"""Shared plumbing of the port's examples: the device, the command line and
figures (the port's counterpart of ``examples/_common.py``).

Nothing here imports matplotlib at module level: the card's machine may
have none, and only ``--plot`` needs it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; the card only where CUDA is there
    (asking for it without CUDA raises: nothing falls back to the CPU).
    On the card both TF32 flags go off: the port's matmul engines raise
    while TF32 is allowed (ROADMAP hazard (a))."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the example runs on the card by default, and CUDA is not "
                "available here: pass --device cpu (device='cpu')")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def numpy(x) -> np.ndarray:
    """A tensor (on any device) as a numpy array."""
    return x.detach().cpu().numpy()


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported on first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_plot(fig, name: str) -> str:
    """Save ``fig`` as ``out/<name>`` beside the examples and close it."""
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, name)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    pyplot().close(fig)
    print(f"saved {path}")
    return path


def cli(main, description: str, **sizes):
    """Run ``main`` from the command line: ``--device`` (default ``cuda``),
    ``--plot``, and one ``--<size>`` option per keyword in ``sizes`` (its
    default and type are the keyword's value)."""
    ap = argparse.ArgumentParser(description=description.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--plot", action="store_true",
                    help="save the example's figure into examples/out/")
    for name, default in sizes.items():
        kind = float if isinstance(default, float) else int
        ap.add_argument(f"--{name.replace('_', '-')}", dest=name, type=kind,
                        default=default)
    main(**vars(ap.parse_args()))
