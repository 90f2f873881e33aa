"""Execute every ```python block of the port's ``walkthrough_*.md`` top to
bottom (the port's copy of ``docs/run_walkthroughs.py``).

Each walkthrough's blocks share one namespace, which starts with ``DEVICE``
(the ``--device`` given: the card, ``cuda``, by default) and ``FIGDIR``
(where a figure block saves its PNG: ``_figures/`` beside this file).  The
blocks must run, and their assertions hold.  ``--no-figures`` skips the
blocks that draw (those importing matplotlib) and says so.

Usage::

    python -m newtonkrylov_tpu_torch.docs.run_walkthroughs [--device cpu] [--no-figures] [name ...]

With more than one walkthrough, each runs in a process of its own.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys

DOCS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(DOCS))
FIGDIR = os.path.join(DOCS, "_figures")
BLOCK = re.compile(r"```python\n(.*?)```", re.DOTALL)


def paths(names=()) -> list:
    """The walkthroughs, all or those whose file name contains a name."""
    found = sorted(glob.glob(os.path.join(DOCS, "walkthrough_*.md")))
    if names:
        found = [p for p in found if any(n in os.path.basename(p) for n in names)]
    return found


def is_figure_block(code: str) -> bool:
    return "matplotlib" in code


def run(path: str, device: str = "cuda", figures: bool = True,
        figdir: str = FIGDIR) -> dict:
    """Run one walkthrough's blocks in a fresh namespace; return it."""
    from newtonkrylov_tpu_torch.examples._common import resolve_device

    resolve_device(device)  # the card only with CUDA; TF32 off there
    blocks = BLOCK.findall(open(path, encoding="utf-8").read())
    os.makedirs(figdir, exist_ok=True)
    ns = {"__name__": f"walkthrough:{os.path.basename(path)}",
          "DEVICE": device, "FIGDIR": figdir}
    print(f"== {os.path.basename(path)} ({len(blocks)} blocks) on {device}")
    skipped = 0
    for i, block in enumerate(blocks):
        if not figures and is_figure_block(block):
            skipped += 1
            continue
        exec(compile(block, f"{path}[block {i}]", "exec"), ns)
    if skipped:
        print(f"   skipped {skipped} figure block(s) (--no-figures)")
    print("   OK")
    return ns


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--no-figures", action="store_true",
                    help="skip the blocks that draw figures")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args(argv)
    found = paths(args.names)
    if not found:
        raise SystemExit("no walkthroughs matched")
    if len(found) == 1:
        run(found[0], args.device, not args.no_figures)
        return
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    for p in found:
        cmd = [sys.executable, "-m", "newtonkrylov_tpu_torch.docs.run_walkthroughs",
               "--device", args.device, os.path.basename(p)]
        if args.no_figures:
            cmd.insert(-1, "--no-figures")
        subprocess.run(cmd, check=True, cwd=ROOT, env=env)


if __name__ == "__main__":
    main()
