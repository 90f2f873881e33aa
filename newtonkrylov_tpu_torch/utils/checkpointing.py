"""Checkpoint and resume for long time marches.

Counterpart of ``newtonkrylov_tpu/utils/checkpointing.py``, in the same
file format, so a snapshot either package writes loads in the other: a
numpy ``.npz`` holding ``leaf_i`` (the state's tensor leaves in order),
``_t``, ``_step``, ``_treedef`` (a description, ignored on load) and
``extra_<key>`` for the user metadata.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..tree import tree_leaves, tree_map

__all__ = ["MarchCheckpoint", "save_checkpoint", "load_checkpoint", "latest_checkpoint"]


class MarchCheckpoint(NamedTuple):
    u: Any            # current state (a tensor or a tuple of tensors)
    t: float          # simulation time
    step: int         # completed steps
    extra: dict       # user metadata (dt, stats, ...)


def save_checkpoint(path: str, ckpt: MarchCheckpoint) -> str:
    """Write a snapshot through a temporary file and an atomic rename;
    returns the final file name."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = tree_leaves(ckpt.u)
    payload = {f"leaf_{i}": l.detach().cpu().numpy() for i, l in enumerate(leaves)}
    payload["_t"] = np.asarray(float(ckpt.t))
    payload["_step"] = np.asarray(int(ckpt.step))
    payload["_treedef"] = np.asarray(f"{type(ckpt.u).__name__} of {len(leaves)} leaves")
    for k, v in ckpt.extra.items():
        payload[f"extra_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    final = path if path.endswith(".npz") else path + ".npz"
    os.replace(tmp, final)
    return final


def load_checkpoint(path: str, u_template: Any) -> MarchCheckpoint:
    """Restore a snapshot; ``u_template`` supplies the state's structure
    and each leaf's device and dtype."""
    with np.load(path, allow_pickle=False) as z:
        leaves = iter(range(len(tree_leaves(u_template))))
        u = tree_map(
            lambda l: torch.as_tensor(z[f"leaf_{next(leaves)}"]).to(
                device=l.device, dtype=l.dtype),
            u_template)
        extra = {
            k[len("extra_"):]: z[k].item() if z[k].ndim == 0 else z[k]
            for k in z.files
            if k.startswith("extra_")
        }
        return MarchCheckpoint(
            u=u, t=float(z["_t"]), step=int(z["_step"]), extra=extra
        )


def latest_checkpoint(directory: str, prefix: str = "march_") -> Optional[str]:
    """Most recent checkpoint file in a directory (by the step number in its
    name), or None."""
    if not os.path.isdir(directory):
        return None
    cands = [f for f in os.listdir(directory) if f.startswith(prefix) and f.endswith(".npz")]
    if not cands:
        return None

    def step_of(f):
        try:
            return int(f[len(prefix):].split(".")[0])
        except ValueError:
            return -1

    return os.path.join(directory, max(cands, key=step_of))
