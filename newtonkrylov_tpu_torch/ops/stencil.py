"""Plain tensor stencil building blocks.

Counterpart of :mod:`newtonkrylov_tpu.ops.stencil`: Dirichlet ghosts are
materialized by a constant pad, then the stencil reads shifted slices.
"""

from __future__ import annotations

import torch.nn.functional as F

__all__ = ["pad_dirichlet", "laplacian_2d"]


def pad_dirichlet(u, value=0.0):
    """Surround a 2-D array with a constant ghost ring."""
    return F.pad(u, (1, 1, 1, 1), mode="constant", value=value)


def laplacian_2d(u_padded, dx, dy):
    """5-point Laplacian over a padded 2-D array: returns the interior."""
    c = u_padded[1:-1, 1:-1]
    return (
        (u_padded[2:, 1:-1] - 2.0 * c + u_padded[:-2, 1:-1]) / (dx * dx)
        + (u_padded[1:-1, 2:] - 2.0 * c + u_padded[1:-1, :-2]) / (dy * dy)
    )
