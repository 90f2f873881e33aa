"""Plain tensor stencil building blocks.

Counterpart of ``newtonkrylov_tpu/ops/stencil.py``: ghosts are materialized
by a constant (Dirichlet) or wrap-around (periodic) pad, then the stencil
reads shifted slices.
"""

from __future__ import annotations

import torch.nn.functional as F

__all__ = ["pad_dirichlet", "pad_periodic", "laplacian_1d", "laplacian_2d"]


def pad_dirichlet(u, value=0.0):
    """Surround a 2-D array with a constant ghost ring."""
    return F.pad(u, (1, 1, 1, 1), mode="constant", value=value)


def pad_periodic(u):
    """Surround a 2-D array with wrap-around ghosts, corners included
    (``jnp.pad(mode="wrap")``).  The circular pad wants batch and channel
    dimensions, so two are added and dropped again."""
    return F.pad(u[None, None], (1, 1, 1, 1), mode="circular")[0, 0]


def laplacian_1d(u_padded, dx):
    """Second difference over a padded 1-D array: returns the interior."""
    return (u_padded[2:] - 2.0 * u_padded[1:-1] + u_padded[:-2]) / (dx * dx)


def laplacian_2d(u_padded, dx, dy):
    """5-point Laplacian over a padded 2-D array: returns the interior."""
    c = u_padded[1:-1, 1:-1]
    return (
        (u_padded[2:, 1:-1] - 2.0 * c + u_padded[:-2, 1:-1]) / (dx * dx)
        + (u_padded[1:-1, 2:] - 2.0 * c + u_padded[1:-1, :-2]) / (dy * dy)
    )
