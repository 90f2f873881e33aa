"""Coefficient probing of 5-point-stencil Jacobians.

Counterpart of the part of :mod:`newtonkrylov_tpu.mg` the DST preconditioner
needs: :func:`probe_5point`.  Operator model ``A u = o·S(u) + d(x)·u`` with
``S`` the sum of the four neighbors (zero-Dirichlet ghosts), ``o`` the
constant off-diagonal coefficient and ``d`` the varying diagonal.  The
multigrid V-cycle itself is not ported yet (ROADMAP.md Queue 1, item 15).
"""

from __future__ import annotations

import torch

from .ops.stencil import pad_dirichlet

__all__ = ["probe_5point"]


def _neighbor_sum(u):
    """S(u): sum of the 4 neighbors with zero-Dirichlet ghosts."""
    up = pad_dirichlet(u)
    return up[2:, 1:-1] + up[:-2, 1:-1] + up[1:-1, 2:] + up[1:-1, :-2]


def _apply(u, o, d):
    return o * _neighbor_sum(u) + d * u


def probe_5point(J, row_offset=0, col_offset=0):
    """Extract (o, d) of a 5-point + diagonal operator by colored probing.

    One JVP with a single basis vector gives the off-diagonal coefficient;
    five JVPs with a (i + 2j) mod 5 coloring give the full diagonal field
    (no two entries of the 5-point stencil share a color under it).  The
    offsets give the global origin of a block, so the colouring of a shard
    stays globally consistent.
    """
    u = J.u
    n, m = u.shape
    dtype, device = u.dtype, u.device

    e = torch.zeros((n, m), dtype=dtype, device=device)
    e[n // 2, m // 2] = 1.0
    rows = torch.arange(n, device=device)[:, None] + row_offset
    cols = torch.arange(m, device=device)[None, :] + col_offset
    color = (rows + 2 * cols) % 5
    probes = torch.stack([e] + [(color == c).to(dtype) for c in range(5)])
    outs = J.mm(probes)  # (6, n, m)
    o = outs[0, n // 2 + 1, m // 2]  # neighbor entry = off-diagonal coefficient
    zero = torch.zeros((), dtype=outs.dtype, device=device)
    d = sum(torch.where(color == c, outs[1 + c], zero) for c in range(5))
    return o, d
