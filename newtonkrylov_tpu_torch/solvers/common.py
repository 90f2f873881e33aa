"""Shared solver plumbing: results, tolerances, operator adapters.

Counterpart of ``newtonkrylov_tpu/solvers/common.py``.  Termination follows
Krylov.jl: stop when ``‖r_k‖ ≤ atol + rtol·‖r₀‖`` with defaults
``atol = rtol = √eps(dtype)``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

__all__ = ["KrylovResult", "default_tols", "as_operator"]


class KrylovResult(NamedTuple):
    """Result of a linear solve."""

    x: Any
    niter: int                  # inner steps taken (counted on the host)
    residual: torch.Tensor      # final (recurrence) residual norm
    converged: torch.Tensor     # bool: met atol + rtol·‖r₀‖
    breakdown: torch.Tensor     # bool: breakdown encountered


def default_tols(dtype, atol=None, rtol=None):
    """Krylov.jl-compatible defaults: atol = rtol = √eps(dtype)."""
    sq = float(torch.finfo(dtype).eps) ** 0.5
    return (sq if atol is None else atol), (sq if rtol is None else rtol)


def as_operator(A) -> Callable:
    """Accept either a callable v↦Av or an object with .mv()."""
    if callable(A):
        return A
    if hasattr(A, "mv"):
        return A.mv
    raise TypeError(f"not a linear operator: {A!r}")
