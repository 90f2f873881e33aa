"""Shared solver plumbing: results, tolerances, operator adapters.

Counterpart of ``newtonkrylov_tpu/solvers/common.py``.  Termination follows
Krylov.jl: stop when ``‖r_k‖ ≤ atol + rtol·‖r₀‖`` with defaults
``atol = rtol = √eps(dtype)``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

__all__ = ["KrylovResult", "default_tols", "as_operator", "nonzero_or_one"]


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


def nonzero_or_one(d):
    """d where it is nonzero, else 1: a guarded divisor."""
    return torch.where(d != 0, d, torch.ones_like(d))
