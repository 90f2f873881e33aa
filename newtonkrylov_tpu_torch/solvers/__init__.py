"""Matrix-free Krylov solvers.

Counterpart of :mod:`newtonkrylov_tpu.solvers`.  Only ``cg`` is ported; the
other names of the reference's menu raise until their ROADMAP.md item lands.
"""

from __future__ import annotations

import inspect

from .cg import cg
from .common import KrylovResult

_ALGOS = {"cg": cg}
_NOT_PORTED = ("gmres", "fgmres", "bicgstab", "cgls")

__all__ = ["cg", "solve", "KrylovResult", "available_algos"]


def available_algos():
    return sorted(_ALGOS)


def solve(algo: str, A, b, x0=None, **kwargs) -> KrylovResult:
    """Dispatch on algorithm name; kwargs are filtered to what it accepts."""
    if algo in _NOT_PORTED:
        raise NotImplementedError(
            f"algo {algo!r} is not ported yet (ROADMAP.md Queue 1, item 13)")
    try:
        fn = _ALGOS[algo]
    except KeyError:
        raise ValueError(
            f"unknown algo {algo!r}; available: {available_algos()}") from None
    params = inspect.signature(fn).parameters
    return fn(A, b, x0, **{k: v for k, v in kwargs.items() if k in params})
