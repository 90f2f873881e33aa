"""Matrix-free Krylov solvers.

Counterpart of ``newtonkrylov_tpu/solvers/``: ``gmres`` (the default of the
Newton driver), ``fgmres``, ``cg`` (plain and pipelined), ``bicgstab`` and
``cgls``.  Each runs its loops through
:mod:`~newtonkrylov_tpu_torch.exportable`, so every one of them exports
inside a whole solve (``utils/serving.py``).
"""

from __future__ import annotations

import inspect

from .bicgstab import bicgstab, cgls
from .cg import cg
from .common import KrylovResult
from .gmres import fgmres, gmres

_ALGOS = {"gmres": gmres, "fgmres": fgmres, "cg": cg, "bicgstab": bicgstab,
          "cgls": cgls}

__all__ = ["gmres", "fgmres", "cg", "bicgstab", "cgls", "solve",
           "KrylovResult", "available_algos"]


def available_algos():
    return sorted(_ALGOS)


def solve(algo: str, A, b, x0=None, **kwargs) -> KrylovResult:
    """Dispatch on algorithm name.  kwargs are filtered to what the solver
    accepts, or forwarded whole to one that takes ``**kwargs`` (``fgmres``
    forwards them to ``gmres``)."""
    try:
        fn = _ALGOS[algo]
    except KeyError:
        raise ValueError(
            f"unknown algo {algo!r}; available: {available_algos()}") from None
    params = inspect.signature(fn).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return fn(A, b, x0, **kwargs)
    return fn(A, b, x0, **{k: v for k, v in kwargs.items() if k in params})
