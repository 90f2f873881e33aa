"""Matrix-free Jacobian operators backed by PyTorch forward-mode AD.

Counterpart of ``newtonkrylov_tpu/operator.py``.  The residual is
linearized once per Newton iteration with :func:`torch.func.linearize`:
it traces the tangent map into an FX graph and folds everything that
depends only on the linearization point (``exp(u)`` and the like) into
constants, so every Krylov matvec replays only the linear part.

A hand-written kernel reached from a residual must be a
``torch.library.custom_op`` with a fake registration (as in
:mod:`newtonkrylov_tpu_torch.kernels.stencil2d`): ``linearize`` traces with
``make_fx``, where a raw foreign call would see tracing tensors.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable

import torch

from .tree import tree_dtype, tree_size

__all__ = ["LinearOperator", "JacobianOperator"]


class LinearOperator:
    """Minimal protocol: a linear map is a callable state → state."""

    def mv(self, v):
        raise NotImplementedError

    def __call__(self, v):
        return self.mv(v)


class JacobianOperator(LinearOperator):
    """Lazy J = ∂F/∂u at a linearization point.

    ``F(u, p) -> res`` is a pure residual; ``p`` is held constant.
    ``res`` is F(u, p), a by-product of the linearization.
    """

    def __init__(self, F: Callable, u: Any, p: Any = None):
        self.F = F
        self.u = u
        self.p = p
        with warnings.catch_warnings():
            # linearize's constant folding builds its folded module before
            # attaching the constants it references and warns about it;
            # the module it returns is complete
            warnings.filterwarnings(
                "ignore", message="Attempted to insert a get_attr Node",
                category=UserWarning)
            self.res, self._jvp = torch.func.linearize(lambda uu: F(uu, p), u)

    def mv(self, v):
        """J @ v by replaying the stored linearization."""
        return self._jvp(v)

    def mm(self, V):
        """J @ [v₁…v_b] for tangents stacked on a leading axis.

        A loop over the replayed map: ``torch.func.vmap`` would need a
        batching rule for every custom kernel the residual reaches.
        """
        return torch.stack([self._jvp(v) for v in V])

    @property
    def shape(self):
        return (tree_size(self.res), tree_size(self.u))

    @property
    def dtype(self):
        return tree_dtype(self.u)
