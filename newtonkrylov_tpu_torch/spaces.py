"""Vector spaces: where the solvers' reductions live.

Counterpart of ``newtonkrylov_tpu/spaces.py``.  Solvers take a ``space`` and
perform every dot product and norm through it; elementwise updates stay raw
tensor ops.

* :class:`EuclideanSpace` — plain reductions over every entry.
* :class:`MaskedSpace` — reductions weighted by a 0/1 interior mask, so the
  ghost cells of a ghost-carrying layout never contribute.

``ShardedSpace`` (the all-reduce point of a distributed solve) is not ported
yet; ROADMAP.md Queue 1 lists it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .tree import tree_dtype, tree_map, tree_norm, tree_project_rows, tree_vdot

__all__ = ["VectorSpace", "EuclideanSpace", "MaskedSpace"]


class VectorSpace:
    """Reduction protocol for solver inner products."""

    def dot(self, x, y):
        raise NotImplementedError

    def norm(self, x):
        return torch.sqrt(self.dot(x, x).real)

    def dot2(self, x1, y1, x2, y2):
        """(<x1,y1>, <x2,y2>) as one (2,)-reduction (alias of dot_stack)."""
        return self.dot_stack([(x1, y1), (x2, y2)])

    def dot_stack(self, pairs):
        """k independent inner products as one stacked (k,) tensor."""
        return torch.stack([self.dot(x, y) for x, y in pairs])

    def mask_tree(self, x):
        """Zero out entries that do not belong to the space (ghost cells)."""
        return x

    def project_rows(self, V, w):
        """<V[j], w> for all rows j of a stacked basis → (m,) vector."""
        raise NotImplementedError

    def reduce_rows(self, h):
        """Complete a vector of locally accumulated inner products (blocked
        orthogonalization): the identity on one device."""
        return h

    def size_multiplier(self):
        """Global size = local tree_size × this (1 without sharding)."""
        return 1


@dataclasses.dataclass(frozen=True)
class EuclideanSpace(VectorSpace):
    """Plain ℓ² space over all entries."""

    def dot(self, x, y):
        return tree_vdot(x, y)

    def norm(self, x):
        return tree_norm(x)

    def project_rows(self, V, w):
        return tree_project_rows(V, w)


@dataclasses.dataclass(frozen=True)
class MaskedSpace(VectorSpace):
    """Interior-masked ℓ² space.

    ``mask`` is congruent with the state: 1 on the interior, 0 on ghosts.
    """

    mask: Any
    # The mask cast to each operand dtype it has met: mixed-precision solves
    # run f32 Krylov vectors against an f64-state mask, and casting once
    # keeps a full-array cast out of every reduction of the Krylov loop.
    _cast: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    def _mask_as(self, dtype):
        m = self._cast.get(dtype)
        if m is None:
            m = self._cast[dtype] = tree_map(lambda l: l.to(dtype), self.mask)
        return m

    def dot(self, x, y):
        return tree_vdot(self.mask_tree(x), y)

    def project_rows(self, V, w):
        return tree_project_rows(V, self.mask_tree(w))

    def mask_tree(self, x):
        return tree_map(torch.mul, self._mask_as(tree_dtype(x)), x)
