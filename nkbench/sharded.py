"""The system under test over a mesh of ranks (``"mesh"`` in a recipe).

The recipe names the port's residual of a padded block and its df32 core
(``residual_padded``, ``residual_df_padded``), which
``halo.sharded_residual_2d`` and ``halo.sharded_residual_df_2d`` lift into
per-rank residuals whose ghosts arrive by exchange (the hi and lo words
apart), the driver ``halo.newton_krylov_sharded``, and a preconditioner
factory that each rank builds on its own block (``mg.multigrid2d`` with
``axis_names``: block Jacobi).  The other driver options are
:meth:`System.kwargs`'s.

Every rank of the process group builds one, in the same order (the mesh's
process groups are made collectively).  Each holds its own block of the
state (:attr:`ShardedSystem.block`), is handed that block on its card and
returns its block of the answer: no card holds the whole grid.
"""

from __future__ import annotations

import importlib

import torch

from .system import PROGRAM, System, resolve


class ShardedSystem(System):
    """A configuration's solve at side ``n``, one block a rank of a
    ``recipe["mesh"]`` mesh over ``recipe["axis_names"]``."""

    def __init__(self, config: dict, n: int, device, mode: str = "live",
                 acceptance=None):
        if mode != "live":
            raise ValueError(f"a sharded solve runs live, not {mode!r}")
        recipe = config["recipe"]
        self.halo = importlib.import_module(PROGRAM + ".halo")
        self.axes = tuple(recipe["axis_names"])
        shape = tuple(int(s) for s in recipe["mesh"])
        if any(n % s for s in shape):
            raise ValueError(f"side {n} does not split over mesh {shape}")
        self.mesh = self.halo.make_mesh(shape, self.axes,
                                        device_type=torch.device(device).type)
        coord = self.mesh.get_coordinate()
        self.block = tuple(slice(c * (n // s), (c + 1) * (n // s))
                           for c, s in zip(coord, shape))
        super().__init__(config, n, device, mode, acceptance)

    @property
    def origin(self):
        """The block's first row and column in the whole grid."""
        return self.block[0].start, self.block[1].start

    def residuals(self):
        r = self.recipe
        return (self.halo.sharded_residual_2d(resolve(r["residual_padded"]),
                                              self.axes),
                self.halo.sharded_residual_df_2d(
                    resolve(r["residual_df_padded"]), self.axes))

    def _solve(self, u0, max_niter=None):
        # u0 is already this rank's block on its card, so it goes in
        # unsplit (an empty spec): the driver's copy of it is then a clone
        # on the card, and the whole grid is never formed
        u, info = self.driver(self.F, u0, self.p, self.mesh, self.halo.P(),
                              axis_names=self.axes,
                              newton_kwargs=self.kwargs(max_niter))
        return (u, info.stats.outer_iterations, info.stats.inner_iterations,
                info.solved)
