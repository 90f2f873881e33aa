"""The system under test, built from a configuration's recipe.

The recipe names the program's public entry points as ``"module:attribute"``
inside the port (``newtonkrylov_tpu_torch``) and nothing else: the
residual, its float32-pair (df32) acceptance residual, the problem's
parameters and the preconditioner factory, with the driver's options.
:class:`System` turns it into one call per request:

* ``"live"``: ``newton_krylov_jit`` called from Python, as a user's script
  calls it;
* ``"served"``: the same solve exported once by ``utils.serving``, saved
  under the run's temporary directory, loaded, and called through the
  loaded program's ``.call``.

Both return a :class:`Answer`.  ``acceptance="f32"`` switches the
program's own float32 acceptance path on in place of the configured df32
one: the control of the correctness check, never used by a benchmark run.
"""

from __future__ import annotations

import importlib
import os
import tempfile
from typing import Any, Callable, NamedTuple, Optional

import torch

PROGRAM = "newtonkrylov_tpu_torch"
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve(ref: str) -> Any:
    """``"module:attribute"`` of the port."""
    module, _, attr = ref.partition(":")
    if module.split(".")[0] != PROGRAM or not attr:
        raise ValueError(f"a recipe names the port's entry points "
                         f"({PROGRAM}.<module>:<attribute>), got {ref!r}")
    return getattr(importlib.import_module(module), attr)


class Answer(NamedTuple):
    """What one request returned: the state, the counts and flags the
    solve reported (Python values)."""
    u: torch.Tensor
    outer: int
    inner: int
    solved: bool


class System:
    """A configuration's solve at side ``n`` on ``device``."""

    def __init__(self, config: dict, n: int, device, mode: str = "live",
                 acceptance: Optional[str] = None):
        recipe = config["recipe"]
        problem = config["problem"]
        self.config, self.recipe, self.problem = config, recipe, problem
        self.n, self.device, self.mode = n, torch.device(device), mode
        self.acceptance = acceptance or recipe["acceptance"]
        if self.acceptance not in ("df32", "f32"):
            raise ValueError(f"unknown acceptance {self.acceptance!r}")
        if mode not in ("live", "served"):
            raise ValueError(f"unknown mode {mode!r}")
        self.F, self.F_df = self.residuals()
        self.p = resolve(recipe["params"])(n, lam=float(problem["lam"]))
        self.driver = resolve(recipe["driver"])
        self.factory = self.make_factory()
        self._loaded = None
        self._tmp = None

    # the state this system takes and returns: the whole grid
    block = None

    def residuals(self):
        """The residual and its df32 acceptance residual."""
        return (resolve(self.recipe["residual"]),
                resolve(self.recipe["residual_df"]))

    # -- the pieces a per-layer reader replays ------------------------------
    def make_factory(self) -> Optional[Callable]:
        pre = self.recipe.get("precond")
        if pre is None:
            return None
        return resolve(pre["factory"])(**pre.get("kwargs", {}))

    def state_dtype(self):
        return torch.float64 if self.acceptance == "df32" else torch.float32

    def kwargs(self, max_niter=None) -> dict:
        """The driver's options; ``max_niter`` in place of the recipe's."""
        r = self.recipe
        kw = dict(algo=r["algo"], tol_rel=float(r["tol_rel"]),
                  tol_abs=float(r["tol_abs"]),
                  max_niter=int(max_niter or r["max_niter"]),
                  krylov_dtype=DTYPES[r["krylov_dtype"]])
        if self.acceptance == "df32":
            kw.update(residual_df=self.F_df, floor_rtol=r.get("floor_rtol"))
        if self.factory is not None:
            kw.update(M=self.factory,
                      precond_refresh=r["precond"].get("refresh", "outer"))
        return kw

    # -- one request ----------------------------------------------------------
    def _solve(self, u0, max_niter=None):
        u, info = self.driver(self.F, u0, self.p, **self.kwargs(max_niter))
        return (u, info.stats.outer_iterations, info.stats.inner_iterations,
                info.solved)

    def prepare(self, example_u0) -> None:
        """Served mode: export the solve at ``example_u0``'s shape, save it
        under the temporary directory, and load it (set-up work)."""
        if self.mode != "served":
            return
        serving = importlib.import_module(PROGRAM + ".utils.serving")
        self._tmp = tempfile.TemporaryDirectory(prefix="nkbench-")
        ep = serving.export_solver(self._solve, (example_u0,))
        path = serving.save_exported(ep, os.path.join(self._tmp.name,
                                                      "solve.pt2"))
        del ep
        self._loaded = serving.load_exported(path)

    def __call__(self, u0, max_niter=None) -> Answer:
        """One request; ``max_niter`` cuts a live solve to that many
        outers (a warm request of the set-up)."""
        if self.mode == "served":
            if max_niter is not None:
                raise ValueError("a served solve runs as it was exported")
            u, outer, inner, solved = self._loaded.call(u0)
        else:
            u, outer, inner, solved = self._solve(u0, max_niter)
        return Answer(u, int(outer), int(inner), bool(solved))

    def close(self) -> None:
        """Free the loaded program and remove what the export wrote."""
        self._loaded = None
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None


def system_class(config: dict):
    """The system a configuration's recipe asks for: :class:`System`, or
    over a mesh of ranks (``"mesh"`` in the recipe)
    :class:`nkbench.sharded.ShardedSystem`."""
    if "mesh" in config["recipe"]:
        from .sharded import ShardedSystem

        return ShardedSystem
    return System
