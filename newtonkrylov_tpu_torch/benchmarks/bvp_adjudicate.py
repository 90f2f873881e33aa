"""The evidence behind the BVP section of the port's parity account.

Counterpart of ``benchmarks/bvp_adjudicate.py``.  The reference solves the
Kelley2022 two-point BVP (n = 801, 1,602 unknowns) with FGMRES and a nested
GMRES(itmax=30) right preconditioner (examples/bvp.jl:54-58) and never
asserts convergence.  This script records what that recipe does under the
Krylov.jl semantics it states:

* outer FGMRES not restarted: one cycle whose basis grows to the
  solver's limit of 2n = 1,602 (Krylov.jl's growing workspace at its
  maximum), ``atol = √eps`` (Krylov.jl's default), ``rtol = η`` from
  Eisenstat–Walker as the reference's ``newton_krylov!`` wires it;
* the preconditioner ``gmres(J, x; itmax=30)`` with Krylov.jl's defaults
  (``atol = rtol = √eps``, one non-restarted cycle of 30);
* the Newton loop at the reference's defaults (``tol_rel`` 1e-6,
  ``tol_abs`` 1e-12, ``max_niter`` 50, s = 1, no line search);

and, for contrast, unpreconditioned full GMRES and the shipped recipe:
GMRES with the pivoted banded LU(2, 2), with Armijo and without.

Run (the card by default; the committed record is a CPU f64 run):

    python -m newtonkrylov_tpu_torch.benchmarks.bvp_adjudicate --device cpu

writes ``newtonkrylov_tpu_torch/benchmarks/bvp_adjudication.json`` in the
JAX record's schema (on the card nothing is written unless ``--out`` names
a file; ``--recipes`` runs a subset).
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Optional

SQ_EPS = math.sqrt(2.220446049250313e-16)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "bvp_adjudication.json")


def _recipes():
    """name -> the keyword arguments of ``newton_krylov`` for that recipe."""
    from .. import precond

    full = {"restart": None, "itmax": 2 * 801, "atol": SQ_EPS}
    return {
        # nested_krylov's restart = min(itmax, 40) = 30: ONE 30-dimensional
        # cycle, Krylov.jl's non-restarted gmres(J, x; itmax=30)
        "reference_recipe_fgmres_nested_gmres30": dict(
            algo="fgmres",
            N=precond.nested_krylov("gmres", itmax=30, atol=SQ_EPS, rtol=SQ_EPS),
            krylov_kwargs=dict(full), max_niter=50),
        "unpreconditioned_full_gmres": dict(
            algo="gmres", krylov_kwargs=dict(full), max_niter=50),
        "banded_lu_armijo": dict(
            algo="gmres", N=precond.banded_lu(2, 2), linesearch="armijo"),
        "banded_lu_plain": dict(algo="gmres", N=precond.banded_lu(2, 2)),
    }


RECIPES = ("reference_recipe_fgmres_nested_gmres30",
           "unpreconditioned_full_gmres", "banded_lu_armijo", "banded_lu_plain")


def run(name: str, device="cuda") -> dict:
    """One recipe on the BVP in f64 through ``newton_krylov``: solved, the
    counts, the final ‖F‖ and the ‖F‖ the callback saw each outer."""
    from .. import newton_krylov
    from ..problems import bvp

    p = bvp.default_config(device=device)
    hist = []
    _, info = newton_krylov(
        bvp.residual, bvp.initial_guess(p), p,
        callback=lambda u, r, n: hist.append(float(n)),
        **_recipes()[name])
    rec = {"solved": bool(info.solved),
           "outer": int(info.stats.outer_iterations),
           "inner": int(info.stats.inner_iterations),
           "final_norm": float(info.stats.n_res),
           "residual_history": hist}
    print(f"[{name}] solved={rec['solved']} outer={rec['outer']} "
          f"inner={rec['inner']} |F|={rec['final_norm']:.3e}", flush=True)
    print("   history:", " ".join(f"{h:.3e}" for h in hist), flush=True)
    return rec


def main(device="cuda", recipes=RECIPES, out: Optional[str] = None) -> dict:
    from ..examples import _common

    dev = _common.resolve_device(device)
    results = {name: run(name, dev) for name in recipes}
    if out:
        with open(out, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
        print(f"wrote {out}")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--recipes", nargs="+", choices=RECIPES, default=RECIPES)
    ap.add_argument("--out", default=None,
                    help="where to write the record (default: the committed "
                         "record for --device cpu, nowhere on the card)")
    a = ap.parse_args()
    out = a.out if a.out is not None else (OUT if a.device == "cpu" else None)
    main(a.device, a.recipes, out or None)
