"""Whether a run's answers are correct, by the configuration's reference.

After the window has closed and the program's state is freed, each kept
answer (every answer of a closed loop; a sample drawn from the seed in an
open one, ``"check": {"sample": k}`` in the mix) goes, with the starting
state the benchmark made for it, to the plain reference named by the
configuration (``nkbench/reference/<name>.py``), which works out the
answer's residual and the tolerance the configuration states for that
solve.  Two numbers are compared, each with its limit from the mix's
``"check": {"limits": ...}``:

* ``res_ratio``: the largest ratio of a checked answer's float64 residual
  norm to its stated tolerance;
* ``unsolved``: the requests whose solve reported ``solved`` false;
* ``bad_counts``: the requests whose reported counts no sound solve gives:
  outer iterations outside ``1 … max_niter`` of the recipe, or fewer inner
  iterations than outer ones (every Newton step takes one Krylov step at
  least).  Every request of the window is held to these two.

A request fails if its answer breaks a limit; the run is correct when no
number exceeds its limit.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, NamedTuple

import torch

BIG = 1e300  # a non-finite reading, as a JSON number


class Verdict(NamedTuple):
    correct: bool
    failed: int
    checks: Dict[str, dict]


def reference(name: str):
    return importlib.import_module(f"nkbench.reference.{name}")


def judge(run, keep: Dict[int, torch.Tensor], log, u0=None) -> Verdict:
    """``u0`` makes a fresh whole starting state where the run's own
    (``run.u0``) is a rank's block of it."""
    fresh = u0 or run.u0
    ref = reference(run.config["reference"])
    limits = run.mix["check"]["limits"]
    recipe, problem = run.config["recipe"], run.config["problem"]
    bad = set()
    worst = 0.0
    by_index = {rec.index: rec for rec in run.records}
    for i in sorted(keep):
        rec = by_index[i]
        u = keep[i].to(device=run.device, dtype=torch.float64)
        u0 = fresh()
        j = ref.judge(u, u0, problem, recipe)
        ratio = j["res_ratio"] if math.isfinite(j["res_ratio"]) else BIG
        if ratio > limits["res_ratio"]:
            bad.add(i)
        worst = max(worst, ratio)
        log(f"[check] request {i}: ‖F(u)‖ "
            f"{j['res']:.6e}, stated tolerance {j['tol']:.6e}, ratio "
            f"{ratio:.6e}; reported {rec.outer} / {rec.inner}, solved "
            f"{rec.solved}")
        del u, u0
    unsolved = [rec.index for rec in run.records if not rec.solved]
    max_niter = int(recipe["max_niter"])
    bad_counts = [rec.index for rec in run.records
                  if not 1 <= rec.outer <= max_niter or rec.inner < rec.outer]
    bad.update(unsolved, bad_counts)
    checks = {
        "res_ratio": {"value": worst, "limit": limits["res_ratio"]},
        "unsolved": {"value": len(unsolved), "limit": limits["unsolved"]},
        "bad_counts": {"value": len(bad_counts),
                       "limit": limits["bad_counts"]},
    }
    log(f"[check] {len(keep)} of {len(run.records)} answers checked")
    correct = (bool(keep) and bool(run.records)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return Verdict(correct, len(bad), checks)
