"""Natural continuation in λ for the 2-D Bratu problem, up to the fold.

Counterpart of ``examples/continuation_bratu.py``.  The Gelfand–Bratu
problem −Δu = λeᵘ has a fold at λ* ≈ 6.808 on the unit square: below it
two solution branches exist (the solver finds the lower one), above it
none.  This example walks λ toward the fold with warm-started
Newton–Krylov solves on a 96² grid:

* warm starts: each solve starts from the previous λ's solution, keeping
  Newton in its quadratic basin as the conditioning worsens toward the
  fold;
* failure detection: past the fold the solve reports ``solved=False``
  (``max_niter`` exhausted or the NaN/Inf abort) instead of raising, so
  the sweep can bisect the fold location;
* the DST preconditioner tracks the linearization point through its
  diagonal shift, staying effective as eᵘ grows.
"""

from __future__ import annotations

import torch

from newtonkrylov_tpu_torch import newton_krylov_jit
from newtonkrylov_tpu_torch.examples import _common
from newtonkrylov_tpu_torch.fftprec import fft_poisson
from newtonkrylov_tpu_torch.problems import bratu2d

LAMS = (1.0, 3.0, 5.0, 6.0, 6.5, 6.7, 6.78, 6.80)
LAM_PAST_FOLD = 7.5


def solve_at(lam, u0, n):
    p = bratu2d.default_config(n, lam=float(lam))
    return newton_krylov_jit(
        bratu2d.residual_scaled, u0, p, algo="cg", tol_rel=1e-10,
        max_niter=30, M=fft_poisson(),
    )


def main(device="cuda", plot=False) -> dict:
    dev = _common.resolve_device(device)
    n = 96
    u = bratu2d.initial_guess(n, dtype=torch.float64, device=dev)

    steps = []
    for lam in LAMS:
        u_new, info = solve_at(lam, u, n)
        ok = bool(info.solved)
        peak = float(torch.max(u_new))
        print(f"lam={lam:5.2f}: solved={ok} outer={int(info.stats.outer_iterations)} "
              f"inner={int(info.stats.inner_iterations)} "
              f"max(u)={peak:.4f}")
        assert ok, f"continuation lost convergence below the fold at lam={lam}"
        u = u_new
        steps.append({"lam": lam, "solved": ok,
                      "outer": int(info.stats.outer_iterations),
                      "inner": int(info.stats.inner_iterations),
                      "n_res": float(info.stats.n_res), "peak": peak})

    # Late steps stay bounded despite the worsening conditioning near the
    # fold (tol_rel is relative to the warm-start residual, the reference's
    # semantics — each step earns ten fresh digits, so counts measure
    # Newton work, not closeness of the start).
    assert steps[-1]["outer"] <= 10, f"near-fold step cost {steps[-1]['outer']} outers"

    # past the fold there is no solution: the solver must REPORT failure
    # (solved=False), not raise or return a spurious root
    _, info_bad = solve_at(LAM_PAST_FOLD, u, n)
    past = {"lam": LAM_PAST_FOLD, "solved": bool(info_bad.solved),
            "outer": int(info_bad.stats.outer_iterations),
            "inner": int(info_bad.stats.inner_iterations)}
    print(f"lam= 7.50: solved={past['solved']} (past the fold, expected False)")
    assert not past["solved"]

    if plot:
        plt = _common.pyplot()
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(LAMS, [s["peak"] for s in steps], "o-")
        ax.axvline(6.808, ls="--", c="gray", label="fold λ* ≈ 6.808")
        ax.set_xlabel("λ")
        ax.set_ylabel("max u (lower branch)")
        ax.set_title(f"2-D Bratu continuation, {n}² grid")
        ax.legend()
        _common.save_plot(fig, "continuation_bratu.png")
    return {"steps": steps, "past_fold": past, "u": _common.numpy(u)}


if __name__ == "__main__":
    _common.cli(main, __doc__)
