"""The df32 refined solve checked and timed at 1024².

Counterpart of ``benchmarks/solve_df32_check.py``.  Three measurements of
2-D Bratu at λ = 5 with an f32 Krylov CG and the df32 acceptance residual:

* the cost of one outer, by differencing solves driven past any tolerance
  (``tol_rel = tol_abs = 0``, no floor clamp) for ``K_SHORT`` and
  ``K_LONG`` outers, without a preconditioner at one inner an outer and
  with the DST (``fft_poisson()``, rebuilt every outer, Eisenstat–Walker);
* the marginal wall of a converged solve to 1e-8·‖F₀‖ with the DST: three
  chained solves against one (:mod:`.chain_solve`);
* that solve's ``solved``, counts and the f64 true residual ‖F(u)‖/‖F₀‖ of
  the state it returned.

Run on the card (``--device cpu`` for a small rehearsal):

    python -m newtonkrylov_tpu_torch.benchmarks.solve_df32_check [--n 1024]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from . import chain_solve as cs

K_SHORT, K_LONG = 3, 8


def per_outer(tag: str, n: int, device, log=print, **kwargs) -> dict:
    """ms and inner iterations per outer of ``newton_krylov_jit(**kwargs)``
    at n², by ``K_SHORT``/``K_LONG`` differencing (the best of two each,
    after a warm solve)."""
    from ..newton import newton_krylov_jit
    from ..problems import bratu2d

    p = bratu2d.default_config(n, lam=cs.LAM)
    u0 = bratu2d.initial_guess(n, dtype=torch.float64, device=device)

    def solve(k, r):
        u = u0 * (1.0 + 1e-8 * (r + 1))
        cs._synchronize(u)
        t0 = time.perf_counter()
        _, info = newton_krylov_jit(
            bratu2d.residual_scaled, u, p, tol_rel=0.0, tol_abs=0.0,
            max_niter=k, floor_rtol=None, **kwargs)
        cs._synchronize(info.stats.n_res)
        return time.perf_counter() - t0, int(info.stats.inner_iterations)

    solve(K_SHORT, 0)  # warm
    short = [solve(K_SHORT, r) for r in range(2)]
    long_ = [solve(K_LONG, r + 2) for r in range(2)]
    diff = K_LONG - K_SHORT
    ms = (min(t for t, _ in long_) - min(t for t, _ in short)) / diff * 1e3
    inner = (long_[-1][1] - short[-1][1]) / diff
    log(f"[solve_df32_check] {n}² {tag:34s} {ms:9.2f} ms/outer  "
        f"({inner:.2f} inner/outer)")
    return {"ms_per_outer": ms, "inner_per_outer": inner}


def run(n: int = 1024, device="cuda", log=print) -> dict:
    """The three measurements of the module at n²; raises unless the
    converged solve is ``solved`` with its f64 true residual at most the
    accepted tolerance.  The card by default: without CUDA it raises unless
    ``device="cpu"``."""
    from ..examples import _common
    from ..fftprec import fft_poisson
    from ..forcing import EisenstatWalker
    from ..problems import bratu2d

    dev = _common.resolve_device(device)
    base = dict(algo="cg", krylov_dtype=torch.float32,
                residual_df=bratu2d.residual_scaled_df,
                forcing=EisenstatWalker())
    out = {"n": n,
           "no_precond_itmax1": per_outer("df32 refined, no M, itmax=1", n,
                                          dev, log, krylov_kwargs={"itmax": 1},
                                          **base),
           "dst_ew": per_outer("df32 refined, DST, EW", n, dev, log,
                               M=fft_poisson(), **base)}
    f = cs.make_chain_solve(n, fft_poisson(), "outer")
    u0 = bratu2d.initial_guess(n, dtype=torch.float64, device=dev)
    m = cs.marginal(f, u0, k_hi=3, repeats=2)
    info = m.chain.info
    fu, f0 = cs.true_residual(m.chain.u, m.chain.u_start)
    tol = cs.clamped_tol(m.chain.u_start)[0]
    out.update(marginal_s=m.s, single_s=m.t1, solved=bool(info.solved),
               outer=int(info.stats.outer_iterations),
               inner=int(info.stats.inner_iterations), true_rel=fu / f0,
               true_res=fu, tol=tol)
    log(f"[solve_df32_check] df32-refined DST solve {n}x{n} to 1e-8: marginal "
        f"{m.s * 1e3:.1f} ms/solve (single wall {m.t1:.3f} s)")
    log(f"[solve_df32_check] solved={out['solved']} outer={out['outer']} "
        f"inner={out['inner']} true-f64 |F|/|F0| = {fu / f0:.3e} "
        f"(|F| {fu:.4e}, accepted tolerance {tol:.4e})")
    if not (out["solved"] and fu <= tol):
        raise AssertionError(f"solve_df32_check {n}²: not solved to its "
                             f"accepted tolerance")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.n, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
