"""Flagship: 2-D Bratu JFNK to ‖F‖ ≤ 1e-8·‖F₀‖ by mixed-precision iterative
refinement, in example form.

Counterpart of ``examples/bratu_2d_tpu.py``.  Two lanes, both f64-accurate
without an f64 operation in the Krylov loop:

* plain refined CG on the aligned ghost layout (f64 state, f32 Krylov):
  every matvec is one launch of the hand-written stencil-JVP kernel (K1)
  and every residual one launch of the residual kernel (K2) — the kernel
  showcase;
* the production recipe: df32 (paired-f32) acceptance residual, f32 CG
  preconditioned by the exact DST Poisson solve (four full-f32 sine-basis
  matmuls), the factory frozen at u₀ (``precond_refresh="once"``).

512² on the card by default (``--n`` sets the side), 128² on the CPU,
where K1 and K2 run their plain PyTorch versions.  The returned dict
carries K1's and K2's launch counts over the aligned lane.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from newtonkrylov_tpu_torch import newton_krylov_jit
from newtonkrylov_tpu_torch.examples import _common
from newtonkrylov_tpu_torch.fftprec import fft_poisson
from newtonkrylov_tpu_torch.kernels import stencil2d as k
from newtonkrylov_tpu_torch.problems import bratu2d

N_CARD, N_CPU = 512, 128


def main(device="cuda", plot=False, n=None) -> dict:
    dev = _common.resolve_device(device)
    n = n or (N_CARD if dev.type == "cuda" else N_CPU)
    u0a, p, space = bratu2d.aligned_setup(n, lam=5.0, dtype=torch.float64,
                                          device=dev)

    before = dict(k.LAUNCHES)
    t0 = time.perf_counter()
    u, info = newton_krylov_jit(
        lambda u, pp: bratu2d.residual_scaled_aligned(u, pp), u0a, p,
        algo="cg", tol_rel=1e-8, space=space, krylov_dtype=torch.float32,
    )
    float(torch.sum(u))  # sync
    wall = time.perf_counter() - t0
    launches = {key: k.LAUNCHES[key] - before[key]
                for key in ("stencil_jvp", "bratu_residual")}

    hist = _common.numpy(info.history)
    kk = int(info.stats.outer_iterations)
    print(f"n={n}^2 lam=5 [refined CG, K1/K2]: solved={bool(info.solved)} "
          f"outer={kk} inner={int(info.stats.inner_iterations)} "
          f"|F|={float(info.stats.n_res):.3e} wall={wall:.2f}s")
    print("residual history:", hist[: kk + 1])

    # Production recipe (the flagship): df32 acceptance residual +
    # DST-preconditioned f32 CG, preconditioner frozen at u0.
    u0 = bratu2d.initial_guess(n, dtype=torch.float64, device=dev)
    pd = bratu2d.default_config(n, lam=5.0)
    t0 = time.perf_counter()
    u2, info2 = newton_krylov_jit(
        bratu2d.residual_scaled, u0, pd,
        algo="cg", tol_rel=1e-8, krylov_dtype=torch.float32,
        residual_df=bratu2d.residual_scaled_df,
        M=fft_poisson(precision="high"), precond_refresh="once",
    )
    float(torch.sum(u2))  # sync
    wall2 = time.perf_counter() - t0
    k2 = int(info2.stats.outer_iterations)
    print(f"n={n}^2 lam=5 [df32 + DST-PCG once]: solved={bool(info2.solved)} "
          f"outer={k2} inner={int(info2.stats.inner_iterations)} "
          f"|F|={float(info2.stats.n_res):.3e} wall={wall2:.2f}s")
    assert bool(info.solved) and bool(info2.solved)

    ui = k.aligned_interior(u, n)
    if plot:
        plt = _common.pyplot()
        fig, axs = plt.subplots(1, 2, figsize=(11, 4))
        im = axs[0].imshow(_common.numpy(ui), origin="lower", extent=(0, 1, 0, 1))
        fig.colorbar(im, ax=axs[0])
        axs[0].set_title(f"2-D Bratu solution, {n}²")
        axs[1].semilogy(hist[: kk + 1], "o-", label="refined CG")
        h2 = _common.numpy(info2.history)
        axs[1].semilogy(h2[: k2 + 1], "s--", label="df32 + DST-PCG")
        axs[1].legend()
        axs[1].set_xlabel("Newton iteration")
        axs[1].set_ylabel("‖F(u)‖")
        axs[1].set_title("convergence (quadratic tail)")
        _common.save_plot(fig, "bratu2d.png")
    return {
        "n": n,
        "refined_cg": {"solved": bool(info.solved), "outer": kk,
                       "inner": int(info.stats.inner_iterations),
                       "n_res": float(info.stats.n_res), "wall": wall,
                       "history": hist[: kk + 1], "launches": launches,
                       "u": _common.numpy(ui)},
        "df32_dst": {"solved": bool(info2.solved), "outer": k2,
                     "inner": int(info2.stats.inner_iterations),
                     "n_res": float(info2.stats.n_res), "wall": wall2,
                     "u": _common.numpy(u2)},
        "max_diff": float(np.abs(_common.numpy(ui) - _common.numpy(u2)).max()),
    }


if __name__ == "__main__":
    _common.cli(main, __doc__, n=None)
