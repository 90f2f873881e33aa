"""Pseudo-transient continuation: solving where plain Newton diverges.

Counterpart of ``examples/ptc_globalization.py``.  The reference's Newton
loop takes the full step every iteration — globalization is its explicit
TODO (src/Ariadne.jl:341-344).  This example shows the Ψtc driver
(``pseudo_transient``, Kelley 2003's ``ptcsol``) on the two canonical
situations:

1. **arctan(x) = 0 from x₀ = 3** — the textbook Newton-divergence witness:
   the Newton step overshoots with growing amplitude, while Ψtc's damped
   steps walk into the basin and then accelerate to Newton speed (SER: δ
   grows by the residual-reduction ratio).

2. **2-D Bratu at λ = 6.8** (fold at λ* ≈ 6.808) **from rough
   large-amplitude starts** — Ψtc follows the stable heat flow
   ``du/dτ = Δu + λeᵘ`` (note the sign: pass −residual) and reaches the
   lower branch in no more outer steps than Newton, with the same DST
   preconditioner factory (it probes the shifted operator δ⁻¹I + J).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from newtonkrylov_tpu_torch import newton_krylov_jit, pseudo_transient
from newtonkrylov_tpu_torch.examples import _common
from newtonkrylov_tpu_torch.fftprec import fft_poisson
from newtonkrylov_tpu_torch.problems import bratu2d

AMPS = (1.5, 2.0, 2.5, 3.0)


def _finite(info):
    h = _common.numpy(info.history)
    return h[np.isfinite(h)]


def arctan_comparison(dev) -> dict:
    F = lambda x, p: torch.arctan(x)  # noqa: E731
    x0 = torch.tensor([3.0], dtype=torch.float64, device=dev)

    _, info_n = newton_krylov_jit(F, x0, max_niter=20)
    hist_n = _finite(info_n)
    print("newton  : solved=%s  history=%s" % (
        bool(info_n.solved), np.array2string(hist_n[:6], precision=2)))

    u, info_p = pseudo_transient(F, x0)
    hist_p = _finite(info_p)
    print("ptc     : solved=%s  outer=%d  history=%s" % (
        bool(info_p.solved), int(info_p.stats.outer_iterations),
        np.array2string(hist_p, precision=2)))
    assert bool(info_p.solved) and not bool(info_n.solved)
    return {"newton": {"solved": bool(info_n.solved), "history": hist_n},
            "ptc": {"solved": bool(info_p.solved),
                    "outer": int(info_p.stats.outer_iterations),
                    "inner": int(info_p.stats.inner_iterations),
                    "history": hist_p, "u": float(u[0])}}


def bratu_rough_starts(dev) -> dict:
    n = 32
    p = bratu2d.default_config(n, lam=6.8)
    X, Y = bratu2d.grid(n, device=dev)
    negF = lambda u, p: -bratu2d.residual_scaled(u, p)  # noqa: E731
    d0 = float((n + 1) ** 2)  # 1/dx²: the dx²-scaled residual's time unit

    print("\n2-D Bratu λ=6.8 (fold at 6.808), rough starts amp·sin(πx)sin(πy):")
    print(f"{'amp':>5} {'newton outers':>14} {'ptc outers':>11}")
    out = {}
    for amp in AMPS:
        u0 = amp * torch.sin(math.pi * X) * torch.sin(math.pi * Y)
        _, info_n = newton_krylov_jit(
            bratu2d.residual_scaled, u0, p, algo="gmres",
            tol_rel=1e-10, M=fft_poisson(), max_niter=50)
        _, info_p = pseudo_transient(
            negF, u0, p, algo="gmres", tol_rel=1e-10, M=fft_poisson(),
            delta0=d0, max_steps=60)
        rec = {"newton_outer": int(info_n.stats.outer_iterations),
               "newton_solved": bool(info_n.solved),
               "ptc_outer": int(info_p.stats.outer_iterations),
               "ptc_inner": int(info_p.stats.inner_iterations),
               "ptc_solved": bool(info_p.solved)}
        print(f"{amp:5.1f} {rec['newton_outer']:>14} {rec['ptc_outer']:>11}")
        assert rec["ptc_solved"]
        assert rec["ptc_outer"] <= rec["newton_outer"]
        out[amp] = rec
    return out


def main(device="cuda", plot=False) -> dict:
    del plot  # the JAX example draws no figure
    dev = _common.resolve_device(device)
    return {"arctan": arctan_comparison(dev),
            "bratu": bratu_rough_starts(dev)}


if __name__ == "__main__":
    _common.cli(main, __doc__)
