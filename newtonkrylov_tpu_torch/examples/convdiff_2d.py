"""Convection–diffusion recipe gallery — the NONSYMMETRIC regime.

Counterpart of ``examples/convdiff_2d.py``.  The manufactured forcing makes
u* = sin(πx)sin(πy) the exact discrete root on the 96² grid, so every
recipe is checked against it:

* moderate convection (c = 2): DST-Poisson-preconditioned GMRES works;
* convection-dominated (c = 25): restarted DST-GMRES stalls (the
  preconditioned spectrum straddles the origin) — a negative recipe — and
  unrestarted it limps;
* ADI line relaxation (``precond.adi``; PCR line solves on the card)
  solves both, including the f32-Krylov + df32-acceptance path;
* variable-coefficient multigrid (``mg.multigrid2d_general``), the
  ADI-smoothed V-cycle on the probed nonsymmetric fields;
* ILU(0) in host C++, the reference's recipe, through the host-stepped
  driver: on the card each apply copies the vector to the host and back
  (``precond.HOST_COPIES``, printed).
"""

from __future__ import annotations

import torch

from newtonkrylov_tpu_torch import newton_krylov, newton_krylov_jit, precond
from newtonkrylov_tpu_torch.examples import _common
from newtonkrylov_tpu_torch.fftprec import fft_poisson
from newtonkrylov_tpu_torch.mg import multigrid2d_general
from newtonkrylov_tpu_torch.precond import adi, ilu0
from newtonkrylov_tpu_torch.problems import convdiff2d

FULL = {"restart": None, "itmax": 400}


def run(tag, n, c, dev, M=None, N_pre=None, driver="jit", expect_fail=False,
        krylov_override=None, **kw) -> dict:
    f64 = torch.float64
    p = convdiff2d.default_config(n, c=c, dtype=f64, device=dev)
    u0 = convdiff2d.initial_guess(n, f64, device=dev)
    drv = newton_krylov_jit if driver == "jit" else newton_krylov
    precond.reset_host_copies()
    u, info = drv(convdiff2d.residual_scaled, u0, p,
                  algo="gmres", forcing=None, M=M, N=N_pre,
                  krylov_kwargs=dict(krylov_override or FULL), **kw)
    us = convdiff2d.manufactured_solution(n, f64, device=dev)
    err = float(torch.max(torch.abs(u - us)))
    note = "  (expected: does NOT converge)" if expect_fail else ""
    copies = ""
    if N_pre is not None and getattr(N_pre, "host_side", False):
        copies = (f" host copies {precond.HOST_COPIES['device_to_host']} to the "
                  f"host, {precond.HOST_COPIES['host_to_device']} back")
    print(f"{tag:36s} solved={str(bool(info.solved)):5s} "
          f"outer={int(info.stats.outer_iterations):3d} "
          f"inner={int(info.stats.inner_iterations):5d} "
          f"max|u-u*|={err:.2e}{note}{copies}")
    if expect_fail and bool(info.solved):
        raise AssertionError(f"negative recipe {tag!r} unexpectedly converged")
    if not expect_fail:
        assert bool(info.solved), tag
    return {"solved": bool(info.solved),
            "outer": int(info.stats.outer_iterations),
            "inner": int(info.stats.inner_iterations),
            "n_res": float(info.stats.n_res), "err": err,
            "host_copies": dict(precond.HOST_COPIES), "u": u}


def main(device="cuda", plot=False, n=96) -> dict:
    dev = _common.resolve_device(device)
    out = {}
    print(f"--- c = 2 (moderate convection), n = {n} ---")
    out["c2 dst"] = run("gmres + DST Poisson", n, 2.0, dev, M=fft_poisson(),
                        tol_rel=1e-10)
    out["c2 adi"] = run("gmres + ADI(4)", n, 2.0, dev, M=adi(4), tol_rel=1e-10)

    print("--- c = 25 (convection-dominated) ---")
    # The DST-preconditioned spectrum straddles the origin past c ~ 6:
    # restarted GMRES stalls outright, and even an unrestarted 400-dim
    # Krylov space limps at ~350 inners per outer.
    out["c25 dst restarted"] = run(
        "gmres(restart=40) + DST Poisson", n, 25.0, dev, M=fft_poisson(),
        tol_rel=1e-10, max_niter=6, expect_fail=True,
        krylov_override={"restart": 40, "itmax": 400})
    out["c25 dst full"] = run("gmres(full) + DST  [26x ADI cost]", n, 25.0, dev,
                              M=fft_poisson(), tol_rel=1e-10, max_niter=15)
    out["c25 adi"] = run("gmres + ADI(4)  [on-device]", n, 25.0, dev, M=adi(4),
                         tol_rel=1e-10, max_niter=15)
    out["c25 mg"] = run("gmres + MG-general  [multilevel]", n, 25.0, dev,
                        M=multigrid2d_general(), tol_rel=1e-10, max_niter=15)
    out["c25 adi df32"] = run(
        "gmres + ADI(4) + df32 to 1e-8", n, 25.0, dev, M=adi(4), tol_rel=1e-8,
        max_niter=15, krylov_dtype=torch.float32,
        residual_df=convdiff2d.residual_scaled_df)
    out["c25 mg df32"] = run(
        "gmres + MG-general + df32 1e-8", n, 25.0, dev, M=multigrid2d_general(),
        tol_rel=1e-8, max_niter=15, krylov_dtype=torch.float32,
        residual_df=convdiff2d.residual_scaled_df)
    out["c25 ilu0"] = run(
        "gmres + ILU0  [host, reference]", n, 25.0, dev,
        N_pre=ilu0(offsets=(-n, -1, 0, 1, n)), driver="host",
        tol_rel=1e-10, max_niter=15)

    if plot:
        plt = _common.pyplot()
        u = _common.numpy(out["c25 adi"]["u"])
        us = _common.numpy(convdiff2d.manufactured_solution(n, torch.float64, device=dev))
        fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(9, 3.6))
        im = ax0.imshow(u, origin="lower", extent=(0, 1, 0, 1))
        fig.colorbar(im, ax=ax0, shrink=0.8)
        ax0.set_title(f"convdiff c=25, n={n} (ADI, on device)")
        im = ax1.imshow(abs(u - us), origin="lower", extent=(0, 1, 0, 1))
        fig.colorbar(im, ax=ax1, shrink=0.8)
        ax1.set_title("error vs manufactured root")
        _common.save_plot(fig, "convdiff2d.png")
    for r in out.values():
        del r["u"]
    return out


if __name__ == "__main__":
    _common.cli(main, __doc__, n=96)
