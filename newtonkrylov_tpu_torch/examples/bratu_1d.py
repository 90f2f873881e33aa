"""1-D Bratu solver-recipe gallery.

Counterpart of ``examples/bratu_1d.py`` (the reference's
examples/bratu.jl): N = 10000, λ = 3.51382, u₀ = sin(πx), through the
host-stepped ``newton_krylov``; recipes: CG (recommended), fixed and
disabled forcing, GMRES + ILU(0) (host C++: one copy to the host and one
back per apply on the card), GMRES + banded direct (refined PCR on the
card).  The error is checked against the cosh closed form.

The gallery also prints the reference's NEGATIVE recipes
(examples/bratu.jl:110-118, 159-177): restarted GMRES stalls without a
preconditioner at this conditioning (κ ~ N²), and BiCGStab and CGLS fail.

The three CG recipes take tens of thousands of host-stepped CG iterations
at N = 10⁴; ``cg_n`` runs them at another size (the discretization error
then scales with Δx²).
"""

from __future__ import annotations

import torch

from newtonkrylov_tpu_torch import Fixed, newton_krylov, precond
from newtonkrylov_tpu_torch.examples import _common
from newtonkrylov_tpu_torch.problems import bratu1d


def run(tag, n, dev, expect_fail=False, **kw) -> dict:
    p = bratu1d.default_config(n)
    precond.reset_host_copies()
    u, info = newton_krylov(bratu1d.residual,
                            bratu1d.initial_guess(n, device=dev), p, **kw)
    err = float(torch.max(torch.abs(
        u - bratu1d.true_solution(bratu1d.grid(n, device=dev)))))
    note = "  (expected: does NOT converge)" if expect_fail else ""
    print(f"{tag:28s} solved={str(bool(info.solved)):5s} outer={info.stats.outer_iterations:3d} "
          f"inner={info.stats.inner_iterations:6d} max|u-u*|={err:.2e} t={info.t:.2f}s{note}")
    if expect_fail and bool(info.solved):
        raise AssertionError(f"negative recipe {tag!r} unexpectedly converged")
    return {"n": n, "solved": bool(info.solved),
            "outer": info.stats.outer_iterations,
            "inner": info.stats.inner_iterations,
            "n_res": float(info.stats.n_res), "err": err, "t": info.t,
            "host_copies": dict(precond.HOST_COPIES),
            "expect_fail": expect_fail, "u": u}


def main(device="cuda", plot=False, cg_n=None) -> dict:
    dev = _common.resolve_device(device)
    n = 10_000
    cg_n = cg_n or n
    out = {}
    out["cg (recommended)"] = run("cg (recommended)", cg_n, dev, algo="cg")
    out["cg + Fixed(0.1)"] = run("cg + Fixed(0.1)", cg_n, dev, algo="cg",
                                 forcing=Fixed(0.1))
    out["cg + exact Newton"] = run("cg + exact Newton", cg_n, dev, algo="cg",
                                   forcing=None)
    out["gmres + ILU0 (host C++)"] = run(
        "gmres + ILU0 (host C++)", n, dev, algo="gmres",
        N=precond.ilu0(bandwidth=1))
    out["gmres + banded direct"] = run(
        "gmres + banded direct", n, dev, algo="gmres", N=precond.banded_direct())

    # --- negative recipes (examples/bratu.jl:110-118,159-177) -------------
    print("--- negative recipes (reference divergence table) ---")
    out["gmres, NO preconditioner"] = run(
        "gmres, NO preconditioner", n, dev, expect_fail=True, algo="gmres",
        max_niter=4, krylov_kwargs={"restart": 20, "itmax": 60})
    out["bicgstab"] = run("bicgstab", n, dev, expect_fail=True, algo="bicgstab",
                          max_niter=4, krylov_kwargs={"itmax": 60})
    out["cgls"] = run("cgls", n, dev, expect_fail=True, algo="cgls",
                      max_niter=4, krylov_kwargs={"itmax": 60})

    if plot:
        plt = _common.pyplot()
        x = bratu1d.grid(cg_n, device=dev)
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(_common.numpy(x), _common.numpy(bratu1d.initial_guess(cg_n, device=dev)),
                label="initial guess sin(πx)")
        ax.plot(_common.numpy(x), _common.numpy(bratu1d.true_solution(x)),
                label="analytic")
        ax.plot(_common.numpy(x), _common.numpy(out["cg (recommended)"]["u"]), "--",
                label="Newton–Krylov")
        ax.legend()
        ax.set_title(f"1-D Bratu, N={cg_n}, λ=3.51382")
        _common.save_plot(fig, "bratu1d.png")
    for r in out.values():
        r["u"] = _common.numpy(r["u"])
    return out


if __name__ == "__main__":
    _common.cli(main, __doc__, cg_n=None)
