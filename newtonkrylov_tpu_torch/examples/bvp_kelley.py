"""Kelley2022 two-point BVP, n = 801.

Counterpart of ``examples/bvp_kelley.py`` (the reference's
examples/bvp.jl).  The robust recipe is GMRES + pivoted banded LU(2,2)
(host-side, scipy): the BVP Jacobian is pentadiagonal with zero diagonals
on the BC rows, and its spectrum straddles the origin, which defeats
GMRES-polynomial preconditioning — the reference's FGMRES +
nested-GMRES(30) recipe is shown for comparison; it stalls.

``nested_itmax`` caps each stalling FGMRES inner solve: by default it
runs to the solver's own limit, twice the 1,602 unknowns, each step a
nested GMRES(30) solve issued from the host; a cap of 40 (one restart
cycle) keeps the run short and the recipe stalled.
"""

from __future__ import annotations

from newtonkrylov_tpu_torch import newton_krylov, precond
from newtonkrylov_tpu_torch.examples import _common
from newtonkrylov_tpu_torch.problems import bvp


def main(device="cuda", plot=False, nested_itmax=None) -> dict:
    dev = _common.resolve_device(device)
    p = bvp.default_config(device=dev)
    U0 = bvp.initial_guess(p)

    U, info = newton_krylov(bvp.residual, U0, p, algo="gmres",
                            N=precond.banded_lu(2, 2))
    print(f"banded-LU recipe: solved={bool(info.solved)} outer={info.stats.outer_iterations} "
          f"inner={info.stats.inner_iterations} |F|={info.stats.n_res:.2e}")

    kk = {"restart": 40}
    if nested_itmax is not None:
        kk["itmax"] = nested_itmax
    _, info2 = newton_krylov(
        bvp.residual, U0, p, algo="fgmres",
        N=precond.nested_krylov(itmax=30), krylov_kwargs=kk, max_niter=5,
    )
    cap = "" if nested_itmax is None else f", inner solves capped at {nested_itmax}"
    print(f"reference fgmres+nested recipe (5 outers{cap}): "
          f"|F|={info2.stats.n_res:.2e} (stalls)")

    if plot:
        plt = _common.pyplot()
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(_common.numpy(p.tv), _common.numpy(U[0::2]), label="v(t)")
        ax.plot(_common.numpy(p.tv), _common.numpy(U[1::2]), label="v'(t)")
        ax.legend()
        ax.set_title("Kelley2022 BVP solution, n=801")
        _common.save_plot(fig, "bvp.png")
    return {"banded_lu": {"solved": bool(info.solved),
                          "outer": info.stats.outer_iterations,
                          "inner": info.stats.inner_iterations,
                          "n_res": float(info.stats.n_res),
                          "U": _common.numpy(U)},
            "nested": {"solved": bool(info2.solved),
                       "outer": info2.stats.outer_iterations,
                       "inner": info2.stats.inner_iterations,
                       "n_res": float(info2.stats.n_res)}}


if __name__ == "__main__":
    _common.cli(main, __doc__, nested_itmax=None)
