"""1-D heat equation with implicit steppers and step-Jacobian analysis.

Counterpart of ``examples/heat_1d.py`` (the reference's
examples/heat_1D.jl): the rank and condition studies of the three steppers'
step Jacobians (dense at N = 10, then matrix-free — agreement with the
dense oracle at N = 10 and a Lanczos lower bound at N = 10⁵, where the
dense matrix would take 80 GB), and the L = 1, M = 100, a = 0.2, Δt = 0.1
march to t = 3 with all three steppers.  ``t_final`` cuts the march's
depth: each step traces its linearization on the host (ROADMAP Queue 1
item 23).
"""

from __future__ import annotations

import numpy as np
import torch

from newtonkrylov_tpu_torch.examples import _common
from newtonkrylov_tpu_torch.operator import JacobianOperator
from newtonkrylov_tpu_torch.problems import heat1d
from newtonkrylov_tpu_torch.spectral import cond2_estimate
from newtonkrylov_tpu_torch.timestep import STEPPERS, StepParams, integrate, step_jacobian

NAMES = ("euler", "midpoint", "trapezoid")


def jacobian_study(dev) -> dict:
    """cf. examples/heat_1D.jl:55-93: rank/cond per stepper."""
    N = 10
    p = heat1d.Params(a=0.5, dx=1.0 / (N + 1), bc="dirichlet")
    z = torch.zeros(N + 2, dtype=torch.float64, device=dev)
    out = {}
    for name in NAMES:
        J = _common.numpy(step_jacobian(name, heat1d.rhs, z, p, 0.1))
        out[name] = {"rank": int(np.linalg.matrix_rank(J)),
                     "cond": float(np.linalg.cond(J))}
        print(f"{name:10s} rank={out[name]['rank']} cond={out[name]['cond']:.4g}")
    Jp = _common.numpy(step_jacobian(
        "euler", heat1d.rhs, z,
        heat1d.Params(a=0.5, dx=1.0 / (N + 1), bc="periodic"), 0.1))
    out["euler+periodic"] = {"rank": int(np.linalg.matrix_rank(Jp))}
    print(f"euler+periodic rank={out['euler+periodic']['rank']}")
    return out


def _step_operator(name, n, dev):
    p = heat1d.Params(a=0.5, dx=1.0 / (n + 1), bc="dirichlet")
    z = torch.zeros(n + 2, dtype=torch.float64, device=dev)
    sp = StepParams(un=z, dt=0.1, p=p, t=0.0)
    return JacobianOperator(STEPPERS[name](heat1d.rhs), z, sp), p


def jacobian_study_matrix_free(dev) -> dict:
    """The same cond study, matrix-free (:mod:`~newtonkrylov_tpu_torch.spectral`)
    — at a size where the dense matrix and its condition number (the
    reference's only tool, examples/implicit.jl:41-50) are out of reach."""
    N = 10
    out = {}
    for name in NAMES:
        J, p = _step_operator(name, N, dev)
        J_dense = _common.numpy(step_jacobian(name, heat1d.rhs, J.u, p, 0.1))
        k_dense = float(np.linalg.cond(J_dense))
        k_mf = float(cond2_estimate(J, k=N + 2))
        out[name] = {"cond_dense": k_dense, "cond_mf": k_mf}
        print(f"{name:10s} cond(dense)={k_dense:.6g} "
              f"cond(matrix-free, k=n)={k_mf:.6g}")

    # at N = 10⁵ the dense matrix is 80 GB; one Lanczos run on the normal
    # operator does it matrix-free.  The Lanczos extremes of this Jacobian
    # are quadratically clustered, so at k ≪ n the estimate is a LOWER
    # bound (like LAPACK's 1-norm estimators)
    J, _ = _step_operator("euler", 100_000, dev)
    out["lower_bound"] = float(cond2_estimate(J, k=128))
    print(f"euler N=1e5 cond2 >= {out['lower_bound']:.4g} "
          f"(k=128 Lanczos lower bound)")
    return out


def march(dev, plot=False, t_final=3.0) -> dict:
    m, a, dt = 100, 0.2, 0.1
    p = heat1d.default_config(m, a)
    x = heat1d.grid(m, device=dev)
    u0 = heat1d.clamp_bc(heat1d.initial_condition(x), p)
    out = {}
    hists = {}
    for name in NAMES:
        r = integrate(name, heat1d.rhs, u0, p, dt, t_final, save_history=plot)
        assert r.n_failed == 0
        out[name] = {"n_failed": r.n_failed, "u": _common.numpy(r.u),
                     "outer": _common.numpy(r.outer_iterations),
                     "inner": _common.numpy(r.inner_iterations)}
        hists[name] = r.history
    if plot:
        plt = _common.pyplot()
        fig, axs = plt.subplots(1, 3, figsize=(14, 4), sharey=True)
        for ax, name in zip(axs, NAMES):
            for row in _common.numpy(hists[name]):
                ax.plot(_common.numpy(x), row, lw=0.8)
            ax.set_title(name)
        _common.save_plot(fig, "heat1d.png")
    return out


def main(device="cuda", plot=False, t_final=3.0) -> dict:
    dev = _common.resolve_device(device)
    return {"dense": jacobian_study(dev),
            "matrix_free": jacobian_study_matrix_free(dev),
            "march": march(dev, plot, t_final)}


if __name__ == "__main__":
    _common.cli(main, __doc__, t_final=3.0)
