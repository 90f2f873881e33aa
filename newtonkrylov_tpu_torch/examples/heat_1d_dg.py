"""Heat equation by DG / upwind operator composition ``du = D1m @ (D1p @ u)``.

Counterpart of ``examples/heat_1d_dg.py`` (the reference's
examples/heat_1D_DG.jl): the polydeg-3 × 40-element Legendre DG pair and
the order-3 periodic upwind pair, the DG backward-Euler step Jacobian's
condition number, and both marches with Δt = 0.0005 to t = 0.05.
``t_final`` cuts the marches' depth: each step traces its linearization on
the host (ROADMAP Queue 1 item 23).
"""

from __future__ import annotations

import numpy as np
import torch

from newtonkrylov_tpu_torch.examples import _common
from newtonkrylov_tpu_torch.problems import heat1d_dg
from newtonkrylov_tpu_torch.timestep import integrate, step_jacobian


def run(tag, p, dt=0.0005, t_final=0.05, save_history=False) -> dict:
    u0 = heat1d_dg.initial_condition(p)
    r = integrate("euler", heat1d_dg.rhs, u0, p, dt, t_final,
                  save_history=save_history)
    n0, n1 = float(torch.linalg.norm(u0)), float(torch.linalg.norm(r.u))
    print(f"{tag:18s} failed={r.n_failed} |u0|={n0:.4f} -> |u|={n1:.4f}")
    return {"n_failed": r.n_failed, "norm_u0": n0, "norm_u": n1,
            "u": _common.numpy(r.u), "history": r.history,
            "outer": _common.numpy(r.outer_iterations),
            "inner": _common.numpy(r.inner_iterations)}


def main(device="cuda", plot=False, t_final=0.05) -> dict:
    dev = _common.resolve_device(device)
    p_dg = heat1d_dg.dg_config(polydeg=3, elements=40, device=dev)
    J = _common.numpy(step_jacobian("euler", heat1d_dg.rhs,
                                    torch.zeros_like(p_dg.x), p_dg, 0.1))
    cond = float(np.linalg.cond(J))
    print(f"DG euler step-Jacobian: shape={J.shape} cond={cond:.4g}")

    configs = [("legendre DG", p_dg),
               ("upwind order-3", heat1d_dg.upwind_config(nnodes=120, device=dev))]
    out = {"cond": cond, "shape": J.shape}
    for tag, p in configs:
        out[tag] = run(tag, p, t_final=t_final, save_history=plot)
    if plot:
        plt = _common.pyplot()
        fig, axs = plt.subplots(1, 2, figsize=(12, 4))
        for ax, (tag, p) in zip(axs, configs):
            hist = _common.numpy(out[tag]["history"])
            ax.plot(_common.numpy(p.x), hist[0], label="t=0")
            ax.plot(_common.numpy(p.x), hist[-1], label="t=end")
            ax.set_title(tag)
            ax.legend()
        _common.save_plot(fig, "heat1d_dg.png")
    for tag, _ in configs:
        del out[tag]["history"]
    return out


if __name__ == "__main__":
    _common.cli(main, __doc__, t_final=0.05)
