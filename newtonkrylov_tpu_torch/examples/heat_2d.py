"""2-D diffusion with all three implicit steppers.

Counterpart of ``examples/heat_2d.py`` (the reference's
examples/heat_2D.jl): a = 0.01 on a 40×40 interior, the explicit-stability
Δt, 40 steps of each stepper with CG (reorthogonalized) as the Newton
inner solver, the peak's decay against the slowest mode's analytic
e^{−2aπ²t}, frames of the decaying sin-bump (a frame strip with
``--plot``), and the periodic constant-field equilibrium.  ``steps`` cuts
the marches' depth: each step traces its linearization on the host
(ROADMAP Queue 1 item 23).
"""

from __future__ import annotations

import numpy as np
import torch

from newtonkrylov_tpu_torch.examples import _common
from newtonkrylov_tpu_torch.problems import heat2d
from newtonkrylov_tpu_torch.timestep import integrate


def main(device="cuda", plot=False, steps=40) -> dict:
    dev = _common.resolve_device(device)
    n = 40
    p = heat2d.default_config(n)
    dt = heat2d.stable_dt(p)
    u0 = heat2d.initial_condition(n, device=dev)
    print(f"dt={dt:.4g} (explicit-stability step, examples/heat_2D.jl:72)")
    out = {"dt": dt}

    for name in ("euler", "midpoint", "trapezoid"):
        frames = []
        r = integrate(
            name, heat2d.rhs, u0, p, dt, steps * dt,
            callback=(lambda u: frames.append(_common.numpy(u))) if plot else None,
            newton_kwargs={"algo": "cg", "krylov_kwargs": {"reorthogonalize": True}},
        )
        decay = float(torch.max(r.u) / torch.max(u0))
        analytic = float(np.exp(-2 * p.a * np.pi**2 * steps * dt))
        print(f"{name:10s} failed={r.n_failed} decay={decay:.4f} "
              f"(analytic {analytic:.4f})")
        out[name] = {"n_failed": r.n_failed, "decay": decay, "analytic": analytic,
                     "u": _common.numpy(r.u),
                     "outer": _common.numpy(r.outer_iterations),
                     "inner": _common.numpy(r.inner_iterations)}
        if plot:
            plt = _common.pyplot()
            fig, axs = plt.subplots(1, 5, figsize=(16, 3.2))
            for ax, idx in zip(axs, np.linspace(0, len(frames) - 1, 5).astype(int)):
                ax.imshow(frames[idx], origin="lower", extent=(0, 1, 0, 1),
                          vmin=0, vmax=1)
                ax.set_title(f"step {idx+1}")
            _common.save_plot(fig, f"heat2d_{name}.png")

    # periodic BCs: a constant field is an equilibrium
    pp = heat2d.default_config(16, bc="periodic")
    du = heat2d.rhs(torch.ones((16, 16), dtype=torch.float64, device=dev), pp)
    out["periodic_residual"] = float(torch.max(torch.abs(du)))
    print("periodic constant-field residual:", out["periodic_residual"])
    return out


if __name__ == "__main__":
    _common.cli(main, __doc__, steps=40)
