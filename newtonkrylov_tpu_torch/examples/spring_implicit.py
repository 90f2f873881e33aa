"""Harmonic oscillator: stepper stability comparison over Δt.

Counterpart of ``examples/spring_implicit.py`` (the reference's
examples/spring.jl:44-103): the step-Jacobian probes of the three implicit
steppers, then the damping check — backward Euler damps the amplitude,
the trapezoid rule conserves it — at Δt = 0.1 to t = 40.  The grid of
marches over Δt ∈ {0.01, 0.05, 0.1, 1} that only feeds the figure runs
with ``--plot``.  Every step is a Newton solve that traces its
linearization on the host (ROADMAP Queue 1 item 23), so ``t_final`` cuts
the march's depth for a quick run.
"""

from __future__ import annotations

import torch

from newtonkrylov_tpu_torch.examples import _common
from newtonkrylov_tpu_torch.problems import spring
from newtonkrylov_tpu_torch.timestep import integrate, step_jacobian

STEPPERS = ("euler", "midpoint", "trapezoid")
PLOT_DTS = (0.01, 0.05, 0.1, 1.0)


def main(device="cuda", plot=False, t_final=40.0) -> dict:
    dev = _common.resolve_device(device)
    p = spring.default_config()
    out = {"jacobians": {}, "amplitude": {}, "n_failed": {}, "u": {}}

    for name in STEPPERS:
        J = _common.numpy(step_jacobian(
            name, spring.rhs,
            torch.tensor([0.1, 0.0], dtype=torch.float64, device=dev), p, 0.1))
        out["jacobians"][name] = J
        print(f"{name:10s} step-Jacobian:\n{J}")

    if plot:
        plt = _common.pyplot()
        fig, axs = plt.subplots(len(PLOT_DTS), 3, figsize=(13, 3 * len(PLOT_DTS)),
                                sharex=True)
        for row, h in zip(axs, PLOT_DTS):
            for ax, name in zip(row, STEPPERS):
                r = integrate(name, spring.rhs, spring.initial_condition(device=dev),
                              p, h, t_final, save_history=True)
                ax.plot(_common.numpy(r.ts), _common.numpy(r.history)[:, 0], lw=0.8)
                ax.set_title(f"{name}, Δt={h}")
        _common.save_plot(fig, "spring.png")
    # damping check: euler damps, trapezoid conserves
    for name, expect in (("euler", "damps"), ("trapezoid", "conserves")):
        r = integrate(name, spring.rhs, spring.initial_condition(device=dev), p,
                      0.1, t_final)
        amp = float(torch.abs(r.u[0]))
        out["amplitude"][name] = amp
        out["n_failed"][name] = r.n_failed
        out["u"][name] = _common.numpy(r.u)
        print(f"{name}: final amplitude {amp:.4f} ({expect})")
    return out


if __name__ == "__main__":
    _common.cli(main, __doc__, t_final=40.0)
