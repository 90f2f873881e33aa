"""Kelley2003 2×2 system: Newton-path traces over the residual-norm contour.

Counterpart of ``examples/simple_2d.py``: three starting points through the
host-stepped ``newton_krylov`` with a callback that records the path, the
third with the tuned forcing ``EisenstatWalker(eta_max=0.68949)``.
"""

from __future__ import annotations

import numpy as np
import torch

from newtonkrylov_tpu_torch import EisenstatWalker, newton_krylov
from newtonkrylov_tpu_torch.examples import _common
from newtonkrylov_tpu_torch.problems import simple

STARTS = (
    ([2.0, 0.5], {}),
    ([2.5, 3.0], {}),
    ([3.0, 4.0], {"forcing": EisenstatWalker(eta_max=simple.TUNED_ETA_MAX)}),
)


def trace_from(x0, device, **kw) -> dict:
    pts = []
    u, info = newton_krylov(
        simple.residual, torch.tensor(x0, dtype=torch.float64, device=device),
        callback=lambda u, res, n: pts.append(_common.numpy(u)),
        **kw,
    )
    u = _common.numpy(u)
    print(f"x0={x0}: solved={bool(info.solved)} "
          f"outer={info.stats.outer_iterations} inner={info.stats.inner_iterations} "
          f"-> {u.round(6)}")
    return {"x0": x0, "solved": bool(info.solved),
            "outer": info.stats.outer_iterations,
            "inner": info.stats.inner_iterations,
            "n_res": float(info.stats.n_res), "u": u, "trace": np.array(pts)}


def main(device="cuda", plot=False) -> dict:
    dev = _common.resolve_device(device)
    runs = [trace_from(x0, dev, **kw) for x0, kw in STARTS]
    if plot:
        plt = _common.pyplot()
        xs = np.linspace(-3, 8, 300)
        ys = np.linspace(-15, 10, 300)
        X, Y = np.meshgrid(xs, ys)
        Z = np.hypot(X**2 + Y**2 - 2, np.exp(X - 1) + Y**2 - 2)
        fig, ax = plt.subplots(figsize=(7, 6))
        ax.contour(X, Y, Z, levels=np.geomspace(0.1, 4000, 25), linewidths=0.5)
        for r in runs:
            t = r["trace"]
            ax.plot(t[:, 0], t[:, 1], "o-", ms=3, label=f"x0={r['x0']}")
        ax.legend()
        ax.set_title("Newton–Krylov paths on the Kelley 2×2 system")
        _common.save_plot(fig, "simple_traces.png")
    return {"runs": runs}


if __name__ == "__main__":
    _common.cli(main, __doc__)
