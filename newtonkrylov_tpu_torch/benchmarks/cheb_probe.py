"""The preconditioner lanes of the df32 refined solve at 1024² and 2048².

Counterpart of ``benchmarks/cheb_probe.py``.  2-D Bratu at λ = 5, CG with
the df32 acceptance residual, ``tol_rel=1e-8``, ``max_niter=30`` (the JAX
script's settings: the Krylov loop in the state's dtype, f64), from the f64
u₀, in the lanes:

* plain CG (no preconditioner);
* DST-PCG (``fft_poisson()``);
* Cheb-PCG (``chebyshev(16)``: on the card one K4 launch per apply);
* two-grid (``two_grid(smoother_degree=d, engine="pallas")`` for d = 4, 8,
  16: on the card K4 runs each smoothing, two launches per apply).

Each lane: the mean wall of ``reps`` solves after a warm one (each ended by
a synchronization), ``solved`` and the counts, and the K4 launches of one
solve against its preconditioner applies.

Run on the card (``--device cpu`` for a small rehearsal):

    python -m newtonkrylov_tpu_torch.benchmarks.cheb_probe [--sizes 1024 2048]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import torch

from .chain_solve import _synchronize
from .xl8192 import counting

LAM = 5.0


def lanes():
    """(label, factory) of every lane, in the JAX script's order."""
    from ..fftprec import fft_poisson
    from ..precond import chebyshev, two_grid

    out = [("plain", None), ("DST-PCG", fft_poisson())]
    out += [(f"two-grid({d})", two_grid(smoother_degree=d, engine="pallas"))
            for d in (4, 8, 16)]
    out.append(("cheb(16)-CG", chebyshev(degree=16)))
    return out


def lane(n: int, M, label: str, device, reps: int = 3, log=print) -> dict:
    """One lane at n² (see the module); raises if the solve fails."""
    from ..kernels import stencil2d as k
    from ..newton import newton_krylov_jit
    from ..problems import bratu2d

    p = bratu2d.default_config(n, lam=LAM)
    u0 = bratu2d.initial_guess(n, dtype=torch.float64, device=device)
    counter = {"applies": 0}

    def solve():
        return newton_krylov_jit(
            bratu2d.residual_scaled, u0, p, algo="cg", tol_rel=1e-8,
            max_niter=30, residual_df=bratu2d.residual_scaled_df,
            M=None if M is None else counting(M, counter))

    k4 = k.LAUNCHES["chebyshev_apply"]
    _, info = solve()
    _synchronize(info.stats.n_res)
    k4 = k.LAUNCHES["chebyshev_apply"] - k4
    applies = counter["applies"]
    t0 = time.perf_counter()
    for _ in range(reps):
        _, info = solve()
        _synchronize(info.stats.n_res)
    ms = (time.perf_counter() - t0) / reps * 1e3
    rec = {"lane": label, "n": n, "ms": ms, "solved": bool(info.solved),
           "outer": int(info.stats.outer_iterations),
           "inner": int(info.stats.inner_iterations), "applies": applies,
           "k4_launches": k4}
    log(f"n={n} {label:18s}: {ms:9.1f} ms  solved={rec['solved']} "
        f"outer={rec['outer']} inner={rec['inner']}  K4 launches {k4} for "
        f"{applies} applies")
    if not rec["solved"]:
        raise AssertionError(f"cheb_probe n={n} [{label}]: not solved")
    return rec


def run(sizes: Sequence[int] = (1024, 2048), device="cuda", reps: int = 3,
        log=print) -> List[dict]:
    """Every lane at every size.  The card by default: without CUDA it
    raises unless ``device="cpu"``."""
    from ..examples import _common

    dev = _common.resolve_device(device)
    return [lane(n, M, label, dev, reps, log)
            for n in sizes for label, M in lanes()]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[1024, 2048])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    run(a.sizes, a.device, a.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
