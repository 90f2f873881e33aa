"""The df32 acceptance floor per size, and the probes that estimate it.

Counterpart of ``benchmarks/floor_probe.py``.  A df32-carried Newton solve
cannot push ‖F‖ below a floor set by the state's representation
granularity.  This script measures that floor — it drives the flagship
(DST-PCG ``precision="high"`` built once, f32 Krylov CG, the df32
acceptance residual) with ``tol_rel=0``, ``tol_abs=1e-30`` and the floor
clamp off (``floor_rtol=None``) for ``MAX_NITER`` outers and records where
‖F‖ plateaus (the least entry of the history) — and evaluates, at u₀ and at
the solve's end state u*, the probes:

* ``coh``: ‖F(u ⊕ ε_dd·|u|) − F(u)‖, a coherent perturbation of one ulp of
  the lo word (ε_dd = 2⁻⁴⁷);
* ``chk``: the same with checkerboard signs;
* ``rnd``: the same with the JAX script's hashed signs (its hash
  ``(31-bit row and column multipliers) & 0xFFFF`` has the parity of
  row + column, so ``rnd`` equals ``chk`` on this grid);
* ``jvp``: the library's :func:`~newtonkrylov_tpu_torch.df32.floor_estimate`,
  the estimate the drivers clamp their tolerance to (×``floor_rtol``).

Each size prints its plateau beside the JAX package's v5e record (a TPU
measurement: ``newtonkrylov_tpu/df32.py``'s notes) and the ratio of the
raw probe (``4·floor_estimate``, before the calibration's division) to the
plateau, which the JAX package measured at 6.28–6.38.  The drivers' guard
holds when ``floor_estimate(u₀)`` is at or above the plateau.

Run on the card (``--device cpu`` for a small rehearsal):

    python -m newtonkrylov_tpu_torch.benchmarks.floor_probe [--sizes 512 1024 2048 4096]
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Dict, List, Optional, Sequence

import torch

LAM = 5.0
EPS_DD = 2.0 ** -47
MAX_NITER = 14
# The JAX package's plateaus on a v5e (TPU measurements, not the port's):
# newtonkrylov_tpu/df32.py, the notes of floor_estimate.
V5E_PLATEAU = {512: 1.148e-12, 1024: 2.282e-12, 2048: 4.638e-12,
               4096: 9.130e-12}
V5E_RATIO = (6.28, 6.38)


def signs(kind: str, shape, device) -> torch.Tensor:
    """±1 in f32: ``coh`` all +1, ``chk`` (−1)^(row+col), ``rnd`` the JAX
    script's hashed sign (row·2654435761 + col·40503) & 0xFFFF, even → +1."""
    rows = torch.arange(shape[0], device=device).reshape(-1, 1).expand(shape)
    cols = torch.arange(shape[1], device=device).reshape(1, -1).expand(shape)
    if kind == "coh":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if kind == "chk":
        even = (rows + cols) % 2 == 0
    else:
        even = ((rows * 2654435761 + cols * 40503) & 0xFFFF) % 2 == 0
    return torch.where(even, 1.0, -1.0).to(torch.float32)


def probes(u_df, n: int) -> Dict[str, float]:
    """The four probes of the module at the df32 state ``u_df``."""
    from .. import df32 as dd
    from ..problems import bratu2d

    p = bratu2d.default_config(n, lam=LAM)
    r0 = bratu2d.residual_scaled_df(u_df, p)
    out = {}
    for kind in ("coh", "chk", "rnd"):
        delta = (u_df.hi.abs() * torch.tensor(EPS_DD, dtype=torch.float32)
                 * signs(kind, tuple(u_df.hi.shape), u_df.hi.device))
        r1 = bratu2d.residual_scaled_df(dd.tree_add_f32(u_df, delta), p)
        out[kind] = float(torch.linalg.vector_norm(dd.sub(r1, r0).hi))
    out["jvp"] = float(dd.floor_estimate(
        bratu2d.residual_scaled, u_df.hi.to(torch.float32), p))
    return out


def plateau_solve(n: int, device):
    """(u₀, u*, info, history) of the flagship driven past any tolerance
    for ``MAX_NITER`` outers."""
    from ..fftprec import fft_poisson
    from ..newton import newton_krylov_jit
    from ..problems import bratu2d

    p = bratu2d.default_config(n, lam=LAM)
    u0 = bratu2d.initial_guess(n, dtype=torch.float64, device=device)
    u, info = newton_krylov_jit(
        bratu2d.residual_scaled, u0, p, algo="cg", tol_rel=0.0,
        tol_abs=1e-30, krylov_dtype=torch.float32,
        residual_df=bratu2d.residual_scaled_df, max_niter=MAX_NITER,
        M=fft_poisson(precision="high"), precond_refresh="once",
        floor_rtol=None)
    hist = info.history.detach().cpu().double()
    return u0, u, info, hist[torch.isfinite(hist)].tolist()


def run_size(n: int, device, log=print) -> dict:
    """The plateau and the probes at n² (see the module); the record."""
    from .. import df32 as dd
    from ..problems import bratu2d

    t0 = time.perf_counter()
    u0, u, info, hist = plateau_solve(n, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plateau = min(hist)
    p = bratu2d.default_config(n, lam=LAM)
    at0 = probes(dd.df_from_f64(u0), n)
    u_df = dd.df_from_f64(u)
    at_star = probes(u_df, n)
    r_star = bratu2d.residual_scaled_df(u_df, p)
    rec = {"n": n, "outer": int(info.stats.outer_iterations),
           "inner": int(info.stats.inner_iterations), "wall_s": wall,
           "res0": hist[0], "plateau": plateau, "history": hist,
           "probes_u0": at0, "probes_ustar": at_star,
           "lo_star": float(torch.linalg.vector_norm(r_star.lo)),
           "hi_star": float(torch.linalg.vector_norm(r_star.hi)),
           "ratio_u0": 4.0 * at0["jvp"] / plateau,
           "ratio_ustar": 4.0 * at_star["jvp"] / plateau,
           "v5e_plateau": V5E_PLATEAU.get(n)}
    log(f"n={n}: {rec['outer']} outers / {rec['inner']} inners in {wall:.3f} s; "
        f"|F0|={hist[0]:.3e} plateau(min |F|)={plateau:.3e} "
        f"rel={plateau / hist[0]:.3e}  tail={['%.3e' % h for h in hist[-6:]]}")
    for tag, pr in (("u0", at0), ("u*", at_star)):
        log(f"n={n}: probes at {tag}  "
            + " ".join(f"{k}={v:.3e}" for k, v in pr.items()))
    log(f"n={n}: |lo(F(u*))|={rec['lo_star']:.3e} |hi(F(u*))|={rec['hi_star']:.3e}")
    v5e = rec["v5e_plateau"]
    log(f"n={n}: floor_estimate(u0) {at0['jvp']:.4e} "
        f"{'>=' if at0['jvp'] >= plateau else '<'} plateau {plateau:.4e}; "
        f"probe/plateau (4·floor_estimate / plateau) {rec['ratio_u0']:.3f} at "
        f"u0, {rec['ratio_ustar']:.3f} at u*; the JAX package's v5e record "
        f"(TPU): plateau {'not recorded' if v5e is None else f'{v5e:.3e}'}, "
        f"ratio {V5E_RATIO[0]}–{V5E_RATIO[1]}")
    if not math.isfinite(plateau) or plateau <= 0:
        raise AssertionError(f"floor_probe n={n}: no finite plateau")
    return rec


def run(sizes: Sequence[int] = (512, 1024, 2048, 4096), device="cuda",
        log=print) -> List[dict]:
    """Every size in order (see the module).  The card by default: without
    CUDA it raises unless ``device="cpu"``."""
    from ..examples import _common

    dev = _common.resolve_device(device)
    return [run_size(n, dev, log) for n in sizes]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[512, 1024, 2048, 4096])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.sizes, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
