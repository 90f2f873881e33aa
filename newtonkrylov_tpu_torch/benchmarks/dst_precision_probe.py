"""The DST products' precision against the flagship's wall and counts.

Counterpart of ``benchmarks/dst_precision_probe.py``.  The DST apply is four
n³ sine-basis products and the largest device part of a flagship CG step
(:mod:`.solve_profile`).  The JAX probe set the TPU's six-pass f32 mode
(``"highest"``) against its three-pass bf16 mode (``"high"``), and its
docstring names the single pass (``"default"``: bf16 operands, f32
accumulation) as the mode in question: there the apply was ~3× cheaper but
the flagship took 49 inner iterations instead of 9 at 1024² (309 at 2048²),
a net loss on the TPU.

Here ``"highest"`` and ``"high"`` are the same full-f32 products
(ROADMAP.md hazard (a): TF32 is refused), and ``"default"`` is the bf16
tensor-core product with f32 accumulation (``fftprec``'s notes).  Each lane
is the flagship configuration of :mod:`.chain_solve` (f32 Krylov CG, the
df32 acceptance, ``tol_rel=1e-8``, ``max_niter=20``) with
``fft_poisson(precision=...)`` rebuilt every outer, as the JAX probe ran
it; ``--two-grid`` adds ``two_grid(8, precision=...)`` built once, as the
XL lanes run it.  Per lane it prints solved, the outer / inner counts, the
marginal ms a solve (three chained solves against one, best of two) and
the f64 true residual against :func:`~.chain_solve.clamped_tol`.

Run on the card (``--device cpu`` for a small rehearsal):

    python -m newtonkrylov_tpu_torch.benchmarks.dst_precision_probe [--sizes 1024 2048]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import torch

from . import chain_solve as cs

PRECISIONS = ("highest", "high", "default")
PRECONDITIONERS = ("DST", "two-grid")
# The JAX probe's TPU counts (newtonkrylov_tpu/fftprec.py's notes on
# ``precision``): inner iterations of the DST lane by side and precision,
# TPU measurements, not the port's
TPU_INNERS = {(1024, "highest"): 9, (1024, "default"): 49,
              (2048, "default"): 309}


def factory(precond: str, precision: str) -> tuple:
    """(preconditioner factory, refresh) of a lane."""
    if precond == "DST":
        from ..fftprec import fft_poisson

        return fft_poisson(precision=precision), "outer"
    if precond == "two-grid":
        from ..precond import two_grid

        return two_grid(8, precision=precision), "once"
    raise ValueError(f"unknown preconditioner {precond!r}; one of "
                     f"{PRECONDITIONERS}")


def lane(ns: int, precision: str, device="cuda", precond: str = "DST",
         k_hi: int = 3, repeats: int = 2, timed: bool = True,
         log=print) -> dict:
    """One lane at ns²: its record (solved, counts, the f64 true residual
    and the tolerance the driver accepted at; with ``timed`` the marginal
    seconds a solve; ``first_s``, the wall of the first solve, first use
    at this side included).  Reports; the caller gates."""
    from ..problems import bratu2d

    dev = torch.device(device)
    M, refresh = factory(precond, precision)
    f = cs.make_chain_solve(ns, M, refresh)
    u0 = bratu2d.initial_guess(ns, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    first = f(u0, 1)  # synchronized at its end
    t_first = time.perf_counter() - t0
    info = first.info
    fu, _ = cs.true_residual(first.u, first.u_start)
    tol = cs.clamped_tol(first.u_start)[0]
    rec = {"precond": precond, "precision": precision, "n": ns,
           "solved": bool(info.solved),
           "outer": int(info.stats.outer_iterations),
           "inner": int(info.stats.inner_iterations),
           "floor_limited": bool(info.floor_limited),
           "first_s": t_first, "true_res": fu, "tol": tol,
           "finite": bool(torch.isfinite(first.u).all())
           and tuple(first.u.shape) == (ns, ns)}
    m = None
    if timed:
        m = cs.marginal(f, u0, k_hi=k_hi, repeats=repeats)
        rec.update(marginal_s=m.s, t1_s=m.t1, t_hi_s=m.t_hi, k_hi=k_hi)
    tpu = TPU_INNERS.get((ns, precision)) if precond == "DST" else None
    log(cs.describe(f"{precond} {precision}", ns, m, first)
        + f"; f64 true |F| {fu:.4e} against the accepted tolerance "
        f"{tol:.4e} ({'within' if fu <= tol else 'ABOVE'})"
        + ("" if tpu is None else f"; the JAX probe's TPU inners: {tpu} (TPU)"))
    return rec


def run(sizes: Sequence[int] = (1024, 2048),
        preconds: Sequence[str] = ("DST",), device="cuda",
        timed: bool = True, log=print) -> List[dict]:
    """Every precision's lane at every side; the records in order.  The
    card by default: without CUDA it raises unless ``device="cpu"``."""
    from ..examples import _common

    dev = _common.resolve_device(device)
    if dev.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(0)}")
        log("on this device 'highest' and 'high' are the same full-f32 "
            "products (TF32 refused, ROADMAP.md hazard (a)); 'default' is "
            "the bf16 tensor-core product with f32 accumulation")
    else:
        log("on the CPU 'highest' and 'high' are the same f32 products; "
            "'default' multiplies bf16-rounded operands in f32")
    return [lane(ns, prec, dev, pc, timed=timed, log=log)
            for ns in sizes for pc in preconds for prec in PRECISIONS]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[1024, 2048])
    ap.add_argument("--two-grid", action="store_true",
                    help="add the two-grid lanes")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.sizes, PRECONDITIONERS if a.two_grid else ("DST",), a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
