"""The large-side regime on one card: 8192² Bratu solves.

Counterpart of ``benchmarks/xl8192.py``.  Past ``fftprec._MATMUL_MAX_N``
(4096) the flagship's DST takes the FFT engine, which the JAX package could
not compile at 8192², so its decision guide sends larger sides on one
device to the geometric V-cycle.  This script runs the flagship configuration (f32 Krylov CG, the df32
acceptance residual, ``tol_rel=1e-8``, ``max_niter=20``) at 8192² — 67 M
unknowns — through the chained-solve protocol of :mod:`.chain_solve`, in
three lanes:

* ``MG-PCG``: ``multigrid2d()`` rebuilt every outer;
* ``two-grid``: ``two_grid(8, precision="high")`` built once, the plain
  Chebyshev smoother (``engine="xla"``);
* ``two-grid pallas``: the same with ``engine="pallas"``: K4 runs each
  smoothing, two launches an apply;

and, for the DST engines' comparison, the flagship's own preconditioner
(``"DST flagship"``, the engine ``fftprec`` picks by side; ``"DST fft"``,
the FFT engine at any side).

Each lane is gated: ``solved``, and the f64 true residual of the returned
state at most the tolerance the driver accepted at (clamped to the df32
floor).  A failed gate raises.  Per lane it prints the marginal wall (k_hi
chained solves against one), the counts, ``floor_limited``, the peak of
``torch.cuda.max_memory_allocated()``, the device-busy share of the first
solve under ``torch.profiler`` and, for the pallas lane, K4's launches against
the preconditioner's applies; for MG-PCG the host and device time of one
V-cycle apply.

Run on the card (``--device cpu`` for a small rehearsal):

    python -m newtonkrylov_tpu_torch.benchmarks.xl8192 [--sizes 8192]
"""

from __future__ import annotations

import argparse
import gc
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from . import chain_solve as cs

LANES = ("MG-PCG", "two-grid", "two-grid pallas")
# the flagship's own preconditioner by its DST engine (fftprec.fft_poisson's
# ``method``): "auto" takes the matrix products up to _MATMUL_MAX_N (4096)
# and the FFTs above; "DST fft" forces the FFTs at any side
DST_LANES = {"DST flagship": "auto", "DST fft": "fft"}


def lane_factory(tag: str) -> tuple:
    """(preconditioner factory, refresh) of lane ``tag``: one of
    :data:`LANES` or of :data:`DST_LANES` (the flagship's own, by engine)."""
    from ..mg import multigrid2d
    from ..precond import two_grid

    if tag == "MG-PCG":
        return multigrid2d(), "outer"
    if tag == "two-grid":
        return two_grid(8, precision="high"), "once"
    if tag == "two-grid pallas":
        return two_grid(8, precision="high", engine="pallas"), "once"
    if tag in DST_LANES:  # "auto": the matrix products up to 4096
        from ..fftprec import fft_poisson

        return fft_poisson(precision="high", method=DST_LANES[tag]), "once"
    raise ValueError(f"unknown lane {tag!r}; one of {LANES + tuple(DST_LANES)}")


def counting(factory: Callable, counter: Dict[str, int]) -> Callable:
    """``factory`` with its applies counted in ``counter["applies"]``."""
    def build(J):
        apply = factory(J)

        def counted(x):
            counter["applies"] += 1
            return apply(x)

        return counted

    return build


def apply_cost(M: Callable, ns: int, device) -> dict:
    """Host and device time of one apply of ``M`` built on the flagship's
    f32 Jacobian at u₀: the host ms to issue it and its wall (best of 3),
    and one apply under the profiler (device ms, device events)."""
    from ..operator import JacobianOperator
    from ..problems import bratu2d

    p = bratu2d.default_config(ns, lam=cs.LAM)
    u = bratu2d.initial_guess(ns, dtype=torch.float32, device=device)
    J = JacobianOperator(bratu2d.residual_scaled, u, p)
    t0 = time.perf_counter()
    apply = M(J)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    r = J.res
    apply(r)
    host, wall = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apply(r)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    b = cs.device_busy(lambda: apply(r))
    return {"build_ms": build_ms, "host_ms": 1e3 * min(host),
            "wall_ms": 1e3 * min(wall), "device_ms": 1e3 * b.busy_s,
            "events": b.events}


def run_lane(tag: str, ns: int, device="cuda", k_hi: int = 3,
             repeats: int = 2, timed: bool = True, profile: bool = True,
             log=print) -> dict:
    """Lane ``tag`` at ns², gated; returns its record (see the module).
    ``timed``: the marginal wall; ``profile``: on the card, the first solve
    runs under the profiler for its busy share (and for MG-PCG the cost of
    one apply is measured)."""
    from ..kernels import stencil2d as k
    from ..problems import bratu2d

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    M, refresh = lane_factory(tag)
    counter = {"applies": 0}
    f = cs.make_chain_solve(ns, counting(M, counter), refresh)
    u0 = bratu2d.initial_guess(ns, dtype=torch.float64, device=dev)
    base = 0
    if cuda:  # what earlier work left alive is collected, the rest counted
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    k4_before = k.LAUNCHES["chebyshev_apply"]
    busy = None
    t0 = time.perf_counter()
    if cuda and profile:
        busy = cs.device_busy(lambda: f(u0, 1))
        first = busy.out
    else:
        first = f(u0, 1)
    t_first = time.perf_counter() - t0
    k4 = k.LAUNCHES["chebyshev_apply"] - k4_before
    applies = counter["applies"]
    info = first.info
    fu, f0 = cs.true_residual(first.u, first.u_start)
    tol, tol_plain, floor = cs.clamped_tol(first.u_start)
    rec = {"lane": tag, "n": ns, "solved": bool(info.solved),
           "outer": int(info.stats.outer_iterations),
           "inner": int(info.stats.inner_iterations),
           "floor_limited": bool(info.floor_limited),
           "first_s": t_first, "true_res": fu, "res0": f0, "tol": tol,
           "tol_unclamped": tol_plain, "floor_clamp": floor,
           "applies": applies, "k4_launches": k4}
    log(f"[{tag}] {ns}²: first solve {t_first:.3f} s (first use at this "
        f"size included); f64 true |F| {fu:.4e} against the accepted "
        f"tolerance {tol:.4e} (1e-8·|F0| + 1e-12 = {tol_plain:.4e}, "
        f"2·floor_estimate(u0) = {floor:.4e}); {applies} preconditioner "
        f"applies, {k4} K4 launches")
    if cuda:
        rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        rec["base_mib"] = base / 2**20
        log(f"[{tag}] {ns}²: peak device memory {rec['peak_mib']:.1f} MiB "
            f"(torch.cuda.max_memory_allocated), {rec['base_mib']:.1f} MiB of "
            f"it allocated before the lane")
    if not rec["solved"]:
        raise AssertionError(f"xl8192 [{tag}] {ns}²: solve did not converge")
    if not (torch.isfinite(first.u).all() and tuple(first.u.shape) == (ns, ns)):
        raise AssertionError(f"xl8192 [{tag}] {ns}²: malformed state")
    if not fu <= tol:
        raise AssertionError(f"xl8192 [{tag}] {ns}²: f64 true residual "
                             f"{fu:.4e} above the accepted tolerance {tol:.4e}")
    if tag == "two-grid pallas" and cuda and k4 != 2 * applies:
        raise AssertionError(f"xl8192 [{tag}] {ns}²: {k4} K4 launches for "
                             f"{applies} applies, not two an apply")
    m = None
    if timed:
        m = cs.marginal(f, u0, k_hi=k_hi, repeats=repeats, warm=False)
        rec.update(marginal_s=m.s, t1_s=m.t1, t_hi_s=m.t_hi, k_hi=k_hi)
        again = m.chain.info
        if (int(again.stats.outer_iterations), int(again.stats.inner_iterations)
                ) != (rec["outer"], rec["inner"]) or not bool(again.solved):
            log(f"[{tag}] {ns}²: the timed solve took "
                f"{int(again.stats.outer_iterations)}/"
                f"{int(again.stats.inner_iterations)} from its perturbed start")
            if not bool(again.solved):
                raise AssertionError(f"xl8192 [{tag}] {ns}²: a timed solve "
                                     f"did not converge")
    if busy is not None:
        rec.update(busy_s=busy.busy_s, profiled_s=busy.wall_s,
                   events=busy.events, busy_share=busy.busy_s / busy.wall_s)
        log(f"[{tag}] {ns}²: the first solve under the profiler: wall "
            f"{busy.wall_s:.3f} s, device busy {busy.busy_s:.4f} s = "
            f"{100 * rec['busy_share']:.1f}%, {busy.events} device events")
        if tag == "MG-PCG":
            c = apply_cost(lane_factory(tag)[0], ns, dev)
            rec["apply"] = c
            log(f"[{tag}] {ns}²: one V-cycle apply: factory build "
                f"{c['build_ms']:.2f} ms, host {c['host_ms']:.2f} ms to issue, "
                f"wall {c['wall_ms']:.2f} ms, device {c['device_ms']:.2f} ms "
                f"in {c['events']} device events")
    log(cs.describe(tag, ns, m, first))
    return rec


def run(sizes: Sequence[int] = (8192,), lanes: Sequence[str] = LANES,
        device="cuda", k_hi: int = 3, repeats: int = 2, timed: bool = True,
        profile: bool = True, log=print) -> List[dict]:
    """Every lane at every size (see the module); the records in order.
    The card by default: without CUDA it raises unless ``device="cpu"``."""
    from ..examples import _common

    dev = _common.resolve_device(device)
    if dev.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(0)}")
    return [run_lane(tag, ns, dev, k_hi, repeats, timed, profile, log)
            for ns in sizes for tag in lanes]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[8192])
    ap.add_argument("--lanes", nargs="+", choices=LANES + tuple(DST_LANES),
                    default=list(LANES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--k-hi", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=2)
    a = ap.parse_args(argv)
    run(a.sizes, a.lanes, a.device, a.k_hi, a.repeats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
