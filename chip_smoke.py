#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``:

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero after any):

1. environment and build: the card's name and power limit, versions, TF32
   switched off, the CUDA sources of ``newtonkrylov_tpu_torch/csrc`` compiled
   in parallel (one ``nvcc`` each);
2. K1 and K2 against their plain PyTorch versions on the card, in f32 and
   f64 at n = 2048 and n = 64 (K1 exactly equal, K2 within 4 ulp), the
   2048² f32 case timed per call (CUDA events) and in device time alone
   (torch.profiler);
3. the chain kernels K3 (k = 0, 1, 2, 7, 33, 200), K5 (k = 2, 200) and K4
   (degree 0, 1, 4, 16, 40, on the interval of a probed Bratu Jacobian)
   against their plain versions, bit for bit, at the same sizes and dtypes
   on the same seeded inputs with random ghosts and apron (so the tiles'
   wrapped halos are exercised; k = 33, 200 and degree 40 take several
   passes), the 2048² f32 cases timed the same way;
4. the probe kernel K6 against its plain version, bit for bit: each of the
   JAX probe's 20 variants at n = 64 and 1024, f32, k = 1, 7 and 8, timed
   per call;
5. ``df32.selfcheck()`` on the card;
6. the main path of the first slice: the aligned-layout solve at 2048² (f64
   state, f32 Krylov, matvecs through K1, residuals through K2) and the
   flagship solve at 2048² (f32 Krylov, df32 acceptance residual,
   DST-Poisson preconditioner built once);
7. the chain lane: ``bench.py``'s matvec lane at 2048² f32 — per-matvec
   times of K3 and K5 by differencing chains of 200 and 2000 steps (each
   chain's output bitwise equal to its plain version), beside K1's per-call
   time on the same inputs;
8. the Cheb-PCG solve: the flagship configuration with
   ``chebyshev(16, lo_frac=1/300)`` in place of the DST preconditioner, at
   2048² (every preconditioner apply one K4 launch) and at 1024²;
9. the probe lane: ``python -m newtonkrylov_tpu_torch.benchmarks.kernel_probe``
   at N = 1024 (chains of 4000 and 400 steps; µs per step of every variant
   and the cost model), the last output of the hoisted stencil ping-pong
   held bit for bit against its plain version;
10. the GMRES paths: the flagship configuration with ``algo="gmres"`` (the
    driver's basis of 100) at 2048², and convection–diffusion (c = 2) at
    512² with DST-preconditioned full GMRES, f32 Krylov and the df32
    acceptance residual;
11. the multigrid and line-relaxation paths: convection–diffusion at
    c = 25 (``bench.py``'s convection lanes: GMRES(80), f32 Krylov + df32)
    with ``multigrid2d_general()`` at 512² and 256² and ``adi(4)`` at 256²
    (PCR line solves on the card), each solved with its f64 true residual
    and max|u − u*| ≤ 1e-6, MG-general in fewer inner iterations than ADI;
    MG-PCG (``multigrid2d()``, rebuilt every outer) and two-grid
    (``two_grid(8, precision="high")``, built once) on the flagship
    configuration at 2048²; two-grid again with ``engine="pallas"``, where
    every smoothing is one K4 launch (at least two per inner iteration);
12. the operator and solver surface: (a) the Cheb-PCG lane at 2048² on a
    Lanczos interval (``chebyshev(16, bounds="lanczos")``, one K4 launch per
    preconditioner apply: exactly inners + outers), with the interval beside
    the probed-Gershgorin one and the factory build's host and device time;
    (b) the flagship with pipelined CG (each inner solve capped at 50
    iterations); (c) the reference's 1-D Bratu
    gallery at N = 10⁴ in f64 (CG with three forcings and GMRES + banded
    direct solve to max|u − u*| ≤ 1e-5; plain GMRES, BiCGStab and CGLS must
    fail); (d) the spectral diagnostics at 32² f64 against numpy on the
    dense materialization (relative 1e-8); (e) the flagship from
    ``bench.py``'s u₀;
13. warm repeats (Cheb-PCG at 2048², and at 1024², its lane's own size,
    convection–diffusion at 512²), the aligned and the
    convection–diffusion solves (c = 2, and ADI(4) and MG-general at c = 25
    on PCR) at 64² against the same solves on the CPU, and breakdowns: each
    component's cost alone and the device busy time of the flagship,
    Cheb-PCG, convection–diffusion, MG-PCG and two-grid solves under
    torch.profiler, with K4's device time per launch inside the 2048²
    Cheb-PCG solve and, for MG-general at 512² and ADI(4) at 256², the host
    and device time and device events of one preconditioner apply
    (measurements only).

Launch counts are zeroed just before each of phases 6–12 and read just
after; each kernel must have been launched on its path (the two-grid
path's K4 count is logged on its own line; the JSON's K4 count is that of
the two Cheb-PCG paths at 2048²).  The last two lines are a JSON object of
per-kernel results and the JSON status object.  Without a CUDA device the
script fails and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N = 2048          # the flagship headline size
LAM = 5.0
SEED = 0
REPS = 50         # launches per timing window
CHAIN = (200, 2000)  # chain lengths the lane differences, as bench.py's
CHEB_REF_1024 = (8, 377)  # outer/inner of the JAX package's Cheb-PCG lane
#                           at 1024² (BENCH_r05.json), a count, not a time
PROBE_N = 1024    # the JAX probe's default size (benchmarks/kernel_probe.py)
PROBE_KS = 400    # its short chain: the K6 call the kernels JSON times
CONVDIFF_N = 512  # the largest convection lane of bench.py (bench.py:333)
CG_FLAGSHIP = (6, 7)  # the CG flagship's outer/inner counts at 2048²
CONV_C = 25.0     # the convection-dominated lanes of bench.py (bench.py:284)
# outer/inner counts of the JAX package's lanes (BENCH_r05.json; TPU counts,
# not times or targets): the convection lanes by (preconditioner, n), and
# two-grid at 2048²
CONV_REF = {("adi", 256): (10, 441), ("mg-general", 256): (8, 27),
            ("mg-general", 512): (7, 29)}
TWO_GRID_REF = (8, 28)
FLAGSHIP_TPU_REF = (6, 11)  # the DST-PCG flagship at 2048² (BENCH_r05.json)
GALLERY_N = 10_000  # the reference's 1-D Bratu size (examples/bratu_1d.py)
PIPELINED_ITMAX = 50  # inner cap of path (b); plain CG takes ≤ 2 an outer

# For the least time the card could take for a kernel's work (bytes over
# the memory rate, operations over the float32 rate): NVIDIA's H100 SXM data
# sheet, HBM3 bandwidth and float32 rate outside the tensor cores, at the
# 700 W power limit.  The sheet's 67 TFLOP/s counts a fused multiply-add as
# two operations; the kernels build with -fmad=false, so every add and
# multiply issues as an instruction of its own, at half that rate.
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12 / 2


def log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, reps=REPS):
    """Milliseconds per call on the device timeline: CUDA events around
    back-to-back calls after a warm-up, so host dispatch gaps count."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile(fn, counts=None):
    """(device µs by kernel name, total device µs) of one call of ``fn``,
    from torch.profiler's CUDA activity: the durations of the events that
    ran on the device (kernels, copies, fills), summed by name; empty when
    the profiler records no device time.  ``counts``, a dict, receives the
    number of events by name.  The profiler's raw events are read directly:
    turning them into ``FunctionEvent``s (``events()``, ``key_averages()``)
    costs ~100 µs an event, minutes for a solve of a million launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        by_name[name] = by_name.get(name, 0.0) + (e.end_ns() - e.start_ns()) / 1e3
        if counts is not None:
            counts[name] = counts.get(name, 0) + 1
    return by_name, sum(by_name.values())


def _device_ms(fn, reps=REPS):
    """Device milliseconds per call (kernel time only, host gaps excluded),
    or None when the profiler sees no device time."""
    fn()

    def loop():
        for _ in range(reps):
            fn()

    _, total_us = _profile(loop)
    return total_us / 1e3 / reps if total_us > 0 else None


def _wall_s(torch, fn, reps=3):
    """Host seconds per call of ``fn`` after a warm-up, the device drained
    before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def _fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def _reps(steps):
    """Timing window for a call of ``steps`` chained steps: ~1000 steps."""
    return max(3, min(REPS, 1000 // max(steps, 1)))


def _bound(key, R, C, n, itemsize, steps=0):
    """(ms, "bytes" or "operations"): the least time for one call of kernel
    ``key`` on an (R, C) aligned array of interior n², ``steps`` chained
    steps.  Bytes: each input read once, the output written once.
    Operations: what the interior needs (K5: every element) — K1 7 per
    element, K2 8 (eᵘ as one), K3 5 per step + a scale on half the steps +
    w − 4 once, K5 the same on all R·C, K4 11 per degree step + 1, K6 (the
    hoisted stencil step of the probe, over all R·C) 4 adds and 2
    multiplies per step + w − 4 and the scaled mask once."""
    arrays, ops = {
        "stencil_jvp": (3, 7 * n * n),
        "bratu_residual": (2, 8 * n * n),
        "stencil_jvp_chain": (3, n * n * (1 + 5 * steps + (steps + 1) // 2)),
        "stencil_chain_probe": (3, R * C * (1 + 5 * steps + steps // 2)),
        "chebyshev_apply": (3, n * n * (1 + 11 * steps)),
        "chain_call": (3, R * C * (2 + 6 * steps)),
    }[key]
    t_bytes = arrays * R * C * itemsize / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bitwise_equal(torch, a, b):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return torch.equal(a.view(ints), b.view(ints))


def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    log(f"[env] tf32 before: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; setting both False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from concurrent.futures import ThreadPoolExecutor

    from newtonkrylov_tpu_torch.kernels import build

    sources = ("stencil2d", "chain2d", "chain_probe")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        list(pool.map(build.load, sources))
    log(f"[build] {len(sources)} sources in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        rec = build.BUILD_LOG[name]
        log(f"[build] {name}.cu -> {os.path.basename(rec['path'])} in "
            f"{rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if line.strip():
                log(f"[build] {line.strip()}")


def _inputs(torch, k, dev):
    """((n, dtype), (v, w, u)) for n = 2048, 64 and f32, f64: seeded random
    aligned arrays, w = |·| + 0.1, drawn in one order for every phase."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for n in (N, 64):
        for dt in (torch.float32, torch.float64):
            def rand(shift=0.0, absval=False):
                x = torch.randn((n, n), generator=gen, device=dev, dtype=dt)
                return k.aligned_wrap(x.abs() + shift if absval else x)

            yield (n, dt), (rand(), rand(0.1, absval=True), rand())


def phase_kernels(torch):
    """K1/K2 against their plain versions; returns the n=2048 f32 results."""
    from newtonkrylov_tpu_torch.kernels import stencil2d as k

    dev = torch.device("cuda", 0)
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    summary = {}
    for (n, dt), (v, w, u) in _inputs(torch, k, dev):
        scale = LAM / (n + 1) ** 2
        interior = k.aligned_mask(n, torch.bool, dev)
        tag = f"n={n} {str(dt).replace('torch.', '')}"

        got = k.stencil_jvp(v, w, n)
        ref = k.stencil_jvp_xla(v, w, n)
        torch.cuda.synchronize()
        bits_differ = (got.view(ints[dt]) != ref.view(ints[dt])) & interior
        if bool(bits_differ.any()):
            raise AssertionError(f"K1 {tag}: {int(bits_differ.sum())} "
                                 "interior entries differ from plain")
        if bool((got[~interior] != 0).any()):
            raise AssertionError(f"K1 {tag}: nonzero ghost/apron entry")
        err1 = float((got - ref).abs().max())

        got2 = k.bratu_residual(u, n, scale)
        ref2 = k.bratu_residual_xla(u, n, scale)
        torch.cuda.synchronize()
        eps = torch.finfo(dt).eps
        bound = 4 * eps * (ref2.abs() + scale * torch.exp(u))
        diff2 = (got2 - ref2).abs()
        if bool((diff2 > bound)[interior].any()):
            raise AssertionError(f"K2 {tag}: exceeds 4 ulp of plain")
        if bool((got2[~interior] != 0).any()):
            raise AssertionError(f"K2 {tag}: nonzero ghost/apron entry")
        err2 = float(diff2.max())
        ulp2 = float((diff2 / (eps * (ref2.abs() + scale * torch.exp(u))))
                     [interior].max())

        log(f"[kernels] {tag}: K1 stencil_jvp bitwise-equal interior, "
            f"ghosts 0, max|err| {err1:.3e}")
        log(f"[kernels] {tag}: K2 bratu_residual max|err| {err2:.3e} "
            f"({ulp2:.2f} ulp of |F|+|scale e^u|, limit 4), ghosts 0")
        if n == N and dt == torch.float32:  # the timed case
            calls = {
                "K1": (lambda: k.stencil_jvp(v, w, n),
                       lambda: k.stencil_jvp_xla(v, w, n)),
                "K2": (lambda: k.bratu_residual(u, n, scale),
                       lambda: k.bratu_residual_xla(u, n, scale)),
            }
            times = {}
            for name, (kern, plain) in calls.items():
                # per call on the device timeline (host dispatch included),
                # then device time alone (profiler)
                times[name] = t, p, td, pd = (_time_ms(kern), _time_ms(plain),
                                              _device_ms(kern), _device_ms(plain))
                log(f"[kernels] {tag}: {name} per call {t:.4f} ms vs plain "
                    f"{p:.4f} ms (CUDA events, back-to-back calls); device "
                    f"time kernel {_fmt_ms(td)} vs plain {_fmt_ms(pd)}")
            for name, key, err in (("K1", "stencil_jvp", err1),
                                   ("K2", "bratu_residual", err2)):
                t, p, td, pd = times[name]
                # device time where the profiler gives it, else events
                summary[key] = (err, td if td is not None else t,
                                pd if pd is not None else p)
    return summary


def phase_chain_kernels(torch, nkt, bratu2d):
    """K3, K4 and K5 against their plain versions, bit for bit, on the
    inputs of ``phase_kernels``; K4's interval and diagonal come from the
    probed Jacobian of the Bratu residual at u₀.  Returns, per kernel, the
    largest |kernel − plain| over all cases and the 2048² f32 timings of
    K3 and K5 at k = 200 and K4 at degree 16."""
    from newtonkrylov_tpu_torch.kernels import stencil2d as k
    from newtonkrylov_tpu_torch.mg import probe_5point
    from newtonkrylov_tpu_torch.precond import _cheb_bounds

    dev = torch.device("cuda", 0)
    errs = dict.fromkeys(("stencil_jvp_chain", "stencil_chain_probe",
                          "chebyshev_apply"), 0.0)
    timed = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for (n, dt), (v, w, _) in _inputs(torch, k, dev):
        tag = f"n={n} {str(dt).replace('torch.', '')}"
        ghosts = ~k.aligned_mask(n, torch.bool, dev)
        v = torch.where(ghosts, torch.randn(v.shape, generator=gen, device=dev,
                                            dtype=dt), v)
        J = nkt.JacobianOperator(bratu2d.residual_scaled,
                                 bratu2d.initial_guess(n, dt, dev),
                                 bratu2d.default_config(n, LAM))
        o, d = probe_5point(J)
        theta, delta = _cheb_bounds(o, d.min(), d.max(), None, 1 / 300, dt)
        diag, scal = k.aligned_wrap(d / o), torch.stack([theta, delta, o])
        cases = [("stencil_jvp_chain", "K3", s,
                  lambda s=s: k.stencil_jvp_chain(v, w, n, s, 0.125),
                  lambda s=s: k.stencil_jvp_chain_xla(v, w, n, s, 0.125))
                 for s in (0, 1, 2, 7, 33, CHAIN[0])]
        cases += [("stencil_chain_probe", "K5", s,
                   lambda s=s: k.stencil_chain_probe(v, w, n, s),
                   lambda s=s: k.stencil_chain_probe_xla(v, w, n, s))
                  for s in (2, CHAIN[0])]
        cases += [("chebyshev_apply", "K4", s,
                   lambda s=s: k.chebyshev_apply(v, diag, scal, n, s),
                   lambda s=s: k.chebyshev_apply_xla(v, diag, scal, n, s))
                  for s in (0, 1, 4, 16, 40)]
        for key, short, steps, kern, plain in cases:
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not _bitwise_equal(torch, got, ref):
                raise AssertionError(f"{short} {tag} steps={steps}: differs "
                                     f"from plain, max|err| {err:.3e}")
            errs[key] = max(errs[key], err)
            plan = k._tile_plan(key, n, dt, steps)
            log(f"[chain kernels] {tag}: {short} {key} steps={steps} "
                f"bitwise equal, max|ref| {float(ref.abs().max()):.3e}; "
                f"{plan.passes(steps)} pass(es), tile {plan.tile_h}x"
                f"{plan.tile_w}, S {plan.steps_per_pass}, smem "
                f"{plan.smem_bytes} B, {plan.threads()} threads")
            if n == N and dt == torch.float32:  # the timed cases
                reps = _reps(steps)
                t, p = _time_ms(kern, reps), _time_ms(plain, reps)
                td, pd = _device_ms(kern, reps), _device_ms(plain, reps)
                log(f"[chain kernels] {tag}: {short} steps={steps} per call "
                    f"{t:.4f} ms vs plain {p:.4f} ms (CUDA events); device "
                    f"time kernel {_fmt_ms(td)} vs plain {_fmt_ms(pd)}")
                if steps in (CHAIN[0], 16):
                    timed[key] = (td if td is not None else t,
                                  pd if pd is not None else p)
    return {key: (errs[key], *timed[key]) for key in errs}


def phase_probe_kernels(torch):
    """K6 against its plain version, bit for bit: every variant the JAX probe
    times (``kernel_probe.VARIANTS``: carry and ping-pong, unroll 1, 2, 4) at
    n = 64 and 1024, f32, k = 1, 7 and 8 (k = 7 checks the ping-pong
    floor), on seeded random arrays whose ghosts and apron are nonzero, so
    every wrap-around and the mask are exercised; each case timed per call
    (CUDA events).  Returns (largest |kernel − plain|, ms, plain ms) with
    the times those of the hoisted stencil ping-pong at 1024², k = 400."""
    from newtonkrylov_tpu_torch.benchmarks import kernel_probe as tprobe
    from newtonkrylov_tpu_torch.kernels import probe as kp
    from newtonkrylov_tpu_torch.kernels import stencil2d as k

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err, cases = 0.0, 0
    for n in (64, PROBE_N):
        shape = (n + 8, k.round_up(n + 2, 128))
        v = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32).abs() + 0.1
        for name, step, kw in tprobe.VARIANTS:
            for steps in (1, 7, 8):
                got = kp.chain_call(step, v, w, steps, **kw)
                ref = kp.chain_call_xla(step, v, w, steps, **kw)
                torch.cuda.synchronize()
                e = float((got - ref).abs().max())
                if not (bool(torch.isfinite(ref).all())
                        and _bitwise_equal(torch, got, ref)):
                    raise AssertionError(f"K6 n={n} {name} k={steps}: differs "
                                         f"from plain, max|err| {e:.3e}")
                err, cases = max(err, e), cases + 1
                t = _time_ms(lambda: kp.chain_call(step, v, w, steps, **kw), 10)
                p = _time_ms(lambda: kp.chain_call_xla(step, v, w, steps, **kw), 10)
                log(f"[probe kernels] n={n} {name} k={steps} "
                    f"({kp.steps_run(steps, **kw)} steps run): bitwise equal; "
                    f"per call {t:.4f} ms vs plain {p:.4f} ms (CUDA events)")
    log(f"[probe kernels] {cases} cases bitwise equal to the plain version")
    v, w = tprobe.inputs(PROBE_N, dev)

    def kern():
        return kp.chain_call(kp.OPT_BUILD, v, w, PROBE_KS, pingpong=True)

    def plain():
        return kp.chain_call_xla(kp.OPT_BUILD, v, w, PROBE_KS, pingpong=True)

    if not _bitwise_equal(torch, kern(), plain()):
        raise AssertionError("K6 hoisted stencil ping-pong k=400 differs from plain")
    t, p = _time_ms(kern, 5), _time_ms(plain, 3)
    td, pd = _device_ms(kern, 5), _device_ms(plain, 3)
    log(f"[probe kernels] n={PROBE_N} stencil hoisted pingpong k={PROBE_KS}: "
        f"bitwise equal; per call {t:.4f} ms vs plain {p:.4f} ms (CUDA "
        f"events); device time kernel {_fmt_ms(td)} vs plain {_fmt_ms(pd)}")
    return (err, td if td is not None else t, pd if pd is not None else p)


def phase_probe_lane(torch):
    """The port's probe (``benchmarks/kernel_probe.py``) at N = 1024: µs per
    step of every variant by chain differencing (4000 vs 400 steps) and the
    cost model.  The last output of the hoisted stencil ping-pong is held
    bit for bit against its plain version on the same input."""
    from newtonkrylov_tpu_torch.benchmarks import kernel_probe as tprobe
    from newtonkrylov_tpu_torch.kernels import probe as kp

    timings = tprobe.run(PROBE_N)
    model = tprobe.cost_model(timings)
    kl, _ = tprobe.chain_lengths(PROBE_N)
    _, w = tprobe.inputs(PROBE_N, torch.device("cuda", 0))
    t = timings["stencil hoisted pingpong"]
    ref = kp.chain_call_xla(kp.OPT_BUILD, t.v, w, kl, pingpong=True)
    if not (bool(torch.isfinite(t.out).all())
            and _bitwise_equal(torch, t.out, ref)):
        raise AssertionError(f"probe lane: hoisted stencil ping-pong k={kl} "
                             "not finite or not bitwise equal to plain")
    log(f"[probe lane] stencil hoisted pingpong k={kl}: bitwise equal to "
        f"plain, max|ref| {float(ref.abs().max()):.3e}")
    return model


def phase_selfcheck(torch):
    from newtonkrylov_tpu_torch import df32

    ok = df32.selfcheck(device="cuda")
    log(f"[df32] selfcheck on cuda: {ok}")
    if not ok:
        raise AssertionError("df32.selfcheck() failed on the card")


def _true_residual(torch, bratu2d, u_interior, u0_interior, p):
    """(‖F(u)‖, ‖F(u₀)‖) of the plain residual, recomputed in f64."""
    f = lambda x: float(torch.linalg.vector_norm(  # noqa: E731
        bratu2d.residual_scaled(x.to(torch.float64), p)))
    return f(u_interior), f(u0_interior)


def _aligned_solve(torch, nkt, bratu2d, n, device, krylov_dtype):
    from newtonkrylov_tpu_torch.kernels import stencil2d as k

    u0a, p, space = bratu2d.aligned_setup(n, lam=LAM, dtype=torch.float64,
                                          device=device)
    t0 = time.perf_counter()
    u, info = nkt.newton_krylov_jit(
        bratu2d.residual_scaled_aligned, u0a, p, algo="cg", space=space,
        krylov_dtype=krylov_dtype, tol_rel=1e-8, max_niter=20)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return u, info, wall, k.aligned_interior(u, n), k.aligned_interior(u0a, n), p


def phase_aligned(torch, nkt, bratu2d, pass_name):
    from newtonkrylov_tpu_torch.kernels import stencil2d as k

    u, info, wall, ui, u0i, p = _aligned_solve(
        torch, nkt, bratu2d, N, "cuda", torch.float32)
    fu, f0 = _true_residual(torch, bratu2d, ui, u0i, p)
    log(f"[aligned {pass_name}] n={N} f64 state, f32 Krylov, MaskedSpace: "
        f"solved={bool(info.solved)} outer={info.stats.outer_iterations} "
        f"inner={info.stats.inner_iterations} wall={wall:.3f} s  "
        f"true |F|={fu:.4e} (limit {1e-8 * f0 + 1e-12:.4e})")
    if not bool(info.solved):
        raise AssertionError("aligned solve did not converge")
    if not (torch.isfinite(u).all()
            and tuple(u.shape) == (N + 8, k.round_up(N + 2, 128))):
        raise AssertionError("aligned solve returned a malformed state")
    if not fu <= 1e-8 * f0 + 1e-12:
        raise AssertionError("aligned solve: f64 true residual above 1e-8·‖F₀‖")
    return info


def phase_aligned_small(torch, nkt, bratu2d):
    """The aligned f64 solve at 64² on the card (kernels) and on the CPU
    (plain versions): both solved, same solution."""
    n = 64
    _, info_g, _, ui_g, _, _ = _aligned_solve(torch, nkt, bratu2d, n, "cuda", None)
    _, info_c, _, ui_c, _, _ = _aligned_solve(torch, nkt, bratu2d, n, "cpu", None)
    err = float((ui_g.cpu() - ui_c).abs().max())
    log(f"[aligned 64] cuda outer/inner {info_g.stats.outer_iterations}/"
        f"{info_g.stats.inner_iterations}  cpu {info_c.stats.outer_iterations}/"
        f"{info_c.stats.inner_iterations}  max|u_cuda - u_cpu| {err:.3e}")
    if not (bool(info_g.solved) and bool(info_c.solved) and err <= 1e-9):
        raise AssertionError("aligned 64² solve on the card disagrees with the CPU")


def _df32_solve(torch, nkt, bratu2d, n, M, tag, algo="cg", refresh="once",
                u0=None, krylov_kwargs=None):
    """The flagship configuration at n² with preconditioner factory ``M``:
    f32 Krylov, df32 acceptance residual, ``M`` built once at u₀ (or every
    outer, ``refresh="outer"``), from ``entry()``'s f32 guess unless an f64
    ``u0`` is given.  Gated on ``solved`` and the f64 true residual;
    returns the NewtonInfo."""
    p = bratu2d.default_config(n, lam=LAM)
    if u0 is None:
        # entry()'s f32 u₀, handed over as its exact f64 value: the df32
        # state starts as (u₀, 0) either way, and the f64 boundary returns
        # hi + lo, the full state, for the f64 residual check below
        u0 = bratu2d.initial_guess(n, dtype=torch.float32, device="cuda").to(
            torch.float64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, info = nkt.newton_krylov_jit(
        bratu2d.residual_scaled, u0, p,
        algo=algo, tol_rel=1e-8, krylov_dtype=torch.float32,
        residual_df=bratu2d.residual_scaled_df,
        max_niter=20, M=M, precond_refresh=refresh, krylov_kwargs=krylov_kwargs,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fu, f0 = _true_residual(torch, bratu2d, u, u0, p)
    log(f"[{tag}] n={n} f32 Krylov + df32: "
        f"solved={bool(info.solved)} outer={info.stats.outer_iterations} "
        f"inner={info.stats.inner_iterations} "
        f"floor_limited={bool(info.floor_limited)} wall={wall:.3f} s  "
        f"true |F|={fu:.4e} (limit {1e-8 * f0 + 1e-12:.4e})")
    if not bool(info.solved):
        raise AssertionError(f"{tag}: solve did not converge")
    if not (torch.isfinite(u).all() and tuple(u.shape) == (n, n)):
        raise AssertionError(f"{tag}: solve returned a malformed state")
    if not fu <= 1e-8 * f0 + 1e-12:
        raise AssertionError(f"{tag}: f64 true residual above 1e-8·‖F₀‖")
    return info


def phase_flagship(torch, nkt, bratu2d, pass_name):
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    return _df32_solve(torch, nkt, bratu2d, N, fft_poisson(precision="high"),
                       f"flagship {pass_name}, DST(high)")


def phase_gmres_flagship(torch, nkt, bratu2d, pass_name):
    """The flagship configuration with ``algo="gmres"`` and no ``restart``:
    the driver's parity basis of min(n², 100) applies."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    info = _df32_solve(torch, nkt, bratu2d, N, fft_poisson(precision="high"),
                       f"gmres flagship {pass_name}, DST(high)", algo="gmres")
    log(f"[gmres flagship {pass_name}] n={N} outer/inner "
        f"{info.stats.outer_iterations}/{info.stats.inner_iterations} beside "
        f"CG's {CG_FLAGSHIP[0]}/{CG_FLAGSHIP[1]} on the same configuration")
    return info


def _convdiff_solve(torch, nkt, n, device, M, c, refined, krylov, max_niter=15):
    """Convection–diffusion at ``c`` from the zero start: GMRES with the
    preconditioner factory ``M`` rebuilt every outer, exact Newton, the
    GMRES options ``krylov``, at most ``max_niter`` outers.  ``refined``:
    f32 Krylov + df32 acceptance residual to 1e-8 (the production path);
    else f64 throughout to 1e-10.  Returns (u, info, wall seconds, ‖F(u)‖
    and ‖F(u₀)‖ in f64, max|u − u*|)."""
    from newtonkrylov_tpu_torch.problems import convdiff2d

    f64 = torch.float64
    p = convdiff2d.default_config(n, c=c, dtype=f64, device=device)
    u0 = convdiff2d.initial_guess(n, f64, device)
    kw = dict(algo="gmres", M=M, forcing=None, krylov_kwargs=krylov,
              max_niter=max_niter)
    if refined:
        kw.update(krylov_dtype=torch.float32,
                  residual_df=convdiff2d.residual_scaled_df, tol_rel=1e-8)
    else:
        kw.update(tol_rel=1e-10)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, info = nkt.newton_krylov_jit(convdiff2d.residual_scaled, u0, p, **kw)
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    norm = lambda x: float(torch.linalg.vector_norm(  # noqa: E731
        convdiff2d.residual_scaled(x.to(f64), p)))
    us = convdiff2d.manufactured_solution(n, f64, device)
    return u, info, wall, norm(u), norm(u0), float((u - us).abs().max())


def _gate_convdiff(torch, tag, n, u, info, fu, f0, err):
    """``solved``, a finite (n, n) state, the f64 true residual
    ≤ 1e-8·‖F₀‖ + 1e-12 and max|u − u*| ≤ 1e-6."""
    if not bool(info.solved):
        raise AssertionError(f"{tag}: solve did not converge")
    if not (torch.isfinite(u).all() and tuple(u.shape) == (n, n)):
        raise AssertionError(f"{tag}: solve returned a malformed state")
    if not (fu <= 1e-8 * f0 + 1e-12 and err <= 1e-6):
        raise AssertionError(f"{tag}: true residual or error above limit")


def phase_convdiff(torch, nkt, pass_name):
    """Convection–diffusion (c = 2) at 512² on the refined path with the
    JAX package's recipe: DST rebuilt every outer, full GMRES (itmax 600).
    Gated by ``_gate_convdiff``."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    n = CONVDIFF_N
    u, info, wall, fu, f0, err = _convdiff_solve(
        torch, nkt, n, "cuda", fft_poisson(), 2.0, True,
        {"restart": None, "itmax": 600}, max_niter=25)
    log(f"[convdiff {pass_name}] n={n} c=2 GMRES(full, itmax 600) + DST, f32 "
        f"Krylov + df32: solved={bool(info.solved)} "
        f"outer={info.stats.outer_iterations} "
        f"inner={info.stats.inner_iterations} "
        f"floor_limited={bool(info.floor_limited)} wall={wall:.3f} s  true "
        f"|F|={fu:.4e} (limit {1e-8 * f0 + 1e-12:.4e})  max|u - u*| "
        f"{err:.3e} (limit 1e-6)")
    _gate_convdiff(torch, "convdiff", n, u, info, fu, f0, err)
    return info, wall


def phase_convdiff_small(torch, nkt):
    """The f64 convection–diffusion GMRES solve (c = 2, DST, full GMRES) at
    64² on the card and on the CPU: both solved, the same counts, solutions
    within 1e-10."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    runs = {dev: _convdiff_solve(torch, nkt, 64, dev, fft_poisson(), 2.0, False,
                                 {"restart": None, "itmax": 150})
            for dev in ("cuda", "cpu")}
    (ug, ig, *_, eg), (uc, ic, *_, ec) = runs["cuda"], runs["cpu"]
    diff = float((ug.cpu() - uc).abs().max())
    log(f"[convdiff 64] cuda outer/inner {ig.stats.outer_iterations}/"
        f"{ig.stats.inner_iterations}  cpu {ic.stats.outer_iterations}/"
        f"{ic.stats.inner_iterations}  max|u_cuda - u_cpu| {diff:.3e}  "
        f"max|u - u*| {eg:.3e}")
    same = (ig.stats.outer_iterations == ic.stats.outer_iterations
            and ig.stats.inner_iterations == ic.stats.inner_iterations)
    if not (bool(ig.solved) and bool(ic.solved) and same and diff <= 1e-10):
        raise AssertionError("convdiff 64² solve on the card disagrees with the CPU")


def _conv_factory(tag, engine="auto"):
    """The convection lanes' preconditioner factories, by tag."""
    from newtonkrylov_tpu_torch.mg import multigrid2d_general
    from newtonkrylov_tpu_torch.precond import adi

    if tag == "adi":
        return adi(4, engine=engine)
    return multigrid2d_general(engine=engine)


def phase_conv25(torch, nkt, tag, n, pass_name):
    """A convection lane of bench.py (``bench.py:284-347``): c = 25 from
    u₀ = 0, GMRES(80) with ``itmax=600``, ``adi(4)`` or
    ``multigrid2d_general()`` rebuilt every outer (PCR line solves on the
    card), f32 Krylov + df32 to 1e-8, ``max_niter=15``.  Gated by
    ``_gate_convdiff``; returns (info, wall)."""
    u, info, wall, fu, f0, err = _convdiff_solve(
        torch, nkt, n, "cuda", _conv_factory(tag), CONV_C, True,
        {"restart": 80, "itmax": 600})
    ref = CONV_REF[tag, n]
    log(f"[convdiff c=25 {tag} {pass_name}] n={n} GMRES(80) + {tag}, f32 "
        f"Krylov + df32: solved={bool(info.solved)} "
        f"outer={info.stats.outer_iterations} "
        f"inner={info.stats.inner_iterations} (the JAX package's recorded "
        f"{ref[0]}/{ref[1]}, BENCH_r05.json, a TPU count) "
        f"floor_limited={bool(info.floor_limited)} wall={wall:.3f} s  true "
        f"|F|={fu:.4e} (limit {1e-8 * f0 + 1e-12:.4e})  max|u - u*| "
        f"{err:.3e} (limit 1e-6)")
    _gate_convdiff(torch, f"convdiff c=25 {tag} {n}", n, u, info, fu, f0, err)
    return info, wall


def phase_conv25_small(torch, nkt):
    """ADI(4) and MG-general at c = 25, 64², f64, full GMRES to 1e-10 with
    the line solver set to PCR on both devices, on the card and on the CPU:
    both solved, the same counts, solutions within 1e-10."""
    for tag in ("adi", "mg-general"):
        runs = {dev: _convdiff_solve(torch, nkt, 64, dev, _conv_factory(tag, "pcr"),
                                     CONV_C, False, {"restart": None, "itmax": 300})
                for dev in ("cuda", "cpu")}
        (ug, ig, *_, eg), (uc, ic, *_, ec) = runs["cuda"], runs["cpu"]
        diff = float((ug.cpu() - uc).abs().max())
        log(f"[convdiff c=25 {tag} 64, pcr] cuda outer/inner "
            f"{ig.stats.outer_iterations}/{ig.stats.inner_iterations}  cpu "
            f"{ic.stats.outer_iterations}/{ic.stats.inner_iterations}  "
            f"max|u_cuda - u_cpu| {diff:.3e}  max|u - u*| {eg:.3e}")
        same = (ig.stats.outer_iterations == ic.stats.outer_iterations
                and ig.stats.inner_iterations == ic.stats.inner_iterations)
        if not (bool(ig.solved) and bool(ic.solved) and same and diff <= 1e-10):
            raise AssertionError(f"convdiff c=25 {tag} 64² on the card disagrees "
                                 "with the CPU")


def phase_cheb(torch, nkt, bratu2d, n, pass_name):
    """The Cheb-PCG lane of bench.py: the flagship with
    ``chebyshev(16, lo_frac=1/300)``; on a CUDA state each preconditioner
    apply is one K4 launch."""
    from newtonkrylov_tpu_torch.precond import chebyshev

    info = _df32_solve(torch, nkt, bratu2d, n, chebyshev(16, lo_frac=1 / 300),
                       f"cheb-pcg {pass_name}, Cheb(16)")
    if n == 1024:
        log(f"[cheb-pcg {pass_name}] n=1024 outer/inner "
            f"{info.stats.outer_iterations}/{info.stats.inner_iterations} "
            f"beside the JAX package's recorded {CHEB_REF_1024[0]}/"
            f"{CHEB_REF_1024[1]} (BENCH_r05.json; a count, not a time)")
    return info


def phase_mg_pcg(torch, nkt, bratu2d, pass_name):
    """The MG-PCG lane of bench.py (``bench.py:234``): the flagship with
    ``multigrid2d()`` rebuilt every outer."""
    from newtonkrylov_tpu_torch.mg import multigrid2d

    return _df32_solve(torch, nkt, bratu2d, N, multigrid2d(),
                       f"mg-pcg {pass_name}", refresh="outer")


def phase_two_grid(torch, nkt, bratu2d, engine, pass_name):
    """The two-grid lane of bench.py (``bench.py:240``): the flagship with
    ``two_grid(8, precision="high")`` built once; ``engine="pallas"`` runs
    each smoothing as one K4 launch."""
    from newtonkrylov_tpu_torch.precond import two_grid

    info = _df32_solve(torch, nkt, bratu2d, N,
                       two_grid(8, precision="high", engine=engine),
                       f"two-grid {engine} {pass_name}")
    log(f"[two-grid {engine} {pass_name}] n={N} outer/inner "
        f"{info.stats.outer_iterations}/{info.stats.inner_iterations} beside "
        f"the JAX package's recorded {TWO_GRID_REF[0]}/{TWO_GRID_REF[1]} "
        f"(BENCH_r05.json, engine \"xla\"; a TPU count)")
    return info


def phase_cheb_lanczos(torch, nkt, bratu2d):
    """Path (a): the Cheb-PCG lane with ``chebyshev(16, bounds="lanczos")``
    (the interval from a 48-step Lanczos run on the u₀ operator, built
    once); each preconditioner apply is one K4 launch."""
    from newtonkrylov_tpu_torch.precond import chebyshev

    return _df32_solve(torch, nkt, bratu2d, N, chebyshev(16, bounds="lanczos"),
                       "cheb-pcg lanczos, Cheb(16)")


def phase_lanczos_interval(torch, nkt, bratu2d):
    """The Lanczos interval of the 2048² u₀ operator (f32) beside the probed
    Gershgorin one and the ``lo_frac=1/300`` interval the Cheb-PCG lane
    uses; gated on lying on one side of zero.  Then the host wall and the
    device time of the whole factory build (the probe and 48 Lanczos steps,
    no K4 launch)."""
    from newtonkrylov_tpu_torch.mg import probe_5point
    from newtonkrylov_tpu_torch.precond import (
        _cheb_bounds, _resolve_cheb_bounds, chebyshev)

    f32 = torch.float32
    p = bratu2d.default_config(N, lam=LAM)
    J = nkt.JacobianOperator(bratu2d.residual_scaled,
                             bratu2d.initial_guess(N, f32, "cuda"), p)
    lo, hi = (float(x) for x in _resolve_cheb_bounds(J, "lanczos", 48))
    o, d = probe_5point(J)
    g_lo, g_hi = float(d.min() - 4 * o.abs()), float(d.max() + 4 * o.abs())
    theta, delta = _cheb_bounds(o, d.min(), d.max(), None, 1 / 300, f32)
    c_lo, c_hi = float(theta - delta), float(theta + delta)
    log(f"[cheb-pcg lanczos] n={N} f32 u0 operator: Lanczos interval "
        f"[{lo:.6e}, {hi:.6e}] (k=48, far end widened 5%); probed Gershgorin "
        f"[{g_lo:.6e}, {g_hi:.6e}]; lo_frac=1/300 interval [{c_lo:.6e}, "
        f"{c_hi:.6e}]")
    if not (lo < hi < 0 or 0 < lo < hi):
        raise AssertionError("the Lanczos interval does not lie on one side of zero")
    factory = chebyshev(16, bounds="lanczos")
    build = _wall_s(torch, lambda: factory(J), reps=2)
    events = {}
    _, dev_us = _profile(lambda: factory(J), events)
    log(f"[cheb-pcg lanczos] factory build (probe + 48 Lanczos steps, a "
        f"48-row f32 basis of {48 * N * N * 4 / 1e9:.2f} GB): host wall "
        f"{build * 1e3:.2f} ms, device {dev_us / 1e3:.2f} ms over "
        f"{sum(events.values())} device events")


def phase_pipelined(torch, nkt, bratu2d, plain):
    """Path (b): the flagship with ``krylov_kwargs={"pipeline": True}``,
    logged beside ``plain``, the main path's plain-CG flagship.  Each inner
    solve is capped at ``PIPELINED_ITMAX`` iterations: at 2048² one f32
    pipelined inner solve stagnates above its tolerance (ROADMAP.md Queue 3
    item 17) and would otherwise run to the default itmax of 2n ≈ 8.4·10⁶."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    info = _df32_solve(torch, nkt, bratu2d, N, fft_poisson(precision="high"),
                       "flagship pipelined CG, DST(high)",
                       krylov_kwargs={"pipeline": True, "itmax": PIPELINED_ITMAX})
    log(f"[flagship pipelined CG] n={N} outer/inner "
        f"{info.stats.outer_iterations}/{info.stats.inner_iterations} beside "
        f"plain CG's {plain.stats.outer_iterations}/"
        f"{plain.stats.inner_iterations} (this run's main path)")
    return info


def phase_gallery(torch, nkt):
    """Path (c): the reference's 1-D Bratu gallery (``examples/bratu_1d.py``)
    at N = 10⁴, λ = 3.51382, in f64 through ``newton_krylov_jit``.  The
    positive recipes must solve with max|u − u*| ≤ 1e-5 against the closed
    form; the negative ones (``max_niter=4``, ``itmax=60``) must end
    unsolved with a finite iterate."""
    from newtonkrylov_tpu_torch.precond import banded_direct
    from newtonkrylov_tpu_torch.problems import bratu1d

    n, f64 = GALLERY_N, torch.float64
    p = bratu1d.default_config(n)
    u0 = bratu1d.initial_guess(n, f64, "cuda")
    u_star = bratu1d.true_solution(bratu1d.grid(n, f64, "cuda"))
    negative = dict(max_niter=4, krylov_kwargs={"itmax": 60})
    recipes = [
        ("cg", True, dict(algo="cg")),
        ("cg + Fixed(0.1)", True, dict(algo="cg", forcing=nkt.Fixed(0.1))),
        ("cg, exact Newton", True, dict(algo="cg", forcing=None)),
        ("gmres + banded direct", True, dict(algo="gmres", N=banded_direct())),
        ("gmres, no preconditioner", False,
         dict(algo="gmres", max_niter=4, krylov_kwargs={"restart": 20, "itmax": 60})),
        ("bicgstab", False, dict(algo="bicgstab", **negative)),
        ("cgls", False, dict(algo="cgls", **negative)),
    ]
    walls = {}
    for tag, solves, kw in recipes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, info = nkt.newton_krylov_jit(bratu1d.residual, u0, p, **kw)
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        err = float((u - u_star).abs().max())
        finite = bool(torch.isfinite(u).all()) and tuple(u.shape) == (n,)
        log(f"[1-D gallery] N={n} {tag}: solved={bool(info.solved)} "
            f"outer={info.stats.outer_iterations} "
            f"inner={info.stats.inner_iterations} max|u - u*| {err:.3e} "
            f"wall={walls[tag]:.3f} s"
            + ("" if solves else "  (a negative recipe: must not converge)"))
        if solves and not (bool(info.solved) and finite and err <= 1e-5):
            raise AssertionError(f"1-D gallery {tag}: not solved, or "
                                 "max|u - u*| above 1e-5")
        if not solves and (bool(info.solved) or not finite):
            raise AssertionError(f"1-D gallery {tag}: a negative recipe "
                                 "converged or returned a non-finite iterate")
    return walls


def phase_spectral(torch, nkt, bratu2d):
    """Path (d): the spectral diagnostics at 32², f64, on the card, against
    numpy on the dense materialization: ``extreme_eigs(J, k=n²)`` of the
    Bratu Jacobian against ``eigvalsh``, ``cond2_estimate(J, k=n²)``
    (Lanczos on JᵀJ, so ``rmv`` runs on the card) against ``cond``, and the
    Ritz values of ``arnoldi_hessenberg`` (k = n²) on the c = 25
    convection–diffusion Jacobian against ``eigvals``; relative 1e-8 (of
    max|λ| for the complex Ritz values)."""
    import numpy as np

    from newtonkrylov_tpu_torch import spectral
    from newtonkrylov_tpu_torch.operator import materialize_dense
    from newtonkrylov_tpu_torch.problems import convdiff2d

    n, f64 = 32, torch.float64
    J = nkt.JacobianOperator(bratu2d.residual_scaled,
                             bratu2d.initial_guess(n, f64, "cuda"),
                             bratu2d.default_config(n, lam=LAM))
    dense = materialize_dense(J).cpu().numpy()
    t0 = time.perf_counter()
    lo, hi = (float(x) for x in spectral.extreme_eigs(J, k=n * n))
    t_eigs = time.perf_counter() - t0
    ev = np.linalg.eigvalsh(dense)
    e_eigs = max(abs(lo - ev[0]) / abs(ev[0]), abs(hi - ev[-1]) / abs(ev[-1]))
    t0 = time.perf_counter()
    kappa = float(spectral.cond2_estimate(J, k=n * n))
    t_cond = time.perf_counter() - t0
    kappa_np = np.linalg.cond(dense)
    e_cond = abs(kappa - kappa_np) / kappa_np
    pc = convdiff2d.default_config(n, c=CONV_C, dtype=f64, device="cuda")
    uc = convdiff2d.manufactured_solution(n, f64, "cuda")
    Jc = nkt.JacobianOperator(convdiff2d.residual_scaled, uc, pc)
    t0 = time.perf_counter()
    H, _ = spectral.arnoldi_hessenberg(Jc, torch.ones_like(uc), n * n)
    ritz = np.sort_complex(spectral.ritz_values(H))
    t_arn = time.perf_counter() - t0
    exact = np.sort_complex(np.linalg.eigvals(materialize_dense(Jc).cpu().numpy()))
    e_ritz = float(np.abs(ritz - exact).max() / np.abs(exact).max())
    log(f"[spectral] n={n} f64 Bratu: extreme_eigs k={n * n} [{lo:.12e}, "
        f"{hi:.12e}] vs eigvalsh [{ev[0]:.12e}, {ev[-1]:.12e}], rel err "
        f"{e_eigs:.2e} ({t_eigs:.3f} s); cond2_estimate {kappa:.10e} vs cond "
        f"{kappa_np:.10e}, rel err {e_cond:.2e} ({t_cond:.3f} s)")
    log(f"[spectral] n={n} f64 convdiff c=25: {ritz.size} Ritz values of "
        f"arnoldi_hessenberg k={n * n} vs eigvals, max err / max|λ| "
        f"{e_ritz:.2e} ({t_arn:.3f} s)")
    if not (e_eigs <= 1e-8 and e_cond <= 1e-8 and e_ritz <= 1e-8
            and ritz.size == exact.size):
        raise AssertionError("spectral diagnostics on the card disagree with "
                             "numpy beyond 1e-8")


def phase_flagship_bench_u0(torch, nkt, bratu2d, entry_info):
    """Path (e): the flagship from ``bench.py``'s u₀ (the f64 guess
    × (1 + 1e-6), ``bench.py:89, 248``) beside ``entry()``'s
    (``entry_info``, the main path's)."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    u0 = bratu2d.initial_guess(N, torch.float64, "cuda") * (1.0 + 1e-6)
    info = _df32_solve(torch, nkt, bratu2d, N, fft_poisson(precision="high"),
                       "flagship from bench.py's u0, DST(high)", u0=u0)
    log(f"[flagship bench u0] n={N} outer/inner {info.stats.outer_iterations}/"
        f"{info.stats.inner_iterations} beside entry()'s u0 on this card "
        f"{entry_info.stats.outer_iterations}/{entry_info.stats.inner_iterations}"
        f" (main path) and the JAX package's {FLAGSHIP_TPU_REF[0]}/"
        f"{FLAGSHIP_TPU_REF[1]} (BENCH_r05.json; a TPU v5e count)")
    return info


def phase_chain_lane(torch, bratu2d):
    """bench.py's matvec lane at 2048² f32 with w = Δx²λ·eᵘ·mask: the
    per-matvec time of K3 (scale 0.125) and K5 by differencing chains of
    CHAIN steps (CUDA events, best of 4), beside K1's per-call time on the
    same inputs.  The last output of each timed chain is held bit for bit
    against the plain version on the same inputs."""
    from newtonkrylov_tpu_torch.kernels import stencil2d as k

    dev = torch.device("cuda", 0)
    p = bratu2d.default_config(N, lam=LAM)
    va = k.aligned_wrap(bratu2d.initial_guess(N, torch.float32, dev))
    wa = (p.dx * p.dx * p.lam) * torch.exp(va) * k.aligned_mask(
        N, torch.float32, dev)

    def best_ms(fn, repeats=4):
        """(best ms, last output) of ``repeats`` timed calls."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return min(times), out

    per_matvec = {}
    for key, short, call, plain in (
            ("stencil_jvp_chain", "K3",
             lambda s: k.stencil_jvp_chain(va, wa, N, s, 0.125),
             lambda s: k.stencil_jvp_chain_xla(va, wa, N, s, 0.125)),
            ("stencil_chain_probe", "K5",
             lambda s: k.stencil_chain_probe(va, wa, N, s),
             lambda s: k.stencil_chain_probe_xla(va, wa, N, s))):
        times = []
        for s in CHAIN:
            t, out = best_ms(lambda s=s: call(s))
            ref = plain(s)
            if not (bool(torch.isfinite(out).all())
                    and _bitwise_equal(torch, out, ref)):
                raise AssertionError(f"chain lane: {short} k={s} not finite "
                                     "or not bitwise equal to plain")
            log(f"[chain lane] {short} k={s}: bitwise equal to plain, "
                f"max|ref| {float(ref.abs().max()):.3e}")
            times.append(t)
        t_short, t_long = times
        per_matvec[key] = (t_long - t_short) / (CHAIN[1] - CHAIN[0])
        log(f"[chain lane] {short} {key}: {t_short:.4f} ms at k={CHAIN[0]}, "
            f"{t_long:.4f} ms at k={CHAIN[1]}: {per_matvec[key] * 1e3:.2f} "
            f"us per matvec")
    k1 = _time_ms(lambda: k.stencil_jvp(va, wa, N))
    k1d = _device_ms(lambda: k.stencil_jvp(va, wa, N))
    log(f"[chain lane] K1 stencil_jvp on the same inputs: {k1 * 1e3:.2f} us "
        f"per call (CUDA events, back-to-back calls), device "
        f"{_fmt_ms(k1d)}")
    return per_matvec


def phase_breakdown(torch, nkt, bratu2d):
    """Where a 2048² solve spends its time: the cost of each component
    alone, and the device busy time of each whole solve (no asserts)."""
    from newtonkrylov_tpu_torch import df32
    from newtonkrylov_tpu_torch.fftprec import fft_poisson
    from newtonkrylov_tpu_torch.kernels import stencil2d as k
    from newtonkrylov_tpu_torch.precond import chebyshev

    p = bratu2d.default_config(N, lam=LAM)
    u = bratu2d.initial_guess(N, dtype=torch.float32, device="cuda")
    ua, pa, _ = bratu2d.aligned_setup(N, lam=LAM, dtype=torch.float32,
                                      device="cuda")
    for tag, F, x, pp in (("flagship", bratu2d.residual_scaled, u, p),
                          ("aligned", bratu2d.residual_scaled_aligned, ua, pa)):
        lin = _wall_s(torch, lambda: nkt.JacobianOperator(F, x, pp))
        J = nkt.JacobianOperator(F, x, pp)
        log(f"[breakdown] {tag}: linearize {lin * 1e3:.2f} ms host wall; "
            f"matvec replay {_time_ms(lambda: J.mv(x)):.4f} ms per call, "
            f"device {_fmt_ms(_device_ms(lambda: J.mv(x)))}")
    J = nkt.JacobianOperator(bratu2d.residual_scaled, u, p)
    build_s = _wall_s(torch, lambda: fft_poisson(precision="high")(J))
    M = fft_poisson(precision="high")(J)
    log(f"[breakdown] DST preconditioner: factory {build_s * 1e3:.2f} ms host "
        f"wall; apply {_time_ms(lambda: M(u), 10):.4f} ms per call, device "
        f"{_fmt_ms(_device_ms(lambda: M(u), 10))}")
    cheb = chebyshev(16, lo_frac=1 / 300)
    build_s = _wall_s(torch, lambda: cheb(J))
    M = cheb(J)
    log(f"[breakdown] Chebyshev(16) preconditioner: factory {build_s * 1e3:.2f}"
        f" ms host wall; apply (one K4 launch) {_time_ms(lambda: M(u), 10):.4f}"
        f" ms per call, device {_fmt_ms(_device_ms(lambda: M(u), 10))}")
    ud = df32.df_from_f64(u)
    log(f"[breakdown] df32 residual: {_time_ms(lambda: bratu2d.residual_scaled_df(ud, p), 10):.4f}"
        f" ms per call, device "
        f"{_fmt_ms(_device_ms(lambda: bratu2d.residual_scaled_df(ud, p), 10))}; "
        f"floor_estimate {_wall_s(torch, lambda: df32.floor_estimate(bratu2d.residual_scaled, u, p)) * 1e3:.2f}"
        f" ms host wall")
    for tag, run in (("flagship", lambda: phase_flagship(torch, nkt, bratu2d, "profiled")),
                     ("cheb-pcg", lambda: phase_cheb(torch, nkt, bratu2d, N, "profiled"))):
        k.reset_launch_counts()
        counts = {}
        t0 = time.perf_counter()
        by_name, busy_us = _profile(run, counts)
        wall = time.perf_counter() - t0
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log(f"[breakdown] {tag} solve under the profiler: wall {wall:.3f} s, "
            f"device busy {busy_us / 1e6:.4f} s "
            f"({100 * busy_us / 1e6 / wall:.1f}% of wall)")
        for name, us in top:
            log(f"[breakdown]   {us / 1e3:9.2f} ms  {name[:90]}")
        if tag == "cheb-pcg":  # K4 by its kernel's name, per launch
            k4_us = sum(us for name, us in by_name.items() if "cheb_pass" in name)
            launches = sum(c for name, c in counts.items() if "cheb_pass" in name)
            calls = k.LAUNCHES["chebyshev_apply"]
            log(f"[breakdown] cheb-pcg: K4 cheb_pass {k4_us / 1e3:.2f} ms of "
                f"device time over {calls} calls ({launches} cheb_pass "
                f"launches seen by the profiler): "
                f"{_fmt_ms(k4_us / 1e3 / launches if launches else None)} "
                f"per launch, {100 * k4_us / busy_us if busy_us else 0:.1f}% "
                f"of device busy")


def _kernel_class(name):
    """The part of a GMRES solve a device kernel belongs to, by its name."""
    low = name.lower()
    if any(t in low for t in ("gemv", "dot_kernel", "gemmsn", "reduce_1block")):
        return "Arnoldi products (cuBLAS gemv/dot)"
    if any(t in low for t in ("gemm", "cutlass", "xmma")):
        return "DST apply (cuBLAS/CUTLASS gemm)"
    return "other (matvec replay, df32, vector updates)"


def phase_convdiff_breakdown(torch, nkt, warm_wall):
    """Where the 512² convection–diffusion solve spends its time: the DST
    apply and one CGS2 pass over a 100-row basis alone, and the whole solve
    under torch.profiler — the device busy share (against the profiled and
    the unprofiled warm wall) and the device time by part (no asserts)."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson
    from newtonkrylov_tpu_torch.problems import convdiff2d
    from newtonkrylov_tpu_torch.tree import tree_basis_combine, tree_project_rows

    n, f32 = CONVDIFF_N, torch.float32
    p = convdiff2d.default_config(n, dtype=f32, device="cuda")
    u = convdiff2d.manufactured_solution(n, f32, "cuda")

    def linearize():
        return nkt.JacobianOperator(convdiff2d.residual_scaled, u, p)

    def factory():
        return fft_poisson()(J)

    J = linearize()
    M = factory()
    log(f"[breakdown] convdiff {n}²: linearize {_wall_s(torch, linearize) * 1e3:.2f}"
        f" ms host wall; DST factory {_wall_s(torch, factory) * 1e3:.2f} ms host"
        f" wall; matvec replay {_time_ms(lambda: J.mv(u), 10):.4f} ms per "
        f"call, device {_fmt_ms(_device_ms(lambda: J.mv(u), 10))}")
    log(f"[breakdown] convdiff {n}² DST apply: {_time_ms(lambda: M(u), 10):.4f}"
        f" ms per call, device {_fmt_ms(_device_ms(lambda: M(u), 10))}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    V = torch.randn((100, n, n), generator=gen, device="cuda", dtype=f32)

    def cgs_pass():
        return u - tree_basis_combine(V, tree_project_rows(V, u))

    log(f"[breakdown] convdiff {n}² one CGS pass (project + combine) over 100 "
        f"basis rows: {_time_ms(cgs_pass, 10):.4f} ms per call, device "
        f"{_fmt_ms(_device_ms(cgs_pass, 10))}")
    t0 = time.perf_counter()
    by_name, busy_us = _profile(lambda: phase_convdiff(torch, nkt, "profiled"))
    wall = time.perf_counter() - t0
    parts = {}
    for name, us in by_name.items():
        parts[_kernel_class(name)] = parts.get(_kernel_class(name), 0.0) + us
    log(f"[breakdown] convdiff solve under the profiler: wall {wall:.3f} s, "
        f"device busy {busy_us / 1e6:.4f} s ({100 * busy_us / 1e6 / wall:.1f}% "
        f"of the profiled wall, {100 * busy_us / 1e6 / warm_wall:.1f}% of the "
        f"warm wall {warm_wall:.3f} s)")
    for part, us in sorted(parts.items(), key=lambda kv: -kv[1]):
        log(f"[breakdown]   {us / 1e3:9.2f} ms  {100 * us / busy_us:5.1f}% of "
            f"device busy  {part}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[breakdown]   {us / 1e3:9.2f} ms  {name[:90]}")


def _solve_profile(torch, tag, run, warm_wall):
    """One solve under the profiler: its device busy time against its
    unprofiled wall ``warm_wall``, its device events and the six costliest
    kernels (no asserts)."""
    counts = {}
    t0 = time.perf_counter()
    by_name, busy_us = _profile(run, counts)
    wall = time.perf_counter() - t0
    log(f"[breakdown] {tag} solve under the profiler: wall {wall:.3f} s, "
        f"device busy {busy_us / 1e6:.4f} s = {100 * busy_us / 1e6 / warm_wall:.1f}% "
        f"of its unprofiled wall {warm_wall:.3f} s; {sum(counts.values())} "
        f"device events")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[breakdown]   {us / 1e3:9.2f} ms  {100 * us / busy_us:5.1f}%  "
            f"{counts[name]:8d} x  {name[:80]}")


def phase_slice_breakdown(torch, nkt, bratu2d, walls):
    """Where the multigrid and line-relaxation solves spend their time
    (measurements only, no gates).  For MG-general at 512² and ADI(4) at
    256², c = 25, linearized at u* in f32: host time per linearization, per
    probe and per factory build (probe + hierarchy + smoothers); per
    preconditioner apply the host time to issue it, its wall and its device
    time, and the device events it launches.  Then the MG-PCG and two-grid
    2048² solves under the profiler, each against its unprofiled wall in
    ``walls``."""
    from newtonkrylov_tpu_torch.mg import probe_5point_general
    from newtonkrylov_tpu_torch.problems import convdiff2d

    for tag, n in (("mg-general", 512), ("adi", 256)):
        f32 = torch.float32
        p = convdiff2d.default_config(n, c=CONV_C, dtype=f32, device="cuda")
        u = convdiff2d.manufactured_solution(n, f32, "cuda")

        def linearize():
            return nkt.JacobianOperator(convdiff2d.residual_scaled, u, p)

        J = linearize()
        factory = _conv_factory(tag)
        log(f"[breakdown] {tag} {n}² c=25: linearize "
            f"{_wall_s(torch, linearize) * 1e3:.2f} ms, probe (6 replays) "
            f"{_wall_s(torch, lambda: probe_5point_general(J)) * 1e3:.2f} ms, "
            f"factory build {_wall_s(torch, lambda: factory(J)) * 1e3:.2f} ms "
            f"host wall")
        M, r = factory(J), J.res
        M(r)
        host, wall = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M(r)
            host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        counts = {}
        _, dev_us = _profile(lambda: M(r), counts)
        log(f"[breakdown] {tag} {n}² apply: host {1e3 * min(host):.2f} ms to "
            f"issue, wall {1e3 * min(wall):.2f} ms (best of 3), device "
            f"{dev_us / 1e3:.2f} ms and {sum(counts.values())} device events "
            f"(one profiled apply)")
    for tag, run, key in (
            (f"mg-pcg {N}²", lambda: phase_mg_pcg(torch, nkt, bratu2d, "profiled"),
             "mg-pcg"),
            (f"two-grid {N}²", lambda: phase_two_grid(torch, nkt, bratu2d, "xla", "profiled"),
             "two-grid")):
        _solve_profile(torch, tag, run, walls[key])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import newtonkrylov_tpu_torch as nkt
    from newtonkrylov_tpu_torch.kernels import probe as kp
    from newtonkrylov_tpu_torch.kernels import stencil2d as k
    from newtonkrylov_tpu_torch.problems import bratu2d

    t_start = time.perf_counter()
    phase_environment(torch)
    summary = phase_kernels(torch)
    summary.update(phase_chain_kernels(torch, nkt, bratu2d))
    summary["chain_call"] = phase_probe_kernels(torch)
    phase_selfcheck(torch)
    log(f"[summary] build and kernel checks: {time.perf_counter() - t_start:.1f} s")

    # Each path counted on its own: the counts are zeroed just before it and
    # read just after, so every launch read is that path's.
    launches = {}

    def counted(path, keys, run, into=launches):
        """``run()`` with the counts zeroed before and read after; the
        counts of ``keys`` go into ``into`` and must be positive."""
        for counters in (k, kp):
            counters.reset_launch_counts()
        t0 = time.perf_counter()
        out = run()
        now = {**k.LAUNCHES, **kp.LAUNCHES}
        into.update({key: now[key] for key in keys})
        log(f"[launches] {path} ({time.perf_counter() - t0:.1f} s): {now}")
        for key in keys:
            if into[key] <= 0:
                raise AssertionError(f"{key} was never launched by the {path}")
        return out

    def main_path():  # the first slice's: the aligned and flagship solves
        return (phase_aligned(torch, nkt, bratu2d, "run"),
                phase_flagship(torch, nkt, bratu2d, "run"))

    info_a, info_f = counted("main path", ("stencil_jvp", "bratu_residual"),
                             main_path)
    if launches["stencil_jvp"] < info_a.stats.inner_iterations:
        raise AssertionError("K1 launched fewer times than the aligned "
                             "solve's inner iterations")
    per_matvec = counted("chain lane", ("stencil_jvp_chain",
                                        "stencil_chain_probe"),
                         lambda: phase_chain_lane(torch, bratu2d))
    info_c = counted("cheb-pcg solve", ("chebyshev_apply",),
                     lambda: phase_cheb(torch, nkt, bratu2d, N, "run"))
    if launches["chebyshev_apply"] < info_c.stats.inner_iterations:
        raise AssertionError("K4 launched fewer times than the Cheb-PCG "
                             "solve's inner iterations")
    # path (a): the same lane on the Lanczos interval; the kernels JSON
    # counts K4's launches on both Cheb-PCG paths
    lz_launches = {}
    info_l = counted("cheb-pcg lanczos solve", ("chebyshev_apply",),
                     lambda: phase_cheb_lanczos(torch, nkt, bratu2d),
                     into=lz_launches)
    k4_l = lz_launches["chebyshev_apply"]
    log(f"[launches] cheb-pcg lanczos solve: K4 {k4_l} launches = inner "
        f"{info_l.stats.inner_iterations} + outer {info_l.stats.outer_iterations}"
        f"; outer/inner beside lo_frac=1/300's {info_c.stats.outer_iterations}/"
        f"{info_c.stats.inner_iterations} from the same u0")
    if k4_l != info_l.stats.inner_iterations + info_l.stats.outer_iterations:
        raise AssertionError("K4 launches on the Lanczos Cheb-PCG path are not "
                             "one per preconditioner apply (inners + outers)")
    launches["chebyshev_apply"] += k4_l
    phase_lanczos_interval(torch, nkt, bratu2d)
    model = counted("probe lane", ("chain_call",),
                    lambda: phase_probe_lane(torch))
    # the GMRES paths run no hand-written kernel: their counts are logged
    counted("gmres flagship", (),
            lambda: phase_gmres_flagship(torch, nkt, bratu2d, "run"))
    counted("convdiff solve", (), lambda: phase_convdiff(torch, nkt, "run"))
    # this slice's paths (b)-(e) run no hand-written kernel: counts logged
    counted("flagship pipelined solve", (),
            lambda: phase_pipelined(torch, nkt, bratu2d, info_f))
    counted("flagship from bench.py's u0", (),
            lambda: phase_flagship_bench_u0(torch, nkt, bratu2d, info_f))
    counted("1-D gallery", (), lambda: phase_gallery(torch, nkt))
    counted("spectral cross-checks", (), lambda: phase_spectral(torch, nkt, bratu2d))

    # the multigrid and line-relaxation slice (PCR line solves on the card);
    # only two-grid with engine="pallas" runs a hand-written kernel (K4)
    walls, conv = {}, {}
    for tag, n in (("mg-general", 512), ("adi", 256), ("mg-general", 256)):
        conv[tag, n], _ = counted(
            f"convdiff c=25 {tag} {n}² solve", (),
            lambda tag=tag, n=n: phase_conv25(torch, nkt, tag, n, "run"))
    if not (conv["mg-general", 256].stats.inner_iterations
            < conv["adi", 256].stats.inner_iterations):
        raise AssertionError("MG-general took no fewer inner iterations than "
                             "ADI(4) at 256²")
    walls["mg-pcg"] = counted("mg-pcg solve", (), lambda: phase_mg_pcg(
        torch, nkt, bratu2d, "run")).t
    info_tg = counted("two-grid xla solve", (), lambda: phase_two_grid(
        torch, nkt, bratu2d, "xla", "run"))
    walls["two-grid"] = info_tg.t
    tg_launches = {}  # the kernels JSON keeps K4's count on the Cheb-PCG path
    info_tgp = counted("two-grid pallas solve", ("chebyshev_apply",),
                       lambda: phase_two_grid(torch, nkt, bratu2d, "pallas", "run"),
                       into=tg_launches)
    k4_tg = tg_launches["chebyshev_apply"]
    log(f"[launches] two-grid pallas solve: K4 {k4_tg} launches over "
        f"{info_tgp.stats.inner_iterations} inner iterations "
        f"({k4_tg / max(info_tgp.stats.inner_iterations, 1):.2f} per inner); "
        f"outer/inner {info_tgp.stats.outer_iterations}/"
        f"{info_tgp.stats.inner_iterations} beside engine xla's "
        f"{info_tg.stats.outer_iterations}/{info_tg.stats.inner_iterations}")
    if k4_tg < 2 * info_tgp.stats.inner_iterations:
        raise AssertionError("K4 launched fewer than twice per inner iteration "
                             "on the two-grid pallas path")

    # warm repeats (first-use costs paid), the lane's own size, the
    # small-size cross-checks and the breakdowns
    t0 = time.perf_counter()
    phase_cheb(torch, nkt, bratu2d, N, "warm")
    phase_cheb(torch, nkt, bratu2d, 1024, "run")
    _, warm_wall = phase_convdiff(torch, nkt, "warm")
    phase_aligned_small(torch, nkt, bratu2d)
    phase_convdiff_small(torch, nkt)
    phase_conv25_small(torch, nkt)
    log(f"[summary] warm repeats and 64² cross-checks: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_breakdown(torch, nkt, bratu2d)
    phase_convdiff_breakdown(torch, nkt, warm_wall)
    phase_slice_breakdown(torch, nkt, bratu2d, walls)
    log(f"[summary] breakdowns: {time.perf_counter() - t0:.1f} s")

    pallas = "newtonkrylov_tpu/kernels/stencil2d.py"
    # kernel -> (source, replaced Pallas function, interior n, steps of the
    # timed call)
    table = {
        "stencil_jvp": ("stencil2d", f"{pallas}:245", N, 0),
        "bratu_residual": ("stencil2d", f"{pallas}:483", N, 0),
        "stencil_jvp_chain": ("chain2d", f"{pallas}:302", N, CHAIN[0]),
        "chebyshev_apply": ("chain2d", f"{pallas}:448", N, 16),
        "stencil_chain_probe": ("chain2d", f"{pallas}:366", N, CHAIN[0]),
        "chain_call": ("chain_probe", "benchmarks/kernel_probe.py:42",
                       PROBE_N, PROBE_KS),
    }
    kernels = []
    for name, (src, replaces, n, steps) in table.items():
        err, ms, plain_ms = summary[name]
        bound_ms, bound_by = _bound(name, n + 8, k.round_up(n + 2, 128), n, 4,
                                    steps)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"newtonkrylov_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        log(f"[summary] {name}: {n}² f32{f' steps={steps}' if steps else ''}"
            f" {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms"
            f" ({bound_by}); {launches[name]} launches on its path")
    for name, us in per_matvec.items():
        log(f"[summary] {name}: {us * 1e3:.2f} us per chained matvec")
    log(f"[summary] probe cost model at {PROBE_N}²: copy + grid sync per step "
        f"{model['copy_sync_stencil_us']:.3f} us (stencil), step through "
        f"memory {model['memory_step_us'][2]:.3f} us (mul x2), row shift "
        f"{model['row_shift_us']:.3f} us, column shift "
        f"{model['column_shift_us']:.3f} us, per multiply "
        f"{model['per_mul_us']:.3f} us")
    log(f"[summary] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
