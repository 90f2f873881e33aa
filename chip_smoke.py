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
4. the probe kernel K6 (overlapped tiles, passes of at most 16 steps)
   against its plain version, bit for bit: each of the JAX probe's 20
   variants at n = 64 and 1024, f32, k = 1, 7 and 8, timed per call, and
   every step at the pass boundaries (carried and ping-pong at k = 15, 16,
   17, 33, 34; ping-pong unrolled 2 and 4 at k = 36 and 40) at n = 64;
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
    iterations); (d) the spectral diagnostics at 32² f64 against numpy on
    the dense materialization (relative 1e-8); (e) the flagship from
    ``bench.py``'s u₀;
13. the host-stepped driver, globalization and host-side factorizations:
    (g) the reference's 1-D Bratu gallery at N = 10⁴ in f64 through
    ``newton_krylov`` (GMRES + ILU(0) in host C++ by bandwidth and by
    offsets, and GMRES + banded direct solve to
    max|u − u*| ≤ 5e-6, the direct ones in at most two inners an outer;
    plain GMRES, BiCGStab and CGLS must fail), with the card's refined PCR
    tridiagonal solve at ≤ 1e-9 relative residual beside Thomas on the
    CPU (its CG recipes, at N = 2,000, run in path (t)); (h) Kelley's BVP
    at n = 801 with GMRES + banded LU in f64 and refined to 1e-8 (the
    reference's stalling FGMRES + nested-GMRES recipe runs in path (t));
    (i) Ψtc near the 2-D Bratu fold at 2048² (λ = 6.8, rough
    start, f32 Krylov + df32, full GMRES) with ``chebyshev(16,
    lo_frac=1/300)`` — one K4 launch per preconditioner apply — and with the
    DST preconditioner, their roots
    within 1e-6, beside Newton + Armijo from the same start; (j)
    quasilinear diffusion at 256² with MG-general, f32 Krylov + df32,
    max|u − u*| ≤ 1e-6; (k) convection–diffusion c = 25 + ILU(0) at 64² in
    f64 on the card against the CPU;
14. warm repeats (Cheb-PCG at 2048², and at 1024², its lane's own size,
    convection–diffusion at 512², the flagship with a native f64 residual
    beside the df32 flagship, in turns), the aligned and the
    convection–diffusion solves (c = 2, and ADI(4) and MG-general at c = 25
    on PCR) at 64² against the same solves on the CPU, and breakdowns: each
    component's cost alone and the device busy time of the flagship,
    Cheb-PCG, convection–diffusion, MG-PCG and two-grid solves under
    torch.profiler, with K4's device time per launch inside the 2048²
    Cheb-PCG solve and, for MG-general at 512² and ADI(4) at 256², the host
    and device time and device events of one preconditioner apply, and the
    cost of one host-ILU(0) GMRES iteration at N = 10⁴ with its two copies
    and its C++ solve timed apart (measurements only);
15. time stepping and the differentiable solve (run after 13): (l) the 2-D
    heat equation at 2048² (a = 0.01, u₀ = sin(πx)sin(πy), 6
    backward-Euler steps of Δt = 0.05 through ``integrate``, f32 Krylov +
    df32) with Cheb-PCG on the Gershgorin box of the step Jacobian — one K4
    launch per apply — gated on the exact decay g⁶·u₀ and each step's f64
    residual; (m) the same march through ``integrate_scan`` with DST-PCG;
    (n) at 256² the two drivers bit for bit and a checkpointed march
    resumed bit for bit; (o) the spring (three steppers, 5 steps), heat1d
    (3 steps), a refined heat1d_dg step and the upwind march (5 steps) on
    the card against the CPU; (p) d(Σu*)/dλ of the 2-D Bratu root at 512²
    by the adjoint against central differences;
16. the sharded solvers, path (q): a world-1 NCCL process group (a file
    store in a temporary directory, destroyed at the end) and a 1×1 mesh,
    every reduction an NCCL all-reduce and every global-DST product a
    reduce-scatter (one card: the ghost exchange has no neighbour and sends
    no message): (q1) the flagship at 2048² through
    ``newton_krylov_sharded`` (overlapped exchange, f32 CG, df32 acceptance
    with the words exchanged apart, ``fft_poisson(scope="global",
    precision="high")`` built once), gated on ``solved``, the f64 true
    residual and the unsharded flagship's counts; (q2) Ψtc through the same
    driver seam, residuals sign-flipped, δ₀ = (n+1)²; (q3) Cheb-PCG with
    the sharded ``chebyshev(16, lo_frac=1/300)`` (an exchange and the plain
    stencil per polynomial step: no K4), its counts beside (cheb-pcg)'s;
    (q4) ``integrate_scan_sharded``, the heat march of (m) for 5 steps with
    the global DST, gated on (m)'s per-step counts and the decay g⁵.  Each
    prints its wall and the collectives the port's wrappers issued.  Then
    (q5) the exchange's transpose at 2048² f64: J.rmv of the exchanged
    residual against the unsharded J.rmv (bit for bit in the plain
    exchange form, 1e-12 relative in the overlapped one) and the dot test;
    (r4) the weak-scaling harness (``utils/scaling.py``) at local_n = 2048
    on a 1-device row mesh and a 1×1 mesh, one exchange per mesh axis and
    matvec;
17. path (r), run just after the main path: (r1) the flagship
    configuration at 2048² exported whole (``utils/serving.py``), saved,
    loaded and called — solved, the f64 true residual, the live
    flagship's counts and its state bit for bit (or within 1e-12·max|u|,
    which of the two is printed), with the export time, the artifact's
    size and the loaded wall beside the live one; (r2) the aligned solve
    at 2048² the same way, its exported graph holding K1 and K2 as ops,
    the loaded program's K1/K2 launches counted on their own (K1 once a
    CG matvec, K2 once a residual: the live solve's less its
    linearizations' tracing); (r3) ``time_chain`` on K1 at 2048² f32
    beside K1's device time, the ``PhaseTimer`` summary and
    ``solve_report`` of (r1), and a ``trace()`` of one loaded flagship
    solve holding an ``annotate`` range;
18. path (s), run just after the GMRES flagship of phase 10: (s1) that
    flagship — ``newton_krylov_jit`` with its default ``algo="gmres"`` —
    exported, saved, loaded and called twice: solved, the live solve's
    counts and its state bit for bit, with the export time, the
    artifact's size and the loaded walls beside the live one; (s2) Ψtc
    (default GMRES), BiCGStab and pipelined CG on Bratu 64² in f64 and CGLS
    on a 64-unknown cubic tridiagonal system, each exported, loaded and
    held bit for bit against its live run;
19. path (t), run just after path (q): the port's example gallery
    (``newtonkrylov_tpu_torch/examples``) through each example's ``main`` on
    the card at ``EXAMPLE_SIZES`` — the JAX examples' sizes, the marches and
    the 1-D gallery's CG recipes at a cut depth, ``bratu_2d_cuda`` at
    2048² (its refined CG lane on K1 and K2: K1 launches at least its
    inner count), ``sharded_bratu`` on a world-1 NCCL group — each gated as
    its JAX counterpart asserts or prints as expected, with its wall and
    counts logged; beside them the four unsharded walkthroughs run with
    ``--device cuda --no-figures``, one subprocess each.

Launch counts are zeroed just before each of phases 6–13 and 15–19 and read
just after; each kernel must have been launched on its path (the two-grid
path's K4 count is logged on its own line; the JSON's K4 count is that of
the two Cheb-PCG paths at 2048², the Ψtc path and the heat march, and its
K1 and K2 counts those of the main path and path (t)).  The
last two lines are a JSON object of per-kernel results and the JSON
status object.  Without a CUDA device the
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
PROBE_PASS = 16   # the most steps one K6 pass runs (csrc/chain_probe.cu)
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
GALLERY_SMALL_N = 2_000  # the three CG recipes, in path (t) (time)
PIPELINED_ITMAX = 50  # inner cap of path (b); plain CG takes ≤ 2 an outer
PTC_LAM = 6.8     # path (i): just below the 2-D Bratu fold (λ* ≈ 6.808)
# Path (i) runs full GMRES (a basis of up to PTC_ITMAX f32 vectors, 9.6 GB
# at 2048²): GMRES(100) with chebyshev(16)'s default interval stagnated
# there, 457,845 inner iterations over 10 steps (PERF.md, PR 7).
PTC_ITMAX = 600
NLDIFF_N = 256    # path (j): the size of the c = 25 MG-general lane
# Path (h)'s stalling FGMRES + nested GMRES(30) recipe: each inner solve is
# capped at one restart cycle.  Uncapped, a stalled outer runs to the
# default itmax 2n = 3,204 FGMRES steps of 30 nested steps each.
BVP_NESTED_ITMAX = 40
# Paths (l)–(n): the 2-D heat equation, a = 0.01, u₀ = sin(πx)sin(πy),
# backward-Euler steps of Δt = 0.05 (8,400× the explicit limit at 2048²):
# 6 to t = 0.3 (20 to t = 1 before path (q) needed the time, 8 before path
# (t))
HEAT_N = 2048
HEAT_SMALL_N = 256
HEAT_A = 0.01
HEAT_DT = 0.05
HEAT_STEPS = 6
# Path (o): the spring at the reference's Δt = 0.01 for 5 steps (to t = 0.05,
# not its t = 2), the upwind march for 5 (to t = 0.05, not the JAX test's
# 0.2), heat1d at Δt = 0.1 to t = 0.3 (not 1): a step is host-bound at
# 0.14–0.8 s on either device, so the reference's 200 spring steps would
# take ~7 minutes for three steppers
SPRING_STEPS = 5
UPWIND_STEPS = 5
HEAT1D_T = 0.3
# Path (q): the sharded solvers on a world-1 NCCL group, the heat march of
# (m) cut to 5 steps
SHARDED_HEAT_STEPS = 5
GRAD_N = 512      # path (p): the differentiable solve
GRAD_LAM = 5.0
# Path (t): the port's example gallery (newtonkrylov_tpu_torch/examples) at
# the JAX examples' sizes, bratu_2d_cuda at the flagship's 2048².  The
# marches and the host-stepped recipes that phases (g) and (h) already cut
# run at a cut depth: every step is a Newton solve whose outers each trace
# their linearization on the host (0.1-0.3 s), whatever the size.
EXAMPLE_SIZES = {
    "simple_2d": {},
    "spring_implicit": {"t_final": 2.0},   # 20 of the 400 steps a stepper
    "heat_1d": {"t_final": 0.3},           # 3 of the 30 steps a stepper
    "heat_1d_dg": {"t_final": 0.005},      # 10 of the 100 steps a march
    "heat_2d": {"steps": 8},               # 8 of the 40 steps a stepper
    "bratu_1d": {"cg_n": GALLERY_SMALL_N},  # the CG recipes at (g)'s N
    "bvp_kelley": {"nested_itmax": BVP_NESTED_ITMAX},  # (h)'s cap
    "continuation_bratu": {},
    "ptc_globalization": {},
    "convdiff_2d": {},
    "bratu_2d_cuda": {"n": N},
    "sharded_bratu": {},
}
# the examples run this many at a time (each host-bound, one thread), the
# longest first; the walkthroughs run on the card, one process each, beside;
# the sharded one needs W ranks (NCCL refuses two on one card), and
# sharded_bratu on a world-1 group stands in for it
WALKTHROUGHS = ("diagnostics", "heat1d_dg", "heat2d", "precision")
EXAMPLE_WORKERS = 3
EXAMPLE_ORDER = ("convdiff_2d", "bratu_1d", "heat_1d", "ptc_globalization",
                 "bvp_kelley", "heat_1d_dg", "continuation_bratu",
                 "spring_implicit", "sharded_bratu", "heat_2d", "simple_2d",
                 "bratu_2d_cuda")

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
    return smi


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
    err = max(err, _probe_boundaries(torch, gen))
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


def _probe_boundaries(torch, gen):
    """K6 at its pass boundaries, bit for bit against the plain version:
    every step of ``kernels/probe.py``'s STEPS, carried and ping-pong, at
    k = S − 1, S, S + 1, 2S + 1 and 2S + 2 (S = 16 steps a pass), and
    ping-pong unrolled 2 and 4 at k = 36 and 40 (passes of 16, 16 and 4 or
    8 steps), on the 64² layout (72 × 128: a tile's halo wraps the array
    more than once).  Returns the largest |kernel − plain|."""
    from newtonkrylov_tpu_torch.kernels import probe as kp

    dev = torch.device("cuda", 0)
    shape = (72, 128)
    v = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    w = torch.randn(shape, generator=gen, device=dev,
                    dtype=torch.float32).abs() + 0.1
    S = PROBE_PASS
    runs = [(k, {}) for k in (S - 1, S, S + 1, 2 * S + 1, 2 * S + 2)]
    runs += [(k, {"pingpong": True}) for k in (S - 1, S, S + 1, 2 * S + 1,
                                               2 * S + 2)]
    runs += [(36, {"pingpong": True, "unroll": 2}),
             (40, {"pingpong": True, "unroll": 4})]
    err, cases = 0.0, 0
    for step in kp.STEPS:
        for k_steps, kw in runs:
            got = kp.chain_call(step, v, w, k_steps, **kw)
            ref = kp.chain_call_xla(step, v, w, k_steps, **kw)
            e = float((got - ref).abs().max())
            if not (bool(torch.isfinite(ref).all())
                    and _bitwise_equal(torch, got, ref)):
                raise AssertionError(f"K6 pass boundary {step} k={k_steps} "
                                     f"{kw}: differs from plain, max|err| "
                                     f"{e:.3e}")
            err, cases = max(err, e), cases + 1
    log(f"[probe kernels] pass boundaries: {cases} cases ({len(kp.STEPS)} "
        f"steps × {len(runs)} calls, S = {S}) bitwise equal to the plain "
        f"version")
    return err


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


def phase_aligned(torch, nkt, bratu2d, pass_name, keep=None):
    from newtonkrylov_tpu_torch.kernels import stencil2d as k

    u, info, wall, ui, u0i, p = _aligned_solve(
        torch, nkt, bratu2d, N, "cuda", torch.float32)
    if keep is not None:  # the caller keeps the state and the wall
        keep["u"], keep["wall"] = u, wall
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
                u0=None, krylov_kwargs=None, keep=None):
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
    if keep is not None:  # the caller keeps the state and the wall
        keep["u"], keep["wall"] = u, wall
    return info


def phase_flagship(torch, nkt, bratu2d, pass_name, keep=None):
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    return _df32_solve(torch, nkt, bratu2d, N, fft_poisson(precision="high"),
                       f"flagship {pass_name}, DST(high)", keep=keep)


def phase_gmres_flagship(torch, nkt, bratu2d, pass_name, keep=None):
    """The flagship configuration with ``algo="gmres"`` and no ``restart``:
    the driver's parity basis of min(n², 100) applies."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    info = _df32_solve(torch, nkt, bratu2d, N, fft_poisson(precision="high"),
                       f"gmres flagship {pass_name}, DST(high)", algo="gmres",
                       keep=keep)
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
    """Path (g): the reference's 1-D Bratu gallery (``examples/bratu_1d.py``)
    at N = 10⁴, λ = 3.51382, in f64 through ``newton_krylov``, as the
    example calls it; its three CG recipes (at N = 2,000) run in path (t),
    in the port's example.
    The positive recipes must solve with max|u − u*| ≤ 5e-6 against the
    closed form (scaled by Δx² at N = 2,000); GMRES + banded direct (PCR
    with refinement on the card) and GMRES + ILU(0) (host C++, by bandwidth
    and by offsets) also in at most two inner iterations an outer (a
    tridiagonal ILU(0) is the exact LU); the negative ones
    (``max_niter=4``, ``itmax=60``) must end unsolved with a finite
    iterate.  The host-side recipes log their copies between the card and
    the host."""
    from newtonkrylov_tpu_torch import precond as tp
    from newtonkrylov_tpu_torch.problems import bratu1d

    f64 = torch.float64
    negative = dict(max_niter=4, krylov_kwargs={"itmax": 60})
    # (tag, N, solves, one inner an outer, kwargs); the three CG recipes
    # (tens of thousands of host-stepped iterations at N = 10⁴) run at
    # GALLERY_SMALL_N in path (t)'s bratu_1d, with the same gates
    recipes = [
        ("gmres + ILU0 (host C++)", GALLERY_N, True, True,
         dict(algo="gmres", N=tp.ilu0(bandwidth=1))),
        ("gmres + ILU0, offsets (-1, 0, 1)", GALLERY_N, True, True,
         dict(algo="gmres", N=tp.ilu0(offsets=(-1, 0, 1)))),
        ("gmres + banded direct", GALLERY_N, True, True,
         dict(algo="gmres", N=tp.banded_direct())),
        ("gmres, no preconditioner", GALLERY_N, False, False,
         dict(algo="gmres", max_niter=4, krylov_kwargs={"restart": 20, "itmax": 60})),
        ("bicgstab", GALLERY_N, False, False, dict(algo="bicgstab", **negative)),
        ("cgls", GALLERY_N, False, False, dict(algo="cgls", **negative)),
    ]
    walls = {}
    for tag, n, solves, direct, kw in recipes:
        p = bratu1d.default_config(n)
        u0 = bratu1d.initial_guess(n, f64, "cuda")
        u_star = bratu1d.true_solution(bratu1d.grid(n, f64, "cuda"))
        # the discretization error scales with Δx²: 5e-6 at N = 10⁴
        limit = 5e-6 * ((GALLERY_N + 1) / (n + 1)) ** 2
        tp.reset_host_copies()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, info = nkt.newton_krylov(bratu1d.residual, u0, p, **kw)
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        err = float((u - u_star).abs().max())
        finite = bool(torch.isfinite(u).all()) and tuple(u.shape) == (n,)
        outer, inner = info.stats.outer_iterations, info.stats.inner_iterations
        copies = ("" if "ILU0" not in tag else
                  f" host copies {tp.HOST_COPIES['device_to_host']} to the host, "
                  f"{tp.HOST_COPIES['host_to_device']} back")
        log(f"[1-D gallery] N={n} {tag}: solved={info.solved} outer={outer} "
            f"inner={inner} max|u - u*| {err:.3e} (limit {limit:.3e}) "
            f"wall={walls[tag]:.3f} s"
            + copies
            + ("" if solves else "  (a negative recipe: must not converge)"))
        if solves and not (info.solved and finite and err <= limit):
            raise AssertionError(f"1-D gallery {tag}: not solved, or "
                                 f"max|u - u*| above {limit:.3e}")
        if direct and inner > 2 * outer:
            raise AssertionError(f"1-D gallery {tag}: more than two inner "
                                 "iterations an outer from a direct solve")
        if "ILU0" in tag and not (
                tp.HOST_COPIES["device_to_host"] == tp.HOST_COPIES["host_to_device"]
                >= inner > 0):
            raise AssertionError(f"1-D gallery {tag}: the host copies do not "
                                 "match one each way per apply")
        if not solves and (info.solved or not finite):
            raise AssertionError(f"1-D gallery {tag}: a negative recipe "
                                 "converged or returned a non-finite iterate")
    return walls


def phase_tridiagonal(torch, nkt):
    """The card's tridiagonal solve of ``banded_direct`` on the 1-D Bratu
    Jacobian at u₀, N = 10⁴, f64, seeded right-hand side: relative residual
    ‖T·x − b‖/‖b‖ of PCR alone, of PCR with refinement (gated ≤ 1e-9) and of
    Thomas on the CPU on the same diagonals."""
    from newtonkrylov_tpu_torch import precond as tp
    from newtonkrylov_tpu_torch.operator import materialize_banded
    from newtonkrylov_tpu_torch.problems import bratu1d

    n = GALLERY_N
    J = nkt.JacobianOperator(bratu1d.residual,
                             bratu1d.initial_guess(n, torch.float64, "cuda"),
                             bratu1d.default_config(n))
    _, (dl, d, du) = materialize_banded(J, 1, 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b = torch.randn(n, generator=gen, device="cuda", dtype=torch.float64)

    def rel(x, diags, rhs):
        return float(torch.linalg.vector_norm(tp._tridiag_mv(*diags, x) - rhs)
                     / torch.linalg.vector_norm(rhs))

    diags = (dl, d, du)
    cpu = tuple(x.cpu() for x in diags)
    r_pcr = rel(tp.pcr_solve(*diags, b), diags, b)
    r_ref = rel(tp.pcr_refined_solve(*diags, b), diags, b)
    r_thomas = rel(tp.thomas_solve(*cpu, b.cpu()), cpu, b.cpu())
    dominance = float((d.abs() - dl.abs() - du.abs())[1:-1].min())
    log(f"[tridiagonal] N={n} f64 1-D Bratu Jacobian at u0 (min(|d| - |dl| - "
        f"|du|) {dominance:.3f}): |T x - b|/|b| PCR {r_pcr:.3e}, PCR + 2 "
        f"refinements {r_ref:.3e} (limit 1e-9), Thomas on the CPU {r_thomas:.3e}")
    if not r_ref <= 1e-9:
        raise AssertionError("the card's tridiagonal solve is not direct: "
                             "relative residual above 1e-9")


def phase_ilu_breakdown(torch, nkt):
    """What one host-ILU GMRES iteration costs at N = 10⁴ on the card (no
    gate): one apply of ``ilu0(bandwidth=1)`` built at u₀ — its copy to the
    host, the C++ triangular solves and the copy back, each timed alone —
    and a GMRES(20) cycle of 20 iterations with and without it."""
    import numpy as np

    from newtonkrylov_tpu_torch import precond as tp
    from newtonkrylov_tpu_torch.problems import bratu1d
    from newtonkrylov_tpu_torch.solvers import gmres

    n = GALLERY_N
    J = nkt.JacobianOperator(bratu1d.residual,
                             bratu1d.initial_guess(n, torch.float64, "cuda"),
                             bratu1d.default_config(n))
    build = _wall_s(torch, lambda: tp.ilu0(bandwidth=1)(J), reps=2)
    M = tp.ilu0(bandwidth=1)(J)
    r = J.res
    host = r.cpu().numpy()

    def best(fn, reps=20):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return 1e3 * min(times), 1e3 * float(np.median(times))

    parts = {
        "apply (both copies + C++ solve)": lambda: M(r),
        "copy to the host (.cpu())": lambda: r.cpu(),
        "C++ triangular solves": lambda: M.host_solve(host),
        "copy to the card (.to(cuda))": lambda: torch.from_numpy(host).to("cuda"),
    }
    for tag, fn in parts.items():
        b_ms, m_ms = best(fn)
        log(f"[ilu breakdown] N={n}: {tag}: best {b_ms:.4f} ms, median "
            f"{m_ms:.4f} ms (host clock, device drained)")
    for tag, kw in (("GMRES(20) + ILU0", {"N": M}), ("GMRES(20)", {})):
        b_ms, m_ms = best(lambda kw=kw: gmres(J, r, restart=20, itmax=20,
                                              rtol=0.0, atol=0.0, **kw), reps=5)
        log(f"[ilu breakdown] N={n}: {tag}, 20 iterations: best "
            f"{b_ms / 20:.4f} ms an iteration, median {m_ms / 20:.4f} ms")
    log(f"[ilu breakdown] N={n}: factory (3 probes, CSR to the host, C++ "
        f"factorization) {build * 1e3:.2f} ms host wall")


def phase_bvp(torch, nkt):
    """Path (h): Kelley's BVP (``examples/bvp_kelley.py``), n = 801, through
    ``newton_krylov`` with GMRES + ``banded_lu(2, 2)`` in f64, and refined
    to 1e-8 with f32 Krylov and the df32 residual; each gated on ``solved``
    and its plain f64 residual under its tolerance.  The reference's
    stalling FGMRES + nested GMRES(30) recipe (its inner solves capped at
    ``BVP_NESTED_ITMAX``) runs in path (t), in the port's example."""
    from newtonkrylov_tpu_torch import precond as tp
    from newtonkrylov_tpu_torch.problems import bvp

    p = bvp.default_config(device="cuda")
    U0 = bvp.initial_guess(p)
    f0 = float(torch.linalg.vector_norm(bvp.residual(U0, p)))
    runs = [
        ("gmres + banded LU(2, 2), f64", 1e-6,
         dict(algo="gmres", N=tp.banded_lu(2, 2))),
        ("gmres + banded LU(2, 2), f32 Krylov + df32", 1e-8,
         dict(algo="gmres", N=tp.banded_lu(2, 2), tol_rel=1e-8,
              residual_df=bvp.residual_df)),
    ]
    for tag, tol_rel, kw in runs:
        tp.reset_host_copies()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        U, info = nkt.newton_krylov(bvp.residual, U0, p, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fu = float(torch.linalg.vector_norm(bvp.residual(U.to(torch.float64), p)))
        log(f"[bvp] n={p.n} {tag}: solved={info.solved} "
            f"outer={info.stats.outer_iterations} inner={info.stats.inner_iterations} "
            f"wall={wall:.3f} s true |F|={fu:.4e} (limit {tol_rel * f0 + 1e-12:.4e}); "
            f"v'(0)={float(U[1]):.2e} v(20)={float(U[-2]):.2e}; host copies "
            f"{tp.HOST_COPIES['device_to_host']} to the host, "
            f"{tp.HOST_COPIES['host_to_device']} back")
        if not (info.solved and fu <= tol_rel * f0 + 1e-12
                and bool(torch.isfinite(U).all()) and tuple(U.shape) == (2 * p.n,)):
            raise AssertionError(f"bvp {tag}: not solved, or the f64 residual "
                                 "is above the tolerance")


def phase_ptc(torch, nkt, bratu2d):
    """Path (i): Ψtc near the fold at 2048² (``tests/test_continuation.py``'s
    near-fold case at full width): λ = 6.8 from u = 2.5·sin(πx)sin(πy), on
    −F with the df32 acceptance residual of −F, f32 Krylov GMRES,
    ``tol_rel=1e-8``, δ₀ = (n + 1)², ``max_steps=60``, full GMRES up to
    ``PTC_ITMAX``; once with ``chebyshev(16, lo_frac=1/300)`` (the Cheb-PCG
    lane's interval; engine "auto": one K4 launch per apply, on the probed
    shifted diagonal) and once with ``fft_poisson(precision="high")``.  Both
    gated on ``solved`` and the f64 true residual; their roots must agree
    within 1e-6.  Then Newton with Armijo backtracking from the same start
    (f64 state, f32 Krylov, the DST preconditioner), logged beside them.
    Returns the K4 launches and the Chebyshev applies of the first solve."""
    import math

    from newtonkrylov_tpu_torch import df32
    from newtonkrylov_tpu_torch.fftprec import fft_poisson
    from newtonkrylov_tpu_torch.kernels import stencil2d as k
    from newtonkrylov_tpu_torch.precond import chebyshev

    n, f64 = N, torch.float64
    p = bratu2d.default_config(n, lam=PTC_LAM)
    X, Y = bratu2d.grid(n, f64, "cuda")
    u0 = 2.5 * torch.sin(math.pi * X) * torch.sin(math.pi * Y)
    f0 = float(torch.linalg.vector_norm(bratu2d.residual_scaled(u0, p)))

    def neg(u, q):
        return -bratu2d.residual_scaled(u, q)

    def neg_df(u, q):
        r = bratu2d.residual_scaled_df(u, q)
        return df32.DF(-r.hi, -r.lo)

    applies = [0]
    cheb = chebyshev(16, lo_frac=1 / 300)

    def counted_cheb(A):
        M = cheb(A)

        def apply(r):
            applies[0] += 1
            return M(r)

        return apply

    roots = {}
    k4 = 0
    for tag, M in (("Cheb(16)", counted_cheb), ("DST(high)", fft_poisson(precision="high"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, info = nkt.pseudo_transient(
            neg, u0, p, algo="gmres", tol_rel=1e-8, M=M,
            delta0=float((n + 1) ** 2), max_steps=60,
            krylov_kwargs={"restart": None, "itmax": PTC_ITMAX},
            krylov_dtype=torch.float32, residual_df=neg_df)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if tag == "Cheb(16)":  # the caller zeroed the counts before this phase
            k4 = k.LAUNCHES["chebyshev_apply"]
        fu = float(torch.linalg.vector_norm(bratu2d.residual_scaled(u, p)))
        roots[tag] = u
        log(f"[ptc] n={n} lambda={PTC_LAM} rough start, {tag}, f32 Krylov + "
            f"df32: solved={bool(info.solved)} steps={info.stats.outer_iterations} "
            f"inner={info.stats.inner_iterations} "
            f"floor_limited={bool(info.floor_limited)} wall={wall:.3f} s true "
            f"|F|={fu:.4e} (limit {1e-8 * f0 + 1e-12:.4e})"
            + (f"; K4 {k4} launches, {applies[0]} preconditioner applies"
               if tag == "Cheb(16)" else ""))
        if not (bool(info.solved) and fu <= 1e-8 * f0 + 1e-12
                and bool(torch.isfinite(u).all()) and tuple(u.shape) == (n, n)):
            raise AssertionError(f"ptc {tag}: not solved, or the f64 true "
                                 "residual is above 1e-8·‖F₀‖")
    diff = float((roots["Cheb(16)"] - roots["DST(high)"]).abs().max())
    log(f"[ptc] n={n}: max|u_cheb - u_dst| {diff:.3e} (limit 1e-6)")
    if not diff <= 1e-6:
        raise AssertionError("ptc: the Chebyshev and DST roots differ")
    if not k4 == applies[0] > 0:
        raise AssertionError("ptc: K4 launches differ from the Chebyshev "
                             "preconditioner applies")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, info = nkt.newton_krylov_jit(
        bratu2d.residual_scaled, u0, p, algo="gmres", tol_rel=1e-8,
        linesearch="armijo", krylov_dtype=torch.float32,
        M=fft_poisson(precision="high"), max_niter=30)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fu = float(torch.linalg.vector_norm(bratu2d.residual_scaled(u, p)))
    dist = float((u - roots["DST(high)"]).abs().max())
    log(f"[ptc] n={n} Newton + Armijo from the same start (f64 state, f32 "
        f"Krylov, DST(high)): solved={bool(info.solved)} "
        f"outer={info.stats.outer_iterations} inner={info.stats.inner_iterations} "
        f"wall={wall:.3f} s true |F|={fu:.4e}; max|u - u_ptc| {dist:.3e}")
    if not bool(torch.isfinite(u).all()):
        raise AssertionError("ptc: Newton + Armijo returned a non-finite iterate")
    return k4, applies[0]


def phase_nldiff(torch, nkt):
    """Path (j): quasilinear diffusion at 256² (``tests/test_nldiff.py``'s
    MG-general recipe at the size of the c = 25 lanes) through
    ``newton_krylov_jit``: GMRES + ``multigrid2d_general()`` (PCR line
    solves on the card), ``forcing=None``, f32 Krylov + the df32 residual to
    1e-8; gated on ``solved`` and max|u − u*| ≤ 1e-6."""
    from newtonkrylov_tpu_torch.mg import multigrid2d_general
    from newtonkrylov_tpu_torch.problems import nldiff2d

    n, f64 = NLDIFF_N, torch.float64
    p = nldiff2d.default_config(n, device="cuda")
    u0 = nldiff2d.initial_guess(n, f64, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, info = nkt.newton_krylov_jit(
        nldiff2d.residual_scaled, u0, p, algo="gmres", M=multigrid2d_general(),
        forcing=None, max_niter=15, tol_rel=1e-8, krylov_dtype=torch.float32,
        residual_df=nldiff2d.residual_scaled_df,
        krylov_kwargs={"restart": None, "itmax": 300})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = float((u - nldiff2d.manufactured_solution(n, device="cuda")).abs().max())
    fu = float(torch.linalg.vector_norm(nldiff2d.residual_scaled(u, p)))
    f0 = float(torch.linalg.vector_norm(nldiff2d.residual_scaled(u0, p)))
    log(f"[nldiff2d] n={n} GMRES + MG-general, f32 Krylov + df32: "
        f"solved={bool(info.solved)} outer={info.stats.outer_iterations} "
        f"inner={info.stats.inner_iterations} "
        f"floor_limited={bool(info.floor_limited)} wall={wall:.3f} s true "
        f"|F|={fu:.4e} (limit {1e-8 * f0 + 1e-12:.4e}) max|u - u*| {err:.3e} "
        f"(limit 1e-6)")
    if not (bool(info.solved) and err <= 1e-6 and tuple(u.shape) == (n, n)):
        raise AssertionError("nldiff2d: not solved, or max|u - u*| above 1e-6")


def phase_convdiff_ilu(torch, nkt):
    """Path (k): convection–diffusion at c = 25, 64², f64, through
    ``newton_krylov`` with GMRES + ``ilu0(offsets=(-n, -1, 0, 1, n))``
    (``tests/test_convdiff.py:83-100``), on the card and on the CPU: both
    solved, the same outer count, solutions within 1e-9."""
    from newtonkrylov_tpu_torch import precond as tp
    from newtonkrylov_tpu_torch.problems import convdiff2d

    n, f64 = 64, torch.float64
    runs = {}
    for dev in ("cuda", "cpu"):
        p = convdiff2d.default_config(n, c=CONV_C, dtype=f64, device=dev)
        runs[dev] = nkt.newton_krylov(
            convdiff2d.residual_scaled, convdiff2d.initial_guess(n, f64, dev), p,
            algo="gmres", tol_rel=1e-10, forcing=None,
            N=tp.ilu0(offsets=(-n, -1, 0, 1, n)),
            krylov_kwargs={"restart": None, "itmax": 200})
    (ug, ig), (uc, ic) = runs["cuda"], runs["cpu"]
    diff = float((ug.cpu() - uc).abs().max())
    err = float((uc - convdiff2d.manufactured_solution(n, f64, "cpu")).abs().max())
    log(f"[convdiff c=25 ilu0 64] cuda outer/inner {ig.stats.outer_iterations}/"
        f"{ig.stats.inner_iterations}  cpu {ic.stats.outer_iterations}/"
        f"{ic.stats.inner_iterations}  max|u_cuda - u_cpu| {diff:.3e}  "
        f"max|u - u*| {err:.3e}")
    if not (ig.solved and ic.solved
            and ig.stats.outer_iterations == ic.stats.outer_iterations
            and diff <= 1e-9):
        raise AssertionError("convdiff c=25 + ILU0 64² on the card disagrees "
                             "with the CPU")


def _heat_setup(torch, n, device="cuda"):
    """The heat march of paths (l)–(n) at n²: (params, o, u₀, g) with
    o = Δt·a/Δx² and g the exact backward-Euler factor of the eigenvector
    u₀ = sin(πx)sin(πy) of the discrete Dirichlet Laplacian, in f64."""
    import math

    from newtonkrylov_tpu_torch.problems import heat2d

    p = heat2d.default_config(n, a=HEAT_A)
    o = HEAT_DT * p.a / (p.dx * p.dx)
    u0 = heat2d.initial_condition(n, torch.float64, device)
    g = 1.0 / (1.0 + HEAT_DT * p.a * (8.0 / (p.dx * p.dx))
               * math.sin(math.pi * p.dx / 2.0) ** 2)
    return p, o, u0, g


def _heat_kwargs(M):
    """The flagship's precision mode on the heat step: f32 Krylov CG on the
    f64 state, the df32 acceptance residual, ``tol_rel=1e-8``,
    ``tol_abs=0``, ``M`` built once a step."""
    import torch

    from newtonkrylov_tpu_torch.problems import heat2d
    from newtonkrylov_tpu_torch.timestep import implicit_euler_df

    return dict(algo="cg", M=M, precond_refresh="once",
                krylov_dtype=torch.float32,
                residual_df=implicit_euler_df(heat2d.rhs_df),
                tol_rel=1e-8, tol_abs=0.0)


def _gate_decay(torch, tag, u, u0, g, steps):
    """max|u − g^steps·u₀| ≤ 1e-6·max|u₀|; returns the error."""
    err = float((u - g ** steps * u0).abs().max())
    limit = 1e-6 * float(u0.abs().max())
    log(f"[{tag}] max|u_{steps} - g^{steps} u0| {err:.4e} (limit {limit:.4e}; "
        f"g = {g:.9f}, g^{steps} = {g ** steps:.9f})")
    if not (err <= limit and bool(torch.isfinite(u).all())):
        raise AssertionError(f"{tag}: the state is not g^{steps}·u0")
    return err


def phase_heat_cheb(torch, nkt):
    """Path (l): the 2-D heat equation at 2048², a = 0.01, u₀ =
    sin(πx)sin(πy), 6 backward-Euler steps of Δt = 0.05 (8,400× the
    explicit limit) through ``integrate`` with Cheb-PCG:
    ``chebyshev(16, bounds=(−1 − 8o, −1))``, the probed Gershgorin box of
    J = −I + o·S, built once a step (one K4 launch per apply on the card).
    Gates: no failed step, every step's f64 residual ‖G(uₙ₊₁)‖ ≤
    1.2e-8·‖G(uₙ)‖, the final state g⁶·u₀ within 1e-6·max|u₀|.  Logs the
    per-step counts, the wall, whether the df32 floor clamp engaged, and
    one step's device busy share.  Returns (the final state, the Chebyshev
    applies, K4's included in the profiled step)."""
    from newtonkrylov_tpu_torch import df32
    from newtonkrylov_tpu_torch.precond import chebyshev
    from newtonkrylov_tpu_torch.problems import heat2d
    from newtonkrylov_tpu_torch.timestep import StepParams, implicit_euler

    n = HEAT_N
    p, o, u0, g = _heat_setup(torch, n)
    applies = [0]
    cheb = chebyshev(16, bounds=(-1.0 - 8.0 * o, -1.0))

    def counted_cheb(A):
        M = cheb(A)

        def apply(r):
            applies[0] += 1
            return M(r)

        return apply

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = nkt.integrate("euler", heat2d.rhs, u0, p, HEAT_DT, HEAT_DT * HEAT_STEPS,
                      save_history=True, newton_kwargs=_heat_kwargs(counted_cheb))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outers, inners = r.outer_iterations.tolist(), r.inner_iterations.tolist()
    log(f"[heat cheb] n={n} a={HEAT_A} dt={HEAT_DT} (o = {o:.1f}, spectrum "
        f"[{-1 - 8 * o:.1f}, -1]) {HEAT_STEPS} steps, Cheb(16)-PCG, f32 Krylov "
        f"+ df32: n_failed={r.n_failed} outer {sum(outers)} inner {sum(inners)} "
        f"wall={wall:.3f} s ({wall / HEAT_STEPS:.3f} s a step); "
        f"{applies[0]} Chebyshev applies")
    log(f"[heat cheb] per-step outer {outers}")
    log(f"[heat cheb] per-step inner {inners}")
    if r.n_failed != 0:
        raise AssertionError("heat cheb: a step's solve failed")
    G = implicit_euler(heat2d.rhs)
    worst, clamped = 0.0, 0
    for k in range(HEAT_STEPS):
        un, u1 = r.history[k], r.history[k + 1]
        sp = StepParams(un=un, dt=HEAT_DT, p=p, t=(k + 1) * HEAT_DT)
        ratio = float(torch.linalg.vector_norm(G(u1, sp))
                      / torch.linalg.vector_norm(G(un, sp)))
        worst = max(worst, ratio)
        # the driver's df32 floor clamp: floor_rtol (2) × the measured floor
        # above tol_rel·‖G(uₙ)‖
        sp32 = sp._replace(un=un.float())
        floor = float(df32.floor_estimate(G, un.float(), sp32))
        clamped += 2.0 * floor > 1e-8 * float(torch.linalg.vector_norm(G(un, sp)))
        if not ratio <= 1.2e-8:
            raise AssertionError(f"heat cheb: step {k + 1}'s f64 residual is "
                                 f"{ratio:.3e} of ‖G(uₙ)‖, above 1.2e-8")
    log(f"[heat cheb] worst step f64 residual ‖G(u_k+1)‖/‖G(u_k)‖ "
        f"{worst:.4e} (limit 1.2e-8); floor_limited in {clamped} of "
        f"{HEAT_STEPS} steps")
    _gate_decay(torch, "heat cheb", r.u, u0, g, HEAT_STEPS)
    # the first step again under the profiler, against the march's mean
    # unprofiled step wall (every step takes the same counts)
    sp = StepParams(un=u0, dt=HEAT_DT, p=p, t=HEAT_DT)
    counts = {}
    _, busy_us = _profile(lambda: nkt.newton_krylov_jit(
        G, u0, sp, **_heat_kwargs(counted_cheb)), counts)
    step_wall = wall / HEAT_STEPS
    log(f"[heat cheb] one step under the profiler: device busy "
        f"{busy_us / 1e6:.4f} s = {100 * busy_us / 1e6 / step_wall:.1f}% of the "
        f"march's mean step wall {step_wall:.3f} s; {sum(counts.values())} "
        f"device events")
    return r.u, applies[0]


def phase_heat_dst_scan(torch, nkt, u_cheb):
    """Path (m): the march of (l) through ``integrate_scan`` with DST-PCG
    (``fft_poisson()``, exact for this constant-coefficient J), saving every
    5th step.  Gates: no failed step, the history's shape and times, the
    final state within 1e-7·max|u₀| of (l)'s and g⁶·u₀ within
    1e-6·max|u₀|."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson
    from newtonkrylov_tpu_torch.problems import heat2d

    n = HEAT_N
    p, _, u0, g = _heat_setup(torch, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = nkt.integrate_scan("euler", heat2d.rhs, u0, p, HEAT_DT, HEAT_STEPS,
                           save_every=5, newton_kwargs=_heat_kwargs(fft_poisson()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outers, inners = r.outer_iterations.tolist(), r.inner_iterations.tolist()
    ts = r.ts.tolist()
    diff = float((r.u - u_cheb).abs().max())
    limit = 1e-7 * float(u0.abs().max())
    log(f"[heat dst scan] n={n} {HEAT_STEPS} steps through integrate_scan, "
        f"DST-PCG: n_failed={int(r.n_failed)} outer {sum(outers)} inner "
        f"{sum(inners)} wall={wall:.3f} s; history {tuple(r.history.shape)} "
        f"ts {ts}; max|u - u_cheb| {diff:.4e} (limit {limit:.4e})")
    log(f"[heat dst scan] per-step outer {outers}")
    log(f"[heat dst scan] per-step inner {inners}")
    if int(r.n_failed) != 0:
        raise AssertionError("heat dst scan: a step's solve failed")
    if tuple(r.history.shape) != (HEAT_STEPS // 5, n, n):
        raise AssertionError("heat dst scan: history has the wrong shape")
    want_ts = [HEAT_DT * k for k in range(5, HEAT_STEPS + 1, 5)]
    if not (len(ts) == len(want_ts)
            and all(abs(a - b) <= 1e-12 for a, b in zip(ts, want_ts))):
        raise AssertionError("heat dst scan: wrong ts")
    if not diff <= limit:
        raise AssertionError("heat dst scan: the final state differs from "
                             "the Cheb-PCG march's")
    _gate_decay(torch, "heat dst scan", r.u, u0, g, HEAT_STEPS)
    return outers, inners


def phase_heat_drivers(torch, nkt):
    """Path (n) at 256², DST-PCG: a 10-step ``integrate`` march with
    ``checkpoint_every=5`` into a temporary directory is the uninterrupted
    reference; ``integrate_scan`` over 5 steps equals its ``march_5``
    snapshot bit for bit; with ``march_10`` removed, the march resumed from
    ``march_5`` runs only the remaining 5 steps and ends on the reference's
    state bit for bit (15 and 10 steps before PR 9's trims)."""
    import tempfile

    from newtonkrylov_tpu_torch.fftprec import fft_poisson
    from newtonkrylov_tpu_torch.problems import heat2d
    from newtonkrylov_tpu_torch.utils.checkpointing import load_checkpoint

    n, steps, k = HEAT_SMALL_N, 10, 5
    p, _, u0, _ = _heat_setup(torch, n)
    kw = _heat_kwargs(fft_poisson())
    with tempfile.TemporaryDirectory() as d:
        full = nkt.integrate("euler", heat2d.rhs, u0, p, HEAT_DT, HEAT_DT * steps,
                             newton_kwargs=kw, checkpoint_dir=d,
                             checkpoint_every=5)
        written = sorted(os.listdir(d))
        scan = nkt.integrate_scan("euler", heat2d.rhs, u0, p, HEAT_DT, k,
                                  newton_kwargs=kw)
        at_k = load_checkpoint(os.path.join(d, f"march_{k}.npz"), u0)
        same = _bitwise_equal(torch, at_k.u, scan.u)
        os.remove(os.path.join(d, f"march_{steps}.npz"))
        resumed = nkt.integrate("euler", heat2d.rhs, u0, p, HEAT_DT, HEAT_DT * steps,
                                newton_kwargs=kw, checkpoint_dir=d, resume=True)
    resumed_same = _bitwise_equal(torch, full.u, resumed.u)
    log(f"[heat drivers] n={n}: checkpoints {written} (t at march_{k}: "
        f"{at_k.t}, step {at_k.step}); integrate_scan over {k} steps vs "
        f"integrate's march_{k} bitwise {same}; resumed from march_{k}: "
        f"{len(resumed.outer_iterations)} steps, final state bitwise {resumed_same}")
    if written != sorted(f"march_{j}.npz" for j in range(k, steps + 1, k)):
        raise AssertionError("heat drivers: unexpected checkpoint files")
    if not (same and at_k.step == k):
        raise AssertionError("heat drivers: integrate and integrate_scan differ")
    if not (resumed_same and len(resumed.outer_iterations) == steps - k):
        raise AssertionError("heat drivers: the resumed march differs from the "
                             "uninterrupted one")


def phase_small_problems(torch, nkt):
    """Path (o): the reference's small problems on the card against the
    same marches on the CPU, f64: the spring with all three steppers
    (Δt = 0.01, ``SPRING_STEPS`` steps), heat1d (m = 100, Δt = 0.1 to
    t = ``HEAT1D_T``), one heat1d_dg step refined to 1e-8 (``dg_config()``, full
    GMRES, ``itmax=200``, df32 residual) also against an f64 oracle step on
    the card, and the upwind march (Δt = 0.01, ``UPWIND_STEPS`` steps).
    Gates: no failed step; the spring and the DG step in equal per-step
    counts with states within 1e-12, the DG step within 1e-7 of the
    oracle.  heat1d
    and the upwind march run GMRES(100) to ~100 inners a step, where the
    devices' dot products, summed in another order, move the counts (as
    between the JAX package and the port on the CPU, ROADMAP.md Queue 3
    item 18): their states are held to the marches' accumulated acceptance
    tolerance, steps × tol_abs (‖J⁻¹‖ ≤ 1 for these step Jacobians)."""
    from newtonkrylov_tpu_torch.problems import heat1d, heat1d_dg, spring
    from newtonkrylov_tpu_torch.timestep import (StepParams, implicit_euler,
                                                 implicit_euler_df)

    def march(dev, stepper, f, p_of, u0_of, dt, t_final):
        p = p_of(dev)
        r = nkt.integrate(stepper, f, u0_of(p, dev), p, dt, t_final)
        return r.u, r.outer_iterations.tolist(), r.inner_iterations.tolist(), r.n_failed

    def dg_step(dev, tol_rel, residual_df):
        p = heat1d_dg.dg_config(device=dev)
        u0 = heat1d_dg.initial_condition(p)
        sp = StepParams(un=u0, dt=1e-4, p=p, t=1e-4)
        kw = dict(algo="gmres", tol_rel=tol_rel, max_niter=10,
                  krylov_kwargs={"restart": None, "itmax": 200})
        if residual_df:
            kw["residual_df"] = implicit_euler_df(heat1d_dg.rhs_df)
        u, info = nkt.newton_krylov_jit(implicit_euler(heat1d_dg.rhs), u0, sp, **kw)
        if not bool(info.solved):
            raise AssertionError(f"small problems: the DG step on {dev} failed")
        return u, [info.stats.outer_iterations], [info.stats.inner_iterations], 0

    spring_t = 0.01 * SPRING_STEPS
    # (tag, counts must be equal, run); a march's default tol_abs is 6e-6
    cases = [(f"spring {s}, dt=0.01 to t={spring_t:g}", True,
              lambda dev, s=s: march(dev, s, spring.rhs,
                                     lambda dev: spring.default_config(),
                                     lambda p, dev: spring.initial_condition(device=dev),
                                     0.01, spring_t))
             for s in ("euler", "midpoint", "trapezoid")]
    cases += [
        (f"heat1d m=100, dt=0.1 to t={HEAT1D_T:g}", False,
         lambda dev: march(dev, "euler", heat1d.rhs,
                           lambda dev: heat1d.default_config(100),
                           lambda p, dev: heat1d.clamp_bc(heat1d.initial_condition(
                               heat1d.grid(100, device=dev)), p),
                           0.1, HEAT1D_T)),
        ("heat1d_dg step refined to 1e-8", True,
         lambda dev: dg_step(dev, 1e-8, True)),
        (f"upwind march, dt=0.01 to t={0.01 * UPWIND_STEPS:g}", False,
         lambda dev: march(dev, "euler", heat1d_dg.rhs,
                           lambda dev: heat1d_dg.upwind_config(device=dev),
                           lambda p, dev: heat1d_dg.initial_condition(p),
                           0.01, 0.01 * UPWIND_STEPS)),
    ]
    for tag, exact, run in cases:
        t0 = time.perf_counter()
        uc, oc, ic, fc = run("cpu")
        t1 = time.perf_counter()
        ug, og, ig, fg = run("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        diff = float((ug.cpu() - uc).abs().max())
        limit = 1e-12 if exact else len(og) * 6e-6
        log(f"[small] {tag}: card outer {sum(og)} inner {sum(ig)} failed {fg} "
            f"({t2 - t1:.3f} s); CPU outer {sum(oc)} inner {sum(ic)} failed {fc} "
            f"({t1 - t0:.3f} s); max|u_card - u_cpu| {diff:.3e} (limit {limit:.1e})")
        if (og, ig) != (oc, ic):
            log(f"[small] {tag}: per-step outer card {og} CPU {oc}; inner "
                f"card {ig} CPU {ic}")
            if exact:
                raise AssertionError(f"small problems {tag}: the counts differ")
        if not (diff <= limit and fg == fc == 0):
            raise AssertionError(f"small problems {tag}: states differ or a "
                                 "step failed")
    u_df, *_ = dg_step("cuda", 1e-8, True)
    u_ref, *_ = dg_step("cuda", 1e-10, False)
    err = float((u_df - u_ref).abs().max())
    log(f"[small] heat1d_dg step refined to 1e-8 against the f64 oracle step "
        f"(tol_rel 1e-10) on the card: max diff {err:.3e} (limit 1e-7)")
    if not err <= 1e-7:
        raise AssertionError("small problems: the refined DG step misses the oracle")


def phase_implicit_grad(torch, nkt, bratu2d):
    """Path (p): the differentiable solve.  d(Σu*)/dλ of the 2-D Bratu root
    at 512², f64, λ = 5 (a 0-d tensor), forward ``newton_krylov_jit`` CG +
    DST (``tol_rel=1e-12``), adjoint CG preconditioned by the DST apply
    built once at u₀, against central differences (ε = 1e-6·λ), rtol
    1e-5."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    n, f64 = GRAD_N, torch.float64
    dx = 1.0 / (n + 1)

    def F(u, lam):
        return bratu2d.residual_scaled(u, bratu2d.Params(dx=dx, lam=lam))

    u0 = bratu2d.initial_guess(n, f64, "cuda")
    lam0 = torch.tensor(GRAD_LAM, dtype=f64, device="cuda")
    M0 = fft_poisson()(nkt.JacobianOperator(F, u0, lam0))
    applies = [0]

    def M_adj(r):
        applies[0] += 1
        return M0(r)

    solve = nkt.make_implicit_solver(
        F, algo="cg", M=fft_poisson(), tol_rel=1e-12, adjoint_algo="cg",
        adjoint_kwargs={"M": M_adj})
    lam = lam0.clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = solve(u0, lam)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (grad,) = torch.autograd.grad(u.sum(), lam)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    eps = 1e-6 * GRAD_LAM
    with torch.no_grad():
        up = solve(u0, lam0 + eps).sum()
        um = solve(u0, lam0 - eps).sum()
    fd = float(up - um) / (2 * eps)
    rel = abs(float(grad) - fd) / abs(fd)
    log(f"[implicit grad] n={n} lambda={GRAD_LAM} f64: d(sum u*)/dlambda "
        f"{float(grad):.10e} adjoint vs central differences {fd:.10e}: rel "
        f"{rel:.3e} (limit 1e-5); forward {t1 - t0:.3f} s, backward "
        f"{t2 - t1:.3f} s, adjoint CG {applies[0] - 1} inner iterations "
        f"({applies[0]} DST applies)")
    if not (rel <= 1e-5 and bool(torch.isfinite(u).all())):
        raise AssertionError("implicit grad: the adjoint gradient disagrees "
                             "with central differences")


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


def phase_native_f64_flagship(torch, nkt, bratu2d):
    """The flagship at 2048² with its acceptance residual in native f64
    (``krylov_dtype=float32`` on an f64 state, no ``residual_df``) beside
    the df32 flagship, on one card in turns (native, df32, native, df32):
    counts, walls, ``floor_limited`` and the f64 true residual.  Each solve
    is gated on ``solved`` and its true residual (``_df32_solve``'s gate for
    the df32 one)."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    p = bratu2d.default_config(N, lam=LAM)
    u0 = bratu2d.initial_guess(N, dtype=torch.float32, device="cuda").to(torch.float64)
    for turn in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, info = nkt.newton_krylov_jit(
            bratu2d.residual_scaled, u0, p, algo="cg", tol_rel=1e-8,
            krylov_dtype=torch.float32, max_niter=20,
            M=fft_poisson(precision="high"), precond_refresh="once")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fu, f0 = _true_residual(torch, bratu2d, u, u0, p)
        log(f"[flagship native f64 residual] n={N} f32 Krylov, f64 state and "
            f"residual, turn {turn}: solved={bool(info.solved)} "
            f"outer={info.stats.outer_iterations} inner={info.stats.inner_iterations} "
            f"floor_limited={bool(info.floor_limited)} wall={wall:.3f} s true "
            f"|F|={fu:.4e} (limit {1e-8 * f0 + 1e-12:.4e})")
        if not (bool(info.solved) and fu <= 1e-8 * f0 + 1e-12):
            raise AssertionError("flagship with a native f64 residual: not "
                                 "solved, or true residual above 1e-8·‖F₀‖")
        phase_flagship(torch, nkt, bratu2d, f"df32 turn {turn}")


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


def _sharded_gate(torch, bratu2d, tag, u, u0, info, wall, coll, p):
    """Log a sharded Bratu solve (counts, wall, collectives, f64 true
    residual) and gate it on ``solved`` and the residual; returns ‖F(u)‖."""
    fu, f0 = _true_residual(torch, bratu2d, u, u0, p)
    log(f"[sharded {tag}] n={N} solved={bool(info.solved)} "
        f"outer={info.stats.outer_iterations} inner={info.stats.inner_iterations} "
        f"wall={wall:.3f} s  true |F|={fu:.4e} (limit {1e-8 * f0 + 1e-12:.4e}); "
        f"collectives {coll}")
    if not (bool(info.solved) and torch.isfinite(u).all()
            and tuple(u.shape) == (N, N)):
        raise AssertionError(f"sharded {tag}: the solve did not converge")
    if not fu <= 1e-8 * f0 + 1e-12:
        raise AssertionError(f"sharded {tag}: f64 true residual above 1e-8·‖F₀‖")
    return fu


def phase_sharded(torch, nkt, bratu2d, smi, info_f, u_f, info_c, heat_counts):
    """Path (q): the sharded solvers on a world-1 NCCL group and a 1×1 mesh
    (one card: each reduction a real NCCL all-reduce, each global-DST
    product a real reduce-scatter, the ghost exchange with no neighbour).
    (q1) the flagship through ``newton_krylov_sharded`` — the unsharded
    flagship's counts, and max|u_sharded − u_flagship| logged with its
    cause when it is not 0; (q2) Ψtc (``driver=pseudo_transient``,
    residuals sign-flipped, δ₀ = (n+1)²); (q3) Cheb-PCG with the sharded
    Chebyshev (no K4), its counts beside (cheb-pcg)'s; (q4)
    ``integrate_scan_sharded``: (m)'s march for ``SHARDED_HEAT_STEPS``
    steps with the global DST — (m)'s per-step counts and the decay
    g^steps.  Every solve gated on ``solved`` and its f64 residual."""
    import shutil
    import tempfile

    from newtonkrylov_tpu_torch import df32, halo
    from newtonkrylov_tpu_torch.fftprec import fft_poisson
    from newtonkrylov_tpu_torch.precond import chebyshev
    from newtonkrylov_tpu_torch.problems import heat2d
    from newtonkrylov_tpu_torch.timestep import implicit_euler_df
    from newtonkrylov_tpu_torch.utils import distributed as D
    from newtonkrylov_tpu_torch.utils.dryrun import bratu_padded

    log(f"[sharded] {smi}")
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        if not D.initialize("file://" + os.path.join(store, "store"), 1, 0,
                            device="cuda"):
            raise AssertionError("sharded: no process group")
        backend = torch.distributed.get_backend()
        mesh = halo.make_mesh((1, 1), ("i", "j"), device_type="cuda")
        log(f"[sharded] {D.host_summary()}; mesh {tuple(mesh.shape)} "
            f"{mesh.mesh_dim_names}")
        if backend != "nccl":
            raise AssertionError(f"sharded: backend {backend}, not nccl")
        axes, spec = ("i", "j"), halo.P("i", "j")
        p = bratu2d.default_config(N, lam=LAM)
        u0 = bratu2d.initial_guess(N, dtype=torch.float32, device="cuda").to(
            torch.float64)
        F = halo.sharded_residual_2d(bratu_padded, axes, "dirichlet")
        F_df = halo.sharded_residual_df_2d(bratu2d.residual_scaled_df_padded,
                                           axes, "dirichlet")
        dst = fft_poisson(axis_names=axes, scope="global", precision="high")
        kw = dict(algo="cg", tol_rel=1e-8, krylov_dtype=torch.float32,
                  max_niter=20)

        def solve(tag, F_, kwargs, driver=None):
            D.reset_collective_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u, info = halo.newton_krylov_sharded(F_, u0, p, mesh, spec,
                                                 newton_kwargs=kwargs,
                                                 driver=driver)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            coll = dict(D.COLLECTIVES)
            _sharded_gate(torch, bratu2d, tag, u, u0, info, wall, coll, p)
            return u, info, coll

        # (q1) the flagship
        u, info, coll = solve("flagship", F, dict(
            kw, M=dst, precond_refresh="once", residual_df=F_df))
        counts = (info.stats.outer_iterations, info.stats.inner_iterations)
        ref = (info_f.stats.outer_iterations, info_f.stats.inner_iterations)
        diff = float((u - u_f).abs().max())
        log(f"[sharded flagship] outer/inner {counts[0]}/{counts[1]} beside the "
            f"unsharded flagship's {ref[0]}/{ref[1]}; max|u_sharded - "
            f"u_flagship| {diff:.3e}; per solve {coll['all_reduce']} NCCL "
            f"all-reduces, {coll['reduce_scatter']} reduce-scatters "
            f"(4 a DST apply), {coll['exchange']} exchanges, {coll['p2p']} "
            "point-to-point messages")
        if diff != 0.0:
            # where the arithmetic parts: the padded residual (plain
            # block + re-evaluated strips) against residual_scaled's
            x = u_f.float()
            r_pad, r_ref = F(x, p), bratu2d.residual_scaled(x, p)
            dx = df32.df_from_f64(u_f)
            d_pad, d_ref = F_df(dx, p), bratu2d.residual_scaled_df(dx, p)
            log(f"[sharded flagship] the states differ: at u_flagship the f32 "
                f"residuals differ by {float((r_pad - r_ref).abs().max()):.3e}, "
                f"the df32 hi words by "
                f"{float((d_pad.hi - d_ref.hi).abs().max()):.3e}")
        if counts != ref:
            raise AssertionError("sharded flagship: counts differ from the "
                                 "unsharded flagship's")
        # where its extra wall goes: one linearization of the overlapped
        # exchanged residual against one of residual_scaled, at u_flagship
        from newtonkrylov_tpu_torch.operator import JacobianOperator

        x = u_f.float()
        lin_sh = _wall_s(torch, lambda: JacobianOperator(F, x, p))
        lin_1 = _wall_s(torch, lambda: JacobianOperator(bratu2d.residual_scaled, x, p))
        log(f"[sharded flagship] one linearization: overlapped exchanged "
            f"residual {lin_sh * 1e3:.1f} ms, residual_scaled {lin_1 * 1e3:.1f} ms "
            f"(host wall, device drained)")

        # (q2) Ψtc through the same seam, residuals sign-flipped
        def F_ptc(ul, pp):
            return -F(ul, pp)

        def F_ptc_df(ud, pp):
            return df32.neg(F_df(ud, pp))

        _, info2, _ = solve("ptc", F_ptc, dict(
            algo="cg", tol_rel=1e-8, krylov_dtype=torch.float32,
            max_steps=25, delta0=float((N + 1) ** 2), M=dst,
            residual_df=F_ptc_df), driver=nkt.pseudo_transient)

        # (q3) Cheb-PCG with the sharded Chebyshev: no K4
        from newtonkrylov_tpu_torch.kernels import stencil2d as k

        k4 = k.LAUNCHES["chebyshev_apply"]
        _, info3, _ = solve("cheb-pcg", F, dict(
            kw, M=chebyshev(16, lo_frac=1 / 300, axis_names=axes),
            precond_refresh="once", residual_df=F_df))
        log(f"[sharded cheb-pcg] outer/inner {info3.stats.outer_iterations}/"
            f"{info3.stats.inner_iterations} beside (cheb-pcg)'s K4 solve "
            f"{info_c.stats.outer_iterations}/{info_c.stats.inner_iterations}; "
            f"K4 launches {k.LAUNCHES['chebyshev_apply'] - k4}")
        if k.LAUNCHES["chebyshev_apply"] != k4:
            raise AssertionError("sharded cheb-pcg launched K4")

        # (q4) integrate_scan_sharded: (m)'s march, cut to SHARDED_HEAT_STEPS
        hp, _, hu0, g = _heat_setup(torch, HEAT_N)

        def f_local(u_, pp, t=None):
            from newtonkrylov_tpu_torch.ops.stencil import laplacian_2d

            return pp.a * laplacian_2d(halo.exchange_2d(u_, axes), pp.dx, pp.dy)

        def f_df_local(u_, pp, t=None):
            up = df32.DF(halo.exchange_2d(u_.hi, axes),
                         halo.exchange_2d(u_.lo, axes))
            return heat2d.rhs_df_padded(up, u_, pp, t)

        hkw = _heat_kwargs(fft_poisson(axis_names=axes, scope="global"))
        hkw["residual_df"] = implicit_euler_df(f_df_local)
        steps = SHARDED_HEAT_STEPS
        D.reset_collective_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = halo.integrate_scan_sharded("euler", f_local, hu0, hp, HEAT_DT,
                                        steps, mesh, spec, newton_kwargs=hkw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        outers, inners = r.outer_iterations.tolist(), r.inner_iterations.tolist()
        want = (heat_counts[0][:steps], heat_counts[1][:steps])
        log(f"[sharded heat scan] n={HEAT_N} {steps} steps, global DST: "
            f"n_failed={int(r.n_failed)} per-step outer {outers} inner {inners} "
            f"(integrate_scan's first {steps}: {want[0]} / {want[1]}) "
            f"wall={wall:.3f} s; collectives {dict(D.COLLECTIVES)}")
        if int(r.n_failed) != 0 or (outers, inners) != want:
            raise AssertionError("sharded heat scan: a step failed or the "
                                 "counts differ from integrate_scan's")
        _gate_decay(torch, "sharded heat scan", r.u, hu0, g, steps)
        phase_transpose(torch, bratu2d, mesh, u_f)  # (q5)
        phase_scaling(torch)  # (r4)
        return info, info2, info3
    finally:
        D.shutdown()
        shutil.rmtree(store, ignore_errors=True)


def phase_transpose(torch, bratu2d, mesh, u_f):
    """(q5) The ghost exchange's transpose on the world-1 group at 2048²
    f64: Jᵀw of the exchanged residual against the unsharded
    ``residual_scaled``'s, bit for bit in the plain exchange form
    (``overlap=False``: the same graph as the unsharded residual), within
    1e-12·max|Jᵀw| in the overlapped form (its edge strips sum the
    cotangents in another order), and the dot test
    |⟨Jv, w⟩ − ⟨v, Jᵀw⟩| ≤ 1e-12·‖Jv‖‖w‖ for both."""
    from newtonkrylov_tpu_torch import halo
    from newtonkrylov_tpu_torch.operator import JacobianOperator
    from newtonkrylov_tpu_torch.utils import distributed as D
    from newtonkrylov_tpu_torch.utils.dryrun import bratu_padded

    p = bratu2d.default_config(N, lam=LAM)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    v, w = (torch.randn((N, N), generator=gen, device="cuda",
                        dtype=torch.float64) for _ in range(2))
    ref = JacobianOperator(bratu2d.residual_scaled, u_f, p).rmv(w)
    for overlap in (False, True):
        F = halo.sharded_residual_2d(bratu_padded, ("i", "j"), "dirichlet",
                                     overlap=overlap)
        D.reset_collective_counts()
        with D.use_mesh(mesh):
            J = JacobianOperator(F, halo.shard_array(u_f, mesh, halo.P("i", "j")), p)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            jtw = J.rmv(w)
            torch.cuda.synchronize()
            t_rmv = time.perf_counter() - t0
            jv = J.mv(v)
        diff = float((jtw - ref).abs().max())
        bitwise = _bitwise_equal(torch, jtw, ref)
        gap = abs(float((jv * w).sum() - (v * jtw).sum()))
        bound = 1e-12 * float(jv.norm() * w.norm())
        form = "overlapped" if overlap else "plain exchange"
        log(f"[transpose] n={N} f64 world 1, {form}: J.rmv against the "
            f"unsharded J.rmv {'bit for bit' if bitwise else f'max|Δ| {diff:.3e}'}"
            f" (max|Jᵀw| {float(ref.abs().max()):.3e}); dot test |<Jv,w> - "
            f"<v,Jᵀw>| {gap:.3e} (limit {bound:.3e}); first J.rmv "
            f"{t_rmv * 1e3:.1f} ms with its VJP trace; collectives "
            f"{dict(D.COLLECTIVES)}")
        if not (bitwise if not overlap
                else diff <= 1e-12 * float(ref.abs().max())):
            raise AssertionError(f"transpose ({form}): J.rmv differs from the "
                                 "unsharded J.rmv")
        if not gap <= bound:
            raise AssertionError(f"transpose ({form}): the dot test fails")


def phase_scaling(torch):
    """(r4) The weak-scaling harness on the world-1 NCCL group at local_n =
    2048 (f32, chains of 200 and 20, best of 3): a 1-device row mesh and a
    1×1 mesh; one exchange per mesh axis and matvec, none sent."""
    from newtonkrylov_tpu_torch.utils import distributed as D
    from newtonkrylov_tpu_torch.utils import scaling

    chain, repeats = 200, 3
    matvecs = (1 + repeats) * (chain // 10 + chain)
    D.reset_collective_counts()
    t0 = time.perf_counter()
    pts = scaling.weak_scaling_matvec(local_n=N, device_counts=[1],
                                      chain=chain, repeats=repeats)
    c1, t1 = dict(D.COLLECTIVES), time.perf_counter() - t0
    D.reset_collective_counts()
    t0 = time.perf_counter()
    pt2 = scaling.weak_scaling_matvec_2d(N, (1, 1), chain=chain,
                                         repeats=repeats)
    c2, t2 = dict(D.COLLECTIVES), time.perf_counter() - t0
    for pt, c, t, axes in ((pts[0], c1, t1, 1), (pt2, c2, t2, 2)):
        log(f"[scaling] {pt.n_devices} device(s), global {pt.global_n} rows x "
            f"{N} cols: {pt.matvecs_per_s:.1f} "
            f"matvecs/s ({1e6 / pt.matvecs_per_s:.2f} us a matvec), efficiency "
            f"{pt.efficiency}; {c['exchange']} exchanges for {matvecs} "
            f"matvecs ({axes} a matvec), {c['p2p']} messages; {t:.1f} s")
        if c["exchange"] != axes * matvecs or c["p2p"] != 0:
            raise AssertionError("scaling: not one exchange per mesh axis and "
                                 "matvec")
        if not pt.matvecs_per_s > 0:
            raise AssertionError("scaling: no rate")
    if pts[0].efficiency != 1.0:
        raise AssertionError("scaling: the first point's efficiency is not 1")


def _roundtrip(torch, fn, args, tag, timer, workdir):
    """``fn`` exported, saved under ``workdir`` and loaded, each phase timed
    by ``timer``; returns (loaded, bytes on disk, the exported graph's op
    targets)."""
    from newtonkrylov_tpu_torch.utils import serving

    with timer(f"{tag}: export"):
        ep = serving.export_solver(fn, args)
    with timer(f"{tag}: save"):
        path = serving.save_exported(ep, os.path.join(workdir, f"{tag}.pt2"))
    with timer(f"{tag}: load"):
        loaded = serving.load_exported(path)
    targets = {str(node.target) for m in ep.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule) for node in m.graph.nodes}
    return loaded, os.path.getsize(path), targets


def _state_agreement(torch, tag, u, u_live):
    """Log and gate the loaded program's state against the live one: bit
    for bit, or within 1e-12·max|u| where the exported graph decomposes an
    op."""
    if _bitwise_equal(torch, u, u_live):
        log(f"[{tag}] state bit for bit equal to the live solve's")
        return
    diff, scale = float((u - u_live).abs().max()), float(u_live.abs().max())
    log(f"[{tag}] state within {diff:.3e} of the live solve's (limit "
        f"1e-12·max|u| = {1e-12 * scale:.3e})")
    if not diff <= 1e-12 * scale:
        raise AssertionError(f"{tag}: the loaded program's state differs")


def phase_export_flagship(torch, nkt, bratu2d, info_f, live, timer, workdir):
    """(r1) ``entry()``'s configuration at 2048² (f32 CG, df32 acceptance,
    ``fft_poisson(precision="high")`` built once, tol_rel 1e-8) exported
    whole, saved, loaded and called: solved, the f64 true residual, the
    live flagship's counts and state.  Returns (loaded, u0, info of the
    loaded call)."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    p = bratu2d.default_config(N, lam=LAM)
    u0 = bratu2d.initial_guess(N, dtype=torch.float32, device="cuda").to(
        torch.float64)

    def fn(u):
        u, info = nkt.newton_krylov_jit(
            bratu2d.residual_scaled, u, p, algo="cg", tol_rel=1e-8,
            krylov_dtype=torch.float32, residual_df=bratu2d.residual_scaled_df,
            max_niter=20, M=fft_poisson(precision="high"),
            precond_refresh="once")
        return (u, info.stats.outer_iterations, info.stats.inner_iterations,
                info.solved, info.stats.n_res, info.floor_limited)

    loaded, size, _ = _roundtrip(torch, fn, (u0,), "flagship", timer, workdir)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer("flagship: loaded call"):
            u, outer, inner, solved, n_res, fl = loaded.call(u0)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    info = nkt.NewtonInfo(solved=solved, stats=nkt.Stats(int(outer), int(inner), n_res),
                          t=walls[-1], floor_limited=fl)
    fu, f0 = _true_residual(torch, bratu2d, u, u0, p)
    counts = (int(outer), int(inner))
    ref = (info_f.stats.outer_iterations, info_f.stats.inner_iterations)
    log(f"[export flagship] n={N}: export {timer.totals['flagship: export']:.2f} s, "
        f"artifact {size / 2**20:.1f} MiB, load {timer.totals['flagship: load']:.2f} s; "
        f"loaded solved={bool(solved)} outer/inner {counts[0]}/{counts[1]} (live "
        f"{ref[0]}/{ref[1]}); wall {walls[0]:.3f} s first call, {walls[1]:.3f} s "
        f"second, beside the live flagship's {live['wall']:.3f} s; true |F|="
        f"{fu:.4e} (limit {1e-8 * f0 + 1e-12:.4e})")
    if not bool(solved):
        raise AssertionError("export flagship: the loaded solve did not converge")
    if not fu <= 1e-8 * f0 + 1e-12:
        raise AssertionError("export flagship: f64 true residual above 1e-8·‖F₀‖")
    if counts != ref:
        raise AssertionError("export flagship: counts differ from the live flagship's")
    _state_agreement(torch, "export flagship", u, live["u"])
    return loaded, u0, info


def phase_export_aligned(torch, nkt, bratu2d, info_a, live, timer, workdir):
    """(r2) The aligned solve at 2048² (f64 state, f32 CG, K1 for every
    matvec, K2 for every residual) exported, saved and loaded; returns the
    loaded program and u₀.  The caller counts the loaded call's launches."""
    u0, p, space = bratu2d.aligned_setup(N, lam=LAM, dtype=torch.float64,
                                         device="cuda")

    def fn(u):
        u, info = nkt.newton_krylov_jit(
            bratu2d.residual_scaled_aligned, u, p, algo="cg", space=space,
            krylov_dtype=torch.float32, tol_rel=1e-8, max_niter=20)
        return u, info.stats.outer_iterations, info.stats.inner_iterations, info.solved

    loaded, size, targets = _roundtrip(torch, fn, (u0,), "aligned", timer, workdir)
    ops = [t for t in ("newtonkrylov_tpu_torch.stencil_jvp.default",
                       "newtonkrylov_tpu_torch.bratu_residual.default")
           if t in targets]
    log(f"[export aligned] n={N}: export {timer.totals['aligned: export']:.2f} s, "
        f"artifact {size / 2**20:.1f} MiB; the graph calls {ops}")
    if len(ops) != 2:
        raise AssertionError("export aligned: the exported graph lost K1 or K2")

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer("aligned: loaded call"):
            out = loaded.call(u0)
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def check(out, wall):
        u, outer, inner, solved = out
        counts = (int(outer), int(inner))
        ref = (info_a.stats.outer_iterations, info_a.stats.inner_iterations)
        log(f"[export aligned] loaded solved={bool(solved)} outer/inner "
            f"{counts[0]}/{counts[1]} (live {ref[0]}/{ref[1]}); wall {wall:.3f} s "
            f"beside the live aligned solve's {live['wall']:.3f} s")
        if not bool(solved) or counts != ref:
            raise AssertionError("export aligned: unsolved, or counts differ "
                                 "from the live solve's")
        _state_agreement(torch, "export aligned", u, live["u"])

    return run, check


def phase_export_gmres_flagship(torch, nkt, bratu2d, info_g, live, timer,
                                workdir):
    """(s1) the GMRES flagship at 2048² — ``newton_krylov_jit`` with its
    default ``algo="gmres"`` (the parity basis of 100), f32 Krylov, df32
    acceptance, DST(high) built once — exported whole, saved, loaded and
    called twice: solved, the live GMRES flagship's counts (6 / 7) and its
    state bit for bit."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    p = bratu2d.default_config(N, lam=LAM)
    u0 = bratu2d.initial_guess(N, dtype=torch.float32, device="cuda").to(
        torch.float64)

    def fn(u):  # every keyword as phase_gmres_flagship's solve; no algo=
        u, info = nkt.newton_krylov_jit(
            bratu2d.residual_scaled, u, p, tol_rel=1e-8,
            krylov_dtype=torch.float32, residual_df=bratu2d.residual_scaled_df,
            max_niter=20, M=fft_poisson(precision="high"),
            precond_refresh="once")
        return u, info.stats.outer_iterations, info.stats.inner_iterations, info.solved

    loaded, size, _ = _roundtrip(torch, fn, (u0,), "gmres flagship", timer,
                                 workdir)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer("gmres flagship: loaded call"):
            u, outer, inner, solved = loaded.call(u0)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    fu, f0 = _true_residual(torch, bratu2d, u, u0, p)
    counts = (int(outer), int(inner))
    ref = (info_g.stats.outer_iterations, info_g.stats.inner_iterations)
    log(f"[export gmres flagship] n={N}: export "
        f"{timer.totals['gmres flagship: export']:.2f} s, artifact "
        f"{size / 2**20:.1f} MiB, load {timer.totals['gmres flagship: load']:.2f}"
        f" s; loaded solved={bool(solved)} outer/inner {counts[0]}/{counts[1]} "
        f"(live {ref[0]}/{ref[1]}); wall {walls[0]:.3f} s first call, "
        f"{walls[1]:.3f} s second, beside the live GMRES flagship's "
        f"{live['wall']:.3f} s; true |F|={fu:.4e} (limit "
        f"{1e-8 * f0 + 1e-12:.4e})")
    if not bool(solved):
        raise AssertionError("export gmres flagship: the loaded solve did not "
                             "converge")
    if not fu <= 1e-8 * f0 + 1e-12:
        raise AssertionError("export gmres flagship: f64 true residual above "
                             "1e-8·‖F₀‖")
    if counts != ref:
        raise AssertionError("export gmres flagship: counts differ from the "
                             "live GMRES flagship's")
    if not _bitwise_equal(torch, u, live["u"]):
        raise AssertionError("export gmres flagship: state not bit for bit "
                             "the live solve's")
    log("[export gmres flagship] state bit for bit equal to the live solve's")


def phase_export_small(torch, nkt, bratu2d, timer, workdir):
    """(s2) Ψtc (default GMRES), BiCGStab, pipelined CG on Bratu 64² in f64
    (tol_rel 1e-10; Ψtc on −F, δ₀ = (n+1)², no preconditioner: a factory
    rebuilt every step fills its caches inside the loop) and CGLS on the
    cubic A u + u³/10 = b (A = tridiag(−1, 4, −1), n = 64, A a parameter,
    so the loop replays a traced Jᵀ·w) exported, loaded and called on the
    card: each solved, with its live run's counts and state bit for bit."""
    f64 = torch.float64
    dev = "cuda"
    p = bratu2d.default_config(64, lam=LAM)
    u0 = bratu2d.initial_guess(64, dtype=f64, device=dev)
    n = 64
    A = (4.0 * torch.eye(n, dtype=f64, device=dev)
         - torch.diag(torch.ones(n - 1, dtype=f64, device=dev), 1)
         - torch.diag(torch.ones(n - 1, dtype=f64, device=dev), -1))
    b = torch.sin(torch.arange(n, dtype=f64, device=dev) + 1.0)

    def cubic(u, q):
        return q[0] @ u + 0.1 * u ** 3 - q[1]

    def newton(algo, **kw):
        def fn(u):
            u, info = nkt.newton_krylov_jit(bratu2d.residual_scaled, u, p,
                                            algo=algo, tol_rel=1e-10, **kw)
            return u, info.stats.outer_iterations, info.stats.inner_iterations, info.solved
        return fn

    def ptc(u):  # Ψtc marches −F (test_torch_continuation.py's recipe)
        u, info = nkt.pseudo_transient(
            lambda x, q: -bratu2d.residual_scaled(x, q), u, p, tol_rel=1e-10,
            delta0=float(65 ** 2), max_steps=60)
        return u, info.stats.outer_iterations, info.stats.inner_iterations, info.solved

    def cgls(u):
        u, info = nkt.newton_krylov_jit(cubic, u, (A, b), algo="cgls",
                                        tol_rel=1e-10)
        return u, info.stats.outer_iterations, info.stats.inner_iterations, info.solved

    cases = (("ptc gmres", ptc, u0), ("bicgstab", newton("bicgstab"), u0),
             ("pipelined cg", newton("cg", krylov_kwargs={"pipeline": True}), u0),
             ("cgls", cgls, torch.zeros(n, dtype=f64, device=dev)))
    for tag, fn, x0 in cases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live = fn(x0)
        torch.cuda.synchronize()
        live_wall = time.perf_counter() - t0
        loaded, size, _ = _roundtrip(torch, fn, (x0,), tag, timer, workdir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loaded.call(x0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, ref = (int(out[1]), int(out[2])), (int(live[1]), int(live[2]))
        log(f"[export small] {tag}: export {timer.totals[f'{tag}: export']:.2f}"
            f" s, artifact {size / 2**20:.2f} MiB; loaded outer/inner "
            f"{counts[0]}/{counts[1]} (live {ref[0]}/{ref[1]}), solved="
            f"{bool(out[3])}; wall {wall:.3f} s beside the live {live_wall:.3f} s")
        if not (bool(out[3]) and bool(live[3])):
            raise AssertionError(f"export small {tag}: not solved")
        if counts != ref or not _bitwise_equal(torch, out[0], live[0]):
            raise AssertionError(f"export small {tag}: the loaded program "
                                 "differs from the live solve")
    log(f"[export small] {len(cases)} exported solves bit for bit equal to "
        "their live runs")


def phase_time_chain(torch, bratu2d, k1_ms):
    """(r3) ``bench.py``'s ``r_pal`` lane on the port: ``time_chain`` on K1
    at 2048² f32 (w = Δx²λeᵘ at the sin-bump u₀), beside phase 2's device
    time per K1 call."""
    from newtonkrylov_tpu_torch.kernels import stencil2d as k
    from newtonkrylov_tpu_torch.utils.profiling import time_chain

    p = bratu2d.default_config(N, lam=LAM)
    u = bratu2d.initial_guess(N, dtype=torch.float32, device="cuda")
    v = k.aligned_wrap(u)
    w = k.aligned_wrap((p.dx * p.dx * p.lam) * torch.exp(u))
    t0 = time.perf_counter()
    rate = time_chain(lambda x, ww: k.stencil_jvp(x, ww, N), v, w)
    per_us = 1e6 / rate
    log(f"[time_chain K1] n={N} f32: {rate:.1f} matvecs/s = {per_us:.2f} us a "
        f"chained matvec, beside K1's device time {k1_ms * 1e3:.2f} us a call "
        f"(phase 2): the chain runs at {k1_ms * 1e3 / per_us:.0%} of the "
        f"device-bound rate ({'device' if k1_ms * 1e3 >= 0.8 * per_us else 'host dispatch'}"
        f" sets it); {time.perf_counter() - t0:.1f} s")
    if not rate > 0:
        raise AssertionError("time_chain on K1: no rate")
    return rate


def phase_trace(torch, loaded, u0, workdir):
    """(r3) ``trace()`` around one loaded flagship solve inside an
    ``annotate`` range: the trace file must exist and hold that range."""
    import glob

    from newtonkrylov_tpu_torch.utils.profiling import annotate, trace

    logdir = os.path.join(workdir, "trace")
    t0 = time.perf_counter()
    with trace(logdir):
        with annotate("flagship_solve"):
            loaded.call(u0)
            torch.cuda.synchronize()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace: {len(files)} trace files in {logdir}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"[trace] {os.path.basename(files[0])}: {os.path.getsize(files[0]) / 2**20:.1f} "
        f"MiB, {len(events)} events ({kernels} kernels), the annotate range "
        f"{'present' if 'flagship_solve' in names else 'MISSING'}; "
        f"{time.perf_counter() - t0:.1f} s with the export of the trace")
    if "flagship_solve" not in names:
        raise AssertionError("trace: the annotate range is not in the trace")


def _gate_examples(name, r):
    """What the JAX example asserts or prints as expected, on the port
    example's returned dict; raises on a miss."""
    def need(ok, what):
        if not ok:
            raise AssertionError(f"example {name}: {what}")

    if name == "simple_2d":
        roots = [(1.0, 1.0), (1.0, 1.0), (-0.47767, 1.331102)]
        for run, root in zip(r["runs"], roots):
            need(run["solved"], f"x0={run['x0']} not solved")
            need(max(abs(a - b) for a, b in zip(run["u"], root)) <= 2e-5,
                 f"x0={run['x0']} left the root {root}")
    elif name == "spring_implicit":
        # energy v² + γ²x² (γ² = 2): backward Euler damps it, the
        # trapezoid rule conserves it
        energy = {k: u[1] ** 2 + 2.0 * u[0] ** 2 for k, u in r["u"].items()}
        need(all(v == 0 for v in r["n_failed"].values()), "a step failed")
        need(energy["euler"] < (1 - 1e-3) * 0.02, "euler does not damp")
        need(abs(energy["trapezoid"] - 0.02) <= 1e-3 * 0.02,
             "trapezoid does not conserve the energy")
    elif name == "heat_1d":
        need(all(d["rank"] == 12 for d in r["dense"].values()), "rank")
        for k in ("euler", "midpoint", "trapezoid"):
            mf = r["matrix_free"][k]
            need(abs(mf["cond_mf"] - mf["cond_dense"]) <= 1e-6 * mf["cond_dense"],
                 f"{k}: matrix-free cond against dense")
            need(r["march"][k]["n_failed"] == 0, f"{k}: a step failed")
        need(r["matrix_free"]["lower_bound"] > 2900, "the N=1e5 lower bound")
    elif name == "heat_1d_dg":
        for tag in ("legendre DG", "upwind order-3"):
            m = r[tag]
            need(m["n_failed"] == 0 and 0.5 * m["norm_u0"] < m["norm_u"] < m["norm_u0"],
                 f"{tag}: a failed step, or the norm does not decay")
    elif name == "heat_2d":
        for k in ("euler", "midpoint", "trapezoid"):
            m = r[k]
            need(m["n_failed"] == 0 and abs(m["decay"] - m["analytic"]) <= 1e-3,
                 f"{k}: a failed step, or the decay off the analytic rate")
        need(r["periodic_residual"] == 0.0, "periodic equilibrium")
    elif name == "bratu_1d":
        for tag, m in r.items():
            # the discretization error scales with Δx²: 5e-6 at N = 10⁴
            limit = 5e-6 * ((GALLERY_N + 1) / (m["n"] + 1)) ** 2
            if m["expect_fail"]:
                need(not m["solved"], f"{tag}: a negative recipe converged")
            else:
                need(m["solved"] and m["err"] <= limit, f"{tag}: not solved, "
                     f"or max|u - u*| {m['err']:.2e} above {limit:.2e}")
        ilu = r["gmres + ILU0 (host C++)"]
        need(ilu["host_copies"]["device_to_host"]
             == ilu["host_copies"]["host_to_device"] >= ilu["inner"] > 0,
             "ILU(0): not one host copy each way per apply")
    elif name == "bvp_kelley":
        need(r["banded_lu"]["solved"] and r["banded_lu"]["n_res"] <= 1e-8,
             "the banded-LU recipe")
        need(not r["nested"]["solved"] and r["nested"]["n_res"] > 1e-2,
             "the nested-Krylov recipe did not stall")
    elif name == "continuation_bratu":
        need(all(st["solved"] for st in r["steps"]), "a step below the fold")
        need(r["steps"][-1]["outer"] <= 10, "the near-fold step's outers")
        need(not r["past_fold"]["solved"], "lam = 7.50 past the fold solved")
    elif name == "ptc_globalization":
        need(r["arctan"]["ptc"]["solved"] and not r["arctan"]["newton"]["solved"],
             "arctan: Ψtc must solve where Newton diverges")
        for amp, m in r["bratu"].items():
            need(m["ptc_solved"] and m["ptc_outer"] <= m["newton_outer"],
                 f"amp {amp}: Ψtc unsolved or slower than Newton")
    elif name == "convdiff_2d":
        for tag, m in r.items():
            if tag == "c25 dst restarted":
                need(not m["solved"], "the restarted DST recipe converged")
            else:
                limit = 1e-6 if "df32" in tag else 1e-10
                need(m["solved"] and m["err"] <= limit, f"{tag}: not solved, "
                     f"or max|u - u*| {m['err']:.2e} above {limit:.0e}")
        ilu = r["c25 ilu0"]
        need(ilu["host_copies"]["device_to_host"] >= ilu["inner"] > 0,
             "ILU(0): host copies")
    elif name == "bratu_2d_cuda":
        cg = r["refined_cg"]
        need(cg["solved"] and r["df32_dst"]["solved"], "a lane unsolved")
        need(cg["launches"]["stencil_jvp"] >= cg["inner"],
             "K1 launched fewer times than the refined lane's inners")
        need(r["max_diff"] <= 1e-6, "the two lanes reach different roots")
    elif name == "sharded_bratu":
        single = r["single"]
        for shape, m in r["meshes"].items():
            need(m["solved"] and (m["outer"], m["inner"]) == (
                single["outer"], single["inner"]) and m["max_diff"] <= 1e-9,
                f"mesh {shape}: counts or state off the single-device solve")
        d = r["dst"]
        need(d["solved"] and d["inner"] == d["single_inner"] and d["max_diff"] <= 1e-9,
             "global DST: counts or state off the single-device solve")


def _example_summary(name, r):
    """One line of the counts an example returned."""
    def counts(m):
        return f"{m['outer']}/{m['inner']}"

    if name == "simple_2d":
        return ", ".join(counts(x) for x in r["runs"])
    if name == "spring_implicit":
        return f"amplitude {r['amplitude']}"
    if name == "heat_1d":
        return ", ".join(f"{k} {m['outer'].tolist()}/{m['inner'].tolist()}"
                         for k, m in r["march"].items())
    if name in ("heat_1d_dg", "heat_2d"):
        return ", ".join(f"{k} {m['outer'].tolist()}/{m['inner'].tolist()}"
                         for k, m in r.items() if isinstance(m, dict))
    if name in ("bratu_1d", "convdiff_2d"):
        return ", ".join(f"{k} {counts(m)}" for k, m in r.items())
    if name == "bvp_kelley":
        return f"banded LU {counts(r['banded_lu'])}, nested {counts(r['nested'])}"
    if name == "continuation_bratu":
        return ", ".join(counts(m) for m in r["steps"]) + f", past {counts(r['past_fold'])}"
    if name == "ptc_globalization":
        return ", ".join(f"{a}: newton {m['newton_outer']} ptc {m['ptc_outer']}"
                         for a, m in r["bratu"].items())
    if name == "bratu_2d_cuda":
        return (f"refined CG {counts(r['refined_cg'])} in {r['refined_cg']['wall']:.3f} s, "
                f"df32 + DST {counts(r['df32_dst'])} in {r['df32_dst']['wall']:.3f} s; "
                f"K1/K2 {r['refined_cg']['launches']}")
    if name == "sharded_bratu":
        return (f"single {counts(r['single'])}, meshes "
                + ", ".join(f"{s} {counts(m)}" for s, m in r["meshes"].items())
                + f", global DST {counts(r['dst'])}")
    return ""


def _example_worker(name, size):
    """One example's ``main`` on the card, its printed lines captured:
    ``(result, printed, wall)``.  Runs in a spawned process of path (t)'s
    pool, or in this one."""
    import contextlib
    import importlib
    import io

    import torch

    mod = importlib.import_module(f"newtonkrylov_tpu_torch.examples.{name}")
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = mod.main(device="cuda", **size)
    torch.cuda.synchronize()
    return result, buf.getvalue(), time.perf_counter() - t0


def phase_examples(torch):
    """Path (t): every example of the port's gallery through its ``main``
    on the card at :data:`EXAMPLE_SIZES`, each gated as its JAX counterpart
    asserts or prints as expected (:func:`_gate_examples`), with its wall,
    its counts and its printed lines logged; ``sharded_bratu`` on a
    world-1 NCCL group.  The examples are host-bound, so they run
    ``EXAMPLE_WORKERS`` at a time in spawned processes, and
    ``bratu_2d_cuda`` in this one, whose K1/K2 counts the caller reads;
    beside them the four unsharded walkthroughs run on the card, one
    subprocess each (``--device cuda --no-figures``), and must end with
    their assertions held.  Every child runs one host thread.  Returns the
    examples' dicts."""
    import multiprocessing
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from newtonkrylov_tpu_torch import examples

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [q for q in env.get("PYTHONPATH", "").split(os.pathsep) if q])
    logdir = tempfile.mkdtemp(prefix="chip_smoke_t_")
    procs, ended = {}, {}
    t_start = time.perf_counter()
    old_threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # inherited by the spawned pool
    pool = ProcessPoolExecutor(EXAMPLE_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        for name in WALKTHROUGHS:
            with open(os.path.join(logdir, f"{name}.log"), "w") as f:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m",
                     "newtonkrylov_tpu_torch.docs.run_walkthroughs",
                     "--device", "cuda", "--no-figures", name],
                    stdout=f, stderr=subprocess.STDOUT, cwd=root, env=env)
        log(f"[examples] started the walkthroughs {', '.join(WALKTHROUGHS)} "
            "on the card, one process each; sharded_bratu on a world-1 NCCL "
            "group stands in for the sharded walkthrough, whose W ranks need "
            f"W cards; the examples {EXAMPLE_WORKERS} at a time in spawned "
            "processes, bratu_2d_cuda in this one")
        local = "bratu_2d_cuda"
        futures = {name: pool.submit(_example_worker, name, EXAMPLE_SIZES[name])
                   for name in EXAMPLE_ORDER if name != local}
        runs = {local: _example_worker(local, EXAMPLE_SIZES[local])}
        for name, fut in futures.items():
            runs[name] = fut.result(timeout=900)
        results = {}
        for name in examples.NAMES:
            r, printed, wall = runs[name]
            for line in printed.splitlines():
                log(f"[examples] {name} | {line}")
            log(f"[examples] {name} {EXAMPLE_SIZES[name] or '(documented size)'}: "
                f"wall {wall:.3f} s; {_example_summary(name, r)}")
            _gate_examples(name, r)
            results[name] = r
        log(f"[examples] the examples ended {time.perf_counter() - t_start:.1f} s "
            "after the phase began")
        while len(ended) < len(procs):
            for name, proc in procs.items():
                if name not in ended and proc.poll() is not None:
                    ended[name] = time.perf_counter() - t_start
            if time.perf_counter() - t_start > 900:
                raise AssertionError("the walkthroughs outlasted 900 s")
            time.sleep(0.5)
        for name, proc in procs.items():
            out = open(os.path.join(logdir, f"{name}.log")).read()
            for line in out.splitlines():
                if "Warning" not in line and "warnings.warn" not in line:
                    log(f"[walkthrough] {name} | {line}")
            log(f"[walkthrough] {name}: exit code {proc.returncode}, ended "
                f"{ended[name]:.1f} s after the phase began")
            if proc.returncode != 0 or "   OK" not in out:
                raise AssertionError(f"walkthrough {name} failed on the card "
                                     f"(exit code {proc.returncode})")
        return results
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        if old_threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old_threads
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(logdir, ignore_errors=True)


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
    smi = phase_environment(torch)
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

    flagship, aligned = {}, {}  # their states and walls, for paths (q), (r)

    def main_path():  # the first slice's: the aligned and flagship solves
        return (phase_aligned(torch, nkt, bratu2d, "run", keep=aligned),
                phase_flagship(torch, nkt, bratu2d, "run", keep=flagship))

    info_a, info_f = counted("main path", ("stencil_jvp", "bratu_residual"),
                             main_path)
    if launches["stencil_jvp"] < info_a.stats.inner_iterations:
        raise AssertionError("K1 launched fewer times than the aligned "
                             "solve's inner iterations")

    # this slice's path (r): the exported solves, the chain timer and the
    # trace (the sharded (r4) and (q5) run in path (q)'s group below)
    import shutil
    import tempfile

    from newtonkrylov_tpu_torch.utils.profiling import PhaseTimer, solve_report

    t0 = time.perf_counter()
    timer, workdir = PhaseTimer(), tempfile.mkdtemp(prefix="chip_smoke_r_")
    try:
        loaded_f, u0_f, info_r1 = phase_export_flagship(
            torch, nkt, bratu2d, info_f, flagship, timer, workdir)
        run_r2, check_r2 = phase_export_aligned(
            torch, nkt, bratu2d, info_a, aligned, timer, workdir)
        r2_launches = {}
        check_r2(*counted("exported aligned solve (loaded program)",
                          ("stencil_jvp", "bratu_residual"), run_r2,
                          into=r2_launches))
        # The loaded program launches K1 once a CG matvec (each outer's
        # r₀ = b − A·x₀ included) and K2 once a residual (u₀'s and one an
        # outer).  The live solve launches more: each torch.func.linearize
        # evaluates the residual three times (its output, its traced dual,
        # its constant folding) and the J·v once while it traces, where the
        # program replays a graph traced once with fake tensors.
        outer, inner = (info_a.stats.outer_iterations,
                        info_a.stats.inner_iterations)
        k1, k2 = r2_launches["stencil_jvp"], r2_launches["bratu_residual"]
        log(f"[export aligned] loaded program: K1 {k1} launches (inner + "
            f"outer = {inner + outer}), K2 {k2} (outer + 1 = {outer + 1}); "
            f"the live aligned solve: K1 {launches['stencil_jvp']}, K2 "
            f"{launches['bratu_residual']}, of which its {outer} "
            f"linearizations' tracing launched K1 {outer} and K2 {3 * outer} "
            f"times")
        if (k1, k2) != (inner + outer, outer + 1) or (
                launches["stencil_jvp"] - k1, launches["bratu_residual"] - k2
        ) != (outer, 3 * outer):
            raise AssertionError("export aligned: the loaded program's K1/K2 "
                                 "launches do not account for the live solve's")
        r3_launches = {}
        counted("time_chain on K1", ("stencil_jvp",),
                lambda: phase_time_chain(torch, bratu2d, summary["stencil_jvp"][1]),
                into=r3_launches)
        log(f"[time_chain K1] {r3_launches['stencil_jvp']} K1 launches")
        phase_trace(torch, loaded_f, u0_f, workdir)
        log("[phase timer] path (r)\n" + timer.summary())
        log("[solve_report] loaded flagship (r1)\n"
            + solve_report(info_r1, N * N))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del aligned["u"]
    log(f"[summary] path (r): {time.perf_counter() - t0:.1f} s")
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
    gmres = {}
    info_g = counted("gmres flagship", (), lambda: phase_gmres_flagship(
        torch, nkt, bratu2d, "run", keep=gmres))

    # this slice's path (s): every Krylov method exported; no kernel runs
    t0 = time.perf_counter()
    timer, workdir = PhaseTimer(), tempfile.mkdtemp(prefix="chip_smoke_s_")
    try:
        counted("exported gmres flagship (s1)", (), lambda: phase_export_gmres_flagship(
            torch, nkt, bratu2d, info_g, gmres, timer, workdir))
        counted("exported small solves (s2)", (),
                lambda: phase_export_small(torch, nkt, bratu2d, timer, workdir))
        log("[phase timer] path (s)\n" + timer.summary())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del gmres["u"]
    log(f"[summary] path (s): {time.perf_counter() - t0:.1f} s")
    counted("convdiff solve", (), lambda: phase_convdiff(torch, nkt, "run"))
    # this slice's paths (b)-(e) run no hand-written kernel: counts logged
    counted("flagship pipelined solve", (),
            lambda: phase_pipelined(torch, nkt, bratu2d, info_f))
    counted("flagship from bench.py's u0", (),
            lambda: phase_flagship_bench_u0(torch, nkt, bratu2d, info_f))
    counted("spectral cross-checks", (), lambda: phase_spectral(torch, nkt, bratu2d))

    # this slice's paths (g)-(k); only Ψtc with Chebyshev runs a kernel (K4)
    counted("1-D gallery (newton_krylov)", (), lambda: phase_gallery(torch, nkt))
    phase_tridiagonal(torch, nkt)
    counted("bvp", (), lambda: phase_bvp(torch, nkt))
    ptc_launches = {}
    applies_ptc = counted(
        "ptc near the fold", ("chebyshev_apply",),
        lambda: phase_ptc(torch, nkt, bratu2d), into=ptc_launches)[1]
    if ptc_launches["chebyshev_apply"] != applies_ptc:
        raise AssertionError("K4 launches on the Ψtc path are not one per "
                             "Chebyshev preconditioner apply")
    launches["chebyshev_apply"] += ptc_launches["chebyshev_apply"]
    log(f"[launches] ptc near the fold: K4 {ptc_launches['chebyshev_apply']} "
        f"launches = {applies_ptc} Chebyshev preconditioner applies")
    counted("nldiff2d solve", (), lambda: phase_nldiff(torch, nkt))
    counted("convdiff c=25 + ILU0 64²", (), lambda: phase_convdiff_ilu(torch, nkt))

    # this slice's paths (l)-(p): time stepping and the differentiable
    # solve; only (l) runs a kernel (K4, one launch per Chebyshev apply)
    heat_launches = {}
    u_cheb, applies_heat = counted(
        "heat march cheb-pcg", ("chebyshev_apply",),
        lambda: phase_heat_cheb(torch, nkt), into=heat_launches)
    k4_heat = heat_launches["chebyshev_apply"]
    log(f"[launches] heat march cheb-pcg: K4 {k4_heat} launches = "
        f"{applies_heat} Chebyshev preconditioner applies")
    if k4_heat != applies_heat:
        raise AssertionError("K4 launches on the heat march are not one per "
                             "Chebyshev preconditioner apply")
    launches["chebyshev_apply"] += k4_heat
    heat_counts = counted("heat march dst integrate_scan", (),
                          lambda: phase_heat_dst_scan(torch, nkt, u_cheb))
    del u_cheb
    counted("heat drivers and resume", (), lambda: phase_heat_drivers(torch, nkt))
    counted("small problems, card against cpu", (),
            lambda: phase_small_problems(torch, nkt))
    counted("implicit grad", (), lambda: phase_implicit_grad(torch, nkt, bratu2d))

    # this slice's path (q): the sharded solvers on a world-1 NCCL group;
    # they run no hand-written kernel (the sharded Chebyshev exchanges
    # ghosts between polynomial steps, which K4 cannot)
    t0 = time.perf_counter()
    counted("sharded solvers (nccl, world 1)", (), lambda: phase_sharded(
        torch, nkt, bratu2d, smi, info_f, flagship.pop("u"),
        info_c, heat_counts))
    log(f"[summary] path (q): {time.perf_counter() - t0:.1f} s")

    # this slice's path (t): the example gallery and the walkthroughs on the
    # card; bratu_2d_cuda's refined CG lane launches K1 every matvec and K2
    # every residual, and the kernels JSON counts them beside the main path's
    t0 = time.perf_counter()
    t_launches = {}
    gallery = counted("examples", ("stencil_jvp", "bratu_residual"),
                      lambda: phase_examples(torch), into=t_launches)
    lane = gallery["bratu_2d_cuda"]["refined_cg"]
    log(f"[launches] examples: K1 {t_launches['stencil_jvp']} launches "
        f"(bratu_2d_cuda's refined CG lane: {lane['outer']} / {lane['inner']}, "
        f"its own count {lane['launches']}), K2 {t_launches['bratu_residual']}")
    if t_launches["stencil_jvp"] < lane["inner"]:
        raise AssertionError("K1 launched fewer times than bratu_2d_cuda's "
                             "refined CG inner iterations")
    for key in ("stencil_jvp", "bratu_residual"):
        launches[key] += t_launches[key]
    del gallery
    log(f"[summary] path (t): {time.perf_counter() - t0:.1f} s")

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
    phase_native_f64_flagship(torch, nkt, bratu2d)
    phase_aligned_small(torch, nkt, bratu2d)
    phase_convdiff_small(torch, nkt)
    phase_conv25_small(torch, nkt)
    log(f"[summary] warm repeats and 64² cross-checks: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_breakdown(torch, nkt, bratu2d)
    phase_convdiff_breakdown(torch, nkt, warm_wall)
    phase_slice_breakdown(torch, nkt, bratu2d, walls)
    phase_ilu_breakdown(torch, nkt)
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
    log(f"[summary] probe cost model at {PROBE_N}²: copy + block barrier per "
        f"step {model['copy_barrier_stencil_us']:.3f} us (stencil), pass "
        f"through memory, per step {model['pass_step_us'][2]:.3f} us (mul x2), row shift "
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
