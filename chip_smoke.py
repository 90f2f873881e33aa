#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``:

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero after any):

1. environment and build: the card's name and power limit, versions, TF32
   switched off, the CUDA sources of ``newtonkrylov_tpu_torch/csrc`` compiled
   in parallel (one ``nvcc`` each);
2. K1 and K2 against their plain PyTorch versions on the card, in f32 and
   f64 at n = 2048 and n = 64 (K1 exactly equal, K2 within 4 ulp), timed
   per call (CUDA events) and in device time alone (torch.profiler);
3. the chain kernels K3 (k = 1, 2, 7, 200), K5 (k = 2, 200) and K4 (degree
   1, 4, 16, on the interval of a probed Bratu Jacobian) against their plain
   versions, bit for bit, at the same sizes, dtypes and seeded inputs, timed
   the same way;
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
11. warm repeats (the Bratu paths at 2048², Cheb-PCG also at 1024², its
    lane's own size, convection–diffusion at 512²), the aligned and the
    convection–diffusion solves at 64² against the same solves on the CPU,
    and a breakdown: each component's cost alone and each solve's device
    busy time under torch.profiler (measurements only).

Launch counts are zeroed just before each of phases 6–10 and read just
after; each kernel must have been launched on its path.  The last two lines
are a JSON object of per-kernel results and the JSON status object.
Without a CUDA device the script fails and prints no result.
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


def _profile(fn):
    """(device µs by kernel name, total device µs) of one call of ``fn``,
    from torch.profiler's CUDA activity; empty when the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us
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
            times[name] = (_time_ms(kern), _time_ms(plain),
                           _device_ms(kern), _device_ms(plain))
        log(f"[kernels] {tag}: K1 stencil_jvp bitwise-equal interior, "
            f"ghosts 0, max|err| {err1:.3e}")
        log(f"[kernels] {tag}: K2 bratu_residual max|err| {err2:.3e} "
            f"({ulp2:.2f} ulp of |F|+|scale e^u|, limit 4), ghosts 0")
        for name, (t, p, td, pd) in times.items():
            log(f"[kernels] {tag}: {name} per call {t:.4f} ms vs plain "
                f"{p:.4f} ms (CUDA events, back-to-back calls); device "
                f"time kernel {_fmt_ms(td)} vs plain {_fmt_ms(pd)}")
        if n == N and dt == torch.float32:
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
    for (n, dt), (v, w, _) in _inputs(torch, k, dev):
        tag = f"n={n} {str(dt).replace('torch.', '')}"
        J = nkt.JacobianOperator(bratu2d.residual_scaled,
                                 bratu2d.initial_guess(n, dt, dev),
                                 bratu2d.default_config(n, LAM))
        o, d = probe_5point(J)
        theta, delta = _cheb_bounds(o, d.min(), d.max(), None, 1 / 300, dt)
        diag, scal = k.aligned_wrap(d / o), torch.stack([theta, delta, o])
        cases = [("stencil_jvp_chain", "K3", s,
                  lambda s=s: k.stencil_jvp_chain(v, w, n, s, 0.125),
                  lambda s=s: k.stencil_jvp_chain_xla(v, w, n, s, 0.125))
                 for s in (1, 2, 7, CHAIN[0])]
        cases += [("stencil_chain_probe", "K5", s,
                   lambda s=s: k.stencil_chain_probe(v, w, n, s),
                   lambda s=s: k.stencil_chain_probe_xla(v, w, n, s))
                  for s in (2, CHAIN[0])]
        cases += [("chebyshev_apply", "K4", s,
                   lambda s=s: k.chebyshev_apply(v, diag, scal, n, s),
                   lambda s=s: k.chebyshev_apply_xla(v, diag, scal, n, s))
                  for s in (1, 4, 16)]
        for key, short, steps, kern, plain in cases:
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not _bitwise_equal(torch, got, ref):
                raise AssertionError(f"{short} {tag} steps={steps}: differs "
                                     f"from plain, max|err| {err:.3e}")
            errs[key] = max(errs[key], err)
            reps = _reps(steps)
            t, p = _time_ms(kern, reps), _time_ms(plain, reps)
            td, pd = _device_ms(kern, reps), _device_ms(plain, reps)
            log(f"[chain kernels] {tag}: {short} {key} steps={steps} "
                f"bitwise equal, max|ref| {float(ref.abs().max()):.3e}; per "
                f"call {t:.4f} ms vs plain {p:.4f} ms (CUDA events); device "
                f"time kernel {_fmt_ms(td)} vs plain {_fmt_ms(pd)}")
            if n == N and dt == torch.float32 and steps in (CHAIN[0], 16):
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


def _df32_solve(torch, nkt, bratu2d, n, M, tag, algo="cg"):
    """The flagship configuration at n² with preconditioner factory ``M``:
    f32 Krylov, df32 acceptance residual, ``M`` built once at u₀.  Gated on
    ``solved`` and the f64 true residual; returns the NewtonInfo."""
    p = bratu2d.default_config(n, lam=LAM)
    u0 = bratu2d.initial_guess(n, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # entry()'s f32 u₀, handed over as its exact f64 value: the df32 state
    # starts as (u₀, 0) either way, and the f64 boundary returns hi + lo, the
    # full state, for the f64 residual check below
    u, info = nkt.newton_krylov_jit(
        bratu2d.residual_scaled, u0.to(torch.float64), p,
        algo=algo, tol_rel=1e-8, krylov_dtype=torch.float32,
        residual_df=bratu2d.residual_scaled_df,
        max_niter=20, M=M, precond_refresh="once",
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


def _convdiff_solve(torch, nkt, n, device, refined):
    """Convection–diffusion (c = 2) from the zero start with the JAX
    package's recipe: DST-preconditioned full GMRES, exact Newton.
    ``refined``: f32 Krylov + df32 acceptance residual to 1e-8 (the
    production path); else f64 throughout to 1e-10.  Returns (u, info, wall
    seconds, ‖F(u)‖ and ‖F(u₀)‖ in f64, max|u − u*|)."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson
    from newtonkrylov_tpu_torch.problems import convdiff2d

    f64 = torch.float64
    p = convdiff2d.default_config(n, dtype=f64, device=device)
    u0 = convdiff2d.initial_guess(n, f64, device)
    kw = dict(algo="gmres", M=fft_poisson(), forcing=None)
    if refined:
        kw.update(krylov_kwargs={"restart": None, "itmax": 600},
                  krylov_dtype=torch.float32,
                  residual_df=convdiff2d.residual_scaled_df,
                  tol_rel=1e-8, max_niter=25)
    else:
        kw.update(krylov_kwargs={"restart": None, "itmax": 150}, tol_rel=1e-10)
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


def phase_convdiff(torch, nkt, pass_name):
    """Convection–diffusion at 512² on the refined path.  Gates: ``solved``,
    max|u − u*| ≤ 1e-6 and the f64 true residual ≤ 1e-8·‖F₀‖ + 1e-12."""
    n = CONVDIFF_N
    u, info, wall, fu, f0, err = _convdiff_solve(torch, nkt, n, "cuda", True)
    log(f"[convdiff {pass_name}] n={n} c=2 GMRES(full, itmax 600) + DST, f32 "
        f"Krylov + df32: solved={bool(info.solved)} "
        f"outer={info.stats.outer_iterations} "
        f"inner={info.stats.inner_iterations} "
        f"floor_limited={bool(info.floor_limited)} wall={wall:.3f} s  true "
        f"|F|={fu:.4e} (limit {1e-8 * f0 + 1e-12:.4e})  max|u - u*| "
        f"{err:.3e} (limit 1e-6)")
    if not bool(info.solved):
        raise AssertionError("convdiff solve did not converge")
    if not (torch.isfinite(u).all() and tuple(u.shape) == (n, n)):
        raise AssertionError("convdiff solve returned a malformed state")
    if not (fu <= 1e-8 * f0 + 1e-12 and err <= 1e-6):
        raise AssertionError("convdiff solve: true residual or error above limit")
    return info, wall


def phase_convdiff_small(torch, nkt):
    """The f64 convection–diffusion GMRES solve at 64² on the card and on
    the CPU: both solved, the same counts, solutions within 1e-10."""
    runs = {dev: _convdiff_solve(torch, nkt, 64, dev, False)
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
                     ("cheb-pcg", lambda: phase_cheb(torch, nkt, bratu2d, N, "profiled")),
                     ("aligned", lambda: phase_aligned(torch, nkt, bratu2d, "profiled"))):
        t0 = time.perf_counter()
        by_name, busy_us = _profile(run)
        wall = time.perf_counter() - t0
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log(f"[breakdown] {tag} solve under the profiler: wall {wall:.3f} s, "
            f"device busy {busy_us / 1e6:.4f} s "
            f"({100 * busy_us / 1e6 / wall:.1f}% of wall)")
        for name, us in top:
            log(f"[breakdown]   {us / 1e3:9.2f} ms  {name[:90]}")


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

    phase_environment(torch)
    summary = phase_kernels(torch)
    summary.update(phase_chain_kernels(torch, nkt, bratu2d))
    summary["chain_call"] = phase_probe_kernels(torch)
    phase_selfcheck(torch)

    # Each path counted on its own: the counts are zeroed just before it and
    # read just after, so every launch read is that path's.
    launches = {}

    def counted(path, keys, run):
        for counters in (k, kp):
            counters.reset_launch_counts()
        out = run()
        now = {**k.LAUNCHES, **kp.LAUNCHES}
        launches.update({key: now[key] for key in keys})
        log(f"[launches] {path}: {now}")
        for key in keys:
            if launches[key] <= 0:
                raise AssertionError(f"{key} was never launched by the {path}")
        return out

    def main_path():  # the first slice's: the aligned and flagship solves
        info = phase_aligned(torch, nkt, bratu2d, "run")
        phase_flagship(torch, nkt, bratu2d, "run")
        return info

    info_a = counted("main path", ("stencil_jvp", "bratu_residual"), main_path)
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
    model = counted("probe lane", ("chain_call",),
                    lambda: phase_probe_lane(torch))
    # the GMRES paths run no hand-written kernel: their counts are logged
    counted("gmres flagship", (),
            lambda: phase_gmres_flagship(torch, nkt, bratu2d, "run"))
    counted("convdiff solve", (), lambda: phase_convdiff(torch, nkt, "run"))

    # warm repeats (first-use costs paid), the lane's own size, the
    # small-size cross-checks and the breakdowns
    phase_aligned(torch, nkt, bratu2d, "warm")
    phase_flagship(torch, nkt, bratu2d, "warm")
    phase_cheb(torch, nkt, bratu2d, N, "warm")
    phase_cheb(torch, nkt, bratu2d, 1024, "run")
    _, warm_wall = phase_convdiff(torch, nkt, "warm")
    phase_aligned_small(torch, nkt, bratu2d)
    phase_convdiff_small(torch, nkt)
    phase_breakdown(torch, nkt, bratu2d)
    phase_convdiff_breakdown(torch, nkt, warm_wall)

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
