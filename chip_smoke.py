#!/usr/bin/env python3
"""Drive the PyTorch port's 2-D Bratu main path once on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and ``nvcc``:

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero after any):

1. environment and build: the card's name and power limit, versions, TF32
   switched off, the CUDA kernels compiled from ``newtonkrylov_tpu_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, in f32 and
   f64 at n = 2048 and n = 64 (K1 exactly equal, K2 within 4 ulp), timed
   per call (CUDA events) and in device time alone (torch.profiler);
3. ``df32.selfcheck()`` on the card;
4. the aligned-layout solve at 2048² (f64 state, f32 Krylov, matvecs through
   K1, residuals through K2), and at 64² against the same solve on the CPU;
5. the flagship solve at 2048² (f32 Krylov, df32 acceptance residual,
   DST-Poisson preconditioner built once);
6. a breakdown: each component's cost alone and each solve's device busy
   time under torch.profiler (measurements only).

Launch counts are zeroed just before phases 4–5 and read just after.  The
last two lines are a JSON object of per-kernel results and the JSON status
object.  Without a CUDA device the script fails and prints no result.
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


def _fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


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

    from newtonkrylov_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load("stencil2d")
    rec = build.BUILD_LOG["stencil2d"]
    log(f"[build] stencil2d.cu -> {os.path.basename(rec['path'])} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in rec["log"].splitlines():
        if line.strip():
            log(f"[build] {line.strip()}")


def phase_kernels(torch):
    """K1/K2 against their plain versions; returns the n=2048 f32 results."""
    from newtonkrylov_tpu_torch.kernels import stencil2d as k

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    summary = {}
    for n in (N, 64):
        scale = LAM / (n + 1) ** 2
        for dt in (torch.float32, torch.float64):
            def rand(shift=0.0, absval=False):
                x = torch.randn((n, n), generator=gen, device=dev, dtype=dt)
                return k.aligned_wrap(x.abs() + shift if absval else x)

            v, w, u = rand(), rand(0.1, absval=True), rand()
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


def phase_flagship(torch, nkt, bratu2d, pass_name):
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    p = bratu2d.default_config(N, lam=LAM)
    u0 = bratu2d.initial_guess(N, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # entry()'s f32 u₀, handed over as its exact f64 value: the df32 state
    # starts as (u₀, 0) either way, and the f64 boundary returns hi + lo, the
    # full state, for the f64 residual check below
    u, info = nkt.newton_krylov_jit(
        bratu2d.residual_scaled, u0.to(torch.float64), p,
        algo="cg", tol_rel=1e-8, krylov_dtype=torch.float32,
        residual_df=bratu2d.residual_scaled_df,
        max_niter=20, M=fft_poisson(precision="high"),
        precond_refresh="once",
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fu, f0 = _true_residual(torch, bratu2d, u, u0, p)
    log(f"[flagship {pass_name}] n={N} f32 Krylov + df32 + DST(high): "
        f"solved={bool(info.solved)} outer={info.stats.outer_iterations} "
        f"inner={info.stats.inner_iterations} "
        f"floor_limited={bool(info.floor_limited)} wall={wall:.3f} s  "
        f"true |F|={fu:.4e} (limit {1e-8 * f0 + 1e-12:.4e})")
    if not bool(info.solved):
        raise AssertionError("flagship solve did not converge")
    if not (torch.isfinite(u).all() and tuple(u.shape) == (N, N)):
        raise AssertionError("flagship solve returned a malformed state")
    if not fu <= 1e-8 * f0 + 1e-12:
        raise AssertionError("flagship: f64 true residual above 1e-8·‖F₀‖")
    return info


def phase_breakdown(torch, nkt, bratu2d):
    """Where a 2048² solve spends its time: the cost of each component
    alone, and the device busy time of each whole solve (no asserts)."""
    from newtonkrylov_tpu_torch import df32
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    def wall_s(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    p = bratu2d.default_config(N, lam=LAM)
    u = bratu2d.initial_guess(N, dtype=torch.float32, device="cuda")
    ua, pa, _ = bratu2d.aligned_setup(N, lam=LAM, dtype=torch.float32,
                                      device="cuda")
    for tag, F, x, pp in (("flagship", bratu2d.residual_scaled, u, p),
                          ("aligned", bratu2d.residual_scaled_aligned, ua, pa)):
        lin = wall_s(lambda: nkt.JacobianOperator(F, x, pp))
        J = nkt.JacobianOperator(F, x, pp)
        log(f"[breakdown] {tag}: linearize {lin * 1e3:.2f} ms host wall; "
            f"matvec replay {_time_ms(lambda: J.mv(x)):.4f} ms per call, "
            f"device {_fmt_ms(_device_ms(lambda: J.mv(x)))}")
    J = nkt.JacobianOperator(bratu2d.residual_scaled, u, p)
    build_s = wall_s(lambda: fft_poisson(precision="high")(J))
    M = fft_poisson(precision="high")(J)
    log(f"[breakdown] DST preconditioner: factory {build_s * 1e3:.2f} ms host "
        f"wall; apply {_time_ms(lambda: M(u), 10):.4f} ms per call, device "
        f"{_fmt_ms(_device_ms(lambda: M(u), 10))}")
    ud = df32.df_from_f64(u)
    log(f"[breakdown] df32 residual: {_time_ms(lambda: bratu2d.residual_scaled_df(ud, p), 10):.4f}"
        f" ms per call, device "
        f"{_fmt_ms(_device_ms(lambda: bratu2d.residual_scaled_df(ud, p), 10))}; "
        f"floor_estimate {wall_s(lambda: df32.floor_estimate(bratu2d.residual_scaled, u, p)) * 1e3:.2f}"
        f" ms host wall")
    for tag, run in (("flagship", lambda: phase_flagship(torch, nkt, bratu2d, "profiled")),
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import newtonkrylov_tpu_torch as nkt
    from newtonkrylov_tpu_torch.kernels import stencil2d as k
    from newtonkrylov_tpu_torch.problems import bratu2d

    phase_environment(torch)
    summary = phase_kernels(torch)
    phase_selfcheck(torch)

    # the main path, counted: every launch from here to the read is the solves'
    k.reset_launch_counts()
    info_a = phase_aligned(torch, nkt, bratu2d, "run")
    phase_flagship(torch, nkt, bratu2d, "run")
    launches = dict(k.LAUNCHES)
    log(f"[launches] main path: {launches}")
    if launches["stencil_jvp"] < info_a.stats.inner_iterations:
        raise AssertionError("K1 launched fewer times than the aligned "
                             "solve's inner iterations")
    if launches["bratu_residual"] <= 0:
        raise AssertionError("K2 was never launched by the main path")

    # warm repeats (first-use costs paid) and the small-size cross-check
    phase_aligned(torch, nkt, bratu2d, "warm")
    phase_flagship(torch, nkt, bratu2d, "warm")
    phase_aligned_small(torch, nkt, bratu2d)
    phase_breakdown(torch, nkt, bratu2d)

    src = "newtonkrylov_tpu_torch/csrc/stencil2d.cu"
    replaces = {"stencil_jvp": "newtonkrylov_tpu/kernels/stencil2d.py:244",
                "bratu_residual": "newtonkrylov_tpu/kernels/stencil2d.py:482"}
    kernels = []
    for name in ("stencil_jvp", "bratu_residual"):
        err, ms, plain_ms = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces[name], "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
