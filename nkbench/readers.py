"""Arithmetic shared by the metric readers of ``nkbench/metrics`` and
``nkbench/e2e``."""

from __future__ import annotations

import math

from . import roofline

K4_KERNEL = "cheb_pass"          # K4's kernel, by its name in the trace
K4_COUNTER = "launches.chebyshev_apply"


def mean_of(run, field: str):
    values = [getattr(r, field) for r in run.records]
    return sum(values) / len(values) if values else None


def p95_latency_ms(run):
    xs = sorted(r.latency_s for r in run.records)
    if not xs:
        return None
    run.log(f"[nkbench] served_p95_ms over {len(xs)} requests; median "
            f"{1e3 * xs[len(xs) // 2]:.3f} ms, max {1e3 * xs[-1]:.3f} ms")
    return 1e3 * xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def on_card(run, fn):
    """``fn(run)``, a device or host-clock replay: only on the card."""
    return fn(run) if run.cuda else None


def idle_pct(run):
    t = run.timeline
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def request_idle_pct(run):
    t = run.timeline
    if t is None or t.request_s <= 0:
        return None
    return 100.0 * (1.0 - t.request_busy_s / t.request_s)


def k4_roofline(run):
    t = run.timeline
    calls = run.counters.get(K4_COUNTER, 0)
    if t is None or calls == 0:
        return None
    seconds, events = t.kernel_seconds(K4_KERNEL)
    t.check_kernel(events, calls, K4_KERNEL)
    pre = run.config["recipe"]["precond"]["kwargs"]
    b = roofline.chebyshev_apply(run.n, int(pre["smoother_degree"]))
    per_call = seconds / calls
    share = roofline.share_pct(b, per_call)
    run.log(f"[k4] {calls} calls, {events} '{K4_KERNEL}' device events, "
            f"{1e3 * per_call:.4f} ms a call; bound {1e3 * b.seconds:.4f} ms "
            f"by {b.bound_by} ({b.flops:.4e} flops at "
            f"{roofline.PEAK_F32_FLOPS:.3e}/s, {b.bytes:.4e} bytes at "
            f"{roofline.PEAK_BYTES:.3e}/s): {share:.3f}%")
    return share
