"""Cost-model probe of the chained stencil on the card (K6).

Counterpart of the JAX probe ``benchmarks/kernel_probe.py``: the same
variants under the same names, the same sizes and the same timing
discipline, with the steps run by the CUDA kernel K6
(:func:`~newtonkrylov_tpu_torch.kernels.probe.chain_call`).  Each variant
runs k dependent steps in one launch, which prices per step:

* elementwise arithmetic (chains of 2, 4 and 8 multiplies);
* a shift along a row (axis 0) or a column (axis 1);
* a carried state against a ping-pong state: on the card a carried
  multiply chain stays in registers, while a carried neighbour-reading step
  pays one copy and one more grid sync per step (``csrc/chain_probe.cu``);
* four formulations of the stencil step.

Timing: chain differencing, (best of ``REPEATS`` at ``KL`` steps − best at
``KS``) / (KL − KS), each call between CUDA events and followed by
``torch.cuda.synchronize()``, inputs perturbed per repeat.  Run on a
machine with a CUDA card, from the repository root:

    python -m newtonkrylov_tpu_torch.benchmarks.kernel_probe [NAME ...]

Arguments select the variants whose names contain one of them.  ``KP_N``
sets the interior size: 1024 (default; chains of 4000 and 400 steps) or
2048 (2000 and 200).
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
from typing import NamedTuple

import torch

from ..kernels import probe as kp
from ..kernels.stencil2d import aligned_wrap
from ..utils import default_device

__all__ = ["VARIANTS", "REPEATS", "Timing", "chain_lengths", "inputs",
           "time_variant", "run", "cost_model", "card", "main"]

REPEATS = 4

# (name, step, keyword arguments of chain_call), in the order of the JAX
# probe's main()
VARIANTS = (
    ("mul x2", kp.muls(2), {}),
    ("mul x4", kp.muls(4), {}),
    ("mul x8", kp.muls(8), {}),
    ("mul x2 pingpong", kp.muls(2), {"pingpong": True}),
    ("mul x4 pingpong", kp.muls(4), {"pingpong": True}),
    ("mul x8 pingpong", kp.muls(8), {"pingpong": True}),
    ("roll sublane x1 (+mul)", kp.roll_chain(0, 1), {}),
    ("roll sublane x4 (+mul)", kp.roll_chain(0, 4), {}),
    ("roll lane x1 (+mul)", kp.roll_chain(1, 1), {}),
    ("roll lane x4 (+mul)", kp.roll_chain(1, 4), {}),
    ("stencil minimal pingpong", kp.MIN_BUILD, {"pingpong": True}),
    ("stencil r1 formulation", kp.CUR_BUILD, {}),
    ("stencil hoisted+fused", kp.OPT_BUILD, {}),
    ("stencil hoisted pingpong", kp.OPT_BUILD, {"pingpong": True}),
    ("stencil hoisted pingpong u2", kp.OPT_BUILD, {"pingpong": True, "unroll": 2}),
    ("stencil hoisted pingpong u4", kp.OPT_BUILD, {"pingpong": True, "unroll": 4}),
    ("stencil rolls->muls pingpong", kp.NOROLL_BUILD, {"pingpong": True}),
    ("stencil r1 pingpong", kp.CUR_BUILD, {"pingpong": True}),
    ("roll sublane x1 pingpong", kp.roll_chain(0, 1), {"pingpong": True}),
    ("roll lane x1 pingpong", kp.roll_chain(1, 1), {"pingpong": True}),
)


class Timing(NamedTuple):
    us_per_step: float
    out: torch.Tensor  # output of the last timed call of the long chain
    v: torch.Tensor    # the (perturbed) input of that call


def chain_lengths(n: int):
    """(KL, KS): 4000 and 400 steps up to n = 1024, else 2000 and 200."""
    return (4000, 400) if n <= 1024 else (2000, 200)


def inputs(n: int, device=None):
    """(v, w): 0.1 and 0.9 on the interior of the aligned layout, as the JAX
    probe's, on ``device`` (by default the card)."""
    f32 = dict(dtype=torch.float32, device=device or default_device())
    return (aligned_wrap(torch.full((n, n), 0.1, **f32)),
            aligned_wrap(torch.full((n, n), 0.9, **f32)))


def time_variant(name, step, v, w, kl, ks, **kw) -> Timing:
    """µs per step of one variant by chain differencing on the card."""
    def call(x, k):
        return kp.chain_call(step, x, w, k, **kw)

    call(v, ks)
    call(v, kl)
    torch.cuda.synchronize()

    def best(k):
        times, out, vr = [], None, None
        for r in range(REPEATS):
            vr = v * (1.0 + 1e-5 * (r + 1))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = call(vr, k)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return min(times), out, vr

    t_long, out, vr = best(kl)
    t_short, _, _ = best(ks)
    us = (t_long - t_short) / (kl - ks) * 1e3
    print(f"{name:34s} {us:8.3f} us/step", flush=True)
    return Timing(us, out, vr)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def run(n: int = 1024, select=None) -> dict:
    """Time every variant (or those whose names contain one of ``select``)
    at interior size n; returns {name: Timing}."""
    kl, ks = chain_lengths(n)
    v, w = inputs(n)
    R, C = v.shape
    print(f"device: {torch.cuda.get_device_name(0)} ({card()})")
    print(f"array: {R}x{C} f32 = {R * C * 4 / 2**20:.1f} MiB; chains of "
          f"{kl} and {ks} steps, best of {REPEATS}")
    return {name: time_variant(name, step, v, w, kl, ks, **kw)
            for name, step, kw in VARIANTS
            if select is None or any(s in name for s in select)}


def cost_model(timings: dict) -> dict:
    """Print the cost-model block from µs per step; returns its numbers."""
    t = {name: timings[name].us_per_step if name in timings else math.nan
         for name, _, _ in VARIANTS}
    model = {
        "per_mul_us": (t["mul x8"] - t["mul x4"]) / 4,
        "row_shift_us": (t["roll sublane x4 (+mul)"] - t["roll sublane x1 (+mul)"]) / 3,
        "column_shift_us": (t["roll lane x4 (+mul)"] - t["roll lane x1 (+mul)"]) / 3,
        "roll_overhead_us": t["stencil hoisted pingpong"] - t["stencil rolls->muls pingpong"],
        "copy_sync_stencil_us": t["stencil hoisted+fused"] - t["stencil hoisted pingpong"],
        "copy_sync_row_us": t["roll sublane x1 (+mul)"] - t["roll sublane x1 pingpong"],
        "copy_sync_column_us": t["roll lane x1 (+mul)"] - t["roll lane x1 pingpong"],
        "memory_step_us": {m: t[f"mul x{m} pingpong"] - t[f"mul x{m}"] for m in (2, 4, 8)},
    }
    print("\n--- cost model ---")
    print(f"per-mul: {model['per_mul_us']:.3f} us (marginal x4->x8, carried in "
          f"registers); fixed/step ~ {t['mul x2'] - 2 * model['per_mul_us']:.3f} us")
    print(f"row shift (axis 0, 'sublane'): {model['row_shift_us']:.3f} us; column "
          f"shift (axis 1, 'lane'): {model['column_shift_us']:.3f} us")
    print(f"roll overhead in stencil (pingpong): {model['roll_overhead_us']:.3f} us")
    print(f"pingpong 1-roll: row {t['roll sublane x1 pingpong']:.3f} column "
          f"{t['roll lane x1 pingpong']:.3f}")
    print(f"r1 {t['stencil r1 formulation']:.3f} -> hoisted "
          f"{t['stencil hoisted+fused']:.3f} -> pingpong "
          f"{t['stencil hoisted pingpong']:.3f} (r1+pingpong "
          f"{t['stencil r1 pingpong']:.3f})")
    print(f"copy + grid sync per step (carry - pingpong): stencil hoisted "
          f"{model['copy_sync_stencil_us']:.3f} us, row roll "
          f"{model['copy_sync_row_us']:.3f} us, column roll "
          f"{model['copy_sync_column_us']:.3f} us")
    print("step through memory (mul pingpong - mul carried in registers): "
          + ", ".join(f"x{m} {us:.3f} us" for m, us in model["memory_step_us"].items()))
    print(f"card: {card()}")
    return model


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device; the probe runs only on a GPU",
              file=sys.stderr)
        return 2
    argv = sys.argv[1:] if argv is None else argv
    n = int(os.environ.get("KP_N", "1024"))
    cost_model(run(n, select=argv or None))
    return 0


if __name__ == "__main__":
    sys.exit(main())
