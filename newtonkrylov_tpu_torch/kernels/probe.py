"""The chained-step cost probe (K6): k dependent probe steps in one launch.

Counterpart of ``_chain_call`` in the JAX probe
``benchmarks/kernel_probe.py``, a Pallas kernel that runs k dependent steps
of a pluggable step with its state resident in VMEM, to price each
ingredient of the chained stencil per step.  A step is named by one of the
JAX probe's step builders and its parameters:

* :func:`muls` ``(n)`` — n multiplies by ``f32(0.999 + 1e-4·i)``;
* :func:`roll_chain` ``(axis, nrolls)`` — nrolls wrap-around shifts along
  ``axis``, alternately by +1 and by ``dim − 1``, each followed by a
  multiply by ``f32(0.9999)``;
* :data:`CUR_BUILD`, :data:`OPT_BUILD`, :data:`NOROLL_BUILD`,
  :data:`MIN_BUILD` — the four stencil formulations.

Arrays are (R, C) float32 in the aligned layout of an interior of size
``n = R − 8``; the stencils use the probe's own mask
``(rows < n) & (1 ≤ cols ≤ n)``.  ``pingpong=False`` runs k steps of a
carried state; ``pingpong=True`` runs ``2·unroll·⌊k / (2·unroll)⌋`` steps,
the count of the JAX probe's body loop.

:func:`chain_call` launches the CUDA kernel (``csrc/chain_probe.cu``) on a
CUDA tensor and runs :func:`chain_call_xla`, its plain version, on a CPU
tensor; ``LAUNCHES["chain_call"]`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

__all__ = [
    "muls",
    "roll_chain",
    "CUR_BUILD",
    "OPT_BUILD",
    "NOROLL_BUILD",
    "MIN_BUILD",
    "STEPS",
    "chain_call_xla",
    "chain_call",
    "steps_run",
    "LAUNCHES",
    "reset_launch_counts",
]

CUR_BUILD = "cur_build"
OPT_BUILD = "opt_build"
NOROLL_BUILD = "noroll_build"
MIN_BUILD = "min_build"

# The kernel's step index is the position in this tuple (csrc/chain_probe.cu).
STEPS = ("muls2", "muls4", "muls8", "roll0x1", "roll0x4", "roll1x1",
         "roll1x4", CUR_BUILD, OPT_BUILD, NOROLL_BUILD, MIN_BUILD)

LAUNCHES = {"chain_call": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def muls(nops: int) -> str:
    """The step of ``nops`` multiplies (2, 4 or 8)."""
    return _checked(f"muls{nops}")


def roll_chain(axis: int, nrolls: int) -> str:
    """The step of ``nrolls`` (1 or 4) shifts along ``axis`` (0 or 1)."""
    return _checked(f"roll{axis}x{nrolls}")


def _checked(step: str) -> str:
    if step not in STEPS:
        raise ValueError(f"unknown probe step {step!r}; known: {STEPS}")
    return step


def _f32(c: float) -> float:
    """``c`` rounded to float32 once, as ``jnp.asarray(c, float32)`` and a
    weak-typed scalar against a float32 array do."""
    return float(np.float32(c))


_SCALE = 0.125
_ROLL_MUL = _f32(0.9999)
_NOROLL = (_f32(1.0001), _f32(0.9999), _f32(1.0002), _f32(0.9998))


def _step_fn(step: str, w, shape):
    """The JAX probe's ``step_builder(w, shape)``: the step as a function of
    the state, its invariants built once."""
    R, C = shape
    n = R - 8
    rows = torch.arange(R, device=w.device)[:, None]
    cols = torch.arange(C, device=w.device)[None, :]
    mask = (rows < n) & (cols >= 1) & (cols <= n)
    masks = mask.to(torch.float32) * _SCALE

    def shifts(x):  # up, dn, left, right, as pltpu.roll by 1 and by dim − 1
        return (torch.roll(x, 1, 0), torch.roll(x, R - 1, 0),
                torch.roll(x, 1, 1), torch.roll(x, C - 1, 1))

    if step.startswith("muls"):
        cs = [_f32(0.999 + 1e-4 * i) for i in range(int(step[4:]))]

        def fn(x):
            for c in cs:
                x = x * c
            return x

    elif step.startswith("roll"):
        axis, nrolls = int(step[4]), int(step[6:])
        dim = shape[axis]

        def fn(x):
            for i in range(nrolls):
                x = torch.roll(x, 1 if i % 2 == 0 else dim - 1, axis) * _ROLL_MUL
            return x

    elif step == CUR_BUILD:
        zero = w.new_zeros(())

        def fn(x):
            up, dn, left, right = shifts(x)
            out = up + dn + left + right + (w - 4.0) * x
            return torch.where(mask, out * _SCALE, zero)

    elif step == OPT_BUILD:
        wm4 = w - 4.0

        def fn(x):
            up, dn, left, right = shifts(x)
            return masks * (((up + dn) + (left + right)) + wm4 * x)

    elif step == NOROLL_BUILD:
        wm4 = w - 4.0
        c_up, c_dn, c_left, c_right = _NOROLL

        def fn(x):
            up, dn, left, right = x * c_up, x * c_dn, x * c_left, x * c_right
            return masks * (((up + dn) + (left + right)) + wm4 * x)

    else:  # MIN_BUILD
        wm4s = masks * (w - 4.0)

        def fn(x):
            up, dn, left, right = shifts(x)
            return masks * ((up + dn) + (left + right)) + wm4s * x

    return fn


def steps_run(k: int, pingpong: bool = False, unroll: int = 1) -> int:
    """The number of steps a call runs: k carried, or the ping-pong body
    loop's ``2·unroll·⌊k / (2·unroll)⌋``."""
    return 2 * unroll * (k // (2 * unroll)) if pingpong else k


def _check_args(step, v, w, k, unroll):
    _checked(step)
    for a in (v, w):
        if a.dtype != torch.float32:
            raise ValueError(f"chain_call: expected float32 tensors, got {a.dtype}")
    if v.dim() != 2 or v.shape != w.shape or v.shape[0] <= 8:
        raise ValueError(f"chain_call: expected two (R, C) arrays of one shape "
                         f"with R > 8, got {tuple(v.shape)} and {tuple(w.shape)}")
    if k < 0 or unroll < 1:
        raise ValueError(f"chain_call: need k ≥ 0 and unroll ≥ 1, got k={k}, "
                         f"unroll={unroll}")


def chain_call_xla(step: str, v, w, k: int, pingpong: bool = False,
                   unroll: int = 1):
    """Plain version of K6: the steps of :func:`chain_call` from ``x = v``,
    each written as the JAX probe writes it (association order, float32
    constants, ``torch.roll`` for ``pltpu.roll``)."""
    _check_args(step, v, w, k, unroll)
    fn = _step_fn(step, w, tuple(v.shape))
    x = v.clone()
    for _ in range(steps_run(k, pingpong, unroll)):
        x = fn(x)
    return x


_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])
_BOUND: dict = {}


def _kernel():
    fn = _BOUND.get("chain_call")
    if fn is None:
        fn = build.load("chain_probe").nk_chain_call
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _BOUND["chain_call"] = fn
    return fn


def chain_call(step: str, v, w, k: int, pingpong: bool = False,
               unroll: int = 1):
    """K6: k chained probe steps of ``step`` from ``x = v`` in one launch
    (see :func:`chain_call_xla` for the arithmetic).  float32 only; ``v``
    is not modified."""
    _check_args(step, v, w, k, unroll)
    if v.device.type == "cpu" and w.device.type == "cpu":
        return chain_call_xla(step, v, w, k, pingpong, unroll)
    if v.device.type != "cuda" or w.device != v.device:
        raise ValueError(f"chain_call: expected CUDA tensors on one device, "
                         f"got {v.device} and {w.device}")
    if not (v.is_contiguous() and w.is_contiguous()):
        raise ValueError("chain_call: expected contiguous tensors")
    R, C = v.shape
    out = torch.empty_like(v)
    scratch = torch.empty_like(v)
    fn = _kernel()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = fn(STEPS.index(step), v.data_ptr(), w.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), R, C, R - 8, int(k), int(bool(pingpong)),
                int(unroll), stream)
    if rc != 0:
        raise RuntimeError(f"chain_call: CUDA kernel launch failed "
                           f"(cudaError_t {rc})")
    LAUNCHES["chain_call"] += 1
    return out
