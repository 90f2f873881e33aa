"""Double-float ("df32") arithmetic: ~f64 accuracy from paired f32.

Counterpart of ``newtonkrylov_tpu/df32.py``: the double-word arithmetic,
the stencil combinators, the double-word matrix–vector product
(:func:`df_matvec`), the self-check and the floor estimate.  A df32 value
is a pair ``(hi, lo)`` of same-shape float32 tensors with
``hi = fl(hi + lo)``; it represents ``hi + lo`` with ~49 effective mantissa
bits.  The Newton driver's ``residual_df`` path evaluates the acceptance
residual in this arithmetic, so ‖F‖ can be driven to 1e-8·‖F₀‖ while the
state is carried as float32 words.

.. warning:: **Strict IEEE float32 arithmetic only.**  The error-free
   transforms (``two_sum``, ``two_prod``) break under contraction
   (``a·b + c`` → FMA) and reassociation.  Everything here is eager
   elementwise ``+ − ×``: no ``addcmul``/``lerp``/fused ops and no
   ``torch.compile``.  :func:`selfcheck` detects a value-breaking backend
   at run time; run it on every device a solve uses.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .exportable import jvp as _jvp
from .tree import tree_map, tree_norm
from .utils import default_device

__all__ = [
    "DF", "two_sum", "fast_two_sum", "two_prod",
    "df_from_f64", "df_to_f64", "df_from_f32", "tree_add_f32",
    "add", "add_f32", "neg", "sub", "mul", "mul_f32", "exp", "norm_hi",
    "df_map", "shift", "neighbor_sum", "scale_pow2", "scale_const", "ln_split",
    "scaled_exp",
    "df_matvec", "selfcheck", "floor_estimate",
]


class DF(NamedTuple):
    """A double-float tensor: represents ``hi + lo``, normalized."""

    hi: torch.Tensor
    lo: torch.Tensor


def two_sum(a, b):
    """Error-free transform: a+b = s+e exactly (Knuth, 6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free a+b = s+e, REQUIRES |a| >= |b| (Dekker, 3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


_SPLIT = 4097.0  # 2^12 + 1 for f32 (24-bit mantissa -> 12/12 split)


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a·b = p+e exactly (Dekker splitting, no FMA)."""
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def df_from_f64(x) -> DF:
    """Split an f64 state (tensor or tuple) into a normalized df32 pair.

    Also accepts f32 input (lo = 0).
    """
    hi = tree_map(lambda l: l.to(torch.float32), x)
    lo = tree_map(lambda l, h: (l - h.to(l.dtype)).to(torch.float32), x, hi)
    return DF(hi, lo)


def df_to_f64(x: DF):
    return tree_map(lambda h, l: h.to(torch.float64) + l.to(torch.float64),
                    x.hi, x.lo)


def df_from_f32(x) -> DF:
    return DF(x, tree_map(torch.zeros_like, x))


def tree_add_f32(u: DF, t) -> DF:
    """u + t, t a plain-f32 tensor (exact two-sum update, ~10 flops).

    The refined Newton step ``u ← u − d`` with a df32-carried state.
    """
    s, e = two_sum(u.hi, t)
    e = e + u.lo
    return DF(*fast_two_sum(s, e))


def add(a: DF, b: DF) -> DF:
    """Double-word + double-word (accurate variant, ~20 flops)."""
    s, e = two_sum(a.hi, b.hi)
    t, f = two_sum(a.lo, b.lo)
    e = e + t
    s, e = fast_two_sum(s, e)
    e = e + f
    return DF(*fast_two_sum(s, e))


def add_f32(a: DF, b) -> DF:
    """Double-word + single f32 (~10 flops)."""
    s, e = two_sum(a.hi, b)
    e = e + a.lo
    return DF(*fast_two_sum(s, e))


def neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def sub(a: DF, b: DF) -> DF:
    return add(a, neg(b))


def mul(a: DF, b: DF) -> DF:
    """Double-word × double-word (~25 flops)."""
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    return DF(*fast_two_sum(p, e))


def mul_f32(a: DF, b) -> DF:
    """Double-word × single f32."""
    p, e = two_prod(a.hi, b)
    e = e + a.lo * b
    return DF(*fast_two_sum(p, e))


# -- exp ----------------------------------------------------------------------
# Range reduction x = k·ln2 + r, |r| ≤ ln2/2, with ln2 split so k·LN2_HI is
# exact for |k| < 2^11; e^r by a degree-12 Taylor polynomial in df32; scale by
# 2^k through the exponent field.  The constants are float32 values held as
# Python floats, so a multiply by them rounds as the float32 multiply does.

_LN2_HI = float(np.float32(0.693145751953125))
_LN2_LO = float(np.float32(1.4286068203094172e-06))
_INV_LN2 = float(np.float32(1.4426950408889634))

# 1/n! for n = 2..12, each as a df32 (hi, lo) pair
_FACT_INV = []
for _n in range(2, 13):
    _c = 1.0 / math.factorial(_n)
    _chi = np.float32(_c)
    _FACT_INV.append((float(_chi), float(np.float32(_c - float(_chi)))))
del _n, _c, _chi


def _ldexp(x, k):
    """x · 2^k for an int32 tensor k within the float32 exponent range: the
    biased exponent bit pattern viewed as float32."""
    bits = ((k + 127) << 23).to(torch.int32)
    return x * bits.view(torch.float32)


def exp(a: DF) -> DF:
    """Double-word e^a (elementwise)."""
    x = a.hi + a.lo
    k = torch.round(x * _INV_LN2)
    ki = k.to(torch.int32)
    # r = a - k·ln2, exactly in df32 (k·LN2_HI exact; LN2_LO correction dd)
    r = add(a, DF(-k * _LN2_HI, -k * _LN2_LO))

    # e^r = 1 + r·(1 + r·P(r)), P(r) = 1/2! + r/3! + … + r¹⁰/12! (Horner)
    chi, clo = _FACT_INV[-1]
    acc = DF(torch.full_like(r.hi, chi), torch.full_like(r.hi, clo))
    for chi, clo in reversed(_FACT_INV[:-1]):
        acc = add(mul(acc, r), DF(torch.full_like(r.hi, chi),
                                  torch.full_like(r.hi, clo)))
    acc = add_f32(mul(acc, r), 1.0)    # 1 + r·P
    acc = mul(acc, r)                  # r + r²·P
    acc = add_f32(acc, 1.0)            # 1 + r + r²·P

    ki = torch.clamp(ki, -126, 126)
    return DF(_ldexp(acc.hi, ki), _ldexp(acc.lo, ki))


# -- stencil combinators --------------------------------------------------------


def df_map(fn, a: DF) -> DF:
    """Apply a structurally exact tensor op (pad, slice, reshape, concat,
    transpose, negation) to both words.  An op that rounds (a general
    scaling, a sum of elements) breaks the normalized pair: use the df32
    arithmetic for those."""
    return DF(fn(a.hi), fn(a.lo))


def shift(up: DF, *offsets: int) -> DF:
    """Interior view of a ghost-padded block, shifted by ``offsets``
    (pure slicing, exact on both words): ``shift(up, 1, 0)`` is the df32
    analogue of ``up[2:, 1:-1]``."""
    def sl(w):
        ix = tuple(slice(1 + o, w.shape[ax] - 1 + o)
                   for ax, o in enumerate(offsets))
        return w[ix]

    return DF(sl(up.hi), sl(up.lo))


def neighbor_sum(up: DF, offsets) -> DF:
    """Σ of unit-coefficient shifts of a padded block in exact two-sum
    chains, e.g. the five-point ``[(1, 0), (-1, 0), (0, 1), (0, -1)]``."""
    terms = [shift(up, *off) for off in offsets]
    s = terms[0]
    for t in terms[1:]:
        s = add(s, t)
    return s


# Host-constant helpers: results depend only on their float arguments, so a
# traced residual (an exported solve's loop body) takes them as constants.
@torch.compiler.assume_constant_result
def _f32(x: float) -> float:
    """x rounded to float32, as a Python float."""
    return float(np.float32(x))


@torch.compiler.assume_constant_result
def _is_pow2(f: float) -> bool:
    m, _ = math.frexp(f)
    return m in (0.5, -0.5) or f == 0.0


def scale_pow2(a: DF, c) -> DF:
    """c·a for a power-of-two constant — exact on both words."""
    f = float(c)
    if not _is_pow2(f):
        raise ValueError(f"{c} is not a power of two")
    return DF(f * a.hi, f * a.lo)


def scale_const(a: DF, c: float) -> DF:
    """c·a for a general host constant: c split into an (hi, lo) float32
    pair, a double-word multiply, returned without the final renormalizing
    ``fast_two_sum`` (the JAX package's choice: every consumer starts with an
    exact ``two_sum``, and XLA:CPU reassociates that last step away)."""
    chi = _f32(float(c))
    clo = _f32(float(c) - chi)
    p, e = two_prod(a.hi, torch.tensor(chi, dtype=torch.float32,
                                       device=a.hi.device))
    e = e + (a.hi * clo + a.lo * chi)
    return DF(p, e)


def ln_split(c: float):
    """``(lnc_hi, lnc_lo, negative)``: ln|c| of a host constant c ≠ 0 as a
    float32 (hi, lo) pair, and whether c < 0 — how :func:`scaled_exp` takes
    its constant (the Bratu kernel K7 is handed the same three)."""
    cf = float(c)
    if cf == 0.0:
        raise ValueError("scaled_exp needs a nonzero constant")
    lnc = math.log(abs(cf))
    lnc_hi = _f32(lnc)
    return lnc_hi, _f32(lnc - lnc_hi), cf < 0


def scaled_exp(a: DF, c: float) -> DF:
    """c·eᵃ for a host constant c ≠ 0, computed as ±e^(a + ln|c|): the
    constant enters through an exact df32 add in the exponent, never as an
    ``x·c_hi + x·c_lo`` pattern."""
    lnc_hi, lnc_lo, negative = ln_split(c)
    out = exp(add(a, DF(torch.full_like(a.hi, lnc_hi),
                        torch.full_like(a.hi, lnc_lo))))
    return neg(out) if negative else out


def _comp_sum_last(P, E):
    """Compensated tree sum of ``P`` along the last axis: a two_sum at every
    level keeps the running sum error-free, and the error terms fold into
    ``E`` with plain adds (each ≤ εΣ|P|, so their own rounding is
    O(ε²Σ|P|)).  The axis is zero-padded to a power of two.  Returns
    ``(s, e)`` with Σ = s + e to ~2⁻⁴⁶."""
    n = P.shape[-1]
    n2 = 1 << max(n - 1, 1).bit_length()
    if n2 != n:
        P = torch.nn.functional.pad(P, (0, n2 - n))
        E = torch.nn.functional.pad(E, (0, n2 - n))
    while P.shape[-1] > 1:
        m = P.shape[-1] // 2
        s, e = two_sum(P[..., :m], P[..., m:])
        E = E[..., :m] + E[..., m:] + e
        P = s
    return P[..., 0], E[..., 0]


def df_matvec(A: DF, x: DF) -> DF:
    """y = A @ x in double-float, for dense-operator residuals (heat1d_dg's
    ``D1m @ (D1p @ u)``).

    ``A`` is a df32 split (n, m) of the matrix (:func:`df_from_f64`), ``x``
    a df32 vector of length m.  The hi×hi products are exact
    (:func:`two_prod`) and summed by :func:`_comp_sum_last`; the hi×lo and
    lo×hi cross terms, ~ε relative to the main term, are full-f32 matrix
    products (the JAX package runs them at ``Precision.HIGHEST``), so this
    raises while TF32 is allowed (ROADMAP.md Queue 3 hazard (a)).
    """
    from .fftprec import _check_matmul_precision

    _check_matmul_precision()
    P, E = two_prod(A.hi, x.hi[None, :])
    s, e = _comp_sum_last(P, E)
    small = e + (torch.mv(A.hi, x.lo) + torch.mv(A.lo, x.hi))
    return DF(*fast_two_sum(s, small))


def selfcheck(device=None) -> bool:
    """True iff ``device`` (by default the card) preserves the error-free
    transforms.

    Runs the known-dangerous pattern (two products sharing a factor, summed
    by two_sum) on ``device`` and compares the value against a strict
    host-side IEEE evaluation.  A backend that contracts or folds the
    pattern loses all of the c2 product (~1e-10 here); a strict one stays
    within an ulp of the tiny e word (~1e-17), so the threshold sits at 1%
    of the c2 contribution.
    """
    c1 = np.float32(0.00118305636)
    c2 = np.float32(0.00118305636 - float(c1))
    xn = np.linspace(1.0, 4.0, 64, dtype=np.float32)
    x = torch.from_numpy(xn).to(device or default_device())
    s, e = two_sum(x * float(c1), x * float(c2))
    a = (xn * c1).astype(np.float32).astype(np.float64)
    b = (xn * c2).astype(np.float32).astype(np.float64)
    got = (s.cpu().numpy().astype(np.float64)
           + e.cpu().numpy().astype(np.float64))
    return bool(np.max(np.abs(got - (a + b))) < 0.01 * np.max(np.abs(b)))


# The JAX package's measured probe/plateau ratio on the 2-D Bratu flagship
# (6.28–6.38× over 512²–4096² on a TPU); dividing by 4 places the estimate
# at ~1.6× the plateau.  On an NVIDIA H100 80GB HBM3 at its 700.00 W power
# limit the port measured 6.326, 6.314, 6.319 and 6.284 at 512², 1024²,
# 2048² and 4096² (benchmarks/floor_probe.py, plateaus 1.152e-12 to
# 9.265e-12): the same calibration holds there.  Kept identical so both
# packages clamp at the same tolerance.
_RND_PROBE_CALIBRATION = 4.0


def floor_estimate(F, u_hi, p=None, space=None, jvp_graph=None):
    """Acceptance floor of a df32-carried solve at state ``u_hi``.

    ``‖J(u)·(±ε_dd·|u|)‖ / 4`` with ε_dd = 2⁻⁴⁷ and signs alternating along
    the last axis and, separately, along the first axis (the larger
    response is kept) — two forward-mode tangents of the plain residual
    ``F`` in the Krylov dtype.  See the JAX package's ``floor_estimate`` for
    the measurements behind the design.  A zero state returns 0.
    ``jvp_graph`` is the J·v graph an export traced ahead of its loops
    (:func:`~newtonkrylov_tpu_torch.exportable.jvp`).
    """
    def sign_leaf(h, last: bool):
        shape = tuple(h.shape) if h.dim() else (1,)
        axis = len(shape) - 1 if last else 0
        view = [1] * len(shape)
        view[axis] = shape[axis]
        i = torch.arange(shape[axis], device=h.device).reshape(view)
        s = (1 - 2 * (i % 2)).expand(shape).to(h.dtype)
        return s.reshape(h.shape)

    def response(last: bool):
        delta = tree_map(lambda h: h.abs() * 2.0 ** -47 * sign_leaf(h, last),
                         u_hi)
        jd = _jvp(F, u_hi, p, delta, jvp_graph)
        return tree_norm(jd) if space is None else space.norm(jd)

    nrm = torch.maximum(response(True), response(False))
    return nrm / _RND_PROBE_CALIBRATION


def norm_hi(r: DF):
    """f32 2-norm of a df32 residual's hi word."""
    return torch.linalg.vector_norm(r.hi)
