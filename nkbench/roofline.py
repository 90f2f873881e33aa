"""Frozen roofline arithmetic: operations, bytes and the card's peaks.

A kernel's share of its roofline is the least time the card could take
for the work the algorithm needs — the larger of its operations over the
peak operation rate and its bytes over the peak bandwidth — over the time
the kernel took.  Operations are the algorithm's floating-point operations,
a multiply-add counted as two; bytes are each input read once and each
output written once.  Both are counted on the n × n interior the algorithm
works on, not on the padded layout a kernel may store it in.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit.
"""

from __future__ import annotations

from typing import NamedTuple

PEAK_F32_FLOPS = 67.0e12   # float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # HBM3


class Bound(NamedTuple):
    flops: float
    bytes: float
    seconds: float   # the larger of the two bounds
    bound_by: str    # "operations" or "bytes"


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS,
          peak_bytes: float = PEAK_BYTES) -> Bound:
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
    if t_ops >= t_bytes:
        return Bound(flops, nbytes, t_ops, "operations")
    return Bound(flops, nbytes, t_bytes, "bytes")


def chebyshev_apply(n: int, degree: int, itemsize: int = 4) -> Bound:
    """K4: ``x = p_degree(A)·r`` on an n × n interior by the three-term
    recurrence, ``A v = o·(up + dn + left + right + diag·v)``.

    Per cell: ``d₀ = r/θ`` (1); each of ``degree`` steps
    ``r ← r − o·((((up + dn) + left) + right) + diag·d)`` (7),
    ``d ← c_d·d + c_r·r`` (3) and ``x ← x + d`` (1).  Reads ``r`` and
    ``diag`` and writes ``x``."""
    cells = n * n
    flops = cells * (1 + 11 * degree)
    nbytes = 3 * cells * itemsize
    return bound(flops, nbytes)


def share_pct(b: Bound, measured_s: float) -> float:
    """The roofline share in percent of a call that took ``measured_s``."""
    return 100.0 * b.seconds / measured_s
