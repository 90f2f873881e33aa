"""The Kelley 2×2 nonlinear system.

Counterpart of ``newtonkrylov_tpu/problems/simple.py``:
``F(x) = [x₁² + x₂² − 2,  e^{x₁−1} + x₂² − 2]``, with its root at (1, 1)
(another root lies near (−0.478, 1.331)), the documented starting points
and the tuned forcing ``EisenstatWalker(eta_max=TUNED_ETA_MAX)`` for the
third of them.
"""

from __future__ import annotations

import torch

from .. import df32 as dd

__all__ = ["residual", "residual_df", "STARTS", "TUNED_ETA_MAX", "ROOT"]

ROOT = (1.0, 1.0)
STARTS = ([2.0, 0.5], [2.5, 3.0], [3.0, 4.0], [3.0, 5.0])
TUNED_ETA_MAX = 0.68949


def residual(x, p=None):
    return torch.stack([
        x[0] * x[0] + x[1] * x[1] - 2.0,
        torch.exp(x[0] - 1.0) + x[1] * x[1] - 2.0,
    ])


def residual_df(x, p=None):
    """df32 residual (``x`` a DF pair): squares as double-word multiplies,
    the exponential through the df32 ``exp`` (its argument shifted by the
    exact −1), constants added by exact two-sums."""
    x0 = dd.df_map(lambda w: w[0:1], x)
    x1 = dd.df_map(lambda w: w[1:2], x)
    sq1 = dd.mul(x1, x1)
    r0 = dd.add_f32(dd.add(dd.mul(x0, x0), sq1), -2.0)
    r1 = dd.add_f32(dd.add(dd.exp(dd.add_f32(x0, -1.0)), sq1), -2.0)
    return dd.DF(torch.cat([r0.hi, r1.hi]), torch.cat([r0.lo, r1.lo]))
