"""Convert the JAX package's objects, given as numpy arrays, into the port's.

The two packages never share memory: tests hand a JAX result over as numpy
(``np.asarray(jax_array)``) and build the port's counterpart here, on an
explicit device and dtype.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..df32 import DF
from ..problems.bratu2d import Params
from ..spaces import MaskedSpace

__all__ = ["state", "df_pair", "params", "masked_space", "to_numpy"]


def state(a, *, device, dtype=None) -> torch.Tensor:
    """A state array (numpy or anything ``np.asarray`` takes) as a tensor.

    ``dtype=None`` keeps the array's own dtype.
    """
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def df_pair(hi, lo, *, device) -> DF:
    """A df32 pair from its two float32 words."""
    return DF(state(hi, device=device, dtype=torch.float32),
              state(lo, device=device, dtype=torch.float32))


def params(p) -> Params:
    """``bratu2d.Params`` from any object with ``dx`` and ``lam``."""
    return Params(dx=float(p.dx), lam=float(p.lam))


def masked_space(mask, *, device, dtype=None) -> MaskedSpace:
    """``MaskedSpace`` from a 0/1 mask array."""
    return MaskedSpace(state(mask, device=device, dtype=dtype))


def to_numpy(x):
    """A tensor as a numpy array; a DF pair as a ``(hi, lo)`` tuple."""
    if isinstance(x, DF):
        return (to_numpy(x.hi), to_numpy(x.lo))
    return x.detach().cpu().numpy()
