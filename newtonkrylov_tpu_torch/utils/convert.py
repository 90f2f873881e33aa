"""Convert the JAX package's objects, given as numpy arrays, into the port's.

The two packages never share memory: tests hand a JAX result over as numpy
(``np.asarray(jax_array)``) and build the port's counterpart here, on an
explicit device and dtype.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..df32 import DF
from ..problems import heat1d, heat1d_dg, heat2d, spring
from ..problems.bratu2d import Params
from ..spaces import MaskedSpace
from ..timestep import StepParams
from .checkpointing import MarchCheckpoint

__all__ = ["state", "df_pair", "params", "heat2d_params", "heat1d_params",
           "spring_params", "heat1d_dg_params", "step_params",
           "march_checkpoint", "masked_space", "to_numpy"]


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


def heat2d_params(p) -> heat2d.Params:
    """``heat2d.Params`` from any object with ``a``, ``dx``, ``dy``, ``bc``."""
    return heat2d.Params(a=float(p.a), dx=float(p.dx), dy=float(p.dy),
                         bc=str(p.bc))


def heat1d_params(p) -> heat1d.Params:
    """``heat1d.Params`` from any object with ``a``, ``dx``, ``bc``."""
    return heat1d.Params(a=float(p.a), dx=float(p.dx), bc=str(p.bc))


def spring_params(p) -> spring.Params:
    """``spring.Params`` from any object with ``gamma``."""
    return spring.Params(gamma=float(p.gamma))


def heat1d_dg_params(p, *, device, dtype=None) -> heat1d_dg.Params:
    """``heat1d_dg.Params`` (the D₋/D₊ matrices and the nodes as tensors)
    from any object with array fields ``D1m``, ``D1p``, ``x``."""
    return heat1d_dg.Params(*(state(a, device=device, dtype=dtype)
                              for a in (p.D1m, p.D1p, p.x)))


def step_params(sp, p, *, device, dtype=None) -> StepParams:
    """``timestep.StepParams`` from any object with ``un`` (an array),
    ``dt`` and ``t`` (numbers or 0-d arrays, taken as floats), with ``p``
    the port's problem parameters."""
    return StepParams(un=state(sp.un, device=device, dtype=dtype),
                      dt=float(sp.dt), p=p, t=float(sp.t))


def march_checkpoint(ck, *, device, dtype=None) -> MarchCheckpoint:
    """``MarchCheckpoint`` from any object with ``u`` (an array), ``t``,
    ``step`` and ``extra``."""
    return MarchCheckpoint(u=state(ck.u, device=device, dtype=dtype),
                           t=float(ck.t), step=int(ck.step),
                           extra=dict(ck.extra))


def masked_space(mask, *, device, dtype=None) -> MaskedSpace:
    """``MaskedSpace`` from a 0/1 mask array."""
    return MaskedSpace(state(mask, device=device, dtype=dtype))


def to_numpy(x):
    """A tensor as a numpy array; a DF pair as a ``(hi, lo)`` tuple."""
    if isinstance(x, DF):
        return (to_numpy(x.hi), to_numpy(x.lo))
    return x.detach().cpu().numpy()
