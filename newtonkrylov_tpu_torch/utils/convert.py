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
           "march_checkpoint", "masked_space", "to_numpy", "spec", "spec_tree",
           "local_block", "local_tree"]


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


def spec(s):
    """A ``jax.sharding.PartitionSpec`` (or any sequence of mesh-axis names
    and None) as the port's :class:`~newtonkrylov_tpu_torch.halo.PartitionSpec`.
    An entry naming several mesh axes has no counterpart and raises."""
    from ..halo import PartitionSpec

    axes = tuple(s)
    for ax in axes:
        if ax is not None and not isinstance(ax, str):
            raise NotImplementedError(
                f"spec entry {ax!r}: the port shards a dimension over one "
                "mesh axis")
    return PartitionSpec(*axes)


def _is_spec(s) -> bool:
    # a JAX PartitionSpec, told apart by its type's name (JAX is not imported)
    return type(s).__name__ == "PartitionSpec"


def spec_tree(p_spec):
    """A ``p_spec`` tree (named tuples, tuples, dicts; PartitionSpec or None
    leaves) with every PartitionSpec converted by :func:`spec`."""
    if p_spec is None or _is_spec(p_spec):
        return None if p_spec is None else spec(p_spec)
    if isinstance(p_spec, dict):
        return {k: spec_tree(v) for k, v in p_spec.items()}
    if isinstance(p_spec, tuple):
        vals = [spec_tree(v) for v in p_spec]
        return type(p_spec)(*vals) if hasattr(p_spec, "_fields") else tuple(vals)
    raise TypeError(f"p_spec leaf {p_spec!r}")


def local_block(a, mesh, s, *, dtype=None) -> torch.Tensor:
    """This rank's block of the global array ``a`` (numpy) under the JAX
    spec ``s``, on the mesh's device."""
    from ..halo import shard_array

    return shard_array(state(a, device="cpu", dtype=dtype), mesh, spec(s))


def local_tree(p, mesh, p_spec):
    """The port's parameters ``p`` with the fields ``p_spec`` (a JAX-spec
    tree congruent with ``p``) shards replaced by this rank's blocks."""
    from ..halo import shard_tree

    return shard_tree(p, mesh, spec_tree(p_spec))
