"""Weak-scaling measurement harness.

Counterpart of ``newtonkrylov_tpu/utils/scaling.py``.  It measures the
throughput of the halo-exchange stencil J·v over device meshes of growing
size; weak scaling grows the global domain with the mesh, so each device
keeps a constant local block and the ideal global rate stays constant.

The JAX package runs one program over meshes of the first d devices.  A
torch process owns one device, so here a mesh of d devices is the first d
ranks of the running group (``halo.make_mesh(..., devices=range(d))``; one
process per device, NCCL on the card, gloo on the CPU); the other ranks
wait at a barrier while it is measured.  Its
ranks step in lockstep (each matvec exchanges ghosts with its neighbours),
and one all-reduce (max) hands every rank the same rate, so every rank
returns the same points.  Timing is
:func:`~newtonkrylov_tpu_torch.utils.profiling.time_chain`.

Run one process per device; rank 0 prints the points as JSON::

    torchrun --nproc-per-node N -m newtonkrylov_tpu_torch.utils.scaling
    torchrun --nproc-per-node 4 -m newtonkrylov_tpu_torch.utils.scaling \\
        --local-n 2048 --device-counts 1,2,4 --mesh-2d 2x2

Without ``torchrun`` it runs a group of one process.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from . import distributed as D
from .profiling import time_chain

__all__ = ["ScalingPoint", "weak_scaling_matvec", "weak_scaling_matvec_2d",
           "main"]


class ScalingPoint(NamedTuple):
    n_devices: int
    global_n: int
    matvecs_per_s: float
    efficiency: float  # vs the smallest measured mesh (= 1 device when included)


def _stencil_jvp_local(up, w):
    u = up[1:-1, 1:-1]
    lap = up[2:, 1:-1] + up[:-2, 1:-1] + up[1:-1, 2:] + up[1:-1, :-2] - 4.0 * u
    return lap + w * u


def _measure(shape, axis_names, local_n, chain, repeats, dtype, device):
    """The rate of the exchange + stencil J·v on a mesh of the first
    prod(shape) ranks, the same on every rank of the group."""
    from ..halo import P, exchange_2d, make_mesh, shard_array
    from . import default_device

    device = torch.device(device) if device is not None else default_device()
    mesh = make_mesh(shape, axis_names, devices=range(math.prod(shape)),
                     device_type=device.type)
    spec = P(*axis_names)
    axes = (axis_names[0], axis_names[1] if len(axis_names) > 1 else None)
    rate = 0.0
    if mesh.get_coordinate() is not None:
        with D.use_mesh(mesh):
            rows = local_n * shape[0]
            cols = local_n * (shape[1] if len(shape) > 1 else 1)
            u = torch.ones((rows, cols), dtype=dtype, device=device)
            w = torch.ones((rows, cols), dtype=dtype, device=device) * 0.1
            us, ws = shard_array(u, mesh, spec), shard_array(w, mesh, spec)
            del u, w

            def matvec_local(v, wl):
                return _stencil_jvp_local(exchange_2d(v, axes, "dirichlet"),
                                          wl)

            rate = time_chain(matvec_local, us, ws, chain=chain,
                              repeats=repeats)
    agreed = torch.tensor(rate, dtype=torch.float64,
                          device=D.mesh_device(mesh))
    D.COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(agreed, op=dist.ReduceOp.MAX)
    dist.barrier()
    return float(agreed)


def weak_scaling_matvec(
    local_n: int = 512,
    device_counts: Optional[Sequence[int]] = None,
    chain: int = 200,
    repeats: int = 3,
    dtype=torch.float32,
    device=None,
) -> list[ScalingPoint]:
    """Measure halo-exchange stencil-JVP throughput per mesh size.

    Each device holds a ``local_n × local_n`` block (row decomposition); the
    matvec includes the ghost exchange — the communication the efficiency
    number is about.  Under weak scaling the ideal global rate is constant
    as devices grow, so ``efficiency = rate_d / rate_first``; **include 1 in
    device_counts** to anchor against one device — with a partial list the
    baseline is the smallest measured mesh and earlier scaling loss is
    invisible.  ``device_counts`` (default: the powers of two up to the
    group's size) name meshes of the first d ranks; every rank of the
    (initialized) group calls this and gets the same points.  Tensors live
    on the card unless ``device="cpu"``.
    """
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    points = []
    base_rate = None
    for d in device_counts:
        if d > world:
            raise ValueError(f"a mesh of {d} devices needs {d} processes, "
                             f"the group has {world}")
        rate = _measure((d,), ("i",), local_n, chain, repeats, dtype, device)
        if base_rate is None:
            base_rate = rate
        points.append(ScalingPoint(n_devices=d, global_n=local_n * d,
                                   matvecs_per_s=rate,
                                   efficiency=rate / base_rate))
    return points


def weak_scaling_matvec_2d(
    local_n: int = 512,
    mesh_shape: tuple = (2, 4),
    chain: int = 200,
    repeats: int = 3,
    dtype=torch.float32,
    device=None,
) -> ScalingPoint:
    """One weak-scaling point over a 2-D ``(i, j)`` mesh of the first
    ``di·dj`` ranks.

    Both grid dimensions are sharded, so the ghost exchange sends four
    messages (±rows over ``i``, ±cols over ``j``) — the communication
    topology of a 2-D domain decomposition."""
    di, dj = mesh_shape
    rate = _measure((di, dj), ("i", "j"), local_n, chain, repeats, dtype,
                    device)
    return ScalingPoint(
        n_devices=di * dj,
        global_n=local_n * di,
        matvecs_per_s=rate,
        efficiency=float("nan"),  # single point; caller anchors it
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--local-n", type=int, default=512)
    ap.add_argument("--device-counts", default=None,
                    help="comma-separated mesh sizes (default: powers of two "
                         "up to the group's size)")
    ap.add_argument("--mesh-2d", default=None,
                    help="a 2-D point, e.g. 2x2 (default: none)")
    ap.add_argument("--chain", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    store = None
    if not D.initialize(device=args.device):
        store = tempfile.mkdtemp(prefix="nk_scaling_")
        D.initialize("file://" + os.path.join(store, "store"), 1, 0,
                     device=args.device)
    try:
        counts = (None if args.device_counts is None else
                  [int(d) for d in args.device_counts.split(",")])
        kw = dict(chain=args.chain, repeats=args.repeats, device=args.device)
        out = {"points": [p._asdict() for p in weak_scaling_matvec(
            args.local_n, counts, **kw)]}
        if args.mesh_2d:
            shape = tuple(int(s) for s in args.mesh_2d.lower().split("x"))
            out["point_2d"] = weak_scaling_matvec_2d(args.local_n, shape,
                                                     **kw)._asdict()
        if args.device == "cuda":
            out["device"] = torch.cuda.get_device_name()
        out["world"] = dist.get_world_size()
        if dist.get_rank() == 0:
            print(json.dumps(out), flush=True)
    finally:
        D.shutdown()
        if store is not None:
            import shutil

            shutil.rmtree(store, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
