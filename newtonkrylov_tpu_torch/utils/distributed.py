"""Multi-process bring-up and the collectives of a sharded solve.

Counterpart of ``newtonkrylov_tpu/utils/distributed.py``.  The JAX package
runs one controller over a device mesh; the port runs one process per
device over :mod:`torch.distributed` (SPMD): every rank holds its block of
the state and runs the same driver code.  Every reduction the JAX package
``psum``s is an ``all_reduce`` here, and all-reduce hands every rank the
same bits, so every boolean a driver reads back agrees across ranks and the
ranks step in lockstep.  A reduction computed without the all-reduce would
let them diverge and deadlock.

* :func:`initialize` / :func:`shutdown` — the process group: NCCL on the
  card, gloo on the CPU; explicit arguments or the ``torchrun`` environment.
* :func:`run_processes` — run a function on N spawned CPU ranks of one gloo
  group (the tests' and the dry run's CPU rehearsal).
* The current mesh (:func:`use_mesh`, :func:`current_mesh`) against which
  axis names resolve: :func:`axis_size`, :func:`axis_index`,
  :func:`axis_group`, :func:`neighbors`.  ``halo.make_mesh`` registers it
  and makes its process groups (:func:`init_axis_groups`): a mesh may
  span part of the group, and its reductions stay inside it.
* The collectives, each counted in ``COLLECTIVES`` where it is issued:
  :func:`all_reduce` (sum, min, max) and :func:`reduce_scatter`; the ghost
  exchange of :mod:`~newtonkrylov_tpu_torch.halo` counts its exchanges and
  point-to-point messages here too.

This module imports nothing else of the port, so the spaces, the
preconditioners and the halo exchange can all build on it.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import math
import os
import queue as _queue
import shutil
import tempfile
import time
import traceback
import warnings
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "initialize", "shutdown", "is_multihost", "host_summary", "run_processes",
    "COLLECTIVES", "reset_collective_counts", "all_reduce", "reduce_scatter",
    "register_mesh", "mesh_key", "mesh_by_key", "current_mesh", "use_mesh",
    "init_axis_groups", "axis_size", "axis_index", "axis_group", "neighbors",
    "mesh_device",
]

# Collectives issued by the port's wrappers since the last reset:
# all-reduces and reduce-scatters, all-gathers (gather_array), ghost
# exchanges (one per sharded axis and exchange) and the point-to-point
# messages those exchanges send.
COLLECTIVES = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0,
               "exchange": 0, "p2p": 0}


def reset_collective_counts() -> None:
    for key in COLLECTIVES:
        COLLECTIVES[key] = 0


def _default_device() -> torch.device:
    # the port's utils.default_device (the card), without importing the
    # package's __init__ chain from here
    return torch.device("cuda")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    timeout_s: float = 300.0,
) -> bool:
    """Initialize the default process group if the environment calls for it.

    Explicit arguments win: ``coordinator_address`` is an init URL
    (``"tcp://host:port"``, ``"file:///path"``) or a bare ``"host:port"``,
    with ``num_processes`` (the world size) and ``process_id`` (this rank).
    Otherwise the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) is read.  Returns True once a group is
    up (also when one already was), False in a single-process environment
    with neither (a no-op, safe to call at program start).

    The backend follows ``device`` (by default the card): NCCL for CUDA,
    each rank bound to ``LOCAL_RANK`` (or rank mod the local card count);
    gloo for the CPU.  Asking for the card without CUDA raises rather than
    falling back to gloo.
    """
    if dist.is_initialized():
        return True
    explicit = coordinator_address is not None
    env = all(os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if not explicit and not env:
        return False
    dev = torch.device(device) if device is not None else _default_device()
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize: the card (NCCL) was asked for but CUDA is not "
                "available; pass device='cpu' for a gloo group")
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize: no backend for device {dev}")
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("initialize: coordinator_address needs "
                             "num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    else:
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown() -> None:
    """Forget the registered meshes and destroy the default process group
    (a no-op without one)."""
    _MESHES.clear()
    _KEYS.clear()
    _CURRENT.clear()
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multihost() -> bool:
    """Whether more than one process takes part (the JAX package's
    ``process_count() > 1``)."""
    return dist.is_initialized() and dist.get_world_size() > 1


def host_summary() -> str:
    if not dist.is_initialized():
        return "process 0/1, no process group"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return (f"process {dist.get_rank()}/{dist.get_world_size()}, backend "
            f"{dist.get_backend()}, {cards} local cards")


# -- Spawned CPU ranks --------------------------------------------------------


def _rank_main(fn, args, rank, world, init, device, results):
    torch.set_num_threads(1)
    try:
        initialize(init, world, rank, device=device)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def run_processes(fn: Callable, world_size: int, args: Sequence = (), *,
                  timeout: float = 120.0, store_dir: Optional[str] = None,
                  device: str = "cpu") -> list:
    """Run ``fn(*args)`` on ``world_size`` spawned processes that form one
    process group (gloo on the CPU), and return their results by rank.

    ``fn`` must be importable by name (a module-level function) and its
    result picklable.  The group meets through a ``file://`` store in
    ``store_dir`` (a fresh temporary directory by default), so concurrent
    runs never contend for a port.  Each rank runs one thread.  A rank that
    raises, dies, or a run that outlasts ``timeout`` seconds fails the call
    with the rank's traceback; every process is stopped before it returns.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="nk_store_") if own_dir else store_dir
    init = "file://" + os.path.join(os.path.abspath(store_dir), "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, tuple(args), r, world_size, init, device,
                               results))
             for r in range(world_size)]
    out = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"run_processes: {world_size - len(out)} of {world_size} "
                    f"ranks gave no result within {timeout} s")
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_processes: rank {dead[0]} died "
                                       f"(exit code {procs[dead[0]].exitcode})")
                continue
            if not ok:
                raise RuntimeError(f"run_processes: rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(world_size)]


# -- The current mesh and its axes -------------------------------------------
#
# Axis names resolve against the current mesh, as the JAX package's resolve
# against the enclosing shard_map.  Meshes are registered under a string key
# so that the ghost exchange, a custom op, can name its mesh in an argument.

_MESHES: dict = {}    # key -> DeviceMesh
_KEYS: dict = {}      # id(mesh) -> key
_CURRENT: list = []   # stack of current meshes
_GROUPS: dict = {}    # id(mesh) -> {sorted dims: this rank's process group}


def register_mesh(mesh) -> str:
    """Register ``mesh`` and make it current; return its key."""
    key = _KEYS.get(id(mesh))
    if key is None:
        key = f"mesh{len(_MESHES)}"
        _MESHES[key] = mesh
        _KEYS[id(mesh)] = key
    _CURRENT[:] = [mesh]
    return key


def mesh_key(mesh=None) -> str:
    m = _resolve(mesh)
    key = _KEYS.get(id(m))
    return key if key is not None else register_mesh(m)


def mesh_by_key(key: str):
    return _MESHES[key]


def current_mesh():
    return _CURRENT[-1] if _CURRENT else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` current inside the block."""
    mesh_key(mesh)
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def _resolve(mesh):
    m = mesh if mesh is not None else current_mesh()
    if m is None:
        raise RuntimeError("no mesh: build one with halo.make_mesh (axis "
                           "names resolve against the current mesh)")
    return m


def _dim(m, ax: str) -> int:
    names = tuple(m.mesh_dim_names or ())
    if ax not in names:
        raise ValueError(f"axis {ax!r} is not an axis of the mesh {names}")
    return names.index(ax)


def axis_size(ax: str, mesh=None) -> int:
    m = _resolve(mesh)
    return int(m.size(_dim(m, ax)))


def axis_index(ax: str, mesh=None) -> int:
    """This rank's coordinate along mesh axis ``ax`` (``lax.axis_index``)."""
    m = _resolve(mesh)
    return int(m.get_coordinate()[_dim(m, ax)])


def _spans_world(m) -> bool:
    return m.mesh.numel() == dist.get_world_size()


def init_axis_groups(mesh) -> None:
    """Make the process groups of ``mesh``'s sets of two or more axes (for
    a 2-D mesh, the mesh's own group), so that a reduction over several
    axes is one collective that stays inside the mesh.  Collective over
    the whole process group: every rank calls it, in the same order, also
    a rank outside the mesh.  A set of all the axes of a mesh that spans
    the group reduces over the default group and makes none."""
    ranks = mesh.mesh
    me = dist.get_rank()
    groups = {}
    for k in range(2, mesh.ndim + 1):
        for dims in itertools.combinations(range(mesh.ndim), k):
            if k == mesh.ndim and _spans_world(mesh):
                continue
            rest = [d for d in range(mesh.ndim) if d not in dims]
            # one group for each coordinate of the other axes
            blocks = ranks.permute(*rest, *dims).reshape(-1, math.prod(
                int(ranks.shape[d]) for d in dims))
            for block in blocks.tolist():
                g = dist.new_group(ranks=block)
                if me in block:
                    groups[dims] = g
    _GROUPS[id(mesh)] = groups


def axis_group(names: Sequence[str], mesh=None):
    """The process group spanning mesh axes ``names``: one axis's group,
    the group :func:`init_axis_groups` made for several, or the default
    group (None) for all the axes of a mesh that spans it."""
    m = _resolve(mesh)
    dims = tuple(sorted({_dim(m, ax) for ax in names}))
    if len(dims) == m.ndim and _spans_world(m):
        return None
    if len(dims) == 1:
        return m.get_group(dims[0])
    group = _GROUPS.get(id(m), {}).get(dims)
    if group is None:
        raise RuntimeError(
            f"no process group for the axes {tuple(names)} of this mesh: "
            "build the mesh with halo.make_mesh")
    return group


def neighbors(ax: str, mesh=None):
    """(previous, next) global ranks along mesh axis ``ax``, with wrap."""
    m = _resolve(mesh)
    d = _dim(m, ax)
    coord = list(m.get_coordinate())
    size = int(m.size(d))
    ranks = m.mesh
    lo, hi = list(coord), list(coord)
    lo[d] = (coord[d] - 1) % size
    hi[d] = (coord[d] + 1) % size
    return int(ranks[tuple(lo)]), int(ranks[tuple(hi)])


def mesh_device(mesh=None) -> torch.device:
    """The device the mesh's blocks live on (the current card for CUDA)."""
    m = _resolve(mesh)
    if m.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(m.device_type)


# -- Collectives --------------------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, names: Sequence[str], op: str = "sum",
               mesh=None) -> torch.Tensor:
    """``x`` reduced over mesh axes ``names`` (``lax.psum``/``pmin``/
    ``pmax``), as a new tensor on every rank; ``names`` empty returns ``x``."""
    if not tuple(names):
        return x
    y = x.contiguous().clone()
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(y, op=_OPS[op], group=axis_group(names, mesh))
    return y


def reduce_scatter(x: torch.Tensor, ax: str, mesh=None) -> torch.Tensor:
    """Sum ``x`` over mesh axis ``ax`` and hand each rank its block of rows
    (``lax.psum_scatter(..., scatter_dimension=0, tiled=True)``)."""
    size = axis_size(ax, mesh)
    if x.shape[0] % size:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows do not split "
                         f"over {size} ranks")
    out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
    COLLECTIVES["reduce_scatter"] += 1
    with warnings.catch_warnings():
        # newer releases rename it reduce_scatter_single; the name used here
        # exists in every release the port runs on
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, x.contiguous(),
                                   group=axis_group((ax,), mesh))
    return out

