"""Halo-exchange domain decomposition over ``torch.distributed``.

Counterpart of ``newtonkrylov_tpu/halo.py``.  The JAX package runs one
program over a device mesh with ``shard_map``; the port runs one process per
device (SPMD), and a ``DeviceMesh`` takes the place of the mesh:

* the global 2-D interior is block-sharded over the mesh; each rank holds
  its block (:func:`shard_array`, read back with :func:`gather_array`) and
  runs the same driver code on it;
* ghost fills are neighbour exchanges over the mesh axes
  (:func:`exchange_1d`, :func:`exchange_2d`): point-to-point messages
  (NCCL on the card, gloo on the CPU) where the JAX package ``ppermute``\\ s;
  physical boundaries take Dirichlet (zero) or periodic values;
* every solver reduction goes through
  :class:`~newtonkrylov_tpu_torch.spaces.ShardedSpace`, whose dot products
  all-reduce over the mesh axes.

An exchange is a ``torch.library.custom_op`` pair — post the messages, wait
for them — wrapped in an ``autograd.Function`` whose JVP runs the same
exchange on the tangent (the exchange is linear).  So a residual that
exchanges ghosts linearizes under :func:`torch.func.linearize`, and every
replayed J·v exchanges the tangent's ghosts again; a raw send inside the
residual would be traced away.  Its backward is the transpose: the
cotangent of each received ghost strip goes back to the rank that owns
those cells, by the same exchange run the other way, and adds to the
cotangent of the edge that rank sent.  So ``J.rmv``, ``cgls`` and any VJP
through :func:`exchange_1d`/:func:`exchange_2d` work on the mesh, as the
transpose of ``ppermute`` does under ``shard_map``.

Axis names resolve against the current mesh (:func:`make_mesh` makes its
mesh current; :func:`newton_krylov_sharded` uses its own).  An axis of size
1 issues no message: its Dirichlet ghosts are zeros and its periodic ghosts
the rank's own opposite edges, as ``ppermute`` to itself gives.

Entry points: :func:`sharded_residual_2d` lifts a padded-block residual into
a per-rank residual; :func:`newton_krylov_sharded` runs a whole solve on the
mesh; :func:`integrate_scan_sharded` marches in time on it.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import df32 as _dd
from .newton import newton_krylov_jit
from .ops.stencil import pad_dirichlet
from .spaces import ShardedSpace
from .tree import tree_map
from .utils import distributed as D

__all__ = [
    "PartitionSpec",
    "P",
    "make_mesh",
    "mesh_shape",
    "shard_array",
    "gather_array",
    "shard_tree",
    "exchange_1d",
    "exchange_2d",
    "sharded_residual_1d",
    "sharded_residual_2d",
    "sharded_residual_df_2d",
    "newton_krylov_sharded",
    "integrate_scan_sharded",
]


class PartitionSpec(tuple):
    """Placement of an array on a mesh: one mesh-axis name (or None, not
    sharded) per array dimension, as ``jax.sharding.PartitionSpec``.
    Missing trailing entries are None; ``PartitionSpec()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def mesh_shape(n_devices: int) -> Tuple[int, int]:
    """The squarest 2-D factorization of ``n_devices`` (rows ≥ columns)."""
    best = (n_devices, 1)
    for a in range(1, int(math.isqrt(n_devices)) + 1):
        if n_devices % a == 0:
            best = (n_devices // a, a)
    return best


def make_mesh(shape: Sequence[int], axis_names: Sequence[str] = ("i", "j"),
              devices: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the first prod(shape) of ``devices`` (global
    ranks, one process a device; by default every rank of the group),
    row-major, with named axes, made current — ``jax.make_mesh``'s
    counterpart.  ``device_type`` defaults to the card (``"cuda"``); pass
    ``"cpu"`` for a gloo group.

    Every rank of the group calls it, in the same order: making process
    groups is collective over the whole group.  On a rank outside the mesh
    ``mesh.get_coordinate()`` is None, and the sharded entry points
    (:func:`shard_array`, :func:`gather_array`,
    :func:`newton_krylov_sharded`, :func:`integrate_scan_sharded`) raise
    there; the mesh's reductions and gathers run over its own groups, so
    the ranks outside take no part in them."""
    from torch.distributed.device_mesh import DeviceMesh

    from .utils import default_device

    shape = tuple(int(s) for s in shape)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "utils.distributed.initialize first")
    world = dist.get_world_size()
    devices = (list(range(world)) if devices is None
               else [int(r) for r in devices])
    need = math.prod(shape)
    if len(devices) < need:
        raise ValueError(f"need {need} devices for mesh {shape}, have "
                         f"{len(devices)}")
    ranks = devices[:need]
    if len(set(ranks)) < need or not all(0 <= r < world for r in ranks):
        raise ValueError(f"mesh {shape}: the devices {ranks} are not "
                         f"distinct ranks of the group of {world}")
    device_type = device_type or default_device().type
    mesh = DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(axis_names))
    D.init_axis_groups(mesh)
    D.register_mesh(mesh)
    return mesh


def _member(mesh, what: str) -> None:
    """Raise unless this rank is a device of ``mesh``."""
    if mesh.get_coordinate() is None:
        raise ValueError(
            f"{what}: rank {dist.get_rank()} is outside the mesh "
            f"{mesh.mesh.tolist()}; only its ranks take part in its solves")


def _spec(spec, ndim: int):
    spec = tuple(spec) if spec is not None else ()
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    for ax in spec:
        if ax is not None and not isinstance(ax, str):
            raise NotImplementedError(
                f"spec entry {ax!r}: one mesh axis per array dimension")
    return spec + (None,) * (ndim - len(spec))


def _block(x, mesh, spec):
    for d, ax in enumerate(_spec(spec, x.dim())):
        if ax is None:
            continue
        size, idx = D.axis_size(ax, mesh), D.axis_index(ax, mesh)
        if x.shape[d] % size:
            raise ValueError(f"dimension {d} of length {x.shape[d]} does not "
                             f"split over the {size} ranks of axis {ax!r}")
        b = x.shape[d] // size
        x = x.narrow(d, idx * b, b)
    return x


def shard_array(x, mesh, spec) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``, as a
    contiguous copy on the mesh's device."""
    _member(mesh, "shard_array")
    x = torch.as_tensor(x)
    return _block(x, mesh, spec).to(D.mesh_device(mesh)).clone(
        memory_format=torch.contiguous_format)


def gather_array(x_local: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The global tensor from every rank's block under ``spec`` (one
    all-gather over the mesh's ranks), on every rank of the mesh."""
    _member(mesh, "gather_array")
    names = tuple(mesh.mesh_dim_names)
    group = D.axis_group(names, mesh)
    members = (list(range(dist.get_world_size())) if group is None
               else dist.get_process_group_ranks(group))
    x_local = x_local.contiguous()
    parts = [torch.empty_like(x_local) for _ in members]
    D.COLLECTIVES["all_gather"] += 1
    dist.all_gather(parts, x_local, group=group)
    spec = _spec(spec, x_local.dim())
    shape = list(x_local.shape)
    for d, ax in enumerate(spec):
        if ax is not None:
            shape[d] *= int(mesh.size(names.index(ax)))
    out = x_local.new_empty(shape)
    for r, part in zip(members, parts):
        coord = tuple(int(c) for c in torch.nonzero(mesh.mesh == r)[0])
        index = tuple(
            slice(None) if ax is None else
            slice(coord[names.index(ax)] * x_local.shape[d],
                  (coord[names.index(ax)] + 1) * x_local.shape[d])
            for d, ax in enumerate(spec))
        out[index] = part
    return out


def shard_tree(p, mesh, p_spec):
    """Shard the tensor fields of the parameters ``p`` by the congruent
    tree ``p_spec``: a :class:`PartitionSpec` leaf shards its tensor like
    the state (an empty one, or None, keeps it whole on the mesh's device);
    non-tensor leaves pass through."""
    if p_spec is None or isinstance(p_spec, PartitionSpec):
        if not isinstance(p, torch.Tensor):
            return p
        if p_spec:
            return shard_array(p, mesh, p_spec)
        return p.to(D.mesh_device(mesh))
    if isinstance(p_spec, dict):
        return {k: shard_tree(p[k], mesh, p_spec[k]) for k in p}
    if isinstance(p_spec, tuple):
        vals = [shard_tree(a, mesh, s) for a, s in zip(p, p_spec)]
        return type(p)(*vals) if hasattr(p, "_fields") else type(p)(vals)
    raise TypeError(f"p_spec leaf {p_spec!r}: use a PartitionSpec or None")


# -- The ghost exchange -------------------------------------------------------
#
# ``post`` issues one axis's four messages and returns the two receive
# buffers; ``wait`` completes them.  Between the two a residual computes its
# bulk (the overlapped form).  The pending messages are found again by the
# receive buffer's address, so the pair needs no handle argument and
# replays from a traced graph like any other pair of ops.

_PENDING: dict = {}  # receive buffer address -> the messages in flight
_SEQ: dict = {}      # exchanges posted per mesh axis: the message tags


def _post_impl(edge_lo: torch.Tensor, edge_hi: torch.Tensor, key: str,
               bc: str) -> Tuple[torch.Tensor, torch.Tensor]:
    if bc not in ("dirichlet", "periodic"):
        raise ValueError(f"unknown bc {bc!r}")
    mesh_key, ax = key.split("/")
    mesh = D.mesh_by_key(mesh_key)
    size, idx = D.axis_size(ax, mesh), D.axis_index(ax, mesh)
    D.COLLECTIVES["exchange"] += 1
    edge_lo, edge_hi = edge_lo.contiguous(), edge_hi.contiguous()
    if size == 1:
        # ppermute to itself: the periodic wrap is the rank's own edges
        if bc == "periodic":
            return edge_hi.clone(), edge_lo.clone()
        return torch.zeros_like(edge_hi), torch.zeros_like(edge_lo)
    prev, nxt = D.neighbors(ax, mesh)
    g_lo, g_hi = torch.empty_like(edge_hi), torch.empty_like(edge_lo)
    # tags tell the two directions apart when both neighbours are one rank
    # (a periodic axis of size 2) on gloo; NCCL matches in issue order,
    # which is the same on every rank
    seq = _SEQ.get(key, 0)
    _SEQ[key] = seq + 1
    tag = (seq % (1 << 20)) * 2
    ops = [dist.P2POp(dist.isend, edge_hi, nxt, tag=tag),
           dist.P2POp(dist.isend, edge_lo, prev, tag=tag + 1),
           dist.P2POp(dist.irecv, g_lo, prev, tag=tag),
           dist.P2POp(dist.irecv, g_hi, nxt, tag=tag + 1)]
    D.COLLECTIVES["p2p"] += 2
    works = dist.batch_isend_irecv(ops)
    # the outermost ranks' Dirichlet ghosts are the BC value, zero
    zero_lo = bc == "dirichlet" and idx == 0
    zero_hi = bc == "dirichlet" and idx == size - 1
    # the sent edges stay referenced until the messages complete
    _PENDING[g_lo.data_ptr()] = (works, (edge_lo, edge_hi), zero_lo, zero_hi)
    return g_lo, g_hi


def _wait_impl(g_lo: torch.Tensor, g_hi: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    entry = _PENDING.pop(g_lo.data_ptr(), None)
    if entry is None:  # an axis of size 1: nothing was sent
        return g_lo.clone(), g_hi.clone()
    works, _, zero_lo, zero_hi = entry
    for w in works:
        w.wait()
    out_lo = torch.zeros_like(g_lo) if zero_lo else g_lo.clone()
    out_hi = torch.zeros_like(g_hi) if zero_hi else g_hi.clone()
    return out_lo, out_hi


@torch.library.custom_op("nk_halo::post", mutates_args=())
def _post_op(edge_lo: torch.Tensor, edge_hi: torch.Tensor, key: str,
             bc: str) -> Tuple[torch.Tensor, torch.Tensor]:
    return _post_impl(edge_lo, edge_hi, key, bc)


@_post_op.register_fake
def _(edge_lo, edge_hi, key, bc):
    return torch.empty_like(edge_hi), torch.empty_like(edge_lo)


@torch.library.custom_op("nk_halo::wait", mutates_args=())
def _wait_op(g_lo: torch.Tensor, g_hi: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _wait_impl(g_lo, g_hi)


@_wait_op.register_fake
def _(g_lo, g_hi):
    return torch.empty_like(g_lo), torch.empty_like(g_hi)


def _zeros_if_none(t, like):
    return torch.zeros_like(like) if t is None else t


# The exchange's transpose is the exchange itself, run on the cotangents:
# ghost_lo came from the previous rank's high edge, so its cotangent goes
# back to that rank as the cotangent of its high edge, which is what
# ``post(c_lo, c_hi)`` delivers as the receiver's ``ghost_hi`` — and the
# same for the other side.  A Dirichlet outermost rank's ghost is the
# boundary value: the forward zeroed what it received, and the transpose
# zeroes the same receive, so that ghost's cotangent is dropped.  An axis
# of size 1 swaps (periodic) or zeroes (Dirichlet) the two edges, its own
# transpose.  Backward runs Wait's transpose (post) before Post's (wait),
# in the same order on every rank.


class _Post(torch.autograd.Function):
    """``post`` with its JVP (the same exchange of the tangent's edges) and
    its transpose (completing the cotangents' exchange that
    :class:`_Wait`'s backward posted)."""

    @staticmethod
    def forward(edge_lo, edge_hi, key, bc):
        return _post_op(edge_lo, edge_hi, key, bc)

    @staticmethod
    def setup_context(ctx, inputs, output):
        edge_lo, edge_hi, ctx.key, ctx.bc = inputs
        ctx.save_for_forward(edge_lo, edge_hi)

    @staticmethod
    def jvp(ctx, t_lo, t_hi, _key, _bc):
        edge_lo, edge_hi = ctx.saved_tensors
        return _post_op(_zeros_if_none(t_lo, edge_lo),
                        _zeros_if_none(t_hi, edge_hi), ctx.key, ctx.bc)

    @staticmethod
    def backward(ctx, c_lo, c_hi):
        g_lo, g_hi = _wait_op(c_lo, c_hi)
        return g_lo, g_hi, None, None


class _Wait(torch.autograd.Function):
    """``wait`` with its JVP (complete the tangent's exchange) and its
    transpose (post the cotangents' exchange, the other way)."""

    @staticmethod
    def forward(g_lo, g_hi, key, bc):
        return _wait_op(g_lo, g_hi)

    @staticmethod
    def setup_context(ctx, inputs, output):
        g_lo, g_hi, ctx.key, ctx.bc = inputs
        ctx.like = [(g.shape, g.dtype, g.device) for g in (g_lo, g_hi)]

    @staticmethod
    def jvp(ctx, t_lo, t_hi, _key, _bc):
        return _wait_op(t_lo, t_hi)

    @staticmethod
    def backward(ctx, c_lo, c_hi):
        c_lo, c_hi = (torch.zeros(shape, dtype=dtype, device=device)
                      if c is None else c
                      for c, (shape, dtype, device) in zip((c_lo, c_hi), ctx.like))
        c_lo, c_hi = _post_op(c_lo, c_hi, ctx.key, ctx.bc)
        return c_lo, c_hi, None, None


def _key(ax: str) -> str:
    return f"{D.mesh_key()}/{ax}"


def _post(edge_lo, edge_hi, ax, bc):
    """Post one axis's exchange: ``(ghost_lo, ghost_hi, key, bc)``, the
    ghosts in flight."""
    key = _key(ax)
    return (*_Post.apply(edge_lo, edge_hi, key, bc), key, bc)


def _wait(pending):
    return _Wait.apply(*pending)


def _neighbor_ghosts(edge_lo, edge_hi, ax: str, bc: str):
    """(ghost_lo, ghost_hi) along mesh axis ``ax``: ghost_lo is the previous
    rank's high edge, ghost_hi the next rank's low edge; the outermost ranks
    take the BC value (zero) under Dirichlet, the wrap under periodic."""
    return _wait(_post(edge_lo, edge_hi, ax, bc))


def _bc_ghosts(u, dim, bc):
    """The ghosts of an unsharded dimension: zeros or the wrap."""
    lo, hi = u.narrow(dim, 0, 1), u.narrow(dim, u.shape[dim] - 1, 1)
    if bc == "dirichlet":
        return torch.zeros_like(hi), torch.zeros_like(lo)
    if bc == "periodic":
        return hi, lo
    raise ValueError(f"unknown bc {bc!r}")


def exchange_1d(u, axis_name: str, bc: str = "dirichlet"):
    """Pad a local 1-D block with one ghost on each side by neighbour
    exchange."""
    g_lo, g_hi = _neighbor_ghosts(u[:1], u[-1:], axis_name, bc)
    return torch.cat([g_lo, u, g_hi])


def _post_2d(u, axis_names, bc):
    """Post the exchanges of a 2-D block's sharded dims; the unsharded
    dims' ghosts are ready at once."""
    ax0, ax1 = axis_names
    rows = (_post(u[:1, :], u[-1:, :], ax0, bc) if ax0 is not None
            else _bc_ghosts(u, 0, bc))
    cols = (_post(u[:, :1], u[:, -1:], ax1, bc) if ax1 is not None
            else _bc_ghosts(u, 1, bc))
    return rows, cols


def _wait_2d(posted, axis_names):
    """The four ghost strips (g_rlo, g_rhi: (1, ml); g_clo, g_chi: (nl, 1))."""
    (rows, cols), (ax0, ax1) = posted, axis_names
    g_rlo, g_rhi = _wait(rows) if ax0 is not None else rows
    g_clo, g_chi = _wait(cols) if ax1 is not None else cols
    return g_rlo, g_rhi, g_clo, g_chi


def _ghosts_2d(u, axis_names, bc):
    return _wait_2d(_post_2d(u, axis_names, bc), axis_names)


def _assemble(u, g_rlo, g_rhi, g_clo, g_chi):
    """[ghost col | ghost row, u, ghost row | ghost col]; the corners are
    zeros, which 5-point stencils never read."""
    z1 = u.new_zeros((1, 1))
    rows = torch.cat([g_rlo, u, g_rhi], 0)
    return torch.cat([torch.cat([z1, g_clo, z1], 0), rows,
                      torch.cat([z1, g_chi, z1], 0)], 1)


def exchange_2d(u, axis_names: Tuple[Optional[str], Optional[str]],
                bc: str = "dirichlet"):
    """Pad a local 2-D block with a one-cell ghost ring.

    ``axis_names`` gives the mesh axis sharding each array dimension (None:
    the dimension is not sharded, its ghosts are pure BC values).  Corners
    are zeros."""
    return _assemble(u, *_ghosts_2d(u, axis_names, bc))


def sharded_residual_1d(padded_residual: Callable, axis_name: str,
                        bc: str = "dirichlet") -> Callable:
    """Lift ``padded_residual(u_padded, p) -> res_local`` into a per-rank
    residual whose ghosts arrive by exchange."""

    def F(u, p):
        return padded_residual(exchange_1d(u, axis_name, bc), p)

    return F


def sharded_residual_2d(
    padded_residual: Callable,
    axis_names: Tuple[Optional[str], Optional[str]],
    bc: str = "dirichlet",
    *,
    overlap: bool = True,
) -> Callable:
    """Lift ``padded_residual(u_padded, p) -> res_local`` (a 5-point stencil
    reading an (nl+2, ml+2) block) into a per-rank residual.

    ``overlap=True`` (the default) posts the exchange, evaluates the whole
    block on zero ghosts while the messages travel, waits, and re-evaluates
    only the four one-cell edge strips with the true ghosts, so the
    exchange runs concurrently with the O(nl·ml) bulk.  It requires a
    radius-1 residual whose position dependence enters only through
    per-gridpoint fields of ``p`` (tensors shaped like the block are sliced
    to each strip; other leaves pass through).  ``overlap=False`` is the
    plain exchange-then-compute form, for residuals that compute absolute
    position themselves.  Both give the same values.
    """
    if not overlap:
        def F(u, p):
            return padded_residual(exchange_2d(u, axis_names, bc), p)

        return F

    def F(u, p):
        nl, ml = u.shape
        if nl < 2 or ml < 2:
            # the edge strips would need second-neighbour ghosts
            return padded_residual(exchange_2d(u, axis_names, bc), p)
        posted = _post_2d(u, axis_names, bc)
        bulk = padded_residual(pad_dirichlet(u), p)  # no ghost dependence
        g_rlo, g_rhi, g_clo, g_chi = _wait_2d(posted, axis_names)

        def edges(l, dim):
            """Rows (columns) 0, 1, −2, −1 of a per-gridpoint field."""
            return torch.cat([l.narrow(dim, 0, 2), l.narrow(dim, l.shape[dim] - 2, 2)],
                             dim)

        def p_edges(dim):
            return tree_map(
                lambda l: edges(l, dim) if (isinstance(l, torch.Tensor)
                                            and tuple(l.shape) == (nl, ml)) else l,
                p)

        z1 = u.new_zeros((1, 1))
        # The edge strips, two to a call: a padded block of rows (g_rlo, 0,
        # 1, nl−2, nl−1, g_rhi) whose first and last interior rows are the
        # top and bottom edges re-evaluated with their true ghosts (the two
        # middle rows are discarded), and the same for the columns.
        # Corners are zeros, which 5-point stencils never read.
        rows = padded_residual(torch.cat([
            torch.cat([z1, edges(g_clo, 0), z1], 0),
            torch.cat([g_rlo, edges(u, 0), g_rhi], 0),
            torch.cat([z1, edges(g_chi, 0), z1], 0)], 1), p_edges(0))
        cols = padded_residual(torch.cat([
            torch.cat([z1, edges(g_rlo, 1), z1], 1),
            torch.cat([g_clo, edges(u, 1), g_chi], 1),
            torch.cat([z1, edges(g_rhi, 1), z1], 1)], 0), p_edges(1))
        res = torch.cat([rows[0:1], bulk[1:nl - 1], rows[3:4]], 0)
        return torch.cat([cols[:, 0:1], res[:, 1:ml - 1], cols[:, 3:4]], 1)

    return F


def sharded_residual_df_2d(
    padded_df_residual: Callable,
    axis_names: Tuple[Optional[str], Optional[str]],
    bc: str = "dirichlet",
) -> Callable:
    """Lift a df32 padded-residual core ``padded_df_residual(up, u, p)``
    (e.g. :func:`~newtonkrylov_tpu_torch.problems.bratu2d.residual_scaled_df_padded`)
    into a per-rank df32 residual.  The hi and lo words are exchanged
    separately: the exchange moves data only, so the error-free chains see
    the values one device would, and the acceptance residual stays exact
    under sharding.  Use as the ``residual_df`` of a sharded solve."""

    def F(u_df, p):
        up = _dd.DF(exchange_2d(u_df.hi, axis_names, bc),
                    exchange_2d(u_df.lo, axis_names, bc))
        return padded_df_residual(up, u_df, p)

    return F


# -- Drivers ------------------------------------------------------------------


def _agreed_wall(t: float, names, mesh) -> float:
    """The slowest rank's wall time, so the info is equal on every rank."""
    tt = torch.tensor(float(t), dtype=torch.float64, device=D.mesh_device(mesh))
    return float(D.all_reduce(tt, names, "max", mesh))


def newton_krylov_sharded(
    F_local: Callable,
    u0,
    p: Any,
    mesh,
    in_spec,
    *,
    axis_names: Optional[Sequence[str]] = None,
    newton_kwargs: Optional[dict] = None,
    p_spec: Optional[Any] = None,
    driver: Optional[Callable] = None,
):
    """Run a whole Newton–Krylov solve on ``mesh``, one block per rank.

    ``F_local`` is the per-rank residual (build it with
    :func:`sharded_residual_2d`); ``u0`` the global initial state, sharded
    by ``in_spec``.  Every solver reduction all-reduces over
    ``axis_names`` (default: all mesh axes) through
    :class:`~newtonkrylov_tpu_torch.spaces.ShardedSpace`.  ``p`` reaches
    every rank whole, unless ``p_spec`` (a tree congruent with ``p`` of
    :class:`PartitionSpec` leaves) shards its per-gridpoint fields like the
    state.

    ``driver`` is :func:`~newtonkrylov_tpu_torch.newton.newton_krylov_jit`
    (the default) or
    :func:`~newtonkrylov_tpu_torch.continuation.pseudo_transient`
    (``newton_kwargs`` then carries ``delta0``, ``max_steps``, …).

    Returns ``(u_local, info)``: this rank's block of the solution and an
    info equal on every rank (``t`` is the slowest rank's wall).  Called on
    a rank outside ``mesh``, it raises.
    """
    _member(mesh, "newton_krylov_sharded")
    axis_names = tuple(axis_names if axis_names is not None
                       else mesh.mesh_dim_names)
    newton_kwargs = dict(newton_kwargs or {})
    driver = driver or newton_krylov_jit
    with D.use_mesh(mesh):
        space = ShardedSpace(axis_names=axis_names, mesh=mesh)
        u0_local = shard_array(u0, mesh, in_spec)
        p_local = p if p_spec is None else shard_tree(p, mesh, p_spec)
        u, info = driver(F_local, u0_local, p_local, space=space,
                         **newton_kwargs)
        return u, info._replace(t=_agreed_wall(info.t, axis_names, mesh))


def integrate_scan_sharded(
    stepper,
    f_local: Callable,
    u0,
    p: Any,
    dt: float,
    n_steps: int,
    mesh,
    in_spec,
    *,
    t0: float = 0.0,
    axis_names: Optional[Sequence[str]] = None,
    tol_abs: float = 6.0e-6,
    newton_kwargs: Optional[dict] = None,
    p_spec: Optional[Any] = None,
    snapshot_every: Optional[int] = None,
):
    """Implicit time march over a sharded domain: the port's
    ``integrate_scan`` loop, each step a ``newton_krylov_jit`` solve whose
    reductions all-reduce over the mesh.

    ``f_local`` is the per-rank right-hand side (its spatial operator
    exchanges ghosts, as :func:`sharded_residual_2d`'s); ``stepper`` is a
    :data:`~newtonkrylov_tpu_torch.timestep.STEPPERS` key or builder.  A
    df32 march passes ``newton_kwargs=dict(residual_df=...)`` with a step
    residual whose right-hand side exchanges the hi and lo words apart.
    ``p_spec`` shards per-gridpoint parameter fields like the state.

    ``snapshot_every=k`` keeps every k-th state (this rank's block) in
    ``history``, stacked on a leading axis; None when unset.  Returns a
    :class:`~newtonkrylov_tpu_torch.timestep.MarchResult` with the local
    final state, the step times in float64 and the per-step counts (equal
    on every rank).
    """
    from .timestep import STEPPERS, MarchResult, StepParams

    _member(mesh, "integrate_scan_sharded")
    if isinstance(stepper, str):
        stepper = STEPPERS[stepper]
    if snapshot_every is not None and snapshot_every < 1:
        raise ValueError("snapshot_every must be a positive int")
    G = stepper(f_local)
    axis_names = tuple(axis_names if axis_names is not None
                       else mesh.mesh_dim_names)
    newton_kwargs = dict(newton_kwargs or {})
    newton_kwargs.setdefault("tol_abs", tol_abs)
    with D.use_mesh(mesh):
        space = ShardedSpace(axis_names=axis_names, mesh=mesh)
        u = shard_array(u0, mesh, in_spec)
        device = u.device
        p_local = p if p_spec is None else shard_tree(p, mesh, p_spec)
        snaps, solved, outers, inners = [], [], [], []
        for k in range(n_steps):
            t = t0 + (k + 1) * dt
            u, info = newton_krylov_jit(
                G, u, StepParams(un=u, dt=dt, p=p_local, t=t), space=space,
                **newton_kwargs)
            solved.append(info.solved)
            outers.append(info.stats.outer_iterations)
            inners.append(info.stats.inner_iterations)
            if snapshot_every is not None and (k + 1) % snapshot_every == 0:
                snaps.append(u)
    steps = torch.arange(1, n_steps + 1, dtype=torch.float64, device=device)
    return MarchResult(
        u=u,
        history=(None if snapshot_every is None else
                 torch.stack(snaps) if snaps else u.new_empty((0,) + u.shape)),
        ts=t0 + dt * steps,
        n_failed=torch.logical_not(torch.stack(solved)).sum(),
        outer_iterations=torch.tensor(outers, dtype=torch.int64, device=device),
        inner_iterations=torch.tensor(inners, dtype=torch.int64, device=device),
    )

