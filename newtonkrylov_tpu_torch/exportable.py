"""Loops and Jacobian-vector products that run eagerly or export whole.

The drivers are Python loops over device tensors: each trip reads one
boolean back to the host.  Under :func:`torch.export.export`
(``torch.compiler.is_exporting()``) the same loop bodies become
``while_loop``\\ s whose carried state has fixed shapes, so a whole solve —
Newton outers, CG inners, the df32 acceptance — is one exported program
(:mod:`~newtonkrylov_tpu_torch.utils.serving`).  Each loop keeps one body;
only the loop around it differs.

* :func:`while_loop` — ``state ← body(*state)`` while ``cond(*state)``.
* :func:`fori_loop` — ``state ← body(i, *state)`` for ``i`` in
  ``[lo, hi)``: a Python loop over ints eagerly, a ``while_loop`` over a
  tensor index when exporting (a bound that depends on the data, such as
  a GMRES step's rotations, is a tensor there).
* :func:`counter` — an iteration count or bound: a Python int eagerly, a
  0-d int64 tensor on the state's device when exporting.
* :func:`record` — write one entry of a preallocated history.
* :func:`jvp_graph` — J·v of a residual ``F(u, p)`` as a
  :class:`JVPGraph` traced once with fake tensors: the linearization,
  evaluated at each new point, and the tangent map, replayed for each J·v.
  The Newton drivers trace it once a solve, ahead of their loops, eagerly
  (every outer then linearizes without a trace) and when exporting (since
  ``torch.func`` transforms cannot be traced inside a ``while_loop``
  body).  :func:`vjp_graph` traces ``Jᵀ·w`` the same way, for the adjoint
  CGLS applies inside an exported loop.
* :func:`jvp` — ``(u, v, p) ↦ J(u)·v``: eagerly :func:`torch.func.jvp`,
  when exporting a :class:`JVPGraph`.

A ``while_loop`` body is traced by Dynamo and may not mutate Python state:
caches that the body would fill (``MaskedSpace``'s mask casts, the DST
preconditioner's constants) are filled only outside an export.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from .utils.profiling import span

__all__ = ["exporting", "while_loop", "fori_loop", "counter", "record",
           "jvp", "jvp_graph", "vjp_graph", "JVPGraph", "require_eager"]


def exporting() -> bool:
    """True while :func:`torch.export.export` traces the caller."""
    return torch.compiler.is_exporting()


def require_eager(what: str) -> None:
    """Raise if an export traces ``what``, a path with no exported form."""
    if exporting():
        raise NotImplementedError(
            f"{what} steps from the host and has no exported form; export "
            "newton_krylov_jit or pseudo_transient")


def counter(like: torch.Tensor, start: int = 0):
    """An iteration count or bound: ``start`` eagerly, a 0-d int64 tensor
    on ``like``'s device when exporting (a ``while_loop`` carries tensors,
    and a Python int that a nested loop's condition reads would become an
    input of the loop without a traced value)."""
    if exporting():
        return torch.full((), start, dtype=torch.int64, device=like.device)
    return start


def record(hist: torch.Tensor, i, value: torch.Tensor) -> torch.Tensor:
    """``hist`` with entry ``i`` set to ``value``, without mutating it (a
    ``while_loop`` body may not write to its carried state in place)."""
    pos = torch.arange(hist.shape[0], device=hist.device)
    return torch.where(pos == i, value.to(hist.dtype), hist)


def while_loop(cond: Callable, body: Callable, state, name: str = None):
    """``state ← body(*state)`` while ``cond(*state)``; returns the state.

    Eagerly a Python loop that reads ``cond``'s boolean back each trip:
    each read is a ``read`` span and each body, given a ``name``, a span of
    that name (:func:`~newtonkrylov_tpu_torch.utils.profiling.span`).
    When exporting, ``torch._higher_order_ops.while_loop`` over the
    flattened state: every leaf must be a tensor whose shape and dtype the
    body keeps (a tree of them: namedtuples, tuples, dicts)."""
    state = tuple(state)
    if not exporting():
        while True:
            with span("read"):
                go = bool(cond(*state))
            if not go:
                return state
            if name is None:
                state = tuple(body(*state))
            else:
                with span(name):
                    state = tuple(body(*state))
    from torch._higher_order_ops import while_loop as hop

    flat, spec = pytree.tree_flatten(state)

    def flat_cond(*leaves):
        return cond(*pytree.tree_unflatten(list(leaves), spec))

    def flat_body(*leaves):
        out = body(*pytree.tree_unflatten(list(leaves), spec))
        return tuple(pytree.tree_flatten(tuple(out))[0])

    return pytree.tree_unflatten(list(hop(flat_cond, flat_body, tuple(flat))),
                                 spec)


def fori_loop(lo, hi, body, state, like: torch.Tensor = None):
    """``state ← body(i, *state)`` for ``i`` in ``[lo, hi)``; returns the
    state.

    Eagerly ``lo`` and ``hi`` are Python ints and ``i`` runs over them with
    no host read.  When exporting either bound may be a 0-d tensor (a count
    the loop around carries): the loop is a :func:`while_loop` over ``(i,
    *state)`` with ``i`` a 0-d int64 tensor on ``like``'s device, and the
    body indexes with it."""
    state = tuple(state)
    if not exporting():
        for i in range(lo, hi):
            state = tuple(body(i, *state))
        return state

    def bound(b):
        if isinstance(b, torch.Tensor):
            return b
        return torch.full((), b, dtype=torch.int64, device=like.device)

    stop = bound(hi)
    out = while_loop(lambda i, *s: i < stop,
                     lambda i, *s: (i + 1, *body(i, *s)),
                     (bound(lo), *state))
    return tuple(out[1:])


def _tensor_leaves(p):
    leaves, spec = pytree.tree_flatten(p)
    idx = [i for i, l in enumerate(leaves) if isinstance(l, torch.Tensor)]
    return leaves, spec, idx


def _example(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros(t.shape, dtype=t.dtype, device=t.device)


class JVPGraph:
    """``J(u)·v`` of a residual as two FX graphs: the linearization
    (everything that reads only the state and the parameters, such as
    ``exp(u)``), evaluated once per linearization point, and the tangent
    map, evaluated per J·v.  This is the split ``torch.func.linearize``
    makes by constant folding, with the state a graph input instead of a
    constant.  Built by :func:`jvp_graph`; :func:`vjp_graph` builds the
    same pair for ``Jᵀ·w``."""

    def __init__(self, primal, tangent, p_idx, out_spec):
        self._primal, self._tangent = primal, tangent
        self._p_idx, self._out_spec = p_idx, out_spec

    def linearize(self, u, p) -> Callable:
        """``v ↦ J(u)·v``; the linearization is evaluated here, once."""
        leaves = pytree.tree_flatten(p)[0]
        consts = self._primal(*pytree.tree_flatten(u)[0],
                              *(leaves[i] for i in self._p_idx))

        def mv(v):
            out = self._tangent(*consts, *pytree.tree_flatten(v)[0])
            return pytree.tree_unflatten(list(out), self._out_spec)

        return mv

    def __call__(self, u, v, p):
        return self.linearize(u, p)(v)


def _split(gm, tangent_inputs):
    """(primal, tangent) GraphModules of ``gm``: the nodes that do not
    depend on ``tangent_inputs`` and the rest, joined by the primal values
    the tangent nodes read."""
    import torch.fx as fx

    graph = gm.graph
    tangent = set(tangent_inputs)
    for node in graph.nodes:
        if node.op == "call_function" and any(
                a in tangent for a in node.all_input_nodes):
            tangent.add(node)
    out = next(n for n in graph.nodes if n.op == "output")
    boundary = [n for n in graph.nodes
                if n not in tangent and n.op != "output"
                and any(user in tangent or user is out for user in n.users)]
    primal, env = fx.Graph(), {}
    for node in graph.nodes:
        if node in tangent or node.op == "output":
            continue
        env[node] = primal.node_copy(node, lambda n: env[n])
    # a view among the linearization's values (a parameter's transpose,
    # which Jᵀ·w reads) leaves as a copy: a while_loop refuses two inputs
    # that share storage
    primal.output(tuple(
        primal.call_function(torch.ops.aten.clone.default, (env[n],))
        if n.op == "call_function" and getattr(n.target, "is_view", False)
        else env[n] for n in boundary))
    primal.eliminate_dead_code()
    tan, env = fx.Graph(), {}
    for n in boundary:
        env[n] = tan.placeholder(f"lin_{n.name}")
    for node in graph.nodes:
        if node.op == "placeholder" and node in tangent:
            env[node] = tan.placeholder(node.name)
        elif node.op != "placeholder" and node in tangent:
            env[node] = tan.node_copy(node, lambda n: env[n])
    tan.output(torch.fx.map_arg(out.args[0], lambda n: env[n]))
    return fx.GraphModule(gm, primal), fx.GraphModule(gm, tan)


def _forward_ad(F: Callable, u, p, v):
    """J·v of ``F(·, p)`` at ``u`` by forward AD, as
    :func:`torch.func.linearize` traces it (an output with no tangent gives
    zeros).  ``torch.func.jvp`` differs where a Python scalar meets a 0-d
    tensor: its tangent takes the scalar's dtype."""
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        out = F(pytree.tree_map(fwAD.make_dual, u, v), p)

        def tangent(dual):
            primal, t = fwAD.unpack_dual(dual)
            return torch.zeros_like(primal) if t is None else t

        return pytree.tree_map_only(torch.Tensor, tangent, out)


def _linear_graph(F: Callable, u, p, cotangent: bool) -> JVPGraph:
    """J·v (or, ``cotangent``, Jᵀ·w) of ``F(·, p)`` traced by ``make_fx``
    and split into the linearization and the linear map (:func:`jvp_graph`,
    :func:`vjp_graph`)."""
    import torch._guards
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._python_dispatch import _disable_current_modes

    u_leaves, u_spec = pytree.tree_flatten(u)
    p_leaves, p_spec, idx = _tensor_leaves(p)
    n_u = len(u_leaves)
    out_spec = []  # the result's tree structure, seen while tracing

    def linear_flat(*args):
        # the order of the graph's inputs: u, p's tensors, v (or w)
        uu = pytree.tree_unflatten(list(args[:n_u]), u_spec)
        leaves = list(p_leaves)
        for i, t in zip(idx, args[n_u:n_u + len(idx)]):
            leaves[i] = t
        pp = pytree.tree_unflatten(leaves, p_spec)
        v = pytree.tree_unflatten(list(args[n_u + len(idx):]), u_spec)
        if cotangent:
            out = torch.func.vjp(lambda x: F(x, pp), uu)[1](v)[0]
        else:
            out = _forward_ad(F, uu, pp, v)
        flat, spec = pytree.tree_flatten(out)
        out_spec.append(spec)
        return tuple(flat)

    # outside the export's modes and its tracing context, whose fake mode
    # make_fx would otherwise adopt (and give the graph symbolic shapes)
    with (_disable_current_modes(), torch._C.DisableTorchFunction(),
          torch._guards.tracing(None)):
        # distinct example tensors: make_fx maps each tensor object to one
        # graph input
        examples = ([_example(l) for l in u_leaves]
                    + [_example(p_leaves[i]) for i in idx]
                    + [_example(l) for l in u_leaves])
        # a tensor the residual closes over becomes a constant of the
        # graph (refused, it fails the trace in a way that leaves torch's
        # dispatch-key state changed for the rest of the thread)
        gm = make_fx(linear_flat, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*examples)
    for node in list(gm.graph.nodes):
        if (node.op == "call_function" and not node.users
                and not isinstance(node.meta.get("val"), torch.Tensor)):
            gm.graph.erase_node(node)
    gm.graph.eliminate_dead_code()
    gm.recompile()
    inputs = [n for n in gm.graph.nodes if n.op == "placeholder"]
    primal, tangent = _split(gm, inputs[n_u + len(idx):])
    return JVPGraph(primal, tangent, idx, out_spec[0])


def jvp_graph(F: Callable, u, p: Any = None) -> JVPGraph:
    """``(uu, v, pp) ↦ J(uu)·v`` of ``F(·, pp)`` as FX graphs of ATen and
    custom ops, for states and parameters shaped like ``u`` and ``p``.

    Traced with fake tensors outside the export that calls it (a nested
    export is refused), with the tensor leaves of the parameters as graph
    inputs: a hand-written kernel's custom op stays one op in the graph.
    The shape checks ``torch.func.jvp`` records (``aten.is_same_size``,
    which returns a bool) and dead nodes are removed: a ``while_loop`` body
    traces only ops that return tensors.  The graph is split into the
    linearization and the tangent map (:class:`JVPGraph`).
    """
    return _linear_graph(F, u, p, cotangent=False)


def vjp_graph(F: Callable, u, p: Any = None) -> JVPGraph:
    """``(uu, w, pp) ↦ J(uu)ᵀ·w`` of ``F(·, pp)`` as :func:`jvp_graph`
    traces J·v: the linearization (the forward values the transpose reads)
    and the cotangent map, split.  ``F`` maps a state to a residual of the
    state's structure and shapes (a square system, as a Newton step's)."""
    return _linear_graph(F, u, p, cotangent=True)


def jvp(F: Callable, u, p: Any, v, graph: Callable = None):
    """J(u)·v of ``F(·, p)``: :func:`torch.func.jvp` eagerly; when
    exporting, ``graph`` (a :func:`jvp_graph` built ahead of any loop) or
    one traced now."""
    if not exporting():
        return torch.func.jvp(lambda x: F(x, p), (u,), (v,))[1]
    return (graph or jvp_graph(F, u, p))(u, v, p)
