"""Implicit time integration: residual-builder steppers and marching drivers.

Counterpart of ``newtonkrylov_tpu/timestep.py`` (the reference's L4 layer,
``examples/implicit.jl``): an ODE right-hand side ``f(u, p, t) -> du`` is
turned into a per-step root problem ``G(u) = 0`` solved by Newton–Krylov,
with three single-step schemes and a fixed-step marching driver.

Time-argument convention: the reference's ``solve`` passes the *target*
time ``t = t_{n+1}`` of each step into ``G!`` (examples/implicit.jl:63-70),
so its midpoint scheme evaluates ``f`` at ``t + αΔt`` and its trapezoid
scheme evaluates the old state at the new time (examples/implicit.jl:17-37).
Those formulas are reproduced for parity (every reference problem is
autonomous, so the difference is invisible).

Two marching drivers share the steppers:

:func:`integrate`
    One Newton solve per step with the reference's ``tol_abs = 6e-6`` and
    warn-and-continue on failure; ``callback(u)`` after every step;
    checkpoint and resume.  Host-only Newton options go to
    :func:`~newtonkrylov_tpu_torch.newton.newton_krylov`, everything else
    to :func:`~newtonkrylov_tpu_torch.newton.newton_krylov_jit`.
:func:`integrate_scan`
    The JAX package's one-program march: here a Python loop over steps on
    the device, each step a ``newton_krylov_jit`` solve, with no host read
    beyond the driver's own loop booleans; returns the stacked history and
    per-step counts instead of callbacks.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from . import df32 as dd
from .newton import newton_krylov, newton_krylov_jit
from .operator import JacobianOperator, materialize_dense
from .tree import tree_add, tree_axpby, tree_axpy, tree_leaves, tree_map, tree_sub

__all__ = [
    "StepParams",
    "MarchResult",
    "implicit_euler",
    "implicit_euler_df",
    "implicit_midpoint",
    "implicit_trapezoid",
    "step_jacobian",
    "integrate",
    "integrate_scan",
    "STEPPERS",
]


class StepParams(NamedTuple):
    """Per-step parameters threaded through the step residual (the
    reference's ``(uₙ, Δt, du, p, t)``, examples/implicit.jl:61, without the
    scratch ``du``)."""

    un: Any          # state at start of step
    dt: Any          # step size
    p: Any           # user parameters for f
    t: Any           # the step's *target* time t_{n+1} (reference convention)


def implicit_euler(f: Callable) -> Callable:
    """Backward Euler: ``G(u) = uₙ + Δt·f(u, t) − u`` (examples/implicit.jl:8-13)."""

    def G(u, sp: StepParams):
        du = f(u, sp.p, sp.t)
        return tree_sub(tree_axpy(sp.dt, du, sp.un), u)

    return G


def implicit_midpoint(f: Callable, alpha: float = 0.5) -> Callable:
    """Implicit midpoint: ``G(u) = uₙ + Δt·f(αuₙ + (1−α)u, t + αΔt) − u``
    (examples/implicit.jl:17-25; ``t`` is already the target time, as in
    the reference)."""

    def G(u, sp: StepParams):
        u_mid = tree_axpby(alpha, sp.un, 1.0 - alpha, u)
        du = f(u_mid, sp.p, sp.t + alpha * sp.dt)
        return tree_sub(tree_axpy(sp.dt, du, sp.un), u)

    return G


def implicit_trapezoid(f: Callable) -> Callable:
    """Implicit trapezoid: ``G(u) = uₙ + Δt/2·(f(uₙ, t) + f(u, t + Δt)) − u``
    (examples/implicit.jl:29-37; the reference's time arguments, kept)."""

    def G(u, sp: StepParams):
        dun = f(sp.un, sp.p, sp.t)
        du = f(u, sp.p, sp.t + sp.dt)
        return tree_sub(tree_axpy(0.5 * sp.dt, tree_add(dun, du), sp.un), u)

    return G


def implicit_euler_df(f_df: Callable) -> Callable:
    """df32 backward-Euler residual ``G(u) = uₙ + Δt·f(u, t) − u``, ``u`` a
    :class:`~newtonkrylov_tpu_torch.df32.DF` pair and ``f_df`` the problem's
    df32 RHS (e.g. :func:`~newtonkrylov_tpu_torch.problems.heat2d.rhs_df`).
    Pass it as the acceptance residual beside the plain stepper::

        integrate("euler", heat2d.rhs, u0, p, dt, T,
                  newton_kwargs=dict(residual_df=implicit_euler_df(heat2d.rhs_df)))

    ``Δt`` and ``uₙ`` enter as df32 splits of their (possibly f64) values
    on every evaluation.
    """

    def G(u, sp: StepParams):
        du = f_df(u, sp.p, sp.t)
        dt = sp.dt
        if not isinstance(dt, torch.Tensor):
            dt = torch.full((), dt, dtype=torch.float64,
                            device=tree_leaves(u.hi)[0].device)
        s = dd.add(dd.df_from_f64(sp.un), dd.mul(du, dd.df_from_f64(dt)))
        return dd.add(s, dd.neg(u))

    return G


STEPPERS = {
    "euler": implicit_euler,
    "midpoint": implicit_midpoint,
    "trapezoid": implicit_trapezoid,
}


def step_jacobian(stepper, f: Callable, un, p, dt, t=0.0):
    """Dense Jacobian of one implicit step at u = uₙ — the analysis probe
    of ``jacobian(G!, f!, ...)`` (examples/implicit.jl:41-50)."""
    if isinstance(stepper, str):
        stepper = STEPPERS[stepper]
    sp = StepParams(un=un, dt=dt, p=p, t=t)
    return materialize_dense(JacobianOperator(stepper(f), un, sp))


class MarchResult(NamedTuple):
    u: Any                 # final state
    history: Any           # stacked states (n_saved, ...) or None
    ts: Any                # times of the history (float64)
    n_failed: Any          # steps whose nonlinear solve did not converge
    outer_iterations: Any  # per-step Newton outer counts
    inner_iterations: Any  # per-step Krylov totals


def _host_only(verbose: int, newton_kwargs: dict) -> bool:
    """Whether the march needs the host-stepped driver: ``verbose``, a
    Newton ``callback``, ``jit_step`` or a host-side factory."""
    return (verbose > 0
            or "callback" in newton_kwargs
            or "jit_step" in newton_kwargs
            or any(getattr(newton_kwargs.get(key), "host_side", False)
                   for key in ("M", "N")))


def _stack(states):
    return tree_map(lambda *ls: torch.stack(ls), *states)


def integrate(
    stepper,
    f: Callable,
    u0: Any,
    p: Any,
    dt: float,
    t_final: float,
    *,
    t0: float = 0.0,
    callback: Optional[Callable] = None,
    save_history: bool = False,
    tol_abs: float = 6.0e-6,
    newton_kwargs: Optional[dict] = None,
    verbose: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> MarchResult:
    """Fixed-step implicit time marching (``solve(G!, f!, uₙ, p, Δt, ts)``,
    examples/implicit.jl:54-78): per step one Newton solve with ``tol_abs``
    defaulting to the reference's 6e-6, warn-and-continue on a failed
    solve (``info.solved`` read once a step), and ``callback(u)`` after
    every step.

    ``stepper`` is one of the builders above or a key of ``STEPPERS``.
    ``verbose``, a ``callback``/``jit_step`` in ``newton_kwargs`` or a
    host-side factory (``host_side``) select the host-stepped
    ``newton_krylov``; otherwise each step runs ``newton_krylov_jit``.

    With ``checkpoint_dir`` and ``checkpoint_every > 0`` a snapshot of
    ``(u, t, step)`` is written every that-many steps; ``resume=True``
    restarts from the latest snapshot in the directory.

    Returns a :class:`MarchResult`: ``ts`` and the per-step counts as
    tensors on the state's device, ``n_failed`` a Python int.
    """
    if isinstance(stepper, str):
        stepper = STEPPERS[stepper]
    G = stepper(f)
    newton_kwargs = dict(newton_kwargs or {})
    newton_kwargs.setdefault("tol_abs", tol_abs)
    host_only = _host_only(verbose, newton_kwargs)
    device = tree_leaves(u0)[0].device

    n_steps = int(round((t_final - t0) / dt))
    u = un = u0
    start_step = 0
    if resume and checkpoint_dir:
        from .utils.checkpointing import latest_checkpoint, load_checkpoint

        latest = latest_checkpoint(checkpoint_dir)
        if latest is not None:
            ck = load_checkpoint(latest, u0)
            un = u = ck.u
            start_step = ck.step
            if verbose > 0:
                print(f"[integrate] resumed from {latest} (step {start_step}, t={ck.t})")

    hist = [un] if save_history else None
    ts = [t0 + start_step * dt]
    n_failed = 0
    outers, inners = [], []

    for k in range(start_step + 1, n_steps + 1):
        t = t0 + k * dt
        sp = StepParams(un=un, dt=dt, p=p, t=t)
        if host_only:
            u, info = newton_krylov(G, un, sp, verbose=verbose, **newton_kwargs)
        else:
            u, info = newton_krylov_jit(G, un, sp, **newton_kwargs)
        if not bool(info.solved):
            n_failed += 1
            print(f"[integrate] WARNING: nonlinear solve failed, marching on (t={t}, stats={info.stats})")
        if callback is not None:
            callback(u)
        if save_history:
            hist.append(u)
        ts.append(t)
        outers.append(int(info.stats.outer_iterations))
        inners.append(int(info.stats.inner_iterations))
        un = u
        if checkpoint_dir and checkpoint_every and k % checkpoint_every == 0:
            from .utils.checkpointing import MarchCheckpoint, save_checkpoint

            save_checkpoint(
                f"{checkpoint_dir}/march_{k}",
                MarchCheckpoint(u=u, t=t, step=k, extra={"dt": dt}),
            )

    return MarchResult(
        u=u,
        history=_stack(hist) if save_history else None,
        ts=torch.tensor(ts, dtype=torch.float64, device=device),
        n_failed=n_failed,
        outer_iterations=_counts(outers, device),
        inner_iterations=_counts(inners, device),
    )


def _counts(counts, device):
    """Per-step counts as one int64 tensor: Python ints eagerly, 0-d
    tensors in an export (``torch.tensor`` cannot read those)."""
    if not counts:
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.stack([torch.as_tensor(c, dtype=torch.int64, device=device)
                        for c in counts])


def integrate_scan(
    stepper,
    f: Callable,
    u0: Any,
    p: Any,
    dt: float,
    n_steps: int,
    *,
    t0: float = 0.0,
    save_every: int = 1,
    tol_abs: float = 6.0e-6,
    newton_kwargs: Optional[dict] = None,
) -> MarchResult:
    """The whole march with its state on the device (the JAX package's
    ``lax.scan`` over jitted Newton solves): a Python loop of
    ``newton_krylov_jit`` steps that reads nothing back beyond the
    driver's own loop booleans.

    Returns the stacked history of every ``save_every``-th step (only those
    states are kept), their times ``t0 + k·dt`` in float64, the per-step
    outer and inner counts as tensors, and ``n_failed`` as a device sum.
    """
    if isinstance(stepper, str):
        stepper = STEPPERS[stepper]
    G = stepper(f)
    newton_kwargs = dict(newton_kwargs or {})
    newton_kwargs.setdefault("tol_abs", tol_abs)
    device = tree_leaves(u0)[0].device

    u = u0
    saved, solved, outers, inners = [], [], [], []
    for k in range(n_steps):
        # the target time in float64 (a Python float), from an exact step index
        t = t0 + (k + 1) * dt
        u, info = newton_krylov_jit(G, u, StepParams(un=u, dt=dt, p=p, t=t),
                                    **newton_kwargs)
        solved.append(info.solved)
        outers.append(info.stats.outer_iterations)
        inners.append(info.stats.inner_iterations)
        if (k + 1) % save_every == 0:
            saved.append(u)

    steps = torch.arange(save_every, n_steps + 1, save_every,
                         dtype=torch.float64, device=device)
    return MarchResult(
        u=u,
        history=_stack(saved) if saved else None,
        ts=t0 + dt * steps,
        n_failed=torch.logical_not(torch.stack(solved)).sum(),
        outer_iterations=_counts(outers, device),
        inner_iterations=_counts(inners, device),
    )
