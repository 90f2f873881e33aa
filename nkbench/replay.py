"""Replays of single phases of a solve, for the per-layer readers.

Copied from the port's ``benchmarks/solve_profile.py`` (device time by
CUDA events around many calls) and ``benchmarks/xl8192.apply_cost`` (one
preconditioner apply on the Jacobian at u₀), so that later changes to
the program cannot change how its phases are timed.  Each runs after the
window, at the cell's side, from the requests' starting state.
"""

from __future__ import annotations

from typing import Callable

import torch


def device_ms(fn: Callable, device, reps: int) -> float:
    """Device ms of one ``fn()``: CUDA events around ``reps`` calls after a
    warm call, over ``reps``."""
    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def point(run):
    """The requests' starting state (float64) and its float32
    linearization point, as the solve's first outer takes it."""
    u = run.u0()
    return u, u.to(torch.float32)


def accept_ms(run, reps: int = 10) -> float:
    """One df32 acceptance residual of the configuration and its norm."""
    from newtonkrylov_tpu_torch import df32

    u, _ = point(run)
    s = run.system
    pair = df32.df_from_f64(u)

    def accept():
        return torch.linalg.vector_norm(s.F_df(pair, s.p).hi)

    return device_ms(accept, run.device, reps)


def precond_apply_ms(run, reps: int = 20) -> float:
    """One apply of the configuration's preconditioner, built on the
    float32 Jacobian at the requests' starting state."""
    from newtonkrylov_tpu_torch.operator import JacobianOperator

    _, u32 = point(run)
    s = run.system
    J = JacobianOperator(s.F, u32, s.p)
    apply = s.make_factory()(J)
    r = J.res
    return device_ms(lambda: apply(r), run.device, reps)
