"""Per-rank code of the sharded walkthrough (``walkthrough_sharded.md``).

The walkthrough runs these functions on W spawned ranks with
``utils.distributed.run_processes`` (gloo on the CPU), which imports them
by name: a function defined in a walkthrough block cannot be sent to a
spawned rank.  Each section function runs inside the initialized group,
on the 2-D mesh :func:`grid` gives, and returns the numbers its section
asserts on; every rank returns the same numbers.  :func:`all_sections`
runs the four in one group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from newtonkrylov_tpu_torch import newton_krylov_jit
from newtonkrylov_tpu_torch.fftprec import fft_poisson
from newtonkrylov_tpu_torch.halo import (P, gather_array, make_mesh, mesh_shape,
                                         newton_krylov_sharded, sharded_residual_2d,
                                         sharded_residual_df_2d)
from newtonkrylov_tpu_torch.precond import chebyshev
from newtonkrylov_tpu_torch.problems import bratu2d

N, LAM = 64, 5.0


def padded_residual(up, pp):
    """2-D Bratu on a (n+2, m+2) ghost-padded block — pure, local."""
    u = up[1:-1, 1:-1]
    lap = up[2:, 1:-1] + up[:-2, 1:-1] + up[1:-1, 2:] + up[1:-1, :-2] - 4.0 * u
    return lap + (pp.dx * pp.dx) * pp.lam * torch.exp(u)


def grid():
    """The squarest 2-D mesh of the group (rows ≤ columns): 2×2 at W = 4."""
    rows, cols = mesh_shape(dist.get_world_size())
    return (cols, rows)


def setup():
    """(mesh, p, u0, F_local) on this rank."""
    cuda = dist.get_backend() == "nccl"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    mesh = make_mesh(grid(), ("i", "j"), device_type=dev.type)
    p = bratu2d.default_config(N, lam=LAM)
    u0 = bratu2d.initial_guess(N, dtype=torch.float64, device=dev)
    F_local = sharded_residual_2d(padded_residual, ("i", "j"), "dirichlet")
    return mesh, p, u0, F_local


def _counts(info):
    return {"solved": bool(info.solved),
            "outer": int(info.stats.outer_iterations),
            "inner": int(info.stats.inner_iterations)}


def iteration_parity() -> dict:
    """Plain CG, sharded and single-device, to tol_rel 1e-9."""
    mesh, p, u0, F_local = setup()
    kw = {"algo": "cg", "tol_rel": 1e-9, "max_niter": 25}
    u_1, info_1 = newton_krylov_jit(bratu2d.residual_scaled, u0, p, **kw)
    u_w, info_w = newton_krylov_sharded(F_local, u0, p, mesh, P("i", "j"),
                                        newton_kwargs=kw)
    u_w = gather_array(u_w, mesh, P("i", "j"))
    return {"single": _counts(info_1), "sharded": _counts(info_w),
            "max_diff": float(torch.max(torch.abs(u_w - u_1)))}


def chebyshev_parity() -> dict:
    """CG preconditioned by the degree-6 Chebyshev polynomial of the global
    operator: every polynomial step exchanges ghosts, no step reduces."""
    mesh, p, u0, F_local = setup()
    kw = {"algo": "cg", "tol_rel": 1e-9, "max_niter": 25}
    _, info_s1 = newton_krylov_jit(bratu2d.residual_scaled, u0, p,
                                   M=chebyshev(degree=6), **kw)
    _, info_sw = newton_krylov_sharded(
        F_local, u0, p, mesh, P("i", "j"),
        newton_kwargs=dict(kw, M=chebyshev(degree=6, axis_names=("i", "j"))))
    return {"single": _counts(info_s1), "sharded": _counts(info_sw)}


def global_dst() -> dict:
    """CG preconditioned by the DST-Poisson solve, the global inverse as
    distributed sine-basis products."""
    mesh, p, u0, F_local = setup()
    kw = {"algo": "cg", "tol_rel": 1e-9, "max_niter": 25}
    u_d1, info_d1 = newton_krylov_jit(bratu2d.residual_scaled, u0, p,
                                      M=fft_poisson(), **kw)
    u_dw, info_dw = newton_krylov_sharded(
        F_local, u0, p, mesh, P("i", "j"),
        newton_kwargs=dict(kw, M=fft_poisson(axis_names=("i", "j"),
                                             scope="global")))
    u_dw = gather_array(u_dw, mesh, P("i", "j"))
    return {"single": _counts(info_d1), "sharded": _counts(info_dw),
            "max_diff": float(torch.max(torch.abs(u_dw - u_d1)))}


def production() -> dict:
    """The flagship configuration sharded: f32 CG, the df32 acceptance
    residual with its words exchanged apart, the global DST."""
    mesh, p, u0, F_local = setup()
    F_df_local = sharded_residual_df_2d(
        bratu2d.residual_scaled_df_padded, ("i", "j"), "dirichlet")
    u_p, info_p = newton_krylov_sharded(
        F_local, u0, p, mesh, P("i", "j"),
        newton_kwargs={
            "algo": "cg", "tol_rel": 1e-8, "max_niter": 20,
            "M": fft_poisson(axis_names=("i", "j"), scope="global"),
            "residual_df": F_df_local,
        })
    u_p = gather_array(u_p, mesh, P("i", "j")).to(torch.float64)
    r = float(torch.linalg.norm(bratu2d.residual_scaled(u_p, p)))
    r0 = float(torch.linalg.norm(bratu2d.residual_scaled(u0, p)))
    h = info_p.history.cpu().numpy()
    return {"sharded": _counts(info_p), "r": r, "r0": r0,
            "u": u_p.cpu().numpy(), "history": h}


def all_sections() -> dict:
    """The four sections in one group; also the world and the mesh."""
    out = {"world": dist.get_world_size(), "mesh": grid()}
    for fn in (iteration_parity, chebyshev_parity, global_dst, production):
        out[fn.__name__] = fn()
    return out
