"""Multi-device dry run of the sharded solvers.

Counterpart of ``__graft_entry__.dryrun_multichip``: the 2-D Bratu interior
block-sharded over the squarest 2-D mesh of the process group, solved twice
in the sharded production configuration —

1. the flagship: the overlapped ghost exchange in an f32 CG loop, the
   globally exact DST preconditioner (``fft_poisson(scope="global",
   precision="high")``) built once, and the df32 acceptance residual with
   its hi and lo words exchanged apart;
2. pseudo-transient continuation (``driver=pseudo_transient``) on the same
   mesh, its residuals sign-flipped (Ψtc follows du/dτ = −F) and
   δ₀ = (n+1)², the Δx²-scaled residual's pseudo-time unit, with the global
   DST rebuilt every step on the shifted operator.

Run one process per device::

    torchrun --nproc-per-node N -m newtonkrylov_tpu_torch.utils.dryrun
    torchrun --nproc-per-node 4 -m newtonkrylov_tpu_torch.utils.dryrun --device cpu

Without ``torchrun`` it runs a group of one process.  The card (NCCL) is the
default device; ``--device cpu`` runs gloo.  Rank 0 prints one JSON line of
counts, walls and collectives, and holds the sharded flagship against the
same solve unsharded on its own device (counts and max|Δu|).  Each rank
holds an 8×8 block unless ``--side`` sets the global side.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from . import distributed as D

__all__ = ["bratu_padded", "dryrun", "main"]


def bratu_padded(up, p):
    """The Δx²-scaled 2-D Bratu residual on a padded (nl+2, ml+2) block."""
    u = up[1:-1, 1:-1]
    stencil = up[2:, 1:-1] + up[:-2, 1:-1] + up[1:-1, 2:] + up[1:-1, :-2] - 4.0 * u
    return stencil + (p.dx * p.dx) * p.lam * torch.exp(u)


def dryrun(n=None, lam: float = 4.0, device_type: str = "cuda") -> dict:
    """Both sharded solves on a mesh of the whole (initialized) group;
    raises if either fails.  Returns a summary on every rank."""
    from .. import df32
    from ..continuation import pseudo_transient
    from ..fftprec import fft_poisson
    from ..halo import (P, gather_array, make_mesh, mesh_shape,
                        newton_krylov_sharded, sharded_residual_2d,
                        sharded_residual_df_2d)
    from ..newton import newton_krylov_jit
    from ..problems import bratu2d

    shape = mesh_shape(dist.get_world_size())
    mesh = make_mesh(shape, ("i", "j"), device_type=device_type)
    n = n or 8 * max(shape)
    p = bratu2d.default_config(n, lam=lam)
    u0 = bratu2d.initial_guess(n, torch.float64, D.mesh_device(mesh))
    axes = ("i", "j")
    F_local = sharded_residual_2d(bratu_padded, axes, "dirichlet")
    F_df_local = sharded_residual_df_2d(bratu2d.residual_scaled_df_padded,
                                        axes, "dirichlet")
    M = fft_poisson(axis_names=axes, scope="global", precision="high")
    summary = {"world": dist.get_world_size(), "mesh": list(shape), "n": n}

    kw = dict(algo="cg", max_niter=10, tol_rel=1e-5, precond_refresh="once")
    D.reset_collective_counts()
    u, info = newton_krylov_sharded(
        F_local, u0, p, mesh, P("i", "j"),
        newton_kwargs=dict(kw, M=M, residual_df=F_df_local))
    if not (bool(torch.isfinite(u).all()) and bool(info.solved)):
        raise AssertionError("the sharded flagship solve did not converge")
    summary["flagship"] = {
        "outer": int(info.stats.outer_iterations),
        "inner": int(info.stats.inner_iterations),
        "wall_s": info.t, "collectives": dict(D.COLLECTIVES)}
    u_global = gather_array(u, mesh, P("i", "j"))
    if dist.get_rank() == 0:
        # the same solve unsharded, on this rank's device
        u1, info1 = newton_krylov_jit(
            bratu2d.residual_scaled, u0, p, M=fft_poisson(precision="high"),
            residual_df=bratu2d.residual_scaled_df, **kw)
        summary["flagship"]["unsharded"] = {
            "outer": int(info1.stats.outer_iterations),
            "inner": int(info1.stats.inner_iterations),
            "max_abs_diff": float((u_global - u1).abs().max())}

    def F_ptc_local(ul, pp):
        return -F_local(ul, pp)

    def F_ptc_df_local(ud, pp):
        return df32.neg(F_df_local(ud, pp))

    D.reset_collective_counts()
    u2, info2 = newton_krylov_sharded(
        F_ptc_local, u0, p, mesh, P("i", "j"), driver=pseudo_transient,
        newton_kwargs=dict(algo="cg", max_steps=25, tol_rel=1e-5,
                           delta0=float((n + 1) ** 2), M=M,
                           residual_df=F_ptc_df_local))
    if not (bool(torch.isfinite(u2).all()) and bool(info2.solved)):
        raise AssertionError("the sharded pseudo-transient solve did not "
                             "converge")
    summary["ptc"] = {
        "steps": int(info2.stats.outer_iterations),
        "inner": int(info2.stats.inner_iterations),
        "wall_s": info2.t, "collectives": dict(D.COLLECTIVES)}
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--side", type=int, default=None,
                    help="global side (default: 8 per rank along the longer "
                         "mesh axis)")
    ap.add_argument("--lam", type=float, default=4.0)
    args = ap.parse_args(argv)

    store = None
    if not D.initialize(device=args.device):
        store = tempfile.mkdtemp(prefix="nk_dryrun_")
        D.initialize("file://" + os.path.join(store, "store"), 1, 0,
                     device=args.device)
    try:
        t0 = time.perf_counter()
        summary = dryrun(args.side, args.lam, args.device)
        summary["total_s"] = time.perf_counter() - t0
        if dist.get_rank() == 0:
            print(json.dumps(summary), flush=True)
    finally:
        D.shutdown()
        if store is not None:
            import shutil

            shutil.rmtree(store, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
