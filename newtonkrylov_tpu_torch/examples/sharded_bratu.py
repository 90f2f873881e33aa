"""Multi-device halo-exchange Bratu solve: block-shard the 2-D interior over
a mesh of processes, exchange ghosts between neighbours, all-reduce every
reduction, and check the result against the single-device solve.

Counterpart of ``examples/sharded_bratu.py``.  The port runs one process per
device, so the example needs a process group of W ranks::

    torchrun --standalone --nproc-per-node W -m newtonkrylov_tpu_torch.examples.sharded_bratu
    torchrun --standalone --nproc-per-node 4 -m newtonkrylov_tpu_torch.examples.sharded_bratu --device cpu

or ``utils.distributed.run_processes(rank_main, W, device=...)``
(``rank_main`` is the per-rank code; spawned ranks import it by name).
Alone, ``main`` runs a group of one process on a file store: NCCL on the
card, gloo on the CPU.

The meshes follow the world (:func:`meshes`): at W = 4 the JAX example's
(2, 2) and (4,) meshes for plain CG and (2, 2) for the global DST; at
W = 8 (2, 4), (8,) and (2, 4) — a port mesh spans the whole group
(``halo.make_mesh``), so the JAX example's (2, 2) mesh over four of its
eight devices has no counterpart there; at W = 1 a 1×1 mesh, whose
exchange sends no message and whose reductions are real collectives.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from newtonkrylov_tpu_torch import newton_krylov_jit
from newtonkrylov_tpu_torch.examples import _common
from newtonkrylov_tpu_torch.fftprec import fft_poisson
from newtonkrylov_tpu_torch.halo import (P, gather_array, make_mesh, mesh_shape,
                                         newton_krylov_sharded, sharded_residual_2d)
from newtonkrylov_tpu_torch.problems import bratu2d
from newtonkrylov_tpu_torch.utils import distributed as D


def padded_residual(up, p):
    u = up[1:-1, 1:-1]
    stencil = up[2:, 1:-1] + up[:-2, 1:-1] + up[1:-1, 2:] + up[1:-1, :-2] - 4.0 * u
    return stencil + (p.dx * p.dx) * p.lam * torch.exp(u)


def meshes(world: int):
    """``(cg_meshes, dst_mesh)`` for a group of ``world`` ranks: each CG mesh
    a ``(shape, axes, spec)``, the global-DST mesh a 2-D shape."""
    rows, cols = mesh_shape(world)  # rows ≥ cols
    grid = (cols, rows)
    cg = [(grid, ("i", "j"), P("i", "j"))]
    if world > 1:
        cg.append(((world,), ("i",), P("i", None)))
    return cg, grid


def rank_main() -> dict:
    """The per-rank code, in an initialized process group: the
    single-device solves on this rank's device, then the sharded solves on
    every mesh of :func:`meshes`.  Rank 0 prints; every rank returns the
    same summary (states gathered)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    cuda = dist.get_backend() == "nccl"
    device_type = "cuda" if cuda else "cpu"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    say = print if rank == 0 else (lambda *a, **k: None)

    say(f"devices: {world} (one process each, {dist.get_backend()})")
    n = 64
    p = bratu2d.default_config(n, lam=5.0)
    u0 = bratu2d.initial_guess(n, device=dev)

    u_ref, info_ref = newton_krylov_jit(bratu2d.residual_scaled, u0, p, algo="cg")
    ref_inner = int(info_ref.stats.inner_iterations)
    out = {"world": world, "single": {
        "solved": bool(info_ref.solved),
        "outer": int(info_ref.stats.outer_iterations), "inner": ref_inner,
        "u": _common.numpy(u_ref)}, "meshes": {}}

    cg_meshes, dst_shape = meshes(world)
    for shape, axes, spec in cg_meshes:
        mesh = make_mesh(shape, axes, device_type=device_type)
        F_local = sharded_residual_2d(
            padded_residual, (axes[0], axes[1] if len(axes) > 1 else None),
            "dirichlet")
        u_sh, info_sh = newton_krylov_sharded(
            F_local, u0, p, mesh, spec, newton_kwargs={"algo": "cg"})
        u_g = gather_array(u_sh, mesh, spec)
        diff = float(torch.max(torch.abs(u_g - u_ref)))
        rec = {"solved": bool(info_sh.solved),
               "outer": int(info_sh.stats.outer_iterations),
               "inner": int(info_sh.stats.inner_iterations),
               "max_diff": diff, "u": _common.numpy(u_g)}
        out["meshes"][shape] = rec
        say(f"mesh {shape}: solved={rec['solved']} outer={rec['outer']} "
            f"inner={rec['inner']} (single-device: {ref_inner}) "
            f"max|Δu|={diff:.2e}")

    # The flagship preconditioner, sharded-exact: fft_poisson(scope="global")
    # runs the single-device DST eigen-solve as distributed sine-basis
    # products (reduce-scatters, no all-gather) — the counts match the
    # single-device preconditioned solve.
    u_d1, info_d1 = newton_krylov_jit(
        bratu2d.residual_scaled, u0, p, algo="cg", M=fft_poisson())
    mesh = make_mesh(dst_shape, ("i", "j"), device_type=device_type)
    F_local = sharded_residual_2d(padded_residual, ("i", "j"), "dirichlet")
    u_d, info_d = newton_krylov_sharded(
        F_local, u0, p, mesh, P("i", "j"),
        newton_kwargs={"algo": "cg",
                       "M": fft_poisson(axis_names=("i", "j"), scope="global")})
    u_dg = gather_array(u_d, mesh, P("i", "j"))
    diff = float(torch.max(torch.abs(u_dg - u_d1)))
    out["dst"] = {"shape": dst_shape, "solved": bool(info_d.solved),
                  "outer": int(info_d.stats.outer_iterations),
                  "inner": int(info_d.stats.inner_iterations),
                  "single_outer": int(info_d1.stats.outer_iterations),
                  "single_inner": int(info_d1.stats.inner_iterations),
                  "max_diff": diff, "u": _common.numpy(u_dg)}
    say(f"mesh {dst_shape} + global DST: solved={out['dst']['solved']} "
        f"inner={out['dst']['inner']} "
        f"(single-device DST: {out['dst']['single_inner']}) "
        f"max|Δu|={diff:.2e}")
    return out


def main(device="cuda", plot=False) -> dict:
    """Run :func:`rank_main` in the process group there is (``torchrun``),
    or in a group of one."""
    del plot  # the JAX example draws no figure
    dev = _common.resolve_device(device)
    if D.initialize(device=dev):
        return rank_main()
    store = tempfile.mkdtemp(prefix="nk_sharded_bratu_")
    try:
        D.initialize("file://" + os.path.join(store, "store"), 1, 0, device=dev)
        return rank_main()
    finally:
        D.shutdown()
        shutil.rmtree(store, ignore_errors=True)


if __name__ == "__main__":
    _common.cli(main, __doc__)
