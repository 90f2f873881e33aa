"""The five BASELINE configurations end to end, with their behavioural record.

Counterpart of ``benchmarks/run_configs.py``: each configuration of
``BASELINE.json`` through the port's public entry points, recording what
the reference returns from every solve (solved, the outer and inner counts,
the final ‖F‖, the residual history and a few values of the solution):

1. ``simple_gmres`` — the 2×2 system of simple.jl, JFNK + GMRES;
2. ``heat1d_implicit_euler`` — heat_1D, 30 implicit Euler steps of Δt = 0.1
   (m = 100, a = 0.2) through ``timestep.integrate``;
3. ``bvp_fgmres_linesearch`` — Kelley's BVP, GMRES + ``banded_lu(2, 2)`` +
   Armijo through ``newton_krylov``;
4. ``bratu2d_ew`` — 2-D Bratu 256² (λ = 5), CG with an f32 Krylov loop
   refined to 1e-8 (Eisenstat–Walker);
5. ``bratu1d_multipartition`` — 1-D Bratu (n = 1024, λ = 3) through
   ``halo.newton_krylov_sharded`` with CG over every rank of the process
   group (``sharded_residual_1d``, Dirichlet ghosts), against the unsharded
   solve.  On the CPU eight spawned gloo ranks; on the card the caller's
   process group, or a world-1 NCCL group of its own; ``n_partitions``
   records its size.

The port's committed record, ``newtonkrylov_tpu_torch/benchmarks/
baseline_configs.json``, is a CPU f64 run in the JAX record's schema:

    python -m newtonkrylov_tpu_torch.benchmarks.run_configs --device cpu

(the card by default, where nothing is written unless ``--out`` names a
file; ``--out`` writes elsewhere, ``--out ''`` nowhere).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "baseline_configs.json")
CONFIGS = ("simple_gmres", "heat1d_implicit_euler", "bvp_fgmres_linesearch",
           "bratu2d_ew", "bratu1d_multipartition")
PARTITIONS = 8  # the JAX run's mesh (eight virtual CPU devices)
N1D, LAM1D = 1024, 3.0


def record(info, **extra) -> dict:
    """The JAX record's fields of a ``NewtonInfo`` (the finite history)."""
    out = {"solved": bool(info.solved),
           "outer": int(info.stats.outer_iterations),
           "inner": int(info.stats.inner_iterations),
           "n_res": float(info.stats.n_res)}
    h = getattr(info, "history", None)
    if h is not None:
        h = torch.as_tensor(h).detach().cpu().double()
        out["residual_history"] = [float(x) for x in h[torch.isfinite(h)]]
    out.update(extra)
    return out


def simple_gmres(device) -> dict:
    from .. import newton_krylov_jit
    from ..problems import simple

    u, info = newton_krylov_jit(
        simple.residual, torch.tensor([2.0, 0.5], dtype=torch.float64,
                                      device=device))
    return record(info, solution=[float(x) for x in u.cpu()])


def heat1d_implicit_euler(device) -> dict:
    from ..problems import heat1d
    from ..timestep import integrate

    p = heat1d.default_config(m=100, a=0.2)
    x = heat1d.grid(100, device=device)
    u0 = heat1d.clamp_bc(heat1d.initial_condition(x), p)
    r = integrate("euler", heat1d.rhs, u0, p, 0.1, 3.0)
    outer = [int(v) for v in torch.as_tensor(r.outer_iterations).cpu()]
    return {"n_steps": len(outer), "n_failed": int(r.n_failed),
            "outer_per_step": outer,
            "final_norm": float(torch.linalg.vector_norm(r.u))}


def bvp_fgmres_linesearch(device) -> dict:
    from .. import newton_krylov, precond
    from ..problems import bvp

    pb = bvp.default_config(device=device)
    U, info = newton_krylov(bvp.residual, bvp.initial_guess(pb), pb,
                            algo="gmres", N=precond.banded_lu(2, 2),
                            linesearch="armijo")
    return record(info, bc_vp0=float(U[1]), bc_vend=float(U[-2]))


def bratu2d_ew(device) -> dict:
    from .. import newton_krylov_jit
    from ..problems import bratu2d

    n2 = 256
    p2 = bratu2d.default_config(n2, lam=5.0)
    u2, info = newton_krylov_jit(
        bratu2d.residual_scaled,
        bratu2d.initial_guess(n2, dtype=torch.float64, device=device), p2,
        algo="cg", tol_rel=1e-8, krylov_dtype=torch.float32)
    return record(info, center=float(u2[n2 // 2, n2 // 2]))


def bratu1d_padded(yp, pp):
    """The 1-D Bratu residual on a ghost-padded block."""
    y = yp[1:-1]
    return (yp[2:] - 2.0 * y + yp[:-2]) + (pp.dx * pp.dx) * pp.lam * torch.exp(y)


def partition_rank() -> dict:
    """Config 5 on every rank of the current process group (its device is
    the group's: the card under NCCL, the CPU under gloo); the record, the
    same on every rank."""
    import torch.distributed as dist

    from .. import halo, newton_krylov_jit
    from ..problems import bratu1d

    world = dist.get_world_size()
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    p1 = bratu1d.default_config(N1D, lam=LAM1D)
    u0 = bratu1d.initial_guess(N1D, device=dev)
    mesh = halo.make_mesh((world,), ("i",), device_type=dev)
    F_local = halo.sharded_residual_1d(bratu1d_padded, "i", "dirichlet")
    u_loc, info_sh = halo.newton_krylov_sharded(
        F_local, u0, p1, mesh, halo.P("i"), newton_kwargs={"algo": "cg"})
    u_sh = halo.gather_array(u_loc, mesh, halo.P("i"))
    u_single, info_single = newton_krylov_jit(
        bratu1d.residual_scaled, u0, p1, algo="cg")
    match = bool(torch.allclose(u_sh, u_single, rtol=1e-5, atol=1e-9))
    return record(info_sh, n_partitions=world, matches_single_device=match,
                  single_device_inner=int(info_single.stats.inner_iterations))


def bratu1d_multipartition(device) -> dict:
    """Config 5: on the CPU ``PARTITIONS`` spawned gloo ranks; on the card
    the caller's process group, or without one a world-1 NCCL group of its
    own (NCCL refuses two ranks on one card)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from ..utils import distributed as D

    if device.type == "cpu":
        return D.run_processes(partition_rank, PARTITIONS, timeout=600.0)[0]
    if dist.is_initialized():
        return partition_rank()
    store = tempfile.mkdtemp(prefix="nk_run_configs_")
    try:
        D.initialize("file://" + os.path.join(store, "store"), 1, 0,
                     device="cuda")
        return partition_rank()
    finally:
        D.shutdown()
        shutil.rmtree(store, ignore_errors=True)


def run(device="cuda", configs: Sequence[str] = CONFIGS,
        out: Optional[str] = None, log=print) -> dict:
    """The configurations named in ``configs`` on ``device`` (the card by
    default: without CUDA it raises unless ``device="cpu"``); writes the
    record to ``out`` when given."""
    from ..examples import _common

    dev = _common.resolve_device(device)
    fns = {name: globals()[name] for name in CONFIGS}
    results = {}
    for name in configs:
        results[name] = fns[name](dev)
        r = results[name]
        log(f"[run_configs] {name}: " + json.dumps(
            {k: v for k, v in r.items() if k != "residual_history"}))
    if out:
        with open(out, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
        log(f"[run_configs] wrote {out}")
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--configs", nargs="+", choices=CONFIGS, default=list(CONFIGS))
    ap.add_argument("--out", default=None,
                    help="where to write the record (default: the committed "
                         "record for --device cpu, nowhere on the card)")
    a = ap.parse_args(argv)
    out = a.out if a.out is not None else (OUT if a.device == "cpu" else None)
    run(a.device, a.configs, out or None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
