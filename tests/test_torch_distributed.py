"""The port's multi-process bring-up (``utils.distributed``) in real
separate processes, against the JAX package's (oracle:
tests/test_distributed.py).

Two OS processes form a gloo group through ``initialize``'s real branches —
explicit arguments with a ``file://`` store, and the ``torchrun``
environment — and run the halo-exchange matvec with a sharded norm, then
the production sharded solve (f32 CG, the global DST, the df32 acceptance
residual).  The dry run runs under ``torchrun`` on four CPU ranks.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds per child process

_CHILD_MATVEC = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from newtonkrylov_tpu_torch.utils import distributed as D

store, pid = sys.argv[1], int(sys.argv[2])
ok = D.initialize("file://" + store, 2, pid, device="cpu")
assert ok, "initialize() must take the explicit branch"
assert D.is_multihost(), D.host_summary()

from newtonkrylov_tpu_torch import halo
from newtonkrylov_tpu_torch.spaces import ShardedSpace

mesh = halo.make_mesh((2,), ("i",), device_type="cpu")
spec = halo.P("i", None)
n, m = 32, 16
host = np.arange(n * m, dtype=np.float32).reshape(n, m) / (n * m)
u = halo.shard_array(torch.tensor(host), mesh, spec)
vp = halo.exchange_2d(u, ("i", None), "dirichlet")
core = vp[1:-1, 1:-1]
lap = vp[2:, 1:-1] + vp[:-2, 1:-1] + vp[1:-1, 2:] + vp[1:-1, :-2] - 4.0 * core
norm = float(ShardedSpace(("i",)).norm(lap))
full = halo.gather_array(lap, mesh, spec).numpy()
print("RESULT " + json.dumps({"pid": pid, "norm": norm, "lap": full.tolist(),
                              "summary": D.host_summary()}))
D.shutdown()
"""

_CHILD_SOLVE = r"""
import json, os
import numpy as np
import torch
torch.set_num_threads(1)
from newtonkrylov_tpu_torch.utils import distributed as D

ok = D.initialize(device="cpu")  # the torchrun environment
assert ok and D.is_multihost()
pid = int(os.environ["RANK"])

import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu_torch import halo
from newtonkrylov_tpu_torch.fftprec import fft_poisson
from newtonkrylov_tpu_torch.problems import bratu2d
from newtonkrylov_tpu_torch.utils.dryrun import bratu_padded

n = 16
p = bratu2d.default_config(n, lam=4.0)
u0 = torch.zeros((n, n), dtype=torch.float32)
mesh = halo.make_mesh((2, 1), ("i", "j"), device_type="cpu")
F = halo.sharded_residual_2d(bratu_padded, ("i", "j"), "dirichlet")
F_df = halo.sharded_residual_df_2d(bratu2d.residual_scaled_df_padded,
                                   ("i", "j"), "dirichlet")
u, info = halo.newton_krylov_sharded(
    F, u0, p, mesh, halo.P("i", "j"),
    newton_kwargs=dict(algo="cg", tol_rel=1e-6, max_niter=10,
                       M=fft_poisson(axis_names=("i", "j"), scope="global",
                                     precision="high"),
                       precond_refresh="once", residual_df=F_df))
assert bool(info.solved), "cross-process production solve failed"
u_ref, info_ref = nkt.newton_krylov_jit(
    bratu2d.residual_scaled, u0, p, algo="cg", tol_rel=1e-6, max_niter=10,
    M=fft_poisson(precision="high"), precond_refresh="once",
    residual_df=bratu2d.residual_scaled_df)
full = halo.gather_array(u, mesh, halo.P("i", "j"))
print("RESULT " + json.dumps({
    "pid": pid, "outer": int(info.stats.outer_iterations),
    "inner": int(info.stats.inner_iterations),
    "outer_single": int(info_ref.stats.outer_iterations),
    "inner_single": int(info_ref.stats.inner_iterations),
    "u": full.numpy().tolist(), "u_single": u_ref.numpy().tolist()}))
D.shutdown()
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    env.update(extra)
    return env


def _run(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        line = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert line, out
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_matvec(tmp_path):
    """Two processes through ``initialize``'s explicit branch (a ``file://``
    store): the exchanged 5-point matvec and its sharded norm equal the
    single-process numpy oracle (rtol 1e-6, the JAX test's) and the JAX
    package's shard_map matvec (its norm within 2 f32 epsilons)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from newtonkrylov_tpu.halo import exchange_2d, make_mesh
    from newtonkrylov_tpu.spaces import ShardedSpace

    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD_MATVEC, store, str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=_env()) for pid in (0, 1)]
    results = _run(procs)

    n, m = 32, 16
    host = np.arange(n * m, dtype=np.float32).reshape(n, m) / (n * m)
    hp = np.zeros((n + 2, m + 2), np.float32)
    hp[1:-1, 1:-1] = host
    ref = hp[2:, 1:-1] + hp[:-2, 1:-1] + hp[1:-1, 2:] + hp[1:-1, :-2] - 4.0 * host

    mesh = make_mesh((4,), ("i",))

    def matvec_local(v):
        vp = exchange_2d(v, ("i", None), "dirichlet")
        core = vp[1:-1, 1:-1]
        lap = vp[2:, 1:-1] + vp[:-2, 1:-1] + vp[1:-1, 2:] + vp[1:-1, :-2] - 4.0 * core
        return lap, ShardedSpace(("i",)).norm(lap)

    lap_j, norm_j = jax.jit(jax.shard_map(
        matvec_local, mesh=mesh, in_specs=(JP("i", None),),
        out_specs=(JP("i", None), JP()), check_vma=False))(jnp.asarray(host))
    for r in results:
        assert r["summary"].startswith(f"process {r['pid']}/2, backend gloo")
        lap = np.asarray(r["lap"], np.float32)
        np.testing.assert_allclose(lap, ref, rtol=1e-6)
        np.testing.assert_array_equal(lap, np.asarray(lap_j))
        np.testing.assert_allclose(r["norm"], float(np.linalg.norm(ref)), rtol=1e-6)
        np.testing.assert_allclose(r["norm"], float(norm_j),
                                   rtol=2 * np.finfo(np.float32).eps)


def test_two_process_production_solve():
    """The production sharded configuration (f32 CG, the global DST as
    distributed sine products, df32 acceptance) over two processes that
    meet through the ``torchrun`` environment: the single-process solve's
    counts and the JAX package's single-device counts, the state within
    2e-6 of both (the JAX test's)."""
    import jax.numpy as jnp

    from newtonkrylov_tpu.fftprec import fft_poisson
    from newtonkrylov_tpu.newton import newton_krylov_jit
    from newtonkrylov_tpu.problems import bratu2d

    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD_SOLVE],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=_env(RANK=str(pid), WORLD_SIZE="2", LOCAL_RANK=str(pid),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
        for pid in (0, 1)]
    results = _run(procs)

    n = 16
    u_j, info_j = newton_krylov_jit(
        bratu2d.residual_scaled, jnp.zeros((n, n), jnp.float32),
        bratu2d.default_config(n, lam=4.0), algo="cg", tol_rel=1e-6,
        max_niter=10, M=fft_poisson(precision="high"), precond_refresh="once",
        residual_df=bratu2d.residual_scaled_df)
    counts_j = (int(info_j.stats.outer_iterations), int(info_j.stats.inner_iterations))
    for r in results:
        assert (r["outer"], r["inner"]) == (r["outer_single"], r["inner_single"])
        assert (r["outer"], r["inner"]) == counts_j
        u = np.asarray(r["u"])
        np.testing.assert_allclose(u, np.asarray(r["u_single"]), atol=2e-6)
        np.testing.assert_allclose(u, np.asarray(u_j), atol=2e-6)


def test_dryrun_under_torchrun_on_four_cpu_ranks():
    """``torchrun --standalone --nproc-per-node 4 -m
    newtonkrylov_tpu_torch.utils.dryrun --device cpu``: both sharded
    solves converge on the 2×2 mesh, and the flagship reduce-scatters
    (four per global-DST apply) and exchanges ghosts."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "newtonkrylov_tpu_torch.utils.dryrun",
         "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=_env(OMP_NUM_THREADS="1"),
        timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    summary = json.loads([l for l in out.stdout.splitlines() if l.startswith("{")][-1])
    assert summary["world"] == 4 and summary["mesh"] == [2, 2] and summary["n"] == 16
    flag = summary["flagship"]
    single = flag["unsharded"]  # rank 0's unsharded solve of the same problem
    assert (flag["outer"], flag["inner"]) == (single["outer"], single["inner"])
    assert single["max_abs_diff"] <= 1e-6
    assert flag["collectives"]["reduce_scatter"] == 4 * (flag["inner"] + flag["outer"])
    assert flag["collectives"]["p2p"] > 0
    assert summary["ptc"]["steps"] >= 1


def test_initialize_without_environment_is_a_no_op(monkeypatch):
    """Single-process, no arguments, no torchrun environment: False, as the
    JAX package's ``initialize``; nothing is multi-process."""
    from newtonkrylov_tpu_torch.utils import distributed as D

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert D.initialize() is False
    assert not D.is_multihost()
    assert D.host_summary() == "process 0/1, no process group"


def test_initialize_refuses_the_card_without_cuda(tmp_path):
    """Asking for the card (NCCL) without CUDA raises; it does not fall back
    to gloo."""
    import torch

    from newtonkrylov_tpu_torch.utils import distributed as D

    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.initialize("file://" + str(tmp_path / "store"), 1, 0)
