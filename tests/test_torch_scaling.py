"""The port's weak-scaling harness (``utils/scaling.py``) against the JAX
package's (oracles: tests/test_utils.py:82-95 and
tests/test_scaling_structure.py).

The stencil J·v is held to the JAX package's bit for bit.  The harness runs
on two gloo ranks in one spawn: the points of meshes of the first 1 and 2
ranks, the same on every rank, and the ghost exchanges one matvec issues,
which must not depend on the mesh size (the JAX test's collective count).
A rate measured here is the CPU's, not a device metric.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonkrylov_tpu.utils.scaling import _stencil_jvp_local as j_stencil
from newtonkrylov_tpu_torch.utils.scaling import _stencil_jvp_local

RANK_TIMEOUT = 240.0
LOCAL_N, CHAIN, REPEATS = 32, 10, 1
# matvecs one time_chain call runs: a warm-up of each chain, then REPEATS
# of each (chains of CHAIN // 10 and CHAIN steps)
MATVECS = (1 + REPEATS) * (max(1, CHAIN // 10) + CHAIN)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_stencil_jvp_local_matches_jax(dtype):
    """The harness's local stencil J·v equals the JAX package's bit for bit
    on the same seeded padded block and coefficient field."""
    rng = np.random.default_rng(0)
    up = rng.standard_normal((34, 18)).astype(dtype)
    w = rng.standard_normal((32, 16)).astype(dtype)
    got = _stencil_jvp_local(torch.from_numpy(up), torch.from_numpy(w))
    want = np.asarray(j_stencil(jnp.asarray(up), jnp.asarray(w)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def scaling_cases():
    """Rank side: the points and each mesh size's exchange counts."""
    from newtonkrylov_tpu_torch.utils import distributed as D
    from newtonkrylov_tpu_torch.utils import scaling

    kw = dict(chain=CHAIN, repeats=REPEATS, device="cpu")
    out = {"points": [tuple(p) for p in scaling.weak_scaling_matvec(
        local_n=LOCAL_N, device_counts=[1, 2], **kw)]}
    for d in (1, 2):
        D.reset_collective_counts()
        scaling.weak_scaling_matvec(local_n=LOCAL_N, device_counts=[d], **kw)
        out[f"collectives_{d}"] = dict(D.COLLECTIVES)
    D.reset_collective_counts()
    out["point_2d"] = tuple(scaling.weak_scaling_matvec_2d(
        LOCAL_N, (2, 1), **kw))
    out["collectives_2d"] = dict(D.COLLECTIVES)
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    from newtonkrylov_tpu_torch.utils import distributed as D

    store = tmp_path_factory.mktemp("store2")
    return D.run_processes(scaling_cases, 2, timeout=RANK_TIMEOUT,
                           store_dir=str(store))


def test_weak_scaling_harness_structure(world2):
    """Points [1, 2] with positive rates and efficiency 1.0 first
    (test_weak_scaling_harness_structure), the same on both ranks."""
    pts = world2[0]["points"]
    assert [p[0] for p in pts] == [1, 2]
    assert [p[1] for p in pts] == [LOCAL_N, 2 * LOCAL_N]
    assert all(np.isfinite(p[2]) and p[2] > 0 for p in pts)
    assert pts[0][3] == 1.0
    assert world2[1]["points"] == pts
    n_dev, global_n, rate, eff = world2[0]["point_2d"]
    assert (n_dev, global_n) == (2, 2 * LOCAL_N) and rate > 0 and np.isnan(eff)


def test_exchanges_per_matvec_independent_of_mesh_size(world2):
    """One ghost exchange per matvec on a mesh of 1 rank and of 2 ranks
    (test_1d_exchange_collective_count_mesh_independent: the collective
    count does not grow with the mesh); the 2-rank mesh sends its two
    messages per matvec, the 1-rank mesh none; no all-gather; one
    all-reduce per point (the agreed rate)."""
    one, two = world2[0]["collectives_1"], world2[0]["collectives_2"]
    assert one["exchange"] == two["exchange"] == MATVECS
    assert (one["p2p"], two["p2p"]) == (0, 2 * MATVECS)
    assert one["all_gather"] == two["all_gather"] == 0
    assert one["all_reduce"] == two["all_reduce"] == 1
    # the rank outside the 1-rank mesh runs no matvec
    assert world2[1]["collectives_1"]["exchange"] == 0
    # the (2, 1) mesh: one exchange per mesh axis and matvec (the column
    # axis, of size 1, sends nothing and takes zeros)
    assert world2[0]["collectives_2d"]["exchange"] == 2 * MATVECS
    assert world2[0]["collectives_2d"]["p2p"] == 2 * MATVECS


def test_scaling_main_prints_points():
    """``python -m newtonkrylov_tpu_torch.utils.scaling`` without torchrun
    runs a group of one process and prints the points as JSON."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run(
        [sys.executable, "-m", "newtonkrylov_tpu_torch.utils.scaling",
         "--device", "cpu", "--local-n", "16", "--chain", "10",
         "--repeats", "1", "--mesh-2d", "1x1"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["world"] == 1
    assert [p["n_devices"] for p in res["points"]] == [1]
    assert res["points"][0]["efficiency"] == 1.0
    assert res["point_2d"]["n_devices"] == 1
