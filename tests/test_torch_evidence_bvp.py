"""The 8-partition 1-D Bratu and the BVP adjudication against the JAX records.

``run_configs``'s configuration 5 — 1-D Bratu (n = 1024, λ = 3) through
``halo.newton_krylov_sharded`` over eight spawned gloo ranks — against the
JAX run in ``benchmarks/baseline_configs.json`` (its eight virtual CPU
devices) and the port's committed record; ``bvp_adjudicate``'s banded-LU
recipes run here against ``benchmarks/bvp_adjudication.json`` and the port's
committed record.  The two stalling recipes take tens of minutes on this
CPU, so their committed CPU record is held against the JAX record as data.

Tolerances: f64 counts equal; histories within 1e-8 relative with a floor
of 1e-8·‖F₀‖ (ROADMAP.md Queue 3 item 1), the sharded solve's within 1e-4
relative over that floor (Queue 3 item 20: each side sums its f64 CG
reductions per block, and the 1-D Bratu's condition amplifies that).  The two stalling recipes are
undamped Newton iterations on inexact directions from an indefinite
Jacobian, and they amplify last-bit differences until rounding decides
their outcome (Queue 3 items 24 and 25): their histories are held only over
the outers before they part — unpreconditioned full GMRES to item 1's
tolerance over its first four entries, the nested recipe to item 24's 5%
over its first four — and each recipe's outcome in the port's record is
pinned as recorded: the JAX run ends unconverged at the cap of 50 outers,
the port's converges.
"""

import json
from pathlib import Path

import pytest

from newtonkrylov_tpu_torch.benchmarks import bvp_adjudicate, run_configs

ROOT = Path(__file__).resolve().parents[1]
JAX_CONFIGS = json.loads((ROOT / "benchmarks" / "baseline_configs.json").read_text())
PORT_CONFIGS = json.loads(Path(run_configs.OUT).read_text())
JAX_BVP = json.loads((ROOT / "benchmarks" / "bvp_adjudication.json").read_text())
PORT_BVP = json.loads(Path(bvp_adjudicate.OUT).read_text())
LU = ("banded_lu_armijo", "banded_lu_plain")
# recipe -> (entries held, relative tolerance, the port's outer, inner)
STALLING = {"reference_recipe_fgmres_nested_gmres30": (4, 0.05, 33, 27808),
            "unpreconditioned_full_gmres": (4, None, 27, 23976)}


def _history_close(got, want):
    assert len(got) == len(want)
    floor = 1e-8 * want[0]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-8 * abs(w) + floor, (g, w)


def test_eight_partition_bratu_matches_the_jax_record():
    import torch

    got = run_configs.bratu1d_multipartition(torch.device("cpu"))
    want = JAX_CONFIGS["bratu1d_multipartition"]
    assert got["n_partitions"] == want["n_partitions"] == 8
    assert got["matches_single_device"] and want["matches_single_device"]
    assert got["solved"] and want["solved"]
    assert (got["outer"], got["inner"], got["single_device_inner"]) == (
        want["outer"], want["inner"], want["single_device_inner"])
    # f64 CG reductions summed per block on either side (ROADMAP.md Queue 3
    # item 20): the history within 1e-4 relative over the floor (measured
    # 2.2e-5 at ‖F‖ ≈ 3e-8, the sixth outer)
    floor = 1e-8 * want["residual_history"][0]
    for g, w in zip(got["residual_history"], want["residual_history"]):
        assert abs(g - w) <= 1e-4 * w + floor, (g, w)
    assert len(got["residual_history"]) == len(want["residual_history"])
    mine = PORT_CONFIGS["bratu1d_multipartition"]
    assert {k: got[k] for k in ("outer", "inner", "single_device_inner",
                                "n_partitions", "matches_single_device")} == {
        k: mine[k] for k in ("outer", "inner", "single_device_inner",
                             "n_partitions", "matches_single_device")}
    _history_close(got["residual_history"], mine["residual_history"])


@pytest.mark.parametrize("recipe", LU)
def test_banded_lu_recipe_matches_the_jax_record(recipe):
    got = bvp_adjudicate.run(recipe, "cpu")
    want = JAX_BVP[recipe]
    assert got["solved"] and want["solved"]
    assert (got["outer"], got["inner"]) == (want["outer"], want["inner"])
    _history_close(got["residual_history"], want["residual_history"])
    f0 = want["residual_history"][0]
    assert abs(got["final_norm"] - want["final_norm"]) <= 1e-8 * f0
    mine = PORT_BVP[recipe]
    assert (got["outer"], got["inner"]) == (mine["outer"], mine["inner"])
    _history_close(got["residual_history"], mine["residual_history"])


def test_record_schema_is_the_jax_records():
    assert list(PORT_BVP) == list(JAX_BVP)
    for name, rec in JAX_BVP.items():
        assert list(PORT_BVP[name]) == list(rec), name


@pytest.mark.parametrize("recipe", sorted(STALLING))
def test_stalling_recipe_records_agree_until_rounding_decides(recipe):
    held, rtol, outer, inner = STALLING[recipe]
    got, want = PORT_BVP[recipe], JAX_BVP[recipe]
    head_got = got["residual_history"][:held]
    head_want = want["residual_history"][:held]
    if rtol is None:
        _history_close(head_got, head_want)
    else:
        for g, w in zip(head_got, head_want):
            assert abs(g - w) <= rtol * w, (g, w)
    assert not want["solved"] and want["outer"] == 51
    assert got["solved"] and (got["outer"], got["inner"]) == (outer, inner)
    assert got["final_norm"] <= 1e-6 * got["residual_history"][0] + 1e-12
    assert len(got["residual_history"]) == got["outer"] + 1


def test_nested_gmres_amplifies_rounding_on_the_bvp_jacobian():
    """Why the stalling recipes part (Queue 3 item 25): the nested
    GMRES(k) apply on the BVP Jacobian at u₀, the same in both packages
    (equal step counts, residual norms within 1e-6), parts from the JAX
    package's apply only through rounding, which its indefinite spectrum
    amplifies step by step: within 1e-13 after 10 steps, far more after 30
    (measured 1.3e-15, 6.7e-15, 6.4e-11 and 3.2e-7 at 5, 10, 20, 30)."""
    import math

    import jax.numpy as jnp
    import numpy as np
    import torch

    from newtonkrylov_tpu import solvers as js
    from newtonkrylov_tpu.operator import JacobianOperator as JJ
    from newtonkrylov_tpu.problems import bvp as jb
    from newtonkrylov_tpu_torch import solvers as ts
    from newtonkrylov_tpu_torch.operator import JacobianOperator as TJ
    from newtonkrylov_tpu_torch.problems import bvp as tbv

    sq = math.sqrt(2.220446049250313e-16)
    pj, pt = jb.default_config(), tbv.default_config(device="cpu")
    Jj = JJ(jb.residual, jb.initial_guess(pj), pj)
    Jt = TJ(tbv.residual, tbv.initial_guess(pt), pt)
    b = np.asarray(Jj.res)
    b = b / np.linalg.norm(b)
    rel = {}
    for k in (10, 30):
        rj = js.solve("gmres", Jj, jnp.asarray(b), itmax=k, restart=k,
                      rtol=sq, atol=sq)
        rt = ts.solve("gmres", Jt, torch.from_numpy(b.copy()), itmax=k,
                      restart=k, rtol=sq, atol=sq)
        zj, zt = np.asarray(rj.x), rt.x.numpy()
        rel[k] = np.linalg.norm(zj - zt) / np.linalg.norm(zj)
        print(k, int(rj.niter), int(rt.niter), rel[k])
        assert int(rj.niter) == int(rt.niter) == k
        assert abs(float(rj[2]) - float(rt[2])) <= 1e-6 * float(rj[2])
    assert rel[10] <= 1e-13
    assert rel[30] > 1e3 * rel[10]
