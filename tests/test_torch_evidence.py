"""The port's ``run_configs`` against the JAX package's behavioural record.

``benchmarks/baseline_configs.json`` (the JAX run of the five BASELINE
configurations, read here as data) against the port's own run on the CPU,
and the port's committed record
(``newtonkrylov_tpu_torch/benchmarks/baseline_configs.json``) against a
fresh run.  Configurations 1–4 here; the 8-partition 1-D Bratu and the BVP
adjudication in ``test_torch_evidence_bvp.py``.

Tolerances, as the existing parity tests hold them:

* ``simple_gmres`` and ``bvp_fgmres_linesearch`` (f64): solved and the
  counts equal; histories and ‖F‖ within 1e-8 relative with a floor of
  1e-8·‖F₀‖ (ROADMAP.md Queue 3 item 1: ``exp`` differs in the last bit);
  the solution within 1e-12, the BVP's boundary values exactly;
* ``heat1d_implicit_euler`` (GMRES marches, Queue 3 item 18): every step
  solved, the step count equal, each step's outer count within one, the
  final norm within sqrt(m + 2)·steps·tol_abs (the states within
  steps·tol_abs);
* ``bratu2d_ew`` (an f32 Krylov loop): solved, the outer count equal and
  the inner count within 5% (Queue 3 item 2: f32 dots summed in another
  order; the JAX run took 1498, the port 1478 with two CPU threads, 1434
  with one and 1475 on the card), the final ‖F‖ under the
  1e-8·‖F₀‖ + 1e-12 tolerance, the centre value within 1e-8.

The fresh run uses two CPU threads, as the committed record's did.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from newtonkrylov_tpu_torch.benchmarks import run_configs

ROOT = Path(__file__).resolve().parents[1]
JAX_RECORD = json.loads((ROOT / "benchmarks" / "baseline_configs.json").read_text())
PORT_RECORD = json.loads(Path(run_configs.OUT).read_text())
CONFIGS = run_configs.CONFIGS[:4]
F32_INNER_RTOL = 0.05
HEAT_STEPS_TOL = 6e-6  # timestep.integrate's tol_abs
HEAT_M = 100


@pytest.fixture(scope="module")
def fresh():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return run_configs.run("cpu", CONFIGS, log=lambda *a: None)
    finally:
        torch.set_num_threads(threads)


def _history_close(got, want):
    """Queue 3 item 1: rtol 1e-8 with a floor of 1e-8·‖F₀‖."""
    assert len(got) == len(want)
    floor = 1e-8 * want[0]
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-8 * abs(w) + floor, (g, w)


def _check(name, got, want):
    if name in ("simple_gmres", "bvp_fgmres_linesearch"):
        assert got["solved"] and want["solved"]
        assert (got["outer"], got["inner"]) == (want["outer"], want["inner"])
        hist = want.get("residual_history")
        f0 = hist[0] if hist else 0.2591818303644248  # the BVP's ‖F(u₀)‖
        assert abs(got["n_res"] - want["n_res"]) <= 1e-8 * want["n_res"] + 1e-8 * f0
        if hist:
            _history_close(got["residual_history"], hist)
        if name == "simple_gmres":
            for g, w in zip(got["solution"], want["solution"]):
                assert abs(g - w) <= 1e-12
        else:
            assert (got["bc_vp0"], got["bc_vend"]) == (want["bc_vp0"],
                                                       want["bc_vend"])
    elif name == "heat1d_implicit_euler":
        assert got["n_failed"] == want["n_failed"] == 0
        assert got["n_steps"] == want["n_steps"] == 30
        diffs = [abs(a - b) for a, b in zip(got["outer_per_step"],
                                            want["outer_per_step"])]
        assert max(diffs) <= 1, (got["outer_per_step"], want["outer_per_step"])
        bound = math.sqrt(HEAT_M + 2) * got["n_steps"] * HEAT_STEPS_TOL
        assert abs(got["final_norm"] - want["final_norm"]) <= bound
    else:  # bratu2d_ew
        assert got["solved"] and want["solved"]
        assert got["outer"] == want["outer"]
        assert abs(got["inner"] - want["inner"]) <= F32_INNER_RTOL * want["inner"]
        f0 = want["residual_history"][0]
        assert got["residual_history"][0] == pytest.approx(f0, rel=1e-12)
        assert got["n_res"] <= 1e-8 * f0 + 1e-12
        assert abs(got["center"] - want["center"]) <= 1e-8


@pytest.mark.parametrize("name", CONFIGS)
def test_config_matches_the_jax_record(fresh, name):
    _check(name, fresh[name], JAX_RECORD[name])


@pytest.mark.parametrize("name", CONFIGS)
def test_committed_record_is_a_fresh_cpu_run(fresh, name):
    """The committed record is what this run gives, to the tolerances the
    JAX record is held to (a CPU of another vector width sums in another
    order): equal f64 counts, the rest as :func:`_check` says."""
    _check(name, fresh[name], PORT_RECORD[name])


def test_record_schema_is_the_jax_records():
    """The port's record carries every configuration and every key of the
    JAX record, in its order."""
    assert list(PORT_RECORD) == list(JAX_RECORD)
    for name, rec in JAX_RECORD.items():
        assert list(PORT_RECORD[name]) == list(rec), name
