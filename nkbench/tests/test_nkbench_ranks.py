"""The harness over ranks on the CPU: a cell over four gloo ranks at a small
side, its answers judged, counted as the sharded driver counts them, the
control and each fault coming out not correct; the command printing one
line from rank 0, ending every rank when one fails, and starting no
process for a cell on one chip."""
import json
import os
import subprocess
import sys
import time

import pytest

from nkbench import control, harness, spec, traffic
from nkbench.tests.conftest import REPO

CELL = "sfi-sharded.solve-24576"
SIDE = 32
SEED = 2**31 + 91
FAULTS = sorted(control.FAULTS) + sorted(control.SHARDED_FAULTS)


def _quiet(_msg):
    pass


def _direct(n):
    """The configuration's solve through ``halo.newton_krylov_sharded``
    called directly on the whole u₀, with the recipe's options."""
    import torch

    from newtonkrylov_tpu_torch import halo
    from newtonkrylov_tpu_torch.mg import multigrid2d
    from newtonkrylov_tpu_torch.problems import bratu2d
    from newtonkrylov_tpu_torch.utils.dryrun import bratu_padded

    config = spec.load_json("config", "sfi-sharded")
    r = config["recipe"]
    axes = tuple(r["axis_names"])
    mesh = halo.make_mesh(r["mesh"], axes, device_type="cpu")
    p = bratu2d.default_config(n, lam=config["problem"]["lam"])
    u0 = traffic.initial_guess(config["problem"], n, "cpu")
    _, info = halo.newton_krylov_sharded(
        halo.sharded_residual_2d(bratu_padded, axes), u0, p, mesh,
        halo.P(*axes), newton_kwargs=dict(
            algo="cg", tol_rel=r["tol_rel"], tol_abs=r["tol_abs"],
            max_niter=r["max_niter"], krylov_dtype=torch.float32,
            residual_df=halo.sharded_residual_df_2d(
                bratu2d.residual_scaled_df_padded, axes),
            floor_rtol=r["floor_rtol"], M=multigrid2d(axis_names=axes),
            precond_refresh="once"))
    return int(info.stats.outer_iterations), int(info.stats.inner_iterations)


def _ranks_side():
    """Every case, in one process group of four ranks (rank 0's results)."""
    out = {}
    for trace in (False, True):
        out[f"trace{int(trace)}"] = harness.run(
            CELL, SEED, 0.2, trace, device="cpu", side=SIDE, log=_quiet)
    out["direct"] = _direct(SIDE)
    for fault in FAULTS:
        out[fault] = harness.run(CELL, SEED, 0.2, False, device="cpu",
                                 side=SIDE, system_factory=control.broken(fault),
                                 log=_quiet)
    out["control"] = control.readings(CELL, [1, 2, 3], device="cpu", side=64,
                                      program=True, log=_quiet)
    out["forbidden"] = harness.forbidden_modules()
    return out


@pytest.fixture(scope="module")
def world4():
    from newtonkrylov_tpu_torch.utils import distributed as D

    return D.run_processes(_ranks_side, 4, timeout=900)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_sharded_run_is_correct(world4, trace):
    r = world4[0][f"trace{trace}"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["device"]["count"] == 4
    want = ({"solve_s", "setup_s"} if not trace
            else {"outers", "inners", "collectives"})
    assert want <= set(r["metrics"])
    assert r["checks"]["res_ratio"]["value"] <= 1.0
    assert all(w[f"trace{trace}"] is None for w in world4[1:])


def test_counts_equal_the_sharded_driver_called_directly(world4):
    outer, inner = world4[0]["direct"]
    m = world4[0]["trace1"]["metrics"]
    assert (m["outers"]["value"], m["inners"]["value"]) == (outer, inner)
    # an all-reduce or an exchange at least every CG step
    assert m["collectives"]["value"] > inner


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_sharded_answer_is_not_correct(world4, fault):
    r = world4[0][fault]
    assert not r["correct"]
    assert r["failed"] == r["attempted"] >= 1
    assert r["checks"]["res_ratio"]["value"] > r["checks"]["res_ratio"]["limit"]


@pytest.mark.parametrize("acceptance", ["f32", "df32"])
def test_the_sharded_control_fails_the_limit(world4, acceptance):
    rows = [x for x in world4[0]["control"] if x["acceptance"] == acceptance]
    assert len(rows) == 3 and world4[1]["control"] == []
    for row in rows:
        if acceptance == "f32":
            assert row["res_ratio"] > row["limit"] and not row["solved"]
        else:
            assert row["res_ratio"] <= 1.0 and row["solved"]


@pytest.mark.parametrize("rank", range(4))
def test_no_rank_loads_jax_nor_the_jax_package(world4, rank):
    assert world4[rank]["forbidden"] == []


# -- the command ----------------------------------------------------------

def _command(cell, seed, *extra, env=None, side=SIDE):
    return subprocess.run(
        [sys.executable, "nkbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "0.2", "--trace", "0", "--device", "cpu",
         "--side", str(side), *extra], cwd=REPO, capture_output=True,
        text=True, env=env, timeout=600)


def _alive(marker: str):
    """Processes whose command line holds ``marker``."""
    found = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if marker.encode() in f.read():
                    found.append(pid)
        except OSError:
            continue
    return found


@pytest.mark.parametrize("seed", [SEED + 1, SEED + 2])
def test_the_command_prints_one_line_from_rank_0(seed):
    out = _command(CELL, seed)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r["correct"] and r["device"]["count"] == 4
    tail = out.stderr.strip().splitlines()[-3:]
    assert [t.split()[1] for t in tail] == ["res_ratio", "unsolved",
                                             "bad_counts"]
    assert _alive(str(seed)) == []


# A rank other than 0 fails: at its start, or in the gather of the
# answers after the window, while rank 0 waits for it in a collective; and
# what its standard error then says
SAYS = {"start": "rank 2 ended with code 5",
        "gather": "a planted failure in rank 2"}
SITE = {
    "start": "import os\nif os.environ.get('RANK') == '2':\n    os._exit(5)\n",
    "gather": (
        "import os\nif os.environ.get('RANK') == '2':\n"
        "    import torch.distributed as dist\n"
        "    def gather(*a, **k):\n"
        "        raise RuntimeError('a planted failure in rank 2')\n"
        "    dist.gather = gather\n"),
}


@pytest.mark.parametrize("where", sorted(SITE))
def test_a_failing_rank_ends_every_rank_and_prints_nothing(tmp_path, where):
    (tmp_path / "sitecustomize.py").write_text(SITE[where])
    seed = SEED + 10 + sorted(SITE).index(where)
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}")
    t0 = time.monotonic()
    out = _command(CELL, seed, env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert SAYS[where] in out.stderr
    assert time.monotonic() - t0 < 120
    time.sleep(0.5)
    assert _alive(str(seed)) == []


@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()[
    "workloads"] if w["chips"] == 1])
def test_a_cell_on_one_chip_starts_no_process(cell, monkeypatch, capsys):
    def refuse(*a, **k):
        raise AssertionError("a cell on one chip started a process")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    rc = harness.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                       "0.2", "--trace", "0", "--device", "cpu", "--side",
                       "16"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["correct"]
