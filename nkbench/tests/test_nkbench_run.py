"""Whole runs of the harness on the CPU at a tiny side: correct runs,
the control and each fault coming out not correct, the import closure,
and a new configuration, mix and metric added as files alone."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from nkbench import control, harness, spec
from nkbench.tests.conftest import REPO

SIDE = 16
SEED = 2**31 + 77
LIVE = ["sfi-dst.solve-8192", "sfi-twogrid.solve-8192"]


def quiet(_msg):
    pass


@pytest.mark.parametrize("cell", LIVE)
def test_a_sound_run_is_correct(cell):
    r = harness.run(cell, SEED, 0.5, False, device="cpu", side=SIDE,
                    log=quiet)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"solve_s", "setup_s"}
    assert list(r)[-1] == "checks"
    assert r["checks"]["res_ratio"]["value"] <= 1.0


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("cell", LIVE)
def test_a_broken_answer_is_not_correct(cell, fault):
    r = harness.run(cell, SEED, 0.2, False, device="cpu", side=SIDE,
                    system_factory=control.broken(fault), log=quiet)
    assert not r["correct"]
    assert r["failed"] == r["attempted"] >= 1
    assert r["checks"]["res_ratio"]["value"] > r["checks"]["res_ratio"]["limit"]


def miscounted(outer):
    """A system that reports ``outer`` Newton steps for every solve."""
    from nkbench.system import Answer, System

    class Miscounted(System):
        def __call__(self, u0):
            a = super().__call__(u0)
            return Answer(a.u, outer, a.inner, a.solved)

    return Miscounted


@pytest.mark.parametrize("outer", [0, 21])
def test_counts_no_sound_solve_gives_are_not_correct(outer):
    r = harness.run(LIVE[0], SEED, 0.2, False, device="cpu", side=SIDE,
                    system_factory=miscounted(outer), log=quiet)
    assert not r["correct"]
    assert r["checks"]["bad_counts"]["value"] == r["attempted"] >= 1
    assert r["checks"]["res_ratio"]["value"] <= 1.0


@pytest.mark.parametrize("cell", LIVE + ["sfi-dst.serve-2048"])
def test_the_control_fails_the_limit(cell):
    # the control's reading grows with the side (on an H100: 1.6e4 at
    # 2048², 6.3e4–6.6e4 at 8192²); 64² is the smallest at which it
    # breaks the cells' limits here
    rows = control.readings(cell, [1, 2, 3], device="cpu", side=64,
                            program=True, log=quiet)
    for row in rows:
        if row["acceptance"] == "f32":
            assert row["res_ratio"] > row["limit"] and not row["solved"]
        else:
            assert row["res_ratio"] <= 1.0 and row["solved"]


def _run_cli(root, *args, env=None):
    return subprocess.run([sys.executable, *args], cwd=root,
                          capture_output=True, text=True, env=env,
                          timeout=600)


def test_the_command_refuses_a_machine_without_a_card():
    out = _run_cli(REPO, "nkbench/run.py", "--workload", LIVE[0], "--seed",
                   "3", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_the_command_fails_without_the_program(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "nkbench", tmp_path / "nkbench")
    env = dict(os.environ, PYTHONPATH="")
    out = _run_cli(tmp_path, "nkbench/run.py", "--workload", LIVE[0],
                   "--seed", "3", "--seconds", "1", "--trace", "0", env=env)
    assert out.returncode != 0 and out.stdout == ""


CLOSURE = """
import json, sys
sys.path.insert(0, {root!r})
from nkbench import harness, spec
out = {{}}
for cell in [w["name"] for w in spec.benchmark()["workloads"]]:
    for trace in (False, True):
        r = harness.run(cell, 5, 0.3, trace, device="cpu", side=16,
                        log=lambda m: None)
        out[cell + str(trace)] = (r["correct"], sorted(r["metrics"]))
print(json.dumps({{"runs": out, "forbidden": harness.forbidden_modules()}}))
"""


def test_import_closure_loads_no_jax_nor_the_jax_package():
    out = _run_cli(REPO, "-c", CLOSURE.format(root=str(REPO)))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert all(ok for ok, _ in got["runs"].values())


DUMMY_METRIC = '''"""A dummy per-layer metric: requests in the window."""


def read(run):
    return float(len(run.records))
'''


def test_a_new_config_mix_and_metric_need_no_edit(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "nkbench", tmp_path / "nkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "nkbench").rglob("*")
              if p.is_file()}
    cfg = spec.load_json("config", "sfi-dst")
    cfg.update(name="dummy", problem=dict(cfg["problem"], lam=3.0))
    cfg["recipe"].pop("precond")
    (tmp_path / "nkbench/configs/dummy.json").write_text(json.dumps(cfg))
    mix = spec.load_json("traffic", "solve-8192")
    mix.update(side=16)
    (tmp_path / "nkbench/traffic/tiny.json").write_text(json.dumps(mix))
    (tmp_path / "nkbench/metrics/requests.py").write_text(DUMMY_METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "a test",
                             "file": "nkbench/configs/dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.tiny", "config": "dummy",
                               "traffic": "tiny", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "solve_s":
            m["workloads"].append("dummy.tiny")
    bench["per_layer"].append({"name": "requests", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "Newton driver (newton.newton_krylov_jit)",
                               "moves": "solve_s", "workloads": ["dummy.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (f"import sys, json; sys.path[:0] = [{str(tmp_path)!r}, "
            f"{str(REPO)!r}]\n"
            "from nkbench import harness\n"
            "r = harness.run('dummy.tiny', 9, 0.3, True, device='cpu', "
            "log=lambda m: None)\n"
            "print(json.dumps(r))")
    out = _run_cli(tmp_path, "-c", code)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"]
    assert r["metrics"]["requests"]["value"] == r["attempted"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_served_answers_are_kept_and_judged():
    r = harness.run("sfi-dst.serve-2048", SEED, 1.0, False, device="cpu",
                    side=SIDE, log=quiet)
    assert r["correct"]
    assert set(r["metrics"]) == {"served_p95_ms", "setup_s"}
    assert r["attempted"] == round(1.0 * spec.load_json(
        "traffic", "serve-2048")["rate_per_s"])
