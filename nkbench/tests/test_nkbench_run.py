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
for cell in [w["name"] for w in spec.benchmark()["workloads"]
             if w["chips"] == 1]:
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


def _copy_tree(tmp_path):
    """A copy of the benchmark (``BENCHMARK.json`` and ``nkbench/``), and
    the bytes of each file copied."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "nkbench", tmp_path / "nkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return {p: p.read_bytes() for p in (tmp_path / "nkbench").rglob("*")
            if p.is_file()}


def _add_cell(tmp_path, config, mix, name, per_layer=()):
    """Add configuration ``config`` and a cell ``name`` of it under mix
    ``mix`` to the copy, as files and entries alone; the cell reports
    ``solve_s`` and the per-layer metrics named."""
    c, t = config["name"], name.split(".", 1)[1]
    (tmp_path / f"nkbench/configs/{c}.json").write_text(json.dumps(config))
    (tmp_path / f"nkbench/traffic/{t}.json").write_text(json.dumps(mix))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": c, "source": "a test",
                             "file": f"nkbench/configs/{c}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": name, "config": c, "traffic": t,
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "solve_s" or m["name"] in per_layer:
            m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def _run_in_copy(tmp_path, body):
    """Run ``body`` (Python, with ``harness`` and ``control`` of the copy
    imported) in a process whose ``nkbench`` is the copy's, and return the
    JSON it prints last."""
    code = (f"import sys, json; sys.path[:0] = [{str(tmp_path)!r}, "
            f"{str(REPO)!r}]\n"
            "from nkbench import control, harness\n" + body)
    out = _run_cli(tmp_path, "-c", code)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _unedited(before):
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_a_new_config_mix_and_metric_need_no_edit(tmp_path):
    before = _copy_tree(tmp_path)
    cfg = spec.load_json("config", "sfi-dst")
    cfg.update(name="dummy", problem=dict(cfg["problem"], lam=3.0))
    cfg["recipe"].update(params_kwargs={"lam": 3.0})
    cfg["recipe"].pop("precond")
    mix = dict(spec.load_json("traffic", "solve-8192"), side=16)
    bench = _add_cell(tmp_path, cfg, mix, "dummy.tiny")
    (tmp_path / "nkbench/metrics/requests.py").write_text(DUMMY_METRIC)
    bench["per_layer"].append({"name": "requests", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "Newton driver (newton.newton_krylov_jit)",
                               "moves": "solve_s", "workloads": ["dummy.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = _run_in_copy(tmp_path, "r = harness.run('dummy.tiny', 9, 0.3, True, "
                     "device='cpu', log=lambda m: None)\n"
                     "print(json.dumps(r))")
    assert r["correct"]
    assert r["metrics"]["requests"]["value"] == r["attempted"] >= 1
    _unedited(before)


# A second problem, added as files alone: the port's steady 2-D
# convection-diffusion (nonsymmetric), Newton-GMRES with full GMRES, no
# forcing, the DST, df32 acceptance, and a reference of its own
CONVDIFF_REFERENCE = '''"""Plain float64 reference of 2-D convection-diffusion.

    Δu − c·u·(u_x + u_y) + g = 0   on the unit square, zero Dirichlet values,

by the 5-point Laplacian and central differences on an n × n interior of
spacing h = 1/(n+1), h²-scaled, with g made so that u* = sin(πx)·sin(πy)
is the discrete root; every request starts from zero.
"""
import math

import torch

F64 = torch.float64
PAIR_EPS = 2.0 ** -47


def operator(u, c):
    h = 1.0 / (u.shape[-1] + 1)
    p = torch.nn.functional.pad(u, (1, 1, 1, 1))
    lap = p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, 2:] + p[1:-1, :-2] - 4.0 * u
    conv = (p[2:, 1:-1] - p[:-2, 1:-1]) + (p[1:-1, 2:] - p[1:-1, :-2])
    return lap - (0.5 * h * c) * u * conv


def residual(u, c):
    n = u.shape[-1]
    s = torch.sin(math.pi * torch.arange(1, n + 1, dtype=F64,
                                         device=u.device) / (n + 1))
    return operator(u.to(F64), c) - operator(s[:, None] * s[None, :], c)


def floor(u0, c):
    """The float32-pair floor of ‖F‖ at u0, measured as for Bratu."""
    worst = 0.0
    for axis in (0, 1):
        k = torch.arange(u0.shape[axis], device=u0.device)
        signs = (1 - 2 * (k % 2)).to(F64)
        signs = signs[:, None] if axis == 0 else signs[None, :]
        jv = torch.func.jvp(lambda u: residual(u, c), (u0,),
                            (u0.abs() * PAIR_EPS * signs,))[1]
        worst = max(worst, float(torch.linalg.vector_norm(jv)))
    return worst / 4.0


def tolerance(u0, c, recipe):
    tol = (recipe["tol_rel"] * float(torch.linalg.vector_norm(
        residual(u0, c))) + recipe["tol_abs"])
    return max(tol, recipe["floor_rtol"] * floor(u0.to(F64), c))


def initial_guess(problem, n, device, block=None):
    u = torch.zeros(n, n, dtype=F64, device=device)
    return u if block is None else u[block]


def judge(u, u0, problem, recipe):
    if tuple(u.shape) != tuple(u0.shape) or not bool(torch.isfinite(u).all()):
        return {"res": math.inf, "tol": math.nan, "res_ratio": math.inf}
    c = float(problem["c"])
    res = float(torch.linalg.vector_norm(residual(u, c)))
    tol = tolerance(u0, c, recipe)
    return {"res": res, "tol": tol, "res_ratio": res / tol}
'''

CD = "newtonkrylov_tpu_torch.problems.convdiff2d:"
CONVDIFF_CONFIG = {
    "name": "cd-gmres", "source": "a test",
    "problem": {"name": "convdiff2d", "c": 2.0, "initial_guess": "zero"},
    "reference": "cd_local",
    "recipe": {
        "driver": "newtonkrylov_tpu_torch.newton:newton_krylov_jit",
        "residual": CD + "residual_scaled",
        "residual_df": CD + "residual_scaled_df",
        "params": CD + "default_config",
        "params_kwargs": {"c": 2.0}, "params_dtype": "float64",
        "acceptance": "df32", "algo": "gmres", "forcing": None,
        "krylov_kwargs": {"restart": None, "itmax": 200},
        "krylov_dtype": "float32", "tol_rel": 1e-8, "tol_abs": 1e-12,
        "max_niter": 20, "floor_rtol": 2.0,
        "precond": {"factory": "newtonkrylov_tpu_torch.fftprec:fft_poisson",
                    "kwargs": {}, "refresh": "once"}}}


def test_a_second_problem_needs_no_edit(tmp_path):
    before = _copy_tree(tmp_path)
    (tmp_path / "nkbench/reference/cd_local.py").write_text(CONVDIFF_REFERENCE)
    mix = dict(spec.load_json("traffic", "solve-8192"), side=SIDE)
    _add_cell(tmp_path, CONVDIFF_CONFIG, mix, "cd-gmres.tiny",
              per_layer=("outers", "inners"))
    got = _run_in_copy(tmp_path, f"""
out = {{}}
for trace in (False, True):
    out[str(trace)] = harness.run('cd-gmres.tiny', {SEED}, 0.3, trace,
                                  device='cpu', log=lambda m: None)
for fault in sorted(control.FAULTS):
    out[fault] = harness.run('cd-gmres.tiny', {SEED}, 0.2, False,
                             device='cpu',
                             system_factory=control.broken(fault),
                             log=lambda m: None)
from nkbench.system import System
s = System(json.load(open({str(tmp_path / "nkbench/configs/cd-gmres.json")!r})),
           {SIDE}, 'cpu')
kw = s.kwargs()
out['options'] = [kw['forcing'], kw['krylov_kwargs'], str(s.p.b.dtype),
                  str(s.p.b.device), s.p.c]
print(json.dumps(out))
""")
    for trace in ("False", "True"):
        r = got[trace]
        assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
        assert r["checks"]["res_ratio"]["value"] <= 1.0
    m = got["True"]["metrics"]
    assert 1 <= m["outers"]["value"] <= m["inners"]["value"]
    for fault in sorted(control.FAULTS):
        r = got[fault]
        assert not r["correct"] and r["failed"] == r["attempted"] >= 1
    assert got["options"] == [None, {"restart": None, "itmax": 200},
                              "torch.float64", "cpu", 2.0]
    _unedited(before)


def test_a_params_dtype_is_stated_where_the_entry_point_takes_one():
    from nkbench.system import System

    cfg = json.loads(json.dumps(CONVDIFF_CONFIG))
    del cfg["recipe"]["params_dtype"]
    with pytest.raises(ValueError, match="params_dtype"):
        System(cfg, SIDE, "cpu")


def test_served_answers_are_kept_and_judged():
    r = harness.run("sfi-dst.serve-2048", SEED, 1.0, False, device="cpu",
                    side=SIDE, log=quiet)
    assert r["correct"]
    assert set(r["metrics"]) == {"served_p95_ms", "setup_s"}
    assert r["attempted"] == round(1.0 * spec.load_json(
        "traffic", "serve-2048")["rate_per_s"])
