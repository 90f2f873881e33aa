"""The port's five walkthroughs (``newtonkrylov_tpu_torch/docs``) run to
their end on the CPU with their figures off, and one of them builds into
an executed notebook.

Each walkthrough runs as the port's runner runs it, in a process of its
own (``python -m newtonkrylov_tpu_torch.docs.run_walkthroughs --device cpu
--no-figures <name>``); the five and the notebook build start together
and each test waits for its own.  A walkthrough's assertions are its
checks: every ``assert`` of the JAX package's walkthrough has its
counterpart in the port's (the count is held below).
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_DOCS = ROOT / "newtonkrylov_tpu_torch" / "docs"
NAMES = ("diagnostics", "heat1d_dg", "heat2d", "precision", "sharded")
TIMEOUT = 900


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The five walkthrough runs and the notebook build, started at once:
    ``{name: (process, log path)}``; the notebook under ``"notebook"``
    with its output directory."""
    tmp = tmp_path_factory.mktemp("walkthroughs")
    procs = {}

    def start(key, args, env):
        log = tmp / f"{key}.log"
        with open(log, "w") as f:
            p = subprocess.Popen([sys.executable, "-m", *args], stdout=f,
                                 stderr=subprocess.STDOUT, cwd=ROOT, env=env)
        procs[key] = (p, log)

    for name in NAMES:
        start(name, ["newtonkrylov_tpu_torch.docs.run_walkthroughs", "--device",
                     "cpu", "--no-figures", name], _env())
    try:
        import ipykernel  # noqa: F401
        import nbclient  # noqa: F401
        import nbformat  # noqa: F401
    except ImportError:
        pass
    else:
        out = tmp / "notebooks"
        start("notebook", ["newtonkrylov_tpu_torch.docs.build_notebooks",
                           "--device", "cpu", "diagnostics"],
              dict(_env(), NK_NB_OUT=str(out)))
        procs["notebook_out"] = out
    yield procs
    for key, val in procs.items():
        if isinstance(val, tuple) and val[0].poll() is None:
            val[0].kill()
            val[0].wait()


def _finish(procs, key):
    p, log = procs[key]
    try:
        rc = p.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        pytest.fail(f"{key} outlasted {TIMEOUT} s:\n{log.read_text()[-4000:]}")
    out = log.read_text()
    assert rc == 0, out[-6000:]
    return out


@pytest.mark.parametrize("name", NAMES)
def test_walkthrough_runs_on_cpu(started, name):
    """Every block but the figure block runs and its assertions hold; the
    runner says it skipped the figure block (the diagnostics walkthrough
    draws none); no block prints a wall time."""
    out = _finish(started, name)
    head = f"== walkthrough_{name}.md"
    assert head in out and "   OK" in out
    skipped = "   skipped 1 figure block(s) (--no-figures)" in out
    assert skipped == (name != "diagnostics")
    printed = out.split(head)[1].split("   skipped")[0].split("   OK")[0]
    assert not re.search(r"\d\.\d+ ?s\b", printed), "a wall time is printed"


@pytest.mark.parametrize("name", NAMES)
def test_walkthrough_keeps_every_jax_assert(name):
    """The port's walkthrough asserts at least as often as the JAX
    package's (the sharded one's device-count assert becomes one on the
    ranks' agreement)."""
    count = lambda text: len(re.findall(r"^\s*assert\b", text, re.M))  # noqa: E731
    jax = (ROOT / "docs" / f"walkthrough_{name}.md").read_text(encoding="utf-8")
    port = (PORT_DOCS / f"walkthrough_{name}.md").read_text(encoding="utf-8")
    assert count(port) >= count(jax) > 0
    assert "import jax" not in port and "newtonkrylov_tpu." not in port


def test_build_one_executed_notebook(started):
    """The diagnostics walkthrough as an executed notebook in a temporary
    directory (as tests/test_notebooks.py builds the JAX package's)."""
    nbformat = pytest.importorskip("nbformat")
    pytest.importorskip("nbclient")
    pytest.importorskip("ipykernel")
    _finish(started, "notebook")
    nb = nbformat.read(str(started["notebook_out"] / "diagnostics.ipynb"),
                       as_version=4)
    code = [c for c in nb.cells if c.cell_type == "code"]
    assert len(code) >= 5 and sum(c.cell_type == "markdown" for c in nb.cells) >= 2
    assert all(c.get("execution_count") is not None for c in code)
    assert "DEVICE = 'cpu'" in code[0].source
    assert any("ptc solved=True" in "".join(o.get("text", "") for o in c.get("outputs", []))
               for c in code)
