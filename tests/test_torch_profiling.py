"""The port's profiling hooks (``utils/profiling.py``) against the JAX
package's (oracle: tests/test_utils.py:60-79).

On the CPU these hold the hooks' structure: the timers accumulate, the
report reads the same as the JAX package's for the same solve, the chain
timer returns a rate, and a trace file holds the annotated range.  A time
measured here is the CPU's, not the card's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu.problems import simple as js
from newtonkrylov_tpu.utils import profiling as jprof
from newtonkrylov_tpu_torch.problems import simple as ts
from newtonkrylov_tpu_torch.utils import profiling


def test_phase_timer():
    """Named timers accumulate; ``block=`` takes a tree of tensors
    (test_phase_timer); the summary lists each phase as the JAX package's
    does."""
    t = profiling.PhaseTimer()
    with t("phase_a"):
        sum(range(1000))
    with t("phase_a"):
        pass
    with t("phase_b", block={"x": torch.ones(4, dtype=torch.float64) * 2,
                             "y": (torch.zeros(2, dtype=torch.float64),)}):
        pass
    assert t.counts["phase_a"] == 2 and t.counts["phase_b"] == 1
    assert t.totals["phase_a"] > 0
    lines = t.summary().splitlines()
    assert [l.split()[0] for l in lines] == sorted(
        ["phase_a", "phase_b"], key=t.totals.get, reverse=True)
    # the same totals print the same summary as the JAX package's timer
    j = jprof.PhaseTimer()
    for name in t.totals:
        j.totals[name], j.counts[name] = t.totals[name], t.counts[name]
    assert t.summary() == j.summary()


@pytest.mark.parametrize("start", [0, 1])
def test_solve_report_matches_jax(start):
    """``solve_report`` of the port's solve of the Kelley system reads as the
    JAX package's for the same solve (test_solve_report): the same first
    line (solved, counts and final ‖F‖ to four digits), and the same
    throughput line for the same wall."""
    x0 = ts.STARTS[start]
    u, info = nkt.newton_krylov(
        ts.residual, torch.tensor(x0, dtype=torch.float64))
    uj, ij = nk.newton_krylov(js.residual, jnp.asarray(x0, dtype=jnp.float64))
    rep = profiling.solve_report(info, 2, wall_s=0.5)
    rep_j = jprof.solve_report(ij, 2, wall_s=0.5)
    assert "solved=True" in rep and "matvec/s" in rep
    assert rep == rep_j
    # the loop driver's info (device tensors) reports its own counts
    _, info_d = nkt.newton_krylov_jit(
        ts.residual, torch.tensor(x0, dtype=torch.float64))
    first = profiling.solve_report(info_d, 2, wall_s=0.5).splitlines()[0]
    assert first.startswith(
        f"solved=True  outer={info_d.stats.outer_iterations}  "
        f"inner={info_d.stats.inner_iterations}  final |F|=")


def test_solve_report_floor_limited_note():
    """The df32 floor note, as the JAX package prints it."""
    _, info = nkt.newton_krylov_jit(
        ts.residual, torch.tensor(ts.STARTS[0], dtype=torch.float64))
    rep = profiling.solve_report(info._replace(floor_limited=True), 2)
    assert rep.splitlines()[0].endswith(
        "[floor_limited: tol clamped to the df32 representation floor]")


def test_time_chain_rate_on_cpu():
    """``time_chain`` returns a positive, finite rate for a stencil step on
    CPU tensors (the number is the CPU's, not a device metric)."""
    from newtonkrylov_tpu_torch.utils.scaling import _stencil_jvp_local

    u = torch.ones((34, 34), dtype=torch.float32)
    w = torch.full((32, 32), 0.1, dtype=torch.float32)

    def step(x, wl):
        return torch.nn.functional.pad(_stencil_jvp_local(x, wl), (1, 1, 1, 1))

    rate = profiling.time_chain(step, u, w, chain=20, repeats=2)
    assert np.isfinite(rate) and rate > 0


def test_trace_writes_annotated_ranges(tmp_path):
    """``trace`` writes a Chrome/TensorBoard trace file into the directory,
    and an ``annotate`` range inside it is one of its events."""
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("newton_outer"):
            (torch.ones(16, dtype=torch.float64) * 2).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "newton_outer" for e in events)
