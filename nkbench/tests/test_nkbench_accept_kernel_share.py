"""``accept_kernel_share``: K7's launches over the window's df32
acceptance calls (outers + 1 a solve)."""
from types import SimpleNamespace

import pytest

from nkbench import harness, spec
from nkbench.system import resolve

READER = spec.reader("per_layer", "accept_kernel_share")


def _run(outers, counters):
    return SimpleNamespace(records=[SimpleNamespace(outer=o) for o in outers],
                           counters=counters)


@pytest.mark.parametrize("launches,share", [(16, 1.0), (8, 0.5), (0, 0.0)])
def test_share_of_acceptance_calls(launches, share):
    run = _run([7, 7], {"launches.bratu_residual_df": launches,
                        "launches.chebyshev_apply": 99})
    assert READER.read(run) == share


def test_nothing_to_read_without_the_counter_or_a_solve():
    """A program with no K7 counter (the tree before K7) and an empty
    window read nothing: the harness leaves the metric out."""
    assert READER.read(_run([7], {"launches.chebyshev_apply": 3})) is None
    assert READER.read(_run([], {"launches.bratu_residual_df": 0})) is None


def test_the_counter_is_one_the_harness_reads():
    launches = resolve(harness.COUNTERS["launches"])
    assert "launches." + "bratu_residual_df" == READER.COUNTER
    assert "bratu_residual_df" in launches
