"""The generator: the sources' initial guess, the same inputs from the
same seed, the open loop's schedule and sample."""
import math

import pytest
import torch

from nkbench import spec, traffic
from nkbench.harness import Run

BENCH = spec.benchmark()
CONFIGS = sorted({w["config"] for w in BENCH["workloads"]})


def dsfifg_xs(nx: int, ny: int, lam: float) -> list:
    """MINPACK-2 ``dsfifg``'s standard starting point (task 'XS'), as its
    Fortran loops state it (1-based indices, x(k) with k = nx·(j−1) + i)."""
    hx, hy = 1.0 / (nx + 1), 1.0 / (ny + 1)
    temp1 = lam / (lam + 1.0)
    x = [0.0] * (nx * ny)
    for j in range(1, ny + 1):
        temp = min(j, ny - j + 1) * hy
        for i in range(1, nx + 1):
            k = nx * (j - 1) + i
            x[k - 1] = temp1 * math.sqrt(min(min(i, nx - i + 1) * hx, temp))
    return x


@pytest.mark.parametrize("n", [1, 2, 5, 8])
@pytest.mark.parametrize("config", CONFIGS)
def test_initial_guess_is_the_sources(config, n):
    cfg = spec.load_json("config", config)
    problem = cfg["problem"]
    got = traffic.initial_guess(cfg, n, torch.device("cpu"))
    want = torch.tensor(dsfifg_xs(n, n, problem["lam"]),
                        dtype=torch.float64).reshape(n, n)
    # x(k) runs along i fastest: the grid is symmetric, so either layout
    assert torch.allclose(got, want, rtol=0, atol=1e-15)
    assert torch.allclose(got, want.T, rtol=0, atol=1e-15)


def test_an_unknown_initial_guess_is_refused():
    config = {"reference": "bratu2d",
              "problem": {"lam": 6.0, "initial_guess": "bump"}}
    with pytest.raises(ValueError):
        traffic.initial_guess(config, 4, torch.device("cpu"))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_draws_the_same_u0_from_the_same_seed(cell):
    w = spec.workload(BENCH, cell)
    mix = spec.load_json("traffic", w["traffic"])
    config = spec.load_json("config", w["config"])

    class Stub:
        n, device, block = 16, torch.device("cpu"), None

    a = Run(w, config, mix, Stub(), print)
    b = Run(w, config, mix, Stub(), print)
    first = a.u0()
    assert torch.equal(first, b.u0())
    first.add_(1.0)  # every request is sent a fresh copy
    assert torch.equal(a.u0(), b.u0())
    assert a.u0(torch.float32).dtype == torch.float32


@pytest.mark.parametrize("block", [(slice(0, 8), slice(8, 16)),
                                   (slice(8, 16), slice(0, 8))])
def test_a_rank_forms_its_block_of_the_starting_state(block):
    config = spec.load_json("config", "sfi-sharded")
    whole = traffic.initial_guess(config, 16, "cpu")
    assert torch.equal(traffic.initial_guess(config, 16, "cpu", block),
                       whole[block])


def test_open_loop_schedule_and_sample():
    mix = spec.load_json("traffic", "serve-2048")
    due = traffic.due_times(mix, 10.0)
    rate = mix["rate_per_s"]
    assert len(due) == round(10.0 * rate)
    assert due[1] - due[0] == pytest.approx(1.0 / rate)
    sample = traffic.checked(mix, 2**31 + 3, len(due))
    assert sample == traffic.checked(mix, 2**31 + 3, len(due))
    assert sample != traffic.checked(mix, 2**31 + 4, len(due))
    assert len(sample) == min(mix["check"]["sample"], len(due))
    assert traffic.checked({"check": {}}, 3, 5) == [0, 1, 2, 3, 4]
