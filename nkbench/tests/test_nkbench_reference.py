"""The plain reference: the textbook Bratu residual, its Jacobian, the
stated tolerance, the sources' starting state, and its imports."""
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from nkbench.reference import bratu2d as ref
from nkbench.tests.conftest import REPO


def textbook(u: np.ndarray, lam: float) -> np.ndarray:
    n = u.shape[0]
    h = 1.0 / (n + 1)
    out = np.empty_like(u)
    for i in range(n):
        for j in range(n):
            s = 0.0
            for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                a, b = i + di, j + dj
                if 0 <= a < n and 0 <= b < n:
                    s += u[a, b]
            # (Δu + λeᵘ)·h² on the 5-point stencil
            out[i, j] = s - 4.0 * u[i, j] + h * h * lam * math.exp(u[i, j])
    return out


def test_residual_matches_the_textbook_formula():
    rng = np.random.default_rng(0)
    u = rng.random((7, 7))
    got = ref.residual(torch.from_numpy(u), 6.0).numpy()
    np.testing.assert_allclose(got, textbook(u, 6.0), rtol=0, atol=1e-15)


def test_jvp_is_the_residuals_derivative():
    rng = np.random.default_rng(1)
    u = torch.from_numpy(rng.random((6, 6)))
    v = torch.from_numpy(rng.random((6, 6)))
    auto = torch.func.jvp(lambda x: ref.residual(x, 6.0), (u,), (v,))[1]
    torch.testing.assert_close(ref.jvp(u, v, 6.0), auto, rtol=1e-14,
                               atol=1e-15)


def test_tolerance_is_the_larger_of_the_relative_one_and_the_floor():
    u0 = torch.rand(16, 16, dtype=torch.float64)
    n0 = float(torch.linalg.vector_norm(ref.residual(u0, 6.0)))
    assert ref.tolerance(u0, 6.0, 1e-8, 1e-12, None) == 1e-8 * n0 + 1e-12
    big = ref.tolerance(u0, 6.0, 0.0, 0.0, 1e9)
    assert big == 1e9 * ref.floor(u0, 6.0) > 0


def test_judge_scores_a_root_and_a_start():
    n = 16
    u = torch.zeros(n, n, dtype=torch.float64)
    recipe = {"tol_rel": 1e-8, "tol_abs": 1e-12, "floor_rtol": 2.0}
    problem = {"lam": 0.0}  # F(0) = 0 at λ = 0
    assert ref.judge(u, u + 0.1, problem, recipe)["res_ratio"] == 0.0
    assert ref.judge(u + 0.1, u + 0.1, problem, recipe)["res_ratio"] > 1e6
    assert math.isinf(ref.judge(u[:-1], u, problem, recipe)["res_ratio"])


def ex5_as_the_harness_made_it(problem, n, device, block=None):
    """The ex5 / dsfifg starting state as the harness's traffic generator
    formed it before the reference states it: the same operations in the
    same order."""
    lam = float(problem["lam"])
    i = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    d = torch.minimum(i, n + 1 - i) / (n + 1)
    rows, cols = (d, d) if block is None else (d[block[0]], d[block[1]])
    return (lam / (lam + 1.0)) * torch.sqrt(torch.minimum(rows[:, None],
                                                          cols[None, :]))


def blocks_2x2(n):
    half = n // 2
    return [(slice(a, a + half), slice(b, b + half))
            for a in (0, half) for b in (0, half)]


@pytest.mark.parametrize("n", [7, 2048])
def test_initial_guess_is_the_old_formula_bit_for_bit(n):
    problem = {"lam": 6.0, "initial_guess": "ex5"}
    assert torch.equal(ref.initial_guess(problem, n, "cpu"),
                       ex5_as_the_harness_made_it(problem, n, "cpu"))


@pytest.mark.parametrize("block", blocks_2x2(24))
def test_a_blocks_initial_guess_is_the_old_formula_bit_for_bit(block):
    problem = {"lam": 6.0, "initial_guess": "ex5"}
    got = ref.initial_guess(problem, 24, "cpu", block)
    assert got.shape == (12, 12)
    assert torch.equal(got, ex5_as_the_harness_made_it(problem, 24, "cpu",
                                                       block))


def test_reference_imports_nothing_of_jax_or_the_program():
    code = ("import sys; import nkbench.reference.bratu2d; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"jax", "jaxlib", "flax", "newtonkrylov_tpu",
                         "newtonkrylov_tpu_torch"}
