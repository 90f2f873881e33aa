"""The port's 1-D Bratu and Kelley 2×2 problems, and the reference's 1-D
Bratu recipe gallery, against the JAX package.

Oracles: tests/test_problems.py (the Kelley starts, the 1-D Bratu CG and
forcing recipes, the banded-direct recipe), tests/test_df32_problems.py
(the df32 residuals against f64, the refined solves to 1e-8) and
examples/bratu_1d.py:42-55 (the gallery, positive and negative recipes).
The same numpy inputs go to both packages.

The gallery runs at N = 512, the smallest size of this λ = 3.51382 whose
discrete problem has a root (at N ≤ 256 both packages exhaust
``max_niter``).  Its unpreconditioned CG and BiCGStab recipes take
thousands of inner steps on κ ≈ 10⁵ and their inner counts differ from the
JAX package's by up to 1% (ROADMAP.md Queue 3 item 16): those recipes
assert the outer count, ``solved`` and the solution; every other recipe
asserts both counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import df32 as jdd
from newtonkrylov_tpu import precond as jp
from newtonkrylov_tpu.problems import bratu1d as jb
from newtonkrylov_tpu.problems import simple as js
from newtonkrylov_tpu_torch import df32 as tdd
from newtonkrylov_tpu_torch import precond as tp
from newtonkrylov_tpu_torch.problems import bratu1d as tb
from newtonkrylov_tpu_torch.problems import simple as ts
from newtonkrylov_tpu_torch.utils import convert

F64, F32 = torch.float64, torch.float32


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def test_bratu1d_setup_matches_jax():
    """Grid, u₀, the closed-form solution and both residuals at n = 100."""
    n = 100
    p = jb.default_config(n)
    assert tuple(tb.default_config(n)) == tuple(p)
    np.testing.assert_allclose(tb.grid(n, device="cpu").numpy(), np.asarray(jb.grid(n)),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(tb.initial_guess(n, device="cpu").numpy(),
                               np.asarray(jb.initial_guess(n)), rtol=0, atol=1e-15)
    x = jb.grid(n)
    np.testing.assert_allclose(tb.true_solution(_t(x)).numpy(),
                               np.asarray(jb.true_solution(x)), rtol=1e-14)
    u = jb.true_solution(x) * 1.01
    for name in ("residual", "residual_scaled"):
        want = np.asarray(getattr(jb, name)(u, p))
        np.testing.assert_allclose(getattr(tb, name)(_t(u), p).numpy(), want,
                                   rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_bratu1d_residual_df_matches_jax_and_f64():
    """The df32 residual at N = 10⁴ on a detuned near-solution state: hi
    words bitwise equal to the JAX package's (Queue 3 item 3: |u| ≤ 60),
    and within 1e-12 of the f64 residual relative to |u|."""
    n = 10_000
    p = jb.default_config(n)
    u64 = np.asarray(jb.true_solution(jb.grid(n))) * (1.0 + 1e-6) + 1e-7
    got = tb.residual_scaled_df(tdd.df_from_f64(_t(u64)), p)
    want = jb.residual_scaled_df(jdd.df_from_f64(jnp.asarray(u64)), p)
    np.testing.assert_array_equal(got.hi.numpy(), np.asarray(want.hi))
    err = np.abs(tdd.df_to_f64(got).numpy() - np.asarray(jb.residual_scaled(u64, p)))
    assert err.max() / np.abs(u64).max() < 1e-12


def test_simple_residuals_match_jax():
    """F and its df32 form at a point off the root; the df32 hi words bitwise
    equal to the JAX package's, the value within 1e-12 of f64."""
    x = np.array([1.7, 0.9])
    np.testing.assert_allclose(ts.residual(_t(x)).numpy(), np.asarray(js.residual(x)),
                               rtol=1e-15)
    got = ts.residual_df(tdd.df_from_f64(_t(x)))
    want = js.residual_df(jdd.df_from_f64(jnp.asarray(x)))
    np.testing.assert_array_equal(got.hi.numpy(), np.asarray(want.hi))
    np.testing.assert_allclose(tdd.df_to_f64(got).numpy(), np.asarray(js.residual(x)),
                               atol=1e-12)


@pytest.mark.parametrize("start", range(3))
def test_simple_starts_match_jax(start):
    """The documented starts (the third with the tuned η_max), GMRES: the
    same counts as the JAX package, the root (1, 1)."""
    x0 = js.STARTS[start]
    kj, kt = {}, {}
    if start == 2:
        kj["forcing"] = nk.EisenstatWalker(eta_max=js.TUNED_ETA_MAX)
        kt["forcing"] = nkt.EisenstatWalker(eta_max=ts.TUNED_ETA_MAX)
    uj, ij = nk.newton_krylov_jit(js.residual, jnp.asarray(x0), **kj)
    ut, it = nkt.newton_krylov_jit(ts.residual, _t(x0), **kt)
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-12)


def test_simple_refined_to_1e8():
    """The Kelley system through f32 Krylov + the df32 residual to 1e-8: the
    JAX package's counts and the root."""
    x0 = np.array([2.0, 0.5])
    kw = dict(tol_rel=1e-8)
    ut, it = nkt.newton_krylov_jit(ts.residual, _t(x0), krylov_dtype=F32,
                                   residual_df=ts.residual_df, **kw)
    _, ij = nk.newton_krylov_jit(js.residual, jnp.asarray(x0), krylov_dtype=jnp.float32,
                                 residual_df=js.residual_df, **kw)
    assert bool(it.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    assert float((ut - 1.0).abs().max()) < 1e-7


def test_bratu1d_refined_solve_to_1e8():
    """N = 2048 through f32 CG preconditioned by ``banded_direct`` (Thomas on
    the CPU) with the df32 acceptance residual: the JAX package's counts,
    the f64 true residual within the driver's tolerance."""
    n = 2048
    p = jb.default_config(n)
    u0 = jb.initial_guess(n)
    kw = dict(algo="cg", tol_rel=1e-8, max_niter=30)
    ut, it = nkt.newton_krylov_jit(tb.residual_scaled, _t(u0), p, krylov_dtype=F32,
                                   residual_df=tb.residual_scaled_df,
                                   M=tp.banded_direct(), **kw)
    _, ij = nk.newton_krylov_jit(jb.residual_scaled, u0, p, krylov_dtype=jnp.float32,
                                 residual_df=jb.residual_scaled_df,
                                 M=jp.banded_direct(), **kw)
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    r64 = np.linalg.norm(np.asarray(jb.residual_scaled(ut.numpy(), p)))
    tol = 1e-12 + 1e-8 * np.linalg.norm(np.asarray(jb.residual_scaled(u0, p)))
    assert r64 <= 1.2 * tol


# examples/bratu_1d.py:42-55: (tag, JAX options, port options, counts
# compared).  "outer" recipes take thousands of unpreconditioned inner steps
# (Queue 3 item 16).
_GALLERY = [
    ("cg", {}, {}, "outer"),
    ("cg + Fixed(0.1)", dict(forcing=nk.Fixed(0.1)), dict(forcing=nkt.Fixed(0.1)), "outer"),
    ("cg, exact Newton", dict(forcing=None), dict(forcing=None), "outer"),
    ("gmres + banded direct", dict(algo="gmres", N=jp.banded_direct()),
     dict(algo="gmres", N=tp.banded_direct()), "both"),
    ("gmres, no preconditioner",
     dict(algo="gmres", max_niter=4, krylov_kwargs={"restart": 20, "itmax": 60}),
     None, "both"),
    ("bicgstab", dict(algo="bicgstab", max_niter=4, krylov_kwargs={"itmax": 60}),
     None, "outer"),
    ("cgls", dict(algo="cgls", max_niter=4, krylov_kwargs={"itmax": 60}), None, "both"),
]


@pytest.mark.parametrize("tag,kj,kt,compare", _GALLERY, ids=[g[0] for g in _GALLERY])
def test_gallery_recipe_matches_jax(tag, kj, kt, compare):
    """One gallery recipe at N = 512 in f64 from the JAX package's u₀: the
    positive recipes solve to the JAX package's root, the negative ones
    (``max_niter=4``, ``itmax=60``) end unsolved with a finite iterate, as
    in the JAX package."""
    n = 512
    p = jb.default_config(n)
    u0 = jb.initial_guess(n)
    kt = dict(kj if kt is None else kt)
    kj = dict(kj)
    for kw in (kj, kt):
        kw.setdefault("algo", "cg")
    uj, ij = nk.newton_krylov_jit(jb.residual, u0, p, **kj)
    ut, it = nkt.newton_krylov_jit(tb.residual, _t(u0), convert.params(p), **kt)
    print(f"gallery N={n} {tag}: JAX {int(ij.stats.outer_iterations)}/"
          f"{int(ij.stats.inner_iterations)}, port {it.stats.outer_iterations}/"
          f"{it.stats.inner_iterations}")
    assert bool(it.solved) == bool(ij.solved) == (kj["algo"] in ("cg", "gmres")
                                                  and "max_niter" not in kj)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    if compare == "both":
        assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    assert bool(torch.isfinite(ut).all())
    if bool(ij.solved):
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-9)
