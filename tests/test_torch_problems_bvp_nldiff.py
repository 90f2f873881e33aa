"""The port's BVP and quasilinear-diffusion problems against the JAX package.

Oracles: tests/test_problems.py (the BVP with banded LU),
tests/test_df32_problems.py (the df32
residuals against f64, the BVP refined to 1e-8 through the host driver)
and tests/test_nldiff.py (the manufactured root, ADI).  The
same numpy inputs go to both packages, in float64 unless stated.
"""

import jax.numpy as jnp
import numpy as np
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import df32 as jdd
from newtonkrylov_tpu import precond as jp
from newtonkrylov_tpu.problems import bvp as jbvp
from newtonkrylov_tpu.problems import nldiff2d as jnl
from newtonkrylov_tpu_torch import df32 as tdd
from newtonkrylov_tpu_torch import precond as tp
from newtonkrylov_tpu_torch.problems import bvp as tbvp
from newtonkrylov_tpu_torch.problems import nldiff2d as tnl

F64, F32 = torch.float64, torch.float32


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _counts(info):
    return (int(info.stats.outer_iterations), int(info.stats.inner_iterations))


def test_bvp_setup_and_residuals_match_jax():
    """n = 201: the times, u₀ and the residual within 1e-14 relative of the
    JAX package's; the df32 residual's hi words bitwise equal to JAX's and
    its value within 1e-12 of the f64 residual."""
    n = 201
    pj, pt = jbvp.default_config(n), tbvp.default_config(n, device="cpu")
    assert (pt.h, pt.n) == (pj.h, pj.n)
    np.testing.assert_array_equal(pt.tv.numpy(), np.asarray(pj.tv))
    np.testing.assert_allclose(pt.tvdag.numpy(), np.asarray(pj.tvdag), rtol=1e-15)
    U0 = np.asarray(jbvp.initial_guess(pj))
    np.testing.assert_allclose(tbvp.initial_guess(pt).numpy(), U0, rtol=1e-14)
    U = U0 * 1.01
    want = np.asarray(jbvp.residual(jnp.asarray(U), pj))
    got = tbvp.residual(_t(U), pt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14 * np.abs(want).max())
    got_df = tbvp.residual_df(tdd.df_from_f64(_t(U)), pt)
    want_df = jbvp.residual_df(jdd.df_from_f64(jnp.asarray(U)), pj)
    np.testing.assert_array_equal(got_df.hi.numpy(), np.asarray(want_df.hi))
    assert float((tdd.df_to_f64(got_df) - _t(want)).abs().max()) < 1e-12


def test_bvp_banded_lu_solve_matches_jax():
    """The robust recipe, GMRES + ``banded_lu(2, 2)`` through
    ``newton_krylov`` at n = 101: the JAX package's counts, about one inner
    iteration an outer, the boundary conditions held, the solution within
    1e-9 of JAX's; and refined to 1e-8 through f32 Krylov and the df32
    residual (``tests/test_df32_problems.py:240-253``) in as many outers,
    its f64 residual under the tolerance."""
    n = 101
    pj, pt = jbvp.default_config(n), tbvp.default_config(n, device="cpu")
    U0 = np.asarray(jbvp.initial_guess(pj))
    Uj, ij = nk.newton_krylov(jbvp.residual, jnp.asarray(U0), pj, algo="gmres",
                              N=jp.banded_lu(2, 2))
    Ut, it = nkt.newton_krylov(tbvp.residual, _t(U0), pt, algo="gmres",
                               N=tp.banded_lu(2, 2))
    assert it.solved and bool(ij.solved)
    assert _counts(it) == _counts(ij)
    assert it.stats.inner_iterations <= 2 * it.stats.outer_iterations
    assert abs(float(Ut[1])) < 1e-6 and abs(float(Ut[-2])) < 1e-6
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), atol=1e-9)
    Ut, ir = nkt.newton_krylov(tbvp.residual, _t(U0), pt, algo="gmres",
                               N=tp.banded_lu(2, 2), tol_rel=1e-8,
                               residual_df=tbvp.residual_df)
    assert ir.solved
    assert ir.stats.outer_iterations == it.stats.outer_iterations
    f0 = float(torch.linalg.vector_norm(tbvp.residual(_t(U0), pt)))
    assert float(torch.linalg.vector_norm(tbvp.residual(Ut, pt))) <= 1e-8 * f0 + 1e-12


def test_nldiff2d_setup_and_residuals_match_jax():
    """32²: the manufactured solution and forcing within 1e-14 of the JAX
    package's (the grids differ by ≤ 4.4e-16, ROADMAP.md Queue 3 item 5),
    u* the discrete root to 1e-14; the residual at a detuned state within
    1e-13, and the df32 residual's hi words bitwise equal to JAX's on the
    same state and parameters, its value within 1e-13 of the f64 one."""
    n = 32
    pj = jnl.default_config(n, dtype=jnp.float64)
    pt = tnl.default_config(n, device="cpu")
    us = tnl.manufactured_solution(n, device="cpu")
    np.testing.assert_allclose(us.numpy(), np.asarray(jnl.manufactured_solution(
        n, dtype=jnp.float64)), atol=1e-14)
    np.testing.assert_allclose(pt.b.numpy(), np.asarray(pj.b), atol=1e-14)
    assert float(tnl.residual_scaled(us, pt).abs().max()) < 1e-14
    assert tnl.initial_guess(n, device="cpu").shape == (n, n)
    pt = tnl.Params(dx=pj.dx, b=_t(pj.b))  # JAX's forcing on both sides
    u = np.asarray(jnl.manufactured_solution(n, dtype=jnp.float64)) * 0.9 + 0.05
    want = np.asarray(jnl.residual_scaled(jnp.asarray(u), pj))
    np.testing.assert_allclose(tnl.residual_scaled(_t(u), pt).numpy(), want,
                               atol=1e-13)
    got_df = tnl.residual_scaled_df(tdd.df_from_f64(_t(u)), pt)
    want_df = jnl.residual_scaled_df(jdd.df_from_f64(jnp.asarray(u)), pj)
    np.testing.assert_array_equal(got_df.hi.numpy(), np.asarray(want_df.hi))
    assert float((tdd.df_to_f64(got_df) - _t(want)).abs().max()) < 1e-13


def test_nldiff2d_adi_solve_matches_jax():
    """32² from u₀ = 0, GMRES + ADI(4) with ``forcing=None``, f64 to 1e-10:
    the JAX package's counts, max|u − u*| ≤ 1e-9."""
    n = 32
    pj = jnl.default_config(n, dtype=jnp.float64)
    pt = tnl.Params(dx=pj.dx, b=_t(pj.b))
    u0 = np.zeros((n, n))
    kw = dict(algo="gmres", forcing=None, max_niter=15, tol_rel=1e-10,
              krylov_kwargs={"restart": None, "itmax": 300})
    _, ij = nk.newton_krylov_jit(jnl.residual_scaled, jnp.asarray(u0), pj,
                                 M=jp.adi(4), **kw)
    ut, it = nkt.newton_krylov_jit(tnl.residual_scaled, _t(u0), pt, M=tp.adi(4), **kw)
    assert bool(it.solved) and bool(ij.solved)
    assert _counts(it) == _counts(ij)
    us = _t(jnl.manufactured_solution(n, dtype=jnp.float64))
    assert float((ut - us).abs().max()) <= 1e-9
