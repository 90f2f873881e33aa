"""The port's convection–diffusion problem and its GMRES solves against the
JAX package (``problems/convdiff2d.py``, tests/test_convdiff.py).

The JAX package's forcing ``b`` and states are handed over as numpy, so both
packages evaluate the same bits.  The df32 residual must be bitwise equal;
the f64 DST-preconditioned full-GMRES solve must take the same outer and
inner counts and reach the same solution; the refined df32/f32 solve the
same outer count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import df32 as jdd
from newtonkrylov_tpu.fftprec import fft_poisson as j_fft_poisson
from newtonkrylov_tpu.problems import bratu2d as jb
from newtonkrylov_tpu.problems import convdiff2d as jc
from newtonkrylov_tpu_torch import df32 as tdd
from newtonkrylov_tpu_torch.fftprec import fft_poisson as t_fft_poisson
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.problems import convdiff2d as tc
from newtonkrylov_tpu_torch.utils import convert

F64, F32 = torch.float64, torch.float32
FULL_GMRES = {"restart": None, "itmax": 150}


def _t(a, dtype=None):
    return convert.state(np.asarray(a), device="cpu", dtype=dtype)


def _params(pj) -> tc.Params:
    return tc.Params(dx=float(pj.dx), c=float(pj.c), b=_t(pj.b))


def _perturbed(n, seed=11):
    rng = np.random.default_rng(seed)
    us = jc.manufactured_solution(n, jnp.float64)
    return us * (1.0 + 1e-3) + jnp.asarray(rng.uniform(-1e-3, 1e-3, (n, n)))


def test_manufactured_solution_is_discrete_root():
    """The port's own configuration: u* is the discrete root in f64, and its
    forcing is the JAX package's within the rounding of its grid."""
    n = 48
    p = tc.default_config(n, device="cpu")
    us = tc.manufactured_solution(n, device="cpu")
    assert float(tc.residual_scaled(us, p).abs().max()) < 1e-15
    assert p.b.dtype == F64 and p.b.device.type == "cpu"
    bj = np.asarray(jc.default_config(n, dtype=jnp.float64).b)
    np.testing.assert_allclose(p.b.numpy(), bj, rtol=0, atol=1e-15)
    assert tc.initial_guess(n, F32, device="cpu").dtype == F32


@pytest.mark.parametrize("c", [2.0, 25.0])
def test_residual_matches_jax(c):
    """residual_scaled at n = 48 on the same state and forcing: within 4 ulp
    of the operand scale (XLA:CPU contracts multiply-adds, ROADMAP.md
    Queue 3 item 6)."""
    n = 48
    pj = jc.default_config(n, c=c, dtype=jnp.float64)
    x = _perturbed(n)
    ref = np.asarray(jc.residual_scaled(x, pj))
    got = tc.residual_scaled(_t(x), _params(pj)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=4 * np.finfo(np.float64).eps * 4.0)


@pytest.mark.parametrize("b_dtype", ["f64", "f32"])
def test_df32_residual_bitwise(b_dtype):
    """residual_scaled_df on the same df32 state: hi and lo words bitwise
    equal to the JAX package's (f64 forcing split into a df32 pair, or an
    f32 forcing with lo = 0)."""
    n = 40
    pj = jc.default_config(n, dtype=jnp.float64)
    if b_dtype == "f32":
        pj = pj._replace(b=pj.b.astype(jnp.float32))
    x = _perturbed(n)
    rj = jc.residual_scaled_df(jdd.df_from_f64(x), pj)
    xd = jdd.df_from_f64(x)
    rt = tc.residual_scaled_df(convert.df_pair(xd.hi, xd.lo, device="cpu"), _params(pj))
    np.testing.assert_array_equal(rt.hi.numpy(), np.asarray(rj.hi))
    np.testing.assert_array_equal(rt.lo.numpy(), np.asarray(rj.lo))
    # and it resolves the f64 residual far below f32 relative accuracy
    want = np.asarray(jc.residual_scaled(x, pj))
    got = tdd.df_to_f64(rt).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-10


def test_df32_sub_and_scale_const_bitwise():
    rng = np.random.default_rng(5)
    a64, b64 = rng.standard_normal((2, 64))
    aj, bj = jdd.df_from_f64(jnp.asarray(a64)), jdd.df_from_f64(jnp.asarray(b64))
    at = convert.df_pair(aj.hi, aj.lo, device="cpu")
    bt = convert.df_pair(bj.hi, bj.lo, device="cpu")
    for got, ref in ((tdd.sub(at, bt), jdd.sub(aj, bj)),
                     (tdd.scale_const(at, -0.5 / 33 * 2.0), jdd.scale_const(aj, -0.5 / 33 * 2.0))):
        np.testing.assert_array_equal(got.hi.numpy(), np.asarray(ref.hi))
        np.testing.assert_array_equal(got.lo.numpy(), np.asarray(ref.lo))


def test_gmres_dst_solve_matches_jax():
    """newton_krylov_jit + full GMRES + DST at n = 32, f64, exact Newton:
    identical outer and inner counts, solution within 1e-12."""
    n = 32
    pj = jc.default_config(n, dtype=jnp.float64)
    u0 = jc.initial_guess(n, jnp.float64)
    kw = dict(algo="gmres", tol_rel=1e-10, forcing=None, krylov_kwargs=FULL_GMRES)
    uj, ij = nk.newton_krylov_jit(jc.residual_scaled, u0, pj, M=j_fft_poisson(), **kw)
    ut, it = nkt.newton_krylov_jit(tc.residual_scaled, _t(u0), _params(pj),
                                   M=t_fft_poisson(), **kw)
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-12)
    us = tc.manufactured_solution(n, device="cpu")
    assert float((ut - us).abs().max()) < 1e-9


def test_refined_df32_solve_matches_jax():
    """The refined path (f32 Krylov, df32 acceptance residual) at n = 32:
    solved to 1e-8, the JAX package's outer count, max|u − u*| ≤ 1e-6."""
    n = 32
    pj = jc.default_config(n, dtype=jnp.float64)
    u0 = jc.initial_guess(n, jnp.float64)
    kw = dict(algo="gmres", tol_rel=1e-8, forcing=None, max_niter=25,
              krylov_kwargs=FULL_GMRES)
    uj, ij = nk.newton_krylov_jit(
        jc.residual_scaled, u0, pj, krylov_dtype=jnp.float32,
        residual_df=jc.residual_scaled_df, M=j_fft_poisson(), **kw)
    ut, it = nkt.newton_krylov_jit(
        tc.residual_scaled, _t(u0), _params(pj), krylov_dtype=F32,
        residual_df=tc.residual_scaled_df, M=t_fft_poisson(), **kw)
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert ut.dtype == F64
    us = tc.manufactured_solution(n, device="cpu")
    assert float((ut - us).abs().max()) < 1e-6


def test_default_algo_bratu_flagship_matches_jax():
    """``newton_krylov_jit(F, u0, p)`` with every default (GMRES with the
    parity basis, Eisenstat–Walker) on the Bratu flagship residual at
    n = 32, f64: it runs, and takes the JAX package's counts."""
    n = 32
    pj = jb.default_config(n, lam=5.0)
    u0 = jb.initial_guess(n)
    uj, ij = nk.newton_krylov_jit(jb.residual_scaled, u0, pj)
    ut, it = nkt.newton_krylov_jit(tb.residual_scaled, _t(u0), convert.params(pj))
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-10)
