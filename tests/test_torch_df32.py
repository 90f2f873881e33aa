"""The port's df32 (double-float) arithmetic against the JAX package's, bit
for bit.

Both sides run strict-IEEE float32 on the CPU: tests/conftest.py turns
XLA:CPU's fast-math off, and the port uses only eager elementwise ops.  The
error-free transforms and everything assembled from them must then agree in
every bit, so these tests compare bit patterns, not values with a tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu.df32 as jd
import newtonkrylov_tpu_torch.df32 as td
from newtonkrylov_tpu.problems import bratu2d as jb
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.utils import convert


def _f32(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _df_np(seed, shape, lo=-1.0, hi=1.0):
    """A normalized df32 pair (hi, lo) of f64 samples, split in numpy."""
    x = np.random.default_rng(seed).uniform(lo, hi, shape)
    h = x.astype(np.float32)
    return h, (x - h.astype(np.float64)).astype(np.float32)


def _t(a):
    return convert.state(a, device="cpu")


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def assert_bitwise(got, ref):
    got = convert.to_numpy(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def assert_df_bitwise(got, ref):
    assert_bitwise(got.hi, ref.hi)
    assert_bitwise(got.lo, ref.lo)


def _pair(seed, shape, lo=-1.0, hi=1.0):
    h, l = _df_np(seed, shape, lo, hi)
    return jd.DF(jnp.asarray(h), jnp.asarray(l)), convert.df_pair(h, l, device="cpu")


@pytest.mark.parametrize("fn", ["two_sum", "fast_two_sum", "two_prod"])
def test_error_free_transforms_bitwise(fn):
    a, b = _f32(0, (64, 64), -1e3, 1e3), _f32(1, (64, 64), -1.0, 1.0)
    ref = getattr(jd, fn)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(td, fn)(_t(a), _t(b))
    for g, r in zip(got, ref):
        assert_bitwise(g, r)


@pytest.mark.parametrize("fn", ["add", "mul"])
def test_double_word_ops_bitwise(fn):
    aj, at = _pair(2, (32, 32), -10, 10)
    bj, bt = _pair(3, (32, 32), -10, 10)
    assert_df_bitwise(getattr(td, fn)(at, bt), getattr(jd, fn)(aj, bj))


def test_add_f32_neg_tree_add_bitwise():
    aj, at = _pair(4, (32, 32), -10, 10)
    b = _f32(5, (32, 32))
    assert_df_bitwise(td.add_f32(at, _t(b)), jd.add_f32(aj, jnp.asarray(b)))
    assert_df_bitwise(td.neg(at), jd.neg(aj))
    assert_df_bitwise(td.tree_add_f32(at, _t(b)), jd.tree_add_f32(aj, jnp.asarray(b)))


def test_boundary_conversions_bitwise():
    x = np.random.default_rng(6).uniform(-3, 3, (16, 16))
    ref = jd.df_from_f64(jnp.asarray(x))
    got = td.df_from_f64(_t(x))
    assert_df_bitwise(got, ref)
    assert_bitwise(td.df_to_f64(got), jd.df_to_f64(ref))
    x32 = x.astype(np.float32)
    assert_df_bitwise(td.df_from_f64(_t(x32)), jd.df_from_f64(jnp.asarray(x32)))
    assert_df_bitwise(td.df_from_f32(_t(x32)), jd.df_from_f32(jnp.asarray(x32)))


@pytest.mark.parametrize("lo,hi", [(-0.4, 0.4), (-20.0, 20.0), (-60.0, 60.0)],
                         ids=["reduced", "moderate", "wide"])
def test_exp_bitwise(lo, hi):
    aj, at = _pair(7, (64, 64), lo, hi)
    assert_df_bitwise(td.exp(at), jd.exp(aj))


def test_exp_subnormal_lo_word():
    """Below x ≈ −63 the result's lo word is subnormal.  XLA:CPU flushes
    subnormals to zero and PyTorch keeps them (ROADMAP.md Queue 3), so
    there the hi words are equal bit for bit and the lo words differ by less
    than the smallest normal float32."""
    aj, at = _pair(12, (64, 64), -87.0, -60.0)
    got, ref = td.exp(at), jd.exp(aj)
    assert_bitwise(got.hi, ref.hi)
    tiny = np.finfo(np.float32).tiny
    assert np.all(np.abs(got.lo.numpy() - np.asarray(ref.lo)) < tiny)


def test_ldexp_bitwise():
    x = _f32(8, (200,), 0.5, 2.0)
    k = np.arange(-100, 100, dtype=np.int32)
    assert_bitwise(td._ldexp(_t(x), _t(k)), jd._ldexp(jnp.asarray(x), jnp.asarray(k)))


@pytest.mark.parametrize("c", [1.38e-5, -2.5, 3.0])
def test_scaled_exp_bitwise(c):
    aj, at = _pair(9, (32, 32), -2, 2)
    assert_df_bitwise(td.scaled_exp(at, c), jd.scaled_exp(aj, c))


def test_stencil_combinators_bitwise():
    uj, ut = _pair(10, (18, 18), -1, 1)
    offsets = [(1, 0), (-1, 0), (0, 1), (0, -1)]
    assert_df_bitwise(td.neighbor_sum(ut, offsets), jd.neighbor_sum(uj, offsets))
    assert_df_bitwise(td.shift(ut, 0, -1), jd.shift(uj, 0, -1))
    assert_df_bitwise(td.scale_pow2(ut, -4.0), jd.scale_pow2(uj, -4.0))
    with pytest.raises(ValueError, match="power of two"):
        td.scale_pow2(ut, 3.0)


@pytest.mark.parametrize("n", [16, 48])
def test_residual_scaled_df_bitwise(n):
    pj = jb.default_config(n, lam=5.0)
    uj, ut = _pair(11, (n, n), 0.0, 1.2)
    ref = jb.residual_scaled_df(uj, pj)
    got = tb.residual_scaled_df(ut, convert.params(pj))
    assert_df_bitwise(got, ref)
    # the f32 norm sums in another order than XLA's: a few ulps, not bits
    np.testing.assert_allclose(float(td.norm_hi(got)), float(jd.norm_hi(ref)),
                               rtol=4 * np.finfo(np.float32).eps)


@pytest.mark.parametrize("n", [16, 48])
def test_floor_estimate_bitwise(n):
    pj = jb.default_config(n, lam=5.0)
    u = np.asarray(jb.initial_guess(n, dtype=jnp.float32))
    ref = jd.floor_estimate(jb.residual_scaled, jnp.asarray(u), pj)
    got = td.floor_estimate(tb.residual_scaled, _t(u), convert.params(pj))
    assert got.dtype == torch.float32
    assert_bitwise(got, ref)


def test_floor_estimate_zero_state():
    p = tb.default_config(16, 5.0)
    z = torch.zeros((16, 16), dtype=torch.float32)
    assert float(td.floor_estimate(tb.residual_scaled, z, p)) == 0.0


def test_selfcheck_cpu():
    assert td.selfcheck("cpu")
    assert jd.selfcheck()
