"""The port's DST-Poisson preconditioner and its coefficient probe against
the JAX package, in float64 at n = 32 (rtol 1e-12: matrix products and FFTs
sum in other orders than XLA's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu.fftprec as jf
import newtonkrylov_tpu.mg as jmg
import newtonkrylov_tpu_torch as nkt
import newtonkrylov_tpu_torch.fftprec as tf
import newtonkrylov_tpu_torch.mg as tmg
from newtonkrylov_tpu.problems import bratu2d as jb
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.utils import convert

F64 = torch.float64
N = 32
RTOL = 1e-12


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(a, dtype=F64):
    return convert.state(a, device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def jacobians():
    pj = jb.default_config(N, lam=5.0)
    u = np.asarray(jb.initial_guess(N)) + 0.05 * _np(0, (N, N))
    Jj = nk.JacobianOperator(jb.residual_scaled, jnp.asarray(u), pj)
    Jt = nkt.JacobianOperator(tb.residual_scaled, _t(u), convert.params(pj))
    return Jj, Jt


@pytest.mark.parametrize("n,dtype", [(7, torch.float64), (32, torch.float64),
                                     (32, torch.float32)])
def test_sine_basis_matches_jax(n, dtype):
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    got = tf.sine_basis(n, dtype, device="cpu")
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(jf.sine_basis(n, jdt)))


def test_probe_5point_matches_jax(jacobians):
    Jj, Jt = jacobians
    oj, dj = jmg.probe_5point(Jj)
    ot, dt = tmg.probe_5point(Jt)
    np.testing.assert_allclose(float(ot), float(oj), rtol=RTOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL)


def test_probe_5point_offsets_match_jax(jacobians):
    Jj, Jt = jacobians
    oj, dj = jmg.probe_5point(Jj, 3, 5)
    ot, dt = tmg.probe_5point(Jt, 3, 5)
    np.testing.assert_allclose(float(ot), float(oj), rtol=RTOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL)


def test_neighbor_apply_matches_jax():
    u, d = _np(1, (N, N)), _np(2, (N, N))
    np.testing.assert_allclose(tmg._apply(_t(u), 0.7, _t(d)).numpy(),
                               np.asarray(jmg._apply(jnp.asarray(u), 0.7, jnp.asarray(d))),
                               rtol=0, atol=1e-14)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_dst1_matches_jax(axis):
    x = _np(3, (N, N + 3))
    np.testing.assert_allclose(tf.dst1(_t(x), axis).numpy(),
                               np.asarray(jf.dst1(jnp.asarray(x), axis)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tf.idst1(_t(x), axis).numpy(),
                               np.asarray(jf.idst1(jnp.asarray(x), axis)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["matmul", "fft"])
def test_dst_poisson_solver_matches_jax(method):
    o, dbar = -1.0, -3.9
    r = _np(4, (N, N))
    aj = jf.dst_poisson_solver(jnp.asarray(o), jnp.asarray(dbar), (N, N), jnp.float64,
                               method=method, precision="high")
    at = tf.dst_poisson_solver(torch.tensor(o, dtype=F64), torch.tensor(dbar, dtype=F64),
                               (N, N), F64, method=method, precision="high")
    ref = np.asarray(aj(jnp.asarray(r)))
    np.testing.assert_allclose(at(_t(r)).numpy(), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def test_dst_engines_agree():
    """The two engines of one solver at 64² in f64 (the CPU rehearsal of
    ``chip_smoke.py``'s DST engine table, which holds them to 1e-4 in f32
    on the card): the same inverse to 1e-12."""
    n, o, dbar = 64, -1.0, -3.9
    r = _t(_np(7, (n, n)))
    out = {m: tf.dst_poisson_solver(torch.tensor(o, dtype=F64),
                                    torch.tensor(dbar, dtype=F64), (n, n), F64,
                                    method=m, precision="high")(r)
           for m in ("matmul", "fft")}
    ref = out["matmul"].numpy()
    np.testing.assert_allclose(out["fft"].numpy(), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


def test_flagship_counts_equal_on_both_engines():
    """The flagship configuration (CG, DST built once, ``tol_rel=1e-8``) at
    64² in f64 with ``method="fft"`` takes the counts of ``"matmul"`` and of
    the JAX package's FFT engine, and their state to 1e-12 (the CPU
    rehearsal of the card's FFT-engine flagships, gated on the matrix
    products' outer count)."""
    n = 64
    pj = jb.default_config(n, lam=5.0)
    u0 = np.asarray(jb.initial_guess(n))
    kw = dict(algo="cg", tol_rel=1e-8, max_niter=20, precond_refresh="once")
    runs = {m: nkt.newton_krylov_jit(tb.residual_scaled, _t(u0), convert.params(pj),
                                     M=tf.fft_poisson(precision="high", method=m),
                                     **kw)
            for m in ("matmul", "fft")}
    uj, ij = nk.newton_krylov_jit(jb.residual_scaled, jnp.asarray(u0), pj,
                                  M=jf.fft_poisson(precision="high", method="fft"),
                                  **kw)
    counts = {m: (info.stats.outer_iterations, info.stats.inner_iterations)
              for m, (_, info) in runs.items()}
    assert all(bool(info.solved) for _, info in runs.values()) and bool(ij.solved)
    assert counts["fft"] == counts["matmul"] == (
        int(ij.stats.outer_iterations), int(ij.stats.inner_iterations))
    np.testing.assert_allclose(runs["fft"][0].numpy(), runs["matmul"][0].numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(runs["fft"][0].numpy(), np.asarray(uj),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("shift", ["mean", "none"])
def test_fft_poisson_factory_matches_jax(jacobians, shift):
    Jj, Jt = jacobians
    r = _np(5, (N, N))
    ref = np.asarray(jf.fft_poisson(shift=shift, precision="high")(Jj)(jnp.asarray(r)))
    got = tf.fft_poisson(shift=shift, precision="high")(Jt)(_t(r)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def test_fft_poisson_inverts_constant_coefficient_operator():
    """M⁻¹ is the exact inverse of o·S + d̄·I: A(M⁻¹ r) = r."""
    o, dbar = -1.0, -3.7
    apply = tf.dst_poisson_solver(torch.tensor(o, dtype=F64), torch.tensor(dbar, dtype=F64),
                                  (N, N), F64)
    r = _t(_np(6, (N, N)))
    back = tmg._apply(apply(r), o, torch.full((N, N), dbar, dtype=F64))
    np.testing.assert_allclose(back.numpy(), r.numpy(), rtol=0, atol=1e-11)


def test_matmul_engine_refuses_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            tf.dst_poisson_solver(torch.tensor(-1.0), torch.tensor(-4.0), (8, 8),
                                  torch.float32, method="matmul")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="Queue 3"):
        tf.dst_poisson_solver(torch.tensor(-1.0), torch.tensor(-4.0), (8, 8),
                              torch.float32, precision="default")
    # the sharded forms need a mesh; the global one needs axis names and
    # the matrix-product engine
    with pytest.raises(ValueError, match="requires axis_names"):
        tf.fft_poisson(scope="global")
    with pytest.raises(ValueError, match="only the matmul engine"):
        tf.fft_poisson(axis_names=("i", "j"), scope="global", method="fft")
    with pytest.raises(ValueError, match="unknown method"):
        tf.fft_poisson(method="dct")
