"""The port's DST-Poisson preconditioner and its coefficient probe against
the JAX package, in float64 at n = 32 (rtol 1e-12: matrix products and FFTs
sum in other orders than XLA's); the single-pass mode (``"default"``)
against a plain bf16 rounding reference and against the JAX package's CPU
apply, which ignores the precision (ROADMAP.md Queue 3 item 27)."""

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
    # the sharded forms need a mesh; the global one needs axis names and
    # the matrix-product engine
    with pytest.raises(ValueError, match="requires axis_names"):
        tf.fft_poisson(scope="global")
    with pytest.raises(ValueError, match="only the matmul engine"):
        tf.fft_poisson(axis_names=("i", "j"), scope="global", method="fft")
    with pytest.raises(ValueError, match="unknown method"):
        tf.fft_poisson(method="dct")
    with pytest.raises(ValueError, match="unknown precision"):
        tf.dst_poisson_solver(torch.tensor(-1.0), torch.tensor(-4.0), (8, 8),
                              torch.float32, precision="tf32")


# -- The single-pass mode, precision="default" -------------------------------
#
# Each of the four products rounds both operands to bf16 and accumulates in
# the state's dtype (f32, or f64 for an f64 state).  The reference is plain
# numpy: the JAX package's sine basis, operands rounded to bf16 with
# ml_dtypes, products summed in f64.  A product of two bf16 numbers is
# exact in f32, so an f32 product differs from it by the f32 sums alone.
# The f32 apply is held to it product by product and whole.  At these sides
# the whole apply agrees to ~4e-8; at larger sides an f32 sum now and then
# lands on the other side of a bf16 rounding boundary of the next operand
# (one bf16 ulp of an intermediate, spread by the next product and scaled
# by 1/λ), which the per-product check does not see.

SINGLE_PASS_RTOL = 1e-5
O, DBAR = -1.0, -3.9


def _bf16(x):
    import ml_dtypes

    return np.asarray(x).astype(ml_dtypes.bfloat16).astype(np.float64)


def _lam(n, m, dtype):
    """The eigenvalue table as the solver forms it: o and d̄ held in
    ``dtype``, the table in f64, then rounded to ``dtype``."""
    o, dbar = (float(np.asarray(v, dtype)) for v in (O, DBAR))
    ci = 2.0 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1))
    cj = 2.0 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1))
    return (o * (ci[:, None] + cj[None, :] - 4.0) + (dbar + 4.0 * o)
            ).astype(dtype).astype(np.float64)


def _single_pass_reference(r, n, m, dtype):
    """The single-pass apply with every operand rounded to bf16 and every
    product summed in f64; the eigenvalue table and the norm in ``dtype``,
    as the apply holds them."""
    Sr = _bf16(np.asarray(jf.sine_basis(n, jnp.float32)))
    Sc = _bf16(np.asarray(jf.sine_basis(m, jnp.float32)))
    x = _bf16(Sr @ _bf16(r)) @ Sc / _lam(n, m, dtype)
    x = _bf16(Sr @ _bf16(x)) @ Sc
    return x * float(np.asarray((2.0 / (n + 1)) * (2.0 / (m + 1)), dtype))


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _solver(shape, dtype, precision, method="matmul"):
    return tf.dst_poisson_solver(torch.tensor(O, dtype=dtype),
                                 torch.tensor(DBAR, dtype=dtype), shape, dtype,
                                 method=method, precision=precision)


@pytest.mark.parametrize("shape", [(32, 32), (64, 64), (24, 40)])
def test_single_pass_apply_matches_rounding_reference(shape):
    """The f32 ``"default"`` apply, product by product: every operand is
    its ml_dtypes bf16 rounding (the basis that of the JAX package's f32
    basis), each of the four products is within 1e-5 relative l2 of the
    f64 product of those operands, and the apply is that chain of products
    bit for bit."""
    n, m = shape
    f32 = torch.float32
    r = _np(8, shape).astype(np.float32)
    rnd, mm = tf._products("default", f32, "cpu")
    Sr = rnd(tf.sine_basis(n, f32, "cpu"))
    Sc = rnd(tf.sine_basis(m, f32, "cpu"))
    np.testing.assert_array_equal(Sr.numpy(), _bf16(np.asarray(jf.sine_basis(n, jnp.float32))))
    lam = torch.from_numpy(_lam(n, m, np.float32)).to(f32)
    x, errs = torch.from_numpy(r), []
    for k, (a, b) in enumerate([(Sr, None), (None, Sc), (Sr, None), (None, Sc)]):
        if k == 2:
            x = x / lam
        xr = rnd(x)
        np.testing.assert_array_equal(xr.numpy(), _bf16(x.numpy()))
        lhs, rhs = (a, xr) if a is not None else (xr, b)
        x = mm(lhs, rhs)
        assert x.dtype == f32
        errs.append(_rel_l2(x.numpy(), lhs.double().numpy() @ rhs.double().numpy()))
    chain = x * torch.tensor((2.0 / (n + 1)) * (2.0 / (m + 1)), dtype=f32)
    got = _solver(shape, f32, "default")(torch.from_numpy(r))
    assert torch.equal(got, chain)
    whole = _rel_l2(got.numpy(), _single_pass_reference(r, n, m, np.float32))
    print(f"{shape}: products {['%.2e' % e for e in errs]}, the whole apply "
          f"against the f64-summed reference {whole:.3e}")
    assert max(errs) <= SINGLE_PASS_RTOL and whole <= SINGLE_PASS_RTOL


@pytest.mark.parametrize("shape", [(32, 32), (64, 64), (24, 40)])
def test_single_pass_apply_against_jax_cpu(shape):
    """Against the JAX package's ``precision="default"`` apply on the CPU,
    where XLA ignores the precision (its ``"default"`` apply equals its
    ``"highest"`` bit for bit): the port's single pass differs from it by
    the bf16 rounding, between 1e-3 and 1e-2 relative l2 (ROADMAP.md
    Queue 3 item 27, a deliberate divergence).  The full-f32 applies of
    the two packages agree within 1e-4 (f32 sums in another order, scaled
    by 1/λ: measured 4.0e-6 to 1.6e-5)."""
    r = _np(9, shape).astype(np.float32)
    j = {prec: np.asarray(jf.dst_poisson_solver(
        jnp.asarray(O, jnp.float32), jnp.asarray(DBAR, jnp.float32), shape,
        jnp.float32, method="matmul", precision=prec)(jnp.asarray(r)))
        for prec in ("default", "highest")}
    np.testing.assert_array_equal(j["default"], j["highest"])
    got = _solver(shape, torch.float32, "default")(torch.from_numpy(r)).numpy()
    full = _solver(shape, torch.float32, "highest")(torch.from_numpy(r)).numpy()
    err = _rel_l2(got, j["default"])
    print(f"{shape}: port single pass against JAX's CPU 'default' {err:.3e}")
    assert 1e-3 <= err <= 1e-2
    assert _rel_l2(full, j["highest"]) <= 1e-4


def test_single_pass_apply_f64_state():
    """An f64 state rounds its operands to bf16 and accumulates in f64:
    the rounding reference to f64 rounding."""
    r = _np(10, (N, N))
    got = _solver((N, N), F64, "default")(_t(r))
    assert got.dtype == F64
    err = _rel_l2(got.numpy(), _single_pass_reference(r, N, N, np.float64))
    print(f"relative l2 {err:.3e}")
    assert err <= 1e-13


def test_fft_engine_ignores_precision():
    """The FFT engine runs the same transforms in every precision, as the
    JAX package's ``else`` branch does."""
    r = _t(_np(11, (N, N)), torch.float32)
    ref = _solver((N, N), torch.float32, "highest", "fft")(r)
    for prec in ("default", "high"):
        assert torch.equal(_solver((N, N), torch.float32, prec, "fft")(r), ref)


def test_flagship_solves_with_the_single_pass():
    """The flagship configuration at 64² (f32 Krylov, df32 acceptance, DST
    built once) with ``fft_poisson(precision="default")``: solved, the f64
    true residual within the tolerance the driver accepted at, the outer
    count of ``"highest"`` and at least its inners."""
    from newtonkrylov_tpu_torch.benchmarks import chain_solve

    n = 64
    u0 = tb.initial_guess(n, dtype=F64, device="cpu")
    p = tb.default_config(n, lam=5.0)
    runs = {prec: nkt.newton_krylov_jit(
        tb.residual_scaled, u0, p, **chain_solve.flagship_kwargs(
            tf.fft_poisson(precision=prec), "once"))
        for prec in ("highest", "default")}
    (u, info), (_, ref) = runs["default"], runs["highest"]
    print({k: (i.stats.outer_iterations, i.stats.inner_iterations)
           for k, (_, i) in runs.items()})
    assert bool(info.solved) and bool(ref.solved)
    fu, _ = chain_solve.true_residual(u, u0)
    assert fu <= chain_solve.clamped_tol(u0)[0]
    assert info.stats.outer_iterations == ref.stats.outer_iterations
    assert info.stats.inner_iterations >= ref.stats.inner_iterations


def test_two_grid_single_pass_builds_and_applies(jacobians):
    """``two_grid(precision="default")`` reaches the single pass through
    its coarse DST solve: the apply is finite and differs from the
    ``"highest"`` two-grid's only by the coarse solve's rounding."""
    from newtonkrylov_tpu_torch.precond import two_grid

    _, Jt = jacobians
    r = _t(_np(12, (N, N)))
    out = {prec: two_grid(8, precision=prec)(Jt)(r) for prec in ("default", "highest")}
    assert torch.isfinite(out["default"]).all()
    err = _rel_l2(out["default"].numpy(), out["highest"].numpy())
    print(f"two-grid default against highest: {err:.3e}")
    assert 0.0 < err <= 1e-2
