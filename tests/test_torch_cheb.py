"""The port's Chebyshev polynomial preconditioner against the JAX package's.

``newtonkrylov_tpu_torch.precond.chebyshev`` and its helpers get the same
inputs, made with numpy from a seed (and the JAX package's own initial
guesses), as ``newtonkrylov_tpu.precond``; the JAX ``engine="pallas"`` runs
its kernel in interpret mode, as tests/test_cheb.py does.  On the CPU the
port's ``engine="pallas"`` runs K4's plain version.

Tolerances: float64 rtol 1e-12 with atol 1e-12·max|ref|; float32 exactly
equal.  Solve tests hold iteration counts identical in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import precond as jp
from newtonkrylov_tpu.operator import JacobianOperator as JJacobian
from newtonkrylov_tpu.problems import bratu2d as jb
from newtonkrylov_tpu_torch import precond as tp
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.utils import convert

F64 = torch.float64


def _t(a, dtype=None):
    return convert.state(np.asarray(a), device="cpu", dtype=dtype)


def _jacobians(n=16, lam=4.0):
    """The scaled Bratu Jacobian at the JAX package's u₀, in both packages."""
    pj = jb.default_config(n, lam=lam)
    u0 = jb.initial_guess(n, dtype=jnp.float64)
    return (JJacobian(jb.residual_scaled, u0, pj),
            nkt.JacobianOperator(tb.residual_scaled, _t(u0), convert.params(pj)))


def _assert_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * float(np.abs(ref).max()))


@pytest.mark.parametrize("dtype", [F64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["nd-gershgorin", "pd-gershgorin", "tuple", "degenerate"])
def test_cheb_bounds_match_jax(case, dtype):
    jdt = {F64: jnp.float64, torch.float32: jnp.float32}[dtype]
    o, dmin, dmax, bounds = {
        "nd-gershgorin": (1.0, -4.0, -3.99, None),   # scaled Bratu: ND
        "pd-gershgorin": (-1.0, 4.0, 4.5, None),
        "tuple": (1.0, -4.0, -3.99, (-7.9, -0.01)),
        "degenerate": (0.0, 2.0, 2.0, None),
    }[case]
    ref = jp._cheb_bounds(jnp.asarray(o, jdt), jnp.asarray(dmin, jdt),
                          jnp.asarray(dmax, jdt), bounds, 1.0 / 300.0, jdt)
    got = tp._cheb_bounds(torch.tensor(o, dtype=dtype), torch.tensor(dmin, dtype=dtype),
                          torch.tensor(dmax, dtype=dtype), bounds, 1.0 / 300.0, dtype)
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        if dtype == F64:
            np.testing.assert_allclose(float(g), float(r), rtol=1e-12)
        else:
            assert g.numpy() == np.asarray(r)


@pytest.mark.parametrize("degree", [1, 4, 7])
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_cheb_engine_matches_jax(engine, degree):
    """Each engine of the port against the JAX engine of the same name (as
    test_cheb_pallas_engine_matches_xla_engine), and the two port engines
    against each other."""
    Jj, Jt = _jacobians()
    r = np.random.default_rng(2).standard_normal((16, 16))
    ref = jp.chebyshev(degree=degree, engine=engine)(Jj)(jnp.asarray(r))
    got = tp.chebyshev(degree=degree, engine=engine)(Jt)(_t(r))
    _assert_close(got, ref)
    other = "xla" if engine == "pallas" else "pallas"
    _assert_close(tp.chebyshev(degree=degree, engine=other)(Jt)(_t(r)), ref)


def test_cheb_linear_and_symmetric():
    """A fixed polynomial in a symmetric operator (tests/test_cheb.py:64)."""
    _, Jt = _jacobians()
    M = tp.chebyshev(degree=6, engine="xla")(Jt)
    rng = np.random.default_rng(1)
    r1, r2 = _t(rng.standard_normal((16, 16))), _t(rng.standard_normal((16, 16)))
    a, b = 1.3, -0.7
    np.testing.assert_allclose(M(a * r1 + b * r2).numpy(), (a * M(r1) + b * M(r2)).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(torch.vdot(r1.flatten(), M(r2).flatten())),
                               float(torch.vdot(M(r1).flatten(), r2.flatten())), rtol=1e-11)


def _count_k4(monkeypatch):
    calls = []
    real = tp.K.chebyshev_apply
    monkeypatch.setattr(tp.K, "chebyshev_apply",
                        lambda *a: calls.append(a[3:]) or real(*a))
    return calls


def test_cheb_auto_engine_picks_kernel_only_for_cuda_f32(monkeypatch):
    """``engine="auto"`` runs the recurrence on a CPU state, in f32 and f64;
    ``"pallas"`` routes every apply through K4's op.  (On a CUDA state
    ``"auto"`` runs K4 in f32 and f64 alike: tests/test_torch_cuda.py.)"""
    calls = _count_k4(monkeypatch)
    n = 128
    p = tb.default_config(n, 5.0)
    for dt in (torch.float32, F64):
        J = nkt.JacobianOperator(tb.residual_scaled,
                                 tb.initial_guess(n, dt, device="cpu"), p)
        r = torch.ones((n, n), dtype=dt)
        tp.chebyshev(4, engine="auto")(J)(r)
        assert calls == []
    tp.chebyshev(4, engine="pallas")(J)(r)
    assert calls == [(n, 4)]


def test_cheb_auto_engine_recurrence_on_unaligned_cpu_state(monkeypatch):
    """On the CPU, ``"auto"`` takes a state the aligned layout cannot
    (n % 8 ≠ 0) through the recurrence, equal to the JAX XLA engine."""
    calls = _count_k4(monkeypatch)
    Jj, Jt = _jacobians(n=12)
    r = np.random.default_rng(3).standard_normal((12, 12))
    ref = jp.chebyshev(degree=5, engine="xla")(Jj)(jnp.asarray(r))
    _assert_close(tp.chebyshev(degree=5, engine="auto")(Jt)(_t(r)), ref)
    assert calls == []


def test_chebyshev_rejects_unported_and_bad_options():
    _, Jt = _jacobians(8)
    with pytest.raises(ValueError, match="engine"):
        tp.chebyshev(engine="mosaic")
    with pytest.raises(NotImplementedError, match="item 20"):
        tp.chebyshev(axis_names=("i", "j"))
    with pytest.raises(ValueError, match="bounds"):
        tp.chebyshev(bounds="gershgorin")(Jt)


@pytest.mark.parametrize("option", [{"bc": "periodic"}, {"bc": "neumann"}])
def test_chebyshev_rejects_options_of_unported_paths(option):
    """``bc`` acts only on the sharded form; set away from its default it
    raises, not passes silently."""
    with pytest.raises(NotImplementedError, match="item 20"):
        tp.chebyshev(**option)


def test_cheb_kernel_engine_rejects_unaligned_state():
    """``engine="pallas"`` on a state the aligned layout cannot take raises,
    naming the plain engine."""
    _, Jt = _jacobians(n=12)
    with pytest.raises(ValueError, match='engine="xla"'):
        tp.chebyshev(4, engine="pallas")(Jt)


def test_newton_cheb_cg_counts_match_jax():
    """Full JFNK with Chebyshev(8)-preconditioned CG, f64, n = 64 (the
    configuration of tests/test_cheb.py:117): solved, identical counts."""
    n = 64
    p = jb.default_config(n, lam=5.0)
    u0 = jb.initial_guess(n, dtype=jnp.float64)
    kw = dict(algo="cg", tol_rel=1e-10, max_niter=30)
    _, ij = nk.newton_krylov_jit(jb.residual_scaled, u0, p,
                                 M=jp.chebyshev(degree=8, engine="xla"), **kw)
    ut, it = nkt.newton_krylov_jit(tb.residual_scaled, _t(u0), convert.params(p),
                                   M=tp.chebyshev(degree=8, engine="xla"), **kw)
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    f0 = float(torch.linalg.vector_norm(tb.residual_scaled(_t(u0), p)))
    assert float(torch.linalg.vector_norm(tb.residual_scaled(ut, p))) <= 1e-9 * f0


def test_newton_cheb_df32_refined():
    """The df32-refined driver with Chebyshev(8) in its f32 loop
    (tests/test_cheb.py:133): solved, the same outer count as JAX, and the
    f64 true residual ≤ 1e-7·‖F₀‖."""
    n = 64
    p = jb.default_config(n, lam=5.0)
    u0 = jb.initial_guess(n, dtype=jnp.float64)
    kw = dict(algo="cg", tol_rel=1e-8, max_niter=30)
    _, ij = nk.newton_krylov_jit(jb.residual_scaled, u0, p,
                                 M=jp.chebyshev(degree=8, engine="xla"),
                                 residual_df=jb.residual_scaled_df, **kw)
    ut, it = nkt.newton_krylov_jit(tb.residual_scaled, _t(u0), convert.params(p),
                                   M=tp.chebyshev(degree=8, engine="xla"),
                                   residual_df=tb.residual_scaled_df, **kw)
    assert bool(it.solved) and bool(ij.solved)
    assert ut.dtype == F64
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    f0 = float(torch.linalg.vector_norm(tb.residual_scaled(_t(u0), p)))
    assert float(torch.linalg.vector_norm(tb.residual_scaled(ut, p))) <= 1e-7 * f0
