"""The port's operator module against the JAX package's.

Oracle: tests/test_operator.py — the Kelley 2×2 operator's known column
and row, the adjoint, the shifted and adjoint operators, and the dense,
banded and CSR materializations of stencil Jacobians.  The same numpy
inputs go to both packages; f64 applies and materializations agree within
rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import operator as jo
from newtonkrylov_tpu.problems import bratu1d as jb1
from newtonkrylov_tpu.problems import bratu2d as jb2
from newtonkrylov_tpu.problems import simple as js
from newtonkrylov_tpu_torch import operator as to
from newtonkrylov_tpu_torch.problems import bratu1d as tb1
from newtonkrylov_tpu_torch.problems import bratu2d as tb2
from newtonkrylov_tpu_torch.problems import simple as ts
from newtonkrylov_tpu_torch.spectral import FnOperator

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, want, rtol=1e-12, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _kelley(x=(3.0, 5.0)):
    return (nk.JacobianOperator(js.residual, jnp.asarray(x), None),
            nkt.JacobianOperator(ts.residual, _t(x), None))


def _bratu1d(n=64, lam=3.51382):
    u0 = jb1.initial_guess(n)
    return (nk.JacobianOperator(jb1.residual, u0, jb1.default_config(n, lam)),
            nkt.JacobianOperator(tb1.residual, _t(u0), tb1.default_config(n, lam)))


def _bratu2d_flat(m=12, lam=1.5):
    u0 = np.asarray(jb2.initial_guess(m)).reshape(-1)

    def fj(u, p):
        return jb2.residual_scaled(u.reshape(m, m), p).reshape(-1)

    def ft(u, p):
        return tb2.residual_scaled(u.reshape(m, m), p).reshape(-1)

    return (nk.JacobianOperator(fj, jnp.asarray(u0), jb2.default_config(m, lam)),
            nkt.JacobianOperator(ft, _t(u0), tb2.default_config(m, lam)))


def test_shape_dtype_and_primal():
    Jj, Jt = _kelley()
    assert Jt.shape == Jj.shape == (2, 2)
    assert Jt.dtype == F64
    _close(Jt.res, Jj.res)


@pytest.mark.parametrize("apply,known", [("mv", [6.0, 7.38905609893065]),
                                         ("rmv", [6.0, 10.0])])
def test_known_column_and_row(apply, known):
    """J·e₁ = [6, e²] and Jᵀ·e₁ = [6, 10] at (3, 5) (the reference's own
    oracle values), equal to the JAX package's."""
    Jj, Jt = _kelley()
    got = getattr(Jt, apply)(_t([1.0, 0.0]))
    _close(got, known, rtol=1e-14)
    _close(got, getattr(Jj, apply)(jnp.asarray([1.0, 0.0])))


@pytest.mark.parametrize("op", ["J", "J.T", "shifted", "shifted.T"])
def test_materialize_dense_matches_jax(op):
    """Dense materializations of J, Jᵀ, 0.3·I + J and its adjoint."""
    Jj, Jt = _bratu1d(n=24)
    pick = {
        "J": lambda J, m: J,
        "J.T": lambda J, m: J.T,
        "shifted": lambda J, m: m.ShiftedOperator(J, 0.3),
        "shifted.T": lambda J, m: m.ShiftedOperator(J, 0.3).T,
    }[op]
    got = to.materialize_dense(pick(Jt, to))
    want = jo.materialize_dense(pick(Jj, jo))
    assert got.shape == want.shape == (24, 24)
    _close(got, want, atol=1e-12 * float(np.abs(np.asarray(want)).max()))


def test_products_and_batches_match_jax():
    """mv, rmv, mm and rmm on seeded random vectors; Jᵀ materialized is the
    transpose of J materialized."""
    Jj, Jt = _bratu1d(n=32)
    rng = np.random.default_rng(0)
    v, W = rng.standard_normal(32), rng.standard_normal((3, 32))
    for name, arg in (("mv", v), ("rmv", v), ("mm", W), ("rmm", W)):
        want = getattr(Jj, name)(jnp.asarray(arg))
        _close(getattr(Jt, name)(_t(arg)), want,
               atol=1e-12 * float(np.abs(np.asarray(want)).max()))
    _close(to.materialize_dense(Jt.T), to.materialize_dense(Jt).T.numpy())
    _close(Jt.T.T.mv(_t(v)), Jt.mv(_t(v)).numpy())


def test_shifted_operator_pass_throughs():
    """ShiftedOperator exposes the operand's u/res/F/p (factories probe
    through it), falls back to ``example_in``, and says so when the operand
    has neither."""
    _, Jt = _bratu1d(n=16)
    S = to.ShiftedOperator(Jt, 0.25)
    assert S.u is Jt.u and S.res is Jt.res and S.F is Jt.F and S.p is Jt.p
    assert S.example_in is Jt.u and S.shape == Jt.shape and S.dtype == F64
    v = _t(np.random.default_rng(1).standard_normal(16))
    _close(S.mv(v), (Jt.mv(v) + 0.25 * v).numpy())
    alpha = torch.tensor(0.25, dtype=F64)
    _close(to.ShiftedOperator(Jt, alpha).rmv(v), S.rmv(v).numpy(), rtol=0)
    fn = FnOperator(lambda x: 2.0 * x, torch.zeros(4, dtype=F64))
    Sf = to.ShiftedOperator(fn, 1.0)
    assert Sf.u is fn.example_in and Sf.res is None and Sf.p is None
    _close(to.materialize_dense(Sf), 3.0 * np.eye(4))
    with pytest.raises(AttributeError, match="example_in"):
        _ = to.ShiftedOperator(lambda x: x, 1.0).u


@pytest.mark.parametrize("lower,upper", [(1, 1), (2, 2)])
def test_materialize_banded_matches_jax(lower, upper):
    """Colored probing of the 1-D Bratu Jacobian: DIA diagonals equal to the
    JAX package's and to the dense matrix's (wider bands come out zero)."""
    n = 64
    Jj, Jt = _bratu1d(n)
    offs_t, diags_t = to.materialize_banded(Jt, lower, upper)
    offs_j, diags_j = jo.materialize_banded(Jj, lower, upper)
    assert offs_t.tolist() == np.asarray(offs_j).tolist()
    _close(diags_t, diags_j)
    dense = to.materialize_dense(Jt).numpy()
    for off, diag in zip(offs_t.tolist(), diags_t.numpy()):
        want = np.diagonal(dense, off)
        got = diag[-off:] if off < 0 else diag[:n - off]
        _close(got, want)


@pytest.mark.parametrize("offsets", [(-1, 0, 1), tuple(range(-2, 3)),
                                     (-100, -1, 0, 1, 100), (-64, -1, 0, 1, 64)])
def test_stencil_coloring_matches_jax(offsets):
    c = to.stencil_coloring(offsets)
    assert c == jo.stencil_coloring(offsets)
    assert len({o % c for o in offsets}) == len(offsets)


@pytest.mark.parametrize("case", ["tridiagonal", "5-point"])
def test_materialize_csr_matches_jax(case):
    """CSR of the 1-D Bratu (offsets −1, 0, 1) and flattened 2-D Bratu
    (−m, −1, 0, 1, m) Jacobians: the same pattern as the JAX package's, the
    same values, and the dense matrix rebuilt from it."""
    if case == "tridiagonal":
        (Jj, Jt), offsets = _bratu1d(64, lam=2.0), (-1, 0, 1)
    else:
        m = 12
        (Jj, Jt), offsets = _bratu2d_flat(m), (-m, -1, 0, 1, m)
    indptr, cols, vals = to.materialize_csr(Jt, offsets)
    indptr_j, cols_j, vals_j = jo.materialize_csr(Jj, offsets)
    np.testing.assert_array_equal(indptr, indptr_j)
    np.testing.assert_array_equal(cols, cols_j)
    _close(vals, vals_j)
    dense = to.materialize_dense(Jt).numpy()
    rebuilt = np.zeros_like(dense)
    for i in range(dense.shape[0]):
        rebuilt[i, cols[indptr[i]:indptr[i + 1]]] = vals[indptr[i]:indptr[i + 1]]
    np.testing.assert_allclose(rebuilt, dense, atol=1e-12)


def test_aligned_residual_has_no_adjoint():
    """The aligned residual's JVP is the K1 kernel, which has no transpose
    (the JAX package's ``rmv`` fails on it too): ``rmv`` says so."""
    u0, p, _ = tb2.aligned_setup(8, lam=4.0, dtype=F64, device="cpu")
    J = nkt.JacobianOperator(tb2.residual_scaled_aligned, u0, p)
    J.mv(u0)  # the forward direction works
    with pytest.raises(NotImplementedError, match="no adjoint"):
        J.rmv(u0)
