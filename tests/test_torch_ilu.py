"""The port's host-side factorizations and the card's tridiagonal solve.

* ILU(0): the host C++ library (``newtonkrylov_tpu_torch/csrc/ilu0.cpp``,
  built with the host compiler at first use) bit for bit equal to the
  port's NumPy version, which is the JAX package's; ``ilu0``'s three
  materializations against the JAX package's factory.
* ``banded_lu`` against the JAX package's on the BVP's Jacobian, whose
  boundary rows have zero diagonals.
* ``pcr_refined_solve``, the solve ``banded_direct`` takes on a CUDA state,
  called here on CPU tensors: ≤ 1e-9 relative residual on the
  non-dominant 1-D Bratu system at N = 10⁴, where PCR alone is not.

Oracles: tests/test_precond.py (ILU(0) at the reference's scale, banded LU
with a zero diagonal) and tests/test_problems.py (the BVP recipe).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import precond as jp
from newtonkrylov_tpu.problems import bratu1d as jb
from newtonkrylov_tpu.problems import bvp as jbvp
from newtonkrylov_tpu_torch import precond as tp
from newtonkrylov_tpu_torch.kernels import build
from newtonkrylov_tpu_torch.problems import bratu1d as tb
from newtonkrylov_tpu_torch.problems import bvp as tbvp
from newtonkrylov_tpu_torch.utils import native

F64, F32 = torch.float64, torch.float32


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _five_point_csr(m, seed):
    """A random nonsymmetric 5-point matrix on an m×m grid, diagonally
    weighted so that ILU(0) has no zero pivot."""
    rng = np.random.default_rng(seed)
    n = m * m
    A = np.zeros((n, n))
    for i in range(n):
        A[i, i] = 6.0 + rng.random()
        for j in (i - 1, i + 1, i - m, i + m):
            if 0 <= j < n and not (abs(j - i) == 1 and j // m != i // m):
                A[i, j] = rng.standard_normal()
    return tp._dense_to_csr(A)


@pytest.mark.parametrize("case", ["5-point", "bratu1d"])
def test_native_ilu0_equals_numpy_and_jax(case):
    """Factorization and solve of the C++ library equal the port's NumPy
    version bit for bit, and that one equals the JAX package's."""
    if case == "5-point":
        indptr, cols, vals = _five_point_csr(9, seed=3)
    else:
        n = 300
        J = nkt.JacobianOperator(tb.residual, tb.initial_guess(n, device="cpu"),
                                 tb.default_config(n))
        indptr, cols, vals = nkt.operator.materialize_csr(J, (-1, 0, 1))
    lib = native.load_ilu()
    vals_c, diag_c = lib.factorize(indptr, cols, vals)
    vals_n, diag_n = tp._ilu0_numpy(indptr, cols, vals)
    vals_j, diag_j = jp._ilu0_numpy(indptr, cols, vals)
    np.testing.assert_array_equal(vals_c, vals_n)
    np.testing.assert_array_equal(diag_c, diag_n)
    np.testing.assert_array_equal(vals_n, vals_j)
    b = np.random.default_rng(7).standard_normal(len(indptr) - 1)
    x_c = lib.solve(indptr, cols, vals_c, diag_c, b)
    x_n = tp._ilu0_solve_numpy(indptr, cols, vals_n, diag_n, b)
    np.testing.assert_array_equal(x_c, x_n)
    np.testing.assert_array_equal(x_n, jp._ilu0_solve_numpy(indptr, cols, vals_n,
                                                            diag_n, b))


def test_native_ilu0_reports_zero_pivot_and_bad_input():
    lib = native.load_ilu()
    indptr, cols, vals = tp._dense_to_csr(np.array([[0.0, 1.0], [1.0, 1.0]]))
    with pytest.raises(ZeroDivisionError, match="row"):
        lib.factorize(indptr, cols, vals)
    with pytest.raises(ValueError, match="malformed"):
        lib.factorize(indptr, cols + 5, vals)


def test_failed_host_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's message;
    nothing falls back."""
    (tmp_path / "broken.cpp").write_text("int f() { return undefined_name; }\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="undefined_name"):
        build.load("broken")


@pytest.mark.parametrize("how", ["offsets", "bandwidth", "dense"])
def test_ilu0_factory_matches_jax(how):
    """``ilu0`` by each materialization on the 1-D Bratu Jacobian (N = 64):
    the apply equals the JAX package's within 1e-12 relative (the two
    packages' probes differ in the last bit), keeps an f32 vector's dtype
    and inverts the tridiagonal Jacobian (exact LU) to 1e-10."""
    n = 64
    kw = {"offsets": {"offsets": (-1, 0, 1)}, "bandwidth": {"bandwidth": 1},
          "dense": {}}[how]
    u0 = np.asarray(jb.initial_guess(n))
    p = jb.default_config(n)
    Jj = nk.JacobianOperator(jb.residual_scaled, jnp.asarray(u0), p)
    Jt = nkt.JacobianOperator(tb.residual_scaled, _t(u0), p)
    app_t, app_j = tp.ilu0(**kw)(Jt), jp.ilu0(**kw)(Jj)
    r = np.cos(np.arange(n, dtype=np.float64))
    got = app_t(_t(r)).numpy()
    np.testing.assert_allclose(got, np.asarray(app_j(jnp.asarray(r))), rtol=1e-12)
    np.testing.assert_allclose(Jt.mv(_t(got)).numpy(), r, atol=1e-10)
    assert app_t(_t(r, F32)).dtype == F32
    assert tp.HOST_COPIES == {"device_to_host": 0, "host_to_device": 0}


def test_banded_lu_on_bvp_zero_diagonal_matches_jax():
    """Pivoted banded LU(2, 2) of the BVP Jacobian (zero diagonals on its
    boundary rows, where ILU(0) meets a zero pivot): the apply equals the
    JAX package's within 1e-12 relative and inverts J to 1e-10."""
    pj = jbvp.default_config(101)
    pt = tbvp.default_config(101, device="cpu")
    U0 = np.asarray(jbvp.initial_guess(pj))
    Jj = nk.JacobianOperator(jbvp.residual, jnp.asarray(U0), pj)
    Jt = nkt.JacobianOperator(tbvp.residual, _t(U0), pt)
    v = np.cos(np.arange(U0.size, dtype=np.float64))
    r = Jt.mv(_t(v))
    assert float(r[0]) == pytest.approx(v[1])  # row 0 depends on U[1] only
    got = tp.banded_lu(2, 2)(Jt)(r).numpy()
    want = np.asarray(jp.banded_lu(2, 2)(Jj)(jnp.asarray(r.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got, v, atol=1e-10)
    with pytest.raises(ZeroDivisionError):
        tp.ilu0(bandwidth=2)(Jt)


def test_pcr_refined_solve_reaches_thomas_accuracy():
    """The card's tridiagonal solve on CPU tensors: the 1-D Bratu Jacobian
    at u₀, N = 10⁴, f64 (min(|d| − |dl| − |du|) ≈ −9.6 over the interior:
    not diagonally dominant), a seeded right-hand side.  Relative residual
    ≤ 1e-9 for the refined solve (Thomas: ~1e-10), where PCR alone leaves
    ~1e-5."""
    n = 10_000
    J = nkt.JacobianOperator(tb.residual, tb.initial_guess(n, device="cpu"),
                             tb.default_config(n))
    _, (dl, d, du) = nkt.materialize_banded(J, 1, 1)
    assert float((d.abs() - dl.abs() - du.abs())[1:-1].min()) < -9.0
    b = _t(np.random.default_rng(0).standard_normal(n))

    def rel(x):
        return float(torch.linalg.vector_norm(tp._tridiag_mv(dl, d, du, x) - b)
                     / torch.linalg.vector_norm(b))

    r_pcr = rel(tp.pcr_solve(dl, d, du, b))
    r_ref = rel(tp.pcr_refined_solve(dl, d, du, b))
    r_thomas = rel(tp.thomas_solve(dl, d, du, b))
    print(f"N={n}: PCR {r_pcr:.2e}, PCR + 2 refinements {r_ref:.2e}, "
          f"Thomas {r_thomas:.2e}")
    assert r_ref <= 1e-9
    assert r_thomas <= 1e-9
