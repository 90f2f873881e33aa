"""The port's spectral diagnostics and Lanczos-bounded Chebyshev against the
JAX package's.

Oracles: tests/test_spectral.py (Lanczos and Arnoldi exact at k = n,
bracketing at k < n, breakdown, κ₂ of a Bratu Jacobian) and
tests/test_cheb.py:151 (Lanczos bounds cut Cheb(16)-PCG inners at 64²).
The same numpy inputs go to both packages; f64 Ritz values agree within
rtol 1e-12 and solve counts are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import precond as jp
from newtonkrylov_tpu import spectral as jsp
from newtonkrylov_tpu.problems import bratu2d as jb
from newtonkrylov_tpu.problems import convdiff2d as jc
from newtonkrylov_tpu.spaces import MaskedSpace as JMaskedSpace
from newtonkrylov_tpu_torch import precond as tp
from newtonkrylov_tpu_torch import spectral as tsp
from newtonkrylov_tpu_torch.operator import materialize_dense
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.problems import convdiff2d as tc
from newtonkrylov_tpu_torch.utils import convert

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, want, rtol=1e-12, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _matrix_ops(M):
    """(JAX, port) FnOperators applying the matrix M, with its adjoint."""
    Mj, Mt = jnp.asarray(M), _t(M)
    n = M.shape[1]
    return (jsp.FnOperator(lambda v: Mj @ v, jnp.zeros(n), rfn=lambda w: Mj.T @ w),
            tsp.FnOperator(lambda v: Mt @ v, torch.zeros(n, dtype=F64),
                           rfn=lambda w: Mt.T @ w))


def _sym_matrix(n, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    evals = np.linspace(0.5, 9.5, n)
    return Q @ np.diag(evals) @ Q.T, evals


def _bratu(n, lam=4.0):
    u0 = jb.initial_guess(n)
    return (nk.JacobianOperator(jb.residual_scaled, u0, jb.default_config(n, lam)),
            nkt.JacobianOperator(tb.residual_scaled, _t(u0), tb.default_config(n, lam)))


def test_lanczos_exact_at_k_equals_n():
    """k = n: T's eigenvalues are the spectrum, the basis is orthonormal,
    m = n; α, β and T's eigenvalues equal the JAX package's."""
    n = 24
    M, evals = _sym_matrix(n)
    Aj, At = _matrix_ops(M)
    v0 = np.random.default_rng(1).standard_normal(n)
    a_t, b_t, V_t, m_t = tsp.lanczos_tridiag(At, _t(v0), n)
    a_j, b_j, _, m_j = jsp.lanczos_tridiag(Aj, jnp.asarray(v0), n)
    assert int(m_t) == int(m_j) == n and m_t.dtype == torch.int32
    _close(a_t, a_j, rtol=1e-10, atol=1e-12)
    _close(b_t[:-1], b_j[:-1], rtol=1e-10, atol=1e-12)
    T = np.diag(a_t.numpy()) + np.diag(b_t[:-1].numpy(), 1) + np.diag(b_t[:-1].numpy(), -1)
    _close(np.sort(np.linalg.eigvalsh(T)), evals, rtol=1e-12)
    np.testing.assert_allclose(V_t.numpy() @ V_t.numpy().T, np.eye(n), atol=1e-10)


def test_extreme_eigs_bracket_like_jax():
    """The 1-D Laplacian at n = 200, k = 40 from the default start: the
    Ritz interval brackets inside the spectrum, equal to the JAX
    package's."""
    n = 200

    def lap(v, cat, zeros):
        return 2.0 * v - cat([v[1:], zeros(1)]) - cat([zeros(1), v[:-1]])

    Aj = jsp.FnOperator(lambda v: lap(v, jnp.concatenate, jnp.zeros), jnp.zeros(n))
    At = tsp.FnOperator(
        lambda v: lap(v, torch.cat, lambda k: torch.zeros(k, dtype=F64)),
        torch.zeros(n, dtype=F64))
    lo_t, hi_t = tsp.extreme_eigs(At, k=40)
    lo_j, hi_j = jsp.extreme_eigs(Aj, k=40)
    h = 1.0 / (n + 1)
    lam_min, lam_max = 4 * np.sin(np.pi * h / 2) ** 2, 4 * np.sin(np.pi * n * h / 2) ** 2
    assert lam_min - 1e-12 <= float(lo_t) < 100 * lam_min
    assert 0.998 < float(hi_t) / lam_max <= 1 + 1e-12
    _close(lo_t, lo_j, rtol=1e-9)
    _close(hi_t, hi_j)


def test_lanczos_breakdown_on_identity():
    """An invariant subspace after one step: m = 1, the padding rows stay
    out of the extremes."""
    n = 16
    v0 = np.random.default_rng(2).standard_normal(n)
    At = tsp.FnOperator(lambda v: v, torch.zeros(n, dtype=F64))
    Aj = jsp.FnOperator(lambda v: v, jnp.zeros(n))
    _, beta, V, m = tsp.lanczos_tridiag(At, _t(v0), 8)
    assert int(m) == int(jsp.lanczos_tridiag(Aj, jnp.asarray(v0), 8)[3]) == 1
    assert float(beta.abs().max()) == 0.0 and float(V[1:].abs().max()) == 0.0
    lo, hi = tsp.extreme_eigs(At, _t(v0), k=8)
    _close(torch.stack([lo, hi]), [1.0, 1.0])


def test_arnoldi_full_spectrum_nonsymmetric():
    """k = n Arnoldi on a random matrix: the Ritz values are its
    eigenvalues, H equals the JAX package's, and A V_kᵀ = Vᵀ H."""
    n = 20
    rng = np.random.default_rng(3)
    M = rng.standard_normal((n, n))
    v0 = rng.standard_normal(n)
    Aj, At = _matrix_ops(M)
    H, V = tsp.arnoldi_hessenberg(At, _t(v0), n)
    Hj, _ = jsp.arnoldi_hessenberg(Aj, jnp.asarray(v0), n)
    assert H.shape == (n + 1, n) and V.shape == (n + 1, n)
    _close(H, Hj, rtol=1e-9, atol=1e-11)
    ritz = np.sort_complex(tsp.ritz_values(H))
    np.testing.assert_allclose(ritz, np.sort_complex(np.linalg.eigvals(M)),
                               rtol=1e-8, atol=1e-8)
    Vn = V.numpy()
    np.testing.assert_allclose(M @ Vn[:n].T, Vn.T @ H.numpy(), atol=1e-9)


@pytest.mark.parametrize("n", [8, 12])
def test_cond2_and_extremes_of_bratu_jacobian(n):
    """κ₂ (Lanczos on JᵀJ through ``rmv``) and the extreme eigenvalues of the
    2-D Bratu Jacobian at k = n²: exact against numpy on the dense matrix,
    equal to the JAX package's."""
    Jj, Jt = _bratu(n)
    dense = materialize_dense(Jt).numpy()
    kappa = tsp.cond2_estimate(Jt, k=n * n)
    _close(kappa, np.linalg.cond(dense), rtol=1e-8)
    _close(kappa, jsp.cond2_estimate(Jj, k=n * n), rtol=1e-10)
    lo, hi = tsp.extreme_eigs(Jt, k=n * n)
    ev = np.linalg.eigvalsh(dense)
    _close(torch.stack([lo, hi]), [ev[0], ev[-1]], rtol=1e-10)
    lo_j, hi_j = jsp.extreme_eigs(Jj, k=n * n)
    _close(torch.stack([lo, hi]), [lo_j, hi_j], rtol=1e-12)


def test_ritz_values_of_convdiff_jacobian():
    """Arnoldi at k = n² on the c = 25 convection–diffusion Jacobian at its
    root (16²): the Ritz values are numpy's eigenvalues."""
    n = 16
    p = tc.default_config(n, c=25.0, dtype=F64, device="cpu")
    u = tc.manufactured_solution(n, F64, "cpu")
    J = nkt.JacobianOperator(tc.residual_scaled, u, p)
    H, _ = tsp.arnoldi_hessenberg(J, torch.ones_like(u), n * n)
    ritz = np.sort_complex(tsp.ritz_values(H))
    exact = np.sort_complex(np.linalg.eigvals(materialize_dense(J).numpy()))
    np.testing.assert_allclose(ritz, exact, rtol=1e-8, atol=1e-8 * np.abs(exact).max())
    pj = jc.default_config(n, c=25.0)
    Jj = nk.JacobianOperator(jc.residual_scaled, jc.manufactured_solution(n), pj)
    Hj, _ = jsp.arnoldi_hessenberg(Jj, jnp.ones((n, n)), 24)
    H24, _ = tsp.arnoldi_hessenberg(J, torch.ones_like(u), 24)
    _close(H24, Hj, rtol=1e-9, atol=1e-12)


def test_lanczos_on_masked_aligned_layout():
    """Lanczos through ``MaskedSpace`` on the aligned layout (K1's plain
    version on the CPU) against the JAX package's masked Lanczos on its
    aligned residual: the same extremes, ghosts never enter."""
    n = 16
    u0j, pj, sj = jb.aligned_setup(n, lam=4.0, dtype=jnp.float64)
    u0t, pt, st = tb.aligned_setup(n, lam=4.0, dtype=F64, device="cpu")
    Jj = nk.JacobianOperator(lambda u, pp: jb.residual_scaled_aligned(u, pp), u0j, pj)
    Jt = nkt.JacobianOperator(tb.residual_scaled_aligned, _t(u0j), pt)
    v0 = np.asarray(sj.mask) * np.cos(np.arange(u0j.size)).reshape(u0j.shape)
    lo_t, hi_t = tsp.extreme_eigs(Jt, _t(v0), k=32, space=st)
    lo_j, hi_j = jsp.extreme_eigs(Jj, jnp.asarray(v0), k=32,
                                  space=JMaskedSpace(sj.mask))
    _close(torch.stack([lo_t, hi_t]), [lo_j, hi_j], rtol=1e-12)
    assert float(hi_t) < 0  # the scaled Bratu Jacobian is negative definite


def test_cheb_lanczos_bounds_match_jax():
    """``_resolve_cheb_bounds(J, "lanczos", 48)`` at 16²: the widened
    interval equal to the JAX package's, on one side of zero."""
    Jj, Jt = _bratu(16)
    lo_t, hi_t = tp._resolve_cheb_bounds(Jt, "lanczos", 48)
    lo_j, hi_j = jp._resolve_cheb_bounds(Jj, "lanczos", 48)
    _close(torch.stack([lo_t, hi_t]), [lo_j, hi_j], rtol=1e-12)
    assert float(lo_t) < float(hi_t) < 0
    assert tp._resolve_cheb_bounds(Jt, (1.0, 2.0), 48) == (1.0, 2.0)
    with pytest.raises(ValueError, match="bounds"):
        tp._resolve_cheb_bounds(Jt, "gershgorin", 48)


def test_cheb_lanczos_bounds_cut_iterations():
    """Cheb(16)-PCG on 2-D Bratu 64², λ = 5, tol_rel 1e-8: Lanczos bounds take
    fewer inners than the probed-Gershgorin default, and both packages'
    f64 counts are equal (the JAX package measured 28 → 20)."""
    n = 64
    p = jb.default_config(n, lam=5.0)
    u0 = jb.initial_guess(n)
    counts = {}
    for bounds in (None, "lanczos"):
        kw = dict(algo="cg", tol_rel=1e-8)
        _, ij = nk.newton_krylov_jit(jb.residual_scaled, u0, p, **kw,
                                     M=jp.chebyshev(16, bounds=bounds, engine="xla"))
        _, it = nkt.newton_krylov_jit(tb.residual_scaled, _t(u0), convert.params(p),
                                      **kw, M=tp.chebyshev(16, bounds=bounds,
                                                           engine="xla"))
        assert bool(it.solved) and bool(ij.solved)
        assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
        assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
        counts[bounds] = it.stats.inner_iterations
    assert counts["lanczos"] < counts[None]
