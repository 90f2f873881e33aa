"""The port's BiCGStab, CGLS and pipelined CG against the JAX package's.

Oracles: tests/test_solvers.py:75-198 and :396 (pipelined CG against
plain CG, its convergence at exactly ``itmax``, ``pipeline=True`` through
the Newton driver; BiCGStab on a general system; CGLS least squares) and
tests/test_robustness.py:48, 93, 103 (BiCGStab breakdown, inconsistent
least squares, a rectangular Jacobian through ``rmv``).  The same numpy
systems go to both packages; f64 iteration counts are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import solvers as js
from newtonkrylov_tpu.problems import bratu2d as jb
from newtonkrylov_tpu_torch import solvers as ts
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.utils import convert

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def random_system(n, seed=0, spd=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n) if spd else A + n * np.eye(n)
    x_true = rng.standard_normal(n)
    return A, A @ x_true, x_true


def _ops(A):
    Aj, At = jnp.asarray(A), _t(A)
    return (lambda v: Aj @ v), (lambda v: At @ v)


def _same(rt, rj, x_atol=1e-10):
    assert rt.niter == int(rj.niter)
    assert bool(rt.converged) == bool(rj.converged)
    assert bool(rt.breakdown) == bool(rj.breakdown)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=x_atol)


@pytest.mark.parametrize("precond", ["none", "left", "right", "both"])
def test_bicgstab_matches_jax(precond):
    """A general system (seed 10, n = 40) with Jacobi-scaled M and/or N:
    the same iteration count and solution as the JAX package, and the
    true solution."""
    A, b, x_true = random_system(40, seed=10)
    (Aj, At), d = _ops(A), 1.0 / np.diag(A)
    dj, dt = jnp.asarray(d), _t(d)
    kj, kt = {}, {}
    if precond in ("left", "both"):
        kj["M"], kt["M"] = (lambda r: dj * r), (lambda r: dt * r)
    if precond in ("right", "both"):
        kj["N"], kt["N"] = (lambda r: dj * r), (lambda r: dt * r)
    rt = ts.bicgstab(At, _t(b), rtol=1e-10, **kt)
    rj = js.bicgstab(Aj, jnp.asarray(b), rtol=1e-10, **kj)
    assert bool(rt.converged)
    _same(rt, rj)
    np.testing.assert_allclose(rt.x.numpy(), x_true, rtol=1e-5)


def test_bicgstab_breakdown_terminates():
    """⟨r̂, r⟩ = 0 at once on this antisymmetric system: a breakdown, a
    finite iterate, as the JAX package."""
    A = np.array([[0.0, 1.0], [-1.0, 0.0]])
    b = np.array([1.0, 0.0])
    (Aj, At) = _ops(A)
    rt = ts.bicgstab(At, _t(b), itmax=10)
    rj = js.bicgstab(Aj, jnp.asarray(b), itmax=10)
    assert np.isfinite(rt.x.numpy()).all() and bool(rt.breakdown)
    _same(rt, rj)


@pytest.mark.parametrize("case", ["consistent", "inconsistent"])
def test_cgls_matches_jax(case):
    """CGLS on a tall system: the exact solution of a consistent one
    (50 × 30, rtol 1e-12), the least-squares one of an inconsistent one
    (20 × 8, rtol 0, atol 1e-12, itmax 100); counts as the JAX package."""
    rng = np.random.default_rng(11 if case == "consistent" else 0)
    if case == "consistent":
        A = rng.standard_normal((50, 30))
        x_want = rng.standard_normal(30)
        b = A @ x_want
        kw = dict(rtol=1e-12)
    else:
        A = rng.standard_normal((20, 8))
        b = rng.standard_normal(20)
        x_want = np.linalg.lstsq(A, b, rcond=None)[0]
        kw = dict(itmax=100, rtol=0.0, atol=1e-12)
    Aj, At = jnp.asarray(A), _t(A)
    rt = ts.cgls(lambda v: At @ v, _t(b), At=lambda w: At.T @ w, **kw)
    rj = js.cgls(lambda v: Aj @ v, jnp.asarray(b), At=lambda w: Aj.T @ w, **kw)
    _same(rt, rj, x_atol=1e-9)
    np.testing.assert_allclose(rt.x.numpy(), x_want, rtol=1e-6, atol=1e-8)


def test_cgls_rectangular_jacobian_through_rmv():
    """Three residuals in two unknowns: CGLS on the JacobianOperator takes Aᵀ
    from ``rmv`` and solves the least-squares Newton step."""
    def F(u, p):
        return torch.stack([u[0] - 1.0, u[1] - 2.0, u[0] + u[1] - 3.0])

    J = nkt.JacobianOperator(F, torch.zeros(2, dtype=F64), None)
    assert J.shape == (3, 2)
    res = ts.cgls(J, J.res, rtol=1e-12)
    np.testing.assert_allclose((-res.x).numpy(), [1.0, 2.0], atol=1e-8)
    with pytest.raises(ValueError, match="At="):
        ts.cgls(lambda v: v, J.res)


@pytest.mark.parametrize("case", ["spd", "jacobi", "negative-definite"])
def test_cg_pipelined_matches_plain_and_jax(case):
    """Pipelined CG on the SPD system of seed 8 (n = 60), Jacobi
    preconditioned, and on its negative-definite mirror: the JAX package's
    pipelined count and iterate, and plain CG's solution."""
    A, b, x_true = random_system(60, seed=8, spd=True)
    sign = -1.0 if case == "negative-definite" else 1.0
    Aj, At = _ops(sign * A)
    d = 1.0 / np.diag(A)
    kj, kt = {}, {}
    if case == "jacobi":
        kj["M"] = lambda r, dj=jnp.asarray(d): dj * r
        kt["M"] = lambda r, dt=_t(d): dt * r
    rt = ts.cg(At, _t(sign * b), rtol=1e-12, pipeline=True, **kt)
    rj = js.cg(Aj, jnp.asarray(sign * b), rtol=1e-12, pipeline=True, **kj)
    rp = ts.cg(At, _t(sign * b), rtol=1e-12, **kt)
    assert bool(rt.converged)
    _same(rt, rj, x_atol=1e-9)
    assert abs(rt.niter - rp.niter) <= 2
    np.testing.assert_allclose(rt.x.numpy(), rp.x.numpy(), atol=1e-8)
    np.testing.assert_allclose(rt.x.numpy(), x_true, rtol=1e-7)


def test_cg_pipelined_itmax_edge_detection():
    """Convergence reached at exactly k = itmax is seen by the exact norm
    after the loop, and the returned residual is the true final one."""
    A, b, _ = random_system(60, seed=8, spd=True)
    _, At = _ops(A)
    k_star = ts.cg(At, _t(b), rtol=1e-12, pipeline=True).niter
    r_edge = ts.cg(At, _t(b), rtol=1e-12, pipeline=True, itmax=k_star)
    assert r_edge.niter == k_star and bool(r_edge.converged)
    true_res = float(np.linalg.norm(b - A @ r_edge.x.numpy()))
    assert abs(float(r_edge.residual) - true_res) <= 1e-9 * float(np.linalg.norm(b))
    short = ts.cg(At, _t(b), rtol=1e-12, pipeline=True, itmax=k_star - 1)
    assert short.niter == k_star - 1 and not bool(short.converged)


def test_cg_pipelined_in_newton_driver():
    """``krylov_kwargs={"pipeline": True}`` reaches CG through the driver: on
    2-D Bratu 32² the JAX package's pipelined counts, and plain CG's
    solution."""
    n = 32
    p = jb.default_config(n, lam=4.0)
    u0 = jb.initial_guess(n)
    kw = dict(algo="cg", krylov_kwargs={"pipeline": True})
    ut, it = nkt.newton_krylov_jit(tb.residual_scaled, _t(u0), convert.params(p), **kw)
    _, ij = nk.newton_krylov_jit(jb.residual_scaled, u0, p, **kw)
    up, ip = nkt.newton_krylov_jit(tb.residual_scaled, _t(u0), convert.params(p),
                                   algo="cg")
    assert bool(it.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    assert abs(it.stats.inner_iterations - ip.stats.inner_iterations) <= 3
    np.testing.assert_allclose(ut.numpy(), up.numpy(), atol=1e-9)
