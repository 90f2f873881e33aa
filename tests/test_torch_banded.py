"""The port's banded and nested-Krylov preconditioners against the JAX
package's.

Oracles: tests/test_precond.py:129-152 (Jacobi, the exact banded solve)
and tests/test_problems.py:63-98 (FGMRES + nested GMRES, GMRES + banded
direct on 1-D Bratu).  On the CPU ``banded_direct`` takes the Thomas
algorithm, as the JAX package does off the TPU, so applies agree within
rtol 1e-12 and f64 solve counts are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import precond as jp
from newtonkrylov_tpu.problems import bratu1d as jb
from newtonkrylov_tpu_torch import precond as tp
from newtonkrylov_tpu_torch.operator import ShiftedOperator
from newtonkrylov_tpu_torch.problems import bratu1d as tb

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _tridiag_F(cat, zeros):
    def F(y, p):
        y_l = cat([zeros(1, y.dtype), y[:-1]])
        y_r = cat([y[1:], zeros(1, y.dtype)])
        return y_r - 2.5 * y + y_l + 0.1 * y * y
    return F


_FJ = _tridiag_F(jnp.concatenate, lambda k, dt: jnp.zeros(k, dt))
_FT = _tridiag_F(torch.cat, lambda k, dt: torch.zeros(k, dtype=dt))


def test_jacobi_matches_jax():
    """Diagonal scaling from three colored probes of a periodic
    diagonally dominant residual, equal to the JAX package's apply."""
    u = np.linspace(0.5, 1.5, 32)
    Jj = nk.JacobianOperator(lambda v, p: 4.0 * v + 0.1 * jnp.roll(v, 1) * v,
                             jnp.asarray(u), None)
    Jt = nkt.JacobianOperator(lambda v, p: 4.0 * v + 0.1 * torch.roll(v, 1) * v,
                              _t(u), None)
    x = np.random.default_rng(0).standard_normal(32)
    got = tp.jacobi(1, 1)(Jt)(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jp.jacobi(1, 1)(Jj)(jnp.asarray(x))),
                               rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), x / (4.0 + 0.1 * np.roll(u, 1)), rtol=1e-12)


@pytest.mark.parametrize("shift", [0.0, 0.75])
def test_banded_direct_is_exact_and_matches_jax(shift):
    """The tridiagonal solve inverts J (and the shifted J + 0.75 I, through
    ShiftedOperator's pass-throughs) and equals the JAX package's."""
    u = np.linspace(0.1, 0.9, 64)
    Jj = nk.JacobianOperator(_FJ, jnp.asarray(u), None)
    Jt = nkt.JacobianOperator(_FT, _t(u), None)
    if shift:
        Jj = nk.operator.ShiftedOperator(Jj, shift)
        Jt = ShiftedOperator(Jt, shift)
    v = np.sin(np.arange(64.0))
    app_t, app_j = tp.banded_direct()(Jt), jp.banded_direct()(Jj)
    np.testing.assert_allclose(app_t(Jt.mv(_t(v))).numpy(), v, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(app_t(_t(v)).numpy(), np.asarray(app_j(jnp.asarray(v))),
                               rtol=1e-12)


def test_banded_direct_takes_thomas_on_the_cpu(monkeypatch):
    """On a CPU state the solve is ``thomas_solve`` (the JAX package's
    engine); ``pcr_solve`` is the card's."""
    calls = []
    monkeypatch.setattr(tp, "pcr_solve", lambda *a, **k: calls.append(a))
    u = np.linspace(0.1, 0.9, 16)
    Jt = nkt.JacobianOperator(_FT, _t(u), None)
    out = tp.banded_direct()(Jt)(_t(u))
    assert calls == [] and out.shape == (16,)


def test_fgmres_nested_krylov_matches_jax():
    """FGMRES (full) preconditioned by a 5-step inner GMRES on 1-D Bratu at
    N = 256, λ = 3: the JAX package's counts and solution."""
    n = 256
    p = jb.default_config(n, lam=3.0)
    u0 = jb.initial_guess(n)
    kw = dict(algo="fgmres", krylov_kwargs={"restart": None, "itmax": 300})
    uj, ij = nk.newton_krylov_jit(jb.residual, u0, p, N=jp.nested_krylov(itmax=5), **kw)
    ut, it = nkt.newton_krylov_jit(tb.residual, _t(u0), tb.default_config(n, 3.0),
                                   N=tp.nested_krylov(itmax=5), **kw)
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations) <= 10
    assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-9)
