"""The port's Newton drivers against the JAX package: ``newton_krylov``
(host-stepped), ``newton_krylov_jit``, Armijo backtracking,
``residual_dtype``, host-side factories and ``precond_refresh``.

Oracles: tests/test_newton.py (the Kelley starts, the callback trace,
forcing variants, ``max_niter``, blow-up, driver equivalence, Armijo) and
tests/test_jit_hygiene.py (ILU(0) refreshed once per outer, the
``precond_refresh`` modes).  The same numpy inputs go to both packages, in
float64 unless stated.  The port's two drivers share one Newton step, so
they must agree bit for bit; against the JAX package the counts are equal
and the iterates agree within the stated tolerance (the packages' ``exp``
and reductions differ in the last bit, ROADMAP.md Queue 3 items 1–2).
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
from newtonkrylov_tpu_torch.problems import bratu1d as tb
from newtonkrylov_tpu_torch.problems import simple as ts

F64, F32 = torch.float64, torch.float32


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def kelley_j(x, p=None):
    return jnp.array([x[0] ** 2 + x[1] ** 2 - 2.0,
                      jnp.exp(x[0] - 1.0) + x[1] ** 2 - 2.0])


def kelley_t(x, p=None):
    return torch.stack([x[0] ** 2 + x[1] ** 2 - 2.0,
                        torch.exp(x[0] - 1.0) + x[1] ** 2 - 2.0])


def atan_j(x, p=None):
    return jnp.arctan(x)


def atan_t(x, p=None):
    return torch.arctan(x)


def _counts(info):
    return (int(info.stats.outer_iterations), int(info.stats.inner_iterations))


def _same_bits(a, b):
    assert a.dtype == b.dtype
    assert torch.equal(a, b), float((a - b).abs().max())


# -- the host-stepped driver against the JAX package's ------------------------


@pytest.mark.parametrize("x0, kw", [
    ([2.0, 0.5], {}),
    ([3.0, 5.0], {}),
    ([3.0, 5.0], {"forcing": "fixed"}),
    ([2.0, 0.5], {"forcing": None}),
    ([3.0, 5.0], {"max_niter": 1}),
    ([3.0, 5.0], {"linesearch": "armijo"}),
], ids=["start1", "start2", "fixed", "exact-newton", "max-niter-1", "armijo"])
def test_newton_krylov_matches_jax(x0, kw):
    """``newton_krylov`` on the Kelley system (both documented starts,
    ``Fixed(0.1)`` from the second (from the first it wanders for ~50
    outers in both packages), exact Newton, ``max_niter=1``, Armijo): the JAX
    package's counts and ``solved``, the iterate within 1e-10 (an inexact
    Newton iterate carries the last-bit differences of ``exp`` amplified by
    the inner solves), and ``newton_krylov_jit``'s iterate bit for bit."""
    kj, kt = dict(kw), dict(kw)
    if kw.get("forcing") == "fixed":
        kj["forcing"], kt["forcing"] = nk.Fixed(0.1), nkt.Fixed(0.1)
    uj, ij = nk.newton_krylov(kelley_j, jnp.asarray(x0), **kj)
    ut, it = nkt.newton_krylov(kelley_t, _t(x0), **kt)
    assert bool(it.solved) == bool(ij.solved)
    assert _counts(it) == _counts(ij)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-10)
    assert isinstance(it.stats.n_res, float) and it.t > 0
    if kw.get("max_niter") == 1:
        assert it.stats.outer_iterations <= 2
    uj2, ij2 = nkt.newton_krylov_jit(kelley_t, _t(x0), **kt)
    _same_bits(ut, uj2)
    assert _counts(ij2) == _counts(it)
    assert float(ij2.stats.n_res) == it.stats.n_res


def test_callback_trace_matches_jax():
    """The callback fires at u₀ and after every residual evaluation: the
    same number of entries as the JAX package's, u₀ first, the norms
    within 1e-12 relative and the last below the tolerance."""
    tj, tt = [], []
    nk.newton_krylov(kelley_j, jnp.asarray([2.0, 0.5]),
                     callback=lambda u, r, n: tj.append((np.array(u), float(n))))
    nkt.newton_krylov(kelley_t, _t([2.0, 0.5]),
                      callback=lambda u, r, n: tt.append((u.numpy().copy(), n)))
    assert len(tt) == len(tj) >= 2
    np.testing.assert_array_equal(tt[0][0], [2.0, 0.5])
    np.testing.assert_allclose([n for _, n in tt], [n for _, n in tj], rtol=1e-12)
    np.testing.assert_allclose(np.stack([u for u, _ in tt]),
                               np.stack([u for u, _ in tj]), atol=1e-12)
    assert tt[-1][1] < 1e-5


def test_blowup_matches_jax(capsys):
    """log(x₀) goes NaN: both packages stop, report unsolved, and leave the
    blown step out of the counts."""
    def bad_j(x, p=None):
        return jnp.array([jnp.log(x[0]), x[1]])

    def bad_t(x, p=None):
        return torch.stack([torch.log(x[0]), x[1]])

    _, ij = nk.newton_krylov(bad_j, jnp.asarray([0.5, 1.0]), forcing=None)
    ut, it = nkt.newton_krylov(bad_t, _t([0.5, 1.0]), forcing=None)
    assert bool(it.solved) == bool(ij.solved)
    assert _counts(it) == _counts(ij)
    assert it.stats.outer_iterations <= 51


def test_armijo_backtracks_in_both_drivers_like_jax():
    """arctan from x₀ = 3, where the full Newton step overshoots (plain
    Newton diverges): Armijo backtracks and converges.  Both of the port's
    drivers give the JAX package's counts and root; they agree bit for
    bit with each other."""
    x0 = [3.0]
    _, plain = nkt.newton_krylov_jit(atan_t, _t(x0), max_niter=10)
    assert not bool(plain.solved)
    uj, ij = nk.newton_krylov_jit(atan_j, jnp.asarray(x0), linesearch="armijo")
    uh_j, ih_j = nk.newton_krylov(atan_j, jnp.asarray(x0), linesearch="armijo")
    ut, it = nkt.newton_krylov_jit(atan_t, _t(x0), linesearch="armijo")
    uh, ih = nkt.newton_krylov(atan_t, _t(x0), linesearch="armijo")
    assert bool(it.solved) and ih.solved and bool(ij.solved)
    assert _counts(it) == _counts(ih) == _counts(ij) == _counts(ih_j)
    _same_bits(ut, uh)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-12)
    assert abs(float(ut[0])) < 1e-6
    # the first step was cut back: its norm is below the full step's
    full = abs(np.arctan(3.0 - np.arctan(3.0) * (1.0 + 9.0)))
    assert float(it.history[1]) < full


def test_residual_dtype_f64_on_f32_state_matches_jax():
    """An f32 state with the outer residual evaluated in f64: both drivers
    hold the JAX package's counts, the f64 norm trace within 2e-6 absolute
    (about 16 ulp of the f32 state, |u| ≈ 1: the two packages' f32 ``exp``
    differ in the last bit), and each other's iterate bit for bit."""
    x0 = np.array([2.0, 0.5], dtype=np.float32)
    kw = dict(tol_rel=1e-6)
    _, ij = nk.newton_krylov_jit(kelley_j, jnp.asarray(x0),
                                 residual_dtype=jnp.float64, **kw)
    _, ih_j = nk.newton_krylov(kelley_j, jnp.asarray(x0),
                               residual_dtype=jnp.float64, **kw)
    ut, it = nkt.newton_krylov_jit(kelley_t, _t(x0, F32), residual_dtype=F64, **kw)
    uh, ih = nkt.newton_krylov(kelley_t, _t(x0, F32), residual_dtype=F64, **kw)
    assert ut.dtype == F32 and it.history.dtype == F64
    assert bool(it.solved) and ih.solved
    assert _counts(it) == _counts(ih) == _counts(ij) == _counts(ih_j)
    _same_bits(ut, uh)
    k = it.stats.outer_iterations
    np.testing.assert_allclose(it.history[:k + 1].numpy(),
                               np.asarray(ij.history)[:k + 1], rtol=0, atol=2e-6)


@pytest.mark.parametrize("case", ["df32", "krylov-f32", "f32-state"])
def test_host_and_jit_drivers_agree_bitwise(case):
    """The two drivers on the precision modes: the same iterate bit for
    bit, the same counts and final norm."""
    if case == "df32":
        args = (ts.residual, _t([2.0, 0.5]))
        kw = dict(krylov_dtype=F32, residual_df=ts.residual_df, tol_rel=1e-8)
    elif case == "krylov-f32":
        p = tb.default_config(64, lam=1.0)
        args = (tb.residual_scaled, tb.initial_guess(64, device="cpu"), p)
        kw = dict(algo="cg", krylov_dtype=F32, tol_rel=1e-8)
    else:
        args = (kelley_t, _t([3.0, 5.0], F32))
        kw = {}
    uh, ih = nkt.newton_krylov(*args, **kw)
    uj, ij = nkt.newton_krylov_jit(*args, **kw)
    assert ih.solved and bool(ij.solved)
    _same_bits(uh, uj)
    assert _counts(ih) == _counts(ij)
    assert ih.stats.n_res == float(ij.stats.n_res)
    assert ih.floor_limited == bool(ij.floor_limited)


def test_bratu1d_gmres_ilu0_counts_match_jax():
    """The gallery's "gmres + ILU0 (host C++)" recipe at N = 512: the JAX
    package's counts, one inner iteration an outer (a tridiagonal ILU(0) is
    the exact LU), the solution within 1e-10 of JAX's, and the jit
    driver's iterate bit for bit."""
    n = 512
    p = jb.default_config(n)
    u0 = np.asarray(jb.initial_guess(n))
    uj, ij = nk.newton_krylov(jb.residual, jnp.asarray(u0), p, algo="gmres",
                              N=jp.ilu0(bandwidth=1))
    ut, it = nkt.newton_krylov(tb.residual, _t(u0), p, algo="gmres",
                               N=tp.ilu0(bandwidth=1))
    assert it.solved and bool(ij.solved)
    assert _counts(it) == _counts(ij)
    assert it.stats.inner_iterations <= 2 * it.stats.outer_iterations
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-10)
    uj2, ij2 = nkt.newton_krylov_jit(tb.residual, _t(u0), p, algo="gmres",
                                     N=tp.ilu0(bandwidth=1))
    _same_bits(ut, uj2)
    assert _counts(ij2) == _counts(it)
    assert tp.HOST_COPIES == {"device_to_host": 0, "host_to_device": 0}


@pytest.mark.parametrize("refresh", ["outer", "once"])
@pytest.mark.parametrize("driver", ["host", "jit"])
def test_factory_invocations_per_refresh_mode(driver, refresh):
    """A host-side factory (ILU(0)) and a device one (Jacobi) are
    invoked once per outer iteration under ``"outer"`` and once in all
    under ``"once"``; either way the solve converges."""
    calls = {"host": 0, "device": 0}
    ilu, jac = tp.ilu0(bandwidth=1), tp.jacobi(1, 1)

    def host_factory(J):
        calls["host"] += 1
        return ilu(J)

    host_factory.host_side = True

    def device_factory(J):
        calls["device"] += 1
        return jac(J)

    n = 128  # λ = 2, well below the fold: a few cheap outers
    run = nkt.newton_krylov if driver == "host" else nkt.newton_krylov_jit
    u, info = run(tb.residual, tb.initial_guess(n, device="cpu"),
                  tb.default_config(n, lam=2.0), algo="fgmres", N=host_factory,
                  M=device_factory, precond_refresh=refresh, max_niter=30)
    assert bool(info.solved)
    outer = int(info.stats.outer_iterations)
    assert outer >= 2
    want = outer if refresh == "outer" else 1
    assert calls == {"host": want, "device": want}


def test_newton_options_match_jax():
    assert nkt.NewtonOptions()._asdict() == nk.newton.NewtonOptions()._asdict()


def test_verbose_prints_each_outer(capsys):
    _, info = nkt.newton_krylov(kelley_t, _t([2.0, 0.5]), verbose=1)
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[newton_krylov] outer=")]
    assert len(lines) == info.stats.outer_iterations


@pytest.mark.parametrize("driver", ["newton_krylov", "newton_krylov_jit"])
def test_drivers_reject_bad_options(driver):
    """The JAX package's errors: an unknown ``precond_refresh``, and
    ``residual_df`` with ``linesearch`` or ``residual_dtype``; also an
    unknown ``linesearch``."""
    run = getattr(nkt, driver)
    x0 = _t([2.0, 0.5])
    with pytest.raises(ValueError, match="precond_refresh"):
        run(ts.residual, x0, None, precond_refresh="never")
    with pytest.raises(ValueError, match="residual_df excludes"):
        run(ts.residual, x0, residual_df=ts.residual_df, linesearch="armijo")
    with pytest.raises(ValueError, match="residual_df excludes"):
        run(ts.residual, x0, residual_df=ts.residual_df, residual_dtype=F64)
    with pytest.raises(ValueError, match="linesearch"):
        run(ts.residual, x0, linesearch="wolfe")
