"""The port's pseudo-transient continuation (Ψtc) against the JAX package.

Oracle: tests/test_continuation.py — arctan from outside Newton's basin,
the Newton regime (δ → ∞), 2-D Bratu near the fold and from the standard
start, the df32 path and ``krylov_dtype``.  The same numpy inputs go to both
packages, in float64 unless stated; f64 counts are equal, and the iterates
agree within the stated tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import df32 as jdd
from newtonkrylov_tpu.fftprec import fft_poisson as j_fft
from newtonkrylov_tpu.problems import bratu2d as jb
from newtonkrylov_tpu_torch import df32 as tdd
from newtonkrylov_tpu_torch.fftprec import fft_poisson as t_fft
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.utils import convert

F64, F32 = torch.float64, torch.float32


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _counts(info):
    return (int(info.stats.outer_iterations), int(info.stats.inner_iterations))


def atan_j(x, p=None):
    return jnp.arctan(x)


def atan_t(x, p=None):
    return torch.arctan(x)


def kelley_j(x, p=None):
    return jnp.array([x[0] ** 2 + x[1] ** 2 - 2.0,
                      jnp.exp(x[0] - 1.0) + x[1] ** 2 - 2.0])


def kelley_t(x, p=None):
    return torch.stack([x[0] ** 2 + x[1] ** 2 - 2.0,
                        torch.exp(x[0] - 1.0) + x[1] ** 2 - 2.0])


@pytest.mark.parametrize("x0, kw", [
    (3.0, {}),
    (100.0, {}),
    (3.0, {"krylov_dtype": "f32", "tol_rel": 1e-10}),
    (100.0, {"max_steps": 2}),
], ids=["from-3", "from-100", "krylov-f32", "max-steps-2"])
def test_ptc_atan_matches_jax(x0, kw):
    """arctan, where Newton from |x₀| > 1.39 diverges: the JAX package's
    counts, ``solved`` and history (relative 1e-12, the packages' arctan
    differ in the last bit), the root within 1e-12.  ``max_steps`` is
    inclusive: a budget of 2 runs 3 steps."""
    kj, kt = dict(kw), dict(kw)
    if kw.get("krylov_dtype"):
        kj["krylov_dtype"], kt["krylov_dtype"] = jnp.float32, F32
    uj, ij = nk.pseudo_transient(atan_j, jnp.asarray([x0]), **kj)
    ut, it = nkt.pseudo_transient(atan_t, _t([x0]), **kt)
    assert bool(it.solved) == bool(ij.solved)
    assert _counts(it) == _counts(ij)
    k = it.stats.outer_iterations
    np.testing.assert_allclose(it.history[:k + 1].numpy(),
                               np.asarray(ij.history)[:k + 1], rtol=1e-12)
    assert bool(torch.isnan(it.history[k + 1:]).all())
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-12)
    if "max_steps" in kw:
        assert k == 3 and not bool(it.solved)
    else:
        assert bool(it.solved) and abs(float(ut[0])) < 1e-5
        h = it.history[:k + 1].numpy()
        assert np.all(np.diff(h[-3:]) < 0)  # the Newton regime's tail


def test_ptc_newton_regime_matches_newton_and_jax():
    """δ₀ = δ_max = 1e14: the shift vanishes and Ψtc takes the Newton
    driver's steps (Kelley system, ``Fixed(1e-4)``), in both packages."""
    forcing_t, forcing_j = nkt.Fixed(1e-4), nk.Fixed(1e-4)
    u_n, i_n = nkt.newton_krylov_jit(kelley_t, _t([2.0, 0.5]), forcing=forcing_t)
    u_p, i_p = nkt.pseudo_transient(kelley_t, _t([2.0, 0.5]), delta0=1e14,
                                    delta_max=1e14, forcing=forcing_t)
    _, i_pj = nk.pseudo_transient(kelley_j, jnp.asarray([2.0, 0.5]), delta0=1e14,
                                  delta_max=1e14, forcing=forcing_j)
    assert bool(i_p.solved)
    assert _counts(i_p) == _counts(i_n) == _counts(i_pj)
    np.testing.assert_allclose(u_p.numpy(), u_n.numpy(), atol=1e-9)


def test_ptc_wrong_sign_stalls_like_jax():
    """Ψtc follows du/dτ = −F: with F = −arctan the root is unstable for
    that flow and the iteration leaves it, in both packages alike."""
    kw = dict(max_steps=20)
    _, ij = nk.pseudo_transient(lambda x, p: -jnp.arctan(x), jnp.asarray([0.5]), **kw)
    ut, it = nkt.pseudo_transient(lambda x, p: -torch.arctan(x), _t([0.5]), **kw)
    assert not bool(it.solved) and not bool(ij.solved)
    assert _counts(it) == _counts(ij)
    assert abs(float(ut[0])) > 0.5


def _bratu_pair(n, lam, rough):
    """(JAX u₀, port u₀, params): the rough start 2.5·sin(πx)sin(πy) or the
    standard sin bump, JAX's values handed to both."""
    p = jb.default_config(n, lam=lam)
    if rough:
        X, Y = jb.grid(n)
        u0 = np.asarray(2.5 * jnp.sin(jnp.pi * X) * jnp.sin(jnp.pi * Y))
    else:
        u0 = np.asarray(jb.initial_guess(n))
    return jnp.asarray(u0), _t(u0), p


@pytest.mark.parametrize("n", [32, 64])
def test_ptc_bratu2d_near_fold_matches_jax(n):
    """λ = 6.8 (fold ≈ 6.808) from the rough start: Ψtc on −F with the DST
    preconditioner probing the shifted operator, δ₀ = (n + 1)², beside
    Newton from the same start.  Both packages' counts are equal, method by
    method; Ψtc takes fewer outers than Newton wherever the JAX package's
    does; the two roots agree within 1e-8, and each with JAX's within 1e-9."""
    uj0, ut0, p = _bratu_pair(n, 6.8, rough=True)
    pt = convert.params(p)
    newton = dict(algo="gmres", tol_rel=1e-10, max_niter=50)
    ptc = dict(algo="gmres", tol_rel=1e-10, delta0=float((n + 1) ** 2), max_steps=60)
    un_j, in_j = nk.newton_krylov_jit(jb.residual_scaled, uj0, p, M=j_fft(), **newton)
    up_j, ip_j = nk.pseudo_transient(lambda u, q: -jb.residual_scaled(u, q), uj0, p,
                                     M=j_fft(), **ptc)
    un_t, in_t = nkt.newton_krylov_jit(tb.residual_scaled, ut0, pt, M=t_fft(), **newton)
    up_t, ip_t = nkt.pseudo_transient(lambda u, q: -tb.residual_scaled(u, q), ut0, pt,
                                      M=t_fft(), **ptc)
    print(f"n={n}: Newton JAX {_counts(in_j)} port {_counts(in_t)}; "
          f"Ψtc JAX {_counts(ip_j)} port {_counts(ip_t)}")
    assert bool(ip_t.solved) and bool(ip_j.solved)
    assert bool(in_t.solved) == bool(in_j.solved)
    assert _counts(ip_t) == _counts(ip_j)
    assert _counts(in_t) == _counts(in_j)
    ptc_fewer_j = int(ip_j.stats.outer_iterations) < int(in_j.stats.outer_iterations)
    ptc_fewer_t = ip_t.stats.outer_iterations < in_t.stats.outer_iterations
    assert ptc_fewer_t == ptc_fewer_j
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up_j), atol=1e-9)
    if bool(in_t.solved):
        np.testing.assert_allclose(up_t.numpy(), un_t.numpy(), atol=1e-8)


def test_ptc_bratu2d_standard_start_matches_jax():
    """λ = 6 from the sin bump: Ψtc costs about Newton (≤ 7 steps), with
    the JAX package's counts."""
    uj0, ut0, p = _bratu_pair(32, 6.0, rough=False)
    kw = dict(algo="gmres", tol_rel=1e-10, delta0=float(33 ** 2), max_steps=60)
    _, ij = nk.pseudo_transient(lambda u, q: -jb.residual_scaled(u, q), uj0, p,
                                M=j_fft(), **kw)
    _, it = nkt.pseudo_transient(lambda u, q: -tb.residual_scaled(u, q), ut0,
                                 convert.params(p), M=t_fft(), **kw)
    assert bool(it.solved) and it.stats.outer_iterations <= 7
    assert _counts(it) == _counts(ij)


def test_ptc_residual_df_matches_jax():
    """The df32 path (f32 Krylov, double-word acceptance residual of −F) at
    32², λ = 6, to 1e-8: solved with the JAX package's outer count (its f32
    inner counts may differ by the summation order, ROADMAP.md Queue 3 item
    2), f64 in and out, the root within 1e-7 of the f64 Ψtc solve."""
    uj0, ut0, p = _bratu_pair(32, 6.0, rough=False)
    pt = convert.params(p)
    kw = dict(algo="gmres", tol_rel=1e-8, delta0=float(33 ** 2), max_steps=60)

    def neg_df_j(u, q):
        r = jb.residual_scaled_df(u, q)
        return jdd.DF(-r.hi, -r.lo)

    def neg_df_t(u, q):
        r = tb.residual_scaled_df(u, q)
        return tdd.DF(-r.hi, -r.lo)

    _, ij = nk.pseudo_transient(lambda u, q: -jb.residual_scaled(u, q), uj0, p,
                                M=j_fft(precision="high"), residual_df=neg_df_j, **kw)
    u_ref, i_ref = nkt.pseudo_transient(lambda u, q: -tb.residual_scaled(u, q), ut0, pt,
                                        M=t_fft(), **kw)
    u_df, i_df = nkt.pseudo_transient(lambda u, q: -tb.residual_scaled(u, q), ut0, pt,
                                      M=t_fft(precision="high"),
                                      residual_df=neg_df_t, **kw)
    assert bool(i_ref.solved) and bool(i_df.solved) and bool(ij.solved)
    assert i_df.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert u_df.dtype == F64
    np.testing.assert_allclose(u_df.numpy(), u_ref.numpy(), atol=1e-7)
