"""The port's 2-D Bratu main path as a whole, against the JAX package.

Two configurations of the same solve (newton_krylov_jit + CG):

* the aligned kernel configuration (``residual_scaled_aligned`` with
  ``MaskedSpace``; K1 for every matvec, K2 for every residual), as in
  tests/test_kernels.py:106-136;
* the flagship of ``__graft_entry__.entry`` (f32 Krylov, df32 acceptance
  residual, DST-Poisson preconditioner built once at u₀).

Inputs are the JAX package's own initial guesses handed over as numpy, so
both drivers start from the same bits.  In float64 the iteration counts must
be identical.  Iteration counts that differ in float32 are recorded in
ROADMAP.md Queue 3, not asserted.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu.fftprec import fft_poisson as j_fft_poisson
from newtonkrylov_tpu.problems import bratu2d as jb
from newtonkrylov_tpu_torch.fftprec import fft_poisson as t_fft_poisson
from newtonkrylov_tpu_torch.kernels import stencil2d as tk
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.utils import convert

F64, F32 = torch.float64, torch.float32


def _t(a, dtype=None):
    return convert.state(np.asarray(a), device="cpu", dtype=dtype)


def _assert_history(h_t, h_j):
    """History entry-wise to rtol 1e-8, with an absolute floor of 1e-8·‖F₀‖:
    the last entries are ‖F‖ values ~1e-7·‖F₀‖ and below, evaluated at
    iterates that agree to ~1e-13, so their relative agreement is limited
    (ROADMAP.md Queue 3).  The NaN padding must coincide."""
    h_t, h_j = h_t.numpy(), np.asarray(h_j)
    assert h_t.shape == h_j.shape
    np.testing.assert_array_equal(np.isnan(h_t), np.isnan(h_j))
    np.testing.assert_allclose(h_t, h_j, rtol=1e-8, atol=1e-8 * h_j[0])


def test_aligned_solve_f64_matches_jax():
    """(a) The aligned kernel configuration in f64 at n = 32: identical outer
    and inner counts, solution atol 1e-9."""
    n = 32
    u0j, pj, sj = jb.aligned_setup(n, lam=4.0, dtype=jnp.float64)
    uj, ij = nk.newton_krylov_jit(
        lambda u, pp: jb.residual_scaled_aligned(u, pp), u0j, pj, algo="cg", space=sj)
    u0t, pt, st = tb.aligned_setup(n, lam=4.0, dtype=F64, device="cpu")
    np.testing.assert_allclose(u0t.numpy(), np.asarray(u0j), rtol=0, atol=1e-15)
    ut, it = nkt.newton_krylov_jit(tb.residual_scaled_aligned, _t(u0j), pt,
                                   algo="cg", space=st)
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-9)
    _assert_history(it.history, ij.history)
    # the ghost-carrying layout survives the whole solve
    assert float(ut[n:].abs().max()) == 0.0
    assert float(ut[:, 0].abs().max()) == float(ut[:, n + 1:].abs().max()) == 0.0


def test_aligned_solve_matches_plain_layout():
    """The aligned configuration and the plain-layout residual converge to
    the same solution (tests/test_kernels.py:106 within the port)."""
    n = 32
    u0a, pa, sa = tb.aligned_setup(n, lam=4.0, dtype=F64, device="cpu")
    ua, ia = nkt.newton_krylov_jit(tb.residual_scaled_aligned, u0a, pa, algo="cg", space=sa)
    us, is_ = nkt.newton_krylov_jit(tb.residual_scaled,
                                    tb.initial_guess(n, F64, device="cpu"),
                                    tb.default_config(n, 4.0), algo="cg")
    assert bool(ia.solved) and bool(is_.solved)
    np.testing.assert_allclose(tk.aligned_interior(ua, n).numpy(), us.numpy(),
                               rtol=0, atol=1e-9)


def test_aligned_mixed_precision_refinement():
    """(b) f64 state + f32 Krylov at n = 64, tol_rel 1e-10: solved, ‖F‖ far
    below the f32 floor."""
    n = 64
    u0j, pj, sj = jb.aligned_setup(n, lam=5.0, dtype=jnp.float64)
    u0t, pt, st = tb.aligned_setup(n, lam=5.0, dtype=F64, device="cpu")
    ut, it = nkt.newton_krylov_jit(tb.residual_scaled_aligned, _t(u0j), pt, algo="cg",
                                   tol_rel=1e-10, space=st, krylov_dtype=F32)
    assert bool(it.solved)
    assert float(it.stats.n_res) < 1e-11
    assert it.stats.outer_iterations <= 15
    assert ut.dtype == F64
    _, ij = nk.newton_krylov_jit(lambda u, pp: jb.residual_scaled_aligned(u, pp), u0j, pj,
                                 algo="cg", tol_rel=1e-10, space=sj,
                                 krylov_dtype=jnp.float32)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)


def _flagship(n, u0, nkmod, bratu, fft_poisson, krylov_dtype, residual_df):
    p = bratu.default_config(n, lam=5.0)
    kw = dict(algo="cg", tol_rel=1e-8, max_niter=20,
              M=fft_poisson(precision="high"), precond_refresh="once")
    if residual_df:
        kw.update(krylov_dtype=krylov_dtype, residual_df=bratu.residual_scaled_df)
    return nkmod.newton_krylov_jit(bratu.residual_scaled, u0, p, **kw), p


@pytest.mark.parametrize("u0_dtype", [F64, F32], ids=["f64-boundary", "f32-in"])
def test_flagship_entry_configuration(u0_dtype):
    """(c) entry()'s configuration at n = 64.  entry()'s f32 u₀ handed over as
    its exact f64 value returns the full df32 state (hi + lo) in f64, whose
    f64 true residual must meet 1e-8·‖F₀‖; handed over as f32 (entry()
    itself) the solve returns the hi word."""
    n = 64
    u0_32 = _t(jb.initial_guess(n, dtype=jnp.float32))
    (u, info), p = _flagship(n, u0_32.to(u0_dtype), nkt, tb, t_fft_poisson, F32, True)
    assert bool(info.solved) and not bool(info.floor_limited)
    assert u.dtype == u0_dtype
    f0 = float(torch.linalg.vector_norm(tb.residual_scaled(u0_32.to(F64), p)))
    if u0_dtype == F64:
        fu = float(torch.linalg.vector_norm(tb.residual_scaled(u, p)))
        assert fu <= 1e-8 * f0 + 1e-12
    else:
        (u64, _), _ = _flagship(n, u0_32.to(F64), nkt, tb, t_fft_poisson, F32, True)
        np.testing.assert_array_equal(u.numpy(), u64.to(F32).numpy())
    assert info.history.shape == (22,)
    assert int(torch.isfinite(info.history).sum()) == info.stats.outer_iterations + 1


@pytest.mark.parametrize("refresh", ["once", "outer"])
def test_flagship_f64_counts_match_jax(refresh):
    """(d) The flagship with f64 Krylov and no df32: counts identical."""
    n = 64
    p = jb.default_config(n, lam=5.0)
    u0 = jb.initial_guess(n)
    kw = dict(algo="cg", tol_rel=1e-8, max_niter=20, precond_refresh=refresh)
    uj, ij = nk.newton_krylov_jit(jb.residual_scaled, u0, p,
                                  M=j_fft_poisson(precision="high"), **kw)
    ut, it = nkt.newton_krylov_jit(tb.residual_scaled, _t(u0), convert.params(p),
                                   M=t_fft_poisson(precision="high"), **kw)
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-12)
    _assert_history(it.history, ij.history)


@pytest.mark.parametrize("forcing", ["fixed", "exact"])
def test_forcing_variants_match_jax(forcing):
    n = 32
    p = jb.default_config(n, lam=5.0)
    u0 = jb.initial_guess(n)
    fj = nk.Fixed(0.05) if forcing == "fixed" else None
    ft = nkt.Fixed(0.05) if forcing == "fixed" else None
    _, ij = nk.newton_krylov_jit(jb.residual_scaled, u0, p, algo="cg", forcing=fj)
    _, it = nkt.newton_krylov_jit(tb.residual_scaled, _t(u0), convert.params(p),
                                  algo="cg", forcing=ft)
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert it.stats.inner_iterations == int(ij.stats.inner_iterations)


def test_blowup_aborts_like_jax():
    """‖F‖ → inf after the first step: both drivers stop, unsolved."""
    def Fj(u, p):
        return jnp.exp(50.0 * u) - 1.0

    def Ft(u, p):
        return torch.exp(50.0 * u) - 1.0

    _, ij = nk.newton_krylov_jit(Fj, jnp.asarray([-1.0]), algo="cg")
    _, it = nkt.newton_krylov_jit(Ft, torch.tensor([-1.0], dtype=F64), algo="cg")
    assert not bool(it.solved) and not bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations) == 1
    assert not bool(torch.isfinite(it.stats.n_res))


def test_driver_rejects_unported_and_bad_options():
    u0 = torch.zeros((8, 8), dtype=F64)
    p = tb.default_config(8, 1.0)
    with pytest.raises(ValueError, match="precond_refresh"):
        nkt.newton_krylov_jit(tb.residual_scaled, u0, p, algo="cg", precond_refresh="x")
    with pytest.raises(ValueError, match="residual_df excludes"):
        nkt.newton_krylov_jit(tb.residual_scaled, u0, p, algo="cg", linesearch="armijo",
                              residual_df=tb.residual_scaled_df)
    with pytest.raises(ValueError, match="unknown algo"):
        nkt.newton_krylov_jit(tb.residual_scaled, u0, p, algo="qmr")
    with pytest.raises(TypeError, match="forcing"):
        nkt.newton_krylov_jit(tb.residual_scaled, u0, p, algo="cg", forcing=0.1)


def test_port_imports_without_jax():
    """The port imports none of JAX: every module loads with ``jax`` blocked."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import newtonkrylov_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert sys.modules['jax'] is None\n"
        "assert not any(k.startswith(('jax.', 'newtonkrylov_tpu.')) or k == "
        "'newtonkrylov_tpu' for k in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("n", [64, pytest.param(2048, marks=pytest.mark.slow)])
@pytest.mark.parametrize("start", ["entry", "bench"])
def test_flagship_f32_df32_counts_match_jax(start, n):
    """The flagship configuration (f32 Krylov, df32 acceptance residual, DST
    ``"high"`` built once, λ = 5, tol_rel 1e-8), both drivers from one u₀:
    ``entry()``'s f32 guess, or ``bench.py``'s f64 guess × (1 + 1e-6).  The
    outer counts must be equal; the inner counts are printed beside each
    other (ROADMAP.md Queue 3 items 2 and 13).  The 2048² case (``-m slow``,
    about a minute) is the card's headline size."""
    if start == "entry":
        u0 = np.asarray(jb.initial_guess(n, dtype=jnp.float32)).astype(np.float64)
    else:
        u0 = np.asarray(jb.initial_guess(n, dtype=jnp.float64)) * (1.0 + 1e-6)
    (_, it), _ = _flagship(n, _t(u0), nkt, tb, t_fft_poisson, F32, True)
    (_, ij), _ = _flagship(n, jnp.asarray(u0), nk, jb, j_fft_poisson,
                           jnp.float32, True)
    print(f"flagship n={n} u0={start}: JAX {int(ij.stats.outer_iterations)}/"
          f"{int(ij.stats.inner_iterations)}, port {it.stats.outer_iterations}/"
          f"{it.stats.inner_iterations}")
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)


@pytest.mark.slow
def test_flagship_pipelined_counts_2048():
    """The flagship with pipelined CG at 2048² (``-m slow``, about a minute),
    each inner solve capped at 50 iterations as ``chip_smoke.py`` does: both
    drivers solve; their counts are printed beside each other.  In f32 one
    pipelined inner solve can stagnate above its tolerance, and where it
    does depends on rounding (ROADMAP.md Queue 3 item 17)."""
    n = 2048
    u0 = np.asarray(jb.initial_guess(n, dtype=jnp.float32)).astype(np.float64)
    p = jb.default_config(n, lam=5.0)
    kw = dict(algo="cg", tol_rel=1e-8, max_niter=20, precond_refresh="once",
              krylov_kwargs={"pipeline": True, "itmax": 50})
    _, ij = nk.newton_krylov_jit(jb.residual_scaled, jnp.asarray(u0), p,
                                 M=j_fft_poisson(precision="high"),
                                 krylov_dtype=jnp.float32,
                                 residual_df=jb.residual_scaled_df, **kw)
    _, it = nkt.newton_krylov_jit(tb.residual_scaled, _t(u0), convert.params(p),
                                  M=t_fft_poisson(precision="high"),
                                  krylov_dtype=F32,
                                  residual_df=tb.residual_scaled_df, **kw)
    print(f"pipelined flagship n={n}: JAX {int(ij.stats.outer_iterations)}/"
          f"{int(ij.stats.inner_iterations)}, port {it.stats.outer_iterations}/"
          f"{it.stats.inner_iterations}")
    assert bool(it.solved) and bool(ij.solved)
