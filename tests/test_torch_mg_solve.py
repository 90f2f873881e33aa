"""Newton solves over the port's multigrid family against the JAX
package's: MG-general (``mg.multigrid2d_general``) on convection–diffusion
at c = 25, MG-PCG (``mg.multigrid2d``) and two-grid (``precond.two_grid``)
on Bratu.

The JAX package's configurations are handed over as numpy.  The f64 solves
take the JAX driver's outer and inner counts and agree within 1e-10; the
refined f32 + df32 solve takes its outer count (f32 inner counts may
differ, ROADMAP.md Queue 3 item 10), is solved and reaches the
manufactured root within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import mg as jmg
from newtonkrylov_tpu import precond as jp
from newtonkrylov_tpu.problems import bratu2d as jb
from newtonkrylov_tpu.problems import convdiff2d as jc
from newtonkrylov_tpu_torch import mg as tmg
from newtonkrylov_tpu_torch import precond as tp
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.problems import convdiff2d as tc
from newtonkrylov_tpu_torch.utils import convert

F64, F32 = torch.float64, torch.float32
N = 32


def _t(a, dtype=None):
    return convert.state(np.asarray(a), device="cpu", dtype=dtype)


def _cd_params(pj) -> tc.Params:
    return tc.Params(dx=float(pj.dx), c=float(pj.c), b=_t(pj.b))


def _assert_same_solve(jax_run, torch_run, atol=1e-10):
    (uj, ij), (ut, it) = jax_run, torch_run
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=atol)
    return ut


def test_newton_mg_general_convdiff_matches_jax():
    """newton_krylov_jit + full GMRES + multigrid2d_general at c = 25,
    n = 32, f64, exact Newton, tol_rel 1e-10: the JAX driver's counts (31
    inners), solutions within 1e-10, the manufactured root reached."""
    pj = jc.default_config(N, c=25.0, dtype=jnp.float64)
    u0 = jc.initial_guess(N, jnp.float64)
    kw = dict(algo="gmres", tol_rel=1e-10, forcing=None, max_niter=15,
              krylov_kwargs={"restart": None, "itmax": 300})
    ut = _assert_same_solve(
        nk.newton_krylov_jit(jc.residual_scaled, u0, pj,
                             M=jmg.multigrid2d_general(), **kw),
        nkt.newton_krylov_jit(tc.residual_scaled, _t(u0), _cd_params(pj),
                              M=tmg.multigrid2d_general(), **kw))
    us = tc.manufactured_solution(N, device="cpu")
    assert float((ut - us).abs().max()) < 1e-9


@pytest.mark.parametrize("lane", ["mg-pcg", "two-grid"])
def test_newton_bratu_mg_family_matches_jax(lane):
    """MG-PCG (``multigrid2d``, rebuilt every outer) and two-grid
    (``two_grid(8)``, built once) under CG on Bratu at 32², f64,
    tol_rel 1e-10: the JAX driver's counts, solutions within 1e-10."""
    pj = jb.default_config(N, lam=5.0)
    u0 = jb.initial_guess(N, dtype=jnp.float64)
    kw = dict(algo="cg", tol_rel=1e-10, max_niter=20)
    if lane == "mg-pcg":
        Mj, Mt = jmg.multigrid2d(), tmg.multigrid2d()
    else:
        Mj, Mt = jp.two_grid(8), tp.two_grid(8)
        kw["precond_refresh"] = "once"
    _assert_same_solve(
        nk.newton_krylov_jit(jb.residual_scaled, u0, pj, M=Mj, **kw),
        nkt.newton_krylov_jit(tb.residual_scaled, _t(u0), convert.params(pj),
                              M=Mt, **kw))


def test_refined_mg_general_solve_matches_jax():
    """The production path over MG-general at c = 25, n = 64: f32 Krylov,
    df32 acceptance residual, tol_rel 1e-8 — solved, the JAX package's
    outer count, max|u − u*| ≤ 1e-6."""
    n = 64
    pj = jc.default_config(n, c=25.0, dtype=jnp.float64)
    u0 = jc.initial_guess(n, jnp.float64)
    kw = dict(algo="gmres", tol_rel=1e-8, forcing=None, max_niter=15,
              krylov_kwargs={"restart": None, "itmax": 300})
    _, ij = nk.newton_krylov_jit(
        jc.residual_scaled, u0, pj, krylov_dtype=jnp.float32,
        residual_df=jc.residual_scaled_df, M=jmg.multigrid2d_general(), **kw)
    ut, it = nkt.newton_krylov_jit(
        tc.residual_scaled, _t(u0), _cd_params(pj), krylov_dtype=F32,
        residual_df=tc.residual_scaled_df, M=tmg.multigrid2d_general(), **kw)
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert ut.dtype == F64
    us = tc.manufactured_solution(n, device="cpu")
    assert float((ut - us).abs().max()) <= 1e-6
