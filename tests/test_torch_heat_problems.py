"""The port's heat, spring and DG problems, the rest of ``ops/stencil`` and
of df32 against the JAX package.

Oracles: tests/test_problems.py (``TestHeat2D``), tests/test_df32_problems.py
(the heat/spring/DG residuals and the refined steps, ``df_matvec``) and
tests/test_df32.py.  The same numpy inputs go to both packages in float64
unless stated.  Pure placements (pads, slices, the BC clamp) and the
elementwise arithmetic are bitwise equal; a dense matrix product sums in
another order, so ``heat1d_dg.rhs`` is held to its rounding scale and the
df32 matvec's lo word to the f32 rounding of its cross terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import df32 as jd
from newtonkrylov_tpu.ops import stencil as jst
from newtonkrylov_tpu.problems import heat1d as jh1
from newtonkrylov_tpu.problems import heat1d_dg as jdg
from newtonkrylov_tpu.problems import heat2d as jh2
from newtonkrylov_tpu.problems import spring as js
from newtonkrylov_tpu.timestep import StepParams as JStep
from newtonkrylov_tpu.timestep import implicit_euler as j_euler
from newtonkrylov_tpu.timestep import implicit_euler_df as j_euler_df
from newtonkrylov_tpu_torch import df32 as td
from newtonkrylov_tpu_torch.ops import stencil as tst
from newtonkrylov_tpu_torch.problems import heat1d as th1
from newtonkrylov_tpu_torch.problems import heat1d_dg as tdg
from newtonkrylov_tpu_torch.problems import heat2d as th2
from newtonkrylov_tpu_torch.problems import spring as ts
from newtonkrylov_tpu_torch.timestep import StepParams as TStep
from newtonkrylov_tpu_torch.timestep import implicit_euler as t_euler
from newtonkrylov_tpu_torch.timestep import implicit_euler_df as t_euler_df
from newtonkrylov_tpu_torch.utils import convert as cv

F64, F32 = torch.float64, torch.float32


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _same(jax_out, torch_out):
    """Bitwise equality of a JAX array and a tensor."""
    a, b = np.asarray(jax_out), torch_out.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b), float(np.abs(a - b).max())


def _same_df(jax_df, torch_df):
    _same(jax_df.hi, torch_df.hi)
    _same(jax_df.lo, torch_df.lo)


# -- ops/stencil and df32 ----------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 9), (16, 16), (1, 5)])
def test_pad_periodic_bitwise(shape):
    """Wrap-around ghosts, corners included, bit for bit (``jnp.pad(wrap)``)."""
    u = np.random.default_rng(0).standard_normal(shape)
    _same(jst.pad_periodic(jnp.asarray(u)), tst.pad_periodic(_t(u)))


def test_laplacian_1d_bitwise():
    up = np.random.default_rng(1).standard_normal(34)
    _same(jst.laplacian_1d(jnp.asarray(up), 0.03), tst.laplacian_1d(_t(up), 0.03))


def test_mul_f32_bitwise():
    rng = np.random.default_rng(2)
    a = rng.standard_normal(257)
    b = rng.standard_normal(257).astype(np.float32)
    _same_df(jd.mul_f32(jd.df_from_f64(jnp.asarray(a)), jnp.asarray(b)),
             td.mul_f32(td.df_from_f64(_t(a)), _t(b, F32)))


@pytest.mark.parametrize("m", [1, 13, 64, 160])
def test_comp_sum_last_bitwise(m):
    """The compensated tree sum, padded to a power of two, bit for bit."""
    rng = np.random.default_rng(m)
    P = rng.standard_normal((5, m)).astype(np.float32)
    E = (rng.standard_normal((5, m)) * 1e-8).astype(np.float32)
    sj, ej = jd._comp_sum_last(jnp.asarray(P), jnp.asarray(E))
    st, et = td._comp_sum_last(_t(P, F32), _t(E, F32))
    _same(sj, st)
    _same(ej, et)


def test_df_matvec_matches_jax_and_f64():
    """The double-word matvec (test_df32_problems.py::test_df_matvec_matches_f64):
    the hi words bit for bit with the JAX package's; the lo words within the
    f32 rounding of the cross-term products (summed in another order,
    1e-12 of max|A|·max|x|·n); both at df32 accuracy against an f64 matmul."""
    rng = np.random.default_rng(5)
    A64 = rng.standard_normal((160, 160))
    x64 = rng.standard_normal(160)
    gj = jd.df_matvec(jd.df_from_f64(jnp.asarray(A64)), jd.df_from_f64(jnp.asarray(x64)))
    gt = td.df_matvec(td.df_from_f64(_t(A64)), td.df_from_f64(_t(x64)))
    _same(gj.hi, gt.hi)
    scale = float(np.abs(A64).max() * np.abs(x64).max()) * 160
    assert float(np.abs(np.asarray(gj.lo) - gt.lo.numpy()).max()) / scale < 1e-12
    err = np.abs(td.df_to_f64(gt).numpy() - A64 @ x64).max() / scale
    assert err < 1e-12


def test_df_matvec_refuses_tf32(monkeypatch):
    """Full-f32 cross products: the matvec raises while TF32 is allowed
    (ROADMAP.md Queue 3 hazard (a))."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    a = td.df_from_f64(torch.ones((4, 4), dtype=F64))
    with pytest.raises(RuntimeError, match="allow_tf32"):
        td.df_matvec(a, td.df_from_f64(torch.ones(4, dtype=F64)))


# -- heat2d ----------------------------------------------------------------


def test_heat2d_config_and_initial_condition():
    pj = jh2.default_config(40)
    pt = th2.default_config(40)
    assert tuple(pt) == tuple(pj)
    assert th2.stable_dt(pt) == jh2.stable_dt(pj)
    np.testing.assert_allclose(th2.initial_condition(40, device="cpu").numpy(),
                               np.asarray(jh2.initial_condition(40)),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("bc", ["zero", "periodic"])
def test_heat2d_rhs_and_rhs_df_bitwise(bc):
    """a·Δu and its df32 form, both BCs, on a seeded state: bit for bit
    (pads and slices are placements, the arithmetic is the same IEEE
    sequence); the df32 form within 1e-11 of the f64 RHS
    (test_df32_problems.py::test_heat2d_rhs_df_bcs)."""
    n = 32
    pj = jh2.default_config(n, bc=bc)
    pt = cv.heat2d_params(pj)
    u = np.random.default_rng(7).uniform(-1, 1, (n, n))
    _same(jh2.rhs(jnp.asarray(u), pj), th2.rhs(_t(u), pt))
    _same_df(jh2.rhs_df(jd.df_from_f64(jnp.asarray(u)), pj),
             th2.rhs_df(td.df_from_f64(_t(u)), pt))
    want = th2.rhs(_t(u), pt)
    got = td.df_to_f64(th2.rhs_df(td.df_from_f64(_t(u)), pt))
    assert float((got - want).abs().max() / want.abs().max()) < 1e-11


def test_heat2d_periodic_constant_is_equilibrium():
    p = th2.default_config(16, bc="periodic")
    assert float(th2.rhs(torch.ones((16, 16), dtype=F64), p).abs().max()) <= 1e-12


# -- heat1d, spring ----------------------------------------------------------


@pytest.mark.parametrize("bc", ["dirichlet", "periodic"])
def test_heat1d_rhs_and_rhs_df_bitwise(bc):
    """The clamped-copy RHS and its df32 form, both BCs, bit for bit; the
    clamp itself too; df32 within 1e-10 of f64
    (test_df32_problems.py::test_heat1d_rhs_df_matches_f64)."""
    pj = jh1.default_config(100, bc=bc)
    pt = cv.heat1d_params(pj)
    x = jh1.grid(100, dtype=jnp.float64)
    u = np.asarray(jh1.clamp_bc(jh1.initial_condition(x), pj)) * 0.93 + 0.01
    raw = np.random.default_rng(3).standard_normal(102)
    _same(jh1.clamp_bc(jnp.asarray(raw), pj), th1.clamp_bc(_t(raw), pt))
    _same(jh1.rhs(jnp.asarray(u), pj), th1.rhs(_t(u), pt))
    _same_df(jh1.rhs_df(jd.df_from_f64(jnp.asarray(u)), pj),
             th1.rhs_df(td.df_from_f64(_t(u)), pt))
    want = th1.rhs(_t(u), pt)
    got = td.df_to_f64(th1.rhs_df(td.df_from_f64(_t(u)), pt))
    assert float((got - want).abs().max() / want.abs().max()) < 1e-10


def test_heat1d_grid_and_initial_condition():
    """0:Δx:1 inclusive (m + 2 points) and 4x(1 − x), within 2 ulp of the
    JAX package's (``arange`` steps accumulate differently)."""
    xj = np.asarray(jh1.grid(100, dtype=jnp.float64))
    xt = th1.grid(100, device="cpu")
    assert xt.shape == (102,) and xt.dtype == F64
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=2.3e-16)
    np.testing.assert_allclose(th1.initial_condition(xt).numpy(),
                               np.asarray(jh1.initial_condition(jnp.asarray(xt.numpy()))),
                               rtol=0, atol=0)


def test_spring_rhs_rhs_df_and_exact_solution():
    pj = js.default_config()
    pt = cv.spring_params(pj)
    assert pt.gamma == ts.default_config().gamma
    u = np.array([0.0731, -0.042])
    _same(js.rhs(jnp.asarray(u), pj), ts.rhs(_t(u), pt))
    _same_df(js.rhs_df(jd.df_from_f64(jnp.asarray(u)), pj),
             ts.rhs_df(td.df_from_f64(_t(u)), pt))
    got = td.df_to_f64(ts.rhs_df(td.df_from_f64(_t(u)), pt))
    np.testing.assert_allclose(got.numpy(), ts.rhs(_t(u), pt).numpy(), atol=1e-14)
    _same(js.initial_condition(), ts.initial_condition(device="cpu"))
    for t in (0.0, 0.37, 2.0):
        np.testing.assert_allclose(float(ts.exact_solution(t, pt, 0.1, 0.3)),
                                   float(js.exact_solution(t, pj, 0.1, 0.3)),
                                   rtol=1e-15, atol=1e-17)


# -- heat1d_dg ----------------------------------------------------------------


@pytest.mark.parametrize("cfg", ["dg", "upwind"])
def test_heat1d_dg_rhs_and_rhs_df(cfg):
    """D1m(D1p u) and its two double-word matvecs against the JAX package on
    its own operators.  The matrix products sum in another order, so the
    f64 RHS is held to 1e-15 of the rounding scale max(|D1m|·|D1p|·|u|)
    (the n·ε bound is 1.8e-14 of it) and the two packages' df32 RHS to
    1e-14 of it; the df32 RHS within 1e-11 of max|rhs| of the f64 oracle
    (test_df32_problems.py::test_heat1d_dg_rhs_df_matches_f64)."""
    pj = getattr(jdg, f"{cfg}_config")()
    pt = cv.heat1d_dg_params(pj, device="cpu")
    u = np.asarray(jdg.initial_condition(pj)) * 0.93
    want = np.asarray(jdg.rhs(jnp.asarray(u), pj))
    got = tdg.rhs(_t(u), pt).numpy()
    bound = (np.abs(np.asarray(pj.D1m)) @ (np.abs(np.asarray(pj.D1p)) @ np.abs(u))).max()
    assert np.abs(got - want).max() / bound < 1e-15
    got_df = td.df_to_f64(tdg.rhs_df(td.df_from_f64(_t(u)), pt)).numpy()
    assert np.abs(got_df - want).max() / np.abs(want).max() < 1e-11
    jdf = jd.df_to_f64(jdg.rhs_df(jd.df_from_f64(jnp.asarray(u)), pj))
    assert np.abs(got_df - np.asarray(jdf)).max() / bound < 1e-14


def test_heat1d_dg_configs_match_jax():
    """The DG and upwind configurations' matrices and nodes bit for bit
    (the sbp construction is a copy of the JAX package's numpy code)."""
    for cfg in ("dg", "upwind"):
        pj = getattr(jdg, f"{cfg}_config")()
        pt = getattr(tdg, f"{cfg}_config")(device="cpu")
        for a, b in zip(pj, pt):
            _same(a, b)
        np.testing.assert_allclose(tdg.initial_condition(pt).numpy(),
                                   np.asarray(jdg.initial_condition(pj)),
                                   rtol=0, atol=1e-15)


# -- the refined steps (test_df32_problems.py) ------------------------------


def _refined_step(j_rhs, j_rhs_df, t_rhs, t_rhs_df, u0, pj, pt, dt, kw):
    """One backward-Euler step to a 1e-8 acceptance residual through the
    df32 path in both packages, and its f64 oracle step (tol_rel 1e-10)."""
    spj = JStep(un=jnp.asarray(u0), dt=dt, p=pj, t=dt)
    spt = TStep(un=_t(u0), dt=dt, p=pt, t=dt)
    uj, ij = nk.newton_krylov_jit(j_euler(j_rhs), jnp.asarray(u0), spj, tol_rel=1e-8,
                                  residual_df=j_euler_df(j_rhs_df), **kw)
    ut, it = nkt.newton_krylov_jit(t_euler(t_rhs), _t(u0), spt, tol_rel=1e-8,
                                   residual_df=t_euler_df(t_rhs_df), **kw)
    uref, iref = nkt.newton_krylov_jit(t_euler(t_rhs), _t(u0), spt, tol_rel=1e-10, **kw)
    return (uj, ij), (ut, it), (uref, iref), spt


@pytest.mark.parametrize("problem", ["heat2d", "heat1d", "heat1d_dg"])
def test_refined_step_to_1e8(problem):
    """The refined steps of test_df32_problems.py: heat2d (64², 50× the
    explicit step, CG), heat1d (m = 100, Δt = 0.1, CG) and heat1d_dg (the
    DG configuration, Δt = 1e-4, full GMRES with itmax 200), f32 Krylov +
    df32: solved, the JAX package's outer counts (and inner counts, but for
    heat2d: ROADMAP.md Queue 3 item 18), the f64 oracle step within 1e-7
    (the JAX tests' bound) and the JAX state within 1e-9 (two 1e-8
    acceptances whose f32 inner solves sum in another order: measured
    1e-10 at most), and the f64 step residual within 1.2e-8 of ‖G(uₙ)‖."""
    if problem == "heat2d":
        pj = jh2.default_config(64)
        pt = cv.heat2d_params(pj)
        u0 = np.asarray(jh2.initial_condition(64))
        dt = jh2.stable_dt(pj) * 50.0
        mods = (jh2.rhs, jh2.rhs_df, th2.rhs, th2.rhs_df)
        kw = dict(algo="cg", max_niter=30)
    elif problem == "heat1d":
        pj = jh1.default_config(100)
        pt = cv.heat1d_params(pj)
        u0 = np.asarray(jh1.clamp_bc(jh1.initial_condition(jh1.grid(100)), pj))
        dt = 0.1
        mods = (jh1.rhs, jh1.rhs_df, th1.rhs, th1.rhs_df)
        kw = dict(algo="cg")
    else:
        pj = jdg.dg_config()
        pt = cv.heat1d_dg_params(pj, device="cpu")
        u0 = np.asarray(jdg.initial_condition(pj))
        dt = 1e-4
        mods = (jdg.rhs, jdg.rhs_df, tdg.rhs, tdg.rhs_df)
        kw = dict(algo="gmres", krylov_kwargs={"restart": None, "itmax": 200},
                  max_niter=10)
    (uj, ij), (ut, it), (uref, iref), spt = _refined_step(*mods, u0, pj, pt, dt, kw)
    assert bool(ij.solved) and bool(it.solved) and bool(iref.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    if problem != "heat2d":
        assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    assert float((ut - uref).abs().max()) < 1e-7
    assert float(np.abs(np.asarray(uj) - ut.numpy()).max()) < 1e-9
    G = t_euler(mods[2])
    assert float(torch.linalg.vector_norm(G(ut, spt))) <= 1.2e-8 * float(
        torch.linalg.vector_norm(G(_t(u0), spt)))
