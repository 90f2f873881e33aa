"""The port's implicit steppers and marching drivers against the JAX
package's ``timestep`` (oracles: tests/test_timestep.py and
tests/test_problems.py::TestHeat2D).

The same numpy inputs go to both packages in float64.  The residual
builders are elementwise, so they agree to rounding (rtol 1e-14); the
marches agree in counts and states where the inner solves are short
(spring, heat2d); where a step runs a hundred GMRES iterations (heat1d)
the packages' dot products, summed in another order, move the later
steps' inner counts (ROADMAP.md Queue 3 item 18), and the states are held
to the march's own tolerance.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import df32 as jd
from newtonkrylov_tpu import timestep as jt
from newtonkrylov_tpu.problems import heat1d as jh1
from newtonkrylov_tpu.problems import heat2d as jh2
from newtonkrylov_tpu.problems import spring as js
from newtonkrylov_tpu_torch import df32 as td
from newtonkrylov_tpu_torch import timestep as tt
from newtonkrylov_tpu_torch.precond import chebyshev
from newtonkrylov_tpu_torch.problems import heat1d as th1
from newtonkrylov_tpu_torch.problems import heat2d as th2
from newtonkrylov_tpu_torch.problems import spring as ts
from newtonkrylov_tpu_torch.utils import convert as cv

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _counts(r):
    return (np.asarray(r.outer_iterations).tolist(),
            np.asarray(r.inner_iterations).tolist())


@pytest.mark.parametrize("name", ["euler", "midpoint", "trapezoid", "euler_df"])
def test_steppers_match_jax(name):
    """The three step residuals and the df32 backward-Euler residual on a
    seeded heat2d state against the JAX package's (rtol 1e-14; the df32
    residual's f64 value), and the hand-checked formulas of
    test_timestep.py::test_stepper_residual_formulas."""
    n = 24
    rng = np.random.default_rng(11)
    pj = jh2.default_config(n)
    pt = cv.heat2d_params(pj)
    un = rng.uniform(-1, 1, (n, n))
    u = un * 0.97 + 1e-3 * rng.standard_normal((n, n))
    dt = jh2.stable_dt(pj) * 10.0
    spj = jt.StepParams(un=jnp.asarray(un), dt=dt, p=pj, t=0.3)
    spt = cv.step_params(spj, pt, device="cpu")
    if name == "euler_df":
        want = jd.df_to_f64(jt.implicit_euler_df(jh2.rhs_df)(jd.df_from_f64(jnp.asarray(u)), spj))
        got = td.df_to_f64(tt.implicit_euler_df(th2.rhs_df)(td.df_from_f64(_t(u)), spt))
        # and the df32 value is the f64 residual to df32 accuracy
        f64 = tt.implicit_euler(th2.rhs)(_t(u), spt)
        assert float((got - f64).abs().max()) / float(np.abs(un).max()) < 1e-12
    else:
        want = jt.STEPPERS[name](jh2.rhs)(jnp.asarray(u), spj)
        got = tt.STEPPERS[name](th2.rhs)(_t(u), spt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=1e-14 * float(np.abs(np.asarray(want)).max()))

    if name != "euler_df":  # du/dt = −2u, uₙ = 1, u = 0.8, Δt = 0.1
        G = tt.STEPPERS[name](lambda v, p, t: -2.0 * v)
        r = float(G(_t([0.8]), tt.StepParams(un=_t([1.0]), dt=0.1, p=None, t=0.1))[0])
        expect = {"euler": 1.0 + 0.1 * (-2 * 0.8) - 0.8,
                  "midpoint": 1.0 + 0.1 * (-2 * 0.9) - 0.8,
                  "trapezoid": 1.0 + 0.05 * (-2 * 1.0 - 2 * 0.8) - 0.8}[name]
        np.testing.assert_allclose(r, expect, rtol=1e-14)


def test_step_jacobian_spring():
    """``step_jacobian`` on the spring: dt·A − I
    (test_timestep.py::test_step_jacobian_probe), and the JAX package's."""
    p = ts.default_config()
    J = tt.step_jacobian("euler", ts.rhs, _t([0.1, 0.0]), p, 0.01)
    A = np.array([[0.0, 1.0], [-2.0, 0.0]])
    np.testing.assert_allclose(J.numpy(), 0.01 * A - np.eye(2), atol=1e-12)
    Jj = jt.step_jacobian("midpoint", js.rhs, jnp.array([0.1, 0.0]),
                          js.default_config(), 0.01)
    Jt = tt.step_jacobian("midpoint", ts.rhs, _t([0.1, 0.0]), p, 0.01)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), atol=1e-12)


@pytest.mark.parametrize("name", ["euler", "midpoint", "trapezoid"])
def test_integrate_spring_matches_jax(name):
    """``integrate`` on the spring, Δt = 0.05 to t = 1 (20 steps), every
    stepper: the JAX package's per-step outer and inner counts, the state
    within rtol 1e-10; stable amplitude, and second order for midpoint and
    trapezoid (test_timestep.py::test_spring_steppers_march)."""
    pj = js.default_config()
    pt = cv.spring_params(pj)
    rj = nk.integrate(name, js.rhs, js.initial_condition(), pj, 0.05, 1.0)
    rt = nkt.integrate(name, ts.rhs, ts.initial_condition(device="cpu"), pt, 0.05, 1.0)
    assert rt.n_failed == int(rj.n_failed) == 0
    assert _counts(rt) == _counts(rj)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=1e-10, atol=1e-15)
    assert abs(float(rt.u[0])) <= 0.11
    if name != "euler":
        np.testing.assert_allclose(float(rt.u[0]), float(ts.exact_solution(1.0, pt)),
                                   atol=2e-3)
    assert rt.ts.dtype == F64 and rt.ts.shape == (21,)
    np.testing.assert_allclose(rt.ts.numpy(), np.asarray(rj.ts), rtol=0, atol=0)


def test_euler_scalar_decay_exact():
    """Backward Euler on du/dt = −u: u/(1 + Δt) a step
    (test_timestep.py::test_euler_scalar_decay_exact)."""
    r = nkt.integrate("euler", lambda u, p, t: -u, _t([1.0]), None, 0.5, 2.0)
    np.testing.assert_allclose(float(r.u[0]), 1.0 / 1.5 ** 4, rtol=1e-6)
    assert r.n_failed == 0


def test_heat1d_march():
    """The heat1d march (m = 100, Δt = 0.1 to t = 1, GMRES, the reference's
    tol_abs = 6e-6; test_timestep.py::test_heat1d_march_decays): history of
    the initial state and 10 steps, clamped boundaries, decay; against the
    JAX package from its u₀: no failed step, the first two steps' counts
    equal, the states within 1e-6 (the later steps' inner counts differ,
    ROADMAP.md Queue 3 item 18)."""
    pj = jh1.default_config(100, a=0.2)
    pt = cv.heat1d_params(pj)
    u0 = np.asarray(jh1.clamp_bc(jh1.initial_condition(jh1.grid(100)), pj))
    rj = nk.integrate("euler", jh1.rhs, jnp.asarray(u0), pj, 0.1, 1.0, save_history=True)
    rt = nkt.integrate("euler", th1.rhs, _t(u0), pt, 0.1, 1.0, save_history=True)
    assert rt.n_failed == int(rj.n_failed) == 0
    assert rt.history.shape == (11, 102)
    assert float(rt.u[0]) == 0.0 and float(rt.u[-1]) == 0.0
    assert float(torch.linalg.vector_norm(rt.u)) < 0.5 * float(np.linalg.norm(u0))
    oj, ij = _counts(rj)
    ot, it = _counts(rt)
    assert (ot[:2], it[:2]) == (oj[:2], ij[:2])
    assert float(np.abs(rt.history.numpy() - np.asarray(rj.history)).max()) < 1e-6


def test_heat2d_march_40():
    """The 40² march of test_problems.py::TestHeat2D: 20 explicit-limit
    steps, the JAX package's counts, the state within 1e-12, and the decay
    exp(−2aπ²t) within 5%."""
    n = 40
    pj = jh2.default_config(n)
    pt = cv.heat2d_params(pj)
    dt = jh2.stable_dt(pj)
    u0 = np.asarray(jh2.initial_condition(n))
    rj = nk.integrate("euler", jh2.rhs, jnp.asarray(u0), pj, dt, 20 * dt)
    rt = nkt.integrate("euler", th2.rhs, _t(u0), pt, dt, 20 * dt)
    assert rt.n_failed == int(rj.n_failed) == 0
    assert _counts(rt) == _counts(rj)
    assert float(np.abs(rt.u.numpy() - np.asarray(rj.u)).max()) < 1e-12
    decay = float(rt.u.max()) / float(u0.max())
    np.testing.assert_allclose(decay, math.exp(-2 * pt.a * math.pi ** 2 * 20 * dt),
                               rtol=0.05)


def test_integrate_matches_integrate_scan_bitwise():
    """The two drivers share the step: the same states bit for bit, the
    history every ``save_every`` steps with its float64 times, per-step
    counts as tensors and ``n_failed`` as a tensor
    (test_timestep.py::test_integrate_scan_matches_host_loop)."""
    n = 16
    p = th2.default_config(n)
    dt = 5 * th2.stable_dt(p)
    u0 = th2.initial_condition(n, device="cpu")
    full = nkt.integrate("midpoint", th2.rhs, u0, p, dt, 6 * dt, save_history=True)
    scan = nkt.integrate_scan("midpoint", th2.rhs, u0, p, dt, 6, save_every=3)
    assert torch.equal(full.u, scan.u)
    assert scan.history.shape == (2, n, n)
    assert torch.equal(scan.history[0], full.history[3])
    assert torch.equal(scan.history[1], full.history[6])
    assert scan.ts.dtype == F64
    np.testing.assert_allclose(scan.ts.numpy(), [3 * dt, 6 * dt], rtol=1e-15)
    assert isinstance(scan.n_failed, torch.Tensor) and int(scan.n_failed) == 0
    assert torch.equal(scan.outer_iterations, full.outer_iterations)
    assert torch.equal(scan.inner_iterations, full.inner_iterations)
    # and against the JAX package's scan on the spring
    rj = jt.integrate_scan("midpoint", js.rhs, js.initial_condition(),
                           js.default_config(), 0.05, 10)
    rt = nkt.integrate_scan("midpoint", ts.rhs, ts.initial_condition(device="cpu"),
                            ts.default_config(), 0.05, 10)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=1e-10)
    assert _counts(rt) == _counts(rj)
    np.testing.assert_allclose(rt.ts.numpy(), np.asarray(rj.ts), rtol=1e-15)


def test_callback_once_per_step_and_warn_and_continue(capsys):
    """``callback(u)`` fires once per step (examples/implicit.jl:74); a
    failed step prints the warning and the march goes on, as the JAX
    package's does."""
    frames = []
    p = ts.default_config()
    r = nkt.integrate("euler", ts.rhs, ts.initial_condition(device="cpu"), p, 0.1, 0.5,
                      callback=lambda u: frames.append(u.clone()))
    assert len(frames) == 5 and r.n_failed == 0
    assert torch.equal(frames[-1], r.u)
    kw = dict(tol_abs=0.0, tol_rel=1e-14, max_niter=0, forcing=nk.Fixed(0.9))
    rj = nk.integrate("euler", js.rhs, js.initial_condition(), js.default_config(),
                      0.1, 0.3, newton_kwargs=kw)
    capsys.readouterr()
    kw["forcing"] = nkt.Fixed(0.9)
    rt = nkt.integrate("euler", ts.rhs, ts.initial_condition(device="cpu"), p, 0.1,
                       0.3, newton_kwargs=kw)
    out = capsys.readouterr().out
    assert rt.n_failed == int(rj.n_failed) == 3
    assert out.count("[integrate] WARNING: nonlinear solve failed, marching on") == 3
    assert rt.ts.shape == (4,)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=1e-12)


@pytest.mark.parametrize("option", ["verbose", "callback", "jit_step"])
def test_host_only_options_use_the_host_driver(option, capsys):
    """``verbose``, a Newton ``callback`` or ``jit_step`` send each step to
    the host-stepped ``newton_krylov`` (the JAX package's split); the two
    drivers share the Newton step, so the march is bit for bit the
    default one's."""
    p = ts.default_config()
    u0 = ts.initial_condition(device="cpu")
    ref = nkt.integrate("midpoint", ts.rhs, u0, p, 0.1, 0.3)
    calls = []
    kw = {"verbose": {}, "callback": {"callback": lambda *a: calls.append(a)},
          "jit_step": {"jit_step": True}}[option]
    r = nkt.integrate("midpoint", ts.rhs, u0, p, 0.1, 0.3,
                      verbose=1 if option == "verbose" else 0,
                      newton_kwargs=dict(kw))
    assert torch.equal(r.u, ref.u) and _counts(r) == _counts(ref)
    out = capsys.readouterr().out
    assert ("[newton_krylov]" in out) == (option == "verbose")
    if option == "callback":  # u₀'s residual and one per outer, every step
        assert len(calls) == int(r.outer_iterations.sum()) + 3


def test_heat2d_cheb_pcg_march_exact_factor():
    """The card path's configuration at 32²: a = 0.01, Δt = 0.05, 20 steps,
    f32 Krylov CG with ``chebyshev(16)`` on the Gershgorin box [−1 − 8o,
    −1] of the step Jacobian, df32 acceptance: sin(πx)sin(πy) is an
    eigenvector of the discrete Laplacian, so each step multiplies it by
    g = 1/(1 + Δt·a·(8/Δx²)·sin²(πΔx/2)); the state within 1e-10 of
    g²⁰·u₀ and every step's f64 residual within 1.2e-8 of ‖G(uₙ)‖."""
    n, dt = 32, 0.05
    p = th2.default_config(n, a=0.01)
    o = dt * p.a / p.dx ** 2
    u0 = th2.initial_condition(n, device="cpu")
    g = 1.0 / (1.0 + dt * p.a * (8.0 / p.dx ** 2) * math.sin(math.pi * p.dx / 2) ** 2)
    kw = dict(algo="cg", M=chebyshev(16, bounds=(-1.0 - 8.0 * o, -1.0)),
              precond_refresh="once", krylov_dtype=torch.float32,
              residual_df=tt.implicit_euler_df(th2.rhs_df), tol_rel=1e-8, tol_abs=0.0)
    r = nkt.integrate("euler", th2.rhs, u0, p, dt, 1.0, newton_kwargs=kw,
                      save_history=True)
    assert r.n_failed == 0 and r.history.shape == (21, n, n)
    assert float((r.u - g ** 20 * u0).abs().max()) < 1e-10
    G = tt.implicit_euler(th2.rhs)
    for k in range(20):
        sp = tt.StepParams(un=r.history[k], dt=dt, p=p, t=(k + 1) * dt)
        assert float(torch.linalg.vector_norm(G(r.history[k + 1], sp))) <= 1.2e-8 * float(
            torch.linalg.vector_norm(G(r.history[k], sp)))
