"""The port's measuring programs against the JAX package, on the CPU.

``benchmarks/chain_solve.py`` (the chained-solve protocol) against
``newton_krylov_jit`` called directly; ``xl8192`` at 64² against the JAX
driver with the same preconditioners; ``floor_probe``'s probes against the
JAX script's own (``benchmarks/floor_probe.py``, imported as the JAX side);
``solve_profile`` at 64² against the JAX driver's counts;
``dst_precision_probe``'s lanes at 32² against the JAX driver
(``solve_df32_check`` and ``cheb_probe``: ``test_torch_benchmarks_lanes.py``).
Every program runs with ``device="cpu"``.

Tolerances: f64 states bit for bit where both sides are the port; the
flagship configuration's f32 Krylov loop takes the JAX driver's outer count
and its inner count within two (ROADMAP.md Queue 3 items 2 and 13); the
df32 probes within 1e-5 relative (f32 norms summed in another order, Queue
3 item 4) and the f32 tangents of ``floor_estimate`` within 1e-5.
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import df32 as jdd
from newtonkrylov_tpu.fftprec import fft_poisson as j_fft_poisson
from newtonkrylov_tpu.mg import multigrid2d as j_multigrid2d
from newtonkrylov_tpu.precond import two_grid as j_two_grid
from newtonkrylov_tpu.problems import bratu2d as jb
from newtonkrylov_tpu_torch import df32 as tdd
from newtonkrylov_tpu_torch.benchmarks import (chain_solve, dst_precision_probe,
                                               floor_probe, solve_profile, xl8192)
from newtonkrylov_tpu_torch.fftprec import fft_poisson
from newtonkrylov_tpu_torch.problems import bratu2d as tb

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
N = 64


def _jax_floor_probe():
    """The JAX script ``benchmarks/floor_probe.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_floor_probe", ROOT / "benchmarks" / "floor_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_flagship(n, M, refresh, u0=None):
    """The JAX driver on the flagship configuration at n² with ``M``."""
    p = jb.default_config(n, lam=5.0)
    u0 = jb.initial_guess(n, dtype=jnp.float64) if u0 is None else u0
    return nk.newton_krylov_jit(
        jb.residual_scaled, u0, p, algo="cg", tol_rel=1e-8,
        krylov_dtype=jnp.float32, residual_df=jb.residual_scaled_df,
        max_niter=20, M=M, precond_refresh=refresh)


def test_chain_solve_is_the_direct_solve():
    """One chained solve is ``newton_krylov_jit`` from u₀·(1 + 1e-6), bit
    for bit in the state, with its counts; the last of two chained solves
    is the direct solve from u₀·(1 + 2e-6); the checksum sums both."""
    u0 = tb.initial_guess(N, dtype=torch.float64, device="cpu")
    p = tb.default_config(N, lam=5.0)
    f = chain_solve.make_chain_solve(N, fft_poisson(precision="high"), "once")
    kw = chain_solve.flagship_kwargs(fft_poisson(precision="high"), "once")
    one, two = f(u0, 1), f(u0, 2)
    for chain, i in ((one, 1), (two, 2)):
        u, info = nkt.newton_krylov_jit(tb.residual_scaled, u0 * (1.0 + 1e-6 * i),
                                        p, **kw)
        assert torch.equal(chain.u_start, u0 * (1.0 + 1e-6 * i))
        assert torch.equal(chain.u, u)
        assert (chain.info.stats.outer_iterations, chain.info.stats.inner_iterations
                ) == (info.stats.outer_iterations, info.stats.inner_iterations)
        assert bool(chain.info.solved)
    want = one.acc + two.u.sum() + two.info.stats.inner_iterations
    assert torch.equal(two.acc, want)
    with pytest.raises(ValueError):
        f(u0, 0)


def test_marginal_and_the_accepted_tolerance():
    """``marginal`` differences two walls and backs them with a solved
    chain; the returned state's f64 true residual is at most the clamped
    tolerance, and the clamp is the larger of its two parts."""
    u0 = tb.initial_guess(32, dtype=torch.float64, device="cpu")
    f = chain_solve.make_chain_solve(32, fft_poisson(precision="high"), "once")
    m = chain_solve.marginal(f, u0, k_hi=2, repeats=1, warm=False)
    assert m.s >= 0.0 and m.t_hi > 0.0 and m.k_hi == 2
    assert bool(m.chain.info.solved)
    fu, f0 = chain_solve.true_residual(m.chain.u, m.chain.u_start)
    tol, plain, floor = chain_solve.clamped_tol(m.chain.u_start)
    assert tol == max(plain, floor) and 0 < fu <= tol < f0
    with pytest.raises(ValueError):
        chain_solve.marginal(f, u0, k_hi=1)


@pytest.mark.parametrize("tag", xl8192.LANES)
def test_xl8192_lane_matches_jax(tag):
    """Each XL lane at 64² on the CPU (``"pallas"``: K4's plain version)
    against the JAX driver with the same preconditioner: solved, the outer
    count equal and the inner count within two (f32 Krylov: ROADMAP.md
    Queue 3 items 2 and 13); the pallas lane's applies counted."""
    rec = xl8192.run_lane(tag, N, "cpu", timed=False, log=lambda *a: None)
    M, refresh = {"MG-PCG": (j_multigrid2d(), "outer"),
                  "two-grid": (j_two_grid(8, precision="high"), "once"),
                  "two-grid pallas": (j_two_grid(8, precision="high",
                                                 engine="pallas"), "once")}[tag]
    u0 = jb.initial_guess(N, dtype=jnp.float64) * (1.0 + 1e-6)
    _, info = _jax_flagship(N, M, refresh, u0)
    print(tag, rec["outer"], rec["inner"], int(info.stats.outer_iterations),
          int(info.stats.inner_iterations))
    assert rec["solved"] and bool(info.solved)
    assert rec["outer"] == int(info.stats.outer_iterations)
    assert abs(rec["inner"] - int(info.stats.inner_iterations)) <= 2
    assert rec["true_res"] <= rec["tol"]
    assert rec["applies"] == rec["inner"] + rec["outer"]
    assert rec["k4_launches"] == 0  # the CPU runs the plain version


def test_xl8192_run_refuses_the_card_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device cpu"):
        xl8192.run((N,))


@pytest.mark.parametrize("n", [64, 128])
def test_floor_probes_match_the_jax_script(n):
    """The four probes at u₀ and at the plateau state u*, against the JAX
    script's ``probes(n)`` on the same f64 states: within 1e-5 relative.
    The plateau run takes ``max_niter + 1`` outers, and the guard holds:
    floor_estimate(u₀) above the plateau."""
    jprobe = _jax_floor_probe().probes(n)
    u0, u, info, hist = floor_probe.plateau_solve(n, CPU)
    for state in (u0, u):
        got = floor_probe.probes(tdd.df_from_f64(state), n)
        want = {k: float(v) for k, v in
                jprobe(jdd.df_from_f64(jnp.asarray(state.numpy()))).items()}
        for key in ("coh", "chk", "rnd", "jvp"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=key)
        assert got["rnd"] == got["chk"]
    assert info.stats.outer_iterations == floor_probe.MAX_NITER + 1
    assert len(hist) == floor_probe.MAX_NITER + 2
    est = floor_probe.probes(tdd.df_from_f64(u0), n)["jvp"]
    assert est >= min(hist) > 0


def test_floor_probe_signs():
    """The hashed sign has the parity of row + column, as the JAX hash."""
    s = floor_probe.signs("rnd", (5, 7), CPU)
    assert torch.equal(s, floor_probe.signs("chk", (5, 7), CPU))
    assert torch.equal(floor_probe.signs("coh", (2, 3), CPU),
                       torch.ones(2, 3))


def test_solve_profile_reports_every_phase():
    """Every phase reported with a finite host time (the device columns
    "not measured" on the CPU); the flagship's counts equal the JAX
    driver's on entry()'s configuration at 64² from its f32 u₀."""
    rec = solve_profile.run(N, "cpu", reps=1, log=lambda *a: None)
    phases = rec["phases"]
    assert set(phases) == {
        "cast_down", "linearize", "probe_factory", "dst_apply", "cg_iter",
        "cg.matvec", "cg.precond", "cg.dots", "cg.axpys", "cg.read",
        "acceptance_df32", "f64_update", "outer_body"}
    for name, t in phases.items():
        assert math.isfinite(t["host"]) and t["busy"] is None, name
    assert math.isfinite(phases["outer_body"]["host_gc_off"])
    assert rec["sum"]["host"] > 0 and "busy" not in rec["sum"]
    u0 = jb.initial_guess(N, dtype=jnp.float32)
    _, info = nk.newton_krylov_jit(
        jb.residual_scaled, u0, jb.default_config(N, lam=5.0), algo="cg",
        tol_rel=1e-8, krylov_dtype=jnp.float32,
        residual_df=jb.residual_scaled_df, max_niter=20,
        M=j_fft_poisson(precision="high"), precond_refresh="once")
    assert rec["solved"] and bool(info.solved)
    assert rec["counts"] == (int(info.stats.outer_iterations),
                             int(info.stats.inner_iterations))


def test_dst_precision_probe_lanes():
    """The probe's DST lanes at 32² on the CPU: ``"highest"`` and ``"high"``
    are the same products here (equal records), and take the JAX driver's
    outer count with its inner count within two (the JAX probe's lane:
    the DST rebuilt every outer); the single pass (``"default"``) solves
    within the accepted tolerance.  A timed two-grid lane in the single
    pass reports its marginal wall."""
    n = 32
    recs = {r["precision"]: r for r in dst_precision_probe.run(
        (n,), device="cpu", timed=False, log=lambda *a: None)}
    assert set(recs) == set(dst_precision_probe.PRECISIONS)
    same = {"solved", "outer", "inner", "floor_limited", "true_res", "tol",
            "finite"}
    assert ({k: recs["high"][k] for k in same}
            == {k: recs["highest"][k] for k in same})
    u0 = jb.initial_guess(n, dtype=jnp.float64) * (1.0 + 1e-6)
    _, info = _jax_flagship(n, j_fft_poisson(precision="highest"), "outer", u0)
    print({k: (r["outer"], r["inner"]) for k, r in recs.items()},
          int(info.stats.outer_iterations), int(info.stats.inner_iterations))
    assert recs["highest"]["outer"] == int(info.stats.outer_iterations)
    assert abs(recs["highest"]["inner"] - int(info.stats.inner_iterations)) <= 2
    for r in recs.values():
        assert r["solved"] and r["finite"] and r["true_res"] <= r["tol"]
    tg = dst_precision_probe.lane(n, "default", "cpu", "two-grid", k_hi=2,
                                  repeats=1, log=lambda *a: None)
    assert tg["solved"] and tg["true_res"] <= tg["tol"]
    assert tg["marginal_s"] >= 0.0 and tg["k_hi"] == 2


def test_dst_precision_probe_refuses_the_card_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device cpu"):
        dst_precision_probe.run((N,))
