"""The port's multigrid family against the JAX package's: the transfers
(``_restrict``, ``_prolong``, ``_prolong_bilinear``, ``_restrict_fw``,
``transfer_matmul``), ``_levels_cap``, ``_coarsen_general``, the
``vcycle``/``multigrid2d``, ``multigrid2d_general`` and ``two_grid`` applies
(``newtonkrylov_tpu/mg.py``, ``precond.py``); their Newton solves are in
tests/test_torch_mg_solve.py.

Inputs are made with numpy from a seed, or are the JAX package's own
configurations handed over as numpy.  Tolerances, all float64: transfers
and coarsening 1e-13 absolute (XLA sums a 2×2 window and a product of
three matrices in its own order); preconditioner applies on probed
Jacobians at 32² rtol 1e-11 with atol 1e-11·max|ref|.  The JAX
``engine="pallas"`` runs its kernel in interpret mode, the port's runs K4's
plain version on the CPU.  A JAX apply whose line solves are Thomas scans
runs under ``jax.jit`` (one compile instead of one per scan).
"""

import jax
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


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _exact(got, ref, atol=1e-13):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol)


def _assert_close(got, ref, rtol=1e-11):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


# --- transfers and hierarchy helpers ----------------------------------------

@pytest.mark.parametrize("shape", [(16, 16), (12, 20), (9, 14)])
def test_restrict_and_prolong_match_jax(shape):
    """2×2 block mean (a trailing odd row dropped, as the VALID window does)
    and nearest injection."""
    r = _rand(0, shape)
    _exact(tmg._restrict(_t(r)), jmg._restrict(jnp.asarray(r)))
    e = _rand(1, (shape[0] // 2, shape[1] // 2))
    got = tmg._prolong(_t(e))
    assert torch.equal(got, _t(jmg._prolong(jnp.asarray(e))))


@pytest.mark.parametrize("shape", [(16, 16), (12, 20)])
def test_bilinear_pair_matches_jax(shape):
    """The 9-3-3-1 prolongation and its exact transpose, the full-weighting
    restriction, against the JAX package's (``jax.linear_transpose``)."""
    n, m = shape
    e, r = _rand(2, (n // 2, m // 2)), _rand(3, shape)
    _exact(tmg._prolong_bilinear(_t(e)), jmg._prolong_bilinear(jnp.asarray(e)))
    _exact(tmg._restrict_fw(_t(r)), jmg._restrict_fw(jnp.asarray(r)))
    # adjointness: <P e, r> = 4 <e, R r>
    pe, rr = tmg._prolong_bilinear(_t(e)), tmg._restrict_fw(_t(r))
    np.testing.assert_allclose(float((pe * _t(r)).sum()),
                               4.0 * float((_t(e) * rr).sum()), rtol=1e-12)


@pytest.mark.parametrize("shape", [(32, 32), (16, 24)])
def test_transfer_matmul_matches_jax(shape):
    """``transfer_matmul``'s P and R (and ``_p1``) against the JAX package's
    and against the sliced pair."""
    n, m = shape
    for k in (n, m):
        assert torch.equal(tmg._p1(k, F64, device="cpu"),
                           _t(jmg._p1(k, jnp.float64)))
    Pj, Rj = jmg.transfer_matmul(n, m, jnp.float64)
    Pt, Rt = tmg.transfer_matmul(n, m, F64, device="cpu")
    e, r = _rand(4, (n // 2, m // 2)), _rand(5, shape)
    _exact(Pt(_t(e)), Pj(jnp.asarray(e)))
    _exact(Rt(_t(r)), Rj(jnp.asarray(r)))
    _exact(Pt(_t(e)), tmg._prolong_bilinear(_t(e)).numpy())
    _exact(Rt(_t(r)), tmg._restrict_fw(_t(r)).numpy())


def test_transfer_matmul_refuses_tf32(monkeypatch):
    """The pair needs full float32 products (ROADMAP.md Queue 3 hazard (a))."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="tf32"):
        tmg.transfer_matmul(8, 8, F32, device="cpu")


@pytest.mark.parametrize("shape,min_coarse", [((32, 50), 8), ((32, 32), 8),
                                              ((32, 50), 16), ((30, 50), 8),
                                              ((512, 512), 8), ((7, 7), 2)])
def test_levels_cap_matches_jax(shape, min_coarse):
    assert tmg._levels_cap(shape, min_coarse) == jmg._levels_cap(shape, min_coarse)


def _const_fields(a0, couplings, n=16):
    """(a0, aip, aim, ajp, ajm) as constant n×n fields, numpy."""
    one = np.ones((n, n))
    return tuple(v * one for v in (a0,) + tuple(couplings))


_H2W = 0.7 / 17 ** 2
COARSEN_CASES = {
    # the constant Laplacian + mass coarsens to its 2h rediscretization
    "laplacian-anchor": _const_fields(-4.0 + _H2W, (1, 1, 1, 1)),
    # convection doubles per level: s ± t → s ± 2t
    "convection": _const_fields(-4.0, (1.2, 0.8, 1, 1)),
    # the exact sign-mirror (positive diagonal, negative couplings)
    "sign-mirror": _const_fields(4.0 - _H2W, (-1, -1, -1, -1)),
    # shift-dominated: diagonal +2 with the couplings still positive
    "shift-dominated": _const_fields(2.0, (1, 1, 1, 1)),
    # pure convection along i: its symmetric part's mean is exactly zero,
    # so the clamp falls back to the diagonal's mirror
    "zero-mean-coupling": _const_fields(-4.0, (0.5, -0.5, 1, 1)),
}


@pytest.mark.parametrize("case", list(COARSEN_CASES))
def test_coarsen_general_matches_jax(case):
    """``_coarsen_general`` (physical-parts split and the sign-aware upwind
    clamp ``_sgn``) on the cases of tests/test_mg.py, within 1e-13."""
    fields = COARSEN_CASES[case]
    ref = jmg._coarsen_general(tuple(map(jnp.asarray, fields)))
    got = tmg._coarsen_general(tuple(map(_t, fields)))
    for g, r in zip(got, ref):
        _exact(g, r)
    if case == "sign-mirror":  # coarsening commutes with the global sign flip
        neg = tmg._coarsen_general(tuple(_t(-f) for f in fields))
        for g, gn in zip(got, neg):
            _exact(g, (-gn).numpy(), atol=1e-12)
            assert float(g.abs().max()) > 0.5  # couplings survived


def test_coarsen_general_matches_jax_on_random_fields():
    """Variable coefficients over three levels of coarsening."""
    rng = np.random.default_rng(6)
    t = rng.uniform(-2.0, 2.0, (2, 32, 32))
    fields = (-4.0 + rng.uniform(0, 0.1, (32, 32)), 1 + t[0], 1 - t[0],
              1 + t[1], 1 - t[1])
    got, ref = tuple(map(_t, fields)), tuple(map(jnp.asarray, fields))
    for _ in range(3):
        got, ref = tmg._coarsen_general(got), jmg._coarsen_general(ref)
        for g, r in zip(got, ref):
            _exact(g, r, atol=1e-12)


# --- preconditioner applies on probed Jacobians at 32² -----------------------

@pytest.fixture(scope="module")
def bratu_jacobians():
    pj = jb.default_config(N, lam=5.0)
    u = np.asarray(jb.initial_guess(N)) + 0.05 * _rand(7, (N, N))
    return (nk.JacobianOperator(jb.residual_scaled, jnp.asarray(u), pj),
            nkt.JacobianOperator(tb.residual_scaled, _t(u), convert.params(pj)))


@pytest.fixture(scope="module")
def convdiff_jacobians():
    pj = jc.default_config(N, c=25.0, dtype=jnp.float64)
    us = jc.manufactured_solution(N, jnp.float64) * 0.7
    return (nk.JacobianOperator(jc.residual_scaled, us, pj),
            nkt.JacobianOperator(tc.residual_scaled, _t(us), _cd_params(pj)))


def test_vcycle_matches_jax(bratu_jacobians):
    """``_build_levels`` and one ``vcycle`` on the probed Bratu Jacobian."""
    Jj, Jt = bratu_jacobians
    lj = jmg._build_levels(*jmg.probe_5point(Jj), 3)
    lt = tmg._build_levels(*tmg.probe_5point(Jt), 3)
    for a, b in zip(lt, lj):
        _exact(a.d, b.d)
        np.testing.assert_allclose(float(a.o), float(b.o), rtol=1e-13)
    r = _rand(8, (N, N))
    _assert_close(tmg.vcycle(_t(r), lt), jmg.vcycle(jnp.asarray(r), lj))


@pytest.mark.parametrize("kw", [{}, {"n_levels": 2, "cycles": 2, "nu": 1}])
def test_multigrid2d_apply_matches_jax(bratu_jacobians, kw):
    Jj, Jt = bratu_jacobians
    r = _rand(9, (N, N))
    _assert_close(tmg.multigrid2d(**kw)(Jt)(_t(r)),
                  jmg.multigrid2d(**kw)(Jj)(jnp.asarray(r)))


@pytest.mark.parametrize("kw", [{}, {"n_levels": 1, "bounds": (0.01, 8.0)},
                                {"cycles": 2, "nu": 1, "engine": "pcr"}])
def test_multigrid2d_general_apply_matches_jax(convdiff_jacobians, kw):
    """The MG-general apply on the probed c = 25 Jacobian: the default
    hierarchy (3 levels, Thomas on the CPU in both packages), a single
    level with user bounds, and two V(1,1) cycles on PCR."""
    Jj, Jt = convdiff_jacobians
    r = _rand(10, (N, N))
    ref = jmg.multigrid2d_general(**kw)(Jj)
    if kw.get("engine") != "pcr":
        ref = jax.jit(ref)
    _assert_close(tmg.multigrid2d_general(**kw)(Jt)(_t(r)), ref(jnp.asarray(r)))


def test_multigrid2d_general_nonsquare_level_cap():
    """(32, 50) coarsens once and stops (25 is odd); the apply matches."""
    n, m = 32, 50
    dx = 1.0 / (n + 1)

    def F(u, p):
        up = p.pad(u)
        s = up[2:, 1:-1] + up[:-2, 1:-1] + up[1:-1, 2:] + up[1:-1, :-2]
        return s - 4.0 * u + dx * dx * p.exp(u)

    class J:  # the residual for either package
        pad, exp = staticmethod(lambda u: jnp.pad(u, 1)), staticmethod(jnp.exp)

    class T:
        pad = staticmethod(lambda u: torch.nn.functional.pad(u, (1, 1, 1, 1)))
        exp = staticmethod(torch.exp)

    r = _rand(11, (n, m))
    ref = jax.jit(jmg.multigrid2d_general()(
        nk.JacobianOperator(F, jnp.zeros((n, m)), J)))(jnp.asarray(r))
    got = tmg.multigrid2d_general()(
        nkt.JacobianOperator(F, torch.zeros((n, m), dtype=F64), T))(_t(r))
    assert got.shape == (n, m)
    _assert_close(got, ref)


@pytest.mark.parametrize("transfer", ["matmul", "bilinear", "nearest"])
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_two_grid_apply_matches_jax(bratu_jacobians, engine, transfer):
    """two_grid(4) with each smoother engine and transfer against the JAX
    factory with the same options (the port's "pallas" runs K4's plain
    version, the JAX one its kernel in interpret mode)."""
    Jj, Jt = bratu_jacobians
    r = _rand(12, (N, N))
    kw = dict(engine=engine, transfer=transfer)
    _assert_close(tp.two_grid(4, **kw)(Jt)(_t(r)),
                  jp.two_grid(4, **kw)(Jj)(jnp.asarray(r)))


def test_two_grid_symmetric(bratu_jacobians):
    """S and A symmetric and P ∝ Rᵀ: M is symmetric (tests/test_twogrid.py)."""
    _, Jt = bratu_jacobians
    M = tp.two_grid(4)(Jt)
    r1, r2 = _t(_rand(13, (N, N))), _t(_rand(14, (N, N)))
    np.testing.assert_allclose(float((r1 * M(r2)).sum()),
                               float((M(r1) * r2).sum()), rtol=1e-11)


def test_two_grid_runs_k4_once_per_smoothing(monkeypatch, bratu_jacobians):
    """``engine="pallas"`` routes each of the two smoothings of an apply
    through K4's op (its plain version on the CPU)."""
    calls = []
    real = tp.K.chebyshev_apply
    monkeypatch.setattr(tp.K, "chebyshev_apply",
                        lambda *a: calls.append(a[3:]) or real(*a))
    _, Jt = bratu_jacobians
    tp.two_grid(8, engine="pallas")(Jt)(_t(_rand(15, (N, N))))
    assert calls == [(N, 8), (N, 8)]


def test_mg_rejects_bad_and_unported_options(bratu_jacobians):
    _, Jt = bratu_jacobians
    for factory in (tmg.multigrid2d, tmg.multigrid2d_general):
        # the sharded forms resolve their axis names against a mesh
        with pytest.raises(RuntimeError, match="no mesh"):
            factory(axis_names=("i", "j"))(Jt)
    with pytest.raises(ValueError, match="engine"):
        tmg.multigrid2d_general(engine="cyclic")
    for bad in ({"nu": 0}, {"smoother_sweeps": 0}, {"coarse_sweeps": 0},
                {"cycles": 0}):
        with pytest.raises(ValueError, match=">= 1"):
            tmg.multigrid2d_general(**bad)
    with pytest.raises(ValueError, match="transfer"):
        tp.two_grid(transfer="cubic")
    with pytest.raises(ValueError, match="engine"):
        tp.two_grid(engine="mosaic")
    odd = nkt.JacobianOperator(tb.residual_scaled, torch.zeros((9, 9), dtype=F64),
                               tb.default_config(9, 5.0))
    with pytest.raises(ValueError, match="even"):
        tp.two_grid()(odd)
