"""The port's SBP/DG operators against ``newtonkrylov_tpu.ops.sbp`` (bit for
bit: the construction is a copy of the same numpy code), the SBP
identities of tests/test_sbp.py, and the DG and upwind heat marches
(``TestHeatDGMarch``) against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu.ops import sbp as jsbp
from newtonkrylov_tpu.problems import heat1d_dg as jdg
from newtonkrylov_tpu_torch.ops import sbp as tsbp
from newtonkrylov_tpu_torch.problems import heat1d_dg as tdg
from newtonkrylov_tpu_torch.utils import convert as cv

F64 = torch.float64


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_upwind_operators_bitwise(order):
    Dj = jsbp.periodic_upwind_operators(37, 0.027, order)
    Dt = tsbp.periodic_upwind_operators(37, 0.027, order, device="cpu")
    for a, b in zip(Dj, Dt):
        _same(a, b)
        assert b.dtype == F64 and b.device.type == "cpu"


@pytest.mark.parametrize("N", [2, 3, 4, 6])
def test_legendre_operator_bitwise(N):
    for a, b in zip(jsbp.legendre_derivative_operator(N),
                    tsbp.legendre_derivative_operator(N)):
        _same(a, b)


@pytest.mark.parametrize("mode", ["minus", "plus", "central"])
def test_couple_discontinuously_bitwise(mode):
    local = jsbp.legendre_derivative_operator(4)
    xj, Dj = jsbp.couple_discontinuously(local, jsbp.UniformPeriodicMesh1D(0.0, 1.0, 9), mode)
    xt, Dt = tsbp.couple_discontinuously(tsbp.legendre_derivative_operator(4),
                                         tsbp.UniformPeriodicMesh1D(0.0, 1.0, 9), mode,
                                         device="cpu")
    _same(xj, xt)
    _same(Dj, Dt)
    x32, D32 = tsbp.couple_discontinuously(tsbp.legendre_derivative_operator(4),
                                           tsbp.UniformPeriodicMesh1D(0.0, 1.0, 9), mode,
                                           dtype=torch.float32, device="cpu")
    assert D32.dtype == torch.float32 and torch.equal(D32, Dt.float())


def test_unknown_coupling_mode_raises():
    with pytest.raises(ValueError, match="unknown coupling mode"):
        tsbp.couple_discontinuously(tsbp.legendre_derivative_operator(3),
                                    tsbp.UniformPeriodicMesh1D(0.0, 1.0, 4), "left",
                                    device="cpu")


# -- the SBP identities (tests/test_sbp.py) ------------------------------------


@pytest.mark.parametrize("order", [1, 2, 3])
def test_upwind_accuracy_adjoint_and_nsd(order):
    """Accuracy on a smooth periodic function, D₊ = −D₋ᵀ, and D₋D₊
    symmetric negative semidefinite."""
    n = 128
    dx = 1.0 / n
    Dm, Dp = tsbp.periodic_upwind_operators(n, dx, order, device="cpu")
    x = torch.arange(n, dtype=F64) * dx
    u = torch.sin(2 * np.pi * x)
    du = 2 * np.pi * torch.cos(2 * np.pi * x)
    for D in (Dm, Dp):
        assert float((D @ u - du).abs().max()) < 500.0 * dx ** order
    assert torch.equal(Dp, -Dm.T)
    lap = (Dm @ Dp).numpy()
    np.testing.assert_allclose(lap, lap.T, atol=1e-10)
    assert np.linalg.eigvalsh(lap).max() < 1e-8


def test_lgl_exactness_and_sbp_property():
    """D exact on polynomials of degree < N; M D + (M D)ᵀ = diag(−1, 0, …, 1)."""
    x, w, D = tsbp.legendre_derivative_operator(4)
    for k in range(4):
        dp = k * x ** max(k - 1, 0) if k > 0 else np.zeros_like(x)
        np.testing.assert_allclose(D @ x ** k, dp, atol=1e-12)
    x, w, D = tsbp.legendre_derivative_operator(5)
    Q = np.diag(w) @ D
    B = np.zeros_like(Q)
    B[0, 0], B[-1, -1] = -1.0, 1.0
    np.testing.assert_allclose(Q + Q.T, B, atol=1e-12)


def test_dg_operators_differentiate_annihilate_and_are_stable():
    """The coupled DG operators differentiate a smooth periodic function,
    annihilate constants in every mode, and D₋D₊ is negative
    semidefinite in the M inner product."""
    local = tsbp.legendre_derivative_operator(4)
    mesh = tsbp.UniformPeriodicMesh1D(0.0, 1.0, 16)
    x, Dm = tsbp.couple_discontinuously(local, mesh, "minus", device="cpu")
    _, Dp = tsbp.couple_discontinuously(local, mesh, "plus", device="cpu")
    u = torch.sin(2 * np.pi * x)
    for D in (Dm, Dp):
        assert float((D @ u - 2 * np.pi * torch.cos(2 * np.pi * x)).abs().max()) < 0.2
    for mode in ("minus", "plus", "central"):
        _, D = tsbp.couple_discontinuously(local, tsbp.UniformPeriodicMesh1D(0.0, 1.0, 8),
                                           mode, device="cpu")
        assert float((D @ torch.ones(D.shape[0], dtype=F64)).abs().max()) < 1e-11
    p = tdg.dg_config(polydeg=3, elements=12, device="cpu")
    _, w, _ = tsbp.legendre_derivative_operator(4)
    mg = np.tile(w * (1.0 / 12) / 2.0, 12)
    MLap = mg[:, None] * (p.D1m @ p.D1p).numpy()
    assert np.linalg.eigvalsh(0.5 * (MLap + MLap.T)).max() < 1e-8


# -- the DG and upwind heat marches (TestHeatDGMarch) ------------------------


@pytest.mark.parametrize("cfg", ["dg", "upwind"])
def test_heat_march_decays_and_matches_jax(cfg):
    """Backward Euler through the operator composition, Δt = 0.01 to t = 0.2
    (the DG configuration at 16 elements, the upwind one at 120 nodes): no
    failed step, decay, and the JAX package's final state within 1e-6 (the
    packages' GMRES counts part in later steps, ROADMAP.md Queue 3 item 18;
    measured 2e-7; 20 steps × the march's tol_abs 6e-6 bound the
    accumulated acceptance error at 1.2e-4, ‖J⁻¹‖ ≤ 1)."""
    if cfg == "dg":
        pj = jdg.dg_config(polydeg=3, elements=16)
    else:
        pj = jdg.upwind_config(nnodes=120, accuracy_order=3)
    pt = cv.heat1d_dg_params(pj, device="cpu")
    u0 = np.asarray(jdg.initial_condition(pj))
    rj = nk.integrate("euler", jdg.rhs, jnp.asarray(u0), pj, 0.01, 0.2)
    rt = nkt.integrate("euler", tdg.rhs, torch.tensor(u0), pt, 0.01, 0.2)
    assert rt.n_failed == int(rj.n_failed) == 0
    assert float(torch.linalg.vector_norm(rt.u)) < float(np.linalg.norm(u0))
    assert bool(torch.isfinite(rt.u).all())
    assert float(np.abs(rt.u.numpy() - np.asarray(rj.u)).max()) < 1e-6
