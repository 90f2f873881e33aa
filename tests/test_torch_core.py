"""Parity of the PyTorch port's core modules with the JAX package.

tree / spaces / operator / forcing / solvers.cg: the same inputs, made with
numpy from a seed, go through the JAX function and its counterpart in
``newtonkrylov_tpu_torch``.  Everything runs in float64 on the CPU; tolerances
are stated per test (reductions are summed in different orders, so values
agree to a few ulps of f64, not bitwise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu.forcing as jforcing
import newtonkrylov_tpu.spaces as jspaces
import newtonkrylov_tpu.tree as jtree
import newtonkrylov_tpu_torch as nkt
import newtonkrylov_tpu_torch.forcing as tforcing
import newtonkrylov_tpu_torch.spaces as tspaces
import newtonkrylov_tpu_torch.tree as ttree
from newtonkrylov_tpu.problems import bratu2d as jb
from newtonkrylov_tpu_torch import df32 as tdf32
from newtonkrylov_tpu_torch import fftprec as tfft
from newtonkrylov_tpu_torch import solvers as tsolvers
from newtonkrylov_tpu_torch.df32 import DF
from newtonkrylov_tpu_torch.kernels import stencil2d as tk
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.utils import convert

F64 = torch.float64
RTOL = 1e-13  # f64 reductions in different summation orders


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(a, dtype=F64):
    return convert.state(a, device="cpu", dtype=dtype)


# -- tree ---------------------------------------------------------------------

@pytest.mark.parametrize("pair", [False, True], ids=["tensor", "DF-pair"])
def test_tree_ops_match_jax(pair):
    a, b = _np(0, (6, 5)), _np(1, (6, 5))
    if pair:
        a2, b2 = _np(2, (6, 5)), _np(3, (6, 5))
        xj, yj = (jnp.asarray(a), jnp.asarray(a2)), (jnp.asarray(b), jnp.asarray(b2))
        xt, yt = DF(_t(a), _t(a2)), DF(_t(b), _t(b2))
    else:
        xj, yj, xt, yt = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    np.testing.assert_allclose(float(ttree.tree_vdot(xt, yt)),
                               float(jtree.tree_vdot(xj, yj)), rtol=RTOL)
    np.testing.assert_allclose(float(ttree.tree_norm(xt)),
                               float(jtree.tree_norm(xj)), rtol=RTOL)
    for got, ref in zip(ttree.tree_leaves(ttree.tree_axpy(0.3, xt, yt)),
                        jnp_leaves(jtree.tree_axpy(0.3, xj, yj))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(ttree.tree_leaves(ttree.tree_sub(xt, yt)),
                        jnp_leaves(jtree.tree_sub(xj, yj))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    sel = ttree.tree_where(torch.tensor(False), xt, yt)
    assert all(torch.equal(s, y) for s, y in zip(ttree.tree_leaves(sel),
                                                  ttree.tree_leaves(yt)))
    assert ttree.tree_size(xt) == jtree.tree_size(xj)
    assert ttree.tree_dtype(xt) == F64
    z = ttree.tree_zeros_like(xt)
    assert type(z) is type(xt) and all(float(l.abs().sum()) == 0
                                       for l in ttree.tree_leaves(z))


def jnp_leaves(x):
    return list(x) if isinstance(x, tuple) else [x]


# -- spaces -------------------------------------------------------------------

def test_euclidean_space_matches_jax():
    x, y = _np(4, (8, 8)), _np(5, (8, 8))
    js, ts = jspaces.EuclideanSpace(), tspaces.EuclideanSpace()
    np.testing.assert_allclose(float(ts.dot(_t(x), _t(y))),
                               float(js.dot(jnp.asarray(x), jnp.asarray(y))), rtol=RTOL)
    np.testing.assert_allclose(float(ts.norm(_t(x))),
                               float(js.norm(jnp.asarray(x))), rtol=RTOL)
    assert ts.size_multiplier() == js.size_multiplier() == 1
    assert ts.mask_tree(_t(x)) is not None


@pytest.mark.parametrize("vec_dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32-against-f64-mask"])
def test_masked_space_matches_jax(vec_dtype):
    mask = (np.random.default_rng(6).random((8, 8)) > 0.3).astype(np.float64)
    x, y, z = _np(7, (8, 8)), _np(8, (8, 8)), _np(9, (8, 8))
    jdt = jnp.float64 if vec_dtype == F64 else jnp.float32
    js = jspaces.MaskedSpace(jnp.asarray(mask))
    ts = convert.masked_space(mask, device="cpu", dtype=F64)
    xj, yj, zj = (jnp.asarray(a, jdt) for a in (x, y, z))
    xt, yt, zt = (_t(a, vec_dtype) for a in (x, y, z))
    rtol = RTOL if vec_dtype == F64 else 1e-6  # f32 sums in different orders
    np.testing.assert_allclose(float(ts.dot(xt, yt)), float(js.dot(xj, yj)), rtol=rtol)
    np.testing.assert_allclose(float(ts.norm(xt)), float(js.norm(xj)), rtol=rtol)
    np.testing.assert_allclose(ts.dot2(xt, yt, yt, zt).numpy(),
                               np.asarray(js.dot2(xj, yj, yj, zj)), rtol=rtol)
    np.testing.assert_allclose(ts.dot_stack([(xt, yt), (zt, zt), (xt, zt)]).numpy(),
                               np.asarray(js.dot_stack([(xj, yj), (zj, zj), (xj, zj)])),
                               rtol=rtol)
    masked = ts.mask_tree(xt)
    assert masked.dtype == vec_dtype
    np.testing.assert_array_equal(masked.numpy(), np.asarray(js.mask_tree(xj)))


# -- operator -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jac_pair():
    n = 12
    u = 0.3 * _np(10, (n, n))
    pj = jb.default_config(n, lam=4.0)
    Jj = nk.JacobianOperator(jb.residual_scaled, jnp.asarray(u), pj)
    Jt = nkt.JacobianOperator(tb.residual_scaled, _t(u), convert.params(pj))
    return n, Jj, Jt


def test_jacobian_operator_primal_and_mv(jac_pair):
    n, Jj, Jt = jac_pair
    np.testing.assert_allclose(Jt.res.numpy(), np.asarray(Jj.res), rtol=0, atol=1e-15)
    v = _np(11, (n, n))
    np.testing.assert_allclose(Jt.mv(_t(v)).numpy(), np.asarray(Jj.mv(jnp.asarray(v))),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(Jt(_t(v)).numpy(), Jt.mv(_t(v)).numpy(), rtol=0, atol=0)
    assert Jt.shape == Jj.shape and Jt.dtype == F64


def test_jacobian_operator_mm_matches_jax(jac_pair):
    n, Jj, Jt = jac_pair
    V = _np(12, (3, n, n))
    np.testing.assert_allclose(Jt.mm(_t(V)).numpy(), np.asarray(Jj.mm(jnp.asarray(V))),
                               rtol=0, atol=1e-14)


def test_jacobian_replay_is_linear_and_reusable(jac_pair):
    n, _, Jt = jac_pair
    a, b = _t(_np(13, (n, n))), _t(_np(14, (n, n)))
    lhs = Jt.mv(2.0 * a + b)
    rhs = 2.0 * Jt.mv(a) + Jt.mv(b)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=0, atol=1e-13)


# -- forcing ------------------------------------------------------------------

_EW_CASES = [  # (eta, tol, n_res, n_res_prior): both safeguard branches + floor
    (0.999, 1e-8, 0.5, 1.0),
    (0.2, 1e-8, 0.01, 1.0),
    (0.9, 1e-8, 0.9, 1.0),
    (0.5, 1e-3, 1e-3, 1e-2),
    (0.01, 1e-6, 1e-7, 1e-4),
]


@pytest.mark.parametrize("case", _EW_CASES)
def test_eisenstat_walker_matches_jax(case):
    fj, ft = jforcing.EisenstatWalker(), tforcing.EisenstatWalker()
    ref = float(fj(*(jnp.asarray(c) for c in case)))
    got = ft(*(torch.tensor(c, dtype=F64) for c in case))
    assert got.dtype == F64
    assert float(got) == ref
    assert ft.host_update(*case) == fj.host_update(*case)
    assert ft.initial() == fj.initial()


def test_fixed_forcing_matches_jax():
    ft, fj = tforcing.Fixed(0.25), jforcing.Fixed(0.25)
    got = ft(None, None, torch.tensor(1.0, dtype=torch.float32), None)
    assert got.dtype == torch.float32 and float(got) == 0.25
    assert ft.initial() == fj.initial() == ft.host_update(0, 0, 0, 0)


# -- cg -----------------------------------------------------------------------

def _spd(n, seed, sign=1.0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = sign * (A @ A.T + n * np.eye(n))
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["spd", "negative-definite"])
@pytest.mark.parametrize("precond", [False, True], ids=["plain", "jacobi"])
def test_cg_matches_jax(sign, precond):
    A, b = _spd(30, 20, sign)
    dinv = 1.0 / np.diag(A)
    Aj, Mj = jnp.asarray(A), jnp.asarray(dinv)
    At, Mt = _t(A), _t(dinv)
    kw_j = dict(rtol=1e-10, atol=0.0)
    rj = nk.cg(lambda v: Aj @ v, jnp.asarray(b),
               M=(lambda r: Mj * r) if precond else None, **kw_j)
    rt = tsolvers.cg(lambda v: At @ v, _t(b),
                     M=(lambda r: Mt * r) if precond else None, **kw_j)
    assert bool(rt.converged) and not bool(rt.breakdown)
    assert rt.niter == int(rj.niter)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10)
    np.testing.assert_allclose(float(rt.residual), float(rj.residual), rtol=1e-6)


def test_cg_tensor_rtol_and_itmax():
    """rtol as a 0-d tensor (the Newton forcing seam) and the itmax cap."""
    A, b = _spd(25, 21)
    At = _t(A)
    eta = torch.tensor(1e-3, dtype=F64)
    rt = tsolvers.cg(lambda v: At @ v, _t(b), rtol=eta, atol=0.0)
    rj = nk.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), rtol=jnp.asarray(1e-3), atol=0.0)
    assert rt.niter == int(rj.niter)
    capped = tsolvers.cg(lambda v: At @ v, _t(b), rtol=1e-14, atol=0.0, itmax=3)
    assert capped.niter == 3 and not bool(capped.converged)


def test_cg_breakdown_flag():
    b = _t(_np(22, 10))
    res = tsolvers.cg(lambda v: torch.zeros_like(v), b, rtol=1e-8, atol=0.0)
    assert bool(res.breakdown) and res.niter == 1


def test_solve_dispatch():
    A, b = _spd(10, 23)
    At = _t(A)
    res = tsolvers.solve("cg", lambda v: At @ v, _t(b), rtol=1e-10, atol=0.0,
                         not_an_option=1)
    assert bool(res.converged)
    assert tsolvers.available_algos() == ["cg"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsolvers.solve("gmres", lambda v: v, _t(b))
    with pytest.raises(ValueError, match="unknown algo"):
        tsolvers.solve("qmr", lambda v: v, _t(b))
    with pytest.raises(NotImplementedError, match="pipelined"):
        tsolvers.cg(lambda v: v, _t(b), pipeline=True)


# -- default device ---------------------------------------------------------

_ENTRY_POINTS = {  # name -> call without a device, returning the tensors made
    "grid": lambda: list(tb.grid(8)),
    "initial_guess": lambda: [tb.initial_guess(8)],
    "aligned_setup": lambda: [(s := tb.aligned_setup(8))[0], s[2].mask],
    "aligned_mask": lambda: [tk.aligned_mask(8)],
    "sine_basis": lambda: [tfft.sine_basis(8)],
    "selfcheck": lambda: tdf32.selfcheck(),
}


@pytest.mark.parametrize("name", list(_ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Called without a device, each entry point creates its tensors on CUDA;
    where there is no CUDA it raises as PyTorch does, with no CPU fallback:
    "Torch not compiled with CUDA enabled" from a CPU-only build, "Found no
    NVIDIA driver" from a CUDA build on a host without a driver."""
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA|NVIDIA"):
            _ENTRY_POINTS[name]()
        return
    out = _ENTRY_POINTS[name]()
    if name == "selfcheck":  # ran its transforms on the card
        assert out is True
    else:
        assert out and all(t.device.type == "cuda" for t in out)
