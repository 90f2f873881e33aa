"""The port's line-relaxation preconditioner against the JAX package's:
``thomas_solve``, ``pcr_solve``, ``probe_5point_general``, ``_adi_build``
and ``adi`` (``newtonkrylov_tpu/precond.py``, ``mg.py``).

Inputs are made with numpy from a seed, or are the JAX package's own
configurations handed over as numpy.  Tolerances, all float64: the line
solvers rtol 1e-12; the probe 1e-13 absolute (boundary couplings exactly
zero); an ADI apply rtol 1e-12 with atol 1e-12·max|ref| (XLA:CPU contracts
multiply-adds, ROADMAP.md Queue 3 item 6).  Thomas and PCR round
differently, so each engine is held against the JAX engine of its name.
The ADI(4) convection solve takes the JAX package's outer and inner counts.
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
from newtonkrylov_tpu.problems import convdiff2d as jc
from newtonkrylov_tpu_torch import mg as tmg
from newtonkrylov_tpu_torch import precond as tp
from newtonkrylov_tpu_torch.problems import convdiff2d as tc
from newtonkrylov_tpu_torch.utils import convert

F64, F32 = torch.float64, torch.float32
FULL_GMRES = {"restart": None, "itmax": 300}


def _t(a, dtype=None):
    return convert.state(np.asarray(a), device="cpu", dtype=dtype)


def _params(pj) -> tc.Params:
    return tc.Params(dx=float(pj.dx), c=float(pj.c), b=_t(pj.b))


def _assert_close(got, ref, rtol=1e-12):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _tridiag(shape, seed):
    """Diagonally dominant (dl, d, du, b) with the system index on axis 0."""
    rng = np.random.default_rng(seed)
    dl, du, b = rng.standard_normal((3,) + shape)
    d = 2.5 + np.abs(dl) + np.abs(du) + rng.uniform(0.0, 1.0, shape)
    return dl, d, du, b


def _jax_thomas(axis, dl, d, du, b):
    args = tuple(map(jnp.asarray, (dl, d, du, b)))
    if args[0].ndim == 1:
        return jp.thomas_solve(*args)
    batch = 1 - axis  # the JAX solver is 1-D: vmap it over the batch axis
    return jax.vmap(jp.thomas_solve, in_axes=batch, out_axes=batch)(*args)


@pytest.mark.parametrize("layout", ["single", "axis0", "axis1"])
@pytest.mark.parametrize("n", [1, 2, 7, 33])
def test_line_solvers_match_jax(layout, n):
    """thomas_solve (the JAX one vmapped over the batch) and pcr_solve on
    one system and on a batch of 5 along axis 0 or 1: within rtol 1e-12,
    and each solves the system it was given."""
    shape = (n,) if layout == "single" else (n, 5)
    dl, d, du, b = _tridiag(shape, seed=n)
    axis = 1 if layout == "axis1" else 0
    if axis == 1:
        dl, d, du, b = (x.T for x in (dl, d, du, b))
    ref_thomas = _jax_thomas(axis, dl, d, du, b)
    ref_pcr = jp.pcr_solve(*map(jnp.asarray, (dl, d, du, b)), axis=axis)
    args = tuple(map(_t, (dl, d, du, b)))
    got_thomas = tp.thomas_solve(*args, axis=axis)
    got_pcr = tp.pcr_solve(*args, axis=axis)
    _assert_close(got_thomas, ref_thomas)
    _assert_close(got_pcr, ref_pcr)
    # the residual of the solved systems, system index first
    def systems_first(v):
        return np.moveaxis(v, axis, 0) if v.ndim == 2 else v[:, None]

    lo, di, up, rhs, xs = map(systems_first, (dl, d, du, b, got_pcr.numpy()))
    Ax = di * xs
    Ax[1:] += lo[1:] * xs[:-1]
    Ax[:-1] += up[:-1] * xs[1:]
    np.testing.assert_allclose(Ax, rhs, rtol=0, atol=1e-12 * np.abs(rhs).max())


def test_line_solvers_ignore_unused_couplings():
    """dl[0] and du[-1] are not part of the system: changing them changes
    nothing, on either engine."""
    dl, d, du, b = _tridiag((9, 3), seed=4)
    base = [tp.thomas_solve(*map(_t, (dl, d, du, b))),
            tp.pcr_solve(*map(_t, (dl, d, du, b)))]
    dl[0], du[-1] = 1e3, -1e3
    for got, ref in zip([tp.thomas_solve(*map(_t, (dl, d, du, b))),
                         tp.pcr_solve(*map(_t, (dl, d, du, b)))], base):
        assert torch.equal(got, ref)


def _convdiff_jacobians(n=12, c=25.0, scale=0.7):
    """The convection–diffusion Jacobian at 0.7·u* in both packages."""
    pj = jc.default_config(n, c=c, dtype=jnp.float64)
    us = jc.manufactured_solution(n, jnp.float64) * scale
    return (nk.JacobianOperator(jc.residual_scaled, us, pj),
            nkt.JacobianOperator(tc.residual_scaled, _t(us), _params(pj)))


def test_probe_5point_general_matches_jax():
    """All five fields of the c = 25 Jacobian at n = 12 within 1e-13 of the
    JAX package's; couplings that would leave the grid exactly zero."""
    Jj, Jt = _convdiff_jacobians()
    got = tmg.probe_5point_general(Jt)
    for g, r in zip(got, jmg.probe_5point_general(Jj)):
        assert g.dtype == F64 and g.shape == (12, 12)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-13)
    a0, aip, aim, ajp, ajm = got
    for edge in (aim[0, :], aip[-1, :], ajm[:, 0], ajp[:, -1]):
        assert bool((edge == 0).all())
    assert float(aip[:-1].abs().min()) > 0.1  # interior couplings are real


def test_probe_5point_general_offsets_match_jax():
    """A block's global origin shifts the stripes as in the JAX package."""
    Jj, Jt = _convdiff_jacobians(n=12)
    for g, r in zip(tmg.probe_5point_general(Jt, 1, 2),
                    jmg.probe_5point_general(Jj, 1, 2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-13)


def _general_fields(n, m, seed):
    """A random convection–diffusion-like operator: couplings 1 ± t, the
    diagonal −4 plus a small mass, as numpy arrays."""
    rng = np.random.default_rng(seed)
    ti, tj = rng.uniform(-0.6, 0.6, (2, n, m))
    aip, aim, ajp, ajm = 1 + ti, 1 - ti, 1 + tj, 1 - tj
    aip[-1, :] = aim[0, :] = ajp[:, -1] = ajm[:, 0] = 0.0
    a0 = -4.0 + rng.uniform(0.0, 0.05, (n, m))
    return a0, aip, aim, ajp, ajm


@pytest.mark.parametrize("engine", ["thomas", "pcr"])
@pytest.mark.parametrize("shape", [(32, 32), (24, 40)])
@pytest.mark.parametrize("variant", [{}, {"alpha_frac": 0.05},
                                     {"bounds": (0.02, 8.5)}])
def test_adi_build_matches_jax(engine, shape, variant):
    """``_adi_build``'s apply against the JAX engine of the same name on
    seeded fields and right-hand side: 3 sweeps, the default interval, the
    smoother's clamped one, or a user interval."""
    fields = _general_fields(*shape, seed=sum(shape))
    r = np.random.default_rng(1).standard_normal(shape)
    bounds = variant.get("bounds")
    frac = variant.get("alpha_frac")
    ref = jp._adi_build(tuple(map(jnp.asarray, fields)), 3, bounds, engine,
                        alpha_frac=frac)(jnp.asarray(r))
    got = tp._adi_build(tuple(map(_t, fields)), 3, bounds, engine,
                        alpha_frac=frac)(_t(r))
    assert got.dtype == F64
    _assert_close(got, ref)


def test_adi_factory_matches_jax_on_convdiff():
    """``adi(4)`` built from the probed c = 25 Jacobian (auto engine: Thomas
    on the CPU in both packages), and the sign-mirrored operator gives the
    same apply up to the sign."""
    Jj, Jt = _convdiff_jacobians(n=16)
    r = np.random.default_rng(3).standard_normal((16, 16))
    ref = jp.adi(4)(Jj)(jnp.asarray(r))
    _assert_close(tp.adi(4)(Jt)(_t(r)), ref)
    mirrored = tuple(-c for c in tmg.probe_5point_general(Jt))
    _assert_close(-tp._adi_build(mirrored, 4, None)(_t(r)), ref)


def _count_line_solves(monkeypatch):
    calls = []
    for name in ("thomas_solve", "pcr_solve"):
        real = getattr(tp, name)
        monkeypatch.setattr(tp, name, lambda *a, _n=name, _f=real, **kw:
                            calls.append(_n) or _f(*a, **kw))
    return calls


def test_adi_auto_engine_is_thomas_on_cpu(monkeypatch):
    """On a CPU state ``"auto"`` runs Thomas, as the JAX package does off the
    TPU; ``"pcr"`` and ``"thomas"`` are honoured as asked.  (On a CUDA state
    ``"auto"`` is PCR: tests/test_torch_cuda.py.)"""
    calls = _count_line_solves(monkeypatch)
    _, Jt = _convdiff_jacobians(n=8)
    r = torch.ones((8, 8), dtype=F64)
    for engine, want in (("auto", "thomas_solve"), ("thomas", "thomas_solve"),
                         ("pcr", "pcr_solve")):
        calls.clear()
        tp.adi(2, engine=engine)(Jt)(r)
        assert calls == [want] * 4


def test_adi_stays_in_the_probe_dtype():
    """An f32 Jacobian gives an f32 apply: no f64 scalar promotes the
    Krylov vectors (the JAX package's regression,
    tests/test_convdiff.py:278)."""
    n = 16
    p = tc.default_config(n, c=25.0, dtype=F32, device="cpu")
    J = nkt.JacobianOperator(tc.residual_scaled,
                             tc.initial_guess(n, F32, device="cpu"), p)
    for M in (tp.adi(4)(J), tmg.multigrid2d_general()(J)):
        out = M(torch.ones((n, n), dtype=F32))
        assert out.dtype == F32 and bool(torch.isfinite(out).all())


def test_adi_rejects_bad_and_unported_options():
    with pytest.raises(ValueError, match="sweeps"):
        tp.adi(0)
    with pytest.raises(ValueError, match="engine"):
        tp.adi(engine="cyclic")
    # the sharded form needs a mesh to resolve its axis names against
    n = 8
    J = nkt.JacobianOperator(tc.residual_scaled,
                             tc.initial_guess(n, F32, device="cpu"),
                             tc.default_config(n, c=25.0, dtype=F32, device="cpu"))
    with pytest.raises(RuntimeError, match="no mesh"):
        tp.adi(axis_names=("i", "j"))(J)
    with pytest.raises(ValueError, match="axis"):
        tp.pcr_solve(*map(_t, _tridiag((4, 2), 0)), axis=2)


def test_newton_adi_convdiff_matches_jax():
    """newton_krylov_jit + full GMRES + ADI(4) at c = 25, n = 32, f64,
    exact Newton, tol_rel 1e-10: the JAX driver's outer and inner counts,
    solutions within 1e-10, and the manufactured root reached."""
    n = 32
    pj = jc.default_config(n, c=25.0, dtype=jnp.float64)
    u0 = jc.initial_guess(n, jnp.float64)
    kw = dict(algo="gmres", tol_rel=1e-10, forcing=None, max_niter=15,
              krylov_kwargs=FULL_GMRES)
    uj, ij = nk.newton_krylov_jit(jc.residual_scaled, u0, pj, M=jp.adi(4), **kw)
    ut, it = nkt.newton_krylov_jit(tc.residual_scaled, _t(u0), _params(pj),
                                   M=tp.adi(4), **kw)
    assert bool(it.solved) and bool(ij.solved)
    assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
    assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-10)
    us = tc.manufactured_solution(n, device="cpu")
    assert float((ut - us).abs().max()) < 1e-9
