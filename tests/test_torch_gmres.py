"""The port's GMRES / FGMRES against the JAX package's, in float64.

The cases of tests/test_solvers.py (dense, restarted, rtol termination, MGS
and CGS2, left and right preconditioners, FGMRES with an inner GMRES,
a tuple state, the zero right-hand side, the blocked CGS2 projection and a
masked space), each run through both packages on the same numpy inputs.
In float64 the step count, ``converged`` and ``breakdown`` must be equal and
the solutions agree to rtol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu.spaces import MaskedSpace as JMaskedSpace
from newtonkrylov_tpu_torch import solvers as tsolvers
from newtonkrylov_tpu_torch.spaces import MaskedSpace as TMaskedSpace

F64 = torch.float64


def random_system(n, seed=0, spd=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n) if spd else A + n * np.eye(n)
    x_true = rng.standard_normal(n)
    return A, A @ x_true, x_true


def _ops(A):
    """(JAX operator, torch operator) applying the same matrix."""
    Aj, At = jnp.asarray(A), torch.tensor(A, dtype=F64)
    return (lambda v: Aj @ v), (lambda v: At @ v)


def _assert_same(rt, rj, rtol=1e-10):
    assert rt.niter == int(rj.niter)
    assert bool(rt.converged) == bool(rj.converged)
    assert bool(rt.breakdown) == bool(rj.breakdown)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=rtol,
                               atol=rtol * float(np.abs(xj).max() or 1.0))


def _both(name, A, b, *, M=None, N=None, **kw):
    """Run ``name`` (gmres or fgmres) of both packages on A x = b; M and N
    given as matrices applied as left / right preconditioners."""
    oj, ot = _ops(A)
    kj, kt = dict(kw), dict(kw)
    if M is not None:
        kj["M"], kt["M"] = _ops(M)
    if N is not None:
        kj["N"], kt["N"] = _ops(N)
    rj = getattr(nk, name)(oj, jnp.asarray(b), **kj)
    rt = getattr(nkt.solvers, name)(ot, torch.tensor(b, dtype=F64), **kt)
    return rt, rj


@pytest.mark.parametrize("case", [
    "dense", "restarted", "rtol", "left_precond", "right_precond"])
def test_gmres_matches_jax(case):
    if case == "dense":
        A, b, x = random_system(40, seed=1)
        rt, rj = _both("gmres", A, b, restart=40, rtol=1e-12, atol=1e-12)
    elif case == "restarted":
        A, b, x = random_system(60, seed=2, spd=True)
        rt, rj = _both("gmres", A, b, restart=15, rtol=1e-10, atol=1e-12, itmax=600)
    elif case == "rtol":
        A, b, x = random_system(50, seed=3)
        rt, rj = _both("gmres", A, b, restart=50, rtol=1e-2, atol=0.0)
        r = b - A @ rt.x.numpy()
        assert np.linalg.norm(r) <= 1e-2 * np.linalg.norm(b) * (1 + 1e-10)
        assert rt.niter < 50
    else:
        A, b, x = random_system(40, seed=5 if case == "left_precond" else 6, spd=True)
        P = np.linalg.inv(A)
        kw = {"M": P} if case == "left_precond" else {"N": P}
        rt, rj = _both("gmres", A, b, restart=10, rtol=1e-10, **kw)
        assert rt.niter <= 2
    _assert_same(rt, rj)
    if case != "rtol":
        assert bool(rt.converged)
        np.testing.assert_allclose(rt.x.numpy(), x, rtol=1e-6)


@pytest.mark.parametrize("orth,reorth", [("cgs2", False), ("cgs2", True),
                                         ("mgs", False), ("mgs", True)])
def test_orthogonalization_matches_jax(orth, reorth):
    A, b, _ = random_system(30, seed=4)
    rt, rj = _both("gmres", A, b, restart=30, rtol=1e-10, orth=orth,
                   reorthogonalize=reorth)
    _assert_same(rt, rj)
    assert bool(rt.converged)


def test_mgs_and_cgs2_agree():
    A, b, _ = random_system(30, seed=4)
    _, ot = _ops(A)
    bt = torch.tensor(b, dtype=F64)
    r1 = tsolvers.gmres(ot, bt, restart=30, rtol=1e-10, orth="cgs2")
    r2 = tsolvers.gmres(ot, bt, restart=30, rtol=1e-10, orth="mgs")
    assert abs(r1.niter - r2.niter) <= 1
    np.testing.assert_allclose(r1.x.numpy(), r2.x.numpy(), rtol=1e-6)


def test_fgmres_nested_gmres_matches_jax():
    """FGMRES whose right preconditioner is an inner GMRES(5) solve."""
    A, b, x_true = random_system(50, seed=7, spd=True)
    oj, ot = _ops(A)
    rj = nk.fgmres(oj, jnp.asarray(b), restart=20, rtol=1e-10,
                   N=lambda r: nk.gmres(oj, r, restart=5, itmax=5, rtol=1e-1).x)
    rt = nkt.solvers.fgmres(
        ot, torch.tensor(b, dtype=F64), restart=20, rtol=1e-10,
        N=lambda r: nkt.solvers.gmres(ot, r, restart=5, itmax=5, rtol=1e-1).x)
    _assert_same(rt, rj)
    assert bool(rt.converged)
    np.testing.assert_allclose(rt.x.numpy(), x_true, rtol=1e-5)


def test_tuple_state_matches_jax():
    """A two-leaf state (a dict in JAX, a tuple here): one basis per leaf."""
    A, b, x_true = random_system(32, seed=12, spd=True)
    Aj, At = jnp.asarray(A), torch.tensor(A, dtype=F64)

    def opj(v):
        out = Aj @ jnp.concatenate([v["p"], v["q"]])
        return {"p": out[:16], "q": out[16:]}

    def opt(v):
        out = At @ torch.cat(v)
        return (out[:16], out[16:])

    rj = nk.gmres(opj, {"p": jnp.asarray(b[:16]), "q": jnp.asarray(b[16:])},
                  restart=32, rtol=1e-11)
    bt = torch.tensor(b, dtype=F64)
    rt = nkt.solvers.gmres(opt, (bt[:16], bt[16:]), restart=32, rtol=1e-11)
    assert rt.niter == int(rj.niter) and bool(rt.converged) and bool(rj.converged)
    np.testing.assert_allclose(torch.cat(rt.x).numpy(),
                               np.concatenate([rj.x["p"], rj.x["q"]]), rtol=1e-10)
    np.testing.assert_allclose(torch.cat(rt.x).numpy(), x_true, rtol=1e-7)


def test_zero_rhs_short_circuits():
    A, _, _ = random_system(10, seed=13)
    rt, rj = _both("gmres", A, np.zeros(10))
    _assert_same(rt, rj)
    assert bool(rt.converged) and rt.niter == 0
    assert float(rt.x.abs().max()) == 0.0


def test_singular_system_breaks_down_like_jax():
    """An inconsistent singular system: the dependent Krylov direction is
    excluded and ends the solve, in both packages at the same step."""
    A = np.diag([1.0, 2.0, 3.0, 0.0, 5.0, 6.0])
    b = np.ones(6)
    rt, rj = _both("gmres", A, b, restart=6, rtol=1e-12, atol=0.0)
    _assert_same(rt, rj)
    assert bool(rt.breakdown) and not bool(rt.converged)


@pytest.mark.parametrize("restart,block", [(None, 16), (40, 16), (None, 7)])
def test_ortho_block_matches_jax_and_unblocked(restart, block):
    rng = np.random.default_rng(0)
    n = 120
    A = np.diag(3.0 + rng.random(n)) + 0.3 * rng.standard_normal((n, n))
    x_true = rng.standard_normal(n)
    b = A @ x_true
    rt, rj = _both("gmres", A, b, restart=restart, itmax=200, rtol=1e-12,
                   ortho_block=block)
    _assert_same(rt, rj)
    r_ref, _ = _both("gmres", A, b, restart=restart, itmax=200, rtol=1e-12)
    assert r_ref.niter == rt.niter and bool(rt.converged)
    np.testing.assert_allclose(rt.x.numpy(), x_true, atol=1e-7)


@pytest.mark.parametrize("block", [7, 32])
def test_ortho_block_convdiff_matches_unblocked(block):
    """Blocked CGS2 on the convection–diffusion solve of ``chip_smoke.py``'s
    orthogonalization table (c = 2, DST rebuilt every outer, full GMRES,
    exact Newton) at 32² in f64: the unblocked CGS2's counts, and its state
    to 1e-12.  At block 7 the projections run over several chunks; 32 is
    the chunk the card's table measures (the JAX package's own recipe,
    ``newtonkrylov_tpu/problems/convdiff2d.py:47``).  At larger sides the
    two sum in another order and their counts part by rounding (ROADMAP
    Queue 3 item 26)."""
    from newtonkrylov_tpu_torch.fftprec import fft_poisson
    from newtonkrylov_tpu_torch.problems import convdiff2d as tc

    n = 32
    p = tc.default_config(n, c=2.0, dtype=F64, device="cpu")
    u0 = tc.initial_guess(n, F64, "cpu")
    runs = [nkt.newton_krylov_jit(
        tc.residual_scaled, u0, p, M=fft_poisson(), algo="gmres", forcing=None,
        tol_rel=1e-10, max_niter=25,
        krylov_kwargs={"restart": None, "itmax": 150, "ortho_block": b})
        for b in (None, block)]
    (u, info), (ub, infob) = runs
    assert bool(info.solved) and bool(infob.solved)
    assert (infob.stats.outer_iterations, infob.stats.inner_iterations) == (
        info.stats.outer_iterations, info.stats.inner_iterations)
    np.testing.assert_allclose(ub.numpy(), u.numpy(), rtol=0,
                               atol=1e-12 * float(u.abs().max()))


@pytest.mark.parametrize("block", [None, 16])
def test_masked_space_matches_jax(block):
    rng = np.random.default_rng(0)
    n = 120
    A = np.diag(3.0 + rng.random(n)) + 0.3 * rng.standard_normal((n, n))
    b = A @ rng.standard_normal(n)
    mask = np.ones(n)
    mask[:3] = 0.0
    Aj, At = jnp.asarray(A), torch.tensor(A, dtype=F64)
    mj, mt = jnp.asarray(mask), torch.tensor(mask, dtype=F64)
    rj = nk.gmres(lambda v: mj * (Aj @ (mj * v)), jnp.asarray(b * mask),
                  restart=None, itmax=200, rtol=1e-10,
                  space=JMaskedSpace(mask=mj), ortho_block=block)
    rt = nkt.solvers.gmres(lambda v: mt * (At @ (mt * v)),
                           torch.tensor(b * mask, dtype=F64), restart=None,
                           itmax=200, rtol=1e-10, space=TMaskedSpace(mt),
                           ortho_block=block)
    _assert_same(rt, rj)
    assert bool(rt.converged)


def test_fgmres_ortho_block_matches_jax():
    rng = np.random.default_rng(2)
    n = 80
    A = np.diag(3.0 + rng.random(n)) + 0.25 * rng.standard_normal((n, n))
    x_true = rng.standard_normal(n)
    b = A @ x_true
    D = np.diag(1.0 / np.diag(A))
    for block in (None, 16):
        rt, rj = _both("fgmres", A, b, N=D, restart=None, itmax=120,
                       rtol=1e-12, ortho_block=block)
        _assert_same(rt, rj)
        np.testing.assert_allclose(rt.x.numpy(), x_true, atol=1e-7)


def test_rejects_bad_options():
    A, b, _ = random_system(8, seed=1)
    _, ot = _ops(A)
    bt = torch.tensor(b, dtype=F64)
    with pytest.raises(ValueError, match="ortho_block requires"):
        tsolvers.gmres(ot, bt, orth="mgs", ortho_block=4)
    with pytest.raises(ValueError, match="positive"):
        tsolvers.gmres(ot, bt, ortho_block=0)
    with pytest.raises(ValueError, match="orthogonalization"):
        tsolvers.gmres(ot, bt, orth="householder")


def _laplace_1d(n):
    main = np.full(n, -2.0)
    A = np.diag(main) + np.diag(np.ones(n - 1), 1) + np.diag(np.ones(n - 1), -1)
    return A, np.sin(np.arange(n, dtype=np.float64))


def test_restart_vs_full_parity_pin_matches_jax():
    """Full GMRES on 1-D Laplace takes exactly n steps; GMRES(20) exhausts
    itmax = 2n unconverged; both packages agree step for step."""
    n = 64
    A, b = _laplace_1d(n)
    full_t, full_j = _both("gmres", A, b, restart=None, itmax=n, rtol=1e-10)
    _assert_same(full_t, full_j, rtol=1e-8)
    assert bool(full_t.converged) and full_t.niter == n
    rs_t, rs_j = _both("gmres", A, b, restart=20, rtol=1e-10)
    _assert_same(rs_t, rs_j, rtol=1e-8)
    assert not bool(rs_t.converged) and rs_t.niter == 140


def test_newton_default_gmres_basis_matches_jax():
    """The driver's default inner solve: one cycle of basis min(n, 100)
    (``_PARITY_GMRES_BASIS``), the non-restarted count; ``restart`` in
    krylov_kwargs overrides it."""
    from newtonkrylov_tpu.newton import _PARITY_GMRES_BASIS as JB
    from newtonkrylov_tpu_torch.newton import _PARITY_GMRES_BASIS as TB

    assert TB == JB == 100
    n = 64
    A, b = _laplace_1d(n)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    At, bt = torch.tensor(A, dtype=F64), torch.tensor(b, dtype=F64)
    for kw in ({}, {"krylov_kwargs": {"restart": 20}}):
        _, ij = nk.newton_krylov_jit(lambda u, p: Aj @ u - bj, jnp.zeros(n),
                                     forcing=nk.Fixed(1e-10), **kw)
        _, it = nkt.newton_krylov_jit(lambda u, p: At @ u - bt,
                                      torch.zeros(n, dtype=F64),
                                      forcing=nkt.Fixed(1e-10), **kw)
        assert it.stats.outer_iterations == int(ij.stats.outer_iterations)
        assert it.stats.inner_iterations == int(ij.stats.inner_iterations)
        if not kw:
            assert it.stats.inner_iterations == n


def test_dispatch_menu():
    """Every algorithm runs through ``solve`` (fgmres keeps its
    ``restart``: kwargs reach a solver that takes ``**kwargs`` whole)."""
    assert set(tsolvers.available_algos()) == {"gmres", "fgmres", "cg",
                                               "bicgstab", "cgls"}
    A, b, x_true = random_system(20, seed=15, spd=True)
    _, ot = _ops(A)
    bt = torch.tensor(b, dtype=F64)
    for algo in ("gmres", "fgmres", "cg", "bicgstab"):
        res = tsolvers.solve(algo, ot, bt, rtol=1e-10)
        assert bool(res.converged), algo
        np.testing.assert_allclose(res.x.numpy(), x_true, rtol=1e-4, err_msg=algo)
    # restart reaches fgmres through the dispatcher: 3 cycles of 2 steps
    res = tsolvers.solve("fgmres", ot, bt, restart=2, itmax=6, rtol=1e-14)
    assert res.niter == 6 and not bool(res.converged)
    # cgls needs the adjoint: an operator with rmv, or At=
    with pytest.raises(ValueError, match="At="):
        tsolvers.solve("cgls", ot, bt)


def _export_gmres(fn, b):
    """``fn(b)`` exported (``utils/serving.py``) and called."""
    from newtonkrylov_tpu_torch.utils import serving

    return serving.export_solver(fn, (b,)).module()(b)


EXPORT_CASES = {
    "restarted": dict(restart=7, rtol=1e-10),
    "reorthogonalize": dict(restart=15, rtol=1e-10, reorthogonalize=True),
    "mgs": dict(restart=10, rtol=1e-10, orth="mgs"),
    "ortho_block": dict(restart=None, itmax=60, rtol=1e-12, ortho_block=7),
    "left_right": dict(restart=10, rtol=1e-10, M="jacobi", N="jacobi"),
    "flexible": dict(restart=10, rtol=1e-10, N="jacobi", flexible=True),
}


@pytest.mark.parametrize("case", sorted(EXPORT_CASES))
def test_export_matches_live_bitwise(case):
    """GMRES exported whole (its cycles and restarts ``while_loop``\\ s, the
    rotations, MGS sweep, chunked projection and back-substitution nested
    loops over a tensor count) equals the live solve bit for bit: solution,
    step count, residual and flags."""
    kw = dict(EXPORT_CASES[case])
    A, b, x_true = random_system(30, seed=21)
    At = torch.tensor(A, dtype=F64)
    D = torch.tensor(1.0 / np.diag(A), dtype=F64)
    for side in ("M", "N"):
        if kw.get(side) == "jacobi":
            kw[side] = lambda v: D * v

    def fn(bb):
        r = tsolvers.gmres(lambda v: At @ v, bb, **kw)
        return r.x, r.niter, r.residual, r.converged, r.breakdown

    bt = torch.tensor(b, dtype=F64)
    live = fn(bt)
    out = _export_gmres(fn, bt)
    assert isinstance(live[1], int) and live[1] == int(out[1])
    for a, e in zip((live[0], *live[2:]), (out[0], *out[2:])):
        assert torch.equal(torch.as_tensor(a), e), case
    assert bool(live[3])
    np.testing.assert_allclose(live[0].numpy(), x_true, rtol=1e-6)


def test_export_singular_breakdown_and_zero_rhs():
    """The dependent-column exclusion (``keff`` masked in the carry) and the
    zero right-hand side export as they run live."""
    A = torch.tensor(np.diag([1.0, 2.0, 3.0, 0.0, 5.0, 6.0]), dtype=F64)

    def fn(bb):
        r = tsolvers.gmres(lambda v: A @ v, bb, restart=6, rtol=1e-12, atol=0.0)
        return r.x, r.niter, r.residual, r.converged, r.breakdown

    for b in (torch.ones(6, dtype=F64), torch.zeros(6, dtype=F64)):
        live = fn(b)
        out = _export_gmres(fn, b)
        assert live[1] == int(out[1])
        for a, e in zip((live[0], *live[2:]), (out[0], *out[2:])):
            assert torch.equal(torch.as_tensor(a), e)
    assert bool(out[4]) is False and int(out[1]) == 0  # the zero rhs
    live = fn(torch.ones(6, dtype=F64))
    assert bool(live[4]) and not bool(live[3])


def test_eager_reads_one_boolean_per_step(monkeypatch):
    """Eagerly the Arnoldi loop reads one boolean per step and nothing
    else: no ``.item()``, ``.cpu()``, ``.numpy()`` or ``.tolist()``, and
    one ``bool`` per step, per restart test and per solve."""
    reads = {"bool": 0, "other": 0}
    real_bool = torch.Tensor.__bool__

    def counted_bool(self):
        reads["bool"] += 1
        return real_bool(self)

    def refuse(name):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, **k):
            reads["other"] += 1
            return real(self, *a, **k)
        return counted

    A, b, _ = random_system(40, seed=3)
    At, bt = torch.tensor(A, dtype=F64), torch.tensor(b, dtype=F64)
    monkeypatch.setattr(torch.Tensor, "__bool__", counted_bool)
    for name in ("item", "cpu", "numpy", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    res = tsolvers.gmres(lambda v: At @ v, bt, restart=10, rtol=1e-10)
    monkeypatch.undo()
    cycles = -(-res.niter // 10)
    assert reads["other"] == 0
    # one per step, one loop exit per cycle, one restart test per cycle,
    # the first cycle's test
    assert reads["bool"] <= res.niter + 2 * cycles + 1, (reads, res.niter)


def test_f32_refined_convdiff_counts_queue3_item10():
    """The refined convection–diffusion solve (f32 Krylov, df32
    acceptance, full GMRES, DST) at n = 32 and 64 takes 5 / 59 and 5 / 117
    (ROADMAP Queue 3 item 10; the JAX package takes 5 / 59 and 5 / 110).
    With the Hessenberg algebra on the host the port took 5 / 58 and
    5 / 116: its back-substitution went through numpy's BLAS dot, whose
    fused, vectorized sum no device op reproduces."""
    from newtonkrylov_tpu.problems import convdiff2d as jc
    from newtonkrylov_tpu_torch.fftprec import fft_poisson
    from newtonkrylov_tpu_torch.problems import convdiff2d as tc
    from newtonkrylov_tpu_torch.utils import convert

    for n, counts in ((32, (5, 59)), (64, (5, 117))):
        pj = jc.default_config(n, dtype=jnp.float64)
        p = tc.Params(dx=float(pj.dx), c=float(pj.c),
                      b=convert.state(np.asarray(pj.b), device="cpu"))
        u0 = convert.state(np.asarray(jc.initial_guess(n, jnp.float64)),
                           device="cpu")
        _, info = nkt.newton_krylov_jit(
            tc.residual_scaled, u0, p, krylov_dtype=torch.float32,
            residual_df=tc.residual_scaled_df, M=fft_poisson(), algo="gmres",
            tol_rel=1e-8, forcing=None, max_niter=25,
            krylov_kwargs={"restart": None, "itmax": 150})
        assert bool(info.solved)
        assert (info.stats.outer_iterations,
                info.stats.inner_iterations) == counts, n
