"""The port's sharded preconditioners against the JAX package's (oracles:
tests/test_sharded_precond.py; the sharded cases of tests/test_cheb.py,
tests/test_continuation.py and tests/test_convdiff.py).

* global-operator Chebyshev (``chebyshev(axis_names=...)``): a ghost
  exchange per polynomial step, the single device's polynomial;
* block-Jacobi DST (``fft_poisson(axis_names=...)``), block-MG, block-ADI
  and block-MG-ADI: each rank its own block, no communication per apply,
  with the Schwarz iteration-count penalty the JAX tests record;
* the globally exact DST (``fft_poisson(scope="global")``): four
  distributed sine-basis products per apply, each a local product and one
  reduce-scatter.

Each world size runs all of its cases in one spawn of gloo CPU ranks (a
module fixture); the JAX side runs here on the virtual CPU devices.  Every
solve is held against the port's own unsharded solve (run on rank 0) and
the JAX package's sharded solve, with the tolerances below.  The structure
tests count the collectives the port's wrappers issue
(``utils.distributed.COLLECTIVES``), where the JAX tests count the
collectives in the traced program.
"""

import traceback

import numpy as np
import pytest
import torch

RANK_TIMEOUT = 300.0  # seconds for one spawn to run all of its cases
N = 64
LAM = 5.0

# Relative state tolerances (max|Δ| / max|u|): f64 solves against the
# port's unsharded solve and the JAX package's sharded one.  The JAX tests
# hold their sharded solves to 1e-9 absolute of the single device (1e-8
# with refresh "once", 1e-7 for df32); the port's measured differences are
# logged beside each test.
TOL = 1e-9
TOL_DF32 = 1e-7


# -- Rank side -----------------------------------------------------------------


def _padded(up, pp):
    u = up[1:-1, 1:-1]
    stencil = up[2:, 1:-1] + up[:-2, 1:-1] + up[1:-1, 2:] + up[1:-1, :-2] - 4.0 * u
    return stencil + (pp.dx * pp.dx) * pp.lam * torch.exp(u)


def _neg_padded(up, pp):
    return -_padded(up, pp)


def _np(x):
    return x.detach().cpu().numpy()


def _out(u, info, mesh=None, spec=None):
    from newtonkrylov_tpu_torch import halo

    if mesh is not None:
        u = halo.gather_array(u, mesh, spec)
    return {"u": _np(u), "solved": bool(info.solved),
            "outer": int(info.stats.outer_iterations),
            "inner": int(info.stats.inner_iterations)}


def _rank0(run):
    import torch.distributed as dist

    return run() if dist.get_rank() == 0 else None


def _bratu_sharded(mesh, axes, M, **extra):
    """The JAX test's ``_sharded``: f64 Bratu at N², CG, tol_rel 1e-9."""
    from newtonkrylov_tpu_torch import halo
    from newtonkrylov_tpu_torch.problems import bratu2d

    p = bratu2d.default_config(N, lam=LAM)
    u0 = bratu2d.initial_guess(N, device="cpu")
    F = halo.sharded_residual_2d(_padded, axes, "dirichlet")
    u, info = halo.newton_krylov_sharded(
        F, u0, p, mesh, halo.P(*axes),
        newton_kwargs={"algo": "cg", "M": M, "tol_rel": 1e-9, "max_niter": 25,
                       **extra})
    return _out(u, info, mesh, halo.P(*axes))


def _bratu_single(M):
    import newtonkrylov_tpu_torch as nkt
    from newtonkrylov_tpu_torch.problems import bratu2d

    p = bratu2d.default_config(N, lam=LAM)
    u, info = nkt.newton_krylov_jit(
        bratu2d.residual_scaled, bratu2d.initial_guess(N, device="cpu"), p,
        algo="cg", M=M, tol_rel=1e-9, max_niter=25)
    return _out(u, info)


def case_cheb(mesh):
    from newtonkrylov_tpu_torch.precond import chebyshev

    out = _bratu_sharded(mesh, ("i", "j"), chebyshev(degree=8, axis_names=("i", "j")))
    out["single"] = _rank0(lambda: _bratu_single(chebyshev(degree=8, engine="xla")))
    return out


def case_block_dst(mesh):
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    out = _bratu_sharded(mesh, ("i", "j"), fft_poisson(axis_names=("i", "j")))
    out["single"] = _rank0(lambda: _bratu_single(fft_poisson()))
    return out


def case_df32_cheb(mesh):
    import newtonkrylov_tpu_torch as nkt
    from newtonkrylov_tpu_torch import halo
    from newtonkrylov_tpu_torch.precond import chebyshev
    from newtonkrylov_tpu_torch.problems import bratu2d

    p = bratu2d.default_config(N, lam=LAM)
    u0 = bratu2d.initial_guess(N, device="cpu")
    F = halo.sharded_residual_2d(_padded, ("i", "j"), "dirichlet")
    F_df = halo.sharded_residual_df_2d(bratu2d.residual_scaled_df_padded,
                                       ("i", "j"), "dirichlet")
    u, info = halo.newton_krylov_sharded(
        F, u0, p, mesh, halo.P("i", "j"),
        newton_kwargs={"algo": "cg", "M": chebyshev(degree=8, axis_names=("i", "j")),
                       "residual_df": F_df, "tol_rel": 1e-8, "max_niter": 25})
    out = _out(u, info, mesh, halo.P("i", "j"))
    out["single"] = _rank0(lambda: _out(*nkt.newton_krylov_jit(
        bratu2d.residual_scaled, u0, p, algo="cg",
        M=chebyshev(degree=8, engine="xla"),
        residual_df=bratu2d.residual_scaled_df, tol_rel=1e-8, max_niter=25)))
    return out


def _apply_counts(mesh, factory, applies):
    """Collectives issued by building ``factory`` on the Bratu Jacobian and
    applying it ``applies`` times."""
    from newtonkrylov_tpu_torch import halo
    from newtonkrylov_tpu_torch.operator import JacobianOperator
    from newtonkrylov_tpu_torch.problems import bratu2d
    from newtonkrylov_tpu_torch.utils import distributed as D

    p = bratu2d.default_config(N, lam=LAM)
    with D.use_mesh(mesh):
        ul = halo.shard_array(bratu2d.initial_guess(N, device="cpu"), mesh,
                              halo.P("i", "j"))
        J = JacobianOperator(halo.sharded_residual_2d(_padded, ("i", "j")), ul, p)
        D.reset_collective_counts()
        M = factory(J)
        r = J.res
        for _ in range(applies):
            r = M(r)
        return dict(D.COLLECTIVES)


def case_cheb_structure(mesh):
    from newtonkrylov_tpu_torch.precond import chebyshev

    factory = chebyshev(degree=8, axis_names=("i", "j"))
    return [_apply_counts(mesh, factory, k) for k in (1, 2)]


def case_global_dst_structure(mesh):
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    factory = fft_poisson(axis_names=("i", "j"), scope="global")
    return [_apply_counts(mesh, factory, k) for k in (0, 1, 2)]


def case_refresh_once(mesh):
    from newtonkrylov_tpu_torch.precond import chebyshev

    M = chebyshev(degree=6, axis_names=("i", None))
    return {"outer": _bratu_sharded(mesh, ("i", None), M),
            "once": _bratu_sharded(mesh, ("i", None), M, precond_refresh="once")}


def case_dst_transform(mesh):
    from newtonkrylov_tpu_torch import fftprec, halo
    from newtonkrylov_tpu_torch.utils import distributed as D

    n, m = 32, 16
    x = torch.tensor(np.random.default_rng(7).standard_normal((n, m)))
    with D.use_mesh(mesh):
        xl = halo.shard_array(x, mesh, halo.P("i", "j"))
        nl, ml = xl.shape
        i, j = D.axis_index("i"), D.axis_index("j")
        Sr = fftprec.sine_basis(n, torch.float64, "cpu")
        Sc = fftprec.sine_basis(m, torch.float64, "cpu")
        y = fftprec._dist_dst_axis1(
            fftprec._dist_dst_axis0(xl, Sr[:, i * nl:(i + 1) * nl].contiguous(), "i"),
            Sc[j * ml:(j + 1) * ml, :].contiguous(), "j")
        return _np(halo.gather_array(y, mesh, halo.P("i", "j")))


def case_global_dst(mesh, axes):
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    out = _bratu_sharded(mesh, axes, fft_poisson(axis_names=axes, scope="global"))
    out["single"] = _rank0(lambda: _bratu_single(fft_poisson()))
    return out


def case_block_mg(mesh):
    from newtonkrylov_tpu_torch.mg import multigrid2d

    out = _bratu_sharded(mesh, ("i", "j"), multigrid2d(axis_names=("i", "j")))
    out["single"] = _rank0(lambda: _bratu_single(multigrid2d()))
    return out


def case_cheb_lanczos(mesh, n):
    """test_cheb.py's sharded Lanczos-bounds parity (n = 32 and n = 8, whose
    16-entry shards are below lanczos_k)."""
    import newtonkrylov_tpu_torch as nkt
    from newtonkrylov_tpu_torch import halo
    from newtonkrylov_tpu_torch.precond import chebyshev
    from newtonkrylov_tpu_torch.problems import bratu2d

    lam = 5.0 if n == 32 else 4.0
    p = bratu2d.default_config(n, lam=lam)
    u0 = bratu2d.initial_guess(n, device="cpu")
    F = halo.sharded_residual_2d(_padded, ("i", "j"), "dirichlet")
    u, info = halo.newton_krylov_sharded(
        F, u0, p, mesh, halo.P("i", "j"),
        newton_kwargs={"algo": "cg", "tol_rel": 1e-8,
                       "M": chebyshev(degree=8, bounds="lanczos",
                                      axis_names=("i", "j"))})
    out = _out(u, info, mesh, halo.P("i", "j"))
    out["single"] = _rank0(lambda: _out(*nkt.newton_krylov_jit(
        bratu2d.residual_scaled, u0, p, algo="cg", tol_rel=1e-8,
        M=chebyshev(degree=8, bounds="lanczos", engine="xla"))))
    return out


def case_ptc(mesh):
    """test_continuation.py's driver seam: Ψtc through newton_krylov_sharded
    with the global DST, n = 32, λ = 6, GMRES(100)."""
    import newtonkrylov_tpu_torch as nkt
    from newtonkrylov_tpu_torch import halo
    from newtonkrylov_tpu_torch.fftprec import fft_poisson
    from newtonkrylov_tpu_torch.problems import bratu2d

    n = 32
    p = bratu2d.default_config(n, lam=6.0)
    u0 = bratu2d.initial_guess(n, device="cpu")
    d0 = float((n + 1) ** 2)
    F = halo.sharded_residual_2d(_neg_padded, ("i", "j"), "dirichlet")
    u, info = halo.newton_krylov_sharded(
        F, u0, p, mesh, halo.P("i", "j"), driver=nkt.pseudo_transient,
        newton_kwargs=dict(algo="gmres", tol_rel=1e-10, delta0=d0, max_steps=60,
                           M=fft_poisson(axis_names=("i", "j"), scope="global"),
                           krylov_kwargs={"restart": 100}))
    out = _out(u, info, mesh, halo.P("i", "j"))
    out["single"] = _rank0(lambda: _out(*nkt.pseudo_transient(
        lambda v, pp: -bratu2d.residual_scaled(v, pp), u0, p, algo="gmres",
        tol_rel=1e-10, M=fft_poisson(), delta0=d0, max_steps=60)))
    return out


def _convdiff_sharded(mesh, n, c, M, krylov):
    import newtonkrylov_tpu_torch as nkt
    from newtonkrylov_tpu_torch import halo
    from newtonkrylov_tpu_torch.problems import convdiff2d

    p = convdiff2d.default_config(n, c=c, device="cpu")
    u0 = convdiff2d.initial_guess(n, device="cpu")
    kw = dict(algo="gmres", tol_rel=1e-10, forcing=None, max_niter=15 if M else 20,
              krylov_kwargs=krylov)
    F = halo.sharded_residual_2d(convdiff2d.residual_scaled_padded, ("i", "j"),
                                 "dirichlet")
    u, info = halo.newton_krylov_sharded(
        F, u0, p, mesh, halo.P("i", "j"),
        newton_kwargs=dict(kw, M=M(("i", "j")) if M else None),
        p_spec=convdiff2d.Params(dx=halo.P(), c=halo.P(), b=halo.P("i", "j")))
    out = _out(u, info, mesh, halo.P("i", "j"))
    out["err"] = float(np.abs(out["u"] - _np(convdiff2d.manufactured_solution(
        n, device="cpu"))).max())
    if M is None:
        out["single"] = _rank0(lambda: _out(*nkt.newton_krylov_jit(
            convdiff2d.residual_scaled, u0, p, **kw)))
    return out


def case_convdiff(mesh):
    return _convdiff_sharded(mesh, 32, 2.0, None, {"restart": None, "itmax": 100})


def case_block_adi(mesh):
    from newtonkrylov_tpu_torch.precond import adi

    return _convdiff_sharded(mesh, 64, 25.0, lambda ax: adi(4, axis_names=ax),
                             {"restart": None, "itmax": 300})


def case_block_mg_general(mesh):
    from newtonkrylov_tpu_torch.mg import multigrid2d_general

    return _convdiff_sharded(
        mesh, 64, 25.0, lambda ax: multigrid2d_general(axis_names=ax),
        {"restart": None, "itmax": 300})


def _run_cases(cases):
    out = {}
    for name, fn, args in cases:
        try:
            out[name] = fn(*args)
        except Exception:  # noqa: BLE001 - reported by the test that reads it
            out[name] = {"error": traceback.format_exc()}
    return out


def world8_cases():
    from newtonkrylov_tpu_torch import halo

    grid = halo.make_mesh((2, 4), ("i", "j"), device_type="cpu")
    grid42 = halo.make_mesh((4, 2), ("i", "j"), device_type="cpu")
    rows = halo.make_mesh((8,), ("i",), device_type="cpu")
    return _run_cases([
        ("cheb", case_cheb, (grid,)),
        ("block_dst", case_block_dst, (grid,)),
        ("df32_cheb", case_df32_cheb, (grid,)),
        ("cheb_structure", case_cheb_structure, (grid,)),
        ("dst_transform", case_dst_transform, (grid42,)),
        ("global_dst", case_global_dst, (grid, ("i", "j"))),
        ("global_dst_structure", case_global_dst_structure, (grid,)),
        ("global_dst_rows", case_global_dst, (rows, ("i", None))),
    ])


def world4_cases():
    from newtonkrylov_tpu_torch import halo

    grid = halo.make_mesh((2, 2), ("i", "j"), device_type="cpu")
    rows = halo.make_mesh((4,), ("i",), device_type="cpu")
    return _run_cases([
        ("refresh_once", case_refresh_once, (rows,)),
        ("block_mg", case_block_mg, (grid,)),
        ("cheb_lanczos_32", case_cheb_lanczos, (grid, 32)),
        ("cheb_lanczos_8", case_cheb_lanczos, (grid, 8)),
        ("ptc", case_ptc, (grid,)),
        ("convdiff", case_convdiff, (grid,)),
        ("block_adi", case_block_adi, (grid,)),
        ("block_mg_general", case_block_mg_general, (grid,)),
    ])


# -- Parent side ---------------------------------------------------------------


def _spawn(fn, world, tmp_path_factory):
    from newtonkrylov_tpu_torch.utils import distributed as D

    store = tmp_path_factory.mktemp(f"store{world}")
    return D.run_processes(fn, world, timeout=RANK_TIMEOUT, store_dir=str(store))


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return _spawn(world8_cases, 8, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(world4_cases, 4, tmp_path_factory)


def _result(ranks, name):
    for r in ranks:
        if isinstance(r[name], dict) and "error" in r[name]:
            pytest.fail(r[name]["error"])
    for r in ranks[1:]:  # the info is equal on every rank
        if isinstance(r[name], dict) and isinstance(r[name].get("outer"), int):
            assert (r[name]["outer"], r[name]["inner"]) == (
                ranks[0][name]["outer"], ranks[0][name]["inner"])
    return ranks[0][name]


def _assert_rel(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    print(f"relative difference {err:.3e} (limit {rtol:.0e})")
    assert err <= rtol, (err, rtol)


def _jax_padded(up, pp):
    import jax.numpy as jnp

    u = up[1:-1, 1:-1]
    stencil = up[2:, 1:-1] + up[:-2, 1:-1] + up[1:-1, 2:] + up[1:-1, :-2] - 4.0 * u
    return stencil + (pp.dx * pp.dx) * pp.lam * jnp.exp(u)


def _jax_sharded(mesh_shape, axes, M, **extra):
    """tests/test_sharded_precond.py's ``_sharded``."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from newtonkrylov_tpu.halo import (make_mesh, newton_krylov_sharded,
                                       sharded_residual_2d)
    from newtonkrylov_tpu.problems import bratu2d

    names = tuple(a for a in axes if a is not None)
    mesh = make_mesh(mesh_shape, names)
    p = bratu2d.default_config(N, lam=LAM)
    u0 = bratu2d.initial_guess(N, dtype=jnp.float64)
    F_local = sharded_residual_2d(_jax_padded, axes, "dirichlet")
    u, info = newton_krylov_sharded(
        F_local, u0, p, mesh, JP(*axes),
        newton_kwargs={"algo": "cg", "M": M, "tol_rel": 1e-9, "max_niter": 25,
                       **extra})
    return _jax_out(u, info)


def _jax_out(u, info):
    return {"u": np.asarray(u), "solved": bool(np.asarray(info.solved)),
            "outer": int(np.asarray(info.stats.outer_iterations)),
            "inner": int(np.asarray(info.stats.inner_iterations))}


def _counts(r):
    return (r["outer"], r["inner"])


# test_sharded_precond.py


def test_sharded_chebyshev_matches_single_device_counts(world8):
    """Global-operator Chebyshev(8) on a 2×4 mesh: the single device's
    polynomial, so the port's unsharded counts (outer equal, inner within
    1, as the JAX test allows), and the JAX package's sharded counts; the
    states within 1e-9 relative."""
    from newtonkrylov_tpu.precond import chebyshev

    got = _result(world8, "cheb")
    single = got["single"]
    ref = _jax_sharded((2, 4), ("i", "j"), chebyshev(degree=8, axis_names=("i", "j")))
    assert got["solved"] and single["solved"] and ref["solved"]
    assert got["outer"] == single["outer"]
    assert abs(got["inner"] - single["inner"]) <= 1
    assert _counts(got) == _counts(ref)
    _assert_rel(got["u"], single["u"], TOL)
    _assert_rel(got["u"], ref["u"], TOL)


def test_sharded_block_jacobi_dst_converges_with_recorded_penalty(world8):
    """Block-Jacobi DST on 8 subdomains: more inner iterations than the
    global DST but at most 16× (the JAX test's bound; its record is 83
    against 7), the JAX package's sharded counts, states within 1e-9."""
    from newtonkrylov_tpu.fftprec import fft_poisson

    got = _result(world8, "block_dst")
    k_ref = got["single"]["inner"]
    ref = _jax_sharded((2, 4), ("i", "j"), fft_poisson(axis_names=("i", "j")))
    assert got["solved"] and ref["solved"]
    assert k_ref <= got["inner"] <= 16 * k_ref, (got["inner"], k_ref)
    # 83 inner iterations of a weak preconditioner: the last-bit
    # differences of the two packages' sums move the count by 2 (ROADMAP.md
    # Queue 3 item 20)
    assert got["outer"] == ref["outer"]
    assert abs(got["inner"] - ref["inner"]) <= 2, (got["inner"], ref["inner"])
    _assert_rel(got["u"], got["single"]["u"], TOL)
    _assert_rel(got["u"], ref["u"], TOL)


def test_sharded_df32_refined_with_chebyshev(world8):
    """df32 acceptance (hi and lo words exchanged apart) + sharded
    Chebyshev: outer counts equal to the unsharded solve's and the JAX
    package's, inner within 2 (the JAX test's), states within 1e-7 (the
    JAX test's)."""
    from jax.sharding import PartitionSpec as JP
    import jax.numpy as jnp

    from newtonkrylov_tpu.halo import (make_mesh, newton_krylov_sharded,
                                       sharded_residual_2d, sharded_residual_df_2d)
    from newtonkrylov_tpu.precond import chebyshev
    from newtonkrylov_tpu.problems import bratu2d

    got = _result(world8, "df32_cheb")
    single = got["single"]
    p = bratu2d.default_config(N, lam=LAM)
    u, info = newton_krylov_sharded(
        sharded_residual_2d(_jax_padded, ("i", "j"), "dirichlet"),
        bratu2d.initial_guess(N, dtype=jnp.float64), p, make_mesh((2, 4), ("i", "j")),
        JP("i", "j"),
        newton_kwargs={"algo": "cg", "M": chebyshev(degree=8, axis_names=("i", "j")),
                       "residual_df": sharded_residual_df_2d(
                           bratu2d.residual_scaled_df_padded, ("i", "j"), "dirichlet"),
                       "tol_rel": 1e-8, "max_niter": 25})
    ref = _jax_out(u, info)
    assert got["solved"] and single["solved"] and ref["solved"]
    assert got["outer"] == single["outer"] == ref["outer"]
    assert abs(got["inner"] - single["inner"]) <= 2
    assert abs(got["inner"] - ref["inner"]) <= 2
    _assert_rel(got["u"], single["u"], TOL_DF32)
    _assert_rel(got["u"], ref["u"], TOL_DF32)


def test_chebyshev_apply_structure(world8):
    """One more apply of sharded Chebyshev(8) costs 8 ghost exchanges on
    each of the two sharded axes (16 posts, 32 messages sent), no
    reduction and no gather (the JAX test: one exchange round in the
    loop body, zero psums)."""
    c1, c2 = _result(world8, "cheb_structure")
    assert c2["exchange"] - c1["exchange"] == 16, (c1, c2)
    assert c2["p2p"] - c1["p2p"] == 32, (c1, c2)
    assert c2["all_reduce"] - c1["all_reduce"] == 0, (c1, c2)
    assert c2["reduce_scatter"] == 0 and c2["all_gather"] == 0, c2


def test_sharded_chebyshev_refresh_once_matches_outer(world4):
    """precond_refresh="once" composes with the sharded factory: within 3
    inner iterations of the per-outer refresh, states within 2e-8 (the JAX
    test's), on a 4-way row mesh (the JAX test's is 2-way)."""
    got = _result(world4, "refresh_once")
    a, b = got["outer"], got["once"]
    assert a["solved"] and b["solved"]
    assert abs(b["inner"] - a["inner"]) <= 3
    np.testing.assert_allclose(b["u"], a["u"], atol=2e-8)


def test_global_dst_transform_matches_dense(world8):
    """The distributed 2-D DST (a product and a reduce-scatter per axis) on
    a 4×2 mesh equals the dense sine-basis transform (rtol 1e-12)."""
    got = _result(world8, "dst_transform")
    n, m = 32, 16
    x = np.random.default_rng(7).standard_normal((n, m))

    def S(k):
        i = np.arange(1, k + 1)
        return np.sin(np.pi * np.outer(i, i) / (k + 1))

    np.testing.assert_allclose(got, S(n) @ x @ S(m), rtol=1e-12, atol=1e-12)


def test_sharded_global_dst_matches_single_device_counts(world8):
    """scope="global" on a 2×4 mesh: the unsharded DST's eigen-solve, so
    the unsharded counts (inner within 1, as the JAX test allows) and the
    JAX package's sharded counts; states within 1e-9."""
    from newtonkrylov_tpu.fftprec import fft_poisson

    got = _result(world8, "global_dst")
    single = got["single"]
    ref = _jax_sharded((2, 4), ("i", "j"),
                       fft_poisson(axis_names=("i", "j"), scope="global"))
    assert got["solved"] and ref["solved"]
    assert got["outer"] == single["outer"]
    assert abs(got["inner"] - single["inner"]) <= 1
    assert _counts(got) == _counts(ref)
    _assert_rel(got["u"], single["u"], TOL)
    _assert_rel(got["u"], ref["u"], TOL)


def test_global_dst_apply_structure(world8):
    """One global-DST apply = 4 reduce-scatters, no gather; building the
    factory costs exactly one all-reduce (the global mean diagonal)."""
    c0, c1, c2 = _result(world8, "global_dst_structure")
    assert c0["all_reduce"] == c1["all_reduce"] == c2["all_reduce"] == 1, (c0, c2)
    assert c1["reduce_scatter"] - c0["reduce_scatter"] == 4, (c0, c1)
    assert c2["reduce_scatter"] - c1["reduce_scatter"] == 4, (c1, c2)
    assert c2["all_gather"] == 0, c2


def test_sharded_global_dst_1d_mesh(world8):
    """Global DST on an 8-way row mesh: axis 1 takes the local product,
    axis 0 reduce-scatters; the unsharded and the JAX package's counts."""
    from newtonkrylov_tpu.fftprec import fft_poisson

    got = _result(world8, "global_dst_rows")
    single = got["single"]
    ref = _jax_sharded((8,), ("i", None),
                       fft_poisson(axis_names=("i", None), scope="global"))
    assert got["solved"] and ref["solved"]
    assert got["outer"] == single["outer"]
    assert abs(got["inner"] - single["inner"]) <= 1
    assert _counts(got) == _counts(ref)
    _assert_rel(got["u"], ref["u"], TOL)


def test_sharded_block_mg_converges_with_recorded_penalty(world4):
    """Block-MG on a 2×2 mesh: between 1× and 6× the unsharded MG's inner
    iterations (the JAX test's bound; its record 68 against 20), the JAX
    package's sharded counts, states within 1e-8 (the JAX test's)."""
    from newtonkrylov_tpu.mg import multigrid2d

    got = _result(world4, "block_mg")
    k_ref = got["single"]["inner"]
    ref = _jax_sharded((2, 2), ("i", "j"), multigrid2d(axis_names=("i", "j")))
    assert got["solved"] and ref["solved"]
    assert k_ref <= got["inner"] <= 6 * k_ref, (got["inner"], k_ref)
    assert _counts(got) == _counts(ref)
    _assert_rel(got["u"], ref["u"], 1e-8)


# the sharded cases of test_cheb.py, test_continuation.py, test_convdiff.py


@pytest.mark.parametrize("n", [32, 8])
def test_cheb_lanczos_bounds_sharded_parity(world4, n):
    """Chebyshev(8) on a Lanczos interval on a 2×2 mesh takes the unsharded
    inner count: k clamps to the global size, and the start vector is the
    single device's (at n = 8 each shard's 16 entries are below
    lanczos_k = 48)."""
    got = _result(world4, f"cheb_lanczos_{n}")
    assert got["solved"] and got["single"]["solved"]
    assert got["inner"] == got["single"]["inner"]
    _assert_rel(got["u"], got["single"]["u"], TOL)


def test_ptc_through_newton_krylov_sharded_driver_seam(world4):
    """Ψtc rides newton_krylov_sharded (driver=pseudo_transient) with the
    global DST: the unsharded Ψtc's step and inner counts, and the JAX
    package's sharded ones; states within 1e-9."""
    import jax.numpy as jnp  # noqa: F401 - x64 set by conftest
    from jax.sharding import PartitionSpec as JP

    from newtonkrylov_tpu.continuation import pseudo_transient
    from newtonkrylov_tpu.fftprec import fft_poisson
    from newtonkrylov_tpu.halo import (make_mesh, newton_krylov_sharded,
                                       sharded_residual_2d)
    from newtonkrylov_tpu.problems import bratu2d

    got = _result(world4, "ptc")
    single = got["single"]
    n = 32

    def neg_padded(up, pp):
        return -_jax_padded(up, pp)

    u, info = newton_krylov_sharded(
        sharded_residual_2d(neg_padded, ("i", "j"), "dirichlet"),
        bratu2d.initial_guess(n), bratu2d.default_config(n, lam=6.0),
        make_mesh((2, 2), ("i", "j")), JP("i", "j"), driver=pseudo_transient,
        newton_kwargs=dict(algo="gmres", tol_rel=1e-10, delta0=float((n + 1) ** 2),
                           max_steps=60,
                           M=fft_poisson(axis_names=("i", "j"), scope="global"),
                           krylov_kwargs={"restart": 100}))
    ref = _jax_out(u, info)
    assert got["solved"] and single["solved"] and ref["solved"]
    assert _counts(got) == _counts(single) == _counts(ref)
    _assert_rel(got["u"], single["u"], TOL)
    _assert_rel(got["u"], ref["u"], TOL)


def _jax_convdiff(n, c, M, krylov):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from newtonkrylov_tpu.halo import (make_mesh, newton_krylov_sharded,
                                       sharded_residual_2d)
    from newtonkrylov_tpu.problems import convdiff2d

    p = convdiff2d.default_config(n, c=c, dtype=jnp.float64)
    u, info = newton_krylov_sharded(
        sharded_residual_2d(convdiff2d.residual_scaled_padded, ("i", "j"), "dirichlet"),
        convdiff2d.initial_guess(n, jnp.float64), p, make_mesh((2, 2), ("i", "j")),
        JP("i", "j"),
        newton_kwargs=dict(algo="gmres", tol_rel=1e-10, forcing=None,
                           max_niter=15 if M else 20, krylov_kwargs=krylov,
                           M=M(("i", "j")) if M else None),
        p_spec=convdiff2d.Params(dx=JP(), c=JP(), b=JP("i", "j")))
    return _jax_out(u, info)


def test_sharded_convdiff_p_spec_matches_single_device(world4):
    """Convection–diffusion (c = 2, n = 32) with its forcing field sharded
    by p_spec, full GMRES: the unsharded and the JAX package's sharded
    counts, states within 1e-9."""
    got = _result(world4, "convdiff")
    single = got["single"]
    ref = _jax_convdiff(32, 2.0, None, {"restart": None, "itmax": 100})
    assert got["solved"] and single["solved"] and ref["solved"]
    assert _counts(got) == _counts(single) == _counts(ref)
    _assert_rel(got["u"], single["u"], TOL)
    _assert_rel(got["u"], ref["u"], TOL)


def test_block_adi_sharded_convection_dominated(world4):
    """Block-ADI(4) at c = 25, n = 64 on a 2×2 mesh: at most 240 inner
    iterations (the JAX test's bound; its record 189), the manufactured
    root within 1e-9, the JAX package's sharded counts."""
    from newtonkrylov_tpu.precond import adi

    got = _result(world4, "block_adi")
    ref = _jax_convdiff(64, 25.0, lambda ax: adi(4, axis_names=ax),
                        {"restart": None, "itmax": 300})
    assert got["solved"] and ref["solved"]
    assert got["inner"] <= 240
    assert got["err"] < 1e-9
    assert _counts(got) == _counts(ref)


def test_block_mg_general_sharded(world4):
    """Block-MG-ADI at c = 25, n = 64 on a 2×2 mesh: at most 260 inner
    iterations (the JAX test's bound), the manufactured root within 1e-9,
    the JAX package's sharded counts."""
    from newtonkrylov_tpu.mg import multigrid2d_general

    got = _result(world4, "block_mg_general")
    ref = _jax_convdiff(64, 25.0, lambda ax: multigrid2d_general(axis_names=ax),
                        {"restart": None, "itmax": 300})
    assert got["solved"] and ref["solved"]
    assert got["inner"] <= 260
    assert got["err"] < 1e-9
    assert _counts(got) == _counts(ref)

