"""The port's example gallery against the JAX package's (see
tests/test_torch_examples_a.py): the convection–diffusion recipe gallery
at a reduced grid, the 2-D Bratu flagship example with the aligned K1/K2
lane (their plain versions on the CPU) and the sharded example on four
gloo ranks, on the CPU in f64."""

import re

import numpy as np

from test_torch_examples_a import fields, jax_example, lines, one_thread, rel  # noqa: F401

CONVDIFF_N = 32  # the example's 96² takes minutes here in either package


def _recipe_lines(out):
    return [re.sub(r" host copies .*$", "", ln) for ln in out.splitlines()
            if "solved=" in ln]


def test_convdiff_2d_matches_jax_example_recipes(monkeypatch, capsys):
    """All nine recipes at n = 32 (the example's 96² took 126 s in the JAX
    package here) through the JAX example's own ``run`` with its grid
    patched to 32.  Every f64 recipe takes the JAX example's ``solved``
    flag and outer count, and its inner count but where an ill-conditioned
    solve amplifies last-bit differences (ROADMAP Queue 3 item 24: full
    DST-GMRES at c = 25, measured 7 / 978 against 7 / 977); the solved ones
    reach max|u − u*| ≤ 1e-13 in both packages, and the restarted DST
    recipe fails at c = 25 in both with errors within 25% (item 24:
    measured 1.80e-4 against 1.55e-4).  The two f32-Krylov + df32 recipes
    agree on ``solved`` and the outer count with max|u − u*| ≤ 1e-9, their
    inner counts following the f32 sums' order (Queue 3 item 10)."""
    from newtonkrylov_tpu.fftprec import fft_poisson as jfft
    from newtonkrylov_tpu.mg import multigrid2d_general as jmg
    from newtonkrylov_tpu.precond import adi as jadi
    from newtonkrylov_tpu.precond import ilu0 as jilu0
    from newtonkrylov_tpu.problems import convdiff2d as jc
    from newtonkrylov_tpu_torch.examples import convdiff_2d

    import jax.numpy as jnp

    got = convdiff_2d.main(device="cpu", n=CONVDIFF_N)
    mine = _recipe_lines(capsys.readouterr().out)
    jmod = jax_example("convdiff_2d", monkeypatch)
    monkeypatch.setattr(jmod, "N", CONVDIFF_N)
    n = CONVDIFF_N
    jmod.run("gmres + DST Poisson", 2.0, M=jfft(), tol_rel=1e-10)
    jmod.run("gmres + ADI(4)", 2.0, M=jadi(4), tol_rel=1e-10)
    jmod.run("gmres(restart=40) + DST Poisson", 25.0, M=jfft(), tol_rel=1e-10,
             max_niter=6, expect_fail=True,
             krylov_override={"restart": 40, "itmax": 400})
    jmod.run("gmres(full) + DST  [26x ADI cost]", 25.0, M=jfft(), tol_rel=1e-10,
             max_niter=15)
    jmod.run("gmres + ADI(4)  [on-device]", 25.0, M=jadi(4), tol_rel=1e-10,
             max_niter=15)
    jmod.run("gmres + MG-general  [multilevel]", 25.0, M=jmg(), tol_rel=1e-10,
             max_niter=15)
    jmod.run("gmres + ADI(4) + df32 to 1e-8", 25.0, M=jadi(4), tol_rel=1e-8,
             max_niter=15, krylov_dtype=jnp.float32,
             residual_df=jc.residual_scaled_df)
    jmod.run("gmres + MG-general + df32 1e-8", 25.0, M=jmg(), tol_rel=1e-8,
             max_niter=15, krylov_dtype=jnp.float32,
             residual_df=jc.residual_scaled_df)
    jmod.run("gmres + ILU0  [host, reference]", 25.0,
             N_pre=jilu0(offsets=(-n, -1, 0, 1, n)), driver="host",
             tol_rel=1e-10, max_niter=15)
    want = _recipe_lines(capsys.readouterr().out)
    assert len(mine) == len(want) == len(got) == 9
    for key, a, b in zip(got, mine, want):
        fa, fb = fields(a), fields(b)
        print(f"{key}: port {a}\n{' ' * len(key)}  JAX  {b}")
        if "df32" in key:
            assert (fa["solved"], fa["outer"]) == (fb["solved"], fb["outer"]) == (True, 7)
            assert got[key]["err"] <= 1e-9
            continue
        assert a[:36] == b[:36], key  # the recipe
        assert (fa["solved"], fa["outer"]) == (fb["solved"], fb["outer"]), key
        assert abs(fa["inner"] - fb["inner"]) <= (1 if key == "c25 dst full" else 0), key
        if fa["solved"]:  # at the root to rounding in both packages
            assert max(fa["max|u-u*|"], fb["max|u-u*|"]) <= 1e-13, key
        else:  # a stalled iterate (ROADMAP Queue 3 item 24: measured 16%)
            assert rel(fa["max|u-u*|"], fb["max|u-u*|"]) <= 0.25, key
    assert not got["c25 dst restarted"]["solved"]
    assert got["c25 mg"]["inner"] < got["c25 adi"]["inner"] < got["c25 dst full"]["inner"]


def test_bratu_2d_cuda_matches_jax_example(monkeypatch, capsys):
    """128² on the CPU (K1 and K2 as their plain versions): both lanes
    solved, the df32 + DST lane in the JAX example's 6 / 6 and the refined
    CG lane in its 8 outers.  The refined lane's f32 Krylov sums part from
    XLA's and follow the CPU's thread count (ROADMAP Queue 3 items 2 and
    13: measured 8 / 680 with one thread, as here, or eight, 8 / 678 with
    two, against the JAX example's 8 / 680), so its inner count is held
    within 1% and its history, where Queue 3 item 1's f64 lane holds 1e-8,
    to 1e-2 relative before the last entry (measured ≤ 8.7e-4 with one or
    eight threads, 2.4e-3 with two); the last entry, set by the last f32
    correction's rounding (measured 6.0e-3 and 5.8e-2 apart), is held
    under 1e-8·‖F₀‖ in both packages."""
    from newtonkrylov_tpu_torch.examples import bratu_2d_cuda

    jax_example("bratu_2d_tpu", monkeypatch).main()
    want = capsys.readouterr().out
    got = bratu_2d_cuda.main(device="cpu")
    assert got["n"] == 128
    jl = lines(want, "n=128^2")
    assert len(jl) == 2
    for key, line in zip(("refined_cg", "df32_dst"), jl):
        f, g = fields(line), got[key]
        assert (g["solved"], g["outer"]) == (f["solved"], f["outer"]) == (True, 8 if key == "refined_cg" else 6)
        assert abs(g["inner"] - f["inner"]) <= 0.01 * f["inner"]
        assert max(g["n_res"], f["|F|"]) <= 1e-8 * got["refined_cg"]["history"][0]
    hist = np.array([float(x) for x in re.findall(
        r"[-+]?\d\.\d+e[-+]\d+", want.split("residual history:")[1].split("n=128")[0])])
    h = got["refined_cg"]["history"]
    assert h.shape == hist.shape == (9,)
    assert rel(h[0], hist[0]) <= 1e-8  # printed to 9 digits
    err = np.abs(h - hist) / hist
    print(f"history: relative differences {err}")
    assert err[:-1].max() <= 1e-2
    assert got["max_diff"] <= 1e-6  # the two lanes reach the same root


def _jax_sharded(jmod, mesh_shape, axes, spec_axes, M=None):
    from jax.sharding import PartitionSpec as JP

    from newtonkrylov_tpu.halo import make_mesh, newton_krylov_sharded, sharded_residual_2d
    from newtonkrylov_tpu.problems import bratu2d as jb

    p = jb.default_config(64, lam=5.0)
    mesh = make_mesh(mesh_shape, axes)
    F = sharded_residual_2d(jmod.padded_residual,
                            (axes[0], axes[1] if len(axes) > 1 else None),
                            "dirichlet")
    kw = {"algo": "cg"} if M is None else {"algo": "cg", "M": M}
    u, info = newton_krylov_sharded(F, jb.initial_guess(64), p, mesh,
                                    JP(*spec_axes), newton_kwargs=kw)
    return (np.asarray(u), int(info.stats.outer_iterations),
            int(info.stats.inner_iterations))


def test_sharded_bratu_on_four_gloo_ranks(monkeypatch, tmp_path):
    """``rank_main`` on 4 spawned gloo ranks at 64²: the (2, 2) and (4,)
    meshes reach the port's unsharded solve's counts (7 / 241) with states
    within 1e-9 (the JAX example prints max|Δu| ≤ 6e-15), and the global
    DST on (2, 2) its 6 inners; against the JAX package's sharded solves
    on the same meshes of its virtual devices the counts are equal and the
    states within 2e-11 relative (ROADMAP Queue 3 item 20)."""
    from newtonkrylov_tpu.fftprec import fft_poisson as jfft
    from newtonkrylov_tpu_torch.examples import sharded_bratu
    from newtonkrylov_tpu_torch.utils import distributed as D

    ranks = D.run_processes(sharded_bratu.rank_main, 4,
                            timeout=600.0, store_dir=str(tmp_path))
    r = ranks[0]
    assert r["world"] == 4
    assert all(x["dst"]["inner"] == r["dst"]["inner"] for x in ranks)
    single = r["single"]
    assert single["solved"] and (single["outer"], single["inner"]) == (7, 241)
    assert set(r["meshes"]) == {(2, 2), (4,)}
    jmod = jax_example("sharded_bratu", monkeypatch)
    for shape, axes, spec in (((2, 2), ("i", "j"), ("i", "j")),
                              ((4,), ("i",), ("i", None))):
        m = r["meshes"][shape]
        assert m["solved"] and (m["outer"], m["inner"]) == (7, 241)
        assert m["max_diff"] <= 1e-9
        uj, oj, ij = _jax_sharded(jmod, shape, axes, spec)
        assert (m["outer"], m["inner"]) == (oj, ij)
        assert rel(m["u"], uj) <= 2e-11
    d = r["dst"]
    assert d["shape"] == (2, 2) and d["solved"]
    assert d["inner"] == d["single_inner"] == 6 and d["max_diff"] <= 1e-9
    uj, oj, ij = _jax_sharded(jmod, (2, 2), ("i", "j"), ("i", "j"),
                              M=jfft(axis_names=("i", "j"), scope="global"))
    assert (d["outer"], d["inner"]) == (oj, ij)
    assert rel(d["u"], uj) <= 2e-11
