"""The port's example gallery against the JAX package's (see
tests/test_torch_examples_a.py): the 1-D Bratu recipe gallery, Kelley's
BVP, continuation to the 2-D Bratu fold and pseudo-transient
continuation, on the CPU in f64."""

import re

import numpy as np

from test_torch_examples_a import fields, jax_example, lines, one_thread, rel  # noqa: F401

# the size of the gallery's three CG recipes here: at the example's
# N = 10⁴ they take tens of thousands of host-stepped iterations each
CG_N = 512


def _strip_time(line):
    return re.sub(r" t=\S+", "", line)


def test_bratu_1d_matches_jax_example(monkeypatch, capsys):
    """The direct and negative recipes at the example's N = 10⁴ through the
    JAX example's own ``run`` — the printed lines (less the wall) identical
    and the states within 1e-9 relative, except BiCGStab's inner count,
    which follows the summation order (ROADMAP Queue 3 item 16: measured
    139 with this CPU's default threads and 189 with two, against 150; its
    outer count, ``solved`` and error agree).  The three CG recipes at N = 512 (at
    N = 10⁴ they take 58,344–73,073 CG iterations each) against the JAX
    package's ``newton_krylov``: ``solved``, the outer counts and the
    states within 1e-9 absolute; their inner counts part (item 16)."""
    from newtonkrylov_tpu import Fixed as JFixed
    from newtonkrylov_tpu import newton_krylov as jnk
    from newtonkrylov_tpu import precond as jp
    from newtonkrylov_tpu.problems import bratu1d as jb
    from newtonkrylov_tpu_torch.examples import bratu_1d

    got = bratu_1d.main(device="cpu", cg_n=CG_N)
    out = capsys.readouterr().out

    jmod = jax_example("bratu_1d", monkeypatch)
    negative = dict(max_niter=4, krylov_kwargs={"itmax": 60})
    recipes = {
        "gmres + ILU0 (host C++)": dict(algo="gmres", N=jp.ilu0(bandwidth=1)),
        "gmres + banded direct": dict(algo="gmres", N=jp.banded_direct()),
        "gmres, NO preconditioner": dict(
            expect_fail=True, algo="gmres", max_niter=4,
            krylov_kwargs={"restart": 20, "itmax": 60}),
        "bicgstab": dict(expect_fail=True, algo="bicgstab", **negative),
        "cgls": dict(expect_fail=True, algo="cgls", **negative),
    }
    for tag, kw in recipes.items():
        u = jmod.run(tag, **kw)
        want = capsys.readouterr().out.strip()
        mine = [ln for ln in lines(out, tag) if ln[:28].strip() == tag]
        assert len(mine) == 1, tag
        f, r = fields(want), got[tag]
        assert (r["solved"], r["outer"]) == (f["solved"], f["outer"]), tag
        assert f"{r['err']:.2e}" == f"{f['max|u-u*|']:.2e}", tag
        if tag == "bicgstab":  # its inner count: Queue 3 item 16
            continue
        assert _strip_time(mine[0]) == _strip_time(want), tag
        if not kw.get("expect_fail"):
            assert rel(r["u"], u) <= 1e-9, tag

    p = jb.default_config(CG_N)
    u0 = jb.initial_guess(CG_N)
    u_star = np.asarray(jb.true_solution(jb.grid(CG_N)))
    for tag, kw in (("cg (recommended)", dict(algo="cg")),
                    ("cg + Fixed(0.1)", dict(algo="cg", forcing=JFixed(0.1))),
                    ("cg + exact Newton", dict(algo="cg", forcing=None))):
        u, info = jnk(jb.residual, u0, p, **kw)
        r = got[tag]
        print(f"{tag} N={CG_N}: port {r['outer']}/{r['inner']}, JAX "
              f"{info.stats.outer_iterations}/{info.stats.inner_iterations}")
        assert r["n"] == CG_N and r["solved"] and bool(info.solved)
        assert r["outer"] == info.stats.outer_iterations
        assert np.abs(r["u"] - np.asarray(u)).max() <= 1e-9
        assert abs(r["err"] - float(np.abs(np.asarray(u) - u_star).max())) <= 1e-9


def test_bvp_kelley_matches_jax():
    """GMRES + banded LU(2, 2) at n = 801 against the JAX package's: equal
    counts (9 / 9), ‖F‖ and the state within 1e-8 relative; the stalling
    FGMRES + nested GMRES(30) recipe with its inner solves capped at 40
    (uncapped each runs 3,204 FGMRES steps issued from the host here):
    unsolved after 5 outers in both packages with equal counts (6 / 201),
    ‖F‖ above 1e-2 and within 5% of each other — a stalled iterate
    amplifies last-bit differences (ROADMAP Queue 3 item 24: measured
    5.670e-2 against 5.755e-2)."""
    from newtonkrylov_tpu import newton_krylov as jnk
    from newtonkrylov_tpu import precond as jp
    from newtonkrylov_tpu.problems import bvp as jbvp
    from newtonkrylov_tpu_torch.examples import bvp_kelley

    got = bvp_kelley.main(device="cpu", nested_itmax=40)
    p = jbvp.default_config()
    U0 = jbvp.initial_guess(p)
    U, info = jnk(jbvp.residual, U0, p, algo="gmres", N=jp.banded_lu(2, 2))
    g = got["banded_lu"]
    assert g["solved"] and bool(info.solved)
    assert (g["outer"], g["inner"]) == (info.stats.outer_iterations,
                                        info.stats.inner_iterations) == (9, 9)
    assert rel(g["U"], U) <= 1e-8
    assert rel(g["n_res"], info.stats.n_res) <= 1e-2
    _, info2 = jnk(jbvp.residual, U0, p, algo="fgmres",
                   N=jp.nested_krylov(itmax=30),
                   krylov_kwargs={"restart": 40, "itmax": 40}, max_niter=5)
    g2 = got["nested"]
    print(f"nested: port |F| {g2['n_res']:.4e} {g2['outer']}/{g2['inner']}, "
          f"JAX {float(info2.stats.n_res):.4e} "
          f"{info2.stats.outer_iterations}/{info2.stats.inner_iterations}")
    assert not g2["solved"] and not bool(info2.solved)
    assert (g2["outer"], g2["inner"]) == (info2.stats.outer_iterations,
                                          info2.stats.inner_iterations)
    assert rel(g2["n_res"], float(info2.stats.n_res)) <= 5e-2
    assert g2["n_res"] > 1e-2


def test_continuation_bratu_matches_jax_example(monkeypatch, capsys):
    """λ = 1 → 6.80 at 96²: the JAX example's lines exactly (solved, the
    outer and inner counts, max u), and λ = 7.50 unsolved past the fold."""
    from newtonkrylov_tpu_torch.examples import continuation_bratu

    jax_example("continuation_bratu", monkeypatch).main()
    want = lines(capsys.readouterr().out, "lam=")
    got = continuation_bratu.main(device="cpu")
    assert lines(capsys.readouterr().out, "lam=") == want
    assert len(want) == 9
    assert [s["outer"] for s in got["steps"]] == [4, 5, 6, 7, 7, 7, 6, 7]
    assert got["past_fold"]["solved"] is False


def test_ptc_globalization_matches_jax_example(monkeypatch, capsys):
    """Newton diverges on arctan from x₀ = 3 and Ψtc solves it in 6 steps;
    at λ = 6.8 from the four rough starts Ψtc takes no more outer steps
    than Newton: the JAX example's lines exactly."""
    from newtonkrylov_tpu_torch.examples import ptc_globalization

    jmod = jax_example("ptc_globalization", monkeypatch)
    jmod.arctan_comparison()
    jmod.bratu_rough_starts()
    want = capsys.readouterr().out.splitlines()
    got = ptc_globalization.main(device="cpu")
    assert capsys.readouterr().out.splitlines() == want
    assert got["arctan"]["ptc"]["outer"] == 6
    assert [r["ptc_outer"] for r in got["bratu"].values()] == [7, 9, 9, 10]
