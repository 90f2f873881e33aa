"""The port's example gallery (``newtonkrylov_tpu_torch/examples``) against
the JAX package's (``examples/``), on the CPU in f64: the Kelley 2×2
traces and the time-stepping examples.

Where the JAX example is cheap its ``main()`` runs here with ``save_plot``
a no-op and its printed lines are compared with the port's, line for line
or field by field.  The marches run at a cut depth through both packages'
functions (each port step is a Newton solve whose every outer traces its
linearization on the host, ~0.1 s here: ROADMAP Queue 1 item 23); the
depth is stated in each test.  f64 counts are held equal; the states
within the stated tolerance.  The helpers here serve the other
``test_torch_examples_*`` files too.
"""

import importlib
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
NUM = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread while an example runs: its ops are tiny and issued
    one at a time, and the test workers share the CPU (restored after)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_example(name, monkeypatch):
    """The JAX example ``examples/<name>.py`` as a module, its
    ``save_plot`` a no-op (figures are drawn, not written)."""
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    mod = importlib.import_module(name)
    if hasattr(mod, "_common"):
        monkeypatch.setattr(mod._common, "save_plot", lambda fig, name: None)
    return mod


def lines(out, prefix=""):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def fields(line):
    """The ``key=value`` pairs of a printed line: numbers as floats,
    ``True``/``False`` as bools."""
    out = {}
    for key, val in re.findall(r"([\w|*()\-]+)=\s*(" + NUM + r"|True|False)", line):
        out[key] = (val == "True") if val in ("True", "False") else float(val)
    return out


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_examples_refuse_the_cpu_fallback():
    """Every example defaults to the card: without CUDA, ``main()`` raises
    instead of running on the CPU."""
    import torch

    from newtonkrylov_tpu_torch import examples

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for name in examples.NAMES:
        mod = importlib.import_module(f"newtonkrylov_tpu_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="--device cpu"):
            mod.main()


def test_simple_2d_matches_jax_example(monkeypatch, capsys):
    """The three starts print the JAX example's lines exactly: solved, the
    outer and inner counts (10 / 13, 8 / 10, 16 / 25 to the other root) and
    the root to six decimals."""
    from newtonkrylov_tpu_torch.examples import simple_2d

    jax_example("simple_2d", monkeypatch).main()
    want = lines(capsys.readouterr().out, "x0=")
    got = simple_2d.main(device="cpu")
    assert lines(capsys.readouterr().out, "x0=") == want
    assert len(want) == 3
    for r, line in zip(got["runs"], want):
        f = fields(line)
        assert (r["solved"], r["outer"], r["inner"]) == (f["solved"], f["outer"], f["inner"])
        assert r["trace"].shape == (r["outer"] + 1, 2)
    np.testing.assert_allclose(got["runs"][2]["u"], [-0.47767, 1.331102], atol=1e-6)


def test_spring_implicit_matches_jax():
    """The step-Jacobian probes equal the JAX package's; the damping check
    at a cut depth, 10 steps of Δt = 0.1 (the example's t = 40 is 400
    steps a stepper), against the JAX package's ``integrate``: equal
    per-step counts, amplitudes within 1e-12 relative."""
    from newtonkrylov_tpu.problems import spring as js
    from newtonkrylov_tpu.timestep import integrate, step_jacobian
    from newtonkrylov_tpu_torch.examples import spring_implicit

    got = spring_implicit.main(device="cpu", t_final=1.0)
    p = js.default_config()
    for name, J in got["jacobians"].items():
        want = np.asarray(step_jacobian(name, js.rhs, jnp.array([0.1, 0.0]), p, 0.1))
        np.testing.assert_allclose(J, want, rtol=0, atol=1e-15)
    for name in ("euler", "trapezoid"):
        r = integrate(name, js.rhs, js.initial_condition(), p, 0.1, 1.0)
        assert got["n_failed"][name] == int(r.n_failed) == 0
        assert rel(got["amplitude"][name], abs(float(r.u[0]))) <= 1e-12
    assert got["amplitude"]["euler"] < got["amplitude"]["trapezoid"]


def test_heat_1d_matches_jax_example(monkeypatch, capsys):
    """The rank and condition studies print the JAX example's lines
    exactly (dense at N = 10, matrix-free at N = 10 and the k = 128 Lanczos
    lower bound at N = 10⁵); the march at a cut depth, t = 0.3 (3 of the 30
    steps), against the JAX package's ``integrate`` as Queue 3 item 18
    states GMRES(100) marches (:func:`_check_gmres_march`)."""
    from newtonkrylov_tpu.problems import heat1d as jh
    from newtonkrylov_tpu.timestep import integrate
    from newtonkrylov_tpu_torch.examples import heat_1d

    jmod = jax_example("heat_1d", monkeypatch)
    jmod.jacobian_study()
    jmod.jacobian_study_matrix_free()
    want = capsys.readouterr().out.splitlines()
    got = heat_1d.main(device="cpu", t_final=0.3)
    assert capsys.readouterr().out.splitlines() == want
    assert got["matrix_free"]["lower_bound"] > 2900

    p = jh.default_config(100, 0.2)
    u0 = jh.clamp_bc(jh.initial_condition(jh.grid(100)), p)
    for name, m in got["march"].items():
        r = integrate(name, jh.rhs, u0, p, 0.1, 0.3)
        _check_gmres_march(m, r, steps=3)


def _check_gmres_march(m, r, steps, tol_abs=6e-6):
    """A GMRES(100) march against the JAX package's, as ROADMAP Queue 3
    item 18 states them: no failed step, outer counts within one a step,
    inner counts free (measured: heat1d's third step 110 against 104), the
    states within steps × tol_abs."""
    outer, inner = np.asarray(r.outer_iterations), np.asarray(r.inner_iterations)
    print(f"outer {m['outer'].tolist()} / {outer.tolist()}, inner "
          f"{m['inner'].tolist()} / {inner.tolist()}, max|du| "
          f"{np.abs(m['u'] - np.asarray(r.u)).max():.3e}")
    assert m["n_failed"] == int(r.n_failed) == 0
    assert np.abs(m["outer"] - outer).max() <= 1
    assert np.abs(m["u"] - np.asarray(r.u)).max() <= steps * tol_abs


def test_heat_1d_dg_matches_jax():
    """The DG step Jacobian's shape and condition number as the JAX
    example prints them; both marches at a cut depth, t = 0.002 (4 of the
    100 steps), against the JAX package's: equal per-step counts (7 outers
    a DG step), norms and states within 1e-10 relative."""
    from newtonkrylov_tpu.problems import heat1d_dg as jd
    from newtonkrylov_tpu.timestep import integrate, step_jacobian
    from newtonkrylov_tpu_torch.examples import heat_1d_dg

    got = heat_1d_dg.main(device="cpu", t_final=0.002)
    p_dg = jd.dg_config(polydeg=3, elements=40)
    J = np.asarray(step_jacobian("euler", jd.rhs, jnp.zeros_like(p_dg.x), p_dg, 0.1))
    assert got["shape"] == J.shape == (160, 160)
    assert f"{got['cond']:.4g}" == f"{np.linalg.cond(J):.4g}" == "5.717e+04"
    for tag, p in (("legendre DG", p_dg), ("upwind order-3", jd.upwind_config(nnodes=120))):
        r = integrate("euler", jd.rhs, jd.initial_condition(p), p, 0.0005, 0.002)
        m = got[tag]
        assert m["n_failed"] == int(r.n_failed) == 0
        assert m["outer"].tolist() == np.asarray(r.outer_iterations).tolist()
        assert m["inner"].tolist() == np.asarray(r.inner_iterations).tolist()
        assert rel(m["u"], r.u) <= 1e-10
        assert rel(m["norm_u"], float(jnp.linalg.norm(r.u))) <= 1e-10


def test_heat_2d_matches_jax():
    """Δt as the JAX example prints it; the three steppers at a cut depth,
    4 of the 40 steps, with the example's CG (reorthogonalized), against
    the JAX package's ``integrate``: equal per-step counts, decays within
    1e-10 relative and at the analytic rate within 1e-3; the periodic
    constant field is an equilibrium."""
    from newtonkrylov_tpu.problems import heat2d as jh
    from newtonkrylov_tpu.timestep import integrate
    from newtonkrylov_tpu_torch.examples import heat_2d

    steps = 4
    got = heat_2d.main(device="cpu", steps=steps)
    p = jh.default_config(40)
    dt = jh.stable_dt(p)
    assert f"{got['dt']:.4g}" == f"{dt:.4g}" == "0.01487"
    u0 = jh.initial_condition(40)
    for name in ("euler", "midpoint", "trapezoid"):
        r = integrate(name, jh.rhs, u0, p, dt, steps * dt,
                      newton_kwargs={"algo": "cg",
                                     "krylov_kwargs": {"reorthogonalize": True}})
        m = got[name]
        assert m["n_failed"] == int(r.n_failed) == 0
        assert m["outer"].tolist() == np.asarray(r.outer_iterations).tolist()
        assert m["inner"].tolist() == np.asarray(r.inner_iterations).tolist()
        assert rel(m["decay"], float(jnp.max(r.u) / jnp.max(u0))) <= 1e-10
        assert abs(m["decay"] - m["analytic"]) <= 1e-3
    assert got["periodic_residual"] == 0.0
