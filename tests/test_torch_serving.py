"""The port's exported solves (``utils/serving.py``) against its live solves
and against the JAX package's exported calls (oracle:
tests/test_utils.py:98-171).

Each solve is exported whole (``torch.export``: the drivers' loops become
``while_loop``\\ s), written to ``tmp_path``, loaded and called.  The loaded
program runs the same ops as the live solve, so its state, counts and
history are held to the live solve's bit for bit.  Against the JAX
package's exported call of the same configuration the counts are equal and
the f64 CG states within 2e-11 relative: the level at which the port's live
solve already agrees with the JAX package's (3.3e-12 measured on Bratu 16²;
torch's and XLA's exp differ in the last bit, ROADMAP.md Queue 3 item 1,
and tests/test_torch_halo.py holds the same 2e-11).  The f32-Krylov
flagship's state is held to 1e-10 relative (Queue 3 items 2 and 13: the
packages' f32 sums differ).  Every input is the JAX package's own
initial guess handed over as numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu.problems import bratu2d as jb
from newtonkrylov_tpu.utils import serving as jserving
from newtonkrylov_tpu_torch.kernels import stencil2d as tk
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.utils import convert
from newtonkrylov_tpu_torch.utils import serving

F32, F64 = torch.float32, torch.float64
TOL_JAX_F64 = 2e-11


def _t(a, dtype=None):
    return convert.state(np.asarray(a), device="cpu", dtype=dtype)


def _roundtrip(fn, args, path):
    """``fn`` exported, saved to ``path``, loaded and called on ``args``."""
    ep = serving.export_solver(fn, args)
    return serving.load_exported(serving.save_exported(ep, str(path))).call(*args)


def _jax_roundtrip(fn, args, path):
    f = jax.jit(fn)
    exp = jserving.export_solver(f, args)
    return jserving.load_exported(jserving.save_exported(exp, str(path))).call(*args)


def _assert_same_run(live, loaded):
    """State, counts (and history) of the loaded program bit for bit."""
    assert len(live) == len(loaded)
    for a, b in zip(live, loaded):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)) or (
            torch.equal(torch.isnan(b), torch.isnan(torch.as_tensor(a)))
            and torch.equal(torch.nan_to_num(torch.as_tensor(a)),
                            torch.nan_to_num(b))), (a, b)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_export_roundtrip(tmp_path):
    """Bratu ``residual_scaled`` at n = 16 with CG (test_export_roundtrip):
    the loaded solve reproduces the live one bit for bit, history included,
    and the JAX package's exported solve within 2e-11 relative with equal
    counts."""
    n = 16
    pj = jb.default_config(n, lam=4.0)
    u0 = np.asarray(jb.initial_guess(n))
    pt = convert.params(pj)

    def fn(u):
        u, info = nkt.newton_krylov_jit(tb.residual_scaled, u, pt, algo="cg")
        return (u, info.stats.outer_iterations, info.stats.inner_iterations,
                info.history)

    live = fn(_t(u0))
    loaded = _roundtrip(fn, (_t(u0),), tmp_path / "solve.pt2")
    _assert_same_run([live[0], torch.tensor(live[1]), torch.tensor(live[2]),
                      live[3]], loaded)

    def jfn(u):
        u, info = nk.newton_krylov_jit(jb.residual_scaled, u, pj, algo="cg")
        return u, info.stats.outer_iterations, info.stats.inner_iterations

    uj, oj, ij = _jax_roundtrip(jfn, (jnp.asarray(u0),), tmp_path / "solve.bin")
    assert (int(loaded[1]), int(loaded[2])) == (int(oj), int(ij))
    assert _rel(loaded[0], uj) <= TOL_JAX_F64


def test_export_roundtrip_production_config(tmp_path):
    """The production flagship at n = 64 (f32 CG, df32 acceptance with its
    floor estimate, ``fft_poisson(precision="high")`` built once,
    ``tol_rel=1e-8``; test_export_roundtrip_production_config), from
    ``entry()``'s f32 guess handed over as f64: the loaded solve equals the
    live one bit for bit; against the JAX package's exported flagship the
    outer and inner counts are equal (6 / 6 on the CPU) and the states
    within 1e-10 relative."""
    from newtonkrylov_tpu.fftprec import fft_poisson as j_fft_poisson
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    n = 64
    pj = jb.default_config(n, lam=5.0)
    pt = convert.params(pj)
    u0 = np.asarray(jb.initial_guess(n, dtype=jnp.float32)).astype(np.float64)
    kw = dict(algo="cg", tol_rel=1e-8, max_niter=20, precond_refresh="once")

    def fn(u):
        u, info = nkt.newton_krylov_jit(
            tb.residual_scaled, u, pt, krylov_dtype=F32,
            residual_df=tb.residual_scaled_df,
            M=fft_poisson(precision="high"), **kw)
        return (u, info.stats.outer_iterations, info.stats.inner_iterations,
                info.solved)

    live = fn(_t(u0))
    loaded = _roundtrip(fn, (_t(u0),), tmp_path / "prod.pt2")
    _assert_same_run([live[0], torch.tensor(live[1]), torch.tensor(live[2]),
                      live[3]], loaded)
    assert bool(loaded[3])

    def jfn(u):
        u, info = nk.newton_krylov_jit(
            jb.residual_scaled, u, pj, krylov_dtype=jnp.float32,
            residual_df=jb.residual_scaled_df,
            M=j_fft_poisson(precision="high"), **kw)
        return u, info.stats.outer_iterations, info.stats.inner_iterations

    uj, oj, ij = _jax_roundtrip(jfn, (jnp.asarray(u0),), tmp_path / "prod.bin")
    print(f"flagship n={n}: port exported {int(loaded[1])}/{int(loaded[2])}, "
          f"JAX exported {int(oj)}/{int(ij)}, relative state difference "
          f"{_rel(loaded[0], uj):.3e}")
    assert (int(loaded[1]), int(loaded[2])) == (int(oj), int(ij))
    assert _rel(loaded[0], uj) <= 1e-10


def test_export_roundtrip_ptc(tmp_path):
    """Ψtc on arctan from x₀ = 3 (test_export_roundtrip_ptc) with the
    driver's default Krylov method, GMRES, on both sides: bit for bit
    against the live solve, within 1e-12 of the JAX package's exported Ψtc
    with equal counts, and at the root."""
    def fn(x):
        x, info = nkt.pseudo_transient(lambda v, p: torch.arctan(v), x)
        return x, info.stats.outer_iterations, info.stats.inner_iterations

    x0 = _t([3.0])
    live = fn(x0)
    loaded = _roundtrip(fn, (x0,), tmp_path / "ptc.pt2")
    _assert_same_run([live[0], torch.tensor(live[1]), torch.tensor(live[2])],
                     loaded)
    assert abs(float(loaded[0][0])) < 1e-5

    def jfn(x):
        x, info = nk.pseudo_transient(lambda v, p: jnp.arctan(v), x)
        return x, info.stats.outer_iterations, info.stats.inner_iterations

    xj, oj, ij = _jax_roundtrip(jfn, (jnp.asarray([3.0]),), tmp_path / "ptc.bin")
    assert (int(loaded[1]), int(loaded[2])) == (int(oj), int(ij))
    np.testing.assert_allclose(loaded[0].numpy(), np.asarray(xj), rtol=0,
                               atol=1e-12)


# Every Krylov method the JAX package exports, inside newton_krylov_jit on
# Bratu 16² in f64 to tol_rel 1e-10 (tight enough that both packages' last
# iterates sit on the same root): (algo, krylov_kwargs).
ALGOS = {
    "gmres": ("gmres", {}),
    "gmres_restarted_mgs": ("gmres", {"restart": 10, "orth": "mgs"}),
    "gmres_blocked": ("gmres", {"restart": None, "itmax": 60,
                                "ortho_block": 8}),
    "fgmres": ("fgmres", {}),
    "bicgstab": ("bicgstab", {}),
    "cg_pipelined": ("cg", {"pipeline": True}),
}


@pytest.mark.parametrize("case", sorted(ALGOS))
def test_export_roundtrip_every_algo(case, tmp_path):
    """The loaded solve equals the live one bit for bit (state, counts,
    history); against the JAX package's exported solve of the same
    configuration the counts are equal and the states within 2e-11
    relative, the file's f64 Bratu level (measured: ≤ 4.1e-14 absolute,
    2.2e-12 for restarted MGS, whose cycles restart from iterates that
    already differ in the last bits)."""
    algo, kw = ALGOS[case]
    n = 16
    pj = jb.default_config(n, lam=4.0)
    u0 = np.asarray(jb.initial_guess(n))
    pt = convert.params(pj)

    def fn(u):
        u, info = nkt.newton_krylov_jit(tb.residual_scaled, u, pt, algo=algo,
                                        tol_rel=1e-10, krylov_kwargs=dict(kw))
        return (u, info.stats.outer_iterations, info.stats.inner_iterations,
                info.history)

    live = fn(_t(u0))
    loaded = _roundtrip(fn, (_t(u0),), tmp_path / "solve.pt2")
    _assert_same_run([live[0], torch.tensor(live[1]), torch.tensor(live[2]),
                      live[3]], loaded)

    def jfn(u):
        u, info = nk.newton_krylov_jit(jb.residual_scaled, u, pj, algo=algo,
                                       tol_rel=1e-10, krylov_kwargs=dict(kw))
        return u, info.stats.outer_iterations, info.stats.inner_iterations

    uj, oj, ij = _jax_roundtrip(jfn, (jnp.asarray(u0),), tmp_path / "solve.bin")
    assert (int(loaded[1]), int(loaded[2])) == (int(oj), int(ij))
    assert _rel(loaded[0], uj) <= TOL_JAX_F64


def test_export_roundtrip_cgls(tmp_path):
    """CGLS, whose loop applies Jᵀ (a traced VJP graph under export), on the
    cubic system A u + u³/10 = b with A = tridiag(−1, 4, −1), n = 32, the
    matrix a parameter (so Jᵀ reads its transpose): bit for bit against the
    live solve; the JAX package's exported solve's counts, states within
    1e-12.  On Bratu 16² the normal equations square κ and the packages'
    f64 inner counts part (474 against 401, ROADMAP Queue 3 item 22)."""
    n = 32
    A = 4.0 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    b = np.sin(np.arange(n) + 1.0)

    def F(u, p):
        return p[0] @ u + 0.1 * u ** 3 - p[1]

    pt = (_t(A), _t(b))

    def fn(u):
        u, info = nkt.newton_krylov_jit(F, u, pt, algo="cgls", tol_rel=1e-10)
        return u, info.stats.outer_iterations, info.stats.inner_iterations

    u0 = _t(np.zeros(n))
    live = fn(u0)
    loaded = _roundtrip(fn, (u0,), tmp_path / "cgls.pt2")
    _assert_same_run([live[0], torch.tensor(live[1]), torch.tensor(live[2])],
                     loaded)

    def jfn(u):
        u, info = nk.newton_krylov_jit(F, u, (jnp.asarray(A), jnp.asarray(b)),
                                       algo="cgls", tol_rel=1e-10)
        return u, info.stats.outer_iterations, info.stats.inner_iterations

    uj, oj, ij = _jax_roundtrip(jfn, (jnp.zeros(n),), tmp_path / "cgls.bin")
    assert (int(loaded[1]), int(loaded[2])) == (int(oj), int(ij))
    np.testing.assert_allclose(loaded[0].numpy(), np.asarray(uj), rtol=0,
                               atol=1e-12)


def test_export_roundtrip_gmres_flagship(tmp_path):
    """The production flagship at n = 64 with the driver's default
    ``algo="gmres"`` (f32 Krylov, df32 acceptance, DST(high) built once):
    the loaded solve equals the live one bit for bit; against the JAX
    package's exported GMRES flagship the counts are equal and the states
    within 1e-10 relative (f32 sums: Queue 3 items 2 and 13)."""
    from newtonkrylov_tpu.fftprec import fft_poisson as j_fft_poisson
    from newtonkrylov_tpu_torch.fftprec import fft_poisson

    n = 64
    pj = jb.default_config(n, lam=5.0)
    pt = convert.params(pj)
    u0 = np.asarray(jb.initial_guess(n, dtype=jnp.float32)).astype(np.float64)
    kw = dict(tol_rel=1e-8, max_niter=20, precond_refresh="once")

    def fn(u):
        u, info = nkt.newton_krylov_jit(
            tb.residual_scaled, u, pt, krylov_dtype=F32,
            residual_df=tb.residual_scaled_df,
            M=fft_poisson(precision="high"), **kw)
        return (u, info.stats.outer_iterations, info.stats.inner_iterations,
                info.solved)

    live = fn(_t(u0))
    loaded = _roundtrip(fn, (_t(u0),), tmp_path / "gmres.pt2")
    _assert_same_run([live[0], torch.tensor(live[1]), torch.tensor(live[2]),
                      live[3]], loaded)
    assert bool(loaded[3])

    def jfn(u):
        u, info = nk.newton_krylov_jit(
            jb.residual_scaled, u, pj, krylov_dtype=jnp.float32,
            residual_df=jb.residual_scaled_df,
            M=j_fft_poisson(precision="high"), **kw)
        return u, info.stats.outer_iterations, info.stats.inner_iterations

    uj, oj, ij = _jax_roundtrip(jfn, (jnp.asarray(u0),), tmp_path / "gmres.bin")
    assert (int(loaded[1]), int(loaded[2])) == (int(oj), int(ij))
    assert _rel(loaded[0], uj) <= 1e-10


def test_export_roundtrip_integrate_scan(tmp_path):
    """``integrate_scan`` exports (its per-step counts stack tensors): four
    implicit-midpoint steps of the spring with the default GMRES, bit for
    bit against the live march."""
    from newtonkrylov_tpu_torch.problems import spring as ts

    def fn(u0):
        r = nkt.integrate_scan("midpoint", ts.rhs, u0, ts.default_config(),
                               0.05, 4)
        return r.u, r.outer_iterations, r.inner_iterations

    u0 = ts.initial_condition(device="cpu")
    live = fn(u0)
    loaded = _roundtrip(fn, (u0,), tmp_path / "scan.pt2")
    _assert_same_run(list(live), loaded)


def test_export_aligned_keeps_kernel_ops(tmp_path):
    """The aligned solve at n = 32 (f64 state, f32 CG): the exported graph
    holds K1 and K2 as the port's custom ops, not their plain versions, and
    the loaded program equals the live solve bit for bit (on the CPU the
    ops run their plain versions; on the card they launch the kernels)."""
    n = 32
    u0, p, space = tb.aligned_setup(n, lam=5.0, dtype=F64, device="cpu")

    def fn(u):
        u, info = nkt.newton_krylov_jit(
            tb.residual_scaled_aligned, u, p, algo="cg", space=space,
            krylov_dtype=F32, tol_rel=1e-8, max_niter=20)
        return u, info.stats.outer_iterations, info.stats.inner_iterations

    ep = serving.export_solver(fn, (u0,))
    targets = {str(node.target) for m in ep.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule) for node in m.graph.nodes}
    assert "newtonkrylov_tpu_torch.stencil_jvp.default" in targets
    assert "newtonkrylov_tpu_torch.bratu_residual.default" in targets
    path = serving.save_exported(ep, str(tmp_path / "aligned.pt2"))
    live = fn(u0)
    loaded = serving.load_exported(path).call(u0)
    _assert_same_run([live[0], torch.tensor(live[1]), torch.tensor(live[2])],
                     loaded)
    assert float(loaded[0][n:].abs().max()) == 0.0  # the layout survives
    ui = tk.aligned_interior(loaded[0], n)
    f = tb.residual_scaled(ui, p)
    f0 = tb.residual_scaled(tk.aligned_interior(u0, n), p)
    assert float(torch.linalg.vector_norm(f)) <= 1e-8 * float(
        torch.linalg.vector_norm(f0)) + 1e-12


def test_export_refuses_host_stepped_paths():
    """A path whose loop reads the host has no exported form and raises:
    the host-stepped driver ``newton_krylov`` (every Krylov method
    exports, the tests above)."""
    x0 = _t([3.0])
    with pytest.raises(Exception, match="no exported form"):
        serving.export_solver(
            lambda x: nkt.newton_krylov(lambda v, p: torch.arctan(v), x,
                                        algo="cg")[0], (x0,))
    with pytest.raises(Exception, match="no exported form"):
        serving.export_solver(
            lambda x: nkt.newton_krylov(lambda v, p: torch.arctan(v), x)[0],
            (x0,))
