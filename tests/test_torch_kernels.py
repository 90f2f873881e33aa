"""The port's stencil kernels (K1 stencil_jvp, K2 bratu_residual) against the
JAX package's Pallas kernels, which run here in interpret mode as in
tests/test_kernels.py.

On the CPU each custom op runs its plain PyTorch version, so these tests hold
the plain versions (and the op dispatch around them) against the Pallas
kernels, in float64 with atol 1e-12 as the JAX kernel tests use.  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.  K7 (bratu_residual_df), which has no Pallas
counterpart, is held here to the eager df32 chain it replaces on the card.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonkrylov_tpu.kernels import stencil2d as jk
from newtonkrylov_tpu.problems import bratu2d as jb
from newtonkrylov_tpu_torch import df32
from newtonkrylov_tpu_torch.kernels import stencil2d as tk
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.utils import convert

F64 = torch.float64


def _rand(n, seed, absval=False, shift=0.0):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (np.abs(a) if absval else a) + shift


def _wrap_both(a):
    """The same interior in the aligned layout: (jax array, torch tensor)."""
    return jk.aligned_wrap(jnp.asarray(a)), tk.aligned_wrap(convert.state(a, device="cpu"))


@pytest.mark.parametrize("n", [16, 32, 64])
def test_layout_helpers_match_jax(n):
    assert tk.round_up(n + 2, 128) == jk.round_up(n + 2, 128)
    vj, vt = _wrap_both(_rand(n, 0))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(tk.aligned_interior(vt, n).numpy(),
                                  np.asarray(jk.aligned_interior(vj, n)))
    np.testing.assert_array_equal(tk.aligned_mask(n, F64, device="cpu").numpy(),
                                  np.asarray(jk.aligned_mask(n, jnp.float64)))
    with pytest.raises(ValueError, match="multiple of 8"):
        tk.aligned_mask(n + 4, device="cpu")


@pytest.mark.parametrize("n,T", [(16, 256), (32, 256), (64, 256), (64, 16)],
                         ids=["n16", "n32", "n64", "n64-T16-multitile"])
def test_stencil_jvp_matches_pallas(n, T):
    vj, vt = _wrap_both(_rand(n, 1))
    wj, wt = _wrap_both(_rand(n, 2, absval=True, shift=0.1))
    ref = np.asarray(jk.stencil_jvp_pallas(vj, wj, n, T=T))
    np.testing.assert_allclose(tk.stencil_jvp(vt, wt, n).numpy(), ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tk.stencil_jvp_xla(vt, wt, n).numpy(),
                               np.asarray(jk.stencil_jvp_xla(vj, wj, n)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n,T", [(16, 256), (32, 8), (64, 256), (64, 16)],
                         ids=["n16", "n32-T8", "n64", "n64-T16-multitile"])
def test_bratu_residual_matches_pallas(n, T):
    scale = 5.0 / (n + 1) ** 2
    uj, ut = _wrap_both(_rand(n, 3))
    ref = np.asarray(jk.bratu_residual_pallas(uj, n, scale, T=T))
    np.testing.assert_allclose(tk.bratu_residual(ut, n, scale).numpy(), ref,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [16, 32])
def test_ghost_invariant(n):
    """Both ops return a valid ghost-carrying array: apron and ghost
    columns exactly zero."""
    _, vt = _wrap_both(_rand(n, 4))
    _, wt = _wrap_both(_rand(n, 5, absval=True))
    for out in (tk.stencil_jvp(vt, wt, n), tk.bratu_residual(vt, n, 1e-3)):
        out = out.numpy()
        assert np.all(out[n:, :] == 0)
        assert np.all(out[:, 0] == 0)
        assert np.all(out[:, n + 1:] == 0)


def test_aligned_residual_forward_matches_jax():
    n = 32
    pj = jb.default_config(n, lam=4.0)
    uj, ut = _wrap_both(0.5 * _rand(n, 6))
    np.testing.assert_allclose(
        tb.residual_scaled_aligned(ut, convert.params(pj)).numpy(),
        np.asarray(jb.residual_scaled_aligned(uj, pj)), rtol=0, atol=1e-12)


def test_aligned_residual_custom_jvp_consistent():
    """The JVP through the aligned residual (K1 path) matches JAX's aligned
    custom JVP and the plain residual's JVP on the interior (the check of
    tests/test_kernels.py:89-103, held against the JAX package)."""
    n = 16
    pj = jb.default_config(n, lam=4.0)
    pt = convert.params(pj)
    u0i = np.asarray(jb.initial_guess(n))
    vi = _rand(n, 7)
    uj, ut = _wrap_both(u0i)
    vj, vt = _wrap_both(vi)
    _, jv_j = jax.jvp(lambda u: jb.residual_scaled_aligned(u, pj), (uj,), (vj,))
    _, jv_t = torch.func.jvp(lambda u: tb.residual_scaled_aligned(u, pt), (ut,), (vt,))
    np.testing.assert_allclose(jv_t.numpy(), np.asarray(jv_j), rtol=0, atol=1e-12)
    _, jv_plain = torch.func.jvp(lambda u: tb.residual_scaled(u, pt),
                                 (convert.state(u0i, device="cpu"),),
                                 (convert.state(vi, device="cpu"),))
    np.testing.assert_allclose(tk.aligned_interior(jv_t, n).numpy(), jv_plain.numpy(),
                               rtol=0, atol=1e-10)
    # and the linearized replay the solvers use gives the same matvec
    from newtonkrylov_tpu_torch import JacobianOperator

    J = JacobianOperator(tb.residual_scaled_aligned, ut, pt)
    np.testing.assert_allclose(J.mv(vt).numpy(), jv_t.numpy(), rtol=0, atol=1e-13)


def test_no_launch_counted_on_cpu():
    """CPU tensors take the plain versions: no kernel launches are counted."""
    n = 16
    tk.reset_launch_counts()
    _, vt = _wrap_both(_rand(n, 8))
    tk.stencil_jvp(vt, vt, n)
    tk.bratu_residual(vt, n, 1e-3)
    from newtonkrylov_tpu_torch import JacobianOperator

    JacobianOperator(tb.residual_scaled_aligned, vt, tb.default_config(n, 4.0)).mv(vt)
    tk.stencil_jvp_chain(vt, vt, n, 3, 0.125)
    tk.stencil_chain_probe(vt, vt, n, 2)
    tk.chebyshev_apply(vt, vt, torch.tensor([-4.0, 3.0, 1.0], dtype=F64), n, 2)
    w = torch.ones((n + 2, n + 2), dtype=torch.float32)
    tk.bratu_residual_df(w, w, w[1:-1, 1:-1], w[1:-1, 1:-1], 1e-3)
    assert tk.LAUNCHES == dict.fromkeys(
        ["stencil_jvp", "bratu_residual", "stencil_jvp_chain",
         "stencil_chain_probe", "chebyshev_apply", "bratu_residual_df"], 0)


@pytest.mark.parametrize("op", ["stencil_jvp", "bratu_residual",
                                "bratu_residual_df"])
def test_custom_op_registration(op):
    """Schema, fake (meta) implementation and tracing of each custom op pass
    torch.library.opcheck — what torch.func.linearize and an export rely
    on."""
    n = 16
    _, vt = _wrap_both(_rand(n, 9))
    args = {"stencil_jvp": (vt, vt.abs(), n), "bratu_residual": (vt, n, 1e-3),
            "bratu_residual_df": (*_df_words((n + 2, 12), 9),
                                  *_df_words((n, 10), 19), 1e-3)}[op]
    result = torch.library.opcheck(getattr(tk, op), args)
    assert set(result.values()) == {"SUCCESS"}


def test_build_names_library_by_source_digest_and_needs_nvcc(monkeypatch, tmp_path):
    from newtonkrylov_tpu_torch.kernels import build

    path = build.library_path("stencil2d")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libstencil2d-")
    root = Path(__file__).resolve().parents[1]
    assert "newtonkrylov_tpu_torch/_build/" in (root / ".gitignore").read_text()
    # without nvcc the first use fails with a clear error, before any launch
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("stencil2d")


def test_ops_reject_other_devices():
    n = 16
    v = torch.zeros((n + 8, 128), dtype=F64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tk._on_cpu(v)


# -- K7, the df32 Bratu acceptance residual ------------------------------------
#
# On the CPU the op is the eager df32 chain, held here to the JAX package's
# residual_scaled_df_padded bit for bit; tests/test_torch_cuda.py holds the
# kernel to that chain on the card.


def _df_words(shape, seed, scale=1.0):
    """A df32 pair (hi, lo) of float32 words from random float64 values."""
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return tuple(df32.df_from_f64(torch.from_numpy(x)))


def _jax_df(words):
    from newtonkrylov_tpu import df32 as jd

    return jd.DF(*(jnp.asarray(w.numpy()) for w in words))


def _assert_words_equal(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      w.view(np.uint32))


@pytest.mark.parametrize("c", [6.0 / 17 ** 2, -0.75], ids=["c>0", "c<0"])
@pytest.mark.parametrize("shape", [(16, 16), (7, 5), (1, 9), (9, 1), (13, 130)])
def test_bratu_residual_df_cpu_is_the_eager_chain(shape, c):
    """On CPU tensors K7 returns the words of the JAX package's df32 chain
    (``residual_scaled_df_padded``) bit for bit, whatever the interior (not
    the padded block's centre), and so do the residuals that call it; no
    launch is counted."""
    n, m = shape
    up = df32.DF(*_df_words((n + 2, m + 2), n * m, 0.5))
    u = df32.DF(*_df_words((n, m), n + m, 0.5))
    p = tb.Params(dx=1.0, lam=c)
    pj = jb.Params(dx=1.0, lam=c)
    want = jb.residual_scaled_df_padded(_jax_df(up), _jax_df(u), pj)
    tk.reset_launch_counts()
    _assert_words_equal(tk.bratu_residual_df(*up, *u, c), want)
    _assert_words_equal(tb.residual_scaled_df_padded(up, u, p), want)
    _assert_words_equal(tb.residual_scaled_df(u, p),
                        jb.residual_scaled_df(_jax_df(u), pj))
    assert tk.LAUNCHES["bratu_residual_df"] == 0


def test_bratu_residual_df_fake_shapes_and_make_fx():
    """The fake gives the interior's shape and float32 for both words, and a
    make_fx trace of the df32 residual holds one K7 call."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    n, m = 6, 11
    with FakeTensorMode():
        up = torch.empty((n + 2, m + 2), dtype=torch.float32)
        u = torch.empty((n, m), dtype=torch.float32)
        hi, lo = tk.bratu_residual_df(up, up, u, u, 0.5)
    for w in (hi, lo):
        assert tuple(w.shape) == (n, m) and w.dtype == torch.float32
    p = tb.default_config(n, lam=6.0)
    gm = make_fx(lambda h, l: tuple(tb.residual_scaled_df(df32.DF(h, l), p)),
                 tracing_mode="fake")(*_df_words((n, n), 3))
    calls = [x for x in gm.graph.nodes
             if x.target is torch.ops.newtonkrylov_tpu_torch.bratu_residual_df.default]
    assert len(calls) == 1


@pytest.mark.parametrize("case", ["padded shape", "lo shape", "one-d", "empty",
                                  "float64", "devices", "c = 0"])
def test_bratu_residual_df_rejects_bad_inputs(case):
    n, m = 5, 7
    up_hi, up_lo = _df_words((n + 2, m + 2), 1)
    u_hi, u_lo = _df_words((n, m), 2)
    c = 0.5
    if case == "padded shape":
        up_hi, up_lo = up_hi[:-1], up_lo[:-1]
    elif case == "lo shape":
        u_lo = u_lo[:, :-1]
    elif case == "one-d":
        up_hi, up_lo, u_hi, u_lo = (w.reshape(-1) for w in (up_hi, up_lo, u_hi, u_lo))
    elif case == "empty":
        up_hi, up_lo, u_hi, u_lo = (w[:, :0] for w in (up_hi, up_lo, u_hi, u_lo))
    elif case == "float64":
        u_lo = u_lo.double()
    elif case == "devices":
        u_hi = u_hi.to("meta")
    else:
        c = 0.0
    with pytest.raises(ValueError, match="bratu_residual_df|nonzero"):
        tk.bratu_residual_df(up_hi, up_lo, u_hi, u_lo, c)


def test_exported_df32_solve_calls_k7(tmp_path):
    """A CPU torch.export of the df32 Bratu flagship at 16² holds K7 in its
    loop bodies, and the loaded program returns the live solve bit for bit."""
    import newtonkrylov_tpu_torch as nkt
    from newtonkrylov_tpu_torch.fftprec import fft_poisson
    from newtonkrylov_tpu_torch.utils import serving

    n = 16
    p = tb.default_config(n, lam=6.0)
    u0 = tb.initial_guess(n, dtype=F64, device="cpu")

    def fn(u):
        u, info = nkt.newton_krylov_jit(
            tb.residual_scaled, u, p, algo="cg", tol_rel=1e-8,
            krylov_dtype=torch.float32, residual_df=tb.residual_scaled_df,
            max_niter=20, M=fft_poisson(precision="high"),
            precond_refresh="once")
        return u, info.stats.outer_iterations, info.stats.inner_iterations

    live = fn(u0)
    ep = serving.export_solver(fn, (u0,))
    op = torch.ops.newtonkrylov_tpu_torch.bratu_residual_df.default
    calls = sum(x.target is op for g in ep.graph_module.modules()
                if isinstance(g, torch.fx.GraphModule) for x in g.graph.nodes)
    assert calls >= 2  # the initial residual and the outer loop's
    loaded = serving.load_exported(serving.save_exported(
        ep, str(tmp_path / "df32.pt2")))
    u, outer, inner = loaded.call(u0)
    assert (int(outer), int(inner)) == (live[1], live[2])
    assert torch.equal(u, live[0])


# -- the chained kernels K3, K4, K5 -------------------------------------------
#
# Tolerances: float64 rtol 1e-12 with atol 1e-12·max|ref|; float32 within 4
# ulp of max|ref|.  The port's plain versions round every operation in IEEE
# order (numpy's evaluation of the same expression agrees with them bit for
# bit); XLA:CPU contracts multiply-adds into FMAs, so the Pallas kernels in
# interpret mode differ in the last bits (ROADMAP.md Queue 3).

def _assert_close(got, ref, dtype):
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    if dtype == F64:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12 * scale)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=4 * np.finfo(np.float32).eps * scale)


def _wrap_both_as(a, dtype):
    return _wrap_both(a.astype({F64: np.float64, torch.float32: np.float32}[dtype]))


@pytest.mark.parametrize("dtype", [F64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("n", [16, 32])
def test_stencil_jvp_chain_matches_pallas(n, k, dtype):
    vj, vt = _wrap_both_as(_rand(n, 10), dtype)
    wj, wt = _wrap_both_as(_rand(n, 11, absval=True, shift=0.1), dtype)
    ref = jk.stencil_jvp_chain_pallas(vj, wj, n, k, 0.125)
    got = tk.stencil_jvp_chain(vt, wt, n, k, 0.125)
    assert got.dtype == dtype
    _assert_close(got, ref, dtype)
    assert float(got[n:].abs().max()) == float(got[:, 0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [F64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("k", [2, 4])
def test_stencil_chain_probe_matches_pallas(k, dtype):
    n = 16
    vj, vt = _wrap_both_as(_rand(n, 12), dtype)
    wj, wt = _wrap_both_as(_rand(n, 13, absval=True, shift=0.1), dtype)
    _assert_close(tk.stencil_chain_probe(vt, wt, n, k),
                  jk.stencil_chain_probe_pallas(vj, wj, n, k), dtype)


def test_stencil_chain_probe_rejects_odd_k():
    n = 16
    _, vt = _wrap_both(_rand(n, 14))
    for fn in (tk.stencil_chain_probe, tk.stencil_chain_probe_xla):
        with pytest.raises(ValueError, match="even"):
            fn(vt, vt, n, 3)
    with pytest.raises(ValueError, match="degree"):
        tk.chebyshev_apply(vt, vt, torch.zeros(3, dtype=F64), n, -1)


@pytest.mark.parametrize("dtype", [F64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("degree", [1, 4, 7])
def test_chebyshev_apply_matches_pallas(degree, dtype):
    """K4 on the probed interval of a Bratu Jacobian: diag = d/o with
    d = Δx²λeᵘ − 4, o = 1, and (θ, δ) from the JAX package's _cheb_bounds."""
    from newtonkrylov_tpu.precond import _cheb_bounds

    n = 16
    npdt = {F64: np.float64, torch.float32: np.float32}[dtype]
    p = jb.default_config(n, lam=5.0)
    d = (p.dx * p.dx * p.lam * np.exp(np.asarray(jb.initial_guess(n))) - 4.0).astype(npdt)
    o = npdt(1.0)
    theta, delta = _cheb_bounds(jnp.asarray(o), jnp.asarray(d.min()), jnp.asarray(d.max()),
                                None, 1.0 / 30.0, jnp.dtype(npdt))
    rj, rt = _wrap_both_as(_rand(n, 15), dtype)
    dj, dt_ = _wrap_both_as(d / o, dtype)
    ref = jk.chebyshev_apply_pallas(rj, dj, theta, delta, o, n, degree)
    scal = torch.tensor(np.array([theta, delta, o], dtype=npdt))
    got = tk.chebyshev_apply(rt, dt_, scal, n, degree)
    assert got.dtype == dtype
    _assert_close(got, ref, dtype)


# -- the launch plan of the chained kernels (csrc/tiled.cuh) -------------------

@pytest.mark.parametrize("name,steps", [("chebyshev_apply", 16),
                                        ("stencil_jvp_chain", 200)],
                         ids=["K4-degree16", "K3-k200"])
@pytest.mark.parametrize("dtype", [torch.float32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [64, 520, 2048])
def test_tile_plan_fits_and_covers(n, dtype, name, steps):
    """_tile_plan: shared memory within the 232,448 bytes a block may have
    and equal to two buffers of the micro-tiles' edges; a block of whole
    warps (the kernels test the interior warp by warp), ≤ 1024 threads;
    tiles that cover all of (R, C); S ≥ 1 steps a pass
    and enough passes for the call — one for K4 at degree 16 in f32."""
    plan = tk._tile_plan(name, n, dtype, steps)
    R, C = n + 8, tk.round_up(n + 2, 128)
    H, W = plan.region()
    itemsize = 4 if dtype == torch.float32 else 8
    bx, by = plan.block()
    assert plan.smem_bytes <= 232_448
    assert plan.smem_bytes == 2 * 2 * bx * (H + by * plan.cols) * itemsize
    assert H % plan.rows == 0 and W % plan.cols == 0
    assert plan.threads() % 32 == 0 and plan.threads() <= 1024
    gx, gy = plan.grid(R, C)
    assert plan.tile_h >= 1 and plan.tile_w >= 1
    assert gx * plan.tile_w >= C > (gx - 1) * plan.tile_w
    assert gy * plan.tile_h >= R > (gy - 1) * plan.tile_h
    assert plan.steps_per_pass >= 1
    assert plan.passes(steps) * plan.steps_per_pass >= steps
    assert (plan.passes(steps) - 1) * plan.steps_per_pass < steps
    if name == "chebyshev_apply" and dtype == torch.float32:
        assert plan.passes(steps) == 1
