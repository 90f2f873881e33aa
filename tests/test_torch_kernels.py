"""The port's stencil kernels (K1 stencil_jvp, K2 bratu_residual) against the
JAX package's Pallas kernels, which run here in interpret mode as in
tests/test_kernels.py.

On the CPU each custom op runs its plain PyTorch version, so these tests hold
the plain versions (and the op dispatch around them) against the Pallas
kernels, in float64 with atol 1e-12 as the JAX kernel tests use.  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newtonkrylov_tpu.kernels import stencil2d as jk
from newtonkrylov_tpu.problems import bratu2d as jb
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
    assert tk.LAUNCHES == dict.fromkeys(
        ["stencil_jvp", "bratu_residual", "stencil_jvp_chain",
         "stencil_chain_probe", "chebyshev_apply"], 0)


@pytest.mark.parametrize("op", ["stencil_jvp", "bratu_residual"])
def test_custom_op_registration(op):
    """Schema, fake (meta) implementation and tracing of each custom op pass
    torch.library.opcheck — what torch.func.linearize relies on."""
    n = 16
    _, vt = _wrap_both(_rand(n, 9))
    args = (vt, vt.abs(), n) if op == "stencil_jvp" else (vt, n, 1e-3)
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
