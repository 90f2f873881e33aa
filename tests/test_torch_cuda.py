"""The port's CUDA kernels and solves on the card (tests marked ``cuda``).

These tests skip where ``torch.cuda.is_available()`` is false.  The file
imports neither JAX nor the JAX package, so it also runs on a machine with a
card and no JAX, where ``tests/conftest.py`` (which imports JAX) is left
out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu_torch import df32
from newtonkrylov_tpu_torch.fftprec import fft_poisson
from newtonkrylov_tpu_torch.kernels import probe as kp
from newtonkrylov_tpu_torch.kernels import stencil2d as tk
from newtonkrylov_tpu_torch import precond as tp
from newtonkrylov_tpu_torch.mg import multigrid2d_general, probe_5point
from newtonkrylov_tpu_torch.precond import _cheb_bounds, chebyshev
from newtonkrylov_tpu_torch.problems import bratu1d as tb1
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.problems import bvp as tbvp
from newtonkrylov_tpu_torch.problems import convdiff2d as tc
from newtonkrylov_tpu_torch.problems import nldiff2d as tnl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(n, device, dtype, gen, absval=False):
    x = torch.randn((n, n), generator=gen, device=device, dtype=dtype)
    return tk.aligned_wrap(x.abs() + 0.1 if absval else x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [64, 512])
def test_kernels_match_plain(cuda_device, dtype, n):
    """K1 bitwise equal to its plain version on the interior, K2 within 4 ulp,
    ghosts exactly 0, and each launch counted once."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    v, w, u = (_rand(n, cuda_device, dtype, gen, absval=a) for a in (False, True, False))
    interior = tk.aligned_mask(n, torch.bool, cuda_device)
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[dtype]
    tk.reset_launch_counts()
    got = tk.stencil_jvp(v, w, n)
    ref = tk.stencil_jvp_xla(v, w, n)
    assert torch.equal(got.view(ints)[interior], ref.view(ints)[interior])
    assert bool((got[~interior] == 0).all())
    scale = 5.0 / (n + 1) ** 2
    got2 = tk.bratu_residual(u, n, scale)
    ref2 = tk.bratu_residual_xla(u, n, scale)
    bound = 4 * torch.finfo(dtype).eps * (ref2.abs() + scale * torch.exp(u))
    assert bool(((got2 - ref2).abs() <= bound)[interior].all())
    assert bool((got2[~interior] == 0).all())
    assert tk.LAUNCHES == {**dict.fromkeys(tk.LAUNCHES, 0),
                           "stencil_jvp": 1, "bratu_residual": 1}


def test_kernels_reject_bad_inputs(cuda_device):
    n = 64
    v = tk.aligned_wrap(torch.zeros((n, n), device=cuda_device))
    with pytest.raises(ValueError, match="shape"):
        tk.stencil_jvp(v[:-8], v[:-8], n)
    with pytest.raises(ValueError, match="dtype"):
        tk.bratu_residual(v.half(), n, 1.0)
    with pytest.raises(ValueError, match="one device|dtype"):
        tk.stencil_jvp(v, v.cpu(), n)


@pytest.mark.parametrize("op", ["stencil_jvp", "bratu_residual"])
def test_custom_op_registration_on_card(cuda_device, op):
    n = 64
    v = tk.aligned_wrap(torch.randn((n, n), device=cuda_device))
    args = (v, v.abs(), n) if op == "stencil_jvp" else (v, n, 1e-3)
    result = torch.library.opcheck(getattr(tk, op), args)
    assert set(result.values()) == {"SUCCESS"}


def test_df32_selfcheck_on_card(cuda_device):
    assert df32.selfcheck(cuda_device)


def test_aligned_solve_on_card_matches_cpu(cuda_device):
    """The aligned f64 solve through K1/K2 takes the CPU solve's iterations
    and reaches its solution; K1 runs at least once per inner iteration."""
    n = 64
    runs = {}
    for dev in ("cpu", cuda_device):
        u0, p, space = tb.aligned_setup(n, lam=5.0, dtype=torch.float64, device=dev)
        tk.reset_launch_counts()
        runs[str(dev)] = nkt.newton_krylov_jit(tb.residual_scaled_aligned, u0, p,
                                               algo="cg", space=space)
        runs[str(dev) + "-launches"] = dict(tk.LAUNCHES)
    (uc, ic), (ug, ig) = runs["cpu"], runs[str(cuda_device)]
    assert bool(ic.solved) and bool(ig.solved)
    assert ig.stats.outer_iterations == ic.stats.outer_iterations
    assert ig.stats.inner_iterations == ic.stats.inner_iterations
    assert float((ug.cpu() - uc).abs().max()) <= 1e-9
    launches = runs[str(cuda_device) + "-launches"]
    assert launches["stencil_jvp"] >= ig.stats.inner_iterations
    assert launches["bratu_residual"] > 0
    assert runs["cpu-launches"] == dict.fromkeys(tk.LAUNCHES, 0)


def test_flagship_solve_on_card(cuda_device):
    """entry()'s configuration at 256² on the card: solved, f64 true
    residual within 1e-8·‖F₀‖."""
    n = 256
    p = tb.default_config(n, lam=5.0)
    u0 = tb.initial_guess(n, dtype=torch.float32, device=cuda_device)
    u, info = nkt.newton_krylov_jit(
        tb.residual_scaled, u0.to(torch.float64), p, algo="cg", tol_rel=1e-8,
        krylov_dtype=torch.float32, residual_df=tb.residual_scaled_df,
        max_niter=20, M=fft_poisson(precision="high"), precond_refresh="once")
    assert bool(info.solved)
    f0 = float(torch.linalg.vector_norm(tb.residual_scaled(u0.to(torch.float64), p)))
    fu = float(torch.linalg.vector_norm(tb.residual_scaled(u, p)))
    assert fu <= 1e-8 * f0 + 1e-12


def _bitwise(a, b):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return torch.equal(a.view(ints), b.view(ints))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [64, 512, 520, 2048])
def test_chain_kernels_match_plain(cuda_device, dtype, n):
    """K3, K5 and K4 (on the probed interval of a Bratu Jacobian) bitwise
    equal to their plain versions at every tiling edge: several tiles with
    ragged last ones (R = n + 8 is no tile multiple), random nonzero ghosts
    and apron (the row-0 and column wraps), one pass and several (K4 degree
    40, K3/K5 k = 200), odd and even k, no steps; one count per call."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + 1)
    R, C = n + 8, tk.round_up(n + 2, 128)
    v, w, ghosts = (torch.randn((R, C), generator=gen, device=cuda_device,
                                dtype=dtype) for _ in range(3))
    w = w.abs() + 0.1
    J = nkt.JacobianOperator(tb.residual_scaled,
                             tb.initial_guess(n, dtype, cuda_device),
                             tb.default_config(n, 5.0))
    o, d = probe_5point(J)
    theta, delta = _cheb_bounds(o, d.min(), d.max(), None, 1 / 300, dtype)
    interior = tk.aligned_mask(n, torch.bool, cuda_device)
    diag = torch.where(interior, tk.aligned_wrap(d / o), ghosts)
    scal = torch.stack([theta, delta, o])
    tk.reset_launch_counts()
    for k in (0, 1, 2, 7, 40, 200):
        assert _bitwise(tk.stencil_jvp_chain(v, w, n, k, 0.125),
                        tk.stencil_jvp_chain_xla(v, w, n, k, 0.125)), k
    for k in (2, 200):
        assert _bitwise(tk.stencil_chain_probe(v, w, n, k),
                        tk.stencil_chain_probe_xla(v, w, n, k)), k
    for degree in (0, 1, 4, 16, 40):
        assert _bitwise(tk.chebyshev_apply(v, diag, scal, n, degree),
                        tk.chebyshev_apply_xla(v, diag, scal, n, degree)), degree
    assert tk.LAUNCHES == {**dict.fromkeys(tk.LAUNCHES, 0), "stencil_jvp_chain": 6,
                           "stencil_chain_probe": 2, "chebyshev_apply": 5}


def test_chain_kernels_raise_on_refused_plan(cuda_device):
    """A plan the kernels do not take (K3 is built for 8 rows per thread,
    not 5) raises with the cudaError_t of the refused launch; nothing is counted."""
    n = 64
    v = tk.aligned_wrap(torch.ones((n, n), device=cuda_device))
    plan = tk._tile_plan("stencil_jvp_chain", n, torch.float32, 4)._replace(rows=5)
    tk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="cudaError_t"):
        tk._launch("stencil_jvp_chain", n, (v, v), 4, 1.0, *plan, scratch=1)
    assert tk.LAUNCHES["stencil_jvp_chain"] == 0


def test_chain_kernels_reject_bad_inputs(cuda_device):
    n = 64
    v = tk.aligned_wrap(torch.zeros((n, n), device=cuda_device))
    scal = torch.ones(3, device=cuda_device)
    with pytest.raises(ValueError, match="even"):
        tk.stencil_chain_probe(v, v, n, 3)
    with pytest.raises(ValueError, match="shape"):
        tk.stencil_jvp_chain(v[:-8], v[:-8], n, 2)
    with pytest.raises(ValueError, match="scal"):
        tk.chebyshev_apply(v, v, scal.double(), n, 2)
    with pytest.raises(ValueError, match="scal"):
        tk.chebyshev_apply(v, v, scal[:2], n, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cheb_auto_engine_launches_k4_on_card(cuda_device, dtype):
    """``chebyshev(engine="auto")`` on a 64² CUDA state runs K4, one launch
    per apply, bitwise equal to the kernel's plain version; a state the
    aligned layout cannot take raises instead of running the recurrence."""
    n = 64
    J = nkt.JacobianOperator(tb.residual_scaled,
                             tb.initial_guess(n, dtype, cuda_device),
                             tb.default_config(n, 5.0))
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    r = torch.randn((n, n), generator=gen, device=cuda_device, dtype=dtype)
    M = chebyshev(16, lo_frac=1 / 300)(J)
    tk.reset_launch_counts()
    got = M(r)
    assert tk.LAUNCHES == {**dict.fromkeys(tk.LAUNCHES, 0), "chebyshev_apply": 1}
    o, d = probe_5point(J)
    theta, delta = _cheb_bounds(o, d.min(), d.max(), None, 1 / 300, dtype)
    ref = tk.chebyshev_apply_xla(tk.aligned_wrap(r), tk.aligned_wrap(d / o),
                                 torch.stack([theta, delta, o]), n, 16)
    assert _bitwise(got, tk.aligned_interior(ref, n))
    m = 60  # n % 8 ≠ 0
    Jm = nkt.JacobianOperator(tb.residual_scaled,
                              tb.initial_guess(m, dtype, cuda_device),
                              tb.default_config(m, 5.0))
    with pytest.raises(ValueError, match='engine="xla"'):
        chebyshev(16)(Jm)


def test_cheb_pcg_solve_on_card(cuda_device):
    """The Cheb-PCG lane's configuration at 256² on the card: every
    preconditioner apply is one K4 launch; solved, f64 true residual within
    1e-8·‖F₀‖."""
    n = 256
    p = tb.default_config(n, lam=5.0)
    u0 = tb.initial_guess(n, dtype=torch.float32, device=cuda_device)
    tk.reset_launch_counts()
    u, info = nkt.newton_krylov_jit(
        tb.residual_scaled, u0.to(torch.float64), p, algo="cg", tol_rel=1e-8,
        krylov_dtype=torch.float32, residual_df=tb.residual_scaled_df,
        max_niter=20, M=chebyshev(16, lo_frac=1 / 300), precond_refresh="once")
    assert bool(info.solved)
    assert tk.LAUNCHES["chebyshev_apply"] >= info.stats.inner_iterations
    f0 = float(torch.linalg.vector_norm(tb.residual_scaled(u0.to(torch.float64), p)))
    fu = float(torch.linalg.vector_norm(tb.residual_scaled(u, p)))
    assert fu <= 1e-8 * f0 + 1e-12


@pytest.mark.parametrize("step,kw", [
    (kp.muls(8), {}),
    (kp.roll_chain(1, 4), {}),
    (kp.OPT_BUILD, {"pingpong": True, "unroll": 2}),
], ids=["mul-x8-carry", "roll-lane-x4-carry", "stencil-hoisted-pingpong-u2"])
def test_chain_call_matches_plain(cuda_device, step, kw):
    """K6 on three probe variants (a register-carried multiply chain, a
    carried column-shift chain through the on-chip copy, the hoisted
    stencil in ping-pong), k = 1, 7, 8 on a 64² aligned f32 array: bitwise
    equal to its plain version, one launch counted per call."""
    n = 64
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    v, w = (_rand(n, cuda_device, torch.float32, gen, absval=a) for a in (False, True))
    kp.reset_launch_counts()
    for k in (1, 7, 8):
        assert _bitwise(kp.chain_call(step, v, w, k, **kw),
                        kp.chain_call_xla(step, v, w, k, **kw))
    assert kp.LAUNCHES == {"chain_call": 3}
    with pytest.raises(ValueError, match="float32"):
        kp.chain_call(step, v.double(), w.double(), 2)


def test_gmres_convdiff_solve_on_card_matches_cpu(cuda_device):
    """The convection–diffusion solve (c = 2, DST, full GMRES, exact Newton)
    at 64² in f64 on the card and on the CPU: same counts, solutions within
    1e-10, both at the manufactured root."""
    n = 64
    runs = {}
    for dev in ("cpu", cuda_device):
        p = tc.default_config(n, device=dev)
        runs[str(dev)] = nkt.newton_krylov_jit(
            tc.residual_scaled, tc.initial_guess(n, device=dev), p,
            algo="gmres", tol_rel=1e-10, M=fft_poisson(), forcing=None,
            krylov_kwargs={"restart": None, "itmax": 150})
    (uc, ic), (ug, ig) = runs["cpu"], runs[str(cuda_device)]
    assert bool(ic.solved) and bool(ig.solved)
    assert ig.stats.outer_iterations == ic.stats.outer_iterations
    assert ig.stats.inner_iterations == ic.stats.inner_iterations
    assert float((ug.cpu() - uc).abs().max()) <= 1e-10
    us = tc.manufactured_solution(n, device="cpu")
    assert float((uc - us).abs().max()) < 1e-9


def test_pcr_on_card_matches_thomas_on_cpu(cuda_device):
    """PCR on the card against Thomas on the CPU for a seeded batch of 37
    diagonally dominant f64 systems of size 300, along either axis: within
    1e-10."""
    gen = torch.Generator().manual_seed(8)
    dl, du, b = torch.randn((3, 300, 37), generator=gen, dtype=torch.float64)
    d = 2.5 + dl.abs() + du.abs()
    for axis in (0, 1):
        args = [x if axis == 0 else x.T.contiguous() for x in (dl, d, du, b)]
        got = tp.pcr_solve(*(x.to(cuda_device) for x in args), axis=axis)
        ref = tp.thomas_solve(*args, axis=axis)
        assert got.device.type == "cuda"
        assert float((got.cpu() - ref).abs().max()) <= 1e-10


def _count_line_solves(monkeypatch):
    calls = []
    for name in ("thomas_solve", "pcr_solve"):
        real = getattr(tp, name)
        monkeypatch.setattr(tp, name, lambda *a, _n=name, _f=real, **kw:
                            calls.append(_n) or _f(*a, **kw))
    return calls


def test_adi_auto_engine_runs_pcr_on_card(cuda_device, monkeypatch):
    """``adi()`` and ``multigrid2d_general()`` under ``engine="auto"`` on a
    CUDA state solve every line by PCR, and agree with the same factories
    on the CPU with ``engine="pcr"`` within 1e-10 in f64."""
    calls = _count_line_solves(monkeypatch)
    n = 64
    out = {}
    for dev, engine in ((cuda_device, "auto"), ("cpu", "pcr")):
        p = tc.default_config(n, c=25.0, device=dev)
        J = nkt.JacobianOperator(tc.residual_scaled,
                                 0.7 * tc.manufactured_solution(n, device=dev), p)
        r = torch.linspace(-1.0, 1.0, n * n, dtype=torch.float64).reshape(n, n)
        calls.clear()
        out[str(dev)] = [M(J)(r.to(dev)) for M in (tp.adi(4, engine=engine),
                                                   multigrid2d_general(engine=engine))]
        assert set(calls) == {"pcr_solve"}
    for got, ref in zip(out[str(cuda_device)], out["cpu"]):
        assert got.device.type == "cuda"
        assert float((got.cpu() - ref).abs().max()) <= 1e-10 * float(ref.abs().max())


def test_two_grid_pallas_launches_k4(cuda_device):
    """``two_grid(engine="pallas")`` on a CUDA state: two K4 launches per
    apply, and the apply agrees with the plain recurrence (``"xla"``)
    within 1e-5 of its scale in f32."""
    n = 256
    J = nkt.JacobianOperator(tb.residual_scaled,
                             tb.initial_guess(n, torch.float32, cuda_device),
                             tb.default_config(n, 5.0))
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    r = torch.randn((n, n), generator=gen, device=cuda_device, dtype=torch.float32)
    M = tp.two_grid(8, precision="high", engine="pallas")(J)
    tk.reset_launch_counts()
    got = M(r)
    assert tk.LAUNCHES == {**dict.fromkeys(tk.LAUNCHES, 0), "chebyshev_apply": 2}
    ref = tp.two_grid(8, precision="high", engine="xla")(J)(r)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_cheb_lanczos_pcg_solve_on_card(cuda_device):
    """Path (a) at 256²: the flagship with ``chebyshev(16,
    bounds="lanczos")`` built once; K4 runs once per preconditioner apply
    (inners + outers), solved, f64 true residual within 1e-8·‖F₀‖."""
    n = 256
    p = tb.default_config(n, lam=5.0)
    u0 = tb.initial_guess(n, dtype=torch.float32, device=cuda_device).to(torch.float64)
    tk.reset_launch_counts()
    u, info = nkt.newton_krylov_jit(
        tb.residual_scaled, u0, p, algo="cg", tol_rel=1e-8,
        krylov_dtype=torch.float32, residual_df=tb.residual_scaled_df,
        max_niter=20, M=chebyshev(16, bounds="lanczos"), precond_refresh="once")
    assert bool(info.solved)
    assert tk.LAUNCHES["chebyshev_apply"] == (info.stats.inner_iterations
                                              + info.stats.outer_iterations)
    f0 = float(torch.linalg.vector_norm(tb.residual_scaled(u0, p)))
    fu = float(torch.linalg.vector_norm(tb.residual_scaled(u, p)))
    assert fu <= 1e-8 * f0 + 1e-12


def test_lanczos_bounds_on_card_match_cpu(cuda_device):
    """The Lanczos interval of the f64 Bratu Jacobian at 64² on the card
    equals the CPU's within 1e-10 and lies below zero."""
    out = {}
    for dev in ("cpu", cuda_device):
        J = nkt.JacobianOperator(tb.residual_scaled,
                                 tb.initial_guess(64, torch.float64, dev),
                                 tb.default_config(64, 5.0))
        out[str(dev)] = torch.stack(tp._resolve_cheb_bounds(J, "lanczos", 48)).cpu()
    got, ref = out[str(cuda_device)], out["cpu"]
    assert float(got[0]) < float(got[1]) < 0
    assert float((got - ref).abs().max()) <= 1e-10 * float(ref.abs().max())


def test_pipelined_cg_solve_on_card_matches_cpu(cuda_device):
    """Path (b) in f64 at 64²: the flagship configuration's DST-preconditioned
    CG with ``pipeline=True`` on the card takes the CPU's counts and
    reaches its solution within 1e-9."""
    n = 64
    runs = {}
    for dev in ("cpu", cuda_device):
        runs[str(dev)] = nkt.newton_krylov_jit(
            tb.residual_scaled, tb.initial_guess(n, torch.float64, dev),
            tb.default_config(n, 5.0), algo="cg", tol_rel=1e-8,
            M=fft_poisson(precision="high"), precond_refresh="once",
            krylov_kwargs={"pipeline": True})
    (uc, ic), (ug, ig) = runs["cpu"], runs[str(cuda_device)]
    assert bool(ic.solved) and bool(ig.solved)
    assert ig.stats.outer_iterations == ic.stats.outer_iterations
    assert ig.stats.inner_iterations == ic.stats.inner_iterations
    assert float((ug.cpu() - uc).abs().max()) <= 1e-9


def test_banded_direct_on_card_runs_pcr(cuda_device, monkeypatch):
    """``banded_direct`` on a CUDA state solves by PCR with two rounds of
    refinement (three PCR solves an apply) and agrees with Thomas on the
    CPU within 1e-10 on the 1-D Bratu Jacobian at N = 512."""
    calls = _count_line_solves(monkeypatch)
    n = 512
    out = {}
    for dev in ("cpu", cuda_device):
        J = nkt.JacobianOperator(tb1.residual, tb1.initial_guess(n, device=dev),
                                 tb1.default_config(n))
        r = torch.cos(torch.arange(n, dtype=torch.float64, device=dev))
        calls.clear()
        out[str(dev)] = tp.banded_direct()(J)(r).cpu()
        assert calls == (["pcr_solve"] * 3 if dev == cuda_device else ["thomas_solve"])
    ref = out["cpu"]
    assert float((out[str(cuda_device)] - ref).abs().max()) <= 1e-10 * float(ref.abs().max())


@pytest.mark.parametrize("recipe", ["cg", "gmres + banded direct", "bicgstab"])
def test_gallery_on_card_matches_cpu(cuda_device, recipe):
    """Path (c) at N = 512 in f64: a positive recipe solves on the card to
    the CPU's root (within 1e-9, same outer count); the negative BiCGStab
    recipe (``max_niter=4``, ``itmax=60``) ends unsolved with a finite
    iterate on both."""
    n = 512
    kw = {"cg": dict(algo="cg"),
          "gmres + banded direct": dict(algo="gmres", N=tp.banded_direct()),
          "bicgstab": dict(algo="bicgstab", max_niter=4,
                           krylov_kwargs={"itmax": 60})}[recipe]
    runs = {str(dev): nkt.newton_krylov_jit(
        tb1.residual, tb1.initial_guess(n, device=dev), tb1.default_config(n), **kw)
        for dev in ("cpu", cuda_device)}
    (uc, ic), (ug, ig) = runs["cpu"], runs[str(cuda_device)]
    assert bool(ig.solved) == bool(ic.solved) == (recipe != "bicgstab")
    assert ig.stats.outer_iterations == ic.stats.outer_iterations
    assert bool(torch.isfinite(ug).all())
    if recipe != "bicgstab":
        assert float((ug.cpu() - uc).abs().max()) <= 1e-9


def test_spectral_on_card_matches_numpy(cuda_device):
    """κ₂ (through ``rmv`` on the card) and the extreme eigenvalues of the
    f64 Bratu Jacobian at 12², k = n², against numpy on the dense
    materialization: relative 1e-8."""
    import numpy as np

    from newtonkrylov_tpu_torch import spectral
    from newtonkrylov_tpu_torch.operator import materialize_dense

    n = 12
    J = nkt.JacobianOperator(tb.residual_scaled,
                             tb.initial_guess(n, torch.float64, cuda_device),
                             tb.default_config(n, 5.0))
    dense = materialize_dense(J).cpu().numpy()
    kappa = float(spectral.cond2_estimate(J, k=n * n))
    assert abs(kappa - np.linalg.cond(dense)) <= 1e-8 * np.linalg.cond(dense)
    lo, hi = spectral.extreme_eigs(J, k=n * n)
    ev = np.linalg.eigvalsh(dense)
    assert abs(float(lo) - ev[0]) <= 1e-8 * abs(ev[0])
    assert abs(float(hi) - ev[-1]) <= 1e-8 * abs(ev[-1])


def test_refined_pcr_on_card_reaches_thomas_accuracy(cuda_device):
    """The solve ``banded_direct`` takes on the card, on the non-dominant
    1-D Bratu Jacobian at u₀, N = 10⁴, f64, seeded right-hand side:
    relative residual ≤ 1e-9."""
    n = 10_000
    J = nkt.JacobianOperator(tb1.residual, tb1.initial_guess(n, device=cuda_device),
                             tb1.default_config(n))
    _, (dl, d, du) = nkt.materialize_banded(J, 1, 1)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b = torch.randn(n, generator=gen, device=cuda_device, dtype=torch.float64)
    x = tp.pcr_refined_solve(dl, d, du, b)
    rel = torch.linalg.vector_norm(tp._tridiag_mv(dl, d, du, x) - b) / torch.linalg.vector_norm(b)
    assert float(rel) <= 1e-9


@pytest.mark.parametrize("driver", ["newton_krylov", "newton_krylov_jit"])
def test_ilu0_gallery_on_card_matches_cpu(cuda_device, driver):
    """GMRES + ``ilu0(bandwidth=1)`` at N = 512 (1-D Bratu, f64) on the
    card and on the CPU: the same counts, roots within 1e-9; on the card
    each preconditioner apply copies to the host and back once."""
    run = getattr(nkt, driver)
    out = {}
    for dev in ("cpu", cuda_device):
        tp.reset_host_copies()
        out[str(dev)] = run(tb1.residual, tb1.initial_guess(512, device=dev),
                            tb1.default_config(512), algo="gmres",
                            N=tp.ilu0(bandwidth=1))
        copies = dict(tp.HOST_COPIES)
    (uc, ic), (ug, ig) = out["cpu"], out[str(cuda_device)]
    assert bool(ig.solved) and bool(ic.solved)
    assert ig.stats.outer_iterations == ic.stats.outer_iterations
    assert ig.stats.inner_iterations == ic.stats.inner_iterations
    assert float((ug.cpu() - uc).abs().max()) <= 1e-9
    assert copies["device_to_host"] == copies["host_to_device"]
    assert copies["device_to_host"] >= ig.stats.inner_iterations > 0


def test_host_and_jit_drivers_agree_on_card(cuda_device):
    """The two drivers on the card (1-D Bratu N = 512, CG, f64): the same
    iterate bit for bit and the same counts."""
    args = (tb1.residual, tb1.initial_guess(512, device=cuda_device),
            tb1.default_config(512))
    uh, ih = nkt.newton_krylov(*args, algo="cg")
    uj, ij = nkt.newton_krylov_jit(*args, algo="cg")
    assert ih.solved and bool(ij.solved)
    assert torch.equal(uh, uj)
    assert (ih.stats.outer_iterations, ih.stats.inner_iterations) == (
        ij.stats.outer_iterations, ij.stats.inner_iterations)


def test_bvp_banded_lu_on_card_matches_cpu(cuda_device):
    """Kelley's BVP at n = 201 through ``newton_krylov`` with GMRES +
    ``banded_lu(2, 2)`` on the card and on the CPU: the same counts, the
    solutions within 1e-9."""
    out = {}
    for dev in ("cpu", cuda_device):
        p = tbvp.default_config(201, device=dev)
        out[str(dev)] = nkt.newton_krylov(tbvp.residual, tbvp.initial_guess(p), p,
                                          algo="gmres", N=tp.banded_lu(2, 2))
    (uc, ic), (ug, ig) = out["cpu"], out[str(cuda_device)]
    assert ig.solved and ic.solved
    assert (ig.stats.outer_iterations, ig.stats.inner_iterations) == (
        ic.stats.outer_iterations, ic.stats.inner_iterations)
    assert float((ug.cpu() - uc).abs().max()) <= 1e-9


def test_ptc_chebyshev_launches_k4_once_per_apply(cuda_device):
    """Ψtc near the fold (λ = 6.8, rough start, −F) at 64² with f32 Krylov,
    the df32 residual and ``chebyshev(16)`` on the shifted operator: solved,
    and K4 launched exactly once per preconditioner apply."""
    import math

    n = 64
    p = tb.default_config(n, lam=6.8)
    X, Y = tb.grid(n, torch.float64, cuda_device)
    u0 = 2.5 * torch.sin(math.pi * X) * torch.sin(math.pi * Y)
    applies = [0]
    cheb = chebyshev(16)

    def counting(A):
        M = cheb(A)

        def apply(r):
            applies[0] += 1
            return M(r)

        return apply

    def neg(u, q):
        return -tb.residual_scaled(u, q)

    def neg_df(u, q):
        r = tb.residual_scaled_df(u, q)
        return df32.DF(-r.hi, -r.lo)

    tk.reset_launch_counts()
    u, info = nkt.pseudo_transient(neg, u0, p, algo="gmres", tol_rel=1e-8,
                                   M=counting, delta0=float((n + 1) ** 2),
                                   max_steps=60, krylov_dtype=torch.float32,
                                   residual_df=neg_df)
    assert bool(info.solved)
    assert tk.LAUNCHES["chebyshev_apply"] == applies[0] > 0
    f = torch.linalg.vector_norm(tb.residual_scaled(u, p))
    f0 = torch.linalg.vector_norm(tb.residual_scaled(u0, p))
    assert float(f) <= 1e-8 * float(f0) + 1e-12


def test_nldiff2d_on_card_matches_cpu(cuda_device):
    """Quasilinear diffusion at 64², f64, GMRES + MG-general with PCR line
    solves on both devices: the same counts, solutions within 1e-9."""
    out = {}
    for dev in ("cpu", cuda_device):
        p = tnl.default_config(64, device=dev)
        out[str(dev)] = nkt.newton_krylov_jit(
            tnl.residual_scaled, tnl.initial_guess(64, device=dev), p,
            algo="gmres", M=multigrid2d_general(engine="pcr"), forcing=None,
            tol_rel=1e-10, max_niter=15,
            krylov_kwargs={"restart": None, "itmax": 300})
    (uc, ic), (ug, ig) = out["cpu"], out[str(cuda_device)]
    assert bool(ig.solved) and bool(ic.solved)
    assert (ig.stats.outer_iterations, ig.stats.inner_iterations) == (
        ic.stats.outer_iterations, ic.stats.inner_iterations)
    assert float((ug.cpu() - uc).abs().max()) <= 1e-9


# -- time stepping and the differentiable solve (chip_smoke.py paths (l)-(p)) --


def _heat_march(cuda_device, n, M, driver="integrate", steps=5, **kw):
    """The heat march of chip_smoke.py (a = 0.01, Δt = 0.05, u₀ =
    sin(πx)sin(πy), f32 Krylov CG + df32 acceptance) at n² for ``steps``
    steps; returns (result, params, u₀, g)."""
    import math

    from newtonkrylov_tpu_torch.problems import heat2d
    from newtonkrylov_tpu_torch.timestep import implicit_euler_df

    p = heat2d.default_config(n, a=0.01)
    u0 = heat2d.initial_condition(n, torch.float64, cuda_device)
    g = 1.0 / (1.0 + 0.05 * p.a * (8.0 / p.dx ** 2) * math.sin(math.pi * p.dx / 2) ** 2)
    nkw = dict(algo="cg", M=M, precond_refresh="once", krylov_dtype=torch.float32,
               residual_df=implicit_euler_df(heat2d.rhs_df), tol_rel=1e-8, tol_abs=0.0)
    if driver == "integrate":
        r = nkt.integrate("euler", heat2d.rhs, u0, p, 0.05, 0.05 * steps,
                          newton_kwargs=nkw, **kw)
    else:
        r = nkt.integrate_scan("euler", heat2d.rhs, u0, p, 0.05, steps,
                               newton_kwargs=nkw, **kw)
    return r, p, u0, g


def test_heat_march_cheb_pcg_launches_k4_on_card(cuda_device):
    """Path (l) at 128², 5 steps: ``chebyshev(16)`` on the Gershgorin box
    [−1 − 8o, −1] runs K4 once per apply; no failed step, every step's f64
    residual within 1.2e-8 of ‖G(uₙ)‖, the state g⁵·u₀ within 1e-6·max|u₀|."""
    from newtonkrylov_tpu_torch.problems import heat2d
    from newtonkrylov_tpu_torch.timestep import StepParams, implicit_euler

    n = 128
    o = 0.05 * 0.01 * (n + 1) ** 2
    applies = [0]
    cheb = chebyshev(16, bounds=(-1.0 - 8.0 * o, -1.0))

    def counting(A):
        M = cheb(A)

        def apply(r):
            applies[0] += 1
            return M(r)

        return apply

    tk.reset_launch_counts()
    r, p, u0, g = _heat_march(cuda_device, n, counting, save_history=True)
    assert r.n_failed == 0
    assert tk.LAUNCHES["chebyshev_apply"] == applies[0] > 0
    assert float((r.u - g ** 5 * u0).abs().max()) <= 1e-6 * float(u0.abs().max())
    G = implicit_euler(heat2d.rhs)
    for k in range(5):
        sp = StepParams(un=r.history[k], dt=0.05, p=p, t=0.05 * (k + 1))
        assert float(torch.linalg.vector_norm(G(r.history[k + 1], sp))) <= 1.2e-8 * float(
            torch.linalg.vector_norm(G(r.history[k], sp)))


def test_heat_scan_dst_matches_integrate_on_card(cuda_device):
    """Paths (m) and (n) at 128², DST-PCG: ``integrate_scan`` (history every
    5th step, float64 times) ends on ``integrate``'s state bit for bit, about
    one inner an outer, and on g⁵·u₀ within 1e-6·max|u₀|."""
    r1, _, u0, g = _heat_march(cuda_device, 128, fft_poisson())
    r2, *_ = _heat_march(cuda_device, 128, fft_poisson(), driver="scan", save_every=5)
    assert int(r2.n_failed) == 0 and r1.n_failed == 0
    assert _bitwise(r1.u, r2.u)
    assert r2.history.shape == (1, 128, 128) and _bitwise(r2.history[0], r2.u)
    assert float(r2.ts[0]) == 0.25 and r2.ts.dtype == torch.float64
    assert torch.equal(r1.outer_iterations, r2.outer_iterations)
    assert int(r2.inner_iterations.sum()) <= int(r2.outer_iterations.sum()) + 5
    assert float((r2.u - g ** 5 * u0).abs().max()) <= 1e-6 * float(u0.abs().max())


def test_heat_resume_on_card_bitwise(cuda_device, tmp_path):
    """Path (n) at 128²: a march checkpointed every 2 steps, resumed from
    its ``march_2`` snapshot, reproduces the uninterrupted 4-step march bit
    for bit in the remaining 2 steps."""
    full, *_ = _heat_march(cuda_device, 128, fft_poisson(), steps=4)
    _heat_march(cuda_device, 128, fft_poisson(), steps=2,
                checkpoint_dir=str(tmp_path), checkpoint_every=2)
    resumed, *_ = _heat_march(cuda_device, 128, fft_poisson(), steps=4,
                              checkpoint_dir=str(tmp_path), resume=True)
    assert len(resumed.outer_iterations) == 2
    assert _bitwise(resumed.u, full.u)


@pytest.mark.parametrize("case", ["euler", "midpoint", "trapezoid", "dg_step"])
def test_small_problems_on_card_match_cpu(cuda_device, case):
    """Path (o): the spring (Δt = 0.01, 5 steps) with each stepper, and one
    heat1d_dg step refined to 1e-8 (full GMRES, df32), on the card against
    the CPU: the same per-step counts, states within 1e-12."""
    from newtonkrylov_tpu_torch.problems import heat1d_dg, spring
    from newtonkrylov_tpu_torch.timestep import (StepParams, implicit_euler,
                                                 implicit_euler_df)

    out = {}
    for dev in ("cpu", cuda_device):
        if case == "dg_step":
            p = heat1d_dg.dg_config(device=dev)
            u0 = heat1d_dg.initial_condition(p)
            u, info = nkt.newton_krylov_jit(
                implicit_euler(heat1d_dg.rhs), u0, StepParams(u0, 1e-4, p, 1e-4),
                algo="gmres", tol_rel=1e-8, max_niter=10,
                residual_df=implicit_euler_df(heat1d_dg.rhs_df),
                krylov_kwargs={"restart": None, "itmax": 200})
            assert bool(info.solved)
            out[str(dev)] = (u, (info.stats.outer_iterations, info.stats.inner_iterations))
        else:
            r = nkt.integrate(case, spring.rhs, spring.initial_condition(device=dev),
                              spring.default_config(), 0.01, 0.05)
            assert r.n_failed == 0
            out[str(dev)] = (r.u, (r.outer_iterations.tolist(), r.inner_iterations.tolist()))
    (uc, cc), (ug, cg) = out["cpu"], out[str(cuda_device)]
    assert cg == cc
    assert float((ug.cpu() - uc).abs().max()) <= 1e-12


def test_implicit_grad_on_card(cuda_device):
    """Path (p) at 128²: d(Σu*)/dλ of the 2-D Bratu root (f64, λ = 5 a 0-d
    tensor; forward CG + DST, adjoint CG with the DST built at u₀) against
    central differences (ε = 1e-6·λ), rtol 1e-5."""
    n = 128
    dx = 1.0 / (n + 1)

    def F(u, lam):
        return tb.residual_scaled(u, tb.Params(dx=dx, lam=lam))

    u0 = tb.initial_guess(n, torch.float64, cuda_device)
    lam0 = torch.tensor(5.0, dtype=torch.float64, device=cuda_device)
    M0 = fft_poisson()(nkt.JacobianOperator(F, u0, lam0))
    solve = nkt.make_implicit_solver(F, algo="cg", M=fft_poisson(), tol_rel=1e-12,
                                     adjoint_algo="cg", adjoint_kwargs={"M": M0})
    lam = lam0.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(solve(u0, lam).sum(), lam)
    eps = 5e-6
    with torch.no_grad():
        fd = float(solve(u0, lam0 + eps).sum() - solve(u0, lam0 - eps).sum()) / (2 * eps)
    assert abs(float(grad) - fd) <= 1e-5 * abs(fd)


def test_sharded_flagship_world1_nccl(cuda_device, tmp_path):
    """The sharded solver on a world-1 NCCL group (one card): the flagship
    configuration at 64² (f32 CG, df32 acceptance with the words exchanged
    apart, the global DST built once) through ``newton_krylov_sharded``
    takes the unsharded flagship's counts and reaches its state within
    1e-12; every reduction is an NCCL all-reduce and every DST product a
    reduce-scatter, and no point-to-point message is sent (axes of size 1).
    """
    from newtonkrylov_tpu_torch import halo
    from newtonkrylov_tpu_torch.utils import distributed as D
    from newtonkrylov_tpu_torch.utils.dryrun import bratu_padded

    n = 64
    p = tb.default_config(n, lam=5.0)
    u0 = tb.initial_guess(n, dtype=torch.float32, device=cuda_device).double()
    kw = dict(algo="cg", tol_rel=1e-8, krylov_dtype=torch.float32, max_niter=20,
              precond_refresh="once")
    u_ref, info_ref = nkt.newton_krylov_jit(
        tb.residual_scaled, u0, p, residual_df=tb.residual_scaled_df,
        M=fft_poisson(precision="high"), **kw)
    assert D.initialize("file://" + str(tmp_path / "store"), 1, 0, device="cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        mesh = halo.make_mesh((1, 1), ("i", "j"), device_type="cuda")
        D.reset_collective_counts()
        u, info = halo.newton_krylov_sharded(
            halo.sharded_residual_2d(bratu_padded, ("i", "j")), u0, p, mesh,
            halo.P("i", "j"),
            newton_kwargs=dict(
                kw, M=fft_poisson(axis_names=("i", "j"), scope="global",
                                  precision="high"),
                residual_df=halo.sharded_residual_df_2d(
                    tb.residual_scaled_df_padded, ("i", "j"))))
        counts = dict(D.COLLECTIVES)
    finally:
        D.shutdown()
    assert bool(info.solved) and bool(info_ref.solved)
    assert (info.stats.outer_iterations, info.stats.inner_iterations) == (
        info_ref.stats.outer_iterations, info_ref.stats.inner_iterations)
    assert float((u - u_ref).abs().max()) <= 1e-12
    # one DST apply to start each outer's CG and one an inner iteration
    applies = info.stats.inner_iterations + info.stats.outer_iterations
    assert counts["reduce_scatter"] == 4 * applies
    assert counts["all_reduce"] > 0 and counts["p2p"] == 0


@pytest.mark.parametrize("step", kp.STEPS)
def test_chain_call_pass_boundaries(cuda_device, step):
    """K6 runs in passes of at most 16 steps (csrc/chain_probe.cu on
    csrc/tiled.cuh): carried and ping-pong at k = 15, 16, 17, 33 and 34,
    ping-pong unrolled 2 at k = 36 and 4 at k = 40, on the 64² layout (a
    72 × 128 array, which a tile's halo wraps more than once), each bitwise
    equal to the plain version."""
    n = 64
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    v, w = (_rand(n, cuda_device, torch.float32, gen, absval=a) for a in (False, True))
    runs = [(k, {"pingpong": pp}) for pp in (False, True)
            for k in (15, 16, 17, 33, 34)]
    runs += [(36, {"pingpong": True, "unroll": 2}),
             (40, {"pingpong": True, "unroll": 4})]
    for k, kw in runs:
        assert _bitwise(kp.chain_call(step, v, w, k, **kw),
                        kp.chain_call_xla(step, v, w, k, **kw)), (k, kw)


def test_exported_gmres_flagship_on_card(cuda_device, tmp_path):
    """The flagship at 64² with the driver's default ``algo="gmres"``
    exported whole, saved, loaded and called on the card: solved, the live
    solve's counts, and its state bit for bit."""
    from newtonkrylov_tpu_torch.utils import serving

    n = 64
    p = tb.default_config(n, lam=5.0)
    u0 = tb.initial_guess(n, dtype=torch.float32, device=cuda_device).double()

    def fn(u):
        u, info = nkt.newton_krylov_jit(
            tb.residual_scaled, u, p, tol_rel=1e-8,
            krylov_dtype=torch.float32, residual_df=tb.residual_scaled_df,
            max_niter=20, M=fft_poisson(precision="high"),
            precond_refresh="once")
        return u, info.stats.outer_iterations, info.stats.inner_iterations, info.solved

    live = fn(u0)
    path = serving.save_exported(serving.export_solver(fn, (u0,)),
                                 str(tmp_path / "gmres.pt2"))
    u, outer, inner, solved = serving.load_exported(path).call(u0)
    assert bool(solved) and bool(live[3])
    assert (int(outer), int(inner)) == (live[1], live[2])
    assert torch.equal(u, live[0])


def test_exported_flagship_on_card(cuda_device, tmp_path):
    """The production flagship at 256² exported whole, saved, loaded and
    called on the card: solved, the live solve's counts, and its state bit
    for bit (the loaded program runs the live solve's ops)."""
    from newtonkrylov_tpu_torch.utils import serving

    n = 256
    p = tb.default_config(n, lam=5.0)
    u0 = tb.initial_guess(n, dtype=torch.float32, device=cuda_device).double()

    def fn(u):
        u, info = nkt.newton_krylov_jit(
            tb.residual_scaled, u, p, algo="cg", tol_rel=1e-8,
            krylov_dtype=torch.float32, residual_df=tb.residual_scaled_df,
            max_niter=20, M=fft_poisson(precision="high"),
            precond_refresh="once")
        return u, info.stats.outer_iterations, info.stats.inner_iterations, info.solved

    live = fn(u0)
    path = serving.save_exported(serving.export_solver(fn, (u0,)),
                                 str(tmp_path / "flagship.pt2"))
    u, outer, inner, solved = serving.load_exported(path).call(u0)
    assert bool(solved) and bool(live[3])
    assert (int(outer), int(inner)) == (live[1], live[2])
    assert torch.equal(u, live[0])


def test_exported_aligned_launches_kernels(cuda_device, tmp_path):
    """The aligned solve at 128² exported and loaded: the loaded program
    launches K1 once a CG matvec and K2 once a residual, the live solve's
    launches less those of its linearizations' tracing (three residuals and
    one J·v each), with the live counts and state bit for bit."""
    from newtonkrylov_tpu_torch.utils import serving

    n = 128
    u0, p, space = tb.aligned_setup(n, lam=5.0, dtype=torch.float64,
                                    device=cuda_device)

    def fn(u):
        u, info = nkt.newton_krylov_jit(
            tb.residual_scaled_aligned, u, p, algo="cg", space=space,
            krylov_dtype=torch.float32, tol_rel=1e-8, max_niter=20)
        return u, info.stats.outer_iterations, info.stats.inner_iterations

    tk.reset_launch_counts()
    live = fn(u0)
    want = dict(tk.LAUNCHES)
    loaded = serving.load_exported(serving.save_exported(
        serving.export_solver(fn, (u0,)), str(tmp_path / "aligned.pt2")))
    tk.reset_launch_counts()
    u, outer, inner = loaded.call(u0)
    outer_l, inner_l = live[1], live[2]
    assert tk.LAUNCHES["stencil_jvp"] == inner_l + outer_l == (
        want["stencil_jvp"] - outer_l)
    assert tk.LAUNCHES["bratu_residual"] == outer_l + 1 == (
        want["bratu_residual"] - 3 * outer_l)
    assert (int(outer), int(inner)) == (live[1], live[2])
    assert torch.equal(u, live[0])


def test_time_chain_on_k1(cuda_device):
    """``time_chain`` on K1 at 256² f32 returns a positive rate, and every
    chained step launched K1 once."""
    from newtonkrylov_tpu_torch.utils.profiling import time_chain

    n = 256
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    v = _rand(n, cuda_device, torch.float32, gen)
    w = _rand(n, cuda_device, torch.float32, gen, absval=True) * 0.01
    tk.reset_launch_counts()
    rate = time_chain(lambda x, ww: tk.stencil_jvp(x, ww, n), v, w, chain=20,
                      repeats=2)
    assert rate > 0
    assert tk.LAUNCHES["stencil_jvp"] == (1 + 2) * (2 + 20)


@pytest.mark.parametrize("overlap", [False, True])
def test_exchange_transpose_world1_nccl(cuda_device, tmp_path, overlap):
    """The ghost exchange's transpose on a world-1 NCCL group at 256² f64:
    Jᵀw of the exchanged residual against the unsharded Jᵀw (bit for bit in
    the plain exchange form; the overlapped form sums the edge strips in
    another order: 1e-12 relative), and the dot test."""
    from newtonkrylov_tpu_torch import halo
    from newtonkrylov_tpu_torch.operator import JacobianOperator
    from newtonkrylov_tpu_torch.utils import distributed as D
    from newtonkrylov_tpu_torch.utils.dryrun import bratu_padded

    n = 256
    p = tb.default_config(n, lam=5.0)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    u = tb.initial_guess(n, device=cuda_device)
    v, w = (torch.randn((n, n), generator=gen, device=cuda_device,
                        dtype=torch.float64) for _ in range(2))
    J1 = JacobianOperator(tb.residual_scaled, u, p)
    assert D.initialize("file://" + str(tmp_path / "store"), 1, 0, device="cuda")
    try:
        mesh = halo.make_mesh((1, 1), ("i", "j"), device_type="cuda")
        F = halo.sharded_residual_2d(bratu_padded, ("i", "j"), overlap=overlap)
        with D.use_mesh(mesh):
            J = JacobianOperator(F, halo.shard_array(u, mesh, halo.P("i", "j")), p)
            jtw, jv = J.rmv(w), J.mv(v)
    finally:
        D.shutdown()
    ref = J1.rmv(w)
    if overlap:
        assert float((jtw - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    else:
        assert torch.equal(jtw, ref)
    gap = abs(float((jv * w).sum() - (v * jtw).sum()))
    assert gap <= 1e-12 * float(jv.norm() * w.norm())


def test_bratu_2d_cuda_example_on_card(cuda_device):
    """The port's flagship example at 256² on the card: both lanes solved
    (the refined CG lane at ‖F‖ ≤ 1e-8·‖F₀‖ with K1 launched at least once
    a CG iteration and K2 once a residual), the two lanes at the same
    root."""
    from newtonkrylov_tpu_torch.examples import bratu_2d_cuda

    got = bratu_2d_cuda.main(device="cuda", n=256)
    cg, dst = got["refined_cg"], got["df32_dst"]
    assert got["n"] == 256 and cg["solved"] and dst["solved"]
    assert cg["n_res"] <= 1e-8 * cg["history"][0] + 1e-12
    assert cg["launches"]["stencil_jvp"] >= cg["inner"]
    assert cg["launches"]["bratu_residual"] >= cg["outer"] + 1
    assert got["max_diff"] <= 1e-6
