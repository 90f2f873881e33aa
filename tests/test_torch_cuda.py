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
from newtonkrylov_tpu_torch.problems import bratu2d as tb
from newtonkrylov_tpu_torch.problems import convdiff2d as tc

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
    carried column-shift chain through memory, the hoisted stencil in
    ping-pong), k = 1, 7, 8 on a 64² aligned f32 array: bitwise equal to
    its plain version, one launch per call."""
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
