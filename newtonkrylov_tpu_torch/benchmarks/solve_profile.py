"""Where one outer of the flagship solve spends its time, phase by phase.

Counterpart of ``benchmarks/solve_profile.py``, on the port's flagship
(2-D Bratu at λ = 5, CG with an f32 Krylov loop, the df32 acceptance
residual, ``fft_poisson(precision="high")`` built once).  Each phase of
``newton._newton_step`` runs alone, ``reps`` times after a warm call, and
is timed three ways: the host clock up to a synchronization (the port's
cost is host time: every op is issued from Python), CUDA events around the
same calls (the device timeline, idle gaps included) and the device-busy
time of the same calls under ``torch.profiler`` (kernels only).  Phases:

* ``cast_down`` — the linearization point and the right-hand side in the
  Krylov dtype (the df32 hi word is already f32: a no-op in the port);
* ``linearize`` — ``JacobianOperator`` (``torch.func.linearize`` of the f32
  residual: a primal evaluation and the traced J·v);
* ``probe_factory`` — the DST factory on that operator (``probe_5point`` and
  the sine bases), paid once per solve by ``precond_refresh="once"``;
* ``dst_apply`` — one preconditioner apply (four f32 matmuls and a scale);
* ``cg_iter`` — one iteration of ``solvers.cg``'s body and loop test, and
  its parts: ``cg.matvec`` (J·p), ``cg.precond`` (M⁻¹r), ``cg.dots`` (⟨p,
  Ap⟩ and the fused ⟨r, r⟩, ⟨r, z⟩ with the scalar updates), ``cg.axpys``
  (the three vector updates) and ``cg.read`` (the one boolean the loop
  reads back a step);
* ``acceptance_df32`` — the df32 residual at the new state and its norm;
* ``f64_update`` — the df32 state update ``u ← u ⊕ (−d)``;
* ``outer_body`` — one whole outer, measured by differencing solves driven
  past any tolerance for ``K_SHORT`` and ``K_LONG`` outers, beside the sum of
  the parts at its measured inners per outer, and again with Python's
  cyclic garbage collector paused.

Every phase starts from ``__graft_entry__.entry()``'s u₀ (the f32 sin-bump
as its f64 value).  The script then runs the flagship once to
``tol_rel=1e-8`` and prints its counts.

Run on the card (``--device cpu`` for a small rehearsal):

    python -m newtonkrylov_tpu_torch.benchmarks.solve_profile [--n 2048]
"""

from __future__ import annotations

import argparse
import gc
import time
from typing import Callable, Dict, Optional, Sequence

import torch

LAM = 5.0
K_SHORT, K_LONG = 3, 8


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def timed(fn: Callable, device, reps: int) -> Dict[str, Optional[float]]:
    """ms per call of ``fn`` after a warm call: ``host`` (the host clock up
    to a synchronization), ``events`` (CUDA events around the calls) and
    ``busy`` (device-busy time under the profiler); the last two None off
    the card."""
    fn()
    _sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return {"host": (time.perf_counter() - t0) / reps * 1e3,
                "events": None, "busy": None}
    from .chain_solve import device_busy

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / reps * 1e3

    def loop():
        for _ in range(reps):
            fn()

    return {"host": host, "events": start.elapsed_time(end) / reps,
            "busy": device_busy(loop).busy_s / reps * 1e3}


def _u0(n: int, device):
    """``__graft_entry__.entry()``'s u₀: the f32 sin-bump, as its f64 value."""
    from ..problems import bratu2d

    return bratu2d.initial_guess(n, dtype=torch.float32,
                                 device=device).to(torch.float64)


def _flagship(n: int, device, **over):
    """(u, info) of the flagship at n² from entry()'s u₀, ``over`` on top."""
    from ..fftprec import fft_poisson
    from ..newton import newton_krylov_jit
    from ..problems import bratu2d

    p = bratu2d.default_config(n, lam=LAM)
    u0 = _u0(n, device)
    kw = dict(algo="cg", tol_rel=1e-8, krylov_dtype=torch.float32,
              residual_df=bratu2d.residual_scaled_df, max_niter=20,
              M=fft_poisson(precision="high"), precond_refresh="once")
    kw.update(over)
    return newton_krylov_jit(bratu2d.residual_scaled, u0, p, **kw)


def phases(n: int, device, reps: int = 10, log=print) -> Dict[str, dict]:
    """Every phase of the module at n², timed (see :func:`timed`)."""
    from .. import df32 as dd
    from ..fftprec import fft_poisson
    from ..newton import _linearization_point
    from ..operator import JacobianOperator
    from ..problems import bratu2d
    from ..spaces import EuclideanSpace
    from ..tree import tree_axpy

    f32 = torch.float32
    F = bratu2d.residual_scaled
    p = bratu2d.default_config(n, lam=LAM)
    space = EuclideanSpace()
    u = dd.df_from_f64(_u0(n, device))
    res = bratu2d.residual_scaled_df(u, p)

    def cast_down():
        u_lin, p_lin = _linearization_point(p, u, f32, bratu2d.residual_scaled_df)
        return u_lin, p_lin, res.hi.to(f32)

    u_lin, p_lin, b = cast_down()
    J = JacobianOperator(F, u_lin, p_lin)
    factory = fft_poisson(precision="high")
    M = factory(J)
    x = M(b)

    # one CG iteration on the solve's own operator and preconditioner,
    # carried from r₀ = b: solvers.cg's body and loop test
    st = {"x": torch.zeros_like(b), "r": b.clone()}
    st["p"] = M(st["r"])
    st["rz"] = space.dot(st["r"], st["p"])
    limit = torch.tensor(10**9, device=device)
    eps_abs = torch.zeros((), dtype=f32, device=device)

    def cg_iter():
        Ap = J.mv(st["p"])
        pAp = space.dot(st["p"], Ap)
        brk = pAp == 0
        alpha = st["rz"] / torch.where(brk, torch.ones_like(pAp), pAp)
        x_ = tree_axpy(alpha, st["p"], st["x"])
        r = tree_axpy(-alpha, Ap, st["r"])
        z = M(r)
        rr, rz_new = space.dot2(r, r, r, z)
        resnorm = torch.sqrt(rr.real)
        beta = rz_new / torch.where(st["rz"] != 0, st["rz"], torch.ones_like(rz_new))
        p_ = tree_axpy(beta, st["p"], z)
        k = torch.ones((), dtype=torch.int64, device=device)
        bool((k < limit) & ~((resnorm <= eps_abs) | brk))
        # keep the carried vectors at the scale of the solve
        st.update(x=x_ * 0.5, r=r * 0.5, p=p_ * 0.5, rz=rz_new * 0.25)

    Ap0 = J.mv(st["p"])
    r0, z0 = st["r"], M(st["r"])
    pAp0 = space.dot(st["p"], Ap0)
    rz0 = st["rz"]
    flag = torch.ones((), dtype=torch.bool, device=device)

    def dots():
        pAp = space.dot(st["p"], Ap0)
        alpha = rz0 / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        rr, rz_new = space.dot2(r0, r0, r0, z0)
        return alpha, torch.sqrt(rr.real), rz_new / torch.where(
            rz0 != 0, rz0, torch.ones_like(rz_new))

    alpha0 = rz0 / pAp0

    def axpys():
        return (tree_axpy(alpha0, st["p"], st["x"]),
                tree_axpy(-alpha0, Ap0, r0), tree_axpy(alpha0, st["p"], z0))

    u_new = dd.tree_add_f32(u, -x)

    def acceptance():
        r_new = bratu2d.residual_scaled_df(u_new, p)
        return space.norm(r_new.hi)

    run = {
        "cast_down": (cast_down, reps * 10),
        "linearize": (lambda: JacobianOperator(F, u_lin, p_lin), reps),
        "probe_factory": (lambda: factory(J), reps),
        "dst_apply": (lambda: M(b), reps * 5),
        "cg_iter": (cg_iter, reps * 5),
        "cg.matvec": (lambda: J.mv(b), reps * 5),
        "cg.precond": (lambda: M(b), reps * 5),
        "cg.dots": (dots, reps * 5),
        "cg.axpys": (axpys, reps * 5),
        "cg.read": (lambda: bool(flag & ~flag), reps * 5),
        "acceptance_df32": (acceptance, reps * 5),
        "f64_update": (lambda: dd.tree_add_f32(u, -x), reps * 5),
    }
    out = {}
    for name, (fn, r) in run.items():
        out[name] = timed(fn, device, r)
        log(f"[solve_profile] {n}² {name:16s} " + _fmt(out[name]))
    return out


def _fmt(t: Dict[str, Optional[float]]) -> str:
    def ms(v):
        return "not measured" if v is None else f"{v:9.4f} ms"

    return (f"host {ms(t['host'])}  events {ms(t['events'])}  "
            f"device busy {ms(t['busy'])}")


def outer_body(n: int, device, log=print) -> dict:
    """ms per outer, by differencing flagship solves driven past any
    tolerance (``tol_rel = tol_abs = 0``, no floor clamp) for ``K_SHORT``
    and ``K_LONG`` outers (the best of two walls each), and the inner
    iterations per outer between them; the same host time with Python's
    cyclic garbage collector paused (``host_gc_off``: each outer's
    linearization traces thousands of objects, and a collection landing in
    a trace is part of the outer's cost); on the card the device busy time
    of one more solve of each length."""
    def solve(k):
        return _flagship(n, device, tol_rel=0.0, tol_abs=0.0, max_niter=k,
                         floor_rtol=None)[1]

    def per_outer(walls):
        return (walls[K_LONG] - walls[K_SHORT]) / (K_LONG - K_SHORT) * 1e3

    solve(K_SHORT)  # warm
    walls, walls_gc_off, inners, busy = {}, {}, {}, {}
    for k in (K_SHORT, K_LONG):
        for into, collect in ((walls, True), (walls_gc_off, False)):
            into[k] = float("inf")
            for _ in range(2):  # the best of two: a host pause lands in one
                _sync(device)
                if not collect:
                    gc.disable()
                try:
                    t0 = time.perf_counter()
                    info = solve(k)
                    _sync(device)
                    into[k] = min(into[k], time.perf_counter() - t0)
                finally:
                    gc.enable()
        inners[k] = int(info.stats.inner_iterations)
        if device.type == "cuda":
            from .chain_solve import device_busy

            busy[k] = device_busy(lambda: solve(k)).busy_s
    diff = K_LONG - K_SHORT
    rec = {"host": per_outer(walls), "host_gc_off": per_outer(walls_gc_off),
           "busy": ((busy[K_LONG] - busy[K_SHORT]) / diff * 1e3
                    if busy else None),
           "events": None,
           "inner_per_outer": (inners[K_LONG] - inners[K_SHORT]) / diff}
    log(f"[solve_profile] {n}² outer_body       {_fmt(rec)}  "
        f"({rec['inner_per_outer']:.2f} inner/outer; {K_SHORT} against "
        f"{K_LONG} outers); host {rec['host_gc_off']:.4f} ms with the "
        f"garbage collector paused")
    return rec


def attribution(parts: Dict[str, dict], whole: dict, log=print) -> dict:
    """The parts of one outer summed (``probe_factory`` is paid once a solve
    and left out; ``cg_iter`` weighed by the inners per outer) against the
    whole outer."""
    ipo = whole["inner_per_outer"]
    rows = [("cast_down", 1.0), ("linearize", 1.0), ("cg_iter", ipo),
            ("acceptance_df32", 1.0), ("f64_update", 1.0)]
    out = {}
    for key in ("host", "busy"):
        if parts["linearize"][key] is None or whole[key] is None:
            continue
        total = sum(w * parts[name][key] for name, w in rows)
        out[key] = total
        log(f"[solve_profile] sum of the parts ({key}): {total:.4f} ms against "
            f"the whole outer {whole[key]:.4f} ms ("
            + ", ".join(f"{name} {100 * w * parts[name][key] / whole[key]:.1f}%"
                        for name, w in rows) + ")")
    return out


def run(n: int = 2048, device="cuda", reps: int = 10, log=print) -> dict:
    """The phases, the whole outer, their attribution and the flagship's
    counts at n² (see the module).  The card by default: without CUDA it
    raises unless ``device="cpu"``."""
    from ..examples import _common

    dev = _common.resolve_device(device)
    parts = phases(n, dev, reps, log)
    whole = outer_body(n, dev, log)
    parts["outer_body"] = whole
    summed = attribution(parts, whole, log)
    _sync(dev)
    t0 = time.perf_counter()
    _, info = _flagship(n, dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = (int(info.stats.outer_iterations), int(info.stats.inner_iterations))
    log(f"[solve_profile] {n}² flagship: solved={bool(info.solved)} "
        f"outer/inner {counts[0]}/{counts[1]} in {wall:.3f} s")
    return {"n": n, "phases": parts, "sum": summed, "solved": bool(info.solved),
            "counts": counts, "wall_s": wall}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args(argv)
    run(a.n, a.device, a.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
