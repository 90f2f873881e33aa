"""One run of one benchmark cell: set up, measure a window, check, report.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix
(:mod:`nkbench.spec` finds both).  A run

1. builds the configuration's solve at the mix's side on the card
   (:class:`nkbench.system.System`), makes one warm request of the cell's
   own shape (served: exports, saves and loads the solve first), and
   counts everything up to the window as ``setup_s``;
2. drives the mix for ``--seconds`` (:mod:`nkbench.traffic`): each request
   is timed by the host clock from its call to ``torch.cuda.synchronize()``,
   and with ``--trace 1`` the card's timeline is recorded
   (:mod:`nkbench.trace`);
3. reads ``memory_peak_bytes``, then the cell's metrics: the end-to-end
   readers with ``--trace 0``, the per-layer readers with ``--trace 1``;
4. frees the program's state and judges the answers it returned with the
   configuration's plain reference (:mod:`nkbench.check`);
5. prints the numbers compared beside their limits as the last lines of
   standard error, and one JSON line last on standard output.

A cell whose ``chips`` is above 1 runs over that many ranks, one process
a card (:mod:`nkbench.ranks`): rank 0 starts the others, every rank builds
its block of the configuration's sharded solve
(:class:`nkbench.sharded.ShardedSystem`), and every request's wall runs on
rank 0's clock until every card has finished.  Rank 0 alone reads the
metrics, judges the answers (their blocks gathered from the ranks) and
prints.

Nothing is printed as a result without a card, or when a module of JAX or
of the JAX package was loaded in any rank.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from . import check, ranks, spec, traffic
from .system import System, system_class
from .trace import Recorder, Spans, now_ns

FORBIDDEN = ("jax", "jaxlib", "flax", "newtonkrylov_tpu")
# the program's counters, read before and after the window
COUNTERS = {
    "launches": "newtonkrylov_tpu_torch.kernels.stencil2d:LAUNCHES",
    "host_copies": "newtonkrylov_tpu_torch.precond:HOST_COPIES",
    "collectives": "newtonkrylov_tpu_torch.utils.distributed:COLLECTIVES",
}


class NoDevice(RuntimeError):
    pass


class Record(NamedTuple):
    """One request of the window."""
    index: int
    wall_s: float      # from its call to the synchronize after it
    latency_s: float   # from when it was due (closed loop: its wall)
    late_s: float      # how late it was sent (closed loop: 0)
    outer: int
    inner: int
    solved: bool


class Run:
    """What a metric reader is handed (``read(run)``)."""

    def __init__(self, cell: dict, config: dict, mix: dict, system: System,
                 log: Callable[[str], None]):
        self.cell, self.config, self.mix = cell, config, mix
        self.system, self.log = system, log
        self.n, self.device = system.n, system.device
        self.guess = traffic.initial_guess(config["problem"], self.n,
                                           self.device, system.block)
        self.world = 1  # the ranks the cell runs over
        self.records: List[Record] = []
        self.timeline = None
        self.counters: Dict[str, int] = {}
        self.window_s = 0.0
        self.window_ns = (0, 0)

    def u0(self, dtype=torch.float64):
        """A fresh copy of the starting state every request is sent (over
        ranks: this rank's block of it)."""
        return self.guess.to(dtype, copy=True)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _read_counters() -> Dict[str, int]:
    from .system import resolve

    out = {}
    for prefix, ref in COUNTERS.items():
        for k, v in resolve(ref).items():
            out[f"{prefix}.{k}"] = int(v)
    return out


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, one
    of its libraries' or the JAX package's (compared whole)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _device_check(device: torch.device, chips: int) -> None:
    if device.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA devices, "
                       f"torch.cuda.device_count() is "
                       f"{torch.cuda.device_count()}")


def _power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _window(run: Run, seed: int, seconds: float, spans: Spans,
            keep: Dict[int, torch.Tensor], group: ranks.Group) -> None:
    """Drive the mix for ``seconds``; fills ``run.records`` and ``keep``
    (the answers to check, on the host).  What is alive before the window
    (the libraries, the program's built state) is moved out of the garbage
    collector's reach first (``gc.freeze``), as a long-running service
    does; the collector stays on, so the program's own garbage is
    collected, and paid for, inside the window."""
    gc.collect()
    gc.freeze()
    try:
        if group.world > 1:
            _drive_ranks(run, seconds, spans, keep, group)
        else:
            _drive(run, seed, seconds, spans, keep)
    finally:
        gc.unfreeze()


def _drive(run: Run, seed: int, seconds: float, spans: Spans,
           keep: Dict[int, torch.Tensor]) -> None:
    mix, system, dev = run.mix, run.system, run.device
    dtype = system.state_dtype()
    closed = mix["loop"] == "closed"
    if closed:
        dues, sample, pin = None, None, False
    else:
        dues = traffic.due_times(mix, seconds)
        sample = set(traffic.checked(mix, seed, len(dues)))
        pin = dev.type == "cuda"
        for i in sample:  # page-locked: the copies run beside the next one
            keep[i] = torch.empty((run.n, run.n), dtype=dtype,
                                  pin_memory=pin)
    _sync(dev)
    w0_ns = now_ns()
    t0 = time.perf_counter()
    i = 0
    while (time.perf_counter() - t0 < seconds) if closed else i < len(dues):
        b_ns = now_ns()
        u0 = run.u0(dtype)
        _sync(dev)
        if not closed:
            wait = t0 + dues[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        a_ns = now_ns()
        spans.add("between requests", b_ns, a_ns)
        t = time.perf_counter()
        due = t if closed else t0 + dues[i]
        ans = system(u0)
        _sync(dev)
        done = time.perf_counter()
        spans.add("request", a_ns, now_ns())
        run.records.append(Record(i, done - t, done - due, t - due,
                                  ans.outer, ans.inner, ans.solved))
        if closed:
            keep[i] = ans.u.to("cpu")
        elif i in sample:
            keep[i].copy_(ans.u, non_blocking=pin)
        del ans, u0
        i += 1
    _sync(dev)
    run.window_s = time.perf_counter() - t0
    run.window_ns = (w0_ns, now_ns())


def _drive_ranks(run: Run, seconds: float, spans: Spans,
                 keep: Dict[int, torch.Tensor], group: ranks.Group) -> None:
    """A closed loop over ranks.  Before each request, outside its wall,
    every rank puts its block of u₀ on its card, and the ranks agree on
    rank 0's decision whether it starts (which they reach together).  A
    request's wall runs on rank 0's clock from the call until every rank
    has synchronized its card: the slowest card sets it.  Each rank keeps
    its block of every answer on the host."""
    if run.mix["loop"] != "closed":
        raise NotImplementedError("a cell over ranks runs a closed loop")
    dev, system = run.device, run.system
    dtype = system.state_dtype()
    _sync(dev)
    group.barrier()
    w0_ns = now_ns()
    t0 = time.perf_counter()
    i = 0
    while True:
        b_ns = now_ns()
        u0 = run.u0(dtype)
        _sync(dev)
        if not group.decide(time.perf_counter() - t0 < seconds):
            break
        a_ns = now_ns()
        spans.add("between requests", b_ns, a_ns)
        t = time.perf_counter()
        ans = system(u0)
        _sync(dev)
        group.barrier()
        done = time.perf_counter()
        spans.add("request", a_ns, now_ns())
        run.records.append(Record(i, done - t, done - t, 0.0, ans.outer,
                                  ans.inner, ans.solved))
        keep[i] = ans.u.to("cpu")
        del ans, u0
        i += 1
    _sync(dev)
    run.window_s = time.perf_counter() - t0
    run.window_ns = (w0_ns, now_ns())


def _metrics(bench: dict, section: str, run: Run, log) -> Dict[str, dict]:
    out = {}
    for entry in spec.metrics_for(bench, section, run.cell["name"]):
        if section == "end_to_end" and entry["name"] == "setup_s":
            continue
        value = spec.reader(section, entry["name"]).read(run)
        if value is None:
            log(f"[nkbench] {entry['name']}: nothing to read in this run")
            continue
        out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        side: Optional[int] = None, system_factory=None,
        log: Callable[[str], None] = None) -> Optional[dict]:
    """One run of cell ``workload`` (see the module); returns the result
    object that :func:`main` prints (over ranks: on rank 0, None on the
    others, each called in its rank of a process group of the cell's
    ``chips``).  ``device``, ``side`` and ``system_factory`` (by default
    the one the configuration's recipe asks for) exist for the harness's
    own tests on the CPU."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    dev = torch.device(device)
    bench = spec.benchmark()
    cell = spec.workload(bench, workload)
    chips = int(cell["chips"])
    _device_check(dev, chips)
    if chips > 1 and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    group = ranks.Group(dev, chips)
    if not group.lead:
        say = log

        def log(m):
            say(f"[rank {group.rank}] {m}")
    config = spec.load_json("config", cell["config"])
    mix = spec.load_json("traffic", cell["traffic"])
    n = int(side or mix["side"])
    system_factory = system_factory or system_class(config)
    system = system_factory(config, n, dev, mode=mix["mode"])
    r = Run(cell, config, mix, system, log)
    r.world = group.world

    # set-up: the solve (served: exported, saved, loaded) and warm requests,
    # each cut to the mix's "warm_outers" where it states them
    u_warm = r.u0(system.state_dtype())
    system.prepare(u_warm)
    warm = {"max_niter": mix["warm_outers"]} if "warm_outers" in mix else {}
    for _ in range(int(mix["warm_requests"])):
        system(u_warm, **warm)
    _sync(dev)
    del u_warm
    if group.world > 1:
        group.barrier()
    setup_s = time.perf_counter() - t_start
    log(f"[nkbench] {workload}: set-up {setup_s:.3f} s (side {n}, "
        f"{mix['mode']} solve)")

    before = _read_counters()
    spans = Spans()
    keep: Dict[int, torch.Tensor] = {}
    with Recorder(trace and r.cuda and group.lead) as rec:
        _window(r, seed, seconds, spans, keep, group)
    after = _read_counters()
    r.counters = {k: after[k] - before[k] for k in after}
    peak = torch.cuda.max_memory_allocated(dev) if r.cuda else 0
    if group.world > 1:
        peak = int(group.max(peak))  # the fullest card's
        if not group.lead:
            return _judge(r, keep, group, log)
    log(f"[nkbench] window {r.window_s:.3f} s: {len(r.records)} requests; "
        f"counters {({k: v for k, v in r.counters.items() if v})}")
    if r.records:
        late = max(x.late_s for x in r.records)
        log(f"[nkbench] requests sent up to {late * 1e3:.3f} ms late; "
            f"walls (s): " + " ".join(f"{x.wall_s:.4f}" for x in r.records))

    device_info = {"platform": "gpu" if r.cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if r.cuda else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak),
                   "power_limit": _power_limit() if r.cuda else None}
    result = {"correct": False, "attempted": len(r.records), "failed": 0}
    if trace:
        r.timeline = rec.result(spans, r.window_ns)
        if r.timeline is not None:
            t = r.timeline
            launches = sum(v for k, v in r.counters.items()
                           if k.startswith("launches."))
            log(f"[nkbench] profiler: {t.events} device events in the "
                f"window ({len(r.records)} requests, {launches} kernel "
                f"launches counted by the program); busy {t.busy_s:.6f} s "
                f"of the {t.window_s:.6f} s window, {t.request_busy_s:.6f} "
                f"s of the {t.request_s:.6f} s in requests")
            t.check(max(len(r.records), launches),
                    "one a request and one a counted launch")
            device_info.update(busy_s=r.timeline.busy_s,
                               window_s=r.timeline.window_s)
        metrics = _metrics(bench, "per_layer", r, log)
    else:
        metrics = _metrics(bench, "end_to_end", r, log)
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    result["metrics"] = metrics
    result["device"] = device_info
    if trace and r.timeline is not None:
        result["breakdown"] = r.timeline.breakdown()

    del system
    verdict = _judge(r, keep, group, log)
    result["correct"] = verdict.correct
    result["failed"] = verdict.failed
    result["checks"] = verdict.checks
    return result


def _judge(r: Run, keep: Dict[int, torch.Tensor], group: ranks.Group,
          log) -> Optional[check.Verdict]:
    """Free the program's state, then judge the kept answers (over ranks:
    gathered whole on rank 0, which alone judges, from the whole u₀)."""
    origin = r.system.origin if group.world > 1 else None
    r.system.close()
    r.system = None
    gc.collect()
    if r.cuda:
        torch.cuda.empty_cache()
    if group.world == 1:
        return check.judge(r, keep, log)
    whole = {}
    for i in sorted(keep):
        u = group.gather(keep.pop(i), origin, r.n)
        if group.lead:
            whole[i] = u
    if not group.lead:
        return None
    problem = r.config["problem"]
    return check.judge(r, whole, log, u0=lambda: traffic.initial_guess(
        problem, r.n, r.device))


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the harness's own tests on the CPU
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--side", type=int, default=None, help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    a = ap.parse_args(argv)
    chips = int(spec.workload(spec.benchmark(), a.workload)["chips"])
    if chips > 1:
        return _main_ranks(a, argv, chips, t_start)
    try:
        result = run(a.workload, a.seed, a.seconds, bool(a.trace),
                     device=a.device, t_start=t_start, side=a.side)
    except NoDevice as e:
        print(f"[nkbench] {e}; no result", file=sys.stderr)
        return 2
    return _report(result)


def _forbidden() -> bool:
    found = forbidden_modules()
    if found:
        print(f"[nkbench] modules of JAX or of the JAX package were loaded: "
              f"{found}; no result", file=sys.stderr)
    return bool(found)


def _report(result: dict) -> int:
    if _forbidden():
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


def _main_ranks(a, argv: List[str], chips: int,
                t_start: Optional[float]) -> int:
    """This process's rank of a cell over ``chips`` ranks (see
    :mod:`nkbench.ranks`): rank 0, unless started as a rank, starts the
    others; it prints the result once every rank has ended with code 0."""
    dev = torch.device(a.device)
    try:
        _device_check(dev, chips)
    except NoDevice as e:
        print(f"[nkbench] {e}; no result", file=sys.stderr)
        return 2
    result, ended = ranks.spmd(
        str(spec.HERE / "run.py"), argv, chips, dev,
        lambda: run(a.workload, a.seed, a.seconds, bool(a.trace),
                    device=a.device, t_start=t_start, side=a.side))
    if result is None:  # not rank 0
        return 3 if _forbidden() else 0
    return _report(result) if ended else 1
