"""Find the highest rate a served cell sustains: a sweep on the card.

Not run by the benchmark.  Sets the cell up as a run does, then offers its
mix at each rate (requests per second) for ``--seconds`` and prints, per
rate, the requests, their median and 95th-percentile latency, the mean
service time and how late the last request was sent: a backlog that grows
through the window shows as a lateness that grows with the window.

    python3 nkbench/sweep.py --workload sfi-dst.serve-2048 --rates 5 6 7 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=None)
    a = ap.parse_args(argv)

    import torch

    from nkbench import harness, spec
    from nkbench.system import System
    from nkbench.trace import Spans

    dev = torch.device(a.device)
    bench = spec.benchmark()
    cell = spec.workload(bench, a.workload)
    config = spec.load_json("config", cell["config"])
    mix = spec.load_json("traffic", cell["traffic"])
    n = a.side or int(mix["side"])
    system = System(config, n, dev, mode=mix["mode"])
    run = harness.Run(cell, config, mix, system, print)
    warm = run.u0(system.state_dtype())
    system.prepare(warm)
    for _ in range(3):
        system(warm)
    rows = []
    for rate in a.rates:
        run.mix = dict(mix, rate_per_s=rate, check={"sample": 0})
        run.records = []
        harness._window(run, a.seed, a.seconds, Spans(), {})
        lat = sorted(r.latency_s for r in run.records)
        row = {"rate_per_s": rate, "requests": len(lat),
               "p50_ms": 1e3 * lat[len(lat) // 2],
               "p95_ms": 1e3 * lat[max(0, -(-len(lat) * 95 // 100) - 1)],
               "service_ms": 1e3 * sum(r.wall_s for r in run.records) / len(lat),
               "last_late_ms": 1e3 * run.records[-1].late_s,
               "window_s": run.window_s}
        rows.append(row)
        print(json.dumps(row), flush=True)
    system.close()
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
