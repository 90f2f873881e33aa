"""The correctness check's control and faults (not run by the benchmark).

* The control: the configuration's solve with the program's own float32
  acceptance switched on in place of the configured df32 one (the nearest
  precision below it), judged by the same reference and limit as a run.
  :func:`readings` gives the control's ``res_ratio`` and, beside it, the
  configured program's, one solve a seed from the cell's request
  (``--program`` adds the configured path).
* The faults: :data:`FAULTS` wraps the system under test so that its
  answers are broken where they are produced; the harness's tests drive a
  whole run with each and see ``correct`` come out false.

On the card, at a cell's own side:

    python3 nkbench/control.py --workload sfi-dst.solve-8192 --seeds 1 2 3 --program
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Iterable


def _unchanged(u, u0):
    return u0.to(u.dtype).clone()


def _half(u, u0):
    out = u.clone()
    out[u.shape[0] // 2:] = u0[u.shape[0] // 2:].to(u.dtype)
    return out


def _altered(u, u0):
    out = u.clone()
    i = u.shape[0] // 2
    out[i, i] = out[i, i] * (1.0 + 1e-6)
    return out


# a step that returns its state unchanged; half of the grid left out of the
# solve; one value of an answer altered where it is produced
FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


def broken(fault: str):
    """A :class:`nkbench.system.System` whose answers carry ``fault``."""
    from nkbench.system import Answer, System

    planted = FAULTS[fault]

    class Broken(System):
        def __call__(self, u0):
            a = super().__call__(u0)
            return Answer(planted(a.u, u0), a.outer, a.inner, a.solved)

    return Broken


def readings(workload: str, seeds: Iterable[int], device="cuda",
             side=None, program: bool = False, log=print) -> list:
    """``res_ratio`` of the control (and with ``program`` of the configured
    solve) on each seed's first request of cell ``workload``.  The cells'
    requests do not depend on the seed, so each seed repeats the solve."""
    import torch

    from nkbench import check, spec, traffic
    from nkbench.system import System

    dev = torch.device(device)
    bench = spec.benchmark()
    cell = spec.workload(bench, workload)
    config = spec.load_json("config", cell["config"])
    mix = spec.load_json("traffic", cell["traffic"])
    n = int(side or mix["side"])
    ref = check.reference(config["reference"])
    guess = traffic.initial_guess(config["problem"], n, dev)
    paths = ["f32"] + (["df32"] if program else [])
    out = []
    for acceptance in paths:
        system = System(config, n, dev, mode="live", acceptance=acceptance)
        for seed in seeds:
            u0 = guess.clone()
            a = system(u0.to(system.state_dtype()))
            j = ref.judge(a.u.to(torch.float64), u0, config["problem"],
                          config["recipe"])
            row = {"workload": workload, "acceptance": acceptance,
                   "seed": seed, "outer": a.outer,
                   "inner": a.inner, "solved": a.solved, **j,
                   "limit": mix["check"]["limits"]["res_ratio"]}
            log(json.dumps(row))
            out.append(row)
            del a
        del system
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=None)
    a = ap.parse_args(argv)
    readings(a.workload, a.seeds, a.device, a.side, a.program)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
