"""The correctness check's control and faults (not run by the benchmark).

* The control: the configuration's solve with the program's own float32
  acceptance switched on in place of the configured df32 one (the nearest
  precision below it), judged by the same reference and limit as a run.
  :func:`readings` gives the control's ``res_ratio`` and, beside it, the
  configured program's, one solve a seed from the cell's request
  (``--program`` adds the configured path).
* The faults: :data:`FAULTS` wraps the system under test so that its
  answers are broken where they are produced, and :data:`SHARDED_FAULTS`
  so that a sharded solve leaves out the exchange between its ranks; the
  harness's tests drive a whole run with each and see ``correct`` come
  out false.

On the card, at a cell's own side (a cell over several chips starts its
ranks as ``nkbench/run.py`` does, and rank 0 prints the readings):

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


# a step that returns its state unchanged; half of the grid (of a rank's
# block) left out of the solve; one value of an answer (of each block)
# altered where it is produced
FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


def _no_exchange(base):
    """``base`` (a sharded system) with residuals that take zero ghosts:
    the exchange between the ranks left out, each block solved alone."""
    from newtonkrylov_tpu_torch import df32
    from newtonkrylov_tpu_torch.ops.stencil import pad_dirichlet

    from nkbench.system import resolve

    class NoExchange(base):
        def residuals(self):
            F = resolve(self.recipe["residual_padded"])
            F_df = resolve(self.recipe["residual_df_padded"])

            def F_alone(u, p):
                return F(pad_dirichlet(u), p)

            def F_df_alone(u, p):
                return F_df(df32.DF(pad_dirichlet(u.hi), pad_dirichlet(u.lo)),
                            u, p)

            return F_alone, F_df_alone

    return NoExchange


SHARDED_FAULTS = {"no_exchange": _no_exchange}


def broken(fault: str):
    """A system factory (``(config, n, device, mode)``) of the system the
    configuration asks for, whose answers carry ``fault`` (a key of
    :data:`FAULTS` or :data:`SHARDED_FAULTS`)."""
    from nkbench.system import Answer, system_class

    def make(config, n, device, mode="live"):
        base = system_class(config)
        if fault in SHARDED_FAULTS:
            return SHARDED_FAULTS[fault](base)(config, n, device, mode=mode)
        planted = FAULTS[fault]

        class Broken(base):
            def __call__(self, u0, **kw):
                a = super().__call__(u0, **kw)
                return Answer(planted(a.u, u0), a.outer, a.inner, a.solved)

        return Broken(config, n, device, mode=mode)

    return make


def readings(workload: str, seeds: Iterable[int], device="cuda",
             side=None, program: bool = False, log=print) -> list:
    """``res_ratio`` of the control (and with ``program`` of the configured
    solve) on each seed's first request of cell ``workload``.  The cells'
    requests do not depend on the seed, so each seed repeats the solve.
    A cell over several chips is read in each rank of a process group of
    its ``chips``: every rank solves its block, and rank 0 judges the
    gathered answer and returns the rows (the others return none)."""
    import torch

    from nkbench import check, ranks, spec, traffic
    from nkbench.system import system_class

    dev = torch.device(device)
    bench = spec.benchmark()
    cell = spec.workload(bench, workload)
    chips = int(cell["chips"])
    if chips > 1 and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    group = ranks.Group(dev, chips)
    config = spec.load_json("config", cell["config"])
    mix = spec.load_json("traffic", cell["traffic"])
    n = int(side or mix["side"])
    ref = check.reference(config["reference"])
    paths = ["f32"] + (["df32"] if program else [])
    out = []
    for acceptance in paths:
        system = system_class(config)(config, n, dev, mode="live",
                                      acceptance=acceptance)
        start = traffic.initial_guess(config, n, dev, system.block)
        for seed in seeds:
            a = system(start.to(system.state_dtype(), copy=True))
            u = a.u
            if group.world > 1:
                u = group.gather(u, system.origin, n)
            if group.lead:
                u0 = traffic.initial_guess(config, n, dev)
                j = ref.judge(u.to(dev, torch.float64), u0, config["problem"],
                              config["recipe"])
                row = {"workload": workload, "acceptance": acceptance,
                       "seed": seed, "outer": a.outer,
                       "inner": a.inner, "solved": a.solved, **j,
                       "limit": mix["check"]["limits"]["res_ratio"]}
                log(json.dumps(row))
                out.append(row)
            del a, u
        del system
    return out


def main(argv=None) -> int:
    import torch

    from nkbench import ranks, spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=None)
    argv = sys.argv[1:] if argv is None else list(argv)
    a = ap.parse_args(argv)
    chips = int(spec.workload(spec.benchmark(), a.workload)["chips"])
    if chips == 1:
        readings(a.workload, a.seeds, a.device, a.side, a.program)
        return 0
    _, ended = ranks.spmd(
        os.path.abspath(__file__), argv, chips, torch.device(a.device),
        lambda: readings(a.workload, a.seeds, a.device, a.side, a.program))
    return 0 if ended else 1


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
