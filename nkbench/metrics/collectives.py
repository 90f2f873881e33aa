"""Collectives a solve: rank 0's all-reduces, reduce-scatters, all-gathers
and ghost exchanges (``utils.distributed.COLLECTIVES``, one exchange a
sharded axis and exchange) over the window, over the window's solves.
None where the program issued none (a solve on one card)."""

KINDS = ("all_reduce", "reduce_scatter", "all_gather", "exchange")


def read(run):
    total = sum(run.counters.get(f"collectives.{k}", 0) for k in KINDS)
    return total / len(run.records) if total and run.records else None
