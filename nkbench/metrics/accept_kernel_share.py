"""Share of the window's df32 acceptance residuals that ran as one kernel
launch: the program's count of K7 launches
(``kernels.stencil2d.LAUNCHES["bratu_residual_df"]``) over the window's
acceptance calls, one an outer and one for a solve's initial residual
(the sum over its solves of outers + 1).  1.0 where every acceptance
launched the kernel; None where the program has no such counter."""

COUNTER = "launches.bratu_residual_df"


def read(run):
    calls = sum(r.outer + 1 for r in run.records)
    if COUNTER not in run.counters or not calls:
        return None
    return run.counters[COUNTER] / calls
