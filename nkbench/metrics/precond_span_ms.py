"""Device ms of one preconditioner apply inside a solve: the device time of
the work launched inside ``precond`` spans of one traced solve after the
window, over those spans."""
from nkbench import spans


def read(run):
    return spans.from_replay(run,
                             lambda rep: spans.device_ms_in(rep, "precond"))
