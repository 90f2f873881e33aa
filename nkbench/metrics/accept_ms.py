"""Device ms of one df32 acceptance residual and its norm at the cell's
side, by CUDA events over repeated calls after the window."""
from nkbench import readers, replay


def read(run):
    return readers.on_card(run, replay.accept_ms)
