"""Device ms of one apply of the configuration's preconditioner, built on
the float32 Jacobian at the requests' starting state, by CUDA events over
repeated applies after the window."""
from nkbench import readers, replay


def read(run):
    return readers.on_card(run, replay.precond_apply_ms)
