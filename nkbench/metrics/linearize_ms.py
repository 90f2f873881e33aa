"""Host ms of one linearization (``JacobianOperator``, i.e.
``torch.func.linearize``) at the cell's side, up to a synchronization:
the median of replays after the window."""
from nkbench import readers, replay


def read(run):
    return readers.on_card(run, replay.linearize_ms)
