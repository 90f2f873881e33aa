"""Host ms of a Newton outer that no span inside it accounts for: each
window ``outer`` span's length less the union of its child spans
(linearization, Krylov solve, acceptance, preconditioner build,
collections), the median over the window's outers."""
from nkbench import spans


def read(run):
    return spans.from_window(run, spans.outer_self_ms)
