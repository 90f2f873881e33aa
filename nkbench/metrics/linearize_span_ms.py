"""Host ms of one linearization as the program's ``linearize`` spans
record it inside the window's solves (``JacobianOperator``'s
``torch.func.linearize``, every outer and the static preconditioner's):
their median."""
from nkbench import spans


def read(run):
    return spans.from_window(run, spans.linearize_span_ms)
