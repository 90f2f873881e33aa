"""Traces of the residual's J·v a solve: the program's ``linearize.trace``
spans inside the window's solves over the number of solves.  A solve that
traces its J·v graph once, in its set-up, reads 1; one whose residual does
not trace with fake tensors counts its set-up's failed attempt and the
``torch.func.linearize`` of every linearization (outers + 2 with a static
preconditioner).  No result where the program records no such span (an
older checkout)."""
from nkbench import spans


def traces(w):
    found = w.named("linearize.trace")
    return len(found) / len(w.solves) if found else None


def read(run):
    return spans.from_window(run, traces)
