"""Host ms a solve spends in Python's garbage collector: the summed
length of the ``gc`` spans inside the window's solves over the number of
solves."""
from nkbench import spans


def read(run):
    return spans.from_window(run, spans.gc_ms)
