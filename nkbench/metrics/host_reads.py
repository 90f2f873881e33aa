"""Times a solve blocks the host on the card to read a loop's condition
back: the ``read`` spans inside the window's solves over the number of
solves."""
from nkbench import spans


def read(run):
    return spans.from_window(run, spans.host_reads)
