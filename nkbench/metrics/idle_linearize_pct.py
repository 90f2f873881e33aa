"""Of the card's idle time inside one traced solve after the window, the
share, %, whose innermost host span is ``linearize``: each idle interval
split at span boundaries, each piece given to the innermost span open over
it."""
from nkbench import spans


def read(run):
    return spans.from_replay(
        run, lambda rep: spans.idle_share_pct(rep, "linearize"))
