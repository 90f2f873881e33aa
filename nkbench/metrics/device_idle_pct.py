"""The card's idle share of the traced window: 1 − (the union of the
device events' intervals ÷ the window), in %.  An open loop's waits for
its next request are in the window."""
from nkbench import readers


def read(run):
    return readers.idle_pct(run)
