"""Krylov (CG) iterations a solve as the solve reported them, over the
window's solves."""
from nkbench import readers


def read(run):
    return readers.mean_of(run, "inner")
