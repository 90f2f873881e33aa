"""Seconds a solve: the summed wall of the window's solves over their
count, each from its call to its synchronization."""
from nkbench import readers


def read(run):
    return readers.mean_of(run, "wall_s")
