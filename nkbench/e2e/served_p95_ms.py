"""The 95th percentile (nearest rank) of the served requests' latencies,
each from when it fell due to its synchronization, over all the window's
requests."""
from nkbench import readers


def read(run):
    return readers.p95_latency_ms(run)
