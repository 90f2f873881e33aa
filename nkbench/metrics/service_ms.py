"""Host ms a request, from its call to its synchronization, over the
window's requests: the service time without the wait for its turn."""
from nkbench import readers


def read(run):
    mean = readers.mean_of(run, "wall_s")
    return None if mean is None else 1e3 * mean
