"""The card's idle share of the requests' own time: 1 − (the union of the
device events' intervals inside the requests ÷ their summed length), in
%: how far the host paces a request once it is sent."""
from nkbench import readers


def read(run):
    return readers.request_idle_pct(run)
