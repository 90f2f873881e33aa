"""The one generator of every traffic mix: requests drawn from a seed.

A mix (``nkbench/traffic/<name>.json``) states the side of the grid and
how requests arrive:

* ``"loop": "closed"``: one client sends a request when the previous one
  has returned, for ``--seconds``; a request started inside the window
  finishes and counts.
* ``"loop": "open"``: requests fall due at ``"rate_per_s"`` per second,
  evenly spaced, over ``--seconds``; each is sent when due, or as soon as
  the one before it returns.

Every request starts from the initial guess its configuration's source
states, made afresh by :func:`initial_guess` from the configuration's
plain reference.  The seed draws which answers of an open loop the
reference checks (:func:`checked`).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .check import reference


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *salt]))


def due_times(mix: dict, seconds: float) -> List[float]:
    """Open loop: the offsets (s from the window's start) at which the
    requests of a window of ``seconds`` fall due."""
    if mix["loop"] != "open":
        raise ValueError("only an open loop has due times")
    rate = float(mix["rate_per_s"])
    count = int(np.ceil(seconds * rate - 1e-9))
    return [i / rate for i in range(count)]


def checked(mix: dict, seed: int, count: int) -> List[int]:
    """The indices of the ``count`` requests of a window whose answers the
    reference checks: all of them, or ``"sample"`` of them drawn from the
    seed (``"check"`` in the mix)."""
    sample = mix.get("check", {}).get("sample")
    if sample is None or sample >= count:
        return list(range(count))
    return sorted(int(i) for i in _rng(seed, 2).choice(count, int(sample),
                                                         replace=False))


def initial_guess(config: dict, n: int, device, block=None):
    """The starting state of every request of ``config``, on the n × n
    interior in float64 on ``device`` (with ``block``, a pair of slices of
    the rows and columns, that block of it): the source's own, as the
    configuration's reference (``nkbench/reference/<name>.py``) states it."""
    return reference(config["reference"]).initial_guess(
        config["problem"], n, device, block)
