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
states (``"initial_guess"`` in the configuration's ``"problem"``), made
afresh by :func:`initial_guess`.  The seed draws which answers of an open
loop the reference checks (:func:`checked`).
"""

from __future__ import annotations

from typing import List

import numpy as np


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


def initial_guess(problem: dict, n: int, device, block=None):
    """The starting state the problem's source states, on the n × n
    interior of the unit square (spacing h = 1/(n+1)), in float64 on
    ``device``; with ``block`` (a pair of slices of the rows and columns)
    only that block of it, as a rank of a sharded solve forms its own.

    ``"ex5"``: PETSc SNES ex5's ``FormInitialGuess`` and MINPACK-2's
    ``dsfifg`` (task ``'XS'``), ``u₀ = λ/(λ+1)·sqrt(d)`` with ``d`` the
    smaller of the point's distances to the boundary along x and along y.
    """
    import torch

    if problem.get("initial_guess") != "ex5":
        raise ValueError(f"unknown initial guess "
                         f"{problem.get('initial_guess')!r}")
    lam = float(problem["lam"])
    i = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    d = torch.minimum(i, n + 1 - i) / (n + 1)
    rows, cols = (d, d) if block is None else (d[block[0]], d[block[1]])
    return (lam / (lam + 1.0)) * torch.sqrt(torch.minimum(rows[:, None],
                                                          cols[None, :]))
