"""Inexact-Newton forcing strategies.

Counterpart of ``newtonkrylov_tpu/forcing.py``, with the same arithmetic and
branch structure (iteration-count parity depends on it):

* :class:`Fixed` — constant η (default 0.1).
* :class:`EisenstatWalker` — Eisenstat & Walker choice 2 with the Eq.-3.6
  safeguard and the Eq.-3.5 oversolving floor, both capped at ``η_max``.

``__call__`` takes and returns 0-d tensors (the device-side update of the
Newton driver); ``host_update`` is the same update on Python floats.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Forcing", "Fixed", "EisenstatWalker"]


@dataclasses.dataclass(frozen=True)
class Forcing:
    """Base class: callable (η, tol, n_res, n_res_prior) → new η."""

    def __call__(self, eta, tol, n_res, n_res_prior):
        raise NotImplementedError

    def initial(self):
        """η₀."""
        raise NotImplementedError

    def host_update(self, eta, tol, n_res, n_res_prior):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Fixed(Forcing):
    """Constant forcing term."""

    eta: float = 0.1

    def __call__(self, eta, tol, n_res, n_res_prior):
        return torch.full((), self.eta, dtype=n_res.dtype, device=n_res.device)

    def initial(self):
        return self.eta

    def host_update(self, eta, tol, n_res, n_res_prior):
        return self.eta


@dataclasses.dataclass(frozen=True)
class EisenstatWalker(Forcing):
    """Eisenstat–Walker adaptive forcing (η_max = 0.999, γ = 0.9)."""

    eta_max: float = 0.999
    gamma: float = 0.9

    def __call__(self, eta, tol, n_res, n_res_prior):
        g = self.gamma
        eta_res = g * (n_res * n_res) / (n_res_prior * n_res_prior)
        # Eq 3.6 safeguard, with the reference's association γ·(η²)
        geta2 = g * (eta * eta)
        eta_safe = torch.where(
            geta2 <= 0.1,
            torch.clamp(eta_res, max=self.eta_max),
            torch.clamp(torch.maximum(eta_res, geta2), max=self.eta_max),
        )
        # Eq 3.5 oversolving floor
        return torch.clamp(torch.maximum(eta_safe, 0.5 * tol / n_res),
                           max=self.eta_max)

    def initial(self):
        return self.eta_max

    def host_update(self, eta, tol, n_res, n_res_prior):
        g = self.gamma
        eta_res = g * (n_res * n_res) / (n_res_prior * n_res_prior)
        if g * (eta * eta) <= 0.1:
            eta_safe = min(self.eta_max, eta_res)
        else:
            eta_safe = min(self.eta_max, max(eta_res, g * (eta * eta)))
        return min(self.eta_max, max(eta_safe, 0.5 * tol / n_res))
