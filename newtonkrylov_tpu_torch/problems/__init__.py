"""Test and benchmark problems (ported so far: 2-D Bratu and 2-D
convection–diffusion)."""

from . import bratu2d, convdiff2d

__all__ = ["bratu2d", "convdiff2d"]
