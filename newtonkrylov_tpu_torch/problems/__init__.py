"""Test and benchmark problems (ported so far: the Kelley 2×2 system,
1-D and 2-D Bratu, and 2-D convection–diffusion)."""

from . import bratu1d, bratu2d, convdiff2d, simple

__all__ = ["simple", "bratu1d", "bratu2d", "convdiff2d"]
