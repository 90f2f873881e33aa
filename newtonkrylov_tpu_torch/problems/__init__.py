"""Test and benchmark problems (ported so far: the Kelley 2×2 system,
1-D and 2-D Bratu, 2-D convection–diffusion, Kelley's two-point BVP and
2-D quasilinear diffusion)."""

from . import bratu1d, bratu2d, bvp, convdiff2d, nldiff2d, simple

__all__ = ["simple", "bratu1d", "bratu2d", "bvp", "convdiff2d", "nldiff2d"]
