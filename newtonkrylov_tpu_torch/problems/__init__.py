"""Test and benchmark problems (ported so far: the Kelley 2×2 system,
1-D and 2-D Bratu, 2-D convection–diffusion, Kelley's two-point BVP, 2-D
quasilinear diffusion, the 1-D and 2-D heat equations, the 1-D heat
equation by DG / upwind operator composition and the spring)."""

from . import (bratu1d, bratu2d, bvp, convdiff2d, heat1d, heat1d_dg, heat2d,
               nldiff2d, simple, spring)

__all__ = ["simple", "bratu1d", "bratu2d", "bvp", "heat1d", "heat2d",
           "heat1d_dg", "spring", "convdiff2d", "nldiff2d"]
