"""Plain tensor operators: stencils, and the summation-by-parts and DG
derivative matrices (:mod:`.sbp`)."""

from .stencil import laplacian_1d, laplacian_2d, pad_dirichlet, pad_periodic

__all__ = ["pad_dirichlet", "pad_periodic", "laplacian_1d", "laplacian_2d"]
