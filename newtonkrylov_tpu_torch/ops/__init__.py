"""Plain tensor operators (stencils)."""

from .stencil import laplacian_2d, pad_dirichlet

__all__ = ["pad_dirichlet", "laplacian_2d"]
