"""Hand-written CUDA kernels for the hot operators.

* :mod:`stencil2d` — the fused 5-point stencil JVP (K1) and the Bratu
  residual (K2) on the aligned ghost layout, CUDA C++ in ``csrc/``.
"""

from . import stencil2d

__all__ = ["stencil2d"]
