"""Hand-written CUDA kernels for the hot operators.

* :mod:`stencil2d` — on the aligned ghost layout, the fused 5-point stencil
  JVP (K1) and the Bratu residual (K2), CUDA C++ in ``csrc/stencil2d.cu``,
  and the chained kernels — k stencil matvecs (K3), the Chebyshev apply (K4)
  and the speed-of-light probe (K5) — in ``csrc/chain2d.cu``.
"""

from . import stencil2d

__all__ = ["stencil2d"]
