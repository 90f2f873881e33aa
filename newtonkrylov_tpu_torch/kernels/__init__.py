"""Hand-written CUDA kernels for the hot operators.

* :mod:`stencil2d` — on the aligned ghost layout, the fused 5-point stencil
  JVP (K1) and the Bratu residual (K2), CUDA C++ in ``csrc/stencil2d.cu``,
  and the chained kernels — k stencil matvecs (K3), the Chebyshev apply (K4)
  and the speed-of-light probe (K5) — in ``csrc/chain2d.cu``.
* :mod:`probe` — the chained-step cost probe (K6): k dependent steps of a
  multiply chain, a shift chain or a stencil formulation in one launch,
  CUDA C++ in ``csrc/chain_probe.cu``.
"""

from . import probe, stencil2d

__all__ = ["probe", "stencil2d"]
