"""K4's share of its roofline, %: the larger of the byte and operation
bounds of one Chebyshev apply (``nkbench.roofline.chebyshev_apply``) over
K4's device time by kernel name in the window's trace, divided by its
calls (``kernels.stencil2d.LAUNCHES``)."""
from nkbench import readers


def read(run):
    return readers.k4_roofline(run)
