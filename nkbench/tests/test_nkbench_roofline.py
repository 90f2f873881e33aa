"""The frozen roofline counts, checked against a count of the operations
of the K4 recurrence as written, at small sides."""
import numpy as np
import pytest

from nkbench import roofline


class Counted:
    """An array that counts the element operations done on it."""
    ops = 0

    def __init__(self, a):
        self.a = np.asarray(a, dtype=np.float32)

    def _op(self, other, f):
        b = other.a if isinstance(other, Counted) else other
        Counted.ops += self.a.size
        return Counted(f(self.a, b))

    def __add__(self, o):
        return self._op(o, np.add)

    def __sub__(self, o):
        return self._op(o, np.subtract)

    def __mul__(self, o):
        return self._op(o, np.multiply)

    __radd__, __rmul__ = __add__, __mul__


def k4_recurrence(r, diag, n, degree, theta=3.0, delta=1.0, o=0.5):
    """K4's per-cell arithmetic on the interior (csrc/chain2d.cu)."""
    def nb(x, di, dj):
        p = np.pad(x.a, 1)
        return Counted(p[1 + di:1 + di + n, 1 + dj:1 + dj + n])

    sigma1 = theta / delta
    rho = 1.0 / sigma1
    d = r * (1.0 / theta)
    x = d
    for _ in range(degree):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        c_d, c_r = rho_new * rho, 2.0 * rho_new / delta
        r = r - (((((nb(d, -1, 0) + nb(d, 1, 0)) + nb(d, 0, -1))
                   + nb(d, 0, 1)) + diag * d) * o)
        d = d * c_d + r * c_r
        x = x + d
        rho = rho_new
    return x


@pytest.mark.parametrize("n,degree", [(8, 1), (8, 8), (16, 3), (24, 16)])
def test_k4_counts(n, degree):
    rng = np.random.default_rng(n + degree)
    Counted.ops = 0
    k4_recurrence(Counted(rng.random((n, n))), Counted(rng.random((n, n))),
                  n, degree)
    b = roofline.chebyshev_apply(n, degree)
    assert b.flops == Counted.ops
    assert b.bytes == 3 * n * n * 4  # r and diag read, x written, f32


def test_bound_takes_the_larger_and_names_it():
    b = roofline.bound(67e12, 1.0)
    assert (b.seconds, b.bound_by) == (1.0, "operations")
    b = roofline.bound(1.0, 3.35e12)
    assert (b.seconds, b.bound_by) == (1.0, "bytes")
    # K4 at 8192² degree 8 moves more than it computes
    b = roofline.chebyshev_apply(8192, 8)
    assert b.bound_by == "bytes"
    assert roofline.share_pct(b, 2 * b.seconds) == pytest.approx(50.0)
