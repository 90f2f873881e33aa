"""ctypes binding of the host ILU(0) library (``csrc/ilu0.cpp``).

Counterpart of ``newtonkrylov_tpu/utils/native.py``.  The library is host
C++, built with the host compiler at first use into the package's
``_build/`` (:func:`~newtonkrylov_tpu_torch.kernels.build.load`).  A build
that fails raises with the compiler's output: nothing falls back to the
NumPy version (``precond._ilu0_numpy``), which is the plain version the
tests hold this one against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..kernels import build

__all__ = ["NativeILU", "load_ilu"]


class NativeILU:
    """``nk_ilu0_factorize`` and ``nk_ilu0_solve`` on float64 CSR arrays."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.nk_ilu0_factorize.restype = ctypes.c_int64
        lib.nk_ilu0_factorize.argtypes = [ctypes.c_int64, i64p, i64p, f64p, i64p]
        lib.nk_ilu0_solve.restype = None
        lib.nk_ilu0_solve.argtypes = [ctypes.c_int64, i64p, i64p, f64p, i64p,
                                      f64p, f64p]

    @staticmethod
    def _p(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    @staticmethod
    def _csr(indptr, cols):
        indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        cols = np.ascontiguousarray(cols, dtype=np.int64)
        n = len(indptr) - 1
        if n < 0 or indptr[0] != 0 or indptr[-1] != len(cols) or (
                len(cols) and (cols.min() < 0 or cols.max() >= n)):
            raise ValueError("ILU(0): malformed CSR arrays")
        return indptr, cols, n

    def factorize(self, indptr, cols, vals):
        """(factored values, diagonal positions); raises on a zero pivot or
        a missing diagonal.  Column indices must be sorted per row."""
        indptr, cols, n = self._csr(indptr, cols)
        vals = np.array(vals, dtype=np.float64)  # a copy, factorized in place
        if len(vals) != len(cols):
            raise ValueError("ILU(0): vals and cols differ in length")
        diag = np.zeros(n, dtype=np.int64)
        rc = self._lib.nk_ilu0_factorize(
            n, self._p(indptr, ctypes.c_int64), self._p(cols, ctypes.c_int64),
            self._p(vals, ctypes.c_double), self._p(diag, ctypes.c_int64))
        if rc != 0:
            raise ZeroDivisionError(
                f"ILU(0): zero pivot or missing diagonal at row {rc - 1}")
        return vals, diag

    def solve(self, indptr, cols, vals, diag, b):
        """x = (LU)⁻¹ b with the factors of :meth:`factorize`."""
        indptr, cols, n = self._csr(indptr, cols)
        vals = np.ascontiguousarray(vals, dtype=np.float64)
        diag = np.ascontiguousarray(diag, dtype=np.int64)
        b = np.ascontiguousarray(b, dtype=np.float64)
        if len(vals) != len(cols) or len(diag) != n or len(b) != n:
            raise ValueError("ILU(0): factor or right-hand side of wrong size")
        x = np.zeros_like(b)
        self._lib.nk_ilu0_solve(
            n, self._p(indptr, ctypes.c_int64), self._p(cols, ctypes.c_int64),
            self._p(vals, ctypes.c_double), self._p(diag, ctypes.c_int64),
            self._p(b, ctypes.c_double), self._p(x, ctypes.c_double))
        return x


def load_ilu() -> NativeILU:
    """The native ILU(0) library, built on first use; raises if the build
    fails."""
    return NativeILU(build.load("ilu0"))
