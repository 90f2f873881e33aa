// Host-side sparse kernels for newtonkrylov_tpu_torch.
//
// ILU(0) factorization + sparse triangular solves on CSR matrices — the
// native runtime piece behind newtonkrylov_tpu_torch.precond.ilu0, the
// analogue of the reference's `N = (J) -> ilu(collect(J))` recipe
// (reference examples/bratu.jl:121-138, KrylovPreconditioners.jl ilu).
// ILU is inherently sequential, which is why it runs on the host CPU in C++
// rather than on the card; the on-card alternatives (nested Krylov, banded
// direct) live in precond.py.  A copy of the JAX package's csrc/ilu0.cpp.
//
// Exposed via a plain C ABI for ctypes.
//
// Build: at first use, by newtonkrylov_tpu_torch/kernels/build.py
// (g++ -O3 -fPIC -std=c++17 -ffp-contract=off -shared) into the package's
// _build/ directory.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// In-place ILU(0), IKJ ordering. CSR arrays: indptr (n+1), cols (nnz),
// vals (nnz, modified in place). diag_out (n) receives the position of the
// diagonal entry of each row. Column indices must be sorted per row and the
// diagonal must be present. Returns 0 on success, i+1 if row i has a zero
// pivot or missing diagonal.
int64_t nk_ilu0_factorize(int64_t n, const int64_t* indptr, const int64_t* cols,
                          double* vals, int64_t* diag_out) {
    // Locate diagonals.
    for (int64_t i = 0; i < n; ++i) {
        int64_t d = -1;
        for (int64_t jj = indptr[i]; jj < indptr[i + 1]; ++jj) {
            if (cols[jj] == i) { d = jj; break; }
        }
        if (d < 0) return i + 1;
        diag_out[i] = d;
    }

    // Scatter workspace: column -> position in the current row.
    std::vector<int64_t> pos(n, -1);

    for (int64_t i = 1; i < n; ++i) {
        for (int64_t jj = indptr[i]; jj < indptr[i + 1]; ++jj) pos[cols[jj]] = jj;

        for (int64_t kk = indptr[i]; kk < indptr[i + 1]; ++kk) {
            int64_t k = cols[kk];
            if (k >= i) break;
            double piv = vals[diag_out[k]];
            if (piv == 0.0) { // zero pivot
                for (int64_t jj = indptr[i]; jj < indptr[i + 1]; ++jj) pos[cols[jj]] = -1;
                return i + 1;
            }
            double lik = vals[kk] / piv;
            vals[kk] = lik;
            for (int64_t jj = diag_out[k] + 1; jj < indptr[k + 1]; ++jj) {
                int64_t p = pos[cols[jj]];
                if (p >= 0) vals[p] -= lik * vals[jj];
            }
        }

        for (int64_t jj = indptr[i]; jj < indptr[i + 1]; ++jj) pos[cols[jj]] = -1;
    }
    return 0;
}

// Solve L U x = b with the factors packed in CSR (unit lower / upper).
// x may alias b.
void nk_ilu0_solve(int64_t n, const int64_t* indptr, const int64_t* cols,
                   const double* vals, const int64_t* diag, const double* b,
                   double* x) {
    if (x != b) std::memcpy(x, b, sizeof(double) * n);
    // Forward: L y = b (unit diagonal).
    for (int64_t i = 0; i < n; ++i) {
        double s = x[i];
        for (int64_t jj = indptr[i]; jj < diag[i]; ++jj) s -= vals[jj] * x[cols[jj]];
        x[i] = s;
    }
    // Backward: U x = y.
    for (int64_t i = n - 1; i >= 0; --i) {
        double s = x[i];
        for (int64_t jj = diag[i] + 1; jj < indptr[i + 1]; ++jj) s -= vals[jj] * x[cols[jj]];
        x[i] = s / vals[diag[i]];
    }
}

// Batched solve for multiple right-hand sides (column-major b: n x m).
void nk_ilu0_solve_batch(int64_t n, int64_t m, const int64_t* indptr,
                         const int64_t* cols, const double* vals,
                         const int64_t* diag, const double* b, double* x) {
    for (int64_t j = 0; j < m; ++j) {
        nk_ilu0_solve(n, indptr, cols, vals, diag, b + j * n, x + j * n);
    }
}

// CSR matvec (used for host-side residual checks of the factorization).
void nk_csr_matvec(int64_t n, const int64_t* indptr, const int64_t* cols,
                   const double* vals, const double* v, double* out) {
    for (int64_t i = 0; i < n; ++i) {
        double s = 0.0;
        for (int64_t jj = indptr[i]; jj < indptr[i + 1]; ++jj) s += vals[jj] * v[cols[jj]];
        out[i] = s;
    }
}

}  // extern "C"
