// Chained 5-point stencil kernels on the aligned ghost layout (Hopper, sm_90a).
//
// Replaces three TPU kernels of newtonkrylov_tpu/kernels/stencil2d.py, each
// of which runs k dependent 5-point steps in one launch with its state
// resident in VMEM:
//   K3  stencil_jvp_chain_pallas    (body _chain_kernel)
//   K4  chebyshev_apply_pallas      (body _cheb_kernel)
//   K5  stencil_chain_probe_pallas  (body _chain_probe_kernel)
//
// Layout: as csrc/stencil2d.cu, (R, C) row-major with R = n + 8 and
// C = round_up(n + 2, 128); the interior is rows [0, n), columns [1, n].
// Neighbours wrap around the whole (R, C) array, as pltpu.roll and torch.roll
// do: the up neighbour of row 0 is apron row R - 1.
//
// Design.  Each step reads neighbours that the previous step wrote, so the
// steps depend on each other across the whole grid.  A 2048^2 f32 array
// (17.9 MB) is far larger than the 227 KB of shared memory of an SM, so the
// state stays in device memory (much of it in the 50 MB L2), and one
// cooperative persistent kernel runs every step of a call: the grid holds as
// many blocks as the SMs run at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// times the SM count, capped by the element count), it is launched with
// cudaLaunchCooperativeKernel, each step walks the elements grid-stride, and
// cooperative_groups::this_grid().sync() separates the steps.  A launch the
// device refuses returns its error to the caller, which raises; there is no
// fallback.
//
// No buffer is written while another thread of the same step may still read
// its neighbours:
//   * K3 and K5 ping-pong between the output and one scratch buffer, the
//     parity chosen so that the last step lands in the output;
//   * K4 keeps two d buffers, reading one and writing the other, so one grid
//     sync per step suffices; r and x are read and written only at a thread's
//     own elements and are updated in place (r in a scratch copy: the
//     caller's r is not modified).
// Buffers written inside the kernel are read with plain loads, never through
// the read-only cache: other blocks wrote them before the last grid sync.
//
// Cost.  The least time of a call is set by its arithmetic for K3 and K5 at
// k in the hundreds (5 to 6 operations per element and step) and by its bytes
// for K4 (r, diag read and x written once).  This first design moves far more
// than that: per step K3 and K5 read x and w and write x (3 arrays; the
// neighbour reads of x mostly hit L1/L2), K4 reads d, diag, r, x and writes
// r, d, x (7 arrays).  Keeping the state on chip is later work.
//
// Arithmetic follows the Pallas bodies operation for operation in the array
// dtype, and the library is built with -fmad=false, so each kernel equals its
// plain PyTorch version (kernels/stencil2d.py, *_xla) bit for bit:
//   K3  w4 = w - 4;  raw(x) = (((up + dn) + left) + right) + w4*x;  each
//       double step scaled (1, s*s) with s*s rounded in the dtype; an odd k
//       ends with raw(x)*s; every step writes the interior and 0 elsewhere.
//   K5  raw(x) = ((up + dn) + (left + right)) + w4*x on every element, no
//       mask; each double step scaled by 1/64; k even.
//   K4  sigma1 = theta/delta, rho = 1/sigma1, d = r*(1/theta), x = d; then
//       degree times: r = r - mask*o*((((up + dn) + left) + right) + diag*d);
//       rho' = 1/(2 sigma1 - rho); d = (rho' rho) d + (2 rho'/delta) r;
//       x = x + d.  theta, delta and o are read from a device 3-vector by
//       every thread, which runs the rho recurrence in registers: an apply
//       needs no host round trip.

#include "cooperative.cuh"

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

using nk::cooperative_launch;
using nk::interior;
using nk::kThreads;
using nk::neighbours;
using nk::Neighbours;

// K3 (PROBE = false) and K5 (PROBE = true): k steps from x = v.  The second
// step of each double step is scaled by s2, the last step of an odd k by s.
template <typename T, bool PROBE>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const T* v, const T* __restrict__ w, T* out, T* scratch,
                 int R, int C, int n, int k, T s, T s2) {
  cg::grid_group grid = cg::this_grid();
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int total = R * C;
  if (k == 0) {
    for (int idx = first; idx < total; idx += stride) out[idx] = v[idx];
    return;
  }
  const T* src = v;
  for (int t = 1; t <= k; ++t) {
    T* dst = (k - t) % 2 == 0 ? out : scratch;
    const int scaled = t % 2 == 0 ? 2 : (t == k ? 1 : 0);
    for (int idx = first; idx < total; idx += stride) {
      const int i = idx / C;
      const int j = idx - i * C;
      T val = T(0);
      if (PROBE || interior(i, j, n)) {
        const Neighbours<T> nb = neighbours(src, idx, i, j, R, C);
        const T w4 = w[idx] - T(4);
        const T x = src[idx];
        const T raw = PROBE ? ((nb.up + nb.dn) + (nb.left + nb.right)) + w4 * x
                            : (((nb.up + nb.dn) + nb.left) + nb.right) + w4 * x;
        val = scaled == 2 ? raw * s2 : (scaled == 1 ? raw * s : raw);
      }
      dst[idx] = val;
    }
    src = dst;
    if (t < k) grid.sync();
  }
}

// K4: x = p_degree(A) r.  r_work, d0 and d1 are scratch of the array's size.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cheb_kernel(const T* __restrict__ r_in, const T* __restrict__ diag,
                const T* __restrict__ scal, T* x, T* r, T* d0, T* d1, int R,
                int C, int n, int degree) {
  cg::grid_group grid = cg::this_grid();
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int total = R * C;
  const T theta = scal[0];
  const T delta = scal[1];
  const T o = scal[2];
  const T sigma1 = theta / delta;
  const T inv_theta = T(1) / theta;
  T rho = T(1) / sigma1;
  for (int idx = first; idx < total; idx += stride) {
    const T ri = r_in[idx];
    const T d = ri * inv_theta;
    r[idx] = ri;
    d0[idx] = d;
    x[idx] = d;
  }
  T* d_cur = d0;
  T* d_next = d1;
  for (int t = 0; t < degree; ++t) {
    grid.sync();
    const T rho_new = T(1) / (T(2) * sigma1 - rho);
    const T c_d = rho_new * rho;
    const T c_r = T(2) * rho_new / delta;
    for (int idx = first; idx < total; idx += stride) {
      const int i = idx / C;
      const int j = idx - i * C;
      const T d = d_cur[idx];
      T rr = r[idx];
      if (interior(i, j, n)) {
        const Neighbours<T> nb = neighbours(d_cur, idx, i, j, R, C);
        rr = rr - o * ((((nb.up + nb.dn) + nb.left) + nb.right) + diag[idx] * d);
      }
      r[idx] = rr;
      const T d_new = c_d * d + c_r * rr;
      d_next[idx] = d_new;
      x[idx] = x[idx] + d_new;
    }
    T* tmp = d_cur;
    d_cur = d_next;
    d_next = tmp;
    rho = rho_new;
  }
}

template <typename T, bool PROBE>
int launch_chain(const void* v, const void* w, void* out, void* scratch, int R,
                 int C, int n, int k, T s, T s2, void* stream) {
  const T* v_t = static_cast<const T*>(v);
  const T* w_t = static_cast<const T*>(w);
  T* out_t = static_cast<T*>(out);
  T* scratch_t = static_cast<T*>(scratch);
  void* args[] = {&v_t, &w_t, &out_t, &scratch_t, &R, &C, &n, &k, &s, &s2};
  return cooperative_launch(chain_kernel<T, PROBE>, args, R, C, stream);
}

template <typename T>
int launch_cheb(const void* r, const void* diag, const void* scal, void* x,
                void* r_work, void* d0, void* d1, int R, int C, int n,
                int degree, void* stream) {
  const T* r_t = static_cast<const T*>(r);
  const T* diag_t = static_cast<const T*>(diag);
  const T* scal_t = static_cast<const T*>(scal);
  T* x_t = static_cast<T*>(x);
  T* r_work_t = static_cast<T*>(r_work);
  T* d0_t = static_cast<T*>(d0);
  T* d1_t = static_cast<T*>(d1);
  void* args[] = {&r_t, &diag_t, &scal_t, &x_t, &r_work_t, &d0_t, &d1_t,
                  &R, &C, &n, &degree};
  return cooperative_launch(cheb_kernel<T>, args, R, C, stream);
}

template <typename T>
int launch_k3(const void* v, const void* w, void* out, void* scratch, int R,
              int C, int n, int k, double scale, void* stream) {
  const T s = static_cast<T>(scale);
  const T s2 = s * s;  // rounded in T, as the Pallas kernel's s * s
  return launch_chain<T, false>(v, w, out, scratch, R, C, n, k, s, s2, stream);
}

}  // namespace

// K3: out = k chained steps x <- mask*(lap x + w x) from x = v, scaled (1, s^2)
// per double step.  Returns the cudaError_t of the launch.
extern "C" int nk_stencil_jvp_chain(const void* v, const void* w, void* out,
                                    void* scratch, int R, int C, int n, int k,
                                    double scale, int is_double,
                                    void* stream) {
  return is_double
             ? launch_k3<double>(v, w, out, scratch, R, C, n, k, scale, stream)
             : launch_k3<float>(v, w, out, scratch, R, C, n, k, scale, stream);
}

// K5: out = k unmasked probe steps from x = v (k even).  Returns the
// cudaError_t of the launch.
extern "C" int nk_stencil_chain_probe(const void* v, const void* w, void* out,
                                      void* scratch, int R, int C, int n,
                                      int k, int is_double, void* stream) {
  return is_double ? launch_chain<double, true>(v, w, out, scratch, R, C, n, k,
                                                1.0, 1.0 / 64.0, stream)
                   : launch_chain<float, true>(v, w, out, scratch, R, C, n, k,
                                               1.0f, 1.0f / 64.0f, stream);
}

// K4: x = p_degree(A) r with scal = [theta, delta, o] on the device.  Returns
// the cudaError_t of the launch.
extern "C" int nk_chebyshev_apply(const void* r, const void* diag,
                                  const void* scal, void* x, void* r_work,
                                  void* d0, void* d1, int R, int C, int n,
                                  int degree, int is_double, void* stream) {
  return is_double ? launch_cheb<double>(r, diag, scal, x, r_work, d0, d1, R,
                                         C, n, degree, stream)
                   : launch_cheb<float>(r, diag, scal, x, r_work, d0, d1, R, C,
                                        n, degree, stream);
}
