// Fused 5-point stencil kernels on the aligned ghost layout (Hopper, sm_90a).
//
// Replaces two TPU kernels of newtonkrylov_tpu/kernels/stencil2d.py, both
// bodies of `_stencil_kernel` reached through `_call_stencil`:
//   K1  stencil_jvp_pallas     (nonlinear=False): out = lap(v) + w*v
//   K2  bratu_residual_pallas  (nonlinear=True):  out = lap(u) + scale*exp(u)
// with lap(v) = v[i-1,j] + v[i+1,j] + v[i,j-1] + v[i,j+1] - 4 v[i,j].
//
// Layout: arrays are (R, C) row-major with R = n + 8 and
// C = round_up(n + 2, 128).  Interior row i lives at array row i (i < n),
// interior column j at array column j + 1; column 0, columns [n+1, C) and the
// bottom apron rows [n, n+8) are ghosts.  Every output element outside the
// interior is written as exactly 0, so the output is again a valid
// ghost-carrying array.  The top ghost row is an implicit zero; the bottom
// neighbour of row n-1 is read from apron row n, which the layout invariant
// keeps zero (as the Pallas kernel's look-ahead block reads it).
//
// Cost: both kernels are bound by memory bandwidth, not arithmetic.  Per
// output element K1 reads v and w and writes out (about 3 arrays of traffic;
// the four neighbour reads of v hit in L1/L2), K2 reads u and writes out
// (about 2 arrays).  The Pallas kernel's row tiles, DMA semaphores and 8-row
// look-ahead exist for the TPU's (8, 128) tiling and are dropped: one thread
// per output element on a 2-D grid whose x axis runs along C, so a warp
// loads 32 consecutive elements of a row.
//
// Arithmetic order follows stencil2d.py:165-169,
//   ((((up + dn) + left) + right) - 4 v) + w v,
// and the library is compiled with -fmad=false, so no product is contracted
// into an FMA: K1 equals the plain PyTorch version bit for bit.  K2's exp is
// the CUDA math library's (expf / exp), which may differ from PyTorch's in
// the last bits.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T, bool NONLINEAR>
__global__ void stencil2d_kernel(const T* __restrict__ v,
                                 const T* __restrict__ w,
                                 T* __restrict__ out, int R, int C, int n,
                                 T scale) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= R || j >= C) return;
  const size_t idx = static_cast<size_t>(i) * C + j;
  if (i >= n || j < 1 || j > n) {
    out[idx] = T(0);
    return;
  }
  const T c = v[idx];
  const T up = i > 0 ? v[idx - C] : T(0);
  const T dn = v[idx + C];
  const T left = v[idx - 1];
  const T right = v[idx + 1];
  const T lap = (((up + dn) + left) + right) - T(4) * c;
  if constexpr (NONLINEAR) {
    out[idx] = lap + scale * exp_t(c);
  } else {
    out[idx] = lap + w[idx] * c;
  }
}

template <typename T, bool NONLINEAR>
int launch(const void* v, const void* w, void* out, int R, int C, int n,
           double scale, void* stream) {
  const dim3 block(128, 4);
  const dim3 grid((C + block.x - 1) / block.x, (R + block.y - 1) / block.y);
  stencil2d_kernel<T, NONLINEAR><<<grid, block, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<T*>(out), R, C, n, static_cast<T>(scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: out = lap(v) + w*v.  Returns the cudaError_t of the launch.
extern "C" int nk_stencil_jvp(const void* v, const void* w, void* out, int R,
                              int C, int n, int is_double, void* stream) {
  return is_double ? launch<double, false>(v, w, out, R, C, n, 0.0, stream)
                   : launch<float, false>(v, w, out, R, C, n, 0.0, stream);
}

// K2: out = lap(u) + scale*exp(u).  Returns the cudaError_t of the launch.
extern "C" int nk_bratu_residual(const void* u, void* out, int R, int C,
                                 int n, double scale, int is_double,
                                 void* stream) {
  return is_double
             ? launch<double, true>(u, nullptr, out, R, C, n, scale, stream)
             : launch<float, true>(u, nullptr, out, R, C, n, scale, stream);
}
