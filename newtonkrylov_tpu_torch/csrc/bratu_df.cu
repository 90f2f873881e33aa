// K7: the 2-D Bratu df32 acceptance residual in one pass (Hopper, sm_90a).
//
// No TPU kernel corresponds to this one: the JAX package's df32 arithmetic
// (newtonkrylov_tpu/df32.py) is plain jnp, which XLA fuses on the TPU.  On
// the card the same arithmetic in eager PyTorch is ~700 full-grid launches a
// call, each reading and writing whole words, and that chain was the largest
// layer of the 8192^2 solves and of the served requests (PERF.md section 5,
// bottleneck (1)).  This kernel evaluates
// problems/bratu2d.py:residual_scaled_df_padded in one launch:
//
//   s   = neighbour sum of the padded (n+2, m+2) block `up`
//         ((1,0), (-1,0), (0,1), (0,-1) in exact two-sum chains)
//   s   = s + (-4)*u                       (an exact power-of-two scale)
//   out = s + sign(c) * e^(u + ln|c|)      (df32.scaled_exp)
//
// over the (n, m) interior `u`, read as given (not as up's centre).  Every
// value is a df32 pair of float32 words (hi, lo).
//
// Arithmetic: operation for operation the eager chain of
// newtonkrylov_tpu_torch/df32.py (neighbor_sum -> add(., scale_pow2(u, -4))
// -> add(., scaled_exp(u, c))), so both words equal the plain version's bit
// for bit.  The library is built with -fmad=false and no product here is
// written as an FMA: eager CUDA a + b, a - b and a * b each round once, as
// these do.  torch.round is rintf (half to even), the int32 cast truncates
// (cvt.rzi), the clamp to +-126 and _ldexp's exponent bits are as in the
// plain version, and every constant (_SPLIT, _LN2_HI/LO, _INV_LN2,
// _FACT_INV, ln|c| as an (hi, lo) pair) is handed over by the host from
// df32.py's own values.  Denormals are kept (no -ftz), as eager PyTorch
// keeps them.
//
// Bound: 613 float32 operations an element (the Horner chain of eleven df32
// multiply-adds is most of it; the split of the reduced argument r is shared
// by its twelve products) against 24 bytes (four words read, two written;
// the neighbour reads hit in L1/L2).  At 33.5 T non-FMA float32
// operations/s and 3.35 TB/s that is ~1.23 ms of operations and ~0.48 ms of
// bytes at 8192^2: the kernel is bound by its arithmetic.  So: one thread an
// element, the whole chain unrolled in registers with no shared memory, a
// warp along a row so every word is read and written coalesced, and a 2-D
// grid of 256-thread blocks (rows by a grid-stride loop past 65535) that
// fills the 132 SMs many times over at every side the port runs.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace {

struct DF {
  float hi, lo;
};

// The host constants, in df32.py's order (see nk_bratu_residual_df).
struct Consts {
  float split;         // _SPLIT
  float inv_ln2;       // _INV_LN2
  float ln2_hi;        // _LN2_HI
  float ln2_lo;        // _LN2_LO
  float lnc_hi;        // ln|c| rounded to float32
  float lnc_lo;        // ln|c| - lnc_hi rounded to float32
  float fact[11][2];   // _FACT_INV: (hi, lo) of 1/n!, n = 2..12
};
constexpr int kNumConsts = sizeof(Consts) / sizeof(float);

__device__ __forceinline__ DF two_sum(float a, float b) {
  const float s = a + b;
  const float bb = s - a;
  return {s, (a - (s - bb)) + (b - bb)};
}

__device__ __forceinline__ DF fast_two_sum(float a, float b) {
  const float s = a + b;
  return {s, b - (s - a)};
}

__device__ __forceinline__ DF split(float a, float c_split) {
  const float c = c_split * a;
  const float hi = c - (c - a);
  return {hi, a - hi};
}

__device__ __forceinline__ DF two_prod(float a, float b, float c_split) {
  const float p = a * b;
  const DF as = split(a, c_split);
  const DF bs = split(b, c_split);
  const float e =
      (((as.hi * bs.hi - p) + as.hi * bs.lo) + as.lo * bs.hi) + as.lo * bs.lo;
  return {p, e};
}

// df32.add: double-word + double-word.
__device__ __forceinline__ DF add(DF a, DF b) {
  const DF se = two_sum(a.hi, b.hi);
  const DF tf = two_sum(a.lo, b.lo);
  const DF s = fast_two_sum(se.hi, se.lo + tf.hi);
  return fast_two_sum(s.hi, s.lo + tf.lo);
}

// df32.add_f32: double-word + float32.
__device__ __forceinline__ DF add_f32(DF a, float b) {
  const DF se = two_sum(a.hi, b);
  return fast_two_sum(se.hi, se.lo + a.lo);
}

// df32.mul: double-word x double-word.
__device__ __forceinline__ DF mul(DF a, DF b, float c_split) {
  const DF pe = two_prod(a.hi, b.hi, c_split);
  return fast_two_sum(pe.hi, pe.lo + (a.hi * b.lo + a.lo * b.hi));
}

// df32.exp: e^a by x = k ln2 + r, a degree-12 Taylor polynomial of e^r in
// df32 (Horner), and 2^k through the exponent bits.
__device__ __forceinline__ DF exp_df(DF a, const Consts& k) {
  const float x = a.hi + a.lo;
  const float kf = rintf(x * k.inv_ln2);
  int ki = __float2int_rz(kf);
  const float nk = -kf;
  const DF r = add(a, DF{nk * k.ln2_hi, nk * k.ln2_lo});
  DF acc = {k.fact[10][0], k.fact[10][1]};
#pragma unroll
  for (int i = 9; i >= 0; --i) {
    acc = add(mul(acc, r, k.split), DF{k.fact[i][0], k.fact[i][1]});
  }
  acc = add_f32(mul(acc, r, k.split), 1.0f);
  acc = mul(acc, r, k.split);
  acc = add_f32(acc, 1.0f);
  ki = min(max(ki, -126), 126);
  const float scale = __int_as_float((ki + 127) << 23);
  return {acc.hi * scale, acc.lo * scale};
}

template <bool NEGATIVE_C>
__global__ void __launch_bounds__(256)
    bratu_residual_df_kernel(const float* __restrict__ up_hi,
                             const float* __restrict__ up_lo,
                             const float* __restrict__ u_hi,
                             const float* __restrict__ u_lo,
                             float* __restrict__ out_hi,
                             float* __restrict__ out_lo, int n, int m,
                             const Consts k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const size_t P = static_cast<size_t>(m) + 2;  // the padded row's length
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t c = static_cast<size_t>(i + 1) * P + (j + 1);  // up's (i, j)
    DF s = {up_hi[c + P], up_lo[c + P]};               // shift (1, 0)
    s = add(s, DF{up_hi[c - P], up_lo[c - P]});        // shift (-1, 0)
    s = add(s, DF{up_hi[c + 1], up_lo[c + 1]});        // shift (0, 1)
    s = add(s, DF{up_hi[c - 1], up_lo[c - 1]});        // shift (0, -1)
    const size_t o = static_cast<size_t>(i) * m + j;
    const DF u = {u_hi[o], u_lo[o]};
    s = add(s, DF{-4.0f * u.hi, -4.0f * u.lo});
    DF e = exp_df(add(u, DF{k.lnc_hi, k.lnc_lo}), k);
    if (NEGATIVE_C) e = DF{-e.hi, -e.lo};
    s = add(s, e);
    out_hi[o] = s.hi;
    out_lo[o] = s.lo;
  }
}

}  // namespace

// K7: (out_hi, out_lo) = the df32 Bratu residual of the (n, m) interior
// (u_hi, u_lo) with its ghost-padded (n+2, m+2) block (up_hi, up_lo); all
// row-major float32 on the device.  `consts` is a host array of `n_consts`
// floats laid out as Consts; `negative_c` is c < 0.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a bad argument).
extern "C" int nk_bratu_residual_df(const void* up_hi, const void* up_lo,
                                    const void* u_hi, const void* u_lo,
                                    void* out_hi, void* out_lo, int n, int m,
                                    const float* consts, int n_consts,
                                    int negative_c, void* stream) {
  if (n < 1 || m < 1 || n_consts != kNumConsts || consts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Consts k;
  std::memcpy(&k, consts, sizeof(Consts));
  const dim3 block(256, 1);
  const dim3 grid((m + block.x - 1) / block.x, n < 65535 ? n : 65535);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(up_hi);
  const float* b = static_cast<const float*>(up_lo);
  const float* c = static_cast<const float*>(u_hi);
  const float* d = static_cast<const float*>(u_lo);
  float* oh = static_cast<float*>(out_hi);
  float* ol = static_cast<float*>(out_lo);
  if (negative_c) {
    bratu_residual_df_kernel<true><<<grid, block, 0, s>>>(a, b, c, d, oh, ol,
                                                          n, m, k);
  } else {
    bratu_residual_df_kernel<false><<<grid, block, 0, s>>>(a, b, c, d, oh, ol,
                                                           n, m, k);
  }
  return static_cast<int>(cudaGetLastError());
}
