// The chained-step cost probe K6 on the aligned layout (Hopper, sm_90a).
//
// Replaces the TPU kernel _chain_call of benchmarks/kernel_probe.py: k
// dependent steps of one probe step in a single launch, to price each
// ingredient of a chained stencil per step.  The steps (kernels/probe.py
// names them, in the order of STEPS there):
//   muls(n)              x <- x*c_0*...*c_(n-1), c_i = f32(0.999 + 1e-4 i)
//   roll_chain(axis, r)  r times: x <- roll(x, +1 / -1 alternating) * 0.9999
//   cur_build            where(mask, ((((up+dn)+left)+right) + (w-4)x) * 1/8, 0)
//   opt_build            masks * (((up+dn)+(left+right)) + (w-4)x)
//   noroll_build         the same with up, dn, left, right = x*1.0001,
//                        x*0.9999, x*1.0002, x*0.9998 (no neighbour read)
//   min_build            masks*((up+dn)+(left+right)) + (masks*(w-4))x
// with mask = (row < n) & (1 <= col <= n), masks = f32(mask)*0.125, and n the
// interior size (R - 8).  Neighbours and rolls wrap around the whole (R, C)
// array as pltpu.roll does.  Every constant is the float32 the JAX probe
// rounds it to, and the library is built with -fmad=false, so the kernel
// equals its plain PyTorch version (kernels/probe.py, chain_call_xla) bit for
// bit.
//
// Design.  The skeleton of csrc/chain2d.cu (cooperative.cuh): one cooperative
// persistent launch per call, grid-stride loops, k a runtime argument as the
// JAX probe keeps it in SMEM.  The kernel is templated on the step, one
// instantiation per step; the two state disciplines of the TPU probe map so:
//   * ping-pong: the steps alternate between the output and one scratch
//     buffer, one grid sync per step; 2*unroll*floor(k / (2*unroll)) steps,
//     the JAX body loop's count;
//   * carry (the fori_loop carried value), for a step that reads only its own
//     element (muls, noroll_build): the value stays in a register for all k
//     steps and is stored once, with no grid sync;
//   * carry, for a step that reads neighbours (rolls, stencils): each step
//     writes the scratch buffer, syncs the grid, copies the scratch buffer
//     back to the output and syncs again: the loop-carry copy the JAX probe
//     measures.
// So a step's carry time less its ping-pong time is the price of one copy
// and one grid sync, and the muls ping-pong time less their carry time the
// price of a step through memory.  A roll is an address computation here:
// each roll of a chain moves the source index one place (with wrap-around),
// and the step reads the element the chain lands on once.
//
// Cost.  A step through memory reads the state and w and writes the state:
// at 1024^2 (a 1032 x 1152 f32 array, 4.76 MB, resident in the 50 MB L2) the
// bytes are the state's own; a register-carried step costs its multiplies.
// K6 is a measuring instrument: its speed is not a target.

#include "cooperative.cuh"

namespace cg = cooperative_groups;

namespace {

using nk::kThreads;

struct Geo {
  int R, C, n;
};

// f32(0.999 + 1e-4 * c), as jnp.asarray(..., float32) rounds it
__device__ __forceinline__ float mul_const(int c) {
  switch (c) {
    case 0: return 0x1.ff7ceep-1f;
    case 1: return 0x1.ff8a0ap-1f;
    case 2: return 0x1.ff9724p-1f;
    case 3: return 0x1.ffa44p-1f;
    case 4: return 0x1.ffb15cp-1f;
    case 5: return 0x1.ffbe76p-1f;
    case 6: return 0x1.ffcb92p-1f;
    default: return 0x1.ffd8aep-1f;
  }
}

constexpr float kRollMul = 0x1.fff2e4p-1f;  // f32(0.9999)
constexpr float kUp = 0x1.00068ep+0f;       // f32(1.0001)
constexpr float kDn = 0x1.fff2e4p-1f;       // f32(0.9999)
constexpr float kLeft = 0x1.000d1cp+0f;     // f32(1.0002)
constexpr float kRight = 0x1.ffe5cap-1f;    // f32(0.9998)
constexpr float kScale = 0.125f;

// Each step: kOwn (reads only its own element, so a carried value may stay in
// a register), own(x, w, i, j) for such a step, and at(src, w, idx, i, j) for
// one step from buffer src.

template <int NOPS>
struct Muls {
  static constexpr bool kOwn = true;
  __device__ static float own(float x, float, int, int, const Geo&) {
#pragma unroll
    for (int c = 0; c < NOPS; ++c) x = x * mul_const(c);
    return x;
  }
  __device__ static float at(const float* src, const float* w, int idx, int i,
                             int j, const Geo& g) {
    return own(src[idx], 0.f, i, j, g);
  }
};

template <int AXIS, int NROLLS>
struct RollChain {
  static constexpr bool kOwn = false;
  __device__ static float at(const float* src, const float*, int, int i,
                             int j, const Geo& g) {
    // roll r shifts by +1 (r even) or by dim - 1 (r odd): its output at p
    // reads its input at p - 1 or p + 1; undo the rolls from the last
    int p = AXIS == 0 ? i : j;
    const int dim = AXIS == 0 ? g.R : g.C;
#pragma unroll
    for (int r = NROLLS - 1; r >= 0; --r)
      p = r % 2 == 0 ? (p > 0 ? p - 1 : dim - 1) : (p < dim - 1 ? p + 1 : 0);
    float x = AXIS == 0 ? src[p * g.C + j] : src[i * g.C + p];
#pragma unroll
    for (int r = 0; r < NROLLS; ++r) x = x * kRollMul;
    return x;
  }
};

struct CurBuild {
  static constexpr bool kOwn = false;
  __device__ static float at(const float* src, const float* w, int idx, int i,
                             int j, const Geo& g) {
    const nk::Neighbours<float> nb = nk::neighbours(src, idx, i, j, g.R, g.C);
    const float out =
        (((nb.up + nb.dn) + nb.left) + nb.right) + (w[idx] - 4.f) * src[idx];
    return nk::interior(i, j, g.n) ? out * kScale : 0.f;
  }
};

struct OptBuild {
  static constexpr bool kOwn = false;
  __device__ static float at(const float* src, const float* w, int idx, int i,
                             int j, const Geo& g) {
    const float masks = (nk::interior(i, j, g.n) ? 1.f : 0.f) * kScale;
    const float wm4 = w[idx] - 4.f;
    const nk::Neighbours<float> nb = nk::neighbours(src, idx, i, j, g.R, g.C);
    return masks * (((nb.up + nb.dn) + (nb.left + nb.right)) + wm4 * src[idx]);
  }
};

struct NorollBuild {
  static constexpr bool kOwn = true;
  __device__ static float own(float x, float w, int i, int j, const Geo& g) {
    const float masks = (nk::interior(i, j, g.n) ? 1.f : 0.f) * kScale;
    const float wm4 = w - 4.f;
    const float up = x * kUp, dn = x * kDn, left = x * kLeft, right = x * kRight;
    return masks * (((up + dn) + (left + right)) + wm4 * x);
  }
  __device__ static float at(const float* src, const float* w, int idx, int i,
                             int j, const Geo& g) {
    return own(src[idx], w[idx], i, j, g);
  }
};

struct MinBuild {
  static constexpr bool kOwn = false;
  __device__ static float at(const float* src, const float* w, int idx, int i,
                             int j, const Geo& g) {
    const float masks = (nk::interior(i, j, g.n) ? 1.f : 0.f) * kScale;
    const float wm4s = masks * (w[idx] - 4.f);
    const nk::Neighbours<float> nb = nk::neighbours(src, idx, i, j, g.R, g.C);
    return masks * ((nb.up + nb.dn) + (nb.left + nb.right)) + wm4s * src[idx];
  }
};

// One step over the whole array, src -> dst.
template <typename Step>
__device__ __forceinline__ void sweep(const float* src,
                                      const float* __restrict__ w, float* dst,
                                      int first, int stride, const Geo& g) {
  const int total = g.R * g.C;
  for (int idx = first; idx < total; idx += stride) {
    const int i = idx / g.C;
    dst[idx] = Step::at(src, w, idx, i, idx - i * g.C, g);
  }
}

template <typename Step>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const float* __restrict__ v, const float* __restrict__ w,
                 float* out, float* scratch, int R, int C, int n, int k,
                 int pingpong, int unroll) {
  cg::grid_group grid = cg::this_grid();
  const Geo g{R, C, n};
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int total = R * C;
  if constexpr (Step::kOwn) {
    if (!pingpong) {  // the carried value stays in a register
      for (int idx = first; idx < total; idx += stride) {
        const int i = idx / C;
        const int j = idx - i * C;
        const float wv = w[idx];
        float x = v[idx];
        for (int t = 0; t < k; ++t) x = Step::own(x, wv, i, j, g);
        out[idx] = x;
      }
      return;
    }
  }
  for (int idx = first; idx < total; idx += stride) out[idx] = v[idx];
  if (pingpong) {
    const int bodies = k / (2 * unroll);
    for (int b = 0; b < bodies; ++b) {
      for (int u = 0; u < unroll; ++u) {
        grid.sync();
        sweep<Step>(out, w, scratch, first, stride, g);
        grid.sync();
        sweep<Step>(scratch, w, out, first, stride, g);
      }
    }
  } else {  // carried through memory: step into scratch, copy back
    for (int t = 0; t < k; ++t) {
      grid.sync();
      sweep<Step>(out, w, scratch, first, stride, g);
      grid.sync();
      for (int idx = first; idx < total; idx += stride) out[idx] = scratch[idx];
    }
  }
}

template <typename Step>
int launch(const void* v, const void* w, void* out, void* scratch, int R,
           int C, int n, int k, int pingpong, int unroll, void* stream) {
  const float* v_t = static_cast<const float*>(v);
  const float* w_t = static_cast<const float*>(w);
  float* out_t = static_cast<float*>(out);
  float* scratch_t = static_cast<float*>(scratch);
  void* args[] = {&v_t, &w_t, &out_t, &scratch_t, &R, &C,
                  &n,   &k,   &pingpong, &unroll};
  return nk::cooperative_launch(probe_kernel<Step>, args, R, C, stream);
}

}  // namespace

// K6: out = k chained probe steps of step `step` (kernels/probe.py's index)
// from x = v, carried or ping-pong.  Returns the cudaError_t of the launch.
extern "C" int nk_chain_call(int step, const void* v, const void* w,
                             void* out, void* scratch, int R, int C, int n,
                             int k, int pingpong, int unroll, void* stream) {
  if (k < 0 || unroll < 1) return cudaErrorInvalidValue;
  switch (step) {
    case 0: return launch<Muls<2>>(v, w, out, scratch, R, C, n, k, pingpong, unroll, stream);
    case 1: return launch<Muls<4>>(v, w, out, scratch, R, C, n, k, pingpong, unroll, stream);
    case 2: return launch<Muls<8>>(v, w, out, scratch, R, C, n, k, pingpong, unroll, stream);
    case 3: return launch<RollChain<0, 1>>(v, w, out, scratch, R, C, n, k, pingpong, unroll, stream);
    case 4: return launch<RollChain<0, 4>>(v, w, out, scratch, R, C, n, k, pingpong, unroll, stream);
    case 5: return launch<RollChain<1, 1>>(v, w, out, scratch, R, C, n, k, pingpong, unroll, stream);
    case 6: return launch<RollChain<1, 4>>(v, w, out, scratch, R, C, n, k, pingpong, unroll, stream);
    case 7: return launch<CurBuild>(v, w, out, scratch, R, C, n, k, pingpong, unroll, stream);
    case 8: return launch<OptBuild>(v, w, out, scratch, R, C, n, k, pingpong, unroll, stream);
    case 9: return launch<NorollBuild>(v, w, out, scratch, R, C, n, k, pingpong, unroll, stream);
    case 10: return launch<MinBuild>(v, w, out, scratch, R, C, n, k, pingpong, unroll, stream);
    default: return cudaErrorInvalidValue;
  }
}
