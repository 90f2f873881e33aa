// The chained-step cost probe K6 on the aligned layout (Hopper, sm_90a).
//
// Replaces the TPU kernel _chain_call of benchmarks/kernel_probe.py: k
// dependent steps of one probe step with the state held on chip, to price
// each ingredient of a chained stencil per step.  The steps (kernels/probe.py
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
// array as pltpu.roll does: a roll by +1 along axis 0 (1) reads the up (left)
// neighbour, and a chain of four rolls (+1, -1, +1, -1) reads the element
// itself.  Every constant is the float32 the JAX probe rounds it to, and the
// library is built with -fmad=false, so the kernel equals its plain PyTorch
// version (kernels/probe.py, chain_call_xla) bit for bit.
//
// Design: the overlapped-tile skeleton of K3-K5 (csrc/tiled.cuh).  A call
// runs in passes of at most S = 16 steps, each one plain launch over a grid
// of output tiles; a block loads its tile and a halo of S cells, steps its
// micro-tiles in registers and shared memory (one thread per micro-tile of
// M x V cells, only the micro-tiles' edges exchanged through shared memory),
// recomputes its halo instead of exchanging it, and writes its tile once.
// No cooperative launch and no grid sync; passes ping-pong between the
// output and the scratch array, the last landing in the output.  The
// probe's disciplines map onto on-chip storage:
//   * ping-pong: each step reads one edge buffer and writes the other, one
//     block barrier per step; 2*unroll*floor(k / (2*unroll)) steps, the JAX
//     body loop's count, the steps of a pass unrolled by `unroll` (1, 2 or
//     4 statically; any other unroll runs the same steps unrolled once);
//   * carry, for a step that reads neighbours (rolls, stencils): each step
//     writes the second edge buffer, and after a block barrier the carried
//     buffer is copied back from it behind a second barrier: the loop-carry
//     copy the TPU probe measures in VMEM;
//   * carry, for a step that reads only its own element (muls,
//     noroll_build): the value stays in a register for all k steps, one
//     plain launch and no barrier.
// So a step's carry time less its ping-pong time is the price of one
// on-chip copy and one block barrier, and the muls ping-pong time less their
// carry time the price of a step through the tiles' machinery (the edges'
// exchange, a barrier, the halo's recomputation), with each pass's trip
// through memory spread over its S steps.  k is a runtime argument.
// K6 is a measuring instrument: its speed is not a target.

#include "tiled.cuh"

namespace {

using nk::Plan;
using nk::Region;

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
// a register) and at(up, dn, left, right, x, wm4, inside): the new value of a
// cell from its neighbours, its own value, w - 4 and whether it lies in the
// probe's mask.

__device__ __forceinline__ float masks_of(bool inside) {
  return (inside ? 1.f : 0.f) * kScale;
}

template <int NOPS>
struct Muls {
  static constexpr bool kOwn = true;
  __device__ static float at(float, float, float, float, float x, float,
                             bool) {
#pragma unroll
    for (int c = 0; c < NOPS; ++c) x = x * mul_const(c);
    return x;
  }
};

template <int AXIS, int NROLLS>
struct RollChain {
  static constexpr bool kOwn = false;
  static_assert(NROLLS == 1 || NROLLS == 4, "the probe's chains");
  __device__ static float at(float up, float, float left, float, float x,
                             float, bool) {
    // one roll by +1 reads the up (left) neighbour; four alternating rolls
    // land on the element itself
    float v = NROLLS == 4 ? x : (AXIS == 0 ? up : left);
#pragma unroll
    for (int r = 0; r < NROLLS; ++r) v = v * kRollMul;
    return v;
  }
};

struct CurBuild {
  static constexpr bool kOwn = false;
  __device__ static float at(float up, float dn, float left, float right,
                             float x, float wm4, bool inside) {
    const float out = (((up + dn) + left) + right) + wm4 * x;
    return inside ? out * kScale : 0.f;
  }
};

struct OptBuild {
  static constexpr bool kOwn = false;
  __device__ static float at(float up, float dn, float left, float right,
                             float x, float wm4, bool inside) {
    return masks_of(inside) * (((up + dn) + (left + right)) + wm4 * x);
  }
};

struct NorollBuild {
  static constexpr bool kOwn = true;
  __device__ static float at(float, float, float, float, float x, float wm4,
                             bool inside) {
    const float up = x * kUp, dn = x * kDn, left = x * kLeft, right = x * kRight;
    return masks_of(inside) * (((up + dn) + (left + right)) + wm4 * x);
  }
};

struct MinBuild {
  static constexpr bool kOwn = false;
  __device__ static float at(float up, float dn, float left, float right,
                             float x, float wm4, bool inside) {
    const float masks = masks_of(inside);
    return masks * ((up + dn) + (left + right)) + (masks * wm4) * x;
  }
};

// The region of every pass (the f32 region of K3 and K5, _REGIONS in
// kernels/stencil2d.py): micro-tiles of M rows x V columns, BX x BY threads,
// at most kMostSteps steps a pass.
constexpr int kM = 8, kV = 4, kBX = 32, kBY = 16;
constexpr int kH = kBY * kM, kW = kBX * kV;
constexpr int kMostSteps = 16;

// One pass of `steps` steps of Step from src into dst: carried (CARRY) or
// ping-pong, the steps unrolled by UNROLL (steps % UNROLL == 0).
template <typename Step, bool CARRY, int UNROLL>
__global__ void __launch_bounds__(kBX * kBY, 1)
    probe_pass(const float* src, const float* __restrict__ w, float* dst,
               int R, int C, int n, int steps, int halo) {
  using E = nk::Edges<float, kM, kV, kBX, kBY>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* edges = reinterpret_cast<E*>(smem);
  const Region g = nk::region<kH, kW>(halo, steps);
  float x[kM][kV];
  float wm4[kM][kV];
  unsigned mask = 0;
  nk::for_region<kM, kV>(g, R, C, [&](int i, int c, int gi, int gj) {
    const int idx = gi * C + gj;
    x[i][c] = src[idx];
    wm4[i][c] = w[idx] - 4.f;
    if (nk::interior(gi, gj, n)) mask |= 1u << (i * kV + c);
  });
  nk::publish(x, edges[0]);
  if (CARRY) nk::publish(x, edges[1]);
  __syncthreads();
  const auto f = [&](int i, int c, float up, float dn, float left,
                     float right, float own) {
    return Step::at(up, dn, left, right, own, wm4[i][c],
                    (mask >> (i * kV + c)) & 1u);
  };
  if (CARRY) {
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    for (int t = 1; t <= steps; ++t) {
      nk::step(x, edges[0], edges[1], g, t, f);
      __syncthreads();  // every read of the carried edges is done
#pragma unroll
      for (int i = 0; i < kM; ++i) {  // the loop-carry copy, own entries
        edges[0].first[ty * kM + i][tx] = edges[1].first[ty * kM + i][tx];
        edges[0].last[ty * kM + i][tx] = edges[1].last[ty * kM + i][tx];
      }
#pragma unroll
      for (int c = 0; c < kV; ++c) {
        edges[0].top[ty][c][tx] = edges[1].top[ty][c][tx];
        edges[0].bottom[ty][c][tx] = edges[1].bottom[ty][c][tx];
      }
      __syncthreads();
    }
  } else {
    for (int t = 1; t <= steps; t += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        nk::step(x, edges[(t + u - 1) & 1], edges[(t + u) & 1], g, t + u, f);
        __syncthreads();
      }
    }
  }
  nk::for_tile<kM, kV>(g, R, C,
                       [&](int i, int c, int idx) { dst[idx] = x[i][c]; });
}

// A carried own-element step: k steps on each element in a register.
template <typename Step>
__global__ void __launch_bounds__(256)
    own_carry(const float* __restrict__ v, const float* __restrict__ w,
              float* out, int R, int C, int n, int k) {
  const int total = R * C;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const int i = idx / C;
    const int j = idx - i * C;
    const float wm4 = w[idx] - 4.f;
    const bool inside = nk::interior(i, j, n);
    float x = v[idx];
    for (int t = 0; t < k; ++t) x = Step::at(0.f, 0.f, 0.f, 0.f, x, wm4, inside);
    out[idx] = x;
  }
}

// The plan of a call of `steps` steps: S = 16 (fewer for a shorter call), so
// that every pass but the last runs S steps and, for ping-pong, each pass a
// multiple of 2 * unroll (16 is one for unroll 1, 2 and 4).
Plan plan_of(int steps) {
  const int S = steps < kMostSteps ? steps : kMostSteps;
  const int edges = 2 * kBX * (kH + kBY * kV);  // values per Edges buffer
  return {kH - 2 * S, kW - 2 * S, S, 2 * edges * static_cast<int>(sizeof(float)),
          kM, kV};
}

template <typename Step, bool CARRY, int UNROLL>
int run_passes(const float* v, const float* w, float* out, float* scratch,
               int R, int C, int n, int steps, void* stream) {
  const Plan p = plan_of(steps);
  int err = nk::check_plan<float>(p, R, C, steps);
  const int passes = nk::passes(steps, p.S);
  const float* src = v;
  for (int q = 0; err == cudaSuccess && q < passes; ++q) {
    float* dst = (passes - 1 - q) % 2 == 0 ? out : scratch;
    const int first = q * p.S;
    const int s = steps - first < p.S ? steps - first : p.S;
    err = nk::launch_pass<probe_pass<Step, CARRY, UNROLL>>(
        p, R, C, stream, src, w, dst, R, C, n, s, p.S);
    src = dst;
  }
  return err;
}

template <typename Step>
int launch(const void* v, const void* w, void* out, void* scratch, int R,
           int C, int n, int k, int pingpong, int unroll, void* stream) {
  const float* v_t = static_cast<const float*>(v);
  const float* w_t = static_cast<const float*>(w);
  float* out_t = static_cast<float*>(out);
  float* scratch_t = static_cast<float*>(scratch);
  if (static_cast<long long>(R) * C > INT_MAX) return cudaErrorInvalidValue;
  if (!pingpong) {
    if constexpr (Step::kOwn) {
      const int blocks = (R * C + 255) / 256;
      own_carry<Step><<<blocks < 4096 ? blocks : 4096, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(v_t, w_t, out_t,
                                                             R, C, n, k);
      return static_cast<int>(cudaGetLastError());
    } else {
      return run_passes<Step, true, 1>(v_t, w_t, out_t, scratch_t, R, C, n, k,
                                       stream);
    }
  }
  const int steps = 2 * unroll * (k / (2 * unroll));
  switch (unroll) {
    case 2:
      return run_passes<Step, false, 2>(v_t, w_t, out_t, scratch_t, R, C, n,
                                        steps, stream);
    case 4:
      return run_passes<Step, false, 4>(v_t, w_t, out_t, scratch_t, R, C, n,
                                        steps, stream);
    default:
      return run_passes<Step, false, 1>(v_t, w_t, out_t, scratch_t, R, C, n,
                                        steps, stream);
  }
}

}  // namespace

// K6: out = k chained probe steps of step `step` (kernels/probe.py's index)
// from x = v, carried or ping-pong; `scratch` is an array of v's shape.
// Returns the cudaError_t of the launches.
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
