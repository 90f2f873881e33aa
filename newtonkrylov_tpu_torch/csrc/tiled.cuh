// The overlapped-tile skeleton of the chained stencil kernels of
// csrc/chain2d.cu (K3, K4, K5): k dependent 5-point steps on an (R, C)
// row-major array whose neighbours wrap around the whole array, as
// torch.roll and pltpu.roll read them.
//
// A call runs as passes of at most S steps.  One pass is one plain launch
// over a 2-D grid of output tiles of tile_h x tile_w cells.  A block loads
// its tile plus a halo of S cells on each side (its region, H x W =
// (tile_h + 2S) x (tile_w + 2S) cells, wrapped indices) onto the chip; step t
// of a pass of s steps updates the cells at least S - s + t cells inside the
// region's edge, so after s steps the tile holds what s steps over the whole
// array give.  Each block recomputes its halo itself, with the same
// arithmetic in the same order: no block reads another block's writes, so a
// pass needs no grid sync, and the stream orders the passes.
//
// Threads: BX x BY, each holding a micro-tile of M rows x V columns of the
// stepped operand in registers (W = BX V, H = BY M, all constants of an
// instantiation).  A cell's neighbours inside the micro-tile come from
// registers; only the micro-tile's edges go through shared memory (Edges):
// per row its first and last value, per column its top and bottom value,
// laid out so that the threads of a warp touch consecutive words.  Two Edges
// buffers are written and read in turn, so one __syncthreads() per step
// separates a step's reads from the next step's writes.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>

namespace nk {

// Rows [0, n), columns [1, n]: the interior of the aligned layout.
__device__ __forceinline__ bool interior(int i, int j, int n) {
  return i < n && j >= 1 && j <= n;
}

// The low N bits set: the mask of a micro-tile of N cells all inside.
template <int N>
__device__ __forceinline__ unsigned all_bits() {
  static_assert(N >= 1 && N <= 32, "one bit per cell");
  return N == 32 ? ~0u : (1u << N) - 1u;
}

// True on every lane of the warp when `p` holds on all of them (every
// thread of a block calls it: blocks are whole warps).
__device__ __forceinline__ bool warp_all(bool p) {
  return __all_sync(0xffffffffu, p);
}

// v mod m in [0, m), for any v (a halo may reach past a small array more
// than once).
__device__ __forceinline__ int wrap(int v, int m) {
  v %= m;
  return v < 0 ? v + m : v;
}

// One block's region in one pass: H x W cells, the tile and its halo.
struct Region {
  int H, W;        // rows and columns
  int halo;        // S
  int row0, col0;  // array coordinates of region cell (0, 0), before wrapping
  int lo;          // S - steps of this pass: the outer lo rows and columns idle
};

template <int H, int W>
__device__ __forceinline__ Region region(int halo, int steps) {
  return {H, W, halo,
          static_cast<int>(blockIdx.y) * (H - 2 * halo) - halo,
          static_cast<int>(blockIdx.x) * (W - 2 * halo) - halo,
          halo - steps};
}

// The edges of every micro-tile after one step, for the neighbours to read.
template <typename T, int M, int V, int BX, int BY>
struct Edges {
  T first[BY * M][BX];  // [region row][thread column]: the row's first value
  T last[BY * M][BX];   // ... its last value
  T top[BY][V][BX];     // [strip][column in the micro-tile][thread column]
  T bottom[BY][V][BX];
};

// Publish the thread's micro-tile v to e.
template <typename T, int M, int V, int BX, int BY>
__device__ __forceinline__ void publish(const T (&v)[M][V],
                                        Edges<T, M, V, BX, BY>& e) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    e.first[ty * M + i][tx] = v[i][0];
    e.last[ty * M + i][tx] = v[i][V - 1];
  }
#pragma unroll
  for (int c = 0; c < V; ++c) {
    e.top[ty][c][tx] = v[0][c];
    e.bottom[ty][c][tx] = v[M - 1][c];
  }
}

// f(i, c, gi, gj) for every cell (i, c) of the thread's micro-tile: array
// row gi and column gj, wrapped.  No cell is skipped, so that the loads of a
// thread issue together instead of one round trip to memory each: a cell
// outside those the pass needs reads a valid element and is never used.
template <int M, int V, typename F>
__device__ __forceinline__ void for_region(const Region& g, int R, int C,
                                           F&& f) {
  int gi[M];
  int gj[V];
#pragma unroll
  for (int i = 0; i < M; ++i) gi[i] = wrap(g.row0 + threadIdx.y * M + i, R);
#pragma unroll
  for (int c = 0; c < V; ++c) gj[c] = wrap(g.col0 + threadIdx.x * V + c, C);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int c = 0; c < V; ++c) f(i, c, gi[i], gj[c]);
}

// f(i, c, idx) for every cell (i, c) of the thread's micro-tile, idx the
// array element of the block's own tile nearest to it (the cell itself in
// the tile): loads of an array that other blocks write in the same pass,
// issued together as for_region's, that touch no element of another tile.
template <int M, int V, typename F>
__device__ __forceinline__ void for_own(const Region& g, int R, int C,
                                        F&& f) {
  const int r_lo = g.row0 + g.halo;
  const int r_hi = min(g.row0 + g.H - g.halo, R) - 1;
  const int c_lo = g.col0 + g.halo;
  const int c_hi = min(g.col0 + g.W - g.halo, C) - 1;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int gi = min(max(g.row0 + static_cast<int>(threadIdx.y) * M + i, r_lo), r_hi);
#pragma unroll
    for (int c = 0; c < V; ++c)
      f(i, c, gi * C + min(max(g.col0 + static_cast<int>(threadIdx.x) * V + c, c_lo), c_hi));
  }
}

// f(i, c, idx) for each cell (i, c) of the thread's micro-tile inside the
// tile and the array (the bottom and right tiles are ragged): array element
// idx.
template <int M, int V, typename F>
__device__ __forceinline__ void for_tile(const Region& g, int R, int C,
                                         F&& f) {
  const int li0 = threadIdx.y * M;
  const int lj0 = threadIdx.x * V;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int lj = lj0 + c;
    const int gj = g.col0 + lj;
    if (lj < g.halo || lj >= g.W - g.halo || gj >= C) continue;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const int li = li0 + i;
      const int gi = g.row0 + li;
      if (li >= g.halo && li < g.H - g.halo && gi < R) f(i, c, gi * C + gj);
    }
  }
}

// Step t (1-based) of a pass.  The cells at least lo + t cells inside the
// region's edge are live: their neighbours were live at step t - 1.  A thread
// whose micro-tile holds a live cell sets every cell (i, c) of it to
// f(i, c, up, dn, left, right, v[i][c]) and publishes its edges to `next`,
// with no test per cell: a dead cell's value is never read by a live cell
// again, so computing it does no harm, and the cells run without branches.
// A micro-tile with no live cell is left alone.
template <typename T, int M, int V, int BX, int BY, typename F>
__device__ __forceinline__ void step(T (&v)[M][V],
                                     const Edges<T, M, V, BX, BY>& cur,
                                     Edges<T, M, V, BX, BY>& next,
                                     const Region& g, int t, F&& f) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int a = g.lo + t;
  if (tx * V + V <= a || tx * V >= g.W - a || ty * M + M <= a ||
      ty * M >= g.H - a)
    return;
  T prev[V];  // the old values of the row above
  T below[V];
#pragma unroll
  for (int c = 0; c < V; ++c) {
    prev[c] = ty > 0 ? cur.bottom[ty - 1][c][tx] : T(0);
    below[c] = ty < BY - 1 ? cur.top[ty + 1][c][tx] : T(0);
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int li = ty * M + i;
    const T before = tx > 0 ? cur.last[li][tx - 1] : T(0);
    const T after = tx < BX - 1 ? cur.first[li][tx + 1] : T(0);
    T row[V];
#pragma unroll
    for (int c = 0; c < V; ++c)
      row[c] = f(i, c, prev[c], i + 1 < M ? v[i + 1][c] : below[c],
                 c > 0 ? v[i][c - 1] : before, c + 1 < V ? v[i][c + 1] : after,
                 v[i][c]);
#pragma unroll
    for (int c = 0; c < V; ++c) {
      prev[c] = v[i][c];
      v[i][c] = row[c];
    }
  }
  publish(v, next);
}

// A pass plan as the caller gives it: tiles of tile_h x tile_w, a halo of S
// (the most steps a pass runs), the dynamic shared memory (two Edges), M
// rows and V columns per thread.
struct Plan {
  int tile_h, tile_w, S, smem, M, V;
  int H() const { return tile_h + 2 * S; }
  int W() const { return tile_w + 2 * S; }
};

// cudaSuccess when `p` describes passes for element type T on an (R, C)
// array running `steps` steps, else cudaErrorInvalidValue.
template <typename T>
int check_plan(const Plan& p, int R, int C, int steps) {
  const bool shape = p.tile_h >= 1 && p.tile_w >= 1 && p.S >= 0 &&
                     (steps == 0 || p.S >= 1) && p.M >= 1 && p.V >= 1 &&
                     p.H() % p.M == 0 && p.W() % p.V == 0;
  const long long bx = shape ? p.W() / p.V : 0;
  const long long by = shape ? p.H() / p.M : 0;
  const bool ok = shape && static_cast<long long>(R) * C <= INT_MAX &&
                  p.smem == 2 * 2 * bx * (p.H() + by * p.V) *
                                static_cast<long long>(sizeof(T));
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// Number of passes of a call of `steps` steps under a plan of halo S.
inline int passes(int steps, int S) {
  return steps == 0 ? 1 : (steps + S - 1) / S;
}

// Launch one pass of `Kernel` under plan `p` on the stream: grid of tiles
// over (R, C), (W / V) x (H / M) threads, dynamic shared memory raised above
// the 48 KB default where the plan asks for it.  A kernel is built for one
// region, so its plan's shared memory never changes (check_plan): the limit
// is raised once per kernel and device, not on every pass.  Returns the
// cudaError_t of the launch.
template <auto Kernel, typename... Args>
int launch_pass(const Plan& p, int R, int C, void* stream, Args... args) {
  if (p.smem > 48 * 1024) {
    static std::atomic<unsigned long long> raised{0};  // one bit per device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(raised.load() & bit)) {
      err = cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised.fetch_or(bit);
    }
  }
  const dim3 grid((C + p.tile_w - 1) / p.tile_w, (R + p.tile_h - 1) / p.tile_h);
  const dim3 block(p.W() / p.V, p.H() / p.M);
  Kernel<<<grid, block, p.smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nk
