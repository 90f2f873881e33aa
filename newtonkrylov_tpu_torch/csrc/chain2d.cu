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
// What bounds them on this card.  Per cell and step K3 and K5 do 5 to 6 adds
// and multiplies, K4 11; the bytes a call must move are three arrays (two
// read, one written), whatever the number of steps.  So at k or degree >= 2
// the least time is the arithmetic's: at 2048^2 f32, K4 at degree 16 0.0222
// ms, K3 and K5 at k = 200 0.14-0.15 ms of operations (chip_smoke.py's
// _bound), against 0.016 ms of bytes.  A design that passes the state
// through device memory on every step cannot come near that: 2048^2 f32 is
// 17.9 MB an array, far beyond the 227 KB of shared memory of an SM, and K4
// moves seven arrays a step.
//
// Design (csrc/tiled.cuh): overlapped temporal tiles.  A call runs in passes
// of at most S steps, each one plain launch over a grid of output tiles; a
// block holds its tile and a halo of S cells on chip, each thread a
// micro-tile of M x V cells in registers (the stepped operand and the
// per-cell arrays), runs the pass's steps over a shrinking region with one
// __syncthreads() per step, exchanging only the micro-tiles' edges through
// shared memory and recomputing the halo instead of exchanging it with
// other blocks, and writes its tile once.  No grid sync, no cooperative
// launch; a pass reads its input and writes its output once, so a call of
// s <= S steps moves the three arrays the bound counts.  The price is the
// halo's redundant work: with the plans of _tile_plan a block computes 1.5
// to 2 cells for each cell of its tile.
//   K3, K5  x is the stepped operand, w - 4 is hoisted once per pass; passes
//           ping-pong between the output and one scratch array, the parity
//           chosen so that the last pass lands in the output (a call of one
//           pass needs no scratch).
//   K4      d is the stepped operand; r, x and diag stay in registers, d0 =
//           r * (1/theta) is formed on chip.  A call of degree <= S reads r
//           and diag and writes x only; a larger degree carries r and d
//           between passes through two pairs of scratch arrays (x is updated
//           in place in the output: only its own block reads a tile's x).
// The tile shape, S, M, V and the shared memory come from the caller's plan
// (kernels/stencil2d.py, _tile_plan), checked here; a launch the device
// refuses returns its error to the caller, which raises.  There is no
// fallback.
//
// Arithmetic follows the Pallas bodies operation for operation in the array
// dtype, and the library is built with -fmad=false, so each kernel equals its
// plain PyTorch version (kernels/stencil2d.py, *_xla) bit for bit; a halo
// cell repeats a neighbour block's arithmetic exactly, so the tiling cannot
// change a bit:
//   K3  w4 = w - 4;  raw(x) = (((up + dn) + left) + right) + w4*x;  each
//       double step scaled (1, s*s) with s*s rounded in the dtype; an odd k
//       ends with raw(x)*s; every step writes the interior and 0 elsewhere.
//       The scaling of a step follows its index in the whole call.
//   K5  raw(x) = ((up + dn) + (left + right)) + w4*x on every element, no
//       mask; each double step scaled by 1/64; k even.
//   K4  sigma1 = theta/delta, rho = 1/sigma1, d = r*(1/theta), x = d; then
//       degree times: r = r - mask*o*((((up + dn) + left) + right) + diag*d);
//       rho' = 1/(2 sigma1 - rho); d = (rho' rho) d + (2 rho'/delta) r;
//       x = x + d.  theta, delta and o are read from a device 3-vector by
//       every thread, which runs the rho recurrence in registers from the
//       first step up to its pass's: an apply needs no host round trip, and
//       every pass uses the same coefficients' bits.
//   k = 0 (degree 0) is one pass of no steps: K3 and K5 copy v, K4 gives d0.

#include "tiled.cuh"

#include <type_traits>

namespace {

using nk::Plan;
using nk::Region;

// One pass of K3 (PROBE = false) or K5 (PROBE = true) on a region of
// BX V x BY M cells: global steps first + 1 .. first + steps of k, from src
// into dst.
template <typename T, int M, int V, int BX, int BY, bool PROBE>
__global__ void __launch_bounds__(BX * BY, 1)
    chain_pass(const T* src, const T* __restrict__ w, T* dst, int R, int C,
               int n, int k, int first, int steps, int halo, T s, T s2) {
  static_assert(M * V <= 32, "one mask bit per cell");
  using E = nk::Edges<T, M, V, BX, BY>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* edges = reinterpret_cast<E*>(smem);
  const Region g = nk::region<BY * M, BX * V>(halo, steps);
  T x[M][V];
  T w4[M][V];
  unsigned mask = 0;
  nk::for_region<M, V>(g, R, C, [&](int i, int c, int gi, int gj) {
    const int idx = gi * C + gj;
    x[i][c] = src[idx];
    w4[i][c] = w[idx] - T(4);
    if (PROBE || nk::interior(gi, gj, n)) mask |= 1u << (i * V + c);
  });
  nk::publish(x, edges[0]);
  __syncthreads();
  // a warp whose micro-tiles lie wholly inside the interior (K5: every
  // warp) skips the mask; the test is the warp's, so no warp runs both
  const bool dense = PROBE || nk::warp_all(mask == nk::all_bits<M * V>());
  for (int t = 1; t <= steps; ++t) {
    const int tg = first + t;
    // raw * 1 == raw exactly: one multiply per cell whatever the step's scale
    const T f = tg % 2 == 0 ? s2 : (tg == k ? s : T(1));
    const auto run = [&](auto all_interior) {
      nk::step(x, edges[(t - 1) & 1], edges[t & 1], g, t,
               [&](int i, int c, T up, T dn, T left, T right, T own) {
                 const T raw =
                     PROBE ? ((up + dn) + (left + right)) + w4[i][c] * own
                           : (((up + dn) + left) + right) + w4[i][c] * own;
                 if constexpr (decltype(all_interior)::value) {
                   return raw * f;
                 } else {
                   return (mask >> (i * V + c)) & 1u ? raw * f : T(0);
                 }
               });
    };
    if (dense)
      run(std::true_type{});
    else
      run(std::false_type{});
    if (t < steps) __syncthreads();
  }
  nk::for_tile<M, V>(g, R, C,
                     [&](int i, int c, int idx) { dst[idx] = x[i][c]; });
}

// One pass of K4 on a region of BX V x BY M cells: steps first + 1 .. first
// + steps of the degree.  The first pass (d_src == nullptr) forms d0 and x
// from r_src = r; later ones read r and d from r_src, d_src and x from x_io.
// r_dst, d_dst receive r and d unless this is the last pass (nullptr); x_io
// receives x.
template <typename T, int M, int V, int BX, int BY>
__global__ void __launch_bounds__(BX * BY, 1)
    cheb_pass(const T* r_src, const T* d_src, const T* __restrict__ diag,
              const T* __restrict__ scal, T* x_io, T* r_dst, T* d_dst, int R,
              int C, int n, int first, int steps, int halo) {
  static_assert(M * V <= 32, "one mask bit per cell");
  using E = nk::Edges<T, M, V, BX, BY>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* edges = reinterpret_cast<E*>(smem);
  const Region g = nk::region<BY * M, BX * V>(halo, steps);
  const T theta = scal[0];
  const T delta = scal[1];
  const T o = scal[2];
  const T sigma1 = theta / delta;
  const T inv_theta = T(1) / theta;
  T rho = T(1) / sigma1;
  for (int t = 0; t < first; ++t) rho = T(1) / (T(2) * sigma1 - rho);
  T d[M][V];
  T r[M][V];
  T x[M][V];
  T dg[M][V];
  unsigned mask = 0;
  if (d_src == nullptr) {
    nk::for_region<M, V>(g, R, C, [&](int i, int c, int gi, int gj) {
      const int idx = gi * C + gj;
      r[i][c] = r_src[idx];
      dg[i][c] = diag[idx];
      d[i][c] = r[i][c] * inv_theta;
      x[i][c] = d[i][c];
    });
  } else {
    nk::for_region<M, V>(g, R, C, [&](int i, int c, int gi, int gj) {
      const int idx = gi * C + gj;
      r[i][c] = r_src[idx];
      dg[i][c] = diag[idx];
      d[i][c] = d_src[idx];
    });
    nk::for_own<M, V>(g, R, C,
                      [&](int i, int c, int idx) { x[i][c] = x_io[idx]; });
  }
  nk::for_region<M, V>(g, R, C, [&](int i, int c, int gi, int gj) {
    if (nk::interior(gi, gj, n)) mask |= 1u << (i * V + c);
  });
  nk::publish(d, edges[0]);
  __syncthreads();
  // a warp whose micro-tiles lie wholly inside the interior skips the mask
  const bool dense = nk::warp_all(mask == nk::all_bits<M * V>());
  for (int t = 1; t <= steps; ++t) {
    const T rho_new = T(1) / (T(2) * sigma1 - rho);
    const T c_d = rho_new * rho;
    const T c_r = T(2) * rho_new / delta;
    const auto run = [&](auto all_interior) {
      nk::step(d, edges[(t - 1) & 1], edges[t & 1], g, t,
               [&](int i, int c, T up, T dn, T left, T right, T own) {
                 const T applied =
                     r[i][c] - o * ((((up + dn) + left) + right) +
                                    dg[i][c] * own);
                 if constexpr (decltype(all_interior)::value) {
                   r[i][c] = applied;
                 } else {
                   r[i][c] = (mask >> (i * V + c)) & 1u ? applied : r[i][c];
                 }
                 const T d_new = c_d * own + c_r * r[i][c];
                 x[i][c] = x[i][c] + d_new;
                 return d_new;
               });
    };
    if (dense)
      run(std::true_type{});
    else
      run(std::false_type{});
    rho = rho_new;
    if (t < steps) __syncthreads();
  }
  nk::for_tile<M, V>(g, R, C, [&](int i, int c, int idx) {
    x_io[idx] = x[i][c];
    if (r_dst != nullptr) {
      r_dst[idx] = r[i][c];
      d_dst[idx] = d[i][c];
    }
  });
}

// The one region each kernel is built for, per element type (the _REGIONS
// of kernels/stencil2d.py): micro-tiles of M rows x V columns, BX x BY
// threads.  Registers hold 2 M V (K3, K5) or 4 M V (K4) values of T a thread.
template <int M_, int V_, int BX_, int BY_>
struct Shape {
  static constexpr int M = M_, V = V_, BX = BX_, BY = BY_;
  // True when plan p names this region.
  static bool takes(const Plan& p) {
    return p.M == M && p.V == V && p.W() == BX * V && p.H() == BY * M;
  }
};

template <typename T>
using ChainShape = std::conditional_t<std::is_same_v<T, float>,
                                      Shape<8, 4, 32, 16>, Shape<6, 4, 32, 16>>;
template <typename T>
using ChebShape = std::conditional_t<std::is_same_v<T, float>,
                                     Shape<4, 4, 32, 20>, Shape<4, 2, 32, 16>>;

// K3 and K5: ceil(k / S) passes from v, the last into out; `work` is one
// scratch array (nullptr when there is one pass).
template <typename T, bool PROBE>
int launch_chain(const void* v, const void* w, void* out, void* work, int R,
                 int C, int n, int k, T s, T s2, const Plan& p, void* stream) {
  using Sh = ChainShape<T>;
  if (!Sh::takes(p)) return cudaErrorInvalidConfiguration;
  int err = nk::check_plan<T>(p, R, C, k);
  const int passes = nk::passes(k, p.S);
  if (err == cudaSuccess && passes > 1 && work == nullptr)
    err = cudaErrorInvalidValue;
  const T* src = static_cast<const T*>(v);
  const T* w_t = static_cast<const T*>(w);
  for (int q = 0; err == cudaSuccess && q < passes; ++q) {
    T* dst = static_cast<T*>((passes - 1 - q) % 2 == 0 ? out : work);
    const int first = q * p.S;
    const int steps = k - first < p.S ? k - first : p.S;
    err = nk::launch_pass<chain_pass<T, Sh::M, Sh::V, Sh::BX, Sh::BY, PROBE>>(
        p, R, C, stream, src, w_t, dst, R, C, n, k, first, steps, p.S, s, s2);
    src = dst;
  }
  return err;
}

// K4: ceil(degree / S) passes; `work` holds four scratch arrays (r and d,
// twice) when there is more than one pass, else nullptr.
template <typename T>
int launch_cheb(const void* r, const void* diag, const void* scal, void* x,
                void* work, int R, int C, int n, int degree, const Plan& p,
                void* stream) {
  using Sh = ChebShape<T>;
  if (!Sh::takes(p)) return cudaErrorInvalidConfiguration;
  int err = nk::check_plan<T>(p, R, C, degree);
  const int passes = nk::passes(degree, p.S);
  if (err == cudaSuccess && passes > 1 && work == nullptr)
    err = cudaErrorInvalidValue;
  const size_t size = static_cast<size_t>(R) * C;
  T* scratch = static_cast<T*>(work);
  const T* r_src = static_cast<const T*>(r);
  const T* d_src = nullptr;
  for (int q = 0; err == cudaSuccess && q < passes; ++q) {
    const bool last = q == passes - 1;
    T* r_dst = last ? nullptr : scratch + (q % 2) * 2 * size;
    T* d_dst = last ? nullptr : r_dst + size;
    const int first = q * p.S;
    const int steps = degree - first < p.S ? degree - first : p.S;
    err = nk::launch_pass<cheb_pass<T, Sh::M, Sh::V, Sh::BX, Sh::BY>>(
        p, R, C, stream, r_src, d_src, static_cast<const T*>(diag),
        static_cast<const T*>(scal), static_cast<T*>(x), r_dst, d_dst, R, C,
        n, first, steps, p.S);
    r_src = r_dst;
    d_src = d_dst;
  }
  return err;
}

template <typename T>
int launch_k3(const void* v, const void* w, void* out, void* work, int R,
              int C, int n, int k, double scale, const Plan& p, void* stream) {
  const T s = static_cast<T>(scale);
  const T s2 = s * s;  // rounded in T, as the Pallas kernel's s * s
  return launch_chain<T, false>(v, w, out, work, R, C, n, k, s, s2, p, stream);
}

}  // namespace

// Each function takes the plan of kernels/stencil2d.py's _tile_plan, in the
// order of its TilePlan: tiles of tile_h x tile_w, S steps per pass (the
// halo), the dynamic shared memory in bytes, and M rows by V columns per
// thread.  Each returns the cudaError_t of its
// launches (cudaErrorInvalidValue or cudaErrorInvalidConfiguration for a plan
// it does not take).

// K3: out = k chained steps x <- mask*(lap x + w x) from x = v, scaled (1, s^2)
// per double step.
extern "C" int nk_stencil_jvp_chain(const void* v, const void* w, void* out,
                                    void* work, int R, int C, int n, int k,
                                    double scale, int tile_h, int tile_w,
                                    int S, int smem, int M, int V,
                                    int is_double, void* stream) {
  const Plan p{tile_h, tile_w, S, smem, M, V};
  return is_double
             ? launch_k3<double>(v, w, out, work, R, C, n, k, scale, p, stream)
             : launch_k3<float>(v, w, out, work, R, C, n, k, scale, p, stream);
}

// K5: out = k unmasked probe steps from x = v (k even).
extern "C" int nk_stencil_chain_probe(const void* v, const void* w, void* out,
                                      void* work, int R, int C, int n, int k,
                                      int tile_h, int tile_w, int S, int smem,
                                      int M, int V, int is_double,
                                      void* stream) {
  const Plan p{tile_h, tile_w, S, smem, M, V};
  return is_double ? launch_chain<double, true>(v, w, out, work, R, C, n, k,
                                                1.0, 1.0 / 64.0, p, stream)
                   : launch_chain<float, true>(v, w, out, work, R, C, n, k,
                                               1.0f, 1.0f / 64.0f, p, stream);
}

// K4: x = p_degree(A) r with scal = [theta, delta, o] on the device.
extern "C" int nk_chebyshev_apply(const void* r, const void* diag,
                                  const void* scal, void* x, void* work, int R,
                                  int C, int n, int degree, int tile_h,
                                  int tile_w, int S, int smem, int M, int V,
                                  int is_double, void* stream) {
  const Plan p{tile_h, tile_w, S, smem, M, V};
  return is_double ? launch_cheb<double>(r, diag, scal, x, work, R, C, n,
                                         degree, p, stream)
                   : launch_cheb<float>(r, diag, scal, x, work, R, C, n,
                                        degree, p, stream);
}
