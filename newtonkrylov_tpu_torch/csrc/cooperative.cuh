// The cooperative persistent skeleton of csrc/chain_probe.cu (K6, the probe
// that prices a step through memory and a grid sync): one launch of as many
// blocks as the SMs hold at once, grid-stride loops over an (R, C) row-major
// array, steps separated by cooperative_groups::this_grid().sync().

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace nk {

constexpr int kThreads = 256;

template <typename T>
struct Neighbours {
  T up, dn, left, right;
};

// The four neighbours of element (i, j) at idx = i*C + j, wrapping around the
// whole (R, C) array, as pltpu.roll and torch.roll do.
template <typename T>
__device__ __forceinline__ Neighbours<T> neighbours(const T* x, int idx, int i,
                                                    int j, int R, int C) {
  const int span = (R - 1) * C;
  return {x[i > 0 ? idx - C : idx + span], x[i < R - 1 ? idx + C : idx - span],
          x[j > 0 ? idx - 1 : idx + (C - 1)],
          x[j < C - 1 ? idx + 1 : idx - (C - 1)]};
}

// Rows [0, n), columns [1, n]: the interior of the aligned layout.
__device__ __forceinline__ bool interior(int i, int j, int n) {
  return i < n && j >= 1 && j <= n;
}

// Launch `kernel` cooperatively on as many blocks as the SMs hold at once,
// capped by the element count.  Returns the cudaError_t of the launch.
template <typename Kernel>
int cooperative_launch(Kernel kernel, void** args, int R, int C,
                       void* stream) {
  if (static_cast<long long>(R) * C > INT_MAX) return cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int needed = (R * C + kThreads - 1) / kThreads;
  const int blocks = per_sm * sms < needed ? per_sm * sms : needed;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nk
