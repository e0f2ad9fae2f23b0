// The block-level histogram step shared by csrc/histogram.cu (hist_full,
// hist_segment) and csrc/ring.cu (fused_hist_ring): one block adds a tile
// of rows into a privatised (features_in_group, B, 3) histogram in shared
// memory, then flushes its non-zero cells into the output with global
// atomicAdd.  See the note at the top of histogram.cu for the design.
//
// accum modes: 0 = float32; 1 = bfloat16 (each gh value rounded to bf16,
// round-to-nearest-even, then summed in f32, as _hist_kernel does); 2 =
// int32 (integer codes, exact).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hist {

constexpr int kGroup = 8;      // features per block
constexpr int kThreads = 256;  // threads per block

template <int kMode>
struct Accum;

template <>
struct Accum<0> {
  using T = float;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
};

template <>
struct Accum<1> {
  using T = float;
  static __device__ __forceinline__ float load(const float* p) {
    return __bfloat162float(__float2bfloat16_rn(__ldg(p)));
  }
};

template <>
struct Accum<2> {
  using T = int32_t;
  static __device__ __forceinline__ int32_t load(const int32_t* p) {
    return __ldg(p);
  }
};

// Adds rows i in [i0, i1) of the row list, features [f0, f0 + kGroup) ∩
// [0, f), into `out` (f, num_bins, 3), through the shared histogram `hist`
// (kGroup * num_bins * 3 cells).  kGather: row i is row_order[off + i];
// otherwise it is i.  Ends with a barrier, so a block may call it again
// for its next tile.
template <int kMode, bool kGather>
__device__ __forceinline__ void accumulate_tile(
    const uint8_t* __restrict__ bins, const typename Accum<kMode>::T* __restrict__ gh,
    const int32_t* __restrict__ row_order, int64_t off, int64_t i0, int64_t i1, int f,
    int f0, int num_bins, typename Accum<kMode>::T* __restrict__ hist,
    typename Accum<kMode>::T* __restrict__ out) {
  using T = typename Accum<kMode>::T;
  const int fg = min(kGroup, f - f0);
  const int cells = fg * num_bins * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = T(0);
  __syncthreads();

  for (int64_t i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    const int64_t r = kGather ? static_cast<int64_t>(__ldg(row_order + off + i)) : i;
    const T g = Accum<kMode>::load(gh + r * 3 + 0);
    const T h = Accum<kMode>::load(gh + r * 3 + 1);
    const T c = Accum<kMode>::load(gh + r * 3 + 2);
    const uint8_t* row = bins + r * f + f0;
    for (int j = 0; j < fg; ++j) {
      const int b = row[j];
      if (b >= num_bins) continue;  // out-of-range bins are dropped
      T* cell = hist + (j * num_bins + b) * 3;
      atomicAdd(cell + 0, g);
      atomicAdd(cell + 1, h);
      atomicAdd(cell + 2, c);
    }
  }
  __syncthreads();

  T* dst = out + static_cast<int64_t>(f0) * num_bins * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const T v = hist[i];
    if (v != T(0)) atomicAdd(dst + i, v);
  }
  __syncthreads();
}

}  // namespace hist
