// How the histogram kernels of csrc/histogram.cu (hist_full, hist_segment)
// and csrc/ring.cu (fused_hist_ring) read a gh value in each accumulation
// mode: 0 = float32; 1 = bfloat16 (each gh value rounded to bf16,
// round-to-nearest-even, then summed in f32, as _hist_kernel does); 2 =
// int32 (integer codes, exact).  Accum<kMode>::T is the type summed;
// load() reads one value from device memory, round() converts one already
// staged in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hist {

template <int kMode>
struct Accum;

template <>
struct Accum<0> {
  using T = float;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Accum<1> {
  using T = float;
  static __device__ __forceinline__ float load(const float* p) {
    return round(__ldg(p));
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <>
struct Accum<2> {
  using T = int32_t;
  static __device__ __forceinline__ int32_t load(const int32_t* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ int32_t round(int32_t v) { return v; }
};

}  // namespace hist
