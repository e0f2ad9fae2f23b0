// Gradient histograms for the GBDT grower, written by hand for Hopper
// (sm_90a).  Built by mmlspark_tpu_torch/ops/_build.py with nvcc into a
// shared library with a plain C interface and called through ctypes
// (mmlspark_tpu_torch/ops/cuda_histogram.py).
//
// hist_full replaces mmlspark_tpu/ops/pallas_histogram.py histogram_pallas
// (body _hist_kernel): the histogram of the whole binned matrix, the root
// histogram of every tree.
// hist_segment replaces histogram_pallas_fused (body _fused_kernel): the
// histogram of one DataPartition segment, rows row_order[off + i] for
// i < cnt, with bins and gh gathered in-kernel by row id.
//
// What they compute: out[j, b, c] = sum over the rows r with bins[r, j] == b
// of gh[r, c], for c in (grad, hess, count).  The TPU kernels fold eight
// features into one-hot MXU matmuls; this card has no need for that trick.
// Each block keeps a privatised (features_in_group, B, 3) histogram in
// shared memory, its threads stride over a tile of rows and atomicAdd into
// shared memory, and the block then flushes its non-zero cells into the
// output with global atomicAdd -- the design of LightGBM's CUDA learner and
// XGBoost's gpu_hist.  Shared memory is sized from B at run time
// (kGroup * B * 3 * 4 bytes, 24 KB at B = 256).
//
// Layout: the binned matrix is the row-major (n, f) uint8 matrix the
// binning pass produces.  A segment gather then reads one contiguous f-byte
// row per row id (two 32-byte sectors at f = 50) instead of f scattered
// bytes of a transposed copy, and the full histogram reads the same matrix
// without a transposed copy on the card.
//
// Bound at the flagship shapes (n = 400,000, f = 50, B = 256, H100 at
// 3.35 TB/s): hist_full must read 20 MB of bins and 4.8 MB of gh and write
// 154 KB, 7.5 us; its 60 M adds are 0.9 us at the 67 TFLOP/s f32 rate, so
// it is bound by bytes.  hist_segment at cnt = 200,000 must read 10 MB of
// bins, 2.4 MB of gh and 0.8 MB of row ids, 4.0 us.  In practice both are
// held back by shared-memory atomic throughput, not named by that bound;
// privatisation keeps the atomics on chip, and feature groups of eight keep
// a block's histogram at 24 KB so that eight blocks share an SM.
//
// accum modes (hist_block.cuh): 0 = float32; 1 = bfloat16; 2 = int32
// (integer codes, exact).  Float atomics make f32 sums depend on the
// order the rows arrive in, run to run; int32 sums are exact.
//
// The kernels allocate nothing (the caller zeroes `out`), launch on the
// caller's stream and do not synchronise; each entry returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"

namespace {

using hist::Accum;
using hist::kGroup;
using hist::kThreads;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
hist_full_kernel(const uint8_t* __restrict__ bins,
                 const typename Accum<kMode>::T* __restrict__ gh, int64_t n, int f,
                 int num_bins, int64_t rows_per_block,
                 typename Accum<kMode>::T* __restrict__ out) {
  using T = typename Accum<kMode>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int64_t i1 = (i0 + rows_per_block < n) ? i0 + rows_per_block : n;
  hist::accumulate_tile<kMode, false>(bins, gh, nullptr, 0, i0, i1, f, blockIdx.x * kGroup,
                                      num_bins, reinterpret_cast<T*>(smem_raw), out);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
hist_segment_kernel(const uint8_t* __restrict__ bins,
                    const typename Accum<kMode>::T* __restrict__ gh,
                    const int32_t* __restrict__ row_order, int64_t off, int64_t cnt,
                    int f, int num_bins, int64_t rows_per_block,
                    typename Accum<kMode>::T* __restrict__ out) {
  using T = typename Accum<kMode>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  const int64_t i1 = (i0 + rows_per_block < cnt) ? i0 + rows_per_block : cnt;
  hist::accumulate_tile<kMode, true>(bins, gh, row_order, off, i0, i1, f, blockIdx.x * kGroup,
                                     num_bins, reinterpret_cast<T*>(smem_raw), out);
}

template <int kMode>
void launch_full(const void* bins, const void* gh, int64_t n, int f, int num_bins,
                 dim3 grid, int64_t rows_per_block, size_t smem, void* out,
                 cudaStream_t stream) {
  using T = typename Accum<kMode>::T;
  hist_full_kernel<kMode><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(bins), static_cast<const T*>(gh), n, f, num_bins,
      rows_per_block, static_cast<T*>(out));
}

template <int kMode>
void launch_segment(const void* bins, const void* gh, const void* row_order,
                    int64_t off, int64_t cnt, int f, int num_bins, dim3 grid,
                    int64_t rows_per_block, size_t smem, void* out,
                    cudaStream_t stream) {
  using T = typename Accum<kMode>::T;
  hist_segment_kernel<kMode><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(bins), static_cast<const T*>(gh),
      static_cast<const int32_t*>(row_order), off, cnt, f, num_bins, rows_per_block,
      static_cast<T*>(out));
}

}  // namespace

extern "C" {

// Block geometry, read by the Python wrapper to size its grid.
int hist_group_size() { return kGroup; }
int hist_threads() { return kThreads; }

int hist_full(const void* bins, const void* gh, int64_t n, int f, int num_bins,
              int mode, int groups, int tiles, int64_t rows_per_block, void* out,
              void* stream) {
  const dim3 grid(groups, tiles);
  const size_t smem = static_cast<size_t>(kGroup) * num_bins * 3 * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: launch_full<0>(bins, gh, n, f, num_bins, grid, rows_per_block, smem, out, s); break;
    case 1: launch_full<1>(bins, gh, n, f, num_bins, grid, rows_per_block, smem, out, s); break;
    case 2: launch_full<2>(bins, gh, n, f, num_bins, grid, rows_per_block, smem, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int hist_segment(const void* bins, const void* gh, const void* row_order, int64_t off,
                 int64_t cnt, int f, int num_bins, int mode, int groups, int tiles,
                 int64_t rows_per_block, void* out, void* stream) {
  const dim3 grid(groups, tiles);
  const size_t smem = static_cast<size_t>(kGroup) * num_bins * 3 * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: launch_segment<0>(bins, gh, row_order, off, cnt, f, num_bins, grid, rows_per_block, smem, out, s); break;
    case 1: launch_segment<1>(bins, gh, row_order, off, cnt, f, num_bins, grid, rows_per_block, smem, out, s); break;
    case 2: launch_segment<2>(bins, gh, row_order, off, cnt, f, num_bins, grid, rows_per_block, smem, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
