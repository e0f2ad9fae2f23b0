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
//
// Layout: the binned matrix is the row-major (n, f) uint8 matrix the
// binning pass produces.  A segment gather then reads one contiguous f-byte
// row per row id (two 32-byte sectors at f = 50) instead of f scattered
// bytes of a transposed copy, and the full histogram reads the same matrix
// without a transposed copy on the card.
//
// hist_full: each block keeps a privatised (8, B, 3) histogram in shared
// memory (hist_block.cuh), its threads stride over a tile of rows and
// atomicAdd into shared memory, and the block then flushes its non-zero
// cells into the output with global atomicAdd -- the design of LightGBM's
// CUDA learner and XGBoost's gpu_hist.  The caller zeroes `out`.
//
// hist_segment (seg_hist.cuh): a block holds as many features as the
// opt-in shared memory allows beside its staging tile (all 50 at the
// flagship's f = 50, B = 256: 203 KB), so each row of the segment is
// gathered once per group; rows are staged 256 at a time (8 a warp, the
// next tile's loads in flight while a tile is added), each feature is
// owned by one warp, and equal bins within a warp are settled without
// float atomics (see seg_hist.cuh).  The add step is bound by shared-
// memory traffic per SM, so the grid follows the segment to spread it:
// ceil(cnt / 256) blocks a group, no more than the card holds at once, and
// the card's other blocks take narrower feature groups (down to 4
// features), so a small segment runs one block a group on many SMs while
// a large one keeps the widest group (ops/cuda_histogram.py seg_grid).
// The group's width is a launch argument.  The blocks of a group form
// thread block clusters (at most 8): after the rows, block k of a cluster
// sums slice k of the cluster's histograms through distributed shared
// memory.  One cluster writes its sums straight into `out`, zeros
// included, with plain stores, so the caller allocates `out` without a
// fill.  Several clusters each store their partial into a workspace
// (clusters x f x B x 3 words), and per slice k a ticket counts the
// clusters that have stored it; the last to arrive adds the partials in
// cluster order, writes `out` and resets the ticket.  The merge moves 2 x
// clusters x f x B x 12 bytes through L2 (15 clusters at f = 50: 4.6 MB),
// in place of the old per-block global atomics (3.3 M at 200,000 rows).
// The workspace and tickets belong to one stream: calls on one stream
// are ordered, so the tickets are zero at every launch.

// Bound at the flagship shapes (n = 400,000, f = 50, B = 256, H100 at
// 3.35 TB/s): hist_full must read 20 MB of bins and 4.8 MB of gh and write
// 154 KB, 7.5 us; its 60 M adds are 0.9 us at the 67 TFLOP/s f32 rate, so
// it is bound by bytes.  hist_segment at cnt = 200,000 must read 10 MB of
// bins, 2.4 MB of gh and 0.8 MB of row ids and write 154 KB, 4.0 us.
// hist_full is held back by shared-memory atomic throughput (3 float
// atomics, each a compare-and-swap loop, per row and feature);
// hist_segment by the instructions of its add step (a few shared-memory
// operations per row and feature) and the latency of its row gathers, and
// at a small segment by its launch.
//
// accum modes (hist_block.cuh): 0 = float32; 1 = bfloat16; 2 = int32
// (integer codes, exact).  Float atomics make f32 sums depend on the
// order the rows arrive in, run to run; int32 sums are exact.
//
// The kernels allocate nothing, launch on the caller's stream and do not
// synchronise; each entry returns cudaGetLastError() (or the launch's own
// error).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"
#include "seg_hist.cuh"

namespace {

namespace cg = cooperative_groups;

using hist::Accum;
using hist::kGroup;
using hist::kThreads;

constexpr int kSegThreads = 1024;  // hist_segment threads per block
constexpr int kCluster = 8;        // largest cluster (the portable size)

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
struct SegArgs {
  const uint8_t* bins;
  const typename Accum<kMode>::T* gh;
  const int32_t* row_order;
  int64_t off, cnt;
  int f, num_bins;
  int group;     // features per block (blockIdx.y: the group)
  int replicas;  // histogram copies per block
  int clusters;  // clusters per group
  typename Accum<kMode>::T* out;
  typename Accum<kMode>::T* partial;  // clusters x (f, B, 3), clusters > 1
  unsigned* tickets;                  // groups x kCluster, clusters > 1
};

// Grid (clusters * cs, groups), clusters of cs blocks along x.  Block x of
// group y adds rows [x * rows, (x + 1) * rows) of the segment.
template <int kMode>
__global__ void __launch_bounds__(kSegThreads, 1)
hist_segment_kernel(const __grid_constant__ SegArgs<kMode> a) {
  using T = typename Accum<kMode>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const seg::Smem<T> sm = seg::carve<T>(smem_raw, a.group, a.num_bins);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int cr = static_cast<int>(cluster.block_rank());
  const int q = blockIdx.x / cs;
  const int stride = seg::feature_words(a.num_bins);
  const int f0 = blockIdx.y * a.group;
  const int fg = min(a.group, a.f - f0);
  const int64_t rows = (a.cnt + gridDim.x - 1) / gridDim.x;
  const int64_t i0 = min(a.cnt, blockIdx.x * rows);
  const int64_t i1 = min(a.cnt, i0 + rows);
  seg::zero_hist(sm.hist, a.replicas * fg * stride);
  seg::accumulate_rows<kMode>(a.bins, a.gh, a.row_order, a.off, i0, i1, a.f, f0, fg,
                              a.num_bins, a.replicas, sm);
  cluster.sync();

  // block cr sums slice cr of the cluster's histograms, its own first,
  // then the others' in rank order
  const int inner = a.num_bins * 3;
  const int cells = fg * inner;
  const int lo = static_cast<int>(static_cast<int64_t>(cells) * cr / cs);
  const int hi = static_cast<int>(static_cast<int64_t>(cells) * (cr + 1) / cs);
  const int64_t base = static_cast<int64_t>(f0) * inner;
  const int64_t plane = static_cast<int64_t>(a.f) * inner;
  const auto peer = [&](int p) -> const T* {
    return cluster.map_shared_rank(sm.hist, (cr + 1 + p) % cs);
  };
  if (a.clusters == 1) {
    T* dst = a.out + base;
    seg::for_cells(sm.hist, lo, hi, fg, inner, stride, a.replicas, peer, cs - 1,
                   [&](int i, T v) { dst[i] = v; });
  } else {
    T* dst = a.partial + q * plane + base;
    seg::for_cells(sm.hist, lo, hi, fg, inner, stride, a.replicas, peer, cs - 1,
                   [&](int i, T v) { __stcg(dst + i, v); });
  }
  cluster.sync();  // no block leaves while another reads its histogram
  if (a.clusters == 1) return;

  // the last cluster to store slice cr adds the partials, in cluster
  // order, and writes out
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* ticket = a.tickets + blockIdx.y * kCluster + cr;
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(a.clusters - 1);
    if (last) {
      atomicExch(ticket, 0u);
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    T v = T(0);
    for (int k = 0; k < a.clusters; ++k) v += __ldcg(a.partial + k * plane + base + i);
    a.out[base + i] = v;
  }
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

const void* segment_kernel(int mode) {
  switch (mode) {
    case 0: return reinterpret_cast<const void*>(hist_segment_kernel<0>);
    case 1: return reinterpret_cast<const void*>(hist_segment_kernel<1>);
    case 2: return reinterpret_cast<const void*>(hist_segment_kernel<2>);
    default: return nullptr;
  }
}

cudaLaunchConfig_t segment_config(dim3 grid, int cs, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kSegThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int kMode>
int launch_segment(const void* bins, const void* gh, const void* row_order, int64_t off,
                   int64_t cnt, int f, int num_bins, int group, int replicas, int clusters,
                   int cs, void* out, void* partial, void* tickets, cudaStream_t stream) {
  using T = typename Accum<kMode>::T;
  SegArgs<kMode> a;
  a.bins = static_cast<const uint8_t*>(bins);
  a.gh = static_cast<const T*>(gh);
  a.row_order = static_cast<const int32_t*>(row_order);
  a.off = off;
  a.cnt = cnt;
  a.f = f;
  a.num_bins = num_bins;
  a.group = group;
  a.replicas = replicas;
  a.clusters = clusters;
  a.out = static_cast<T*>(out);
  a.partial = static_cast<T*>(partial);
  a.tickets = static_cast<unsigned*>(tickets);
  const size_t smem = seg::smem_bytes(group, replicas, num_bins, kSegThreads / 32);
  cudaLaunchAttribute attr;
  const dim3 grid(clusters * cs, (f + group - 1) / group);
  const cudaLaunchConfig_t cfg = segment_config(grid, cs, smem, stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, hist_segment_kernel<kMode>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Block geometry, read by the Python wrapper to size its grid.
int hist_group_size() { return kGroup; }
int hist_threads() { return kThreads; }
int hist_segment_threads() { return kSegThreads; }
int hist_segment_cluster() { return kCluster; }
int hist_segment_pad() { return seg::kPad; }
int hist_segment_max_group() { return seg::kMaxGroup; }
int hist_segment_warp_rows() { return seg::kWarpRows; }

// Shared-memory bytes of a hist_segment block (seg_hist.cuh's layout).
int64_t hist_segment_smem(int group, int replicas, int num_bins) {
  return static_cast<int64_t>(seg::smem_bytes(group, replicas, num_bins, kSegThreads / 32));
}

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

// Lets hist_segment use the opt-in shared memory of the current device;
// call once per device before any hist_segment_capacity or launch.
// Returns the dynamic shared-memory bytes a block may use, or minus a
// cudaError.
int hist_segment_setup() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int budget = optin;
  for (int mode = 0; mode < 3; ++mode) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, segment_kernel(mode));
    if (e != cudaSuccess) return -static_cast<int>(e);
    const int dyn = optin - static_cast<int>(attr.sharedSizeBytes);
    budget = dyn < budget ? dyn : budget;
  }
  for (int mode = 0; mode < 3; ++mode) {
    e = cudaFuncSetAttribute(segment_kernel(mode), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             budget);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  return budget;
}

// What the current device holds at once of hist_segment blocks with `smem`
// bytes of shared memory: *blocks of them, and *clusters clusters of
// kCluster of them.  Returns a cudaError.
int hist_segment_capacity(int mode, int smem, int* blocks, int* clusters) {
  const void* kernel = segment_kernel(mode);
  if (!kernel || smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSegThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = segment_config(dim3(kCluster), kCluster, smem, nullptr, &attr);
  e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = per_sm * sms;
  return 0;
}

// The histogram of rows row_order[off + i], i < cnt (cnt >= 1): groups of
// `group` features (grid y), each block with `replicas` histogram copies,
// `clusters` clusters of `cs` blocks a group.  clusters > 1 needs
// `partial` (clusters x f x num_bins x 3 words) and `tickets` (groups x
// kCluster words, zero).  `out` needs no zeroing.
int hist_segment(const void* bins, const void* gh, const void* row_order, int64_t off,
                 int64_t cnt, int f, int num_bins, int mode, int group, int replicas,
                 int clusters, int cs, void* out, void* partial, void* tickets, void* stream) {
  if (cnt < 1 || f < 1 || num_bins < 1 || num_bins > 256 || group < 1 ||
      group > seg::kMaxGroup || replicas < 1 || clusters < 1 || cs < 1 || cs > kCluster ||
      (clusters > 1 && (!partial || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_segment<0>(bins, gh, row_order, off, cnt, f, num_bins, group, replicas, clusters, cs, out, partial, tickets, s);
    case 1: return launch_segment<1>(bins, gh, row_order, off, cnt, f, num_bins, group, replicas, clusters, cs, out, partial, tickets, s);
    case 2: return launch_segment<2>(bins, gh, row_order, off, cnt, f, num_bins, group, replicas, clusters, cs, out, partial, tickets, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
