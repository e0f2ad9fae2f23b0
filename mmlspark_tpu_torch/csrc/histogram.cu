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
// hist_full (full_hist.cuh): threads own features and add their rows in
// order, with no atomic.  A block holds as many features as the opt-in
// shared memory allows (64 at B = 256: all 50 of the flagship's), one
// thread each, in a layout where a warp's adds never meet a bank conflict;
// rows are staged by cp.async a few tiles ahead.  Grid (blocks, groups): the
// blocks of a group take consecutive row ranges of `rows` rows (a multiple
// of 16), as many blocks as the card holds at once, in clusters of cs
// (ops/cuda_histogram.py full_grid; up to 16 blocks a cluster).  After the
// rows, block k of a cluster sums slice k of the cluster's histograms (the
// bins [B k / cs, B (k + 1) / cs)) through distributed shared memory, its
// own first, then the others' in rank order, 16 bytes a load.  With one
// cluster a group the block keeps the sums; with several it stores them as
// a partial, and the last cluster to finish a slice adds the partials in
// cluster order, through tickets, as hist_segment does.  The block then
// writes its slice of `out` (zeros included) from shared memory, each
// feature's cells of the slice one contiguous run.  So every cell is summed in an order that
// the shapes and the card's geometry fix: f32 and bf16 results are the same
// bits on every call, and the caller allocates `out` without a fill.
// cuda_histogram.histogram_ordered states that order in Python.
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
// hist_full is held back by the shared-memory instructions of its adds
// (per row and 32 features about ten: a bin, gh, three loads and three
// stores) issued by the two warps of an SM that hold the flagship's 50
// features; hist_segment by the instructions of its add step and the
// latency of its row gathers, and at a small segment by its launch.
//
// Wide bins (more than 256 bins: int32 codes, as the binning pass writes
// them there).  Both kernels keep their 256-bin code paths and add a
// second instantiation for wide codes.  hist_segment's (seg_hist.cuh,
// kWide) stages four bytes a code and settles equal bins by
// __match_any_sync rounds in lane order instead of tag rows, whose bytes
// grow with B times the warps.  hist_full's layout holds (B + 1) x 3 x 32
// words of histogram a block at least, which passes the 227 KB at about
// 540 bins, so its wide mode, hist_full_wide_kernel, runs the segment
// block step over the identity row range (rows 0 .. n-1 in order, no row
// ids read): one feature takes (3 B + 1) words, so a block holds 17
// features at B = 1,024 and 4 at 4,096, and the widest B is (227 KB - 4
// KB of staging) / 12, about 19,000 (ops/cuda_histogram.py wide_max_bins).
// Both wide modes add every cell in an order that the launch's geometry
// fixes (cuda_histogram.histogram_segment_ordered), with no atomic in the
// float modes, and merge clusters and partials as hist_segment does.  A
// wide call of the full histogram reads each row once per feature group
// (3 groups at 50 features and B = 1,024); its bound at 400,000 x 50,
// B = 1,024 is the 80 MB of codes, 4.8 MB of gh and 0.6 MB out, 25.5 us.
// The wide modes are correct, not tuned: 16-bit codes and a layout of
// their own for the full histogram are later work.
//
// accum modes (hist_block.cuh): 0 = float32; 1 = bfloat16; 2 = int32
// (integer codes, exact).
//
// The kernels allocate nothing, launch on the caller's stream and do not
// synchronise; each entry returns cudaGetLastError() (or the launch's own
// error).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "full_hist.cuh"
#include "hist_block.cuh"
#include "seg_hist.cuh"

namespace {

namespace cg = cooperative_groups;

using hist::Accum;

constexpr int kSegThreads = 1024;  // hist_segment threads per block
constexpr int kCluster = 8;        // largest cluster (the portable size)

template <int kMode>
struct FullArgs {
  const uint8_t* bins;
  const typename Accum<kMode>::T* gh;
  int64_t n;
  int f, num_bins;
  int slots;     // features per group (blockIdx.y: the group)
  int clusters;  // clusters per group
  int64_t rows;  // rows per block
  typename Accum<kMode>::T* out;
  typename Accum<kMode>::T* partial;  // clusters x groups x (B, slots, 3)
  unsigned* tickets;                  // groups x kMaxCluster, clusters > 1
};

// Grid (clusters * cs, groups), clusters of cs blocks along x.  Block x of
// group y adds rows [x * rows, (x + 1) * rows).
template <int kMode>
__global__ void __launch_bounds__(full::kThreads, 1)
hist_full_kernel(const __grid_constant__ FullArgs<kMode> a) {
  using T = typename Accum<kMode>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  T* hist = reinterpret_cast<T*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int cr = static_cast<int>(cluster.block_rank());
  const int q = blockIdx.x / cs;
  const int f0 = blockIdx.y * a.slots;
  const int fg = min(a.slots, a.f - f0);
  const int64_t i0 = min(a.n, static_cast<int64_t>(blockIdx.x) * a.rows);
  const int64_t i1 = min(a.n, i0 + a.rows);
  const int words = full::hist_words(a.slots, a.num_bins);
  full::accumulate_rows<kMode>(a.bins, a.gh, i0, i1, a.f, f0, fg, a.slots, a.num_bins, words,
                               hist, smem_raw + full::hist_bytes(a.slots, a.num_bins));
  cluster.sync();

  // Slice cr of the histogram: the bins [b_lo, b_hi), quads (four words)
  // [pa, pa + na) of the pair plane and [pc, pc + nc) of the count plane.
  // Block cr sums the cluster's slices cr, its own first, then the others'
  // in rank order, 16 bytes a load, kUnroll quads of a thread and kLoads
  // of each in flight.
  constexpr int kUnroll = 4;
  constexpr int kLoads = 4;
  const int b_lo = a.num_bins * cr / cs;
  const int b_hi = a.num_bins * (cr + 1) / cs;
  const int pa = b_lo * a.slots / 2;
  const int na = (b_hi - b_lo) * a.slots / 2;
  const int pc = (full::count_plane(a.slots, a.num_bins) + b_lo * a.slots) / 4;
  const int nc = (b_hi - b_lo) * a.slots / 4;
  const auto quad = [&](int i) { return i < na ? pa + i : pc + i - na; };
  const int64_t plane = static_cast<int64_t>(gridDim.y) * words / 4;  // a cluster's partials
  uint4* own = reinterpret_cast<uint4*>(hist);
  for (int i0 = 0; i0 < na + nc; i0 += kUnroll * blockDim.x) {
    int qd[kUnroll];
    T v[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x + threadIdx.x;
      qd[u] = i < na + nc ? quad(i) : -1;
      if (qd[u] >= 0) full::unpack(own[qd[u]], v[u]);
    }
    for (int p0 = 0; p0 < cs - 1; p0 += kLoads) {
      uint4 x[kUnroll][kLoads];
#pragma unroll
      for (int p = 0; p < kLoads; ++p) {
        const uint4* peer = cluster.map_shared_rank(own, (cr + 1 + p0 + p) % cs);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          x[u][p] = p0 + p < cs - 1 && qd[u] >= 0 ? peer[qd[u]] : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int p = 0; p < kLoads; ++p)
          if (p0 + p < cs - 1) full::add(v[u], x[u][p]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (qd[u] < 0) continue;
      if (a.clusters == 1)
        own[qd[u]] = full::pack(v[u]);
      else
        __stcg(reinterpret_cast<uint4*>(a.partial) + q * plane + blockIdx.y * words / 4 + qd[u],
               full::pack(v[u]));
    }
  }
  cluster.sync();  // no block reads another's histogram past here
  if (a.clusters > 1) {
    // the last cluster to store slice cr adds the partials, in cluster
    // order
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned* ticket = a.tickets + blockIdx.y * full::kMaxCluster + cr;
      last = atomicAdd(ticket, 1u) == static_cast<unsigned>(a.clusters - 1);
      if (last) {
        atomicExch(ticket, 0u);
        __threadfence();
      }
    }
    __syncthreads();
    if (!last) return;
    const uint4* first = reinterpret_cast<const uint4*>(a.partial) + blockIdx.y * words / 4;
    for (int i0 = 0; i0 < na + nc; i0 += kUnroll * blockDim.x) {
      int qd[kUnroll];
      T v[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * blockDim.x + threadIdx.x;
        qd[u] = i < na + nc ? quad(i) : -1;
        v[u][0] = v[u][1] = v[u][2] = v[u][3] = T(0);
      }
      for (int k0 = 0; k0 < a.clusters; k0 += kLoads) {
        uint4 x[kUnroll][kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k)
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            x[u][k] = k0 + k < a.clusters && qd[u] >= 0 ? __ldcg(first + (k0 + k) * plane + qd[u])
                                                         : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int k = 0; k < kLoads; ++k)
            if (k0 + k < a.clusters) full::add(v[u], x[u][k]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (qd[u] >= 0) own[qd[u]] = full::pack(v[u]);
    }
    __syncthreads();
  }
  // the slice's sums, now in this block's histogram, to out: feature j's
  // cells of the slice are the run out[f0 + j, b_lo:b_hi, :]; a warp takes
  // 8 cells of each of 4 features
  const int run = (b_hi - b_lo) * 3;
  const int chunks = (run + 7) / 8;
  const int items = (fg + 3) / 4 * chunks * 32;
  const T* counts = hist + full::count_plane(a.slots, a.num_bins);
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int lane = i & 31;
    const int wi = i >> 5;
    const int j = wi / chunks * 4 + (lane >> 3);
    const int k = (wi % chunks) * 8 + (lane & 7);
    if (j >= fg || k >= run) continue;
    const int b = b_lo + k / 3;
    const int c = k - (k / 3) * 3;
    const int cell = b * a.slots + j;
    a.out[(static_cast<int64_t>(f0 + j) * a.num_bins + b_lo) * 3 + k] =
        c < 2 ? hist[2 * cell + c] : counts[cell];
  }
}

template <int kMode>
struct SegArgs {
  const void* bins;  // uint8 codes, or int32 in the wide modes
  const typename Accum<kMode>::T* gh;
  const int32_t* row_order;  // null in hist_full's wide mode: rows in order
  int64_t off, cnt;
  int f, num_bins;
  int group;     // features per block (blockIdx.y: the group)
  int replicas;  // histogram copies per block
  int clusters;  // clusters per group
  typename Accum<kMode>::T* out;
  typename Accum<kMode>::T* partial;  // clusters x (f, B, 3), clusters > 1
  unsigned* tickets;                  // groups x kMaxCluster, clusters > 1
};

// Grid (clusters * cs, groups), clusters of cs blocks along x.  Block x of
// group y adds rows [x * rows, (x + 1) * rows) of the segment.
template <int kMode, bool kWide>
__device__ __forceinline__ void segment_body(const SegArgs<kMode>& a, unsigned char* smem_raw,
                                             int& last) {
  using T = typename Accum<kMode>::T;
  const seg::Smem<T> sm = seg::carve<T, kWide>(smem_raw, a.group, a.num_bins);
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
  seg::accumulate_rows<kMode, kWide>(static_cast<const seg::Code<kWide>*>(a.bins), a.gh,
                                     a.row_order, a.off, i0, i1, a.f, f0, fg, a.num_bins,
                                     a.replicas, sm);
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

template <int kMode, bool kWide>
__global__ void __launch_bounds__(kSegThreads, 1)
hist_segment_kernel(const __grid_constant__ SegArgs<kMode> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  segment_body<kMode, kWide>(a, smem_raw, last);
}

// hist_full's wide mode: the segment block step over rows 0 .. n-1 in
// order (a.row_order null, a.off 0, a.cnt n).
template <int kMode>
__global__ void __launch_bounds__(kSegThreads, 1)
hist_full_wide_kernel(const __grid_constant__ SegArgs<kMode> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  segment_body<kMode, true>(a, smem_raw, last);
}

const void* full_kernel(int mode) {
  switch (mode) {
    case 0: return reinterpret_cast<const void*>(hist_full_kernel<0>);
    case 1: return reinterpret_cast<const void*>(hist_full_kernel<1>);
    case 2: return reinterpret_cast<const void*>(hist_full_kernel<2>);
    default: return nullptr;
  }
}

// The segment block step's kernels by `mode + 3 * variant`: variant 0,
// hist_segment; 1, hist_segment on wide codes; 2, hist_full's wide mode.
constexpr int kSegVariants = 3;
const void* segment_kernel(int kind) {
  switch (kind) {
    case 0: return reinterpret_cast<const void*>(hist_segment_kernel<0, false>);
    case 1: return reinterpret_cast<const void*>(hist_segment_kernel<1, false>);
    case 2: return reinterpret_cast<const void*>(hist_segment_kernel<2, false>);
    case 3: return reinterpret_cast<const void*>(hist_segment_kernel<0, true>);
    case 4: return reinterpret_cast<const void*>(hist_segment_kernel<1, true>);
    case 5: return reinterpret_cast<const void*>(hist_segment_kernel<2, true>);
    case 6: return reinterpret_cast<const void*>(hist_full_wide_kernel<0>);
    case 7: return reinterpret_cast<const void*>(hist_full_wide_kernel<1>);
    case 8: return reinterpret_cast<const void*>(hist_full_wide_kernel<2>);
    default: return nullptr;
  }
}

cudaLaunchConfig_t cluster_config(dim3 grid, int threads, int cs, size_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
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

// variant: as segment_kernel's.
template <int kMode>
int launch_segment(int variant, const void* bins, const void* gh, const void* row_order,
                   int64_t off, int64_t cnt, int f, int num_bins, int group, int replicas,
                   int clusters, int cs, void* out, void* partial, void* tickets,
                   cudaStream_t stream) {
  using T = typename Accum<kMode>::T;
  SegArgs<kMode> a;
  a.bins = bins;
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
  const size_t smem = seg::smem_bytes(group, replicas, num_bins, kSegThreads / 32, variant > 0);
  cudaLaunchAttribute attr;
  const dim3 grid(clusters * cs, (f + group - 1) / group);
  const cudaLaunchConfig_t cfg = cluster_config(grid, kSegThreads, cs, smem, stream, &attr);
  const cudaError_t e =
      variant == 0   ? cudaLaunchKernelEx(&cfg, hist_segment_kernel<kMode, false>, a)
      : variant == 1 ? cudaLaunchKernelEx(&cfg, hist_segment_kernel<kMode, true>, a)
                     : cudaLaunchKernelEx(&cfg, hist_full_wide_kernel<kMode>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int launch_full(const void* bins, const void* gh, int64_t n, int f, int num_bins, int slots,
                int cs, int clusters, int64_t rows, void* out, void* partial, void* tickets,
                cudaStream_t stream) {
  using T = typename Accum<kMode>::T;
  FullArgs<kMode> a;
  a.bins = static_cast<const uint8_t*>(bins);
  a.gh = static_cast<const T*>(gh);
  a.n = n;
  a.f = f;
  a.num_bins = num_bins;
  a.slots = slots;
  a.clusters = clusters;
  a.rows = rows;
  a.out = static_cast<T*>(out);
  a.partial = static_cast<T*>(partial);
  a.tickets = static_cast<unsigned*>(tickets);
  cudaLaunchAttribute attr;
  const dim3 grid(clusters * cs, (f + slots - 1) / slots);
  const cudaLaunchConfig_t cfg = cluster_config(grid, full::kThreads, cs,
                                                full::smem_bytes(slots, num_bins), stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, hist_full_kernel<kMode>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory the kernels of `kernel(k)`, k = 0 .. count - 1,
// may use on the current device, made their limit; or minus a cudaError.
int setup_kernels(const void* (*kernel)(int), int count) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int budget = optin;
  for (int k = 0; k < count; ++k) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel(k));
    if (e != cudaSuccess) return -static_cast<int>(e);
    const int dyn = optin - static_cast<int>(attr.sharedSizeBytes);
    budget = dyn < budget ? dyn : budget;
  }
  for (int k = 0; k < count; ++k) {
    e = cudaFuncSetAttribute(kernel(k), cudaFuncAttributeMaxDynamicSharedMemorySize, budget);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  return budget;
}

}  // namespace

extern "C" {

// Block geometry, checked against ops/cuda_histogram.py at load.
int hist_full_threads() { return full::kThreads; }
int hist_full_slot_align() { return full::kSlotAlign; }
int hist_full_row_align() { return full::kRowAlign; }
int hist_full_stages() { return full::kStages; }
int hist_full_stage_bytes() { return full::kStageBytes; }
int hist_full_cluster() { return full::kMaxCluster; }
int hist_segment_threads() { return kSegThreads; }
int hist_segment_cluster() { return kCluster; }
int hist_segment_pad() { return seg::kPad; }
int hist_segment_max_group() { return seg::kMaxGroup; }
int hist_segment_warp_rows() { return seg::kWarpRows; }

// Shared-memory bytes of a hist_full block (full_hist.cuh's layout).
int64_t hist_full_smem(int slots, int num_bins) {
  return static_cast<int64_t>(full::smem_bytes(slots, num_bins));
}

// Shared-memory bytes of a hist_segment block (seg_hist.cuh's layout).
int64_t hist_segment_smem(int group, int replicas, int num_bins) {
  return static_cast<int64_t>(seg::smem_bytes(group, replicas, num_bins, kSegThreads / 32));
}

// The same in the wide modes (int32 codes, no tag rows).
int64_t hist_segment_wide_smem(int group, int replicas, int num_bins) {
  return static_cast<int64_t>(
      seg::smem_bytes(group, replicas, num_bins, kSegThreads / 32, true));
}

// Lets hist_full use the opt-in shared memory of the current device; call
// once per device before any hist_full_capacity or launch.  Returns the
// dynamic shared-memory bytes a block may use, or minus a cudaError.
int hist_full_setup() {
  const int budget = setup_kernels(full_kernel, 3);
  for (int mode = 0; budget > 0 && mode < 3; ++mode) {
    const cudaError_t e =
        cudaFuncSetAttribute(full_kernel(mode), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  return budget;
}

// What the current device holds at once of hist_full blocks of `slots`
// features and `num_bins` bins: *blocks of them, and fits[k] clusters of
// 2^k of them, k = 0 .. 4.  Returns a cudaError.
int hist_full_capacity(int mode, int slots, int num_bins, int* blocks, int* fits) {
  const void* kernel = full_kernel(mode);
  if (!kernel || slots < 1 || num_bins < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = full::smem_bytes(slots, num_bins);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, full::kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int k = 0; (1 << k) <= full::kMaxCluster; ++k) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(dim3(1 << k), full::kThreads, 1 << k, smem, nullptr, &attr);
    e = cudaOccupancyMaxActiveClusters(fits + k, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *blocks = per_sm * sms;
  return 0;
}

// The histogram of the whole (n, f) matrix (n >= 0): groups of `slots`
// features (grid y), `clusters` clusters of `cs` blocks a group, `rows`
// rows a block.  clusters > 1 needs `partial` (clusters x groups x
// (num_bins + 1) x slots x 3 words) and `tickets` (groups x kMaxCluster words,
// zero).  `out` needs no zeroing.
int hist_full(const void* bins, const void* gh, int64_t n, int f, int num_bins, int mode,
              int slots, int cs, int clusters, int64_t rows, void* out, void* partial,
              void* tickets, void* stream) {
  if (n < 0 || f < 1 || num_bins < 1 || num_bins > 256 || slots < full::kSlotAlign ||
      slots > full::kMaxSlots || slots % full::kSlotAlign != 0 || cs < 1 ||
      cs > full::kMaxCluster ||
      clusters < 1 || rows < 1 || rows % full::kRowAlign != 0 ||
      (clusters > 1 && (!partial || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_full<0>(bins, gh, n, f, num_bins, slots, cs, clusters, rows, out, partial, tickets, s);
    case 1: return launch_full<1>(bins, gh, n, f, num_bins, slots, cs, clusters, rows, out, partial, tickets, s);
    case 2: return launch_full<2>(bins, gh, n, f, num_bins, slots, cs, clusters, rows, out, partial, tickets, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Lets hist_segment and the wide modes of both histograms use the opt-in
// shared memory of the current device; call once per device before any
// hist_segment_capacity or launch.  Returns the dynamic shared-memory
// bytes a block may use, or minus a cudaError.
int hist_segment_setup() { return setup_kernels(segment_kernel, 3 * kSegVariants); }

// What the current device holds at once of blocks with `smem` bytes of
// shared memory of the kernel `kind` (segment_kernel's mode + 3 x
// variant): *blocks of them, and *clusters clusters of kCluster of them.
// Returns a cudaError.
int hist_segment_capacity(int kind, int smem, int* blocks, int* clusters) {
  const void* kernel = segment_kernel(kind);
  if (!kernel || smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSegThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(kCluster), kSegThreads, kCluster, smem, nullptr, &attr);
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
    case 0: return launch_segment<0>(0, bins, gh, row_order, off, cnt, f, num_bins, group, replicas, clusters, cs, out, partial, tickets, s);
    case 1: return launch_segment<1>(0, bins, gh, row_order, off, cnt, f, num_bins, group, replicas, clusters, cs, out, partial, tickets, s);
    case 2: return launch_segment<2>(0, bins, gh, row_order, off, cnt, f, num_bins, group, replicas, clusters, cs, out, partial, tickets, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The wide modes, on (n, f) int32 codes and any num_bins >= 1 whose block
// fits: with row_order, the segment's histogram as hist_segment computes
// it (variant 1); without (null), hist_full's wide mode over the rows
// off .. off + cnt - 1 (variant 2).  Arguments as hist_segment's.
int hist_wide(const void* bins, const void* gh, const void* row_order, int64_t off,
              int64_t cnt, int f, int num_bins, int mode, int group, int replicas,
              int clusters, int cs, void* out, void* partial, void* tickets, void* stream) {
  if (cnt < 1 || f < 1 || num_bins < 1 || group < 1 || group > seg::kMaxGroup ||
      replicas < 1 || clusters < 1 || cs < 1 || cs > kCluster ||
      (clusters > 1 && (!partial || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int variant = row_order ? 1 : 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_segment<0>(variant, bins, gh, row_order, off, cnt, f, num_bins, group, replicas, clusters, cs, out, partial, tickets, s);
    case 1: return launch_segment<1>(variant, bins, gh, row_order, off, cnt, f, num_bins, group, replicas, clusters, cs, out, partial, tickets, s);
    case 2: return launch_segment<2>(variant, bins, gh, row_order, off, cnt, f, num_bins, group, replicas, clusters, cs, out, partial, tickets, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
