// The segment-histogram block step shared by csrc/histogram.cu
// (hist_segment) and csrc/ring.cu (fused_hist_ring, phase 1): one block
// adds the rows row_order[off + i], i in [i0, i1), of a segment into a
// shared-memory histogram of the features [f0, f0 + fg).
//
// Shared memory (carve): a staging tile of kWarpRows rows a warp -- their
// (g, h, c) and their bin bytes of the group, `row_bytes` a row -- then two
// tag rows of num_bins bytes a warp, then `replicas` copies of the group's
// histogram, feature j of copy q at words (q * fg + j) * stride, stride =
// num_bins * 3 + kPad, cell (j, b, c) at + b * 3 + c.  The group is as wide
// as the opt-in shared memory allows, at most kMaxGroup = 64 features (all
// 50 of the flagship's f = 50 at B = 256; 63 at B = 256 in 227 KB), so a row
// is gathered once per group instead of once per eight features.
//
// Stage.  Each warp copies kWarpRows rows a tile into shared memory: its
// lanes load the rows' ids at once, then every row's bin bytes with the
// lanes across the row's features (neighbouring lanes on neighbouring
// bytes) and the rows' gh, all in flight together, into registers.  The
// next tile's loads are issued before this tile is added, and the ids of
// the one after that, so the gathers' latency hides behind the adds.
//
// Add.  Warp w owns the (copy, feature) units w, w + W, ...; copy q of a
// feature takes the tile's 32-row chunks q, q + replicas, ...  For a
// chunk, lane l reads row l's bin of the feature and its gh from the tile
// (odd word strides: no bank conflicts).  No other warp writes the unit,
// so the lanes need only settle among themselves who adds to a bin:
// - float32 and bfloat16: each lane with a bin writes its lane number into
//   the warp's tag row at that bin and reads it back; the lanes that read
//   their own number hold distinct bins and add with plain loads and
//   stores, the others try again.  A chunk takes as many rounds as its
//   most repeated bin has rows (one or two on spread bins, 32 when every
//   row holds one bin).  A warp with two features runs their rounds
//   together (a tag row each).  This card's shared memory has no native
//   float atomic add (a float atomicAdd there is a compare-and-swap loop,
//   which measured slower than the rounds, as did __match_any_sync).
// - int32: a native shared-memory atomicAdd.
//
// Wide bins (kWide: more than 256 bins).  The codes are int32, four bytes
// a feature in the staging tile (row_bytes: an odd number of words, so 32
// rows of one feature still lie on 32 banks).  There are no tag rows:
// their num_bins bytes a warp would take 256 KB at 4,096 bins and 32
// warps.  Instead the lanes with equal bins find each other with
// __match_any_sync and add in rounds in lane order (round r: the lanes
// with r lower lanes of their bin), so each cell adds its rows in row
// order within a chunk, chunks in order: the order is fixed by the
// launch's geometry alone (cuda_histogram.histogram_segment_ordered states
// it).  int32 keeps its atomicAdd.  A null row_order reads the rows off,
// off + 1, ... in order: hist_full's wide mode runs this block step over
// the identity row range.
//
// accum modes (hist_block.cuh's Accum): 0 = float32; 1 = bfloat16 (gh
// rounded to bf16, summed in f32); 2 = int32 (exact).  Out-of-range bins
// are dropped.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hist_block.cuh"

namespace seg {

using hist::Accum;

// The type of a bin code: a byte up to 256 bins, int32 above (kWide).
template <bool kWide>
using Code = typename std::conditional<kWide, int32_t, uint8_t>::type;

constexpr int kPad = 1;                // words after each feature's cells
constexpr int kMaxJ = 2;               // bin bytes a lane stages per row
constexpr int kMaxGroup = 32 * kMaxJ;  // features per block
constexpr int kWarpRows = 8;           // rows a warp stages per tile

// Words of shared memory per feature.
__host__ __device__ __forceinline__ int feature_words(int num_bins) { return num_bins * 3 + kPad; }

// Staged bytes per row for a group of `group` features (codes of one
// byte, or four when wide): an odd number of words, so 32 rows' codes of
// one feature lie on 32 banks.
__host__ __device__ __forceinline__ int row_bytes(int group, bool wide = false) {
  return 4 * (((group * (wide ? 4 : 1) + 3) / 4) | 1);
}

// Bytes of the staging tile (kWarpRows rows a warp) and the tag rows (two
// of num_bins bytes a warp; none when wide) of a block of `warps` warps.
__host__ __device__ __forceinline__ size_t head_bytes(int group, int num_bins, int warps,
                                                      bool wide = false) {
  return static_cast<size_t>(kWarpRows) * warps * (12 + row_bytes(group, wide)) +
         (wide ? 0 : static_cast<size_t>(warps) * 2 * ((num_bins + 3) / 4 * 4));
}

// Bytes of shared memory a block of `warps` warps, `group` features and
// `replicas` histogram copies uses.
__host__ __device__ __forceinline__ size_t smem_bytes(int group, int replicas, int num_bins,
                                                      int warps, bool wide = false) {
  return head_bytes(group, num_bins, warps, wide) +
         static_cast<size_t>(replicas) * group * feature_words(num_bins) * 4;
}

template <typename T>
struct Smem {
  T* gh;          // (tile rows, 3)
  uint8_t* bins;  // (tile rows, row_bytes)
  uint8_t* tags;  // (warps, 2, num_bins rounded up to 4); none when wide
  T* hist;        // (replicas, fg, stride)
  int row_bytes;
};

template <typename T, bool kWide = false>
__device__ __forceinline__ Smem<T> carve(unsigned char* smem, int group, int num_bins) {
  Smem<T> s;
  const int rows = kWarpRows * (blockDim.x >> 5);
  s.row_bytes = row_bytes(group, kWide);
  s.gh = reinterpret_cast<T*>(smem);
  s.bins = smem + rows * 12;
  s.tags = smem + rows * (12 + s.row_bytes);
  s.hist = reinterpret_cast<T*>(smem + head_bytes(group, num_bins, blockDim.x >> 5, kWide));
  return s;
}

// Zeroes the first `words` words of `hist` (16-byte aligned); ends with a
// barrier.
template <typename T>
__device__ __forceinline__ void zero_hist(T* hist, int words) {
  int4* h4 = reinterpret_cast<int4*>(hist);
  const int n4 = words / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) h4[i] = make_int4(0, 0, 0, 0);
  for (int i = n4 * 4 + threadIdx.x; i < words; i += blockDim.x) hist[i] = T(0);
  __syncthreads();
}

// Adds the (g, h, c) of each lane into two features' cells: `cells0` at
// its bin b0 and `cells1` at b1 (a bin < 0: nothing), the two features'
// rounds interleaved (see the note at the top); tag0, tag1: the warp's tag
// rows.
template <int kMode>
__device__ __forceinline__ void add_pair(typename Accum<kMode>::T* cells0,
                                         typename Accum<kMode>::T* cells1, uint8_t* tag0,
                                         uint8_t* tag1, int b0, int b1,
                                         typename Accum<kMode>::T g,
                                         typename Accum<kMode>::T h,
                                         typename Accum<kMode>::T c) {
  using T = typename Accum<kMode>::T;
  constexpr unsigned kAll = 0xffffffffu;
  if (kMode == 2) {
    if (b0 >= 0) {
      atomicAdd(cells0 + b0 * 3 + 0, g);
      atomicAdd(cells0 + b0 * 3 + 1, h);
      atomicAdd(cells0 + b0 * 3 + 2, c);
    }
    if (b1 >= 0) {
      atomicAdd(cells1 + b1 * 3 + 0, g);
      atomicAdd(cells1 + b1 * 3 + 1, h);
      atomicAdd(cells1 + b1 * 3 + 2, c);
    }
    return;
  }
  const uint8_t lane = static_cast<uint8_t>(threadIdx.x & 31);
  bool p0 = b0 >= 0, p1 = b1 >= 0;
  while (__any_sync(kAll, p0 || p1)) {
    if (p0) tag0[b0] = lane;
    if (p1) tag1[b1] = lane;
    __syncwarp();
    if (p0 && tag0[b0] == lane) {
      T* cell = cells0 + b0 * 3;
      cell[0] += g;
      cell[1] += h;
      cell[2] += c;
      p0 = false;
    }
    if (p1 && tag1[b1] == lane) {
      T* cell = cells1 + b1 * 3;
      cell[0] += g;
      cell[1] += h;
      cell[2] += c;
      p1 = false;
    }
    __syncwarp();
  }
}

// add_pair of the wide mode: no tag rows.  The lanes of one bin add in
// rounds in lane order: round r, the lanes with r lower lanes of their bin
// (__match_any_sync), so the lanes of a round hold distinct bins.
template <int kMode>
__device__ __forceinline__ void add_pair_wide(typename Accum<kMode>::T* cells0,
                                              typename Accum<kMode>::T* cells1, int b0, int b1,
                                              typename Accum<kMode>::T g,
                                              typename Accum<kMode>::T h,
                                              typename Accum<kMode>::T c) {
  using T = typename Accum<kMode>::T;
  constexpr unsigned kAll = 0xffffffffu;
  if (kMode == 2) {
    if (b0 >= 0) {
      atomicAdd(cells0 + b0 * 3 + 0, g);
      atomicAdd(cells0 + b0 * 3 + 1, h);
      atomicAdd(cells0 + b0 * 3 + 2, c);
    }
    if (b1 >= 0) {
      atomicAdd(cells1 + b1 * 3 + 0, g);
      atomicAdd(cells1 + b1 * 3 + 1, h);
      atomicAdd(cells1 + b1 * 3 + 2, c);
    }
    return;
  }
  const unsigned lower = (1u << (threadIdx.x & 31)) - 1u;
  const unsigned m0 = __match_any_sync(kAll, b0);
  const unsigned m1 = __match_any_sync(kAll, b1);
  const int r0 = b0 >= 0 ? __popc(m0 & lower) : -1;
  const int r1 = b1 >= 0 ? __popc(m1 & lower) : -1;
  const int rounds = static_cast<int>(__reduce_max_sync(kAll, static_cast<unsigned>(max(r0, r1) + 1)));
  for (int r = 0; r < rounds; ++r) {
    if (r0 == r) {
      T* cell = cells0 + b0 * 3;
      cell[0] += g;
      cell[1] += h;
      cell[2] += c;
    }
    if (r1 == r) {
      T* cell = cells1 + b1 * 3;
      cell[0] += g;
      cell[1] += h;
      cell[2] += c;
    }
    __syncwarp();
  }
}

// One tile's rows of a warp (kWarpRows of them, `mine` real) in
// registers, on their way from device memory to the staging tile: each
// lane's bytes j = lane and lane + 32 of every row, and one of the rows'
// (g, h, c) values (lanes 0 .. 3 * kWarpRows - 1).
template <typename T>
struct Staged {
  int v[kWarpRows][kMaxJ];
  T gh;
  int mine;
};

// Issues the loads of a warp's tile rows (ids in lanes 0 .. mine-1 of rid).
template <int kMode, bool kWide = false>
__device__ __forceinline__ void stage_load(const Code<kWide>* __restrict__ bins,
                                           const typename Accum<kMode>::T* __restrict__ gh,
                                           int32_t rid, int mine, int f, int f0, int fg,
                                           Staged<typename Accum<kMode>::T>& st) {
  using T = typename Accum<kMode>::T;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  st.mine = mine;
#pragma unroll
  for (int u = 0; u < kWarpRows; ++u) {
    const int32_t rk = __shfl_sync(kAll, rid, u);
    const Code<kWide>* row = bins + static_cast<int64_t>(rk) * f + f0;
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      const int j = lane + 32 * jj;
      st.v[u][jj] = (u < mine && j < fg) ? static_cast<int>(__ldg(row + j)) : 0;
    }
  }
  const int k = lane < 3 * kWarpRows ? lane / 3 : 0;
  const int32_t rk = __shfl_sync(kAll, rid, k);
  st.gh = (lane < 3 * kWarpRows && k < mine)
              ? Accum<kMode>::load(gh + static_cast<int64_t>(rk) * 3 + (lane - 3 * k))
              : T(0);
}

// Writes a warp's staged rows into the tile at rows r0 ...
template <typename T, bool kWide = false>
__device__ __forceinline__ void stage_store(const Staged<T>& st, int fg, int r0, const Smem<T>& s) {
  using C = Code<kWide>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kWarpRows; ++u) {
    C* row = reinterpret_cast<C*>(s.bins + (r0 + u) * s.row_bytes);
#pragma unroll
    for (int jj = 0; jj < kMaxJ; ++jj) {
      const int j = lane + 32 * jj;
      if (u < st.mine && j < fg) row[j] = static_cast<C>(st.v[u][jj]);
    }
  }
  if (lane < 3 * kWarpRows && lane / 3 < st.mine) s.gh[r0 * 3 + lane] = st.gh;
}

// Adds the rows row_order[off + i], i in [i0, i1), features [f0, f0 + fg)
// (fg <= kMaxGroup) of the (n, f) bins and (n, 3) gh into the `replicas`
// copies of the histogram in `s` (zeroed by the caller), a tile of
// kWarpRows rows a warp at a time: the next tile's rows are loaded into
// registers while this tile is added.  kWide: int32 codes, the rounds of
// add_pair_wide, and a null row_order reads rows off + i.  Ends with a
// barrier.
template <int kMode, bool kWide = false>
__device__ __forceinline__ void accumulate_rows(
    const Code<kWide>* __restrict__ bins, const typename Accum<kMode>::T* __restrict__ gh,
    const int32_t* __restrict__ row_order, int64_t off, int64_t i0, int64_t i1, int f, int f0,
    int fg, int num_bins, int replicas, const Smem<typename Accum<kMode>::T>& s) {
  using T = typename Accum<kMode>::T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int tile = kWarpRows * warps;
  const int r0 = warp * kWarpRows;
  const int stride = feature_words(num_bins);
  const int units = replicas * fg;
  const int tag_stride = (num_bins + 3) / 4 * 4;
  uint8_t* tag = s.tags + warp * 2 * tag_stride;
  // a warp's rows of the tile at t: [t + r0, t + r0 + kWarpRows) ∩ [., i1)
  const auto mine_at = [&](int64_t t) {
    return static_cast<int>(max(static_cast<int64_t>(0),
                                min(static_cast<int64_t>(kWarpRows), i1 - t - r0)));
  };
  const auto ids_at = [&](int64_t t) {
    if (kWide && row_order == nullptr)
      return lane < mine_at(t) ? static_cast<int32_t>(off + t + r0 + lane) : 0;
    return lane < mine_at(t) ? __ldg(row_order + off + t + r0 + lane) : 0;
  };
  Staged<T> st;
  stage_load<kMode, kWide>(bins, gh, ids_at(i0), mine_at(i0), f, f0, fg, st);
  int32_t rid = ids_at(i0 + tile);
  for (int64_t t0 = i0; t0 < i1; t0 += tile) {
    const int n = static_cast<int>(i1 - t0 < tile ? i1 - t0 : tile);
    stage_store<T, kWide>(st, fg, r0, s);
    __syncthreads();
    // the next tile's rows, and the ids of the one after, in flight while
    // this tile is added
    const int64_t t1 = t0 + tile;
    if (t1 < i1) {
      stage_load<kMode, kWide>(bins, gh, rid, mine_at(t1), f, f0, fg, st);
      rid = ids_at(t1 + tile);
    }
    // add: warp-owned (copy, feature) units, two at a time (a warp has a
    // second unit only when there is one copy, so both take every chunk)
    for (int u0 = warp; u0 < units; u0 += 2 * warps) {
      const int u1 = u0 + warps;
      const int q = u0 / fg;
      const int j0 = u0 - q * fg;
      const int j1 = u1 < units ? u1 - q * fg : -1;
      T* cells0 = s.hist + u0 * stride;
      T* cells1 = s.hist + (u1 < units ? u1 : u0) * stride;
      for (int k = q; k * 32 < n; k += replicas) {
        const int r = k * 32 + lane;
        int b0 = -1, b1 = -1;
        T g = T(0), h = T(0), c = T(0);
        if (r < n) {
          const Code<kWide>* row = reinterpret_cast<const Code<kWide>*>(s.bins + r * s.row_bytes);
          // out-of-range bins are dropped (negative wide codes too)
          b0 = row[j0];
          if (static_cast<unsigned>(b0) >= static_cast<unsigned>(num_bins)) b0 = -1;
          if (j1 >= 0) {
            b1 = row[j1];
            if (static_cast<unsigned>(b1) >= static_cast<unsigned>(num_bins)) b1 = -1;
          }
          g = s.gh[r * 3 + 0];
          h = s.gh[r * 3 + 1];
          c = s.gh[r * 3 + 2];
        }
        if constexpr (kWide)
          add_pair_wide<kMode>(cells0, cells1, b0, b1, g, h, c);
        else
          add_pair<kMode>(cells0, cells1, tag, tag + tag_stride, b0, b1, g, h, c);
      }
    }
    __syncthreads();
  }
}

// Calls store(i, v) for the cells i in [lo, hi) (feature-major, 0 <= lo
// <= hi <= fg * inner; inner = num_bins * 3) with v the sum over the
// copies of cell i in `hist`, laid out as above, then over those of the
// `peers` histograms peer(0), peer(1), ... (other blocks' of a cluster).
// The cell's (feature, bin) is tracked by steps, not divisions.
template <typename T, typename Peer, typename Store>
__device__ __forceinline__ void for_cells(const T* hist, int lo, int hi, int fg, int inner,
                                          int stride, int replicas, const Peer& peer,
                                          int peers, const Store& store) {
  // i = lo + threadIdx.x + k * blockDim.x, tracked as (feature j, cell w)
  int i = lo + threadIdx.x;
  int j = i / inner;
  int w = i - j * inner;
  const int step_j = blockDim.x / inner, step_w = blockDim.x - step_j * inner;
  for (; i < hi; i += blockDim.x) {
    const int at = j * stride + w;
    T v = hist[at];
    for (int q = 1; q < replicas; ++q) v += hist[at + q * fg * stride];
    for (int p = 0; p < peers; ++p) {
      const T* o = peer(p);
      for (int q = 0; q < replicas; ++q) v += o[at + q * fg * stride];
    }
    store(i, v);
    j += step_j;
    w += step_w;
    if (w >= inner) {
      w -= inner;
      ++j;
    }
  }
}

}  // namespace seg
