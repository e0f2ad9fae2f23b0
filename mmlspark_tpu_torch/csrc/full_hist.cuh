// The block step of hist_full (csrc/histogram.cu): one block adds the
// contiguous rows [i0, i1) of the (n, f) bins and (n, 3) gh, features
// [f0, f0 + fg), into a histogram in shared memory, with no atomic and in
// row order.
//
// Threads own cells.  A block holds `slots` features (a multiple of 32, as
// many as the opt-in shared memory allows, at most kMaxSlots), so each
// row's gh is read once per block.  Thread j < slots owns the (grad, hess)
// cells of feature f0 + j, thread slots + j its count cells; each is the
// only thread that ever touches its cells, so it adds with plain loads and
// stores, and each cell is the sum of its rows' values in row order: the
// order is fixed by the block's row range alone, run to run.  The two
// thread sets are whole warps, so at the flagship's 64 slots four warps
// add, one on each of the SM's four schedulers: a warp issues a shared-
// memory instruction at most every few cycles, so the adds need every
// scheduler.  All kThreads threads stage, zero and merge.
//
// Layout (words): the pair plane, cell (j, b) at 2 (b * slots + j) (grad,
// then hess), then the count plane, cell (j, b) at 2 (B + 1) slots +
// b * slots + j.  A warp's lanes hit 32 consecutive pairs, or words, of one
// row of the plane whatever their bins, as slots is a multiple of 32: the
// adds are free of bank conflicts by construction, and a pair moves in one
// 8-byte load or store.  Bin B is a dump bin that no output reads.  At B =
// 256 and 64 slots the histogram takes 197,376 bytes.
//
// Staging.  Behind the histogram lie kStages buffers of kStageBytes, a
// ring of row tiles filled by cp.async (16-byte copies that hold no
// register), kStages - 1 tiles ahead of the adds.  When the block holds the
// whole row (fg == f) a tile's bins are one contiguous byte range; else
// each row's fg bytes are copied as a window of 16-byte chunks.  A tile's
// gh is one contiguous range, staged 16-byte aligned (in 4-byte copies
// when the rows do not start on a 16-byte boundary).  Bin copies start on
// the 16-byte boundary at or below their first byte and end on the one at
// or above their last, so they read no further than the 16-byte blocks
// that hold the tensor's bytes.
//
// Adds.  A thread takes kBatch rows a step: it loads the kBatch cells, adds,
// and stores them, while the next step's bins and gh (three 16-byte loads
// for four rows' gh) are read.  When two rows of a step share
// a bin, the later row adds to the earlier row's new value, forwarded in
// registers, so the adds stay in row order.  The loads and stores take no
// branch: a tile's last step adds zero gh past its rows, and at fewer than
// 256 bins an out-of-range bin adds into the dump bin.
//
// accum modes (hist_block.cuh's Accum): 0 = float32; 1 = bfloat16; 2 =
// int32 (exact).  Out-of-range bins are dropped.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hist_block.cuh"

namespace full {

using hist::Accum;

constexpr int kSlotAlign = 32;    // slots: a multiple of a warp
constexpr int kThreads = 512;     // threads a block
constexpr int kMaxSlots = kThreads / 2;
constexpr int kStages = 3;        // staged tiles
constexpr int kStageBytes = 8192; // bytes a staged tile
constexpr int kBatch = 4;         // rows a thread adds a step
constexpr int kRowAlign = 16;     // a block's rows start at a multiple of this
constexpr int kMaxCluster = 16;   // largest cluster (a non-portable size)

// Words of the histogram of `slots` features (num_bins bins and the dump
// bin), where its count plane begins, and the bytes of a block's shared
// memory.
__host__ __device__ __forceinline__ int hist_words(int slots, int num_bins) {
  return (num_bins + 1) * 3 * slots;
}
__host__ __device__ __forceinline__ int count_plane(int slots, int num_bins) {
  return (num_bins + 1) * 2 * slots;
}
__host__ __device__ __forceinline__ size_t hist_bytes(int slots, int num_bins) {
  return static_cast<size_t>(hist_words(slots, num_bins)) * 4;
}
__host__ __device__ __forceinline__ size_t smem_bytes(int slots, int num_bins) {
  return hist_bytes(slots, num_bins) + static_cast<size_t>(kStages) * kStageBytes;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes to reserve for `bytes` bytes copied from any 4-byte-aligned start
// by whole 16-byte chunks.
__device__ __forceinline__ int chunked(int bytes) { return (bytes + 30) / 16 * 16; }

// How a block's tiles are laid out in a staging buffer.
struct Tile {
  bool contiguous;  // the block holds the whole row: one byte range a tile
  int rows;         // rows a tile, a multiple of kBatch
  int row_bytes;    // a row's window (not contiguous): whole chunks
  int gh_at;        // where a tile's gh begins in the buffer
};

__device__ __forceinline__ Tile tile_shape(int f, int fg) {
  Tile t;
  t.contiguous = fg == f;
  t.row_bytes = chunked(fg);
  const int per_row = (t.contiguous ? f : t.row_bytes) + 12;
  int rows = (kStageBytes - 64) / per_row / kBatch * kBatch;
  const auto bins_bytes = [&](int r) { return t.contiguous ? chunked(r * f) : r * t.row_bytes; };
  while (rows > kBatch && bins_bytes(rows) + chunked(rows * 12) > kStageBytes) rows -= kBatch;
  t.rows = rows < kBatch ? kBatch : rows;
  t.gh_at = bins_bytes(t.rows);
  return t;
}

// Issues the copies of rows [r0, r0 + nr) into `buf`, then commits them as
// one group (an empty group when nr <= 0).
template <typename T>
__device__ __forceinline__ void stage_tile(const uint8_t* __restrict__ bins,
                                           const T* __restrict__ gh, int64_t r0, int nr, int f,
                                           int f0, int fg, const Tile& t, unsigned char* buf) {
  if (nr > 0) {
    if (t.contiguous) {
      const uintptr_t s = reinterpret_cast<uintptr_t>(bins + r0 * f);
      const uintptr_t s16 = s & ~uintptr_t(15);
      const int chunks = static_cast<int>((s + static_cast<uintptr_t>(nr) * f + 15 - s16) >> 4);
      for (int k = threadIdx.x; k < chunks; k += blockDim.x)
        cp_async16(buf + 16 * k, reinterpret_cast<const void*>(s16 + 16 * k));
    } else {
      const int per_row = t.row_bytes >> 4;
      const int chunks = nr * per_row;
      for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
        const int u = k / per_row;
        const int w = k - u * per_row;
        const uintptr_t s = reinterpret_cast<uintptr_t>(bins + (r0 + u) * f + f0);
        const uintptr_t c = (s & ~uintptr_t(15)) + 16 * w;
        if (c < s + fg) cp_async16(buf + u * t.row_bytes + 16 * w, reinterpret_cast<const void*>(c));
      }
    }
    // the tile's gh lands at gh_at, 16-byte aligned: in 16-byte copies
    // where the rows start on a 16-byte boundary, else in 4-byte ones
    const T* g = gh + r0 * 3;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      const int chunks = (nr * 12 + 15) >> 4;
      for (int k = threadIdx.x; k < chunks; k += blockDim.x)
        cp_async16(buf + t.gh_at + 16 * k, g + 4 * k);
    } else {
      for (int k = threadIdx.x; k < nr * 3; k += blockDim.x)
        cp_async4(buf + t.gh_at + 4 * k, g + k);
    }
  }
  cp_async_commit();
}

template <typename T>
__device__ __forceinline__ T from_bits(unsigned v);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned v) { return __uint_as_float(v); }
template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(unsigned v) { return static_cast<int32_t>(v); }
__device__ __forceinline__ unsigned to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned to_bits(int32_t v) { return static_cast<unsigned>(v); }

// Four cells as 16 bytes, and back; add() adds four cells' values to v.
template <typename T>
__device__ __forceinline__ void unpack(uint4 x, T (&v)[4]) {
  v[0] = from_bits<T>(x.x);
  v[1] = from_bits<T>(x.y);
  v[2] = from_bits<T>(x.z);
  v[3] = from_bits<T>(x.w);
}
template <typename T>
__device__ __forceinline__ uint4 pack(const T (&v)[4]) {
  return make_uint4(to_bits(v[0]), to_bits(v[1]), to_bits(v[2]), to_bits(v[3]));
}
template <typename T>
__device__ __forceinline__ void add(T (&v)[4], uint4 x) {
  v[0] += from_bits<T>(x.x);
  v[1] += from_bits<T>(x.y);
  v[2] += from_bits<T>(x.z);
  v[3] += from_bits<T>(x.w);
}

// Thread j's adds of one staged tile of nr rows (rows r0 ...): the pair
// cells (kPair) or the count cells of feature f0 + j; see the note at the
// top.  Steps read the rows of a whole step, also past nr: the caller
// zeroes the gh of those rows, and adding zero leaves a cell as it is (a
// cell is never -0).  kChecked (num_bins < 256): a bin of num_bins or more
// adds into the dump bin; at 256 bins every byte is a bin.  The next step's
// rows are read while a step is added, into the other of two register sets.
template <int kMode, bool kContiguous, bool kChecked, bool kPair>
__device__ __forceinline__ void add_tile(const uint8_t* __restrict__ bins, int64_t r0, int nr,
                                         int f, int f0, int j, int slots,
                                         int num_bins, const Tile& t,
                                         const unsigned char* __restrict__ buf,
                                         typename Accum<kMode>::T* __restrict__ hist) {
  using T = typename Accum<kMode>::T;
  constexpr int kC = kPair ? 2 : 1;    // channels a thread adds
  constexpr int kC0 = kPair ? 0 : 2;   // its first channel
  // where row r's bin byte of feature f0 + j and its gh lie in the buffer
  const int bin_mis = static_cast<int>(reinterpret_cast<uintptr_t>(bins + r0 * f + f0) & 15);
  const unsigned char* b0 = buf + j + bin_mis;
  const int f16 = f & 15;
  const auto bin_at = [&](int r) {
    return kContiguous ? r * f : r * t.row_bytes + ((bin_mis + r * f16) & 15) - bin_mis;
  };
  const uint4* g0 = reinterpret_cast<const uint4*>(buf + t.gh_at);
  unsigned char* cells = reinterpret_cast<unsigned char*>(
      kPair ? hist + 2 * j : hist + count_plane(slots, num_bins) + j);
  const int bin_bytes = kC * slots * 4;

  // the bins and gh of rows u0 .. u0 + kBatch - 1 (u0 + kBatch <= t.rows)
  const auto load = [&](int u0, int (&b)[kBatch], T (&g)[kBatch][kC]) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int bin = b0[bin_at(u0 + u)];
      b[u] = kChecked && bin >= num_bins ? num_bins : bin;
    }
    // kBatch rows' gh: 3 kBatch words in 16-byte loads (kBatch is a
    // multiple of 4, so are u0 and the words before row u0)
    unsigned w[3 * kBatch];
#pragma unroll
    const uint4* q = g0 + static_cast<unsigned>(u0) / 4u * 3u;
    for (int k = 0; k < 3 * kBatch / 4; ++k) {
      const uint4 x = q[k];
      w[4 * k] = x.x;
      w[4 * k + 1] = x.y;
      w[4 * k + 2] = x.z;
      w[4 * k + 3] = x.w;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        g[u][c] = Accum<kMode>::round(from_bits<T>(w[u * 3 + kC0 + c]));
  };
  // adds a step's rows: row u adds to the newest value of its cell, the
  // latest earlier row of the step with its bin, else the loaded one
  const auto add = [&](const int (&b)[kBatch], T (&g)[kBatch][kC]) {
    T* cell[kBatch];
    T old[kBatch][kC];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      cell[u] = reinterpret_cast<T*>(cells + b[u] * bin_bytes);
      if (kPair) {
        const uint2 x = *reinterpret_cast<const uint2*>(cell[u]);
        old[u][0] = from_bits<T>(x.x);
        old[u][kC - 1] = from_bits<T>(x.y);
      } else {
        old[u][0] = cell[u][0];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
#pragma unroll
      for (int p = 0; p < u; ++p) {
        if (b[p] == b[u]) {
#pragma unroll
          for (int c = 0; c < kC; ++c) old[u][c] = g[p][c];
        }
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) g[u][c] = old[u][c] + g[u][c];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (kPair)
        *reinterpret_cast<uint2*>(cell[u]) = make_uint2(to_bits(g[u][0]), to_bits(g[u][kC - 1]));
      else
        cell[u][0] = g[u][0];
    }
  };

  const int last = t.rows - kBatch;
  int ba[kBatch], bb[kBatch];
  T ga[kBatch][kC], gb[kBatch][kC];
  load(0, ba, ga);
  for (int u0 = 0; u0 < nr; u0 += 2 * kBatch) {
    load(min(u0 + kBatch, last), bb, gb);
    add(ba, ga);
    if (u0 + kBatch >= nr) break;
    load(min(u0 + 2 * kBatch, last), ba, ga);
    add(bb, gb);
  }
}

// Zeroes `hist` (`words` words) while the first tiles are copied, then adds
// rows [i0, i1), features [f0, f0 + fg) (fg <= slots <= kMaxSlots), into
// it through the kStages staging buffers at `stage`.  Ends with every copy
// landed; the caller's next barrier makes the histogram whole.
template <int kMode>
__device__ __forceinline__ void accumulate_rows(const uint8_t* __restrict__ bins,
                                                const typename Accum<kMode>::T* __restrict__ gh,
                                                int64_t i0, int64_t i1, int f, int f0, int fg,
                                                int slots, int num_bins, int words,
                                                typename Accum<kMode>::T* __restrict__ hist,
                                                unsigned char* __restrict__ stage) {
  const Tile t = tile_shape(f, fg);
  const int64_t tiles = (i1 - i0 + t.rows - 1) / t.rows;
  const auto rows_of = [&](int64_t k) {
    return static_cast<int>(k < tiles ? min(static_cast<int64_t>(t.rows), i1 - i0 - k * t.rows)
                                      : 0);
  };
  const auto buffer = [&](int64_t k) { return stage + (k % kStages) * kStageBytes; };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k)
    stage_tile(bins, gh, i0 + k * t.rows, rows_of(k), f, f0, fg, t, buffer(k));
  {
    int4* h4 = reinterpret_cast<int4*>(hist);  // words is a multiple of 4
    for (int i = threadIdx.x; i < words / 4; i += blockDim.x) h4[i] = make_int4(0, 0, 0, 0);
  }
  for (int64_t k = 0; k < tiles; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile k landed for all; all are done with tile k - 1
    const int64_t ahead = k + kStages - 1;
    stage_tile(bins, gh, i0 + ahead * t.rows, rows_of(ahead), f, f0, fg, t, buffer(ahead));
    const int64_t r0 = i0 + k * t.rows;
    const int nr = rows_of(k);
    if (nr % kBatch) {
      // the gh of the rows from nr to the end of the last step add zero
      using T = typename Accum<kMode>::T;
      T* tail = reinterpret_cast<T*>(buffer(k) + t.gh_at) + nr * 3;
      if (threadIdx.x < (kBatch - nr % kBatch) * 3) tail[threadIdx.x] = T(0);
      __syncthreads();
    }
    // warps of threads [0, slots) add the pair cells, of [slots, 2 slots)
    // the count cells
    const int j = threadIdx.x < slots ? threadIdx.x : threadIdx.x - slots;
    if (threadIdx.x < 2 * slots && j < fg) {
      const auto go = [&](auto contiguous, auto checked, auto pair) {
        add_tile<kMode, decltype(contiguous)::value, decltype(checked)::value,
                 decltype(pair)::value>(bins, r0, nr, f, f0, j, slots, num_bins, t, buffer(k),
                                        hist);
      };
      using Yes = std::true_type;
      using No = std::false_type;
      const bool checked = num_bins < 256;
      if (threadIdx.x < slots) {
        if (t.contiguous)
          checked ? go(Yes(), Yes(), Yes()) : go(Yes(), No(), Yes());
        else
          checked ? go(No(), Yes(), Yes()) : go(No(), No(), Yes());
      } else {
        if (t.contiguous)
          checked ? go(Yes(), Yes(), No()) : go(Yes(), No(), No());
        else
          checked ? go(No(), Yes(), No()) : go(No(), No(), No());
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace full
