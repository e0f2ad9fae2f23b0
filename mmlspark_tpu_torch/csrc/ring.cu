// Cross-shard reductions of the data-parallel learners, written by hand
// for Hopper (sm_90a).  Built by mmlspark_tpu_torch/ops/_build.py with nvcc
// into a shared library with a plain C interface and called through ctypes
// (ops/cuda_ring.py).
//
// What each replaces, in mmlspark_tpu/ops/pallas_collectives.py:
// - ring_allreduce (:196; launcher _ring_flat :161, body
//   _ring_allreduce_kernel :102): the sum over D shards of one float32
//   partial each, delivered to every shard.  Here direct_ring_allreduce_kernel
//   when every rank lies on one card, ring_allreduce_kernel when the mesh
//   spans cards.
// - ring_allreduce_select (:242, with _gather_cand :233; the same TPU body
//   under its own collective id): the PV-Tree voted-column reduction.  Each
//   shard holds a local (f, B, 3) histogram, or the (m, f, B, 3) stack of
//   one grow step's children, and the candidate columns cand (k2,) or (m,
//   k2), identical on every shard (they come from the gathered votes); only
//   the gathered (k2, B, 3) or (m, k2, B, 3) slab is summed, flattened as
//   one array.  Here direct_ring_select_kernel on one card,
//   ring_select_kernel across cards.  Both gather in the kernel, as the TPU
//   kernel gathers in its body; a candidate index outside [0, f) traps the
//   kernel (an error at the next synchronize) instead of reading outside
//   the histogram.
// - fused_segment_hist_ring (:406, body _fused_hist_ring_kernel :289): each
//   shard gathers its DataPartition segment row_order[off : off + cnt],
//   histograms it, and the (f, B, 3) partials are ring-reduced in the same
//   kernel (float32 or exact int32): fused_hist_ring_kernel, on one card or
//   many.
//
// Order.  The TPU ring cuts the flattened payload of `total` elements into D
// chunks of `chunk` = cb * 128 elements (cb = ceil(ceil(total / 128) / D),
// _ring_flat's padding; here the pad is never materialised: elements past
// `total` read as zero and are not written), and chunk c is summed
// ((x_c + x_{c+1}) + x_{c+2}) + ..., indices mod D.  Every kernel here adds
// each element in exactly that order, with no atomics, so the float32
// results equal the plain twins (ops/collectives.py ring_allreduce_plain,
// ring_allreduce_select_plain) bit for bit, and those equal the reference.
//
// Direct kernels (every rank on one card).  All D partials already lie in
// that card's memory, and the wrapper launches on the card's current
// stream, behind the work that wrote them, so stream order makes every
// input complete before the launch starts; the D outputs are one fresh
// allocation that nothing else touches until the kernel ends.  So no
// handshake is needed, and a ring (a pipeline that exists to move chunks
// between devices) has nothing to do.  One ordinary launch computes the
// ring's sum directly: the thread for element e (or for the float4 of four
// elements at e, where every pointer is 16-byte aligned and the row length
// a multiple of 4; a chunk is a multiple of 128, so a float4 never
// straddles two chunks) takes chunk c = e / chunk, loads x_c, x_{c+1}, ...,
// x_{c+D-1} (all D loads issued before the first add), adds them in that
// order, and stores the sum to every rank's output.  No flag, comm slot,
// fence, atomic or sequence number, and no cooperative launch.  The select
// kernel's grid y walks the m * k2 slab rows and x the row's inner = B * 3
// cells: per row it reads cand[row] once, checks it, and computes the row's
// base in every rank's (m, f, B, 3) histogram, its chunk c0 and the first
// cell jb of chunk c0 + 1; where chunk >= inner (the wide pair: 24,576
// against 768) a row meets at most one boundary, so a cell's chunk is c0 or
// c0 + 1 with no division, and a small slab whose chunk < inner (chunk 128
// against inner 768 for a one-row slab) divides only past jb.
//
// Ring kernels (the mesh spans cards).  Reduce-scatter: at step k = 0 rank
// r sends its own chunk r to rank r + 1; at steps k = 1 .. D-1 it adds its
// local part of chunk r - k to the partial that arrived from rank r - 1
// and sends the sum on.  After step D-1 rank r holds the total of chunk
// r + 1.  All-gather: D-1 forwarding steps.  Transport: a pointer table
// (struct Args, a __grid_constant__ kernel parameter) gives each rank's
// input, output, comm slots and flag words.  Rank r pushes: it stores its
// finished chunk into rank r + 1's comm slot, fences, then raises r + 1's
// flag for that slot with a release store; the receiver spins on an
// acquire load and reads the slot through L2 (__ldcg).  The pointers lie on
// peer cards (the wrapper enables peer access), or for the fused kernel
// also on one card.  Where the TPU kernel double-buffers two comm slots
// under DMA semaphores, each step here owns its own slot (2(D-1) per rank):
// no slot is reused within a launch, so no back-pressure handshake is
// needed, and a rank can only reach a slot in launch s + 1 after its right
// neighbour has consumed it in launch s (the reduce-scatter of s + 1 cannot
// finish before that neighbour has finished s).  Flags carry a
// per-workspace launch sequence number, so nothing is reset between
// launches.
//
// Blocks.  The ring decomposes by element: block b of every rank handles
// the same slice of each chunk, and talks only to block b of its two
// neighbours (one flag per (slot, block)), so every card of a mesh must
// launch the same number of blocks per rank: the wrapper asks each card
// what it wants and holds (ring_allreduce_blocks, fused_hist_ring_blocks),
// takes the minimum over the mesh, and passes that one count to every
// card's launch.  (fused_hist_ring: that count bounds the launch, whose
// first nb_ring blocks carry the ring's slices on every card, and whose
// grid takes the ring blocks or the phase-1 items, whichever are more.)
// One cooperative launch per card covers every rank on that card (grid y =
// local rank), so every block that another block waits on is resident; a
// grid that does not fit fails to launch instead of hanging.  Every wait is
// bounded by kWaitSeconds of %globaltimer and __trap()s when it runs out,
// so a broken handshake surfaces as an error at the next synchronize, not
// as a hung card.  ring_phase takes its payload through a loader; the
// select ring's (SelectLoad) reads element (mm, kk, b, c) of the slab
// straight from the rank's local histogram, hist[mm][cand[mm][kk]][b][c].
//
// fused_hist_ring.  Phase 1 cuts the rank's segment histogram along the
// ring's chunks: chunk c covers the flattened elements [c * chunk, (c + 1)
// * chunk), which lie in features [fa_c, fb_c) (a feature that straddles
// a chunk boundary belongs to both chunks, and each chunk's items add
// only their own cells).  An item is (chunk, sub-group of at most `group`
// features, row tile); its block adds the tile's rows into shared memory
// with the block step of seg_hist.cuh (each row staged once, features
// owned by warps, no float atomics), then adds the chunk's non-zero cells
// into the rank's `work` buffer with global atomics and counts itself on
// the chunk's readiness counter; the last item of a chunk resets the
// counter and raises the chunk's flag to the launch's sequence number.
// Items are taken in the order the ring consumes the chunks (chunk rank
// first, then rank - 1, ...), from the last block down, so the ring's
// blocks (the first nb_ring) take the last items.  Phase 2 is the ring
// above over `work`; before it loads chunk c a ring block waits for chunk
// c's flag alone, so the first send overlaps the histogram of the later
// chunks, and no barrier spans the rank's blocks.  Blocks with neither an
// item nor a ring slice leave at once.  Each ring block then zeroes its
// slice of `work`, so the buffer is zero for the next launch without a
// memset.  Each rank takes its own exact `cnt` (no padding to a global
// bucket).
//
// Scope.  The dense and select rings run only across cards, so their
// handshakes use .sys scope (__threadfence_system, st.release.sys,
// ld.acquire.sys).  The fused kernel's use .gpu scope (fence.acq_rel.gpu,
// st.release.gpu, ld.acquire.gpu) when every rank lies on one card and
// .sys when the mesh spans cards; its readiness words never leave the
// rank's card, so they are .gpu always.
//
// Bound (H100 SXM, 3.35 TB/s HBM, 450 GB/s NVLink each way).  The bound
// counts what the function must move, not what a ring chooses to move
// through its slots.  ring_allreduce on the flagship payload (50, 256, 3)
// f32 = 153,600 B, D shards on one card: read the D partials and write the
// D outputs, 2 x D x 153,600 B = 1.23 MB at D = 4, 0.37 us; its adds are
// negligible.  The direct kernel moves exactly those bytes.  ring_select on
// the wide voting configuration (topK 32, so k2 = 64 of f = 2000 columns,
// B = 256): the pair slab is (2, 64, 256, 3) f32 = 393,216 B; at D = 4 on
// one card the function reads the 4 gathered slabs and writes 4 outputs,
// 3.15 MB, 0.94 us.  What bounds the direct kernels instead is a launch's
// latency and one round trip of loads: the flagship payload is 9,600
// float4 (75 blocks of 128 threads) and the pair 128 rows of 192 float4
// threads, less than one wave of the card's 132 SMs at any D.  Across
// cards, one shard a card: each card reads its partial and writes its
// output, and 2(D-1)/D of the payload must cross NVLink each way, 0.51 us
// at D = 4; the ring is held back by its 2(D-1) flag handshakes in
// sequence, each a fenced store and a poll over NVLink, not by bytes.
// fused_hist_ring at 100,000 rows per shard, f = 50, D = 4 must read 4 x
// (5 MB bins + 1.2 MB gh + 0.4 MB row ids) = 26.4 MB and write the 4
// reduced outputs, 0.61 MB: 8.06 us; like hist_segment it is held back in
// phase 1 by the add step's instructions and the latency of the row
// gathers (seg_hist.cuh), and at a small segment by the launch and the
// 2(D-1) handshakes of phase 2.
//
// Each entry returns cudaGetLastError() (or the launch's own error); the
// kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "seg_hist.cuh"

namespace {

constexpr int kMaxRanks = 16;
constexpr int kMaxBlocks = 1024;      // ring blocks per rank; flag stride
constexpr int kThreads = 256;         // dense and select rings
constexpr int kFusedThreads = 512;    // fused_hist_ring
constexpr int kElemsPerThread = 4;    // ring_allreduce grid sizing
constexpr int kDenseThreads = 128;    // direct_ring_allreduce_kernel
constexpr int kSelectThreads = 256;   // direct_ring_select_kernel, at most
constexpr int kDirectMaxGrid = 4096;  // direct kernels' grid x; they stride
constexpr unsigned long long kWaitNs = 20ull * 1000 * 1000 * 1000;  // kWaitSeconds = 20

struct Rank {
  const void* x;       // ring_allreduce: the input partial; ring_select:
                       //   the local (m, f, B, 3) histogram
  const int32_t* cand; // ring_select: (m * k2,) candidate columns
  void* out;           // the reduced payload
  void* slots;         // 2(D-1) chunks, written by rank - 1
  unsigned* flags;     // 2(D-1) * kMaxBlocks words, one per (slot, block)
  const uint8_t* bins; // fused_hist_ring: (n, f) bins of this shard
  const void* gh;      //   (n, 3) gh
  const int32_t* row_order;
  int64_t off;         //   segment row_order[off : off + cnt]
  int64_t cnt;
  int64_t tiles;       //   row tiles of the segment (0 when cnt == 0)
  void* work;          //   local (f, B, 3) histogram, zero between launches
  unsigned* ready;     //   per chunk: [kMaxRanks items counted, kMaxRanks flags]
};

struct Args {
  Rank r[kMaxRanks];
  int local[kMaxRanks];  // global rank of block row blockIdx.y
  int ranks;             // D
  int f, num_bins;
  int group;             // fused_hist_ring: features per phase-1 item
  int replicas;          // fused_hist_ring: histogram copies per block
  int nb_ring;           // fused_hist_ring: ring blocks per rank
  int64_t k2, inner;     // ring_select: candidates per child, B * 3
  int64_t total;         // payload elements
  int64_t chunk;         // cb * 128
  unsigned seq;          // launch sequence number, never 0
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Handshake primitives at system scope (kSys: ranks on several cards) or
// at the scope of one card.
template <bool kSys>
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  if (kSys)
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <bool kSys>
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  if (kSys)
    asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  else
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

template <bool kSys>
__device__ __forceinline__ void fence() {
  if (kSys)
    __threadfence_system();
  else
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

template <bool kSys>
__device__ __forceinline__ void spin_until(const unsigned* p, unsigned v) {
  const unsigned long long t0 = now_ns();
  while (ld_acquire<kSys>(p) != v) {
    if (now_ns() - t0 > kWaitNs) __trap();
  }
}

// Block-wide receive: thread 0 waits for the flag, then the block goes on.
template <bool kSys>
__device__ __forceinline__ void block_wait(const unsigned* flag, unsigned seq) {
  if (threadIdx.x == 0) spin_until<kSys>(flag, seq);
  __syncthreads();
}

// Block-wide send: every thread's stores so far become visible at the
// scope before thread 0 raises the flag.
template <bool kSys>
__device__ __forceinline__ void block_signal(unsigned* flag, unsigned seq) {
  fence<kSys>();
  __syncthreads();
  if (threadIdx.x == 0) st_release<kSys>(flag, seq);
}

// Payload element e of a plain array.
template <typename T>
struct DenseLoad {
  const T* x;
  __device__ __forceinline__ T operator()(int64_t e) const { return __ldcg(x + e); }
};

// Payload element e of the voted slab (m, k2, B, 3), read from the local
// (m, f, B, 3) histogram through the candidate columns.
struct SelectLoad {
  const float* hist;
  const int32_t* cand;  // (m * k2,)
  int64_t f, k2, inner;
  __device__ __forceinline__ float operator()(int64_t e) const {
    const int64_t row = e / inner;  // slab row, m * k2 of them
    const int64_t col = cand[row];
    if (col < 0 || col >= f) __trap();
    return __ldcg(hist + ((row / k2) * f + col) * inner + (e - row * inner));
  }
};

// The dense and select rings' payload is there before the launch.
struct Ready {
  __device__ __forceinline__ void operator()(int) const {}
};

// Block b (of nb) of `rank` runs its slice of the ring over the payload
// that `load` reads; `ready(c)` returns once chunk c of it may be read.
// kZeroX: zero x's slice once the reduce-scatter has read it (x is the
// payload that `load` reads).  kSys: handshakes at system scope.
template <typename T, bool kZeroX, bool kSys, typename Load, typename Wait>
__device__ void ring_phase(const Args& a, int rank, int b, int nb, const Load& load, T* x,
                           const Wait& ready) {
  const int D = a.ranks;
  const Rank& me = a.r[rank];
  const Rank& right = a.r[(rank + 1) % D];
  T* out = static_cast<T*>(me.out);
  const T* mine = static_cast<const T*>(me.slots);
  T* theirs = static_cast<T*>(right.slots);
  const int64_t cs = a.chunk, total = a.total;
  const int64_t i0 = static_cast<int64_t>(b) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(nb) * blockDim.x;

  // reduce-scatter, step 0: chunk `rank` goes to the right neighbour
  ready(rank);
  for (int64_t i = i0; i < cs; i += stride) {
    const int64_t e = static_cast<int64_t>(rank) * cs + i;
    __stcg(theirs + i, e < total ? load(e) : T(0));
  }
  block_signal<kSys>(right.flags + b, a.seq);
  // steps 1 .. D-1: add the local part of chunk rank - k to the partial
  // from the left and pass it on; step D-1 completes chunk rank + 1, and
  // its send is the first all-gather step
  for (int k = 1; k < D; ++k) {
    const int c = (rank - k + D) % D;
    ready(c);
    block_wait<kSys>(me.flags + static_cast<int64_t>(k - 1) * kMaxBlocks + b, a.seq);
    const T* in = mine + static_cast<int64_t>(k - 1) * cs;
    T* fwd = theirs + static_cast<int64_t>(k) * cs;
    for (int64_t i = i0; i < cs; i += stride) {
      const int64_t e = static_cast<int64_t>(c) * cs + i;
      const T v = (e < total ? load(e) : T(0)) + __ldcg(in + i);
      if (k == D - 1 && e < total) out[e] = v;
      __stcg(fwd + i, v);
    }
    block_signal<kSys>(right.flags + static_cast<int64_t>(k) * kMaxBlocks + b, a.seq);
  }
  if (kZeroX) {
    for (int64_t i = i0; i < cs; i += stride) {
      for (int c = 0; c < D; ++c) {
        const int64_t e = static_cast<int64_t>(c) * cs + i;
        if (e < total) x[e] = T(0);
      }
    }
  }
  // all-gather: slot D-2+j brings the total of chunk rank + 1 - j
  for (int j = 1; j < D; ++j) {
    const int s = D - 2 + j;
    block_wait<kSys>(me.flags + static_cast<int64_t>(s) * kMaxBlocks + b, a.seq);
    const int c = (rank + 1 - j + D) % D;
    const T* in = mine + static_cast<int64_t>(s) * cs;
    T* fwd = theirs + static_cast<int64_t>(s + 1) * cs;
    for (int64_t i = i0; i < cs; i += stride) {
      const T v = __ldcg(in + i);
      const int64_t e = static_cast<int64_t>(c) * cs + i;
      if (e < total) out[e] = v;
      if (j < D - 1) __stcg(fwd + i, v);
    }
    if (j < D - 1) block_signal<kSys>(right.flags + static_cast<int64_t>(s + 1) * kMaxBlocks + b, a.seq);
  }
}

__global__ void __launch_bounds__(kThreads) ring_allreduce_kernel(const __grid_constant__ Args a) {
  const int rank = a.local[blockIdx.y];
  const DenseLoad<float> load{static_cast<const float*>(a.r[rank].x)};
  ring_phase<float, false, true>(a, rank, blockIdx.x, gridDim.x, load,
                                 static_cast<float*>(nullptr), Ready{});
}

__global__ void __launch_bounds__(kThreads) ring_select_kernel(const __grid_constant__ Args a) {
  const int rank = a.local[blockIdx.y];
  const Rank& me = a.r[rank];
  const SelectLoad load{static_cast<const float*>(me.x), me.cand, a.f, a.k2, a.inner};
  ring_phase<float, false, true>(a, rank, blockIdx.x, gridDim.x, load,
                                 static_cast<float*>(nullptr), Ready{});
}

// The direct kernels' arguments: rank r's input (dense: its partial;
// select: its local (m, f, B, 3) histogram), and one output of `ranks` x
// `total` elements, rank r's at out + r * total.
struct Direct {
  const float* x[kMaxRanks];
  float* out;
  const int32_t* cand;  // select: (m * k2,) candidate columns, on the card
  int ranks;
  int f;                // select: columns of a local histogram
  int64_t k2, inner;    // select: candidates per child, cells per slab row
  int64_t total;        // payload elements
  int64_t chunk;        // cb * 128
};

// One payload element (float) or four neighbouring ones (float4).
template <typename V>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kWidth = 1;
  __device__ static __forceinline__ float load(const float* p) { return __ldg(p); }
  __device__ static __forceinline__ void add(float& s, float v) { s += v; }
  __device__ static __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Vec<float4> {
  static constexpr int kWidth = 4;
  __device__ static __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static __forceinline__ void add(float4& s, const float4& v) {
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  __device__ static __forceinline__ void store(float* p, const float4& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

// The ring's sum of the element(s) at offset i of every rank's input,
// started at rank c: ((x_c + x_{c+1}) + x_{c+2}) + ..., indices mod D.  The
// D loads are issued before the first add.
template <typename V>
__device__ __forceinline__ V ring_sum(const Direct& a, int c, int64_t i) {
  V v[kMaxRanks];
#pragma unroll
  for (int k = 0; k < kMaxRanks; ++k) {
    if (k < a.ranks) {
      const int r = c + k < a.ranks ? c + k : c + k - a.ranks;
      v[k] = Vec<V>::load(a.x[r] + i);
    }
  }
  V s = v[0];
#pragma unroll
  for (int k = 1; k < kMaxRanks; ++k)
    if (k < a.ranks) Vec<V>::add(s, v[k]);
  return s;
}

template <typename V>
__device__ __forceinline__ void store_all(const Direct& a, int64_t i, const V& s) {
  for (int r = 0; r < a.ranks; ++r) Vec<V>::store(a.out + r * a.total + i, s);
}

// ring_allreduce on one card: the thread for element e (kVec: the float4 at
// e) adds it from chunk e / chunk's rank on and writes every output.
template <bool kVec>
__global__ void __launch_bounds__(kDenseThreads)
direct_ring_allreduce_kernel(const __grid_constant__ Direct a) {
  using V = typename std::conditional<kVec, float4, float>::type;
  const int64_t n = a.total / Vec<V>::kWidth;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const int64_t e = t * Vec<V>::kWidth;
    store_all(a, e, ring_sum<V>(a, static_cast<int>(e / a.chunk), e));
  }
}

// ring_select on one card: block row y takes slab rows y, y + gridDim.y,
// ...; its threads take the row's cells (kVec: float4s).  Slab element e =
// row * inner + j lies at ((row / k2) * f + cand[row]) * inner + j of every
// rank's histogram.
template <bool kVec>
__global__ void __launch_bounds__(kSelectThreads)
direct_ring_select_kernel(const __grid_constant__ Direct a) {
  using V = typename std::conditional<kVec, float4, float>::type;
  const int64_t inner = a.inner;
  const int64_t rows = a.total / inner;
  const int64_t n = inner / Vec<V>::kWidth;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // chunk >= inner: a row meets at most one chunk boundary
  const int narrow = a.chunk < inner ? static_cast<int>(a.chunk) : 0;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int64_t col = __ldg(a.cand + row);
    if (col < 0 || col >= a.f) __trap();
    const int64_t src = ((row / a.k2) * a.f + col) * inner;
    const int64_t dst = row * inner;
    const int c0 = static_cast<int>(dst / a.chunk);
    const int64_t jb = (c0 + 1) * a.chunk - dst;  // first cell of chunk c0 + 1
    for (int64_t t = t0; t < n; t += stride) {
      const int64_t j = t * Vec<V>::kWidth;
      int c = c0;
      if (j >= jb) c += 1 + (narrow ? static_cast<int>(j - jb) / narrow : 0);
      store_all(a, dst + j, ring_sum<V>(a, c, src + j));
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Fills the direct kernels' common arguments; false when they are invalid.
bool fill_direct(Direct& a, int ranks, void* const* x, void* out, int64_t total,
                 int64_t chunk) {
  if (ranks < 2 || ranks > kMaxRanks || total < 1 || chunk < 128 || chunk % 128 != 0 ||
      chunk * ranks < total)
    return false;
  a = Direct{};
  a.ranks = ranks;
  a.total = total;
  a.chunk = chunk;
  a.out = static_cast<float*>(out);
  for (int r = 0; r < ranks; ++r) a.x[r] = static_cast<const float*>(x[r]);
  return true;
}

// Every input and the output 16-byte aligned, and each rank's output
// (`total` elements) a multiple of 4: rows of `width` elements may go as
// float4s.
bool vec_ok(const Direct& a, int64_t width) {
  if (width % 4 != 0 || a.total % 4 != 0 || !aligned16(a.out)) return false;
  for (int r = 0; r < a.ranks; ++r)
    if (!aligned16(a.x[r])) return false;
  return true;
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The features [fa, fb) that hold chunk c's elements, in nsub phase-1
// sub-groups of at most a.group features (nsub = 0: a chunk past the
// payload).
struct ChunkFeatures {
  int fa, fb, nsub;
};

__device__ __forceinline__ ChunkFeatures chunk_features(const Args& a, int c) {
  const int64_t inner = static_cast<int64_t>(a.num_bins) * 3;
  const int64_t lo = static_cast<int64_t>(c) * a.chunk;
  const int64_t hi = lo + a.chunk < a.total ? lo + a.chunk : a.total;
  if (lo >= hi) return {0, 0, 0};
  const int fa = static_cast<int>(lo / inner);
  const int fb = static_cast<int>((hi + inner - 1) / inner);
  return {fa, fb, (fb - fa + a.group - 1) / a.group};
}

// Chunk c of the rank's `work` is complete once all its items have counted
// themselves: the last raises the chunk's flag (gpu scope: the readers are
// the rank's own blocks, on its card).
struct ChunkReady {
  const Args& a;
  const Rank& me;
  __device__ __forceinline__ void operator()(int c) const {
    if (chunk_features(a, c).nsub * me.tiles == 0) return;  // nothing added
    block_wait<false>(me.ready + kMaxRanks + c, a.seq);
  }
};

__device__ __forceinline__ void chunk_arrive(const Args& a, const Rank& me, int c,
                                             unsigned items) {
  fence<false>();
  __syncthreads();
  if (threadIdx.x == 0) {
    if (atomicAdd(me.ready + c, 1u) + 1u == items) {
      atomicExch(me.ready + c, 0u);
      fence<false>();
      st_release<false>(me.ready + kMaxRanks + c, a.seq);
    }
  }
  __syncthreads();  // the next item reuses the shared histogram
}

template <int kMode, bool kSys>
__global__ void __launch_bounds__(kFusedThreads, 2)
fused_hist_ring_kernel(const __grid_constant__ Args a) {
  using T = typename seg::Accum<kMode>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const seg::Smem<T> sm = seg::carve<T>(smem_raw, a.group, a.num_bins);
  const int rank = a.local[blockIdx.y];
  const Rank& me = a.r[rank];
  T* work = static_cast<T*>(me.work);
  const int D = a.ranks;
  const int nb = gridDim.x;

  // phase 1: items (chunk rank - k, sub-group s, tile t) in the order of
  // k, s, t; block nb - 1 - p takes items p, p + nb, ...
  if (me.tiles > 0) {
    const int inner = a.num_bins * 3;
    const int stride = seg::feature_words(a.num_bins);
    const int64_t rows = (me.cnt + me.tiles - 1) / me.tiles;
    for (int64_t q = nb - 1 - static_cast<int>(blockIdx.x);; q += nb) {
      int k = 0, c = rank;
      ChunkFeatures cf = chunk_features(a, c);
      int64_t rem = q;
      while (rem >= cf.nsub * me.tiles) {
        rem -= cf.nsub * me.tiles;
        if (++k == D) break;
        c = (rank - k + D) % D;
        cf = chunk_features(a, c);
      }
      if (k == D) break;
      const int s = static_cast<int>(rem / me.tiles);
      const int64_t t = rem - s * me.tiles;
      const int f0 = cf.fa + s * a.group;
      const int fg = min(a.group, cf.fb - f0);
      const int64_t i0 = t * rows;
      const int64_t i1 = i0 + rows < me.cnt ? i0 + rows : me.cnt;
      seg::zero_hist(sm.hist, a.replicas * fg * stride);
      seg::accumulate_rows<kMode>(me.bins, static_cast<const T*>(me.gh), me.row_order, me.off,
                                  i0, i1, a.f, f0, fg, a.num_bins, a.replicas, sm);
      // this chunk's cells of the sub-group
      const int64_t c_lo = static_cast<int64_t>(c) * a.chunk;
      const int64_t c_hi = c_lo + a.chunk < a.total ? c_lo + a.chunk : a.total;
      const int64_t g_lo = static_cast<int64_t>(f0) * inner;
      const int lo = static_cast<int>((c_lo > g_lo ? c_lo : g_lo) - g_lo);
      const int hi = static_cast<int>((c_hi < g_lo + fg * inner ? c_hi : g_lo + fg * inner) - g_lo);
      T* dst = work + g_lo;
      seg::for_cells(sm.hist, lo, hi, fg, inner, stride, a.replicas,
                     [](int) -> const T* { return nullptr; }, 0, [&](int i, T v) {
                       if (v != T(0)) atomicAdd(dst + i, v);
                     });
      chunk_arrive(a, me, c, static_cast<unsigned>(cf.nsub * me.tiles));
    }
  }

  // phase 2: ring-reduce `work` into every rank's `out`, each chunk once
  // its items are in
  if (static_cast<int>(blockIdx.x) < a.nb_ring)
    ring_phase<T, true, kSys>(a, rank, blockIdx.x, a.nb_ring, DenseLoad<T>{work}, work,
                              ChunkReady{a, me});
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

// Blocks per rank for a grid of n_local ranks on the current device: `want`
// (at least 1), limited by how many blocks of `kernel` the card holds at
// once (a cooperative launch needs them all resident).  Returns 0 when not
// even one block per rank fits.
int blocks_per_rank(const void* kernel, int threads, size_t smem, int n_local, int64_t want) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
      cudaSuccess)
    return 0;
  int nb = per_sm * sm_count() / n_local;
  nb = nb < kMaxBlocks ? nb : kMaxBlocks;
  return want < nb ? (want > 1 ? static_cast<int>(want) : 1) : nb;
}

const void* fused_kernel(int mode, int sys) {
  switch (mode * 2 + (sys ? 1 : 0)) {
    case 0: return reinterpret_cast<const void*>(fused_hist_ring_kernel<0, false>);
    case 1: return reinterpret_cast<const void*>(fused_hist_ring_kernel<0, true>);
    case 4: return reinterpret_cast<const void*>(fused_hist_ring_kernel<2, false>);
    case 5: return reinterpret_cast<const void*>(fused_hist_ring_kernel<2, true>);
    default: return nullptr;
  }
}

int launch(const void* kernel, Args& a, int n_local, int nb, int threads, size_t smem,
           void* stream) {
  if (nb < 1 || nb > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(nb, n_local), dim3(threads),
                                                    params, smem,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int fill_common(Args& a, int ranks, int n_local, const int* local, void* const* out,
                void* const* slots, void* const* flags, int64_t total, int64_t chunk,
                unsigned seq) {
  if (ranks < 2 || ranks > kMaxRanks || n_local < 1 || n_local > ranks || seq == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a = Args{};
  a.ranks = ranks;
  a.total = total;
  a.chunk = chunk;
  a.seq = seq;
  for (int i = 0; i < n_local; ++i) {
    if (local[i] < 0 || local[i] >= ranks) return static_cast<int>(cudaErrorInvalidValue);
    a.local[i] = local[i];
  }
  for (int r = 0; r < ranks; ++r) {
    a.r[r].out = out[r];
    a.r[r].slots = slots[r];
    a.r[r].flags = static_cast<unsigned*>(flags[r]);
  }
  return 0;
}

}  // namespace

extern "C" {

// Flag words per rank per comm slot (the workspace's flag stride).
int ring_max_blocks() { return kMaxBlocks; }
int ring_max_ranks() { return kMaxRanks; }
int fused_hist_ring_threads() { return kFusedThreads; }

// Let device `dev` write into `peer`'s memory; raises no error when access
// is already enabled.  Restores the caller's current device.
int ring_enable_peer(int dev, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(dev);
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    e = cudaSuccess;
  }
  cudaSetDevice(prev);
  return static_cast<int>(e);
}

// Ring blocks per rank that this card asks for and can hold, for n_local
// ranks on the current device (0: not even one fits).  The ring needs the
// same count on every card of a mesh, because block b of every rank
// covers the same slice and waits on flag (slot, b): the caller takes the
// minimum over the mesh's cards and passes it to every launch as `nb`.
int ring_allreduce_blocks(int n_local, int64_t chunk) {
  if (n_local < 1) return 0;
  const int64_t want = (chunk + kThreads * kElemsPerThread - 1) / (kThreads * kElemsPerThread);
  return blocks_per_rank(reinterpret_cast<const void*>(ring_allreduce_kernel), kThreads, 0,
                         n_local, want);
}

int ring_allreduce_select_blocks(int n_local, int64_t chunk) {
  if (n_local < 1) return 0;
  const int64_t want = (chunk + kThreads * kElemsPerThread - 1) / (kThreads * kElemsPerThread);
  return blocks_per_rank(reinterpret_cast<const void*>(ring_select_kernel), kThreads, 0,
                         n_local, want);
}

// The opt-in shared memory a fused_hist_ring block may use on the current
// device, after letting the kernels use it; minus a cudaError on failure.
int fused_hist_ring_setup() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int budget = optin;
  for (int k = 0; k < 6; ++k) {
    const void* kernel = fused_kernel(k / 2, k % 2);
    if (!kernel) continue;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return -static_cast<int>(e);
    const int dyn = optin - static_cast<int>(attr.sharedSizeBytes);
    budget = dyn < budget ? dyn : budget;
  }
  for (int k = 0; k < 6; ++k) {
    const void* kernel = fused_kernel(k / 2, k % 2);
    if (!kernel) continue;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, budget);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  return budget;
}

// Blocks per rank of the fused kernel, with `smem` bytes of shared memory a
// block, that the current device holds at once for n_local ranks (0: not
// one fits).  Call fused_hist_ring_setup on the device first.
int fused_hist_ring_blocks(int mode, int sys, int smem, int n_local) {
  const void* kernel = fused_kernel(mode, sys);
  if (!kernel || n_local < 1 || smem < 0) return 0;
  return blocks_per_rank(kernel, kFusedThreads, smem, n_local, kMaxBlocks);
}

// One launch of nb blocks per rank on the current device for the n_local
// ranks `local` that live on it.  Pointer arrays have one entry per rank
// (all `ranks`).
int ring_allreduce_launch(int ranks, int n_local, const int* local, void* const* x,
                          void* const* out, void* const* slots, void* const* flags,
                          int64_t total, int64_t chunk, unsigned seq, int nb, void* stream) {
  Args a;
  int rc = fill_common(a, ranks, n_local, local, out, slots, flags, total, chunk, seq);
  if (rc) return rc;
  for (int r = 0; r < ranks; ++r) a.r[r].x = x[r];
  return launch(reinterpret_cast<const void*>(ring_allreduce_kernel), a, n_local, nb, kThreads,
                0, stream);
}

// The voted-column ring: hist[r] is rank r's local (m, f, B, 3) float32
// histogram (m = 1 for one slab), cand[r] its copy of the (m * k2,) int32
// candidate columns, out[r] its (m, k2, B, 3) result; inner = B * 3 and
// total = m * k2 * inner.  nb: as above.
int ring_allreduce_select_launch(int ranks, int n_local, const int* local, void* const* hist,
                                 void* const* cand, void* const* out, void* const* slots,
                                 void* const* flags, int f, int64_t k2, int64_t inner,
                                 int64_t total, int64_t chunk, unsigned seq, int nb,
                                 void* stream) {
  Args a;
  int rc = fill_common(a, ranks, n_local, local, out, slots, flags, total, chunk, seq);
  if (rc) return rc;
  if (f < 1 || k2 < 1 || inner < 1 || total % (k2 * inner) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.f = f;
  a.k2 = k2;
  a.inner = inner;
  for (int r = 0; r < ranks; ++r) {
    a.r[r].x = hist[r];
    a.r[r].cand = static_cast<const int32_t*>(cand[r]);
  }
  return launch(reinterpret_cast<const void*>(ring_select_kernel), a, n_local, nb, kThreads, 0,
                stream);
}

// ring_allreduce with every rank on the current device: x[r] is rank r's
// float32 partial of `total` elements, out the (ranks, total) result; one
// ordinary launch.
int direct_ring_allreduce_launch(int ranks, void* const* x, void* out, int64_t total,
                                 int64_t chunk, void* stream) {
  Direct a;
  if (!fill_direct(a, ranks, x, out, total, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec_ok(a, total)) {
    const int64_t blocks = cdiv(total / 4, kDenseThreads);
    direct_ring_allreduce_kernel<true>
        <<<static_cast<unsigned>(blocks < kDirectMaxGrid ? blocks : kDirectMaxGrid),
           kDenseThreads, 0, s>>>(a);
  } else {
    const int64_t blocks = cdiv(total, kDenseThreads);
    direct_ring_allreduce_kernel<false>
        <<<static_cast<unsigned>(blocks < kDirectMaxGrid ? blocks : kDirectMaxGrid),
           kDenseThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ring_select with every rank on the current device: hist[r] is rank r's
// local (m, f, B, 3) float32 histogram (m = 1 for one slab), cand the
// (m * k2,) int32 candidate columns on this device, out the (ranks, m, k2,
// B, 3) result; inner = B * 3 and total = m * k2 * inner.  One ordinary
// launch.
int direct_ring_select_launch(int ranks, void* const* hist, const void* cand, void* out,
                              int f, int64_t k2, int64_t inner, int64_t total,
                              int64_t chunk, void* stream) {
  Direct a;
  if (!fill_direct(a, ranks, hist, out, total, chunk) || f < 1 || k2 < 1 || inner < 1 ||
      inner > 0x7fffffff || total % (k2 * inner) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a.cand = static_cast<const int32_t*>(cand);
  a.f = f;
  a.k2 = k2;
  a.inner = inner;
  const bool vec = vec_ok(a, inner);
  const int64_t n = vec ? inner / 4 : inner;
  const int threads = static_cast<int>(n < kSelectThreads ? cdiv(n, 32) * 32 : kSelectThreads);
  const int64_t gx = cdiv(n, threads), rows = total / inner;
  const dim3 grid(static_cast<unsigned>(gx < kDirectMaxGrid ? gx : kDirectMaxGrid),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    direct_ring_select_kernel<true><<<grid, threads, 0, s>>>(a);
  else
    direct_ring_select_kernel<false><<<grid, threads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 = float32, 2 = int32 (seg_hist.cuh); sys: the mesh spans cards.
// seg: 3 x ranks words, rank r's segment row_order[r][off : off + cnt] at
// off = seg[r], cnt = seg[ranks + r], and its row tiles seg[2 * ranks + r]
// (0 iff cnt == 0).  `work` and
// `ready` are zero at the first launch; the kernel leaves them so (the
// flags of `ready` carry sequence numbers).  group: features per phase-1
// item, replicas: histogram copies per block; nb: blocks per rank of this
// launch, at most what
// fused_hist_ring_blocks reports; nb_ring: ring blocks per rank, at most
// nb and the same on every card of the mesh.
int fused_hist_ring_launch(int ranks, int n_local, const int* local, void* const* bins,
                           void* const* gh, void* const* row_order, const int64_t* seg,
                           void* const* work,
                           void* const* ready, void* const* out, void* const* slots,
                           void* const* flags, int f, int num_bins, int mode, int sys,
                           int group, int replicas, int64_t chunk, unsigned seq, int nb,
                           int nb_ring, void* stream) {
  Args a;
  const int64_t total = static_cast<int64_t>(f) * num_bins * 3;
  int rc = fill_common(a, ranks, n_local, local, out, slots, flags, total, chunk, seq);
  if (rc) return rc;
  if (f < 1 || num_bins < 1 || num_bins > 256 || group < 1 || group > seg::kMaxGroup ||
      replicas < 1 || nb_ring < 1 || nb_ring > nb)
    return static_cast<int>(cudaErrorInvalidValue);
  a.f = f;
  a.num_bins = num_bins;
  a.group = group;
  a.replicas = replicas;
  a.nb_ring = nb_ring;
  for (int r = 0; r < ranks; ++r) {
    const int64_t off = seg[r], cnt = seg[ranks + r], tiles = seg[2 * ranks + r];
    if (off < 0 || cnt < 0 || tiles < 0 || (tiles == 0) != (cnt == 0))
      return static_cast<int>(cudaErrorInvalidValue);
    a.r[r].bins = static_cast<const uint8_t*>(bins[r]);
    a.r[r].gh = gh[r];
    a.r[r].row_order = static_cast<const int32_t*>(row_order[r]);
    a.r[r].off = off;
    a.r[r].cnt = cnt;
    a.r[r].tiles = tiles;
    a.r[r].work = work[r];
    a.r[r].ready = static_cast<unsigned*>(ready[r]);
  }
  const void* kernel = fused_kernel(mode, sys);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  return launch(kernel, a, n_local, nb, kFusedThreads,
                seg::smem_bytes(group, replicas, num_bins, kFusedThreads / 32), stream);
}

}  // extern "C"
