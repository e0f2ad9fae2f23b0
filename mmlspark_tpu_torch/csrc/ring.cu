// Ring all-reduce across data shards, and the fused gather -> segment
// histogram -> ring kernel, written by hand for Hopper (sm_90a).  Built by
// mmlspark_tpu_torch/ops/_build.py with nvcc into a shared library with a
// plain C interface and called through ctypes (ops/cuda_ring.py).
//
// ring_allreduce replaces mmlspark_tpu/ops/pallas_collectives.py
// ring_allreduce (body _ring_allreduce_kernel, launcher _ring_flat): the sum
// over D shards of one float32 partial each, delivered to every shard.
// fused_hist_ring replaces fused_segment_hist_ring (body
// _fused_hist_ring_kernel): each shard gathers its DataPartition segment
// row_order[off : off + cnt], histograms it, and the (f, B, 3) partials are
// ring-reduced in the same kernel (float32 or exact int32).
// ring_select replaces ring_allreduce_select (the same TPU body under its
// own collective id, with _gather_cand before it): the PV-Tree voted-column
// reduction.  Each shard holds a local (f, B, 3) histogram, or the (m, f, B,
// 3) stack of one grow step's children, and the candidate columns cand (k2,)
// or (m, k2), identical on every shard (they come from the gathered votes);
// the ring sums only the gathered (k2, B, 3) or (m, k2, B, 3) slab.
//
// Schedule.  Both follow the TPU kernel's ring exactly: the flattened
// payload of `total` elements is cut into D chunks of `chunk` = cb * 128
// elements (cb = ceil(ceil(total / 128) / D), _ring_flat's padding; the pad
// is never materialised, elements past `total` read as zero and are not
// written).  Reduce-scatter: at step k = 0 rank r sends its own chunk r to
// rank r + 1; at steps k = 1 .. D-1 it adds its local part of chunk r - k to
// the partial that arrived from rank r - 1 and sends the sum on.  After step
// D-1 rank r holds the total of chunk r + 1.  All-gather: D-1 forwarding
// steps.  Chunk c is therefore summed ((x_c + x_{c+1}) + x_{c+2}) + ...,
// the TPU kernel's order, so float32 results equal the plain twin
// (ops/collectives.py ring_allreduce_plain) bit for bit; no atomics touch
// the ring.
//
// Transport.  A pointer table (struct Args, a __grid_constant__ kernel
// parameter) gives each rank's input, output, comm slots and flag words.
// Rank r pushes: it stores its finished chunk into rank r + 1's comm slot,
// fences (__threadfence_system), then raises r + 1's flag for that slot with
// st.release.sys; the receiver spins on ld.acquire.sys and reads the slot
// through L2 (__ldcg).  The pointers may lie on one card (D virtual shards)
// or on peer cards (the wrapper enables peer access), so the same code runs
// on one card or many.  Where the TPU kernel double-buffers two comm slots
// under DMA semaphores, each step here owns its own slot (2(D-1) per rank):
// no slot is reused within a launch, so no back-pressure handshake is
// needed, and a rank can only reach a slot in launch s + 1 after its right
// neighbour has consumed it in launch s (the reduce-scatter of s + 1 cannot
// finish before that neighbour has finished s).  Flags carry a per-workspace
// launch sequence number, so nothing is reset between launches.
//
// Blocks.  The ring decomposes by element: block b of every rank handles
// the same slice of each chunk, and talks only to block b of its two
// neighbours (one flag per (slot, block)), so every card of a mesh must
// launch the same number of blocks per rank: the wrapper asks each card
// what it wants and holds (ring_allreduce_blocks, fused_hist_ring_blocks),
// takes the minimum over the mesh, and passes that one count to every
// card's launch.  One cooperative launch per card
// covers every rank on that card (grid y = local rank), so every block that
// another block waits on is resident; a grid that does not fit fails to
// launch instead of hanging.  Every wait is bounded by kWaitSeconds of
// %globaltimer and __trap()s when it runs out, so a broken handshake
// surfaces as an error at the next synchronize, not as a hung card.
//
// ring_select.  ring_phase takes its payload through a loader; the select
// ring's (SelectLoad) reads element (mm, kk, b, c) of the slab straight from
// the rank's local histogram, hist[mm][cand[mm][kk]][b][c], so the gather
// and the ring are one kernel with no staging copy, as the TPU kernel
// gathers in its body.  The slab is flattened as one
// array ((m, k2, B, 3) for a pair) before it is cut into chunks, so it is
// summed in the twin's order (ring_allreduce_select_plain) bit for bit.  A
// candidate index outside [0, f) traps the kernel (an error at the next
// synchronize) instead of reading outside the histogram.  The select ring
// has its own workspace (comm slots and flags), the counterpart of the TPU
// kernel's own collective id: dense and voted rings never share a flag.
//
// fused_hist_ring.  Phase 1: the rank's blocks walk (feature group, row
// tile) items of its segment with the shared-memory privatised histogram of
// hist_segment (hist_block.cuh), flushing into the rank's `work` buffer.  A
// barrier over the rank's blocks (arrive counter + generation word) ends the
// phase.  Phase 2: the ring above over `work`; each block then zeroes its
// slice of `work`, so the buffer is zero for the next launch without a
// memset.  Each rank takes its own exact `cnt` (no padding to a global
// bucket).  This first version finishes the whole local histogram before it
// rings; the TPU kernel's overlap of one chunk's transfer with the next
// chunk's histogram is later work.
//
// Bound (H100 SXM, 3.35 TB/s HBM, 450 GB/s NVLink each way).  The bound
// counts what the function must move, not what the ring chooses to move
// through its slots.  ring_allreduce on the flagship payload (50, 256, 3)
// f32 = 153,600 B, D shards on one card: read the D partials and write the
// D outputs, 2 x D x 153,600 B = 1.23 MB at D = 4, 0.37 us; its adds are
// negligible.  Across cards, one shard a card: each card reads its partial
// and writes its output, and 2(D-1)/D of the payload must cross NVLink each
// way, 0.51 us at D = 4.  What holds it back is latency, not bytes: 2(D-1)
// flag handshakes in sequence, each a fenced store and a poll through L2
// (or NVLink).  fused_hist_ring at 100,000 rows per shard, f = 50, D = 4
// must read 4 x (5 MB bins + 1.2 MB gh + 0.4 MB row ids) = 26.4 MB and
// write the 4 reduced outputs, 0.61 MB: 8.06 us; like hist_segment it is
// held back by shared-memory atomics in phase 1 and by the handshakes in
// phase 2.
//
// ring_select on the wide voting configuration (topK 32, so k2 = 64 of
// f = 2000 columns, B = 256): the pair slab is (2, 64, 256, 3) f32 =
// 393,216 B; at D = 4 shards on one card the function reads the 4 gathered
// slabs and writes 4 outputs, 3.15 MB, 0.94 us.  Like ring_allreduce it is
// held back by its 2(D-1) handshakes, not by bytes.
//
// Each entry returns cudaGetLastError() (or the launch's own error); the
// kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"

namespace {

constexpr int kMaxRanks = 16;
constexpr int kMaxBlocks = 1024;      // ring blocks per rank; flag stride
constexpr int kThreads = hist::kThreads;
constexpr int kElemsPerThread = 4;    // ring_allreduce grid sizing
constexpr int kHistBlocksPerSM = 4;   // fused_hist_ring grid sizing
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
  void* work;          //   local (f, B, 3) histogram, zero between launches
  unsigned* bar;       //   [arrived blocks, generation]
};

struct Args {
  Rank r[kMaxRanks];
  int local[kMaxRanks];  // global rank of block row blockIdx.y
  int ranks;             // D
  int f, num_bins, groups;
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

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void spin_until(const unsigned* p, unsigned v) {
  const unsigned long long t0 = now_ns();
  while (ld_acquire(p) != v) {
    if (now_ns() - t0 > kWaitNs) __trap();
  }
}

// Block-wide receive: thread 0 waits for the flag, then the block goes on.
__device__ __forceinline__ void block_wait(const unsigned* flag, unsigned seq) {
  if (threadIdx.x == 0) spin_until(flag, seq);
  __syncthreads();
}

// Block-wide send: every thread's stores so far become visible system-wide
// before thread 0 raises the flag.
__device__ __forceinline__ void block_signal(unsigned* flag, unsigned seq) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) st_release(flag, seq);
}

// Barrier over the `nblocks` blocks of one rank: the last block to arrive
// resets the counter and publishes the generation `seq`.
__device__ __forceinline__ void rank_barrier(unsigned* bar, unsigned nblocks, unsigned seq) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned arrived = atomicAdd(bar, 1u) + 1u;
    if (arrived == nblocks) {
      atomicExch(bar, 0u);
      __threadfence();
      st_release(bar + 1, seq);
    } else {
      spin_until(bar + 1, seq);
    }
  }
  __syncthreads();
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

// Block b (of nb) of `rank` runs its slice of the ring over the payload
// that `load` reads.  kZeroX: zero x's slice once the reduce-scatter has
// read it (x is the payload that `load` reads).
template <typename T, bool kZeroX, typename Load>
__device__ void ring_phase(const Args& a, int rank, int b, int nb, const Load& load, T* x) {
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
  for (int64_t i = i0; i < cs; i += stride) {
    const int64_t e = static_cast<int64_t>(rank) * cs + i;
    __stcg(theirs + i, e < total ? load(e) : T(0));
  }
  block_signal(right.flags + b, a.seq);
  // steps 1 .. D-1: add the local part of chunk rank - k to the partial
  // from the left and pass it on; step D-1 completes chunk rank + 1, and
  // its send is the first all-gather step
  for (int k = 1; k < D; ++k) {
    block_wait(me.flags + static_cast<int64_t>(k - 1) * kMaxBlocks + b, a.seq);
    const int c = (rank - k + D) % D;
    const T* in = mine + static_cast<int64_t>(k - 1) * cs;
    T* fwd = theirs + static_cast<int64_t>(k) * cs;
    for (int64_t i = i0; i < cs; i += stride) {
      const int64_t e = static_cast<int64_t>(c) * cs + i;
      const T v = (e < total ? load(e) : T(0)) + __ldcg(in + i);
      if (k == D - 1 && e < total) out[e] = v;
      __stcg(fwd + i, v);
    }
    block_signal(right.flags + static_cast<int64_t>(k) * kMaxBlocks + b, a.seq);
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
    block_wait(me.flags + static_cast<int64_t>(s) * kMaxBlocks + b, a.seq);
    const int c = (rank + 1 - j + D) % D;
    const T* in = mine + static_cast<int64_t>(s) * cs;
    T* fwd = theirs + static_cast<int64_t>(s + 1) * cs;
    for (int64_t i = i0; i < cs; i += stride) {
      const T v = __ldcg(in + i);
      const int64_t e = static_cast<int64_t>(c) * cs + i;
      if (e < total) out[e] = v;
      if (j < D - 1) __stcg(fwd + i, v);
    }
    if (j < D - 1) block_signal(right.flags + static_cast<int64_t>(s + 1) * kMaxBlocks + b, a.seq);
  }
}

__global__ void __launch_bounds__(kThreads) ring_allreduce_kernel(const __grid_constant__ Args a) {
  const int rank = a.local[blockIdx.y];
  const DenseLoad<float> load{static_cast<const float*>(a.r[rank].x)};
  ring_phase<float, false>(a, rank, blockIdx.x, gridDim.x, load, static_cast<float*>(nullptr));
}

__global__ void __launch_bounds__(kThreads) ring_select_kernel(const __grid_constant__ Args a) {
  const int rank = a.local[blockIdx.y];
  const Rank& me = a.r[rank];
  const SelectLoad load{static_cast<const float*>(me.x), me.cand, a.f, a.k2, a.inner};
  ring_phase<float, false>(a, rank, blockIdx.x, gridDim.x, load, static_cast<float*>(nullptr));
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) fused_hist_ring_kernel(const __grid_constant__ Args a) {
  using T = typename hist::Accum<kMode>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rank = a.local[blockIdx.y];
  const Rank& me = a.r[rank];
  T* work = static_cast<T*>(me.work);
  const int nb = gridDim.x;

  // phase 1: this rank's segment histogram into `work`
  const int64_t cnt = me.cnt;
  if (cnt > 0) {
    const int64_t want = (nb + a.groups - 1) / a.groups;
    int64_t tiles = cnt / kThreads;
    tiles = tiles < want ? tiles : want;
    tiles = tiles > 1 ? tiles : 1;
    const int64_t rows = (cnt + tiles - 1) / tiles;
    const int64_t items = ((cnt + rows - 1) / rows) * a.groups;
    for (int64_t it = blockIdx.x; it < items; it += nb) {
      const int g = static_cast<int>(it % a.groups);
      const int64_t i0 = (it / a.groups) * rows;
      const int64_t i1 = i0 + rows < cnt ? i0 + rows : cnt;
      hist::accumulate_tile<kMode, true>(me.bins, static_cast<const T*>(me.gh), me.row_order,
                                         me.off, i0, i1, a.f, g * hist::kGroup, a.num_bins,
                                         reinterpret_cast<T*>(smem_raw), work);
    }
  }
  rank_barrier(me.bar, nb, a.seq);

  // phase 2: ring-reduce `work` into every rank's `out`
  const int64_t need = (a.chunk + kThreads - 1) / kThreads;
  const int nb_ring = static_cast<int>(need < nb ? need : nb);
  if (static_cast<int>(blockIdx.x) < nb_ring)
    ring_phase<T, true>(a, rank, blockIdx.x, nb_ring, DenseLoad<T>{work}, work);
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
int blocks_per_rank(const void* kernel, size_t smem, int n_local, int64_t want) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
      cudaSuccess)
    return 0;
  int nb = per_sm * sm_count() / n_local;
  nb = nb < kMaxBlocks ? nb : kMaxBlocks;
  return want < nb ? (want > 1 ? static_cast<int>(want) : 1) : nb;
}

const void* fused_kernel(int mode) {
  switch (mode) {
    case 0: return reinterpret_cast<const void*>(fused_hist_ring_kernel<0>);
    case 2: return reinterpret_cast<const void*>(fused_hist_ring_kernel<2>);
    default: return nullptr;
  }
}

size_t fused_smem(int num_bins) { return static_cast<size_t>(hist::kGroup) * num_bins * 3 * 4; }

int launch(const void* kernel, Args& a, int n_local, int nb, size_t smem, void* stream) {
  if (nb < 1 || nb > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(nb, n_local), dim3(kThreads),
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
  return blocks_per_rank(reinterpret_cast<const void*>(ring_allreduce_kernel), 0, n_local, want);
}

int ring_allreduce_select_blocks(int n_local, int64_t chunk) {
  if (n_local < 1) return 0;
  const int64_t want = (chunk + kThreads * kElemsPerThread - 1) / (kThreads * kElemsPerThread);
  return blocks_per_rank(reinterpret_cast<const void*>(ring_select_kernel), 0, n_local, want);
}

int fused_hist_ring_blocks(int mode, int num_bins, int n_local) {
  const void* kernel = fused_kernel(mode);
  if (!kernel || n_local < 1 || num_bins < 1 || num_bins > 256) return 0;
  return blocks_per_rank(kernel, fused_smem(num_bins), n_local,
                         kHistBlocksPerSM * sm_count() / n_local);
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
  return launch(reinterpret_cast<const void*>(ring_allreduce_kernel), a, n_local, nb, 0, stream);
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
  return launch(reinterpret_cast<const void*>(ring_select_kernel), a, n_local, nb, 0, stream);
}

// mode: 0 = float32, 2 = int32 (hist_block.cuh).  `work` and `bar` are
// zero at the first launch; the kernel leaves them so.  nb: as above.
int fused_hist_ring_launch(int ranks, int n_local, const int* local, void* const* bins,
                           void* const* gh, void* const* row_order, const int64_t* off,
                           const int64_t* cnt, void* const* work, void* const* bar,
                           void* const* out, void* const* slots, void* const* flags, int f,
                           int num_bins, int mode, int64_t chunk, unsigned seq, int nb,
                           void* stream) {
  Args a;
  const int64_t total = static_cast<int64_t>(f) * num_bins * 3;
  int rc = fill_common(a, ranks, n_local, local, out, slots, flags, total, chunk, seq);
  if (rc) return rc;
  if (f < 1 || num_bins < 1 || num_bins > 256) return static_cast<int>(cudaErrorInvalidValue);
  a.f = f;
  a.num_bins = num_bins;
  a.groups = (f + hist::kGroup - 1) / hist::kGroup;
  for (int r = 0; r < ranks; ++r) {
    a.r[r].bins = static_cast<const uint8_t*>(bins[r]);
    a.r[r].gh = gh[r];
    a.r[r].row_order = static_cast<const int32_t*>(row_order[r]);
    a.r[r].off = off[r];
    a.r[r].cnt = cnt[r];
    a.r[r].work = work[r];
    a.r[r].bar = static_cast<unsigned*>(bar[r]);
  }
  const void* kernel = fused_kernel(mode);
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  return launch(kernel, a, n_local, nb, fused_smem(num_bins), stream);
}

}  // extern "C"
