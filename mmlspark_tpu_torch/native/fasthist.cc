// Gradient histograms, the DataPartition split and the split scan on the
// host: the GBDT hot loop of a CPU fit.
//
// The port's copy of mmlspark_tpu/native/fasthist_ffi.cc.  The reference
// binds these loops as XLA FFI handlers, whose headers come from jaxlib;
// here each is a plain C function over pointers and sizes, loaded with
// ctypes (ops/histogram.py checks every shape, dtype and contiguity before
// the call and allocates the outputs).  The loop bodies are the
// reference's, unchanged, so the floats are its floats.
//
// Same accumulation loop as LightGBM's ConstructHistograms: one row pass,
// three fused adds per row-feature into an L2-resident (f, B, 3) float32
// accumulator.  Masked rows (g == h == c == 0) skip.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <new>
#include <vector>

// The entries that allocate return 1 when the host is out of memory (an
// exception must not cross the C interface); every entry returns 0 on
// success.

// bins (n, f) u8, gh (n, 3) f32 -> out (f, B, 3) f32.
extern "C" int mmlspark_hist(const uint8_t* b, const float* g, int64_t n,
                             int64_t f, int64_t B, float* o) {
  std::fill(o, o + f * B * 3, 0.f);
  for (int64_t i = 0; i < n; ++i) {
    const float gi = g[3 * i];
    const float hi = g[3 * i + 1];
    const float ci = g[3 * i + 2];
    if (gi == 0.f && hi == 0.f && ci == 0.f) continue;  // masked row
    const uint8_t* br = b + i * f;
    for (int64_t j = 0; j < f; ++j) {
      int64_t bin = br[j];
      if (bin >= B) bin = B - 1;  // safety clamp; mapper guarantees < B
      float* cell = o + (j * B + bin) * 3;
      cell[0] += gi;
      cell[1] += hi;
      cell[2] += ci;
    }
  }
  return 0;
}

// Segment histogram with a dynamic offset and count straight off the
// DataPartition row permutation: the loop runs exactly `cnt` rows.
// bins (n, f) u8, gh (n, 3) f32, row_order (m,) i32, [off, off + cnt)
// -> out (f, B, 3) f32.
extern "C" int mmlspark_seg_hist(const uint8_t* b, const float* g, int64_t n,
                                 int64_t f, const int32_t* ro, int64_t m,
                                 int64_t off, int64_t cnt, int64_t B,
                                 float* o) {
  if (off < 0) off = 0;
  if (off + cnt > m) cnt = m - off;
  std::fill(o, o + f * B * 3, 0.f);
  // the permutation makes every row access random: prefetch a few rows
  // ahead so the DRAM fetch overlaps the current row's accumulate
  // (LightGBM's indexed ConstructHistograms does the same)
  constexpr int64_t kPrefetch = 8;
  for (int64_t i = 0; i < cnt; ++i) {
    if (i + kPrefetch < cnt) {
      const int64_t pr = ro[off + i + kPrefetch];
      if (pr >= 0 && pr < n) {
        __builtin_prefetch(b + pr * f);
        __builtin_prefetch(b + pr * f + f - 1);  // row tail (2nd line if any)
        __builtin_prefetch(g + 3 * pr);
      }
    }
    int64_t row = ro[off + i];
    if (row < 0 || row >= n) continue;  // pad sentinel
    const float gi = g[3 * row];
    const float hi = g[3 * row + 1];
    const float ci = g[3 * row + 2];
    if (gi == 0.f && hi == 0.f && ci == 0.f) continue;  // bagged out
    const uint8_t* br = b + row * f;
    for (int64_t j = 0; j < f; ++j) {
      int64_t bin = br[j];
      if (bin >= B) bin = B - 1;
      float* cell = o + (j * B + bin) * 3;
      cell[0] += gi;
      cell[1] += hi;
      cell[2] += ci;
    }
  }
  return 0;
}

// DataPartition::Split as one stable in-place pass: the leaf's
// contiguous segment row_order[off, off + cnt) becomes left | right by
// the split column (bin <= thr, or with use_cat the bin's bit in the
// (W,) u32 bitset).  counts = [cnt_left, cnt_right].
extern "C" int mmlspark_partition(int32_t* ro, int64_t m, const uint8_t* c,
                                  int64_t n, int64_t off, int64_t cnt,
                                  int32_t thr, int use_cat,
                                  const uint32_t* bits, int64_t W,
                                  int32_t* counts) try {
  if (off < 0) off = 0;
  if (off + cnt > m) cnt = m - off;
  const int64_t max_bin = W * 32;  // bitset span
  std::vector<int32_t> right;
  right.reserve(static_cast<size_t>(cnt));
  int64_t w = off;
  constexpr int64_t kPrefetch = 16;
  for (int64_t i = 0; i < cnt; ++i) {
    if (i + kPrefetch < cnt) {
      const int32_t pr = ro[off + i + kPrefetch];
      if (pr >= 0 && pr < n) __builtin_prefetch(c + pr);
    }
    const int32_t row = ro[off + i];
    int64_t bin = (row >= 0 && row < n) ? c[row] : 0;
    if (bin >= max_bin) bin = max_bin - 1;  // clamp, like the hist kernels
    const bool left = use_cat ? ((bits[bin >> 5] >> (bin & 31)) & 1u) != 0
                              : bin <= thr;
    if (left) {
      ro[w++] = row;
    } else {
      right.push_back(row);
    }
  }
  std::copy(right.begin(), right.end(), ro + w);
  counts[0] = static_cast<int32_t>(w - off);
  counts[1] = static_cast<int32_t>(right.size());
  return 0;
} catch (const std::bad_alloc&) {
  return 1;
}

// Numeric best-split scan over a (f, B, 3) histogram (LightGBM's
// FindBestThreshold).  Same validity rules and first-occurrence
// (feature-major, bin-minor) argmax order as grower.split_gains: left =
// bins <= b, last bin excluded, min_data_in_leaf / min_sum_hessian gates,
// gain = leaf_gain(l) + leaf_gain(r) - leaf_gain(parent) in the
// l1-threshold form.  The sequential f32 prefix sums here round
// differently from the bins-axis prefix sum of the plain path, so this
// scan's contribution is the WINNING (feature, bin): ops/histogram.py
// native_find_split recomputes the recorded gain in that path's order.
// parent (3,) = [g, h, c]; conf (6,) = [min_data_in_leaf,
// min_sum_hessian, lambda_l1, lambda_l2, gain_floor, depth_ok]; writes
// gain (1,) and fb (2,) = [feature, bin].
static inline float LeafGainL1(float g, float h, float l1, float l2) {
  float t = std::fabs(g) - l1;
  if (t < 0.f) t = 0.f;
  t = std::copysign(t, g);
  if (g == 0.f) t = 0.f;  // sign(0) == 0
  return (t * t) / (h + l2);
}

extern "C" int mmlspark_split(const float* h, int64_t f, int64_t B,
                              const float* parent, const float* fm,
                              const float* cf, float* gain_out,
                              int32_t* fb_out) {
  const float pg = parent[0];
  const float ph = parent[1];
  const float pc = parent[2];
  const float min_cnt = cf[0];
  const float min_hess = cf[1];
  const float l1 = cf[2];
  const float l2 = cf[3];
  const float gain_floor = cf[4];
  const bool depth_ok = cf[5] != 0.f;
  const float parent_gain = LeafGainL1(pg, ph, l1, l2);
  float best = -std::numeric_limits<float>::infinity();
  int32_t bf = 0, bb = 0;
  if (depth_ok) {
    for (int64_t j = 0; j < f; ++j) {
      if (!(fm[j] > 0.f)) continue;
      const float* hj = h + j * B * 3;
      float gl = 0.f, hl = 0.f, cl = 0.f;
      for (int64_t b = 0; b + 1 < B; ++b) {  // last bin excluded
        gl += hj[3 * b];
        hl += hj[3 * b + 1];
        cl += hj[3 * b + 2];
        const float gr = pg - gl;
        const float hr = ph - hl;
        const float cr = pc - cl;
        if (cl >= min_cnt && cr >= min_cnt && hl >= min_hess &&
            hr >= min_hess) {
          const float gain = LeafGainL1(gl, hl, l1, l2) +
                             LeafGainL1(gr, hr, l1, l2) - parent_gain;
          if (gain > best) {  // strict: first occurrence wins, like argmax
            best = gain;
            bf = static_cast<int32_t>(j);
            bb = static_cast<int32_t>(b);
          }
        }
      }
    }
  }
  gain_out[0] = best > gain_floor ? best
                                  : -std::numeric_limits<float>::infinity();
  fb_out[0] = bf;
  fb_out[1] = bb;
  return 0;
}

// ---------------------------------------------------------------------------
// Quantized-gradient histograms.  gh holds int16 GRID CODES; accumulation
// is exact int32.  Two modes, chosen by `packed` (set by the caller from
// the headroom bound ops/histogram.packed_accum_ok):
//
//   packed — the (g, h, count) triple is folded into ONE biased uint64
//     per row: [g + mc : 24 bits][h + mc : 24 bits][count : 16 bits],
//     and the inner loop does a SINGLE 64-bit add per row-feature into
//     an (f, B) uint64 scratch — a third of the adds and 8 bytes of
//     cell traffic instead of 12.  The bias keeps all fields
//     non-negative so field-carries cannot happen while
//     n * 2*max_code < 2^24 and n < 2^16.  Exactness contract per row:
//     count == 1 and |code| <= mc (the training invariant — the count
//     channel is the 0/1 bag mask and the quantizer clips).  Rows that
//     violate it (and count==0 rows) accumulate DIRECTLY into the int32
//     output instead, so the result is exact for any input; the final
//     unpack ADDS the scratch into the output.
//
//   unpacked — three int32 adds per row-feature, no scratch; used when
//     the packed bound fails.
namespace {

struct QAccum {
  int64_t f, B, mc;
  bool packed;
  int32_t* o;                  // (f, B, 3) int32, pre-zeroed
  std::vector<uint64_t> acc;   // (f, B) packed scratch (packed mode)

  void Init(int64_t f_, int64_t B_, int64_t mc_, bool packed_,
            int32_t* o_) {
    f = f_;
    B = B_;
    mc = mc_;
    packed = packed_;
    o = o_;
    std::fill(o, o + f * B * 3, 0);
    if (packed) acc.assign(static_cast<size_t>(f * B), 0ull);
  }

  inline void Row(const uint8_t* br, int32_t gi, int32_t hi, int32_t ci) {
    if (packed && ci == 1 && gi >= -mc && gi <= mc && hi >= -mc &&
        hi <= mc) {
      const uint64_t pv =
          (static_cast<uint64_t>(static_cast<uint32_t>(gi + mc)) << 40) |
          (static_cast<uint64_t>(static_cast<uint32_t>(hi + mc)) << 16) |
          1ull;
      uint64_t* a = acc.data();
      for (int64_t j = 0; j < f; ++j) {
        int64_t bin = br[j];
        if (bin >= B) bin = B - 1;
        a[j * B + bin] += pv;
      }
      return;
    }
    if (gi == 0 && hi == 0 && ci == 0) return;  // masked row
    for (int64_t j = 0; j < f; ++j) {
      int64_t bin = br[j];
      if (bin >= B) bin = B - 1;
      int32_t* cell = o + (j * B + bin) * 3;
      cell[0] += gi;
      cell[1] += hi;
      cell[2] += ci;
    }
  }

  void Finish() {
    if (!packed) return;
    const uint64_t* a = acc.data();
    for (int64_t c = 0; c < f * B; ++c) {
      const uint64_t v = a[c];
      if (v == 0) continue;
      const int64_t k = static_cast<int64_t>(v & 0xFFFFull);
      const int64_t hs =
          static_cast<int64_t>((v >> 16) & 0xFFFFFFull) - k * mc;
      const int64_t gs = static_cast<int64_t>(v >> 40) - k * mc;
      int32_t* cell = o + c * 3;
      cell[0] += static_cast<int32_t>(gs);
      cell[1] += static_cast<int32_t>(hs);
      cell[2] += static_cast<int32_t>(k);
    }
  }
};

}  // namespace

// bins (n, f) u8, gh (n, 3) s16 -> out (f, B, 3) s32.
extern "C" int mmlspark_qhist(const uint8_t* b, const int16_t* g, int64_t n,
                              int64_t f, int64_t B, int packed, int64_t mc,
                              int32_t* out) try {
  QAccum q;
  q.Init(f, B, mc, packed != 0, out);
  for (int64_t i = 0; i < n; ++i) {
    q.Row(b + i * f, g[3 * i], g[3 * i + 1], g[3 * i + 2]);
  }
  q.Finish();
  return 0;
} catch (const std::bad_alloc&) {
  return 1;
}

// Quantized segment histogram off the DataPartition permutation:
// bins (n, f) u8, gh (n, 3) s16, row_order (m,) s32, [off, off + cnt)
// -> out (f, B, 3) s32.
extern "C" int mmlspark_seg_qhist(const uint8_t* b, const int16_t* g,
                                  int64_t n, int64_t f, const int32_t* ro,
                                  int64_t m, int64_t off, int64_t cnt,
                                  int64_t B, int packed, int64_t mc,
                                  int32_t* out) try {
  if (off < 0) off = 0;
  if (off + cnt > m) cnt = m - off;
  QAccum q;
  q.Init(f, B, mc, packed != 0, out);
  constexpr int64_t kPrefetch = 8;
  for (int64_t i = 0; i < cnt; ++i) {
    if (i + kPrefetch < cnt) {
      const int64_t pr = ro[off + i + kPrefetch];
      if (pr >= 0 && pr < n) {
        __builtin_prefetch(b + pr * f);
        __builtin_prefetch(b + pr * f + f - 1);
        __builtin_prefetch(g + 3 * pr);
      }
    }
    const int64_t row = ro[off + i];
    if (row < 0 || row >= n) continue;  // pad sentinel
    q.Row(b + row * f, g[3 * row], g[3 * row + 1], g[3 * row + 2]);
  }
  q.Finish();
  return 0;
} catch (const std::bad_alloc&) {
  return 1;
}
