// Feature binning on the host: the BinMapper's quantization loop.
//
// The port's copy of mmlspark_tpu/native/fastbin.cc, whose loop body it
// carries over unchanged (the reference's CPython buffer wrapper is
// replaced by a plain C function over pointers and sizes, loaded with
// ctypes; gbdt/binning.py checks every shape, dtype and contiguity before
// the call).  Raw float features -> per-feature quantile bin indices, an
// interpolation-table hint plus a local probe, or a binary search where
// the hint table would degenerate.
//
// Exactness contract: callers pass float32 bounds ADJUSTED DOWNWARD to the
// largest float32 <= the true float64 bound, which makes (bound < v)
// decisions identical to float64 for every float32 input v (binning.py
// states the proof).  float64 inputs use the raw float64 bounds.

#include <algorithm>
#include <cstdint>

namespace {

// T is the raw feature type; BT the bound type (float for adjusted-f32
// bounds, double for raw-f64 bounds).
template <typename T, typename BT>
void BinColumns(const T* x, int64_t n, int64_t f, const BT* bext, int64_t m,
                const int32_t* nb, const int32_t* base, int64_t cells,
                const float* lo, const float* scale, const uint8_t* use_table,
                int missing_bin, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const T* xrow = x + i * f;
    uint8_t* orow = out + i * f;
    for (int64_t j = 0; j < f; ++j) {
      T v = xrow[j];
      if (v != v) {  // NaN
        orow[j] = static_cast<uint8_t>(missing_bin);
        continue;
      }
      int32_t nbj = nb[j];
      if (nbj == 0) {
        orow[j] = 0;
        continue;
      }
      const BT* be = bext + j * m;
      int32_t b;
      if (use_table[j]) {
        // hint from the uniform grid, then probe.  The hint only has to
        // be *near* the answer: the two probe loops correct either way,
        // so float rounding in the k computation cannot misbin.
        float kf = (static_cast<float>(v) - lo[j]) * scale[j];
        // range-check BEFORE the int cast: casting non-finite or
        // out-of-range floats to int64 is UB (huge f64 inputs overflow the
        // f32 cast to +/-inf; !(kf >= 0) also catches NaN)
        int64_t k;
        if (!(kf >= 0.0f)) {
          k = 0;
        } else if (kf >= static_cast<float>(cells)) {
          k = cells - 1;
        } else {
          k = static_cast<int64_t>(kf);
        }
        b = base[j * cells + k];
        while (b > 0 && !(be[b - 1] < v)) --b;
        while (b < nbj && be[b] < v) ++b;
      } else {
        // first index with be[idx] >= v  ==  count of bounds < v
        b = static_cast<int32_t>(
            std::lower_bound(be, be + nbj, v,
                             [](BT a, T val) { return a < val; }) -
            be);
      }
      orow[j] = static_cast<uint8_t>(b);
    }
  }
}

}  // namespace

// X (n, f) float32 (is64 = 0) or float64 (is64 = 1), row-major;
// bext (f, m) bounds of X's type; nb (f,) bounds per feature; base (f,
// cells) grid hint table; lo, scale (f,) grid origin and inverse cell
// width; use_table (f,) 1 = grid + probe, 0 = binary search; out (n, f)
// uint8, written.
extern "C" int mmlspark_bin_columns(const void* x, int is64, int64_t n,
                                    int64_t f, const void* bext, int64_t m,
                                    const int32_t* nb, const int32_t* base,
                                    int64_t cells, const float* lo,
                                    const float* scale,
                                    const uint8_t* use_table,
                                    int missing_bin, uint8_t* out) {
  if (is64) {
    BinColumns<double, double>(static_cast<const double*>(x), n, f,
                               static_cast<const double*>(bext), m, nb, base,
                               cells, lo, scale, use_table, missing_bin, out);
  } else {
    BinColumns<float, float>(static_cast<const float*>(x), n, f,
                             static_cast<const float*>(bext), m, nb, base,
                             cells, lo, scale, use_table, missing_bin, out);
  }
  return 0;
}
