// Forest traversal on the host: Booster margins on a CPU booster.
//
// The port's copy of mmlspark_tpu/native/fastforest.cc, whose walk it
// carries over unchanged (the reference's CPython buffer wrapper is
// replaced by a plain C function over pointers and sizes, loaded with
// ctypes; gbdt/booster.py checks every shape before the call).  Each row
// walks each tree from the root and stops at its leaf, where the device
// walk advances every row for the forest's full depth.
//
// Exactness contract: margins equal the device walk's (booster._margins)
// bit for bit.  The walk uses the same float32 `x <= thr` decision (NaN ->
// right for numeric nodes), the same categorical bitset rule as
// _cat_go_left (NaN -> default_left, negative / out-of-range categories
// -> right), and accumulates per-row tree values in the same tree order in
// float32.

#include <cmath>
#include <cstdint>
#include <system_error>
#include <thread>
#include <vector>

namespace {

struct Forest {
  const int32_t* feat;     // (T, m)
  const float* thr;        // (T, m)
  const int32_t* left;     // (T, m)
  const int32_t* right;    // (T, m)
  const float* leaf;       // (T, L)
  const uint8_t* single;   // (T,)
  const int32_t* is_cat;   // (T, m)
  const int32_t* dleft;    // (T, m)
  const int32_t* cat_bnd;  // (T, C1)
  const uint32_t* cat_words;  // (T, W)
  int64_t T, m, L, C1, W;
  int K;
  bool has_cat;
};

inline bool CatGoLeft(float x, int32_t j, int32_t dleft_node,
                      const int32_t* bnd, int64_t C1, const uint32_t* words,
                      int64_t W) {
  if (std::isnan(x)) return dleft_node > 0;
  if (j < 0) j = 0;
  if (j > static_cast<int32_t>(C1) - 2) j = static_cast<int32_t>(C1) - 2;
  const int64_t b0 = bnd[j];
  const int64_t b1 = bnd[j + 1];
  // int32 truncation FIRST, then the sign gate, exactly like the device
  // walk: x in (-1, 0) truncates to category 0 (may go left); x <= -1
  // routes right.  Values outside int32 range route right.
  if (!(x > -2147483648.0f && x < 2147483648.0f)) return false;
  const int32_t c = static_cast<int32_t>(x);
  if (c < 0) return false;
  const int64_t widx = b0 + (c >> 5);
  if (widx < 0 || widx >= b1 || widx >= W) return false;
  return (words[widx] >> (c & 31)) & 1u;
}

void PredictRows(const Forest& fr, const float* X, int64_t f, int64_t r0,
                 int64_t r1, float* out) {
  for (int64_t i = r0; i < r1; ++i) {
    const float* xrow = X + i * f;
    float* orow = out + i * fr.K;
    for (int64_t t = 0; t < fr.T; ++t) {
      const int32_t* tfeat = fr.feat + t * fr.m;
      const float* tthr = fr.thr + t * fr.m;
      const int32_t* tleft = fr.left + t * fr.m;
      const int32_t* tright = fr.right + t * fr.m;
      int32_t node = fr.single[t] ? -1 : 0;
      // Corrupt-model hardening: index clamps, and a step bound that
      // turns a cyclic left/right graph into leaf 0 instead of a hang.
      int64_t steps = 0;
      while (node >= 0) {
        if (node >= fr.m) node = static_cast<int32_t>(fr.m) - 1;
        if (++steps > fr.m) {
          node = -1;
          break;
        }
        int32_t fj = tfeat[node];
        if (fj < 0) fj = 0;
        if (fj >= f) fj = static_cast<int32_t>(f) - 1;
        const float x = xrow[fj];
        bool go_left;
        if (fr.has_cat && fr.is_cat[t * fr.m + node]) {
          go_left = CatGoLeft(x, static_cast<int32_t>(tthr[node]),
                              fr.dleft[t * fr.m + node],
                              fr.cat_bnd + t * fr.C1, fr.C1,
                              fr.cat_words + t * fr.W, fr.W);
        } else {
          go_left = x <= tthr[node];  // NaN -> right, as in the device walk
        }
        node = go_left ? tleft[node] : tright[node];
      }
      int64_t li = -static_cast<int64_t>(node) - 1;
      if (li >= fr.L) li = fr.L - 1;
      orow[t % fr.K] += fr.leaf[t * fr.L + li];
    }
  }
}

}  // namespace

// X (n, f) float32 row-major; the stacked forest's arrays with T trees, m
// nodes, L leaves, C1 category boundaries and W bitset words each; out
// (n, K) float32, zeroed by the caller, accumulated into.  n_threads <= 0
// takes every hardware thread; below 4,096 rows one thread walks all.
// Returns 0, or 1 when a worker thread cannot start (an exception must
// not cross the C interface).
extern "C" int mmlspark_predict_forest(
    const float* X, int64_t n, int64_t f, const int32_t* feat,
    const float* thr, const int32_t* left, const int32_t* right,
    const float* leaf, const uint8_t* single, const int32_t* is_cat,
    const int32_t* dleft, const int32_t* cat_bnd, const uint32_t* cat_words,
    int64_t T, int64_t m, int64_t L, int64_t C1, int64_t W, int K,
    int has_cat, int n_threads, float* out) try {
  Forest fr;
  fr.feat = feat;
  fr.thr = thr;
  fr.left = left;
  fr.right = right;
  fr.leaf = leaf;
  fr.single = single;
  fr.is_cat = is_cat;
  fr.dleft = dleft;
  fr.cat_bnd = cat_bnd;
  fr.cat_words = cat_words;
  fr.T = T;
  fr.m = m;
  fr.L = L;
  fr.C1 = C1;
  fr.W = W;
  fr.K = K;
  fr.has_cat = has_cat != 0;
  int nt = n_threads > 0 ? n_threads
                         : static_cast<int>(
                               std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > 1 && n >= 4096) {
    std::vector<std::thread> pool;
    const int64_t step = (n + nt - 1) / nt;
    for (int w = 0; w < nt; ++w) {
      const int64_t r0 = w * step;
      const int64_t r1 = r0 + step < n ? r0 + step : n;
      if (r0 >= r1) break;
      pool.emplace_back(
          [&fr, X, f, r0, r1, out]() { PredictRows(fr, X, f, r0, r1, out); });
    }
    for (auto& th : pool) th.join();
  } else {
    PredictRows(fr, X, f, 0, n, out);
  }
  return 0;
} catch (const std::system_error&) {
  return 1;
}
