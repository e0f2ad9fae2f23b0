"""The port's histogram ops against the JAX reference (CPU).

The plain twins of the CUDA kernels are held against the reference's
Pallas kernels, run in interpret mode as tests/test_histogram.py runs
them.  Tolerance for f32 / bf16: rtol 1e-5, atol 1e-4 — the twin adds each
cell's rows in row order, the interpreted MXU contraction in its own
blocked order, so the sums may differ in the last bits.  int32 is exact.
The CUDA kernels themselves are held against the twins on the card
(chip_smoke.py phase 3, and tests/test_torch_cuda.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.histogram import compute_histogram as ref_hist
from mmlspark_tpu.ops.pallas_histogram import (histogram_pallas,
                                               histogram_pallas_fused)
from mmlspark_tpu_torch.ops import cuda_histogram as ch
from mmlspark_tpu_torch.ops.histogram import (compute_histogram,
                                              segment_histogram)
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ACCUMS = ("float32", "bfloat16", "int32")
F_MAX = 13


def _inputs(n, f, B, accum, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(n, f)).astype(np.int32)
    if accum == "int32":
        gh = rng.integers(-300, 300, size=(n, 3)).astype(np.int32)
    else:
        gh = rng.normal(size=(n, 3)).astype(np.float32)
    return bins, gh


@functools.lru_cache(maxsize=None)
def _pallas_full(n, B, accum):
    """The reference histogram of F_MAX features; a feature's histogram
    does not depend on the others, so narrower cases slice it."""
    bins, gh = _inputs(n, F_MAX, B, accum)
    return np.asarray(histogram_pallas(jnp.asarray(bins), jnp.asarray(gh),
                                       B, accum=accum, interpret=True))


def _check(got, want, accum):
    if accum == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("B", [16, 63, 256])
@pytest.mark.parametrize("f", [1, 5, 8, 13])
@pytest.mark.parametrize("n", [1, 127, 1000])
def test_plain_twin_matches_histogram_pallas(n, f, B, accum):
    bins, gh = _inputs(n, F_MAX, B, accum)
    got = ch.histogram_cuda(torch.from_numpy(bins[:, :f]),
                            torch.from_numpy(gh), B, accum).numpy()
    assert got.shape == (f, B, 3)
    assert got.dtype == (np.int32 if accum == "int32" else np.float32)
    _check(got, _pallas_full(n, B, accum)[:f], accum)


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("cnt", [0, 1, 700])
def test_fused_twin_matches_histogram_pallas_fused(cnt, accum):
    """A partitioned row_order segment: the twin reads
    row_order[off:off+cnt]; the reference gets the same rows with the
    zero-weight padding of its bucket."""
    n, f, B, size = 3000, 11, 64, 1024
    bins, gh = _inputs(n, f, B, accum, seed=1)
    rng = np.random.default_rng(2)
    row_order = rng.permutation(n).astype(np.int32)
    off = 901
    rows = row_order[off:off + size]
    valid = (np.arange(size) < cnt).astype(gh.dtype)[:, None]
    want = np.asarray(histogram_pallas_fused(
        jnp.asarray(bins.T), jnp.asarray(gh[rows] * valid),
        jnp.asarray(rows), B, size, accum=accum, interpret=True))[:f]
    got = ch.histogram_cuda_fused(torch.from_numpy(bins),
                                  torch.from_numpy(gh),
                                  torch.from_numpy(row_order), off, cnt, B,
                                  accum).numpy()
    _check(got, want, accum)


@pytest.mark.parametrize("integer", [False, True])
def test_compute_histogram_segment_parity(integer):
    """method='segment' against the reference's segment method: the same
    rows added in the same order, so f32 agrees bit for bit."""
    n, f, B = 2000, 7, 256
    bins, gh = _inputs(n, f, B, "int32" if integer else "float32", seed=3)
    want = np.asarray(ref_hist(jnp.asarray(bins), jnp.asarray(gh), B,
                               method="segment"))
    for method in ("segment", "auto"):
        got = compute_histogram(torch.from_numpy(bins),
                                torch.from_numpy(gh), B, method).numpy()
        np.testing.assert_array_equal(got, want, err_msg=method)
    # the oracle sums in float64 and rounds once
    got = compute_histogram(torch.from_numpy(bins), torch.from_numpy(gh), B,
                            "onehot").numpy()
    _check(got, want, "int32" if integer else "float32")


def test_segment_histogram_gathers_the_segment():
    n, f, B = 500, 4, 32
    bins, gh = _inputs(n, f, B, "float32", seed=4)
    order = np.random.default_rng(5).permutation(n).astype(np.int32)
    rows = order[100:260]
    want = np.asarray(ref_hist(jnp.asarray(bins[rows]),
                               jnp.asarray(gh[rows]), B, method="segment"))
    got = segment_histogram(torch.from_numpy(bins), torch.from_numpy(gh),
                            torch.from_numpy(order), 100, 160, B,
                            "segment").numpy()
    np.testing.assert_array_equal(got, want)


def test_methods_and_devices_are_checked():
    """TPU-only formulations raise; ``pallas_ring`` is a kernel method
    whose full-matrix call is the plain histogram, as in the reference."""
    bins = torch.zeros(4, 2, dtype=torch.uint8)
    gh = torch.ones(4, 3)
    got = compute_histogram(bins, gh, 16, "pallas_ring")
    torch.testing.assert_close(got, compute_histogram(bins, gh, 16,
                                                      "segment"))
    with pytest.raises(ValueError):
        compute_histogram(bins, gh, 16, "dot16")


# -- the full kernel's geometry and order (csrc/full_hist.cuh) --------------

#: what an H100 SXM (132 SMs; as an H100 80GB HBM3 reports it) and an
#: H100 PCIe (114 SMs; scaled) hold at once of hist_full blocks of
#: 221,952 bytes: blocks, and clusters of 1, 2, 4, 8, 16
CARDS = {"sxm": (132, (132, 66, 30, 15, 7)),
         "pcie": (114, (114, 57, 26, 13, 6))}
#: the fits' hist_full shapes (rows, features; B = 256), then the edges
FULL_SHAPES = [(400_000, 50, 256), (100_000, 50, 256), (2048, 2000, 256),
               (8192, 500, 256), (4096, 1000, 256), (20_000, 13, 16),
               (20_000, 13, 63), (1, 50, 256), (127, 13, 256), (0, 5, 16)]
H100_BUDGET = 232_448


def _card(card, slots, num_bins):
    """``CARDS[card]`` scaled to the blocks of ``slots`` features that
    one SM holds (one at B = 256, 64 slots)."""
    sms, fits = CARDS[card]
    per_sm = min(H100_BUDGET // (ch.full_smem(slots, num_bins) + 4),
                 2048 // ch.FULL_THREADS)
    return sms * per_sm, tuple(min(x * per_sm, sms * per_sm >> k)
                               for k, x in enumerate(fits))


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("n,f,B", FULL_SHAPES)
def test_full_grid_covers_every_row_and_feature_once(n, f, B, card):
    """Groups of ``slots`` features cover the f features once each, the
    blocks' row ranges cover the n rows once each, a block fits the
    H100's 232,448 bytes, the layout's ``slots`` is a multiple of 32, and
    the clusters of every group fit on the card at once."""
    slots = ch.full_slots(f, B)
    resident, fits = _card(card, slots, B)
    g = ch.full_grid(n, f, B, slots, resident, fits)
    assert g.slots == slots and slots % 32 == 0
    assert ch.full_smem(slots, B) + 4 <= H100_BUDGET
    sizes = [min(slots, f - k * slots) for k in range(g.groups)]
    assert min(sizes) >= 1 and sum(sizes) == f
    blocks = g.cs * g.clusters
    assert g.rows % ch.FULL_ROW_ALIGN == 0 and g.rows >= ch.FULL_ROW_ALIGN
    covered = [min(n, (x + 1) * g.rows) - min(n, x * g.rows)
               for x in range(blocks)]
    assert sum(covered) == n and min(covered) >= 0
    assert g.cs in (1, 2, 4, 8, 16)
    assert g.groups * g.clusters <= fits[g.cs.bit_length() - 1]
    assert blocks * g.groups <= max(resident, g.groups)


def test_full_slots_fill_shared_memory():
    # the flagship: all 50 features in one block of two warps
    assert ch.full_slots(50, 256) == 64
    assert ch.full_smem(64, 256) == 257 * 3 * 64 * 4 + 3 * 8192
    # the wide tables: 64 features a block at B = 256, more at fewer bins
    assert ch.full_slots(2000, 256) == 64
    assert ch.full_slots(2000, 63) == 256
    assert ch.full_slots(2000, 16) == ch.FULL_THREADS // 2
    assert ch.full_slots(1, 256) == 32
    with pytest.raises(ValueError):
        ch.full_slots(4, 256, smem_budget=100_000)


def test_full_grid_at_the_fit_shapes():
    """(slots, groups, cluster size, clusters, rows) on an H100 SXM: the
    flagship in 15 clusters of 8 (fewer partials than 30 of 4), its D = 4
    shard in 7 of 16, the wide shapes in small clusters over every SM."""
    def grid(n, f):
        slots = ch.full_slots(f, 256)
        return tuple(ch.full_grid(n, f, 256, slots, *_card("sxm", slots,
                                                           256)))
    assert grid(400_000, 50) == (64, 1, 8, 15, 3344)
    assert grid(100_000, 50) == (64, 1, 16, 7, 896)
    assert grid(2048, 2000) == (64, 32, 2, 2, 512)
    assert grid(8192, 500) == (64, 8, 4, 3, 688)
    assert grid(4096, 1000) == (64, 16, 2, 4, 512)
    assert grid(1, 50) == (64, 1, 1, 1, 16)


def _ordered_numpy(bins, gh, B, accum, geom):
    """hist_full's order written out with numpy: ``np.add.at`` adds each
    block's rows in row order, then the cluster and cluster-order merges
    cell by cell."""
    n, f = bins.shape
    slots, groups, cs, clusters, rows = geom
    dt = np.int32 if accum == "int32" else np.float32
    ghv = ch._gh_values(torch.from_numpy(gh), accum).numpy().astype(dt)
    out = np.zeros((f, B, 3), dt)
    for g in range(groups):
        f0, fg = g * slots, min(slots, f - g * slots)
        parts = []
        for x in range(cs * clusters):
            p = np.zeros((fg, B, 3), dt)
            for r in range(x * rows, min(n, (x + 1) * rows)):
                for j in range(fg):
                    if bins[r, f0 + j] < B:
                        np.add.at(p, (j, bins[r, f0 + j]), ghv[r])
            parts.append(p)
        for j in range(fg):
            for b in range(B):
                for c in range(3):
                    r = next(k for k in range(cs, -1, -1)
                             if B * k // cs <= b)
                    total = dt(0)
                    for q in range(clusters):
                        v = parts[q * cs + r][j, b, c]
                        for p in range(cs - 1):
                            v = dt(v + parts[q * cs + (r + 1 + p) % cs][
                                j, b, c])
                        total = v if clusters == 1 else dt(total + v)
                    out[f0 + j, b, c] = total
    return out


#: small launches of every kind (slots, groups, cs, clusters): one block;
#: clusters of 2, 4, 8; several clusters; several groups.  Rows a block
#: follow the rows (:func:`_order_geom`), leaving trailing blocks empty.
ORDER_GEOMS = [(32, 1, 1, 1), (32, 1, 2, 1), (32, 1, 4, 3), (64, 1, 8, 2),
               (32, 2, 2, 2)]


def _order_geom(k, n, f):
    slots, groups, cs, clusters = ORDER_GEOMS[k]
    if groups > 1:
        slots = -(-f // groups)
    return ch.FullGeometry(slots, groups, cs, clusters,
                           ch._row_block(n, cs * clusters))


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("k", range(len(ORDER_GEOMS)))
def test_histogram_ordered_follows_its_stated_order(k, accum):
    """The summation-order twin against the order written out cell by
    cell, bit for bit (out-of-range bins among the rows)."""
    n, f, B = 300, 5, 16
    geom = _order_geom(k, n, f)
    bins, gh = _inputs(n, f, B + 3, accum, seed=10 + k)
    got = ch.histogram_ordered(torch.from_numpy(bins), torch.from_numpy(gh),
                               B, accum, geom).numpy()
    np.testing.assert_array_equal(got, _ordered_numpy(bins, gh, B, accum,
                                                      geom))


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("k", range(len(ORDER_GEOMS)))
def test_histogram_ordered_matches_histogram_pallas(k, accum):
    """The order the card's kernel adds in gives the reference's
    histogram within the kernels' tolerance (int32 exactly)."""
    n, B = 1000, 63
    bins, gh = _inputs(n, F_MAX, B, accum)
    got = ch.histogram_ordered(torch.from_numpy(bins), torch.from_numpy(gh),
                               B, accum, _order_geom(k, n, F_MAX)).numpy()
    _check(got, _pallas_full(n, B, accum), accum)


@pytest.mark.parametrize("accum", ACCUMS)
def test_plain_twin_drops_out_of_range_bins(accum):
    """Bins of B or more fall in no cell, as in the kernels and the
    one-hot oracle."""
    n, f, B = 500, 6, 40
    bins, gh = _inputs(n, f, 64, accum, seed=11)
    b, g = torch.from_numpy(bins), torch.from_numpy(gh)
    want = compute_histogram(b, ch._gh_values(g, accum), B, "onehot")
    _check(ch.histogram_plain(b, g, B, accum).numpy(), want.numpy(), accum)


# -- the segment kernel's geometry (csrc/seg_hist.cuh, histogram.cu) ---------

@pytest.mark.parametrize("resident,most", [(132, 15), (114, 13)])
@pytest.mark.parametrize("cnt", [1, 777, 6522, 200_000])
@pytest.mark.parametrize("B", [2, 17, 256])
@pytest.mark.parametrize("f", [1, 13, 50, 75, 76, 2000])
def test_seg_grid_puts_every_feature_in_one_group(f, B, cnt, resident, most):
    """Groups of ``group`` features cover the f features once each, a
    block's staging tile, tag rows and histogram copies fit the
    shared-memory budget, and the launch holds no more blocks than the
    card (132 SMs holding 15 clusters of 8, or 114 holding 13) or the rows
    justify."""
    widest = ch.seg_widest(f, B)
    group, groups, cs, clusters = ch.seg_grid(cnt, f, widest, resident,
                                              most)
    sizes = [min(group, f - g * group) for g in range(groups)]
    assert min(sizes) >= 1 and sum(sizes) == f
    assert 1 <= group <= widest <= ch.SEG_MAX_GROUP
    assert groups >= -(-f // widest)
    reps = ch.seg_replicas(group, B, ch.SEG_THREADS // 32)
    assert 1 <= reps <= max(1, ch.SEG_THREADS // 32 // group)
    assert group * (B * 3 + ch.SEG_PAD) * 4 < ch.seg_smem(group, reps, B) \
        <= ch.SMEM_BUDGET
    assert 1 <= cs <= ch.SEG_CLUSTER and cs & (cs - 1) == 0
    per_group = cs * clusters
    assert per_group <= max(1, -(-cnt // ch.SEG_ROWS_PER_BLOCK))
    assert per_group * groups <= max(resident, groups)
    assert clusters == 1 or clusters * groups <= most


def test_seg_widest_is_as_wide_as_shared_memory_allows():
    # the flagship: every feature in one block, each row gathered once
    assert ch.seg_widest(50, 256) == 50
    assert ch.seg_smem(50, 1, 256) == (256 * (12 + 52) + 32 * 2 * 256
                                       + 50 * 769 * 4)
    # the wide table: 63 features fit beside the staging tile and the tag
    # rows in 227 KB, so a row is gathered 32 times, not 250
    assert ch.seg_widest(2000, 256) == 63
    assert ch.seg_widest(2000, 2) == ch.SEG_MAX_GROUP
    with pytest.raises(ValueError):
        ch.seg_widest(4, 256, smem_budget=1000)


def test_seg_grid_at_the_flagship_shapes():
    """(features per group, groups, cluster size, clusters per group) on
    a card of 132 SMs that holds 15 clusters of 8: a small segment spreads
    over narrow groups, one block each; the median segment of the
    flagship fit over 5 groups of 3 clusters; the root-sized segment keeps
    one group of all 50 features in 15 clusters, merged through the
    workspace and tickets."""
    assert ch.seg_grid(1, 50, 50, 132, 15) == (4, 13, 1, 1)
    assert ch.seg_grid(777, 50, 50, 132, 15) == (4, 13, 4, 1)
    assert ch.seg_grid(6522, 50, 50, 132, 15) == (10, 5, 8, 3)
    assert ch.seg_grid(200_000, 50, 50, 132, 15) == (50, 1, 8, 15)
    assert ch.seg_grid(1024, 2000, 63, 132, 15) == (61, 33, 4, 1)
