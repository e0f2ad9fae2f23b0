"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The file imports nothing of JAX, so it also runs on a
GPU machine without it; there, skip the repository's conftest (which sets
up JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance for f32 / bf16: rtol 1e-5, atol 1e-4 at 20,000 rows (both sides
add each cell's rows in another order, with atomics); int32 is exact.
The segment kernel's sweep (up to 200,000 rows) states its tolerance per
cell as chip_smoke.py does: |k - p| <= 1e-5 |p| + 256 * 2^-24 * sum|gh|
(a sum of m terms in another order is off by about sqrt(m) u sum|gh|).
"""

import functools

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import cuda_histogram as ch

ACCUMS = ("float32", "bfloat16", "int32")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(n, f, B, accum, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(n, f)).astype(np.uint8)
    if accum == "int32":
        gh = rng.integers(-300, 300, size=(n, 3)).astype(np.int32)
    else:
        gh = rng.normal(size=(n, 3)).astype(np.float32)
    return bins, gh


def _check(got, want, accum):
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if accum == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("B", [16, 63, 256])
def test_hist_full_matches_twin(cuda_device, B, accum):
    bins, gh = _inputs(20_000, 13, B, accum, seed=B)
    b, g = (torch.from_numpy(a).to(cuda_device) for a in (bins, gh))
    before = ch.histogram_cuda.launches
    _check(ch.histogram_cuda(b, g, B, accum),
           ch.histogram_plain(b, g, B, accum), accum)
    assert ch.histogram_cuda.launches == before + 1


#: hist_full's shapes in the fits (rows, features; B = 256): the serial
#: flagship, its D = 4 shard, the wide data (voting) shard, the wide
#: feature 1 x 4 and data+feature 2 x 2 slices; then the edges (B < 256,
#: f not a multiple of 32, fewer rows than a tile, no row)
FULL_FIT_SHAPES = [(400_000, 50, 256), (100_000, 50, 256), (2048, 2000, 256),
                   (8192, 500, 256), (4096, 1000, 256)]
FULL_EDGE_SHAPES = [(20_000, 13, 16), (20_000, 13, 63), (5000, 1, 63),
                    (1, 1, 16), (1, 13, 256), (127, 13, 63), (127, 50, 256),
                    (0, 13, 256)]


def _full_inputs(n, f, B, accum, seed, bin_range=None):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, bin_range or B, size=(n, f), dtype=np.uint8)
    if accum == "int32":
        gh = rng.integers(-300, 300, size=(n, 3)).astype(np.int32)
    else:
        gh = rng.normal(size=(n, 3)).astype(np.float32)
    return torch.from_numpy(bins), torch.from_numpy(gh)


def _check_full(n, f, B, accum, bin_range=None):
    """hist_full against its twin (int32 exactly; f32 and bf16 within the
    per-cell tolerance) and against the order it states
    (``histogram_ordered`` on the CPU), bit for bit; one launch."""
    bins, gh = _full_inputs(n, f, B, accum, seed=n + f + B, bin_range=bin_range)
    b, g = bins.cuda(), gh.cuda()
    before = ch.histogram_cuda.launches
    got = ch.histogram_cuda(b, g, B, accum)
    assert ch.histogram_cuda.launches == before + 1
    assert got.shape == (f, B, 3)
    want = ch.histogram_plain(b, g, B, accum)
    gh_abs = ch._gh_values(g, accum).abs().float()
    _check_tol(got, want, ch.histogram_plain(b, gh_abs, B), accum)
    geom = ch.full_launch_geometry(n, f, B, accum, b.device)
    order = ch.histogram_ordered(bins, gh, B, accum, geom)
    assert torch.equal(got.cpu(), order), geom


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("n,f,B", FULL_FIT_SHAPES)
def test_hist_full_at_the_fit_shapes(cuda_device, n, f, B, accum):
    _check_full(n, f, B, accum)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("n,f,B", FULL_EDGE_SHAPES)
def test_hist_full_at_the_edges(cuda_device, n, f, B, accum):
    _check_full(n, f, B, accum)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("B", [16, 63, 200])
def test_hist_full_drops_out_of_range_bins(cuda_device, B, accum):
    _check_full(20_000, 13, B, accum, bin_range=256)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("n,f", [(400_000, 50), (2048, 2000)])
def test_hist_full_repeats_bit_for_bit(cuda_device, n, f, accum):
    """20 calls on the same inputs give the same bits: no atomic decides
    an order."""
    bins, gh = _full_inputs(n, f, 256, accum, seed=3)
    b, g = bins.cuda(), gh.cuda()
    first = ch.histogram_cuda(b, g, 256, accum)
    for _ in range(19):
        assert torch.equal(ch.histogram_cuda(b, g, 256, accum), first)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("n,f,B", [(20_000, 13, 256), (5000, 1000, 63)])
def test_hist_full_on_unaligned_views(cuda_device, n, f, B, accum):
    """Row views that start one row into their tensors: bins on no
    16-byte boundary, gh 12 bytes past one (staged by 4-byte copies),
    whole rows (f = 13) and row windows (f = 1000)."""
    bins, gh = _full_inputs(n + 1, f, B, accum, seed=5)
    b, g = bins.cuda()[1:], gh.cuda()[1:]
    assert b.data_ptr() % 16 and g.data_ptr() % 16
    got = ch.histogram_cuda(b, g, B, accum)
    want = ch.histogram_plain(b, g, B, accum)
    gh_abs = ch._gh_values(g, accum).abs().float()
    _check_tol(got, want, ch.histogram_plain(b, gh_abs, B), accum)
    geom = ch.full_launch_geometry(n, f, B, accum, b.device)
    assert torch.equal(got.cpu(), ch.histogram_ordered(bins[1:], gh[1:], B,
                                                       accum, geom))


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", [(400_000, 50), (1, 13), (4096, 1000)])
def test_hist_full_needs_no_fill(cuda_device, n, f):
    """The kernel writes every cell: an output block that held NaNs just
    before the call comes back right."""
    B = 256
    bins, gh = _full_inputs(n, f, B, "float32", seed=4)
    b, g = bins.cuda(), gh.cuda()
    want = ch.histogram_cuda(b, g, B)          # the workspace, allocated
    torch.cuda.synchronize()
    junk = torch.full((f, B, 3), float("nan"), device=cuda_device)
    at = junk.data_ptr()
    del junk
    got = ch.histogram_cuda(b, g, B)
    assert got.data_ptr() == at
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("cnt", [0, 1, 777, 15_000])
def test_hist_segment_matches_twin(cuda_device, cnt, accum):
    n, B = 20_000, 256
    bins, gh = _inputs(n, 13, B, accum, seed=cnt)
    order = np.random.default_rng(7).permutation(n).astype(np.int32)
    b, g, o = (torch.from_numpy(a).to(cuda_device)
               for a in (bins, gh, order))
    before = ch.histogram_cuda_fused.launches
    _check(ch.histogram_cuda_fused(b, g, o, 333, cnt, B, accum),
           ch.histogram_fused_plain(b, g, o, 333, cnt, B, accum), accum)
    assert ch.histogram_cuda_fused.launches == before + (cnt > 0)


SWEEP_COUNTS = (0, 1, 31, 777, 15_000, 200_000)


@functools.lru_cache(maxsize=4)
def _sweep_inputs(f, B):
    """200,100 rows of f features (bins straight as uint8: no int64 copy
    of a 400 MB matrix), a float and an integer gh, and a row order."""
    n = max(SWEEP_COUNTS) + 100
    rng = np.random.default_rng(f * 1000 + B)
    bins = torch.from_numpy(rng.integers(0, B, size=(n, f), dtype=np.uint8))
    gh = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    gh_int = torch.from_numpy(rng.integers(-300, 300, size=(n, 3))
                              .astype(np.int32))
    order = torch.from_numpy(rng.permutation(n).astype(np.int32))
    return tuple(t.to("cuda") for t in (bins, gh, gh_int, order))


def _check_tol(got, want, gh_abs_hist, accum):
    torch.cuda.synchronize()
    if accum == "int32":
        assert torch.equal(got, want)
        return
    tol = 1e-5 * want.abs() + 256 * 2.0 ** -24 * gh_abs_hist
    err = (got - want).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("B", [2, 17, 256])
@pytest.mark.parametrize("f", [1, 13, 50, 75, 76, 2000])
def test_hist_segment_sweep_matches_twin(cuda_device, f, B, accum):
    """Every segment size from empty to 200,000 rows (one block; one
    cluster; several clusters merged through the workspace), one group or
    many."""
    bins, gh, gh_int, order = _sweep_inputs(f, B)
    ghm = gh_int if accum == "int32" else gh
    gh_abs = ch._gh_values(ghm, accum).abs().float()
    for cnt in SWEEP_COUNTS:
        off = 57
        before = ch.histogram_cuda_fused.launches
        got = ch.histogram_cuda_fused(bins, ghm, order, off, cnt, B, accum)
        assert ch.histogram_cuda_fused.launches == before + (cnt > 0)
        want = ch.histogram_fused_plain(bins, ghm, order, off, cnt, B, accum)
        assert got.shape == (f, B, 3) and got.dtype == want.dtype
        _check_tol(got, want, ch.histogram_fused_plain(
            bins, gh_abs, order, off, cnt, B), accum)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [50, 75])
@pytest.mark.parametrize("accum", ACCUMS)
def test_hist_segment_merges_several_clusters(cuda_device, accum, f):
    """200,000 rows of the flagship width (one group), and of 75 features
    (two groups), launch several clusters a group; their partials meet
    through the workspace and the tickets, which each launch leaves at
    zero: repeated calls, and calls of other sizes between them, stay
    right."""
    B = 256
    card = ch._seg_card(torch.device("cuda", torch.cuda.current_device()))
    widest, resident, clusters = card.geom(f, B, ch.ACCUM_MODES[accum])
    _, _, cs, per_group = ch.seg_grid(200_000, f, widest, resident,
                                      clusters)
    assert per_group > 1 and cs == ch.SEG_CLUSTER
    bins, gh, gh_int, order = _sweep_inputs(f, B)
    ghm = gh_int if accum == "int32" else gh
    gh_abs = ch._gh_values(ghm, accum).abs().float()
    for cnt, off in ((200_000, 0), (777, 5), (200_000, 100), (150_000, 9)):
        want = ch.histogram_fused_plain(bins, ghm, order, off, cnt, B, accum)
        abs_hist = ch.histogram_fused_plain(bins, gh_abs, order, off, cnt, B)
        for _ in range(2):
            got = ch.histogram_cuda_fused(bins, ghm, order, off, cnt, B,
                                          accum)
            _check_tol(got, want, abs_hist, accum)


@pytest.mark.cuda
def test_bad_inputs_raise_on_the_card(cuda_device):
    b = torch.zeros(8, 2, dtype=torch.uint8, device=cuda_device)
    g = torch.zeros(8, 3, device=cuda_device)
    with pytest.raises(ValueError):
        ch.histogram_cuda(b, g, 257)
    with pytest.raises(ValueError):
        ch.histogram_cuda_fused(b, g, torch.zeros(8, dtype=torch.int32,
                                                  device=cuda_device),
                                4, 5, 16)


@pytest.mark.cuda
def test_fit_on_the_card_grows_the_cpu_tree(cuda_device):
    from mmlspark_tpu_torch import LightGBMClassifier
    rng = np.random.default_rng(0)
    X = rng.normal(size=(5000, 8)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float64)
    table = {"features": X, "label": y}
    trees = [LightGBMClassifier(numIterations=1, numLeaves=15, device=d)
             .fit(table).getModel().trees[0] for d in ("cuda", "cpu")]
    for k in ("split_feature", "threshold", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(trees[0], k),
                                      getattr(trees[1], k))


# -- ring collectives (csrc/ring.cu) -----------------------------------------
# ring_allreduce adds in the plain twin's order without atomics, so it is
# compared exactly; fused_segment_hist_ring's histogram phase uses f32
# atomics (tolerance as above), its int32 mode is exact.

from mmlspark_tpu_torch.core.mesh import build_mesh  # noqa: E402
from mmlspark_tpu_torch.ops import collectives as co  # noqa: E402
from mmlspark_tpu_torch.ops import cuda_ring as cr  # noqa: E402

RING_SHAPES = [(50, 256, 3), (13, 17, 3), (3,), (1, 129)]


def _parts(shape, devices, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(d) for d in devices]


def _routes(mesh, kind):
    """The routes of the ``kind`` ("dense", "select") workspaces that calls
    on ``mesh`` have made."""
    return {ws.route for key, ws in mesh.scratch.items() if key[1] == kind}


def _check_ring(devices, shapes=RING_SHAPES):
    mesh = build_mesh(devices=devices)
    for i, shape in enumerate(shapes):
        parts = _parts(shape, mesh.devices, seed=i)
        before = cr.ring_allreduce_cuda.launches
        for _ in range(3):   # repeated calls reuse the workspace
            got = co.ring_allreduce(parts, mesh)
        torch.cuda.synchronize()
        want = co.ring_allreduce_plain(parts)
        assert cr.ring_allreduce_cuda.launches == before + 3
        for g in got:
            assert torch.equal(g.to(want.device), want), shape
    assert _routes(mesh, "dense") == {cr.ring_route(mesh.devices)}


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 4])
def test_ring_allreduce_equals_twin_on_virtual_shards(cuda_device, D):
    _check_ring([cuda_device] * D)


def _fused_shards(devices, accum, counts, seed, f=13, B=256):
    rng = np.random.default_rng(seed)
    shards = []
    for d, (dev, cnt) in enumerate(zip(devices, counts)):
        n = 6000 + 100 * d
        bins, gh = _inputs(n, f, B, accum, seed=seed + d)
        order = rng.permutation(n).astype(np.int32)
        shards.append((torch.from_numpy(bins).to(dev),
                       torch.from_numpy(gh).to(dev),
                       torch.from_numpy(order).to(dev), 17 * d, cnt))
    return shards


def _check_fused(devices, accum, f=13):
    mesh = build_mesh(devices=devices)
    D = len(devices)
    for k, counts in enumerate(([5000] * D, [1, 0, 777, 4000][:D],
                                [0] * D)):
        shards = _fused_shards(mesh.devices, accum, counts, seed=10 * k,
                               f=f)
        before = cr.fused_segment_hist_ring_cuda.launches
        for _ in range(2):   # the kernel leaves its work buffers zeroed
            got = co.fused_segment_hist_ring(shards, 256, mesh, accum)
            want = co.fused_segment_hist_ring_plain(shards, 256, accum)
            for g in got:
                _check(g.to(want.device), want, accum)
        assert cr.fused_segment_hist_ring_cuda.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ["float32", "int32"])
@pytest.mark.parametrize("D", [2, 3, 4])
def test_fused_segment_hist_ring_matches_twin(cuda_device, D, accum):
    _check_fused([cuda_device] * D, accum)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ["float32", "int32"])
@pytest.mark.parametrize("D,f", [(2, 300), (4, 50), (3, 2000)])
def test_fused_segment_hist_ring_at_wide_and_flagship_widths(cuda_device, D,
                                                             f, accum):
    """Chunks of several feature sub-groups (f = 300 at D = 2: 150
    features a chunk; f = 2000 at D = 3), and the flagship's 13 a chunk
    with segments of many row tiles, uneven across the ranks."""
    _check_fused([cuda_device] * D, accum, f=f)
    mesh = build_mesh(devices=[cuda_device] * D)
    counts = [5900, 3001, 0, 4096][:D]
    shards = _fused_shards(mesh.devices, accum, counts, seed=3, f=f)
    got = co.fused_segment_hist_ring(shards, 256, mesh, accum)
    want = co.fused_segment_hist_ring_plain(shards, 256, accum)
    for g in got:
        _check(g, want, accum)


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [((600, 64), (150, 256)),
                                    ((150, 256), (600, 64)),
                                    ((50, 256), (100, 128))])
@pytest.mark.parametrize("D", [2, 4])
def test_fused_payloads_of_one_size_keep_their_own_geometry(cuda_device, D,
                                                            shapes):
    """Shapes of one f·B share a ring workspace; each keeps its own
    feature group, copies and block counts, called in turn on one mesh."""
    mesh = build_mesh(devices=[cuda_device] * D)
    counts = [3000, 1, 0, 777][:D]
    for f, B in shapes + shapes:
        for accum in ("float32", "int32"):
            shards = _fused_shards(mesh.devices, accum, counts, seed=f + B,
                                   f=f, B=B)
            got = co.fused_segment_hist_ring(shards, B, mesh, accum)
            want = co.fused_segment_hist_ring_plain(shards, B, accum)
            for g in got:
                assert g.shape == (f, B, 3)
                _check(g, want, accum)


@pytest.mark.cuda
def test_fused_wrapper_never_reuses_stale_pointers(cuda_device):
    """The wrapper keeps the pointer arrays of the shard tensors it has
    launched on: new tensors of the same shapes get their own pointers,
    the first tensors theirs again, and an in-place change of a cached
    tensor is read at the next call."""
    mesh = build_mesh(devices=[cuda_device] * 4)
    counts = [700, 1, 0, 3000]
    a = _fused_shards(mesh.devices, "int32", counts, seed=1)
    b = _fused_shards(mesh.devices, "int32", counts, seed=2)
    for shards in (a, b, a, b):
        got = co.fused_segment_hist_ring(shards, 256, mesh, "int32")
        want = co.fused_segment_hist_ring_plain(shards, 256, "int32")
        for g in got:
            _check(g, want, "int32")
    a[0][1].mul_(-2)
    a[3][0].copy_(a[3][0].flip(0))
    got = co.fused_segment_hist_ring(a, 256, mesh, "int32")
    want = co.fused_segment_hist_ring_plain(a, 256, "int32")
    for g in got:
        _check(g, want, "int32")
    # gh that must be converted (float64 for float32) is never cached
    c = [(bn, g.double(), o, off, cnt) for bn, g, o, off, cnt in
         _fused_shards(mesh.devices, "float32", counts, seed=4)]
    for _ in range(2):
        got = co.fused_segment_hist_ring(c, 256, mesh, "float32")
        want = co.fused_segment_hist_ring_plain(
            [(bn, g.float(), o, off, cnt) for bn, g, o, off, cnt in c], 256)
        for g in got:
            _check(g, want, "float32")


@pytest.mark.cuda
def test_dense_select_and_fused_rings_interleave_exactly(cuda_device):
    """Interleaved dense, select and fused (int32) calls on one mesh stay
    exact: each ring has its own workspace, flags and sequence numbers,
    and the fused kernel's readiness words are its own."""
    mesh = build_mesh(devices=[cuda_device] * 4)
    dense = _parts((50, 256, 3), mesh.devices, seed=5)
    parts, cand = _select_inputs((2, 200, 256, 3), (2, 32), mesh.devices, 6)
    shards = _fused_shards(mesh.devices, "int32", [900, 0, 17, 2500], 7,
                           f=50)
    want_a = co.ring_allreduce_plain(dense)
    want_b = co.ring_allreduce_select_plain(parts, cand)
    want_c = co.fused_segment_hist_ring_plain(shards, 256, "int32")
    for _ in range(4):
        a = co.ring_allreduce(dense, mesh)
        c = co.fused_segment_hist_ring(shards, 256, mesh, "int32")
        b = co.ring_allreduce_select(parts, cand, mesh)
    torch.cuda.synchronize()
    assert all(torch.equal(x, want_a) for x in a)
    assert all(torch.equal(x, want_b) for x in b)
    assert all(torch.equal(x, want_c) for x in c)


def _two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (one shard per card)")
    return [torch.device("cuda", i)
            for i in range(min(4, torch.cuda.device_count()))]


@pytest.mark.cuda
def test_ring_allreduce_across_cards(cuda_device):
    _check_ring(_two_cards())


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ["float32", "int32"])
def test_fused_segment_hist_ring_across_cards(cuda_device, accum):
    _check_fused(_two_cards(), accum)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ["float32", "int32"])
def test_ring_kernels_on_an_uneven_mesh(cuda_device, accum):
    """Two shards on the first card and one on the second.  On its own the
    first card would launch fewer blocks a rank than the second wherever
    the payload needs more than it holds (a (2200, 256, 3) ring; the fused
    kernel at 300 features and B = 256); the wrappers launch the mesh's
    one count on both, so the ring's slices line up."""
    first, second = _two_cards()[:2]
    devices = [first, first, second]
    _check_ring(devices, RING_SHAPES + [(2200, 256, 3)])
    _check_fused(devices, accum, f=300)


# -- the voted-column ring (ring_select) -------------------------------------
# (local histogram shape, candidate shape): the wide voting configuration's
# pair and single slab (f = 2000, B = 256, k2 = 64), and a ragged slab

SELECT_CASES = [((2, 2000, 256, 3), (2, 64)), ((2000, 256, 3), (64,)),
                ((9, 7, 3), (5,))]


def _select_inputs(shape, cand_shape, devices, seed):
    rng = np.random.default_rng(seed)
    f = shape[len(cand_shape) - 1]
    cand = np.stack([rng.choice(f, size=cand_shape[-1], replace=False)
                     for _ in range(int(np.prod(cand_shape[:-1])))])
    parts = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
             .to(d) for d in devices]
    return parts, torch.from_numpy(
        cand.reshape(cand_shape).astype(np.int32)).to(devices[0])


def _check_select(devices, cases=SELECT_CASES):
    mesh = build_mesh(devices=devices)
    for i, (shape, cand_shape) in enumerate(cases):
        parts, cand = _select_inputs(shape, cand_shape, mesh.devices, i)
        before = cr.ring_allreduce_select_cuda.launches
        for _ in range(3):   # repeated calls reuse the workspace
            got = co.ring_allreduce_select(parts, cand, mesh)
        torch.cuda.synchronize()
        want = co.ring_allreduce_select_plain(parts, cand)
        assert cr.ring_allreduce_select_cuda.launches == before + 3
        assert want.shape == cand_shape + shape[len(cand_shape):]
        for g in got:
            assert torch.equal(g.to(want.device), want), shape
    assert _routes(mesh, "select") == {cr.ring_route(mesh.devices)}


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 4])
def test_ring_select_equals_twin_on_virtual_shards(cuda_device, D):
    _check_select([cuda_device] * D)


@pytest.mark.cuda
def test_ring_select_on_an_uneven_mesh(cuda_device):
    first, second = _two_cards()[:2]
    _check_select([first, first, second])


# -- the direct kernels (every shard on one card) ----------------------------
# the ring's sum, element by element, in one ordinary launch: exact against
# the twins at every D, on 16-byte aligned inputs (float4) and on
# misaligned views (scalar), over repeated calls

DIRECT_SHAPES = RING_SHAPES + [(7, 5), (1,), (3, 100)]
DIRECT_SELECT_CASES = SELECT_CASES + [((5, 256, 3), (1,)),
                                      ((2, 23, 32, 3), (2, 8))]


def _misaligned(parts):
    """Each part again, as a view one element into a larger buffer: no
    longer 16-byte aligned."""
    out = []
    for p in parts:
        buf = torch.empty(p.numel() + 1, dtype=p.dtype, device=p.device)
        view = buf[1:].view(p.shape)
        view.copy_(p)
        out.append(view)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 3, 4, 8])
def test_direct_kernels_equal_twins(cuda_device, D):
    mesh = build_mesh(devices=[cuda_device] * D)
    assert cr.ring_route(mesh.devices) == "direct"
    for i, shape in enumerate(DIRECT_SHAPES):
        parts = _parts(shape, mesh.devices, seed=100 + i)
        want = co.ring_allreduce_plain(parts)
        for x in (parts, _misaligned(parts)):
            for _ in range(2):
                got = cr.ring_allreduce_cuda(x, mesh)
                torch.cuda.synchronize()
                assert len(got) == D
                assert all(torch.equal(g, want) for g in got), shape
    for i, (shape, cand_shape) in enumerate(DIRECT_SELECT_CASES):
        parts, cand = _select_inputs(shape, cand_shape, mesh.devices, 50 + i)
        want = co.ring_allreduce_select_plain(parts, cand)
        for x in (parts, _misaligned(parts)):
            for c in (cand, cand.cpu()):
                got = cr.ring_allreduce_select_cuda(x, c, mesh)
                torch.cuda.synchronize()
                assert all(torch.equal(g, want) for g in got), shape
    assert _routes(mesh, "dense") == _routes(mesh, "select") == {"direct"}


@pytest.mark.cuda
def test_one_card_calls_allocate_no_ring_buffers(cuda_device):
    """A direct workspace holds no comm slot or flag, and a call makes one
    output allocation whose D views it returns."""
    mesh = build_mesh(devices=[cuda_device] * 4)
    dense = _parts((50, 256, 3), mesh.devices, seed=3)
    parts, cand = _select_inputs((2, 200, 256, 3), (2, 32), mesh.devices, 4)
    a = co.ring_allreduce(dense, mesh)
    b = co.ring_allreduce_select(parts, cand, mesh)
    torch.cuda.synchronize()
    for kind, out in (("dense", a), ("select", b)):
        [ws] = [w for k, w in mesh.scratch.items() if k[1] == kind]
        assert ws.route == "direct"
        assert ws.slots == [] and ws.flags == [] and ws.work == []
        base = out[0].untyped_storage().data_ptr()
        assert all(o.untyped_storage().data_ptr() == base for o in out)
        assert [o.data_ptr() - base for o in out] == \
            [r * out[0].numel() * 4 for r in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 3, 4])
def test_ring_kernels_on_one_card_equal_twins(cuda_device, D):
    """The ring kernels that meshes spanning cards take, run on D virtual
    shards of one card: exact against the twins over repeated calls, with
    ``cand`` on the card and on the host, and the dense and select rings
    of one payload size interleaved on their own flags."""
    mesh = build_mesh(devices=[cuda_device] * D)
    for i, shape in enumerate(RING_SHAPES):
        parts = _parts(shape, mesh.devices, seed=200 + i)
        want = co.ring_allreduce_plain(parts)
        for _ in range(3):
            got = cr._allreduce(parts, mesh, "ring")
        torch.cuda.synchronize()
        assert all(torch.equal(g, want) for g in got), shape
    for i, (shape, cand_shape) in enumerate(SELECT_CASES):
        parts, cand = _select_inputs(shape, cand_shape, mesh.devices, 300 + i)
        want = co.ring_allreduce_select_plain(parts, cand)
        for c in (cand, cand.cpu()):
            got = cr._allreduce_select(parts, c, mesh, "ring")
            torch.cuda.synchronize()
            assert all(torch.equal(g, want) for g in got), shape
    dense = _parts((64, 256, 3), mesh.devices, seed=1)
    parts, cand = _select_inputs((2, 200, 256, 3), (2, 32), mesh.devices, 2)
    for _ in range(4):
        a = cr._allreduce(dense, mesh, "ring")
        b = cr._allreduce_select(parts, cand, mesh, "ring")
    torch.cuda.synchronize()
    want_a = co.ring_allreduce_plain(dense)
    want_b = co.ring_allreduce_select_plain(parts, cand)
    assert all(torch.equal(x, want_a) for x in a)
    assert all(torch.equal(x, want_b) for x in b)
    assert _routes(mesh, "dense") == _routes(mesh, "select") == {"ring"}


@pytest.mark.cuda
def test_direct_select_traps_on_a_bad_candidate_on_the_card(cuda_device):
    """A candidate column outside [0, f) on the card traps the kernel (an
    error at the next synchronize) instead of reading outside the
    histogram.  In a process of its own: a trap leaves the process's CUDA
    context unusable."""
    import subprocess
    import sys
    code = (
        "import torch\n"
        "from mmlspark_tpu_torch.core.mesh import build_mesh\n"
        "from mmlspark_tpu_torch.ops import cuda_ring as cr\n"
        "mesh = build_mesh(devices=['cuda:0'] * 2)\n"
        "parts = [torch.zeros(11, 16, 3, device='cuda:0') for _ in range(2)]\n"
        "cand = torch.tensor([0, 11], dtype=torch.int32, device='cuda:0')\n"
        "cr.ring_allreduce_select_cuda(parts, cand, mesh)\n"
        "torch.cuda.synchronize()\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert "Error" in res.stderr, res.stderr[-2000:]


@pytest.mark.cuda
def test_select_and_dense_rings_never_share_flags(cuda_device):
    """Interleaved dense and select calls of one payload size on one mesh
    stay exact: each ring has its own workspace and sequence numbers."""
    mesh = build_mesh(devices=[cuda_device] * 4)
    dense = _parts((64, 256, 3), mesh.devices, seed=1)
    parts, cand = _select_inputs((2, 200, 256, 3), (2, 32), mesh.devices, 2)
    for _ in range(4):
        a = co.ring_allreduce(dense, mesh)
        b = co.ring_allreduce_select(parts, cand, mesh)
    torch.cuda.synchronize()
    assert a[0].numel() == b[0].numel()
    want_a = co.ring_allreduce_plain(dense)
    want_b = co.ring_allreduce_select_plain(parts, cand)
    assert all(torch.equal(x, want_a) for x in a)
    assert all(torch.equal(x, want_b) for x in b)


@pytest.mark.cuda
def test_ring_select_checks_its_inputs(cuda_device):
    mesh = build_mesh(devices=[cuda_device] * 2)
    parts, cand = _select_inputs((11, 16, 3), (4,), mesh.devices, 0)
    for bad in (cand.long(), cand[None, None], cand.cpu() + 11):
        with pytest.raises(ValueError):
            cr.ring_allreduce_select_cuda(parts, bad, mesh)
    with pytest.raises(ValueError):
        cr.ring_allreduce_select_cuda([p.cpu() for p in parts], cand, mesh)


@pytest.mark.cuda
def test_voting_fit_on_the_card_grows_the_cpu_voting_tree(cuda_device):
    """D = 4 virtual shards, voting with the ring: the card's first tree is
    the CPU voting fit's, and the root and every grow step reduced one
    voted slab through ring_select and nothing else."""
    from mmlspark_tpu_torch import LightGBMClassifier
    rng = np.random.default_rng(0)
    X = rng.normal(size=(5001, 12)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float64)
    table = {"features": X, "label": y}
    before = (cr.ring_allreduce_select_cuda.launches,
              cr.ring_allreduce_cuda.launches,
              cr.fused_segment_hist_ring_cuda.launches)
    trees = []
    for dev in (cuda_device, "cpu"):
        est = LightGBMClassifier(numIterations=2, numLeaves=15,
                                 collective="ring", parallelism="voting",
                                 topK=3, device=str(torch.device(dev).type))
        est.setMesh(build_mesh(devices=[dev] * 4))
        trees.append(est.fit(table).getModel().trees)
    for k in ("split_feature", "threshold", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(trees[0][0], k),
                                      getattr(trees[1][0], k))
    splits = sum(t.num_leaves - 1 for t in trees[0])
    after = (cr.ring_allreduce_select_cuda.launches,
             cr.ring_allreduce_cuda.launches,
             cr.fused_segment_hist_ring_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == \
        [len(trees[0]) + splits, 0, 0]


@pytest.mark.cuda
def test_feature_fit_on_the_card_grows_the_cpu_tree(cuda_device):
    """data+feature on a 2 × 2 grid of virtual devices: the first tree is
    the CPU fit's."""
    from mmlspark_tpu_torch import LightGBMClassifier
    rng = np.random.default_rng(1)
    X = rng.normal(size=(4001, 9)).astype(np.float32)
    y = (X[:, 0] - X[:, 5] > 0).astype(np.float64)
    trees = []
    for dev in (cuda_device, "cpu"):
        est = LightGBMClassifier(numIterations=2, numLeaves=15,
                                 parallelism="data+feature",
                                 device=str(torch.device(dev).type))
        est.setMesh(build_mesh(2, 2, devices=[dev] * 4))
        trees.append(est.fit({"features": X, "label": y})
                     .getModel().trees)
    for k in ("split_feature", "threshold", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(trees[0][0], k),
                                      getattr(trees[1][0], k))


@pytest.mark.cuda
def test_ring_wrappers_raise_without_their_library(cuda_device,
                                                   monkeypatch):
    """No fallback: a CUDA tensor never reaches a plain twin."""
    def broken():
        raise RuntimeError("nvcc failed for ring.cu")

    monkeypatch.setattr(cr, "_lib", broken)
    mesh = build_mesh(devices=[cuda_device] * 2)
    parts = _parts((7, 5), mesh.devices, seed=0)
    before = cr.ring_allreduce_cuda.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        co.ring_allreduce(parts, mesh)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        co.fused_segment_hist_ring(
            _fused_shards(mesh.devices, "float32", [3, 4], 0), 256, mesh)
    sel, cand = _select_inputs((7, 5, 3), (3,), mesh.devices, 0)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        co.ring_allreduce_select(sel, cand, mesh)
    assert cr.ring_allreduce_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["auto", "pallas_ring"])
def test_mesh_fit_on_the_card_grows_the_cpu_mesh_tree(cuda_device, method):
    """D = 4 virtual shards with the ring: the card's first tree is the
    CPU mesh fit's, and every reduction went through the ring kernels."""
    from mmlspark_tpu_torch import LightGBMClassifier
    rng = np.random.default_rng(0)
    X = rng.normal(size=(5001, 8)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float64)
    table = {"features": X, "label": y}
    before = (cr.ring_allreduce_cuda.launches,
              cr.fused_segment_hist_ring_cuda.launches)
    trees = []
    for dev in (cuda_device, "cpu"):
        est = LightGBMClassifier(numIterations=2, numLeaves=15,
                                 collective="ring", histogramMethod=method,
                                 device=str(torch.device(dev).type))
        est.setMesh(build_mesh(devices=[dev] * 4))
        trees.append(est.fit(table).getModel().trees)
    for k in ("split_feature", "threshold", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(trees[0][0], k),
                                      getattr(trees[1][0], k))
    splits = sum(t.num_leaves - 1 for t in trees[0])
    ring = cr.ring_allreduce_cuda.launches - before[0]
    fused = cr.fused_segment_hist_ring_cuda.launches - before[1]
    if method == "auto":
        assert (ring, fused) == (len(trees[0]) + splits, 0)
    else:
        assert (ring, fused) == (len(trees[0]), splits)
