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
The wide modes (more than 256 bins, int32 codes) are also held to the
order they state (``histogram_segment_ordered``) bit for bit in f32.
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
        for _ in range(2):   # a second launch reuses the workspace
            got = co.fused_segment_hist_ring(shards, 256, mesh, accum)
            want = co.fused_segment_hist_ring_plain(shards, 256, accum)
            for g in got:
                _check(g.to(want.device), want, accum)
        assert cr.fused_segment_hist_ring_cuda.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("D", [2, 4])
def test_fused_hist_ring_f32_is_the_same_on_every_launch(cuda_device, D):
    """fused_hist_ring adds its row tiles' partials in tile order, with no
    float atomic: 20 launches on the same shards give the same bits, on
    every shard."""
    mesh = build_mesh(devices=[cuda_device] * D)
    shards = _fused_shards(mesh.devices, "float32", [5000] * D, seed=3)
    first = co.fused_segment_hist_ring(shards, 256, mesh, "float32")
    first = [g.clone() for g in first]
    for _ in range(19):
        got = co.fused_segment_hist_ring(shards, 256, mesh, "float32")
        assert all(torch.equal(a, b) for a, b in zip(got, first))
    assert all(torch.equal(first[0], g) for g in first[1:])


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


@pytest.mark.cuda
def test_bitset_partition_on_the_card_equals_the_cpu(cuda_device):
    """A categorical split's partition (bins in the node's bitset go
    left) on the card: the same stable order and left count as on the
    CPU."""
    from mmlspark_tpu_torch.gbdt import grower
    rng = np.random.default_rng(3)
    n, B = 50_000, 256
    col = torch.from_numpy(rng.integers(0, B, size=n).astype(np.uint8))
    order = torch.from_numpy(rng.permutation(n).astype(np.int32))
    bits = grower.pack_bin_mask(torch.from_numpy(rng.random(B) < 0.3), 8)
    got = order.to(cuda_device)
    n_card = grower._partition_left(got, col.to(cuda_device), 0, 777,
                                    40_000, bits.to(cuda_device))
    want = order.clone()
    n_cpu = grower._partition_left(want, col, 0, 777, 40_000, bits)
    assert int(n_card) == int(n_cpu) > 0
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def _same_trees(a, b, count):
    for ta, tb in zip(a[:count], b[:count]):
        for k in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child", "cat_boundaries",
                  "cat_threshold"):
            np.testing.assert_array_equal(getattr(ta, k), getattr(tb, k))


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_d", [1, 4])
def test_categorical_fit_on_the_card_grows_the_cpu_tree(cuda_device,
                                                        mesh_d):
    """Two categorical columns (24 and 300 categories, the second beyond
    maxBin − 1 = 63) beside numeric ones, serially and on D = 4 virtual
    shards with the ring: the card's first tree is the CPU's, with its
    categorical splits."""
    from mmlspark_tpu_torch import LightGBMClassifier
    rng = np.random.default_rng(4)
    n = 6000
    X = rng.normal(size=(n, 5)).astype(np.float32)
    X[:, 0] = rng.integers(0, 24, size=n)
    X[:, 3] = rng.integers(0, 300, size=n)
    y = (np.isin(X[:, 0], [1, 4, 8, 13, 21]) + 0.5 * X[:, 1]
         + (X[:, 3] % 7 == 0) + rng.normal(size=n) * 0.3 > 0.6)
    table = {"features": X, "label": y.astype(np.float64)}
    trees = []
    for dev in (cuda_device, "cpu"):
        est = LightGBMClassifier(numIterations=3, numLeaves=15, maxBin=63,
                                 categoricalSlotIndexes=[0, 3],
                                 collective="ring",
                                 device=str(torch.device(dev).type))
        if mesh_d > 1:
            est.setMesh(build_mesh(devices=[dev] * mesh_d))
        trees.append(est.fit(table).getModel().trees)
    assert trees[0][0].num_cat >= 1
    _same_trees(trees[0], trees[1], 1)


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_multiclass_fit_on_the_card_grows_the_cpu_trees(cuda_device,
                                                        objective):
    """Three classes: the card's first iteration (K trees, one root
    histogram each) is the CPU's, and so are its probabilities."""
    from mmlspark_tpu_torch import LightGBMClassifier
    rng = np.random.default_rng(5)
    X = rng.normal(size=(6000, 6)).astype(np.float32)
    s = np.stack([X[:, 0], X[:, 1] - X[:, 2], 0.5 * X[:, 3]], 1)
    y = (s + rng.normal(size=s.shape) * 0.5).argmax(1).astype(np.float64)
    table = {"features": X, "label": y}
    models = []
    before = ch.histogram_cuda.launches
    for dev in (cuda_device, "cpu"):
        models.append(LightGBMClassifier(
            numIterations=3, numLeaves=15, objective=objective,
            device=str(torch.device(dev).type)).fit(table))
    trees = [m.getModel().trees for m in models]
    assert len(trees[0]) == len(trees[1]) == 9
    assert ch.histogram_cuda.launches - before == 9
    _same_trees(trees[0], trees[1], 3)
    probs = [m.getModel().predict(X, num_iteration=1, device=dev).cpu()
             for m, dev in zip(models, (cuda_device, "cpu"))]
    np.testing.assert_allclose(probs[0].numpy(), probs[1].numpy(),
                               rtol=1e-4, atol=1e-4)


# -- quantized training and its PRNG -------------------------------------------


@pytest.mark.cuda
def test_threefry_on_the_card_equals_the_cpu(cuda_device):
    """The threefry module gives the same words and uniforms on the card
    as on the CPU (where the CPU tests hold it to jax.random)."""
    from mmlspark_tpu_torch.ops import threefry as tf
    for seed in (0, 42, 2 ** 31 - 1):
        keys = {d: tf.prng_key(seed, d) for d in ("cpu", cuda_device)}
        for shape in ((7,), (65_537,), (400_000, 2)):
            a, b = (tf.uniform(k, shape) for k in keys.values())
            assert torch.equal(a, b.cpu()), (seed, shape)
        a, b = (tf.split(k, 50) for k in keys.values())
        assert torch.equal(a, b.cpu())
        g = torch.tensor(3.8995044, dtype=torch.float32)
        a, b = (tf.fold_in(k, tf.float_bits(g.to(k.device)))
                for k in keys.values())
        assert torch.equal(a, b.cpu())


#: the flagship's headroom edge: 400,000 rows at max_code 5,368 (16 bits,
#: (2^31 - 1) // 400,000), every row in one bin: n * max_code =
#: 2,147,200,000, 283,647 below 2^31 - 1
EDGE_ROWS, EDGE_CODE = 400_000, 5_368


def _edge_inputs(dev, sign, rows=EDGE_ROWS, f=50):
    bins = torch.full((rows, f), 7, dtype=torch.uint8, device=dev)
    gh = torch.tensor([sign * EDGE_CODE, EDGE_CODE, 1], dtype=torch.int32,
                      device=dev).expand(rows, 3).contiguous()
    return bins, gh


def _edge_want(rows, f, B=256, sign=1):
    want = torch.zeros((f, B, 3), dtype=torch.int64)
    want[:, 7] = torch.tensor([sign * rows * EDGE_CODE, rows * EDGE_CODE,
                               rows])
    return want.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [1, -1])
def test_int32_histograms_hold_the_headroom_edge(cuda_device, sign):
    """Every row in one bin and every code at ±max_code: hist_full and
    hist_segment (the segment of every row) give the exact int32 cells
    n·max_code, as their twins do."""
    bins, gh = _edge_inputs(cuda_device, sign)
    want = _edge_want(EDGE_ROWS, 50, sign=sign)
    full = ch.histogram_cuda(bins, gh, 256, "int32")
    order = torch.arange(EDGE_ROWS, dtype=torch.int32, device=cuda_device)
    seg = ch.histogram_cuda_fused(bins, gh, order, 0, EDGE_ROWS, 256,
                                  "int32")
    for got, twin in ((full, ch.histogram_plain(bins, gh, 256, "int32")),
                      (seg, ch.histogram_fused_plain(
                          bins, gh, order, 0, EDGE_ROWS, 256, "int32"))):
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        assert torch.equal(twin.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [1, -1])
def test_int32_fused_ring_holds_the_headroom_edge(cuda_device, sign):
    """The same edge split over D = 4 virtual shards of 100,000 rows:
    fused_hist_ring's int32 partials and merges stay exact."""
    D, S = 4, EDGE_ROWS // 4
    mesh = build_mesh(devices=[cuda_device] * D)
    shards = []
    for d in range(D):
        bins, gh = _edge_inputs(cuda_device, sign, rows=S)
        order = torch.arange(S, dtype=torch.int32, device=cuda_device)
        shards.append((bins, gh, order, 0, S))
    got = co.fused_segment_hist_ring(shards, 256, mesh, "int32")
    want = _edge_want(EDGE_ROWS, 50, sign=sign)
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), want) for g in got)
    assert torch.equal(co.fused_segment_hist_ring_plain(
        shards, 256, "int32").cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["direct", "ring"])
@pytest.mark.parametrize("D", [2, 4])
def test_integer_slabs_ride_the_rings_exactly(cuda_device, D, route):
    """Quantized histograms cross the dense and select rings as f32 lanes
    and cast back: the wrappers' integer results equal the twins' and the
    exact sums (every sum below 2^24), on both routes."""
    mesh = build_mesh(devices=[cuda_device] * D)
    rng = np.random.default_rng(D)
    parts = [torch.from_numpy(rng.integers(-2 ** 21, 2 ** 21, (2, 40, 64, 3))
                              .astype(np.int32)).to(cuda_device)
             for _ in range(D)]
    cand = torch.from_numpy(np.stack([rng.choice(40, 9, replace=False)
                                      for _ in range(2)]).astype(np.int32))
    want = sum(p.long() for p in parts).int()
    want_sel = torch.stack([want[c][cand[c].long().to(want.device)]
                            for c in range(2)])
    lanes = [p.float() for p in parts]
    dense = [g.int() for g in cr._allreduce(lanes, mesh, route)]
    sel = [g.int() for g in cr._allreduce_select(
        lanes, cand.to(cuda_device), mesh, route)]
    if route == cr.ring_route(mesh.devices):
        dense += co.ring_allreduce(parts, mesh)
        sel += co.ring_allreduce_select(parts, cand.to(cuda_device), mesh)
    torch.cuda.synchronize()
    assert torch.equal(co.ring_allreduce_plain(parts), want)
    assert all(g.dtype == torch.int32 and torch.equal(g, want)
               for g in dense)
    assert all(torch.equal(g, want_sel) for g in sel)


def _quant_data(n=8192, f=100, seed=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 1.5 + X[:, 1] * X[:, 2] + rng.normal(size=n) * 0.5 > 0)
    return {"features": X, "label": y.astype(np.float64)}


@pytest.mark.cuda
def test_quantized_pallas_ring_fit_is_the_same_run_to_run(cuda_device):
    """A quantized D = 4 pallas_ring fit (max_code 3, int16 wire, ring
    kept) runs the int32 fused kernel, and its integer sums commute: two
    fits write one model text, which is the CPU mesh fit's."""
    from mmlspark_tpu_torch import LightGBMClassifier
    from mmlspark_tpu_torch.gbdt import engine
    table = _quant_data()
    texts = []
    for dev in (cuda_device, cuda_device, "cpu"):
        est = LightGBMClassifier(
            numIterations=4, numLeaves=15, quantizedGrad="16",
            collective="ring", histogramMethod="pallas_ring",
            device=str(torch.device(dev).type))
        est.setMesh(build_mesh(devices=[dev] * 4))
        before = cr.fused_segment_hist_ring_cuda.launches
        texts.append(est.fit(table).getNativeModel())
        if dev != "cpu":
            assert cr.fused_segment_hist_ring_cuda.launches > before
        assert engine.last_fit_info["quantized_max_code"] == "3"
        assert engine.last_fit_info["collective"] == "ring"
    assert texts[0] == texts[1] == texts[2]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(boostingType="goss"),
                                dict(quantizedGrad="16"),
                                dict(quantizedGrad="8")],
                         ids=["goss", "q16", "q8"])
def test_goss_and_quantized_fits_on_the_card_grow_the_cpu_trees(cuda_device,
                                                               kw):
    """GOSS draws the same sample and the quantizer the same codes on the
    card as on the CPU (threefry, sorts of integer keys), so the first
    trees agree."""
    from mmlspark_tpu_torch import LightGBMClassifier
    table = _quant_data(20_000, 20)
    trees = [LightGBMClassifier(numIterations=3, numLeaves=15, device=d,
                                **kw).fit(table).getModel().trees
             for d in ("cuda", "cpu")]
    _same_trees(trees[0], trees[1], 1)


@pytest.mark.cuda
def test_early_stopping_on_the_card_stops_where_the_cpu_does(cuda_device):
    """20,000 rows, 10 iterations, earlyStoppingRound 3: the card stops at
    the CPU's iteration, with validation metrics within 1e-5 relative at
    every iteration."""
    from mmlspark_tpu_torch import LightGBMClassifier
    from mmlspark_tpu_torch.gbdt import engine
    table = _quant_data(20_000, 20)
    table["val"] = np.random.default_rng(3).random(20_000) < 0.2
    stops, metrics = [], []
    for dev in ("cuda", "cpu"):
        booster = LightGBMClassifier(
            numIterations=10, learningRate=0.5, numLeaves=31, device=dev,
            validationIndicatorCol="val", earlyStoppingRound=3,
        ).fit(table).getModel()
        stops.append(booster.params["num_iterations"])
        metrics.append(engine.last_validation["metrics"])
    assert stops[0] == stops[1]
    np.testing.assert_allclose(metrics[0], metrics[1], rtol=1e-5)


def _rank_table(n_queries=120, f=20, seed=5):
    rng = np.random.default_rng(seed)
    q = np.repeat(np.arange(n_queries), rng.integers(20, 120, n_queries))
    X = rng.normal(size=(len(q), f)).astype(np.float32)
    s = X[:, :5] @ rng.normal(size=5) + rng.normal(size=len(q))
    y = np.digitize(s, np.quantile(s, [0.5, 0.82, 0.95, 0.985]))
    return {"features": X, "label": y.astype(np.float64), "query": q}


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(boostingType="dart", dropRate=0.5, skipDrop=0.0),
    dict(boostingType="rf", baggingFraction=0.8, baggingFreq=1,
         featureFraction=0.8),
    dict(objective="poisson"), dict(objective="gamma"),
    dict(objective="cross_entropy")], ids=["dart", "rf", "poisson", "gamma",
                                           "cross_entropy"])
def test_dart_rf_and_objectives_on_the_card_grow_the_cpu_trees(cuda_device,
                                                               kw):
    """DART (drops in most iterations), rf and the log-link and
    cross-entropy objectives: the card's first tree is the CPU's, and the
    predictions agree within 1e-4 over the iterations whose trees match
    (f32 histograms add each cell in another order on the card)."""
    from mmlspark_tpu_torch import LightGBMRegressor
    table = _quant_data(20_000, 20)
    y = table["label"]
    if kw.get("objective") in ("poisson", "gamma"):
        table = {**table, "label": np.exp(table["features"][:, 0] * 0.3)
                 + y}
    models = [LightGBMRegressor(numIterations=4, numLeaves=15, device=d,
                                **kw).fit(table) for d in ("cuda", "cpu")]
    trees = [m.getModel().trees for m in models]
    _same_trees(trees[0], trees[1], 1)
    if kw.get("boostingType") == "dart":
        # the card and the CPU drop the same iterations: the same scales
        assert [t.shrinkage for t in trees[0]] == \
            [t.shrinkage for t in trees[1]]
    X = table["features"]
    a = models[0].getModel().predict(X, num_iteration=1).cpu().numpy()
    b = models[1].getModel().predict(X, num_iteration=1,
                                     device="cpu").numpy()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_d", [1, 4])
def test_ranker_on_the_card_grows_the_cpu_tree(cuda_device, mesh_d):
    """A ranker fit (120 queries of 20–119 documents), serially and on
    D = 4 virtual shards (each query on one shard): the lambda gradients
    are the CPU's bit for bit, so the first tree is the CPU's, and the
    NDCG@10 of the two fits agrees within 0.01."""
    from mmlspark_tpu_torch import LightGBMRanker, ndcg_at_k
    from mmlspark_tpu_torch.gbdt.ranking import LambdarankGradient
    table = _rank_table()
    grads = [LambdarankGradient.serial(table["label"], table["query"], 1.0,
                                       30, d).grad_hess(
        0, torch.full((len(table["label"]),), 0.25, device=d))
        for d in ("cuda", "cpu")]
    for a, b in zip(*grads):
        assert torch.equal(a.cpu(), b)
    models, ndcg = [], []
    for d in ("cuda", "cpu"):
        est = LightGBMRanker(numIterations=5, numLeaves=15, device=d)
        if mesh_d > 1:
            est.setMesh(build_mesh(devices=[d] * mesh_d))
        m = est.fit(table)
        models.append(m.getModel().trees)
        ndcg.append(ndcg_at_k(m.transform(table)["prediction"],
                              table["label"], table["query"], 10))
    _same_trees(models[0], models[1], 1)
    assert abs(ndcg[0] - ndcg[1]) < 0.01


# -- wide bins (more than 256: int32 codes) ----------------------------------

WIDE_BINS = (257, 512, 1024, 4096)
WIDE_ROWS = (1, 777, 6522)


@functools.lru_cache(maxsize=8)
def _wide_inputs(n, f, B, seed=11):
    """n rows of f int32 codes in [0, B + 8) (the codes >= B are dropped),
    a float and an integer gh, and a row order; on the CPU."""
    rng = np.random.default_rng(seed + B)
    bins = torch.from_numpy(rng.integers(0, B + 8, size=(n, f),
                                         dtype=np.int32))
    gh = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    gh_int = torch.from_numpy(rng.integers(-300, 300, size=(n, 3),
                                           dtype=np.int32))
    order = torch.from_numpy(rng.permutation(n).astype(np.int32))
    return bins, gh, gh_int, order


def _check_wide(got, bins, ghm, order, off, cnt, B, accum, variant):
    """A wide kernel's result against its twin (int32 exactly, f32 and
    bf16 within the per-cell tolerance) and against the order it states
    (``histogram_segment_ordered``), bit for bit."""
    torch.cuda.synchronize()
    want = ch.histogram_fused_plain(bins, ghm, order, off, cnt, B, accum)
    gh_abs = ch._gh_values(ghm, accum).abs().float()
    _check_tol(got.cpu(), want, ch.histogram_fused_plain(
        bins, gh_abs, order, off, cnt, B), accum)
    geom = ch.segment_launch_geometry(cnt, bins.shape[1], B, accum,
                                      got.device, variant)
    ordered = ch.histogram_segment_ordered(
        bins, ghm, None if variant == ch.FULL_WIDE else order, off, cnt, B,
        accum, geom)
    assert torch.equal(got.cpu(), ordered), geom


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("B", WIDE_BINS)
@pytest.mark.parametrize("n", WIDE_ROWS)
def test_wide_hist_full_matches_twin_and_order(cuda_device, n, B, accum):
    bins, gh, gh_int, _ = _wide_inputs(n, 50, B)
    ghm = gh_int if accum == "int32" else gh
    before = ch.histogram_cuda.launches
    got = ch.histogram_cuda(bins.cuda(), ghm.cuda(), B, accum)
    assert ch.histogram_cuda.launches == before + 1
    assert got.shape == (50, B, 3)
    _check_wide(got, bins, ghm, torch.arange(n, dtype=torch.int32), 0, n,
                B, accum, ch.FULL_WIDE)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("B", WIDE_BINS)
@pytest.mark.parametrize("cnt", WIDE_ROWS)
def test_wide_hist_segment_matches_twin_and_order(cuda_device, cnt, B,
                                                  accum):
    bins, gh, gh_int, order = _wide_inputs(20_000, 50, B)
    ghm = gh_int if accum == "int32" else gh
    off = 1234
    before = ch.histogram_cuda_fused.launches
    got = ch.histogram_cuda_fused(bins.cuda(), ghm.cuda(), order.cuda(),
                                  off, cnt, B, accum)
    assert ch.histogram_cuda_fused.launches == before + 1
    _check_wide(got, bins, ghm, order, off, cnt, B, accum, ch.SEG_WIDE)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ACCUMS)
def test_wide_kernels_at_the_flagship_shape(cuda_device, accum):
    """400,000 x 50 at 1,024 bins (several clusters a group, merged
    through the workspace): the full histogram and a 200,000-row segment
    against their twins and their stated orders, and 5 calls the same
    bits."""
    B = 1024
    bins, gh, gh_int, order = _wide_inputs(400_000, 50, B)
    ghm = gh_int if accum == "int32" else gh
    b, g, o = bins.cuda(), ghm.cuda(), order.cuda()
    full = ch.histogram_cuda(b, g, B, accum)
    _check_wide(full, bins, ghm, torch.arange(400_000, dtype=torch.int32),
                0, 400_000, B, accum, ch.FULL_WIDE)
    seg = ch.histogram_cuda_fused(b, g, o, 100, 200_000, B, accum)
    _check_wide(seg, bins, ghm, order, 100, 200_000, B, accum, ch.SEG_WIDE)
    for _ in range(4):
        assert torch.equal(ch.histogram_cuda(b, g, B, accum), full)
        assert torch.equal(ch.histogram_cuda_fused(b, g, o, 100, 200_000, B,
                                                   accum), seg)


@pytest.mark.cuda
def test_wide_limit_is_the_shared_memory(cuda_device):
    """The wide modes take up to ``wide_max_bins`` of the card's budget;
    one more raises a ValueError that names the limit."""
    card = ch._seg_card(torch.device("cuda", torch.cuda.current_device()))
    most = ch.wide_max_bins(card.budget)
    assert most >= 4096
    bins, gh, _, order = _wide_inputs(777, 1, most)
    b, g, o = bins.cuda(), gh.cuda(), order.cuda()
    for got in (ch.histogram_cuda(b, g, most),
                ch.histogram_cuda_fused(b, g, o, 0, 777, most)):
        _check_tol(got.cpu(), ch.histogram_fused_plain(bins, gh, order, 0,
                                                       777, most),
                   ch.histogram_fused_plain(bins, gh.abs(), order, 0, 777,
                                            most), "float32")
    with pytest.raises(ValueError, match=f"1..{most} bins"):
        ch.histogram_cuda(b, g, most + 1)
    with pytest.raises(ValueError, match=f"1..{most} bins"):
        ch.histogram_cuda_fused(b, g, o, 0, 777, most + 1)


@pytest.mark.cuda
def test_no_code_is_narrowed(cuda_device):
    """Codes are uint8 up to 256 bins and int32 above, nothing else: an
    int32 code of 300 lands in bin 300 at 512 bins (as a byte it would be
    44), and int32 codes at 256 bins or uint8 codes at 512 raise."""
    bins = torch.full((100, 2), 300, dtype=torch.int32, device=cuda_device)
    gh = torch.ones(100, 3, device=cuda_device)
    got = ch.histogram_cuda(bins, gh, 512)
    assert float(got[:, 300, 2].sum()) == 200.0
    assert float(got.sum()) == 600.0
    order = torch.arange(100, dtype=torch.int32, device=cuda_device)
    got = ch.histogram_cuda_fused(bins, gh, order, 0, 100, 512)
    assert float(got[:, 300, 2].sum()) == 200.0
    with pytest.raises(ValueError, match="uint8"):
        ch.histogram_cuda(bins, gh, 256)
    with pytest.raises(ValueError, match="int32"):
        ch.histogram_cuda(bins.to(torch.uint8), gh, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_compiled_predictor_equals_predict_margin(cuda_device, objective):
    """A continued fit on the card: ``predictor()`` margins equal
    ``predict_margin`` bit for bit, tree-range partials sum to them, and
    the leaf indices equal the CPU walk's."""
    import tempfile

    from mmlspark_tpu_torch import LightGBMClassifier
    rng = np.random.default_rng(9)
    X = rng.normal(size=(4000, 10))
    s = X[:, 0] + X[:, 1] * X[:, 2] + rng.normal(size=4000)
    y = ((s > 0).astype(float) if objective == "binary"
         else np.digitize(s, [-0.7, 0.7]).astype(float))
    table = {"features": X, "label": y}
    kw = dict(numIterations=4, numLeaves=15, verbosity=0, device="cuda",
              objective=objective)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/base.txt"
        LightGBMClassifier(**kw).fit(table).saveNativeModel(path)
        booster = LightGBMClassifier(initModelPath=path, **kw).fit(
            table).getModel()
    K = booster.num_class
    Xd = torch.as_tensor(X, device=cuda_device)
    full = booster.predictor()(Xd)
    assert full.is_cuda and torch.equal(full, booster.predict_margin(Xd))
    lo = booster.predictor(tree_range=(0, 4 * K))(Xd)
    hi = booster.predictor(tree_range=(4 * K, 8 * K),
                           include_init_score=False)(Xd)
    torch.testing.assert_close(lo + hi, full, rtol=1e-5, atol=1e-5)
    assert torch.equal(booster.predict_leaf_index(Xd).cpu(),
                       booster.predict_leaf_index(X, device="cpu"))


# -- the observability core on the card ----------------------------------------


@pytest.mark.cuda
def test_profiler_watermarks_and_dispatch_bracket_on_a_card_fit(cuda_device,
                                                                  tmp_path):
    """A small card fit: the profiler's ``cuda:0`` watermarks hold
    ``bytes_in_use <= peak_bytes_in_use <= bytes_limit`` (the peak at
    least the codes), the ``train.boost_chunk`` dispatch bracket records
    one host and one device-wait phase per ``boost_chunk`` event, and the
    fit writes the same forest with the profiler and the profile capture
    off."""
    import os

    from mmlspark_tpu_torch.core import telemetry as tm
    from mmlspark_tpu_torch.core.profiler import get_profiler
    from mmlspark_tpu_torch.gbdt import (engine, fit_bin_mapper,
                                         get_objective)
    tm.configure_flight_recorder(directory=str(tmp_path))
    rng = np.random.default_rng(3)
    X = rng.normal(size=(50_000, 20)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float64)
    mapper = fit_bin_mapper(X, max_bin=63)
    bins = torch.as_tensor(mapper.transform_packed(X), device=cuda_device)
    params = engine.TrainParams(num_iterations=8, num_leaves=15,
                                verbosity=-1)
    prof = get_profiler()
    texts = []
    for on in (True, False):
        prof.configure(enabled=on)
        os.environ[engine.REF_PROFILE_ENV] = "1" if on else "0"
        try:
            st = prof.stats.snapshot()["stages"]
            n0 = st.get("train.boost_chunk.device_wait", {}).get("count", 0)
            seq0 = tm.get_journal().events()[-1]["seq"] \
                if tm.get_journal().events() else 0
            b = engine.train(bins, y, None, mapper,
                             get_objective("binary"), params)
            texts.append(b.save_native_model_string())
            chunks = [e for e in tm.get_journal().events()
                      if e["seq"] > seq0 and e["ev"] == "boost_chunk"]
            st = prof.stats.snapshot()["stages"]
            waits = st.get("train.boost_chunk.device_wait",
                           {}).get("count", 0) - n0
            assert waits == (len(chunks) if on else 0)
            assert (b.reference_profile is not None) == on
        finally:
            prof.configure(enabled=True)
            os.environ.pop(engine.REF_PROFILE_ENV, None)
    assert texts[0] == texts[1]
    prof.sample_memory(min_interval_s=0.0)
    mem = prof.snapshot()["memory_bytes"]
    used, peak, limit = (mem[f"cuda:0/{k}"] for k in (
        "bytes_in_use", "peak_bytes_in_use", "bytes_limit"))
    assert used <= peak <= limit
    assert peak >= bins.numel()
    assert prof.snapshot()["build_events"].get("cuda_load", {}).get(
        "count", 0) >= 1


# -- the serving plane on the card ---------------------------------------------


def _card_booster(cuda_device, n=20_000, f=12, iterations=10):
    """A small card booster reloaded from its model text on the card."""
    from mmlspark_tpu_torch import LightGBMRegressor
    from mmlspark_tpu_torch.gbdt import Booster
    rng = np.random.default_rng(17)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2]).astype(np.float64)
    m = LightGBMRegressor(numIterations=iterations, numLeaves=15,
                          verbosity=0, device="cuda").fit(
        {"features": X, "label": y})
    text = m.getModel().save_native_model_string()
    return Booster.load_native_model_string(text, device="cuda"), X


@pytest.mark.cuda
def test_scoring_engine_replies_equal_the_card_predictor(cuda_device):
    """The engine on a card booster's predictor (the device walk): every
    reply equals ``predict_margin`` on the card bit for bit, each batch
    ends in one device→host copy of a CUDA tensor, and the profiler's
    dispatch bracket records both halves."""
    import queue
    import threading
    import time

    from mmlspark_tpu_torch.core.profiler import get_profiler
    from mmlspark_tpu_torch.io.scoring import ScoringEngine
    b, X = _card_booster(cuda_device)
    pred = b.predictor(backend="jit")
    devices = []

    class Spy:
        num_features = pred.num_features
        mode = pred.mode

        def __call__(self, M):
            out = pred(M)
            devices.append(out.device.type)
            return out

    class Srv:
        def __init__(self):
            self.request_queue = queue.Queue()
            self.got = {}
            self.lock = threading.Lock()

        def reply(self, rid, val, status=200):
            with self.lock:
                self.got[rid] = (val, status)
            return True

    prof = get_profiler()
    prof.configure(enabled=True)
    srv = Srv()
    rows = X[:300]
    for i in range(len(rows)):
        srv.request_queue.put((str(i), {"features": rows[i].tolist()}))
    eng = ScoringEngine(srv, predictor=Spy(), max_rows=64,
                        latency_budget_ms=2.0, num_scorers=2).start()
    try:
        deadline = time.time() + 60
        while len(srv.got) < len(rows) and time.time() < deadline:
            time.sleep(0.01)
    finally:
        eng.stop()
    want = b.predict_margin(torch.as_tensor(rows, device=cuda_device))
    want = want.cpu().numpy()
    assert [srv.got[str(i)] for i in range(len(rows))] \
        == [(v, 200) for v in want.tolist()]
    assert devices and set(devices) == {"cuda"}
    st = eng.stats_snapshot()["stages"]
    assert st["device_wait"]["count"] == len(devices)
    assert st["dispatch_host"]["count"] == len(devices)


@pytest.mark.cuda
def test_sharded_predictor_on_the_card_equals_the_fleet(cuda_device):
    """``ShardedPredictor`` on a card booster equals the fleet's reduce of
    its workers' partials (threads over real sockets, each scoring its
    tree range on the card) and the replica pool equals the card's
    margins."""
    from mmlspark_tpu_torch.io.fleet import PredictorFleet, ShardedPredictor
    b, X = _card_booster(cuda_device)
    sp = ShardedPredictor(b, num_shards=3)
    want = sp(X[:512])
    assert isinstance(want, np.ndarray)
    for routing, expect in (("shard", want),
                            ("replica", b.predict_margin(
                                X[:512]).cpu().numpy())):
        fleet = PredictorFleet(b, num_shards=3, routing=routing,
                               spawn=False, join_timeout=60.0).start()
        try:
            assert fleet._device.startswith("cuda")
            assert np.array_equal(fleet(X[:512]), expect)
        finally:
            fleet.stop()


@pytest.mark.cuda
def test_registry_and_rollout_serve_from_the_card(cuda_device, tmp_path):
    """A registry loads its versions on the card by default, and a
    rollout canary there routes each row to an arm whose margins equal
    that arm's card predictor bit for bit, brought to the host as an
    ndarray."""
    from mmlspark_tpu_torch.io import (ModelRegistry, RolloutConfig,
                                       RolloutController)
    b1, X = _card_booster(cuda_device)
    b2, _ = _card_booster(cuda_device, iterations=14)
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(b1, activate=True)
    v2 = reg.publish(b2)
    loaded = reg.load()
    assert loaded.predict_margin(X[:64]).is_cuda
    ctl = RolloutController(reg, config=RolloutConfig(
        canary_fraction=0.5, soak_s=0.0, min_canary_rows=1,
        canary_deadline_ms=None))
    ctl.start_canary(v2)
    rids = [f"r{i}" for i in range(1000)]
    got = ctl.score_routed(X[:1000], rids)
    assert isinstance(got, np.ndarray)
    arms = {v: reg.load(v).predictor()(X[:1000]).cpu().numpy()
            for v in (1, v2)}
    canary = np.array([ctl.arm_for(r) == "canary" for r in rids])
    assert 0 < canary.sum() < len(rids)
    assert np.array_equal(got, np.where(canary, arms[v2], arms[1]))
    assert ctl.tick() == "promoted"
    assert np.array_equal(ctl(X[:1000]), arms[v2])
