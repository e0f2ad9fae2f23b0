"""The port's cross-shard reductions against the JAX reference, on the CPU.

The reference runs its Pallas ring kernels in interpret mode over the
forced 8-device host platform of ``tests/conftest.py``; the port runs the
plain twins of its CUDA kernels (``ops/collectives.py``).  Inputs come
from numpy seeds and pass between the two as numpy arrays.

* ``ring_allreduce_plain`` adds each chunk in the ring's rotated order, so
  it equals the reference ring bit for bit at every D.
* ``psum_plain`` adds in shard order, as XLA's CPU ``lax.psum`` does, bit
  for bit.
* ``ring_allreduce_select_plain`` (gather the voted columns, then the
  ring over the flattened slab) equals the reference's
  ``ring_allreduce_select`` bit for bit, one slab and the stacked pair of
  a grow step, at D = 2, 3, 4.
* The direct kernels' order (each element summed from the shard of its
  chunk on, the select slab row by row with its chunk boundary), modelled
  element by element, equals the twins and the reference rings bit for
  bit; ``ring_route`` picks the direct kernels for one device only.
* The fused twin (segment histogram per shard, then the ring) equals the
  reference ``fused_segment_hist_ring`` exactly in int32.  In float32 the
  reference sums each cell through an MXU-shaped ``dot_general`` over
  one-hot blocks, another order than the twin's row-order ``index_add_``,
  so the two agree within rtol 1e-5, atol 1e-5 (cells are sums of O(10)
  standard normals; the reorder costs a few ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from mmlspark_tpu.core.mesh import DATA_AXIS, shard_map_compat
from mmlspark_tpu.ops.pallas_collectives import (fused_segment_hist_ring
                                                 as ref_fused,
                                                 ring_allreduce as ref_ring,
                                                 ring_allreduce_select
                                                 as ref_select)
from mmlspark_tpu_torch.core.mesh import build_mesh
from mmlspark_tpu_torch.ops import collectives as co
from mmlspark_tpu_torch.ops import cuda_ring as cr
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPES = [(11, 64, 3), (3,), (7, 5), (1, 129), (13, 17, 3)]


def _run_ref(fn, d, x, in_specs, out_spec):
    mesh = RefMesh(np.asarray(jax.devices()[:d]), (DATA_AXIS,))
    args = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, s))
            for a, s in zip(x, in_specs)]
    return np.asarray(jax.jit(shard_map_compat(fn, mesh, tuple(in_specs),
                                               out_spec))(*args))


def _partials(d, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(d,) + shape).astype(np.float32)


def _ref_reduce(fn, d, x):
    """Run ``fn`` over the d partials ``x[i]``; the first shard's result."""
    shape = x.shape[1:]
    spec = P(*((DATA_AXIS,) + (None,) * (len(shape) - 1)))
    out = _run_ref(fn, d, [x.reshape((-1,) + shape[1:])], [spec], spec)
    per = out.reshape((d,) + shape)
    for i in range(1, d):      # every rank holds the same sum
        np.testing.assert_array_equal(per[i], per[0])
    return per[0]


@pytest.mark.parametrize("d", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ring_plain_equals_reference_ring_bitwise(d, shape):
    x = _partials(d, shape, seed=d * 100 + len(shape))
    want = _ref_reduce(lambda a: ref_ring(a, DATA_AXIS, d, interpret=True),
                       d, x)
    got = co.ring_allreduce_plain([torch.from_numpy(p) for p in x])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [2, 4])
def test_psum_plain_equals_reference_psum_bitwise(d):
    x = _partials(d, (11, 64, 3), seed=d)
    want = _ref_reduce(lambda a: jax.lax.psum(a, DATA_AXIS), d, x)
    got = co.psum_plain([torch.from_numpy(p) for p in x])
    np.testing.assert_array_equal(got.numpy(), want)


def test_ring_and_psum_orders_differ_beyond_two_shards():
    """At D = 2 both orders add the same pair; at D = 4 they differ, so
    the two twins are not interchangeable."""
    for d, same in ((2, True), (4, False)):
        parts = [torch.from_numpy(p)
                 for p in _partials(d, (11, 64, 3), seed=7)]
        eq = torch.equal(co.ring_allreduce_plain(parts),
                         co.psum_plain(parts))
        assert eq == same, d


def test_ring_entry_delivers_to_every_shard():
    mesh = build_mesh(devices=["cpu"] * 3)
    parts = [torch.from_numpy(p) for p in _partials(3, (13, 17, 3), 1)]
    outs = co.ring_allreduce(parts, mesh)
    assert len(outs) == 3
    for o in outs:
        assert torch.equal(o, co.ring_allreduce_plain(parts))
    with pytest.raises(ValueError):
        co.ring_allreduce(parts[:2], mesh)


def test_resolve_collective():
    assert co.resolve_collective("auto", 4) == "psum"
    assert co.resolve_collective("psum", 4) == "psum"
    assert co.resolve_collective("ring", 4) == "ring"
    assert co.resolve_collective("ring", 1) == "psum"
    with pytest.raises(ValueError, match="Unknown collective"):
        co.resolve_collective("tree", 4)


#: (local histogram shape, candidate shape): one slab, the stacked pair
#: of a grow step, and a ragged slab whose size is no multiple of 128
SELECT_CASES = [((23, 32, 3), (8,)), ((2, 23, 32, 3), (2, 8)),
                ((9, 7, 3), (5,))]


def _select_case(d, hist_shape, cand_shape, seed):
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(d,) + hist_shape).astype(np.float32)
    f = hist_shape[len(cand_shape) - 1]
    cand = np.stack([rng.choice(f, size=cand_shape[-1], replace=False)
                     for _ in range(int(np.prod(cand_shape[:-1])))])
    return hist, cand.reshape(cand_shape).astype(np.int32)


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("hist_shape,cand_shape", SELECT_CASES, ids=str)
def test_select_plain_equals_reference_select_bitwise(d, hist_shape,
                                                      cand_shape):
    hist, cand = _select_case(d, hist_shape, cand_shape,
                              seed=d * 10 + len(cand_shape))
    in_spec = P(*((DATA_AXIS,) + (None,) * (len(hist_shape) - 1)))
    out_shape = cand_shape + hist_shape[len(cand_shape):]
    out_spec = P(*((DATA_AXIS,) + (None,) * (len(out_shape) - 1)))
    out = _run_ref(
        lambda h: ref_select(h, jnp.asarray(cand), DATA_AXIS, d,
                             interpret=True),
        d, [hist.reshape((-1,) + hist_shape[1:])], [in_spec], out_spec)
    per = out.reshape((d,) + out_shape)
    got = co.ring_allreduce_select_plain(
        [torch.from_numpy(h) for h in hist], torch.from_numpy(cand))
    assert got.shape == out_shape
    for i in range(d):      # every rank holds the same sum
        np.testing.assert_array_equal(got.numpy(), per[i])


def test_select_entry_gathers_then_reduces_to_every_shard():
    """The entry routes CPU parts to the twin and delivers to every shard;
    on one shard it is the gather alone, as in the reference."""
    hist, cand = _select_case(3, (2, 23, 32, 3), (2, 8), seed=5)
    parts = [torch.from_numpy(h) for h in hist]
    c = torch.from_numpy(cand)
    outs = co.ring_allreduce_select(parts, c, build_mesh(
        devices=["cpu"] * 3))
    want = co.ring_allreduce_plain([co.gather_cand(p, c) for p in parts])
    assert len(outs) == 3 and all(torch.equal(o, want) for o in outs)
    np.testing.assert_array_equal(
        co.gather_cand(parts[0], c).numpy(),
        np.stack([hist[0, m][cand[m]] for m in range(2)]))
    np.testing.assert_array_equal(
        co.ring_allreduce_select([parts[0][0]], c[0],
                                 build_mesh(devices=["cpu"]))[0].numpy(),
        hist[0, 0][cand[0]])
    with pytest.raises(ValueError):
        co.ring_allreduce_select(parts[:2], c, build_mesh(
            devices=["cpu"] * 3))


def test_ring_block_count_is_one_for_the_whole_mesh():
    """Block b of every rank covers the same slice of each chunk, so a mesh
    whose cards would choose different counts on their own (three shards
    on one card and one on another, or cards with different SM counts)
    launches the fewest blocks that any card asks for or holds."""
    from mmlspark_tpu_torch.ops.cuda_ring import mesh_blocks

    def fused_per_card(sms, n_local, resident_per_sm=4):
        # csrc/ring.cu fused_hist_ring_blocks: the blocks that stay
        # resident, shared by the card's ranks
        return min(4 * sms // n_local, resident_per_sm * sms // n_local)

    counts = [fused_per_card(132, 3), fused_per_card(114, 1)]
    assert counts == [176, 456]
    assert mesh_blocks(counts) == 176
    assert mesh_blocks([75, 75, 75]) == 75
    with pytest.raises(RuntimeError, match="cannot hold one ring block"):
        mesh_blocks([12, 0])


def _fused_case(d, accum, counts, seed, f=11, n_local=700, B=64):
    """Per shard: bins, gh per row, a row permutation, and a segment of
    counts[i] rows.  The reference takes the segment pre-gathered and
    padded to the largest count with zero-weighted rows (as its grower
    pads to a bucket); the port takes exact counts."""
    rng = np.random.default_rng(seed)
    size = max(counts)
    binsT, ghs, idxs, shards = [], [], [], []
    for i in range(d):
        bins = rng.integers(0, B, size=(n_local, f)).astype(np.uint8)
        if accum == "int32":
            gh = rng.integers(-200, 200, size=(n_local, 3)).astype(np.int32)
        else:
            gh = rng.normal(size=(n_local, 3)).astype(np.float32)
        order = rng.permutation(n_local).astype(np.int32)
        off, cnt = 13 * i, counts[i]
        rows = np.zeros(size, np.int32)
        rows[:cnt] = order[off:off + cnt]
        valid = (np.arange(size) < cnt)[:, None]
        binsT.append(bins.T)
        ghs.append((gh[rows] * valid).astype(gh.dtype))
        idxs.append(rows)
        shards.append((torch.from_numpy(bins), torch.from_numpy(gh),
                       torch.from_numpy(order), off, cnt))
    return (np.concatenate(binsT), np.concatenate(ghs),
            np.concatenate(idxs)), shards, size


@pytest.mark.parametrize("accum", ["float32", "int32"])
@pytest.mark.parametrize("d", [2, 4])
def test_fused_twin_matches_reference_kernel(d, accum):
    B = 64
    counts = [400, 1, 260, 0][:d] if d == 4 else [400, 257]
    (binsT, gh, idx), shards, size = _fused_case(d, accum, counts,
                                                 seed=d)
    in_specs = (P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS))
    out = _run_ref(
        lambda b, g, i: ref_fused(b, g, i, B, size, DATA_AXIS, d,
                                  accum=accum, interpret=True),
        d, [binsT.astype(np.int32), gh, idx], in_specs,
        P(DATA_AXIS, None, None))
    f = shards[0][0].shape[1]
    want = out.reshape(d, f, B, 3)[0]
    got = co.fused_segment_hist_ring_plain(shards, B, accum).numpy()
    if accum == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the entry routes CPU shards to the twin and delivers to every shard
    mesh = build_mesh(devices=["cpu"] * d)
    for o in co.fused_segment_hist_ring(shards, B, mesh, accum):
        np.testing.assert_array_equal(o.numpy(), got)


# -- the fused kernel's phase-1 geometry (csrc/ring.cu) ----------------------

@pytest.mark.parametrize("B", [2, 17, 256])
@pytest.mark.parametrize("f", [1, 13, 50, 300, 2000])
@pytest.mark.parametrize("d", [2, 3, 4, 8])
def test_fused_chunk_map_covers_every_element_once(d, f, B):
    """Each ring chunk's elements lie in its feature range, the chunks
    cover the payload once, and the phase-1 sub-groups of ``group``
    features cover each chunk's range once within the shared memory."""
    from mmlspark_tpu_torch.ops import cuda_histogram as ch
    from mmlspark_tpu_torch.ops import cuda_ring as cr
    inner = 3 * B
    total = f * inner
    chunk = cr.ring_chunk(total, d)
    ranges = cr.fused_chunk_features(f, B, chunk, d)
    group = cr.fused_group(f, B, chunk, d)
    assert ch.seg_smem(group, 1, B, cr.FUSED_THREADS // 32) \
        <= ch.SMEM_BUDGET
    assert 1 <= group <= ch.SEG_MAX_GROUP
    seen = np.zeros(total, np.int32)
    for c, (fa, fb) in enumerate(ranges):
        lo, hi = c * chunk, min((c + 1) * chunk, total)
        if lo >= hi:
            assert (fa, fb) == (0, 0)
            continue
        assert fa * inner <= lo and hi <= fb * inner
        assert (fa + 1) * inner > lo and (fb - 1) * inner < hi
        # the chunk's cells of each sub-group, as the kernel flushes them
        subs = np.arange(fa, fb, group)
        for f0 in subs:
            g_lo, g_hi = f0 * inner, min(f0 + group, fb) * inner
            seen[max(lo, g_lo):min(hi, g_hi)] += 1
        assert len(subs) == -(-(fb - fa) // group)
    np.testing.assert_array_equal(seen, np.ones(total, np.int32))


@pytest.mark.parametrize("counts", [[1, 1, 1, 1], [777, 0, 5, 3],
                                    [100_000] * 4, [0, 0], [2048, 1]])
def test_fused_grid_tiles_each_segment(counts):
    from mmlspark_tpu_torch.ops import cuda_ring as cr
    for nb_cap, nb_ring, sub_items in ((132, 19, 4), (132, 38, 2),
                                       (44, 38, 3), (8, 8, 9)):
        tiles, nb = cr.fused_grid(counts, sub_items, nb_cap, nb_ring)
        assert [t == 0 for t in tiles] == [c == 0 for c in counts]
        assert all(t <= max(1, -(-c // cr.FUSED_ROWS_PER_TILE))
                   for t, c in zip(tiles, counts))
        items = max(tiles) * sub_items
        assert items <= max(nb_cap, sub_items)   # one tile at the least
        assert nb == min(nb_cap, max(nb_ring, items))
    # a one-row segment per shard launches the ring blocks alone: its four
    # items go to the last four of them
    assert cr.fused_grid([1] * 4, 4, 132, 19) == ([1] * 4, 19)
    assert cr.fused_grid([100_000] * 4, 4, 66, 19) == ([16] * 4, 64)


# -- the direct kernels' order (csrc/ring.cu, every shard on one card) -------
# The direct kernels add element e from the shard of its chunk, e // chunk,
# on: x_c + x_{c+1} + ..., indices mod D.  These models restate that index
# arithmetic element by element (the select model with the kernel's
# per-row chunk and boundary) and hold it against the plain twins, and
# through them against the reference ring, bit for bit.

#: the flagship payload, a ragged one, a 2-D one, one element, and one
#: whose chunks past the second are empty at D >= 4 (total < (D-1)·chunk)
DIRECT_SHAPES = [(50, 256, 3), (13, 17, 3), (7, 5), (1,), (3, 100)]


def _direct_model(x, chunk):
    """Element e of the direct dense kernel's output for the partials
    ``x[d]``: summed from shard ``e // chunk`` on, in float32."""
    d = x.shape[0]
    flat = x.reshape(d, -1)
    e = np.arange(flat.shape[1])
    c = e // chunk
    acc = flat[c, e].copy()
    for k in range(1, d):
        acc = acc + flat[(c + k) % d, e]
    return acc.reshape(x.shape[1:])


def _direct_select_model(hist, cand, chunk):
    """The direct select kernel's output, row by row as its grid walks the
    slab: row ``row`` reads column ``cand[row]`` of child ``row // k2``;
    its cells before ``jb`` lie in chunk ``c0``, the rest in ``c0 + 1``,
    or further where a chunk is shorter than a row."""
    d = hist.shape[0]
    lead = cand.ndim - 1
    f = hist.shape[1 + lead]
    inner = int(np.prod(hist.shape[2 + lead:]))
    k2 = cand.shape[-1]
    h = hist.reshape(d, -1, inner)          # (d, m·f, inner)
    flat_cand = cand.reshape(-1)
    narrow = chunk if chunk < inner else 0
    out = np.empty((flat_cand.size, inner), np.float32)
    j = np.arange(inner)
    for row, col in enumerate(flat_cand):
        src = (row // k2) * f + int(col)
        dst = row * inner
        c0 = dst // chunk
        jb = (c0 + 1) * chunk - dst
        beyond = (j - jb) // narrow if narrow else 0
        c = np.where(j < jb, c0, c0 + 1 + beyond)
        acc = h[c, src, j].copy()
        for k in range(1, d):
            acc = acc + h[(c + k) % d, src, j]
        out[row] = acc
    return out.reshape(cand.shape + hist.shape[2 + lead:])


@pytest.mark.parametrize("d", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", DIRECT_SHAPES, ids=str)
def test_direct_order_equals_ring_twin_bitwise(d, shape):
    x = _partials(d, shape, seed=d * 1000 + sum(shape))
    chunk = cr.ring_chunk(int(np.prod(shape)), d)
    got = _direct_model(x, chunk)
    want = co.ring_allreduce_plain([torch.from_numpy(p) for p in x])
    np.testing.assert_array_equal(got, want.numpy())
    if d in (2, 4):
        ref = _ref_reduce(lambda a: ref_ring(a, DATA_AXIS, d,
                                             interpret=True), d, x)
        np.testing.assert_array_equal(got, ref)


def test_direct_shapes_cover_empty_chunks():
    """At D = 4 and 8 the one-element and (3, 100) payloads leave chunks
    wholly past the payload; the flagship does not."""
    for shape in ((1,), (3, 100)):
        total = int(np.prod(shape))
        for d in (4, 8):
            assert total < (d - 1) * cr.ring_chunk(total, d)
    assert 38_400 > 7 * cr.ring_chunk(38_400, 8)


#: select cases: the wide configuration's grow-step pair and root slab at
#: a cut f (the chunk still exceeds a row, as at f = 2000), a one-column
#: slab whose chunk (128 at D = 4, 8) is shorter than its row of 768 cells,
#: and the ragged slabs of SELECT_CASES
DIRECT_SELECT_CASES = [((2, 200, 256, 3), (2, 64)), ((200, 256, 3), (64,)),
                       ((5, 256, 3), (1,))] + SELECT_CASES


@pytest.mark.parametrize("d", [2, 3, 4, 8])
@pytest.mark.parametrize("hist_shape,cand_shape", DIRECT_SELECT_CASES,
                         ids=str)
def test_direct_select_order_equals_select_twin_bitwise(d, hist_shape,
                                                        cand_shape):
    hist, cand = _select_case(d, hist_shape, cand_shape,
                              seed=d * 7 + hist_shape[-2])
    out_shape = cand_shape + hist_shape[len(cand_shape):]
    chunk = cr.ring_chunk(int(np.prod(out_shape)), d)
    got = _direct_select_model(hist, cand, chunk)
    want = co.ring_allreduce_select_plain(
        [torch.from_numpy(h) for h in hist], torch.from_numpy(cand))
    assert got.shape == out_shape
    np.testing.assert_array_equal(got, want.numpy())
    if d in (2, 4) and hist.size <= 200_000:
        in_spec = P(*((DATA_AXIS,) + (None,) * (len(hist_shape) - 1)))
        out_spec = P(*((DATA_AXIS,) + (None,) * (len(out_shape) - 1)))
        out = _run_ref(
            lambda h: ref_select(h, jnp.asarray(cand), DATA_AXIS, d,
                                 interpret=True),
            d, [hist.reshape((-1,) + hist_shape[1:])], [in_spec], out_spec)
        np.testing.assert_array_equal(got, out.reshape((d,) + out_shape)[0])


def test_direct_select_cases_cover_both_chunk_widths():
    """The wide pair's chunk exceeds a slab row (at most one boundary a
    row); the one-column slab's chunk is shorter than its row."""
    widths = {}
    for hist_shape, cand_shape in DIRECT_SELECT_CASES[:3]:
        inner = int(np.prod(hist_shape[len(cand_shape):]))
        total = int(np.prod(cand_shape)) * inner
        widths[hist_shape] = [cr.ring_chunk(total, d) >= inner
                              for d in (2, 4, 8)]
    assert widths[(2, 200, 256, 3)] == [True, True, True]
    assert widths[(5, 256, 3)] == [False, False, False]


def test_ring_route_follows_the_mesh_layout():
    """One device for every rank: the direct kernels; ranks on two or more
    devices, evenly or not: the ring."""
    card0, card1 = torch.device("cuda", 0), torch.device("cuda", 1)
    for d in (2, 3, 4, 8):
        assert cr.ring_route([card0] * d) == "direct"
    for devices in ([card0, card1], [card0, card0, card1],
                    [card1, card0, card0, card0],
                    [torch.device("cuda", i) for i in range(4)]):
        assert cr.ring_route(devices) == "ring"
