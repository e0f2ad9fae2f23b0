"""Quantized-gradient training (``quantizedGrad`` "16" / "8") in the port
against the JAX reference, on the CPU.

The reference is pinned to ``histogram_method="segment"`` (or
``"pallas_ring"``, interpret mode, where the test says so); inputs come
from numpy seeds at small sizes (1,200 rows, 6 features).

* The resolution: ``_resolve_quantized`` equals the reference's (grid,
  wire, ring → psum downgrade) over a table of row counts, shard counts,
  bits and collectives; ``collective_schedule`` equals the reference's on
  quantized configurations.
* The grid: :func:`..grower.quantize_gh` equals the reference's compiled
  ``_quantize_gh`` (codes and scales, bit for bit) at several
  ``max_code``; the wire-width psum and the rings' f32 lanes give the
  exact integer sums.
* Fits, model text byte for byte and ``last_fit_info``'s ``quantized_*``
  keys equal: 16 bits under every learner (serial; data psum at D = 2,
  ring at D = 2, 4; voting ring at D = 4; feature 1 × 2; data+feature
  2 × 2), 8 bits with categorical columns (serial, voting), L2 on
  data+feature and multiclass serially, quantized GOSS,
  ``pallas_ring`` at D = 2 and 4 (the int32 fused kernel's twin; integer
  sums are exact, so the model text is too), and the estimator.  The ring
  → psum downgrade needs ``n · max_code ≥ 2**24`` with an int32 wire,
  which takes more than 10,922 rows: that one fit has 12,000 rows of 2
  features and 1 iteration.
"""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.mesh import build_mesh as ref_build_mesh
from mmlspark_tpu.gbdt import LightGBMClassifier as RefClassifier
from mmlspark_tpu.gbdt import engine as ref_engine
from mmlspark_tpu.gbdt import grower as ref_grower
from mmlspark_tpu_torch import LightGBMClassifier
from mmlspark_tpu_torch.core.mesh import build_mesh
from mmlspark_tpu_torch.gbdt import engine, grower
from mmlspark_tpu_torch.gbdt.engine import TrainParams
from mmlspark_tpu_torch.ops.collectives import (ring_allreduce,
                                                ring_allreduce_plain,
                                                ring_allreduce_select)
from torch_parity import (LEARNERS, data, fit_pair,
                          one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

Q16 = dict(quantized_grad="16", num_iterations=5, num_leaves=7,
           min_data_in_leaf=10)
QKEYS = ("quantized_bits", "quantized_max_code", "quantized_wire",
         "quantized_downgrade", "quantized_scale_bytes_per_tree",
         "collective", "collective_payload_bytes_per_tree",
         "collective_payload_vs_dense")


def _info(info):
    return {k: info.get(k) for k in QKEYS}


@pytest.mark.parametrize("bits", ["16", "8"])
def test_resolve_quantized_equals_reference(bits):
    for n in (50, 100, 127, 1_200, 10_922, 10_923, 400_000, 3_000_000):
        for d in (1, 2, 4):
            mesh = None if d == 1 else ref_build_mesh(
                data=d, feature=1, devices=jax.devices()[:d])
            for collective in ("psum", "ring"):
                want = ref_engine._resolve_quantized(
                    ref_engine.TrainParams(quantized_grad=bits), n, mesh,
                    collective)
                got = engine._resolve_quantized(
                    TrainParams(quantized_grad=bits), n, d, collective)
                assert got == want, (n, d, collective)


@pytest.mark.parametrize("value,want", [("", "off"), ("0", "off"),
                                        ("false", "off"), ("None", "off"),
                                        (" 16 ", "16"), ("8", "8")])
def test_quantized_grad_is_normalised_as_the_reference(value, want):
    assert TrainParams(quantized_grad=value).quantized_grad == want
    assert ref_engine.TrainParams(quantized_grad=value).quantized_grad == want


def test_unknown_quantized_grad_refuses():
    with pytest.raises(ValueError, match="quantizedGrad"):
        TrainParams(quantized_grad="4")


@pytest.mark.parametrize("wire,collective,voting", [
    ("int8", "psum", 0), ("int16", "psum", 0), ("int32", "psum", 0),
    ("int16", "ring", 0), ("int16", "psum", 5), ("int16", "ring", 5)])
def test_collective_schedule_equals_reference(wire, collective, voting):
    common = dict(num_leaves=15, num_bins=64, collective=collective,
                  voting_k=voting, quantized_bits=16, quantized_max_code=9,
                  quantized_wire=wire)
    ref_cfg = ref_grower.GrowerConfig(axis_name="data", data_axis_size=4,
                                      **common)
    port_cfg = grower.GrowerConfig(data_axis_size=4, **common)
    want = ref_grower.collective_schedule(ref_cfg, 40, n_rows_local=300)
    got = grower.collective_schedule(port_cfg, 40, n_rows_local=300)
    assert got == want


@pytest.mark.parametrize("max_code", [32767, 5368, 127, 3])
def test_quantize_gh_equals_the_reference_compiled(max_code):
    """The reference quantizes inside its compiled grower, where XLA turns
    ``max / max_code`` into a product with the inverse; the port computes
    that form, so codes and scales equal the jitted reference's."""
    rng = np.random.default_rng(0)
    n = 50_000
    gh = np.stack([rng.normal(size=n), rng.uniform(0.1, 0.25, n),
                   (rng.random(n) < 0.9)], 1).astype(np.float32)
    gh[:, :2] *= gh[:, 2:]
    cfg = dict(quantized_bits=16, quantized_seed=42,
               quantized_max_code=max_code)
    codes, scale = jax.jit(lambda x: ref_grower._quantize_gh(
        x, ref_grower.GrowerConfig(**cfg)))(gh)
    got, got_scale = grower.quantize_gh([torch.from_numpy(gh)],
                                        grower.GrowerConfig(**cfg))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(codes))
    np.testing.assert_array_equal(got_scale[0].numpy(), np.asarray(scale))
    assert int(got[0][:, :2].abs().max()) <= max_code


def test_quantize_gh_takes_the_max_over_data_shards():
    """On a data mesh every shard quantizes on the grid of the global
    max (the reference's pmax), with the same key."""
    rng = np.random.default_rng(1)
    gh = np.stack([rng.normal(size=800), rng.uniform(0.1, 0.25, 800),
                   np.ones(800)], 1).astype(np.float32)
    cfg = grower.GrowerConfig(quantized_bits=8, quantized_seed=7,
                              quantized_max_code=127, data_axis_size=2)
    parts = [torch.from_numpy(gh[:400]), torch.from_numpy(gh[400:])]
    codes, scales = grower.quantize_gh(parts, cfg)
    assert torch.equal(scales[0], scales[1])
    assert np.abs(gh[:400, 0]).max() != np.abs(gh[400:, 0]).max()
    gmax = np.abs(gh[:, 0]).max()
    assert float(scales[0][0]) == gmax * np.float32(1 / 127)
    assert int(torch.cat(codes)[:, 0].abs().max()) == 127


@pytest.mark.parametrize("wire", ["int8", "int16", "int32"])
def test_wire_psum_is_the_exact_integer_sum(wire):
    rng = np.random.default_rng(2)
    bound = {"int8": 127, "int16": 32767, "int32": 2 ** 30}[wire] // 4
    parts = [torch.from_numpy(rng.integers(-bound, bound, (7, 9, 3))
                              .astype(np.int32)) for _ in range(4)]
    cfg = grower.GrowerConfig(quantized_wire=wire, data_axis_size=4)
    got = grower.wire_psum(parts, cfg)
    assert got.dtype == torch.int32
    assert torch.equal(got, sum(p.long() for p in parts).int())


@pytest.mark.parametrize("d", [2, 4])
def test_rings_carry_integer_slabs_exactly(d):
    """Integer slabs ride the rings' f32 lanes and cast back: below 2**24
    the sums are exact."""
    rng = np.random.default_rng(d)
    mesh = build_mesh(devices=["cpu"] * d)
    parts = [torch.from_numpy(rng.integers(-2 ** 21, 2 ** 21, (2, 11, 5, 3))
                              .astype(np.int32)) for _ in range(d)]
    want = sum(p.long() for p in parts).int()
    for got in [ring_allreduce_plain(parts)] + ring_allreduce(parts, mesh):
        assert got.dtype == torch.int32 and torch.equal(got, want)
    cand = torch.tensor([[3, 0, 7], [10, 1, 2]], dtype=torch.int32)
    sel = ring_allreduce_select(parts, cand, mesh)
    want_sel = torch.stack([want[0][cand[0].long()],
                            want[1][cand[1].long()]])
    assert all(torch.equal(s, want_sel) for s in sel)


@pytest.mark.parametrize("learner", [k for k in LEARNERS
                                     if k != "data_psum_4"])
def test_quantized_forest_equals_reference(learner):
    d, feature, kw = LEARNERS[learner]
    X, y = data("binary")
    ref, port = fit_pair(X, y, "binary", d, feature, **kw, **Q16)
    want = _info(ref_engine.last_fit_info)
    assert port.save_native_model_string() == ref.save_native_model_string()
    assert _info(engine.last_fit_info) == want
    assert want["quantized_wire"] == ("none" if d == 1 else "int16")


@pytest.mark.parametrize("objective,learner,categorical", [
    ("binary", "serial", True), ("binary", "voting_ring_4", True),
    ("regression", "data_feature_2x2", False),
    ("multiclass", "serial", False)])
def test_eight_bit_forest_equals_reference(objective, learner, categorical):
    d, feature, kw = LEARNERS[learner]
    X, y = data(objective, categorical=categorical)
    ref, port = fit_pair(X, y, objective, d, feature,
                         categorical=(4, 5) if categorical else (),
                         **kw, **{**Q16, "quantized_grad": "8"})
    assert port.save_native_model_string() == ref.save_native_model_string()
    assert _info(engine.last_fit_info) == _info(ref_engine.last_fit_info)


@pytest.mark.parametrize("learner", ["serial", "data_ring_4"])
def test_quantized_goss_equals_reference(learner):
    d, feature, kw = LEARNERS[learner]
    X, y = data("binary")
    ref, port = fit_pair(X, y, "binary", d, feature, boosting="goss",
                         **kw, **Q16)
    assert port.save_native_model_string() == ref.save_native_model_string()


@pytest.mark.parametrize("d", [2, 4])
def test_quantized_pallas_ring_equals_reference(d):
    X, y = data("binary")
    ref, port = fit_pair(X, y, "binary", d, method="pallas_ring",
                         collective="ring", **{**Q16, "num_iterations": 3})
    assert port.save_native_model_string() == ref.save_native_model_string()
    assert _info(engine.last_fit_info) == _info(ref_engine.last_fit_info)


def test_ring_downgrades_to_psum_when_codes_overflow_f32_lanes():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(12_000, 2))
    y = (X[:, 0] > 0).astype(np.float64)
    ref, port = fit_pair(X, y, "binary", 4, collective="ring",
                         quantized_grad="16", num_iterations=1, num_leaves=3)
    info = _info(engine.last_fit_info)
    assert info == _info(ref_engine.last_fit_info)
    assert info["quantized_downgrade"] == "quantized_unsupported"
    assert info["collective"] == "psum" and info["quantized_wire"] == "int32"
    assert port.save_native_model_string() == ref.save_native_model_string()


def test_quantized_estimator_equals_reference():
    X, y = data("binary")
    kw = dict(numIterations=5, numLeaves=7, minDataInLeaf=10, verbosity=0,
              quantizedGrad="8")
    table = {"features": X, "label": y}
    want = RefClassifier(histogramMethod="segment", **kw).fit(table)
    got = LightGBMClassifier(device="cpu", histogramMethod="segment",
                             **kw).fit(table)
    assert got.getNativeModel() == want.getNativeModel()
    assert engine.last_fit_info["quantized_max_code"] == "127"
