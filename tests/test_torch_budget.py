"""The port's fit memory budget (``gbdt/budget.py``, called by
``engine.train``), on the CPU.

* ``estimate_fit_bytes`` counts the port's allocations term by term: the
  flagship's codes are its n × f bytes, a mesh adds the padded copy and
  the shards, int32 codes add the device binning, a ranking fit its query
  tensors and pairwise chunk, quantized training its codes; the total is
  the sum.  The fit records its estimate (``engine.last_fit_budget``).
* ``MMLSPARK_TPU_HBM_BYTES`` overrides the capacity on any device (the
  reference's setting, read the same way); without it a CPU fit has no
  capacity and only logs.
* A pinned capacity below the estimate raises ``MemoryError`` with the
  breakdown before the first tree, on a serial and on a D = 2 mesh fit:
  no native histogram, partition or split scan runs and the grower makes
  no host sync; the reference refuses the same fit under the same setting.
"""

import logging

import numpy as np
import pytest
import torch

from mmlspark_tpu.gbdt import LightGBMClassifier as RefClassifier
from mmlspark_tpu_torch import LightGBMClassifier, build_mesh, native
from mmlspark_tpu_torch.gbdt import budget, engine
from mmlspark_tpu_torch.gbdt.grower import grow_tree
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _table(n=2000, f=6):
    rng = np.random.default_rng(8)
    X = rng.normal(size=(n, f))
    return {"features": X, "label": (X[:, 0] > 0).astype(np.float64)}


def test_estimate_counts_the_port_allocations():
    n, f, B, L = 400_000, 50, 256, 31
    serial = budget.estimate_fit_bytes(n, f, B, L)
    assert serial["codes"] == n * f
    assert serial["leaf_histograms"] == (L + budget.HIST_WORK) * f * B * 12
    assert serial["binning"] == serial["reductions"] == 0
    assert serial["total"] == sum(v for k, v in serial.items()
                                  if k != "total")
    mesh = budget.estimate_fit_bytes(n, f, B, L, data_shards=4,
                                     shards_on_device=4)
    assert mesh["codes"] == n * f + n * f + 4 * (n // 4) * f
    assert mesh["row_vectors"] == serial["row_vectors"]
    assert mesh["reductions"] > 0
    wide = budget.estimate_fit_bytes(n, f, 1024, L, bin_itemsize=4)
    assert wide["binning"] == budget.BINNING_CELL_BYTES * n * f
    assert wide["codes"] == 4 * n * f
    quant = budget.estimate_fit_bytes(n, f, B, L, quantized=True)
    assert quant["gradients"] > serial["gradients"]
    rank = budget.estimate_fit_bytes(n, f, B, L, query_slots=10_000,
                                     query_pairs=4_000_000)
    assert rank["lambdarank"] == (10_000 * 20
                                  + 4_000_000 * budget.LAMBDA_PAIR_BYTES)
    assert budget.estimate_fit_bytes(n, f, B, L, n_val=1000)["validation"]


def test_the_fit_records_its_estimate():
    LightGBMClassifier(numIterations=2, device="cpu", verbosity=0).fit(
        _table())
    assert engine.last_fit_budget == budget.estimate_fit_bytes(2000, 6, 256,
                                                               31)


def test_capacity_override_and_cpu(monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_HBM_BYTES", raising=False)
    assert budget.device_capacity_bytes(torch.device("cpu")) is None
    monkeypatch.setenv("MMLSPARK_TPU_HBM_BYTES", "8e9")
    assert budget.device_capacity_bytes(torch.device("cpu")) == 8 * 10**9


def test_a_cpu_fit_only_logs(monkeypatch, caplog):
    monkeypatch.delenv("MMLSPARK_TPU_HBM_BYTES", raising=False)
    with caplog.at_level(logging.INFO, logger="mmlspark_tpu_torch.gbdt"):
        LightGBMClassifier(numIterations=2, device="cpu").fit(_table())
    assert any("fit memory budget" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("shards", [1, 2])
def test_a_pinned_capacity_refuses_the_fit_before_its_first_tree(
        monkeypatch, shards):
    table = _table()
    est = LightGBMClassifier(numIterations=3, device="cpu", verbosity=0)
    if shards > 1:
        est.setMesh(build_mesh(shards, devices=["cpu"] * shards))
    monkeypatch.setenv("MMLSPARK_TPU_HBM_BYTES", "100000")
    counted = ("hist", "seg_hist", "qhist", "seg_qhist", "partition",
               "split")
    before = {k: native.COUNTED[k].calls for k in counted}
    grow_tree.host_syncs = 0
    with pytest.raises(MemoryError, match="leaf_histograms="):
        est.fit(table)
    assert {k: native.COUNTED[k].calls for k in counted} == before
    assert grow_tree.host_syncs == 0
    with pytest.raises(MemoryError):
        RefClassifier(numIterations=3, verbosity=0).fit(table)
    monkeypatch.setenv("MMLSPARK_TPU_HBM_BYTES", "1e12")
    est.fit(table)
    assert grow_tree.host_syncs > 0
