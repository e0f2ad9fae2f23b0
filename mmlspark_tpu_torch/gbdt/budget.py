"""Fit-time device-memory budget: refuse a fit that cannot fit before it
starts.

The port's counterpart of ``mmlspark_tpu/gbdt/budget.py``.  The
reference counts the arrays of its jitted boost scan; the port runs
eagerly, so :func:`estimate_fit_bytes` counts what the port's own fit
allocates on its busiest device, term by term, named after those
allocations:

* ``codes`` — the binned matrix: the fit's input on its device
  (``engine.train``), on a mesh the row-padded copy and each shard's
  slice (``distributed.prepare_arrays``), under EFB the bundled matrix
  beside the unbundled one it was planned from; under sharded ingestion
  only each shard's slice (``distributed.prepare_arrays_from_shards``:
  no device holds the whole matrix);
* ``binning`` — above 256 bins (int32 codes) the estimator bins on the
  device (``BinMapper.transform``): the transposed float64 copy of X, the
  int64 search result and its NaN mask and select, ``BINNING_CELL_BYTES``
  a cell of the larger of the training and validation matrices;
* ``row_vectors`` — per shard the labels, weights, ``real`` and bag masks
  and the scores (``ShardArrays``), the grower's ``row_order`` (int32)
  and each class's ``row_leaf`` (int64) with its build temporaries and
  the score update;
* ``gradients`` — the objective's (grad, hess) and their temporaries, the
  mask, the ``(n, 3)`` gh stack of the tree being grown, and under
  quantized training the int32 codes, the threefry draws and the
  rounding's temporaries;
* ``lambdarank`` — a ranking fit's padded query tensors and the pairwise
  ``(chunk, G, G)`` arrays of one chunk of queries
  (``ranking.lambda_grad_sorted``), ``LAMBDA_PAIR_BYTES`` a pair;
* ``leaf_histograms`` — each histogram holder's ``(L, f, B, 3)`` store of
  leaf histograms (``grow_tree_sharded``'s ``leaf_hist``) and the working
  histograms of a split step (the smaller child, both children stacked,
  the split scan's prefix sums and gains), ``HIST_WORK`` of them;
* ``reductions`` — on a data axis, the stacked shard histograms a
  cross-shard sum builds;
* ``kernel_workspace`` — the CUDA histogram kernels' merge partials and
  tickets at this fit's largest launches (``ops/cuda_histogram.py``
  ``merge_space``), from their launch geometry on the card;
* ``walks`` — the binned walks over every row (GOSS's score update,
  DART's dropped margins);
* ``validation`` — the validation codes, scores and walk.

Each term errs high: a guard a few percent over beats a fit that runs out
of memory at iteration 40.  ``chip_smoke.py`` holds the estimate against
``torch.cuda.max_memory_allocated()`` of full-width fits on the card.

:func:`device_capacity_bytes` reads the fit device's memory through torch,
after the reference's override ``MMLSPARK_TPU_HBM_BYTES`` (the same
setting means the same to both packages; the tests pin a tiny budget with
it).  :func:`check_fit_budget` logs the estimate and raises
``MemoryError`` with the breakdown when it exceeds the capacity; a CPU fit
without the override has no capacity and only logs, as the reference's
does.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

log = logging.getLogger("mmlspark_tpu_torch.gbdt")

#: working histograms of one split step besides the leaf store (the
#: smaller child, both children and their stack, the split scan's padded
#: prefix sums, its right-side and gain arrays)
HIST_WORK = 24
#: bytes a row of the binned walks (GOSS's score update, DART's dropped
#: margins, the validation walk) keeps in int64 temporaries
WALK_ROW_BYTES = 48
#: device binning above 256 bins, bytes a cell at its peak: the float64
#: transposed copy (8), the int64 search result and its select (16), the
#: NaN mask (1)
BINNING_CELL_BYTES = 25
#: the pairwise arrays of lambda_grad_sorted alive at once, bytes a pair:
#: two bool masks, the float32 pair, gain, discount and delta arrays, and
#: the sigmoid's float64 temporaries (``objectives.fma32``); 74 a pair
#: measured on an H100 (``chip_smoke.py`` ranking_path), rounded up
LAMBDA_PAIR_BYTES = 96


def estimate_fit_bytes(n_rows: int, num_features: int, num_bins: int,
                       num_leaves: int, num_class: int = 1,
                       bin_itemsize: int = 1, data_shards: int = 1,
                       feature_shards: int = 1, shards_on_device: int = 1,
                       histogram_holders: int = 1, bundles: int = 0,
                       quantized: bool = False, walks: bool = False,
                       n_val: int = 0, kernel_workspace: int = 0,
                       query_slots: int = 0, query_pairs: int = 0,
                       sharded_input: bool = False) -> Dict[str, int]:
    """Bytes the port's fit of ``n_rows`` × ``num_features`` holds on its
    busiest device, by term (the module docstring), plus ``"total"``.

    ``data_shards`` × ``feature_shards``: the mesh (1 × 1 serially);
    ``shards_on_device``: how many of its devices are the busiest device
    (a mesh of virtual shards on one card: all of them);
    ``histogram_holders``: leaf-histogram stores on that device (one a
    feature slice, one a data shard under voting); ``bundles``: the EFB
    bundle columns (0 without EFB); ``walks``: GOSS or DART; ``n_val``:
    validation rows; ``kernel_workspace``: the CUDA kernels' merge
    workspace; ``query_slots`` and ``query_pairs``: a ranking fit's padded
    (query, document) slots and the pairs of its largest chunk;
    ``sharded_input``: sharded ingestion, ``n_rows`` the padded layout
    (the data axis times the largest shard), each device holding its
    shard's slice alone."""
    n, f, B, L, K = (n_rows, num_features, num_bins, num_leaves,
                     num_class)
    D, F, k = data_shards, feature_shards, shards_on_device
    S = -(-n // D)
    f_loc = -(-f // F)
    cols = bundles or f_loc
    item = bin_itemsize
    mesh = D * F > 1
    costs: Dict[str, int] = {}
    if sharded_input:
        codes = k * S * cols * item
    else:
        codes = n * f * item
        if bundles:
            codes += n * bundles * item
        if mesh:
            codes += S * D * f * item + k * S * cols * item
    costs["codes"] = codes
    costs["binning"] = (BINNING_CELL_BYTES * max(n, n_val) * f
                        if item == 4 else 0)
    costs["row_vectors"] = k * S * (52 + 16 * K)
    costs["gradients"] = k * S * (24 + 40 * K + (112 if quantized else 0))
    costs["lambdarank"] = (k * query_slots * 20
                           + query_pairs * LAMBDA_PAIR_BYTES)
    hist = f_loc * B * 3 * 4
    costs["leaf_histograms"] = histogram_holders * (L + HIST_WORK) * hist
    costs["reductions"] = 2 * D * hist if D > 1 else 0
    costs["kernel_workspace"] = int(kernel_workspace)
    costs["walks"] = k * S * WALK_ROW_BYTES if walks else 0
    costs["validation"] = (n_val * (f * item + 4 * K + WALK_ROW_BYTES)
                           if n_val else 0)
    costs["total"] = sum(costs.values())
    return costs


def kernel_workspace_bytes(rows: int, features: int, num_bins: int,
                           quantized: bool, device: torch.device) -> int:
    """The CUDA histogram kernels' merge workspace for launches over at
    most ``rows`` rows of ``features`` columns on the card ``device``:
    ``hist_full``'s partials and tickets and the segment kernel's, from
    the launch geometry the wrappers will pick (0 off the card).  Reads
    the card's occupancy and launches nothing."""
    if device.type != "cuda" or rows <= 0 or features <= 0:
        return 0
    from ..ops import cuda_histogram as ch
    accum = "int32" if quantized else "float32"
    total = 0
    if num_bins <= ch.NARROW_BINS:
        g = ch.full_launch_geometry(rows, features, num_bins, accum, device)
        if g.clusters > 1:
            total += 4 * (g.clusters * g.groups * (num_bins + 1) * 3
                          * g.slots + g.groups * ch.FULL_CLUSTER)
        variants = (ch.SEG_NARROW,)
    else:
        variants = (ch.SEG_WIDE, ch.FULL_WIDE)
    for v in variants:
        g = ch.segment_launch_geometry(rows, features, num_bins, accum,
                                       device, v)
        if g.clusters > 1:
            total += 4 * (g.clusters * features * num_bins * 3
                          + g.groups * ch.SEG_CLUSTER)
    return total


def device_capacity_bytes(device: torch.device) -> Optional[int]:
    """The fit device's memory in bytes, or None when unknown (the CPU).
    ``MMLSPARK_TPU_HBM_BYTES`` overrides it on any device, as in the
    reference."""
    env = os.environ.get("MMLSPARK_TPU_HBM_BYTES")
    if env:
        return int(float(env))
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return None


def check_fit_budget(costs: Dict[str, int], device: torch.device,
                     data_shards: int = 1, verbosity: int = 1
                     ) -> Dict[str, int]:
    """Log the estimate ``costs`` (:func:`estimate_fit_bytes`) and raise
    ``MemoryError`` with its breakdown and the remedies when it exceeds
    ``device``'s capacity (:func:`device_capacity_bytes`).  Returns
    ``costs``."""
    cap = device_capacity_bytes(device)
    if verbosity > 0:
        log.info("fit memory budget: %.1f MB on %s estimated%s",
                 costs["total"] / 1e6, device,
                 "" if cap is None else f" of {cap / 1e6:.1f} MB")
    if cap is not None and costs["total"] > cap:
        detail = ", ".join(f"{k}={v / 1e6:.1f}MB"
                           for k, v in costs.items()
                           if k != "total" and v)
        need = int(np.ceil(costs["total"] / cap * data_shards))
        raise MemoryError(
            f"GBDT fit needs ~{costs['total'] / 1e6:.1f} MB on {device} "
            f"({detail}) but only {cap / 1e6:.1f} MB is available. "
            f"Remedies: shard the rows over a larger data mesh (>= {need} "
            f"shards on distinct cards at this scale), lower maxBin "
            f"(one-byte codes up to 255), lower numLeaves. Set "
            f"MMLSPARK_TPU_HBM_BYTES to override the detected capacity.")
    return costs
