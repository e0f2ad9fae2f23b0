"""Boosting loop — ``boosting`` "gbdt", "goss", "rf" and "dart", serial or
on a mesh, with validation and early stopping, and lambdarank.

The port's counterpart of ``mmlspark_tpu/gbdt/engine.py`` (``train`` →
``_train_impl`` → ``_boost_scan`` / ``_boost_scan_multi`` /
``_boost_scan_goss`` serially, ``_train_distributed`` on a mesh): per
iteration, (grad, hess) from the objective, one tree per class from
:func:`..grower.grow_tree_sharded` (iteration-major, class-minor, the
model file's order), and the score updates.  A serial fit is the
one-device case of the mesh loop (:mod:`.distributed`); the mesh's shape
decides between the data (or voting), feature and data+feature learners.

* **Sampling.**  Bagging and feature-fraction draws use numpy
  ``default_rng`` streams seeded as the reference seeds them, so both
  packages draw the same rows and features: on a mesh the bag draws
  exactly n randoms and scatters them into the padded layout, and feature
  fraction draws over the original f features, the pad features staying
  masked, as the reference does.  GOSS draws with the reference's
  threefry keys, ``split(PRNGKey(bagging_seed), T)``
  (:mod:`..ops.threefry`).
* **rf** (random forest): every tree fits the gradient at the constant
  init scores, unshrunk, on its bag; the export averages the trees
  (:func:`_rf_average_trees`) and validation reads the running average
  (:func:`_rf_margins`).
* **DART** (:func:`_dart_fit`, one host loop for the serial fit and the
  mesh): each iteration drops a random subset of the earlier iterations
  (:func:`_dart_draw_drops`, numpy ``default_rng(drop_seed)``), grows
  its K trees at the dropped-out scores, and renormalises — the new
  iteration joins at 1/(k+1) and the k dropped shrink by k/(k+1); the
  export bakes each iteration's scale into its trees.  The float steps
  are the reference's eager ones, each rounded.
* **Lambdarank** (``ranking_info``): the gradients come from the query
  structure (:class:`.ranking.LambdarankGradient`); serially the rows
  keep their order and the score update rounds the product and the sum
  apart (the reference's host loop), on a mesh each query is packed onto
  one data shard (:func:`.ranking.shard_queries`) and the update is one
  FMA (the reference's compiled scan).
* **Quantized gradients** (``quantized_grad`` "16" / "8"):
  :func:`_resolve_quantized` picks the grid, the wire dtype and the
  ring → psum downgrade as the reference does; the grower quantizes.
* **Exclusive Feature Bundling** (``enable_bundle``, :func:`_build_efb`,
  :func:`_efb_gate`): the reference's gates, as written — serially no
  categorical feature, at most 256 bins and no lambdarank; on a mesh also
  no feature axis, no voting, no GOSS and no DART — and a plan that
  bundles something; else the fit runs unbundled.  The training matrix
  becomes G bundle columns (the validation matrix never does), and the
  grower, GOSS's score walk and DART's dropped-tree margins read it
  through the maps.
* **Init scores** (``init_scores``, LightGBM's per-row init score, and
  the margins of a model continued by ``initModelPath`` /
  :func:`train_incremental`): the scores start at ``init + init_scores``
  in float32 with ``init`` 0 (a per-row offset replaces boost-from-average
  and is not baked into the model); pad rows of a mesh keep the plain
  init.  ``val_init_scores`` offsets the validation scores alike.
* **Memory budget** (:mod:`.budget`): before the binned rows are laid
  out over the devices, the fit's bytes on its busiest device are
  estimated term by term and held against the device's memory; a fit
  that cannot fit raises ``MemoryError`` with the breakdown before its
  first histogram (``last_fit_budget`` records the estimate).
* **Validation.**  The validation scores start at the training scores'
  init and add each iteration's shrunk trees (a binned walk at lr = 1, in
  f32, on the first device); the metric runs on the host, one sync an
  iteration.  A metric below ``best − 1e-12`` is a new best; otherwise
  the fit stops once ``it − best_iter ≥ early_stopping_round`` and keeps
  ``best_iter + 1`` iterations.  As in the reference, an iteration in
  which no class's tree split then cuts the forest after it and records
  it as the stop.
* **Chunks, checkpoints and replay** (the reference's ``_boost_scan``
  chunks): the gbdt / goss / rf loop runs in chunks of iterations
  (:func:`_chunk_size`, the reference's bounds, so both packages save at
  the same boundaries), each one call of :func:`_boost_chunk`.  With
  ``checkpoint_dir`` every boundary is saved (:mod:`.checkpoint`): the
  trees, the scores per data shard, the validation scores, the carried
  bag row, both numpy streams and the early-stopping bests, which is
  every piece of state the loop carries (GOSS's keys are drawn for all
  iterations up front, the quantizer's key folds in each tree's peak
  gradient, the EFB plan rebuilds from the bins and the lambdarank
  gradient source holds only its query structure); a re-run of the same
  fit resumes from the last boundary and writes the same forest.  With
  ``fault_tolerant_retries`` > 0 the scores and validation scores are
  copied to the host before each chunk, and a chunk that raises is
  replayed: every device input is uploaded again from host copies and
  rebound (:meth:`_BoostFit.upload`).  A sticky CUDA error (an illegal
  address, a launch failure) leaves the process's CUDA context unusable,
  so every in-process replay fails alike and the error is re-raised once
  the retries are spent; a checkpoint then resumes the fit in a new
  process.  As in the reference, DART and lambdarank do not checkpoint
  (a warning says so), and DART does not replay.  ``callbacks`` are
  called as ``cb(it, trees)`` after each chunk for its iterations, in
  order.
* **Sharded ingestion** (``train`` given per-shard lists,
  :func:`_train_distributed_sharded`, the reference's function of that
  name): each data shard's rows are laid out on its mesh slice from its
  own matrix (:func:`.distributed.prepare_arrays_from_shards`), padded
  to the largest shard, and never joined into one matrix; a ranking
  fit's queries stay on the shards that hold them
  (:func:`.ranking.shard_queries_from_shards`).  On a **gang of
  controllers** (a mesh over the processes of a ``torch.distributed``
  group, :class:`..core.mesh.Mesh`) each process passes None in the
  slots of the others' shards and ``shard_rows``; labels and weights are
  complete everywhere.  Every process draws the same host streams over
  the global rows and takes its own slice, the grower gathers every
  cross-shard partial in shard order, and so each process grows the
  one-controller fit's trees.  A gang saves one state file per process
  behind two barriers (:mod:`.checkpoint`), and a resume needs every
  process's consent.  The rings, voting, DART and lambdarank do not run
  on a gang (they raise).
* **Telemetry** (:mod:`..core.telemetry`, :mod:`..core.profiler`), where
  the reference has it: :func:`train` wraps each fit in a fit span
  (``fit_begin`` / ``fit_end`` / ``fit_failed`` with a flight record),
  each chunk journals a ``boost_chunk`` event and sets the ``train_loss``
  gauge (:func:`_monitor_chunk`), the profiler brackets the chunk into
  its host and device-wait phases, :data:`train_stats` and two info
  gauges join the process registry, every fit's booster gets a reference
  profile for drift monitoring (:func:`_capture_reference_profile`), and
  debug mode (:mod:`..core.debug`) checks the codes and gradients the
  grower takes.  None of it changes a forest.
"""

from __future__ import annotations

import glob
import logging
import os
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import telemetry as _tm
from ..core.mesh import Mesh, pad_to_multiple
from ..core.profiler import device_wait, get_profiler
from ..device import DeviceLike, resolve_device
from ..ops.collectives import gang_barrier, is_gang, resolve_collective
from ..ops.threefry import prng_key, split
from .binning import BinMapper
from .booster import Booster, host_tree_from_arrays
from .budget import (check_fit_budget, estimate_fit_bytes,
                     kernel_workspace_bytes)
from .checkpoint import (TreeChunk, _ckpt_clear, _ckpt_event,
                         _ckpt_fingerprint, _ckpt_fingerprint_mesh,
                         _ckpt_load, _ckpt_load_mesh, _ckpt_save,
                         _ckpt_save_mesh, _ckpt_unanimous, _host,
                         _local_bins_digest,
                         train_stats)  # noqa: F401 - engine.train_stats
from .distributed import (ShardArrays, ShardedInput, boost_iteration,
                          check_parallelism, dart_grow, goss_iteration,
                          objective_grads, prepare_arrays,
                          prepare_arrays_from_shards, shard_full_bins,
                          sharded_cfg, unit_margin)
from .efb import bundle_matrix, expansion_arrays, find_bundles
from .grower import (GrowerConfig, apply_shrinkage, collective_schedule,
                     predict_tree_binned)
from .objectives import Objective

log = logging.getLogger("mmlspark_tpu_torch.gbdt")

#: What the last fit in this process ran: the histogram method, the
#: collective and why a ring request was downgraded, the devices' type,
#: the quantized grid and wire, and the per-tree collective schedule.
last_fit_info: Dict[str, str] = {}
#: The last fit's memory budget: the estimate of its bytes on its busiest
#: device by term, and the total (:func:`.budget.estimate_fit_bytes`).
last_fit_budget: Dict[str, int] = {}
#: The last fit's validation: the metric of every iteration, the best
#: iteration and metric, the iteration count kept, and the host seconds
#: the validation walks and metrics took (empty without a validation set).
last_validation: Dict[str, object] = {}

#: The last fit's checkpoints: the boundaries saved, the seconds the
#: saves took, the snapshot files' bytes on disk after each save, and the
#: boundary the fit resumed from (None: it started fresh; empty without
#: ``checkpoint_dir``).
last_checkpoint: Dict[str, object] = {}

#: TrainParams fields of the reference that the port's lacks, with their
#: defaults.  A ``pass_through`` key naming one is an engine key in the
#: reference, so the model text does not record it either.  The packed
#: gather layout does not change a forest.
REFERENCE_ONLY_PARAMS = {"packed_gather": False}

# the training counters join the process registry, as the reference's do:
# a process that trains exposes them on /metrics under ns="train"
_tm.get_registry().register("train", train_stats)


def _fit_resolution_exposition() -> str:
    """Prometheus info gauge naming the resolved histogram kernel and
    collective of the last fit in this process (the reference's
    ``train_histogram_method`` exposition)."""
    if not last_fit_info:
        return ""
    labels = ",".join(f'{k}="{v}"' for k, v in sorted(
        last_fit_info.items()))
    name = "mmlspark_tpu_train_histogram_method_info"
    return (f"# HELP {name} Resolved histogram kernel/collective of the "
            "last fit\n"
            f"# TYPE {name} gauge\n"
            f"{name}{{{labels}}} 1\n")


_tm.get_registry().register_exposition("train_histogram_method",
                                       _fit_resolution_exposition)


def _quantized_exposition() -> str:
    """Prometheus info gauge naming the quantized-gradient resolution of
    the last fit: grid bits, max code, wire dtype and downgrade (the
    reference's ``train_quantized`` exposition)."""
    if not last_fit_info:
        return ""
    keys = ("quantized_bits", "quantized_max_code", "quantized_wire",
            "quantized_downgrade")
    labels = ",".join(
        f'{k[len("quantized_"):]}="{last_fit_info[k]}"'
        for k in keys if k in last_fit_info)
    if not labels:
        return ""
    name = "mmlspark_tpu_train_quantized_info"
    return (f"# HELP {name} Quantized-gradient resolution of the last "
            "fit\n"
            f"# TYPE {name} gauge\n"
            f"{name}{{{labels}}} 1\n")


_tm.get_registry().register_exposition("train_quantized",
                                       _quantized_exposition)

#: cap on rows copied to the host per chunk boundary for the train-loss
#: gauge; larger fits are sampled with a stride, sliced on the device
_MONITOR_LOSS_MAX_ROWS = 65536


def _monitor_chunk(it0: int, it1: int, dt_s: float, n_rows: int, K: int,
                   hist_method: str, objective=None, scores=None,
                   labels=None, weights=None,
                   collective: str = "none",
                   coll_sched: Optional[dict] = None) -> None:
    """Per-boost-chunk training telemetry (the reference's function of
    this name): ``ms_per_tree``, ``train_rows_per_s`` and
    ``last_iteration`` gauges and the ``boost_chunks`` counter on
    :data:`train_stats`, the chunk's collectives (``coll_sched`` times its
    trees) in ``collective_count`` / ``collective_payload_bytes``, the
    ``train_loss`` gauge when ``objective`` is given, and one
    ``boost_chunk`` journal event.

    ``scores`` (a tensor, on the card or not) is copied to the host for
    the loss only: beyond ``_MONITOR_LOSS_MAX_ROWS`` rows a strided sample
    is sliced on the device first, so the copy stays bounded.  A failing
    loss leaves the gauge unset; it never fails the fit."""
    iters = max(1, it1 - it0)
    trees = iters * max(1, K)
    ms_per_tree = dt_s * 1e3 / trees
    rows_per_s = n_rows * iters / dt_s if dt_s > 0 else 0.0
    train_stats.set_gauge("ms_per_tree", round(ms_per_tree, 3))
    train_stats.set_gauge("train_rows_per_s", round(rows_per_s, 1))
    train_stats.set_gauge("last_iteration", float(it1))
    train_stats.incr("boost_chunks")
    coll_count = coll_bytes = None
    if coll_sched is not None:
        coll_count = coll_sched["count"] * trees
        coll_bytes = coll_sched["payload_bytes"] * trees
        train_stats.incr("collective_count", coll_count)
        train_stats.incr("collective_payload_bytes", coll_bytes)
    loss = None
    if objective is not None and scores is not None and labels is not None:
        try:
            labels_np = np.asarray(labels)
            stride = max(1, len(labels_np) // _MONITOR_LOSS_MAX_ROWS)
            if stride > 1:
                scores = scores[::stride]       # sliced on the device:
                labels_np = labels_np[::stride]  # the copy stays bounded
                weights = (None if weights is None
                           else np.asarray(weights)[::stride])
            host = (scores.cpu().numpy() if isinstance(scores, torch.Tensor)
                    else np.asarray(scores))
            loss = objective.train_loss(host, labels_np, weights)
        except Exception:  # noqa: BLE001 - telemetry must never kill
            loss = None    # the fit it observes
    if loss is not None:
        train_stats.set_gauge("train_loss", round(float(loss), 6))
    ev = {"fit": _tm.current_fit_span(), "it_start": int(it0),
          "it_end": int(it1), "ms_per_tree": round(ms_per_tree, 3),
          "rows_per_s": round(rows_per_s, 1),
          "hist_method": hist_method, "collective": collective}
    if coll_count is not None:
        ev["collective_count"] = int(coll_count)
        ev["collective_payload_bytes"] = int(coll_bytes)
    if loss is not None:
        ev["train_loss"] = round(float(loss), 6)
    _tm.get_journal().emit("boost_chunk", **ev)


#: set to "0" to skip the fit-time reference-profile capture (e.g. a run
#: that fits many throwaway models)
REF_PROFILE_ENV = "MMLSPARK_TPU_REF_PROFILE"

#: rows fed to the margin sketch's representative-predict pass; the
#: per-feature sketches always count the full binned matrix
_REF_PROFILE_MARGIN_ROWS = 32768

#: the last reference-profile capture: its seconds, split into the codes'
#: copy and sample (``codes_s``), the margins' predict (``predict_s``) and
#: the sketches (``sketch_s``), and the rows predicted
last_ref_profile: Dict[str, float] = {}


def _coerce(key: str, value, like):
    """``value`` (a pass-through string) as the type of ``like``, as the
    reference's ``TrainParams.__post_init__`` coerces it."""
    s = str(value).strip()
    try:
        if isinstance(like, bool):
            low = s.lower()
            if low in ("1", "true", "yes", "on"):
                return True
            if low in ("0", "false", "no", "off"):
                return False
            raise ValueError(f"not a boolean: {s!r}")
        if isinstance(like, int):
            return int(s)
        if isinstance(like, float):
            return float(s)
        return s
    except ValueError as e:
        raise ValueError(
            f"passThroughArgs {key}={value!r} cannot be coerced to "
            f"{type(like).__name__}: {e}") from None


@dataclass
class TrainParams:
    """Engine-level hyper-parameters (the reference's subset for gbdt)."""
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_depth: int = -1
    max_bin: int = 255
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    feature_fraction: float = 1.0
    #: stop once the validation metric has not improved for this many
    #: iterations (0: never; the metric is still tracked)
    early_stopping_round: int = 0
    boost_from_average: bool = True
    seed: int = 42
    bagging_seed: int = 3
    #: "gbdt", "goss" (gradient-based one-side sampling: the top_rate
    #: rows of largest |g·h| and an other_rate sample of the rest,
    #: amplified by (1 − top_rate) / other_rate), "dart" (dropout
    #: boosting) or "rf" (random forest: bagged unshrunk trees, averaged)
    boosting: str = "gbdt"
    top_rate: float = 0.2
    other_rate: float = 0.1
    #: DART knobs (LightGBM names and defaults): the chance an earlier
    #: iteration drops, the most dropped an iteration (<= 0: no limit),
    #: the chance an iteration drops none, and the drops' seed
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    drop_seed: int = 4
    histogram_method: str = "auto"
    parallelism: str = "data"
    collective: str = "auto"
    #: PV-Tree voting: features each shard votes per split (LightGBM
    #: top_k); read only when ``parallelism == "voting"``
    top_k: int = 20
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    #: quantized-gradient training: "off", or "16" / "8" bits ("", "0",
    #: "false" and "none" mean "off")
    quantized_grad: str = "off"
    #: Exclusive Feature Bundling (LightGBM enable_bundle): merge
    #: mutually exclusive sparse features into bundle columns, behind the
    #: reference's gates (:func:`_efb_gate`); trees and the model name
    #: the original features.  ``max_conflict_rate``: the share of the
    #: bundling sample's rows allowed to break exclusivity in a bundle
    enable_bundle: bool = False
    max_conflict_rate: float = 0.0
    verbosity: int = 1
    #: chunk-level failure recovery: > 0 copies the scores to the host
    #: before each chunk and replays a chunk that raises up to this many
    #: times, every device input uploaded again (:func:`train`)
    fault_tolerant_retries: int = 0
    #: a directory where every chunk boundary is saved; a killed fit
    #: re-run with the same inputs and params resumes from the last
    #: boundary and writes the same forest.  The snapshot is
    #: fingerprinted (shapes, params, data, topology), discarded with a
    #: warning on a mismatch, and deleted when the fit completes
    #: (:mod:`.checkpoint`).  Inert, with a warning, for DART and
    #: lambdarank
    checkpoint_dir: str = ""
    #: the most iterations between two boundaries when checkpointing;
    #: chunking never changes the forest, and the fingerprint leaves it out
    checkpoint_chunk: int = 32
    #: raw pass-through params (``passThroughArgs``), recorded in the model
    #: text.  A key naming a field is applied onto it (coerced from its
    #: string) after the constructor, as in the reference, and is not
    #: recorded; :data:`REFERENCE_ONLY_PARAMS` are engine keys too
    pass_through: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        for k, v in self.pass_through.items():
            if k == "pass_through":
                continue
            if k in REFERENCE_ONLY_PARAMS:
                _coerce(k, v, REFERENCE_ONLY_PARAMS[k])
                continue
            if hasattr(self, k):
                setattr(self, k, _coerce(k, v, getattr(self, k)))
        qg = str(self.quantized_grad).strip().lower()
        self.quantized_grad = {"": "off", "0": "off", "false": "off",
                               "none": "off"}.get(qg, qg)
        if self.quantized_grad not in ("off", "8", "16"):
            raise ValueError(
                f"quantizedGrad={self.quantized_grad!r} is not supported; "
                "valid: off, 16, 8")


#: why a gang of controllers refuses the ring collectives
_GANG_RING = (
    "collective='ring' and histogramMethod='pallas_ring' reduce within one "
    "process: the port's ring kernels do not cross processes (ROADMAP.md, "
    "Queue B items 3-5); a gang of controllers takes collective='psum' "
    "or 'auto'")


def _resolve_collective_cfg(params: TrainParams, mesh: Optional[Mesh],
                            ranking: bool = False):
    """``params.collective`` → ``(collective, downgrade reason)``.  ``auto``
    and ``psum`` are the shard-order sum; ``ring`` needs more than one data
    shard (else reason ``single_data_shard``), a mesh without a feature
    axis (else ``feature_axis``), and a fit that is not lambdarank (else
    ``ranking``) or DART (else ``dart``), and otherwise keeps psum, as the
    reference does.  Voting rides the ring on a data-only mesh.  There is
    no compile-probe downgrade: on the card a ring kernel that does not
    build or launch raises.  On a gang of controllers ``ring`` and
    ``histogram_method="pallas_ring"`` raise ``NotImplementedError``: the
    port's rings reduce within one process."""
    if is_gang(mesh) and (params.collective == "ring"
                          or params.histogram_method == "pallas_ring"):
        raise NotImplementedError(_GANG_RING)
    shards = 1 if mesh is None else mesh.data
    collective = resolve_collective(params.collective, shards)
    if params.collective != "ring":
        return collective, "none"
    reason = ("single_data_shard" if collective == "psum"
              else "feature_axis" if mesh.feature > 1
              else "ranking" if ranking
              else "dart" if params.boosting == "dart" else "none")
    if reason != "none":
        log.info("collective='ring' needs a multi-shard data-parallel or "
                 "voting fit; this fit keeps psum (%s)", reason)
        return "psum", reason
    return collective, "none"


def _resolve_quantized(params: TrainParams, n: int, data_shards: int,
                       collective: str, ranking: bool = False):
    """``params.quantized_grad`` → ``(bits, max_code, wire, collective,
    downgrade)``, as the reference's ``_resolve_quantized``.  DART and
    lambdarank keep f32 gradients (downgrade ``quantized_unsupported``).

    ``max_code`` is ``2^(bits-1) - 1`` clamped so that ``n · max_code``
    (the largest |int32| cell: every row in one bin) fits int32.  The wire
    is the narrowest integer the same bound fits: int8, int16, or int16
    with the grid clamped to ``32767 // n`` when that keeps at least 3
    levels, else int32; a serial fit has none.  A ring whose f32 lanes
    cannot carry the codes exactly (``n · max_code ≥ 2^24``) falls back
    to psum, with downgrade ``quantized_unsupported``."""
    if params.quantized_grad == "off":
        return 0, 0, "none", collective, "none"
    if ranking or params.boosting == "dart":
        log.info("quantizedGrad=%s needs a gbdt/goss/rf fit (dart's host "
                 "loop and lambdarank keep f32 gradients); quantization is "
                 "off for this fit (quantized_unsupported)",
                 params.quantized_grad)
        return 0, 0, "none", collective, "quantized_unsupported"
    bits = int(params.quantized_grad)
    mc = min((1 << (bits - 1)) - 1, (2 ** 31 - 1) // max(n, 1))
    if data_shards <= 1:
        return bits, mc, "none", collective, "none"
    if n * mc <= 127:
        wire = "int8"
    elif n * mc <= 32767:
        wire = "int16"
    elif 32767 // max(n, 1) >= 3:
        mc = 32767 // n
        wire = "int16"
    else:
        wire = "int32"
    if collective == "ring" and n * mc >= (1 << 24):
        log.info("collective='ring' carries histograms in f32 lanes; "
                 "quantized codes up to n*max_code=%d cannot ride it "
                 "exactly; this fit keeps psum (quantized_unsupported)",
                 n * mc)
        return bits, mc, wire, "psum", "quantized_unsupported"
    return bits, mc, wire, collective, "none"


def _record_fit_resolution(cfg: GrowerConfig, collective: str,
                           downgrade: str, sched: dict, backend: str,
                           quantized_downgrade: str = "none") -> None:
    last_fit_info.clear()
    last_fit_info.update(
        histogram_method=cfg.hist_method, collective=collective,
        collective_downgrade=downgrade, backend=backend,
        quantized_bits=str(cfg.quantized_bits),
        quantized_max_code=str(cfg.quantized_max_code),
        quantized_wire=cfg.quantized_wire,
        quantized_downgrade=quantized_downgrade,
        data_shards=str(cfg.data_axis_size),
        feature_shards=str(cfg.feature_axis_size),
        voting_k=str(cfg.voting_k),
        collective_count_per_tree=str(sched["count"]),
        collective_payload_bytes_per_tree=str(sched["payload_bytes"]),
        collective_payload_vs_dense=(
            f"{sched['payload_bytes'] / max(1, sched['dense_payload_bytes']):.6f}"))
    if sched["quantized_scale_bytes"]:
        last_fit_info["quantized_scale_bytes_per_tree"] = str(
            sched["quantized_scale_bytes"])


def _fit_budget(cfg: GrowerConfig, params: TrainParams, n: int,
                itemsize: int, f: int, K: int, devices, bundles: int,
                n_val: int, qids: Optional[np.ndarray],
                shard_rows: int = 0) -> dict:
    """:func:`.budget.estimate_fit_bytes` of this fit on its busiest
    device: ``n`` rows of ``itemsize``-byte (bundled) codes, ``devices``
    this process's devices of the mesh (one device serially), ``qids``
    a ranking fit's query ids.  Under sharded ingestion ``shard_rows`` is
    the padded shard (the reference's second budget call, ``n_local =
    max(sizes)``): no device holds more than its shards' rows."""
    D, F = cfg.data_axis_size, cfg.feature_axis_size
    devs = [torch.device(d) for d in devices]
    H = len(devs) if cfg.voting_k > 0 and D > 1 else F
    S = shard_rows or -(-n // D)
    cols = bundles or -(-f // F)
    slots = pairs = 0
    if qids is not None:
        from .ranking import CHUNK_PAIRS
        docs = np.unique(qids, return_counts=True)[1]
        G = int(docs.max())
        chunk = max(1, min(len(docs), CHUNK_PAIRS // (G * G)))
        slots, pairs = (-(-len(docs) // chunk) * chunk * G, chunk * G * G)
    return estimate_fit_bytes(
        S * D if shard_rows else n, f, cfg.num_bins, cfg.num_leaves, K,
        itemsize, D, F, max(Counter(devs).values()),
        max(Counter(devs[:H]).values()), bundles, cfg.quantized_bits > 0,
        params.boosting in ("goss", "dart"), n_val,
        kernel_workspace_bytes(S, cols, cfg.num_bins, cfg.quantized_bits > 0,
                               devs[0]), slots, pairs,
        sharded_input=bool(shard_rows))


def _efb_gate(params: TrainParams, mapper: BinMapper, ranking: bool,
              mesh: Optional[Mesh], n: int, sharded: bool = False) -> str:
    """Why EFB stays off for this fit of ``n`` rows ("off" when not
    asked), or "none" when it may bundle: the reference's serial gate (no
    categorical feature, at most 256 bins, no lambdarank) and, on a mesh,
    its mesh gate as well (no feature axis, no voting, no GOSS that
    samples — a GOSS sample covering a whole shard trains as gbdt and
    bundles; a mesh DART fit runs the reference's dart scan, which never
    bundles).  Sharded ingestion (``sharded``) never bundles, as in the
    reference: a plan needs the whole matrix on one host."""
    if not params.enable_bundle:
        return "off"
    if sharded:
        if params.verbosity > 0:
            log.info("enableBundle: sharded ingestion runs unbundled, as "
                     "the reference's does (sharded)")
        return "sharded"
    reason = ("categorical" if mapper.has_categorical
              else "wide_bins" if mapper.num_total_bins > 256
              else "ranking" if ranking else "none")
    if reason == "none" and mesh is not None:
        reason = ("feature_axis" if mesh.feature > 1
                  else "voting" if params.parallelism == "voting"
                  else "goss" if params.boosting == "goss"
                  and not _goss_covers(params, pad_to_multiple(
                      n, mesh.data) // mesh.data)
                  else "dart" if params.boosting == "dart" else "none")
    if reason != "none" and params.verbosity > 0:
        log.info("enableBundle: this fit runs unbundled (%s), as the "
                 "reference's gate does", reason)
    return reason


def _build_efb(bins: np.ndarray, mapper: BinMapper, params: TrainParams,
               f: int):
    """The reference's ``_build_efb``: plan bundles over the host binned
    matrix (``efb.find_bundles``, the conflict budget
    ``max_conflict_rate``, bundles as wide as the mapper's bins, sampled
    with ``params.seed``), then the expansion maps and the bundled
    matrix.  Returns ``(maps, bundled)``, or ``(None, None)`` when no
    bundle holds two features."""
    nb_list = [mapper.feature_num_bins(j) for j in range(f)]
    spec = find_bundles(bins, nb_list, mapper.missing_bin,
                        params.max_conflict_rate,
                        max_bundle_bins=mapper.num_total_bins,
                        seed=params.seed)
    if spec.is_trivial:
        return None, None
    maps = expansion_arrays(spec, mapper.num_total_bins, mapper.missing_bin)
    bundled = bundle_matrix(bins, spec, mapper.missing_bin)
    if params.verbosity > 0:
        log.info("EFB: %d features -> %d bundle columns", f,
                 spec.num_bundles)
    return maps, bundled


def _feat_info_from_mapper(mapper: BinMapper, f: int) -> np.ndarray:
    """``(f, 3)`` [mask, is_cat, n_value_bins] from the fitted mapper."""
    fi = np.zeros((f, 3), np.float32)
    fi[:, 0] = 1.0
    if mapper.has_categorical:
        fi[:, 1] = mapper.categorical.astype(np.float32)
        fi[:, 2] = [mapper.feature_num_bins(j) for j in range(f)]
    return fi


def _draw_feature_fraction(rng, fi_base: np.ndarray, f: int,
                           feature_fraction: float) -> np.ndarray:
    """One per-iteration featureFraction mask draw (the reference's draw)."""
    k_keep = max(1, int(np.ceil(f * feature_fraction)))
    sel = rng.choice(f, size=k_keep, replace=False)
    fi_it = fi_base.copy()
    fi_it[:, 0] = 0.0
    fi_it[sel, 0] = 1.0
    return fi_it


def _goss_k(params: TrainParams, rows: int):
    """GOSS's top and other sample sizes over ``rows`` rows."""
    return (max(1, int(np.ceil(rows * params.top_rate))),
            max(1, int(np.ceil(rows * params.other_rate))))


def _goss_covers(params: TrainParams, rows: int) -> bool:
    """Whether GOSS's sample covers all ``rows`` rows (the fit is gbdt)."""
    return sum(_goss_k(params, rows)) >= rows


def _goss_sizes(params: TrainParams, rows: int):
    """GOSS's checks and its sample over ``rows`` rows (a shard's on a
    mesh): ``(k1, k2, amp)``, or None when the sample covers every row
    (the fit falls back to gbdt)."""
    if params.bagging_freq > 0 and params.bagging_fraction < 1.0:
        raise ValueError("Cannot use bagging in GOSS (as in LightGBM); "
                         "unset baggingFraction/baggingFreq or use "
                         "boostingType='gbdt'")
    if not (0.0 < params.top_rate < 1.0 and 0.0 < params.other_rate < 1.0) \
            or params.top_rate + params.other_rate >= 1.0:
        raise ValueError("GOSS needs 0 < topRate < 1, 0 < otherRate < 1 "
                         "and topRate + otherRate < 1, got "
                         f"{params.top_rate}/{params.other_rate}")
    k1, k2 = _goss_k(params, rows)
    if _goss_covers(params, rows):
        if params.verbosity > 0:
            log.info("GOSS sample covers every row (%d a shard); training "
                     "falls back to plain gbdt", rows)
        return None
    return k1, k2, (1.0 - params.top_rate) / params.other_rate


def _truncate(trees: list, grew: List[bool], K: int, stop_iter: int,
              verbosity: int):
    """The reference's cut: the first ``stop_iter`` iterations, then
    through the first iteration in which no class's tree split, which
    becomes the recorded stop (LightGBM keeps that iteration's stumps)."""
    trees = trees[:stop_iter * K]
    grew = grew[:stop_iter]
    if all(grew):
        return trees, stop_iter
    first = grew.index(False)
    if verbosity > 0:
        log.info("No further splits with positive gain; stopping at "
                 "iteration %d", first)
    return trees[:(first + 1) * K], min(stop_iter, first)


def _rf_margins(init: float, val_row: np.ndarray, tree_idx: int):
    """rf margins after tree ``tree_idx``: init plus the running average
    of the unshrunk trees' outputs (the scores started at init)."""
    return init + (val_row - init) / (tree_idx + 1)


def _rf_average_trees(trees: list, K: int) -> None:
    """Bake rf's 1/T averaging weight into the exported trees."""
    if not trees:
        return
    avg = 1.0 / (len(trees) // K)
    for t in trees:
        t.leaf_value = t.leaf_value * avg
        t.internal_value = t.internal_value * avg
        t.shrinkage = avg


def _dart_draw_drops(dart_rng, n_units: int, params: TrainParams
                     ) -> np.ndarray:
    """One iteration's DART drops, drawing the reference's stream in its
    order: ``random()`` (skip?), ``random(n_units)`` (each unit drops at
    ``drop_rate``), then at most ``max_drop`` of them by ``choice``."""
    if n_units and dart_rng.random() >= params.skip_drop:
        sel = np.nonzero(dart_rng.random(n_units) < params.drop_rate)[0]
        if params.max_drop > 0 and len(sel) > params.max_drop:
            sel = dart_rng.choice(sel, size=params.max_drop, replace=False)
        return sel
    return np.zeros(0, np.int64)


def _dart_fit(arrays, grads_at, cfg: GrowerConfig, params: TrainParams,
              mesh: Optional[Mesh], K: int, bag_draw, fi_draw,
              callbacks: Sequence[Callable] = (), to_host=None):
    """The DART host loop (the reference's ``_dart_host_loop``, shared by
    the serial fit and the mesh): per iteration the drops, the dropped
    units' scaled margins subtracted from every device's scores, K trees
    grown at those scores (``grads_at(scores per device, bag)``) and
    shrunk, then the 1/(k+1) normalisation and the dropped units'
    rescale.  Each step rounds as the reference's eager ``jnp`` does.
    After each iteration every callback is called as ``cb(it, trees)``
    with the host trees so far (``to_host`` converts one), before DART's
    rescale.  Returns the iteration-major trees, one scale per iteration,
    whether each iteration split, and every device's final training
    scores."""
    F = arrays.feature
    full_bins = shard_full_bins(arrays)
    scores = list(arrays.scores)
    dart_rng = np.random.default_rng(params.drop_seed)
    units, scales, grew, host = [], [], [], []

    def margin(i):
        return unit_margin(units[i], full_bins, cfg.num_leaves, F,
                           arrays.efb, cfg.num_bins)

    for it in range(params.num_iterations):
        bag = bag_draw(it)
        fi = fi_draw(it)
        sel = _dart_draw_drops(dart_rng, len(units), params)
        k = len(sel)
        s_minus = scores
        if k:
            P = [scales[sel[0]] * m for m in margin(sel[0])]
            for i in sel[1:]:
                P = [p + scales[i] * m for p, m in zip(P, margin(i))]
            s_minus = [s - p for s, p in zip(scores, P)]
        unit, b_new = dart_grow(arrays, grads_at(s_minus, bag), fi, cfg,
                                params.learning_rate, mesh, K)
        norm = 1.0 / (k + 1)
        scores = [s + norm * b for s, b in zip(s_minus, b_new)]
        if k:
            scores = [s + (k * norm) * p for s, p in zip(scores, P)]
            for i in sel:
                scales[i] *= k * norm
        units.append(unit)
        scales.append(norm)
        grew.append(any(int(t.num_leaves) > 1 for t in unit[0]))
        if callbacks:
            host += [to_host(t) for t in unit[0]]
            for cb in callbacks:
                cb(it, host)
    return [t for u in units for t in u[0]], scales, grew, scores


def _chunk_size(params: TrainParams, T: int, has_val: bool,
                callbacks: bool, use_bag: bool, use_mesh: bool,
                ckpt: str) -> int:
    """Iterations a chunk of the boosting loop runs: the reference's
    bounds, in its order for the path (``_train_impl``'s serial scan,
    ``_train_distributed`` on a mesh), so both packages save at the same
    boundaries.  A validation set bounds the chunk to ``max(min(esr, 64),
    8)`` under early stopping, else 64; callbacks to 8 (serially only
    without a validation set); bagging to 64; retries to 32; then
    ``checkpoint_chunk`` when checkpointing."""
    esr = params.early_stopping_round
    val_chunk = max(min(esr, 64), 8) if esr > 0 else 64
    if use_mesh:
        chunk = min(T, 64) if use_bag else T
        if has_val:
            chunk = min(chunk, val_chunk)
        if callbacks:
            chunk = min(chunk, 8)
    else:
        chunk = (min(T, val_chunk) if has_val
                 else min(T, 8) if callbacks else T)
        if use_bag:
            chunk = min(chunk, 64)
    if params.fault_tolerant_retries > 0:
        chunk = min(chunk, 32)
    if ckpt:
        chunk = min(chunk, max(1, params.checkpoint_chunk))
    return max(chunk, 1)


def _draw_bag_row(bag_rng: np.random.Generator, n: int,
                  fraction: float) -> np.ndarray:
    """One bag over the source rows: exactly ``n`` randoms, so that the
    stream is a serial fit's on every mesh."""
    return (bag_rng.random(n) < fraction).astype(np.float32)


def _bag_on_devices(arrays: ShardArrays, row: np.ndarray,
                    devices) -> list:
    """A host bag row laid into the padded layout (pad rows 0), one slice
    on each device."""
    return arrays.split(arrays.scatter(row), devices)


class _BoostFit:
    """A gbdt / goss / rf fit's boosting loop: its settings and host
    inputs, and what it holds on the devices, which :meth:`upload` puts
    there and each chunk (:func:`_boost_chunk`) reads and advances:
    ``arrays`` (:class:`.distributed.ShardArrays`: bins, labels, weights,
    ``real``, scores and the EFB maps), ``ones`` (the bag without
    bagging), ``goss_keys`` and ``full_bins`` (GOSS), ``val_bins`` and
    ``val_scores`` (on the first device), and ``grad_src`` (lambdarank).
    """

    def __init__(self, **settings):
        self.__dict__.update(settings)
        self.arrays = self.ones = self.goss_keys = self.full_bins = None
        self.val_bins = self.val_scores = self.grad_src = None

    def upload(self, bins, val_bins=None) -> None:
        """Lay every device input out from ``bins`` and ``val_bins``
        (device tensors, or the host copies a replay re-uploads; ``bins``
        a :class:`.distributed.ShardedInput` under sharded ingestion),
        with the scores and validation scores at their start.  Anything
        that held the old buffers (the mesh's ring workspaces included)
        is rebound to the new ones."""
        if self.mesh is not None:
            self.mesh.scratch.clear()
        if isinstance(bins, ShardedInput):
            self.arrays = prepare_arrays_from_shards(
                bins.bins, bins.labels, bins.weights, self.mesh, self.init,
                self.K, bins.sizes, bins.init_scores, self.perm,
                self.offsets)
        else:
            self.arrays = prepare_arrays(
                bins.to(self.dev), self.labels, self.w, self.devices,
                self.init, self.F, self.K, self.perm, self.efb_maps,
                self.init_scores)
        self.ones = [torch.ones(self.arrays.rows_per_shard,
                                dtype=torch.float32, device=d)
                     for d in self.devices]
        if self.goss is not None:
            self.goss_keys = split(prng_key(self.params.bagging_seed,
                                            self.dev), self.T)
            self.full_bins = shard_full_bins(self.arrays)
        if self.has_val:
            self.val_bins = val_bins.to(self.dev)
            self.val_scores = torch.tensor(self.vs0, device=self.dev)
        if self.ranking is not None:
            self.grad_src = self.ranking()

    def restore(self, scores: Sequence[np.ndarray],
                val_scores: Optional[np.ndarray]) -> None:
        """Set every device's scores (and the validation scores) from host
        copies, each copied onto its device."""
        if any(tuple(s.shape) != tuple(t.shape)
               for s, t in zip(scores, self.arrays.scores)):
            raise ValueError("restored scores do not match the fit's layout")
        self.arrays.scores = [torch.tensor(s, device=d)
                              for s, d in zip(scores, self.devices)]
        if self.has_val:
            self.val_scores = torch.tensor(val_scores, device=self.dev)

    def host_state(self):
        """Host copies of every device's scores and of the validation
        scores: a chunk's replay snapshot."""
        return ([_host(s) for s in self.arrays.scores],
                _host(self.val_scores) if self.has_val else None)

    def synchronize(self) -> None:
        """Wait for every card of the fit, so that a failure of this
        chunk's work surfaces while the chunk can still be replayed."""
        for d in set(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def drop_device_arrays(self) -> None:
        """Forget every device buffer, as a device loss does (the chaos
        injector's hook): a chunk that runs without :meth:`upload` first
        fails."""
        self.arrays = self.ones = self.goss_keys = self.full_bins = None
        self.val_bins = self.val_scores = self.grad_src = None
        if self.mesh is not None:
            self.mesh.scratch.clear()


@dataclass
class _ChunkOut:
    """One chunk's result: its host trees (iteration-major), whether each
    iteration split, the validation metric of each iteration, the
    early-stopping bests after it, the validation seconds, the stop
    iteration when early stopping fired (the trees kept), and whether an
    iteration without a split ended the fit."""
    trees: list
    grew: List[bool]
    metrics: List[float]
    best: tuple
    val_seconds: float = 0.0
    stop_iter: Optional[int] = None
    no_growth: bool = False


def _boost_chunk(fit: _BoostFit, it0: int, bag_rows, fis, best
                 ) -> _ChunkOut:
    """Iterations ``it0 … it0 + len(fis) − 1`` of a gbdt / goss / rf fit
    (the reference's ``_boost_scan`` / ``run_chunk``): per iteration the
    bag (``bag_rows[j]``, a host row over the source rows, None without
    bagging), the feature-fraction draw ``fis[j]``, one tree per class
    grown and the scores updated, then the validation walk and metric
    against the early-stopping bests ``best`` = ``(metric, iteration)``.
    It reads only ``fit``'s device state and these host inputs, so a
    replay from the same inputs and restored scores repeats it."""
    p, K = fit.params, fit.K
    best_metric, best_iter = best
    out = _ChunkOut([], [], [], best)
    bag, prev = fit.ones, None
    for j, fi in enumerate(fis):
        it = it0 + j
        row = None if bag_rows is None else bag_rows[j]
        if row is not None and row is not prev:
            bag = _bag_on_devices(fit.arrays, row, fit.devices)
            prev = row
        grads = None if fit.grad_src is None else fit.grad_src(fit.arrays,
                                                               bag)
        if fit.goss is None:
            grown = boost_iteration(
                fit.arrays, bag, fi, fit.objective, fit.cfg,
                p.learning_rate, fit.mesh, fit.use_rf, grads, fit.fused)
        else:
            grown = goss_iteration(
                fit.arrays, fit.goss_keys[it], fi, fit.objective, fit.cfg,
                p.learning_rate, fit.mesh, *fit.goss, fit.full_bins, grads,
                fit.fused)
        # rf keeps its trees unshrunk: the export averages them
        done = grown if fit.use_rf else [
            apply_shrinkage(t, p.learning_rate) for t in grown]
        out.trees += [host_tree_from_arrays(t, fit.mapper) for t in done]
        out.grew.append(any(int(t.num_leaves) > 1 for t in grown))
        if fit.has_val:
            t0 = time.perf_counter()
            # the trees are shrunk already: the walk adds them at lr = 1
            for c, t in enumerate(done):
                add = predict_tree_binned(t, fit.val_bins, p.num_leaves)
                if K == 1:
                    fit.val_scores = fit.val_scores + add
                else:
                    fit.val_scores[:, c] += add
            margins = fit.val_scores.cpu().numpy()
            if fit.use_rf:
                margins = _rf_margins(fit.init, margins, it)
            metric = float(fit.val_metric(margins, fit.val_labels,
                                          fit.val_weights))
            out.metrics.append(metric)
            out.val_seconds += time.perf_counter() - t0
            if metric < best_metric - 1e-12:
                best_metric, best_iter = metric, it
            elif p.early_stopping_round > 0 \
                    and it - best_iter >= p.early_stopping_round:
                if p.verbosity > 0:
                    log.info("Early stopping at iteration %d (best %d, "
                             "metric %.6f)", it, best_iter, best_metric)
                out.stop_iter = best_iter + 1
                break
        elif not out.grew[-1]:
            # no validation to stop on: the first iteration in which no
            # class's tree can split ends the fit (_truncate records it)
            out.no_growth = True
            break
    out.best = (best_metric, best_iter)
    return out


def _observe_chunk(fit: _BoostFit, prof, it: int, C: int, t_chunk: float,
                   seq0: int, host_loop: bool, ranking: bool,
                   use_mesh: bool, n: int, coll_sched: dict) -> None:
    """A chunk's telemetry, where the reference's loops put it.  The host
    loop (the serial ranker, a custom gradient: one iteration a chunk)
    records ``train.host_iter`` and journals the iteration with no loss.
    The gbdt / goss / rf chunk, without replay, is one bracketed dispatch
    ``train.boost_chunk`` when the profiler is on: the host's time until
    :func:`_boost_chunk` returned, then one wait for the card
    (:func:`..core.profiler.device_wait`), with its ``profile_span``
    journal event; then :func:`_monitor_chunk`, with the training loss
    serially (one strided copy to the host) and the collective on a mesh.
    A mesh ranking fit journals no chunk, as the reference's does not."""
    p, K = fit.params, fit.K
    if host_loop:
        dt = time.perf_counter() - t_chunk
        prof.record_phase("train.host_iter", dt)
        _monitor_chunk(it, it + C, dt, n, K, fit.cfg.hist_method,
                       coll_sched=coll_sched)
        return
    if ranking:
        return
    if p.fault_tolerant_retries == 0 and prof.enabled:
        t_host = time.perf_counter()
        device_wait(fit.devices)
        t_done = time.perf_counter()
        prof.dispatch("train.boost_chunk", t_host - t_chunk,
                      t_done - t_host, prof.compile_seq() - seq0)
        prof.span("train.boost_chunk", t_done - t_chunk, journal=True,
                  it=int(it), **({"mesh": True} if use_mesh else {}),
                  host_ms=round((t_host - t_chunk) * 1e3, 3),
                  device_ms=round((t_done - t_host) * 1e3, 3))
    dt = time.perf_counter() - t_chunk
    if use_mesh:
        _monitor_chunk(it, it + C, dt, n, K, fit.cfg.hist_method,
                       collective=fit.cfg.collective, coll_sched=coll_sched)
    else:
        _monitor_chunk(it, it + C, dt, n, K, fit.cfg.hist_method,
                       fit.objective, fit.arrays.scores[0], fit.labels,
                       fit.w, coll_sched=coll_sched)


def train(*args, **kwargs) -> Booster:
    """Train a forest — the public entry point (:func:`_train_entry` holds
    the parameter contract).

    Wraps the fit in a telemetry *fit span*, as the reference does: a span
    id is minted per fit and published process-wide
    (:func:`..core.telemetry.current_fit_span`), so the checkpoint events
    and the elastic lease files carry it; ``fit_begin`` / ``fit_end`` (or
    ``fit_failed``, with a flight record) journal events bracket every
    ``boost_chunk`` / ``ckpt_*`` event in between, which is what
    ``tools/trace_report.py`` turns into a fit timeline.  After the fit
    the booster gets its reference profile
    (:func:`_capture_reference_profile`).  A nested call joins the
    enclosing span instead of minting its own."""
    if _tm.current_fit_span() is not None:
        return _train_entry(*args, **kwargs)
    span = _tm.new_trace_id()
    _tm.set_current_fit_span(span)
    t0 = time.perf_counter()
    _tm.get_journal().emit("fit_begin", fit=span)
    try:
        booster = _train_entry(*args, **kwargs)
    except BaseException as e:
        _tm.get_journal().emit("fit_failed", fit=span,
                               error=type(e).__name__)
        if not isinstance(e, KeyboardInterrupt):
            # the journal tail, the metrics, the profile (with the card's
            # watermarks) and the thread stacks at the moment the fit died
            _tm.record_flight("fit_failed",
                              {"fit": span, "error": repr(e)})
        _tm.set_current_fit_span(None)
        raise

    def _arg(i: int, name: str):
        return args[i] if len(args) > i else kwargs.get(name)

    _capture_reference_profile(booster, _arg(0, "bins"), _arg(3, "mapper"),
                               _arg(6, "feature_names"))
    _tm.get_journal().emit(
        "fit_end", fit=span, dur_s=round(time.perf_counter() - t0, 3),
        trees=len(booster.trees))
    _tm.set_current_fit_span(None)
    return booster


def _train_entry(bins, labels, weights, mapper: BinMapper,
                 objective: Objective, params: TrainParams,
                 feature_names: Optional[List[str]] = None,
                 device: DeviceLike = "cuda", mesh: Optional[Mesh] = None,
                 val_bins=None, val_labels: Optional[np.ndarray] = None,
                 val_weights: Optional[np.ndarray] = None,
                 val_metric: Optional[Callable] = None,
                 ranking_info: Optional[Dict] = None,
                 init_scores=None,
                 val_init_scores: Optional[np.ndarray] = None,
                 callbacks: Optional[Sequence[Callable]] = None,
                 shard_rows: Optional[Sequence[int]] = None,
                 grad_fn_override: Optional[Callable] = None) -> Booster:
    """:func:`train`'s fit.  ``bins``: ``(n, f)`` bin codes — a tensor or a
    numpy array.  Without a mesh the fit runs on the tensor's device (an
    array moves to ``device``).  With a mesh of more than one device the
    rows are sharded over its data axis and the features over its feature
    axis (``params.parallelism="voting"`` selects PV-Tree voting on the
    data axis); a one-device mesh fits serially on its device.

    ``bins`` may also be a list of per-shard code matrices, one per data
    shard of ``mesh``, with ``labels`` and ``weights`` lists to match:
    sharded ingestion (:func:`_train_distributed_sharded`), where no
    matrix of every shard's rows is ever made.  On a gang of controllers
    each process passes None in the slots of the shards it does not hold,
    with ``shard_rows`` (every shard's row count).

    ``val_bins`` (binned by the same mapper) with ``val_labels``,
    ``val_weights`` and ``val_metric(margins, labels, weights)`` (lower
    is better, numpy on the host): the validation set that
    ``params.early_stopping_round`` stops on (DART takes none).

    ``ranking_info`` (``query_ids``, ``sigma``, ``truncation_level``):
    lambdarank gradients from the rows' query structure replace the
    objective's; on a mesh each query lives on one data shard.

    ``init_scores`` (``(n,)`` or ``(n, K)``): per-row margin offsets the
    scores start from (LightGBM's init score; the margins of the model a
    continuation extends), in place of boost-from-average;
    ``val_init_scores`` offsets the validation rows alike.

    ``callbacks``: each called as ``cb(it, trees)`` after every iteration,
    in order, with the host trees grown so far (iteration-major, shrunk
    but for rf; DART's before its rescale).  The gbdt / goss / rf loop
    calls them after each chunk (:func:`_chunk_size`) for its
    iterations, as the reference does; a fit resumed from a checkpoint
    calls them for the remaining iterations only.

    ``params.checkpoint_dir`` and ``params.fault_tolerant_retries``: the
    chunk-boundary checkpoints and the in-process chunk replay (the
    module's docstring).

    ``grad_fn_override``: the reference's custom gradient, ``(scores) ->
    (g, h)``, called every iteration with the ``(n,)`` scores in place of
    the objective's gradient (a single-model objective, no mesh, as in the
    reference).  The loop is the reference's host loop: bagging, GOSS, rf
    and DART as for any objective, the score update rounded as the
    serial ranker's, no EFB and no checkpoints."""
    if isinstance(bins, (list, tuple)):
        return _train_distributed_sharded(
            bins, labels, weights, mapper, objective, params, mesh,
            feature_names, val_bins=val_bins, val_labels=val_labels,
            val_weights=val_weights, val_metric=val_metric,
            callbacks=callbacks, grad_fn_override=grad_fn_override,
            init_scores=init_scores, val_init_scores=val_init_scores,
            ranking_info=ranking_info, shard_rows=shard_rows)
    if is_gang(mesh):
        raise ValueError(
            "a gang of controllers trains from per-shard lists (sharded "
            "ingestion): pass each process's shards, None in the others' "
            "slots, and shard_rows")
    return _train_impl(bins, labels, weights, mapper, objective, params,
                       feature_names, device, mesh, val_bins, val_labels,
                       val_weights, val_metric, ranking_info, init_scores,
                       val_init_scores, callbacks,
                       grad_fn_override=grad_fn_override)


class _GradOverride:
    """A custom gradient ``fn(scores) -> (g, h)`` as a serial fit's
    gradient source (the form :class:`.ranking.LambdarankGradient`
    takes): per call ``[(g, h, bag, bag)]``, so the grower's channels are
    ``(g·bag, h·bag, bag)``, the reference's host loop's."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, arrays, bag, scores=None):
        s = (arrays.scores if scores is None else scores)[0]
        g, h = self.fn(s)
        g, h = (torch.as_tensor(x, dtype=torch.float32, device=s.device)
                for x in (g, h))
        return [(g, h, bag[0], bag[0])]


def _gang_refusal(params: TrainParams, ranking: bool) -> Optional[str]:
    """What a gang of controllers does not run yet, or None."""
    if params.fault_tolerant_retries > 0:
        # A replay in one process would send its chunk's gathers again
        # while its peers move on, and gloo pairs gathers by order alone.
        return ("faultTolerantRetries on a gang of controllers is not "
                "ported (ROADMAP.md, Queue A item 10): a gang recovers "
                "through supervise and checkpointDir")
    what = ("parallelism='voting'" if params.parallelism == "voting"
            else "boostingType='dart'" if params.boosting == "dart"
            else "a ranking objective" if ranking else None)
    return None if what is None else (
        f"{what} on a gang of controllers is not ported (ROADMAP.md, "
        "Queue A item 10); it runs on a one-controller mesh")


def _train_distributed_sharded(bins_shards, label_shards, weight_shards,
                               mapper: BinMapper, objective: Objective,
                               params: TrainParams, mesh: Optional[Mesh],
                               feature_names=None, val_bins=None,
                               val_labels=None, val_weights=None,
                               val_metric=None, callbacks=None,
                               grad_fn_override=None, init_scores=None,
                               val_init_scores=None, ranking_info=None,
                               shard_rows=None) -> Booster:
    """Training from per-shard inputs (the reference's function of this
    name): each data shard's rows go to its own mesh slice, and no matrix
    of every shard's rows exists anywhere.  Supports what the mesh loop
    does — validation and early stopping (the validation set arrives
    whole), bagging, feature fraction, callbacks, per-shard init scores
    (a list, or one array in shard order), GOSS, rf, DART and lambdarank
    (``ranking_info["query_ids"]`` a list per shard or one array in shard
    order; each query must live on one shard), DART × ranking included —
    and on a gang of controllers everything but voting, DART,
    lambdarank and ``fault_tolerant_retries``.  Labels and weights must
    be complete on every controller; a custom gradient is refused."""
    if mesh is None:
        raise ValueError("sharded input requires a mesh (setMesh or "
                         "build_mesh)")
    if grad_fn_override is not None:
        raise NotImplementedError(
            "custom gradient overrides are not supported with sharded "
            "ingestion (the override closes over monolithic rows); "
            "rankers pass structured ranking_info instead")
    D = mesh.data
    if not len(bins_shards) == len(label_shards) == D:
        raise ValueError(
            f"need exactly one shard slot per data-mesh slice: got "
            f"{len(bins_shards)} bins and {len(label_shards)} label slots "
            f"for data={D}")
    if any(b is None for b in bins_shards):
        if shard_rows is None:
            raise ValueError(
                "multi-controller sharded training (None bins slots) "
                "requires shard_rows — the global per-shard row counts")
        if any(y is None for y in label_shards):
            raise ValueError(
                "label_shards must be complete on every controller "
                "(labels are 1-D metadata; all-gather them first)")
    if weight_shards is None:
        weight_shards = [None if y is None else np.ones(len(y), np.float64)
                         for y in label_shards]
    if any(w is None for w in weight_shards):
        raise ValueError("weight_shards must be complete on every "
                         "controller (1-D metadata, like labels)")
    sizes = (list(shard_rows) if shard_rows is not None
             else [b.shape[0] for b in bins_shards])
    if len(sizes) != D:
        raise ValueError(f"shard_rows has {len(sizes)} counts for "
                         f"data={D}")
    for d, y in enumerate(label_shards):
        if len(y) != sizes[d]:
            raise ValueError(f"shard {d}: {len(y)} labels for "
                             f"{sizes[d]} rows")

    def per_shard(x):
        if x is None or isinstance(x, (list, tuple)):
            return None if x is None else list(x)
        offs = np.cumsum([0] + sizes)
        return [np.asarray(x)[offs[d]:offs[d + 1]] for d in range(len(sizes))]

    ranking = ranking_info is not None
    shards = ShardedInput(list(bins_shards), list(label_shards),
                          list(weight_shards), sizes,
                          per_shard(init_scores),
                          per_shard(ranking_info["query_ids"]) if ranking
                          else None)
    if ranking and any(q is None for q in shards.qids):
        raise ValueError("qid shards must be complete on every controller "
                         "(1-D metadata, like labels)")
    if mesh.is_gang:
        refusal = _gang_refusal(params, ranking)
        if refusal:
            raise NotImplementedError(refusal)
    labels = np.concatenate([np.asarray(y) for y in label_shards])
    w = np.concatenate([np.asarray(x, np.float64) for x in weight_shards])
    return _train_impl(None, labels, w, mapper, objective, params,
                       feature_names, mesh.devices[0], mesh, val_bins,
                       val_labels, val_weights, val_metric, ranking_info,
                       shards.init_scores, val_init_scores, callbacks,
                       shards=shards)


def _train_impl(bins, labels: np.ndarray, weights: Optional[np.ndarray],
                mapper: BinMapper, objective: Objective,
                params: TrainParams, feature_names=None,
                device: DeviceLike = "cuda", mesh: Optional[Mesh] = None,
                val_bins=None, val_labels=None, val_weights=None,
                val_metric=None, ranking_info=None, init_scores=None,
                val_init_scores=None, callbacks=None,
                shards: Optional[ShardedInput] = None,
                grad_fn_override: Optional[Callable] = None) -> Booster:
    """:func:`train`'s fit, from one matrix ``bins`` or, under sharded
    ingestion, from ``shards`` (``bins`` None, ``labels`` and ``weights``
    every shard's in shard order)."""
    check_parallelism(params.parallelism)
    if params.boosting not in ("gbdt", "goss", "dart", "rf"):
        raise NotImplementedError(
            f"boostingType={params.boosting!r} is not supported; use "
            "'gbdt', 'goss', 'dart' or 'rf'")
    use_rf = params.boosting == "rf"
    use_dart = params.boosting == "dart"
    use_bag = params.bagging_freq > 0 and params.bagging_fraction < 1.0
    if use_rf and not (use_bag and params.bagging_fraction > 0.0):
        raise ValueError("boostingType='rf' requires bagging: set "
                         "baggingFraction in (0,1) and baggingFreq > 0 "
                         "(as in LightGBM)")
    if use_dart and params.early_stopping_round > 0:
        raise NotImplementedError(
            "boostingType='dart' does not support early stopping "
            "(dropped-tree rescaling is not invertible by truncation); "
            "unset earlyStoppingRound")
    callbacks = list(callbacks or ())
    if mesh is not None:
        dev = mesh.devices[0]
    elif isinstance(bins, torch.Tensor):
        dev = resolve_device(bins.device)
    else:
        dev = resolve_device(device)
    # sharded ingestion always runs the mesh loop, as in the reference
    use_mesh = mesh is not None and (len(mesh) > 1 or shards is not None)
    devices = mesh.devices if use_mesh else (dev,)
    if shards is None:
        if not isinstance(bins, torch.Tensor):
            bins = torch.as_tensor(np.asarray(bins), dtype=mapper.bin_dtype)
        bins = bins.to(dev).contiguous()
        n, f = bins.shape
    else:
        n, f = shards.n, shards.num_features
    labels = np.asarray(labels)
    rng = np.random.default_rng(params.seed)
    bag_rng = np.random.default_rng(params.bagging_seed)
    ranking = ranking_info is not None
    override = grad_fn_override is not None
    if override and use_mesh:
        raise NotImplementedError(
            "custom gradient overrides are not supported with a mesh (only "
            "lambdarank, which provides ranking_info)")
    # the reference's per-iteration host loop: the serial ranker and a
    # custom gradient (a chunk an iteration, journaled as such)
    host_loop = override or (ranking and not use_mesh)

    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    objective.prepare(labels, w)
    # per-row init scores replace boost_from_average, as in LightGBM: a
    # training-time offset, not baked into the model
    init = objective.init_score(labels, w) \
        if params.boost_from_average and init_scores is None else 0.0
    shard_mesh = mesh if use_mesh else None
    collective, downgrade = _resolve_collective_cfg(params, shard_mesh,
                                                    ranking)
    qbits, qmc, qwire, collective, qdown = _resolve_quantized(
        params, n, 1 if shard_mesh is None else shard_mesh.data, collective,
        ranking)
    cfg = GrowerConfig(
        num_leaves=params.num_leaves, max_depth=params.max_depth,
        num_bins=mapper.num_total_bins, lambda_l1=params.lambda_l1,
        lambda_l2=params.lambda_l2, min_data_in_leaf=params.min_data_in_leaf,
        min_sum_hessian_in_leaf=params.min_sum_hessian_in_leaf,
        min_gain_to_split=params.min_gain_to_split,
        hist_method=params.histogram_method, collective=collective,
        voting_k=params.top_k if params.parallelism == "voting" else 0,
        use_categorical=mapper.has_categorical,
        cat_smooth=params.cat_smooth, cat_l2=params.cat_l2,
        max_cat_threshold=params.max_cat_threshold,
        max_cat_to_onehot=params.max_cat_to_onehot,
        quantized_bits=qbits, quantized_seed=params.seed,
        quantized_max_code=qmc, quantized_wire=qwire)
    cfg = sharded_cfg(shard_mesh, cfg)
    if cfg.voting_k > 0 and cfg.data_axis_size > 1 \
            and cfg.feature_axis_size > 1:
        raise ValueError("parallelism='voting' runs on a mesh without a "
                         f"feature axis; got {mesh.shape}")
    F = cfg.feature_axis_size
    K = objective.num_model_per_iteration
    T = params.num_iterations
    if override and K > 1:
        raise NotImplementedError(
            "a custom gradient override trains a single-model objective; "
            f"this one grows {K} trees an iteration")
    ckpt = params.checkpoint_dir
    if ckpt and (use_dart or ranking or override):
        log.warning(
            "checkpoint_dir is inert for %s (per-iteration host "
            "bookkeeping, as in the reference; restart a killed fit from "
            "initModelPath)", "boostingType='dart'" if use_dart
            else "lambdarank" if ranking else "a custom gradient")
        ckpt = ""
    if ckpt:
        # the fingerprint of the inputs as given, before EFB rebinds bins
        fp = (_ckpt_fingerprint_mesh(n, f, K, params, labels, bins, w,
                                     init_scores, mesh, shards) if use_mesh
              else _ckpt_fingerprint(n, f, K, params, labels, bins, w,
                                     init_scores))
        local_digest = _local_bins_digest(shards)
    perm = offsets = ranking_src = None
    if ranking:
        # ranking.py holds the ranker estimator, which imports this module
        from .ranking import (LambdarankGradient, shard_queries,
                              shard_queries_from_shards)
    if ranking and use_mesh:
        if init_scores is not None:
            raise NotImplementedError(
                "per-row init scores (initScoreCol, or the margins of an "
                "initModelPath continuation) are not supported with a "
                "mesh ranking objective (the packed-query layout boots from "
                "zero, as LightGBM's lambdarank does); continue a ranker "
                "serially, or train fresh under the mesh")
        if F > 1 and params.boosting in ("dart", "goss"):
            raise NotImplementedError(
                f"boostingType={params.boosting!r} with a ranking objective "
                "requires a data-only mesh; use parallelism='data' / "
                "feature=1")
        if shards is None:
            perm, _, qt = shard_queries(labels, ranking_info["query_ids"],
                                        cfg.data_axis_size,
                                        ranking_info["truncation_level"])
        else:
            perm, _, qt, offsets = shard_queries_from_shards(
                shards.labels, shards.qids,
                ranking_info["truncation_level"])

        def ranking_src():
            return LambdarankGradient.sharded(
                qt, cfg.data_axis_size, devices, F, ranking_info["sigma"],
                ranking_info["truncation_level"], mesh.data_offset,
                dart=params.boosting == "dart")
    elif ranking:
        def ranking_src():
            return LambdarankGradient.serial(
                labels, ranking_info["query_ids"], ranking_info["sigma"],
                ranking_info["truncation_level"], dev, weights)
    elif override:
        def ranking_src():
            return _GradOverride(grad_fn_override)
    # the host loop of a custom gradient stays unbundled, as in the
    # reference
    efb_gate = ("custom_gradient" if override and params.enable_bundle
                else _efb_gate(params, mapper, ranking, shard_mesh, n,
                               shards is not None))
    efb_maps = None
    if efb_gate == "none":
        efb_maps, bundled = _build_efb(bins.cpu().numpy(), mapper, params,
                                       f)
        if efb_maps is None:
            efb_gate = "trivial"
        else:
            bins = torch.as_tensor(bundled, device=dev)
    # the memory guard, before anything of the fit's own is on the device
    D = cfg.data_axis_size
    qids = None if not ranking else (
        np.concatenate([np.asarray(q) for q in shards.qids])
        if shards is not None else ranking_info["query_ids"])
    if shards is None:
        itemsize, shard_rows = bins.element_size(), 0
    else:
        itemsize = mapper.bin_dtype.itemsize
        shard_rows = (len(perm) if perm is not None
                      else D * max(shards.sizes)) // D
    budget = check_fit_budget(
        _fit_budget(cfg, params, n, itemsize, f, K, devices,
                    0 if efb_maps is None else bins.shape[1],
                    0 if val_bins is None else len(val_bins), qids,
                    shard_rows),
        dev, D, params.verbosity)
    goss = None
    if params.boosting == "goss":
        if perm is not None:
            goss_rows = len(perm) // D
        elif shards is not None:
            # the reference sizes every shard's sample from the mean shard
            goss_rows = max(1, int(np.ceil(n / D)))
            if max(shards.sizes) > 2 * min(shards.sizes) \
                    and params.verbosity >= 0:
                log.warning("GOSS with sharded ingestion: shard sizes %s "
                            "are imbalanced; per-shard sample fractions "
                            "will differ (small shards train closer to "
                            "full)", shards.sizes)
        else:
            goss_rows = pad_to_multiple(n, D) // D
        goss = _goss_sizes(params, goss_rows)
    has_val = val_bins is not None and val_metric is not None \
        and len(val_bins) > 0
    vs0 = None
    if has_val:
        if not isinstance(val_bins, torch.Tensor):
            val_bins = torch.as_tensor(np.asarray(val_bins),
                                       dtype=mapper.bin_dtype)
        val_bins = val_bins.to(dev).contiguous()
        nv = val_bins.shape[0]
        vs0 = np.full((nv,) if K == 1 else (nv, K), init, np.float32)
        if val_init_scores is not None:
            vsc = np.asarray(val_init_scores, np.float32)
            vs0 = vs0 + (vsc if vs0.ndim == vsc.ndim else vsc[:, None])
        val_labels = np.asarray(val_labels)
    fit = _BoostFit(
        params=params, objective=objective, cfg=cfg, mapper=mapper,
        mesh=shard_mesh, dev=dev, devices=devices, labels=labels, w=w,
        init=init, init_scores=init_scores, F=F, K=K, T=T, perm=perm,
        offsets=offsets,
        efb_maps=efb_maps, ranking=ranking_src, goss=goss, use_rf=use_rf,
        has_val=has_val, vs0=vs0, val_labels=val_labels,
        val_weights=val_weights, val_metric=val_metric,
        # the serial lambdarank loop and a custom gradient round the score
        # update's product and sum apart, as the reference's eager host
        # loop does
        fused=not host_loop)
    source = bins if shards is None else shards
    fit.upload(source, val_bins)
    arrays = fit.arrays
    coll_sched = collective_schedule(cfg, f,
                                     n_rows_local=arrays.rows_per_shard)
    _record_fit_resolution(cfg, collective, downgrade, coll_sched, dev.type,
                           qdown)
    if shards is not None:
        last_fit_info.update(sharded_input="true",
                             processes=str(mesh.process_count))
        if mesh.is_gang:
            import torch.distributed as dist
            last_fit_info["gang_backend"] = str(dist.get_backend())
    last_fit_info.update(
        efb_bundles=str(0 if efb_maps is None else bins.shape[1]),
        efb_gate=efb_gate)
    last_fit_budget.clear()
    last_fit_budget.update(budget)
    last_validation.clear()
    last_checkpoint.clear()
    # pad features (to a multiple of the feature axis) stay masked out
    fi_base = np.zeros((pad_to_multiple(f, F), 3), np.float32)
    fi_base[:f] = _feat_info_from_mapper(mapper, f)
    use_ff = params.feature_fraction < 1.0

    def fi_draw(_it):
        return (_draw_feature_fraction(rng, fi_base, f,
                                       params.feature_fraction)
                if use_ff else fi_base)

    if use_dart:
        if params.fault_tolerant_retries > 0:
            log.warning("faultTolerantRetries is inert for "
                        "boostingType='dart' (per-iteration host loop; no "
                        "chunk snapshots)")
        bag = fit.ones

        def bag_draw(it):
            nonlocal bag
            if use_bag and it % params.bagging_freq == 0:
                bag = _bag_on_devices(arrays, _draw_bag_row(
                    bag_rng, n, params.bagging_fraction), devices)
            return bag

        def grads_at(scores, bag):
            if fit.grad_src is not None:
                return fit.grad_src(arrays, bag, scores)
            return objective_grads(arrays, bag, objective, scores)

        trees_dev, scales, grew, _ = _dart_fit(
            arrays, grads_at, cfg, params, shard_mesh, K, bag_draw, fi_draw,
            callbacks, lambda t: host_tree_from_arrays(t, mapper))
        trees, stop_iter = _truncate(
            [host_tree_from_arrays(t, mapper) for t in trees_dev], grew, K,
            T, params.verbosity)
        # bake each iteration's final scale into its K trees
        for t, sc in zip(trees, np.repeat(scales, K)):
            t.leaf_value = t.leaf_value * sc
            t.internal_value = t.internal_value * sc
            t.shrinkage = sc
        return _finalize(trees, K, init, params, objective, mapper,
                         feature_names, f, stop_iter, dev)

    if has_val:
        last_validation.update(metrics=[], seconds=0.0)
    ftr = params.fault_tolerant_retries
    chunk = 1 if host_loop else _chunk_size(
        params, T, has_val, bool(callbacks), use_bag, use_mesh, ckpt)
    prof = get_profiler()
    if ftr > 0:
        # host copies of the device inputs a replay uploads again (the
        # shards' own matrices under sharded ingestion)
        host_inputs = (bins.cpu() if shards is None else shards,
                       val_bins.cpu() if has_val else None)
    cur_bag = np.ones(n, np.float32)
    best_metric, best_iter = np.inf, -1
    trees_chunks: List[TreeChunk] = []
    stop_iter = T
    it = 0
    if ckpt:
        last_checkpoint.update(saves=0, save_seconds=0.0, bytes=[],
                               resumed_from=None)
        snap = (_ckpt_load_mesh(ckpt, fp, arrays.scores,
                                fit.val_scores if has_val
                                else np.zeros(0, np.float32), F, mesh,
                                local_digest)
                if use_mesh else _ckpt_load(ckpt, fp))
        # one verdict for the gang: a process whose own inputs changed
        # starts every process fresh
        snap = _ckpt_unanimous(snap, shard_mesh)
        if snap is None:
            # stale chunk files of an abandoned fit must not be skipped
            # over by this fit's saves and stitched into its meta; the
            # verdict is the gang's, so process 0 alone deletes, and the
            # barrier keeps peers' first saves behind the purge
            if not is_gang(shard_mesh) or mesh.process_index == 0:
                _ckpt_clear(ckpt)
            gang_barrier(shard_mesh)
        else:
            _ckpt_event("ckpt_resumed", it=int(snap["it"]),
                        **({"mesh": True} if use_mesh else {}))
            it = snap["it"]
            trees_chunks = list(snap["trees_chunks"])
            fit.restore(snap["scores"] if use_mesh else [snap["scores"]],
                        snap["val_scores"])
            cur_bag = np.asarray(snap["cur_bag"], np.float32)
            rng.bit_generator.state = snap["rng_state"]
            bag_rng.bit_generator.state = snap["bag_rng_state"]
            best_metric, best_iter = snap["best_metric"], snap["best_iter"]
            last_checkpoint["resumed_from"] = it
            if callbacks:
                log.warning("resuming from checkpoint at iteration %d: "
                            "callbacks replay only for the remaining "
                            "iterations", it)
            elif params.verbosity > 0:
                log.info("resuming from checkpoint at iteration %d", it)
    trees = [t for ch in trees_chunks for t in ch.trees]
    grew = [g for ch in trees_chunks for g in ch.grew]
    while it < T:
        C = min(chunk, T - it)
        rows = None
        if use_bag:
            rows = []
            for j in range(C):
                if (it + j) % params.bagging_freq == 0:
                    cur_bag = _draw_bag_row(bag_rng, n,
                                            params.bagging_fraction)
                rows.append(cur_bag)
        fis = [fi_draw(it + j) for j in range(C)]
        snapshot = fit.host_state() if ftr > 0 else None
        t_chunk = time.perf_counter()
        seq0 = prof.compile_seq()
        for attempt in range(ftr + 1):
            try:
                if attempt > 0:
                    # inside the try: a failed upload spends an attempt
                    fit.upload(*host_inputs)
                    fit.restore(*snapshot)
                out = _boost_chunk(fit, it, rows, fis,
                                   (best_metric, best_iter))
                if ftr > 0:
                    fit.synchronize()
                break
            except Exception as e:  # noqa: BLE001 - a lost device
                if attempt >= ftr:
                    raise
                _ckpt_event("chunk_replayed", it=int(it),
                            attempt=attempt + 1,
                            **({"mesh": True} if use_mesh else {}))
                log.warning("chunk at iteration %d failed (attempt %d/%d: "
                            "%s: %s); uploading the inputs again and "
                            "replaying", it, attempt + 1, ftr,
                            type(e).__name__, e)
                # free the failed attempt's buffers before the upload
                # (after an out-of-memory error they would hold a copy)
                fit.drop_device_arrays()
        _observe_chunk(fit, prof, it, C, t_chunk, seq0, host_loop, ranking,
                       use_mesh, n, coll_sched)
        trees_chunks.append(TreeChunk(out.trees, out.grew))
        trees += out.trees
        grew += out.grew
        best_metric, best_iter = out.best
        if has_val:
            last_validation["metrics"] += out.metrics
            last_validation["seconds"] += out.val_seconds
        if out.stop_iter is not None:
            stop_iter = out.stop_iter
        if callbacks:
            upto = stop_iter if out.stop_iter is not None \
                else it + len(out.grew)
            for j in range(it, upto):
                for cb in callbacks:
                    cb(j, trees[:(j + 1) * K])
        if out.stop_iter is not None or out.no_growth:
            break
        it += C
        if ckpt and it < T:
            # it == T would save what the clear below deletes
            t0 = time.perf_counter()
            if use_mesh:
                _ckpt_save_mesh(ckpt, fp, it, trees_chunks,
                                fit.arrays.scores, fit.val_scores
                                if has_val else np.zeros(0, np.float32),
                                cur_bag, rng, bag_rng, best_metric,
                                best_iter, F, shard_mesh, local_digest)
            else:
                _ckpt_save(ckpt, fp, it, trees_chunks, fit.arrays.scores[0],
                           fit.val_scores if has_val
                           else np.zeros(0, np.float32), cur_bag, rng,
                           bag_rng, best_metric, best_iter)
            last_checkpoint["save_seconds"] += time.perf_counter() - t0
            last_checkpoint["saves"] += 1
            last_checkpoint["bytes"].append(_npz_bytes(ckpt))
    if ckpt:
        # every process must be past its last read of the snapshot
        # before process 0 deletes it
        gang_barrier(shard_mesh)
        if not is_gang(shard_mesh) or mesh.process_index == 0:
            _ckpt_clear(ckpt)

    trees, stop_iter = _truncate(trees, grew, K, stop_iter,
                                 params.verbosity)
    if has_val:
        last_validation.update(best_iteration=best_iter,
                               best_metric=best_metric,
                               stop_iteration=stop_iter)
    if use_rf:
        _rf_average_trees(trees, K)
    return _finalize(trees, K, init, params, objective, mapper,
                     feature_names, f, stop_iter, dev)


def _npz_bytes(ckpt_dir: str) -> int:
    """The snapshot files' bytes on disk; a file that goes while it is
    counted (a peer of a gang removing its older state file) counts 0."""
    total = 0
    for p in glob.glob(os.path.join(ckpt_dir, "*.npz")):
        try:
            total += os.path.getsize(p)
        except FileNotFoundError:
            pass
    return total


def _finalize(trees: list, K: int, init: float, params: TrainParams,
              objective: Objective, mapper: BinMapper,
              feature_names: Optional[List[str]], f: int, stop_iter: int,
              dev: torch.device) -> Booster:
    """The Booster of the exported trees: the init score baked into the
    first tree of each class, as LightGBM does."""
    if trees and params.boost_from_average and init != 0.0:
        for t in trees[:K]:
            t.leaf_value = t.leaf_value + init
            t.internal_value = t.internal_value + init
    # pass-through keys naming engine params were applied by
    # TrainParams.__post_init__ (num_iterations records the stop); only
    # the engine-unknown ones are recorded as given
    extra = {k: v for k, v in params.pass_through.items()
             if not hasattr(params, k) and k not in REFERENCE_ONLY_PARAMS}
    engine_params = {
        "boosting": params.boosting,
        "objective": objective.model_str,
        "num_iterations": str(stop_iter),
        "learning_rate": f"{params.learning_rate:g}",
        "num_leaves": str(params.num_leaves),
        "max_depth": str(params.max_depth),
        "max_bin": str(params.max_bin),
        **extra,
    }
    return Booster(trees, num_class=K, objective_str=objective.model_str,
                   init_score=0.0, feature_names=feature_names,
                   feature_infos=mapper.feature_infos(),
                   max_feature_idx=f - 1, params=engine_params, device=dev)


def _bin_representatives(mapper: BinMapper) -> List[np.ndarray]:
    """Per feature, the lookup ``bin code -> a raw value in the bin``:
    tree thresholds are bin upper bounds, so a row of representatives
    reaches exactly the leaves its raw row would (the missing bin is NaN,
    which the walk routes by the default direction; a categorical bin is
    its raw category value)."""
    reps: List[np.ndarray] = []
    for j in range(mapper.num_features):
        rep = np.full(mapper.num_total_bins, np.nan, np.float64)
        if mapper.is_categorical(j):
            vals = mapper.cat_values[j]
            rep[:len(vals)] = vals.astype(np.float64)
        else:
            ub = mapper.upper_bounds[j]
            if len(ub):
                rep[:len(ub)] = ub
                rep[len(ub)] = ub[-1] + max(1.0, abs(float(ub[-1])))
            else:
                rep[0] = 0.0
        reps.append(rep)
    return reps


def _host_codes(bins) -> Optional[np.ndarray]:
    """The fit's bin codes as one host matrix: a tensor copied to the
    host, per-shard matrices joined in shard order; None when a shard is
    not held here (a gang's other processes' slots)."""
    if isinstance(bins, (list, tuple)):
        if any(b is None for b in bins):
            return None
        return np.concatenate([_host_codes(b) for b in bins], axis=0)
    if isinstance(bins, torch.Tensor):
        return bins.cpu().numpy()
    return np.asarray(bins)


def _capture_reference_profile(booster: Booster, bins, mapper,
                               feature_names) -> None:
    """Attach the fit-time data-quality baseline (the reference's function
    of this name): per-feature sketches over the full binned training
    matrix plus a prediction-margin sketch from predicting at most
    ``_REF_PROFILE_MARGIN_ROWS`` rows of bin representatives
    (:func:`_bin_representatives`; a seeded sample of the rows beyond
    that).  The capture runs on the host: the native scorer's margins
    are the card walk's bits, and the card walk would add its stacked
    forest and per-tree buffers to the fit's device-memory peak, which
    the fit budget does not cover.  Advisory — a capture failure logs and leaves
    ``booster.reference_profile`` None; it never fails the fit.
    ``MMLSPARK_TPU_REF_PROFILE=0`` skips it.  :data:`last_ref_profile`
    keeps its seconds by step and its rows."""
    if os.environ.get(REF_PROFILE_ENV, "1") == "0" or mapper is None:
        return
    t0 = time.perf_counter()
    try:
        from ..core.sketch import build_reference_profile
        bins = _host_codes(bins)
        if bins is None or bins.ndim != 2 \
                or bins.shape[1] != mapper.num_features:
            return
        sample = bins
        if sample.shape[0] > _REF_PROFILE_MARGIN_ROWS:
            idx = np.random.default_rng(0).choice(
                sample.shape[0], size=_REF_PROFILE_MARGIN_ROWS,
                replace=False)
            idx.sort()
            sample = sample[idx]
        reps = _bin_representatives(mapper)
        Xr = np.empty(sample.shape, np.float32)
        for j, rep in enumerate(reps):
            Xr[:, j] = rep[sample[:, j].astype(np.int64)]
        t1 = time.perf_counter()
        margins = booster.predict_margin(Xr, device="cpu").numpy()
        t2 = time.perf_counter()
        booster.reference_profile = build_reference_profile(
            bins, mapper, margins, feature_names=feature_names,
            meta={"trees": len(booster.trees),
                  "num_class": booster.num_class,
                  "fit_span": _tm.current_fit_span()})
        train_stats.incr("ref_profiles")
        last_ref_profile.clear()
        t3 = time.perf_counter()
        last_ref_profile.update(seconds=t3 - t0, codes_s=t1 - t0,
                                predict_s=t2 - t1, sketch_s=t3 - t2,
                                rows=float(len(sample)))
    except Exception:  # noqa: BLE001 - the profile is advisory
        log.exception("reference-profile capture failed; drift "
                      "monitoring will be unavailable for this model")


def train_incremental(bins, labels: np.ndarray, mapper: BinMapper, *,
                      init_booster: Booster, objective: Objective,
                      params: TrainParams,
                      weights: Optional[np.ndarray] = None,
                      feature_names: Optional[List[str]] = None,
                      device: DeviceLike = "cuda",
                      callbacks: Optional[Sequence[Callable]] = None
                      ) -> Booster:
    """Continued training from rows already binned by ``mapper``: the
    init margins come from walking ``init_booster`` over each bin's
    representative value (:func:`_bin_representatives`), which reach the
    leaves the raw rows would, so they equal the margins of the raw rows.
    The new trees boost from them on ``device``, and the result is
    ``init_booster.extended(new)``, the forest ``initModelPath`` gives.
    ``callbacks`` and ``params.checkpoint_dir`` work as in :func:`train`
    (the fingerprint covers the init margins).  The merged booster gets
    its own reference profile (:func:`_capture_reference_profile`): the
    one a drift monitor compares live margins against must describe the
    merged forest."""
    if params.boosting not in ("gbdt", "goss"):
        raise ValueError(
            "incremental training requires boosting gbdt or goss: "
            f"got {params.boosting!r}")
    if init_booster.num_class != objective.num_model_per_iteration:
        raise ValueError(
            f"init model has num_class={init_booster.num_class}, this "
            f"fit trains {objective.num_model_per_iteration}")
    if init_booster.max_feature_idx != mapper.num_features - 1:
        raise ValueError(
            f"init model was trained on "
            f"{init_booster.max_feature_idx + 1} features, the binned "
            f"matrix has {mapper.num_features}")
    host = (bins.cpu().numpy() if isinstance(bins, torch.Tensor)
            else np.ascontiguousarray(bins))
    if host.ndim != 2 or host.shape[1] != mapper.num_features:
        raise ValueError(
            f"bins shape {host.shape} does not match the mapper's "
            f"{mapper.num_features} features")
    Xr = np.empty(host.shape, np.float64)
    for j, rep in enumerate(_bin_representatives(mapper)):
        Xr[:, j] = rep[host[:, j].astype(np.int64)]
    margins = init_booster.predict_margin(Xr, device=device)
    booster = train(bins, labels, weights, mapper, objective, params,
                    feature_names, device=device,
                    init_scores=margins.cpu().numpy().astype(np.float64),
                    callbacks=callbacks)
    merged = init_booster.extended(booster)
    _capture_reference_profile(merged, host, mapper, feature_names)
    return merged
