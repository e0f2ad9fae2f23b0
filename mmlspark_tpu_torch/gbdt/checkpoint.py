"""Chunk-boundary checkpoints of a fit (``TrainParams.checkpoint_dir``).

The port's counterpart of the checkpoint section of
``mmlspark_tpu/gbdt/engine.py`` (lines 372-1031), with its function
names, its file names and its crash-consistency order:

* **Tree chunks are write-once.**  Each chunk of iterations is one file,
  ``boost_chunk_{:06d}.npz``, written once (to a temporary file, fsynced,
  renamed) and never rewritten.  The port keeps host trees
  (:class:`.booster.HostTree`), so a chunk holds every field of each of
  its trees as its own array, and each iteration's ``grew`` flag: loading
  gives back trees whose model text is byte-equal.
* **The meta is written last**, ``boost_checkpoint.npz``: the fit's
  fingerprint, the boundary iteration, the chunk and tree counts, the
  fit span (:func:`..core.telemetry.current_fit_span`), both numpy
  streams' states and the early-stopping bests (serially also the
  scores, the validation scores and the carried bag row), to a temporary
  file, fsynced, ``os.replace``\\ d, then the directory fsynced.  A torn
  save leaves the previous boundary loadable.
* **A bad snapshot degrades to a fresh fit**: absent, torn, corrupt, of
  another fit (:func:`_ckpt_fingerprint`) or with a stale chunk cadence,
  it loads as None, with a warning and the ``ckpt_discarded`` counter.
  ``checkpoint_dir`` and ``checkpoint_chunk`` decide where and how often
  snapshots land, never the forest, and stay out of the fingerprint.
* **The mesh form** (the reference's, ``engine.py:766-1031``).  Each
  process of the mesh (one, or a gang of controllers) writes its own
  state file a boundary, ``mesh_state_p{pid:03d}_it{:06d}.npz``: its
  data shards' scores once (a feature axis's replicas once when they are
  equal, else each device's own), the validation scores and the carried
  bag row; process 0 alone writes the chunk files.  Then every process
  waits (a barrier), process 0 alone writes the meta naming the
  boundary, every process waits again, and each removes its own older
  state files: a crash
  anywhere leaves the meta naming a complete generation.  The
  fingerprint adds the topology, the process count included
  (:func:`_ckpt_fingerprint_mesh`); under sharded ingestion it covers
  the metadata every process holds (sizes, labels, weights), and each
  process's own codes and init scores are covered by its
  :func:`_local_bins_digest`, kept in its state file.  A load checks
  every process's state file against the meta and its own digest, and
  :func:`_ckpt_unanimous` makes the verdict the gang's: one process
  rejecting the snapshot starts the whole gang fresh.  Process 0 alone
  clears a stale generation, behind a barrier.

:data:`train_stats` counts the events over every fit of the process and
the telemetry journal records each, stamped with the fit span
(:func:`_ckpt_event`), as the reference's do.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import logging
import os
import re
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import telemetry as _tm
from ..core.profiling import StageStats
from ..ops.collectives import gang_barrier, gang_gather, is_gang
from .booster import HostTree

log = logging.getLogger("mmlspark_tpu_torch.gbdt")

_CKPT_FILE = "boost_checkpoint.npz"       # meta + loop state, atomic
#: one per tree chunk, write-once; the clear glob is derived from the
#: template (:func:`_ckpt_glob`)
_CKPT_CHUNK = "boost_chunk_{:06d}.npz"
#: a mesh fit's state, stamped with its boundary iteration, so the state
#: write (first) and the meta write (last) never tear against each other
_CKPT_MESH_PREFIX = "mesh_state_p{:03d}_it"
_CKPT_MESH_STATE = _CKPT_MESH_PREFIX + "{:06d}.npz"

#: Training counters over every fit of this process (recovery, boost
#: chunks, reference profiles, collectives), seeded at 0 so that "no
#: recovery happened" reads as an explicit zero; the engine registers it
#: under ``"train"`` in the process registry.
train_stats = StageStats()
for _k in ("chunks_replayed", "ckpt_saved", "ckpt_resumed",
           "ckpt_discarded", "boost_chunks", "ref_profiles",
           "collective_count", "collective_payload_bytes"):
    train_stats.incr(_k, 0)
del _k

_EVENT_COUNTERS = {"chunk_replayed": "chunks_replayed"}
_TREE_FIELDS = [f.name for f in dataclasses.fields(HostTree)]
_TREE_SCALARS = {"shrinkage": float, "num_cat": int}


class TreeChunk(NamedTuple):
    """One chunk of iterations: its host trees (iteration-major,
    class-minor, shrunk as the fit keeps them) and whether each
    iteration's trees split."""
    trees: List[HostTree]
    grew: List[bool]


def _ckpt_event(name: str, **fields) -> None:
    """Count a checkpoint event into :data:`train_stats` (``ckpt_saved``,
    ``ckpt_resumed``, ``ckpt_discarded``; ``chunk_replayed`` counts
    ``chunks_replayed``) and journal it, stamped with the current fit
    span so ``tools/trace_report.py`` places it on the fit's timeline."""
    train_stats.incr(_EVENT_COUNTERS.get(name, name))
    _tm.get_journal().emit(name, fit=_tm.current_fit_span(), **fields)


def _host(x) -> np.ndarray:
    """A host numpy copy of a tensor (or an array as it is)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def _ckpt_glob(template: str) -> str:
    """The glob of a file-name template: every ``{...}`` becomes ``*``."""
    return re.sub(r"\{[^{}]*\}", "*", template)


def _fsync_dir(path: str) -> None:
    """fsync a directory, so that a rename in it survives power loss;
    best-effort (a checkpoint must never kill the fit it protects)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_atomic(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez`` to ``path + ".tmp"``, fsync, then rename onto
    ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _meta_array(meta: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8)


def _read_meta(z) -> dict:
    return json.loads(bytes(z["__meta__"]).decode("utf-8"))


def _ckpt_fingerprint(n, f, K, params, labels, bins, weights,
                      init_scores) -> str:
    """The identity of a fit for resume: its shapes, every parameter but
    ``checkpoint_dir`` and ``checkpoint_chunk`` (also when given as
    pass-through keys), and a digest of its data (the labels, weights and
    init scores whole, and a strided sample of the bin codes), so that a
    fit of the same shape on other inputs starts fresh."""
    skip = ("checkpoint_dir", "checkpoint_chunk")
    d = {k: v for k, v in params.__dict__.items() if k not in skip}
    d["pass_through"] = {k: v for k, v in params.pass_through.items()
                         if k not in skip}
    h = hashlib.sha256(
        f"{n}|{f}|{K}|{sorted(d.items())!r}".encode("utf-8"))
    h.update(np.ascontiguousarray(np.asarray(labels)).tobytes())
    h.update(b"w" if weights is None else
             np.ascontiguousarray(np.asarray(weights)).tobytes())
    h.update(b"i" if init_scores is None else
             np.ascontiguousarray(np.asarray(init_scores)).tobytes())
    sample = bins[::max(1, len(bins) // 4096)]
    h.update(np.ascontiguousarray(_host(sample)).tobytes())
    return h.hexdigest()


def _ckpt_fingerprint_mesh(n, f, K, params, labels, bins, w, init_scores,
                           mesh, shards=None) -> str:
    """A mesh fit's fingerprint: the serial one plus the topology (the
    ``data × feature`` shape, the process count, the learner and the
    collective), so that a resume under another layout starts fresh.
    Under sharded ingestion (``shards``, a
    :class:`.distributed.ShardedInput`) the digest covers only what every
    process holds — the parameters, the labels, weights and init scores
    in shard order (the init scores only where every slot has them) and
    the shard sizes — so the fingerprint is the same in every process
    with no round of messages; each process's own codes are covered by
    :func:`_local_bins_digest`."""
    if shards is not None:
        iss = shards.init_scores
        is_cat = (None if iss is None or any(s is None for s in iss)
                  else np.concatenate([np.asarray(s) for s in iss]))
        base = _ckpt_fingerprint(
            n, f, K, params, np.concatenate(
                [np.asarray(y) for y in shards.labels]),
            np.zeros((0, f), np.uint8), np.concatenate(
                [np.asarray(x) for x in shards.weights]), is_cat)
        base = hashlib.sha256(
            (base + "|sizes=" + ",".join(map(str, shards.sizes))
             ).encode("utf-8")).hexdigest()
    else:
        base = _ckpt_fingerprint(n, f, K, params, labels, bins, w,
                                 init_scores)
    topo = (f"|mesh={mesh.data}x{mesh.feature}|procs={mesh.process_count}"
            f"|parallelism={params.parallelism}"
            f"|collective={params.collective}")
    return hashlib.sha256((base + topo).encode("utf-8")).hexdigest()


def _local_bins_digest(shards) -> str:
    """The digest of what this process alone contributes under sharded
    ingestion: its shards' codes and init scores (each init-score slot
    tagged with its index).  Without it a re-run on other feature values,
    or a continuation on another base model's margins, would resume and
    blend two fits.  "" without sharded ingestion (the fingerprint covers
    the inputs then)."""
    if shards is None:
        return ""
    h = hashlib.sha256()
    for b in shards.bins:
        if b is not None:
            h.update(np.ascontiguousarray(_host(b)).tobytes())
    if shards.init_scores is not None:
        for i, s in enumerate(shards.init_scores):
            if s is not None:
                h.update(f"|is{i}|".encode("utf-8"))
                h.update(np.ascontiguousarray(
                    np.asarray(s, np.float32)).tobytes())
    return h.hexdigest()


def _ckpt_tree_count(trees_chunks: Sequence[TreeChunk]) -> int:
    """The trees across the chunks: the meta endorses it, so that a load
    detects a stale chunk file that a resume under another
    ``checkpoint_chunk`` cadence left behind."""
    return int(sum(len(ch.trees) for ch in trees_chunks))


def _chunk_arrays(chunk: TreeChunk) -> Dict[str, np.ndarray]:
    out = {"grew": np.asarray(chunk.grew, bool),
           "n_trees": np.asarray(len(chunk.trees), np.int64)}
    for i, t in enumerate(chunk.trees):
        for name in _TREE_FIELDS:
            out[f"t{i}_{name}"] = np.asarray(getattr(t, name))
    return out


def _chunk_from(z) -> TreeChunk:
    trees = []
    for i in range(int(z["n_trees"])):
        kw = {}
        for name in _TREE_FIELDS:
            a = z[f"t{i}_{name}"]
            kw[name] = _TREE_SCALARS[name](a) if name in _TREE_SCALARS \
                else a
        trees.append(HostTree(**kw))
    return TreeChunk(trees, [bool(g) for g in z["grew"]])


def _ckpt_read_chunks(ckpt_dir, n_chunks, n_trees=None) -> List[TreeChunk]:
    """The write-once chunk files, each npz closed after reading.  Raises
    when their trees do not add up to the meta's ``n_trees`` (a stale
    chunk of another cadence); the load paths discard the snapshot."""
    chunks = []
    for i in range(n_chunks):
        with np.load(os.path.join(ckpt_dir, _CKPT_CHUNK.format(i))) as cz:
            chunks.append(_chunk_from(cz))
    if n_trees is not None and _ckpt_tree_count(chunks) != n_trees:
        raise ValueError(
            f"tree chunk files hold {_ckpt_tree_count(chunks)} trees "
            f"but the checkpoint meta endorses {n_trees} (stale chunk "
            f"from a different checkpoint_chunk cadence)")
    return chunks


def _ckpt_write_chunks(ckpt_dir, trees_chunks: Sequence[TreeChunk]) -> None:
    """Write each chunk file that is not there yet (fsynced, renamed)."""
    for i, ch in enumerate(trees_chunks):
        cpath = os.path.join(ckpt_dir, _CKPT_CHUNK.format(i))
        if not os.path.exists(cpath):
            _write_atomic(cpath, _chunk_arrays(ch))


def _ckpt_write_meta(ckpt_dir, fp, it, n_chunks, rng, bag_rng,
                     best_metric, best_iter, arrays, extra_meta=None
                     ) -> None:
    """The meta file, replaced atomically last, then the directory
    fsynced so the rename itself is durable."""
    meta = {
        "fingerprint": fp, "it": int(it), "n_chunks": int(n_chunks),
        "rng_state": rng.bit_generator.state,
        "bag_rng_state": bag_rng.bit_generator.state,
        "best_metric": float(best_metric), "best_iter": int(best_iter),
    }
    if extra_meta:
        meta.update(extra_meta)
    _write_atomic(os.path.join(ckpt_dir, _CKPT_FILE),
                  {"__meta__": _meta_array(meta), **arrays})
    _fsync_dir(ckpt_dir)


def _ckpt_save(ckpt_dir, fp, it, trees_chunks, scores, val_scores,
               cur_bag, rng, bag_rng, best_metric, best_iter) -> None:
    """Persist a serial fit's boundary ``it``: the chunk files not yet on
    disk, then the meta with host copies of the scores, the validation
    scores (float32, exact) and the carried bag row."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _ckpt_write_chunks(ckpt_dir, trees_chunks)
    _ckpt_write_meta(
        ckpt_dir, fp, it, len(trees_chunks), rng, bag_rng, best_metric,
        best_iter,
        arrays={"scores": _host(scores), "val_scores": _host(val_scores),
                "cur_bag": _host(cur_bag)},
        extra_meta={"n_trees": _ckpt_tree_count(trees_chunks),
                    "fit_span": _tm.current_fit_span()})
    _ckpt_event("ckpt_saved", it=int(it), n_chunks=len(trees_chunks))


def _ckpt_load(ckpt_dir, fp) -> Optional[dict]:
    """A serial snapshot, or None when it is absent, unreadable or of
    another fit (the fit then starts fresh)."""
    path = os.path.join(ckpt_dir, _CKPT_FILE)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            meta = _read_meta(z)
            if meta["fingerprint"] != fp:
                log.warning("checkpoint at %s belongs to a different "
                            "fit (data or params changed); starting "
                            "fresh", path)
                _ckpt_event("ckpt_discarded", reason="fingerprint_mismatch")
                return None
            arrays = {k: z[k] for k in ("scores", "val_scores", "cur_bag")}
        return {
            "it": meta["it"],
            "trees_chunks": _ckpt_read_chunks(ckpt_dir, meta["n_chunks"],
                                              meta.get("n_trees")),
            **arrays,
            "rng_state": meta["rng_state"],
            "bag_rng_state": meta["bag_rng_state"],
            "best_metric": meta["best_metric"],
            "best_iter": meta["best_iter"],
        }
    except Exception as e:  # noqa: BLE001 - torn or partial snapshot
        log.warning("checkpoint at %s is unreadable (%s: %s); "
                    "starting fresh", path, type(e).__name__, e)
        _ckpt_event("ckpt_discarded", reason=type(e).__name__)
        return None


def _ckpt_clear(ckpt_dir) -> None:
    """Remove every snapshot file (temporary partials included)."""
    paths = [os.path.join(ckpt_dir, _CKPT_FILE),
             os.path.join(ckpt_dir, _CKPT_FILE + ".tmp")]
    for tpl in (_CKPT_CHUNK, _CKPT_MESH_STATE):
        for pat in (_ckpt_glob(tpl), _ckpt_glob(tpl) + ".tmp"):
            paths += glob.glob(os.path.join(ckpt_dir, pat))
    for p in paths:
        try:
            os.remove(p)
        except OSError:
            pass


def _ckpt_shard_bounds(index, shape) -> List[List[int]]:
    """A shard's index (a tuple of slices) as ``[[start, stop], ...]``."""
    return [list(s.indices(dim)[:2]) for s, dim in zip(index, shape)]


def _score_layout(scores: Sequence, feature: int, shard0: int = 0,
                  data: int = 0):
    """``[(device, bounds)]`` of this process's per-device scores in the
    global padded layout of ``data`` shards (0: its own): local device k
    holds data shard ``shard0 + k // feature``'s rows."""
    S = scores[0].shape[0]
    shape = ((data or len(scores) // feature) * S,) \
        + tuple(scores[0].shape[1:])
    rest = (slice(None),) * (len(shape) - 1)
    return [(k, _ckpt_shard_bounds(
        (slice((shard0 + k // feature) * S,
               (shard0 + k // feature + 1) * S),) + rest, shape))
        for k in range(len(scores))]


def _ckpt_save_mesh(ckpt_dir, fp, it, trees_chunks, scores, val_scores,
                    cur_bag, rng, bag_rng, best_metric, best_iter,
                    feature: int = 1, mesh=None,
                    local_digest: str = "") -> None:
    """Persist a mesh fit's boundary ``it`` in the reference's order:
    process 0's chunk files, this process's it-stamped state file (its
    data shards' scores from their first devices, a feature axis's other
    replicas only where they differ from it, the validation scores, the
    carried bag row and its ``local_digest``), a barrier, process 0's
    meta, a barrier, then this process's older state files removed.
    ``mesh`` (None: one process) names the process and its shards."""
    pid = mesh.process_index if is_gang(mesh) else 0
    nproc = mesh.process_count if is_gang(mesh) else 1
    os.makedirs(ckpt_dir, exist_ok=True)
    if pid == 0:
        # write-once and shared: the trees are the same in every process
        _ckpt_write_chunks(ckpt_dir, trees_chunks)
    host = [_host(s) for s in scores]
    layout = _score_layout(host, feature,
                           mesh.data_offset if nproc > 1 else 0,
                           mesh.data if nproc > 1 else 0)
    arrays = {"cur_bag": _host(cur_bag)}
    shards_meta = []
    for k, bounds in layout:
        first = host[k - k % feature]
        if k % feature and host[k].tobytes() == first.tobytes():
            continue            # a replica along the feature axis
        arrays[f"shard_{len(shards_meta)}"] = host[k]
        shards_meta.append({"name": "scores", "bounds": bounds,
                            "device": k})
    vs = _host(val_scores)
    arrays[f"shard_{len(shards_meta)}"] = vs
    shards_meta.append({"name": "val_scores",
                        "bounds": [[0, d] for d in vs.shape], "device": 0})
    pmeta = {"fingerprint": fp, "it": int(it), "pid": pid,
             "local_digest": local_digest, "shards": shards_meta}
    spath = os.path.join(ckpt_dir, _CKPT_MESH_STATE.format(pid, int(it)))
    _write_atomic(spath, {"__meta__": _meta_array(pmeta), **arrays})
    _fsync_dir(ckpt_dir)
    # the meta must never name a boundary some process has not persisted
    gang_barrier(mesh)
    if pid == 0:
        _ckpt_write_meta(ckpt_dir, fp, it, len(trees_chunks), rng, bag_rng,
                         best_metric, best_iter, arrays={},
                         extra_meta={"nproc": nproc, "mesh": True,
                                     "n_trees": _ckpt_tree_count(
                                         trees_chunks),
                                     "fit_span": _tm.current_fit_span()})
    # and no process may remove its previous generation before the meta
    # naming the new one is durable
    gang_barrier(mesh)
    for p in glob.glob(os.path.join(
            ckpt_dir, _CKPT_MESH_PREFIX.format(pid) + "*")):
        if p != spath:
            try:
                os.remove(p)
            except OSError:
                pass
    _ckpt_event("ckpt_saved", it=int(it), n_chunks=len(trees_chunks),
                pid=pid, mesh=True)


def _ckpt_load_mesh(ckpt_dir, fp, scores_like, val_scores_like,
                    feature: int = 1, mesh=None,
                    local_digest: str = "") -> Optional[dict]:
    """This process's part of a mesh snapshot, or None when absent,
    unusable, of another fit or written against other local inputs
    (``local_digest``).  Every process's state file must match the meta;
    only this process's own is read whole.  ``scores`` comes back as one
    host array per device of ``scores_like`` (each device its own replica
    where one was written, else its data shard's), each checked against
    the like's shape; ``val_scores`` as one host array.  On a gang the
    caller makes the verdict unanimous (:func:`_ckpt_unanimous`)."""
    path = os.path.join(ckpt_dir, _CKPT_FILE)
    if not os.path.exists(path):
        return None
    pid = mesh.process_index if is_gang(mesh) else 0
    try:
        with np.load(path) as z:
            meta = _read_meta(z)
        if meta["fingerprint"] != fp:
            log.warning("mesh checkpoint at %s belongs to a different "
                        "fit (data, params or topology changed); "
                        "starting fresh", path)
            _ckpt_event("ckpt_discarded", reason="fingerprint_mismatch",
                        mesh=True)
            return None
        it = meta["it"]
        pmeta = own = None
        for p in range(meta.get("nproc", 1)):
            spath = os.path.join(ckpt_dir, _CKPT_MESH_STATE.format(p, it))
            # each peer's file is opened for its meta alone, and closed
            with np.load(spath) as sz:
                m = _read_meta(sz)
                if m["fingerprint"] != fp or m["it"] != it:
                    raise ValueError(
                        f"state file for process {p} does not match the "
                        f"checkpoint meta (boundary {it})")
                if p == pid:
                    pmeta = m
                    own = {k: sz[k] for k in sz.files if k != "__meta__"}
        if pmeta is None:
            raise ValueError(f"no state file for process {pid}")
        if pmeta.get("local_digest", "") != local_digest:
            log.warning("mesh checkpoint state for process %d was written "
                        "against other local inputs; starting fresh", pid)
            _ckpt_event("ckpt_discarded", reason="local_digest", mesh=True)
            return None
        chunks = _ckpt_read_chunks(ckpt_dir, meta["n_chunks"],
                                   meta.get("n_trees"))
        by_device, val = {}, None
        for i, sm in enumerate(pmeta["shards"]):
            if sm["name"] == "scores":
                by_device[sm["device"]] = own[f"shard_{i}"]
            else:
                val = own[f"shard_{i}"]
        scores = []
        for k, like in enumerate(scores_like):
            s = by_device.get(k, by_device.get(k - k % feature))
            if s is None or tuple(s.shape) != tuple(like.shape):
                raise ValueError(f"no scores of shape {tuple(like.shape)} "
                                 f"for device {k}")
            scores.append(s)
        if val is None or tuple(val.shape) != tuple(val_scores_like.shape):
            raise ValueError("the validation scores do not match the fit")
        return {
            "it": it, "trees_chunks": chunks, "scores": scores,
            "val_scores": val, "cur_bag": own["cur_bag"],
            "rng_state": meta["rng_state"],
            "bag_rng_state": meta["bag_rng_state"],
            "best_metric": meta["best_metric"],
            "best_iter": meta["best_iter"],
        }
    except Exception as e:  # noqa: BLE001 - torn or partial snapshot
        log.warning("mesh checkpoint at %s is unusable (%s: %s); "
                    "starting fresh", path, type(e).__name__, e)
        _ckpt_event("ckpt_discarded", reason=type(e).__name__,
                    mesh=True)
        return None


def _ckpt_unanimous(snap: Optional[dict], mesh) -> Optional[dict]:
    """The gang's verdict on a mesh snapshot: ``snap`` when every process
    loaded its part, else None for every process (a gang in which one
    controller resumes while another starts fresh would sum unlike
    partials).  Off a gang the verdict is this process's own."""
    if not is_gang(mesh):
        return snap
    peers_ok = [int(x) for x in gang_gather(
        [torch.tensor(int(snap is not None), device=mesh.devices[0])], mesh)]
    if snap is not None and not all(peers_ok):
        log.warning("a peer controller rejected the mesh checkpoint; "
                    "starting fresh gang-wide")
        _ckpt_event("ckpt_discarded", reason="peer_rejected", mesh=True)
        return None
    return snap
