"""LightGBMRanker: the lambdarank objective and estimator.

The port's counterpart of ``mmlspark_tpu/gbdt/ranking.py``.  Rows are
grouped by query on the host and packed into padded ``(Q, G)`` index
matrices (G the largest query); the gradient runs over chunks of queries,
each a ``(chunk, G, G)`` pairwise lambda tensor:

* gains ``2^label − 1``, discounts ``1 / log2(2 + rank)`` with ranks from
  the current scores, ΔNDCG normalised by the query's ideal DCG;
* ``lambda = −σ · p_ij · ΔNDCG``, ``hess = σ² p (1 − p) ΔNDCG``;
* pairs count when either member ranks above the truncation level.

The float order is the reference's compiled XLA CPU program's: its log
(:func:`log32`) and sigmoid, and both pairwise sums added as its CPU
backend adds them (:func:`..grower.sum_bins`: blocks of 32, zero-padded
evenly at both ends), so the gradients agree bit for bit.  The chunking
only bounds memory; the padded width G is the whole fit's.

On a mesh (:func:`shard_queries`) every query lives on one data shard, so
the gradients stay shard-local and only the histograms cross shards.
The host helpers (:func:`pack_queries`, :func:`query_tensors`,
:func:`shard_queries`, :func:`ndcg_at_k`) are copies of the reference's
numpy code.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.params import Param, TypeConverters
from ..core.schema import DataTable, features_matrix
from .base import LightGBMBase, LightGBMModelBase
from .booster import Booster
from .grower import sum_bins
from .objectives import sigmoid

#: the Cephes log polynomial of XLA's CPU backend (float32 constants)
_LOG_POLY = tuple(float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_SQRT_HALF = float(np.float32(0.707106781186547524))
_LN2_HI, _LN2_LO = 0.693359375, float(np.float32(-2.12194440e-4))
#: 1 / ln 2 as XLA folds the divisor of ``jnp.log2``
_INV_LN2 = float(np.float32(1.44269502))
#: the default bound on a chunk's pairs (the reference's
#: ``query_chunk_pairs``)
CHUNK_PAIRS = 4_000_000


def log32(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of positive normal ``x`` by the Cephes
    polynomial XLA's CPU backend evaluates: equal to its ``log`` at every
    integer in [2, 4097], the arguments the rank discount takes (a
    test holds them), and within one ulp elsewhere."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF).to(torch.float32) - 126.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    tmp = torch.where(small, m, 0.0)
    m = m - 1.0
    e = e - small.to(torch.float32)
    m = m + tmp
    p = _LOG_POLY
    x2 = m * m
    x3 = x2 * m
    y = p[0] * m + p[1]
    y1 = p[3] * m + p[4]
    y2 = p[6] * m + p[7]
    y = y * m + p[2]
    y1 = y1 * m + p[5]
    y2 = y2 * m + p[8]
    y = (y * x3 + y1) * x3 + y2
    y = y * x3 + e * _LN2_LO
    return (m - x2 * 0.5) + y + e * _LN2_HI


def dcg_discount(rank: torch.Tensor) -> torch.Tensor:
    """``1 / log2(2 + rank)`` in float32, as the reference's compiled
    ``1.0 / jnp.log2(2.0 + rank)``: XLA's log times its folded 1 / ln 2,
    then the division."""
    lg = log32(2.0 + rank) * _INV_LN2
    return torch.full_like(lg, 1.0) / lg


def _descending_order(s: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(-s, axis=1)``: stable, in the float total order of
    XLA's sort (−0 before +0), on the int32 keys that order it alike on
    the CPU and the card."""
    i = (-s).view(torch.int32)
    key = i ^ ((i >> 31) & 0x7FFFFFFF)
    return torch.argsort(key, dim=1, stable=True)


def pack_queries(query_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """Group rows by query: ``(order, qidx, qmask)``; ``order`` sorts rows
    by query (stable), ``qidx`` ``(Q, G)`` holds positions in the sorted
    order (0 padded) and ``qmask`` marks the real entries."""
    order = np.argsort(query_ids, kind="stable")
    sorted_q = query_ids[order]
    _, starts, counts = np.unique(sorted_q, return_index=True,
                                  return_counts=True)
    Q, G = len(starts), int(counts.max())
    qidx = np.zeros((Q, G), np.int32)
    qmask = np.zeros((Q, G), np.float32)
    for i, (s, c) in enumerate(zip(starts, counts)):
        qidx[i, :c] = np.arange(s, s + c)
        qmask[i, :c] = 1.0
    return order.astype(np.int32), qidx, qmask


def query_tensors(labels_sorted: np.ndarray, qidx: np.ndarray,
                  qmask: np.ndarray, truncation_level: int,
                  max_label: int = 31):
    """Per-query host tensors: gains, padded labels (pads −1) and the
    inverse ideal DCG."""
    Q, G = qidx.shape
    gains_row = (2.0 ** np.minimum(labels_sorted, max_label) - 1.0)
    lab_q = labels_sorted[qidx] * qmask - (1.0 - qmask)
    gains_q = gains_row[qidx] * qmask
    ideal = -np.sort(-gains_q, axis=1)
    k = min(truncation_level, G)
    disc = 1.0 / np.log2(2.0 + np.arange(G))
    max_dcg = (ideal[:, :k] * disc[:k]).sum(axis=1)
    inv_max_dcg = np.where(max_dcg > 0,
                           1.0 / np.maximum(max_dcg, 1e-12), 0.0)
    return (gains_q.astype(np.float32), lab_q.astype(np.float32),
            inv_max_dcg.astype(np.float32))


# The mesh DART step's sums over a query's G documents, as the reference's
# compiled program adds them on the CPU (ROADMAP.md, Queue C 3).  XLA
# writes each sum as a loop; from G = 12 to 32 LLVM vectorises it on 8
# lanes and the x86 backend splits the 8-lane adds into 4-lane halves and
# folds some of them into FMA chains.  Each order is a tree over the
# 4-term quarters q_k = x[4k : 4k + 4] (nested pairs: (a, b) is a + b),
# then the 4 lanes reduced by halves, ((l0 + l2) + (l1 + l3)), then the
# terms past the covered span added one by one.  Read from the optimised
# IR (``--xla_dump_to``'s ``*.ir-with-opt.ll``), the object code of the
# fusions and the per-row (g, h) of the reference's step.
_Q16 = ((0, 2), (1, 3))                     # 8 lanes: v0 + v1
_Q16_FMA = (((0, 2), 3), 1)                 # folded into one chain
_Q24 = (((0, 2), 4), ((1, 3), 5))           # 8 lanes: (v0 + v1) + v2
_Q24_FMA = (((((0, 2), 4), 3), 1), 5)
_Q32 = (((0, 4), (2, 6)), ((1, 5), (3, 7)))         # (v0 + v2) + (v1 + v3)
_Q32_FMA = ((((0, 4), 6), 2), (((1, 5), 7), 3))     # ((v0 + v2) + v3) + v1

#: G -> {sum: quarter tree}; the sums are "grad_j" / "hess_j" (over the
#: documents j of row i) and "grad_i" / "hess_i" (over i); a sum or a
#: width not named keeps the ranking scan's order (sequential up to 32)
DART_ORDERS = {
    12: {"hess_j": _Q16},
    **{G: {"grad_j": _Q16, "hess_j": _Q16} for G in range(13, 16)},
    **{G: dict.fromkeys(("grad_j", "hess_j", "grad_i", "hess_i"), _Q16)
       for G in range(16, 20)},
    **{G: {"grad_j": _Q16, "grad_i": _Q16, "hess_j": _Q16_FMA,
           "hess_i": _Q16_FMA} for G in range(20, 24)},
    **{G: dict.fromkeys(("grad_j", "hess_j", "grad_i", "hess_i"), _Q24)
       for G in range(24, 28)},
    **{G: {"grad_j": _Q24, "grad_i": _Q24, "hess_j": _Q24_FMA,
           "hess_i": _Q24} for G in range(28, 32)},
    32: {"grad_j": _Q32, "grad_i": _Q32, "hess_j": _Q32_FMA,
         "hess_i": _Q32_FMA},
}


def _quarter_sum(x: torch.Tensor, tree) -> torch.Tensor:
    """Sum over the last axis in the order of a quarter ``tree`` (see
    :data:`DART_ORDERS`).  The vector loop covers every term up to 16
    (its second 8-lane vector masked: those lanes are absent, not zero),
    else the whole 8-term vectors."""
    G = x.shape[-1]
    covered = G if G <= 16 else 8 * (G // 8)

    def lanes(t):
        if isinstance(t, int):
            return [x[..., 4 * t + k] if 4 * t + k < covered else None
                    for k in range(4)]
        a, b = lanes(t[0]), lanes(t[1])
        return [u if w is None else w if u is None else u + w
                for u, w in zip(a, b)]

    l0, l1, l2, l3 = lanes(tree)
    out = (l0 + l2) + (l1 + l3)
    for k in range(covered, G):
        out = out + x[..., k]
    return out


def _dart_sum(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Sum over the last axis (G terms) as the reference's compiled mesh
    DART step adds the sum ``kind`` (:data:`DART_ORDERS`), else in the
    ranking scan's order (:func:`..grower.sum_bins`)."""
    tree = DART_ORDERS.get(x.shape[-1], {}).get(kind)
    if tree is not None:
        return _quarter_sum(x, tree)
    return sum_bins(x.unsqueeze(-1)).squeeze(-1)


def lambda_grad_sorted(s_sorted: torch.Tensor, qt, sigma: float,
                       trunc: int, n: int, dart: bool = False):
    """``(n,)`` lambdarank (grad, hess) of scores sorted by query.  ``qt``
    holds the chunked query tensors ``(qidx, qmask, gains, labq)``, each
    ``(n_chunks, chunk, G)``, and ``invmax`` ``(n_chunks, chunk)``, on the
    scores' device; a row no query covers gets 0.  ``dart`` adds the sums
    over j and over i in the mesh DART step's order (:func:`_dart_sum`);
    without it every sum keeps the ranking scan's."""
    neg_sig = float(np.float32(-sigma))
    sig2 = float(np.float32(sigma * sigma))
    g_acc = torch.zeros(n, dtype=torch.float32, device=s_sorted.device)
    h_acc = torch.zeros_like(g_acc)
    for qi, qm, gains, labs, invmax in zip(*qt):
        s = s_sorted[qi] * qm - 1e9 * (1.0 - qm)
        ranks = torch.argsort(_descending_order(s), dim=1).to(torch.float32)
        disc = dcg_discount(ranks)
        better = labs[:, :, None] > labs[:, None, :]
        in_trunc = (ranks[:, :, None] < trunc) | (ranks[:, None, :] < trunc)
        pair = (better & in_trunc).to(torch.float32) * qm[:, :, None] \
            * qm[:, None, :]
        dgain = (gains[:, :, None] - gains[:, None, :]).abs()
        ddisc = (disc[:, :, None] - disc[:, None, :]).abs()
        delta = dgain * ddisc * invmax[:, None, None]
        p = sigmoid(neg_sig * (s[:, :, None] - s[:, None, :]))
        lam = neg_sig * p * delta * pair
        hes = sig2 * p * (1.0 - p) * delta * pair
        # sum over j (axis 2) and over i (axis 1), each in XLA's order
        if dart:
            g_q = _dart_sum(lam, "grad_j") \
                - _dart_sum(lam.transpose(1, 2), "grad_i")
            h_q = _dart_sum(hes, "hess_j") \
                + _dart_sum(hes.transpose(1, 2), "hess_i")
        else:
            g_q = sum_bins(lam.transpose(1, 2)) - sum_bins(lam)
            h_q = sum_bins(hes.transpose(1, 2)) + sum_bins(hes)
        real = qm > 0
        rows = qi[real]
        g_acc.index_add_(0, rows, (g_q * qm)[real])
        h_acc.index_add_(0, rows, (h_q * qm)[real])
    return g_acc, h_acc


def _chunked(qidx, qmask, gains, labq, invmax, chunk: int, device):
    """The query tensors cut into chunks of ``chunk`` queries, on
    ``device`` (qidx as int64 for indexing)."""
    G = qidx.shape[-1]
    return (torch.as_tensor(qidx.reshape(-1, chunk, G).astype(np.int64),
                            device=device),
            torch.as_tensor(qmask.reshape(-1, chunk, G), device=device),
            torch.as_tensor(gains.reshape(-1, chunk, G), device=device),
            torch.as_tensor(labq.reshape(-1, chunk, G), device=device),
            torch.as_tensor(invmax.reshape(-1, chunk), device=device))


class LambdarankGradient:
    """Lambdarank (grad, hess) of one fit, closed over its query
    structure; called with the per-device scores and bags, it returns the
    per-device ``(g, h, mask, count)`` the grower's (grad, hess, count)
    channels take (``g·mask``, ``h·mask``, ``count``).

    Serially (:meth:`serial`, the reference's ``make_lambdarank_grad_fn``)
    the rows keep their order: scores are gathered by query, the
    gradients scattered back, multiplied by the row weights, and the
    hessian floored at 1e-9; the mask and count are the bag.  On a mesh
    (:meth:`sharded`, the reference's ``make_ranking_scan``) each device
    holds whole queries of packed rows: the hessian is floored first, the
    mask is weight · bag (weights 0 on pad rows) and the count real ·
    bag."""

    def __init__(self, qts: List[tuple], sigma: float, trunc: int,
                 order: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None,
                 dart: bool = False):
        self.qts = qts
        self.sigma = float(sigma)
        self.trunc = int(trunc)
        self.order = order
        self.weights = weights
        self.dart = dart

    @classmethod
    def serial(cls, labels: np.ndarray, query_ids: np.ndarray,
               sigma: float, truncation_level: int, device,
               weights: Optional[np.ndarray] = None, max_label: int = 31,
               query_chunk_pairs: int = CHUNK_PAIRS):
        order, qidx, qmask = pack_queries(np.asarray(query_ids))
        Q, G = qidx.shape
        chunk = max(1, min(Q, query_chunk_pairs // max(G * G, 1)))
        pad_q = (-Q) % chunk
        gains, labq, invmax = query_tensors(
            np.asarray(labels, np.float32)[order], qidx, qmask,
            truncation_level, max_label)
        if pad_q:
            qidx = np.concatenate([qidx, np.zeros((pad_q, G), np.int32)])
            qmask = np.concatenate([qmask, np.zeros((pad_q, G), np.float32)])
            gains = np.concatenate([gains, np.zeros((pad_q, G), np.float32)])
            labq = np.concatenate([labq, -np.ones((pad_q, G), np.float32)])
            invmax = np.concatenate([invmax, np.zeros(pad_q, np.float32)])
        w = None if weights is None else torch.as_tensor(
            np.asarray(weights), dtype=torch.float32, device=device)
        return cls([_chunked(qidx, qmask, gains, labq, invmax, chunk,
                             device)], sigma, truncation_level,
                   order=torch.as_tensor(order.astype(np.int64),
                                         device=device), weights=w)

    @classmethod
    def sharded(cls, qt, n_shards: int, devices: Sequence[torch.device],
                feature: int, sigma: float, truncation_level: int,
                shard0: int = 0, dart: bool = False):
        """From :func:`shard_queries`'s chunked tensors ``qt``: device k
        takes data shard ``shard0 + k // feature``'s chunks (``shard0``:
        the first data shard of this process's ``devices``).  ``dart``:
        the mesh DART step's hessian order (:func:`lambda_grad_sorted`)."""
        per = qt[0].shape[0] // n_shards
        qts = []
        for k, dev in enumerate(devices):
            d = shard0 + k // feature
            part = [a[d * per:(d + 1) * per] for a in qt]
            chunk = part[0].shape[1]
            qts.append(_chunked(*part, chunk=chunk, device=dev))
        return cls(qts, sigma, truncation_level, dart=dart)

    def grad_hess(self, k: int, scores: torch.Tensor):
        """Device k's (grad, hess) at its scores."""
        n = scores.shape[0]
        if self.order is None:
            g, h = lambda_grad_sorted(scores, self.qts[k], self.sigma,
                                      self.trunc, n, self.dart)
            return g, torch.clamp(h, min=1e-9)
        g_s, h_s = lambda_grad_sorted(scores[self.order], self.qts[k],
                                      self.sigma, self.trunc, n)
        g = torch.empty_like(g_s)
        h = torch.empty_like(h_s)
        g[self.order] = g_s
        h[self.order] = h_s
        if self.weights is not None:
            g = g * self.weights
            h = h * self.weights
        return g, torch.clamp(h, min=1e-9)

    def __call__(self, arrays, bag: Sequence[torch.Tensor],
                 scores: Optional[Sequence[torch.Tensor]] = None):
        scores = arrays.scores if scores is None else scores
        out = []
        for k, s in enumerate(scores):
            g, h = self.grad_hess(k, s)
            if self.order is None:
                out.append((g, h, arrays.weights[k] * bag[k],
                            arrays.real[k] * bag[k]))
            else:
                out.append((g, h, bag[k], bag[k]))
        return out


def shard_queries(labels: np.ndarray, query_ids: np.ndarray, n_shards: int,
                  truncation_level: int, max_label: int = 31,
                  query_chunk_pairs: int = CHUNK_PAIRS, assign=None):
    """Partition whole queries across data shards (greedy row balancing):
    ``(perm, real, qt)`` — ``perm`` ``(D·S,)`` maps a packed slot to its
    source row (−1 pad), ``real`` the 0/1 validity mask, ``qt`` each
    shard's chunked query tensors (qidx, qmask, gains, labq, invmax),
    ``(D·n_chunks, chunk, G)`` / ``(D·n_chunks, chunk)``, each shard's
    qidx indexing its own packed rows.  ``assign`` pins each unique query
    (sorted id order) to a shard instead."""
    q = np.asarray(query_ids)
    order = np.argsort(q, kind="stable")
    sorted_q = q[order]
    _, starts, counts = np.unique(sorted_q, return_index=True,
                                  return_counts=True)
    D = n_shards
    loads = np.zeros(D, np.int64)
    if assign is None:
        assign = np.empty(len(starts), np.int32)
        for i, c in enumerate(counts):   # greedy: least-loaded shard
            s = int(np.argmin(loads))
            assign[i] = s
            loads[s] += c
    else:
        assign = np.asarray(assign, np.int32)
        if len(assign) != len(starts):
            raise ValueError(
                f"assign has {len(assign)} entries for {len(starts)} "
                "unique queries")
        np.add.at(loads, assign, counts)
    S = int(loads.max())
    G = int(counts.max())
    qs_per_shard = np.bincount(assign, minlength=D)
    Qs = int(qs_per_shard.max()) if len(starts) else 1
    chunk = max(1, min(Qs, query_chunk_pairs // max(G * G, 1)))
    Qp = Qs + ((-Qs) % chunk)

    perm = np.full((D, S), -1, np.int64)
    qidx = np.zeros((D, Qp, G), np.int32)
    qmask = np.zeros((D, Qp, G), np.float32)
    gains = np.zeros((D, Qp, G), np.float32)
    labq = -np.ones((D, Qp, G), np.float32)
    invmax = np.zeros((D, Qp), np.float32)

    labels_sorted = np.asarray(labels, np.float32)[order]
    fill_rows = np.zeros(D, np.int64)
    fill_q = np.zeros(D, np.int64)
    for i, (st, c) in enumerate(zip(starts, counts)):
        d = assign[i]
        r0 = fill_rows[d]
        perm[d, r0:r0 + c] = order[st:st + c]
        qi = fill_q[d]
        qidx[d, qi, :c] = np.arange(r0, r0 + c)
        qmask[d, qi, :c] = 1.0
        g_q, l_q, im = query_tensors(
            labels_sorted[st:st + c],
            np.arange(c, dtype=np.int32)[None, :c],
            np.ones((1, c), np.float32), truncation_level, max_label)
        gains[d, qi, :c] = g_q[0]
        labq[d, qi, :c] = l_q[0]
        invmax[d, qi] = im[0]
        fill_rows[d] += c
        fill_q[d] += 1

    real = (perm >= 0).astype(np.float32).reshape(-1)
    nc = D * (Qp // chunk)
    qt = (qidx.reshape(nc, chunk, G), qmask.reshape(nc, chunk, G),
          gains.reshape(nc, chunk, G), labq.reshape(nc, chunk, G),
          invmax.reshape(nc, chunk))
    return perm.reshape(-1), real, qt


def shard_queries_from_shards(label_shards, qid_shards,
                              truncation_level: int, max_label: int = 31,
                              query_chunk_pairs: int = CHUNK_PAIRS):
    """Query packing for sharded ingestion (the reference's function of
    the same name): each query stays on the shard that holds its rows.
    ``label_shards`` / ``qid_shards``: every shard's labels and query ids
    (complete on every controller, metadata like the labels).  A query
    whose id appears in two shards raises.  Returns :func:`shard_queries`'
    ``(perm, real, qt)`` (``perm`` in shard-concatenation row order) and
    each shard's first row in that order."""
    D = len(qid_shards)
    sizes = np.array([len(np.asarray(q)) for q in qid_shards], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    qids = np.concatenate([np.asarray(q) for q in qid_shards])
    labels = np.concatenate([np.asarray(l, np.float32)
                             for l in label_shards])
    if len(labels) != len(qids):
        raise ValueError(
            f"labels ({len(labels)}) and query ids ({len(qids)}) differ")
    shard_of_row = np.repeat(np.arange(D, dtype=np.int32), sizes)
    uq, inv = np.unique(qids, return_inverse=True)
    lo = np.full(len(uq), D, np.int32)
    hi = np.full(len(uq), -1, np.int32)
    np.minimum.at(lo, inv, shard_of_row)
    np.maximum.at(hi, inv, shard_of_row)
    spans = np.nonzero(lo != hi)[0]
    if len(spans):
        raise ValueError(
            f"query {uq[spans[0]]!r} spans shards {lo[spans[0]]} and "
            f"{hi[spans[0]]}: sharded lambdarank requires every query's "
            "rows on ONE shard (group-contiguous ingestion)")
    perm, real, qt = shard_queries(
        labels, qids, D, truncation_level, max_label=max_label,
        query_chunk_pairs=query_chunk_pairs, assign=lo)
    return perm, real, qt, offsets


def ndcg_at_k(scores: np.ndarray, labels: np.ndarray, query_ids: np.ndarray,
              k: int = 10) -> float:
    """Mean NDCG@k across queries (evaluation helper, numpy)."""
    out, cnt = 0.0, 0
    # group the rows by query once (stable: each query's rows keep their
    # order), then walk the queries in ascending id
    order = np.argsort(query_ids, kind="stable")
    _, starts = np.unique(np.asarray(query_ids)[order], return_index=True)
    scores, labels = np.asarray(scores)[order], np.asarray(labels)[order]
    for st, en in zip(starts, np.append(starts[1:], len(order))):
        s, lab = scores[st:en], labels[st:en]
        if len(lab) < 2 or lab.max() == lab.min():
            continue
        order = np.argsort(-s)
        gains = 2.0 ** lab - 1
        disc = 1.0 / np.log2(2 + np.arange(len(lab)))
        dcg = (gains[order][:k] * disc[:k]).sum()
        idcg = (np.sort(gains)[::-1][:k] * disc[:k]).sum()
        if idcg > 0:
            out += dcg / idcg
            cnt += 1
    return out / max(cnt, 1)


class LightGBMRanker(LightGBMBase):
    """The lambdarank estimator; the reference's LightGBMRanker API."""

    _default_objective = "lambdarank"

    groupCol = Param("groupCol", "Column with the query/group id",
                     default="query", typeConverter=TypeConverters.toString)
    maxPosition = Param("maxPosition", "NDCG truncation level", default=30,
                        typeConverter=TypeConverters.toInt)
    sigma = Param("sigma", "Sigmoid scaling of pairwise logistic loss",
                  default=1.0, typeConverter=TypeConverters.toFloat)
    evalAt = Param("evalAt", "NDCG@k positions for evaluation",
                   default=[1, 3, 5, 10],
                   typeConverter=TypeConverters.toListInt)

    def __init__(self, **kwargs):
        kwargs.setdefault("objective", "lambdarank")
        super().__init__(**kwargs)

    def _ranking_info(self, table: DataTable, train_rows):
        return {
            "query_ids": np.asarray(table[self.getGroupCol()])[train_rows],
            "sigma": self.getSigma(),
            "truncation_level": self.getMaxPosition(),
        }

    def _val_metric_fn(self, table: DataTable, val_rows):
        """Negative mean NDCG at the largest ``evalAt`` over the
        validation queries (lower is better)."""
        q_val = np.asarray(table[self.getGroupCol()])[val_rows]
        k = max(self.getEvalAt())

        def neg_ndcg(scores, labels, weights):
            return -ndcg_at_k(np.asarray(scores), np.asarray(labels),
                              q_val, k=k)
        return neg_ndcg

    def _make_model(self, booster: Booster) -> "LightGBMRankerModel":
        return LightGBMRankerModel(booster=booster)


class LightGBMRankerModel(LightGBMModelBase):

    def _transform(self, table: DataTable) -> DataTable:
        X = features_matrix(table, self.getFeaturesCol())
        out = self._with_shap(table, X)
        return out.withColumn(self.getPredictionCol(),
                              self._margins(X).astype(np.float64))
