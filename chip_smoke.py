#!/usr/bin/env python3
"""Smoke run of mmlspark_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. environment — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions; exits non-zero without a CUDA device.
2. build — compiles every ``mmlspark_tpu_torch/csrc/*.cu`` with nvcc (one
   process per source, all started together) and prints the seconds and
   each kernel's registers.
3. kernels — each CUDA kernel, in each accumulation mode, at the main-path
   shapes (B = 256; ``hist_full`` at every shape the fits launch it at:
   the flagship's 400,000 × 50 rows × features, its D = 4 shard of
   100,000 rows, the wide configuration's 2,048 × 2,000 data shard, 8,192
   × 500 feature slice and 4,096 × 1,000 data+feature block; the segment
   kernel at cnt ∈ {1, 777, the flagship fit's median segment, 200,000},
   and on the wide local 2,048 × 2,000 at a 1,024-row segment) against
   its plain PyTorch twin on the same inputs, with the median time of 20
   launches after warm-up (CUDA events) of the kernel, the twin and a
   one-call ``index_add_`` yardstick, the kernel's device time alone
   (``torch.profiler``), and the wrapper's host enqueue time (a host clock
   around 1,000 calls without a synchronize; ``hist_full`` at every row,
   the segment kernel at 1 and 777 rows).  ``hist_full`` must also equal,
   bit for bit, the order it states (``histogram_ordered`` on the CPU),
   and 20 calls in f32 must give the same bits.  The last row,
   ``hist_segment_every_row``, runs the segment kernel over rows 0 … n−1
   of the flagship matrix: the other design ``hist_full`` could have had.
4. main_path — LightGBMClassifier fit → transform at the flagship width
   (400,000 × 50, 50 iterations, 31 leaves, 255 bins), warm-up fit first;
   the launch counts of the timed fit must equal the trees grown (root
   histograms) and the splits made (segment histograms); train AUC must
   reach 0.955; the warm-up and timed fits must write the same model text
   (``same_model_text``): card fits are the same run to run.  ``host_s``
   splits the timed fit's host clock (:class:`host_split`).
5. cuda_vs_cpu — the same classifier at 20,000 × 50 and 5 iterations on
   the kernels and on the plain CPU path: identical first tree, AUCs
   within 0.002, margins close over the trees whose structure matches.
6. profile — where a 10-iteration flagship fit spends its time:
   ``torch.profiler`` device time by kernel, the device's idle share, and
   the host binning pass timed alone; the quantiles of its segment sizes
   (the smaller child of each split); then the same 10-iteration fit on
   four virtual shards under ``histogramMethod="pallas_ring"``, for the
   device time of ``fused_hist_ring`` per fit, and under ``"auto"``.
7. collectives — the kernels of ``csrc/ring.cu`` on D ∈ {2, 4}
   virtual shards of the card (the dense and select reductions on their
   direct route, as ``route`` says): ``ring_allreduce`` against its plain twin
   on the flagship payload (50, 256, 3) and a ragged (13, 17, 3), exactly
   (``torch.equal``); ``ring_allreduce_select`` against its twin, exactly,
   on the wide voting configuration's local pair (2, 2000, 256, 3) with
   k2 = 64 candidates per child, a single (2000, 256, 3) slab and a
   ragged (9, 7, 3) with 5 (yardstick ``torch.stack([p.index_select(...)
   for p in parts]).sum(0)``); ``fused_segment_hist_ring`` against its twin on the
   flagship matrix split over D shards, segments of 1, 777 and 100,000
   rows per shard, float32 within the kernels' tolerance and int32
   exactly.  Median times of the kernel's wrapper call, the twin and a
   one-call yardstick (``torch.stack(parts).sum(0)``; ``index_add_`` over
   every shard's segment), the kernel's device time alone
   (``torch.profiler``), the bound, and the wrapper's host enqueue time
   (the fused kernel's at 1 and 777 rows a shard).  Then the ring kernels
   that the dense and select reductions take on a mesh spanning cards,
   run on the same virtual shards (``route`` ``"ring"``) on the flagship
   payload and the wide pair, against the twins exactly.
8. mesh_path — the flagship classifier data-parallel over
   ``build_mesh(data=4, devices=["cuda:0"] * 4)`` with
   ``collective="ring"``, under ``histogramMethod="auto"`` and
   ``"pallas_ring"``, each a warm-up fit and a timed fit: train AUC must
   reach 0.955, and the timed fit must launch ``ring_allreduce`` once per
   tree and split (auto) or once per tree with ``fused_segment_hist_ring``
   once per split (pallas_ring); ``host_s`` and ``same_model_text`` as
   in phase 4 (reported, not required).  Then a
   20,000 × 50, 5-iteration D = 4 fit on the card and on
   ``devices=["cpu"] * 4``: identical first tree, AUCs within 0.002.
9. voting_path — the repo's wide configuration (``bench.py``'s wide-data
   A/B: 8,192 × 2,000, 4 iterations, 31 leaves, ``maxDepth`` 30, 255
   bins) on four virtual devices of the card, each learner a warm-up fit
   and a timed fit: ``parallelism="data"`` with the ring, ``"voting"``
   with the ring and ``topK=32``, ``"feature"`` on a 1 × 4 grid and
   ``"data+feature"`` on 2 × 2.  Each reports fit seconds, train AUC, the
   launches of every kernel, host syncs and the per-tree collective
   schedule.  Voting must launch ``ring_allreduce_select`` once per tree
   and split and no dense ring, ``hist_full`` 4 × trees, carry 0.063012
   of the dense payload, and reach the data fit's AUC within 0.01; each
   fit reports ``same_model_text`` against its warm-up fit.  Then
   the voting fit once more under ``torch.profiler`` (device time by
   kernel, the device's idle share), and a 20,000 × 50, 5-iteration D = 4
   voting fit (``topK=5``) on the card and on ``devices=["cpu"] * 4``:
   identical first tree, AUCs within 0.002.
10. collectives_cross_card — phase 7's checks with one shard per card,
   D = min(cards, 4), where the host has at least two cards; elsewhere it
   prints ``"ran": false`` (not a failure).

Then the ``{"kernels": [...]}`` line, the card line, and last the
``{"ok": true, ...}`` line.  Any failed phase makes the script exit 1
without that last line.

    python3 chip_smoke.py --phases kernels,main_path

runs the environment and build phases and the named ones only, in the
order above, and ends after the card line (exit 0, or 1 if a phase
failed): an A/B of one phase between two checkouts runs only what it
needs.
"""

import json
import statistics
import subprocess
import sys
import time

#: published H100 SXM rates (NVIDIA data sheet): HBM bytes/s and f32
#: FLOP/s outside the tensor cores, for the kernels' least times
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: NVLink 4 on the H100 SXM, bytes/s each way per card
NVLINK_BYTES_PER_S = 450e9
N_ROWS, N_FEATURES = 400_000, 50
#: the median of the flagship fit's segment sizes (the smaller child of
#: each of its 1,500 splits), as phase main_path prints it
MEDIAN_SEGMENT = 6_522
SEGMENT_COUNTS = (1, 777, MEDIAN_SEGMENT, 200_000)
#: the wide configuration's local shard (8,192 rows over 4 shards) and
#: the segment the kernels phase histograms on it
WIDE_LOCAL_ROWS, WIDE_SEGMENT = 2048, 1024
#: hist_full's other shapes in the fits: the flagship's D = 4 shard, and
#: beside the wide configuration's data shard its 1 x 4 feature slice and
#: 2 x 2 data+feature block (rows, features)
MESH_SHARD_ROWS = 100_000
WIDE_FULL_SHAPES = ((8192, 500), (4096, 1000))
#: calls per host enqueue measurement
ENQUEUE_CALLS = 1000
#: f32/bf16 kernel-vs-twin tolerance: |k - p| <= RTOL |p| + ATOL_ULPS u
#: sum|gh| per cell.  Both sides add the same values in different orders
#: (atomics on each); a sum of m terms in any order is off by at most
#: (m-1) u sum|x|, and by about sqrt(m) u sum|x| for random orders — about
#: 40 u sum|x| at the ~1,600 rows of a cell at 400,000 rows and 256 bins.
RTOL, ATOL_ULPS = 1e-5, 256
#: ring collectives: virtual shard counts, payloads and per-shard segments
RING_SHARDS = (2, 4)
RING_SHAPES = ((50, 256, 3), (13, 17, 3))
SHARD_SEGMENT_COUNTS = (1, 777, 100_000)
MESH_SHARDS = 4
#: the voted-column ring: (local histogram, candidates) — the wide voting
#: configuration's grow-step pair and root slab (f = 2000, B = 256, topK
#: 32 so k2 = 64), and a ragged slab
SELECT_SHAPES = (((2, 2000, 256, 3), (2, 64)), ((2000, 256, 3), (64,)),
                 ((9, 7, 3), (5,)))
#: the wide configuration (bench.py's wide-data A/B,
#: artifacts/bench_wide_r16.json): rows, features, iterations, topK
WIDE_ROWS, WIDE_FEATURES, WIDE_ITERATIONS, WIDE_TOP_K = 8192, 2000, 4, 32
REPLACES = {
    "hist_full": "mmlspark_tpu/ops/pallas_histogram.py:384",
    "hist_segment": "mmlspark_tpu/ops/pallas_histogram.py:148",
    "ring_allreduce": "mmlspark_tpu/ops/pallas_collectives.py:196",
    "ring_allreduce_select": "mmlspark_tpu/ops/pallas_collectives.py:242",
    "fused_segment_hist_ring": "mmlspark_tpu/ops/pallas_collectives.py:406",
}
SOURCES = {
    "hist_full": "mmlspark_tpu_torch/csrc/histogram.cu",
    "hist_segment": "mmlspark_tpu_torch/csrc/histogram.cu",
    "ring_allreduce": "mmlspark_tpu_torch/csrc/ring.cu",
    "ring_allreduce_select": "mmlspark_tpu_torch/csrc/ring.cu",
    "fused_segment_hist_ring": "mmlspark_tpu_torch/csrc/ring.cu",
}
#: the card the kernels and the main path run on
DEV = "cuda"


def emit(obj):
    print(json.dumps(obj), flush=True)


def bench_data(n, f):
    """bench.py's synthetic binary task (numpy default_rng(0))."""
    import numpy as np
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, f)).astype(np.float32)
    logits = (X[:, 0] * 1.5 + X[:, 1] * X[:, 2] + np.sin(X[:, 3] * 2)
              + rng.normal(size=n) * 0.5)
    return X, (logits > 0).astype(np.float64)


def auc(y, s):
    """ROC AUC by the rank formula, ties at their average rank."""
    import numpy as np
    _, inv, cnt = np.unique(s, return_inverse=True, return_counts=True)
    avg = np.cumsum(cnt) - (cnt - 1) / 2.0
    ranks = avg[inv]
    pos = y > 0
    npos, nneg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - npos * (npos + 1) / 2.0)
                 / (npos * nneg))


def median_ms(fn, reps=20, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, kernel, reps=20):
    """Mean device time per call of the kernels whose name holds
    ``kernel``, over ``reps`` calls of ``fn`` under ``torch.profiler``.
    Unlike ``median_ms`` it leaves out the host's enqueue time, which
    bounds a call whose kernel is shorter than its wrapper."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or 0
             for e in prof.key_averages() if kernel in e.key)
    return us / 1e3 / reps


def enqueue_us(fn, calls=None):
    """Host time per call of ``fn`` over ``calls`` (``ENQUEUE_CALLS``)
    calls with no synchronize between them (the wrapper's enqueue, not
    the kernel)."""
    import torch
    calls = calls or ENQUEUE_CALLS
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


class host_split:
    """Host clocks inside one timed fit: ``fetch_s``, the grower's device →
    host fetches (its host syncs: the wait for the queued kernels plus the
    copy), ``hist_segment_s`` / ``fused_hist_ring_s``, the histogram
    wrappers' calls (their host enqueue), and ``ring_allreduce_s``, the
    dense ring's; what is left of the fit is the rest of the host loop."""

    def __enter__(self):
        from mmlspark_tpu_torch.gbdt import grower
        from mmlspark_tpu_torch.ops import histogram
        self.spans = {"fetch_s": 0.0, "hist_segment_s": 0.0,
                      "fused_hist_ring_s": 0.0, "ring_allreduce_s": 0.0}
        self.patched = [(grower, "_fetch", "fetch_s"),
                        (histogram, "histogram_cuda_fused", "hist_segment_s"),
                        (grower, "fused_segment_hist_ring",
                         "fused_hist_ring_s"),
                        (grower, "ring_allreduce", "ring_allreduce_s")]
        self.saved = [getattr(m, a) for m, a, _ in self.patched]
        for (mod, attr, span), fn in zip(self.patched, self.saved):
            setattr(mod, attr, self._timed(fn, span))
        return self

    def _timed(self, fn, span):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.spans[span] += time.perf_counter() - t0
        return timed

    def __exit__(self, *exc):
        for (mod, attr, _), fn in zip(self.patched, self.saved):
            setattr(mod, attr, fn)


def segment_sizes(model):
    """The grower's segment of every split: its smaller child's rows."""
    import numpy as np
    sizes = []
    for t in model.getModel().trees:
        def rows(child):
            return t.internal_count[child] if child >= 0 \
                else t.leaf_count[~child]
        sizes += [min(rows(a), rows(b))
                  for a, b in zip(t.left_child, t.right_child)]
    q = np.quantile(np.asarray(sizes, np.float64),
                    [0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0])
    return {"splits": len(sizes),
            "quantiles": dict(zip(("min", "p10", "p25", "median", "p75",
                                   "p90", "max"), q.tolist()))}


def bound_ms(n_bytes, n_ops, wire_bytes=0):
    """Least time of a call: ``n_bytes`` through device memory and
    ``wire_bytes`` over NVLink one way, or ``n_ops`` f32 operations,
    whichever takes longest; returns ``(ms, "bytes" | "operations")``."""
    t_bytes = max(n_bytes / HBM_BYTES_PER_S, wire_bytes / NVLINK_BYTES_PER_S)
    t_ops = n_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_environment():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    return {"nvidia_smi": card, "device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}


def phase_build():
    from mmlspark_tpu_torch.ops._build import CSRC, build_all
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    res = build_all(names)
    return {"seconds": time.perf_counter() - t0,
            "sources": {k: {"seconds": v[1],
                            "ptxas": [ln.strip() for ln in v[2].splitlines()
                                      if "registers" in ln]}
                        for k, v in res.items()}}


def kernel_inputs(n=None, f=None, rows=None):
    """Binned n × f matrix and gradient triples of the main path's first
    tree (binary objective at the init score), on the card; ``rows``: only
    the first ``rows`` of them (a shard), binned on all n."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.gbdt import fit_bin_mapper, get_objective
    X, y = bench_data(n or N_ROWS, f or N_FEATURES)
    mapper = fit_bin_mapper(X, max_bin=255)
    if rows is not None:
        X, y = X[:rows], y[:rows]
    bins = mapper.transform(X, DEV)
    obj = get_objective("binary")
    w = np.ones(len(y))
    obj.prepare(y, w)
    scores = torch.full((len(y),), obj.init_score(y, w), device=DEV)
    yt = torch.as_tensor(y, dtype=torch.float32, device=DEV)
    g, h = obj.grad_hess(scores, yt, torch.ones_like(yt))
    gh = torch.stack([g, h, torch.ones_like(g)], dim=1)
    # int32 mode: integer codes on a 127-step grid per channel
    scale = gh.abs().amax(0).clamp(min=1e-30) / 127
    gh_int = torch.round(gh / scale).to(torch.int32)
    return bins, mapper.num_total_bins, gh, gh_int


def compare(kern, plain, gh_abs_hist, accum):
    import torch
    if accum == "int32":
        return torch.equal(kern, plain), 0.0
    err = (kern - plain).abs()
    tol = RTOL * plain.abs() + ATOL_ULPS * 2.0 ** -24 * gh_abs_hist
    return bool((err <= tol).all()), float(err.max())


def _segment_row(inputs, row_order, cnt, accum):
    """hist_segment at ``cnt`` rows against its twin: match, times, the
    device time alone and the bound."""
    import torch
    from mmlspark_tpu_torch.ops import cuda_histogram as ch
    bins, B, gh, gh_int = inputs
    n, f = bins.shape
    ghm = gh_int if accum == "int32" else gh
    ghv = ch._gh_values(ghm, accum)
    off = (n - cnt) // 3

    def kernel():
        return ch.histogram_cuda_fused(bins, ghm, row_order, off, cnt, B,
                                       accum)

    kern = kernel()
    plain = ch.histogram_fused_plain(bins, ghm, row_order, off, cnt, B,
                                     accum)
    torch.cuda.synchronize()
    good, err = compare(kern, plain, ch.histogram_fused_plain(
        bins, ghv.abs().float(), row_order, off, cnt, B), accum)
    seg = row_order[off:off + cnt].long()
    flat = (bins[seg].long() + torch.arange(f, device=DEV) * B).reshape(-1)
    rep = ghv[seg].repeat_interleave(f, 0)
    lib_out = torch.zeros(f * B, 3, dtype=kern.dtype, device=DEV)
    bms, by = bound_ms(cnt * (f + 12 + 4) + f * B * 12, cnt * f * 3)
    return {"kernel": "hist_segment", "accum": accum, "rows": cnt,
            "features": f, "match": good, "max_abs_err": err,
            "ms": median_ms(kernel),
            "device_ms": device_ms(kernel, "hist_segment_kernel"),
            "plain_ms": median_ms(lambda: ch.histogram_fused_plain(
                bins, ghm, row_order, off, cnt, B, accum)),
            "library_ms": median_ms(lambda: lib_out.index_add_(0, flat, rep)),
            "bound_ms": bms, "bound_by": by}


def _cut(inputs, rows, features):
    """The first ``rows`` rows and ``features`` features of kernel
    inputs, contiguous: a shard or a feature slice of a mesh."""
    bins, B, gh, gh_int = inputs
    return (bins[:rows, :features].contiguous(), B, gh[:rows].contiguous(),
            gh_int[:rows].contiguous())


def _full_row(inputs, accum):
    """hist_full against its twin and against the order it states
    (``histogram_ordered`` on the CPU, bit for bit), repeated calls
    against the first (f32), with its call, alone and enqueue times, the
    twin's and one ``index_add_``'s, and the bound."""
    import torch
    from mmlspark_tpu_torch.ops import cuda_histogram as ch
    bins, B, gh, gh_int = inputs
    n, f = bins.shape
    ghm = gh_int if accum == "int32" else gh
    ghv = ch._gh_values(ghm, accum)

    def kernel():
        return ch.histogram_cuda(bins, ghm, B, accum)

    kern = kernel()
    plain = ch.histogram_plain(bins, ghm, B, accum)
    torch.cuda.synchronize()
    good, err = compare(kern, plain,
                        ch.histogram_plain(bins, ghv.abs().float(), B), accum)
    geom = ch.full_launch_geometry(n, f, B, accum, bins.device)
    ordered = torch.equal(kern.cpu(), ch.histogram_ordered(
        bins.cpu(), ghm.cpu(), B, accum, geom))
    repeats = None
    if accum == "float32":
        repeats = all(torch.equal(kernel(), kern) for _ in range(19))
    flat = (bins.long() + torch.arange(f, device=DEV) * B).reshape(-1)
    rep = ghv.repeat_interleave(f, 0)
    lib_out = torch.zeros(f * B, 3, dtype=kern.dtype, device=DEV)
    bms, by = bound_ms(n * f + n * 12 + f * B * 12, n * f * 3)
    row = {"kernel": "hist_full", "accum": accum, "rows": n, "features": f,
           "geometry": geom._asdict(),
           "match": good and ordered and repeats is not False,
           "order_exact": ordered, "repeats_identical": repeats,
           "max_abs_err": err, "ms": median_ms(kernel),
           "device_ms": device_ms(kernel, "hist_full_kernel"),
           "enqueue_us": enqueue_us(kernel),
           "plain_ms": median_ms(lambda: ch.histogram_plain(
               bins, ghm, B, accum)),
           "library_ms": median_ms(lambda: lib_out.index_add_(0, flat, rep)),
           "bound_ms": bms, "bound_by": by}
    return row


def phase_kernels(state):
    import torch
    from mmlspark_tpu_torch.ops import cuda_histogram as ch
    inputs = kernel_inputs()
    bins, B, gh, gh_int = inputs
    n, f = bins.shape
    g = torch.Generator(device="cpu").manual_seed(0)
    row_order = torch.randperm(n, generator=g).to(torch.int32).to(DEV)
    wide = kernel_inputs(WIDE_ROWS, WIDE_FEATURES, WIDE_LOCAL_ROWS)
    wide_all = kernel_inputs(WIDE_ROWS, WIDE_FEATURES)
    wide_order = torch.randperm(WIDE_LOCAL_ROWS, generator=g).to(
        torch.int32).to(DEV)
    full_inputs = [inputs, _cut(inputs, MESH_SHARD_ROWS, f), wide,
                   *(_cut(wide_all, *shape) for shape in WIDE_FULL_SHAPES)]
    rows = []
    for accum in ("float32", "bfloat16", "int32"):
        rows += [_full_row(ins, accum) for ins in full_inputs]
        # segment histogram
        for cnt in SEGMENT_COUNTS:
            rows.append(_segment_row(inputs, row_order, cnt, accum))
        rows.append(_segment_row(wide, wide_order, WIDE_SEGMENT, accum))
    # the other design: hist_segment's block step over every row in order
    every = torch.arange(n, dtype=torch.int32, device=DEV)
    rows.append({**_segment_row(inputs, every, n, "float32"),
                 "kernel": "hist_segment_every_row"})
    enqueue = {}
    for cnt in (1, 777):
        off = (n - cnt) // 3
        enqueue[f"hist_segment_{cnt}_rows_us"] = enqueue_us(
            lambda: ch.histogram_cuda_fused(bins, gh, row_order, off, cnt,
                                            B))
    state["kernel_rows"] = rows
    ok = all(r["match"] for r in rows)
    if not ok:
        raise AssertionError("a kernel disagrees with its plain twin: "
                             + json.dumps([r for r in rows
                                           if not r["match"]]))
    return {"rows": rows, "enqueue": enqueue,
            "tolerance": f"int32 exact; f32/bf16 |k-p| <= "
            f"{RTOL}|p| + {ATOL_ULPS}*2^-24*sum|gh| per cell"}


def _classifier(**kw):
    from mmlspark_tpu_torch import LightGBMClassifier
    return LightGBMClassifier(learningRate=0.1, numLeaves=31, maxBin=255,
                              minDataInLeaf=20, verbosity=0, **kw)


def phase_main_path(state):
    import numpy as np
    import torch
    from mmlspark_tpu_torch.gbdt.grower import grow_tree
    from mmlspark_tpu_torch.ops import cuda_histogram as ch
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    est = _classifier(numIterations=50, device=DEV, parallelism="serial")
    warm = est.fit(table)                            # warm-up
    ch.histogram_cuda.launches = 0
    ch.histogram_cuda_fused.launches = 0
    grow_tree.host_syncs = 0
    torch.cuda.synchronize()
    with host_split() as host:
        t0 = time.perf_counter()
        model = est.fit(table)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    launches = {"hist_full": ch.histogram_cuda.launches,
                "hist_segment": ch.histogram_cuda_fused.launches}
    syncs = grow_tree.host_syncs
    t0 = time.perf_counter()
    out = model.transform(table)
    transform_s = time.perf_counter() - t0
    prob = out["probability"][:, 1]
    trees = model.getModel().trees
    splits = sum(t.num_leaves - 1 for t in trees)
    train_auc = auc(y, prob)
    state["launches"] = launches
    same = same_model_text(warm, model)
    res = {"rows": N_ROWS, "features": N_FEATURES, "iterations": 50,
           "fit_s": fit_s, "transform_s": transform_s,
           "train_auc": train_auc, "trees": len(trees), "splits": splits,
           "launches": launches, "host_syncs": syncs,
           "same_model_text": same,
           "host_s": host.spans, "segments": segment_sizes(model)}
    if prob.shape != (N_ROWS,) or not np.isfinite(prob).all():
        raise AssertionError(f"probabilities not finite of shape "
                             f"({N_ROWS},): {res}")
    if launches["hist_full"] != len(trees) or \
            launches["hist_segment"] != splits:
        raise AssertionError(f"launch counts {launches} do not match "
                             f"{len(trees)} trees / {splits} splits: {res}")
    if not train_auc >= 0.955:
        raise AssertionError(f"train AUC {train_auc} < 0.955: {res}")
    if not same:
        raise AssertionError(f"the warm-up and timed fits wrote different "
                             f"model text: {res}")
    return res


def same_model_text(a, b):
    """Whether two fitted models write the same LightGBM text, byte for
    byte: the card fit's result is the same run to run."""
    return (a.getModel().save_native_model_string()
            == b.getModel().save_native_model_string())


def phase_cuda_vs_cpu():
    import numpy as np
    X, y = bench_data(20_000, N_FEATURES)
    table = {"features": X, "label": y}
    models = {dev: _classifier(numIterations=5, device=dev).fit(table)
              for dev in (DEV, "cpu")}
    tg, tc = (models[d].getModel().trees for d in (DEV, "cpu"))

    def same(a, b):
        return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in
                   ("split_feature", "threshold", "left_child",
                    "right_child"))

    k = 0
    while k < min(len(tg), len(tc)) and same(tg[k], tc[k]):
        k += 1
    aucs = {d: auc(y, m.transform(table)["probability"][:, 1])
            for d, m in models.items()}
    mg = models[DEV].getModel().predict_margin(X, num_iteration=k)
    mc = models["cpu"].getModel().predict_margin(X, num_iteration=k,
                                                 device="cpu")
    diff = float((mg.cpu() - mc).abs().max()) if k else None
    res = {"matching_trees": k, "trees": [len(tg), len(tc)], "auc": aucs,
           "margin_max_abs_diff": diff}
    if k < 1:
        raise AssertionError(f"first tree differs between cuda and cpu: "
                             f"{res}")
    if abs(aucs[DEV] - aucs["cpu"]) > 0.002:
        raise AssertionError(f"AUCs differ by more than 0.002: {res}")
    if not np.allclose(mg.cpu().numpy(), mc.numpy(), rtol=1e-4, atol=1e-4):
        raise AssertionError(f"margins over {k} matching trees differ: "
                             f"{res}")
    return res


def phase_profile():
    """Where a flagship fit's time goes: ``torch.profiler`` over a
    10-iteration fit at full width, device time summed by kernel."""
    import torch
    from mmlspark_tpu_torch.gbdt import fit_bin_mapper
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    t0 = time.perf_counter()
    fit_bin_mapper(X, max_bin=255).transform(X, DEV)
    torch.cuda.synchronize()
    binning_s = time.perf_counter() - t0
    from mmlspark_tpu_torch import build_mesh
    est = _classifier(numIterations=10, device=DEV, parallelism="serial")
    serial = profiled_fit(est, table, ("hist_full", "hist_segment"))
    mesh = build_mesh(data=MESH_SHARDS, devices=[f"{DEV}:0"] * MESH_SHARDS)
    ring = _classifier(numIterations=10, device=DEV, collective="ring",
                       histogramMethod="pallas_ring").setMesh(mesh)
    auto = _classifier(numIterations=10, device=DEV, collective="ring",
                       histogramMethod="auto").setMesh(mesh)
    return {"iterations": 10, "binning_s": binning_s, **serial,
            "pallas_ring_d4": profiled_fit(
                ring, table, ("hist_full", "fused_hist_ring",
                              "ring_allreduce")),
            "auto_d4": profiled_fit(
                auto, table, ("hist_full", "hist_segment",
                              "ring_allreduce"))}


def profiled_fit(est, table, kernels):
    """One warmed fit of ``est`` under ``torch.profiler``: its wall time,
    the device's busy time and idle share, the device time of the named
    ``kernels`` (``<name>_kernel``), the busiest kernels, the host
    operations with the most host time of their own, and the fit's
    segment sizes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    est.fit(table)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = est.fit(table)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    dev, host = {}, {}
    for e in prof.key_averages():
        own = getattr(e, "self_cpu_time_total", 0) or 0
        if own > 0:
            host[e.key] = (own / 1e3, e.count)
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0 and getattr(e, "device_type", None) == \
                torch.autograd.DeviceType.CUDA:
            dev[e.key] = (dev.get(e.key, (0.0, 0))[0] + t / 1e3,
                          dev.get(e.key, (0.0, 0))[1] + e.count)
    busy = sum(v[0] for v in dev.values())
    ours = {k: sum(v[0] for n, v in dev.items() if f"{k}_kernel" in n)
            for k in kernels}
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:8]
    return {"fit_s_profiled": wall_s,
            "device_busy_ms": busy if dev else None,
            "device_idle_share": 1 - busy / (wall_s * 1e3) if dev else None,
            "kernels_ms": ours,
            "top_kernels": [{"name": k[:90], "ms": v[0], "count": v[1]}
                            for k, v in top],
            "top_host": [{"name": k[:60], "ms": v[0], "count": v[1]}
                         for k, v in sorted(host.items(),
                                            key=lambda kv: -kv[1][0])[:10]],
            "segments": segment_sizes(model)}


def allreduce_bound_ms(payload_bytes, shards, one_card, seg_bytes=None,
                       seg_ops=0):
    """Bound of an all-reduce of D partials of ``payload_bytes`` (f32
    adds): what the function must move, not what the ring moves through
    its comm slots.  Each shard reads its partial and writes its output;
    where the kernel makes the partial itself from a segment
    (``seg_bytes`` to read, ``seg_ops`` operations), it reads the segment
    instead.  All D shards on one card: D times that through device
    memory.  One shard a card: that per card, and 2(D-1)/D of the payload
    over NVLink each way."""
    D = shards
    per_shard = payload_bytes + (payload_bytes if seg_bytes is None
                                 else seg_bytes)
    adds = (D - 1) * payload_bytes // 4
    if one_card:
        return bound_ms(D * per_shard, D * seg_ops + adds)
    return bound_ms(per_shard, seg_ops + adds / D,
                    wire_bytes=2 * (D - 1) * payload_bytes / D)


def _ring_rows(devices, tag, shapes=RING_SHAPES, route=None):
    """ring_allreduce against its twin, exactly, on the mesh ``devices``:
    through the wrapper (``route`` None, the route the mesh's layout
    picks), or on the kernel of ``route`` (``"ring"`` on one card)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core.mesh import build_mesh
    from mmlspark_tpu_torch.ops import collectives as co
    from mmlspark_tpu_torch.ops import cuda_ring as cr
    mesh = build_mesh(devices=devices)
    D = len(mesh)
    one_card = len(set(mesh.devices)) == 1
    if route is None:
        route, call = cr.ring_route(mesh.devices), cr.ring_allreduce_cuda
    else:
        def call(parts, mesh):
            return cr._allreduce(parts, mesh, route)
    rows = []
    for k, shape in enumerate(shapes):
        rng = np.random.default_rng(100 * D + k)
        parts = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(d) for d in mesh.devices]
        got = call(parts, mesh)
        want = co.ring_allreduce_plain(parts)
        torch.cuda.synchronize()
        exact = all(torch.equal(g.to(want.device), want) for g in got)
        err = max(float((g.to(want.device) - want).abs().max())
                  for g in got)
        if one_card:
            def library():
                return torch.stack(parts).sum(0)
        else:
            def library():
                return torch.cuda.comm.reduce_add(parts, mesh.devices[0])
        bms, by = allreduce_bound_ms(want.numel() * 4, D, one_card)
        rows.append({"kernel": "ring_allreduce", "mesh": tag, "shards": D,
                     "shape": list(shape), "accum": "float32",
                     "route": route, "match": exact, "max_abs_err": err,
                     "ms": median_ms(lambda: call(parts, mesh)),
                     "device_ms": device_ms(lambda: call(parts, mesh),
                                            "ring_allreduce_kernel"),
                     "enqueue_us": enqueue_us(lambda: call(parts, mesh)),
                     "plain_ms": median_ms(
                         lambda: co.ring_allreduce_plain(parts)),
                     "library_ms": median_ms(library),
                     "bound_ms": bms, "bound_by": by})
    return rows


def _select_rows(devices, tag, shapes=SELECT_SHAPES, route=None):
    """ring_allreduce_select against its twin, exactly, on the mesh
    ``devices``, through the wrapper or on the kernel of ``route`` (as
    :func:`_ring_rows`)."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core.mesh import build_mesh
    from mmlspark_tpu_torch.ops import collectives as co
    from mmlspark_tpu_torch.ops import cuda_ring as cr
    mesh = build_mesh(devices=devices)
    D = len(mesh)
    one_card = len(set(mesh.devices)) == 1
    if route is None:
        route = cr.ring_route(mesh.devices)
        call = cr.ring_allreduce_select_cuda
    else:
        def call(parts, cand, mesh):
            return cr._allreduce_select(parts, cand, mesh, route)
    rows = []
    for k, (shape, cand_shape) in enumerate(shapes):
        rng = np.random.default_rng(200 * D + k)
        lead = len(cand_shape) - 1
        f = shape[lead]
        cand_np = np.stack([
            rng.choice(f, size=cand_shape[-1], replace=False)
            for _ in range(int(np.prod(cand_shape[:-1])))]).astype(np.int32)
        cand = torch.from_numpy(cand_np.reshape(cand_shape)).to(devices[0])
        parts = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(d) for d in mesh.devices]
        got = call(parts, cand, mesh)
        want = co.ring_allreduce_select_plain(parts, cand)
        torch.cuda.synchronize()
        exact = all(torch.equal(g.to(want.device), want) for g in got)
        err = max(float((g.to(want.device) - want).abs().max())
                  for g in got)
        # yardstick: one index_select per shard over the flattened
        # (m·f, B, 3) view, then a stacked sum
        flat = [p.reshape((-1,) + tuple(shape[lead + 1:])) for p in parts]
        rows_idx = (torch.arange(cand_np.shape[0], device=devices[0])[:, None]
                    * f + cand.reshape(cand_np.shape).long()).reshape(-1)
        idx = [rows_idx.to(p.device) for p in parts]

        def library():
            return torch.stack([p.index_select(0, i).to(devices[0])
                                for p, i in zip(flat, idx)]).sum(0)

        bms, by = allreduce_bound_ms(want.numel() * 4, D, one_card)
        rows.append({"kernel": "ring_allreduce_select", "mesh": tag,
                     "shards": D, "shape": list(shape),
                     "cand": list(cand_shape), "accum": "float32",
                     "route": route, "match": exact, "max_abs_err": err,
                     "ms": median_ms(lambda: call(parts, cand, mesh)),
                     "device_ms": device_ms(lambda: call(parts, cand, mesh),
                                            "ring_select_kernel"),
                     "enqueue_us": enqueue_us(lambda: call(parts, cand,
                                                           mesh)),
                     "plain_ms": median_ms(
                         lambda: co.ring_allreduce_select_plain(parts, cand)),
                     "library_ms": median_ms(library),
                     "bound_ms": bms, "bound_by": by})
    return rows


def _fused_rows(devices, tag, inputs):
    """fused_segment_hist_ring against its twin on the flagship matrix cut
    into len(devices) shards (shard d holds rows [d·S, (d+1)·S))."""
    import torch
    from mmlspark_tpu_torch.core.mesh import build_mesh
    from mmlspark_tpu_torch.ops import collectives as co
    from mmlspark_tpu_torch.ops import cuda_histogram as ch
    from mmlspark_tpu_torch.ops import cuda_ring as cr
    bins, B, gh, gh_int = inputs
    mesh = build_mesh(devices=devices)
    D = len(mesh)
    one_card = len(set(mesh.devices)) == 1
    n, f = bins.shape
    S = n // D
    g = torch.Generator(device="cpu").manual_seed(D)
    local = [(bins[d * S:(d + 1) * S].to(dev),
              torch.randperm(S, generator=g).to(torch.int32).to(dev), d)
             for d, dev in enumerate(mesh.devices)]
    rows = []
    for accum in ("float32", "int32"):
        ghm = gh_int if accum == "int32" else gh
        ghv = ch._gh_values(ghm, accum)
        for cnt in SHARD_SEGMENT_COUNTS:
            cnt = min(cnt, S)
            offs = [(S - cnt) // (3 + d) for d in range(D)]

            def shards_of(values):
                return [(b, values[d * S:(d + 1) * S].to(b.device), o,
                         offs[d], cnt) for b, o, d in local]

            shards = shards_of(ghm)
            got = co.fused_segment_hist_ring(shards, B, mesh, accum)
            want = co.fused_segment_hist_ring_plain(shards, B, accum)
            torch.cuda.synchronize()
            abs_hist = co.fused_segment_hist_ring_plain(
                shards_of(ghv.abs().float()), B)
            checks = [compare(x.to(want.device), want, abs_hist, accum)
                      for x in got]
            good = all(c[0] for c in checks)
            err = max(c[1] for c in checks)
            # yardstick: one index_add_ over every shard's segment
            segs = [o[off:off + cnt].long() + d * S
                    for (_, o, d), off in zip(local, offs)]
            seg = torch.cat([s.to(bins.device) for s in segs])
            flat = (bins[seg].long()
                    + torch.arange(f, device=bins.device) * B).reshape(-1)
            rep = ghv[seg].repeat_interleave(f, 0)
            lib_out = torch.zeros(f * B, 3, dtype=want.dtype,
                                  device=bins.device)
            # each segment row's bins, gh and row id
            bms, by = allreduce_bound_ms(f * B * 3 * 4, D, one_card,
                                         cnt * (f + 12 + 4), cnt * f * 3)
            rows.append({"kernel": "fused_segment_hist_ring", "mesh": tag,
                         "shards": D, "accum": accum, "rows": cnt,
                         "match": good, "max_abs_err": err,
                         "ms": median_ms(
                             lambda: cr.fused_segment_hist_ring_cuda(
                                 shards, B, mesh, accum)),
                         "device_ms": device_ms(
                             lambda: cr.fused_segment_hist_ring_cuda(
                                 shards, B, mesh, accum),
                             "fused_hist_ring_kernel"),
                         "plain_ms": median_ms(
                             lambda: co.fused_segment_hist_ring_plain(
                                 shards, B, accum)),
                         "library_ms": median_ms(
                             lambda: lib_out.index_add_(0, flat, rep)),
                         "bound_ms": bms, "bound_by": by})
            if cnt in (1, 777):
                rows[-1]["enqueue_us"] = enqueue_us(
                    lambda: cr.fused_segment_hist_ring_cuda(
                        shards, B, mesh, accum))
            del flat, rep, lib_out
    return rows


def _check_rows(rows):
    bad = [r for r in rows if not r["match"]]
    if bad:
        raise AssertionError("a ring kernel disagrees with its plain twin: "
                             + json.dumps(bad))


def phase_collectives(state):
    import torch
    dev = torch.device(DEV, 0)
    inputs = kernel_inputs()
    rows, ring_kernels = [], []
    for D in RING_SHARDS:
        mesh = [dev] * D
        rows += _ring_rows(mesh, "virtual")
        rows += _select_rows(mesh, "virtual")
        rows += _fused_rows(mesh, "virtual", inputs)
        # the ring kernels that meshes spanning cards take, on one card
        ring_kernels += _ring_rows(mesh, "virtual", RING_SHAPES[:1], "ring")
        ring_kernels += _select_rows(mesh, "virtual", SELECT_SHAPES[:1],
                                     "ring")
    state["ring_rows"] = rows
    rows = rows + ring_kernels
    _check_rows(rows)
    return {"rows": rows, "tolerance": "ring_allreduce and "
            "ring_allreduce_select exact (torch.equal); "
            "fused_segment_hist_ring int32 exact, f32 "
            f"|k-p| <= {RTOL}|p| + {ATOL_ULPS}*2^-24*sum|gh| per cell",
            "bound": "bytes at 3.35 TB/s: ring_allreduce reads the D "
            "partials and writes the D outputs; ring_allreduce_select reads "
            "the D gathered slabs and writes the D outputs; "
            "fused_segment_hist_ring reads each segment row's bins, gh and "
            "row id and writes the D outputs (the ring's comm-slot traffic "
            "is not counted)"}


def phase_collectives_cross_card():
    import torch
    cards = torch.cuda.device_count()
    if cards < 2:
        return {"ran": False, "cards": cards}
    devices = [torch.device(DEV, i) for i in range(min(cards, 4))]
    rows = (_ring_rows(devices, "cards") + _select_rows(devices, "cards")
            + _fused_rows(devices, "cards", kernel_inputs()))
    _check_rows(rows)
    return {"ran": True, "cards": cards, "rows": rows}


def phase_mesh_path(state):
    import numpy as np
    import torch
    from mmlspark_tpu_torch import build_mesh
    from mmlspark_tpu_torch.gbdt.grower import grow_tree
    counters = _counters()
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    mesh = build_mesh(data=MESH_SHARDS,
                      devices=[f"{DEV}:0"] * MESH_SHARDS)
    fits = {}
    for method in ("auto", "pallas_ring"):
        est = _classifier(numIterations=50, device=DEV, collective="ring",
                          histogramMethod=method).setMesh(mesh)
        warm = est.fit(table)                        # warm-up
        for fn in counters.values():
            fn.launches = 0
        grow_tree.host_syncs = 0
        torch.cuda.synchronize()
        with host_split() as host:
            t0 = time.perf_counter()
            model = est.fit(table)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        prob = model.transform(table)["probability"][:, 1]
        trees = model.getModel().trees
        splits = sum(t.num_leaves - 1 for t in trees)
        res = {"shards": MESH_SHARDS, "fit_s": fit_s,
               "train_auc": auc(y, prob), "trees": len(trees),
               "splits": splits, "launches": launches,
               "host_syncs": grow_tree.host_syncs,
               "same_model_text": same_model_text(warm, model),
               "host_s": host.spans}
        fits[method] = res
        if prob.shape != (N_ROWS,) or not np.isfinite(prob).all():
            raise AssertionError(f"{method}: probabilities not finite of "
                                 f"shape ({N_ROWS},): {res}")
        want = ({"ring_allreduce": len(trees) + splits,
                 "fused_segment_hist_ring": 0} if method == "auto" else
                {"ring_allreduce": len(trees),
                 "fused_segment_hist_ring": splits})
        got = {k: launches[k] for k in want}
        if got != want or launches["hist_full"] != MESH_SHARDS * len(trees) \
                or (method == "auto" and launches["hist_segment"] == 0):
            raise AssertionError(f"{method}: launch counts {launches} do "
                                 f"not match {len(trees)} trees / {splits} "
                                 f"splits on {MESH_SHARDS} shards: {res}")
        if not res["train_auc"] >= 0.955:
            raise AssertionError(f"{method}: train AUC {res['train_auc']} "
                                 f"< 0.955: {res}")
    state["mesh_launches"] = {
        "ring_allreduce": fits["auto"]["launches"]["ring_allreduce"],
        "fused_segment_hist_ring":
            fits["pallas_ring"]["launches"]["fused_segment_hist_ring"]}
    return {"rows": N_ROWS, "features": N_FEATURES, "iterations": 50,
            "fits": fits, "card_vs_cpu": _mesh_card_vs_cpu()}


def _mesh_card_vs_cpu():
    """A 20,000 × 50, 5-iteration D = 4 ring fit on the card (both
    histogram methods) and on ``devices=["cpu"] * 4``."""
    import numpy as np
    from mmlspark_tpu_torch import build_mesh
    X, y = bench_data(20_000, N_FEATURES)
    table = {"features": X, "label": y}
    keys = ("split_feature", "threshold", "left_child", "right_child")
    fits = {}
    for name, dev, method in (("cpu", "cpu", "auto"),
                              ("cuda_auto", f"{DEV}:0", "auto"),
                              ("cuda_pallas_ring", f"{DEV}:0",
                               "pallas_ring")):
        est = _classifier(numIterations=5, device=dev.split(":")[0],
                          collective="ring", histogramMethod=method)
        fits[name] = est.setMesh(build_mesh(
            devices=[dev] * MESH_SHARDS)).fit(table)
    ref = fits.pop("cpu")
    res = {"auc_cpu": auc(y, ref.transform(table)["probability"][:, 1])}
    for name, m in fits.items():
        same = all(np.array_equal(getattr(m.getModel().trees[0], k),
                                  getattr(ref.getModel().trees[0], k))
                   for k in keys)
        a = auc(y, m.transform(table)["probability"][:, 1])
        res[name] = {"first_tree_equal": same, "auc": a}
        if not same or abs(a - res["auc_cpu"]) > 0.002:
            raise AssertionError(f"{name}: the D = {MESH_SHARDS} card fit "
                                 f"differs from the cpu mesh fit: {res}")
    return res


def _counters():
    from mmlspark_tpu_torch.ops import cuda_histogram as ch
    from mmlspark_tpu_torch.ops import cuda_ring as cr
    return {"hist_full": ch.histogram_cuda,
            "hist_segment": ch.histogram_cuda_fused,
            "ring_allreduce": cr.ring_allreduce_cuda,
            "ring_allreduce_select": cr.ring_allreduce_select_cuda,
            "fused_segment_hist_ring": cr.fused_segment_hist_ring_cuda}


def phase_voting_path(state):
    """The wide configuration under each learner on four virtual devices
    of the card, then a small voting fit on the card against the CPU."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import build_mesh
    from mmlspark_tpu_torch.gbdt import engine
    from mmlspark_tpu_torch.gbdt.grower import grow_tree
    counters = _counters()
    X, y = bench_data(WIDE_ROWS, WIDE_FEATURES)
    table = {"features": X, "label": y}
    card = [f"{DEV}:0"] * MESH_SHARDS
    learners = {
        "data": (build_mesh(data=MESH_SHARDS, devices=card),
                 dict(parallelism="data", collective="ring")),
        "voting": (build_mesh(data=MESH_SHARDS, devices=card),
                   dict(parallelism="voting", collective="ring",
                        topK=WIDE_TOP_K)),
        "feature": (build_mesh(1, MESH_SHARDS, devices=card),
                    dict(parallelism="feature")),
        "data+feature": (build_mesh(2, MESH_SHARDS // 2, devices=card),
                         dict(parallelism="data+feature")),
    }
    fits = {}
    for name, (mesh, kw) in learners.items():
        est = _classifier(numIterations=WIDE_ITERATIONS, maxDepth=30,
                          device=DEV, **kw).setMesh(mesh)
        warm = est.fit(table)                        # warm-up
        for fn in counters.values():
            fn.launches = 0
        grow_tree.host_syncs = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = est.fit(table)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        syncs = grow_tree.host_syncs
        info = dict(engine.last_fit_info)
        prob = model.transform(table)["probability"][:, 1]
        trees = model.getModel().trees
        if prob.shape != (WIDE_ROWS,) or not np.isfinite(prob).all():
            raise AssertionError(f"{name}: probabilities not finite of "
                                 f"shape ({WIDE_ROWS},)")
        fits[name] = {
            "mesh": mesh.shape, "fit_s": fit_s, "train_auc": auc(y, prob),
            "trees": len(trees),
            "splits": sum(t.num_leaves - 1 for t in trees),
            "launches": launches, "host_syncs": syncs,
            "same_model_text": same_model_text(warm, model),
            "collective": info["collective"],
            "collective_downgrade": info["collective_downgrade"],
            "collectives_per_tree": int(info["collective_count_per_tree"]),
            "payload_bytes_per_tree":
                int(info["collective_payload_bytes_per_tree"]),
            "payload_vs_dense": float(info["collective_payload_vs_dense"])}
    vote = fits["voting"]
    state["voting_launches"] = vote["launches"]["ring_allreduce_select"]
    mesh, kw = learners["voting"]
    profile = profiled_fit(
        _classifier(numIterations=WIDE_ITERATIONS, maxDepth=30, device=DEV,
                    **kw).setMesh(mesh), table,
        ("hist_full", "hist_segment", "ring_select"))
    res = {"rows": WIDE_ROWS, "features": WIDE_FEATURES,
           "iterations": WIDE_ITERATIONS, "top_k": WIDE_TOP_K,
           "fits": fits, "voting_profile": profile,
           "card_vs_cpu": _voting_card_vs_cpu()}
    want = {"ring_allreduce_select": vote["trees"] + vote["splits"],
            "ring_allreduce": 0, "fused_segment_hist_ring": 0,
            "hist_full": MESH_SHARDS * vote["trees"]}
    got = {k: vote["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"voting: launch counts {got} != {want}: "
                             f"{res}")
    if vote["payload_vs_dense"] != 0.063012:
        raise AssertionError(f"voting: payload/dense "
                             f"{vote['payload_vs_dense']} != 0.063012")
    if abs(vote["train_auc"] - fits["data"]["train_auc"]) > 0.01:
        raise AssertionError(f"voting AUC {vote['train_auc']} is not within "
                             f"0.01 of the data fit's: {res}")
    return res


def _voting_card_vs_cpu():
    """A 20,000 × 50, 5-iteration D = 4 voting ring fit (topK 5) on the
    card and on ``devices=["cpu"] * 4``."""
    import numpy as np
    from mmlspark_tpu_torch import build_mesh
    X, y = bench_data(20_000, N_FEATURES)
    table = {"features": X, "label": y}
    models = {}
    for dev in (f"{DEV}:0", "cpu"):
        est = _classifier(numIterations=5, device=dev.split(":")[0],
                          collective="ring", parallelism="voting", topK=5)
        models[dev] = est.setMesh(build_mesh(
            devices=[dev] * MESH_SHARDS)).fit(table)
    card, cpu = (models[d].getModel().trees[0] for d in (f"{DEV}:0", "cpu"))
    same = all(np.array_equal(getattr(card, k), getattr(cpu, k)) for k in
               ("split_feature", "threshold", "left_child", "right_child"))
    aucs = {d: auc(y, m.transform(table)["probability"][:, 1])
            for d, m in models.items()}
    res = {"first_tree_equal": same, "auc": aucs}
    if not same or abs(aucs[f"{DEV}:0"] - aucs["cpu"]) > 0.002:
        raise AssertionError(f"the D = {MESH_SHARDS} voting card fit "
                             f"differs from the cpu fit: {res}")
    return res


def kernels_line(state):
    rows = {r["kernel"]: r for r in state.get("kernel_rows", [])
            if r["accum"] == "float32"
            and r.get("features", N_FEATURES) == N_FEATURES
            and r["rows"] in (N_ROWS, max(SEGMENT_COUNTS))}
    main_shape = {"ring_allreduce": list(RING_SHAPES[0]),
                  "ring_allreduce_select": list(SELECT_SHAPES[0][0])}
    for r in state.get("ring_rows", []):
        if r["shards"] == MESH_SHARDS and r["accum"] == "float32" and (
                r.get("shape") == main_shape.get(r["kernel"])
                or r.get("rows") == max(SHARD_SEGMENT_COUNTS)):
            rows[r["kernel"]] = r
    launches = {**state.get("launches", {}),
                **state.get("mesh_launches", {}),
                "ring_allreduce_select": state.get("voting_launches", 0)}
    out = []
    for name in REPLACES:
        r = rows.get(name, {})
        out.append({"name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name],
                    "launches": launches.get(name, 0),
                    "max_abs_err": r.get("max_abs_err"),
                    "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                    "bound_ms": r.get("bound_ms"),
                    "bound_by": r.get("bound_by"),
                    "library_ms": r.get("library_ms"),
                    "device_ms": r.get("device_ms"),
                    "rows": r.get("rows"), "shards": r.get("shards", 1)})
    return {"kernels": out}


def main(argv) -> int:
    import torch
    only = None
    if argv:
        if len(argv) != 2 or argv[0] != "--phases":
            print("usage: chip_smoke.py [--phases NAME[,NAME...]]",
                  file=sys.stderr)
            return 2
        only = set(argv[1].split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    try:
        import mmlspark_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import mmlspark_tpu_torch ({e}); run "
              "it from the root of the repository", file=sys.stderr)
        return 2
    state = {}
    failed = []
    env = None
    phases = [("environment", phase_environment),
              ("build", phase_build),
              ("kernels", lambda: phase_kernels(state)),
              ("main_path", lambda: phase_main_path(state)),
              ("cuda_vs_cpu", phase_cuda_vs_cpu),
              ("profile", phase_profile),
              ("collectives", lambda: phase_collectives(state)),
              ("mesh_path", lambda: phase_mesh_path(state)),
              ("voting_path", lambda: phase_voting_path(state)),
              ("collectives_cross_card", phase_collectives_cross_card)]
    if only is not None:
        unknown = only - {name for name, _ in phases}
        if unknown:
            print(f"chip_smoke: unknown phases {sorted(unknown)}",
                  file=sys.stderr)
            return 2
        phases = [(name, fn) for name, fn in phases
                  if name in only | {"environment", "build"}]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
            ok = True
        except Exception as e:  # noqa: BLE001 - report the phase, go on
            res = {"error": f"{type(e).__name__}: {e}"}
            ok = False
            failed.append(name)
            if name == "build":
                emit({"phase": name, "ok": ok, **res})
                break
        if name == "environment":
            env = res
        emit({"phase": name, "ok": ok,
              "seconds": time.perf_counter() - t0, **res})
    if only is None:
        emit(kernels_line(state))
    if env is not None:
        print(env["nvidia_smi"], flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if only is not None:
        return 0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
