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
   shapes (400,000 × 50 rows × features, B = 256; the segment kernel at
   cnt ∈ {1, 777, 200,000}) against its plain PyTorch twin on the same
   inputs, with the median time of 20 launches after warm-up (CUDA
   events) of the kernel, the twin and a one-call ``index_add_``
   yardstick.
4. main_path — LightGBMClassifier fit → transform at the flagship width
   (400,000 × 50, 50 iterations, 31 leaves, 255 bins), warm-up fit first;
   the launch counts of the timed fit must equal the trees grown (root
   histograms) and the splits made (segment histograms); train AUC must
   reach 0.955.
5. cuda_vs_cpu — the same classifier at 20,000 × 50 and 5 iterations on
   the kernels and on the plain CPU path: identical first tree, AUCs
   within 0.002, margins close over the trees whose structure matches.
6. profile — where a 10-iteration flagship fit spends its time:
   ``torch.profiler`` device time by kernel, the device's idle share, and
   the host binning pass timed alone.

Then the ``{"kernels": [...]}`` line, the card line, and last the
``{"ok": true, ...}`` line.  Any failed phase makes the script exit 1
without that last line.
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
N_ROWS, N_FEATURES = 400_000, 50
SEGMENT_COUNTS = (1, 777, 200_000)
#: f32/bf16 kernel-vs-twin tolerance: |k - p| <= RTOL |p| + ATOL_ULPS u
#: sum|gh| per cell.  Both sides add the same values in different orders
#: (atomics on each); a sum of m terms in any order is off by at most
#: (m-1) u sum|x|, and by about sqrt(m) u sum|x| for random orders — about
#: 40 u sum|x| at the ~1,600 rows of a cell at 400,000 rows and 256 bins.
RTOL, ATOL_ULPS = 1e-5, 256
REPLACES = {
    "hist_full": "mmlspark_tpu/ops/pallas_histogram.py:384",
    "hist_segment": "mmlspark_tpu/ops/pallas_histogram.py:148",
}
SOURCE = "mmlspark_tpu_torch/csrc/histogram.cu"
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


def bound_ms(n_bytes, n_ops):
    t = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
    return t * 1e3, ("bytes" if n_bytes / HBM_BYTES_PER_S
                     >= n_ops / F32_OPS_PER_S else "operations")


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


def kernel_inputs():
    """Binned 400k × 50 matrix and gradient triples of the main path's
    first tree (binary objective at the init score), on the card."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.gbdt import fit_bin_mapper, get_objective
    X, y = bench_data(N_ROWS, N_FEATURES)
    mapper = fit_bin_mapper(X, max_bin=255)
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


def phase_kernels(state):
    import torch
    from mmlspark_tpu_torch.ops import cuda_histogram as ch
    bins, B, gh, gh_int = kernel_inputs()
    n, f = bins.shape
    g = torch.Generator(device="cpu").manual_seed(0)
    row_order = torch.randperm(n, generator=g).to(torch.int32).to(DEV)
    rows = []
    ok = True
    for accum in ("float32", "bfloat16", "int32"):
        ghm = gh_int if accum == "int32" else gh
        ghv = ch._gh_values(ghm, accum)
        gh_abs = ghv.abs().float()
        # full histogram
        kern = ch.histogram_cuda(bins, ghm, B, accum)
        plain = ch.histogram_plain(bins, ghm, B, accum)
        torch.cuda.synchronize()
        good, err = compare(kern, plain,
                            ch.histogram_plain(bins, gh_abs, B), accum)
        flat = (bins.long() + torch.arange(f, device=DEV) * B).reshape(-1)
        rep = ghv.repeat_interleave(f, 0)
        lib_out = torch.zeros(f * B, 3, dtype=kern.dtype, device=DEV)
        bms, by = bound_ms(n * f + n * 12 + f * B * 12, n * f * 3)
        rows.append({"kernel": "hist_full", "accum": accum, "rows": n,
                     "match": good, "max_abs_err": err,
                     "ms": median_ms(lambda: ch.histogram_cuda(
                         bins, ghm, B, accum)),
                     "plain_ms": median_ms(lambda: ch.histogram_plain(
                         bins, ghm, B, accum)),
                     "library_ms": median_ms(
                         lambda: lib_out.index_add_(0, flat, rep)),
                     "bound_ms": bms, "bound_by": by})
        ok &= good
        del flat, rep, lib_out
        # segment histogram
        for cnt in SEGMENT_COUNTS:
            off = (n - cnt) // 3
            kern = ch.histogram_cuda_fused(bins, ghm, row_order, off, cnt, B,
                                           accum)
            plain = ch.histogram_fused_plain(bins, ghm, row_order, off, cnt,
                                             B, accum)
            torch.cuda.synchronize()
            good, err = compare(kern, plain, ch.histogram_fused_plain(
                bins, gh_abs, row_order, off, cnt, B), accum)
            seg = row_order[off:off + cnt].long()
            flat = (bins[seg].long()
                    + torch.arange(f, device=DEV) * B).reshape(-1)
            rep = ghv[seg].repeat_interleave(f, 0)
            lib_out = torch.zeros(f * B, 3, dtype=kern.dtype, device=DEV)
            bms, by = bound_ms(cnt * (f + 12 + 4) + f * B * 12,
                               cnt * f * 3)
            rows.append({"kernel": "hist_segment", "accum": accum,
                         "rows": cnt, "match": good, "max_abs_err": err,
                         "ms": median_ms(lambda: ch.histogram_cuda_fused(
                             bins, ghm, row_order, off, cnt, B, accum)),
                         "plain_ms": median_ms(
                             lambda: ch.histogram_fused_plain(
                                 bins, ghm, row_order, off, cnt, B, accum)),
                         "library_ms": median_ms(
                             lambda: lib_out.index_add_(0, flat, rep)),
                         "bound_ms": bms, "bound_by": by})
            ok &= good
    state["kernel_rows"] = rows
    if not ok:
        raise AssertionError("a kernel disagrees with its plain twin: "
                             + json.dumps([r for r in rows
                                           if not r["match"]]))
    return {"rows": rows, "tolerance": f"int32 exact; f32/bf16 |k-p| <= "
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
    est = _classifier(numIterations=50, device=DEV)
    est.fit(table)                                   # warm-up
    ch.histogram_cuda.launches = 0
    ch.histogram_cuda_fused.launches = 0
    grow_tree.host_syncs = 0
    torch.cuda.synchronize()
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
    res = {"rows": N_ROWS, "features": N_FEATURES, "iterations": 50,
           "fit_s": fit_s, "transform_s": transform_s,
           "train_auc": train_auc, "trees": len(trees), "splits": splits,
           "launches": launches, "host_syncs": syncs}
    if prob.shape != (N_ROWS,) or not np.isfinite(prob).all():
        raise AssertionError(f"probabilities not finite of shape "
                             f"({N_ROWS},): {res}")
    if launches["hist_full"] != len(trees) or \
            launches["hist_segment"] != splits:
        raise AssertionError(f"launch counts {launches} do not match "
                             f"{len(trees)} trees / {splits} splits: {res}")
    if not train_auc >= 0.955:
        raise AssertionError(f"train AUC {train_auc} < 0.955: {res}")
    return res


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
    from torch.profiler import ProfilerActivity, profile
    from mmlspark_tpu_torch.gbdt import fit_bin_mapper
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    t0 = time.perf_counter()
    fit_bin_mapper(X, max_bin=255).transform(X, DEV)
    torch.cuda.synchronize()
    binning_s = time.perf_counter() - t0
    est = _classifier(numIterations=10, device=DEV)
    est.fit(table)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.fit(table)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    dev = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0 and getattr(e, "device_type", None) == \
                torch.autograd.DeviceType.CUDA:
            dev[e.key] = (dev.get(e.key, (0.0, 0))[0] + t / 1e3,
                          dev.get(e.key, (0.0, 0))[1] + e.count)
    busy = sum(v[0] for v in dev.values())
    ours = {k: sum(v[0] for n, v in dev.items() if f"{k}_kernel" in n)
            for k in ("hist_full", "hist_segment")}
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:8]
    return {"iterations": 10, "fit_s_profiled": wall_s,
            "binning_s": binning_s,
            "device_busy_ms": busy if dev else None,
            "device_idle_share": 1 - busy / (wall_s * 1e3) if dev else None,
            "histogram_kernels_ms": ours,
            "top_kernels": [{"name": k[:90], "ms": v[0], "count": v[1]}
                            for k, v in top]}


def kernels_line(state):
    rows = {r["kernel"]: r for r in state.get("kernel_rows", [])
            if r["accum"] == "float32"
            and r["rows"] in (N_ROWS, max(SEGMENT_COUNTS))}
    out = []
    for name in ("hist_full", "hist_segment"):
        r = rows.get(name, {})
        out.append({"name": name, "route": "cuda", "source": SOURCE,
                    "replaces": REPLACES[name],
                    "launches": state.get("launches", {}).get(name, 0),
                    "max_abs_err": r.get("max_abs_err"),
                    "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                    "bound_ms": r.get("bound_ms"),
                    "bound_by": r.get("bound_by"),
                    "library_ms": r.get("library_ms"),
                    "rows": r.get("rows")})
    return {"kernels": out}


def main() -> int:
    import torch
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
              ("profile", phase_profile)]
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
    emit(kernels_line(state))
    if env is not None:
        print(env["nvidia_smi"], flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
