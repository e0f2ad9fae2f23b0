#!/usr/bin/env python3
"""Smoke run of mmlspark_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. environment — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, the host CPU's model and threads; exits non-zero
   without a CUDA device.
2. build — compiles every ``mmlspark_tpu_torch/csrc/*.cu`` with nvcc (one
   process per source, all started together) and prints the seconds and
   each kernel's registers; beside them the native host sources
   (``mmlspark_tpu_torch/native/*.cc``) with g++.
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
   splits the timed fit's host clock (:class:`host_split`; ``binning_s``
   is the estimator's native host binning and the copy of the codes).
   ``memory``: ``torch.cuda.max_memory_allocated()`` of the timed fit
   (the peak reset just before it) beside the fit budget's estimate
   (``gbdt/budget.py``), which must be at least the fit's own peak (the
   peak less what was allocated at the reset); efb_path's bundled,
   ranking_path's and wide_bins_path's timed fits report and check the
   same.
4b. continued_path — continued training, the Booster's serving surface
   and stage persistence on the flagship (400,000 × 50, 31 leaves, 255
   bins): a 25-iteration base fit saved as LightGBM text and its
   25-iteration ``initModelPath`` continuation (``hist_full`` 25 times
   and ``hist_segment`` once a split; the merged text's first 25 tree
   blocks equal the base's byte for byte and it records 50 iterations;
   train AUC ≥ 0.955 and within 0.002 of main_path's straight
   50-iteration fit; both fits' seconds and the largest margin gap to
   the straight fit); a 25-iteration ``initScoreCol`` fit at the base
   model's margins, whose tree blocks equal the continuation's last 25;
   5-iteration D = 4 continuations with the ring under ``auto``
   (``ring_allreduce`` once a tree and split) and ``pallas_ring``
   (``fused_hist_ring`` once a split; fitted twice, ``same_model_text``
   reported), AUC within 0.01 of the serial continuation's first 5;
   ``predictor()`` margins ``torch.equal`` to ``predict_margin`` at 1,
   64, 4,096 and 400,000 rows with the median ms of both (20 calls after
   warm-up), tree-range partials (0, 25) + (25, 50) without the init
   score summing to the margins (rtol and atol 1e-5), and a stale
   predictor raising after ``invalidate_cache()``; ``predict_leaf_index``
   on 400,000 rows, whose leaf values summed in tree order give the
   margins (rtol 1e-6); TreeSHAP on 100 rows on the host (local accuracy
   within 1e-5, its seconds); ``save`` / ``load`` of the model and of a
   ``PipelineModel`` on the card, transforms equal bit for bit; a
   5-iteration fit with ``profileTraceDir`` whose Chrome trace names
   ``hist_full`` 5 times; and a 20,000-row base 5 + continuation 5
   card-vs-CPU check: the continuation's first tree identical, the
   margins allclose 1e-4 over the matching trees.
5. cuda_vs_cpu — the same classifier at 20,000 × 50 and 5 iterations on
   the kernels and on the plain CPU path: identical first tree, AUCs
   within 0.002, margins close over the trees whose structure matches.
6. profile — where a 5-iteration flagship fit spends its time (each
   profiled fit runs without a warm-up fit of its own: main_path has
   warmed the card):
   ``torch.profiler`` device time by kernel (the profiler records the
   device alone) and the device's idle share, and the fit's binning pass
   (the mapper's fit, the native host binning and the copy of the codes)
   timed alone; the quantiles of its segment sizes
   (the smaller child of each split); then the same 5-iteration fit on
   four virtual shards under ``histogramMethod="pallas_ring"``, for the
   device time of ``fused_hist_ring`` per fit, and under ``"auto"``; and
   a 5-iteration ranking fit (``ranking_data``): the lambda gradient's
   share of the device.
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
   ``"pallas_ring"``, each a warm-up fit (cut, as in every phase after
   main_path but DART's, to ``WARM_ITERATIONS``; its trees must equal the
   timed fit's first trees byte for byte, which ``same_model_text``
   reports) and a timed fit: train AUC must
   reach 0.955, and the timed fit must launch ``ring_allreduce`` once per
   tree and split (auto) or once per tree with ``fused_segment_hist_ring``
   once per split (pallas_ring); ``host_s`` as in phase 4;
   ``same_model_text`` reported under ``auto`` and required under
   ``pallas_ring`` (``fused_hist_ring`` merges its row tiles in a fixed
   order).  Then a
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
10. categorical_path — the flagship with categorical columns
   (``categorical_data``: columns 40–49 category ids of 2 … 10,000
   categories, a label with scattered-subset terms), 50 iterations, 31
   leaves, 255 bins, ``categoricalSlotIndexes`` 40–49: a warm-up and a
   timed serial fit (fit, transform and host seconds; ``hist_full`` once
   a tree and ``hist_segment`` once a split; at least one categorical
   split; train AUC ≥ 0.955 and above the same fit with the columns left
   numeric; ``same_model_text``); a 5-iteration data-ring fit and
   voting fit (``topK`` 5) on four virtual shards of the card
   (``ring_allreduce`` / ``ring_allreduce_select`` once a tree and split,
   AUC within 0.01 of the serial fit's first 5 iterations); a
   20,000-row, 5-iteration card-vs-CPU check from the
   init score 0, where the first tree's sums are exact, serially and at
   D = 4 (data ring, voting, feature 1 × 4, ``pallas_ring``, the last
   fitted twice on the card for ``same_model_text``, reported), 3
   iterations: first tree identical, AUCs within 0.002.
11. multiclass_path — the flagship's features with five classes
   (``multiclass_data``), ``multiclass`` and ``multiclassova``, 5
   iterations (cut from 20, then 10, to hold the script's time): a
   warm-up and a timed serial fit each (25 trees and 25 ``hist_full``
   launches, train accuracy, multi-logloss of the first and the last
   iteration, which must fall, ``same_model_text``); a
   5-iteration data-ring fit on four virtual shards; a 20,000-row,
   3-iteration card-vs-CPU check: the first K trees identical and the
   probabilities allclose 1e-4 over the matching iterations.
12. validation_path — the flagship with 20% of its rows flagged by
   ``validationIndicatorCol`` (numpy ``default_rng(3)``),
   ``earlyStoppingRound`` 10 at learning rate 0.5 (300 iterations asked):
   a warm-up and a timed serial fit (the stop fires early, the model text
   records ``best_iter + 1`` iterations and the forest holds as many
   trees, one model text), the device time of one validation walk, a D =
   4 data-ring fit under the same rule, and a 20,000-row, 5-iteration
   card-vs-CPU check (``earlyStoppingRound`` 3): the same stop iteration,
   validation metrics within 1e-5 relative.
13. goss_path — the flagship under ``boostingType="goss"`` (``topRate``
   0.2, ``otherRate`` 0.1, 50 iterations): a warm-up and a timed serial
   fit (``hist_full`` 50 times on the 120,000 sampled rows, train AUC ≥
   0.955, one model text), the device time of one iteration's sampling, a
   5-iteration D = 4 data-ring fit (20,000 + 10,000 rows a shard), and a
   20,000-row, 5-iteration card-vs-CPU check: the first tree identical and
   iteration 0's sampled rows equal (``torch.equal``).
14. quantized_path — ``quantizedGrad`` "16" (max_code 5,368) and "8"
   (127) on the flagship, 25 iterations, a warm-up and a timed serial
   fit each (the int32 ``hist_full`` once a tree and ``hist_segment``
   once a split, AUC within 0.005 of main_path's f32 fit at 25
   iterations, one model text); the
   flagship on D = 4 with the ring, which the reference's gate turns to
   psum (``quantized_unsupported``); the reference's quantized
   configuration (``artifacts/bench_quant_r17.json``: max_code 3, int16
   wire) on the wide data (8,192 × 2,000, 4 iterations, 31 leaves,
   ``maxDepth`` 30) under the data ring, data ``pallas_ring`` (the int32
   ``fused_hist_ring``, fitted twice: one model text), voting (``topK``
   32) and feature 1 × 4, each with its ``quantized_*`` fit info and
   payload over the dense f32 payload; and a 20,000-row, 5-iteration
   card-vs-CPU check: the first tree identical where the g-max bits agree
   (both printed), AUCs within 0.002 where they do not.
15. objectives_path — the flagship's features with a label for each
   regression family (``objective_data``), each of ``OBJECTIVES`` fitted
   5 iterations (31 leaves, 255 bins) after one warm-up fit: fit seconds,
   the objective's LightGBM metric (``objective_loss``) at the first and
   the last iteration, which must fall, ``transform`` equal to the
   objective's ``transform_prediction`` of ``predict_margin``,
   ``hist_full`` once a tree and ``hist_segment`` once a split; a
   20,000-row, 3-iteration card-vs-CPU check of each: the first tree
   identical, the predictions close over the matching iterations.
16. dart_path — the flagship under ``boostingType="dart"`` (LightGBM's
   defaults: ``dropRate`` 0.1, ``maxDrop`` 50, ``skipDrop`` 0.5,
   ``dropSeed`` 4), 50 iterations, a warm-up and a timed fit: fit and
   transform seconds, train AUC ≥ 0.94 (``DART_MIN_AUC``), the drops of
   every iteration (some above 0), one model text, and the fit's final
   training scores equal to the exported model's margins walked over the
   bins within 1e-5 of their largest magnitude (the baked scales; the
   rows where the float thresholds route a row apart from its bin are
   counted, ``rows_where_thresholds_route_apart``); a 5-iteration D = 4
   fit asking for the ring, which keeps psum with the downgrade
   ``"dart"``; a 20,000-row,
   5-iteration card-vs-CPU check with drops in every iteration: the
   first tree identical, the same drops and scales, AUCs within 0.002.
17. rf_path — the flagship under ``boostingType="rf"`` (``baggingFraction``
   0.8, ``baggingFreq`` 1, ``featureFraction`` 0.8), 50 iterations: fit
   seconds and AUC; then 5-iteration D = 4 fits under the data ring
   (``ring_allreduce`` once per tree and split), ``pallas_ring``
   (``fused_hist_ring`` once per split) and voting with the ring (``topK``
   5, ``ring_allreduce_select`` once per tree and split), each AUC within
   0.01 of the serial fit's first 5 iterations; a 20,000-row card-vs-CPU
   check.
18. ranking_path — the slice's main path: ``LightGBMRanker`` on data of
   MSLR-WEB30K's shape (``ranking_data``: 3,000 queries of 20–230
   documents, 136 features, grades 0–4), 15 iterations, 31 leaves, 255
   bins, ``maxPosition`` 30, ``sigma`` 1, a warm-up and a timed fit: fit
   and transform seconds, the lambda gradient's milliseconds an iteration
   (CUDA events), train NDCG@1/3/5/10 against the score-0 baseline
   (NDCG@10 must rise by 0.1), one model text, ``hist_full`` once a tree
   and ``hist_segment`` once a split; a fit with 20% of the queries held
   out and ``earlyStoppingRound`` 10 on the negative NDCG@10 (learning
   rate 0.5; the stop rule must hold whether or not it fires); a
   5-iteration D = 4 data fit (each query on one shard); a 200-query,
   5-iteration card-vs-CPU check: the first tree identical, NDCG@10
   within 0.002.
19. efb_path — Exclusive Feature Bundling on ``flight_data`` (the Flight
   Delay set's shape: 100,000 rows, one-hot Month, DayofMonth, DayOfWeek,
   UniqueCarrier, Origin and Dest with Zipf carriers and airports, dense
   DepTime and Distance, 674 features, about 19% delayed), 25 iterations,
   31 leaves, 255 bins: a warm-up and a timed fit with ``enableBundle``
   (G bundle columns; ``same_model_text``), the unbundled fit, and
   5-iteration bundled GOSS and DART fits and D = 4 data-ring fits under
   ``auto`` and ``pallas_ring``; each with fit and transform seconds, AUC
   and launches.  Every histogram call of a bundled fit must be at the G
   columns (the unbundled at 674), the timed bundled fit must launch
   ``hist_full`` once a tree and ``hist_segment`` once a split, the
   bundled AUC must lie within 0.002 of the unbundled.  Then a
   20,000-row, 5-iteration bundled card-vs-CPU check: the first tree
   identical, margins within 1e-4.  (The kernels phase runs both
   histogram kernels at the bundled and the unbundled shape.)
20. wide_bins_path — the flagship at ``maxBin`` 1023 and 511 (B = 1,024
   and 512, int32 codes): a warm-up and a timed serial fit each, 50
   iterations (``hist_full`` once a tree and ``hist_segment`` once a
   split, every call at B int32 codes, AUC >= 0.955, one model text);
   5-iteration D = 4 data-ring fits at 1023 under ``auto`` and
   ``pallas_ring``: above 256 bins ``fused_hist_ring`` is not launched,
   each shard's ``hist_segment`` runs and ``ring_allreduce`` reduces
   once per tree and split, AUC within 0.01 of the serial fit's first 5
   iterations; a 20,000-row card-vs-CPU check at 1023.
21. native_path — the reference's native host paths
   (``mmlspark_tpu_torch/native``): the codes of ``transform_packed``
   (fastbin) equal ``transform(X, "cuda")`` at the flagship's 400,000 ×
   50 and ``flight_data``'s 100,000 × 674 (``torch.equal``), with the
   seconds of the host binning, the copy of its codes to the card and the
   device transform; main_path's model (standalone, the phase fits the
   flagship itself) loaded onto the CPU, whose native
   margins (fastforest) equal the CPU walk's and the card predictor's bit
   for bit, with the median host ms of 20 calls of the native scorer and
   of the card predictor (host rows in, host margins out) at 1, 64, 4,096
   and 400,000 rows and the host's thread count; a 20,000 × 50,
   5-iteration CPU fit under ``auto`` (fasthist, its native call counts)
   and under ``segment``, each with its seconds, the ``auto`` fit's first
   tree identical to the card fit's; and a flagship fit with
   ``MMLSPARK_TPU_HBM_BYTES`` at half main_path's estimate, which must
   raise ``MemoryError`` before any kernel launches.
22. fault_tolerance_path — chunk-boundary checkpoints, kill and resume,
   and chunk replay through ``engine.train`` on the flagship (400,000 ×
   50, the main path's settings, bagging every 3rd iteration at 0.8,
   feature fraction 0.8, 10 iterations, boundaries every 5): after a
   5-iteration warm-up, the fit without and with ``checkpoint_dir`` in
   turns (plain, checkpointed, checkpointed, plain: seconds, the saves'
   seconds, the snapshot's bytes on disk after each boundary, one model
   text); the same fit in a subprocess (``chip_smoke.py
   --fault-tolerance-worker DIR``) that exits in its callback at
   iteration 5, after boundary 5 is durable, resumed here
   (``ckpt_resumed`` = 1, the directory cleared); the fit with
   ``fault_tolerant_retries=1`` whose chunk 2 fails once after
   ``ChaosBoostStep`` drops its device arrays (``chunks_replayed`` = 1);
   a D = 4 one-card mesh fit with the last 40,000 rows as its
   validation set and psum, replayed and resumed alike; and that mesh fit
   on the ring (``collective="ring"``, ``ring_allreduce`` once a tree and
   split), replayed.  Every recovered fit must write the uninterrupted
   fit's model text byte for byte, and the phase's fits must launch both
   histogram kernels and the ring.
22b. multicontroller_path — sharded ingestion and a gang of two
   controller processes on the one card (``python -m
   mmlspark_tpu_torch.gbdt.elastic --device cuda``, gloo, the gathers
   staged through host memory): the flagship table (400,000 × 50, 255
   bins, from the script's seed, ``gang_table``), which each controller
   regenerates with the shared bin mapper and bins only its own rows, cut
   unequally at row 190,000 into two shards; fault_tolerance_path's fit
   settings at 10 iterations (31 leaves, bagging 0.8 every 3rd iteration,
   feature fraction 0.8, boundaries every 5).  The in-process
   one-controller fit of the same two shards on ``[cuda:0] * 2``, then a
   gang run without checkpoints under a heartbeat stall, its leases
   beaconed over the transport to a ``HeartbeatHub`` in the script's
   process (``--heartbeat-transport``, in place of the lease files),
   which must write its text byte for byte with ``heartbeat_stalls``,
   no peer lost and no restart; then the chaos drill
   (``mmlspark_tpu_torch.tools.chaos_training``) with that run as its
   baseline and its stall phase: controller 1 SIGKILLed at boundary 5
   and the gang resumed (one restart, ``ckpt_resumed`` 1 in each
   controller, the directory cleared), and a fresh gang on a copy of
   that kill's snapshot with its meta bit-flipped (``ckpt_discarded``),
   each ending in that text (four gang rounds).  A round lost to a
   rendezvous port taken in between does not count as a restart.  Then
   ``hist_full`` at controller 1's shard (the 210,000 rows from the cut
   on × 50) and ``hist_segment`` at
   half of it, against their twins, timed.  Reported: the gang's fit
   seconds per controller beside the in-process fit's, the backend, each
   controller's gathers (count, bytes, host seconds) and ``hist_full`` /
   ``hist_segment`` launches.
23. collectives_cross_card — phase 7's checks with one shard per card,
   D = min(cards, 4), where the host has at least two cards; elsewhere it
   prints ``"ran": false`` (not a failure).
24. observability_path — the observability core (``core/telemetry.py``,
   ``profiler.py``, ``sketch.py``, ``debug.py``) on main_path's flagship
   (400,000 × 50, serial) at 25 iterations (``OBS_ITERATIONS``): two
   fits with everything on and two with the profiler off and
   ``MMLSPARK_TPU_REF_PROFILE=0``, in turns (on, off, off, on), must
   write the same model text;
   each fit's seconds, the grower's host syncs and every synchronizing
   call (``torch.cuda.synchronize`` and ``Tensor.cpu`` of a card tensor)
   are printed, with each pair's difference as a share and their median
   (the reference's contract is < 3%; printed, not held), and the
   reference profile's capture ms by step.  The
   instrumented fit's journal holds one span: ``fit_begin``, then
   ``boost_chunk`` events whose ``[it_start, it_end)`` tile [0, 25), then
   ``fit_end`` with the booster's trees; it is mirrored to a file, read
   back by ``read_journal`` and turned into a fit timeline by
   ``mmlspark_tpu_torch/tools/trace_report.py``.  The profiler's
   ``train.boost_chunk.dispatch_host`` / ``device_wait`` counts equal the
   ``boost_chunk`` events; the ``cuda:0`` watermarks hold
   ``bytes_in_use <= peak_bytes_in_use <= bytes_limit`` with the peak at
   least the 20 MB of codes; ``tools/perf_report.py`` parses the
   registry's render.  The booster's reference profile (captured on the
   host) equals the one ``build_reference_profile`` builds from the same
   codes and the booster's CPU margins, its feature sketches exact counts
   (its capture's ms printed by step).  A fit with
   ``io.chaos.ChaosBoostStep`` failing its first chunk and no retries
   raises, journals ``fit_failed`` under its span and leaves a flight
   record with the journal tail, the profiler snapshot and the card's
   watermarks.  In debug mode a fit whose ``grad_fn_override`` returns a
   NaN raises ``DebugCheckError`` before its first tree.  The kernels'
   launches of the instrumented fit must equal its trees and splits.
25. serving_path — the serving plane (``mmlspark_tpu_torch/io``) on
   main_path's flagship model (400,000 × 50, 50 iterations, 31 leaves,
   255 bins; standalone the phase fits it), exported as LightGBM text and
   reloaded on the card, as ``samples/train_export_serve.py`` serves its
   model.  ``HTTPServer`` + ``ScoringEngine`` on ``predictor(backend=
   "jit")`` (2 scorers, ``max_rows`` 256, ``latency_budget_ms`` 2):
   ``SERVE_CLIENTS`` threads post ``SERVE_REQUESTS`` one-row JSON
   requests drawn from the flagship rows (numpy seed ``SERVE_SEED``);
   every reply must equal ``predict_margin`` of its row on the card bit
   for bit after float32 → JSON → float32.  Printed: rows/s, end-to-end
   p50 / p99 at the client, the engine's ``stats_snapshot`` stage p50s
   (batch forming, decode, score, reply, and the dispatch split into
   ``dispatch_host`` and ``device_wait``), its mean batch rows, and the
   same engine on a CPU booster's native scorer (its replies equal the
   card's).  Then ``serve_forever`` on the same server with the reloaded
   model's ``transform``, whose reply must equal the batch transform's
   probability; the raw-float32 wire through the exchange (a transport
   client holding the worker slot of a ``MultiprocessHTTPServer``,
   ``wire.pack_matrix`` rows, reply blocks) and ``MultiprocessHTTPServer``
   with two spawned worker processes (no worker death), both bit-equal;
   ``PredictorFleet`` with two spawned workers that load the model on
   the card, ``routing="shard"`` equal to the port's ``ShardedPredictor``
   on the card and ``"replica"`` to the full predictor, with the fleet's
   ms a call at ``FLEET_ROWS`` rows against the in-process predictor's.
   No number in the phase is a claim.
26. lifecycle_path — the model lifecycle (``mmlspark_tpu_torch/io``
   ``registry``, ``rollout``, ``ingest``, ``refresh``), after
   ``tools/chaos_online.py``'s scenarios A, C and D, on main_path's
   flagship model (standalone the phase fits it): version 1 of a
   ``ModelRegistry``, served through a ``RolloutController`` on the card
   behind a ``ScoringEngine`` (2 scorers, ``max_rows`` 256) with a
   ``DriftMonitor`` from the model's reference profile and an ingest tap
   into an ``IngestBuffer`` (window 50,000, reservoir 1,500, segments
   8,192) on the estimator's bin mapper.  Traffic: flagship rows (numpy
   seed ``LIFE_SEED``) through a ``ChaosDrift`` ramp on one feature, in
   bursts of 256 one-row requests whose payloads are float32 row views,
   52,224 rows before the refresh (the detection latency in rows
   printed).  The drift's SLO burn triggers a refresh in a trainer
   process on the card (``tools.chaos_online``'s trainer: binary, 10
   iterations, boundaries every 5, the flagship's fit settings) over
   about 51,500 × 50 retained rows; it is SIGKILLed after its first
   boundary and a fresh trainer resumes the episode and publishes
   version 2, whose text must equal, byte for byte, an uninterrupted
   ``train_incremental`` on the card over the same ``dataset.npz``
   (its launches: ``hist_full`` once a tree, ``hist_segment`` once a
   split).  Version 2 then canaries at fraction 0.5 and the gate must
   promote it; every reply of both stages must equal, bit for bit,
   ``predict_margin`` on the card of one version live at that moment
   (none wrong, none dropped), and the merged journals of the three
   processes must hold the episode's chain (triggered → dataset →
   fit_begin → SIGKILL → recovered → candidate).  Then the lease beacons
   (``tools.chaos_training.transport_heartbeat_drill``, in this
   process): link cuts never fake a dead peer, the stall is counted, the
   sessions resume.  Both histogram kernels at the refresh's shapes
   against their twins.  Printed: the refresh fit's seconds, the resumed
   fit's launches, each trainer's start seconds, the canary's rows/s and
   ``dispatch_host`` / ``device_wait`` p50, the phase's seconds and the
   card line.  No number in the phase is a claim.

The kernels phase also runs the wide modes (``WIDE_KERNEL_BINS``: B =
257, 512, 1,024 and 4,096, int32 codes from the flagship binned at
``maxBin`` B − 1) in all three modes: ``hist_full`` at 400,000 × 50 and
``hist_segment`` at the median segment (and at 200,000 rows at B =
1,024), against their twins, in f32 bit for bit against the order they
state (``histogram_segment_ordered``), with the same times and bound;
and both 256-bin kernels at ``flight_data``'s G bundle columns and its
674 unbundled columns (f32; the full matrix and the median segment).
``kernels_flagship`` (run only when named) times the two 256-bin
flagship rows alone: the phase to A/B between two checkouts.

The kernels phase also runs ``hist_full`` f32 at GOSS's 120,000 sampled
rows and at the ranking configuration's rows × 136 features on its first
lambda gradients (and ``hist_segment`` there), the int32 ``hist_full``
and ``hist_segment`` on the quantized flagship's codes; the collectives
phase the int32 ``fused_hist_ring`` at 2,048 rows a shard × 2,000
features (codes of the reference configuration's grid).

Then the ``{"kernels": [...]}`` line (a row per kernel, launches from the
main path, plus a row per int32 mode, launches from ``quantized_path``,
the histogram kernels at the ranking shapes, launches from
``ranking_path``, at the bundled table's G columns, launches from
``efb_path``, their wide modes at B = 1,024 and 512, launches from
``wide_bins_path``, and the flagship rows again with the launches of
``continued_path``'s serial and D = 4 continuations, mode
``continued``, and with the launches of ``fault_tolerance_path``'s
fits, mode ``fault_tolerance``; the two histogram kernels at a gang
controller's shapes, with the launches of ``multicontroller_path``'s
gang summed over its controllers, mode ``multicontroller``; the two
histogram kernels with the launches of ``observability_path``'s
instrumented fit, mode ``observability``; the two histogram kernels at
the refresh fit's shapes, with the launches of ``lifecycle_path``'s
uninterrupted card fit, mode ``lifecycle``), the card
line, and last the ``{"ok": true, ...}``
line.  Any failed phase makes the script exit 1 without that last line.

    python3 chip_smoke.py --phases kernels,main_path

runs the environment and build phases and the named ones only, in the
order above, and ends after the card line (exit 0, or 1 if a phase
failed): an A/B of one phase between two checkouts runs only what it
needs.
"""

import json
import os
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
#: the categorical configuration: bench.py's data with columns 40-49
#: categorical, of these cardinalities
CAT_COLUMNS = tuple(range(40, 50))
CAT_CARDINALITIES = (2, 3, 4, 12, 24, 64, 200, 254, 1000, 10_000)
#: iterations of its two fits on four virtual shards (the serial fit's
#: 50 cut, to hold the phase's time; 10 until PR 15)
CAT_MESH_ITERATIONS = 5
#: the multiclass configuration: classes and iterations (the mesh fit's
#: too; cut from 20 and then 10 to hold the script's time)
NUM_CLASSES, MULTICLASS_ITERATIONS = 5, 5
#: the validation configuration: the flagship with this fraction of its
#: rows flagged (numpy default_rng(VAL_SEED)), a learning rate at which
#: the validation logloss turns within the iterations asked, and the
#: early-stopping round
VAL_FRACTION, VAL_SEED = 0.2, 3
VAL_ITERATIONS, VAL_LR, VAL_ESR = 300, 0.5, 10
#: GOSS on the flagship: rates, iterations (D = 4 fit: 5; 10 until PR
#: 15, cut with every D = 4 variant fit to hold the script's time)
GOSS_TOP_RATE, GOSS_OTHER_RATE = 0.2, 0.1
GOSS_ITERATIONS, GOSS_MESH_ITERATIONS = 50, 5
#: quantized flagship iterations (cut from 50 to hold the script's time;
#: the AUC is held against main_path's fit at as many iterations)
QUANT_ITERATIONS = 25
#: the objectives configuration: the flagship's features, one label per
#: family (numpy default_rng(4)), each objective fitted this many
#: iterations
OBJECTIVES = ("regression_l1", "huber", "fair", "poisson", "quantile",
              "mape", "gamma", "tweedie", "cross_entropy")
OBJ_ITERATIONS = 5
#: DART with LightGBM's default drops, rf with its bagging; iterations of
#: the serial fits and of the D = 4 fits
DART_ITERATIONS, DART_MESH_ITERATIONS = 50, 5
#: DART's train AUC floor on the flagship: each new iteration joins at
#: 1/(k+1) and the dropped ones shrink, so at learning rate 0.1 the
#: 50-iteration fit reaches 0.9448 (PR 9, chip call 1), below gbdt's
#: 0.955 floor; the CPU fits equal the reference's byte for byte
DART_MIN_AUC = 0.94
RF_ITERATIONS, RF_MESH_ITERATIONS, RF_TOP_K = 50, 5, 5
#: the ranking configuration, MSLR-WEB30K's shape: queries, documents a
#: query (uniform), features, the quantiles the grades 0-4 are cut at
#: (numpy default_rng(5)), iterations (D = 4 fit: 5), NDCG positions
RANK_QUERIES, RANK_DOCS, RANK_FEATURES = 3000, (20, 230), 136
RANK_CUTS = (0.50, 0.82, 0.95, 0.985)
RANK_ITERATIONS, RANK_MESH_ITERATIONS = 15, 5
RANK_EVAL_AT = (1, 3, 5, 10)
#: the held-out fit's learning rate (its validation NDCG turns sooner)
RANK_ES_LR = 0.5
#: iterations of each profiled fit (the profiler multiplies a fit's
#: host time)
PROFILE_ITERATIONS = 5
#: the EFB configuration, the Flight Delay set's shape (Ke et al., NIPS
#: 2017, Table 1; szilard/benchm-ml's one-hot airline columns): rows, the
#: one-hot blocks (name, categories), the Zipf-distributed ones, the two
#: dense columns' count, the positive share, iterations (the bundled
#: GOSS and DART fits and the D = 4 fits: 5).  Rows cut from 400,000 to
#: hold the script's time: each fit bins and bundles the 674 columns on
#: the host, ~9 s a fit at 400,000 rows on an H100's host
FLIGHT_ROWS = 100_000
FLIGHT_ONEHOT = (("Month", 12), ("DayofMonth", 31), ("DayOfWeek", 7),
                 ("UniqueCarrier", 22), ("Origin", 300), ("Dest", 300))
FLIGHT_ZIPF = ("UniqueCarrier", "Origin", "Dest")
FLIGHT_FEATURES = sum(k for _, k in FLIGHT_ONEHOT) + 2
FLIGHT_POSITIVE = 0.19
FLIGHT_ITERATIONS, FLIGHT_MESH_ITERATIONS = 25, 5
#: wide bins: the flagship's maxBin values (B = 1,024 and 512), the D = 4
#: fits' iterations, and the bin counts the kernels phase runs the wide
#: modes at
WIDE_MAX_BINS = (1023, 511)
WIDE_MESH_ITERATIONS = 5
WIDE_KERNEL_BINS = (257, 512, 1024, 4096)
#: continued training on the flagship: the base and the continuation's
#: iterations, the D = 4 continuations' iterations, the row counts the
#: predictor is timed at, the TreeSHAP rows, and the card-vs-CPU check's
#: rows and iterations (base and continuation each)
CONT_ITERATIONS, CONT_MESH_ITERATIONS = 25, 5
PREDICT_ROWS = (1, 64, 4096, N_ROWS)
SHAP_ROWS = 100
CONT_CPU_ROWS, CONT_CPU_ITERATIONS = 20_000, 5
#: iterations of the warm-up fit before a timed fit, where it is cut
#: (every phase but main_path and dart_path): it warms the card and its
#: trees must equal the timed fit's first ones byte for byte
WARM_ITERATIONS = 5
#: the card the kernels and the main path run on
DEV = "cuda"
#: phases that run only when ``--phases`` names them
ONLY_WHEN_NAMED = ("kernels_flagship",)


def emit(obj):
    print(json.dumps(obj), flush=True)


_LOGITS = {}


def bench_logits(n, f):
    """bench.py's synthetic task (numpy default_rng(0)): the features and
    the logits whose sign is its binary label (made once a run for each
    shape; each call gets its own copies)."""
    import numpy as np
    if (n, f) not in _LOGITS:
        rng = np.random.default_rng(0)
        X = rng.normal(size=(n, f)).astype(np.float32)
        logits = (X[:, 0] * 1.5 + X[:, 1] * X[:, 2] + np.sin(X[:, 3] * 2)
                  + rng.normal(size=n) * 0.5)
        _LOGITS[n, f] = (X, logits)
    X, logits = _LOGITS[n, f]
    return X.copy(), logits.copy()


def bench_data(n, f):
    """bench.py's synthetic binary task (numpy default_rng(0))."""
    X, logits = bench_logits(n, f)
    return X, (logits > 0).astype("float64")


def categorical_data(n):
    """``bench_logits(n, 50)`` with columns 40–49 replaced by category ids
    drawn from numpy ``default_rng(1)``, of cardinalities
    ``CAT_CARDINALITIES`` (1,000 and 10,000 have more categories than the
    254 category bins of 255 bins: the rarer ones share the missing bin).
    The label is

        y = [logits + 2·[c44 ∈ S24] + 1.5·[c46 ∈ S200] − 1.4 > 0]

    with c44 the 24-category column, S24 = {0, 8} ∪ {1, 4, 7, …, 22}, c46
    the 200-category column and S200 = {c : 37c mod 11 < 4}: subsets
    scattered over the ids, which no numeric threshold expresses."""
    import numpy as np
    X, logits = bench_logits(n, N_FEATURES)
    rng = np.random.default_rng(1)
    for j, card in zip(CAT_COLUMNS, CAT_CARDINALITIES):
        X[:, j] = rng.integers(0, card, size=n)
    c24, c200 = X[:, 44].astype(np.int64), X[:, 46].astype(np.int64)
    in24 = np.isin(c24, sorted(set(range(1, 24, 3)) | {0, 8}))
    in200 = (37 * c200) % 11 < 4
    return X, (logits + 2.0 * in24 + 1.5 * in200 - 1.4 > 0).astype(
        np.float64)


def multiclass_data(n):
    """``bench_logits(n, 50)``'s features with ``NUM_CLASSES`` classes:
    y = argmax_k (X[:, :10] · W[:, k] + e_k), W a 10 × 5 standard normal
    matrix and e an n × 5 standard normal noise, both drawn from numpy
    ``default_rng(2)``."""
    import numpy as np
    X, _ = bench_logits(n, N_FEATURES)
    rng = np.random.default_rng(2)
    W = rng.normal(size=(10, NUM_CLASSES))
    scores = X[:, :10] @ W + rng.normal(size=(n, NUM_CLASSES))
    return X, scores.argmax(1).astype(np.float64)


def multi_logloss(y, prob):
    """Mean negative log probability of the true class."""
    import numpy as np
    p = prob[np.arange(len(y)), y.astype(np.int64)]
    return float(-np.log(np.clip(p, 1e-15, 1.0)).mean())


def objective_data(name, n=None):
    """The flagship's features with a label for ``name``'s family, drawn
    from numpy ``default_rng(4)`` around the flagship's hidden logit z: a
    Poisson count of mean exp(0.3 z) (poisson), a Gamma (shape 2) and a
    Tweedie (ρ 1.5, compound Poisson-Gamma, φ 1) of the same mean,
    sigmoid(z) (cross_entropy), else z plus Student-t(2) noise."""
    import numpy as np
    n = n or N_ROWS
    X, z = bench_logits(n, N_FEATURES)
    rng = np.random.default_rng(4)
    mu = np.exp(0.3 * z)
    if name == "poisson":
        y = rng.poisson(mu).astype(np.float64)
    elif name == "gamma":
        y = rng.gamma(2.0, mu / 2.0)
    elif name == "tweedie":
        rho = 1.5
        lam = mu ** (2 - rho) / (2 - rho)
        alpha = (2 - rho) / (rho - 1)
        count = rng.poisson(lam)
        y = np.where(count > 0, rng.gamma(np.maximum(count * alpha, 1e-9),
                                          (rho - 1) * mu ** (rho - 1)), 0.0)
    elif name == "cross_entropy":
        y = 1.0 / (1.0 + np.exp(-z))
    else:
        y = z + rng.standard_t(2, size=n)
    return X, y.astype(np.float64)


def objective_loss(name, y, margin):
    """LightGBM's metric for each objective (numpy, mean over rows) at
    the margins: l1, huber (δ 0.9), fair (c 1), poisson / gamma /
    tweedie (ρ 1.5) negative log-likelihood up to constants, quantile
    (α 0.9), mape, cross_entropy."""
    import numpy as np
    m = np.asarray(margin, np.float64)
    d = m - y
    if name == "regression_l1":
        loss = np.abs(d)
    elif name == "huber":
        loss = np.where(np.abs(d) <= 0.9, 0.5 * d * d,
                        0.9 * (np.abs(d) - 0.45))
    elif name == "fair":
        loss = np.abs(d) - np.log1p(np.abs(d))
    elif name == "poisson":
        loss = np.exp(m) - y * m
    elif name == "quantile":
        loss = np.where(d >= 0, 0.1 * d, -0.9 * d)
    elif name == "mape":
        loss = np.abs(d) / np.maximum(np.abs(y), 1.0)
    elif name == "gamma":
        loss = y * np.exp(-m) + m
    elif name == "tweedie":
        loss = y * np.exp(-0.5 * m) / 0.5 + np.exp(0.5 * m) / 0.5
    else:
        p = np.clip(1.0 / (1.0 + np.exp(-m)), 1e-15, 1 - 1e-15)
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
    return float(loss.mean())


_RANKING = {}


def ranking_data(n_queries=None):
    """Data of MSLR-WEB30K's shape, from numpy ``default_rng(5)``:
    ``n_queries`` queries of uniformly 20–230 documents, 136 standard
    normal features, and grades 0–4 cut at the quantiles ``RANK_CUTS`` of
    a noisy linear score (weights on 20 features).  The data and its cuts
    are this script's own, not MSLR's published label shares."""
    import numpy as np
    n_queries = n_queries or RANK_QUERIES
    if n_queries in _RANKING:
        return _RANKING[n_queries]
    rng = np.random.default_rng(5)
    sizes = rng.integers(RANK_DOCS[0], RANK_DOCS[1] + 1, size=n_queries)
    q = np.repeat(np.arange(n_queries), sizes)
    X = rng.normal(size=(len(q), RANK_FEATURES)).astype(np.float32)
    score = X[:, :20] @ rng.normal(size=20) + rng.normal(size=len(q)) * 2.0
    y = np.digitize(score, np.quantile(score, RANK_CUTS)).astype(np.float64)
    _RANKING[n_queries] = (X, y, q)
    return X, y, q


def ranking_inputs():
    """Kernel inputs of the ranking main path's first tree: its binned
    matrix and the lambda gradients at score 0, on the card."""
    import torch
    from mmlspark_tpu_torch.gbdt import fit_bin_mapper
    from mmlspark_tpu_torch.gbdt.ranking import LambdarankGradient
    X, y, q = ranking_data()
    mapper = fit_bin_mapper(X, max_bin=255)
    bins = mapper.transform(X, DEV)
    g, h = LambdarankGradient.serial(y, q, 1.0, 30, DEV).grad_hess(
        0, torch.zeros(len(y), device=DEV))
    gh = torch.stack([g, h, torch.ones_like(g)], dim=1)
    scale = gh.abs().amax(0).clamp(min=1e-30) / 127
    return bins, mapper.num_total_bins, gh, torch.round(gh / scale).to(
        torch.int32)


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
    bounds a call whose kernel is shorter than its wrapper.  None (not
    measured) when the profiler recorded no such kernel on the card, as
    late in a whole run it has (the gang's rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [ms for name, (ms, _) in device_events(prof).items()
             if kernel in name]
    return sum(times) / reps if times else None


def device_events(prof):
    """``{name: (ms, count)}`` of the events a finished ``torch.profiler``
    run recorded on the card, summed by name, read from the profiler's
    raw results: ``key_averages()`` builds torch's event tree first,
    which costs seconds for each thousand launches."""
    import torch
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ms, count = out.get(e.name(), (0.0, 0))
            out[e.name()] = (ms + (e.end_ns() - e.start_ns()) / 1e6,
                             count + 1)
    return out


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
    """Host clocks inside one timed fit: ``binning_s``, the estimator's
    binning of its rows (``base.fit_codes``: the native host binning and
    the copy of the codes to the card, or above 256 bins the device
    transform), ``fetch_s``, the grower's device →
    host fetches (its host syncs: the wait for the queued kernels plus the
    copy), ``hist_segment_s`` / ``fused_hist_ring_s``, the histogram
    wrappers' calls (their host enqueue), and ``ring_allreduce_s``, the
    dense ring's; what is left of the fit is the rest of the host loop."""

    def __enter__(self):
        from mmlspark_tpu_torch.gbdt import base, grower
        from mmlspark_tpu_torch.ops import histogram
        self.spans = {"binning_s": 0.0, "fetch_s": 0.0,
                      "hist_segment_s": 0.0, "fused_hist_ring_s": 0.0,
                      "ring_allreduce_s": 0.0}
        self.patched = [(base, "fit_codes", "binning_s"),
                        (grower, "_fetch", "fetch_s"),
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


def host_cpu():
    """The host CPU's model name (``lscpu``'s, from ``/proc/cpuinfo``):
    the native host paths' times are host numbers."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


def card_line():
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"


def phase_environment():
    import torch
    return {"nvidia_smi": card_line(),
            "device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "host_cpu": host_cpu(),
            "host_threads": os.cpu_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from mmlspark_tpu_torch import native
    from mmlspark_tpu_torch.ops._build import CSRC, build_all
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.build_all)
        res = build_all(names)
        host_res = host.result()
    return {"seconds": time.perf_counter() - t0,
            "sources": {k: {"seconds": v[1],
                            "ptxas": [ln.strip() for ln in v[2].splitlines()
                                      if "registers" in ln]}
                        for k, v in res.items()},
            "native_sources": {k: {"seconds": v[1]}
                               for k, v in host_res.items()}}


_KERNEL_INPUTS = {}


def kernel_inputs(n=None, f=None, rows=None, max_bin=255):
    """Binned n × f matrix and gradient triples of the main path's first
    tree (binary objective at the init score), on the card; ``rows``: only
    the first ``rows`` of them (a shard), binned on all n.  The flagship's
    (no arguments) are made once a run: several phases read them, and
    none writes them."""
    key = (n, f, rows, max_bin)
    if key == (None, None, None, 255):
        if key not in _KERNEL_INPUTS:
            _KERNEL_INPUTS[key] = _kernel_inputs(n, f, rows, max_bin)
        return _KERNEL_INPUTS[key]
    return _kernel_inputs(n, f, rows, max_bin)


def _kernel_inputs(n, f, rows, max_bin):
    import numpy as np
    import torch
    from mmlspark_tpu_torch.gbdt import fit_bin_mapper, get_objective
    X, y = bench_data(n or N_ROWS, f or N_FEATURES)
    mapper = fit_bin_mapper(X, max_bin=max_bin)
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


def max_code(bits, n, data_shards=1):
    """The quantized grid's largest |code| for n rows (the engine's
    ``_resolve_quantized``): 2^(bits-1) - 1 clamped to int32 headroom,
    and on a data mesh to the int16 wire: at the flagship's 400,000 rows
    5,368 (16 bits) and 127 (8); at the wide 8,192 rows on four shards
    3."""
    mc = min((1 << (bits - 1)) - 1, (2 ** 31 - 1) // n)
    if data_shards > 1 and n * mc > 32767 and 32767 // n >= 3:
        mc = 32767 // n
    return mc


def quant_inputs(inputs, max_code):
    """Kernel inputs with the int32 codes a quantized fit's first tree
    histograms: the gradient triples on the port's 16-bit grid clamped to
    ``max_code`` (:func:`mmlspark_tpu_torch.gbdt.grower.quantize_gh`)."""
    from mmlspark_tpu_torch.gbdt.grower import GrowerConfig, quantize_gh
    bins, B, gh, _ = inputs
    codes, _ = quantize_gh([gh], GrowerConfig(
        quantized_bits=16, quantized_seed=42, quantized_max_code=max_code))
    return bins, B, gh, codes[0]


def compare(kern, plain, gh_abs_hist, accum, cell_bound=False):
    """Kernel against twin: int32 exactly; f32 / bf16 within RTOL |p| +
    ATOL_ULPS u sum|gh| per cell, or with ``cell_bound`` within the bound
    that holds for any order, RTOL |p| + 2 (m - 1) u sum|gh| for a cell of
    m rows (each side's float sum of m terms lies within (m - 1) u sum|x|
    of the exact sum): for tables whose cells hold most of the rows, as
    a bundle's all-default bin or a one-hot column's zero bin do, where
    the same-signed terms' rounding adds up rather than cancelling."""
    import torch
    if accum == "int32":
        return torch.equal(kern, plain), 0.0
    err = (kern - plain).abs()
    ulps = ATOL_ULPS
    if cell_bound:
        ulps = torch.clamp(2 * (plain[..., 2:3] - 1), min=ATOL_ULPS)
    tol = RTOL * plain.abs() + ulps * 2.0 ** -24 * gh_abs_hist
    return bool((err <= tol).all()), float(err.max())


def _segment_row(inputs, row_order, cnt, accum, cell_bound=False):
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
        bins, ghv.abs().float(), row_order, off, cnt, B), accum, cell_bound)
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


def _full_row(inputs, accum, ordered=True, cell_bound=False):
    """hist_full against its twin (``cell_bound``: :func:`compare`'s) and
    against the order it states (``histogram_ordered`` on the CPU, bit
    for bit; ``ordered=False`` skips it, for a matrix too large to add on
    the host), repeated calls
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
                        ch.histogram_plain(bins, ghv.abs().float(), B), accum,
                        cell_bound)
    geom = ch.full_launch_geometry(n, f, B, accum, bins.device)
    if ordered:
        ordered = torch.equal(kern.cpu(), ch.histogram_ordered(
            bins.cpu(), ghm.cpu(), B, accum, geom))
    else:
        ordered = None
    repeats = None
    if accum == "float32":
        repeats = all(torch.equal(kernel(), kern) for _ in range(19))
    flat = (bins.long() + torch.arange(f, device=DEV) * B).reshape(-1)
    rep = ghv.repeat_interleave(f, 0)
    lib_out = torch.zeros(f * B, 3, dtype=kern.dtype, device=DEV)
    bms, by = bound_ms(n * f + n * 12 + f * B * 12, n * f * 3)
    row = {"kernel": "hist_full", "accum": accum, "rows": n, "features": f,
           "geometry": geom._asdict(),
           "match": good and ordered is not False and repeats is not False,
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
    # the new paths' shapes: GOSS's 120,000 sampled rows (f32), and the
    # quantized flagship's codes (|code| <= 5,368) in the int32 mode
    goss = _cut(inputs, int(N_ROWS * (GOSS_TOP_RATE + GOSS_OTHER_RATE)), f)
    rows.append({**_full_row(goss, "float32"), "path": "goss_path"})
    quant = quant_inputs(inputs, max_code(16, N_ROWS))
    rows.append({**_full_row(quant, "int32"), "path": "quantized_path"})
    for cnt in (MEDIAN_SEGMENT, max(SEGMENT_COUNTS)):
        rows.append({**_segment_row(quant, row_order, cnt, "int32"),
                     "path": "quantized_path"})
    # the ranking main path's shapes: its matrix and first gradients
    rank = ranking_inputs()
    rank_order = torch.randperm(rank[0].shape[0], generator=g).to(
        torch.int32).to(DEV)
    rows.append({**_full_row(rank, "float32"), "path": "ranking_path"})
    for cnt in (MEDIAN_SEGMENT, rank[0].shape[0] // 2):
        rows.append({**_segment_row(rank, rank_order, cnt, "float32"),
                     "path": "ranking_path"})
    # the wide modes (B > 256, int32 codes) at the flagship's shapes, and
    # both kernels at the bundled EFB table's shape
    rows += _wide_kernel_rows(row_order)
    rows += _efb_kernel_rows()
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
    state["kernel_rows"] = state.get("kernel_rows", []) + rows
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
    return LightGBMClassifier(**{**dict(learningRate=0.1, numLeaves=31,
                                        maxBin=255, minDataInLeaf=20,
                                        verbosity=0), **kw})


def phase_main_path(state):
    import numpy as np
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    est = _classifier(numIterations=50, device=DEV, parallelism="serial")
    warm, model, fit_s, counts, host_s, syncs = _timed_fit(
        est, table, _counters(), warm_iterations=None)
    launches = {k: counts[k] for k in ("hist_full", "hist_segment")}
    t0 = time.perf_counter()
    out = model.transform(table)
    transform_s = time.perf_counter() - t0
    prob = out["probability"][:, 1]
    trees = model.getModel().trees
    splits = sum(t.num_leaves - 1 for t in trees)
    train_auc = auc(y, prob)
    state["launches"] = launches
    state["main_auc"] = train_auc
    state["main_model"] = model
    same = same_model_text(warm, model)
    state["main_memory"] = _timed_fit.memory
    res = {"rows": N_ROWS, "features": N_FEATURES, "iterations": 50,
           "fit_s": fit_s, "transform_s": transform_s,
           "train_auc": train_auc, "trees": len(trees), "splits": splits,
           "launches": launches, "host_syncs": syncs,
           "same_model_text": same, "binning_s": host_s["binning_s"],
           "host_s": host_s, "segments": segment_sizes(model),
           "memory": _memory("main_path")}
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
    """Whether two card fits of one configuration write the same model:
    the same LightGBM text byte for byte, or, where ``a`` is a warm-up
    fit cut to fewer iterations (:func:`_timed_fit`), tree blocks equal
    to ``b``'s first ones byte for byte: the card fit's result is the
    same run to run."""
    ta = a.getModel().save_native_model_string()
    tb = b.getModel().save_native_model_string()
    na, nb = len(a.getModel().trees), len(b.getModel().trees)
    if na >= nb:
        return ta == tb
    return na > 0 and _tree_blocks(ta) == _tree_blocks(tb)[:na]


def _tree_blocks(text):
    """The tree blocks of a model text without their ``Tree=i`` lines."""
    body = text.split("end of trees")[0]
    return [b.partition("\n")[2] for b in body.split("Tree=")[1:]]


def _trace_kernel_count(out_dir, name):
    """Kernel events of the one Chrome trace under ``out_dir`` whose name
    holds ``name``."""
    import glob
    import os
    paths = glob.glob(os.path.join(out_dir, "*.trace.json"))
    if len(paths) != 1:
        raise AssertionError(f"{len(paths)} traces under {out_dir}")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel"
               and name in str(e.get("name", "")))


def phase_continued_path(state):
    """Continued training, the Booster's serving surface and stage
    persistence on the flagship (``bench_data``, 400,000 × 50, 31 leaves,
    255 bins)."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mmlspark_tpu_torch import LightGBMClassificationModel, build_mesh
    from mmlspark_tpu_torch.core import PipelineModel
    counters = _counters()
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_continued_")
    res = {"rows": N_ROWS, "features": N_FEATURES,
           "iterations": [CONT_ITERATIONS, CONT_ITERATIONS]}
    try:
        # -- the base model and its continuation ----------------------
        base, base_s, _ = _counted_fit(
            _classifier(numIterations=CONT_ITERATIONS, device=DEV,
                        parallelism="serial"), table, counters)
        path = os.path.join(tmp, "base.txt")
        base.saveNativeModel(path)
        cont, cont_s, launches = _counted_fit(
            _classifier(numIterations=CONT_ITERATIONS, device=DEV,
                        parallelism="serial", initModelPath=path),
            table, counters)
        booster = cont.getModel()
        new = booster.trees[CONT_ITERATIONS:]
        splits = sum(t.num_leaves - 1 for t in new)
        text = cont.getNativeModel()
        prob = cont.transform(table)["probability"][:, 1]
        cont_auc = auc(y, prob)
        straight = state.get("main_model")
        if straight is None:
            straight = _classifier(numIterations=2 * CONT_ITERATIONS,
                                   device=DEV,
                                   parallelism="serial").fit(table)
        main_auc = auc(y, straight.transform(table)["probability"][:, 1])
        Xd = torch.as_tensor(X, dtype=torch.float32, device=DEV)
        full = booster.predict_margin(Xd)
        gap = float((full - straight.getModel().predict_margin(Xd))
                    .abs().max())
        base_same = (_tree_blocks(text)[:CONT_ITERATIONS]
                     == _tree_blocks(base.getNativeModel()))
        res.update(base_fit_s=base_s, continuation_fit_s=cont_s,
                   trees=len(booster.trees), splits=splits,
                   launches={k: launches[k] for k in ("hist_full",
                                                      "hist_segment")},
                   train_auc=cont_auc, straight_auc=main_auc,
                   max_margin_gap_to_straight=gap,
                   base_blocks_equal=base_same)
        if launches["hist_full"] != CONT_ITERATIONS or \
                launches["hist_segment"] != splits:
            raise AssertionError(f"continuation launches {launches} do not "
                                 f"match {CONT_ITERATIONS} trees / {splits} "
                                 f"splits: {res}")
        if not base_same or "[num_iterations: 50]" not in text:
            raise AssertionError(f"the merged text does not start with the "
                                 f"base's trees or record 50 iterations: "
                                 f"{res}")
        if not (cont_auc >= 0.955 and abs(cont_auc - main_auc) <= 0.002):
            raise AssertionError(f"continuation AUC {cont_auc} below 0.955 "
                                 f"or off the straight fit's {main_auc}: "
                                 f"{res}")
        # -- initScoreCol at the base model's margins ------------------
        offs = base.getModel().predict_margin(Xd).cpu().numpy()
        iscore, iscore_s, ilaunch = _counted_fit(
            _classifier(numIterations=CONT_ITERATIONS, device=DEV,
                        parallelism="serial", initScoreCol="offset"),
            {**table, "offset": offs.astype(np.float64)}, counters)
        same = (_tree_blocks(iscore.getNativeModel())
                == _tree_blocks(text)[CONT_ITERATIONS:])
        res["init_score_col"] = {"fit_s": iscore_s,
                                 "hist_full": ilaunch["hist_full"],
                                 "blocks_equal_continuation": same}
        if not same:
            raise AssertionError(f"the initScoreCol fit's trees differ from "
                                 f"the continuation's: {res}")
        # -- D = 4 virtual shards ---------------------------------------
        serial_auc = auc(y, booster.predict(
            Xd, num_iteration=CONT_ITERATIONS + CONT_MESH_ITERATIONS)
            .cpu().numpy())
        mesh = build_mesh(data=MESH_SHARDS,
                          devices=[f"{DEV}:0"] * MESH_SHARDS)
        fits, cont_launches = {}, {k: launches[k] for k in ("hist_full",
                                                            "hist_segment")}
        for method in ("auto", "pallas_ring", "pallas_ring"):
            est = _classifier(numIterations=CONT_MESH_ITERATIONS,
                              device=DEV, collective="ring",
                              histogramMethod=method,
                              initModelPath=path).setMesh(mesh)
            m, fit_s, ml = _counted_fit(est, table, counters)
            mt = m.getModel().trees[CONT_ITERATIONS:]
            msplits = sum(t.num_leaves - 1 for t in mt)
            a = auc(y, m.transform(table)["probability"][:, 1])
            r = {"fit_s": fit_s, "train_auc": a, "splits": msplits,
                 "launches": {k: ml[k] for k in (
                     "hist_full", "ring_allreduce",
                     "fused_segment_hist_ring")},
                 "text": m.getNativeModel()}
            if method in fits:
                fits[method]["same_model_text"] = \
                    fits[method].pop("text") == r["text"]
                continue
            fits[method] = r
            want = ({"ring_allreduce": len(mt) + msplits}
                    if method == "auto" else
                    {"ring_allreduce": len(mt),
                     "fused_segment_hist_ring": msplits})
            if any(ml[k] != v for k, v in want.items()) or \
                    abs(a - serial_auc) > 0.01:
                raise AssertionError(f"{method}: launches {ml} against "
                                     f"{want}, or AUC {a} off the serial "
                                     f"continuation's {serial_auc}")
            k = ("ring_allreduce" if method == "auto"
                 else "fused_segment_hist_ring")
            cont_launches[k] = ml[k]
        fits["auto"].pop("text")
        res["mesh"] = {"shards": MESH_SHARDS,
                       "iterations": CONT_MESH_ITERATIONS,
                       "serial_auc": serial_auc, "fits": fits}
        state["cont_launches"] = cont_launches
        # -- the predictor --------------------------------------------
        pred = booster.predictor()
        timing = {}
        for rows in PREDICT_ROWS:
            sub = Xd[:rows]
            if not torch.equal(pred(sub), booster.predict_margin(sub)):
                raise AssertionError(f"predictor() differs from "
                                     f"predict_margin at {rows} rows")
            timing[rows] = {
                "predictor_ms": median_ms(lambda: pred(sub)),
                "predict_margin_ms": median_ms(
                    lambda: booster.predict_margin(sub))}
        lo = booster.predictor(tree_range=(0, CONT_ITERATIONS))(Xd)
        hi = booster.predictor(tree_range=(CONT_ITERATIONS,
                                           2 * CONT_ITERATIONS),
                               include_init_score=False)(Xd)
        parts_ok = torch.allclose(lo + hi, full, rtol=1e-5, atol=1e-5)
        booster.invalidate_cache()
        try:
            pred(Xd[:1])
            stale = False
        except RuntimeError:
            stale = True
        res["predictor"] = {"mode": pred.mode, "median_ms": timing,
                            "tree_range_parts_sum": parts_ok,
                            "stale_raises": stale}
        if not (parts_ok and stale):
            raise AssertionError(f"tree-range partials or the stale check "
                                 f"failed: {res}")
        # -- leaf indices ---------------------------------------------
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves = booster.predict_leaf_index(Xd)
        torch.cuda.synchronize()
        leaf_s = time.perf_counter() - t0
        L = max(t.num_leaves for t in booster.trees)
        values = torch.zeros(len(booster.trees), L, device=DEV)
        for i, t in enumerate(booster.trees):
            values[i, :t.num_leaves] = torch.as_tensor(
                t.leaf_value.astype(np.float32))
        summed = torch.zeros(N_ROWS, device=DEV)
        for i in range(len(booster.trees)):
            summed += values[i].gather(0, leaves[:, i].long())
        res["leaf_index"] = {
            "shape": list(leaves.shape), "seconds": leaf_s,
            "max_abs_diff": float((summed - full).abs().max()),
            "bit_equal": bool(torch.equal(summed, full))}
        if not torch.allclose(summed, full, rtol=1e-6, atol=0.0):
            raise AssertionError(f"leaf values summed differ from the "
                                 f"margins: {res['leaf_index']}")
        # -- TreeSHAP on the host -------------------------------------
        t0 = time.perf_counter()
        contrib = booster.predict_contrib(X[:SHAP_ROWS])
        shap_s = time.perf_counter() - t0
        err = float(np.abs(contrib.sum(1) - full[:SHAP_ROWS].cpu().numpy())
                    .max())
        res["shap"] = {"rows": SHAP_ROWS, "seconds": shap_s,
                       "local_accuracy_max_abs": err}
        if not np.allclose(contrib.sum(1), full[:SHAP_ROWS].cpu().numpy(),
                           rtol=1e-5, atol=1e-5):
            raise AssertionError(f"TreeSHAP local accuracy: {res['shap']}")
        # -- persistence ----------------------------------------------
        want = cont.transform(table)
        cont.save(os.path.join(tmp, "model"))
        loaded = LightGBMClassificationModel.load(os.path.join(tmp,
                                                               "model"))
        PipelineModel([cont]).save(os.path.join(tmp, "pipeline"))
        piped = PipelineModel.load(os.path.join(tmp, "pipeline"))
        same = {name: all(np.array_equal(np.asarray(m.transform(table)[c]),
                                         np.asarray(want[c]))
                          for c in ("rawPrediction", "probability",
                                    "prediction"))
                for name, m in (("model", loaded), ("pipeline", piped))}
        res["persistence"] = {"device": loaded.getDevice(), **same}
        if not all(same.values()):
            raise AssertionError(f"a loaded stage scores differently: "
                                 f"{res['persistence']}")
        # -- profileTraceDir ------------------------------------------
        trace_dir = os.path.join(tmp, "trace")
        _classifier(numIterations=PROFILE_ITERATIONS, device=DEV,
                    parallelism="serial",
                    profileTraceDir=trace_dir).fit(table)
        n_full = _trace_kernel_count(trace_dir, "hist_full_kernel")
        res["profile_trace"] = {"hist_full_kernels": n_full}
        if n_full != PROFILE_ITERATIONS:
            raise AssertionError(f"the trace names hist_full {n_full} "
                                 f"times, not {PROFILE_ITERATIONS}")
        res["card_vs_cpu"] = _continued_card_vs_cpu(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def _continued_card_vs_cpu(tmp):
    """A base fit on the card at ``CONT_CPU_ROWS`` × 50, continued on the
    card and on the CPU from the same file: the continuation's first
    tree identical, the margins close over the trees whose structure
    matches."""
    import os
    import numpy as np
    X, y = bench_data(CONT_CPU_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    path = os.path.join(tmp, "small_base.txt")
    _classifier(numIterations=CONT_CPU_ITERATIONS, device=DEV) \
        .fit(table).saveNativeModel(path)
    models = {dev: _classifier(numIterations=CONT_CPU_ITERATIONS,
                               device=dev, initModelPath=path)
              .fit(table).getModel() for dev in (DEV, "cpu")}
    tg, tc = models[DEV].trees, models["cpu"].trees
    k = CONT_CPU_ITERATIONS
    while k < min(len(tg), len(tc)) and _same_tree(tg[k], tc[k]):
        k += 1
    mg = models[DEV].predict_margin(X, num_iteration=k).cpu().numpy()
    mc = models["cpu"].predict_margin(X, num_iteration=k,
                                      device="cpu").numpy()
    res = {"rows": CONT_CPU_ROWS, "matching_trees": k,
           "trees": [len(tg), len(tc)],
           "margin_max_abs_diff": float(np.abs(mg - mc).max())}
    if k <= CONT_CPU_ITERATIONS:
        raise AssertionError(f"the continuation's first tree differs "
                             f"between the card and the CPU: {res}")
    if not np.allclose(mg, mc, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"margins over {k} matching trees differ: "
                             f"{res}")
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
    """Where a fit's time goes: ``torch.profiler`` over a
    ``PROFILE_ITERATIONS``-iteration fit at full width (the flagship
    serially and on four virtual shards, and the ranking configuration),
    device time summed by kernel."""
    import torch
    from mmlspark_tpu_torch.gbdt import base, fit_bin_mapper
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    t0 = time.perf_counter()
    base.fit_codes(fit_bin_mapper(X, max_bin=255), X, DEV)
    torch.cuda.synchronize()
    binning_s = time.perf_counter() - t0
    from mmlspark_tpu_torch import build_mesh
    T = PROFILE_ITERATIONS
    est = _classifier(numIterations=T, device=DEV, parallelism="serial")
    serial = profiled_fit(est, table, ("hist_full", "hist_segment"))
    mesh = build_mesh(data=MESH_SHARDS, devices=[f"{DEV}:0"] * MESH_SHARDS)
    ring = _classifier(numIterations=T, device=DEV, collective="ring",
                       histogramMethod="pallas_ring").setMesh(mesh)
    auto = _classifier(numIterations=T, device=DEV, collective="ring",
                       histogramMethod="auto").setMesh(mesh)
    Xr, yr, qr = ranking_data()
    ranking = profiled_fit(
        _ranker(numIterations=T, device=DEV),
        {"features": Xr, "label": yr, "query": qr},
        ("hist_full", "hist_segment"))
    return {"iterations": T, "binning_s": binning_s, **serial,
            "ranking": ranking,
            "pallas_ring_d4": profiled_fit(
                ring, table, ("hist_full", "fused_hist_ring",
                              "ring_allreduce")),
            "auto_d4": profiled_fit(
                auto, table, ("hist_full", "hist_segment",
                              "ring_allreduce"))}


def profiled_fit(est, table, kernels):
    """One fit of ``est`` under ``torch.profiler``, recording the device
    only (no warm-up fit of its own: the phases that profile run after
    ``main_path`` has warmed the card and built the kernels): its wall
    time, the device's busy time and idle share, the device time of the
    named ``kernels`` (``<name>_kernel``), the busiest kernels, and the
    fit's segment sizes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = est.fit(table)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    dev = device_events(prof)
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


def _fused_rows(devices, tag, inputs, accums=("float32", "int32")):
    """fused_segment_hist_ring against its twin on the flagship matrix cut
    into len(devices) shards (shard d holds rows [d·S, (d+1)·S)), in the
    ``accums`` modes."""
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
    for accum in accums:
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
    # the quantized reference configuration's fused kernel: int32 codes
    # (|code| <= 3) on the wide data, 2,048 rows a shard at D = 4
    wide = quant_inputs(kernel_inputs(WIDE_ROWS, WIDE_FEATURES),
                        max_code(16, WIDE_ROWS, MESH_SHARDS))
    rows += [{**r, "path": "quantized_path"} for r in _fused_rows(
        [dev] * MESH_SHARDS, "virtual", wide, ("int32",))]
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
    from mmlspark_tpu_torch import build_mesh
    counters = _counters()
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    mesh = build_mesh(data=MESH_SHARDS,
                      devices=[f"{DEV}:0"] * MESH_SHARDS)
    fits = {}
    for method in ("auto", "pallas_ring"):
        est = _classifier(numIterations=50, device=DEV, collective="ring",
                          histogramMethod=method).setMesh(mesh)
        warm, model, fit_s, launches, host_s, syncs = _timed_fit(
            est, table, counters)
        prob = model.transform(table)["probability"][:, 1]
        trees = model.getModel().trees
        splits = sum(t.num_leaves - 1 for t in trees)
        res = {"shards": MESH_SHARDS, "fit_s": fit_s,
               "train_auc": auc(y, prob), "trees": len(trees),
               "splits": splits, "launches": launches,
               "host_syncs": syncs,
               "same_model_text": same_model_text(warm, model),
               "host_s": host_s}
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
        # fused_hist_ring merges its row tiles in a fixed order: a
        # pallas_ring fit is the same on every run
        if method == "pallas_ring" and not res["same_model_text"]:
            raise AssertionError(f"{method}: the warm-up and timed fits "
                                 f"wrote different trees: {res}")
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
    from mmlspark_tpu_torch import build_mesh
    from mmlspark_tpu_torch.gbdt import engine
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
        warm, model, fit_s, launches, _, syncs = _timed_fit(est, table,
                                                            counters)
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


def _timed_fit(est, table, counters, warm_iterations=WARM_ITERATIONS,
               after_warm=None):
    """A warm-up fit of ``est`` cut to ``warm_iterations`` (``None``: the
    whole fit), ``after_warm()``, then a timed fit with every kernel's
    launch count and the grower's host syncs set to 0 just before it:
    ``(warm-up model, model, fit_s, launches, host_s, host_syncs)``."""
    import torch
    from mmlspark_tpu_torch.gbdt.grower import grow_tree
    if warm_iterations is not None and \
            warm_iterations < est.getOrDefault("numIterations"):
        warm = est.copy({"numIterations": warm_iterations}).fit(table)
    else:
        warm = est.fit(table)
    if after_warm is not None:
        after_warm()
    for fn in counters.values():
        fn.launches = 0
    grow_tree.host_syncs = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    with host_split() as host:
        t0 = time.perf_counter()
        model = est.fit(table)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    _timed_fit.memory = _memory_reading(resident)
    return (warm, model, fit_s,
            {k: fn.launches for k, fn in counters.items()}, host.spans,
            grow_tree.host_syncs)


def _memory_reading(resident):
    """The last fit's device memory: ``torch.cuda.max_memory_allocated()``
    since the reset just before it (``peak_bytes``), what was allocated
    at the reset (``resident_bytes``: earlier phases' cached kernel
    workspaces and models), the fit's own peak (the difference), and the
    fit budget's estimate (``engine.last_fit_budget``) with its terms."""
    import torch
    from mmlspark_tpu_torch.gbdt import engine
    peak = torch.cuda.max_memory_allocated()
    budget = dict(engine.last_fit_budget)
    est = budget.pop("total")
    return {"peak_bytes": peak, "resident_bytes": resident,
            "fit_peak_bytes": peak - resident, "estimate_bytes": est,
            "estimate_over_fit_peak": est / max(1, peak - resident),
            "estimate_terms": budget}


def _memory(name):
    """The last timed fit's memory reading; raises when the fit budget's
    estimate lies below the fit's own peak."""
    m = dict(_timed_fit.memory)
    if m["estimate_bytes"] < m["fit_peak_bytes"]:
        raise AssertionError(f"{name}: the fit budget's estimate lies below "
                             f"the fit's device-memory peak: {m}")
    return m


def _counted_fit(est, table, counters):
    """One fit of ``est`` with the launch counts set to 0 just before it:
    ``(model, fit_s, launches)``."""
    import torch
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = est.fit(table)
    torch.cuda.synchronize()
    return (model, time.perf_counter() - t0,
            {k: fn.launches for k, fn in counters.items()})


def phase_categorical_path(state):
    """The flagship with categorical columns (``categorical_data``): a
    warm-up and a timed serial fit at full width with
    ``categoricalSlotIndexes`` 40–49, against the same fit with the
    columns left numeric; then one data-ring fit and one voting fit
    (``topK`` 5) of ``CAT_MESH_ITERATIONS`` iterations on four virtual
    shards of the card (each the first fit of its configuration, its AUC
    held against the serial fit's first as many iterations), and a
    20,000-row card-vs-CPU check."""
    import numpy as np
    from mmlspark_tpu_torch import build_mesh
    counters = _counters()
    X, y = categorical_data(N_ROWS)
    table = {"features": X, "label": y}
    cats = list(CAT_COLUMNS)
    est = _classifier(numIterations=50, device=DEV, parallelism="serial",
                      categoricalSlotIndexes=cats)
    warm, model, fit_s, launches, host_s, syncs = _timed_fit(
        est, table, counters)
    t0 = time.perf_counter()
    prob = model.transform(table)["probability"][:, 1]
    transform_s = time.perf_counter() - t0
    trees = model.getModel().trees
    splits = sum(t.num_leaves - 1 for t in trees)
    numeric = _classifier(numIterations=50, device=DEV,
                          parallelism="serial").fit(table)
    res = {"rows": N_ROWS, "features": N_FEATURES, "iterations": 50,
           "categorical_columns": cats,
           "cardinalities": list(CAT_CARDINALITIES),
           "fit_s": fit_s, "transform_s": transform_s, "host_s": host_s,
           "host_syncs": syncs, "trees": len(trees), "splits": splits,
           "categorical_splits": sum(t.num_cat for t in trees),
           "launches": launches, "train_auc": auc(y, prob),
           "numeric_train_auc": auc(
               y, numeric.transform(table)["probability"][:, 1]),
           "same_model_text": same_model_text(warm, model)}
    if prob.shape != (N_ROWS,) or not np.isfinite(prob).all():
        raise AssertionError(f"probabilities not finite of shape "
                             f"({N_ROWS},): {res}")
    if launches["hist_full"] != len(trees) or \
            launches["hist_segment"] != splits:
        raise AssertionError(f"launch counts {launches} do not match "
                             f"{len(trees)} trees / {splits} splits: {res}")
    if res["categorical_splits"] < 1:
        raise AssertionError(f"no categorical split: {res}")
    if not res["train_auc"] >= 0.955 or \
            not res["train_auc"] > res["numeric_train_auc"]:
        raise AssertionError(f"train AUC {res['train_auc']} is below 0.955 "
                             f"or the numeric treatment's: {res}")
    if not res["same_model_text"]:
        raise AssertionError(f"the warm-up and timed fits wrote different "
                             f"model text: {res}")
    mesh = build_mesh(data=MESH_SHARDS, devices=[f"{DEV}:0"] * MESH_SHARDS)
    T = CAT_MESH_ITERATIONS
    res["train_auc_at_mesh_iterations"] = auc(
        y, model.getModel().predict_margin(X, num_iteration=T).cpu().numpy())
    fits = {}
    for name, kw, kernel in (
            ("data_ring", dict(collective="ring"), "ring_allreduce"),
            ("voting_ring", dict(collective="ring", parallelism="voting",
                                 topK=5), "ring_allreduce_select")):
        m, mesh_s, counts = _counted_fit(
            _classifier(numIterations=T, device=DEV,
                        categoricalSlotIndexes=cats, **kw).setMesh(mesh),
            table, counters)
        mt = m.getModel().trees
        fits[name] = {"fit_s": mesh_s, "launches": counts,
                      "trees": len(mt),
                      "splits": sum(t.num_leaves - 1 for t in mt),
                      "categorical_splits": sum(t.num_cat for t in mt),
                      "train_auc": auc(
                          y, m.transform(table)["probability"][:, 1])}
        f = fits[name]
        if counts[kernel] != f["trees"] + f["splits"]:
            raise AssertionError(f"{name}: {kernel} launched "
                                 f"{counts[kernel]} times, not once per "
                                 f"tree and split: {fits}")
        if abs(f["train_auc"] - res["train_auc_at_mesh_iterations"]) \
                > 0.01:
            raise AssertionError(f"{name}: AUC not within 0.01 of the "
                                 f"serial fit's first {T} iterations: "
                                 f"{fits}")
    return {**res, "mesh_fits": fits,
            "card_vs_cpu": _categorical_card_vs_cpu()}


def _same_tree(a, b):
    """Whether two trees have the same structure and splits."""
    import numpy as np
    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("split_feature", "threshold", "decision_type",
                         "left_child", "right_child", "cat_boundaries",
                         "cat_threshold"))


def _categorical_card_vs_cpu():
    """The categorical configuration at 20,000 rows and 3 iterations on
    the card and on the CPU, from the init score 0 (``boostFromAverage``
    off): serially and on D = 4 (data ring, voting, feature 1 × 4, and
    ``pallas_ring``, fitted twice on the card for ``same_model_text``).

    At score 0 every first-tree gradient is ±0.5 and every hessian 0.25,
    so each histogram cell is an exact float32 sum on both sides and the
    first trees must agree entirely.  From the label average they need
    not: the card adds a cell's rows in another order than the CPU's
    sequential twin (on an H100, 0.62 apart in the root's largest cells
    at 20,000 rows, the twin the less exact), the sibling subtraction
    carries that error into a deep leaf's small cells, and the
    sorted-subset search orders those cells by their ratio.  That serial
    fit is reported
    (``boost_from_average_matching_splits``: how many leading split
    features agree), not held."""
    import numpy as np
    from mmlspark_tpu_torch import build_mesh
    X, y = categorical_data(20_000)
    table = {"features": X, "label": y}
    D = MESH_SHARDS
    learners = {
        "serial": (None, {}),
        "data_ring": ((D, 1), dict(collective="ring")),
        "voting_ring": ((D, 1), dict(collective="ring",
                                     parallelism="voting", topK=5)),
        "feature_1x4": ((1, D), dict(parallelism="feature")),
        "pallas_ring": ((D, 1), dict(collective="ring",
                                     histogramMethod="pallas_ring")),
    }

    def fit(dev, shape, kw):
        est = _classifier(numIterations=3, device=dev.split(":")[0],
                          categoricalSlotIndexes=list(CAT_COLUMNS), **kw)
        if shape is not None:
            est.setMesh(build_mesh(*shape, devices=[dev] * D))
        return est.fit(table)

    res = {}
    for name, (shape, kw) in learners.items():
        kw = {**kw, "boostFromAverage": False}
        card = fit(f"{DEV}:0", shape, kw)
        cpu = fit("cpu", shape, {k: v for k, v in kw.items()
                                 if k != "histogramMethod"})
        a, b = card.getModel().trees[0], cpu.getModel().trees[0]
        aucs = [auc(y, m.transform(table)["probability"][:, 1])
                for m in (card, cpu)]
        row = {"first_tree_equal": _same_tree(a, b),
               "first_tree_leaf_values_equal": bool(
                   np.array_equal(a.leaf_value, b.leaf_value)),
               "first_tree_categorical_splits": int(a.num_cat),
               "auc_card": aucs[0], "auc_cpu": aucs[1]}
        if name == "pallas_ring":
            row["same_model_text"] = same_model_text(
                card, fit(f"{DEV}:0", shape, kw))
        res[name] = row
        if not row["first_tree_equal"] or abs(aucs[0] - aucs[1]) > 0.002:
            raise AssertionError(f"{name}: the card fit differs from the "
                                 f"cpu fit: {res}")
    a, b = (fit(dev, None, {}).getModel().trees[0]
            for dev in (f"{DEV}:0", "cpu"))
    same = a.split_feature == b.split_feature \
        if len(a.split_feature) == len(b.split_feature) else [False]
    res["boost_from_average_matching_splits"] = int(
        np.argmin(np.append(same, False)))
    return res


def phase_multiclass_path(state):
    """The flagship width with ``NUM_CLASSES`` classes
    (``multiclass_data``): for ``multiclass`` and ``multiclassova`` a
    warm-up and a timed serial fit of ``MULTICLASS_ITERATIONS``
    iterations (K trees an iteration, K root histograms); then one
    multiclass data-ring fit of as many iterations on four virtual
    shards of the card, and a 20,000-row card-vs-CPU check."""
    import numpy as np
    from mmlspark_tpu_torch import build_mesh
    counters = _counters()
    X, y = multiclass_data(N_ROWS)
    table = {"features": X, "label": y}
    K, T = NUM_CLASSES, MULTICLASS_ITERATIONS
    fits = {}
    for objective in ("multiclass", "multiclassova"):
        est = _classifier(numIterations=T, device=DEV, objective=objective,
                          parallelism="serial")
        warm, model, fit_s, launches, host_s, syncs = _timed_fit(
            est, table, counters)
        booster = model.getModel()
        out = model.transform(table)
        first = booster.predict(X, num_iteration=1).cpu().numpy()
        last = booster.predict(X).cpu().numpy()
        trees = booster.trees
        f = fits[objective] = {
            "fit_s": fit_s, "host_s": host_s, "host_syncs": syncs,
            "trees": len(trees),
            "splits": sum(t.num_leaves - 1 for t in trees),
            "launches": launches,
            "train_accuracy": float((out["prediction"] == y).mean()),
            "multi_logloss_first_iteration": multi_logloss(y, first),
            "multi_logloss": multi_logloss(y, last),
            "same_model_text": same_model_text(warm, model)}
        if last.shape != (N_ROWS, K) or not np.isfinite(last).all() or \
                out["probability"].shape != (N_ROWS, K):
            raise AssertionError(f"{objective}: probabilities not finite "
                                 f"of shape ({N_ROWS}, {K}): {f}")
        if f["trees"] != K * T or launches["hist_full"] != K * T or \
                launches["hist_segment"] != f["splits"]:
            raise AssertionError(f"{objective}: {f['trees']} trees, "
                                 f"launches {launches}, not K = {K} a "
                                 f"tree for {T} iterations: {f}")
        if not f["multi_logloss"] < f["multi_logloss_first_iteration"]:
            raise AssertionError(f"{objective}: the multi-logloss did not "
                                 f"fall: {f}")
        if not f["same_model_text"]:
            raise AssertionError(f"{objective}: the warm-up and timed fits "
                                 f"wrote different model text: {f}")
    mesh = build_mesh(data=MESH_SHARDS, devices=[f"{DEV}:0"] * MESH_SHARDS)
    m, mesh_s, counts = _counted_fit(
        _classifier(numIterations=MULTICLASS_ITERATIONS, device=DEV,
                    objective="multiclass",
                    collective="ring").setMesh(mesh), table, counters)
    mt = m.getModel().trees
    mesh_fit = {"iterations": T, "fit_s": mesh_s, "launches": counts,
                "trees": len(mt),
                "splits": sum(t.num_leaves - 1 for t in mt),
                "train_accuracy": float(
                    (m.transform(table)["prediction"] == y).mean())}
    if counts["ring_allreduce"] != mesh_fit["trees"] + mesh_fit["splits"] \
            or mesh_fit["trees"] != T * K:
        raise AssertionError(f"multiclass D = {MESH_SHARDS}: launches do "
                             f"not match the trees and splits: {mesh_fit}")
    return {"rows": N_ROWS, "features": N_FEATURES, "classes": K,
            "iterations": T, "fits": fits, "mesh_data_ring": mesh_fit,
            "card_vs_cpu": _multiclass_card_vs_cpu()}


def _multiclass_card_vs_cpu():
    """Both multiclass objectives at 20,000 × 50 and 3 iterations on the
    card and on the CPU: the first K trees identical, and
    ``Booster.predict`` allclose 1e-4 over the iterations whose K trees
    all match."""
    import numpy as np
    X, y = multiclass_data(20_000)
    table = {"features": X, "label": y}
    K = NUM_CLASSES
    res = {}
    for objective in ("multiclass", "multiclassova"):
        card, cpu = (_classifier(numIterations=3, device=dev,
                                 objective=objective).fit(table).getModel()
                     for dev in (DEV, "cpu"))
        it = 0
        while it < min(len(card.trees), len(cpu.trees)) // K and all(
                _same_tree(a, b) for a, b in
                zip(card.trees[it * K:(it + 1) * K],
                    cpu.trees[it * K:(it + 1) * K])):
            it += 1
        row = {"matching_iterations": it,
               "trees": [len(card.trees), len(cpu.trees)]}
        if it:
            pg = card.predict(X, num_iteration=it).cpu().numpy()
            pc = cpu.predict(X, num_iteration=it, device="cpu").numpy()
            row["prob_max_abs_diff"] = float(np.abs(pg - pc).max())
        res[objective] = row
        if it < 1 or not np.allclose(pg, pc, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{objective}: the card's first iteration "
                                 f"differs from the cpu's: {res}")
    return res


def _recorder(fn):
    """Wrap the function ``fn = (module, name)`` in its module so that its
    calls are kept in ``wrapper.calls`` as ``(args, kwargs, result)``;
    returns ``(wrapper, restore)``."""
    mod, name = fn
    orig = getattr(mod, name)

    def wrapper(*args, **kw):
        out = orig(*args, **kw)
        wrapper.calls.append((args, kw, out))
        return out

    wrapper.calls = []
    setattr(mod, name, wrapper)
    return wrapper, lambda: setattr(mod, name, orig)


def _hist_full_calls(rec):
    """The rows and gh dtype of each ``hist_full`` call a recorder of
    ``ops.histogram.histogram_cuda`` kept."""
    return [(int(args[0].shape[0]), str(args[1].dtype).split(".")[-1])
            for args, _, _ in rec.calls]


def _stop(model):
    return int(model.getModel().params["num_iterations"])


def phase_validation_path(state):
    """The flagship with ``VAL_FRACTION`` of its rows flagged for
    validation (numpy ``default_rng(VAL_SEED)``) and
    ``earlyStoppingRound`` ``VAL_ESR``: a warm-up and a timed serial fit
    (the stop must fire before ``VAL_ITERATIONS``, the model text records
    ``best_iter + 1`` iterations and the forest holds as many trees, the
    two fits write one model text), the device time of one validation
    walk, then a D = 4 data-ring fit on four virtual shards of the card
    under the same rule, and a 20,000-row card-vs-CPU check."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import build_mesh
    from mmlspark_tpu_torch.gbdt import engine
    from mmlspark_tpu_torch.gbdt.grower import predict_tree_binned
    counters = _counters()
    X, y = bench_data(N_ROWS, N_FEATURES)
    val = np.random.default_rng(VAL_SEED).random(N_ROWS) < VAL_FRACTION
    table = {"features": X, "label": y, "val": val}
    kw = dict(numIterations=VAL_ITERATIONS, learningRate=VAL_LR,
              validationIndicatorCol="val", earlyStoppingRound=VAL_ESR)
    est = _classifier(device=DEV, parallelism="serial", **kw)
    walks, restore = _recorder((engine, "predict_tree_binned"))
    try:
        warm, model, fit_s, launches, host_s, syncs = _timed_fit(
            est, table, counters)
    finally:
        restore()
    info = dict(engine.last_validation)
    trees = model.getModel().trees
    # one validation walk (the last tree over the validation bins), timed
    # on the device
    args = walks.calls[-1][0]
    walk_ms = median_ms(lambda: predict_tree_binned(*args))
    prob = model.transform({"features": X[val]})["probability"][:, 1]
    res = {"rows": N_ROWS, "validation_rows": int(val.sum()),
           "iterations_asked": VAL_ITERATIONS, "learning_rate": VAL_LR,
           "early_stopping_round": VAL_ESR, "fit_s": fit_s,
           "host_s": host_s, "host_syncs": syncs,
           "stop_iteration": _stop(model),
           "best_iteration": info["best_iteration"],
           "best_validation_logloss": info["best_metric"],
           "iterations_run": len(info["metrics"]),
           "non_finite_metrics": int(sum(not np.isfinite(v)
                                         for v in info["metrics"])),
           "validation_host_s_per_iteration":
               info["seconds"] / len(info["metrics"]),
           "validation_walk_ms_per_tree": walk_ms, "trees": len(trees),
           "launches": launches, "validation_auc": auc(y[val], prob),
           "same_model_text": same_model_text(warm, model)}
    if not res["stop_iteration"] < VAL_ITERATIONS:
        raise AssertionError(f"the fit did not stop early: {res}")
    if res["stop_iteration"] != info["best_iteration"] + 1 or \
            len(trees) != res["stop_iteration"]:
        raise AssertionError(f"the forest is not cut at best_iter + 1: "
                             f"{res}")
    if launches["hist_full"] != res["iterations_run"]:
        raise AssertionError(f"hist_full did not run once an iteration: "
                             f"{res}")
    if not res["same_model_text"]:
        raise AssertionError(f"the warm-up and timed fits wrote different "
                             f"model text: {res}")
    mesh = build_mesh(data=MESH_SHARDS, devices=[f"{DEV}:0"] * MESH_SHARDS)
    m, mesh_s, counts = _counted_fit(
        _classifier(device=DEV, collective="ring", **kw).setMesh(mesh),
        table, counters)
    minfo = dict(engine.last_validation)
    res["mesh_data_ring"] = {
        "fit_s": mesh_s, "stop_iteration": _stop(m),
        "best_iteration": minfo["best_iteration"],
        "best_validation_logloss": minfo["best_metric"],
        "serial_stop_iteration": res["stop_iteration"], "launches": counts}
    if not (_stop(m) < VAL_ITERATIONS
            and _stop(m) == minfo["best_iteration"] + 1):
        raise AssertionError(f"D = {MESH_SHARDS}: the stop rule did not "
                             f"hold: {res['mesh_data_ring']}")
    if counts["ring_allreduce"] == 0:
        raise AssertionError("D = 4: the ring did not run")
    res["card_vs_cpu"] = _validation_card_vs_cpu()
    torch.cuda.synchronize()
    return res


def _validation_card_vs_cpu():
    """20,000 rows, 10 iterations, ``earlyStoppingRound`` 3, on the card
    and on the CPU, in f32 and with ``quantizedGrad`` "16": the same stop
    iteration, and the validation metrics within 1e-5 relative over the
    iterations whose trees agree on both sides.  The quantized fits sum
    integer codes, exactly on both sides, so every tree and every metric
    must agree; the f32 fits add each histogram cell in another order on
    the card, and a near-tie may part a later tree (reported as
    ``matching_iterations``)."""
    import numpy as np
    from mmlspark_tpu_torch.gbdt import engine
    X, y = bench_data(20_000, N_FEATURES)
    val = np.random.default_rng(VAL_SEED).random(20_000) < VAL_FRACTION
    table = {"features": X, "label": y, "val": val}
    res = {}
    for name, extra in (("float32", {}),
                        ("quantized_16", {"quantizedGrad": "16"})):
        out = {}
        for dev in (DEV, "cpu"):
            m = _classifier(numIterations=10, learningRate=VAL_LR,
                            device=dev, validationIndicatorCol="val",
                            earlyStoppingRound=3, **extra).fit(table)
            out[dev] = (_stop(m), list(engine.last_validation["metrics"]),
                        m.getModel().trees)
        (sa, ma, ta), (sb, mb, tb) = out[DEV], out["cpu"]
        k = 0
        while k < min(len(ta), len(tb)) and _same_tree(ta[k], tb[k]):
            k += 1
        n = min(len(ma), len(mb))
        rel = np.abs(np.subtract(ma[:n], mb[:n])) / np.abs(mb[:n])
        row = res[name] = {
            "stop_iteration": [sa, sb], "matching_iterations": k,
            "metrics_card": ma, "metrics_cpu": mb,
            "metric_max_rel_diff_matching": float(rel[:k].max())
            if k else None,
            "metric_max_rel_diff": float(rel.max())}
        held = k if name == "float32" else n
        if sa != sb or k < 1 or (name != "float32" and k < min(
                len(ta), len(tb))) or float(rel[:held].max()) > 1e-5:
            raise AssertionError(f"{name}: the card's validation differs "
                                 f"from the cpu's: {row}")
    return res


def phase_goss_path(state):
    """The flagship under ``boostingType="goss"`` (``topRate`` 0.2,
    ``otherRate`` 0.1, ``GOSS_ITERATIONS`` iterations): a warm-up and a
    timed serial fit (``hist_full`` once an iteration on the 120,000
    sampled rows, train AUC ≥ 0.955, one model text), the device time of
    one iteration's sampling (the influence sort, the threefry draw and
    its sort, the gathers); then a ``GOSS_MESH_ITERATIONS``-iteration
    D = 4 data-ring fit on four virtual shards (20,000 + 10,000 rows a
    shard), and a 20,000-row card-vs-CPU check."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import build_mesh
    from mmlspark_tpu_torch.gbdt import fit_bin_mapper, get_objective
    from mmlspark_tpu_torch.gbdt.distributed import goss_sample
    from mmlspark_tpu_torch.ops import histogram
    from mmlspark_tpu_torch.ops.threefry import prng_key, split
    counters = _counters()
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    kw = dict(boostingType="goss", topRate=GOSS_TOP_RATE,
              otherRate=GOSS_OTHER_RATE)
    k1, k2 = int(np.ceil(N_ROWS * GOSS_TOP_RATE)), \
        int(np.ceil(N_ROWS * GOSS_OTHER_RATE))
    est = _classifier(numIterations=GOSS_ITERATIONS, device=DEV,
                      parallelism="serial", **kw)
    rec, restore = _recorder((histogram, "histogram_cuda"))
    try:
        warm, model, fit_s, launches, host_s, syncs = _timed_fit(
            est, table, counters, after_warm=rec.calls.clear)
    finally:
        restore()
    timed_rows = sorted({r for r, _ in _hist_full_calls(rec)})
    state["goss_launches"] = launches["hist_full"]
    prob = model.transform(table)["probability"][:, 1]
    trees = model.getModel().trees
    # one iteration's sample at the flagship, from the init gradients
    obj = get_objective("binary")
    w = np.ones(N_ROWS)
    obj.prepare(y, w)
    scores = torch.full((N_ROWS,), obj.init_score(y, w), device=DEV)
    yt = torch.as_tensor(y, dtype=torch.float32, device=DEV)
    g, h = obj.grad_hess(scores, yt, torch.ones_like(yt))
    key = split(prng_key(3, DEV), GOSS_ITERATIONS)[0]
    bins = fit_bin_mapper(X, max_bin=255).transform(X, DEV)

    amp = (1.0 - GOSS_TOP_RATE) / GOSS_OTHER_RATE

    def sample():
        idx, wts = goss_sample(g, h, key, k1, k2, amp)
        return bins[idx], g[idx] * wts, h[idx] * wts

    res = {"rows": N_ROWS, "iterations": GOSS_ITERATIONS,
           "top_rate": GOSS_TOP_RATE, "other_rate": GOSS_OTHER_RATE,
           "sampled_rows": k1 + k2, "fit_s": fit_s, "host_s": host_s,
           "host_syncs": syncs, "trees": len(trees),
           "splits": sum(t.num_leaves - 1 for t in trees),
           "launches": launches, "hist_full_rows": timed_rows,
           "sampling_ms_per_iteration": median_ms(sample),
           "train_auc": auc(y, prob),
           "same_model_text": same_model_text(warm, model)}
    if launches["hist_full"] != GOSS_ITERATIONS or timed_rows != [k1 + k2]:
        raise AssertionError(f"hist_full did not run once an iteration on "
                             f"{k1 + k2} rows: {res}")
    if not res["train_auc"] >= 0.955:
        raise AssertionError(f"train AUC {res['train_auc']} < 0.955: {res}")
    if not res["same_model_text"]:
        raise AssertionError(f"the warm-up and timed fits wrote different "
                             f"model text: {res}")
    mesh = build_mesh(data=MESH_SHARDS, devices=[f"{DEV}:0"] * MESH_SHARDS)
    rec, restore = _recorder((histogram, "histogram_cuda"))
    try:
        m, mesh_s, counts = _counted_fit(
            _classifier(numIterations=GOSS_MESH_ITERATIONS, device=DEV,
                        collective="ring", **kw).setMesh(mesh),
            table, counters)
    finally:
        restore()
    calls = _hist_full_calls(rec)
    mt = m.getModel().trees
    S = N_ROWS // MESH_SHARDS
    res["mesh_data_ring"] = {
        "iterations": GOSS_MESH_ITERATIONS, "fit_s": mesh_s,
        "launches": counts, "trees": len(mt),
        "splits": sum(t.num_leaves - 1 for t in mt),
        "hist_full_rows": sorted({r for r, _ in calls}),
        "train_auc": auc(y, m.transform(table)["probability"][:, 1])}
    mf = res["mesh_data_ring"]
    want_rows = int(np.ceil(S * GOSS_TOP_RATE) + np.ceil(S * GOSS_OTHER_RATE))
    if counts["ring_allreduce"] != mf["trees"] + mf["splits"] or \
            counts["hist_full"] != MESH_SHARDS * mf["trees"] or \
            mf["hist_full_rows"] != [want_rows]:
        raise AssertionError(f"D = {MESH_SHARDS} GOSS: launches do not "
                             f"match: {mf}")
    res["card_vs_cpu"] = _goss_card_vs_cpu()
    return res


def _goss_card_vs_cpu():
    """20,000 × 50, 5 GOSS iterations on the card and on the CPU: the
    first tree identical, and iteration 0's sampled rows equal
    (``torch.equal``)."""
    from mmlspark_tpu_torch.gbdt import distributed
    X, y = bench_data(20_000, N_FEATURES)
    table = {"features": X, "label": y}
    res, samples, models = {}, {}, {}
    for dev in (DEV, "cpu"):
        rec, restore = _recorder((distributed, "goss_sample"))
        try:
            models[dev] = _classifier(
                numIterations=5, device=dev, boostingType="goss",
                topRate=GOSS_TOP_RATE, otherRate=GOSS_OTHER_RATE).fit(table)
        finally:
            restore()
        samples[dev] = rec.calls[0][2][0].cpu()
    a, b = (models[d].getModel().trees[0] for d in (DEV, "cpu"))
    aucs = {d: auc(y, m.transform(table)["probability"][:, 1])
            for d, m in models.items()}
    res = {"first_tree_equal": _same_tree(a, b),
           "iteration0_sample_equal": samples[DEV].shape ==
           samples["cpu"].shape and bool((samples[DEV]
                                          == samples["cpu"]).all()),
           "sampled_rows": int(samples[DEV].numel()), "auc": aucs}
    if not res["first_tree_equal"] or not res["iteration0_sample_equal"]:
        raise AssertionError(f"the card's GOSS fit differs from the cpu's: "
                             f"{res}")
    return res


def _quant_fit_info():
    from mmlspark_tpu_torch.gbdt import engine
    return {k: v for k, v in engine.last_fit_info.items()
            if k.startswith("quantized") or k.startswith("collective")}


def phase_quantized_path(state):
    """Quantized-gradient training: the flagship serially with
    ``quantizedGrad`` "16" (max_code 5,368) and "8" (127), a warm-up and
    a timed fit each (``hist_full`` in its int32 mode once a tree,
    ``hist_segment``'s int32 mode once a split, AUC within 0.005 of
    main_path's f32 flagship fit at as many iterations, one model text);
    the flagship on D = 4 with the ring (the reference's gate turns it to
    psum: ``quantized_unsupported``); the reference's quantized configuration
    (``artifacts/bench_quant_r17.json``: max_code 3, int16 wire) on the
    wide data under the data ring, data ``pallas_ring`` (the int32
    ``fused_hist_ring``, fitted twice: one model text), voting and
    feature 1 × 4; and a 20,000-row card-vs-CPU check."""
    from mmlspark_tpu_torch import build_mesh
    from mmlspark_tpu_torch.ops import histogram
    counters = _counters()
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    f32 = state.get("main_model")
    if f32 is None:
        f32 = _classifier(numIterations=QUANT_ITERATIONS, device=DEV,
                          parallelism="serial").fit(table)
    f32_auc = auc(y, f32.getModel().predict_margin(
        X, num_iteration=QUANT_ITERATIONS).cpu().numpy())
    fits = {}
    for bits in ("16", "8"):
        mc = max_code(int(bits), N_ROWS)
        est = _classifier(numIterations=QUANT_ITERATIONS, device=DEV,
                          parallelism="serial", quantizedGrad=bits)
        rec, restore = _recorder((histogram, "histogram_cuda"))
        try:
            warm, model, fit_s, launches, host_s, syncs = _timed_fit(
                est, table, counters)
        finally:
            restore()
        calls = _hist_full_calls(rec)
        info = _quant_fit_info()
        trees = model.getModel().trees
        splits = sum(t.num_leaves - 1 for t in trees)
        prob = model.transform(table)["probability"][:, 1]
        f = fits[bits] = {
            "fit_s": fit_s, "host_s": host_s, "host_syncs": syncs,
            "trees": len(trees), "splits": splits, "launches": launches,
            "hist_full_modes": sorted({d for _, d in calls}),
            "train_auc": auc(y, prob), "f32_train_auc": f32_auc,
            "fit_info": info,
            "same_model_text": same_model_text(warm, model)}
        if bits == "16":
            state["quant_launches"] = {k: launches[k] for k in
                                       ("hist_full", "hist_segment")}
        if info["quantized_max_code"] != str(mc):
            raise AssertionError(f"{bits} bits: max_code is not {mc}: {f}")
        if launches["hist_full"] != len(trees) or \
                launches["hist_segment"] != splits or \
                f["hist_full_modes"] != ["int32"]:
            raise AssertionError(f"{bits} bits: the int32 kernels did not "
                                 f"run once a tree and split: {f}")
        if abs(f["train_auc"] - f32_auc) > 0.005:
            raise AssertionError(f"{bits} bits: AUC not within 0.005 of the "
                                 f"f32 fit's: {f}")
        if not f["same_model_text"]:
            raise AssertionError(f"{bits} bits: the warm-up and timed fits "
                                 f"wrote different model text: {f}")
    # a tree's quantization at the flagship, on the device: the threefry
    # draw alone, then the whole grid (max, draw, rounding, codes)
    from mmlspark_tpu_torch.gbdt.grower import GrowerConfig, quantize_gh
    from mmlspark_tpu_torch.ops.threefry import fold_in, prng_key, uniform
    _, _, gh, _ = kernel_inputs()
    key = fold_in(prng_key(42, DEV), 1056980546)
    qcfg = GrowerConfig(quantized_bits=16, quantized_seed=42,
                        quantized_max_code=max_code(16, N_ROWS))
    per_tree = {"threefry_uniform_ms": median_ms(
        lambda: uniform(key, (N_ROWS, 2))),
        "quantize_gh_ms": median_ms(lambda: quantize_gh([gh], qcfg))}
    card = [f"{DEV}:0"] * MESH_SHARDS
    _counted_fit(_classifier(numIterations=2, device=DEV, collective="ring",
                             quantizedGrad="16").setMesh(
        build_mesh(data=MESH_SHARDS, devices=card)), table, counters)
    down = _quant_fit_info()
    if down["quantized_downgrade"] != "quantized_unsupported" or \
            down["collective"] != "psum":
        raise AssertionError(f"the D = 4 flagship ring fit was not turned "
                             f"to psum: {down}")
    return {"rows": N_ROWS, "iterations": QUANT_ITERATIONS, "fits": fits,
            "per_tree": per_tree, "flagship_d4_ring": down,
            "reference_configuration": _quantized_wide(state, counters),
            "card_vs_cpu": _quantized_card_vs_cpu()}


def _quantized_wide(state, counters):
    """The reference's quantized configuration (quantizedGrad 16 at 8,192
    rows on a data mesh: max_code 3, int16 wire) on the wide data, 4
    iterations, 31 leaves, maxDepth 30, on four virtual devices."""
    from mmlspark_tpu_torch import build_mesh
    X, y = bench_data(WIDE_ROWS, WIDE_FEATURES)
    table = {"features": X, "label": y}
    card = [f"{DEV}:0"] * MESH_SHARDS
    data_mesh = build_mesh(data=MESH_SHARDS, devices=card)
    learners = {
        "data_ring": (data_mesh, dict(collective="ring")),
        "data_pallas_ring": (data_mesh, dict(collective="ring",
                                             histogramMethod="pallas_ring")),
        "voting_ring": (data_mesh, dict(parallelism="voting",
                                        collective="ring",
                                        topK=WIDE_TOP_K)),
        "feature_1x4": (build_mesh(1, MESH_SHARDS, devices=card),
                        dict(parallelism="feature")),
    }
    fits = {}
    for name, (mesh, kw) in learners.items():
        est = _classifier(numIterations=WIDE_ITERATIONS, maxDepth=30,
                          device=DEV, quantizedGrad="16",
                          **kw).setMesh(mesh)
        m, fit_s, counts = _counted_fit(est, table, counters)
        info = _quant_fit_info()
        trees = m.getModel().trees
        f = fits[name] = {
            "fit_s": fit_s, "launches": counts, "trees": len(trees),
            "splits": sum(t.num_leaves - 1 for t in trees),
            "train_auc": auc(y, m.transform(table)["probability"][:, 1]),
            "fit_info": info,
            "payload_vs_dense": float(info["collective_payload_vs_dense"])}
        if name == "data_pallas_ring":
            state["quant_fused_launches"] = counts["fused_segment_hist_ring"]
            f["same_model_text"] = same_model_text(m, est.fit(table))
            if not f["same_model_text"] or \
                    counts["fused_segment_hist_ring"] != f["splits"]:
                raise AssertionError(f"quantized pallas_ring: {f}")
        want = max_code(16, WIDE_ROWS, 1 if name == "feature_1x4"
                        else MESH_SHARDS)
        if info["quantized_max_code"] != str(want) or (
                name != "feature_1x4" and info["quantized_wire"] != "int16"):
            raise AssertionError(f"{name}: not the reference's grid: {f}")
    return fits


def _quantized_card_vs_cpu():
    """20,000 × 50, 5 quantized iterations ("16", max_code 32,767) on the
    card and on the CPU: the first tree identical; the first tree's
    g-max bits on each side."""
    from mmlspark_tpu_torch.gbdt import grower
    from mmlspark_tpu_torch.ops.threefry import float_bits
    X, y = bench_data(20_000, N_FEATURES)
    table = {"features": X, "label": y}
    models, gmax = {}, {}
    for dev in (DEV, "cpu"):
        rec, restore = _recorder((grower, "quantize_gh"))
        try:
            models[dev] = _classifier(numIterations=5, device=dev,
                                      quantizedGrad="16").fit(table)
        finally:
            restore()
        gh = rec.calls[0][0][0][0]
        gmax[dev] = int(float_bits(gh[:, 0].abs().amax()).cpu())
    a, b = (models[d].getModel().trees[0] for d in (DEV, "cpu"))
    aucs = {d: auc(y, m.transform(table)["probability"][:, 1])
            for d, m in models.items()}
    res = {"first_tree_equal": _same_tree(a, b),
           "first_tree_leaf_values_equal": bool(
               (a.leaf_value == b.leaf_value).all()),
           "gmax_bits": gmax, "gmax_bits_equal": gmax[DEV] == gmax["cpu"],
           "auc": aucs}
    if res["gmax_bits_equal"] and not res["first_tree_equal"]:
        raise AssertionError(f"same g-max bits, yet the card's first "
                             f"quantized tree differs from the cpu's: {res}")
    if not res["gmax_bits_equal"] and abs(aucs[DEV] - aucs["cpu"]) > 0.002:
        raise AssertionError(f"the card's quantized fit differs from the "
                             f"cpu's: {res}")
    return res


def _regressor(**kw):
    from mmlspark_tpu_torch import LightGBMRegressor
    return LightGBMRegressor(**{**dict(learningRate=0.1, numLeaves=31,
                                       maxBin=255, minDataInLeaf=20,
                                       verbosity=0), **kw})


def _splits(model):
    return sum(t.num_leaves - 1 for t in model.getModel().trees)


def phase_objectives_path(state):
    """Each of ``OBJECTIVES`` on the flagship's features with its
    family's label (``objective_data``), ``OBJ_ITERATIONS`` iterations
    after one warm-up fit: fit seconds, the LightGBM metric at the first
    and the last iteration (it must fall), ``transform`` equal to the
    objective's ``transform_prediction`` of ``predict_margin``,
    ``hist_full`` once a tree and ``hist_segment`` once a split; then the
    card-vs-CPU check."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.gbdt import get_objective
    counters = _counters()
    X, y = objective_data("huber")
    _regressor(objective="huber", numIterations=WARM_ITERATIONS,
               device=DEV).fit({"features": X, "label": y})
    res = {"rows": N_ROWS, "iterations": OBJ_ITERATIONS, "fits": {}}
    for name in OBJECTIVES:
        X, y = objective_data(name)
        table = {"features": X, "label": y}
        model, fit_s, counts = _counted_fit(
            _regressor(objective=name, numIterations=OBJ_ITERATIONS,
                       device=DEV), table, counters)
        booster = model.getModel()
        m0, mT = (booster.predict_margin(X, num_iteration=k).cpu().numpy()
                  for k in (1, OBJ_ITERATIONS))
        t0 = time.perf_counter()
        pred = model.transform(table)["prediction"]
        transform_s = time.perf_counter() - t0
        want = get_objective(name).transform_prediction(
            booster.predict_margin(X)).cpu().numpy().astype(np.float64)
        row = res["fits"][name] = {
            "fit_s": fit_s, "transform_s": transform_s,
            "loss_iteration_0": objective_loss(name, y, m0),
            "loss_last_iteration": objective_loss(name, y, mT),
            "trees": len(booster.trees), "splits": _splits(model),
            "launches": {k: counts[k] for k in ("hist_full",
                                                "hist_segment")},
            "transform_is_the_objective_s": bool(np.array_equal(pred,
                                                                want))}
        if not row["loss_last_iteration"] < row["loss_iteration_0"]:
            raise AssertionError(f"{name}: the loss did not fall: {row}")
        if not row["transform_is_the_objective_s"] or \
                not np.isfinite(pred).all():
            raise AssertionError(f"{name}: transform is not the "
                                 f"objective's transform: {row}")
        if row["launches"] != {"hist_full": row["trees"],
                               "hist_segment": row["splits"]}:
            raise AssertionError(f"{name}: launches do not match the "
                                 f"trees and splits: {row}")
    state["objective_launches"] = {
        k: sum(r["launches"][k] for r in res["fits"].values())
        for k in ("hist_full", "hist_segment")}
    res["card_vs_cpu"] = _objectives_card_vs_cpu()
    torch.cuda.synchronize()
    return res


def _matching(ta, tb):
    k = 0
    while k < min(len(ta), len(tb)) and _same_tree(ta[k], tb[k]):
        k += 1
    return k


def _objectives_card_vs_cpu():
    """20,000 rows, 3 iterations of each objective on the card and on the
    CPU: the first tree identical, the predictions within 1e-4 over the
    matching iterations (the f32 histograms add each cell in another
    order on the card, so a near-tie may part a later tree)."""
    import numpy as np
    out = {}
    for name in OBJECTIVES:
        X, y = objective_data(name, 20_000)
        table = {"features": X, "label": y}
        models = {d: _regressor(objective=name, numIterations=3,
                                device=d).fit(table) for d in (DEV, "cpu")}
        k = _matching(*(models[d].getModel().trees for d in (DEV, "cpu")))
        pa = models[DEV].getModel().predict(X, num_iteration=k)
        pb = models["cpu"].getModel().predict(X, num_iteration=k,
                                              device="cpu")
        diff = float((pa.cpu() - pb).abs().max()) if k else None
        out[name] = {"matching_trees": k, "prediction_max_abs_diff": diff}
        if k < 1 or not np.allclose(pa.cpu().numpy(), pb.numpy(),
                                    rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{name}: the card's fit differs from the "
                                 f"cpu's: {out[name]}")
    return out


def phase_dart_path(state):
    """The flagship under DART with LightGBM's default drops,
    ``DART_ITERATIONS`` iterations, a warm-up and a timed fit; a D = 4
    fit asking for the ring (psum, downgrade ``"dart"``); the card-vs-CPU
    check."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import build_mesh
    from mmlspark_tpu_torch.gbdt import engine
    from mmlspark_tpu_torch.gbdt.grower import leaf_index_binned
    counters = _counters()
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    kw = dict(boostingType="dart", dropRate=0.1, maxDrop=50, skipDrop=0.5,
              dropSeed=4)
    est = _classifier(numIterations=DART_ITERATIONS, device=DEV,
                      parallelism="serial", **kw)
    drops, restore_d = _recorder((engine, "_dart_draw_drops"))
    fits, restore_f = _recorder((engine, "_dart_fit"))
    try:
        # a whole warm-up fit: DART rescales the trees it drops, so a
        # shorter fit's trees are not the first trees of this one
        warm, model, fit_s, launches, host_s, syncs = _timed_fit(
            est, table, counters, warm_iterations=None)
    finally:
        restore_d()
        restore_f()
    per_iteration = [len(out) for _, _, out in drops.calls[-DART_ITERATIONS:]]
    args, _, (trees_dev, _, _, scores) = fits.calls[-1]
    bins = args[0].bins[0]
    t0 = time.perf_counter()
    prob = model.transform(table)["probability"][:, 1]
    transform_s = time.perf_counter() - t0
    booster = model.getModel()
    trees = booster.trees
    margin = booster.predict_margin(X)
    # the exported trees (scales and init baked in) walked over the bins,
    # added in tree order as predict_margin adds them
    binned = torch.zeros_like(margin)
    for t, host in zip(trees_dev, trees):
        binned += torch.as_tensor(host.leaf_value, dtype=torch.float32,
                                  device=bins.device)[
            leaf_index_binned(t, bins, 31)]
    scores = scores[0]
    res = {"rows": N_ROWS, "iterations": DART_ITERATIONS, **kw,
           "fit_s": fit_s, "transform_s": transform_s, "host_s": host_s,
           "host_syncs": syncs, "trees": len(trees),
           "splits": _splits(model), "launches": launches,
           "drops_per_iteration": per_iteration,
           "train_auc": auc(y, prob),
           "scores_vs_binned_model_max_abs_diff": float(
               (scores - binned).abs().max()),
           "margin_max_abs": float(margin.abs().max()),
           "rows_where_thresholds_route_apart": int(
               (margin != binned).sum()),
           "same_model_text": same_model_text(warm, model)}
    state["dart_launches"] = launches
    if not res["train_auc"] >= DART_MIN_AUC:
        raise AssertionError(f"train AUC {res['train_auc']} < "
                             f"{DART_MIN_AUC}: {res}")
    if not max(per_iteration) > 0:
        raise AssertionError(f"no iteration dropped a tree: {res}")
    if res["scores_vs_binned_model_max_abs_diff"] > \
            1e-5 * res["margin_max_abs"]:
        raise AssertionError(f"the training scores are not the exported "
                             f"model's margins: {res}")
    if launches["hist_full"] != len(trees) or \
            launches["hist_segment"] != res["splits"]:
        raise AssertionError(f"launches do not match the trees and "
                             f"splits: {res}")
    if not res["same_model_text"]:
        raise AssertionError(f"the warm-up and timed fits wrote different "
                             f"model text: {res}")
    mesh = build_mesh(data=MESH_SHARDS, devices=[f"{DEV}:0"] * MESH_SHARDS)
    m, mesh_s, counts = _counted_fit(
        _classifier(numIterations=DART_MESH_ITERATIONS, device=DEV,
                    collective="ring", **kw).setMesh(mesh), table, counters)
    res["mesh_psum"] = {
        "iterations": DART_MESH_ITERATIONS, "fit_s": mesh_s,
        "launches": counts,
        "collective": engine.last_fit_info["collective"],
        "collective_downgrade": engine.last_fit_info["collective_downgrade"],
        "train_auc": auc(y, m.transform(table)["probability"][:, 1])}
    if res["mesh_psum"]["collective_downgrade"] != "dart" or \
            counts["hist_full"] != MESH_SHARDS * len(m.getModel().trees):
        raise AssertionError(f"D = {MESH_SHARDS} DART: {res['mesh_psum']}")
    res["card_vs_cpu"] = _dart_card_vs_cpu()
    torch.cuda.synchronize()
    return res


def _dart_card_vs_cpu():
    """20,000 rows, 5 DART iterations dropping in every iteration
    (``skipDrop`` 0, ``dropRate`` 0.5) on the card and on the CPU: the
    first tree identical, the same scales (the same drops), AUCs within
    0.002."""
    X, y = bench_data(20_000, N_FEATURES)
    table = {"features": X, "label": y}
    models = {d: _classifier(numIterations=5, device=d, boostingType="dart",
                             skipDrop=0.0, dropRate=0.5).fit(table)
              for d in (DEV, "cpu")}
    ta, tb = (models[d].getModel().trees for d in (DEV, "cpu"))
    aucs = {d: auc(y, m.transform(table)["probability"][:, 1])
            for d, m in models.items()}
    res = {"matching_trees": _matching(ta, tb),
           "same_scales": [t.shrinkage for t in ta]
           == [t.shrinkage for t in tb], "auc": aucs}
    if res["matching_trees"] < 1 or not res["same_scales"] or \
            abs(aucs[DEV] - aucs["cpu"]) > 0.002:
        raise AssertionError(f"the card's DART fit differs from the cpu's: "
                             f"{res}")
    return res


def phase_rf_path(state):
    """The flagship as a random forest, ``RF_ITERATIONS`` iterations; then
    D = 4 fits under the data ring, ``pallas_ring`` and voting, each
    against the serial fit's first ``RF_MESH_ITERATIONS`` iterations; the
    card-vs-CPU check."""
    import torch
    from mmlspark_tpu_torch import build_mesh
    counters = _counters()
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    kw = dict(boostingType="rf", baggingFraction=0.8, baggingFreq=1,
              featureFraction=0.8)
    model, fit_s, launches = _counted_fit(
        _classifier(numIterations=RF_ITERATIONS, device=DEV,
                    parallelism="serial", **kw), table, counters)
    booster = model.getModel()
    serial_t = auc(y, booster.predict_margin(
        X, num_iteration=RF_MESH_ITERATIONS).cpu().numpy())
    res = {"rows": N_ROWS, "iterations": RF_ITERATIONS, **kw,
           "fit_s": fit_s, "launches": launches,
           "trees": len(booster.trees), "splits": _splits(model),
           "train_auc": auc(y, model.transform(table)["probability"][:, 1]),
           "train_auc_at_mesh_iterations": serial_t, "mesh": {}}
    if launches["hist_full"] != len(booster.trees) or \
            launches["hist_segment"] != res["splits"]:
        raise AssertionError(f"launches do not match: {res}")
    mesh = build_mesh(data=MESH_SHARDS, devices=[f"{DEV}:0"] * MESH_SHARDS)
    for name, extra in (("data_ring", dict(collective="ring")),
                        ("pallas_ring", dict(collective="ring",
                                             histogramMethod="pallas_ring")),
                        ("voting_ring", dict(collective="ring",
                                             parallelism="voting",
                                             topK=RF_TOP_K))):
        m, mesh_s, counts = _counted_fit(
            _classifier(numIterations=RF_MESH_ITERATIONS, device=DEV,
                        **kw, **extra).setMesh(mesh), table, counters)
        T, S = len(m.getModel().trees), _splits(m)
        row = res["mesh"][name] = {
            "fit_s": mesh_s, "launches": counts, "trees": T, "splits": S,
            "train_auc": auc(y, m.transform(table)["probability"][:, 1])}
        want = {"data_ring": ("ring_allreduce", T + S),
                "pallas_ring": ("fused_segment_hist_ring", S),
                "voting_ring": ("ring_allreduce_select", T + S)}[name]
        if counts[want[0]] != want[1] or \
                abs(row["train_auc"] - serial_t) > 0.01:
            raise AssertionError(f"D = {MESH_SHARDS} rf {name}: {row}")
    state["rf_launches"] = {k: sum(r["launches"][k]
                                   for r in res["mesh"].values())
                            for k in counters}
    res["card_vs_cpu"] = _rf_card_vs_cpu(kw)
    torch.cuda.synchronize()
    return res


def _rf_card_vs_cpu(kw):
    X, y = bench_data(20_000, N_FEATURES)
    table = {"features": X, "label": y}
    models = {d: _classifier(numIterations=5, device=d, **kw).fit(table)
              for d in (DEV, "cpu")}
    aucs = {d: auc(y, m.transform(table)["probability"][:, 1])
            for d, m in models.items()}
    res = {"matching_trees": _matching(*(models[d].getModel().trees
                                         for d in (DEV, "cpu"))),
           "auc": aucs}
    if res["matching_trees"] < 1 or abs(aucs[DEV] - aucs["cpu"]) > 0.002:
        raise AssertionError(f"the card's rf fit differs from the cpu's: "
                             f"{res}")
    return res


def _ranker(**kw):
    from mmlspark_tpu_torch import LightGBMRanker
    return LightGBMRanker(**{**dict(learningRate=0.1, numLeaves=31,
                                    maxBin=255, minDataInLeaf=20,
                                    maxPosition=30, sigma=1.0,
                                    verbosity=0), **kw})


def _ndcgs(scores, y, q):
    from mmlspark_tpu_torch import ndcg_at_k
    return {f"ndcg@{k}": ndcg_at_k(scores, y, q, k) for k in RANK_EVAL_AT}


def phase_ranking_path(state):
    """``LightGBMRanker`` on ``ranking_data``: a warm-up and a timed fit
    of ``RANK_ITERATIONS`` iterations, the lambda gradient timed alone,
    train NDCG against the score-0 baseline; a held-out fit with early
    stopping; a D = 4 data fit; the card-vs-CPU check."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch import build_mesh
    from mmlspark_tpu_torch.gbdt import engine
    from mmlspark_tpu_torch.gbdt.ranking import LambdarankGradient
    counters = _counters()
    X, y, q = ranking_data()
    table = {"features": X, "label": y, "query": q}
    est = _ranker(numIterations=RANK_ITERATIONS, device=DEV,
                  parallelism="serial")
    warm, model, fit_s, launches, host_s, syncs = _timed_fit(est, table,
                                                            counters)
    t0 = time.perf_counter()
    pred = model.transform(table)["prediction"]
    transform_s = time.perf_counter() - t0
    grad = LambdarankGradient.serial(y, q, 1.0, 30, DEV)
    zero = torch.zeros(len(y), device=DEV)
    lam_ms = median_ms(lambda: grad.grad_hess(0, zero), reps=5, warm=1)
    trees = model.getModel().trees
    splits = _splits(model)
    base = _ndcgs(np.zeros_like(pred), y, q)
    got = _ndcgs(pred, y, q)
    state["rank_launches"] = {k: launches[k] for k in ("hist_full",
                                                       "hist_segment")}
    res = {"queries": RANK_QUERIES, "rows": len(y),
           "features": RANK_FEATURES, "iterations": RANK_ITERATIONS,
           "max_documents": int(np.bincount(q).max()), "fit_s": fit_s,
           "transform_s": transform_s, "host_s": host_s,
           "host_syncs": syncs, "lambda_gradient_ms_per_iteration": lam_ms,
           "trees": len(trees), "splits": splits, "launches": launches,
           "train_ndcg": got, "baseline_ndcg": base,
           "same_model_text": same_model_text(warm, model),
           "memory": _memory("ranking_path")}
    if pred.shape != (len(y),) or not np.isfinite(pred).all():
        raise AssertionError(f"predictions not finite: {res}")
    if got["ndcg@10"] < base["ndcg@10"] + 0.1:
        raise AssertionError(f"NDCG@10 rose less than 0.1: {res}")
    if launches["hist_full"] != len(trees) or \
            launches["hist_segment"] != splits:
        raise AssertionError(f"launches do not match the trees and "
                             f"splits: {res}")
    if not res["same_model_text"]:
        raise AssertionError(f"the warm-up and timed fits wrote different "
                             f"model text: {res}")
    val = np.isin(q, np.random.default_rng(5).choice(
        RANK_QUERIES, RANK_QUERIES // 5, replace=False))
    m, es_s, counts = _counted_fit(
        _ranker(numIterations=RANK_ITERATIONS, learningRate=RANK_ES_LR,
                device=DEV, validationIndicatorCol="val",
                earlyStoppingRound=10),
        {**table, "val": val}, counters)
    info = dict(engine.last_validation)
    res["early_stopping"] = {
        "validation_queries": RANK_QUERIES // 5,
        "learning_rate": RANK_ES_LR, "fit_s": es_s,
        "stop_iteration": _stop(m),
        "best_iteration": info["best_iteration"],
        "best_validation_ndcg@10": -info["best_metric"],
        "iterations_run": len(info["metrics"])}
    stopped = len(info["metrics"]) < RANK_ITERATIONS
    res["early_stopping"]["stopped_early"] = stopped
    if _stop(m) != (info["best_iteration"] + 1 if stopped
                    else RANK_ITERATIONS) or len(m.getModel().trees) != \
            _stop(m):
        raise AssertionError(f"the stop rule did not hold: "
                             f"{res['early_stopping']}")
    mesh = build_mesh(data=MESH_SHARDS, devices=[f"{DEV}:0"] * MESH_SHARDS)
    m, mesh_s, counts = _counted_fit(
        _ranker(numIterations=RANK_MESH_ITERATIONS, device=DEV)
        .setMesh(mesh), table, counters)
    res["mesh_data_psum"] = {
        "iterations": RANK_MESH_ITERATIONS, "fit_s": mesh_s,
        "launches": counts,
        "train_ndcg": _ndcgs(m.transform(table)["prediction"], y, q)}
    if counts["hist_full"] != MESH_SHARDS * len(m.getModel().trees):
        raise AssertionError(f"D = {MESH_SHARDS} ranking: "
                             f"{res['mesh_data_psum']}")
    res["card_vs_cpu"] = _ranking_card_vs_cpu()
    torch.cuda.synchronize()
    return res


def _ranking_card_vs_cpu():
    """200 queries, 5 iterations on the card and on the CPU: the lambda
    gradients at score 0 equal (``torch.equal``), the first tree
    identical, NDCG@10 within 0.002."""
    import torch
    from mmlspark_tpu_torch.gbdt.ranking import LambdarankGradient
    X, y, q = ranking_data(200)
    table = {"features": X, "label": y, "query": q}
    grads = [LambdarankGradient.serial(y, q, 1.0, 30, d).grad_hess(
        0, torch.zeros(len(y), device=d)) for d in (DEV, "cpu")]
    models = {d: _ranker(numIterations=5, device=d).fit(table)
              for d in (DEV, "cpu")}
    ndcg = {d: _ndcgs(m.transform(table)["prediction"], y, q)["ndcg@10"]
            for d, m in models.items()}
    res = {"rows": len(y),
           "gradients_equal": all(torch.equal(a.cpu(), b)
                                  for a, b in zip(*grads)),
           "matching_trees": _matching(*(models[d].getModel().trees
                                         for d in (DEV, "cpu"))),
           "ndcg@10": ndcg}
    if not res["gradients_equal"] or res["matching_trees"] < 1 or \
            abs(ndcg[DEV] - ndcg["cpu"]) > 0.002:
        raise AssertionError(f"the card's ranking fit differs from the "
                             f"cpu's: {res}")
    return res


def flight_data(n):
    """Data of the Flight Delay set's shape (Ke et al., NIPS 2017, Table 1;
    built as szilard/benchm-ml's one-hot airline columns), from numpy
    ``default_rng(6)``: one-hot blocks of ``FLIGHT_ONEHOT`` (carriers and
    airports Zipf-distributed, the calendar uniform) and the dense
    DepTime (hhmm) and Distance (miles) columns, ``FLIGHT_FEATURES`` in
    all, float32; a delay label of about 19% positives from additive
    effects of every column plus logistic noise."""
    import numpy as np
    rng = np.random.default_rng(6)
    X = np.zeros((n, FLIGHT_FEATURES), np.float32)
    logit = np.zeros(n)
    col = 0
    for name, k in FLIGHT_ONEHOT:
        if name in FLIGHT_ZIPF:
            p = 1.0 / np.arange(1, k + 1) ** 1.1
            ids = rng.choice(k, size=n, p=p / p.sum())
        else:
            ids = rng.integers(0, k, size=n)
        X[np.arange(n), col + ids] = 1.0
        logit += rng.normal(scale=0.35, size=k)[ids]
        col += k
    hour = rng.integers(5, 24, size=n)
    dep = hour * 100 + rng.integers(0, 60, size=n)
    dist = np.exp(rng.normal(6.4, 0.6, size=n))
    X[:, col] = dep
    X[:, col + 1] = dist
    logit += 0.09 * (hour - 14) + 0.2 * np.log(dist / 600)
    score = logit + rng.logistic(size=n)
    y = (score > np.quantile(score, 1 - FLIGHT_POSITIVE)).astype("float64")
    return X, y


def _shape_spy():
    """Wrap ``ops.histogram``'s two kernel wrappers so that every call
    keeps ``(kernel, columns, bins, code dtype)`` in ``calls`` (shapes
    only: no tensor is held); returns ``(calls, restore)``."""
    from mmlspark_tpu_torch.ops import histogram
    calls = []
    saved = {name: getattr(histogram, name)
             for name in ("histogram_cuda", "histogram_cuda_fused")}

    def spy(kernel, fn):
        def wrapped(bins, gh, *args):
            calls.append((kernel, int(bins.shape[1]), int(args[-2])
                          if kernel == "hist_segment" else int(args[0]),
                          str(bins.dtype).split(".")[-1]))
            return fn(bins, gh, *args)
        return wrapped

    histogram.histogram_cuda = spy("hist_full", saved["histogram_cuda"])
    histogram.histogram_cuda_fused = spy("hist_segment",
                                         saved["histogram_cuda_fused"])

    def restore():
        for name, fn in saved.items():
            setattr(histogram, name, fn)
    return calls, restore


def _spied_fit(fit):
    """``fit()`` under :func:`_shape_spy`: ``(its result, the calls)``."""
    calls, restore = _shape_spy()
    try:
        return fit(), calls
    finally:
        restore()


def _card_vs_cpu(table, y, **kw):
    """The classifier of ``kw`` at 5 iterations on the card and on the
    CPU: the first tree identical, margins within 1e-4 over the matching
    trees, AUCs within 0.002."""
    import numpy as np
    models = {d: _classifier(numIterations=5, device=d, **kw).fit(table)
              for d in (DEV, "cpu")}
    k = _matching(*(models[d].getModel().trees for d in (DEV, "cpu")))
    X = table["features"]
    mg = models[DEV].getModel().predict_margin(X, num_iteration=k)
    mc = models["cpu"].getModel().predict_margin(X, num_iteration=k,
                                                 device="cpu")
    aucs = {d: auc(y, m.transform(table)["probability"][:, 1])
            for d, m in models.items()}
    res = {"rows": len(y), "matching_trees": k, "auc": aucs,
           "margin_max_abs_diff": float((mg.cpu() - mc).abs().max())
           if k else None}
    if k < 1 or abs(aucs[DEV] - aucs["cpu"]) > 0.002 or not np.allclose(
            mg.cpu().numpy(), mc.numpy(), rtol=1e-4, atol=1e-4):
        raise AssertionError(f"the card's fit differs from the cpu's: {res}")
    return res


def _efb_kernel_rows():
    """hist_full and hist_segment (median segment) at ``flight_data``'s G
    bundle columns (uint8; the plan an ``enableBundle`` fit makes) and at
    its 674 unbundled columns, f32, tagged ``path`` efb_path /
    efb_path_unbundled.  Most rows of a bundle (or of a one-hot column)
    fall in one bin, so the twins are held within :func:`compare`'s
    order-free cell bound; ``hist_full`` at the G columns is held to its
    stated order bit for bit as well."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.gbdt import engine, fit_bin_mapper, get_objective
    X, y = flight_data(FLIGHT_ROWS)
    mapper = fit_bin_mapper(X, max_bin=255)
    bins = mapper.transform(X, "cpu")
    maps, bundled = engine._build_efb(bins.numpy(), mapper,
                                      engine.TrainParams(verbosity=0),
                                      X.shape[1])
    obj = get_objective("binary")
    w = np.ones(len(y))
    obj.prepare(y, w)
    yt = torch.as_tensor(y, dtype=torch.float32, device=DEV)
    scores = torch.full_like(yt, obj.init_score(y, w))
    g, h = obj.grad_hess(scores, yt, torch.ones_like(yt))
    gh = torch.stack([g, h, torch.ones_like(g)], dim=1)
    gh_int = torch.round(gh / (gh.abs().amax(0).clamp(min=1e-30) / 127)
                         ).to(torch.int32)
    order = torch.randperm(len(y), generator=torch.Generator().manual_seed(
        0)).to(torch.int32).to(DEV)
    rows = []
    for tag, b in (("efb_path", bundled), ("efb_path_unbundled",
                                           bins.numpy())):
        inputs = (torch.as_tensor(b, device=DEV), mapper.num_total_bins,
                  gh, gh_int)
        rows.append({**_full_row(inputs, "float32", tag == "efb_path",
                                 cell_bound=True), "path": tag})
        rows.append({**_segment_row(inputs, order, MEDIAN_SEGMENT,
                                    "float32", cell_bound=True),
                     "path": tag})
    return rows


def phase_efb_path(state):
    """Exclusive Feature Bundling on ``flight_data`` (100,000 × 674): a
    warm-up and a timed bundled fit (``enableBundle``), the unbundled fit,
    bundled GOSS and DART fits, D = 4 data-ring fits (``auto`` and
    ``pallas_ring``), and a 20,000-row card-vs-CPU check."""
    import numpy as np
    from mmlspark_tpu_torch import build_mesh
    from mmlspark_tpu_torch.gbdt import engine
    counters = _counters()
    t0 = time.perf_counter()
    X, y = flight_data(FLIGHT_ROWS)
    table = {"features": X, "label": y}
    data_s = time.perf_counter() - t0
    common = dict(numIterations=FLIGHT_ITERATIONS, device=DEV)

    def run(name, est, warm=False):
        if warm:
            calls, restore = _shape_spy()
            try:
                warm_m, model, fit_s, launches, host_s, syncs = _timed_fit(
                    est, table, counters, after_warm=calls.clear)
            finally:
                restore()
        else:
            (model, fit_s, launches), calls = _spied_fit(
                lambda: _counted_fit(est, table, counters))
        info = dict(engine.last_fit_info)
        t1 = time.perf_counter()
        prob = model.transform(table)["probability"][:, 1]
        res = {"fit_s": fit_s, "transform_s": time.perf_counter() - t1,
               "train_auc": auc(y, prob),
               "trees": len(model.getModel().trees),
               "splits": _splits(model), "launches": launches,
               "bundles": int(info["efb_bundles"]),
               "efb_gate": info["efb_gate"],
               "histogram_columns": sorted({c for _, c, _, _ in calls})}
        if warm:
            res["same_model_text"] = same_model_text(warm_m, model)
            res["host_s"] = host_s
            res["binning_s"] = host_s["binning_s"]
            res["memory"] = _memory(f"efb_path {name}")
        if not np.isfinite(prob).all():
            raise AssertionError(f"{name}: probabilities not finite: {res}")
        return res, calls

    fits = {}
    fits["bundled"], calls = run(
        "bundled", _classifier(enableBundle=True, **common), warm=True)
    G = fits["bundled"]["bundles"]
    fits["unbundled"], _ = run("unbundled", _classifier(**common))
    short = {**common, "numIterations": FLIGHT_MESH_ITERATIONS}
    fits["goss"], _ = run("goss", _classifier(
        enableBundle=True, boostingType="goss", **short))
    fits["dart"], _ = run("dart", _classifier(
        enableBundle=True, boostingType="dart", **short))
    mesh = build_mesh(data=MESH_SHARDS, devices=[f"{DEV}:0"] * MESH_SHARDS)
    for method in ("auto", "pallas_ring"):
        fits[f"ring_{method}"], _ = run(method, _classifier(
            enableBundle=True, numIterations=FLIGHT_MESH_ITERATIONS,
            device=DEV, collective="ring",
            histogramMethod=method).setMesh(mesh))
    b = fits["bundled"]
    res = {"rows": FLIGHT_ROWS, "features": FLIGHT_FEATURES,
           "bundles": G, "data_s": data_s, "fits": fits,
           "auc_gap": b["train_auc"] - fits["unbundled"]["train_auc"]}
    state["efb_launches"] = {k: b["launches"][k]
                             for k in ("hist_full", "hist_segment")}
    rows_g = [r["features"] for r in state.get("kernel_rows", [])
              if r.get("path") == "efb_path"]
    if rows_g and set(rows_g) != {G}:
        raise AssertionError(f"the kernels phase's EFB rows are at {rows_g} "
                             f"columns, the fits' plan at {G}")
    res["card_vs_cpu"] = _card_vs_cpu(
        {"features": X[:20_000], "label": y[:20_000]}, y[:20_000],
        enableBundle=True)
    bad = [name for name, r in fits.items() if name != "unbundled" and (
        r["efb_gate"] != "none" or r["histogram_columns"] != [G])]
    if not 1 < G < FLIGHT_FEATURES or bad or \
            fits["unbundled"]["histogram_columns"] != [FLIGHT_FEATURES]:
        raise AssertionError(f"bundled fits {bad} launched histograms at "
                             f"other than the {G} bundle columns: {res}")
    if len(calls) != b["launches"]["hist_full"] + b["launches"][
            "hist_segment"] or b["launches"]["hist_full"] != b["trees"] \
            or b["launches"]["hist_segment"] != b["splits"]:
        raise AssertionError(f"the timed bundled fit's launches do not "
                             f"match its trees and splits: {res}")
    r = fits["ring_pallas_ring"]
    if r["launches"]["fused_segment_hist_ring"] != r["splits"]:
        raise AssertionError(f"pallas_ring: fused_hist_ring not once a "
                             f"split: {res}")
    if abs(res["auc_gap"]) > 0.002:
        raise AssertionError(f"the bundled AUC is not within 0.002 of the "
                             f"unbundled: {res}")
    if not b["same_model_text"]:
        raise AssertionError(f"the bundled warm-up and timed fits wrote "
                             f"different model text: {res}")
    return res


def phase_wide_bins_path(state):
    """The flagship at ``maxBin`` 1023 (B = 1,024) and 511 (B = 512):
    warm-up and timed serial fits, D = 4 data-ring fits (``auto`` and
    ``pallas_ring``) at 1023, and a 20,000-row card-vs-CPU check."""
    import numpy as np
    from mmlspark_tpu_torch import build_mesh
    counters = _counters()
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    fits = {}
    for max_bin in WIDE_MAX_BINS:
        calls, restore = _shape_spy()
        try:
            warm, model, fit_s, launches, host_s, syncs = _timed_fit(
                _classifier(numIterations=50, device=DEV, maxBin=max_bin),
                table, counters, after_warm=calls.clear)
        finally:
            restore()
        prob = model.transform(table)["probability"][:, 1]
        r = {"bins": max_bin + 1, "fit_s": fit_s, "train_auc": auc(y, prob),
             "trees": len(model.getModel().trees), "splits": _splits(model),
             "launches": launches, "host_s": host_s, "host_syncs": syncs,
             "same_model_text": same_model_text(warm, model),
             "histogram_calls": sorted({c[2:] for c in calls}),
             "memory": _memory(f"wide_bins_path {max_bin}")}
        fits[f"serial_{max_bin}"] = r
        if r["launches"]["hist_full"] != r["trees"] or \
                r["launches"]["hist_segment"] != r["splits"] or \
                r["histogram_calls"] != [(max_bin + 1, "int32")]:
            raise AssertionError(f"maxBin {max_bin}: launches or shapes: {r}")
        if not (r["train_auc"] >= 0.955 and r["same_model_text"]
                and np.isfinite(prob).all()):
            raise AssertionError(f"maxBin {max_bin}: AUC or model text: {r}")
        if max_bin == WIDE_MAX_BINS[0]:
            # the serial fit's first iterations, as many as the D = 4 fits
            serial_auc = auc(y, model.getModel().predict_margin(
                X, num_iteration=WIDE_MESH_ITERATIONS).cpu().numpy())
    mesh = build_mesh(data=MESH_SHARDS, devices=[f"{DEV}:0"] * MESH_SHARDS)
    for method in ("auto", "pallas_ring"):
        model, fit_s, launches = _counted_fit(
            _classifier(numIterations=WIDE_MESH_ITERATIONS, device=DEV,
                        maxBin=WIDE_MAX_BINS[0], collective="ring",
                        histogramMethod=method).setMesh(mesh),
            table, counters)
        r = {"fit_s": fit_s, "trees": len(model.getModel().trees),
             "splits": _splits(model), "launches": launches,
             "train_auc": auc(y, model.transform(table)["probability"][:, 1]),
             "serial_auc_at_same_iterations": serial_auc}
        fits[f"ring_{method}"] = r
        want = {"fused_segment_hist_ring": 0,
                "ring_allreduce": r["trees"] + r["splits"],
                "hist_full": MESH_SHARDS * r["trees"],
                "hist_segment": MESH_SHARDS * r["splits"]}
        if {k: launches[k] for k in want} != want or \
                abs(r["train_auc"] - serial_auc) > 0.01:
            raise AssertionError(f"D = {MESH_SHARDS} {method}: above 256 "
                                 f"bins each shard's hist_segment runs and "
                                 f"the ring reduces: want {want}: {r}")
    state["wide_launches"] = {
        mb: {k: fits[f"serial_{mb}"]["launches"][k]
             for k in ("hist_full", "hist_segment")} for mb in WIDE_MAX_BINS}
    return {"rows": N_ROWS, "features": N_FEATURES, "fits": fits,
            "card_vs_cpu": _card_vs_cpu(
                {"features": X[:20_000], "label": y[:20_000]}, y[:20_000],
                maxBin=WIDE_MAX_BINS[0])}


def _wide_row(inputs, accum, row_order=None, cnt=None):
    """A wide mode (int32 codes, B > 256) against its twin, at the full
    matrix (``row_order`` None: ``hist_full``) or at ``cnt`` rows of
    ``row_order`` (``hist_segment``): match, the order it states
    (``histogram_segment_ordered`` on the CPU, bit for bit, f32) and 5
    calls the same bits, its call, alone and enqueue times, the twin's
    and one ``index_add_``'s, and the bound."""
    import torch
    from mmlspark_tpu_torch.ops import cuda_histogram as ch
    bins, B, gh, gh_int = inputs
    n, f = bins.shape
    ghm = gh_int if accum == "int32" else gh
    ghv = ch._gh_values(ghm, accum)
    full = row_order is None
    cnt = n if full else cnt
    off = 0 if full else (n - cnt) // 3
    order = (torch.arange(n, dtype=torch.int32, device=DEV) if full
             else row_order)

    def kernel():
        if full:
            return ch.histogram_cuda(bins, ghm, B, accum)
        return ch.histogram_cuda_fused(bins, ghm, row_order, off, cnt, B,
                                       accum)

    kern = kernel()
    plain = ch.histogram_fused_plain(bins, ghm, order, off, cnt, B, accum)
    torch.cuda.synchronize()
    good, err = compare(kern, plain, ch.histogram_fused_plain(
        bins, ghv.abs().float(), order, off, cnt, B), accum)
    variant = ch.FULL_WIDE if full else ch.SEG_WIDE
    geom = ch.segment_launch_geometry(cnt, f, B, accum, bins.device, variant)
    ordered = repeats = None
    if accum == "float32":
        ordered = torch.equal(kern.cpu(), ch.histogram_segment_ordered(
            bins.cpu(), ghm.cpu(), None if full else row_order.cpu(), off,
            cnt, B, accum, geom))
        repeats = all(torch.equal(kernel(), kern) for _ in range(4))
    seg = order[off:off + cnt].long()
    flat = (bins[seg].long() + torch.arange(f, device=DEV) * B).reshape(-1)
    rep = ghv[seg].repeat_interleave(f, 0)
    lib_out = torch.zeros(f * B, 3, dtype=kern.dtype, device=DEV)
    bms, by = bound_ms(cnt * (4 * f + 12 + (0 if full else 4))
                       + f * B * 12, cnt * f * 3)
    return {"kernel": "hist_full" if full else "hist_segment",
            "accum": accum, "bins": B, "rows": cnt, "features": f,
            "path": "wide_bins_path", "geometry": geom._asdict(),
            "match": good and ordered is not False and repeats is not False,
            "order_exact": ordered, "repeats_identical": repeats,
            "max_abs_err": err, "ms": median_ms(kernel),
            "device_ms": device_ms(kernel, "hist_full_wide_kernel" if full
                                   else "hist_segment_kernel"),
            "enqueue_us": enqueue_us(kernel, 200),
            "plain_ms": median_ms(lambda: ch.histogram_fused_plain(
                bins, ghm, order, off, cnt, B, accum), reps=5),
            "library_ms": median_ms(lambda: lib_out.index_add_(0, flat, rep),
                                    reps=5),
            "bound_ms": bms, "bound_by": by}


def _wide_kernel_rows(row_order):
    """The wide modes at B = ``WIDE_KERNEL_BINS`` in each accumulation
    mode: ``hist_full`` at the flagship's 400,000 × 50 and ``hist_segment``
    at its median segment, on the flagship binned at ``maxBin`` B − 1;
    and at B = 1,024 the 200,000-row segment (several clusters)."""
    rows = []
    for B in WIDE_KERNEL_BINS:
        inputs = kernel_inputs(max_bin=B - 1)
        if inputs[1] != B or inputs[0].dtype != __import__("torch").int32:
            raise AssertionError(f"maxBin {B - 1} binned to {inputs[1]} "
                                 f"bins of {inputs[0].dtype}")
        for accum in ("float32", "bfloat16", "int32"):
            rows.append(_wide_row(inputs, accum))
            rows.append(_wide_row(inputs, accum, row_order, MEDIAN_SEGMENT))
        if B == 1024:
            rows.append(_wide_row(inputs, "float32", row_order,
                                  max(SEGMENT_COUNTS)))
    return rows


def phase_kernels_flagship(state):
    """The two 256-bin flagship rows alone (``hist_full`` f32 at 400,000 ×
    50, ``hist_segment`` f32 at the median segment): the phase to A/B
    between two checkouts in one chip call."""
    import torch
    inputs = kernel_inputs()
    g = torch.Generator(device="cpu").manual_seed(0)
    row_order = torch.randperm(N_ROWS, generator=g).to(torch.int32).to(DEV)
    rows = [_full_row(inputs, "float32"),
            _segment_row(inputs, row_order, MEDIAN_SEGMENT, "float32")]
    if not all(r["match"] for r in rows):
        raise AssertionError(f"a kernel disagrees with its twin: {rows}")
    return {"rows": [{k: r[k] for k in ("kernel", "rows", "features", "ms",
                                        "device_ms", "bound_ms")}
                     for r in rows]}


def host_median_ms(fn, reps=20, warm=3):
    """Median host wall-clock ms of ``reps`` calls of ``fn`` after
    ``warm`` calls (``fn`` returns only when its result is on the host)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _native_calls():
    from mmlspark_tpu_torch import native
    return {k: fn.calls for k, fn in native.COUNTED.items()}


def _zero_native_calls():
    from mmlspark_tpu_torch import native
    for fn in native.COUNTED.values():
        fn.calls = 0


def phase_native_path(state):
    """The reference's native host paths (``mmlspark_tpu_torch/native``)
    beside the card: fastbin's codes against the device transform, the
    fastforest scorer against the CPU walk and the card predictor,
    fasthist CPU fits against the plain twin and the card, and the fit
    budget's refusal."""
    import numpy as np
    import torch
    from mmlspark_tpu_torch.gbdt import Booster, engine, fit_bin_mapper
    res = {"host_cpu": host_cpu(), "host_threads": os.cpu_count()}

    # -- fastbin: host codes against the device transform -----------------
    binning = {}
    for name, (X, _) in (("flagship", bench_data(N_ROWS, N_FEATURES)),
                         ("flight", flight_data(FLIGHT_ROWS))):
        mapper = fit_bin_mapper(X, max_bin=255)
        t0 = time.perf_counter()
        host = mapper.transform_packed(X)
        packed_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = host.to(DEV)
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dev = mapper.transform(X, DEV)
        torch.cuda.synchronize()
        device_s = time.perf_counter() - t0
        binning[name] = {"rows": X.shape[0], "features": X.shape[1],
                         "dtype": str(X.dtype), "transform_packed_s": packed_s,
                         "copy_to_card_s": copy_s,
                         "device_transform_s": device_s,
                         "equal": bool(torch.equal(card, dev))}
        del card, dev
    res["binning"] = binning

    # -- fastforest: main_path's model on the CPU --------------------------
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    model = state.get("main_model")
    if model is None:
        model = _classifier(numIterations=50, device=DEV).fit(table)
    # the flagship fit's budget estimate (main_path's, or this fit's)
    estimate = (state["main_memory"]["estimate_bytes"]
                if "main_memory" in state
                else engine.last_fit_budget["total"])
    card_b = model.getModel()
    cpu_b = Booster.load_native_model_string(
        card_b.save_native_model_string(), device="cpu")
    nat = cpu_b.predictor()
    walk = cpu_b.predictor(backend="jit")
    card = card_b.predictor()
    m_nat = nat(X)
    same = {"cpu_walk": bool(torch.equal(m_nat, walk(X))),
            "card_predictor": bool(torch.equal(m_nat, card(X).cpu()))}
    timing = {}
    for rows in PREDICT_ROWS:
        sub = X[:rows]
        timing[rows] = {
            "native_ms": host_median_ms(lambda: nat(sub)),
            "card_predictor_ms": host_median_ms(lambda: card(sub).cpu())}
    res["forest"] = {"trees": len(cpu_b.trees), "modes": [nat.mode,
                                                          card.mode],
                     "bitwise_equal": same, "median_ms": timing,
                     "threads": os.cpu_count()}

    # -- fasthist: CPU fits, native against the plain twin and the card ----
    Xs, ys = bench_data(20_000, N_FEATURES)
    small = {"features": Xs, "label": ys}
    fits = {}
    models = {}
    for method in ("auto", "segment"):
        _zero_native_calls()
        t0 = time.perf_counter()
        models[method] = _classifier(numIterations=5, device="cpu",
                                     histogramMethod=method).fit(small)
        fits[method] = {"fit_s": time.perf_counter() - t0,
                        "native_calls": _native_calls()}
    models[DEV] = _classifier(numIterations=5, device=DEV).fit(small)
    first = [models[k].getModel().trees[0] for k in ("auto", DEV)]
    first_same = all(np.array_equal(getattr(first[0], k),
                                    getattr(first[1], k))
                     for k in ("split_feature", "threshold", "left_child",
                               "right_child"))
    res["cpu_fits"] = {
        "rows": 20_000, "iterations": 5, "fits": fits,
        "first_tree_equals_card": first_same,
        "auto_equals_segment_model_text":
            models["auto"].getNativeModel()
            == models["segment"].getNativeModel()}

    # -- the fit budget refuses before the first kernel --------------------
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    os.environ["MMLSPARK_TPU_HBM_BYTES"] = str(estimate // 2)
    try:
        _classifier(numIterations=50, device=DEV).fit(table)
        refused = None
    except MemoryError as e:
        refused = str(e)
    finally:
        del os.environ["MMLSPARK_TPU_HBM_BYTES"]
    launched = {k: fn.launches for k, fn in counters.items()}
    res["budget"] = {"capacity_bytes": estimate // 2,
                     "estimate_bytes": estimate,
                     "refused": refused, "launches_before": launched}

    bad = [k for k, r in binning.items() if not r["equal"]]
    if bad:
        raise AssertionError(f"transform_packed differs from the device "
                             f"transform on {bad}: {res}")
    if nat.mode != "native" or not all(same.values()):
        raise AssertionError(f"the native scorer's margins differ: {res}")
    # both fits bin natively, and score their reference profile's margins
    # with the native forest walk (a CPU booster); only the histogram,
    # partition and split kernels tell the routes apart
    if fits["auto"]["native_calls"]["split"] < 1 or any(
            v for k, v in fits["segment"]["native_calls"].items()
            if k not in ("bin_columns", "predict_forest")):
        raise AssertionError(f"the CPU auto fit did not take the native "
                             f"kernels, or the segment fit did: {res}")
    if not first_same:
        raise AssertionError(f"the native CPU fit's first tree differs from "
                             f"the card's: {res}")
    if refused is None or any(launched.values()):
        raise AssertionError(f"the fit budget did not refuse the flagship "
                             f"before its first kernel: {res}")
    return res


#: fault_tolerance_path: the flagship fit's iterations, the checkpoint
#: cadence, the iteration after whose chunk the worker dies (boundary
#: FT_KILL_AT is durable then), the worker's exit code, the D = 4 mesh
#: fit's validation rows (the flagship's last rows) and the chaos seed
FT_ITERATIONS, FT_CHUNK, FT_KILL_AT, FT_KILL_CODE = 10, 5, 5, 37
FT_VAL_ROWS = 40_000
FT_SEED = 14
_FT = {}


def _ft_inputs():
    """The flagship rows binned on the host once (``fit_codes``), on the
    card, with their labels and mapper."""
    if not _FT:
        from mmlspark_tpu_torch.gbdt import fit_bin_mapper
        from mmlspark_tpu_torch.gbdt.base import fit_codes
        X, y = bench_data(N_ROWS, N_FEATURES)
        mapper = fit_bin_mapper(X, max_bin=255)
        _FT.update(y=y, mapper=mapper, bins=fit_codes(mapper, X, DEV))
    return _FT


def _logloss(margins, labels, weights):
    import numpy as np
    p = np.clip(1.0 / (1.0 + np.exp(-margins)), 1e-15, 1 - 1e-15)
    return float(-np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p)))


def _ft_fit(callbacks=None, mesh=None, **kw):
    """fault_tolerance_path's fit through ``engine.train``: the flagship
    at the main path's settings with bagging every 3rd iteration and
    feature fraction, FT_ITERATIONS iterations, boundaries every FT_CHUNK;
    on ``mesh`` the last FT_VAL_ROWS rows are its validation set."""
    from mmlspark_tpu_torch.gbdt import engine, get_objective
    d = _ft_inputs()
    bins, y = d["bins"], d["y"]
    extra = {}
    if mesh is not None:
        cut = N_ROWS - FT_VAL_ROWS
        extra = dict(val_bins=bins[cut:], val_labels=y[cut:],
                     val_metric=_logloss)
        bins, y = bins[:cut], y[:cut]
    params = engine.TrainParams(**{**dict(
        num_iterations=FT_ITERATIONS, learning_rate=0.1, num_leaves=31,
        max_bin=255, min_data_in_leaf=20, verbosity=0,
        bagging_fraction=0.8, bagging_freq=3, feature_fraction=0.8,
        checkpoint_chunk=FT_CHUNK), **kw})
    return engine.train(bins, y, None, d["mapper"],
                        get_objective("binary"), params, device=DEV,
                        mesh=mesh, callbacks=callbacks, **extra)


def fault_tolerance_worker(ckpt_dir):
    """The killed fit of fault_tolerance_path, run as
    ``chip_smoke.py --fault-tolerance-worker DIR``: fault_tolerance_path's
    serial fit checkpointing into DIR, which exits with FT_KILL_CODE
    (``os._exit``: no cleanup) in its callback at iteration FT_KILL_AT,
    after the boundary FT_KILL_AT is durable."""
    def die(it, trees):
        if it >= FT_KILL_AT:
            os._exit(FT_KILL_CODE)

    _ft_fit([die], checkpoint_dir=ckpt_dir)
    print("chip_smoke: the worker's fit was not killed", file=sys.stderr)
    return 1


def _ft_timed(**kw):
    """One fault_tolerance_path fit: ``(model text, seconds)``."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    booster = _ft_fit(**kw)
    torch.cuda.synchronize()
    return booster.save_native_model_string(), time.perf_counter() - t0


def _ft_counters():
    from mmlspark_tpu_torch.gbdt import engine
    return dict(engine.train_stats.snapshot()["counters"])


def _ft_replayed(tmp, name, **kw):
    """The fit with one retry, chunk 2's first attempt failing after
    the fit's device arrays are dropped: ``(text, seconds,
    chunks_replayed)``."""
    from mmlspark_tpu_torch.gbdt import engine
    from mmlspark_tpu_torch.io.chaos import ChaosBoostStep, ChaosPlan
    inner = engine._boost_chunk
    engine._boost_chunk = step = ChaosBoostStep(
        inner, ChaosPlan(FT_SEED), fail_on_calls={2}, drop_device=True)
    before = _ft_counters()
    try:
        text, sec = _ft_timed(checkpoint_dir=os.path.join(tmp, name),
                              fault_tolerant_retries=1, **kw)
    finally:
        engine._boost_chunk = inner
    if step.failures != 1:
        raise AssertionError(f"{name}: the injector failed "
                             f"{step.failures} chunks, not 1")
    return text, sec, _ft_counters()["chunks_replayed"] - \
        before["chunks_replayed"]


def phase_fault_tolerance_path(state):
    """Chunk-boundary checkpoints, kill and resume, and chunk replay on
    the card (``engine.train`` with ``checkpoint_dir`` and
    ``fault_tolerant_retries``): (a) the flagship fit with and without
    checkpoints, the saves' seconds and bytes; (b) the same fit killed in
    a subprocess after boundary FT_KILL_AT and resumed here; (c) replayed
    after an injected failure of chunk 2 that also drops the fit's
    device arrays; (d) a D = 4 one-card mesh fit with validation and
    psum, replayed and resumed alike, and on the ring, replayed.  Every
    recovered fit must write its uninterrupted fit's model text."""
    import shutil
    import tempfile
    from mmlspark_tpu_torch.core.mesh import build_mesh
    from mmlspark_tpu_torch.gbdt import engine
    from mmlspark_tpu_torch.io.chaos import read_ckpt_boundary
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ft_")
    try:
        _ft_fit(num_iterations=WARM_ITERATIONS)          # warms the card
        # plain, checkpointed, checkpointed, plain: in turns
        fits, saved = {"plain": [], "ckpt": []}, []
        for i, kind in enumerate(("plain", "ckpt", "ckpt", "plain")):
            kw = ({} if kind == "plain"
                  else dict(checkpoint_dir=os.path.join(tmp, f"a{i}")))
            fits[kind].append(_ft_timed(**kw))
            if kind == "ckpt":
                saved.append(dict(engine.last_checkpoint))
        plain = fits["plain"][0][0]
        res = {"rows": N_ROWS, "features": N_FEATURES,
               "iterations": FT_ITERATIONS, "checkpoint_chunk": FT_CHUNK,
               "reference_fit": {
                   "plain_fit_s": [s for _, s in fits["plain"]],
                   "checkpointed_fit_s": [s for _, s in fits["ckpt"]],
                   "saves": [c["saves"] for c in saved],
                   "save_s": [c["save_seconds"] for c in saved],
                   "bytes_on_disk_per_boundary": saved[0]["bytes"],
                   "same_model_text": all(
                       t == plain for t, _ in fits["plain"] + fits["ckpt"])}}

        # (b) killed in a subprocess, resumed here
        ck = os.path.join(tmp, "b")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--fault-tolerance-worker", ck],
                           capture_output=True, text=True, timeout=600)
        worker_s = time.perf_counter() - t0
        boundary = read_ckpt_boundary(ck)
        before = _ft_counters()
        resumed, resume_s = _ft_timed(checkpoint_dir=ck)
        res["kill_and_resume"] = {
            "worker_rc": r.returncode, "worker_s": worker_s,
            "worker_stderr_tail": r.stderr[-500:],
            "boundary": boundary,
            "resumed_from": engine.last_checkpoint["resumed_from"],
            "ckpt_resumed": _ft_counters()["ckpt_resumed"]
            - before["ckpt_resumed"],
            "resume_fit_s": resume_s, "same_model_text": resumed == plain,
            "directory_cleared": os.listdir(ck) == []}

        # (c) replay on one card
        replayed, replay_s, n_replayed = _ft_replayed(tmp, "c")
        res["replay"] = {"fit_s": replay_s, "chunks_replayed": n_replayed,
                         "same_model_text": replayed == plain}

        # (d) the D = 4 one-card mesh with validation and psum
        mesh = build_mesh(MESH_SHARDS, devices=[DEV] * MESH_SHARDS)
        mkw = dict(mesh=mesh, collective="psum", early_stopping_round=10)
        mplain, mplain_s = _ft_timed(**mkw)
        mreplayed, mreplay_s, mn = _ft_replayed(tmp, "d", **mkw)

        class Interrupt(Exception):
            pass

        def interrupt(it, trees):
            if it >= FT_KILL_AT:
                raise Interrupt

        mck = os.path.join(tmp, "e")
        try:
            _ft_fit([interrupt], checkpoint_dir=mck, **mkw)
        except Interrupt:
            pass
        mboundary = read_ckpt_boundary(mck)
        before = _ft_counters()
        mresumed, mresume_s = _ft_timed(checkpoint_dir=mck, **mkw)
        res["mesh"] = {
            "shards": MESH_SHARDS, "collective": "psum",
            "validation_rows": FT_VAL_ROWS, "plain_fit_s": mplain_s,
            "replay_fit_s": mreplay_s, "chunks_replayed": mn,
            "replay_same_model_text": mreplayed == mplain,
            "boundary": mboundary,
            "ckpt_resumed": _ft_counters()["ckpt_resumed"]
            - before["ckpt_resumed"],
            "resume_fit_s": mresume_s,
            "resume_same_model_text": mresumed == mplain,
            "stop_iteration": engine.last_validation.get("stop_iteration")}
        # the same mesh fit on the ring kernel (deterministic), replayed
        rkw = dict(mkw, collective="ring")
        rplain, rplain_s = _ft_timed(**rkw)
        rreplayed, rreplay_s, rn = _ft_replayed(tmp, "f", **rkw)
        res["mesh_ring"] = {"plain_fit_s": rplain_s,
                            "replay_fit_s": rreplay_s, "chunks_replayed": rn,
                            "replay_same_model_text": rreplayed == rplain}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    state["ft_launches"] = launches
    res["launches"] = launches
    res["counters"] = _ft_counters()
    kr, mres = res["kill_and_resume"], res["mesh"]
    bad = []
    if not res["reference_fit"]["same_model_text"] or any(
            c["saves"] != (FT_ITERATIONS - 1) // FT_CHUNK for c in saved):
        bad.append("the checkpointed fit")
    if kr["worker_rc"] != FT_KILL_CODE or kr["boundary"] != FT_KILL_AT \
            or kr["resumed_from"] != FT_KILL_AT or kr["ckpt_resumed"] != 1 \
            or not kr["same_model_text"] or not kr["directory_cleared"]:
        bad.append("kill and resume")
    if res["replay"]["chunks_replayed"] != 1 or \
            not res["replay"]["same_model_text"]:
        bad.append("the serial replay")
    if mres["chunks_replayed"] != 1 or not mres["replay_same_model_text"] \
            or mres["boundary"] != FT_KILL_AT or mres["ckpt_resumed"] != 1 \
            or not mres["resume_same_model_text"]:
        bad.append("the mesh replay or resume")
    if res["mesh_ring"]["chunks_replayed"] != 1 or \
            not res["mesh_ring"]["replay_same_model_text"]:
        bad.append("the mesh ring replay")
    if not all(launches[k] for k in ("hist_full", "hist_segment",
                                     "ring_allreduce")):
        bad.append("the kernels' launches")
    if bad:
        raise AssertionError(f"fault_tolerance_path: {', '.join(bad)} "
                             f"failed: {res}")
    return res


#: multicontroller_path: the row at which the flagship is cut into its
#: two shards, the controllers, the drill's heartbeat stall and the
#: gang's iterations (boundaries every FT_CHUNK)
GANG_CUT, GANG_PROCESSES = 190_000, 2
GANG_STALL = "2.0:1.5"
GANG_ITERATIONS = 10


def gang_table(seed, rows, features, num_class=2):
    """The gang's table for ``elastic --table chip_smoke:gang_table``: the
    flagship (``bench_data``, numpy default_rng(0)), which every
    controller regenerates."""
    if seed != 0 or num_class != 2:
        raise ValueError("the flagship table is binary, from seed 0")
    return bench_data(rows, features)


def _gang_args():
    """The controllers' fit: fault_tolerance_path's settings on the
    flagship, cut at GANG_CUT, for GANG_ITERATIONS iterations."""
    return ["--table", "chip_smoke:gang_table", "--rows", str(N_ROWS),
            "--features", str(N_FEATURES), "--max-bin", "255",
            "--cuts", str(GANG_CUT), "--iterations", str(GANG_ITERATIONS),
            "--num-leaves", "31", "--learning-rate", "0.1",
            "--bagging-fraction", "0.8", "--bagging-freq", "3",
            "--feature-fraction", "0.8", "--straggler-age", "0.6",
            "--lease-timeout", "5"]


def phase_multicontroller_path(state):
    """Sharded ingestion and the gang of controllers on the card (the
    module's docstring, 22b): the in-process one-controller fit, a gang
    run without checkpoints, and the chaos drill's kill, corrupt and stall
    phases, every model text held to the first."""
    import shutil
    import tempfile
    import torch
    from mmlspark_tpu_torch.gbdt import elastic
    from mmlspark_tpu_torch.tools import chaos_training as ct
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    worker = _gang_args() + ["--device", DEV]
    counters = _counters()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gang_")
    try:
        args = elastic.parse_args(worker + [
            "--num-processes", str(GANG_PROCESSES), "--heartbeat-dir", tmp])
        for fn in counters.values():
            fn.launches = 0
        booster, one_s, one_prep_s = elastic.sharded_fit(
            args, None, torch.device("cuda", 0) if DEV == "cuda"
            else torch.device(DEV))
        one_text = booster.save_native_model_string()
        one_launches = {k: fn.launches for k, fn in counters.items()}
        kw = dict(checkpoint_chunk=FT_CHUNK, phase_timeout=300.0, env=env)
        # one uninterrupted gang run without checkpoints, under the
        # heartbeat stall, its leases beaconed to a hub in this process
        # (the transport mode): the drill's baseline and its stall phase
        plain = ct.run_phase("plain", tmp, worker, checkpoint=False,
                             stall=GANG_STALL, transport=True, **kw)
        drill = ct.drill(tmp, worker, base=plain, stallp=plain, **kw)
        texts = {name: open(os.path.join(tmp, f"model_{name}.txt")).read()
                 for name in ("kill", "corrupt")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    stats = plain["stats"]["0"]
    per = [stats.get(str(p), {}) for p in range(GANG_PROCESSES)]
    launches = [s.get("launches", {}) for s in per]
    res = {"rows": N_ROWS, "features": N_FEATURES, "shards":
           [GANG_CUT, N_ROWS - GANG_CUT], "processes": GANG_PROCESSES,
           "iterations": GANG_ITERATIONS, "checkpoint_chunk": FT_CHUNK,
           "one_controller_fit_s": one_s,
           "one_controller_prep_s": one_prep_s,
           "one_controller_launches": one_launches,
           "gang_fit_s": [s.get("fit_s") for s in per],
           "gang_worker_s": [{k: s.get(k) for k in ("setup_s",
                                                    "rendezvous_s",
                                                    "prep_s", "fit_s")}
                             for s in per],
           "gang_round_s": plain["seconds"],
           "backend": [s.get("backend") for s in per],
           "gathers": [s.get("gathers") for s in per],
           "launches_per_controller": launches,
           "gang_same_model_text": plain["model"] == one_text,
           "drill": {name: {k: v for k, v in r.items() if k != "stats"}
                     for name, r in drill.items() if name != "verdicts"},
           "drill_stats": {name: r["stats"] for name, r in drill.items()
                           if name != "verdicts"},
           "verdicts": drill["verdicts"],
           "drill_same_model_text": {name: t == one_text
                                     for name, t in texts.items()}}
    # both kernels at the shapes a controller gives them: controller 1's
    # shard (the flagship's rows from GANG_CUT on, binned by the shared
    # mapper) and half of it as the segment, against their twins
    inputs = kernel_inputs()
    shard = tuple(x[GANG_CUT:].contiguous() if torch.is_tensor(x) else x
                  for x in inputs)
    n1 = N_ROWS - GANG_CUT
    order = torch.randperm(n1, generator=torch.Generator().manual_seed(
        0)).to(torch.int32).to(DEV)
    krows = [{**_full_row(shard, "float32"), "path": "multicontroller_path"},
             {**_segment_row(shard, order, n1 // 2, "float32"),
              "path": "multicontroller_path"}]
    state["kernel_rows"] = state.get("kernel_rows", []) + krows
    res["kernel_rows"] = krows
    state["gang_launches"] = {k: sum(n.get(k, 0) for n in launches)
                              for k in ("hist_full", "hist_segment")}
    state["gang_controllers"] = {k: [n.get(k, 0) for n in launches]
                                 for k in ("hist_full", "hist_segment")}
    bad = []
    if not res["gang_same_model_text"]:
        bad.append("the gang's text differs from the one-controller fit's")
    if not all(res["drill_same_model_text"].values()):
        bad.append("a drill phase's text differs")
    if not all(drill["verdicts"].values()):
        bad.append("a drill verdict failed")
    if not all(r["match"] for r in krows):
        bad.append("a kernel disagrees with its twin at a controller's "
                   "shapes")
    if any(b != "gloo" for b in res["backend"]):
        bad.append("the backend is not gloo on one card")
    if not all(n.get(k) for n in launches
               for k in ("hist_full", "hist_segment")):
        bad.append("a controller launched no histogram kernel")
    if bad:
        raise AssertionError(f"multicontroller_path: {'; '.join(bad)}: "
                             f"{res}")
    return res


class sync_count:
    """Every synchronizing call inside the block: ``torch.cuda.synchronize``
    and ``Tensor.cpu`` of a card tensor (the grower's fetches, the
    profiler's dispatch bracket, the train-loss copy and the reference
    profile's copies all go through one of them)."""

    def __enter__(self):
        import torch
        self.n = 0
        self.saved = (torch.cuda.synchronize, torch.Tensor.cpu)
        sync, cpu = self.saved

        def counted_sync(*a, **k):
            self.n += 1
            return sync(*a, **k)

        def counted_cpu(t, *a, **k):
            self.n += t.is_cuda
            return cpu(t, *a, **k)

        torch.cuda.synchronize, torch.Tensor.cpu = counted_sync, counted_cpu
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize, torch.Tensor.cpu = self.saved


def _observed_fit(est, table, counters):
    """One fit of ``est`` with the kernels' launch counts, the grower's
    host syncs and the profiler's chunk phases read from 0 just before
    it: ``(model, fit_s, launches, grower host syncs, synchronizing
    calls, span events, dispatch_host and device_wait counts)``."""
    import torch
    from mmlspark_tpu_torch.core import telemetry as tm
    from mmlspark_tpu_torch.core.profiler import get_profiler
    from mmlspark_tpu_torch.gbdt.grower import grow_tree

    def phase_counts():
        st = get_profiler().stats.snapshot()["stages"]
        return [st.get(f"train.boost_chunk.{k}", {}).get("count", 0)
                for k in ("dispatch_host", "device_wait")]

    before = phase_counts()
    seq0 = tm.get_journal().events()[-1]["seq"] \
        if tm.get_journal().events() else 0
    for fn in counters.values():
        fn.launches = 0
    grow_tree.host_syncs = 0
    torch.cuda.synchronize()
    with sync_count() as syncs:
        t0 = time.perf_counter()
        model = est.fit(table)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    events = [e for e in tm.get_journal().events() if e["seq"] > seq0]
    return (model, fit_s, {k: fn.launches for k, fn in counters.items()},
            grow_tree.host_syncs, syncs.n - 1, events,
            [a - b for a, b in zip(phase_counts(), before)])


#: observability_path: the iterations of each of its six flagship fits
OBS_ITERATIONS = 25


def phase_observability_path(state):
    """Phase 24 (module docstring): the observability core on the
    flagship fit."""
    import tempfile

    import numpy as np
    import torch
    from mmlspark_tpu_torch.core import debug
    from mmlspark_tpu_torch.core import telemetry as tm
    from mmlspark_tpu_torch.core.profiler import get_profiler
    from mmlspark_tpu_torch.core.sketch import build_reference_profile
    from mmlspark_tpu_torch.gbdt import engine, get_objective
    from mmlspark_tpu_torch.io.chaos import ChaosBoostStep, ChaosPlan
    from mmlspark_tpu_torch.tools import perf_report, trace_report
    X, y = bench_data(N_ROWS, N_FEATURES)
    table = {"features": X, "label": y}
    est = _classifier(numIterations=OBS_ITERATIONS, device=DEV,
                      parallelism="serial")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    jpath = os.path.join(tmp, "journal.jsonl")
    frdir = os.path.join(tmp, "flightrec")
    tm.configure_flight_recorder(directory=frdir, min_interval_s=0.0)
    prof = get_profiler()
    counters = _counters()
    # the warm-up (standalone the phase builds and loads the kernels)
    est.copy({"numIterations": WARM_ITERATIONS}).fit(table)
    captured = {}
    capture = engine._capture_reference_profile

    def spy(booster, bins, mapper, feature_names):
        # a reference only: the copy is made after the timed fits
        captured.update(bins=bins, mapper=mapper,
                        feature_names=feature_names)
        return capture(booster, bins, mapper, feature_names)

    def plain_fit():
        prof.configure(enabled=False)
        os.environ[engine.REF_PROFILE_ENV] = "0"
        try:
            return _observed_fit(est, table, counters)
        finally:
            prof.configure(enabled=True)
            os.environ.pop(engine.REF_PROFILE_ENV, None)

    # on, off, off, on: the first fit of each side is checked, all are
    # timed
    tm.get_journal().configure(jpath)
    engine._capture_reference_profile = spy
    try:
        on = _observed_fit(est, table, counters)
    finally:
        engine._capture_reference_profile = capture
        tm.get_journal().configure(None)
    capture_s = dict(engine.last_ref_profile)
    off = plain_fit()
    off2 = plain_fit()
    on2 = _observed_fit(est, table, counters)
    model = on[0]
    booster = model.getModel()
    trees = booster.trees
    splits = sum(t.num_leaves - 1 for t in trees)
    launches = {k: on[2][k] for k in ("hist_full", "hist_segment")}
    state["obs_launches"] = launches
    bad = []
    same = len({f[0].getNativeModel()
                for f in (on, off, off2, on2)}) == 1
    if not same:
        bad.append("the instrumented and plain fits wrote different text")
    if launches["hist_full"] != len(trees) or \
            launches["hist_segment"] != splits:
        bad.append(f"launches {launches} against {len(trees)} trees and "
                   f"{splits} splits")
    # the journal: one span, its chunks tiling the iterations
    events = on[5]
    spans = {e.get("fit") for e in events}
    kinds = [e["ev"] for e in events]
    chunks = [(e["it_start"], e["it_end"]) for e in events
              if e["ev"] == "boost_chunk"]
    tiled = bool(chunks) and chunks[0][0] == 0 \
        and chunks[-1][1] == OBS_ITERATIONS \
        and all(b == a2 for (_, b), (a2, _) in zip(chunks, chunks[1:]))
    if len(spans) != 1 or kinds[0] != "fit_begin" \
            or kinds[-1] != "fit_end" or not tiled \
            or events[-1].get("trees") != len(trees) \
            or kinds.count("fit_begin") != 1:
        bad.append(f"the journal is not one span of tiling chunks: {kinds} "
                   f"{chunks}")
    span = events[0].get("fit")
    mirrored = tm.read_journal(jpath)
    timeline = trace_report.timeline_report(
        trace_report.load_events([jpath]), fit=span)["fit"]
    if [e["ev"] for e in mirrored if e.get("fit") == span] != kinds \
            or not timeline["complete"]:
        bad.append("the mirrored journal does not read back as the fit's "
                   "timeline")
    # the profiler: one bracket per chunk; the card's watermarks
    if on[6] != [len(chunks)] * 2 or off[6] != [0, 0]:
        bad.append(f"dispatch phases {on[6]} / {off[6]} against "
                   f"{len(chunks)} chunks")
    prof.sample_memory(min_interval_s=0.0)
    mem = {k.split("/")[1]: v for k, v in
           prof.snapshot()["memory_bytes"].items() if k.startswith("cuda:0/")}
    codes_bytes = N_ROWS * N_FEATURES
    if not (mem.get("bytes_in_use", -1) <= mem.get("peak_bytes_in_use", -2)
            <= mem.get("bytes_limit", -3)
            and mem["peak_bytes_in_use"] >= codes_bytes):
        bad.append(f"cuda:0 watermarks {mem}")
    render = tm.get_registry().render_prometheus()
    totals = perf_report.parse_stage_totals(render)
    report = perf_report.build_report(
        {"telemetry": {"profile": prof.snapshot(),
                       "metrics_exposition": render}}, [jpath])
    if totals.get("train.boost_chunk.device_wait", {}).get("count", 0) \
            < len(chunks) or not report["compile_ledger"]["sites"]:
        bad.append("perf_report did not parse the profile families")
    # the reference profile against the CPU's from the same codes
    t0 = time.perf_counter()
    codes, mapper = captured["bins"].cpu().numpy(), captured["mapper"]
    sample = codes
    if len(codes) > engine._REF_PROFILE_MARGIN_ROWS:
        idx = np.random.default_rng(0).choice(
            len(codes), size=engine._REF_PROFILE_MARGIN_ROWS, replace=False)
        idx.sort()
        sample = codes[idx]
    Xr = np.empty(sample.shape, np.float32)
    for j, rep in enumerate(engine._bin_representatives(mapper)):
        Xr[:, j] = rep[sample[:, j].astype(np.int64)]
    meta = json.loads(booster.reference_profile.to_json())["meta"]
    cpu_profile = build_reference_profile(
        codes, mapper, booster.predict_margin(Xr, device="cpu").numpy(),
        feature_names=captured["feature_names"],
        meta={k: meta[k] for k in ("trees", "num_class", "fit_span",
                                   "created")})
    cpu_profile_s = time.perf_counter() - t0
    if booster.reference_profile.to_json() != cpu_profile.to_json():
        bad.append("the card fit's reference profile differs from the "
                   "CPU's")
    # the feature sketches are exact counts: each sums to the rows, and
    # its buckets to the codes' bincount rolled up by its ladder
    for j, sk in enumerate(json.loads(cpu_profile.to_json())[
            "feature_sketches"]):
        if sk["n"] + sk["nan"] != N_ROWS or \
                sum(sk["buckets"].values()) != sk["n"] or \
                sk["nan"] != int((codes[:, j] == mapper.missing_bin).sum()):
            bad.append(f"feature {j}'s sketch does not count every row")
            break
    # a failing fit: fit_failed under its span and a flight record
    step = ChaosBoostStep(engine._boost_chunk, ChaosPlan(seed=0),
                          fail_on_calls=[1])
    saved = engine._boost_chunk
    engine._boost_chunk = step
    seq0 = tm.get_journal().events()[-1]["seq"]
    try:
        est.fit(table)
        bad.append("the injected fit did not raise")
    except RuntimeError:
        pass
    finally:
        engine._boost_chunk = saved
    failed = [e for e in tm.get_journal().events() if e["seq"] > seq0]
    records = sorted(os.listdir(frdir)) if os.path.isdir(frdir) else []
    record = {}
    if records:
        with open(os.path.join(frdir, records[-1])) as fh:
            record = json.load(fh)
    fspan = failed[0].get("fit") if failed else None
    if [e["ev"] for e in failed] != ["fit_begin", "fit_failed"] \
            or failed[-1].get("fit") != fspan \
            or record.get("context", {}).get("fit") != fspan \
            or not record.get("journal_tail") \
            or "cuda:0/peak_bytes_in_use" not in (
                record.get("profile") or {}).get("memory_bytes", {}):
        bad.append(f"the failing fit left {[e['ev'] for e in failed]} and "
                   f"flight records {records}")
    # debug mode: a NaN gradient stops the fit before its first tree
    nan_calls = []

    def nan_grad(scores):
        nan_calls.append(1)
        g = torch.zeros_like(scores)
        g[123] = float("nan")
        return g, torch.ones_like(scores)

    codes_dev = torch.as_tensor(codes, device=DEV)
    debug.debug_mode(True)
    debug_error = None
    try:
        engine.train(codes_dev, y, None, mapper, get_objective("binary"),
                     engine.TrainParams(num_iterations=5, verbosity=-1),
                     grad_fn_override=nan_grad)
    except debug.DebugCheckError as e:
        debug_error = str(e)
    finally:
        debug.debug_mode(False)
    if debug_error is None or nan_calls != [1]:
        bad.append(f"debug mode did not stop the NaN fit ({debug_error}, "
                   f"{len(nan_calls)} gradient calls)")
    pairs = ((on, off), (on2, off2))
    shares = [(a[1] - b[1]) / b[1] for a, b in pairs]
    res = {"rows": N_ROWS, "features": N_FEATURES,
           "iterations": OBS_ITERATIONS,
           "fit_s_on": [a[1] for a, _ in pairs],
           "fit_s_off": [b[1] for _, b in pairs],
           "overhead_shares": shares,
           "overhead_share": statistics.median(shares),
           "host_syncs_on": on[3], "host_syncs_off": off[3],
           "sync_calls_on": [a[4] for a, _ in pairs],
           "sync_calls_off": [b[4] for _, b in pairs],
           "ref_profile_ms": {k: v * 1e3 for k, v in capture_s.items()
                              if k != "rows"},
           "ref_profile_rows": capture_s.get("rows"),
           "cpu_profile_check_s": cpu_profile_s,
           "boost_chunks": len(chunks), "journal_events": kinds,
           "same_model_text": same, "launches": launches,
           "trees": len(trees), "splits": splits, "memory_bytes": mem,
           "build_events": prof.snapshot()["build_events"],
           "flight_record": records[-1] if records else None,
           "debug_error": debug_error}
    if bad:
        raise AssertionError(f"observability_path: {'; '.join(bad)}: {res}")
    return res


#: serving_path: the one-row JSON requests and the client threads posting
#: them, the engine's batching, the requests of the binary-wire and
#: multiprocess checks and of the CPU engine, the fleet's timed sizes and
#: the seed drawing the rows
SERVE_REQUESTS, SERVE_CLIENTS = 4000, 8
SERVE_MAX_ROWS, SERVE_BUDGET_MS = 256, 2.0
SERVE_SIDE_REQUESTS = 1000
FLEET_ROWS = (1, 64, 4096)
SERVE_SEED = 17


def _client_run(addrs, bodies, clients):
    """The clients of serving_path, run in a process of their own:
    ``clients`` threads, each on one keep-alive HTTP connection to its
    address (``addrs`` round-robin), post ``bodies`` (request j by thread
    j % clients).  Returns ``(replies, each request's seconds, wall
    seconds, errors)``."""
    import http.client
    import json
    import threading
    from urllib.parse import urlsplit
    out = [0.0] * len(bodies)
    lat = [0.0] * len(bodies)
    errors = []

    def client(k):
        u = urlsplit(addrs[k % len(addrs)])
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
        for j in range(k, len(bodies), clients):
            t0 = time.perf_counter()
            try:
                conn.request("POST", u.path or "/", body=bodies[j],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    raise RuntimeError(f"HTTP {resp.status}: {data[:200]}")
                out[j] = json.loads(data)
            except Exception as e:  # noqa: BLE001 - reported by the caller
                errors.append(f"request {j}: {e!r}")
                conn.close()
                conn = http.client.HTTPConnection(u.hostname, u.port,
                                                  timeout=60)
            lat[j] = time.perf_counter() - t0
        conn.close()

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, lat, time.perf_counter() - t0, errors


def _serve_posts(pool, addrs, X, idx, clients=SERVE_CLIENTS):
    """POST rows ``idx`` of ``X`` as one-row JSON requests from
    ``clients`` threads of the client process ``pool`` (thread k keeps
    one connection to ``addrs[k % len(addrs)]``): ``(replies as float32
    in idx order, each request's seconds, wall seconds)``."""
    import json
    import numpy as np
    bodies = [json.dumps({"features": X[i].tolist()}).encode() for i in idx]
    out, lat, wall, errors = pool.submit(_client_run, list(addrs), bodies,
                                         clients).result()
    if errors:
        raise AssertionError(f"{len(errors)} requests failed: {errors[:3]}")
    return np.asarray(out, np.float32), np.asarray(lat), wall


def _engine_run(pool, predictor, X, idx, server=None):
    """``predictor`` behind an ``HTTPServer`` (or ``server``) and a
    ``ScoringEngine`` at the phase's batching, ``_serve_posts`` of rows
    ``idx`` from the client process ``pool``: ``(replies, summary)``; the
    engine is stopped, the server left running."""
    import numpy as np
    from mmlspark_tpu_torch.io import HTTPServer, ScoringEngine
    srv = server or HTTPServer().start()
    eng = ScoringEngine(srv, predictor=predictor, max_rows=SERVE_MAX_ROWS,
                        latency_budget_ms=SERVE_BUDGET_MS,
                        num_scorers=2).start()
    try:
        got, lat, wall = _serve_posts(pool, [srv.address], X, idx)
    finally:
        eng.stop()
    snap = eng.stats_snapshot()
    st = snap["stages"]
    batches = st["e2e"]["count"]
    return got, {
        "requests": len(idx), "wall_s": wall, "rows_per_s": len(idx) / wall,
        "client_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "client_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "stage_p50_ms": {k: st[k]["p50_ms"] for k in (
            "batch_form", "queue_wait", "decode", "score", "reply", "e2e",
            "dispatch_host", "device_wait") if k in st},
        "dispatch_calls": st.get("dispatch_host", {}).get("count", 0),
        "batches": batches, "mean_batch_rows": snap["rows"] / max(1,
                                                                 batches),
        "counters": snap["counters"]}


def _wire_scores(X, rows, predictor):
    """The raw-float32 wire through the exchange, as the reference's
    ``tools/bench_serving.py`` drives it: a transport client holds the
    worker slot of a ``MultiprocessHTTPServer`` (``spawn_workers``
    False), parks each row as a ``wire.pack_matrix`` block, reads the
    raw-float32 reply blocks and acks them from a thread of its own (an
    ack sent from the read pump's callback could wait for send credits
    that only that pump can read).  Returns the margins in row order and
    the seconds."""
    import queue
    import threading
    import numpy as np
    from mmlspark_tpu_torch.io import (MultiprocessHTTPServer,
                                       ScoringEngine, TransportClient,
                                       TransportConfig)
    from mmlspark_tpu_torch.io import wire
    from mmlspark_tpu_torch.io.transport import CH_CONTROL, CH_SCORING
    srv = MultiprocessHTTPServer(num_workers=1, spawn_workers=False,
                                 join_timeout=30.0)
    got, cv, holder = {}, threading.Condition(), {}
    acks: "queue.Queue" = queue.Queue()

    def on_msg(session, channel, msg, dl):
        if not isinstance(msg, (bytes, memoryview)):
            return
        entries = wire.unpack_replies(msg)
        with cv:
            for rid, v in entries:
                got[rid] = np.float32(np.asarray(v).reshape(()))
            cv.notify_all()
        acks.put([rid for rid, _ in entries])

    def ack_loop():
        for rids in iter(acks.get, None):
            holder["c"].send(CH_SCORING, {"op": "ack_many", "rids": rids,
                                          "delivered": [True] * len(rids)},
                             timeout=30.0)

    def dial():
        h, p = srv._ts.address
        c = TransportClient((h, p), token=srv.token,
                            cfg=TransportConfig(initial_credits=2048,
                                                credit_batch=64),
                            on_message=on_msg, name="wire-client")
        for _ in range(400):
            try:
                c.connect(retries=0)
                break
            except OSError:
                time.sleep(0.05)
        c.send(CH_CONTROL, {"op": "hello", "worker": 0,
                            "host": "127.0.0.1", "port": 1})
        holder["c"] = c

    t = threading.Thread(target=dial, daemon=True)
    t.start()
    srv.start()
    t.join(30)
    acker = threading.Thread(target=ack_loop, daemon=True)
    acker.start()
    eng = ScoringEngine(srv, predictor=predictor, max_rows=SERVE_MAX_ROWS,
                        latency_budget_ms=SERVE_BUDGET_MS,
                        num_scorers=2).start()
    try:
        if not holder["c"].session.peer_binary:
            raise AssertionError("the exchange did not negotiate the "
                                 "binary wire")
        t0 = time.perf_counter()
        for k, i in enumerate(rows):
            holder["c"].send_bytes(CH_SCORING,
                                   wire.pack_matrix(f"w{k}", X[i:i + 1]),
                                   timeout=30.0)
        with cv:
            cv.wait_for(lambda: len(got) == len(rows), 60)
        secs = time.perf_counter() - t0
    finally:
        eng.stop()
        acks.put(None)
        acker.join(30)
        holder["c"].close()
        srv.stop()
    if len(got) != len(rows):
        raise AssertionError(f"binary wire: {len(got)} of {len(rows)} "
                             "replies")
    return np.asarray([got[f"w{k}"] for k in range(len(rows))]), secs


def phase_serving_path(state):
    """Phase 25 (module docstring): the serving plane on the flagship
    model.  The clients run in a process of their own.  The spawned
    workers of the multiprocess server and of the two fleets start after
    the binary wire's run and while the card's engine, ``serve_forever``
    and the CPU engine run."""
    import json
    import multiprocessing
    import threading
    import urllib.request
    from concurrent.futures import ProcessPoolExecutor
    import numpy as np
    import torch
    from mmlspark_tpu_torch.gbdt import (Booster,
                                         LightGBMClassificationModel)
    from mmlspark_tpu_torch.io import (HTTPServer, MultiprocessHTTPServer,
                                       PredictorFleet, ScoringEngine,
                                       ShardedPredictor, serve_forever)
    X, y = bench_data(N_ROWS, N_FEATURES)
    model = state.get("main_model")
    if model is None:
        model = _classifier(numIterations=50, device=DEV,
                            parallelism="serial").fit(
            {"features": X, "label": y})
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
        "spawn"))
    t0 = time.perf_counter()
    text = model.getModel().save_native_model_string()
    card = Booster.load_native_model_string(text, device=DEV)
    reload_s = time.perf_counter() - t0
    pred = card.predictor(backend="jit")
    rng = np.random.default_rng(SERVE_SEED)
    idx = rng.integers(0, N_ROWS, SERVE_REQUESTS)
    side = idx[:SERVE_SIDE_REQUESTS]
    # every reply against predict_margin of its row on the card
    want = card.predict_margin(torch.as_tensor(X[idx], device=DEV))
    want = want.cpu().numpy()
    bad = []
    res = {"rows": N_ROWS, "features": N_FEATURES,
           "trees": len(card.trees), "reload_s": reload_s,
           "predictor_mode": pred.mode, "nvidia_smi": card_line()}
    workers, started = {}, {}
    starters = []
    try:
        # the raw-float32 wire through the exchange
        got, secs = _wire_scores(X, side, pred)
        res["binary_wire"] = {"requests": len(side), "seconds": secs,
                              "replies_equal": bool(np.array_equal(
                                  got, want[:len(side)]))}
        if not res["binary_wire"]["replies_equal"]:
            bad.append("binary-wire replies differ")

        # the spawned workers start from here on
        def start(name, make):
            t1 = time.perf_counter()
            try:
                workers[name] = make()
            except Exception as e:  # noqa: BLE001 - reported below
                workers[name] = e
            started[name] = time.perf_counter() - t1

        for name, make in (
                ("fleet_shard", lambda: PredictorFleet(
                    card, num_shards=2, routing="shard", spawn=True,
                    join_timeout=120.0).start()),
                ("fleet_replica", lambda: PredictorFleet(
                    card, num_shards=2, routing="replica", spawn=True,
                    join_timeout=120.0).start()),
                ("multiprocess",
                 lambda: MultiprocessHTTPServer(num_workers=2).start())):
            starters.append(threading.Thread(target=start,
                                             args=(name, make)))
            starters[-1].start()
        # HTTPServer + ScoringEngine on the card predictor
        srv = HTTPServer().start()
        try:
            got, res["http_card"] = _engine_run(pool, pred, X, idx,
                                                server=srv)
            res["http_card"]["replies_equal"] = bool(
                np.array_equal(got, want))
            if not res["http_card"]["replies_equal"]:
                bad.append(f"{int((got != want).sum())} card replies "
                           "differ from predict_margin")
            if res["http_card"]["dispatch_calls"] < 1:
                bad.append("the engine recorded no dispatch bracket")
            # ... then serve_forever on the same server, as the sample
            reloaded = LightGBMClassificationModel.loadNativeModelFromString(
                text, device=DEV)

            def transform(t):
                feats = np.asarray(t["features"], np.float32)
                out = reloaded.transform({"features": feats})
                return t.withColumn("reply", np.asarray([
                    {"probability": float(p[1])}
                    for p in np.asarray(out["probability"])], dtype=object))

            stop = threading.Event()
            loop = threading.Thread(target=serve_forever,
                                    args=(srv, transform, "reply"),
                                    kwargs={"max_rows": 32,
                                            "stop_event": stop},
                                    daemon=True)
            loop.start()
            row = int(idx[0])
            req = urllib.request.Request(
                srv.address, data=json.dumps(
                    {"features": X[row].tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                answer = json.loads(resp.read())
            stop.set()
            loop.join(30)
            expect = float(np.asarray(reloaded.transform(
                {"features": X[row:row + 1]})["probability"])[0, 1])
            res["serve_forever"] = {"probability": answer["probability"],
                                    "batch_transform": expect,
                                    "equal": answer["probability"]
                                    == expect}
            if not res["serve_forever"]["equal"]:
                bad.append("serve_forever's reply differs from the batch "
                           "transform")
        finally:
            srv.stop()
        # the same engine on a CPU booster's native scorer
        cpu_pred = Booster.load_native_model_string(
            text, device="cpu").predictor()
        got, res["http_cpu_native"] = _engine_run(pool, cpu_pred, X, side)
        res["http_cpu_native"]["predictor_mode"] = cpu_pred.mode
        res["http_cpu_native"]["replies_equal_card"] = bool(
            np.array_equal(got, want[:len(side)]))
        if not res["http_cpu_native"]["replies_equal_card"]:
            bad.append("the CPU native scorer's replies differ from the "
                       "card's")
        t_join = time.perf_counter()
        for t in starters:
            t.join()
        failed = {k: f"{type(v).__name__}: {v}" for k, v in workers.items()
                  if isinstance(v, Exception)}
        if failed:
            raise AssertionError(f"spawned workers failed to start: "
                                 f"{failed}")
        res["spawn_start_s"] = started
        res["spawn_wait_s"] = time.perf_counter() - t_join
        # two spawned worker processes in front of the card's engine
        mp = workers["multiprocess"]
        eng = ScoringEngine(mp, predictor=pred, max_rows=SERVE_MAX_ROWS,
                            latency_budget_ms=SERVE_BUDGET_MS,
                            num_scorers=2).start()
        try:
            got, lat, wall = _serve_posts(pool, mp.addresses, X, side)
        finally:
            eng.stop()
        deaths = mp.counters["worker_deaths"]
        res["multiprocess"] = {
            "workers": 2, "requests": len(side),
            "rows_per_s": len(side) / wall,
            "client_p50_ms": float(np.percentile(lat, 50) * 1e3),
            "client_p99_ms": float(np.percentile(lat, 99) * 1e3),
            "worker_deaths": deaths,
            "replies_equal": bool(np.array_equal(got, want[:len(side)]))}
        if not res["multiprocess"]["replies_equal"] or deaths:
            bad.append(f"multiprocess: replies equal "
                       f"{res['multiprocess']['replies_equal']}, worker "
                       f"deaths {deaths}")
        # the fleets: two spawned workers each, on the card
        shard, replica = workers["fleet_shard"], workers["fleet_replica"]
        Xq = X[idx[:max(FLEET_ROWS)]]
        eq = {"shard": bool(np.array_equal(
                  shard(Xq), ShardedPredictor(card, num_shards=2)(Xq))),
              "replica": bool(np.array_equal(
                  replica(Xq), pred(Xq).cpu().numpy()))}
        res["fleet"] = {"workers": 2, "device": shard._device, "equal": eq}
        if not all(eq.values()):
            bad.append(f"fleet margins differ: {eq}")
        if not shard._device.startswith("cuda"):
            bad.append("the fleet's workers do not score on the card")
        res["fleet"]["ms"] = {
            n: {"shard": host_median_ms(lambda: shard(Xq[:n]), reps=3,
                                        warm=1),
                "replica": host_median_ms(lambda: replica(Xq[:n]), reps=3,
                                          warm=1),
                "in_process": host_median_ms(lambda: pred(Xq[:n]).cpu(),
                                             reps=3, warm=1)}
            for n in FLEET_ROWS}
    finally:
        for t in starters:
            t.join()
        for w in workers.values():
            if not isinstance(w, Exception):
                w.stop()
        pool.shutdown()
    if bad:
        raise AssertionError(f"serving_path: {'; '.join(bad)}: {res}")
    return res


#: lifecycle_path: the ingest buffer's window, reservoir and segment rows;
#: the drifting feed before the refresh (a ChaosDrift ramp of LIFE_SHIFT
#: on feature LIFE_FEATURE over LIFE_RAMP rows) in bursts of LIFE_BURST
#: one-row requests; the canary's bursts at most; the refresh's
#: iterations and checkpoint chunk; the traffic's seed
LIFE_WINDOW, LIFE_RESERVOIR, LIFE_SEGMENT = 50_000, 1_500, 8_192
LIFE_BURST, LIFE_FEED_BURSTS, LIFE_CANARY_BURSTS = 256, 204, 30
LIFE_FEATURE, LIFE_SHIFT, LIFE_RAMP = 3, 2.0, 20_000
LIFE_ITERATIONS, LIFE_CHUNK = 10, 5
LIFE_SEED = 18
#: the refresh fit: the flagship's settings
LIFE_TRAIN = dict(num_leaves=31, learning_rate=0.1, max_bin=255,
                  min_data_in_leaf=20, parallelism="serial", verbosity=0)
#: the episode-1 chain the merged journals must hold, in order
LIFE_CHAIN = ("refresh_triggered", "refresh_dataset", "refresh_fit_begin",
              "trainer_sigkill", "refresh_recovered", "refresh_candidate")


def life_labels(X):
    """The flagship's label without its noise: the ground truth the
    lifecycle's ingest tap joins to a scored row."""
    import numpy as np
    return (X[:, 0] * 1.5 + X[:, 1] * X[:, 2] + np.sin(X[:, 3] * 2)
            > 0).astype(np.float64)


class _Versions:
    """The registry's boosters on the card, loaded once each, and the
    replies' ledger (``tools.chaos_online.serve_batch``'s context)."""

    def __init__(self, registry):
        self.registry = registry
        self._boosters = {}
        self.led = {"total": 0, "wrong": 0, "dropped": 0, "by_version": {}}

    def booster(self, v):
        if v not in self._boosters:
            self._boosters[v] = self.registry.load(v, device=DEV)
        return self._boosters[v]


def _journal_chain(root):
    """The merged journals of the driver and both trainers: the first
    event of each of LIFE_CHAIN (episode 1), their order, and whether the
    fit began and recovered in different processes."""
    import glob
    from mmlspark_tpu_torch.core.telemetry import read_journal
    evs = []
    for path in sorted(glob.glob(os.path.join(root, "journal_*.jsonl"))):
        evs += read_journal(path)
    evs.sort(key=lambda e: (e["ts"], e["seq"]))
    at = {}
    for i, e in enumerate(evs):
        if e["ev"] in LIFE_CHAIN and e["ev"] not in at and (
                e["ev"] == "trainer_sigkill" or e.get("episode") == 1):
            at[e["ev"]] = (i, e["pid"])
    idx = [at.get(ev, (None, None))[0] for ev in LIFE_CHAIN]
    ordered = None not in idx and idx == sorted(idx)
    pids = (at.get("refresh_fit_begin", (0, None))[1],
            at.get("refresh_recovered", (0, None))[1])
    return {"events": dict(zip(LIFE_CHAIN, idx)), "ordered": ordered,
            "recovered_in_another_process": None not in pids
            and pids[0] != pids[1]}


def phase_lifecycle_path(state):
    """Phase 26 (module docstring): the model lifecycle on the flagship
    model, after ``tools/chaos_online.py``'s scenarios A, C and D, and
    the lease beacons over the transport."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mmlspark_tpu_torch.core.drift import (DriftConfig, DriftMonitor,
                                               set_drift_monitor)
    from mmlspark_tpu_torch.core.telemetry import get_journal
    from mmlspark_tpu_torch.gbdt import fit_bin_mapper, get_objective
    from mmlspark_tpu_torch.gbdt.booster import split_native_digest
    from mmlspark_tpu_torch.gbdt.engine import TrainParams, train_incremental
    from mmlspark_tpu_torch.io import (ChaosDrift, ChaosPlan, ColumnPlan,
                                       IngestBuffer, ModelRegistry,
                                       RefreshConfig, RefreshController,
                                       RolloutConfig, RolloutController,
                                       ScoringEngine)
    from mmlspark_tpu_torch.tools import chaos_drift as cd
    from mmlspark_tpu_torch.tools import chaos_online as co
    from mmlspark_tpu_torch.tools.chaos_training import \
        transport_heartbeat_drill
    t_phase = time.perf_counter()
    X, y = bench_data(N_ROWS, N_FEATURES)
    model = state.get("main_model")
    if model is None:
        model = _classifier(numIterations=50, device=DEV,
                            parallelism="serial").fit(
            {"features": X, "label": y})
    booster = model.getModel()
    # the estimator's own mapper: fit on the same rows with its seed
    mapper = fit_bin_mapper(X, max_bin=255,
                            seed=_classifier().getOrDefault("seed"))
    root = tempfile.mkdtemp(prefix="chip_smoke_lifecycle_")
    refresh_cfg = dict(hysteresis_evals=1, cooldown_s=5.0, min_fit_rows=400,
                       num_iterations=LIFE_ITERATIONS,
                       checkpoint_chunk=LIFE_CHUNK)
    counters = _counters()
    res = {"rows": N_ROWS, "features": N_FEATURES, "burst": LIFE_BURST,
           "window_rows": LIFE_WINDOW, "reservoir_rows": LIFE_RESERVOIR,
           "segment_rows": LIFE_SEGMENT, "iterations": LIFE_ITERATIONS,
           "checkpoint_chunk": LIFE_CHUNK, "nvidia_smi": card_line()}
    bad = []
    get_journal().configure(os.path.join(root, "journal_driver.jsonl"),
                            max_bytes=8 << 20)
    try:
        registry = ModelRegistry(os.path.join(root, "registry"))
        registry.publish(booster, activate=True)
        ingest = IngestBuffer(os.path.join(root, "ingest"), mapper,
                              window_rows=LIFE_WINDOW,
                              reservoir_rows=LIFE_RESERVOIR,
                              segment_rows=LIFE_SEGMENT, seed=LIFE_SEED,
                              register=False)
        rollout = RolloutController(
            registry, device=DEV, config=RolloutConfig(
                canary_fraction=0.5, soak_s=0.3, min_canary_rows=200,
                canary_deadline_ms=None, fast_window_s=1.0,
                slow_window_s=2.0))
        ctx = _Versions(registry)
        mon = DriftMonitor(booster.reference_profile, DriftConfig(
            duty=1.0, eval_interval_s=0.02, min_rows=200))
        rng = np.random.default_rng(LIFE_SEED)
        drift = ChaosDrift(ChaosPlan(LIFE_SEED), feature=LIFE_FEATURE,
                           shift=LIFE_SHIFT, ramp_rows=LIFE_RAMP,
                           name="lifecycle_feed")

        def engine(monitor=None):
            return ScoringEngine(
                server, predictor=rollout,
                plan=ColumnPlan("features", N_FEATURES),
                max_rows=LIFE_BURST, latency_budget_ms=5.0, num_scorers=2,
                num_repliers=0, drift_monitor=monitor,
                ingest_tap=lambda rows, m: ingest.append(
                    rows, life_labels(rows))).start()

        # the drifting feed on version 1, tapped into the ingest buffer
        server = cd._QueueServer()
        eng = engine(mon)
        served, tail, detect = 0, [], None
        t0 = time.perf_counter()
        try:
            for i in range(LIFE_FEED_BURSTS):
                batch = drift(X[rng.integers(0, N_ROWS, LIFE_BURST)])
                served = co.serve_batch(ctx, server, served, batch, [1],
                                        f"f{i}_", binary=True)
                tail.append(batch)
                if detect is None and i % 4 == 3 and \
                        mon.report()["alerting"]:
                    detect = served
        finally:
            eng.stop()
            set_drift_monitor(None)
        res["feed"] = {"rows": served,
                       "seconds": time.perf_counter() - t0,
                       "detection_rows": detect,
                       "alerting": mon.report()["alerting"]}
        ingest.flush()
        res["ingest_rows_durable"] = ingest.rows_durable
        np.savez(os.path.join(root, "drifted.npz"),
                 X=np.concatenate(tail)[-4096:])
        # the refresh: a trainer SIGKILLed after its first checkpoint, a
        # fresh one resuming the episode
        co.write_trainer_config(root, device=DEV, objective="binary",
                                refresh=refresh_cfg, train=LIFE_TRAIN,
                                kill_at=LIFE_CHUNK)
        r1, _, start1 = co.run_trainer(root, "kill")
        ck = os.path.join(root, "refresh", "ckpt_0001",
                          "boost_checkpoint.npz")
        with open(os.path.join(root, "refresh",
                               "refresh_state.json")) as fh:
            killed_state = json.load(fh)["state"]
        durable = os.path.exists(ck)
        r2, info2, start2 = co.run_trainer(root, "resume")
        res["trainers"] = {
            "start_s": [start1, start2],
            "kill_returncode": r1.returncode,
            "killed_state": killed_state, "checkpoint_durable": durable,
            "resume_returncode": r2.returncode, "resumed": info2}
        if r1.returncode != -9 or killed_state != "fitting" or not durable:
            bad.append("the first trainer was not killed mid-fit")
        if r2.returncode != 0 or not info2 or info2.get("candidate") != 2:
            bad.append("the resumed trainer published no candidate")
            res["trainer_stderr"] = r1.stderr[-1500:] + r2.stderr[-1500:]
            raise AssertionError(f"lifecycle_path: {'; '.join(bad)}: "
                                 f"{res}")
        if not info2["launches"]["hist_full"] or \
                not info2["launches"]["hist_segment"]:
            bad.append("the resumed fit launched no histogram kernel")
        registry.reload()
        res["candidate_meta"] = registry.entry(2).get("meta")
        # the uninterrupted fit of the same dataset on the card
        with np.load(os.path.join(root, "refresh",
                                  "dataset_0001.npz")) as ds:
            bins, labels = ds["bins"], ds["labels"]
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clean = train_incremental(
            bins, labels, mapper,
            init_booster=registry.load(1, device=DEV),
            objective=get_objective("binary"),
            params=TrainParams(num_iterations=LIFE_ITERATIONS,
                               checkpoint_chunk=LIFE_CHUNK,
                               checkpoint_dir=os.path.join(root, "clean"),
                               **LIFE_TRAIN), device=DEV)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        new = clean.trees[len(booster.trees):]
        res["uninterrupted"] = {
            "rows": len(bins), "fit_s": time.perf_counter() - t0,
            "launches": launches,
            "trees": len(new), "splits": sum(t.num_leaves - 1 for t in new),
            "same_model_text": split_native_digest(registry.read_text(2))
            == clean.save_native_model_string()}
        state["life_launches"] = launches
        if not res["uninterrupted"]["same_model_text"]:
            bad.append("version 2's text differs from the uninterrupted fit's")
        if launches["hist_full"] != len(new) or \
                launches["hist_segment"] != res["uninterrupted"]["splits"]:
            bad.append("the uninterrupted fit's launches do not match its "
                       "trees and splits")
        # the driver adopts the episode: canary, gate, promote
        refresh = RefreshController(
            os.path.join(root, "refresh"), registry=registry,
            rollout=rollout, ingest=IngestBuffer(os.path.join(root,
                                                              "ingest"),
                                                 register=False),
            monitor=None, config=RefreshConfig(**refresh_cfg),
            register=False, device=DEV)
        polls = [refresh.poll(now=50.0)]
        server = cd._QueueServer()
        eng = engine()
        gate, served2, live = "soaking", 0, [1, 2]
        t0 = time.perf_counter()
        try:
            for i in range(LIFE_CANARY_BURSTS):
                batch = drift(X[rng.integers(0, N_ROWS, LIFE_BURST)])
                served2 = co.serve_batch(ctx, server, served2, batch, live,
                                         f"c{i}_", binary=True)
                if gate != "promoted":
                    time.sleep(0.02)        # the soak runs on the clock
                    gate = rollout.tick()
                if gate == "promoted":
                    if live == [2]:
                        break               # a burst on version 2 alone
                    live = [2]
        finally:
            eng.stop()
        wall = time.perf_counter() - t0
        snap = eng.stats_snapshot()
        st = snap["stages"]
        polls.append(refresh.poll(now=60.0))
        res["canary"] = {
            "polls": polls, "gate": gate, "rows": served2, "wall_s": wall,
            "rows_per_s": served2 / wall,
            "stage_p50_ms": {k: st[k]["p50_ms"] for k in (
                "dispatch_host", "device_wait", "score", "e2e") if k in st},
            "active_version": registry.active_version()}
        if polls != ["canary", "promoted"] or gate != "promoted" or \
                registry.active_version() != 2:
            bad.append("the candidate did not canary and promote")
        res["replies"] = dict(ctx.led)
        if ctx.led["wrong"] or ctx.led["dropped"] or \
                ctx.led["total"] != served + served2 or \
                sorted(ctx.led["by_version"]) != ["v1", "v2"]:
            bad.append("a reply matches no live version, or was dropped")
        res["journal"] = _journal_chain(root)
        if not res["journal"]["ordered"] or \
                not res["journal"]["recovered_in_another_process"]:
            bad.append("the journals do not hold the episode's chain")
    finally:
        get_journal().configure(None)
        shutil.rmtree(root, ignore_errors=True)
    # the lease beacons over the transport, in this process
    verdicts, detail = transport_heartbeat_drill()
    res["beacons"] = {"verdicts": verdicts,
                      **{k: detail[k] for k in ("link_kills", "peer_lost",
                                                "injected_stalls")},
                      "resumes": detail["counters_delta"].get("resumes")}
    if not all(verdicts.values()):
        bad.append("a beacon verdict failed")
    # both kernels at the refresh fit's shapes: the dataset's rows of the
    # flagship matrix, and half of them as the segment
    n = res["uninterrupted"]["rows"]
    fit_inputs = _cut(kernel_inputs(), n, N_FEATURES)
    order = torch.randperm(n, generator=torch.Generator().manual_seed(
        0)).to(torch.int32).to(DEV)
    krows = [{**_full_row(fit_inputs, "float32"), "path": "lifecycle_path"},
             {**_segment_row(fit_inputs, order, n // 2, "float32"),
              "path": "lifecycle_path"}]
    state["kernel_rows"] = state.get("kernel_rows", []) + krows
    res["kernel_rows"] = krows
    if not all(r["match"] for r in krows):
        bad.append("a kernel disagrees with its twin at the refresh's "
                   "shapes")
    res["phase_s"] = time.perf_counter() - t_phase
    if bad:
        raise AssertionError(f"lifecycle_path: {'; '.join(bad)}: {res}")
    return res


def kernels_line(state):
    rows = {r["kernel"]: r for r in state.get("kernel_rows", [])
            if r["accum"] == "float32" and "path" not in r
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
    # the int32 modes, on the quantized path: their rows at its shapes,
    # their launches from its timed fits
    quant = {}
    for r in state.get("kernel_rows", []) + state.get("ring_rows", []):
        if r.get("path") == "quantized_path" and r["rows"] in (
                N_ROWS, max(SEGMENT_COUNTS), WIDE_LOCAL_ROWS):
            quant[r["kernel"]] = r
    qlaunch = {**state.get("quant_launches", {}),
               "fused_segment_hist_ring": state.get("quant_fused_launches",
                                                    0)}
    # the histogram kernels at the ranking main path's shapes, their
    # launches from its timed fit
    rank = {}
    for r in state.get("kernel_rows", []):
        if r.get("path") == "ranking_path" and (
                r["kernel"] == "hist_full" or r["rows"] == MEDIAN_SEGMENT):
            rank[r["kernel"]] = r
    # the histogram kernels at the bundled table's G columns (launches
    # from efb_path's timed bundled fit) and their wide modes at B =
    # 1,024 and 512 (launches from wide_bins_path's timed serial fits):
    # hist_full at the full matrix, hist_segment at the median segment
    extra = []
    for k in ("hist_full", "hist_segment"):
        for r in state.get("kernel_rows", []):
            if r["kernel"] != k or r["accum"] != "float32" or (
                    k == "hist_segment" and r["rows"] != MEDIAN_SEGMENT):
                continue
            if r.get("path") == "efb_path":
                extra.append((k, r, state.get("efb_launches", {}).get(k, 0),
                              "efb"))
            elif r.get("path") == "wide_bins_path" and r["bins"] in (
                    b + 1 for b in WIDE_MAX_BINS):
                extra.append((k, r, state.get("wide_launches", {}).get(
                    r["bins"] - 1, {}).get(k, 0), f"wide_{r['bins']}"))
    # the histogram kernels at a gang controller's shapes, their launches
    # summed over multicontroller_path's controllers
    gang = {r["kernel"]: r for r in state.get("kernel_rows", [])
            if r.get("path") == "multicontroller_path"}
    life = {r["kernel"]: r for r in state.get("kernel_rows", [])
            if r.get("path") == "lifecycle_path"}
    out = []
    for name, r, n_launch, mode in (
            [(k, rows.get(k, {}), launches.get(k, 0), "float32")
             for k in REPLACES]
            + [(k, quant.get(k, {}), qlaunch.get(k, 0), "int32")
               for k in ("hist_full", "hist_segment",
                         "fused_segment_hist_ring")]
            + [(k, rank.get(k, {}), state.get("rank_launches", {}).get(k, 0),
                "ranking") for k in ("hist_full", "hist_segment")]
            + extra
            + [(k, rows.get(k, {}), state.get("cont_launches", {}).get(k, 0),
                "continued") for k in ("hist_full", "hist_segment",
                                       "ring_allreduce",
                                       "fused_segment_hist_ring")]
            + [(k, rows.get(k, {}), state.get("ft_launches", {}).get(k, 0),
                "fault_tolerance") for k in ("hist_full", "hist_segment",
                                             "ring_allreduce")]
            + [(k, gang.get(k, {}), state.get("gang_launches", {}).get(k, 0),
                "multicontroller") for k in ("hist_full", "hist_segment")]
            + [(k, rows.get(k, {}), state.get("obs_launches", {}).get(k, 0),
                "observability") for k in ("hist_full", "hist_segment")]
            + [(k, life.get(k, {}), state.get("life_launches", {}).get(k, 0),
                "lifecycle") for k in ("hist_full", "hist_segment")]):
        out.append({"name": name if mode == "float32" else f"{name}_{mode}",
                    "mode": "int32" if mode == "int32" else "float32",
                    "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name], "launches": n_launch,
                    "max_abs_err": r.get("max_abs_err"),
                    "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                    "bound_ms": r.get("bound_ms"),
                    "bound_by": r.get("bound_by"),
                    "library_ms": r.get("library_ms"),
                    "device_ms": r.get("device_ms"),
                    "rows": r.get("rows"), "features": r.get("features"),
                    "bins": r.get("bins", 256),
                    "shards": r.get("shards", 1)})
        if mode == "multicontroller":
            out[-1]["launches_per_controller"] = state.get(
                "gang_controllers", {}).get(name)
    return {"kernels": out}


def main(argv) -> int:
    import torch
    if argv[:1] == ["--fault-tolerance-worker"] and len(argv) == 2:
        return fault_tolerance_worker(argv[1])
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
    # a fit that fails (the budget's refusal, the injected failures)
    # leaves its flight record in a temporary directory, not the checkout
    if "MMLSPARK_TPU_FLIGHTREC_DIR" not in os.environ:
        import tempfile
        os.environ["MMLSPARK_TPU_FLIGHTREC_DIR"] = tempfile.mkdtemp(
            prefix="chip_smoke_flightrec_")
    state = {}
    failed = []
    env = None
    phases = [("environment", phase_environment),
              ("build", phase_build),
              ("kernels", lambda: phase_kernels(state)),
              ("main_path", lambda: phase_main_path(state)),
              ("continued_path", lambda: phase_continued_path(state)),
              ("cuda_vs_cpu", phase_cuda_vs_cpu),
              ("profile", phase_profile),
              ("collectives", lambda: phase_collectives(state)),
              ("mesh_path", lambda: phase_mesh_path(state)),
              ("voting_path", lambda: phase_voting_path(state)),
              ("categorical_path", lambda: phase_categorical_path(state)),
              ("multiclass_path", lambda: phase_multiclass_path(state)),
              ("validation_path", lambda: phase_validation_path(state)),
              ("goss_path", lambda: phase_goss_path(state)),
              ("quantized_path", lambda: phase_quantized_path(state)),
              ("objectives_path", lambda: phase_objectives_path(state)),
              ("dart_path", lambda: phase_dart_path(state)),
              ("rf_path", lambda: phase_rf_path(state)),
              ("ranking_path", lambda: phase_ranking_path(state)),
              ("efb_path", lambda: phase_efb_path(state)),
              ("wide_bins_path", lambda: phase_wide_bins_path(state)),
              ("native_path", lambda: phase_native_path(state)),
              ("fault_tolerance_path",
               lambda: phase_fault_tolerance_path(state)),
              ("multicontroller_path",
               lambda: phase_multicontroller_path(state)),
              ("collectives_cross_card", phase_collectives_cross_card),
              ("observability_path",
               lambda: phase_observability_path(state)),
              ("serving_path", lambda: phase_serving_path(state)),
              ("lifecycle_path", lambda: phase_lifecycle_path(state)),
              ("kernels_flagship", lambda: phase_kernels_flagship(state))]
    if only is not None:
        unknown = only - {name for name, _ in phases}
        if unknown:
            print(f"chip_smoke: unknown phases {sorted(unknown)}",
                  file=sys.stderr)
            return 2
        phases = [(name, fn) for name, fn in phases
                  if name in only | {"environment", "build"}]
    else:
        phases = [(name, fn) for name, fn in phases
                  if name not in ONLY_WHEN_NAMED]
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
