#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``twtml_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. device  — the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build   — compile every kernel of the port from ``twtml_tpu_torch/csrc``,
               and the host library of the wire path from ``native/*.cpp``;
  3. kernel  — the fused dense-SGD kernel (one cooperative launch a call)
               against its plain PyTorch twin on the card, case by case, at
               rtol 1e-4 / atol 1e-5 (only the summation order differs), each
               rerun bitwise equal: 7 cases of mixed sizes, then B = 1 and
               B = 16 (smaller than one CTA's rows), B = 16381 (a ragged last
               CTA, rows spilled), B = 4096 x F = 8196 (the tiled wide-F and
               spill path) with NaN/Inf in masked rows bitwise ignored, and
               the operating point (spill path); and a valid row holding a
               NaN label, then an Inf feature: the twin's non-finite
               pattern in w and preds, every iteration run; then the
               kernel's logistic residual mode (r = σ(x·w) − y, 0/1 labels)
               at the same shapes: the narrow pass, count 0, a ragged last
               CTA with rows spilled, the tiled wide pass (NaN/Inf in masked
               rows bitwise ignored) and the operating point;
 3b. kernel  — the sparse regime's Gram route (``ops/fused_gram.py``) at
               F = 2^18 against its plain twins on the card: B4's counts and
               the G product bitwise at a row mass of 127 (int8 counts,
               ``torch._int_mm``), 128 and 255 (f32 counts), fractional
               values within rtol 1e-6; B7 (the dual loop, one cooperative
               launch) at B = 1, 16, 2048, 3072 and 4096 (G spilled to L2),
               count 0, the logistic mode, ``-b 0.5`` masks, tolerance 0 and
               0.001 and tolerances that stop it at iterations 2 and N - 1,
               with the twin's iterations run and one grid barrier an update
               (the count the kernel writes), NaN/Inf in masked rows bitwise
               ignored, within rtol 1e-4 / atol 1e-5, and two replays of a
               CUDA graph that captured it bitwise the eager launch; B8 (the
               write-back, from the batch's tokens) in both planes and in
               the skew cases (85 hot columns, every token in one column,
               padding in column 0, a model axis's clamped slice, L = 511,
               indices out of range, a NaN or Inf α) within rtol 2e-4 of
               its plain version and of the per-occurrence scatter, its
               text columns bitwise its order on the host, and in a CUDA
               graph replayed twice bitwise the eager launch; each rerun
               bitwise equal;
  4. main    — the flagship app (``apps/linear_regression.run``, its
               streaming context and fetch pipeline, ``--seconds 0
               --batchBucket 16384``) on cuda for 4 full-width synthetic
               batches (16384 tweets, 1000 + 4 dims, 50 iterations,
               --modelWatch on) on its back-to-back wire: one native fill and
               one native pack a batch into ONE page-locked buffer, one H2D
               copy, decoded on the card. The kernel's launch counter (the 4
               batches and the pre-stream warm-up) and the native counters
               show the path went through them; the stats are held against
               the same app on the CPU;
  5. padded  — the same 4 batches on cuda through ``--wire padded``: weights,
               predictions, stats and quality bitwise equal to phase 4's;
  6. replay  — the replay fixture on cuda on both wires, lines equal to the
               CPU runs';
  7. stream  — 8 full-width batches of pinned synthetic tweets from a
               pre-filled queue source, publishing to a loopback recorder
               (this script's ``http.server``): 1 config post, 8 stats posts
               equal to the 8 printed lines, 8 series posts of at most
               SERIES_MAX_POINTS points, a Lightning session and 8 appends;
               every dispatch under ``torch.cuda.set_sync_debug_mode
               ("error")``; the run at fetch depth 8 bitwise equal to a run
               at depth 1 with synchronous copies (weights, predictions,
               stats, quality); per-batch dispatch, fetch wait, depth and
               publish times; tweets/s over batches 2-8; the device's idle
               share and the H2D copies against the kernels from a profiled
               run; the live synthetic source's own rate;
 7b. bench   — the port's bench entry (``twtml_tpu_torch/bench.py``
               ``measure``, the counterpart of the root ``bench.py``'s
               headline measurement) on cuda at 8 batches of 16384 tweets,
               2 warm-up steps, 3 passes and no budget, with prefetch on and
               off, then at 1 pass: B1 launched 2 + passes x 8 times in each
               run; the final mse and weights bitwise equal across prefetch
               on and off (a host buffer reused under a pending copy would
               part them), the final mse across 1 and 3 passes (``reset()``
               before each); tweets/s best and median, passes and health;
               the device's idle share and the kernels a step from one
               profiled pass;
  8. guards  — the runtime guards at the stream's width and depth, from a
               pre-filled source, every dispatch under the sync-debug mode
               "error": a poisoned batch (``--chaos source.nan@5``) with a
               checkpoint every batch rolls back once, replays its rows from
               the journal, loses none, fetches once a dispatch, and ends
               bitwise equal to the clean run; the same at batch 7 with a
               checkpoint every 4 and batch 7 held in flight on the card
               (``torch.cuda._sleep``), so later batches drain as tainted
               skips; without a checkpoint the weights go back to zeros;
               4 + 4 resumed batches equal 8; a rollback storm aborts and
               leaves a flight-recorder bundle naming the last checkpoint;
               ``--recycleAfterMb 1`` in a subprocess re-execs and resumes
               exactly; the guards on against off: the same device work a
               step (profiler), both rates, and the save, journal append,
               rollback and dump times. Every checkpointed run has the
               telemetry historian on (``--history auto``, the JAX
               defaults): a ``--history off`` arm prints the same lines and
               ends with bitwise-equal weights, the profiled history-on run
               makes the same D2H copies and launches a step as the off run;
               the ms a ``sample()`` takes and the segment bytes a batch;
  9. sampled — ``-b 0.5``: the [50, 16384] Bernoulli masks made on the card
               bitwise equal to the CPU's (float32 and float64 draws); 4
               full-width batches on the torch loop under the sync-debug
               mode "error", against the ``--backend cpu`` twin (weights
               and stats within 1e-4), the fused kernel launched 0 times;
               the mask draw's and a step's device ms and launches;
 10. dtype   — ``--dtype bfloat16``: 4 full-width batches on the card, MSE
               falling, finite, within 2**-5 of the CPU twin, a step's
               device ms and launches; ``--dtype float64 --backend cuda``
               exits (CPU only, as in the JAX package) before building;
 11. clock   — ``--seconds 1`` on the default wire (padded), the synthetic
               source paced at 20000 tweets/s, 5 intervals: every interval's
               batch trains, the warm-up ends before the stream starts, the
               stats posts arrive; each tick's lateness and rows;
 12. web     — the port's dashboard server as a process of its own
               (``python -m twtml_tpu_torch.web.main -nocache``, a loopback
               PORT, a temporary TMPDIR): a websocket client (web/websocket.py)
               gets the Config push; 8 full-width batches of the stream
               phase's tweets on the card publish to it (Lightning stays at
               the recorder): each batch's Stats frame equals its printed
               line, GET /api/stats equals the last, GET / serves the port's
               index.html; publish ms a batch against the stream phase's,
               the POST latency (p50, p99) and the largest frame; SIGTERM
               stops it;
 13. live    — ``--source twitter`` with the OAuth credentials from an
               ``application.conf`` named by TWTML_CONFIG and
               ``twitter4j.streamBaseURL`` at a loopback chunked stream that
               checks every request's signature and serves the main phase's
               synthetic tweets: 4 full-width batches back to back, each line
               equal to the same tweets' from a pre-filled source on the
               card; the app's and the source's own tweets/s;
 14. hosthash — ``--hashOn host --wire padded --profileDir``: the main
               phase's 4 batches hashed on the host (native/fasthash.cpp),
               weights, predictions, stats and quality bitwise equal to the
               padded phase's, the fused kernel launched as there; the
               Chrome trace names the kernel and the app's annotated
               regions; host-hash featurize against the device-hash wire's,
               the profiled run's wall against an unprofiled run's;
 15. logistic — ``apps/logistic_regression.py`` on the card: 4 full-width
               batches of two-class tweets (a lexicon word drawn onto each
               original) from a pre-filled source under the sync-debug
               mode, B1 in its logistic mode 4 + 1 times, against the
               ``--backend cpu`` twin: weights and stats within 1e-4,
               predictions equal except rows whose margin is within 1e-4 of
               0 (counted); the labels' positive share;
 16. superbatch — ``--superBatch 8`` on the group wire (one packed buffer
               a group) and the stacked wire, and ``--superBatch 1``, every
               dispatch under the sync-debug mode, all three bitwise equal
               (weights, predictions, stats, quality, lines): over the
               stream phase's 8 batches (their ragged units buckets decide
               which group), then over 8 batches of one bucket fed twice, so
               the second group replays the CUDA graph the first captured;
               each arm's launches and H2D/D2H copies a dispatch (a
               ``--profileDir`` trace), host wall a batch, tweets/s;
 17. kmeans  — ``apps/kmeans.py`` on the card: the (3, 2) random centers
               bitwise the CPU's draw; 4 batches of 16384 retweets from a
               pre-filled source against the ``--backend cpu`` twin:
               assignments and sizes equal, centers and weights within
               1e-5;
 18. sparse  — BASELINE config #4 through the app: ``--numTextFeatures
               262144 --l2Reg 0.1 --batchBucket 2048``, 4 back-to-back
               batches on the ragged packed wire at depth 8 under the
               sync-debug mode, B4, B7 and B8 launched 4 + 1 times each and B1
               never, weights, stats and predictions (but HALF_UP flips) held
               against the card's scatter route and the ``--backend cpu``
               twin; one batch at B = 16384 (over the gate: the scatter loop)
               against its CPU twin; whether the card's scatter loop reruns
               bitwise; where a Gram step's time goes (gather predict, B4, the
               G product, B7, B8, quality; device busy, idle, launches);
 19. times   — at the operating point: the launch plan (grid, rows resident
               and spilled, shared memory, registers from ptxas), kernel,
               prologue and per-iteration times, the twin, the bound; each
               wire's featurize by sub-stage, bytes and H2D copy; and where
               a step's time goes on each wire; the logistic mode's kernel
               time (50 iterations), twin and bound; B4, the G product, B7
               (µs an iteration and the spread at both tolerances, grid
               barriers, one barrier crossing alone on a probe kernel; and
               at B = 3072 and 4096, G spilled) and B8 at config #4's
               operating point (B = 2048, F = 2^18),
               with ``torch.bincount`` as B4's library call and
               ``index_add_`` as B8's; B4's f32 build on tweet-length rows
               (L = 511): (a) on their tokens, (b) with every index out of
               range, (c) ``torch.bincount``, the counts bitwise the CPU
               twin's and a rerun's; B8 on the same rows (the f32 plane);
 20. serve   — the serving plane: a verified checkpoint (stamped ok) of the
               main phase's weights served by ``apps/serve.run`` on the card
               (the dashboard server on a loopback port); 2,000 requests of
               1-16 of the stream phase's tweets from 16 ``ServingClient``
               threads, every dispatch under the sync-debug mode "error":
               every answer bitwise equal to the card's train-step
               pre-update predictions of its rows (computed 256 rows at a
               time in another composition) under the snapshot step it
               names, across a second checkpoint written mid-load (the
               promoter's hot swap: both steps served, none torn); against
               the ``--backend cpu`` predict engine rounded predictions
               equal but HALF_UP flips of a raw margin within 2e-3 of a half
               (counted) and raw margins within 2e-3; B1 launched once a
               served batch plus the warm-up, each its predict kernel
               (N = 0: 0 iterations, the served weights bitwise the
               snapshot's); 0 client errors. Two ``python -m
               twtml_tpu_torch.apps.serve`` processes on the card behind
               ``apps/router.run``, under ``p99`` and under ``hash``, one
               of them killed halfway through the second load: 0 client
               errors, every answer bitwise the train step's, the kill
               counted as an ejection. A 262,148-weight snapshot (config
               #4) served on the gather predict, against the CPU twin, B1
               launched 0 times. Latency p50/p99, QPS and batch fill; one
               serve step's device ms, launches and host wall; B1's
               predict kernel at B = 256 and 16384 bitwise the N = 1
               launch's first-pass predictions, and at F = 2000 and 8196
               (the wide order), NaN/Inf in masked rows bitwise ignored,
               an all-padding batch predicting zeros; its device time
               (one call between events behind ~1 ms of sleep, and 50 calls
               back to back behind the long sleep of ``split_queued``)
               against its twin, ``torch.mv`` and its bound.
 21. tenants — the tenant plane (``--tenants``, parallel/tenants.py) on the
               card, 4 ticks of the stream phase's tweets from a pre-filled
               source under the sync-debug mode "error", ``--modelWatch on``:
               the linear app at M = 4 (hash key, ragged wire), B1 launched
               4 x (4 ticks + the warm-up) times, one fetch a tick (the
               model's ``fetch_output`` calls and ``fetch.count``); every
               tenant's predictions, stats, quality and final weights bitwise
               a standalone card learner stepped on its routed parts; the
               [4, 1004] stack and the pooled stats within 1e-4 of the
               ``--backend cpu`` twin; ``TWTML_FORCE_TENANT_PLANE=1
               --tenants 1`` bitwise the plain run (lines, weights);
               ``--chaos source.nan@3`` with a checkpoint every tick rolls
               the whole stack back to the verified archive once, replays,
               loses no row and ends bitwise the clean run; the logistic app
               at M = 2 and ``--tenantKey lang`` at M = 4 (a dry tenant)
               each bitwise standalone learners; from ``--profileDir``
               traces, M = 4 against the plain M = 1 run: host wall, device
               busy ms, launches and H2D/D2H copies a tick (one D2H), and
               tweets/s. Its vmap arm: B1's tenant grid
               (``fused_dense_sgd_tenants``) against its plain version in
               both residual modes on skewed parts (1 : 3 : 0 : 12
               thousand rows, a dry tenant, per-tenant step sizes and
               L2s), NaN/Inf in masked rows bitwise ignored, a NaN label
               kept in its tenant, parts of 16 rows, all dry, text values
               no count is (a 300, a 2.5, a NaN in a valid row), M = 16
               and M = 32; reruns bitwise; at 4 x 4096 valid rows its
               resident and spilled rows, its device time
               against the 4 single B1 launches on the same parts and B1
               on the 16384 rows, in turns behind a long queued sleep, and
               its timing instantiation's phase split; then
               ``TenantStackModel(mapping="vmap")`` (library level) on the
               linear app run's parts (M = 4) and the logistic one's (M =
               2): the grid launched once a tick (4 + the warm-up) and B1
               never, under the sync-debug mode, each tick's counts equal
               to the scan form's, predictions equal but flips at a tie,
               stats, quality and the final stack within 1e-3; both
               forms' host wall, device busy ms, launches and copies a
               tick (M = 4);
 22. abtest  — champion/challenger serving: ``--tenants 3`` trained on the
               card with ``--checkpointDir`` (the stack and a quality stamp a
               tenant in its verified meta); ``apps.serve --abtest on`` over
               that stack and a single-model ``apps.serve`` (the champion's
               weights) as processes of their own, every dispatch under the
               sync-debug mode; 2,000 requests from 16 ``ServingClient``
               threads of this process to each: every A/B answer bitwise the
               champion tenant's card train step under the step it names,
               across a checkpoint written mid-load whose stamps promote
               challenger 1 once and refuse the alert challenger 2
               (``promotions`` 1, ``refusedPromotions`` 1 in the Serving
               view), the router's Fleet view naming the champion; B1
               launched 3 x (served batches + the warm-up) times in the A/B
               process, each its predict kernel; requests/s and client
               p50/p99 of both servers.
23. block   — block ingest and the digram wire codec: the superbatch
               phase's 8 one-bucket batches written as a replay file; the
               linear app on the card with ``--ingest object``, ``--ingest
               block`` and ``--ingest block --wireCodec dict`` (``--seconds
               0 --batchBucket 16384``, every dispatch under the sync-debug
               mode "error"): the same 8 batches (rows a batch), lines,
               weights, predictions, stats and quality bitwise equal across
               the arms, B1 launched 8 + 1 times each, the C wire emitter
               parsing with 0 degraded parses, fills or packs and 0 codec
               fallbacks; the coded arm against its ``--backend cpu`` twin
               (batch 1's line identical, every stat within 1e-4); each
               arm's featurize by sub-stage, pack, wire bytes (raw and
               coded, ``wire.codec_ratio``), parse rate and tweets/s over
               batches 2-8; the raw and coded wires' pack ms, H2D ms, device
               busy ms and kernels a step (the difference: the decode's
               kernels) and ``units_from_codes`` alone (CUDA events, median
               of 25); ``--superBatch 8 --wirePack group`` over the file
               twice (the second group replays the CUDA graph, the decode
               inside) and ``--tenants 4 --wirePack group``, each with the
               codec bitwise without it; the logistic app (4 two-class
               batches) and k-means (4 batches) with ``--ingest block``,
               lines equal the CPU runs'; ``--chaos source.nan@5
               --checkpointEvery 1`` rolling back once and replaying its
               rows from kind-2 (block) journal records, 0 rows lost, lines
               and the final archive bitwise the clean block run's.
24. multihost — the lockstep multi-host runtime: B1's data-parallel
               split at world size 1 (a one-rank gloo group, through
               MultiHostSGDModel) bitwise B1 in both residual modes (2
               steps: weights, predictions, stats), each split launch against
               its plain version at a rank's B = 8192 (the iteration's
               launch at it = 2 bitwise the update-only launch and then a
               first launch from its weights); then the stream phase's first
               4 x 16384 tweets as a replay file and the linear app on 2
               ranks (``--master twtml://``, subprocesses, both on cuda:0,
               so gloo) at 8192 rows a rank against one process on the card
               at 16384: the lead's lines (count and batch exact, rounded
               stats within 2), the follower silent, the final weights
               within rtol 1e-4 and atol 1e-7, each rank 51 split launches
               a step (50 iterations, the last update), 52 all-reduces, one
               alignment all-gather
               a batch, no fused launch; the same for ``--wireCodec dict``,
               ``--superBatch 4`` and the 2^18 Gram route at B = 2048;
               ``--ingest block`` on byte-range shards against its emulation
               on the card; a resume that trains nothing; ``source.nan@3``
               rolled back on both ranks; ``peer.kill`` of rank 1 at tick 3
               (rank 1 exits 77, the survivor non-zero within the watchdog);
               a rank's step ms, launches, all-reduce and cadence all-gather
               ms, host wall a tick, tweets/s against one process, and each
               split launch's device time, twin time and bound.
25. elastic — ``--elastic on`` on the same 2 ranks and file: a healthy
               run with the lockstep main arm's collectives, fetches and
               split launches (as many cadence all-gathers as ticks), its
               host wall a tick and tweets/s beside the lockstep run's;
               ``peer.kill`` of uid 1 at tick 3 (``--checkpointEvery 1``):
               the survivor forms epoch 1 alone, and its final weights are
               bitwise those of a world-1 split run and of B1, each from
               the archive it restored, on the card in this process (the
               rescue's seconds from the kill, rows rolled back and
               replayed); ``peer.kill`` of uid 0: uid 1 wins the election,
               promotes its standby archives, held the same way; a
               restarted uid 1 parks and is admitted at an epoch boundary,
               its first tick's state CRC the lead's; the split kernels'
               launches and the phase's wall. The detached store processes
               the ranks start are gone (or stopped) when the phase ends.
26. modelaxis — the layouts over a model axis, every rank on cuda:0 over
               gloo, on tweets of ASCII and CJK words (an ASCII bigram
               hashes below 4,064, so only wider code units reach the
               second half of 2^18): B4 at each [2048, 2^17] slice, each
               holding tokens, bitwise its twin (short tweets int8 in both
               slices; tweet-length rows exact in the first, bf16 in the
               second), the G that a 2 x 2 and a 1 x 2 group sum from
               their ranks' panels bitwise one process's G, B7 on it and
               B8 at each rank's [1024, 2^17] slice against their twins,
               and B4 at a [2048, 500] slice; then
               ``tests/torch_mesh_worker.py`` in a 2 x 2 group (4 ranks)
               and a 1 x 2 group (2 ranks): the 2D Gram step at BASELINE
               config #4 (2^18, L2 0.1, 50 iterations, B = 2048 global) on
               3 batches of each kind against the port's one-process step
               on the card (weights within rtol 1e-4, each rank's
               predictions within 1e-4, HALF_UP flips counted, B4/B7/B8
               once a step), the small arm at F = 1000, the scatter route
               (2 x 256 rows, 10 iterations, 3 collectives an iteration), a
               checkpoint round trip bitwise, k-means over 2 data shards
               (assignments equal, centers within 1e-5) and 4 tenants on a
               1 x 2 model axis bitwise the one-process stack; then on the
               multihost phase's replay ``--tenants 4`` on 2 ranks against
               one process (lines, the stack within rtol 1e-4, one fetch a
               tick, 4 x 51 split launches a step),
               ``--elastic on --tenants 4`` with uid 1 killed (the
               survivor's stack bitwise the world-1 fleet's and the plain
               stack's from its archive) and the k-means app on 2 ranks
               against one process (lines equal, assignments equal); a
               rank's 2D step device ms and host wall, each axis's
               collectives and their ms, the fleet's tick and tweets/s,
               the k-means wall and the phase's; then its vmap arm (ROADMAP
               B10 b), 2 ranks on a data axis: the split with a tenant grid
               (``fused_dense_sgd_tenants_split``) against its plain
               version on each rank over the real all-reduce (rtol 1e-4 /
               atol 1e-5, both residual modes, a tenant dry on one rank
               and one on both, NaN/Inf in masked rows bitwise ignored,
               the ranks' stacks bitwise equal, one tenant bitwise the
               split); 4 tenants at 1004 columns on 8192 rows a rank, a
               warm-up and 4 ticks, the vmap form within 1e-3 of the scan
               form on the same mesh (HALF_UP flips counted), 52
               all-reduces a tick against 208, their ms and a rank's host
               wall a tick; the iteration launch's device ms at 4 x 2048
               valid rows against the split's on the same 8192 rows, its
               twin's, ``torch.bmm``'s and its bound; then its 2^18 arm
               (ROADMAP B10 d), 2 ranks on a data axis at config #4 (B =
               2048 global, 4 tenants routed by hash, model watch on): on
               each rank every call of B4's, B7's and B8's tenant forms
               held against its plain version on the same inputs (a short
               tick, a tick whose tweet-length row on rank 0 puts its
               tenant in another plane, ``-b 0.5`` with each tenant's own
               draws), a warm-up and 5 short ticks in turns of (vmap, scan,
               scan, vmap), each form's reruns bitwise, the vmap form
               within 1e-3 of scan on the short, mixed, ``-b 0.5`` and
               scatter-route ticks (HALF_UP flips counted), 2 all-gathers
               and 3 all-reduces a tick against scan's 8 and 12 (52
               all-reduces against 208 on the scatter route), their ms, a
               rank's host wall, device busy ms and launches a tick
               (profiled runs), and the three forms' device ms at rank 0's
               share of a tick, their plain versions', the library calls'
               and their bounds.
No app run publishes anywhere but the loopback recorder and, in the web,
serve and abtest phases, the port's own servers on loopback ports. The line before
the last is the kernels' JSON record (B1's least-squares mode with its
``bench`` (``launches_bench``) and ``tenants`` launches and the ``block`` phase's figures, its logistic mode, its predict kernel with its
``abtest`` launches, B4 with its f32 build on tweet-length rows, B7,
B8 and the split's two launches with their ``elastic`` and ``modelaxis`` launches, B4, B7 and
B8 with their ``modelaxis`` launches, the split's iteration launch with its library calls'
times, B1's tenant grid with the vmap arm's launches, the split with a tenant
grid with the modelaxis phase's vmap arm's launches, the tenant forms of
B4, B7 and B8 with the 2^18 vmap arm's launches, and again, named
``<form>:data_axis``, with the modelaxis phase's 2^18 arm's launches and
their times at its shapes); the last line is ``{"ok": true,
"device": {...}}``.

``python3 chip_smoke.py --times-only [--package-root DIR]`` runs phases 1
and 2 and then only the kernels' device times (B1's logistic mode, its
predict kernel, B4 in both planes, the G product, B7 at B = 2048, 3072
and 4096 and, where the tree has it, B7's tenant form at one tenant on
B7's 2048 rows with its probe's phase split where the tree has the timing
instantiation, B8), importing the port from DIR (another checkout unpacked
there), so that two versions can be timed in turns in one call; its last
line is that JSON.

``python3 chip_smoke.py --bench-only`` runs phases 1 and 2 and then only
the bench entry as a user runs it, ``python -m twtml_tpu_torch.bench`` in
a process of its own at its defaults (524288 tweets, batches of 16384, a
600 s budget, then its CPU child); it prints the entry's JSON line on the
line before the last.

``python3 chip_smoke.py --elastic-ab N`` runs phases 1 and 2 and then
only N alternating pairs of healthy group runs, lockstep and ``--elastic
on`` (``elastic_ab``); its last line is their JSON.

``python3 chip_smoke.py --modelaxis-only`` runs phases 1 and 2 and then
only the modelaxis phase, its tenant fleet and k-means app on synthetic
tweets; its last line is the phase's JSON.

``python3 chip_smoke.py --tenants-vmap-only`` runs phases 1 and 2, the
linear tenant app at M = 4 and the logistic one at M = 2 on 4 x 16384
synthetic tweets for their parts, then only the tenants phase's vmap arm;
its last line is the arm's JSON.

``python3 chip_smoke.py --tenants-sparse-only`` runs phases 1 and 2 and
then only the 2^18 vmap arm (``tenants_sparse_arm``: the tenant forms of
B4, B7 and B8 against their plain versions, B7's with the grid barriers
each launch crossed against the schedule's count, the vmap form against
scan at config #4 on short tweets, mixed planes and the scatter route, the
kernels' times, B7's tenant form's probe split); its last line is the
arm's JSON.

``python3 chip_smoke.py --tenants-mesh-only`` runs phases 1 and 2 and then
only the modelaxis phase's vmap arm on 5 x 16384 synthetic tweets, with
three turns of (vmap, scan, scan, vmap) for a longer reading of the tick's
wall; its last line is the arm's JSON.

``python3 chip_smoke.py --tenants-mesh-sparse-only`` runs phases 1 and 2
and then only the modelaxis phase's 2^18 vmap arm over a data axis
(``tenants_mesh_sparse_arm``); its last line is the arm's JSON.

``python3 chip_smoke.py --gram-ab N --package-root DIR`` runs phases 1 and
2 (on DIR's port) and then only N alternating pairs of the app's 2-rank
2^18 Gram route, the port found in DIR (e.g. the parent commit unpacked
there) against this checkout's (``gram_ab``); its last line is their JSON.

``python3 chip_smoke.py --grid-ab N --package-root DIR`` runs phases 1 and
2 (on DIR's port) and then only N alternating pairs of B1's tenant grid
at 4 x 4096 valid rows and with those rows as one tenant, DIR's port
against this checkout's, each in a process of its own, with each tree's
phase split where it has the timing instantiation (``grid_ab``); its last
line is their JSON.

``python3 chip_smoke.py --tsplit-ab N --package-root DIR`` runs phases 1
and 2 (on DIR's port) and then only N alternating pairs of the split with
a tenant grid at 4 x 2048 valid rows of a rank's 8192 x 1004: its
iteration and update-only launches against the split's on the same rows,
the host's enqueue and, where a tree has the timing instantiation, the
phase split at 4 tenants and at one tenant of every row, DIR's port
against this checkout's, each in a process of its own (``tsplit_ab``);
its last line is their JSON.

``python3 chip_smoke.py --dual-ab N --package-root DIR`` runs phases 1 and
2 (on DIR's port) and then only N alternating pairs of B7's tenant form at
config #4's 4 parts (tolerance 0.001 and 0) and at one tenant on B7's
2048 rows, with B7 (``dual_sgd``) at B = 2048, 3072 and 4096 in the same
processes, DIR's port against this checkout's, each in a process of its
own, with each tree's probe split where it has the timing instantiation
and whether B7's results at each B, in both residual modes and under
``-b 0.5``, are bitwise equal across the trees (``dual_ab``); its last
line is their JSON.

``python3 chip_smoke.py --wb-ab N --package-root DIR`` runs phases 1 and 2
(on DIR's port) and then only N alternating pairs of B8 in its four
forms: the single form on config #4's synthetic batch (the int8 plane)
and on tweet-length rows (the f32 plane), the tenant form at the 2^18 vmap
arm's 4 parts and at a data axis's rank 0 rows of each block, DIR's port
against this checkout's, each in a process of its own (``wb_ab``); a tree
whose B8 reads the count build's C gets its C built beforehand; its last
line is their JSON.

``python3 chip_smoke.py --split-ab N --package-root DIR`` runs phases 1 and
2 (on DIR's port) and then only N alternating pairs of one split
iteration's device time at a rank's B = 8192 x 1004, DIR's port (e.g. the
parent commit unpacked there) against this checkout's, each in a process
of its own (``split_ab``); its last line is their JSON.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE_ROOT = HERE  # where twtml_tpu_torch is imported from (``--package-root``)
OP_ROWS = 16384  # bench.py's operating point: tweets per batch
OP_ITERS = 50
RTOL, ATOL = 1e-4, 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
NOW_MS = 1_700_000_000_000


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


class Recorder:
    """A loopback HTTP server (127.0.0.1, a free port) standing in for the
    twtml web dashboard and a Lightning server: it records every POST (path,
    JSON body) and answers Lightning's session and visualization requests
    with ids ``s1`` and ``v1``."""

    def __init__(self):
        self.posts: list = []
        self._lock = threading.Lock()
        recorder = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("content-length", 0)))
                with recorder._lock:
                    recorder.posts.append((self.path, body))
                reply = {"/sessions/": {"id": "s1"},
                         "/sessions/s1/visualizations/": {"id": "v1"}}.get(self.path, {})
                data = json.dumps(reply).encode()
                self.send_response(200)
                self.send_header("content-type", "application/json")
                self.send_header("content-length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def take(self) -> list:
        """The posts recorded since the last call, their bodies parsed (here,
        not while the server takes them: a run's timed window should not
        carry the recorder's JSON parse)."""
        with self._lock:
            posts, self.posts = self.posts, []
        return [(path, json.loads(body or b"{}")) for path, body in posts]

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


RECORDER: Recorder | None = None


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} CUDA {torch.version.cuda} | "
          f"python {sys.version.split()[0]}")
    return smi


def build_phase():
    sys.path.insert(0, PACKAGE_ROOT)
    from twtml_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    phase("build", f"{len(paths)} kernel librar{'y' if len(paths) == 1 else 'ies'} "
          f"in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log = path.with_name(path.name + ".log")
        report = log.read_text().strip() if log.exists() else "(built earlier)"
        phase("build", f"{name}: {path.name}\n{report}")
    from twtml_tpu_torch.features import native

    t0 = time.perf_counter()
    lib = native.NativeLibrary(native.build())
    if lib.featurize_wire is None or lib.wire_assemble is None:
        raise AssertionError(f"{lib.path.name} lacks a native entry of the wire path")
    phase("build", f"native host library {lib.path.name} (g++, "
          f"{' '.join(native.FLAGS)}) in {time.perf_counter() - t0:.1f} s")


# ---- phase 3: kernel against twin ------------------------------------------

def design(rng, rows, features, n_valid, terms=40):
    """A tweet-like design: ``terms`` bigram counts of 1 or 2 per row in the
    text columns, 4 small numeric columns, a random mask."""
    import numpy as np

    x = np.zeros((rows, features), dtype="float32")
    cols = rng.integers(0, features - 4, size=(rows, terms))
    np.add.at(x, (np.arange(rows)[:, None], cols), rng.integers(1, 3, size=(rows, terms)))
    x[:, -4:] = rng.normal(size=(rows, 4)) * 1e-3
    y = rng.uniform(50, 900, size=(rows,)).astype("float32")
    mask = (rng.permutation(rows) < n_valid).astype("float32")
    return x, y, mask


def compare(name, got, want):
    import torch

    err = (got - want).abs()
    rel = (err / want.abs().clamp(min=1e-30)).max().item()
    bad = err > ATOL + RTOL * want.abs()
    if bad.any() or not torch.isfinite(got).all():
        i = int(err.argmax())
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol {RTOL} atol {ATOL}; "
            f"max abs err {err.max().item():.3e} at [{i}]: kernel "
            f"{got.flatten()[i].item():.8e} twin {want.flatten()[i].item():.8e}; "
            f"max |twin| {want.abs().max().item():.3e}"
        )
    return err.max().item(), rel


def op_point_batch():
    """The operating point's host batch: 16384 SyntheticSource(seed=3)
    tweets on the padded units wire."""
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    tweets = list(SyntheticSource(total=OP_ROWS, seed=3, base_ms=NOW_MS).produce())
    return Featurizer(now_ms=NOW_MS).featurize_batch_units(tweets, row_bucket=OP_ROWS)


def op_point_inputs(device):
    """The operating point's kernel inputs, densified on the card by the
    port's ops (1000 text + 4 numeric dims), and a small random w0."""
    import numpy as np
    import torch

    from twtml_tpu_torch.models.sgd import batch_to_device
    from twtml_tpu_torch.ops.sparse import densify_text
    from twtml_tpu_torch.ops.text_hash import hash_bigrams_device

    batch = batch_to_device(op_point_batch(), device)
    idx, val = hash_bigrams_device(batch.units, batch.length, 1000)
    x = torch.cat([densify_text(idx, val, 1000), batch.numeric], dim=1)
    w0 = torch.from_numpy(
        np.random.default_rng(3).normal(size=(1004,)).astype("float32") * 1e-3
    ).to(device)
    return x, batch.label, batch.mask, w0


def kernel_phase():
    import numpy as np
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    cases = []

    def case(name, x, y, mask, w0, dirty=False, **kw):
        """Kernel vs twin at rtol/atol, a bitwise rerun, and with ``dirty``
        NaN/Inf garbage in the masked rows, bitwise the same result."""
        kw.setdefault("num_iterations", OP_ITERS)
        kw.setdefault("step_size", 0.005)
        w, p = fused_sgd.fused_dense_sgd(x, y, mask, w0, **kw)
        w_ref, p_ref = fused_sgd.fused_dense_sgd_reference(x, y, mask, w0, **kw)
        w_again, p_again = fused_sgd.fused_dense_sgd(x, y, mask, w0, **kw)
        torch.cuda.synchronize()
        ew, rw = compare(f"{name} weights", w, w_ref)
        ep, rp = compare(f"{name} preds", p, p_ref)
        if not (torch.equal(w, w_again) and torch.equal(p, p_again)):
            raise AssertionError(f"{name}: reruns are not bitwise equal")
        note = "rerun bitwise equal"
        if dirty:
            keep = mask > 0
            x_d = torch.where(keep[:, None], x, float("nan"))
            y_d = torch.where(keep, y, float("inf"))
            w_d, p_d = fused_sgd.fused_dense_sgd(x_d, y_d, mask, w0, **kw)
            if not (torch.equal(w, w_d) and torch.equal(p, p_d)):
                raise AssertionError(f"{name}: NaN/Inf in masked rows reached the result")
            note += f"; NaN/Inf in {int((~keep).sum())} masked rows: bitwise equal"
        plan = fused_sgd.launch_plan(x.shape[0], x.shape[1], **sm_limits())
        mode = fused_sgd.residual_mode(kw.get("residual_fn"))
        phase("kernel", f"{name}: B={x.shape[0]} F={x.shape[1]} grid {plan.grid}, "
              f"{plan.resident_rows} rows resident, {plan.spill_rows} spilled; "
              f"residual mode {mode}, {int(fused_sgd.fused_dense_sgd.last_iterations.item())} "
              f"iterations run; max abs err w {ew:.3e} preds {ep:.3e}; max rel w {rw:.3e} "
              f"preds {rp:.3e}; {note}")
        cases.append((name, max(ew, ep), mode))
        return w, p

    x, y, m = design(rng, 16, 64, 14, terms=6)
    case("small", to(x), to(y), to(m), to(np.zeros(64, "float32")),
         num_iterations=30)
    x, y, m = design(rng, 1001, 1004, 1001)
    case("ragged", to(x), to(y), to(m), to(rng.normal(size=1004).astype("float32") * 1e-3))

    x, y, m = design(rng, 64, 1004, 0)
    w0 = to(rng.normal(size=1004).astype("float32"))
    w, p = case("count=0", to(x), to(y), to(m), w0, l2_reg=0.5)
    if not torch.equal(w, w0) or not torch.equal(p, torch.zeros_like(p)):
        raise AssertionError("count=0: weights must be unchanged, preds 0")

    x, y, m = design(rng, 256, 1004, 200)
    x_dirty, y_dirty = x.copy(), y.copy()
    x_dirty[m == 0] = np.nan
    y_dirty[m == 0] = np.inf
    w_clean, p_clean = case("masked clean", to(x * m[:, None]), to(y * m), to(m),
                            to(np.zeros(1004, "float32")))
    w_dirty, p_dirty = case("masked NaN/Inf", to(x_dirty), to(y_dirty), to(m),
                            to(np.zeros(1004, "float32")))
    if not (torch.equal(w_clean, w_dirty) and torch.equal(p_clean, p_dirty)):
        raise AssertionError("NaN/Inf garbage in masked rows reached the result")

    x, y, m = design(rng, 512, 1004, 500)
    case("converge tol 0.5", to(x), to(y), to(m), to(np.zeros(1004, "float32")),
         convergence_tol=0.5)
    case("l2Reg 0.1", to(x), to(y), to(m), to(np.zeros(1004, "float32")), l2_reg=0.1)

    # smaller than one CTA's rows, a ragged last CTA, the wide-F tiled path
    small_w0 = lambda f: to(rng.normal(size=f).astype("float32") * 1e-3)  # noqa: E731
    x, y, m = design(rng, 1, 1004, 1)
    case("B=1", to(x), to(y), to(m), small_w0(1004))
    x, y, m = design(rng, 16, 1004, 12)
    case("B=16", to(x), to(y), to(m), small_w0(1004), dirty=True)
    x, y, m = design(rng, 16381, 1004, 16000)
    case("ragged last CTA (spill path)", to(x), to(y), to(m), small_w0(1004), dirty=True)
    x, y, m = design(rng, 4096, 8196, 4000)
    case("wide F (tiled + spill path)", to(x), to(y), to(m), small_w0(8196), dirty=True)
    del x, y, m

    # non-finite data in a VALID row must propagate as in the twin (the
    # divergence sentinel sees it in the stats): a NaN label, and an Inf
    # numeric feature; the converged freeze must not hold on NaN
    x, y, m = design(rng, 256, 1004, 200)
    valid = np.flatnonzero(m > 0)
    w0 = small_w0(1004)
    y_nan = y.copy()
    y_nan[valid[3]] = np.nan
    nonfinite_case("NaN label in a valid row", to(x), to(y_nan), to(m), w0)
    x_inf = x.copy()
    x_inf[valid[5], -2] = np.inf
    nonfinite_case("Inf feature in a valid row", to(x_inf), to(y), to(m), w0)

    x, y, m, w0 = op_point_inputs(dev)
    case("operating point (spill path)", x, y, m, w0)

    # the logistic residual mode, r = σ(x·w) − y, at the same shapes, with
    # 0/1 labels: the narrow pass, count 0, rows spilled to L2 and the
    # tiled wide pass, each with NaN/Inf in its masked rows (σ(0) − 0 = 0.5
    # times a zeroed row adds nothing), and the operating point
    logistic = dict(residual_fn=fused_sgd.logistic_residual, step_size=0.1)
    binary = lambda n: to((rng.random(n) < 0.5).astype("float32"))  # noqa: E731
    x_, _, m_ = design(rng, 1001, 1004, 1001)
    case("logistic ragged (narrow pass)", to(x_), binary(1001), to(m_), small_w0(1004),
         **logistic)
    x_, _, m_ = design(rng, 64, 1004, 0)
    w0_ = to(rng.normal(size=1004).astype("float32"))
    w_, p_ = case("logistic count=0", to(x_), binary(64), to(m_), w0_, **logistic)
    if not torch.equal(w_, w0_) or not torch.equal(p_, torch.zeros_like(p_)):
        raise AssertionError("logistic count=0: weights must be unchanged, preds 0")
    x_, _, m_ = design(rng, 16381, 1004, 16000)
    case("logistic ragged last CTA (spill path)", to(x_), binary(16381), to(m_),
         small_w0(1004), dirty=True, **logistic)
    x_, _, m_ = design(rng, 4096, 8196, 4000)
    case("logistic wide F (tiled + spill path)", to(x_), binary(4096), to(m_),
         small_w0(8196), dirty=True, **logistic)
    del x_, m_
    case("logistic operating point (spill path)", x, op_point_labels(dev), m, w0,
         dirty=True, **logistic)
    torch.cuda.synchronize()
    return ({mode: max(e for _, e, md in cases if md == mode) for mode in (0, 1)},
            [name for name, _, _ in cases] + NONFINITE_CASES)


def op_point_labels(device):
    """0/1 labels of the operating point for the logistic mode, drawn from
    a fixed seed (the synthetic tweets' sentiment is all 1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(8)
    return torch.from_numpy((rng.random(OP_ROWS) < 0.6).astype("float32")).to(device)


NONFINITE_CASES: list = []


def nonfinite_case(name, x, y, mask, w0, **kw):
    """A valid row holding NaN or Inf: the kernel's w and preds have the
    twin's non-finite pattern (NaN, +Inf and -Inf at the same elements),
    agree with it on the finite ones, rerun bitwise equal, and run every
    iteration (no freeze on NaN)."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    kw.setdefault("num_iterations", OP_ITERS)
    kw.setdefault("step_size", 0.005)
    w, p = fused_sgd.fused_dense_sgd(x, y, mask, w0, **kw)
    iters = int(fused_sgd.fused_dense_sgd.last_iterations.item())
    w_ref, p_ref = fused_sgd.fused_dense_sgd_reference(x, y, mask, w0, **kw)
    w_again, p_again = fused_sgd.fused_dense_sgd(x, y, mask, w0, **kw)
    torch.cuda.synchronize()
    for what, got, want in (("weights", w, w_ref), ("preds", p, p_ref)):
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(test(got), test(want)):
                raise AssertionError(f"{name} {what}: {test.__name__} pattern differs: "
                                     f"kernel {int(test(got).sum())}, twin "
                                     f"{int(test(want).sum())}")
        fin = torch.isfinite(want)
        if fin.any():
            compare(f"{name} {what} (finite)", got[fin], want[fin])
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    if not (torch.equal(bits(w), bits(w_again)) and torch.equal(bits(p), bits(p_again))):
        raise AssertionError(f"{name}: reruns are not bitwise equal")
    if iters != kw["num_iterations"]:
        raise AssertionError(f"{name}: the kernel froze after {iters} iterations")
    phase("kernel", f"{name}: weights {int(torch.isnan(w).sum())}/{w.numel()} NaN, preds "
          f"{int((~torch.isfinite(p)).sum())}/{p.numel()} non-finite, as the twin's; "
          f"finite elements within rtol {RTOL} atol {ATOL}; rerun bitwise equal; "
          f"{iters} iterations run (no freeze on NaN)")
    NONFINITE_CASES.append(name)


def sm_limits():
    """The launch plan's card arguments for device 0."""
    from twtml_tpu_torch.ops import fused_sgd

    sm_count, shared_limit = fused_sgd.device_limits(0)
    return {"sm_count": sm_count, "shared_limit": shared_limit}


# ---- phase 3b: the Gram route's kernels against their twins --------------

GRAM_F = 2**18  # BASELINE config #4's HashingTF width
GRAM_ROWS = 2048  # its operating point (tools/bench_suite.py)
# weights against the scatter route and the CPU twin: the JAX package's own
# Gram-vs-scatter tolerance (tests/test_gram_sgd.py), scaled by max(1, max|w|)
WEIGHT_RTOL = 2e-4
GRAM_EXACT_RTOL = 1e-6  # the exact plane's G (f32 products in another order)


def gram_tokens(rng, rows, peak, fractional=False, terms=40, tokens=48):
    """[rows, tokens] (idx int32, val f32) pairs at F = 2^18: ``terms``
    tweet-like tokens of value 1 or 2 a row, the rest padding (idx 0, val
    0); row 0's first two tokens are feature 7 with values summing to
    ``peak`` (its absolute mass is ``peak`` plus its other terms' unless
    ``peak`` rules it), and row 1 holds feature 7 once (G[0, 1] witnesses a
    count that wrapped). ``fractional`` scales every value by 0.37."""
    import numpy as np

    idx = np.zeros((rows, tokens), np.int32)
    val = np.zeros((rows, tokens), np.float32)
    idx[:, :terms] = rng.integers(0, GRAM_F, size=(rows, terms))
    val[:, :terms] = rng.integers(1, 3, size=(rows, terms))
    if peak:
        idx[0, :] = 0
        val[0, :] = 0.0
        idx[0, :2] = 7
        val[0, :2] = (peak - peak // 2, peak // 2)
        idx[1, 0], val[1, 0] = 7, 1.0
    if fractional:
        val *= 0.37
    return idx, val


def b8_cases(rng, int8_tokens):
    """B8's holds at B = GRAM_ROWS, F = 2^18: (name, idx, val, F, options)
    on the card. The int8 plane's tokens (the count build's row mass 127
    case) and the same values scaled by 0.37 (the f32 plane); the skews: 85
    hot columns (synthetic tweets, ~1,500 occurrences each), every token in
    one column, the padding slots (value 0) in column 0 and a model axis's
    slice (the tokens outside clamped into columns 0 and f_local - 1, value
    0), tweet-length rows of the exact plane (L = 511, f32 values: ~1 M
    occurrences), indices outside [0, F) (no scatter: it takes none), and
    a NaN or an Inf α in one row (its columns poisoned as in the scatter)."""
    import numpy as np
    import torch

    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    idx8, val8 = int8_tokens[:2]
    b = GRAM_ROWS
    yield "int8 plane tokens (row mass 127)", idx8, val8, GRAM_F, {}
    yield "f32 plane (values x 0.37)", idx8, (val8 * 0.37).contiguous(), GRAM_F, {}
    hot = rng.choice(GRAM_F, 85, replace=False)
    synth = hot[rng.integers(0, 85, (b, 63))].astype(np.int32)
    ones = rng.integers(1, 3, (b, 63)).astype(np.float32)
    yield "skew: 85 hot columns, L = 63", to(synth), to(ones), GRAM_F, {}
    yield ("skew: every token in one column", to(np.full((b, 63), GRAM_F * 3 // 7, np.int32)),
           to(ones), GRAM_F, {})
    idx, val = gram_tokens(rng, b, 0, tokens=63)  # 40 terms a row, 23 padding slots in column 0
    yield "padding slots in column 0", to(idx), to(val), GRAM_F, {}
    f_local, lo = GRAM_F // 2, GRAM_F // 4
    rel = idx.astype(np.int64) - lo
    sliced = val * ((rel >= 0) & (rel < f_local))
    yield ("a model axis's slice (clamped into columns 0 and f_local - 1, value 0)",
           to(np.clip(rel, 0, f_local - 1).astype(np.int32)), to(sliced.astype(np.float32)),
           f_local, {})
    yield ("exact plane, tweet-length rows (L = 511, f32 values)",
           to(rng.integers(0, GRAM_F, (b, 511)).astype(np.int32)),
           to(rng.normal(size=(b, 511)).astype(np.float32)), GRAM_F, {})
    oor = idx.copy()
    oor[:, ::7], oor[:, 1::9] = GRAM_F + 3, -2
    yield "indices outside [0, F)", to(oor), to(val), GRAM_F, {"scatter": False}
    yield "a NaN alpha in row 3", to(idx), to(val), GRAM_F, {"poison": {3: float("nan")}}
    yield "an Inf alpha in row 5", to(idx), to(val), GRAM_F, {"poison": {5: float("inf")}}


def b8_hold(name, w, c, alpha, idx, val, num, f, scatter=True):
    """B8 (``dual_writeback_counts``) on one batch's tokens on the card: a
    rerun bitwise equal; the text columns bitwise its order on the host
    (``dual_writeback_in_order``; where α is finite); within WEIGHT_RTOL
    (atol WEIGHT_RTOL·max(1, max|w|)) of its plain version and, with
    ``scatter``, of the per-occurrence scatter write-back (``ops/gram.py``
    ``dual_writeback``); the NaN and Inf columns the plain version's.
    Returns (W_new, the worst abs error, a note)."""
    import torch

    from twtml_tpu_torch.ops import fused_gram
    from twtml_tpu_torch.ops.gram import dual_writeback

    got = fused_gram.dual_writeback_counts(w, c, alpha, idx, val, num, f)
    again = fused_gram.dual_writeback_counts(w, c, alpha, idx, val, num, f)
    order = fused_gram.dual_writeback_in_order(w, c, alpha, idx, val, num, f)
    wants = [("plain version", fused_gram.dual_writeback_reference(w, c, alpha, idx, val, num, f))]
    if scatter:
        text, numw = dual_writeback(w[:f], w[f:], c, alpha, idx, val, num)
        wants.append(("per-occurrence scatter", torch.cat([text, numw])))
    torch.cuda.synchronize()
    if not torch.equal(bits(got), bits(again)):
        raise AssertionError(f"{name}: reruns are not bitwise equal")
    finite = torch.isfinite(order[:f])
    if not torch.equal(bits(got[:f][finite]), bits(order[:f][finite])):
        diff = int((bits(got[:f][finite]) != bits(order[:f][finite])).sum())
        raise AssertionError(f"{name}: {diff} text columns differ bitwise from the kernel's "
                             "order on the host")
    worst = 0.0
    for what, want in wants:
        if not (torch.equal(torch.isnan(got), torch.isnan(want))
                and torch.equal(torch.isinf(got), torch.isinf(want))):
            raise AssertionError(f"{name}: its non-finite columns are not the {what}'s")
        ok = torch.isfinite(want)
        err = (got[ok] - want[ok]).abs()
        atol = WEIGHT_RTOL * max(1.0, want[ok].abs().max().item())
        if (err > atol + WEIGHT_RTOL * want[ok].abs()).any():
            raise AssertionError(f"{name}: the {what} differs by {err.max().item():.3e}")
        worst = max(worst, err.max().item())
    poisoned = int((~torch.isfinite(got)).sum())
    return got, worst, (f"max abs err {worst:.3e} against its plain version"
                        f"{' and the per-occurrence scatter' if scatter else ''} (tolerance rtol "
                        f"{WEIGHT_RTOL}, atol {WEIGHT_RTOL}*max(1, max|w|)); text columns "
                        "bitwise its order on the host; rerun bitwise"
                        + (f"; {poisoned} non-finite columns, the plain version's"
                           if poisoned else ""))


def gram_kernel_phase():
    """B4 and the G product, B7 and B8 on the card against their plain
    twins, each rerun bitwise equal. B4 + G: bitwise at a row mass of 127
    (the int8 plane: s8 counts, ``torch._int_mm``), 128 and 255 (f32 counts,
    an f32 matmul), fractional values within GRAM_EXACT_RTOL. B7: B = 1, 16,
    2047, 2048, 3072, 4095 and 4096 (G spilled to L2 past 2048), count 0,
    the logistic mode, ``-b 0.5`` masks, tolerance 0, 0.001 and the
    tolerances that stop the twin at iterations 2 and N - 1, each with the
    same iterations run and the grid barriers ``expected_barriers`` counts,
    NaN/Inf in masked rows bitwise ignored; within RTOL/ATOL; a CUDA graph
    of it replayed twice, bitwise the eager launch; at B % 4 != 0 on
    NaN-filled scratch, bitwise the launch on other scratch. B8 from the
    tokens in ``b8_cases`` (``b8_hold``), and in a CUDA graph replayed
    twice, bitwise the eager launch."""
    import numpy as np
    import torch

    from twtml_tpu_torch.models.sgd import sampling_masks
    from twtml_tpu_torch.ops import fused_gram, gram
    from twtml_tpu_torch.ops.fused_sgd import logistic_residual

    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    errs = {"count_build": 0.0, "dual_sgd": 0.0, "dual_writeback_counts": 0.0}
    cases = []
    counts_int8 = None
    for name, peak, fractional in (("row mass 127", 127, False), ("row mass 128", 128, False),
                                   ("row mass 255", 255, False), ("fractional", 0, True)):
        idx, val = gram_tokens(rng, GRAM_ROWS, peak, fractional)
        idx_t, val_t = to(idx), to(val)
        plane = gram.data_plane(val_t)
        int8 = plane == gram.PLANE_INT8
        c = fused_gram.count_build(idx_t, val_t, GRAM_F, int8=int8)
        again = fused_gram.count_build(idx_t, val_t, GRAM_F, int8=int8)
        ref = fused_gram.count_build_reference(idx_t, val_t, GRAM_F, int8=int8,
                                               rows_out=c.shape[0], cols_out=c.shape[1])
        g = fused_gram.gram_from_counts(c)[:GRAM_ROWS, :GRAM_ROWS]
        g_ref = gram.text_gram(idx_t, val_t, GRAM_F, plane=plane)
        torch.cuda.synchronize()
        if not torch.equal(c, again):
            raise AssertionError(f"count_build {name}: reruns are not bitwise equal")
        counts_bitwise = torch.equal(c, ref)
        if plane == gram.PLANE_EXACT:
            err = (c.float() - ref.float()).abs().max().item()
            if err > GRAM_EXACT_RTOL * ref.float().abs().max().item():
                raise AssertionError(f"count_build {name}: counts differ by {err:.3e}")
            g_err = ((g - g_ref).abs() / g_ref.abs().clamp(min=1e-30)).max().item()
            if not g_err <= GRAM_EXACT_RTOL:
                raise AssertionError(f"G {name}: relative error {g_err:.3e} > "
                                     f"{GRAM_EXACT_RTOL}")
            errs["count_build"] = max(errs["count_build"], err)
        else:
            if not counts_bitwise:
                raise AssertionError(f"count_build {name}: counts differ from the twin")
            if not torch.equal(g, g_ref):
                raise AssertionError(f"G {name} ({gram.PLANE_NAMES[plane]} plane): differs "
                                     f"from the exact product by "
                                     f"{(g - g_ref).abs().max().item():.3e}")
            g_err = 0.0
        if peak and float(g[0, 1]) != float(peak):
            raise AssertionError(f"G {name}: G[0, 1] = {float(g[0, 1])}, want {peak}")
        if int8 and counts_int8 is None:
            counts_int8 = (idx_t, val_t, c)
        phase("kernel", f"count_build + G {name}: B={GRAM_ROWS} F={GRAM_F} L={idx.shape[1]}, "
              f"{gram.PLANE_NAMES[plane]} plane ({c.dtype} counts {tuple(c.shape)}); counts "
              f"{'bitwise equal to' if counts_bitwise else 'within rtol 1e-6 of'} the twin, G "
              f"{'bitwise equal to' if g_err == 0 else f'within {g_err:.2e} of'} the exact "
              f"product; rerun bitwise equal")
        cases.append(f"count_build + G {name}")
        del c, again, ref, g, g_ref

    # ---- B7: the dual loop
    def dual_inputs(rows, n_valid, terms=40, cols=4096):
        z = np.zeros((rows, cols), np.float32)
        np.add.at(z, (np.arange(rows)[:, None], rng.integers(0, cols, size=(rows, terms))),
                  1.0)
        num = (rng.normal(size=(rows, 4)) * 0.1).astype(np.float32)
        zt, nt = to(z), to(num)
        g = zt @ zt.T + nt @ nt.T
        u = to((rng.normal(size=rows) * 10).astype(np.float32))
        y = to(rng.uniform(50, 900, size=rows).astype(np.float32))
        mask = to((rng.permutation(rows) < n_valid).astype(np.float32))
        return g, u, y, mask

    def expected_barriers(mask, kw, its):
        """B7's grid barriers: one an update, less the last update's when no
        test is pending (tolerance 0), plus one that carries the test that
        stopped the loop early; 0 when no iteration selects a row, None (not
        checked) when only some select none."""
        masks, n = kw.get("masks"), kw["num_iterations"]
        counts = (mask if masks is None else mask * masks).reshape(-1, mask.shape[0]).sum(1)
        if not (counts > 0).any():
            return 0
        if not (counts > 0).all():
            return None
        return min(its + 1, n) if kw["convergence_tol"] > 0 else n - 1

    def dual_case(name, g, u, y, mask, dirty=False, **kw):
        kw = dict(dict(num_iterations=OP_ITERS, step_size=0.005, l2_reg=0.1,
                       convergence_tol=0.001, p_prev=torch.tensor(3.0, device=dev)), **kw)
        c, a, its = fused_gram.dual_sgd(g, u, y, mask, **kw)
        barriers = fused_gram.dual_sgd.last_barriers
        c2, a2, its2 = fused_gram.dual_sgd(g, u, y, mask, **kw)
        c_r, a_r, its_r = fused_gram.dual_sgd_reference(g, u, y, mask, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(a, a2) and torch.equal(c, c2) and int(its) == int(its2)):
            raise AssertionError(f"dual_sgd {name}: reruns are not bitwise equal")
        if int(its) != int(its_r):
            raise AssertionError(f"dual_sgd {name}: {int(its)} iterations run, the twin "
                                 f"{int(its_r)}")
        want = expected_barriers(mask, kw, int(its))
        if want is not None and int(barriers) != want:
            raise AssertionError(f"dual_sgd {name}: {int(barriers)} grid barriers crossed "
                                 f"in {int(its)} iterations, want {want}")
        ea, ra = compare(f"dual_sgd {name} alpha", a, a_r)
        ec, _ = compare(f"dual_sgd {name} c", c.reshape(1), c_r.reshape(1))
        note = "rerun bitwise equal"
        if dirty:
            keep = mask > 0
            both = keep[:, None] & keep[None, :]
            b = mask.shape[0]
            g_d = g.clone()
            g_d[:b, :b] = torch.where(both, g[:b, :b], float("nan"))
            u_d = torch.where(keep, u, float("nan"))
            y_d = torch.where(keep, y, float("inf"))
            c_d, a_d, its_d = fused_gram.dual_sgd(g_d, u_d, y_d, mask, **kw)
            if not (torch.equal(a, a_d) and torch.equal(c, c_d) and int(its) == int(its_d)):
                raise AssertionError(f"dual_sgd {name}: NaN/Inf in masked rows reached "
                                     "the result")
            note += f"; NaN/Inf in {int((~keep).sum())} masked rows: bitwise equal"
        plan = fused_gram.dual_tenants_plan((mask.shape[0],), **sm_limits())
        where = ("G in registers" if plan.in_registers
                 else f"{plan.resident_rows} rows of G resident, {plan.spill_rows} spilled")
        phase("kernel", f"dual_sgd {name}: B={mask.shape[0]} grid {plan.grid}, {where}; "
              f"{int(its)} iterations run (twin {int(its_r)}), {int(barriers)} grid barriers "
              f"crossed; max abs err alpha {ea:.3e} (rel {ra:.3e}) c {ec:.3e}; {note}")
        errs["dual_sgd"] = max(errs["dual_sgd"], ea, ec)
        cases.append(f"dual_sgd {name}")
        return c, a, its

    def stopping_tol(k, g, u, y, mask):
        """A tolerance at which the twin stops at iteration k, and the ratio
        of the widest band of tolerances that do: the loop stops at the first
        iteration whose test ratio falls below the tolerance, so the
        iterations run fall as it grows; the band's geometric middle."""
        p_prev = torch.tensor(3.0, device=dev)

        def stops_by(tol, j):
            return int(fused_gram.dual_sgd_reference(
                g, u, y, mask, p_prev=p_prev, num_iterations=OP_ITERS, step_size=0.005,
                l2_reg=0.1, convergence_tol=tol)[2]) <= j

        def edge(j):  # the least tolerance (by log bisection) that stops it by iteration j
            lo, hi = 1e-7, 1.0
            for _ in range(30):
                mid = math.sqrt(lo * hi)
                lo, hi = (lo, mid) if stops_by(mid, j) else (mid, hi)
            return hi

        a, b = edge(k), edge(k - 1)
        if not a < b:
            raise AssertionError(f"dual_sgd: no tolerance stops the twin at iteration {k}")
        return math.sqrt(a * b), b / a

    dual_case("B=1", *dual_inputs(1, 1))
    dual_case("B=16", *dual_inputs(16, 12), dirty=True)
    g, u, y, m = dual_inputs(GRAM_ROWS, GRAM_ROWS - 100)
    dual_case("B=2048 tol 0.001", g, u, y, m, dirty=True)
    # labels near the margins: the loop freezes early at tolerance 0.001
    near = u + to((rng.normal(size=GRAM_ROWS) * 10).astype(np.float32))
    _, _, its = dual_case("B=2048 tol 0.001 (freezes)", g, u, near, m, dirty=True)
    if not 1 < int(its) < OP_ITERS:
        raise AssertionError(f"dual_sgd freeze case: {int(its)} iterations run")
    # the folded test's first and last crossings: stops at iteration 2 and N - 1
    for k in (2, OP_ITERS - 1):
        tol, band = stopping_tol(k, g, u, near, m)
        _, _, its = dual_case(f"B=2048 tol {tol:.6g} (stops at {k}; band x{band:.4f})", g, u,
                              near, m, convergence_tol=tol)
        if int(its) != k:
            raise AssertionError(f"dual_sgd stops at {int(its)}, not {k}")
    _, _, its = dual_case("B=2048 tol 0", g, u, y, m, convergence_tol=0.0)
    if int(its) != OP_ITERS:
        raise AssertionError(f"dual_sgd tol 0: {int(its)} iterations run")
    masks = sampling_masks(GRAM_ROWS, OP_ITERS, 0.5, torch.float32, dev)
    dual_case("B=2048 -b 0.5 masks", g, u, y, m, masks=masks, dirty=True)
    dual_case("B=2048 logistic", g, u, (y > 475).float(), m, step_size=0.1,
              residual_fn=logistic_residual, dirty=True)
    c0, a0, _ = dual_case("count=0", g, u, y, torch.zeros_like(m))
    if float(c0) != 1.0 or a0.any():
        raise AssertionError("dual_sgd count=0: c must stay 1 and alpha 0")
    # captured in a CUDA graph (as step_many captures it) and replayed twice:
    # each replay bitwise the eager launch, so no barrier state outlives one
    kw = dict(num_iterations=OP_ITERS, step_size=0.005, l2_reg=0.1, convergence_tol=0.001,
              p_prev=torch.tensor(3.0, device=dev))
    eager = fused_gram.dual_sgd(g, u, near, m, **kw) + (fused_gram.dual_sgd.last_barriers,)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_gram.dual_sgd(g, u, near, m, **kw) + (fused_gram.dual_sgd.last_barriers,)
    for replay in (1, 2):
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(x, e) for x, e in zip(captured, eager)):
            raise AssertionError(f"dual_sgd in a CUDA graph: replay {replay} differs from the "
                                 "eager launch")
    phase("kernel", f"dual_sgd CUDA graph: B={GRAM_ROWS}, tol 0.001, labels near the margins; "
          f"2 replays bitwise equal to the eager launch (c, alpha, {int(eager[2])} iterations, "
          f"{int(eager[3])} grid barriers)")
    cases.append("dual_sgd CUDA graph")
    del graph, captured, g
    dual_case("B=3072 (G spilled)", *dual_inputs(3072, 3000), dirty=True)
    dual_case("B=4096 (G spilled)", *dual_inputs(4096, 4000), dirty=True)

    def nan_scratch_case(name, rows, n_valid):
        """B % 4 != 0 on scratch that held NaN: G·α loads α's padding [B, bp)
        as whole float4s, and it must meet G's zero columns as 0."""
        g, u, y, m = dual_inputs(rows, n_valid)
        kw = dict(num_iterations=OP_ITERS, step_size=0.005, l2_reg=0.1, convergence_tol=0.001,
                  p_prev=torch.tensor(3.0, device=dev))
        c, a, its = dual_case(name, g, u, y, m, dirty=True)
        plan = fused_gram.dual_tenants_plan((rows,), **sm_limits())
        scratch_floats = plan.scratch_floats + 3  # then c, the iterations and the barriers
        # NaN in free blocks of the scratch's size, each kept from merging
        # with the next by a live one, so that the launch's scratch is one
        held = [torch.full((scratch_floats,), float("nan"), device=dev) for _ in range(64)]
        nan_ptrs = {t.data_ptr() for t in held[::2]}
        del held[::2]
        c_n, a_n, its_n = fused_gram.dual_sgd(g, u, y, m, **kw)
        base = fused_gram.dual_sgd.last_barriers.data_ptr() - 4 * (scratch_floats - 1)
        del held
        torch.cuda.synchronize()
        if base not in nan_ptrs:
            raise AssertionError(f"dual_sgd {name}: its scratch is not a NaN-filled block")
        if not (torch.equal(a, a_n) and torch.equal(c, c_n) and int(its) == int(its_n)):
            raise AssertionError(f"dual_sgd {name}: NaN left in its scratch reached the result")
        phase("kernel", f"dual_sgd {name} on NaN-filled scratch: {plan.bp_max - rows} padding "
              f"float(s) of alpha; bitwise equal to the launch on other scratch")
        cases.append(f"dual_sgd {name} on NaN-filled scratch")

    nan_scratch_case("B=2047 (G in registers)", 2047, 2000)
    nan_scratch_case("B=4095 (G spilled)", 4095, 4000)

    # ---- B8: the write-back from the batch's tokens, in both planes and in
    # every skew case (b8_cases)
    for name, idx_b, val_b, f_b, opts in b8_cases(rng, counts_int8):
        w = to((rng.normal(size=f_b + 4) * 1e-2).astype(np.float32))
        alpha = (rng.normal(size=idx_b.shape[0]) * 1e-3).astype(np.float32)
        for row, value in opts.get("poison", {}).items():
            alpha[row] = value
        alpha = to(alpha)
        num = to((rng.normal(size=(idx_b.shape[0], 4)) * 0.1).astype(np.float32))
        _, worst, note = b8_hold(f"dual_writeback_counts {name}", w, torch.tensor(0.97, device=dev),
                                 alpha, idx_b, val_b, num, f_b, scatter=opts.get("scatter", True))
        errs["dual_writeback_counts"] = max(errs["dual_writeback_counts"], worst)
        phase("kernel", f"dual_writeback_counts {name}: B={idx_b.shape[0]} L={idx_b.shape[1]} "
              f"F={f_b}; {note}")
        cases.append(f"dual_writeback_counts {name}")
    # captured in a CUDA graph (as step_many captures it) and replayed twice
    idx_b, val_b = counts_int8[:2]
    w = to((rng.normal(size=GRAM_F + 4) * 1e-2).astype(np.float32))
    alpha = to((rng.normal(size=GRAM_ROWS) * 1e-3).astype(np.float32))
    num = to((rng.normal(size=(GRAM_ROWS, 4)) * 0.1).astype(np.float32))
    c = torch.tensor(0.97, device=dev)
    eager = fused_gram.dual_writeback_counts(w, c, alpha, idx_b, val_b, num, GRAM_F)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused_gram.dual_writeback_counts(w, c, alpha, idx_b, val_b, num, GRAM_F)
    fused_gram.dual_writeback_counts.captured = 0
    for replay in (1, 2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(bits(captured), bits(eager)):
            raise AssertionError(f"dual_writeback_counts in a CUDA graph: replay {replay} "
                                 "differs from the eager launch")
    phase("kernel", f"dual_writeback_counts CUDA graph: B={GRAM_ROWS}; 2 replays bitwise equal "
          "to the eager launch (its scratch from the graph's pool)")
    cases.append("dual_writeback_counts CUDA graph")
    del graph, captured
    torch.cuda.synchronize()
    return errs, cases


# ---- phase 4/5/6: the main path on each wire --------------------------------

def app_run(argv, max_batches=0, app_module=None, **kw):
    """One run of an app (``app_module``, the flagship linear app when None)
    with ``argv``, publishing to the loopback recorder only; returns its
    totals and printed lines."""
    from twtml_tpu_torch.apps import linear_regression
    from twtml_tpu_torch.config import ConfArguments

    out = io.StringIO()
    conf = ConfArguments().parse(
        ["--lightning", RECORDER.url, "--twtweb", RECORDER.url, *argv])
    with contextlib.redirect_stdout(out):
        totals = (app_module or linear_regression).run(conf, max_batches=max_batches, **kw)
    return totals, out.getvalue().splitlines()


class ErrorLog(logging.Handler):
    """The port's ERROR records of a run: a batch whose dispatch raised (a
    sync under the sync-debug mode, a kernel that did not launch) is logged
    and skipped by the streaming context, never silently."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records: list = []

    def emit(self, record):
        self.records.append(record)


def recorded_app_run(argv, max_batches, source=None, blocking_copies=False,
                     sleep_before=None, expected_errors=(), expect_abort=False,
                     app_module=None, learner=None, **kw):
    """One app run with the kernels' launch counters (B1's, and B4's, B7's
    and B8's in ``rec["gram_launches"]``) and the native counters set to 0
    just before it and read just after, recording what the run's
    model returned: the warm-up's output, each batch's StepOutput (device
    tensors), the iterations each fused call ran (device scalars, no sync),
    the host fetches started (``fetch_output`` calls, the warm-up's
    excluded), the weights each ``set_initial_weights`` installed and the
    final weights. ``source`` replaces the configured source;
    ``blocking_copies`` makes every H2D copy synchronous; ``rec["planes"]``
    holds each ``step``'s Gram plane (``model.planes``); ``sleep_before``
    {step: cycles} queues ``torch.cuda._sleep`` on the model's stream ahead
    of that step (step 1 is the first batch after the warm-up), so that
    later batches dispatch while it is still in flight. A run that logged an
    error fails, unless the message starts with one of ``expected_errors``
    (a guard's own report of what it caught). With ``expect_abort`` the
    run must raise its guard abort: totals and lines are then None and []
    and ``rec["aborted"]`` holds the message. ``app_module`` and ``learner``
    (the flagship app and its linear learner when None) pick another SGD
    app; ``rec["raw"]`` holds each fused call's raw margins (device
    tensors); ``rec["groups"]`` the step_many calls; ``rec["captured"]``
    the CUDA graphs the model captured."""
    import torch

    from twtml_tpu_torch.apps import common
    from twtml_tpu_torch.apps import linear_regression as app
    from twtml_tpu_torch.features import native
    from twtml_tpu_torch.models import sgd as sgd_module
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.ops import fused_gram, fused_sgd

    rec = {"outputs": [], "iterations": [], "fetches": 0, "restored": [], "raw": [],
           "groups": 0, "planes": []}
    base_build, base_source = app.build_model, app.build_source
    base_cls = learner or StreamingLinearRegressionWithSGD

    class Recorded(base_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.non_blocking = not blocking_copies

        def step(self, batch):
            cycles = (sleep_before or {}).get(len(rec["outputs"]))
            if cycles:
                torch.cuda._sleep(cycles)
            out = super().step(batch)
            rec["outputs"].append(out)
            rec["planes"].append(self.planes(batch))
            rec["model"] = self
            return out

        def step_many(self, stacked):
            out = super().step_many(stacked)
            rec["groups"] += 1
            rec["outputs"].extend(
                type(out)(*(None if f is None else f[i] for f in out))
                for i in range(out.count.shape[0]))
            rec["model"] = self
            return out

        def fetch_output(self, out):
            rec["fetches"] += 1
            return StreamingLinearRegressionWithSGD.fetch_output(out)

        def set_initial_weights(self, weights):
            super().set_initial_weights(weights)
            rec["restored"].append(self._weights)
            return self

    def fused(*args, **kw):
        out = fused_sgd.fused_dense_sgd(*args, **kw)
        rec["iterations"].append(fused_sgd.fused_dense_sgd.last_iterations)
        rec["raw"].append(out[1])
        return out

    app.build_model = lambda conf, *_: common.build_model(conf, model_cls=Recorded)
    sgd_module.fused_dense_sgd = fused
    if source is not None:
        app.build_source = lambda conf, **_: source
    errors = ErrorLog()
    logging.getLogger("twtml_tpu_torch").addHandler(errors)
    try:
        fused_sgd.fused_dense_sgd.launches = 0
        for fn in fused_gram.KERNELS:
            fn.launches = 0
        native.reset_counters()
        t0 = time.perf_counter()
        try:
            totals, lines = app_run(argv, max_batches=max_batches, app_module=app_module,
                                    **kw)
        except RuntimeError as exc:
            if not expect_abort or "runtime guard" not in str(exc):
                raise
            totals, lines, rec["aborted"] = None, [], str(exc)
        else:
            if expect_abort:
                raise AssertionError("the run did not abort")
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = fused_sgd.fused_dense_sgd.launches
        rec["gram_launches"] = {fn.__name__: fn.launches for fn in fused_gram.KERNELS}
        rec["native"] = dict(native.COUNTERS)
        rec["parse"] = dict(native.PARSE_COUNTERS)
    finally:
        logging.getLogger("twtml_tpu_torch").removeHandler(errors)
        app.build_model, app.build_source = base_build, base_source
        sgd_module.fused_dense_sgd = fused_sgd.fused_dense_sgd
    unexpected = [r for r in errors.records
                  if not r.getMessage().startswith(tuple(expected_errors) or ("\0",))]
    if unexpected:
        raise AssertionError("the run logged errors: " + "; ".join(
            f"{r.getMessage()} {r.exc_text or ''}" for r in unexpected))
    # the first step is the pre-stream warm-up's all-padding batch
    rec["warmup"], rec["outputs"] = rec["outputs"][0], rec["outputs"][1:]
    rec["planes"] = rec["planes"][1:]  # each step's Gram plane (() off the Gram route)
    rec["iterations"] = rec["iterations"][1:]
    rec["raw"] = rec["raw"][1:]
    rec["fetches"] -= 1  # the warm-up's
    rec["weights"] = rec["model"].latest_weights
    rec["captured"] = len(rec["model"]._graphs)
    if float(rec["warmup"].count) != 0:
        raise AssertionError("the warm-up step trained rows")
    return totals, lines, rec


def check_counters(name, rec, batches, wire):
    """The kernel launched once a batch and once for the warm-up; on the
    ragged wire the native fill and pack built every batch (the fill also
    the batch featurized when a cap stopped the stream), never degraded."""
    if rec["launches"] != batches + 1:
        raise AssertionError(f"{name}: fused_dense_sgd launched {rec['launches']} times "
                             f"for {batches} batches and the warm-up")
    nat = rec["native"]
    if wire == "ragged":
        ok = (nat["packs_native"] == batches + 1 and nat["fills_native"] - batches - 1 in (0, 1)
              and nat["fills_degraded"] == nat["packs_degraded"] == 0)
    else:
        ok = not any(nat.values())
    if not ok:
        raise AssertionError(f"{name}: native counters {nat} for {batches} batches on {wire}")


MAIN_ARGV = ["--source", "synthetic", "--seconds", "0", "--batchBucket", str(OP_ROWS)]


def main_path_phase():
    import math

    from twtml_tpu_torch.ops import fused_sgd

    totals, lines, rec = recorded_app_run(["--backend", "cuda", *MAIN_ARGV], 4)
    launches = rec["launches"]
    for line, step in zip(lines, totals["steps"]):
        subs = ", ".join(f"{k} {v:.1f}" for k, v in step["featurize_substages_ms"].items())
        phase("main", f"{line} | {step['wire']} wire {step['wire_bytes']} B "
              f"(native fill {step['native_fill']}, pack {step['native_pack']}) | "
              f"featurize {step['featurize_ms']:.1f} ms ({subs}), "
              f"step {step['step_ms']:.2f} ms (CUDA events)")
    if totals["batches"] != 4 or totals["count"] != 4 * OP_ROWS:
        raise AssertionError(f"main path ran {totals['batches']} batches, "
                             f"{totals['count']} rows")
    check_counters("main", rec, 4, "ragged")
    if not all(st["wire"] == "ragged" and st["native_fill"] and st["native_pack"]
               for st in totals["steps"]):
        raise AssertionError("a main-path batch did not take the ragged native wire")
    phase("main", f"native counters: {rec['native']} (4 batches, the warm-up's "
          "all-padding batch, and a batch featurized as the cap stopped the stream)")
    steady = totals["steps"][1:]  # batch 1 pays first-use set-up
    host_ms = sum(st["featurize_ms"] for st in steady)
    dev_ms = sum(st["step_ms"] for st in steady)
    phase("main", f"app wall {rec['wall_s']:.3f} s for {totals['count']} tweets = "
          f"{totals['count'] / rec['wall_s']:.0f} tweets/s (synthetic source "
          f"generation, session set-up, the warm-up and the stats fetches included)")
    phase("main", f"batches 2-4: featurize {host_ms:.1f} ms + step {dev_ms:.2f} ms"
          f" for {len(steady) * OP_ROWS} tweets = "
          f"{len(steady) * OP_ROWS / (host_ms + dev_ms) * 1e3:.0f} tweets/s "
          f"featurized and trained (bench.py's window: source excluded)")
    per_call = fused_sgd.launches_per_call(OP_ITERS)
    phase("main", f"fused_dense_sgd launches: {launches} calls (4 batches and the "
          f"warm-up) = {launches * per_call} device kernel launches ({per_call} per call)")
    phase("main", "iterations run before the converged freeze, batches 1-4: "
          f"{[int(t.item()) for t in rec['iterations']]} of {OP_ITERS}")
    for i, step in enumerate(totals["steps"]):
        values = [step[k] for k in ("count", "mse", "real_stdev", "pred_stdev")]
        values += step["quality"]
        if len(step["quality"]) != 19 or not all(map(math.isfinite, values)):
            raise AssertionError(f"batch {i + 1}: non-finite stats or quality")

    # the same app on the CPU (the twin's path) over the same 4 batches:
    # batch 1 starts from zero weights, so its reported stats must be equal;
    # every unrounded stat agrees within the kernel's 1e-4
    from twtml_tpu_torch.utils.rounding import round_half_up

    cpu_totals, cpu_lines = app_run(["--backend", "cpu", *MAIN_ARGV], max_batches=4)
    if lines[0] != cpu_lines[0]:
        raise AssertionError(f"batch 1: cuda {lines[0]!r} != cpu {cpu_lines[0]!r}")
    for i, (g, c) in enumerate(zip(totals["steps"], cpu_totals["steps"])):
        for k in ("count", "mse", "real_stdev", "pred_stdev"):
            if abs(g[k] - c[k]) > RTOL * abs(c[k]) + ATOL:
                raise AssertionError(f"batch {i + 1} {k}: cuda {g[k]} cpu {c[k]}")
        if i == 0 and any(round_half_up(g[k]) != round_half_up(c[k])
                          for k in ("mse", "real_stdev", "pred_stdev")):
            raise AssertionError("batch 1 reported stats differ from the CPU run")
    phase("main", "stats of 4 batches equal the CPU twin's within rtol 1e-4; "
          "batch 1's reported line is identical")
    return launches, rec


def padded_phase(ragged_rec):
    """The same 4 batches on the card through ``--wire padded``: the design
    matrix is the same, so everything must be bitwise equal."""
    import numpy as np
    import torch

    totals, lines, rec = recorded_app_run(
        ["--backend", "cuda", "--wire", "padded", *MAIN_ARGV], 4)
    for line, step in zip(lines, totals["steps"]):
        subs = ", ".join(f"{k} {v:.1f}" for k, v in step["featurize_substages_ms"].items())
        phase("padded", f"{line} | {step['wire']} wire {step['wire_bytes']} B | "
              f"featurize {step['featurize_ms']:.1f} ms ({subs}), "
              f"step {step['step_ms']:.2f} ms (CUDA events)")
    steady = totals["steps"][1:]
    host_ms = sum(st["featurize_ms"] for st in steady)
    dev_ms = sum(st["step_ms"] for st in steady)
    phase("padded", f"batches 2-4: featurize {host_ms:.1f} ms + step {dev_ms:.2f} ms"
          f" for {len(steady) * OP_ROWS} tweets = "
          f"{len(steady) * OP_ROWS / (host_ms + dev_ms) * 1e3:.0f} tweets/s "
          f"featurized and trained (bench.py's window: source excluded)")
    if totals["batches"] != 4 or len(rec["outputs"]) != len(ragged_rec["outputs"]):
        raise AssertionError(f"padded: ran {totals['batches']} batches")
    check_counters("padded", rec, 4, "padded")
    for i, (a, b) in enumerate(zip(ragged_rec["outputs"], rec["outputs"])):
        for k in ("predictions", "quality", "count", "mse", "real_stdev", "pred_stdev"):
            if not torch.equal(getattr(a, k), getattr(b, k)):
                raise AssertionError(f"batch {i + 1}: {k} differs between the wires")
    if not np.array_equal(ragged_rec["weights"], rec["weights"]):
        raise AssertionError("final weights differ between the ragged and padded wires")
    phase("padded", "4 batches: weights, predictions, stats and quality bitwise "
          "equal to the ragged packed run; kernel launches 4 + the warm-up's, "
          "native counters 0")
    rec["totals"] = totals
    return rec


def replay_phase():
    argv = ["--source", "replay", "--replayFile",
            os.path.join(HERE, "tests", "data", "tweets.jsonl"), "--seconds", "0",
            "--batchBucket", "4"]
    runs = {
        (backend, wire): app_run(["--backend", backend, "--wire", wire, *argv])[1]
        for backend in ("cuda", "cpu") for wire in ("ragged", "padded")
    }
    for line in runs["cuda", "ragged"]:
        phase("replay", line)
    if len(runs["cuda", "ragged"]) != 3 or any(
            lines != runs["cuda", "ragged"] for lines in runs.values()):
        raise AssertionError(f"replay lines differ: {runs}")
    phase("replay", "3 batches, lines identical on cuda and cpu, ragged and padded")


# ---- phase 7: the streaming runtime at full width --------------------------

STREAM_BATCHES = 8
STREAM_ARGV = ["--backend", "cuda", "--source", "synthetic", "--seconds", "0",
               "--batchBucket", str(OP_ROWS), "--maxQueueRows", "-1"]


def prefilled_source(statuses):
    """A queue source holding ``statuses``, closed: the stream ends when
    they are batched, and no tweet is generated inside the timed window."""
    from twtml_tpu_torch.streaming.sources import QueueSource

    src = QueueSource()
    for st in statuses:
        src.push(st)
    src.close()
    return src


def check_posts(name, posts, lines):
    """The dashboard and Lightning posts of one run against its printed
    lines: 1 config, a stats post per line equal to it, a series post per
    line of at most SERIES_MAX_POINTS points, a Lightning session, its
    visualization and an append per line."""
    from twtml_tpu_torch.telemetry.session_stats import SERIES_MAX_POINTS

    api = [b for p, b in posts if p == "/api"]
    kinds = [b["jsonClass"] for b in api]
    stats = [b for b in api if b["jsonClass"] == "Stats"]
    series = [b for b in api if b["jsonClass"] == "Series"]
    lgn = [p for p, _ in posts if p != "/api"]
    printed = [
        f"count: {b['count']}  batch: {b['batch']}  mse: {float(b['mse'])}  "
        f"stdev (real, pred): ({b['realStddev']}, {b['predStddev']})" for b in stats
    ]
    if kinds.count("Config") != 1 or printed != lines:
        raise AssertionError(f"{name}: posts {kinds} / stats {printed} against lines {lines}")
    if len(series) != len(lines) or any(
            not 0 < len(b["real"]) == len(b["pred"]) <= SERIES_MAX_POINTS for b in series):
        raise AssertionError(f"{name}: {len(series)} series posts for {len(lines)} batches")
    want = ["/sessions/", "/sessions/s1/visualizations/"] + ["/visualizations/v1/data/"] * len(lines)
    if lgn != want:
        raise AssertionError(f"{name}: Lightning posts {lgn}")
    phase(name, f"posts: {kinds.count('Config')} config, {len(stats)} stats equal to the "
          f"printed lines, {len(series)} series of <= {SERIES_MAX_POINTS} points, "
          f"{kinds.count('Metrics')} metrics; Lightning: session, visualization, "
          f"{len(lgn) - 2} appends")


def device_timeline(prof):
    """(start us, end us, name) of every device event of a profile."""
    out = []
    for ev in prof.events():
        if getattr(ev, "device_type", None) is not None and ev.device_type.name == "CUDA":
            out.append((ev.time_range.start, ev.time_range.end, ev.name))
    return sorted(out)


def busy_us(events, lo):
    """The µs of the device's timeline from ``lo`` on that some event of
    ``events`` (sorted by start) covers."""
    busy, cursor = 0.0, lo
    for start, end, _ in events:
        start = max(start, cursor)
        if end > start:
            busy += end - start
            cursor = end
    return busy


def timeline_report(events):
    """Idle share of the device over batches 2-8 (from batch 2's H2D copy
    to the last event), the H2D copies in that window, from which memory,
    and how many overlap a kernel."""
    kernels = [e for e in events if KERNEL in e[2]]
    if len(kernels) != STREAM_BATCHES + 1:
        phase("stream", f"profiler: {len(kernels)} fused kernels recorded, want "
              f"{STREAM_BATCHES + 1}; timeline not measured")
        return None
    h2d_all = [e for e in events if "HtoD" in e[2]]
    h2d = [e for e in h2d_all if e[0] >= kernels[1][1]]  # after batch 1's kernel
    if not h2d:
        phase("stream", "profiler: no H2D copy recorded; timeline not measured")
        return None
    lo, hi = h2d[0][0], max(e[1] for e in events)
    busy = busy_us(events, lo)
    copies = [e for e in events if "Memcpy" in e[2] or "memcpy" in e[2].lower()]
    compute = [e for e in events if e not in copies]
    overlap = sum(any(c[0] < k[1] and k[0] < c[1] for k in compute) for c in h2d)
    pinned = sum("Pinned" in c[2] for c in h2d)
    idle = 1 - busy / (hi - lo)
    phase("stream", f"device over batches 2-8 (profiler): {(hi - lo) / 1e3:.3f} ms window, "
          f"{busy / 1e3:.3f} ms busy, {100 * idle:.1f}% idle; {len(h2d)} H2D copies "
          f"({pinned} from pinned memory: {sorted({c[2] for c in h2d})}), {overlap} "
          "overlapping a kernel (one stream: copies and kernels run in order)")
    return {"idle": idle, "h2d": len(h2d), "overlap": overlap}


def stream_phase():
    """The streaming runtime at full width: a pre-filled source, the fetch
    pipeline at depth 8 with every dispatch under the sync-debug mode, its
    posts, the same run at depth 1 with synchronous copies (bitwise), a
    profiled run, and the live synthetic source's own rate."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    t0 = time.perf_counter()
    statuses = list(SyntheticSource(total=STREAM_BATCHES * OP_ROWS, seed=5,
                                    base_ms=NOW_MS).produce())
    phase("stream", f"{len(statuses)} tweets generated in {time.perf_counter() - t0:.2f} s "
          "(before the runs, not timed in them)")
    RECORDER.take()
    os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        totals, lines, rec = recorded_app_run(STREAM_ARGV, 0, source=prefilled_source(statuses))
    finally:
        del os.environ[SYNC_DEBUG_ENV]
    posts = RECORDER.take()
    steps = totals["steps"]
    if (totals["batches"], totals["count"], len(steps), len(lines)) != (
            STREAM_BATCHES, STREAM_BATCHES * OP_ROWS, STREAM_BATCHES, STREAM_BATCHES):
        raise AssertionError(f"stream: {totals['batches']} batches, {totals['count']} rows, "
                             f"{len(steps)} records for {STREAM_BATCHES} batches fed")
    check_counters("stream", rec, STREAM_BATCHES, "ragged")
    phase("stream", f"{STREAM_BATCHES} batches of {OP_ROWS} trained, every dispatch under "
          "torch.cuda.set_sync_debug_mode('error'): no sync raised, no error logged; "
          f"kernel launches {rec['launches']} (batches + warm-up), native {rec['native']}")
    for i, (line, st) in enumerate(zip(lines, steps)):
        phase("stream", f"batch {i + 1}: {line} | featurize {st['featurize_ms']:.2f} ms, "
              f"dispatch {st['dispatch_ms']:.3f} ms, depth in flight at dispatch "
              f"{st['depth']}, fetch wait {st['fetch_wait_ms']:.3f} ms, step "
              f"{st['step_ms']:.3f} ms (CUDA events), publish {st['publish_ms']:.3f} ms")
    check_posts("stream", posts, lines)
    span = steps[-1]["delivered_s"] - steps[0]["delivered_s"]
    rate = (STREAM_BATCHES - 1) * OP_ROWS / span
    later = steps[1:]
    means = {k: statistics.mean(st[k] for st in later)
             for k in ("featurize_ms", "dispatch_ms", "fetch_wait_ms", "publish_ms")}
    phase("stream", f"batches 2-{STREAM_BATCHES}: {(STREAM_BATCHES - 1) * OP_ROWS} tweets "
          f"delivered in {span:.4f} s = {rate:.0f} tweets/s; whole stream "
          f"{totals['count']} tweets in stream_seconds {totals['stream_seconds']:.4f} s = "
          f"{totals['count'] / totals['stream_seconds']:.0f} tweets/s; means a batch: "
          + ", ".join(f"{k} {v:.3f}" for k, v in means.items()))

    totals1, lines1, rec1 = recorded_app_run(
        STREAM_ARGV, 0, source=prefilled_source(statuses), fetch_depth=1,
        blocking_copies=True)
    RECORDER.take()
    if lines1 != lines or max(st["depth"] for st in totals1["steps"]) != 0:
        raise AssertionError("stream: the depth-1 run's lines differ")
    for i, (a, b) in enumerate(zip(rec["outputs"], rec1["outputs"], strict=True)):
        for k in ("predictions", "quality", "count", "mse", "real_stdev", "pred_stdev"):
            if not torch.equal(getattr(a, k), getattr(b, k)):
                raise AssertionError(f"stream batch {i + 1}: {k} differs between depth 8 and 1")
    if not np.array_equal(rec["weights"], rec1["weights"]):
        raise AssertionError("stream: final weights differ between depth 8 and depth 1")
    phase("stream", f"depth 8 (non-blocking copies from pinned memory) bitwise equal to "
          f"depth 1 (synchronous copies) over {STREAM_BATCHES} batches: weights, "
          f"predictions, stats, quality; depth-1 stream {totals1['stream_seconds']:.4f} s")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        totals_p, _, rec_p = recorded_app_run(STREAM_ARGV, 0, source=prefilled_source(statuses))
        torch.cuda.synchronize()
    RECORDER.take()
    timeline = timeline_report(device_timeline(prof))
    phase("stream", f"profiled run: stream_seconds {totals_p['stream_seconds']:.4f} s "
          f"(profiler on), kernel launches {rec_p['launches']}")

    src = SyntheticSource(seed=6, base_ms=NOW_MS, total=OP_ROWS)
    got = []
    t0 = time.perf_counter()
    src.start(got.append)
    while not src.exhausted and time.perf_counter() - t0 < 60:
        time.sleep(0.005)
    live_s = time.perf_counter() - t0
    src.stop()
    if len(got) != OP_ROWS:
        raise AssertionError(f"live synthetic source gave {len(got)} tweets")
    phase("stream", f"live SyntheticSource alone: {OP_ROWS} tweets in {live_s:.3f} s = "
          f"{OP_ROWS / live_s:.0f} tweets/s (its producer thread, nothing else running)")
    return {"launches": rec["launches"], "rate": rate, "timeline": timeline,
            "statuses": statuses, "publish_ms": means["publish_ms"]}


# ---- phase 7b: the port's bench entry (twtml_tpu_torch/bench.py) -----------

BENCH_BATCHES = 8
BENCH_TWEETS = BENCH_BATCHES * OP_ROWS
BENCH_REPEATS = 3
BENCH_DEVICE = "cuda"
BENCH_TIMEOUT_S = 900  # --bench-only: each child's watchdog (the 600 s budget + set-up)


def bench_run(name, **kw):
    """One ``bench.measure`` at the phase's operating point (no budget), B1's
    launch counter set to 0 just before and read just after: it must have
    risen by the warm-up's steps and a step a batch of every pass. Returns
    (record, launches, the model it measured)."""
    from twtml_tpu_torch import bench
    from twtml_tpu_torch.ops import fused_sgd

    kept = {}
    real = bench.measure_pipeline

    def keep(model, *args, **kwargs):
        kept["model"] = model
        return real(model, *args, **kwargs)

    bench.measure_pipeline = keep
    fused_sgd.fused_dense_sgd.launches = 0
    try:
        rec = bench.measure(n_tweets=BENCH_TWEETS, batch_size=OP_ROWS, time_budget_s=None,
                            device=BENCH_DEVICE, **kw)
    finally:
        bench.measure_pipeline = real
    launches = fused_sgd.fused_dense_sgd.launches
    want = bench.WARMUP_BATCHES + rec["passes"] * BENCH_BATCHES
    if launches != want or rec["tenants"] != 1:
        raise AssertionError(f"bench {name}: B1 launched {launches} times for "
                             f"{rec['passes']} passes of {BENCH_BATCHES} batches and "
                             f"{bench.WARMUP_BATCHES} warm-up steps ({want})")
    if not (math.isfinite(rec["final_mse"]) and rec["final_mse"] > 0):
        raise AssertionError(f"bench {name}: final mse {rec['final_mse']}")
    phase("bench", f"{name}: best {rec['tweets_per_sec']:.1f} tweets/s, median "
          f"{rec['median_tweets_per_sec']:.1f}, {rec['passes']} passes of {BENCH_TWEETS} "
          f"tweets (best pass {rec['seconds']:.4f} s), final mse {rec['final_mse']!r}, "
          f"health {json.dumps(rec['health'])}; B1 launched {launches} = "
          f"{bench.WARMUP_BATCHES} + {rec['passes']} x {BENCH_BATCHES}")
    return rec, launches, kept["model"]


def bench_timeline(events, batches):
    """Over the profiled pass (from its first H2D copy, after the warm-up's
    last B1 kernel, to the last device event): the device's idle share and
    the kernels launched a step."""
    kernels = [e for e in events if KERNEL in e[2]]
    if len(kernels) < batches + 1:
        phase("bench", f"profiler: {len(kernels)} B1 kernels recorded; timeline not measured")
        return None
    h2d = [e for e in events if "HtoD" in e[2] and e[0] >= kernels[-batches - 1][1]]
    if not h2d:
        phase("bench", "profiler: no H2D copy recorded; timeline not measured")
        return None
    lo, hi = h2d[0][0], max(e[1] for e in events)
    window = [e for e in events if e[0] >= lo]
    busy = busy_us(window, lo)
    copies = [e for e in window if "memcpy" in e[2].lower() or "memset" in e[2].lower()]
    launched = len(window) - len(copies)
    out = {"idle": 1 - busy / (hi - lo), "window_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
           "launches_a_step": launched / batches, "copies_a_step": len(copies) / batches}
    phase("bench", f"profiled pass (profiler on): {out['window_ms']:.3f} ms window, "
          f"{out['busy_ms']:.3f} ms busy, {100 * out['idle']:.1f}% idle; "
          f"{out['launches_a_step']:.2f} kernels and {out['copies_a_step']:.2f} copies or "
          f"sets a step over {batches} steps")
    return out


def bench_phase():
    """The port's bench entry on the card (``bench.measure``) at 8 batches of
    16384, 3 passes and no budget, with prefetch on and off, then at 1 pass,
    then one profiled pass: B1 launched for every step of each run; the final
    mse and weights bitwise equal across prefetch on and off (a host buffer
    overwritten under a pending copy would part them) and the final mse
    across 1 and 3 passes (``reset()`` before each)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    on, launches, m_on = bench_run("prefetch on", repeats=BENCH_REPEATS, prefetch=True)
    w_on = m_on.latest_weights
    off, _, m_off = bench_run("prefetch off", repeats=BENCH_REPEATS, prefetch=False)
    w_off = m_off.latest_weights
    if on["final_mse"] != off["final_mse"] or w_on.tobytes() != w_off.tobytes():
        raise AssertionError(f"bench: prefetch on (mse {on['final_mse']!r}) and off (mse "
                             f"{off['final_mse']!r}) differ, weights max |diff| "
                             f"{float(abs(w_on - w_off).max())}")
    one, _, _ = bench_run("1 pass", repeats=1, prefetch=True)
    if one["final_mse"] != on["final_mse"]:
        raise AssertionError(f"bench: 1 pass ends at mse {one['final_mse']!r}, "
                             f"{BENCH_REPEATS} at {on['final_mse']!r}")
    phase("bench", f"final mse and weights bitwise equal with prefetch on and off; the final "
          f"mse bitwise equal after 1 and {BENCH_REPEATS} passes (reset before each)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bench_run("profiled", repeats=1, prefetch=True)
        torch.cuda.synchronize()
    timeline = bench_timeline(device_timeline(prof), BENCH_BATCHES)
    phase("bench", f"phase wall {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "prefetch_on": on, "prefetch_off": off,
            "timeline": timeline}


def bench_only(smi):
    """``--bench-only``: the entry's ``main()`` at its defaults (524288 tweets,
    b16384, a 600 s budget, then the CPU child), as a user runs it, in a
    process of its own; prints its JSON line and the end of its log."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory(prefix="twtml-bench-") as tmp:
        env = dict(os.environ, TWTML_RUN_ID_FILE=os.path.join(tmp, "run-id"),
                   TWTML_BENCH_TIMEOUT=str(BENCH_TIMEOUT_S))
        env.pop("TWTML_BENCH_CHILD", None)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "twtml_tpu_torch.bench"],
                              cwd=PACKAGE_ROOT, env=env, capture_output=True, text=True,
                              timeout=BENCH_TIMEOUT_S + 200)
    wall = time.perf_counter() - t0
    for line in proc.stderr.strip().splitlines()[-20:]:
        phase("bench", f"entry log: {line}")
    if proc.returncode != 0:
        raise SystemExit(f"chip_smoke: python -m twtml_tpu_torch.bench exited "
                         f"{proc.returncode} after {wall:.1f} s")
    line = proc.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    if not (rec["metric"] == "tweets_per_sec_e2e" and rec["value"] > 0
            and rec["device"] == torch.cuda.get_device_name(0)):
        raise AssertionError(f"bench entry: {line}")
    phase("bench", f"python -m twtml_tpu_torch.bench: {wall:.1f} s on {smi}")
    print(line, flush=True)
    return rec


# ---- phase 8: the runtime guards at full width -----------------------------

GUARD_BATCHES = 8
GUARD_ARGV = ["--backend", "cuda", "--source", "synthetic", "--seconds", "0",
              "--batchBucket", str(OP_ROWS), "--maxQueueRows", "-1"]
GUARD_COUNTERS = ("model.rollbacks", "model.nonfinite_batches", "model.rows_lost",
                  "model.sentinel_aborts", "journal.replayed_rows", "fetch.aborts",
                  "checkpoint.quarantined")
# what a guard reports at ERROR or above about the fault it caught
GUARD_ERRORS = ("divergence sentinel", "run aborting", "post-mortem bundle written")
# ~0.3 s of device work queued ahead of a step, so the next batch dispatches
# while it is still in flight
INFLIGHT_SLEEP_CYCLES = 500_000_000
# the card's nvidia-smi name and power limit, on every [guards] line
GUARD_CARD = ""


def guard_line(msg: str) -> None:
    phase("guards", f"{msg} | card: {GUARD_CARD}")


class Timings:
    """Wall ms of each call of the named methods while the context is
    open (``{label: (owner, attribute)}``), for the guards' costs."""

    def __init__(self, targets):
        self.targets = targets
        self.ms = {label: [] for label in targets}

    def __enter__(self):
        self._saved = {}
        for label, (owner, attr) in self.targets.items():
            base = getattr(owner, attr)
            self._saved[label] = base

            def timed_call(*a, _base=base, _label=label, **k):
                t0 = time.perf_counter()
                try:
                    return _base(*a, **k)
                finally:
                    self.ms[_label].append((time.perf_counter() - t0) * 1e3)

            setattr(owner, attr, timed_call)
        return self

    def __exit__(self, *exc):
        for label, (owner, attr) in self.targets.items():
            setattr(owner, attr, self._saved[label])
        return False

    def mean(self, label):
        v = self.ms[label]
        return f"{statistics.mean(v):.3f} ms (n={len(v)}, max {max(v):.3f})" if v else "no call"


def guard_run(name, statuses, extra, max_batches=0, **kw):
    """One app run of the guards phase from a pre-filled source of
    ``statuses``: the registry's guard counters as deltas over the run,
    every dispatch under the sync-debug mode "error"."""
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV
    from twtml_tpu_torch.telemetry import metrics

    reg = metrics.get_registry()
    before = {k: reg.counter(k).snapshot() for k in GUARD_COUNTERS}
    os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        totals, lines, rec = recorded_app_run(
            GUARD_ARGV + extra, max_batches, source=prefilled_source(statuses),
            expected_errors=GUARD_ERRORS, **kw)
    finally:
        del os.environ[SYNC_DEBUG_ENV]
    rec["counters"] = {k: int(reg.counter(k).snapshot() - before[k]) for k in GUARD_COUNTERS}
    guard_line(f"{name}: " + ("aborted: " + rec["aborted"] if totals is None else
                                    f"{totals['batches']} batches, {totals['count']} rows")
          + f"; kernel launches {rec['launches']}, fetches {rec['fetches']}, counters "
          + json.dumps(rec["counters"]))
    return totals, lines, rec


def expect(name, got: dict, want: dict):
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if bad:
        raise AssertionError(f"guards {name}: (got, want) {bad}")


def archive(directory, step=None):
    """(weights, meta) of the directory's newest verified archive, or of
    ``step``'s."""
    from twtml_tpu_torch.checkpoint import Checkpointer

    restored = Checkpointer(directory).restore(step=step)
    if restored is None:
        raise AssertionError(f"no verified archive (step {step}) in {directory}")
    return restored


def write_replay(path, statuses):
    """The tweets as the JSON lines ``ReplayFileSource`` reads back into
    the same Status objects."""
    def obj(s):
        d = {"text": s.text, "retweet_count": s.retweet_count,
             "user": {"followers_count": s.followers_count,
                      "favourites_count": s.favourites_count,
                      "friends_count": s.friends_count},
             "timestamp_ms": str(s.created_at_ms), "lang": s.lang, "id": s.id}
        if s.retweeted_status is not None:
            d["retweeted_status"] = obj(s.retweeted_status)
        return d

    with open(path, "w") as fh:
        for s in statuses:
            fh.write(json.dumps(obj(s)) + "\n")


def recycle_run(replay, ckdir, recycle: bool):
    """The app as a user starts it, in a subprocess on the card; returns
    its stderr and printed lines."""
    env = dict(os.environ, TWTML_RECYCLE_MAX="1", TWTML_RECYCLE_SAMPLE_EVERY="1")
    env.pop("TWTML_RECYCLES", None)
    argv = [sys.executable, "-m", "twtml_tpu_torch.apps.linear_regression",
            "--backend", "cuda", "--source", "replay", "--replayFile", replay,
            "--seconds", "0", "--batchBucket", str(OP_ROWS), "--checkpointDir", ckdir,
            "--checkpointEvery", "2",
            "--lightning", RECORDER.url, "--twtweb", RECORDER.url]
    if recycle:
        argv += ["--recycleAfterMb", "1"]
    proc = subprocess.run(argv, cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"recycle run (recycle={recycle}) exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stderr, [ln for ln in proc.stdout.splitlines() if ln.startswith("count:")]


def step_work(events):
    """Device work between the end of batch 1's fused kernel and the end of
    the last batch's (the warm-up's and batch 1's work, where the profiler
    may drop a session's first events, and the reads after the run fall
    outside): batches 2-8's H2D copies and the step ops before their fused
    kernel, batches 1-7's ops after it and their D2H fetch, so 7 steps'
    worth of every kind."""
    fused = [e for e in events if KERNEL in e[2]]
    if len(fused) != GUARD_BATCHES + 1:
        raise AssertionError(f"guards cost: profiler recorded {len(fused)} fused kernels, "
                             f"want {GUARD_BATCHES + 1}")
    lo, hi = fused[1][1], fused[-1][1]
    inside = [e for e in events if lo <= e[0] and e[1] <= hi]
    return {
        "kernels": sum("Memcpy" not in e[2] and "Memset" not in e[2] for e in inside),
        "fused": sum(KERNEL in e[2] for e in inside),
        "h2d": sum("HtoD (Pinned -> Device)" in e[2] for e in inside),
        "d2h": sum("DtoH (Device -> Pinned)" in e[2] for e in inside),
        "other_copies": sum(("Memcpy" in e[2] and "Pinned" not in e[2]) for e in inside),
    }


def guards_phase(smi):
    """The runtime guards at full width (B = 16384, 1004 dims, 50
    iterations, ragged, depth 8), from a pre-filled source: a poisoned run
    against a clean one at --checkpointEvery 1 and 4 (with batches in
    flight at the rollback), no checkpoint, resume, a rollback storm, a
    recycle in a subprocess, and the guards' cost."""
    global GUARD_CARD
    import re
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from twtml_tpu_torch.apps.common import AppCheckpoint
    from twtml_tpu_torch.checkpoint import Checkpointer
    from twtml_tpu_torch.streaming.journal import IntakeJournal
    from twtml_tpu_torch.streaming.sources import SyntheticSource
    from twtml_tpu_torch.telemetry import historian
    from twtml_tpu_torch.telemetry.blackbox import FlightRecorder

    GUARD_CARD = smi
    statuses = list(SyntheticSource(total=GUARD_BATCHES * OP_ROWS, seed=7,
                                    base_ms=NOW_MS).produce())
    tmp = tempfile.mkdtemp(prefix="twtml-guards-")
    full = {"batches": GUARD_BATCHES, "count": GUARD_BATCHES * OP_ROWS}
    timings = Timings({"save": (AppCheckpoint, "_save"),
                       "npz": (Checkpointer, "save"),
                       "append": (IntakeJournal, "append"),
                       "rollback": (AppCheckpoint, "rollback_to_verified"),
                       "dump": (FlightRecorder, "dump"),
                       "sample": (historian.Historian, "sample")})
    RECORDER.take()
    with timings:
        # -- poison at batch 5, a checkpoint every batch: crash equals clean
        clean1, clean1_lines, clean1_rec = guard_run(
            "clean, --checkpointEvery 1", statuses,
            ["--checkpointDir", f"{tmp}/clean1", "--checkpointEvery", "1"])
        saves_clean = list(timings.ms["save"])
        # the historian (on at the JAX defaults with --checkpointDir) against
        # --history off: the same lines and bitwise-equal weights
        samples_clean = list(timings.ms["sample"])
        _, off_lines, off_rec = guard_run(
            "clean, --checkpointEvery 1, --history off", statuses,
            ["--checkpointDir", f"{tmp}/clean1off", "--checkpointEvery", "1",
             "--history", "off"])
        hist = f"{tmp}/clean1/history"
        records = historian.read_series(hist)
        seg_bytes = sum(os.path.getsize(os.path.join(hist, n)) for n in os.listdir(hist)
                        if n.endswith(".twh"))
        n_samples = sum(r["k"] == "s" for r in records)
        if not (off_lines == clean1_lines and np.array_equal(off_rec["weights"],
                                                             clean1_rec["weights"])
                and n_samples >= 1 and samples_clean
                and not os.path.exists(f"{tmp}/clean1off/history")):
            raise AssertionError(f"guards history: on/off differ, or {n_samples} samples "
                                 f"in {hist}")
        guard_line(f"historian (--history auto, on with --checkpointDir): {n_samples} "
                   f"samples and {len(records) - n_samples} other records in "
                   f"{seg_bytes} segment bytes over {GUARD_BATCHES} batches = "
                   f"{seg_bytes / GUARD_BATCHES:.1f} B a batch; sample() "
                   f"{statistics.mean(samples_clean):.3f} ms (n={len(samples_clean)}, "
                   f"max {max(samples_clean):.3f}); --history off: the same lines, final "
                   "weights bitwise equal, no history directory")
        got, lines, rec = guard_run(
            "poison source.nan@5, --checkpointEvery 1", statuses,
            ["--checkpointDir", f"{tmp}/poison1", "--checkpointEvery", "1",
             "--chaos", "source.nan@5"])
        expect("poison@5", {**rec["counters"], "batches": got["batches"],
                            "count": got["count"], "fetches": rec["fetches"]},
               {"model.rollbacks": 1, "model.nonfinite_batches": 1, "model.rows_lost": 0,
                "journal.replayed_rows": OP_ROWS, "fetch.aborts": 0,
                "checkpoint.quarantined": 0, "fetches": GUARD_BATCHES + 1, **full})
        if lines != clean1_lines:
            raise AssertionError("guards poison@5: printed lines differ from the clean run's")
        w_p, meta_p = archive(f"{tmp}/poison1")
        w_c, meta_c = archive(f"{tmp}/clean1")
        if not (np.array_equal(w_p, w_c) and meta_p["count"] == meta_c["count"]):
            raise AssertionError("guards poison@5: final archive differs from the clean run's")
        guard_line(f"poison@5: 1 rollback, 1 non-finite batch, 0 rows lost, "
              f"{OP_ROWS} rows replayed, {rec['fetches']} fetches for "
              f"{len(rec['outputs'])} dispatches; lines equal the clean run's; the final "
              f"archive (step {meta_p['step']}) bitwise equal to the clean run's")
        drain_ms = statistics.mean(st["fetch_wait_ms"] for st in clean1["steps"][1:])
        guard_line(f"checkpoint every batch, clean run: save (.cpu() + npz + "
              f"rename) {statistics.mean(saves_clean):.3f} ms a batch (n={len(saves_clean)}), "
              f"of which npz + rename {timings.mean('npz')}; the drain before it "
              f"(fetch wait a batch) {drain_ms:.3f} ms; journal append of "
              f"{OP_ROWS} rows {timings.mean('append')}; rollback (restore + H2D) "
              f"{timings.mean('rollback')}")

        # -- poison at batch 7 with batches in flight, a checkpoint every 4
        sleep = {7: INFLIGHT_SLEEP_CYCLES}
        clean4, clean4_lines, _ = guard_run(
            "clean, --checkpointEvery 4", statuses,
            ["--checkpointDir", f"{tmp}/clean4", "--checkpointEvery", "4"],
            sleep_before=sleep)
        got, lines, rec = guard_run(
            "poison source.nan@7, --checkpointEvery 4, batch 7 delayed", statuses,
            ["--checkpointDir", f"{tmp}/poison4", "--checkpointEvery", "4",
             "--chaos", "source.nan@7"], sleep_before=sleep)
        tainted = rec["counters"]["model.nonfinite_batches"] - 1
        if tainted < 1:
            raise AssertionError("guards poison@7: no batch was in flight at the rollback")
        # dispatched: batches 1-7, the tainted ones after 7, the 4 replayed
        expect("poison@7", {**rec["counters"], "batches": got["batches"],
                            "count": got["count"], "fetches": rec["fetches"],
                            "dispatches": len(rec["outputs"])},
               {"model.rollbacks": 1, "model.rows_lost": 0,
                "journal.replayed_rows": 4 * OP_ROWS, "fetch.aborts": 0,
                "fetches": 7 + tainted + 4, "dispatches": 7 + tainted + 4, **full})
        w_p, _ = archive(f"{tmp}/poison4")
        w_c, _ = archive(f"{tmp}/clean4")
        # batches 5 and 6 trained and printed before the rollback to step 4,
        # and print again (the same counts) as the replay retrains them
        if lines != clean4_lines[:6] + clean4_lines[4:] or not np.array_equal(w_p, w_c):
            raise AssertionError("guards poison@7: lines or final archive differ from the "
                                 "clean run's")
        guard_line(f"poison@7: {tainted} batch(es) in flight at the rollback drained "
              f"as tainted skips; 1 rollback, 0 rows lost, {4 * OP_ROWS} rows of batches "
              f"5-8 replayed, {rec['fetches']} fetches for {len(rec['outputs'])} "
              "dispatches; no sync raised under set_sync_debug_mode('error'); the "
              "lines of batches 1-6 then, replayed, 5-8 equal the clean run's, and the "
              "final archive is bitwise equal to it")

        # -- poison without a checkpoint: back to zeros, rows counted lost
        got, lines, rec = guard_run("poison source.nan@5, no checkpoint", statuses,
                                    ["--chaos", "source.nan@5"])
        lost = rec["counters"]["model.rows_lost"]
        last = got["steps"][-1]
        if not (rec["counters"]["model.rollbacks"] == 1 and lost >= OP_ROWS
                and lost % OP_ROWS == 0 and got["count"] == full["count"] - lost
                and len(rec["restored"]) == 1 and not rec["restored"][0].any()
                and all(math.isfinite(last[k]) for k in ("mse", "real_stdev", "pred_stdev"))):
            raise AssertionError(f"guards no-checkpoint: {rec['counters']}, {got['count']} rows")
        guard_line(f"no checkpoint: weights reset to zeros, {lost} rows lost "
              f"({lost // OP_ROWS} batch(es): the poisoned one"
              f"{' and tainted in-flight ones' if lost > OP_ROWS else ''}), "
              f"{got['batches']} batches trained after it, last stats finite")

        # -- resume: 4 batches, then a new run from the same directory
        _, lines_a, _ = guard_run("resume, first run", statuses,
                                  ["--checkpointDir", f"{tmp}/resume",
                                   "--checkpointEvery", "1"], max_batches=4)
        w_saved, _ = archive(f"{tmp}/resume")
        got, lines_b, rec = guard_run("resume, second run", statuses,
                                      ["--checkpointDir", f"{tmp}/resume",
                                       "--checkpointEvery", "1"], max_batches=8)
        restored = rec["restored"][0].cpu().numpy()
        w_final, _ = archive(f"{tmp}/resume")
        if not (np.array_equal(restored, w_saved) and lines_a + lines_b == clean1_lines
                and np.array_equal(w_final, archive(f"{tmp}/clean1")[0])):
            raise AssertionError("guards resume: not equal to one 8-batch run")
        guard_line("resume: restored weights bitwise equal to the archive; 4 + 4 "
              "batches' lines and final weights equal one 8-batch run's")

        # -- a rollback storm aborts the run, leaving a bundle
        got, _, rec = guard_run(
            "storm source.nan@2, --sentinelRollbacks 2", statuses,
            ["--checkpointDir", f"{tmp}/storm/ck", "--checkpointEvery", "1",
             "--chaos", "source.nan@2", "--sentinelRollbacks", "2",
             "--sentinelWindow", "100"], expect_abort=True)
        expect("storm", rec["counters"], {"model.rollbacks": 2, "model.sentinel_aborts": 1})
        w_s, meta_s = archive(f"{tmp}/storm/ck")
        bundle_path = os.path.join(f"{tmp}/storm", f"postmortem.p0.{os.getpid()}.json")
        with open(bundle_path) as fh:
            bundle = json.load(fh)
        note = bundle["notes"].get("last_checkpoint", {})
        if not (np.isfinite(w_s).all() and note.get("step") == meta_s["step"]
                and any(e["kind"] == "sentinel_abort" for e in bundle["events"])):
            raise AssertionError(f"guards storm: archive step {meta_s['step']}, bundle "
                                 f"notes {bundle['notes']}")
        guard_line(f"storm: aborted through request_abort after 2 rollbacks; the "
              f"newest archive (step {meta_s['step']}) is finite; bundle "
              f"{os.path.basename(bundle_path)} names it ({len(bundle['events'])} events); "
              f"dump {timings.mean('dump')}")
    RECORDER.take()

    # -- recycle: a subprocess re-execs itself after a checkpoint
    replay = f"{tmp}/recycle.jsonl"
    write_replay(replay, statuses[: 4 * OP_ROWS])
    err_r, lines_r = recycle_run(replay, f"{tmp}/recycled", True)
    _, lines_u = recycle_run(replay, f"{tmp}/unrecycled", False)
    saved = re.findall(r"state crc ([0-9a-f]+)\) and re-exec'ing", err_r)
    resumed = re.findall(r"resumed from checkpoint step \d+ \(count=\d+, state crc "
                         r"([0-9a-f]+)\)", err_r)
    w_r, meta_r = archive(f"{tmp}/recycled")
    w_u, meta_u = archive(f"{tmp}/unrecycled")
    if not (len(saved) == 1 and resumed == saved and meta_r["count"] == meta_u["count"]
            == 4 * OP_ROWS and np.array_equal(w_r, w_u)
            and lines_r[-1] == lines_u[-1]):
        raise AssertionError(f"guards recycle: crc {saved} / {resumed}, counts "
                             f"{meta_r['count']} / {meta_u['count']}")
    guard_line(f"recycle (subprocess on the card, --recycleAfterMb 1): state crc "
          f"{saved[0]} at the re-exec and at the restore; {meta_r['count']} rows, final "
          "weights bitwise equal to an unrecycled run's")
    RECORDER.take()

    # -- the guards' cost on the healthy path
    off = ["--sentinel", "off", "--modelWatch", "off", "--freshness", "off",
           "--blackbox", "off"]
    rates = {}
    for label, extra in (("guards on", []), ("guards off", off),
                         ("guards on (again)", []), ("guards off (again)", off)):
        got, _, _ = guard_run(label, statuses, extra)
        span = got["steps"][-1]["delivered_s"] - got["steps"][0]["delivered_s"]
        rates.setdefault(label.split(" (")[0], []).append(
            (GUARD_BATCHES - 1) * OP_ROWS / span)
        posts = RECORDER.take()
        kinds = [b.get("jsonClass") for p, b in posts if p == "/api"]
        if label.startswith("guards on") and not (kinds.count("ModelHealth") >= 1
                                                  and kinds.count("Freshness") >= 1):
            raise AssertionError(f"guards cost: posts {sorted(set(kinds))}")
        # (the model watcher's view outlives a run in its process, as in the
        # JAX package; the freshness plane is rebuilt or turned off each run)
        if label.startswith("guards off") and "Freshness" in kinds:
            raise AssertionError("guards cost: the guards-off run posted a freshness view")
    # device work, profiled: the host guards off keep the step as it is;
    # --modelWatch off also drops the in-step quality vector (its launches)
    host_off = ["--sentinel", "off", "--freshness", "off", "--blackbox", "off"]
    copies = {}
    for label, extra in (("guards on", []), ("host guards off", host_off),
                         ("all off", off),
                         ("history on", ["--checkpointDir", f"{tmp}/prof_on"]),
                         ("history off", ["--checkpointDir", f"{tmp}/prof_off",
                                          "--history", "off"])):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            guard_run(f"{label}, profiled", statuses, extra)
            torch.cuda.synchronize()
        RECORDER.take()
        copies[label] = step_work(device_timeline(prof))
    on = copies["guards on"]
    if not (on == copies["host guards off"] and on["h2d"] == on["d2h"] == GUARD_BATCHES - 1
            and on["fused"] == GUARD_BATCHES - 1
            and all(copies["all off"][k] == on[k] for k in ("fused", "h2d", "d2h"))):
        raise AssertionError(f"guards cost: device work {copies}")
    if copies["history on"] != copies["history off"]:
        raise AssertionError(f"guards history: device work on {copies['history on']} "
                             f"against off {copies['history off']}")
    per = lambda c: c["kernels"] / (GUARD_BATCHES - 1)  # noqa: E731
    guard_line(f"device work over {GUARD_BATCHES - 1} steps (profiler, from batch 1's fused "
               f"kernel to batch {GUARD_BATCHES}'s): guards on {on}, sentinel/freshness/"
               f"blackbox off {copies['host guards off']}, all off {copies['all off']}: 1 H2D "
               f"(pinned) and 1 D2H (to pinned) copy a step either way, {per(on):g} launches "
               f"a step with the guards on as with the host guards off; --modelWatch off "
               f"drops the step's quality vector: {per(copies['all off']):g} launches a step")
    guard_line(f"historian on (--checkpointDir, --history auto) against --history off, "
               f"profiled: {copies['history on']} / {copies['history off']}: the same D2H "
               f"copies ({copies['history on']['d2h'] / (GUARD_BATCHES - 1):g}) and launches "
               f"({per(copies['history on']):g}) a step")
    guard_line("tweets/s over batches 2-8, guards on: "
          + ", ".join(f"{r:.0f}" for r in rates["guards on"]) + "; off: "
          + ", ".join(f"{r:.0f}" for r in rates["guards off"]))
    return {"rates": rates, "copies": copies}


# ---- phases 9 and 10: Bernoulli mini-batches and --dtype at full width ---------

SAMPLED_ARGV = ["--source", "synthetic", "--seconds", "0", "--batchBucket", str(OP_ROWS)]
SAMPLED_BATCHES = 4
# the CPU tests' tolerances (tests/test_torch_sampling.py): float32 weights
# within 1e-4 of the largest, stats within 1e-4; bfloat16 here within 2**-5
# (4 units of its 8-bit mantissa: each of the 200 updates rounds, and the
# card's and the CPU's matrix products sum in other orders)
SAMPLED_RTOL = 1e-4
BF16_CARD_RTOL = 2.0**-5


# ~50 ms of device sleep: long enough for the host to enqueue a whole step
# of the torch loop (~1,500 launches) before the device starts it
STEP_AHEAD_CYCLES = 100_000_000


def device_costs(fn, runs):
    """What the card spends on ``fn`` a run: (CUDA-event ms with the whole
    run queued ahead, so the device's time and not the host's enqueue; the
    profiler's summed device time of its kernels and copies; kernel
    launches from the profiler's host-side cudaLaunch* calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # first use outside the windows
    torch.cuda.synchronize()
    event_ms, _ = timed(fn, runs, queue_ahead=True, ahead_cycles=STEP_AHEAD_CYCLES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    busy = sum(ev.device_time_total for ev in prof.key_averages()
               if ev.device_time_total) / runs / 1e3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    n = sum(ev.count for ev in prof.key_averages() if ev.key.startswith("cudaLaunch")) / runs
    return event_ms, busy, n


def route_run(name, extra, statuses):
    """``SAMPLED_BATCHES`` full-width batches of ``statuses`` (a pre-filled
    source, so no producer thread competes with the dispatch for the
    interpreter lock) on the card with ``extra`` under the sync-debug mode
    "error", and the same on ``--backend cpu``: (totals, lines, record) of
    each."""
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV

    os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        totals, lines, rec = recorded_app_run(
            ["--backend", "cuda", *SAMPLED_ARGV, *extra], SAMPLED_BATCHES,
            source=prefilled_source(statuses))
    finally:
        del os.environ[SYNC_DEBUG_ENV]
    if totals["batches"] != SAMPLED_BATCHES or rec["launches"] != 0:
        raise AssertionError(f"{name}: {totals['batches']} batches, fused_dense_sgd "
                             f"launched {rec['launches']} times (the torch loop's route "
                             "must not launch it)")
    if rec["model"].route != "torch_loop":
        raise AssertionError(f"{name}: route {rec['model'].route}")
    twin = recorded_app_run(["--backend", "cpu", *SAMPLED_ARGV, *extra], SAMPLED_BATCHES,
                            source=prefilled_source(statuses))
    return (totals, lines, rec), twin


def compare_twin(name, card, twin, rtol):
    """Weights within ``rtol`` of the CPU twin's largest weight, each
    batch's 4 stats within ``rtol``: the largest differences seen."""
    (totals, _, rec), (ctotals, _, crec) = card, twin
    w, cw = rec["weights"].astype("float64"), crec["weights"].astype("float64")
    w_err = float(abs(w - cw).max() / abs(cw).max())
    s_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                for a, b in zip(totals["steps"], ctotals["steps"])
                for k in ("count", "mse", "real_stdev", "pred_stdev"))
    if not (w_err <= rtol and s_err <= rtol):
        raise AssertionError(f"{name}: card against the CPU twin: weights {w_err:.3g}, "
                             f"stats {s_err:.3g} (tolerance {rtol:g})")
    return w_err, s_err


def sampled_phase(smi):
    """``-b 0.5`` at full width: the [N, B] masks made on the card bitwise
    equal to the same function on the CPU (in each float type the draw
    takes), 4 batches on the card against the CPU twin, no launch of the
    fused kernel, no host sync; the mask build's and the step's device ms
    and launches."""
    import torch

    from twtml_tpu_torch.models import sgd

    for dtype in (torch.float32, torch.float64):
        gpu = sgd.sampling_masks(OP_ROWS, OP_ITERS, 0.5, dtype, "cuda")
        cpu = sgd.sampling_masks(OP_ROWS, OP_ITERS, 0.5, dtype, "cpu")
        if not torch.equal(gpu.cpu(), cpu):
            raise AssertionError(f"sampled: {dtype} masks on the card differ from the CPU's")
    mask_ms, mask_busy, mask_n = device_costs(
        lambda: sgd.sampling_masks(OP_ROWS, OP_ITERS, 0.5, torch.float32, "cuda"), 10)
    phase("sampled", f"masks [{OP_ITERS}, {OP_ROWS}] on the card bitwise equal to the "
          f"CPU's (float32 and float64 draws), {int(cpu.sum())} of {cpu.numel()} rows "
          f"selected; the batched draw (made once a row count): {mask_ms:.4f} ms "
          f"(CUDA events, queued ahead), {mask_busy:.4f} ms device busy (profiler), "
          f"{mask_n:g} launches | card: {smi}")
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    statuses = list(SyntheticSource(total=SAMPLED_BATCHES * OP_ROWS, seed=7,
                                    base_ms=NOW_MS).produce())
    card, twin = route_run("sampled", ["-b", "0.5"], statuses)
    totals, lines, rec = card
    w_err, s_err = compare_twin("sampled", card, twin, SAMPLED_RTOL)
    for line, st in zip(lines, totals["steps"]):
        phase("sampled", f"{line} | step {st['step_ms']:.3f} ms (CUDA events), "
              f"dispatch {st['dispatch_ms']:.3f} ms, fetch wait {st['fetch_wait_ms']:.3f} ms")
    phase("sampled", f"{SAMPLED_BATCHES} batches of {OP_ROWS} on the torch loop (route "
          f"named: {rec['model'].route}), fused_dense_sgd launched {rec['launches']} times, "
          f"every dispatch under set_sync_debug_mode('error'); against the --backend cpu "
          f"twin: weights {w_err:.3g} of the largest, stats {s_err:.3g} "
          f"(tolerance {SAMPLED_RTOL:g})")
    dev_ms, busy, n = step_costs(["-b", "0.5"])
    fused_ms, fused_busy, fused_n = step_costs([])
    phase("sampled", f"one step of batch 2 (padded wire, on the card), median of 5: "
          f"{dev_ms:.3f} ms (CUDA events, queued ahead), {busy:.3f} ms device busy "
          f"(profiler), {n:g} kernel launches; the default route (fused kernel) by the "
          f"same measures: {fused_ms:.3f} ms, {fused_busy:.3f} ms, {fused_n:g} launches "
          f"| card: {smi}")
    return {"step_ms": dev_ms, "step_busy_ms": busy, "launches": n, "mask_ms": mask_ms,
            "mask_busy_ms": mask_busy, "weights_err": w_err, "stats_err": s_err,
            "fused_step_ms": fused_ms, "fused_step_busy_ms": fused_busy,
            "fused_launches": fused_n}


def step_costs(extra):
    """``device_costs`` of one step of a fresh cuda model configured by
    ``extra``, on batch 2 of the operating point's stream (padded wire)
    copied to the card, from the weights batch 1 left."""
    from twtml_tpu_torch.apps.common import build_model
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.sgd import batch_to_device
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    tweets = list(SyntheticSource(total=2 * OP_ROWS, seed=3, base_ms=NOW_MS).produce())
    featurizer = Featurizer(now_ms=NOW_MS)
    batches = [featurizer.featurize_batch_units(tweets[i:i + OP_ROWS], row_bucket=OP_ROWS)
               for i in (0, OP_ROWS)]
    model = build_model(ConfArguments().parse(["--backend", "cuda", *extra]))
    float(model.step(batches[0]).mse)
    w, dev = model._weights, batch_to_device(batches[1], "cuda", non_blocking=False)
    return device_costs(lambda: model._train_step(w, dev), 5)


def dtype_phase(smi):
    """``--dtype bfloat16``: 4 full-width batches on the card, the MSE falls,
    everything finite, within BF16_CARD_RTOL of the CPU twin; ``--dtype
    float64 --backend cuda`` exits before anything is built, as the JAX
    package's does."""
    import numpy as np

    from twtml_tpu_torch.streaming.sources import SyntheticSource

    statuses = list(SyntheticSource(total=SAMPLED_BATCHES * OP_ROWS, seed=7,
                                    base_ms=NOW_MS).produce())
    card, twin = route_run("dtype bfloat16", ["--dtype", "bfloat16"], statuses)
    totals, lines, rec = card
    mses = [st["mse"] for st in totals["steps"]]
    finite = all(np.isfinite(st[k]) for st in totals["steps"]
                 for k in ("mse", "real_stdev", "pred_stdev")) and np.isfinite(rec["weights"]).all()
    if not (finite and mses[-1] < mses[0]):
        raise AssertionError(f"dtype bfloat16: MSE {mses}, finite {finite}")
    w_err, s_err = compare_twin("dtype bfloat16", card, twin, BF16_CARD_RTOL)
    for line, st in zip(lines, totals["steps"]):
        phase("dtype", f"bfloat16: {line} | step {st['step_ms']:.3f} ms (CUDA events)")
    phase("dtype", f"bfloat16: MSE falls {mses[0]:.1f} -> {mses[-1]:.1f}, all finite, "
          f"route {rec['model'].route}, fused_dense_sgd launched {rec['launches']} times, "
          f"no host sync; against the --backend cpu twin: weights {w_err:.3g} of the "
          f"largest, stats {s_err:.3g} (tolerance {BF16_CARD_RTOL:g})")
    dev_ms, busy, n = step_costs(["--dtype", "bfloat16"])
    phase("dtype", f"bfloat16: one step of batch 2 (padded wire, on the card), median of "
          f"5: {dev_ms:.3f} ms (CUDA events, queued ahead), {busy:.3f} ms device busy "
          f"(profiler), {n:g} kernel launches | card: {smi}")
    built = []
    from twtml_tpu_torch.apps import linear_regression as app

    base = app.build_model
    app.build_model = lambda conf: built.append(conf) or base(conf)
    try:
        app_run(["--backend", "cuda", "--dtype", "float64", *SAMPLED_ARGV], 1)
        raise AssertionError("dtype float64: --backend cuda was not refused")
    except SystemExit as exc:
        if "add --backend cpu" not in str(exc) or built:
            raise AssertionError(f"dtype float64: refused with {exc!r} after building "
                                 f"{len(built)} model(s)")
        phase("dtype", f"float64 --backend cuda: exits before building a model: {exc}")
    finally:
        app.build_model = base
    return {"step_ms": dev_ms, "step_busy_ms": busy, "launches": n,
            "weights_err": w_err, "stats_err": s_err}


WALL_BATCHES = 5
WALL_ARGV = ["--backend", "cuda", "--source", "synthetic", "--seconds", "1",
             "--replaySpeed", "20000"]


def clock_phase():
    """``--seconds 1`` on the default wire: each interval's tweets, one
    synchronous fetch a batch, the warm-up before the first tick."""
    from twtml_tpu_torch.apps import linear_regression as app
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.streaming.context import StreamingContext

    if ConfArguments().parse(WALL_ARGV).effective_wire() != "padded":
        raise AssertionError("--seconds 1 must resolve the default wire to padded")
    marks = {}
    base_warm, base_start = app.warmup_compile, StreamingContext.start

    def warm(*a, **k):
        base_warm(*a, **k)
        marks["warm_end"] = time.perf_counter()

    def start(self, **kw):
        marks["start"] = time.perf_counter()
        base_start(self, **kw)

    app.warmup_compile, StreamingContext.start = warm, start
    try:
        RECORDER.take()
        os.environ["TWTML_SYNC_DEBUG"] = "error"
        totals, lines, rec = recorded_app_run(WALL_ARGV, WALL_BATCHES)
    finally:
        os.environ.pop("TWTML_SYNC_DEBUG", None)
        app.warmup_compile, StreamingContext.start = base_warm, base_start
    posts = RECORDER.take()
    steps = totals["steps"]
    if (totals["batches"], len(steps)) != (WALL_BATCHES, WALL_BATCHES) or any(
            st["count"] <= 0 or st["wire"] != "padded" for st in steps):
        raise AssertionError(f"clock: {totals['batches']} batches: {steps}")
    if totals["count"] != sum(st["count"] for st in steps):
        raise AssertionError("clock: the count does not add up")
    check_counters("clock", rec, WALL_BATCHES, "padded")
    if not marks["warm_end"] <= totals["stream_started_s"] <= marks["start"]:
        raise AssertionError(f"clock: the warm-up did not end before the stream: {marks}")
    check_posts("clock", posts, lines)
    for i, (line, st) in enumerate(zip(lines, steps)):
        late = st["featurize_started_s"] - (totals["stream_started_s"] + (i + 1) * 1.0)
        phase("clock", f"tick {i + 1}: {line} | {int(st['count'])} rows, lateness "
              f"{late * 1e3:.2f} ms, featurize {st['featurize_ms']:.2f} ms, dispatch "
              f"{st['dispatch_ms']:.3f} ms, fetch wait {st['fetch_wait_ms']:.3f} ms, "
              f"publish {st['publish_ms']:.3f} ms")
    phase("clock", f"{WALL_BATCHES} intervals trained on the padded wire, warm-up "
          f"ended {(marks['start'] - marks['warm_end']) * 1e3:.1f} ms before the stream "
          f"started; kernel launches {rec['launches']} (intervals + warm-up)")
    return rec["launches"]


# ---- phases 12-14: the dashboard server, the live source, host hashing -----

WEB_BATCHES = 8
LIVE_BATCHES = 4
POST_SAMPLES = 200


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stats_line(b) -> str:
    """The app's printed line of a Stats message."""
    return (f"count: {b['count']}  batch: {b['batch']}  mse: {float(b['mse'])}  "
            f"stdev (real, pred): ({b['realStddev']}, {b['predStddev']})")


def http_get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read()


def web_phase(statuses, stream_publish_ms):
    """The port's dashboard server as its own process (``python -m
    twtml_tpu_torch.web.main -nocache``) on a loopback port: a websocket
    client gets the Config push, the app trains 8 full-width batches on the
    card publishing to it (Lightning stays at the recorder), each batch's
    Stats frame equals its printed line, the views and the dashboard are
    served; then the server's POST latency and the largest frame."""
    import tempfile
    import urllib.request

    from twtml_tpu_torch.web.websocket import WebSocketClient

    t_phase = time.perf_counter()
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    tmp = tempfile.mkdtemp(prefix="twtml-web-")
    env = dict(os.environ, PORT=str(port), TMPDIR=tmp, PYTHONPATH=HERE)
    proc = subprocess.Popen([sys.executable, "-m", "twtml_tpu_torch.web.main", "-nocache"],
                            cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    frames, reader = [], None
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"web: the server exited {proc.returncode}: "
                                     f"{proc.stdout.read().decode()[-2000:]}")
            try:
                client = WebSocketClient(url.replace("http", "ws") + "/api", timeout=10)
                break
            except OSError:
                if time.perf_counter() - t0 > 60:
                    raise
                time.sleep(0.1)
        up_s = time.perf_counter() - t0
        push = json.loads(client.recv_text())
        if push != {"jsonClass": "Config", "id": "", "host": "", "viz": []}:
            raise AssertionError(f"web: connect push {push}")
        client.sock.settimeout(None)

        def read():
            try:
                while (text := client.recv_text()) is not None:
                    frames.append(text)
            except OSError:
                pass

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        RECORDER.take()
        totals, lines, rec = recorded_app_run(
            [*STREAM_ARGV, "--twtweb", url], 0, source=prefilled_source(statuses))
        check_counters("web", rec, WEB_BATCHES, "ragged")
        t0 = time.perf_counter()
        while sum('"Stats"' in f for f in frames) < WEB_BATCHES and time.perf_counter() - t0 < 20:
            time.sleep(0.01)
        seen = list(frames)
        stats = [json.loads(f) for f in seen if json.loads(f)["jsonClass"] == "Stats"]
        if [stats_line(b) for b in stats] != lines or len(lines) != WEB_BATCHES:
            raise AssertionError(f"web: Stats frames {stats} against lines {lines}")
        kinds = [json.loads(f)["jsonClass"] for f in seen]
        _, body = http_get(url + "/api/stats")
        if json.loads(body) != stats[-1]:
            raise AssertionError(f"web: GET /api/stats {body!r} != the last frame")
        _, index = http_get(url + "/")
        with open(os.path.join(HERE, "twtml_tpu_torch", "web", "assets", "index.html"), "rb") as fh:
            if index != fh.read():
                raise AssertionError("web: GET / is not the port's index.html")
        views = {v: json.loads(http_get(url + "/api/" + v)[1])["jsonClass"] if v != "series"
                 else len(json.loads(http_get(url + "/api/series")[1]))
                 for v in ("config", "series", "metrics", "model", "freshness")}
        largest = max(len(f.encode()) for f in seen)
        publish = [st["publish_ms"] for st in totals["steps"]]
        phase("web", f"server up in {up_s:.2f} s (a process of its own); connect push "
              f"{push}; {len(seen)} frames during the run: "
              + ", ".join(f"{k} {kinds.count(k)}" for k in sorted(set(kinds))))
        phase("web", f"{WEB_BATCHES} batches of {OP_ROWS} on the card: every Stats frame equals "
              "its printed line, GET /api/stats equals the last, GET / serves the port's "
              f"index.html ({len(index)} B); views {views}; kernel launches {rec['launches']}")
        for i, (line, st) in enumerate(zip(lines, totals["steps"])):
            phase("web", f"batch {i + 1}: {line} | publish {st['publish_ms']:.3f} ms")
        phase("web", f"publish a batch, batches 2-{WEB_BATCHES}: mean "
              f"{statistics.mean(publish[1:]):.3f} ms to the port's server against "
              f"{stream_publish_ms:.3f} ms to the stream phase's recorder (Lightning at the "
              f"recorder in both)")
        body = json.dumps(stats[-1]).encode()
        lat = []
        for _ in range(POST_SAMPLES):
            req = urllib.request.Request(url + "/api", data=body, method="POST",
                                         headers={"content-type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=10) as resp:
                resp.read()
            lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        p50, p99 = lat[len(lat) // 2], lat[int(len(lat) * 0.99) - 1]
        phase("web", f"POST /api latency, {POST_SAMPLES} posts of a Stats body ({len(body)} B) "
              f"as the app posts them (urllib, a connection each, one websocket live): "
              f"p50 {p50:.3f} ms, p99 {p99:.3f} ms, max {lat[-1]:.3f} ms")
        phase("web", f"largest websocket frame of the run: {largest} B")
    finally:
        proc.terminate()
        try:
            code = proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            code = proc.wait()
        if reader is not None:
            reader.join(timeout=10)
    if code != 0 or (reader is not None and reader.is_alive()):
        raise AssertionError(f"web: the server exited {code} on SIGTERM")
    phase("web", f"server stopped by SIGTERM (exit 0), websocket closed by it; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"publish_ms": statistics.mean(publish[1:]), "post_p50_ms": p50,
            "post_p99_ms": p99, "largest_frame": largest}


def tweet_json(s) -> dict:
    """A Status as the v1.1 stream's JSON (what ``Status.from_json`` reads)."""
    obj = {"text": s.text, "retweet_count": s.retweet_count, "id": s.id,
           "user": {"followers_count": s.followers_count,
                    "favourites_count": s.favourites_count,
                    "friends_count": s.friends_count}}
    if s.created_at_ms:
        obj["timestamp_ms"] = str(s.created_at_ms)
    if s.lang:
        obj["lang"] = s.lang
    if s.retweeted_status is not None:
        obj["retweeted_status"] = tweet_json(s.retweeted_status)
    return obj


class FakeStream:
    """A loopback v1.1 streaming endpoint: every request's OAuth signature
    is checked against the credentials; the first request of a round gets
    ``body`` as a chunked stream of JSON lines with keep-alive lines among
    them, later ones an empty stream (the source reconnects)."""

    CREDS = {"consumerKey": "ck-smoke", "consumerSecret": "cs-smoke",
             "accessToken": "at-smoke", "accessTokenSecret": "ts-smoke"}

    def __init__(self, body: bytes):
        from twtml_tpu_torch.streaming import oauth1

        self.body = body
        self.requests = self.bad = 0
        self.served = False
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):
                from urllib.parse import unquote

                fake.requests += 1
                auth = self.headers.get("Authorization", "")
                params = dict((k, unquote(v.strip('"'))) for k, _, v in (
                    p.strip().partition("=") for p in auth[len("OAuth "):].split(",")))
                want = oauth1.sign(
                    "GET", fake.url, [(k, v) for k, v in params.items() if k != "oauth_signature"],
                    fake.CREDS["consumerSecret"], fake.CREDS["accessTokenSecret"])
                if (params.get("oauth_signature") != want
                        or params.get("oauth_consumer_key") != fake.CREDS["consumerKey"]
                        or params.get("oauth_token") != fake.CREDS["accessToken"]):
                    fake.bad += 1
                    self.send_response(401, "Unauthorized")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                body, fake.served = (b"" if fake.served else fake.body), True
                for i in range(0, len(body), 1 << 16):  # chunks cut lines anywhere
                    piece = body[i:i + (1 << 16)]
                    self.wfile.write(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
                self.close_connection = True

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/1.1/statuses/sample.json"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def live_phase():
    """``--source twitter`` at full width: credentials from an
    ``application.conf`` named by ``TWTML_CONFIG``, ``twitter4j.streamBaseURL``
    at a loopback stream that checks each request's OAuth signature and
    serves the main phase's synthetic tweets; 4 batches back to back, each
    line equal to the same tweets' from a pre-filled source on the card;
    the source's own rate."""
    import tempfile

    from twtml_tpu_torch import config
    from twtml_tpu_torch.features.featurizer import Status
    from twtml_tpu_torch.streaming.sources import SyntheticSource
    from twtml_tpu_torch.streaming.twitter import TwitterSource

    t_phase = time.perf_counter()
    # one batch more than the run trains: a live stream never ends, and the
    # depth-8 pipeline delivers a batch's stats when the next batch fills
    n = (LIVE_BATCHES + 1) * OP_ROWS
    statuses = list(SyntheticSource(total=n, base_ms=NOW_MS).produce())
    objs = [tweet_json(s) for s in statuses]
    if [Status.from_json(o) for o in objs] != statuses:
        raise AssertionError("live: a tweet does not survive its JSON round trip")
    # a blank keep-alive line after every 4096 tweets, as the stream sends them
    body = "".join(json.dumps(o) + ("\r\n\r\n" if i % 4096 == 4095 else "\r\n")
                   for i, o in enumerate(objs)).encode()
    fake = FakeStream(body)
    conf_dir = tempfile.mkdtemp(prefix="twtml-conf-")
    conf_path = os.path.join(conf_dir, "application.conf")
    with open(conf_path, "w") as fh:
        fh.write("".join(f'{k}="{v}"\n' for k, v in FakeStream.CREDS.items()))
    argv = ["--backend", "cuda", "--seconds", "0", "--batchBucket", str(OP_ROWS)]
    try:
        os.environ["TWTML_CONFIG"] = conf_path
        config.set_property("twitter4j.streamBaseURL", fake.url)
        t0 = time.perf_counter()
        # the stream's end is a disconnect: the source logs it and reconnects
        totals, lines, rec = recorded_app_run([*argv, "--source", "twitter"], LIVE_BATCHES,
                                              expected_errors=("source twitter crashed",))
        wall = time.perf_counter() - t0
        requests, bad = fake.requests, fake.bad
        # the source alone, a fresh round of the same stream
        fake.served, got = False, []
        src = TwitterSource.from_properties()
        t0 = time.perf_counter()
        src.start(got.append)
        while len(got) < n and time.perf_counter() - t0 < 120:
            time.sleep(0.005)
        alone_s = time.perf_counter() - t0
        src.stop()
    finally:
        os.environ.pop("TWTML_CONFIG", None)
        config.set_property("twitter4j.streamBaseURL", "")
        fake.close()
    RECORDER.take()
    check_counters("live", rec, LIVE_BATCHES, "ragged")
    if bad or not requests:
        raise AssertionError(f"live: {bad} of {requests} requests failed the OAuth check")
    if len(got) != n or got != statuses:
        raise AssertionError(f"live: the source alone gave {len(got)} tweets, not the stream's")
    _, want, _ = recorded_app_run([*argv, "--source", "synthetic"], LIVE_BATCHES,
                                  source=prefilled_source(statuses[:LIVE_BATCHES * OP_ROWS]))
    RECORDER.take()
    if lines != want or len(lines) != LIVE_BATCHES or totals["count"] != LIVE_BATCHES * OP_ROWS:
        raise AssertionError(f"live: lines {lines} against the pre-filled source's {want}")
    for line in lines:
        phase("live", line)
    rate = totals["count"] / totals["stream_seconds"]
    phase("live", f"{LIVE_BATCHES} batches of {OP_ROWS} from --source twitter (OAuth from "
          f"TWTML_CONFIG's application.conf, {requests} signed request(s), all verified by the "
          "stream) equal the pre-filled source's lines on the card")
    phase("live", f"the app: {totals['count']} tweets in stream_seconds "
          f"{totals['stream_seconds']:.3f} s = {rate:.0f} tweets/s (app wall {wall:.2f} s); "
          f"the source alone: {n} tweets in {alone_s:.3f} s = {n / alone_s:.0f} tweets/s "
          f"(socket, chunked decode, json.loads, Status); {len(body)} B of stream; phase "
          f"wall {time.perf_counter() - t_phase:.1f} s")
    return {"app_tweets_per_s": rate, "source_tweets_per_s": n / alone_s}


def hosthash_phase(padded_rec):
    """``--hashOn host --wire padded --profileDir``: the main phase's 4
    batches hashed on the host (native/fasthash.cpp) and trained by the
    same fused kernel, bitwise equal to the padded phase; the Chrome trace
    names the kernel and the app's annotated regions. Then the same batches
    unprofiled, with host and with device hashing, from one pre-filled
    source each (no source thread in the timed runs): featurize and wall."""
    import glob
    import tempfile

    import numpy as np
    import torch

    from twtml_tpu_torch.features import native
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    t_phase = time.perf_counter()
    prof_dir = tempfile.mkdtemp(prefix="twtml-prof-")
    statuses = list(SyntheticSource(total=4 * OP_ROWS, base_ms=NOW_MS).produce())
    argv = ["--backend", "cuda", "--wire", "padded", *MAIN_ARGV]
    host = [*argv, "--hashOn", "host"]
    totals, lines, rec = recorded_app_run([*host, "--profileDir", prof_dir], 4,
                                          source=prefilled_source(statuses))
    hashes = dict(native.HASH_COUNTERS)
    totals_u, lines_u, rec_u = recorded_app_run(host, 4, source=prefilled_source(statuses))
    totals_d, lines_d, rec_d = recorded_app_run([*argv, "--hashOn", "device"], 4,
                                                source=prefilled_source(statuses))
    RECORDER.take()
    check_counters("hosthash", rec, 4, "padded")
    if hashes != {"hashes_native": 5, "hashes_degraded": 0}:
        raise AssertionError(f"hosthash: host hashing counters {hashes}")
    for name, r in (("profiled", rec), ("unprofiled", rec_u), ("device-hash", rec_d)):
        for i, (a, b) in enumerate(zip(padded_rec["outputs"], r["outputs"], strict=True)):
            for k in ("predictions", "quality", "count", "mse", "real_stdev", "pred_stdev"):
                if not torch.equal(getattr(a, k), getattr(b, k)):
                    raise AssertionError(f"hosthash {name} batch {i + 1}: {k} differs "
                                         "from the padded phase")
        if not np.array_equal(padded_rec["weights"], r["weights"]):
            raise AssertionError(f"hosthash {name}: weights differ from the padded phase")
    if not lines_u == lines == lines_d:
        raise AssertionError("hosthash: the runs' lines differ")
    traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    if len(traces) != 1 or traces[0] != totals["profile"]:
        raise AssertionError(f"hosthash: traces {traces}, the app wrote {totals['profile']}")
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = [e for e in events if KERNEL in e.get("name", "") and e.get("cat") == "kernel"]
    regions = {r: sum(e.get("name") == r for e in events)
               for r in ("twtml.featurize", "twtml.dispatch", "twtml.publish")}
    if len(kernels) != 4 or not all(regions.values()):
        raise AssertionError(f"hosthash: trace holds {len(kernels)} {KERNEL} kernels, "
                             f"regions {regions}; {len(names)} names")
    for line, st, st_d in zip(lines, totals_u["steps"], totals_d["steps"]):
        subs = ", ".join(f"{k} {v:.1f}" for k, v in st["featurize_substages_ms"].items())
        phase("hosthash", f"{line} | {st['wire']} wire {st['wire_bytes']} B (device hash "
              f"{st_d['wire_bytes']} B) | featurize {st['featurize_ms']:.1f} ms ({subs}; "
              f"device hash {st_d['featurize_ms']:.1f}), step {st['step_ms']:.2f} ms (device "
              f"hash {st_d['step_ms']:.2f}; CUDA events)")
    host_ms = statistics.median(st["featurize_ms"] for st in totals_u["steps"][1:])
    dev_ms = statistics.median(st["featurize_ms"] for st in totals_d["steps"][1:])
    host_step = statistics.median(st["step_ms"] for st in totals_u["steps"][1:])
    dev_step = statistics.median(st["step_ms"] for st in totals_d["steps"][1:])
    phase("hosthash", "4 batches, host hashing profiled and unprofiled and device hashing: "
          "weights, predictions, stats and quality bitwise equal to the padded phase; "
          f"kernel launches {rec['launches']} (batches + warm-up), host hashing {hashes}")
    phase("hosthash", f"batches 2-4 median, pre-filled source: featurize {host_ms:.2f} ms "
          f"with host hashing against {dev_ms:.2f} ms on the device-hash padded wire (whose "
          f"hash runs in the step); step {host_step:.3f} against {dev_step:.3f} ms")
    phase("hosthash", f"--profileDir: {os.path.basename(traces[0])} "
          f"({os.path.getsize(traces[0])} B, {len(events)} events), {len(kernels)} "
          f"{KERNEL} kernels, regions {regions} (a CUDA region is also a GPU annotation); "
          f"profiled app wall {rec['wall_s']:.3f} s (stream {totals['stream_seconds']:.3f} s) "
          f"against unprofiled {rec_u['wall_s']:.3f} s (stream "
          f"{totals_u['stream_seconds']:.3f} s); phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"host_featurize_ms": host_ms, "device_featurize_ms": dev_ms,
            "launches": rec["launches"]}

# ---- phase 10: times --------------------------------------------------------

# ~0.1 ms of device work queued ahead of a timed call, so that its start
# event fires only after the host has enqueued the call's launch
QUEUE_AHEAD_CYCLES = 200_000


# ---- the logistic learner, the superbatch, streaming k-means ----------------

LOGISTIC_BATCHES = 4
LOGISTIC_ARGV = ["--source", "synthetic", "--seconds", "0", "--batchBucket", str(OP_ROWS)]
# a prediction may differ from the CPU twin's only where the twin's margin
# lies this close to 0 (the card sums X·w in another order)
MARGIN_ATOL = 1e-4


def two_class_statuses(n, seed):
    """``n`` synthetic tweets whose originals end in a lexicon word with a
    seeded draw (" great" 40 %, " bad" 40 %, none 20 %), so the sentiment
    labels hold both classes (the synthetic vocabulary alone is all 1)."""
    import numpy as np

    from twtml_tpu_torch.streaming.sources import SyntheticSource

    statuses = list(SyntheticSource(total=n, seed=seed, base_ms=NOW_MS).produce())
    words = np.random.default_rng(seed).choice(["", " great", " bad"], size=n,
                                                p=[0.2, 0.4, 0.4])
    for st, word in zip(statuses, words):
        st.retweeted_status.text += str(word)
    return statuses


def logistic_phase(smi):
    """``apps/logistic_regression.py`` on the card: 4 full-width batches of
    two-class tweets from a pre-filled source under the sync-debug mode,
    held against the ``--backend cpu`` twin (weights and stats within
    SAMPLED_RTOL, predictions equal except where the twin's margin is
    within MARGIN_ATOL of 0), B1 launched in its logistic mode once a batch
    and once for the warm-up."""
    import numpy as np

    from twtml_tpu_torch.apps import logistic_regression
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV
    from twtml_tpu_torch.features.sentiment import sentiment_labels
    from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD

    t_phase = time.perf_counter()
    statuses = two_class_statuses(LOGISTIC_BATCHES * OP_ROWS, 11)
    share = float(sentiment_labels(statuses).mean())
    run = dict(app_module=logistic_regression, learner=StreamingLogisticRegressionWithSGD)
    os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        totals, lines, rec = recorded_app_run(
            ["--backend", "cuda", *LOGISTIC_ARGV], LOGISTIC_BATCHES,
            source=prefilled_source(statuses), **run)
    finally:
        del os.environ[SYNC_DEBUG_ENV]
    twin = recorded_app_run(["--backend", "cpu", *LOGISTIC_ARGV], LOGISTIC_BATCHES,
                            source=prefilled_source(statuses), **run)
    RECORDER.take()
    if (totals["batches"], rec["launches"], rec["model"].route) != (
            LOGISTIC_BATCHES, LOGISTIC_BATCHES + 1, "fused_dense_sgd"):
        raise AssertionError(f"logistic: {totals['batches']} batches, {rec['launches']} "
                             f"fused launches, route {rec['model'].route}")
    if twin[1] != lines[:1] + twin[1][1:] or len(twin[1]) != len(lines):
        raise AssertionError("logistic: the CPU twin printed another number of lines")
    w_err, s_err = compare_twin("logistic", (totals, lines, rec), twin, SAMPLED_RTOL)
    near, flips = [], 0
    for i, (out, cout, raw) in enumerate(zip(rec["outputs"], twin[2]["outputs"],
                                             twin[2]["raw"], strict=True)):
        valid = cout.count.item()
        close = (raw.abs() <= MARGIN_ATOL)[: int(valid)]
        differ = (out.predictions.cpu() != cout.predictions)[: int(valid)]
        near.append(int(close.sum()))
        flips += int(differ.sum())
        if (differ & ~close).any():
            raise AssertionError(f"logistic batch {i + 1}: {int((differ & ~close).sum())} "
                                 "predictions differ from the twin's at margins clear of 0")
    for line, st in zip(lines, totals["steps"]):
        phase("logistic", f"{line} | step {st['step_ms']:.3f} ms (CUDA events), "
              f"featurize {st['featurize_ms']:.2f} ms, publish {st['publish_ms']:.3f} ms")
    iters = [None if t is None else int(t.item()) for t in rec["iterations"]]
    phase("logistic", f"{LOGISTIC_BATCHES} batches of {OP_ROWS} two-class tweets (positive "
          f"label share {share:.4f}), every dispatch under set_sync_debug_mode('error'); "
          f"fused_dense_sgd (logistic mode) launched {rec['launches']} times (batches + "
          f"warm-up), iterations run {iters}; against the --backend cpu twin: weights "
          f"{w_err:.3g} of the largest, stats {s_err:.3g} (tolerance {SAMPLED_RTOL:g}); "
          f"predictions equal except {flips} row(s); rows with |margin| <= "
          f"{MARGIN_ATOL:g} a batch {near} (batch 1: zero weights, every margin 0); "
          f"whole stream {totals['count']} tweets in {totals['stream_seconds']:.4f} s = "
          f"{totals['count'] / totals['stream_seconds']:.0f} tweets/s; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s | card: {smi}")
    if not 0 < share < 1 or not np.isfinite(rec["weights"]).all():
        raise AssertionError(f"logistic: label share {share}, weights finite "
                             f"{np.isfinite(rec['weights']).all()}")
    return {"launches": rec["launches"], "positive_share": share, "near_zero_rows": near[1:],
            "prediction_flips": flips, "weights_err": w_err, "stats_err": s_err,
            "tweets_per_s": totals["count"] / totals["stream_seconds"]}


SB_K = 8
# --superBatch needs pinned buckets: the row length bucket the synthetic
# tweets take unpinned
SB_ARGV = [*STREAM_ARGV, "--tokenBucket", "64"]
SB_ARMS = (("group", ["--superBatch", str(SB_K), "--wirePack", "group"]),
           ("stacked", ["--superBatch", str(SB_K), "--wirePack", "stacked"]),
           ("K=1", ["--superBatch", "1"]))


def units_buckets(statuses):
    """The ragged units bucket of each full batch of ``statuses``."""
    from twtml_tpu_torch.features.featurizer import Featurizer

    featurizer = Featurizer(now_ms=NOW_MS)
    return [int(featurizer.featurize_batch_ragged(statuses[i:i + OP_ROWS],
                                                  row_bucket=OP_ROWS).units.shape[0])
            for i in range(0, len(statuses), OP_ROWS)]


def dispatch_costs(trace_path):
    """Host launches (kernels, cooperative kernels, graphs) and device
    copies by direction within each ``twtml.dispatch`` region of a
    ``--profileDir`` Chrome trace, in dispatch order."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    # the host's region (the trace repeats it on the device timeline as a
    # gpu_user_annotation)
    regions = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                     if e.get("name") == "twtml.dispatch" and e.get("ph") == "X"
                     and e.get("cat") == "user_annotation")
    copies = {e.get("args", {}).get("correlation"): e["name"] for e in events
              if e.get("cat") == "gpu_memcpy"}
    out = []
    for lo, hi in regions:
        calls = [e for e in events if e.get("cat") == "cuda_runtime"
                 and lo <= e.get("ts", -1) <= hi]
        launches = sum(e["name"].startswith(("cudaLaunch", "cudaGraphLaunch")) for e in calls)
        kinds = [copies.get(e.get("args", {}).get("correlation"), "") for e in calls]
        out.append({"launches": launches, "graph_launches": sum(
            e["name"] == "cudaGraphLaunch" for e in calls),
            "h2d": sum("HtoD" in k for k in kinds), "d2h": sum("DtoH" in k for k in kinds)})
    return out


def graph_memory(rec):
    """(allocated, reserved) bytes the run's model's CUDA graphs held: the
    card's figures with the graphs alive, less those once they (and the
    record's capture-time tensors) are released and the cache emptied."""
    import gc

    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    rec["model"]._graphs.clear()
    rec["raw"], rec["iterations"] = [], []
    gc.collect()
    torch.cuda.empty_cache()
    return held[0] - torch.cuda.memory_allocated(), held[1] - torch.cuda.memory_reserved()


def superbatch_arms(name, statuses, profile_dir=None):
    """The three arms over ``statuses`` under the sync-debug mode, held
    bitwise to the K = 1 arm (weights, each batch's predictions, stats and
    quality, the lines), then, given a ``profile_dir``, each arm again with
    ``--profileDir``: its launches and copies a dispatch. Returns the
    per-arm summaries."""
    import glob

    import numpy as np
    import torch

    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV

    batches = len(statuses) // OP_ROWS
    runs = {}
    for arm, extra in SB_ARMS:
        os.environ[SYNC_DEBUG_ENV] = "error"
        try:
            totals, lines, rec = recorded_app_run([*SB_ARGV, *extra], 0,
                                                  source=prefilled_source(statuses))
        finally:
            del os.environ[SYNC_DEBUG_ENV]
        if arm != "K=1":
            rec["graph_memory"] = graph_memory(rec)
        warm = SB_K if arm != "K=1" else 0  # the warm-up's all-padding group
        if any(float(o.count) for o in rec["outputs"][:warm]):
            raise AssertionError(f"{name} {arm}: the warm-up group trained rows")
        rec["outputs"] = rec["outputs"][warm:]
        if (totals["batches"], len(rec["outputs"])) != (batches, batches):
            raise AssertionError(f"{name} {arm}: {totals['batches']} batches delivered, "
                                 f"{len(rec['outputs'])} outputs for {batches} fed")
        runs[arm] = (totals, lines, rec)
    _, ref_lines, ref = runs["K=1"]
    for arm, (totals, lines, rec) in runs.items():
        if lines != ref_lines or not np.array_equal(rec["weights"], ref["weights"]):
            raise AssertionError(f"{name} {arm}: lines or weights differ from K=1's")
        for i, (a, b) in enumerate(zip(rec["outputs"], ref["outputs"], strict=True)):
            for k in ("predictions", "quality", "count", "mse", "real_stdev", "pred_stdev"):
                if not torch.equal(getattr(a, k), getattr(b, k)):
                    raise AssertionError(f"{name} {arm} batch {i + 1}: {k} differs from K=1's")
    summary = {}
    for arm, extra in SB_ARMS:
        totals, _, rec = runs[arm]
        costs, profiled = [], ""
        if profile_dir is not None:
            out_dir = os.path.join(profile_dir, f"{name}-{arm}")
            ptotals, _, _ = recorded_app_run([*SB_ARGV, *extra, "--profileDir", out_dir], 0,
                                             source=prefilled_source(statuses))
            costs = dispatch_costs(glob.glob(os.path.join(out_dir, "*.pt.trace.json"))[0])
            profiled = f"; profiled run ({ptotals['stream_seconds']:.4f} s), "
        groups = [st.get("group", 1) for st in totals["steps"]]
        # host wall (dispatch + fetch wait) of each 8 consecutive batches:
        # a group's, or 8 plain steps'
        walls = [sum(st["dispatch_ms"] + st["fetch_wait_ms"]
                     for st in totals["steps"][i:i + SB_K])
                 for i in range(0, batches, SB_K)]
        rate = totals["count"] / totals["stream_seconds"]
        grouped = rec["groups"] - (1 if arm != "K=1" else 0)
        per = (costs if len(costs) <= batches // SB_K else
               [{k: sum(c[k] for c in costs[i:i + SB_K]) for k in costs[0]}
                for i in range(0, len(costs), SB_K)])
        if per:
            profiled += (("per dispatch" if per is costs else f"per {SB_K} dispatches") + ": "
                         + "; ".join(f"{c['launches']} launches ({c['graph_launches']} graph), "
                                     f"{c['h2d']} H2D, {c['d2h']} D2H" for c in per))
        phase("superbatch", f"{name} {arm}: {batches} batches, {grouped} group(s) of "
              f"{SB_K} dispatched ({sum(g > 1 for g in groups)} batches grouped), CUDA graphs "
              f"captured {rec['captured']} (the warm-up's included); host wall (dispatch + "
              f"fetch wait) each {SB_K} batches: "
              + ", ".join(f"{w:.3f} ms" for w in walls)
              + f" ({walls[-1] / SB_K:.3f} ms a batch in the last)"
              + ("" if arm == "K=1" else
                 "; the graphs held {:.1f} MB allocated, {:.1f} MB reserved".format(
                     *(b / 2**20 for b in rec["graph_memory"])))
              + "; whole stream "
              f"{totals['count']} tweets in {totals['stream_seconds']:.4f} s = {rate:.0f} "
              f"tweets/s" + profiled)
        host_ms = walls[-1] / SB_K
        summary[arm] = {"groups": grouped, "captured": rec["captured"],
                        "graph_memory_bytes": rec.get("graph_memory"),
                        "host_ms_a_batch_last": host_ms, "host_ms_each_8": walls,
                        "tweets_per_s": rate, "dispatch_costs": per}
    phase("superbatch", f"{name}: the three arms bitwise equal over {batches} batches "
          "(weights, predictions, stats, quality, lines), every dispatch under "
          "set_sync_debug_mode('error')")
    return summary


def superbatch_phase(stream_statuses, smi):
    """``--superBatch 8`` on the group wire, the stacked wire and K = 1,
    three arms held bitwise equal: first over the stream phase's 8 batches,
    whose ragged units buckets decide which of them may group; then over 8
    batches of one units bucket (SyntheticSource seed 3, batches 2-9, each
    bucket checked) fed twice, so the first group captures its CUDA graph
    and the second replays it."""
    import tempfile

    from twtml_tpu_torch.streaming.sources import SyntheticSource

    t_phase = time.perf_counter()
    phase("superbatch", f"stream phase's batches: units buckets {units_buckets(stream_statuses)} "
          f"(groups form only of consecutive batches of one bucket) | card: {smi}")
    pool = list(SyntheticSource(total=9 * OP_ROWS, seed=3, base_ms=NOW_MS).produce())[OP_ROWS:]
    buckets = units_buckets(pool)
    if len(set(buckets)) != 1:
        raise AssertionError(f"superbatch: the replay batches' units buckets differ: {buckets}")
    first = superbatch_arms("stream", stream_statuses)
    with tempfile.TemporaryDirectory() as tmp:
        replay = superbatch_arms("one-bucket x2", pool + pool, tmp)
    if replay["group"]["captured"] < 2 or replay["group"]["groups"] != 2:
        raise AssertionError(f"superbatch: the one-bucket stream ran {replay['group']}")
    phase("superbatch", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"stream": first, "one_bucket": replay, "pool": pool}


KMEANS_BATCHES = 4
KMEANS_ARGV = ["--source", "synthetic", "--seconds", "0", "--batchBucket", str(OP_ROWS)]
KMEANS_RTOL = 1e-5


def kmeans_run(backend, statuses, argv=KMEANS_ARGV):
    """``apps/kmeans.py`` on ``backend`` over a pre-filled source of
    ``statuses`` (None: the source ``argv`` configures): (totals, lines,
    the model, each batch's assignments on the host)."""
    from twtml_tpu_torch.apps import kmeans
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.models.kmeans import StreamingKMeans

    rec = {"assign": []}
    base_update, base_source = StreamingKMeans.update_device, kmeans.build_source

    def update_device(self, points, mask=None):
        assign = base_update(self, points, mask)
        rec["assign"].append(assign.cpu().numpy())
        rec["model"] = self
        return assign

    StreamingKMeans.update_device = update_device
    if statuses is not None:
        kmeans.build_source = lambda conf, **_: prefilled_source(statuses)
    out = io.StringIO()
    try:
        conf = ConfArguments().parse(["--backend", backend, *argv, "--lightning",
                                      RECORDER.url, "--twtweb", RECORDER.url])
        with contextlib.redirect_stdout(out):
            totals = kmeans.run(conf, max_batches=KMEANS_BATCHES)
    finally:
        StreamingKMeans.update_device, kmeans.build_source = base_update, base_source
    return totals, out.getvalue().splitlines(), rec


def kmeans_phase(smi):
    """``apps/kmeans.py`` on the card: 4 batches of 16384 retweets from a
    pre-filled source against the ``--backend cpu`` twin: the initial
    centers bitwise the CPU's draw, centers and weights within KMEANS_RTOL,
    assignments and sizes (the lines' ``sizes``) equal."""
    import numpy as np

    from twtml_tpu_torch.models.kmeans import StreamingKMeans
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    t_phase = time.perf_counter()
    card0 = StreamingKMeans(device="cuda").set_k(3).set_random_centers(2, 0.0).latest_centers
    cpu0 = StreamingKMeans(device="cpu").set_k(3).set_random_centers(2, 0.0).latest_centers
    if not np.array_equal(card0.view(np.int32), cpu0.view(np.int32)):
        raise AssertionError(f"kmeans: initial centers on the card {card0} differ from the "
                             f"CPU's {cpu0}")
    phase("kmeans", f"initial centers (normal(PRNGKey(0), (3, 2)) on the card) "
          f"{card0.tolist()}: bitwise equal to the CPU draw")
    statuses = list(SyntheticSource(total=KMEANS_BATCHES * OP_ROWS, seed=13,
                                    base_ms=NOW_MS).produce())
    t0 = time.perf_counter()
    totals, lines, rec = kmeans_run("cuda", statuses)
    wall = time.perf_counter() - t0
    ctotals, clines, crec = kmeans_run("cpu", statuses)
    RECORDER.take()
    model, cmodel = rec["model"], crec["model"]
    if model.device.type != "cuda" or totals["batches"] != KMEANS_BATCHES:
        raise AssertionError(f"kmeans: {totals['batches']} batches on {model.device}")
    sizes = [ln.split("sizes: ")[1] for ln in lines]
    csizes = [ln.split("sizes: ")[1] for ln in clines]
    for i, (a, b) in enumerate(zip(rec["assign"], crec["assign"], strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"kmeans batch {i + 1}: {int((a != b).sum())} assignments "
                                 "differ from the CPU twin's")
    c_err = float(np.max(np.abs(model.latest_centers - cmodel.latest_centers)
                         / np.maximum(np.abs(cmodel.latest_centers), 1e-30)))
    w_err = float(np.max(np.abs(model.latest_weights - cmodel.latest_weights)
                         / np.maximum(np.abs(cmodel.latest_weights), 1e-30)))
    if sizes != csizes or c_err > KMEANS_RTOL or w_err > KMEANS_RTOL:
        raise AssertionError(f"kmeans: sizes {sizes} / {csizes}, centers {c_err:.3g}, "
                             f"weights {w_err:.3g} against the CPU twin")
    for line in lines:
        phase("kmeans", line)
    phase("kmeans", f"{KMEANS_BATCHES} batches of {OP_ROWS} retweets on the card ("
          f"{totals['count']} points, {wall:.3f} s for the run); against the --backend "
          f"cpu twin: assignments and sizes equal, centers {c_err:.3g}, weights "
          f"{w_err:.3g} relative (tolerance {KMEANS_RTOL:g}); final weights "
          f"{model.latest_weights.tolist()}; phase wall {time.perf_counter() - t_phase:.1f} s "
          f"| card: {smi}")
    return {"centers_err": c_err, "weights_err": w_err, "seconds": wall}


# ---- the 2^18 sparse regime (BASELINE config #4) ----------------------------

SPARSE_BATCHES = 4
SPARSE_ARGV = ["--source", "synthetic", "--seconds", "0", "--batchBucket", str(GRAM_ROWS),
               "--numTextFeatures", str(GRAM_F), "--l2Reg", "0.1", "--maxQueueRows", "-1"]
GATE_MISS_ROWS = 16384  # 16384 x 2^18 x 4 B = 16 GiB of f32 counts: over the gate
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak


# tweet-length rows for the f32-count planes: each batch's (shortest,
# longest) row in code units. A row of n units holds n - 1 bigrams, so the
# longest row picks the plane: 256 units (mass 255) bf16, 280 exact, 128
# (mass 127) int8
LONG_SPANS = ((140, 256), (140, 280), (100, 128), (140, 280))
LONG_PLANES = ("bf16", "exact", "int8", "exact")


def long_statuses(spans, rows, seed):
    """``rows`` retweets for each (shortest, longest) span of code units in
    ``spans``: ASCII text cut from a seeded stream of words of 2-9 letters
    and digits, each row's length uniform in its span and each batch's first
    row at the longest (which fixes the batch's plane); the retweet count
    linear in followers and text length, as SyntheticSource makes it."""
    import numpy as np

    from twtml_tpu_torch.features.featurizer import Status

    rng = np.random.default_rng(seed)
    chars = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
    vocab = ["".join(rng.choice(chars, size=int(n))) for n in rng.integers(2, 10, 4096)]
    corpus = " ".join(vocab[i] for i in rng.integers(0, len(vocab), 40_000).tolist())
    out = []
    for lo, hi in spans:
        lengths = rng.integers(lo, hi + 1, rows)
        lengths[0] = hi
        starts = rng.integers(0, len(corpus) - hi, rows)
        followers = rng.integers(100, 2_000_000, rows)
        noise = rng.normal(0, 20, rows)
        ages = rng.integers(0, 86_400_000, rows)
        for n, at, fo, e, age in zip(lengths, starts, followers, noise, ages):
            text = corpus[at:at + n]
            label = int(np.clip(100 + fo * 4e-4 + n * 2 + e, 100, 1000))
            original = Status(text=text, retweet_count=label, followers_count=int(fo),
                              favourites_count=int(fo % 50_000),
                              friends_count=int(fo % 10_000),
                              created_at_ms=NOW_MS - int(age))
            out.append(Status(text="RT " + text, retweeted_status=original))
    return out


def scatter_learner():
    """The linear learner forced onto the scatter loop (``use_gram=False``):
    the JAX package's own differential baseline for the Gram route."""
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD

    class Scatter(StreamingLinearRegressionWithSGD):
        def __init__(self, *a, **k):
            super().__init__(*a, use_gram=False, **k)

    return Scatter


def sparse_run(name, backend, statuses, batches, extra=(), learner=None):
    """``batches`` batches of ``statuses`` through the flagship app at 2^18
    (a pre-filled source; on cuda every dispatch under the sync-debug mode
    "error"): (totals, lines, record)."""
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV

    if backend == "cuda":
        os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        totals, lines, rec = recorded_app_run(
            ["--backend", backend, *SPARSE_ARGV, *extra], batches,
            source=prefilled_source(statuses), learner=learner)
    finally:
        os.environ.pop(SYNC_DEBUG_ENV, None)
    if totals["batches"] != batches or rec["launches"] != 0:
        raise AssertionError(f"sparse {name}: {totals['batches']} batches, fused_dense_sgd "
                             f"launched {rec['launches']} times")
    return totals, lines, rec


def hold_run(name, run, ref):
    """Weights within WEIGHT_RTOL (atol scaled by max(1, max|w|)), each
    batch's count equal and other stats within RTOL, predictions equal but
    for HALF_UP flips (|difference| 1, where the two margins straddle a
    .5). Returns (weights max abs err, stats max rel err, flips)."""
    import numpy as np

    (totals, _, rec), (rtotals, _, rref) = run, ref
    w, rw = rec["weights"], rref["weights"]
    atol = WEIGHT_RTOL * max(1.0, float(np.abs(rw).max()))
    w_err = float(np.abs(w - rw).max())
    if not (np.abs(w - rw) <= atol + WEIGHT_RTOL * np.abs(rw)).all():
        raise AssertionError(f"sparse {name}: weights differ by {w_err:.3e}")
    s_err = 0.0
    for i, (a, b) in enumerate(zip(totals["steps"], rtotals["steps"], strict=True)):
        if a["count"] != b["count"]:
            raise AssertionError(f"sparse {name} batch {i + 1}: count {a['count']} vs "
                                 f"{b['count']}")
        for k in ("mse", "real_stdev", "pred_stdev"):
            err = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
            if err > RTOL:
                raise AssertionError(f"sparse {name} batch {i + 1} {k}: {a[k]} vs {b[k]}")
            s_err = max(s_err, err)
    flips = 0
    for i, (a, b) in enumerate(zip(rec["outputs"], rref["outputs"], strict=True)):
        d = np.abs(a.predictions.cpu().numpy() - b.predictions.cpu().numpy())
        if (d > 1.0).any() or ((d > 0) & (d < 1.0)).any():
            raise AssertionError(f"sparse {name} batch {i + 1}: predictions differ by up "
                                 f"to {d.max()}")
        flips += int((d > 0).sum())
    if flips > 8:  # 8 of 8,192 rows
        raise AssertionError(f"sparse {name}: {flips} predictions differ (HALF_UP flips)")
    return w_err, s_err, flips


def sparse_phase(smi):
    """Config #4 through the app at F = 2^18, B = 2048, 50 iterations, L2
    0.1, the ragged packed wire at depth 8, model watch on: 4 back-to-back
    batches on the Gram route (B4, B7 and B8 once a batch and once for the
    warm-up, B1 never, no dispatch syncing the host), held against the same
    batches on the card's scatter route and on the CPU twin; one batch at
    B = 16384 (a gate miss: the scatter loop) against its CPU twin; whether
    the card's scatter loop reruns bitwise; ``--superBatch 4`` (a CUDA graph
    of the Gram route, replayed) bitwise equal to K = 1; where a step's time
    goes, on the short synthetic tweets (the int8 plane) and on tweet-length
    rows (the f32-count planes: 4 batches through the app against the CPU
    twin, each batch's plane asserted)."""
    import numpy as np

    from twtml_tpu_torch.ops.gram import PLANE_NAMES
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    t_phase = time.perf_counter()
    statuses = list(SyntheticSource(total=SPARSE_BATCHES * GRAM_ROWS, seed=11,
                                    base_ms=NOW_MS).produce())
    gram_run = sparse_run("gram", "cuda", statuses, SPARSE_BATCHES)
    totals, lines, rec = gram_run
    # one B4, B7 and B8 a batch; none of their tenant forms (no tenant plane)
    want = dict(dict.fromkeys(SV_KERNELS, 0), count_build=SPARSE_BATCHES + 1,
                dual_sgd=SPARSE_BATCHES + 1, dual_writeback_counts=SPARSE_BATCHES + 1)
    if rec["gram_launches"] != want or rec["model"].route != "gram":
        raise AssertionError(f"sparse: route {rec['model'].route}, launches "
                             f"{rec['gram_launches']}, want {want} (4 batches + the warm-up)")
    for line, st in zip(lines, totals["steps"]):
        phase("sparse", f"{line} | step {st['step_ms']:.3f} ms (CUDA events), dispatch "
              f"{st['dispatch_ms']:.3f} ms, featurize {st['featurize_ms']:.2f} ms, fetch "
              f"wait {st['fetch_wait_ms']:.3f} ms")
    scatter = sparse_run("scatter", "cuda", statuses, SPARSE_BATCHES,
                         learner=scatter_learner())
    if any(scatter[2]["gram_launches"].values()) or scatter[2]["model"].route != "scatter":
        raise AssertionError(f"sparse scatter: {scatter[2]['gram_launches']}")
    phase("sparse", "scatter route (use_gram=False) on the card, step ms (CUDA events): "
          + ", ".join(f"{st['step_ms']:.3f}" for st in scatter[0]["steps"]))
    cpu = sparse_run("cpu twin", "cpu", statuses, SPARSE_BATCHES)
    held = {what: hold_run(what, gram_run, ref)
            for what, ref in (("card scatter route", scatter), ("cpu twin", cpu))}
    RECORDER.take()
    for what, (w_err, s_err, flips) in held.items():
        phase("sparse", f"Gram route against the {what}: weights max abs err {w_err:.3e} "
              f"(tolerance rtol {WEIGHT_RTOL}, atol {WEIGHT_RTOL}*max(1, max|w|)), stats "
              f"{s_err:.3e} (rtol {RTOL}), {flips} HALF_UP prediction flips of "
              f"{SPARSE_BATCHES * GRAM_ROWS}")
    phase("sparse", f"{SPARSE_BATCHES} batches of {GRAM_ROWS} at F = {GRAM_F} on the Gram "
          f"route (each batch's plane from host metadata), every "
          f"dispatch under set_sync_debug_mode('error'); launches {rec['gram_launches']} "
          f"(4 batches + the warm-up), fused_dense_sgd {rec['launches']}; app wall "
          f"{rec['wall_s']:.3f} s, scatter route {scatter[2]['wall_s']:.3f} s")

    # tweet-length rows: past 128 code units a batch leaves the int8 plane
    # for f32 counts (B4 writes f32 C, the G product is an f32 matmul, B8
    # reads f32 C); the same app and kernels, held against the CPU twin
    long = long_statuses(LONG_SPANS, GRAM_ROWS, seed=14)
    long_run = sparse_run("long tweets", "cuda", long, SPARSE_BATCHES)
    long_planes = tuple(PLANE_NAMES[p] for (p,) in long_run[2]["planes"])
    if long_planes != LONG_PLANES or long_run[2]["gram_launches"] != want:
        raise AssertionError(f"sparse long tweets: planes {long_planes} (want {LONG_PLANES}), "
                             f"launches {long_run[2]['gram_launches']} (want {want})")
    long_cpu = sparse_run("long tweets cpu twin", "cpu", long, SPARSE_BATCHES)
    RECORDER.take()
    l_w, l_s, l_flips = hold_run("long tweets", long_run, long_cpu)
    for line, st, pl, (lo, hi) in zip(long_run[1], long_run[0]["steps"], long_planes,
                                      LONG_SPANS):
        phase("sparse", f"long tweets ({lo}-{hi} code units, {pl} plane): {line} | step "
              f"{st['step_ms']:.3f} ms (CUDA events), dispatch {st['dispatch_ms']:.3f} ms")
    phase("sparse", f"long tweets: {SPARSE_BATCHES} batches of {GRAM_ROWS} through the app on "
          f"the Gram route, planes {long_planes} from host metadata, launches "
          f"{long_run[2]['gram_launches']}; against the CPU twin: weights {l_w:.3e}, stats "
          f"{l_s:.3e}, {l_flips} flips; app wall {long_run[2]['wall_s']:.3f} s")

    # --superBatch 4 on the padded wire with one row length (8 batches, 2
    # groups of one signature): a group replays a CUDA graph holding B4, the
    # G product, B7 and B8; bitwise equal to K = 1
    more = statuses + list(SyntheticSource(total=SPARSE_BATCHES * GRAM_ROWS, seed=13,
                                           base_ms=NOW_MS).produce())
    padded = ["--wire", "padded", "--tokenBucket", "64"]
    one = sparse_run("superbatch K=1", "cuda", more, 2 * SPARSE_BATCHES, padded)
    sb = sparse_run("superbatch", "cuda", more, 2 * SPARSE_BATCHES,
                    [*padded, "--superBatch", str(SPARSE_BATCHES)])
    # the warm-up's step, then its group of 4 (eager, then captured) and the
    # two groups of real batches (replays of one signature, or an eager run
    # and a replay): 1 + 4 + 4 + 4 launches of each kernel
    want_sb = {k: 1 + 3 * SPARSE_BATCHES if n else 0 for k, n in want.items()}
    warm = sb[2]["outputs"][:SPARSE_BATCHES]  # the warm-up's all-padding group
    sb[2]["outputs"] = sb[2]["outputs"][SPARSE_BATCHES:]
    if any(float(o.count) for o in warm):
        raise AssertionError("sparse superbatch: the warm-up group trained rows")
    if sb[2]["gram_launches"] != want_sb or sb[2]["groups"] != 3 or sb[2]["captured"] < 1:
        raise AssertionError(f"sparse superbatch: launches {sb[2]['gram_launches']} (want "
                             f"{want_sb}), {sb[2]['groups']} groups (want the warm-up's + 2), "
                             f"{sb[2]['captured']} graphs")
    if not np.array_equal(sb[2]["weights"], one[2]["weights"]) or any(
            not np.array_equal(a.predictions.cpu().numpy(), b.predictions.cpu().numpy())
            for a, b in zip(sb[2]["outputs"], one[2]["outputs"], strict=True)):
        raise AssertionError("sparse superbatch: differs from K = 1")
    RECORDER.take()
    phase("sparse", f"--superBatch {SPARSE_BATCHES} --wire padded --tokenBucket 64, 8 "
          f"batches: 2 groups, "
          f"{sb[2]['captured']} CUDA graph(s) captured (the second group replays), launches "
          f"{sb[2]['gram_launches']}; weights and predictions bitwise equal to K = 1")

    # a gate miss: B = 16384 runs the scatter loop, on the card and the CPU
    big = list(SyntheticSource(total=GATE_MISS_ROWS, seed=12, base_ms=NOW_MS).produce())
    miss_argv = ["--batchBucket", str(GATE_MISS_ROWS)]
    miss = sparse_run("gate miss", "cuda", big, 1, miss_argv)
    if any(miss[2]["gram_launches"].values()):
        raise AssertionError(f"sparse gate miss: {miss[2]['gram_launches']}")
    miss_cpu = sparse_run("gate miss cpu twin", "cpu", big, 1, miss_argv)
    RECORDER.take()
    m_w, m_s, m_flips = hold_run("gate miss", miss, miss_cpu)
    phase("sparse", f"gate miss B={GATE_MISS_ROWS}: the scatter loop (B4/B7/B8 launches "
          f"{miss[2]['gram_launches']}), against the CPU twin: weights {m_w:.3e}, stats "
          f"{m_s:.3e}, {m_flips} flips; step {miss[0]['steps'][0]['step_ms']:.2f} ms")
    breakdown = sparse_breakdown(statuses)
    long_breakdown = sparse_breakdown(long, scatter_check=False)
    phase("sparse", f"phase wall {time.perf_counter() - t_phase:.1f} s | card: {smi}")
    return {"launches": rec["gram_launches"],
            "held": {k: {"weights_abs_err": v[0], "stats_rel_err": v[1], "flips": v[2]}
                     for k, v in held.items()},
            "gate_miss": {"weights_abs_err": m_w, "stats_rel_err": m_s, "flips": m_flips},
            "superbatch": {"launches": sb[2]["gram_launches"], "graphs": sb[2]["captured"]},
            "scatter_step_ms": [st["step_ms"] for st in scatter[0]["steps"]],
            "step_ms": [st["step_ms"] for st in totals["steps"]],
            "long": {"planes": long_planes, "weights_abs_err": l_w, "stats_rel_err": l_s,
                     "flips": l_flips,
                     "step_ms": [st["step_ms"] for st in long_run[0]["steps"]]},
            "breakdown": breakdown, "long_breakdown": long_breakdown}


def sparse_breakdown(statuses, scatter_check=True):
    """Where one Gram step's time goes, on batch 2 of ``statuses``
    (padded wire, on the card, from the weights batch 1 left): each piece's
    device time (CUDA events, work queued ahead), the whole step's device
    busy time and launches (profiler), its wall with the host's enqueue,
    and the device's idle share of that wall; with ``scatter_check``,
    whether two runs of the scatter loop on the same inputs are bitwise
    equal."""
    import torch

    from twtml_tpu_torch.apps.common import build_model
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.sgd import batch_to_device, sparse_sgd_loop
    from twtml_tpu_torch.ops import fused_gram
    from twtml_tpu_torch.ops.gram import PLANE_INT8, PLANE_NAMES
    from twtml_tpu_torch.ops.quality import quality_vector
    from twtml_tpu_torch.ops.sparse import sparse_predict
    from twtml_tpu_torch.ops.stats import batch_stats
    from twtml_tpu_torch.ops.text_hash import hash_bigrams_device
    from twtml_tpu_torch.utils.rounding import torch_round_half_up

    featurizer = Featurizer(now_ms=NOW_MS, num_text_features=GRAM_F)
    batches = [featurizer.featurize_batch_units(statuses[i:i + GRAM_ROWS], row_bucket=GRAM_ROWS)
               for i in (0, GRAM_ROWS)]
    model = build_model(ConfArguments().parse(["--backend", "cuda", *SPARSE_ARGV]))
    float(model.step(batches[0]).mse)
    (plane,) = model.planes(batches[1])
    w = model._weights
    dev = batch_to_device(batches[1], "cuda", non_blocking=False)
    idx, val = hash_bigrams_device(dev.units, dev.length, GRAM_F)
    num, y, m = dev.numeric, dev.label, dev.mask
    f = GRAM_F
    kw = dict(num_iterations=OP_ITERS, step_size=0.005, l2_reg=0.1, convergence_tol=0.001)
    raw = sparse_predict(w[:f], w[f:], idx, val, num)
    counts = fused_gram.count_build(idx, val, f, int8=plane == PLANE_INT8)
    g = fused_gram.gram_from_counts(counts)
    g[:GRAM_ROWS, :GRAM_ROWS] += num @ num.T
    p_prev = torch.sum(w * w)
    c, alpha, its = fused_gram.dual_sgd(g, raw, y, m, p_prev=p_prev, **kw)

    def add_numeric():
        gg = fused_gram.gram_from_counts(counts)
        gg[:GRAM_ROWS, :GRAM_ROWS] += num @ num.T

    w_new = fused_gram.dual_writeback_counts(w, c, alpha, idx, val, num, f)

    def quality():  # the step's HALF_UP rounding, stats and quality vector
        preds = torch_round_half_up(raw)
        batch_stats(y, preds, m)
        quality_vector(w, w_new, residual=(raw - y) * m, preds=preds, labels=y, mask=m,
                       numeric=num, token_idx=idx, token_val=val)

    pieces = {
        "hash (units -> tokens)": lambda: hash_bigrams_device(dev.units, dev.length, f),
        "gather predict": lambda: sparse_predict(w[:f], w[f:], idx, val, num),
        "B4 count build": lambda: fused_gram.count_build(idx, val, f, int8=plane == PLANE_INT8),
        "G product (+ N·Nᵀ)": add_numeric,
        "B7 dual loop": lambda: fused_gram.dual_sgd(g, raw, y, m, p_prev=p_prev, **kw),
        "B8 write-back": lambda: fused_gram.dual_writeback_counts(w, c, alpha, idx, val, num, f),
        "rounding + stats + quality": quality,
    }
    times = {}
    for name, fn in pieces.items():
        fn()
        # a piece of many small launches is queued whole before the device
        # starts it, so its time is the device's, not the host's enqueue
        times[name] = timed(fn, 10, queue_ahead=True, ahead_cycles=STEP_AHEAD_CYCLES)[0]
    step = lambda: model._train_step(w, dev, plane=plane)  # noqa: E731
    step_ms, busy, launches = device_costs(step, 5)
    wall_ms = timed(step, 5)[0]
    idle = max(0.0, 1.0 - busy / wall_ms)
    phase("sparse", f"one Gram step of batch 2 (B={GRAM_ROWS}, {PLANE_NAMES[plane]} plane, "
          f"{int(its)} dual iterations run), device ms by piece (CUDA events, queued "
          "ahead, median of 10): " + "; ".join(f"{k} {v:.4f}" for k, v in times.items()))
    phase("sparse", f"the whole step: {step_ms:.3f} ms device (queued ahead), {busy:.3f} ms "
          f"device busy (profiler), {launches:g} kernel launches, {wall_ms:.3f} ms wall with "
          f"the host's enqueue: device idle {idle:.1%} of it")
    out = {"pieces_ms": times, "step_ms": step_ms, "busy_ms": busy, "launches": launches,
           "wall_ms": wall_ms, "idle": idle, "plane": PLANE_NAMES[plane],
           "dual_iterations": int(its)}
    if not scatter_check:
        return out
    # the scatter loop's reproducibility on the card (index_add_: float atomics)
    w1 = sparse_sgd_loop(w, idx, val, num, y, m, num_text_features=f, **kw)
    w2 = sparse_sgd_loop(w, idx, val, num, y, m, num_text_features=f, **kw)
    bitwise = bool(torch.equal(w1, w2))
    phase("sparse", f"scatter loop run twice on the same batch on the card: "
          f"{'bitwise equal' if bitwise else 'NOT bitwise equal'} (max abs difference "
          f"{(w1 - w2).abs().max().item():.3e})")
    return dict(out, scatter_bitwise=bitwise)


def bincount_ms(idx, val, rows, cols):
    """``torch.bincount`` of the flat (row, index) pairs weighted by the
    values, at ``minlength`` rows·cols: the dense counts in one PyTorch call
    (float32 for float32 weights; it sizes its output from max(index), a
    device-to-host read). Median device time of 10, queued ahead; and its
    output's dtype."""
    import torch

    flat = (torch.arange(idx.shape[0], device=idx.device)[:, None] * cols + idx).reshape(-1)
    w = val.reshape(-1)
    call = lambda: torch.bincount(flat, weights=w, minlength=rows * cols)  # noqa: E731
    dtype = str(call().dtype)
    return timed(call, 10, queue_ahead=True)[0], dtype


def long_tweet_tokens():
    """Batch 2 of the sparse phase's ``long_statuses`` (140-280 code units,
    the exact plane) featurized onto the card at B = 2048 x 2^18: (the
    batch, its device-hashed idx, val)."""
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.sgd import batch_to_device
    from twtml_tpu_torch.ops.text_hash import hash_bigrams_device

    tweets = long_statuses(LONG_SPANS, GRAM_ROWS, seed=14)[GRAM_ROWS:2 * GRAM_ROWS]
    host = Featurizer(now_ms=NOW_MS, num_text_features=GRAM_F).featurize_batch_units(
        tweets, row_bucket=GRAM_ROWS)
    dev = batch_to_device(host, "cuda", non_blocking=False)
    return (dev,) + hash_bigrams_device(dev.units, dev.length, GRAM_F)


def f32_build_times(smi):
    """B4's f32 build on tweet-length rows: batch 2 of the sparse phase's
    ``long_statuses`` (140-280 code units, the exact plane), device-hashed at
    B = 2048 x 2^18: (a) the kernel on those tokens, (b) the same shape with
    every index out of range (only the zero-fill, the token staging and the
    sort), (c) ``torch.bincount``; its twin, its bound; the counts bitwise
    the CPU twin's and a rerun's, and the CPU twin's with the indices taken
    mod 1024 (crowded steps)."""
    import torch

    from twtml_tpu_torch.ops import fused_gram

    dev, idx, val = long_tweet_tokens()
    b, l = idx.shape
    f = GRAM_F
    build = lambda i: fused_gram.count_build(i, val, f, int8=False)  # noqa: E731
    c = build(idx)
    rows, cols = c.shape
    again = build(idx)
    twin = fused_gram.count_build_reference(idx.cpu(), val.cpu(), f, int8=False,
                                            rows_out=rows, cols_out=cols)
    card_twin = fused_gram.count_build_reference(idx, val, f, int8=False, rows_out=rows,
                                                 cols_out=cols)
    torch.cuda.synchronize()
    if not torch.equal(bits(c), bits(again)):
        raise AssertionError("count_build f32 L=511: reruns are not bitwise equal")
    if not torch.equal(bits(c).cpu(), bits(twin)):
        raise AssertionError("count_build f32 L=511: differs bitwise from the CPU twin")
    card_twin_bitwise = bool(torch.equal(bits(c), bits(card_twin)))
    del again, twin, card_twin
    # every row's keys in the first 1024 columns: steps (32 chunks) that hold
    # more keys than a warp's window of 32
    crowded = build(idx % 1024)
    crowded_twin = fused_gram.count_build_reference((idx % 1024).cpu(), val.cpu(), 1024,
                                                    int8=False, rows_out=rows)
    if (not torch.equal(bits(crowded[:, :1024]).cpu(), bits(crowded_twin))
            or bool(crowded[:, 1024:].any())):
        raise AssertionError("count_build f32 L=511, crowded steps: differs bitwise from the "
                             "CPU twin")
    del crowded, crowded_twin
    oor = torch.full_like(idx, f)  # every index out of range: nothing counts
    if bool(build(oor).any()):
        raise AssertionError("count_build f32: an out-of-range index was counted")
    a_ms, a_all = timed(lambda: build(idx), 25, queue_ahead=True)
    b_ms, b_all = timed(lambda: build(oor), 25, queue_ahead=True)
    lib_ms, lib_dtype = bincount_ms(idx, val, rows, cols)
    twin_ms, _ = timed(lambda: fused_gram.count_build_reference(
        idx, val, f, int8=False, rows_out=rows, cols_out=cols), 5)
    io_bytes = rows * cols * 4 + b * l * 8
    bound_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    phase("times", f"B4 f32 build on tweet-length rows (card: {smi}): B={b} L={l} F={f}, C "
          f"{rows} x {cols} f32; (a) tokens: median {a_ms:.4f} ms over 25 (min "
          f"{min(a_all):.4f}); (b) every index out of range: {b_ms:.4f} ms (min "
          f"{min(b_all):.4f}); (a) - (b) = {a_ms - b_ms:.4f} ms; rows crowded into 1024 columns "
          f"bitwise the CPU twin; (c) torch.bincount "
          f"({lib_dtype}): {lib_ms:.4f} ms; twin {twin_ms:.4f} ms; bound {io_bytes} B / "
          f"3.35e12 B/s = {bound_ms:.5f} ms "
          f"(bytes), the kernel at {bound_ms / a_ms:.0%} of it; counts bitwise the CPU "
          f"twin's and a rerun's (the card's twin: "
          f"{'bitwise' if card_twin_bitwise else 'NOT bitwise'})")
    # B8 on the same tweet-length tokens: the f32 plane's write-back
    rng = torch.Generator(device="cuda").manual_seed(15)
    w = torch.randn(f + 4, device="cuda", generator=rng) * 1e-2
    alpha = torch.randn(b, device="cuda", generator=rng) * 1e-3
    b8 = b8_times(smi, w, torch.tensor(0.97, device="cuda"), alpha, idx, val, dev.numeric, f,
                  False, "f32 plane, tweet-length rows")
    return {"ms": a_ms, "tokens": l, "b8": b8,
            "out_of_range_ms": b_ms, "token_pass_ms": a_ms - b_ms, "plain_ms": twin_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
            "library_call": "torch.bincount", "library_dtype": lib_dtype,
            "bitwise_cpu_twin": True, "bitwise_card_twin": card_twin_bitwise,
            "rerun_bitwise": True}


def b7_plan(rows):
    """B7's launch plan at B = ``rows`` in the tree imported: its tenant
    table's plan of one tenant, or (a tree before B7 ran over it) its own
    ``dual_plan``. Returns (grid, shared bytes a CTA, G in registers, rows of G
    resident, rows spilled)."""
    from twtml_tpu_torch.ops import fused_gram

    if hasattr(fused_gram, "dual_plan"):
        plan = fused_gram.dual_plan(rows, **sm_limits())
    else:
        plan = fused_gram.dual_tenants_plan((rows,), **sm_limits())
    return (plan.grid, plan.shared_bytes, plan.in_registers, plan.resident_rows,
            plan.spill_rows)


def gram_tweet_batch(rows):
    """``rows`` synthetic tweets (seed 11) featurized onto the card at
    F = 2^18: the batch, its plane and its device-hashed bigrams."""
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.sgd import batch_to_device, host_planes
    from twtml_tpu_torch.ops.text_hash import hash_bigrams_device
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    tweets = list(SyntheticSource(total=rows, seed=11, base_ms=NOW_MS).produce())
    host = Featurizer(now_ms=NOW_MS, num_text_features=GRAM_F).featurize_batch_units(
        tweets, row_bucket=rows)
    (plane,) = host_planes(host)
    dev = batch_to_device(host, "cuda", non_blocking=False)
    return (dev, plane) + hash_bigrams_device(dev.units, dev.length, GRAM_F)


def gram_times(smi, errs, launches, structure=True):
    """B4, the G product, B7 and B8 at config #4's operating point (B = 2048
    synthetic tweets at F = 2^18, device-hashed, the int8 plane), and B7 at
    B = 3072 and 4096 (G spilled): each kernel alone as device time, its
    twin, its bound, the library call where one exists; the kernels line's
    records. With ``structure`` also B7's grid barriers at each tolerance,
    one barrier crossing alone and where G lives; without it only what
    every tree's ``dual_sgd`` exposes (``--times-only`` against another
    checkout; its plan by ``b7_plan``). Where the tree has B7's tenant form,
    it is timed at one tenant on B7's rows beside B7, with the probe's phase
    split where the tree has its timing instantiation."""
    import numpy as np
    import torch

    from twtml_tpu_torch.ops import fused_gram
    from twtml_tpu_torch.ops.gram import PLANE_INT8, PLANE_NAMES
    from twtml_tpu_torch.ops.sparse import sparse_predict

    tweet_batch = gram_tweet_batch
    dev, plane, idx, val = tweet_batch(GRAM_ROWS)
    b, l = idx.shape
    f = GRAM_F
    int8 = plane == PLANE_INT8
    w = torch.from_numpy((np.random.default_rng(5).normal(size=f + 4) * 1e-3)
                         .astype(np.float32)).cuda()
    num, y, m = dev.numeric, dev.label, dev.mask

    def record(name, source_line, ms, twin_ms, bound, extra):
        bytes_ms, ops_ms = bound
        return dict({
            "name": name, "route": "cuda", "source": "twtml_tpu_torch/csrc/gram.cu",
            "replaces": source_line, "tpu_function": None,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": twin_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }, **extra)

    # B4
    counts = fused_gram.count_build(idx, val, f, int8=int8)
    rows, cols = counts.shape
    b4_one, b4_all = timed(lambda: fused_gram.count_build(idx, val, f, int8=int8), 25,
                           queue_ahead=True)
    # 50 calls back to back behind ~20 ms of sleep: one call between two
    # events carries the events' own cost (PERF.md §6, the predict kernel)
    b4_ms, b4_runs, _ = split_queued(lambda: fused_gram.count_build(idx, val, f, int8=int8), 5)
    b4_twin, _ = timed(lambda: fused_gram.count_build_reference(
        idx, val, f, int8=int8, rows_out=rows, cols_out=cols), 5)
    b4_bytes = rows * cols * counts.element_size() + b * l * 8
    b4_bound = (b4_bytes / HBM_BYTES_PER_S * 1e3, 0.0)
    b4_lib, b4_lib_dtype = bincount_ms(idx, val, rows, cols)
    # the G product: torch._int_mm (s8 x s8 -> s32) and the f32 cast
    mm_ms, _ = timed(lambda: torch._int_mm(counts, counts.t()), 10, queue_ahead=True)
    g_ms, _ = timed(lambda: fused_gram.gram_from_counts(counts), 10, queue_ahead=True)
    mm_ops = 2 * rows * rows * cols
    mm_bound = max(mm_ops / INT8_OPS_PER_S, (rows * cols + rows * rows * 4) / HBM_BYTES_PER_S) * 1e3
    counts_f32 = counts.float()
    f32_ms, _ = timed(lambda: counts_f32 @ counts_f32.t(), 3, queue_ahead=True)
    del counts_f32
    phase("times", f"B4 count build at B={b} L={l} F={f} ({PLANE_NAMES[plane]} plane, "
          f"C {tuple(counts.shape)} {counts.dtype}): {b4_ms:.4f} ms back to back (50 calls "
          f"behind ~20 ms of sleep, median of 5: {min(b4_runs):.4f}-{max(b4_runs):.4f}); one "
          f"call between events median {b4_one:.4f} ms over 25 (min {min(b4_all):.4f}); twin {b4_twin:.4f} ms; torch.bincount ({b4_lib_dtype} counts) {b4_lib:.4f} ms; bound "
          f"{b4_bytes} B / 3.35e12 B/s = {b4_bound[0]:.5f} ms (bytes); "
          f"{b4_ms / b4_bound[0]:.1f}x | card: {smi}")
    f32_build = f32_build_times(smi)
    phase("times", f"G product: torch._int_mm {tuple(counts.shape)} x its transpose "
          f"{mm_ms:.4f} ms (with the f32 cast {g_ms:.4f}); bound {mm_ops} int8 operations / "
          f"1979e12 = {mm_bound:.5f} ms ({mm_ms / mm_bound:.1f}x); the f32 planes' f32 matmul "
          f"at the same shape {f32_ms:.3f} ms")
    # B7 at the app's tolerance and with every iteration run
    g = fused_gram.gram_from_counts(counts)
    g[:b, :b] += num @ num.T
    raw = sparse_predict(w[:f], w[f:], idx, val, num)
    p_prev = torch.sum(w * w)
    kw = dict(num_iterations=OP_ITERS, step_size=0.005, l2_reg=0.1)

    def b7_time(g, raw, y, m, tol):
        call = lambda: fused_gram.dual_sgd(g, raw, y, m, p_prev=p_prev,  # noqa: E731
                                           convergence_tol=tol, **kw)
        _, _, its = call()
        r = {"barriers": int(fused_gram.dual_sgd.last_barriers)} if structure else {}
        ms, all_ms = timed(call, 25, queue_ahead=True)
        queued, queued_runs, _ = split_queued(call, 5)
        return dict(r, one_call_ms=ms, min_ms=min(all_ms), max_ms=max(all_ms),
                    ms=queued, queued_runs_ms=queued_runs, iterations=int(its),
                    us_per_iteration=queued / max(int(its), 1) * 1e3)

    def b7_line(r):
        crossed = f", {r['barriers']} grid barriers" if structure else ""
        return (f"{r['ms']:.4f} ms back to back (median of 5 runs of 50: "
                f"{min(r['queued_runs_ms']):.4f}-{max(r['queued_runs_ms']):.4f}); one call "
                f"between events median {r['one_call_ms']:.4f} ms over 25 (min "
                f"{r['min_ms']:.4f}, max {r['max_ms']:.4f}), {r['iterations']} iterations "
                f"run{crossed}, {r['us_per_iteration']:.2f} us an iteration")

    b7 = {tol: b7_time(g, raw, y, m, tol) for tol in (0.001, 0.0)}
    b7_twin, _ = timed(lambda: fused_gram.dual_sgd_reference(
        g, raw, y, m, p_prev=p_prev, convergence_tol=0.001, **kw), 5)
    grid, shared_bytes, regs, _, _ = b7_plan(b)
    its = b7[0.001]["iterations"]
    # each iteration needs one product, G·α_new (2·B² flops: G·Δα is its
    # difference with the last one), and ~12·B elementwise (residual, α
    # update, the four dot products); G read once
    b7_ops = its * (2 * b * b + 12 * b)
    b7_bytes = b * b * 4 + 5 * b * 4
    b7_bound = (b7_bytes / HBM_BYTES_PER_S * 1e3, b7_ops / F32_FLOPS_PER_S * 1e3)
    spread = "; ".join(f"tol {tol}: {b7_line(r)}" for tol, r in b7.items())
    if structure:
        # one barrier crossing alone: the probe on B7's grid, 1000 crossings less none
        fused_gram.dual_barrier_probe(grid, 1000)
        none_ms, _ = timed(lambda: fused_gram.dual_barrier_probe(grid, 0), 25,
                           queue_ahead=True)
        many_ms, _ = timed(lambda: fused_gram.dual_barrier_probe(grid, 1000), 25,
                           queue_ahead=True)
        barrier_us = (many_ms - none_ms) / 1000 * 1e3
        where = "G in registers" if regs else f"{b7_plan(b)[3]} rows of G resident"
        spread += (f"; one grid barrier crossing alone {barrier_us:.3f} us (1000 crossings "
                   f"on {grid} CTAs); {where}")
    phase("times", f"B7 dual loop at B={b}: grid {grid}, {shared_bytes} B shared a "
          f"CTA; {spread}; twin {b7_twin:.4f} ms; bound bytes {b7_bytes} B = "
          f"{b7_bound[0]:.5f} ms, operations {b7_ops} f32 / 67e12 = {b7_bound[1]:.5f} ms")
    # B7 where G's rows do not all fit on chip: B = 3072 and 4096 tweets
    # (the 2^18 route's 4 GiB gate admits both), tolerance 0.001
    spilled = {}
    for rows in (3072, 4096):
        dev_s, plane_s, idx_s, val_s = tweet_batch(rows)
        g_s = fused_gram.gram_from_counts(
            fused_gram.count_build(idx_s, val_s, f, int8=plane_s == PLANE_INT8))
        g_s[:rows, :rows] += dev_s.numeric @ dev_s.numeric.T
        raw_s = sparse_predict(w[:f], w[f:], idx_s, val_s, dev_s.numeric)
        grid_s, _, _, resident_s, spill_s = b7_plan(rows)
        spilled[rows] = dict(b7_time(g_s, raw_s, dev_s.label, dev_s.mask, 0.001),
                             grid=grid_s, resident_rows=resident_s, spill_rows=spill_s)
        phase("times", f"B7 dual loop at B={rows} (G spilled): grid {grid_s}, "
              f"{resident_s} rows of G resident, {spill_s} spilled; tol "
              f"0.001: {b7_line(spilled[rows])}")
        del dev_s, idx_s, val_s, g_s, raw_s
    b7_extra = {"kernel": "B7", "iterations_run": its, "all_iterations_ms": b7[0.0]["ms"],
                "grid": grid, "shared_bytes": shared_bytes,
                "tolerances": {str(tol): r for tol, r in b7.items()},
                "spilled": {str(rows): r for rows, r in spilled.items()}}
    if hasattr(fused_gram, "dual_sgd_tenants"):
        # B7's tenant form at one tenant on B7's rows, against B7 itself: what
        # keeps the two dual loops apart (B7's G in registers, one barrier an
        # iteration, its speculative update)
        c7, a7, _ = fused_gram.dual_sgd(g, raw, y, m, p_prev=p_prev, convergence_tol=0.001, **kw)
        g_text = fused_gram.gram_from_counts(counts)
        one = lambda: fused_gram.dual_sgd_tenants(  # noqa: E731
            [g_text], raw[None], y[None], m[None], num[None], valid_rows=[b],
            p_prev=p_prev[None], num_iterations=OP_ITERS, step_sizes=[0.005], l2_regs=[0.1],
            convergence_tol=0.001)
        c1, a1, i1 = one()
        one_ms, one_runs, one_host_us = split_queued(one, 5)
        one_probe = dual_probe([g_text], raw[None], y[None], m[None], num[None], valid_rows=[b],
                               p_prev=p_prev[None], num_iterations=OP_ITERS, step_sizes=[0.005],
                               l2_regs=[0.1], convergence_tol=0.001)
        one_rec = {
            "ms": one_ms, "queued_runs_ms": one_runs, "host_enqueue_us": one_host_us,
            "iterations": int(i1[0]), "b7_ms": b7[0.001]["ms"],
            "max_abs_diff_alpha": float((a1[0] - a7).abs().max()),
            "c_diff": float((c1[0] - c7).abs()), "probe": one_probe}
        b7_extra["tenant_form_one_tenant"] = one_rec
        phase("times", f"B7's tenant form at one tenant on the same B={b} rows, tol 0.001: "
              f"{one_ms:.4f} ms back to back (median of 5 runs of 50: {min(one_runs):.4f}-"
              f"{max(one_runs):.4f}; host enqueue {one_host_us:.1f} us a call), "
              f"{one_rec['iterations']} iterations, against B7's {one_rec['b7_ms']:.4f} ms; "
              f"max |Δα| {one_rec['max_abs_diff_alpha']:.3g}, |Δc| {one_rec['c_diff']:.3g}; "
              f"its probe split {dual_probe_text(one_probe)} | card: {smi}")
        del g_text
    if structure:
        b7_extra.update(g_in_registers=regs, barrier_crossing_us=barrier_us)
    # B8
    c, alpha, _ = fused_gram.dual_sgd(g, raw, y, m, p_prev=p_prev, convergence_tol=0.001, **kw)
    b8 = b8_times(smi, w, c, alpha, idx, val, num, f, int8, "int8 plane")
    b8["f32_plane"] = f32_build.pop("b8")
    return [
        record("count_build", "twtml_tpu/ops/gram.py:133 (onehot_counts_int8; :112 "
               "onehot_counts, sparse.py:29 densify_text)", b4_ms, b4_twin, b4_bound, {
                   "kernel": "B4", "plane": PLANE_NAMES[plane], "tokens": l,
                   "library_ms": b4_lib, "library_call": "torch.bincount",
                   "one_call_ms": b4_one, "queued_runs_ms": b4_runs,
                   "library_dtype": b4_lib_dtype, "f32_build": f32_build,
                   "gram_product": {"call": "torch._int_mm", "ms": mm_ms,
                                    "with_f32_cast_ms": g_ms, "bound_ms": mm_bound,
                                    "bound_by": "operations", "f32_matmul_ms": f32_ms,
                                    "replaces": "twtml_tpu/ops/gram.py:210"}}),
        record("dual_sgd", "twtml_tpu/models/sgd.py:155 (run_dual_loop)", b7[0.001]["ms"],
               b7_twin, b7_bound, b7_extra),
        record("dual_writeback_counts", "twtml_tpu/ops/gram.py:269 (dual_writeback)",
               b8.pop("ms"), b8.pop("plain_ms"), b8.pop("bound"), b8),
    ]


def b8_call(fused_gram, w, c, alpha, idx, val, num, f, int8):
    """B8 and its plain version on one batch as calls, for the tree
    imported: from the tokens, or (a tree whose B8 read the count build's
    C) from C, built here once. Returns (kernel, plain, reads C)."""
    import inspect

    if "token_idx" in inspect.signature(fused_gram.dual_writeback_counts).parameters:
        return (lambda: fused_gram.dual_writeback_counts(w, c, alpha, idx, val, num, f),
                lambda: fused_gram.dual_writeback_reference(w, c, alpha, idx, val, num, f), False)
    counts = fused_gram.count_build(idx, val, f, int8=int8)
    return (lambda: fused_gram.dual_writeback_counts(w, c, alpha, counts, num, f),
            lambda: fused_gram.dual_writeback_reference(w, c, alpha, counts, num, f), True)


def b8_bytes(rows, tokens, f, tenants=1):
    """The least bytes B8 moves: each token's (idx, val) read once, α and
    the numeric rows read once, each tenant's row of W read and written
    once (and its c)."""
    return rows * tokens * 8 + rows * (4 + 16) + tenants * (2 * (f + 4) * 4 + 4)


def b8_times(smi, w, c, alpha, idx, val, num, f, int8, plane):
    """B8 at one batch's tokens on the tree imported: device ms back to
    back (5 runs of 50 queued), one call between events, the plain
    version, ``index_add_`` of the same contributions (the scatter alone,
    one PyTorch call; not reproducible bitwise on the card: it adds with
    atomics), the bound from B8's own bytes beside one read of the int8 C
    (what B8 streamed before it took the tokens). Returns the record's
    fields (``ms``, ``plain_ms``, ``bound``: (bytes ms, operations ms))."""
    import torch

    from twtml_tpu_torch.ops import fused_gram

    kernel, plain, reads_c = b8_call(fused_gram, w, c, alpha, idx, val, num, f, int8)
    b, l = idx.shape
    one, _ = timed(kernel, 25, queue_ahead=True)
    ms, runs, _ = split_queued(kernel, 5)
    plain_ms, _ = timed(plain, 5)
    flat, contrib, wt = idx.reshape(-1), (val * alpha[:, None]).reshape(-1), w[:f] * c
    lib_ms, _ = timed(lambda: wt.index_add_(0, flat, contrib), 10, queue_ahead=True)
    moved = b8_bytes(b, l, f)
    ops = 2 * b * l + 8 * b + 2 * (f + 4)
    bound = (moved / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3)
    c_read = b * fused_gram.padded_columns(f)
    phase("times", f"B8 write-back ({plane}) at B={b} L={l} F={f}"
          f"{' (this tree reads C)' if reads_c else ''}: {ms:.4f} ms back to back (median of 5 "
          f"runs of 50: {min(runs):.4f}-{max(runs):.4f}); one call between events median "
          f"{one:.4f} ms; plain version {plain_ms:.4f} ms; torch index_add_ of the "
          f"contributions (the scatter alone) {lib_ms:.4f} ms; bound from its own bytes "
          f"{moved} B = {bound[0]:.5f} ms (operations {ops}: {bound[1]:.6f} ms), the kernel at "
          f"{bound[0] / ms:.1%} of it; one read of the int8 C would be {c_read} B = "
          f"{c_read / HBM_BYTES_PER_S * 1e3:.5f} ms | card: {smi}")
    return {"ms": ms, "plain_ms": plain_ms, "bound": bound, "kernel": "B8", "plane": plane,
            "tokens": l, "library_ms": lib_ms, "library_call": "torch.Tensor.index_add_ "
            "(the scatter alone; atomics, not bitwise reproducible)", "one_call_ms": one,
            "queued_runs_ms": runs, "bytes": moved, "reads_c": reads_c,
            "int8_c_read_bytes": c_read}


def timed(fn, runs, queue_ahead=False, ahead_cycles=QUEUE_AHEAD_CYCLES):
    """Median and all of ``runs`` CUDA-event times of ``fn``. With
    ``queue_ahead`` the device is kept busy (``ahead_cycles`` of
    ``torch.cuda._sleep``) while the host enqueues, so the time is the
    device's alone; without it the host's enqueue gap counts."""
    import torch

    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if queue_ahead:
            torch.cuda._sleep(ahead_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


KERNEL = "fused_sgd_kernel"


def profile_kernel(kernel_only, runs=5):
    """Device time of the kernel's launches, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            kernel_only()
        torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages() if ev.device_time_total and KERNEL in ev.key]
    if not rows:
        phase("times", "profiler: no device time recorded; breakdown not measured")
        return
    us = sum(ev.device_time_total for ev in rows) / runs
    n = sum(ev.count for ev in rows) / runs
    phase("times", f"profile {KERNEL}: {us / 1e3:.4f} ms per call in {n:g} launch(es)")


def wire_batches():
    """The operating point's 4 batches (SyntheticSource(seed=3)) on each
    wire, featurized chunk by chunk in turns (ragged packed, then padded),
    with each call's featurize ms and its sub-stages."""
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    tweets = list(SyntheticSource(total=4 * OP_ROWS, seed=3, base_ms=NOW_MS).produce())
    featurizer = Featurizer(now_ms=NOW_MS)
    wires = {"ragged": ([], []), "padded": ([], [])}
    for i in range(0, 4 * OP_ROWS, OP_ROWS):
        chunk = tweets[i:i + OP_ROWS]
        for wire, (batches, times) in wires.items():
            t0 = time.perf_counter()
            if wire == "ragged":
                batch = featurizer.featurize_batch_ragged(chunk, row_bucket=OP_ROWS, pack=True)
            else:
                batch = featurizer.featurize_batch_units(chunk, row_bucket=OP_ROWS)
            times.append(((time.perf_counter() - t0) * 1e3, {
                name: seconds * 1e3 for name, _, seconds in featurizer.last_substages}))
            batches.append(batch)
    return wires


def h2d_ms(batch, runs=20):
    """Host wall of ``batch_to_device`` on the card, synchronised: median
    and min of ``runs``."""
    import torch

    from twtml_tpu_torch.models.sgd import batch_to_device

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch_to_device(batch, "cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times)


def model_after_batch_1(batches):
    """A fresh model on the card that has stepped ``batches[0]`` (which also
    pays first-use set-up)."""
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD

    model = StreamingLinearRegressionWithSGD(device="cuda", quality=True)
    float(model.step(batches[0]).mse)
    return model


def step_walls(wires, rounds=5):
    """Host wall a step on each wire: batches 2-4 of the operating point's
    stream (fresh batches, so each step's loop runs as the app's does),
    the H2D copy, launches and the stats fetch that ends each step
    included, no profiler. The wires take turns, ``rounds`` times."""
    walls = {wire: [] for wire in wires}
    for _ in range(rounds):
        for wire, (batches, _) in wires.items():
            model = model_after_batch_1(batches)
            t0 = time.perf_counter()
            for batch in batches[1:]:
                float(model.step(batch).mse)
            walls[wire].append((time.perf_counter() - t0) * 1e3 / 3)
    for wire, times in walls.items():
        phase("times", f"{wire}: host wall a step, batches 2-4, {rounds} rounds in "
              f"turns: median {statistics.median(times):.3f} ms (all "
              f"{', '.join(f'{t:.3f}' for t in times)})")
    return {wire: statistics.median(times) for wire, times in walls.items()}


def profile_step(wire, batches, wall_ms):
    """Where a step's time goes on ``wire``, batches 2-4: device time by
    CUDA kernel from torch.profiler on one model, the host's launches on a
    second, against the host wall ``wall_ms`` from ``step_walls``. The
    per-step figures divide by the steps whose kernels the profiler
    recorded, counted by the fused kernel's launches (one a step)."""
    from torch.profiler import ProfilerActivity, profile

    model = model_after_batch_1(batches)
    # device activity only: with CPU activity on, the aten ops' events
    # repeat their kernels' device time and the sum counts it twice
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for batch in batches[1:]:
            float(model.step(batch).mse)
    kernels = [ev for ev in prof.key_averages() if ev.device_time_total]
    steps = sum(ev.count for ev in kernels if KERNEL in ev.key)
    if not steps:
        phase("times", f"{wire} step: profiler recorded no kernel of the step, "
              "breakdown not measured")
        return
    rows = [(ev.device_time_total / steps / 1e3, ev.count / steps, ev.key) for ev in kernels]
    busy = sum(ms for ms, _, _ in rows)
    copies = sum(n for _, n, key in rows if "HtoD" in key)
    phase("times", f"{wire} steps of batches 2-4: {busy:.3f} ms device busy a step "
          f"(profiler, {steps} of 3 steps recorded) against {wall_ms:.3f} ms host "
          f"wall: {100 * (1 - busy / wall_ms):.1f}% device idle; {copies:g} H2D "
          "copies a step")
    for ms, n, key in sorted(rows, reverse=True)[:10]:
        phase("times", f"  {wire} step device {ms:.4f} ms ({100 * ms / busy:.1f}%) "
              f"x{n:g} {key[:80]}")

    model = model_after_batch_1(batches)  # the host side of the same steps
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for batch in batches[1:]:
            float(model.step(batch).mse)
    host = sorted(
        ((ev.self_cpu_time_total / 3 / 1e3, ev.count / 3, ev.key)
         for ev in prof.key_averages() if ev.self_cpu_time_total),
        reverse=True,
    )
    total = sum(ms for ms, _, _ in host)
    launches = {key: (n, ms) for ms, n, key in host if key.startswith("cudaLaunch")}
    phase("times", f"{wire} host self time a step (profiler on, so inflated): "
          f"{total:.3f} ms over {sum(n for _, n, _ in host):g} recorded ops; "
          f"launches a step: {sum(n for n, _ in launches.values()):g} ("
          + ", ".join(f"{k} {n:g} in {ms:.4f} ms" for k, (n, ms) in sorted(launches.items()))
          + ")")
    for ms, n, key in host[:8]:
        phase("times", f"  {wire} step host {ms:.4f} ms in {n:g} calls "
              f"({100 * ms / total:.1f}%) {key[:60]}")


def wire_times():
    """Each wire at the operating point: featurize by sub-stage, bytes, the
    H2D copy, the host wall a step, and where its step's time goes. The
    arena serves page-locked buffers, as it does a cuda model's stream, so
    the ragged wire's packed buffer is pinned; the padded wire's arrays are
    pageable."""
    from twtml_tpu_torch.features.arena import get_arena
    from twtml_tpu_torch.features.batch import wire_nbytes

    get_arena().use_device("cuda")
    wires = wire_batches()
    for wire, (batches, times) in wires.items():
        steady = times[1:]  # batch 1 pays first-use set-up
        subs = {k: statistics.median(s[k] for _, s in steady) for k in steady[0][1]}
        phase("times", f"{wire}: featurize batches 2-4 median "
              f"{statistics.median(ms for ms, _ in steady):.2f} ms (all "
              f"{', '.join(f'{ms:.2f}' for ms, _ in times)}); by sub-stage, medians: "
              + ", ".join(f"{k} {v:.2f}" for k, v in subs.items()))
        med, low = h2d_ms(batches[1])
        memory = "pinned" if wire == "ragged" else "pageable"
        phase("times", f"{wire}: wire {wire_nbytes(batches[1])} B a batch ({memory}); "
              f"H2D (batch_to_device, non-blocking, then synchronised) median "
              f"{med:.3f} ms, min {low:.3f} ms over 20 runs")
    walls = step_walls(wires)
    for wire, (batches, _) in wires.items():
        profile_step(wire, batches, walls[wire])


def ptxas_report(kernel=KERNEL):
    """Registers and spills of ``kernel`` (a kernel of csrc/fused_sgd.cu),
    from the ptxas report that the build leaves beside the library."""
    import re

    from twtml_tpu_torch.ops import _build

    path = _build.library_path("fused_sgd")
    log = path.with_name(path.name + ".log")
    text = log.read_text() if log.exists() else ""
    block = text[text.find(kernel):] if kernel in text else ""
    regs = re.search(r"Used (\d+) registers", block)
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
    return (
        int(regs.group(1)) if regs else None,
        (int(spills.group(1)), int(spills.group(2))) if spills else None,
    )


def times_phase(smi, max_err, launches):
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    dev = torch.device("cuda")
    x, y, m, w0 = op_point_inputs(dev)
    b, f = x.shape
    kw = dict(num_iterations=OP_ITERS, step_size=0.005)

    # iterations this data runs before the converged freeze, as the kernel
    # counts them, checked by bisection: reruns are bitwise equal, so
    # w(k) == w(N) exactly from the freeze on
    w_full, _ = fused_sgd.fused_dense_sgd(x, y, m, w0, **kw)
    iters = int(fused_sgd.fused_dense_sgd.last_iterations.item())
    lo, hi = 1, OP_ITERS
    while lo < hi:
        mid = (lo + hi) // 2
        w_mid, _ = fused_sgd.fused_dense_sgd(x, y, m, w0, **dict(kw, num_iterations=mid))
        lo, hi = (lo, mid) if torch.equal(w_mid, w_full) else (mid + 1, hi)
    if lo != iters:
        raise AssertionError(f"kernel counts {iters} iterations, bisection {lo}")

    # the kernel alone: the C entry on buffers allocated once, as the
    # wrapper calls it (it writes only its outputs: no reset between runs)
    plan = fused_sgd.launch_plan(b, f, **sm_limits())
    w = torch.empty(f, device=dev)
    preds = torch.empty(b, device=dev)
    spill = torch.empty(plan.spill_elements, dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(plan.scratch_floats, device=dev)

    def args(iterations=OP_ITERS):
        return fused_sgd.kernel_args(plan, x, y, m, w0, w, preds, spill, scratch,
                                     num_iterations=iterations, step_size=0.005,
                                     l2_reg=0.0, convergence_tol=0.001)

    def kernel_only(iterations=OP_ITERS):
        fused_sgd.call_kernel(plan, args(iterations))

    def kernel_times(iterations, runs=25):
        for _ in range(3):  # warm-up
            kernel_only(iterations)
        return timed(lambda: kernel_only(iterations), runs, queue_ahead=True)

    kernel_ms, times = kernel_times(OP_ITERS)
    prologue_ms, _ = kernel_times(0)
    # the same call with the host's set-up and enqueue inside the events
    with_host_ms, _ = timed(kernel_only, 25)
    enqueue, prepare = [], []
    for _ in range(50):  # host time to enqueue one call, and to prepare its arguments
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call = args()
        t1 = time.perf_counter()
        fused_sgd.call_kernel(plan, call)
        enqueue.append((time.perf_counter() - t0) * 1e3)
        prepare.append((t1 - t0) * 1e3)
        torch.cuda.synchronize()
    # the wrapper with its host work counted: allocations, plan, launch
    wrapper_ms, _ = timed(lambda: fused_sgd.fused_dense_sgd(x, y, m, w0, **kw), 25)
    profile_kernel(kernel_only)
    wire_times()
    twin_ms, _ = timed(lambda: fused_sgd.fused_dense_sgd_reference(x, y, m, w0, **kw), 10)

    # each input read once, each output written once: f32 X, y, mask,
    # w0 / preds, w; X·w0 is the first iteration's product too
    io_bytes = b * f * 4 + 4 * b * 2 + 4 * b + 4 * f * 2
    flops = iters * (4 * b * f + 6 * f) if iters else 2 * b * f
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    regs, spills = ptxas_report()
    phase("times", f"card: {smi}")
    phase("times", f"operating point B={b} F={f}, {OP_ITERS} iterations "
          f"({iters} run before the converged freeze, kernel count = bisection)")
    phase("times", f"launch plan: grid {plan.grid} CTAs x {fused_sgd.THREADS} threads, "
          f"{plan.rows_cap} rows a CTA at most, {plan.resident} resident / "
          f"{plan.spill_per_cta} spilled a CTA ({plan.resident_rows} / "
          f"{plan.spill_rows} rows), {plan.shared_bytes} B shared memory a CTA, "
          f"{regs} registers a thread, spill stores/loads {spills} B (ptxas)")
    phase("times", f"kernel alone (device time: CUDA events with work queued "
          f"ahead, host enqueue excluded): median {kernel_ms:.4f} ms over 25 "
          f"runs (min {min(times):.4f}, max {max(times):.4f}); prologue alone "
          f"(num_iterations=0: X staged, preds, count, one grid barrier): "
          f"{prologue_ms:.4f} ms; per iteration "
          f"{(kernel_ms - prologue_ms) / max(iters, 1) * 1e3:.2f} us "
          f"((t{OP_ITERS} - t0) / {iters} iterations run)")
    phase("times", "earlier kernel (PR 1, three launches an iteration), quoted "
          "from PERF.md, not measured in this run: 1.929 ms")
    phase("times", f"host enqueue of the kernel's {fused_sgd.launches_per_call(OP_ITERS)} "
          f"launch: median {statistics.median(enqueue):.4f} ms over 50 calls (min "
          f"{min(enqueue):.4f}), of which the Python arguments median "
          f"{statistics.median(prepare):.4f} ms; the "
          f"kernel alone with that enqueue inside the events: median "
          f"{with_host_ms:.4f} ms over 25 runs")
    phase("times", f"wrapper call (host work counted: plan, allocations, launch): "
          f"median {wrapper_ms:.4f} ms over 25 runs")
    phase("times", f"plain twin on the card: median {twin_ms:.4f} ms over 10 runs")
    phase("times", f"bound: bytes {io_bytes} B / 3.35e12 B/s = {bytes_ms:.5f} ms; "
          f"operations {flops} f32 flops / 67e12 flop/s = {ops_ms:.5f} ms; "
          f"bound_ms = {bound_ms:.5f} ({bound_by}); kernel at "
          f"{kernel_ms / bound_ms:.1f}x its bound")
    phase("times", "library_ms: none; no single PyTorch call computes the "
          "50-iteration SGD loop")
    return {
        "name": "fused_dense_sgd",
        "route": "cuda",
        "source": "twtml_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "twtml_tpu/ops/pallas_sgd.py:55",
        "tpu_function": "_sgd_kernel",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "prologue_ms": prologue_ms,
        "wrapper_ms": wrapper_ms,
        "plain_ms": twin_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "iterations_run": iters,
        "grid": plan.grid,
        "shared_bytes": plan.shared_bytes,
        "registers": regs,
    }


def logistic_times(smi, max_err, launches):
    """B1's logistic mode at the operating point (0/1 labels from a fixed
    seed): the kernel alone as device time with all 50 iterations run
    (tolerance 0: no freeze), and at the app's tolerance, its twin, its
    bound (the least-squares mode's work plus σ: an exp, an add, a divide
    and a subtract a row an iteration)."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    dev = torch.device("cuda")
    x, _, m, w0 = op_point_inputs(dev)
    y = op_point_labels(dev)
    b, f = x.shape
    plan = fused_sgd.launch_plan(b, f, **sm_limits())
    w = torch.empty(f, device=dev)
    preds = torch.empty(b, device=dev)
    spill = torch.empty(plan.spill_elements, dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(plan.scratch_floats, device=dev)

    def kernel_only(tol):
        fused_sgd.call_kernel(plan, fused_sgd.kernel_args(
            plan, x, y, m, w0, w, preds, spill, scratch, num_iterations=OP_ITERS,
            step_size=0.1, l2_reg=0.0, convergence_tol=tol, mode=1))

    runs = {}
    for tol in (0.0, 0.001):
        for _ in range(3):
            kernel_only(tol)
        runs[tol] = timed(lambda: kernel_only(tol), 25, queue_ahead=True)
        runs[tol] = runs[tol] + (int(scratch[-1].item()),)
    kernel_ms, times, iters = runs[0.0]
    app_ms, _, app_iters = runs[0.001]
    kw = dict(num_iterations=OP_ITERS, step_size=0.1, convergence_tol=0.0,
              residual_fn=fused_sgd.logistic_residual)
    twin_ms, _ = timed(lambda: fused_sgd.fused_dense_sgd_reference(x, y, m, w0, **kw), 10)
    io_bytes = b * f * 4 + 4 * b * 2 + 4 * b + 4 * f * 2
    flops = iters * (4 * b * f + 4 * b + 6 * f)
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    phase("times", f"logistic mode (card: {smi}): kernel alone, {iters} iterations "
          f"(tolerance 0), device time median {kernel_ms:.4f} ms over 25 runs (min "
          f"{min(times):.4f}, max {max(times):.4f}); at the app's tolerance 0.001: "
          f"{app_ms:.4f} ms, {app_iters} iterations run; twin on the card median "
          f"{twin_ms:.4f} ms over 10 runs; bound: bytes {io_bytes} B = {bytes_ms:.5f} ms, "
          f"operations {flops} = {ops_ms:.5f} ms, bound_ms {bound_ms:.5f} ({bound_by}); "
          f"kernel at {kernel_ms / bound_ms:.1f}x its bound")
    return {
        "name": "fused_dense_sgd (logistic mode)",
        "route": "cuda",
        "source": "twtml_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "twtml_tpu/ops/pallas_sgd.py:55",
        "tpu_function": "_sgd_kernel",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "app_tolerance_ms": app_ms,
        "app_tolerance_iterations": app_iters,
        "plain_ms": twin_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "iterations_run": iters,
    }


# ---- phase 20: the serving plane and its fleet router on the card ----------

SERVE_ROWS = 256  # --serveBatchRows's default: the predict step's B
SERVE_REQUESTS = 2000
SERVE_CLIENTS = 16
SERVE_MAX_ROWS = 16
SWAP_AT = SERVE_REQUESTS // 3  # the second checkpoint lands after this many answers
FLEET_REQUESTS = 320
FLEET_CLIENTS = 8
SPARSE_SERVE_REQUESTS = 64
RAW_ATOL = 2e-3  # tests/test_torch_step.py's tolerance on raw margins, card vs CPU


def serve_pool(statuses):
    """The request rows: the stream phase's originals as the JSON face."""
    return [{
        "text": s.retweeted_status.text,
        "followers_count": s.retweeted_status.followers_count,
        "favourites_count": s.retweeted_status.favourites_count,
        "friends_count": s.retweeted_status.friends_count,
        "created_at_ms": s.retweeted_status.created_at_ms,
        "retweet_count": s.retweeted_status.retweet_count,
    } for s in statuses]


def serve_load(url, pool, requests, clients, seed, progress=None):
    """``requests`` POST /api/predict of 1-16 rows (a seeded slice of
    ``pool`` each) from ``clients`` threads through ``ServingClient``:
    [(first row, rows, response, latency s)], the client errors, the
    wall seconds. ``progress(n)`` sees each answer's running count."""
    import numpy as np

    from twtml_tpu_torch.serving import ServingClient

    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, SERVE_MAX_ROWS + 1, size=requests)
    starts = rng.integers(0, len(pool) - SERVE_MAX_ROWS, size=requests)
    jobs = list(zip(starts.tolist(), sizes.tolist()))
    out, errors, lock = [], [], threading.Lock()

    def client_thread(k):
        client = ServingClient(url, timeout=60.0, retries=3)
        for start, n in jobs[k::clients]:
            t0 = time.perf_counter()
            try:
                res = client.predict(pool[start:start + n])
            except Exception as exc:  # every client error is counted and fails the phase
                with lock:
                    errors.append(repr(exc))
                continue
            with lock:
                out.append((start, n, res, time.perf_counter() - t0))
                done = len(out)
            if progress is not None:
                progress(done)

    threads = [threading.Thread(target=client_thread, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads):
        raise AssertionError("serve: a load client did not finish within 300 s")
    return out, errors, time.perf_counter() - t0


class RowRefs:
    """Each row's reference prediction under a snapshot's weights, computed
    in batches of ``SERVE_ROWS`` rows of another composition than served:
    ``train`` is the card's train step (50 iterations; its pre-update
    predictions), ``cpu`` the CPU predict engine, ``raw_cuda``/``raw_cpu``
    the raw margins (rounding off) on each device."""

    def __init__(self, pool, weights_by_step, num_text_features=1000):
        self.pool = pool
        self.weights = weights_by_step
        self.nf = num_text_features
        self.cache: dict = {}

    def model(self, kind):
        from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
        from twtml_tpu_torch.serving.engine import PredictEngine

        class Raw(StreamingLinearRegressionWithSGD):
            round_predictions = False

        if kind == "train":
            return StreamingLinearRegressionWithSGD(num_text_features=self.nf)
        device = "cpu" if kind in ("cpu", "raw_cpu") else "cuda"
        cls = Raw if kind.startswith("raw") else None
        return PredictEngine(num_text_features=self.nf, model_cls=cls, device=device).model

    def get(self, kind, step, rows):
        """{row index: prediction} for ``rows`` (indices into the pool)."""
        import numpy as np

        from twtml_tpu_torch.features.featurizer import Featurizer
        from twtml_tpu_torch.serving.plane import ServingPlane

        have = self.cache.setdefault((kind, step), {})
        todo = sorted(set(rows) - set(have))
        if not todo:
            return have
        model = self.model(kind)
        feat = Featurizer(num_text_features=self.nf)
        for i in range(0, len(todo), SERVE_ROWS):
            chunk = todo[i:i + SERVE_ROWS][::-1]  # another order than served
            model.set_initial_weights(self.weights[step])
            batch = feat.featurize_batch_ragged(
                ServingPlane.statuses_from_rows([self.pool[j] for j in chunk]),
                row_bucket=SERVE_ROWS, pre_filtered=True)
            pending = model.fetch_output(model.step(batch))
            pending.wait()
            preds = pending.result().predictions[np.asarray(batch.mask) > 0]
            have.update(zip(chunk, preds.tolist()))
        return have


def check_served(name, answers, refs, steps):
    """Each answer's predictions against the card's train step under the
    snapshot its ``snapshotStep`` names: bitwise. Returns the steps seen."""
    import numpy as np

    seen = {}
    for start, n, res, _ in answers:
        step = res["snapshotStep"]
        if step not in steps or res["servedRows"] != n:
            raise AssertionError(f"{name}: an answer of {res['servedRows']} rows for {n} "
                                 f"names step {step}, want one of {steps}")
        seen.setdefault(step, []).append((start, n, res))
    for step, group in seen.items():
        rows = [j for start, n, _ in group for j in range(start, start + n)]
        want = refs.get("train", step, rows)
        for start, n, res in group:
            got = np.asarray(res["predictions"], np.float32)
            ref = np.asarray([want[j] for j in range(start, start + n)], np.float32)
            if got.tobytes() != ref.tobytes():  # JSON floats hold float32 exactly
                raise AssertionError(f"{name}: rows {start}..{start + n} under step {step}: "
                                     f"served {got[:4]} != train step {ref[:4]}")
    return {step: len(group) for step, group in seen.items()}


def hold_cpu(name, answers, refs, step):
    """Served (card) against the CPU predict engine: rounded predictions
    equal except HALF_UP flips of a raw margin within ``RAW_ATOL`` of a
    half, and raw margins within ``RAW_ATOL``. Returns (rows, flips, max
    raw error)."""
    rows = sorted({j for start, n, res, _ in answers if res["snapshotStep"] == step
                   for j in range(start, start + n)})
    cpu = refs.get("cpu", step, rows)
    raw_gpu, raw_cpu = refs.get("raw_cuda", step, rows), refs.get("raw_cpu", step, rows)
    served = {}
    for start, n, res, _ in answers:
        if res["snapshotStep"] == step:
            served.update(zip(range(start, start + n), res["predictions"]))
    flips, err = 0, 0.0
    for j in rows:
        err = max(err, abs(raw_gpu[j] - raw_cpu[j]))
        if served[j] != cpu[j]:
            if abs(abs(raw_cpu[j] % 1.0) - 0.5) > RAW_ATOL:
                raise AssertionError(f"{name}: row {j} served {served[j]} cpu {cpu[j]} "
                                     f"(raw {raw_gpu[j]} / {raw_cpu[j]}), not a HALF_UP flip")
            flips += 1
    if err > RAW_ATOL:
        raise AssertionError(f"{name}: raw margins {err:.3e} apart, card against CPU")
    return len(rows), flips, err


def spawn_serve(ck, port, log_path, extra=(), counted=False):
    """``python -m twtml_tpu_torch.apps.serve`` on the card, a process of
    its own, every dispatch under the sync-debug mode, with ``extra``
    flags; ``counted`` runs the same entry point under ``COUNTED_SERVE``
    (stop it with ``stop_counted``)."""
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV

    env = dict(os.environ, **{SYNC_DEBUG_ENV: "error"})
    log = open(log_path, "w")
    entry = ["-c", COUNTED_SERVE] if counted else ["-m", "twtml_tpu_torch.apps.serve"]
    proc = subprocess.Popen(
        [sys.executable, *entry, "--backend", "cuda", "--checkpointDir", ck, "--servePort",
         str(port), "--servePromoteEvery", "0.2", "--blackbox", "off", *extra],
        cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
    proc.log = log
    return proc


def wait_serving(url, step, proc, seconds=120.0):
    """Until the replica's published Serving view names ``step``."""
    from twtml_tpu_torch.serving import ServingClient

    client = ServingClient(url, timeout=2.0, retries=0)
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if proc.poll() is not None:
            break
        try:
            if client.serving().get("snapshotStep", -1) >= step:
                return
        except OSError:
            pass  # not listening yet
        time.sleep(0.2)
    proc.log.flush()
    with open(proc.log.name) as fh:
        tail = fh.read()[-3000:]
    raise AssertionError(f"serve replica {url} never served step {step}:\n{tail}")


def fleet_arm(ck, pool, refs, step):
    """Two serve processes on the card behind ``apps/router.run``: a load
    under ``p99``, then one under ``hash`` with replica 0 killed halfway.
    No client error; every answer equals the train step under its step;
    the kill counted as an ejection."""
    import signal

    from twtml_tpu_torch.apps import router as router_app
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.telemetry import metrics

    ports = (free_port(), free_port())
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    logs = [os.path.join(os.path.dirname(ck), f"replica{i}.log") for i in range(2)]
    procs = [spawn_serve(ck, p, log) for p, log in zip(ports, logs)]
    results = {}
    try:
        t0 = time.perf_counter()
        for url, proc in zip(urls, procs):
            wait_serving(url, step, proc)
        phase("serve", f"fleet: 2 serve processes on the card up in "
              f"{time.perf_counter() - t0:.1f} s (torch import, CUDA context, warm-up)")
        for policy, kill in (("p99", False), ("hash", True)):
            ready, stop, got = threading.Event(), threading.Event(), {}

            def started(server, router, got=got, ready=ready):
                got["port"], got["router"] = server.port, router
                ready.set()

            conf = ConfArguments().parse(["--replicas", ",".join(urls), "--routerPort", "0",
                                          "--routePolicy", policy])
            runner = threading.Thread(target=router_app.run, kwargs=dict(
                conf=conf, started=started, stop_event=stop))
            runner.start()
            if not ready.wait(30):
                raise AssertionError("fleet: the router never came up")
            reg = metrics.get_registry()
            eject0 = reg.counter("fleet.replica_ejections").snapshot()

            def progress(n, kill=kill):
                if kill and n == FLEET_REQUESTS // 2 and procs[0].poll() is None:
                    procs[0].send_signal(signal.SIGKILL)

            try:
                answers, errors, wall = serve_load(
                    f"http://127.0.0.1:{got['port']}", pool, FLEET_REQUESTS, FLEET_CLIENTS,
                    seed=31 if kill else 30, progress=progress)
                if kill:
                    procs[0].wait(timeout=30)
                    router = got["router"]
                    end = time.monotonic() + 30
                    while router.replicas[0].healthy and time.monotonic() < end:
                        router.health_check_once()
                view = got["router"].stats()
            finally:
                stop.set()
                runner.join(timeout=30)
            if errors:
                raise AssertionError(f"fleet {policy}: {len(errors)} client errors: "
                                     f"{errors[:3]}")
            check_served(f"fleet {policy}", answers, refs, {step})
            ejections = reg.counter("fleet.replica_ejections").snapshot() - eject0
            if kill and (ejections < 1 or view["replicas"][0]["healthy"]):
                raise AssertionError(f"fleet {policy}: the killed replica was not ejected "
                                     f"({view})")
            lat = sorted(a[3] for a in answers)
            results[policy] = {
                "requests": len(answers), "client_errors": len(errors),
                "qps": len(answers) / wall, "p50_ms": lat[len(lat) // 2] * 1e3,
                "p99_ms": lat[int(0.99 * (len(lat) - 1))] * 1e3,
                "replica_requests": [r["requests"] for r in view["replicas"]],
                "retries": view["retries"], "ejections": ejections,
            }
            phase("serve", f"fleet {policy}{' (replica 0 killed halfway)' if kill else ''}: "
                  f"{len(answers)} answers, 0 client errors, each bitwise the train step's; "
                  f"{results[policy]['qps']:.0f} requests/s, p50 "
                  f"{results[policy]['p50_ms']:.2f} ms, p99 {results[policy]['p99_ms']:.2f} ms; "
                  f"per replica {results[policy]['replica_requests']}, router retries "
                  f"{view['retries']}, ejections {ejections}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10)
            proc.log.close()
    return results


PREDICT_AHEAD_CYCLES = 2_000_000  # ~1 ms: the wrapper's host work stays off the clock


def bits(t):
    """A float32 tensor's bit patterns (a comparison that tells -0 from 0)."""
    import torch

    return t.contiguous().view(dtype=torch.int32)


def predict_case(name, x, y, m, w0):
    """The predict kernel (N = 0) against the training kernel's first row
    pass (N = 1) on the same batch, bitwise; w returned bitwise w0, 0
    iterations; the twin within RTOL/ATOL. Returns (preds, max abs err)."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    w, preds = fused_sgd.fused_dense_sgd(x, y, m, w0, num_iterations=0, step_size=0.005)
    iterations = int(fused_sgd.fused_dense_sgd.last_iterations.item())
    _, train = fused_sgd.fused_dense_sgd(x, y, m, w0, num_iterations=1, step_size=0.005)
    again = fused_sgd.fused_dense_sgd(x, y, m, w0, num_iterations=0, step_size=0.005)[1]
    _, twin = fused_sgd.fused_dense_sgd_reference(x, y, m, w0, num_iterations=0,
                                                  step_size=0.005)
    torch.cuda.synchronize()
    if not torch.equal(bits(preds), bits(train)):
        diff = int((bits(preds) != bits(train)).sum())
        raise AssertionError(f"predict {name}: {diff} predictions differ bitwise from the "
                             "N = 1 launch's first pass")
    if not torch.equal(bits(w), bits(w0)) or iterations != 0:
        raise AssertionError(f"predict {name}: w changed or {iterations} iterations ran")
    if not torch.equal(bits(preds), bits(again)):
        raise AssertionError(f"predict {name}: reruns are not bitwise equal")
    err, _ = compare(f"predict {name}", preds, twin)
    return preds, err


def predict_mode_times(smi, launches):
    """B1's predict-only kernel (N = 0, the serving path's) at B = 256 and
    16384: bitwise the N = 1 launch's first-pass predictions, w bitwise w0,
    0 iterations, the twin within RTOL/ATOL, an all-padding batch predicting
    zeros; the same at F = 2000 and 8196 (the wide order) and with NaN/Inf
    in masked rows, bitwise ignored; the kernel alone through its wrapper (device time,
    queued ahead), its twin, the one PyTorch call of the same function
    (``torch.mv``: X·w0), the bound. The kernels line's record."""
    import numpy as np
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    dev = torch.device("cuda")
    x_full, y_full, m_full, w0 = op_point_inputs(dev)
    out = {}
    for b in (SERVE_ROWS, OP_ROWS):
        x, y, m = (t[:b].contiguous() for t in (x_full, y_full, m_full))
        f = x.shape[1]
        kw = dict(num_iterations=0, step_size=0.005)
        preds, err = predict_case(f"B={b}", x, y, m, w0)
        _, empty = fused_sgd.fused_dense_sgd(x, y, torch.zeros_like(m), w0, **kw)
        if empty.abs().max().item() != 0.0:
            raise AssertionError(f"predict mode B={b}: an all-padding batch predicts non-zero")
        call = lambda: fused_sgd.fused_dense_sgd(x, y, m, w0, **kw)  # noqa: E731
        for _ in range(3):
            call()
        kernel_ms, times = timed(call, 50, queue_ahead=True,
                                 ahead_cycles=PREDICT_AHEAD_CYCLES)
        twin_ms, _ = timed(lambda: fused_sgd.fused_dense_sgd_reference(x, y, m, w0, **kw), 20,
                           queue_ahead=True, ahead_cycles=PREDICT_AHEAD_CYCLES)
        for _ in range(3):
            torch.mv(x, w0)
        mv_ms, _ = timed(lambda: torch.mv(x, w0), 50, queue_ahead=True,
                         ahead_cycles=PREDICT_AHEAD_CYCLES)
        # the same two, 50 calls back to back behind split_queued's long
        # sleep: no event pair around each call, the host never in the way
        long_ms, long_runs, host_us = split_queued(call, 10)
        mv_long_ms, _, _ = split_queued(lambda: torch.mv(x, w0), 10)
        mv_err = (torch.mv(x, w0) - preds)[m > 0].abs().max().item()
        # each input the function needs read once, each output written once:
        # f32 X, mask and w0; preds and w (it reads no labels)
        io_bytes = b * f * 4 + 4 * b + 4 * f + 4 * b + 4 * f
        flops = 2 * b * f
        bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        out[b] = {
            "ms": long_ms, "plain_ms": twin_ms, "library_ms": mv_long_ms,
            "ms_one_call": kernel_ms, "library_ms_one_call": mv_ms,
            "runs_ms": long_runs, "host_us_a_call": host_us, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "max_abs_err": err,
            "mv_max_abs_diff": mv_err, "bitwise_first_pass": True,
        }
        phase("serve", f"B1 predict kernel (N = 0) at B={b} F={f} (card: {smi}): kernel "
              f"alone median {kernel_ms:.4f} ms over 50 runs (min {min(times):.4f}); twin "
              f"{twin_ms:.4f} ms; torch.mv "
              f"(X·w0, the library call) {mv_ms:.4f} ms, within {mv_err:.2e} of the kernel; "
              f"bound: bytes {io_bytes} B = {bytes_ms:.5f} ms, operations {flops} = "
              f"{ops_ms:.5f} ms; kernel at {kernel_ms / bound_ms:.1f}x its bound, "
              f"{kernel_ms / mv_ms:.2f}x torch.mv; preds bitwise the N = 1 launch's first "
              f"pass, w bitwise w0, 0 iterations, max abs err vs twin {err:.2e}, all-padding "
              "zeros")
        phase("serve", f"B1 predict kernel at B={b}, 10 runs of 50 calls back to back queued "
              f"behind {SPLIT_AHEAD_CYCLES} cycles of sleep (split_queued): median "
              f"{long_ms:.4f} ms a call (runs {min(long_runs):.4f}-{max(long_runs):.4f}; the "
              f"host's enqueue {host_us:.1f} us a call), torch.mv {mv_long_ms:.4f} ms: the "
              f"kernel at {long_ms / bound_ms:.1f}x its bound, {long_ms / mv_long_ms:.2f}x "
              "torch.mv")

    # the wide order (F > 1024) and NaN/Inf in masked rows, each bitwise
    # the training kernel's first pass
    rng = np.random.default_rng(2030)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    for rows, feats, valid in ((1024, 2000, 1000), (SERVE_ROWS, 1004, 130), (300, 8196, 250)):
        x, y, m = design(rng, rows, feats, valid)
        w = to((rng.normal(size=feats) * 1e-2).astype("float32"))
        clean, err = predict_case(f"B={rows} F={feats}", to(x * m[:, None]), to(y), to(m), w)
        x[m == 0] = np.nan
        x[(m == 0).nonzero()[0][::2], 1] = np.inf
        dirty, _ = predict_case(f"B={rows} F={feats} NaN/Inf", to(x), to(y), to(m), w)
        if not torch.equal(bits(clean), bits(dirty)):
            raise AssertionError(f"predict B={rows} F={feats}: NaN/Inf in masked rows reached "
                                 "the predictions")
        phase("serve", f"B1 predict kernel at B={rows} F={feats} "
              f"({'wide' if feats > fused_sgd.TILE_COLUMNS else 'narrow'} order): preds "
              f"bitwise the N = 1 launch's first pass, max abs err vs twin {err:.2e}; "
              f"NaN/Inf in {rows - valid} masked rows: bitwise equal")
    serve = out[SERVE_ROWS]
    return dict({
        "name": "fused_dense_predict", "route": "cuda",
        "source": "twtml_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "twtml_tpu/ops/pallas_sgd.py:55 (_sgd_kernel at num_iterations=0)",
        "tpu_function": "_sgd_kernel", "launches": launches,
        "max_abs_err": max(o["max_abs_err"] for o in out.values()),
        "library_call": "torch.mv(X, w0)", "shape": [SERVE_ROWS, x_full.shape[1]],
    }, **{k: serve[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        at_16384=out[OP_ROWS])


def serve_step_costs(weights, pool):
    """One full serve batch (B = 256) through the predict engine on the
    card: device ms (queued ahead), device busy and launches (profiler),
    and the host wall of a step with its fetch."""
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.serving import ServingSnapshot
    from twtml_tpu_torch.serving.engine import PredictEngine
    from twtml_tpu_torch.serving.plane import ServingPlane

    engine = PredictEngine()
    engine.set_snapshot(ServingSnapshot(step=0, weights=weights))
    batch = Featurizer().featurize_batch_ragged(
        ServingPlane.statuses_from_rows(pool[:SERVE_ROWS]), row_bucket=SERVE_ROWS,
        pre_filtered=True)
    wire = engine.pack_for_wire(batch)
    event_ms, busy, launches = device_costs(lambda: engine.step(wire), 20)
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        pending = engine.fetch_output(engine.step(wire))
        pending.wait()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"device_ms": event_ms, "busy_ms": busy, "launches": launches,
            "host_wall_ms": statistics.median(walls)}


def serve_phase(smi, main_weights, statuses):
    """The serving plane on the card (module docstring, phase 20)."""
    import tempfile

    import numpy as np
    import torch

    from twtml_tpu_torch.apps import serve as serve_app
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV
    from twtml_tpu_torch.checkpoint import Checkpointer
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.ops import fused_gram, fused_sgd
    from twtml_tpu_torch.serving import ServingSnapshot
    from twtml_tpu_torch.serving.plane import ServingPlane
    from twtml_tpu_torch.telemetry import metrics

    t_phase = time.perf_counter()
    pool = serve_pool(statuses)
    w1 = np.asarray(main_weights, np.float32)
    w2 = (w1 * np.float32(0.75)).astype(np.float32)
    refs = RowRefs(pool, {4: w1, 8: w2})
    ok = {"quality": {"level": "ok"}}
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        Checkpointer(ck).save(4, w1, dict(ok, count=4 * OP_ROWS, batches=4))
        reg = metrics.get_registry()
        batches0 = reg.counter("serve.batches").snapshot()
        ready, stop, got = threading.Event(), threading.Event(), {}

        def started(server, plane, promoter):
            got["url"], got["plane"] = f"http://127.0.0.1:{server.port}", plane
            ready.set()

        def run():
            try:
                got["stats"] = serve_app.run(ConfArguments().parse([
                    "--backend", "cuda", "--checkpointDir", ck, "--servePort",
                    str(free_port()), "--servePromoteEvery", "0.2", "--blackbox", "off",
                ]), started=started, stop_event=stop)
            except BaseException as exc:  # raised below
                got["error"] = exc
                ready.set()

        fused_sgd.fused_dense_sgd.launches = 0
        fused_sgd.fused_dense_sgd.predict_launches = 0
        for fn in fused_gram.KERNELS:
            fn.launches = 0
        os.environ[SYNC_DEBUG_ENV] = "error"
        server = threading.Thread(target=run)
        t0 = time.perf_counter()
        server.start()
        try:
            if not ready.wait(120) or "error" in got:
                raise AssertionError(f"serve: apps/serve.run did not come up: {got.get('error')}")
            boot_s = time.perf_counter() - t0

            def progress(n):
                if n == SWAP_AT:  # mid-load, the trainer's next checkpoint
                    Checkpointer(ck).save(8, w2, dict(ok, count=8 * OP_ROWS, batches=8))

            answers, errors, wall = serve_load(got["url"], pool, SERVE_REQUESTS,
                                               SERVE_CLIENTS, seed=20, progress=progress)
        finally:
            stop.set()
            server.join(timeout=60)
            del os.environ[SYNC_DEBUG_ENV]
        torch.cuda.synchronize()
        launches = fused_sgd.fused_dense_sgd.launches
        predict_launches = fused_sgd.fused_dense_sgd.predict_launches
        gram_launches = {fn.__name__: fn.launches for fn in fused_gram.KERNELS}
        served_batches = reg.counter("serve.batches").snapshot() - batches0
        plane = got["plane"]
        if server.is_alive() or "error" in got:
            raise AssertionError(f"serve: the app did not stop cleanly: {got.get('error')}")
        if errors:
            raise AssertionError(f"serve: {len(errors)} client errors: {errors[:3]}")
        if (launches != served_batches + 1 or predict_launches != launches
                or any(gram_launches.values())):
            raise AssertionError(f"serve: B1 launched {launches} times ({predict_launches} "
                                 f"of them its predict kernel) for {served_batches} batches "
                                 f"+ the warm-up; Gram kernels {gram_launches}")
        if (int(fused_sgd.fused_dense_sgd.last_iterations.item()) != 0
                or not np.array_equal(plane._engine.model.latest_weights, w2)):
            raise AssertionError("serve: the predict-only launches moved the snapshot's weights")
        seen = check_served("serve", answers, refs, {4, 8})
        if set(seen) != {4, 8}:
            raise AssertionError(f"serve: the hot swap served steps {seen}")
        lat = sorted(a[3] for a in answers)
        rows = sum(a[1] for a in answers)
        phase("serve", f"apps/serve.run on the card up in {boot_s:.2f} s (snapshot of the main "
              f"phase's 4 batches, step 4); {len(answers)} requests of 1-{SERVE_MAX_ROWS} rows "
              f"({rows} rows) from {SERVE_CLIENTS} ServingClient threads in {wall:.3f} s = "
              f"{len(answers) / wall:.0f} requests/s, {rows / wall:.0f} rows/s; latency p50 "
              f"{lat[len(lat) // 2] * 1e3:.2f} ms, p99 {lat[int(0.99 * (len(lat) - 1))] * 1e3:.2f}"
              f" ms; {served_batches} batches, fill {rows / served_batches:.1f} rows of "
              f"{SERVE_ROWS}; every dispatch under set_sync_debug_mode('error'), 0 client errors")
        phase("serve", f"B1 launched {launches} times = {served_batches} batches + the warm-up, "
              f"each its predict kernel ({predict_launches} predict launches, last iterations "
              f"0), the served weights bitwise the snapshot's; Gram kernels 0")
        phase("serve", f"hot swap mid-load to step 8: answers by snapshot step {seen}; every "
              "answer bitwise equal to the card's train-step pre-update predictions of its rows "
              f"under the step it names, the references batched {SERVE_ROWS} rows at a time in "
              "another composition and order (each row's prediction is row-local)")
        held = {step: hold_cpu("serve", answers, refs, step) for step in (4, 8)}
        phase("serve", "against the --backend cpu predict engine: " + "; ".join(
            f"step {s}: {n} rows, {fl} HALF_UP flips, raw margins within {e:.2e}"
            for s, (n, fl, e) in held.items()) + f" (tolerance {RAW_ATOL})")
        fleet = fleet_arm(ck, pool, refs, 8)

    # config #4: a 262,148-weight snapshot on the card's gather predict
    sparse_w = (np.random.default_rng(18).standard_normal(GRAM_F + 4) * 2.0).astype(np.float32)
    fused_sgd.fused_dense_sgd.launches = 0
    sparse_refs = RowRefs(pool, {1: sparse_w}, num_text_features=GRAM_F)
    os.environ[SYNC_DEBUG_ENV] = "error"
    sp = ServingPlane(ServingSnapshot(step=1, weights=sparse_w), num_text_features=GRAM_F,
                      featurizer=Featurizer(num_text_features=GRAM_F))
    try:
        sp.warmup()
        sp.start()
        rng = np.random.default_rng(44)
        jobs = [(int(s), int(n)) for s, n in zip(
            rng.integers(0, len(pool) - SERVE_MAX_ROWS, SPARSE_SERVE_REQUESTS),
            rng.integers(1, SERVE_MAX_ROWS + 1, SPARSE_SERVE_REQUESTS))]
        futs = [(s, n, sp.submit(sp.statuses_from_rows(pool[s:s + n]))) for s, n in jobs]
        sparse_answers = [(s, n, {"snapshotStep": 1, "servedRows": n,
                                  "predictions": f.result(timeout=120)["predictions"]}, 0.0)
                          for s, n, f in futs]
    finally:
        sp.stop()
        del os.environ[SYNC_DEBUG_ENV]
    if fused_sgd.fused_dense_sgd.launches or sp._engine.model.route != "scatter":
        raise AssertionError(f"serve config #4: route {sp._engine.model.route}, B1 launched "
                             f"{fused_sgd.fused_dense_sgd.launches} times")
    n4, flips4, err4 = hold_cpu("serve config #4", sparse_answers, sparse_refs, 1)
    phase("serve", f"config #4 (2^18 + 4 = {GRAM_F + 4} weights): {len(sparse_answers)} requests "
          f"({n4} rows) on the card's gather predict (route scatter, 0 iterations: no "
          f"kernel), B1 launched 0 times; against the CPU twin {flips4} HALF_UP flips, raw "
          f"margins within {err4:.2e}")

    step = serve_step_costs(w1, pool)
    phase("serve", f"one serve step (B = {SERVE_ROWS}, packed ragged wire, H2D copy "
          f"included): device {step['device_ms']:.4f} ms (CUDA events, queued ahead), "
          f"{step['busy_ms']:.4f} ms busy and {step['launches']:.0f} launches (profiler), "
          f"host wall of step + fetch {step['host_wall_ms']:.3f} ms (median of 20)")
    predict = predict_mode_times(smi, predict_launches)
    phase("serve", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return {
        "requests": len(answers), "qps": len(answers) / wall,
        "p50_ms": lat[len(lat) // 2] * 1e3, "p99_ms": lat[int(0.99 * (len(lat) - 1))] * 1e3,
        "batches": served_batches, "fill_rows": rows / served_batches, "steps_seen": seen,
        "cpu_flips": {s: v[1] for s, v in held.items()}, "fleet": fleet, "step": step,
        "predict_kernel": predict,
    }


# ---- phase 21: the tenant plane --------------------------------------------

TENANT_BATCHES = 4
TENANT_M = 4
TENANT_ARGV = [*STREAM_ARGV, "--modelWatch", "on"]
# phrases whose widest code unit puts a row in the lang key's class 102 (CJK:
# U+6587) or 5 (Cyrillic: U+0442); ASCII rows are class 0
LANG_TAILS = (" café 中文", " привет")


def copy_batch(b):
    """A host batch with fresh arrays (the run's arena buffers are reused)."""
    import numpy as np

    from twtml_tpu_torch.features.batch import RaggedUnitBatch

    if isinstance(b, RaggedUnitBatch):
        return RaggedUnitBatch(*(np.array(a) for a in (b.units, b.offsets, b.numeric,
                                                      b.label, b.mask)), row_len=b.row_len)
    return type(b)(*(np.array(a) for a in b))


def tenant_parts(model, wire):
    """The M host parts a tick's wire carried (the routed split of a host
    batch on the padded wire), copied."""
    from twtml_tpu_torch.features.batch import PackedBatch, unpack_batch
    from twtml_tpu_torch.models.sgd import _batch_at

    if isinstance(wire, PackedBatch):
        wire = unpack_batch(wire.buffer.copy(), wire.layout)
    if not model._is_tenant_wire(wire):
        return [copy_batch(p) for p in model.split(wire)]
    return [copy_batch(_batch_at(wire, m)) for m in range(model.num_tenants)]


def tenant_app_run(argv, statuses, app_module=None, expected_errors=(), sync_debug=True):
    """One app run on the tenant plane (``--tenants`` in ``argv``) from a
    pre-filled source of ``statuses`` (None: the source ``argv``
    configures), every dispatch under the sync-debug
    mode "error" unless ``sync_debug`` is False, B1's launch counters set to
    0 just before it and read just after. Records what the run's
    ``TenantStackModel`` saw and returned: each tick's M host parts and
    [M]-leading device StepOutput (the warm-up's apart, checked to train
    nothing), the host fetches it started (``fetch_output``), each stack
    ``set_initial_weights`` installed, the final stack, the tenant view,
    and the registry's guard counters and ``fetch.count`` as deltas."""
    import numpy as np
    import torch

    from twtml_tpu_torch.apps import linear_regression as app
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV
    from twtml_tpu_torch.ops import fused_sgd
    from twtml_tpu_torch.parallel import tenants
    from twtml_tpu_torch.telemetry import metrics, modelwatch
    from twtml_tpu_torch.telemetry import tenants as tenant_view

    rec = {"parts": [], "outputs": [], "fetches": 0, "restored": []}
    base = tenants.TenantStackModel

    class RecordedStack(base):
        def step(self, batch):
            rec["parts"].append(tenant_parts(self, batch))
            out = super().step(batch)
            rec["outputs"].append(out)
            rec["model"] = self
            return out

        def fetch_output(self, out):
            rec["fetches"] += 1
            return base.fetch_output(out)

        def set_initial_weights(self, weights):
            super().set_initial_weights(weights)
            rec["restored"].append(self._weights)
            return self

    reg = metrics.get_registry()
    keys = GUARD_COUNTERS + ("fetch.count",)
    before = {k: reg.counter(k).snapshot() for k in keys}
    base_source = app.build_source
    tenants.TenantStackModel = RecordedStack
    if statuses is not None:
        app.build_source = lambda conf, **_: prefilled_source(statuses)
    # the process-wide model watch keeps a track per tenant it has seen
    # (both packages): a run at another M starts from a fresh watch
    tenant_view.reset_for_tests()
    modelwatch.reset_for_tests()
    errors = ErrorLog()
    logging.getLogger("twtml_tpu_torch").addHandler(errors)
    if sync_debug:
        os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        fused_sgd.fused_dense_sgd.launches = 0
        fused_sgd.fused_dense_sgd.predict_launches = 0
        t0 = time.perf_counter()
        totals, lines = app_run(argv, app_module=app_module)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = fused_sgd.fused_dense_sgd.launches
        rec["predict_launches"] = fused_sgd.fused_dense_sgd.predict_launches
    finally:
        os.environ.pop(SYNC_DEBUG_ENV, None)
        logging.getLogger("twtml_tpu_torch").removeHandler(errors)
        tenants.TenantStackModel = base
        app.build_source = base_source
    unexpected = [r for r in errors.records
                  if not r.getMessage().startswith(tuple(expected_errors) or ("\0",))]
    if unexpected:
        raise AssertionError("the tenant run logged errors: " + "; ".join(
            f"{r.getMessage()} {r.exc_text or ''}" for r in unexpected))
    rec["counters"] = {k: int(reg.counter(k).snapshot() - before[k]) for k in keys}
    warm = rec["outputs"].pop(0)
    rec["parts"].pop(0)
    rec["fetches"] -= 1  # the warm-up's
    if warm.count.abs().sum().item() != 0:
        raise AssertionError("the tenant warm-up trained rows")
    rec["weights"] = rec["model"].latest_weights
    rec["view"] = tenant_view.last_tenants()
    return totals, lines, rec


def hold_standalone(name, argv, rec, learner_cls):
    """Each tenant against a standalone card learner of the app's
    configuration (its step size and L2) stepped on the tenant's parts:
    every tick's predictions, stats and quality and the final weights
    bitwise."""
    import torch

    from twtml_tpu_torch.config import ConfArguments

    model = rec["model"]
    conf = ConfArguments().parse(list(argv))
    singles = [learner_cls.from_conf(conf, step_size=model.step_sizes[m],
                                     l2_reg=model.l2_regs[m])
               for m in range(model.num_tenants)]
    for t, (out, parts) in enumerate(zip(rec["outputs"], rec["parts"], strict=True)):
        for m, (single, part) in enumerate(zip(singles, parts, strict=True)):
            ref = single.step(part)
            for k in ("predictions", "count", "mse", "real_stdev", "pred_stdev", "quality"):
                a, b = getattr(out, k), getattr(ref, k)
                if (a is None) != (b is None) or (a is not None and not torch.equal(a[m], b)):
                    raise AssertionError(f"{name} tick {t + 1} tenant {m}: {k} is not the "
                                         "standalone learner's")
    for m, single in enumerate(singles):
        if single.latest_weights.tobytes() != rec["weights"][m].tobytes():
            raise AssertionError(f"{name} tenant {m}: final weights are not the standalone "
                                 "learner's")


def tick_rate(totals):
    """Tweets/s over ticks 2..n (delivery to delivery)."""
    steps = totals["steps"]
    return (len(steps) - 1) * OP_ROWS / (steps[-1]["delivered_s"] - steps[0]["delivered_s"])


def trace_costs(profile_dir):
    """Per tick of a ``--profileDir`` run: host launches and copies by
    direction (``dispatch_costs``), and the device's busy ms over the whole
    traced stream (the union of its kernels, copies and sets)."""
    import glob

    path = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))[0]
    costs = dispatch_costs(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    b1 = sum(1 for e in events if e.get("cat") == "kernel" and KERNEL in e.get("name", ""))
    return costs, device_busy_ms(events), b1


def device_busy_ms(events):
    """The device's busy ms in a Chrome trace's events: the union of its
    kernels, copies and sets."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, cursor = 0.0, -math.inf
    for lo, hi in spans:
        lo = max(lo, cursor)
        if hi > lo:
            busy += hi - lo
            cursor = hi
    return busy / 1e3


def lang_statuses(n, seed):
    """``n`` synthetic tweets, every third original's text ending in a
    Latin-1 and CJK or a Cyrillic phrase: rows of three scripts for the
    ``lang`` key (at 4 tenants ASCII rows go to 0, Cyrillic to 1, CJK to 2;
    tenant 3 stays dry)."""
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    statuses = list(SyntheticSource(total=n, seed=seed, base_ms=NOW_MS).produce())
    for i, st in enumerate(statuses):
        if i % 3 == 0:
            st.retweeted_status.text += LANG_TAILS[(i // 3) % 2]
    return statuses


def tenants_phase(stream_statuses, smi):
    """The tenant plane on the card (module docstring, phase 21)."""
    import tempfile

    import numpy as np

    from twtml_tpu_torch.apps import logistic_regression
    from twtml_tpu_torch.apps.common import FORCE_TENANT_PLANE_ENV, SYNC_DEBUG_ENV
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD

    t_phase = time.perf_counter()
    n = TENANT_BATCHES
    statuses = stream_statuses[:n * OP_ROWS]
    argv = [*TENANT_ARGV, "--tenants", str(TENANT_M)]
    totals, lines, rec = tenant_app_run(argv, statuses)
    RECORDER.take()
    if (totals["batches"], totals["count"], totals["tenants"], len(rec["outputs"])) != (
            n, n * OP_ROWS, TENANT_M, n):
        raise AssertionError(f"tenants: {totals['batches']} ticks, {totals['count']} rows, "
                             f"{totals['tenants']} tenants, {len(rec['outputs'])} outputs")
    if (rec["launches"], rec["fetches"], rec["counters"]["fetch.count"]) != (
            TENANT_M * (n + 1), n, n) or rec["model"].route != "fused_dense_sgd":
        raise AssertionError(f"tenants: B1 launched {rec['launches']} times, "
                             f"{rec['fetches']} fetches started, fetch.count "
                             f"{rec['counters']['fetch.count']} for {n} ticks + the warm-up")
    hold_standalone("tenants M=4", argv, rec, StreamingLinearRegressionWithSGD)
    rows = [t["rows"] for t in rec["view"]["tenants"]]
    if sum(rows) != n * OP_ROWS:
        raise AssertionError(f"tenants: the view's rows {rows} for {n * OP_ROWS}")
    for line, st in zip(lines, totals["steps"]):
        phase("tenants", f"{line} | host wall {st['pack_ms'] + st['dispatch_ms'] + st['fetch_wait_ms']:.3f}"
              f" ms (route + split + stack {st['pack_ms']:.3f}, dispatch "
              f"{st['dispatch_ms']:.3f}, fetch wait {st['fetch_wait_ms']:.3f}), step "
              f"{st['step_ms']:.3f} ms (CUDA events, {TENANT_M} tenants)")
    phase("tenants", f"M = {TENANT_M}, hash key, ragged wire, {n} ticks of {OP_ROWS} under "
          f"set_sync_debug_mode('error'): B1 launched {rec['launches']} = {TENANT_M} x ({n} "
          f"ticks + the warm-up); {rec['fetches']} fetches for {n} ticks (fetch.count "
          f"{rec['counters']['fetch.count']}): one D2H a tick; rows a tenant {rows}; each "
          "tenant's predictions, stats, quality and final weights bitwise a standalone card "
          "learner stepped on its routed parts")

    twin = tenant_app_run([*argv, "--backend", "cpu"], statuses, sync_debug=False)
    RECORDER.take()
    if twin[1][:1] != lines[:1]:
        raise AssertionError(f"tenants: tick 1 {lines[:1]} != the CPU twin's {twin[1][:1]}")
    w_err, s_err = compare_twin("tenants", (totals, lines, rec), twin, RTOL)
    phase("tenants", f"against the --backend cpu twin: the [{TENANT_M}, 1004] stack "
          f"{w_err:.3g} of the largest weight, pooled stats {s_err:.3g} (tolerance "
          f"{RTOL:g}); tick 1's line identical")

    os.environ[FORCE_TENANT_PLANE_ENV] = "1"
    try:
        forced = tenant_app_run([*TENANT_ARGV, "--tenants", "1"], statuses)
    finally:
        del os.environ[FORCE_TENANT_PLANE_ENV]
    os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        plain = recorded_app_run(TENANT_ARGV, 0, source=prefilled_source(statuses))
    finally:
        del os.environ[SYNC_DEBUG_ENV]
    RECORDER.take()
    launches = (forced[2]["launches"], plain[2]["launches"])
    if (forced[1] != plain[1] or forced[2]["weights"].shape != (1, 1004)
            or forced[2]["weights"][0].tobytes() != plain[2]["weights"].tobytes()
            or launches != (n + 1, n + 1)):
        raise AssertionError("tenants: TWTML_FORCE_TENANT_PLANE=1 --tenants 1 is not the "
                             f"plain run (lines equal {forced[1] == plain[1]}, B1 launched "
                             f"{launches} times)")
    phase("tenants", f"TWTML_FORCE_TENANT_PLANE=1 at --tenants 1: the plain run's {n} lines "
          f"and its weights bitwise, B1 launched {forced[2]['launches']} times as there")

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        poisoned = tenant_app_run(
            [*argv, "--checkpointDir", ck, "--checkpointEvery", "1", "--chaos", "source.nan@3"],
            statuses, expected_errors=GUARD_ERRORS)
        RECORDER.take()
        verified, meta = archive(ck, step=2)
    prec = poisoned[2]
    expect("tenants poisoned", prec["counters"],
           {"model.rollbacks": 1, "model.rows_lost": 0, "model.sentinel_aborts": 0})
    rolled = prec["restored"][-1].cpu().numpy()
    if (poisoned[0]["batches"], poisoned[0]["count"]) != (n, n * OP_ROWS) \
            or rolled.shape != (TENANT_M, 1004) or rolled.tobytes() != verified.tobytes() \
            or prec["weights"].tobytes() != rec["weights"].tobytes() \
            or poisoned[1] != lines or prec["counters"]["journal.replayed_rows"] <= 0:
        raise AssertionError("tenants: the poisoned run did not roll the whole stack back to "
                             "the verified checkpoint and end as the clean run")
    phase("tenants", f"--chaos source.nan@3 with a checkpoint every tick: 1 rollback of the "
          f"whole [{TENANT_M}, 1004] stack, bitwise the verified archive of tick "
          f"{meta.get('step')}; {prec['counters']['journal.replayed_rows']} rows replayed, 0 "
          f"lost; the final stack and the {n} lines bitwise the clean run's; B1 launched "
          f"{prec['launches']} times ({n + 1} ticks + the warm-up, x {TENANT_M})")

    two = two_class_statuses(n * OP_ROWS, 13)
    lg_argv = [*TENANT_ARGV, "--tenants", "2"]
    lg = tenant_app_run(lg_argv, two, app_module=logistic_regression)
    hold_standalone("tenants logistic M=2", lg_argv, lg[2], StreamingLogisticRegressionWithSGD)
    if lg[2]["launches"] != 2 * (n + 1) or lg[0]["batches"] != n:
        raise AssertionError(f"tenants logistic: B1 launched {lg[2]['launches']} times")
    lang_argv = [*argv, "--tenantKey", "lang"]
    lang = tenant_app_run(lang_argv, lang_statuses(n * OP_ROWS, 7))
    RECORDER.take()
    hold_standalone("tenants lang M=4", lang_argv, lang[2], StreamingLinearRegressionWithSGD)
    lang_rows = [t["rows"] for t in lang[2]["view"]["tenants"]]
    dry = [m for m, r in enumerate(lang_rows) if r == 0]
    if sum(r > 0 for r in lang_rows) < 2 or not dry or lang[2]["weights"][dry].any():
        raise AssertionError(f"tenants lang: rows a tenant {lang_rows}")
    phase("tenants", f"the logistic app at M = 2 ({lg[1][-1]}) and --tenantKey lang at M = "
          f"{TENANT_M} (rows a tenant {lang_rows}: dry tenant(s) {dry} with finite stats and "
          "zero weights): each tenant bitwise its standalone card learner; B1 launched "
          f"{lg[2]['launches']} and {lang[2]['launches']} times")

    with tempfile.TemporaryDirectory() as tmp:
        prof = tenant_app_run([*argv, "--profileDir", os.path.join(tmp, "m4")], statuses)
        p_m4 = trace_costs(os.path.join(tmp, "m4"))
        recorded_app_run([*TENANT_ARGV, "--profileDir", os.path.join(tmp, "m1")], 0,
                         source=prefilled_source(statuses))
        p_m1 = trace_costs(os.path.join(tmp, "m1"))
    RECORDER.take()
    if [c["d2h"] for c in p_m4[0]] != [1] * n:
        raise AssertionError(f"tenants: D2H copies a tick {[c['d2h'] for c in p_m4[0]]}")
    out = {"M": TENANT_M}
    for name, run, (costs, busy_ms, b1) in (("M=4", (totals, rec), p_m4),
                                             ("M=1", plain, p_m1)):
        steps = run[0]["steps"][1:]
        host = statistics.mean(st["pack_ms"] + st["dispatch_ms"] + st["fetch_wait_ms"]
                               for st in steps)
        out[name] = {"host_wall_ms_a_tick": host, "device_busy_ms_a_tick": busy_ms / n,
                     "launches_a_tick": statistics.mean(c["launches"] for c in costs),
                     "b1_a_tick": b1 / n, "d2h_a_tick": statistics.mean(c["d2h"] for c in costs),
                     "h2d_a_tick": statistics.mean(c["h2d"] for c in costs),
                     "tweets_per_s": tick_rate(run[0])}
        phase("tenants", f"{name}: host wall {host:.3f} ms a tick (ticks 2-{n}: route/split/"
              f"pack + dispatch + fetch wait), device busy {busy_ms / n:.3f} ms a tick "
              f"(profiler), {out[name]['launches_a_tick']:.0f} host launches a tick "
              f"({b1 / n:.0f} of B1), {out[name]['h2d_a_tick']:.0f} H2D and "
              f"{out[name]['d2h_a_tick']:.0f} D2H copies a tick; {out[name]['tweets_per_s']:.0f}"
              f" tweets/s over ticks 2-{n}")
    out.update(rows_a_tenant=rows, lang_rows=lang_rows, twin_weights_err=w_err,
               twin_stats_err=s_err, launches=rec["launches"],
               launches_logistic=lg[2]["launches"], launches_lang=lang[2]["launches"],
               launches_poisoned=prec["launches"], profiled_stream_s=prof[0]["stream_seconds"])
    out["vmap"], out["grid_record"] = tenant_vmap_phase(argv, rec, smi, lg_argv, lg[2])
    phase("tenants", f"phase wall {time.perf_counter() - t_phase:.1f} s | card: {smi}")
    return out


def tenant_vmap_phase(argv, rec, smi, lg_argv, lg_rec):
    """The vmap arm of the tenants phase: B1's tenant grid against its plain
    version and its times (``tenant_grid_checks``), then the vmap form
    against the scan form on the linear app run ``rec``'s parts (the
    grid's main path, timed too) and on the logistic app run ``lg_rec``'s
    (the grid's logistic mode) (``tenant_vmap_arm``). Returns (the arm's
    summary, the grid's kernels line record with the arm's launches)."""
    from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD as L

    t0 = time.perf_counter()
    record = tenant_grid_checks(smi)
    summary, record["launches"] = tenant_vmap_arm(argv, rec, smi)
    knobs = dict(residual_fn=L.residual_fn, prediction_fn=L.prediction_fn,
                 round_predictions=L.round_predictions,
                 step_size=lg_rec["model"].step_sizes[0])
    summary["logistic"], record["launches_logistic"] = tenant_vmap_arm(
        lg_argv, lg_rec, smi, knobs=knobs, timing=False)
    record["vmap_tick"] = summary
    phase("tenants", f"vmap arm wall {time.perf_counter() - t0:.1f} s")
    return summary, record


# ---- phase 21, its vmap arm: B1's tenant grid (ROADMAP B10) ------------------

# tests/test_torch_tenants_vmap.py's tolerance of the vmap form against the
# JAX vmap, which is that far from its own scan form
VMAP_RTOL = VMAP_ATOL = 1e-3
# a rounded prediction of the vmap form may differ from the scan form's by
# one HALF_UP step only where the f64 margin lies this close to a tie
VMAP_TIE = 1e-3
TENANT_SKEW = (1, 3, 0, 12)  # the skewed parts' rows, in 1024s: tenant 2 dry
TENANT_STEPS = (0.005, 0.002, 0.01, 0.005)
TENANT_L2S = (0.0, 0.1, 0.01, 0.0)
TENANT_LG_STEPS = (0.5, 1.0, 0.5, 2.0)  # the logistic mode's, on 0/1 labels


def tenant_grid_text_values(clean, labels01, w0s, w_clean, kw, lg_kw):
    """Text columns holding what no bigram count is (a 300 in a valid row of
    tenant 0 and a 2.5 in one of tenant 1; then a NaN in a valid row of
    tenant 3) against the plain version in both residual modes: the NaN
    held to the twin's pattern in tenant 3, the other tenants bitwise the
    clean run's. Returns the max abs errors."""
    import torch

    errs = []
    xs, ys, ms = clean
    last = {t: int(torch.nonzero(ms[t])[-1]) for t in (0, 1, 3)}  # tenant 2 is dry
    odd = xs.clone()
    odd[0, last[0], 5] = 300.0
    odd[1, last[1], 17] = 2.5
    nan = xs.clone()
    nan[3, last[3], 999] = float("nan")
    for mode, (labels, case_kw) in (("least squares", (ys, kw)),
                                    ("logistic", (labels01, lg_kw))):
        errs.append(tenant_grid_case(f"1:3:0:12 a count of 300 and a 2.5, {mode}", odd, labels,
                                     ms, w0s, **case_kw)[3])
        w_n, _, _, err = tenant_grid_case(f"1:3:0:12 NaN in a text column, {mode}", nan,
                                          labels, ms, w0s, **case_kw)
        errs.append(err)
        if not torch.isnan(w_n[3]).all():
            raise AssertionError(f"tenant grid NaN in a text column ({mode}): tenant 3 finite")
        if mode == "least squares" and not torch.equal(bits(w_n[:3]), bits(w_clean[:3])):
            raise AssertionError("tenant grid NaN in a text column: it left tenant 3")
    return errs


def tenant_grid_many(x, y, labels01, m, w0, kw, lg_kw):
    """The grid at M = 16 (B/16 valid rows each) and M = 32 (31 parts of
    B/32 valid rows and a dry one, tests' PLAN_CASES["thirty_two_tenants"])
    in parts of the B rows of ``x``, both residual modes, against the plain
    version. Returns the max abs errors."""
    import torch

    errs = []
    b = x.shape[0]
    for rows in ([b // 16] * 16, [b // 32] * 31 + [0]):
        n = len(rows)
        scale = torch.linspace(-2.0, 2.0, n, device=x.device)[:, None]
        w0s = (w0[None] * scale).contiguous()
        cyc = lambda vals: [vals[t % len(vals)] for t in range(n)]  # noqa: E731
        for mode, labels, case_kw in (("least squares", y, kw), ("logistic", labels01, lg_kw)):
            parts = tenant_grid_parts(x, labels, m, rows)
            case_kw = dict(case_kw, step_sizes=cyc(case_kw["step_sizes"]),
                           l2_regs=cyc(case_kw["l2_regs"]))
            errs.append(tenant_grid_case(f"M = {n}, {mode}", *parts, w0s, **case_kw)[3])
            del parts
    return errs


def tenant_ptxas():
    """Registers and spills (ptxas) of each tenant_sgd_kernel instantiation:
    the two residual modes and their timing (probe) instantiations."""
    import re

    from twtml_tpu_torch.ops import _build

    path = _build.library_path("fused_sgd")
    log = path.with_name(path.name + ".log")
    out = {}
    for block in ptxas_blocks(log.read_text() if log.exists() else "", "tenant_sgd_kernel"):
        inst = re.search(r"tenant_sgd_kernelILb(\d)ELb(\d)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        if inst and regs and spills:
            name = ("logistic" if inst.group(1) == "1" else "least_squares") + (
                "_probe" if inst.group(2) == "1" else "")
            out[name] = (int(regs.group(1)), (int(spills.group(1)), int(spills.group(2))))
    return out


def tenant_grid_parts(x, y, m, rows, dirty=False):
    """M parts [M, B, F] (B the rows of ``x``): part t holds the next
    ``rows[t]`` rows of (x, y, m) at its front, the rest masked. With
    ``dirty`` the first quarter of part 1's rows is masked too (rows the
    kernel reads and must mask), then NaN fills X and y of every masked row
    and +Inf every third one's X (past a part's valid rows the kernel must
    never read them)."""
    import torch

    b, f = x.shape
    n = len(rows)
    xs = torch.zeros((n, b, f), device=x.device)
    ys = torch.zeros((n, b), device=x.device)
    ms = torch.zeros((n, b), device=x.device)
    at = 0
    for t, v in enumerate(rows):
        xs[t, :v], ys[t, :v], ms[t, :v] = x[at:at + v], y[at:at + v], m[at:at + v]
        at += v
    if dirty:
        ms[1, : rows[1] // 4] = 0.0
        off = ms == 0
        xs[off] = float("nan")
        ys[off] = float("nan")
        third = torch.zeros_like(off)
        third[:, ::3] = True
        xs[off & third] = float("inf")
    return xs, ys, ms


def tenant_grid_case(name, xs, ys, ms, w0, reruns=1, **kw):
    """B1's tenant grid against its plain version (M calls of B1's twin) on
    the card: weights and preds within RTOL/ATOL where the twin's are
    finite, the twin's NaN/Inf pattern elsewhere, ``reruns`` reruns bitwise
    equal. Returns (w, preds, each tenant's iterations run, max abs err)."""
    import torch

    from twtml_tpu_torch.features.batch import tenant_valid_rows
    from twtml_tpu_torch.ops import fused_sgd

    valid = tenant_valid_rows(ms.cpu().numpy())
    w, p = fused_sgd.fused_dense_sgd_tenants(xs, ys, ms, w0, valid_rows=valid, **kw)
    iters = [int(v) for v in fused_sgd.fused_dense_sgd_tenants.last_iterations.tolist()]
    for _ in range(reruns):
        w2, p2 = fused_sgd.fused_dense_sgd_tenants(xs, ys, ms, w0, valid_rows=valid, **kw)
        if not (torch.equal(bits(w), bits(w2)) and torch.equal(bits(p), bits(p2))):
            raise AssertionError(f"tenant grid {name}: reruns are not bitwise equal")
    w_ref, p_ref = fused_sgd.fused_dense_sgd_tenants_reference(xs, ys, ms, w0, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for what, got, want in (("weights", w, w_ref), ("preds", p, p_ref)):
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(test(got), test(want)):
                raise AssertionError(f"tenant grid {name} {what}: {test.__name__} pattern "
                                     f"differs: kernel {int(test(got).sum())}, twin "
                                     f"{int(test(want).sum())}")
        fin = torch.isfinite(want)
        if fin.any():
            err = max(err, compare(f"tenant grid {name} {what}", got[fin], want[fin])[0])
    for t, v in enumerate(valid):
        if v == 0 and (iters[t] != 0 or not torch.equal(bits(w[t]), bits(w0[t]))
                       or p[t].abs().max().item() != 0.0):
            raise AssertionError(f"tenant grid {name}: dry tenant {t} moved")
    shown = valid if len(valid) <= 4 else f"{len(valid)} tenants, {sum(valid)} rows"
    phase("tenants", f"tenant grid {name}: valid rows {shown}, iterations run "
          f"{iters if len(iters) <= 4 else sorted(set(iters))}; weights and preds within rtol "
          f"{RTOL} atol {ATOL} of the plain version (max abs err {err:.2e}); {reruns} rerun(s) "
          "bitwise equal")
    return w, p, iters, err


def tenant_grid_checks(smi):
    """B1's tenant grid (``fused_dense_sgd_tenants``, csrc/fused_sgd.cu
    ``tenant_sgd_kernel``) on the card at the operating point's width:
    against its plain version in both residual modes on skewed parts
    (1 : 3 : 0 : 12 thousand rows, a dry tenant, per-tenant step sizes and
    L2s), bitwise unmoved by NaN/Inf in masked rows (past the valid rows and
    inside them), a NaN label in one tenant (its NaN pattern the twin's,
    every iteration run, the others finite), parts of 16 rows; then at 4 x
    4096 valid rows in parts of 16384 its device time (median of 20 runs of
    5 calls, queued behind ``split_queued``'s long sleep, in turns) against
    the 4 single B1 launches on the same parts, B1 on the 16384 rows as one
    batch and the grid with those rows as one tenant; the plain version's
    time, and its bound. Returns the kernels line's
    record (launches are the vmap arm's)."""
    import torch

    from twtml_tpu_torch.features.batch import tenant_valid_rows
    from twtml_tpu_torch.ops import fused_sgd

    dev = torch.device("cuda")
    x, y, m, w0 = op_point_inputs(dev)
    b, f = x.shape
    w0s = (w0[None] * torch.tensor([1.0, -1.0, 2.0, 0.5], device=dev)[:, None]).contiguous()
    kw = dict(num_iterations=OP_ITERS, step_sizes=TENANT_STEPS, l2_regs=TENANT_L2S)
    skew = [r * 1024 for r in TENANT_SKEW]
    errs = []
    clean = tenant_grid_parts(x, y, m, skew)
    w_c, p_c, _, err = tenant_grid_case("1:3:0:12", *clean, w0s, **kw)
    errs.append(err)
    dirty = tenant_grid_parts(x, y, m, skew, dirty=True)
    holed = (clean[0], clean[1], dirty[2])  # the same mask without the garbage
    w_h, p_h, _, err = tenant_grid_case("1:3:0:12 part 1 holed", *holed, w0s, **kw)
    w_d, p_d, _, err_d = tenant_grid_case("1:3:0:12 NaN/Inf in masked rows", *dirty, w0s, **kw)
    errs += [err, err_d]
    if not (torch.equal(bits(w_h), bits(w_d)) and torch.equal(bits(p_h), bits(p_d))):
        raise AssertionError("tenant grid: NaN/Inf in masked rows reached the results")
    labels01 = op_point_labels(dev)
    lg = tenant_grid_parts(x, labels01, m, skew)
    lg_kw = dict(kw, step_sizes=TENANT_LG_STEPS, residual_fn=fused_sgd.logistic_residual)
    _, _, lg_iters, err = tenant_grid_case("1:3:0:12 logistic", *lg, w0s, **lg_kw)
    errs.append(err)
    xs, ys, ms = (t.clone() for t in clean)
    row = int(torch.nonzero(ms[3])[0])
    ys[3, row] = float("nan")
    w_n, _, n_iters, err = tenant_grid_case("1:3:0:12 NaN label in tenant 3", xs, ys, ms,
                                            w0s, **kw)
    errs.append(err)
    if (n_iters[3] != OP_ITERS or not torch.isnan(w_n[3]).all()
            or not torch.isfinite(w_n[[0, 1, 2]]).all()
            or not torch.equal(bits(w_n[[0, 1, 2]]), bits(w_c[[0, 1, 2]]))):
        raise AssertionError(f"tenant grid NaN label: tenant 3 ran {n_iters[3]} iterations; "
                             "the NaN must stay in tenant 3")
    small = tenant_grid_parts(x[:16].contiguous(), y[:16].contiguous(), m[:16].contiguous(),
                              [1, 3, 0, 12])
    errs.append(tenant_grid_case("B=16 1:3:0:12", *small, w0s, **kw)[3])
    none = tenant_grid_parts(x, y, m, [0, 0, 0, 0])
    errs.append(tenant_grid_case("all dry", *none, w0s, **kw)[3])
    errs += tenant_grid_text_values(clean, lg[1], w0s, w_c, kw, lg_kw)
    errs += tenant_grid_many(x, y, labels01, m, w0, kw, lg_kw)

    # the operating point: 4 parts of 16384 rows, 4096 valid each
    even = tenant_grid_parts(x, y, m, [b // 4] * 4)
    one = dict(num_iterations=OP_ITERS, step_size=0.005)
    kw_even = dict(num_iterations=OP_ITERS, step_sizes=[0.005] * 4, l2_regs=[0.0] * 4)
    valid = tenant_valid_rows(even[2].cpu().numpy())
    _, _, iters, err = tenant_grid_case("4 x 4096", *even, w0s, reruns=3, **kw_even)
    errs.append(err)
    plan = fused_sgd.tenant_launch_plan(valid, f, **sm_limits())
    resident = sum(min(rows, plan.resident) for _, _, rows in plan.entries())
    grid_call = lambda: fused_sgd.fused_dense_sgd_tenants(  # noqa: E731
        *even, w0s, valid_rows=valid, **kw_even)
    singles = lambda: [fused_sgd.fused_dense_sgd(  # noqa: E731
        even[0][t], even[1][t], even[2][t], w0s[t], **one) for t in range(4)]
    together = lambda: fused_sgd.fused_dense_sgd(x, y, m, w0, **one)  # noqa: E731
    # the grid with one tenant of the 16384 rows: B1's work and grid, the
    # tenant's view and its per-tenant decisions, one tenant's reduce
    x1, y1, m1, w1 = (t[None].contiguous() for t in (x, y, m, w0))
    valid1 = tenant_valid_rows(m1.cpu().numpy())
    grid_one = lambda: fused_sgd.fused_dense_sgd_tenants(  # noqa: E731
        x1, y1, m1, w1, valid_rows=valid1, num_iterations=OP_ITERS, step_sizes=[0.005],
        l2_regs=[0.0])
    calls = (("grid", grid_call), ("singles", singles), ("together", together),
             ("grid_one", grid_one))
    rounds = {name: [] for name, _ in calls}
    for _ in range(2):  # in turns, forwards then backwards
        for name, fn in (*calls, *calls[::-1]):
            rounds[name].append(split_queued(fn, 5, n=5))
    ms_of = {k: statistics.median([r for v in runs for r in v[1]])
             for k, runs in rounds.items()}
    b1_iters = []
    for t in range(4):
        fused_sgd.fused_dense_sgd(even[0][t], even[1][t], even[2][t], w0s[t], **one)
        b1_iters.append(int(fused_sgd.fused_dense_sgd.last_iterations.item()))
    plain_ms, _ = timed(lambda: fused_sgd.fused_dense_sgd_tenants_reference(
        *even, w0s, **kw_even), 3)
    # the function's bytes: each valid row of X, its label and mask read
    # once, w0 read, w and every pred written; its operations: each
    # tenant's iterations run over its valid rows (X·w0 the first one's)
    rows = sum(valid)
    io_bytes = rows * f * 4 + 2 * 4 * rows + 2 * 4 * 4 * f + 4 * 4 * b
    flops = sum(it * (4 * v * f + 6 * f) if it else 2 * v * f for it, v in zip(iters, valid))
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    ptxas = tenant_ptxas()
    regs, spills = ptxas["least_squares"]
    probe = grid_probe(even, w0s, **kw_even)
    probe_one = grid_probe((x1, y1, m1), w1, num_iterations=OP_ITERS, step_sizes=[0.005],
                           l2_regs=[0.0])
    phase("tenants", f"tenant grid at 4 x 4096 valid rows in parts of B={b}, F={f}, "
          f"{OP_ITERS} iterations (card: {smi}): plan grid {plan.grid} CTAs "
          f"{plan.first_cta}, {plan.rows_cap} rows a CTA at most, {plan.resident} resident: "
          f"{resident} of the {sum(valid)} valid rows resident, {sum(valid) - resident} "
          f"spilled; {plan.shared_bytes} B shared; "
          f"registers and spill stores/loads (ptxas) {ptxas}; iterations run {iters} (B1 on "
          f"each part: {b1_iters})")
    phase("tenants", f"tenant grid probe at 4 x 4096: {probe_text(probe)}")
    phase("tenants", f"tenant grid probe, one tenant of the 16384 rows: {probe_text(probe_one)}")
    phase("tenants", f"device time a call, median of 20 runs of 5 calls queued behind "
          f"{SPLIT_AHEAD_CYCLES} cycles of sleep, in turns: the tenant grid "
          f"{ms_of['grid']:.4f} ms; the 4 single B1 launches on the same parts "
          f"{ms_of['singles']:.4f} ms; B1 on the 16384 rows as one batch "
          f"{ms_of['together']:.4f} ms; the grid with one tenant of those 16384 rows "
          f"{ms_of['grid_one']:.4f} ms; the plain version {plain_ms:.4f} ms; bound: bytes "
          f"{io_bytes} B = {bytes_ms:.5f} ms, operations {flops} = {ops_ms:.5f} ms: the "
          f"kernel at {ms_of['grid'] / bound_ms:.1f}x")
    return {
        "name": "fused_dense_sgd_tenants", "route": "cuda",
        "source": "twtml_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "twtml_tpu/ops/pallas_sgd.py:55 (_sgd_kernel under the tenant "
                    "stack's jax.vmap, twtml_tpu/parallel/tenants.py:330)",
        "tpu_function": "_sgd_kernel", "launches": 0, "max_abs_err": max(errs),
        "ms": ms_of["grid"], "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "library_ms": None,
        "b1_singles_ms": ms_of["singles"], "b1_one_batch_ms": ms_of["together"],
        "one_tenant_ms": ms_of["grid_one"],
        "runs_ms": {k: [r for v in runs for r in v[1]] for k, runs in rounds.items()},
        "iterations_run": iters, "b1_iterations_run": b1_iters,
        "logistic_iterations_run": lg_iters, "grid": plan.grid,
        "shared_bytes": plan.shared_bytes, "registers": regs, "spills": spills,
        "ptxas": ptxas, "resident": resident, "spilled": sum(valid) - resident, "probe": probe,
        "probe_one_tenant": probe_one, "shape": [4, b, f], "valid_rows": valid, "card": smi,
    }


def grid_probe(parts, w0s, runs=5, **kw):
    """The tenant grid's phase split on ``parts`` (the timing
    instantiation, ``runs`` launches): the median over the launches of
    each phase's mean (``fused_sgd.tenant_probe_split``), the µs an iteration, the probe
    launch's device ms (CUDA events) and iterations stamped."""
    import torch

    from twtml_tpu_torch.features.batch import tenant_valid_rows
    from twtml_tpu_torch.ops import fused_sgd

    valid = tenant_valid_rows(parts[2].cpu().numpy())
    kw = dict(kw, valid_rows=valid, probe_iterations=kw["num_iterations"])
    splits = []
    for _ in range(runs + 1):  # the first a warm-up
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        stamps = fused_sgd.tenant_grid_probe(*parts, w0s, **kw)[3]
        end.record()
        end.synchronize()
        splits.append((fused_sgd.tenant_probe_split(stamps), start.elapsed_time(end)))
    splits = splits[1:]
    med = lambda xs: statistics.median(xs)  # noqa: E731
    prologue = {k: med([s[0][0][k] for s in splits]) for k in fused_sgd.PROBE_PROLOGUE}
    phases = {k: med([s[0][1][k] for s in splits]) for k in fused_sgd.PROBE_PHASES}
    return {"prologue_us": prologue, "iteration_us": phases,
            "us_an_iteration": sum(phases.values()),
            "iterations_stamped": splits[0][0][2], "span_us": med([s[0][3] for s in splits]),
            "probe_launch_ms": med([s[1] for s in splits])}


def probe_text(split):
    return (f"prologue {', '.join(f'{k} {v:.2f}' for k, v in split['prologue_us'].items())} "
            f"µs; an iteration {split['us_an_iteration']:.2f} µs: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split["iteration_us"].items())
            + f" ({split['iterations_stamped']} iterations stamped, the first left out; "
            f"span {split['span_us']:.1f} µs, the probe launch {split['probe_launch_ms']:.4f} "
            "ms with its event pair)")


def grid_ab_times(runs=5):
    """The tenant grid at 4 x 4096 valid rows in parts of B = OP_ROWS and
    with those rows as one tenant, on the port this process imports:
    device ms a call (5 calls queued behind the long sleep, the median of
    ``runs``; in turns, twice), B1 on the same rows as one batch beside
    them, and, where the port has the timing instantiation, each grid's
    phase split (``grid_probe``)."""
    import torch

    from twtml_tpu_torch.features.batch import tenant_valid_rows
    from twtml_tpu_torch.ops import fused_sgd

    dev = torch.device("cuda")
    x, y, m, w0 = op_point_inputs(dev)
    b, _ = x.shape
    w0s = (w0[None] * torch.tensor([1.0, -1.0, 2.0, 0.5], device=dev)[:, None]).contiguous()
    even = tenant_grid_parts(x, y, m, [b // 4] * 4)
    kw_even = dict(num_iterations=OP_ITERS, step_sizes=[0.005] * 4, l2_regs=[0.0] * 4)
    one = (x[None].contiguous(), y[None].contiguous(), m[None].contiguous())
    kw_one = dict(num_iterations=OP_ITERS, step_sizes=[0.005], l2_regs=[0.0])
    valid, valid1 = (tenant_valid_rows(p[2].cpu().numpy()) for p in (even, one))
    calls = (("grid", lambda: fused_sgd.fused_dense_sgd_tenants(
                 *even, w0s, valid_rows=valid, **kw_even)),
             ("one_tenant", lambda: fused_sgd.fused_dense_sgd_tenants(
                 *one, w0[None].contiguous(), valid_rows=valid1, **kw_one)),
             ("b1", lambda: fused_sgd.fused_dense_sgd(x, y, m, w0, num_iterations=OP_ITERS,
                                                      step_size=0.005)))
    runs_ms = {name: [] for name, _ in calls}
    for _ in range(2):  # in turns, forwards then backwards
        for name, fn in (*calls, *calls[::-1]):
            runs_ms[name] += split_queued(fn, runs, n=5)[1]
    out = {f"{k}_ms": statistics.median(v) for k, v in runs_ms.items()}
    out["runs_ms"] = runs_ms
    if hasattr(fused_sgd, "tenant_grid_probe"):
        out["probe"] = grid_probe(even, w0s, **kw_even)
        out["probe_one_tenant"] = grid_probe(one, w0[None].contiguous(), **kw_one)
    return out


# one arm of an A/B mode (``--grid-ab``, ``--split-ab``, ``--tsplit-ab``, ``--dual-ab``,
# ``--wb-ab``):
# the port found in argv[1], this chip_smoke (argv[2]) for its inputs and
# timing, its function argv[3]; the result as the last line
AB_RUN = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("chip_smoke_ab", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import twtml_tpu_torch
out = getattr(cs, sys.argv[3])()
out["package"] = twtml_tpu_torch.__file__
print(json.dumps(out), flush=True)
"""


def ab_pairs(label, fn, pairs, parent_root, report, timeout=900):
    """``pairs`` pairs of an A/B mode's runs: ``fn`` (this chip_smoke's
    function of that name, returning a dict) on the port found in
    ``parent_root`` and on this checkout's, each in a process of its own,
    the order alternating; ``report(pair, arm, record)`` after each run.
    Returns each arm's records, with their pair and position."""
    roots = {"parent": parent_root, "change": HERE}
    runs = {"parent": [], "change": []}
    for i in range(pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for arm in order:
            res = subprocess.run([sys.executable, "-c", AB_RUN, roots[arm],
                                  os.path.join(HERE, "chip_smoke.py"), fn],
                                 capture_output=True, text=True, timeout=timeout)
            lines = res.stdout.splitlines()
            if res.returncode != 0 or not lines or not lines[-1].startswith("{"):
                raise AssertionError(f"{label} {arm} pair {i}: exit {res.returncode}:\n"
                                     f"{res.stderr[-4000:]}")
            rec = json.loads(lines[-1])
            if os.path.dirname(os.path.dirname(rec["package"])) != roots[arm]:
                raise AssertionError(f"{label} {arm}: imported {rec['package']}")
            rec.update(pair=i, position=order.index(arm))
            runs[arm].append(rec)
            report(i, arm, rec)
    return runs


def ptxas_blocks(text, kernel):
    """The ptxas report's blocks (an entry function's header line and the
    lines up to the next) of every instantiation of ``kernel``."""
    blocks, keep = [], False
    for line in text.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
            if keep:
                blocks.append([])
        if keep:
            blocks[-1].append(line.strip())
    return ["\n".join(b) for b in blocks]


def grid_ab(smi, pairs, parent_root):
    """``--grid-ab N --package-root DIR``: the tenant grid at 4 x 4096 valid
    rows and the one-tenant grid (``grid_ab_times``), the port found in
    DIR (e.g. the parent commit unpacked there) against this checkout's,
    each arm in a process of its own, N pairs, the order alternating; the
    probe's split where a tree has it; each tree's ptxas report."""
    import glob

    def report(i, arm, rec):
        phase("grid-ab", f"pair {i} {arm} (run {rec['position'] + 1} of 2): the grid at 4 "
              f"x 4096 {rec['grid_ms']:.4f} ms, one tenant {rec['one_tenant_ms']:.4f} ms, "
              f"B1 on the 16384 rows {rec['b1_ms']:.4f} ms (median of 20 runs of 5 calls)")
        for key in ("probe", "probe_one_tenant"):
            if key in rec:
                phase("grid-ab", f"pair {i} {arm} {key}: {probe_text(rec[key])}")

    roots = {"parent": parent_root, "change": HERE}
    runs = ab_pairs("grid-ab", "grid_ab_times", pairs, parent_root, report)
    keys = ("grid_ms", "one_tenant_ms", "b1_ms")
    medians = {arm: {k: statistics.median(r[k] for r in rows) for k in keys}
               for arm, rows in runs.items()}
    pair_of = lambda arm: sorted(runs[arm], key=lambda r: r["pair"])  # noqa: E731
    wins = {k: sum(c[k] < p[k] for c, p in zip(pair_of("change"), pair_of("parent")))
            for k in keys}
    for arm, root in roots.items():
        for log in glob.glob(os.path.join(root, "build", "twtml_tpu_torch", "libfused_sgd-*.log")):
            phase("grid-ab", f"{arm} build ({os.path.basename(log)}), tenant_sgd_kernel:\n"
                  + "\n".join(ptxas_blocks(open(log).read(), "tenant_sgd_kernel")))
    phase("grid-ab", f"medians over {pairs} pairs: the grid {medians['change']['grid_ms']:.4f} "
          f"ms against the parent's {medians['parent']['grid_ms']:.4f}, lower in "
          f"{wins['grid_ms']} of {pairs} pairs; one tenant "
          f"{medians['change']['one_tenant_ms']:.4f} against "
          f"{medians['parent']['one_tenant_ms']:.4f}, lower in {wins['one_tenant_ms']}; B1 "
          f"{medians['change']['b1_ms']:.4f} against {medians['parent']['b1_ms']:.4f} | card: "
          f"{smi}")
    print(json.dumps({"grid_ab": {"pairs": pairs, "runs": runs, "medians": medians,
                                  "change_wins": wins, "card": smi}}), flush=True)


def ab_summary(runs, keys):
    """An A/B mode's medians by arm over its runs and, for each key, the
    pairs in which the change's run was lower than the parent's."""
    medians = {arm: {k: statistics.median(r[k] for r in rows) for k in keys}
               for arm, rows in runs.items()}
    pair_of = lambda arm: sorted(runs[arm], key=lambda r: r["pair"])  # noqa: E731
    wins = {k: sum(c[k] < p[k] for c, p in zip(pair_of("change"), pair_of("parent")))
            for k in keys}
    return medians, wins


WB_AB_FORMS = ("single_int8", "single_f32", "tenants", "data_axis")


def wb_ab_times(runs=5):
    """B8 in each of its forms on the port this process imports, 50 calls
    back to back behind ``split_queued``'s sleep (the median of ``runs``),
    the forms in turns, twice: the single form on config #4's synthetic
    batch (the int8 plane) and on tweet-length rows (the f32 plane), the
    tenant form at the 2^18 vmap arm's 4 parts and at a data axis's rank 0
    rows of each block (``tm_time_inputs``). A tree whose B8 reads the
    count build's C gets its C, built once beforehand."""
    import inspect
    import tempfile

    import numpy as np
    import torch

    from twtml_tpu_torch.ops import fused_gram

    tokens = "token_idx" in inspect.signature(fused_gram.dual_writeback_tenants).parameters
    rng = np.random.default_rng(27)
    cuda = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    calls = {}
    short, _, short_idx, short_val = gram_tweet_batch(GRAM_ROWS)
    for form, (dev, idx, val) in (("single_int8", (short, short_idx, short_val)),
                                  ("single_f32", long_tweet_tokens())):
        b = idx.shape[0]
        w, alpha = cuda(rng.normal(size=GRAM_F + 4) * 1e-2), cuda(rng.normal(size=b) * 1e-3)
        calls[form] = b8_call(fused_gram, w, torch.tensor(0.97, device="cuda"), alpha, idx, val,
                              dev.numeric, GRAM_F, form == "single_int8")[0]
    x = sv_time_inputs()
    m, b = x.mask.shape
    c = cuda(rng.uniform(0.9, 1.0, m))
    alpha = cuda(rng.normal(size=(m, b)) * 1e-3)
    out = torch.empty_like(x.w)
    if tokens:
        calls["tenants"] = lambda: fused_gram.dual_writeback_tenants(
            x.w, c, alpha, x.idx, x.val, x.num, GRAM_F, valid_rows=x.valid, out=out)
    else:
        counts, at = fused_gram.count_build_tenants(x.idx, x.val, GRAM_F, valid_rows=x.valid,
                                                    int8=True)
        calls["tenants"] = lambda: fused_gram.dual_writeback_tenants(
            x.w, c, alpha, counts, x.num, GRAM_F, valid_rows=x.valid, tenants=range(m), at=at,
            out=out)
    with tempfile.TemporaryDirectory() as tmp:
        short = ma_statuses(MA_SHORT_SPAN, GRAM_ROWS, 2, 23)
        t = tm_time_inputs(ma_unit_batches(os.path.join(tmp, "short.npz"), short, GRAM_ROWS,
                                           GRAM_F, MA_UNITS)[1])
    mine, zeros, delta = t.table.mine(), torch.zeros_like(t.w), torch.empty_like(t.w)
    alpha_b = cuda(rng.normal(size=tuple(t.mask.shape)) * 1e-3)
    c_b = cuda(rng.uniform(0.9, 1.0, m))
    kw = dict(valid_rows=[n for _, n in mine], first_rows=[o for o, _ in mine])
    if tokens:
        calls["data_axis"] = lambda: fused_gram.dual_writeback_tenants(
            zeros, c_b, alpha_b, t.idx, t.val, t.num, GRAM_F, out=delta,
            token_rows=[t.table.rank * t.table.rows] * m, **kw)
    else:
        counts_b, at_b = fused_gram.count_build_tenants(
            t.idx, t.val, GRAM_F, valid_rows=t.table.totals, int8=True,
            segments=t.table.segments())
        calls["data_axis"] = lambda: fused_gram.dual_writeback_tenants(
            zeros, c_b, alpha_b, counts_b, t.num, GRAM_F, out=delta, tenants=range(m), at=at_b,
            **kw)
    runs_ms = {form: [] for form in WB_AB_FORMS}
    for _ in range(2):  # in turns, forwards then backwards
        for form in (*WB_AB_FORMS, *WB_AB_FORMS[::-1]):
            runs_ms[form] += split_queued(calls[form], runs)[1]
    out = {f"{k}_ms": statistics.median(v) for k, v in runs_ms.items()}
    out.update(runs_ms=runs_ms, reads_c=not tokens)
    return out


def wb_ab(smi, pairs, parent_root):
    """``--wb-ab N --package-root DIR``: B8's four forms (``wb_ab_times``),
    the port found in DIR (e.g. the parent commit unpacked there) against
    this checkout's, each arm in a process of its own, N pairs, the order
    alternating; each tree's ptxas report of writeback_kernel."""
    import glob

    keys = tuple(f"{k}_ms" for k in WB_AB_FORMS)

    def report(i, arm, rec):
        phase("wb-ab", f"pair {i} {arm} (run {rec['position'] + 1} of 2"
              f"{', B8 reads C' if rec['reads_c'] else ''}): "
              + ", ".join(f"{k[:-3]} {rec[k]:.4f} ms" for k in keys))

    runs = ab_pairs("wb-ab", "wb_ab_times", pairs, parent_root, report)
    medians, wins = ab_summary(runs, keys)
    for arm, root in {"parent": parent_root, "change": HERE}.items():
        for log in glob.glob(os.path.join(root, "build", "twtml_tpu_torch", "libgram-*.log")):
            phase("wb-ab", f"{arm} build ({os.path.basename(log)}), writeback_kernel:\n"
                  + "\n".join(ptxas_blocks(open(log).read(), "writeback_kernel")))
    phase("wb-ab", f"medians over {pairs} pairs, the change against the parent: "
          + "; ".join(f"{k[:-3]} {medians['change'][k]:.4f} ms against "
                      f"{medians['parent'][k]:.4f}, lower in {wins[k]} of {pairs}" for k in keys)
          + f" | card: {smi}")
    print(json.dumps({"wb_ab": {"pairs": pairs, "runs": runs, "medians": medians,
                                "change_wins": wins, "card": smi}}), flush=True)


def tick_inputs(model, parts):
    """A tick's dense X [M, B, F] on the card, decoded by the port's ops
    from the wire the model packs of ``parts``."""
    import torch

    from twtml_tpu_torch.features.batch import PackedBatch, unpack_batch
    from twtml_tpu_torch.models.sgd import batch_to_device, decode_batch, flatten_tenants
    from twtml_tpu_torch.ops.sparse import densify_text

    dev = batch_to_device(model.prepare_wire_from_parts(parts), model.device)
    if isinstance(dev, PackedBatch):
        dev = unpack_batch(dev.buffer, dev.layout)
    idx, val, num, _, mask = decode_batch(flatten_tenants(dev), model.num_text_features,
                                          torch.float32)
    x = torch.cat([densify_text(idx, val, model.num_text_features), num], dim=1)
    return x.view(model.num_tenants, mask.shape[0] // model.num_tenants, -1)


def tenant_ticks(model, ticks, profile_dir=None, sync_debug=False):
    """``model``'s steps over ``ticks`` (lists of M parts), one fetch each,
    each tick's pack, step and fetch in a ``twtml.dispatch`` region (under
    the sync-debug mode "error" with ``sync_debug``), then its wait.
    Returns (host results, host wall ms a tick: pack + step + fetch +
    wait). With ``profile_dir`` the ticks after the first run under
    ``torch.profiler``, whose Chrome trace lands there."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    outs, walls = [], []

    def tick(parts):
        t0 = time.perf_counter()
        if sync_debug:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with record_function("twtml.dispatch"):
                pending = model.fetch_output(model.step(model.prepare_wire_from_parts(parts)))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        pending.wait()
        walls.append((time.perf_counter() - t0) * 1e3)
        outs.append(pending.result())

    tick(ticks[0])
    if profile_dir is None:
        for parts in ticks[1:]:
            tick(parts)
        return outs, walls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for parts in ticks[1:]:
            tick(parts)
    prof.export_chrome_trace(os.path.join(profile_dir, "ticks.pt.trace.json"))
    return outs, walls


def hold_vmap_tick(k, ov, os_, x, w_prev, logistic=False):
    """Tick ``k`` of the vmap form (host results ``ov``) against the scan
    form's (``os_``) on the same parts: counts equal; predictions equal but
    where one step lies between them and the f64 margin X·w_prev (``x`` the
    tick's dense X on the card, or a function of ``w_prev`` that gives the
    margins, ``w_prev`` the scan stack before it) is within VMAP_TIE of a
    tie (a HALF_UP half, or 0 for the ``logistic`` learner's class); the
    stats and the quality vector within VMAP_RTOL / VMAP_ATOL. Returns
    (flips, largest relative stat difference)."""
    import numpy as np
    import torch

    if not np.array_equal(ov.count, os_.count):
        raise AssertionError(f"tenants vmap tick {k}: counts {ov.count} != scan's {os_.count}")
    diff = ov.predictions != os_.predictions
    if diff.any():
        raw = (x(w_prev) if callable(x) else
               torch.bmm(x.double(), w_prev.double()[..., None])[..., 0]).cpu().numpy()
        tie = np.abs(raw) if logistic else np.abs(raw - (np.floor(raw) + 0.5))
        near = (np.abs(ov.predictions - os_.predictions) == 1) & (tie < VMAP_TIE)
        if (diff & ~near).any():
            raise AssertionError(f"tenants vmap tick {k}: {int((diff & ~near).sum())} "
                                 "rounded predictions differ from the scan form's away from "
                                 "a tie")
    worst = 0.0
    for f in ("mse", "real_stdev", "pred_stdev", "quality"):
        a = np.asarray(getattr(ov, f), np.float64)
        b = np.asarray(getattr(os_, f), np.float64)
        if not np.isfinite(a).all() or (np.abs(a - b) > VMAP_ATOL + VMAP_RTOL * np.abs(b)).any():
            raise AssertionError(f"tenants vmap tick {k}: {f} {a} against the scan form's {b}")
        worst = max(worst, float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max()))
    return int(diff.sum()), worst


def tenant_vmap_arm(argv, rec, smi, knobs=None, timing=True):
    """The tenant plane's vmap form at full width, library level (the JAX
    package reaches it only so): ``TenantStackModel.from_conf`` of the
    phase's configuration with ``mapping="vmap"`` and the scan form, each
    stepped on the app run's routed parts (its ticks, after a warm-up tick
    of all padding), one fetch a tick; ``knobs`` are the learner's (the
    logistic one's residual, prediction and step size). The vmap form's
    ticks are the main path of B1's tenant grid: every dispatch under the
    sync-debug mode "error", the grid's count from 0 (a launch a tick) and
    B1's (none). Each tick held against the scan form's
    (``hold_vmap_tick``), the final stacks within VMAP_RTOL / VMAP_ATOL;
    then, with ``timing``, each form's host wall a tick (in turns: vmap,
    scan, scan, vmap), and from a profiled pass its device busy ms,
    launches and copies a tick. Returns (summary, launches)."""
    import tempfile

    import numpy as np

    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.ops import fused_sgd
    from twtml_tpu_torch.parallel.tenants import TenantStackModel

    conf = ConfArguments().parse(list(argv))
    knobs = knobs or {}
    logistic = "residual_fn" in knobs
    m_tenants = rec["model"].num_tenants
    warm = [copy_batch(p) for p in rec["parts"][0]]
    for p in warm:
        p.mask[:] = 0.0
    ticks = [warm, *rec["parts"]]
    n = len(ticks) - 1
    vmap = TenantStackModel.from_conf(conf, mapping="vmap", **knobs)
    scan = TenantStackModel.from_conf(conf, **knobs)
    if vmap.route != "fused_dense_sgd" or vmap.mapping != "vmap":
        raise AssertionError(f"tenants vmap: route {vmap.route}, mapping {vmap.mapping}")
    fused_sgd.fused_dense_sgd_tenants.launches = 0
    fused_sgd.fused_dense_sgd.launches = 0
    v_outs, _ = tenant_ticks(vmap, ticks, sync_debug=True)
    launches = fused_sgd.fused_dense_sgd_tenants.launches
    b1_in_vmap = fused_sgd.fused_dense_sgd.launches
    if launches != n + 1 or b1_in_vmap != 0:
        raise AssertionError(f"tenants vmap: the tenant grid launched {launches} times, B1 "
                             f"{b1_in_vmap}, for {n} ticks + the warm-up")
    fused_sgd.fused_dense_sgd.launches = 0
    flips, worst, prev = 0, 0.0, []
    s_outs = []
    for parts in ticks:
        prev.append(scan._weights.clone())
        s_outs.append(tenant_ticks(scan, [parts])[0][0])
    if fused_sgd.fused_dense_sgd.launches != m_tenants * (n + 1):
        raise AssertionError(f"tenants vmap: the scan form launched B1 "
                             f"{fused_sgd.fused_dense_sgd.launches} times")
    for k, (parts, ov, os_, w_prev) in enumerate(zip(ticks, v_outs, s_outs, prev)):
        f_k, w_k = hold_vmap_tick(k, ov, os_, tick_inputs(scan, parts), w_prev, logistic)
        flips, worst = flips + f_k, max(worst, w_k)
    w_v, w_s = vmap.latest_weights.astype(np.float64), scan.latest_weights.astype(np.float64)
    if not np.allclose(w_v, w_s, rtol=VMAP_RTOL, atol=VMAP_ATOL) or not np.isfinite(w_v).all():
        raise AssertionError("tenants vmap: the final stack is not the scan form's within "
                             f"rtol {VMAP_RTOL} atol {VMAP_ATOL}")
    w_err = float(np.abs(w_v - w_s).max())
    phase("tenants", f"vmap form, {'logistic' if logistic else 'linear'} learner at M = "
          f"{m_tenants} (library level, {conf.numTextFeatures + 4} dims, B = {OP_ROWS}, the "
          f"app run's {n} ticks of routed ragged parts + a warm-up of padding, --modelWatch "
          f"on): B1's tenant grid launched {launches} times (a tick), B1 {b1_in_vmap}, every "
          f"dispatch under the sync-debug mode \"error\"; each tick against the scan form's "
          f"({m_tenants * (n + 1)} B1 launches): counts equal, {flips} prediction(s) a step "
          f"apart within {VMAP_TIE} of a tie, stats and quality within {worst:.2e} "
          f"(tolerance rtol {VMAP_RTOL} atol {VMAP_ATOL}); the final [{m_tenants}, "
          f"{w_v.shape[1]}] stacks {w_err:.2e} apart at most")
    out = {"ticks": n, "launches": launches, "b1_launches_scan": m_tenants * (n + 1),
           "flips": flips, "stats_rel_err": worst, "weights_abs_err": w_err}
    if not timing:
        return out, launches

    walls = {"vmap": [], "scan": []}
    for mapping in ("vmap", "scan", "scan", "vmap"):
        walls[mapping] += tenant_ticks(TenantStackModel.from_conf(conf, mapping=mapping),
                                       ticks)[1][1:]
    with tempfile.TemporaryDirectory() as tmp:
        for mapping in ("vmap", "scan"):
            where = os.path.join(tmp, mapping)
            os.makedirs(where)
            tenant_ticks(TenantStackModel.from_conf(conf, mapping=mapping), ticks,
                         profile_dir=where)
            costs, busy_ms, b1 = trace_costs(where)
            with open(os.path.join(where, "ticks.pt.trace.json")) as fh:
                grid = sum(1 for e in json.load(fh)["traceEvents"] if e.get("cat") == "kernel"
                           and "tenant_sgd_kernel" in e.get("name", ""))
            out[mapping] = {
                "host_wall_ms_a_tick": statistics.median(walls[mapping]),
                "host_wall_ms": walls[mapping],
                "device_busy_ms_a_tick": busy_ms / n,
                "launches_a_tick": statistics.mean(c["launches"] for c in costs),
                "b1_a_tick": b1 / n, "tenant_grid_a_tick": grid / n,
                "h2d_a_tick": statistics.mean(c["h2d"] for c in costs),
                "d2h_a_tick": statistics.mean(c["d2h"] for c in costs),
            }
            o = out[mapping]
            phase("tenants", f"{mapping} tick (library level, the {n} ticks after the "
                  f"warm-up): host wall "
                  f"median {o['host_wall_ms_a_tick']:.3f} ms (pack + step + fetch + wait, "
                  f"8 runs of each form in turns); device busy {o['device_busy_ms_a_tick']:.3f}"
                  f" ms, {o['launches_a_tick']:.0f} host launches ({o['b1_a_tick']:.0f} of B1,"
                  f" {o['tenant_grid_a_tick']:.0f} of the tenant grid), {o['h2d_a_tick']:.0f} "
                  f"H2D and {o['d2h_a_tick']:.0f} D2H copies a tick (profiler) | card: {smi}")
    if out["vmap"]["d2h_a_tick"] != 1:
        raise AssertionError(f"tenants vmap: {out['vmap']['d2h_a_tick']} D2H copies a tick")
    return out, launches


# ---- the 2^18 vmap arm: B4, B7 and B8's tenant forms (ROADMAP B10 c) --------

SV_M = 4  # the ticks' tenants
SV_TICKS = 5  # ticks after the warm-up
SV_LONG_ROWS = 3  # tweet-length rows a tick in the mixed-planes ticks
SV_LONG_SPAN = (200, 280)  # their code units: row mass past 127 (the bf16 or exact plane)
SV_TIME_RUNS = 5
SV_KERNELS = ("count_build_tenants", "dual_sgd_tenants", "dual_writeback_tenants")
# the kernel holds: (name, each part's valid rows, a part's rows, options)
SV_CASES = (
    ("M=1 of 2048 rows", (2048,), 2048, {}),
    ("M=2", (700, 1300), 2048, {}),
    ("M=4 config #4", (512, 530, 498, 508), 2048, {}),
    ("M=4 skew 1:3:0:12", (100, 300, 0, 1200), 2048, {}),
    ("M=4 a tenant at 4096 rows", (4096, 200, 0, 50), 4096, {}),
    ("M=16", tuple(48 + 13 * t for t in range(15)) + (0,), 256, {}),
    ("M=40 (two launches of each form)", tuple(30 + 5 * t for t in range(39)) + (0,), 256, {}),
    ("M=4 logistic", (512, 530, 498, 508), 2048, {"logistic": True}),
    ("M=4 -b 0.5", (512, 530, 498, 508), 2048, {"sampled": True}),
    ("M=4 tol 0", (512, 530, 498, 508), 2048, {"tol": 0.0}),
    ("M=4 tenants 0 and 2 freeze early", (512, 530, 498, 508), 2048, {"near": (0, 2)}),
    ("M=4 every tenant freezes (the launch ends early)", (512, 530, 0, 508), 2048,
     {"near": (0, 1, 3)}),
    ("M=4 f32 counts (row mass 128)", (512, 530, 498, 508), 2048, {"peak": 128}),
    ("M=4 exact plane (fractional)", (300, 0, 700, 64), 2048, {"fractional": True}),
)


def sv_inputs(rng, valid, rows, peak=0, fractional=False):
    """M parts of ``rows`` rows at F = 2^18 on the card: part m's first
    valid[m] rows tweet-like tokens (``gram_tokens``; part 0's row 0 at
    ``peak``), the rest padding; ~10 % of the valid rows masked, each part's
    last valid row kept; numeric features, u = Z·W_prev and labels."""
    import numpy as np
    import torch

    m, tokens = len(valid), 48
    idx = np.zeros((m, rows, tokens), np.int32)
    val = np.zeros((m, rows, tokens), np.float32)
    mask = np.zeros((m, rows), np.float32)
    for t, v in enumerate(valid):
        if v:
            idx[t, :v], val[t, :v] = gram_tokens(rng, v, peak if t == 0 else 0, fractional)
            mask[t, :v] = rng.random(v) < 0.9
            mask[t, v - 1] = 1.0
    num = (rng.normal(size=(m, rows, 4)) * 0.1).astype(np.float32)
    u = (rng.normal(size=(m, rows)) * 10).astype(np.float32)
    y = rng.uniform(50, 900, size=(m, rows)).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in (idx, val, num, mask, u, y))


def tenant_barriers(valid, its, mask, masks, tol):
    """The grid barriers each launch of B7's tenant form crosses by the
    schedule's model (``fused_gram.dual_tenants_barriers``), from the
    iterations each tenant ran; None where a launch's one tenant has
    iterations whose draws select none of its rows (not counted)."""
    from twtml_tpu_torch.ops import fused_gram

    out = []
    for lo in range(0, len(valid), fused_gram.TENANTS_PER_LAUNCH):
        part = list(valid[lo:lo + fused_gram.TENANTS_PER_LAUNCH])
        live = [lo + t for t, v in enumerate(part) if v]
        selects = "all"
        if len(live) == 1:
            rows = mask[live[0], :valid[live[0]]]
            counts = (rows[None] if masks is None else rows * masks[:, :valid[live[0]]]).sum(1)
            selects = ("all" if bool((counts > 0).all()) else "some" if bool(counts.any())
                       else "none")
        out.append(fused_gram.dual_tenants_barriers(
            part, its[lo:lo + len(part)], num_iterations=OP_ITERS, convergence_tol=tol,
            selects=selects))
    return out


def sv_check_case(name, valid, rows, opts, errs, rng):
    """One hold of the three tenant forms on ``valid``'s parts: B4's tenant
    form bitwise its plain version and each tenant's block bitwise B4 on
    its valid rows; B7's within RTOL/ATOL of its plain version with the same
    iterations run by each tenant, NaN/Inf in masked rows bitwise ignored;
    B8's within WEIGHT_RTOL of its plain version and each tenant's row
    bitwise B8 on the same rows; every rerun bitwise. Returns the line."""
    import torch

    from twtml_tpu_torch.models.sgd import sampling_masks
    from twtml_tpu_torch.ops import fused_gram
    from twtml_tpu_torch.ops.fused_sgd import logistic_residual

    idx, val, num, mask, u, y = sv_inputs(rng, valid, rows, opts.get("peak", 0),
                                          opts.get("fractional", False))
    m = len(valid)
    int8 = not (opts.get("peak") or opts.get("fractional"))
    counts, at = fused_gram.count_build_tenants(idx, val, GRAM_F, valid_rows=valid, int8=int8)
    again, _ = fused_gram.count_build_tenants(idx, val, GRAM_F, valid_rows=valid, int8=int8)
    plain, plain_at = fused_gram.count_build_tenants_reference(
        idx, val, GRAM_F, valid_rows=valid, int8=int8, cols_out=counts.shape[1])
    torch.cuda.synchronize()
    if not torch.equal(counts, again) or plain_at != at or not torch.equal(counts, plain):
        raise AssertionError(f"count_build_tenants {name}: not bitwise its plain version "
                             "(or a rerun)")
    for t, v in enumerate(valid):
        if v:
            single = fused_gram.count_build(idx[t, :v].contiguous(), val[t, :v].contiguous(),
                                            GRAM_F, int8=int8)
            if not torch.equal(counts[at[t]:at[t] + single.shape[0]], single):
                raise AssertionError(f"count_build_tenants {name}: tenant {t}'s block is not "
                                     "B4's on its rows")
    del plain, again
    gs = fused_gram.tenant_gram_blocks(counts, at, valid)
    logistic = opts.get("logistic", False)
    labels = (y > 475).float() if logistic else y.clone()
    for t in opts.get("near", ()):  # labels near the margins: the tenant's test converges early
        labels[t] = u[t] + torch.from_numpy(rng.normal(size=rows).astype("float32")).to(u)
    kw = dict(num_iterations=OP_ITERS, convergence_tol=opts.get("tol", 0.001),
              step_sizes=[0.1 if logistic else 0.005 * (1 + t % 3) for t in range(m)],
              l2_regs=[(0.1, 0.0, 0.01)[t % 3] for t in range(m)],
              residual_fn=logistic_residual if logistic else None)
    kw = {k: v for k, v in kw.items() if v is not None}
    masks = (sampling_masks(rows, OP_ITERS, 0.5, torch.float32, idx.device)
             if opts.get("sampled") else None)
    p_prev = (torch.full((m,), 1.5, device=idx.device) if opts.get("near")
              else torch.rand(m, device=idx.device) * 3)
    args = (gs, u, labels, mask, num)
    c, alpha, its = fused_gram.dual_sgd_tenants(*args, valid_rows=valid, masks=masks,
                                                p_prev=p_prev, **kw)
    barriers = fused_gram.dual_sgd_tenants.last_barriers
    c2, alpha2, its2 = fused_gram.dual_sgd_tenants(*args, valid_rows=valid, masks=masks,
                                                   p_prev=p_prev, **kw)
    keep = mask > 0
    dirty = (gs, torch.where(keep, u, float("nan")), torch.where(keep, labels, float("inf")),
             mask, torch.where(keep[..., None], num, float("nan")))
    c3, alpha3, its3 = fused_gram.dual_sgd_tenants(*dirty, valid_rows=valid, masks=masks,
                                                   p_prev=p_prev, **kw)
    c_r, alpha_r, its_r = fused_gram.dual_sgd_tenants_reference(
        *args, valid_rows=valid, masks=masks, p_prev=p_prev, **kw)
    torch.cuda.synchronize()
    for what, (cc, aa, ii) in (("a rerun", (c2, alpha2, its2)),
                               ("NaN/Inf in masked rows", (c3, alpha3, its3))):
        if not (torch.equal(c, cc) and torch.equal(alpha, aa) and torch.equal(its, ii)):
            raise AssertionError(f"dual_sgd_tenants {name}: {what} is not bitwise equal")
    if not torch.equal(its, its_r.to(its.dtype)):
        raise AssertionError(f"dual_sgd_tenants {name}: iterations run {its.tolist()}, the "
                             f"plain version {its_r.tolist()}")
    crossed = [int(x) for x in barriers]
    want = tenant_barriers(valid, [int(i) for i in its.tolist()], mask, masks,
                           kw["convergence_tol"])
    if any(w is not None and w != x for w, x in zip(want, crossed)) or len(want) != len(crossed):
        raise AssertionError(f"dual_sgd_tenants {name}: {crossed} grid barriers crossed by its "
                             f"launches, the schedule's model {want}")
    early = [t for t in opts.get("near", ()) if not int(its[t]) < OP_ITERS]
    if early or any(int(its[t]) != OP_ITERS for t in range(m)
                    if valid[t] and t not in opts.get("near", ()) and opts.get("near")):
        raise AssertionError(f"dual_sgd_tenants {name}: iterations run {its.tolist()}: the "
                             f"tenants {opts.get('near')} were to freeze early, the others not")
    ea, _ = compare(f"dual_sgd_tenants {name} alpha", alpha, alpha_r)
    ec, _ = compare(f"dual_sgd_tenants {name} c", c, c_r)
    single_note = ""
    if m == 1:  # B7 on the same rows: G with N·Nᵀ added by the library product
        v = valid[0]
        g = gs[0].float()
        g[:v, :v] += num[0, :v] @ num[0, :v].T
        c1, a1, i1 = fused_gram.dual_sgd(
            g, u[0, :v].contiguous(), labels[0, :v].contiguous(), mask[0, :v].contiguous(),
            masks=None if masks is None else masks[:, :v].contiguous(), p_prev=p_prev[0],
            num_iterations=OP_ITERS, step_size=kw["step_sizes"][0], l2_reg=kw["l2_regs"][0],
            convergence_tol=kw["convergence_tol"])
        torch.cuda.synchronize()
        if int(i1) != int(its[0]):
            raise AssertionError(f"dual_sgd_tenants {name}: {int(its[0])} iterations, B7 "
                                 f"{int(i1)}")
        e1, _ = compare(f"dual_sgd_tenants {name} against B7", alpha[0, :v], a1)
        same = torch.equal(alpha[0, :v], a1) and torch.equal(c[0], c1)
        single_note = (f"; against B7 on the same rows (the same kernel over a table of "
                       f"one, G holding N·Nᵀ from the library product; here N·Nᵀ added in "
                       f"the prologue): {'bitwise equal' if same else f'max abs err {e1:.3e}'}")
    w = (torch.randn(m, GRAM_F + 4, device=idx.device) * 1e-2).contiguous()
    err = sv_writeback_hold(name, w, c, alpha, idx, val, num, valid)
    for key, e in zip(SV_KERNELS, (0.0, max(ea, ec), err)):
        errs[key] = max(errs[key], e)
    return (f"{name}: valid rows {list(valid)} of {rows}, {'int8' if int8 else 'f32'} counts "
            f"{tuple(counts.shape)}; B4's tenant form bitwise its plain version and B4 on each "
            f"tenant's rows; B7's iterations run {[int(i) for i in its.tolist()]} (the plain "
            f"version's), grid barriers {crossed} (the schedule's), max abs err alpha "
            f"{ea:.3e} c {ec:.3e}{single_note}, NaN/Inf in "
            f"masked rows bitwise ignored; B8's within {err:.3e} of its plain "
            "version, each row bitwise B8 on the same rows; reruns bitwise")


def sv_writeback_hold(name, w, c, alpha, idx, val, num, valid):
    """B8's tenant form on the card over every part of [M, B, L] tokens
    (``dual_writeback_tenants``): a rerun bitwise; within WEIGHT_RTOL (atol
    WEIGHT_RTOL·max(1, max|w|)) of its plain version; each tenant's row
    bitwise B8 (``dual_writeback_counts``) on its rows and its text columns
    bitwise the kernel's order on the host; a dry tenant's row exactly
    c·W. Returns the max abs error."""
    import torch

    from twtml_tpu_torch.ops import fused_gram

    wb = fused_gram.dual_writeback_tenants(w, c, alpha, idx, val, num, GRAM_F, valid_rows=valid)
    wb2 = fused_gram.dual_writeback_tenants(w, c, alpha, idx, val, num, GRAM_F, valid_rows=valid)
    wb_r = fused_gram.dual_writeback_tenants_reference(w, c, alpha, idx, val, num, GRAM_F,
                                                       valid_rows=valid)
    torch.cuda.synchronize()
    if not torch.equal(bits(wb), bits(wb2)):
        raise AssertionError(f"dual_writeback_tenants {name}: a rerun is not bitwise equal")
    err = (wb - wb_r).abs()
    atol = WEIGHT_RTOL * max(1.0, wb_r.abs().max().item())
    if (err > atol + WEIGHT_RTOL * wb_r.abs()).any() or not torch.isfinite(wb).all():
        raise AssertionError(f"dual_writeback_tenants {name}: its plain version differs by "
                             f"{err.max().item():.3e}")
    for t, v in enumerate(valid):
        if v:
            rows = [x[t, :v].contiguous() for x in (alpha, idx, val, num)]
            single = fused_gram.dual_writeback_counts(w[t], c[t], *rows, GRAM_F)
            order = fused_gram.dual_writeback_in_order(w[t], c[t], *rows, GRAM_F)
            if not torch.equal(bits(single), bits(wb[t])):
                raise AssertionError(f"dual_writeback_tenants {name}: tenant {t}'s row is not "
                                     "B8's on its rows")
            if not torch.equal(bits(wb[t, :GRAM_F]), bits(order[:GRAM_F])):
                raise AssertionError(f"dual_writeback_tenants {name}: tenant {t}'s text "
                                     "columns differ bitwise from the kernel's order")
        elif not torch.equal(bits(wb[t]), bits(w[t] * c[t])):
            raise AssertionError(f"dual_writeback_tenants {name}: dry tenant {t} moved")
    return err.max().item()


# B8's tenant form's skew holds: (name, each part's valid rows, a part's
# rows, how the tokens land)
SV_WB_CASES = (
    ("M=4 config #4, every tenant's tokens in 85 hot columns", (512, 530, 498, 508), 2048,
     "hot"),
    ("M=4 skew 1:3:0:12, every token of every tenant in one column", (100, 300, 0, 1200), 2048,
     "one column"),
    ("M=4 tweet-length rows (L = 511, f32 values)", (300, 0, 700, 64), 1024, "long"),
    ("M=40, two launches, padding in column 0", tuple(30 + 5 * t for t in range(39)) + (0,),
     256, "padding"),
)


def sv_writeback_inputs(rng, valid, rows, how):
    """[M, rows, L] tokens on the card for ``SV_WB_CASES``, α, c and the
    numeric rows; each part's rows past its valid ones padding."""
    import numpy as np
    import torch

    m = len(valid)
    tokens = 511 if how == "long" else 63
    idx = np.zeros((m, rows, tokens), np.int32)
    val = np.zeros((m, rows, tokens), np.float32)
    hot = rng.choice(GRAM_F, 85, replace=False)
    for t, v in enumerate(valid):
        if how == "hot":
            idx[t, :v] = hot[rng.integers(0, 85, (v, tokens))]
            val[t, :v] = rng.integers(1, 3, (v, tokens))
        elif how == "one column":
            idx[t, :v], val[t, :v] = GRAM_F // 3, rng.integers(1, 3, (v, tokens))
        elif how == "long":
            idx[t, :v] = rng.integers(0, GRAM_F, (v, tokens))
            val[t, :v] = rng.normal(size=(v, tokens))
        else:
            idx[t, :v], val[t, :v] = gram_tokens(rng, v, 0, tokens=tokens)
    alpha = (rng.normal(size=(m, rows)) * 1e-3).astype(np.float32)
    num = (rng.normal(size=(m, rows, 4)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(m, GRAM_F + 4)) * 1e-2).astype(np.float32)
    c = rng.uniform(0.9, 1.0, m).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in (w, c, alpha, idx, val, num))


def sv_checks():
    """The tenant forms' holds (``sv_check_case``) over SV_CASES: M = 1, 2,
    4, 16 and 40 (past TENANTS_PER_LAUNCH: consecutive launches), a dry
    tenant, a tenant at 4096 rows, the 1 : 3 : 0 : 12 skew,
    the logistic mode, ``-b 0.5`` masks, tolerance 0 and 0.001, int8 and f32
    counts; then B8's tenant form alone over SV_WB_CASES (hot columns, one
    column for every tenant, tweet-length rows, M = 40 with padding).
    Returns (max abs errors by kernel, the cases' names)."""
    import numpy as np

    rng = np.random.default_rng(2323)
    errs = dict.fromkeys(SV_KERNELS, 0.0)
    for name, valid, rows, opts in SV_CASES:
        phase("tenants-sparse", "kernel hold " + sv_check_case(name, valid, rows, opts, errs,
                                                              rng))
    for name, valid, rows, how in SV_WB_CASES:
        w, c, alpha, idx, val, num = sv_writeback_inputs(rng, valid, rows, how)
        err = sv_writeback_hold(name, w, c, alpha, idx, val, num, valid)
        errs["dual_writeback_tenants"] = max(errs["dual_writeback_tenants"], err)
        phase("tenants-sparse", f"kernel hold dual_writeback_tenants {name}: valid rows "
              f"{list(valid)} of {rows}, L={idx.shape[2]}; within {err:.3e} of its plain "
              "version, each tenant's row bitwise B8 on its rows and its text columns bitwise "
              "the kernel's order, a dry tenant exactly c·W; rerun bitwise")
    return errs, [c[0] for c in SV_CASES] + [f"dual_writeback_tenants {c[0]}"
                                             for c in SV_WB_CASES]


def sv_ticks(kind, ticks=SV_TICKS):
    """``ticks`` host batches of GRAM_ROWS synthetic tweets (seed 11) at
    2^18 for ``kind``: "short" (the int8 plane), "mixed" (SV_LONG_ROWS of
    each batch's rows tweet-length: their tenants' parts leave the int8
    plane) or "scatter" (the short tweets, for the scatter route)."""
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    statuses = list(SyntheticSource(total=ticks * GRAM_ROWS, seed=11, base_ms=NOW_MS).produce())
    if kind == "mixed":
        longs = long_statuses([SV_LONG_SPAN], SV_LONG_ROWS * ticks, 17)
        for k in range(ticks):
            for j in range(SV_LONG_ROWS):
                at = k * GRAM_ROWS + (j + 1) * GRAM_ROWS // (SV_LONG_ROWS + 1)
                statuses[at] = longs[k * SV_LONG_ROWS + j]
    feat = Featurizer(num_text_features=GRAM_F, now_ms=NOW_MS)
    return [feat.featurize_batch_ragged(statuses[k * GRAM_ROWS:(k + 1) * GRAM_ROWS],
                                        row_bucket=GRAM_ROWS, pre_filtered=True)
            for k in range(ticks)]


def sv_model(mapping, kind):
    from twtml_tpu_torch.parallel.tenants import TenantStackModel

    return TenantStackModel(SV_M, mapping=mapping, num_text_features=GRAM_F, step_size=0.005,
                            l2_reg=0.1, quality=True, use_gram=False if kind == "scatter" else None,
                            device="cuda")


def sv_margins(model, parts):
    """A function of the stack before a tick that gives the tick's f64
    margins [M, B] on the card (``hold_vmap_tick``'s ``x``)."""
    import torch

    from twtml_tpu_torch.models.sgd import batch_to_device, decode_batch, flatten_tenants
    from twtml_tpu_torch.ops.sparse import sparse_predict

    dev = batch_to_device(model.prepare_wire_from_parts(parts), model.device)
    idx, val, num, _, mask = decode_batch(flatten_tenants(dev), GRAM_F, torch.float32)
    m = SV_M
    rows = mask.shape[0] // m

    def raw(w):
        w = w.double()
        return sparse_predict(w[:, :GRAM_F], w[:, GRAM_F:], idx.view(m, rows, -1),
                              val.view(m, rows, -1).double(), num.view(m, rows, -1).double())

    return raw


def sv_expected(model, ticks):
    """The vmap form's launches over ``ticks`` on the Gram route: a tick
    launches B4's tenant form once a plane its tenants with rows hold (a dry
    tenant rides with the first tenant with rows), B7's and B8's once (B8
    reads the tokens, whatever the planes), and one G product a tenant with
    rows."""
    from twtml_tpu_torch.ops.gram import PLANE_INT8

    want = dict.fromkeys(SV_KERNELS, 0)
    want["products"] = 0
    for parts in ticks:
        wire = model.prepare_wire_from_parts(parts)
        planes, valid = model.planes(wire), model.valid_rows(wire)
        held = {planes[t] == PLANE_INT8 for t in range(SV_M) if valid[t]}
        want["count_build_tenants"] += len(held)
        want["dual_writeback_tenants"] += 1
        want["dual_sgd_tenants"] += 1
        want["products"] += sum(1 for v in valid if v)
    return want


def sv_scan_expected(kind, ticks):
    """The scan form's launches over ``ticks`` ticks: on the Gram route B4,
    B7 and B8 once a tenant (its padded part, a dry one's too), none of the
    tenant forms; on the scatter route no kernel."""
    per = 0 if kind == "scatter" else SV_M * ticks
    return dict(dict.fromkeys(SV_KERNELS, 0), count_build=per, dual_sgd=per,
                dual_writeback_counts=per)


def sv_tick_arm(kind, smi, timing=False):
    """The tenant plane's vmap form at config #4 (2^18, step 0.005, L2 0.1,
    GRAM_ROWS tweets a tick routed to SV_M tenants, model watch on),
    library level, against the scan form on the same parts: a warm-up tick
    of all padding, then SV_TICKS ticks. Its ticks are the main path of the
    tenant forms on the Gram route: every dispatch under the sync-debug
    mode "error", the counts from 0 (one B4 a plane present, one B7 and one
    B8 a tick, M G products; B4, B7 and B8 themselves none), against scan's
    M of each. Each tick within VMAP_RTOL / VMAP_ATOL of scan's, HALF_UP
    flips counted (``hold_vmap_tick``); the final stacks too. With
    ``timing``, each form's device busy ms, launches and copies a tick from
    a profiled pass. Returns the summary (its ``launches`` by kernel)."""
    import tempfile

    import numpy as np

    from twtml_tpu_torch.ops import fused_gram

    vmap, scan = sv_model("vmap", kind), sv_model("scan", kind)
    ticks = [vmap.split(b) for b in sv_ticks(kind)]
    warm = [copy_batch(p) for p in ticks[0]]
    for p in warm:
        p.mask[:] = 0.0
    ticks = [warm, *ticks]
    if vmap._batched is None or vmap.route != ("scatter" if kind == "scatter" else "gram"):
        raise AssertionError(f"tenants sparse {kind}: no batched step on route {vmap.route}")
    counters = [getattr(fused_gram, k) for k in SV_KERNELS + (
        "count_build", "dual_sgd", "dual_writeback_counts")]
    for fn in counters:
        fn.launches = 0
    fused_gram.tenant_gram_blocks.products = 0
    v_outs, _ = tenant_ticks(vmap, ticks, sync_debug=True)
    got = {fn.__name__: fn.launches for fn in counters}
    got["products"] = fused_gram.tenant_gram_blocks.products
    want = (sv_expected(vmap, ticks) if kind != "scatter"
            else dict(dict.fromkeys(SV_KERNELS, 0), products=0))
    want.update(count_build=0, dual_sgd=0, dual_writeback_counts=0)
    if got != want:
        raise AssertionError(f"tenants sparse {kind}: launches {got}, want {want}")
    for fn in counters:
        fn.launches = 0
    s_outs, prev = [], []
    for parts in ticks:
        prev.append(scan._weights.clone())
        s_outs.append(tenant_ticks(scan, [parts], sync_debug=True)[0][0])
    scan_launches = {fn.__name__: fn.launches for fn in counters}
    if scan_launches != sv_scan_expected(kind, len(ticks)):
        raise AssertionError(f"tenants sparse {kind}: the scan form launched {scan_launches}")
    flips, worst = 0, 0.0
    for k, (parts, ov, os_, w_prev) in enumerate(zip(ticks, v_outs, s_outs, prev)):
        f_k, w_k = hold_vmap_tick(k, ov, os_, sv_margins(scan, parts), w_prev)
        flips, worst = flips + f_k, max(worst, w_k)
    w_v, w_s = vmap.latest_weights.astype(np.float64), scan.latest_weights.astype(np.float64)
    if not np.allclose(w_v, w_s, rtol=VMAP_RTOL, atol=VMAP_ATOL) or not np.isfinite(w_v).all():
        raise AssertionError(f"tenants sparse {kind}: the final stack is not the scan form's "
                             f"within rtol {VMAP_RTOL} atol {VMAP_ATOL}")
    planes = [vmap.planes(vmap.prepare_wire_from_parts(p)) for p in ticks[1:]]
    out = {"ticks": len(ticks) - 1, "launches": got, "scan_launches": scan_launches,
           "flips": flips, "stats_rel_err": worst,
           "weights_abs_err": float(np.abs(w_v - w_s).max()),
           "planes": [list(p) for p in planes]}
    phase("tenants-sparse", f"{kind} ticks, M = {SV_M} at 2^18 (library level, B = {GRAM_ROWS}, "
          f"{len(ticks) - 1} ticks + a warm-up of padding, route {vmap.route}, planes "
          f"{out['planes']}): the vmap form launched {got} under the sync-debug mode \"error\", "
          f"the scan form {scan_launches}; each tick against scan's: counts equal, {flips} "
          f"prediction(s) a step apart within {VMAP_TIE} of a tie, stats and quality within "
          f"{worst:.2e}; the final stacks {out['weights_abs_err']:.2e} apart (tolerance rtol "
          f"{VMAP_RTOL} atol {VMAP_ATOL})")
    if not timing:
        return out
    walls = {"vmap": [], "scan": []}
    for mapping in ("vmap", "scan", "scan", "vmap"):
        walls[mapping] += tenant_ticks(sv_model(mapping, kind), ticks)[1][1:]
    with tempfile.TemporaryDirectory() as tmp:
        for mapping in ("vmap", "scan"):
            where = os.path.join(tmp, mapping)
            os.makedirs(where)
            tenant_ticks(sv_model(mapping, kind), ticks, profile_dir=where)
            costs, busy_ms, _ = trace_costs(where)
            n = len(ticks) - 1
            out[mapping] = {"host_wall_ms_a_tick": statistics.median(walls[mapping]),
                            "host_wall_ms": walls[mapping],
                            "device_busy_ms_a_tick": busy_ms / n,
                            "launches_a_tick": statistics.mean(c["launches"] for c in costs),
                            "h2d_a_tick": statistics.mean(c["h2d"] for c in costs),
                            "d2h_a_tick": statistics.mean(c["d2h"] for c in costs)}
            o = out[mapping]
            phase("tenants-sparse", f"{kind} {mapping} tick (the {n} ticks after the warm-up): "
                  f"host wall median {o['host_wall_ms_a_tick']:.3f} ms (pack + step + fetch + "
                  f"wait, {2 * n} ticks of each form in turns); profiler: device busy "
                  f"{o['device_busy_ms_a_tick']:.3f} ms, "
                  f"{o['launches_a_tick']:.0f} host launches, {o['h2d_a_tick']:.0f} H2D and "
                  f"{o['d2h_a_tick']:.0f} D2H copies a tick | card: {smi}")
    return out


DUAL_PROBE_RUNS = 5  # probe launches a reading of B7's tenant form's phase split


def dual_probe(gs, u, labels, mask, numeric, runs=DUAL_PROBE_RUNS, **kw):
    """B7's tenant form's phase split (``fused_gram.dual_tenants_probe``,
    the timing instantiation; ``runs`` launches after a warm-up): each
    phase's median over the launches of ``dual_tenants_probe_split``, the µs
    an iteration, the iterations stamped and the probe launch's device ms
    (CUDA events). None where the tree has no probe."""
    import torch

    from twtml_tpu_torch.ops import fused_gram

    if not hasattr(fused_gram, "dual_tenants_probe"):
        return None
    splits = []
    for _ in range(runs + 1):  # the first a warm-up
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        stamps = fused_gram.dual_tenants_probe(gs, u, labels, mask, numeric, **kw)[3]
        end.record()
        end.synchronize()
        splits.append((fused_gram.dual_tenants_probe_split(stamps), start.elapsed_time(end)))
    splits = splits[1:]
    med = statistics.median
    phases = {k: med([s[0]["iteration_us"].get(k, 0.0) for s in splits])
              for k in fused_gram.DUAL_PROBE_PHASES}
    return {"iteration_us": phases, "us_an_iteration": sum(phases.values()),
            "prologue_us": med([s[0]["prologue_us"] or 0.0 for s in splits]),
            "iterations_stamped": splits[0][0]["iterations"],
            "span_us": med([s[0]["span_us"] or 0.0 for s in splits]),
            "probe_launch_ms": med([s[1] for s in splits])}


def dual_probe_text(split):
    if split is None:
        return "no probe in this tree"
    return (f"an iteration {split['us_an_iteration']:.3f} µs: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split["iteration_us"].items())
            + f"; prologue {split['prologue_us']:.2f} µs ({split['iterations_stamped']} "
            f"iterations stamped, the first left out; span {split['span_us']:.1f} µs, the probe "
            f"launch {split['probe_launch_ms']:.4f} ms with its event pair)")


def sv_time_inputs():
    """The tenant forms' timed inputs: the 2^18 vmap arm's first short tick
    routed to SV_M parts of GRAM_ROWS rows (~512 valid each, the int8
    plane) on the card, decoded, W_prev random (seed 5), u = Z·W_prev,
    p_prev and the dual loop's keywords (50 iterations, tolerance 0.001)."""
    import types

    import numpy as np
    import torch

    from twtml_tpu_torch.models.sgd import batch_to_device, decode_batch, flatten_tenants
    from twtml_tpu_torch.ops.gram import PLANE_INT8
    from twtml_tpu_torch.ops.sparse import sparse_predict

    model = sv_model("vmap", "short")
    parts = model.split(sv_ticks("short", 1)[0])
    wire = model.prepare_wire_from_parts(parts)
    valid = model.valid_rows(wire)
    if set(model.planes(wire)) != {PLANE_INT8}:
        raise AssertionError(f"tenants sparse times: planes {model.planes(wire)}")
    dev = batch_to_device(wire, model.device, non_blocking=False)
    idx, val, num, y, mask = decode_batch(flatten_tenants(dev), GRAM_F, torch.float32)
    m, f = SV_M, GRAM_F
    b = mask.shape[0] // m
    idx, val, num = idx.view(m, b, -1), val.view(m, b, -1), num.view(m, b, -1)
    y, mask = y.view(m, b), mask.view(m, b)
    w = torch.from_numpy((np.random.default_rng(5).normal(size=(m, f + 4)) * 1e-3)
                         .astype(np.float32)).cuda()
    raw = sparse_predict(w[:, :f], w[:, f:], idx, val, num)
    kw = dict(num_iterations=OP_ITERS, step_sizes=[0.005] * m, l2_regs=[0.1] * m,
              convergence_tol=0.001)
    return types.SimpleNamespace(valid=valid, idx=idx, val=val, num=num, y=y, mask=mask, w=w,
                                 raw=raw, p_prev=torch.sum(w * w, dim=1), kw=kw, rows=b)


def sv_times(smi, errs, launches):
    """The tenant forms at the short ticks' shapes (the first tick's SV_M
    parts of GRAM_ROWS rows, ~512 valid each, the int8 plane): each kernel
    alone, 50 calls back to back behind ``split_queued``'s sleep (the
    median of SV_TIME_RUNS), its plain version's time, its bound and the
    library call where one computes the same work (B4: ``torch.bincount``
    over tenant-offset keys; B8: ``index_add_`` of the contributions over
    tenant-offset keys; B7: none); beside each, the in-turn kernel's M launches
    on the padded parts (the scan form's). Returns the kernels line's
    records."""
    import torch

    from twtml_tpu_torch.ops import fused_gram

    x = sv_time_inputs()
    valid, idx, val, num, y, mask = x.valid, x.idx, x.val, x.num, x.y, x.mask
    w, raw, p_prev, kw = x.w, x.raw, x.p_prev, x.kw
    m, f, b, l = SV_M, GRAM_F, x.rows, idx.shape[2]
    tv = sum(valid)

    def queued(fn):
        ms, all_ms, host_us = split_queued(fn, SV_TIME_RUNS)
        return {"ms": ms, "runs_ms": all_ms, "host_enqueue_us": host_us}

    def record(name, replaces, t, plain_ms, bound, library_ms, extra):
        bytes_ms, ops_ms = bound
        return dict({
            "name": name, "route": "cuda", "source": "twtml_tpu_torch/csrc/gram.cu",
            "replaces": replaces, "tpu_function": None, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "valid_rows": list(valid), "part_rows": b,
            "runs_ms": t["runs_ms"], "host_enqueue_us": t["host_enqueue_us"]}, **extra)

    # B4's tenant form
    counts, at = fused_gram.count_build_tenants(idx, val, f, valid_rows=valid, int8=True)
    rows, cols = counts.shape
    b4 = queued(lambda: fused_gram.count_build_tenants(idx, val, f, valid_rows=valid,
                                                       int8=True))
    b4_plain, _ = timed(lambda: fused_gram.count_build_tenants_reference(
        idx, val, f, valid_rows=valid, int8=True, cols_out=cols), 3)
    b4_bytes = rows * cols + tv * l * 8
    keys = torch.cat([(at[t] + torch.arange(v, device=idx.device))[:, None] * cols
                      + idx[t, :v] for t, v in enumerate(valid) if v]).reshape(-1)
    kval = torch.cat([val[t, :v] for t, v in enumerate(valid) if v]).reshape(-1)
    bincount = lambda: torch.bincount(keys, weights=kval, minlength=rows * cols)  # noqa: E731
    b4_lib, _ = timed(bincount, 10, queue_ahead=True)
    in_turn = [(idx[t].contiguous(), val[t].contiguous()) for t in range(m)]
    b4_turn = queued(lambda: [fused_gram.count_build(i, v, f, int8=True) for i, v in in_turn])
    # the G products
    gs = fused_gram.tenant_gram_blocks(counts, at, valid)
    products = queued(lambda: fused_gram.tenant_gram_blocks(counts, at, valid))
    # a yardstick for the products: ONE product over every tenant's rows
    # (its diagonal blocks are the tenants' G; the rest is work no tenant needs)
    one_product = queued(lambda: torch._int_mm(counts, counts.t()))
    # B7's tenant form
    c, alpha, its = fused_gram.dual_sgd_tenants(gs, raw, y, mask, num, valid_rows=valid,
                                                p_prev=p_prev, **kw)
    its = [int(i) for i in its.tolist()]
    b7 = queued(lambda: fused_gram.dual_sgd_tenants(gs, raw, y, mask, num, valid_rows=valid,
                                                    p_prev=p_prev, **kw))
    b7_tol0 = queued(lambda: fused_gram.dual_sgd_tenants(
        gs, raw, y, mask, num, valid_rows=valid, p_prev=p_prev, **dict(kw, convergence_tol=0.0)))
    b7_plain, _ = timed(lambda: fused_gram.dual_sgd_tenants_reference(
        gs, raw, y, mask, num, valid_rows=valid, p_prev=p_prev, **kw), 3)
    b7_probe = dual_probe(gs, raw, y, mask, num, valid_rows=valid, p_prev=p_prev, **kw)
    b7_ops = sum(i * (2 * v * v + 12 * v) for i, v in zip(its, valid))
    b7_bytes = sum(v * v * 4 + 9 * v * 4 for v in valid)
    g_pad = []
    for t in range(m):  # B7 in turn: each padded part's G, N·Nᵀ added
        cp = fused_gram.count_build(*in_turn[t], f, int8=True)
        g = fused_gram.gram_from_counts(cp)
        g[:b, :b] += num[t] @ num[t].T
        g_pad.append((g, raw[t].contiguous(), y[t].contiguous(), mask[t].contiguous(),
                      p_prev[t]))
        del cp
    b7_turn = queued(lambda: [fused_gram.dual_sgd(g, r_, y_, m_, p_prev=p_, num_iterations=OP_ITERS,
                                                  step_size=0.005, l2_reg=0.1,
                                                  convergence_tol=0.001)
                              for g, r_, y_, m_, p_ in g_pad])
    del g_pad
    # B8's tenant form, from the tokens
    out_w = torch.empty_like(w)
    b8 = queued(lambda: fused_gram.dual_writeback_tenants(w, c, alpha, idx, val, num, f,
                                                          valid_rows=valid, out=out_w))
    b8_plain, _ = timed(lambda: fused_gram.dual_writeback_tenants_reference(
        w, c, alpha, idx, val, num, f, valid_rows=valid), 3)
    wb_bytes = b8_bytes(tv, l, f, tenants=m)
    b8_ops = 2 * tv * l + 8 * tv + 2 * m * (f + 4)
    c_read = sum(v * cols for v in valid)  # what B8 streamed before it took the tokens
    # the scatter alone as one library call: index_add_ over tenant-offset keys
    keys8 = torch.cat([t * f + idx[t, :v].reshape(-1).long() for t, v in enumerate(valid) if v])
    contrib8 = torch.cat([(val[t, :v] * alpha[t, :v, None]).reshape(-1)
                          for t, v in enumerate(valid) if v])
    w_flat = (w[:, :f] * c[:, None]).reshape(-1)
    b8_lib, _ = timed(lambda: w_flat.index_add_(0, keys8, contrib8), 10, queue_ahead=True)
    del keys8, contrib8
    a_turn = [torch.zeros(b, device=idx.device) for _ in range(m)]
    b8_turn = queued(lambda: [fused_gram.dual_writeback_counts(w[t], c[t], a_turn[t], *in_turn[t],
                                                                num[t], f) for t in range(m)])
    card = {"card": smi}
    phase("tenants-sparse", f"times at {m} parts of {b} rows, valid {list(valid)}, F = {f}, int8 "
          f"counts {tuple(counts.shape)} (50 calls back to back behind ~20 ms of sleep, median "
          f"of {SV_TIME_RUNS}): B4's tenant form {b4['ms']:.4f} ms (in turn, B4 on the {m} "
          f"padded parts: {b4_turn['ms']:.4f}), plain {b4_plain:.4f}, torch.bincount "
          f"{b4_lib:.4f}, bound {b4_bytes} B = {b4_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms; the "
          f"{sum(1 for v in valid if v)} G products {products['ms']:.4f} ms (one product over "
          f"all {rows} rows {one_product['ms']:.4f}); B7's tenant form "
          f"{b7['ms']:.4f} ms ({its} iterations; tol 0 {b7_tol0['ms']:.4f}; in turn on the "
          f"padded parts {b7_turn['ms']:.4f}), plain {b7_plain:.4f}, bound {b7_ops} f32 "
          f"operations = {b7_ops / F32_FLOPS_PER_S * 1e3:.5f} ms, its probe split "
          f"{dual_probe_text(b7_probe)}; B8's tenant form "
          f"{b8['ms']:.4f} ms (in turn {b8_turn['ms']:.4f}), plain {b8_plain:.4f}, torch "
          f"index_add_ of the contributions {b8_lib:.4f}, bound from its own bytes {wb_bytes} "
          f"B = {wb_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms (one read of the int8 C: {c_read} B "
          f"= {c_read / HBM_BYTES_PER_S * 1e3:.5f} ms) | card: {smi}")
    return [
        record("count_build_tenants", "twtml_tpu/ops/gram.py:133 (onehot_counts_int8) under "
               "jax.vmap (twtml_tpu/parallel/tenants.py:329)", b4, b4_plain,
               (b4_bytes / HBM_BYTES_PER_S * 1e3, 0.0), b4_lib, dict(
                   card, kernel="B4 tenant form", library_call="torch.bincount over "
                   "tenant-offset keys", in_turn_ms=b4_turn["ms"],
                   gram_products={"call": "torch._int_mm", "products": sum(
                       1 for v in valid if v), "ms": products["ms"],
                       "one_product_over_all_rows_ms": one_product["ms"]})),
        record("dual_sgd_tenants", "twtml_tpu/models/sgd.py:155 (run_dual_loop) under jax.vmap "
               "(twtml_tpu/parallel/tenants.py:329)", b7, b7_plain,
               (b7_bytes / HBM_BYTES_PER_S * 1e3, b7_ops / F32_FLOPS_PER_S * 1e3), None, dict(
                   card, kernel="B7 tenant form", iterations_run=its, tol0_ms=b7_tol0["ms"],
                   in_turn_ms=b7_turn["ms"], probe=b7_probe)),
        record("dual_writeback_tenants", "twtml_tpu/ops/gram.py:269 (dual_writeback) under "
               "jax.vmap (twtml_tpu/parallel/tenants.py:329)", b8, b8_plain,
               (wb_bytes / HBM_BYTES_PER_S * 1e3, b8_ops / F32_FLOPS_PER_S * 1e3), b8_lib, dict(
                   card, kernel="B8 tenant form", library_call="torch.Tensor.index_add_ over "
                   "tenant-offset keys (the scatter alone; atomics, not bitwise reproducible)",
                   in_turn_ms=b8_turn["ms"], bytes=wb_bytes, int8_c_read_bytes=c_read)),
    ]


def tenants_sparse_arm(smi):
    """The 2^18 vmap arm (ROADMAP B10 c): the tenant forms' holds
    (``sv_checks``), then the vmap form against scan on short tweets (the
    main path of the tenant forms, profiled), mixed planes and the scatter
    route (``sv_tick_arm``), then the kernels' times (``sv_times``).
    Returns (the arm's summary, the three kernels line records, launches
    from the short ticks' run)."""
    t0 = time.perf_counter()
    errs, cases = sv_checks()
    summary = {"short": sv_tick_arm("short", smi, timing=True),
               "mixed": sv_tick_arm("mixed", smi), "scatter": sv_tick_arm("scatter", smi)}
    launches = dict(summary["short"]["launches"])
    for k in SV_KERNELS:
        launches[k] += summary["mixed"]["launches"][k]
    records = sv_times(smi, errs, launches)
    for r in records:
        r["cases"] = cases
        r["launches_short_ticks"] = summary["short"]["launches"][r["name"]]
        r["launches_mixed_ticks"] = summary["mixed"]["launches"][r["name"]]
    summary["wall_s"] = time.perf_counter() - t0
    phase("tenants-sparse", f"the 2^18 vmap arm wall {summary['wall_s']:.1f} s")
    return summary, records


DUAL_AB_ROWS = (2048, 3072, 4096)  # B7's batches in ``--dual-ab``: G in registers, then spilled


def dual_ab_times(runs=SV_TIME_RUNS):
    """B7's tenant form at config #4's 4 parts (``sv_time_inputs``: tolerance
    0.001 and 0) and at one tenant on B7's 2048 rows, with B7 itself
    (``dual_sgd``) at B = 2048 (tolerance 0.001 and 0), 3072 and 4096 in the
    same process, and B7 at no iteration (its prologue alone) at 2048 and
    4096, on the port this process imports: device ms (50 calls back to
    back behind ``split_queued``'s sleep, the median of ``runs``; in turns,
    forwards then backwards), the form's probe split where the port has it
    (B7's own launch too, where B7 is the form), and digests of B7's results (α, c and iterations) at each B in
    both residual modes, with and without ``-b 0.5`` draws, and at tolerance
    0, for a bitwise comparison across ports."""
    import hashlib

    import numpy as np
    import torch

    from twtml_tpu_torch.models.sgd import sampling_masks
    from twtml_tpu_torch.ops import fused_gram
    from twtml_tpu_torch.ops.fused_sgd import logistic_residual
    from twtml_tpu_torch.ops.gram import PLANE_INT8
    from twtml_tpu_torch.ops.sparse import sparse_predict

    x = sv_time_inputs()
    counts, at = fused_gram.count_build_tenants(x.idx, x.val, GRAM_F, valid_rows=x.valid,
                                                int8=True)
    gs = fused_gram.tenant_gram_blocks(counts, at, x.valid)
    form = (gs, x.raw, x.y, x.mask, x.num)
    w = torch.from_numpy((np.random.default_rng(5).normal(size=GRAM_F + 4) * 1e-3)
                         .astype(np.float32)).cuda()
    p_prev = torch.sum(w * w)
    kw = dict(num_iterations=OP_ITERS, step_size=0.005, l2_reg=0.1)
    batches = {}
    for rows in DUAL_AB_ROWS:
        dev, plane, idx, val = gram_tweet_batch(rows)
        counts_b = fused_gram.count_build(idx, val, GRAM_F, int8=plane == PLANE_INT8)
        g_text = fused_gram.gram_from_counts(counts_b)
        g = g_text.clone()
        g[:rows, :rows] += dev.numeric @ dev.numeric.T
        raw = sparse_predict(w[:GRAM_F], w[GRAM_F:], idx, val, dev.numeric)
        batches[rows] = (g, raw, dev.label, dev.mask, dev.numeric, g_text)
        del counts_b
    g2, raw2, y2, m2, num2, g_text2 = batches[2048]
    calls = [
        ("form_config4", lambda: fused_gram.dual_sgd_tenants(*form, valid_rows=x.valid,
                                                             p_prev=x.p_prev, **x.kw)),
        ("form_config4_tol0", lambda: fused_gram.dual_sgd_tenants(
            *form, valid_rows=x.valid, p_prev=x.p_prev, **dict(x.kw, convergence_tol=0.0))),
        ("form_one_tenant", lambda: fused_gram.dual_sgd_tenants(
            [g_text2], raw2[None], y2[None], m2[None], num2[None], valid_rows=[2048],
            p_prev=p_prev[None], num_iterations=OP_ITERS, step_sizes=[0.005],
            l2_regs=[0.1], convergence_tol=0.001)),
        ("b7_2048_tol0", lambda: fused_gram.dual_sgd(g2, raw2, y2, m2, p_prev=p_prev,
                                                     convergence_tol=0.0, **kw)),
    ] + [(f"b7_{rows}", (lambda r: lambda: fused_gram.dual_sgd(
        *batches[r][:4], p_prev=p_prev, convergence_tol=0.001, **kw))(rows))
        for rows in DUAL_AB_ROWS] + [
        # no iteration: the prologue (G staged, the outputs written) alone
        (f"b7_{rows}_n0", (lambda r: lambda: fused_gram.dual_sgd(
            *batches[r][:4], p_prev=p_prev, convergence_tol=0.001,
            **dict(kw, num_iterations=0)))(rows)) for rows in (2048, 4096)]
    runs_ms = {name: [] for name, _ in calls}
    for name, fn in calls:
        fn()  # a warm-up
    for name, fn in (*calls, *calls[::-1]):
        runs_ms[name] += split_queued(fn, runs)[1]
    out = {f"{k}_ms": statistics.median(v) for k, v in runs_ms.items()}
    out["runs_ms"] = runs_ms
    digests, iterations = {}, {}
    for rows, (g, raw, y, m, _, _) in batches.items():
        two = (y > y[m > 0].mean()).float()
        masks = sampling_masks(rows, OP_ITERS, 0.5, torch.float32, "cuda")
        for key, args, extra in (
                ("least squares", (g, raw, y, m), {}),
                ("logistic", (g, raw, two, m), dict(step_size=0.1,
                                                     residual_fn=logistic_residual)),
                ("least squares -b 0.5", (g, raw, y, m), dict(masks=masks)),
                ("logistic -b 0.5", (g, raw, two, m), dict(masks=masks, step_size=0.1,
                                                            residual_fn=logistic_residual)),
                ("least squares tol 0", (g, raw, y, m), dict(convergence_tol=0.0))):
            c, a, its = fused_gram.dual_sgd(*args, p_prev=p_prev,
                                            **dict(dict(kw, convergence_tol=0.001), **extra))
            torch.cuda.synchronize()
            blob = a.cpu().numpy().tobytes() + c.cpu().numpy().tobytes() + its.cpu().numpy(
            ).tobytes()
            digests[f"{rows} {key}"] = hashlib.sha256(blob).hexdigest()[:16]
            iterations[f"{rows} {key}"] = int(its)
    out.update(digests=digests, iterations=iterations)
    out["probe_config4"] = dual_probe(*form, valid_rows=x.valid, p_prev=x.p_prev, **x.kw)
    out["probe_one_tenant"] = dual_probe(
        [g_text2], raw2[None], y2[None], m2[None], num2[None], valid_rows=[2048],
        p_prev=p_prev[None], num_iterations=OP_ITERS, step_sizes=[0.005], l2_regs=[0.1],
        convergence_tol=0.001)
    # B7's own launch (G read whole) at B = 2048 (in registers) and 4096 (spilled)
    for rows in (2048, 4096):
        g, raw, y, m = batches[rows][:4]
        out[f"probe_b7_{rows}"] = dual_probe(
            [g], raw[None], y[None], m[None], None, valid_rows=[rows], p_prev=p_prev[None],
            num_iterations=OP_ITERS, step_sizes=[0.005], l2_regs=[0.1], convergence_tol=0.001)
    return out


def dual_ab(smi, pairs, parent_root):
    """``--dual-ab N --package-root DIR``: ``dual_ab_times`` on the port found
    in DIR (e.g. the parent commit unpacked there) and on this checkout's,
    each arm in a process of its own, N pairs, the order alternating: the
    tenant form at config #4's 4 parts and at one tenant, B7 at each B, the
    probe's split where a tree has it, whether B7's results are bitwise
    equal across the trees, and each tree's ptxas report of the kernels."""
    import glob

    keys = ("form_config4_ms", "form_config4_tol0_ms", "form_one_tenant_ms", "b7_2048_ms",
            "b7_2048_tol0_ms", "b7_3072_ms", "b7_4096_ms", "b7_2048_n0_ms", "b7_4096_n0_ms")

    def report(i, arm, rec):
        phase("dual-ab", f"pair {i} {arm} (run {rec['position'] + 1} of 2): "
              + ", ".join(f"{k[:-3]} {rec[k]:.4f}" for k in keys)
              + " ms (50 calls back to back, median of 10 runs in turns)")
        for key in ("probe_config4", "probe_one_tenant", "probe_b7_2048", "probe_b7_4096"):
            phase("dual-ab", f"pair {i} {arm} {key}: {dual_probe_text(rec[key])}")

    roots = {"parent": parent_root, "change": HERE}
    runs = ab_pairs("dual-ab", "dual_ab_times", pairs, parent_root, report)
    medians = {arm: {k: statistics.median(r[k] for r in rows) for k in keys}
               for arm, rows in runs.items()}
    pair_of = lambda arm: sorted(runs[arm], key=lambda r: r["pair"])  # noqa: E731
    wins = {k: sum(c[k] < p[k] for c, p in zip(pair_of("change"), pair_of("parent")))
            for k in keys}
    ratios = {k: medians["change"][k] / medians["parent"][k] for k in keys}
    bitwise = {k: all(r["digests"][k] == runs["parent"][0]["digests"][k]
                      for arm in runs for r in runs[arm])
               for k in runs["parent"][0]["digests"]}
    for arm, root in roots.items():
        for log in glob.glob(os.path.join(root, "build", "twtml_tpu_torch", "libgram-*.log")):
            text = open(log).read()
            phase("dual-ab", f"{arm} build ({os.path.basename(log)}):\n"
                  + "\n".join(ptxas_blocks(text, "dual_tenants_kernel")
                              + ptxas_blocks(text, "dual_sgd_kernel")))
    phase("dual-ab", f"medians over {pairs} pairs, this tree against the parent's: "
          + ", ".join(f"{k[:-3]} {medians['change'][k]:.4f} / {medians['parent'][k]:.4f} "
                      f"({ratios[k]:.3f}x, lower in {wins[k]} of {pairs})" for k in keys)
          + f"; B7's results bitwise equal across the trees: "
          + ", ".join(f"{k} {'yes' if v else 'NO'}" for k, v in bitwise.items())
          + f"; iterations {runs['change'][0]['iterations']} | card: {smi}")
    print(json.dumps({"dual_ab": {"pairs": pairs, "runs": runs, "medians": medians,
                                  "ratios": ratios, "change_wins": wins, "bitwise": bitwise,
                                  "card": smi}}), flush=True)


# ---- phase 22: champion/challenger serving -----------------------------------

AB_M = 3
# the serve entry point with the B1 counters and the served batches printed
# as JSON when it stops (SIGINT), so a serve process reports its launches
COUNTED_SERVE = (
    "import json, sys\n"
    "from twtml_tpu_torch.apps import serve\n"
    "from twtml_tpu_torch.ops import fused_sgd\n"
    "from twtml_tpu_torch.telemetry import metrics\n"
    "try:\n"
    "    serve.main(sys.argv[1:])\n"
    "finally:\n"
    "    print(json.dumps({'launches': fused_sgd.fused_dense_sgd.launches,\n"
    "                      'predict_launches': fused_sgd.fused_dense_sgd.predict_launches,\n"
    "                      'batches': int(metrics.get_registry().counter('serve.batches')\n"
    "                                     .snapshot())}), flush=True)\n"
)


def stamps(entries):
    """A checkpoint's quality stamp with a stamp a tenant: [(level, loss)]."""
    return {"level": "ok", "tenants": [
        {"tenant": i, "level": level, "loss": loss, "drift_score": 9.0 if level == "alert"
         else 0.5, "loss_trend": 0.0} for i, (level, loss) in enumerate(entries)]}


def stop_counted(proc):
    """SIGINT a counted serve process and read the counters it printed
    ({} when it printed none: the caller's gate then fails)."""
    import signal

    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
    proc.log.flush()
    with open(proc.log.name) as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.startswith('{"launches"')]
    return json.loads(lines[-1]) if lines else {}


def abtest_phase(smi, statuses):
    """Champion/challenger serving on the card (module docstring, phase 22)."""
    import tempfile

    import numpy as np

    from twtml_tpu_torch.checkpoint import Checkpointer
    from twtml_tpu_torch.serving import FleetRouter, ServingClient

    t_phase = time.perf_counter()
    n = TENANT_BATCHES
    with tempfile.TemporaryDirectory() as tmp:
        train_ck = os.path.join(tmp, "train")
        totals, _, rec = tenant_app_run(
            [*TENANT_ARGV, "--tenants", str(AB_M), "--checkpointDir", train_ck,
             "--checkpointEvery", "2"], statuses[:n * OP_ROWS])
        RECORDER.take()
        stack1, meta = archive(train_ck)
        trained = (meta.get("quality") or {}).get("tenants") or []
        if (stack1.shape != (AB_M, 1004) or stack1.tobytes() != rec["weights"].tobytes()
                or [t.get("tenant") for t in trained] != list(range(AB_M))):
            raise AssertionError(f"abtest: the trained checkpoint holds {stack1.shape}, "
                                 f"tenant stamps {trained}")
        phase("abtest", f"trained --tenants {AB_M} on the card ({totals['batches']} ticks, "
              f"B1 launched {rec['launches']} times): the verified checkpoint holds the "
              f"[{AB_M}, 1004] stack and a quality stamp a tenant: "
              + json.dumps([{k: t[k] for k in ("tenant", "level", "loss")} for t in trained]))
        stack2 = (stack1 * np.array([[1.0], [0.75], [1.0]], np.float32)).astype(np.float32)
        base = {"count": totals["count"], "batches": totals["batches"]}
        ab_ck, one_ck = os.path.join(tmp, "ab"), os.path.join(tmp, "one")
        Checkpointer(ab_ck).save(1, stack1, dict(base, quality=stamps(
            [("ok", 1.0), ("ok", 5.0), ("ok", 9.0)])))
        Checkpointer(one_ck).save(1, stack1[0], dict(base, quality={"level": "ok"}))
        ports = (free_port(), free_port())
        urls = [f"http://127.0.0.1:{p}" for p in ports]
        procs = [spawn_serve(ab_ck, ports[0], os.path.join(tmp, "ab.log"),
                             extra=("--abtest", "on"), counted=True),
                 spawn_serve(one_ck, ports[1], os.path.join(tmp, "one.log"), counted=True)]
        counts = {}
        try:
            t0 = time.perf_counter()
            for url, proc in zip(urls, procs):
                wait_serving(url, 1, proc)
            boot_s = time.perf_counter() - t0
            pool = serve_pool(statuses)
            refs = RowRefs(pool, {1: stack1[0], 2: stack2[1]})

            def progress(done):
                if done == SWAP_AT:  # mid-load: a checkpoint favouring challenger 1
                    Checkpointer(ab_ck).save(2, stack2, dict(base, quality=stamps(
                        [("ok", 1.0), ("ok", 0.5), ("alert", 0.1)])))

            answers, errors, wall = serve_load(urls[0], pool, SERVE_REQUESTS, SERVE_CLIENTS,
                                               seed=40, progress=progress)
            client = ServingClient(urls[0], timeout=2.0, retries=0)
            end = time.monotonic() + 30
            view = client.serving()
            while (view.get("promotions"), view.get("refusedPromotions")) != (1, 1) \
                    and time.monotonic() < end:
                time.sleep(0.2)
                view = client.serving()
            router = FleetRouter([urls[0]])
            try:
                router.health_check_once()
                fleet = router.stats()
            finally:
                router.stop()
            answers1, errors1, wall1 = serve_load(urls[1], pool, SERVE_REQUESTS,
                                                  SERVE_CLIENTS, seed=40)
        finally:
            for name, proc in zip(("ab", "one"), procs):
                counts[name] = stop_counted(proc) if proc.poll() is None else {}
                proc.log.close()
    if errors or errors1:
        raise AssertionError(f"abtest: client errors {errors[:3]} {errors1[:3]}")
    seen = check_served("abtest", answers, refs, {1, 2})
    check_served("abtest single", answers1, refs, {1})
    if set(seen) != {1, 2}:
        raise AssertionError(f"abtest: answers by step {seen}: the swap did not serve both")
    if (view.get("champion"), view.get("promotions"), view.get("refusedPromotions"),
            fleet.get("champion")) != (1, 1, 1, 1):
        raise AssertionError(f"abtest: Serving view {view}, Fleet view {fleet}")
    ab, one = counts["ab"], counts["one"]
    if (ab.get("predict_launches") != AB_M * (ab.get("batches", -1) + 1)
            or ab.get("launches") != ab.get("predict_launches")
            or one.get("predict_launches") != one.get("batches", -1) + 1):
        raise AssertionError(f"abtest: B1 counts {ab} (A/B), {one} (single model)")
    out = {"boot_s": boot_s, "steps_seen": seen, "counts_ab": ab, "counts_single": one,
           "shadows": view.get("shadows")}
    for name, ans, w in (("A/B", answers, wall), ("single", answers1, wall1)):
        lat = sorted(a[3] for a in ans)
        rows = sum(a[1] for a in ans)
        out[name] = {"requests_per_s": len(ans) / w, "p50_ms": lat[len(lat) // 2] * 1e3,
                     "p99_ms": lat[int(0.99 * (len(lat) - 1))] * 1e3, "rows": rows}
        phase("abtest", f"{name} server (its own process; the {SERVE_CLIENTS} ServingClient "
              f"threads in this one): {len(ans)} requests ({rows} rows) in {w:.3f} s = "
              f"{len(ans) / w:.0f} requests/s, client p50 {out[name]['p50_ms']:.2f} ms, p99 "
              f"{out[name]['p99_ms']:.2f} ms, 0 client errors")
    phase("abtest", f"apps.serve --abtest on up with the single-model server in {boot_s:.1f} "
          f"s; answers by snapshot step {seen}: each bitwise the champion tenant's card train "
          "step under the step it names (step 1: tenant 0; step 2, written mid-load: tenant "
          f"1), none torn; B1 launched {ab['predict_launches']} times = {AB_M} x "
          f"({ab['batches']} served batches + the warm-up), every launch its predict kernel; "
          f"the single model {one['predict_launches']} = {one['batches']} + 1")
    phase("abtest", f"step 2's stamps: challenger 1 (ok, loss 0.5) promoted once "
          f"(abtest.promotions {view['promotions']}), challenger 2 (alert, loss 0.1) refused "
          f"(abtest.promotions_refused {view['refusedPromotions']}); Serving view champion "
          f"{view['champion']}, the router's Fleet view champion {fleet['champion']}; "
          f"shadows {json.dumps(view.get('shadows'))}")
    phase("abtest", f"phase wall {time.perf_counter() - t_phase:.1f} s | card: {smi}")
    return out


# ---- phase 23: block ingest and the digram wire codec ------------------------

BLOCK_BATCHES = 8
BLOCK_ARGV = ["--source", "replay", "--seconds", "0", "--batchBucket", str(OP_ROWS),
              "--maxQueueRows", "-1"]
BLOCK_ARMS = (("object", []), ("block", ["--ingest", "block"]),
              ("block+codec", ["--ingest", "block", "--wireCodec", "dict"]))
BLOCK_COUNTERS = GUARD_COUNTERS + ("wire.codec_fallbacks", "ingest.rows_dropped_parse")
BLOCK_FIELDS = ("predictions", "quality", "count", "mse", "real_stdev", "pred_stdev")
# CUDA-event timings of the device decode
DECODE_RUNS = 25


def block_run(argv, max_batches=0, **kw):
    """One app run of the block phase from the replay file ``argv`` names,
    every dispatch under the sync-debug mode "error" on the card: the
    registry's counters as deltas over the run, and the parse rate gauge."""
    from twtml_tpu_torch.apps.common import SYNC_DEBUG_ENV
    from twtml_tpu_torch.telemetry import metrics

    reg = metrics.get_registry()
    before = {k: reg.counter(k).snapshot() for k in BLOCK_COUNTERS}
    reg.gauge("ingest.parse_tweets_per_s").set(0.0)
    os.environ[SYNC_DEBUG_ENV] = "error"
    try:
        totals, lines, rec = recorded_app_run(argv, max_batches,
                                              expected_errors=GUARD_ERRORS, **kw)
    finally:
        del os.environ[SYNC_DEBUG_ENV]
    rec["counters"] = {k: int(reg.counter(k).snapshot() - before[k]) for k in BLOCK_COUNTERS}
    rec["parse_rate"] = reg.gauge("ingest.parse_tweets_per_s").value
    rec["codec_ratio"] = reg.gauge("wire.codec_ratio").value
    return totals, lines, rec


def hold_bitwise(name, runs):
    """Every run of ``runs`` ({arm: (totals, lines, rec)}) bitwise the
    first's: the rows of each batch, the lines, the final weights, and each
    batch's predictions, quality and stats."""
    import numpy as np
    import torch

    (ref_arm, (ref_totals, ref_lines, ref)), *rest = runs.items()
    ref_rows = [st["count"] for st in ref_totals["steps"]]
    for arm, (totals, lines, rec) in rest:
        rows = [st["count"] for st in totals["steps"]]
        if rows != ref_rows:
            raise AssertionError(f"{name} {arm}: batch rows {rows} against {ref_arm}'s "
                                 f"{ref_rows}")
        if lines != ref_lines or not np.array_equal(rec["weights"], ref["weights"]):
            raise AssertionError(f"{name} {arm}: lines or weights differ from {ref_arm}'s")
        for i, (a, b) in enumerate(zip(rec["outputs"], ref["outputs"], strict=True)):
            for k in BLOCK_FIELDS:
                x, y = getattr(a, k), getattr(b, k)
                if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                    raise AssertionError(f"{name} {arm} batch {i + 1}: {k} differs from "
                                         f"{ref_arm}'s")
    return ref_rows


def block_wires(path, n=3):
    """The first ``n`` batches of the replay file through the block parser
    (the wire emitter) and ``featurize_parsed_block``: (ragged batches, raw
    packed wires, coded packed wires, median ms of the raw pack and of the
    coded pack over 5 runs of each batch)."""
    from twtml_tpu_torch.features.batch import pack_batch
    from twtml_tpu_torch.features.blocks import iter_row_chunks
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.streaming.sources import BlockReplayFileSource

    featurizer = Featurizer(now_ms=NOW_MS)
    chunks = iter_row_chunks(BlockReplayFileSource(path, wire=True).produce(), OP_ROWS)
    batches = [featurizer.featurize_parsed_block(next(chunks), row_bucket=OP_ROWS, ragged=True)
               for _ in range(n)]
    times = {"raw": [], "dict": []}
    for rb in batches:
        for codec in ("raw", "dict"):
            for _ in range(5):
                t0 = time.perf_counter()
                wire = pack_batch(rb, codec=None if codec == "raw" else codec)
                times[codec].append((time.perf_counter() - t0) * 1e3)
                wire.lease.retire()
    raw = [pack_batch(rb) for rb in batches]
    coded = [pack_batch(rb, codec="dict") for rb in batches]
    return batches, raw, coded, {k: statistics.median(v) for k, v in times.items()}


def step_profile(wires):
    """Device busy ms and device kernels (copies apart) a step over steps
    2..n of ``wires`` on a fresh card model (step 1 pays first-use set-up),
    from torch.profiler's device events."""
    from torch.profiler import ProfilerActivity, profile

    model = model_after_batch_1(wires)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for wire in wires[1:]:
            float(model.step(wire).mse)
    events = [ev for ev in prof.key_averages() if ev.device_time_total]
    steps = sum(ev.count for ev in events if KERNEL in ev.key)
    if not steps:
        return None
    busy = sum(ev.device_time_total for ev in events) / steps / 1e3
    kernels = sum(ev.count for ev in events
                  if "Memcpy" not in ev.key and "Memset" not in ev.key) / steps
    copies = sum(ev.count for ev in events if "Memcpy" in ev.key) / steps
    return {"busy_ms": busy, "kernels": kernels, "copies": copies, "steps": steps}


def decode_times(coded):
    """``units_from_codes`` on the card at the operating point: the coded
    units of a packed wire decoded DECODE_RUNS times between CUDA events,
    bitwise the host decode: the device's time (queued ahead: median, min
    ms) and the call's time as the step issues it (its launches not queued
    ahead: median ms)."""
    import numpy as np
    import torch

    from twtml_tpu_torch.features.batch import _layout_codec
    from twtml_tpu_torch.features.wirecodec import decode_np
    from twtml_tpu_torch.ops.ragged import units_from_codes

    (m,), _ = coded.layout[1][0]
    out_len = int(np.prod(_layout_codec(coded.layout)[1]))
    codes = torch.from_numpy(np.asarray(coded.buffer[:m]).copy()).to("cuda")
    got = units_from_codes(codes, out_len)
    if not np.array_equal(got.cpu().numpy(), decode_np(np.asarray(coded.buffer[:m]), out_len)):
        raise AssertionError("block: units_from_codes on the card differs from the host decode")
    ms, times = timed(lambda: units_from_codes(codes, out_len), DECODE_RUNS, queue_ahead=True,
                      ahead_cycles=PREDICT_AHEAD_CYCLES)
    issued, _ = timed(lambda: units_from_codes(codes, out_len), DECODE_RUNS)
    return {"ms": ms, "min_ms": min(times), "issued_ms": issued, "codes": m, "units": out_len}


def block_phase(pool, smi):
    """Block ingest and the digram codec on the card (module docstring,
    phase 23), from a replay file of the superbatch phase's 8 one-bucket
    batches."""
    import tempfile

    import numpy as np

    from twtml_tpu_torch.apps import kmeans as kmeans_app
    from twtml_tpu_torch.apps import logistic_regression
    from twtml_tpu_torch.features.arena import get_arena
    from twtml_tpu_torch.features.blocks import ParsedBlock
    from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD
    from twtml_tpu_torch.streaming.journal import IntakeJournal

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="twtml-block-")
    path = os.path.join(tmp, "stream.jsonl")
    write_replay(path, pool)
    twice = os.path.join(tmp, "twice.jsonl")
    with open(path, "rb") as src, open(twice, "wb") as dst:
        data = src.read()
        dst.write(data + data)
    phase("block", f"replay file of {len(pool)} tweets ({len(data)} B), written in "
          f"{time.perf_counter() - t_phase:.2f} s | card: {smi}")
    argv = ["--backend", "cuda", *BLOCK_ARGV, "--replayFile", path]

    # -- the three ingest arms: the same batches, bitwise
    runs = {}
    for arm, extra in BLOCK_ARMS:
        totals, lines, rec = block_run([*argv, *extra])
        if (totals["batches"], totals["count"], rec["launches"]) != (
                BLOCK_BATCHES, BLOCK_BATCHES * OP_ROWS, BLOCK_BATCHES + 1):
            raise AssertionError(f"block {arm}: {totals['batches']} batches, "
                                 f"{totals['count']} rows, B1 launched {rec['launches']}")
        check_counters(f"block {arm}", rec, BLOCK_BATCHES, "ragged")
        parse = rec["parse"]
        if arm != "object" and not (parse["parses_wire"] >= 1 and parse["parses_native"]
                                    == parse["parses_python"] == parse["wire_degraded"]
                                    == parse["native_degraded"] == 0):
            raise AssertionError(f"block {arm}: parse counters {parse}")
        if rec["counters"]["wire.codec_fallbacks"] or rec["counters"][
                "ingest.rows_dropped_parse"]:
            raise AssertionError(f"block {arm}: counters {rec['counters']}")
        if arm == "block+codec" and not all(st.get("units_coded_bytes") for st in
                                            totals["steps"]):
            raise AssertionError("block+codec: a batch shipped raw units")
        runs[arm] = (totals, lines, rec)
    rows = hold_bitwise("block", runs)
    phase("block", f"object, block and block+codec arms: batch rows {rows}, lines, "
          "weights, predictions, stats and quality bitwise equal; B1 launched "
          f"{BLOCK_BATCHES} + 1 times in each, every dispatch under "
          "set_sync_debug_mode('error'); wire emitter parses "
          f"{runs['block+codec'][2]['parse']['parses_wire']}, 0 degraded, 0 codec fallbacks")
    summary = {}
    for arm, (totals, lines, rec) in runs.items():
        later = totals["steps"][1:]
        subs = {}
        for st in later:
            for k, v in st["featurize_substages_ms"].items():
                subs[k] = subs.get(k, 0.0) + v / len(later)
        span = later[-1]["delivered_s"] - totals["steps"][0]["delivered_s"]
        rate = len(later) * OP_ROWS / span
        mean = {k: statistics.mean(st[k] for st in later)
                for k in ("featurize_ms", "pack_ms", "wire_bytes", "step_ms", "dispatch_ms")}
        units = [st.get("units_bytes") for st in later]
        coded = [st.get("units_coded_bytes") for st in later]
        summary[arm] = {"featurize_ms": mean["featurize_ms"], "substages_ms": subs,
                        "pack_ms": mean["pack_ms"], "wire_bytes": mean["wire_bytes"],
                        "step_ms": mean["step_ms"], "tweets_per_s": rate,
                        "parse_tweets_per_s": rec["parse_rate"] or None,
                        "units_bytes": units[0], "units_coded_bytes": coded[0],
                        "codec_ratio": rec["codec_ratio"] if coded[0] else None,
                        "parse": rec["parse"]}
        phase("block", f"{arm}: batches 2-{BLOCK_BATCHES} mean featurize "
              f"{mean['featurize_ms']:.2f} ms (" + ", ".join(
                  f"{k} {v:.2f}" for k, v in subs.items()) + f"), pack {mean['pack_ms']:.3f} "
              f"ms, wire {mean['wire_bytes']:.0f} B" + (
                  f" (units {units[0]} B raw, {coded[0]} B coded, wire.codec_ratio "
                  f"{rec['codec_ratio']})" if coded[0] else "")
              + f", step {mean['step_ms']:.3f} ms (CUDA events); "
              f"{len(later) * OP_ROWS} tweets delivered in {span:.4f} s = {rate:.0f} "
              f"tweets/s; parse rate {rec['parse_rate']:.0f} tweets/s (the "
              "ingest.parse_tweets_per_s gauge, last chunk)" + "; lines: " + " / ".join(
                  lines[:2]))

    # -- the CPU twin of the coded arm
    cpu_totals, cpu_lines = app_run(["--backend", "cpu", *BLOCK_ARGV, "--replayFile", path,
                                     *BLOCK_ARMS[2][1]])
    card_totals, card_lines, _ = runs["block+codec"]
    if card_lines[0] != cpu_lines[0] or len(cpu_lines) != BLOCK_BATCHES:
        raise AssertionError(f"block: batch 1 on the card {card_lines[0]!r}, on the CPU "
                             f"{cpu_lines[0]!r} ({len(cpu_lines)} lines)")
    s_err = 0.0
    for i, (g, c) in enumerate(zip(card_totals["steps"], cpu_totals["steps"], strict=True)):
        for k in ("count", "mse", "real_stdev", "pred_stdev"):
            err = abs(g[k] - c[k]) / max(abs(c[k]), 1e-30)
            s_err = max(s_err, err)
            if abs(g[k] - c[k]) > RTOL * abs(c[k]) + ATOL:
                raise AssertionError(f"block batch {i + 1} {k}: card {g[k]} cpu {c[k]}")
    phase("block", f"block+codec against --backend cpu: batch 1's line identical, every "
          f"stat of {BLOCK_BATCHES} batches within rtol {RTOL:g} (largest {s_err:.3g})")

    # -- the wire and the device decode at the operating point
    get_arena().use_device("cuda")
    batches, raw, coded, pack_ms = block_wires(path)
    h2d = {"raw": h2d_ms(raw[1]), "dict": h2d_ms(coded[1])}
    prof = {"raw": step_profile(raw), "dict": step_profile(coded)}
    decode = decode_times(coded[0])
    decode_launches = (None if None in prof.values()
                       else prof["dict"]["kernels"] - prof["raw"]["kernels"])
    phase("block", f"pack of a batch (median of 15): raw {pack_ms['raw']:.3f} ms, coded "
          f"{pack_ms['dict']:.3f} ms (the encode: {pack_ms['dict'] - pack_ms['raw']:.3f} ms); "
          f"wire {raw[1].buffer.nbytes} B raw, {coded[1].buffer.nbytes} B coded; H2D "
          f"(batch_to_device, synchronised, median/min of 20): raw {h2d['raw'][0]:.3f}/"
          f"{h2d['raw'][1]:.3f} ms, coded {h2d['dict'][0]:.3f}/{h2d['dict'][1]:.3f} ms")
    for codec, p in prof.items():
        if p is None:
            phase("block", f"{codec} step: the profiler recorded no step kernel; not measured")
            continue
        phase("block", f"{codec} wire, steps 2-3 (profiler): {p['busy_ms']:.3f} ms device "
              f"busy a step, {p['kernels']:g} device kernels and {p['copies']:g} copies a "
              "step")
    phase("block", f"the codec's decode: {decode_launches} kernels a step; "
          f"units_from_codes alone {decode['ms']:.4f} ms of device time (queued ahead, "
          f"median of {DECODE_RUNS}, min {decode['min_ms']:.4f}; CUDA events), "
          f"{decode['issued_ms']:.4f} ms as the step issues it (its launches not queued "
          f"ahead), for {decode['codes']} codes to {decode['units']} units, bitwise the "
          "host decode")

    # -- the superbatch and the tenant plane with the codec
    sb_argv = ["--backend", "cuda", *BLOCK_ARGV, "--replayFile", twice, "--ingest", "block",
               "--superBatch", str(SB_K), "--tokenBucket", "64", "--wirePack", "group"]
    sb = {}
    for arm, extra in (("group", []), ("group+codec", ["--wireCodec", "dict"])):
        totals, lines, rec = block_run([*sb_argv, *extra])
        if (totals["batches"], rec["groups"], rec["captured"]) != (2 * BLOCK_BATCHES, 3, 2):
            raise AssertionError(f"block superbatch {arm}: {totals['batches']} batches, "
                                 f"{rec['groups']} step_many calls, {rec['captured']} graphs")
        rec["outputs"] = rec["outputs"][SB_K:]  # the warm-up group's
        sb[arm] = (totals, lines, rec)
    hold_bitwise("block superbatch", sb)
    phase("block", f"--superBatch {SB_K} --wirePack group, {2 * BLOCK_BATCHES} block batches: "
          "with --wireCodec dict bitwise without it; 2 groups a run, the second replaying "
          "the CUDA graph the first captured (the decode inside it); B1 launches "
          f"{sb['group+codec'][2]['launches']} (the warm-up group's included)")
    tn_argv = ["--backend", "cuda", *BLOCK_ARGV, "--replayFile", path, "--ingest", "block",
               "--tenants", str(TENANT_M), "--wirePack", "group"]
    tn = {}
    for arm, extra in (("group", []), ("group+codec", ["--wireCodec", "dict"])):
        totals, lines, rec = tenant_app_run([*tn_argv, *extra], None)
        if (totals["batches"], rec["launches"]) != (BLOCK_BATCHES,
                                                    TENANT_M * (BLOCK_BATCHES + 1)):
            raise AssertionError(f"block tenants {arm}: {totals['batches']} ticks, B1 "
                                 f"launched {rec['launches']}")
        tn[arm] = (totals, lines, rec)
    hold_bitwise("block tenants", tn)
    RECORDER.take()
    phase("block", f"--tenants {TENANT_M} --wirePack group on the block source: with "
          f"--wireCodec dict bitwise without it over {BLOCK_BATCHES} ticks (lines, the "
          f"[{TENANT_M}, 1004] stack, each tick's outputs); B1 "
          f"{tn['group+codec'][2]['launches']} launches")

    # -- the logistic and k-means apps on block batches, against the CPU
    two = os.path.join(tmp, "two_class.jsonl")
    write_replay(two, two_class_statuses(LOGISTIC_BATCHES * OP_ROWS, 11))
    lg = dict(app_module=logistic_regression, learner=StreamingLogisticRegressionWithSGD)
    lg_argv = [*BLOCK_ARGV, "--replayFile", two, "--ingest", "block"]
    totals, lines, rec = block_run(["--backend", "cuda", *lg_argv], LOGISTIC_BATCHES, **lg)
    _, cpu_lines, _ = recorded_app_run(["--backend", "cpu", *lg_argv], LOGISTIC_BATCHES, **lg)
    if lines != cpu_lines or rec["launches"] != LOGISTIC_BATCHES + 1:
        raise AssertionError(f"block logistic: lines {lines} against the CPU's {cpu_lines}, "
                             f"B1 launched {rec['launches']}")
    km_argv = [*BLOCK_ARGV, "--replayFile", path, "--ingest", "block"]
    _, km_lines, km = kmeans_run("cuda", None, km_argv)
    _, kc_lines, kc = kmeans_run("cpu", None, km_argv)
    RECORDER.take()
    if (km_lines != kc_lines or len(km_lines) != KMEANS_BATCHES
            or not all(np.array_equal(a, b) for a, b in zip(km["assign"], kc["assign"],
                                                             strict=True))):
        raise AssertionError(f"block kmeans: lines {km_lines} against the CPU's {kc_lines}")
    phase("block", f"logistic app, {LOGISTIC_BATCHES} two-class block batches: lines equal "
          f"the CPU run's ({lines[-1]}); k-means, {KMEANS_BATCHES} block batches (every "
          f"retweet): lines and assignments equal the CPU run's ({km_lines[-1]})")

    # -- a poisoned batch rolls back and replays its rows from kind-2 records
    ck = ["--ingest", "block", "--checkpointEvery", "1"]
    clean, clean_lines, _ = block_run([*argv, *ck, "--checkpointDir", f"{tmp}/clean"])
    got, lines, rec = block_run([*argv, *ck, "--checkpointDir", f"{tmp}/poison",
                                 "--chaos", "source.nan@5"])
    expect("block poison@5", {**rec["counters"], "batches": got["batches"],
                              "count": got["count"], "fetches": rec["fetches"]},
           {"model.rollbacks": 1, "model.nonfinite_batches": 1, "model.rows_lost": 0,
            "journal.replayed_rows": OP_ROWS, "fetch.aborts": 0, "checkpoint.quarantined": 0,
            "fetches": BLOCK_BATCHES + 1, "batches": BLOCK_BATCHES,
            "count": BLOCK_BATCHES * OP_ROWS})
    journal = IntakeJournal(f"{tmp}/poison/journal")
    items = [item for _, its in journal.records_from(0) for item in its]
    journal.close()
    w_p, meta_p = archive(f"{tmp}/poison")
    w_c, meta_c = archive(f"{tmp}/clean")
    if (lines != clean_lines or not np.array_equal(w_p, w_c)
            or meta_p["count"] != meta_c["count"]
            or not items or not all(isinstance(b, ParsedBlock) for b in items)):
        raise AssertionError(f"block poison@5: lines, final archive or the journal's "
                             f"{len(items)} records differ from the clean run's")
    RECORDER.take()
    wall = time.perf_counter() - t_phase
    phase("block", f"--chaos source.nan@5 --checkpointEvery 1: 1 rollback, "
          f"{OP_ROWS} rows replayed from the journal's kind-2 (block) records "
          f"({len(items)} records, {sum(b.rows for b in items)} rows on disk), 0 lost; "
          f"lines and the final archive bitwise the clean run's; phase wall {wall:.1f} s "
          f"| card: {smi}")
    return {"launches": runs["block+codec"][2]["launches"], "arms": summary,
            "cpu_stats_err": s_err, "pack_ms": pack_ms,
            "wire_bytes": {"raw": int(raw[1].buffer.nbytes),
                           "dict": int(coded[1].buffer.nbytes)},
            "h2d_ms": {k: v[0] for k, v in h2d.items()}, "step": prof,
            "decode_launches": decode_launches, "decode": decode, "seconds": wall}


# ---- the multihost phase: the lockstep runtime, 2 ranks on cuda:0 over gloo ----

MH_RANKS = 2
MH_ROWS = OP_ROWS // MH_RANKS  # a rank's rows of the global B = 16384
MH_BATCHES = 4
MH_ARGV = ["--backend", "cuda", "--source", "replay", "--seconds", "0", "--tokenBucket", "64",
           "--maxQueueRows", "-1"]
MH_GRAM_ARGV = ["--numTextFeatures", str(GRAM_F), "--l2Reg", "0.1"]
MH_TIMEOUT_S = 300
MH_WATCHDOG_S = 20  # TWTML_LOCKSTEP_TIMEOUT_S of the peer.kill arm
MH_WEIGHT_RTOL, MH_WEIGHT_ATOL = 1e-4, 1e-7  # the JAX multi-host test's
MH_STAT_SLACK = 2  # rounded stats: the JAX multi-host test's rule
SPLIT_ENTRIES = ("fused_dense_grad", "fused_dense_update")


def split_launches_a_step():
    """Each split entry's launches in one step of OP_ITERS iterations: an
    iteration's launch each iteration, the update alone once
    (``fused_sgd.split_schedule``)."""
    return {"fused_dense_grad": OP_ITERS, "fused_dense_update": 1}

# one rank: the linear app as ``main`` runs it (``run`` on the parsed flags),
# then its launch counts, collectives and step times as the last line
MH_RANK = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from twtml_tpu_torch.apps import linear_regression
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.ops import fused_gram, fused_sgd
from twtml_tpu_torch.parallel import distributed
from twtml_tpu_torch.telemetry import metrics
failed, totals = None, {}
try:
    totals = linear_regression.run(ConfArguments().parse(sys.argv[2:]))
except RuntimeError as exc:
    failed = str(exc)
launches = {n: getattr(fused_sgd, n).launches for n in ("fused_dense_grad", "fused_dense_update")}
launches["fused_dense_sgd"] = fused_sgd.fused_dense_sgd.launches
launches.update({fn.__name__: fn.launches for fn in fused_gram.KERNELS})
print(json.dumps({"failed": failed, "count": totals.get("count"),
                  "batches": totals.get("batches"),
                  "stream_seconds": totals.get("stream_seconds"),
                  "step_ms": [s.get("step_ms") for s in totals.get("steps", [])],
                  "launches": launches, "collectives": distributed.COUNTERS,
                  "seconds": distributed.SECONDS,
                  "counters": metrics.get_registry().snapshot()["counters"]}), flush=True)
sys.stdout.flush()
sys.exit(3 if failed else 0)
"""


def mh_group(name, argv, env=None, timeout=MH_TIMEOUT_S):
    """The linear app on MH_RANKS ranks of one group (``--master
    twtml://``, every rank on cuda:0, so gloo): each rank's (exit code,
    stats lines, its JSON record or None, stderr tail, wall s). Every rank
    is stopped before this returns."""
    port = free_port()
    full_env = dict(os.environ, **(env or {}))
    full_env.pop("TWTML_SYNC_DEBUG", None)  # a gloo all-reduce waits for the card
    procs, t0 = [], time.perf_counter()
    for rank in range(MH_RANKS):
        args = [sys.executable, "-c", MH_RANK, PACKAGE_ROOT, *argv,
                "--lightning", RECORDER.url, "--twtweb", RECORDER.url,
                "--master", f"twtml://127.0.0.1:{port}", "--numProcesses", str(MH_RANKS),
                "--processId", str(rank)]
        procs.append(subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env=full_env))
    out = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            lines = stdout.splitlines()
            rec = None
            if lines and lines[-1].startswith("{"):
                rec = json.loads(lines[-1])
            out.append((p.returncode, [ln for ln in lines if ln.startswith("count:")], rec,
                        stderr[-4000:], time.perf_counter() - t0))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return out


def mh_ok(name, results):
    for rank, (rc, _lines, rec, err, _wall) in enumerate(results):
        if rc != 0 or rec is None or rec["failed"]:
            raise AssertionError(f"multihost {name}: rank {rank} exited {rc}:\n{err}")
    return results


def mh_hold_lines(name, got, want):
    """The JAX multi-host test's rule for the lead's lines against one
    process's: as many lines, count and batch exact, rounded stats within
    MH_STAT_SLACK."""
    import re

    if len(got) != len(want) or not got:
        raise AssertionError(f"multihost {name}: {len(got)} lines against {len(want)}")
    for g_line, w_line in zip(got, want):
        g = [int(x) for x in re.findall(r"-?\d+", g_line)]
        w = [int(x) for x in re.findall(r"-?\d+", w_line)]
        if g[:2] != w[:2] or len(g) != len(w) or any(
                abs(a - b) > MH_STAT_SLACK for a, b in zip(g[2:], w[2:])):
            raise AssertionError(f"multihost {name}: {g_line!r} against {w_line!r}")


def mh_hold_weights(name, got_dir, want):
    import numpy as np

    from twtml_tpu_torch.checkpoint import Checkpointer

    got, meta = Checkpointer(got_dir).restore()
    got = np.asarray(got)
    err = float(np.max(np.abs(got - want)))
    if not np.allclose(got, want, rtol=MH_WEIGHT_RTOL, atol=MH_WEIGHT_ATOL):
        raise AssertionError(f"multihost {name}: weights differ from one process's by "
                             f"{err:.3g} (rtol {MH_WEIGHT_RTOL}, atol {MH_WEIGHT_ATOL})")
    return err, meta


def mh_arm(name, path, workdir, rows, extra=(), single_rows=None, label="multihost"):
    """One arm: the group on ``path`` at ``rows`` a rank against one
    process on the card (in this process) at ``single_rows``; the lead's
    lines and the final weights held, the follower silent. Returns the
    ranks' records, the single run's totals and the weights' max error."""
    from twtml_tpu_torch.checkpoint import Checkpointer

    d_multi, d_single = (os.path.join(workdir, f"{name}-{k}") for k in ("multi", "single"))
    argv = [*MH_ARGV, "--replayFile", path, *extra]
    totals, single_lines = app_run(
        [*argv, "--batchBucket", str(single_rows or rows * MH_RANKS),
         "--checkpointDir", d_single])
    results = mh_ok(name, mh_group(name, [*argv, "--batchBucket", str(rows),
                                          "--checkpointDir", d_multi]))
    if results[1][1]:
        raise AssertionError(f"multihost {name}: the follower printed {results[1][1][:2]}")
    single_lines = [ln for ln in single_lines if ln.startswith("count:")]
    mh_hold_lines(name, results[0][1], single_lines)
    err, meta = mh_hold_weights(name, d_multi, Checkpointer(d_single).restore()[0])
    if meta["count"] != totals["count"]:
        raise AssertionError(f"multihost {name}: the group counted {meta['count']} rows, "
                             f"one process {totals['count']}")
    phase(label, f"{name}: {len(single_lines)} lines held (count and batch exact, "
          f"stats within {MH_STAT_SLACK}), weights within {err:.3g} of one process's, "
          f"follower silent; group wall {results[0][4]:.1f} s")
    return [r[2] for r in results], totals, err, d_multi, argv


def mh_rank_numbers(name, recs, totals, steps, label="multihost"):
    """Per rank: step device ms, launches a step (``steps``: the batches and
    the warm-up's), the all-reduce's and the cadence all-gather's host ms,
    host wall a tick; tweets/s against one process."""
    import statistics as st

    out = []
    single_rate = totals["count"] / totals["stream_seconds"]
    for rank, rec in enumerate(recs):
        c, s = rec["collectives"], rec["seconds"]
        ticks = max(1, c["cadence_allgathers"])
        row = {
            "rank": rank,
            "step_device_ms": st.median(rec["step_ms"]) if rec["step_ms"] else None,
            "launches_a_step": {k: v / steps for k, v in rec["launches"].items() if v},
            "allreduce_ms": 1e3 * s["allreduce"] / max(1, c["allreduces"]),
            "allreduces_a_step": c["allreduces"] / steps,
            "cadence_allgather_ms": 1e3 * s["cadence_allgather"] / ticks,
            "host_wall_a_tick_ms": 1e3 * rec["stream_seconds"] / ticks,
            "ticks": ticks,
            "tweets_per_s": rec["count"] / rec["stream_seconds"],
            "single_process_tweets_per_s": single_rate,
        }
        out.append(row)
        phase(label, f"{name} rank {rank}: step {row['step_device_ms']:.3f} ms "
              f"(CUDA events), launches a step {row['launches_a_step']}, all-reduce "
              f"{row['allreduce_ms']:.3f} ms x {row['allreduces_a_step']:.0f} a step, cadence "
              f"all-gather {row['cadence_allgather_ms']:.3f} ms, host wall a tick "
              f"{row['host_wall_a_tick_ms']:.1f} ms, {row['tweets_per_s']:.0f} tweets/s "
              f"(one process {single_rate:.0f})")
    return out


def split_checks():
    """The split at world size 1 through MultiHostSGDModel (a one-rank gloo
    group) against B1 on the same wire, bitwise, in both residual modes;
    each split entry against its plain twin on the card. Returns each
    entry's max error against its twin."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.models.logistic import StreamingLogisticRegressionWithSGD
    from twtml_tpu_torch.ops import fused_sgd
    from twtml_tpu_torch.parallel import distributed as D
    from twtml_tpu_torch.parallel.mesh import make_mesh
    from twtml_tpu_torch.parallel.sharding import ParallelSGDModel
    from twtml_tpu_torch.streaming.sources import SyntheticSource

    statuses = list(SyntheticSource(total=OP_ROWS, seed=11, base_ms=NOW_MS).produce())
    batch = Featurizer(now_ms=NOW_MS).featurize_batch_ragged(
        statuses, row_bucket=OP_ROWS, unit_bucket=64)
    store = dist.TCPStore("127.0.0.1", free_port(), 1, is_master=True,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, world_size=1, rank=0)
    try:
        for learner in (StreamingLinearRegressionWithSGD, StreamingLogisticRegressionWithSGD):
            plain = learner(device="cuda", quality=True)
            mesh = make_mesh(num_processes=1)
            inner = ParallelSGDModel(
                mesh, D.Collectives(rank=0, world=1, staged=True), device="cuda",
                quality=True, residual_fn=learner.residual_fn,
                prediction_fn=learner.prediction_fn,
                round_predictions=learner.round_predictions,
                step_size=learner.default_step_size)
            multi = D.MultiHostSGDModel(inner, mesh)
            before = {e: getattr(fused_sgd, e).launches for e in SPLIT_ENTRIES}
            for _ in range(2):  # the second step from the first's weights
                a, b = plain.step(batch), multi.step(multi.pack_for_wire(batch))
            torch.cuda.synchronize()
            ran = {e: getattr(fused_sgd, e).launches - before[e] for e in SPLIT_ENTRIES}
            if ran != {e: 2 * k for e, k in split_launches_a_step().items()}:
                raise AssertionError(f"the world-size-1 steps made split launches {ran}")
            same = (np.array_equal(plain.latest_weights, multi.latest_weights)
                    and torch.equal(a.predictions, b.predictions)
                    and all(torch.equal(getattr(a, k), getattr(b, k))
                            for k in ("count", "mse", "real_stdev", "pred_stdev")))
            if not same:
                raise AssertionError(f"{learner.__name__}: the split loop at world size 1 "
                                     "differs from B1")
            phase("multihost", f"split at world size 1 through MultiHostSGDModel, "
                  f"{learner.__name__}: weights, predictions and stats bitwise B1's "
                  "(2 steps)")
    finally:
        dist.destroy_process_group()
    return split_twin_errors()


SPLIT_SHAPES = ((MH_ROWS, 1004), (4096, 2000), (4096, 8196))  # narrow, wide (2 and 9 tiles)
# ~20 ms of torch.cuda._sleep ahead of a timed run of split launches: the
# host takes 10-30 µs to enqueue each (a Python wrapper and a ctypes call),
# longer than a launch takes on the card, so a shorter lead lets the card
# wait for the host and times the enqueue
SPLIT_AHEAD_CYCLES = 40_000_000


def split_queued(fn, runs, n=50):
    """``fn``'s device time a call, ``n`` calls queued behind
    SPLIT_AHEAD_CYCLES of sleep (the median of ``runs``, after one
    unqueued round), and the host's µs to enqueue one (the median over the
    runs). Returns (ms, all runs' ms, host µs)."""
    import torch

    def many():
        for _ in range(n):
            fn()

    many()
    runs_ms, host_us = [], []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SPLIT_AHEAD_CYCLES)
        start.record()
        t0 = time.perf_counter()
        many()
        host_us.append(1e6 * (time.perf_counter() - t0) / n)
        end.record()
        end.synchronize()
        runs_ms.append(start.elapsed_time(end) / n)
    return statistics.median(runs_ms), runs_ms, statistics.median(host_us)


def split_inputs(rows=MH_ROWS, features=1004, seed=5, logistic=False):
    """A tweet-like batch (``design``) on the card for the split's checks
    and times: 97 % of the rows valid, a small w0, 0/1 labels for the
    logistic mode."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x, y, m = design(rng, rows, features, rows - rows // 32)
    if logistic:
        y = (rng.random(rows) < 0.5).astype("float32")
    w0 = rng.normal(size=features).astype("float32") * 1e-3
    return tuple(torch.from_numpy(a).cuda() for a in (x, y, m, w0))


def split_loop_check(name, x, y, m, w0, **kw):
    """The split loop at world size 1 (the all-reduce an identity) against
    B1 on the same inputs: weights and margins bitwise; with NaN/Inf in the
    masked rows, bitwise the clean run's."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    w_b1, p_b1 = fused_sgd.fused_dense_sgd(x, y, m, w0, **kw)
    w_s, p_s = fused_sgd.fused_dense_sgd_split(x, y, m, w0, allreduce=lambda t: t, **kw)
    keep = m > 0
    x_d = torch.where(keep[:, None], x, float("nan"))
    y_d = torch.where(keep, y, float("inf"))
    w_d, p_d = fused_sgd.fused_dense_sgd_split(x_d, y_d, m, w0, allreduce=lambda t: t, **kw)
    torch.cuda.synchronize()
    if not (torch.isfinite(w_b1).all() and torch.equal(w_s, w_b1) and torch.equal(p_s, p_b1)):
        raise AssertionError(f"split loop {name}: differs from B1 by "
                             f"{float((w_s - w_b1).abs().max()):.3g} (weights), "
                             f"{float((p_s - p_b1).abs().max()):.3g} (margins)")
    if not (torch.equal(w_d, w_s) and torch.equal(p_d, p_s)):
        raise AssertionError(f"split loop {name}: NaN/Inf in masked rows reached the result")
    return int((~keep).sum())


def split_fold_check(name, plan, x, y, m, w0, mode, kw):
    """The iteration's launch against its parts, at it = 1 and 2. The first
    launch: its per-CTA partials summed in torch against
    ``fused_dense_grad_reference``'s Xᵀr (its margins too), its gbuf
    within 1e-6·max|Xᵀr| of the partials' float64 sum and its count exact.
    Then from that launch's buffers (the all-reduce an identity): the
    update-only launch of iteration 1 bitwise ``fused_dense_update_reference``
    (weights and the step's flag), and the launch at it = 2 bitwise that
    update followed by a first launch from its weights (weights, the
    iterations run, the flag and, unless the update stopped the step, the
    gbuf of Xᵀr and count). Returns the grad launch's (max abs error, max
    relative error) against its twin and the update's max abs error."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    rows, f = x.shape
    fpad = plan.fpad
    rf = (fused_sgd.least_squares_residual, fused_sgd.logistic_residual)[mode]
    bufs = fused_sgd.split_buffers(plan, x.device)
    w, preds = torch.empty_like(w0), torch.empty_like(y)
    fused_sgd.fused_dense_grad(plan, bufs, x, y, m, w0, w, preds, it=1, mode=mode, **kw)
    partials = bufs.scratch[:plan.grid * fpad].view(plan.grid, fpad).clone()
    after_1 = fused_sgd.SplitBuffers(*(t.clone() for t in bufs))
    g_ref, count_ref, raw_ref = fused_sgd.fused_dense_grad_reference(x, y, m, w0, residual_fn=rf)
    torch.cuda.synchronize()
    scale_g = float(g_ref.abs().max().clamp(min=1))
    summed = partials.double().sum(dim=0)
    g_abs = float((summed[:f] - g_ref.double()).abs().max())
    p_abs = float((preds - raw_ref).abs().max())
    pad_abs = float(summed[f:].abs().max()) if fpad > f else 0.0
    r_abs = float((bufs.gbuf[:fpad].double() - summed).abs().max())
    if bufs.gbuf[fpad].item() != count_ref.item():
        raise AssertionError(f"fused_dense_grad ({name}): the count differs from the twin's")
    if g_abs > 1e-5 * scale_g or p_abs > 1e-3 or pad_abs:
        raise AssertionError(f"fused_dense_grad ({name}): Xᵀr off by {g_abs:.3g} (max |Xᵀr| "
                             f"{scale_g:.3g}), margins by {p_abs:.3g}, padded columns "
                             f"{pad_abs:.3g}")
    if r_abs > 1e-6 * scale_g:
        raise AssertionError(f"fused_dense_grad ({name}): gbuf off the partials' sum by "
                             f"{r_abs:.3g}")
    # path A: the launch at it = 2 (the update of 1, then the row pass)
    fused_sgd.fused_dense_grad(plan, bufs, x, y, m, w0, w, preds, it=2, mode=mode, **kw)
    # path B: the update of 1 alone from the same buffers, then a first launch
    gbuf_1 = torch.cat([after_1.gbuf[:f], after_1.gbuf[fpad:]])
    want, stop = fused_sgd.fused_dense_update_reference(w0, gbuf_1, f, it=1, **kw)
    w_b = torch.empty_like(w0)
    fused_sgd.fused_dense_update(plan, after_1, w_b, f, it=1, **kw)
    torch.cuda.synchronize()
    u_abs = float((w_b - want).abs().max())
    if (not torch.equal(w_b, want)
            or bool(after_1.state[0].item()) != bool(stop.item())):
        raise AssertionError(f"fused_dense_update ({name}) differs from its twin by "
                             f"{u_abs:.3g} (flag {after_1.state[0].item()} against "
                             f"{bool(stop.item())})")
    fresh = fused_sgd.split_buffers(plan, x.device)
    w_c, preds_c = torch.empty_like(w0), torch.empty_like(y)
    fused_sgd.fused_dense_grad(plan, fresh, x, y, m, w_b.clone(), w_c, preds_c, it=1,
                               mode=mode, **kw)
    torch.cuda.synchronize()
    same = (torch.equal(w, w_b) and torch.equal(bufs.state, after_1.state)
            and torch.equal(bufs.scratch[-1:], after_1.scratch[-1:])
            and torch.equal(bufs.scratch[plan.grid * fpad:][:fpad],
                            after_1.scratch[plan.grid * fpad:][:fpad])
            and torch.equal(bufs.gbuf, after_1.gbuf if bool(stop.item()) else fresh.gbuf))
    if not same:
        raise AssertionError(f"fused_dense_grad ({name}) at it = 2 differs from the update-only "
                             "launch followed by a first launch from its weights")
    return max(g_abs, p_abs, r_abs), max(g_abs, r_abs) / scale_g, u_abs


def split_twin_errors():
    """The split at each of SPLIT_SHAPES (B1's narrow pass at a rank's
    operating point, its tiled wide pass at 2000 and 8196 columns), in both
    residual modes: the loop at world size 1 bitwise B1's, NaN/Inf in masked
    rows bitwise ignored; the launches against their parts and twins
    (``split_fold_check``). Then a batch on which the loop diverges (dense
    0-2 counts at 4096 x 8196, step 0.005, 50 iterations: the weights
    overflow) through B1 and the split: the same non-finite pattern and
    values. Returns each entry's max abs error and max relative error
    against its twin."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    sms, shared = fused_sgd.device_limits(torch.cuda.current_device())
    abs_err = dict.fromkeys(SPLIT_ENTRIES, 0.0)
    rel_err = dict.fromkeys(SPLIT_ENTRIES, 0.0)
    for rows, f in SPLIT_SHAPES:
        for mode, rf in enumerate((fused_sgd.least_squares_residual,
                                   fused_sgd.logistic_residual)):
            x, y, m, w0 = split_inputs(rows, f, seed=5 + mode, logistic=bool(mode))
            step = 0.1 if mode else 0.005
            masked = split_loop_check(f"{rows} x {f} mode {mode}", x, y, m, w0,
                                      num_iterations=OP_ITERS, step_size=step, l2_reg=0.01,
                                      residual_fn=rf)
            plan = fused_sgd.split_plan(rows, f, sm_count=sms, shared_limit=shared)
            g_abs, g_rel, u_abs = split_fold_check(
                f"{rows} x {f}, mode {mode}", plan, x, y, m, w0, mode,
                dict(step_size=step, l2_reg=0.01, convergence_tol=0.001))
            for e, a, r in (("fused_dense_grad", g_abs, g_rel), ("fused_dense_update", u_abs, 0.0)):
                abs_err[e], rel_err[e] = max(abs_err[e], a), max(rel_err[e], r)
            phase("multihost", f"split at {rows} x {f} ({'narrow' if f <= 1024 else 'wide'} "
                  f"pass, mode {mode}): the loop at world size 1 bitwise B1's ({OP_ITERS} "
                  f"iterations), NaN/Inf in {masked} masked rows bitwise ignored; the first "
                  f"launch's partials and gbuf within {g_abs:.3g} of the twin's Xᵀr and the "
                  "partials' sum, the count exact; the update-only launch and its flag "
                  "bitwise its twin; the launch at it = 2 bitwise the update-only launch "
                  "and a first launch from its weights")
    # a divergent batch: dense 0-2 counts overflow the loop at 8196 columns
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 3, (4096, 8196), generator=g).float()
    x[:, -4:] = torch.rand(4096, 4, generator=g) * 1e-3
    y = torch.rand(4096, generator=g) * 1000
    m = (torch.rand(4096, generator=g) < 0.95).float()
    w0 = torch.randn(8196, generator=g) * 1e-3
    x, y, m, w0 = (t.cuda() for t in (x, y, m, w0))
    kw = dict(num_iterations=OP_ITERS, step_size=0.005)
    w_b1, p_b1 = fused_sgd.fused_dense_sgd(x, y, m, w0, **kw)
    w_s, p_s = fused_sgd.fused_dense_sgd_split(x, y, m, w0, allreduce=lambda t: t, **kw)
    torch.cuda.synchronize()
    bad = int((~torch.isfinite(w_b1)).sum())
    same = (torch.equal(w_b1.isnan(), w_s.isnan())
            and torch.equal(w_b1.nan_to_num(0.0), w_s.nan_to_num(0.0))
            and torch.equal(p_b1, p_s))
    if not same:
        raise AssertionError("the divergent 4096 x 8196 batch: the split's weights differ "
                             f"from B1's ({bad} of B1's are not finite)")
    phase("multihost", f"a divergent 4096 x 8196 batch: B1's own weights have "
          f"{bad} non-finite of 8196 (the step diverges on dense 0-2 counts), the split's the "
          f"same pattern and values (bit patterns equal: "
          f"{torch.equal(w_b1.view(torch.int32), w_s.view(torch.int32))})")
    return abs_err, rel_err


def split_times(smi, errs, launches):
    """Each split launch's device time at a rank's operating point (the
    iteration's launch at it = 2: X staged, the update of 1 folded in; the
    update alone), its plain version's, the library calls' and its bound;
    a whole split step at world size 1 (the all-reduce an identity) beside
    B1 on the same rows. ``errs``: (max abs error, max relative error) by
    entry."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    x, y, m, w0 = split_inputs()
    rows, f = x.shape
    sms, shared = fused_sgd.device_limits(torch.cuda.current_device())
    plan = fused_sgd.split_plan(rows, f, sm_count=sms, shared_limit=shared)
    bufs = fused_sgd.split_buffers(plan, x.device)
    w, preds = torch.empty_like(w0), torch.empty_like(y)
    kw = dict(step_size=1e-12, l2_reg=0.0, convergence_tol=0.0)  # tol 0: never converged
    fused_sgd.fused_dense_grad(plan, bufs, x, y, m, w0, w, preds, it=1, **kw)
    n = 50
    g_count = torch.cat([bufs.gbuf[:f], bufs.gbuf[plan.fpad:]])
    calls = {
        "fused_dense_grad": lambda: fused_sgd.fused_dense_grad(
            plan, bufs, x, y, m, w0, w, preds, it=2, **kw),
        "fused_dense_update": lambda: fused_sgd.fused_dense_update(plan, bufs, w, f, it=2, **kw),
    }
    plains = {
        "fused_dense_grad": lambda: fused_sgd.fused_dense_iteration_reference(
            x, y, m, w0, g_count, it=2, **kw),
        "fused_dense_update": lambda: fused_sgd.fused_dense_update_reference(
            w0, g_count, f, it=2, **kw),
    }
    # the one PyTorch call for the iteration's main work: Xᵀr as torch.mv on
    # the f32 X the caller holds (4·B·F bytes read, where the kernel reads
    # its staged bf16 copy); beside it the partials' column sums, the work
    # of the reduce that the launch folds in
    residual = (x @ w0 - y) * m
    partials = bufs.scratch[:plan.grid * plan.fpad].view(plan.grid, plan.fpad)
    libraries = {"fused_dense_grad": ("torch.mv(X.t(), r), f32 X", lambda: torch.mv(x.t(), residual))}
    extra_library = ("partials.sum(0)", lambda: partials.sum(0))
    # bytes each launch's function must move, each input read once and each
    # output written once, at the batch's own size (no padding, none of the
    # design's own scratch such as the partials): the iteration reads X
    # (bf16, as B1 stores it), y, the mask, w and the all-reduced Xᵀr and
    # count, and writes w, Xᵀr and the count; the update alone reads w, Xᵀr
    # and the count and writes w
    moved = {
        "fused_dense_grad": 2 * rows * f + 4 * (2 * rows + 4 * f + 2),
        "fused_dense_update": 4 * (3 * f + 1),
    }
    ops = {  # x·w and r·x: two FMAs an element of X; the update's 8 a column
        "fused_dense_grad": 4 * rows * f + 8 * f,
        "fused_dense_update": 8 * f,
    }

    records = []
    for name in SPLIT_ENTRIES:
        ms, _runs, host_us = split_queued(calls[name], 5, n)
        plain_ms = split_queued(plains[name], 3, n)[0]
        library = libraries.get(name, (None, None))
        library_ms = None if library[1] is None else split_queued(library[1], 5, n)[0]
        bytes_ms = moved[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = ops[name] / F32_FLOPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        records.append({
            "name": name, "route": "cuda", "source": "twtml_tpu_torch/csrc/fused_sgd.cu",
            "replaces": "twtml_tpu/ops/pallas_sgd.py:55", "launches": launches[name],
            "max_abs_err": errs[0][name], "max_rel_err": errs[1][name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "library": library[0],
            "bound_bytes": moved[name], "card": smi, "rows": rows, "features": f,
            "grid": plan.grid, "shapes_checked": [list(sh) for sh in SPLIT_SHAPES],
            "host_us_a_launch": host_us,
        })
        phase("multihost", f"{name}: {ms:.5f} ms a launch at B = {rows} x {f} (CUDA events, "
              f"{n} launches queued; the host's enqueue {host_us:.1f} µs a launch), twin "
              f"{plain_ms:.5f} ms, library "
              f"{'none' if library_ms is None else f'{library[0]} {library_ms:.5f} ms'}, "
              f"bound {bound_ms:.5f} ms "
              f"({records[-1]['bound_by']}, {moved[name]} B), launches on the main arm "
              f"{launches[name]}")
    grad = records[0]
    grad["reduce_library"] = extra_library[0]
    grad["reduce_library_ms"] = split_queued(extra_library[1], 5, n)[0]
    # one whole step at world size 1 (OP_ITERS iterations, tol 0), and B1 on the same rows
    step_kw = dict(num_iterations=OP_ITERS, step_size=1e-12, convergence_tol=0.0)
    before = {e: getattr(fused_sgd, e).launches for e in SPLIT_ENTRIES}
    fused_sgd.fused_dense_sgd_split(x, y, m, w0, allreduce=lambda t: t, **step_kw)
    step_launches = sum(getattr(fused_sgd, e).launches - before[e] for e in SPLIT_ENTRIES)
    step_ms = split_queued(lambda: fused_sgd.fused_dense_sgd_split(
        x, y, m, w0, allreduce=lambda t: t, **step_kw), 5, 1)[0]
    b1_ms = split_queued(lambda: fused_sgd.fused_dense_sgd(x, y, m, w0, **step_kw), 5, 1)[0]
    grad.update(step_ms=step_ms, step_launches=step_launches, b1_step_ms=b1_ms)
    phase("multihost", f"split: {grad['ms']:.5f} ms an iteration in one launch, the update "
          f"alone {records[1]['ms']:.5f} ms; {extra_library[0]} {grad['reduce_library_ms']:.5f} "
          f"ms; a step at world size 1 ({OP_ITERS} iterations, the all-reduce an identity) "
          f"{step_ms:.4f} ms in {step_launches} launches against B1's one launch on the same "
          f"rows {b1_ms:.4f} ms; card: {smi}")
    return records, grad["ms"]


def split_iteration_ms(runs=5, n=50):
    """One split iteration's device time at a rank's B = 8192 x 1004 on the
    port this process imports: ``n`` iterations after the first (X staged)
    queued behind SPLIT_AHEAD_CYCLES (``split_queued``), the median of
    ``runs``, and the host's µs to enqueue one; a port with a reduce entry runs
    its three launches an iteration, this one its one. Then a whole step at
    world size 1 (OP_ITERS iterations, tol 0, the all-reduce an identity)
    and its launches, and B1's one launch at B = OP_ROWS x 1004."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    x, y, m, w0 = split_inputs()
    rows, f = x.shape
    sms, shared = fused_sgd.device_limits(torch.cuda.current_device())
    plan = fused_sgd.split_plan(rows, f, sm_count=sms, shared_limit=shared)
    bufs = fused_sgd.split_buffers(plan, x.device)
    w, preds = torch.empty_like(w0), torch.empty_like(y)
    kw = dict(step_size=1e-12, l2_reg=0.0, convergence_tol=0.0)  # tol 0: never converged
    entries = [e for e in ("fused_dense_grad", "fused_dense_grad_reduce", "fused_dense_update")
               if hasattr(fused_sgd, e)]
    if "fused_dense_grad_reduce" in entries:  # three plain launches an iteration
        fused_sgd.fused_dense_grad(plan, bufs, x, y, m, w0, w, preds, first=True)

        def iteration():
            fused_sgd.fused_dense_grad(plan, bufs, x, y, m, w0, w, preds, first=False)
            fused_sgd.fused_dense_grad_reduce(plan, bufs, f)
            fused_sgd.fused_dense_update(plan, bufs, w, f, it=2, **kw)
    else:
        fused_sgd.fused_dense_grad(plan, bufs, x, y, m, w0, w, preds, it=1, **kw)

        def iteration():
            fused_sgd.fused_dense_grad(plan, bufs, x, y, m, w0, w, preds, it=2, **kw)

    median, all_runs, host_us = split_queued(iteration, runs, n)
    step_kw = dict(num_iterations=OP_ITERS, step_size=1e-12, convergence_tol=0.0)
    before = {e: getattr(fused_sgd, e).launches for e in entries}
    fused_sgd.fused_dense_sgd_split(x, y, m, w0, allreduce=lambda t: t, **step_kw)
    launches = sum(getattr(fused_sgd, e).launches - before[e] for e in entries)
    step = split_queued(lambda: fused_sgd.fused_dense_sgd_split(
        x, y, m, w0, allreduce=lambda t: t, **step_kw), runs, 1)
    # B1's one launch at the operating point, the kernel both trees share
    xb, yb, mb, wb = split_inputs(rows=OP_ROWS)
    b1 = split_queued(lambda: fused_sgd.fused_dense_sgd(xb, yb, mb, wb, **step_kw), runs, 1)
    return {"iteration_ms": median, "iteration_ms_runs": all_runs,
            "host_us_an_iteration": host_us,
            "launches_an_iteration": len(entries) if "fused_dense_grad_reduce" in entries else 1,
            "step_ms": step[0], "step_ms_runs": step[1], "step_host_us": step[2],
            "launches_a_step": launches, "b1_ms": b1[0], "b1_ms_runs": b1[1],
            "entries": entries}


def split_ab(smi, pairs, parent_root):
    """``--split-ab N --package-root DIR``: one split iteration at a rank's
    B = 8192 x 1004, the port found in DIR (e.g. the parent commit
    unpacked there: three plain launches an iteration) against this
    checkout's (one cooperative launch), each arm in a process of its own
    (``split_iteration_ms``), N pairs, the order alternating; the ptxas
    report of each tree's fused_sgd build."""
    import glob

    def report(i, arm, rec):
        phase("split-ab", f"pair {i} {arm} (run {rec['position'] + 1} of 2): an iteration "
              f"{rec['iteration_ms']:.5f} ms in {rec['launches_an_iteration']} launch(es) "
              f"(CUDA events, 50 queued, median of 5; the host's enqueue "
              f"{rec['host_us_an_iteration']:.1f} µs), a step at world size 1 "
              f"{rec['step_ms']:.4f} ms in {rec['launches_a_step']} launches; B1 at "
              f"{OP_ROWS} x 1004 {rec['b1_ms']:.4f} ms")

    roots = {"parent": parent_root, "change": HERE}
    runs = ab_pairs("split-ab", "split_iteration_ms", pairs, parent_root, report, timeout=600)
    medians = {arm: {k: statistics.median(r[k] for r in rows)
                     for k in ("iteration_ms", "host_us_an_iteration", "step_ms", "b1_ms")}
               for arm, rows in runs.items()}
    wins = sum(c["iteration_ms"] < p["iteration_ms"] for c, p in zip(
        sorted(runs["change"], key=lambda r: r["pair"]),
        sorted(runs["parent"], key=lambda r: r["pair"])))
    for arm, root in roots.items():
        for log in glob.glob(os.path.join(root, "build", "twtml_tpu_torch", "libfused_sgd-*.log")):
            phase("split-ab", f"{arm} build ({os.path.basename(log)}):\n"
                  + open(log).read().strip())
    phase("split-ab", f"medians over {pairs} pairs: an iteration {medians['change']['iteration_ms']:.5f} "
          f"ms against the parent's {medians['parent']['iteration_ms']:.5f}, lower in {wins} of "
          f"{pairs} pairs; the host's enqueue {medians['change']['host_us_an_iteration']:.1f} "
          f"against {medians['parent']['host_us_an_iteration']:.1f} µs an iteration; a step "
          f"{medians['change']['step_ms']:.4f} against "
          f"{medians['parent']['step_ms']:.4f} ms; B1 {medians['change']['b1_ms']:.4f} against "
          f"{medians['parent']['b1_ms']:.4f} ms | card: {smi}")
    print(json.dumps({"split_ab": {"pairs": pairs, "runs": runs, "medians": medians,
                                   "change_wins": wins, "card": smi}}), flush=True)


def mh_block_emulation(path, lines):
    """The group's --ingest block run's weights, emulated in this process:
    tick k's per-rank buckets of their byte-range shards (host 0's rows,
    then host 1's) through one card learner."""
    import numpy as np

    from twtml_tpu_torch.features.batch import UnitBatch
    from twtml_tpu_torch.features.blocks import empty_block, iter_row_chunks
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.streaming.sources import BlockReplayFileSource

    feat = Featurizer(now_ms=NOW_MS)
    chunks = [list(iter_row_chunks(BlockReplayFileSource(
        path, shard_index=i, shard_count=MH_RANKS).produce(), MH_ROWS))
        for i in range(MH_RANKS)]
    ticks = max(len(c) for c in chunks)
    model = StreamingLinearRegressionWithSGD(device=MH_ARGV[1])
    for k in range(ticks):
        parts = [feat.featurize_parsed_block(c[k] if k < len(c) else empty_block(),
                                             row_bucket=MH_ROWS, unit_bucket=64)
                 for c in chunks]
        model.step(UnitBatch(*(np.concatenate([getattr(b, fld) for b in parts])
                               for fld in UnitBatch._fields)))
    if len(lines) != ticks:
        raise AssertionError(f"multihost block: {len(lines)} lines for {ticks} ticks")
    return model.latest_weights


def multihost_phase(smi, statuses):
    """The multihost phase: the lockstep multi-host runtime, 2 ranks of the linear
    app on the one card over gloo, at the global B = 16384 (8192 a rank),
    full width, 50 iterations, on the stream phase's tweets as a replay
    file, against one process on the card; the split kernels against B1
    and their twins; the arms (codec, superbatch, block ingest, the 2^18
    Gram route), a resume, a rollback and a killed peer."""
    import shutil
    import tempfile

    import numpy as np

    from twtml_tpu_torch.checkpoint import Checkpointer

    workdir = tempfile.mkdtemp(prefix="twtml-multihost-")
    try:
        errs = split_checks()
        path = os.path.join(workdir, "tweets.jsonl")
        write_replay(path, statuses[:MH_BATCHES * OP_ROWS])
        # the main arm: the default wire; its counts are the split kernels' launches
        recs, totals, w_err, d_main, argv = mh_arm("main", path, workdir, MH_ROWS)
        launches = {e: sum(r["launches"][e] for r in recs) for e in SPLIT_ENTRIES}
        for rank, rec in enumerate(recs):
            steps = MH_BATCHES + 1
            want = {e: steps * k for e, k in split_launches_a_step().items()}
            got = {e: rec["launches"][e] for e in SPLIT_ENTRIES}
            c = rec["collectives"]
            if got != want or rec["launches"]["fused_dense_sgd"]:
                raise AssertionError(f"multihost main rank {rank}: launches {rec['launches']}, "
                                     f"want {want} and no fused launch")
            if c["allreduces"] != steps * (OP_ITERS + 2) or c["align_allgathers"] != steps:
                raise AssertionError(f"multihost main rank {rank}: collectives {c} for "
                                     f"{steps} steps")
        numbers = {"main": mh_rank_numbers("main", recs, totals, MH_BATCHES + 1),
                   "weights_max_err": w_err}
        # a second run on the same directory: the journal resumes exactly
        again = mh_ok("resume", mh_group("resume", [*argv, "--batchBucket", str(MH_ROWS),
                                                     "--checkpointDir", d_main]))
        meta = Checkpointer(d_main).restore()[1]
        if again[0][1] or meta["count"] != totals["count"]:
            raise AssertionError(f"multihost resume: {len(again[0][1])} new lines, count "
                                 f"{meta['count']}")
        phase("multihost", "resume: the second run trained no batch (count unchanged)")
        # the superbatch's warm-up also steps one all-padding group of K
        for name, extra, steps in (("codec", ["--wireCodec", "dict"], MH_BATCHES + 1),
                                   ("superbatch", ["--superBatch", "4"], MH_BATCHES + 5)):
            recs_x, totals_x, err_x, _d, _a = mh_arm(name, path, workdir, MH_ROWS, extra)
            numbers[name] = {"weights_max_err": err_x,
                             "ranks": mh_rank_numbers(name, recs_x, totals_x, steps)}
        # block ingest on byte-range shards, against its emulation on the card
        d_block = os.path.join(workdir, "block")
        block = mh_ok("block", mh_group("block", [*MH_ARGV, "--replayFile", path,
                                                   "--ingest", "block", "--batchBucket",
                                                   str(MH_ROWS), "--checkpointDir", d_block]))
        err_b, _meta = mh_hold_weights("block", d_block, mh_block_emulation(path, block[0][1]))
        numbers["block"] = {"weights_max_err": err_b}
        phase("multihost", f"block: {len(block[0][1])} ticks of byte-range shards, weights "
              f"within {err_b:.3g} of the emulation on the card")
        # the 2^18 Gram route at B = 2048 (1024 a rank) on short rows
        gram_path = os.path.join(workdir, "gram.jsonl")
        write_replay(gram_path, statuses[:MH_BATCHES * GRAM_ROWS])
        recs_g, totals_g, err_g, _d, _a = mh_arm("gram", gram_path, workdir,
                                                 GRAM_ROWS // MH_RANKS, MH_GRAM_ARGV)
        for rank, rec in enumerate(recs_g):
            if not all(rec["launches"][k] for k in ("count_build", "dual_sgd",
                                                    "dual_writeback_counts")):
                raise AssertionError(f"multihost gram rank {rank}: launches {rec['launches']}")
        numbers["gram"] = {"weights_max_err": err_g,
                           "ranks": mh_rank_numbers("gram", recs_g, totals_g,
                                                    MH_BATCHES + 1)}
        # a poisoned batch rolled back on both ranks
        d_roll = os.path.join(workdir, "rollback")
        roll = mh_ok("rollback", mh_group("rollback", [
            *argv, "--batchBucket", str(MH_ROWS), "--checkpointDir", d_roll,
            "--checkpointEvery", "1", "--chaos", "source.nan@3"]))
        for rank, (_rc, _lines, _rec, err, _wall) in enumerate(roll):
            if "rolled back to verified checkpoint" not in err or "disagree" in err:
                raise AssertionError(f"multihost rollback rank {rank}:\n{err}")
        state, meta = Checkpointer(d_roll).restore()
        if (len(roll[0][1]) != MH_BATCHES or meta["count"] != totals["count"]
                or not np.isfinite(np.asarray(state)).all()):
            raise AssertionError(f"multihost rollback: {len(roll[0][1])} lines, count "
                                 f"{meta['count']}")
        phase("multihost", "rollback: source.nan@3 rolled both ranks back (the follower from "
              f"the lead's broadcast), the journal replayed, {MH_BATCHES} batches trained")
        # a peer killed at tick 3: the survivor aborts within the watchdog's bound
        kill = mh_group("peer.kill", [*argv, "--batchBucket", str(MH_ROWS),
                                      "--chaos", "peer.kill:uid=1:tick=3"],
                        env={"TWTML_LOCKSTEP_TIMEOUT_S": str(MH_WATCHDOG_S)})
        (rc0, _l0, _r0, err0, wall0), (rc1, *_rest) = kill
        # the survivor's wall holds its start-up (a process reaches the card
        # in ~8 s), the warm-up and two ticks, then at most the watchdog
        if rc1 != 77 or rc0 == 0 or "lockstep" not in err0 or wall0 > MH_WATCHDOG_S + 90:
            raise AssertionError(f"multihost peer.kill: exit codes {rc0}, {rc1} after "
                                 f"{wall0:.1f} s:\n{err0}")
        numbers["peer_kill"] = {"survivor_exit": rc0, "survivor_wall_s": wall0}
        phase("multihost", f"peer.kill at tick 3: the peer exited 77, the survivor {rc0} "
              f"after {wall0:.1f} s (watchdog {MH_WATCHDOG_S} s), no hang")
        records, split_ms = split_times(smi, errs, launches)
        numbers["split_ms_an_iteration"] = split_ms
        return records, numbers, {"recs": recs, "numbers": numbers["main"]}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ---- the elastic phase: --elastic on, 2 ranks on cuda:0 over gloo ----------

EL_WATCHDOG_S = 5  # TWTML_LOCKSTEP_TIMEOUT_S of the elastic arms
EL_ENV = {"TWTML_LOCKSTEP_TIMEOUT_S": str(EL_WATCHDOG_S), "TWTML_ELASTIC_RESCUE_GRACE_S": "2",
          "TWTML_ELASTIC_SERVICE_LINGER_S": "3"}
EL_TIMEOUT_S = 240
EL_KILL_TICK = 3
# the rejoin arm: the lead pauses 6 s a tick from the tick after the kill,
# so the restarted rank (~8 s to reach the card) parks before its data ends;
# the arm's watchdog outlasts the pause (the kill shows as a failed all-gather)
EL_PAUSE = f"peer.pause:uid=0:ticks=12@from{EL_KILL_TICK + 1}"
EL_REJOIN_ENV = {"TWTML_LOCKSTEP_TIMEOUT_S": "30"}
# set on every elastic rank to the phase's own work directory: the store
# processes the ranks spawn inherit it, and the phase stops only those
EL_TAG_ENV = "TWTML_CHIP_ELASTIC_RUN"

# one elastic rank: the linear app as ``main`` runs it; it leaves through
# elastic_exit's hard exit, so its record (totals, launches, collectives,
# counters) prints just before
EL_RANK = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from twtml_tpu_torch.apps import linear_regression
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.ops import fused_sgd
from twtml_tpu_torch.parallel import distributed
from twtml_tpu_torch.telemetry import metrics
kept = []
checkpoint = linear_regression.AppCheckpoint
def keeping(conf, get_state, set_state, totals, lead=True):
    kept.append(totals)
    return checkpoint(conf, get_state, set_state, totals, lead=lead)
def report(failed, hard_exit):
    totals = kept[0] if kept else {}
    launches = {n: getattr(fused_sgd, n).launches for n in
                ("fused_dense_grad", "fused_dense_update")}
    launches["fused_dense_sgd"] = fused_sgd.fused_dense_sgd.launches
    snap = metrics.get_registry().snapshot()
    print(json.dumps({"failed": failed, "hard_exit": hard_exit, "count": totals.get("count"),
                      "batches": totals.get("batches"),
                      "stream_seconds": totals.get("stream_seconds"),
                      "launches": launches, "collectives": distributed.COUNTERS,
                      "seconds": distributed.SECONDS, "counters": snap["counters"],
                      "gauges": snap["gauges"]}), flush=True)
elastic_exit = linear_regression.elastic_exit
def exit_reporting(failed=False):
    report("the run failed" if failed else None, True)
    elastic_exit(failed)
linear_regression.AppCheckpoint = keeping
linear_regression.elastic_exit = exit_reporting
try:
    linear_regression.run(ConfArguments().parse(sys.argv[2:]))
except RuntimeError as exc:
    report(str(exc), False)
    sys.exit(3)
report("the run returned instead of leaving through the elastic exit", False)
sys.exit(4)
"""


def el_base_port() -> int:
    """A base port with the elastic group's ports free from it (the beacon
    on base + 1, epoch e's store on base + 2 + e)."""
    from twtml_tpu_torch.parallel.elastic import free_base_port

    return free_base_port()


def el_spawn(tag, rank, argv, base, extra=(), env=None):
    """One elastic rank of the linear app (``--master twtml://``, cuda:0).
    ``tag`` goes into its environment as EL_TAG_ENV, which the store
    processes it spawns inherit: el_reap_store_hosts finds this phase's by
    it."""
    env = dict(os.environ, **{**EL_ENV, **(env or {}), EL_TAG_ENV: tag})
    env.pop("TWTML_SYNC_DEBUG", None)  # a gloo all-reduce waits for the card
    args = [sys.executable, "-c", EL_RANK, PACKAGE_ROOT, *argv, *extra,
            "--lightning", RECORDER.url, "--twtweb", RECORDER.url,
            "--master", f"twtml://127.0.0.1:{base}", "--numProcesses", str(MH_RANKS),
            "--processId", str(rank)]
    return subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def el_collect(procs, t0, name=""):
    """Each process's (exit code, stats lines, record or None, stderr, wall
    s); every process is stopped before this returns. With
    ``TWTML_CHIP_LOG_DIR`` set, each stderr is also written there."""
    out = []
    log_dir = os.environ.get("TWTML_CHIP_LOG_DIR", "")
    try:
        for i, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=EL_TIMEOUT_S)
            if log_dir:
                with open(os.path.join(log_dir, f"elastic-{name}-{i}.log"), "w") as fh:
                    fh.write(stderr)
            lines = stdout.splitlines()
            rec = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
            out.append((p.returncode, [ln for ln in lines if ln.startswith("count:")], rec,
                        stderr, time.perf_counter() - t0))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return out


def el_group(tag, name, argv, extra=((), ())):
    """The two elastic ranks with ``argv`` (and each rank's ``extra``)."""
    t0 = time.perf_counter()
    base = el_base_port()
    return el_collect([el_spawn(tag, r, argv, base, extra[r]) for r in range(MH_RANKS)], t0,
                      name)


def el_tick_split(rec):
    """A rank's host wall a tick (ms) and the part of it in the gloo
    all-reduces and in the cadence all-gather; the rest is the host's own
    (featurize, dispatch, the plane, checkpoint saves). The collectives'
    seconds are the run's (the warm-up step's included) over its ticks, so
    the rest is a lower bound."""
    ticks = max(1, rec["collectives"]["cadence_allgathers"])
    wall, sec = 1e3 * rec["stream_seconds"] / ticks, rec["seconds"]
    allreduce = 1e3 * sec["allreduce"] / ticks
    allgather = 1e3 * sec["cadence_allgather"] / ticks
    return {"host_wall": wall, "allreduces": allreduce, "allgather": allgather,
            "rest": wall - allreduce - allgather}


def el_tick_text(t):
    return (f"{t['host_wall']:.1f} ms (all-reduces {t['allreduces']:.1f}, all-gather "
            f"{t['allgather']:.1f}, rest {t['rest']:.1f})")


def el_survived(name, res, want_rc=(0, 0)):
    for rank, (rc, _lines, rec, err, _wall) in enumerate(res):
        if rc != want_rc[rank]:
            raise AssertionError(f"elastic {name}: rank {rank} exited {rc} (want "
                                 f"{want_rc[rank]}):\n{err[-4000:]}")
        if rc == 0 and (rec is None or rec["failed"] or not rec["hard_exit"]):
            raise AssertionError(f"elastic {name}: rank {rank}'s record {rec}:\n{err[-4000:]}")


def el_log_time(err, text):
    """The host clock (s) of the first log line of ``err`` holding
    ``text`` (the log's asctime, to the millisecond), or None."""
    import datetime

    for line in err.splitlines():
        if text in line:
            stamp = datetime.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f")
            return stamp.timestamp()
    return None


def el_resync(name, err):
    import re

    m = re.search(r"elastic resync: state from the lead's verified checkpoint \(count=(\d+), "
                  r"batches=(\d+), state crc ([0-9a-f]+)\)(?: — (\d+) row\(s\) of "
                  r"post-checkpoint progress rolled back)?", err)
    if m is None:
        raise AssertionError(f"elastic {name}: the survivor never logged its resync:\n"
                             f"{err[-4000:]}")
    replayed = re.findall(r"journal: replayed (\d+) row\(s\) from cursor \d+ after elastic", err)
    return (int(m.group(1)), int(m.group(2)), m.group(3), int(m.group(4) or 0),
            sum(int(r) for r in replayed))


def el_clean_run(state, rows):
    """The survivor's continuation in this process, on the card: the world-1
    split (``MultiHostSGDModel`` over a ``ParallelSGDModel`` on a group of
    one) and B1's fused learner, each from ``state`` over ``rows`` in
    MH_ROWS-row batches. Returns (split weights, B1 weights)."""
    from twtml_tpu_torch.config import ConfArguments
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD
    from twtml_tpu_torch.parallel.distributed import Collectives, MultiHostSGDModel
    from twtml_tpu_torch.parallel.mesh import make_mesh
    from twtml_tpu_torch.parallel.sharding import ParallelSGDModel

    conf = ConfArguments().parse(["--backend", MH_ARGV[1]])
    mesh = make_mesh(num_processes=1)
    split = MultiHostSGDModel(ParallelSGDModel.from_conf(conf, mesh, Collectives()), mesh)
    plain = StreamingLinearRegressionWithSGD.from_conf(conf)
    split.set_initial_weights(state)
    plain.set_initial_weights(state)
    feat = Featurizer(now_ms=NOW_MS)
    for lo in range(0, len(rows), MH_ROWS):
        batch = feat.featurize_batch_ragged(rows[lo:lo + MH_ROWS], row_bucket=MH_ROWS,
                                            unit_bucket=64)
        split.step(split.pack_for_wire(batch))
        plain.step(batch)
    return split.latest_weights, plain.latest_weights


def el_hold_continuation(name, final_dir, archive_dir, step, rows):
    """The survivor's final archive against its clean continuation on the
    card from the archive it restored (step ``step``): bitwise the world-1
    split's and B1's."""
    import numpy as np

    from twtml_tpu_torch.checkpoint import Checkpointer

    state, _meta = Checkpointer(archive_dir).restore(step=step)
    final, meta = Checkpointer(final_dir).restore()
    split_w, b1_w = el_clean_run(state, rows)
    if not (np.array_equal(np.asarray(final), split_w) and np.array_equal(split_w, b1_w)):
        raise AssertionError(
            f"elastic {name}: the survivor's weights differ from the clean run from step "
            f"{step} by {float(np.max(np.abs(np.asarray(final) - split_w))):.3g} (split), the "
            f"split from B1's by {float(np.max(np.abs(split_w - b1_w))):.3g}")
    return state, int(meta["count"])


def el_reap_store_hosts(tag, deadline_s=30.0):
    """Wait for the store processes this phase's ranks spawned
    (parallel/service_host.py, detached, ``tag`` in their environment) to
    reap themselves once their beacon is gone; stop any still there at the
    deadline. A process whose environment cannot be read is not this
    phase's. Returns how many were stopped."""
    import signal

    mark = f"{EL_TAG_ENV}={tag}".encode()

    def hosts():
        pids = []
        for d in os.listdir("/proc"):
            if d.isdigit():
                try:
                    with open(f"/proc/{d}/cmdline", "rb") as fh:
                        if b"twtml_tpu_torch.parallel.service_host" not in fh.read():
                            continue
                    with open(f"/proc/{d}/environ", "rb") as fh:
                        if mark in fh.read().split(b"\0"):
                            pids.append(int(d))
                except OSError:
                    pass
        return pids

    t0 = time.monotonic()
    while hosts() and time.monotonic() - t0 < deadline_s:
        time.sleep(0.5)
    left = hosts()
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return len(left)


def elastic_phase(smi, statuses, lockstep):
    """The elastic phase (``--elastic on``): 2 ranks of the linear app on the
    one card over gloo, full width, 8192 rows a rank, on the multihost
    phase's replay file. A healthy run counted against the lockstep main
    arm (``lockstep``: its ranks' records and numbers) and timed between it
    and a lockstep run of the same flags after it; ``peer.kill`` on uid
    1 at tick 3: the survivor shrinks and its continuation is bitwise the
    world-1 split's and B1's from the restored archive on the card;
    ``peer.kill`` on uid 0: the election, held the same way from uid 1's
    standby archive; a restarted uid 1: admitted, its first tick's state
    CRC the lead's. Returns the phase's numbers."""
    import re
    import shutil
    import tempfile

    from twtml_tpu_torch.streaming.sources import ReplayFileSource

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="twtml-elastic-")
    out = {}
    try:
        path = os.path.join(workdir, "tweets.jsonl")
        write_replay(path, statuses[:MH_BATCHES * OP_ROWS])
        rows = list(ReplayFileSource(path).produce())
        off = [*MH_ARGV, "--replayFile", path, "--batchBucket", str(MH_ROWS)]
        argv = [*off, "--elastic", "on"]
        steps = MH_BATCHES + 1  # and the warm-up's
        # healthy: the lockstep main arm's collectives, fetches and launches;
        # its tick timed between that arm (run before) and a lockstep run
        # with this arm's flags but --elastic off (run after)
        d_h = os.path.join(workdir, "healthy")
        res = el_group(workdir, "healthy", [*argv, "--checkpointDir", d_h])
        el_survived("healthy", res)
        d_after = os.path.join(workdir, "lockstep-after")
        after = mh_ok("elastic lockstep-after", mh_group(
            "elastic lockstep-after", [*off, "--checkpointDir", d_after], env=EL_ENV))
        healthy = []
        for rank, (_rc, lines, rec, _err, wall) in enumerate(res):
            c = rec["collectives"]
            for ref in (lockstep["recs"][rank], after[rank][2]):
                if (c["cadence_allgathers"] != rec["counters"]["lockstep.ticks"]
                        or {k: c[k] for k in ref["collectives"]} != ref["collectives"]
                        or rec["counters"]["fetch.count"] != ref["counters"]["fetch.count"]
                        or rec["count"] != ref["count"]
                        or {k: rec["launches"][k] for k in SPLIT_ENTRIES}
                        != {k: ref["launches"][k] for k in SPLIT_ENTRIES}):
                    raise AssertionError(f"elastic healthy rank {rank}: {rec} against the "
                                         f"lockstep run's {ref}")
            ticks = c["cadence_allgathers"]
            row = {"rank": rank, "ticks": ticks, "collectives": c,
                   "fetches": rec["counters"]["fetch.count"],
                   "host_wall_a_tick_ms": 1e3 * rec["stream_seconds"] / ticks,
                   "tweets_per_s": rec["count"] / rec["stream_seconds"],
                   "tick_ms": el_tick_split(rec),
                   "lockstep_host_wall_a_tick_ms":
                       lockstep["numbers"][rank]["host_wall_a_tick_ms"],
                   "lockstep_tweets_per_s": lockstep["numbers"][rank]["tweets_per_s"],
                   "lockstep_tick_ms": el_tick_split(lockstep["recs"][rank]),
                   "lockstep_after_tick_ms": el_tick_split(after[rank][2]),
                   "lockstep_after_tweets_per_s":
                       after[rank][2]["count"] / after[rank][2]["stream_seconds"],
                   "group_wall_s": wall}
            healthy.append(row)
            phase("elastic", f"healthy rank {rank}: {ticks} ticks, {ticks} cadence all-gathers, "
                  f"collectives and {row['fetches']} fetches as --elastic off; a tick "
                  f"{el_tick_text(row['tick_ms'])} against lockstep before "
                  f"{el_tick_text(row['lockstep_tick_ms'])} and after "
                  f"{el_tick_text(row['lockstep_after_tick_ms'])}; {row['tweets_per_s']:.0f} "
                  f"tweets/s against {row['lockstep_tweets_per_s']:.0f} before and "
                  f"{row['lockstep_after_tweets_per_s']:.0f} after")
        out["healthy"] = healthy
        launches = {e: sum(r[2]["launches"][e] for r in res) for e in SPLIT_ENTRIES}
        # a follower killed at a tick boundary: the survivor shrinks
        every = ["--checkpointEvery", "1"]
        kill1 = f"peer.kill:uid=1:tick={EL_KILL_TICK}"
        d_k = os.path.join(workdir, "kill1")
        res = el_group(workdir, "kill1", [*argv, *every, "--checkpointDir", d_k],
                       extra=((), ("--chaos", kill1)))
        el_survived("kill1", res, (0, 77))
        err0, err1 = res[0][3], res[1][3]
        if "elastic epoch 1 formed: 1 host(s) [0]" not in err0:
            raise AssertionError(f"elastic kill1: no shrink:\n{err0[-4000:]}")
        count, batches, crc, rolled, replayed = el_resync("kill1", err0)
        done = batches * MH_ROWS  # the survivor's rows inside the restored archive
        _state, final_count = el_hold_continuation("kill1", d_k, d_k, batches,
                                                   rows[0::2][done:])
        t_kill = el_log_time(err1, "peer.kill firing")
        t_seen = el_log_time(err0, "lockstep collective failed")
        t_formed = el_log_time(err0, "elastic epoch 1 formed")
        rec = res[0][2]
        out["kill1"] = {
            "resync": {"count": count, "batches": batches, "crc": crc},
            "rows_rolled_back": rolled, "rows_replayed": replayed,
            "final_count": final_count, "detect_s": t_seen - t_kill,
            "rescue_s": t_formed - t_kill,
            "launches_survivor": {e: rec["launches"][e] for e in SPLIT_ENTRIES},
            "allreduces_survivor": rec["collectives"]["allreduces"], "wall_s": res[0][4]}
        phase("elastic", f"peer.kill uid 1 at tick {EL_KILL_TICK}: the survivor formed epoch 1 "
              f"alone {t_formed - t_kill:.3f} s after the kill (the failed all-gather seen "
              f"after {t_seen - t_kill:.3f} s), resynced to step {batches} (count {count}, crc "
              f"{crc}), {rolled} rows rolled back, {replayed} replayed; final count "
              f"{final_count}, weights bitwise the clean world-1 split's and B1's on the card; "
              f"survivor's split launches {out['kill1']['launches_survivor']}")
        # the lead killed: uid 1 wins the election and promotes its standby
        d_l = os.path.join(workdir, "kill0")
        res = el_group(workdir, "kill0", [*argv, *every, "--checkpointDir", d_l, "--chaos",
                                 f"peer.kill:uid=0:tick={EL_KILL_TICK}"])
        el_survived("kill0", res, (77, 0))
        err0, err1 = res[0][3], res[1][3]
        for text in ("uid 1 WON the election", "checkpoint authority PROMOTED",
                     "elastic epoch 1 formed: 1 host(s) [1]"):
            if text not in err1:
                raise AssertionError(f"elastic kill0: no {text!r}:\n{err1[-4000:]}")
        count, batches, crc, rolled, replayed = el_resync("kill0", err1)
        done = batches * MH_ROWS
        standby = os.path.join(d_l, "standby-u1")
        _state, final_count = el_hold_continuation("kill0", standby, standby, batches,
                                                   rows[1::2][done:])
        t_kill = el_log_time(err0, "peer.kill firing")
        t_formed = el_log_time(err1, "elastic epoch 1 formed")
        out["kill0"] = {"resync": {"count": count, "batches": batches, "crc": crc},
                        "rows_rolled_back": rolled, "rows_replayed": replayed,
                        "final_count": final_count, "rescue_s": t_formed - t_kill,
                        "wall_s": res[1][4]}
        phase("elastic", f"peer.kill uid 0 at tick {EL_KILL_TICK}: uid 1 won the election, "
              f"formed epoch 1 {t_formed - t_kill:.3f} s after the kill from its own step "
              f"{batches} (crc {crc}); final count {final_count}, weights bitwise the clean "
              "world-1 split's and B1's on the card")
        # a restarted uid 1: parks, admitted at an epoch boundary
        d_r = os.path.join(workdir, "rejoin")
        t0 = time.perf_counter()
        base = el_base_port()
        argv_r = [*argv, *every, "--checkpointDir", d_r]
        lead = el_spawn(workdir, 0, argv_r, base, ("--chaos", EL_PAUSE), EL_REJOIN_ENV)
        peer = el_spawn(workdir, 1, argv_r, base, ("--chaos", f"{EL_PAUSE},{kill1}"),
                        EL_REJOIN_ENV)
        rejoiner = None
        try:
            peer_rc = peer.wait(timeout=EL_TIMEOUT_S)
            rejoiner = el_spawn(workdir, 1, argv_r, base, ("--chaos", EL_PAUSE), EL_REJOIN_ENV)
            res = el_collect([lead, rejoiner], t0, "rejoin")
        finally:
            for p in (lead, peer, rejoiner):
                if p is not None:
                    p.kill()
                    p.wait()
        if peer_rc != 77:
            raise AssertionError(f"elastic rejoin: the killed rank exited {peer_rc}")
        for rank, r in enumerate(res):
            if r[0] != 0:
                raise AssertionError(f"elastic rejoin: rank {rank} exited {r[0]}:\n"
                                     f"{res[0][3][-3000:]}\n-- the rejoiner:\n{res[1][3][-3000:]}")
        el_survived("rejoin", res)
        err0, errr = res[0][3], res[1][3]
        for text, err in (("elastic epoch 2 formed: 2 host(s) [0, 1]", err0),
                          ("parking this host (uid 1) for admission", errr)):
            if text not in err:
                raise AssertionError(f"elastic rejoin: no {text!r}:\n{err[-4000:]}")
        lead_crc = re.findall(r"elastic resync: .* state crc ([0-9a-f]+)", err0)
        join_crc = re.findall(r"multi-host state synchronized from the lead \(count=(\d+), "
                              r"state crc ([0-9a-f]+)\)", errr)
        if not (lead_crc and join_crc and join_crc[-1][1] == lead_crc[-1]):
            raise AssertionError(f"elastic rejoin: the rejoiner's first-tick crc {join_crc} "
                                 f"against the lead's {lead_crc}")
        t_formed = el_log_time(err0, "elastic epoch 2 formed")
        t_parked = el_log_time(errr, "parking this host")
        out["rejoin"] = {"crc": lead_crc[-1], "count_at_admission": int(join_crc[-1][0]),
                         "parked_to_admitted_s": t_formed - t_parked,
                         "lead_final_count": res[0][2]["count"], "wall_s": res[0][4]}
        phase("elastic", f"restarted uid 1: parked, admitted at epoch 2 "
              f"{t_formed - t_parked:.3f} s later; its first tick's state crc {lead_crc[-1]} "
              f"the lead's (count {join_crc[-1][0]})")
        stopped = el_reap_store_hosts(workdir)
        out.update(launches=launches, store_hosts_stopped=stopped,
                   wall_s=time.perf_counter() - t_phase, card=smi)
        phase("elastic", f"split launches on the healthy run (both ranks) {launches}; store "
              f"processes stopped at the end {stopped}; phase wall {out['wall_s']:.1f} s | "
              f"card: {smi}")
        return out
    finally:
        el_reap_store_hosts(workdir)
        shutil.rmtree(workdir, ignore_errors=True)


# ---- the modelaxis phase: the layouts over a model axis, ranks on cuda:0 ----

MA_BATCHES = 3  # global batches of each 2^18 arm
MA_SHORT_SPAN = (16, 120)  # short tweets' code units (mass <= 127: the int8 plane)
MA_UNITS = 128
MA_LONG_SPAN = (140, 280)  # tweet-length rows (f32 counts on one process)
MA_LONG_UNITS = 512
MA_CJK = (0x4E00, 0xA000)  # CJK ideographs: their bigrams reach both halves of 2^18
MA_WIDE_ROW = 200  # the tweet-length arm's row of second-half bigrams only
# each arm's planes at the two [B, 2^17] slices: the short tweets int8 in
# both; the tweet-length rows exact in the first (an ASCII row of 280
# units) and bf16 in the second (a row of MA_WIDE_ROW units hashed there)
MA_SLICE_PLANES = {"short": ["int8", "int8"], "long": ["exact", "bf16"]}
MA_SMALL_F = 1000  # the small arm: B4 at a 500-column slice on 2 x 2
MA_SCATTER_ROWS, MA_SCATTER_BATCHES, MA_SCATTER_ITERS = 256, 2, 10
MA_TENANTS = 4
MA_TIMEOUT_S = 600
MA_PRED_ATOL = 1e-4  # the JAX package's mesh tests' prediction tolerance
MA_KMEANS_ROWS = 16384  # a k-means library batch (global)
MA_WORKER = os.path.join("tests", "torch_mesh_worker.py")
MA_DEVICE = "cuda"  # a CPU rehearsal sets "cpu" (and MH_ARGV[1])

# one rank of the k-means app (``main`` on the parsed flags), recording its
# rows' assignments; its record as the last line
MA_KMEANS_RANK = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from twtml_tpu_torch.apps import kmeans
from twtml_tpu_torch.config import ConfArguments
from twtml_tpu_torch.models.kmeans import StreamingKMeans
from twtml_tpu_torch.parallel import distributed
assign, model = [], []
base = StreamingKMeans.update_device
def update_device(self, points, mask=None):
    out = base(self, points, mask)
    assign.append(out.cpu().numpy().tolist())
    model[:] = [self]
    return out
StreamingKMeans.update_device = update_device
t0 = time.perf_counter()
totals = kmeans.run(ConfArguments().parse(sys.argv[2:]))
print(json.dumps({"count": totals["count"], "batches": totals["batches"],
                  "wall_s": time.perf_counter() - t0, "assign": assign,
                  "centers": model[0].latest_centers.tolist(),
                  "weights": model[0].latest_weights.tolist(),
                  "collectives": distributed.COUNTERS, "seconds": distributed.SECONDS}),
      flush=True)
"""


def ma_statuses(span, rows, batches, seed, heads=False):
    """``batches`` x ``rows`` retweets of ASCII and CJK words (about half
    each), each row's length uniform in ``span`` code units and each
    batch's first row at the longest; the retweet count linear in
    followers and text length, as SyntheticSource makes it. An ASCII
    bigram hashes below 4,064 (``31·c₁ + c₂``), so at 2^18 only the wider
    code units reach the second half of the features, the second model
    slice of a 2-way axis. With ``heads`` each batch's row 0 is ASCII only
    (every bigram in the first half) and row 1 MA_WIDE_ROW units of
    ideographs whose every bigram lands in the second half, which set the
    slices' planes (MA_SLICE_PLANES)."""
    import numpy as np

    from twtml_tpu_torch.features.featurizer import Status

    rng = np.random.default_rng(seed)
    ascii_ = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
    cjk = np.arange(*MA_CJK)
    # (31·c mod 2^18) + any unit below MA_CJK[1] stays in [2^17, 2^18)
    wide = cjk[((31 * cjk) % 2**18 >= 2**17) & ((31 * cjk) % 2**18 < 2**18 - MA_CJK[1])]

    def word():
        n = int(rng.integers(2, 6))
        if rng.random() < 0.5:
            return "".join(rng.choice(ascii_, n))
        return "".join(chr(int(c)) for c in rng.choice(cjk, n))

    def text(n, k):
        if heads and k == 0:
            return "".join(rng.choice(ascii_, n))
        if heads and k == 1:
            return "".join(chr(int(c)) for c in rng.choice(wide, MA_WIDE_ROW))
        t = ""
        while len(t) < n:
            t += word() + " "
        return t[:n]

    out = []
    for _ in range(batches):
        lengths = rng.integers(span[0], span[1] + 1, rows)
        lengths[0] = span[1]
        for k, n in enumerate(lengths.tolist()):
            t = text(n, k)
            fo = int(rng.integers(100, 2_000_000))
            label = int(np.clip(100 + fo * 4e-4 + len(t) * 2 + rng.normal(0, 20), 100, 1000))
            original = Status(text=t, retweet_count=label, followers_count=fo,
                              favourites_count=fo % 50_000, friends_count=fo % 10_000,
                              created_at_ms=NOW_MS - int(rng.integers(0, 86_400_000)))
            out.append(Status(text="RT " + t, retweeted_status=original))
    return out


def ma_group(name, workdir, nprocs, spec):
    """``tests/torch_mesh_worker.py`` in ``nprocs`` ranks of one group on
    the card (every rank on cuda:0, so gloo) with ``spec``: (each rank's
    record, each run's arrays by rank: ``arrays[run][rank]``), the group's
    wall s. Every rank is stopped before this returns."""
    import numpy as np

    spec = dict(spec, device=MA_DEVICE, out=workdir)
    path = os.path.join(workdir, f"{name}-spec.json")
    with open(path, "w") as fh:
        json.dump(spec, fh)
    env = dict(os.environ)
    env.pop("TWTML_SYNC_DEBUG", None)  # a gloo collective waits for the card
    port, t0 = free_port(), time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.join(PACKAGE_ROOT, MA_WORKER),
                               str(r), str(nprocs), str(port), path], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(nprocs)]
    recs = []
    try:
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=MA_TIMEOUT_S)
            lines = stdout.splitlines()
            if p.returncode != 0 or not lines or not lines[-1].startswith("{"):
                raise AssertionError(f"modelaxis {name}: rank {r} exited {p.returncode}:\n"
                                     f"{stderr[-4000:]}")
            recs.append(json.loads(lines[-1]))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    arrays = {}
    for run in spec["runs"]:
        arrays[run["name"]] = []
        for r in range(nprocs):
            with np.load(os.path.join(workdir, f"{run['name']}-rank{r}.npz")) as data:
                arrays[run["name"]].append({k: data[k] for k in data.files})
    return recs, arrays, wall


def ma_unit_batches(path, statuses, rows, features, units):
    """Each ``rows`` of ``statuses`` as a padded units batch (device
    hashing, uint16 units of ``units`` a row), saved stacked to ``path``;
    returns the batches."""
    import numpy as np

    from twtml_tpu_torch.features.batch import UnitBatch
    from twtml_tpu_torch.features.featurizer import Featurizer

    feat = Featurizer(num_text_features=features, now_ms=NOW_MS)
    out = []
    for lo in range(0, len(statuses), rows):
        b = feat.featurize_batch_units(statuses[lo:lo + rows], row_bucket=rows,
                                       unit_bucket=units)
        out.append(b._replace(units=np.asarray(b.units, np.uint16)))
    np.savez(path, **{f: np.stack([getattr(b, f) for b in out]) for f in UnitBatch._fields})
    return out


def ma_single(batches, **kw):
    """The port's one-process learner on the card over ``batches``: the
    weights after each step and each step's predictions (host)."""
    from twtml_tpu_torch.models.linear import StreamingLinearRegressionWithSGD

    model = StreamingLinearRegressionWithSGD(device=MA_DEVICE, **kw)
    ws, preds = [], []
    for b in batches:
        out = model.step(b)
        preds.append(out.predictions.cpu().numpy())
        ws.append(model.latest_weights)
    return ws, preds


def ma_hold_run(name, layout, recs, arrays, want, rtol=1e-4, atol=1e-7, bitwise=False):
    """A group's run against the one-process run (``want``: weights and
    predictions a step): every rank's gathered weights equal, within
    ``rtol``/``atol`` of one process's (bitwise with ``bitwise``); each
    rank's rows' predictions within MA_PRED_ATOL, HALF_UP flips (a
    difference of 1) counted. Returns (weights max error, flips)."""
    import numpy as np

    ws, preds = want
    err, flips = 0.0, 0
    for rank, arr in enumerate(arrays):
        if not np.array_equal(arr["w"], arrays[0]["w"]):
            raise AssertionError(f"modelaxis {name} {layout}: rank {rank}'s weights differ "
                                 "from rank 0's")
        d, nd = recs[rank]["data_index"], len({r["data_index"] for r in recs})
        for k, (w, p) in enumerate(zip(ws, preds)):
            got = arr["w"][k]
            e = float(np.max(np.abs(got - w)))
            ok = np.array_equal(got, w) if bitwise else np.allclose(got, w, rtol=rtol,
                                                                    atol=atol)
            if not ok:
                raise AssertionError(f"modelaxis {name} {layout} step {k}: weights differ from "
                                     f"one process's by {e:.3g}")
            err = max(err, e)
            rows = p.shape[0] // nd
            diff = np.abs(arr["preds"][k] - p[d * rows:(d + 1) * rows])
            flip = np.isclose(diff, 1.0)
            if np.any(diff[~flip] > MA_PRED_ATOL):
                raise AssertionError(f"modelaxis {name} {layout} step {k}: predictions "
                                     f"differ by {float(diff[~flip].max()):.3g}")
            flips += int(flip.sum())
    return err, flips


def ma_slice(idx, val, f_local, m):
    """Model shard ``m``'s tokens of a batch: relative, clipped indices and
    the values zeroed outside its slice (as ``gram_sgd_parallel`` keeps
    them)."""
    import torch

    rel = idx - m * f_local
    keep = (rel >= 0) & (rel < f_local)
    return torch.clamp(rel, 0, f_local - 1), val * keep.to(val.dtype)


def ma_kernel_holds(name, batch, features, num_model=2, num_data=2):
    """The 2D route's kernels at the slice's shapes on one batch, against
    their twins: B4 at each [B, F/num_model] slice bitwise in every plane
    (its counts are integer sums), the G a (num_data x num_model) group
    sums from its ranks' panels (bitwise the one-process G), B7 on it and
    B8 at each rank's [B/num_data, F/num_model] slice. Every slice must
    hold tokens. Returns each kernel's max error and the slices' planes."""
    import torch

    from twtml_tpu_torch.models.sgd import batch_to_device, decode_batch, host_planes
    from twtml_tpu_torch.ops import fused_gram, gram

    dev = torch.device(MA_DEVICE)
    idx, val, num, lab, mask = decode_batch(batch_to_device(batch, dev), features,
                                            torch.float32)
    b, f_local = mask.shape[0], features // num_model
    full = host_planes(batch)[0]
    c_full = fused_gram.count_build(idx, val, features, int8=full == gram.PLANE_INT8)
    g_full = fused_gram.gram_from_counts(c_full)[:b, :b]
    del c_full
    g_sum, g_sum1 = torch.zeros_like(g_full), torch.zeros_like(g_full)
    planes, counts, errs, rows = [], [], {"count_build": 0.0}, b // num_data
    for m in range(num_model):
        rel, val_m = ma_slice(idx, val, f_local, m)
        tokens = int(torch.count_nonzero(val_m))
        if tokens == 0:
            raise AssertionError(f"modelaxis {name}: slice {m} holds no token")
        plane = gram.data_plane(val_m)
        planes.append(gram.PLANE_NAMES[plane])
        c = fused_gram.count_build(rel, val_m, f_local, int8=plane == gram.PLANE_INT8)
        ref = fused_gram.count_build_reference(rel, val_m, f_local,
                                               int8=plane == gram.PLANE_INT8,
                                               rows_out=c.shape[0], cols_out=c.shape[1])
        if not torch.equal(c, ref):
            raise AssertionError(f"modelaxis {name}: B4 at slice {m} [{b}, {f_local}] in the "
                                 f"{planes[-1]} plane differs from its twin by "
                                 f"{float((c.float() - ref.float()).abs().max()):.3g}")
        del ref
        panels = [fused_gram.gram_from_counts(c, rows=(d * rows, rows))[:, :b]
                  for d in range(num_data)]
        g_sum += torch.cat(panels)  # the num_data x num_model ranks' panels
        g_sum1 += fused_gram.gram_from_counts(c)[:b, :b]  # a 1 x num_model rank's
        counts.append((rel, val_m))
    for layout, got in ((f"{num_data} x {num_model}", g_sum), (f"1 x {num_model}", g_sum1)):
        if not torch.equal(got, g_full):
            raise AssertionError(f"modelaxis {name}: G summed over the model axis of "
                                 f"{layout} differs from one process's by "
                                 f"{float((got - g_full).abs().max()):.3g}")
    g = gram.add_numeric_block(g_sum, num)
    raw = torch.zeros_like(lab)
    kw = dict(num_iterations=OP_ITERS, step_size=0.005, l2_reg=0.1, convergence_tol=0.001,
              p_prev=torch.tensor(0.0, device=dev))
    c_, a, _its = fused_gram.dual_sgd(g, raw, lab, mask, **kw)
    c_r, a_r, _ = fused_gram.dual_sgd_reference(g, raw, lab, mask, **kw)
    errs["dual_sgd"] = compare(f"modelaxis {name} B7 alpha", a, a_r)[0]
    compare(f"modelaxis {name} B7 c", c_.reshape(1), c_r.reshape(1))
    zeros = torch.zeros((f_local + 4,), dtype=torch.float32, device=dev)
    alpha0 = a[:rows].contiguous()
    errs["dual_writeback_counts"] = 0.0
    for m, (rel, val_m) in enumerate(counts):  # each slice's tokens: rank 0's rows
        w = fused_gram.dual_writeback_counts(zeros, c_, alpha0, rel[:rows], val_m[:rows],
                                             num[:rows], f_local)
        w_r = fused_gram.dual_writeback_reference(zeros, c_, alpha0, rel[:rows], val_m[:rows],
                                                  num[:rows], f_local)
        e = float((w - w_r).abs().max())
        if e > WEIGHT_RTOL * float(w_r.abs().max()):
            raise AssertionError(f"modelaxis {name}: B8 at slice {m} [{rows}, {f_local}] "
                                 f"differs from its twin by {e:.3g}")
        errs["dual_writeback_counts"] = max(errs["dual_writeback_counts"], e)
    return errs, planes


def ma_rank_numbers(name, layout, recs, run):
    """Per rank: a 2D step's device ms (CUDA events) and host wall, and the
    ms of each axis's collectives in a step, each the median over the steps
    after the first (which pays the first use of every kernel and group);
    the run's collectives a step (the weights' gathers for the holds
    included)."""
    import statistics as st

    out = []
    for rec in recs:
        r = rec["runs"][run]
        steps = max(1, len(r["step_wall_ms"]))
        c = r["collectives"]
        later = r["step_collective_ms"][1:] or r["step_collective_ms"]
        row = {"rank": rec["rank"],
               "step_device_ms": st.median(r["step_device_ms"][1:] or [float("nan")]),
               "step_wall_ms": st.median(r["step_wall_ms"][1:] or r["step_wall_ms"]),
               "collectives_a_step": {k: c[k] / steps for k in c if c[k]},
               "collective_ms_a_step": {k: st.median(m.get(k, 0.0) for m in later)
                                        for k in sorted({k for m in later for k in m})}}
        out.append(row)
        phase("modelaxis", f"{name} {layout} rank {rec['rank']}: step {row['step_device_ms']:.2f} "
              f"ms (CUDA events), host wall {row['step_wall_ms']:.2f} ms; a step's "
              f"collectives {row['collectives_a_step']}, their ms "
              f"{ {k: round(v, 3) for k, v in row['collective_ms_a_step'].items()} }")
    return out


def ma_tenant_clean_run(state, rows):
    """The fleet survivor's continuation on the card: the world-1 fleet
    (split) and the plain stack (B1), each from ``state`` over ``rows`` in
    MH_ROWS-row batches. Returns (fleet weights, stack weights)."""
    from twtml_tpu_torch.features.featurizer import Featurizer
    from twtml_tpu_torch.parallel.distributed import Collectives
    from twtml_tpu_torch.parallel.mesh import make_mesh
    from twtml_tpu_torch.parallel.tenants import MultiHostTenantModel, TenantStackModel

    mesh = make_mesh(num_processes=1)
    kw = dict(step_size=0.005, quality=True, device=MA_DEVICE)
    fleet = MultiHostTenantModel(TenantStackModel(MA_TENANTS, mesh=mesh, group=Collectives(),
                                                  **kw), mesh)
    plain = TenantStackModel(MA_TENANTS, **kw)
    fleet.set_initial_weights(state)
    plain.set_initial_weights(state)
    feat = Featurizer(now_ms=NOW_MS)
    for lo in range(0, len(rows), MH_ROWS):
        batch = feat.featurize_batch_ragged(rows[lo:lo + MH_ROWS], row_bucket=MH_ROWS,
                                            unit_bucket=64)
        fleet.step(fleet.pack_for_wire(batch))
        plain.step(batch)
    return fleet.latest_weights, plain.latest_weights


# ---- phase 26, its vmap arm: the tenant plane's vmap form over a data axis (B10 b)

TS_M = 4  # the arm's tenants
TS_F = 1000  # text columns: 1004 with the numeric ones
TS_TICKS = 4  # timed ticks a run, after one warm-up tick
TS_ENTRY = "fused_dense_sgd_tenants_split"
TS_TIME_VALID = 2048  # a tenant's valid rows in the timed launch: TS_M x 2048 = MH_ROWS
TS_PROBE_LAUNCHES = 20  # probe launches a split (each stamps one iteration)


def ts_check_valid(m, rows):
    """Each rank's valid rows of the kernel checks' M parts of ``rows`` rows:
    every row on rank 0, a varying share on rank 1; tenant 1 has rows on
    rank 0 only, tenant 2 (M > 2) on neither (its global count 0)."""
    r0 = [rows] * m
    r1 = [rows // 2 + (t * 37) % (rows // 2) for t in range(m)]
    r1[1] = 0
    if m > 2:
        r0[2] = r1[2] = 0
    return [r0, r1]


# the kernel checks on 2 ranks: (tenants, a part's rows, each rank's valid
# rows). M = 2 ... 32 split a rank's MH_ROWS rows into M parts, at each
# count where the kernel's layouts change: up to 12 tenants the reduce
# shares its 12 warps (6, 2 and 1 a tenant at M = 2, 5 and 8 or 12; at
# M = 5 two warps idle), above 12 it takes a thread a (tenant, column)
# pair; the update's lanes a tenant change with M, and above 6 tenants the
# decisions take the table of lane sums. The skew gives the four tenants
# 1 : 3 : 0 : 12 of the rows on rank 0 and 12 : 0 : 0 : 4 on rank 1
TS_CHECKS = {
    "m4": (4, MH_ROWS, [[2048, 2048, 0, 3072], [2048, 0, 0, 1024]]),
    **{f"m{m}": (m, MH_ROWS // m, ts_check_valid(m, MH_ROWS // m)) for m in (2, 5, 8, 12)},
    "m16": (16, MH_ROWS // 16, ts_check_valid(16, MH_ROWS // 16)),
    "m32": (32, MH_ROWS // 32, ts_check_valid(32, MH_ROWS // 32)),
    "skew": (4, MH_ROWS, [[v * MH_ROWS // 16 for v in (1, 3, 0, 12)],
                          [v * MH_ROWS // 16 for v in (12, 0, 0, 4)]]),
}


def tsplit_probe(parts, w0s, runs=TS_PROBE_LAUNCHES):
    """The split with a tenant grid's phase split on ``parts`` (x, y, mask
    [M, B, ·]): ``runs`` launches of its timing instantiation at it = 2
    (``fused_sgd.tenant_split_probe``), each phase's mean in µs
    (``tenant_split_probe_split``) and their sum."""
    from twtml_tpu_torch.features.batch import tenant_valid_rows
    from twtml_tpu_torch.ops import fused_sgd

    m = parts[0].shape[0]
    valid = tenant_valid_rows(parts[2].cpu().numpy())
    stamps = fused_sgd.tenant_split_probe(*parts, w0s, valid_rows=valid, step_sizes=[1e-12] * m,
                                          l2_regs=[0.0] * m, launches=runs)[2]
    phases, launches, span, by_slot = fused_sgd.tenant_split_probe_split(stamps)
    return {"iteration_us": phases, "us_an_iteration": sum(phases.values()),
            "launches_stamped": launches, "span_us": span, "valid_rows": list(valid),
            "cta0_us": by_slot.get(0, {}),
            "last_ctas_us": {k: statistics.mean(v[k] for slot, v in by_slot.items() if slot)
                             for k in phases} if len(by_slot) > 1 else {}}


def tsplit_probe_text(split):
    slots = "; ".join(f"{who} " + ", ".join(f"{k} {v:.3f}" for k, v in split[key].items())
                      for who, key in (("CTA 0", "cta0_us"), ("the tenants' last CTAs",
                                                              "last_ctas_us")) if split.get(key))
    return (f"an iteration {split['us_an_iteration']:.2f} µs: "
            + ", ".join(f"{k} {v:.3f}" for k, v in split["iteration_us"].items())
            + f" ({split['launches_stamped']} launches stamped, span {split['span_us']:.2f} µs"
            + (f"; {slots})" if slots else ")"))


def tenant_split_timing():
    """The split with a tenant grid's launches on a rank's MH_ROWS x 1004
    rows (``split_inputs``) cut into TS_M parts of TS_TIME_VALID valid rows,
    each padded to MH_ROWS as the tenant wire carries it, the all-reduce an
    identity, on the port this process imports: the iteration launch (it =
    2: the update of 1 folded in) and the update-only launch, at TS_M
    tenants and with the same rows as one tenant, each against the split's
    on the same rows as one model, in turns (split, tenants, tenants, split;
    each the median of 5 runs of 50 queued launches) with the host's µs to
    enqueue one; where the port has the timing instantiation, its phase
    split at TS_M tenants and at one tenant. Returns (the numbers, the
    inputs and the step for the caller's twin and bound)."""
    import torch

    from twtml_tpu_torch.features.batch import tenant_valid_rows
    from twtml_tpu_torch.ops import fused_sgd

    x, y, m, w0 = split_inputs()
    rows, f = x.shape
    xs, ys, ms = tenant_grid_parts(x, y, m, [TS_TIME_VALID] * TS_M)
    w0s = w0.expand(TS_M, f).contiguous()
    kw = dict(step_size=1e-12, l2_reg=0.0, convergence_tol=0.0)  # tol 0: never converged
    step = fused_sgd.TenantSplitStep(xs, ys, ms, w0s, valid_rows=[TS_TIME_VALID] * TS_M,
                                     step_sizes=[1e-12] * TS_M, l2_regs=[0.0] * TS_M,
                                     convergence_tol=0.0, mode=0)
    step.launch(1)
    sms, shared = fused_sgd.device_limits(torch.cuda.current_device())
    plan = fused_sgd.split_plan(rows, f, sm_count=sms, shared_limit=shared)
    bufs = fused_sgd.split_buffers(plan, x.device)
    w, preds = torch.empty_like(w0), torch.empty_like(y)
    fused_sgd.fused_dense_grad(plan, bufs, x, y, m, w0, w, preds, it=1, **kw)
    # the same rows as ONE tenant: the split's work through this kernel
    one = (x[None].contiguous(), y[None].contiguous(), m[None].contiguous())
    one_valid = tenant_valid_rows(one[2].cpu().numpy())
    step1 = fused_sgd.TenantSplitStep(*one, w0[None].contiguous(), valid_rows=one_valid,
                                      step_sizes=[1e-12], l2_regs=[0.0], convergence_tol=0.0,
                                      mode=0)
    step1.launch(1)
    arms = {"split": lambda: fused_sgd.fused_dense_grad(plan, bufs, x, y, m, w0, w, preds,
                                                        it=2, **kw),
            "tenants": lambda: step.launch(2),
            "one_tenant": lambda: step1.launch(2),
            "split_update": lambda: fused_sgd.fused_dense_update(plan, bufs, w, f, it=2, **kw),
            "tenants_update": lambda: step.launch(2, row_pass=False),
            "one_tenant_update": lambda: step1.launch(2, row_pass=False)}
    times, host = ({name: [] for name in arms} for _ in range(2))
    for pair in (("split", "tenants"), ("split", "one_tenant"),
                 ("split_update", "tenants_update"), ("split_update", "one_tenant_update")):
        for name in (*pair, *pair[::-1]):
            ms_, _runs, host_us = split_queued(arms[name], 5, 50)
            times[name].append(ms_)
            host[name].append(host_us)
    split_ = fused_sgd.tenant_split_plan([TS_TIME_VALID] * TS_M, rows, f, sm_count=sms,
                                         shared_limit=shared)
    out = {"ms": {k: statistics.median(v) for k, v in times.items()}, "turns_ms": times,
           "host_us_a_launch": {k: statistics.median(v) for k, v in host.items()},
           "grid": split_.tenants.grid, "slices": split_.slices, "rows": rows, "features": f,
           "valid_rows": [TS_TIME_VALID] * TS_M}
    if hasattr(fused_sgd, "tenant_split_probe"):
        out["probe"] = tsplit_probe((xs, ys, ms), w0s)
        out["probe_one_tenant"] = tsplit_probe(one, w0[None].contiguous())
    return out, (xs, ys, ms, w0s, step, plan.fpad, kw)


def tenant_split_times(smi):
    """``tenant_split_timing``'s launches, probe splits and host enqueue, with
    the iteration launch's plain version (each tenant's
    ``fused_dense_iteration_reference``), the library call (``torch.bmm`` of
    the TS_M tenants' Xᵀr on the f32 X of their valid rows) and its bound.
    Returns the kernels line's record, without its launches and errors."""
    import torch

    from twtml_tpu_torch.ops import fused_sgd

    t, (xs, ys, ms, w0s, step, fpad, kw) = tenant_split_timing()
    rows, f, n = t["rows"], t["features"], 50
    g = torch.cat([step.gbuf[:, :f], step.gbuf[:, fpad:]], dim=1)
    plain_ms = split_queued(lambda: [fused_sgd.fused_dense_iteration_reference(
        xs[u], ys[u], ms[u], w0s[u], g[u], it=2, **kw) for u in range(TS_M)], 3, 10)[0]
    v = TS_TIME_VALID
    xv = xs[:, :v].contiguous()
    r = (torch.bmm(xv, w0s[..., None])[..., 0] - ys[:, :v]) * ms[:, :v]
    library_ms = split_queued(lambda: torch.bmm(xv.transpose(1, 2), r[..., None]), 5, n)[0]
    valid = TS_M * v
    # each input read once and each output written once at the parts' valid
    # rows: X (bf16, as staged), y and the mask, each tenant's w and its
    # all-reduced Xᵀr and count; written: each tenant's w, Xᵀr and count
    moved = 2 * valid * f + 4 * (2 * valid + 4 * f * TS_M + 2 * TS_M)
    ops = 4 * valid * f + 8 * f * TS_M  # x·w and r·x a valid element; the update's 8 a column
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
    update_moved = 4 * TS_M * (3 * f + 1)  # the update alone: w, Xᵀr, count read; w written
    tms, host = t["ms"], t["host_us_a_launch"]
    record = {
        "name": TS_ENTRY, "route": "cuda", "source": "twtml_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "twtml_tpu/ops/pallas_sgd.py:55",
        "ms": tms["tenants"], "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "library": "torch.bmm(X.transpose(1, 2), r) of the tenants' valid rows, f32 X",
        "bound_bytes": moved, "card": smi, "tenants": TS_M, "rows": rows,
        "valid_rows": t["valid_rows"], "features": f, "grid": t["grid"],
        "slices": t["slices"], "split_ms": tms["split"], "one_tenant_ms": tms["one_tenant"],
        "update_ms": tms["tenants_update"],
        "split_update_ms": tms["split_update"], "update_bound_bytes": update_moved,
        "update_bound_ms": update_moved / HBM_BYTES_PER_S * 1e3, "turns_ms": t["turns_ms"],
        "host_us_a_launch": host, "probe": t.get("probe"),
        "probe_one_tenant": t.get("probe_one_tenant"),
    }
    phase("modelaxis", f"{TS_ENTRY}: {tms['tenants']:.5f} ms an iteration launch at {TS_M} x "
          f"{v} valid rows of {rows} x {f} (grid {t['grid']}, {t['slices']} slices; turns "
          f"{[round(x, 5) for x in t['turns_ms']['tenants']]}), the split's on the same {valid} "
          f"rows as one model {tms['split']:.5f} ms (turns "
          f"{[round(x, 5) for x in t['turns_ms']['split']]}), as one tenant through this "
          f"kernel {tms['one_tenant']:.5f} ms; the update-only launch "
          f"{tms['tenants_update']:.5f} ms (one tenant {tms['one_tenant_update']:.5f}) against "
          f"the split's {tms['split_update']:.5f}; twin "
          f"{plain_ms:.5f} ms, {record['library']} {library_ms:.5f} ms, bound "
          f"{record['bound_ms']:.5f} ms ({record['bound_by']}, {moved} B); host enqueue "
          f"{ {k: round(x, 1) for k, x in host.items()} } µs | card: {smi}")
    for key in ("probe", "probe_one_tenant"):
        phase("modelaxis", f"{TS_ENTRY} {key} (valid rows {t[key]['valid_rows']}): "
              f"{tsplit_probe_text(t[key])} | card: {smi}")
    return record


def tenant_split_ab_times():
    """One ``--tsplit-ab`` arm: ``tenant_split_timing``'s numbers."""
    return tenant_split_timing()[0]


def tsplit_ab(smi, pairs, parent_root):
    """``--tsplit-ab N --package-root DIR``: the split with a tenant grid at
    TS_M x TS_TIME_VALID valid rows of a rank's MH_ROWS x 1004
    (``tenant_split_timing``: the iteration and the update-only launch, the
    split's beside them, the host's enqueue, the probe split where a tree
    has it), the port found in DIR (e.g. the parent commit unpacked there)
    against this checkout's, each arm in a process of its own, N pairs, the
    order alternating; each tree's ptxas report of the kernel."""
    import glob

    def report(i, arm, rec):
        ms, host = rec["ms"], rec["host_us_a_launch"]
        phase("tsplit-ab", f"pair {i} {arm} (run {rec['position'] + 1} of 2): an iteration "
              f"{ms['tenants']:.5f} ms (the split's {ms['split']:.5f}; one tenant of those "
              f"rows {ms['one_tenant']:.5f}), the update-only launch "
              f"{ms['tenants_update']:.5f} (the split's {ms['split_update']:.5f}); host "
              f"enqueue {host['tenants']:.1f} / {host['tenants_update']:.1f} µs (the split's "
              f"{host['split']:.1f} / {host['split_update']:.1f})")
        for key in ("probe", "probe_one_tenant"):
            if key in rec:
                phase("tsplit-ab", f"pair {i} {arm} {key}: {tsplit_probe_text(rec[key])}")

    roots = {"parent": parent_root, "change": HERE}
    runs = ab_pairs("tsplit-ab", "tenant_split_ab_times", pairs, parent_root, report)
    keys = {"iteration_ms": ("ms", "tenants"), "one_tenant_ms": ("ms", "one_tenant"),
            "update_ms": ("ms", "tenants_update"),
            "one_tenant_update_ms": ("ms", "one_tenant_update"),
            "split_ms": ("ms", "split"), "split_update_ms": ("ms", "split_update"),
            "host_us": ("host_us_a_launch", "tenants"),
            "split_host_us": ("host_us_a_launch", "split")}
    medians = {arm: {k: statistics.median(r[a][b] for r in rows) for k, (a, b) in keys.items()}
               for arm, rows in runs.items()}
    pair_of = lambda arm: sorted(runs[arm], key=lambda r: r["pair"])  # noqa: E731
    wins = {k: sum(c[a][b] < p[a][b] for c, p in zip(pair_of("change"), pair_of("parent")))
            for k, (a, b) in keys.items()}
    for arm, root in roots.items():
        for log in glob.glob(os.path.join(root, "build", "twtml_tpu_torch", "libfused_sgd-*.log")):
            phase("tsplit-ab", f"{arm} build ({os.path.basename(log)}), tenant_iteration_kernel:\n"
                  + "\n".join(ptxas_blocks(open(log).read(), "tenant_iteration_kernel")))
    mc, mp = medians["change"], medians["parent"]
    phase("tsplit-ab", f"medians over {pairs} pairs: an iteration {mc['iteration_ms']:.5f} ms "
          f"against the parent's {mp['iteration_ms']:.5f}, lower in {wins['iteration_ms']} of "
          f"{pairs} (the split's {mc['split_ms']:.5f} / {mp['split_ms']:.5f}; one tenant "
          f"{mc['one_tenant_ms']:.5f} / {mp['one_tenant_ms']:.5f}); the update-only "
          f"launch {mc['update_ms']:.5f} against {mp['update_ms']:.5f} (one tenant "
          f"{mc['one_tenant_update_ms']:.5f} / {mp['one_tenant_update_ms']:.5f}; the split's "
          f"{mc['split_update_ms']:.5f} / {mp['split_update_ms']:.5f}); host enqueue "
          f"{mc['host_us']:.1f} against {mp['host_us']:.1f} µs (the split's "
          f"{mc['split_host_us']:.1f} / {mp['split_host_us']:.1f}) | card: {smi}")
    print(json.dumps({"tsplit_ab": {"pairs": pairs, "runs": runs, "medians": medians,
                                    "change_wins": wins, "card": smi}}), flush=True)


def mesh_vmap_hold(name, recs, arrays, vmap, scan):
    """``vmap`` against ``scan`` (run names) on the same mesh: each rank's
    stack within VMAP_RTOL / VMAP_ATOL of scan's, the counts equal, the
    predictions at most one HALF_UP step apart (counted). Returns (weights
    max error, flips)."""
    import numpy as np

    w_err, flips = 0.0, 0
    for rank in range(len(recs)):
        av, as_ = arrays[vmap][rank], arrays[scan][rank]
        if not (np.allclose(av["w"], as_["w"], rtol=VMAP_RTOL, atol=VMAP_ATOL)
                and np.array_equal(av["counts"], as_["counts"])):
            raise AssertionError(f"tenants mesh {name}: rank {rank}'s vmap stack differs "
                                 f"from the scan form's by "
                                 f"{float(np.max(np.abs(av['w'] - as_['w']))):.3g} (counts "
                                 f"{av['counts'].tolist()} against {as_['counts'].tolist()})")
        w_err = max(w_err, float(np.max(np.abs(av["w"] - as_["w"]))))
        d = np.abs(av["preds"].astype(np.float64) - as_["preds"])
        if d.max(initial=0.0) > 1.0:
            raise AssertionError(f"tenants mesh {name}: rank {rank}'s predictions differ "
                                 f"by {d.max():.3g}, more than one HALF_UP step")
        flips += int((d > 0).sum())
    return w_err, flips


def tenants_mesh_arm(smi, statuses, workdir, pairs=1):
    """The vmap form over a data axis on 2 gloo ranks on the card
    (tests/torch_mesh_worker.py): the split with a tenant grid against its
    plain version on each rank over the real all-reduce (``tenant_split``
    mode, both residual modes, each of TS_CHECKS: a tenant dry on one rank,
    one dry on both when M > 2; NaN/Inf in masked rows bitwise ignored; one tenant
    bitwise the split), then TS_M tenants at 1004 columns on MH_ROWS rows a
    rank, a warm-up tick and TS_TICKS ticks of ``statuses``, the vmap form
    against the scan form on the same mesh in ``pairs`` turns of (vmap,
    scan, scan, vmap): weights within VMAP_RTOL / VMAP_ATOL, counts equal,
    rounded predictions off by one HALF_UP step at most (counted), each
    form's reruns bitwise; the all-reduces a tick (N + 2 against TS_M x
    that) and their ms, a rank's host wall a tick. Returns (the arm's
    summary, the kernels line's record)."""
    import numpy as np

    t0 = time.perf_counter()
    record = tenant_split_times(smi) if MA_DEVICE == "cuda" else {"name": TS_ENTRY}
    n = max(1, len(statuses) // OP_ROWS)
    pool = [s for k in range(TS_TICKS + 1)
            for s in statuses[(k % n) * OP_ROWS:(k % n + 1) * OP_ROWS]]
    path = os.path.join(workdir, "tenants-mesh.npz")
    ma_unit_batches(path, pool, OP_ROWS, TS_F, MA_LONG_UNITS)
    model = dict(num_text_features=TS_F, num_iterations=OP_ITERS, step_sizes=list(TENANT_STEPS),
                 l2_regs=list(TENANT_L2S), quality=True)
    checks = [{"mode": "tenant_split", "name": f"split_{case}_{mode}", "residual": residual,
               "tenants": m, "rows": rows, "features": TS_F + 4, "valid": valid,
               "iterations": OP_ITERS, "step_sizes": [steps[t % 4] for t in range(m)],
               "l2_regs": [TENANT_L2S[t % 4] for t in range(m)], "seed": 41}
              for case, (m, rows, valid) in TS_CHECKS.items()
              for mode, residual, steps in (("least_squares", "", TENANT_STEPS),
                                            ("logistic", "logistic", TENANT_LG_STEPS))]
    order = [("vmap", "scan", "scan", "vmap")[i % 4] for i in range(4 * pairs)]
    names = [f"{form}{i}" for i, form in enumerate(order)]
    runs = checks + [{"mode": "tenants", "name": name, "mapping": form, "num_tenants": TS_M,
                      "batches": path, "wire": "unit", "model": model}
                     for name, form in zip(names, order)]
    recs, arrays, wall = ma_group("tenants-mesh", workdir, MH_RANKS,
                                  {"num_data": MH_RANKS, "num_model": 1, "runs": runs})
    out = {"card": smi, "group_wall_s": wall, "checks": {}}
    errs = []
    for check in checks:
        name = check["name"]
        rr = [r["runs"][name] for r in recs]
        ws = [a["w"] for a in arrays[name]]
        bad = [r for r in rr if not (r["within"] and r["dirty_bitwise"]
                                     and r["one_tenant_bitwise"])]
        if bad or not np.array_equal(ws[0], ws[1]) or rr[0]["iterations"] != rr[1]["iterations"]:
            raise AssertionError(f"tenants mesh {name}: {[{k: r[k] for k in ('w_err', 'p_err', 'within', 'dirty_bitwise', 'one_tenant_bitwise', 'iterations')} for r in rr]}, ranks' weights equal: {np.array_equal(ws[0], ws[1])}")
        if MA_DEVICE == "cuda" and check["tenants"] > 2 and rr[0]["iterations"][2] != 0:
            raise AssertionError(f"tenants mesh {name}: tenant 2 (no row on any rank) ran "
                                 f"{rr[0]['iterations'][2]} iterations")
        errs += [r["w_err"] for r in rr] + [r["p_err"] for r in rr]
        out["checks"][name] = {"ranks": [{k: r[k] for k in ("valid", "iterations", "w_err",
                                                            "p_err", "w_scale", "p_scale")}
                                         for r in rr]}
        phase("modelaxis", f"tenants mesh {name}: the split with a tenant grid on 2 ranks, "
              f"{check['tenants']} parts of {check['rows']} rows (valid rows "
              f"{[r['valid'] for r in rr]}, iterations {rr[0]['iterations']}) "
              f"within rtol {RTOL} atol {ATOL} of its plain version over the same all-reduce "
              f"(weights {max(r['w_err'] for r in rr):.3g}, margins "
              f"{max(r['p_err'] for r in rr):.3g}), the ranks' stacks bitwise equal (tenant 1 "
              "updated on the rank without its rows), NaN/Inf in masked rows bitwise ignored, "
              "one tenant of every row bitwise the split")
    record["max_abs_err"] = max(errs)
    # the vmap form against the scan form, each form's runs bitwise each other
    by_form = {form: [nm for nm, fm in zip(names, order) if fm == form]
               for form in ("vmap", "scan")}
    for form, nms in by_form.items():
        for nm in nms[1:]:
            for a, b in zip(arrays[nms[0]], arrays[nm]):
                if not all(np.array_equal(a[k], b[k]) for k in ("w", "counts", "preds")):
                    raise AssertionError(f"tenants mesh: {form} runs {nms[0]} and {nm} differ")
    w_err, flips = mesh_vmap_hold("dense", recs, arrays, by_form["vmap"][0], by_form["scan"][0])
    ticks = TS_TICKS + 1
    want = {"vmap": OP_ITERS + 2, "scan": TS_M * (OP_ITERS + 2)}
    want_launches = {"vmap": {TS_ENTRY: ticks * (OP_ITERS + 1), "fused_dense_grad": 0},
                     "scan": {TS_ENTRY: 0, "fused_dense_grad": TS_M * ticks * OP_ITERS}}
    numbers = {}
    for form, nms in by_form.items():
        rr = [r["runs"][nm] for nm in nms for r in recs]
        for r in rr:
            counts = [t["allreduces"] for t in r["tick_collectives"]]
            got = {k: r["launches"][k] for k in want_launches[form]}
            if MA_DEVICE != "cuda":
                got = want_launches[form]  # the CPU twins count no launch
            if counts != [want[form]] * ticks or got != want_launches[form]:
                raise AssertionError(f"tenants mesh {form}: all-reduces a tick {counts}, "
                                     f"launches {got}; want {want[form]} and "
                                     f"{want_launches[form]}")
        timed = [(r["step_wall_ms"][1:], r["step_device_ms"][1:],
                  [c.get("allreduce", 0.0) for c in r["step_collective_ms"][1:]]) for r in rr]
        wall_ms = statistics.median([x for t in timed for x in t[0]])
        numbers[form] = {
            "allreduces_a_tick": want[form],
            "tick_wall_ms": wall_ms,
            "tick_wall_ms_by_run": [statistics.median(t[0]) for t in timed],
            "tick_device_ms": (statistics.median([x for t in timed for x in t[1]])
                               if timed[0][1] else None),
            "allreduce_ms_a_tick": statistics.median([x for t in timed for x in t[2]]),
        }
        numbers[form]["ms_an_allreduce"] = numbers[form]["allreduce_ms_a_tick"] / want[form]
    out.update(weights_max_err=w_err, flips=flips, forms=numbers,
               launches=sum(r["runs"][nm]["launches"].get(TS_ENTRY, 0)
                            for nm in by_form["vmap"] for r in recs))
    record["launches"] = out["launches"]
    nv, ns = numbers["vmap"], numbers["scan"]
    phase("modelaxis", f"tenants mesh: vmap over 2 ranks x {MH_ROWS} rows, {TS_M} tenants, "
          f"{TS_F + 4} columns, {TS_TICKS} ticks after a warm-up, {len(order)} runs in turns: "
          f"the stack within {w_err:.3g} of the scan form's (rtol/atol {VMAP_RTOL}), counts "
          f"equal, {flips} HALF_UP flips; all-reduces a tick {nv['allreduces_a_tick']} against "
          f"scan's {ns['allreduces_a_tick']} ({nv['allreduce_ms_a_tick']:.1f} against "
          f"{ns['allreduce_ms_a_tick']:.1f} ms a tick, {nv['ms_an_allreduce']:.2f} and "
          f"{ns['ms_an_allreduce']:.2f} ms each); a rank's host wall a tick "
          f"{nv['tick_wall_ms']:.1f} ms against scan's {ns['tick_wall_ms']:.1f} ms; launches of "
          f"{TS_ENTRY} {out['launches']}; arm wall {time.perf_counter() - t0:.1f} s | "
          f"card: {smi}")
    out["wall_s"] = time.perf_counter() - t0
    return out, record


# ---- phase 26, its 2^18 vmap arm over a data axis: the tenant forms there (B10 d)

TM_TICKS = 5  # timed ticks a run, after one warm-up tick
TM_SAMPLED = 0.5  # the held -b run's fraction
TM_LONG_AT = 5  # the mixed tick's tweet-length row: row 5, on rank 0
TM_FORMS = ("count_build_tenants", "dual_sgd_tenants", "dual_writeback_tenants")
TM_SINGLE = ("count_build", "dual_sgd", "dual_writeback_counts")
# each form's hold against its plain version on each rank: (rtol, atol);
# atol None: rtol x max(1, the plain version's largest magnitude), B8's rule
TM_HOLDS = {"dual_sgd_tenants": (RTOL, ATOL), "dual_writeback_tenants": (WEIGHT_RTOL, None)}


def tm_batches(workdir):
    """The arm's global batches at config #4's width (GRAM_ROWS tweets of
    ASCII and CJK words a tick, ``ma_statuses``), saved for the worker:
    ``short`` (TM_TICKS + 1 ticks of short tweets: the int8 plane),
    ``two`` (its first two) and ``mixed`` (a short tick, then one whose row
    TM_LONG_AT, on rank 0, is tweet-length: its tenant's gathered rows in
    the exact plane on both ranks). Returns (the paths, the short
    batches)."""
    short = ma_statuses(MA_SHORT_SPAN, GRAM_ROWS, TM_TICKS + 1, 23)
    paths = {k: os.path.join(workdir, f"tm-{k}.npz") for k in ("short", "two", "mixed")}
    batches = ma_unit_batches(paths["short"], short, GRAM_ROWS, GRAM_F, MA_UNITS)
    ma_unit_batches(paths["two"], short[:2 * GRAM_ROWS], GRAM_ROWS, GRAM_F, MA_UNITS)
    mixed = list(short[:2 * GRAM_ROWS])
    mixed[GRAM_ROWS + TM_LONG_AT] = ma_statuses(MA_LONG_SPAN, 1, 1, 41)[0]
    ma_unit_batches(paths["mixed"], mixed, GRAM_ROWS, GRAM_F, MA_LONG_UNITS)
    return paths, batches


def tm_trace(where, ticks):
    """A rank's profiled ticks (the worker's ``profile``): the device's busy
    ms a tick (the union of its kernels, copies and sets), its kernels a
    tick, the host's launches a tick (CUDA runtime and low-level API calls) and the
    device's five largest ms a tick by kernel or copy name."""
    import glob
    from collections import Counter

    with open(glob.glob(os.path.join(where, "*.pt.trace.json"))[0]) as fh:
        events = json.load(fh)["traceEvents"]
    by_name = Counter()
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            by_name[e.get("name", "")[:60]] += e.get("dur", 0) / 1e3 / ticks
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    launches = sum(1 for e in events if e.get("cat", "").startswith("cuda_")
                   and e.get("name", "").startswith(("cudaLaunch", "cuLaunch")))
    return {"device_busy_ms_a_tick": device_busy_ms(events) / ticks,
            "kernels_a_tick": kernels / ticks,
            "host_launches_a_tick": launches / ticks,
            "largest_ms_a_tick": dict(by_name.most_common(5))}


def tm_forms_held(recs, run, planes_a_tick):
    """The worker's holds of the tenant forms on each rank in ``run``
    (``hold_forms``): B4's bitwise its plain version (its blocks at the
    same rows), B7's and B8's within TM_HOLDS, B7's iterations run the plain
    version's; B4 once a plane a tick (``planes_a_tick``), B7 and B8 once a
    tick. Returns the largest error by form."""
    errs = dict.fromkeys(TM_FORMS, 0.0)
    for rank, r in enumerate(recs):
        forms = r["runs"][run]["forms"]
        got = {f: sum(1 for e in forms if e["form"] == f) for f in TM_FORMS}
        want = {"count_build_tenants": sum(planes_a_tick),
                "dual_sgd_tenants": len(planes_a_tick),
                "dual_writeback_tenants": len(planes_a_tick)}
        if got != want:
            raise AssertionError(f"tenants mesh sparse {run} rank {rank}: forms called {got}, "
                                 f"want {want}")
        for e in forms:
            form = e["form"]
            if form == "count_build_tenants":
                ok = e["bitwise"] and e["at_equal"]
            else:
                rtol, atol = TM_HOLDS[form]
                atol = rtol * max(1.0, e["scale"]) if atol is None else atol
                ok = e["max_abs_err"] <= atol + rtol * e["scale"]
                if form == "dual_sgd_tenants":
                    ok = ok and e["iterations_equal"]
            if not ok:
                raise AssertionError(f"tenants mesh sparse {run} rank {rank}: {form} against its "
                                     f"plain version: {e}")
            errs[form] = max(errs[form], e["max_abs_err"])
    return errs


def tm_time_inputs(batch):
    """Rank 0's share of the arm's first short tick as the batched step
    builds it: both ranks' halves of ``batch`` (a global host UnitBatch)
    routed to SV_M parts each, decoded on the card and laid out as the
    tenant-row all-gather lays them ([M, ranks · B_local], rank-major
    within a tenant), the row table (``TenantRowTable``), each tenant's
    block rows (``index``), W_prev random (seed 5), u = Z·W_prev, p_prev
    and the dual loop's keywords (50 iterations, tolerance 0.001)."""
    import types

    import numpy as np
    import torch

    from twtml_tpu_torch.features.batch import UnitBatch
    from twtml_tpu_torch.models.sgd import (
        TenantRowTable, batch_to_device, decode_batch, flatten_tenants)
    from twtml_tpu_torch.ops.sparse import sparse_predict
    from twtml_tpu_torch.parallel.tenants import TenantStackModel

    router = TenantStackModel(SV_M, mapping="vmap", num_text_features=GRAM_F, device=MA_DEVICE)
    half = GRAM_ROWS // MH_RANKS
    fields, valid = [], []
    for r in range(MH_RANKS):
        wire = router.prepare_wire_from_parts(router.split(UnitBatch(
            *(np.asarray(a)[r * half:(r + 1) * half] for a in batch))))
        valid.append(tuple(router.valid_rows(wire)))
        dev = batch_to_device(wire, router.device, non_blocking=False)
        fields.append([x.view((SV_M, half) + tuple(x.shape[1:]))
                       for x in decode_batch(flatten_tenants(dev), GRAM_F, torch.float32)])
    idx, val, num, y, mask = (torch.cat(xs, dim=1) for xs in zip(*fields))
    m, f = SV_M, GRAM_F
    w = torch.from_numpy((np.random.default_rng(5).normal(size=(m, f + 4)) * 1e-3)
                         .astype(np.float32)).to(idx.device)
    raw = sparse_predict(w[:, :f], w[:, f:], idx, val, num)
    table = TenantRowTable(valid=tuple(valid), rank=0, rows=half)
    index = table.index(idx.device)
    t_ = torch.arange(m, device=idx.device)[:, None]
    kw = dict(num_iterations=OP_ITERS, step_sizes=[0.005] * m, l2_regs=[0.1] * m,
              convergence_tol=0.001)
    return types.SimpleNamespace(
        table=table, idx=idx, val=val, index=index, u=raw[t_, index], y=y[t_, index],
        mask=mask[t_, index], num=num[t_, index], w=w, p_prev=torch.sum(w * w, dim=1), kw=kw)


def tm_times(smi, batch, errs, launches):
    """The tenant forms at the arm's shapes on rank 0's share of its first
    short tick (``tm_time_inputs``): each alone, 50 calls back to back behind
    ``split_queued``'s sleep (the median of SV_TIME_RUNS), its plain
    version's time, its bound and the library call where one computes the
    same work (B4: ``torch.bincount`` over block-offset keys; B8:
    ``index_add_`` of this rank's rows' contributions; B7: none),
    each against its plain version here too; this rank's G panels' products.
    Returns the kernels line's three records."""
    import torch

    from twtml_tpu_torch.ops import fused_gram

    x = tm_time_inputs(batch)
    table, idx, val, kw = x.table, x.idx, x.val, x.kw
    totals, mine = table.totals, table.mine()
    m, f, l = SV_M, GRAM_F, idx.shape[2]

    def queued(fn):
        ms, all_ms, host_us = split_queued(fn, SV_TIME_RUNS)
        return {"ms": ms, "runs_ms": all_ms, "host_enqueue_us": host_us}

    def record(name, kernel, replaces, t, plain_ms, bound, library_ms, extra):
        bytes_ms, ops_ms = bound
        return dict({
            "name": f"{name}:data_axis", "route": "cuda",
            "source": "twtml_tpu_torch/csrc/gram.cu", "replaces": replaces,
            "tpu_function": None, "kernel": kernel, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "valid_rows": [list(v) for v in table.valid],
            "block_rows": list(totals), "rank_rows": [list(r) for r in mine],
            "runs_ms": t["runs_ms"], "host_enqueue_us": t["host_enqueue_us"],
            "card": smi}, **extra)

    # B4's tenant form over the segments
    segs = table.segments()
    counts, at = fused_gram.count_build_tenants(idx, val, f, valid_rows=totals, int8=True,
                                                segments=segs)
    plain, plain_at = fused_gram.count_build_tenants_reference(
        idx, val, f, valid_rows=totals, int8=True, cols_out=counts.shape[1], segments=segs)
    torch.cuda.synchronize()
    if not torch.equal(counts, plain) or plain_at != at:
        raise AssertionError("tenants mesh sparse times: B4's segments are not bitwise its "
                             "plain version")
    del plain
    rows, cols = counts.shape
    b4 = queued(lambda: fused_gram.count_build_tenants(idx, val, f, valid_rows=totals, int8=True,
                                                       segments=segs))
    b4_plain, _ = timed(lambda: fused_gram.count_build_tenants_reference(
        idx, val, f, valid_rows=totals, int8=True, cols_out=cols, segments=segs), 3)
    tv = sum(totals)
    b4_bytes = rows * cols + tv * l * 8
    t_ = torch.arange(m, device=idx.device)[:, None]
    b_idx, b_val = idx[t_, x.index], val[t_, x.index]
    keys = torch.cat([(at[t] + torch.arange(p, device=idx.device))[:, None] * cols
                      + b_idx[t, :p] for t, p in enumerate(totals) if p]).reshape(-1)
    kval = torch.cat([b_val[t, :p] for t, p in enumerate(totals) if p]).reshape(-1)
    b4_lib, _ = timed(lambda: torch.bincount(keys, weights=kval, minlength=rows * cols), 10,
                      queue_ahead=True)
    del keys, kval, b_idx, b_val
    # this rank's G panels, then every tenant's G as the panels' all-gather leaves it
    panels = queued(lambda: fused_gram.tenant_gram_blocks(counts, at, totals, rows=mine))
    gs = [None if g is None else g[:p, :p].contiguous()
          for g, p in zip(fused_gram.tenant_gram_blocks(counts, at, totals), totals)]
    # B7's tenant form on the blocks
    args = (gs, x.u, x.y, x.mask, x.num)
    c, alpha, its = fused_gram.dual_sgd_tenants(*args, valid_rows=totals, p_prev=x.p_prev, **kw)
    c_r, alpha_r, its_r = fused_gram.dual_sgd_tenants_reference(*args, valid_rows=totals,
                                                                p_prev=x.p_prev, **kw)
    if not torch.equal(its, its_r.to(its.dtype)):
        raise AssertionError(f"tenants mesh sparse times: B7 ran {its.tolist()} iterations, its "
                             f"plain version {its_r.tolist()}")
    e7 = max(compare("tenants mesh sparse B7 alpha", alpha, alpha_r)[0],
             compare("tenants mesh sparse B7 c", c, c_r)[0])
    its = [int(i) for i in its.tolist()]
    b7 = queued(lambda: fused_gram.dual_sgd_tenants(*args, valid_rows=totals, p_prev=x.p_prev,
                                                    **kw))
    b7_plain, _ = timed(lambda: fused_gram.dual_sgd_tenants_reference(
        *args, valid_rows=totals, p_prev=x.p_prev, **kw), 3)
    b7_ops = sum(i * (2 * p * p + 12 * p) for i, p in zip(its, totals))
    b7_bytes = sum(p * p * 4 + 9 * p * 4 for p in totals)
    # B8's tenant form at this rank's rows of each block, on zero weights:
    # rank 0's rows of each gathered part of the tokens
    zeros = torch.zeros_like(x.w)
    wb_kw = dict(valid_rows=[n for _, n in mine], first_rows=[o for o, _ in mine],
                 token_rows=[table.rank * table.rows] * m)
    delta = torch.empty_like(x.w)
    fused_gram.dual_writeback_tenants(zeros, c, alpha, idx, val, x.num, f, out=delta, **wb_kw)
    want = fused_gram.dual_writeback_tenants_reference(zeros, c, alpha, idx, val, x.num, f,
                                                       **wb_kw)
    torch.cuda.synchronize()
    e8 = float((delta - want).abs().max())
    if e8 > WEIGHT_RTOL * max(1.0, float(want.abs().max())) or not torch.isfinite(delta).all():
        raise AssertionError(f"tenants mesh sparse times: B8 at rank 0's rows differs from its "
                             f"plain version by {e8:.3e}")
    b8 = queued(lambda: fused_gram.dual_writeback_tenants(zeros, c, alpha, idx, val, x.num, f,
                                                          out=delta, **wb_kw))
    b8_plain, _ = timed(lambda: fused_gram.dual_writeback_tenants_reference(
        zeros, c, alpha, idx, val, x.num, f, **wb_kw), 3)
    vr = sum(n for _, n in mine)
    wb_bytes = b8_bytes(vr, l, f, tenants=m)
    b8_ops = 2 * vr * l + 8 * vr + 2 * m * (f + 4)
    c_read = vr * cols  # what B8 streamed before it took the tokens
    r0 = table.rank * table.rows
    keys8 = torch.cat([t * f + idx[t, r0:r0 + n].reshape(-1).long()
                       for t, (_, n) in enumerate(mine) if n])
    contrib8 = torch.cat([(val[t, r0:r0 + n] * alpha[t, o:o + n, None]).reshape(-1)
                          for t, (o, n) in enumerate(mine) if n])
    w_flat = torch.zeros(m * f, device=idx.device)
    b8_lib, _ = timed(lambda: w_flat.index_add_(0, keys8, contrib8), 10, queue_ahead=True)
    del keys8, contrib8
    errs = dict(errs, dual_sgd_tenants=max(errs["dual_sgd_tenants"], e7),
                dual_writeback_tenants=max(errs["dual_writeback_tenants"], e8))
    phase("modelaxis", f"tenants mesh sparse times at rank 0's share of a short tick (valid rows "
          f"by rank {[list(v) for v in table.valid]}, blocks {list(totals)}, int8 counts "
          f"{tuple(counts.shape)}; 50 calls back to back behind ~20 ms of sleep, median of "
          f"{SV_TIME_RUNS}): B4's tenant form over the segments {b4['ms']:.4f} ms, plain "
          f"{b4_plain:.4f}, torch.bincount {b4_lib:.4f}, bound "
          f"{b4_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms; this rank's {sum(1 for _, n in mine if n)} "
          f"G panels {panels['ms']:.4f} ms; B7's tenant form {b7['ms']:.4f} ms ({its} "
          f"iterations), plain {b7_plain:.4f}, bound {b7_ops / F32_FLOPS_PER_S * 1e3:.5f} ms; B8's "
          f"tenant form at this rank's rows {b8['ms']:.4f} ms, plain {b8_plain:.4f}, torch "
          f"index_add_ {b8_lib:.4f}, bound from its own bytes {wb_bytes} B = "
          f"{wb_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms (one read of the int8 C: "
          f"{c_read / HBM_BYTES_PER_S * 1e3:.5f} ms) | card: {smi}")
    vmap = "under jax.vmap in shard_map (twtml_tpu/parallel/tenants.py:324-352)"
    return [
        record("count_build_tenants", "B4 tenant form over a data axis's gathered rows",
               f"twtml_tpu/ops/gram.py:133 (onehot_counts_int8) {vmap}", b4, b4_plain,
               (b4_bytes / HBM_BYTES_PER_S * 1e3, 0.0), b4_lib, dict(
                   library_call="torch.bincount over block-offset keys",
                   gram_panels={"call": "torch._int_mm", "ms": panels["ms"]})),
        record("dual_sgd_tenants", "B7 tenant form, replicated on the gathered blocks",
               f"twtml_tpu/models/sgd.py:155 (run_dual_loop) {vmap}", b7, b7_plain,
               (b7_bytes / HBM_BYTES_PER_S * 1e3, b7_ops / F32_FLOPS_PER_S * 1e3), None,
               dict(iterations_run=its)),
        record("dual_writeback_tenants", "B8 tenant form at a rank's rows of each block",
               f"twtml_tpu/models/sgd.py:363-368 (the sharded write-back) {vmap}", b8, b8_plain,
               (wb_bytes / HBM_BYTES_PER_S * 1e3, b8_ops / F32_FLOPS_PER_S * 1e3), b8_lib,
               dict(library_call="torch.Tensor.index_add_ over tenant-offset keys of this "
                    "rank's rows (the scatter alone; atomics, not bitwise reproducible)",
                    bytes=wb_bytes, int8_c_read_bytes=c_read)),
    ]


def tenants_mesh_sparse_arm(smi, workdir):
    """The vmap form on the 2^18 routes over a data axis (ROADMAP B10 d) on 2
    gloo ranks on the card (tests/torch_mesh_worker.py): BASELINE config #4
    (2^18, L2 0.1, 50 iterations, model watch on), B = GRAM_ROWS global,
    SV_M tenants routed by hash. Runs: the forms held against their plain
    versions on each rank (``hold_forms``) on a short tick and the mixed
    tick (two planes), and under ``-b 0.5`` (each tenant's own draws); the
    timed short ticks (a warm-up and TM_TICKS) in one turn of (vmap, scan,
    scan, vmap), each form's reruns bitwise; a profiled run of each
    form; the mixed tick and ``-b 0.5`` against scan; the scatter route
    against scan. Every vmap run within VMAP_RTOL / VMAP_ATOL of its scan
    run, counts equal, HALF_UP flips counted; the collectives a tick (2
    all-gathers and 3 all-reduces on the Gram route, N + 2 all-reduces on
    the scatter route, against scan's M times its own) and their ms, a
    rank's host wall, device busy ms and launches a tick; then the forms'
    times at these shapes (``tm_times``). Returns (the summary, the kernels
    line's three records)."""
    import numpy as np

    t0 = time.perf_counter()
    paths, short = tm_batches(workdir)
    model = dict(num_text_features=GRAM_F, num_iterations=OP_ITERS, step_size=0.005,
                 l2_reg=0.1, quality=True)

    def run(name, mapping, path, extra=None, **opts):
        return dict({"mode": "tenants", "name": name, "mapping": mapping, "num_tenants": SV_M,
                     "batches": paths[path], "wire": "unit",
                     "model": dict(model, **(extra or {}))}, **opts)

    order = ("vmap", "scan", "scan", "vmap")
    names = [f"tm_{form}{i}" for i, form in enumerate(order)]
    prof = os.path.join(workdir, "tm-prof")
    sampled = {"mini_batch_fraction": TM_SAMPLED}
    runs = [run("tm_mixed_vmap", "vmap", "mixed", hold_forms=True),
            run("tm_mixed_scan", "scan", "mixed"),
            run("tm_sampled_vmap", "vmap", "two", sampled, hold_forms=True),
            run("tm_sampled_scan", "scan", "two", sampled),
            *(run(nm, form, "short") for nm, form in zip(names, order)),
            run("tm_vmap_prof", "vmap", "short", profile=os.path.join(prof, "vmap")),
            run("tm_scan_prof", "scan", "short", profile=os.path.join(prof, "scan")),
            run("tm_scatter_vmap", "vmap", "two", {"use_gram": False}),
            run("tm_scatter_scan", "scan", "two", {"use_gram": False})]
    recs, arrays, wall = ma_group("tenants-mesh-sparse", workdir, MH_RANKS,
                                  {"num_data": MH_RANKS, "num_model": 1, "runs": runs})
    out = {"card": smi, "group_wall_s": wall}
    for spec in runs:
        for rank, r in enumerate(recs):
            rr = r["runs"][spec["name"]]
            route = "scatter" if "scatter" in spec["name"] else "gram"
            if rr["route"] != route or rr["batched"] != (spec["mapping"] == "vmap"):
                raise AssertionError(f"tenants mesh sparse {spec['name']} rank {rank}: route "
                                     f"{rr['route']}, batched {rr['batched']}")
    # the forms against their plain versions on each rank, at the arm's shapes
    errs = dict.fromkeys(TM_FORMS, 0.0)
    if MA_DEVICE == "cuda":  # the CPU runs the plain pieces, no form
        for name, planes in (("tm_mixed_vmap", [1, 2]), ("tm_sampled_vmap", [1, 1])):
            for form, e in tm_forms_held(recs, name, planes).items():
                errs[form] = max(errs[form], e)
        for r in recs:
            if not all(e["tenant_draws"] for e in r["runs"]["tm_sampled_vmap"]["forms"]
                       if e["form"] == "dual_sgd_tenants"):
                raise AssertionError("tenants mesh sparse: -b 0.5 without each tenant's draws")
        phase("modelaxis", "tenants mesh sparse: on each rank, every call of B4's, B7's and "
              "B8's tenant forms in the vmap runs held against its plain version on the same "
              "inputs (a short tick, then the mixed tick's two planes; two short ticks under "
              f"-b 0.5 with each tenant's own draws): B4 bitwise, B7 within rtol {RTOL} atol {ATOL} with the same iterations "
              f"run, B8 within rtol {WEIGHT_RTOL}; max abs errors "
              f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} }")
    # each form's reruns bitwise; vmap against scan
    by_form = {form: [nm for nm, fm in zip(names, order) if fm == form]
               for form in ("vmap", "scan")}
    for form, nms in by_form.items():
        for nm in nms[1:] + [f"tm_{form}_prof"]:
            for a, b in zip(arrays[nms[0]], arrays[nm]):
                if not all(np.array_equal(a[k], b[k]) for k in ("w", "counts", "preds")):
                    raise AssertionError(f"tenants mesh sparse: {form} runs {nms[0]} and {nm} "
                                         "differ")
    held = {}
    for label, vmap, scan in (("short", by_form["vmap"][0], by_form["scan"][0]),
                              ("mixed", "tm_mixed_vmap", "tm_mixed_scan"),
                              ("sampled", "tm_sampled_vmap", "tm_sampled_scan"),
                              ("scatter", "tm_scatter_vmap", "tm_scatter_scan")):
        w_err, flips = mesh_vmap_hold(f"2^18 {label}", recs, arrays, vmap, scan)
        held[label] = {"weights_max_err": w_err, "flips": flips}
    out["held"] = held
    # collectives and launches a tick
    ticks, m, n = TM_TICKS + 1, SV_M, OP_ITERS
    want_coll = {("gram", "vmap"): (2, 3), ("gram", "scan"): (2 * m, 3 * m),
                 ("scatter", "vmap"): (0, n + 2), ("scatter", "scan"): (0, m * (n + 2))}
    for spec in runs:
        route = "scatter" if "scatter" in spec["name"] else "gram"
        want = want_coll[(route, spec["mapping"])]
        for rank, r in enumerate(recs):
            got = [(t["row_allgathers"], t["allreduces"])
                   for t in r["runs"][spec["name"]]["tick_collectives"]]
            if any(g != want for g in got):
                raise AssertionError(f"tenants mesh sparse {spec['name']} rank {rank}: "
                                     f"(all-gathers, all-reduces) a tick {got}, want {want}")
    vmap_runs = [s["name"] for s in runs if s["mapping"] == "vmap"
                 and "scatter" not in s["name"]]
    launches = {k: sum(r["runs"][nm]["launches"][k] for nm in vmap_runs for r in recs)
                for k in TM_FORMS + TM_SINGLE + ("tenant_gram_products",)}
    if MA_DEVICE == "cuda":
        # a short tick: B4, B7 and B8 once each (one plane); the mixed one B4 twice
        for nm in vmap_runs:
            for rank, r in enumerate(recs):
                got = r["runs"][nm]["launches"]
                k = 2 if nm in ("tm_mixed_vmap", "tm_sampled_vmap") else ticks
                planes = k + (1 if nm == "tm_mixed_vmap" else 0)
                want = {"count_build_tenants": planes, "dual_sgd_tenants": k,
                        "dual_writeback_tenants": k, **dict.fromkeys(TM_SINGLE, 0)}
                if {key: got[key] for key in want} != want:
                    raise AssertionError(f"tenants mesh sparse {nm} rank {rank}: launches "
                                         f"{got}, want {want}")
        for nm in by_form["scan"]:
            for r in recs:
                got = r["runs"][nm]["launches"]
                if any(got[k] for k in TM_FORMS) or any(got[k] != m * ticks for k in TM_SINGLE):
                    raise AssertionError(f"tenants mesh sparse {nm}: launches {got}")
    numbers = {}
    for form, nms in by_form.items():
        rr = [r["runs"][nm] for nm in nms for r in recs]
        timed_ = [(x["step_wall_ms"][1:], x["step_device_ms"][1:],
                   [c.get("row_allgather", 0.0) for c in x["step_collective_ms"][1:]],
                   [c.get("allreduce", 0.0) for c in x["step_collective_ms"][1:]]) for x in rr]
        flat = lambda i: [v for t in timed_ for v in t[i]]  # noqa: E731
        ag, ar = want_coll[("gram", form)]
        numbers[form] = {
            "allgathers_a_tick": ag, "allreduces_a_tick": ar,
            "tick_wall_ms": statistics.median(flat(0)),
            "tick_wall_ms_by_run": [statistics.median(t[0]) for t in timed_],
            "tick_device_ms": statistics.median(flat(1)) if flat(1) else None,
            "allgather_ms_a_tick": statistics.median(flat(2)),
            "allreduce_ms_a_tick": statistics.median(flat(3)),
        }
        numbers[form]["ms_a_collective"] = ((numbers[form]["allgather_ms_a_tick"]
                                             + numbers[form]["allreduce_ms_a_tick"]) / (ag + ar))
        if MA_DEVICE == "cuda":
            numbers[form]["profiled"] = [tm_trace(os.path.join(prof, form, f"rank{r}"), TM_TICKS)
                                         for r in range(MH_RANKS)]
    out.update(forms=numbers, launches=launches, form_errors=errs,
               run_wall_s={s["name"]: recs[0]["runs"][s["name"]]["wall_s"] for s in runs})
    nv, ns = numbers["vmap"], numbers["scan"]
    busy = {k: [round(p["device_busy_ms_a_tick"], 3) for p in v.get("profiled", [])]
            for k, v in numbers.items()}
    largest = {k: {n: round(ms, 3) for n, ms in v["profiled"][0]["largest_ms_a_tick"].items()}
               for k, v in numbers.items() if v.get("profiled")}
    phase("modelaxis", f"tenants mesh sparse: vmap over 2 ranks x {GRAM_ROWS // MH_RANKS} rows at "
          f"2^18, {SV_M} tenants, {TM_TICKS} ticks after a warm-up, {len(order)} runs in turns: "
          f"the stack within {held['short']['weights_max_err']:.3g} of the scan form's (rtol/atol "
          f"{VMAP_RTOL}), counts equal, {held['short']['flips']} HALF_UP flips; mixed planes "
          f"{held['mixed']['weights_max_err']:.3g}, -b 0.5 "
          f"{held['sampled']['weights_max_err']:.3g}, scatter "
          f"{held['scatter']['weights_max_err']:.3g}; collectives a tick "
          f"{nv['allgathers_a_tick']} all-gathers + {nv['allreduces_a_tick']} all-reduces against "
          f"scan's "
          f"{ns['allgathers_a_tick']} + {ns['allreduces_a_tick']} ({nv['allgather_ms_a_tick']:.1f} "
          f"+ {nv['allreduce_ms_a_tick']:.1f} ms against {ns['allgather_ms_a_tick']:.1f} + "
          f"{ns['allreduce_ms_a_tick']:.1f} ms a tick); a rank's host wall a tick "
          f"{nv['tick_wall_ms']:.1f} ms against scan's {ns['tick_wall_ms']:.1f} ms, device busy "
          f"ms a tick by rank {busy} (rank 0's largest: {largest}); launches of the vmap runs "
          f"{launches}; rank 0's wall by run (s) "
          f"{ {k: round(v, 2) for k, v in out['run_wall_s'].items()} }, the group's "
          f"{wall:.1f}; arm wall "
          f"{time.perf_counter() - t0:.1f} s | card: {smi}")
    records = []
    if MA_DEVICE == "cuda":
        records = tm_times(smi, short[1], errs, launches)
        records[0]["arm"] = {"held": held, "forms": numbers}
    out["wall_s"] = time.perf_counter() - t0
    return out, records


def modelaxis_phase(smi, statuses):
    """The modelaxis phase: the layouts over a model axis, every rank on the one
    card over gloo (tests/torch_mesh_worker.py at the library level, the
    apps in a group). (a) The 2D Gram step at BASELINE config #4 (2^18, L2
    0.1, 50 iterations, B = 2048 global) on 2 x 2 and 1 x 2, short tweets
    (the int8 plane) and tweet-length rows of ASCII and CJK words (tokens in
    both slices, MA_SLICE_PLANES), each 3 batches against the port's
    one-process step on the card; B4, the summed G, B7 and B8 at the
    slice's shapes against their twins and one process's G; a small arm at
    F = 1000 (B4 at a 500-column slice). (b) The scatter route on 2 x 2.
    (c) A checkpoint round trip on 2 x 2, bitwise. (d) ``--tenants 4`` on 2
    ranks against one process, tenants on a 1 x 2 model axis bitwise the
    one-process stack, and ``--elastic on --tenants 4`` with the follower
    killed. (e) K-means across 2 ranks, the model and the app, against one
    process. (f) The vmap form over a data axis (``tenants_mesh_arm``). (g)
    Its 2^18 routes (``tenants_mesh_sparse_arm``). Returns the phase's
    numbers, the kernels' launches, the split with a tenant grid's kernels
    line record (``tenant_split_record``) and the tenant forms' records
    over a data axis (``tenants_mesh_sparse_records``)."""
    import shutil
    import tempfile

    import numpy as np

    from twtml_tpu_torch.models.kmeans import StreamingKMeans
    from twtml_tpu_torch.parallel.tenants import TenantStackModel
    from twtml_tpu_torch.streaming.sources import ReplayFileSource

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="twtml-modelaxis-")
    out = {"card": smi}
    gram_kw = dict(num_text_features=GRAM_F, num_iterations=OP_ITERS, step_size=0.005,
                   l2_reg=0.1)
    try:
        short = ma_statuses(MA_SHORT_SPAN, GRAM_ROWS, MA_BATCHES, 17)
        data = {
            "short": ma_unit_batches(os.path.join(workdir, "short.npz"), short, GRAM_ROWS,
                                     GRAM_F, MA_UNITS),
            "long": ma_unit_batches(os.path.join(workdir, "long.npz"),
                                    ma_statuses(MA_LONG_SPAN, GRAM_ROWS, MA_BATCHES, 29,
                                                heads=True),
                                    GRAM_ROWS, GRAM_F, MA_LONG_UNITS),
            "small": ma_unit_batches(os.path.join(workdir, "small.npz"), short, GRAM_ROWS,
                                     MA_SMALL_F, MA_UNITS),
            "scatter": ma_unit_batches(os.path.join(workdir, "scatter.npz"),
                                       short[:MA_SCATTER_BATCHES * MA_SCATTER_ROWS],
                                       MA_SCATTER_ROWS, GRAM_F, MA_UNITS),
        }
        rng = np.random.default_rng(31)
        km_points = (rng.normal(size=(MA_BATCHES, MA_KMEANS_ROWS, 2)) * [1.0, 5.0]).astype(
            np.float32)
        km_mask = (rng.random((MA_BATCHES, MA_KMEANS_ROWS)) < 0.95).astype(np.float32)
        np.savez(os.path.join(workdir, "kmeans.npz"), points=km_points, mask=km_mask)

        # the kernels at the slice's shapes, in this process
        holds = {}
        for name in ("short", "long"):
            errs, planes = ma_kernel_holds(name, data[name][0], GRAM_F)
            if planes != MA_SLICE_PLANES[name]:
                raise AssertionError(f"modelaxis {name}: slice planes {planes}, want "
                                     f"{MA_SLICE_PLANES[name]}")
            holds[name] = {"errors": errs, "slice_planes": planes}
            phase("modelaxis", f"{name}: B4 at two [{GRAM_ROWS}, {GRAM_F // 2}] slices, each "
                  f"holding tokens (planes {planes}), bitwise its twin; G summed from the 2 x 2 "
                  f"and 1 x 2 ranks' panels bitwise one process's; B7 on it "
                  f"{errs['dual_sgd']:.3g}, B8 at each [{GRAM_ROWS // 2}, {GRAM_F // 2}] slice "
                  f"{errs['dual_writeback_counts']:.3g} against their twins")
        errs, planes = ma_kernel_holds("small", data["small"][0], MA_SMALL_F)
        holds["small"] = {"errors": errs, "slice_planes": planes}
        phase("modelaxis", f"small: B4 at two [{GRAM_ROWS}, {MA_SMALL_F // 2}] slices "
              f"(planes {planes}) bitwise its twin, G summed bitwise one process's")
        out["kernel_holds"] = holds

        runs4 = [
            {"mode": "sgd", "name": "short", "batches": os.path.join(workdir, "short.npz"),
             "wire": "unit", "model": gram_kw},
            {"mode": "sgd", "name": "long", "batches": os.path.join(workdir, "long.npz"),
             "wire": "unit", "model": gram_kw},
            {"mode": "sgd", "name": "small", "batches": os.path.join(workdir, "small.npz"),
             "wire": "unit", "model": dict(gram_kw, num_text_features=MA_SMALL_F),
             "checkpoint": os.path.join(workdir, "ck")},
            {"mode": "sgd", "name": "scatter", "batches": os.path.join(workdir, "scatter.npz"),
             "wire": "unit", "model": dict(gram_kw, num_iterations=MA_SCATTER_ITERS,
                                            use_gram=False)},
            {"mode": "kmeans", "name": "kmeans", "batches": os.path.join(workdir,
                                                                           "kmeans.npz")},
        ]
        recs4, arr4, wall4 = ma_group("2x2", workdir, 4, {"num_data": 2, "num_model": 2,
                                                          "runs": runs4})
        runs2 = [runs4[0], runs4[1],
                 {"mode": "tenants", "name": "tenants", "num_tenants": MA_TENANTS,
                  "batches": os.path.join(workdir, "small.npz"), "wire": "unit",
                  "model": dict(num_text_features=MA_SMALL_F, step_size=0.005)}]
        recs2, arr2, wall2 = ma_group("1x2", workdir, 2, {"num_data": 1, "num_model": 2,
                                                          "runs": runs2})
        out["group_wall_s"] = {"2x2": wall4, "1x2": wall2}

        # (a) the Gram route against one process, (b) the scatter route
        out["gram"] = {}
        for name in ("short", "long"):
            want = ma_single(data[name], **gram_kw)
            for layout, recs, arrs in (("2x2", recs4, arr4), ("1x2", recs2, arr2)):
                rr = [dict(r["runs"][name], data_index=r["data_index"]) for r in recs]
                if any(r["route"] != "gram" for r in rr):
                    raise AssertionError(f"modelaxis {name} {layout}: routes "
                                         f"{[r['route'] for r in rr]}")
                for r in rr if MA_DEVICE == "cuda" else ():  # the CPU twins count none
                    got = {k: r["launches"][k] for k in
                           ("count_build", "dual_sgd", "dual_writeback_counts")}
                    if got != dict.fromkeys(got, MA_BATCHES):
                        raise AssertionError(f"modelaxis {name} {layout}: launches {got}, "
                                             f"want {MA_BATCHES} each")
                err, flips = ma_hold_run(name, layout, rr, arrs[name], want)
                out["gram"][f"{name}_{layout}"] = {
                    "weights_max_err": err, "flips": flips,
                    "ranks": ma_rank_numbers(name, layout, recs, name)}
                phase("modelaxis", f"{name} {layout}: {MA_BATCHES} steps held against one "
                      f"process on the card: weights within {err:.3g} (rtol 1e-4), "
                      f"predictions within {MA_PRED_ATOL} with {flips} HALF_UP flips")
        want = ma_single(data["small"], **dict(gram_kw, num_text_features=MA_SMALL_F),
                         use_sparse=True)
        rr = [dict(r["runs"]["small"], data_index=r["data_index"]) for r in recs4]
        err, flips = ma_hold_run("small", "2x2", rr, arr4["small"], want)
        out["gram"]["small_2x2"] = {"weights_max_err": err, "flips": flips}
        phase("modelaxis", f"small (F = {MA_SMALL_F}) 2x2: weights within {err:.3g} of one "
              f"process's Gram route, {flips} flips")
        want = ma_single(data["scatter"], **dict(gram_kw, num_iterations=MA_SCATTER_ITERS),
                         use_gram=False)
        rr = [dict(r["runs"]["scatter"], data_index=r["data_index"]) for r in recs4]
        if any(r["route"] != "scatter" or r["launches"]["count_build"] for r in rr):
            raise AssertionError(f"modelaxis scatter: {[(r['route'], r['launches']) for r in rr]}")
        err, flips = ma_hold_run("scatter", "2x2", rr, arr4["scatter"], want)
        for r in rr:
            c = r["collectives"]
            n = MA_SCATTER_ITERS * MA_SCATTER_BATCHES
            if (c["model_allreduces"] != 2 * n + MA_SCATTER_BATCHES
                    or c["data_allreduces"] != n + MA_SCATTER_BATCHES):
                raise AssertionError(f"modelaxis scatter: collectives {c}")
        out["scatter"] = {"weights_max_err": err, "flips": flips,
                          "ranks": ma_rank_numbers("scatter", "2x2", recs4, "scatter")}
        phase("modelaxis", f"scatter 2x2 ({MA_SCATTER_BATCHES} x {MA_SCATTER_ROWS} rows, "
              f"{MA_SCATTER_ITERS} iterations): weights within {err:.3g} of one process's "
              f"scatter loop, 3 collectives an iteration (margins and norms over model, "
              f"the gradient over data)")
        # (c) the checkpoint round trip (on the small arm's Gram route)
        for rank, arr in enumerate(arr4["small"]):
            if not np.array_equal(arr["resumed"], arr["uninterrupted"]):
                raise AssertionError(f"modelaxis checkpoint: rank {rank} resumed "
                                     "differently from the uninterrupted model")
        phase("modelaxis", "checkpoint 2x2: gathered, saved by the lead, restored into fresh "
              "models; the next step bitwise the uninterrupted run's on every rank")

        # (d) tenants on a 1 x 2 model axis, bitwise the one-process stack
        stack = TenantStackModel(MA_TENANTS, num_text_features=MA_SMALL_F, step_size=0.005,
                                 device=MA_DEVICE)
        for b in data["small"]:
            stack.step(b)
        for rank, arr in enumerate(arr2["tenants"]):
            if not np.array_equal(arr["w"], stack.latest_weights):
                raise AssertionError(f"modelaxis tenants 1x2: rank {rank}'s stack differs from "
                                     "one process's by "
                                     f"{float(np.max(np.abs(arr['w'] - stack.latest_weights))):.3g}")
            c = recs2[rank]["runs"]["tenants"]["collectives"]
            if c["model_allreduces"] or c["data_allreduces"] or c["allreduces"]:
                raise AssertionError(f"modelaxis tenants 1x2: collectives {c}")
        phase("modelaxis", f"tenants on a 1x2 model axis ({MA_TENANTS // 2} a rank): the "
              f"gathered [{MA_TENANTS}, {MA_SMALL_F + 4}] stack bitwise one process's, no "
              "collective inside a tick")
        # (e) the k-means model over 2 data shards against one process
        km = (StreamingKMeans(device=MA_DEVICE).set_k(3).set_half_life(5, "batches")
              .set_random_centers(2, 0.0))
        km_assign = [km.update(p, m) for p, m in zip(km_points, km_mask)]
        for rank, arr in enumerate(arr4["kmeans"]):
            d = recs4[rank]["data_index"]
            rows = MA_KMEANS_ROWS // 2
            for k, a in enumerate(km_assign):
                if not np.array_equal(arr["assign"][k], a[d * rows:(d + 1) * rows]):
                    raise AssertionError(f"modelaxis kmeans: rank {rank} batch {k} assignments "
                                         "differ from one process's")
            if not (np.allclose(arr["centers"], km.latest_centers, rtol=KMEANS_RTOL, atol=1e-7)
                    and np.allclose(arr["weights"], km.latest_weights, rtol=KMEANS_RTOL)):
                raise AssertionError(f"modelaxis kmeans: rank {rank} centers {arr['centers']} "
                                     f"against {km.latest_centers}")
        phase("modelaxis", f"k-means over 2 data shards ({MA_BATCHES} x {MA_KMEANS_ROWS} "
              "points): assignments equal, centers and weights within 1e-5 of one process's")
        # (f) the vmap form over a data axis (ROADMAP B10 b)
        out["tenants_mesh"], out["tenant_split_record"] = tenants_mesh_arm(smi, statuses,
                                                                           workdir)
        # (g) the vmap form on the 2^18 routes over a data axis (ROADMAP B10 d)
        out["tenants_mesh_sparse"], out["tenants_mesh_sparse_records"] = (
            tenants_mesh_sparse_arm(smi, workdir))

        # the apps in a group, on the multihost phase's replay
        path = os.path.join(workdir, "tweets.jsonl")
        write_replay(path, statuses[:MH_BATCHES * OP_ROWS])
        recs_t, totals_t, err_t, _d, _a = mh_arm("tenants", path, workdir, MH_ROWS,
                                                 ["--tenants", str(MA_TENANTS)],
                                                 label="modelaxis")
        steps = MH_BATCHES + 1  # and the warm-up's
        for rank, rec in enumerate(recs_t):
            want = {e: MA_TENANTS * k * steps for e, k in split_launches_a_step().items()}
            got = {e: rec["launches"][e] for e in SPLIT_ENTRIES}
            if MA_DEVICE != "cuda":
                got = want  # the CPU twins count no launch
            if (got != want or rec["launches"]["fused_dense_sgd"]
                    or rec["counters"]["fetch.count"] != rec["batches"]):
                raise AssertionError(f"modelaxis tenants app rank {rank}: launches "
                                     f"{rec['launches']}, fetches {rec['counters']['fetch.count']}"
                                     f" for {rec['batches']} ticks")
        out["tenant_fleet"] = {"weights_max_err": err_t,
                               "launches": {e: sum(r["launches"][e] for r in recs_t)
                                            for e in SPLIT_ENTRIES},
                               "ranks": mh_rank_numbers("tenants", recs_t, totals_t, steps,
                                                        label="modelaxis")}
        phase("modelaxis", f"--tenants {MA_TENANTS} on 2 ranks: lines and the [{MA_TENANTS}, "
              f"1004] stack within {err_t:.3g} of one process's, one fetch a tick, the split "
              f"{MA_TENANTS} x ({OP_ITERS} + 1) launches a step")
        # --elastic on: a killed follower, the survivor's stack from its archive
        kill1 = f"peer.kill:uid=1:tick={EL_KILL_TICK}"
        d_k = os.path.join(workdir, "tenants-kill1")
        argv = [*MH_ARGV, "--replayFile", path, "--batchBucket", str(MH_ROWS), "--elastic", "on",
                "--tenants", str(MA_TENANTS), "--checkpointEvery", "1", "--checkpointDir", d_k]
        res = el_group(workdir, "tenants-kill1", argv, extra=((), ("--chaos", kill1)))
        el_survived("tenants-kill1", res, (0, 77))
        count, batches, crc, _rolled, _replayed = el_resync("tenants-kill1", res[0][3])
        from twtml_tpu_torch.checkpoint import Checkpointer

        state, _meta = Checkpointer(d_k).restore(step=batches)
        final, meta = Checkpointer(d_k).restore()
        rows = list(ReplayFileSource(path).produce())[0::2][batches * MH_ROWS:]
        fleet_w, stack_w = ma_tenant_clean_run(state, rows)
        if not (np.array_equal(np.asarray(final), fleet_w) and np.array_equal(fleet_w, stack_w)):
            raise AssertionError(
                f"modelaxis tenants-kill1: the survivor's stack differs from the clean run "
                f"by {float(np.max(np.abs(np.asarray(final) - fleet_w))):.3g}, the world-1 "
                f"fleet from the stack by {float(np.max(np.abs(fleet_w - stack_w))):.3g}")
        out["tenant_fleet"]["kill1"] = {"resync_count": count, "resync_batches": batches,
                                        "final_count": int(meta["count"]), "wall_s": res[0][4]}
        phase("modelaxis", f"--elastic on --tenants {MA_TENANTS}, uid 1 killed at tick "
              f"{EL_KILL_TICK}: the survivor resynced to step {batches} (count {count}, crc "
              f"{crc}); its final stack (count {int(meta['count'])}) bitwise the world-1 "
              "fleet's and the plain stack's from that archive on the card")
        el_reap_store_hosts(workdir)
        # (e) the k-means app on 2 ranks against one process
        km_argv = [*MH_ARGV[:2], "--source", "replay", "--replayFile", path, "--seconds", "0"]
        t0 = time.perf_counter()
        totals_k, lines_k, rec_k = kmeans_run(MA_DEVICE, None, argv=[*km_argv[2:], "--batchBucket",
                                                                    str(OP_ROWS)])
        single_wall = time.perf_counter() - t0
        port, procs, t0 = free_port(), [], time.perf_counter()
        env = dict(os.environ)
        env.pop("TWTML_SYNC_DEBUG", None)
        for rank in range(MH_RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", MA_KMEANS_RANK, PACKAGE_ROOT, *km_argv, "--batchBucket",
                 str(MH_ROWS), "--lightning", RECORDER.url, "--twtweb", RECORDER.url,
                 "--master", f"twtml://127.0.0.1:{port}", "--numProcesses", str(MH_RANKS),
                 "--processId", str(rank)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env))
        km_out = []
        try:
            for rank, p in enumerate(procs):
                stdout, stderr = p.communicate(timeout=MA_TIMEOUT_S)
                lines = stdout.splitlines()
                if p.returncode != 0 or not lines or not lines[-1].startswith("{"):
                    raise AssertionError(f"modelaxis kmeans app: rank {rank} exited "
                                         f"{p.returncode}:\n{stderr[-4000:]}")
                km_out.append(([ln for ln in lines if ln.startswith("count:")],
                               json.loads(lines[-1])))
        finally:
            for p in procs:
                p.kill()
                p.wait()
        group_wall = time.perf_counter() - t0
        single_lines = [ln for ln in lines_k if ln.startswith("count:")]
        if km_out[1][0] or km_out[0][0] != single_lines:
            raise AssertionError(f"modelaxis kmeans app: lead {km_out[0][0][:2]} against "
                                 f"{single_lines[:2]}, follower {km_out[1][0][:2]}")
        replay = list(ReplayFileSource(path).produce())
        for k, a in enumerate(rec_k["assign"]):
            batch = replay[k * OP_ROWS:(k + 1) * OP_ROWS]
            rt = np.array([s.is_retweet for s in batch])
            pos = np.cumsum(rt) - 1
            for rank in range(MH_RANKS):
                mine = pos[rank::MH_RANKS][rt[rank::MH_RANKS]]
                got = np.asarray(km_out[rank][1]["assign"][k][:len(mine)])
                if not np.array_equal(got, a[mine]):
                    raise AssertionError(f"modelaxis kmeans app: rank {rank} batch {k} "
                                         "assignments differ from one process's")
        model = rec_k["model"]
        for rank, (_l, rec) in enumerate(km_out):
            if not (np.allclose(rec["centers"], model.latest_centers, rtol=KMEANS_RTOL,
                                atol=1e-7)
                    and np.allclose(rec["weights"], model.latest_weights, rtol=KMEANS_RTOL)):
                raise AssertionError(f"modelaxis kmeans app: rank {rank} centers "
                                     f"{rec['centers']} against {model.latest_centers}")
        out["kmeans_app"] = {"lines": len(single_lines), "group_wall_s": group_wall,
                             "rank_wall_s": [rec["wall_s"] for _l, rec in km_out],
                             "single_wall_s": single_wall,
                             "collectives": [rec["collectives"] for _l, rec in km_out]}
        phase("modelaxis", f"k-means app on 2 ranks: {len(single_lines)} lines equal to one "
              "process's (counts, batches, centers, sizes), assignments equal, centers within "
              f"1e-5; the group's wall {group_wall:.1f} s (ranks' runs "
              f"{[round(rec['wall_s'], 2) for _l, rec in km_out]} s), one process's run "
              f"{single_wall:.2f} s")
        gram = {k: sum(r["runs"][run]["launches"][k] for recs, runs in
                       ((recs4, ("short", "long", "small")), (recs2, ("short", "long")))
                       for r in recs for run in runs)
                for k in ("count_build", "dual_sgd", "dual_writeback_counts")}
        split = {e: out["tenant_fleet"]["launches"][e]
                 + sum(r["runs"]["tenants"]["launches"][e] for r in recs2)
                 for e in SPLIT_ENTRIES}
        out["launches"] = dict(gram, **split)
        out["wall_s"] = time.perf_counter() - t_phase
        phase("modelaxis", f"launches {out['launches']}; phase wall {out['wall_s']:.1f} s | "
              f"card: {smi}")
        return out
    finally:
        el_reap_store_hosts(workdir)
        shutil.rmtree(workdir, ignore_errors=True)


EL_AB_BATCHES = 8  # a run's global batches in ``--elastic-ab``


def elastic_ab(smi, pairs):
    """``--elastic-ab N``: the healthy elastic tick against lockstep alone,
    in N pairs of group runs of the same flags, environment and checkpoint
    settings, the order alternating (lockstep first in even pairs, elastic
    first in odd ones), each on EL_AB_BATCHES x 16384 synthetic tweets
    (8192 rows a rank): per run and rank the host wall a tick split into
    the all-reduces, the cadence all-gather and the rest
    (``el_tick_split``), then the medians by arm. The counted collectives
    and fetches are held equal in every pair."""
    import shutil
    import tempfile

    from twtml_tpu_torch.streaming.sources import SyntheticSource

    workdir = tempfile.mkdtemp(prefix="twtml-elastic-ab-")
    runs = {"lockstep": [], "elastic": []}
    ratios = []  # elastic over lockstep host wall a tick, a pair and rank
    try:
        path = os.path.join(workdir, "tweets.jsonl")
        write_replay(path, SyntheticSource(total=EL_AB_BATCHES * OP_ROWS, seed=5,
                                           base_ms=NOW_MS).produce())
        off = [*MH_ARGV, "--replayFile", path, "--batchBucket", str(MH_ROWS)]
        for i in range(pairs):
            order = ("lockstep", "elastic") if i % 2 == 0 else ("elastic", "lockstep")
            recs = {}
            for arm in order:
                ck = ["--checkpointDir", os.path.join(workdir, f"{arm}-{i}")]
                if arm == "elastic":
                    res = el_group(workdir, f"ab-{i}", [*off, "--elastic", "on", *ck])
                    el_survived(f"ab-{i}", res)
                else:
                    res = mh_ok(f"elastic-ab lockstep {i}",
                                mh_group(f"ab-{i}", [*off, *ck], env=EL_ENV))
                recs[arm] = [r[2] for r in res]
                for rank, rec in enumerate(recs[arm]):
                    t = dict(el_tick_split(rec), pair=i, rank=rank, position=order.index(arm),
                             tweets_per_s=rec["count"] / rec["stream_seconds"])
                    runs[arm].append(t)
                    phase("elastic-ab", f"pair {i} {arm} (run {order.index(arm) + 1} of 2) "
                          f"rank {rank}: a tick {el_tick_text(t)}, "
                          f"{t['tweets_per_s']:.0f} tweets/s")
            for rank in range(MH_RANKS):
                e, lk = recs["elastic"][rank], recs["lockstep"][rank]
                if ({k: e["collectives"][k] for k in lk["collectives"]} != lk["collectives"]
                        or e["counters"]["fetch.count"] != lk["counters"]["fetch.count"]):
                    raise AssertionError(f"elastic-ab pair {i} rank {rank}: {e} against {lk}")
                ratios.append(runs["elastic"][-MH_RANKS + rank]["host_wall"]
                              / runs["lockstep"][-MH_RANKS + rank]["host_wall"])
            phase("elastic-ab", f"pair {i}: elastic over lockstep, a tick's host wall "
                  f"{[round(r, 4) for r in ratios[-MH_RANKS:]]} (ranks 0, 1)")
        summary = {}
        for arm, rows in runs.items():
            summary[arm] = {k: statistics.median(r[k] for r in rows)
                            for k in ("host_wall", "allreduces", "allgather", "rest",
                                      "tweets_per_s")}
        ratio = summary["elastic"]["host_wall"] / summary["lockstep"]["host_wall"]
        pair_ratio = statistics.median(ratios)
        phase("elastic-ab", f"medians over {pairs} pairs x {MH_RANKS} ranks: elastic a tick "
              f"{el_tick_text(summary['elastic'])} against lockstep "
              f"{el_tick_text(summary['lockstep'])}: {ratio:.4f}x; the pairs' ratios "
              f"{min(ratios):.4f}-{max(ratios):.4f}, median {pair_ratio:.4f} | card: {smi}")
        print(json.dumps({"elastic_ab": {"pairs": pairs, "batches": EL_AB_BATCHES,
                                         "runs": runs, "medians": summary,
                                         "host_wall_ratio": ratio, "pair_ratios": ratios,
                                         "pair_ratio_median": pair_ratio, "card": smi}}),
              flush=True)
    finally:
        el_reap_store_hosts(workdir)
        shutil.rmtree(workdir, ignore_errors=True)


def gram_ab(smi, pairs, parent_root):
    """``--gram-ab N --package-root DIR``: the app's data-parallel 2^18 Gram
    route on 2 ranks (the multihost phase's gram arm: BASELINE config #4, B
    = 2048, 1024 rows a rank, MH_BATCHES batches of short synthetic tweets)
    with the port found in DIR (another checkout, e.g. the parent commit
    unpacked there) against this checkout's, in N pairs, the order
    alternating. Per run and rank: the step's device ms (median), the host
    wall a tick, the row all-gathers and all-reduces a step and their ms,
    tweets/s. The lead's lines are held equal between the two trees."""
    import shutil
    import tempfile

    from twtml_tpu_torch.streaming.sources import SyntheticSource

    global PACKAGE_ROOT
    roots = {"parent": parent_root, "change": HERE}
    workdir = tempfile.mkdtemp(prefix="twtml-gram-ab-")
    runs = {"parent": [], "change": []}
    try:
        path = os.path.join(workdir, "gram.jsonl")
        write_replay(path, SyntheticSource(total=MH_BATCHES * GRAM_ROWS, seed=5,
                                           base_ms=NOW_MS).produce())
        argv = [*MH_ARGV, "--replayFile", path, "--batchBucket", str(GRAM_ROWS // MH_RANKS),
                *MH_GRAM_ARGV]
        for i in range(pairs):
            order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
            lines = {}
            for arm in order:
                PACKAGE_ROOT = roots[arm]
                res = mh_ok(f"gram-ab {arm} {i}", mh_group(f"gram-ab-{i}", argv))
                lines[arm] = res[0][1]
                for rank, (_rc, _l, rec, _err, _wall) in enumerate(res):
                    c, sec = rec["collectives"], rec["seconds"]
                    steps = MH_BATCHES + 1  # and the warm-up's
                    ticks = max(1, c["cadence_allgathers"])
                    row = {"pair": i, "rank": rank, "position": order.index(arm),
                           "step_device_ms": statistics.median(rec["step_ms"]),
                           "host_wall_a_tick_ms": 1e3 * rec["stream_seconds"] / ticks,
                           "row_allgathers_a_step": c.get("row_allgathers", 0) / steps,
                           # a tree that does not time its row all-gathers: None
                           "row_allgather_ms_a_step": (1e3 * sec["row_allgather"] / steps
                                                       if "row_allgather" in sec else None),
                           "allreduces_a_step": c["allreduces"] / steps,
                           "allreduce_ms_a_step": 1e3 * sec["allreduce"] / steps,
                           "tweets_per_s": rec["count"] / rec["stream_seconds"]}
                    runs[arm].append(row)
                    phase("gram-ab", f"pair {i} {arm} (run {order.index(arm) + 1} of 2) rank "
                          f"{rank}: step {row['step_device_ms']:.2f} ms (CUDA events), host "
                          f"wall a tick {row['host_wall_a_tick_ms']:.1f} ms; a step "
                          f"{row['row_allgathers_a_step']:.0f} row all-gathers in "
                          f"{row['row_allgather_ms_a_step'] or 'untimed'} ms, "
                          f"{row['allreduces_a_step']:.0f} all-reduces in "
                          f"{row['allreduce_ms_a_step']:.2f} ms; "
                          f"{row['tweets_per_s']:.0f} tweets/s")
            if lines["parent"] != lines["change"] or not lines["change"]:
                raise AssertionError(f"gram-ab pair {i}: the lead's lines differ between the "
                                     f"trees: {lines['parent'][:2]} against "
                                     f"{lines['change'][:2]}")
        keys = ("step_device_ms", "host_wall_a_tick_ms", "row_allgather_ms_a_step",
                "allreduce_ms_a_step", "tweets_per_s")
        medians = {arm: {k: statistics.median([r[k] for r in rows if r[k] is not None]
                                              or [float("nan")]) for k in keys}
                   for arm, rows in runs.items()}
        # a run's host wall a tick: the mean over its ranks; a pair is won by
        # the arm whose run took less
        walls = {arm: [statistics.mean(r["host_wall_a_tick_ms"] for r in rows if r["pair"] == i)
                       for i in range(pairs)] for arm, rows in runs.items()}
        wins = sum(c < p for c, p in zip(walls["change"], walls["parent"]))
        q = statistics.quantiles(walls["parent"], n=4) if pairs > 1 else [0.0, 0.0, 0.0]
        phase("gram-ab", f"medians over {pairs} pairs x {MH_RANKS} ranks: change "
              f"{medians['change']} against parent {medians['parent']}; the change's run "
              f"took less host wall a tick in {wins} of {pairs} pairs; the parent's runs' "
              f"quartiles {q[0]:.1f}-{q[2]:.1f} ms; the lead's lines equal in every pair | "
              f"card: {smi}")
        print(json.dumps({"gram_ab": {"pairs": pairs, "runs": runs, "medians": medians,
                                      "run_walls": walls, "change_wins": wins,
                                      "parent_quartiles": q, "card": smi}}), flush=True)
    finally:
        PACKAGE_ROOT = HERE
        shutil.rmtree(workdir, ignore_errors=True)


def times_only(smi):
    """``--times-only``: the kernels' device times alone (B1's training
    kernel in its logistic mode, its predict-only mode, B4 in both planes,
    the G product, B7 and B8), no app phase; with ``--package-root DIR`` on
    the port found in DIR (another checkout, e.g. a parent commit unpacked
    there), so that two versions are timed in one call, in turns. It calls
    only the kernels' wrappers and C entries, and reads of B7 only what
    every tree exposes: no barrier count or probe."""
    from collections import defaultdict

    out = {"package_root": PACKAGE_ROOT, "logistic": logistic_times(smi, 0.0, 0)}
    out["predict"] = predict_mode_times(smi, 0)
    out["gram"] = gram_times(smi, defaultdict(float), defaultdict(int), structure=False)
    print(json.dumps({"times_only": out}), flush=True)


def main() -> None:
    global RECORDER, PACKAGE_ROOT
    t_start = time.perf_counter()
    argv = sys.argv[1:]
    if "--package-root" in argv:
        PACKAGE_ROOT = os.path.abspath(argv[argv.index("--package-root") + 1])
    smi = device_phase()
    build_phase()
    if "--times-only" in argv:
        times_only(smi)
        return
    if "--modelaxis-only" in argv:
        from twtml_tpu_torch.streaming.sources import SyntheticSource

        os.environ["TWTML_NOW_MS"] = str(NOW_MS)
        RECORDER = Recorder()
        try:
            statuses = list(SyntheticSource(total=MH_BATCHES * OP_ROWS, seed=5,
                                            base_ms=NOW_MS).produce())
            print(json.dumps({"modelaxis": modelaxis_phase(smi, statuses)}), flush=True)
        finally:
            RECORDER.close()
        return
    if "--tenants-mesh-only" in argv:
        import shutil
        import tempfile

        from twtml_tpu_torch.streaming.sources import SyntheticSource

        os.environ["TWTML_NOW_MS"] = str(NOW_MS)
        workdir = tempfile.mkdtemp(prefix="twtml-tenants-mesh-")
        try:
            statuses = list(SyntheticSource(total=(TS_TICKS + 1) * OP_ROWS, seed=5,
                                            base_ms=NOW_MS).produce())
            summary, ts_record = tenants_mesh_arm(smi, statuses, workdir, pairs=3)
            print(json.dumps({"tenants_mesh": summary, "kernel": ts_record}), flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        return
    if "--tenants-mesh-sparse-only" in argv:
        import shutil
        import tempfile

        workdir = tempfile.mkdtemp(prefix="twtml-tenants-mesh-sparse-")
        try:
            summary, tm_records = tenants_mesh_sparse_arm(smi, workdir)
            print(json.dumps({"tenants_mesh_sparse": summary, "kernels": tm_records}), flush=True)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        return
    if "--tenants-vmap-only" in argv:
        from twtml_tpu_torch.streaming.sources import SyntheticSource

        os.environ["TWTML_NOW_MS"] = str(NOW_MS)
        RECORDER = Recorder()
        try:
            statuses = list(SyntheticSource(total=TENANT_BATCHES * OP_ROWS, seed=5,
                                            base_ms=NOW_MS).produce())
            from twtml_tpu_torch.apps import logistic_regression

            argv_t = [*TENANT_ARGV, "--tenants", str(TENANT_M)]
            rec = tenant_app_run(argv_t, statuses)[2]
            lg_argv = [*TENANT_ARGV, "--tenants", "2"]
            lg = tenant_app_run(lg_argv, two_class_statuses(TENANT_BATCHES * OP_ROWS, 13),
                                app_module=logistic_regression)[2]
            summary, grid_record = tenant_vmap_phase(argv_t, rec, smi, lg_argv, lg)
            print(json.dumps({"tenants_vmap": summary, "kernel": grid_record}), flush=True)
        finally:
            RECORDER.close()
        return
    if "--tenants-sparse-only" in argv:
        summary, sv_records = tenants_sparse_arm(smi)
        print(json.dumps({"tenants_sparse": summary, "kernels": sv_records}), flush=True)
        return
    if "--gram-ab" in argv:
        os.environ["TWTML_NOW_MS"] = str(NOW_MS)
        RECORDER = Recorder()
        try:
            gram_ab(smi, int(argv[argv.index("--gram-ab") + 1]), PACKAGE_ROOT)
        finally:
            RECORDER.close()
        return
    if "--split-ab" in argv:
        split_ab(smi, int(argv[argv.index("--split-ab") + 1]), PACKAGE_ROOT)
        return
    if "--grid-ab" in argv:
        grid_ab(smi, int(argv[argv.index("--grid-ab") + 1]), PACKAGE_ROOT)
        return
    if "--tsplit-ab" in argv:
        tsplit_ab(smi, int(argv[argv.index("--tsplit-ab") + 1]), PACKAGE_ROOT)
        return
    if "--dual-ab" in argv:
        dual_ab(smi, int(argv[argv.index("--dual-ab") + 1]), PACKAGE_ROOT)
        return
    if "--wb-ab" in argv:
        wb_ab(smi, int(argv[argv.index("--wb-ab") + 1]), PACKAGE_ROOT)
        return
    if "--bench-only" in argv:
        bench_only(smi)
        print_ok()
        return
    if "--elastic-ab" in argv:
        os.environ["TWTML_NOW_MS"] = str(NOW_MS)
        RECORDER = Recorder()
        try:
            elastic_ab(smi, int(argv[argv.index("--elastic-ab") + 1]))
        finally:
            RECORDER.close()
        return
    max_errs, kernel_cases = kernel_phase()
    gram_errs, gram_cases = gram_kernel_phase()
    # pins the featurizer's clock and the synthetic tweets' creation times:
    # the wires and backends compared below featurize identical tweets
    os.environ["TWTML_NOW_MS"] = str(NOW_MS)
    RECORDER = Recorder()
    try:
        launches, ragged_rec = main_path_phase()
        padded_rec = padded_phase(ragged_rec)
        replay_phase()
        stream = stream_phase()
        bench_rec = bench_phase()
        guards = guards_phase(smi)
        sampled = sampled_phase(smi)
        dtypes = dtype_phase(smi)
        clock_launches = clock_phase()
        web_statuses = stream.pop("statuses")
        web = web_phase(web_statuses, stream["publish_ms"])
        live = live_phase()
        hosthash = hosthash_phase(padded_rec)
        logistic = logistic_phase(smi)
        superbatch = superbatch_phase(web_statuses, smi)
        block_pool = superbatch.pop("pool")
        kmeans = kmeans_phase(smi)
        sparse = sparse_phase(smi)
    finally:
        RECORDER.close()
    record = times_phase(smi, max_errs[0], launches)
    record["cases"] = [name for name in kernel_cases if not name.startswith("logistic")]
    logistic_record = logistic_times(smi, max_errs[1], logistic.pop("launches"))
    logistic_record.update(cases=[n for n in kernel_cases if n.startswith("logistic")],
                           app=logistic)
    record.update(launches_stream=stream["launches"], launches_bench=bench_rec["launches"],
                  bench=bench_rec, launches_clock=clock_launches,
                  stream_tweets_per_s=stream["rate"],
                  guards_tweets_per_s=guards["rates"],
                  sampled_route=sampled, bfloat16_route=dtypes,
                  stream_device_idle=(stream["timeline"] or {}).get("idle"),
                  launches_hosthash=hosthash["launches"], web=web, live=live,
                  hosthash_featurize_ms=hosthash["host_featurize_ms"],
                  superbatch=superbatch, kmeans=kmeans)
    gram_records = gram_times(smi, gram_errs, sparse.pop("launches"))
    for r in gram_records:
        r["cases"] = [c for c in gram_cases if c.startswith(r["name"])]
    gram_records[0]["sparse_phase"] = sparse
    sparse_vmap, sv_records = tenants_sparse_arm(smi)
    serve = serve_phase(smi, ragged_rec["weights"], web_statuses)
    predict_record = serve.pop("predict_kernel")
    record["serve"] = serve
    RECORDER = Recorder()  # the tenant and block phases' app runs publish to it
    try:
        tenants = tenants_phase(web_statuses, smi)
        abtest = abtest_phase(smi, web_statuses)
        block = block_phase(block_pool, smi)
    finally:
        RECORDER.close()
    RECORDER = Recorder()  # the multihost, elastic and modelaxis phases' app runs publish to it
    try:
        split_records, multihost, lockstep = multihost_phase(smi, web_statuses)
        elastic = elastic_phase(smi, web_statuses, lockstep)
        modelaxis = modelaxis_phase(smi, web_statuses)
    finally:
        RECORDER.close()
    for r in split_records:
        r["launches_elastic"] = elastic["launches"][r["name"]]
    for r in [*split_records, *gram_records]:
        r["launches_modelaxis"] = modelaxis["launches"][r["name"]]
    grid_record = tenants.pop("grid_record")
    sv_records[0]["tenants_sparse"] = sparse_vmap
    record.update(tenants=tenants, launches_tenants=tenants["launches"], block=block,
                  launches_block=block["launches"], multihost=multihost, elastic=elastic,
                  modelaxis=modelaxis)
    predict_record.update(abtest=abtest, launches_abtest=abtest["counts_ab"]["predict_launches"])
    tenant_split_record = modelaxis.pop("tenant_split_record")
    tm_records = modelaxis.pop("tenants_mesh_sparse_records")
    phase("done", f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [record, logistic_record, predict_record, *gram_records,
                                  *split_records, grid_record, tenant_split_record,
                                  *sv_records, *tm_records]}),
          flush=True)
    print_ok()


def print_ok() -> None:
    """The last line: the run passed, on this card."""
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
