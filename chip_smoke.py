#!/usr/bin/env python3
"""Smoke run of photon_tpu_torch's serving and training paths on one
NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs
one CUDA device and ``nvcc``; without a GPU, or without the package
beside it, it exits non-zero and prints no result.

It builds the repo's serving model at full width with numpy from a
fixed seed (logistic GLMix: fixed effect ``global`` d = 64; ``per-user``
100,000 entities x 17 slots; ``per-movie`` 20,000 x 9), writes it with
the port's ``save_checkpoint``, then runs these phases, each printing
JSON lines:

1. device  - ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build   - compiles the CUDA kernels from ``photon_tpu_torch/csrc``;
2a. graph_loops - the loop designs measured (``phase_graph_loops``): a
             toy device loop captured as one WHILE node and unrolled
             into 100 and 2,500 IF nodes (``csrc/graph_loop.cu``):
             capture and instantiate seconds, nodes, replay ms, each
             equal to the eager loop;
2b. program_contracts - the program tier (``python -m
             photon_tpu_torch.analysis --semantic``) on the card
             (``phase_program_contracts``): the fused-fit, newton-kernel,
             segment-reduce-kernel, serve-kernel and serving contracts
             built on CUDA tensors, each program a real CUDA-graph
             capture or a kernel wrapper's dispatch under
             ``set_sync_debug_mode("error")``. Gates: no unsuppressed
             finding; the captures and the kernels' launches each
             contract's programs must hold;
3. parity  - the serve kernel against its plain PyTorch version at every
             rung 1/8/64/512, f32 and bf16 tables, dense features and an
             ELL-sparse layout, 5% cold lookups plus padding rows;
             max |diff| <= 1e-5 (f32) and <= 5e-2 (bf16, the serving
             parity gate);
4. serve   - load_checkpoint -> CoefficientTables -> ScorePrograms
             (one CUDA graph captured per rung: the count, seconds and
             bytes) -> MicroBatchQueue -> drive over 20,000 synthetic
             requests (5% cold) with bf16 tables; no errors, no graph
             captured while serving, every dispatch a replay that runs
             one kernel launch and no launch from Python, and 2,000 more
             requests under ``torch.profiler``: one ``serve_score``
             kernel per replay; 64 sampled requests re-scored through
             the queue agree with the plain version and with a float64
             numpy score taken straight from the checkpoint arrays;
5. timing  - per rung and table dtype, median of 50 runs after warm-up
             with CUDA events: the kernel's and the plain version's device
             time (calls captured in a CUDA graph and replayed) beside
             the launch floor (``torch.zeros(1)`` timed the same way),
             the same calls issued eagerly from Python, the host time to
             issue one kernel call, a whole host dispatch and fetch as
             a graph replay (``dispatch_host_ms``) beside the eager
             dispatch (copies, launch and fetch from Python), the
             bound and ``ladder_bound_ms``, the cost ledger's count of
             the rung (every row known and distinct,
             ``ScorePrograms.rung_cost``);
6. paced   - a second drive at a fixed offered load, whose p50/p99 are
             service latency rather than queueing behind a flood, once
             with telemetry off and once on as ``cli.serve`` runs it
             (spans, request records, the registry): both p50/p99, no
             graph captured, and the request records the ring kept plus
             the events it dropped cover every request; then the
             20,000-request flood off, on, on, off (``flood_telemetry``:
             QPS, p50/p99), and one more pair on the same requests with
             skewed users, p(u) ~ 1 / (u + 1) (``flood_monitor``):
             the health tap, an SLO policy and the monitor exporter
             under a scraper polling /metrics, /healthz and /readyz
             every 50 ms, off then on (QPS and p50 reported, not gated;
             gated: no error, no graph captured and one replay a batch
             in both, every exposition valid, and the hottest user in
             the queue's top 5);
6a. coords - the serving model plus 9 small random coordinates (12
             active, two launches a rung: groups of 8 and 4): the kernel
             against its plain version at rungs 1 and 512, f32 and bf16
             (the parity gates), and rung 512's device time beside the
             3-coordinate model's;
6b. score_cli - batch scoring from Avro: the serving model written as an
             Avro GAME model directory (``save_game_model``, float32) and
             107,496 TrainingExampleAvro rows (``write_training_examples``;
             features / userFeatures / movieFeatures bags of 8 / 6 / 4
             features, 5% cold user and movie ids, logistic labels,
             weights and offsets), then ``cli.score.main`` with
             ``--evaluators AUC RMSE AUC:userId``, once on the kernel and
             once with ``PHOTON_SERVE_KERNEL=off``. Gates: the native Avro
             decoder ran; one kernel launch per chunk of the 1024/8192
             ladder (13 x 8192 + 1 x 1024) and none with the switch off;
             the output scores within 1e-5 (relative to 1 + |score|) of
             a float64 numpy score of the same rows and of the plain
             run; ``evaluation.json`` (f32, the labels' dtype) within
             the f32 rounding bound of numpy's float64 metrics of the
             written scores (``f32_metric_tolerances``: sqrt(n) 2**-24
             relative for AUC and RMSE, the cancellation of the running
             sums for AUC:userId, whose premise, the depth of the card's
             f32 scan, is measured and held: ``scan_premise``), and
             equal, bit for bit, to ``evaluate_scores`` run twice in this
             process on them (determinism: the evaluation's segment sums
             launch the segment-sum kernel, counted at its
             ``evaluation`` site, and its running sums take the
             evaluators' fixed-order float64 blocked scan). The
             segment-sum kernel is held, run twice, on each of the
             in-process evaluation's own segment sums against its plain
             version in float64, within the rounding of the kernel's
             order of additions (``evaluation_segment_check``), and the
             card's 1-D ``torch.cumsum`` is run 100 times on each of its
             running-sum operands, f32 and float64, to count the runs
             that differ (``scan_stability``). It prints
             each stage's seconds, rows/s, and the kernel's device ms
             at rungs 1024 and 8192 on the CLI's ELL operands beside the
             bound and the launch floor.

6c. serve_ops - serving as operators run it, on the serving model with
             bf16 tables: (a) a values-only reload (new coefficients
             from another seed) while 4 producer threads flood 20,000
             requests: nothing recaptured, every request served, 64 of
             them then within 5e-2 of the new model's float64 numpy
             score; (b) four degraded drives of 5,000 requests on the
             live ladder, each with its counters gated: 1 ms deadlines
             (every request served or expired, both counted), a shed
             watermark of 256 (every refusal counted), transient
             ``serve.dispatch`` faults at calls 2, 4, 6, 8 and 10 (all
             retried and served), poison at calls 1-3 with a breaker of
             threshold 3 (tripped once, every request poisoned, drained
             or refused, then ``reset_breaker`` serves a full batch);
             (c) a structure-change reload to the 12-coordinate
             ``coords`` model under the same flood: 4 graphs captured
             off the request path, the seconds the queue was parked,
             the old ladder's bytes released, every request served,
             two launches a replay, and the new ladder against its
             plain version; (d) ``cli.serve --input`` on score_cli's
             107,496 rows and model directory (ELL requests, deadlines,
             a shed watermark, the breaker, a hot reload of the same
             directory) with ``--telemetry``, ``--trace`` and
             ``--request-log`` and the cost ledger armed: every row
             served twice with no graph captured after start, one launch
             a replay, and the per-request scores equal, bit for bit in
             float32, to ``cli.score``'s (and within 1e-5 relative to
             1 + |score|); every file validates,
             the request records kept plus the events dropped cover the
             2 x 107,496 requests, the registry's outcome counters equal
             ``health()``, the ledger's ``serve/score@<rung>`` dispatches
             sum to the replays and its roofline for rung 512 equals the
             count ``score_cli`` printed for that rung of this ladder
             (``cli_serve_telemetry``). The same run passes
             ``--monitor-port 0 --health-sketch --slo-p99-ms 10``, its
             exporter polled every 50 ms (``scraping_monitors``): every
             exposition valid by the port's ``validate_exposition``,
             /healthz 200, /readyz 503 before the last rung's graph was
             captured (each 503 naming the tables, a graph or the
             queue, which starts just after the last capture) and 200
             once the queue was up, the ladder's graphs captured and
             one replay for each batch the queue served, the tap's
             sampled requests in the written sketch, and ``slo``,
             ``window_latency`` and ``hot_entities`` in the summary
             (``cli_serve_monitoring``).

Then the training group, on the bench's logistic GLMix at full width in
float32 (``bench.py`` ``build_estimator("logistic")`` and
``_synth_arrays``, seed 20260729: 4,000,000 rows, fixed effect d = 64,
``per-user`` 100,000 entities x 17 slots, ``per-movie`` 20,000 x 9,
4 coordinate-descent iterations; nothing cut):

7.  train_data     - numpy data, the copy to the card, the host planner;
7a. planner_logistic - the same prepare with PHOTON_TPU_SERIAL_INGEST=1
                     on a fresh estimator, then pipelined again, this
                     time the bf16 estimator's with its warm capture
                     armed (the first prepare, f32, declines it: a
                     listener is attached, so its fused fit captures at
                     first use): the seconds of the three, each one's
                     PIPELINE_STATS report and packed
                     transfers (bytes, chunks, seconds), ``os.cpu_count()``,
                     PHOTON_TPU_INGEST_THREADS and ``torch.get_num_threads()``,
                     and the warm stage (``warm_stage_row``: its compile
                     seconds, the compile_wait at the prepare's end, the
                     overlap fraction, nodes); gate: every run's packed plan
                     buffers equal to the first's on the card (precision
                     changes no plan);
8.  newton_parity  - three Newton steps on the largest user and movie
                     buckets: the CUDA kernel, ``newton_step_plain`` in
                     f32 and in float64, on the card. The kernel's
                     largest error against float64 is at most twice the
                     f32 plain version's (+1e-5) in w, f and g, and its
                     ``improved`` equals the plain version's; their
                     difference and the count outside rtol 1e-4 /
                     atol 1e-5 are reported (entities whose objective
                     moved only by f32 round-off on both sides are
                     counted and left out);
9.  fit            - the unfused ``GameEstimator.fit`` (a no-op listener)
                     with the Newton-kernel launch, plain-route and
                     host-sync counts zeroed just before: launches > 0
                     and no bucket on the plain route; again, warm (its
                     launches those of the first); then the fused fit
                     (``fused_fit``): cold, its capture (seconds, graph
                     and conditional nodes), then 3 warm replays under
                     ``torch.cuda.set_sync_debug_mode("error")`` and
                     one under ``torch.profiler`` (peak memory, kernel
                     launches on the device counters). Gates: no solver
                     sync in a warm fit; each replay's Newton launches
                     equal its diagnostics' count and the unfused fit's;
                     the models equal the unfused fit's bit for bit or
                     within 5e-4 (fixed effect) / 2e-3 (random effects),
                     which is printed. (The fused fit's fixed effect runs
                     ``batched.lbfgs``, the unfused one ``lbfgs.py``:
                     this pair took the place of ``fe_lbfgs_designs``.)
                     Then the unfused fit once more with
                     ``obs.enable()``, ``ledger.enable()`` and
                     ``obs.health.enable()`` (``fit_telemetry``): the
                     same host syncs and Newton launches, the model
                     equal bit for bit and a ``coord:<cid>`` span every
                     update; and one fused fit armed the same way
                     (``fused_fit_telemetry``): one ``fused_fit`` span,
                     one fit recorded, one sentinel parked and scanned
                     finite, ``fused_fit`` rows for every coordinate;
9a. fit_bf16      - the bf16 estimator of 7a on the same data
                     (``phase_fit_bf16``): its first fused fit adopts
                     the warm graph (compile and wait seconds, overlap
                     fraction, nodes), BF16_WARM warm replays under
                     ``set_sync_debug_mode("error")``, the eager twin,
                     one unfused fit (a no-op listener); a warm start
                     at a tenth of the rows and entities.
                     Gates: every coefficient finite; within 2e-2 of
                     the f32 fused model (fixed and random effects, the
                     largest difference over the f32 model's largest
                     magnitude, the reference's logistic tolerance);
                     the fused fit within ``bf16_fused_bounds`` of the
                     unfused bf16 fit (2^-8 of the coordinate's largest
                     coefficient plus 2^-9 of the largest score, each
                     coordinate); no solver sync in a warm
                     replay; 0 Newton-kernel launches and every bucket
                     solve on the batch-minor loop (the kernel takes
                     f32 only, as the reference's does); the slab bytes
                     half the f32 fit's; a warm start adds no fused
                     cache key; ``cache_stats()`` reads
                     ``aot_compiles >= 1`` and ``aot_failures == 0``;
                     the graph was adopted, not captured in the fit,
                     and the adopted fit equals its eager twin bit for
                     bit. Peak memory and the training AUC beside the
                     f32 AUC are printed;
10. optimality     - each entity's gradient at the fitted model against
                     the cascade's tolerance, else its convergence reason;
11. quality        - train AUC beside the generating weights' AUC;
12. train_serve    - the trained model through save_checkpoint,
                     load_checkpoint and ScorePrograms on 512 training
                     rows: equal to the trainer's scores within 1e-5;
13. newton_timing  - device ms per Newton step at every bucket shape
                     (CUDA-graph replay), the plain version's at the
                     largest buckets, and the bound;
14. route_agreement - the same fit at a tenth of the rows and entities
                     with the kernel route and with the batch-minor plain
                     route (``PHOTON_NEWTON_KERNEL=off``): fixed effect
                     within rtol 1e-3 / atol 1e-4,
                     random effects within rtol 1e-3 / atol 2e-3 (the
                     f32 resolution of an entity's optimum, see
                     RE_FIT_ATOL), training losses within 1e-4. The
                     kernel fit's model then goes through
                     ``GameEstimator.evaluate_model`` with
                     ``obs.health.calibration_sink`` on the data's last
                     40,000 rows (``calibration_check``): the sketch's
                     ECE within 1e-12 of numpy's on the host scores the
                     sink received, and the sink's one device-to-host
                     copy counted under ``torch.profiler``.
14a. train_cli     - GAME training from the command line at the
                     logistic configuration's widths: the serving
                     model's arrays (fixed effect ``global`` on the
                     features bag's 63 ids plus the intercept, d = 64;
                     ``per-user`` on userFeatures, 17 slots; ``per-movie``
                     on movieFeatures, 9 slots) draw logistic labels for
                     262,144 train and 32,768 validation rows
                     (``score_files``: ELL_K features a bag, users with a
                     long tail of activity, p(u) ~ 1 / (u + 20), which is
                     synthetic; 5% cold ids in validation).
                     Cut: rows only, against the 4,000,000 above, because
                     the pure-Python Avro writer makes the files. A JSON
                     config (``train_cli_config``: global L2 1e-3,
                     per-user L2 [1, 10] capped at 512 rows as above
                     (its longest users in a [B, 1024, 17] bucket, past
                     the reference's R * S <= 16384), per-movie L2 1, two
                     iterations, AUC and AUC:userId, EXPLICIT output,
                     feature stats, a checkpoint directory) runs through
                     ``cli.train.main`` twice: on the kernel, under
                     ``torch.profiler`` (device time only) with
                     ``--no-flight`` (telemetry fully off), and with
                     ``PHOTON_NEWTON_KERNEL=off``; then ``cli.score.main``
                     scores the validation file with the kernel run's
                     best model. Gates: (a) both exit 0, the output
                     layout, the checkpoint at its last iteration; (b)
                     Newton launches on the kernel run and no bucket on
                     the plain route, none with the switch off, and the
                     kernel held against its plain version as
                     newton_parity holds it, on a synthetic bucket of the
                     run's longest shape (``long_bucket``); (c) the
                     same best configuration, best models within the
                     route_agreement tolerances (entities whose rows hold
                     one label, which have no finite optimum, counted and
                     left out), validation AUCs within 1e-4; (d) the
                     trained AUC recovers at least half of the generating
                     model's lift over 0.5; (e) the scores within 1e-5
                     (relative to 1 + |score|) of a float64 numpy score
                     from the best model's arrays, ``evaluation.json``'s
                     AUC within 1e-4 of the summary's, one serve launch a
                     chunk; (f) the global shard's feature stats within
                     1e-6 of numpy float64 over the written rows. And
                     (b) the fixed effect's sparse transpose: the kernel
                     run (profiled) launched the segment-sum kernel at
                     its ``fixed_effect`` site and no atomic scatter
                     kernel (``index_add_``, ``scatter_add_``,
                     ``index_put_`` with accumulate; ATOMIC_SCATTER_KERNELS)
                     on the card; on the run's own global shard (262,144
                     x 9 slots into 64 features, cut into 8,192 row
                     blocks of 64 segments each) the kernel is held,
                     twice, against its plain version and timed, alone
                     and with the blocks' sum, beside ``index_add_`` on
                     the same slots and its bound (``fixed_effect_site``);
                     the run's peak device memory is printed with it.

14b. train_cli_routes - in a process of its own (``phase_child``), beside
                     14c-14h: phase 14a's files through ``cli.train`` on the
                     optimizer routes (``train_cli_routes_config``:
                     ``global`` TRON with FULL variances and
                     down-sampling 0.5, ``per-user`` L2 [1, 10] with
                     SIMPLE variances, ``per-movie`` L1 1 with SIMPLE
                     variances), then a second ``cli.train`` with
                     ``incremental_training`` and ``--init-model`` on the
                     first run's best checkpoint, then ``cli.score`` of
                     the validation file with the second run's best
                     model. Gates: both runs exit 0; every coordinate's
                     variances in the written Avro models read back
                     equal to the run's native checkpoint (by entity and
                     feature); Newton launches on both runs and no
                     plain-route solve; validation AUC at least half the
                     generating model's lift; scores within 1e-5
                     (relative to 1 + |score|) of a float64 numpy score,
                     one serve launch a chunk.
14c. train_routes  - the logistic training configuration at full width
                     (``synth_arrays``: 4,000,000 rows, ``per-user``
                     100,000 x 17, ``per-movie`` 20,000 x 9, float32) on
                     the slice's routes (``routes_estimator``): ``global``
                     TRON, L2 1e-3, FULL variances; ``per-user`` L2 1,
                     SIMPLE variances, on the Newton kernel;
                     ``per-movie`` elastic net (alpha 0.5, weight 1) on
                     the batched OWL-QN route, with SIMPLE variances so
                     that the refit has a prior for every coordinate; 2
                     CD iterations; then one incremental iteration from
                     that model. Per update: seconds, batched and Newton
                     host syncs, iterations (max and mean) and Newton
                     launches. Gates: (a) Newton launches on both fits
                     and no plain-route solve; (b) every per-movie
                     entity's minimum-norm subgradient (float64, at its
                     last update's residuals) under the cascade's
                     tolerance, else a convergence reason, with the
                     count of exact zeros; (c) the fixed effect's TRON
                     stop confirmed in float64 for the reason it
                     reports: GRADIENT_CONVERGED, the gradient under
                     TRON's tolerance; FUNCTION_VALUES_CONVERGED, the
                     last step's decrease (its start replayed) under
                     the loss tolerance; OBJECTIVE_NOT_IMPROVING, the
                     gradient under the f32 resolution
                     sqrt(8 u F lambda_max); (d) the FULL variances
                     within 3 (sqrt(n) + d) u cond(H) of float64, and
                     for 256 sampled entities of every random-effect
                     bucket the SIMPLE variances within (R + S M + 4) u
                     of float64 1 / diag; (e) the first fit at a tenth
                     of the rows
                     and entities on the card and on the CPU
                     (``device="cpu"``) within route_agreement's
                     tolerances, training losses within 1e-4; (f) at that
                     size the configuration fused (TRON, OWL-QN and the
                     variances in a graph) against the unfused fit on the
                     card, within the same tolerances
                     (``train_routes_fused``). Both fits of (a)-(d) keep
                     a no-op listener: their per-update records need the
                     unfused loop.
14d. stream_cli    - run once 14a is done, in a process of its own
                     (``phase_child``; ``cli_phases`` runs 14c in this
                     process beside 14b and 14d-14h's processes), on
                     14a's configuration and its
                     training rows, which 14a writes as 16 part files
                     (the in-memory runs read the directory): the
                     in-memory ``cli.train`` and (a) ``--stream-dir
                     --stream-window 2``, side by side, each in a
                     subprocess of its own (``--cli-child``,
                     ``cli_children``) for its peak RSS (the larger
                     of VmHWM, where the kernel reports it, and VmRSS
                     sampled every 10 ms from this process), beside the
                     RSS after the imports and the CUDA context;
                     then, each with
                     a lighter config (one lambda, one iteration, the
                     best model only; (b)'s completing run and (e)'s
                     training each in a subprocess of its own, beside
                     (b)'s refusal and (c) in the phase's process):
                     (b) shard 5 truncated: the default
                     policy raises ``CorruptShardError`` naming it;
                     ``--max-bad-shards 1`` completes, under (d)
                     transient faults at ``io.shard_read`` calls 2, 4, 6
                     and 8 (each followed by a clean attempt: three in a
                     row exhaust the 3-attempt policy); (c) a ``crash``
                     at ``io.shard_decode`` on shard 9 (serial decode, so
                     the call count is exact), then ``--resume-ingest``;
                     (e) day 2: stream again with ``--init-model`` (a)'s
                     best checkpoint, then ``cli.score`` of the
                     validation file. The in-memory child passes
                     ``--telemetry``, ``--trace`` and ``--flight-dir``
                     and a copy of the config with ``profile_dir``: its
                     JSONL and Chrome trace validate, it leaves no
                     flight dump, and its torch.profiler trace names the
                     Newton and segment-sum kernels within the
                     ``train_fit_profile`` span (``stream_telemetry``);
                     (i) it also passes ``--distributed --fleet-dir``,
                     so it runs with the cost ledger armed and ships a
                     1-rank fleet bundle, which ``python -m
                     photon_tpu_torch.cli.fleetview --expect-ranks 1``
                     merges (``stream_fleet``): both exit 0, the bundle
                     committed, the merged trace valid, one rank, no
                     gap, a finite clock bound, fit seconds booked to
                     each of 14a's coordinates, and its launches at
                     every kernel site equal to 14a's kernel run's (it
                     prints the bundle's bytes and ship seconds);
                     (c)'s crash leaves one ``flight-<pid>.json`` whose
                     ``faults_fired`` names it. (a) and (c) run with
                     ``obs.health`` armed: the resumed (c)'s
                     ``ingest-sketch.json`` is byte-identical to (a)'s,
                     then ``python -m photon_tpu_torch.cli.health``
                     compares (a)'s work dir with 6c(d)'s serve sketch
                     and prints its report (``stream_sketch_check``).
                     Gates: (a) the dataset
                     (host mirrors, device columns, id tags) and the
                     packed plan buffer sha256-equal to the in-memory
                     run's,
                     two in-memory fits equal bit for bit (14a's kernel
                     run and this phase's) and the streamed fit's best
                     model equal, bit for bit, to the in-memory one's
                     (the fixed effect's transpose is a sorted segment
                     sum, so no reduction on the card changes its order
                     from run to run); (b) the file named, the
                     quarantined path and ingested_fraction 15/16;
                     (c) ``resumed_from_shard`` the committed cursor's,
                     the dataset and plans equal to (a)'s; (d) 4
                     retries, 4 recovered, none exhausted; (e) the
                     checkpoint's run meta holds ``ingest_cursor`` and
                     ``init_model``, the scores within 1e-5 of a float64
                     numpy score, one serve launch a chunk; every run
                     launches the Newton kernel with no plain-route
                     solve, and the segment sum at the ``evaluation``
                     site (the validation's AUC:userId) and at the
                     ``fixed_effect`` site. It prints the
                     ingest's seconds by stage, rows/s, the packed
                     transfers and both peak RSS.
14e. tuning_cli    - hyperparameter tuning through ``cli.train`` on 14a's
                     files (``tuning_config``: one lambda a coordinate,
                     one CD iteration, TUNED output, seed TUNING_SEED):
                     RANDOM with 3 candidates and BAYESIAN with 5
                     twice (with three tunable coordinates and a
                     one-point grid the GP makes the 4th and 5th), the
                     three runs side by side, each in a subprocess of
                     its own (``cli_children``, started before 14b and
                     running beside it), then
                     ``cli.score`` of the validation file with the
                     BAYESIAN run's best model. Gates: the RANDOM
                     candidates' lambdas equal, bit for bit, the Sobol
                     draws taken straight from ``scipy.stats.qmc`` with
                     the same seed (``sobol_lambdas``); the two BAYESIAN
                     runs' configurations, evaluations, best index and
                     best model equal bit for bit; each run's
                     ``num_tuned_configurations`` its candidates; TUNED
                     saves ``best`` and every tuned model but the best,
                     never the grid's; Newton launches with no
                     plain-route solve, segment sums at the
                     ``fixed_effect`` and ``evaluation`` sites; the
                     scores within 1e-5 of a float64 numpy score, one
                     serve launch a chunk. It prints each run's seconds
                     by stage and per configuration.
14f. glm_cli       - the legacy ``cli.glm`` on 14a's files (the global
                     bag), in a process of its own beside 14b
                     (``phase_child``), lambdas GLM_LAMBDAS, on the card
                     in float32
                     and on the CPU in float64 (the port's readers
                     switched to float64: ``float64_readers``). Gates:
                     the same selected lambda, the card's best model
                     within GLM_F32_ATOL = 5e-4 of float64 (the bound
                     ``tests/test_torch_wide.py`` derives for an f32
                     fixed-effect solve), segment sums
                     at the ``fixed_effect`` site. It prints both runs'
                     seconds by stage.
14g. pilot_cli     - ``python -m photon_tpu_torch.cli.pilot`` (through
                     ``--cli-child``, so the child reports its counts;
                     ``pilot_child``), started beside 14e's three
                     children and 14b (all only read 14a's files), at 14a's
                     widths (``pilot_config``: 14a's coordinates with one
                     lambda each, one CD iteration, AUC and AUC:userId on
                     the validation file, windows of 2 shards, rungs
                     1/8/64/512, ``--traffic-qps 1000`` for the whole
                     first run, ``--monitor-port 0`` scraped every 50 ms,
                     health armed with drift 0.25 and non-finite
                     coefficients; the skew gate off, since the traffic
                     is synthetic and not drawn from the training rows).
                     Cut: rows, as in 14a, and the days are 14a's part
                     files of 16,384 rows. Every cycle ingests every
                     shard of the watched directory, so the cycles grow:
                     (a) parts 0-3 land, the bootstrap promotes and the
                     server captures the ladder; (b) parts 4-5 land, the
                     retrain from the live generation is gated on the
                     holdout and promoted under traffic (values-only or a
                     structure change, reported); (c) part 6's rows with
                     every feature value moved by DRIFT_SHIFT = 4.0
                     (bench.py:223) land and the cycle is refused with a
                     ``health:drift`` reason, held in the state file and
                     a flight post-mortem; (d) a restart (a second child,
                     no traffic of its own) with the shifted day taken
                     out and a replay of part 2 in (a copy under a new
                     name: no new entity or feature, so the promotion and
                     the rollback are values-only reloads), under a
                     ``PHOTON_TPU_FAULT_PLAN`` that poisons the first
                     ``serve.dispatch`` after the new generation's
                     64-request sample in its observation window: the
                     pilot rolls back to (b)'s generation. Not run here:
                     the SIGTERM between the ring commit and the reload
                     (``tests/test_torch_pilot.py`` on the CPU). Gates:
                     no stage failure, deadline overrun or error report
                     in either run (the pilot retries a failed stage
                     after a backoff); every stage on the card, Newton
                     launches with no plain-route solve and segment sums
                     at the ``fixed_effect`` and ``evaluation`` sites in
                     both runs; one serve replay a batch served (a
                     poisoned batch none); the start captures the ladder,
                     a values-only reload no graph and a structure change
                     one a rung, off the request path, and (d)'s
                     promotion and rollback are values-only; no request
                     error in (a)-(c) and none stranded, in (d) only the
                     poisoned batch's, in OBSERVE; after each promotion
                     ((d)'s inside its window) and after the rollback, 64
                     requests through the live queue within 1e-5 (5e-2
                     with bf16 tables) of the plain version of that
                     generation's tables and, relative to 1 + |score|, of
                     a float64 numpy score from its ``.npz``, the
                     rollback's equal bit for bit to (b)'s; (b)'s holdout
                     AUC recovers at least half the generating model's
                     lift; every scraped exposition valid. It prints the
                     staleness (part landed to serving), each cycle's
                     seconds by stage, the graphs each promotion
                     captured, the traffic served and its errors, and
                     p50/p99 by the stage a request was submitted in
                     (TRAIN against IDLE).

14h. profile_cli   - ``python -m photon_tpu_torch.cli.profile`` twice,
                     each through ``--cli-child`` (``profile_child``),
                     chained, the chain started beside 14e's and 14g's
                     children and 14b: (A) the JAX package's CI
                     contract, its defaults with ``--overhead-check``
                     (512 rows, 16 users, 25 samples of at least 1 s of
                     fits an arm, ledger off and on alternating fit by
                     fit; the median of the samples' on/off ratios
                     within 1.05); (B)
                     ``--rows 262144 --entities 8192 --fits 3``, the
                     priced report at the training CLI's row count.
                     Gates for each: exit 0 and ``failures`` empty;
                     Newton launches in the profiled fit window (from
                     outside the package: ``ledger.mark`` and the first
                     ``attribution_since`` wrapped) and no plain-route
                     solve; each probe (``segment_sum`` on 8,192 values
                     at site ``segment_reduce/probe``, ``serve_score``
                     on one 64-row rung) launched its kernel once and
                     its census row carries a ``vs_roofline``; the fit
                     window's attributed fraction above 0; (A)'s
                     overhead and top-k table printed. It prints each
                     run's seconds, top-k rows with their blocking
                     reasons and the census.

Then the wide group, ``wide-linear`` in float32: the bench's squared-loss
GLMix with ``per-movie`` on a sparse tag shard (20,000 movies, p(m) ~
1 / (m + 20); each owns 192 of 100,000 tag ids; a row carries 2-8 of
its movie's tags and the intercept id), whose subspaces are wider than
128 slots, so the planner lays it out materialized (ELL blocks, a score
table capped at 6 entries a row with a COO tail); 4,000,000 rows,
``per-user`` 100,000 x 17 as above, 4 coordinate-descent iterations,
nothing cut:

15. wide_data        - generation, the copy to the card, the planner's
                       host seconds, every bucket's shape, S, route and
                       gram bounds, the tail's size and multiplicity
                       (``planner_wide``, 7a's serial and repeated
                       pipelined prepares of these arrays, ~50 s, is cut
                       to keep the script inside its time with phase
                       25: the serial planner's plans stay held against
                       the pipelined ones byte for byte in 7a);
16. segment_parity   - the segment-sum kernel against its plain version
                       on integer fixtures (exact: duplicates, empty
                       segments, dropped ids, one long run), random f32
                       and bf16 values, and the inputs of every site at
                       its full-width shape (gram, slots, each densify
                       bucket, score tail, a multiplicity-1
                       scatter_add_rows over the user bucket's 4M rows):
                       |diff| <= 1e-6 (1 + sum |v| of the segment), and
                       two kernel runs bit-identical;
17. segment_timing   - per site: the kernel's and the plain version's
                       device ms (CUDA-graph replay), the whole wrapper's
                       ms, one ``index_add_`` on the same ids (a yardstick,
                       never called by the port) and the bound;
18. wide_fit         - ``GameEstimator.fit`` with the segment counts
                       zeroed just before: launches at the gram, slots,
                       densify and score-tail sites, every direct solve
                       one iteration and GRADIENT_CONVERGED; then each
                       update timed alone. The layout is materialized,
                       so the fit stays unfused (gated, with the
                       reference's reason printed); before the fit one
                       gram and one densify bucket's solve are captured
                       into a CUDA graph and replayed
                       (``wide_fit_graph``): bit for bit the eager solve,
                       the same launches;
19. wide_optimality  - for 256 sampled entities of every random-effect
                       bucket, the float64 normal equations at the
                       residuals of the entity's last solve: fitted
                       coefficients within rtol 1e-3 / atol 1e-4;
20. wide_route_agreement - per-movie solved as built and with the gram
                       route's pair budget at 0 (densify everywhere):
                       within rtol 1e-4 / atol 1e-5;
21. wide_train_serve - the wide model through save_checkpoint,
                       load_checkpoint and ScorePrograms (the tag shard
                       as ELL rows) on 512 rows: the trainer's scores
                       within 1e-5;
22. wide_newton      - the Newton kernel's wide design on the per-movie
                       gram bucket densified (logistic operands over the
                       same data): newton_parity's three-step check and
                       newton_timing's columns;
23. wide_logistic    - the same generator at a tenth of the rows and
                       entities, logistic: densify launches; the wide
                       buckets within the Newton gate (R * S <= 16384,
                       S > 128) on the Newton kernel's wide design, the
                       rest on the batch-minor Newton loop; the optimality
                       check of phase 10; then newton_parity's three-step
                       check and newton_timing's columns at the widest
                       bucket on the kernel, whose solve (densify and the
                       Newton loop on the wide design) is captured and
                       replayed before the fit as in 18
                       (``wide_logistic_graph``).

24. ell_routes       - the routes of ROADMAP Queue A item 6, between 22
                       and 23 (a) and after 23 (b, c), each part's
                       seconds printed (``t``):
    (a) ell_routes_full - 22's 4,000,000-row arrays as they are, the
                       tag shard folded onto 127 ids plus the intercept
                       (``ell_fold``: S <= 128) and logistic labels from
                       the generator's margin; the logistic bench
                       estimator with ``per-movie`` on that shard, no
                       width cap, f32. Gates: the auto layout is lazy;
                       some bucket is over ``ONE_HOT_ELEMENT_BUDGET``
                       and exactly those materialize ELL (each bucket's
                       [B, R, k, S], B R k S beside the budget, and
                       route printed); the fit captures the fused graph,
                       whose capture recorded ``segment_reduce/densify``;
                       two warm replays under
                       ``set_sync_debug_mode("error")`` with no solver
                       sync, each launching segment sums and Newton
                       steps (device counters), bit-identical models
                       equal to the unfused fit's, bit for bit or within
                       ``FUSED_FE_ATOL`` / ``FUSED_RE_ATOL`` (an entity
                       past the latter only where both fits stopped on
                       its objective and the two objectives agree within
                       ``ROUND_OFF``: ``entity_gaps``);
                       ``entity_optimality`` on 256 entities of every
                       bucket; every densified bucket's segment-sum
                       densify against ``densify_ell_plain`` within
                       ``SEGMENT_REL``, and, where the Newton kernel
                       takes the dense slab, newton_parity's three
                       steps on it (the STEP bounds). Printed: capture
                       and instantiate seconds,
                       the warm fits' seconds beside the unfused fit's,
                       peak memory;
    (b) ell_routes_f64 - 23's arrays in float64: ``per-movie`` on the
                       wide tag shard solved once at fixed residuals,
                       every bucket on the ``ell`` route; a second solve
                       bit-identical; 64 entities of every bucket solved
                       on the CPU by the same route: iterations and
                       reasons equal, coefficients within rtol 1e-9 /
                       atol 1e-11;
    (c) ell_routes_dual - 23's arrays with the tag shard as
                       ``ell_to_dual_ell(width_cap=4)``: a fixed effect
                       and ``per-movie`` (score table capped at 6) over
                       it, fitted twice: launches at the ``fixed_effect``
                       and ``segment_reduce/score_tail`` sites, the two
                       fits bit-identical; ``GameTransformer``'s scores
                       within 1e-5 (relative to 1 + |score|) of a
                       float64 numpy score of the rows, and
                       ``cli.score.score_game_dataset`` (its
                       ``GameTransformer`` fallback) equal to them.
25. mesh             - data- and entity-parallel training and scoring
                       (``parallel/mesh.py``) in two ranks of one
                       ``torch.distributed`` group on the one card: gloo,
                       since NCCL refuses two ranks on one device. Each
                       rank is ``chip_smoke.py --cli-child`` with the
                       variables ``torchrun --standalone --nproc-per-node
                       2`` exports (``mesh_ranks``);
    (a) mesh_fit     - right after 7-14: phase ``fit``'s logistic
                       estimator at full width (4,000,000 rows, f32) with
                       ``mesh="auto"``, each rank generating the arrays
                       from the seed, prepared and fitted twice. Gates:
                       each rank holds ceil(rows / 2) fixed-effect rows
                       and half of every bucket's padded entities; the
                       fit unfused with the reference's reason;
                       Newton-kernel launches in each rank; the two fits
                       bit-identical in each rank, and rank 1's model
                       rank 0's bit for bit; the model within
                       ``MESH_FE_ATOL`` / ``MESH_RE_ATOL`` of phase
                       ``fit``'s unfused model (saved by phase 7-14 as
                       ``build/smoke/mesh/single.npz``), an entity past
                       the latter only where both fits stopped on its
                       objective (``mesh_gaps``, as ``entity_gaps``).
                       Printed: the backend, each rank's prepare and fit
                       seconds, collectives per fit and their seconds,
                       peak memory and Newton launches;
    (b) mesh_cli     - in a process of its own once 14f's ends, beside
                       14b and 14d (``cli_phases``),
                       on 14a's files: ``cli.train`` in two ranks with
                       ``--distributed --fleet-dir`` (14a's
                       configuration, ``model_output_mode`` BEST), then
                       ``cli.fleetview``, then ``cli.score --mesh auto``
                       in two ranks on 14a's best model. Gates: exit 0;
                       one model and one summary; 14a's configuration
                       and validation AUC (within 1e-4); the coefficients
                       within 1e-3 / 4e-3 of 14a's best model, twice
                       Queue C's f32 split (one-label entities left out,
                       as 14a's own agreement does; the excess past the
                       reference's rtol 1e-4 / atol 2e-5 is printed);
                       two bundles and no rank missing; one scores file
                       within 1e-5 of 14a's ``cli.score`` and its AUC;
    (c) mesh_column  - in (a)'s ranks after its fits: the column-sharded
                       fixed effect at the JAX package's d = 10^7 + 1
                       (``column_rank``) by L-BFGS, then (i) an elastic
                       net by OWL-QN, (ii) L-BFGS-B with binding scalar
                       bounds on the same shards, (iii) FULL variances at
                       1,025 features of the same generator, each fitted
                       twice and against the parent's replicated fit of
                       the same route (``phase_mesh_column``,
                       ``phase_mesh_column_routes``). Gates: the route
                       check at the replicated coefficients within
                       ``ROUND_OFF``; fits and ranks bit-identical; each
                       whole fit on a stop rule, float64 objectives
                       within ``ROUND_OFF``; (i)'s padded slots 0, (ii)
                       inside its bounds, (iii)'s variances within
                       ``COLUMN_VAR_ROUTE_RTOL`` / ``COLUMN_VAR_RTOL``;
                       every census declared; segment-sum launches at
                       ``fixed_effect`` in every fit.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line again, and
last ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.

``python3 chip_smoke.py --fits N`` runs only the device and build phases
and then the full-width fits and the Newton kernel's timing, for
comparing two trees on one card: the logistic fit N + 1 times on the
kernel route (fused: the first, cold, is the capture) and N + 1 times
unfused (a no-op listener), once on the plain route in float32 and once
in float64, each with its trajectory (Newton and L-BFGS
iterations, launches, host syncs) and training loss; newton_timing; the
``wide-linear`` fit N + 1 times; the wide design's check and timing on
its per-movie gram bucket. It prints no ``ok`` line. To compare a parent
commit, unpack its package into a git-ignored directory, copy this
script beside it, and run parent, change, change, parent in one call.

``python3 chip_smoke.py --train-cli`` runs only the device and build
phases and then phases 14a and 14b, ``--cli`` phase 14a and then
14b-14h as the whole run runs them (``cli_phases``), ``--train-routes``
phase 14c,
``--serve`` the serving phases 1-6c, ``--stream`` phases 14a, 14d, 7a
(on its own logistic data) and 15, ``--tuning`` phases 14a, 14e and
14f, ``--pilot`` 14a's files (not its runs) and phase 14g, and
``--profile`` phase 14h alone and then ``overhead_aa``, printing no
``ok`` line: ``cli.profile``'s A/B run three times with both arms off
(A/A) and three times as it runs, each read by its own estimator (the
median paired ratio) and by the JAX package's (the best on over
the best off), with no gate.

``python3 chip_smoke.py --ell-routes`` runs only the device and build
phases and then phase 24 on its own arrays (22's and 23's generators),
printing no ``ok`` line.

``python3 chip_smoke.py --mesh`` runs only the device and build phases,
phase ``fit``'s unfused fit (saved for 25 (a)), phase 25 (a) with (c),
phase 14a and phase 25 (b), printing no ``ok`` line.

``python3 chip_smoke.py --timing N`` runs only the device and build
phases and then the serve kernel's timing phase (phase 5) N times on the
serving model, printing no ``ok`` line: the A/B of the serve kernel
across two trees, in the same way.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 20260803
N_FEATURES = 64
N_USERS, USER_SLOTS = 100_000, 17
N_MOVIES, MOVIE_SLOTS = 20_000, 9
RUNGS = (1, 8, 64, 512)
N_REQUESTS = 20_000
COLD_FRACTION = 0.05
PACED_REQUESTS, PACED_QPS = 10_000, 5_000.0
PROFILED_REQUESTS = 2_000
SERVE_PRECISION = "bfloat16"
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
# ELL widths of the sparse layout: a few of each shard's features.
ELL_K = {"global": 8, "userShard": 6, "movieShard": 4}
# The card's peaks and the kernels' byte and operation counts live in the
# package (photon_tpu_torch/analysis/costmodel.py): the bounds printed
# here and the cost ledger's rows read one count.
TIMING_RUNS, TIMING_INNER = 50, 20
# ``event_ms`` stops early once this many runs took this much device time.
TIMING_MIN_RUNS, TIMING_BUDGET_S = 10, 2.0
PLAIN_INNER = 4
REPLACES = "photon_tpu/ops/serve_kernel.py:291"


def zero_serve_counts(serve_kernel) -> None:
    """Zero the serve kernel's counters: launches from Python and
    launches run by graph replays."""
    serve_kernel.launches = 0
    serve_kernel.replay_launches = 0


def serve_counts(serve_kernel) -> tuple[int, int]:
    """(launches from Python, launches run by graph replays)."""
    return serve_kernel.launches, serve_kernel.replay_launches


# The script's clock: every phase row carries its seconds since start
# ("t"), so that a run shows where its wall time went.
T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def empty_cache() -> None:
    """``torch.cuda.empty_cache()`` once no CUDA-graph capture is in
    progress in any thread (it fails during one)."""
    from photon_tpu_torch.utils import device_loop

    device_loop.empty_cache()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def serving_arrays(seed: int = SEED):
    """Checkpoint-keyed arrays and manifest of the serving model."""
    rng = np.random.default_rng(seed)
    task = "LOGISTIC_REGRESSION"
    arrays = {
        "global/means": (rng.normal(size=N_FEATURES) * 0.3).astype(np.float32)
    }
    manifest = {"global": {"kind": "fixed", "shard": "global", "task": task}}
    for name, re_type, shard, e, s in (
        ("per-user", "userId", "userShard", N_USERS, USER_SLOTS),
        ("per-movie", "movieId", "movieShard", N_MOVIES, MOVIE_SLOTS),
    ):
        arrays[f"{name}/coefficients"] = (
            rng.normal(size=(e, s)) * 0.3).astype(np.float32)
        arrays[f"{name}/proj_all"] = np.tile(
            np.arange(s, dtype=np.int64), (e, 1))
        manifest[name] = {
            "kind": "random", "re_type": re_type, "shard": shard,
            "task": task, "entity_keys": [str(i) for i in range(e)],
        }
    return arrays, manifest


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi exited {proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def ell_specs(programs):
    from photon_tpu_torch.serve.programs import FeatureSpec

    return {
        s: FeatureSpec("sparse", programs.specs[s].d, k=ELL_K[s])
        for s in programs.shard_order
    }


def peaks() -> dict:
    """The H100 SXM's peaks (NVIDIA data sheet), from the package."""
    from photon_tpu_torch.analysis import costmodel

    return costmodel.CHIP_PEAKS[costmodel.DEFAULT_CHIP]


def roofline_row(cost: dict) -> dict:
    """bound_ms and bound_by of a count at the card's peaks."""
    from photon_tpu_torch.analysis import costmodel

    roof = costmodel.roofline(cost)
    return {"bound_ms": roof["min_seconds"] * 1e3,
            "bound_by": "bytes" if roof["bound"] == "hbm" else "operations",
            "bytes": cost["hbm_bytes"], "flops": cost["flops"]}


def bound(ops: dict, precision: str) -> dict:
    """Least time the card could take for one launch on these operands
    (``costmodel.serve_score_cost`` on this batch's data): each input
    byte read once (only the table rows this rung's known codes name,
    once per distinct entity), the output written once, and the
    multiply-adds at the f32 peak."""
    from photon_tpu_torch.analysis import costmodel

    return roofline_row(costmodel.serve_score_cost(ops, precision))


def packed_operands(programs, n, rung_seed, cold_fraction=COLD_FRACTION):
    """fused_score operands for ``n`` synthetic requests padded to their
    rung (rows past ``n`` are padding: zero features, code -1)."""
    from photon_tpu_torch.serve.driver import synthetic_requests

    reqs = synthetic_requests(programs.tables, programs, n,
                              cold_fraction=cold_fraction, seed=rung_seed)
    feats, codes, _ = programs.pack_requests(reqs)
    return programs.operands(feats, codes)


def phase_parity(torch, model) -> float:
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.programs import ScorePrograms
    from photon_tpu_torch.serve.tables import CoefficientTables

    worst = 0.0
    for precision in ("float32", "bfloat16"):
        tables = CoefficientTables.from_game_model(model, precision)
        dense = ScorePrograms(tables, compile_now=False)
        for layout, programs in (
            ("dense", dense),
            ("ell", ScorePrograms(tables, specs=ell_specs(dense),
                                  compile_now=False)),
        ):
            for rung in RUNGS:
                n = max(1, rung - 1)
                ops = packed_operands(programs, n, rung_seed=rung)
                got = serve_kernel.fused_score(**ops)
                torch.cuda.synchronize()
                ref = serve_kernel.fused_score_reference(**ops)
                torch.cuda.synchronize()
                if got.shape != (rung,) or not bool(got.isfinite().all()):
                    fail(f"parity {precision}/{layout}/{rung}: bad output")
                err = float((got - ref).abs().max())
                worst = max(worst, err)
                cold = sum(int((c[:n] < 0).sum()) for c in ops["codes"])
                emit({"phase": "parity", "precision": precision,
                      "layout": layout, "rung": rung, "requests": n,
                      "cold_lookups": cold, "max_abs_err": err,
                      "tol": TOL[precision]})
                if not err <= TOL[precision]:
                    fail(f"kernel and plain version differ by {err} "
                         f"({precision}, {layout}, rung {rung})")
    return worst


def numpy_scores(torch, arrays, requests, precision) -> np.ndarray:
    """float64 scores of dense requests straight from the checkpoint
    arrays: x . w_global + per coordinate sum_s w[e, s] * x[proj[e, s]]
    for a known entity e. Weights and features are first rounded to the
    table dtype, as the served path stores and reads them."""
    dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32

    def stored(a):
        return torch.from_numpy(a).to(dtype).double().numpy()

    out = []
    for feats, ids in requests:
        z = stored(feats["global"]) @ stored(arrays["global/means"])
        for name, re_type, shard in (("per-user", "userId", "userShard"),
                                     ("per-movie", "movieId", "movieShard")):
            key = ids.get(re_type, "")
            if key.isdigit():
                e = int(key)
                proj = arrays[f"{name}/proj_all"][e]
                w = stored(arrays[f"{name}/coefficients"][e])
                x = stored(feats[shard])
                z += float(np.sum(w[proj >= 0] * x[proj[proj >= 0]]))
        out.append(z)
    return np.asarray(out)


def profiled_queue_window(torch, queue, requests) -> dict:
    """``requests`` through the live queue under ``torch.profiler``:
    the rung dispatches (graph replays) in the window beside the
    ``serve_score`` kernels, graph launches and copies the card ran."""
    from torch.profiler import ProfilerActivity, profile

    programs = queue.programs
    before = sum(programs.stats["dispatches"].values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        futs = [queue.submit(f, ids) for f, ids in requests]
        for f in futs:
            f.result(timeout=120)
        torch.cuda.synchronize()
    counts: dict = {}
    for e in prof.key_averages():
        for key, match in (("kernels", "serve_score_kernel"),
                           ("graph_launches", "cudaGraphLaunch"),
                           ("copies_to_device", "Memcpy HtoD"),
                           ("copies_to_host", "Memcpy DtoH")):
            if match in e.key:
                counts[key] = counts.get(key, 0) + e.count
    replays = sum(programs.stats["dispatches"].values()) - before
    return {"requests": len(requests), "replays": replays, **counts}


def phase_serve(torch, ckpt_path, arrays) -> dict:
    from photon_tpu_torch.io.model_io import load_checkpoint
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.driver import drive, synthetic_requests
    from photon_tpu_torch.serve.programs import ScorePrograms
    from photon_tpu_torch.serve.queue import MicroBatchQueue
    from photon_tpu_torch.serve.tables import CoefficientTables

    t0 = time.perf_counter()
    model = load_checkpoint(ckpt_path)
    tables = CoefficientTables.from_game_model(model, SERVE_PRECISION)
    programs = ScorePrograms(tables)  # one CUDA graph captured per rung
    setup_s = time.perf_counter() - t0
    capture = {k: programs.stats[k] for k in (
        "programs_compiled", "aot_compile_seconds", "graph_device_bytes",
        "graph_host_bytes")}
    per_graph = {r: programs.compile_rung(r).launches for r in RUNGS}
    requests = synthetic_requests(tables, programs, N_REQUESTS,
                                  cold_fraction=COLD_FRACTION, seed=7)
    with MicroBatchQueue(programs, max_linger_s=0.002) as queue:
        zero_serve_counts(serve_kernel)
        summary = drive(queue, requests)
        eager, launches = serve_counts(serve_kernel)
        by_rung = dict(programs.stats["dispatches"])
        dispatches = sum(by_rung.values())
        recaptured = (programs.stats["programs_compiled"]
                      - capture["programs_compiled"])
        profiled = profiled_queue_window(torch, queue,
                                         requests[:PROFILED_REQUESTS])
        sample = np.random.default_rng(1).choice(
            len(requests), size=64, replace=False)
        picked = [requests[i] for i in sample]
        futs = [queue.submit(f, ids) for f, ids in picked]
        served = np.array([f.result(timeout=120) for f in futs])
        qstats = queue.stats()
    feats, codes, _ = programs.pack_requests(picked)
    plain = serve_kernel.fused_score_reference(
        **programs.operands(feats, codes))[:64].cpu().numpy()
    exact = numpy_scores(torch, arrays, picked, SERVE_PRECISION)
    err_plain = float(np.abs(served - plain).max())
    err_numpy = float(np.abs(served - exact).max())
    result = {
        "phase": "serve", "precision": SERVE_PRECISION,
        "setup_seconds": setup_s, **capture,
        "launches_per_replay": per_graph,
        "kernel_launches": launches, "eager_launches": eager,
        "graphs_captured_while_serving": recaptured,
        "dispatches": by_rung, "profiled": profiled,
        "sample_max_abs_err_plain": err_plain,
        "sample_max_abs_err_numpy_f64": err_numpy,
        # Host pack (pad, stack, entity-code lookup) per batch, whole run.
        "pack_ms_per_batch": (
            qstats["staging_seconds"] * 1e3 / qstats["batches"]),
        **{k: summary[k] for k in (
            "requests", "warmup_requests", "errors", "p50_ms", "p90_ms",
            "p99_ms", "max_ms", "qps", "wall_seconds", "batches",
            "batch_fill_fraction", "mean_batch_size", "cold_entity_rate",
            "staged_batches", "staging_overlap_fraction")},
    }
    emit(result)
    if summary["errors"]:
        fail(f"{summary['errors']} requests failed")
    if capture["programs_compiled"] != len(RUNGS) or recaptured:
        fail(f"serve: {capture['programs_compiled']} graphs captured at "
             f"start for {len(RUNGS)} rungs, {recaptured} while serving")
    if set(per_graph.values()) != {1}:
        fail(f"serve: kernel launches per graph {per_graph}, expected 1")
    if eager or launches <= 0 or launches != dispatches:
        fail(f"serve: {launches} replayed and {eager} eager kernel "
             f"launches for {dispatches} dispatches")
    if profiled.get("kernels") != profiled["replays"] or not profiled[
            "replays"]:
        fail(f"serve: the profiler saw {profiled.get('kernels')} "
             f"serve_score kernels for {profiled['replays']} replays")
    if not np.isfinite(served).all():
        fail("non-finite served scores")
    if not err_plain <= TOL[SERVE_PRECISION]:
        fail(f"served scores differ from the plain version by {err_plain}")
    if not err_numpy <= TOL[SERVE_PRECISION]:
        fail(f"served scores differ from the numpy score by {err_numpy}")

    # The paced drive with telemetry off, then on as cli.serve runs it
    # (spans, request records, registry): the same ladder, no capture.
    from photon_tpu_torch import obs

    paced = {}
    captured = programs.stats["programs_compiled"]
    for mode in ("off", "on"):
        if mode == "on":
            obs.reset()
            obs.enable()
        try:
            with MicroBatchQueue(programs, max_linger_s=0.002) as queue:
                paced[mode] = drive(queue, requests[:PACED_REQUESTS],
                                    rate=PACED_QPS)
        finally:
            obs.disable()
        emit({"phase": "paced", "precision": SERVE_PRECISION,
              "telemetry": mode, **{k: paced[mode][k] for k in (
                  "requests", "errors", "offered_rate", "qps", "p50_ms",
                  "p90_ms", "p99_ms", "max_ms", "mean_batch_size",
                  "batches")},
              **({"request_trace": paced[mode]["request_trace"]}
                 if mode == "on" else {})})
        if paced[mode]["errors"]:
            fail(f"{paced[mode]['errors']} paced requests failed "
                 f"(telemetry {mode})")
    dropped = obs.trace.dropped()
    obs.reset()
    if programs.stats["programs_compiled"] != captured:
        fail("paced: a graph was captured while serving with telemetry on")
    # The request ring holds 8,192 events: the records it kept and the
    # events it dropped cover every request.
    trace_on = paced["on"]["request_trace"]
    if (set(trace_on["outcomes"]) != {"served"}
            or trace_on["records"] + dropped < PACED_REQUESTS):
        fail(f"paced: request records {trace_on}, {dropped} dropped")
    result["paced"] = {m: {k: paced[m][k] for k in ("p50_ms", "p99_ms")}
                       for m in paced}
    result["flood_telemetry"] = flood_telemetry(programs, requests)
    return result


def flood_telemetry(programs, requests) -> dict:
    """The flood of phase 4 with telemetry off and on, in turns (off, on,
    on, off): QPS and p50/p99 of each, the cost of recording every
    request (``cli.serve`` always records). Then one more pair on
    skewed traffic (``flood_monitor``): the health tap, the monitor
    exporter under a concurrent scraper and SLO tracking off, then on."""
    from photon_tpu_torch import obs
    from photon_tpu_torch.serve.driver import drive
    from photon_tpu_torch.serve.queue import MicroBatchQueue

    runs = []
    for mode in ("off", "on", "on", "off"):
        obs.reset()
        if mode == "on":
            obs.enable()
        try:
            with MicroBatchQueue(programs, max_linger_s=0.002) as queue:
                out = drive(queue, requests)
        finally:
            obs.disable()
            obs.reset()
        if out["errors"]:
            fail(f"flood_telemetry: {out['errors']} requests failed")
        runs.append({"telemetry": mode, **{k: out[k] for k in (
            "qps", "p50_ms", "p99_ms", "batches", "mean_batch_size")}})
    row = {"phase": "flood_telemetry", "precision": SERVE_PRECISION,
           "requests": len(requests), "runs": runs,
           "monitor_runs": flood_monitor(programs, requests)}
    emit(row)
    return row


# The /metrics, /healthz and /readyz poll interval of the scrapers.
SCRAPE_INTERVAL_S = 0.05
# Skewed users for the monitored flood: p(u) ~ 1 / (u + c).
HOT_USER_SKEW = 1


class MonitorScraper(threading.Thread):
    """Polls one monitor exporter every ``SCRAPE_INTERVAL_S`` until
    ``stop()``: each ``/metrics`` text through the port's own
    ``validate_exposition``, each ``/healthz`` and ``/readyz`` status
    (the latter with its JSON detail). The first probe runs at
    construction, before the caller goes on. A failure is recorded,
    never raised on this thread; the caller gates the record."""

    def __init__(self, url: str):
        super().__init__(name="chip-smoke-scraper", daemon=True)
        self.url = url
        self._stop_event = threading.Event()
        self.expositions = 0
        self.samples = 0
        self.healthz: dict = {}
        self.readyz: list = []  # (status, detail) in order
        self.errors: list = []
        self.poll()

    def poll(self) -> None:
        import urllib.error
        import urllib.request

        from photon_tpu_torch.obs import monitor

        try:
            for path in ("/readyz", "/healthz", "/metrics"):
                try:
                    with urllib.request.urlopen(self.url + path,
                                                timeout=5) as resp:
                        status, body = resp.status, resp.read()
                except urllib.error.HTTPError as exc:
                    status, body = exc.code, exc.read()
                if path == "/readyz":
                    self.readyz.append((status, json.loads(body)))
                elif path == "/healthz":
                    self.healthz[status] = self.healthz.get(status, 0) + 1
                elif status != 200:
                    self.errors.append(f"/metrics {status}: {body[:200]}")
                else:
                    self.samples += monitor.validate_exposition(
                        body.decode("utf-8"))
                    self.expositions += 1
        except Exception as exc:  # noqa: BLE001 - recorded, then gated
            self.errors.append(repr(exc))

    def run(self) -> None:
        while not self._stop_event.wait(SCRAPE_INTERVAL_S):
            self.poll()

    def stop(self) -> "MonitorScraper":
        self._stop_event.set()
        self.join(timeout=30)
        return self

    def summary(self) -> dict:
        return {"expositions": self.expositions, "samples": self.samples,
                "healthz": self.healthz, "errors": self.errors[:3],
                "readyz": [s for s, _ in self.readyz]}


@contextlib.contextmanager
def scraping_monitors():
    """Every ``MonitorServer`` started inside the block gets a
    ``MonitorScraper``, its first probe made inside ``start`` (before
    the starter goes on) and its last before the server stops; yields
    the list of scrapers."""
    from photon_tpu_torch.obs import monitor

    scrapers: list = []
    start, stop = monitor.MonitorServer.start, monitor.MonitorServer.stop

    def scraped_start(self):
        out = start(self)
        scraper = MonitorScraper(self.url)
        scraper.server = self
        scraper.start()
        scrapers.append(scraper)
        return out

    def scraped_stop(self):
        for scraper in scrapers:
            if scraper.server is self:
                scraper.stop()
        stop(self)

    monitor.MonitorServer.start = scraped_start
    monitor.MonitorServer.stop = scraped_stop
    try:
        yield scrapers
    finally:
        monitor.MonitorServer.start, monitor.MonitorServer.stop = start, stop
        for scraper in scrapers:
            scraper.stop()


def skewed_users(requests, seed: int = SEED + 5) -> tuple[list, str]:
    """``requests`` with their userId redrawn from the vocabulary the
    synthetic requests used, p(u) ~ 1 / (u + HOT_USER_SKEW) (cold ids
    kept): (requests, the most frequent id)."""
    keys = sorted({ids["userId"] for _, ids in requests
                   if not ids["userId"].startswith("__cold")}, key=int)
    rng = np.random.default_rng(seed)
    p = 1.0 / (np.arange(len(keys)) + HOT_USER_SKEW)
    draws = rng.choice(len(keys), size=len(requests), p=p / p.sum())
    out = []
    for (feats, ids), d in zip(requests, draws):
        if not ids["userId"].startswith("__cold"):
            ids = {**ids, "userId": keys[int(d)]}
        out.append((feats, ids))
    counts: dict = {}
    for _, ids in out:
        counts[ids["userId"]] = counts.get(ids["userId"], 0) + 1
    return out, max(counts, key=counts.get)


def flood_monitor(programs, requests) -> list:
    """The phase-4 flood on skewed users (``skewed_users``), with the
    health layer, an SLO policy and the monitor exporter under a
    ``MonitorScraper`` off, then on. Gates, each run: no request failed,
    no graph captured, one replay a batch (the layers add no device
    work); on: every scraped exposition valid, ``/healthz`` 200,
    ``/readyz`` 200, the tap sampled requests, and the hottest user in
    the queue's top 5 for ``per-user``. QPS and p50 are reported, not
    gated."""
    from photon_tpu_torch.obs import health, monitor
    from photon_tpu_torch.serve.driver import drive
    from photon_tpu_torch.serve.queue import MicroBatchQueue

    skewed, hottest = skewed_users(requests)
    runs = []
    for mode in ("off", "on"):
        on = mode == "on"
        health.reset()
        if on:
            health.enable()
        captured = programs.stats["programs_compiled"]
        replays = sum(programs.stats["dispatches"].values())
        scraper = None
        try:
            with MicroBatchQueue(
                    programs, max_linger_s=0.002,
                    slo=monitor.SloPolicy(p99_ms=10.0) if on else None
            ) as queue, (monitor.MonitorServer(
                    0, collectors=[queue.metrics_families],
                    readiness=lambda: (not queue.health()["breaker_open"],
                                       {}))
                    if on else contextlib.nullcontext()) as srv:
                if on:
                    scraper = MonitorScraper(srv.url)
                    scraper.start()
                try:
                    out = drive(queue, skewed)
                finally:
                    if scraper is not None:
                        scraper.stop()
                batches = queue.stats()["batches"]
                top = [it["key"] for it in queue.hotness_top(5)["per-user"]]
            tap = health.serve_snapshot()
        finally:
            health.disable()
            health.reset()
        run = {"mode": mode, **{k: out[k] for k in (
            "qps", "p50_ms", "p99_ms", "batches", "mean_batch_size",
            "errors")},
            "graphs_captured": programs.stats["programs_compiled"]
            - captured,
            "replays": sum(programs.stats["dispatches"].values()) - replays,
            "queue_batches": batches, "hot_top5": top, "hottest": hottest,
            "requests_sampled": tap["requests_sampled"],
            "slo": out.get("slo"), "window_latency": out["window_latency"],
            "scraper": None if scraper is None else scraper.summary()}
        runs.append(run)
        if (out["errors"] or run["graphs_captured"]
                or run["replays"] != batches):
            fail(f"flood_monitor ({mode}): {run}")
        if on and (scraper.errors or not scraper.expositions
                   or set(scraper.healthz) != {200}
                   or {s for s, _ in scraper.readyz} != {200}
                   or tap["requests_sampled"] <= 0
                   or hottest not in top or out.get("slo") is None):
            fail(f"flood_monitor (on): {run}")
    return runs


def event_ms(torch, run, inner: int) -> float:
    """Median over TIMING_RUNS of CUDA-event time of ``run()`` divided
    by the ``inner`` calls it makes; once TIMING_MIN_RUNS runs have
    taken TIMING_BUDGET_S of device time, over those runs (a call of
    tens of ms, as a plain version at full width takes, needs no 50)."""
    runs = []
    spent = 0.0
    for _ in range(TIMING_RUNS):
        if len(runs) >= TIMING_MIN_RUNS and spent >= TIMING_BUDGET_S:
            break
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / inner)
        spent += runs[-1] * inner / 1e3
    return float(np.median(runs))


def eager_ms(torch, fn, inner: int) -> float:
    """Time per call of ``inner`` calls issued from Python back to back:
    what a caller sees, including the host's launch cost whenever the
    device waits for it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(inner):
            fn()

    return event_ms(torch, run, inner)


def device_ms(torch, fn, inner: int) -> float:
    """Device time per call: ``inner`` calls captured in one CUDA graph
    and replayed, so the host's launch cost is out of the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    from photon_tpu_torch.utils import device_loop

    graph = torch.cuda.CUDAGraph()
    # One capture at a time in the process (a warm capture may run), on
    # a stream no other thread's work shares.
    capture_stream = torch.cuda.Stream(priority=device_loop.CAPTURE_PRIORITY)
    with device_loop.exclusive(), torch.cuda.graph(graph,
                                                   stream=capture_stream):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return event_ms(torch, graph.replay, inner)


def enqueue_ms(torch, fn, inner: int) -> float:
    """Host time to issue one call (checks, operand packing, launch),
    median over TIMING_RUNS runs of ``inner`` calls."""
    runs = []
    for _ in range(TIMING_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        runs.append((time.perf_counter() - t0) * 1e3 / inner)
    torch.cuda.synchronize()
    return float(np.median(runs))


def host_ms(programs, dispatch, feats, codes, n) -> float:
    """Median host wall time of one whole dispatch (``dispatch`` is
    ``programs.dispatch_padded``, a graph replay, or
    ``programs.dispatch_eager``) and the fetch that waits for the
    scores."""
    for _ in range(3):
        programs.fetch_padded(dispatch(feats, codes, n))
    runs = []
    for _ in range(TIMING_RUNS):
        t0 = time.perf_counter()
        programs.fetch_padded(dispatch(feats, codes, n))
        runs.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(runs))


def phase_timing(torch, model) -> list[dict]:
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.driver import synthetic_requests
    from photon_tpu_torch.serve.programs import ScorePrograms
    from photon_tpu_torch.serve.tables import CoefficientTables

    rows = []
    # The smallest launch the card makes, timed as ``ms`` is: a yardstick
    # for a kernel whose bytes take less time than a launch.
    floor_ms = device_ms(
        torch, lambda: torch.zeros(1, device="cuda"), TIMING_INNER)
    for precision in ("float32", "bfloat16"):
        tables = CoefficientTables.from_game_model(model, precision)
        programs = ScorePrograms(tables)
        for rung in RUNGS:
            reqs = synthetic_requests(tables, programs, rung,
                                      cold_fraction=COLD_FRACTION, seed=rung)
            feats, codes, _ = programs.pack_requests(reqs)
            ops = programs.operands(feats, codes)

            def kernel():
                return serve_kernel.fused_score(**ops)

            def plain():
                return serve_kernel.fused_score_reference(**ops)

            row = {
                "phase": "timing", "precision": precision, "rung": rung,
                "ms": device_ms(torch, kernel, TIMING_INNER),
                "launch_floor_ms": floor_ms,
                "plain_ms": device_ms(torch, plain, PLAIN_INNER),
                "eager_ms": eager_ms(torch, kernel, TIMING_INNER),
                "plain_eager_ms": eager_ms(torch, plain, PLAIN_INNER),
                "enqueue_host_ms": enqueue_ms(torch, kernel, TIMING_INNER),
                "dispatch_host_ms": host_ms(
                    programs, programs.dispatch_padded, feats, codes, rung),
                "eager_dispatch_host_ms": host_ms(
                    programs, programs.dispatch_eager, feats, codes, rung),
                **bound(ops, precision),
                # The cost ledger's count of this rung: every row known
                # and distinct (ScorePrograms.rung_cost).
                "ladder_bound_ms": roofline_row(
                    programs.rung_cost(rung))["bound_ms"],
            }
            emit(row)
            rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# more than eight coordinates, and batch scoring from Avro
# ---------------------------------------------------------------------------

EXTRA_COORDS = 9  # random coordinates added: 12 active in all
EXTRA_ENTITIES, EXTRA_SLOTS = 2_000, 5
COORD_RUNGS = (1, 512)
SCORE_ROWS = 13 * 8192 + 1_000  # chunk plan: 13 x 8192, then rung 1024
SCORE_RUNGS = (1024, 8192)
SCORE_EVALUATORS = ("AUC", "RMSE", "AUC:userId")
SCORE_SHARDS = {"global": ("features", "g", N_FEATURES),
                "userShard": ("userFeatures", "u", USER_SLOTS),
                "movieShard": ("movieFeatures", "m", MOVIE_SLOTS)}
F32_U = 2.0 ** -24


def coords_arrays(arrays, manifest, seed: int = SEED + 1):
    """The serving model plus EXTRA_COORDS small random coordinates,
    alternating between the user and movie shards and id types, each
    with its own entity vocabulary (12 active coordinates)."""
    rng = np.random.default_rng(seed)
    arrays, manifest = dict(arrays), dict(manifest)
    for i in range(EXTRA_COORDS):
        user = i % 2 == 0
        width = USER_SLOTS if user else MOVIE_SLOTS
        name = f"extra-{i}"
        arrays[f"{name}/coefficients"] = (rng.normal(
            size=(EXTRA_ENTITIES, EXTRA_SLOTS)) * 0.3).astype(np.float32)
        arrays[f"{name}/proj_all"] = np.stack([
            np.sort(rng.choice(width, size=EXTRA_SLOTS, replace=False))
            for _ in range(EXTRA_ENTITIES)]).astype(np.int64)
        manifest[name] = {
            "kind": "random", "re_type": "userId" if user else "movieId",
            "shard": "userShard" if user else "movieShard",
            "task": "LOGISTIC_REGRESSION",
            "entity_keys": [str(e) for e in rng.permutation(
                N_USERS if user else N_MOVIES)[:EXTRA_ENTITIES]],
        }
    return arrays, manifest


def phase_coords(torch, arrays, manifest, timing_rows) -> dict:
    """A model of 12 active coordinates through one ScorePrograms: the
    kernel (two launches a rung, groups of 8 and 4) against its plain
    version at rungs 1 and 512, and rung 512's device time beside the
    3-coordinate serving model's from the timing phase."""
    from photon_tpu_torch.io.model_io import game_model_from_numpy
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.programs import ScorePrograms
    from photon_tpu_torch.serve.tables import CoefficientTables

    big_arrays, big_manifest = coords_arrays(arrays, manifest)
    model = game_model_from_numpy(big_arrays, big_manifest, "cuda")
    out = {}
    for precision in ("float32", "bfloat16"):
        tables = CoefficientTables.from_game_model(model, precision)
        programs = ScorePrograms(tables, compile_now=False)
        n_coords = len(programs._fe_names) + len(programs._re_names)
        for rung in COORD_RUNGS:
            ops = packed_operands(programs, max(1, rung - 1), rung_seed=rung)
            before = serve_kernel.launches
            got = serve_kernel.fused_score(**ops)
            torch.cuda.synchronize()
            launched = serve_kernel.launches - before
            ref = serve_kernel.fused_score_reference(**ops)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            row = {"phase": "coords", "precision": precision, "rung": rung,
                   "coordinates": n_coords, "launches_per_rung": launched,
                   "max_abs_err": err, "tol": TOL[precision]}
            if rung == COORD_RUNGS[-1]:
                three = next(r for r in timing_rows
                             if r["precision"] == precision
                             and r["rung"] == rung)
                row.update(
                    ms=device_ms(torch,
                                 lambda: serve_kernel.fused_score(**ops),
                                 TIMING_INNER),
                    plain_ms=device_ms(
                        torch, lambda: serve_kernel.fused_score_reference(
                            **ops), PLAIN_INNER),
                    three_coordinate_ms=three["ms"],
                    launch_floor_ms=three["launch_floor_ms"],
                    **bound(ops, precision))
                out[precision] = row
            emit(row)
            if n_coords != 12 or launched != 2:
                fail(f"coords: {n_coords} coordinates in {launched} "
                     "launches, expected 12 in 2")
            if not bool(got.isfinite().all()) or not err <= TOL[precision]:
                fail(f"coords: kernel and plain version differ by {err} "
                     f"({precision}, rung {rung})")
    return out


def score_files(arrays, manifest, root: str, n: int = SCORE_ROWS,
                seed: int = SEED + 2, *, cold: float = COLD_FRACTION,
                intercept: bool = False, model: bool = True,
                name: str = "data.avro",
                user_skew: int | None = None,
                parts: int | None = None) -> dict:
    """The serving model as an Avro GAME model directory (float32
    coefficients, written by the port's ``save_game_model``; left out
    without ``model``) and ``n`` TrainingExampleAvro rows with the
    features, userFeatures and movieFeatures bags (ELL_K features each,
    values N(0, 1)), userId and movieId in the metadata with a ``cold``
    fraction of ids unseen anywhere else, logistic labels drawn from the
    model, weights and offsets. Users are uniform, or with
    ``user_skew`` = c drawn with p(u) ~ 1 / (u + c), a long tail of
    activity. With ``intercept`` each shard's last
    slot is the intercept: the bags draw from the other ids, every
    row's margin adds the last coefficient (the reader appends the
    intercept column). With ``parts`` the rows go, in order, into that
    many part files ``part-NNNNN.avro`` of the directory ``name`` (the
    shard layout the streaming ingest reads; the in-memory readers read
    the directory as one input). Returns the paths and the arrays the
    numpy reference scores from."""
    from photon_tpu_torch.data.index_map import IndexMap
    from photon_tpu_torch.io.model_io import (
        game_model_from_numpy,
        save_game_model,
    )
    from photon_tpu_torch.types import make_feature_key

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    model_dir = os.path.join(root, "model")
    data_path = os.path.join(root, name)
    ids = {s: d - intercept for s, (_, _, d) in SCORE_SHARDS.items()}
    keys = {s: [make_feature_key(f"{p}{j}") for j in range(ids[s])]
            for s, (_, p, _) in SCORE_SHARDS.items()}
    t0 = time.perf_counter()
    if model:
        save_game_model(
            game_model_from_numpy(arrays, manifest, "cpu"), model_dir,
            {s: IndexMap({k: i for i, k in enumerate(ks)})
             for s, ks in keys.items()})
    model_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = {}
    for s in SCORE_SHARDS:
        k = ELL_K[s]
        idx = np.argsort(rng.random((n, ids[s])), axis=1)[:, :k]
        # Stored as f32, as the reader keeps them.
        val = rng.normal(size=(n, k)).astype(np.float32).astype(np.float64)
        feats[s] = (idx, val)
    if user_skew is None:
        users = rng.integers(0, N_USERS, size=n)
    else:
        p = 1.0 / (np.arange(N_USERS) + user_skew)
        users = rng.choice(N_USERS, size=n, p=p / p.sum())
    movies = rng.integers(0, N_MOVIES, size=n)
    cold_u = rng.uniform(size=n) < cold
    cold_m = rng.uniform(size=n) < cold
    weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    offsets = (rng.normal(size=n) * 0.1).astype(np.float32)
    exact = numpy_batch_scores(arrays, feats, np.where(cold_u, -1, users),
                               np.where(cold_m, -1, movies), intercept)
    labels = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(
        -(exact + offsets)))).astype(np.float64)

    def rows(s):
        idx, val = feats[s]
        ks = keys[s]
        return [list(zip([ks[j] for j in r], v))
                for r, v in zip(idx.tolist(), val.tolist())]

    tag = os.path.splitext(name)[0]
    meta = [{"userId": f"cold-{tag}-{i}" if cu else str(u),
             "movieId": f"cold-{tag}-{i}" if cm else str(m)}
            for i, (u, m, cu, cm) in enumerate(zip(
                users.tolist(), movies.tolist(), cold_u, cold_m))]
    global_rows = rows("global")
    bag_rows = {SCORE_SHARDS[s][0]: rows(s)
                for s in ("userShard", "movieShard")}
    if parts is None:
        spans = [(data_path, 0, n)]
    else:
        os.makedirs(data_path, exist_ok=True)
        step = -(-n // parts)
        spans = [(os.path.join(data_path, f"part-{k:05d}.avro"), lo,
                  min(lo + step, n))
                 for k, lo in enumerate(range(0, n, step))]
    jobs = [(path, labels[lo:hi], global_rows[lo:hi], offsets[lo:hi],
             weights[lo:hi], meta[lo:hi], np.arange(lo, hi),
             {b: r[lo:hi] for b, r in bag_rows.items()})
            for path, lo, hi in spans]
    if len(jobs) == 1:
        write_part(jobs[0])
    else:
        # The Avro encoder is Python: one process a part file. Spawned,
        # not forked, since this process holds a CUDA context.
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(len(jobs), os.cpu_count() or 1)) as pool:
            pool.map(write_part, jobs)
    data_s = time.perf_counter() - t0
    return dict(model_dir=model_dir, data=data_path, exact=exact,
                labels=labels, weights=weights.astype(np.float64),
                offsets=offsets.astype(np.float64), feats=feats,
                keys=keys, users=np.where(cold_u, -1, users),
                movies=np.where(cold_m, -1, movies),
                model_seconds=model_s, data_seconds=data_s,
                data_bytes=sum(os.path.getsize(p) for p, _, _ in spans))


def write_part(job) -> None:
    """One TrainingExampleAvro file of ``score_files``' rows."""
    from photon_tpu_torch.io import avro_data

    path, labels, rows, offsets, weights, meta, uids, bags = job
    avro_data.write_training_examples(
        path, labels, rows, offsets=offsets, weights=weights,
        metadata=meta, uids=uids, bags=bags)


def numpy_batch_scores(arrays, feats, users, movies,
                       intercept: bool = False) -> np.ndarray:
    """float64 scores of the batch rows straight from the model arrays:
    the global dot plus, for a known user (movie), the sum of its
    coefficients at the row's user (movie) features (the serving model's
    projector row is 0..S-1, so feature j is slot j); with
    ``intercept``, each coordinate's last slot adds for every row (of a
    known entity)."""
    gi, gv = feats["global"]
    w = arrays["global/means"].astype(np.float64)
    z = np.sum(gv * w[gi], axis=1) + (w[-1] if intercept else 0.0)
    for name, shard, codes in (("per-user", "userShard", users),
                               ("per-movie", "movieShard", movies)):
        idx, val = feats[shard]
        w = arrays[f"{name}/coefficients"].astype(np.float64)
        known = codes >= 0
        z[known] += np.sum(val[known] * w[codes[known][:, None],
                                          idx[known]], axis=1)
        if intercept:
            z[known] += w[codes[known], -1]
    return z


def numpy_auc(z, y, w) -> float:
    """Weighted tie-aware AUC: each positive's weight times the negative
    weight scored below it plus half that scored equal, over W+ W-."""
    pos = y > 0.5
    neg_s = z[~pos]
    order = np.argsort(neg_s, kind="stable")
    neg_s, neg_w = neg_s[order], w[~pos][order]
    cum = np.concatenate([[0.0], np.cumsum(neg_w)])
    below = cum[np.searchsorted(neg_s, z[pos], side="left")]
    upto = cum[np.searchsorted(neg_s, z[pos], side="right")]
    credit = np.sum(w[pos] * (below + 0.5 * (upto - below)))
    return float(credit / (np.sum(w[pos]) * np.sum(neg_w)))


def user_groups(files) -> list:
    """The row indices of each user's rows (a cold row is its own
    group)."""
    ids = np.where(files["users"] >= 0, files["users"],
                   -1 - np.arange(len(files["users"])))
    order = np.argsort(ids, kind="stable")
    return np.split(order, np.flatnonzero(np.diff(ids[order])) + 1)


def numpy_metrics(scores, files) -> dict:
    """AUC, RMSE and AUC:userId of the scores plus offsets, in float64:
    RMSE = sqrt(sum w (z - y)^2 / n); the grouped AUC is the mean over
    the users (cold ids included, each its own group) whose rows hold
    both classes."""
    z = scores.astype(np.float64) + files["offsets"]
    y, w = files["labels"], files["weights"]
    groups = [numpy_auc(z[r], y[r], w[r]) for r in user_groups(files)
              if y[r].min() < 0.5 < y[r].max()]
    return {"AUC": numpy_auc(z, y, w),
            "RMSE": float(np.sqrt(np.sum(w * (z - y) ** 2) / len(z))),
            "AUC:userId": float(np.mean(groups))}


def f32_metric_tolerances(files, want: dict) -> dict:
    """How far an f32 evaluation (the CLI's: the labels' dtype, as the
    reference's) may be from the float64 metrics ``want``, relative.

    AUC and RMSE are ratios of sums over the n rows (a running sum of
    negative weight times each positive's weight; the weighted squared
    residuals). An f32 sum of n terms, in whatever order the card takes
    them, adds a rounding error of at most u = 2**-24 of the running
    total at each step: a random walk whose size is about sqrt(n) u of
    the sum, 1.95e-5 for 107,496 rows.

    AUC:userId is the mean over the G users holding both classes of
    each user's AUC. A user's credit is a difference of two running sums
    of negative weight over all the rows in (group, score) order
    (``running_sum`` of the whole column, less the group's offset),
    each up to the total negative weight W-: cancellation, not the
    user's own few rows, sets its error. The premise: a running sum's
    error is a random walk of standard deviation at most
    sqrt(ceil(log2 n)) u W-, what a tiled f32 scan of depth
    ceil(log2 n) gives; on the card ``running_sum`` accumulates in
    float64 in a fixed order and rounds each running sum once to f32
    (at most u/2 of W-), well inside it, and ``scan_premise`` measures
    it in the same run. A credit carries two of them,
    sqrt(2 ceil(log2 n)) u W-, and that user's AUC the same over N_g,
    its negative weight. The users' errors are independent, so the
    mean's standard deviation is sqrt(2 ceil(log2 n)) u W- sqrt(sum 1 /
    N_g^2) / G; the bound is three of them."""
    y, w = files["labels"], files["weights"]
    neg = np.where(y < 0.5, w, 0.0)
    n_g = np.array([neg[r].sum() for r in user_groups(files)
                    if y[r].min() < 0.5 < y[r].max()])
    depth = math.ceil(math.log2(len(y)))
    grouped = (3.0 * math.sqrt(2 * depth) * F32_U * neg.sum()
               * np.sqrt(np.sum(1.0 / n_g ** 2)) / len(n_g))
    flat = math.sqrt(len(y)) * F32_U
    return {"AUC": flat, "RMSE": flat,
            "AUC:userId": grouped / abs(want["AUC:userId"])}


def scan_premise(torch, scores, files) -> dict:
    """The premise of ``f32_metric_tolerances``'s AUC:userId bound,
    measured: the negative weights in (user, score) order, as the grouped
    AUC orders its rows, summed by the evaluators' ``running_sum`` (the
    fixed-order blocked scan in float64, rounded to f32) on the card
    against float64.
    Returns the running sums' largest and root-mean-square
    error over W-, beside the premise's standard deviation
    sqrt(ceil(log2 n)) u and a sequential f32 sum's, about sqrt(n) u / 3
    at the end."""
    users = files["users"]
    ids = np.where(users >= 0, users, -1 - np.arange(len(users)))
    order = np.lexsort((scores + files["offsets"], ids))
    y, w = files["labels"][order], files["weights"][order]
    neg = np.where(y < 0.5, w, 0.0).astype(np.float32)
    from photon_tpu_torch.evaluation.evaluators import running_sum

    got = running_sum(torch.from_numpy(neg).cuda()).double().cpu()
    err = np.abs(got.numpy() - np.cumsum(neg.astype(np.float64)))
    total = float(neg.astype(np.float64).sum())
    n = len(neg)
    return {"n": n, "max_err_over_w": float(err.max()) / total,
            "rms_err_over_w": float(np.sqrt(np.mean(err ** 2))) / total,
            "premise_sd_over_w": math.sqrt(math.ceil(math.log2(n))) * F32_U,
            "sequential_sd_over_w": math.sqrt(n) * F32_U / 3.0}


def run_score_cli(files, out_dir, *extra) -> dict:
    """One ``cli.score.main`` run in this process; its JSON line."""
    from photon_tpu_torch.cli import score as score_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = score_cli.main([
            "--model-dir", files["model_dir"], "--input", files["data"],
            "--output", out_dir, "--feature-shards",
            *[f"{s}={SCORE_SHARDS[s][0]}" for s in SCORE_SHARDS],
            "--id-tags", "userId", "movieId",
            "--evaluators", *SCORE_EVALUATORS, *extra])
    if rc != 0:
        fail(f"cli.score exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_score_cli(torch, arrays, manifest, floor_ms: float) -> dict:
    """Batch scoring from Avro at full width through the CLI (module
    docstring); returns the rung-8192 timing row."""
    from photon_tpu_torch.io import avro
    from photon_tpu_torch.io.avro_data import read_merged
    from photon_tpu_torch.io.model_io import load_game_model
    from photon_tpu_torch.native import get_avro_decoder
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.programs import (
        ScorePrograms,
        ShapeLadder,
        specs_from_dataset,
    )
    from photon_tpu_torch.data.random_effect import scoring_codes
    from photon_tpu_torch.ops import segment_reduce
    from photon_tpu_torch.serve.tables import CoefficientTables
    from photon_tpu_torch.transformers import evaluate_scores

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "smoke", "score")
    files = score_files(arrays, manifest, root)
    decoder = "native" if get_avro_decoder() is not None else "python"
    plan = ShapeLadder(SCORE_RUNGS).chunk_plan(SCORE_ROWS)
    serve_kernel.launches = 0
    segment_reduce.reset_counts()
    line = run_score_cli(files, os.path.join(root, "out"))
    launches = serve_kernel.launches
    eval_launches = segment_reduce.launches_by_site.get("evaluation", 0)
    with env_switch("PHOTON_SERVE_KERNEL", "off"):
        serve_kernel.launches = 0
        plain_line = run_score_cli(files, os.path.join(root, "out_plain"))
        plain_launches = serve_kernel.launches
    recs = avro.read_container_dir(os.path.join(root, "out",
                                                "part-00000.avro"))
    scores = np.array([r["predictionScore"] for r in recs])
    plain = np.array([r["predictionScore"] for r in avro.read_container_dir(
        os.path.join(root, "out_plain", "part-00000.avro"))])
    rel = 1.0 + np.abs(files["exact"])
    err_numpy = float(np.max(np.abs(scores - files["exact"]) / rel))
    err_plain = float(np.max(np.abs(scores - plain) / rel))
    with open(os.path.join(root, "out", "evaluation.json")) as f:
        evaluation = json.load(f)
    want = numpy_metrics(scores, files)
    eval_tol = f32_metric_tolerances(files, want)
    eval_err = {k: abs(evaluation[k] - want[k]) / abs(want[k])
                for k in want}

    # The kernel at rungs 1024 and 8192 on the CLI's own operands: the
    # dataset and tables rebuilt as the CLI builds them, the first rows.
    data, maps = read_merged(
        files["data"],
        feature_shards={s: [SCORE_SHARDS[s][0]] for s in SCORE_SHARDS},
        id_tag_names=["userId", "movieId"], device="cuda")
    # evaluation.json against evaluate_scores run here, twice, on the
    # written scores (the same f32 values) and the same dataset.
    written = torch.from_numpy(scores.astype(np.float32)).cuda()
    with _EvaluationInputs() as seen:
        in_process = evaluate_scores(data, written,
                                     list(SCORE_EVALUATORS)).evaluations
    # The segment-sum kernel against its plain version on the
    # evaluation's own operands (tie blocks and users of the grouped AUC).
    eval_parity = [evaluation_segment_check(
        torch, segment_reduce, f"evaluation {i} n={n}", vals, ids, n)
        for i, (vals, ids, n) in enumerate(seen.segments)]
    stability = scan_stability(torch, seen.scans)
    again = evaluate_scores(data, written,
                            list(SCORE_EVALUATORS)).evaluations
    in_process_err = {k: abs(evaluation[k] - v) / abs(v)
                      for k, v in in_process.items()}
    premise = scan_premise(torch, scores, files)
    model, _ = load_game_model(files["model_dir"], maps, device="cuda")
    programs = ScorePrograms(
        CoefficientTables.from_game_model(model, "float32"),
        ladder=ShapeLadder(SCORE_RUNGS), specs=specs_from_dataset(data),
        compile_now=False)
    codes_all = [torch.from_numpy(scoring_codes(
        data, programs.tables.random[nm].random_effect_type,
        programs.tables.random[nm].entity_keys).astype(np.int32)).cuda()
        for nm in programs._re_names]
    timing = []
    for rung in SCORE_RUNGS:
        feats = tuple(programs.specs[s].slice_rows(
            (data.feature_shards[s].indices, data.feature_shards[s].values),
            0, rung, rung) for s in programs.shard_order)
        ops = programs._device_operands(
            feats, tuple(c[:rung].contiguous() for c in codes_all))
        row = {"phase": "score_cli_timing", "rung": rung,
               "layout": "ell", "precision": "float32",
               "k": {s: programs.specs[s].k for s in programs.shard_order},
               "ms": device_ms(torch,
                               lambda: serve_kernel.fused_score(**ops),
                               TIMING_INNER),
               "plain_ms": device_ms(
                   torch, lambda: serve_kernel.fused_score_reference(**ops),
                   PLAIN_INNER),
               "launch_floor_ms": floor_ms, **bound(ops, "float32")}
        emit(row)
        timing.append(row)
    # The count the cost ledger books for cli.serve's top rung on these
    # files (its default ladder, this layout, f32 tables): serve_ops
    # holds the ledger's priced row of that rung against it.
    cli_ladder = ScorePrograms(programs.tables, ladder=ShapeLadder(RUNGS),
                               specs=programs.given_specs,
                               compile_now=False)
    ladder_bound = {"phase": "score_cli_timing", "rung": RUNGS[-1],
                    "layout": "ell", "precision": "float32",
                    "ladder_bound": roofline_row(
                        cli_ladder.rung_cost(RUNGS[-1]))}
    emit(ladder_bound)
    del data, model, programs, codes_all, cli_ladder
    empty_cache()

    sec = line["seconds"]
    row = {
        "phase": "score_cli", "rows": SCORE_ROWS, "decoder": decoder,
        "decoded_blocks": line["decoded_blocks"],
        "write_data_seconds": files["data_seconds"],
        "write_model_seconds": files["model_seconds"],
        "data_bytes": files["data_bytes"],
        "seconds": sec, "rows_per_second": line["rows_per_second"],
        "chunks": len(plan), "kernel_launches": launches,
        "plain_run_launches": plain_launches,
        "serve_kernel": [line["serve_kernel"], plain_line["serve_kernel"]],
        "dispatches": line["dispatches"],
        "max_rel_err_numpy_f64": err_numpy,
        "max_rel_err_plain": err_plain,
        "evaluation": evaluation, "evaluation_numpy": want,
        "evaluation_rel_err": eval_err, "evaluation_rel_tol": eval_tol,
        "evaluation_in_process": in_process,
        "evaluation_in_process_again": again,
        "evaluation_in_process_rel_err": in_process_err,
        "evaluation_segment_launches": eval_launches,
        "evaluation_segment_parity_max_abs_err": max(
            (r["max_abs_err"] for r in eval_parity), default=None),
        "scan_premise": premise,
        "scan_stability": stability,
        "plain_run_seconds": plain_line["seconds"],
    }
    emit(row)
    if decoder != "native" or line["decoded_blocks"]["python"]:
        fail(f"score_cli: the Avro decoder was {decoder} "
             f"({line['decoded_blocks']})")
    if launches != len(plan) or line["chunks"] != len(plan):
        fail(f"score_cli: {launches} kernel launches for {len(plan)} chunks")
    if plain_launches != 0 or plain_line["serve_kernel"] != "plain":
        fail("score_cli: PHOTON_SERVE_KERNEL=off still launched the kernel")
    if len(scores) != SCORE_ROWS or not np.isfinite(scores).all():
        fail("score_cli: the output scores are not finite or not one a row")
    if not err_numpy <= 1e-5:
        fail(f"score_cli: scores differ from the numpy score by {err_numpy}")
    if not err_plain <= 1e-5:
        fail(f"score_cli: kernel and plain runs differ by {err_plain}")
    if not premise["rms_err_over_w"] <= premise["premise_sd_over_w"]:
        fail(f"score_cli: the card's f32 running sums are further from "
             f"float64 than the AUC:userId bound assumes: {premise}")
    if not all(eval_err[k] <= eval_tol[k] for k in want):
        fail(f"score_cli: evaluation.json differs from numpy: {eval_err}")
    # The evaluation's f32 sums run in a fixed order on the card (the
    # segment-sum kernel and the blocked running sum), so the CLI's
    # evaluation and two in-process ones of the same scores are equal,
    # bit for bit.
    if eval_launches <= 0 or not eval_parity:
        fail("score_cli: the evaluation did not take the segment-sum kernel")
    if evaluation != in_process or in_process != again:
        fail(f"score_cli: evaluation.json {evaluation} and evaluate_scores "
             f"on the written scores {in_process}, {again} are not equal")
    return {**timing[-1], "launches": launches, "files": files,
            "ladder_bound": ladder_bound["ladder_bound"],
            "scores": scores, "evaluation_launches": eval_launches,
            "evaluation_max_abs_err": row[
                "evaluation_segment_parity_max_abs_err"]}


# ---------------------------------------------------------------------------
# serving as operators run it: hot reloads, degraded mode, cli.serve --input
# ---------------------------------------------------------------------------

RELOAD_REQUESTS = 20_000
RELOAD_PRODUCERS = 4
DEGRADED_REQUESTS = 5_000
DEADLINE_S = 0.001
SHED_WATERMARK = 256
TRANSIENT_AT = (2, 4, 6, 8, 10)  # dispatch calls; never two in a row
POISON_AT = (1, 2, 3)
BREAKER_THRESHOLD = 3


def flood_with_reload(programs, requests, model) -> dict:
    """RELOAD_PRODUCERS threads submit ``requests`` to a live queue while
    this thread reloads ``model`` into it once a quarter was submitted.
    Returns the reload's summary, the outcome of every request, the
    queue's health and the ladder serving at the end."""
    from photon_tpu_torch.serve.queue import MicroBatchQueue

    futures: list = [None] * len(requests)
    parts = np.array_split(np.arange(len(requests)), RELOAD_PRODUCERS)
    with MicroBatchQueue(programs, max_linger_s=0.002) as queue:
        def producer(idx):
            for i in idx:
                futures[i] = queue.submit(*requests[i])

        threads = [threading.Thread(target=producer, args=(idx,))
                   for idx in parts]
        for t in threads:
            t.start()
        while queue.stats()["requests"] < len(requests) // 4:
            time.sleep(0.001)
        t0 = time.perf_counter()
        info = queue.reload_model(model)
        info["reload_seconds"] = time.perf_counter() - t0
        info["submitted_before_reload"] = queue.stats()["requests"]
        for t in threads:
            t.join(timeout=300)
        outcomes = [f.exception(timeout=300) for f in futures]
        live = queue.programs
    health = queue.health()
    return {"info": info, "served": sum(e is None for e in outcomes),
            "errors": sum(e is not None for e in outcomes),
            "health": health, "programs": live}


def outcome_counts(futures, rejected: dict) -> dict:
    """Outcomes of a drive's futures by exception name ('served' for a
    result), plus the submits the queue refused, by name."""
    out = dict(rejected)
    for f in futures:
        exc = f.exception(timeout=300)
        key = "served" if exc is None else type(exc).__name__
        out[key] = out.get(key, 0) + 1
    return out


def degraded_drive(programs, requests, plan=None, **queue_kw) -> dict:
    """Flood ``requests`` into a fresh queue over the live ladder with
    ``queue_kw``, ``plan`` (a fault plan) armed; count every outcome."""
    from photon_tpu_torch.resilience import faults
    from photon_tpu_torch.serve.queue import MicroBatchQueue

    rejected: dict = {}
    futures = []
    ctx = faults.injected(plan) if plan is not None else (
        contextlib.nullcontext())
    with ctx, MicroBatchQueue(programs, max_linger_s=0.002,
                              **queue_kw) as queue:
        for feats, ids in requests:
            try:
                futures.append(queue.submit(feats, ids))
            except RuntimeError as exc:  # typed refusals: shed, breaker
                name = type(exc).__name__
                rejected[name] = rejected.get(name, 0) + 1
        counts = outcome_counts(futures, rejected)
        health = queue.health()
        if queue_kw.get("breaker_threshold"):
            queue.reset_breaker()
            after = [queue.submit(*r) for r in requests[:RUNGS[-1]]]
            counts["served_after_reset"] = sum(
                f.exception(timeout=300) is None for f in after)
            counts["breaker_open_after_reset"] = queue.health()[
                "breaker_open"]
    return {"counts": counts, "health": health}


def cli_serve_telemetry(line, files, report, ladder_bound) -> dict:
    """Gates of ``cli.serve --telemetry --trace --request-log`` (phase
    6c(d)): every file validates; the request records the ring kept plus
    the events it dropped cover the requests served; the registry's
    outcome counters equal the queue's ``health()``; the ledger's
    ``serve/score@<rung>`` dispatches sum to the run's replays, and its
    roofline for the top rung is the count ``score_cli`` printed for it."""
    from photon_tpu_torch import obs
    from photon_tpu_torch.analysis import costmodel

    n_records = obs.validate_jsonl(files["requests.jsonl"])
    n_lines = obs.validate_jsonl(files["telemetry.jsonl"])
    n_events = obs.trace.validate_chrome_trace(files["trace.json"])
    with open(files["requests.jsonl"]) as f:
        recs = [json.loads(x) for x in f]
    header, recs = recs[0], recs[1:]
    outcomes: dict = {}
    for r in recs:
        outcomes[r["outcome"]] = outcomes.get(r["outcome"], 0) + 1
    with open(files["telemetry.jsonl"]) as f:
        counters = {r["series"]: r["value"] for r in map(json.loads, f)
                    if r["type"] == "counter"}
    health = line["health"]
    served_total = SCORE_ROWS * 2  # the main drive and the reload's
    serve_rows = {r["program"]: r for r in report["rows"]
                  if r["program"].startswith("serve/score@")}
    dispatched = sum(r["dispatches"] for r in serve_rows.values())
    replays = sum(line["dispatches"].values())
    top = f"serve/score@{RUNGS[-1]}"
    top_cost = report["programs"][top]["cost"]
    top_ms = costmodel.roofline(top_cost)["min_seconds"] * 1e3
    row = {"phase": "serve_ops", "step": "cli_serve_telemetry",
           "telemetry_lines": n_lines, "trace_events": n_events,
           "request_records": len(recs),
           "events_dropped": header["events_dropped"],
           "outcomes_retained": outcomes,
           "registry": {k: counters.get(k, 0.0) for k in (
               "serve_requests_total", "serve_deadline_expired_total",
               "serve_dispatch_retries_total", "serve_breaker_trips_total")},
           "ledger_dispatches": dispatched, "replays": replays,
           "ledger_rows": {k: {c: r[c] for c in (
               "dispatches", "seconds", "vs_roofline", "blocking")}
               for k, r in serve_rows.items()},
           "ledger_compiles": report["compiles"],
           "resident_bytes": report["resident_bytes"],
           "top_rung_roofline_ms": top_ms,
           "top_rung_ladder_bound_ms": ladder_bound["bound_ms"],
           "flight_dumps": len([f for f in os.listdir(files["flight"])
                                if f.startswith("flight-")])
           if os.path.isdir(files["flight"]) else 0}
    emit(row)
    if n_records != len(recs) + 1 or any(
            r["outcome"] != "served" for r in recs):
        fail(f"cli.serve request log: {row}")
    if len(recs) + header["events_dropped"] < served_total:
        fail(f"cli.serve: {len(recs)} request records and "
             f"{header['events_dropped']} dropped events for "
             f"{served_total} requests")
    reg = row["registry"]
    if (reg["serve_requests_total"] != health["requests"]
            or health["requests"] != served_total
            or reg["serve_deadline_expired_total"]
            != health["deadline_expired"]
            or reg["serve_dispatch_retries_total"]
            != health["dispatch_retries"]
            or reg["serve_breaker_trips_total"] != health["breaker_trips"]):
        fail(f"cli.serve: the registry's outcome counters disagree with "
             f"health() {health}: {reg}")
    if dispatched != replays or set(line["dispatches"]) != {
            str(r) for r in RUNGS} or set(report["compiles"]) != {
            f"serve/score@{r}" for r in RUNGS}:
        fail(f"cli.serve: the ledger booked {dispatched} dispatches for "
             f"{replays} replays: {row}")
    if top_ms != ladder_bound["bound_ms"]:
        fail(f"cli.serve: the ledger's rung-{RUNGS[-1]} roofline "
             f"{top_ms} ms is not the count's {ladder_bound['bound_ms']}")
    if row["flight_dumps"]:
        fail("cli.serve: a clean run left a flight dump")
    return row


def cli_serve_monitoring(line, scrapers, sketch) -> dict:
    """Gates of ``cli.serve --monitor-port 0 --health-sketch --slo-p99-ms``
    (phase 6c(d)), from its summary and the exporter's scraper: every
    scraped exposition valid and ``/healthz`` always 200; ``/readyz``
    503 while a rung's graph was not yet captured (its first probe ran
    before the model loaded), every 503 naming what was missing (the
    tables, a rung's graph, or the queue, which starts after the last
    capture: a probe between the two reads every graph captured and
    ``queue_up`` false), and 200 only once every rung's graph was
    captured and the queue was up, never 503 again; the graphs captured
    are the ladder's and every batch the queue served one replay (the
    layers add none); the tap sampled requests and the sketch holds
    them; ``slo``, ``window_latency`` and ``hot_entities`` present."""
    from photon_tpu_torch.obs import health

    if len(scrapers) != 1:
        fail(f"cli.serve --monitor-port started {len(scrapers)} exporters")
    scraper = scrapers[0]
    queue = scraper.server._collectors[0].__self__
    batches = queue.stats()["batches"]
    replays = sum(line["dispatches"].values())
    ready = scraper.readyz
    first_ok = next((i for i, (s, _) in enumerate(ready) if s == 200),
                    None)
    early = [d for s, d in ready[:first_ok] if s == 503]

    def all_captured(d):
        return d["graphs_captured"] >= len(RUNGS) and d["ladder_compiled"]

    def up(d):
        return (d["tables_loaded"] and all_captured(d) and d["queue_up"]
                and not d["breaker_open"])

    # Before the first 200 no batch has run, so the breaker is closed and
    # a 503 names the tables, a graph or the queue.
    unexplained = [(s, d) for s, d in ready[:first_ok]
                   if s != 503 or up(d) or d["breaker_open"]]
    late = [] if first_ok is None else [
        (s, d) for s, d in ready[first_ok:] if s != 200 or not up(d)]
    rows = health.DataSketch.load(sketch).rows
    row = {"phase": "serve_ops", "step": "cli_serve_monitoring",
           "scraper": scraper.summary(),
           "readyz_503_before_ready": len(early),
           "readyz_503_before_capture": sum(
               not all_captured(d) for d in early),
           "readyz_503_queue_pending": sum(
               all_captured(d) and not d["queue_up"] for d in early),
           "readyz_first_detail": ready[0][1] if ready else None,
           "monitor": line.get("monitor"),
           "graphs_captured": line["programs_compiled"],
           "queue_batches": batches, "replays": replays,
           "requests_sampled": line["health_sketch"]["requests_sampled"],
           "sketch_rows": rows, "sketch_bytes": os.path.getsize(sketch),
           "health_tap": {k: line["health_tap"][k] for k in (
               "batches_seen", "batches_sampled", "requests_sampled",
               "sample_every")},
           "slo": line.get("slo"), "window_latency": line.get(
               "window_latency"),
           "hot_entities": line.get("hot_entities")}
    emit(row)
    if scraper.errors or not scraper.expositions or set(
            scraper.healthz) != {200}:
        fail(f"cli.serve --monitor-port: scrapes {row['scraper']}")
    if (first_ok is None or not row["readyz_503_before_capture"]
            or unexplained or late):
        fail(f"cli.serve /readyz did not turn 200 exactly when the last "
             f"rung was captured and the queue was up: "
             f"{[(s, d) for s, d in ready[:3]]} ... "
             f"{row['scraper']['readyz'][-3:]}; before the first 200 "
             f"{unexplained[:3]}; from it {late[:3]}")
    if line["programs_compiled"] != len(RUNGS) or replays != batches:
        fail(f"cli.serve --monitor-port: {line['programs_compiled']} "
             f"graphs, {replays} replays for {batches} batches")
    if not 0 < row["requests_sampled"] == rows:
        fail(f"cli.serve --health-sketch sampled {row['requests_sampled']} "
             f"requests, its sketch holds {rows} rows")
    if not (line.get("slo") and line.get("window_latency")
            and line.get("hot_entities", {}).get("per-user")):
        fail(f"cli.serve: slo, window_latency or hot_entities missing: "
             f"{row}")
    return row


def run_serve_cli(argv) -> dict:
    """One ``cli.serve.main`` run in this process; its JSON line."""
    from photon_tpu_torch.cli import serve as serve_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(argv)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0:
        fail(f"cli.serve exited {rc}: errors {line.get('errors')}")
    return line


def phase_serve_ops(torch, arrays, manifest, ckpt_path, batch) -> dict:
    """Serving as the reference's operators run it, at full width with
    bf16 tables (module docstring): hot reloads under a four-producer
    flood, the degraded drives and ``cli.serve --input``."""
    from photon_tpu_torch.io.model_io import (
        game_model_from_numpy,
        load_checkpoint,
    )
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.resilience import FaultPlan, retry
    from photon_tpu_torch.serve.driver import synthetic_requests
    from photon_tpu_torch.serve.programs import ScorePrograms
    from photon_tpu_torch.serve.tables import CoefficientTables

    tables = CoefficientTables.from_game_model(
        load_checkpoint(ckpt_path), SERVE_PRECISION)
    programs = ScorePrograms(tables)
    requests = synthetic_requests(tables, programs, RELOAD_REQUESTS,
                                  cold_fraction=COLD_FRACTION, seed=11)
    launches = 0
    out: dict = {}

    def counted(fn, *a, warmups: int = 0, **kw):
        """``fn``'s replayed launches, added to the phase's count; the
        only launches from Python allowed are a new ladder's capture
        warm-ups (one eager run a rung, before its capture)."""
        nonlocal launches
        zero_serve_counts(serve_kernel)
        res = fn(*a, **kw)
        eager, replayed = serve_counts(serve_kernel)
        if eager != warmups:
            fail(f"serve_ops: {eager} kernel launches from Python in a "
                 f"drive, expected {warmups} capture warm-ups")
        launches += replayed
        return res

    # A values-only refresh: new coefficients, the same structure.
    fresh_arrays, _ = serving_arrays(SEED + 7)
    refreshed = game_model_from_numpy(fresh_arrays, manifest, "cuda")
    flood = counted(flood_with_reload, programs, requests, refreshed)
    picked = [requests[i] for i in range(0, RELOAD_REQUESTS, 313)]
    feats, codes, _ = programs.pack_requests(picked[:64])
    got = programs.score_padded(feats, codes, len(picked[:64]))
    exact = numpy_scores(torch, fresh_arrays, picked[:64], SERVE_PRECISION)
    err = float(np.abs(got - exact).max())
    info = flood["info"]
    out["values_only"] = row = {
        "phase": "serve_ops", "step": "values_only_reload", **info,
        "served": flood["served"], "errors": flood["errors"],
        "graphs": programs.stats["programs_compiled"],
        "max_abs_err_numpy_f64": err, "tol": TOL[SERVE_PRECISION]}
    emit(row)
    if not info["values_only"] or info["programs_compiled"] or (
            programs.stats["programs_compiled"] != len(RUNGS)
            or flood["programs"] is not programs):
        fail(f"serve_ops: the values-only reload recaptured: {row}")
    if flood["served"] != RELOAD_REQUESTS or flood["errors"]:
        fail(f"serve_ops: the values-only reload lost requests: {row}")
    if not err <= TOL[SERVE_PRECISION]:
        fail(f"serve_ops: scores after the values-only reload differ from "
             f"the new model's numpy score by {err}")

    # The degraded drives, on the live ladder.
    drives = {
        "deadline": dict(default_deadline_s=DEADLINE_S),
        "shed": dict(shed_watermark=SHED_WATERMARK),
        "transient": dict(plan=FaultPlan(
            [dict(point="serve.dispatch", nth=n, error="transient")
             for n in TRANSIENT_AT])),
        "breaker": dict(plan=FaultPlan(
            [dict(point="serve.dispatch", nth=n, error="poison")
             for n in POISON_AT]), breaker_threshold=BREAKER_THRESHOLD),
    }
    n = DEGRADED_REQUESTS
    for name, kw in drives.items():
        retry.reset_retry_stats()
        res = counted(degraded_drive, programs, requests[:n], **kw)
        c, h = res["counts"], res["health"]
        out[name] = row = {"phase": "serve_ops", "step": name, **c,
                           "health": h, "retry": retry.retry_stats()}
        emit(row)
        served = c.get("served", 0)
        if name == "deadline":
            ok = (h["deadline_expired"] > 0
                  and c.get("DeadlineExceededError", 0)
                  == h["deadline_expired"]
                  and served + h["deadline_expired"] == n
                  and not h["dispatch_errors"])
        elif name == "shed":
            ok = (h["shed"] > 0 and c.get("OverloadedError", 0) == h["shed"]
                  and served == n - h["shed"] and not h["dispatch_errors"])
        elif name == "transient":
            ok = (served == n and not h["dispatch_errors"]
                  and h["dispatch_retries"] == len(TRANSIENT_AT)
                  and row["retry"]["recovered"] == len(TRANSIENT_AT))
        else:
            ok = (h["breaker_trips"] == 1 and h["breaker_open"]
                  and h["dispatch_errors"] == len(POISON_AT)
                  and c.get("PoisonError", 0) > 0
                  and c.get("CircuitOpenError", 0) > 0
                  and served + c["PoisonError"] + c["CircuitOpenError"] == n
                  and c["served_after_reset"] == RUNGS[-1]
                  and not c["breaker_open_after_reset"])
        if not ok:
            fail(f"serve_ops: the {name} drive's counters do not hold: "
                 f"{row}")

    # A structure change: the 12-coordinate model of the coords phase.
    big_arrays, big_manifest = coords_arrays(arrays, manifest)
    grown = game_model_from_numpy(big_arrays, big_manifest, "cuda")
    # 12 coordinates: two launches a rung, in each warm-up too.
    flood = counted(flood_with_reload, programs, requests, grown,
                    warmups=2 * len(RUNGS))
    live = flood["programs"]
    feats, codes, _ = live.pack_requests(picked[:64])
    got = live.score_padded(feats, codes, 64)
    plain = serve_kernel.fused_score_reference(
        **live.operands(feats, codes))[:64].cpu().numpy()
    err = float(np.abs(got - plain).max())
    info = flood["info"]
    out["structure"] = row = {
        "phase": "serve_ops", "step": "structure_reload", **info,
        "served": flood["served"], "errors": flood["errors"],
        "launches_per_replay": {r: live.compile_rung(r).launches
                                for r in RUNGS},
        "max_abs_err_plain": err, "tol": TOL[SERVE_PRECISION]}
    emit(row)
    if info["values_only"] or info["programs_compiled"] != len(RUNGS):
        fail(f"serve_ops: the structure reload captured "
             f"{info['programs_compiled']} graphs: {row}")
    if flood["served"] != RELOAD_REQUESTS or flood["errors"]:
        fail(f"serve_ops: the structure reload lost requests: {row}")
    if set(row["launches_per_replay"].values()) != {2}:
        fail(f"serve_ops: 12 coordinates replay "
             f"{row['launches_per_replay']} launches, expected 2")
    if not err <= TOL[SERVE_PRECISION]:
        fail(f"serve_ops: the new ladder differs from the plain version "
             f"by {err}")
    del programs, live, flood, tables
    empty_cache()

    # cli.serve --input on score_cli's rows, with a hot reload of the
    # same model directory (values-only against the data's maps).
    files = batch["files"]
    work = os.path.dirname(files["data"])
    npy = os.path.join(work, "served.npy")
    obs_files = {k: os.path.join(work, f"serve-{k}") for k in (
        "telemetry.jsonl", "trace.json", "requests.jsonl", "flight")}
    # Its ladder (3 coordinates: one launch a rung) is captured inside
    # the counted window. The cost ledger is armed for the run (cli.serve
    # records telemetry on every run; the ledger is the caller's).
    from photon_tpu_torch.obs import ledger

    # The live monitor, the SLO tracker and the health tap ride the same
    # run, the exporter polled throughout (``scraping_monitors``).
    sketch = os.path.join(work, "serve-sketch.json")
    ledger.reset()
    ledger.enable()
    try:
        with scraping_monitors() as scrapers:
            line = counted(run_serve_cli, [
                "--model-dir", files["model_dir"], "--input", files["data"],
                "--feature-shards",
                *[f"{s}={SCORE_SHARDS[s][0]}" for s in SCORE_SHARDS],
                "--id-tags", "userId", "movieId", "--scores", npy,
                "--deadline-ms", "60000", "--shed-watermark", "1000000",
                "--breaker-threshold", "8", "--reload-model",
                files["model_dir"],
                "--telemetry", obs_files["telemetry.jsonl"],
                "--trace", obs_files["trace.json"],
                "--request-log", obs_files["requests.jsonl"],
                "--flight-dir", obs_files["flight"],
                "--monitor-port", "0", "--health-sketch", sketch,
                "--slo-p99-ms", "10"],
                warmups=len(RUNGS))
        ledger_report = ledger.report()
        # The programs as priced by that report.
        ledger_report["programs"] = ledger.snapshot()["programs"]
    finally:
        ledger.disable()
        ledger.reset()
    out["cli_telemetry"] = cli_serve_telemetry(
        line, obs_files, ledger_report, batch["ladder_bound"])
    out["cli_monitoring"] = cli_serve_monitoring(line, scrapers, sketch)
    out["health_sketch"] = sketch
    served = np.load(npy)
    rel = float(np.max(np.abs(served - batch["scores"])
                       / (1.0 + np.abs(batch["scores"]))))
    reload_info = line["reloads"][0]
    out["cli"] = row = {
        "phase": "serve_ops", "step": "cli_serve_input",
        "requests": len(served),
        **{k: line[k] for k in (
            "programs_compiled", "aot_compile_seconds",
            "graph_device_bytes", "compile_events_during_serving",
            "kernel_launches", "errors", "p50_ms", "p99_ms", "qps",
            "wall_seconds", "batches", "dispatches", "health")},
        "reload": {k: v for k, v in reload_info.items() if k != "summary"},
        "reload_drive": {k: reload_info["summary"][k] for k in (
            "errors", "p50_ms", "p99_ms", "qps")},
        "max_rel_err_score_cli": rel,
        "scores_differing_from_score_cli": int(np.sum(
            served.astype(np.float32) != batch["scores"].astype(
                np.float32)))}
    emit(row)
    replays = sum(line["dispatches"].values())
    if (len(served) != SCORE_ROWS or line["errors"]
            or reload_info["summary"]["errors"]):
        fail(f"cli.serve --input did not serve every row: {row}")
    if (line["programs_compiled"] != len(RUNGS)
            or line["compile_events_during_serving"]
            or not reload_info["values_only"]
            or reload_info["programs_compiled"]):
        fail(f"cli.serve --input captured graphs while serving: {row}")
    if (line["kernel_launches"] != replays or not rel <= 1e-5
            or row["scores_differing_from_score_cli"]):
        fail(f"cli.serve --input: {line['kernel_launches']} launches for "
             f"{replays} replays, scores {rel} from cli.score's, "
             f"{row['scores_differing_from_score_cli']} not bit for bit")
    out["launches"] = launches
    return out


# The segment-sum kernel's order of additions (``csrc/segment_sum.cu``):
# a thread's 4 elements in sequence, a 32-lane shuffle scan, the 8 warp
# totals in order, then one add into the segment's slot per chunk of
# 1,024 elements; a segment of L elements meets at most
# 3 + 5 + 7 + ceil(L / 1024) + 1 additions on any path.
SEGMENT_ORDER_DEPTH = 16
SEGMENT_CHUNK = 1024


def evaluation_segment_check(torch, sr, name, vals, ids, n) -> dict:
    """The kernel twice against its plain version on one of the
    evaluation's inputs. The plain version runs in float64 (its f32
    ``index_add_`` rounds at each of a segment's L atomic adds, in an
    order that changes from run to run), and the kernel is held within
    the rounding of its own order of additions:
    |got - exact| <= (SEGMENT_ORDER_DEPTH + ceil(L / 1024)) u sum |v|."""
    got = sr.segment_sum(vals, ids, n, site="parity")
    again = sr.segment_sum(vals, ids, n, site="parity")
    torch.cuda.synchronize()
    exact = sr.sorted_segment_sum_plain(vals.double(), ids, n)
    mag = sr.sorted_segment_sum_plain(vals.double().abs(), ids, n)
    length = sr.sorted_segment_sum_plain(
        torch.ones_like(vals, dtype=torch.float64), ids, n)
    bound = (SEGMENT_ORDER_DEPTH + torch.ceil(length / SEGMENT_CHUNK)) \
        * F32_U * mag
    diff = (got.double() - exact).abs()
    plain_diff = (sr.sorted_segment_sum_plain(vals, ids, n).double()
                  - exact).abs()
    row = {"phase": "segment_parity", "input": name,
           "values": int(vals.shape[0]), "segments": int(n),
           "longest_segment": int(length.max()),
           "max_abs_err": float(diff.max()),
           "max_err_over_bound": float(torch.where(
               diff == 0, 0.0, diff / bound).max()),
           "plain_f32_max_abs_err": float(plain_diff.max()),
           "bit_identical_runs": bool(torch.equal(got, again)),
           "finite": bool(got.isfinite().all())}
    emit(row)
    if not (row["max_err_over_bound"] <= 1.0 and row["bit_identical_runs"]
            and row["finite"]):
        fail(f"the segment-sum kernel disagrees with its plain version or "
             f"with itself on the evaluation's input: {row}")
    return row


class _EvaluationInputs:
    """Records the operands of every segment sum (``segments``: values,
    int32 ids, n) and running sum (``scans``) the evaluators take while
    active."""

    def __enter__(self):
        import torch
        from photon_tpu_torch.evaluation import evaluators

        self.segments, self.scans = [], []
        self._mod = evaluators
        self._real = (evaluators._segment_sum, evaluators.running_sum)
        segment_sum, running_sum = self._real

        def segment_spy(values, ids, n):
            self.segments.append((values.contiguous(),
                                  ids.to(torch.int32).contiguous(), int(n)))
            return segment_sum(values, ids, n)

        def scan_spy(x):
            self.scans.append(x.clone())
            return running_sum(x)

        evaluators._segment_sum, evaluators.running_sum = (segment_spy,
                                                           scan_spy)
        return self

    def __exit__(self, *exc):
        self._mod._segment_sum, self._mod.running_sum = self._real
        return False


SCAN_RUNS = 100


def scan_stability(torch, scans) -> list:
    """Whether the card's 1-D ``torch.cumsum`` repeats itself bit for bit
    on the evaluation's running-sum operands: per operand, SCAN_RUNS runs
    each of the f32 cumsum, the float64 cumsum (its float64 bits, and
    rounded to f32) and the evaluators' ``blocked_running_sum``, every
    other run beside a matmul on a second stream (to move the scan's
    timing); the count of runs that differ from the first of their
    kind, and the largest difference. An f32 operand's float64 sums are
    exact while its values span fewer than 53 - log2(n) bits, whatever
    the order; the ``_wide`` kinds scale it by a fixed factor in [1, 2)
    drawn in float64, so that its values carry 53 bits, as a float64
    evaluation's do."""
    from photon_tpu_torch.evaluation.evaluators import blocked_running_sum

    side = torch.cuda.Stream()
    big = torch.randn(4096, 4096, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kinds = {"cumsum_f32": lambda x: torch.cumsum(x, 0),
             "cumsum_f64": lambda x: torch.cumsum(x.double(), 0),
             "cumsum_f64_to_f32": lambda x: torch.cumsum(
                 x.double(), 0).to(x.dtype),
             "blocked_f64": lambda x: blocked_running_sum(x.double()),
             "cumsum_f64_wide": lambda x: torch.cumsum(wide, 0),
             "blocked_f64_wide": lambda x: blocked_running_sum(wide)}
    out = []
    for x in scans:
        wide = x.double() * (1.0 + torch.rand(
            x.shape, generator=gen, dtype=torch.float64, device=x.device))
        row = {"n": int(x.shape[0]), "dtype": str(x.dtype)[6:],
               "runs": SCAN_RUNS}
        for name, fn in kinds.items():
            first, differ, worst = fn(x), 0, 0.0
            for r in range(1, SCAN_RUNS):
                if r % 2:
                    side.wait_stream(torch.cuda.current_stream())
                    with torch.cuda.stream(side):
                        big @ big
                got = fn(x)
                if not torch.equal(got, first):
                    differ += 1
                    worst = max(worst, float((got.double() - first.double())
                                             .abs().max()))
            torch.cuda.synchronize()
            row[name] = {"runs_differing": differ, "max_abs_diff": worst}
        out.append(row)
    emit({"phase": "score_cli_scan_stability", "operands": out})
    return out


# ---------------------------------------------------------------------------
# training: the bench's logistic GLMix at full width, float32
# ---------------------------------------------------------------------------

TRAIN_SEED = 20260729
TRAIN_ROWS, TRAIN_FEATURES = 4_000_000, 64
USER_FEATURES, MOVIE_FEATURES = 16, 8  # + the bias slot each
REDUCED = dict(n_rows=400_000, n_users=10_000, n_movies=2_000)
CD_ITERATIONS = 4
# The kernel against its plain version on the card, both f32: the same
# arithmetic with the sums taken in another order. Over a whole bucket
# (1.7 million user coefficients) the f32 plain version itself is up to
# 1.6e-4 from a float64 step in g, so the two are held against the
# float64 step, and rtol 1e-4 / atol 1e-5 between them is reported.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
# An objective change within this relative size is f32 round-off.
ROUND_OFF = 1e-5
# The kernel-route fit against the plain-route fit: the fixed effect
# within rtol 1e-3 / atol 1e-4. A per-entity solve in f32 stops where
# its objective F no longer resolves an improvement, about 4 eps F; with
# F ~ 0.6 R (logistic, R rows) and curvature h ~ 0.2 R + l2, two f32
# solves of one entity can end sqrt(2 * 4 eps F / h) ~ sqrt(24 eps)
# ~ 1.2e-3 apart in any coefficient, whichever route they take. The
# random effects are held at twice that; how many coefficients are
# outside rtol 1e-3 / atol 1e-4 is reported beside it.
FIT_RTOL, FIT_ATOL = 1e-3, 1e-4
RE_FIT_ATOL = 2e-3
NEWTON_STEPS = 3
SERVE_ROWS = 512
NEWTON_REPLACES = "photon_tpu/ops/newton_kernel.py:225"


def synth_arrays(n_rows=TRAIN_ROWS, n_users=N_USERS, n_movies=N_MOVIES,
                 seed=TRAIN_SEED):
    """The bench's MovieLens-shaped logistic workload as numpy, drawn in
    the bench's order (``bench.py:_synth_arrays``), plus the generating
    margin (the Bayes-optimal score)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, TRAIN_FEATURES)).astype(np.float32)
    x[:, -1] = 1.0
    xu = rng.normal(size=(n_rows, USER_FEATURES + 1)).astype(np.float32)
    xu[:, -1] = 1.0
    xm = rng.normal(size=(n_rows, MOVIE_FEATURES + 1)).astype(np.float32)
    xm[:, -1] = 1.0
    users = rng.integers(0, n_users, size=n_rows)
    movies = rng.integers(0, n_movies, size=n_rows)
    w = rng.normal(size=TRAIN_FEATURES).astype(np.float32) * 0.3
    wu = rng.normal(size=(n_users, USER_FEATURES + 1)).astype(
        np.float32) * 0.3
    wm = rng.normal(size=(n_movies, MOVIE_FEATURES + 1)).astype(
        np.float32) * 0.2
    z = (x @ w + np.einsum("nd,nd->n", xu, wu[users])
         + np.einsum("nd,nd->n", xm, wm[movies]))
    y = (rng.uniform(size=n_rows) < 1.0 / (1.0 + np.exp(-0.5 * z))).astype(
        np.float32)
    return dict(x=x, xu=xu, xm=xm, users=users, movies=movies, y=y, z=z)


def train_dataset(arrays, dtype=None, device="cuda"):
    """The arrays on the card (or ``device``), in float32 unless
    ``dtype`` says otherwise (a float64 dataset trains in float64, on the
    plain route)."""
    from photon_tpu_torch.data.dataset import DenseFeatures
    from photon_tpu_torch.data.game_data import make_game_dataset

    extra = {} if dtype is None else {"dtype": dtype}
    return make_game_dataset(
        arrays["y"],
        {"global": DenseFeatures(arrays["x"]),
         "userShard": DenseFeatures(arrays["xu"]),
         "movieShard": DenseFeatures(arrays["xm"])},
        id_tags={"userId": arrays["users"], "movieId": arrays["movies"]},
        device=device, **extra,
    )


def build_estimator(task_name="logistic", movie=None, intercepts=None,
                    device=None, precision="float32"):
    """The bench's ``build_estimator(task_name)``, in float32 unless
    ``precision`` says otherwise (the bench's own default is bf16).
    ``movie`` replaces the per-movie data configuration and
    ``intercepts`` the intercept indices."""
    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm.problems import (
        GLMOptimizationConfiguration,
    )
    from photon_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
    )
    from photon_tpu_torch.estimators.game_estimator import (
        FixedEffectCoordinateConfiguration,
        GameEstimator,
        RandomEffectCoordinateConfiguration,
    )
    from photon_tpu_torch.types import TaskType

    def l2(weight):
        return GLMOptimizationConfiguration(
            regularization=optim.RegularizationContext(
                optim.RegularizationType.L2),
            regularization_weight=weight)

    return GameEstimator(
        TaskType.LOGISTIC_REGRESSION if task_name == "logistic"
        else TaskType.LINEAR_REGRESSION,
        {
            "global": FixedEffectCoordinateConfiguration("global", l2(1e-3)),
            "per-user": RandomEffectCoordinateConfiguration(
                RandomEffectDataConfiguration(
                    "userId", "userShard", active_data_upper_bound=512,
                    min_bucket_entities=128),
                l2(1.0)),
            "per-movie": RandomEffectCoordinateConfiguration(
                movie or RandomEffectDataConfiguration(
                    "movieId", "movieShard", active_data_upper_bound=2048,
                    min_bucket_entities=128),
                l2(1.0)),
        },
        intercept_indices=intercepts or {"global": TRAIN_FEATURES - 1,
                                         "userShard": USER_FEATURES,
                                         "movieShard": MOVIE_FEATURES},
        num_iterations=CD_ITERATIONS,
        precision=precision,
        device=device,
    )


RE_IDS = ("per-user", "per-movie")


def l2_weight(est, cid) -> float:
    return est.coordinate_configs[cid].optimization.l2_weight


def newton_operands(torch, eb, l2w: float) -> dict:
    """The Newton step's operands for one cached bucket as the solver
    forms them at its start: w = 0, no residuals, no normalization, no
    prior."""
    from photon_tpu_torch.ops import losses

    x = eb.x_values.contiguous()
    off = eb.offsets
    b, _, s = x.shape
    w = torch.zeros((b, s), dtype=x.dtype, device=x.device)
    l2 = (l2w * eb.penalty_mask).contiguous()
    z = torch.einsum("brs,bs->br", x, w) + off
    f = torch.sum(eb.weights * losses.LOGISTIC.loss(z, eb.labels), dim=-1)
    return dict(x=x, w=w, y=eb.labels.contiguous(),
                wt=eb.weights.contiguous(), off=off.contiguous(), l2=l2,
                mt=torch.zeros_like(w), vm=eb.valid_mask.contiguous(),
                f=f.contiguous())


def step_args(ops):
    return tuple(ops[k] for k in ("x", "w", "y", "wt", "off", "l2", "mt",
                                  "vm", "f"))


def max_or_zero(t) -> float:
    return float(t.max()) if t.numel() else 0.0


def phase_newton_parity(torch, datasets, est) -> dict:
    """Three Newton steps on the largest user bucket and the largest
    movie bucket: the CUDA kernel, the plain version in f32 and the
    plain version in float64, all from the same state on the card (each
    step starts from the f32 plain version's iterate).

    The kernel must be as accurate as the plain version: its largest
    error against the float64 step at most twice the f32 plain
    version's, plus STEP_ATOL, for w, f and g; and ``improved`` equal
    to the plain version's. How far kernel and plain are apart, and how
    many values lie outside rtol STEP_RTOL / atol STEP_ATOL of each
    other, is reported. An entity whose objective moved by no more than
    f32 round-off on both sides is near its optimum, where the order of
    the sums decides whether and how far it steps; such entities are
    counted and left out (none may be on the first step).
    """
    worst = 0.0
    rows = []
    for cid in RE_IDS:
        blocks = datasets[cid].device_blocks()
        eb = max(blocks, key=lambda b: b.num_entities)
        w, r = newton_parity_steps(torch, cid, eb, l2_weight(est, cid))
        worst = max(worst, w)
        rows += r
    return {"max_abs_err": worst, "rows": rows}


def newton_parity_steps(torch, cid, eb, l2w, phase="newton_parity"):
    """Three Newton steps on one dense bucket, as ``phase_newton_parity``
    checks them; returns (largest kernel-plain difference, rows)."""
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    worst = 0.0
    rows = []
    ops = newton_operands(torch, eb, l2w)
    for k in range(NEWTON_STEPS):
        args = step_args(ops)
        got = nk.newton_step(*args, task=task)
        torch.cuda.synchronize()
        want = nk.newton_step_plain(*args, task=task)
        ref = nk.newton_step_plain(*(a.double() for a in args),
                                   task=task)
        torch.cuda.synchronize()
        f_prev = ops["f"]

        def moved(f_new):
            return ((f_new - f_prev).abs()
                    > ROUND_OFF * (f_prev.abs() + 1.0))

        keep = moved(got[1]) | moved(want[1])
        # Counted in integers: a float32 mean of B ones on the card
        # (a sum times 1/B) need not be exactly 1.
        n_keep = int(keep.sum())
        disagree = int((got[3] != want[3])[keep].sum())
        row = {"phase": phase, "coordinate": cid,
               "bucket": list(eb.x_values.shape), "step": k + 1,
               "near_optimum_entities": int((~keep).sum()),
               "improved_agreement": (1.0 - disagree / n_keep
                                      if n_keep else 1.0),
               "improved_disagreements": disagree,
               "improved_fraction": int(want[3].sum()) / want[3].numel()}
        ok = disagree == 0
        for name, a, b, c in zip(("w", "f", "g"), got[:3], want[:3],
                                 ref[:3]):
            a, b, c = a[keep], b[keep], c[keep]
            diff = (a - b).abs()
            k_err = max_or_zero((a.double() - c).abs())
            p_err = max_or_zero((b.double() - c).abs())
            row[f"max_abs_diff_{name}"] = max_or_zero(diff)
            row[f"outside_tol_{name}"] = int(
                (diff > STEP_ATOL + STEP_RTOL * b.abs()).sum())
            row[f"kernel_err_f64_{name}"] = k_err
            row[f"plain_err_f64_{name}"] = p_err
            worst = max(worst, row[f"max_abs_diff_{name}"])
            ok = (ok and bool(a.isfinite().all())
                  and k_err <= 2.0 * p_err + STEP_ATOL)
        row["values"] = int(want[0][keep].numel())
        emit(row)
        rows.append(row)
        if not ok:
            fail(f"the Newton kernel is less accurate than its plain "
                 f"version against float64 ({cid}, step {k + 1})")
        if k == 0 and row["near_optimum_entities"]:
            fail(f"{cid}: entities at round-off on the first step")
        ops = dict(ops, w=want[0], f=want[1])
    return worst, rows


def bucket_launches(stats_history, datasets) -> dict:
    """Newton-step launches per bucket shape over a fit: each RE solve
    runs one launch per iteration of its slowest entity in the bucket."""
    out: dict = {}
    for rec in stats_history:
        if rec.coordinate_id not in RE_IDS:
            continue
        it = rec.diagnostics.iterations
        start = 0
        for eb in datasets[rec.coordinate_id].device_blocks():
            n = eb.num_entities
            key = (rec.coordinate_id, tuple(eb.x_values.shape))
            out[key] = out.get(key, 0) + int(it[start:start + n].max())
            start += n
    return out


def total_scores(torch, model, datasets, data):
    """The trainer's own score of every row: fixed effect plus each
    random effect, with its per-coordinate parts."""
    parts = {"global": model["global"].model.coefficients.compute_score(
        data.feature_shards["global"])}
    for cid in RE_IDS:
        parts[cid] = model[cid].score_dataset(datasets[cid])
    total = sum(parts.values())
    return total, parts


def auc(score: np.ndarray, y: np.ndarray) -> float:
    order = np.argsort(score, kind="stable")
    ranks = np.empty(score.shape[0], dtype=np.float64)
    ranks[order] = np.arange(1, score.shape[0] + 1)
    pos = y > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def fit_trajectory(torch, est, data) -> tuple[dict, object]:
    """One ``GameEstimator.fit`` with the counts zeroed just before: its
    wall seconds (ending in a sync), per CD iteration and coordinate
    (None for a fused fit: one graph runs the whole fit), and its
    trajectory: L-BFGS and Newton iterations, Newton-kernel launches
    made from Python (a fused fit's replay makes none: its launches are
    counted by ``fused_fit_row``), plain-route solves, host syncs."""
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.optim import batched, lbfgs

    nk.launches = 0
    ra.host_syncs = ra.plain_route_solves = 0
    lbfgs.host_syncs = batched.host_syncs = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = est.fit(data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    res = results[0]
    hist = res.descent.history
    timed = all(r.seconds is not None for r in hist)
    row = {
        "fit_seconds": fit_s,
        "fused": est._fused_cache is not None and est.emitter is None,
        "seconds_per_cd_iteration": [
            sum(r.seconds for r in hist if r.iteration == i)
            for i in range(CD_ITERATIONS)] if timed else None,
        "seconds_per_coordinate": {
            cid: sum(r.seconds for r in hist if r.coordinate_id == cid)
            for cid in est.update_sequence} if timed else None,
        "fe_lbfgs_iterations": [int(r.diagnostics.iterations) for r in hist
                                if r.coordinate_id == "global"],
        "re_newton_iterations_max": {
            cid: [r.diagnostics.iterations_max for r in hist
                  if r.coordinate_id == cid] for cid in RE_IDS},
        "newton_kernel_launches": nk.launches,
        "plain_route_solves": ra.plain_route_solves,
        "newton_host_syncs": ra.host_syncs,
        "lbfgs_host_syncs": lbfgs.host_syncs,
        "batched_host_syncs": batched.host_syncs,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    return row, res


@contextlib.contextmanager
def unfused(est):
    """``est`` on its unfused loop: a no-op listener, as the reference's
    tests/test_fused_fit.py forces it."""
    from photon_tpu_torch.events import EventEmitter

    saved = est.emitter
    est.emitter = EventEmitter([lambda e: None])
    try:
        yield est
    finally:
        est.emitter = saved


# Warm replays of the fused fit in phase ``fit``, and in ``fit_bf16``,
# whose fits run 100 Newton iterations (8.7 s each at full width on an
# H100 80GB HBM3 at 700 W).
FUSED_WARM, BF16_WARM = 3, 1
# The fused fit against the unfused one on the card, f32: the fixed
# effect's L-BFGS runs as batched.lbfgs in the fused fit and as the
# host-branching lbfgs.py in the unfused one (two designs, the same
# float64 iterates), so the f32 solves stop apart by at most the bounds
# of an f32 solve against float64 that ROADMAP Queue C states.
FUSED_FE_ATOL, FUSED_RE_ATOL = 5e-4, 2e-3


def fused_bucket_launches(stats_history, datasets) -> dict:
    """Newton-step launches per bucket shape over a fused fit: its
    diagnostics hold each entity's iterations in entity-code order, and
    a bucket's WHILE node runs one launch per iteration of its slowest
    entity."""
    out: dict = {}
    for rec in stats_history:
        if rec.coordinate_id not in RE_IDS:
            continue
        it = rec.diagnostics.iterations
        for eb in datasets[rec.coordinate_id].device_blocks():
            key = (rec.coordinate_id, tuple(eb.x_values.shape))
            codes = eb.entity_codes.cpu().numpy()
            out[key] = out.get(key, 0) + int(it[codes].max())
    return out


def model_diffs(torch, a, b) -> dict:
    """Largest coefficient difference per coordinate of two models."""
    out = {}
    for cid in ("global",) + RE_IDS:
        x = (a[cid].model.coefficients.means if cid == "global"
             else a[cid].coefficients)
        y = (b[cid].model.coefficients.means if cid == "global"
             else b[cid].coefficients)
        out[cid] = float((x - y).abs().max())
    return out


def fused_fit_row(torch, est, data, datasets, unfused_row, unfused_res
                  ) -> dict:
    """The fused fit: cold (its capture), then ``FUSED_WARM`` warm
    replays, each under ``torch.cuda.set_sync_debug_mode("error")`` (a
    host sync anywhere in ``est.fit`` raises), its Newton launches read
    from the device counters (``device_loop.count_graph_launches``:
    ``torch.profiler`` reports a kernel inside a WHILE body once a
    replay, not once an iteration); then the same fit function run
    eagerly on the same operands (``FusedFit._fit_fn``, the graph's
    eager twin: the same solvers, the loops Python loops). Gates: the
    capture succeeded; no solver counted a sync and none was made; each
    replay's Newton launches equal its diagnostics' count and the eager
    twin's, and its model equals the twin's bit for bit; the models
    equal the unfused fit's, bit for bit or within ``FUSED_FE_ATOL`` /
    ``FUSED_RE_ATOL``. The unfused fit's Newton launches are printed
    beside the fused fit's, not gated equal: its fixed effect runs
    ``lbfgs.py``, whose f32 iterates differ from ``batched.lbfgs``'s
    in the last bits, and an entity at a convergence boundary then
    stops one Newton iteration apart (the iterations are printed)."""
    from photon_tpu_torch.utils import device_loop

    device_loop.reset_graph_launches()
    cold, res = fit_trajectory(torch, est, data)
    cold_replayed = device_loop.graph_launches("newton_step")
    if not cold["fused"]:
        fail("phase fit: the estimator did not take the fused path")
    ff = next(iter(est._fused_cache.values()))
    cap = ff.captured()
    if cap is None:
        fail("phase fit: the fused fit captured no graph")
    warm = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(FUSED_WARM):
        from photon_tpu_torch.algorithm import random_effect as ra
        from photon_tpu_torch.optim import batched, lbfgs

        device_loop.reset_graph_launches()
        before = (ra.host_syncs, batched.host_syncs, lbfgs.host_syncs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = est.fit(data)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        warm.append({"seconds": time.perf_counter() - t0,
                     "dispatch_seconds": t1 - t0,
                     "solver_syncs": [a - b for a, b in zip(
                         (ra.host_syncs, batched.host_syncs,
                          lbfgs.host_syncs), before)],
                     "newton_launches": device_loop.graph_launches(
                         "newton_step"),
                     "segment_launches": device_loop.graph_launches(
                         "segment_sum")})
    peak = torch.cuda.max_memory_allocated()
    by_bucket = fused_bucket_launches(res.descent.history, datasets)
    per_fit = [w["newton_launches"] for w in warm]
    twin, twin_launches = eager_twin(torch, est, datasets, ff)
    twin_equal = model_arrays_equal(res.model, twin)
    diffs = model_diffs(torch, res.model, unfused_res.model)
    bit_equal = model_arrays_equal(res.model, unfused_res.model)
    row = {"phase": "fused_fit",
           "cold_seconds": cold["fit_seconds"],
           "capture_seconds": cap.seconds,
           "instantiate_seconds": cap.instantiate_seconds,
           "graph_nodes": cap.nodes,
           "conditional_nodes": cap.conditional_nodes,
           "graphs_captured": len(ff._graphs),
           "warm": warm,
           "warm_seconds": [w["seconds"] for w in warm],
           "unfused_warm_seconds": unfused_row["fit_seconds"],
           "solver_syncs_warm": [w["solver_syncs"] for w in warm],
           "newton_launches_per_replay": per_fit,
           "newton_launches_cold_replay": cold_replayed,
           "segment_launches_per_replay": [w["segment_launches"]
                                           for w in warm],
           "newton_launches_by_bucket": {
               f"{c}:{'x'.join(map(str, s))}": n
               for (c, s), n in by_bucket.items()},
           "newton_launches_unfused": unfused_row["newton_kernel_launches"],
           "newton_launches_eager_twin": twin_launches,
           "eager_twin_bit_identical": twin_equal,
           "re_newton_iterations_max_unfused":
               unfused_row["re_newton_iterations_max"],
           "fe_lbfgs_iterations": cold["fe_lbfgs_iterations"],
           "fe_lbfgs_iterations_unfused":
               unfused_row["fe_lbfgs_iterations"],
           "re_newton_iterations_max": cold["re_newton_iterations_max"],
           "capture_newton_launches": cold["newton_kernel_launches"],
           "max_memory_allocated_bytes_cold":
               cold["max_memory_allocated_bytes"],
           "max_memory_allocated_bytes_warm": peak,
           "max_memory_allocated_bytes_unfused":
               unfused_row["max_memory_allocated_bytes"],
           "max_abs_coefficient_diff": diffs,
           "models_bit_identical": bit_equal,
           "bounds": {"global": FUSED_FE_ATOL, "random": FUSED_RE_ATOL}}
    emit(row)
    if any(any(w["solver_syncs"]) for w in warm):
        fail(f"phase fit: a warm fused fit counted solver syncs: {row}")
    if any(n != sum(by_bucket.values()) for n in per_fit + [cold_replayed]):
        fail(f"phase fit: the replays launched {per_fit} Newton steps, "
             f"their diagnostics say {sum(by_bucket.values())}")
    if any(n != twin_launches for n in per_fit) or not twin_equal:
        fail(f"phase fit: the replays launched {per_fit} Newton steps and "
             f"its eager twin {twin_launches}; bit-identical models: "
             f"{twin_equal}")
    if not bit_equal and (
            diffs["global"] > FUSED_FE_ATOL
            or max(diffs[c] for c in RE_IDS) > FUSED_RE_ATOL):
        fail(f"phase fit: the fused and unfused models differ beyond "
             f"{FUSED_FE_ATOL} / {FUSED_RE_ATOL}: {diffs}")
    return dict(row, result=res,
                replayed_newton_launches=cold_replayed + sum(per_fit))


def eager_twin(torch, est, datasets, ff) -> tuple:
    """The fused fit's function run eagerly (no graph) on the operands
    of ``est``'s current configuration: (its model, the Newton launches
    the wrapper counted)."""
    from photon_tpu_torch.ops import newton_kernel as nk

    coords = est._build_coordinates(datasets, {}, {})
    ops = ff._operands(coords, None)
    statics = ff._statics(coords, None)
    before = nk.launches
    states = ff._fit_fn(ops, est._fused_mat_share["ebs"], statics)[0]
    torch.cuda.synchronize()
    return ff.models(coords, states), nk.launches - before


def phase_fit(torch, arrays, data, est) -> dict:
    """GameEstimator.fit at full width: the unfused fit (a no-op
    listener; counts zeroed just before) twice, the second warm; then
    the fused fit (``fused_fit_row``) against it; then both once more
    with telemetry, the cost ledger and health on (``fit_telemetry``,
    ``fused_telemetry``). The fused fit's fixed effect runs
    ``batched.lbfgs``, the unfused one ``lbfgs.py``: their comparison
    took the place of ``fe_lbfgs_designs`` (the two designs on one
    recorded solve), cut for the script's time."""
    from photon_tpu_torch.utils import device_loop

    with unfused(est):
        traj, res = fit_trajectory(torch, est, data)
        row = {"phase": "fit", "rows": int(arrays["y"].shape[0]), **traj}
        emit(row)
        warm, res = fit_trajectory(torch, est, data)
        emit({"phase": "fit", "warm": True, **warm})
    if row["newton_kernel_launches"] <= 0:
        fail("the fit launched the Newton kernel no time")
    if row["plain_route_solves"] != 0:
        fail(f"{row['plain_route_solves']} bucket solves took the plain route")
    if warm["newton_kernel_launches"] != row["newton_kernel_launches"]:
        fail("the warm unfused fit launched otherwise than the first")
    datasets, _ = est.prepare(data)
    fused = fused_fit_row(torch, est, data, datasets, warm, res)
    with unfused(est):
        fit_telemetry(torch, est, data, warm, res)
    device_loop.reset_graph_launches()
    fused_telemetry(torch, est, data, fused["result"])
    # The Newton launches the fused fits made: the eager pass before the
    # capture through the wrapper (the cold fit's count less what the
    # capture recorded), then every replay on the device counters.
    cap = next(iter(est._fused_cache.values())).captured()
    eager_before_capture = (fused["capture_newton_launches"]
                            - sum(cap.newton.values()))
    fused_launches = (eager_before_capture
                      + fused["replayed_newton_launches"]
                      + device_loop.graph_launches("newton_step"))
    return {"row": row, "result": res, "fused": fused,
            "unfused_launches": row["newton_kernel_launches"]
            + 2 * warm["newton_kernel_launches"],
            "fused_newton_launches": fused_launches}


# bf16 against f32: the reference's logistic tolerance
# (tests/test_precision.py:145-150), by its ``_rel_err``.
BF16_RTOL = 2e-2


def bf16_fused_bounds(torch, unfused_model, zmax: float) -> dict:
    """Per coordinate, how far the bf16 fused fit may lie from the bf16
    unfused loop (largest absolute coefficient difference). The two
    differ by the fused fit's bf16 score carries (the unfused loop's
    are f32): a carry rounded to bf16 moves each row's offset by at most
    2^-9 of the largest score ``zmax``, which moves an entity's
    coefficients (its intercept first) by at most as much; and the
    margins read each coefficient rounded to bf16, so a solve stops
    within one bf16 step, 2^-8 of the coordinate's largest coefficient,
    of where the other stops."""
    out = {}
    for cid in ("global",) + RE_IDS:
        w = (unfused_model[cid].model.coefficients.means if cid == "global"
             else unfused_model[cid].coefficients)
        out[cid] = 2.0 ** -8 * float(w.abs().max()) + 2.0 ** -9 * zmax
    return out


def rel_err(torch, a, b) -> float:
    """The reference's ``_rel_err``: the largest absolute difference over
    the largest magnitude of ``b``."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-9)


def model_rel_errs(torch, a, b) -> dict:
    out = {}
    for cid in ("global",) + RE_IDS:
        x = (a[cid].model.coefficients.means if cid == "global"
             else a[cid].coefficients)
        y = (b[cid].model.coefficients.means if cid == "global"
             else b[cid].coefficients)
        out[cid] = rel_err(torch, x, y)
    return out


def model_finite(torch, m) -> bool:
    return all(bool(torch.isfinite(
        m[cid].model.coefficients.means if cid == "global"
        else m[cid].coefficients).all()) for cid in ("global",) + RE_IDS)


def phase_fit_bf16(torch, arrays, data, est16, est32, fit32,
                   f32_auc: float) -> dict:
    """Phase 9a (docstring): the bf16 estimator's fits on the same data,
    its first fused fit on the graph its prepare captured."""
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.data import pipeline
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.optim import batched, lbfgs
    from photon_tpu_torch.utils import compile_cache, device_loop

    datasets, _ = est16.prepare(data)
    device_loop.reset_graph_launches()
    first, first_res = fit_trajectory(torch, est16, data)
    report = pipeline.PIPELINE_STATS.report()
    first_replayed = device_loop.graph_launches("newton_step")
    ff = next(iter(est16._fused_cache.values()))
    cap = ff.captured()
    graphs_first = len(ff._graphs)
    warm = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(BF16_WARM):
        device_loop.reset_graph_launches()
        before = (ra.host_syncs, batched.host_syncs, lbfgs.host_syncs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = est16.fit(data)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        warm.append({"seconds": time.perf_counter() - t0,
                     "solver_syncs": [a - b for a, b in zip(
                         (ra.host_syncs, batched.host_syncs,
                          lbfgs.host_syncs), before)],
                     "newton_launches": device_loop.graph_launches(
                         "newton_step")})
    peak = torch.cuda.max_memory_allocated()
    twin, twin_launches = eager_twin(torch, est16, datasets, ff)
    # A warm start within a generation (a two-configuration sequence,
    # the second seeded by the first: a lambda grid's re-entry), at a
    # tenth of the rows and entities: its twin's capture runs the whole
    # bf16 fit eagerly first, ~12 s at full width.
    small = train_dataset(synth_arrays(**REDUCED))
    est_small = build_estimator(precision="bfloat16")
    est_small.fit(small)
    keys = set(est_small._fused_cache)
    est_small.fit(small, opt_config_sequence=[{}, {}])
    warm_start_keys = set(est_small._fused_cache)
    del est_small, small
    with unfused(est16):
        unf, unf_res = fit_trajectory(torch, est16, data)
    n_buckets = sum(len(datasets[cid].blocks) for cid in RE_IDS)
    ff32 = next(iter(est32._fused_cache.values()))
    m32 = fit32["fused"]["result"].model
    total, _ = total_scores(torch, res.model, datasets, data)
    score = total.double().cpu().numpy()
    unf_total, _ = total_scores(torch, unf_res.model, datasets, data)
    fused_bounds = bf16_fused_bounds(torch, unf_res.model,
                                     float(unf_total.abs().max()))
    stats = compile_cache.cache_stats()
    row = {"phase": "fit_bf16",
           "first_seconds": first["fit_seconds"],
           "compile_seconds": report["compile_seconds"],
           "compile_wait_seconds": report["compile_wait_seconds"],
           "compile_overlap_fraction": report["compile_overlap_fraction"],
           "graph_adopted": bool(cap is not None and cap.adopted),
           # After the first fit (the warm start's twin adds one later).
           "graphs_after_first_fit": graphs_first,
           "capture_seconds": None if cap is None else cap.seconds,
           "instantiate_seconds": (None if cap is None
                                   else cap.instantiate_seconds),
           "graph_nodes": None if cap is None else cap.nodes,
           "conditional_nodes": (None if cap is None
                                 else cap.conditional_nodes),
           "warm_seconds": [w["seconds"] for w in warm],
           "solver_syncs_warm": [w["solver_syncs"] for w in warm],
           "unfused_seconds": unf["fit_seconds"],
           "newton_kernel_launches": {
               "first_replay": first_replayed,
               "first_python": first["newton_kernel_launches"],
               "warm_replays": [w["newton_launches"] for w in warm],
               "eager_twin": twin_launches,
               "unfused": unf["newton_kernel_launches"]},
           "routing": "batch-minor loop (the Newton kernel takes f32 only)",
           "re_newton_iterations_max": first["re_newton_iterations_max"],
           "re_newton_iterations_max_unfused":
               unf["re_newton_iterations_max"],
           "re_newton_iterations_max_f32":
               fit32["fused"]["re_newton_iterations_max"],
           "fe_lbfgs_iterations": first["fe_lbfgs_iterations"],
           "plain_route_solves_unfused": unf["plain_route_solves"],
           "bucket_solves_unfused": n_buckets * CD_ITERATIONS,
           "slab_bytes": ff.slab_nbytes(),
           "slab_bytes_f32": ff32.slab_nbytes(),
           "rel_err_vs_f32": model_rel_errs(torch, res.model, m32),
           "rel_err_fused_vs_unfused": model_rel_errs(torch, res.model,
                                                      unf_res.model),
           "max_abs_diff_fused_vs_unfused": model_diffs(torch, res.model,
                                                        unf_res.model),
           "eager_twin_bit_identical": (
               model_arrays_equal(first_res.model, twin)
               and model_arrays_equal(res.model, twin)),
           "warm_start_adds_no_key": warm_start_keys == keys,
           "cache_stats": stats,
           "max_memory_allocated_bytes_warm": peak,
           "max_memory_allocated_bytes_first":
               first["max_memory_allocated_bytes"],
           "train_auc": auc(score, arrays["y"]),
           "train_auc_f32": f32_auc,
           "bounds": {"vs_f32": BF16_RTOL,
                      "fused_vs_unfused": fused_bounds}}
    emit(row)
    if not (model_finite(torch, first_res.model)
            and model_finite(torch, unf_res.model)):
        fail(f"fit_bf16: a coefficient is not finite: {row}")
    if not (row["graph_adopted"] and graphs_first == 1):
        fail(f"fit_bf16: the first fused fit did not replay the warm "
             f"graph: {row}")
    if stats["aot_compiles"] < 1 or stats["aot_failures"] != 0:
        fail(f"fit_bf16: compile_cache stats {stats}")
    if max(row["rel_err_vs_f32"].values()) > BF16_RTOL:
        fail(f"fit_bf16: beyond {BF16_RTOL} of the f32 model: {row}")
    if any(row["max_abs_diff_fused_vs_unfused"][c] > fused_bounds[c]
           for c in fused_bounds):
        fail(f"fit_bf16: fused and unfused beyond {fused_bounds}: {row}")
    if any(any(w["solver_syncs"]) for w in warm):
        fail(f"fit_bf16: a warm replay counted solver syncs: {row}")
    launches = row["newton_kernel_launches"]
    if (launches["first_replay"] or launches["first_python"]
            or any(launches["warm_replays"]) or launches["eager_twin"]
            or launches["unfused"]
            or unf["plain_route_solves"] != n_buckets * CD_ITERATIONS):
        fail(f"fit_bf16: the bf16 fit reached the Newton kernel or left "
             f"the batch-minor loop: {row}")
    if 2 * row["slab_bytes"] != row["slab_bytes_f32"]:
        fail(f"fit_bf16: the bf16 slabs are not half the f32 ones: {row}")
    if not row["warm_start_adds_no_key"]:
        fail(f"fit_bf16: a warm start added a fused cache key: {row}")
    if not row["eager_twin_bit_identical"]:
        fail(f"fit_bf16: the adopted fit differs from its eager twin: "
             f"{row}")
    return row


def fused_telemetry(torch, est, data, off_result) -> dict:
    """One warm fused fit with ``obs.enable()``, ``ledger.enable()`` and
    ``obs.health.enable()``. Gates: one ``fused_fit`` span, one fit
    recorded in the convergence traces and one parked sentinel, both
    scanned finite; the ``fused_fit`` ledger rows split over every
    coordinate (a warm window), beside ``unattributed``; the model equal
    bit for bit to the telemetry-off replay's."""
    from photon_tpu_torch import obs
    from photon_tpu_torch.obs import health, ledger

    obs.reset()
    ledger.reset()
    health.reset()
    obs.enable()
    ledger.enable()
    health.enable()
    try:
        before = health.sentinel_seq()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = est.fit(data)[0]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        spans = [sp for sp in obs.TRACER.completed()
                 if sp.name == "fused_fit"]
        conv = obs.convergence.snapshot()
        traces = obs.convergence.traces()
        numerics = health.numerics_report(since_seq=before)
        parked = health.sentinel_seq() - before
        snap = ledger.snapshot()
    finally:
        obs.disable()
        ledger.disable()
        health.disable()
        obs.reset()
        ledger.reset()
        health.reset()
    rows = {(r["coordinate"], r["program"]) for r in snap["rows"]}
    finite = bool(traces) and all(
        math.isfinite(v) for series in traces[-1].values()
        for values in series.values() for v in values)
    row = {"phase": "fused_fit_telemetry", "fit_seconds": seconds,
           "fused_fit_spans": len(spans),
           "fit_window_pure": [sp.attrs.get("fit_window_pure")
                               for sp in spans],
           "device_wait_seconds": [sp.device_wait_seconds for sp in spans],
           "fits_recorded": conv["fits_recorded"],
           "convergence_finite": finite,
           "convergence_last": conv["last"],
           "sentinels_parked": parked,
           "fits_scanned": numerics.get("fits_scanned"),
           "nonfinite_total": numerics.get("nonfinite_total"),
           "ledger_rows": sorted(f"{c}/{p}" for c, p in rows),
           "model_bit_identical": model_arrays_equal(res.model,
                                                     off_result.model)}
    emit(row)
    want = {(cid, "fused_fit") for cid in est.update_sequence}
    if (len(spans) != 1 or conv["fits_recorded"] != 1 or parked != 1
            or numerics.get("fits_scanned") != 1):
        fail(f"fused_fit_telemetry: spans, traces or sentinels: {row}")
    if not finite or numerics.get("nonfinite_total") != 0:
        fail(f"fused_fit_telemetry: the convergence block is not finite: "
             f"{row}")
    if not want <= rows or ("-", "unattributed") not in rows:
        fail(f"fused_fit_telemetry: the fused_fit ledger rows are missing: "
             f"{row}")
    if not row["model_bit_identical"]:
        fail("fused_fit_telemetry: telemetry changed the fused fit's model")
    return dict(row, fits=1)


def model_arrays_equal(a, b) -> bool:
    """Two GameModels equal bit for bit, array by array."""
    from photon_tpu_torch.io.model_io import game_model_to_numpy

    (xa, ma), (xb, mb) = game_model_to_numpy(a), game_model_to_numpy(b)
    return ma == mb and set(xa) == set(xb) and all(
        np.array_equal(xa[k], xb[k]) for k in xa)


def fit_telemetry(torch, est, data, off: dict, off_result) -> dict:
    """The warm fit once more with ``obs.enable()``, ``ledger.enable()``
    and ``obs.health.enable()``. Gates against the telemetry-off fit:
    the same host syncs and Newton launches, the model equal bit for
    bit, and a ``coord:<cid>`` span for every update. The health
    layer's numerics report is printed (the unfused fit parks no
    sentinel: ``fits_scanned`` 0)."""
    from photon_tpu_torch import obs
    from photon_tpu_torch.obs import health, ledger

    obs.reset()
    obs.enable()
    ledger.enable()
    health.enable()
    try:
        on, res = fit_trajectory(torch, est, data)
        spans = [sp.path for sp in obs.TRACER.completed()]
        numerics = health.numerics_report()
    finally:
        obs.disable()
        ledger.disable()
        health.disable()
        obs.reset()
    keys = ("newton_kernel_launches", "plain_route_solves",
            "newton_host_syncs", "lbfgs_host_syncs")
    coords = {cid: sum(p.endswith(f"coord:{cid}") for p in spans)
              for cid in est.update_sequence}
    same_model = model_arrays_equal(res.model, off_result.model)
    row = {"phase": "fit_telemetry",
           "fit_seconds": {"off": off["fit_seconds"],
                           "on": on["fit_seconds"]},
           **{k: {"off": off[k], "on": on[k]} for k in keys},
           "model_bit_identical": same_model,
           "coord_spans": coords, "spans": len(spans),
           "health_armed": True, "numerics": numerics}
    emit(row)
    if any(off[k] != on[k] for k in keys):
        fail(f"fit_telemetry: telemetry changed the fit's syncs or "
             f"launches: {row}")
    if not same_model:
        fail("fit_telemetry: the fit with telemetry on differs from the "
             "fit with it off")
    if any(n != CD_ITERATIONS for n in coords.values()):
        fail(f"fit_telemetry: coord spans {coords}, expected "
             f"{CD_ITERATIONS} a coordinate")
    return row


def entity_subset(eb, sel, device=None):
    """The entities ``sel`` (indices or a mask) of bucket ``eb``, each
    array moved to ``device`` when one is given."""
    import dataclasses

    def take(a):
        return a[sel] if device is None else a[sel].to(device)

    return type(eb)(**{
        f.name: None if getattr(eb, f.name) is None else take(
            getattr(eb, f.name)) for f in dataclasses.fields(eb)})


def dense_x(torch, eb):
    """A bucket's design as a float64 [B, R, S] slab: the dense slab as
    it is, an ELL block scattered out (duplicate slots add)."""
    if eb.x_indices is None:
        return eb.x_values.double()
    b, r, _ = eb.x_indices.shape
    x = torch.zeros((b, r, eb.sub_dim), dtype=torch.float64,
                    device=eb.x_values.device)
    return x.scatter_add_(2, eb.x_indices.long(), eb.x_values.double())


def phase_optimality(torch, model, datasets, data, stats,
                     phase="optimality") -> dict:
    """Each entity's regularized gradient at the fitted model (float64,
    against the final scores of every other coordinate) against the
    cascade's gradient tolerance; where it is above, the entity's last
    convergence code says why."""
    total, parts = total_scores(torch, model, datasets, data)
    return {cid: entity_optimality(
        torch, datasets[cid], total - parts[cid], model[cid],
        stats["reasons"][cid], stats["l2"][cid], phase=phase, cid=cid)
        for cid in RE_IDS}


def coordinate_offsets(eb, residuals):
    """A bucket's offsets plus the residual scores on its live rows, in
    float64."""
    off = eb.offsets.double()
    if residuals is None:
        return off
    return off + residuals.double()[eb.row_ids.long()] * (eb.weights > 0)


def pseudo_gradient(torch, w, g, l1):
    """Minimum-norm subgradient of f(w) + l1 |w|_1 (g where l1 = 0)."""
    right, left = g + l1, g - l1
    zero = torch.zeros_like(g)
    at_zero = torch.where(right < 0, right, torch.where(left > 0, left, zero))
    return torch.where(w > 0, right, torch.where(w < 0, left, at_zero))


def entity_optimality(torch, ds, residuals, model, reasons, l2, *, phase,
                      cid, l1=0.0, blocks=None) -> dict:
    """Each entity's logistic objective (L2 ``l2`` on the penalized
    slots, L1 ``l1`` on every slot) in float64 at its fitted
    coefficients, its rows' offsets plus ``residuals``: the norm of its
    minimum-norm subgradient (the gradient when l1 = 0) against the
    cascade's tolerance, 1e-7 of that norm at zero; where it is above,
    the entity's convergence code (``reasons``, in bucket order) must
    say why. Emits the row, with the count of exact zeros. ``blocks``
    replaces ``ds.device_blocks()`` (a sample of them)."""
    from photon_tpu_torch.optim import ConvergenceReason

    w_all = model.coefficients.double()
    gn, g0n, zeros = [], [], 0
    for eb in (ds.device_blocks() if blocks is None else blocks):
        x = dense_x(torch, eb)
        off = coordinate_offsets(eb, residuals)
        wt = eb.weights.double()
        ind = (eb.labels > 0.5).double()
        w = w_all[eb.entity_codes.long()][:, :x.shape[-1]]
        pen = l2 * eb.penalty_mask.double()
        vm = eb.valid_mask.double()
        for ww, sink in ((w, gn), (torch.zeros_like(w), g0n)):
            z = torch.einsum("brs,bs->br", x, ww) + off
            g = (torch.einsum("brs,br->bs", x, wt * (torch.sigmoid(z) - ind))
                 + pen * ww)
            sink.append(torch.linalg.vector_norm(
                pseudo_gradient(torch, ww, g, l1) * vm, dim=-1))
        zeros += int(((w == 0) & (vm > 0)).sum())
    gn = torch.cat(gn).cpu().numpy()
    g0n = torch.cat(g0n).cpu().numpy()
    converged = gn <= g0n * 1e-7
    counts = {"GRADIENT_BELOW_TOLERANCE": int(converged.sum())}
    for code in np.unique(reasons[~converged]):
        counts[ConvergenceReason(int(code)).name] = int(
            (reasons[~converged] == code).sum())
    rel = gn / np.maximum(g0n, 1e-30)
    row = {"phase": phase, "coordinate": cid, "entities": int(gn.size),
           "counts": counts, "exact_zeros": zeros,
           "rel_grad_median": float(np.median(rel)),
           "rel_grad_p99": float(np.quantile(rel, 0.99)),
           "rel_grad_max": float(rel.max())}
    emit(row)
    if not np.isfinite(gn).all():
        fail(f"{cid}: non-finite gradient at the fitted model")
    if (reasons[~converged] == int(ConvergenceReason.NOT_CONVERGED)).any():
        fail(f"{cid}: an entity is above the gradient tolerance with no "
             "convergence reason")
    return row


def phase_quality(torch, arrays, model, datasets, data) -> dict:
    total, _ = total_scores(torch, model, datasets, data)
    score = total.double().cpu().numpy()
    row = {"phase": "quality", "train_auc": auc(score, arrays["y"]),
           "bayes_auc": auc(arrays["z"], arrays["y"]),
           "scores_finite": bool(np.isfinite(score).all())}
    emit(row)
    if not row["scores_finite"] or not row["train_auc"] > 0.5:
        fail(f"trained model scores: {row}")
    return {"row": row, "total": total}


def phase_train_serve(torch, arrays, model, total) -> dict:
    """The trained model through save_checkpoint -> load_checkpoint ->
    ScorePrograms, scoring training rows as requests."""
    from photon_tpu_torch.io.model_io import load_checkpoint, save_checkpoint
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.programs import ScorePrograms
    from photon_tpu_torch.serve.tables import CoefficientTables

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke")
    path = save_checkpoint(model, os.path.join(out_dir, "trained_model.npz"))
    programs = ScorePrograms(CoefficientTables.from_game_model(
        load_checkpoint(path), "float32"))
    rows = np.random.default_rng(3).choice(
        arrays["y"].shape[0], size=SERVE_ROWS, replace=False)
    requests = [
        ({"global": arrays["x"][i], "userShard": arrays["xu"][i],
          "movieShard": arrays["xm"][i]},
         {"userId": str(arrays["users"][i]),
          "movieId": str(arrays["movies"][i])})
        for i in rows
    ]
    feats, codes, rung = programs.pack_requests(requests)
    zero_serve_counts(serve_kernel)
    served = programs.score_padded(feats, codes, len(requests))
    launches = sum(serve_counts(serve_kernel))
    trainer = total[torch.from_numpy(rows).to(total.device)].cpu().numpy()
    err = float(np.abs(served - trainer).max())
    row = {"phase": "train_serve", "requests": len(requests), "rung": rung,
           "serve_kernel_launches": launches, "max_abs_err": err,
           "tol": TOL["float32"], "checkpoint": path}
    emit(row)
    if launches != 1 or not err <= TOL["float32"]:
        fail(f"served scores of the trained model differ from the "
             f"trainer's by {err} ({launches} launches)")
    return row


def newton_bound(shape, trials=16) -> dict:
    """Least time for one Newton step on a [B, R, S] bucket: bytes (the
    slab, each [B, R] and [B, S] operand and output, f read and written,
    the improved byte, each once) at 3.35 TB/s; f32 operations (margins,
    gradient, the S CG steps, trial margins and losses, the refresh) at
    67 TFLOP/s, the CG taken the cheaper of two ways: on a formed H, or
    applying H from the slab; and the exp and log1p of every row in every
    trial, plus those of the margins and the refresh, at the
    special-function rate. ``bound_ms`` is the largest. The counts are
    ``costmodel.newton_step_cost``'s."""
    from photon_tpu_torch.analysis import costmodel

    cost = costmodel.newton_step_cost(shape, trials)
    nbytes, flops = cost["hbm_bytes"], cost["flops"]
    transcendental = cost["transcendentals"]
    pk = peaks()
    times = {"bytes": nbytes / pk["hbm_bytes_per_sec"],
             "operations": flops / pk["flops_per_sec"],
             "transcendentals": transcendental
             / pk["transcendentals_per_sec"]}
    name = max(times, key=times.get)
    return {"bound_ms": times[name] * 1e3,
            "bound_by": "bytes" if name == "bytes" else "operations",
            "bound_detail": name,
            "bytes_ms": times["bytes"] * 1e3,
            "flops_ms": times["operations"] * 1e3,
            "transcendentals_ms": times["transcendentals"] * 1e3,
            "bytes": nbytes, "flops": flops,
            "transcendental_ops": transcendental}


def phase_newton_timing(torch, datasets, est, launches_by_bucket) -> list:
    """Device ms per Newton step at every bucket shape of the fit (CUDA
    graph replay); the plain version at the largest user and movie
    buckets."""
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    rows = []
    for cid in RE_IDS:
        blocks = datasets[cid].device_blocks()
        biggest = max(blocks, key=lambda b: b.num_entities)
        for eb in blocks:
            args = step_args(newton_operands(torch, eb, l2_weight(est, cid)))
            shape = tuple(eb.x_values.shape)

            def kernel():
                return nk.newton_step(*args, task=task)

            def plain():
                return nk.newton_step_plain(*args, task=task)

            row = {"phase": "newton_timing", "coordinate": cid,
                   "bucket": list(shape),
                   "fit_launches": launches_by_bucket.get((cid, shape), 0),
                   "ms": device_ms(torch, kernel, 5),
                   "eager_ms": eager_ms(torch, kernel, 5),
                   **newton_bound(shape)}
            if eb is biggest:
                row["plain_ms"] = device_ms(torch, plain, 1)
            emit(row)
            rows.append(row)
    return rows


def fit_objective(torch, total, data) -> float:
    """Sum of the logistic loss of every row at the fit's scores
    (float64), the data term of the training objective."""
    from photon_tpu_torch.ops import losses

    return float(torch.sum(losses.LOGISTIC.loss(total.double(),
                                                data.labels.double())))


@contextlib.contextmanager
def env_switch(name: str, value: str | None):
    """Set the kernel switch ``name`` to ``value`` (None: leave it as it
    is) for the block, then restore it."""
    before = os.environ.get(name)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = before


def newton_switch(value: str | None):
    """``PHOTON_NEWTON_KERNEL=off`` sends every bucket to the batch-minor
    plain route (the switch is read at each route choice)."""
    return env_switch("PHOTON_NEWTON_KERNEL", value)


# Rows of the route_agreement data held out as calibration_check's
# validation set (its last rows).
CALIBRATION_ROWS = 40_000


def calibration_check(torch, est, model, arrays, data) -> dict:
    """``GameEstimator.evaluate_model`` with ``obs.health``'s
    ``calibration_sink`` on the logistic model of ``route_agreement``'s
    kernel fit, its validation the data's last ``CALIBRATION_ROWS``
    rows. Gates: the sketch's ECE equal, within 1e-12, to an ECE
    computed here in numpy from the host scores and labels the sink
    received; and the sink's call adds exactly one device-to-host copy
    (``Memcpy DtoH`` events under ``torch.profiler``, a call with the
    sink against one without, both after a warm call)."""
    from photon_tpu_torch.obs import health
    from photon_tpu_torch.types import TaskType

    validation = train_dataset({k: arrays[k][-CALIBRATION_ROWS:] for k in (
        "y", "x", "xu", "xm", "users", "movies")})
    t0 = time.perf_counter()
    est.evaluate_model(model, data, validation)  # builds the context
    warm_s = time.perf_counter() - t0
    copies, seen, evals = {}, [], {}
    cal, sink = health.calibration_sink(TaskType.LOGISTIC_REGRESSION)

    def recording_sink(z, y):
        seen.append((z, y))
        sink(z, y)

    for mode in ("no_sink", "sink"):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            res = est.evaluate_model(
                model, data, validation,
                score_sink=recording_sink if mode == "sink" else None)
            torch.cuda.synchronize()
        copies[mode] = sum("Memcpy DtoH" in e.name for e in prof.events())
        evals[mode] = res.evaluations
    z, y = seen[0]
    p = 1.0 / (1.0 + np.exp(-np.clip(z.astype(np.float64), -60.0, 60.0)))
    b = np.minimum((p * 10).astype(np.int64), 9)
    n_b = np.zeros(10)
    p_b = np.zeros(10)
    y_b = np.zeros(10)
    np.add.at(n_b, b, 1.0)
    np.add.at(p_b, b, p)
    np.add.at(y_b, b, y.astype(np.float64))
    live = n_b > 0
    ece_numpy = float(np.sum(np.abs(y_b[live] - p_b[live])) / len(p))
    row = {"phase": "calibration", "rows": CALIBRATION_ROWS,
           "warm_call_seconds": warm_s, "ece": cal.ece(),
           "ece_numpy": ece_numpy,
           "ece_abs_diff": abs(cal.ece() - ece_numpy),
           "samples": int(cal.counts.sum()), "missing": cal.missing,
           "d2h_copies": copies,
           "evaluations_equal": evals["sink"] == evals["no_sink"],
           "evaluations": evals["sink"]}
    emit(row)
    if (len(seen) != 1 or len(z) != CALIBRATION_ROWS
            or not row["ece_abs_diff"] <= 1e-12):
        fail(f"calibration: the sketch's ECE is not numpy's: {row}")
    if copies["sink"] - copies["no_sink"] != 1 or not copies["no_sink"]:
        fail(f"calibration: the score sink made "
             f"{copies['sink'] - copies['no_sink']} device-to-host "
             f"copies, not one: {row}")
    if not row["evaluations_equal"]:
        fail(f"calibration: the sink changed the evaluation: {row}")
    return row


def phase_route_agreement(torch) -> dict:
    """The same fit at a tenth of the rows, users and movies (the
    per-entity shapes stay the bench's) with the kernel route and with
    the batch-minor plain route that the solver takes for buckets the
    kernel does not serve; both on the card in float32."""
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.ops import newton_kernel as nk

    arrays = synth_arrays(**REDUCED)
    data = train_dataset(arrays)
    fits = {}
    for route in ("kernel", "plain"):
        est = build_estimator()
        nk.launches = ra.plain_route_solves = 0
        with newton_switch("off" if route == "plain" else None):
            t0 = time.perf_counter()
            model = est.fit(data)[0].model
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        datasets, _ = est.prepare(data)
        total, _ = total_scores(torch, model, datasets, data)
        fits[route] = dict(model=model, seconds=secs, launches=nk.launches,
                           plain_solves=ra.plain_route_solves,
                           objective=fit_objective(torch, total, data))
        if route == "kernel":
            calibration_check(torch, est, model, arrays, data)
    k, p = fits["kernel"], fits["plain"]
    row = {"phase": "route_agreement", **REDUCED,
           "rtol": FIT_RTOL,
           "kernel_fit_seconds": k["seconds"],
           "plain_fit_seconds": p["seconds"],
           "kernel_launches": [k["launches"], p["launches"]],
           "plain_route_solves": [k["plain_solves"], p["plain_solves"]],
           "objective_kernel": k["objective"],
           "objective_plain": p["objective"],
           "objective_rel_diff": abs(k["objective"] - p["objective"])
           / abs(p["objective"])}
    ok = True
    for cid in ("global",) + RE_IDS:
        a = (k["model"][cid].model.coefficients.means if cid == "global"
             else k["model"][cid].coefficients)
        b = (p["model"][cid].model.coefficients.means if cid == "global"
             else p["model"][cid].coefficients)
        diff = (a - b).abs()
        excess = diff - (FIT_ATOL + FIT_RTOL * b.abs())
        atol = FIT_ATOL if cid == "global" else RE_FIT_ATOL
        gate = diff - (atol + FIT_RTOL * b.abs())
        row[f"{cid}_max_abs_diff"] = float(diff.max())
        row[f"{cid}_outside_1e-3_1e-4"] = int((excess > 0).sum())
        row[f"{cid}_atol"] = atol
        row[f"{cid}_max_excess"] = float(gate.max())
        row[f"{cid}_coefficients"] = int(diff.numel())
        ok = ok and float(gate.max()) <= 0.0
    emit(row)
    if k["launches"] <= 0 or p["launches"] != 0 or p["plain_solves"] <= 0:
        fail(f"the two fits did not take their routes: {row}")
    if not ok:
        fail(f"kernel-route and plain-route fits differ beyond rtol "
             f"{FIT_RTOL} / atol {FIT_ATOL} (fixed effect), "
             f"{RE_FIT_ATOL} (random effects)")
    if not row["objective_rel_diff"] <= 1e-4:
        fail(f"the two fits' training losses differ: {row}")
    return row


def phase_train(torch) -> dict:
    from photon_tpu_torch.ops import newton_kernel as nk

    t0 = time.perf_counter()
    arrays = synth_arrays()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = train_dataset(arrays)
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t0
    est = build_estimator()
    # The f32 estimator's prepare declines the warm stage (a listener is
    # attached while it plans): its fused fit captures at first use, and
    # the bf16 estimator of the planner comparison takes the warm stage.
    with unfused(est):
        datasets, plan_row = timed_prepare(torch, est, data)
    plan_s = plan_row["seconds"]
    t0 = time.perf_counter()
    buckets = {cid: [list(b.x_values.shape)
                     for b in datasets[cid].device_blocks()]
               for cid in RE_IDS}
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    emit({"phase": "train_data", "rows": int(arrays["y"].shape[0]),
          "generate_seconds": gen_s, "to_device_seconds": put_s,
          "planner_host_seconds": plan_s, "slab_gather_seconds": gather_s,
          "buckets": buckets})
    est16 = planner_comparison(
        torch, "logistic", build_estimator, data, datasets, plan_row,
        again_estimator=lambda: build_estimator(
            precision="bfloat16"))["estimator"]
    parity = phase_newton_parity(torch, datasets, est)

    fit = phase_fit(torch, arrays, data, est)
    save_single_fit(os.path.join(mesh_root(), "single.npz"), fit["result"],
                    datasets)
    model = fit["result"].model
    hist = fit["result"].descent.history
    last = {r.coordinate_id: r for r in hist if r.iteration == CD_ITERATIONS - 1}
    stats = {"l2": {cid: l2_weight(est, cid) for cid in RE_IDS},
             "reasons": {cid: last[cid].diagnostics.reasons for cid in RE_IDS}}
    t0 = time.perf_counter()
    total, parts = total_scores(torch, model, datasets, data)
    torch.cuda.synchronize()
    emit({"phase": "score", "seconds": time.perf_counter() - t0})
    phase_optimality(torch, model, datasets, data, stats)
    quality = phase_quality(torch, arrays, model, datasets, data)
    phase_fit_bf16(torch, arrays, data, est16, est, fit,
                   quality["row"]["train_auc"])
    del est16
    phase_train_serve(torch, arrays, model, quality["total"])
    by_bucket = bucket_launches(hist, datasets)
    if sum(by_bucket.values()) != fit["row"]["newton_kernel_launches"]:
        fail(f"per-bucket launches {by_bucket} do not add up to the count")
    timing = phase_newton_timing(torch, datasets, est, by_bucket)
    del datasets, data, total, parts, quality
    phase_route_agreement(torch)
    user = max((r for r in timing if r["coordinate"] == "per-user"),
               key=lambda r: r["bucket"][0])
    return {
        "name": "newton_step",
        "route": "cuda",
        "source": nk.SOURCE,
        "replaces": NEWTON_REPLACES,
        # The unfused fits' launches and the fused fits'.
        "launches": fit["unfused_launches"] + fit["fused_newton_launches"],
        "launches_fused_fit": fit["fused_newton_launches"],
        "fused_fit_newton_launches_per_replay":
            fit["fused"]["newton_launches_per_replay"],
        "max_abs_err": parity["max_abs_err"],
        "ms": user["ms"],
        "plain_ms": user["plain_ms"],
        "bound_ms": user["bound_ms"],
        "bound_by": user["bound_by"],
        "library_ms": None,
    }


# The loop designs' probe: lanes, iterations of the toy loop's slowest
# lane, and the unrolled IF-node counts (100 is the solvers' iteration
# bound; 2,500 = 100 iterations x 25 line-search probes, one solve's
# line-search bodies at the bound).
PROBE_LANES = 1024
PROBE_IF_NODES = (100, 2_500)


def phase_graph_loops(torch) -> dict:
    """The choice of loop design, measured: one toy loop (per lane
    ``x = 1.5 x + 1`` while ``x < limit``; the row gives the slowest
    lane's iterations) captured as one WHILE node (``device_loop.while_loop``)
    and unrolled into N IF nodes (``device_loop.cond_apply`` N times),
    for each N of ``PROBE_IF_NODES``: capture and instantiate seconds,
    graph nodes, one replay's milliseconds, and each result equal to the
    eager loop's. Gates: every result equal."""
    from types import SimpleNamespace

    from photon_tpu_torch.utils import device_loop

    limit = torch.linspace(10.0, 1e12, PROBE_LANES, device="cuda")

    def fresh():
        return SimpleNamespace(
            x=torch.zeros(PROBE_LANES, device="cuda"),
            n=torch.zeros(PROBE_LANES, dtype=torch.int64, device="cuda"))

    def step(c, active):
        c.x = torch.where(active, c.x * 1.5 + 1.0, c.x)
        c.n = c.n + active.long()

    def any_running(mask):
        return bool(mask.any())

    want = fresh()
    device_loop.while_loop(lambda: want.x < limit,
                           lambda a: step(want, a), (want,),
                           any_running=any_running)

    def measure(kind, build):
        graph = device_loop.new_graph()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with device_loop.capture(graph, "cuda") as cap:
            c = build()
        capture_s = time.perf_counter() - t0
        inst = None
        if hasattr(graph, "instantiate"):
            t0 = time.perf_counter()
            graph.instantiate()
            inst = time.perf_counter() - t0
        graph.replay()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        torch.cuda.synchronize()
        out = {"design": kind, "capture_seconds": capture_s,
               "instantiate_seconds": inst,
               "graph_nodes": device_loop.graph_nodes(cap),
               "conditional_nodes": cap.conditional_nodes,
               "replay_ms": (time.perf_counter() - t0) * 1e3,
               "equal": bool(torch.equal(c.x, want.x)
                             and torch.equal(c.n, want.n))}
        del graph
        return out

    def while_node():
        c = fresh()
        device_loop.while_loop(lambda: c.x < limit, lambda a: step(c, a),
                               (c,), any_running=any_running)
        return c

    def if_nodes(n):
        def build():
            c = fresh()
            for _ in range(n):
                active = c.x < limit
                device_loop.cond_apply(active, lambda a=active: step(c, a),
                                       (c,), any_running=any_running)
            return c
        return build

    rows = [measure("while", while_node)]
    rows += [dict(measure("if_unrolled", if_nodes(n)), if_nodes=n)
             for n in PROBE_IF_NODES]
    row = {"phase": "graph_loops", "lanes": PROBE_LANES,
           "iterations": int(want.n.max()), "designs": rows}
    emit(row)
    if not all(r["equal"] for r in rows):
        fail(f"graph_loops: a captured loop differs from the eager loop: "
             f"{row}")
    return row


# The program tier's contracts audited on the card (``analysis/program.py``
# with ``device="cuda"``): the captured fused fit, the three kernels'
# wrappers and the serving ladder.
PROGRAM_CONTRACTS_ON_CARD = ("fused-fit", "newton-kernel",
                             "segment-reduce-kernel", "serve-kernel",
                             "serving")


def phase_program_contracts(torch) -> dict:
    """The program tier (``python -m photon_tpu_torch.analysis
    --semantic``) on the card, in this process: each of
    PROGRAM_CONTRACTS_ON_CARD built on CUDA tensors, where a program is
    what a real CUDA-graph capture recorded (the fused fit's cold and
    warm graphs, one serving rung each) or what a kernel wrapper
    dispatched under ``set_sync_debug_mode("error")`` (the fused fit's
    replays too), with the kernels' launches marked in it. Gates: no
    unsuppressed finding (census, recompile keys, host boundary,
    float64); the fused fit captured 2 graphs for its base and lambda
    grid, its fit program launches the Newton kernel; each kernel
    contract's program launched its kernel once (the wrapper's own
    counter agreeing); the serve kernel's rung one graph and the serving
    ladder three, each launching the serve kernel."""
    from photon_tpu_torch.analysis import program

    t0 = time.perf_counter()
    findings, report = program.audit(
        program.collect_contracts(PROGRAM_CONTRACTS_ON_CARD), device="cuda")
    seconds = time.perf_counter() - t0
    contracts = report["contracts"]
    row = {"phase": "program_contracts", "seconds": seconds,
           "findings": [f.format() for f in findings],
           "contracts": {
               name: {"captures": e.get("captures"), "programs": {
                   n: {k: p[k] for k in ("signature", "ops", "syncs",
                                         "launches")}
                   for n, p in e["programs"].items()}, "notes": e["notes"]}
               for name, e in contracts.items()}}
    emit(row)
    if any(not f.suppressed for f in findings):
        fail(f"program_contracts: {row['findings']}")

    def launched(contract, prog, name):
        return contracts[contract]["programs"][prog]["launches"].get(name, 0)

    problems = []
    if "fused-fit" in contracts:
        if contracts["fused-fit"].get("captures") != 2:
            problems.append("fused-fit captures")
        if not launched("fused-fit", "fit", "newton_step") >= 1:
            problems.append("fused-fit's graph launches no Newton kernel")
    for contract, prog, kernel in (
            ("newton-kernel", "newton_step", "newton_step"),
            ("segment-reduce-kernel", "segment_sum", "segment_sum")):
        if contract in contracts and not (
                launched(contract, prog, kernel) == 1
                and launched(contract, prog, f"{kernel}(counter)") == 1):
            problems.append(f"{contract} launches")
    if "serve-kernel" in contracts and not (
            contracts["serve-kernel"].get("captures") == 1
            and launched("serve-kernel", "serve_kernel_b8",
                         "serve_score") >= 1):
        problems.append("serve-kernel capture")
    if "serving" in contracts and not (
            contracts["serving"].get("captures") == 3
            and all(p["launches"].get("serve_score", 0) >= 1
                    for p in contracts["serving"]["programs"].values())):
        problems.append("serving captures")
    if problems:
        fail(f"program_contracts: {problems}: {row}")
    empty_cache()
    return row


# ---------------------------------------------------------------------------
# the training CLI: Avro files in, a directory of GAME models out
# ---------------------------------------------------------------------------

CLI_TRAIN_ROWS = 32 * 8192
# The training rows' part files, and the streaming runs' window of them.
STREAM_SHARDS, STREAM_WINDOW = 16, 2
CLI_VALIDATION_ROWS = 4 * 8192
CLI_EVALUATORS = ["AUC", "AUC:userId"]
CLI_SHARDS = {s: [bag] for s, (bag, _, _) in SCORE_SHARDS.items()}
# User activity p(u) ~ 1 / (u + 20), the form of the wide group's movie
# popularity: a long tail over the 100,000 users whose head has the rows
# to train on. It is synthetic, taken from no published trace.
CLI_USER_SKEW = 20
# An entity trains with at least this many rows: below it, too many
# entities hold rows of one label only, and then the intercept, which
# L2 leaves unpenalized, has no finite optimum.
CLI_MIN_ROWS = 8
# At most this many rows a user (a reservoir sample past it), the logistic
# configuration's per-user cap (``build_estimator``). A user of 257-512
# rows lands in the 1024-row bucket: 1024 x 17 slots is past the
# reference's R * S <= 16384 and takes the narrow design's long layout.
CLI_MAX_ROWS = 512


def train_cli_config(files, root: str) -> dict:
    """The logistic training configuration's coordinates over the three
    bags: ``global`` L2 1e-3, ``per-user`` L2 [1, 10] (a two-point grid)
    capped at CLI_MAX_ROWS rows, ``per-movie`` L2 1, each random effect
    active from CLI_MIN_ROWS rows; two CD iterations; EXPLICIT output,
    feature stats, AUC and AUC:userId."""
    def l2(*weights):
        return {"type": "L2", "weights": list(weights)}

    return {
        "task": "LOGISTIC_REGRESSION",
        "input": {"format": "avro", "train_path": files["train"]["data"],
                  "validation_path": files["validation"]["data"],
                  "feature_shards": CLI_SHARDS,
                  "id_tags": ["userId", "movieId"]},
        "coordinates": {
            "global": {"type": "fixed", "feature_shard": "global",
                       "regularization": l2(1e-3)},
            "per-user": {"type": "random", "random_effect_type": "userId",
                         "feature_shard": "userShard",
                         "active_data_upper_bound": CLI_MAX_ROWS,
                         "active_data_lower_bound": CLI_MIN_ROWS,
                         "regularization": l2(1.0, 10.0)},
            "per-movie": {"type": "random", "random_effect_type": "movieId",
                          "feature_shard": "movieShard",
                          "active_data_lower_bound": CLI_MIN_ROWS,
                          "regularization": l2(1.0)},
        },
        "num_iterations": 2,
        "evaluators": CLI_EVALUATORS,
        "model_output_mode": "EXPLICIT",
        "data_summary_dir": os.path.join(root, "summary"),
        "output_dir": os.path.join(root, "out"),
    }


def write_cli_config(cfg: dict, root: str) -> tuple[dict, str]:
    """``cfg`` with its outputs under ``root`` (feature stats too, when it
    asks for them), written to ``root/train.json``: (the config, its
    path)."""
    cfg = dict(cfg, output_dir=os.path.join(root, "out"))
    if "data_summary_dir" in cfg:
        cfg["data_summary_dir"] = os.path.join(root, "summary")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg, path


def run_train_cli(torch, cfg: dict, root: str, profiled: bool,
                  *extra: str) -> dict:
    """One in-process ``cli.train.main`` run into ``root`` (counts zeroed
    just before): exit code, last line, summary, Newton launches (and by
    bucket shape), plain-route solves, peak device memory, wall seconds,
    and, when
    ``profiled``, the Newton kernel's device ms from ``torch.profiler``
    (CUDA activity only) with the device's busy share of the run."""
    from torch.profiler import ProfilerActivity, profile

    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.cli import train as train_cli
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.ops import segment_reduce as sr

    cfg, path = write_cli_config(cfg, root)
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    prof = (profile(activities=[ProfilerActivity.CUDA]) if profiled
            else contextlib.nullcontext())
    nk.launches = ra.plain_route_solves = 0
    nk.launches_by_shape.clear()
    sr.reset_counts()
    t0 = time.perf_counter()
    with prof, contextlib.redirect_stdout(buf):
        rc = train_cli.main(["--config", path, "--device", "cuda",
                             "--checkpoint-dir",
                             os.path.join(root, "ckpt"), *extra])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {"rc": rc, "wall_seconds": wall, "launches": nk.launches,
           "launches_by_shape": dict(nk.launches_by_shape),
           "segment_launches_by_site": dict(sr.launches_by_site),
           "plain_route_solves": ra.plain_route_solves,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "line": json.loads(buf.getvalue().strip().splitlines()[-1]),
           "root": root, "out": cfg["output_dir"]}
    if rc != 0:
        fail(f"train_cli: cli.train exited {rc}")
    with open(os.path.join(cfg["output_dir"],
                          "training-summary.json")) as f:
        out["summary"] = json.load(f)
    if profiled:
        def device_us(e):
            return float(getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0)))

        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        newton = [e for e in kernels if "newton" in e.key.lower()]
        out["newton_device_ms"] = sum(map(device_us, newton)) / 1e3
        out["newton_profiled_launches"] = sum(e.count for e in newton)
        out["device_ms"] = sum(map(device_us, kernels)) / 1e3
        out["device_busy_share"] = out["device_ms"] / (wall * 1e3)
        out["atomic_scatter_kernels"] = atomic_scatter_kernels(
            e.key for e in kernels)
    return out


def checkpoint_arrays(path: str):
    """(arrays, manifest) of a native checkpoint, in numpy."""
    from photon_tpu_torch.io.model_io import (
        game_model_to_numpy,
        load_checkpoint,
    )

    return game_model_to_numpy(load_checkpoint(path, "cpu"))


def numpy_model_scores(model_dir: str, data_path: str) -> np.ndarray:
    """float64 scores of the rows of ``data_path`` from the arrays of the
    Avro model in ``model_dir``, in the index space ``cli.score`` builds
    from that data: each row's dot with the fixed effect, plus, for an
    entity the model knows, its coefficients at the row's features."""
    from photon_tpu_torch.data.random_effect import scoring_codes
    from photon_tpu_torch.io.avro_data import read_merged
    from photon_tpu_torch.io.model_io import load_game_model

    data, maps = read_merged(data_path, feature_shards=CLI_SHARDS,
                             id_tag_names=["userId", "movieId"],
                             device="cpu")
    model, _ = load_game_model(model_dir, maps, device="cpu")
    z = np.zeros(data.num_samples)
    for name, sub in model.items():
        idx, val, d = data.host_shard_coo(sub.feature_shard_id)
        val = val.astype(np.float64)
        if name == "global":
            w = sub.model.coefficients.means.double().numpy()
            z += np.sum(val * w[idx], axis=1)
            continue
        coefs = sub.coefficients.double().numpy()
        dense = np.zeros((coefs.shape[0] + 1, d))
        rows, slots = np.nonzero(sub.proj_all >= 0)
        dense[rows, sub.proj_all[rows, slots]] = coefs[rows, slots]
        codes = scoring_codes(data, sub.random_effect_type,
                              sub.entity_keys)
        z += np.sum(val * dense[np.where(codes >= 0, codes, -1)[:, None],
                                idx], axis=1)
    return z


def numpy_weighted_moments(files, shard: str, d: int):
    """The weighted mean and unbiased variance of every feature id of
    ``shard`` over the written training rows, in float64 (implicit zeros
    counted, as FeatureDataStatistics counts them)."""
    idx, val = files["feats"][shard]
    w = files["weights"]
    s1 = np.bincount(idx.ravel(), (val * w[:, None]).ravel(), minlength=d)
    s2 = np.bincount(idx.ravel(), (val * val * w[:, None]).ravel(),
                     minlength=d)
    sw = w.sum()
    mean = s1 / sw
    return mean, (sw / (sw - 1.0)) * (s2 / sw - mean * mean)


def long_bucket(torch, shape, seed: int):
    """A synthetic random-effect bucket of ``shape`` [B, R, S] as the
    planner lays out the CLI's longest entities, for the Newton kernel's
    parity there: each entity holds R/4 + 1 .. R/2 live rows (the rest
    padding of weight 0), ELL_K["userShard"] of its S - 1 feature slots
    drawn N(0, 1) a row plus the intercept slot (last, unpenalized), and
    logistic labels from N(0, 1 / k) coefficients."""
    from types import SimpleNamespace

    b, r, s = shape
    k = min(ELL_K["userShard"], s - 1)
    rng = np.random.default_rng(seed)
    live = np.arange(r)[None, :] < rng.integers(r // 4 + 1, r // 2 + 1,
                                                size=b)[:, None]
    x = np.zeros((b, r, s))
    cols = np.argsort(rng.random((b, r, s - 1)), axis=2)[:, :, :k]
    np.put_along_axis(x, cols, rng.normal(size=(b, r, k)), axis=2)
    x[:, :, s - 1] = 1.0
    x *= live[:, :, None]
    z = np.einsum("brs,bs->br", x, rng.normal(size=(b, s)) / math.sqrt(k))
    y = (rng.uniform(size=(b, r)) < 1.0 / (1.0 + np.exp(-z))) & live
    penalty = np.ones((b, s))
    penalty[:, s - 1] = 0.0

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    return SimpleNamespace(
        x_values=dev(x), offsets=dev(np.zeros((b, r))), labels=dev(y),
        weights=dev(live), penalty_mask=dev(penalty),
        valid_mask=dev(np.ones((b, s))), num_entities=b)


def train_cli_root() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "smoke", "train_cli")


def train_cli_files(arrays, manifest, root: str) -> tuple[dict, float]:
    """``train_cli``'s Avro files under ``root`` and the seconds they
    took: the training rows as STREAM_SHARDS part files (the in-memory
    runs read the directory, the streaming runs stream it) and the
    validation file."""
    t0 = time.perf_counter()
    files = {
        "train": score_files(arrays, manifest, root, CLI_TRAIN_ROWS,
                             SEED + 3, cold=0.0, intercept=True,
                             model=False, name="train",
                             user_skew=CLI_USER_SKEW,
                             parts=STREAM_SHARDS),
        "validation": score_files(arrays, manifest, root,
                                  CLI_VALIDATION_ROWS, SEED + 4,
                                  intercept=True, model=False,
                                  name="validation.avro",
                                  user_skew=CLI_USER_SKEW),
    }
    return files, time.perf_counter() - t0


def generating_auc(files) -> float:
    """The generating model's AUC on the validation rows, in float64."""
    val = files["validation"]
    return numpy_auc(val["exact"] + val["offsets"], val["labels"],
                     val["weights"])


def train_cli_inputs(arrays, manifest) -> dict:
    """``train_cli``'s files and configuration without its runs (what
    ``--pilot`` needs)."""
    root = train_cli_root()
    files, write_s = train_cli_files(arrays, manifest, root)
    return {"files": files, "cfg": train_cli_config(files, root),
            "root": root, "generating_auc": generating_auc(files),
            "write_files_seconds": write_s}


def phase_train_cli(torch, arrays, manifest) -> dict:
    """``cli.train`` at the logistic configuration's widths, through the
    CLI (module docstring, phase 14a). Cut: rows only, 262,144 train and
    32,768 validation against the in-memory phase's 4,000,000, because
    the pure-Python Avro writer makes the files (it took 13.9-14.7 s for
    107,496 rows on the H100 host, so 4M rows would be ~9 minutes of
    set-up). Returns the launch counts and the kernel run's row."""
    import resource

    from photon_tpu_torch.cli import score as score_cli
    from photon_tpu_torch.io import avro
    from photon_tpu_torch.io.model_io import load_feature_stats
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.resilience import load_training_checkpoint
    from photon_tpu_torch.serve.programs import ShapeLadder

    root = train_cli_root()
    files, write_s = train_cli_files(arrays, manifest, root)
    cfg = train_cli_config(files, root)
    kept: list = []
    with capture_prepare(kept, keep=lambda data, datasets: data):
        # --no-flight: with the recorder off, telemetry is fully off in
        # the run this script profiles.
        kernel = run_train_cli(torch, cfg, os.path.join(root, "kernel"),
                               True, "--no-flight")
    # (b) the fixed effect's transpose: the segment-sum kernel at its
    # fixed_effect site on the run's own global shard.
    global_shard = kept[0].feature_shards["global"]
    site = fixed_effect_site(torch, global_shard, torch.from_numpy(
        np.random.default_rng(SEED + 6).normal(
            size=global_shard.num_rows).astype(np.float32)).cuda())
    plan = global_shard.transpose_plan()
    site["transpose_plan_bytes"] = sum(
        t.numel() * t.element_size()
        for t in (plan.ids, plan.values, plan.rows))
    del kept, global_shard, plan
    with newton_switch("off"):
        plain = run_train_cli(torch, cfg, os.path.join(root, "plain"),
                              False)

    # (a) layout and the checkpoint chain.
    ks, ps = kernel["summary"], plain["summary"]
    best = ks["best_configuration_index"]
    other = 1 - best
    layout = ["training-summary.json", "models/best/model-metadata.json",
              "models/best/checkpoint.npz",
              "models/best/fixed-effect/global/id-info",
              "models/best/random-effect/per-user/id-info",
              "models/best/random-effect/per-movie/id-info",
              f"models/config_{other}/checkpoint.npz",
              "group-evaluation/0/AUC_userId.json"]
    missing = [f for f in layout
               if not os.path.exists(os.path.join(kernel["out"], f))]
    ckpt = load_training_checkpoint(os.path.join(kernel["root"], "ckpt"),
                                    "cuda")
    # (c) route agreement of the best models and their validation AUCs.
    ka, kman = checkpoint_arrays(os.path.join(kernel["out"], "models",
                                              "best", "checkpoint.npz"))
    pa, pman = checkpoint_arrays(os.path.join(plain["out"], "models",
                                              "best", "checkpoint.npz"))
    # An entity whose training rows hold one label has no finite
    # optimum (its intercept runs off), so each route stops it where its
    # iterations end: such entities are counted and left out.
    agreement, one_label = {}, {}
    train = files["train"]
    for key, a in ka.items():
        if key.endswith("/proj_all"):
            agreement[key] = bool(np.array_equal(a, pa[key]))
            continue
        b = pa[key].astype(np.float64)
        diff = np.abs(a.astype(np.float64) - b)
        atol = FIT_ATOL if key.startswith("global/") else RE_FIT_ATOL
        excess = diff - (atol + FIT_RTOL * np.abs(b))
        if not key.startswith("global/"):
            cid = key.split("/")[0]
            ids = train["users" if cid == "per-user" else "movies"]
            pos = np.bincount(ids, weights=train["labels"])
            mixed = (pos > 0) & (pos < np.bincount(ids))
            ent = np.array([int(k) for k in kman[cid]["entity_keys"]])
            keep = mixed[ent]
            one_label[cid] = int((~keep).sum())
            excess = excess[keep]
        agreement[key] = float(np.max(excess))
    k_auc = ks["configurations"][best]["evaluation"]["AUC"]
    p_auc = ps["configurations"][ps["best_configuration_index"]][
        "evaluation"]["AUC"]
    # The Newton kernel against its plain version at the kernel run's
    # longest bucket shape, on a synthetic bucket of that shape.
    shapes = kernel["launches_by_shape"]
    longest = max(shapes, key=lambda sh: (sh[1] * sh[2], sh[0]))
    parity_err, _ = newton_parity_steps(
        torch, "longest", long_bucket(torch, longest, SEED + 5), 1.0,
        phase="train_cli_newton_parity")
    # (d) the generating model's validation AUC in float64.
    val = files["validation"]
    gen_auc = generating_auc(files)
    # (e) train -> score on the validation file.
    score_out = os.path.join(root, "scores")
    best_dir = os.path.join(kernel["out"], "models", "best")
    serve_kernel.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = score_cli.main([
            "--model-dir", best_dir, "--input", val["data"],
            "--output", score_out, "--feature-shards",
            *[f"{s}={b[0]}" for s, b in CLI_SHARDS.items()],
            "--id-tags", "userId", "movieId", "--device", "cuda",
            "--evaluators", *CLI_EVALUATORS])
    score_launches = serve_kernel.launches
    chunks = len(ShapeLadder(SCORE_RUNGS).chunk_plan(CLI_VALIDATION_ROWS))
    scores = np.array([r["predictionScore"] for r in avro.read_container_dir(
        os.path.join(score_out, "part-00000.avro"))])
    exact = numpy_model_scores(best_dir, val["data"])
    score_err = float(np.max(np.abs(scores - exact) / (1.0 + np.abs(exact))))
    with open(os.path.join(score_out, "evaluation.json")) as f:
        score_auc = json.load(f)["AUC"]
    # (f) the global shard's feature stats against numpy.
    stats = load_feature_stats(os.path.join(kernel["root"], "summary",
                                            "global"))
    n_ids = N_FEATURES - 1
    mean, var = numpy_weighted_moments(files["train"], "global", n_ids)
    keys = files["train"]["keys"]["global"]
    stats_err = max(max(abs(stats[keys[j]]["mean"] - mean[j]),
                        abs(stats[keys[j]]["variance"] - var[j]))
                    for j in range(n_ids))

    row = {
        "phase": "train_cli", "rows": CLI_TRAIN_ROWS,
        "validation_rows": CLI_VALIDATION_ROWS,
        "write_files_seconds": write_s,
        "data_bytes": [f["data_bytes"] for f in files.values()],
        "seconds": ks["seconds"], "wall_seconds": kernel["wall_seconds"],
        "plain_run_seconds": ps["seconds"],
        "plain_run_wall_seconds": plain["wall_seconds"],
        "newton_launches": [kernel["launches"], plain["launches"]],
        "newton_launches_by_shape": [
            [list(sh), n] for sh, n in sorted(shapes.items())],
        "newton_parity_shape": list(longest),
        "newton_parity_max_abs_diff": parity_err,
        "plain_route_solves": [kernel["plain_route_solves"],
                               plain["plain_route_solves"]],
        "newton_device_ms": kernel.get("newton_device_ms"),
        "newton_profiled_launches": kernel.get("newton_profiled_launches"),
        "segment_launches_by_site": [kernel["segment_launches_by_site"],
                                     plain["segment_launches_by_site"]],
        "atomic_scatter_kernels": kernel["atomic_scatter_kernels"],
        "device_ms": kernel.get("device_ms"),
        "device_busy_share": kernel.get("device_busy_share"),
        "peak_device_bytes": [kernel["peak_device_bytes"],
                              plain["peak_device_bytes"]],
        "transpose_plan_bytes": site["transpose_plan_bytes"],
        "peak_host_rss_bytes": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
        "best_configuration": [best, ps["best_configuration_index"]],
        "configurations": [c["evaluation"] for c in ks["configurations"]],
        "validation_auc": [k_auc, p_auc], "generating_auc": gen_auc,
        "checkpoint": [ckpt.config_index, ckpt.iteration,
                       ckpt.interrupted],
        "model_agreement_max_excess": agreement,
        "one_label_entities_left_out": one_label,
        "score_launches": score_launches, "score_chunks": chunks,
        "score_max_rel_err_numpy_f64": score_err,
        "score_auc": score_auc,
        "stats_max_abs_err": stats_err,
        "last_line": kernel["line"],
    }
    emit(row)
    print(f"train_cli: validation AUC {k_auc:.6f} (generating model "
          f"{gen_auc:.6f}); Newton launches {kernel['launches']} "
          f"({kernel.get('newton_device_ms')} device ms) on the kernel, "
          f"{plain['launches']} with the switch off", flush=True)
    if missing:
        fail(f"train_cli: missing outputs {missing}")
    if (ckpt.config_index, ckpt.iteration, ckpt.interrupted) != (1, 1,
                                                                  False):
        fail(f"train_cli: the checkpoint holds {row['checkpoint']}")
    if kernel["launches"] <= 0 or kernel["plain_route_solves"] != 0:
        fail("train_cli: the kernel run did not take the Newton kernel on "
             "every bucket")
    if plain["launches"] != 0:
        fail("train_cli: PHOTON_NEWTON_KERNEL=off still launched the kernel")
    fe_launches = kernel["segment_launches_by_site"].get("fixed_effect", 0)
    if fe_launches <= 0 or kernel["atomic_scatter_kernels"]:
        fail(f"train_cli (b): {fe_launches} segment-sum launches at the "
             f"fixed_effect site; atomic scatter kernels on the card: "
             f"{kernel['atomic_scatter_kernels']}")
    if best != ps["best_configuration_index"]:
        fail("train_cli: the two runs chose different configurations")
    if not all(v is True or (not isinstance(v, bool) and v <= 0.0)
               for v in agreement.values()) or kman != pman:
        fail(f"train_cli: the best models differ: {agreement}")
    if not abs(k_auc - p_auc) <= 1e-4:
        fail(f"train_cli: validation AUCs differ: {k_auc} vs {p_auc}")
    if not k_auc - 0.5 >= 0.5 * (gen_auc - 0.5):
        fail(f"train_cli: AUC {k_auc} recovers under half the generating "
             f"model's lift ({gen_auc})")
    if rc != 0 or len(scores) != CLI_VALIDATION_ROWS or not np.isfinite(
            scores).all():
        fail("train_cli: cli.score did not score every validation row")
    if not score_err <= 1e-5:
        fail(f"train_cli: scores differ from the numpy score by {score_err}")
    if not abs(score_auc - k_auc) <= 1e-4:
        fail(f"train_cli: evaluation.json AUC {score_auc} against "
             f"training-summary.json's {k_auc}")
    if score_launches != chunks:
        fail(f"train_cli: {score_launches} serve launches for {chunks} "
             "chunks")
    if not stats_err <= 1e-6 or len(stats) != n_ids:
        fail(f"train_cli: feature stats differ from numpy by {stats_err}")
    return {"newton_launches": kernel["launches"],
            "newton_parity_max_abs_diff": parity_err,
            "serve_launches": score_launches, "row": row,
            "fixed_effect_launches": fe_launches,
            "kernel_segment_launches_by_site": kernel[
                "segment_launches_by_site"],
            "fixed_effect_site": site,
            "files": files, "cfg": cfg, "root": root,
            "generating_auc": gen_auc}


# ---------------------------------------------------------------------------
# a fit that repeats bit for bit: the fixed effect's sparse transpose
# ---------------------------------------------------------------------------

# Name fragments of PyTorch's scatter-add kernels on the card:
# index_add_ and scatter_add_ (``ReduceAdd``: float atomics, whose order
# of additions changes from run to run) and index_put_ with accumulate
# (``indexing_backward``, the sorted form deterministic mode takes).
# Gathers (``_scatter_gather_elementwise_kernel`` with ``TensorAssign``)
# do not match.
ATOMIC_SCATTER_KERNELS = ("reduceadd", "index_add", "indexing_backward",
                          "atomic")


def atomic_scatter_kernels(names) -> list:
    return sorted(n for n in names
                  if any(a in n.lower() for a in ATOMIC_SCATTER_KERNELS))


LIBRARY_REPEATS = 20


def index_add_transpose(features, contrib):
    """The fixed effect's sparse transpose as one ``index_add_`` over the
    unsorted slots (float atomics on the card): the library call for the
    ``fixed_effect`` site's ``library_ms``, used nowhere in the port."""
    import torch

    out = torch.zeros(features.d, dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, features.indices.reshape(-1).long(),
                          contrib.reshape(-1))


def fixed_effect_site(torch, features, g) -> dict:
    """The segment-sum kernel at the ``fixed_effect`` site on one shard's
    sorted slots (``SparseFeatures.transpose_plan``: ``parts`` row blocks
    of ``d`` segments) times ``g``: held twice against its plain version
    (``_segment_check``), then its device ms beside the plain version's,
    the kernel with the blocks' sum (``reduce_ms``), ``index_add_`` on
    the same unsorted slots (the library call) and how far
    LIBRARY_REPEATS of its calls disagree, the whole ``rmatvec`` and the
    bound."""
    from photon_tpu_torch.ops import segment_reduce as sr

    plan = features.transpose_plan()
    vals = (plan.values * g.index_select(0, plan.rows)).contiguous()
    d = int(features.d)
    n = plan.parts * d
    check = _segment_check(
        torch, sr, f"fixed_effect {tuple(features.indices.shape)}", vals,
        plan.ids, n)
    contrib = features.values * g[:, None]

    def kernel():
        return sr.segment_sum(vals, plan.ids, n, site="timing")

    def reduce():
        return kernel().view(plan.parts, d).sum(0)

    def plain():
        return sr.sorted_segment_sum_plain(vals, plan.ids, n)

    def library():
        return index_add_transpose(features, contrib)

    row = {"phase": "fixed_effect_timing", "site": "fixed_effect",
           "shape": list(features.indices.shape), "values": int(vals.shape[0]),
           "features": d, "parts": plan.parts, "segments": n,
           "max_abs_err": check["max_abs_err"],
           "ms": device_ms(torch, kernel, SEGMENT_INNER),
           "reduce_ms": device_ms(torch, reduce, SEGMENT_INNER),
           "plain_ms": device_ms(torch, plain, SEGMENT_INNER),
           "library_ms": device_ms(torch, library, SEGMENT_INNER),
           "rmatvec_ms": eager_ms(torch, lambda: features.rmatvec(g),
                                  SEGMENT_INNER),
           "index_add_vs_kernel_max_abs": float(
               (library() - reduce()).abs().max()),
           **segment_bound(vals, n)}
    # What the site replaced: the atomic index_add_ on the same slots
    # gives a different sum from call to call; the kernel (checked
    # above) gives one.
    runs = [library() for _ in range(LIBRARY_REPEATS)]
    row["library_runs_unequal"] = sum(
        not torch.equal(r, runs[0]) for r in runs[1:])
    row["library_spread_max_abs"] = max(
        float((r - runs[0]).abs().max()) for r in runs)
    emit(row)
    return row


# ---------------------------------------------------------------------------
# hyperparameter tuning in cli.train, and the legacy cli.glm driver
# ---------------------------------------------------------------------------

TUNING_SEED = 7
# RANDOM draws 3 candidates. BAYESIAN draws 5: with train_cli's three
# tunable coordinates and a one-point grid, the reference's
# GaussianProcessSearch draws Sobol points until it holds more
# observations than dimensions, so its 4th and 5th candidates are the
# first that come from the GP.
TUNING_RANDOM, TUNING_BAYESIAN = 3, 5
# The tuner's default search range of a regularization weight
# (GameEstimatorEvaluationFunction.scala:242), searched in log space.
TUNING_WEIGHT_RANGE = (1e-4, 1e4)
# Three weights in the range where train_cli's validation AUC still moves
# with lambda, so that the best two lie well beyond the ~1e-5 of f32
# rounding in an AUC of 32,768 rows (the phase prints every lambda's AUC
# on both runs): below lambda ~100 the AUCs agree to that rounding, and
# the f32 and float64 runs could pick either.
GLM_LAMBDAS = "10000,1000,100"
GLM_F32_ATOL = 5e-4


def tuning_config(cli: dict, mode: str, iterations: int) -> dict:
    """``train_cli``'s configuration with one lambda a coordinate (its
    first), one CD iteration, TUNED output and no feature stats, tuned
    by ``mode`` for ``iterations`` candidates from TUNING_SEED."""
    cfg = {k: v for k, v in cli["cfg"].items() if k != "data_summary_dir"}
    cfg.update(
        coordinates={cid: dict(c, regularization={
            "type": "L2", "weights": c["regularization"]["weights"][:1]})
            for cid, c in cfg["coordinates"].items()},
        num_iterations=1, model_output_mode="TUNED",
        hyperparameter_tuning={"mode": mode, "iterations": iterations,
                               "seed": TUNING_SEED})
    return cfg


def sobol_lambdas(n_params: int, n: int, seed: int) -> list:
    """The RANDOM tuner's first ``n`` candidates taken straight from
    scipy's Sobol sequence (unscrambled, fast-forwarded by the seed, as
    RandomSearch.scala:46-51 draws them), mapped to weights over
    TUNING_WEIGHT_RANGE in log space: one row per candidate, the
    coordinates in sorted order."""
    from scipy.stats import qmc

    sobol = qmc.Sobol(d=n_params, scramble=False)
    if seed % 65536:
        sobol.fast_forward(seed % 65536)
    lo, hi = (math.log(w) for w in TUNING_WEIGHT_RANGE)
    return [[math.exp(float(v) * (hi - lo) + lo) for v in row]
            for row in sobol.random(n)]


def summary_lambdas(summary: dict) -> list:
    """Each configuration's lambdas, the coordinates in sorted order."""
    return [[c["config"][cid]["lambda"] for cid in sorted(c["config"])]
            for c in summary["configurations"]]


# Phase 14e's three runs, side by side, each in a process of its own:
# the two BAYESIAN runs repeat each other across processes.
TUNING_RUNS = {"random": ("RANDOM", TUNING_RANDOM),
               "bayesian": ("BAYESIAN", TUNING_BAYESIAN),
               "bayesian_again": ("BAYESIAN", TUNING_BAYESIAN)}


def tuning_jobs(cli: dict) -> list:
    """Phase 14e's ``cli_children`` specs, in TUNING_RUNS' order."""
    return [train_child(tuning_config(cli, mode, n),
                        os.path.join(cli["root"], "tuning", k))
            for k, (mode, n) in TUNING_RUNS.items()]


def phase_tuning_cli(torch, cli: dict, results: list) -> dict:
    """Hyperparameter tuning through ``cli.train`` on ``train_cli``'s
    files (module docstring, phase 14e): the gates on the three runs'
    results (``tuning_jobs``, through ``cli_children``), then ``cli.score``
    of the validation file with the BAYESIAN run's best model."""
    from photon_tpu_torch.cli import score as score_cli
    from photon_tpu_torch.io import avro
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.programs import ShapeLadder

    root = os.path.join(cli["root"], "tuning")
    runs = dict(zip(TUNING_RUNS, results))
    sums = {k: r["summary"] for k, r in runs.items()}
    n_params = len(cli["cfg"]["coordinates"])
    want_random = sobol_lambdas(n_params, TUNING_RANDOM, TUNING_SEED)
    got_random = summary_lambdas(sums["random"])[1:]
    dirs, want_dirs = {}, {}
    for k, r in runs.items():
        s = sums[k]
        best = s["best_configuration_index"]
        dirs[k] = sorted(os.listdir(os.path.join(r["out"], "models")))
        want_dirs[k] = sorted({"best"} | {
            f"config_{i}" for i in range(1, s["num_configurations"])
            if i != best})
    b, b2 = runs["bayesian"], runs["bayesian_again"]
    bayes_models = max_abs_diff(best_arrays(b["out"]), best_arrays(b2["out"]))
    # The tuned best model through cli.score.
    val = cli["files"]["validation"]
    best_dir = os.path.join(b["out"], "models", "best")
    score_out = os.path.join(root, "scores")
    serve_kernel.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        score_rc = score_cli.main([
            "--model-dir", best_dir, "--input", val["data"],
            "--output", score_out, "--feature-shards",
            *[f"{sh}={bag[0]}" for sh, bag in CLI_SHARDS.items()],
            "--id-tags", "userId", "movieId", "--device", "cuda",
            "--evaluators", *CLI_EVALUATORS])
    score_launches = serve_kernel.launches
    chunks = len(ShapeLadder(SCORE_RUNGS).chunk_plan(CLI_VALIDATION_ROWS))
    scores = np.array([r["predictionScore"] for r in avro.read_container_dir(
        os.path.join(score_out, "part-00000.avro"))])
    exact = numpy_model_scores(best_dir, val["data"])
    score_err = float(np.max(np.abs(scores - exact) / (1.0 + np.abs(exact))))
    row = {
        "phase": "tuning_cli", "seed": TUNING_SEED,
        "runs": {k: {
            "wall_seconds": r["wall_seconds"],
            "process_seconds": r["process_seconds"],
            "seconds": sums[k]["seconds"],
            "num_configurations": sums[k]["num_configurations"],
            "num_tuned_configurations": sums[k]["num_tuned_configurations"],
            "best_configuration_index": sums[k]["best_configuration_index"],
            "lambdas": summary_lambdas(sums[k]),
            "auc": [c["evaluation"]["AUC"]
                    for c in sums[k]["configurations"]],
            "newton_launches": r["launches"],
            "plain_route_solves": r["plain_route_solves"],
            "segment_launches_by_site": r["segment_launches_by_site"],
            "model_dirs": dirs[k]} for k, r in runs.items()},
        "random_lambdas_sobol": want_random,
        "bayesian_best_models_max_abs_diff": bayes_models,
        "score_launches": score_launches, "score_chunks": chunks,
        "score_max_rel_err_numpy_f64": score_err,
    }
    emit(row)
    if got_random != want_random:
        fail(f"tuning_cli: the RANDOM candidates {got_random} are not the "
             f"Sobol draws {want_random}")
    for k, mode_n in (("random", TUNING_RANDOM), ("bayesian", TUNING_BAYESIAN),
                      ("bayesian_again", TUNING_BAYESIAN)):
        s = sums[k]
        if (s["num_tuned_configurations"], s["num_configurations"]) != (
                mode_n, mode_n + 1):
            fail(f"tuning_cli ({k}): {s['num_tuned_configurations']} tuned "
                 f"of {s['num_configurations']} configurations")
        if dirs[k] != want_dirs[k]:
            fail(f"tuning_cli ({k}): TUNED saved {dirs[k]}, not "
                 f"{want_dirs[k]}")
        r = runs[k]
        if (r["launches"] <= 0 or r["plain_route_solves"] != 0
                or r["segment_launches_by_site"].get("fixed_effect", 0) <= 0
                or r["segment_launches_by_site"].get("evaluation", 0) <= 0):
            fail(f"tuning_cli ({k}): Newton launches {r['launches']}, "
                 f"plain solves {r['plain_route_solves']}, segment sums "
                 f"{r['segment_launches_by_site']}")
    if (sums["bayesian"]["configurations"]
            != sums["bayesian_again"]["configurations"]
            or sums["bayesian"]["best_configuration_index"]
            != sums["bayesian_again"]["best_configuration_index"]
            or bayes_models != 0.0):
        fail("tuning_cli: two BAYESIAN runs differ: "
             f"{row['runs']['bayesian']['lambdas']} against "
             f"{row['runs']['bayesian_again']['lambdas']}, best models "
             f"{bayes_models} apart")
    if score_rc != 0 or len(scores) != CLI_VALIDATION_ROWS or not (
            score_err <= 1e-5) or score_launches != chunks:
        fail(f"tuning_cli: cli.score rc {score_rc}, error {score_err}, "
             f"{score_launches} launches for {chunks} chunks")
    fe = sum(r["segment_launches_by_site"].get("fixed_effect", 0)
             for r in runs.values())
    return {"newton_launches": sum(r["launches"] for r in runs.values()),
            "fixed_effect_launches": fe, "serve_launches": score_launches,
            "row": row}


@contextlib.contextmanager
def float64_readers():
    """The port's Avro and libsvm readers make float64 data inside the
    block (the CLIs read float32)."""
    import functools

    import torch

    from photon_tpu_torch.data import libsvm
    from photon_tpu_torch.io import avro_data

    saved = [(m, n, getattr(m, n)) for m, n in (
        (avro_data, "read_training_examples"), (libsvm, "read_libsvm"))]
    for m, n, fn in saved:
        setattr(m, n, functools.partial(fn, dtype=torch.float64))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def run_glm_cli(torch, files: dict, out_dir: str, device: str) -> dict:
    """``cli.glm`` on ``train_cli``'s files (the global bag) into
    ``out_dir``: its summary, the segment sums by site and the best
    model's means in float64."""
    from photon_tpu_torch.cli import glm as glm_cli
    from photon_tpu_torch.data.index_map import IndexMap
    from photon_tpu_torch.io.model_io import load_game_model
    from photon_tpu_torch.ops import segment_reduce as sr

    sr.reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = glm_cli.main([
            "--train", files["train"]["data"],
            "--validate", files["validation"]["data"],
            "--task", "LOGISTIC_REGRESSION", "--lambdas", GLM_LAMBDAS,
            "--output-dir", out_dir, "--device", device])
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"glm_cli: cli.glm exited {rc} on {device}")
    imap = IndexMap.from_feature_names(files["train"]["keys"]["global"])
    model, _ = load_game_model(os.path.join(out_dir, "best-model"),
                               {"features": imap}, device="cpu",
                               dtype=torch.float64)
    return {"summary": json.loads(buf.getvalue().strip().splitlines()[-1]),
            "wall_seconds": wall,
            "segment_launches_by_site": dict(sr.launches_by_site),
            "means": model["global"].model.coefficients.means.numpy()}


def phase_glm_cli(torch, cli: dict) -> dict:
    """The legacy ``cli.glm`` on ``train_cli``'s files (module docstring,
    phase 14f): on the card in float32, then on the CPU in float64."""
    root = os.path.join(cli["root"], "glm")
    card = run_glm_cli(torch, cli["files"], os.path.join(root, "card"),
                       "cuda")
    with float64_readers():
        cpu = run_glm_cli(torch, cli["files"], os.path.join(root, "cpu64"),
                          "cpu")
    diff = float(np.max(np.abs(card["means"] - cpu["means"])))
    fe = card["segment_launches_by_site"].get("fixed_effect", 0)
    row = {"phase": "glm_cli", "lambdas": GLM_LAMBDAS,
           "best_lambda": [card["summary"]["best_lambda"],
                           cpu["summary"]["best_lambda"]],
           "seconds": {"card": card["summary"]["seconds"],
                       "cpu_float64": cpu["summary"]["seconds"]},
           "wall_seconds": [card["wall_seconds"], cpu["wall_seconds"]],
           "auc": {k: {lam: m["AUC"] for lam, m in r["summary"][
               "metrics"].items()} for k, r in (("card", card),
                                                ("cpu_float64", cpu))},
           "best_model_max_abs_diff_float64": diff,
           "segment_launches_by_site": card["segment_launches_by_site"]}
    emit(row)
    if card["summary"]["best_lambda"] != cpu["summary"]["best_lambda"]:
        fail(f"glm_cli: the card selected lambda "
             f"{card['summary']['best_lambda']}, float64 on the CPU "
             f"{cpu['summary']['best_lambda']}")
    if not diff <= GLM_F32_ATOL:
        fail(f"glm_cli: the card's best model is {diff} from float64")
    if fe <= 0:
        fail("glm_cli: the sweep launched no segment sum at the "
             "fixed_effect site")
    return {"fixed_effect_launches": fe, "row": row}


# ---------------------------------------------------------------------------
# ingest at scale: the streaming CLI and the pipelined planner
# ---------------------------------------------------------------------------


def _sha(*arrays) -> str:
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def ingest_digests(data, datasets) -> dict:
    """sha256 digests of a prepared training dataset: its host mirrors,
    its device columns (copied back), its id tags, and the one packed
    plan buffer every random-effect coordinate's plan lies in (with its
    layout), so two runs compare byte for byte without holding both."""
    def dev(t):
        return t.detach().cpu().numpy()

    out = {"host": _sha(data.host["labels"], data.host["offsets"],
                        data.host["weights"], data.uids,
                        *[a for s in sorted(data.feature_shards)
                          for a in data.host_shard_coo(s)[:2]]),
           "device": _sha(dev(data.labels), dev(data.offsets),
                          dev(data.weights),
                          *[dev(t) for s in sorted(data.feature_shards)
                            for t in (data.feature_shards[s].indices,
                                      data.feature_shards[s].values)]),
           "id_tags": _sha(*[dev(data.id_tags[t].codes)
                             for t in sorted(data.id_tags)],
                           np.array([k for t in sorted(data.id_tags)
                                     for k in data.id_tags[t].inverse]))}
    views = [ds.packed_view for ds in datasets.values()
             if getattr(ds, "packed_view", None) is not None]
    bufs = {id(v.buffer): v.buffer for v in views}
    if len(bufs) != 1:
        fail(f"the plan arrays lie in {len(bufs)} device buffers, not one")
    buf = next(iter(bufs.values()))
    out["packed"] = _sha(dev(buf), np.array(
        [d for v in views for sh in v.shapes for d in (len(sh), *sh)]))
    out["packed_bytes"] = int(buf.numel() * buf.element_size())
    return out


@contextlib.contextmanager
def capture_prepare(store: list, keep=ingest_digests):
    """Record ``keep(data, datasets)`` of the first
    ``GameEstimator.prepare`` in the block (a CLI run prepares once and
    fit reuses it): by default its ``ingest_digests``."""
    from photon_tpu_torch.estimators import game_estimator as ge

    orig = ge.GameEstimator.prepare

    def prepare(self, data, validation=None, initial_model=None):
        out = orig(self, data, validation, initial_model)
        if not store:
            store.append(keep(data, out[0]))
        return out

    ge.GameEstimator.prepare = prepare
    try:
        yield store
    finally:
        ge.GameEstimator.prepare = orig


def stream_run(torch, cfg: dict, root: str, *extra: str) -> dict:
    """One in-process ``cli.train`` run (``run_train_cli``) with its
    ingest digests and the segment-sum launches of its validation (the
    grouped AUC, site ``evaluation``), counts zeroed just before."""
    from photon_tpu_torch.ops import segment_reduce as sr

    sr.reset_counts()
    store: list = []
    with capture_prepare(store):
        out = run_train_cli(torch, cfg, root, False, *extra)
    out["digests"] = store[0]
    out["segment_evaluation_launches"] = sr.launches_by_site.get(
        "evaluation", 0)
    out["segment_fixed_effect_launches"] = sr.launches_by_site.get(
        "fixed_effect", 0)
    return out


_CHILD_KEYS = ("rc", "wall_seconds", "launches", "plain_route_solves",
               "peak_device_bytes", "summary", "digests", "out",
               "segment_launches_by_site", "segment_evaluation_launches",
               "segment_fixed_effect_launches")


def _vm_status(key: str, pid="self") -> int | None:
    """A ``/proc/<pid>/status`` size (VmRSS, VmHWM) in bytes."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def cli_child(spec_path: str) -> int:
    """``--cli-child SPEC``: one ``stream_run`` in this process, under
    ``spec["env"]`` (or, for a spec of kind ``pilot``, one ``cli.pilot``
    run: ``pilot_child``; of kind ``profile``, one ``cli.profile`` run:
    ``profile_child``; of kind ``phase``, one phase of this script:
    ``phase_child``), its result and its memory written to
    ``spec["out"]``: VmHWM, its own address space's high-water mark,
    where the kernel reports it (the rusage maximum would carry the
    parent's over the exec), and the RSS after the imports and the CUDA
    context, before the run."""
    import torch

    from photon_tpu_torch.cli import train  # noqa: F401 — the imports
    from photon_tpu_torch.data import stream  # noqa: F401

    with open(spec_path) as f:
        spec = json.load(f)
    if spec.get("health"):
        from photon_tpu_torch.obs import health

        health.enable()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    base = _vm_status("VmRSS")
    if spec.get("kind") == "pilot":
        result = pilot_child(torch, spec)
    elif spec.get("kind") == "profile":
        result = profile_child(torch, spec)
    elif spec.get("kind") == "phase":
        result = run_phase_child(torch, spec)
    elif spec.get("kind") == "mesh_rank":
        result = mesh_rank(torch, spec)
    else:
        os.environ.update(spec.get("env") or {})
        with timed_ship() as ship:
            out = stream_run(torch, spec["cfg"], spec["root"],
                             *spec["extra"])
        result = {k: out[k] for k in _CHILD_KEYS}
        result["ship_bundle_seconds"] = ship.get("seconds")
    result.update(vm_hwm_bytes=_vm_status("VmHWM"), baseline_rss_bytes=base)
    with open(spec["out"], "w") as f:
        json.dump(result, f)
    return 0


@contextlib.contextmanager
def timed_ship():
    """``obs.fleet.ship_bundle`` wrapped from outside the package: the
    seconds of a ``--distributed`` run's bundle commit land in the
    yielded dict (``seconds``)."""
    from photon_tpu_torch.obs import fleet

    out: dict = {}
    orig = fleet.ship_bundle

    def ship_bundle(run_dir, **kw):
        t0 = time.perf_counter()
        try:
            return orig(run_dir, **kw)
        finally:
            out["seconds"] = time.perf_counter() - t0

    fleet.ship_bundle = ship_bundle
    try:
        yield out
    finally:
        fleet.ship_bundle = orig


def _spawn_child(spec: dict, env: dict) -> dict:
    """Start ``chip_smoke.py --cli-child`` on ``spec`` with environment
    ``env`` (``spec`` written to ``<root>/child.json``; its result goes
    to ``<root>/child-result.json``, its output to ``<root>/child.log``)."""
    root = spec["root"]
    os.makedirs(root, exist_ok=True)
    spec = dict(spec, out=os.path.join(root, "child-result.json"))
    path = os.path.join(root, "child.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    log = open(os.path.join(root, "child.log"), "w")
    return {"root": root, "log": log, "sampled": 0,
            "t0": time.perf_counter(), "proc": subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--cli-child", path], stdout=log, env=env,
                stderr=subprocess.STDOUT, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)))}


def _child_result(c: dict) -> dict:
    out = os.path.join(c["root"], "child-result.json")
    if c["proc"].returncode != 0 or not os.path.exists(out):
        with open(os.path.join(c["root"], "child.log")) as f:
            fail(f"the child run in {c['root']} exited "
                 f"{c['proc'].returncode}: {f.read()[-3000:]}")
    with open(out) as f:
        result = json.load(f)
    result["process_seconds"] = c["seconds"]
    result["sampled_peak_rss_bytes"] = c["sampled"]
    result["peak_host_rss_bytes"] = max(result["vm_hwm_bytes"] or 0,
                                        c["sampled"])
    return result


def train_child(cfg: dict, root: str, extra=(), health: bool = False,
                env: dict | None = None) -> dict:
    """A ``cli_children`` spec for one ``stream_run`` (``health`` arms
    ``obs.health`` in the child; ``env`` is added to its environment)."""
    return {"cfg": cfg, "root": root, "extra": list(extra),
            "health": health, "env": env or {}}


def phase_child(name: str, root: str, *args) -> dict:
    """A ``cli_children`` spec that runs ``name(torch, *args)``, one
    phase of this script, in a process of its own (``run_phase_child``):
    the arguments go to ``<root>/phase-args.pickle``; the phase's JSON
    lines go to the child's log, which ``phase_result`` prints."""
    import pickle

    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "phase-args.pickle")
    with open(path, "wb") as f:
        pickle.dump(args, f)
    return {"kind": "phase", "name": name, "args": path, "root": root}


def run_phase_child(torch, spec: dict) -> dict:
    """A ``phase_child`` spec's phase, set up as ``main`` sets up this
    process for it: TF32 off and graph replays' launches counted."""
    import pickle

    from photon_tpu_torch.utils import device_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_loop.count_graph_launches("cuda")
    with open(spec["args"], "rb") as f:
        args = pickle.load(f)
    return {"result": globals()[spec["name"]](torch, *args),
            "root": spec["root"]}


def phase_result(child: dict) -> dict:
    """A phase child's return value, after its log (its JSON lines) is
    printed here."""
    with open(os.path.join(child["root"], "child.log")) as f:
        sys.stdout.write(f.read())
    sys.stdout.flush()
    return child["result"]


def cli_children(jobs: list, stop: threading.Event | None = None,
                 env: dict | None = None) -> list:
    """Each job in a subprocess of its own, all jobs at once, for their
    peak RSS: a job is a child spec (``train_child``'s, or
    ``pilot_child``'s) or a list of specs, a chain, each child started
    when the one before it exited cleanly. Each result as ``cli_child``
    wrote it, with the process's seconds and the peak of its RSS sampled
    from here; a chain's results as a list. Every child gets the
    environment of the call, also one started later in a chain while
    this process runs other phases (``env``, when given, in place of
    it). Setting ``stop`` kills the children still running and
    raises."""
    env = dict(os.environ) if env is None else env
    is_chain = [isinstance(job, list) for job in jobs]
    chains = [list(job) if chain else [job]
              for job, chain in zip(jobs, is_chain)]
    running = [_spawn_child(chain.pop(0), env) for chain in chains]
    done: list = [[] for _ in chains]

    def reap(i, c):
        c["proc"].wait()
        c["log"].close()
        c.setdefault("seconds", time.perf_counter() - c["t0"])
        done[i].append(c)

    try:
        # Each child's RSS every 10 ms, read from here, where their GILs
        # do not hold the reads back.
        while any(c is not None for c in running):
            if stop is not None and stop.is_set():
                raise RuntimeError("cli_children stopped")
            for i, c in enumerate(running):
                if c is None:
                    continue
                if c["proc"].poll() is None:
                    c["sampled"] = max(c["sampled"], _vm_status(
                        "VmRSS", c["proc"].pid) or 0)
                    if time.perf_counter() - c["t0"] > 900:
                        c["proc"].kill()
                    continue
                reap(i, c)
                running[i] = (_spawn_child(chains[i].pop(0), env)
                              if chains[i] and c["proc"].returncode == 0
                              else None)
            time.sleep(0.01)
    finally:
        for i, c in enumerate(running):
            if c is not None:
                if c["proc"].poll() is None:
                    c["proc"].kill()
                reap(i, c)
    results = []
    for i, cs in enumerate(done):
        rs = [_child_result(c) for c in cs]
        if chains[i]:
            fail(f"the child chain in {cs[-1]['root']} stopped early")
        results.append(rs if is_chain[i] else rs[0])
    return results


def in_background(fn, *args, **kwargs):
    """``fn(*args, stop=event, **kwargs)`` on a thread of its own; returns a
    ``join(cancel=False)`` that waits for it and gives its result, or
    raises what it raised (a ``fail`` in it included). ``cancel`` sets
    the event first."""
    out: dict = {}
    stop = threading.Event()

    def run():
        try:
            out["result"] = fn(*args, stop=stop, **kwargs)
        except BaseException as exc:  # noqa: BLE001 - raised by join
            out["error"] = exc

    thread = threading.Thread(target=run, name="chip-smoke-background")
    thread.start()

    def join(cancel: bool = False):
        if cancel:
            stop.set()
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["result"]

    return join


def best_arrays(out_dir: str) -> dict:
    return checkpoint_arrays(os.path.join(out_dir, "models", "best",
                                          "checkpoint.npz"))[0]


def max_abs_diff(a: dict, b: dict) -> float:
    """Largest |a - b| over two checkpoints' arrays (inf when their keys
    or shapes differ)."""
    if a.keys() != b.keys() or any(a[k].shape != b[k].shape for k in a):
        return math.inf
    return max((float(np.max(np.abs(a[k].astype(np.float64)
                                    - b[k].astype(np.float64))))
                for k in a if a[k].size), default=0.0)


def stream_ingest_row(summary: dict) -> dict:
    """The ingest's seconds by stage (scan, decode, transfer, assemble),
    rows/s and the packed transfer of one CLI run's summary."""
    si = summary["streaming_ingest"]
    pipe = summary["ingest_pipeline"]
    return {k: si[k] for k in (
        "scan_seconds", "decode_seconds", "transfer_seconds",
        "wall_seconds", "rows_per_sec", "rows_ingested",
        "ingested_fraction", "shards_quarantined", "resumed_from_shard",
        "retry")} | {
        "assemble_seconds": pipe["stages"].get("stream_assemble"),
        "pipeline": {k: v for k, v in pipe.items()
                     if k != "packed_transfers"},
        "packed_transfers": pipe["packed_transfers"],
        "cli_seconds": summary["seconds"]}


def phase_stream_cli(torch, cli: dict, serve_sketch: str | None = None
                     ) -> dict:
    """The streaming training CLI on ``train_cli``'s configuration and
    rows (module docstring, phase 14d): the in-memory run and (a) in
    subprocesses of their own, side by side, for their peak RSS, then
    (b)-(e), (b)'s completing run with (d) and (e)'s training each in a
    subprocess of its own beside the others in this process. (a) and
    (c) run with ``obs.health`` armed; ``cli.health``
    then compares (a)'s ingest sketch with ``serve_sketch`` (serve_ops'
    ``--health-sketch``; without one, with (c)'s)."""
    import shutil

    from photon_tpu_torch.cli import score as score_cli
    from photon_tpu_torch.data import pipeline
    from photon_tpu_torch.io import avro
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.programs import ShapeLadder

    files, cfg = cli["files"], cli["cfg"]
    # The runs that are not compared with an in-memory run train one
    # iteration of one lambda and save the best model only: their gates
    # read the ingest, the plans and the kernels' launches.
    light = {k: v for k, v in cfg.items() if k != "data_summary_dir"}
    light.update(num_iterations=1, model_output_mode="BEST", coordinates={
        **cfg["coordinates"], "per-user": {
            **cfg["coordinates"]["per-user"],
            "regularization": {"type": "L2", "weights": [1.0]}}})
    shard_dir = files["train"]["data"]
    root = os.path.join(cli["root"], "stream")
    shutil.rmtree(root, ignore_errors=True)
    window = ("--stream-window", str(STREAM_WINDOW))
    stream = ("--stream-dir", shard_dir, *window)
    t_phase = time.perf_counter()

    # The in-memory run and (a), each in its own process, side by side.
    # The in-memory run records its telemetry, timeline and flight
    # recorder and profiles its fit (profile_dir): gated below, and the
    # in-memory fits' bit-equality shows they change no result.
    mem_root = os.path.join(root, "memory")
    mem_obs = {"telemetry": os.path.join(mem_root, "telemetry.jsonl"),
               "trace": os.path.join(mem_root, "trace.json"),
               "flight": os.path.join(mem_root, "flight"),
               "profile": os.path.join(mem_root, "profile"),
               "fleet": os.path.join(mem_root, "fleet")}
    memory, run_a = cli_children([
        train_child(dict(cfg, profile_dir=mem_obs["profile"]), mem_root,
                    ("--telemetry", mem_obs["telemetry"], "--trace",
                     mem_obs["trace"], "--flight-dir", mem_obs["flight"],
                     "--distributed", "--fleet-dir", mem_obs["fleet"])),
        train_child(cfg, os.path.join(root, "a"), stream, health=True)])
    mem_telemetry = stream_telemetry(mem_obs)
    mem_fleet = stream_fleet(mem_obs, memory, cli)
    a_out = os.path.join(root, "a", "out")
    a_best = best_arrays(a_out)
    mem_best = best_arrays(os.path.join(root, "memory", "out"))
    kernel_best = best_arrays(os.path.join(cli["root"], "kernel", "out"))
    # Two in-memory runs of the same files: the card's own spread.
    spread = max_abs_diff(kernel_best, mem_best)
    model_diff = max_abs_diff(a_best, mem_best)

    # (b) one shard truncated: the default policy stops naming it; a
    # budget of one completes without it. (d) rides the same run:
    # transient faults at io.shard_read, each followed by a clean attempt
    # (three in a row would exhaust the 3-attempt policy). That run and
    # (e) run in subprocesses of their own, beside the refusal and (c)
    # here.
    bad_dir = os.path.join(root, "shards-truncated")
    shutil.copytree(shard_dir, bad_dir)
    bad = os.path.join(bad_dir, "part-00005.avro")
    with open(bad, "rb") as f:
        raw = f.read()
    with open(bad, "wb") as f:
        f.write(raw[: len(raw) // 2])
    # (e) day 2: stream again, warm-started from (a)'s model.
    e_root = os.path.join(root, "e")
    side = in_background(cli_children, [
        train_child(light, os.path.join(root, "bd"),
                    ("--stream-dir", bad_dir, *window,
                     "--max-bad-shards", "1"),
                    env={"PHOTON_TPU_FAULT_PLAN": json.dumps({"faults": [
                        {"point": "io.shard_read", "nth": n}
                        for n in (2, 4, 6, 8)]})}),
        train_child(light, e_root, (*stream, "--init-model", os.path.join(
            a_out, "models", "best", "checkpoint.npz")))],
        env=dict(os.environ))
    try:
        here = stream_refusal_and_resume(torch, light, root, bad_dir,
                                         stream)
    except BaseException:
        with contextlib.suppress(BaseException):
            side(cancel=True)
        raise
    run_b, run_e = side()
    run_c, crash_at, crashed = here["run"], here["crash_at"], here["crash"]
    c_dumps, c_dump, cursor = here["dumps"], here["dump"], here["cursor"]
    refused, partial_rows = here["refused"], here["partial_rows"]
    sketch_check = stream_sketch_check(
        os.path.join(root, "a", "ckpt", "ingest-work"), here["work"],
        partial_rows, serve_sketch)

    with open(os.path.join(e_root, "ckpt", "manifest.json")) as f:
        run_meta = json.load(f).get("run", {})

    val = files["validation"]
    score_out = os.path.join(e_root, "scores")
    best_dir = os.path.join(run_e["out"], "models", "best")
    serve_kernel.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        score_rc = score_cli.main([
            "--model-dir", best_dir, "--input", val["data"],
            "--output", score_out, "--feature-shards",
            *[f"{s}={b[0]}" for s, b in CLI_SHARDS.items()],
            "--id-tags", "userId", "movieId", "--device", "cuda",
            "--evaluators", *CLI_EVALUATORS])
    score_launches = serve_kernel.launches
    chunks = len(ShapeLadder(SCORE_RUNGS).chunk_plan(CLI_VALIDATION_ROWS))
    scores = np.array([r["predictionScore"] for r in avro.read_container_dir(
        os.path.join(score_out, "part-00000.avro"))])
    exact = numpy_model_scores(best_dir, val["data"])
    score_err = float(np.max(np.abs(scores - exact) / (1.0 + np.abs(exact))))

    trained = {"memory": memory, "a": run_a, "bd": run_b, "c": run_c,
               "e": run_e}
    newton = sum(r["launches"] for r in trained.values())
    segment = sum(r["segment_evaluation_launches"]
                  for r in trained.values())
    fixed_effect = sum(r["segment_fixed_effect_launches"]
                       for r in trained.values())
    si = {k: r["summary"].get("streaming_ingest")
          for k, r in trained.items()}
    row = {
        "phase": "stream_cli", "shards": STREAM_SHARDS,
        "window_shards": STREAM_WINDOW, "rows": CLI_TRAIN_ROWS,
        "phase_seconds": time.perf_counter() - t_phase,
        "cpu_count": os.cpu_count(),
        "ingest_threads_env": os.environ.get("PHOTON_TPU_INGEST_THREADS"),
        "ingest_threads": pipeline.ingest_threads(),
        "torch_threads": torch.get_num_threads(),
        "memory": {"peak_host_rss_bytes": memory["peak_host_rss_bytes"],
                   "peak_device_bytes": memory["peak_device_bytes"],
                   "baseline_rss_bytes": memory["baseline_rss_bytes"],
                   "sampled_peak_rss_bytes": memory[
                       "sampled_peak_rss_bytes"],
                   "vm_hwm_bytes": memory["vm_hwm_bytes"],
                   "process_seconds": memory["process_seconds"],
                   "cli_seconds": memory["summary"]["seconds"],
                   "pipeline": memory["summary"]["ingest_pipeline"]},
        "a": {"peak_host_rss_bytes": run_a["peak_host_rss_bytes"],
              "peak_device_bytes": run_a["peak_device_bytes"],
              "baseline_rss_bytes": run_a["baseline_rss_bytes"],
              "sampled_peak_rss_bytes": run_a["sampled_peak_rss_bytes"],
              "vm_hwm_bytes": run_a["vm_hwm_bytes"],
              "process_seconds": run_a["process_seconds"],
              **stream_ingest_row(run_a["summary"])},
        "digests_equal_memory": {k: run_a["digests"][k] == memory[
            "digests"][k] for k in ("host", "device", "id_tags",
                                    "packed")},
        "packed_bytes": run_a["digests"]["packed_bytes"],
        "best_model_max_abs_diff": model_diff,
        "in_memory_runs_max_abs_diff": spread,
        "bd": {"default_policy_error": refused,
               **stream_ingest_row(run_b["summary"]),
               "quarantined_paths": si["bd"]["quarantined_paths"]},
        "memory_telemetry": mem_telemetry,
        "memory_fleet": mem_fleet,
        "c": {"crash": crashed, "fault_call": crash_at,
              "flight_dumps": c_dumps,
              "flight_reason": c_dump.get("reason"),
              "flight_faults_fired": c_dump.get("faults_fired"),
              "cursor_next_shard": cursor["next_shard"],
              **stream_ingest_row(run_c["summary"]),
              "digests_equal_a": run_c["digests"] == run_a["digests"]},
        "health_sketch": sketch_check,
        "e": {**stream_ingest_row(run_e["summary"]),
              "run_meta_keys": sorted(run_meta),
              "score_launches": score_launches, "score_chunks": chunks,
              "score_max_rel_err_numpy_f64": score_err},
        "newton_launches": {k: r["launches"] for k, r in trained.items()},
        "plain_route_solves": {k: r["plain_route_solves"]
                               for k, r in trained.items()},
        "segment_evaluation_launches": {
            k: r["segment_evaluation_launches"]
            for k, r in trained.items()},
        "segment_fixed_effect_launches": {
            k: r["segment_fixed_effect_launches"]
            for k, r in trained.items()},
        "validation_auc": {
            k: r["summary"]["configurations"][r["summary"][
                "best_configuration_index"]]["evaluation"]["AUC"]
            for k, r in trained.items()},
    }
    emit(row)
    print(f"stream_cli: peak RSS in-memory {memory['peak_host_rss_bytes']}"
          f" B, streamed {run_a['peak_host_rss_bytes']} B; "
          f"{si['a']['rows_per_sec']} rows/s streamed", flush=True)

    # (a) byte-identical data and plans; the model as the in-memory one.
    if not all(row["digests_equal_memory"].values()):
        fail(f"stream_cli (a): the streamed dataset or packed plan buffer "
             f"differs from the in-memory run's: "
             f"{row['digests_equal_memory']}")
    if spread != 0.0:
        fail(f"stream_cli (a): two in-memory fits of the same files differ "
             f"by {spread}")
    if model_diff != 0.0:
        fail(f"stream_cli (a): the streamed fit differs from the in-memory "
             f"one by {model_diff}")
    if si["a"]["ingested_fraction"] != 1.0 or si["a"][
            "shards_quarantined"]:
        fail(f"stream_cli (a): a clean ingest reports {si['a']}")
    # (b) the default policy names the file; a budget of one completes.
    if refused is None or "part-00005.avro" not in refused:
        fail(f"stream_cli (b): the default policy did not refuse the "
             f"truncated shard by name ({refused})")
    if (si["bd"]["quarantined_paths"] != [bad]
            or not 0.9 < si["bd"]["ingested_fraction"] < 1.0):
        fail(f"stream_cli (b): --max-bad-shards 1 reports {si['bd']}")
    # (c) a killed ingest resumes to the same bytes.
    if crashed is None or si["c"]["resumed_from_shard"] != cursor[
            "next_shard"] or not 0 < cursor["next_shard"] <= 9:
        fail(f"stream_cli (c): crash {crashed}, cursor {cursor}, resumed "
             f"at {si['c']['resumed_from_shard']}")
    if not row["c"]["digests_equal_a"]:
        fail("stream_cli (c): the resumed run's dataset or packed plan "
             "buffer differs from (a)'s")
    if not sketch_check["bytes_equal_a"] or not (
            0 < partial_rows < CLI_TRAIN_ROWS) or sketch_check[
            "rows"] != CLI_TRAIN_ROWS or sketch_check["cli_health_rc"]:
        fail(f"stream_cli (c): the resumed ingest's health sketch is not "
             f"(a)'s, or cli.health failed: {sketch_check}")
    # (c) the crash left one post-mortem that names the fault.
    if c_dumps != [f"flight-{os.getpid()}.json"] or {
            "point": "io.shard_decode", "call": crash_at,
            "error": "crash"} not in (c_dump.get("faults_fired") or []):
        fail(f"stream_cli (c): flight dumps {c_dumps}, fired "
             f"{c_dump.get('faults_fired')}")
    # (d) every transient retried and counted.
    retry = si["bd"]["retry"]
    if (retry["retries"], retry["recovered"], retry["exhausted"]) != (
            4, 4, 0):
        fail(f"stream_cli (d): retry counters {retry}")
    # (e) the day-2 run's provenance and its scores.
    if not {"ingest_cursor", "init_model"} <= set(run_meta):
        fail(f"stream_cli (e): the checkpoint's run meta holds "
             f"{sorted(run_meta)}")
    if score_rc != 0 or len(scores) != CLI_VALIDATION_ROWS or not (
            score_err <= 1e-5) or score_launches != chunks:
        fail(f"stream_cli (e): cli.score rc {score_rc}, error "
             f"{score_err}, {score_launches} launches for {chunks} chunks")
    # Every run's path through the kernels.
    for k, r in trained.items():
        if r["launches"] <= 0 or r["plain_route_solves"] != 0:
            fail(f"stream_cli ({k}): the Newton kernel did not take every "
                 "bucket")
        if r["segment_evaluation_launches"] <= 0:
            fail(f"stream_cli ({k}): the validation's grouped AUC launched "
                 "no segment sum")
        if r["segment_fixed_effect_launches"] <= 0:
            fail(f"stream_cli ({k}): the fixed effect's transpose launched "
                 "no segment sum")
    return {"newton_launches": newton, "segment_launches": segment,
            "fixed_effect_launches": fixed_effect,
            "serve_launches": score_launches, "row": row}


def stream_refusal_and_resume(torch, light: dict, root: str, bad_dir: str,
                              stream: tuple) -> dict:
    """Phase 14d's runs in this process: (b) the default policy's
    refusal of the truncated shard, then (c) a crash at io.shard_decode
    on shard 9 (serial decode, so the count is exact: 16 scan calls,
    then one a shard) and the resume, with ``obs.health`` armed, as (a)
    folds the ingest's health sketch (ingest-sketch.json)."""
    from photon_tpu_torch.cli import train as train_cli
    from photon_tpu_torch.data import pipeline
    from photon_tpu_torch.obs import health
    from photon_tpu_torch.resilience import faults, reset_retry_stats
    from photon_tpu_torch.resilience.errors import (
        CorruptShardError,
        InjectedCrash,
    )

    window = stream[2:]
    _, path = write_cli_config(light, os.path.join(root, "b-default"))
    refused = None
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli.main(["--config", path, "--device", "cuda",
                            "--stream-dir", bad_dir, *window])
    except CorruptShardError as exc:
        refused = str(exc)
    reset_retry_stats()
    crash_at = STREAM_SHARDS + 9 + 1
    c_root = os.path.join(root, "c")
    _, path = write_cli_config(light, c_root)
    crashed = None
    c_flight = os.path.join(c_root, "flight")
    health.reset()
    health.enable()
    with env_switch("PHOTON_TPU_SERIAL_INGEST", "1"), env_switch(
            "PHOTON_TPU_FAULT_PLAN", json.dumps({"faults": [
                {"point": "io.shard_decode", "nth": crash_at,
                 "error": "crash"}]})):
        pipeline.reset_executors()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                train_cli.main(["--config", path, "--device", "cuda",
                                "--checkpoint-dir",
                                os.path.join(c_root, "ckpt"),
                                "--flight-dir", c_flight, *stream])
        except InjectedCrash as exc:
            crashed = str(exc)
        finally:
            faults.disarm()
            pipeline.reset_executors()
    c_dumps = sorted(os.listdir(c_flight)) if os.path.isdir(
        c_flight) else []
    c_dump = {}
    if len(c_dumps) == 1:
        with open(os.path.join(c_flight, c_dumps[0])) as f:
            c_dump = json.load(f)
    c_work = os.path.join(c_root, "ckpt", "ingest-work")
    with open(os.path.join(c_work, "ingest-cursor.json")) as f:
        cursor = json.load(f)
    partial_rows = health.DataSketch.load(
        os.path.join(c_work, "ingest-sketch.json")).rows
    try:
        run_c = stream_run(torch, light, c_root, *stream, "--resume-ingest")
    finally:
        health.disable()
        health.reset()
    return {"refused": refused, "crash_at": crash_at, "crash": crashed,
            "dumps": c_dumps, "dump": c_dump, "cursor": cursor,
            "work": c_work, "partial_rows": partial_rows, "run": run_c}


def stream_sketch_check(a_work: str, c_work: str, partial_rows: int,
                        serve_sketch: str | None) -> dict:
    """(a)'s and the resumed (c)'s ``ingest-sketch.json``, byte for
    byte, then ``python -m photon_tpu_torch.cli.health --a <(a)'s work
    dir> --b <serve_sketch or (c)'s work dir> --json`` in a subprocess,
    its report printed."""
    from photon_tpu_torch.obs import health

    with open(os.path.join(a_work, "ingest-sketch.json"), "rb") as f:
        a_bytes = f.read()
    with open(os.path.join(c_work, "ingest-sketch.json"), "rb") as f:
        c_bytes = f.read()
    b = serve_sketch or c_work
    report_path = os.path.join(os.path.dirname(c_work), "health.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "photon_tpu_torch.cli.health", "--a", a_work,
         "--b", b, "--json", report_path], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)), timeout=300)
    seconds = time.perf_counter() - t0
    print(proc.stdout, flush=True)
    report = {}
    if proc.returncode == 0:
        with open(report_path) as f:
            report = json.load(f)["comparison"]
    return {"bytes_equal_a": a_bytes == c_bytes, "sketch_bytes": len(a_bytes),
            "rows": health.DataSketch.from_dict(json.loads(a_bytes)).rows,
            "partial_rows_at_crash": partial_rows,
            "cli_health_b": "serve_ops sketch" if serve_sketch else "(c)",
            "cli_health_rc": proc.returncode,
            "cli_health_seconds": seconds,
            "cli_health_stderr": proc.stderr[-2000:] if proc.returncode
            else None,
            "max_psi": report.get("max_psi"),
            "max_psi_surface": report.get("max_psi_surface"),
            "max_ks": report.get("max_ks"),
            "compared_columns": sorted(report.get("columns", {})),
            "compared_shards": sorted(report.get("shards", {}))}


def stream_fleet(files: dict, memory: dict, cli: dict) -> dict:
    """Gates of the in-memory child's ``--distributed --fleet-dir``
    (phase 14d (i)): ``python -m photon_tpu_torch.cli.fleetview`` merges
    its bundle (exit 0, ``--expect-ranks 1``); the bundle committed, the
    merged trace valid, one rank, no gap, a finite clock bound, fit
    seconds booked to each of 14a's trained coordinates, and the run's
    launches at every kernel site those of 14a's kernel run (the same
    files and configuration, the ledger off there)."""
    from photon_tpu_torch import obs

    run_dir = files["fleet"]
    host = os.path.join(run_dir, "obs-host-0")
    merged = os.path.join(os.path.dirname(run_dir), "merged.json")
    report_path = os.path.join(os.path.dirname(run_dir), "report.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "photon_tpu_torch.cli.fleetview",
         "--run-dir", run_dir, "--trace", merged, "--json", report_path,
         "--expect-ranks", "1"], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)), timeout=300)
    seconds = time.perf_counter() - t0
    print(proc.stdout, flush=True)
    report, bundle, events = {}, {}, None
    if proc.returncode == 0:
        with open(report_path) as f:
            report = json.load(f)
        events = obs.trace.validate_chrome_trace(merged)
    committed = os.path.exists(os.path.join(host, "bundle.json"))
    if committed:
        with open(os.path.join(host, "bundle.json")) as f:
            bundle = json.load(f)
    fit_rows = {r["coordinate"]: r["seconds"]
                for r in (bundle.get("ledger") or {}).get("rows", ())
                if r["phase"] == "fit" and r["coordinate"] != "-"
                and r["program"] == "coordinate_descent"}
    trained = sorted(cli["cfg"]["coordinates"])
    row = {"fleetview_rc": proc.returncode,
           "fleetview_seconds": seconds,
           "fleetview_stderr": proc.stderr[-2000:] if proc.returncode
           else None,
           "bundle_committed": committed,
           "bundle_bytes": sum(
               os.path.getsize(os.path.join(host, f))
               for f in ("bundle.json", "spans.jsonl")
               if os.path.exists(os.path.join(host, f))),
           "ship_bundle_seconds": memory.get("ship_bundle_seconds"),
           "merged_trace_events": events,
           "ranks": report.get("ranks"), "gaps": report.get("gaps"),
           "clock_skew_bound_seconds": report.get(
               "clock_skew_bound_seconds"),
           "attributed_seconds": [r["attributed_seconds"]
                                  for r in report.get("per_rank", ())],
           "fit_seconds_by_coordinate": fit_rows,
           "unattributed_seconds": next(
               (r["seconds"] for r in (bundle.get("ledger") or {}).get(
                   "rows", ()) if r["program"] == "unattributed"), None),
           "census": sorted((bundle.get("ledger") or {}).get(
               "programs", {})),
           "run_id": (bundle.get("host") or {}).get("run_id"),
           "newton_launches": {"memory": memory["launches"],
                               "train_cli": cli["newton_launches"]},
           "segment_launches_by_site": {
               "memory": memory["segment_launches_by_site"],
               "train_cli": cli["kernel_segment_launches_by_site"]}}
    if (proc.returncode != 0 or not committed or not events
            or report.get("ranks") != [0] or report.get("gaps")
            or not math.isfinite(report.get("clock_skew_bound_seconds",
                                            math.nan))):
        fail(f"stream_cli (i): the fleet bundle and its merge: {row}")
    if any(not fit_rows.get(cid, 0.0) > 0.0 for cid in trained):
        fail(f"stream_cli (i): fit seconds by coordinate {fit_rows}, "
             f"trained {trained}")
    if (memory["launches"] != cli["newton_launches"]
            or memory["segment_launches_by_site"]
            != cli["kernel_segment_launches_by_site"]):
        fail(f"stream_cli (i): the --distributed run launched otherwise "
             f"than 14a's kernel run: {row['newton_launches']}, "
             f"{row['segment_launches_by_site']}")
    return row


def stream_telemetry(files: dict) -> dict:
    """Gates of the in-memory child's ``--telemetry``, ``--trace`` and
    ``profile_dir`` (phase 14d): both files validate, the clean run left
    no flight dump, and the profiler's Chrome trace names the Newton and
    segment-sum kernels, whose spread fits inside the
    ``train_fit_profile`` span."""
    from photon_tpu_torch import obs

    n_lines = obs.validate_jsonl(files["telemetry"])
    n_events = obs.trace.validate_chrome_trace(files["trace"])
    with open(files["telemetry"]) as f:
        spans = [r for r in map(json.loads, f) if r["type"] == "span"]
    profile_spans = [s for s in spans if s["name"] == "train_fit_profile"]
    traces = sorted(p for p in os.listdir(files["profile"])
                    if p.endswith(".json"))
    kernels = []
    if len(traces) == 1:
        with open(os.path.join(files["profile"], traces[0])) as f:
            kernels = [e for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
    named = {k: [e for e in kernels if k in e.get("name", "").lower()]
             for k in ("newton", "segment_sum")}
    spread_s = ((max(e["ts"] + e.get("dur", 0) for e in kernels)
                 - min(e["ts"] for e in kernels)) / 1e6) if kernels else None
    row = {"telemetry_lines": n_lines, "trace_events": n_events,
           "profile_traces": traces, "kernel_events": len(kernels),
           "newton_kernel_events": len(named["newton"]),
           "segment_sum_kernel_events": len(named["segment_sum"]),
           "kernel_spread_seconds": spread_s,
           "train_fit_profile_seconds": [s["seconds"]
                                         for s in profile_spans],
           "coord_spans": sum("coord:" in s["path"] for s in spans),
           "flight_dumps": os.listdir(files["flight"])
           if os.path.isdir(files["flight"]) else []}
    if (len(traces) != 1 or not named["newton"]
            or not named["segment_sum"] or len(profile_spans) != 1
            or spread_s > profile_spans[0]["seconds"]
            or not row["coord_spans"] or row["flight_dumps"]):
        fail(f"stream_cli: the in-memory run's telemetry: {row}")
    return row


def timed_prepare(torch, est, data) -> tuple[dict, dict]:
    """``est.prepare(data)`` timed, with its PIPELINE_STATS report and
    packed transfers: (datasets, row)."""
    from photon_tpu_torch.data import pipeline

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    datasets, _ = est.prepare(data)
    torch.cuda.synchronize()
    return datasets, {
        "seconds": time.perf_counter() - t0,
        "report": pipeline.PIPELINE_STATS.report(),
        "packed_transfers": pipeline.PIPELINE_STATS.transfers()}


def warm_stage_row(torch, est, prepare_row: dict) -> dict:
    """``est``'s warm stage, which its prepare waited for at its end:
    the ``compile`` stage's seconds, the ``compile_wait`` the planning
    did not hide, the overlap fraction, and the capture's seconds and
    nodes."""
    from photon_tpu_torch.data import pipeline

    fut = est._aot_future
    art = fut.result() if fut is not None else None
    report = pipeline.PIPELINE_STATS.report()
    row = {"armed": fut is not None,
           "prepare_seconds": prepare_row["seconds"],
           "compile_seconds": pipeline.PIPELINE_STATS.seconds("compile"),
           "compile_wait_seconds": pipeline.PIPELINE_STATS.seconds(
               "compile_wait"),
           "compile_overlap_fraction": report["compile_overlap_fraction"]}
    cap = None if art is None else art["captured"]
    if cap is not None:
        row.update(capture_seconds=cap.seconds,
                   instantiate_seconds=cap.instantiate_seconds,
                   graph_nodes=cap.nodes,
                   conditional_nodes=cap.conditional_nodes)
    row["captured"] = cap is not None
    return row


def planner_comparison(torch, name: str, make_estimator, data, datasets,
                       pipelined: dict, again_estimator=None) -> dict:
    """The same prepare with ``PHOTON_TPU_SERIAL_INGEST=1`` on a fresh
    estimator, then pipelined once more (pipelined, serial, pipelined:
    the first run's place in the process is not the path's), the last
    on ``again_estimator()`` when given (the bf16 estimator, whose warm
    capture runs beside its planning: ``warm_stage_row``): the seconds
    of each, and every run's packed plan buffers compared with the
    first's on the card (exact int32 equality). Returns the row, with
    the last estimator under ``estimator`` (not printed)."""
    from photon_tpu_torch.data import pipeline
    from photon_tpu_torch.utils import device_loop

    def same_plans(other) -> bool:
        views = [(ds.packed_view, other[cid].packed_view)
                 for cid, ds in datasets.items()
                 if getattr(ds, "packed_view", None) is not None]
        return bool(views) and all(
            a.shapes == b.shapes and a.buffer.shape == b.buffer.shape
            and bool(torch.equal(a.buffer, b.buffer)) for a, b in views)

    with env_switch("PHOTON_TPU_SERIAL_INGEST", "1"):
        pipeline.reset_executors()
        serial, serial_row = timed_prepare(torch, make_estimator(), data)
    pipeline.reset_executors()
    identical = same_plans(serial)
    del serial
    again_est = (again_estimator or make_estimator)()
    again, again_row = timed_prepare(torch, again_est, data)
    again_row["warm_stage"] = warm_stage_row(torch, again_est, again_row)
    identical = identical and same_plans(again)
    del again
    row = {"phase": f"planner_{name}", "pipelined": pipelined,
           "serial": serial_row, "pipelined_again": again_row,
           "identical": identical,
           "speedup": [serial_row["seconds"] / pipelined["seconds"],
                       serial_row["seconds"] / again_row["seconds"]],
           "cpu_count": os.cpu_count(),
           "ingest_threads_env": os.environ.get("PHOTON_TPU_INGEST_THREADS"),
           "ingest_threads": pipeline.ingest_threads(),
           "torch_threads": torch.get_num_threads()}
    emit(row)
    device_loop.empty_cache()
    if not identical:
        fail(f"planner_{name}: the serial and pipelined plans differ")
    return dict(row, estimator=again_est)


# ---------------------------------------------------------------------------
# the optimizer routes: TRON, OWL-QN, variances and an incremental refit
# ---------------------------------------------------------------------------

ROUTES_CD_ITERATIONS = 2
VARIANCE_SAMPLE = 256
F32_EPS = 2.0 ** -24


def routes_estimator(device=None, incremental: bool = False,
                     num_iterations: int = ROUTES_CD_ITERATIONS,
                     fused: bool = False):
    """The logistic training configuration (``build_estimator``'s data
    configurations and intercepts) on the slice's routes: ``global`` TRON
    with L2 1e-3 and FULL variances; ``per-user`` L2 1 with SIMPLE
    variances (the Newton kernel); ``per-movie`` elastic net, alpha 0.5
    and weight 1 (L1 0.5 + L2 0.5: the batched OWL-QN route), with SIMPLE
    variances so that the refit has a prior for every coordinate. Unless
    ``fused``, a no-op listener keeps it on the unfused loop, whose
    updates ``update_recorder`` records."""
    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm.problems import (
        GLMOptimizationConfiguration,
        VarianceComputationType,
    )

    base = build_estimator(device=device)

    def cfg(reg, weight, variance, opt=None, alpha=None):
        return GLMOptimizationConfiguration(
            optimizer=opt or optim.OptimizerConfig(),
            regularization=optim.RegularizationContext(reg, alpha),
            regularization_weight=weight,
            variance_computation=VarianceComputationType[variance])

    opts = {
        "global": cfg(optim.RegularizationType.L2, 1e-3, "FULL",
                      optim.OptimizerConfig.tron()),
        "per-user": cfg(optim.RegularizationType.L2, 1.0, "SIMPLE"),
        "per-movie": cfg(optim.RegularizationType.ELASTIC_NET, 1.0,
                         "SIMPLE", alpha=0.5),
    }
    base.coordinate_configs = {
        cid: dataclasses.replace(c, optimization=opts[cid])
        for cid, c in base.coordinate_configs.items()}
    base.num_iterations = num_iterations
    base.incremental_training = incremental
    if not fused:
        from photon_tpu_torch.events import EventEmitter

        base.emitter = EventEmitter([lambda e: None])
    return base


def fused_routes_check(torch) -> dict:
    """The routes configuration at a tenth of the rows, users and
    movies, fused (TRON's CG, the batched OWL-QN's line search, L-BFGS
    and the variances, each loop a conditional node of the graph)
    against the unfused fit on the card: within route_agreement's
    tolerances, the training losses within 1e-4."""
    arrays = synth_arrays(**REDUCED)
    data = train_dataset(arrays)
    fits = {}
    for name in ("unfused", "fused"):
        est = routes_estimator(fused=name == "fused")
        est.prepare(data)
        t0 = time.perf_counter()
        res = est.fit(data)[0]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if (est._fused_cache is not None) != (name == "fused"):
            fail(f"train_routes_fused: the {name} fit took the other path")
        datasets, _ = est.prepare(data)
        total, _ = total_scores(torch, res.model, datasets, data)
        fits[name] = dict(model=res.model, seconds=secs,
                          objective=fit_objective(torch, total, data))
    cap = next(iter(est._fused_cache.values())).captured()
    u, f = fits["unfused"], fits["fused"]
    row = {"phase": "train_routes_fused", **REDUCED,
           "unfused_fit_seconds": u["seconds"],
           "fused_cold_fit_seconds": f["seconds"],
           "capture_seconds": cap.seconds, "graph_nodes": cap.nodes,
           "conditional_nodes": cap.conditional_nodes,
           "objective_rel_diff": abs(u["objective"] - f["objective"])
           / abs(u["objective"])}
    ok = True
    for cid in ("global",) + RE_IDS:
        a = (f["model"][cid].model.coefficients.means if cid == "global"
             else f["model"][cid].coefficients)
        b = (u["model"][cid].model.coefficients.means if cid == "global"
             else u["model"][cid].coefficients)
        atol = FIT_ATOL if cid == "global" else RE_FIT_ATOL
        gate = (a - b).abs() - (atol + FIT_RTOL * b.abs())
        row[f"{cid}_max_abs_diff"] = float((a - b).abs().max())
        row[f"{cid}_max_excess"] = float(gate.max())
        ok = ok and float(gate.max()) <= 0.0
    emit(row)
    if not ok or not row["objective_rel_diff"] <= 1e-4:
        fail(f"train_routes_fused: the fused and unfused fits differ: {row}")
    return row


@contextlib.contextmanager
def update_recorder(torch, device):
    """Record each coordinate update of the fits run in the block: its
    seconds (ending in a sync), Newton launches, the batched route's and
    the Newton loop's host syncs, iterations, and the residuals and model
    of each coordinate's last update (for the optimality checks)."""
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.estimators import game_estimator as ge
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.optim import batched

    rows, last = [], {}

    def wrap(cls, name_of):
        orig = cls.train

        def train(self, residuals=None, initial_model=None, *, seed=0):
            before = (nk.launches, batched.host_syncs, ra.host_syncs)
            sync(torch, device)
            t0 = time.perf_counter()
            model, diag = orig(self, residuals, initial_model, seed=seed)
            sync(torch, device)
            cid = name_of(self)
            if hasattr(diag, "iterations_max"):
                its = {"iterations_max": diag.iterations_max,
                       "iterations_mean": diag.iterations_mean,
                       "reasons": diag.convergence_reason_counts}
            else:
                its = {"iterations": int(diag.iterations),
                       "reason": int(diag.convergence_reason)}
            rows.append({"coordinate": cid,
                         "seconds": time.perf_counter() - t0,
                         "newton_launches": nk.launches - before[0],
                         "batched_host_syncs":
                             batched.host_syncs - before[1],
                         "newton_host_syncs": ra.host_syncs - before[2],
                         **its})
            last[cid] = (residuals, model, diag)
            return model, diag

        cls.train = train
        return orig

    saved = {ra.RandomEffectCoordinate: wrap(
                 ra.RandomEffectCoordinate,
                 lambda c: {"userId": "per-user", "movieId": "per-movie"}[
                     c.dataset.config.random_effect_type]),
             ge._FixedEffectModelAdapter: wrap(
                 ge._FixedEffectModelAdapter, lambda c: "global")}
    try:
        yield rows, last
    finally:
        for cls, orig in saved.items():
            cls.train = orig


def sync(torch, device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def routes_fit(torch, data, est, device, **fit_kw):
    """One fit with every count zeroed just before; (row, result, last)."""
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.optim import batched

    nk.launches = 0
    ra.host_syncs = ra.plain_route_solves = ra.quasi_newton_solves = 0
    batched.host_syncs = 0
    with update_recorder(torch, device) as (rows, last):
        t0 = time.perf_counter()
        res = est.fit(data, **fit_kw)[0]
        sync(torch, device)
        secs = time.perf_counter() - t0
    row = {"fit_seconds": secs, "newton_launches": nk.launches,
           "plain_route_solves": ra.plain_route_solves,
           "quasi_newton_solves": ra.quasi_newton_solves,
           "batched_host_syncs": batched.host_syncs,
           "newton_host_syncs": ra.host_syncs, "updates": rows}
    return row, res, last


def fe_hessian_parts(torch, data, residuals, w, l2, icpt):
    """(gradient, Hessian) of the fixed effect's L2 objective in float64
    at ``w`` with the update's residual offsets; intercept unpenalized."""
    x = data.feature_shards["global"].x.double()
    z = x @ w + data.offsets.double() + (
        0.0 if residuals is None else residuals.double())
    p = torch.sigmoid(z)
    wt = data.weights.double()
    pen = torch.full_like(w, l2)
    pen[icpt] = 0.0
    g = x.T @ (wt * (p - data.labels.double())) + pen * w
    h = x.T @ ((wt * p * (1 - p))[:, None] * x) + torch.diag(pen)
    return g, h


def fe_objective(torch, data, residuals, w, l2, icpt) -> float:
    """The fixed effect's L2 objective in float64 at ``w`` with the
    update's residual offsets; intercept unpenalized."""
    from photon_tpu_torch.ops import losses

    x = data.feature_shards["global"].x.double()
    z = x @ w + data.offsets.double() + (
        0.0 if residuals is None else residuals.double())
    pen = torch.full_like(w, l2)
    pen[icpt] = 0.0
    return float(torch.sum(data.weights.double() * losses.LOGISTIC.loss(
        z, data.labels.double())) + 0.5 * torch.sum(pen * w * w))


class _LastSolve:
    """Records the last call of ``optim.<name>`` made while active: its
    arguments and result, so that a check can replay the solve."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        from photon_tpu_torch import optim

        self._real = real = getattr(optim, self.name)
        self.call = None

        def spy(*args, **kw):
            result = real(*args, **kw)
            self.call = (args, kw, result)
            return result

        setattr(optim, self.name, spy)
        return self

    def __exit__(self, *exc):
        from photon_tpu_torch import optim

        setattr(optim, self.name, self._real)
        return False


def phase_routes_fixed_effect(torch, data, residuals, glm, diag, l2, icpt,
                              tron_call) -> dict:
    """Gate (c): the fixed effect's TRON stopped for the reason it
    reports, as float64 sees it at the fitted coefficients (no
    normalization, so the solver's space is the model's):
    GRADIENT_CONVERGED, the float64 gradient under TRON's tolerance
    (1e-5 of its norm at zero); FUNCTION_VALUES_CONVERGED, the float64
    decrease of the last accepted step under the cascade's loss
    tolerance (1e-5 of F at zero), the step's start replayed by the same
    solve cut one iteration short (its loss history must equal the
    fit's); OBJECTIVE_NOT_IMPROVING, where the f32 objective no
    longer resolves an improvement, F - F* <= 4 u F, so |g| <=
    sqrt(2 lambda_max (F - F*)) = sqrt(8 u F lambda_max), lambda_max the
    Hessian's largest eigenvalue. Any other reason fails. Gate (d) for
    FULL: its variances within the f32 bound of the float64 diagonal of
    the inverse Hessian."""
    from photon_tpu_torch.optim import ConvergenceReason as R

    w = glm.coefficients.means.double()
    g, h = fe_hessian_parts(torch, data, residuals, w, l2, icpt)
    g0, _ = fe_hessian_parts(torch, data, residuals, torch.zeros_like(w),
                             l2, icpt)
    gn, g0n = float(torch.linalg.vector_norm(g)), float(
        torch.linalg.vector_norm(g0))
    f = fe_objective(torch, data, residuals, w, l2, icpt)
    f_zero = fe_objective(torch, data, residuals, torch.zeros_like(w), l2,
                          icpt)
    eig = torch.linalg.eigvalsh(h)
    resolution = math.sqrt(8.0 * F32_EPS * f * float(eig[-1]))
    reason, k = R(int(diag.convergence_reason)), int(diag.iterations)
    (fun, hvp, w0, config), kw, result = tron_call
    if not torch.equal(result.coefficients.double(), w):
        fail("train_routes: the recorded TRON solve is not the fixed "
             "effect's last update")
    # The last accepted step's start: the same solve cut one short.
    if k > 1:
        prev = tron_call_replay(fun, hvp, w0, config, kw, k - 1)
        replayed = bool(torch.equal(prev.loss_history[:k],
                                    result.loss_history[:k]))
        w_prev = prev.coefficients.double()
    else:
        replayed, w_prev = True, w0.double()
    f_prev = fe_objective(torch, data, residuals, w_prev, l2, icpt)
    step_decrease = f_prev - f
    f32_decrease = float(result.loss_history[k - 1] - result.loss_history[k])
    want = torch.diagonal(torch.linalg.inv(h)).cpu().numpy()
    got = glm.coefficients.variances.double().cpu().numpy()
    cond = float(eig[-1] / eig[0])
    n, d = data.num_samples, w.shape[0]
    # f32 Hessian entries summed over n rows: a random walk of about
    # sqrt(n) u relative; Cholesky and its solve add about d u; the
    # inverse carries both times cond(H). Three standard deviations.
    bound = 3.0 * (math.sqrt(n) + d) * F32_EPS * cond
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    row = {"phase": "train_routes_fixed_effect",
           "iterations": k, "reason": reason.name,
           "gradient_norm": gn, "tron_tolerance": 1e-5 * g0n,
           "last_step_decrease": step_decrease,
           "last_step_decrease_f32": f32_decrease,
           "loss_tolerance": 1e-5 * abs(f_zero),
           "replay_loss_history_equal": replayed,
           "f32_resolution": resolution,
           "variance_max_rel_err": rel, "variance_rel_bound": bound,
           "hessian_cond": cond}
    emit(row)
    if reason == R.GRADIENT_CONVERGED:
        ok = gn <= 1e-5 * g0n
    elif reason == R.FUNCTION_VALUES_CONVERGED:
        ok = replayed and abs(step_decrease) <= row["loss_tolerance"]
    elif reason == R.OBJECTIVE_NOT_IMPROVING:
        ok = gn <= resolution
    else:
        ok = False
    if not ok:
        fail(f"train_routes: the fixed effect's TRON stopped by "
             f"{reason.name}, which float64 does not confirm: {row}")
    if not rel <= bound:
        fail(f"train_routes: fixed-effect FULL variances {rel} from float64 "
             f"(bound {bound})")
    return row


def tron_call_replay(fun, hvp, w0, config, kw, iterations: int):
    """A recorded TRON solve again, stopped after ``iterations``
    accepted steps."""
    from photon_tpu_torch import optim

    return optim.tron_solve(fun, hvp, w0, dataclasses.replace(
        config, max_iterations=iterations), **kw)


def phase_routes_variances(torch, datasets, last, l2s) -> dict:
    """Gate (d) for the random effects: SIMPLE variances of
    VARIANCE_SAMPLE sampled entities of every bucket against float64
    1 / (sum c x^2 + l2 pen) at the fitted coefficients and the
    update's residuals. The f32 bound: the diagonal sums R nonnegative
    terms (at most (R - 1) u of it) and each curvature comes from an f32
    margin of S products (at most S u M of the margin, M its largest
    sum |x w|, moving c by as much relative): (R + S M + 4) u."""
    rng = np.random.default_rng(SEED + 9)
    out = {}
    for cid in RE_IDS:
        residuals, model, _ = last[cid]
        w_all = model.coefficients.double()
        v_all = model.variances.double()
        worst = worst_ratio = 0.0
        for eb in datasets[cid].device_blocks():
            b = eb.num_entities
            pick = torch.from_numpy(np.sort(rng.choice(
                b, size=min(b, VARIANCE_SAMPLE), replace=False))).to(
                eb.labels.device)
            sub = type("S", (), {})()
            for f in ("x_values", "x_indices", "offsets", "weights",
                      "labels", "row_ids", "penalty_mask", "valid_mask",
                      "entity_codes"):
                v = getattr(eb, f)
                setattr(sub, f, None if v is None else v[pick])
            sub.sub_dim = eb.sub_dim
            x = dense_x(torch, sub)
            off = coordinate_offsets(sub, residuals)
            codes = sub.entity_codes.long()
            w = w_all[codes][:, :x.shape[-1]]
            z = torch.einsum("brs,bs->br", x, w) + off
            p = torch.sigmoid(z)
            c = sub.weights.double() * p * (1 - p)
            diag = (torch.einsum("brs,br->bs", x * x, c)
                    + l2s[cid] * sub.penalty_mask.double())
            vm = sub.valid_mask > 0
            want = torch.where(diag == 0, torch.inf, 1.0 / diag)
            got = v_all[codes][:, :x.shape[-1]]
            m = float(torch.einsum("brs,bs->br", x.abs(), w.abs()).max())
            r, s = x.shape[1], x.shape[2]
            bound = (r + s * m + 4) * F32_EPS
            ok = vm & torch.isfinite(want)
            rel = ((got - want).abs() / want.abs())[ok]
            err = float(rel.max()) if rel.numel() else 0.0
            if not bool((torch.isinf(got) == torch.isinf(want))[vm].all()):
                fail(f"train_routes: {cid} variances disagree on which "
                     "slots have no curvature")
            worst = max(worst, err)
            worst_ratio = max(worst_ratio, err / bound)
        out[cid] = {"max_rel_err": worst, "max_err_over_bound": worst_ratio}
    row = {"phase": "train_routes_variances", "sample": VARIANCE_SAMPLE,
           **out}
    emit(row)
    if not all(v["max_err_over_bound"] <= 1.0 for v in out.values()):
        fail(f"train_routes: random-effect variances outside their f32 "
             f"bound: {out}")
    return row


def routes_agreement(torch, devices=("cuda", "cpu")) -> dict:
    """Gate (e): the first fit at a tenth of the rows, users and movies
    on the card and on the CPU (``device="cpu"``), both f32, within
    route_agreement's tolerances; training losses within 1e-4."""
    arrays = synth_arrays(**REDUCED)
    fits = {}
    for device in devices:
        data = train_dataset(arrays, device=device)
        est = routes_estimator(device=device)
        row, res, _ = routes_fit(torch, data, est, device)
        datasets, _ = est.prepare(data)
        total, _ = total_scores(torch, res.model, datasets, data)
        fits[device] = dict(model=res.model, seconds=row["fit_seconds"],
                            objective=fit_objective(torch, total, data),
                            launches=row["newton_launches"])
        del data, datasets, total
    k, p = (fits[d] for d in devices)
    row = {"phase": "train_routes_agreement", **REDUCED,
           "card_fit_seconds": k["seconds"], "cpu_fit_seconds": p["seconds"],
           "newton_launches": [k["launches"], p["launches"]],
           "objective_rel_diff": abs(k["objective"] - p["objective"])
           / abs(p["objective"])}
    ok = True
    for cid in ("global",) + RE_IDS:
        a = (k["model"][cid].model.coefficients.means if cid == "global"
             else k["model"][cid].coefficients).double().cpu()
        b = (p["model"][cid].model.coefficients.means if cid == "global"
             else p["model"][cid].coefficients).double()
        atol = FIT_ATOL if cid == "global" else RE_FIT_ATOL
        gate = (a - b).abs() - (atol + FIT_RTOL * b.abs())
        row[f"{cid}_max_abs_diff"] = float((a - b).abs().max())
        row[f"{cid}_max_excess"] = float(gate.max())
        ok = ok and float(gate.max()) <= 0.0
    emit(row)
    if k["launches"] <= 0 or p["launches"] != 0:
        fail(f"train_routes: the card and CPU fits did not take their "
             f"routes: {row}")
    if not ok or not row["objective_rel_diff"] <= 1e-4:
        fail(f"train_routes: the card's fit and the CPU's differ: {row}")
    return row


def phase_train_routes(torch, device="cuda") -> dict:
    """The logistic training configuration at full width on the slice's
    routes (module docstring, phase 14c); returns the Newton launches of
    both fits. ``device="cpu"`` runs its logic on the plain versions."""
    t0 = time.perf_counter()
    arrays = synth_arrays()
    data = train_dataset(arrays, device=device)
    sync(torch, device)
    setup_s = time.perf_counter() - t0
    est = routes_estimator(device=device)
    t0 = time.perf_counter()
    datasets, _ = est.prepare(data)
    plan_s = time.perf_counter() - t0
    del arrays
    with _LastSolve("tron_solve") as tron:
        first, res, last = routes_fit(torch, data, est, device)
    emit({"phase": "train_routes_fit", "fit": "first",
          "setup_seconds": setup_s, "planner_host_seconds": plan_s,
          **first})
    # (a) the Newton kernel took every per-user bucket.
    if first["newton_launches"] <= 0 or first["plain_route_solves"] != 0:
        fail(f"train_routes: per-user did not take the Newton kernel on "
             f"every bucket: {first['newton_launches']} launches, "
             f"{first['plain_route_solves']} plain-route solves")
    if first["quasi_newton_solves"] <= 0:
        fail("train_routes: per-movie did not take the quasi-Newton route")
    opt = {cid: est.coordinate_configs[cid].optimization for cid in
           est.coordinate_configs}
    # (b) OWL-QN's optimality, at the residuals of per-movie's last update.
    mres, mmodel, mstats = last["per-movie"]
    entity_optimality(torch, datasets["per-movie"], mres, mmodel,
                      mstats.reasons, opt["per-movie"].l2_weight,
                      l1=opt["per-movie"].l1_weight,
                      phase="train_routes_owlqn_optimality",
                      cid="per-movie")
    gres, gmodel, gdiag = last["global"]
    phase_routes_fixed_effect(torch, data, gres, gmodel.model, gdiag,
                              opt["global"].l2_weight, TRAIN_FEATURES - 1,
                              tron.call)
    phase_routes_variances(torch, datasets, last,
                           {cid: opt[cid].l2_weight for cid in RE_IDS})
    # The incremental refit: one iteration from the first fit's model,
    # every coordinate's prior its variances.
    inc = routes_estimator(device=device, incremental=True,
                           num_iterations=1)
    second, res2, _ = routes_fit(torch, data, inc, device,
                                 initial_model=res.model)
    moved = float((res2.model["per-user"].coefficients
                   - res.model["per-user"].coefficients).abs().max())
    emit({"phase": "train_routes_fit", "fit": "incremental",
          "per_user_max_move": moved, **second})
    if second["newton_launches"] <= 0 or second["plain_route_solves"] != 0:
        fail("train_routes: the incremental refit did not take the Newton "
             "kernel on every per-user bucket")
    del data, datasets, res, res2, last
    if device == "cuda":
        empty_cache()
        fused_routes_check(torch)
    routes_agreement(torch, (device, "cpu"))
    return {"newton_launches": first["newton_launches"]
            + second["newton_launches"]}


def train_cli_routes_config(cli: dict) -> dict:
    """Phase 14a's configuration on the slice's routes: ``global`` TRON
    with FULL variances and down-sampling at 0.5; ``per-user`` L2
    [1, 10] with SIMPLE variances; ``per-movie`` L1 weight 1 (OWL-QN)
    with SIMPLE variances, so that the incremental run has a prior for
    every coordinate."""
    cfg = json.loads(json.dumps(cli["cfg"]))
    coords = cfg["coordinates"]
    coords["global"].update(optimizer={"type": "TRON"},
                            variance_computation="FULL",
                            down_sampling_rate=0.5)
    coords["per-user"].update(variance_computation="SIMPLE")
    coords["per-movie"].update(regularization={"type": "L1",
                                               "weights": [1.0]},
                               variance_computation="SIMPLE")
    return cfg


def entity_feature_table(model) -> dict | None:
    """A random-effect model's variances by (entity key, feature id),
    whatever the slot layout the model was loaded into; None when a
    model with coefficients has no variances."""
    rows, slots = np.nonzero(model.proj_all >= 0)
    if model.variances is None:
        return None if rows.size else {}
    v = model.variances.double().numpy()
    keys = np.asarray(model.entity_keys, dtype=object)[rows]
    return dict(zip(zip(keys.tolist(),
                        model.proj_all[rows, slots].tolist()),
                    v[rows, slots].tolist()))


def phase_train_cli_routes(torch, cli: dict) -> dict:
    """``cli.train`` on the slice's routes over phase 14a's files, then an
    incremental ``cli.train`` from the first run's best model, then
    ``cli.score`` of the validation file with the second run's best
    model (module docstring, phase 14b)."""
    from photon_tpu_torch.cli import score as score_cli
    from photon_tpu_torch.io import avro
    from photon_tpu_torch.io.avro_data import read_merged
    from photon_tpu_torch.io.model_io import load_checkpoint, load_game_model
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.programs import ShapeLadder

    root = os.path.join(cli["root"], "routes")
    cfg = train_cli_routes_config(cli)
    first = run_train_cli(torch, cfg, os.path.join(root, "first"), False)
    best_ckpt = os.path.join(first["out"], "models", "best",
                             "checkpoint.npz")
    inc = dict(cfg, incremental_training=True)
    second = run_train_cli(torch, inc, os.path.join(root, "incremental"),
                           False, "--init-model", best_ckpt)
    # The written Avro models carry variances and read back equal to the
    # run's native checkpoint.
    _, maps = read_merged(cli["files"]["train"]["data"],
                          feature_shards=CLI_SHARDS,
                          id_tag_names=["userId", "movieId"], device="cpu")
    mismatched = []
    for run in (first, second):
        best = os.path.join(run["out"], "models", "best")
        avro_model, _ = load_game_model(best, maps, device="cpu")
        native = load_checkpoint(os.path.join(best, "checkpoint.npz"), "cpu")
        for cid in ("global",) + RE_IDS:
            a, b = avro_model[cid], native[cid]
            if cid == "global":
                va, vb = (m.model.coefficients.variances for m in (a, b))
                same = (va is not None and vb is not None
                        and np.array_equal(va.double().numpy(),
                                           vb.double().numpy()))
            else:
                ta = entity_feature_table(a)
                same = ta is not None and ta == entity_feature_table(b)
            if not same:
                mismatched.append((run["root"], cid))
    # Score the validation file with the incremental run's best model.
    val = cli["files"]["validation"]
    best_dir = os.path.join(second["out"], "models", "best")
    score_out = os.path.join(root, "scores")
    serve_kernel.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = score_cli.main([
            "--model-dir", best_dir, "--input", val["data"],
            "--output", score_out, "--feature-shards",
            *[f"{s}={b[0]}" for s, b in CLI_SHARDS.items()],
            "--id-tags", "userId", "movieId", "--device", "cuda",
            "--evaluators", *CLI_EVALUATORS])
    score_launches = serve_kernel.launches
    chunks = len(ShapeLadder(SCORE_RUNGS).chunk_plan(CLI_VALIDATION_ROWS))
    scores = np.array([r["predictionScore"] for r in avro.read_container_dir(
        os.path.join(score_out, "part-00000.avro"))])
    exact = numpy_model_scores(best_dir, val["data"])
    score_err = float(np.max(np.abs(scores - exact) / (1.0 + np.abs(exact))))
    with open(os.path.join(score_out, "evaluation.json")) as f:
        score_auc = json.load(f)["AUC"]
    aucs = [r["summary"]["configurations"][
        r["summary"]["best_configuration_index"]]["evaluation"]["AUC"]
        for r in (first, second)]
    gen_auc = cli["generating_auc"]
    row = {"phase": "train_cli_routes",
           "seconds": [first["summary"]["seconds"],
                       second["summary"]["seconds"]],
           "wall_seconds": [first["wall_seconds"], second["wall_seconds"]],
           "newton_launches": [first["launches"], second["launches"]],
           "plain_route_solves": [first["plain_route_solves"],
                                  second["plain_route_solves"]],
           "validation_auc": aucs, "generating_auc": gen_auc,
           "score_auc": score_auc, "score_launches": score_launches,
           "score_chunks": chunks, "score_max_rel_err_numpy_f64": score_err,
           "variance_mismatches": mismatched}
    emit(row)
    if mismatched:
        fail(f"train_cli_routes: variances missing or unequal after the "
             f"round trip: {mismatched}")
    if min(row["newton_launches"]) <= 0 or max(row["plain_route_solves"]):
        fail(f"train_cli_routes: the runs did not take the Newton kernel on "
             f"every per-user bucket: {row}")
    if not min(aucs) - 0.5 >= 0.5 * (gen_auc - 0.5):
        fail(f"train_cli_routes: validation AUC {aucs} recovers under half "
             f"the generating model's lift ({gen_auc})")
    if rc != 0 or len(scores) != CLI_VALIDATION_ROWS or not np.isfinite(
            scores).all():
        fail("train_cli_routes: cli.score did not score every row")
    if not score_err <= 1e-5:
        fail(f"train_cli_routes: scores differ from the numpy score by "
             f"{score_err}")
    if score_launches != chunks:
        fail(f"train_cli_routes: {score_launches} serve launches for "
             f"{chunks} chunks")
    return {"newton_launches": sum(row["newton_launches"]),
            "fixed_effect_launches": sum(
                r["segment_launches_by_site"].get("fixed_effect", 0)
                for r in (first, second)),
            "serve_launches": score_launches}


# ---------------------------------------------------------------------------
# the pilot on the card: ingest -> train -> validate -> promote -> observe
# ---------------------------------------------------------------------------

# bench.py:223: every feature value of the shifted day moves by this.
DRIFT_SHIFT = 4.0
# The watched directory's days, from train_cli's part files: (a) the
# bootstrap, (b) two more days, (c) a day of part 6's rows shifted by
# DRIFT_SHIFT, (d) after a restart, the shifted day taken out and a
# replay of part 2's rows whose entities already train (``replay_rows``:
# no new entity or feature, so (d)'s promotion and its rollback are
# values-only reloads).
PILOT_BOOT_PARTS = (0, 1, 2, 3)
PILOT_DAY_PARTS = (4, 5)
PILOT_SHIFTED_PART = 6
PILOT_REPLAY_PART = 2
PILOT_TRAFFIC_QPS = 1000.0
PILOT_SAMPLE = 64
PILOT_OBSERVE_S = 2.0
# Seconds between the pilot's polls of the watched directory: its IDLE
# windows, whose traffic is the baseline of the TRAIN window's.
PILOT_POLL_S = 1.0


def pilot_config(cli: dict, root: str) -> tuple[dict, str]:
    """``train_cli``'s coordinates at their widths with one lambda a
    coordinate (its first) and one CD iteration, AUC and AUC:userId on
    the validation file (a directory of its own: the stream reads
    directories), windows of 2 shards, the serving ladder's rungs,
    health armed (drift 0.25, non-finite coefficients; the skew gate
    off: the traffic is synthetic, not drawn from the training rows),
    a 2 s observation window. Written to ``root/pilot.json``."""
    holdout = os.path.join(root, "holdout")
    os.makedirs(holdout, exist_ok=True)
    link = os.path.join(holdout, "part-00000.avro")
    if not os.path.exists(link):
        os.symlink(os.path.abspath(cli["files"]["validation"]["data"]),
                   link)
    base = cli["cfg"]
    cfg = {
        "task": base["task"],
        "coordinates": {cid: dict(c, regularization={
            "type": "L2", "weights": c["regularization"]["weights"][:1]})
            for cid, c in base["coordinates"].items()},
        "num_iterations": 1,
        "evaluators": CLI_EVALUATORS,
        "stream_dir": os.path.join(root, "watch"),
        "work_dir": os.path.join(root, "work"),
        "validation_dir": holdout,
        "window_shards": STREAM_WINDOW,
        "keep_generations": 3,
        "promotion": {"min_delta": {"AUC": -0.005}},
        "observe": {"window_s": PILOT_OBSERVE_S, "poll_s": 0.05,
                    "max_dispatch_errors": 0},
        "serve": {"rungs": list(RUNGS), "max_linger_ms": 2.0},
        "ingest": {"feature_shards": CLI_SHARDS,
                   "id_tag_names": ["userId", "movieId"]},
        "health": {"max_drift_psi": 0.25, "max_skew_psi": None,
                   "forbid_nonfinite": True},
    }
    path = os.path.join(root, "pilot.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg, path


def part_rows(train: dict, part: int) -> np.ndarray:
    """The row indices of train_cli's part file ``part``."""
    n = len(train["labels"])
    step = -(-n // STREAM_SHARDS)
    return np.arange(part * step, min((part + 1) * step, n))


def write_rows(train: dict, rows: np.ndarray, path: str,
               shift: float = 0.0) -> None:
    """train_cli's rows ``rows`` again as one part file at ``path``, every
    feature value of every bag moved by ``shift`` (labels, ids, uids,
    weights and offsets as written)."""
    def bag(s):
        idx, val = train["feats"][s]
        ks = train["keys"][s]
        return [list(zip([ks[j] for j in r], v)) for r, v in zip(
            idx[rows].tolist(), (val[rows] + shift).tolist())]

    meta = [{"userId": str(u), "movieId": str(m)} for u, m in zip(
        train["users"][rows].tolist(), train["movies"][rows].tolist())]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_part((path, train["labels"][rows], bag("global"),
                train["offsets"][rows].astype(np.float32),
                train["weights"][rows].astype(np.float32), meta, rows,
                {SCORE_SHARDS[s][0]: bag(s)
                 for s in ("userShard", "movieShard")}))


def replay_rows(train: dict) -> np.ndarray:
    """Part PILOT_REPLAY_PART's rows whose user and movie both already
    train on the parts (b) promoted (at least CLI_MIN_ROWS rows there):
    landed again, they add no entity and no feature to any entity's
    subspace, so the tables keep their structure."""
    seen = np.concatenate([part_rows(train, k) for k in
                           PILOT_BOOT_PARTS + PILOT_DAY_PARTS])
    rows = part_rows(train, PILOT_REPLAY_PART)
    keep = np.ones(len(rows), dtype=bool)
    for key in ("users", "movies"):
        ids = train[key]
        trained = np.bincount(ids[seen], minlength=int(ids.max()) + 1)
        keep &= trained[ids[rows]] >= CLI_MIN_ROWS
    return rows[keep]


def pilot_jobs(cli: dict) -> list:
    """Phase 14g's children, as one chain for ``cli_children``: the
    pilot under traffic for cycles (a)-(c), then its restart for (d).
    The parts land in the watched directory from the child (copies, so
    their mtimes are the landing times staleness counts from)."""
    import shutil

    root = os.path.join(cli["root"], "pilot")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "watch"))
    cfg, path = pilot_config(cli, root)
    parts = cli["files"]["train"]["data"]

    def part(k):
        return os.path.join(parts, f"part-{k:05d}.avro")

    train = cli["files"]["train"]
    shifted = os.path.join(root, "shifted",
                           f"part-{PILOT_SHIFTED_PART:05d}.avro")
    replay = os.path.join(root, "replay",
                          f"part-{PILOT_REPLAY_PART:05d}-replay.avro")
    t0 = time.perf_counter()
    write_rows(train, part_rows(train, PILOT_SHIFTED_PART), shifted,
               DRIFT_SHIFT)
    replayed = replay_rows(train)
    write_rows(train, replayed, replay)
    emit({"phase": "pilot_cli", "step": "files",
          "files_seconds": time.perf_counter() - t0,
          "drift_shift": DRIFT_SHIFT, "replay_rows": len(replayed)})
    common = {"kind": "pilot", "config": path, "watch": cfg["stream_dir"],
              "work": cfg["work_dir"], "flight": os.path.join(root, "flight")}
    argv = ["--config", path, "--device", "cuda",
            "--poll-interval", str(PILOT_POLL_S), "--monitor-port", "0",
            "--flight-dir", common["flight"]]
    # The restart serves no traffic of its own: its first PILOT_SAMPLE
    # dispatches are the new generation's sample, one request each, in
    # OBSERVE; the next one, the first of 64 requests submitted right
    # after, is poisoned.
    plan = json.dumps({"seed": SEED, "faults": [
        {"point": "serve.dispatch", "nth": PILOT_SAMPLE + 1,
         "error": "poison"}]})
    return [[
        dict(common, root=os.path.join(root, "run1"),
             argv=argv + ["--max-cycles", "3",
                          "--traffic-qps", str(PILOT_TRAFFIC_QPS),
                          "--json", os.path.join(root, "run1.json")],
             feeds=[{"add": [part(k) for k in PILOT_BOOT_PARTS]},
                    {"add": [part(k) for k in PILOT_DAY_PARTS]},
                    {"add": [shifted]}],
             env={}, burn=False),
        dict(common, root=os.path.join(root, "run2"),
             argv=argv + ["--max-cycles", "1",
                          "--json", os.path.join(root, "run2.json")],
             feeds=[{"remove": [os.path.basename(shifted)],
                     "add": [replay]}],
             env={"PHOTON_TPU_FAULT_PLAN": plan}, burn=True),
    ]]


def generation_scores(path: str, requests, precision: str) -> np.ndarray:
    """float64 scores of dense requests from a generation's ``.npz``:
    each fixed effect's dot, plus, for an entity the generation knows,
    sum_s w[e, s] * x[proj[e, s]]; weights and features rounded to the
    table dtype first, as the served path stores and reads them."""
    import torch

    dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32

    def stored(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            dtype).double().numpy()

    arrays, manifest = checkpoint_arrays(path)
    index = {name: {k: i for i, k in enumerate(info["entity_keys"])}
             for name, info in manifest.items() if info["kind"] == "random"}
    out = []
    for feats, ids in requests:
        z = 0.0
        for name, info in manifest.items():
            x = stored(feats[info["shard"]])
            if info["kind"] == "fixed":
                w = stored(arrays[f"{name}/means"])
                z += float(x[: w.size] @ w)
                continue
            e = index[name].get(ids.get(info["re_type"]))
            if e is not None:
                proj = arrays[f"{name}/proj_all"][e]
                w = stored(arrays[f"{name}/coefficients"][e])
                live = proj >= 0
                z += float(np.sum(w[live] * x[proj[live]]))
        out.append(z)
    return np.asarray(out)


def pilot_sample(torch, pilot, cycle: int, one_by_one: bool = False
                 ) -> dict:
    """PILOT_SAMPLE requests through the live queue, held against the
    plain version of the live tables (the same requests packed and
    scored by ``fused_score_reference``) and against a float64 numpy
    score from the live generation's ``.npz``. The requests come from
    one seed, so two samples of one generation are the same requests.
    ``one_by_one`` waits for each request before the next: one dispatch
    a request."""
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.driver import synthetic_requests

    server = pilot.server
    programs = server.programs
    reqs = synthetic_requests(programs.tables, programs, PILOT_SAMPLE,
                              seed=SEED + 7)
    if one_by_one:
        got = np.array([server.submit(f, ids).result(timeout=120)
                        for f, ids in reqs])
    else:
        futs = [server.submit(f, ids) for f, ids in reqs]
        got = np.array([f.result(timeout=120) for f in futs])
    feats, codes, _ = programs.pack_requests(reqs)
    plain = serve_kernel.fused_score_reference(
        **programs.operands(feats, codes))[:len(reqs)].float().cpu().numpy()
    precision = programs.tables.precision
    exact = generation_scores(pilot.ring.path(pilot.ring.live), reqs,
                              precision)
    return {"cycle": cycle, "generation": pilot.ring.live,
            "precision": precision, "requests": len(reqs),
            "finite": bool(np.isfinite(got).all()),
            "plain_max_abs_err": float(np.max(np.abs(got - plain))),
            "numpy_max_rel_err": float(np.max(
                np.abs(got - exact) / (1.0 + np.abs(exact)))),
            "scores_sha": _sha(got.astype(np.float32))}


def pilot_child(torch, spec: dict) -> dict:
    """One ``cli.pilot`` run in this process (phase 14g), instrumented
    from outside the package: every committed stage stamped, each
    cycle's report kept, a sample checked after each promotion and
    rollback (``pilot_sample``), the next day's parts landed once a
    cycle is done (``spec["feeds"]``), every request's latency by the
    stage it was submitted in, every reload's summary, the exporter
    scraped (``scraping_monitors``). With ``spec["burn"]``, once OBSERVE
    commits: the new generation's sample, one request at a time, then
    64 requests at once (the fault plan in ``spec["env"]`` poisons the
    first dispatch after the sample's). The counts start at 0 in this
    new process and are read after the run."""
    import shutil

    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.cli import pilot as pilot_cli
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.ops import segment_reduce as sr
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.pilot import PilotServer, loop
    from photon_tpu_torch.resilience import faults
    from photon_tpu_torch.serve.driver import synthetic_requests

    watch, feeds = spec["watch"], list(spec["feeds"])
    rec: dict = {"stages": [], "reports": [], "errors": [], "samples": [],
                 "reloads": [], "landed": [], "servers": [], "device": None}
    latency: list = []
    stage_now = ["IDLE"]
    burning: list = []

    def land(step):
        for name in step.get("remove", ()):
            os.remove(os.path.join(watch, name))
        for src in step.get("add", ()):
            shutil.copyfile(src, os.path.join(watch, os.path.basename(src)))
        rec["landed"].append({"t": time.perf_counter(), **step})

    def burn(pilot):
        rec["samples"].append(pilot_sample(torch, pilot, pilot.state.cycle,
                                           one_by_one=True))
        server = pilot.server
        reqs = synthetic_requests(server.programs.tables, server.programs,
                                  PILOT_SAMPLE, seed=SEED + 8)
        for f in [server.submit(x, ids) for x, ids in reqs]:
            f.exception(timeout=120)

    orig_commit, orig_cycle = loop.Pilot._commit, loop.Pilot.run_cycle
    orig_init, orig_reload = PilotServer.__init__, PilotServer.reload
    orig_submit = PilotServer.submit

    def commit(self):
        orig_commit(self)
        rec["device"] = str(self.device)
        st = self.state
        if not rec["stages"] or rec["stages"][-1][1:] != [st.cycle,
                                                          st.stage]:
            rec["stages"].append([time.perf_counter(), st.cycle, st.stage])
        stage_now[0] = st.stage
        if st.stage == "OBSERVE" and spec.get("burn") and not burning:
            burning.append(threading.Thread(target=burn, args=(self,),
                                            daemon=True))
            burning[0].start()

    def run_cycle(self):
        report = orig_cycle(self)
        if "error" in report:
            # A stage that failed: the pilot backs off and resumes there.
            rec["errors"].append(json.loads(json.dumps(report,
                                                       default=str)))
        elif "cycle" in report and report.get("stage") == "IDLE":
            rec["reports"].append(json.loads(json.dumps(report,
                                                        default=str)))
            if "promotion" in report or report.get("rollback"):
                rec["samples"].append(pilot_sample(torch, self,
                                                   report["cycle"]))
            if feeds:
                land(feeds.pop(0))
        return report

    def init(self, *a, **kw):
        t0 = time.perf_counter()
        orig_init(self, *a, **kw)
        rec["servers"].append(self)
        rec["reloads"].append({
            "kind": "start", "seconds": time.perf_counter() - t0,
            "programs_compiled": self.programs.stats["programs_compiled"],
            "serve_kernel": self.programs.stats["serve_kernel"]})

    def reload(self, model):
        t0 = time.perf_counter()
        out = orig_reload(self, model)
        rec["reloads"].append({"kind": "reload",
                               "seconds": time.perf_counter() - t0,
                               "stage": stage_now[0], **out})
        return out

    def submit(self, features, entity_ids=None, **kw):
        # [stage at submit, submitted, resolved, future]; the callback
        # runs on the worker before the future's waiters wake, so it
        # only stamps.
        entry = [stage_now[0], time.perf_counter(), None, None]
        fut = orig_submit(self, features, entity_ids, **kw)
        entry[3] = fut
        latency.append(entry)
        fut.add_done_callback(
            lambda f: entry.__setitem__(2, time.perf_counter()))
        return fut

    loop.Pilot._commit, loop.Pilot.run_cycle = commit, run_cycle
    PilotServer.__init__, PilotServer.reload = init, reload
    PilotServer.submit = submit
    os.environ.update(spec["env"])
    land(feeds.pop(0))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with scraping_monitors() as scrapers, contextlib.redirect_stdout(buf):
        rc = pilot_cli.main(spec["argv"])
    for th in burning:
        th.join(timeout=120)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    queues = [s.queue.stats() for s in rec.pop("servers")]
    by_stage: dict = {}
    for stage, t_sub, t_done, fut in latency:
        b = by_stage.setdefault(stage, {"ms": [], "errors": 0,
                                        "unresolved": 0})
        if t_done is None:
            b["unresolved"] += 1
            continue
        b["ms"].append((t_done - t_sub) * 1e3)
        b["errors"] += fut.exception(timeout=0) is not None
    stage_latency = {
        stage: {"requests": len(b["ms"]), "errors": b["errors"],
                "unresolved": b["unresolved"],
                "p50_ms": float(np.percentile(b["ms"], 50)),
                "p99_ms": float(np.percentile(b["ms"], 99))}
        for stage, b in by_stage.items() if b["ms"]}
    t_base = rec["stages"][0][0] if rec["stages"] else t0
    return {
        "rc": rc, "wall_seconds": wall,
        "line": json.loads(buf.getvalue().strip().splitlines()[-1]),
        "stages": [[t - t_base, c, s] for t, c, s in rec["stages"]],
        "landed": [dict(x, t=x["t"] - t_base) for x in rec["landed"]],
        "reports": rec["reports"], "stage_errors": rec["errors"],
        "samples": rec["samples"], "reloads": rec["reloads"],
        "device": rec["device"],
        "latency_by_stage": stage_latency,
        "scrapers": [sc.summary() for sc in scrapers],
        "faults_fired": faults.fired(),
        "newton_launches": nk.launches,
        "plain_route_solves": ra.plain_route_solves,
        "segment_launches_by_site": dict(sr.launches_by_site),
        "serve_launches": serve_kernel.launches,
        "serve_replay_launches": serve_kernel.replay_launches,
        "queue_batches": sum(q["batches"] for q in queues),
        "queue_requests": sum(q["requests"] for q in queues),
        "dispatch_errors": sum(q["dispatch_errors"] for q in queues),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }


def stage_seconds(stages: list) -> dict:
    """{cycle: {stage: seconds}} from the stamped commits (a stage's
    seconds run to the next commit)."""
    out: dict = {}
    for (t, cycle, stage), (t_next, _, _) in zip(stages, stages[1:]):
        if stage != "IDLE":
            out.setdefault(str(cycle), {})[stage] = t_next - t
    return out


def phase_pilot_cli(torch, cli: dict, runs: list) -> dict:
    """Phase 14g's gates on its two children's results (module
    docstring)."""
    from photon_tpu_torch.pilot import GenerationRing, load_state

    first, second = runs
    root = os.path.join(cli["root"], "pilot")
    work = os.path.join(root, "work")
    state = load_state(work)
    ring = GenerationRing(os.path.join(work, "generations"), keep=3)
    flights = {}
    for path in sorted(glob.glob(os.path.join(root, "flight",
                                              "flight-*.json"))):
        with open(path) as f:
            flights[os.path.basename(path)] = json.load(f).get("reason")
    r1, r2 = first["reports"], second["reports"]
    promos = [r for r in r1 + r2 if "promotion" in r]
    gen_auc = cli["generating_auc"]
    aucs = {r["cycle"]: r["candidate_metrics"]["AUC"] for r in r1 + r2
            if r.get("candidate_metrics")}
    lat = first["latency_by_stage"]
    row = {
        "phase": "pilot_cli",
        "parts": {"bootstrap": list(PILOT_BOOT_PARTS),
                  "day": list(PILOT_DAY_PARTS),
                  "shifted": PILOT_SHIFTED_PART,
                  "replay": PILOT_REPLAY_PART},
        "rows_per_part": -(-CLI_TRAIN_ROWS // STREAM_SHARDS),
        "cut": ("rows: train_cli's part files as days (the pure-Python "
                "Avro writer); the SIGTERM between ring commit and reload "
                "runs on the CPU (tests/test_torch_pilot.py)"),
        "wall_seconds": [first["wall_seconds"], second["wall_seconds"]],
        "process_seconds": [first["process_seconds"],
                            second["process_seconds"]],
        "stage_seconds": [stage_seconds(first["stages"]),
                          stage_seconds(second["stages"])],
        "ingest_rows": {r["cycle"]: r["ingest"]["rows"]
                        for r in r1 + r2 if "ingest" in r},
        "staleness_seconds": {r["cycle"]: r["staleness_seconds"]
                              for r in promos},
        "promotions": [{"cycle": r["cycle"], **r["promotion"]}
                       for r in promos],
        "reloads": [first["reloads"], second["reloads"]],
        "refused": {r["cycle"]: r["refused"] for r in r1 + r2
                    if "refused" in r},
        "health": {r["cycle"]: r.get("health") for r in r1 + r2},
        "rollback": [r.get("rollback") for r in r2],
        "failures": [res["line"]["failures"] for res in runs],
        "deadline_overruns": [res["line"]["deadline_overruns"]
                              for res in runs],
        "stage_errors": [res["stage_errors"] for res in runs],
        "holdout_auc": aucs, "generating_auc": gen_auc,
        "samples": first["samples"] + second["samples"],
        "traffic": first["line"].get("traffic"),
        "latency_by_stage": [lat, second["latency_by_stage"]],
        "scrapers": [first["scrapers"], second["scrapers"]],
        "faults_fired": second["faults_fired"],
        "newton_launches": [first["newton_launches"],
                            second["newton_launches"]],
        "plain_route_solves": [first["plain_route_solves"],
                               second["plain_route_solves"]],
        "segment_launches_by_site": [first["segment_launches_by_site"],
                                     second["segment_launches_by_site"]],
        "serve_replay_launches": [first["serve_replay_launches"],
                                  second["serve_replay_launches"]],
        "serve_launches": [first["serve_launches"],
                           second["serve_launches"]],
        "queue_batches": [first["queue_batches"], second["queue_batches"]],
        "dispatch_errors": [first["dispatch_errors"],
                            second["dispatch_errors"]],
        "peak_device_bytes": [first["peak_device_bytes"],
                              second["peak_device_bytes"]],
        "peak_host_rss_bytes": [first["peak_host_rss_bytes"],
                                second["peak_host_rss_bytes"]],
        "flight_dumps": flights,
        "state": {k: getattr(state, k) for k in (
            "stage", "cycle", "promotions", "refusals", "rollbacks",
            "cycles_completed", "mode")},
        "ring": {"live": ring.live, "staged": ring.staged,
                 "entries": [{k: e.get(k) for k in (
                     "gen", "cycle", "rolled_back")}
                     for e in ring.entries()]},
        "devices": [first["device"], second["device"]],
    }
    emit(row)
    train, idle = lat.get("TRAIN", {}), lat.get("IDLE", {})
    print(f"pilot_cli: staleness {row['staleness_seconds']} s; "
          f"graphs captured per promotion "
          f"{[p['programs_compiled'] for p in row['promotions']]} "
          f"(values-only {[p['values_only'] for p in row['promotions']]}); "
          f"stage failures {row['failures']}, deadline overruns "
          f"{row['deadline_overruns']}; "
          f"traffic {row['traffic']}; p50/p99 ms TRAIN "
          f"{train.get('p50_ms')}/{train.get('p99_ms')} against IDLE "
          f"{idle.get('p50_ms')}/{idle.get('p99_ms')}", flush=True)

    # Every stage on the card, on the kernels, and none failed (a failed
    # stage is retried after a backoff and would pass every gate below).
    for i, res in enumerate(runs):
        if (res["line"]["failures"] or res["line"]["deadline_overruns"]
                or res["stage_errors"]):
            fail(f"pilot_cli run {i + 1}: {res['line']['failures']} stage "
                 f"failures, {res['line']['deadline_overruns']} deadline "
                 f"overruns: {res['stage_errors']}")
        sites = res["segment_launches_by_site"]
        if (res["rc"] != 0 or res["device"] != "cuda:0"
                or res["newton_launches"] <= 0
                or res["plain_route_solves"] != 0
                or sites.get("fixed_effect", 0) <= 0
                or sites.get("evaluation", 0) <= 0):
            fail(f"pilot_cli run {i + 1}: rc {res['rc']} on "
                 f"{res['device']}, Newton launches "
                 f"{res['newton_launches']}, plain solves "
                 f"{res['plain_route_solves']}, segment sums {sites}")
        # One replay a batch served (a poisoned batch never replays).
        if (res["serve_replay_launches"]
                != res["queue_batches"] - res["dispatch_errors"]):
            fail(f"pilot_cli run {i + 1}: {res['serve_replay_launches']} "
                 f"replays for {res['queue_batches']} batches "
                 f"({res['dispatch_errors']} failed)")
        for sc in res["scrapers"]:
            if sc["errors"] or not sc["expositions"] or set(
                    map(str, sc["healthz"])) != {"200"}:
                fail(f"pilot_cli run {i + 1}: scrapes {sc}")
        if len(res["scrapers"]) != 1:
            fail(f"pilot_cli run {i + 1}: {len(res['scrapers'])} exporters")
    # (a)-(c): two promotions, then the shifted day refused on drift.
    outcome = [("promotion" in r, bool(r.get("refused"))) for r in r1]
    if outcome != [(True, False), (True, False), (False, True)]:
        fail(f"pilot_cli (a)-(c): outcomes {outcome}: {r1}")
    if not any(x.startswith("health:drift") for x in r1[2]["refused"]):
        fail(f"pilot_cli (c): refused for {r1[2]['refused']}, not drift")
    if not (state.last_refusal and any(
            x.startswith("health:drift")
            for x in state.last_refusal["reasons"])):
        fail(f"pilot_cli (c): the state file's refusal {state.last_refusal}")
    if f"pilot.refusal:cycle-{r1[2]['cycle']}" not in flights.values():
        fail(f"pilot_cli (c): no refusal post-mortem in {flights}")
    # Graphs: the start captures the ladder, a values-only promotion
    # none, a structure change one a rung. (d)'s day is a replay, so its
    # promotion and its rollback are values-only.
    for res in runs:
        for rl in res["reloads"]:
            want = (0 if rl.get("values_only") else len(RUNGS))
            if rl["programs_compiled"] != want or (
                    rl["kind"] == "start" and rl["serve_kernel"] != "cuda"):
                fail(f"pilot_cli: reload {rl} captured "
                     f"{rl['programs_compiled']} graphs, not {want}")
    if [(rl["kind"], rl.get("values_only"), rl["programs_compiled"])
            for rl in second["reloads"]] != [
            ("start", None, len(RUNGS)), ("reload", True, 0),
            ("reload", True, 0)]:
        fail(f"pilot_cli (d): reloads {second['reloads']}, not a start "
             "then two values-only reloads")
    # Traffic: no errors, none stranded, in (a)-(c).
    t = first["line"].get("traffic") or {}
    if (not t.get("served") or t.get("errors") or t.get("submit_errors")
            or t.get("stranded")
            or any(b["errors"] or b["unresolved"] for b in lat.values())):
        fail(f"pilot_cli (a)-(c): traffic {t}, latency {lat}")
    # (d): the promotion rolled back to the generation before it, every
    # error one of the planned poison's, all of them in OBSERVE.
    rb = (r2[0].get("rollback") or {}) if r2 else {}
    if not (len(r2) == 1 and "promotion" in r2[0] and rb.get("rolled_back")
            and rb.get("to") == promos[1]["promotion"]["generation"]
            and rb.get("from") == r2[0]["promotion"]["generation"]
            and ring.live == rb.get("to")
            and second["line"]["rollbacks"] == 1):
        fail(f"pilot_cli (d): {r2}, ring live {ring.live}")
    bad = {s: b["errors"] for s, b in second["latency_by_stage"].items()
           if b["errors"]}
    if (second["faults_fired"] != [{"point": "serve.dispatch",
                                    "call": PILOT_SAMPLE + 1,
                                    "error": "poison"}]
            or set(bad) != {"OBSERVE"} or second["dispatch_errors"] != 1):
        fail(f"pilot_cli (d): faults {second['faults_fired']}, errors by "
             f"stage {bad}, dispatch errors {second['dispatch_errors']}")
    # After each promotion ((d)'s inside its observation window) and the
    # rollback: the live queue against the plain version and float64
    # numpy; the rollback's sample is (b)'s generation's, bit for bit.
    samples = row["samples"]
    if ([smp["generation"] for smp in samples]
            != [1, 2, rb.get("from"), rb.get("to")]
            or samples[-1]["scores_sha"] != samples[1]["scores_sha"]):
        fail(f"pilot_cli: samples {samples}")
    for smp in samples:
        tol = TOL[smp["precision"]]
        if not (smp["finite"] and smp["plain_max_abs_err"] <= tol
                and smp["numpy_max_rel_err"] <= tol):
            fail(f"pilot_cli: sample {smp} outside {tol}")
    # The holdout AUC of (b)'s generation recovers at least half the
    # generating model's lift, as in train_cli (d).
    auc_b = aucs[r1[1]["cycle"]]
    if not auc_b - 0.5 >= 0.5 * (gen_auc - 0.5):
        fail(f"pilot_cli (b): holdout AUC {auc_b} recovers under half "
             f"the generating model's lift ({gen_auc})")
    newton = first["newton_launches"] + second["newton_launches"]
    return {"newton_launches": newton,
            "fixed_effect_launches": sum(
                r["segment_launches_by_site"].get("fixed_effect", 0)
                for r in runs),
            "evaluation_launches": sum(
                r["segment_launches_by_site"].get("evaluation", 0)
                for r in runs),
            "serve_launches": sum(r["serve_replay_launches"]
                                  + r["serve_launches"] for r in runs),
            "row": row}


# ---------------------------------------------------------------------------
# the cost ledger's report: cli.profile
# ---------------------------------------------------------------------------

# Phase 14h's two runs: (A) the JAX package's CI contract, its defaults
# with the overhead gate; (B) the priced report at the training CLI's
# row count (8,192 users of 32 rows: 14a's rows at the profile
# workload's widths).
PROFILE_RUNS = {
    "ci": ["--overhead-check"],
    "full": ["--rows", str(CLI_TRAIN_ROWS), "--entities", "8192",
             "--fits", "3"],
}


def profile_jobs(cli: dict) -> list:
    """Phase 14h's children, as one chain for ``cli_children`` ((A),
    then (B)): the two runs do not share the host's cores with each
    other, so (A)'s overhead A/B is not timed against (B)."""
    import shutil

    root = os.path.join(cli["root"], "profile")
    shutil.rmtree(root, ignore_errors=True)
    return [[{"kind": "profile", "name": name, "args": args,
              "root": os.path.join(root, name),
              "json": os.path.join(root, name, "profile.json")}
             for name, args in PROFILE_RUNS.items()]]


def profile_child(torch, spec: dict) -> dict:
    """One ``python -m photon_tpu_torch.cli.profile`` run in this process
    (``cli.profile.main``), its counts read after it. ``ledger.mark``
    and the first ``ledger.attribution_since`` with a wall are wrapped
    from outside the package: they bracket the profiled fit window, so
    the Newton launches and plain-route solves inside it are counted on
    their own. The workload's fits are fused: after the first (the
    capture) each is a graph replay, whose launches no wrapper counts,
    so the device counters count them
    (``device_loop.count_graph_launches``, on before the capture)."""
    from photon_tpu_torch.algorithm import fused_fit as ff
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.cli import profile
    from photon_tpu_torch.obs import ledger
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.ops import segment_reduce as sr
    from photon_tpu_torch.ops import serve_kernel as sk

    from photon_tpu_torch.utils import device_loop

    window: dict = {}
    orig_mark, orig_attr = ledger.mark, ledger.attribution_since

    def counts():
        return (nk.launches, ra.plain_route_solves, ff.replays,
                device_loop.graph_launches("newton_step"))

    def mark():
        window["start"] = counts()
        return orig_mark()

    def attribution_since(marker, wall_seconds=None):
        if wall_seconds is not None and "end" not in window:
            window["end"] = counts()
        return orig_attr(marker, wall_seconds)

    device_loop.count_graph_launches("cuda")
    device_loop.reset_graph_launches()
    nk.launches = ra.plain_route_solves = sk.launches = 0
    replays0 = ff.replays
    sr.reset_counts()
    os.makedirs(spec["root"], exist_ok=True)
    buf = io.StringIO()
    ledger.mark, ledger.attribution_since = mark, attribution_since
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = profile.main([*spec["args"], "--json", spec["json"],
                               "--device", "cuda"])
        torch.cuda.synchronize()
    finally:
        ledger.mark, ledger.attribution_since = orig_mark, orig_attr
    wall = time.perf_counter() - t0
    start = window.get("start", (0, 0, 0, 0))
    end = window.get("end", (0, 0, 0, 0))
    replayed = device_loop.graph_launches("newton_step")
    doc = None
    if os.path.exists(spec["json"]):
        with open(spec["json"]) as f:
            doc = json.load(f)
    return {"name": spec["name"], "args": spec["args"], "rc": rc,
            "wall_seconds": wall, "stdout": buf.getvalue()[-8000:],
            "doc": doc, "newton_launches": nk.launches + replayed,
            "newton_launches_from_python": nk.launches,
            "replayed_newton_launches": replayed,
            "fused_replays": ff.replays - replays0,
            "fit_window_replays": end[2] - start[2],
            "fit_window_newton_launches": (end[0] - start[0]
                                           + end[3] - start[3]),
            "fit_window_plain_route_solves": end[1] - start[1],
            "plain_route_solves": ra.plain_route_solves,
            "segment_launches": sr.launches,
            "segment_launches_by_site": dict(sr.launches_by_site),
            "serve_launches": sk.launches,
            "peak_device_bytes": torch.cuda.max_memory_allocated()}


def phase_profile_cli(torch, runs: list) -> dict:
    """Phase 14h's gates on its two children's results (module
    docstring): each exits 0 with no failure; the Newton kernel took the
    fit window's solves; each probe launched its kernel once and its
    census row is priced; the fit window attributes seconds. (A)'s
    overhead and both top-k tables are printed."""
    rows = []
    for r in runs:
        doc = r["doc"] or {}
        report = doc.get("report") or {"rows": [], "programs": {}}
        probes = {}
        for key, kernel, count in (
                ("kernel_probe", "segment_sum",
                 r["segment_launches_by_site"].get(
                     "segment_reduce/probe", 0)),
                ("serve_kernel_probe", "serve_score", None)):
            probe = doc.get(key)
            priced = next((x for x in report["rows"] if probe and
                           x["program"] == probe["program"]), None)
            probes[kernel] = {
                "launches": None if probe is None else probe["launches"],
                "site_launches": count,
                "seconds": None if probe is None else probe["seconds"],
                "vs_roofline": None if priced is None
                else priced["vs_roofline"],
                "blocking": None if priced is None else priced["blocking"]}
        top = [{k: x[k] for k in ("coordinate", "phase", "program",
                                  "seconds", "dispatches",
                                  "host_gap_seconds", "wasted_seconds",
                                  "vs_roofline", "blocking")}
               for x in report["rows"] if x["program"] != "unattributed"][:5]
        row = {"phase": "profile_cli", "run": r["name"], "args": r["args"],
               "rc": r["rc"], "failures": doc.get("failures"),
               "process_seconds": r["process_seconds"],
               "main_seconds": r["wall_seconds"],
               "fit_window": doc.get("fit_window"),
               "overhead": doc.get("overhead"),
               "top_k": top, "probes": probes,
               "census": sorted(report.get("programs", {})),
               "resident_bytes": report.get("resident_bytes"),
               "newton_launches": r["newton_launches"],
               "replayed_newton_launches": r["replayed_newton_launches"],
               "fused_replays": r["fused_replays"],
               "fit_window_replays": r["fit_window_replays"],
               "fit_window_newton_launches": r[
                   "fit_window_newton_launches"],
               "plain_route_solves": r["plain_route_solves"],
               "segment_launches_by_site": r["segment_launches_by_site"],
               "serve_launches": r["serve_launches"],
               "peak_host_rss_bytes": r["peak_host_rss_bytes"],
               "peak_device_bytes": r["peak_device_bytes"]}
        emit(row)
        print(f"profile_cli ({r['name']}):\n{r['stdout']}", flush=True)
        rows.append(row)
        where = f"profile_cli ({r['name']})"
        if r["rc"] != 0 or doc.get("failures") != []:
            fail(f"{where}: exit {r['rc']}, failures "
                 f"{doc.get('failures')}: {r['stdout'][-2000:]}")
        if r["fit_window_newton_launches"] <= 0 or r[
                "plain_route_solves"] != 0:
            fail(f"{where}: {r['fit_window_newton_launches']} Newton "
                 f"launches in the fit window, "
                 f"{r['plain_route_solves']} plain-route solves")
        for kernel, p in probes.items():
            if p["launches"] != 1 or p["vs_roofline"] is None:
                fail(f"{where}: the {kernel} probe {p}")
        if probes["segment_sum"]["site_launches"] != 1:
            fail(f"{where}: {probes['segment_sum']['site_launches']} "
                 "launches at the probe's site")
        if not (doc.get("fit_window") or {}).get("attributed_fraction"):
            fail(f"{where}: the fit window attributed nothing: "
                 f"{doc.get('fit_window')}")
        if r["args"] == PROFILE_RUNS["ci"] and (
                (doc.get("overhead") or {}).get("overhead_fraction") is None
                or "ledger overhead:" not in r["stdout"]
                or "vs_roof" not in r["stdout"]):
            fail(f"{where}: no overhead or top-k table printed")
    return {"newton_launches": sum(r["newton_launches"] for r in runs),
            "segment_launches": sum(r["segment_launches"] for r in runs),
            "serve_launches": sum(r["serve_launches"] for r in runs),
            "rows": rows}


def overhead_aa(torch, rounds: int = 3) -> list:
    """``cli.profile``'s overhead A/B (``_overhead_ab``) on its default
    workload, ``rounds`` times with both arms off (``ledger.enable``
    stubbed to ``disable``: an A/A, whose true overhead is 0) and
    ``rounds`` times as it runs, alternating. Each row gives the A/B's
    own fraction (the median of the samples' on/off ratios, minus 1) and
    the JAX package's estimator on the same samples (the best on over
    the best off, minus 1). A measurement, no gate."""
    from photon_tpu_torch import obs
    from photon_tpu_torch.cli import profile
    from photon_tpu_torch.obs import ledger

    was = obs.enabled()
    obs.enable()
    est, data = profile._tiny_workload(512, 16, 2, device="cuda")
    for _ in range(3):
        profile._fit_once(est, data)
    rows = []
    real_enable = ledger.enable
    try:
        for i in range(rounds):
            for aa in (True, False):
                ledger.enable = ledger.disable if aa else real_enable
                out = profile._overhead_ab(est, data, 25)
                row = {"phase": "overhead_aa", "round": i,
                       "arms": "off/off" if aa else "off/on", **out,
                       "best_on_over_best_off": out["on_best_seconds"]
                       / out["off_best_seconds"] - 1.0}
                emit(row)
                rows.append(row)
    finally:
        ledger.enable = real_enable
        ledger.disable()
        ledger.reset()
        if not was:
            obs.disable()
    return rows


# ---------------------------------------------------------------------------
# the wide-subspace squared-loss GLMix at full width, float32
# ---------------------------------------------------------------------------

WIDE_DEVICE = "cuda"  # "cpu" runs the logic with the plain versions
WIDE_MOVIES = 20_000
WIDE_POOL, WIDE_TAGS = 192, 100_000  # tag pool per movie, tag ids
WIDE_K = 9  # 2-8 tags and the intercept id per row
WIDE_ZIPF_OFFSET = 20  # movie popularity p(m) ~ 1 / (m + 20)
WIDE_TABLE_CAP = 6
WIDE_SHARD = "tagShard"
WIDE_REDUCED = dict(n_rows=400_000, n_users=10_000, n_movies=2_000)
SEGMENT_REPLACES = "photon_tpu/ops/segment_reduce.py:230"
FIT_SITES = ("segment_reduce/gram", "segment_reduce/slots",
             "segment_reduce/densify", "segment_reduce/score_tail")
# Kernel against plain, f32: |diff| <= 1e-6 (1 + sum |v| of the segment).
SEGMENT_REL = 1e-6
# Fitted coefficients against a float64 solve of the normal equations:
# f32 normal equations solved by CG with one refinement pass.
OPT_RTOL, OPT_ATOL = 1e-3, 1e-4
OPT_SAMPLE = 256
# The gram route against densify (the reference's own gate,
# tests/test_random_effect.py:700).
WIDE_ROUTE_RTOL, WIDE_ROUTE_ATOL = 1e-4, 1e-5
SEGMENT_INNER = 5


def wide_arrays(n_rows=TRAIN_ROWS, n_users=N_USERS, n_movies=WIDE_MOVIES,
                seed=TRAIN_SEED, task="linear"):
    """The bench's GLMix (``bench.py:_synth_arrays``) with ``per-movie``
    on a sparse tag shard: each movie owns a pool of WIDE_POOL tag ids
    drawn from WIDE_TAGS; each row carries 2-8 distinct tags of its
    movie's pool with N(0, 1) values, then the intercept id WIDE_TAGS at
    1. Movies are drawn with p(m) ~ 1 / (m + WIDE_ZIPF_OFFSET). The
    label is the bench's, with the movie term the row's tag values times
    per-movie weights N(0, 0.2) over its pool and intercept."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, TRAIN_FEATURES)).astype(np.float32)
    x[:, -1] = 1.0
    xu = rng.normal(size=(n_rows, USER_FEATURES + 1)).astype(np.float32)
    xu[:, -1] = 1.0
    users = rng.integers(0, n_users, size=n_rows)
    pm = 1.0 / (np.arange(n_movies) + WIDE_ZIPF_OFFSET)
    movies = rng.choice(n_movies, size=n_rows, p=pm / pm.sum())
    pools = np.stack([rng.choice(WIDE_TAGS, size=WIDE_POOL, replace=False)
                      for _ in range(n_movies)]).astype(np.int32)
    counts = rng.integers(2, WIDE_K, size=n_rows)
    pos = rng.integers(0, WIDE_POOL, size=(n_rows, WIDE_K - 1))
    while True:  # redraw rows whose pool positions repeat
        srt = np.sort(pos, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        if not dup.any():
            break
        pos[dup] = rng.integers(0, WIDE_POOL, size=(int(dup.sum()),
                                                    WIDE_K - 1))
    live = np.arange(WIDE_K - 1)[None, :] < counts[:, None]
    idx = np.zeros((n_rows, WIDE_K), np.int32)
    val = np.zeros((n_rows, WIDE_K), np.float32)
    idx[:, :-1] = np.where(live, pools[movies[:, None], pos], 0)
    val[:, :-1] = np.where(live, rng.normal(size=(n_rows, WIDE_K - 1)), 0.0)
    rows = np.arange(n_rows)
    idx[rows, counts] = WIDE_TAGS
    val[rows, counts] = 1.0
    w = rng.normal(size=TRAIN_FEATURES).astype(np.float32) * 0.3
    wu = rng.normal(size=(n_users, USER_FEATURES + 1)).astype(
        np.float32) * 0.3
    wm = rng.normal(size=(n_movies, WIDE_POOL + 1)).astype(np.float32) * 0.2
    z = (x @ w + np.einsum("nd,nd->n", xu, wu[users])
         + np.sum(np.where(live, val[:, :-1] * wm[movies[:, None], pos], 0.0),
                  axis=1)
         + wm[movies, WIDE_POOL])
    if task == "logistic":
        y = (rng.uniform(size=n_rows) < 1.0 / (1.0 + np.exp(-0.5 * z)))
    else:
        y = z + 0.2 * rng.normal(size=n_rows)
    return dict(x=x, xu=xu, users=users, movies=movies, idx=idx, val=val,
                y=y.astype(np.float32), z=z)


def wide_dataset(arrays):
    from photon_tpu_torch.data.dataset import DenseFeatures, SparseFeatures
    from photon_tpu_torch.data.game_data import make_game_dataset

    return make_game_dataset(
        arrays["y"],
        {"global": DenseFeatures(arrays["x"]),
         "userShard": DenseFeatures(arrays["xu"]),
         WIDE_SHARD: SparseFeatures(arrays["idx"], arrays["val"],
                                    WIDE_TAGS + 1)},
        id_tags={"userId": arrays["users"], "movieId": arrays["movies"]},
        device=WIDE_DEVICE,
    )


def wide_estimator(task_name="linear"):
    """``wide-linear``: the bench's estimator with ``per-movie`` on the
    tag shard, its score table capped at WIDE_TABLE_CAP entries a row."""
    from photon_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
    )

    return build_estimator(
        task_name,
        movie=RandomEffectDataConfiguration(
            "movieId", WIDE_SHARD, active_data_upper_bound=2048,
            score_table_width_cap=WIDE_TABLE_CAP, min_bucket_entities=128),
        intercepts={"global": TRAIN_FEATURES - 1, "userShard": USER_FEATURES,
                    WIDE_SHARD: WIDE_TAGS},
        device=WIDE_DEVICE)


def bucket_routes(datasets, direct=True) -> list:
    """(coordinate, bucket index, block, gram bounds, route) of every
    random-effect bucket, the route as the solver picks it."""
    from photon_tpu_torch.algorithm import random_effect as ra

    out = []
    for cid in RE_IDS:
        ds = datasets[cid]
        for i, eb in enumerate(ds.device_blocks()):
            gm = (ds.block_gram_mults[i] if i < len(ds.block_gram_mults)
                  else None)
            route = ra.block_route(eb, eb.sub_dim, direct=direct,
                                   newton=not direct, gram_mults=gm,
                                   shifts=False, variances=False)
            out.append((cid, i, eb, gm, route))
    return out


def phase_wide_data(torch) -> dict:
    t0 = time.perf_counter()
    arrays = wide_arrays()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = wide_dataset(arrays)
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t0
    est = wide_estimator()
    datasets, plan_row = timed_prepare(torch, est, data)
    plan_s = plan_row["seconds"]
    movie = datasets["per-movie"]
    buckets = [{"coordinate": cid, "shape": list(eb.x_values.shape),
                "sub_dim": eb.sub_dim, "route": route,
                "gram_mults": None if gm is None else list(gm)}
               for cid, _, eb, gm, route in bucket_routes(datasets)]
    row = {"phase": "wide_data", "rows": int(arrays["y"].shape[0]),
           "generate_seconds": gen_s, "to_device_seconds": put_s,
           "planner_host_seconds": plan_s,
           "movie_layout": "lazy" if movie.is_lazy else "materialized",
           "movie_max_sub_dim": movie.max_sub_dim,
           "movie_kept_rows": int(movie.covered_np.sum()),
           "movie_passive_rows": int((~movie.covered_np).sum()),
           "score_table_width": int(movie.score_indices.shape[1]),
           "tail_entries": int(movie.score_tail_rows.shape[0]),
           "tail_mult": movie.score_tail_mult,
           "buckets": buckets}
    emit(row)
    routes = {b["route"] for b in buckets if b["coordinate"] == "per-movie"}
    if movie.is_lazy or not {"gram", "densify"} <= routes:
        fail(f"per-movie buckets took the routes {sorted(routes)}; the "
             "configuration must exercise both gram and densify")
    return dict(arrays=arrays, data=data, est=est, datasets=datasets,
                row=row)


def site_operands(torch, datasets) -> list:
    """The sorted (values, ids, segments) each segment-reduce site of the
    fit reduces, at its full-width shape, with the call that builds and
    reduces them (the whole wrapper). Values are the fit's own inputs
    where it has them (design values, unit weights, labels as the
    weighted targets) and N(0, 1) coefficients for the score tail."""
    from photon_tpu_torch.models import game as pt_game
    from photon_tpu_torch.ops import segment_reduce as sr

    out = []
    gen = torch.Generator(device=WIDE_DEVICE).manual_seed(7)
    for cid, _, eb, gm, route in bucket_routes(datasets):
        s = eb.sub_dim
        shape = list(eb.x_values.shape)
        if route == "gram":
            y_eff = (eb.labels - eb.offsets) * eb.weights

            def gram(eb=eb, s=s, m=gm[1]):
                return sr.ell_gram_blocks(eb.x_indices, eb.x_values,
                                          eb.weights, s, multiplicity=m)

            def slots(eb=eb, s=s, m=gm[0], y_eff=y_eff):
                return sr.ell_segment_slots(eb.x_indices, eb.x_values, y_eff,
                                            s, multiplicity=m)

            out.append(("segment_reduce/gram", shape, *sr.gram_operands(
                eb.x_indices, eb.x_values, eb.weights, s), gram))
            out.append(("segment_reduce/slots", shape, *sr.slot_operands(
                eb.x_indices, eb.x_values, y_eff, s), slots))
        elif route == "densify":
            def densify(eb=eb, s=s):
                return sr.densify_ell_blocks(eb.x_indices, eb.x_values, s)

            out.append(("segment_reduce/densify", shape, *sr.densify_operands(
                eb.x_indices, eb.x_values, s), densify))
    movie = datasets["per-movie"]
    w = torch.randn((movie.num_entities, movie.max_sub_dim), device=WIDE_DEVICE,
                    generator=gen)
    tail = (movie.score_tail_rows, movie.score_tail_indices,
            movie.score_tail_values)
    tr, ti, tv = tail
    contrib = tv * w.reshape(-1)[movie.score_codes[tr.long()].long()
                                 * w.shape[1] + ti.long()]

    def tail_scores():
        return pt_game.score_tail(w, movie.score_codes, tail, movie.num_rows,
                                  movie.score_tail_mult)

    out.append(("segment_reduce/score_tail", [int(tr.shape[0])], contrib,
                tr, movie.num_rows, tail_scores))
    # The bucket scorer's multiplicity-1 scatter over the largest user
    # bucket's rows (every row of the table).
    user = max(datasets["per-user"].device_plans(),
               key=lambda p: p.row_ids.numel())
    r = user.row_ids.shape[1]
    valid = (torch.arange(r, device=WIDE_DEVICE)[None, :]
             < user.row_counts[:, None])
    zb = torch.randn(user.row_ids.shape, device=WIDE_DEVICE, generator=gen)
    z = torch.zeros(movie.num_rows, device=WIDE_DEVICE)

    def rows_scatter():
        return sr.scatter_add_rows(z, user.row_ids, zb, valid)

    out.append(("segment_reduce/score", list(user.row_ids.shape),
                *sr.row_operands(movie.num_rows, user.row_ids, zb, valid),
                movie.num_rows, rows_scatter))
    return out


def _segment_check(torch, sr, name, vals, ids, n) -> dict:
    """The kernel twice against the plain version on one input."""
    got = sr.segment_sum(vals, ids, n, site="parity")
    again = sr.segment_sum(vals, ids, n, site="parity")
    torch.cuda.synchronize()
    plain = sr.sorted_segment_sum_plain(vals, ids, n)
    mag = sr.sorted_segment_sum_plain(vals.float().abs(), ids, n)
    diff = (got - plain).abs()
    row = {"phase": "segment_parity", "input": name,
           "values": int(vals.shape[0]), "segments": int(n),
           "dtype": str(vals.dtype).replace("torch.", ""),
           "max_abs_err": float(diff.max()),
           "max_err_over_bound": float(
               (diff / (SEGMENT_REL * (1.0 + mag))).max()),
           "bit_identical_runs": bool(torch.equal(got, again)),
           "finite": bool(got.isfinite().all())}
    emit(row)
    if not (row["max_err_over_bound"] <= 1.0 and row["bit_identical_runs"]
            and row["finite"]):
        fail(f"the segment-sum kernel disagrees with its plain version or "
             f"with itself: {row}")
    return row


def phase_segment_parity(torch, ops) -> float:
    """The kernel against ``sorted_segment_sum_plain`` on the card."""
    from photon_tpu_torch.ops import segment_reduce as sr

    dev = WIDE_DEVICE
    rng = np.random.default_rng(11)
    worst = 0.0

    def ints(size):
        return torch.from_numpy(rng.integers(-3, 4, size=size).astype(
            np.float32)).to(dev)

    def ids_of(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    n = 250_003
    dup = np.repeat(np.arange(n), rng.integers(0, 4, n))
    fixtures = [
        ("integer_duplicates", ints(dup.size), ids_of(dup), n),
        ("empty_segments", ints(4), ids_of([5, 5, 2_049, 4_098]), 4_099),
        ("dropped_ids", ints(6), ids_of([0, 1, 7, 1_283, 1_283, 1_290]),
         1_283),
        ("one_long_run", ints(1_000_002),
         ids_of(np.r_[0, np.full(1_000_000, 11), 36]), 37),
    ]
    for name, vals, ids, n_seg in fixtures:
        got = sr.segment_sum(vals, ids, n_seg, site="parity")
        torch.cuda.synchronize()
        exact = bool(torch.equal(got, sr.sorted_segment_sum_plain(
            vals, ids, n_seg)))
        emit({"phase": "segment_parity", "input": name,
              "values": int(vals.shape[0]), "segments": n_seg,
              "exact": exact})
        if not exact:
            fail(f"the segment-sum kernel is not exact on {name}")
    ids = ids_of(np.sort(rng.integers(0, 1_000_000, 3_000_000)))
    for dtype in (torch.float32, torch.bfloat16):
        vals = torch.from_numpy(rng.normal(size=ids.shape[0]).astype(
            np.float32)).to(dev, dtype)
        worst = max(worst, _segment_check(
            torch, sr, f"random_{str(dtype)[6:]}", vals, ids,
            1_000_000)["max_abs_err"])
    for site, shape, vals, ids, n_seg, _ in ops:
        row = _segment_check(torch, sr, f"{site} {shape}", vals, ids, n_seg)
        worst = max(worst, row["max_abs_err"])
    # The whole multiplicity-1 scatter_add_rows over the table's rows.
    site, shape, vals, ids, n_seg, rows_scatter = next(
        op for op in ops if op[0] == "segment_reduce/score")
    got = rows_scatter()
    torch.cuda.synchronize()
    want = sr.sorted_segment_sum_plain(vals, ids, n_seg)
    err = float((got - want).abs().max())
    emit({"phase": "segment_parity", "input": f"scatter_add_rows {shape}",
          "values": int(vals.shape[0]), "max_abs_err": err})
    if not err <= SEGMENT_REL * (1.0 + float(vals.abs().max())):
        fail(f"scatter_add_rows differs from its plain version by {err}")
    return worst


def segment_bound(vals, n) -> dict:
    """Least time for one reduce (``costmodel.segment_sum_cost``): each
    value and id read once and each output written once, at 3.35 TB/s."""
    from photon_tpu_torch.analysis import costmodel

    nbytes = costmodel.segment_sum_cost(
        int(vals.shape[0]), vals.element_size(), n)["hbm_bytes"]
    return {"bound_ms": nbytes / peaks()["hbm_bytes_per_sec"] * 1e3,
            "bound_by": "bytes", "bytes": nbytes}


def phase_segment_timing(torch, ops) -> list:
    """Per site at its full-width shape: the kernel's and the plain
    version's device ms (CUDA-graph replay, ``event_ms``), the whole
    wrapper's ms (operands, sort and kernel, issued back to back), one
    ``index_add_`` on the same ids (a yardstick only) and the bound."""
    from photon_tpu_torch.ops import segment_reduce as sr

    rows = []
    for site, shape, vals, ids, n, wrapper in ops:
        idx64 = torch.where(ids < n, ids.long(), torch.full_like(
            ids, n, dtype=torch.int64))
        vals32 = vals.float()

        def kernel():
            return sr.segment_sum(vals, ids, n, site="timing")

        def plain():
            return sr.sorted_segment_sum_plain(vals, ids, n)

        def library():
            out = torch.zeros(n + 1, device=vals.device)
            return out.index_add_(0, idx64, vals32)

        row = {"phase": "segment_timing", "site": site, "shape": shape,
               "values": int(vals.shape[0]), "segments": int(n),
               "ms": device_ms(torch, kernel, SEGMENT_INNER),
               "plain_ms": device_ms(torch, plain, SEGMENT_INNER),
               "library_ms": device_ms(torch, library, SEGMENT_INNER),
               "wrapper_ms": eager_ms(torch, wrapper, SEGMENT_INNER),
               **segment_bound(vals, n)}
        emit(row)
        rows.append(row)
    return rows


class _Residuals:
    """Records the residuals of each random-effect solve, keyed by its
    dataset, so a check can rebuild the problem the last solve saw."""

    def __init__(self):
        self.last = {}

    def __enter__(self):
        from photon_tpu_torch.algorithm import random_effect as ra

        self._train = train = ra.RandomEffectCoordinate.train
        last = self.last

        def recording(coord, residuals=None, *a, **k):
            last[id(coord.dataset)] = residuals
            return train(coord, residuals, *a, **k)

        ra.RandomEffectCoordinate.train = recording
        return self

    def __exit__(self, *exc):
        from photon_tpu_torch.algorithm import random_effect as ra

        ra.RandomEffectCoordinate.train = self._train


def graph_bucket_check(torch, group, coord, picks, residuals) -> dict:
    """Each picked bucket's solve (``random_effect._solve_block``, as the
    fit runs it) captured into a CUDA graph through ``device_loop`` (a
    Newton loop becomes a WHILE node) and replayed, its launches read
    from the device counters, against the same solve run eagerly: the
    coefficients, iterations and reasons equal bit for bit, and the
    replay's Newton and segment-sum launches beside the eager run's
    wrapper counts. The wide layout is materialized, so its fits stay
    on the unfused loop (the reference's own rule); this holds its
    kernels (the gram and densify segment sums, the Newton kernel's wide
    design) inside a graph."""
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.ops import segment_reduce as sr
    from photon_tpu_torch.utils import device_loop

    ds, cfg = coord.dataset, coord.config
    direct, newton = coord._routes()
    shape = (ds.num_entities, ds.max_sub_dim)
    w0 = torch.zeros(shape, dtype=ds.dtype, device=ds.device)

    def solve(i, eb):
        gm = (ds.block_gram_mults[i] if i < len(ds.block_gram_mults)
              else None)
        w_all = torch.zeros(shape, dtype=ds.dtype, device=ds.device)
        return ra._solve_block(
            eb, residuals, coord.normalization.factors,
            coord.normalization.shifts, w0, cfg.l1_weight, cfg.l2_weight,
            cfg.incremental_weight, None, w_all, None, sub_dim=eb.sub_dim,
            task=coord.task, opt_config=cfg.optimizer,
            variance_computation=cfg.variance_computation, direct=direct,
            newton=newton, gram_mults=gm)

    rows = []
    for i, eb, route in picks:
        n0, s0 = nk.launches, sr.launches
        eager = solve(i, eb)
        torch.cuda.synchronize()
        eager_launches = {"newton_step": nk.launches - n0,
                          "segment_sum": sr.launches - s0}
        graph = device_loop.new_graph()
        t0 = time.perf_counter()
        with device_loop.capture(graph, "cuda") as cap:
            out = solve(i, eb)
        capture_s = time.perf_counter() - t0
        if hasattr(graph, "instantiate"):
            graph.instantiate()
        torch.cuda.synchronize()
        device_loop.reset_graph_launches()
        graph.replay()
        counts = {"newton_step": device_loop.graph_launches("newton_step"),
                  "segment_sum": device_loop.graph_launches("segment_sum")}
        same = all(torch.equal(a, b) for a, b in (
            (out[0], eager[0]), (out[2], eager[2]), (out[3], eager[3])))
        rows.append({"bucket": list(eb.x_values.shape) + [eb.sub_dim],
                     "route": route, "capture_seconds": capture_s,
                     "graph_nodes": device_loop.graph_nodes(cap),
                     "conditional_nodes": cap.conditional_nodes,
                     "replay_kernels": counts,
                     "eager_launches": eager_launches,
                     "bit_identical": same,
                     "max_abs_diff": float((out[0] - eager[0]).abs().max())})
        # The graph dies here, outside any capture (``cap`` holds it too):
        # destroying a graph frees device memory, which would invalidate
        # the next bucket's capture were it to happen inside it.
        del graph, cap, out, eager
    row = {"phase": f"{group}_graph", "buckets": rows}
    emit(row)
    for r in rows:
        if not r["bit_identical"]:
            fail(f"{group}_graph: a bucket's captured solve differs from "
                 f"its eager solve: {r}")
        if (r["replay_kernels"]["newton_step"]
                != r["eager_launches"]["newton_step"]
                or r["replay_kernels"]["segment_sum"]
                != r["eager_launches"]["segment_sum"]):
            fail(f"{group}_graph: the replay's launches differ from the "
                 f"eager solve's: {r}")
    return row


def phase_wide_fit(torch, wide) -> dict:
    """GameEstimator.fit with the segment counts zeroed just before; then
    each coordinate's update timed alone at its final inputs."""
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.ops import segment_reduce as sr
    from photon_tpu_torch.optim import ConvergenceReason, lbfgs

    est, data = wide["est"], wide["data"]
    # One gram and one densify bucket of per-movie, solved in a graph.
    wide_coords = est._build_coordinates(wide["datasets"], {}, {})
    picks = {}
    for cid, i, eb, _, route in bucket_routes(wide["datasets"]):
        if cid == "per-movie" and route in ("gram", "densify"):
            picks.setdefault(route, (i, eb, route))
    graph_bucket_check(torch, "wide_fit", wide_coords["per-movie"],
                       list(picks.values()), None)
    sr.reset_counts()
    ra.route_solves.clear()
    nk.launches = 0
    lbfgs.host_syncs = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with _Residuals() as rec:
        t0 = time.perf_counter()
        results = est.fit(data)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    by_site = dict(sr.launches_by_site)
    routes = dict(ra.route_solves)
    peak = torch.cuda.max_memory_allocated()
    res = results[0]
    hist = res.descent.history
    converged = int(ConvergenceReason.GRADIENT_CONVERGED)
    direct_ok = all(
        bool((r.diagnostics.iterations == 1).all())
        and bool((r.diagnostics.reasons == converged).all())
        for r in hist if r.coordinate_id in RE_IDS)
    # Each coordinate's update alone (train and score, synchronised) at
    # the inputs of its last update in the fit.
    datasets = wide["datasets"]
    coords = est._build_coordinates(datasets, {}, {})
    total, parts = total_scores(torch, res.model, datasets, data)
    alone = {}
    for cid in est.update_sequence:
        residuals = (rec.last[id(datasets[cid])] if cid in RE_IDS
                     else total - parts[cid])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, _ = coords[cid].train(residuals)
        coords[cid].score(model)
        torch.cuda.synchronize()
        alone[cid] = time.perf_counter() - t0
    row = {"phase": "wide_fit", "rows": int(data.num_samples),
           "fit_seconds": fit_s,
           "seconds_per_cd_iteration": [
               sum(r.seconds for r in hist if r.iteration == i)
               for i in range(CD_ITERATIONS)],
           "host_seconds_per_coordinate": {
               cid: sum(r.seconds for r in hist if r.coordinate_id == cid)
               for cid in est.update_sequence},
           "update_seconds_alone": alone,
           "fe_lbfgs_iterations": [int(r.diagnostics.iterations)
                                   for r in hist
                                   if r.coordinate_id == "global"],
           "segment_launches_by_site": by_site,
           "route_solves": routes, "newton_kernel_launches": nk.launches,
           "lbfgs_host_syncs": lbfgs.host_syncs,
           "direct_solves_one_iteration_converged": direct_ok,
           "max_memory_allocated_bytes": peak}
    from photon_tpu_torch.algorithm.fused_fit import (
        fuse_ineligibility_reasons,
    )

    row["fused_fit"] = est._fused_cache is not None
    row["fuse_ineligibility_reasons"] = fuse_ineligibility_reasons(coords)
    emit(row)
    if row["fused_fit"] or not row["fuse_ineligibility_reasons"]:
        fail("wide_fit: the materialized layout took the fused path")
    missing = [s for s in FIT_SITES if by_site.get(s, 0) <= 0]
    if missing:
        fail(f"the fit launched the segment-sum kernel at no {missing}")

    if not direct_ok:
        fail("a direct solve did not report one iteration and "
             "GRADIENT_CONVERGED")
    return dict(row=row, model=res.model, residuals=rec.last, coords=coords,
                total=total, parts=parts)


def phase_wide_optimality(torch, wide, fit) -> list:
    """For OPT_SAMPLE sampled entities of every random-effect bucket, the
    normal equations in float64 numpy at the residuals of the entity's
    last solve (for ``per-movie``, last in the sequence, the final
    residuals); the fitted coefficients must agree within rtol OPT_RTOL /
    atol OPT_ATOL."""
    rows = []
    rng = np.random.default_rng(17)
    for cid, i, eb, _, route in bucket_routes(wide["datasets"]):
        est = wide["est"]
        l2w = l2_weight(est, cid)
        residuals = fit["residuals"][id(wide["datasets"][cid])]
        b = eb.num_entities
        sel_np = np.sort(rng.choice(b, size=min(OPT_SAMPLE, b),
                                    replace=False))
        sel = torch.from_numpy(sel_np).to(WIDE_DEVICE)
        sub = entity_subset(eb, sel)
        x = dense_x(torch, sub).cpu().numpy()
        wt = sub.weights.double().cpu().numpy()
        off = (sub.offsets.double() + torch.where(
            sub.weights > 0, residuals[sub.row_ids.long()].double(),
            torch.zeros((), dtype=torch.float64, device=WIDE_DEVICE))).cpu().numpy()
        y = sub.labels.double().cpu().numpy()
        pen = sub.penalty_mask.double().cpu().numpy()
        vm = sub.valid_mask.double().cpu().numpy()
        # Batched products (BLAS): a three-operand einsum loops in C
        # over b * r * s * s terms, over a minute at the widest bucket.
        xt = np.swapaxes(x, 1, 2)
        h = xt @ (x * wt[..., None])
        h += np.einsum("bs,st->bst", l2w * pen + (1.0 - vm),
                       np.eye(x.shape[-1]))
        rhs = (xt @ (wt * (y - off))[..., None])[..., 0]
        w64 = np.linalg.solve(h, rhs[..., None])[..., 0] * vm
        codes = sub.entity_codes.long()
        w_fit = fit["model"][cid].coefficients[codes][:, :x.shape[-1]]
        w_fit = w_fit.double().cpu().numpy()
        diff = np.abs(w_fit - w64)
        excess = diff - (OPT_ATOL + OPT_RTOL * np.abs(w64))
        row = {"phase": "wide_optimality", "coordinate": cid, "bucket": i,
               "shape": list(eb.x_values.shape), "route": route,
               "entities": int(sel_np.size),
               "max_abs_diff": float(diff.max()),
               "max_rel_diff": float((diff / np.maximum(np.abs(w64), 1e-3)
                                      ).max()),
               "max_excess": float(excess.max()),
               "max_abs_coefficient": float(np.abs(w64).max())}
        emit(row)
        rows.append(row)
        if not row["max_excess"] <= 0.0:
            fail(f"fitted coefficients differ from the float64 normal "
                 f"equations beyond rtol {OPT_RTOL} / atol {OPT_ATOL}: {row}")
    return rows


def phase_wide_route_agreement(torch, wide, fit) -> dict:
    """The per-movie coordinate solved as built (its narrow bucket on the
    gram route) and with ``GRAM_ELEMENT_BUDGET`` 0 (every bucket on
    densify), at the residuals of its last solve."""
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.ops import segment_reduce as sr

    coord = fit["coords"]["per-movie"]
    residuals = fit["residuals"][id(wide["datasets"]["per-movie"])]
    out = {}
    budget = sr.GRAM_ELEMENT_BUDGET
    for name, cap in (("gram", budget), ("densify", 0)):
        ra.route_solves.clear()
        sr.GRAM_ELEMENT_BUDGET = cap
        try:
            model, _ = coord.train(residuals)
            torch.cuda.synchronize()
        finally:
            sr.GRAM_ELEMENT_BUDGET = budget
        out[name] = (model.coefficients, dict(ra.route_solves))
    a, b = out["gram"][0], out["densify"][0]
    diff = (a - b).abs()
    excess = diff - (WIDE_ROUTE_ATOL + WIDE_ROUTE_RTOL * b.abs())
    row = {"phase": "wide_route_agreement",
           "routes": [out["gram"][1], out["densify"][1]],
           "max_abs_diff": float(diff.max()),
           "max_excess": float(excess.max()),
           "outside": int((excess > 0).sum()),
           "coefficients": int(diff.numel()),
           "rtol": WIDE_ROUTE_RTOL, "atol": WIDE_ROUTE_ATOL}
    emit(row)
    if out["gram"][1].get("gram", 0) < 1 or "gram" in out["densify"][1]:
        fail(f"the two solves did not take their routes: {row}")
    if not row["max_excess"] <= 0.0:
        fail(f"the gram and densify routes disagree: {row}")
    return row


def phase_wide_train_serve(torch, wide, fit) -> dict:
    """The trained wide model through save_checkpoint -> load_checkpoint
    -> ScorePrograms (the tag shard served as ELL rows) on 512 training
    rows, against the trainer's scores (score table plus tail)."""
    from photon_tpu_torch.io.model_io import load_checkpoint, save_checkpoint
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.programs import FeatureSpec, ScorePrograms
    from photon_tpu_torch.serve.tables import CoefficientTables

    arrays = wide["arrays"]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke")
    path = save_checkpoint(fit["model"], os.path.join(
        out_dir, "wide_model.npz"))
    specs = {"global": FeatureSpec("dense", TRAIN_FEATURES),
             "userShard": FeatureSpec("dense", USER_FEATURES + 1),
             WIDE_SHARD: FeatureSpec("sparse", WIDE_TAGS + 1, k=WIDE_K)}
    programs = ScorePrograms(CoefficientTables.from_game_model(
        load_checkpoint(path, WIDE_DEVICE), "float32", device=WIDE_DEVICE),
        specs=specs)
    rows = np.random.default_rng(3).choice(
        arrays["y"].shape[0], size=SERVE_ROWS, replace=False)
    requests = [
        ({"global": arrays["x"][i], "userShard": arrays["xu"][i],
          WIDE_SHARD: (arrays["idx"][i], arrays["val"][i])},
         {"userId": str(arrays["users"][i]),
          "movieId": str(arrays["movies"][i])})
        for i in rows
    ]
    feats, codes, rung = programs.pack_requests(requests)
    zero_serve_counts(serve_kernel)
    served = programs.score_padded(feats, codes, len(requests))
    launches = sum(serve_counts(serve_kernel))
    trainer = fit["total"][torch.from_numpy(rows).to(WIDE_DEVICE)].cpu().numpy()
    err = float(np.abs(served - trainer).max())
    row = {"phase": "wide_train_serve", "requests": len(requests),
           "rung": rung, "serve_kernel_launches": launches,
           "max_abs_err": err, "tol": TOL["float32"], "checkpoint": path}
    emit(row)
    if launches != 1 or not err <= TOL["float32"]:
        fail(f"served scores of the wide model differ from the trainer's "
             f"by {err} ({launches} launches)")
    return row


def phase_wide_logistic(torch) -> dict:
    """The same generator at a tenth of the rows and entities, logistic:
    every per-movie bucket is densified; those within the Newton gate
    (R * S <= 16384, here the 64-row buckets of S > 128) take the Newton
    kernel's wide design, the rest the batch-minor Newton loop; then the
    logistic optimality check of phase 10, and the wide design's parity
    and timing at its widest bucket."""
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.ops import segment_reduce as sr

    arrays = wide_arrays(**WIDE_REDUCED, task="logistic")
    data = wide_dataset(arrays)
    est = wide_estimator("logistic")
    datasets, _ = est.prepare(data)
    buckets = bucket_routes(datasets, direct=False)
    wide = [(cid, eb) for cid, _, eb, _, _ in buckets
            if eb.sub_dim > nk.NARROW_SUB_DIM
            and eb.x_values.shape[1] * eb.sub_dim <= nk.MAX_RS]
    past_gate = sum(1 for _, _, eb, _, _ in buckets
                    if eb.x_values.shape[1] * eb.sub_dim > nk.MAX_RS)
    # The widest wide-design bucket's solve (densify, then the Newton
    # loop on the wide kernel) in a graph, before the fit (as in
    # wide_fit).
    gcid, geb = max(wide, key=lambda w: w[1].sub_dim)
    gi = next(i for c, i, b, _, _ in buckets if c == gcid and b is geb)
    graph_bucket_check(torch, "wide_logistic",
                       est._build_coordinates(datasets, {}, {})[gcid],
                       [(gi, geb, "densify")], None)
    sr.reset_counts()
    ra.route_solves.clear()
    nk.launches = nk.wide_launches = ra.plain_route_solves = 0
    t0 = time.perf_counter()
    res = est.fit(data)[0]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    row = {"phase": "wide_logistic", **WIDE_REDUCED, "fit_seconds": fit_s,
           "segment_launches_by_site": dict(sr.launches_by_site),
           "route_solves": dict(ra.route_solves),
           "newton_kernel_launches": nk.launches,
           "newton_wide_launches": nk.wide_launches,
           "plain_route_solves": ra.plain_route_solves,
           "wide_kernel_buckets": [list(eb.x_values.shape) + [eb.sub_dim]
                                   for _, eb in wide],
           "past_gate_bucket_solves": past_gate * CD_ITERATIONS}
    emit(row)
    if sr.launches_by_site.get("segment_reduce/densify", 0) <= 0:
        fail("the wide logistic fit launched no densify")
    if not wide or nk.wide_launches <= 0:
        fail(f"no wide bucket took the Newton kernel: {row}")
    if ra.plain_route_solves != past_gate * CD_ITERATIONS:
        fail(f"buckets past the Newton gate and the Newton loop's plain "
             f"route disagree: {row}")
    if nk.launches <= nk.wide_launches:
        fail("the narrow buckets did not take the Newton kernel")
    hist = res.descent.history
    last = {r.coordinate_id: r for r in hist
            if r.iteration == CD_ITERATIONS - 1}
    stats = {"l2": {cid: l2_weight(est, cid) for cid in RE_IDS},
             "reasons": {cid: last[cid].diagnostics.reasons
                         for cid in RE_IDS}}
    phase_optimality(torch, res.model, datasets, data, stats,
                     phase="wide_logistic_optimality")
    # The wide design against its plain version, and its timing, at the
    # widest bucket it serves.
    cid, eb = max(wide, key=lambda w: w[1].sub_dim)
    timing = wide_newton_check(torch, "wide_logistic", cid, eb,
                               l2_weight(est, cid))

    return dict(row, timing=timing, arrays=arrays)


def wide_newton_check(torch, group, cid, eb, l2w) -> dict:
    """newton_parity's three-step check and newton_timing's columns for
    one wide ELL bucket, densified as the solver densifies it, on the
    logistic operands ``newton_operands`` builds (the Newton kernel's
    wide design)."""
    import dataclasses

    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.ops import segment_reduce as sr
    from photon_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    r = eb.x_values.shape[1]
    if not nk.kernel_supported(task, eb.x_values.dtype, r, eb.sub_dim):
        fail(f"{group}: the bucket [{r} x {eb.sub_dim}] is outside the "
             "Newton kernel's gate")
    eb = dataclasses.replace(eb, x_indices=None, x_values=(
        sr.densify_ell_blocks(eb.x_indices, eb.x_values, eb.sub_dim)))
    worst, _ = newton_parity_steps(torch, cid, eb, l2w,
                                   phase="wide_newton_parity")
    args = step_args(newton_operands(torch, eb, l2w))
    shape = tuple(eb.x_values.shape)
    timing = {"phase": "wide_newton_timing", "group": group,
              "coordinate": cid, "bucket": list(shape), "max_abs_err": worst,
              "ms": device_ms(torch, lambda: nk.newton_step(
                  *args, task=task), 5),
              "plain_ms": device_ms(torch, lambda: nk.newton_step_plain(
                  *args, task=task), 1),
              **newton_bound(shape)}
    emit(timing)
    return timing


# ell_routes: the tag shard folded onto ELL_FOLD ids (a pool of at most
# 127 a movie) plus the intercept id ELL_FOLD, so every per-movie
# subspace has at most 128 slots and the auto layout is lazy.
ELL_FOLD = 127
ELL_SHARD = "tagFold"
ELL_WARM = 2
ELL_SAMPLE = 256
ELL_DUAL_CAP = 4
ELL_DUAL_SHARD = "tagDual"
ELL_SCORE_REL = 1e-5
# The ell route on the card against the CPU in float64.
ELL_EXACT64 = dict(rtol=1e-9, atol=1e-11)
ELL_CPU_SAMPLE = 64


def ell_fold(arrays) -> np.ndarray:
    """The wide tag ids folded onto ELL_FOLD ids (two tags of a row may
    meet: their values add), the intercept moved to ELL_FOLD."""
    idx = arrays["idx"]
    return np.where(idx == WIDE_TAGS, ELL_FOLD,
                    idx % ELL_FOLD).astype(np.int32)


def ell_labels(arrays, seed=TRAIN_SEED + 19) -> np.ndarray:
    """Logistic labels drawn from the wide generator's margin, as
    ``wide_arrays(task="logistic")`` draws them."""
    rng = np.random.default_rng(seed)
    p = 1.0 / (1.0 + np.exp(-0.5 * arrays["z"]))
    return (rng.uniform(size=p.shape) < p).astype(np.float32)


def ell_estimator(device=WIDE_DEVICE):
    """The bench's logistic estimator with ``per-movie`` on the folded
    tag shard and no score-table width cap."""
    from photon_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
    )

    return build_estimator(
        "logistic",
        movie=RandomEffectDataConfiguration(
            "movieId", ELL_SHARD, active_data_upper_bound=2048,
            min_bucket_entities=128),
        intercepts={"global": TRAIN_FEATURES - 1, "userShard": USER_FEATURES,
                    ELL_SHARD: ELL_FOLD},
        device=device)


def ell_sampled_optimality(torch, est, datasets, data, res, *, phase,
                           sample=ELL_SAMPLE) -> list:
    """``entity_optimality`` on ``sample`` entities drawn from every
    bucket the fused fit solved, each entity's reason read from the
    fused diagnostics (entity-code order)."""
    ff = next(iter(est._fused_cache.values()))
    mats = est._fused_mat_share["ebs"]
    hist = res.descent.history
    last = {r.coordinate_id: r for r in hist
            if r.iteration == CD_ITERATIONS - 1}
    total, parts = total_scores(torch, res.model, datasets, data)
    rng = np.random.default_rng(23)
    rows = []
    for cid in RE_IDS:
        keep = ff._re_meta[cid]["keep"]
        by_code = np.zeros(keep.shape[0], dtype=np.int64)
        by_code[np.nonzero(keep)[0]] = last[cid].diagnostics.reasons
        subs, reasons = [], []
        for eb in mats[cid]["ebs"]:
            b = eb.num_entities
            pick = np.sort(rng.choice(b, size=min(sample, b), replace=False))
            sel = torch.from_numpy(pick).to(eb.labels.device)
            subs.append(entity_subset(eb, sel))
            reasons.append(by_code[eb.entity_codes[sel].long().cpu()
                                   .numpy()])
        rows.append(entity_optimality(
            torch, None, total - parts[cid], res.model[cid],
            np.concatenate(reasons), l2_weight(est, cid), phase=phase,
            cid=cid, blocks=subs))
    return rows


def ell_densify_parity(torch, ebs, routes, cid, l2w) -> list:
    """Every ELL bucket of ``ebs`` on the ``densify`` route at the shapes
    the fit gave it: the segment-sum kernel's densify against
    ``densify_ell_plain`` (duplicate slots of a row summed) within
    SEGMENT_REL of 1 + the densified magnitudes, then, where the Newton
    kernel takes the dense slab, ``newton_parity_steps`` on it (its
    entities with rows: a padded entity has no objective to move)."""
    import dataclasses

    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.ops import segment_reduce as sr
    from photon_tpu_torch.types import TaskType

    rows = []
    for eb, route in zip(ebs, routes):
        if route != "densify":
            continue
        b, r, k = eb.x_indices.shape
        got = sr.densify_ell_blocks(eb.x_indices, eb.x_values, eb.sub_dim)
        if got is None:
            fail(f"ell_routes: the densify route refused [{b} x {r} x {k}]")
        torch.cuda.synchronize()
        plain = sr.densify_ell_plain(eb.x_indices, eb.x_values, eb.sub_dim)
        mag = sr.densify_ell_plain(eb.x_indices, eb.x_values.abs(),
                                   eb.sub_dim)
        diff = (got - plain).abs()
        newton = nk.kernel_supported(TaskType.LOGISTIC_REGRESSION,
                                     got.dtype, r, eb.sub_dim)
        row = {"phase": "ell_densify_parity", "coordinate": cid,
               "bucket": [b, r, k, eb.sub_dim],
               "max_abs_err": float(diff.max()),
               "max_err_over_bound": float(
                   (diff / (SEGMENT_REL * (1.0 + mag))).max()),
               "newton_kernel": newton}
        del plain, mag, diff
        emit(row)
        if not row["max_err_over_bound"] <= 1.0:
            fail(f"ell_routes: the densify kernel disagrees with its plain "
                 f"version: {row}")
        if newton:
            dense = dataclasses.replace(eb, x_indices=None, x_values=got)
            real = dense.weights.sum(dim=1) > 0
            if not bool(real.all()):
                dense = entity_subset(dense, real)
            row["newton_max_abs_diff"], _ = newton_parity_steps(
                torch, cid, dense, l2w, phase="ell_newton_parity")
            del dense
        rows.append(row)
        del got
    return rows


def reasons_by_code(res, ds, cid, fused) -> np.ndarray:
    """Each entity's convergence code at the last CD iteration of
    ``res``, indexed by entity code (-1 where no bucket holds it): a
    fused fit reports entity-code order, an unfused one bucket order."""
    hist = res.descent.history
    last = [r for r in hist if r.coordinate_id == cid][-1]
    n = ds.num_entities
    if fused:
        codes = np.unique(np.concatenate(
            [c[c < n] for c in ds.block_codes_np]))
    else:
        codes = np.concatenate([c[c < n] for c in ds.block_codes_np])
    out = np.full(n, -1, dtype=np.int64)
    out[codes] = last.diagnostics.reasons
    return out


def entity_gaps(torch, est, datasets, data, fused, unfused, *,
                phase) -> dict:
    """Per random-effect coordinate, the entities whose coefficients in
    the ``fused`` and ``unfused`` fit results lie more than
    FUSED_RE_ATOL apart. Such an entity passes only where both fits
    stopped on its objective (FUNCTION_VALUES_CONVERGED or
    OBJECTIVE_NOT_IMPROVING: an f32 solve in a flat valley) and the two
    models' float64 objectives on its rows (logistic loss at each
    model's own total scores plus the entity's L2 term) agree within
    ROUND_OFF of 1 + |objective|. Emits their count, both fits' codes
    for them and the largest objective gap; returns the failures."""
    from photon_tpu_torch.optim import ConvergenceReason

    flat = (int(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
            int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING))
    mats = est._fused_mat_share["ebs"]
    scores = [total_scores(torch, r.model, datasets, data)
              for r in (fused, unfused)]
    out, bad = {}, {}
    for cid in RE_IDS:
        ds = datasets[cid]
        wf = fused.model[cid].coefficients.double()
        wu = unfused.model[cid].coefficients.double()
        diff = (wf - wu).abs().amax(dim=1)
        beyond = np.nonzero((diff > FUSED_RE_ATOL).cpu().numpy())[0]
        codes = {name: reasons_by_code(res, ds, cid, is_fused)[beyond]
                 for name, res, is_fused in (("fused", fused, True),
                                             ("unfused", unfused, False))}
        want = torch.zeros(diff.shape[0], dtype=torch.bool,
                           device=diff.device)
        want[torch.from_numpy(beyond).to(diff.device)] = True
        gap = torch.full((diff.shape[0],), float("nan"),
                         dtype=torch.float64, device=diff.device)
        l2 = l2_weight(est, cid)
        for eb in mats[cid]["ebs"] if beyond.size else ():
            sel = want[eb.entity_codes.long()]
            if not bool(sel.any()):
                continue
            sub = entity_subset(eb, sel)
            x = dense_x(torch, sub)
            ind = (sub.labels > 0.5).double()
            objs = []
            for (total, parts), w_all in zip(scores, (wf, wu)):
                w = w_all[sub.entity_codes.long()][:, :x.shape[-1]]
                z = (torch.einsum("brs,bs->br", x, w)
                     + coordinate_offsets(sub, total - parts[cid]))
                loss = (torch.log1p(torch.exp(-z.abs())) + z.clamp(min=0.0)
                        - z * ind)
                objs.append((sub.weights.double() * loss).sum(dim=1)
                            + 0.5 * l2 * (sub.penalty_mask.double()
                                          * w * w).sum(dim=1))
            gap[sub.entity_codes.long()] = (
                (objs[0] - objs[1]).abs() / (1.0 + objs[1].abs()))
        gaps = gap[torch.from_numpy(beyond).to(gap.device)].cpu().numpy()
        ok = (np.isin(codes["fused"], flat) & np.isin(codes["unfused"], flat)
              & (gaps <= ROUND_OFF))
        row = {"entities": int(diff.shape[0]),
               "max_coefficient_diff": float(diff.max()),
               "entities_beyond": int(beyond.size),
               "objective_rel_gap_max": (float(np.nanmax(gaps))
                                         if beyond.size else None),
               "failing": int((~ok).sum())}
        for name, c in codes.items():
            row[f"reasons_{name}"] = {
                ConvergenceReason(int(v)).name if v >= 0 else "none":
                    int((c == v).sum()) for v in np.unique(c)}
        out[cid] = row
        if not ok.all():
            bad[cid] = row
    emit({"phase": phase, "bound": FUSED_RE_ATOL, "round_off": ROUND_OFF,
          "coordinates": out})
    return bad


def phase_ell_routes_full(torch, arrays) -> dict:
    """(a) The lazy per-movie coordinate past the one-hot budget, at full
    width inside the fused fit (module docstring, phase 24a)."""
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.data import random_effect as re_data
    from photon_tpu_torch.data.dataset import DenseFeatures, SparseFeatures
    from photon_tpu_torch.data.game_data import make_game_dataset
    from photon_tpu_torch.optim import batched, lbfgs
    from photon_tpu_torch.utils import device_loop

    t_phase = time.perf_counter()
    data = make_game_dataset(
        ell_labels(arrays),
        {"global": DenseFeatures(arrays["x"]),
         "userShard": DenseFeatures(arrays["xu"]),
         ELL_SHARD: SparseFeatures(ell_fold(arrays), arrays["val"],
                                   ELL_FOLD + 1)},
        id_tags={"userId": arrays["users"], "movieId": arrays["movies"]},
        device=WIDE_DEVICE)
    est = ell_estimator()
    datasets, plan_row = timed_prepare(torch, est, data)
    movie = datasets["per-movie"]
    budget = re_data.ONE_HOT_ELEMENT_BUDGET
    buckets = []
    for p in movie.device_plans():
        b, r = p.row_ids.shape
        k, s = p.raw.indices.shape[1], p.sub_dim
        buckets.append({"shape": [b, r, k, s], "elements": b * r * k * s,
                        "budget": budget,
                        "over_budget": b * r * k * s > budget,
                        "ell_width": p.ell_width()})
    with unfused(est):
        unfused_row, unfused_res = fit_trajectory(torch, est, data)
    device_loop.reset_graph_launches()
    cold, _ = fit_trajectory(torch, est, data)
    cold_launches = {n: device_loop.graph_launches(n)
                     for n in ("segment_sum", "newton_step")}
    ff = next(iter(est._fused_cache.values())) if est._fused_cache else None
    cap = None if ff is None else ff.captured()
    warm, results = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(ELL_WARM):
        device_loop.reset_graph_launches()
        before = (ra.host_syncs, batched.host_syncs, lbfgs.host_syncs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = est.fit(data)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        warm.append({"seconds": time.perf_counter() - t0,
                     "solver_syncs": [a - b for a, b in zip(
                         (ra.host_syncs, batched.host_syncs,
                          lbfgs.host_syncs), before)],
                     "segment_launches": device_loop.graph_launches(
                         "segment_sum"),
                     "newton_launches": device_loop.graph_launches(
                         "newton_step")})
        results.append(res)
    peak = torch.cuda.max_memory_allocated()
    mats = est._fused_mat_share["ebs"]["per-movie"]["ebs"]
    for info, eb in zip(buckets, mats):
        info["materialized_ell"] = eb.x_indices is not None
    routes = est._build_coordinates(datasets, {}, {})[
        "per-movie"].bucket_routes()
    for info, route in zip(buckets, routes):
        info["route"] = route
    bit_equal = model_arrays_equal(results[0].model, results[1].model)
    diffs = model_diffs(torch, results[-1].model, unfused_res.model)
    unfused_equal = model_arrays_equal(results[-1].model, unfused_res.model)
    row = {"phase": "ell_routes_full", "rows": int(arrays["y"].shape[0]),
           "layout": "lazy" if movie.is_lazy else "materialized",
           "movie_max_sub_dim": movie.max_sub_dim,
           "planner_host_seconds": plan_row["seconds"],
           "buckets": buckets,
           "fused": cold["fused"],
           "capture_seconds": None if cap is None else cap.seconds,
           "instantiate_seconds": (None if cap is None
                                   else cap.instantiate_seconds),
           "graph_nodes": None if cap is None else cap.nodes,
           "conditional_nodes": (None if cap is None
                                 else cap.conditional_nodes),
           "captured_segment_sites": None if cap is None else cap.segment,
           "captured_newton_buckets": (None if cap is None else {
               "x".join(map(str, k)) if isinstance(k, tuple) else str(k): v
               for k, v in cap.newton.items()}),
           "cold_seconds": cold["fit_seconds"],
           "cold_replay_launches": cold_launches,
           "warm": warm,
           "warm_seconds": [w["seconds"] for w in warm],
           "unfused_seconds": unfused_row["fit_seconds"],
           "unfused_host_syncs": unfused_row["newton_host_syncs"],
           "max_memory_allocated_bytes_warm": peak,
           "max_memory_allocated_bytes_unfused":
               unfused_row["max_memory_allocated_bytes"],
           "fused_fits_bit_identical": bit_equal,
           "unfused_bit_identical": unfused_equal,
           "max_abs_coefficient_diff_unfused": diffs,
           "bounds": {"global": FUSED_FE_ATOL, "random": FUSED_RE_ATOL}}
    emit(row)
    gaps = entity_gaps(torch, est, datasets, data, results[-1],
                       unfused_res, phase="ell_routes_unfused_entities")
    if not movie.is_lazy:
        fail("ell_routes: the folded per-movie coordinate is not lazy")
    if not any(b["over_budget"] for b in buckets):
        fail(f"ell_routes: no per-movie bucket is over the one-hot budget: "
             f"{buckets}")
    if any(b["over_budget"] != b["materialized_ell"]
           or b["materialized_ell"] != (b["ell_width"] is not None)
           for b in buckets):
        fail(f"ell_routes: the over-budget buckets and the ELL slabs "
             f"disagree: {buckets}")
    if not cold["fused"] or cap is None:
        fail("ell_routes: the fit did not capture the fused graph")
    if any(any(w["solver_syncs"]) for w in warm):
        fail(f"ell_routes: a warm fused fit made a host sync: {warm}")
    captured = {} if cap is None else cap.segment
    if captured.get("segment_reduce/densify", 0) <= 0:
        fail(f"ell_routes: the graph captured no densify: {captured}")
    if any(w["segment_launches"] <= 0 or w["newton_launches"] <= 0
           for w in warm):
        fail(f"ell_routes: a replay launched no segment sum or no Newton "
             f"step: {warm}")
    if not bit_equal:
        fail("ell_routes: two fused fits differ")
    ell_sampled_optimality(torch, est, datasets, data, results[-1],
                           phase="ell_routes_optimality")
    ell_densify_parity(torch, mats, routes, "per-movie",
                       l2_weight(est, "per-movie"))
    if not unfused_equal and (diffs["global"] > FUSED_FE_ATOL or gaps):
        fail(f"ell_routes: the fused and unfused models differ beyond "
             f"{FUSED_FE_ATOL} (global) or, for an entity, beyond "
             f"{FUSED_RE_ATOL} with no objective stop in both fits or an "
             f"objective gap past {ROUND_OFF}: {diffs} {gaps}")
    launches = {"segment_sum": cold_launches["segment_sum"] + sum(
        w["segment_launches"] for w in warm),
        "newton_step": cold_launches["newton_step"] + sum(
            w["newton_launches"] for w in warm)}
    emit({"phase": "ell_routes_full_done",
          "seconds": time.perf_counter() - t_phase, "launches": launches})
    del data, est, datasets, results, mats
    empty_cache()
    return launches


def phase_ell_routes_f64(torch, arrays) -> dict:
    """(b) The ``ell`` route at a tenth of the rows in float64 (phase
    24b): ``per-movie`` on the wide tag shard, every bucket ELL and wide
    (densify takes no float64), solved at fixed residuals on the card,
    twice; then ELL_CPU_SAMPLE entities of every bucket solved on the
    CPU by the same route (each entity's solve is its own: its
    iterations, reason and coefficients do not depend on its bucket's
    other entities)."""
    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.algorithm.problems import (
        GLMOptimizationConfiguration,
        VarianceComputationType,
    )
    from photon_tpu_torch.data import random_effect as re_data
    from photon_tpu_torch.data.dataset import SparseFeatures
    from photon_tpu_torch.data.game_data import make_game_dataset
    from photon_tpu_torch.ops import segment_reduce as sr
    from photon_tpu_torch.types import TaskType

    task = TaskType.LOGISTIC_REGRESSION
    cfg = GLMOptimizationConfiguration(
        regularization=optim.RegularizationContext(
            optim.RegularizationType.L2), regularization_weight=1.0)
    data = make_game_dataset(
        arrays["y"], {WIDE_SHARD: SparseFeatures(
            arrays["idx"], arrays["val"], WIDE_TAGS + 1)},
        id_tags={"movieId": arrays["movies"]}, dtype=torch.float64,
        device=WIDE_DEVICE)
    ds = re_data.build_random_effect_dataset(
        data, re_data.RandomEffectDataConfiguration(
            "movieId", WIDE_SHARD, active_data_upper_bound=2048,
            score_table_width_cap=WIDE_TABLE_CAP, min_bucket_entities=128),
        intercept_index=WIDE_TAGS)
    coord = ra.RandomEffectCoordinate(ds, task, cfg)
    residuals = torch.from_numpy(np.random.default_rng(29).normal(
        size=ds.num_rows) * 0.1).to(WIDE_DEVICE)
    sr.reset_counts()
    ra.route_solves.clear()
    sync(torch, WIDE_DEVICE)
    t0 = time.perf_counter()
    model, stats = coord.train(residuals)
    sync(torch, WIDE_DEVICE)
    card_s = time.perf_counter() - t0
    routes = dict(ra.route_solves)
    again, _ = coord.train(residuals)
    rerun_equal = bool(torch.equal(model.coefficients, again.coefficients))
    # The card's per-entity results; ``stats`` is in bucket order.
    w_card = model.coefficients.cpu().numpy()
    its_card, rs_card = stats.iterations, stats.reasons
    rng = np.random.default_rng(31)
    res_cpu = residuals.cpu()
    e, smax = ds.num_entities, ds.max_sub_dim
    worst_excess, worst_diff, its_equal, rs_equal = -np.inf, 0.0, True, True
    base = 0
    cpu_routes: dict = {}
    t0 = time.perf_counter()
    for eb in ds.blocks:
        b = eb.num_entities
        pick = np.sort(rng.choice(b, size=min(ELL_CPU_SAMPLE, b),
                                  replace=False))
        sel = torch.from_numpy(pick).to(eb.labels.device)
        sub = entity_subset(eb, sel, "cpu")
        ra.route_solves.clear()
        w_all, _, it, reason = ra._solve_block(
            sub, res_cpu, None, None,
            torch.zeros((e, smax), dtype=torch.float64), 0.0,
            cfg.l2_weight, 1.0, None,
            torch.zeros((e, smax), dtype=torch.float64), None,
            sub_dim=eb.sub_dim, task=task, opt_config=cfg.optimizer,
            variance_computation=VarianceComputationType.NONE,
            direct=False, newton=True)
        for k, v in ra.route_solves.items():
            cpu_routes[k] = cpu_routes.get(k, 0) + v
        codes = sub.entity_codes.long().numpy()
        w_cpu = w_all.numpy()[codes]
        diff = np.abs(w_card[codes] - w_cpu)
        worst_diff = max(worst_diff, float(diff.max()))
        worst_excess = max(worst_excess, float((diff - (
            ELL_EXACT64["atol"] + ELL_EXACT64["rtol"] * np.abs(w_cpu))
        ).max()))
        its_equal &= bool(np.array_equal(its_card[base + pick],
                                         it.numpy()))
        rs_equal &= bool(np.array_equal(rs_card[base + pick],
                                        reason.numpy()))
        base += b
    cpu_s = time.perf_counter() - t0
    buckets = [list(b.x_indices.shape) + [b.sub_dim] for b in ds.blocks]
    row = {"phase": "ell_routes_f64", **WIDE_REDUCED, "buckets": buckets,
           "routes": routes, "routes_cpu_sample": cpu_routes,
           "card_seconds": card_s, "cpu_sample_seconds": cpu_s,
           "cpu_sample_per_bucket": ELL_CPU_SAMPLE,
           "iterations_max": int(its_card.max()),
           "iterations_equal": its_equal, "reasons_equal": rs_equal,
           "max_abs_diff": worst_diff, "max_excess": worst_excess,
           "bit_identical_rerun": rerun_equal,
           "segment_launches": sr.launches}
    emit(row)
    if routes != {"ell": len(buckets)} or cpu_routes != routes:
        fail(f"ell_routes_f64: the wide buckets took {routes} on the card "
             f"and {cpu_routes} on the CPU, expected the ell route")
    if not (its_equal and rs_equal):
        fail(f"ell_routes_f64: iterations or reasons differ from the "
             f"CPU's: {row}")
    if not worst_excess <= 0.0:
        fail(f"ell_routes_f64: coefficients beyond rtol 1e-9 / atol 1e-11 "
             f"of the CPU's: {row}")
    if not rerun_equal:
        fail("ell_routes_f64: two solves on the card differ")
    del data, ds, coord
    return row


def numpy_dual_scores(model, arrays) -> np.ndarray:
    """Float64 numpy scores of the rows (their whole ELL rows, slab and
    tail) under ``model``: the fixed effect's dot plus each row's
    movie's coefficients at the row's ids in its subspace."""
    fe = model["tags"].model.coefficients.means.double().cpu().numpy()
    idx, val = arrays["idx"].astype(np.int64), arrays["val"].astype(
        np.float64)
    z = np.sum(val * fe[idx], axis=1)
    re = model["per-movie"]
    w = re.coefficients.double().cpu().numpy()
    proj = re.proj_all
    code_of = {k: i for i, k in enumerate(re.entity_keys)}
    codes = np.array([code_of.get(str(m), -1)
                      for m in np.unique(arrays["movies"])])
    row_codes = codes[np.searchsorted(np.unique(arrays["movies"]),
                                      arrays["movies"])]
    stride = WIDE_TAGS + 1
    valid = proj >= 0
    ent = np.broadcast_to(np.arange(proj.shape[0])[:, None], proj.shape)
    keys = ent[valid] * stride + proj[valid]
    order = np.argsort(keys)
    keys, wv = keys[order], w[valid][order]
    q = np.maximum(row_codes, 0)[:, None] * stride + idx
    pos = np.minimum(np.searchsorted(keys, q), keys.size - 1)
    hit = (keys[pos] == q) & (row_codes[:, None] >= 0)
    return z + np.sum(np.where(hit, val * wv[pos], 0.0), axis=1)


def phase_ell_routes_dual(torch, arrays) -> dict:
    """(c) The tag shard as a dual-ELL shard at a tenth of the rows: a
    fixed effect and ``per-movie`` over it (phase 24c)."""
    from photon_tpu_torch.algorithm.problems import (
        GLMOptimizationConfiguration,
    )
    from photon_tpu_torch import optim
    from photon_tpu_torch.cli import score as score_cli
    from photon_tpu_torch.data.dataset import ell_to_dual_ell
    from photon_tpu_torch.data.game_data import make_game_dataset
    from photon_tpu_torch.data.random_effect import (
        RandomEffectDataConfiguration,
    )
    from photon_tpu_torch.estimators.game_estimator import (
        FixedEffectCoordinateConfiguration,
        GameEstimator,
        RandomEffectCoordinateConfiguration,
    )
    from photon_tpu_torch.ops import segment_reduce as sr
    from photon_tpu_torch.transformers import GameTransformer
    from photon_tpu_torch.types import TaskType

    def l2(weight):
        return GLMOptimizationConfiguration(
            regularization=optim.RegularizationContext(
                optim.RegularizationType.L2),
            regularization_weight=weight)

    dual = ell_to_dual_ell(arrays["idx"], arrays["val"], WIDE_TAGS + 1,
                           ELL_DUAL_CAP, device=WIDE_DEVICE)
    data = make_game_dataset(arrays["y"], {ELL_DUAL_SHARD: dual},
                             id_tags={"movieId": arrays["movies"]},
                             device=WIDE_DEVICE)
    est = GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"tags": FixedEffectCoordinateConfiguration(ELL_DUAL_SHARD,
                                                    l2(1e-3)),
         "per-movie": RandomEffectCoordinateConfiguration(
             RandomEffectDataConfiguration(
                 "movieId", ELL_DUAL_SHARD, active_data_upper_bound=2048,
                 score_table_width_cap=WIDE_TABLE_CAP,
                 min_bucket_entities=128), l2(1.0))},
        intercept_indices={ELL_DUAL_SHARD: WIDE_TAGS},
        num_iterations=CD_ITERATIONS, device=WIDE_DEVICE)
    est.prepare(data)
    fits, seconds, launches = [], [], []
    for _ in range(2):
        sr.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits.append(est.fit(data)[0])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches.append(dict(sr.launches_by_site))
    bit_equal = model_arrays_equal(fits[0].model, fits[1].model)
    sr.reset_counts()
    scores = GameTransformer(fits[0].model).score(data).double().cpu().numpy()
    transformer_launches = dict(sr.launches_by_site)
    want = numpy_dual_scores(fits[0].model, arrays)
    rel = float(np.max(np.abs(scores - want) / (1.0 + np.abs(want))))
    report: dict = {}
    cli_scores, _ = score_cli.score_game_dataset(fits[0].model, data,
                                                 report=report)
    cli_equal = bool(np.array_equal(np.asarray(cli_scores, np.float64),
                                    scores))
    row = {"phase": "ell_routes_dual", **WIDE_REDUCED,
           "width_cap": ELL_DUAL_CAP,
           "tail_entries": int(dual.tail_rows.shape[0]),
           "fused": bool(est._fused_cache) and est.emitter is None,
           "fit_seconds": seconds,
           "launches_by_site": launches,
           "transformer_launches_by_site": transformer_launches,
           "fits_bit_identical": bit_equal,
           "score_max_rel_err": rel,
           "cli_route": report.get("serve_kernel"),
           "cli_scores_equal": cli_equal}
    emit(row)
    for site in ("fixed_effect", "segment_reduce/score_tail"):
        if any(n.get(site, 0) <= 0 for n in launches):
            fail(f"ell_routes_dual: no launch at the {site} site: {row}")
    if not bit_equal:
        fail("ell_routes_dual: two fits on the dual shard differ")
    if not rel <= ELL_SCORE_REL:
        fail(f"ell_routes_dual: GameTransformer's scores are {rel} from "
             f"the float64 numpy score (bound {ELL_SCORE_REL})")
    if report.get("serve_kernel") != "transformer" or not cli_equal:
        fail(f"ell_routes_dual: cli.score's fallback route disagrees: "
             f"{row}")
    return row


def phase_ell_routes(torch, arrays) -> dict:
    """Phase 24a on the wide group's full-width arrays: the launches it
    counted on the card (``segment_launches``, ``newton_launches``)."""
    t0 = time.perf_counter()
    full = phase_ell_routes_full(torch, arrays)
    emit({"phase": "ell_routes", "part": "a",
          "t": time.perf_counter() - t0})
    return {"segment_launches": full["segment_sum"],
            "newton_launches": full["newton_step"]}


def phase_ell_routes_small(torch, arrays) -> dict:
    """Phases 24b and 24c on ``wide_logistic``'s arrays (a tenth of the
    rows): the segment-sum launches they counted."""
    t0 = time.perf_counter()
    f64 = phase_ell_routes_f64(torch, arrays)
    emit({"phase": "ell_routes", "part": "b",
          "t": time.perf_counter() - t0})
    t0 = time.perf_counter()
    dual = phase_ell_routes_dual(torch, arrays)
    emit({"phase": "ell_routes", "part": "c",
          "t": time.perf_counter() - t0})
    return {"segment_launches_small": f64["segment_launches"] + sum(
        sum(d.values()) for d in dual["launches_by_site"])}


def phase_wide(torch) -> dict:
    """The wide-linear group; returns the segment-sum kernel's entry of
    the ``kernels`` line."""
    from photon_tpu_torch.ops import segment_reduce as sr

    wide = phase_wide_data(torch)
    ops = site_operands(torch, wide["datasets"])
    worst = phase_segment_parity(torch, ops)
    timing = phase_segment_timing(torch, ops)
    del ops
    empty_cache()
    fit = phase_wide_fit(torch, wide)
    phase_wide_optimality(torch, wide, fit)
    phase_wide_route_agreement(torch, wide, fit)
    phase_wide_train_serve(torch, wide, fit)
    # The Newton kernel's wide design at full width: the per-movie gram
    # bucket, on logistic operands over the same data.
    cid, _, eb, _, _ = next(b for b in bucket_routes(wide["datasets"])
                            if b[0] == "per-movie" and b[4] == "gram")
    wide_newton_check(torch, "wide-linear", cid, eb,
                      l2_weight(wide["est"], cid))
    launches = fit["row"]["segment_launches_by_site"]
    # The entry reports the site whose launches took the most device
    # time in the fit.
    by_site = {}
    for r in timing:
        by_site.setdefault(r["site"], []).append(r)
    top = max((r for r in timing if r["site"] in FIT_SITES),
              key=lambda r: launches.get(r["site"], 0) * r["ms"]
              / len(by_site[r["site"]]))
    arrays = wide["arrays"]
    del wide, fit
    empty_cache()
    ell = phase_ell_routes(torch, arrays)
    del arrays
    empty_cache()
    logistic = phase_wide_logistic(torch)
    ell.update(phase_ell_routes_small(torch, logistic.pop("arrays")))
    return {
        "name": "segment_sum",
        "route": "cuda",
        "source": sr.SOURCE,
        "replaces": SEGMENT_REPLACES,
        "launches": sum(launches.values()),
        "launches_by_path": {"wide_fit": sum(launches.values()),
                             "ell_routes": ell["segment_launches"]
                             + ell["segment_launches_small"]},
        "ell_routes_newton_launches": ell["newton_launches"],
        "max_abs_err": worst,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "site": top["site"],
        "shape": top["shape"],
    }


# ---------------------------------------------------------------------------
# phase 25: the mesh, two ranks on the one card (gloo)
# ---------------------------------------------------------------------------

# Ranks of phase 25's process group. The machine has one card, so both
# ranks share it and the group runs gloo (NCCL refuses two ranks on one
# device); the NCCL route waits for a machine with more than one card.
MESH_RANKS = 2
# Seconds phase 25 waits for a group of ranks; a collective fails after
# MESH_TIMEOUT_S, so a rank that dies ends the others' waits.
MESH_LIMIT_S, MESH_TIMEOUT_S = 600, 300
# The mesh fit against the single-process fit, f32: the sums cross the
# ranks in another order, so the two f32 solves stop apart by at most
# the bounds of an f32 solve against float64 (ROADMAP Queue C's split,
# FUSED_FE_ATOL / FUSED_RE_ATOL); an entity past them passes only where
# both fits stopped on its objective (``mesh_gaps``, as ``entity_gaps``).
MESH_FE_ATOL, MESH_RE_ATOL = FUSED_FE_ATOL, FUSED_RE_ATOL
# The mesh cli.train against 14a's single-process run: reported against
# the reference's f32 CLI tolerance (tests/test_estimator_mesh.py:
# 399-425, a 203-row linear fit), gated at twice Queue C's f32 split
# (MESH_CLI_FE_ATOL, MESH_CLI_RE_ATOL: two f32 logistic fits, each
# within the split of float64, whose sums differ in order; the bounds
# tests/test_torch_train_cli.py holds two f32 CLI fits to). The CPU
# rehearsal at 8,192 rows read 7.3e-4 on the fixed effect, past the
# former. The mesh cli.score against 14a's cli.score of the same model.
MESH_CLI_RTOL, MESH_CLI_ATOL, MESH_SCORE_ATOL = 1e-4, 2e-5, 1e-5
MESH_CLI_FE_ATOL, MESH_CLI_RE_ATOL = 2 * FUSED_FE_ATOL, 2 * FUSED_RE_ATOL


def mesh_root() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "smoke", "mesh")


def save_single_fit(path: str, res, datasets) -> str:
    """The single-process unfused fit that phase 25 (a) holds the mesh
    fit against: its coefficients, each random effect's projectors and
    each entity's last convergence code, as an ``.npz``."""
    out = {"global": res.model["global"].model.coefficients.means.cpu(
        ).numpy()}
    for cid in RE_IDS:
        m = res.model[cid]
        out[cid] = m.coefficients.cpu().numpy()
        out[f"{cid}/proj_all"] = np.asarray(m.proj_all)
        out[f"{cid}/reasons"] = reasons_by_code(res, datasets[cid], cid,
                                                False)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **out)
    return path


def single_fit_npz(torch) -> str:
    """``--mesh``: phase ``fit``'s unfused fit alone, saved for (a)."""
    arrays = synth_arrays()
    data = train_dataset(arrays)
    est = build_estimator()
    with unfused(est):
        res = est.fit(data)[0]
    datasets, _ = est.prepare(data)
    path = save_single_fit(os.path.join(mesh_root(), "single.npz"), res,
                           datasets)
    del arrays, data, est, datasets, res
    empty_cache()
    return path


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_ranks(what: str, root: str, **spec) -> list:
    """``mesh_rank(what)`` in MESH_RANKS processes of one gloo group on
    this card (``chip_smoke.py --cli-child``, each with the variables
    ``torchrun --standalone --nproc-per-node 2`` exports); every rank's
    result, in rank order. A rank that exits non-zero, or a group past
    MESH_LIMIT_S (every rank killed), fails the run."""
    port = _free_port()
    ranks = []
    for r in range(MESH_RANKS):
        rroot = os.path.join(root, f"rank{r}")
        os.makedirs(rroot, exist_ok=True)
        path = os.path.join(rroot, "child.json")
        out = os.path.join(rroot, "child-result.json")
        with open(path, "w") as f:
            json.dump(dict(spec, kind="mesh_rank", what=what, root=rroot,
                           out=out), f)
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(MESH_RANKS),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(MESH_RANKS),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PHOTON_DIST_TIMEOUT_SECONDS=str(MESH_TIMEOUT_S))
        log = open(os.path.join(rroot, "child.log"), "w")
        ranks.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cli-child", path],
            stdout=log, stderr=subprocess.STDOUT, env=env, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__))), log, rroot, out))
    deadline = time.perf_counter() + MESH_LIMIT_S
    try:
        for proc, _, _, _ in ranks:
            proc.wait(timeout=max(deadline - time.perf_counter(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log, _, _ in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    results = []
    for r, (proc, _, rroot, out) in enumerate(ranks):
        if proc.returncode != 0 or not os.path.exists(out):
            with open(os.path.join(rroot, "child.log")) as f:
                fail(f"mesh {what}: rank {r} exited {proc.returncode}: "
                     f"{f.read()[-3000:]}")
        with open(out) as f:
            results.append(json.load(f))
    return results


def mesh_rank(torch, spec: dict) -> dict:
    """A ``--cli-child`` spec of kind ``mesh_rank``: one rank of phase
    25's group, (a) the fit (``mesh_fit_rank``) or (b) a CLI run in this
    process (``cli.train`` or ``cli.score``: ``spec["argv"]``), the
    kernels' counts zeroed just before it and read just after."""
    if spec["what"] == "fit":
        return mesh_fit_rank(torch, spec)
    from photon_tpu_torch.cli import score as score_cli
    from photon_tpu_torch.cli import train as train_cli
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.ops import segment_reduce as sr
    from photon_tpu_torch.ops import serve_kernel

    main = train_cli.main if spec["what"] == "train" else score_cli.main
    nk.launches = serve_kernel.launches = 0
    sr.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(spec["argv"])
    torch.cuda.synchronize()
    lines = buf.getvalue().strip().splitlines()
    from photon_tpu_torch.parallel import mesh as mesh_mod

    stats = mesh_mod.group_stats()
    return {"rank": int(os.environ["RANK"]), "rc": rc,
            "census": compact_census(stats.census),
            "collectives_by_site": stats.snapshot()["by_site"],
            "wall_seconds": time.perf_counter() - t0,
            "newton_launches": nk.launches,
            "serve_launches": serve_kernel.launches,
            "segment_launches_by_site": dict(sr.launches_by_site),
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "line": json.loads(lines[-1]) if lines else None}


def mesh_gaps(torch, est, datasets, data, res, single) -> dict:
    """This rank's share of (a)'s model check: the fixed effect's
    largest difference to the single-process fit, and per random effect
    the entities of this rank's buckets more than MESH_RE_ATOL apart;
    such an entity passes only where both fits stopped on its objective
    (FUNCTION_VALUES_CONVERGED or OBJECTIVE_NOT_IMPROVING) and the two
    models' float64 objectives on its rows (logistic loss at each
    model's own total scores, plus its L2 term) agree within ROUND_OFF
    of 1 + |objective|, as ``entity_gaps`` judges. The scores come
    from every row on this rank (no collective)."""
    from photon_tpu_torch.data.random_effect import EntityBlocks
    from photon_tpu_torch.optim import ConvergenceReason
    from photon_tpu_torch.transformers import make_submodel_scorer

    flat = (int(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
            int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING))
    dev = data.device
    weights = {"mesh": {"global": res.model["global"].model.coefficients
                        .means},
               "single": {"global": torch.from_numpy(single["global"]).to(
                   dev)}}
    for cid in RE_IDS:
        if not np.array_equal(np.asarray(res.model[cid].proj_all),
                              single[f"{cid}/proj_all"]):
            fail(f"mesh_fit: {cid}'s projectors differ from the single "
                 "process's")
        weights["mesh"][cid] = res.model[cid].coefficients
        weights["single"][cid] = torch.from_numpy(single[cid]).to(dev)
    parts = {}
    for name, ws in weights.items():
        parts[name] = {}
        for cid, m in res.model.items():
            if cid == "global":
                m = dataclasses.replace(m, model=dataclasses.replace(
                    m.model, coefficients=dataclasses.replace(
                        m.model.coefficients, means=ws[cid])))
            else:
                m = dataclasses.replace(m, coefficients=ws[cid])
            parts[name][cid] = make_submodel_scorer(m, data)(m).double()
    totals = {name: sum(p.values()) for name, p in parts.items()}
    fe = float((weights["mesh"]["global"].double()
                - weights["single"]["global"].double()).abs().max())
    out = {"global_max_coefficient_diff": fe}
    for cid in RE_IDS:
        ds = datasets[cid]
        n = ds.num_entities
        wm = weights["mesh"][cid].double()
        ws = weights["single"][cid].double()
        diff = (wm - ws).abs().amax(dim=1)
        beyond = diff > MESH_RE_ATOL
        codes = {"mesh": reasons_by_code(res, ds, cid, False),
                 "single": single[f"{cid}/reasons"]}
        l2 = l2_weight(est, cid)
        row = {"entities": n, "max_coefficient_diff": float(diff.max()),
               "entities_beyond_here": 0, "failing_here": 0,
               "objective_rel_gap_max": None}
        for b in ds.device_blocks():
            eb = b if isinstance(b, EntityBlocks) else b.materialize(None)
            ec = eb.entity_codes.long()
            sel = (ec < n) & beyond[ec.clamp(max=n - 1)]
            if not bool(sel.any()):
                continue
            sub = entity_subset(eb, sel)
            x = dense_x(torch, sub)
            ind = (sub.labels > 0.5).double()
            objs = []
            for name, w_all in (("mesh", wm), ("single", ws)):
                w = w_all[sub.entity_codes.long()][:, :x.shape[-1]]
                z = (torch.einsum("brs,bs->br", x, w)
                     + coordinate_offsets(
                         sub, totals[name] - parts[name][cid]))
                loss = (torch.log1p(torch.exp(-z.abs())) + z.clamp(min=0.0)
                        - z * ind)
                objs.append((sub.weights.double() * loss).sum(dim=1)
                            + 0.5 * l2 * (sub.penalty_mask.double()
                                          * w * w).sum(dim=1))
            gaps = ((objs[0] - objs[1]).abs()
                    / (1.0 + objs[1].abs())).cpu().numpy()
            got = sub.entity_codes.long().cpu().numpy()
            ok = (np.isin(codes["mesh"][got], flat)
                  & np.isin(codes["single"][got], flat)
                  & (gaps <= ROUND_OFF))
            row["entities_beyond_here"] += int(got.size)
            row["failing_here"] += int((~ok).sum())
            row["objective_rel_gap_max"] = max(
                row["objective_rel_gap_max"] or 0.0, float(gaps.max()))
        out[cid] = row
    return out


def mesh_fit_rank(torch, spec: dict) -> dict:
    """One rank of (a): the arrays generated from the seed, the
    estimator on the group's mesh (``mesh="auto"``), prepared (this
    rank's shares checked) and fitted twice, the counts zeroed before
    each fit and read after it; the model saved for the parent, and
    ``mesh_gaps`` against the single-process fit."""
    from photon_tpu_torch.algorithm import fused_fit as ff
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.init_from_env("cuda")
    try:
        t0 = time.perf_counter()
        arrays = synth_arrays()
        gen_s = time.perf_counter() - t0
        data = train_dataset(arrays)
        n = int(arrays["y"].shape[0])
        del arrays
        est = build_estimator()
        datasets, plan_row = timed_prepare(torch, est, data)
        em = est.resolve_mesh()
        fe = datasets["global"]
        shares = {"global": [fe.num_samples, fe.logical_rows]}
        for cid in RE_IDS:
            ds = datasets[cid]
            shares[cid] = [[b.num_entities, len(c)]
                           for b, c in zip(ds.blocks, ds.block_codes_np)]
        coords = est._build_coordinates(datasets, {}, {})
        reasons = ff.fuse_ineligibility_reasons(coords, mesh=em,
                                                emitter=est.emitter)
        fits, models, census = [], [], []
        for k in range(2):
            c0 = em.stats.snapshot()
            at = len(em.stats.census)
            nk.launches = 0
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = est.fit(data)[0]
            torch.cuda.synchronize()
            c1 = em.stats.snapshot()
            fits.append({"fit": k, "fit_seconds": time.perf_counter() - t0,
                         "newton_launches": nk.launches,
                         "collectives": c1["count"] - c0["count"],
                         "collective_seconds": c1["seconds"] - c0["seconds"],
                         "collective_bytes": c1["bytes"] - c0["bytes"],
                         "collectives_by_site": mesh_mod.site_delta(c0, c1),
                         "peak_device_bytes":
                             torch.cuda.max_memory_allocated(),
                         "fused": est._fused_cache is not None})
            census.append(compact_census(em.stats.census[at:]))
            models.append({cid: (m.model.coefficients.means
                                 if cid == "global" else m.coefficients)
                           for cid, m in res.model.items()})
        repeat = all(torch.equal(models[0][c], models[1][c])
                     for c in models[0])
        np.savez(os.path.join(spec["root"], "model.npz"),
                 **{c: t.cpu().numpy() for c, t in models[1].items()})
        gaps = mesh_gaps(torch, est, datasets, data, res,
                         np.load(spec["single"]))
        del est, datasets, data, res, models, coords
        empty_cache()
        column = column_rank(torch, spec, mesh)
        return {"rank": mesh.rank, "size": mesh.size,
                "backend": mesh.backend, "rows": n,
                "generate_seconds": gen_s,
                "prepare_seconds": plan_row["seconds"], "shares": shares,
                "fuse_reasons": reasons, "fits": fits, "census": census,
                "repeat_bit_identical": repeat, "gaps": gaps,
                "model": os.path.join(spec["root"], "model.npz"),
                "column": column}
    finally:
        mesh_mod.shutdown()


def phase_mesh_fit(torch, single: str, column_single: str) -> dict:
    """Phase 25 (a): phase ``fit``'s full-width logistic fit (4,000,000
    rows, f32, caps 512 / 2048, 4 CD iterations) by
    ``GameEstimator(mesh="auto")`` in MESH_RANKS ranks on this card
    (gloo), each generating the arrays from the seed, fitted twice.
    Gates: each rank holds ceil(rows / ranks) fixed-effect rows and its
    share of every bucket's padded entities; the fit unfused with the
    reference's reason; Newton-kernel launches in each rank (the
    wrapper's count: an unfused fit replays no graph); the two fits
    bit-identical in each rank and rank 1's model rank 0's bit for bit;
    the model within MESH_FE_ATOL / MESH_RE_ATOL of the single-process
    unfused fit (``single``, the ``.npz`` ``save_single_fit`` wrote), an
    entity past them only where both fits stopped on its objective.
    Every rank's census of each fit equal to rank 0's and fully declared
    (``census_gate``). Then 25 (c) in the same ranks
    (``phase_mesh_column``)."""
    t0 = time.perf_counter()
    ranks = mesh_ranks("fit", os.path.join(mesh_root(), "fit"),
                       single=single, column_single=column_single)
    wall = time.perf_counter() - t0
    for r in ranks:
        emit({"phase": "mesh_fit", "rank": r["rank"],
              "backend": r["backend"], "generate_seconds":
                  r["generate_seconds"],
              "prepare_seconds": r["prepare_seconds"],
              "shares": r["shares"], "fits": r["fits"],
              "repeat_bit_identical": r["repeat_bit_identical"],
              "gaps": r["gaps"]})
    for k in range(2):
        census_gate("mesh_fit", f"fit {k}", [r["census"][k] for r in ranks])
    models = [np.load(r["model"]) for r in ranks]
    across = all(np.array_equal(models[0][c], m[c])
                 for m in models[1:] for c in models[0].files)
    gaps = ranks[0]["gaps"]
    failing = {cid: sum(r["gaps"][cid]["failing_here"] for r in ranks)
               for cid in RE_IDS}
    beyond = {cid: sum(r["gaps"][cid]["entities_beyond_here"]
                       for r in ranks) for cid in RE_IDS}
    row = {"phase": "mesh_fit", "ranks": len(ranks),
           "backend": ranks[0]["backend"], "wall_seconds": wall,
           "fit_seconds": [[f["fit_seconds"] for f in r["fits"]]
                           for r in ranks],
           "prepare_seconds": [r["prepare_seconds"] for r in ranks],
           "collectives_per_fit": [r["fits"][-1]["collectives"]
                                   for r in ranks],
           "collective_seconds_per_fit": [
               r["fits"][-1]["collective_seconds"] for r in ranks],
           "collectives_by_site_per_fit": [
               r["fits"][-1]["collectives_by_site"] for r in ranks],
           "peak_device_bytes": [max(f["peak_device_bytes"]
                                     for f in r["fits"]) for r in ranks],
           "newton_launches": [[f["newton_launches"] for f in r["fits"]]
                               for r in ranks],
           "ranks_bit_identical": across,
           "global_max_coefficient_diff":
               gaps["global_max_coefficient_diff"],
           "re_max_coefficient_diff": {
               cid: gaps[cid]["max_coefficient_diff"] for cid in RE_IDS},
           "re_entities_beyond": beyond, "re_failing": failing,
           "bounds": [MESH_FE_ATOL, MESH_RE_ATOL]}
    emit(row)
    for r in ranks:
        n = r["rows"]
        fe_rows, logical = r["shares"]["global"]
        if fe_rows != -(-n // MESH_RANKS) or logical != n:
            fail(f"mesh_fit: rank {r['rank']} holds {fe_rows} of {logical} "
                 f"fixed-effect rows")
        for cid in RE_IDS:
            if any(b * MESH_RANKS != padded
                   for b, padded in r["shares"][cid]):
                fail(f"mesh_fit: rank {r['rank']}'s {cid} shares "
                     f"{r['shares'][cid]}")
        if r["backend"] != "gloo" or r["size"] != MESH_RANKS:
            fail(f"mesh_fit: rank {r['rank']} on {r['backend']} of "
                 f"{r['size']}")
        if (not r["fuse_reasons"]
                or not r["fuse_reasons"][0].startswith("mesh execution")
                or any(f["fused"] for f in r["fits"])):
            fail(f"mesh_fit: rank {r['rank']} fused: {r['fuse_reasons']}")
        if not all(f["newton_launches"] > 0 and f["collectives"] > 0
                   for f in r["fits"]):
            fail(f"mesh_fit: rank {r['rank']}'s fits {r['fits']}")
        if not r["repeat_bit_identical"]:
            fail(f"mesh_fit: rank {r['rank']}'s two fits differ")
    if not across:
        fail("mesh_fit: the ranks' models differ")
    if not gaps["global_max_coefficient_diff"] <= MESH_FE_ATOL:
        fail(f"mesh_fit: the fixed effect is "
             f"{gaps['global_max_coefficient_diff']} from the single "
             "process's")
    if any(failing.values()):
        fail(f"mesh_fit: entities past {MESH_RE_ATOL} without an objective "
             f"stop in both fits: {failing}")
    return {"newton_launches": sum(f["newton_launches"] for r in ranks
                                   for f in r["fits"]),
            "column": phase_mesh_column(torch, [r["column"] for r in ranks],
                                        np.load(column_single))}


def compact_census(census) -> list:
    """A census (``CollectiveStats.census``) as ``[op, site, dtype,
    shape]`` lists, the fields the ranks must agree on."""
    return [[c["op"], c["site"], c["dtype"], c["shape"]] for c in census]


def census_gate(phase: str, what: str, censuses: list) -> dict:
    """Every rank's census equal to rank 0's, position by position, and
    every site one that ``parallel.mesh.SPMD_AUDIT`` declares (the SPMD
    tier's collective-order, trace-divergence and implicit-reshard
    rules, on the card's ranks)."""
    from photon_tpu_torch.parallel.mesh import SPMD_AUDIT

    declared = set(SPMD_AUDIT["ordered_collectives"])
    sites = {}
    for c in censuses[0]:
        sites[c[1]] = sites.get(c[1], 0) + 1
    row = {"phase": f"{phase}_census", "what": what,
           "collectives": [len(c) for c in censuses], "sites": sites,
           "undeclared": sorted(set(sites) - declared)}
    for r, c in enumerate(censuses[1:], 1):
        if c != censuses[0]:
            at = next((i for i, (a, b) in enumerate(zip(censuses[0], c))
                       if a != b), min(len(c), len(censuses[0])))
            row["divergent_rank"], row["divergent_position"] = r, at
            break
    emit(row)
    if not censuses[0] or "divergent_rank" in row or row["undeclared"]:
        fail(f"{phase}: the ranks' censuses of {what}: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 25 (c): the column-sharded fixed effect at the reference's d = 10^7
# ---------------------------------------------------------------------------

# The JAX package's wide fixed effect (bench.py run_wide_d): 10^7
# features drawn as d * u^2.2 (a power law: ~73% of the entries below
# d / 2), 100,000 rows of 20, weights planted on the first 100,000 ids,
# logistic, L2 1.0, f32; the libsvm reader's intercept appended as the
# last feature, as that run reads it (so the last rank owns it).
COLUMN_D, COLUMN_ROWS, COLUMN_K = 10_000_000, 100_000, 20
COLUMN_PLANTED, COLUMN_SEED, COLUMN_L2 = 100_000, 7, 1.0
# The column route against the replicated one. Two f32 L-BFGS solves of
# this problem do not stay within Queue C's f32 fixed-effect split
# (5e-4): the rounding of their sums, taken in another order, grows
# about 10^5 times in 20 iterations (CPU, 10^6 features: the two routes
# 1.8e-11 apart in float64 after 20 iterations, 0.20 apart in f32, the
# replicated f32 solve 1.3e-3 from its float64 twin), and a whole fit
# stops where rounding puts it (the stop threshold, 6.9e-3, is about 3x
# the objective's own f32 rounding): the H100 read 5.4e-2 between the
# two routes' whole fits, their float64 objectives 1.2e-5 apart. So the
# routes are held against each other where no solve intervenes: the
# column route's margins, objective and gradient at the replicated
# fit's coefficients, on every rank, against a float64 evaluation,
# within ROUND_OFF of 1 + the magnitude of their terms (the replicated
# route's errors printed beside them); each whole fit must stop on a
# convergence rule with its held-in AUC within COLUMN_AUC_ATOL of the
# other's, and their distance is printed.
COLUMN_AUC_ATOL = 1e-4
# 25 (c)'s further solver routes on the same ranks and shards: (i) an
# elastic net by OWL-QN (lambda, alpha: L1 and L2 both 1.0), (ii)
# L-BFGS-B with the scalar bounds +-COLUMN_BOX (the reference's column
# route takes scalar bounds; many coefficients bind), (iii) FULL
# variances at COLUMN_FULL_D + 1 features of the same generator and
# rows. Each route's column fits against the replicated f32 fit of the
# same route in the parent: the route check at the replicated fit's
# coefficients (the pseudo-, projected or plain gradient), the two whole
# fits' float64 objectives within ROUND_OFF of 1 + the replicated one's;
# (iii)'s variances at the replicated fit's coefficients through the
# column route within COLUMN_VAR_ROUTE_RTOL of the replicated route's,
# relative, and the whole column fit's within COLUMN_VAR_RTOL of the
# replicated fit's. The CPU rehearsal (10^6 + 1 features for (i) and
# (ii), 100,000 rows) read 4.7e-7 for the first (two f32 Hessians summed
# in another order, one Cholesky of 1,025) and 1.5e-4 for the second
# (the two f32 solves stop 38 and 39 iterations in, at slightly other
# coefficients); the bounds are about 20 and 13 times those.
COLUMN_ENET = (2.0, 0.5)
COLUMN_BOX = 0.05
COLUMN_FULL_D = 1024
COLUMN_VAR_ROUTE_RTOL = 1e-5
COLUMN_VAR_RTOL = 2e-3
COLUMN_ROUTES = ("enet", "box", "full")


def column_arrays(d: int = COLUMN_D) -> dict:
    """25 (c)'s arrays from COLUMN_SEED (bench.py run_wide_d's draws) over
    ``d`` features, the intercept column at index ``d``."""
    rng = np.random.default_rng(COLUMN_SEED)
    rows, k = COLUMN_ROWS, COLUMN_K
    idx = np.minimum((d * rng.uniform(size=(rows, k)) ** 2.2).astype(
        np.int64), d - 1)
    val = rng.normal(size=(rows, k)).astype(np.float32)
    w_true = (rng.normal(size=COLUMN_PLANTED) * 0.5).astype(np.float32)
    planted = np.where(idx < COLUMN_PLANTED,
                       w_true[np.minimum(idx, COLUMN_PLANTED - 1)], 0.0)
    z = (val * planted).sum(axis=1)
    y = (rng.uniform(size=rows) < 1.0 / (1.0 + np.exp(-z))).astype(
        np.float32)
    idx = np.concatenate([idx.astype(np.int32),
                          np.full((rows, 1), d, np.int32)], axis=1)
    val = np.concatenate([val, np.ones((rows, 1), np.float32)], axis=1)
    return {"idx": idx, "val": val, "y": y}


def column_dataset(arrays, device="cuda", d: int = COLUMN_D):
    import torch

    from photon_tpu_torch.data.dataset import SparseFeatures
    from photon_tpu_torch.data.game_data import make_game_dataset

    return make_game_dataset(
        arrays["y"], {"features": SparseFeatures(
            arrays["idx"], arrays["val"], d + 1)},
        dtype=torch.float32, device=device)


def column_estimator(device="cuda", route: str = "lbfgs",
                     d: int = COLUMN_D):
    """The fixed effect alone, ``feature_sharding: auto`` (column on a
    mesh above 200,000 features, replicated without one; ``column`` for
    route ``full``, whose width is below that), a no-op listener so
    that the single process also fits on the unfused loop. Routes:
    ``lbfgs`` (L2 COLUMN_L2, the intercept exempt), ``enet`` (OWL-QN,
    COLUMN_ENET), ``box`` (L-BFGS-B, +-COLUMN_BOX), ``full`` (L2, FULL
    variances)."""
    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm.problems import (
        GLMOptimizationConfiguration,
        VarianceComputationType,
    )
    from photon_tpu_torch.estimators.game_estimator import (
        FixedEffectCoordinateConfiguration,
        GameEstimator,
    )
    from photon_tpu_torch.types import TaskType

    l2 = optim.RegularizationContext(optim.RegularizationType.L2)
    kw = {"regularization": l2, "regularization_weight": COLUMN_L2}
    if route == "enet":
        kw = {"regularization": optim.RegularizationContext(
            optim.RegularizationType.ELASTIC_NET, COLUMN_ENET[1]),
            "regularization_weight": COLUMN_ENET[0]}
    elif route == "box":
        kw["optimizer"] = optim.OptimizerConfig(
            box_constraints=(-COLUMN_BOX, COLUMN_BOX))
    elif route == "full":
        kw["variance_computation"] = VarianceComputationType.FULL
    opt = GLMOptimizationConfiguration(**kw)
    sharding = "column" if route == "full" else "auto"
    return GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"global": FixedEffectCoordinateConfiguration(
            "features", opt, feature_sharding=sharding)},
        num_iterations=1, intercept_indices={"features": d},
        mesh="auto", device=device, listeners=[lambda e: None])


def column_fit(torch, est, data) -> tuple[dict, object]:
    """One fit with the counts zeroed just before it and read after."""
    from photon_tpu_torch.ops import segment_reduce as sr
    from photon_tpu_torch.optim import lbfgs

    sr.reset_counts()
    lbfgs.host_syncs = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = est.fit(data)[0]
    torch.cuda.synchronize()
    hist = res.descent.history
    return {"fit_seconds": time.perf_counter() - t0,
            "lbfgs_iterations": [int(r.diagnostics.iterations)
                                 for r in hist],
            "convergence_reason": int(hist[-1].diagnostics
                                      .convergence_reason),
            "lbfgs_host_syncs": lbfgs.host_syncs,
            "fixed_effect_launches": sr.launches_by_site.get(
                "fixed_effect", 0),
            "peak_device_bytes": torch.cuda.max_memory_allocated()}, res


def column_single_npz(torch) -> str:
    """25 (c)'s replicated fits in this process (no process group:
    ``auto`` stays replicated), saved for the ranks' comparison: the
    L-BFGS fit of its arrays (the coefficients, the held-in AUC and the
    stop reason), then each further route's (``column_route_single``)."""
    from photon_tpu_torch.evaluation import evaluators

    t0 = time.perf_counter()
    arrays = column_arrays()
    gen_s = time.perf_counter() - t0
    data = column_dataset(arrays)
    est = column_estimator()
    row, res = column_fit(torch, est, data)
    means = res.model["global"].model.coefficients.means
    scores = data.feature_shards["features"].matvec(means)
    auc = float(evaluators.auc_roc(scores, data.labels))
    emit({"phase": "mesh_column_single", "generate_seconds": gen_s,
          "features": COLUMN_D + 1, "rows": COLUMN_ROWS, "auc": auc, **row})
    out = {"means": means.cpu().numpy(), "auc": auc,
           "reason": row["convergence_reason"]}
    del est, res, scores
    for route in ("enet", "box"):
        out.update(column_route_single(torch, route, data))
    del arrays, data
    empty_cache()
    small = column_dataset(column_arrays(COLUMN_FULL_D), d=COLUMN_FULL_D)
    out.update(column_route_single(torch, "full", small))
    del small
    path = os.path.join(mesh_root(), "column_single.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **out)
    empty_cache()
    return path


def column_route_single(torch, route: str, data) -> dict:
    """One further route's replicated f32 fit (``column_estimator``'s
    ``route``) on ``data``: its coefficients, stop reason, float64
    objective, count of nonzeros and (FULL) variances, keyed
    ``<route>_<field>``."""
    d = data.feature_shards["features"].num_features - 1
    est = column_estimator(route=route, d=d)
    row, res = column_fit(torch, est, data)
    coefs = res.model["global"].model.coefficients
    obj = column_objective(torch, data, coefs.means, route=route, d=d)
    nnz = int((coefs.means != 0).sum())
    emit({"phase": "mesh_column_single", "route": route, "features": d + 1,
          "rows": COLUMN_ROWS, "objective_float64": obj, "nnz": nnz, **row})
    out = {f"{route}_means": coefs.means.cpu().numpy(),
           f"{route}_reason": row["convergence_reason"],
           f"{route}_objective": obj, f"{route}_nnz": nnz}
    if coefs.variances is not None:
        out[f"{route}_variances"] = coefs.variances.cpu().numpy()
    del est, res
    return out


def column_l1(route: str) -> float:
    """A route's L1 weight: the elastic net's share of its lambda."""
    lam, alpha = COLUMN_ENET
    return lam * alpha if route == "enet" else 0.0


def column_l2(route: str) -> float:
    lam, alpha = COLUMN_ENET
    return lam * (1.0 - alpha) if route == "enet" else COLUMN_L2


def column_objective(torch, data, w, *, route: str = "lbfgs",
                     d: int = COLUMN_D) -> float:
    """``route``'s objective of a whole ``[d + 1]`` model on every row in
    float64: the logistic loss plus the L2 term (intercept exempt) and,
    for ``enet``, the L1 term (every coefficient, as OWL-QN's)."""
    feats = data.feature_shards["features"]
    l1, l2 = column_l1(route), column_l2(route)
    w = w.double()
    z = (feats.values.double() * w[feats.indices.long()]).sum(1)
    y = data.labels.double()
    loss = (torch.nn.functional.softplus(z) - y * z).sum()
    wm = w.clone()
    wm.narrow(0, d, 1).zero_()
    return float(loss + 0.5 * l2 * (wm * wm).sum() + l1 * w.abs().sum())


def column_route_check(torch, data, fs, w, *, route: str = "lbfgs",
                       d: int = COLUMN_D) -> dict:
    """Both routes' margins, objective and gradient (the solver's own
    ``fun``: the GLM objective with L2, the intercept exempt, plus
    OWL-QN's L1 term for ``enet``) at the whole model ``w``, this rank's
    slice of the column route's and the replicated route's, each against
    a float64 evaluation by plain PyTorch: the error of each over
    ROUND_OFF of 1 + the magnitude of its terms (a margin's sum of |x w|,
    a gradient entry's sum of |x c|, the objective itself). The gradient
    held is the one the route's solver reads: OWL-QN's pseudo-gradient
    for ``enet``, L-BFGS-B's projected gradient P(w - g) - w for
    ``box``."""
    from photon_tpu_torch import optim
    from photon_tpu_torch.data.dataset import GLMBatch
    from photon_tpu_torch.ops import glm as glm_ops
    from photon_tpu_torch.ops import losses as losses_mod
    from photon_tpu_torch.optim.base import across_shards_later
    from photon_tpu_torch.optim.owlqn import _pseudo_gradient
    from photon_tpu_torch.types import TaskType

    l1, l2 = column_l1(route), column_l2(route)
    loss = losses_mod.get_loss(TaskType.LOGISTIC_REGRESSION)
    whole = data.shard_batch("features")
    col = GLMBatch(fs, data.labels, data.offsets, data.weights)
    w = w.to(data.labels.device, torch.float32)
    feats = whole.features
    idx = feats.indices.long()
    x = feats.values.double()
    w64 = w.double()
    z64 = (x * w64[idx]).sum(1)
    zmag = (x * w64[idx]).abs().sum(1)
    y = data.labels.double()
    c = torch.sigmoid(z64) - y
    wm = w64.clone()
    wm.narrow(0, d, 1).zero_()
    f64 = float((torch.nn.functional.softplus(z64) - y * z64).sum()
                + 0.5 * l2 * (wm * wm).sum() + l1 * w64.abs().sum())
    g64 = torch.zeros(feats.d, dtype=torch.float64,
                      device=w.device).index_add_(
        0, idx.reshape(-1), (x * c[:, None]).reshape(-1)) + l2 * wm
    gmag = torch.zeros(feats.d, dtype=torch.float64,
                       device=w.device).index_add_(
        0, idx.reshape(-1), (x.abs() * c.abs()[:, None]).reshape(-1))
    rep_fun = optim.with_l2(glm_ops.make_value_and_grad(whole, loss), l2, d)
    col_fun = optim.with_l2(glm_ops.make_value_and_grad(col, loss), l2,
                            fs.local_index(d))
    f_rep, g_rep = rep_fun(w)
    f_rep = f_rep + l1 * w.abs().sum()
    w_loc = fs.local_slice(w)
    with optim.sharded_over(fs.mesh):
        pen = across_shards_later(torch.sum(l1 * torch.abs(w_loc)))
        f_col, g_col = col_fun(w_loc)
        f_col = f_col + pen()
    z_col, z_rep = fs.matvec(w), feats.matvec(w)

    def solver_gradient(wv, g):
        if route == "enet":
            return _pseudo_gradient(wv, g, l1)
        if route == "box":
            return torch.clamp(wv - g, -COLUMN_BOX, COLUMN_BOX) - wv
        return g

    g_ref = solver_gradient(fs.local_slice(w64), fs.local_slice(g64))
    g_bound = 1.0 + fs.local_slice(gmag)

    def over(err, bound):
        return float((err / (ROUND_OFF * bound)).max())

    return {
        "column": {
            "margin": over((z_col.double() - z64).abs(), 1.0 + zmag),
            "objective": abs(float(f_col) - f64) / (
                ROUND_OFF * (1.0 + abs(f64))),
            "gradient": over((solver_gradient(w_loc, g_col).double()
                              - g_ref).abs(), g_bound)},
        "replicated": {
            "margin": over((z_rep.double() - z64).abs(), 1.0 + zmag),
            "objective": abs(float(f_rep) - f64) / (
                ROUND_OFF * (1.0 + abs(f64))),
            "gradient": over((solver_gradient(
                w_loc, fs.local_slice(g_rep)).double() - g_ref).abs(),
                g_bound)}}


def column_rank(torch, spec: dict, mesh) -> dict:
    """One rank of 25 (c), after (a)'s fits in the same group: the
    arrays from the seed, ``column_estimator`` on the mesh (column:
    this rank's feature range), prepared and fitted twice, the counts
    zeroed before each fit and read after it; each fit's census; the
    held-in AUC by the column ``matvec``; the rank's local ``rmatvec``
    at the ``fixed_effect`` site held against its plain version and
    timed (``fixed_effect_site``); both routes at the replicated fit's
    coefficients against float64 (``column_route_check``); the float64
    objectives of both routes' models; the model saved for the
    parent."""
    from photon_tpu_torch.evaluation import evaluators
    from photon_tpu_torch.parallel.mesh import (
        FeatureShardedSparse,
        site_delta,
    )

    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    arrays = column_arrays()
    gen_s = time.perf_counter() - t0
    data = column_dataset(arrays)
    del arrays
    est = column_estimator()
    t0 = time.perf_counter()
    datasets, _ = est.prepare(data)
    prepare_s = time.perf_counter() - t0
    fs = datasets["global"].features
    if not isinstance(fs, FeatureShardedSparse):
        fail(f"mesh_column: rank {mesh.rank}'s fixed effect is "
             f"{type(fs).__name__}, not column-sharded")
    stats = mesh.stats
    fits, census, models = [], [], []
    for k in range(2):
        c0, at = stats.snapshot(), len(stats.census)
        row, res = column_fit(torch, est, data)
        c1 = stats.snapshot()
        fits.append({"fit": k, **row,
                     "collectives": c1["count"] - c0["count"],
                     "collective_seconds": c1["seconds"] - c0["seconds"],
                     "collective_bytes": c1["bytes"] - c0["bytes"],
                     "collectives_by_site": site_delta(c0, c1)})
        census.append(compact_census(stats.census[at:]))
        models.append(res.model["global"].model.coefficients.means)
    repeat = bool(torch.equal(models[0], models[1]))
    scores = fs.matvec(models[1])
    auc = float(evaluators.auc_roc(scores, data.labels))
    g = data.weights * (torch.sigmoid(scores) - data.labels)
    site = fixed_effect_site(torch, fs.local, g)
    single = torch.from_numpy(np.load(spec["column_single"])["means"]).to(
        models[1].device)
    route = column_route_check(torch, data, fs, single)
    objectives = [column_objective(torch, data, w)
                  for w in (models[1], single)]
    path = os.path.join(spec["root"], "column_model.npy")
    np.save(path, models[1].cpu().numpy())
    out = {"rank": mesh.rank, "d": fs.d, "logical_d": fs.logical_d,
            "d_local": fs.d_local, "lo": fs.lo,
            "nnz": int((fs.local_values != 0).sum()),
            "k_loc": int(fs.local_indices.shape[1]),
            "generate_seconds": gen_s, "prepare_seconds": prepare_s,
            "resident_bytes_before": resident,
            "fits": fits, "census": census, "repeat_bit_identical": repeat,
            "route_check": route,
            "auc": auc, "model": path, "objectives": objectives,
            "site": {k: site[k] for k in (
                "shape", "values", "features", "parts", "segments", "ms",
                "plain_ms", "library_ms", "rmatvec_ms", "bound_ms",
                "bound_by", "max_abs_err")}}
    del est, datasets, models, fs, scores, g
    out["routes"] = {route: column_route_rank(torch, spec, mesh, route, data)
                     for route in ("enet", "box")}
    del data
    empty_cache()
    out["routes"]["full"] = column_route_rank(torch, spec, mesh, "full", None)
    return out


def column_route_rank(torch, spec: dict, mesh, route: str, data) -> dict:
    """One further route of 25 (c) on this rank (``column_estimator``'s
    ``route``; ``data``: 25 (c)'s dataset, or None for ``full``, which
    builds its own at COLUMN_FULL_D + 1 features): prepared, fitted
    twice with the counts zeroed before each fit and read after it, each
    fit's census; the route check at the replicated fit's coefficients
    (``column_route_check``); both fits' float64 objectives; the padded
    slots of the whole model (the solver's gathered ``[d]``), the count
    of nonzeros, the bounds, or the variances; for ``full`` the
    segment-sum kernel at ``fixed_effect`` on this rank's shard, held
    against its plain version and timed."""
    from photon_tpu_torch.parallel.mesh import (
        FeatureShardedSparse,
        site_delta,
    )

    d = COLUMN_D if data is not None else COLUMN_FULL_D
    if data is None:
        data = column_dataset(column_arrays(d), d=d)
    single = np.load(spec["column_single"])
    est = column_estimator(route=route, d=d)
    t0 = time.perf_counter()
    datasets, _ = est.prepare(data)
    prepare_s = time.perf_counter() - t0
    fs = datasets["global"].features
    if not isinstance(fs, FeatureShardedSparse):
        fail(f"mesh_column: rank {mesh.rank}'s {route} fixed effect is "
             f"{type(fs).__name__}, not column-sharded")
    stats = mesh.stats
    fits, census, models, whole, variances = [], [], [], [], []
    for k in range(2):
        c0, at = stats.snapshot(), len(stats.census)
        row, res = column_fit(torch, est, data)
        c1 = stats.snapshot()
        fits.append({"fit": k, **row,
                     "collectives": c1["count"] - c0["count"],
                     "collective_seconds": c1["seconds"] - c0["seconds"],
                     "collective_bytes": c1["bytes"] - c0["bytes"],
                     "collectives_by_site": site_delta(c0, c1)})
        census.append(compact_census(stats.census[at:]))
        coefs = res.model["global"].model.coefficients
        models.append(coefs.means)
        whole.append(res.descent.history[-1].diagnostics.coefficients)
        if coefs.variances is not None:
            variances.append(coefs.variances)
    repeat = bool(torch.equal(models[0], models[1])
                  and torch.equal(whole[0], whole[1])
                  and all(torch.equal(variances[0], v)
                          for v in variances[1:]))
    rep = torch.from_numpy(single[f"{route}_means"]).to(models[1].device)
    out = {"route": route, "d": fs.d, "logical_d": fs.logical_d,
           "d_local": fs.d_local, "lo": fs.lo,
           "nnz_entries": int((fs.local_values != 0).sum()),
           "prepare_seconds": prepare_s, "fits": fits, "census": census,
           "repeat_bit_identical": repeat,
           "route_check": column_route_check(torch, data, fs, rep,
                                             route=route, d=d),
           "objectives": [column_objective(torch, data, models[1],
                                           route=route, d=d),
                          float(single[f"{route}_objective"])],
           "reasons": [fits[-1]["convergence_reason"],
                       int(single[f"{route}_reason"])],
           "padded": whole[1][fs.logical_d:].cpu().numpy().tolist(),
           "nnz": [int((models[1] != 0).sum()),
                   int(single[f"{route}_nnz"])]}
    if route == "box":
        w = models[1]
        out["outside_bounds"] = int(((w < -COLUMN_BOX)
                                     | (w > COLUMN_BOX)).sum())
        out["at_bounds"] = int(((w == -COLUMN_BOX)
                                | (w == COLUMN_BOX)).sum())
    if route == "full":
        want = torch.from_numpy(single["full_variances"]).to(
            models[1].device).double()

        def rel(v):
            return float(((v.double() - want).abs() / want.abs()).max())

        out["variance_max_rel"] = rel(variances[1])
        out["variances_finite"] = bool(torch.isfinite(variances[1]).all())
        out["variance_route_rel"] = rel(column_route_variances(
            torch, data, fs, rep, d)[:d + 1])
        scores = fs.matvec(models[1])
        g = data.weights * (torch.sigmoid(scores) - data.labels)
        site = fixed_effect_site(torch, fs.local, g)
        out["site"] = {k: site[k] for k in (
            "shape", "values", "features", "segments", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "max_abs_err")}
    path = os.path.join(spec["root"], f"column_{route}_model.npz")
    np.savez(path, means=models[1].cpu().numpy(), **(
        {"variances": variances[1].cpu().numpy()} if variances else {}))
    out["model"] = path
    del est, datasets, models, whole, variances, res
    return out


def column_route_variances(torch, data, fs, w, d: int):
    """The column route's FULL variances (this rank's row block of the
    Hessian, gathered; one Cholesky) at the whole model ``w``, gathered
    whole: the variances the replicated route computed at ``w``, through
    the column route."""
    from photon_tpu_torch import optim
    from photon_tpu_torch.algorithm import problems
    from photon_tpu_torch.data.dataset import GLMBatch
    from photon_tpu_torch.ops import losses as losses_mod
    from photon_tpu_torch.ops.normalization import NormalizationContext
    from photon_tpu_torch.types import TaskType

    batch = GLMBatch(fs, data.labels, data.offsets, data.weights)
    coef = fs.local_slice(w.to(data.labels.device, torch.float32))
    with optim.sharded_over(fs.mesh):
        local = problems.variances_in_transformed_space(
            batch, losses_mod.get_loss(TaskType.LOGISTIC_REGRESSION), coef,
            NormalizationContext(),
            problems._l2_diagonal(coef, COLUMN_L2, fs.local_index(d)),
            problems.VarianceComputationType.FULL)
    return fs.gather(local)[0]


def phase_mesh_column_routes(torch, ranks: list) -> dict:
    """25 (c) (i)-(iii) from the ranks' ``column_route_rank`` results.
    Gates, for each route: every rank's census of each fit equal to rank
    0's and declared; both fits bit-identical on every rank and the
    ranks' models equal; segment-sum launches at ``fixed_effect`` in
    every fit; the route check at the replicated fit's coefficients
    within ROUND_OFF on every rank; both whole fits (column and
    replicated) stopped by a stop rule, their float64 objectives within
    ROUND_OFF of 1 + the replicated one's. (i): the padded slots exactly
    0 (its count of nonzeros printed beside the replicated fit's). (ii):
    every coefficient inside +-COLUMN_BOX, some on a bound. (iii): the
    variances finite; at the replicated fit's coefficients within
    COLUMN_VAR_ROUTE_RTOL of the replicated route's, and the whole fit's
    within COLUMN_VAR_RTOL of the replicated fit's."""
    from photon_tpu_torch.optim import ConvergenceReason

    stops = (int(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
             int(ConvergenceReason.GRADIENT_CONVERGED),
             int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING))
    out = {}
    for route in COLUMN_ROUTES:
        rs = [r["routes"][route] for r in ranks]
        for k in range(2):
            census_gate("mesh_column", f"{route} fit {k}",
                        [r["census"][k] for r in rs])
        obj_col, obj_rep = rs[0]["objectives"]
        gap = abs(obj_col - obj_rep) / (1.0 + abs(obj_rep))
        route_worst = max(v for r in rs
                          for v in r["route_check"]["column"].values())
        launches = [f["fixed_effect_launches"] for r in rs
                    for f in r["fits"]]
        row = {"phase": "mesh_column_route", "route": route,
               "ranks": len(rs), "features": rs[0]["logical_d"],
               "rows": COLUMN_ROWS, "d_local": rs[0]["d_local"],
               "nnz_entries": [r["nnz_entries"] for r in rs],
               "iterations": [r["fits"][-1]["lbfgs_iterations"]
                              for r in rs],
               "fit_seconds": [[f["fit_seconds"] for f in r["fits"]]
                               for r in rs],
               "peak_device_bytes": [max(f["peak_device_bytes"]
                                         for f in r["fits"]) for r in rs],
               "collectives_per_fit": [r["fits"][-1]["collectives"]
                                       for r in rs],
               "collective_seconds_per_fit": [
                   r["fits"][-1]["collective_seconds"] for r in rs],
               "collectives_by_site_per_fit": [
                   r["fits"][-1]["collectives_by_site"] for r in rs],
               "fixed_effect_launches": launches,
               "route_check": [r["route_check"] for r in rs],
               "route_check_worst_over_bound": route_worst,
               "repeat_bit_identical": [r["repeat_bit_identical"]
                                        for r in rs],
               "objective_float64": [obj_col, obj_rep],
               "objective_rel_gap": gap,
               "convergence_reasons": rs[0]["reasons"],
               "padded": rs[0]["padded"], "nnz": rs[0]["nnz"],
               "bounds": [ROUND_OFF, COLUMN_VAR_ROUTE_RTOL,
                          COLUMN_VAR_RTOL]}
        for key in ("outside_bounds", "at_bounds", "variance_max_rel",
                    "variance_route_rel", "variances_finite", "site"):
            if key in rs[0]:
                row[key] = ([r[key] for r in rs] if key != "site"
                            else rs[0][key])
        emit(row)
        if not all(r["repeat_bit_identical"] for r in rs):
            fail(f"mesh_column: {route}'s two fits differ on a rank")
        models = [np.load(r["model"]) for r in rs]
        if not all(r["padded"] == rs[0]["padded"] for r in rs) or not all(
                np.array_equal(models[0][f], m[f]) for m in models[1:]
                for f in models[0].files):
            fail(f"mesh_column: {route}'s ranks disagree")
        if not all(n > 0 for n in launches):
            fail(f"mesh_column: {route} launched the segment-sum kernel "
                 "no time at fixed_effect in a fit")
        if not route_worst <= 1.0:
            fail(f"mesh_column: {route}'s route check {row['route_check']}")
        if not all(r in stops for r in rs[0]["reasons"]) or not (
                gap <= ROUND_OFF):
            fail(f"mesh_column: {route} stopped {rs[0]['reasons']}, "
                 f"objectives {obj_col} against {obj_rep}")
        if route == "enet" and any(v != 0.0 for v in rs[0]["padded"]):
            fail(f"mesh_column: enet's padded slots {rs[0]['padded']}")
        if route == "box" and (any(r["outside_bounds"] for r in rs)
                               or not rs[0]["at_bounds"]):
            fail(f"mesh_column: box: {row['outside_bounds']} outside, "
                 f"{row['at_bounds']} on the bounds")
        if route == "full" and not (
                all(r["variances_finite"] for r in rs)
                and max(r["variance_route_rel"] for r in rs)
                <= COLUMN_VAR_ROUTE_RTOL
                and max(r["variance_max_rel"] for r in rs)
                <= COLUMN_VAR_RTOL):
            fail(f"mesh_column: full variances {row['variance_max_rel']} "
                 f"from the replicated fit's, {row['variance_route_rel']} "
                 "at its coefficients")
        out[route] = {"fixed_effect_launches": sum(launches),
                      "fit_seconds": row["fit_seconds"][0],
                      "iterations": row["iterations"][0],
                      "max_abs_err": max(r["site"]["max_abs_err"]
                                         for r in rs) if "site" in rs[0]
                      else 0.0}
    return out


def phase_mesh_column(torch, ranks: list, single) -> dict:
    """Phase 25 (c): the column-sharded fixed effect at the JAX package's
    d = 10^7 configuration in (a)'s ranks (``column_rank``). Gates: each
    rank column-sharded over its own feature range; both ranks' models
    equal bit for bit, and each rank's two fits; on every rank the
    column route's margins, objective and gradient at the replicated
    fit's coefficients within ROUND_OFF of a float64 evaluation
    (``column_route_check``); each whole fit stopped on a convergence
    rule, the column fit's held-in AUC within COLUMN_AUC_ATOL of the
    replicated fit's (``single``); segment-sum launches at
    ``fixed_effect`` in every fit; every rank's census of each fit equal
    to rank 0's and declared.
    Printed: each rank's nnz and slab width, L-BFGS iterations, fit
    seconds, peak memory, collectives by site with seconds and bytes,
    the kernel's device ms and bound on the rank's shard, and the whole
    fits' distance to the replicated fit."""
    from photon_tpu_torch.optim import ConvergenceReason

    stops = (int(ConvergenceReason.FUNCTION_VALUES_CONVERGED),
             int(ConvergenceReason.GRADIENT_CONVERGED),
             int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING))
    models = [np.load(r["model"]) for r in ranks]
    across = all(np.array_equal(models[0], m) for m in models[1:])
    diff = float(np.abs(models[0].astype(np.float64)
                        - single["means"].astype(np.float64)).max())
    obj_col, obj_single = ranks[0]["objectives"]
    route = max(v for r in ranks for v in r["route_check"]["column"].values())
    reasons = [ranks[0]["fits"][-1]["convergence_reason"],
               int(single["reason"])]
    auc_gap = abs(ranks[0]["auc"] - float(single["auc"]))
    for r in ranks:
        emit({"phase": "mesh_column", "rank": r["rank"], "d": r["d"],
              "logical_d": r["logical_d"], "d_local": r["d_local"],
              "lo": r["lo"], "nnz": r["nnz"], "k_loc": r["k_loc"],
              "generate_seconds": r["generate_seconds"],
              "prepare_seconds": r["prepare_seconds"],
              "resident_bytes_before": r["resident_bytes_before"],
              "fits": r["fits"], "route_check": r["route_check"],
              "repeat_bit_identical": r["repeat_bit_identical"],
              "auc": r["auc"], "fixed_effect_site": r["site"]})
    for k in range(2):
        census_gate("mesh_column", f"fit {k}", [r["census"][k] for r in ranks])
    launches = sum(f["fixed_effect_launches"] for r in ranks
                   for f in r["fits"])
    row = {"phase": "mesh_column", "ranks": len(ranks),
           "features": ranks[0]["logical_d"], "rows": COLUMN_ROWS,
           "nnz": [r["nnz"] for r in ranks],
           "k_loc": [r["k_loc"] for r in ranks],
           "nnz_share_rank0": ranks[0]["nnz"] / sum(r["nnz"] for r in ranks),
           "lbfgs_iterations": [r["fits"][-1]["lbfgs_iterations"]
                                for r in ranks],
           "fit_seconds": [[f["fit_seconds"] for f in r["fits"]]
                           for r in ranks],
           "peak_device_bytes": [max(f["peak_device_bytes"]
                                     for f in r["fits"]) for r in ranks],
           "collectives_per_fit": [r["fits"][-1]["collectives"]
                                   for r in ranks],
           "collective_seconds_per_fit": [
               r["fits"][-1]["collective_seconds"] for r in ranks],
           "collectives_by_site_per_fit": [
               r["fits"][-1]["collectives_by_site"] for r in ranks],
           "fixed_effect_launches": launches,
           "ranks_bit_identical": across,
           "route_check_worst_over_bound": route,
           "max_coefficient_diff_vs_replicated": diff,
           "objective_float64": [obj_col, obj_single],
           "objective_rel_gap": abs(obj_col - obj_single) / (
               1.0 + abs(obj_single)),
           "convergence_reasons": reasons,
           "auc": ranks[0]["auc"], "auc_replicated": float(single["auc"]),
           "bounds": [ROUND_OFF, COLUMN_AUC_ATOL]}
    emit(row)
    for r in ranks:
        if not r["repeat_bit_identical"]:
            fail(f"mesh_column: rank {r['rank']}'s two fits differ")
        if not all(f["fixed_effect_launches"] > 0 for f in r["fits"]):
            fail(f"mesh_column: rank {r['rank']} launched the segment-sum "
                 "kernel no time at fixed_effect")
        if r["d_local"] * len(ranks) != r["d"] or r["lo"] != (
                r["rank"] * r["d_local"]):
            fail(f"mesh_column: rank {r['rank']} holds [{r['lo']}, "
                 f"{r['lo'] + r['d_local']}) of {r['d']}")
    if not across:
        fail("mesh_column: the ranks' models differ")
    if not route <= 1.0:
        fail("mesh_column: the column route at the replicated fit's "
             f"coefficients against float64: {[r['route_check'] for r in ranks]}")
    if not all(r in stops for r in reasons) or not auc_gap <= COLUMN_AUC_ATOL:
        fail(f"mesh_column: stop reasons {reasons}, AUC {ranks[0]['auc']} "
             f"against {float(single['auc'])}")
    site = max((r["site"] for r in ranks), key=lambda s: s["values"])
    return {"fixed_effect_launches": launches,
            "site": dict(site, launches=launches, ranks=len(ranks)),
            "routes": phase_mesh_column_routes(torch, ranks)}


def phase_mesh_cli(torch, cli: dict) -> dict:
    """Phase 25 (b), on 14a's files: ``cli.train`` in MESH_RANKS ranks
    (14a's configuration, one model: ``model_output_mode`` BEST, no
    feature statistics) with ``--distributed --fleet-dir``, then
    ``cli.fleetview`` on the bundles, then ``cli.score --mesh auto`` in
    MESH_RANKS ranks on 14a's best model and validation file. Gates:
    every rank exits 0; one model and one summary; the configuration
    14a chose and its validation AUC within 1e-4; the coefficients
    within MESH_CLI_FE_ATOL / MESH_CLI_RE_ATOL of 14a's single-process
    best model (the entities whose rows hold one label left out, as
    14a's own agreement leaves them: they have no finite optimum), and
    how far past MESH_CLI_RTOL / MESH_CLI_ATOL they lie reported; fleetview merges MESH_RANKS bundles
    with no rank missing; one scores file within MESH_SCORE_ATOL of
    14a's ``cli.score``, and its AUC."""
    from photon_tpu_torch.io import avro

    root = mesh_root()
    cfg = dict(cli["cfg"], model_output_mode="BEST")
    cfg.pop("data_summary_dir", None)
    cfg, path = write_cli_config(cfg, os.path.join(root, "train"))
    fleet_dir = os.path.join(root, "fleet")
    t0 = time.perf_counter()
    train = mesh_ranks("train", os.path.join(root, "train"), argv=[
        "--config", path, "--device", "cuda", "--no-flight",
        "--distributed", "--fleet-dir", fleet_dir])
    train_s = time.perf_counter() - t0
    out = cfg["output_dir"]
    written = sorted(os.path.relpath(p, out) for p in glob.glob(
        os.path.join(out, "**", "*"), recursive=True) if os.path.isfile(p)
        and os.path.basename(p) in ("checkpoint.npz",
                                    "training-summary.json"))
    mesh_a, _ = checkpoint_arrays(os.path.join(out, "models", "best",
                                               "checkpoint.npz"))
    single_a, sman = checkpoint_arrays(os.path.join(
        cli["root"], "kernel", "out", "models", "best", "checkpoint.npz"))
    train_rows = cli["files"]["train"]
    excess, ref_excess, one_label = {}, {}, {}
    for key, a in single_a.items():
        if key.endswith("/proj_all"):
            excess[key] = 0.0 if np.array_equal(a, mesh_a[key]) else 1.0
            continue
        a = a.astype(np.float64)
        diff = np.abs(mesh_a[key].astype(np.float64) - a)
        room = diff - (MESH_CLI_FE_ATOL if key.startswith("global/")
                       else MESH_CLI_RE_ATOL)
        ref = diff - (MESH_CLI_ATOL + MESH_CLI_RTOL * np.abs(a))
        if not key.startswith("global/"):
            cid = key.split("/")[0]
            ids = train_rows["users" if cid == "per-user" else "movies"]
            pos = np.bincount(ids, weights=train_rows["labels"])
            mixed = (pos > 0) & (pos < np.bincount(ids))
            keep = mixed[np.array([int(k)
                                   for k in sman[cid]["entity_keys"]])]
            one_label[cid] = int((~keep).sum())
            room, ref = room[keep], ref[keep]
        excess[key] = float(np.max(room)) if room.size else 0.0
        ref_excess[key] = float(np.max(ref)) if ref.size else 0.0
    with open(os.path.join(out, "training-summary.json")) as f:
        ms = json.load(f)
    with open(os.path.join(cli["root"], "kernel", "out",
                           "training-summary.json")) as f:
        ks = json.load(f)
    best = [ms["best_configuration_index"], ks["best_configuration_index"]]
    val_auc = [s_["configurations"][b]["evaluation"]["AUC"]
               for s_, b in zip((ms, ks), best)]
    t0 = time.perf_counter()
    view = subprocess.run(
        [sys.executable, "-m", "photon_tpu_torch.cli.fleetview",
         "--run-dir", fleet_dir, "--json", os.path.join(root, "fleet.json"),
         "--expect-ranks", str(MESH_RANKS)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=MESH_LIMIT_S)
    view_s = time.perf_counter() - t0
    report = {}
    if os.path.exists(os.path.join(root, "fleet.json")):
        with open(os.path.join(root, "fleet.json")) as f:
            report = json.load(f)
    from photon_tpu_torch.obs import fleet

    census_gate("mesh_cli", "cli.train", [r["census"] for r in train])
    join = fleet.crosscheck_collective_census(
        report, [dict(zip(("op", "site"), c[:2])) for c in train[0]["census"]])
    val = cli["files"]["validation"]
    score_out = os.path.join(root, "scores")
    t0 = time.perf_counter()
    score = mesh_ranks("score", os.path.join(root, "score"), argv=[
        "--model-dir", os.path.join(cli["root"], "kernel", "out", "models",
                                    "best"),
        "--input", val["data"], "--output", score_out, "--feature-shards",
        *[f"{s}={b[0]}" for s, b in CLI_SHARDS.items()],
        "--id-tags", "userId", "movieId", "--device", "cuda",
        "--evaluators", *CLI_EVALUATORS, "--mesh", "auto"])
    score_s = time.perf_counter() - t0
    census_gate("mesh_cli", "cli.score", [r["census"] for r in score])

    def read(d):
        recs = avro.read_container_dir(os.path.join(d, "part-00000.avro"))
        with open(os.path.join(d, "evaluation.json")) as f:
            return np.array([r["predictionScore"] for r in recs]), json.load(f)

    got, got_ev = read(score_out)
    want, want_ev = read(os.path.join(cli["root"], "scores"))
    score_err = float(np.max(np.abs(got - want)))
    files = sorted(os.listdir(score_out))
    row = {"phase": "mesh_cli", "ranks": MESH_RANKS,
           "train_seconds": train_s,
           "train_rank_seconds": [r["wall_seconds"] for r in train],
           "train_stage_seconds": [r["line"] and r["line"].get(
               "wall_clock_seconds") for r in train],
           "newton_launches": [r["newton_launches"] for r in train],
           "segment_launches_by_site": [r["segment_launches_by_site"]
                                        for r in train + score],
           "peak_device_bytes": [r["peak_device_bytes"]
                                 for r in train + score],
           "written": written, "model_max_excess": excess,
           "model_max_excess_at_reference_bound": ref_excess,
           "one_label_entities_left_out": one_label,
           "best_configuration": best, "validation_auc": val_auc,
           "fleetview_rc": view.returncode, "fleetview_seconds": view_s,
           "fleet_bundles": report.get("bundles"),
           "fleet_missing_ranks": report.get("missing_ranks"),
           "census_join": {k: join[k] for k in ("count", "mismatches")},
           "train_collectives_by_site": [r["collectives_by_site"]
                                         for r in train],
           "score_seconds": score_s, "score_files": files,
           "score_max_abs_diff": score_err,
           "score_serve_launches": [r["serve_launches"] for r in score],
           "auc": [got_ev.get("AUC"), want_ev.get("AUC")]}
    emit(row)
    if any(r["rc"] != 0 for r in train + score):
        fail("mesh_cli: a rank's CLI exited non-zero")
    if written != ["models/best/checkpoint.npz", "training-summary.json"]:
        fail(f"mesh_cli: cli.train wrote {written}")
    if best[0] != best[1] or not abs(val_auc[0] - val_auc[1]) <= 1e-4:
        fail(f"mesh_cli: configuration {best} and validation AUC {val_auc} "
             "against 14a's")
    if not all(v <= 0.0 for v in excess.values()):
        fail(f"mesh_cli: the mesh model is past the bounds: {excess}")
    if any(r["newton_launches"] <= 0 for r in train):
        fail("mesh_cli: a rank launched the Newton kernel no time")
    if (view.returncode != 0 or report.get("bundles") != MESH_RANKS
            or report.get("missing_ranks")):
        fail(f"mesh_cli: fleetview exited {view.returncode} with "
             f"{report.get('bundles')} bundles: {view.stderr[-2000:]}")
    if join["mismatches"] or not join["count"]:
        fail(f"mesh_cli: the fleet report against the census: {join}")
    if files != ["evaluation.json", "part-00000.avro"]:
        fail(f"mesh_cli: cli.score wrote {files}")
    if len(got) != CLI_VALIDATION_ROWS or not score_err <= MESH_SCORE_ATOL:
        fail(f"mesh_cli: scores {score_err} from the single process's")
    if not abs(got_ev["AUC"] - want_ev["AUC"]) <= 1e-6:
        fail(f"mesh_cli: AUC {got_ev['AUC']} against {want_ev['AUC']}")
    sites = {}
    for r in train + score:
        for site, k in r["segment_launches_by_site"].items():
            sites[site] = sites.get(site, 0) + k
    return {"newton_launches": sum(r["newton_launches"] for r in train),
            "fixed_effect_launches": sites.get("fixed_effect", 0),
            "evaluation_launches": sites.get("evaluation", 0)}


def fits_only(torch, n: int) -> int:
    """``--fits N``: the full-width fits alone (module docstring)."""
    from photon_tpu_torch.ops import newton_kernel as nk

    arrays = synth_arrays()
    for route, dtype in (("kernel", torch.float32),
                         ("unfused", torch.float32),
                         ("plain", torch.float32),
                         ("float64", torch.float64)):
        data = train_dataset(arrays, dtype)
        est = build_estimator()
        if route == "unfused":
            from photon_tpu_torch.events import EventEmitter

            est.emitter = EventEmitter([lambda e: None])
        datasets, _ = est.prepare(data)
        with newton_switch("off" if route == "plain" else None):
            for k in range(n + 1 if route in ("kernel", "unfused") else 1):
                traj, res = fit_trajectory(torch, est, data)
                total, _ = total_scores(torch, res.model, datasets, data)
                emit({"phase": "fits", "route": route, "fit": k,
                      "cold": k == 0, **traj,
                      "training_loss": fit_objective(torch, total, data)})
        if route == "unfused":
            phase_newton_timing(torch, datasets, est, bucket_launches(
                res.descent.history, datasets))
        del data, est, datasets, res, total
        empty_cache()
    del arrays
    wide = phase_wide_data(torch)
    for k in range(n + 1):
        traj, _ = fit_trajectory(torch, wide["est"], wide["data"])
        emit({"phase": "wide_fits", "fit": k, "cold": k == 0,
              "fit_seconds": traj["fit_seconds"],
              "seconds_per_coordinate": traj["seconds_per_coordinate"],
              "fe_lbfgs_iterations": traj["fe_lbfgs_iterations"],
              "lbfgs_host_syncs": traj["lbfgs_host_syncs"]})
    cid, _, eb, _, _ = next(b for b in bucket_routes(wide["datasets"])
                            if b[0] == "per-movie" and b[4] == "gram")
    wide_newton_check(torch, "wide-linear", cid, eb,
                      l2_weight(wide["est"], cid))
    print(nvidia_smi(), flush=True)
    return 0


def cli_phases(torch, train_cli: dict, serve_sketch: str | None) -> tuple:
    """Phases 14b-14h once 14a has written its files: the phases that
    only read them (14b train_cli_routes, 14d stream_cli and 14f
    glm_cli, each through ``phase_child``; 14e's tuned runs, 14g's
    pilot and 14h's cli.profile, through their ``--cli-child`` specs)
    run at once, each in a process of its own that counts its launches,
    beside 14c in this process; 25 (b) ``phase_mesh_cli`` starts when
    14f's child ends (a chain: the block's CPU is its bound, and 14d's
    child, the longest, then has fewer beside it). Returns the results
    of 14d, 14b, 14f, 25 (b), 14c, 14e, 14g and 14h."""
    root = train_cli["root"]

    def child(name, tag, *args):
        return phase_child(name, os.path.join(root, f"phase-{tag}"), *args)

    children = in_background(cli_children, [
        child("phase_stream_cli", "stream", train_cli, serve_sketch),
        child("phase_train_cli_routes", "routes", train_cli),
        [child("phase_glm_cli", "glm", train_cli),
         child("phase_mesh_cli", "mesh", train_cli)]]
        + tuning_jobs(train_cli) + pilot_jobs(train_cli)
        + profile_jobs(train_cli), env=dict(os.environ))
    try:
        routes = phase_train_routes(torch)
    except BaseException:
        with contextlib.suppress(BaseException):
            children(cancel=True)
        raise
    empty_cache()
    stream, cli_routes, (glm, mesh_cli), *tuned, piloted, profiled = (
        children())
    stream, cli_routes, glm, mesh_cli = map(
        phase_result, (stream, cli_routes, glm, mesh_cli))
    return (stream, cli_routes, glm, mesh_cli, routes,
            phase_tuning_cli(torch, train_cli, tuned),
            phase_pilot_cli(torch, train_cli, piloted),
            phase_profile_cli(torch, profiled))


def main() -> int:
    ap = argparse.ArgumentParser(
        description="Smoke run of photon_tpu_torch on one NVIDIA GPU.")
    ap.add_argument("--timing", type=int, default=0, metavar="N",
                    help="run only the serve kernel's timing, N times")
    ap.add_argument("--fits", type=int, default=0, metavar="N",
                    help="run only the full-width fits, N warm times each")
    ap.add_argument("--train-cli", action="store_true",
                    help="run only the training CLI phases")
    ap.add_argument("--cli", action="store_true",
                    help="run only phase 14a and then 14b-14h as the "
                         "whole run runs them")
    ap.add_argument("--train-routes", action="store_true",
                    help="run only the optimizer-routes phase")
    ap.add_argument("--serve", action="store_true",
                    help="run only the serving phases (1-6c)")
    ap.add_argument("--stream", action="store_true",
                    help="run only the ingest phases: train_cli, "
                         "stream_cli and the planner comparison")
    ap.add_argument("--tuning", action="store_true",
                    help="run only train_cli, the tuned cli.train runs "
                         "and cli.glm")
    ap.add_argument("--pilot", action="store_true",
                    help="run only the pilot phase (14g) on train_cli's "
                         "files")
    ap.add_argument("--profile", action="store_true",
                    help="run only the cli.profile phase (14h)")
    ap.add_argument("--ell-routes", action="store_true",
                    help="run only the ell_routes phase (24)")
    ap.add_argument("--mesh", action="store_true",
                    help="run only the mesh phase (25) and what it reads")
    ap.add_argument("--cli-child", default=None, metavar="SPEC",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cli_child:
        return cli_child(args.cli_child)
    try:
        import torch
    except ImportError as exc:
        fail(f"torch is not importable: {exc}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    try:
        from photon_tpu_torch.io.model_io import (
            game_model_from_numpy,
            save_checkpoint,
        )
        from photon_tpu_torch.ops import (
            _build,
            newton_kernel,
            segment_reduce,
            serve_kernel,
        )
    except ImportError as exc:
        fail(f"photon_tpu_torch is not importable beside this script: {exc}")
    # The plain versions use no matmul, but a reference states TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib = _build.build()
    serve_kernel.load()
    newton_kernel.load()
    segment_reduce.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "library": str(lib),
          "sources": [str(p.name) for p in _build.sources()]})
    # Count the kernel launches that graph replays run (before any
    # capture, so every graph carries the counters).
    from photon_tpu_torch.utils import device_loop

    device_loop.count_graph_launches("cuda")
    phase_graph_loops(torch)
    phase_program_contracts(torch)
    if args.fits > 0:
        return fits_only(torch, args.fits)
    if args.ell_routes:
        phase_ell_routes(torch, wide_arrays())
        empty_cache()
        phase_ell_routes_small(
            torch, wide_arrays(**WIDE_REDUCED, task="logistic"))
        print(smi, flush=True)
        return 0
    if args.mesh:
        phase_mesh_fit(torch, single_fit_npz(torch), column_single_npz(torch))
        phase_mesh_cli(torch, phase_train_cli(torch, *serving_arrays()))
        print(smi, flush=True)
        return 0
    if args.tuning:
        cli = phase_train_cli(torch, *serving_arrays())
        phase_tuning_cli(torch, cli, cli_children(tuning_jobs(cli)))
        phase_glm_cli(torch, cli)
        print(smi, flush=True)
        return 0
    if args.profile:
        phase_profile_cli(torch, cli_children(
            profile_jobs({"root": train_cli_root()}))[0])
        overhead_aa(torch)
        print(smi, flush=True)
        return 0
    if args.pilot:
        cli = train_cli_inputs(*serving_arrays())
        phase_pilot_cli(torch, cli, cli_children(pilot_jobs(cli))[0])
        print(smi, flush=True)
        return 0
    if args.train_cli:
        phase_train_cli_routes(torch, phase_train_cli(torch,
                                                      *serving_arrays()))
        print(smi, flush=True)
        return 0
    if args.cli:
        cli_phases(torch, phase_train_cli(torch, *serving_arrays()), None)
        print(smi, flush=True)
        return 0
    if args.train_routes:
        phase_train_routes(torch)
        print(smi, flush=True)
        return 0
    if args.stream:
        phase_stream_cli(torch, phase_train_cli(torch, *serving_arrays()))
        arrays = synth_arrays()
        data = train_dataset(arrays)
        datasets, plan_row = timed_prepare(torch, build_estimator(), data)
        planner_comparison(torch, "logistic", build_estimator, data,
                           datasets, plan_row)
        del arrays, data, datasets
        empty_cache()
        phase_wide_data(torch)
        print(smi, flush=True)
        return 0
    if args.timing > 0:
        model = game_model_from_numpy(*serving_arrays(), "cuda")
        for _ in range(args.timing):
            phase_timing(torch, model)
        print(smi, flush=True)
        return 0

    t0 = time.perf_counter()
    arrays, manifest = serving_arrays()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke")
    ckpt = save_checkpoint(
        game_model_from_numpy(arrays, manifest, "cpu"),
        os.path.join(out_dir, "serving_model.npz"),
    )
    model = game_model_from_numpy(arrays, manifest, "cuda")
    emit({"phase": "model", "seconds": time.perf_counter() - t0,
          "checkpoint": ckpt, "checkpoint_bytes": os.path.getsize(ckpt)})

    worst = phase_parity(torch, model)
    serve = phase_serve(torch, ckpt, arrays)
    rows = phase_timing(torch, model)
    coords = phase_coords(torch, arrays, manifest, rows)
    del model
    batch = phase_score_cli(torch, arrays, manifest,
                            rows[0]["launch_floor_ms"])
    empty_cache()
    ops = phase_serve_ops(torch, arrays, manifest, ckpt, batch)
    empty_cache()
    if args.serve:
        print(smi, flush=True)
        return 0
    newton = phase_train(torch)
    empty_cache()
    mesh_fit = phase_mesh_fit(torch, os.path.join(mesh_root(), "single.npz"),
                              column_single_npz(torch))
    train_cli = phase_train_cli(torch, arrays, manifest)
    empty_cache()
    (stream, cli_routes, glm, mesh_cli, routes, tuning, pilot,
     profiles) = cli_phases(torch, train_cli, ops["health_sketch"])
    empty_cache()
    newton["launches_by_path"] = {
        "fit": newton["launches"], "train_cli": train_cli["newton_launches"],
        "stream_cli": stream["newton_launches"],
        "train_routes": routes["newton_launches"],
        "train_cli_routes": cli_routes["newton_launches"],
        "tuning_cli": tuning["newton_launches"],
        "pilot_cli": pilot["newton_launches"],
        "profile_cli": profiles["newton_launches"],
        "mesh_fit": mesh_fit["newton_launches"],
        "mesh_cli": mesh_cli["newton_launches"]}
    newton["launches"] = sum(newton["launches_by_path"].values())
    newton["max_abs_err"] = max(newton["max_abs_err"],
                                train_cli["newton_parity_max_abs_diff"])
    empty_cache()
    segment = phase_wide(torch)
    newton["launches_by_path"]["ell_routes"] = segment.pop(
        "ell_routes_newton_launches")
    newton["launches"] = sum(newton["launches_by_path"].values())
    segment["launches_by_path"]["score_cli_evaluation"] = batch[
        "evaluation_launches"]
    segment["launches_by_path"]["stream_cli_evaluation"] = stream[
        "segment_launches"]
    segment["launches_by_path"]["pilot_cli_evaluation"] = pilot[
        "evaluation_launches"]
    segment["launches_by_path"]["profile_cli"] = profiles[
        "segment_launches"]
    segment["launches_by_path"]["mesh_cli_fixed_effect"] = mesh_cli[
        "fixed_effect_launches"]
    segment["launches_by_path"]["mesh_cli_evaluation"] = mesh_cli[
        "evaluation_launches"]
    segment["launches_by_path"]["mesh_column_fixed_effect"] = mesh_fit[
        "column"]["fixed_effect_launches"]
    for route, r in mesh_fit["column"]["routes"].items():
        segment["launches_by_path"][f"mesh_column_{route}_fixed_effect"] = (
            r["fixed_effect_launches"])
    # The fixed effect's sparse transpose on every CLI training path.
    fixed_effect = {"train_cli": train_cli["fixed_effect_launches"],
                    "stream_cli": stream["fixed_effect_launches"],
                    "train_cli_routes": cli_routes["fixed_effect_launches"],
                    "tuning_cli": tuning["fixed_effect_launches"],
                    "glm_cli": glm["fixed_effect_launches"],
                    "pilot_cli": pilot["fixed_effect_launches"]}
    for path, n in fixed_effect.items():
        segment["launches_by_path"][f"{path}_fixed_effect"] = n
    segment["launches"] = sum(segment["launches_by_path"].values())
    site = train_cli["fixed_effect_site"]
    segment["max_abs_err"] = max(segment["max_abs_err"],
                                 batch["evaluation_max_abs_err"],
                                 site["max_abs_err"],
                                 mesh_fit["column"]["site"]["max_abs_err"],
                                 *(r["max_abs_err"] for r in mesh_fit[
                                     "column"]["routes"].values()))
    segment["fixed_effect"] = {
        k: site[k] for k in ("shape", "values", "features", "parts",
                             "segments", "ms", "reduce_ms", "plain_ms",
                             "library_ms", "library_spread_max_abs",
                             "rmatvec_ms",
                             "bound_ms", "bound_by", "max_abs_err")}
    segment["fixed_effect"]["launches_per_train_cli_run"] = train_cli[
        "fixed_effect_launches"]
    # 25 (c): a rank's column shard of the d = 10^7 fixed effect.
    segment["fixed_effect_column"] = mesh_fit["column"]["site"]

    top = next(r for r in rows
               if r["precision"] == SERVE_PRECISION and r["rung"] == 512)
    kernels = [{
        "name": "serve_score",
        "route": "cuda",
        "source": serve_kernel.SOURCE,
        "replaces": REPLACES,
        # Its main paths: the served requests (graph replays), serving
        # under reloads, the degraded drives and cli.serve --input (graph
        # replays), the batch CLI and the training CLI's train -> score
        # round trip.
        "launches": (serve["kernel_launches"] + ops["launches"]
                     + batch["launches"]
                     + train_cli["serve_launches"]
                     + stream["serve_launches"]
                     + cli_routes["serve_launches"]
                     + pilot["serve_launches"]
                     + profiles["serve_launches"]),
        "launches_by_path": {"serve": serve["kernel_launches"],
                             "serve_ops": ops["launches"],
                             "score_cli": batch["launches"],
                             "train_cli": train_cli["serve_launches"],
                             "stream_cli": stream["serve_launches"],
                             "train_cli_routes":
                                 cli_routes["serve_launches"],
                             "pilot_cli": pilot["serve_launches"],
                             "profile_cli": profiles["serve_launches"]},
        "max_abs_err": max(worst, coords["float32"]["max_abs_err"]),
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "launch_floor_ms": top["launch_floor_ms"],
        "graphs_captured": serve["programs_compiled"],
        "graph_capture_seconds": serve["aot_compile_seconds"],
        "dispatch_host_ms_replay": top["dispatch_host_ms"],
        "dispatch_host_ms_eager": top["eager_dispatch_host_ms"],
        "score_cli_rung_8192_ms": batch["ms"],
        "score_cli_rung_8192_bound_ms": batch["bound_ms"],
        "coords_12_rung_512_bf16_ms": coords["bfloat16"]["ms"],
    }, newton, segment]
    if not all(math.isfinite(k["ms"]) and k["ms"] > 0
               and math.isfinite(k["bound_ms"]) and k["bound_ms"] > 0
               for k in kernels) or not all(
            math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows):
        fail("a kernel timing is not a positive number")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
