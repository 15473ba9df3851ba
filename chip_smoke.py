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
             dispatch (copies, launch and fetch from Python), and the
             bound;
6. paced   - a second drive at a fixed offered load, whose p50/p99 are
             service latency rather than queueing behind a flood;
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
             directory): every row served twice with no graph captured
             after start, one launch a replay, and the per-request
             scores within 1e-5 (relative to 1 + |score|) of
             ``cli.score``'s.

Then the training group, on the bench's logistic GLMix at full width in
float32 (``bench.py`` ``build_estimator("logistic")`` and
``_synth_arrays``, seed 20260729: 4,000,000 rows, fixed effect d = 64,
``per-user`` 100,000 entities x 17 slots, ``per-movie`` 20,000 x 9,
4 coordinate-descent iterations; nothing cut):

7.  train_data     - numpy data, the copy to the card, the host planner;
7a. planner_logistic - the same prepare with PHOTON_TPU_SERIAL_INGEST=1
                     on a fresh estimator, then pipelined again: the
                     seconds of the three, each one's PIPELINE_STATS
                     report and packed
                     transfers (bytes, chunks, seconds), ``os.cpu_count()``,
                     PHOTON_TPU_INGEST_THREADS and ``torch.get_num_threads()``;
                     gate: every run's packed plan buffers equal to the
                     first's on the card;
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
9.  fit            - ``GameEstimator.fit`` with the Newton-kernel launch,
                     plain-route and host-sync counts zeroed just before:
                     launches > 0 and no bucket on the plain route;
                     then the fit's last fixed-effect L-BFGS solve
                     replayed by the port's two L-BFGS designs, host
                     branching and a batch of one, alternating
                     (``fe_lbfgs_designs``: seconds, syncs, iterations);
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
                     RE_FIT_ATOL), training losses within 1e-4.
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
                     ``torch.profiler`` (device time only), and with
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

14b. train_cli_routes - phase 14a's files through ``cli.train`` on the
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
                     tolerances, training losses within 1e-4.
14d. stream_cli    - run right after 14a, on its configuration and its
                     training rows, which 14a writes as 16 part files
                     (the in-memory runs read the directory): the
                     in-memory ``cli.train`` and (a) ``--stream-dir
                     --stream-window 2``, side by side, each in a
                     subprocess of its own (``--cli-child``,
                     ``cli_children``) for its peak RSS (the larger
                     of VmHWM, where the kernel reports it, and VmRSS
                     sampled every 10 ms from this process), beside the
                     RSS after the imports and the CUDA context;
                     then in this process, each with
                     a lighter config (one lambda, one iteration, the
                     best model only): (b) shard 5 truncated: the default
                     policy raises ``CorruptShardError`` naming it;
                     ``--max-bad-shards 1`` completes, under (d)
                     transient faults at ``io.shard_read`` calls 2, 4, 6
                     and 8 (each followed by a clean attempt: three in a
                     row exhaust the 3-attempt policy); (c) a ``crash``
                     at ``io.shard_decode`` on shard 9 (serial decode, so
                     the call count is exact), then ``--resume-ingest``;
                     (e) day 2: stream again with ``--init-model`` (a)'s
                     best checkpoint, then ``cli.score`` of the
                     validation file. Gates: (a) the dataset (host
                     mirrors, device columns, id tags) and the packed
                     plan buffer sha256-equal to the in-memory run's,
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
                     its own (``cli_children``), then
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
                     bag), lambdas GLM_LAMBDAS, on the card in float32
                     and on the CPU in float64 (the port's readers
                     switched to float64: ``float64_readers``). Gates:
                     the same selected lambda, the card's best model
                     within GLM_F32_ATOL = 5e-4 of float64 (the bound
                     ``tests/test_torch_wide.py`` derives for an f32
                     fixed-effect solve), segment sums
                     at the ``fixed_effect`` site. It prints both runs'
                     seconds by stage.

Then the wide group, ``wide-linear`` in float32: the bench's squared-loss
GLMix with ``per-movie`` on a sparse tag shard (20,000 movies, p(m) ~
1 / (m + 20); each owns 192 of 100,000 tag ids; a row carries 2-8 of
its movie's tags and the intercept id), whose subspaces are wider than
128 slots, so the planner lays it out materialized (ELL blocks, a score
table capped at 6 entries a row with a COO tail); 4,000,000 rows,
``per-user`` 100,000 x 17 as above, 4 coordinate-descent iterations,
nothing cut:

15. wide_data        - generation, the copy to the card, the planner's
                       host seconds and ``planner_wide`` (as 7a),
                       host seconds, every bucket's shape, S, route and
                       gram bounds, the tail's size and multiplicity;
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
                       update timed alone;
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
22. wide_profile     - one per-movie update under torch.profiler: device
                       ms by operator and the device's busy share; then
                       the Newton kernel's wide design on the per-movie
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
                       bucket on the kernel.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line again, and
last ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.

``python3 chip_smoke.py --fits N`` runs only the device and build phases
and then the full-width fits and the Newton kernel's timing, for
comparing two trees on one card: the logistic fit N + 1 times on the
kernel route (the first, cold, marked), once on the plain route in
float32 and once in float64, each with its trajectory (Newton and L-BFGS
iterations, launches, host syncs) and training loss; newton_timing; the
``wide-linear`` fit N + 1 times; the wide design's check and timing on
its per-movie gram bucket. It prints no ``ok`` line. To compare a parent
commit, unpack its package into a git-ignored directory, copy this
script beside it, and run parent, change, change, parent in one call.

``python3 chip_smoke.py --train-cli`` runs only the device and build
phases and then phases 14a and 14b, ``--train-routes`` phase 14c,
``--serve`` the serving phases 1-6c, ``--stream`` phases 14a, 14d, 7a
(on its own logistic data) and 15, and ``--tuning`` phases 14a, 14e and
14f, printing no ``ok`` line.

``python3 chip_smoke.py --timing N`` runs only the device and build
phases and then the serve kernel's timing phase (phase 5) N times on the
serving model, printing no ``ok`` line: the A/B of the serve kernel
across two trees, in the same way.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32
# FLOP/s, the unit this kernel's arithmetic runs on.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TIMING_RUNS, TIMING_INNER = 50, 20
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


def bound(ops: dict, precision: str) -> dict:
    """Least time the card could take for one launch on these operands:
    each input byte read once (only the table rows this rung's known
    codes name, once per distinct entity), the output written once, and
    the multiply-adds at the f32 peak."""
    wbytes = 2 if precision == "bfloat16" else 4
    rung = int(ops["codes"][0].shape[0])
    nbytes = 4.0 * rung  # the f32 output
    flops = 0.0
    kinds, feats = ops["spec_kinds"], ops["feats"]
    for si, kind in enumerate(kinds):
        nbytes += (feats[si].numel() * 4 if kind == "dense"
                   else feats[si][0].numel() * 8)
    for w, fi in zip(ops["fe_ws"], ops["fe_feat"]):
        nbytes += w.numel() * wbytes
        width = (feats[fi].shape[1] if kinds[fi] == "dense"
                 else feats[fi][0].shape[1])
        flops += 2.0 * rung * width
    for w, code, fi in zip(ops["re_ws"], ops["codes"], ops["re_feat"]):
        s = int(w.shape[1])
        known = code[(code >= 0) & (code < w.shape[0])]
        nbytes += code.numel() * 4
        nbytes += int(known.unique().numel()) * s * (wbytes + 4)
        per_slot = 2.0 if kinds[fi] == "dense" else 2.0 * (
            feats[fi][0].shape[1] + 1)
        flops += per_slot * int(known.numel()) * s
    ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS else (
        "operations")
    return {"bound_ms": ms, "bound_by": by, "bytes": nbytes, "flops": flops}


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

    with MicroBatchQueue(programs, max_linger_s=0.002) as queue:
        paced = drive(queue, requests[:PACED_REQUESTS], rate=PACED_QPS)
    emit({"phase": "paced", "precision": SERVE_PRECISION, **{
        k: paced[k] for k in (
            "requests", "errors", "offered_rate", "qps", "p50_ms", "p90_ms",
            "p99_ms", "max_ms", "mean_batch_size", "batches")}})
    if paced["errors"]:
        fail(f"{paced['errors']} paced requests failed")
    return result


def event_ms(torch, run, inner: int) -> float:
    """Median over TIMING_RUNS of CUDA-event time of ``run()`` divided
    by the ``inner`` calls it makes."""
    runs = []
    for _ in range(TIMING_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / inner)
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
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
    del data, model, programs, codes_all
    torch.cuda.empty_cache()

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
    torch.cuda.empty_cache()

    # cli.serve --input on score_cli's rows, with a hot reload of the
    # same model directory (values-only against the data's maps).
    files = batch["files"]
    npy = os.path.join(os.path.dirname(files["data"]), "served.npy")
    # Its ladder (3 coordinates: one launch a rung) is captured inside
    # the counted window.
    line = counted(run_serve_cli, [
        "--model-dir", files["model_dir"], "--input", files["data"],
        "--feature-shards",
        *[f"{s}={SCORE_SHARDS[s][0]}" for s in SCORE_SHARDS],
        "--id-tags", "userId", "movieId", "--scores", npy,
        "--deadline-ms", "60000", "--shed-watermark", "1000000",
        "--breaker-threshold", "8", "--reload-model", files["model_dir"]],
        warmups=len(RUNGS))
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
        "max_rel_err_score_cli": rel}
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
    if line["kernel_launches"] != replays or not rel <= 1e-5:
        fail(f"cli.serve --input: {line['kernel_launches']} launches for "
             f"{replays} replays, scores {rel} from cli.score's")
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
# H100 special-function units: 16 results per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute
# capability 9.0) x 132 SMs x 1.98 GHz boost clock.
SFU_OPS_PER_S = 16 * 132 * 1.98e9
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
                    device=None):
    """The bench's ``build_estimator(task_name)`` in float32. ``movie``
    replaces the per-movie data configuration and ``intercepts`` the
    intercept indices."""
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
        precision="float32",
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
        imp_agree = (float((got[3] == want[3])[keep].float().mean())
                     if bool(keep.any()) else 1.0)
        row = {"phase": phase, "coordinate": cid,
               "bucket": list(eb.x_values.shape), "step": k + 1,
               "near_optimum_entities": int((~keep).sum()),
               "improved_agreement": imp_agree,
               "improved_fraction": float(want[3].float().mean())}
        ok = imp_agree == 1.0
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
    wall seconds (ending in a sync), per CD iteration and coordinate, and
    its trajectory: L-BFGS and Newton iterations, Newton-kernel launches,
    plain-route solves, host syncs."""
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.optim import lbfgs

    nk.launches = 0
    ra.host_syncs = ra.plain_route_solves = 0
    lbfgs.host_syncs = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = est.fit(data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    res = results[0]
    hist = res.descent.history
    row = {
        "fit_seconds": fit_s,
        "seconds_per_cd_iteration": [
            sum(r.seconds for r in hist if r.iteration == i)
            for i in range(CD_ITERATIONS)],
        "seconds_per_coordinate": {
            cid: sum(r.seconds for r in hist if r.coordinate_id == cid)
            for cid in est.update_sequence},
        "fe_lbfgs_iterations": [int(r.diagnostics.iterations) for r in hist
                                if r.coordinate_id == "global"],
        "re_newton_iterations_max": {
            cid: [r.diagnostics.iterations_max for r in hist
                  if r.coordinate_id == cid] for cid in RE_IDS},
        "newton_kernel_launches": nk.launches,
        "plain_route_solves": ra.plain_route_solves,
        "newton_host_syncs": ra.host_syncs,
        "lbfgs_host_syncs": lbfgs.host_syncs,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    return row, res


def phase_fit(torch, arrays, data, est) -> dict:
    """GameEstimator.fit at full width, counts zeroed just before; then
    the fixed effect's last L-BFGS solve replayed by both designs."""
    with _LastSolve("lbfgs_solve") as fe:
        traj, res = fit_trajectory(torch, est, data)
    row = {"phase": "fit", "rows": int(arrays["y"].shape[0]), **traj}
    emit(row)
    if row["newton_kernel_launches"] <= 0:
        fail("the fit launched the Newton kernel no time")
    if row["plain_route_solves"] != 0:
        fail(f"{row['plain_route_solves']} bucket solves took the plain route")
    lbfgs_designs(torch, fe.call)
    return {"row": row, "result": res}


def lbfgs_designs(torch, call) -> dict:
    """The port's two L-BFGS designs on one recorded fixed-effect solve,
    alternating (host, batched, batched, host) twice:
    ``optim.lbfgs_solve`` (branches on the host: one sync a line-search
    probe, two an iteration) and ``batched.lbfgs`` with one lane
    (``batched.single``; every branch a ``torch.where``, the per-entity
    route's solver). Each one's seconds (ending in a sync), host syncs,
    iterations and reason, and their largest coefficient difference."""
    from photon_tpu_torch.optim import batched, lbfgs

    args, kw, _ = call
    designs = {"host": (lbfgs, lambda: lbfgs.lbfgs_solve(*args, **kw)),
               "batched": (batched, lambda: batched.single(
                   batched.lbfgs, *args, **kw))}
    row = {"phase": "fe_lbfgs_designs"}
    got = {}
    for name in ("host", "batched", "batched", "host") * 2:
        counter, solve = designs[name]
        before = counter.host_syncs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[name] = solve()
        torch.cuda.synchronize()
        r = row.setdefault(name, {"seconds": []})
        r["seconds"].append(time.perf_counter() - t0)
        r["host_syncs"] = counter.host_syncs - before
        r["iterations"] = int(got[name].iterations)
        r["reason"] = int(got[name].convergence_reason)
    row["max_abs_coefficient_diff"] = float(
        (got["host"].coefficients - got["batched"].coefficients).abs().max())
    emit(row)
    return row


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
                      cid, l1=0.0) -> dict:
    """Each entity's logistic objective (L2 ``l2`` on the penalized
    slots, L1 ``l1`` on every slot) in float64 at its fitted
    coefficients, its rows' offsets plus ``residuals``: the norm of its
    minimum-norm subgradient (the gradient when l1 = 0) against the
    cascade's tolerance, 1e-7 of that norm at zero; where it is above,
    the entity's convergence code (``reasons``, in bucket order) must
    say why. Emits the row, with the count of exact zeros."""
    from photon_tpu_torch.optim import ConvergenceReason

    w_all = model.coefficients.double()
    gn, g0n, zeros = [], [], 0
    for eb in ds.device_blocks():
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
    special-function rate. ``bound_ms`` is the largest."""
    b, r, s = shape
    nbytes = 4.0 * b * (r * s + 3 * r + 4 * s + 2 * s + 2) + b
    cg = min(r * s * (s + 1) + r * s + s * (2 * s * s + 10 * s),
             s * (4 * r * s + r + 12 * s))
    per_entity = (
        2 * r * s                      # margins
        + cg                           # H (formed or not) and the CG
        + 2 * r * s + 4 * s            # gradient + penalty
        + 2 * r * s                    # trial margins x d
        + trials * (r * 12 + 4 * s)    # trial losses + penalties
        + 4 * r * s + 12 * r           # refresh: margins, gradient, loss
    )
    flops = float(b) * per_entity
    transcendental = float(b) * r * (2 * trials + 6)
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": flops / F32_FLOPS,
             "transcendentals": transcendental / SFU_OPS_PER_S}
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
    planner_comparison(torch, "logistic", build_estimator, data, datasets,
                       plan_row)
    parity = phase_newton_parity(torch, datasets, est)

    fit = phase_fit(torch, arrays, data, est)
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
        "launches": fit["row"]["newton_kernel_launches"],
        "max_abs_err": parity["max_abs_err"],
        "ms": user["ms"],
        "plain_ms": user["plain_ms"],
        "bound_ms": user["bound_ms"],
        "bound_by": user["bound_by"],
        "library_ms": None,
    }


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
        kernel = run_train_cli(torch, cfg, os.path.join(root, "kernel"),
                               True)
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
    gen_auc = numpy_auc(val["exact"] + val["offsets"], val["labels"],
                        val["weights"])
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


def phase_tuning_cli(torch, cli: dict) -> dict:
    """Hyperparameter tuning through ``cli.train`` on ``train_cli``'s
    files (module docstring, phase 14e): RANDOM once and BAYESIAN twice,
    side by side, then ``cli.score`` of the validation file with the
    BAYESIAN run's best model."""
    from photon_tpu_torch.cli import score as score_cli
    from photon_tpu_torch.io import avro
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.serve.programs import ShapeLadder

    root = os.path.join(cli["root"], "tuning")
    t_phase = time.perf_counter()
    # Three processes side by side: the two BAYESIAN runs repeat each
    # other across processes.
    jobs = {"random": ("RANDOM", TUNING_RANDOM),
            "bayesian": ("BAYESIAN", TUNING_BAYESIAN),
            "bayesian_again": ("BAYESIAN", TUNING_BAYESIAN)}
    runs = dict(zip(jobs, cli_children([
        (tuning_config(cli, mode, n), os.path.join(root, k), ())
        for k, (mode, n) in jobs.items()])))
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
        "phase_seconds": time.perf_counter() - t_phase,
        "runs": {k: {
            "wall_seconds": r["wall_seconds"],
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
    """``--cli-child SPEC``: one ``stream_run`` in this process, its
    result and its memory written to ``spec["out"]``: VmHWM, its own
    address space's high-water mark, where the kernel reports it (the
    rusage maximum would carry the parent's over the exec), and the RSS
    after the imports and the CUDA context, before the run."""
    import torch

    from photon_tpu_torch.cli import train  # noqa: F401 — the imports
    from photon_tpu_torch.data import stream  # noqa: F401

    with open(spec_path) as f:
        spec = json.load(f)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    base = _vm_status("VmRSS")
    out = stream_run(torch, spec["cfg"], spec["root"], *spec["extra"])
    result = {k: out[k] for k in _CHILD_KEYS}
    result.update(vm_hwm_bytes=_vm_status("VmHWM"), baseline_rss_bytes=base)
    with open(spec["out"], "w") as f:
        json.dump(result, f)
    return 0


def cli_children(jobs: list) -> list:
    """``stream_run`` of each (cfg, root, extra) job in a subprocess of
    its own, all at once, for their peak RSS: each result as
    ``cli_child`` wrote it, with the process's seconds and the peak of
    its RSS sampled from here."""
    procs = []
    for cfg, root, extra in jobs:
        os.makedirs(root, exist_ok=True)
        spec = os.path.join(root, "child.json")
        with open(spec, "w") as f:
            json.dump({"cfg": cfg, "root": root, "extra": list(extra),
                       "out": os.path.join(root, "child-result.json")}, f)
        log = open(os.path.join(root, "child.log"), "w")
        procs.append({"root": root, "log": log, "sampled": 0,
                      "t0": time.perf_counter(), "proc": subprocess.Popen(
                          [sys.executable, os.path.abspath(__file__),
                           "--cli-child", spec], stdout=log,
                          stderr=subprocess.STDOUT, text=True,
                          cwd=os.path.dirname(os.path.abspath(__file__)))})
    try:
        # Each child's RSS every 10 ms, read from here, where their GILs
        # do not hold the reads back.
        while any(c["proc"].poll() is None for c in procs):
            for c in procs:
                if c["proc"].poll() is None:
                    c["sampled"] = max(c["sampled"], _vm_status(
                        "VmRSS", c["proc"].pid) or 0)
                    if time.perf_counter() - c["t0"] > 900:
                        c["proc"].kill()
                elif "seconds" not in c:
                    c["seconds"] = time.perf_counter() - c["t0"]
            time.sleep(0.01)
    finally:
        for c in procs:
            if c["proc"].poll() is None:
                c["proc"].kill()
            c["proc"].wait()
            c["log"].close()
            c.setdefault("seconds", time.perf_counter() - c["t0"])
    results = []
    for c in procs:
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
        results.append(result)
    return results


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


def phase_stream_cli(torch, cli: dict) -> dict:
    """The streaming training CLI on ``train_cli``'s configuration and
    rows (module docstring, phase 14d): the in-memory run and (a) in
    subprocesses of their own, side by side, for their peak RSS, then
    (b)-(e)."""
    import shutil

    from photon_tpu_torch.cli import score as score_cli
    from photon_tpu_torch.cli import train as train_cli
    from photon_tpu_torch.data import pipeline
    from photon_tpu_torch.io import avro
    from photon_tpu_torch.ops import serve_kernel
    from photon_tpu_torch.resilience import faults, reset_retry_stats
    from photon_tpu_torch.resilience.errors import (
        CorruptShardError,
        InjectedCrash,
    )
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
    memory, run_a = cli_children([(cfg, os.path.join(root, "memory"), ()),
                                  (cfg, os.path.join(root, "a"), stream)])
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
    # (three in a row would exhaust the 3-attempt policy).
    bad_dir = os.path.join(root, "shards-truncated")
    shutil.copytree(shard_dir, bad_dir)
    bad = os.path.join(bad_dir, "part-00005.avro")
    with open(bad, "rb") as f:
        raw = f.read()
    with open(bad, "wb") as f:
        f.write(raw[: len(raw) // 2])
    _, path = write_cli_config(light, os.path.join(root, "b-default"))
    refused = None
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli.main(["--config", path, "--device", "cuda",
                            "--stream-dir", bad_dir, *window])
    except CorruptShardError as exc:
        refused = str(exc)
    reset_retry_stats()
    with env_switch("PHOTON_TPU_FAULT_PLAN", json.dumps({"faults": [
            {"point": "io.shard_read", "nth": n} for n in (2, 4, 6, 8)]})):
        try:
            run_b = stream_run(torch, light, os.path.join(root, "bd"),
                               "--stream-dir", bad_dir, *window,
                               "--max-bad-shards", "1")
        finally:
            faults.disarm()
    reset_retry_stats()

    # (c) a crash at io.shard_decode on shard 9 (serial decode, so the
    # count is exact: 16 scan calls, then one a shard), then a resume.
    crash_at = STREAM_SHARDS + 9 + 1
    c_root = os.path.join(root, "c")
    _, path = write_cli_config(light, c_root)
    crashed = None
    with env_switch("PHOTON_TPU_SERIAL_INGEST", "1"), env_switch(
            "PHOTON_TPU_FAULT_PLAN", json.dumps({"faults": [
                {"point": "io.shard_decode", "nth": crash_at,
                 "error": "crash"}]})):
        pipeline.reset_executors()
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                train_cli.main(["--config", path, "--device", "cuda",
                                "--checkpoint-dir",
                                os.path.join(c_root, "ckpt"), *stream])
        except InjectedCrash as exc:
            crashed = str(exc)
        finally:
            faults.disarm()
            pipeline.reset_executors()
    cursor_path = os.path.join(c_root, "ckpt", "ingest-work",
                               "ingest-cursor.json")
    with open(cursor_path) as f:
        cursor = json.load(f)
    run_c = stream_run(torch, light, c_root, *stream, "--resume-ingest")

    # (e) day 2: stream again, warm-started from (a)'s model, then score.
    e_root = os.path.join(root, "e")
    run_e = stream_run(torch, light, e_root, *stream, "--init-model",
                       os.path.join(a_out, "models", "best",
                                    "checkpoint.npz"))
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
        "c": {"crash": crashed, "fault_call": crash_at,
              "cursor_next_shard": cursor["next_shard"],
              **stream_ingest_row(run_c["summary"]),
              "digests_equal_a": run_c["digests"] == run_a["digests"]},
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


def planner_comparison(torch, name: str, make_estimator, data, datasets,
                       pipelined: dict) -> dict:
    """The same prepare with ``PHOTON_TPU_SERIAL_INGEST=1`` on a fresh
    estimator, then pipelined once more (pipelined, serial, pipelined:
    the first run's place in the process is not the path's): the
    seconds of each, and every run's packed plan buffers compared with
    the first's on the card (exact int32 equality)."""
    from photon_tpu_torch.data import pipeline

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
    again, again_row = timed_prepare(torch, make_estimator(), data)
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
    torch.cuda.empty_cache()
    if not identical:
        fail(f"planner_{name}: the serial and pipelined plans differ")
    return row


# ---------------------------------------------------------------------------
# the optimizer routes: TRON, OWL-QN, variances and an incremental refit
# ---------------------------------------------------------------------------

ROUTES_CD_ITERATIONS = 2
VARIANCE_SAMPLE = 256
F32_EPS = 2.0 ** -24


def routes_estimator(device=None, incremental: bool = False,
                     num_iterations: int = ROUTES_CD_ITERATIONS):
    """The logistic training configuration (``build_estimator``'s data
    configurations and intercepts) on the slice's routes: ``global`` TRON
    with L2 1e-3 and FULL variances; ``per-user`` L2 1 with SIMPLE
    variances (the Newton kernel); ``per-movie`` elastic net, alpha 0.5
    and weight 1 (L1 0.5 + L2 0.5: the batched OWL-QN route), with SIMPLE
    variances so that the refit has a prior for every coordinate."""
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
    return base


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
        torch.cuda.empty_cache()
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
    planner_comparison(torch, "wide", wide_estimator, data, datasets,
                       plan_row)
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
    """Least time for one reduce: each value and id read once and each
    output written once, at 3.35 TB/s."""
    nbytes = float(vals.shape[0] * (4 + vals.element_size()) + n * 4)
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes}


def phase_segment_timing(torch, ops) -> list:
    """Per site at its full-width shape: the kernel's and the plain
    version's device ms (CUDA-graph replay, median of 50), the whole
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


def phase_wide_fit(torch, wide) -> dict:
    """GameEstimator.fit with the segment counts zeroed just before; then
    each coordinate's update timed alone at its final inputs."""
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.ops import segment_reduce as sr
    from photon_tpu_torch.optim import ConvergenceReason, lbfgs

    est, data = wide["est"], wide["data"]
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
    emit(row)
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
        sub = type(eb)(**{
            f: (getattr(eb, f)[sel] if getattr(eb, f) is not None else None)
            for f in ("entity_codes", "x_indices", "x_values", "labels",
                      "offsets", "weights", "row_ids", "proj",
                      "penalty_mask", "valid_mask", "intercept_slots")})
        x = dense_x(torch, sub).cpu().numpy()
        wt = sub.weights.double().cpu().numpy()
        off = (sub.offsets.double() + torch.where(
            sub.weights > 0, residuals[sub.row_ids.long()].double(),
            torch.zeros((), dtype=torch.float64, device=WIDE_DEVICE))).cpu().numpy()
        y = sub.labels.double().cpu().numpy()
        pen = sub.penalty_mask.double().cpu().numpy()
        vm = sub.valid_mask.double().cpu().numpy()
        h = np.einsum("brs,br,brt->bst", x, wt, x)
        h += np.einsum("bs,st->bst", l2w * pen + (1.0 - vm),
                       np.eye(x.shape[-1]))
        rhs = np.einsum("brs,br->bs", x, wt * (y - off))
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
    return dict(row, timing=timing)


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


def phase_wide_profile(torch, wide, fit) -> dict:
    """One per-movie update (train and score at the residuals of its last
    solve) under ``torch.profiler``: device time by operator, and the
    device's busy share of the update's wall time."""
    from torch.profiler import ProfilerActivity, profile

    coord = fit["coords"]["per-movie"]
    residuals = fit["residuals"][id(wide["datasets"]["per-movie"])]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, _ = coord.train(residuals)
        coord.score(model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def self_device_us(evt):
        return float(getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0)))

    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # Device time is the sum over the kernels (CUDA events); each
    # operator's self device time is that of the kernels it launched.
    kernels = [e for e in events if e.device_type == cuda]
    device_ms = sum(self_device_us(e) for e in kernels) / 1e3

    def top(evts):
        ranked = sorted(((self_device_us(e), e.key[:90], e.count)
                         for e in evts), reverse=True)
        return [{"name": k, "device_ms": us / 1e3, "calls": c}
                for us, k, c in ranked[:10] if us > 0]

    row = {"phase": "wide_profile", "coordinate": "per-movie",
           "wall_ms": wall * 1e3, "device_ms": device_ms,
           "device_busy_share": device_ms / (wall * 1e3),
           "top_operators": top(e for e in events if e.device_type != cuda),
           "top_kernels": top(kernels)}
    emit(row)
    return row


def phase_wide(torch) -> dict:
    """The wide-linear group; returns the segment-sum kernel's entry of
    the ``kernels`` line."""
    from photon_tpu_torch.ops import segment_reduce as sr

    wide = phase_wide_data(torch)
    ops = site_operands(torch, wide["datasets"])
    worst = phase_segment_parity(torch, ops)
    timing = phase_segment_timing(torch, ops)
    del ops
    torch.cuda.empty_cache()
    fit = phase_wide_fit(torch, wide)
    phase_wide_optimality(torch, wide, fit)
    phase_wide_route_agreement(torch, wide, fit)
    phase_wide_train_serve(torch, wide, fit)
    phase_wide_profile(torch, wide, fit)
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
    del wide, fit
    torch.cuda.empty_cache()
    phase_wide_logistic(torch)
    return {
        "name": "segment_sum",
        "route": "cuda",
        "source": sr.SOURCE,
        "replaces": SEGMENT_REPLACES,
        "launches": sum(launches.values()),
        "launches_by_path": {"wide_fit": sum(launches.values())},
        "max_abs_err": worst,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "site": top["site"],
        "shape": top["shape"],
    }


def fits_only(torch, n: int) -> int:
    """``--fits N``: the full-width fits alone (module docstring)."""
    from photon_tpu_torch.ops import newton_kernel as nk

    arrays = synth_arrays()
    for route, dtype in (("kernel", torch.float32), ("plain", torch.float32),
                         ("float64", torch.float64)):
        data = train_dataset(arrays, dtype)
        est = build_estimator()
        datasets, _ = est.prepare(data)
        with newton_switch("off" if route == "plain" else None):
            for k in range(n + 1 if route == "kernel" else 1):
                traj, res = fit_trajectory(torch, est, data)
                total, _ = total_scores(torch, res.model, datasets, data)
                emit({"phase": "fits", "route": route, "fit": k,
                      "cold": k == 0, **traj,
                      "training_loss": fit_objective(torch, total, data)})
        if route == "kernel":
            phase_newton_timing(torch, datasets, est, bucket_launches(
                res.descent.history, datasets))
        del data, est, datasets, res, total
        torch.cuda.empty_cache()
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


def main() -> int:
    ap = argparse.ArgumentParser(
        description="Smoke run of photon_tpu_torch on one NVIDIA GPU.")
    ap.add_argument("--timing", type=int, default=0, metavar="N",
                    help="run only the serve kernel's timing, N times")
    ap.add_argument("--fits", type=int, default=0, metavar="N",
                    help="run only the full-width fits, N warm times each")
    ap.add_argument("--train-cli", action="store_true",
                    help="run only the training CLI phases")
    ap.add_argument("--train-routes", action="store_true",
                    help="run only the optimizer-routes phase")
    ap.add_argument("--serve", action="store_true",
                    help="run only the serving phases (1-6c)")
    ap.add_argument("--stream", action="store_true",
                    help="run only the ingest phases: train_cli, "
                         "stream_cli and the planner comparisons")
    ap.add_argument("--tuning", action="store_true",
                    help="run only train_cli, the tuned cli.train runs "
                         "and cli.glm")
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
    if args.fits > 0:
        return fits_only(torch, args.fits)
    if args.tuning:
        cli = phase_train_cli(torch, *serving_arrays())
        phase_tuning_cli(torch, cli)
        phase_glm_cli(torch, cli)
        print(smi, flush=True)
        return 0
    if args.train_cli:
        phase_train_cli_routes(torch, phase_train_cli(torch,
                                                      *serving_arrays()))
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
        torch.cuda.empty_cache()
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
    torch.cuda.empty_cache()
    ops = phase_serve_ops(torch, arrays, manifest, ckpt, batch)
    torch.cuda.empty_cache()
    if args.serve:
        print(smi, flush=True)
        return 0
    newton = phase_train(torch)
    torch.cuda.empty_cache()
    train_cli = phase_train_cli(torch, arrays, manifest)
    stream = phase_stream_cli(torch, train_cli)
    torch.cuda.empty_cache()
    cli_routes = phase_train_cli_routes(torch, train_cli)
    torch.cuda.empty_cache()
    tuning = phase_tuning_cli(torch, train_cli)
    glm = phase_glm_cli(torch, train_cli)
    torch.cuda.empty_cache()
    routes = phase_train_routes(torch)
    newton["launches_by_path"] = {
        "fit": newton["launches"], "train_cli": train_cli["newton_launches"],
        "stream_cli": stream["newton_launches"],
        "train_routes": routes["newton_launches"],
        "train_cli_routes": cli_routes["newton_launches"],
        "tuning_cli": tuning["newton_launches"]}
    newton["launches"] = sum(newton["launches_by_path"].values())
    newton["max_abs_err"] = max(newton["max_abs_err"],
                                train_cli["newton_parity_max_abs_diff"])
    torch.cuda.empty_cache()
    segment = phase_wide(torch)
    segment["launches_by_path"]["score_cli_evaluation"] = batch[
        "evaluation_launches"]
    segment["launches_by_path"]["stream_cli_evaluation"] = stream[
        "segment_launches"]
    # The fixed effect's sparse transpose on every CLI training path.
    fixed_effect = {"train_cli": train_cli["fixed_effect_launches"],
                    "stream_cli": stream["fixed_effect_launches"],
                    "train_cli_routes": cli_routes["fixed_effect_launches"],
                    "tuning_cli": tuning["fixed_effect_launches"],
                    "glm_cli": glm["fixed_effect_launches"]}
    for path, n in fixed_effect.items():
        segment["launches_by_path"][f"{path}_fixed_effect"] = n
    segment["launches"] = sum(segment["launches_by_path"].values())
    site = train_cli["fixed_effect_site"]
    segment["max_abs_err"] = max(segment["max_abs_err"],
                                 batch["evaluation_max_abs_err"],
                                 site["max_abs_err"])
    segment["fixed_effect"] = {
        k: site[k] for k in ("shape", "values", "features", "parts",
                             "segments", "ms", "reduce_ms", "plain_ms",
                             "library_ms", "library_spread_max_abs",
                             "rmatvec_ms",
                             "bound_ms", "bound_by", "max_abs_err")}
    segment["fixed_effect"]["launches_per_train_cli_run"] = train_cli[
        "fixed_effect_launches"]

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
                     + cli_routes["serve_launches"]),
        "launches_by_path": {"serve": serve["kernel_launches"],
                             "serve_ops": ops["launches"],
                             "score_cli": batch["launches"],
                             "train_cli": train_cli["serve_launches"],
                             "stream_cli": stream["serve_launches"],
                             "train_cli_routes":
                                 cli_routes["serve_launches"]},
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
