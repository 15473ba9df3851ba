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
4. serve   - load_checkpoint -> CoefficientTables -> ScorePrograms ->
             MicroBatchQueue -> drive over 20,000 synthetic requests
             (5% cold) with bf16 tables; no errors, every dispatch one
             kernel launch, and 64 sampled requests re-scored through
             the queue agree with the plain version and with a float64
             numpy score taken straight from the checkpoint arrays;
5. timing  - per rung and table dtype, median of 50 runs after warm-up
             with CUDA events: the kernel's and the plain version's device
             time (calls captured in a CUDA graph and replayed) beside
             the launch floor (``torch.zeros(1)`` timed the same way),
             the same calls issued eagerly from Python, the host time to
             issue one kernel call, a whole host dispatch (copies +
             launch + fetch), and the bound;
6. paced   - a second drive at a fixed offered load, whose p50/p99 are
             service latency rather than queueing behind a flood.

Then the training group, on the bench's logistic GLMix at full width in
float32 (``bench.py`` ``build_estimator("logistic")`` and
``_synth_arrays``, seed 20260729: 4,000,000 rows, fixed effect d = 64,
``per-user`` 100,000 entities x 17 slots, ``per-movie`` 20,000 x 9,
4 coordinate-descent iterations; nothing cut):

7.  train_data     - numpy data, the copy to the card, the host planner;
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
                     route: fixed effect within rtol 1e-3 / atol 1e-4,
                     random effects within rtol 1e-3 / atol 2e-3 (the
                     f32 resolution of an entity's optimum, see
                     RE_FIT_ATOL), training losses within 1e-4.

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
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
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


def emit(obj) -> None:
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
        dense = ScorePrograms(tables)
        for layout, programs in (
            ("dense", dense),
            ("ell", ScorePrograms(tables, specs=ell_specs(dense))),
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
    programs = ScorePrograms(tables)
    setup_s = time.perf_counter() - t0
    requests = synthetic_requests(tables, programs, N_REQUESTS,
                                  cold_fraction=COLD_FRACTION, seed=7)
    with MicroBatchQueue(programs, max_linger_s=0.002) as queue:
        serve_kernel.launches = 0
        summary = drive(queue, requests)
        launches = serve_kernel.launches
        by_rung = dict(programs.stats["dispatches"])
        dispatches = sum(by_rung.values())
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
        "setup_seconds": setup_s, "kernel_launches": launches,
        "dispatches": by_rung,
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
    if launches <= 0 or launches != dispatches:
        fail(f"{launches} kernel launches for {dispatches} dispatches")
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


def host_ms(programs, feats, codes, n) -> float:
    """Median host wall time of one whole dispatch: staging copies,
    launch and the fetch that waits for the scores."""
    for _ in range(3):
        programs.score_padded(feats, codes, n)
    runs = []
    for _ in range(TIMING_RUNS):
        t0 = time.perf_counter()
        programs.score_padded(feats, codes, n)
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
                "dispatch_host_ms": host_ms(programs, feats, codes, rung),
                **bound(ops, precision),
            }
            emit(row)
            rows.append(row)
    return rows


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


def train_dataset(arrays, dtype=None):
    """The arrays on the card, in float32 unless ``dtype`` says otherwise
    (a float64 dataset trains in float64, on the plain route)."""
    from photon_tpu_torch.data.dataset import DenseFeatures
    from photon_tpu_torch.data.game_data import make_game_dataset

    extra = {} if dtype is None else {"dtype": dtype}
    return make_game_dataset(
        arrays["y"],
        {"global": DenseFeatures(arrays["x"]),
         "userShard": DenseFeatures(arrays["xu"]),
         "movieShard": DenseFeatures(arrays["xm"])},
        id_tags={"userId": arrays["users"], "movieId": arrays["movies"]},
        device="cuda", **extra,
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
    """GameEstimator.fit at full width, counts zeroed just before."""
    traj, res = fit_trajectory(torch, est, data)
    row = {"phase": "fit", "rows": int(arrays["y"].shape[0]), **traj}
    emit(row)
    if row["newton_kernel_launches"] <= 0:
        fail("the fit launched the Newton kernel no time")
    if row["plain_route_solves"] != 0:
        fail(f"{row['plain_route_solves']} bucket solves took the plain route")
    return {"row": row, "result": res}


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
    from photon_tpu_torch.optim import ConvergenceReason

    total, parts = total_scores(torch, model, datasets, data)
    out = {}
    for cid in RE_IDS:
        ds = datasets[cid]
        residuals = (total - parts[cid]).double()
        w_all = model[cid].coefficients.double()
        l2w = stats["l2"][cid]
        reasons = stats["reasons"][cid]
        gn, g0n = [], []
        for eb in ds.device_blocks():
            x = dense_x(torch, eb)
            rows = eb.row_ids.long()
            wt = eb.weights.double()
            off = eb.offsets.double() + torch.where(
                eb.weights > 0, residuals[rows], torch.zeros_like(wt))
            ind = (eb.labels > 0.5).double()
            w = w_all[eb.entity_codes.long()][:, :x.shape[-1]]
            pen = l2w * eb.penalty_mask.double()
            vm = eb.valid_mask.double()
            for ww, sink in ((w, gn), (torch.zeros_like(w), g0n)):
                z = torch.einsum("brs,bs->br", x, ww) + off
                g = (torch.einsum("brs,br->bs", x,
                                  wt * (torch.sigmoid(z) - ind))
                     + pen * ww) * vm
                sink.append(torch.linalg.vector_norm(g, dim=-1))
        gn = torch.cat(gn).cpu().numpy()
        g0n = torch.cat(g0n).cpu().numpy()
        tol = g0n * 1e-7
        converged = gn <= tol
        counts = {"GRADIENT_BELOW_TOLERANCE": int(converged.sum())}
        for code in np.unique(reasons[~converged]):
            counts[ConvergenceReason(int(code)).name] = int(
                (reasons[~converged] == code).sum())
        rel = gn / np.maximum(g0n, 1e-30)
        row = {"phase": phase, "coordinate": cid,
               "entities": int(gn.size), "counts": counts,
               "rel_grad_median": float(np.median(rel)),
               "rel_grad_p99": float(np.quantile(rel, 0.99)),
               "rel_grad_max": float(rel.max())}
        emit(row)
        out[cid] = row
        if not np.isfinite(gn).all():
            fail(f"{cid}: non-finite gradient at the fitted model")
        if (reasons[~converged] == int(ConvergenceReason.NOT_CONVERGED)).any():
            fail(f"{cid}: an entity is above the gradient tolerance with no "
                 "convergence reason")
    return out


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
    serve_kernel.launches = 0
    served = programs.score_padded(feats, codes, len(requests))
    launches = serve_kernel.launches
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
    supported = nk.kernel_supported
    for route in ("kernel", "plain"):
        est = build_estimator()
        nk.launches = ra.plain_route_solves = 0
        if route == "plain":
            nk.kernel_supported = lambda *a, **k: False
        try:
            t0 = time.perf_counter()
            model = est.fit(data)[0].model
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            nk.kernel_supported = supported
        datasets = est.prepare(data)
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
    t0 = time.perf_counter()
    datasets = est.prepare(data)
    plan_s = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    datasets = est.prepare(data)
    plan_s = time.perf_counter() - t0
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
    serve_kernel.launches = 0
    served = programs.score_padded(feats, codes, len(requests))
    launches = serve_kernel.launches
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
    datasets = est.prepare(data)
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
        datasets = est.prepare(data)
        supported = nk.kernel_supported
        if route == "plain":
            nk.kernel_supported = lambda *a, **k: False
        try:
            for k in range(n + 1 if route == "kernel" else 1):
                traj, res = fit_trajectory(torch, est, data)
                total, _ = total_scores(torch, res.model, datasets, data)
                emit({"phase": "fits", "route": route, "fit": k,
                      "cold": k == 0, **traj,
                      "training_loss": fit_objective(torch, total, data)})
        finally:
            nk.kernel_supported = supported
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
    ap.add_argument("--fits", type=int, default=0, metavar="N",
                    help="run only the full-width fits, N warm times each")
    args = ap.parse_args()
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
    newton = phase_train(torch)
    torch.cuda.empty_cache()
    segment = phase_wide(torch)

    top = next(r for r in rows
               if r["precision"] == SERVE_PRECISION and r["rung"] == 512)
    kernels = [{
        "name": "serve_score",
        "route": "cuda",
        "source": serve_kernel.SOURCE,
        "replaces": REPLACES,
        "launches": serve["kernel_launches"],
        "max_abs_err": worst,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "launch_floor_ms": top["launch_floor_ms"],
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
