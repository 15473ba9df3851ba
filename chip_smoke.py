#!/usr/bin/env python3
"""Smoke run of photon_tpu_torch's serving path on one NVIDIA GPU.

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
             time (calls captured in a CUDA graph and replayed), the same
             calls issued eagerly from Python, the host time to issue one
             kernel call, a whole host dispatch (copies + launch +
             fetch), and the bound;
6. paced   - a second drive at a fixed offered load, whose p50/p99 are
             service latency rather than queueing behind a flood.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line again, and
last ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero.
"""

from __future__ import annotations

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


def main() -> int:
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
        from photon_tpu_torch.ops import _build, serve_kernel
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
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds, "library": str(lib)})

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

    top = next(r for r in rows
               if r["precision"] == SERVE_PRECISION and r["rung"] == 512)
    emit({"kernels": [{
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
    }]})
    if not all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows):
        fail("a kernel timing is not a positive number")
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
