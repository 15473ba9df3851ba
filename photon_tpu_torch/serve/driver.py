"""Synchronous serving driver (port of ``photon_tpu/serve/driver.py``).

The driver is the load generator and the client: it pushes requests
(synthetic, or one per row of a ``GameDataset``) through a
``MicroBatchQueue`` from the calling thread, timestamps each completion
with a done-callback on the worker thread, and reports p50/p99 latency,
QPS, batch fill and the cold-entity rate. ``traffic_loop`` is the
open-ended paced load generator a caller runs on its own thread against
a live server, so that a reload happens under traffic. The driver owns
no threads and no locks.
"""

from __future__ import annotations

import time

import numpy as np

from photon_tpu_torch.data.dataset import DenseFeatures
from photon_tpu_torch.serve.programs import ScorePrograms
from photon_tpu_torch.serve.queue import MicroBatchQueue
from photon_tpu_torch.serve.tables import CoefficientTables


def synthetic_requests(
    tables: CoefficientTables,
    programs: ScorePrograms,
    n: int,
    *,
    cold_fraction: float = 0.05,
    seed: int = 0,
) -> list[tuple[dict, dict]]:
    """``n`` synthetic ``(features, entity_ids)`` requests: features
    N(0, 1) per shard spec, entity ids drawn from each random table's
    vocabulary with ``cold_fraction`` of lookups replaced by keys the
    model never trained."""
    rng = np.random.default_rng(seed)
    vocab = {
        rt: next(
            t.entity_keys
            for t in tables.random.values()
            if t.random_effect_type == rt
        )
        for rt in programs.retype_order
    }
    reqs: list[tuple[dict, dict]] = []
    for i in range(n):
        feats = {}
        for s in programs.shard_order:
            spec = programs.specs[s]
            if spec.kind == "dense":
                feats[s] = rng.normal(size=spec.d).astype(programs.dtype)
            else:
                feats[s] = (
                    rng.integers(0, spec.d, size=spec.k).astype(np.int32),
                    rng.normal(size=spec.k).astype(programs.dtype),
                )
        ids = {}
        for rt, keys in vocab.items():
            if keys and rng.uniform() >= cold_fraction:
                ids[rt] = keys[int(rng.integers(0, len(keys)))]
            else:
                ids[rt] = f"__cold_{i}"
        reqs.append((feats, ids))
    return reqs


def dataset_requests(data, programs: ScorePrograms
                     ) -> list[tuple[dict, dict]]:
    """One ``(features, entity_ids)`` request per dataset row, against
    the dataset's own feature layout and id tags (the file-driven
    serve CLI path)."""
    host: dict[str, tuple] = {}
    for s in programs.shard_order:
        feats = data.feature_shards[s]
        if isinstance(feats, DenseFeatures):
            host[s] = (feats.x.cpu().numpy(),)
        else:
            host[s] = (feats.indices.cpu().numpy().astype(np.int32),
                       feats.values.cpu().float().numpy())
    keys = {}
    for rt in programs.retype_order:
        tag = data.id_tags[rt]
        keys[rt] = [tag.inverse[c] for c in tag.host_codes()]
    reqs: list[tuple[dict, dict]] = []
    for i in range(data.num_samples):
        feats = {s: (leaf[0][i] if len(leaf) == 1
                     else (leaf[0][i], leaf[1][i]))
                 for s, leaf in host.items()}
        reqs.append((feats, {rt: k[i] for rt, k in keys.items()}))
    return reqs


def traffic_loop(
    get_server,
    rate: float,
    stop,
    counts: dict,
    *,
    batch: int = 32,
    cold_fraction: float = 0.05,
    idle_sleep: float = 0.05,
    drain_timeout_s: float = 30.0,
) -> None:
    """Open-ended paced synthetic traffic against a live server, run by
    the caller on its own thread until ``stop`` (a
    ``threading.Event``) is set.

    ``get_server()`` returns the current server (anything with
    ``.programs`` and ``.submit``, such as a ``MicroBatchQueue``) or
    None while none is up; it is read again every ``batch`` requests,
    so a swapped generation is picked up. ``counts`` (``served``,
    ``errors``, ``submit_errors``, ``stranded``, ``last_error``) is
    written only from the calling thread; read it after the join. Typed
    queue rejections (shed, breaker, closed) are counted, never fatal.
    """
    interval = 1.0 / rate
    next_t = time.perf_counter()
    pending: list = []
    batch_no = 0
    while not stop.is_set():
        server = get_server()
        if server is None:
            time.sleep(idle_sleep)
            continue
        programs = server.programs
        try:
            reqs = synthetic_requests(
                programs.tables, programs, batch,
                cold_fraction=cold_fraction, seed=batch_no,
            )
        except (StopIteration, KeyError):
            # Read mid-swap: the programs read above and the tables they
            # point at are two generations; the next read is settled.
            time.sleep(0.01)
            continue
        batch_no += 1
        for feats, ids in reqs:
            if stop.is_set():
                break
            delay = next_t - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            next_t = max(next_t + interval,
                         time.perf_counter() - 5 * interval)
            try:
                pending.append(server.submit(feats, ids))
            except Exception as exc:  # noqa: BLE001 - a typed queue
                # rejection counts as a drop; the loop outlives it.
                counts["submit_errors"] += 1
                counts["last_error"] = type(exc).__name__
            while pending and pending[0].done():
                _count(counts, pending.pop(0).exception())
    for fut in pending:
        try:
            exc = fut.exception(timeout=drain_timeout_s)
        except TimeoutError:
            counts["stranded"] += 1
            continue
        _count(counts, exc)


def _count(counts: dict, exc: BaseException | None) -> None:
    if exc is None:
        counts["served"] += 1
    else:
        counts["errors"] += 1
        counts["last_error"] = type(exc).__name__


def drive(
    queue: MicroBatchQueue,
    requests: list[tuple[dict, dict]],
    *,
    warmup: int | None = None,
    rate: float | None = None,
    scores: list | None = None,
) -> dict:
    """Push ``requests`` through ``queue``; return the serving summary.

    A warmup prefix (default: one max batch per rung, at most a quarter
    of the requests) runs to completion before the measured window.
    ``rate=None`` floods (QPS is the ceiling and latency includes
    queueing); a requests/s ``rate`` paces submission on a fixed
    schedule. ``scores``, when given, receives every request's score in
    request order, warmup included (NaN for a failed request).
    """
    ladder = queue.programs.ladder
    if warmup is None:
        warmup = min(len(requests) // 4, sum(ladder.rungs))
    warm, measured = requests[:warmup], requests[warmup:]
    if not measured:
        raise ValueError(
            f"{len(requests)} requests leave nothing to measure after "
            f"a {warmup}-request warmup"
        )
    warm_futures = [queue.submit(feats, ids) for feats, ids in warm]
    for fut in warm_futures:
        fut.result()
    warm_stats = queue.stats()

    # (submit time, completion time, future), appended only from the
    # worker thread, read only after every future resolved.
    completions: list[tuple[float, float, object]] = []

    def on_done(t0: float):
        def cb(fut):
            completions.append((t0, time.perf_counter(), fut))

        return cb

    futures = []
    t_start = time.perf_counter()
    for i, (feats, ids) in enumerate(measured):
        if rate:
            delay = t_start + i / rate - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        t0 = time.perf_counter()
        fut = queue.submit(feats, ids)
        fut.add_done_callback(on_done(t0))
        futures.append(fut)
    errors = 0
    first_error: BaseException | None = None
    for fut in futures:
        exc = fut.exception()
        if exc is not None:
            errors += 1
            first_error = first_error or exc
    if errors == len(futures) and first_error is not None:
        raise first_error  # nothing scored: surface the real failure
    if scores is not None:
        scores.extend(float("nan") if f.exception() is not None
                      else f.result() for f in warm_futures + futures)
    # Latency and QPS describe served requests only.
    ok = [(t0, td) for t0, td, f in completions if f.exception() is None]
    lat_arr = np.asarray(sorted(td - t0 for t0, td in ok))
    t_end = max(td for _, td in ok)
    wall = max(t_end - t_start, 1e-9)
    out = {
        "requests": len(measured),
        "warmup_requests": len(warm),
        "errors": errors,
        "p50_ms": round(float(np.percentile(lat_arr, 50)) * 1e3, 3),
        "p90_ms": round(float(np.percentile(lat_arr, 90)) * 1e3, 3),
        "p99_ms": round(float(np.percentile(lat_arr, 99)) * 1e3, 3),
        "max_ms": round(float(lat_arr[-1]) * 1e3, 3),
        "qps": round(len(lat_arr) / wall, 1),
        "wall_seconds": round(wall, 4),
        "offered_rate": rate,
    }
    qstats = queue.stats()

    def delta(key):
        return qstats[key] - warm_stats[key]

    batches = delta("batches")
    batched = delta("batched_requests")
    lookups = delta("entity_lookups")
    out["batch_fill_fraction"] = (
        round(batched / (batches * queue.max_batch), 4) if batches else None
    )
    out["mean_batch_size"] = round(batched / batches, 2) if batches else None
    out["cold_entity_rate"] = (
        round(delta("cold_lookups") / lookups, 4) if lookups else None
    )
    out["cold_entity_rate_by_coordinate"] = {}
    for nm, cs in qstats["per_coordinate"].items():
        warm_cs = warm_stats["per_coordinate"][nm]
        lk = cs["entity_lookups"] - warm_cs["entity_lookups"]
        cd = cs["cold_lookups"] - warm_cs["cold_lookups"]
        out["cold_entity_rate_by_coordinate"][nm] = (
            round(cd / lk, 4) if lk else None
        )
    out["batches"] = batches
    out["dispatch_errors"] = delta("dispatch_errors")
    stage_s = delta("staging_seconds")
    out["staged_batches"] = delta("staged_batches")
    out["staging_overlap_fraction"] = (
        round(delta("staging_overlapped_seconds") / stage_s, 4)
        if stage_s > 0 else None
    )
    # Live monitoring: the sliding window's quantiles (warmup ages out
    # of the ring; the whole-run percentiles above cannot), the SLO
    # burn report and each coordinate's hottest entities.
    out["window_latency"] = queue.latency.quantiles_ms()
    if queue.slo_tracker is not None:
        out["slo"] = queue.slo_tracker.report()
    out["hot_entities"] = {
        nm: [{"key": it["key"], "count": it["count"], "error": it["error"]}
             for it in items]
        for nm, items in queue.hotness_top(5).items()
    }
    from photon_tpu_torch import obs

    if obs.enabled():
        # Outcome counts and mean segment milliseconds over the ring's
        # request records (warmup included; the full stream is
        # obs.trace.write_request_jsonl).
        out["request_trace"] = obs.trace.request_summary()
    if obs.health.enabled():
        # The serve tap's view of this drive: sampled batch and request
        # counts and the score and request-feature sketch summaries.
        out["health_tap"] = obs.health.serve_snapshot()
    return out
