"""One timeline for everything: trace events and the Chrome-trace export
(port of ``photon_tpu/obs/trace.py``).

A ``trace.json`` that Perfetto or chrome://tracing renders, every source
on one clock:

- **host spans** from the span tracer become complete ("X") slices on
  per-thread tracks (the ingest pools, the serve worker and the
  training thread each get their own);
- **instant events** (``instant()``) mark points in time: injected
  faults firing, retry attempts, circuit-breaker trips, CD rollbacks,
  profiler start and stop;
- **counter samples** (``counter()``) are time series (the serve queue
  depth after every batch); at export every registry counter and gauge
  adds its final value as a one-sample track;
- **request records** (``request()``) are the serving layer's
  per-request span trees (queue wait, batch fill, dispatch, scatter),
  rendered as async slices per request id;
- **convergence traces** become counter tracks inside their fit's
  ``fused_fit`` span (none yet in the port, ``obs/convergence.py``).

All of it is host bookkeeping on ``time.perf_counter``, the clock the
span tracer stamps, and recording is gated on the one telemetry flag:
disabled, every emit is one flag check. Nothing here launches device
work, so a captured CUDA graph is the same with tracing on or off.

``profile_session`` is the device-profiling entry point: the block runs
under ``torch.profiler`` (CPU and CUDA activities) inside an obs span
bracketed by ``profile.start``/``profile.stop`` instants, and the
profiler's Chrome trace is exported into the session's directory.

The ring is bounded (``set_retention``; default 8192 events, the oldest
dropped first and counted by ``dropped()``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

_DEFAULT_MAX_EVENTS = 8192

# ``_lock`` guards the event ring and its drop counter; events come from
# every thread the runtime owns (the serve worker, retry sites, the
# training thread) and exporters read snapshots taken under it.
_lock = threading.Lock()
_events: deque = deque(maxlen=_DEFAULT_MAX_EVENTS)
_dropped = 0

# The request-record outcome taxonomy (OBSERVABILITY.md): every request
# minted at MicroBatchQueue.submit resolves to exactly one of these.
REQUEST_OUTCOMES = (
    "served",     # scored; full segment tree present
    "expired",    # deadline lapsed while queued (failed before dispatch)
    "shed",       # rejected at submit: queue depth at the shed watermark
    "breaker",    # rejected/drained: dispatch circuit breaker open
    "closed",     # rejected at submit: queue already closed
    "error",      # its batch's dispatch raised; error fanned out
    "shutdown",   # stranded by a bounded close() timeout
)


def _enabled() -> bool:
    from photon_tpu_torch import obs

    return obs.TRACER.enabled


def _append(rec: dict) -> None:
    global _dropped
    evicted = False
    with _lock:
        if len(_events) == _events.maxlen:
            _dropped += 1
            evicted = True
        _events.append(rec)
    if evicted:
        # Outside the ring lock (never nested with the registry's):
        # retention pressure is alertable, not just a snapshot header.
        from photon_tpu_torch.obs.metrics import REGISTRY

        REGISTRY.counter("trace_events_dropped_total").inc()


def instant(name: str, *, cat: str = "event", **args) -> None:
    """Record a point-in-time event (no-op when telemetry is disabled)."""
    if not _enabled():
        return
    _append({
        "kind": "instant",
        "name": name,
        "cat": cat,
        "ts": time.perf_counter(),
        "thread": threading.current_thread().name,
        "args": args,
    })


def counter(name: str, value: float, *, ts: float | None = None) -> None:
    """Record one counter-track sample (no-op when disabled). ``ts`` is a
    ``time.perf_counter`` stamp; defaults to now."""
    if not _enabled():
        return
    _append({
        "kind": "counter",
        "name": name,
        "ts": time.perf_counter() if ts is None else float(ts),
        "value": float(value),
    })


def request(record: dict) -> None:
    """Record one serving request's span-tree record (no-op when
    disabled). Required keys: ``id``, ``outcome`` (REQUEST_OUTCOMES),
    ``submit_ts``, ``done_ts``; served requests also carry ``take_ts``,
    ``dispatch_ts``, ``scatter_ts``, ``batch``, ``batch_size``."""
    if not _enabled():
        return
    _append({"kind": "request", **record})


def events() -> list[dict]:
    """Snapshot of the event ring (record order; bounded — ``dropped()``
    counts the evicted)."""
    with _lock:
        return list(_events)


def request_records() -> list[dict]:
    """The ring's request records only (the per-request JSONL payload)."""
    return [e for e in events() if e["kind"] == "request"]


def dropped() -> int:
    with _lock:
        return _dropped


def request_summary(records: list[dict] | None = None) -> dict:
    """Aggregate view of the ring's request records (the serving
    driver's / CLI's ``request_trace`` stats block): outcome counts and
    per-segment mean milliseconds over the requests that carry each
    segment."""
    recs = request_records() if records is None else list(records)
    outcomes: dict[str, int] = {}
    segments: dict[str, list[float]] = {
        name: [] for name, _, _ in REQUEST_SEGMENTS
    }
    for rec in recs:
        outcome = rec.get("outcome", "unknown")
        outcomes[outcome] = outcomes.get(outcome, 0) + 1
        for name, a, b in REQUEST_SEGMENTS:
            if a in rec and b in rec and rec[b] >= rec[a]:
                segments[name].append(rec[b] - rec[a])
    return {
        "records": len(recs),
        "outcomes": dict(sorted(outcomes.items())),
        "segment_mean_ms": {
            name: round(sum(vals) / len(vals) * 1e3, 3)
            for name, vals in segments.items()
            if vals
        },
    }


def set_retention(max_events: int) -> None:
    """Rebind the event ring to a new bound (the newest events are
    kept). Events a shrinking bound evicts count as drops — the same
    accounting as ring overflow. The spans ring has the analogous
    ``obs.set_span_retention``."""
    if max_events < 1:
        raise ValueError(f"event retention must be >= 1, got {max_events}")
    global _events, _dropped
    with _lock:
        evicted = max(0, len(_events) - int(max_events))
        _events = deque(_events, maxlen=int(max_events))
        _dropped += evicted
    if evicted:
        from photon_tpu_torch.obs.metrics import REGISTRY

        REGISTRY.counter("trace_events_dropped_total").inc(evicted)


def reset() -> None:
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0


# --------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# --------------------------------------------------------------------------

# Request span-tree segments, in tree order: (slice name, start key,
# end key). A record missing a segment's keys (non-served outcomes)
# renders only the root request slice.
REQUEST_SEGMENTS = (
    ("queue_wait", "submit_ts", "take_ts"),
    ("batch_fill", "take_ts", "dispatch_ts"),
    ("dispatch", "dispatch_ts", "scatter_ts"),
    ("scatter", "scatter_ts", "done_ts"),
)


def _us(t: float) -> float:
    # perf_counter seconds -> chrome-trace microseconds (µs precision
    # kept to 1ns; Perfetto takes floats).
    return round(t * 1e6, 3)


def _request_chrome_events(rec: dict, pid: int) -> list[dict]:
    """One request record -> async ("b"/"e") slices: a root `request`
    slice spanning submit→done plus one nested slice per present
    segment. Perfetto groups async slices by (cat, id) — every request
    renders as its own lane."""
    rid = str(rec["id"])
    cat = "serve.request"
    args = {
        k: rec[k]
        for k in ("outcome", "batch", "batch_size", "error")
        if k in rec
    }
    out = [{
        "name": "request", "cat": cat, "ph": "b", "id": rid,
        "pid": pid, "ts": _us(rec["submit_ts"]), "args": args,
    }]
    for name, a, b in REQUEST_SEGMENTS:
        if a in rec and b in rec and rec[b] >= rec[a]:
            out.append({"name": name, "cat": cat, "ph": "b", "id": rid,
                        "pid": pid, "ts": _us(rec[a])})
            out.append({"name": name, "cat": cat, "ph": "e", "id": rid,
                        "pid": pid, "ts": _us(rec[b])})
    out.append({"name": "request", "cat": cat, "ph": "e", "id": rid,
                "pid": pid, "ts": _us(rec["done_ts"])})
    return out


def chrome_trace() -> dict:
    """Everything on one timeline, as a chrome-trace JSON object.

    Merges (all on the shared ``perf_counter`` clock): completed spans
    as per-thread "X" slices, ring instants/counters, request records as
    async slice trees, the metrics registry's final counter/gauge values
    as one-sample counter tracks, and convergence series as counter
    tracks aligned inside their ``fused_fit`` span windows.
    """
    from photon_tpu_torch import obs
    from photon_tpu_torch.obs import convergence

    pid = os.getpid()
    out: list[dict] = []
    tids: dict[str, int] = {}

    def tid_for(thread: str) -> int:
        t = tids.get(thread)
        if t is None:
            t = tids[thread] = len(tids) + 1
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": t, "args": {"name": thread}})
        return t

    spans = obs.TRACER.completed()
    for sp in spans:
        args: dict = {"path": sp.path}
        if sp.attrs:
            args.update(sp.attrs)
        if sp.device_wait_seconds is not None:
            args["device_wait_seconds"] = round(sp.device_wait_seconds, 6)
        out.append({
            "name": sp.name, "cat": "span", "ph": "X",
            "ts": _us(sp.t0), "dur": _us(max(sp.t1 - sp.t0, 0.0)),
            "pid": pid, "tid": tid_for(sp.thread), "args": args,
        })

    for ev in events():
        kind = ev["kind"]
        if kind == "instant":
            out.append({
                "name": ev["name"], "cat": ev.get("cat", "event"),
                "ph": "i", "s": "t", "ts": _us(ev["ts"]), "pid": pid,
                "tid": tid_for(ev.get("thread", "events")),
                "args": dict(ev.get("args") or {}),
            })
        elif kind == "counter":
            out.append({
                "name": ev["name"], "ph": "C", "ts": _us(ev["ts"]),
                "pid": pid, "args": {"value": ev["value"]},
            })
        else:  # request
            out.extend(_request_chrome_events(ev, pid))

    # Metrics-as-counter-tracks: every registry counter/gauge closes its
    # track with the final value, sampled at export time (live samples,
    # where instrumented, already rode the ring above).
    now_ts = _us(time.perf_counter())
    snap = obs.REGISTRY.snapshot()
    for series, value in sorted(snap["counters"].items()):
        out.append({"name": series, "ph": "C", "ts": now_ts, "pid": pid,
                    "args": {"value": value}})
    for series, value in sorted(snap["gauges"].items()):
        out.append({"name": series, "ph": "C", "ts": now_ts, "pid": pid,
                    "args": {"value": value}})

    # Convergence series -> counter tracks aligned inside their fit's
    # span window. Pairing is presentation-layer: the LAST k parked
    # traces align with the LAST k `fused_fit` spans (both record in
    # completion order on the training thread; the rings bound
    # differently, so only the common tail pairs). Per-iteration values
    # spread evenly across the span — the fit program gives no
    # per-iteration host timestamps, by design.
    fused = [sp for sp in spans if sp.name == "fused_fit"]
    conv = convergence.traces()
    k = min(len(fused), len(conv))
    for fit_span, fit_trace in zip(fused[-k:] if k else [], conv[-k:]):
        t0, dt = fit_span.t0, max(fit_span.t1 - fit_span.t0, 0.0)
        for cid, by_metric in fit_trace.items():
            for metric, values in by_metric.items():
                n = len(values) or 1
                for i, v in enumerate(values):
                    out.append({
                        "name": f"convergence:{cid}:{metric}",
                        "ph": "C",
                        "ts": _us(t0 + dt * (i + 1) / n),
                        "pid": pid, "args": {"value": v},
                    })

    from photon_tpu_torch.obs import fleet

    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "photon_tpu_torch.obs.trace",
            "schema": 1,
            "spans_dropped": obs.TRACER.dropped,
            "events_dropped": dropped(),
            "host": fleet.host_identity(),
        },
    }


def write_chrome_trace(path: str) -> int:
    """Write ``chrome_trace()`` to ``path``; returns the event count."""
    doc = chrome_trace()
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


_CHROME_PHASES = frozenset({"X", "i", "I", "C", "b", "e", "n", "M"})


def validate_chrome_trace(path: str) -> int:
    """Validate a chrome-trace JSON file (what a viewer needs to load
    it).

    Raises ValueError on the first violation; returns the event count.
    """
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as exc:
            raise ValueError(f"{path}: not JSON ({exc})")
    if not isinstance(doc, dict) or not isinstance(
        doc.get("traceEvents"), list
    ):
        raise ValueError(
            f"{path}: not a chrome-trace object (traceEvents missing)"
        )
    evs = doc["traceEvents"]
    if not evs:
        raise ValueError(f"{path}: empty traceEvents")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"{path}: traceEvents[{i}] is not an object")
        ph = ev.get("ph")
        if ph not in _CHROME_PHASES:
            raise ValueError(
                f"{path}: traceEvents[{i}] has unknown phase {ph!r}"
            )
        if not isinstance(ev.get("pid"), int):
            raise ValueError(f"{path}: traceEvents[{i}] missing int pid")
        if ph == "M":
            if not isinstance(ev.get("args"), dict):
                raise ValueError(
                    f"{path}: traceEvents[{i}] metadata without args"
                )
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(
                f"{path}: traceEvents[{i}] ({ph}) missing numeric ts"
            )
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"{path}: traceEvents[{i}] complete event with bad "
                    f"dur {dur!r}"
                )
        if ph == "C":
            value = (ev.get("args") or {}).get("value")
            if not isinstance(value, (int, float)):
                raise ValueError(
                    f"{path}: traceEvents[{i}] counter without numeric "
                    "args.value"
                )
        if ph in ("b", "e") and ("id" not in ev or "cat" not in ev):
            raise ValueError(
                f"{path}: traceEvents[{i}] async event without id/cat"
            )
    return len(evs)


def write_request_jsonl(path: str) -> int:
    """Write the per-request JSONL stream (header + one ``request``
    record per line; same schema `validate_jsonl` enforces). Returns the
    line count."""
    from photon_tpu_torch import obs

    lines: list[dict] = [{
        "type": "telemetry",
        "version": 1,
        "spans_dropped": obs.TRACER.dropped,
        "events_dropped": dropped(),
    }]
    for rec in request_records():
        lines.append({
            "type": "request",
            **{k: v for k, v in rec.items() if k != "kind"},
        })
    with open(path, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return len(lines)


# --------------------------------------------------------------------------
# the profiler entry point
# --------------------------------------------------------------------------


@contextlib.contextmanager
def profile_session(trace_dir: str | None, *, name: str = "torch_profiler"):
    """The device-profiling entry point.

    A falsy ``trace_dir`` is a no-op that never imports
    ``torch.profiler``, so call sites wire it unconditionally. With a
    directory, the block runs under ``torch.profiler.profile`` with the
    CPU and CUDA activities (CPU only where there is no card) inside a
    ``<name>`` obs span carrying the directory, bracketed by
    ``profile.start``/``profile.stop`` instants: the profile's window is
    the span's. On exit the profiler's Chrome trace is written to
    ``<trace_dir>/<name>-<pid>.pt.trace.json``.
    """
    if not trace_dir:
        yield
        return
    import torch
    import torch.profiler as tp

    from photon_tpu_torch import obs

    activities = [tp.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(tp.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name}-{os.getpid()}.pt.trace.json")
    instant("profile.start", cat="profiler", trace_dir=trace_dir)
    try:
        with obs.span(name, attrs={"trace_dir": trace_dir}):
            with tp.profile(activities=activities) as prof:
                yield
            prof.export_chrome_trace(path)
    finally:
        instant("profile.stop", cat="profiler", trace_dir=trace_dir)
