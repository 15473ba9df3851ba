"""The serving micro-batch queue: bounded, lingering, draining, degrading
(port of ``photon_tpu/serve/queue.py``).

One worker thread owns every dispatch; producers hand
``(features, entity_ids)`` pairs to ``submit`` and get a future back. A
batch dispatches when it reaches ``max_batch`` requests (clamped to the
ladder's top rung) or when its oldest request has lingered
``max_linger_s``. The queue is bounded (``max_queue``): producers block
for space.

Degraded mode. Deadlines, shedding and the circuit breaker are off by
default; dispatch retry is on (``dispatch_retry=_DISPATCH_RETRY``: 3
attempts, 5 ms base backoff), and ``dispatch_retry=None`` fails on the
first attempt.

- **Deadlines**: a request submitted with ``deadline_s`` (or the
  queue's ``default_deadline_s``) that is still queued when it expires
  fails with ``DeadlineExceededError`` before any device work is spent
  on it. A deadline also cuts the linger short: a batch whose earliest
  deadline would lapse mid-linger flushes ``_DEADLINE_FLUSH_SLACK_S``
  early, so a deadline tighter than the linger is served.
- **Shedding**: with ``shed_watermark`` set, a submit that finds that
  many requests queued is rejected at once with ``OverloadedError``.
- **Circuit breaker**: ``breaker_threshold`` consecutive dispatch
  failures open the breaker: the pending deque and the staged batch
  fail with ``CircuitOpenError``, new submits fail fast, and
  ``reset_breaker()`` re-arms it.
- **Dispatch retry**: transient failures (``TransientError``, such as
  the injected ``serve.dispatch`` fault, and the CUDA codes
  ``resilience.errors.is_transient`` retries) are retried with backoff
  before any error fans out; a deterministic failure (``PoisonError``, a
  malformed request, a sticky CUDA error) fans out to its batch only.
- **health()**: one locked snapshot of queue depth, the degraded-mode
  counters and the tables' generation, with the sliding-window latency
  quantiles (``window_latency``), the per-coordinate cold rates and,
  given an ``slo``, the SLO burn report.
- **reload_model() / quiesce()**: a hot model swap on the live queue.
  A values-only refresh is copied into the live tables in place, so the
  captured graphs, which hold the tables' device pointers, serve it with
  nothing recaptured. A structure change builds and captures the new
  generation's ladder off the request path, then swaps tables and the
  queue's program binding inside one ``quiesce`` window (the worker
  parks before popping; producers keep queueing; nothing is dropped).

Staging is double-buffered: while batch k is on the device the worker
pops and packs batch k+1 into fresh host arrays, so packing overlaps the
device round trip; batch k+1's dispatch copies them into the rung's
static buffers only after batch k's scores were fetched.
``pipeline_staging=False`` gives the serial worker, the parity
reference for the staged one.

``close()`` drains everything queued and resolves every future.
``close(timeout=...)`` (and ``close_timeout_s`` for the ``with`` exit)
bounds the drain: past it every still-queued future fails with
``ShutdownError`` and close returns False; the worker is a daemon, so a
wedged dispatch cannot hang process exit.

Request tracing (``photon_tpu_torch.obs.trace``): with telemetry on,
every request, served or refused, leaves one record at its outcome
(``REQUEST_OUTCOMES``) under a process-unique id minted at ``submit``,
with the served path's segment stamps (take, dispatch, scatter); each
batch is a ``serve/batch`` span, and the registry counts requests,
batches, cold lookups, expiries, retries and breaker trips.

Live monitoring (``photon_tpu_torch.obs.monitor``): every served
request's submit-to-scatter latency feeds a rolling window ring
(``latency``) and, given ``slo``, an ``SloTracker`` (``slo_tracker``),
which also counts every refused or failed request and every entity
lookup; each random coordinate's lookups feed a space-saving top-K
sketch (``hotness``, ``hotness_top``). ``metrics_families`` is the
queue's ``/metrics`` collector. With the health layer armed
(``obs.health``), a sample of the served batches (features and scores)
folds into the serve-side sketch; a tap that raises is logged and the
batch is served all the same.

Everything is recorded on the worker after ``fetch_padded`` returned
the scores as host numpy, outside ``_cond`` and outside any captured
graph: no record adds a launch, a graph capture or a copy from the
card.

Threading: ``_cond`` (a Condition, which is also the mutex) guards the
pending deque, the closed, stranded, pause and dispatching flags, the
breaker state, the staged slot, ``programs``, the counters and the
per-coordinate maps (``_coord_stats``, ``_re_types``, ``hotness``). The
latency ring, the SLO tracker and each hotness sketch keep their own
lock (``obs/monitor.py``), so a scrape never waits on ``_cond`` for more
than a dict copy. The
worker takes a batch under the lock and dispatches outside it; every
future resolution (results, errors, expiry, breaker drain, shutdown
strand) runs outside it too, because resolution runs callbacks.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import threading
import time

import numpy as np

from photon_tpu_torch.resilience import faults
from photon_tpu_torch.resilience import retry as _retry
from photon_tpu_torch.resilience.errors import (
    CircuitOpenError,
    DeadlineExceededError,
    OverloadedError,
    ShutdownError,
)

logger = logging.getLogger(__name__)


class QueueClosed(RuntimeError):
    """submit() after close()."""


class _Future:
    """Single-shot future set once by the worker. Done callbacks run on
    the worker thread at resolution; ``_lock`` keeps a callback added
    during resolution from being lost."""

    __slots__ = ("_lock", "_event", "_value", "_exc", "_callbacks",
                 "_resolved")

    def __init__(self):
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._value = None
        self._exc: BaseException | None = None
        self._callbacks: list = []
        self._resolved = False

    def _resolve(self, value, exc: BaseException | None) -> None:
        with self._lock:
            if self._resolved:
                raise RuntimeError("future resolved twice")
            self._resolved = True
            self._value = value
            self._exc = exc
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 - a raising callback must
                # not kill the worker and strand every queued future.
                logger.exception("serve future done-callback raised")
        # Set after the callbacks ran, so a waiter that sees done() may
        # rely on its callback's side effects.
        self._event.set()

    def set_result(self, value) -> None:
        self._resolve(value, None)

    def set_exception(self, exc: BaseException) -> None:
        self._resolve(None, exc)

    def add_done_callback(self, cb) -> None:
        with self._lock:
            if not self._resolved:
                self._callbacks.append(cb)
                return
        cb(self)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("score request still queued")
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("score request still queued")
        return self._exc


# Minted at every submit, refused ones included, so each request yields
# one trace record under a process-unique id.
_REQUEST_IDS = itertools.count(1)


class _Request:
    __slots__ = ("features", "entity_ids", "future", "enqueued_at",
                 "deadline", "rid", "take_ts")

    def __init__(self, features: dict, entity_ids: dict,
                 deadline_s: float | None = None):
        self.features = features
        self.entity_ids = entity_ids
        self.future = _Future()
        self.rid = next(_REQUEST_IDS)
        self.enqueued_at = time.perf_counter()
        # Stamped, with telemetry on, when the worker pops the request
        # into a batch: submit to take is the queue_wait segment.
        self.take_ts: float | None = None
        self.deadline = (None if deadline_s is None
                         else self.enqueued_at + float(deadline_s))


def _record_request(req: _Request, outcome: str, **extra) -> None:
    """One request's trace record (a no-op with telemetry off);
    ``extra`` carries the served path's stamps or the error."""
    from photon_tpu_torch import obs

    if not obs.enabled():
        return
    rec = {
        "id": req.rid,
        "outcome": outcome,
        "submit_ts": req.enqueued_at,
        "done_ts": time.perf_counter(),
    }
    if req.take_ts is not None:
        rec["take_ts"] = req.take_ts
    rec.update(extra)
    obs.trace.request(rec)


class _Staged:
    """A batch popped and packed while the previous one was in flight.
    ``programs`` pins the generation it was packed against: after a
    structure reload adopted new programs its codes name the old
    vocabulary, so ``_dispatch`` packs again. ``packed`` is None when
    packing raised; the dispatch then packs again and reports the error
    to the batch."""

    __slots__ = ("requests", "packed", "programs")

    def __init__(self, requests, packed, programs):
        self.requests = requests
        self.packed = packed
        self.programs = programs


# Two quick re-attempts: a transient dispatch failure clears in
# milliseconds or not at all, and a long backoff stacks onto the latency
# of every request queued behind the batch.
_DISPATCH_RETRY = _retry.RetryPolicy(
    max_attempts=3, base_delay_s=0.005, max_delay_s=0.1
)

# How far before the earliest pending deadline the linger flushes:
# waking at the deadline itself would expire the request in the scan
# meant to save it, and Condition.wait oversleeps by scheduler jitter.
_DEADLINE_FLUSH_SLACK_S = 25e-3

class MicroBatchQueue:
    """Bounded micro-batching front of a ``ScorePrograms`` ladder."""

    def __init__(
        self,
        programs,
        *,
        max_batch: int | None = None,
        max_linger_s: float = 0.002,
        max_queue: int = 4096,
        default_deadline_s: float | None = None,
        shed_watermark: int | None = None,
        breaker_threshold: int | None = None,
        dispatch_retry: "_retry.RetryPolicy | None" = _DISPATCH_RETRY,
        pipeline_staging: bool = True,
        close_timeout_s: float | None = None,
        slo=None,
        latency_window_s: float = 10.0,
        latency_windows: int = 6,
        hotness_k: int = 64,
    ):
        from photon_tpu_torch.obs.monitor import (
            RollingHistogram,
            SloTracker,
        )

        self.programs = programs
        top = programs.ladder.max_batch
        self.max_batch = min(
            top if max_batch is None else int(max_batch), top
        )
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_linger_s = float(max_linger_s)
        self.max_queue = max(int(max_queue), self.max_batch)
        self.default_deadline_s = default_deadline_s
        self.shed_watermark = (None if shed_watermark is None
                               else max(int(shed_watermark), 1))
        self.breaker_threshold = (None if breaker_threshold is None
                                  else max(int(breaker_threshold), 1))
        self.dispatch_retry = dispatch_retry
        self.pipeline_staging = bool(pipeline_staging)
        self.close_timeout_s = close_timeout_s
        self._cond = threading.Condition()
        self._pending: collections.deque[_Request] = collections.deque()
        self._closed = False
        self._close_stranded = False
        self._breaker_open = False
        self._consecutive_failures = 0
        # While ``_paused`` the worker parks before popping;
        # ``_dispatching`` is True from a batch's pop to its dispatch's
        # return, so ``quiesce`` can wait out the batch in flight.
        self._paused = False
        self._dispatching = False
        self._staged: _Staged | None = None
        # Latched by the first deadline-bearing submit, so the expiry
        # scan stays off the clean path.
        self._has_deadlines = default_deadline_s is not None
        self._stats = {
            "requests": 0,
            "batches": 0,
            "batched_requests": 0,
            "cold_lookups": 0,
            "entity_lookups": 0,
            "rejected": 0,
            "dispatch_errors": 0,
            "dispatch_retries": 0,
            "deadline_expired": 0,
            "shed": 0,
            "breaker_trips": 0,
            "breaker_rejected": 0,
            "shutdown_stranded": 0,
            # staged_batches: batches packed ahead of their dispatch;
            # staging_seconds: all host pack time;
            # staging_overlapped_seconds: the part hidden behind a
            # batch in flight.
            "staged_batches": 0,
            "staging_seconds": 0.0,
            "staging_overlapped_seconds": 0.0,
        }
        self._coord_stats = {
            name: {"entity_lookups": 0, "cold_lookups": 0}
            for name in self._random_tables(programs)
        }
        self.latency = RollingHistogram(
            window_s=latency_window_s, num_windows=latency_windows)
        self.slo_tracker = None if slo is None else SloTracker(slo)
        self._hotness_k = int(hotness_k)
        self._re_types: dict = {}
        self.hotness: dict = {}
        self._bind_coordinates_locked(programs)
        self._thread = threading.Thread(
            target=self._worker, name="photon-torch-serve-worker",
            # A dispatch wedged in native code must not hang exit.
            daemon=True,
        )
        self._thread.start()

    @staticmethod
    def _random_tables(programs) -> dict:
        return getattr(getattr(programs, "tables", None), "random",
                       None) or {}

    # -- producer side ----------------------------------------------------

    def submit(self, features: dict, entity_ids: dict | None = None,
               *, deadline_s: float | None = None):
        """Queue one request; returns its future.

        ``features`` maps shard id -> the spec's request leaf,
        ``entity_ids`` maps random-effect type -> entity key, and
        ``deadline_s`` (default: the queue's ``default_deadline_s``)
        bounds how long it may wait queued. Blocks while the queue holds
        ``max_queue`` requests unless ``shed_watermark`` rejects first;
        raises ``QueueClosed``, ``CircuitOpenError`` or
        ``OverloadedError`` instead of queueing.
        """
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req = _Request(features, dict(entity_ids or {}), deadline_s)
        rejection = None  # (outcome, exc), recorded outside the lock
        with self._cond:
            while True:
                if self._closed:
                    self._stats["rejected"] += 1
                    rejection = ("closed",
                                 QueueClosed("serve queue is closed"))
                    break
                if self._breaker_open:
                    self._stats["breaker_rejected"] += 1
                    rejection = ("breaker", CircuitOpenError(
                        "serve dispatch circuit breaker is open (tripped "
                        f"after {self.breaker_threshold} consecutive batch "
                        "failures); reset_breaker() to resume"))
                    break
                if (self.shed_watermark is not None
                        and len(self._pending) >= self.shed_watermark):
                    self._stats["shed"] += 1
                    rejection = ("shed", OverloadedError(
                        f"serve queue depth {len(self._pending)} is at the "
                        f"shed watermark {self.shed_watermark}; request "
                        "rejected instead of queued"))
                    break
                if len(self._pending) < self.max_queue:
                    break
                self._cond.wait()
            if rejection is None:
                if req.deadline is not None:
                    self._has_deadlines = True
                self._pending.append(req)
                self._stats["requests"] += 1
                self._cond.notify_all()
        if rejection is not None:
            outcome, exc = rejection
            _record_request(req, outcome)
            if self.slo_tracker is not None:
                self.slo_tracker.observe_errors(1)
            raise exc
        return req.future

    def close(self, timeout: float | None = None) -> bool:
        """Stop accepting requests, drain everything queued, join the
        worker. Idempotent.

        ``timeout`` bounds the drain and join: past it, every request
        still queued (never handed to the worker) fails with
        ``ShutdownError`` and close returns False; the batch in flight
        stays with the worker, which resolves it if its dispatch ever
        returns. Once a bounded close has stranded the queue, a later
        ``close()`` without a timeout polls the worker instead of
        joining it forever.
        """
        with self._cond:
            self._closed = True
            already_stranded = self._close_stranded
            self._cond.notify_all()
        if already_stranded and timeout is None:
            timeout = 0.0
        self._thread.join(timeout)
        if not self._thread.is_alive():
            return True
        if already_stranded:
            return False
        with self._cond:
            self._close_stranded = True
            stranded = list(self._pending)
            self._pending.clear()
            self._stats["shutdown_stranded"] += len(stranded)
            self._cond.notify_all()
        logger.error(
            "serve queue close(): drain did not finish in %.3fs; failing "
            "%d still-queued request(s) with ShutdownError",
            timeout, len(stranded))
        exc = ShutdownError(
            f"serve queue drain exceeded its {timeout}s close timeout; "
            "request abandoned before dispatch")
        for r in stranded:
            r.future.set_exception(exc)
            _record_request(r, "shutdown")
        if self.slo_tracker is not None:
            self.slo_tracker.observe_errors(len(stranded))
        return False

    def reset_breaker(self) -> None:
        """Re-arm a tripped dispatch circuit breaker (after the failure
        behind it was dealt with)."""
        with self._cond:
            self._breaker_open = False
            self._consecutive_failures = 0
            self._cond.notify_all()

    @contextlib.contextmanager
    def quiesce(self):
        """Hold dispatch for the block: entering waits out the batch in
        flight; while held the worker parks before popping and producers
        keep queueing. Not reentrant; ``close()`` overrides a held pause
        so shutdown still drains."""
        with self._cond:
            self._paused = True
            while self._dispatching:
                self._cond.wait()
        try:
            yield self
        finally:
            with self._cond:
                self._paused = False
                self._cond.notify_all()

    def _adopt_programs_locked(self, programs) -> None:
        """Rebind the queue to a new generation's ``ScorePrograms``
        (the caller holds ``_cond`` and the quiesce pause, so no
        dispatch straddles generations). Per-coordinate counters carry
        over where the coordinate survives and start at zero where it
        is new; so do the hotness sketches."""
        self.programs = programs
        self.max_batch = min(self.max_batch, programs.ladder.max_batch)
        self._coord_stats = {
            name: self._coord_stats.get(
                name, {"entity_lookups": 0, "cold_lookups": 0})
            for name in self._random_tables(programs)
        }
        self._bind_coordinates_locked(programs)

    def _bind_coordinates_locked(self, programs) -> None:
        """Each random coordinate's entity type and hotness sketch (kept
        where the coordinate survives a reload)."""
        from photon_tpu_torch.obs.monitor import SpaceSavingSketch

        tables = self._random_tables(programs)
        self._re_types = {name: t.random_effect_type
                          for name, t in tables.items()}
        self.hotness = {
            name: self.hotness.get(name)
            or SpaceSavingSketch(self._hotness_k)
            for name in tables
        }

    def reload_model(self, model) -> dict:
        """Hot-swap a refreshed ``GameModel`` into the live queue.

        Values-only delta (a daily retrain): the new coefficients are
        copied into the live tables in place; the captured graphs read
        them at their next replay and nothing is recaptured. On the card
        the copy is ordered on the stream between two replays and needs
        no pause; on the CPU the worker's eager dispatch reads the
        tables from its own thread, so the copy waits out the batch in
        flight (``quiesce``) rather than tear a row under it.

        Structure change: the new tables and their ladder (one graph
        captured per rung, on a side stream) are built off the request
        path while the old generation serves, then swapped in with the
        queue's program binding inside one ``quiesce`` window, and the
        old ladder's graphs are released. No queued request is dropped.

        Returns ``values_only``, ``generation``, ``programs_compiled``
        (graphs captured), and for a structure change
        ``capture_seconds``, ``quiesce_seconds`` (how long the worker
        was parked), ``graph_device_bytes`` of the new ladder and
        ``released_device_bytes`` of the old one.
        """
        from photon_tpu_torch.serve.tables import CoefficientTables

        tables = self.programs.tables
        # Built at the live precision and device: a bf16 queue
        # reloading an f32-trained model stays values-only.
        new = CoefficientTables.from_game_model(
            model, tables.precision, tables.device)
        if tables._values_only_delta(new):
            if tables.device.type == "cuda":
                tables._reload_built(new)
            else:
                with self.quiesce():
                    tables._reload_built(new)
            return {"values_only": True, "generation": tables.generation,
                    "programs_compiled": 0}

        old = self.programs
        parked: dict = {}

        @contextlib.contextmanager
        def timed_quiesce():
            t0 = time.perf_counter()
            with self.quiesce():
                yield
            parked["quiesce_seconds"] = time.perf_counter() - t0

        def adopt(new_programs):
            with self._cond:
                self._adopt_programs_locked(new_programs)

        new_programs = tables.rebuild_from(
            model, programs=old, quiesce=timed_quiesce, adopt=adopt,
            prebuilt=new)
        released = old.release()
        stats = new_programs.stats
        return {
            "values_only": False,
            "generation": tables.generation,
            "programs_compiled": stats["programs_compiled"],
            "capture_seconds": stats["aot_compile_seconds"],
            "quiesce_seconds": parked["quiesce_seconds"],
            "graph_device_bytes": stats["graph_device_bytes"],
            "released_device_bytes": released,
        }

    def __enter__(self) -> "MicroBatchQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close(self.close_timeout_s)

    def stats(self) -> dict:
        """Snapshot of the counters, with derived fill, cold and overlap
        rates and the per-coordinate lookups."""
        with self._cond:
            snap = dict(self._stats)
            snap["queued_now"] = len(self._pending)
            per_coord = {
                nm: dict(cs) for nm, cs in self._coord_stats.items()
            }
        for cs in per_coord.values():
            cs["cold_entity_rate"] = (
                round(cs["cold_lookups"] / cs["entity_lookups"], 4)
                if cs["entity_lookups"] else None
            )
        snap["per_coordinate"] = per_coord
        batches = snap["batches"]
        snap["batch_fill_fraction"] = (
            round(snap["batched_requests"] / (batches * self.max_batch), 4)
            if batches else None)
        snap["mean_batch_size"] = (
            round(snap["batched_requests"] / batches, 2)
            if batches else None)
        snap["cold_entity_rate"] = (
            round(snap["cold_lookups"] / snap["entity_lookups"], 4)
            if snap["entity_lookups"] else None
        )
        snap["staging_overlap_fraction"] = self._overlap(snap)
        return snap

    @staticmethod
    def _overlap(stats: dict) -> float | None:
        """Share of the host pack time hidden behind a batch in flight
        (0 on the serial worker, None before any pack)."""
        if stats["staging_seconds"] <= 0:
            return None
        return round(stats["staging_overlapped_seconds"]
                     / stats["staging_seconds"], 4)

    def health(self) -> dict:
        """One consistent degraded-mode snapshot: queue depth, breaker
        state, the shed, deadline, error, retry, breaker and shutdown
        counters, the configuration and the tables' reload generation;
        then, each under its own lock, the sliding-window latency
        quantiles (``window_latency``) and, given an ``slo``, its burn
        report (``slo``)."""
        with self._cond:
            s = self._stats
            per_coord = {
                nm: dict(cs) for nm, cs in self._coord_stats.items()
            }
            snap = {
                "queue_depth": len(self._pending),
                "closed": self._closed,
                "breaker_open": self._breaker_open,
                "consecutive_failures": self._consecutive_failures,
                **{k: s[k] for k in (
                    "requests", "shed", "deadline_expired",
                    "dispatch_errors", "dispatch_retries", "breaker_trips",
                    "breaker_rejected", "shutdown_stranded",
                    "staged_batches")},
                "staging_overlap_fraction": self._overlap(s),
            }
            generation = getattr(self.programs.tables, "generation", 0)
        snap["pipeline_staging"] = self.pipeline_staging
        snap["max_queue"] = self.max_queue
        snap["shed_watermark"] = self.shed_watermark
        snap["breaker_threshold"] = self.breaker_threshold
        snap["default_deadline_s"] = self.default_deadline_s
        snap["table_generation"] = generation
        window = self.latency.quantiles_ms()
        window["window_seconds"] = (
            self.latency.window_s * self.latency.num_windows)
        snap["window_latency"] = window
        snap["cold_entity_rate_by_coordinate"] = {
            nm: (round(cs["cold_lookups"] / cs["entity_lookups"], 4)
                 if cs["entity_lookups"] else None)
            for nm, cs in per_coord.items()
        }
        if self.slo_tracker is not None:
            snap["slo"] = self.slo_tracker.report()
        return snap

    def hotness_top(self, n: int = 10) -> dict:
        """Per-coordinate top-``n`` hottest entities (space-saving
        sketch: counts overestimate by at most their recorded error)."""
        with self._cond:
            sketches = dict(self.hotness)
        return {nm: sketch.top(n) for nm, sketch in sketches.items()}

    def metrics_families(self) -> list[dict]:
        """The queue's ``/metrics`` collector (register with
        ``MonitorServer(collectors=[queue.metrics_families])``): live
        depth/breaker gauges, per-coordinate cold counters, the
        windowed-latency histogram + quantile gauges, hotness top-K,
        and the SLO burn gauges. Every number is copied under its own
        surface's lock and rendered lockless."""
        from photon_tpu_torch.obs import monitor

        with self._cond:
            depth = len(self._pending)
            breaker = self._breaker_open
            closed = self._closed
            stats = dict(self._stats)
            per_coord = {
                nm: dict(cs) for nm, cs in self._coord_stats.items()
            }
        fams = [
            monitor.family(
                "serve_queue_depth_live", "gauge",
                "requests queued at scrape time", [("", {}, depth)],
            ),
            monitor.family(
                "serve_breaker_open_live", "gauge",
                "1 when the dispatch circuit breaker is open",
                [("", {}, float(breaker))],
            ),
            monitor.family(
                "serve_queue_closed", "gauge",
                "1 once close() was called", [("", {}, float(closed))],
            ),
            monitor.family(
                "serve_queue_requests_total", "counter",
                "requests accepted by the queue",
                [("", {}, float(stats["requests"]))],
            ),
            monitor.family(
                "serve_staging_overlap_fraction", "gauge",
                "fraction of host pack time overlapped with the batch "
                "in flight by the pipelined worker",
                [(
                    "", {},
                    (
                        stats["staging_overlapped_seconds"]
                        / stats["staging_seconds"]
                    )
                    if stats["staging_seconds"] > 0
                    else 0.0,
                )],
            ),
            monitor.family(
                "serve_staged_batches_total", "counter",
                "batches popped and host-packed ahead of dispatch",
                [("", {}, float(stats["staged_batches"]))],
            ),
            monitor.family(
                "serve_queue_events_total", "counter",
                "degraded-mode queue events by kind",
                [
                    ("", {"kind": k}, float(stats[k]))
                    for k in (
                        "shed", "deadline_expired", "dispatch_errors",
                        "dispatch_retries", "breaker_trips",
                        "breaker_rejected", "shutdown_stranded",
                    )
                ],
            ),
            monitor.family(
                "serve_entity_lookups_total", "counter",
                "entity lookups per random-effect coordinate",
                [
                    ("", {"coordinate": nm}, float(cs["entity_lookups"]))
                    for nm, cs in sorted(per_coord.items())
                ],
            ),
            monitor.family(
                "serve_cold_entity_lookups_total", "counter",
                "cold (out-of-vocabulary) lookups per coordinate",
                [
                    ("", {"coordinate": nm}, float(cs["cold_lookups"]))
                    for nm, cs in sorted(per_coord.items())
                ],
            ),
            self.latency.prometheus_family(
                "serve_request_latency_window_seconds",
                "submit-to-scatter latency over the sliding window (last "
                f"{self.latency.window_s * self.latency.num_windows:g}s)",
            ),
        ]
        quantiles = self.latency.quantiles_ms()
        fams.append(
            monitor.family(
                "serve_request_latency_window_ms", "gauge",
                "sliding-window latency quantiles, milliseconds",
                [
                    ("", {"quantile": str(int(q[1:q.index('_')]) / 100)}, v)
                    for q, v in quantiles.items()
                    if q.startswith("p") and v is not None
                ],
            )
        )
        hot_samples = [
            ("", {"coordinate": nm, "entity": item["key"]},
             float(item["count"]))
            for nm, items in sorted(self.hotness_top(10).items())
            for item in items
        ]
        if hot_samples:
            fams.append(
                monitor.family(
                    "serve_hot_entity_requests", "gauge",
                    "space-saving sketch count per hot entity "
                    "(overestimates by at most the sketch error)",
                    hot_samples,
                )
            )
        if self.slo_tracker is not None:
            fams.extend(self.slo_tracker.prometheus_families())
        return fams

    # -- worker side ------------------------------------------------------

    def _expire_locked(self) -> list[_Request]:
        """Pull every pending request whose deadline has passed (the
        caller holds ``_cond``; the caller resolves them outside it).
        Skipped until a deadline-bearing request was ever submitted."""
        if not self._has_deadlines or not self._pending:
            return []
        now = time.perf_counter()
        expired = [r for r in self._pending
                   if r.deadline is not None and now >= r.deadline]
        if expired:
            self._pending = collections.deque(
                r for r in self._pending
                if r.deadline is None or now < r.deadline)
            self._stats["deadline_expired"] += len(expired)
            self._cond.notify_all()  # space freed: wake producers
        return expired

    def _pop_locked(self) -> list[_Request]:
        from photon_tpu_torch import obs

        batch = [self._pending.popleft()
                 for _ in range(min(len(self._pending), self.max_batch))]
        if batch:
            self._stats["batches"] += 1
            self._stats["batched_requests"] += len(batch)
            if obs.enabled():
                now = time.perf_counter()
                for r in batch:
                    r.take_ts = now
        self._cond.notify_all()  # space freed: wake producers
        return batch

    def _take_batch(self):
        """Block for the next batch per the flush policy.

        Returns ``(batch, expired, depth, breaker_open)``: ``batch`` is
        None once the queue is closed and drained, and empty when this
        round only expired requests; ``expired`` failed their deadline
        while queued and are resolved by the caller, outside the lock,
        before any device work is spent on the batch; ``depth`` and
        ``breaker_open`` are read under the same hold.
        """
        with self._cond:
            while True:
                # Quiesced: park without popping; close() overrides the
                # pause so a quiesced queue still drains.
                while self._paused and not self._closed:
                    self._cond.wait()
                expired = self._expire_locked()
                if self._pending:
                    linger_end = (self._pending[0].enqueued_at
                                  + self.max_linger_s)
                    while (len(self._pending) < self.max_batch
                           and not self._closed and not self._paused):
                        flush_at = linger_end
                        if self._has_deadlines:
                            earliest = min(
                                (r.deadline for r in self._pending
                                 if r.deadline is not None),
                                default=None)
                            if earliest is not None:
                                flush_at = min(
                                    flush_at,
                                    earliest - _DEADLINE_FLUSH_SLACK_S)
                        remaining = flush_at - time.perf_counter()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                    # A quiesce can begin during the linger: park again
                    # before popping, handing back what already expired.
                    if self._paused and not self._closed:
                        if expired:
                            return ([], expired, len(self._pending),
                                    self._breaker_open)
                        continue
                    # Deadlines may have lapsed during the linger; no
                    # request reaches dispatch already dead.
                    expired.extend(self._expire_locked())
                    batch = self._pop_locked()
                    if batch:
                        # Under the same hold that popped it: a quiescer
                        # entering now waits for this dispatch.
                        self._dispatching = True
                    return (batch, expired, len(self._pending),
                            self._breaker_open)
                if self._closed or expired:
                    return ((None if self._closed else []), expired,
                            len(self._pending), self._breaker_open)
                self._cond.wait()

    def _resolve_expired(self, expired: list[_Request]) -> None:
        """Fail a round's expired requests (worker thread, outside the
        lock)."""
        from photon_tpu_torch import obs

        if not expired:
            return
        exc = DeadlineExceededError(
            "request deadline expired while queued; failed before "
            "dispatch")
        for r in expired:
            r.future.set_exception(exc)
            _record_request(r, "expired")
        if self.slo_tracker is not None:
            self.slo_tracker.observe_errors(len(expired))
        if obs.enabled():
            obs.REGISTRY.counter("serve_deadline_expired_total").inc(
                len(expired))

    def _pop_staged(self) -> _Staged | None:
        """Claim the staged batch, if any. Parks while quiesced, as
        ``_take_batch`` does; ``_dispatching`` turns True under the hold
        that claims the batch."""
        with self._cond:
            while self._paused and not self._closed:
                self._cond.wait()
            staged, self._staged = self._staged, None
            if staged is not None:
                self._dispatching = True
                self._cond.notify_all()
            return staged

    def _stage_next(self) -> float:
        """Pop and pack the next batch while the current one is on the
        device; returns the pack's seconds (0.0 when nothing was
        packed), which the fetch leaves out of the ledger's device
        window. Pops only what the flush policy would release now (a
        full batch, a head request past its linger, or a closing
        queue's drain) and never waits; no-ops when a batch is already
        staged (a retried dispatch) or the queue is quiesced."""
        with self._cond:
            if self._staged is not None or self._paused:
                return 0.0
            expired = self._expire_locked()
            flush = bool(self._pending) and (
                len(self._pending) >= self.max_batch
                or self._closed
                or self._pending[0].enqueued_at + self.max_linger_s
                <= time.perf_counter()
            )
            reqs = self._pop_locked() if flush else []
            if reqs:
                self._stats["staged_batches"] += 1
        self._resolve_expired(expired)
        if not reqs:
            return 0.0
        t0 = time.perf_counter()
        try:
            packed = self.programs.pack_requests(
                [(r.features, r.entity_ids) for r in reqs])
        except Exception:  # noqa: BLE001 - a malformed request fails
            # on the dispatch path, where retry, the breaker and its
            # batch's futures handle it; it must not break the fetch of
            # the batch in flight.
            packed = None
        dt = time.perf_counter() - t0
        with self._cond:
            self._staged = _Staged(reqs, packed, self.programs)
            self._stats["staging_seconds"] += dt
            self._stats["staging_overlapped_seconds"] += dt
            self._cond.notify_all()
        return dt

    def _worker(self) -> None:
        from photon_tpu_torch import obs

        while True:
            # A staged batch goes first: its requests are off the
            # pending deque already, and close() must drain them.
            staged = self._pop_staged()
            if staged is not None:
                batch = staged.requests
            else:
                batch, expired, depth, breaker = self._take_batch()
                if obs.enabled():
                    # Queue pressure at every wakeup, in the registry.
                    obs.REGISTRY.gauge("serve_queue_depth").set(depth)
                    obs.REGISTRY.gauge("serve_breaker_open").set(
                        float(breaker))
                self._resolve_expired(expired)
                if batch is None:
                    return
                if not batch:
                    continue
            try:
                self._dispatch(batch, staged)
            finally:
                with self._cond:
                    self._dispatching = False
                    self._cond.notify_all()

    def _health_tap(self, batch: list[_Request], scores) -> None:
        """Fold a sample of a served batch (its request features and its
        scores, already host numpy) into the health layer's serve-side
        sketch; a no-op unless ``obs.health`` is armed. A tap that
        raises is logged and the batch is served all the same:
        telemetry must not strand the futures."""
        from photon_tpu_torch.obs import health

        if not health.enabled():
            return
        try:
            health.observe_serve_batch(
                [r.features for r in batch], scores,
                # The spec widths size a sparse shard's per-feature
                # moments to the serving feature space, so they align
                # with the training sketch's.
                widths={s: self.programs.specs[s].d
                        for s in self.programs.shard_order})
        except Exception:  # noqa: BLE001 - see the docstring
            logger.exception("serve health tap failed; continuing")

    def _dispatch(self, batch: list[_Request],
                  staged: _Staged | None = None) -> None:
        """Pack (unless staged for this generation), score and resolve
        one batch, outside the lock. On the pipelined path the dispatch
        is split: enqueue (``dispatch_padded``), pack the next batch
        while it runs, then fetch. Transient failures retry with backoff
        (``dispatch_retry``) around ``faults.check("serve.dispatch")``
        and the dispatch; anything else fans out to this batch's futures
        and feeds the breaker's consecutive-failure count. With
        telemetry on, the batch is a ``serve/batch`` span and each
        request's record is written at its outcome, after the fetch."""
        from photon_tpu_torch import obs

        t_start = time.perf_counter()
        # A retried dispatch keeps the last attempt's stamps: the one
        # whose scores the requests are served from.
        dispatch_ts = scatter_ts = None

        def attempt():
            nonlocal dispatch_ts, scatter_ts
            if (staged is not None and staged.packed is not None
                    and staged.programs is self.programs):
                feats, codes, _rung = staged.packed
            else:
                t0 = time.perf_counter()
                feats, codes, _rung = self.programs.pack_requests(
                    [(r.features, r.entity_ids) for r in batch])
                with self._cond:
                    self._stats["staging_seconds"] += (
                        time.perf_counter() - t0)
            cold_by_coord = {
                nm: int(np.sum(vec[: len(batch)] < 0))
                for nm, vec in codes.items()
            }
            dispatch_ts = time.perf_counter()
            dp = getattr(self.programs, "dispatch_padded", None)
            with obs.span("serve/batch"):
                if self.pipeline_staging and dp is not None:
                    handle = dp(feats, codes, len(batch))
                    # The card is busy: pack the next batch now, and
                    # leave that host time out of the ledger's window.
                    overlap = self._stage_next()
                    scores = self.programs.fetch_padded(
                        handle, exclude_seconds=overlap)
                else:
                    # The serial worker, or a programs object without
                    # the split dispatch and fetch.
                    scores = self.programs.score_padded(feats, codes,
                                                        len(batch))
            scatter_ts = time.perf_counter()
            return cold_by_coord, len(codes) * len(batch), scores

        def on_retry(attempt_no, exc):
            with self._cond:
                self._stats["dispatch_retries"] += 1
            if obs.enabled():
                obs.REGISTRY.counter("serve_dispatch_retries_total").inc()

        try:
            if self.dispatch_retry is not None:
                cold_by_coord, lookups, scores = _retry.retrying_check(
                    "serve.dispatch", attempt, site="serve.dispatch",
                    policy=self.dispatch_retry, on_retry=on_retry)
            else:
                faults.check("serve.dispatch")
                cold_by_coord, lookups, scores = attempt()
        except Exception as exc:  # noqa: BLE001 - fan out to the waiters
            drained: list[_Request] = []
            with self._cond:
                self._stats["dispatch_errors"] += 1
                self._consecutive_failures += 1
                tripped = (
                    self.breaker_threshold is not None
                    and not self._breaker_open
                    and self._consecutive_failures >= self.breaker_threshold
                )
                if tripped:
                    self._breaker_open = True
                    self._stats["breaker_trips"] += 1
                    drained = list(self._pending)
                    self._pending.clear()
                    # The staged batch is off the deque but not yet
                    # dispatched: its futures would strand otherwise.
                    if self._staged is not None:
                        drained.extend(self._staged.requests)
                        self._staged = None
                    self._cond.notify_all()
            for r in batch:
                r.future.set_exception(exc)
                _record_request(r, "error", error=type(exc).__name__,
                                batch_size=len(batch))
            if tripped:
                logger.error(
                    "serve dispatch circuit breaker OPEN after %d "
                    "consecutive batch failure(s) (last: %r); drained %d "
                    "queued request(s)",
                    self._consecutive_failures, exc, len(drained))
                drain_exc = CircuitOpenError(
                    "serve dispatch circuit breaker opened while this "
                    f"request was queued (last failure: {exc!r})")
                for r in drained:
                    r.future.set_exception(drain_exc)
                    _record_request(r, "breaker")
                if obs.enabled():
                    obs.REGISTRY.counter("serve_breaker_trips_total").inc()
                    obs.trace.instant(
                        "serve.breaker_open", cat="serve",
                        consecutive_failures=self._consecutive_failures,
                        drained=len(drained))
            if self.slo_tracker is not None:
                self.slo_tracker.observe_errors(len(batch) + len(drained))
            return
        self._health_tap(batch, scores)
        cold = sum(cold_by_coord.values())
        with self._cond:
            self._consecutive_failures = 0
            self._stats["cold_lookups"] += cold
            self._stats["entity_lookups"] += lookups
            for nm, c in cold_by_coord.items():
                cs = self._coord_stats[nm]
                cs["entity_lookups"] += len(batch)
                cs["cold_lookups"] += c
            batch_no = self._stats["batches"]
            depth = len(self._pending)
            hotness = {nm: (self.hotness[nm], self._re_types[nm])
                       for nm in cold_by_coord}
        # Each surface below has its own lock, taken outside _cond.
        for sketch, rt in hotness.values():
            for r in batch:
                key = r.entity_ids.get(rt)
                if key is not None:
                    sketch.observe(key)
        if self.slo_tracker is not None:
            self.slo_tracker.observe_lookups(lookups, cold)
        if obs.enabled():
            obs.REGISTRY.counter("serve_requests_total").inc(len(batch))
            obs.REGISTRY.counter("serve_batches_total").inc()
            if lookups:
                obs.REGISTRY.counter("serve_cold_lookups_total").inc(cold)
            obs.REGISTRY.histogram("serve_batch_fill").observe(
                len(batch) / self.max_batch)
            obs.REGISTRY.histogram("serve_batch_seconds").observe(
                time.perf_counter() - t_start)
            # Queue depth after each batch: a counter track on the
            # timeline.
            obs.trace.counter("serve_queue_depth", depth)
        for r, s in zip(batch, scores):
            # Submit to scatter is the request's service latency, the
            # number the window ring and the latency SLO judge; taken
            # before resolution, so a slow done-callback cannot
            # inflate it.
            latency = scatter_ts - r.enqueued_at
            self.latency.observe(latency)
            if self.slo_tracker is not None:
                self.slo_tracker.observe_request(latency)
            r.future.set_result(float(s))
            # done_ts lands after resolution: scatter to done covers
            # the fan-out, the driver's done-callbacks included.
            _record_request(r, "served", dispatch_ts=dispatch_ts,
                            scatter_ts=scatter_ts, batch=batch_no,
                            batch_size=len(batch))
