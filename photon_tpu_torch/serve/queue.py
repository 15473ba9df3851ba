"""The serving micro-batch queue (a thin port of
``photon_tpu/serve/queue.py``).

One worker thread owns every dispatch; producers hand
``(features, entity_ids)`` pairs to ``submit`` and get a future back. A
batch dispatches when it reaches ``max_batch`` requests (clamped to the
ladder's top rung) or when its oldest request has lingered
``max_linger_s``. The queue is bounded (``max_queue``): producers block
for space.

Staging is double-buffered: while batch k is on the device the worker
pops and packs batch k+1, so host packing overlaps the device round
trip. ``close`` drains everything queued and resolves every future;
``quiesce`` parks the worker between batches.

Not ported yet: deadlines, shedding, the circuit breaker, dispatch
retry, hotness sketches, SLO tracking, metrics families and
``reload_model``.

Threading: ``_cond`` (a Condition, which is also the mutex) guards the
pending deque, the closed and pause flags, the staged slot and the
counters. The worker takes a batch under the lock and dispatches and
resolves futures outside it.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time

import numpy as np

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


class _Request:
    __slots__ = ("features", "entity_ids", "future", "enqueued_at")

    def __init__(self, features: dict, entity_ids: dict):
        self.features = features
        self.entity_ids = entity_ids
        self.future = _Future()
        self.enqueued_at = time.perf_counter()


class _Staged:
    """A batch popped and packed while the previous one was in flight.
    ``packed`` is None when packing raised; the dispatch then packs
    again and reports the error to the batch."""

    __slots__ = ("requests", "packed")

    def __init__(self, requests, packed):
        self.requests = requests
        self.packed = packed


class MicroBatchQueue:
    """Bounded micro-batching front of a ``ScorePrograms`` ladder."""

    def __init__(
        self,
        programs,
        *,
        max_batch: int | None = None,
        max_linger_s: float = 0.002,
        max_queue: int = 4096,
    ):
        self.programs = programs
        top = programs.ladder.max_batch
        self.max_batch = min(
            top if max_batch is None else int(max_batch), top
        )
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_linger_s = float(max_linger_s)
        self.max_queue = max(int(max_queue), self.max_batch)
        self._cond = threading.Condition()
        self._pending: collections.deque[_Request] = collections.deque()
        self._closed = False
        self._paused = False
        self._dispatching = False
        self._staged: _Staged | None = None
        self._stats = {
            "requests": 0,
            "batches": 0,
            "batched_requests": 0,
            "cold_lookups": 0,
            "entity_lookups": 0,
            "rejected": 0,
            "dispatch_errors": 0,
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
            for name in programs.tables.random
        }
        self._thread = threading.Thread(
            target=self._worker, name="photon-torch-serve-worker",
            # A dispatch wedged in native code must not hang exit.
            daemon=True,
        )
        self._thread.start()

    # -- producer side ----------------------------------------------------

    def submit(self, features: dict, entity_ids: dict | None = None):
        """Queue one request; returns its future. ``features`` maps
        shard id -> the spec's request leaf, ``entity_ids`` maps
        random-effect type -> entity key. Blocks while the queue is
        full; raises ``QueueClosed`` after ``close``."""
        req = _Request(features, dict(entity_ids or {}))
        with self._cond:
            while not self._closed and len(self._pending) >= self.max_queue:
                self._cond.wait()
            if self._closed:
                self._stats["rejected"] += 1
                raise QueueClosed("serve queue is closed")
            self._pending.append(req)
            self._stats["requests"] += 1
            self._cond.notify_all()
        return req.future

    def close(self, timeout: float | None = None) -> bool:
        """Stop accepting requests, drain the queue, join the worker.
        Returns False when the worker did not finish within
        ``timeout``."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)
        return not self._thread.is_alive()

    @contextlib.contextmanager
    def quiesce(self):
        """Hold dispatch for the block: entering waits out the batch in
        flight; producers keep queueing meanwhile."""
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

    def __enter__(self) -> "MicroBatchQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        """Snapshot of the counters, with per-coordinate lookups."""
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
        snap["mean_batch_size"] = (
            round(snap["batched_requests"] / snap["batches"], 2)
            if snap["batches"] else None
        )
        snap["cold_entity_rate"] = (
            round(snap["cold_lookups"] / snap["entity_lookups"], 4)
            if snap["entity_lookups"] else None
        )
        return snap

    # -- worker side ------------------------------------------------------

    def _pop_locked(self) -> list[_Request]:
        batch = [
            self._pending.popleft()
            for _ in range(min(len(self._pending), self.max_batch))
        ]
        self._stats["batches"] += 1
        self._stats["batched_requests"] += len(batch)
        self._cond.notify_all()  # space freed: wake producers
        return batch

    def _take_batch(self) -> list[_Request] | None:
        """Block for the next batch per the flush policy; None once the
        queue is closed and drained."""
        with self._cond:
            while True:
                while self._paused and not self._closed:
                    self._cond.wait()
                if self._pending:
                    linger_end = (
                        self._pending[0].enqueued_at + self.max_linger_s
                    )
                    while (
                        len(self._pending) < self.max_batch
                        and not self._closed
                        and not self._paused
                    ):
                        remaining = linger_end - time.perf_counter()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                    if self._paused and not self._closed:
                        continue  # a quiesce began during the linger
                    self._dispatching = True
                    return self._pop_locked()
                if self._closed:
                    return None
                self._cond.wait()

    def _pop_staged(self) -> _Staged | None:
        with self._cond:
            while self._paused and not self._closed:
                self._cond.wait()
            staged, self._staged = self._staged, None
            if staged is not None:
                self._dispatching = True
            return staged

    def _stage_next(self) -> None:
        """Pop and pack the next batch while the current one is on the
        device. Pops only what the flush policy would release now (a
        full batch, a head request past its linger, or a closing
        queue's drain) and never waits."""
        with self._cond:
            if self._staged is not None or self._paused:
                return
            flush = bool(self._pending) and (
                len(self._pending) >= self.max_batch
                or self._closed
                or self._pending[0].enqueued_at + self.max_linger_s
                <= time.perf_counter()
            )
            if not flush:
                return
            reqs = self._pop_locked()
            self._stats["staged_batches"] += 1
        t0 = time.perf_counter()
        try:
            packed = self.programs.pack_requests(
                [(r.features, r.entity_ids) for r in reqs]
            )
        except Exception:  # noqa: BLE001 - a malformed request fails
            # on the dispatch path, where its batch's futures get the
            # error; it must not break the fetch of the batch in flight.
            packed = None
        dt = time.perf_counter() - t0
        with self._cond:
            self._staged = _Staged(reqs, packed)
            self._stats["staging_seconds"] += dt
            self._stats["staging_overlapped_seconds"] += dt

    def _worker(self) -> None:
        while True:
            staged = self._pop_staged()
            if staged is not None:
                batch, packed = staged.requests, staged.packed
            else:
                batch, packed = self._take_batch(), None
                if batch is None:
                    return
            try:
                self._dispatch(batch, packed)
            finally:
                with self._cond:
                    self._dispatching = False
                    self._cond.notify_all()

    def _dispatch(self, batch: list[_Request], packed) -> None:
        """Pack (unless staged), score and resolve one batch. Any
        exception goes to this batch's futures; the worker serves on."""
        try:
            if packed is None:
                t0 = time.perf_counter()
                packed = self.programs.pack_requests(
                    [(r.features, r.entity_ids) for r in batch]
                )
                with self._cond:
                    self._stats["staging_seconds"] += (
                        time.perf_counter() - t0
                    )
            feats, codes, _rung = packed
            cold_by_coord = {
                nm: int(np.sum(vec[: len(batch)] < 0))
                for nm, vec in codes.items()
            }
            handle = self.programs.dispatch_padded(feats, codes, len(batch))
            self._stage_next()
            scores = self.programs.fetch_padded(handle)
        except Exception as exc:  # noqa: BLE001 - fan out to the waiters
            with self._cond:
                self._stats["dispatch_errors"] += 1
            for r in batch:
                r.future.set_exception(exc)
            return
        with self._cond:
            for nm, cold in cold_by_coord.items():
                cs = self._coord_stats[nm]
                cs["entity_lookups"] += len(batch)
                cs["cold_lookups"] += cold
                self._stats["entity_lookups"] += len(batch)
                self._stats["cold_lookups"] += cold
        for r, s in zip(batch, scores):
            r.future.set_result(float(s))
