"""Typed training events and a listener registry (port of
``photon_tpu/events.py``).

Counterpart of photon-client's event bus (event/EventEmitter.scala:24,
a listener list with ``sendEvent`` fan-out, and the ``Event`` case
classes of event/Event.scala:65). ``GameEstimator(listeners=...)`` owns
one emitter; the coordinate-descent loop sends a
``CoordinateUpdateEvent`` per update (``CoordinateRollbackEvent`` for a
non-finite update it rolled back) and the estimator a ``FitEndEvent``
per optimization configuration.

Listeners are plain callables ``listener(event) -> None``. By default an
exception propagates (a raising listener aborts training, the
reference's synchronous ``foreach``); ``safe_listeners=True``, or
``isolate=True`` on one ``send_event``, logs it and goes on with the
next listener.

Threading: the listener list is guarded by ``_lock``; ``send_event``
fans out over a snapshot taken under it, outside it, so every listener
registered when the emit began receives the event exactly once and a
listener may add or remove listeners from inside the fan-out.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Callable

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class PhotonEvent:
    """Base event type (event/Event.scala:65)."""


@dataclasses.dataclass(frozen=True)
class CoordinateUpdateEvent(PhotonEvent):
    """One coordinate update finished; wraps its history record
    (``CoordinateUpdateRecord``) so the event cannot drift from it."""

    record: Any

    @property
    def iteration(self) -> int:
        return self.record.iteration

    @property
    def coordinate_id(self) -> str:
        return self.record.coordinate_id

    @property
    def seconds(self) -> float | None:
        return self.record.seconds

    @property
    def diagnostics(self):
        return self.record.diagnostics

    @property
    def evaluation(self):
        return self.record.evaluation


@dataclasses.dataclass(frozen=True)
class CoordinateRollbackEvent(PhotonEvent):
    """A coordinate update was non-finite and ROLLED BACK to the
    previous iterate (the CD loop's non-finite guard); the record's
    ``rolled_back`` is set and carries the poisoned update's
    diagnostics."""

    record: Any

    @property
    def iteration(self) -> int:
        return self.record.iteration

    @property
    def coordinate_id(self) -> str:
        return self.record.coordinate_id


@dataclasses.dataclass(frozen=True)
class FitEndEvent(PhotonEvent):
    """One optimization configuration's coordinate descent finished."""

    config_index: int
    result: Any  # GameFitResult


Listener = Callable[[PhotonEvent], None]


class EventEmitter:
    """Listener registry with synchronous fan-out, in order, on the
    sending thread (EventEmitter.scala:24)."""

    def __init__(self, listeners=None, *, safe_listeners: bool = False):
        self._lock = threading.Lock()
        self._listeners: list[Listener] = list(listeners or ())
        self.safe_listeners = safe_listeners

    def add_listener(self, listener: Listener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def remove_listener(self, listener: Listener) -> None:
        with self._lock:
            self._listeners.remove(listener)

    def clear_listeners(self) -> None:
        with self._lock:
            self._listeners.clear()

    def send_event(self, event: PhotonEvent, *,
                   isolate: bool | None = None) -> None:
        if isolate is None:
            isolate = self.safe_listeners
        with self._lock:
            listeners = tuple(self._listeners)
        if not isolate:
            for listener in listeners:
                listener(event)
            return
        for listener in listeners:
            try:
                listener(event)
            except Exception:  # noqa: BLE001 - isolation is the contract
                logger.exception(
                    "event listener %r raised on %r; continuing "
                    "(isolated fan-out)", listener, type(event).__name__)
