"""Labeled metrics registry: counters, gauges, histograms (port of
``photon_tpu/obs/metrics.py``).

The runtime's scalar telemetry (training events, ingest pipeline
stages, retry sites, the serve queue) lands in one process-global,
thread-safe registry. Series are keyed ``name{label=value,...}``;
histograms keep count/sum/min/max.

Threading: every mutation, from the training thread, the ingest pools
and the serve worker alike, takes the one registry lock
(``MetricsRegistry._lock``); ``_Counter.inc``, ``_Gauge.set`` and
``_Histogram.observe`` are the surface other threads call.
"""

from __future__ import annotations

import threading


def _series_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class _Counter:
    __slots__ = ("registry", "key")

    def __init__(self, registry: "MetricsRegistry", key: str):
        self.registry = registry
        self.key = key

    def inc(self, value: float = 1.0) -> None:
        with self.registry._lock:
            c = self.registry._counters
            c[self.key] = c.get(self.key, 0.0) + value


class _Gauge:
    __slots__ = ("registry", "key")

    def __init__(self, registry: "MetricsRegistry", key: str):
        self.registry = registry
        self.key = key

    def set(self, value: float) -> None:
        with self.registry._lock:
            self.registry._gauges[self.key] = float(value)


class _Histogram:
    __slots__ = ("registry", "key")

    def __init__(self, registry: "MetricsRegistry", key: str):
        self.registry = registry
        self.key = key

    def observe(self, value: float) -> None:
        value = float(value)
        with self.registry._lock:
            h = self.registry._histograms.get(self.key)
            if h is None:
                self.registry._histograms[self.key] = {
                    "count": 1, "sum": value, "min": value, "max": value,
                }
            else:
                h["count"] += 1
                h["sum"] += value
                h["min"] = min(h["min"], value)
                h["max"] = max(h["max"], value)


class MetricsRegistry:
    """Thread-safe registry; the process-global one is
    ``photon_tpu_torch.obs.REGISTRY``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._histograms: dict[str, dict] = {}

    def reset(self) -> None:
        with self._lock:
            self._counters = {}
            self._gauges = {}
            self._histograms = {}

    def counter(self, name: str, **labels) -> _Counter:
        return _Counter(self, _series_key(name, labels))

    def gauge(self, name: str, **labels) -> _Gauge:
        return _Gauge(self, _series_key(name, labels))

    def histogram(self, name: str, **labels) -> _Histogram:
        return _Histogram(self, _series_key(name, labels))

    def snapshot(self) -> dict:
        """JSON-ready view: {counters, gauges, histograms}."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    k: dict(v) for k, v in self._histograms.items()
                },
            }


REGISTRY = MetricsRegistry()


def metrics_listener(event) -> None:
    """An ``EventEmitter`` listener feeding the registry from the
    training events: per-coordinate update counters and update-time
    histograms, per-configuration fit-end counters."""
    from photon_tpu_torch.events import CoordinateUpdateEvent, FitEndEvent

    if isinstance(event, CoordinateUpdateEvent):
        REGISTRY.counter(
            "coordinate_updates_total", coordinate=event.coordinate_id
        ).inc()
        if event.seconds is not None:
            REGISTRY.histogram(
                "coordinate_update_dispatch_seconds",
                coordinate=event.coordinate_id,
            ).observe(event.seconds)
    elif isinstance(event, FitEndEvent):
        REGISTRY.counter("fit_configs_total").inc()
