"""photon_tpu_torch.obs: runtime telemetry (port of ``photon_tpu/obs``).

One layer over the port's runtime visibility: hierarchical **spans**
with a host/device split measured only where a span asks for it
(``obs/spans.py``), a labeled **metrics registry** (``obs/metrics.py``),
device-side **convergence traces** (``obs/convergence.py``; empty until
the fused fit is ported), a **timeline** of instants, counters and
per-request records with its Chrome-trace export (``obs/trace.py``),
the crash **flight recorder** (``obs/flight.py``), the per-program
**cost ledger** (``obs/ledger.py``), the model and data **health**
layer (``obs/health.py``: sketches, drift and skew, calibration,
sentinels, the serve tap), **live monitoring** (``obs/monitor.py``:
``/metrics``, ``/healthz``, ``/readyz``, latency windows, SLO burn,
hotness; imported lazily) and the **exporters**: ``snapshot()``, the
JSONL stream and the text table (``obs/export.py``; schema in
OBSERVABILITY.md), and the **fleet** layer (``obs/fleet.py``: host
identity, clock alignment, per-rank bundles and their merge).

Telemetry is off by default, and turning it on is a host decision only:
no hook launches a kernel, copies to or from the card or waits for it,
so the kernels, the CUDA graphs and every number a fit or a score
produces are the same either way.

Usage::

    from photon_tpu_torch import obs

    obs.enable()
    with obs.span("prepare"):
        datasets, _ = est.prepare(data)
    ...
    print(obs.summary_table())
    obs.write_jsonl("run-telemetry.jsonl")
"""

from __future__ import annotations

import contextlib
import logging
import time

from photon_tpu_torch.obs import convergence
from photon_tpu_torch.obs import fleet
from photon_tpu_torch.obs import flight
from photon_tpu_torch.obs import health
from photon_tpu_torch.obs import ledger
from photon_tpu_torch.obs import trace


def __getattr__(name: str):
    # Lazy submodule (PEP 562): every training and serving path imports
    # the obs package, and only --monitor-port users need the
    # http.server import chain. `from photon_tpu_torch.obs import
    # monitor` still works: the from-import falls back to this hook.
    if name == "monitor":
        import importlib

        return importlib.import_module("photon_tpu_torch.obs.monitor")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


from photon_tpu_torch.obs.export import (
    snapshot,
    summary_table,
    validate_jsonl,
    write_jsonl,
)
from photon_tpu_torch.obs.metrics import (
    REGISTRY,
    MetricsRegistry,
    metrics_listener,
)
from photon_tpu_torch.obs.spans import Span, SpanTracer
from photon_tpu_torch.obs.trace import profile_session, write_chrome_trace

TRACER = SpanTracer()
span = TRACER.span


@contextlib.contextmanager
def logged_span(msg: str, log: logging.Logger | None = None):
    """A span that also keeps the reference's ``Timed`` logging contract
    ("<msg>: begin execution" / "<msg>: executed in <t> s",
    util/Timed.scala:53-80): the one logged-section helper of the CLIs
    and of ``utils.Timed``."""
    log = log or logging.getLogger("photon_tpu_torch.timed")
    log.info("%s: begin execution", msg)
    t0 = time.perf_counter()
    try:
        with span(msg):
            yield
    finally:
        log.info("%s: executed in %.3f s", msg, time.perf_counter() - t0)


def enable() -> None:
    """Turn telemetry recording on (spans, events, metric side-feeds)."""
    TRACER.enabled = True


def disable() -> None:
    TRACER.enabled = False


def enabled() -> bool:
    return TRACER.enabled


def reset() -> None:
    """Drop all recorded telemetry (spans, metrics, convergence traces,
    trace events, the ledger's accumulators, the health sketches and
    sentinels, the host identity). Does not touch the enabled flags."""
    TRACER.reset()
    REGISTRY.reset()
    convergence.reset()
    trace.reset()
    ledger.reset()
    health.reset()
    fleet.reset()


def set_span_retention(max_spans: int) -> None:
    """Rebind the completed-span ring's bound (default 4096, the newest
    kept); the trace-event ring has ``obs.trace.set_retention``. Drops
    feed ``spans_dropped_total`` / ``trace_events_dropped_total`` and
    the snapshot and JSONL headers."""
    TRACER.set_retention(max_spans)


__all__ = [
    "REGISTRY",
    "MetricsRegistry",
    "Span",
    "SpanTracer",
    "TRACER",
    "convergence",
    "disable",
    "enable",
    "enabled",
    "fleet",
    "flight",
    "health",
    "ledger",
    "logged_span",
    "metrics_listener",
    "profile_session",
    "reset",
    "set_span_retention",
    "snapshot",
    "span",
    "summary_table",
    "trace",
    "validate_jsonl",
    "write_chrome_trace",
    "write_jsonl",
]
