"""Crash flight recorder: the last stretch of the timeline, on disk,
always (port of ``photon_tpu/obs/flight.py``).

The telemetry layer's bounded rings (completed spans, trace events) are
the recording; a dump writes their tails, the metrics and their deltas
since install, the retry counters and fired faults and, when armed, the
cost ledger and the health layer's counters (``health.raw_snapshot``,
which copies nothing from the card) to ``flight-<pid>.json``, atomically (temp file, fsync,
rename: ``io/model_io.atomic_write_bytes``), so a dump cut short by the
dying process leaves no half-written file.

Dumps fire on:

- **signals**: ``install(signals=True)`` chains SIGINT and SIGTERM
  (dump, then the previous handler, or the default disposition
  restored and re-raised so the exit keeps its signal semantics).
  ``cli.train`` keeps its own handlers, which drive the emergency
  checkpoint, and dumps from that path instead. Off the main thread
  ``signal.signal`` raises, so there the recorder installs without
  signal hooks.
- **unhandled exceptions**: ``install()`` chains ``sys.excepthook``.
- **crash-kind injected faults**: a listener registered with
  ``resilience.faults.on_crash`` dumps at the raise point, so a fault
  plan's crash leaves a post-mortem even when a caller catches
  ``InjectedCrash``.

Installing the recorder turns telemetry recording on (``uninstall``
restores the prior flag): a recorder over empty rings records nothing,
and what it turns on is host bookkeeping, never device work. The CLIs
install it by default (``--no-flight`` opts out, ``--flight-dir``
picks the directory). A failed dump logs and returns None: it never
raises over the crash it documents.
"""

from __future__ import annotations

import json
import logging
import os
import signal as _signal
import sys
import threading
import time

logger = logging.getLogger(__name__)

_DEFAULT_SPAN_LIMIT = 512
_DEFAULT_EVENT_LIMIT = 1024
# How long a signal handler waits for the off-thread dump before
# letting the process die post-mortem-less (see _on_signal).
_SIGNAL_DUMP_TIMEOUT_S = 5.0

# ``_lock`` guards the one installed-recorder reference (installed and
# removed by the driver thread, read by signal handlers, the excepthook
# and the crash-fault path on whatever thread crashes). A dump works on
# ring snapshots and writes its file outside any lock.
_lock = threading.Lock()
_recorder: "FlightRecorder | None" = None


class FlightRecorder:
    """One installed recorder; use ``install()``/``uninstall()`` rather
    than constructing directly (the module keeps the single reference
    the signal/excepthook/crash paths consult)."""

    def __init__(
        self,
        directory: str,
        *,
        span_limit: int = _DEFAULT_SPAN_LIMIT,
        event_limit: int = _DEFAULT_EVENT_LIMIT,
    ):
        self.directory = directory
        self.span_limit = int(span_limit)
        self.event_limit = int(event_limit)
        self.installed_unix = time.time()
        # Counter baseline for the dump's deltas: "what moved since the
        # recorder went in" is the post-mortem question.
        from photon_tpu_torch import obs

        self._baseline = dict(obs.REGISTRY.snapshot()["counters"])
        self._prev_enabled: bool | None = None
        self._prev_handlers: dict = {}
        self._prev_excepthook = None
        self._crash_listener = None
        # Both set by install(); reinstall re-arms with the same choices.
        self._signals = False
        self._enable = True

    # -- dump ------------------------------------------------------------

    def dump(self, reason: str) -> str | None:
        """Write ``flight-<pid>.json`` atomically (multi-process runs
        suffix the rank: ``flight-<pid>-r<process_index>.json``, so two
        ranks on one box can never clobber or confuse each other's
        post-mortems); returns the path, or None if the dump failed (a
        failing dump must never mask the crash it is documenting — it
        logs and returns)."""
        try:
            # The shared tmp + fsync + replace + directory fsync: a
            # power loss right after the rename keeps the post-mortem,
            # and a failed dump leaves no temp file.
            from photon_tpu_torch.io.model_io import atomic_write_bytes

            payload = self._payload(reason)
            os.makedirs(self.directory, exist_ok=True)
            host = payload.get("host") or {}
            stem = f"flight-{os.getpid()}"
            if (host.get("process_count") or 1) > 1:
                stem += f"-r{host.get('process_index', 0)}"
            path = os.path.join(self.directory, f"{stem}.json")
            atomic_write_bytes(path, json.dumps(payload).encode())
            return path
        except Exception:  # noqa: BLE001 — the crash path stays alive
            logger.exception("flight-recorder dump failed (%s)", reason)
            return None

    def _payload(self, reason: str) -> dict:
        """Assemble the post-mortem. Each section is independently
        guarded: one wedged surface (a poisoned device array behind a
        convergence fetch) must not cost the rest of the dump."""
        from photon_tpu_torch import obs
        from photon_tpu_torch.obs import trace as obs_trace

        out: dict = {
            "schema": 1,
            "reason": reason,
            "pid": os.getpid(),
            "time_unix": time.time(),
            "perf_counter": time.perf_counter(),
            "installed_unix": self.installed_unix,
        }
        try:
            from photon_tpu_torch.obs import fleet

            out["host"] = fleet.host_identity()
        except Exception as exc:  # noqa: BLE001
            out["host_error"] = repr(exc)
        try:
            spans = obs.TRACER.completed()[-self.span_limit:]
            out["spans"] = [
                dict(sp.to_json(), t0=sp.t0, t1=sp.t1) for sp in spans
            ]
            out["spans_dropped"] = obs.TRACER.dropped
        except Exception as exc:  # noqa: BLE001
            out["spans_error"] = repr(exc)
        try:
            out["events"] = obs_trace.events()[-self.event_limit:]
            out["events_dropped"] = obs_trace.dropped()
        except Exception as exc:  # noqa: BLE001
            out["events_error"] = repr(exc)
        try:
            snap = obs.REGISTRY.snapshot()
            out["metrics"] = snap
            out["counter_deltas"] = {
                k: v - self._baseline.get(k, 0.0)
                for k, v in snap["counters"].items()
                if v != self._baseline.get(k, 0.0)
            }
        except Exception as exc:  # noqa: BLE001
            out["metrics_error"] = repr(exc)
        try:
            from photon_tpu_torch.resilience import faults, retry_stats

            out["retry_stats"] = retry_stats()
            out["faults_fired"] = faults.fired()
        except Exception as exc:  # noqa: BLE001
            out["resilience_error"] = repr(exc)
        try:
            from photon_tpu_torch.obs import ledger

            if ledger.enabled():
                # Raw accumulators only (snapshot never prices a cost
                # thunk): a dying process counts nothing new.
                out["ledger"] = ledger.snapshot()
        except Exception as exc:  # noqa: BLE001
            out["ledger_error"] = repr(exc)
        try:
            from photon_tpu_torch.obs import health

            if health.enabled():
                # Counters and the last gate decision only: a dying
                # process must not copy parked sentinel tensors from the
                # card (the ledger's policy above).
                out["health"] = health.raw_snapshot()
        except Exception as exc:  # noqa: BLE001
            out["health_error"] = repr(exc)
        return out

    # -- hooks -----------------------------------------------------------

    def _on_signal(self, signum, frame):
        # dump() takes the tracer/ring/registry locks, and a Python
        # signal handler runs on the main thread BETWEEN BYTECODES —
        # possibly inside one of those very `with lock:` blocks (span
        # completion is constant in a serving process). An inline dump
        # would self-deadlock on the non-reentrant lock and the
        # SIGTERM'd process would hang instead of dying. A daemon
        # thread takes the locks safely (the main thread parks in the
        # join, holding nothing in the common case); the bounded join
        # gives up the post-mortem — never the exit — when the
        # interrupted thread does hold one.
        t = threading.Thread(
            target=self.dump, args=(f"signal:{signum}",),
            name="flight-signal-dump", daemon=True,
        )
        t.start()
        t.join(timeout=_SIGNAL_DUMP_TIMEOUT_S)
        if t.is_alive():  # pragma: no cover — needs a lock-holding race
            logger.error(
                "flight-recorder dump wedged on signal %d; exiting "
                "without a post-mortem", signum,
            )
        prev = self._prev_handlers.get(signum)
        if prev is _signal.SIG_IGN:
            return
        if callable(prev):
            prev(signum, frame)
            return
        # Default disposition: restore it and re-raise so the process
        # dies with the signal's own exit semantics (a SIGTERM'd serve
        # process must still read as SIGTERM'd to its supervisor).
        _signal.signal(signum, prev if prev is not None else _signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    def _on_exception(self, exc_type, exc, tb):
        self.dump(f"exception:{exc_type.__name__}")
        hook = self._prev_excepthook or sys.__excepthook__
        hook(exc_type, exc, tb)

    def _on_crash_fault(self, point: str, message: str) -> None:
        self.dump(f"fault.crash:{point}")


def install(
    directory: str,
    *,
    signals: bool = False,
    enable: bool = True,
    span_limit: int = _DEFAULT_SPAN_LIMIT,
    event_limit: int = _DEFAULT_EVENT_LIMIT,
) -> FlightRecorder:
    """Install the process flight recorder (replacing any prior one —
    ``reinstall`` hands a replaced recorder back).

    Chains ``sys.excepthook`` and the ``resilience.faults`` crash-fault
    listener; ``signals=True`` additionally chains SIGINT/SIGTERM (the
    serve CLI's mode — the train CLI keeps its own handlers and dumps
    from its emergency-checkpoint path). ``enable=True`` (default) turns
    telemetry recording on so the rings have content; the prior flag is
    restored on ``uninstall``.
    """
    rec = FlightRecorder(
        directory, span_limit=span_limit, event_limit=event_limit
    )
    rec._signals = bool(signals)
    rec._enable = bool(enable)
    return _arm(rec, enable=enable)


def reinstall(rec: FlightRecorder) -> FlightRecorder:
    """Re-arm a previously-uninstalled recorder: same directory, limits,
    counter baseline, signal mode, and enable choice (an ambient
    recorder installed with ``enable=False`` stays recording-off); every
    hook re-chained against the CURRENT process state. How the CLIs
    hand an embedding caller's ambient recorder back after their own
    default-on install replaced it — the caller's post-mortem coverage
    survives the nested run."""
    return _arm(rec, enable=rec._enable)


def _arm(rec: FlightRecorder, *, enable: bool) -> FlightRecorder:
    from photon_tpu_torch import obs
    from photon_tpu_torch.resilience import faults

    uninstall()
    rec._prev_enabled = obs.enabled()
    if enable:
        obs.enable()
    rec._prev_excepthook = sys.excepthook
    sys.excepthook = rec._on_exception
    rec._crash_listener = rec._on_crash_fault
    faults.on_crash(rec._crash_listener)
    rec._prev_handlers = {}
    if rec._signals:
        for sig in (_signal.SIGINT, _signal.SIGTERM):
            try:
                rec._prev_handlers[sig] = _signal.signal(
                    sig, rec._on_signal
                )
            except ValueError:  # pragma: no cover — non-main-thread embed
                pass
    with _lock:
        global _recorder
        _recorder = rec
    return rec


def uninstall() -> None:
    """Remove the installed recorder and restore every chained hook
    (telemetry flag, excepthook, signal handlers, crash listener).
    Idempotent."""
    with _lock:
        global _recorder
        rec, _recorder = _recorder, None
    if rec is None:
        return
    from photon_tpu_torch import obs
    from photon_tpu_torch.resilience import faults

    if rec._crash_listener is not None:
        faults.remove_crash_listener(rec._crash_listener)
    if sys.excepthook == rec._on_exception:
        sys.excepthook = rec._prev_excepthook or sys.__excepthook__
    for sig, prev in rec._prev_handlers.items():
        try:
            # A prior handler installed from C reads back as None —
            # signal.signal(None) is a TypeError; SIG_DFL is the same
            # substitution _on_signal's re-raise path makes.
            _signal.signal(sig, prev if prev is not None else _signal.SIG_DFL)
        except ValueError:  # pragma: no cover
            pass
    if rec._prev_enabled is not None:
        obs.TRACER.enabled = rec._prev_enabled


def installed() -> "FlightRecorder | None":
    return _recorder


def dump(reason: str) -> str | None:
    """Dump via the installed recorder; no-op (None) when none is
    installed — call sites wire it unconditionally."""
    rec = _recorder
    return rec.dump(reason) if rec is not None else None
