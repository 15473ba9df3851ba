"""Deterministic fault injection at the runtime's named boundaries
(port of ``photon_tpu/resilience/faults.py``).

A failing run is only useful if it can be replayed: every injection is
driven by a seeded ``FaultPlan``, so the same faults fire at the same
call indices on any machine. Production code carries one
``faults.check(point)`` at each boundary, a single module-global read
when nothing is armed. ``PHOTON_TPU_FAULT_PLAN`` arms a plan in a CLI
process (``arm_from_env``), with the reference's spelling.

The points the port reaches:

==================  ======================================================
point               boundary
==================  ======================================================
``checkpoint.write``a checkpoint write, AFTER the temp file but BEFORE
                    the atomic rename (the mid-write crash window)
``cd.iteration``    end of one outer coordinate-descent iteration, AFTER
                    its checkpoint was written (the kill-and-resume
                    window)
``fit.dispatch``    before each fused fit's graph replay (its capture on
                    first use), inside the retried call
                    ``fused_fit.dispatch`` (``FusedFit.run``)
``serve.dispatch``  the serve queue's batch dispatch, inside its retried
                    call (``MicroBatchQueue._dispatch``)
``ingest.plan``,    the planner's per-coordinate plan and chunk, and the
``ingest.chunk``,   packed host-to-device copy (``data/pipeline.py``)
``transfer.packed``
``io.shard_read``,  a streamed shard's read and decode, inside their
``io.shard_decode`` retried calls (``data/stream.py``)
``pilot.ingest``,   the pilot's stages, each inside its retried call
``pilot.train``,    (``Pilot._stage_run``)
``pilot.validate``
``pilot.promote``   twice a promotion: inside the generation npz's
                    atomic write (``GenerationRing.stage_candidate``),
                    and between the ring commit and the serving reload
``pilot.rollback``  before a rollback loads its target generation
==================  ======================================================

``compile.aot`` fires inside every ahead-of-time capture's retried call
(``utils.compile_cache.aot_capture``): the fused fit's warm capture
during ``prepare`` and each serving rung's capture, the two places the
reference fires it.

Fault kinds (``FaultSpec.error``): ``"transient"`` raises
``TransientError``, ``"poison"`` raises ``PoisonError``, ``"crash"``
raises ``InjectedCrash`` (a simulated process death), ``"delay"`` sleeps
``seconds``, ``"sigterm"`` sends SIGTERM to this process. Triggers are
``nth`` (the Nth call to the point, 1-based, once) or ``probability``
(a seeded draw per call from a per-point stream keyed by
``(seed, crc32(point))``).

``on_crash(fn)`` registers a listener that runs where a ``crash``
fault fires, before ``InjectedCrash`` propagates (the flight recorder's
hook), and with telemetry on every fired fault marks a ``fault.fired``
instant on the timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
import zlib

import numpy as np

from photon_tpu_torch.resilience.errors import (
    InjectedCrash,
    PoisonError,
    TransientError,
)

INJECTION_POINTS = (
    "ingest.plan",
    "ingest.chunk",
    "compile.aot",
    "transfer.packed",
    "fit.dispatch",
    "serve.dispatch",
    "checkpoint.write",
    "cd.iteration",
    "io.shard_read",
    "io.shard_decode",
    "pilot.ingest",
    "pilot.train",
    "pilot.validate",
    "pilot.promote",
    "pilot.rollback",
)

_KINDS = ("transient", "poison", "crash", "delay", "sigterm")

ENV_VAR = "PHOTON_TPU_FAULT_PLAN"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injected fault: where, when, and what."""

    point: str
    error: str = "transient"  # transient | poison | crash | delay | sigterm
    nth: int | None = None  # fire on the Nth call (1-based), once
    probability: float | None = None  # else: seeded per-call draw
    seconds: float = 0.0  # delay kind: how long to stall
    message: str = ""

    def __post_init__(self):
        if self.point not in INJECTION_POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r} "
                f"(known: {', '.join(INJECTION_POINTS)})")
        if self.error not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.error!r} (known: "
                f"{', '.join(_KINDS)})")
        if (self.nth is None) == (self.probability is None):
            raise ValueError(
                "exactly one of nth / probability must be set "
                f"({self.point!r})")
        if self.nth is not None and self.nth < 1:
            raise ValueError(f"nth is 1-based, got {self.nth}")
        if self.probability is not None and not (
            0.0 < self.probability <= 1.0
        ):
            raise ValueError(
                f"probability must be in (0, 1], got {self.probability}")


class FaultPlan:
    """A seeded, replayable set of fault specs.

    Determinism contract: for a fixed (specs, seed) and a fixed
    per-point call sequence, the same calls trigger the same faults —
    per-point RNG substreams are keyed by ``(seed, crc32(point))`` so
    points never perturb each other, and nth-call counters are advanced
    under the module lock so concurrent callers count exactly.
    """

    def __init__(self, specs, *, seed: int = 0):
        self.specs = tuple(
            s if isinstance(s, FaultSpec) else FaultSpec(**s)
            for s in specs
        )
        self.seed = int(seed)
        self._by_point: dict[str, list[FaultSpec]] = {}
        for s in self.specs:
            self._by_point.setdefault(s.point, []).append(s)
        self._counts = {p: 0 for p in self._by_point}
        self._rngs = {
            p: np.random.default_rng(
                [self.seed, zlib.crc32(p.encode("utf-8"))]
            )
            for p in self._by_point
        }
        self._armed_nth: set[tuple[str, int]] = set()
        self._fired: list[dict] = []

    @staticmethod
    def from_json(blob: str | dict) -> "FaultPlan":
        """Build a plan from its JSON form:
        ``{"seed": 7, "faults": [{"point": ..., "nth": 1, ...}, ...]}``."""
        raw = json.loads(blob) if isinstance(blob, str) else dict(blob)
        return FaultPlan(raw.get("faults", ()), seed=raw.get("seed", 0))

    def _advance(self, point: str) -> FaultSpec | None:
        """Count one call to ``point`` and return the triggered spec, if
        any. Takes the module lock itself: counters and the fired log
        stay exact under concurrent callers from every pool."""
        with _lock:
            specs = self._by_point.get(point)
            if not specs:
                return None
            self._counts[point] += 1
            call = self._counts[point]
            rng = self._rngs[point]
            for idx, s in enumerate(specs):
                if s.nth is not None:
                    if (
                        call == s.nth
                        and (point, idx) not in self._armed_nth
                    ):
                        self._armed_nth.add((point, idx))
                        self._fired.append({
                            "point": point, "call": call,
                            "error": s.error,
                        })
                        return s
                elif rng.random() < s.probability:
                    self._fired.append({
                        "point": point, "call": call, "error": s.error,
                    })
                    return s
            return None


_lock = threading.Lock()
_active: FaultPlan | None = None
# Crash-fault listeners, called (point, message) where a ``crash``-kind
# fault fires, before ``InjectedCrash`` propagates: how the flight
# recorder (obs/flight.py) leaves a post-mortem even when a caller
# catches the crash. Registered under ``_lock``; called outside it, and
# a listener that raises is logged, never raised over the crash.
_crash_listeners: list = []


def on_crash(fn) -> None:
    """Register ``fn(point, message)`` to run when a ``crash``-kind
    fault fires (at the raise point, before ``InjectedCrash``)."""
    with _lock:
        _crash_listeners.append(fn)


def remove_crash_listener(fn) -> None:
    """Unregister a crash listener. Idempotent."""
    with _lock:
        try:
            _crash_listeners.remove(fn)
        except ValueError:
            pass


def arm(plan: FaultPlan) -> None:
    """Make ``plan`` the process's active fault plan."""
    global _active
    with _lock:
        _active = plan


def disarm() -> None:
    global _active
    with _lock:
        _active = None


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """Scope guard: arm ``plan`` for the block, disarm after."""
    arm(plan)
    try:
        yield plan
    finally:
        disarm()


def arm_from_env(env_var: str = ENV_VAR) -> FaultPlan | None:
    """Arm a plan from ``PHOTON_TPU_FAULT_PLAN`` (JSON, or ``@path`` to
    a JSON file): how a test reaches into a CLI process.
    Returns the armed plan, or None when the variable is unset."""
    raw = os.environ.get(env_var)
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    plan = FaultPlan.from_json(raw)
    arm(plan)
    return plan


def _fault_instant(point: str, error: str) -> None:
    """Mark a fired fault on the trace timeline (a no-op with telemetry
    off)."""
    try:
        from photon_tpu_torch.obs import trace as obs_trace

        obs_trace.instant("fault.fired", cat="fault", point=point,
                          error=error)
    except Exception:  # noqa: BLE001 - telemetry never alters a fault
        pass


def fired() -> list[dict]:
    """Snapshot of the active plan's fired-fault log (empty when no
    plan is armed or nothing fired)."""
    with _lock:
        return list(_active._fired) if _active is not None else []


def check(point: str) -> None:
    """The injection hook production code calls at each boundary.

    Disarmed (the production default): ONE module-global read, no lock,
    no allocation. Armed: counts the call and executes any triggered
    spec — raising for transient/poison/crash kinds, stalling for
    delay, signalling for sigterm — with the stall/raise OUTSIDE the
    module lock.
    """
    if _active is None:
        return
    plan = _active
    spec = plan._advance(point) if plan is not None else None
    if spec is None:
        return
    msg = spec.message or f"injected {spec.error} fault at {point}"
    _fault_instant(point, spec.error)
    if spec.error == "transient":
        raise TransientError(msg)
    if spec.error == "poison":
        raise PoisonError(msg)
    if spec.error == "crash":
        with _lock:
            listeners = list(_crash_listeners)
        for fn in listeners:
            try:
                fn(point, msg)
            except Exception:  # noqa: BLE001 - a listener (the flight
                # recorder's dump) never replaces the injected crash.
                logging.getLogger(__name__).exception(
                    "crash-fault listener raised at %s", point)
        raise InjectedCrash(msg)
    if spec.error == "sigterm":
        import signal

        os.kill(os.getpid(), signal.SIGTERM)
        # Give the interpreter a beat to run the handler on the main
        # thread (delivery is asynchronous when called off-main-thread).
        time.sleep(0.05)
        return
    time.sleep(spec.seconds)
