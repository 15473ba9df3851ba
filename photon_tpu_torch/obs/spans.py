"""Hierarchical span tracer: one tree answering "where did the time go"
(port of ``photon_tpu/obs/spans.py``).

Thread-safe, hierarchical spans recording wall seconds and, at span
roots only, the host/device split:

- **Nothing on the device.** A span is host bookkeeping around work the
  host issues; it adds no launch and no copy.
- **Device time only where asked.** A span given ``sync=...`` (or
  ``span.sync = outputs`` before exit) waits at exit for the CUDA
  tensors in it, by synchronizing the current stream of each tensor's
  device, and records the wait as ``device_wait_seconds``. A CPU tensor
  needs no wait. Only coarse spans pass ``sync``; per-iteration code
  never does, so a span adds no host sync to a loop.
- **Disabled is free.** With the tracer disabled ``span()`` is one flag
  check yielding None.

Hierarchy is per thread: each thread keeps its own span stack, and a
span's ``path`` is its ancestors' names joined by ``/`` (pool threads,
such as the ingest planners, root their own subtrees). Paths are
aggregated at export time (``obs/export.py``).

Threading: the completed-span ring and its drop counter are guarded by
``SpanTracer._lock``; the per-thread stacks are ``threading.local``. The
``enabled`` flag is read unguarded, once per span entry: a racing
toggle gains or loses one span at the boundary, never corrupts one.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

# Default bound on completed spans: a long run must not grow host
# memory linearly. The oldest drop first and are counted.
_MAX_SPANS = 4096


def _cuda_devices(tree, out: set) -> None:
    """The CUDA devices of the tensors in a nest of tuples, lists and
    dicts."""
    import torch

    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)


def wait_for(tree) -> None:
    """Wait for the device work behind the CUDA tensors in ``tree``:
    synchronize the current stream of each one's device."""
    import torch

    devices: set = set()
    _cuda_devices(tree, devices)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class Span:
    """One completed (or in-flight) timed section."""

    __slots__ = ("name", "path", "thread", "t0", "t1", "seconds",
                 "device_wait_seconds", "sync", "attrs")

    def __init__(self, name: str, path: str, thread: str):
        self.name = name
        self.path = path
        self.thread = thread
        self.t0 = 0.0
        self.t1 = 0.0
        self.seconds = 0.0
        # Seconds blocked at exit waiting for ``sync``'s device work;
        # None for a host-only span.
        self.device_wait_seconds: float | None = None
        self.sync = None
        self.attrs: dict | None = None

    def to_json(self) -> dict:
        return {
            "type": "span",
            "path": self.path,
            "name": self.name,
            "thread": self.thread,
            "seconds": round(self.seconds, 6),
            "device_wait_seconds": (
                None if self.device_wait_seconds is None
                else round(self.device_wait_seconds, 6)
            ),
            "attrs": self.attrs or {},
        }


class SpanTracer:
    """Thread-safe span recorder with per-thread hierarchy; the
    process-global one is ``photon_tpu_torch.obs.TRACER``, and
    ``obs.enable()``/``disable()`` flip recording for the whole
    telemetry layer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: deque[Span] = deque(maxlen=_MAX_SPANS)
        self.dropped = 0
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def set_retention(self, max_spans: int) -> None:
        """Rebind the completed-span ring to a new bound (the newest
        kept); spans a shrinking bound evicts count as drops."""
        if max_spans < 1:
            raise ValueError(f"span retention must be >= 1, got {max_spans}")
        with self._lock:
            evicted = max(0, len(self._spans) - int(max_spans))
            self._spans = deque(self._spans, maxlen=int(max_spans))
            self.dropped += evicted
        if evicted:
            from photon_tpu_torch.obs.metrics import REGISTRY

            REGISTRY.counter("spans_dropped_total").inc(evicted)

    def completed(self) -> list[Span]:
        """Snapshot of the completed spans, in record order."""
        with self._lock:
            return list(self._spans)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, *, sync=None, attrs: dict | None = None):
        """Record a named section; yields the live Span, or None when
        telemetry is disabled (callers tolerate both). ``sync``: tensors
        to wait for at exit (``wait_for``), the wait recorded as
        ``device_wait_seconds``."""
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        path = f"{stack[-1].path}/{name}" if stack else name
        sp = Span(name, path, threading.current_thread().name)
        if attrs:
            sp.attrs = dict(attrs)
        sp.sync = sync
        stack.append(sp)
        sp.t0 = time.perf_counter()
        try:
            yield sp
        finally:
            t1 = time.perf_counter()
            try:
                if sp.sync is not None:
                    # Cleared before waiting: the record pins no device
                    # memory, even when the wait raises.
                    sync, sp.sync = sp.sync, None
                    wait_for(sync)
                    t_done = time.perf_counter()
                    sp.device_wait_seconds = t_done - t1
                    t1 = t_done
            finally:
                # Pop and record even when the wait raised: the
                # thread's stack must not keep a dead span.
                sp.t1 = t1
                sp.seconds = t1 - sp.t0
                stack.pop()
                evicted = False
                with self._lock:
                    if len(self._spans) == self._spans.maxlen:
                        self.dropped += 1
                        evicted = True
                    self._spans.append(sp)
                if evicted:
                    # Outside the tracer lock, never nested with the
                    # registry's.
                    from photon_tpu_torch.obs.metrics import REGISTRY

                    REGISTRY.counter("spans_dropped_total").inc()


def aggregate(spans: list[Span]) -> dict[str, dict]:
    """Path -> {count, seconds, device_wait_seconds} over completed
    spans, paths sorted; ``device_wait_seconds`` sums only the
    occurrences that waited (None when none did)."""
    out: dict[str, dict] = {}
    for sp in spans:
        agg = out.setdefault(
            sp.path,
            {"count": 0, "seconds": 0.0, "device_wait_seconds": None},
        )
        agg["count"] += 1
        agg["seconds"] += sp.seconds
        if sp.device_wait_seconds is not None:
            agg["device_wait_seconds"] = (
                agg["device_wait_seconds"] or 0.0
            ) + sp.device_wait_seconds
    for agg in out.values():
        agg["seconds"] = round(agg["seconds"], 6)
        if agg["device_wait_seconds"] is not None:
            agg["device_wait_seconds"] = round(agg["device_wait_seconds"], 6)
    return dict(sorted(out.items()))
