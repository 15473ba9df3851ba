"""Pipelined ingest: executors, stage accounting and the packed transfer
(port of ``photon_tpu/data/pipeline.py``).

The host planner runs numpy passes and then sends its plan arrays to the
device. Run serially, planning the coordinates one after another and
copying each array on its own, those costs add. This module owns what
overlaps them:

- **Planning executors** (``plan_executor`` / ``chunk_executor``): the
  per-coordinate planners run concurrently (the hot numpy ops, radix
  argsort, bincount and fancy gathers, release the GIL), and elementwise
  row passes inside a coordinate chunk over rows (``map_chunked`` /
  ``bincount_chunked``: exact and order-preserving, so the result is
  BIT-IDENTICAL to the serial path; the deterministic reservoir hash
  order is the contract). Two separate pools: coordinate tasks block on
  their own chunk tasks, so running both levels on one bounded pool could
  deadlock (every worker waiting on queued chunks). No planning thread
  makes a CUDA call: device work stays on the calling thread.
- **One packed, chunked, double-buffered transfer**
  (``packed_to_device``): every plan array of a build goes to the device
  as one int32 buffer, allocated up front on the device; the host fills
  a pinned staging chunk while the previous chunk's copy drains on a
  side stream, two staging buffers with an event each, every chunk
  written into its slice of the final buffer (no concatenate, so peak
  device memory is 1x). Below one chunk it is one copy. The layout is
  byte-identical either way.
- **The compile pool** (``compile_executor``, two workers): the fused
  fit's warm capture (``GameEstimator._warm_capture``) runs there while
  the planner works, as the reference's ahead-of-time compile does. Its
  ``compile`` stage is the capture; the first fit's ``compile_wait`` is
  the part the planning did not hide. It is the one pool thread that
  makes CUDA calls (allocations, kernels and the capture itself, never
  a copy from the host).
- **PIPELINE_STATS**: per-stage seconds (plan / pack / transfer /
  compile / compile_wait and the streaming stages), reset per prepare.

``PHOTON_TPU_SERIAL_INGEST=1`` forces everything back to the serial
in-line path (the determinism tests diff the two);
``PHOTON_TPU_INGEST_THREADS`` bounds the chunk pool;
``PHOTON_TPU_TRANSFER_CHUNK_MB`` sets the transfer chunk (default 64).
With telemetry on, every stage is also a ``pipeline/<stage>`` span and
a histogram sample.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

logger = logging.getLogger(__name__)


def serial_ingest() -> bool:
    """True when the serial reference path is forced."""
    return os.environ.get("PHOTON_TPU_SERIAL_INGEST", "") == "1"


def ingest_threads() -> int:
    raw = os.environ.get("PHOTON_TPU_INGEST_THREADS", "")
    if raw.isdigit() and int(raw) > 0:
        return int(raw)
    return min(8, os.cpu_count() or 1)


# Minimum rows before an elementwise pass is worth chunking across
# threads: below this the submit/join overhead exceeds the work.
_CHUNK_MIN_ROWS = 1 << 19
_TRANSFER_GRANULE_ELEMS = (4 << 20) // 4  # 4 MiB of int32 elements


def transfer_chunk_elems() -> int:
    """Transfer chunk size in int32 elements (PHOTON_TPU_TRANSFER_CHUNK_MB,
    default 64 MiB), rounded up to the packed buffer's 4 MiB granule."""
    raw = os.environ.get("PHOTON_TPU_TRANSFER_CHUNK_MB", "")
    mb = int(raw) if raw.isdigit() and int(raw) > 0 else 64
    elems = (mb << 20) // 4
    g = _TRANSFER_GRANULE_ELEMS
    return max(-(-elems // g) * g, g)


class _Immediate(Future):
    """Already-resolved future for the serial in-line path."""

    def __init__(self, result=None, exc=None):
        super().__init__()
        if exc is not None:
            self.set_exception(exc)
        else:
            self.set_result(result)


class _Pool:
    """Lazy thread pool that degrades to in-line execution when serial
    ingest is forced (or only one worker would exist)."""

    def __init__(self, name: str, workers):
        self._name = name
        self._workers = workers  # int or callable () -> int
        self._pool: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()

    def _resolve_workers(self) -> int:
        w = self._workers
        return w() if callable(w) else w

    def submit(self, fn, *args, **kwargs) -> Future:
        if serial_ingest() or self._resolve_workers() <= 1:
            try:
                return _Immediate(fn(*args, **kwargs))
            except Exception as exc:  # noqa: BLE001 — parity with Future
                return _Immediate(exc=exc)
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._resolve_workers(),
                    thread_name_prefix=self._name,
                )
            # Submit inside the lock: shutdown() swaps the pool out under
            # it, so a submit cannot land on an executor past shutdown.
            return self._pool.submit(fn, *args, **kwargs)

    def shutdown(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)


# Coordinate-level planning tasks (each may block on its own chunk
# tasks, hence the separate pool).
plan_executor = _Pool("photon-plan", 4)
chunk_executor = _Pool("photon-chunk", ingest_threads)
# The warm capture during prepare.
compile_executor = _Pool("photon-compile", 2)


def reset_executors() -> None:
    """Drop the pools so the next use re-reads the environment; a
    failing shutdown still shuts the remaining pools down."""
    try:
        plan_executor.shutdown()
    finally:
        try:
            chunk_executor.shutdown()
        finally:
            compile_executor.shutdown()


def consume_futures(futs) -> list:
    """``[f.result() for f in futs]`` that waits for EVERY future: the
    first exception propagates after the rest completed, later ones are
    logged, so no worker's failure is dropped."""
    results: list = []
    first_exc: Exception | None = None
    for f in futs:
        try:
            results.append(f.result())
        # Exception, not BaseException: a KeyboardInterrupt delivered
        # while blocked in result() aborts the wait at once.
        except Exception as exc:  # noqa: BLE001 — re-raised below
            if first_exc is None:
                first_exc = exc
            else:
                logger.warning(
                    "additional worker-thunk failure (first is being "
                    "re-raised): %r", exc,
                )
    if first_exc is not None:
        raise first_exc
    return results


class PipelineStats:
    """Thread-safe per-stage wall-clock accounting for one ingest.

    Stage seconds ACCUMULATE (two coordinates planning concurrently both
    add their seconds); the report also keeps the wall span per stage.
    """

    def __init__(self):
        self._stats_lock = threading.Lock()
        self._generation = 0
        self.reset()

    def reset(self, keep: tuple = ()) -> None:
        """Start a new accounting generation. A stage entered before the
        reset records nothing when it finishes; ``keep`` names stages
        whose accumulation survives (the raw-data transfer, recorded when
        the dataset is built, before any estimator exists)."""
        with self._stats_lock:
            def kept(attr):
                return {k: v for k, v in getattr(self, attr, {}).items()
                        if k in keep}

            seconds, spans, counts = (kept("_seconds"), kept("_spans"),
                                      kept("_counts"))
            self._generation += 1
            self._seconds: dict[str, float] = seconds
            self._spans: dict[str, list[float]] = spans
            self._counts: dict[str, int] = counts
            self._transfers: list[dict] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        # Every stage is also a ``pipeline/<stage>`` span (a pool
        # thread's roots its own subtree) and a ``pipeline_stage_seconds``
        # histogram sample; both are no-ops with telemetry off, and this
        # accounting stays authoritative either way.
        from photon_tpu_torch import obs

        with self._stats_lock:
            gen = self._generation
        t0 = time.perf_counter()
        try:
            with obs.span(f"pipeline/{name}"):
                yield
        finally:
            t1 = time.perf_counter()
            with self._stats_lock:
                # A stale generation (reset() ran mid-stage) records
                # nothing here, nor in the histogram.
                if gen == self._generation:
                    if obs.enabled():
                        obs.REGISTRY.histogram(
                            "pipeline_stage_seconds", stage=name
                        ).observe(t1 - t0)
                    self._seconds[name] = self._seconds.get(
                        name, 0.0) + (t1 - t0)
                    self._counts[name] = self._counts.get(name, 0) + 1
                    span = self._spans.get(name)
                    if span is None:
                        self._spans[name] = [t0, t1]
                    else:
                        span[0] = min(span[0], t0)
                        span[1] = max(span[1], t1)

    def add(self, name: str, seconds: float) -> None:
        with self._stats_lock:
            self._seconds[name] = self._seconds.get(name, 0.0) + seconds
            self._counts[name] = self._counts.get(name, 0) + 1

    def seconds(self, name: str) -> float:
        with self._stats_lock:
            return self._seconds.get(name, 0.0)

    def note_transfer(self, record: dict) -> None:
        with self._stats_lock:
            self._transfers.append(dict(record))

    def transfers(self) -> list[dict]:
        """One record per packed transfer of this generation: bytes,
        chunks, seconds and whether it took the chunked path."""
        with self._stats_lock:
            return [dict(t) for t in self._transfers]

    def report(self) -> dict:
        """The JSON-ready stage breakdown. ``compile_overlap_fraction``
        is measured: the warm capture's seconds less the seconds the
        first fit waited for it, over the capture's seconds (None when
        no warm capture ran)."""
        with self._stats_lock:
            seconds = dict(self._seconds)
            spans = {k: tuple(v) for k, v in self._spans.items()}
        compile_s = seconds.get("compile", 0.0)
        wait_s = seconds.get("compile_wait", 0.0)
        overlap = (max(0.0, min(1.0, 1.0 - wait_s / compile_s))
                   if compile_s > 0.0 else None)
        out = {
            "plan_seconds": round(seconds.get("plan", 0.0), 4),
            "pack_seconds": round(seconds.get("pack", 0.0), 4),
            "transfer_seconds": round(seconds.get("transfer", 0.0), 4),
            "compile_seconds": round(compile_s, 4),
            "compile_wait_seconds": round(wait_s, 4),
            "compile_overlap_fraction": (
                None if overlap is None else round(overlap, 4)),
            "stages": {k: round(v, 4) for k, v in sorted(seconds.items())},
        }
        plan_span = spans.get("plan")
        if plan_span is not None:
            out["plan_wall_seconds"] = round(plan_span[1] - plan_span[0], 4)
        return out


PIPELINE_STATS = PipelineStats()


# --------------------------------------------------------------------------
# chunked host passes (bit-identical to the serial forms)
# --------------------------------------------------------------------------


def _chunk_bounds(n: int, workers: int) -> list[tuple[int, int]]:
    per = -(-n // workers)
    return [(lo, min(lo + per, n)) for lo in range(0, n, per)]


def map_chunked(fn, out: np.ndarray, *arrays: np.ndarray) -> np.ndarray:
    """``out[lo:hi] = fn(*[a[lo:hi] for a in arrays])`` over disjoint row
    chunks. For ELEMENTWISE ``fn`` only: chunking is then exact, so the
    result is byte-identical to ``out[:] = fn(*arrays)``. Serial mode
    (or a small input) takes the one-shot path."""
    n = out.shape[0]
    workers = ingest_threads()
    if serial_ingest() or workers <= 1 or n < _CHUNK_MIN_ROWS:
        out[:] = fn(*arrays)
        return out

    def run(lo: int, hi: int) -> None:
        from photon_tpu_torch.resilience import faults

        # A chunk worker dying mid-pass surfaces through consume_futures
        # and never leaves a span of the output unwritten silently.
        faults.check("ingest.chunk")
        out[lo:hi] = fn(*[a[lo:hi] for a in arrays])

    consume_futures([chunk_executor.submit(run, lo, hi)
                     for lo, hi in _chunk_bounds(n, workers)])
    return out


def bincount_chunked(codes: np.ndarray, minlength: int) -> np.ndarray:
    """Exact parallel ``np.bincount``: partial integer counts sum
    associatively, so the chunked result is identical."""
    n = codes.shape[0]
    workers = ingest_threads()
    if serial_ingest() or workers <= 1 or n < _CHUNK_MIN_ROWS:
        return np.bincount(codes, minlength=minlength)
    parts = consume_futures([
        chunk_executor.submit(np.bincount, codes[lo:hi], minlength=minlength)
        for lo, hi in _chunk_bounds(n, workers)])
    total = parts[0].astype(np.int64, copy=True)
    for p in parts[1:]:
        total += p
    return total


# --------------------------------------------------------------------------
# the packed transfer
# --------------------------------------------------------------------------


def padded_len(n: int) -> int:
    """Packed-buffer length after granule padding."""
    g = _TRANSFER_GRANULE_ELEMS
    return max(-(-n // g) * g, g)


def packable(a: np.ndarray) -> bool:
    """Whether ``a`` rides the int32 packed buffer: int32 as it is,
    float32 by its bits (a view on the device restores it)."""
    return np.dtype(a.dtype) in (np.dtype(np.int32), np.dtype(np.float32))


def _words(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.int32)


class _Layout:
    """The packed layout of ``arrays``: their int32 words back to back,
    zero padding to ``n_pad``. ``fill`` writes any window of it."""

    def __init__(self, arrays):
        self.words = [_words(a) for a in arrays]
        sizes = [w.size for w in self.words]
        self.starts = np.concatenate([[0], np.cumsum(sizes)]).astype(
            np.int64)
        self.n = int(self.starts[-1])
        self.n_pad = padded_len(self.n)

    def fill(self, dst: np.ndarray, lo: int, hi: int) -> None:
        """dst[: hi - lo] = layout[lo:hi]."""
        first = int(np.searchsorted(self.starts, lo, side="right")) - 1
        pos = lo
        for i in range(max(first, 0), len(self.words)):
            s = int(self.starts[i])
            if s >= hi:
                break
            w = self.words[i]
            a, b = max(pos - s, 0), min(hi - s, w.size)
            if b > a:
                dst[pos - lo:pos - lo + (b - a)] = w[a:b]
                pos += b - a
        if pos < hi:
            dst[pos - lo:hi - lo] = 0


def packed_to_device(arrays, device) -> tuple[torch.Tensor, tuple]:
    """Place the packed int32 layout of ``arrays`` (int32 or float32
    numpy arrays) on ``device``; returns ``(buf, shapes)``.

    The transfer is a retried site: a transient host-to-device failure
    (or the injected ``transfer.packed`` fault) re-runs the whole copy,
    which is pure (host arrays in, a fresh device buffer out)."""
    from photon_tpu_torch.resilience import retry

    device = torch.device(device)
    return retry.retrying_check(
        "transfer.packed", lambda: _packed_to_device_once(arrays, device),
        site="ingest.packed_transfer")


def _packed_to_device_once(arrays, device) -> tuple[torch.Tensor, tuple]:
    shapes = tuple(tuple(a.shape) for a in arrays)
    layout = _Layout(arrays)
    chunk = transfer_chunk_elems()
    t0 = time.perf_counter()
    if serial_ingest() or layout.n_pad <= chunk:
        with PIPELINE_STATS.stage("pack"):
            flat = np.empty(layout.n_pad, dtype=np.int32)
            layout.fill(flat, 0, layout.n_pad)
        with PIPELINE_STATS.stage("transfer"):
            buf = torch.from_numpy(flat).to(device)
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
        chunks = 1
    else:
        with PIPELINE_STATS.stage("transfer"):
            buf = torch.empty(layout.n_pad, dtype=torch.int32,
                              device=device)
            if device.type == "cuda":
                chunks = _chunked_cuda(layout, buf, chunk, device)
            else:
                staging = np.empty(chunk, dtype=np.int32)
                chunks = 0
                for lo in range(0, layout.n_pad, chunk):
                    hi = min(lo + chunk, layout.n_pad)
                    layout.fill(staging, lo, hi)
                    buf[lo:hi].copy_(torch.from_numpy(staging[:hi - lo]))
                    chunks += 1
    PIPELINE_STATS.note_transfer({
        "bytes": 4 * layout.n_pad, "payload_bytes": 4 * layout.n,
        "arrays": len(shapes), "chunks": chunks,
        "seconds": time.perf_counter() - t0})
    return buf, shapes


def _chunked_cuda(layout: _Layout, buf: torch.Tensor, chunk: int,
                  device) -> int:
    """Double-buffered copy: staging buffer k % 2 is refilled only after
    the event recorded behind its previous copy has completed, while the
    other chunk's copy drains on the side stream."""
    side = torch.cuda.Stream(device)
    # ``buf``'s memory may have been freed by work still queued on the
    # current stream: the copies wait for it.
    side.wait_stream(torch.cuda.current_stream(device))
    size = min(chunk, layout.n_pad)
    staging = [torch.empty(size, dtype=torch.int32, pin_memory=True)
               for _ in range(2)]
    views = [s.numpy() for s in staging]
    events: list = [None, None]
    chunks = 0
    with torch.cuda.stream(side):
        for lo in range(0, layout.n_pad, chunk):
            hi = min(lo + chunk, layout.n_pad)
            k = chunks % 2
            if events[k] is not None:
                events[k].synchronize()
            layout.fill(views[k], lo, hi)
            buf[lo:hi].copy_(staging[k][:hi - lo], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
            events[k] = ev
            chunks += 1
    for ev in events:
        if ev is not None:
            ev.synchronize()
    torch.cuda.current_stream(device).wait_stream(side)
    return chunks
