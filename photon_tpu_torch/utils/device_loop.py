"""Loops whose condition is a device boolean: the port's counterpart of
``lax.while_loop`` (and of ``lax.cond`` for a body that runs at most
once).

A loop is given as ``cond() -> mask`` (a bool tensor: the loop runs
while any element is set), ``body(mask)`` and ``state``, the objects
whose tensor attributes are the loop's carry (a solver's state object, a
``types.SimpleNamespace`` of locals). The body reads the carry from
those attributes and leaves the next carry in them, by reassigning an
attribute or by writing into its tensor in place.

- **Eagerly** (on the CPU, or on the card outside a capture) the loop is
  a Python loop: each step asks ``any_running(mask)``, the caller's own
  counted host sync, and runs the body while it says yes. That is the
  solvers' loop as it always ran, sync for sync and launch for launch.
- **Under a capture** (inside ``capture``) the loop becomes a conditional
  node of the CUDA graph, built by ``csrc/graph_loop.cu``: a WHILE node
  (an IF node for ``cond_apply``) whose body graph is captured once, on a
  stream of its own, by running ``body`` there. At the end of the body
  each reassigned carry tensor is copied into the buffer it had at loop
  entry (the body graph reads those addresses on every pass), then the
  mask is computed again and a one-thread kernel sets the node's handle
  from it. (The entry buffers are copies made as the loop is captured,
  so no carry aliases another tensor.) So the card runs every iteration with no host sync; the
  condition is never read on the host. The body's allocations go to a
  private memory pool that lives as long as the graph.

``capture`` wraps ``torch.cuda.graph``: it sets up the pool the loop
bodies allocate from and counts the nodes of every body graph
(``Capture.body_nodes``). One capture runs at a time in the process,
whatever its thread (the ingest pipeline's compile pool captures the
fused fit while the main thread plans): ``capture`` holds the module's
capture lock from its entry, where torch synchronizes and empties the
allocator's cache, to its end. ``torch.cuda.empty_cache()`` fails while
any thread captures; ``empty_cache`` here waits for the capture to end
first, and ``exclusive`` keeps any other capture out.

A kernel wrapper's Python launch counter sees a captured launch once,
at its capture, however many times the replays run it (a WHILE body
runs once an iteration). ``count_graph_launches(device)`` makes the
counts exact: from then on a wrapper that launches under a capture
(``note_launch``) also captures an add into a device counter of its
kernel, so each replay counts on the card what it launched
(``graph_launches``). Off, the default, it adds nothing to a graph.

``observing(observer)`` hands this thread's loops and launches to the
program tier (``analysis/program.py``): each loop's body is bracketed by
``observer.mark`` calls and each kernel launch is marked with its
statics. With ``unroll=True`` (the tier's CPU trace) an eager loop runs
its body exactly once and never asks its condition on the host, as a
capture records it; the values it leaves are not a solve's.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
import weakref
from typing import Callable, Iterable

import torch

SOURCE = "photon_tpu_torch/csrc/graph_loop.cu"
_WHILE, _IF = 0, 1

_local = threading.local()
# Held for the whole of a capture (``capture``, ``exclusive``).
_capture_lock = threading.Lock()
# Device launch counters by kernel name (``count_graph_launches``).
_GRAPH_KERNELS = ("newton_step", "segment_sum")
_graph_counts: dict = {}
_begin_fn = None
_end_fn = None
_count_fn = None


def _load() -> None:
    global _begin_fn, _end_fn, _count_fn
    if _begin_fn is not None:
        return
    from photon_tpu_torch.ops import _build

    lib = _build.library()
    begin = lib.photon_graph_cond_begin
    begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong)]
    begin.restype = ctypes.c_int
    end = lib.photon_graph_cond_end
    end.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p,
                    ctypes.c_int, ctypes.POINTER(ctypes.c_size_t)]
    end.restype = ctypes.c_int
    count = lib.photon_graph_node_count
    count.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    count.restype = ctypes.c_int
    _begin_fn, _end_fn, _count_fn = begin, end, count


class Capture:
    """One graph capture in progress (see ``capture``)."""

    def __init__(self, graph, device: torch.device):
        self.graph = graph
        self.device = device
        self.depth = 0
        self.body_nodes = 0
        self.conditional_nodes = 0
        # One body stream per nesting depth (``_body_streams``).
        self.streams: list = []
        # The loop bodies' memory pool (see ``capture``).
        self.pool = None


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUDA error {rc}")


_STREAMS: dict = {}
# Captures run on streams of the high-priority pool, which nothing else
# in the process draws from: ``torch.cuda.Stream()`` hands out a pool's
# streams round robin, so a default-priority capture stream can be the
# very stream another thread is enqueuing work on (a transfer, an eager
# pass), and that work would land in the capture.
CAPTURE_PRIORITY = -1
# Nesting depth the body streams cover (a solver's outer loop, its line
# search, and the fixed effect's loops nested in nothing deeper).
_MAX_DEPTH = 4


def _body_streams(device: torch.device) -> list:
    """Per device and thread, the capture stream and one stream per
    nesting depth (``CAPTURE_PRIORITY``), each warmed once by a small
    matmul so the thread's cuBLAS workspace for it exists before any
    capture."""
    key = (device.index if device.index is not None else
           torch.cuda.current_device(), threading.get_ident())
    streams = _STREAMS.get(key)
    if streams is None:
        streams = []
        for _ in range(_MAX_DEPTH + 1):
            s = torch.cuda.Stream(device=device, priority=CAPTURE_PRIORITY)
            s.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(s):
                a = torch.ones((2, 2), device=device)
                (a @ a).sum()
                torch.einsum("bij,bj->bi", a[None], a[:1])
            torch.cuda.current_stream(device).wait_stream(s)
            streams.append(s)
        _STREAMS[key] = streams
    return streams


def count_graph_launches(device) -> None:
    """From now on count, on the card, every launch of the wrapped
    kernels that a graph captured on ``device`` replays. Make this call
    before the captures whose launches it should count: the counters
    exist before any capture, so no graph resets them."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    for name in _GRAPH_KERNELS:
        if (name, idx) not in _graph_counts:
            _graph_counts[(name, idx)] = torch.zeros(
                (), dtype=torch.int64, device=torch.device("cuda", idx))


@contextlib.contextmanager
def observing(observer, *, unroll: bool = False):
    """Report this thread's loops and launches to ``observer`` (its
    ``mark(text)``); ``unroll``: run each eager loop body once."""
    prev = getattr(_local, "observer", None)
    _local.observer = (observer, unroll)
    try:
        yield observer
    finally:
        _local.observer = prev


def _mark(text: str) -> None:
    obs = getattr(_local, "observer", None)
    if obs is not None:
        obs[0].mark(text)


def _unrolled() -> bool:
    obs = getattr(_local, "observer", None)
    return obs is not None and obs[1]


def note_launch(name: str, device: torch.device, detail: str = "") -> None:
    """A wrapper's hook, right after it launches ``name`` on ``device``
    (``detail``: the launch's statics, for an observer): under a capture
    with counting on, capture one add into the kernel's device
    counter."""
    _mark(f"launch {name} {detail}".rstrip())
    if (not _graph_counts or device.type != "cuda"
            or not torch.cuda.is_current_stream_capturing()):
        return
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    counter = _graph_counts.get((name, idx))
    if counter is not None:
        counter.add_(1)


def graph_launches(name: str) -> int:
    """Launches of ``name`` that graph replays ran since the last
    ``reset_graph_launches`` (one host sync); 0 with counting off."""
    return sum(int(t.item()) for (n, _), t in _graph_counts.items()
               if n == name)


def reset_graph_launches() -> None:
    for t in _graph_counts.values():
        t.zero_()


def new_graph():
    """A ``torch.cuda.CUDAGraph`` that keeps its ``cudaGraph_t`` after
    capture where this torch allows it (for the node count)."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return torch.cuda.CUDAGraph()


@contextlib.contextmanager
def exclusive():
    """Hold the capture lock: no ``capture`` runs meanwhile, in any
    thread (a serving ladder's capture takes it too)."""
    with _capture_lock:
        yield


def empty_cache() -> None:
    """``torch.cuda.empty_cache()`` once no capture is in progress."""
    with _capture_lock:
        torch.cuda.empty_cache()


@contextlib.contextmanager
def capture(graph, device, stream=None):
    """Capture ``graph`` (``torch.cuda.graph``) with device loops
    enabled; yields the ``Capture``.

    The capture is thread-local: work of other threads (a serving
    queue, an ingest worker) cannot invalidate it; and the garbage
    collector is paused for its length. Destroying a graph frees device
    memory, which invalidates a capture in progress: a collected graph
    cannot, and a caller must not drop its last reference to an old
    graph (or to the ``Capture`` that holds it) inside a new capture. Loop bodies allocate
    from a second private pool, routed by thread
    (torch's graph pool takes only its own capture stream's
    allocations). That pool lives as long as ``graph``: a finalizer
    releases it when the graph is collected."""
    device = torch.device(device)
    _load()
    with _capture_lock:
        streams = _body_streams(device)
        cap = Capture(graph, device)
        # The last stream is this thread's capture stream (torch's default
        # one is shared by every thread).
        cap.streams = streams[:-1]
        if stream is None:
            stream = streams[-1]
        cap.pool = torch.cuda.graph_pool_handle()
        idx = device.index if device.index is not None else \
            torch.cuda.current_device()
        prev = getattr(_local, "capture", None)
        _local.capture = cap
        # No collection may run inside the capture: a collected graph or
        # pool frees device memory, which invalidates a capture.
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                torch._C._cuda_beginAllocateCurrentThreadToPool(idx,
                                                                cap.pool)
                try:
                    yield cap
                finally:
                    torch._C._cuda_endAllocateToPool(idx, cap.pool)
        finally:
            _local.capture = prev
            if gc_was_on:
                gc.enable()
            weakref.finalize(graph, torch._C._cuda_releasePool, idx,
                             cap.pool)


def graph_nodes(cap: Capture) -> int | None:
    """Every node of a finished capture: its top level (None where this
    torch does not keep the ``cudaGraph_t``) plus each body graph's."""
    try:
        raw = cap.graph.raw_cuda_graph()
    except (AttributeError, RuntimeError):
        return None
    n = ctypes.c_size_t(0)
    _check(_count_fn(ctypes.c_void_p(raw), ctypes.byref(n)),
           "cudaGraphGetNodes")
    return int(n.value) + cap.body_nodes


def _capturing(mask: torch.Tensor) -> Capture | None:
    if mask.device.type != "cuda":
        return None
    if not torch.cuda.is_current_stream_capturing():
        return None
    cap = getattr(_local, "capture", None)
    if cap is None:
        raise RuntimeError(
            "a device loop met a CUDA-graph capture not made by "
            "device_loop.capture: its body's memory pool is unknown")
    return cap


def _carry(state: Iterable) -> list:
    """The loop-entry buffers: a copy of every tensor attribute of
    ``state``, which the attribute then holds. The body graph reads and
    writes these addresses on every pass, so none may be shared with
    another carry or with a tensor the body reads from outside (the
    line search starts ``f_t`` and ``f_lo`` at the caller's ``f0``)."""
    carry = []
    for obj in state:
        for name, value in list(vars(obj).items()):
            if isinstance(value, torch.Tensor):
                buf = value.clone()
                setattr(obj, name, buf)
                carry.append((obj, name, buf))
    return carry


def _write_back(carry: list, state: Iterable) -> None:
    """Copy each reassigned carry tensor into its loop-entry buffer and
    point the attribute back at the buffer."""
    entry = {(id(obj), name) for obj, name, _ in carry}
    for obj in state:
        for name, value in vars(obj).items():
            if (isinstance(value, torch.Tensor)
                    and (id(obj), name) not in entry):
                raise RuntimeError(
                    f"device loop: {type(obj).__name__}.{name} first set "
                    "inside the body cannot be carried")
    news = []
    bufs = {b.untyped_storage().data_ptr() for _, _, b in carry}
    for obj, name, buf in carry:
        new = getattr(obj, name)
        if new is buf:
            continue
        if new.shape != buf.shape or new.dtype != buf.dtype:
            raise RuntimeError(
                f"device loop: {type(obj).__name__}.{name} changed from "
                f"{tuple(buf.shape)} {buf.dtype} to {tuple(new.shape)} "
                f"{new.dtype} inside the body")
        if new.untyped_storage().data_ptr() in bufs:
            new = new.clone()
        news.append((obj, name, buf, new))
    for obj, name, buf, new in news:
        buf.copy_(new)
        setattr(obj, name, buf)


def _conditional(cap: Capture, kind: int, mask: torch.Tensor,
                 run_body: Callable, cond: Callable | None) -> None:
    flag = mask.any()
    depth = cap.depth
    if depth >= len(cap.streams):
        raise RuntimeError(f"device loops nested deeper than {len(cap.streams)}")
    body_stream = cap.streams[depth]
    outer = torch.cuda.current_stream(cap.device)
    handle = ctypes.c_ulonglong(0)
    _check(_begin_fn(ctypes.c_void_p(outer.cuda_stream),
                     ctypes.c_void_p(body_stream.cuda_stream),
                     ctypes.c_void_p(flag.data_ptr()), kind,
                     ctypes.byref(handle)), "conditional node begin")
    cap.depth += 1
    nodes = ctypes.c_size_t(0)
    ended = False
    try:
        with torch.cuda.stream(body_stream):
            _mark("while {" if kind == _WHILE else "if {")
            run_body()
            if cond is not None:
                again = cond()
                mask.copy_(again)
                torch.any(again, out=flag)
            _mark("}")
            ended = True
            _check(_end_fn(ctypes.c_void_p(body_stream.cuda_stream),
                           handle, ctypes.c_void_p(flag.data_ptr()), kind,
                           ctypes.byref(nodes)), "conditional node end")
    finally:
        cap.depth -= 1
        if not ended:
            # Leave no stream capturing behind a failed body.
            _end_fn(ctypes.c_void_p(body_stream.cuda_stream), handle,
                    ctypes.c_void_p(flag.data_ptr()), _IF,
                    ctypes.byref(nodes))
    cap.body_nodes += int(nodes.value)
    cap.conditional_nodes += 1


def while_loop(cond: Callable[[], torch.Tensor],
               body: Callable[[torch.Tensor], None], state: Iterable, *,
               any_running: Callable[[torch.Tensor], bool]) -> None:
    """Run ``body(mask)`` while ``any_running(mask := cond())``; under a
    capture, as a WHILE node (module docstring)."""
    state = tuple(state)
    mask = cond()
    cap = _capturing(mask)
    if cap is None and _unrolled():
        _mark("while {")
        body(mask)
        cond()
        _mark("}")
        return
    if cap is None:
        while any_running(mask):
            body(mask)
            mask = cond()
        return
    carry = _carry(state)
    mask = mask.clone()

    def run_body():
        body(mask)
        _write_back(carry, state)

    _conditional(cap, _WHILE, mask, run_body, cond)


def cond_apply(mask: torch.Tensor, body: Callable[[], None],
               state: Iterable, *,
               any_running: Callable[[torch.Tensor], bool]) -> None:
    """Run ``body()`` once if ``any_running(mask)``; under a capture, as
    an IF node whose body leaves its results in ``state``'s loop-entry
    buffers."""
    state = tuple(state)
    cap = _capturing(mask)
    if cap is None and _unrolled():
        _mark("if {")
        body()
        _mark("}")
        return
    if cap is None:
        if any_running(mask):
            body()
        return
    carry = _carry(state)

    def run_body():
        body()
        _write_back(carry, state)

    _conditional(cap, _IF, mask, run_body, None)
