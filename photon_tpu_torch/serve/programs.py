"""The serving shape ladder (port of ``photon_tpu/serve/programs.py``).

Requests arrive one at a time; the score kernel takes a padded batch.
The bridge is a ladder of batch rungs (default 1/8/64/512): each batch
of requests is padded up to the nearest rung, padded rows carrying zero
features and code -1 so they score 0 and are sliced away.

On the card every rung is one CUDA graph, captured at server start
(``compile_all``, the counterpart of the JAX package's AOT ladder; the
constructor calls it unless ``compile_now=False``). A graph covers the
host-to-device copies from the rung's static pinned buffers, the fused
serve kernel's launches (``ops/serve_kernel.py``; one per group of
``GROUP_COORDS`` coordinates) and the copy of the scores into a static
pinned output. ``dispatch_padded`` fills the static inputs and replays;
``fetch_padded`` waits on the replay's event and reads the first ``n``
scores. Nothing is built or captured after start, and a rung that was
not captured is refused, not run eagerly. ``stats["programs_compiled"]``
counts the graphs captured and ``stats["aot_compile_seconds"]`` their
capture time, under the JAX package's names.

A ladder's graphs share one memory pool. Each is captured on a side
stream in ``thread_local`` mode, so a new ladder can be captured while
the queue's worker replays the old one on its own thread. A graph holds
the tables' device pointers: a values-only reload must copy into the
live tensors (``CoefficientTables.reload`` does), never rebind them.

``PHOTON_SERVE_KERNEL=off`` (read once, at construction) captures the
kernel's plain PyTorch version instead; the choice is logged and kept
in ``stats["serve_kernel"]``. On the CPU there are no graphs: every
dispatch runs the plain version eagerly (``dispatch_eager``), and
``compile_all`` captures nothing.

``score_dataset`` chunks a whole ``GameDataset`` through the ladder
(``ShapeLadder.chunk_plan``), the batch-scoring route of
``cli/score.py``: each chunk is one eager call of the route chosen at
construction (one kernel launch on the card) on rows sliced from the
dataset's own device tensors, so no chunk is staged through the host.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from photon_tpu_torch.data.dataset import DenseFeatures, SparseFeatures
from photon_tpu_torch.ops import serve_kernel
from photon_tpu_torch.serve.tables import CoefficientTables

log = logging.getLogger(__name__)

def _ledger_key(batch: int) -> str:
    return f"serve/score@{batch}"


@dataclasses.dataclass(frozen=True)
class ShapeLadder:
    """The closed set of batch shapes the server scores."""

    rungs: tuple[int, ...] = (1, 8, 64, 512)

    def __post_init__(self):
        rungs = tuple(sorted(set(int(r) for r in self.rungs)))
        if not rungs or rungs[0] < 1:
            raise ValueError(f"ladder rungs must be >= 1, got {self.rungs}")
        object.__setattr__(self, "rungs", rungs)

    @property
    def max_batch(self) -> int:
        return self.rungs[-1]

    def rung_for(self, n: int) -> int:
        """Smallest rung that holds ``n`` requests."""
        if n < 1:
            raise ValueError("empty batch has no rung")
        for r in self.rungs:
            if n <= r:
                return r
        raise ValueError(
            f"batch of {n} exceeds the ladder max {self.max_batch}; "
            "split it (the queue's max_batch is clamped to the ladder)"
        )

    def chunk_plan(self, n: int) -> list[tuple[int, int, int]]:
        """(lo, hi, rung) chunks covering ``n`` rows: full max-batch
        chunks plus one padded tail rung."""
        plan: list[tuple[int, int, int]] = []
        lo = 0
        while n - lo > self.max_batch:
            plan.append((lo, lo + self.max_batch, self.max_batch))
            lo += self.max_batch
        if n - lo > 0:
            plan.append((lo, n, self.rung_for(n - lo)))
        return plan


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    """Request layout of one feature shard.

    ``dense``: a request carries a [d] vector. ``sparse``: it carries an
    ELL row pair ([k] int32 ids, [k] values).
    """

    kind: str  # "dense" | "sparse"
    d: int
    k: int = 0

    def __post_init__(self):
        if self.kind not in ("dense", "sparse"):
            raise ValueError(f"unknown feature spec kind {self.kind!r}")

    def stack(self, rows: list, batch: int):
        """Pad ``rows`` (one request leaf each) up to [batch, ...] numpy
        arrays; padding rows are all zero."""
        if self.kind == "dense":
            out = np.zeros((batch, self.d), dtype=np.float32)
            for i, r in enumerate(rows):
                out[i] = r
            return out
        idx = np.zeros((batch, self.k), dtype=np.int32)
        val = np.zeros((batch, self.k), dtype=np.float32)
        for i, (ri, rv) in enumerate(rows):
            idx[i] = ri
            val[i] = rv
        return idx, val

    def slice_rows(self, leaf, lo: int, hi: int, batch: int):
        """Padded [batch, ...] chunk of rows ``lo:hi`` of a whole
        shard's tensors (dense: [n, d]; ELL: ([n, k] ids, [n, k]
        values)), on their device, features as f32. A full chunk is a
        view of the rows; a short one is padded with zero rows."""
        if self.kind == "dense":
            return pad_rows(leaf, lo, hi, batch, torch.float32)
        idx, val = leaf
        return (pad_rows(idx, lo, hi, batch, torch.int32),
                pad_rows(val, lo, hi, batch, torch.float32))


def pad_rows(t: torch.Tensor, lo: int, hi: int, batch: int, dtype,
             fill=0) -> torch.Tensor:
    """Rows ``lo:hi`` of ``t`` as a [batch, ...] ``dtype`` tensor on its
    device: a view when the rows fill the batch, else padded with
    ``fill`` (0 for features, -1, the cold code, for entity codes)."""
    part = t[lo:hi].to(dtype)
    if hi - lo == batch:
        return part.contiguous()
    out = torch.full((batch,) + tuple(t.shape[1:]), fill, dtype=dtype,
                     device=t.device)
    out[: hi - lo] = part
    return out


def default_specs(tables: CoefficientTables) -> dict[str, FeatureSpec]:
    """Dense request layout per shard, as wide as its widest consumer
    (a random table's width is the widest feature its projector names)."""
    dims: dict[str, int] = {}
    for t in tables.fixed.values():
        dims[t.feature_shard_id] = max(
            dims.get(t.feature_shard_id, 1), t.num_features
        )
    for t in tables.random.values():
        if t.num_entities:
            dims[t.feature_shard_id] = max(
                dims.get(t.feature_shard_id, 1), t.num_features
            )
    return {s: FeatureSpec("dense", d) for s, d in dims.items()}


def specs_from_dataset(data) -> dict[str, FeatureSpec]:
    """Request layout matching a GameDataset's shards (batch path)."""
    specs: dict[str, FeatureSpec] = {}
    for name, feats in data.feature_shards.items():
        if isinstance(feats, DenseFeatures):
            specs[name] = FeatureSpec("dense", int(feats.x.shape[1]))
        elif isinstance(feats, SparseFeatures):
            specs[name] = FeatureSpec(
                "sparse", int(feats.d), k=int(feats.indices.shape[1])
            )
        else:
            raise TypeError(
                f"shard {name!r}: {type(feats).__name__} has no fixed "
                "per-row serving layout (DualEll tails span rows); "
                "score it through GameTransformer"
            )
    return specs


@dataclasses.dataclass
class _RungGraph:
    """One rung's captured CUDA graph and the static buffers it reads
    and writes. ``host_in`` are numpy views of the pinned inputs in the
    flat order of ``ScorePrograms._flat_host``; ``keep`` holds the
    tensors behind the views, the device inputs and the graph's output.
    ``seq`` counts the replays; a dispatch handle carries the one whose
    scores it fetches."""

    graph: object  # torch.cuda.CUDAGraph
    host_in: tuple
    host_out: np.ndarray
    done: object  # torch.cuda.Event recorded after each replay
    launches: int  # serve-kernel launches one replay runs
    keep: tuple
    seq: int = 0


@dataclasses.dataclass(frozen=True)
class _Inflight:
    """One dispatched, not yet fetched rung: a graph replay (``graph``
    and its ``seq``), or an eager call's device scores and the pinned
    host buffers its copies read from (held until the fetch)."""

    batch: int
    n: int
    graph: _RungGraph | None = None
    seq: int = 0
    out: torch.Tensor | None = None
    staged: tuple = ()
    t0: float = 0.0  # perf_counter at the replay (or eager call)


class ScorePrograms:
    """The score ladder for one model structure.

    A structure change of the tables needs a new ``ScorePrograms``
    (``CoefficientTables.rebuild_from`` builds it). One thread dispatches
    at a time (the queue's worker): a rung's static buffers serve one
    dispatch until its fetch.
    """

    def __init__(
        self,
        tables: CoefficientTables,
        *,
        ladder: ShapeLadder | None = None,
        specs: dict[str, FeatureSpec] | None = None,
        compile_now: bool = True,
    ):
        self.tables = tables
        self.device = tables.device
        self.ladder = ladder or ShapeLadder()
        # An empty random-effect table (no entity trained yet)
        # contributes zero and is left out of the kernel's operands.
        self._fe_names = tuple(tables.fixed)
        self._re_names = tuple(
            n for n, t in tables.random.items() if t.num_entities
        )
        fe_shards = [tables.fixed[n].feature_shard_id for n in self._fe_names]
        re_shards = [
            tables.random[n].feature_shard_id for n in self._re_names
        ]
        self.shard_order = tuple(dict.fromkeys(fe_shards + re_shards))
        self.retype_order = tuple(dict.fromkeys(
            tables.random[n].random_effect_type for n in self._re_names
        ))
        # The request layout the caller chose (None: the tables'
        # default), carried over to a structure change's new ladder.
        self.given_specs = None if specs is None else dict(specs)
        self.specs = dict(
            specs if specs is not None else default_specs(tables)
        )
        missing = [s for s in self.shard_order if s not in self.specs]
        if missing:
            raise ValueError(f"no FeatureSpec for shard(s) {missing}")
        if not self._fe_names and not self._re_names:
            raise ValueError("model has no active coordinates to serve")
        # Request payloads are always f32: bf16 tables narrow the
        # coefficients, not the features.
        self.dtype = np.dtype(np.float32)
        shard_idx = {s: i for i, s in enumerate(self.shard_order)}
        self._kernel_args = dict(
            spec_kinds=tuple(self.specs[s].kind for s in self.shard_order),
            fe_feat=tuple(shard_idx[s] for s in fe_shards),
            re_feat=tuple(shard_idx[s] for s in re_shards),
        )
        # The route is chosen once, here: on the card the kernel unless
        # PHOTON_SERVE_KERNEL is off; on the CPU the plain version.
        self.use_kernel = (self.device.type == "cuda"
                           and serve_kernel.kernel_supported())
        self._score = (serve_kernel.fused_score if self.use_kernel
                       else serve_kernel.fused_score_reference)
        self._graphs: dict[int, _RungGraph] = {}
        self._pool = None
        self._capture_stream = None
        self.stats = {
            "serve_kernel": "cuda" if self.use_kernel else "plain",
            "library_load_seconds": 0.0,
            "programs_compiled": 0,
            "aot_compile_seconds": 0.0,
            # Device memory the captured graphs hold (static inputs and
            # the pool), and their pinned host buffers.
            "graph_device_bytes": 0,
            "graph_host_bytes": 0,
            "dispatches": {int(r): 0 for r in self.ladder.rungs},
        }
        log.info("ScorePrograms on %s: serve kernel route %s", self.device,
                 self.stats["serve_kernel"])
        if self.use_kernel:
            t0 = time.perf_counter()
            serve_kernel.load()
            self.stats["library_load_seconds"] = time.perf_counter() - t0
        if compile_now:
            self.compile_all()

    # -- operand layout ---------------------------------------------------

    def _flat_host(self, feats: dict, codes: dict) -> list[np.ndarray]:
        """One packed rung's host arrays in flat order: each shard's
        leaf (dense x, or ELL ids then values) in shard order, then one
        int32 code vector per random coordinate."""
        flat = []
        for s in self.shard_order:
            leaf = feats[s]
            if self.specs[s].kind == "dense":
                flat.append(leaf)
            else:
                flat.extend(leaf)
        flat.extend(np.asarray(codes[nm], dtype=np.int32)
                    for nm in self._re_names)
        return flat

    def _flat_layout(self, batch: int) -> list[tuple[tuple, torch.dtype]]:
        """(shape, dtype) of each flat input of rung ``batch``."""
        out = []
        for s in self.shard_order:
            spec = self.specs[s]
            if spec.kind == "dense":
                out.append(((batch, spec.d), torch.float32))
            else:
                out += [((batch, spec.k), torch.int32),
                        ((batch, spec.k), torch.float32)]
        out += [((batch,), torch.int32)] * len(self._re_names)
        return out

    def _unflat(self, flat: list) -> tuple[tuple, tuple]:
        """Flat inputs -> (features in shard order, codes in coordinate
        order), as ``_device_operands`` takes them."""
        it = iter(flat)
        feats = tuple(
            next(it) if self.specs[s].kind == "dense" else (next(it),
                                                            next(it))
            for s in self.shard_order
        )
        return feats, tuple(it)

    def operands(self, feats: dict, codes: dict,
                 staged: list | None = None) -> dict:
        """``fused_score``'s keyword operands for one packed rung: the
        live tables, the features and codes moved to the device, and
        the shard wiring. Pinned host buffers are appended to
        ``staged``; keep them until the scores are fetched."""
        staged = [] if staged is None else staged
        flat = [self._to_device(np.asarray(a), staged)
                for a in self._flat_host(feats, codes)]
        return self._device_operands(*self._unflat(flat))

    def _device_operands(self, feats: tuple, codes: tuple) -> dict:
        """``fused_score``'s keyword operands from features and codes
        already on the device (shard and coordinate order)."""
        t = self.tables
        rand = [t.random[n] for n in self._re_names]
        return dict(
            fe_ws=tuple(t.fixed[n].weights for n in self._fe_names),
            re_ws=tuple(x.weights for x in rand),
            re_projs=tuple(x.proj for x in rand),
            feats=feats,
            codes=codes,
            **self._kernel_args,
        )

    def _to_device(self, arr: np.ndarray, staged: list) -> torch.Tensor:
        """Host array -> device tensor. On the GPU the array is copied
        into a pinned buffer and sent asynchronously; the buffer is kept
        in ``staged`` until the fetch, so it is never reused while its
        copy may still be in flight."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return t
        pinned = t.pin_memory()
        staged.append(pinned)
        return pinned.to(self.device, non_blocking=True)

    # -- capture ----------------------------------------------------------

    def compile_rung(self, batch: int) -> _RungGraph | None:
        """Capture rung ``batch``'s CUDA graph, once (server start).

        The static inputs and the graph's output come first; one eager
        run on them (counted as the kernel's launches from Python) loads
        everything that would otherwise load lazily inside the capture;
        then the copies in, the score and the copy out are captured on
        a side stream in ``thread_local`` mode, into the ladder's shared
        pool. A failed capture raises: there is no eager fallback. On
        the CPU there is nothing to capture and this returns None.
        """
        if batch not in self.stats["dispatches"]:
            raise ValueError(
                f"batch {batch} is not a ladder rung {self.ladder.rungs}")
        if self.device.type != "cuda":
            self._register_rung(batch)
            return None
        g = self._graphs.get(batch)
        if g is not None:
            return g
        from photon_tpu_torch.utils import compile_cache

        t0 = time.perf_counter()
        mem0 = torch.cuda.memory_allocated(self.device)
        # The capture is the rung's compile: a retried ``compile.aot``
        # site, booked under its program's key.
        g = compile_cache.aot_capture(lambda: self._capture_rung(batch),
                                      ledger_key=_ledger_key(batch))
        self._graphs[batch] = g
        self.stats["programs_compiled"] += 1
        self.stats["aot_compile_seconds"] += time.perf_counter() - t0
        self._register_rung(batch)
        self.stats["graph_device_bytes"] += (
            torch.cuda.memory_allocated(self.device) - mem0)
        self.stats["graph_host_bytes"] += sum(
            h.numel() * h.element_size() for h in g.keep[0]) + 4 * batch
        return g

    def _capture_rung(self, batch: int) -> _RungGraph:
        """One attempt at rung ``batch``'s graph, from fresh buffers."""
        from photon_tpu_torch.utils import device_loop

        layout = self._flat_layout(batch)
        host = [torch.zeros(shape, dtype=dt, pin_memory=True)
                for shape, dt in layout]
        dev = [torch.zeros(shape, dtype=dt, device=self.device)
               for shape, dt in layout]
        host_out = torch.zeros(batch, dtype=torch.float32, pin_memory=True)
        for h, d, (shape, _) in zip(host, dev, layout):
            if len(shape) == 1:  # a code vector: padding rows are cold
                h.fill_(-1)
                d.fill_(-1)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            # A stream no other thread's work can share (device_loop).
            self._capture_stream = torch.cuda.Stream(
                self.device, priority=device_loop.CAPTURE_PRIORITY)
        side = self._capture_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        ops = self._device_operands(*self._unflat(dev))
        graph = torch.cuda.CUDAGraph()
        with device_loop.exclusive(), torch.cuda.stream(side):
            self._score(**ops)
            side.synchronize()
            before = serve_kernel.captured
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                for d, h in zip(dev, host):
                    d.copy_(h, non_blocking=True)
                out = self._score(**ops)
                host_out.copy_(out, non_blocking=True)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is already broken; raise its cause
                raise
            graph.capture_end()
        return _RungGraph(
            graph=graph,
            host_in=tuple(h.numpy() for h in host),
            host_out=host_out.numpy(),
            done=torch.cuda.Event(),
            launches=serve_kernel.captured - before,
            keep=(host, dev, host_out, out),
        )

    def compile_all(self) -> None:
        """Capture every rung's graph (server start); the request loop
        never captures again."""
        from photon_tpu_torch import obs

        with obs.span("serve/compile_ladder"):
            for r in self.ladder.rungs:
                self.compile_rung(r)

    def _register_rung(self, batch: int) -> None:
        """Put rung ``batch`` in the cost ledger's census (one flag
        check when the ledger is off), its cost counted at report
        time."""
        from photon_tpu_torch.obs import ledger

        ledger.register_program(
            _ledger_key(batch), phase="serve",
            cost_thunk=lambda b=batch: self.rung_cost(b))

    def rung_cost(self, batch: int) -> dict:
        """The serve kernel's count for one launch of rung ``batch``
        (``costmodel.serve_score_cost``) at the ladder's layout: every
        row of the rung known, reading distinct table rows up to the
        table's size, the most one launch of the rung can need. Counted
        from shapes (meta tensors); reads no device data."""
        from photon_tpu_torch.analysis import costmodel

        flat = [torch.empty(shape, dtype=dt, device="meta")
                for shape, dt in self._flat_layout(batch)]
        ops = self._device_operands(*self._unflat(flat))
        read = [min(batch, self.tables.random[n].num_entities)
                for n in self._re_names]
        return costmodel.serve_score_cost(
            ops, self.tables.precision, rows_read=read,
            rows_known=[batch] * len(read))

    def release(self) -> int:
        """Drop every captured graph and its buffers (a retired ladder,
        after a structure swap); returns the device bytes freed."""
        if not self._graphs:
            return 0
        mem0 = torch.cuda.memory_allocated(self.device)
        for g in self._graphs.values():
            g.done.synchronize()
            g.graph.reset()
            # A handle still held elsewhere must not keep the buffers.
            g.keep = g.host_in = ()
        self._graphs.clear()
        return mem0 - torch.cuda.memory_allocated(self.device)

    # -- dispatch ---------------------------------------------------------

    def _rung_of(self, feats: dict, codes: dict) -> int:
        if not feats and not codes:
            raise ValueError("score dispatch needs at least one operand")
        some = next(iter(feats.values())) if feats else None
        batch = (
            some.shape[0] if isinstance(some, np.ndarray)
            else some[0].shape[0] if some is not None
            else next(iter(codes.values())).shape[0]
        )
        if batch not in self.stats["dispatches"]:
            raise ValueError(
                f"batch {batch} is not a ladder rung {self.ladder.rungs}; "
                "pad with pack_requests first"
            )
        return batch

    def dispatch_padded(self, feats: dict, codes: dict, n: int) -> _Inflight:
        """Enqueue the score of ``n`` stacked requests without waiting;
        ``fetch_padded`` returns the scores. The split lets the queue
        pack batch k+1 while batch k is on the device.

        On the card: wait for the rung's last replay (its copies have
        then read the static inputs and written its scores), fill the
        static inputs, replay the rung's graph and record its event. On
        the CPU: ``dispatch_eager``."""
        batch = self._rung_of(feats, codes)
        if self.device.type != "cuda":
            return self.dispatch_eager(feats, codes, n)
        g = self._graphs.get(batch)
        if g is None:
            raise ValueError(
                f"rung {batch} has no captured graph: compile_rung({batch}) "
                "or compile_all() first")
        g.done.synchronize()
        for dst, src in zip(g.host_in, self._flat_host(feats, codes)):
            if dst.shape != np.shape(src):
                raise ValueError(f"operand of shape {np.shape(src)} for a "
                                 f"static input of shape {dst.shape}")
            dst[...] = src
        t0 = time.perf_counter()
        g.graph.replay()
        g.done.record()
        g.seq += 1
        self.stats["dispatches"][batch] += 1
        serve_kernel.replay_launches += g.launches
        return _Inflight(batch=batch, n=n, graph=g, seq=g.seq, t0=t0)

    def dispatch_eager(self, feats: dict, codes: dict, n: int) -> _Inflight:
        """The eager dispatch: copies and the score issued from Python
        (the CPU's dispatch; on the card, the yardstick for a replay)."""
        batch = self._rung_of(feats, codes)
        staged: list = []
        t0 = time.perf_counter()
        out = self._score(**self.operands(feats, codes, staged))
        self.stats["dispatches"][batch] += 1
        return _Inflight(batch=batch, n=n, out=out, staged=tuple(staged),
                         t0=t0)

    def fetch_padded(self, handle: _Inflight, *,
                     exclude_seconds: float = 0.0) -> np.ndarray:
        """Wait for a dispatched rung; its first ``n`` scores as numpy
        (the one host sync of the request path).

        With the cost ledger on, the dispatch's window (replay to
        fetched) is booked to ``serve/score@<rung>``, less
        ``exclude_seconds``: host time the caller spent between dispatch
        and fetch on work overlapped with the card (the queue's staging
        pack), so the row stays the device's time."""
        g = handle.graph
        if g is None:
            scores = handle.out[: handle.n].cpu().numpy()
        else:
            if handle.seq != g.seq:
                raise RuntimeError(
                    f"rung {handle.batch} was dispatched again before this "
                    "dispatch was fetched; its scores are gone")
            g.done.synchronize()
            scores = g.host_out[: handle.n].copy()
        from photon_tpu_torch.obs import ledger

        if ledger.enabled():
            t1 = time.perf_counter()
            ledger.record_dispatch(
                _ledger_key(handle.batch),
                max((t1 - handle.t0) - max(exclude_seconds, 0.0), 0.0),
                phase="serve", start=handle.t0, end=t1)
        return scores

    def score_padded(self, feats: dict, codes: dict, n: int) -> np.ndarray:
        """Dispatch and fetch in one call."""
        return self.fetch_padded(self.dispatch_padded(feats, codes, n))

    def pack_requests(
        self, requests: list[tuple[dict, dict]]
    ) -> tuple[dict, dict, int]:
        """Stack [(features, entity_ids)] into padded rung operands.

        Returns (feats, codes, rung). Cold entities and padding rows get
        code -1, which scores the fixed effects only.
        """
        n = len(requests)
        rung = self.ladder.rung_for(n)
        feats = {
            s: self.specs[s].stack([r[0][s] for r in requests], rung)
            for s in self.shard_order
        }
        codes = {}
        for nm in self._re_names:
            table = self.tables.random[nm]
            rt = table.random_effect_type
            vec = np.full(rung, -1, dtype=np.int32)
            for i, (_, ids) in enumerate(requests):
                vec[i] = table.code_for(ids.get(rt, ""))
            codes[nm] = vec
        return feats, codes, rung

    def score_dataset(self, data) -> np.ndarray:
        """Score a whole GameDataset through the ladder: [n] f32 scores
        as numpy. Each chunk of ``ladder.chunk_plan`` is one call of the
        route chosen at construction (one kernel launch on the card),
        on rows sliced from the dataset's device tensors and entity
        codes uploaded once per coordinate; the scores come back to the
        host once, at the end."""
        from photon_tpu_torch.data.random_effect import scoring_codes

        if data.device != self.device:
            raise ValueError(f"dataset is on {data.device}, the tables on "
                             f"{self.device}")
        n = data.num_samples
        leaves = {}
        for s in self.shard_order:
            feats = data.feature_shards[s]
            leaves[s] = (feats.x if isinstance(feats, DenseFeatures)
                         else (feats.indices, feats.values))
        full_codes = []
        for nm in self._re_names:
            table = self.tables.random[nm]
            codes = scoring_codes(data, table.random_effect_type,
                                  table.entity_keys).astype(np.int32)
            full_codes.append(torch.from_numpy(codes).to(self.device))
        out = torch.empty(n, dtype=torch.float32, device=self.device)
        for lo, hi, rung in self.ladder.chunk_plan(n):
            feats = tuple(
                self.specs[s].slice_rows(leaves[s], lo, hi, rung)
                for s in self.shard_order
            )
            codes = tuple(pad_rows(fc, lo, hi, rung, torch.int32, fill=-1)
                          for fc in full_codes)
            z = self._score(**self._device_operands(feats, codes))
            self.stats["dispatches"][rung] += 1
            out[lo:hi] = z[: hi - lo]
        return out.cpu().numpy()
