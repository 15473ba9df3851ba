"""The serving shape ladder (port of ``photon_tpu/serve/programs.py``).

Requests arrive one at a time; the score kernel takes a padded batch.
The bridge is a ladder of batch rungs (default 1/8/64/512): each batch
of requests is padded up to the nearest rung, padded rows carrying zero
features and code -1 so they score 0 and are sliced away.

On the GPU every rung is scored by one launch of the fused serve kernel
(``ops/serve_kernel.py``); there is no other path on the card. The kernel
library is built and loaded when ``ScorePrograms`` is constructed, so
the request loop never builds anything. On the CPU the same call runs
the kernel's plain PyTorch version.

The tables are read at every dispatch, so a values-only
``CoefficientTables.reload`` (an in-place copy) is served by the next
dispatch with nothing rebuilt.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from photon_tpu_torch.ops import serve_kernel
from photon_tpu_torch.serve.tables import CoefficientTables


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


@dataclasses.dataclass(frozen=True)
class _Inflight:
    """One dispatched, not yet fetched rung: the device scores, the
    staged host buffers the copies read from (held until the fetch), and
    the caller's live row count."""

    out: torch.Tensor
    staged: tuple
    batch: int
    n: int


class ScorePrograms:
    """The score ladder for one model structure.

    A structure change of the tables (``reload`` returned False) needs
    a new ``ScorePrograms``.
    """

    def __init__(
        self,
        tables: CoefficientTables,
        *,
        ladder: ShapeLadder | None = None,
        specs: dict[str, FeatureSpec] | None = None,
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
        self.specs = dict(
            specs if specs is not None else default_specs(tables)
        )
        missing = [s for s in self.shard_order if s not in self.specs]
        if missing:
            raise ValueError(f"no FeatureSpec for shard(s) {missing}")
        if not self._fe_names and not self._re_names:
            raise ValueError("model has no active coordinates to serve")
        n_coords = len(self._fe_names) + len(self._re_names)
        if n_coords > serve_kernel.MAX_COORDS:
            raise ValueError(
                f"{n_coords} active coordinates; the serve kernel takes "
                f"at most {serve_kernel.MAX_COORDS}")
        # Request payloads are always f32: bf16 tables narrow the
        # coefficients, not the features.
        self.dtype = np.dtype(np.float32)
        shard_idx = {s: i for i, s in enumerate(self.shard_order)}
        self._kernel_args = dict(
            spec_kinds=tuple(self.specs[s].kind for s in self.shard_order),
            fe_feat=tuple(shard_idx[s] for s in fe_shards),
            re_feat=tuple(shard_idx[s] for s in re_shards),
        )
        self.stats = {
            "library_load_seconds": 0.0,
            "dispatches": {int(r): 0 for r in self.ladder.rungs},
        }
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            serve_kernel.load()
            self.stats["library_load_seconds"] = time.perf_counter() - t0

    def operands(self, feats: dict, codes: dict,
                 staged: list | None = None) -> dict:
        """``fused_score``'s keyword operands for one packed rung: the
        live tables, the features and codes moved to the device, and
        the shard wiring. Pinned host buffers are appended to
        ``staged``; keep them until the scores are fetched."""
        staged = [] if staged is None else staged
        t = self.tables
        rand = [t.random[n] for n in self._re_names]
        f = []
        for s in self.shard_order:
            leaf = feats[s]
            if self.specs[s].kind == "dense":
                f.append(self._to_device(leaf, staged))
            else:
                f.append(tuple(self._to_device(a, staged) for a in leaf))
        return dict(
            fe_ws=tuple(t.fixed[n].weights for n in self._fe_names),
            re_ws=tuple(x.weights for x in rand),
            re_projs=tuple(x.proj for x in rand),
            feats=tuple(f),
            codes=tuple(
                self._to_device(
                    np.asarray(codes[nm], dtype=np.int32), staged)
                for nm in self._re_names
            ),
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

    def dispatch_padded(self, feats: dict, codes: dict, n: int) -> _Inflight:
        """Enqueue the score of ``n`` stacked requests without waiting;
        ``fetch_padded`` returns the scores. The split lets the queue
        pack batch k+1 while batch k is on the device."""
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
        staged: list = []
        out = serve_kernel.fused_score(**self.operands(feats, codes, staged))
        self.stats["dispatches"][batch] += 1
        return _Inflight(out=out, staged=tuple(staged), batch=batch, n=n)

    def fetch_padded(self, handle: _Inflight) -> np.ndarray:
        """Wait for a dispatched rung; its first ``n`` scores as numpy
        (the one host sync of the request path)."""
        return handle.out[: handle.n].cpu().numpy()

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
