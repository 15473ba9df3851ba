"""Model and data health: drift, skew, calibration, numerics (port of
``photon_tpu/obs/health.py``).

The statistical health of a model and its data, from bounded-memory
host machinery in float64 numpy:

- **Streaming data-distribution sketches** (:class:`DistSketch`,
  :class:`FeatureMoments`, :class:`DataSketch`): per-column
  moment/quantile/missing-rate sketches plus per-feature moments and
  per-shard value/nnz histograms. Mergeable (counts add, window by
  window, day by day), serialized as canonical JSON (``to_bytes``; a
  sketch round-tripped through disk re-serializes to the identical
  bytes, and the JAX package's sketch of the same inputs serializes to
  the same bytes), and recorded per ingest window by
  ``data/stream.py`` (persisted beside the cursor, so a kill-and-resume
  ingest reproduces the identical sketch).
- **Skew and drift scoring** (:func:`psi`, :func:`ks`, :func:`compare`):
  population-stability index and a KS-style distance between any two
  sketches: train window against train window (drift) and train against
  serve (skew, fed from the serve queue's batches at a bounded sample
  rate through :func:`observe_serve_batch`).
- **Model-health trackers**: expected calibration error on (score,
  label) pairs (:class:`CalibrationSketch`, fed by
  ``GameEstimator.evaluate_model``'s ``score_sink``), score
  distributions on the serve path, and per-coordinate
  coefficient-movement norms across warm-start generations
  (:func:`coefficient_movement`).
- **Numerics sentinels** (:func:`sentinel_watch`,
  :func:`numerics_report`): non-finite detection per (fit, coordinate,
  metric, iteration) over a fit's convergence block. The block is
  parked as the tensor the fit already produced; it is copied to the
  host (``.cpu()``) only at report time, so arming the sentinel adds no
  wait for the card to a fit. The fused fit parks its block on every
  fit while health is armed; the unfused loop (validation, checkpoints,
  listeners) parks nothing, so after such a fit ``numerics_report``
  reads ``fits_scanned: 0``.
  :func:`scan_model` is the companion check on a model's coefficient
  tables.

Everything is off by default (``enable()`` arms it) and host-only: no
hook launches a kernel, captures a graph or copies to or from the card
on a hot path, so the serve ladder's graphs and a fit's numbers are the
same either way.

Threading: one module lock, ``_LOCK``, guards the process-global state
(``_STATE`` and ``_ENABLED``): the serve tap (written by the queue's
worker through ``observe_serve_batch``, read by snapshot and metrics
readers), the parked sentinels and the counters. All numpy preparation
happens outside the lock (the worker converts and bins before taking
it; a sentinel's host copy is made outside and installed under it), so
the serve worker never waits for a scrape beyond a dict copy. The lock
is a leaf: nothing done while holding it takes another lock.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
from collections import deque

import numpy as np

SCHEMA_VERSION = 1

# Per-feature moment tracking is bounded: indices past this cap pool
# into one overflow slot, so a 100M-feature vocabulary costs the same
# three arrays as a 4096-feature one (the per-shard value HISTOGRAM
# still sees every value — only the per-feature split is capped).
HEALTH_MAX_FEATURES = 4096

# Bounded sentinel inventory — same policy as obs/convergence.py's
# parked-trace deque: a bench steady-state loop runs dozens of fits.
_MAX_SENTINELS = 8


def signed_log_bounds(
    lo: float = 1e-3, hi: float = 1e4, per_decade: int = 2
) -> tuple[float, ...]:
    """Symmetric signed-log bucket upper bounds for arbitrary real
    feature/score streams: ``-hi .. -lo, 0, lo .. hi`` with
    ``per_decade`` buckets per decade (values above ``hi`` land in the
    implicit +Inf catch-all; below ``-hi`` in bucket 0). Fixed,
    data-independent edges are what make two sketches comparable — PSI
    and KS are defined bucket-by-bucket."""
    if not (0 < lo < hi) or per_decade < 1:
        raise ValueError(
            f"bad bounds spec lo={lo} hi={hi} per_decade={per_decade}")
    decades = int(round(math.log10(hi / lo) * per_decade))
    pos = [lo * 10 ** (i / per_decade) for i in range(decades + 1)]
    return tuple([-v for v in reversed(pos)] + [0.0] + pos)


DEFAULT_BOUNDS = signed_log_bounds()
# Unit-interval bounds for probability-like streams (calibration bins
# use their own uniform grid; this is for score DISTRIBUTIONS).
UNIT_BOUNDS = tuple(i / 20 for i in range(21))


class DistSketch:
    """Bounded-memory sketch of one scalar stream.

    Fixed-edge histogram (``bounds`` are upper edges + an implicit +Inf
    catch-all) plus exact moments (count/sum/sumsq/min/max) and a
    missing counter (non-finite observations). Mergeable when the
    bounds match; quantiles report the upper edge of the bucket holding
    the exact quantile (the RollingHistogram error contract).
    """

    __slots__ = (
        "bounds", "counts", "count", "missing", "sum", "sumsq",
        "min", "max",
    )

    def __init__(self, bounds: tuple[float, ...] | None = None):
        self.bounds = tuple(bounds) if bounds else DEFAULT_BOUNDS
        self.counts = np.zeros(len(self.bounds) + 1, dtype=np.int64)
        self.count = 0
        self.missing = 0
        self.sum = 0.0
        self.sumsq = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, values: np.ndarray) -> None:
        """Fold a float64 ndarray in (the CALLER converts — keeping
        ``np.asarray`` outside any lock this sketch is updated under)."""
        v = values.reshape(-1)
        if v.size == 0:
            return
        finite = np.isfinite(v)
        self.missing += int(v.size - finite.sum())
        v = v[finite]
        if v.size == 0:
            return
        idx = np.searchsorted(np.asarray(self.bounds), v, side="left")
        self.counts += np.bincount(idx, minlength=len(self.counts))
        self.count += int(v.size)
        self.sum += float(v.sum())
        self.sumsq += float((v * v).sum())
        self.min = min(self.min, float(v.min()))
        self.max = max(self.max, float(v.max()))

    # -- algebra -----------------------------------------------------------

    def merge(self, other: "DistSketch") -> "DistSketch":
        if self.bounds != other.bounds:
            raise ValueError(
                "cannot merge sketches with different bucket bounds "
                f"({len(self.bounds)} vs {len(other.bounds)} edges)")
        self.counts = self.counts + other.counts
        self.count += other.count
        self.missing += other.missing
        self.sum += other.sum
        self.sumsq += other.sumsq
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def clone(self) -> "DistSketch":
        """Cheap structural copy: array memcpys + scalars, no
        per-element boxing — safe to take under a lock."""
        out = DistSketch(self.bounds)
        out.counts = self.counts.copy()
        out.count = self.count
        out.missing = self.missing
        out.sum = self.sum
        out.sumsq = self.sumsq
        out.min = self.min
        out.max = self.max
        return out

    def diff_from(self, baseline: "DistSketch") -> "DistSketch":
        """The WINDOW ``self - baseline`` (a cumulative sketch minus an
        earlier snapshot of itself): counts and moments subtract
        exactly, so PSI/KS/mean-shift over the window are exact;
        extrema keep the cumulative values (conservative — min/max are
        not invertible)."""
        if self.bounds != baseline.bounds:
            raise ValueError(
                "cannot diff sketches with different bucket bounds")
        out = DistSketch(self.bounds)
        out.counts = np.maximum(self.counts - baseline.counts, 0)
        out.count = max(self.count - baseline.count, 0)
        out.missing = max(self.missing - baseline.missing, 0)
        out.sum = self.sum - baseline.sum
        out.sumsq = self.sumsq - baseline.sumsq
        out.min = self.min
        out.max = self.max
        return out

    # -- summaries ---------------------------------------------------------

    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def std(self) -> float | None:
        if not self.count:
            return None
        var = max(self.sumsq / self.count - (self.sum / self.count) ** 2,
                  0.0)
        return math.sqrt(var)

    def missing_rate(self) -> float | None:
        total = self.count + self.missing
        return self.missing / total if total else None

    def quantile(self, q: float) -> float | None:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if not self.count:
            return None
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += int(c)
            if seen >= rank:
                if i < len(self.bounds):
                    return self.bounds[i]
                return self.max  # +Inf catch-all: report the seen max
        return self.max  # pragma: no cover — rank <= count

    def summary(self) -> dict:
        return {
            "count": self.count,
            "missing": self.missing,
            "missing_rate": self.missing_rate(),
            "mean": self.mean(),
            "std": self.std(),
            "min": None if self.count == 0 else self.min,
            "max": None if self.count == 0 else self.max,
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
        }

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "bounds": list(self.bounds),
            "counts": [int(c) for c in self.counts],
            "count": int(self.count),
            "missing": int(self.missing),
            "sum": float(self.sum),
            "sumsq": float(self.sumsq),
            "min": None if self.count == 0 else float(self.min),
            "max": None if self.count == 0 else float(self.max),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DistSketch":
        out = cls(tuple(d["bounds"]))
        out.counts = np.asarray(d["counts"], dtype=np.int64)
        out.count = int(d["count"])
        out.missing = int(d["missing"])
        out.sum = float(d["sum"])
        out.sumsq = float(d["sumsq"])
        out.min = math.inf if d["min"] is None else float(d["min"])
        out.max = -math.inf if d["max"] is None else float(d["max"])
        return out


class FeatureMoments:
    """Per-feature-index count/sum/sumsq for one feature shard.

    Bounded: indices ``>= cap`` pool into one overflow slot (index
    ``cap``), so memory is ``O(min(num_features, cap))`` whatever the
    vocabulary. Values of exactly 0 are treated as absent — the ingest
    layer drops explicit zeros (data/stream.py decode), so in ELL
    buffers a zero value is indistinguishable from padding by design.
    """

    __slots__ = ("num_features", "cap", "counts", "sums", "sumsqs")

    def __init__(self, num_features: int, cap: int = HEALTH_MAX_FEATURES):
        self.num_features = int(num_features)
        self.cap = min(self.num_features, int(cap))
        n = self.cap + 1  # + the overflow pool
        self.counts = np.zeros(n, dtype=np.int64)
        self.sums = np.zeros(n, dtype=np.float64)
        self.sumsqs = np.zeros(n, dtype=np.float64)

    def update(self, idx: np.ndarray, val: np.ndarray) -> None:
        """Fold an (indices, values) pair in — ELL blocks ([n, k]) or
        flat arrays; zero values (padding/absent) are skipped."""
        i = idx.reshape(-1)
        v = val.reshape(-1).astype(np.float64)
        live = v != 0.0
        i = np.minimum(i[live], self.cap)
        v = v[live]
        n = len(self.counts)
        self.counts += np.bincount(i, minlength=n).astype(np.int64)
        self.sums += np.bincount(i, weights=v, minlength=n)
        self.sumsqs += np.bincount(i, weights=v * v, minlength=n)

    def merge(self, other: "FeatureMoments") -> "FeatureMoments":
        if (self.num_features, self.cap) != (other.num_features, other.cap):
            raise ValueError(
                "cannot merge feature moments with different shapes "
                f"({self.num_features}/{self.cap} vs "
                f"{other.num_features}/{other.cap})")
        self.counts = self.counts + other.counts
        self.sums = self.sums + other.sums
        self.sumsqs = self.sumsqs + other.sumsqs
        return self

    def clone(self) -> "FeatureMoments":
        out = FeatureMoments(self.num_features, cap=self.cap)
        out.counts = self.counts.copy()
        out.sums = self.sums.copy()
        out.sumsqs = self.sumsqs.copy()
        return out

    def diff_from(self, baseline: "FeatureMoments") -> "FeatureMoments":
        if (self.num_features, self.cap) != (
            baseline.num_features, baseline.cap
        ):
            raise ValueError(
                "cannot diff feature moments with different shapes")
        out = FeatureMoments(self.num_features, cap=self.cap)
        out.counts = np.maximum(self.counts - baseline.counts, 0)
        out.sums = self.sums - baseline.sums
        out.sumsqs = self.sumsqs - baseline.sumsqs
        return out

    def means(self) -> np.ndarray:
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(
                self.counts > 0, self.sums / self.counts, np.nan)

    def stds(self) -> np.ndarray:
        with np.errstate(invalid="ignore", divide="ignore"):
            var = np.where(
                self.counts > 0,
                self.sumsqs / self.counts
                - (self.sums / np.maximum(self.counts, 1)) ** 2,
                np.nan,
            )
        return np.sqrt(np.maximum(var, 0.0))

    def to_dict(self) -> dict:
        return {
            "num_features": self.num_features,
            "cap": self.cap,
            "counts": [int(c) for c in self.counts],
            "sums": [float(s) for s in self.sums],
            "sumsqs": [float(s) for s in self.sumsqs],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FeatureMoments":
        out = cls(int(d["num_features"]), cap=int(d["cap"]))
        out.counts = np.asarray(d["counts"], dtype=np.int64)
        out.sums = np.asarray(d["sums"], dtype=np.float64)
        out.sumsqs = np.asarray(d["sumsqs"], dtype=np.float64)
        return out


class DataSketch:
    """One dataset snapshot's full health sketch.

    ``columns`` holds per-column :class:`DistSketch`es (label / offset /
    weight on the train side; score on the serve side); ``shards`` holds
    per-feature-shard blocks — the pooled value distribution, the
    per-row nonzero-count distribution, and the per-feature moments.
    """

    __slots__ = ("rows", "columns", "shards")

    def __init__(self):
        self.rows = 0
        self.columns: dict[str, DistSketch] = {}
        self.shards: dict[str, dict] = {}

    # -- building ----------------------------------------------------------

    def column(self, name: str,
               bounds: tuple[float, ...] | None = None) -> DistSketch:
        sk = self.columns.get(name)
        if sk is None:
            sk = self.columns[name] = DistSketch(bounds)
        return sk

    def shard(self, name: str, num_features: int) -> dict:
        blk = self.shards.get(name)
        if blk is None:
            blk = self.shards[name] = {
                "values": DistSketch(),
                "nnz": DistSketch(),
                "moments": FeatureMoments(num_features),
            }
        return blk

    def update_window(
        self,
        labels: np.ndarray,
        offsets: np.ndarray,
        weights: np.ndarray,
        shards: dict[str, tuple[np.ndarray, np.ndarray]],
        widths: dict[str, int],
    ) -> None:
        """Fold one decoded ingest window in (data/stream.py `_Window`
        arrays: columns + per-shard ELL (idx, val) blocks; ``widths``
        maps shard -> vocabulary size). Pure numpy — the streaming
        ingest calls this on its consuming thread, in window order."""
        self.rows += int(labels.shape[0])
        self.column("label").observe(labels.astype(np.float64))
        self.column("offset").observe(offsets.astype(np.float64))
        self.column("weight").observe(weights.astype(np.float64))
        for name, (idx, val) in shards.items():
            blk = self.shard(name, widths[name])
            v = val.astype(np.float64)
            blk["values"].observe(v[v != 0.0])
            blk["nnz"].observe((v != 0.0).sum(axis=1).astype(np.float64))
            blk["moments"].update(idx, v)

    def update_requests_sparse(
        self, name: str, idx: np.ndarray, val: np.ndarray,
        num_features: int, rows: int,
    ) -> None:
        blk = self.shard(name, num_features)
        v = val.astype(np.float64)
        blk["values"].observe(v[v != 0.0])
        blk["nnz"].observe(
            (v != 0.0).reshape(rows, -1).sum(axis=1).astype(np.float64))
        blk["moments"].update(idx, v)

    def update_requests_dense(self, name: str, x: np.ndarray) -> None:
        """Fold dense [n, d] request vectors in with the SAME
        zero-is-absent convention as the sparse/ELL train side: the
        ingest layer drops explicit zeros at decode, so a dense zero
        on the serve side means "feature absent", not "observed 0" —
        folding zeros as observations would pile (d - nnz)/d of the
        serve histogram's mass into a bucket the training sketch never
        has and make the skew gate refuse identical traffic."""
        blk = self.shard(name, x.shape[1])
        v = x.astype(np.float64)
        blk["values"].observe(v[v != 0.0])
        blk["nnz"].observe(
            (v != 0.0).sum(axis=1).astype(np.float64))
        idx = np.broadcast_to(
            np.arange(x.shape[1]), v.shape)
        blk["moments"].update(idx, v)  # update() skips zeros

    def merge(self, other: "DataSketch") -> "DataSketch":
        self.rows += other.rows
        for name, sk in other.columns.items():
            if name in self.columns:
                self.columns[name].merge(sk)
            else:
                self.columns[name] = sk.clone()
        for name, blk in other.shards.items():
            if name in self.shards:
                mine = self.shards[name]
                mine["values"].merge(blk["values"])
                mine["nnz"].merge(blk["nnz"])
                mine["moments"].merge(blk["moments"])
            else:
                self.shards[name] = {
                    k: blk[k].clone()
                    for k in ("values", "nnz", "moments")
                }
        return self

    def clone(self) -> "DataSketch":
        """Cheap structural copy (array memcpys only — safe under a
        lock; the serve tap's snapshot path)."""
        out = DataSketch()
        out.rows = self.rows
        out.columns = {n: sk.clone() for n, sk in self.columns.items()}
        out.shards = {
            n: {
                "values": blk["values"].clone(),
                "nnz": blk["nnz"].clone(),
                "moments": blk["moments"].clone(),
            }
            for n, blk in self.shards.items()
        }
        return out

    def diff_from(self, baseline: "DataSketch") -> "DataSketch":
        """The window ``self - baseline``: surfaces the baseline lacks
        copy through whole; shared surfaces subtract (see
        ``DistSketch.diff_from``). This is how a long-lived serve tap
        yields a PER-CYCLE traffic window for the skew gate — without
        it, day 31's shifted traffic is 1/31 of the cumulative mass
        and the gate's sensitivity decays toward zero."""
        out = DataSketch()
        out.rows = max(self.rows - baseline.rows, 0)
        for n, sk in self.columns.items():
            base = baseline.columns.get(n)
            out.columns[n] = (
                sk.clone() if base is None else sk.diff_from(base)
            )
        for n, blk in self.shards.items():
            base = baseline.shards.get(n)
            if base is None:
                out.shards[n] = {
                    k: blk[k].clone()
                    for k in ("values", "nnz", "moments")
                }
            else:
                out.shards[n] = {
                    k: blk[k].diff_from(base[k])
                    for k in ("values", "nnz", "moments")
                }
        return out

    # -- serialization (canonical, byte-stable) ---------------------------

    def to_dict(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "rows": int(self.rows),
            "columns": {
                n: sk.to_dict() for n, sk in sorted(self.columns.items())
            },
            "shards": {
                n: {
                    "values": blk["values"].to_dict(),
                    "nnz": blk["nnz"].to_dict(),
                    "moments": blk["moments"].to_dict(),
                }
                for n, blk in sorted(self.shards.items())
            },
        }

    def to_bytes(self) -> bytes:
        """Canonical serialization: sorted keys, no whitespace — the
        byte-stability contract (save -> load -> to_bytes reproduces
        the identical bytes; pinned by tests/test_health.py)."""
        return json.dumps(
            self.to_dict(), sort_keys=True, separators=(",", ":")
        ).encode("utf-8")

    @classmethod
    def from_dict(cls, d: dict) -> "DataSketch":
        version = d.get("schema_version")
        if version != SCHEMA_VERSION:
            raise ValueError(
                f"health sketch schema_version {version!r} is not the "
                f"supported {SCHEMA_VERSION}")
        out = cls()
        out.rows = int(d["rows"])
        for n, sk in d.get("columns", {}).items():
            out.columns[n] = DistSketch.from_dict(sk)
        for n, blk in d.get("shards", {}).items():
            out.shards[n] = {
                "values": DistSketch.from_dict(blk["values"]),
                "nnz": DistSketch.from_dict(blk["nnz"]),
                "moments": FeatureMoments.from_dict(blk["moments"]),
            }
        return out

    def save(self, path: str) -> None:
        from photon_tpu_torch.io.model_io import atomic_write_bytes

        atomic_write_bytes(path, self.to_bytes())

    @classmethod
    def load(cls, path: str) -> "DataSketch":
        with open(path, "rb") as f:
            return cls.from_dict(json.loads(f.read().decode("utf-8")))

    def summary(self) -> dict:
        return {
            "rows": self.rows,
            "columns": {
                n: sk.summary() for n, sk in sorted(self.columns.items())
            },
            "shards": {
                n: {
                    "values": blk["values"].summary(),
                    "nnz": blk["nnz"].summary(),
                }
                for n, blk in sorted(self.shards.items())
            },
        }


# --------------------------------------------------------------------------
# drift / skew scoring
# --------------------------------------------------------------------------


def psi(p_counts, q_counts, eps: float = 1e-6) -> float:
    """Population stability index between two aligned histograms.

    Add-half (Jeffreys) smoothing per bucket before the log: with a
    bare epsilon floor, a bucket holding ONE sample on one side and
    zero on the other contributes ``(1/n) * ln(1/(n*eps))`` — at small
    sample counts that empty-bucket noise alone crosses typical gate
    ceilings (a 120-row window "drifted" 0.5+ against its own
    distribution). The pseudo-count shrinks sampling noise to O(1/n)
    while a real mass relocation still scores in the units the 0.1/0.25
    PSI folklore thresholds assume. Finite, SYMMETRIC in its
    arguments, and exactly 0.0 on identical inputs."""
    p = np.asarray(p_counts, dtype=np.float64)
    q = np.asarray(q_counts, dtype=np.float64)
    if p.shape != q.shape:
        raise ValueError(
            f"PSI needs aligned histograms ({p.shape} vs {q.shape})")
    if p.sum() == 0 or q.sum() == 0:
        return 0.0
    if np.array_equal(p, q):
        return 0.0
    n = p.size
    p = np.maximum((p + 0.5) / (p.sum() + 0.5 * n), eps)
    q = np.maximum((q + 0.5) / (q.sum() + 0.5 * n), eps)
    return float(np.sum((p - q) * np.log(p / q)))


def ks(p_counts, q_counts) -> float:
    """KS-style distance: the max absolute CDF gap over the shared
    bucket grid (0 on identical, 1 on disjoint)."""
    p = np.asarray(p_counts, dtype=np.float64)
    q = np.asarray(q_counts, dtype=np.float64)
    if p.shape != q.shape:
        raise ValueError(
            f"KS needs aligned histograms ({p.shape} vs {q.shape})")
    if p.sum() == 0 or q.sum() == 0:
        return 0.0
    return float(np.max(np.abs(
        np.cumsum(p) / p.sum() - np.cumsum(q) / q.sum()
    )))


def sketch_distance(a: DistSketch, b: DistSketch) -> dict:
    """PSI + KS + moment shift between two scalar sketches."""
    ma, mb = a.mean(), b.mean()
    sa, sb = a.std(), b.std()
    pooled = None
    if sa is not None and sb is not None:
        pooled = math.sqrt((sa * sa + sb * sb) / 2.0)
    shift = None
    if ma is not None and mb is not None:
        shift = (
            abs(ma - mb) / pooled if pooled else abs(ma - mb)
        )
    miss = None
    ra, rb = a.missing_rate(), b.missing_rate()
    if ra is not None and rb is not None:
        miss = rb - ra
    return {
        "psi": round(psi(a.counts, b.counts), 6),
        "ks": round(ks(a.counts, b.counts), 6),
        "mean_a": ma,
        "mean_b": mb,
        "mean_shift": None if shift is None else round(shift, 6),
        "missing_rate_delta": None if miss is None else round(miss, 6),
    }


def compare(a: DataSketch, b: DataSketch, top_k: int = 10) -> dict:
    """Full drift/skew report between two :class:`DataSketch`es.

    Surfaces only what BOTH sides carry (a serve-side sketch has no
    label column; the comparison is over the intersection). Per column
    and per shard: PSI/KS/mean-shift; per shard additionally the
    top-``top_k`` features by normalized mean movement. ``max_psi`` /
    ``max_ks`` aggregate over every compared distribution — the numbers
    a gate thresholds."""
    out: dict = {"rows_a": a.rows, "rows_b": b.rows,
                 "columns": {}, "shards": {}}
    worst_psi = 0.0
    worst_ks = 0.0
    worst_surface = None
    for name in sorted(set(a.columns) & set(b.columns)):
        d = sketch_distance(a.columns[name], b.columns[name])
        out["columns"][name] = d
        if d["psi"] >= worst_psi:
            worst_psi, worst_surface = d["psi"], f"column:{name}"
        worst_ks = max(worst_ks, d["ks"])
    for name in sorted(set(a.shards) & set(b.shards)):
        blk_a, blk_b = a.shards[name], b.shards[name]
        d = {
            "values": sketch_distance(blk_a["values"], blk_b["values"]),
            "nnz": sketch_distance(blk_a["nnz"], blk_b["nnz"]),
        }
        fm_a, fm_b = blk_a["moments"], blk_b["moments"]
        if (fm_a.num_features, fm_a.cap) == (fm_b.num_features, fm_b.cap):
            mean_a, mean_b = fm_a.means(), fm_b.means()
            std_a, std_b = fm_a.stds(), fm_b.stds()
            both = (fm_a.counts > 0) & (fm_b.counts > 0)
            with np.errstate(invalid="ignore", divide="ignore"):
                pooled = np.sqrt((std_a ** 2 + std_b ** 2) / 2.0)
                moved = np.abs(mean_a - mean_b) / np.where(
                    pooled > 0, pooled, 1.0)
            moved = np.where(both, moved, 0.0)
            order = np.argsort(-moved)[:top_k]
            d["top_moved_features"] = [
                {
                    "index": int(i),
                    "mean_shift": round(float(moved[i]), 6),
                    "mean_a": round(float(mean_a[i]), 6),
                    "mean_b": round(float(mean_b[i]), 6),
                }
                for i in order if moved[i] > 0.0
            ]
        out["shards"][name] = d
        for key in ("values", "nnz"):
            if d[key]["psi"] >= worst_psi:
                worst_psi = d[key]["psi"]
                worst_surface = f"shard:{name}/{key}"
            worst_ks = max(worst_ks, d[key]["ks"])
    out["max_psi"] = round(worst_psi, 6)
    out["max_ks"] = round(worst_ks, 6)
    out["max_psi_surface"] = worst_surface
    return out


def render_comparison(report: dict) -> str:
    """Human-readable table for ``python -m photon_tpu_torch.cli.health``."""
    rows = [
        "== health comparison ==",
        f"rows: {report.get('rows_a')} vs {report.get('rows_b')}",
        f"max PSI {report.get('max_psi')} "
        f"({report.get('max_psi_surface')}); "
        f"max KS {report.get('max_ks')}",
        f"{'surface':<28} {'psi':>9} {'ks':>9} {'mean shift':>11}",
    ]
    for name, d in report.get("columns", {}).items():
        rows.append(
            f"column:{name:<21} {d['psi']:>9.4f} {d['ks']:>9.4f} "
            f"{d['mean_shift'] if d['mean_shift'] is not None else '-':>11}"
        )
    for name, blk in report.get("shards", {}).items():
        for key in ("values", "nnz"):
            d = blk[key]
            label = f"shard:{name}/{key}"
            rows.append(
                f"{label:<28} {d['psi']:>9.4f} {d['ks']:>9.4f} "
                f"{d['mean_shift'] if d['mean_shift'] is not None else '-':>11}"
            )
        moved = blk.get("top_moved_features") or []
        if moved:
            tops = ", ".join(
                f"#{m['index']}({m['mean_shift']:.2f})"
                for m in moved[:5]
            )
            rows.append(f"  top-moved features: {tops}")
    return "\n".join(rows)


# --------------------------------------------------------------------------
# calibration
# --------------------------------------------------------------------------


class CalibrationSketch:
    """Expected-calibration-error accumulator over uniform [0, 1] bins.

    Per bin: count / Σpredicted / Σlabel. ``ece()`` is the standard
    count-weighted mean of |accuracy - confidence| per non-empty bin.
    Mergeable; serializable with the same canonical-bytes contract as
    :class:`DistSketch`.
    """

    __slots__ = ("bins", "counts", "pred_sums", "label_sums", "missing")

    def __init__(self, bins: int = 10):
        if bins < 1:
            raise ValueError(f"calibration bins must be >= 1, got {bins}")
        self.bins = int(bins)
        self.counts = np.zeros(self.bins, dtype=np.int64)
        self.pred_sums = np.zeros(self.bins, dtype=np.float64)
        self.label_sums = np.zeros(self.bins, dtype=np.float64)
        self.missing = 0

    def update(self, probs: np.ndarray, labels: np.ndarray) -> None:
        p = probs.reshape(-1).astype(np.float64)
        y = labels.reshape(-1).astype(np.float64)
        # Non-finite pairs count as MISSING, never bin: a NaN-scoring
        # candidate is exactly what the health layer exists to refuse —
        # a NaN here must reach the numerics gate as a refusal, not
        # crash the VALIDATE stage in bincount (garbage bin index) or
        # poison label_sums so ece() goes NaN and 'NaN > ceiling'
        # silently passes the calibration gate.
        ok = np.isfinite(p) & np.isfinite(y)
        self.missing += int(p.size - ok.sum())
        p = np.clip(p[ok], 0.0, 1.0)
        y = y[ok]
        if p.size == 0:
            return
        idx = np.minimum((p * self.bins).astype(np.int64), self.bins - 1)
        self.counts += np.bincount(idx, minlength=self.bins)
        self.pred_sums += np.bincount(idx, weights=p, minlength=self.bins)
        self.label_sums += np.bincount(idx, weights=y, minlength=self.bins)

    def merge(self, other: "CalibrationSketch") -> "CalibrationSketch":
        if self.bins != other.bins:
            raise ValueError(
                f"cannot merge {other.bins}-bin calibration into "
                f"{self.bins}-bin")
        self.counts = self.counts + other.counts
        self.pred_sums = self.pred_sums + other.pred_sums
        self.label_sums = self.label_sums + other.label_sums
        self.missing += other.missing
        return self

    def ece(self) -> float | None:
        total = int(self.counts.sum())
        if not total:
            return None
        live = self.counts > 0
        conf = self.pred_sums[live] / self.counts[live]
        acc = self.label_sums[live] / self.counts[live]
        return float(
            np.sum(self.counts[live] * np.abs(acc - conf)) / total)

    def summary(self) -> dict:
        return {
            "bins": self.bins,
            "samples": int(self.counts.sum()),
            "missing": self.missing,
            "ece": self.ece(),
            "per_bin": [
                {
                    "count": int(c),
                    "confidence": (float(p / c) if c else None),
                    "accuracy": (float(s / c) if c else None),
                }
                for c, p, s in zip(
                    self.counts, self.pred_sums, self.label_sums)
            ],
        }

    def to_dict(self) -> dict:
        return {
            "bins": self.bins,
            "counts": [int(c) for c in self.counts],
            "pred_sums": [float(p) for p in self.pred_sums],
            "label_sums": [float(s) for s in self.label_sums],
            "missing": int(self.missing),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationSketch":
        out = cls(int(d["bins"]))
        out.counts = np.asarray(d["counts"], dtype=np.int64)
        out.pred_sums = np.asarray(d["pred_sums"], dtype=np.float64)
        out.label_sums = np.asarray(d["label_sums"], dtype=np.float64)
        out.missing = int(d.get("missing", 0))
        return out


def calibration_sink(task) -> tuple[CalibrationSketch, object] | None:
    """(sketch, score_sink) for ``GameEstimator.evaluate_model``.

    Binary tasks map raw margins through the logistic link to
    probabilities; non-binary tasks return None — ECE is undefined
    without a probability semantic, and a gate configured with
    ``max_ece`` on a regression task records that instead of guessing.
    """
    from photon_tpu_torch.types import TaskType

    if task not in (TaskType.LOGISTIC_REGRESSION,
                    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        return None
    cal = CalibrationSketch()

    def sink(scores: np.ndarray, labels: np.ndarray) -> None:
        z = np.clip(scores.astype(np.float64), -60.0, 60.0)
        cal.update(1.0 / (1.0 + np.exp(-z)), labels)

    return cal, sink


# --------------------------------------------------------------------------
# coefficient movement
# --------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as host numpy: the one
    device-to-host copy a health check makes, at gate or report time."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host64(x) -> np.ndarray:
    return _host(x).astype(np.float64)


def coefficient_movement(old_model, new_model, top_k: int = 10) -> dict:
    """Per-coordinate movement between two warm-start generations.

    For every coordinate both models carry: L2 and L∞ of the
    coefficient delta plus ``rel_l2`` (delta norm over the old norm —
    the scale-free "lurch" number a gate thresholds). Random-effect
    tables additionally report the ``top_k`` most-moved entities by
    per-row L2 (exact — the table is already in host reach at gate
    time; the streaming counterpart of "which entities are hot" stays
    with the serve-side SpaceSavingSketch)."""
    out: dict = {}
    shared = [
        cid for cid, _ in new_model.items() if cid in old_model
    ]
    for cid in shared:
        old_m, new_m = old_model[cid], new_model[cid]
        entity_keys = getattr(new_m, "entity_keys", None)
        if entity_keys is not None:
            w_old = _host64(old_m.coefficients)
            w_new = _host64(new_m.coefficients)
            if w_old.shape != w_new.shape:
                out[cid] = {
                    "structure_changed": True,
                    "shape_old": list(w_old.shape),
                    "shape_new": list(w_new.shape),
                }
                continue
            delta = w_new - w_old
            row_l2 = np.sqrt((delta * delta).sum(axis=1))
            order = np.argsort(-row_l2)[:top_k]
            entry = {
                "l2": float(np.sqrt((delta * delta).sum())),
                "linf": float(np.abs(delta).max()) if delta.size else 0.0,
                "norm_old": float(np.sqrt((w_old * w_old).sum())),
                "top_moved_entities": [
                    {
                        "entity": str(entity_keys[i]),
                        "l2": round(float(row_l2[i]), 6),
                    }
                    for i in order if row_l2[i] > 0.0
                ],
            }
        else:
            glm_old = getattr(old_m, "model", old_m)
            glm_new = getattr(new_m, "model", new_m)
            w_old = _host64(glm_old.coefficients.means)
            w_new = _host64(glm_new.coefficients.means)
            if w_old.shape != w_new.shape:
                out[cid] = {
                    "structure_changed": True,
                    "shape_old": list(w_old.shape),
                    "shape_new": list(w_new.shape),
                }
                continue
            delta = w_new - w_old
            entry = {
                "l2": float(np.sqrt((delta * delta).sum())),
                "linf": float(np.abs(delta).max()) if delta.size else 0.0,
                "norm_old": float(np.sqrt((w_old * w_old).sum())),
            }
        entry["rel_l2"] = round(
            entry["l2"] / (entry["norm_old"] + 1e-12), 6)
        out[cid] = entry
    return out


def scan_model(model) -> list[str]:
    """Non-finite scan over a model's coefficient tables (host numpy;
    called once per gate decision, never on a dispatch path). Returns
    one message per offending coordinate."""
    out = []
    for cid, m in model.items():
        glm = getattr(m, "model", None)
        coef = (
            glm.coefficients.means if glm is not None
            else m.coefficients
        )
        arr = _host(coef)
        bad = int((~np.isfinite(arr)).sum())
        if bad:
            out.append(
                f"coordinate {cid!r}: {bad} non-finite coefficient(s) "
                f"of {arr.size}")
    return out


# --------------------------------------------------------------------------
# evaluation coverage
# --------------------------------------------------------------------------


def count_undefined_groups(per_group: dict) -> dict:
    """Coverage summary over ``EvaluationSuite.evaluate_per_group``
    output: per metric — group count, how many groups the metric is
    UNDEFINED on (the documented NaN convention for single-class-AUC
    groups), and the mean over DEFINED groups only. The undefined
    count is first-class: silently averaging over NaN groups (or
    worse, dropping them without saying so) is exactly the kind of
    quiet statistical rot this module exists to surface."""
    out = {}
    for metric, values in per_group.items():
        arr = np.asarray(values, dtype=np.float64)
        defined = np.isfinite(arr)
        out[metric] = {
            "groups": int(arr.size),
            "undefined_groups": int(arr.size - defined.sum()),
            "mean_defined": (
                float(arr[defined].mean()) if defined.any() else None
            ),
        }
    return out


# --------------------------------------------------------------------------
# numerics sentinels (piggybacking the convergence-trace readback)
# --------------------------------------------------------------------------


def sentinel_watch(coordinates: tuple, array) -> None:
    """Park one fit's convergence block for lazy non-finite scanning.

    ``array`` is the [iters, coords, metrics] tensor a fit already
    produced: the fused fit (``algorithm/fused_fit.py``) parks its
    convergence block here whenever health is armed. Parking
    keeps a reference only: no wait for the card, no copy (the
    obs/convergence.py contract). The copy to the host and the scan
    happen at :func:`numerics_report` time."""
    with _LOCK:
        _STATE["sentinel_seq"] += 1
        _STATE["sentinels"].append({
            "seq": _STATE["sentinel_seq"],
            "coordinates": tuple(coordinates),
            "array": array,
            "np": None,
        })


def sentinel_seq() -> int:
    """Monotonic count of fits ever parked — callers window a
    :func:`numerics_report` to "fits since my mark" with it (the pilot
    marks at each cycle's trigger, so an old cycle's
    violation never refuses a later, healthy retrain)."""
    with _LOCK:
        return _STATE["sentinel_seq"]


def _materialize_sentinel(entry: dict) -> np.ndarray:
    """The parked tensor's copy to the host (``.cpu()``), made outside
    the module lock and installed under it (the obs/convergence.py
    double-checked pattern)."""
    with _LOCK:
        arr = entry.get("np")
        dev = entry.get("array")
    if arr is None:
        fetched = _host(dev)
        with _LOCK:
            arr = entry.get("np")
            if arr is None:
                arr = entry["np"] = fetched
                entry["array"] = None
    return arr


def numerics_report(since_seq: int = 0) -> dict:
    """Scan parked sentinel blocks for non-finite values.

    Returns ``{"fits_scanned", "nonfinite_total", "violations"}`` where
    each violation names (fit seq, coordinate, metric, first bad
    iteration, count). ``since_seq`` windows the scan to fits parked
    AFTER a :func:`sentinel_seq` mark. The copy to the host happens
    HERE: by report or gate time the fits completed long ago, so it is
    a plain copy, not a wait inside a fit."""
    from photon_tpu_torch.obs.convergence import METRICS

    with _LOCK:
        parked = [
            e for e in _STATE["sentinels"] if e["seq"] > since_seq
        ]
    violations = []
    total = 0
    for entry in parked:
        fit_i = entry["seq"]
        arr = _materialize_sentinel(entry)
        bad = ~np.isfinite(arr)
        if not bad.any():
            continue
        for j, cid in enumerate(entry["coordinates"]):
            for k, metric in enumerate(METRICS):
                col = bad[:, j, k]
                n = int(col.sum())
                if n:
                    total += n
                    violations.append({
                        "fit": fit_i,
                        "coordinate": cid,
                        "metric": metric,
                        "first_iteration": int(np.argmax(col)),
                        "count": n,
                    })
    return {
        "fits_scanned": len(parked),
        "nonfinite_total": total,
        "violations": violations,
    }


# --------------------------------------------------------------------------
# the serve tap (bounded-rate request/score sampling)
# --------------------------------------------------------------------------


def observe_serve_batch(features_list, scores, widths=None) -> None:
    """Sample one dispatched serving batch into the serve-side sketches.

    Called by the queue's dispatch worker AFTER scoring, outside the
    queue lock (serve/queue.py). Bounded: only every
    ``serve_sample_every``-th batch is folded in, so the tap's cost is
    amortized to ~zero at the default rate; a no-op when the layer is
    disabled. ``features_list`` holds the batch's raw request feature
    dicts (shard -> dense vector | (indices, values)); ``scores`` the
    served raw scores; ``widths`` maps shard -> the serving spec's
    feature-space size — WITHOUT it a sparse shard's per-feature
    moments would be pinned by the first sampled batch's max index and
    could never align with the training sketch's (vocabulary-sized)
    moments, so ``compare`` would silently drop the per-feature skew
    evidence."""
    with _LOCK:
        if not _ENABLED:
            return
        _STATE["serve_batches_seen"] += 1
        if (_STATE["serve_batches_seen"] - 1) % _STATE[
            "serve_sample_every"
        ] != 0:
            return
    # All numpy preparation outside the lock: the dispatch worker holds
    # no lock while packing, and a concurrent scrape only ever waits
    # for the fold below.
    widths = widths or {}
    score_arr = np.asarray(scores, dtype=np.float64).reshape(-1)
    dense: dict[str, np.ndarray] = {}
    sparse: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for name in features_list[0].keys() if features_list else ():
        leaves = [req[name] for req in features_list]
        if isinstance(leaves[0], tuple):
            sparse[name] = (
                np.concatenate(
                    [np.asarray(ix).reshape(-1) for ix, _ in leaves]),
                np.concatenate(
                    [np.asarray(v, dtype=np.float64).reshape(-1)
                     for _, v in leaves]),
            )
        else:
            dense[name] = np.stack([
                np.asarray(x, dtype=np.float64) for x in leaves
            ])
    with _LOCK:
        if not _ENABLED:  # disabled between check and fold
            return
        _STATE["serve_batches_sampled"] += 1
        _STATE["serve_requests_sampled"] += len(features_list)
        sketch = _STATE["serve_sketch"]
        sketch.rows += len(features_list)
        sketch.column("score").observe(score_arr)
        for name, x in dense.items():
            sketch.update_requests_dense(name, x)
        for name, (ix, v) in sparse.items():
            nf = max(
                int(widths.get(name) or 0),
                int(ix.max()) + 1 if ix.size else 1,
            )
            blk = sketch.shards.get(name)
            if blk is not None:
                nf = max(nf, blk["moments"].num_features)
            sketch.update_requests_sparse(
                name, ix, v, nf, len(features_list))


def set_serve_sample_every(n: int) -> None:
    """Tap rate: fold every ``n``-th dispatched batch (default 8)."""
    if n < 1:
        raise ValueError(f"sample_every must be >= 1, got {n}")
    with _LOCK:
        _STATE["serve_sample_every"] = int(n)


def serve_mark() -> DataSketch:
    """A snapshot of the tap to window later reads against: the skew
    gate wants THIS CYCLE's traffic, and ``serve_sketch(since=mark)``
    subtracts the mark from the (cumulative) tap — without a window, a
    month-old tap dilutes a fresh traffic shift to invisibility."""
    with _LOCK:
        return _STATE["serve_sketch"].clone()


def serve_sketch(since: DataSketch | None = None) -> DataSketch:
    """A consistent COPY of the serve tap's sketch (safe to compare or
    persist while the worker keeps folding); ``since`` (a
    :func:`serve_mark`) windows it to the traffic sampled after the
    mark. The lock hold is array memcpys only (``clone``) — a reader
    never stalls the dispatch worker for a serialization."""
    with _LOCK:
        snap = _STATE["serve_sketch"].clone()
    return snap if since is None else snap.diff_from(since)


def serve_snapshot() -> dict:
    with _LOCK:
        out = {
            "batches_seen": _STATE["serve_batches_seen"],
            "batches_sampled": _STATE["serve_batches_sampled"],
            "requests_sampled": _STATE["serve_requests_sampled"],
            "sample_every": _STATE["serve_sample_every"],
        }
        snap = _STATE["serve_sketch"].clone()
    out["sketch_summary"] = snap.summary()
    return out


def save_serve_sketch(path: str) -> int:
    """Persist the tap's sketch (the ``cli.serve --health-sketch``
    artifact ``cli.health`` compares against a training manifest's
    ``ingest-sketch.json``). Serialization happens OUTSIDE the module
    lock (``serve_sketch`` clones under it). Returns the
    sampled-request count."""
    sk = serve_sketch()
    sk.save(path)
    with _LOCK:
        return _STATE["serve_requests_sampled"]


# --------------------------------------------------------------------------
# train-side reference
# --------------------------------------------------------------------------


def set_train_sketch(sketch: DataSketch) -> None:
    """Register the most recent training-data sketch (the streaming
    ingest calls this at the end of a health-armed run) so skew
    (train vs serve tap) is computable in-process."""
    with _LOCK:
        _STATE["train_sketch"] = sketch


def train_sketch() -> DataSketch | None:
    with _LOCK:
        return _STATE["train_sketch"]


# --------------------------------------------------------------------------
# promotion gate policy
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HealthGatePolicy:
    """Thresholds that refuse a promotion (the pilot applies them in
    VALIDATE, ``pilot/loop.py``; PILOT.md).

    Every reason is prefixed ``health:`` so refusal bookkeeping (state
    file, flight post-mortem) distinguishes statistical refusals from
    metric-delta ones. ``None`` disables the individual check.

    - ``max_drift_psi``: ceiling on the max PSI between this cycle's
      ingest sketch and the last PROMOTED cycle's (temporal drift).
    - ``max_skew_psi``: ceiling on the max PSI between this cycle's
      ingest sketch and the serve tap's request sketch (train/serve
      skew; skipped until the tap has sampled ``min_skew_requests``).
    - ``max_ece``: ceiling on the candidate's expected calibration
      error on the validation scores (binary tasks only).
    - ``max_coefficient_rel_l2``: ceiling on any coordinate's
      relative coefficient movement vs the serving generation.
    - ``forbid_nonfinite``: refuse when the fit's numerics sentinels
      saw any non-finite convergence value or the candidate's tables
      carry non-finite coefficients.
    """

    max_drift_psi: float | None = 0.25
    max_skew_psi: float | None = None
    max_ece: float | None = None
    max_coefficient_rel_l2: float | None = None
    forbid_nonfinite: bool = True
    min_skew_requests: int = 64

    def evaluate(
        self,
        *,
        drift: dict | None = None,
        skew: dict | None = None,
        skew_requests: int = 0,
        ece: float | None = None,
        movement: dict | None = None,
        nonfinite: dict | None = None,
        model_scan: list | tuple = (),
    ) -> list[str]:
        """Refusal reasons (empty = healthy); inputs absent when their
        surface is unarmed are skipped, never guessed."""
        reasons: list[str] = []
        if self.max_drift_psi is not None and drift is not None:
            if drift["max_psi"] > self.max_drift_psi:
                reasons.append(
                    f"health:drift PSI {drift['max_psi']:.4f} > "
                    f"{self.max_drift_psi:g} on "
                    f"{drift['max_psi_surface']} (this cycle's input "
                    "distribution moved vs the last promoted cycle)")
        if (
            self.max_skew_psi is not None
            and skew is not None
            and skew_requests >= self.min_skew_requests
        ):
            if skew["max_psi"] > self.max_skew_psi:
                reasons.append(
                    f"health:skew PSI {skew['max_psi']:.4f} > "
                    f"{self.max_skew_psi:g} on "
                    f"{skew['max_psi_surface']} (training features "
                    "diverge from sampled serving traffic)")
        if self.max_ece is not None and ece is not None:
            if ece > self.max_ece:
                reasons.append(
                    f"health:calibration ECE {ece:.4f} > "
                    f"{self.max_ece:g} (candidate scores are "
                    "mis-calibrated on the validation set)")
        if self.max_coefficient_rel_l2 is not None and movement:
            for cid, m in sorted(movement.items()):
                if m.get("structure_changed"):
                    continue
                if m["rel_l2"] > self.max_coefficient_rel_l2:
                    reasons.append(
                        f"health:coefficients {cid} moved rel_l2 "
                        f"{m['rel_l2']:.4f} > "
                        f"{self.max_coefficient_rel_l2:g} "
                        "(warm-start generation lurched)")
        if self.forbid_nonfinite:
            if nonfinite is not None and nonfinite["nonfinite_total"]:
                v = nonfinite["violations"][0]
                reasons.append(
                    "health:numerics "
                    f"{nonfinite['nonfinite_total']} non-finite "
                    "convergence value(s) during the fit (first: "
                    f"coordinate {v['coordinate']!r} metric "
                    f"{v['metric']} iteration {v['first_iteration']})")
            for msg in model_scan:
                reasons.append(f"health:numerics {msg}")
        return reasons


# --------------------------------------------------------------------------
# process-global state + surfaces
# --------------------------------------------------------------------------

_LOCK = threading.Lock()

# Lock-free read mirror of the armed flag (the ledger's pattern): the
# serve worker and the streaming ingest check `enabled()` on their hot
# paths even when the layer is off — a disabled check must never queue
# behind a scrape holding the module lock. Writes stay under _LOCK.
_ENABLED = False


def _fresh_state() -> dict:
    return {
        "serve_sample_every": 8,
        "serve_batches_seen": 0,
        "serve_batches_sampled": 0,
        "serve_requests_sampled": 0,
        "serve_sketch": DataSketch(),
        "train_sketch": None,
        "sentinel_seq": 0,
        "sentinels": deque(maxlen=_MAX_SENTINELS),
        "last_gate": None,  # record_gate's last promotion decision
    }


_STATE = _fresh_state()


def enable() -> None:
    """Arm the health layer (sketching, the serve tap, sentinels).
    Host-side only: the captured serve graphs, their replays and a
    fit's host syncs are the same either way."""
    global _ENABLED
    with _LOCK:
        _ENABLED = True


def disable() -> None:
    global _ENABLED
    with _LOCK:
        _ENABLED = False


def enabled() -> bool:
    # Deliberately lock-free: a plain bool read on the dispatch/fit
    # hot paths (see _ENABLED above).
    return _ENABLED


def reset() -> None:
    """Drop all recorded health state; keeps the enabled flag (the
    ``obs.reset()`` contract — flags are policy, records are data)."""
    global _STATE
    with _LOCK:
        sample = _STATE["serve_sample_every"]
        _STATE = _fresh_state()
        _STATE["serve_sample_every"] = sample


def record_gate(decision: dict) -> None:
    """The last health-gate decision (reasons + measured numbers) —
    what ``snapshot()`` and the gauges surface."""
    with _LOCK:
        _STATE["last_gate"] = decision


def raw_snapshot() -> dict:
    """Crash-safe view: counters and serve-tap sizes only — NO device
    materialization (a flight dump must not fetch device arrays while
    the process is dying; same policy as the ledger's raw dump)."""
    with _LOCK:
        return {
            "enabled": _ENABLED,
            "serve_batches_seen": _STATE["serve_batches_seen"],
            "serve_batches_sampled": _STATE["serve_batches_sampled"],
            "serve_requests_sampled": _STATE["serve_requests_sampled"],
            "sentinels_parked": len(_STATE["sentinels"]),
            "train_sketch_rows": (
                _STATE["train_sketch"].rows
                if _STATE["train_sketch"] is not None else None
            ),
            "last_gate": _STATE["last_gate"],
        }


def snapshot() -> dict:
    """Full JSON-ready view (obs.snapshot()['health'] when armed):
    serve tap summary, train-sketch summary, the numerics report (this
    is where parked sentinels materialize — by snapshot time every fit
    completed), and the last gate decision."""
    out = raw_snapshot()
    out["numerics"] = numerics_report()
    with _LOCK:
        train = _STATE["train_sketch"]
        serve = _STATE["serve_sketch"].clone()  # memcpy-cheap hold
    out["train_sketch"] = (
        train.summary() if train is not None else None
    )
    out["serve_sketch"] = serve.summary()
    return out


def metrics_families() -> list[dict]:
    """``health_*`` /metrics families; EMPTY when the layer is off, so
    an unarmed process scrapes exactly what it always did (the monitor
    appends this next to the ledger's — obs/monitor.py render)."""
    with _LOCK:
        if not _ENABLED:
            return []
        sampled = _STATE["serve_requests_sampled"]
        seen = _STATE["serve_batches_seen"]
        gate = _STATE["last_gate"]
        sentinels = len(_STATE["sentinels"])
    from photon_tpu_torch.obs import monitor

    fams = [
        monitor.family(
            "health_enabled", "gauge",
            "1 while the model/data health layer is armed",
            [("", {}, 1.0)],
        ),
        monitor.family(
            "health_serve_batches_seen_total", "counter",
            "serving batches the health tap observed (sampled at "
            "1/sample_every)",
            [("", {}, float(seen))],
        ),
        monitor.family(
            "health_serve_requests_sampled_total", "counter",
            "serving requests folded into the serve-side sketch",
            [("", {}, float(sampled))],
        ),
        monitor.family(
            "health_sentinel_fits", "gauge",
            "fits with a parked numerics-sentinel trace",
            [("", {}, float(sentinels))],
        ),
    ]
    if gate is not None:
        fams.append(monitor.family(
            "health_gate_violations", "gauge",
            "health-gate refusal reasons at the last gate decision",
            [("", {}, float(len(gate.get("reasons") or ())))],
        ))
        for key, label in (
            ("drift", "drift"), ("skew", "skew"),
        ):
            block = gate.get(key)
            if isinstance(block, dict) and "max_psi" in block:
                fams.append(monitor.family(
                    f"health_{label}_max_psi", "gauge",
                    f"max PSI at the last {label} comparison",
                    [("", {}, float(block["max_psi"]))],
                ))
        if gate.get("ece") is not None:
            fams.append(monitor.family(
                "health_ece", "gauge",
                "candidate expected-calibration-error at the last "
                "gate decision",
                [("", {}, float(gate["ece"]))],
            ))
    return fams
