"""Live monitoring for long-running processes: pull, don't post-mortem
(port of ``photon_tpu/obs/monitor.py``).

The snapshot, JSONL, trace and flight exports describe a process at its
end or its crash. A serving fleet is observed while it runs, by
pulling, so this module adds the four pieces a scrape-based monitoring
stack needs, all stdlib:

- **The HTTP exporter** (:class:`MonitorServer`): ``http.server`` on a
  daemon thread serving ``/metrics`` (Prometheus text exposition
  0.0.4, rendered from a consistent snapshot of the metrics registry
  plus any registered collectors), ``/healthz`` (liveness: the process
  is up and the exporter thread answers) and ``/readyz`` (readiness:
  the caller's probe; for ``cli.serve``, tables resident, every rung's
  CUDA graph captured and the breaker closed). Wired into
  ``cli.serve --monitor-port`` and ``cli.train --monitor-port``.
- **Sliding-window latency quantiles** (:class:`RollingHistogram`):
  log-bucketed fixed-size histograms in a ring of rotating windows, so
  ``p50/p99`` describe the last N seconds, not the whole run.
  Quantile error is bounded by the bucket growth factor (a reported
  quantile is the upper bound of the bucket holding the exact one).
- **Declared SLOs with multi-window burn rates** (:class:`SloPolicy` /
  :class:`SloTracker`): ``p99_ms`` (latency objective), ``error_rate``
  and ``cold_entity_rate`` budgets, each tracked as good/bad counts in
  a rotating ring and reported as ``observed / budget`` burn over a
  short and a long window, surfaced through ``/metrics``, the serve
  queue's ``health()`` and ``drive``'s summary.
- **Entity-hotness sketches** (:class:`SpaceSavingSketch`):
  space-saving top-K over per-coordinate entity lookups, the
  bounded-memory answer to "which entities are hot enough to shard or
  cache".

Everything here is host bookkeeping: nothing launches a kernel, captures
a graph or copies to or from the card, so a scrape under load leaves the
serve ladder's graph captures and replays unchanged.

Threading. The exporter's handler threads (one per in-flight scrape;
``ThreadingHTTPServer``) read every surface through snapshot methods
that copy under that surface's own small lock and release it before any
rendering or socket I/O: a scrape never holds a lock the serve worker
needs across anything blocking. Each surface keeps its own lock, and no
path nests two of them:

- ``RollingHistogram._hist_lock``: the window counts, sums, totals,
  cursor and start;
- ``SpaceSavingSketch._sketch_lock``: the tracked counts and errors and
  the observed total;
- ``SloTracker._slo_lock``: the rings, their cursor and start;
- ``MonitorServer._server_lock``: the scrape counters.

Writers are the serve worker (windows, sketches, SLO rings) and
producers (SLO rejection counts); readers are ``do_GET`` and the
queue's ``health()``.
"""

from __future__ import annotations

import http.server
import json
import math
import threading
import time


# --------------------------------------------------------------------------
# Prometheus text exposition (render + shared validator)
# --------------------------------------------------------------------------

# One rendered metric family: ``samples`` is a list of
# (suffix, labels-dict, value) — suffix is "" for plain families and
# "_bucket"/"_count"/"_sum" for histogram series.
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def family(name: str, mtype: str, help_: str, samples) -> dict:
    if mtype not in _TYPES:
        raise ValueError(f"unknown metric type {mtype!r}")
    return {
        "name": metric_name(name),
        "type": mtype,
        "help": help_,
        "samples": list(samples),
    }


def state_family(name: str, states, current, help_: str) -> dict:
    """A Prometheus state-set: one-hot gauge samples labeled by state
    (``name{state="INGEST"} 1`` next to zeros for the others) — the
    queryable form of an enum-valued gauge like the pilot's
    state-machine stage. ``current`` must be one of ``states``."""
    states = tuple(states)
    if current not in states:
        raise ValueError(
            f"state {current!r} is not one of the declared {states}")
    return family(
        name, "gauge", help_,
        [("", {"state": s}, 1.0 if s == current else 0.0)
         for s in states],
    )


def metric_name(raw: str) -> str:
    """Sanitize to the exposition charset ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = [
        c if (c.isascii() and (c.isalnum() or c in "_:")) else "_"
        for c in raw
    ]
    if not out:
        return "_"
    if out[0].isdigit():
        out.insert(0, "_")
    return "".join(out)


def _label_name(raw: str) -> str:
    out = metric_name(raw).replace(":", "_")
    return out


def _label_value(raw) -> str:
    return (
        str(raw)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(value: float) -> str:
    value = float(value)
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _parse_series_key(key: str) -> tuple[str, dict]:
    """Invert ``obs.metrics._series_key``: ``name{k=v,...}`` -> parts."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels: dict[str, str] = {}
    for pair in rest.rstrip("}").split(","):
        if not pair:
            continue
        k, _, v = pair.partition("=")
        labels[k] = v
    return name, labels


def registry_families(snapshot: dict) -> list[dict]:
    """Metric families from a ``MetricsRegistry.snapshot()``.

    Counters and gauges map one-to-one; the registry's count/sum/min/max
    histograms render as a summary (``_count``/``_sum``) plus ``_min`` /
    ``_max`` gauge families — they carry no buckets by design
    (obs/metrics.py keeps the hot host path to four scalars).
    """
    grouped: dict[tuple[str, str], list] = {}
    for kind in ("counters", "gauges"):
        for key, value in sorted(snapshot.get(kind, {}).items()):
            name, labels = _parse_series_key(key)
            grouped.setdefault((kind, name), []).append(
                ("", labels, float(value))
            )
    out = [
        family(
            name,
            "counter" if kind == "counters" else "gauge",
            f"photon_tpu_torch metrics-registry {kind[:-1]} {name}",
            samples,
        )
        for (kind, name), samples in sorted(grouped.items())
    ]
    hists: dict[str, list] = {}
    extrema: dict[str, list] = {}
    for key, h in sorted(snapshot.get("histograms", {}).items()):
        name, labels = _parse_series_key(key)
        hists.setdefault(name, []).extend(
            [
                ("_count", labels, float(h["count"])),
                ("_sum", labels, float(h["sum"])),
            ]
        )
        for bound in ("min", "max"):
            extrema.setdefault(f"{name}_{bound}", []).append(
                ("", labels, float(h[bound]))
            )
    for name, samples in sorted(hists.items()):
        out.append(
            family(
                name,
                "summary",
                f"photon_tpu_torch metrics-registry histogram {name} "
                "(count/sum; min/max ride as gauges)",
                samples,
            )
        )
    for name, samples in sorted(extrema.items()):
        out.append(
            family(
                name, "gauge",
                f"photon_tpu_torch metrics-registry histogram extremum "
                f"{name}",
                samples,
            )
        )
    return out


def render_exposition(families: list[dict]) -> str:
    """Families -> Prometheus text exposition format 0.0.4."""
    lines: list[str] = []
    seen: set[str] = set()
    for fam in families:
        name = fam["name"]
        if name in seen:
            raise ValueError(f"duplicate metric family {name!r}")
        seen.add(name)
        help_ = fam["help"].replace("\\", "\\\\").replace("\n", "\\n")
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for suffix, labels, value in fam["samples"]:
            label_txt = ""
            if labels:
                inner = ",".join(
                    f'{_label_name(k)}="{_label_value(v)}"'
                    for k, v in labels.items()
                )
                label_txt = "{" + inner + "}"
            lines.append(f"{name}{suffix}{label_txt} {_fmt(value)}")
    return "\n".join(lines) + "\n"


_NAME_OK = None  # compiled lazily (keep import time flat)


def _name_re():
    global _NAME_OK
    if _NAME_OK is None:
        import re

        _NAME_OK = (
            re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$"),
            re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$"),
            re.compile(
                r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
                r"(?P<labels>\{.*\})?\s+(?P<value>\S+)$"
            ),
            re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'),
        )
    return _NAME_OK


def validate_exposition(text: str) -> int:
    """Validate Prometheus text exposition; the ONE validator shared by
    the unit tests and the CI scrape step.

    Checks: metric/label name charsets, every sample preceded by its
    family's ``# HELP``/``# TYPE`` pair, known types, parseable values,
    histogram bucket monotonicity (cumulative ``le`` buckets
    nondecreasing, ``+Inf`` present and equal to ``_count``). Raises
    ``ValueError`` on the first violation; returns the sample count.
    """
    name_re, label_re, sample_re, labelpair_re = _name_re()
    typed: dict[str, str] = {}
    helped: set[str] = set()
    samples = 0
    # histogram name -> labels-sans-le key -> [(le, value)], count value
    buckets: dict[str, dict[str, list]] = {}
    counts: dict[str, dict[str, float]] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            name = line.split(None, 3)[2]
            if not name_re.match(name):
                raise ValueError(f"line {i}: bad metric name {name!r}")
            helped.add(name)
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ValueError(f"line {i}: malformed TYPE line")
            name, mtype = parts[2], parts[3]
            if not name_re.match(name):
                raise ValueError(f"line {i}: bad metric name {name!r}")
            if mtype not in _TYPES:
                raise ValueError(f"line {i}: unknown type {mtype!r}")
            if name in typed:
                raise ValueError(f"line {i}: duplicate TYPE for {name!r}")
            typed[name] = mtype
            continue
        if line.startswith("#"):
            continue
        m = sample_re.match(line)
        if m is None:
            raise ValueError(f"line {i}: unparseable sample {line!r}")
        full = m.group("name")
        base = full
        suffix = ""
        for s in ("_bucket", "_count", "_sum"):
            if full.endswith(s) and full[: -len(s)] in typed:
                base, suffix = full[: -len(s)], s
                break
        if base not in typed or base not in helped:
            raise ValueError(
                f"line {i}: sample {full!r} has no HELP/TYPE family"
            )
        value_txt = m.group("value")
        if value_txt not in ("+Inf", "-Inf", "NaN"):
            try:
                float(value_txt)
            except ValueError:
                raise ValueError(
                    f"line {i}: non-numeric value {value_txt!r}"
                )
        labels = {}
        if m.group("labels"):
            for lm in labelpair_re.finditer(m.group("labels")):
                k = lm.group(1)
                if not label_re.match(k):
                    raise ValueError(f"line {i}: bad label name {k!r}")
                labels[k] = lm.group(2)
        if typed[base] == "histogram":
            key = ",".join(
                f"{k}={v}" for k, v in sorted(labels.items())
                if k != "le"
            )
            if suffix == "_bucket":
                le = labels.get("le")
                if le is None:
                    raise ValueError(
                        f"line {i}: histogram bucket without le label"
                    )
                le_val = (
                    math.inf if le == "+Inf" else float(le)
                )
                buckets.setdefault(base, {}).setdefault(key, []).append(
                    (le_val, float(value_txt))
                )
            elif suffix == "_count":
                counts.setdefault(base, {})[key] = float(value_txt)
        samples += 1
    for name, series in buckets.items():
        for key, pairs in series.items():
            ordered = sorted(pairs)
            les = [le for le, _ in ordered]
            vals = [v for _, v in ordered]
            if len(set(les)) != len(les):
                raise ValueError(
                    f"{name}{{{key}}}: duplicate le bucket"
                )
            if any(b < a for a, b in zip(vals, vals[1:])):
                raise ValueError(
                    f"{name}{{{key}}}: bucket counts not monotone "
                    f"({vals})"
                )
            if not les or not math.isinf(les[-1]):
                raise ValueError(f"{name}{{{key}}}: no +Inf bucket")
            cnt = counts.get(name, {}).get(key)
            if cnt is not None and cnt != vals[-1]:
                raise ValueError(
                    f"{name}{{{key}}}: _count {cnt} != +Inf bucket "
                    f"{vals[-1]}"
                )
    return samples


# --------------------------------------------------------------------------
# sliding-window latency quantiles
# --------------------------------------------------------------------------


def log_bucket_bounds(
    lo: float = 1e-4, hi: float = 60.0, growth: float = 2 ** 0.25
) -> tuple[float, ...]:
    """Log-spaced bucket upper bounds covering [lo, hi] seconds.

    ``growth`` is the per-bucket ratio and therefore the quantile
    error bound: a reported quantile is the upper bound of the bucket
    the exact quantile falls in, so it sits within one growth factor
    above it (values below ``lo`` report ``lo``; the +Inf catch-all is
    implicit in :class:`RollingHistogram`).
    """
    if not (0 < lo < hi) or growth <= 1.0:
        raise ValueError(f"bad bucket spec lo={lo} hi={hi} growth={growth}")
    bounds = [lo]
    while bounds[-1] < hi:
        bounds.append(bounds[-1] * growth)
    return tuple(bounds)


class RollingHistogram:
    """Fixed-size log-bucketed histogram over a ring of rotating windows.

    ``num_windows`` sub-windows of ``window_s`` seconds each; quantiles
    and bucket snapshots merge the ring, so they describe the last
    ``num_windows * window_s`` seconds (plus the partially-filled
    current window). Rotation happens lazily on observe/read — no
    timer thread. O(buckets) memory, O(1) observe.
    """

    def __init__(
        self,
        *,
        window_s: float = 10.0,
        num_windows: int = 6,
        bounds: tuple[float, ...] | None = None,
        clock=time.monotonic,
    ):
        if window_s <= 0 or num_windows < 1:
            raise ValueError(
                f"bad ring spec window_s={window_s} "
                f"num_windows={num_windows}"
            )
        self.window_s = float(window_s)
        self.num_windows = int(num_windows)
        self.bounds = tuple(bounds) if bounds else log_bucket_bounds()
        self._clock = clock
        self._hist_lock = threading.Lock()
        n = len(self.bounds) + 1  # +Inf catch-all
        self._win_counts = [
            [0] * n for _ in range(self.num_windows)
        ]
        self._win_sums = [0.0] * self.num_windows
        self._win_totals = [0] * self.num_windows
        self._win_cursor = 0
        self._window_start = self._clock()

    def _rotate_locked(self, now: float) -> None:
        # The caller holds _hist_lock.
        stale = int((now - self._window_start) // self.window_s)
        if stale <= 0:
            return
        for _ in range(min(stale, self.num_windows)):
            self._win_cursor = (self._win_cursor + 1) % self.num_windows
            self._win_counts[self._win_cursor] = [0] * (len(self.bounds) + 1)
            self._win_sums[self._win_cursor] = 0.0
            self._win_totals[self._win_cursor] = 0
        self._window_start += stale * self.window_s

    def _bucket_index(self, value: float) -> int:
        import bisect

        return bisect.bisect_left(self.bounds, value)

    def observe(self, value: float) -> None:
        value = float(value)
        idx = self._bucket_index(value)
        with self._hist_lock:
            self._rotate_locked(self._clock())
            self._win_counts[self._win_cursor][idx] += 1
            self._win_sums[self._win_cursor] += value
            self._win_totals[self._win_cursor] += 1

    def _merged_locked(self) -> tuple[list[int], int, float]:
        merged = [0] * (len(self.bounds) + 1)
        for win in self._win_counts:
            for i, c in enumerate(win):
                merged[i] += c
        return merged, sum(self._win_totals), sum(self._win_sums)

    def snapshot(self) -> dict:
        """Consistent merged view of the ring (bucket counts per upper
        bound, total count/sum, the window the numbers describe)."""
        with self._hist_lock:
            self._rotate_locked(self._clock())
            merged, total, total_sum = self._merged_locked()
        return {
            "bounds": self.bounds,
            "counts": merged,
            "count": total,
            "sum": total_sum,
            "window_seconds": self.window_s * self.num_windows,
        }

    def _quantile_from(self, snap: dict, q: float) -> float | None:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        total = snap["count"]
        if not total:
            return None
        rank = max(1, math.ceil(q * total))
        seen = 0
        for i, c in enumerate(snap["counts"]):
            seen += c
            if seen >= rank:
                if i < len(self.bounds):
                    return self.bounds[i]
                return math.inf
        return math.inf  # pragma: no cover — rank <= total by construction

    def quantile(self, q: float) -> float | None:
        """Windowed quantile estimate (bucket upper bound; None when the
        ring is empty). Error bound: one bucket growth factor."""
        return self._quantile_from(self.snapshot(), q)

    def quantiles_ms(self, qs=(0.5, 0.9, 0.99)) -> dict:
        """All quantiles (milliseconds) + the sample count from ONE
        snapshot — mutually consistent by construction (independent
        reads could interleave a ring rotation and report
        p99 < p50)."""
        snap = self.snapshot()
        out = {}
        for q in qs:
            v = self._quantile_from(snap, q)
            key = f"p{int(q * 100)}_ms"
            # A quantile in the +Inf catch-all clamps to the top
            # finite bound: the dict feeds json.dumps surfaces (cli
            # --json, ``drive``'s summary) and a literal Infinity is not
            # valid RFC-8259 JSON. The exposition histogram still
            # shows the +Inf bucket mass, so the overflow is visible.
            out[key] = None if v is None else round(
                min(v, self.bounds[-1]) * 1e3, 3
            )
        out["count"] = snap["count"]
        return out

    def prometheus_family(self, name: str, help_: str) -> dict:
        snap = self.snapshot()
        cumulative = 0
        samples = []
        for bound, c in zip(snap["bounds"], snap["counts"]):
            cumulative += c
            samples.append(
                ("_bucket", {"le": _fmt(bound)}, float(cumulative))
            )
        samples.append(
            ("_bucket", {"le": "+Inf"}, float(snap["count"]))
        )
        samples.append(("_count", {}, float(snap["count"])))
        samples.append(("_sum", {}, float(snap["sum"])))
        return family(name, "histogram", help_, samples)


# --------------------------------------------------------------------------
# entity-hotness sketch (space-saving top-K)
# --------------------------------------------------------------------------


class SpaceSavingSketch:
    """Metwally et al. space-saving top-K heavy hitters.

    Bounded memory (``k`` tracked keys); every tracked key's count
    overestimates its true frequency by at most its recorded ``error``
    — the standard guarantee that makes the top of the list
    trustworthy on skewed streams (entity popularity is exactly such a
    stream). O(k) eviction keeps the implementation dependency-free;
    k is small (default 64 per coordinate).
    """

    def __init__(self, k: int = 64):
        if k < 1:
            raise ValueError(f"sketch capacity must be >= 1, got {k}")
        self.k = int(k)
        self._sketch_lock = threading.Lock()
        self._sk_counts: dict[str, int] = {}
        self._sk_errors: dict[str, int] = {}
        self._observed = 0

    def observe(self, key, weight: int = 1) -> None:
        key = str(key)
        with self._sketch_lock:
            self._observed += weight
            if key in self._sk_counts:
                self._sk_counts[key] += weight
                return
            if len(self._sk_counts) < self.k:
                self._sk_counts[key] = weight
                self._sk_errors[key] = 0
                return
            victim = min(self._sk_counts, key=self._sk_counts.get)
            floor = self._sk_counts.pop(victim)
            self._sk_errors.pop(victim)
            self._sk_counts[key] = floor + weight
            self._sk_errors[key] = floor

    def top(self, n: int | None = None) -> list[dict]:
        with self._sketch_lock:
            items = sorted(
                self._sk_counts.items(), key=lambda kv: -kv[1]
            )[: self.k if n is None else n]
            return [
                {
                    "key": key,
                    "count": count,
                    "error": self._sk_errors[key],
                }
                for key, count in items
            ]

    def observed(self) -> int:
        with self._sketch_lock:
            return self._observed


# --------------------------------------------------------------------------
# declared SLOs + multi-window burn rates
# --------------------------------------------------------------------------


class SloPolicy:
    """Declared serving SLOs.

    ``p99_ms``: the latency objective — 99% of served requests must
    finish under this many milliseconds (error budget: 1%).
    ``error_rate``: the fraction of requests allowed to fail.
    ``cold_entity_rate``: the fraction of entity lookups allowed to
    miss every vocabulary (sustained cold traffic above this means the
    serving model is stale or the vocabulary is mis-sized).
    ``short_window_s``/``long_window_s``: the two burn-rate windows.
    """

    __slots__ = (
        "p99_ms", "error_rate", "cold_entity_rate",
        "short_window_s", "long_window_s",
    )

    def __init__(
        self,
        *,
        p99_ms: float = 250.0,
        error_rate: float = 0.001,
        cold_entity_rate: float = 0.2,
        short_window_s: float = 5.0,
        long_window_s: float = 60.0,
    ):
        if p99_ms <= 0 or not (0 < error_rate < 1) or not (
            0 < cold_entity_rate <= 1
        ):
            raise ValueError("bad SLO policy")
        if not (0 < short_window_s <= long_window_s):
            raise ValueError(
                f"short window {short_window_s}s must be <= long "
                f"window {long_window_s}s"
            )
        self.p99_ms = float(p99_ms)
        self.error_rate = float(error_rate)
        self.cold_entity_rate = float(cold_entity_rate)
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


_SLO_NAMES = ("p99_ms", "error_rate", "cold_entity_rate")


class SloTracker:
    """Good/bad counts per SLO in a rotating ring; burn = observed bad
    fraction over the declared budget, computed over the short and the
    long window. Burn 0 means no budget spent at all; burn 1 means
    spending exactly at budget; sustained burn > 1 on both windows is
    the page condition.
    """

    # The short window reads this many ring granules (the current,
    # partially-filled one plus the previous full one). With granules
    # of short_window_s/2, the short burn always covers between
    # short/2 and short seconds of history — a burst can never vanish
    # from the short window at the instant a granule rotates, which a
    # current-granule-only read would allow.
    _SHORT_GRANULES = 2

    def __init__(self, policy: SloPolicy | None = None, *,
                 clock=time.monotonic):
        self.policy = policy or SloPolicy()
        self._clock = clock
        self._granule_s = (
            self.policy.short_window_s / self._SHORT_GRANULES
        )
        self._num_granules = max(
            self._SHORT_GRANULES,
            math.ceil(self.policy.long_window_s / self._granule_s),
        )
        self._slo_lock = threading.Lock()
        # ring[granule][slo] = [bad, total]
        self._rings = [
            {name: [0, 0] for name in _SLO_NAMES}
            for _ in range(self._num_granules)
        ]
        self._ring_cursor = 0
        self._ring_start = self._clock()

    # budgets: the latency SLO is "99% under p99_ms" (budget 1%); the
    # other two ARE their budgets.
    def _budget(self, name: str) -> float:
        if name == "p99_ms":
            return 0.01
        return getattr(self.policy, name)

    def _rotate_locked(self, now: float) -> None:
        # The caller holds _slo_lock.
        stale = int((now - self._ring_start) // self._granule_s)
        if stale <= 0:
            return
        for _ in range(min(stale, self._num_granules)):
            self._ring_cursor = (self._ring_cursor + 1) % self._num_granules
            self._rings[self._ring_cursor] = {
                name: [0, 0] for name in _SLO_NAMES
            }
        self._ring_start += stale * self._granule_s

    def _observe_locked(self, name: str, bad: int, total: int) -> None:
        cell = self._rings[self._ring_cursor][name]
        cell[0] += bad
        cell[1] += total

    def observe_request(
        self, latency_s: float | None, *, error: bool = False
    ) -> None:
        """One finished request: served requests carry their latency
        (the latency SLO judges it against ``p99_ms``); failed ones —
        dispatch errors, expired deadlines, shed/breaker/shutdown
        rejections — carry ``error=True`` and no latency."""
        with self._slo_lock:
            self._rotate_locked(self._clock())
            self._observe_locked("error_rate", int(error), 1)
            if latency_s is not None:
                over = latency_s * 1e3 > self.policy.p99_ms
                self._observe_locked("p99_ms", int(over), 1)

    def observe_errors(self, n: int = 1) -> None:
        """``n`` failed requests at once (a breaker drain, a bounded
        close's stranding) — each burns error budget, none carries a
        latency."""
        if n <= 0:
            return
        with self._slo_lock:
            self._rotate_locked(self._clock())
            self._observe_locked("error_rate", n, n)

    def observe_lookups(self, total: int, cold: int) -> None:
        if total <= 0:
            return
        with self._slo_lock:
            self._rotate_locked(self._clock())
            self._observe_locked("cold_entity_rate", cold, total)

    def _window_counts_locked(self, granules: int) -> dict:
        out = {name: [0, 0] for name in _SLO_NAMES}
        for i in range(min(granules, self._num_granules)):
            ring = self._rings[
                (self._ring_cursor - i) % self._num_granules
            ]
            for name in _SLO_NAMES:
                out[name][0] += ring[name][0]
                out[name][1] += ring[name][1]
        return out

    def report(self) -> dict:
        """The burn-rate block ``health()``, ``/metrics`` and
        ``drive``'s summary surface: per SLO — target, budget,
        short/long-window burn, bad/total counts over the long window —
        plus an aggregate ``healthy`` flag (every burn <= 1)."""
        with self._slo_lock:
            self._rotate_locked(self._clock())
            short = self._window_counts_locked(self._SHORT_GRANULES)
            long_ = self._window_counts_locked(self._num_granules)
        out: dict = {"windows_s": {
            "short": self._granule_s * self._SHORT_GRANULES,
            "long": self._granule_s * self._num_granules,
        }}
        healthy = True
        for name in _SLO_NAMES:
            budget = self._budget(name)

            def burn(cell):
                bad, total = cell
                return round(
                    (bad / total) / budget, 4
                ) if total else 0.0

            b_short, b_long = burn(short[name]), burn(long_[name])
            healthy = healthy and b_short <= 1.0 and b_long <= 1.0
            out[name] = {
                "target": getattr(self.policy, name),
                "budget": budget,
                "burn_short": b_short,
                "burn_long": b_long,
                "bad": long_[name][0],
                "total": long_[name][1],
            }
        out["healthy"] = healthy
        return out

    def prometheus_families(self) -> list[dict]:
        rep = self.report()
        burns, bads, totals = [], [], []
        for name in _SLO_NAMES:
            for window in ("short", "long"):
                burns.append((
                    "",
                    {"slo": name, "window": window},
                    rep[name][f"burn_{window}"],
                ))
            bads.append(("", {"slo": name}, float(rep[name]["bad"])))
            totals.append(
                ("", {"slo": name}, float(rep[name]["total"]))
            )
        return [
            family(
                "slo_burn_rate", "gauge",
                "observed bad fraction over the declared budget, per "
                "SLO and burn window (sustained > 1 on both windows "
                "means the budget is burning)",
                burns,
            ),
            family(
                "slo_bad_events", "gauge",
                "SLO-violating events over the long window", bads,
            ),
            family(
                "slo_events", "gauge",
                "SLO-judged events over the long window", totals,
            ),
        ]


# --------------------------------------------------------------------------
# the HTTP exporter
# --------------------------------------------------------------------------

_START_TIME = time.monotonic()


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "photon-monitor/1"
    protocol_version = "HTTP/1.1"

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        mon: "MonitorServer" = self.server.monitor  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = mon.render().encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                code = 200
            elif path == "/healthz":
                body, ctype, code = b"ok\n", "text/plain", 200
            elif path == "/readyz":
                ready, detail = mon.readiness_probe()
                body = (
                    json.dumps(
                        {"ready": bool(ready), **detail}
                    ).encode("utf-8") + b"\n"
                )
                ctype = "application/json"
                code = 200 if ready else 503
            else:
                body, ctype, code = b"not found\n", "text/plain", 404
        except Exception as exc:  # noqa: BLE001 — a scrape must never
            # take the server thread down; the error is the response.
            mon.count_scrape(path, error=True)
            body = f"scrape failed: {exc!r}\n".encode("utf-8")
            ctype, code = "text/plain", 500
        else:
            mon.count_scrape(path, error=False)
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-response; nothing to save

    def log_message(self, *args):  # noqa: D102 — quiet by design
        pass


class MonitorServer:
    """``/metrics`` + ``/healthz`` + ``/readyz`` on a daemon thread.

    ``collectors`` are zero-arg callables returning metric-family lists
    (``family(...)`` dicts) — the serve CLI registers the queue-health
    and SLO collectors; the metrics registry is always included.
    ``readiness`` is a zero-arg callable returning ``(ready, detail)``;
    ``None`` means ready-when-alive. ``port=0`` binds an ephemeral port
    (tests, ``chip_smoke.py``); ``.port`` reports the bound one.

    Rendering takes a consistent snapshot of each surface (the registry
    under its one lock, each collector under its own) and assembles the
    text with NO lock held — a slow scraper can never stall the serve
    worker.
    """

    def __init__(
        self,
        port: int = 0,
        *,
        host: str = "127.0.0.1",
        readiness=None,
        collectors=(),
    ):
        self.host = host
        self._requested_port = int(port)
        self._readiness = readiness
        self._collectors = list(collectors)
        self._server_lock = threading.Lock()
        self._scrapes: dict[str, int] = {}
        self._scrape_errors = 0
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "MonitorServer":
        if self._httpd is not None:
            return self
        httpd = http.server.ThreadingHTTPServer(
            (self.host, self._requested_port), _Handler
        )
        httpd.daemon_threads = True
        httpd.monitor = self  # type: ignore[attr-defined]
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever,
            name="photon-monitor",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MonitorServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("monitor server is not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- handler-facing surface ------------------------------------------

    def add_collector(self, collector) -> None:
        self._collectors.append(collector)

    def count_scrape(self, path: str, *, error: bool) -> None:
        with self._server_lock:
            self._scrapes[path] = self._scrapes.get(path, 0) + 1
            if error:
                self._scrape_errors += 1

    def scrape_stats(self) -> dict:
        with self._server_lock:
            return {
                "scrapes": dict(self._scrapes),
                "scrape_errors": self._scrape_errors,
            }

    def readiness_probe(self) -> tuple[bool, dict]:
        if self._readiness is None:
            return True, {}
        out = self._readiness()
        if isinstance(out, tuple):
            ready, detail = out
            return bool(ready), dict(detail)
        return bool(out), {}

    def render(self) -> str:
        """One scrape's exposition text. Snapshot-then-render: the
        registry snapshot and every collector hold only their own lock
        while COPYING; rendering and the socket write happen lockless.
        """
        from photon_tpu_torch.obs import REGISTRY

        families = registry_families(REGISTRY.snapshot())
        for collector in self._collectors:
            families.extend(collector())
        # The cost ledger exposes itself on EVERY monitor (train,
        # serve) without per-CLI wiring: empty when disabled,
        # so an unarmed process scrapes exactly what it always did.
        from photon_tpu_torch.obs import ledger

        families.extend(ledger.metrics_families())
        # Same policy for the model/data-health layer (obs/health.py):
        # health_* families on every monitor, empty when disarmed.
        from photon_tpu_torch.obs import health

        families.extend(health.metrics_families())
        stats = self.scrape_stats()
        scrape_samples = [
            ("", {"path": path}, float(n))
            for path, n in sorted(stats["scrapes"].items())
        ] or [("", {"path": "/metrics"}, 0.0)]
        families.append(
            family(
                "monitor_scrapes_total", "counter",
                "scrapes served by this exporter, per endpoint",
                scrape_samples,
            )
        )
        families.append(
            family(
                "monitor_scrape_errors_total", "counter",
                "scrapes that failed to render",
                [("", {}, float(stats["scrape_errors"]))],
            )
        )
        families.append(
            family(
                "process_uptime_seconds", "gauge",
                "seconds since photon_tpu_torch.obs.monitor was imported",
                [("", {}, time.monotonic() - _START_TIME)],
            )
        )
        return render_exposition(families)
