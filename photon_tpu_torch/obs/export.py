"""Telemetry exporters: snapshot dict, JSONL stream, text summary
(port of ``photon_tpu/obs/export.py``).

Three views over the same state (span tracer, metrics registry,
convergence traces, and the reports they absorb):

- ``snapshot()``: one JSON-ready dict (what ``cli.train --telemetry``
  folds into ``training-summary.json``);
- ``write_jsonl(path)``: the line-per-record stream, under the JAX
  package's schema (OBSERVABILITY.md), checked by ``validate_jsonl``;
- ``summary_table()``: the end-of-run text table.

JSONL SCHEMA (version 1): one JSON object per line, discriminated by
``type``:

  {"type": "telemetry", "version": 1, "spans_dropped": 0,
   "host": {...}}  # header, first record; host = obs.fleet identity
  {"type": "span", "path", "name", "thread", "seconds",
   "device_wait_seconds": float|null, "attrs": {}}
  {"type": "counter", "series", "value"}
  {"type": "gauge", "series", "value"}
  {"type": "histogram", "series", "count", "sum", "min", "max"}
  {"type": "series", "name": "convergence", "fit", "coordinate",
   "metric", "values": [float, ...]}
  {"type": "report", "name": "pipeline"|"compile_cache"|"ledger",
   "data": {}}
  {"type": "request", "id", "outcome", "submit_ts", "done_ts",
   ...segment timestamps for served requests}   # obs/trace.py

The port has no XLA compile cache: its ``compile_cache`` report is
``utils.compile_cache.cache_stats()`` (the JAX package's key names:
``aot_compiles`` and ``aot_compile_seconds`` count the ahead-of-time
captures, the serving ladders' rungs and the fused fit's warm capture,
``aot_failures`` the failed ones; ``persistent_hits`` /
``persistent_misses`` the kernel library loaded or built), plus the
library itself (``kernel_library``, ``kernel_build_seconds``). With the health layer armed, the snapshot
carries a ``health`` section and the stream a ``health`` report
(``obs.health.snapshot()``: by export time every fit completed, so
copying a parked sentinel to the host there is a plain copy).
"""

from __future__ import annotations

import json


def _absorbed_reports() -> tuple[dict, dict]:
    """The two scalar surfaces the telemetry layer absorbs: the ingest
    pipeline's per-stage report and the compile report
    (``compile_report``).

    Returns ``(reports, errors)``: a surface that fails to import or
    render lands as None in ``reports`` WITH its error recorded in
    ``errors`` — the exporters surface the degradation visibly (a
    ``report`` record noting it, a ``degraded_reports`` snapshot key)
    instead of silently dropping the section."""
    out: dict = {}
    errors: dict = {}
    try:
        from photon_tpu_torch.data.pipeline import PIPELINE_STATS

        out["pipeline"] = PIPELINE_STATS.report()
    except Exception as exc:  # noqa: BLE001 — import cycles in odd embeds
        out["pipeline"] = None
        errors["pipeline"] = repr(exc)
    try:
        out["compile_cache"] = compile_report()
    except Exception as exc:  # noqa: BLE001
        out["compile_cache"] = None
        errors["compile_cache"] = repr(exc)
    return out, errors



def compile_report() -> dict:
    """The compile-cache report: ``compile_cache.cache_stats()`` and the
    CUDA kernel library, read without building or loading anything."""
    from photon_tpu_torch.ops import _build
    from photon_tpu_torch.utils import compile_cache

    lib = _build.loaded_library()
    return {
        **compile_cache.cache_stats(),
        "kernel_library": lib,
        "kernel_build_seconds": (
            None if _build.build_seconds is None
            else round(_build.build_seconds, 4)),
    }


def snapshot() -> dict:
    """Everything the telemetry layer knows, as one JSON-ready dict —
    merged with the absorbed pipeline/compile-cache reports so one
    snapshot answers the whole "where did the time go" question."""
    from photon_tpu_torch.obs import REGISTRY, convergence, enabled

    from photon_tpu_torch.obs import TRACER

    from photon_tpu_torch.obs import fleet

    out = {
        "enabled": enabled(),
        "host": fleet.host_identity(),
        "spans": _spans_aggregated(),
        "spans_dropped": TRACER.dropped,
        "metrics": REGISTRY.snapshot(),
        "convergence": convergence.snapshot(),
    }
    reports, errors = _absorbed_reports()
    out.update(reports)
    if errors:
        out["degraded_reports"] = errors
    from photon_tpu_torch.obs import ledger

    if ledger.enabled():
        out["ledger"] = ledger.snapshot()
    from photon_tpu_torch.obs import health

    if health.enabled():
        out["health"] = health.snapshot()
    return out


def _spans_aggregated() -> dict:
    from photon_tpu_torch.obs import TRACER
    from photon_tpu_torch.obs.spans import aggregate

    return aggregate(TRACER.completed())


def write_jsonl(path: str) -> int:
    """Write the full telemetry stream; returns the line count."""
    from photon_tpu_torch.obs import TRACER, REGISTRY, convergence, fleet

    lines: list[dict] = [{
        "type": "telemetry",
        "version": 1,
        "spans_dropped": TRACER.dropped,
        "host": fleet.host_identity(),
    }]
    for sp in TRACER.completed():
        lines.append(sp.to_json())
    m = REGISTRY.snapshot()
    for series, value in sorted(m["counters"].items()):
        lines.append({"type": "counter", "series": series, "value": value})
    for series, value in sorted(m["gauges"].items()):
        lines.append({"type": "gauge", "series": series, "value": value})
    for series, h in sorted(m["histograms"].items()):
        lines.append({"type": "histogram", "series": series, **h})
    for fit_i, series in enumerate(convergence.traces()):
        for cid, by_metric in series.items():
            for metric, values in by_metric.items():
                lines.append({
                    "type": "series",
                    "name": "convergence",
                    "fit": fit_i,
                    "coordinate": cid,
                    "metric": metric,
                    "values": values,
                })
    reports, errors = _absorbed_reports()
    for name, data in reports.items():
        if data is None:
            # A degraded surface is still a VISIBLE record: the
            # consumer sees "this export is missing its pipeline /
            # compile-cache section and why", not a silent hole.
            lines.append({
                "type": "report", "name": name,
                "data": {"degraded": True, "error": errors.get(name)},
            })
        else:
            lines.append({"type": "report", "name": name, "data": data})
    from photon_tpu_torch.obs import ledger

    if ledger.enabled():
        lines.append({
            "type": "report", "name": "ledger",
            "data": ledger.snapshot(),
        })
    from photon_tpu_torch.obs import health

    if health.enabled():
        lines.append({
            "type": "report", "name": "health",
            "data": health.snapshot(),
        })
    with open(path, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return len(lines)


_REQUIRED_KEYS = {
    "telemetry": ("version",),
    "span": ("path", "name", "thread", "seconds", "device_wait_seconds"),
    "counter": ("series", "value"),
    "gauge": ("series", "value"),
    "histogram": ("series", "count", "sum", "min", "max"),
    "series": ("name", "fit", "coordinate", "metric", "values"),
    "report": ("name", "data"),
    # Serving request records (obs/trace.py write_request_jsonl):
    # outcome must come from trace.REQUEST_OUTCOMES, checked below.
    "request": ("id", "outcome", "submit_ts", "done_ts"),
}


def validate_jsonl(path: str) -> int:
    """Validate a telemetry JSONL file against the documented schema.

    Raises ValueError on the first violation; returns the number of
    validated lines.
    """
    n = 0
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw)
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path}:{lineno}: not JSON ({exc})")
            if not isinstance(rec, dict) or "type" not in rec:
                raise ValueError(
                    f"{path}:{lineno}: record without a 'type' field"
                )
            rtype = rec["type"]
            if rtype not in _REQUIRED_KEYS:
                raise ValueError(
                    f"{path}:{lineno}: unknown record type {rtype!r}"
                )
            # The FIRST RECORD (not merely the first line — blank lines
            # skip) must be the version header.
            if n == 0 and rtype != "telemetry":
                raise ValueError(
                    f"{path}: first record must be the telemetry header"
                )
            missing = [
                k for k in _REQUIRED_KEYS[rtype] if k not in rec
            ]
            if missing:
                raise ValueError(
                    f"{path}:{lineno}: {rtype} record missing "
                    f"{', '.join(missing)}"
                )
            if rtype == "span" and rec["seconds"] < 0:
                raise ValueError(
                    f"{path}:{lineno}: negative span seconds"
                )
            if rtype == "series" and not isinstance(rec["values"], list):
                raise ValueError(
                    f"{path}:{lineno}: series values must be a list"
                )
            if rtype == "request":
                from photon_tpu_torch.obs.trace import REQUEST_OUTCOMES

                if rec["outcome"] not in REQUEST_OUTCOMES:
                    raise ValueError(
                        f"{path}:{lineno}: unknown request outcome "
                        f"{rec['outcome']!r} (known: "
                        f"{', '.join(REQUEST_OUTCOMES)})"
                    )
                if rec["done_ts"] < rec["submit_ts"]:
                    raise ValueError(
                        f"{path}:{lineno}: request done_ts precedes "
                        "submit_ts"
                    )
            n += 1
    if n == 0:
        raise ValueError(f"{path}: empty telemetry file")
    return n


def summary_table() -> str:
    """End-of-run text summary: the span tree + headline metrics."""
    snap = snapshot()
    rows = ["== telemetry summary ==", "-- spans (path, count, s, device-wait s) --"]
    for path, agg in snap["spans"].items():
        depth = path.count("/")
        dw = agg["device_wait_seconds"]
        rows.append(
            f"  {'  ' * depth}{path.rsplit('/', 1)[-1]:<28} "
            f"x{agg['count']:<4} {agg['seconds']:>10.4f} "
            f"{'-' if dw is None else f'{dw:.4f}':>10}"
        )
    m = snap["metrics"]
    if m["counters"]:
        rows.append("-- counters --")
        rows.extend(
            f"  {k} = {v:g}" for k, v in sorted(m["counters"].items())
        )
    if m["gauges"]:
        rows.append("-- gauges --")
        rows.extend(
            f"  {k} = {v:g}" for k, v in sorted(m["gauges"].items())
        )
    if m["histograms"]:
        rows.append("-- histograms (count/sum/min/max) --")
        rows.extend(
            f"  {k}: n={h['count']} sum={h['sum']:.4f} "
            f"min={h['min']:.4f} max={h['max']:.4f}"
            for k, h in sorted(m["histograms"].items())
        )
    conv = snap["convergence"]
    if conv["fits_recorded"]:
        rows.append(
            f"-- convergence: {conv['fits_recorded']} fit(s) recorded; "
            f"metrics {', '.join(conv['metrics'])} --"
        )
    return "\n".join(rows)
