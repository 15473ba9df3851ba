"""Per-program cost ledger: every wall-clock second and device byte,
named (port of ``photon_tpu/obs/ledger.py``).

Every cost belongs to a ``(coordinate, phase, program)`` triple. The
cost model (``analysis/costmodel.py``) counts each kernel's bytes and
operations; the ledger joins that static cost to measured dispatches
and live buffers:

- a **program census**: the programs the instrumented paths register
  (the serve ladder's ``serve/score@<rung>`` graphs; a fused fit's
  ``fused_fit`` and ``materialize`` programs, an unfused fit's
  ``coordinate_descent`` loop, and the Newton bucket shapes and
  segment-sum sites either launched), each with a static cost or a lazy
  cost thunk priced at report time, never on a dispatch path;
- **dispatch rows** keyed by ``(coordinate, phase, program)``: measured
  seconds, dispatch count and host-gap seconds (the idle gap between
  the previous dispatch's completion and this one's start);
- a **device live-buffer account**: per-owner resident bytes (the
  serving tables) and a peak watermark;
- a **compile ledger** keyed by the caller's key (a rung's CUDA graph
  capture is its compile).

``report()`` joins rows to their program's cost: achieved FLOP/s and
bytes/s against the program's own roofline, wasted seconds (measured
minus the bound) and a blocking reason (``dispatch-gap``,
``bandwidth``, ``compute`` or ``measured-only``). ``mark()`` and
``attribution_since`` give a window's rows plus an explicit
``unattributed`` residual.

Off by default, and off means off: every hook is one flag check and
``register_program`` adds nothing. Enabled, it is host bookkeeping
only, never a launch, a copy or a sync; the one wait it brings is the
unfused fit's feed (``algorithm.coordinate_descent.FitLedgerFeed``),
which syncs once at a fit's end on the card to read its CUDA events
(a fused fit's rows read the telemetry span's own sync).
"""

from __future__ import annotations

import threading
import time

from photon_tpu_torch.analysis.costmodel import DEFAULT_CHIP, roofline

# The coordinate slot for costs that belong to no single coordinate
# (the serve ladder, slab materialization, whole-program rows).
NO_COORDINATE = "-"
# The program name of the explicit residual row in attribution windows.
UNATTRIBUTED = "unattributed"

# Threading: rows are written from the serve worker (score dispatches),
# the training thread (evaluation windows) and anywhere a graph is
# captured, and read by exporters on any thread: all state lives under
# the one module lock ``_lock``. Reports and snapshots copy under it and
# price outside it.
_lock = threading.Lock()
_enabled = False
# program key -> {"phase", "cost", "cost_thunk"} — cost is the cached
# {"flops", "hbm_bytes", ...} dict once the thunk has been priced.
_programs: dict[str, dict] = {}
# (coordinate, phase, program) -> {"seconds", "dispatches",
# "host_gap_seconds"}
_rows: dict[tuple, dict] = {}
# cache key -> {"seconds", "count"}
_compiles: dict[str, dict] = {}
_resident: dict[str, float] = {}
_resident_peak = 0.0
_last_end: float | None = None


def enable() -> None:
    """Arm the ledger (host bookkeeping only; the audited ``ledger``
    contract pins that traced programs are byte-identical either way)."""
    global _enabled
    with _lock:
        _enabled = True


def disable() -> None:
    global _enabled
    with _lock:
        _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop every accumulator (census, rows, compiles, resident
    account, watermark). Does not touch the enabled flag — the same
    contract as ``obs.reset``."""
    global _resident_peak, _last_end
    with _lock:
        _programs.clear()
        _rows.clear()
        _compiles.clear()
        _resident.clear()
        _resident_peak = 0.0
        _last_end = None


# --------------------------------------------------------------------------
# recording (the hot-path surface: one flag check when disabled)
# --------------------------------------------------------------------------


def register_program(
    program: str,
    *,
    phase: str,
    cost: dict | None = None,
    cost_thunk=None,
) -> None:
    """Add one compiled program to the census (no-op when disabled —
    a ledger-off run adds ZERO programs).

    ``cost`` is a ready ``{"flops", "hbm_bytes"}`` dict (a
    ``costmodel`` count); ``cost_thunk`` is a zero-arg callable
    producing one, called lazily at REPORT time so no dispatch path
    pays for the count. Re-registration refreshes the thunk (a new
    ladder generation re-keys the same program name) but keeps an
    already-priced cost unless a fresh one is given.
    """
    if not _enabled:
        return
    with _lock:
        entry = _programs.get(program)
        if entry is None:
            entry = _programs[program] = {
                "phase": phase, "cost": None, "cost_thunk": None,
            }
        entry["phase"] = phase
        if cost is not None:
            entry["cost"] = dict(cost)
        if cost_thunk is not None:
            entry["cost_thunk"] = cost_thunk


def _row_locked(key: tuple) -> dict:
    """Get-or-create one accumulator row; caller holds ``_lock`` (the
    ``_locked`` suffix is the calling convention)."""
    row = _rows.get(key)
    if row is None:
        row = _rows[key] = {
            "seconds": 0.0, "dispatches": 0, "host_gap_seconds": 0.0,
        }
    return row


def record_dispatch(
    program: str,
    seconds: float,
    *,
    phase: str,
    coordinate: str = NO_COORDINATE,
    start: float | None = None,
    end: float | None = None,
    parts: dict[str, float] | None = None,
) -> None:
    """Account one measured dispatch of ``program`` (no-op when
    disabled).

    ``start``/``end`` are ``time.perf_counter`` stamps of the dispatch
    window; when given, the idle gap since the PREVIOUS recorded
    dispatch's completion is charged to this program's
    ``host_gap_seconds`` — the between-dispatch host time the roofline
    gap says we are paying. ``parts`` distributes the measured seconds
    over coordinates (the fused fit's per-coordinate attribution);
    without it the whole window lands on ``coordinate``.

    Also drops one counter sample on the trace timeline
    (``ledger/<program>_seconds``, obs/trace.py) when telemetry is
    recording, so per-dispatch cost rides the exported Perfetto view as
    its own counter track.
    """
    if not _enabled:
        return
    global _last_end
    seconds = float(seconds)
    with _lock:
        if start is not None:
            if _last_end is not None and start > _last_end:
                _row_locked(
                    (coordinate if parts is None else NO_COORDINATE,
                     phase, program)
                )["host_gap_seconds"] += start - _last_end
            if end is not None:
                _last_end = end if _last_end is None else max(
                    _last_end, end)
        if parts:
            for cid, share in parts.items():
                row = _row_locked((str(cid), phase, program))
                row["seconds"] += float(share)
                row["dispatches"] += 1
        else:
            row = _row_locked((coordinate, phase, program))
            row["seconds"] += seconds
            row["dispatches"] += 1
    # Outside the ledger lock (the trace ring takes its own): one
    # counter sample per dispatch, only while telemetry records.
    try:
        from photon_tpu_torch.obs import trace as obs_trace

        obs_trace.counter(
            f"ledger/{program}_seconds", seconds, ts=end,
        )
    except Exception:  # pragma: no cover — telemetry must never abort
        pass


def record_unattributed(
    seconds: float, *, phase: str = "host"
) -> None:
    """Account window time with no program on it (operand assembly,
    AOT-compile waits) as the EXPLICIT residual row — the ledger never
    silently drops wall clock it saw."""
    if not _enabled:
        return
    with _lock:
        row = _row_locked((NO_COORDINATE, phase, UNATTRIBUTED))
        row["seconds"] += float(seconds)
        row["dispatches"] += 1


def record_compile(key: str, seconds: float) -> None:
    """Account one compile under its cache key (no-op when disabled)."""
    if not _enabled:
        return
    with _lock:
        c = _compiles.get(key)
        if c is None:
            c = _compiles[key] = {"seconds": 0.0, "count": 0}
        c["seconds"] += float(seconds)
        c["count"] += 1


def set_resident(owner: str, nbytes: float) -> None:
    """Set one owner's live device bytes (a table, a slab set); the peak
    watermark tracks the max TOTAL ever observed across owners —
    including the transient double-residency of an off-path rebuild."""
    if not _enabled:
        return
    global _resident_peak
    with _lock:
        _resident[owner] = float(nbytes)
        total = sum(_resident.values())
        if total > _resident_peak:
            _resident_peak = total


def resident_total() -> float:
    with _lock:
        return sum(_resident.values())


# --------------------------------------------------------------------------
# snapshots, windows, and the priced report
# --------------------------------------------------------------------------


def snapshot() -> dict:
    """JSON-ready view of the raw accumulators (no pricing: cost
    thunks are NOT evaluated here — ``report()`` does that)."""
    with _lock:
        return {
            "enabled": _enabled,
            "programs": {
                k: {"phase": v["phase"], "cost": v["cost"]}
                for k, v in _programs.items()
            },
            "rows": [
                {
                    "coordinate": c, "phase": ph, "program": pr,
                    "seconds": row["seconds"],
                    "dispatches": row["dispatches"],
                    "host_gap_seconds": row["host_gap_seconds"],
                }
                for (c, ph, pr), row in sorted(_rows.items())
            ],
            "compiles": {k: dict(v) for k, v in sorted(
                _compiles.items())},
            "resident_bytes": dict(sorted(_resident.items())),
            "resident_peak_bytes": _resident_peak,
        }


def mark() -> dict | None:
    """Opaque window marker for ``attribution_since`` (None when the
    ledger is disabled — callers wire it unconditionally)."""
    if not _enabled:
        return None
    with _lock:
        return {
            "rows": {k: dict(v) for k, v in _rows.items()},
        }


def attribution_since(
    marker: dict | None, wall_seconds: float | None = None
) -> dict:
    """The window's costs as named rows + the explicit residual.

    Rows are the per-(coordinate, phase, program) DELTAS since
    ``marker`` (None = since reset). With a measured ``wall_seconds``,
    the ``unattributed`` row is the wall minus every named second (the
    recorded residual rows fold into it — never double-counted), and
    ``attributed_fraction`` is named/wall; without a wall, the recorded
    residual rows alone are the unattributed account.
    """
    base = (marker or {}).get("rows", {})
    with _lock:
        deltas: dict[tuple, dict] = {}
        for key, row in _rows.items():
            prev = base.get(key)
            d = {
                "seconds": row["seconds"]
                - (prev["seconds"] if prev else 0.0),
                "dispatches": row["dispatches"]
                - (prev["dispatches"] if prev else 0),
                "host_gap_seconds": row["host_gap_seconds"]
                - (prev["host_gap_seconds"] if prev else 0.0),
            }
            if d["dispatches"] or d["seconds"] or d["host_gap_seconds"]:
                deltas[key] = d
    named: list[dict] = []
    recorded_residual = 0.0
    for (c, ph, pr), d in sorted(deltas.items()):
        if pr == UNATTRIBUTED:
            recorded_residual += d["seconds"]
            continue
        named.append({
            "coordinate": c, "phase": ph, "program": pr,
            "seconds": round(d["seconds"], 6),
            "dispatches": d["dispatches"],
            "host_gap_seconds": round(d["host_gap_seconds"], 6),
        })
    named.sort(key=lambda r: -r["seconds"])
    attributed = sum(r["seconds"] for r in named)
    if wall_seconds is not None:
        unattributed = max(float(wall_seconds) - attributed, 0.0)
        fraction = (
            attributed / float(wall_seconds) if wall_seconds else None
        )
    else:
        unattributed = recorded_residual
        total = attributed + unattributed
        fraction = (attributed / total) if total > 0.0 else None
    rows = named + [{
        "coordinate": NO_COORDINATE, "phase": "host",
        "program": UNATTRIBUTED,
        "seconds": round(unattributed, 6),
        "dispatches": 0, "host_gap_seconds": 0.0,
    }]
    return {
        "rows": rows,
        "attributed_seconds": round(attributed, 6),
        "unattributed_seconds": round(unattributed, 6),
        "attributed_fraction": (
            None if fraction is None else round(min(fraction, 1.0), 4)
        ),
    }


def _priced_cost(program: str) -> dict | None:
    """The program's static cost, pricing (and caching) the lazy thunk
    on first use. A failing thunk degrades to measured-only; the
    error is cached so a broken count is tried once, not per report
    row."""
    with _lock:
        entry = _programs.get(program)
        if entry is None:
            return None
        cost = entry["cost"]
        thunk = entry["cost_thunk"]
    if cost is not None or thunk is None:
        return cost
    try:
        cost = dict(thunk())
    except Exception as exc:  # noqa: BLE001 — degrade, never abort
        cost = {"error": repr(exc)}
    with _lock:
        entry = _programs.get(program)
        if entry is not None and entry["cost"] is None:
            entry["cost"] = cost
            entry["cost_thunk"] = None
    return cost


def _blocking_reason(row: dict, roof: dict | None) -> str:
    """Why this row's measured seconds exceed its lower bound:
    host idle between dispatches, the card's memory or its FLOPs, or
    measured-only when the program has no static cost to bound it."""
    if row["host_gap_seconds"] >= row["seconds"] > 0.0:
        return "dispatch-gap"
    if roof is None or not roof.get("min_seconds"):
        return "measured-only"
    return "bandwidth" if roof["bound"] == "hbm" else "compute"


def report(chip: str = DEFAULT_CHIP) -> dict:
    """The priced ledger: every row joined to its program's static
    cost and roofline.

    Per row (only where both sides exist — zero-FLOP / cost-less
    programs keep their measured columns and a ``measured-only``
    blocking reason, never a division): achieved FLOP/s and bytes/s
    over the measured window, ``vs_roofline`` (measured seconds per
    dispatch over the program's own roofline lower bound), wasted
    seconds (measured minus bound x dispatches), and the blocking
    reason. Cost thunks are priced here, outside every lock a dispatch
    path takes.
    """
    snap = snapshot()
    # A parts-split program (the JAX package's fused fit) spreads ONE program's
    # dispatches over several coordinate rows: each row carries only
    # its share of the program's static cost, or FLOPs would double-
    # count across rows and every per-coordinate vs_roofline /
    # wasted_seconds would compare a slice of the wall against the
    # WHOLE program's bound. The share is the row's fraction of the
    # program's total recorded seconds; shares sum to the program's
    # cost/waste by construction.
    prog_seconds: dict[str, float] = {}
    for row in snap["rows"]:
        if row["program"] != UNATTRIBUTED:
            prog_seconds[row["program"]] = (
                prog_seconds.get(row["program"], 0.0) + row["seconds"]
            )
    rows = []
    for row in snap["rows"]:
        out = dict(row)
        cost = _priced_cost(row["program"])
        roof = None
        if cost and not cost.get("error") and (
            cost.get("flops") or cost.get("hbm_bytes")
        ):
            roof = roofline(cost, chip)
        seconds = row["seconds"]
        n = row["dispatches"]
        if roof is not None and seconds > 0.0 and n > 0:
            total = prog_seconds.get(row["program"], 0.0)
            share = (seconds / total) if total > 0.0 else 1.0
            min_seconds = roof["min_seconds"] * share
            bound = min_seconds * n
            out["achieved_flops_per_sec"] = (
                cost.get("flops", 0.0) * share * n / seconds
            )
            out["achieved_hbm_bytes_per_sec"] = (
                cost.get("hbm_bytes", 0.0) * share * n / seconds
            )
            out["vs_roofline"] = (
                round((seconds / n) / min_seconds, 2)
                if min_seconds > 0.0 else None
            )
            out["wasted_seconds"] = round(max(seconds - bound, 0.0), 6)
            out["roofline_bound"] = roof["bound"]
        else:
            # Measured-only degradation: no static cost (or a pure-
            # transfer zero-cost program) — the measured columns stand
            # alone and every derived ratio is None, by contract.
            out["achieved_flops_per_sec"] = None
            out["achieved_hbm_bytes_per_sec"] = None
            out["vs_roofline"] = None
            out["wasted_seconds"] = round(seconds, 6)
            out["roofline_bound"] = None
        out["blocking"] = _blocking_reason(row, roof)
        if cost and cost.get("error"):
            out["cost_error"] = cost["error"]
        rows.append(out)
    rows.sort(key=lambda r: -(r["wasted_seconds"] or 0.0))
    return {
        "chip": chip,
        "enabled": snap["enabled"],
        "rows": rows,
        "programs": snap["programs"],
        "compiles": snap["compiles"],
        "resident_bytes": snap["resident_bytes"],
        "resident_peak_bytes": snap["resident_peak_bytes"],
    }


def top_k(k: int = 5, chip: str = DEFAULT_CHIP) -> list[dict]:
    """The k worst rows by wasted-seconds-vs-roofline (the profile
    CLI's table), residual rows excluded — they have no program to
    blame by construction."""
    rows = [
        r for r in report(chip)["rows"] if r["program"] != UNATTRIBUTED
    ]
    return rows[: max(int(k), 0)]


def render_top_k(k: int = 5, chip: str = DEFAULT_CHIP) -> str:
    """Human-readable top-k table (one line per row)."""
    rows = top_k(k, chip)
    if not rows:
        return "ledger: no dispatches recorded"
    head = [
        "coordinate", "phase", "program", "seconds", "disp",
        "gap_s", "wasted_s", "vs_roof", "blocking",
    ]
    table = [head]
    for r in rows:
        table.append([
            r["coordinate"], r["phase"], r["program"],
            f"{r['seconds']:.4f}", str(r["dispatches"]),
            f"{r['host_gap_seconds']:.4f}",
            f"{r['wasted_seconds']:.4f}",
            "-" if r["vs_roofline"] is None else f"{r['vs_roofline']:g}",
            r["blocking"],
        ])
    widths = [max(len(row[i]) for row in table) for i in range(len(head))]
    return "\n".join(
        "  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
        for row in table
    )


# --------------------------------------------------------------------------
# the /metrics collector (obs/monitor.py appends it on every scrape)
# --------------------------------------------------------------------------


def metrics_families() -> list[dict]:
    """``ledger_*`` metric families for the monitor exporter — empty
    when the ledger is disabled, so an unarmed process scrapes exactly
    what it scraped before this module existed."""
    snap = snapshot()
    if not snap["enabled"]:
        return []
    from photon_tpu_torch.obs.monitor import family

    fams = []
    row_labels = [
        (
            {
                "coordinate": r["coordinate"],
                "phase": r["phase"],
                "program": r["program"],
            },
            r,
        )
        for r in snap["rows"]
    ]
    if row_labels:
        fams.append(family(
            "ledger_dispatch_seconds_total", "counter",
            "measured wall seconds per (coordinate, phase, program) "
            "ledger row",
            [("", labels, row["seconds"]) for labels, row in row_labels],
        ))
        fams.append(family(
            "ledger_dispatches_total", "counter",
            "dispatches per ledger row",
            [("", labels, float(row["dispatches"]))
             for labels, row in row_labels],
        ))
        fams.append(family(
            "ledger_host_gap_seconds_total", "counter",
            "host idle seconds between consecutive dispatches, charged "
            "to the program that dispatched next",
            [("", labels, row["host_gap_seconds"])
             for labels, row in row_labels],
        ))
    fams.append(family(
        "ledger_programs_registered", "gauge",
        "compiled programs in the ledger census (0 when the ledger "
        "is off: a disabled run registers nothing)",
        [("", {}, float(len(snap["programs"])))],
    ))
    if snap["compiles"]:
        fams.append(family(
            "ledger_compile_seconds_total", "counter",
            "compile seconds per key (a rung's CUDA graph capture is "
            "its compile)",
            [("", {"key": k}, v["seconds"])
             for k, v in snap["compiles"].items()],
        ))
    if snap["resident_bytes"]:
        fams.append(family(
            "ledger_resident_bytes", "gauge",
            "live device bytes per owner (the serving tables)",
            [("", {"owner": k}, v)
             for k, v in snap["resident_bytes"].items()],
        ))
    fams.append(family(
        "ledger_resident_peak_bytes", "gauge",
        "peak watermark of total accounted resident bytes",
        [("", {}, snap["resident_peak_bytes"])],
    ))
    return fams


def tree_nbytes(tree) -> int:
    """Total bytes of the tensors and arrays in a nest of tuples, lists
    and dicts (metadata only: never reads device data). The resident
    account's helper."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    numel = getattr(tree, "numel", None)
    if callable(numel) and hasattr(tree, "element_size"):
        return int(numel()) * int(tree.element_size())
    nbytes = getattr(tree, "nbytes", None)
    return int(nbytes) if nbytes is not None else 0
