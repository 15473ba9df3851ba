"""Distributed observability (port of ``photon_tpu/obs/fleet.py``):
host identity, clock-aligned telemetry bundles, and the fleet merge and
straggler report behind ``cli.fleetview``.

**Host identity.** ``host_identity()`` is stamped into the snapshot,
the JSONL header, the flight dump and the Chrome trace's ``otherData``,
so no artifact is anonymous. The process index and count come from the
environment (``RANK`` and ``WORLD_SIZE``, as ``torch.distributed``
launchers set them; 0 and 1 on one card). The device kind and count
come from ``torch.cuda``, read only once the process has initialized
CUDA, so stamping never creates a CUDA context as a side effect.
``resolve_monitor_port`` offsets a ``--monitor-port`` by the process
index.

**Clock alignment.** Spans and events record on ``perf_counter``
(monotonic, process-local); comparing hosts needs the epoch clock. The
handshake samples the perf-to-epoch offset twice, at
``cli.common.maybe_init_distributed`` (``mark_init``) and again at the
bundle's commit, each as back-to-back (epoch, perf) pairs whose spread
bounds the sampling jitter. ``skew_bound_seconds`` = |offset at commit
- offset at init| + both spreads. The merge shifts each host's events
onto the epoch clock through its own offset.

**Bundles and the merge.** ``ship_bundle(run_dir)`` commits this
rank's obs state (spans JSONL with raw t0/t1, the metrics snapshot, the
trace-event ring, the ledger's rows, the health state) into
``<run_dir>/obs-host-<k>/`` through ``io/model_io.atomic_write_bytes``;
``bundle.json`` (schema 1) is written last and is the commit point.
``merge_chrome_trace`` puts every bundle on one Chrome trace (a pid a
rank; ``trace.validate_chrome_trace`` passes it), and
``straggler_report`` rolls the ledgers up: attributed seconds per rank,
per-program window skew, the slowest rank and the collective wait. A
torn ``spans.jsonl``, an uncommitted bundle or a missing rank is a
named gap in both, never an exception. ``cli.train --distributed``
ships one bundle a rank: a 1-rank fleet from a single process, one
bundle from each rank of a mesh run under a launcher
(``parallel/mesh.py``). ``global_device_count`` counts cards, so ranks
that share a card count it once.

Everything here is host work: no function launches, copies or syncs.

Threading: the cached identity, the run id and the init clock sample are
guarded by ``_lock``; ``ship_bundle`` may run on any thread (it reads
the other modules' snapshots under their own locks and writes files
outside any lock).
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time

BUNDLE_SCHEMA = 1
HOST_DIR_PREFIX = "obs-host-"
BUNDLE_FILE = "bundle.json"
SPANS_FILE = "spans.jsonl"

# Trace events a bundle ships (the newest kept).
_EVENT_LIMIT = 8192

_lock = threading.Lock()
_identity: dict | None = None
_run_id: str | None = None
_init_clock: dict | None = None


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw.isdigit() else default


def _global_cards(local_cards: int, world: int) -> int:
    """The cards a run of ``world`` processes holds: on each host
    (``LOCAL_WORLD_SIZE`` processes, default all of them) as many of its
    ``local_cards`` as it has processes, so ranks that share a card
    count it once."""
    if world <= 1:
        return local_cards
    local_world = max(_env_int("LOCAL_WORLD_SIZE", world), 1)
    return max(world // local_world, 1) * min(local_cards, local_world)


def _probe_identity() -> dict:
    """The provenance block of this process; a CUDA query that fails
    leaves nulls, never a failed snapshot or dump."""
    ident: dict = {
        "process_index": _env_int("RANK", 0),
        "process_count": _env_int("WORLD_SIZE", 1),
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "device_kind": None,
        "local_device_count": None,
        "global_device_count": None,
        "torch_version": None,
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        ident["torch_version"] = getattr(torch, "__version__", None)
        try:
            if torch.cuda.is_initialized():
                n = torch.cuda.device_count()
                ident["local_device_count"] = n
                ident["global_device_count"] = _global_cards(
                    n, ident["process_count"])
                if n:
                    ident["device_kind"] = torch.cuda.get_device_name(
                        torch.cuda.current_device())
        except Exception:  # noqa: BLE001 - a runtime mid-teardown
            pass
    return ident


def host_identity(*, refresh: bool = False) -> dict:
    """The host-identity block (cached; ``refresh=True`` probes again)."""
    global _identity
    with _lock:
        cached = _identity
    if cached is None or refresh or (
            cached["device_kind"] is None and _cuda_up()):
        probed = _probe_identity()
        with _lock:
            _identity = cached = probed
    out = dict(cached)
    out["run_id"] = run_id()
    return out


def resolve_monitor_port(port: int, process_index: int | None = None
                         ) -> int:
    """The per-process ``/metrics`` bind port: ``port + process_index``,
    so several processes sharing a host never collide on one
    ``--monitor-port`` value. Port 0 (ephemeral: the OS picks) passes
    through untouched."""
    if port <= 0:
        return port
    k = (host_identity()["process_index"] if process_index is None
         else int(process_index))
    return port + k


def _cuda_up() -> bool:
    torch = sys.modules.get("torch")
    try:
        return torch is not None and torch.cuda.is_initialized()
    except Exception:  # noqa: BLE001
        return False


def set_run_id(value: str | None) -> None:
    """Pin the run id every artifact of this run carries."""
    global _run_id
    with _lock:
        _run_id = value


def run_id() -> str | None:
    """An explicit ``set_run_id`` wins, else ``PHOTON_RUN_ID``, else
    None."""
    with _lock:
        rid = _run_id
    return rid if rid is not None else os.environ.get("PHOTON_RUN_ID")


def reset() -> None:
    """Drop the cached identity, the run id and the init clock sample
    (part of ``obs.reset()``)."""
    global _identity, _run_id, _init_clock
    with _lock:
        _identity = None
        _run_id = None
        _init_clock = None


# --------------------------------------------------------------------------
# clock alignment
# --------------------------------------------------------------------------


def clock_sample(n: int = 5) -> dict:
    """One monotonic↔epoch offset measurement: ``n`` back-to-back
    (epoch, perf_counter) pairs. ``offset`` maps perf_counter seconds
    onto the epoch clock (``epoch ≈ perf + offset``); ``spread`` (the
    max−min of the per-pair offsets) bounds the scheduling jitter of the
    measurement itself."""
    offsets = []
    epoch = perf = 0.0
    for _ in range(max(int(n), 1)):
        perf = time.perf_counter()
        epoch = time.time()
        offsets.append(epoch - perf)
    offsets.sort()
    return {
        "offset": offsets[len(offsets) // 2],
        "spread": offsets[-1] - offsets[0],
        "epoch": epoch,
        "perf_counter": perf,
    }


def mark_init() -> dict:
    """The init half of the clock-alignment handshake — called from
    ``cli.common.maybe_init_distributed`` at a CLI's start, and again by
    ``cli.train --distributed`` after its ``obs.reset()``. Also
    refreshes the cached identity."""
    sample = clock_sample()
    global _init_clock
    with _lock:
        _init_clock = sample
    host_identity(refresh=True)
    return sample


def init_clock() -> dict | None:
    with _lock:
        return None if _init_clock is None else dict(_init_clock)


def clock_alignment() -> dict:
    """The commit half of the handshake: a fresh offset sample paired
    with the init-time one. ``skew_bound_seconds`` bounds how far this
    host's perf→epoch mapping may have drifted over the run: the offset
    delta between the two samples plus both sampling spreads. With no
    init sample (single-process run that never called ``mark_init``) the
    commit sample stands alone and the bound is its own spread."""
    commit = clock_sample()
    init = init_clock() or commit
    bound = (
        abs(commit["offset"] - init["offset"])
        + commit["spread"]
        + init["spread"]
    )
    return {
        "init": init,
        "commit": commit,
        "skew_bound_seconds": bound,
    }


# --------------------------------------------------------------------------
# bundle shipping (the per-rank write side)
# --------------------------------------------------------------------------


def host_dir(run_dir: str, process_index: int) -> str:
    return os.path.join(run_dir, f"{HOST_DIR_PREFIX}{process_index}")


def ship_bundle(run_dir: str, *, extra: dict | None = None) -> str:
    """Commit this rank's obs state into ``<run_dir>/obs-host-<k>/``.

    Two files, both via the atomic tmp+fsync+replace discipline:
    ``spans.jsonl`` (telemetry header + one ``span`` record per
    completed span, carrying raw ``t0``/``t1`` perf_counter stamps for
    the timeline merge) and — LAST, as the commit point — ``bundle.json``
    (identity, clock alignment, metrics snapshot, trace-event ring,
    ledger attribution rows, health state). Returns the bundle dir.
    ``extra`` merges caller context into the bundle's ``extra``
    block.
    """
    from photon_tpu_torch import obs
    from photon_tpu_torch.obs import health, ledger
    from photon_tpu_torch.obs import trace as obs_trace
    from photon_tpu_torch.io.model_io import atomic_write_bytes

    ident = host_identity(refresh=True)
    out_dir = host_dir(run_dir, ident["process_index"])
    os.makedirs(out_dir, exist_ok=True)

    lines: list[dict] = [{
        "type": "telemetry",
        "version": 1,
        "spans_dropped": obs.TRACER.dropped,
        "host": ident,
    }]
    for sp in obs.TRACER.completed():
        lines.append(dict(sp.to_json(), t0=sp.t0, t1=sp.t1))
    payload = "".join(json.dumps(line) + "\n" for line in lines)
    atomic_write_bytes(
        os.path.join(out_dir, SPANS_FILE), payload.encode()
    )

    bundle: dict = {
        "schema": BUNDLE_SCHEMA,
        "host": ident,
        "clock": clock_alignment(),
        "metrics": obs.REGISTRY.snapshot(),
        "events": obs_trace.events()[-_EVENT_LIMIT:],
        "events_dropped": obs_trace.dropped(),
        "spans_dropped": obs.TRACER.dropped,
        "ledger": ledger.snapshot() if ledger.enabled() else None,
        "health": health.raw_snapshot() if health.enabled() else None,
        "extra": dict(extra or {}),
    }
    atomic_write_bytes(
        os.path.join(out_dir, BUNDLE_FILE),
        json.dumps(bundle).encode(),
    )
    return out_dir


# --------------------------------------------------------------------------
# discovery + merge (the fleetview read side)
# --------------------------------------------------------------------------


def discover_bundles(run_dir: str) -> tuple[list[dict], list[str]]:
    """Read every committed ``obs-host-*/`` bundle under ``run_dir``.

    Returns ``(bundles, gaps)``: each bundle is its ``bundle.json`` dict
    plus a ``"spans"`` list parsed from ``spans.jsonl`` and a ``"dir"``.
    Anything broken degrades to a NAMED gap, never an exception: a host
    dir without a committed bundle.json (rank died before the commit
    point), an unparseable bundle, or a truncated spans.jsonl (the span
    records before the tear are kept).
    """
    bundles: list[dict] = []
    gaps: list[str] = []
    try:
        entries = sorted(os.listdir(run_dir))
    except OSError as exc:
        return [], [f"{run_dir}: unreadable run dir ({exc})"]
    for name in entries:
        if not name.startswith(HOST_DIR_PREFIX):
            continue
        d = os.path.join(run_dir, name)
        if not os.path.isdir(d):
            continue
        bundle_path = os.path.join(d, BUNDLE_FILE)
        try:
            with open(bundle_path) as f:
                bundle = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            gaps.append(
                f"{name}: no committed bundle.json ({exc}) — rank "
                "died before the bundle commit point"
            )
            continue
        if not isinstance(bundle, dict) or "host" not in bundle:
            gaps.append(f"{name}: bundle.json missing the host block")
            continue
        spans, span_gap = _read_spans(os.path.join(d, SPANS_FILE))
        if span_gap:
            gaps.append(f"{name}: {span_gap}")
        bundle["spans"] = spans
        bundle["dir"] = d
        bundles.append(bundle)
    bundles.sort(
        key=lambda b: b.get("host", {}).get("process_index", 0)
    )
    return bundles, gaps


def _read_spans(path: str) -> tuple[list[dict], str | None]:
    """Parse a bundle's spans.jsonl; a torn tail (crashed rank) keeps
    every record before the tear and names the gap."""
    spans: list[dict] = []
    try:
        with open(path) as f:
            raw_lines = f.readlines()
    except OSError as exc:
        return [], f"spans.jsonl unreadable ({exc})"
    for lineno, raw in enumerate(raw_lines, 1):
        raw = raw.strip()
        if not raw:
            continue
        try:
            rec = json.loads(raw)
        except json.JSONDecodeError:
            return spans, (
                f"spans.jsonl truncated at line {lineno} — kept "
                f"{len(spans)} span(s) before the tear"
            )
        if rec.get("type") == "span" and "t0" in rec and "t1" in rec:
            spans.append(rec)
    return spans, None


def _to_epoch(bundle: dict, t_perf: float) -> float:
    """Map a bundle's perf_counter stamp onto the epoch clock through
    its commit-time offset sample."""
    clock = bundle.get("clock") or {}
    commit = clock.get("commit") or {}
    return t_perf + float(commit.get("offset", 0.0))


def _bundle_rank(bundle: dict) -> int:
    return int(bundle.get("host", {}).get("process_index", 0))


def _epoch0(bundles: list[dict]) -> float:
    """The merged timeline's zero: the earliest epoch instant any
    bundle knows about (first span start, first ring event, else the
    commit sample itself)."""
    starts: list[float] = []
    for b in bundles:
        spans = b.get("spans", ())
        if spans:
            # Spans record in COMPLETION order (a parent completes after
            # its children), so the earliest start needs the full scan.
            starts.append(
                _to_epoch(b, min(float(sp["t0"]) for sp in spans))
            )
        for ev in b.get("events", ()) or ():
            if "ts" in ev:
                starts.append(_to_epoch(b, float(ev["ts"])))
                break
        commit = (b.get("clock") or {}).get("commit") or {}
        if "epoch" in commit:
            starts.append(float(commit["epoch"]))
    return min(starts) if starts else 0.0


def merge_chrome_trace(
    bundles: list[dict], gaps: tuple[str, ...] | list[str] = ()
) -> dict:
    """All bundles on ONE chrome-trace timeline: pid per rank, each
    host's perf_counter stamps shifted onto the shared epoch clock
    through its own offset, events sorted by fleet time. The document
    passes ``trace.validate_chrome_trace``; ``otherData`` carries the
    fleet provenance, per-host clock bounds, and any merge gaps."""
    from photon_tpu_torch.obs.trace import _request_chrome_events, _us

    epoch0 = _epoch0(bundles)
    out: list[dict] = []
    hosts_meta: list[dict] = []
    skew_bounds: list[float] = []

    for b in bundles:
        ident = b.get("host", {})
        pid = _bundle_rank(b)
        clock = b.get("clock") or {}
        bound = float(clock.get("skew_bound_seconds", 0.0))
        skew_bounds.append(bound)
        hosts_meta.append({
            "process_index": pid,
            "hostname": ident.get("hostname"),
            "pid": ident.get("pid"),
            "run_id": ident.get("run_id"),
            "clock_skew_bound_seconds": bound,
            "spans": len(b.get("spans", ())),
            "events": len(b.get("events", ()) or ()),
        })

        def fleet_us(t_perf: float, b=b) -> float:
            return _us(_to_epoch(b, float(t_perf)) - epoch0)

        out.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {
                "name": f"rank {pid} · {ident.get('hostname', '?')}"
            },
        })
        out.append({
            "name": "process_sort_index", "ph": "M", "pid": pid,
            "args": {"sort_index": pid},
        })
        tids: dict[str, int] = {}

        def tid_for(thread: str, pid=pid, tids=tids) -> int:
            t = tids.get(thread)
            if t is None:
                t = tids[thread] = len(tids) + 1
                out.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": t, "args": {"name": thread},
                })
            return t

        for sp in b.get("spans", ()):
            args: dict = {"path": sp.get("path")}
            if sp.get("attrs"):
                args.update(sp["attrs"])
            if sp.get("device_wait_seconds") is not None:
                args["device_wait_seconds"] = sp["device_wait_seconds"]
            t0, t1 = float(sp["t0"]), float(sp["t1"])
            out.append({
                "name": sp.get("name", "span"), "cat": "span",
                "ph": "X", "ts": fleet_us(t0),
                "dur": _us(max(t1 - t0, 0.0)),
                "pid": pid, "tid": tid_for(sp.get("thread", "main")),
                "args": args,
            })
        for ev in b.get("events", ()) or ():
            kind = ev.get("kind")
            if kind == "instant":
                out.append({
                    "name": ev["name"], "cat": ev.get("cat", "event"),
                    "ph": "i", "s": "t", "ts": fleet_us(ev["ts"]),
                    "pid": pid,
                    "tid": tid_for(ev.get("thread", "events")),
                    "args": dict(ev.get("args") or {}),
                })
            elif kind == "counter":
                out.append({
                    "name": ev["name"], "ph": "C",
                    "ts": fleet_us(ev["ts"]), "pid": pid,
                    "args": {"value": ev["value"]},
                })
            elif kind == "request":
                shifted = dict(ev)
                for k, v in ev.items():
                    if k.endswith("_ts") and isinstance(v, (int, float)):
                        shifted[k] = _to_epoch(b, float(v)) - epoch0
                out.extend(_request_chrome_events(shifted, pid))

    # Stable fleet order: metadata first, then strictly by fleet time —
    # the "monotonic single timeline" the merge promises.
    out.sort(key=lambda ev: (ev["ph"] != "M", ev.get("ts", 0.0)))
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "photon_tpu_torch.obs.fleet",
            "schema": BUNDLE_SCHEMA,
            "epoch0": epoch0,
            "hosts": hosts_meta,
            "clock_skew_bound_seconds": (
                max(skew_bounds) if skew_bounds else 0.0
            ),
            "gaps": list(gaps),
        },
    }


# --------------------------------------------------------------------------
# fleet ledger rollup + straggler report
# --------------------------------------------------------------------------


def _rank_window(bundle: dict) -> tuple[float, float] | None:
    """A rank's dispatch window on the fleet epoch clock: first span
    start → last span end (spans are the recorded work envelope)."""
    spans = bundle.get("spans", ())
    if not spans:
        return None
    t0 = min(float(sp["t0"]) for sp in spans)
    t1 = max(float(sp["t1"]) for sp in spans)
    return _to_epoch(bundle, t0), _to_epoch(bundle, t1)


def _ledger_rows(bundle: dict) -> list[dict]:
    led = bundle.get("ledger") or {}
    return list(led.get("rows", ()) or ())


def straggler_report(
    bundles: list[dict], gaps: tuple[str, ...] | list[str] = ()
) -> dict:
    """The fleet ledger rollup + straggler analysis.

    Per rank: attributed dispatch seconds (sum of its ledger rows),
    dispatch count, and its work window on the fleet
    clock. Per program dispatched on all ranks: per-rank seconds and the
    max−min completion-window skew. The collective-vs-compute split is
    the barrier-wait residual: the fleet wall window is set by the
    slowest rank, every other rank spends (wall − own attributed
    seconds) waiting inside the collectives that keep SPMD ranks in
    lockstep, so ``collective_fraction`` = that wait summed over ranks /
    (ranks × wall). The split is an attribution *estimate* — the
    collectives give no per-collective host timestamps — but its inputs (windows,
    attributed seconds, clock bound) are all measured.
    """
    per_rank: list[dict] = []
    windows: dict[int, tuple[float, float]] = {}
    attributed: dict[int, float] = {}
    prog_rank_seconds: dict[str, dict[int, float]] = {}
    prog_rank_windows: dict[str, dict[int, tuple[float, float]]] = {}
    skew_bounds: list[float] = []
    process_count = 0

    for b in bundles:
        rank = _bundle_rank(b)
        ident = b.get("host", {})
        process_count = max(
            process_count, int(ident.get("process_count", 1))
        )
        clock = b.get("clock") or {}
        skew_bounds.append(float(clock.get("skew_bound_seconds", 0.0)))
        rows = _ledger_rows(b)
        att = sum(float(r.get("seconds", 0.0)) for r in rows)
        dispatches = sum(int(r.get("dispatches", 0)) for r in rows)
        win = _rank_window(b)
        if win is not None:
            windows[rank] = win
        if not rows and win is not None:
            # Ledger-off rank: fall back to the span window as the
            # attributed envelope so the report still ranks it.
            att = win[1] - win[0]
        attributed[rank] = att
        for r in rows:
            prog = str(r.get("program", "?"))
            prog_rank_seconds.setdefault(prog, {})
            prog_rank_seconds[prog][rank] = (
                prog_rank_seconds[prog].get(rank, 0.0)
                + float(r.get("seconds", 0.0))
            )
        for sp in b.get("spans", ()):
            name = str(sp.get("name", "?"))
            e0 = _to_epoch(b, float(sp["t0"]))
            e1 = _to_epoch(b, float(sp["t1"]))
            by_rank = prog_rank_windows.setdefault(name, {})
            if rank in by_rank:
                w0, w1 = by_rank[rank]
                by_rank[rank] = (min(w0, e0), max(w1, e1))
            else:
                by_rank[rank] = (e0, e1)
        per_rank.append({
            "process_index": rank,
            "hostname": ident.get("hostname"),
            "pid": ident.get("pid"),
            "attributed_seconds": round(att, 6),
            "dispatches": dispatches,
            "window": (
                None if win is None else {
                    "start": win[0],
                    "end": win[1],
                    "seconds": round(win[1] - win[0], 6),
                }
            ),
        })

    ranks = sorted(attributed)
    process_count = max(process_count, len(ranks), 1)
    missing = [
        k for k in range(process_count) if k not in set(ranks)
    ]
    gaps = list(gaps) + [
        f"rank {k}: no bundle shipped" for k in missing
    ]

    wall = max(
        (w[1] - w[0] for w in windows.values()), default=0.0
    )
    total_wait = 0.0
    for row in per_rank:
        wait = max(0.0, wall - row["attributed_seconds"])
        row["collective_wait_seconds"] = round(wait, 6)
        total_wait += wait
    collective_fraction = (
        total_wait / (len(per_rank) * wall)
        if per_rank and wall > 0 else 0.0
    )

    straggler = None
    if attributed:
        worst = max(attributed, key=lambda k: attributed[k])
        straggler = {
            "process_index": worst,
            "attributed_seconds": round(attributed[worst], 6),
        }
    straggler_skew = (
        max(attributed.values()) - min(attributed.values())
        if attributed else 0.0
    )

    programs: dict[str, dict] = {}
    for prog in sorted(set(prog_rank_seconds) | set(prog_rank_windows)):
        secs = prog_rank_seconds.get(prog, {})
        wins = prog_rank_windows.get(prog, {})
        on_all = set(secs or wins) >= set(ranks) and bool(ranks)
        entry: dict = {
            "per_rank_seconds": {
                str(k): round(v, 6) for k, v in sorted(secs.items())
            },
            "on_all_ranks": on_all,
        }
        if wins:
            # max−min completion skew: spread of when each rank FINISHED
            # this program's window on the fleet clock.
            ends = {k: w[1] for k, w in wins.items()}
            entry["window_skew_seconds"] = round(
                max(ends.values()) - min(ends.values()), 6
            )
        if secs:
            entry["slowest_rank"] = max(secs, key=lambda k: secs[k])
            entry["seconds_skew"] = round(
                max(secs.values()) - min(secs.values()), 6
            )
        programs[prog] = entry

    return {
        "schema": BUNDLE_SCHEMA,
        "bundles": len(bundles),
        "process_count": process_count,
        "ranks": ranks,
        "missing_ranks": missing,
        "gaps": gaps,
        "per_rank": per_rank,
        "straggler": straggler,
        "straggler_skew_seconds": round(straggler_skew, 6),
        "wall_seconds": round(wall, 6),
        "collective_fraction": round(collective_fraction, 6),
        "clock_skew_bound_seconds": (
            max(skew_bounds) if skew_bounds else 0.0
        ),
        "programs": programs,
    }


def merge_run(
    run_dir: str,
    *,
    trace_path: str | None = None,
) -> tuple[dict, dict]:
    """Discover, merge, and report in one call (the fleetview CLI's
    entry point). Returns ``(report,
    trace_doc)``; ``trace_path`` additionally writes the merged
    timeline (atomically — the artifact CI validates)."""
    bundles, gaps = discover_bundles(run_dir)
    trace_doc = merge_chrome_trace(bundles, gaps)
    report = straggler_report(bundles, gaps)
    if trace_path is not None and bundles:
        from photon_tpu_torch.io.model_io import atomic_write_bytes

        atomic_write_bytes(
            trace_path, json.dumps(trace_doc).encode()
        )
    return report, trace_doc


# --------------------------------------------------------------------------
# MULTICHIP artifact row + monitor-port arbitration
# --------------------------------------------------------------------------


def crosscheck_collective_census(report: dict, census_ops) -> dict:
    """Join a collective census onto a merged fleet report.

    ``census_ops`` is an ordered census of the collectives every rank
    issues: the port's (``parallel.mesh.CollectiveStats.census`` records,
    each named ``op@site``, the records the SPMD tier compares across
    ranks: ``python -m photon_tpu_torch.analysis --spmd``) or op names
    as strings (the JAX package's ``analysis.spmd.collective_sequence``
    op names). The runtime ledger observes collective *waits*; the
    census says which collectives every rank is issuing — joining the
    two makes a mismatched-collective hang attributable: a fleet whose
    census is non-empty but whose merged run is missing ranks is
    presenting exactly the deadlock signature the ``--spmd``
    collective-order rule proves against. The entry is stored under
    ``report["collective_census"]`` (read by :func:`multichip_row` for
    the benchtrend ``multichip_collective_count`` gauge) and returned.
    """
    ops = [f"{o.get('op')}@{o.get('site')}" if isinstance(o, dict)
           else str(o) for o in census_ops]
    mismatches: list[str] = []
    if ops:
        for k in report.get("missing_ranks", ()):
            mismatches.append(
                f"static census orders {len(ops)} collective(s) "
                f"({' -> '.join(ops)}) but rank {k} shipped no bundle — "
                "a mismatched collective order presents exactly this "
                "way; cross-check the --spmd collective-order audit"
            )
    entry = {
        "source": "analysis.spmd",
        "ops": ops,
        "count": len(ops),
        "mismatches": mismatches,
    }
    report["collective_census"] = entry
    return entry


def multichip_row(report: dict, *, n_devices: int | None = None) -> dict:
    """Flatten a straggler report into the MULTICHIP_r*.json row shape.

    Schema 2 keeps the older rows' keys (``n_devices``, ``ok``) and adds
    the structured attribution benchtrend tracks (the ``multichip_*``
    gauges: also the merged wall clock, the hosts-reporting
    count, and the static collective count when
    :func:`crosscheck_collective_census` ran); the full report rides
    along under ``"report"``."""
    row = {
        "schema": 2,
        "n_devices": n_devices,
        "ok": bool(report.get("bundles")) and not report.get("gaps"),
        "process_count": report.get("process_count"),
        "bundles": report.get("bundles"),
        "per_rank_dispatch_seconds": {
            str(r["process_index"]): r["attributed_seconds"]
            for r in report.get("per_rank", ())
        },
        "multichip_straggler_skew_seconds": report.get(
            "straggler_skew_seconds"
        ),
        "multichip_collective_fraction": report.get(
            "collective_fraction"
        ),
        "multichip_clock_skew_bound_seconds": report.get(
            "clock_skew_bound_seconds"
        ),
        "multichip_wall_seconds": report.get("wall_seconds"),
        "multichip_hosts_reporting": len(report.get("ranks", ())),
        "report": report,
    }
    census = report.get("collective_census")
    if census is not None:
        row["multichip_collective_count"] = census.get("count")
    return row


def write_multichip_row(
    row: dict, *, root: str = ".", start: int = 1
) -> str:
    """Commit a MULTICHIP row into the next free ``MULTICHIP_r<NN>.json``
    slot under ``root`` (atomic)."""
    from photon_tpu_torch.io.model_io import atomic_write_bytes

    n = start
    while os.path.exists(
        os.path.join(root, f"MULTICHIP_r{n:02d}.json")
    ):
        n += 1
    path = os.path.join(root, f"MULTICHIP_r{n:02d}.json")
    atomic_write_bytes(path, json.dumps(row, indent=1).encode())
    return path
