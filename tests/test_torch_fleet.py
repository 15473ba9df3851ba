"""The port's fleet layer (``photon_tpu_torch.obs.fleet``), ported from
``tests/test_fleet.py``: the host-identity block and its stamping, the
clock-alignment handshake, bundle shipping (schema and commit point),
the merge of synthetic two-host bundles with a known clock offset onto
one timeline, degradation (torn spans, missing rank, empty run dir),
the straggler rollup, ``cli.fleetview``'s exit codes, monitor-port
arbitration, the MULTICHIP row and ``cli.benchtrend`` over MULTICHIP
series.

Then the two packages side by side: the same synthetic bundles merged
by both ``merge_run``s give equal reports and the same events per rank
in the merged traces, and each package's ``cli.fleetview`` merges a
bundle the other shipped.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import time
import urllib.request

import pytest

from photon_tpu_torch import obs
from photon_tpu_torch.obs import export, fleet, flight
from photon_tpu_torch.obs import trace as obs_trace
from photon_tpu_torch.obs.trace import validate_chrome_trace


@pytest.fixture
def telemetry():
    was = obs.enabled()
    obs.reset()
    obs.enable()
    yield obs
    obs.TRACER.enabled = was
    obs.reset()


@pytest.fixture(autouse=True)
def _clean_fleet():
    fleet.reset()
    yield
    fleet.reset()


# ---------------------------------------------------------------------------
# host identity
# ---------------------------------------------------------------------------


def test_host_identity_fields(monkeypatch):
    monkeypatch.delenv("PHOTON_RUN_ID", raising=False)
    ident = fleet.host_identity()
    # The port's block names torch's version where the JAX package's
    # names jax's.
    for key in (
        "process_index", "process_count", "hostname", "pid",
        "device_kind", "local_device_count", "global_device_count",
        "torch_version", "run_id",
    ):
        assert key in ident
    assert ident["pid"] == os.getpid()
    assert ident["hostname"] == socket.gethostname()
    assert ident["process_index"] == 0
    assert ident["process_count"] >= 1
    assert ident["run_id"] is None


def test_host_identity_is_cached_until_refresh():
    a = fleet.host_identity()
    b = fleet.host_identity()
    assert a == b
    c = fleet.host_identity(refresh=True)
    assert c["pid"] == a["pid"]


def test_run_id_explicit_wins_over_env(monkeypatch):
    monkeypatch.setenv("PHOTON_RUN_ID", "from-env")
    assert fleet.host_identity()["run_id"] == "from-env"
    fleet.set_run_id("explicit")
    assert fleet.run_id() == "explicit"
    fleet.set_run_id(None)
    assert fleet.run_id() == "from-env"


def test_snapshot_and_jsonl_header_carry_host(telemetry, tmp_path):
    with obs.span("stamped"):
        pass
    snap = obs.snapshot()
    assert snap["host"]["pid"] == os.getpid()
    path = tmp_path / "telemetry.jsonl"
    export.write_jsonl(str(path))
    header = json.loads(path.read_text().splitlines()[0])
    assert header["type"] == "telemetry"
    assert header["host"]["hostname"] == socket.gethostname()
    export.validate_jsonl(str(path))


def test_chrome_trace_other_data_carries_host(telemetry):
    with obs.span("traced"):
        pass
    doc = obs_trace.chrome_trace()
    assert doc["otherData"]["host"]["pid"] == os.getpid()


def test_flight_dump_rank_suffixed_filename(telemetry, tmp_path, monkeypatch):
    forged = dict(
        fleet._probe_identity(), process_index=1, process_count=2,
        run_id=None,
    )
    monkeypatch.setattr(fleet, "host_identity", lambda **kw: forged)
    rec = flight.FlightRecorder(str(tmp_path))
    path = rec.dump("test")
    assert path is not None
    assert os.path.basename(path) == f"flight-{os.getpid()}-r1.json"
    payload = json.loads(open(path).read())
    assert payload["host"]["process_index"] == 1


def test_flight_dump_single_process_keeps_plain_name(telemetry, tmp_path):
    rec = flight.FlightRecorder(str(tmp_path))
    path = rec.dump("test")
    assert os.path.basename(path) == f"flight-{os.getpid()}.json"


# ---------------------------------------------------------------------------
# clock alignment
# ---------------------------------------------------------------------------


def test_clock_sample_offset_maps_perf_to_epoch():
    s = fleet.clock_sample()
    assert set(s) == {"offset", "spread", "epoch", "perf_counter"}
    now = time.time() - time.perf_counter()
    assert abs(s["offset"] - now) < 1.0
    assert s["spread"] >= 0.0


def test_clock_alignment_handshake_bounds_drift():
    fleet.mark_init()
    align = fleet.clock_alignment()
    assert align["init"] is not None
    bound = align["skew_bound_seconds"]
    assert bound >= 0.0
    expect = (
        abs(align["commit"]["offset"] - align["init"]["offset"])
        + align["commit"]["spread"] + align["init"]["spread"]
    )
    assert bound == pytest.approx(expect)
    assert bound < 1.0


def test_clock_alignment_without_init_stands_alone():
    align = fleet.clock_alignment()
    assert align["init"] == align["commit"]


# ---------------------------------------------------------------------------
# bundle shipping
# ---------------------------------------------------------------------------


def test_ship_bundle_artifacts(telemetry, tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_RUN_ID", "test-run")
    fleet.mark_init()
    with obs.span("fit"):
        with obs.span("solve"):
            pass
    obs_trace.instant("promoted", cat="pilot")
    obs_trace.counter("queue_depth", 3)
    out_dir = fleet.ship_bundle(str(tmp_path))
    assert os.path.basename(out_dir) == "obs-host-0"

    spans_path = os.path.join(out_dir, fleet.SPANS_FILE)
    export.validate_jsonl(spans_path)
    lines = [json.loads(x) for x in open(spans_path)]
    assert lines[0]["host"]["run_id"] == "test-run"
    spans = [x for x in lines if x.get("type") == "span"]
    assert {s["name"] for s in spans} == {"fit", "solve"}
    assert all("t0" in s and "t1" in s for s in spans)

    bundle = json.load(open(os.path.join(out_dir, fleet.BUNDLE_FILE)))
    assert bundle["schema"] == fleet.BUNDLE_SCHEMA
    assert bundle["host"]["run_id"] == "test-run"
    assert bundle["clock"]["skew_bound_seconds"] >= 0.0
    kinds = {ev["kind"] for ev in bundle["events"]}
    assert {"instant", "counter"} <= kinds
    assert bundle["ledger"] is None  # ledger off in this test


def test_ship_bundle_extra_block(telemetry, tmp_path):
    out_dir = fleet.ship_bundle(str(tmp_path), extra={"verdict": "ok"})
    bundle = json.load(open(os.path.join(out_dir, fleet.BUNDLE_FILE)))
    assert bundle["extra"] == {"verdict": "ok"}


# ---------------------------------------------------------------------------
# synthetic two-host merge
# ---------------------------------------------------------------------------


def _forge_bundle(
    run_dir,
    rank,
    *,
    offset,
    spans,
    ledger_rows=None,
    process_count=2,
    skew_bound=1e-6,
    host_dir=None,
):
    """Write a forged rank bundle: ``spans`` are (name, t0, t1) in the
    host's own perf_counter base; ``offset`` is its perf-to-epoch
    shift. ``host_dir`` is the package's ``fleet.host_dir`` (the
    port's by default)."""
    d = (host_dir or fleet.host_dir)(str(run_dir), rank)
    os.makedirs(d, exist_ok=True)
    host = {
        "process_index": rank, "process_count": process_count,
        "hostname": f"host-{rank}", "pid": 1000 + rank,
        "device_kind": "cpu", "local_device_count": 4,
        "global_device_count": 4 * process_count,
        "torch_version": "0.0-test", "run_id": "forged",
    }
    clock_half = {
        "offset": offset, "spread": 0.0,
        "epoch": offset + 100.0, "perf_counter": 100.0,
    }
    lines = [{"type": "telemetry", "version": 1, "spans_dropped": 0,
              "host": host}]
    for name, t0, t1 in spans:
        lines.append({
            "type": "span", "name": name, "path": name,
            "seconds": t1 - t0, "thread": "main", "attrs": {},
            "device_wait_seconds": None, "t0": t0, "t1": t1,
        })
    with open(os.path.join(d, fleet.SPANS_FILE), "w") as f:
        f.write("".join(json.dumps(x) + "\n" for x in lines))
    bundle = {
        "schema": fleet.BUNDLE_SCHEMA, "host": host,
        "clock": {"init": clock_half, "commit": clock_half,
                  "skew_bound_seconds": skew_bound},
        "metrics": {"counters": {}, "gauges": {}},
        "events": [], "events_dropped": 0, "spans_dropped": 0,
        "ledger": (
            None if ledger_rows is None else {"rows": ledger_rows}
        ),
        "health": None, "extra": {},
    }
    with open(os.path.join(d, fleet.BUNDLE_FILE), "w") as f:
        json.dump(bundle, f)
    return d


def _two_host_dir(tmp_path):
    """Two ranks with DIFFERENT perf bases joined by known offsets:
    rank 0 (offset 1000) works at local [1.0, 3.0] -> epoch [1001, 1003];
    rank 1 (offset 996) at local [4.5, 8.5] -> epoch [1000.5, 1004.5]:
    interleaved on the fleet clock although their local stamps are
    disjoint."""
    run = tmp_path / "fleet"
    _forge_bundle(
        run, 0, offset=1000.0, spans=[("fit", 1.0, 3.0)],
        ledger_rows=[{"coordinate": "fixed", "phase": "fit",
                      "program": "coordinate_descent", "seconds": 2.0,
                      "dispatches": 4, "host_gap_seconds": 0.0}],
    )
    _forge_bundle(
        run, 1, offset=996.0, spans=[("fit", 4.5, 8.5)],
        ledger_rows=[{"coordinate": "fixed", "phase": "fit",
                      "program": "coordinate_descent", "seconds": 4.0,
                      "dispatches": 4, "host_gap_seconds": 0.0}],
    )
    return run


def test_merge_two_hosts_one_timeline(tmp_path):
    run = _two_host_dir(tmp_path)
    bundles, gaps = fleet.discover_bundles(str(run))
    assert [fleet._bundle_rank(b) for b in bundles] == [0, 1]
    assert gaps == []
    doc = fleet.merge_chrome_trace(bundles, gaps)
    events = doc["traceEvents"]
    pids = {ev["pid"] for ev in events}
    assert pids == {0, 1}
    body = [ev for ev in events if ev["ph"] != "M"]
    ts = [ev["ts"] for ev in body]
    assert ts == sorted(ts)
    meta_prefix = len(events) - len(body)
    assert all(ev["ph"] == "M" for ev in events[:meta_prefix])
    # epoch0 = 1000.5, so rank 0's fit starts at +0.5 s, rank 1's at 0
    spans = {ev["pid"]: ev for ev in body if ev["ph"] == "X"}
    assert spans[1]["ts"] == pytest.approx(0.0, abs=1.0)
    assert spans[0]["ts"] == pytest.approx(0.5e6, rel=1e-6)
    assert doc["otherData"]["clock_skew_bound_seconds"] <= 1e-5
    assert [h["process_index"] for h in doc["otherData"]["hosts"]] == [0, 1]


def test_merged_trace_validates_on_disk(tmp_path):
    run = _two_host_dir(tmp_path)
    trace_path = tmp_path / "fleet-trace.json"
    report, doc = fleet.merge_run(str(run), trace_path=str(trace_path))
    assert trace_path.exists()
    assert validate_chrome_trace(str(trace_path)) == len(
        doc["traceEvents"]
    )
    assert report["bundles"] == 2


def test_straggler_report_names_slowest_rank(tmp_path):
    run = _two_host_dir(tmp_path)
    bundles, gaps = fleet.discover_bundles(str(run))
    report = fleet.straggler_report(bundles, gaps)
    assert report["ranks"] == [0, 1]
    assert report["missing_ranks"] == []
    assert report["straggler"]["process_index"] == 1
    assert report["straggler_skew_seconds"] == pytest.approx(2.0)
    # wall = slowest window (rank 1's 4 s); rank 0 waits 2 s of it ->
    # fraction = 2 / (2 ranks x 4 s)
    assert report["wall_seconds"] == pytest.approx(4.0)
    per = {r["process_index"]: r for r in report["per_rank"]}
    assert per[0]["collective_wait_seconds"] == pytest.approx(2.0)
    assert per[1]["collective_wait_seconds"] == pytest.approx(0.0)
    assert report["collective_fraction"] == pytest.approx(0.25)
    fit = report["programs"]["fit"]
    assert fit["on_all_ranks"]
    # rank 0 finishes at epoch 1003, rank 1 at 1004.5
    assert fit["window_skew_seconds"] == pytest.approx(1.5)
    cd = report["programs"]["coordinate_descent"]
    assert cd["slowest_rank"] == 1
    assert cd["seconds_skew"] == pytest.approx(2.0)


def test_ledger_off_rank_falls_back_to_span_window(tmp_path):
    run = tmp_path / "fleet"
    _forge_bundle(run, 0, offset=0.0, spans=[("fit", 1.0, 4.0)],
                  process_count=1)
    bundles, gaps = fleet.discover_bundles(str(run))
    report = fleet.straggler_report(bundles, gaps)
    assert report["per_rank"][0]["attributed_seconds"] == pytest.approx(
        3.0
    )


# ---------------------------------------------------------------------------
# degradation: torn spans, missing rank, uncommitted bundle
# ---------------------------------------------------------------------------


def test_truncated_spans_merge_partially_with_named_gap(tmp_path):
    run = _two_host_dir(tmp_path)
    spans_path = os.path.join(
        fleet.host_dir(str(run), 1), fleet.SPANS_FILE
    )
    with open(spans_path, "a") as f:
        f.write('{"type": "span", "name": "torn", "t0": 5.0, "t')
    bundles, gaps = fleet.discover_bundles(str(run))
    assert len(bundles) == 2
    assert any("truncated" in g and "obs-host-1" in g for g in gaps)
    r1 = [b for b in bundles if fleet._bundle_rank(b) == 1][0]
    assert [s["name"] for s in r1["spans"]] == ["fit"]
    trace_path = tmp_path / "trace.json"
    report, _ = fleet.merge_run(str(run), trace_path=str(trace_path))
    validate_chrome_trace(str(trace_path))
    assert any("truncated" in g for g in report["gaps"])


def test_uncommitted_bundle_is_a_named_gap(tmp_path):
    run = _two_host_dir(tmp_path)
    os.remove(os.path.join(fleet.host_dir(str(run), 1),
                           fleet.BUNDLE_FILE))
    bundles, gaps = fleet.discover_bundles(str(run))
    assert len(bundles) == 1
    assert any("commit point" in g for g in gaps)
    report = fleet.straggler_report(bundles, gaps)
    assert report["missing_ranks"] == [1]
    assert any("rank 1: no bundle shipped" in g for g in report["gaps"])


def test_empty_run_dir_reports_not_raises(tmp_path):
    bundles, gaps = fleet.discover_bundles(str(tmp_path))
    assert bundles == []
    report = fleet.straggler_report(bundles, gaps)
    assert report["bundles"] == 0
    doc = fleet.merge_chrome_trace(bundles, gaps)
    assert doc["traceEvents"] == []


# ---------------------------------------------------------------------------
# fleetview CLI
# ---------------------------------------------------------------------------


def test_fleetview_cli_exit_codes(tmp_path, capsys):
    from photon_tpu_torch.cli import fleetview

    run = _two_host_dir(tmp_path)
    rc = fleetview.main(["--run-dir", str(run), "--expect-ranks", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "slowest rank: 1" in out
    assert "rank 0" in out and "rank 1" in out

    assert fleetview.main(
        ["--run-dir", str(run), "--expect-ranks", "3"]
    ) == 1
    empty = tmp_path / "empty"
    empty.mkdir()
    assert fleetview.main(["--run-dir", str(empty)]) == 2
    capsys.readouterr()


def test_fleetview_cli_json_report(tmp_path, capsys):
    from photon_tpu_torch.cli import fleetview

    run = _two_host_dir(tmp_path)
    out_json = tmp_path / "report.json"
    trace = tmp_path / "trace.json"
    rc = fleetview.main([
        "--run-dir", str(run), "--json", str(out_json),
        "--trace", str(trace),
    ])
    capsys.readouterr()
    assert rc == 0
    report = json.load(open(out_json))
    assert report["straggler"]["process_index"] == 1
    validate_chrome_trace(str(trace))


# ---------------------------------------------------------------------------
# monitor-port arbitration
# ---------------------------------------------------------------------------


def test_resolve_monitor_port():
    assert fleet.resolve_monitor_port(0) == 0
    assert fleet.resolve_monitor_port(-1) == -1
    assert fleet.resolve_monitor_port(9100, 0) == 9100
    assert fleet.resolve_monitor_port(9100, 3) == 9103
    assert fleet.resolve_monitor_port(9100) == 9100


def test_two_rank_exporters_coexist_on_offset_ports(telemetry):
    """Two in-process MonitorServers on rank-offset ports: the per-host
    collision the offset exists to prevent."""
    from photon_tpu_torch.obs.monitor import MonitorServer

    for _ in range(5):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            base = probe.getsockname()[1]
        ports = [fleet.resolve_monitor_port(base, k) for k in range(2)]
        assert ports == [base, base + 1]
        try:
            with MonitorServer(ports[0]) as m0, \
                    MonitorServer(ports[1]) as m1:
                for mon in (m0, m1):
                    resp = urllib.request.urlopen(
                        mon.url + "/metrics", timeout=5
                    )
                    assert resp.status == 200
                    resp.read()
                assert m0.port == base and m1.port == base + 1
            return
        except OSError:
            continue  # another process took base + 1; retry
    pytest.skip("could not find two adjacent free ports")


# ---------------------------------------------------------------------------
# MULTICHIP row + benchtrend multichip series
# ---------------------------------------------------------------------------


def test_multichip_row_shape(tmp_path):
    run = _two_host_dir(tmp_path)
    report, _ = fleet.merge_run(str(run))
    row = fleet.multichip_row(report, n_devices=8)
    assert row["schema"] == 2
    assert row["ok"] is True
    assert row["n_devices"] == 8
    assert row["per_rank_dispatch_seconds"] == {
        "0": pytest.approx(2.0), "1": pytest.approx(4.0)
    }
    assert row["multichip_straggler_skew_seconds"] == pytest.approx(2.0)
    assert row["multichip_collective_fraction"] == pytest.approx(0.25)
    assert row["report"]["ranks"] == [0, 1]


def test_multichip_row_not_ok_with_gaps(tmp_path):
    run = _two_host_dir(tmp_path)
    os.remove(os.path.join(fleet.host_dir(str(run), 1),
                           fleet.BUNDLE_FILE))
    report, _ = fleet.merge_run(str(run))
    assert fleet.multichip_row(report)["ok"] is False


def test_write_multichip_row_takes_next_slot(tmp_path):
    (tmp_path / "MULTICHIP_r01.json").write_text("{}")
    path = fleet.write_multichip_row({"ok": True}, root=str(tmp_path))
    assert os.path.basename(path) == "MULTICHIP_r02.json"
    assert json.load(open(path)) == {"ok": True}


def _old_schema_row(path, rc=0):
    path.write_text(json.dumps({
        "n_devices": 8, "rc": rc, "ok": rc == 0, "skipped": False,
        "tail": ["connecting to gloo", "all done"],
    }))


def test_benchtrend_multichip_series_tolerates_old_schema(tmp_path, capsys):
    from photon_tpu_torch.cli import benchtrend

    (tmp_path / "BENCH_r01.json").write_text(
        json.dumps({"logistic_rows_per_sec": 1e6})
    )
    _old_schema_row(tmp_path / "MULTICHIP_r01.json")
    _old_schema_row(tmp_path / "MULTICHIP_r02.json")
    (tmp_path / "MULTICHIP_r03.json").write_text(json.dumps({
        "schema": 2, "ok": True,
        "multichip_straggler_skew_seconds": 0.07,
        "multichip_collective_fraction": 0.006,
    }))
    rc = benchtrend.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "multichip_straggler_skew_seconds" in out
    assert "new" in out


def test_benchtrend_multichip_regression_gates(tmp_path, capsys):
    from photon_tpu_torch.cli import benchtrend

    (tmp_path / "BENCH_r01.json").write_text(
        json.dumps({"logistic_rows_per_sec": 1e6})
    )
    (tmp_path / "MULTICHIP_r01.json").write_text(json.dumps(
        {"multichip_straggler_skew_seconds": 0.05,
         "multichip_collective_fraction": 0.005}
    ))
    (tmp_path / "MULTICHIP_r02.json").write_text(json.dumps(
        {"multichip_straggler_skew_seconds": 5.0,   # 100x worse
         "multichip_collective_fraction": 0.005}
    ))
    rc = benchtrend.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "multichip: multichip_straggler_skew_seconds" in out


def test_benchtrend_fallback_keys_read_plain_report_names(tmp_path, capsys):
    from photon_tpu_torch.cli import benchtrend

    (tmp_path / "BENCH_r01.json").write_text(
        json.dumps({"logistic_rows_per_sec": 1e6})
    )
    (tmp_path / "MULTICHIP_r01.json").write_text(json.dumps(
        {"straggler_skew_seconds": 0.05, "collective_fraction": 0.005}
    ))
    rc = benchtrend.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "0.05" in out


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------


def _strip_versions(report: dict) -> dict:
    """A report with the host blocks' ``jax_version``/``torch_version``
    removed (the one field the packages stamp differently)."""
    def walk(v):
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()
                    if k not in ("jax_version", "torch_version")}
        if isinstance(v, list):
            return [walk(x) for x in v]
        return v
    return walk(report)


def _events_by_rank(doc: dict) -> dict:
    out: dict = {}
    for ev in doc["traceEvents"]:
        out.setdefault(ev["pid"], []).append(
            {k: v for k, v in ev.items()})
    return out


@pytest.mark.parametrize("torn", [False, True], ids=["clean", "torn-rank-1"])
def test_merge_run_matches_the_reference(tmp_path, torn):
    from photon_tpu.obs import fleet as jax_fleet

    run = _two_host_dir(tmp_path)
    if torn:
        with open(os.path.join(fleet.host_dir(str(run), 1),
                               fleet.SPANS_FILE), "a") as f:
            f.write('{"type": "span", "name": "torn", "t0": 5.0, "t')
    # A third, uncommitted rank dir: a named gap on both sides.
    os.makedirs(fleet.host_dir(str(run), 2))
    pt_report, pt_doc = fleet.merge_run(str(run))
    jx_report, jx_doc = jax_fleet.merge_run(str(run))
    assert _strip_versions(pt_report) == _strip_versions(jx_report)
    assert _events_by_rank(pt_doc) == _events_by_rank(jx_doc)
    pt_other = dict(pt_doc["otherData"], producer=None)
    jx_other = dict(jx_doc["otherData"], producer=None)
    assert pt_other == jx_other
    assert pt_report["gaps"]


def _ship_real_bundle(package: str, run_dir: str) -> str:
    """One bundle shipped by ``package``'s own ``ship_bundle`` after a
    few spans, an instant and its ledger's rows."""
    if package == "jax":
        from photon_tpu import obs as pkg_obs
        from photon_tpu.obs import fleet as pkg_fleet
        from photon_tpu.obs import ledger as pkg_ledger
        from photon_tpu.obs import trace as pkg_trace
    else:
        pkg_obs, pkg_fleet, pkg_trace = obs, fleet, obs_trace
        from photon_tpu_torch.obs import ledger as pkg_ledger
    was = pkg_obs.enabled()
    pkg_obs.reset()
    pkg_obs.enable()
    pkg_ledger.enable()
    try:
        pkg_fleet.mark_init()
        with pkg_obs.span("fit/config:0"):
            with pkg_obs.span("coord:global"):
                time.sleep(0.002)
        pkg_trace.instant("shipped", cat="fleet")
        pkg_ledger.record_dispatch("coordinate_descent", 0.002,
                                   phase="fit", coordinate="global")
        return pkg_fleet.ship_bundle(run_dir)
    finally:
        pkg_ledger.disable()
        pkg_ledger.reset()
        pkg_obs.TRACER.enabled = was
        pkg_obs.reset()


@pytest.mark.parametrize("shipper,reader", [("torch", "jax"),
                                            ("jax", "torch")])
def test_fleetview_reads_the_other_packages_bundle(tmp_path, shipper,
                                                   reader):
    from photon_tpu.cli import fleetview as jax_fleetview
    from photon_tpu_torch.cli import fleetview as pt_fleetview

    run = tmp_path / "fleet"
    out_dir = _ship_real_bundle(shipper, str(run))
    with open(os.path.join(out_dir, fleet.BUNDLE_FILE)) as f:
        shipped = json.load(f)
    assert shipped["schema"] == fleet.BUNDLE_SCHEMA
    main = jax_fleetview.main if reader == "jax" else pt_fleetview.main
    report_path = tmp_path / "report.json"
    trace_path = tmp_path / "merged.json"
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = main(["--run-dir", str(run), "--expect-ranks", "1",
                   "--json", str(report_path), "--trace",
                   str(trace_path)])
    assert rc == 0, out.getvalue()
    report = json.loads(report_path.read_text())
    assert report["ranks"] == [0] and report["gaps"] == []
    assert report["programs"]["coordinate_descent"]["per_rank_seconds"] == {
        "0": pytest.approx(0.002)}
    assert validate_chrome_trace(str(trace_path)) > 0
    names = {ev.get("name") for ev in json.loads(
        trace_path.read_text())["traceEvents"]}
    assert {"fit/config:0", "coord:global", "shipped"} <= names
