"""The port's per-program cost ledger (``photon_tpu_torch.obs.ledger``),
ported from ``tests/test_ledger.py``: the accumulators (rows, host
gaps, compiles, the resident account and its watermark), the
off-means-off census, attribution windows with the explicit
``unattributed`` residual, the priced report's roofline join and
blocking reasons at the H100's peaks, the cost model's counts, thread
safety under three writer threads, the export and flight surfaces, and
the feed from a real fit with validation and a serving ladder, and the
``ledger_*`` /metrics families (rendered and checked by the port's
``obs.monitor.validate_exposition``, and on a monitor scrape).

Its profile CLI cases are in ``tests/test_torch_profile.py`` and its
``benchtrend`` case in ``tests/test_torch_benchtrend.py``. Its
fused-fit cases run on the port's unfused fit, whose ledger feed books
``coordinate_descent`` rows.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

from photon_tpu_torch import obs
from photon_tpu_torch.algorithm.coordinate_descent import FIT_PROGRAM
from photon_tpu_torch.analysis import costmodel
from photon_tpu_torch.obs import ledger
from test_torch_serve_degraded import D, DU, S, request, server


@pytest.fixture(autouse=True)
def _clean_ledger():
    ledger.disable()
    ledger.reset()
    yield
    ledger.disable()
    ledger.reset()


@pytest.fixture
def rng():
    return np.random.default_rng(20260803)


@pytest.fixture
def armed():
    """Ledger and telemetry on for the test, everything restored
    after."""
    was_obs = obs.enabled()
    obs.enable()
    ledger.enable()
    yield
    ledger.disable()
    ledger.reset()
    obs.TRACER.enabled = was_obs
    obs.reset()


# -------------------------------------------------------------------------
# accumulator primitives
# -------------------------------------------------------------------------


class TestAccumulators:
    def test_disabled_records_nothing(self):
        assert not ledger.enabled()
        ledger.register_program("p", phase="fit", cost={"flops": 1.0})
        ledger.record_dispatch("p", 0.1, phase="fit")
        ledger.record_unattributed(0.1)
        ledger.record_compile("k", 0.1)
        ledger.set_resident("t", 100.0)
        snap = ledger.snapshot()
        # The acceptance contract: a ledger-off run adds ZERO programs
        # to the census (and zero of everything else).
        assert snap["programs"] == {}
        assert snap["rows"] == []
        assert snap["compiles"] == {}
        assert snap["resident_bytes"] == {}
        assert snap["resident_peak_bytes"] == 0.0

    def test_rows_accumulate_by_triple(self, armed):
        ledger.record_dispatch(
            "p", 0.25, phase="fit", coordinate="global")
        ledger.record_dispatch(
            "p", 0.75, phase="fit", coordinate="global")
        ledger.record_dispatch("p", 0.5, phase="serve")
        snap = ledger.snapshot()
        rows = {
            (r["coordinate"], r["phase"], r["program"]): r
            for r in snap["rows"]
        }
        assert rows[("global", "fit", "p")]["seconds"] == pytest.approx(1.0)
        assert rows[("global", "fit", "p")]["dispatches"] == 2
        assert rows[("-", "serve", "p")]["dispatches"] == 1

    def test_host_gap_charged_to_next_dispatcher(self, armed):
        ledger.record_dispatch("a", 1.0, phase="fit", start=0.0, end=1.0)
        ledger.record_dispatch("b", 1.0, phase="fit", start=3.0, end=4.0)
        rows = {
            (r["coordinate"], r["phase"], r["program"]): r
            for r in ledger.snapshot()["rows"]
        }
        assert rows[("-", "fit", "a")]["host_gap_seconds"] == 0.0
        assert rows[("-", "fit", "b")]["host_gap_seconds"] == pytest.approx(
            2.0)

    def test_parts_split_with_dispatch_counts(self, armed):
        ledger.record_dispatch(
            "fit", 1.0, phase="fit", start=0.0, end=1.0,
            parts={"g": 0.25, "u": 0.75},
        )
        rows = {
            (r["coordinate"], r["phase"], r["program"]): r
            for r in ledger.snapshot()["rows"]
        }
        assert rows[("g", "fit", "fit")]["seconds"] == pytest.approx(0.25)
        assert rows[("u", "fit", "fit")]["seconds"] == pytest.approx(0.75)
        assert rows[("g", "fit", "fit")]["dispatches"] == 1

    def test_compile_and_resident_accounts(self, armed):
        ledger.record_compile("serve/score@8", 1.5)
        ledger.record_compile("serve/score@8", 0.5)
        ledger.set_resident("table/a", 100.0)
        ledger.set_resident("table/b", 50.0)
        # Shrinking one owner must not shrink the watermark.
        ledger.set_resident("table/a", 10.0)
        snap = ledger.snapshot()
        assert snap["compiles"]["serve/score@8"] == {
            "seconds": 2.0, "count": 2,
        }
        assert snap["resident_bytes"] == {
            "table/a": 10.0, "table/b": 50.0,
        }
        assert snap["resident_peak_bytes"] == 150.0
        assert ledger.resident_total() == 60.0

    def test_obs_reset_clears_ledger(self, armed):
        ledger.record_dispatch("p", 0.1, phase="fit")
        obs.reset()
        assert ledger.snapshot()["rows"] == []
        # reset drops accumulators but never the enabled flag.
        assert ledger.enabled()


# -------------------------------------------------------------------------
# attribution windows
# -------------------------------------------------------------------------


class TestAttribution:
    def test_mark_is_none_when_disabled(self):
        assert ledger.mark() is None

    def test_window_with_wall_names_residual(self, armed):
        ledger.record_dispatch("warmup", 5.0, phase="fit")
        mark = ledger.mark()
        ledger.record_dispatch(
            "fit", 0.8, phase="fit", parts={"g": 0.3, "u": 0.5})
        out = ledger.attribution_since(mark, wall_seconds=1.0)
        assert out["attributed_seconds"] == pytest.approx(0.8)
        assert out["unattributed_seconds"] == pytest.approx(0.2)
        assert out["attributed_fraction"] == pytest.approx(0.8)
        # The warmup row predates the mark: the window must not see it.
        programs = {r["program"] for r in out["rows"]}
        assert programs == {"fit", "unattributed"}
        residual = [
            r for r in out["rows"] if r["program"] == "unattributed"
        ]
        assert len(residual) == 1
        assert residual[0]["seconds"] == pytest.approx(0.2)

    def test_recorded_residual_without_wall(self, armed):
        mark = ledger.mark()
        ledger.record_dispatch("fit", 0.9, phase="fit")
        ledger.record_unattributed(0.1)
        out = ledger.attribution_since(mark)
        assert out["attributed_fraction"] == pytest.approx(0.9)
        assert out["unattributed_seconds"] == pytest.approx(0.1)

    def test_fraction_clamped_and_empty_window_none(self, armed):
        mark = ledger.mark()
        out = ledger.attribution_since(mark)
        assert out["attributed_fraction"] is None
        ledger.record_dispatch("fit", 2.0, phase="fit")
        # A wall smaller than the named seconds (overlapping windows)
        # clamps to 1.0 instead of reporting >100%.
        out = ledger.attribution_since(mark, wall_seconds=1.0)
        assert out["attributed_fraction"] == 1.0


# -------------------------------------------------------------------------
# the priced report (roofline join + blocking reasons)
# -------------------------------------------------------------------------


class TestReport:
    def test_roofline_join_and_wasted_seconds(self, armed):
        peaks = costmodel.CHIP_PEAKS[costmodel.DEFAULT_CHIP]
        # One dispatch bound by the card's memory: its peak bytes = 1s.
        ledger.register_program(
            "p", phase="fit",
            cost={"flops": 1.0, "hbm_bytes": peaks["hbm_bytes_per_sec"]},
        )
        ledger.record_dispatch("p", 3.0, phase="fit")
        row = ledger.report()["rows"][0]
        assert row["roofline_bound"] == "hbm"
        assert row["vs_roofline"] == pytest.approx(3.0)
        assert row["wasted_seconds"] == pytest.approx(2.0)
        assert row["blocking"] == "bandwidth"
        assert row["achieved_hbm_bytes_per_sec"] == pytest.approx(
            peaks["hbm_bytes_per_sec"] / 3.0)

    def test_compute_bound_blocking(self, armed):
        peaks = costmodel.CHIP_PEAKS[costmodel.DEFAULT_CHIP]
        ledger.register_program(
            "p", phase="fit",
            cost={"flops": peaks["flops_per_sec"], "hbm_bytes": 1.0},
        )
        ledger.record_dispatch("p", 2.0, phase="fit")
        row = ledger.report()["rows"][0]
        assert row["roofline_bound"] == "flops"
        assert row["blocking"] == "compute"

    def test_dispatch_gap_dominates_blocking(self, armed):
        ledger.register_program(
            "p", phase="serve", cost={"flops": 1e9, "hbm_bytes": 1e9})
        ledger.record_dispatch("p", 0.001, phase="serve",
                               start=10.0, end=10.001)
        ledger.record_dispatch("p", 0.001, phase="serve",
                               start=20.0, end=20.001)
        row = [
            r for r in ledger.report()["rows"] if r["dispatches"] == 2
        ][0]
        assert row["host_gap_seconds"] == pytest.approx(9.999)
        assert row["blocking"] == "dispatch-gap"

    def test_parts_split_rows_share_the_program_cost(self, armed):
        # A parts-split program (the fused fit) spreads one program's
        # dispatches over coordinate rows: each row must be priced
        # against its SHARE of the program's cost — pricing every row
        # against the whole program would double-count FLOPs across
        # rows and understate every per-coordinate vs_roofline.
        peaks = costmodel.CHIP_PEAKS[costmodel.DEFAULT_CHIP]
        ledger.register_program(
            "fit", phase="fit",
            cost={"flops": 1.0, "hbm_bytes": peaks["hbm_bytes_per_sec"]},
        )  # whole-program HBM bound: 1s per dispatch
        ledger.record_dispatch(
            "fit", 4.0, phase="fit", start=0.0, end=4.0,
            parts={"g": 1.0, "u": 3.0},
        )
        rows = {
            r["coordinate"]: r
            for r in ledger.report()["rows"]
            if r["dispatches"] > 0
        }
        # Both rows ran the SAME program at the same rate: identical
        # vs_roofline (4x — the whole program's ratio), and achieved
        # bytes/s equal to the program's true rate, not N-coordinates
        # times it.
        assert rows["g"]["vs_roofline"] == pytest.approx(4.0)
        assert rows["u"]["vs_roofline"] == pytest.approx(4.0)
        for r in (rows["g"], rows["u"]):
            assert r["achieved_hbm_bytes_per_sec"] == pytest.approx(
                peaks["hbm_bytes_per_sec"] / 4.0)
        # Waste splits by share and sums to the program's waste (3s).
        assert rows["g"]["wasted_seconds"] == pytest.approx(0.75)
        assert rows["u"]["wasted_seconds"] == pytest.approx(2.25)

    def test_costless_program_degrades_to_measured_only(self, armed):
        ledger.record_dispatch("transfer", 0.5, phase="ingest")
        row = ledger.report()["rows"][0]
        assert row["vs_roofline"] is None
        assert row["achieved_flops_per_sec"] is None
        assert row["blocking"] == "measured-only"
        assert row["wasted_seconds"] == pytest.approx(0.5)

    def test_zero_cost_program_never_divides(self, armed):
        # A pure-transfer program prices to all-zero counters: the
        # roofline bound is 0s and every derived ratio must be None,
        # not a ZeroDivisionError.
        ledger.register_program(
            "xfer", phase="ingest",
            cost={"flops": 0.0, "hbm_bytes": 0.0},
        )
        ledger.record_dispatch("xfer", 0.25, phase="ingest")
        row = ledger.report()["rows"][0]
        assert row["vs_roofline"] is None
        assert row["blocking"] == "measured-only"

    def test_failing_cost_thunk_degrades_once(self, armed):
        calls = []

        def boom():
            calls.append(1)
            raise RuntimeError("no cost analysis on this backend")

        ledger.register_program("p", phase="fit", cost_thunk=boom)
        ledger.record_dispatch("p", 0.5, phase="fit")
        row1 = ledger.report()["rows"][0]
        row2 = ledger.report()["rows"][0]
        assert row1["blocking"] == "measured-only"
        assert "no cost analysis" in row1["cost_error"]
        assert row2["cost_error"] == row1["cost_error"]
        assert len(calls) == 1  # the failure is cached, priced once

    def test_top_k_excludes_residual_and_ranks_by_waste(self, armed):
        ledger.record_dispatch("slow", 2.0, phase="fit")
        ledger.record_dispatch("fast", 0.1, phase="fit")
        ledger.record_unattributed(9.0)
        rows = ledger.top_k(5)
        assert [r["program"] for r in rows] == ["slow", "fast"]
        assert "slow" in ledger.render_top_k(1)
        assert "fast" not in ledger.render_top_k(1)

    def test_render_empty(self, armed):
        assert "no dispatches" in ledger.render_top_k()


# -------------------------------------------------------------------------
# the cost model the ledger prices by: the H100's peaks and the kernels'
# own counts (the JAX package's cost_analysis cases become count cases:
# the port has no lowering to analyse)
# -------------------------------------------------------------------------


class TestCostmodelEdges:
    def test_peaks_are_the_h100s(self):
        peaks = costmodel.CHIP_PEAKS[costmodel.DEFAULT_CHIP]
        assert costmodel.DEFAULT_CHIP == "h100_sxm"
        assert peaks["hbm_bytes_per_sec"] == 3.35e12
        assert peaks["flops_per_sec"] == 67e12
        assert peaks["bf16_tensor_flops_per_sec"] == 989e12
        # No TPU peak reaches the port.
        assert not any(k.startswith("tpu") for k in costmodel.CHIP_PEAKS)

    def test_serve_rung_cost_counts_every_row(self, rng):
        """The ledger's count of a rung is the serve kernel's count with
        every row known and distinct, from shapes alone."""
        _, programs = server(rng, rungs=(1, 4))
        cost = programs.rung_cost(4)
        feats, codes, _ = programs.pack_requests(
            [request(rng, str(i)) for i in range(4)])
        ops = programs.operands(feats, codes)
        assert cost == costmodel.serve_score_cost(ops, "float32")
        # 4 rows of D + DU f32 features, D f32 weights, one code and
        # one S-slot table row (weights and projector) a row, 4 scores.
        assert cost["hbm_bytes"] == 4 * (D + DU) * 4 + D * 4 + 4 * 4 + (
            4 * S * 8) + 4 * 4
        assert cost["flops"] == 2.0 * 4 * D + 2.0 * 4 * S

    def test_newton_and_segment_counts(self):
        b, r, s = 10, 64, 17
        cost = costmodel.newton_step_cost((b, r, s))
        assert cost["hbm_bytes"] == 4.0 * b * (r * s + 3 * r + 6 * s + 2) + b
        assert cost["transcendentals"] == b * r * (2 * 16 + 6)
        seg = costmodel.segment_sum_cost(1000, 2, 7)
        assert seg == {"flops": 1000.0, "hbm_bytes": 1000 * 6 + 7 * 4}
        # A segment sum is bound by its bytes.
        assert costmodel.roofline(seg)["bound"] == "hbm"

    def test_roofline_zero_cost_no_division(self):
        roof = costmodel.roofline(
            {"flops": 0.0, "hbm_bytes": 0.0})
        assert roof["min_seconds"] == 0.0
        assert roof["arithmetic_intensity"] is None

    def test_roofline_zero_flops_pure_transfer(self):
        roof = costmodel.roofline({"flops": 0.0, "hbm_bytes": 3.35e12})
        assert roof["bound"] == "hbm"
        assert roof["min_seconds"] == pytest.approx(1.0)


# -------------------------------------------------------------------------
# thread safety: the three writer threads production runs
# -------------------------------------------------------------------------


class TestThreadSafety:
    def test_concurrent_writers_lose_nothing(self, armed):
        n = 400
        errs = []

        def guarded(fn):
            def run():
                try:
                    fn()
                except Exception as exc:  # noqa: BLE001
                    errs.append(exc)
            return run

        def serve_worker():
            for i in range(n):
                ledger.record_dispatch(
                    "serve/score@8", 0.001, phase="serve",
                    start=float(i), end=float(i) + 0.001,
                )

        def compile_thread():
            for i in range(n):
                ledger.record_compile("fused_fit/fit", 0.002)
                ledger.register_program(
                    f"prog-{i % 7}", phase="fit",
                    cost={"flops": 1.0, "hbm_bytes": 1.0},
                )

        def ingest_planner():
            for i in range(n):
                ledger.record_dispatch(
                    "fit", 0.003, phase="fit",
                    parts={"g": 0.001, "u": 0.002},
                )
                ledger.set_resident("table/a", float(i))
                ledger.record_unattributed(0.0005)

        threads = [
            threading.Thread(target=guarded(f), name=name)
            for name, f in (
                ("serve-worker", serve_worker),
                ("compile", compile_thread),
                ("ingest-planner", ingest_planner),
            )
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert errs == []
        snap = ledger.snapshot()
        rows = {
            (r["coordinate"], r["phase"], r["program"]): r
            for r in snap["rows"]
        }
        assert rows[("-", "serve", "serve/score@8")]["dispatches"] == n
        assert rows[("g", "fit", "fit")]["seconds"] == pytest.approx(
            n * 0.001)
        assert rows[("u", "fit", "fit")]["seconds"] == pytest.approx(
            n * 0.002)
        assert rows[("-", "host", "unattributed")]["seconds"] == (
            pytest.approx(n * 0.0005))
        assert snap["compiles"]["fused_fit/fit"]["count"] == n
        assert len(snap["programs"]) == 7
        # Reports render consistently after the hammer too.
        assert ledger.report()["rows"]


# -------------------------------------------------------------------------
# surfaces: /metrics families, exporters, flight
# -------------------------------------------------------------------------


# -------------------------------------------------------------------------
# surfaces: exporters, flight
# -------------------------------------------------------------------------


class TestSurfaces:
    def test_metrics_families_empty_when_disabled(self):
        assert ledger.metrics_families() == []

    def test_metrics_families_render_and_validate(self, armed):
        from photon_tpu_torch.obs.monitor import (
            render_exposition,
            validate_exposition,
        )

        ledger.register_program("p", phase="fit")
        ledger.record_dispatch(
            "p", 0.5, phase="fit", coordinate="global")
        ledger.record_compile("k", 1.0)
        ledger.set_resident("table/a", 42.0)
        text = render_exposition(ledger.metrics_families())
        assert validate_exposition(text) > 0
        assert 'ledger_dispatch_seconds_total{' in text
        assert 'coordinate="global"' in text
        assert "ledger_resident_peak_bytes 42" in text
        assert 'ledger_compile_seconds_total{key="k"} 1' in text

    def test_monitor_scrape_includes_ledger(self, armed):
        from photon_tpu_torch.obs.monitor import (
            MonitorServer,
            validate_exposition,
        )

        ledger.record_dispatch("p", 0.5, phase="fit")
        text = MonitorServer(port=0).render()
        assert validate_exposition(text) > 0
        assert "ledger_programs_registered" in text

    def test_snapshot_and_jsonl_carry_ledger(self, armed, tmp_path):
        from photon_tpu_torch.obs.export import validate_jsonl

        ledger.record_dispatch("p", 0.5, phase="fit")
        snap = obs.snapshot()
        assert snap["ledger"]["rows"]
        path = tmp_path / "telemetry.jsonl"
        obs.write_jsonl(str(path))
        validate_jsonl(str(path))
        recs = [
            json.loads(line) for line in path.read_text().splitlines()
        ]
        led = [
            r for r in recs
            if r["type"] == "report" and r["name"] == "ledger"
        ]
        assert len(led) == 1
        assert led[0]["data"]["rows"]

    def test_flight_dump_books_ledger(self, armed, tmp_path):
        from photon_tpu_torch.obs import flight

        ledger.record_dispatch("p", 0.5, phase="fit")
        rec = flight.install(str(tmp_path), signals=False)
        try:
            path = rec.dump("test")
        finally:
            flight.uninstall()
        with open(path) as f:
            payload = json.load(f)
        assert payload["ledger"]["rows"]


# -------------------------------------------------------------------------
# export degradation (satellite: obs/export.py visible degraded report)
# -------------------------------------------------------------------------


class TestExportDegradation:
    def test_healthy_branch_emits_real_reports(self, tmp_path):
        from photon_tpu_torch.obs.export import validate_jsonl

        was = obs.enabled()
        obs.enable()
        try:
            path = tmp_path / "t.jsonl"
            obs.write_jsonl(str(path))
        finally:
            obs.TRACER.enabled = was
        validate_jsonl(str(path))
        recs = [
            json.loads(line) for line in path.read_text().splitlines()
        ]
        reports = {
            r["name"]: r["data"] for r in recs if r["type"] == "report"
        }
        assert "pipeline" in reports and "compile_cache" in reports
        assert not reports["pipeline"].get("degraded")
        assert not reports["compile_cache"].get("degraded")
        # The JAX package's key names where they mean the same thing.
        assert {"aot_compiles", "aot_compile_seconds", "dir"} <= set(
            reports["compile_cache"])
        assert "degraded_reports" not in obs.snapshot()

    def test_degraded_branch_is_visible(self, tmp_path, monkeypatch):
        from photon_tpu_torch.data.pipeline import PIPELINE_STATS
        from photon_tpu_torch.obs.export import validate_jsonl

        def boom():
            raise RuntimeError("stats backend wedged")

        monkeypatch.setattr(PIPELINE_STATS, "report", boom)
        was = obs.enabled()
        obs.enable()
        try:
            snap = obs.snapshot()
            path = tmp_path / "t.jsonl"
            obs.write_jsonl(str(path))
        finally:
            obs.TRACER.enabled = was
        # The snapshot says WHY the section is missing...
        assert snap["pipeline"] is None
        assert "stats backend wedged" in snap["degraded_reports"][
            "pipeline"]
        # ...and the JSONL stream carries a VISIBLE degraded report
        # record (schema-valid) instead of silently dropping the line.
        validate_jsonl(str(path))
        recs = [
            json.loads(line) for line in path.read_text().splitlines()
        ]
        degraded = [
            r for r in recs
            if r["type"] == "report" and r["name"] == "pipeline"
        ]
        assert len(degraded) == 1
        assert degraded[0]["data"]["degraded"] is True
        assert "stats backend wedged" in degraded[0]["data"]["error"]


# -------------------------------------------------------------------------
# end to end: a fit with validation and a serving ladder feed the ledger
# -------------------------------------------------------------------------


def _fit_with_validation():
    import test_torch_train as tt

    _, pdata = tt.both_datasets(tt.synth(n=600), dtype=torch.float32)
    _, pval = tt.both_datasets(tt.synth(seed=6, n=300),
                               dtype=torch.float32)
    _, pest = tt.both_estimators("logistic", tt.FE_1RE, num_iterations=1)
    result = pest.fit(pdata, pval)[0]
    return pest, pval, result


class TestEndToEnd:
    def test_fit_and_serve_feed_the_ledger(self, armed, rng):
        from photon_tpu_torch.serve.queue import MicroBatchQueue

        pest, pval, result = _fit_with_validation()
        mark = ledger.mark()
        # A (re)loaded model's validation rescoring: eval rows.
        _, val_ctx = pest.prepare(pest._fit_cache[0][0], pval)
        pest._score_with_validation(val_ctx, result.model)
        _, programs = server(rng, rungs=(1, 4))
        with MicroBatchQueue(programs, max_linger_s=0.001) as q:
            for f in [q.submit(*request(rng, str(i))) for i in range(9)]:
                f.result(timeout=30)
        snap = ledger.snapshot()
        # The fit's program, measured-only, beside the serve rungs; on
        # the CPU no kernel launched, so no kernel joins the census.
        assert {"serve/score@1", "serve/score@4", FIT_PROGRAM} == set(
            snap["programs"])
        assert snap["programs"][FIT_PROGRAM] == {"phase": "fit",
                                                 "cost": None}
        rows = {(r["coordinate"], r["phase"], r["program"]): r
                for r in snap["rows"]}
        # Per-coordinate fit rows (one dispatch each: one fit) and the
        # explicit residual of the fit's wall.
        for cid in ("global", "per-user"):
            fit_row = rows[(cid, "fit", FIT_PROGRAM)]
            assert fit_row["dispatches"] == 1 and fit_row["seconds"] > 0
        assert ("-", "host", "unattributed") in rows
        # The per-user slabs' bytes: [B, R, S] values plus the [B, R]
        # and [B, S] leaves of every materialized bucket.
        slabs = sum(ds.slab_nbytes() for ds in pest._fit_cache[1][0].values()
                    if hasattr(ds, "slab_nbytes"))
        assert slabs > 0
        assert snap["resident_bytes"][f"{FIT_PROGRAM}/slabs"] == slabs
        assert ("global", "eval", "eval/score") in rows
        assert ("per-user", "eval", "eval/score") in rows
        assert ("-", "eval", "eval/suite") in rows
        served = sum(r["dispatches"] for k, r in rows.items()
                     if k[2].startswith("serve/score@"))
        assert served == sum(programs.stats["dispatches"].values())
        assert any(k.startswith("table/") for k in snap["resident_bytes"])
        out = ledger.attribution_since(mark)
        assert out["attributed_fraction"] is not None
        # The priced report joins the kernel counts without error.
        top = ledger.top_k(3)
        assert top and all("blocking" in r for r in top)
        priced = {r["program"]: r for r in ledger.report()["rows"]}
        assert priced["serve/score@4"]["roofline_bound"] == "hbm"
        assert "cost_error" not in priced["serve/score@4"]

    def test_ledger_off_fit_registers_zero_programs(self, rng):
        from photon_tpu_torch.serve.queue import MicroBatchQueue

        was = obs.enabled()
        obs.enable()
        try:
            assert not ledger.enabled()
            _fit_with_validation()
            _, programs = server(rng, rungs=(1, 4))
            with MicroBatchQueue(programs, max_linger_s=0.001) as q:
                q.submit(*request(rng)).result(timeout=30)
        finally:
            obs.TRACER.enabled = was
            obs.reset()
        snap = ledger.snapshot()
        assert snap["programs"] == {}
        assert snap["rows"] == []
        assert snap["resident_bytes"] == {}
