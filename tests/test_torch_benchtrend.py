"""The port's ``cli.benchtrend`` (a host file tool), ported from
``tests/test_monitor.py``'s ``TestBenchTrend`` and
``TestBenchTrendEmbeddedRegressions`` and ``tests/test_ledger.py``'s
``TestBenchtrendTracksAttribution``, on synthetic ``BENCH_r*.json`` and
``MULTICHIP_r*.json`` files under ``tmp_path`` only; then the same
series through both packages' ``analyze`` and ``main``: equal reports
and exit codes.
"""

from __future__ import annotations

import contextlib
import io
import json

import pytest

from photon_tpu_torch.cli import benchtrend

# The entry the JAX package's fifth bench round embedded, which the
# seeded waiver covers.
R05_ENTRY = "ingest_rows_per_sec 510028 < 1000000"


def _write_history(tmp_path, *parsed_list, prefix="BENCH_r", wrap=True):
    for i, parsed in enumerate(parsed_list, 1):
        (tmp_path / f"{prefix}{i:02d}.json").write_text(
            json.dumps({"parsed": parsed} if wrap else parsed))


class TestBenchTrend:
    def test_real_history_passes(self, tmp_path, capsys):
        # A history shaped like the repo's own (round-capture files
        # wrapping the line under "parsed", a metric that first lands
        # mid-series, a waived embedded regression in the latest round),
        # written here: the tool reads no file of the repo's.
        _write_history(
            tmp_path,
            {"logistic_rows_per_sec": 1.2e6,
             "logistic_compile_seconds": 20.0},
            {"logistic_rows_per_sec": 1.5e6,
             "logistic_compile_seconds": 19.0},
            {"logistic_rows_per_sec": 1.4e6,
             "logistic_compile_seconds": 21.0, "serving_qps": 900.0},
            {"logistic_rows_per_sec": 1.6e6,
             "logistic_compile_seconds": 18.0, "serving_qps": 950.0,
             "regressions": [R05_ENTRY]},
        )
        rc = benchtrend.main(["--dir", str(tmp_path)])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "trend OK" in out
        assert f"waived: {R05_ENTRY}" in out

    def test_synthetic_regression_fixture_flagged(self, tmp_path, capsys):
        _write_history(
            tmp_path,
            {"logistic_rows_per_sec": 1e6,
             "logistic_compile_seconds": 20.0},
            {"logistic_rows_per_sec": 2e6,
             "logistic_compile_seconds": 18.0},
            {"logistic_rows_per_sec": 0.9e6,  # > 1.5x below best
             "logistic_compile_seconds": 60.0},  # > 1.5x above best
        )
        rc = benchtrend.main(["--dir", str(tmp_path)])
        out = capsys.readouterr().out
        assert rc == 1
        assert "logistic_rows_per_sec" in out
        assert out.count("REGRESSION:") == 2

    def test_within_tolerance_passes(self, tmp_path, capsys):
        _write_history(tmp_path, {"logistic_rows_per_sec": 2e6},
                       {"logistic_rows_per_sec": 1.5e6})
        assert benchtrend.main(["--dir", str(tmp_path)]) == 0
        capsys.readouterr()

    def test_dead_gauge_flagged(self, tmp_path, capsys):
        _write_history(
            tmp_path,
            {"logistic_rows_per_sec": 1e6, "serving_qps": 100.0},
            {"logistic_rows_per_sec": 1.1e6},  # serving_qps vanished
        )
        rc = benchtrend.main(["--dir", str(tmp_path)])
        out = capsys.readouterr().out
        assert rc == 1
        assert "dead gauge" in out

    def test_unparseable_round_skipped_not_fatal(self, tmp_path, capsys):
        (tmp_path / "BENCH_r01.json").write_text("not json{")
        (tmp_path / "BENCH_r02.json").write_text(
            json.dumps({"parsed": {"logistic_rows_per_sec": 1e6}})
        )
        assert benchtrend.main(["--dir", str(tmp_path)]) == 0
        capsys.readouterr()

    def test_json_report_written(self, tmp_path, capsys):
        (tmp_path / "BENCH_r01.json").write_text(
            json.dumps({"parsed": {"logistic_rows_per_sec": 1e6}})
        )
        report_path = tmp_path / "trend.json"
        benchtrend.main([
            "--dir", str(tmp_path), "--json", str(report_path)
        ])
        capsys.readouterr()
        report = json.loads(report_path.read_text())
        assert report["metrics"]["logistic_rows_per_sec"]["status"] in (
            "new", "ok"
        )


class TestBenchTrendEmbeddedRegressions:
    """Bench-reported regressions GATE: a populated ``regressions``
    list in the latest round fails the trend check unless each entry
    carries a reasoned waiver."""

    def test_populated_list_fails(self, tmp_path, capsys):
        _write_history(
            tmp_path,
            {"logistic_rows_per_sec": 1e6, "regressions": []},
            {"logistic_rows_per_sec": 1e6,
             "regressions": ["serving_errors 3 != 0"]},
        )
        rc = benchtrend.main(["--dir", str(tmp_path)])
        out = capsys.readouterr().out
        assert rc == 1
        assert "bench-reported: serving_errors 3 != 0" in out

    def test_only_latest_round_gates(self, tmp_path, capsys):
        _write_history(
            tmp_path,
            {"logistic_rows_per_sec": 1e6,
             "regressions": ["old floor trip"]},
            {"logistic_rows_per_sec": 1e6, "regressions": []},
        )
        assert benchtrend.main(["--dir", str(tmp_path)]) == 0
        capsys.readouterr()

    def test_waiver_requires_reason_and_passes(self, tmp_path, capsys):
        _write_history(
            tmp_path,
            {"logistic_rows_per_sec": 1e6,
             "regressions": ["ingest_rows_per_sec 9 < 10"]},
        )
        rc = benchtrend.main([
            "--dir", str(tmp_path),
            "--waive", "ingest_rows_per_sec 9=rebaselined, see notes",
        ])
        out = capsys.readouterr().out
        assert rc == 0
        assert "waived: ingest_rows_per_sec 9 < 10" in out
        with pytest.raises(SystemExit):
            benchtrend.main([
                "--dir", str(tmp_path), "--waive", "ingest_rows_per_sec",
            ])
        capsys.readouterr()

    def test_seeded_r05_waiver_covers_real_history(self):
        assert any(
            pat in R05_ENTRY for pat in benchtrend.WAIVED_REGRESSIONS
        )
        assert all(
            reason.strip()
            for reason in benchtrend.WAIVED_REGRESSIONS.values()
        )


class TestBenchtrendTracksAttribution:
    def test_tracked_metrics_registered(self):
        assert "logistic_attributed_fraction" in benchtrend.TRACKED
        assert "linear_attributed_fraction" in benchtrend.TRACKED
        direction, tol, _ = benchtrend.TRACKED[
            "logistic_attributed_fraction"]
        assert direction == "higher"
        assert tol < 1.5


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------


SERIES = {
    "clean": (
        [{"logistic_rows_per_sec": 1e6, "serving_p99_ms": 3.0},
         {"logistic_rows_per_sec": 1.3e6, "serving_p99_ms": 2.5,
          "logistic_attributed_fraction": 0.9},
         {"logistic_rows_per_sec": 1.2e6, "serving_p99_ms": 2.8,
          "logistic_attributed_fraction": 0.95,
          "regressions": [R05_ENTRY]}],
        [{"n_devices": 8, "rc": 0, "tail": ["ok"]},
         {"multichip_straggler_skew_seconds": 0.05,
          "report": {"wall_seconds": 2.0}, "bundles": 2},
         {"multichip_straggler_skew_seconds": 0.06,
          "multichip_wall_seconds": 2.2, "multichip_hosts_reporting": 2}],
    ),
    "regressed": (
        [{"logistic_rows_per_sec": 2e6, "serving_qps": 100.0,
          "logistic_compile_seconds": 10.0},
         {"logistic_rows_per_sec": 1e6, "logistic_compile_seconds": 30.0,
          "regressions": ["serving_errors 1 != 0"]}],
        [{"multichip_collective_fraction": 0.01,
          "multichip_hosts_reporting": 2},
         {"collective_fraction": 0.5, "bundles": 1}],
    ),
}


@pytest.mark.parametrize("name", sorted(SERIES))
def test_analyze_and_main_match_the_reference(tmp_path, name):
    from photon_tpu.cli import benchtrend as jax_benchtrend

    bench, multichip = SERIES[name]
    _write_history(tmp_path, *bench)
    _write_history(tmp_path, *multichip, prefix="MULTICHIP_r", wrap=False)
    (tmp_path / "BENCH_r09.json").write_text("torn{")
    for pattern, prefix, tracked in (
            ("BENCH_r*.json", "BENCH_", "TRACKED"),
            ("MULTICHIP_r*.json", "MULTICHIP_", "MULTICHIP_TRACKED")):
        pt_rounds = benchtrend.load_series(str(tmp_path), pattern, prefix)
        jx_rounds = jax_benchtrend.load_series(str(tmp_path), pattern,
                                               prefix)
        assert pt_rounds == jx_rounds
        assert benchtrend.analyze(
            pt_rounds[0], tracked=getattr(benchtrend, tracked)
        ) == jax_benchtrend.analyze(
            jx_rounds[0], tracked=getattr(jax_benchtrend, tracked))
    outs = {}
    for side, main in (("pt", benchtrend.main), ("jax", jax_benchtrend.main)):
        path = tmp_path / f"trend-{side}.json"
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = main(["--dir", str(tmp_path), "--json", str(path)])
        outs[side] = (rc, out.getvalue(), json.loads(path.read_text()))
    assert outs["pt"] == outs["jax"]
    assert outs["pt"][0] == (0 if name == "clean" else 1)
