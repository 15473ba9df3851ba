"""The port's timeline (``photon_tpu_torch.obs.trace``) and crash
flight recorder (``obs.flight``), ported from ``tests/test_trace.py``:

- the trace-event ring (instants, counters, request records), its
  bounded retention and the drop counters;
- the Chrome-trace export: export, validate, load, with host spans,
  counter tracks and per-request async span trees on one clock;
- request-scoped serving traces: every queue outcome (served, expired,
  shed, closed, error) yields exactly one record, served ones with
  monotonic segment stamps; the request log validates under both
  packages' ``validate_jsonl``;
- the flight recorder: dump contents, the dump on a crash-kind fault
  (``faults.on_crash``), the chained excepthook, uninstall restoring
  every hook, and a real ``cli.train`` subprocess's dump on SIGTERM;
- ``profile_session`` over ``torch.profiler`` (monkeypatched) and the
  deprecated ``utils.profile_trace`` shim.

Not ported: the JAX package's three ``TestRooflineGate`` cases (they
hold its ``bench.py`` floors; the port has no benchmark yet) and its
``trace`` program-audit contract (the port has no traced programs).
"""

from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from photon_tpu import obs as jax_obs
from photon_tpu_torch import obs
from photon_tpu_torch.obs import flight
from photon_tpu_torch.obs import trace
from photon_tpu_torch.resilience import FaultPlan, InjectedCrash, faults
from test_torch_serve_degraded import E, request, server

REPO_ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def rng():
    return np.random.default_rng(20260803)


@pytest.fixture
def telemetry():
    """Telemetry on, rings clean; everything restored afterwards."""
    was = obs.enabled()
    obs.reset()
    obs.enable()
    yield obs
    obs.TRACER.enabled = was
    obs.set_span_retention(4096)
    trace.set_retention(8192)
    obs.reset()


def _programs(rng, rungs=(1, 4)):
    return server(rng, rungs)[1]


def _request(rng, user="1"):
    return request(rng, user)


# --------------------------------------------------------------------------
# the event ring
# --------------------------------------------------------------------------


class TestEventRing:
    def test_disabled_records_nothing(self):
        was = obs.enabled()
        obs.disable()
        obs.reset()
        try:
            trace.instant("x")
            trace.counter("c", 1.0)
            trace.request({"id": 1, "outcome": "served",
                           "submit_ts": 0.0, "done_ts": 0.0})
            assert trace.events() == []
        finally:
            obs.TRACER.enabled = was

    def test_overflow_counts_drops_and_feeds_registry(self, telemetry):
        trace.set_retention(3)
        for i in range(7):
            trace.instant(f"e{i}")
        assert len(trace.events()) == 3
        assert trace.dropped() == 4
        # Retention pressure is a REAL metric, not only a header field.
        counters = obs.REGISTRY.snapshot()["counters"]
        assert counters["trace_events_dropped_total"] == 4
        # newest survive
        assert [e["name"] for e in trace.events()] == ["e4", "e5", "e6"]

    def test_set_retention_rejects_nonpositive(self):
        with pytest.raises(ValueError):
            trace.set_retention(0)

    def test_span_retention_configurable_and_counted(self, telemetry):
        obs.set_span_retention(2)
        for i in range(5):
            with obs.span(f"s{i}"):
                pass
        assert len(obs.TRACER.completed()) == 2
        assert obs.TRACER.dropped == 3
        counters = obs.REGISTRY.snapshot()["counters"]
        assert counters["spans_dropped_total"] == 3

    def test_reset_clears_ring(self, telemetry):
        trace.instant("x")
        obs.reset()
        assert trace.events() == []
        assert trace.dropped() == 0


# --------------------------------------------------------------------------
# chrome-trace export
# --------------------------------------------------------------------------


class TestChromeTrace:
    def test_round_trip_export_validate_load(self, telemetry, tmp_path):
        with obs.span("host_section"):
            trace.instant("marker", cat="test", detail=1)
        trace.counter("depth", 3.0)
        trace.request({
            "id": 7, "outcome": "served",
            "submit_ts": 1.0, "take_ts": 1.1, "dispatch_ts": 1.2,
            "scatter_ts": 1.3, "done_ts": 1.4,
            "batch": 1, "batch_size": 2,
        })
        path = str(tmp_path / "trace.json")
        n = obs.write_chrome_trace(path)
        assert trace.validate_chrome_trace(path) == n
        doc = json.load(open(path))
        evs = doc["traceEvents"]
        phases = {e["ph"] for e in evs}
        assert {"X", "i", "C", "b", "e", "M"} <= phases
        # host span on a named thread track
        meta = [e for e in evs if e["ph"] == "M"]
        assert any(e["args"]["name"] for e in meta)
        spans = [e for e in evs if e["ph"] == "X"]
        assert any(e["name"] == "host_section" for e in spans)
        # the request renders as an async tree: root + 4 segments,
        # all grouped under one id
        req = [e for e in evs if e.get("cat") == "serve.request"]
        assert {e["id"] for e in req} == {"7"}
        names = [e["name"] for e in req if e["ph"] == "b"]
        assert names == [
            "request", "queue_wait", "batch_fill", "dispatch", "scatter"
        ]
        # counter track with the sample value
        depth = [e for e in evs
                 if e["ph"] == "C" and e["name"] == "depth"]
        assert depth and depth[0]["args"]["value"] == 3.0
        assert doc["otherData"]["spans_dropped"] == 0
        assert doc["otherData"]["events_dropped"] == 0

    def test_partial_request_renders_root_only(self, telemetry, tmp_path):
        trace.request({
            "id": 9, "outcome": "expired",
            "submit_ts": 5.0, "done_ts": 5.5,
        })
        path = str(tmp_path / "t.json")
        obs.write_chrome_trace(path)
        doc = json.load(open(path))
        req = [e for e in doc["traceEvents"]
               if e.get("cat") == "serve.request"]
        assert [e["name"] for e in req] == ["request", "request"]
        assert req[0]["args"]["outcome"] == "expired"

    def test_metrics_become_counter_tracks(self, telemetry, tmp_path):
        obs.REGISTRY.counter("my_total").inc(4)
        obs.REGISTRY.gauge("my_gauge").set(0.5)
        path = str(tmp_path / "t.json")
        obs.write_chrome_trace(path)
        doc = json.load(open(path))
        tracks = {e["name"]: e["args"]["value"]
                  for e in doc["traceEvents"] if e["ph"] == "C"}
        assert tracks["my_total"] == 4.0
        assert tracks["my_gauge"] == 0.5

    def test_validator_rejects_schema_violations(self, tmp_path):
        def write(doc):
            p = str(tmp_path / "bad.json")
            with open(p, "w") as f:
                json.dump(doc, f)
            return p

        with pytest.raises(ValueError, match="not JSON"):
            p = str(tmp_path / "bad.json")
            open(p, "w").write("{nope")
            trace.validate_chrome_trace(p)
        with pytest.raises(ValueError, match="traceEvents missing"):
            trace.validate_chrome_trace(write({"foo": 1}))
        with pytest.raises(ValueError, match="empty traceEvents"):
            trace.validate_chrome_trace(write({"traceEvents": []}))
        with pytest.raises(ValueError, match="unknown phase"):
            trace.validate_chrome_trace(
                write({"traceEvents": [{"ph": "Z", "pid": 1}]}))
        with pytest.raises(ValueError, match="missing numeric ts"):
            trace.validate_chrome_trace(
                write({"traceEvents": [{"ph": "i", "pid": 1}]}))
        with pytest.raises(ValueError, match="counter without numeric"):
            trace.validate_chrome_trace(write({
                "traceEvents": [
                    {"ph": "C", "pid": 1, "ts": 0.0, "args": {}}
                ]
            }))
        with pytest.raises(ValueError, match="without id/cat"):
            trace.validate_chrome_trace(write({
                "traceEvents": [{"ph": "b", "pid": 1, "ts": 0.0}]
            }))


# --------------------------------------------------------------------------
# request-scoped serving traces
# --------------------------------------------------------------------------


class TestRequestTracing:
    def test_served_requests_carry_monotonic_segment_tree(
        self, telemetry, rng
    ):
        from photon_tpu_torch.serve.queue import MicroBatchQueue

        programs = _programs(rng)
        with MicroBatchQueue(programs, max_linger_s=0.001) as q:
            futs = [q.submit(*_request(rng, str(i % E)))
                    for i in range(6)]
            for f in futs:
                f.result(timeout=30)
        recs = trace.request_records()
        assert len(recs) == 6
        assert {r["outcome"] for r in recs} == {"served"}
        assert len({r["id"] for r in recs}) == 6
        for r in recs:
            assert (r["submit_ts"] <= r["take_ts"] <= r["dispatch_ts"]
                    <= r["scatter_ts"] <= r["done_ts"])
            assert r["batch_size"] >= 1
        summary = trace.request_summary()
        assert summary["outcomes"] == {"served": 6}
        assert set(summary["segment_mean_ms"]) == {
            "queue_wait", "batch_fill", "dispatch", "scatter"
        }

    def test_expired_and_closed_outcomes_recorded(self, telemetry, rng):
        from photon_tpu_torch.resilience.errors import DeadlineExceededError
        from photon_tpu_torch.serve.queue import MicroBatchQueue, QueueClosed

        programs = _programs(rng)
        q = MicroBatchQueue(programs, max_batch=4, max_linger_s=0.2)
        # already past its deadline at submit: fails fast pre-dispatch
        fut = q.submit(*_request(rng), deadline_s=0.0)
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=30)
        q.close()
        with pytest.raises(QueueClosed):
            q.submit(*_request(rng))
        outcomes = [r["outcome"] for r in trace.request_records()]
        assert outcomes.count("expired") == 1
        assert outcomes.count("closed") == 1

    def test_shed_outcome_recorded(self, telemetry, rng):
        from photon_tpu_torch.resilience.errors import OverloadedError
        from photon_tpu_torch.serve.queue import MicroBatchQueue

        programs = _programs(rng)
        with MicroBatchQueue(
            programs, max_batch=4, max_linger_s=0.3, shed_watermark=1
        ) as q:
            first = q.submit(*_request(rng))
            # first lingers in the pending deque -> depth is at the
            # watermark -> the second submit sheds instead of queueing
            with pytest.raises(OverloadedError):
                q.submit(*_request(rng))
            first.result(timeout=30)
        recs = trace.request_records()
        by_outcome = {r["outcome"] for r in recs}
        assert {"served", "shed"} == by_outcome

    def test_dispatch_error_outcome_recorded(self, telemetry, rng):
        from photon_tpu_torch.serve.queue import MicroBatchQueue

        class Boom:
            class ladder:
                max_batch = 4
                rungs = (4,)

            tables = None

            def pack_requests(self, reqs):
                raise ValueError("boom")

        q = MicroBatchQueue(Boom(), max_linger_s=0.001)
        fut = q.submit({"features": np.zeros(1, np.float32)}, {})
        with pytest.raises(ValueError, match="boom"):
            fut.result(timeout=30)
        q.close()
        recs = trace.request_records()
        assert [r["outcome"] for r in recs] == ["error"]
        assert recs[0]["error"] == "ValueError"

    def test_request_jsonl_round_trip_validates(
        self, telemetry, rng, tmp_path
    ):
        from photon_tpu_torch.serve.queue import MicroBatchQueue

        programs = _programs(rng)
        with MicroBatchQueue(programs, max_linger_s=0.001) as q:
            futs = [q.submit(*_request(rng, str(i % E)))
                    for i in range(4)]
            for f in futs:
                f.result(timeout=30)
        path = str(tmp_path / "requests.jsonl")
        n = obs.trace.write_request_jsonl(path)
        assert n == 5  # header + 4 records
        assert obs.validate_jsonl(path) == 5
        # The JAX package's validator reads the port's request log too.
        assert jax_obs.validate_jsonl(path) == 5

    def test_validate_jsonl_rejects_unknown_outcome(self, tmp_path):
        path = str(tmp_path / "bad.jsonl")
        with open(path, "w") as f:
            f.write(json.dumps({"type": "telemetry", "version": 1}) + "\n")
            f.write(json.dumps({
                "type": "request", "id": 1, "outcome": "vanished",
                "submit_ts": 0.0, "done_ts": 1.0,
            }) + "\n")
        with pytest.raises(ValueError, match="unknown request outcome"):
            obs.validate_jsonl(path)

    def test_driver_reports_request_trace(self, telemetry, rng):
        from photon_tpu_torch.serve.driver import drive, synthetic_requests
        from photon_tpu_torch.serve.queue import MicroBatchQueue

        programs = _programs(rng)
        tables = programs.tables
        requests = synthetic_requests(tables, programs, 24, seed=3)
        with MicroBatchQueue(programs, max_linger_s=0.001) as q:
            out = drive(q, requests, warmup=4)
        assert out["request_trace"]["outcomes"]["served"] == 24
        assert "queue_wait" in out["request_trace"]["segment_mean_ms"]


# --------------------------------------------------------------------------
# the flight recorder
# --------------------------------------------------------------------------


class TestFlightRecorder:
    def test_dump_payload_sections(self, telemetry, tmp_path):
        rec = flight.install(str(tmp_path), signals=False)
        try:
            with obs.span("doomed_section"):
                trace.instant("last_words", cat="test")
            obs.REGISTRY.counter("moved_total").inc(3)
            path = rec.dump("test")
            assert path and os.path.exists(path)
            payload = json.load(open(path))
            assert payload["reason"] == "test"
            assert payload["pid"] == os.getpid()
            assert any(s["name"] == "doomed_section"
                       for s in payload["spans"])
            assert any(e.get("name") == "last_words"
                       for e in payload["events"])
            assert payload["counter_deltas"]["moved_total"] == 3.0
            assert payload["retry_stats"]["retries"] == 0
        finally:
            flight.uninstall()

    def test_reinstall_hands_back_a_replaced_recorder(self, tmp_path):
        """The CLI nesting contract: a default-on CLI install replaces
        an ambient recorder; uninstall + reinstall hands it back with
        its hooks re-chained and its identity (baseline, directory)
        intact."""
        import sys

        ambient = flight.install(str(tmp_path / "ambient"), signals=False)
        try:
            inner = flight.install(str(tmp_path / "cli"), signals=False)
            assert flight.installed() is inner
            flight.uninstall()
            assert flight.installed() is None
            back = flight.reinstall(ambient)
            assert back is ambient
            assert flight.installed() is ambient
            assert sys.excepthook == ambient._on_exception
            assert obs.enabled()  # reinstall re-arms recording
            path = flight.dump("handback")
            assert path and str(tmp_path / "ambient") in path
        finally:
            flight.uninstall()
            obs.reset()
            obs.disable()

    def test_install_enables_telemetry_uninstall_restores(self, tmp_path):
        was = obs.enabled()
        obs.disable()
        try:
            flight.install(str(tmp_path), signals=False)
            assert obs.enabled()  # a recorder with empty rings is useless
            flight.uninstall()
            assert not obs.enabled()
        finally:
            obs.TRACER.enabled = was
            obs.reset()

    def test_dump_on_crash_fault(self, telemetry, tmp_path):
        flight.install(str(tmp_path), signals=False)
        try:
            plan = FaultPlan(
                [dict(point="fit.dispatch", nth=1, error="crash")]
            )
            with faults.injected(plan):
                with pytest.raises(InjectedCrash):
                    faults.check("fit.dispatch")
        finally:
            flight.uninstall()
        dumps = glob.glob(str(tmp_path / "flight-*.json"))
        assert len(dumps) == 1
        payload = json.load(open(dumps[0]))
        assert payload["reason"] == "fault.crash:fit.dispatch"
        # the fired fault itself is on the dumped timeline
        assert any(e.get("name") == "fault.fired"
                   for e in payload["events"])

    def test_excepthook_chains_and_dumps(self, telemetry, tmp_path):
        seen = []
        prev = sys.excepthook
        sys.excepthook = lambda *a: seen.append(a)
        try:
            flight.install(str(tmp_path), signals=False)
            try:
                sys.excepthook(ValueError, ValueError("die"), None)
            finally:
                flight.uninstall()
            assert sys.excepthook is not prev  # our spy is restored
            assert len(seen) == 1  # the chained previous hook ran
        finally:
            sys.excepthook = prev
        dumps = glob.glob(str(tmp_path / "flight-*.json"))
        assert len(dumps) == 1
        assert json.load(open(dumps[0]))["reason"] == \
            "exception:ValueError"

    def test_failed_dump_never_raises(self, telemetry, tmp_path):
        bad = tmp_path / "not-a-dir"
        bad.write_text("file, not dir")
        rec = flight.install(str(bad), signals=False)
        try:
            assert rec.dump("test") is None  # logs, returns None
        finally:
            flight.uninstall()

    def test_module_dump_without_recorder_is_noop(self):
        flight.uninstall()
        assert flight.dump("whatever") is None

    def test_sigterm_subprocess_leaves_flight_dump(self, tmp_path):
        """A real ``cli.train`` process held mid-fit by an injected
        delay receives SIGTERM: beside the emergency checkpoint, the
        default-on flight recorder leaves flight-<pid>.json in
        --flight-dir with the signal's reason."""
        from photon_tpu_torch.resilience import load_training_checkpoint
        from test_torch_train_cli import make_config, write_glmix

        train = tmp_path / "train.avro"
        write_glmix(train, 600, 1)
        cfg = make_config(tmp_path, train, None, num_iterations=3,
                          output_dir=str(tmp_path / "out"))
        cfg_path = tmp_path / "cfg.json"
        cfg_path.write_text(json.dumps(cfg))
        ckpt_dir = tmp_path / "ckpt"
        env = dict(os.environ)
        env.update({
            "PYTHONPATH": str(REPO_ROOT),
            faults.ENV_VAR: json.dumps({"faults": [{
                "point": "cd.iteration", "nth": 1,
                "error": "delay", "seconds": 120,
            }]}),
        })
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "photon_tpu_torch.cli.train",
                "--config", str(cfg_path), "--device", "cpu",
                "--checkpoint-dir", str(ckpt_dir),
                "--flight-dir", str(tmp_path / "flight"),
            ],
            cwd=str(REPO_ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        try:
            manifest = ckpt_dir / "manifest.json"
            deadline = time.time() + 120
            while not manifest.exists() and time.time() < deadline:
                assert proc.poll() is None, (
                    proc.communicate()[1].decode()
                )
                time.sleep(0.2)
            assert manifest.exists(), "no checkpoint within 120s"
            time.sleep(0.5)
            proc.send_signal(signal.SIGTERM)
            out, err = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 128 + signal.SIGTERM, err.decode()
        # The recovery point and the post-mortem, committed together.
        assert load_training_checkpoint(str(ckpt_dir), "cpu").interrupted
        dumps = glob.glob(str(tmp_path / "flight" / "flight-*.json"))
        assert len(dumps) == 1, err.decode()
        payload = json.load(open(dumps[0]))
        assert payload["reason"] == f"signal:{signal.SIGTERM}"
        assert payload["pid"] == proc.pid
        assert any(s["name"].startswith("coord:")
                   for s in payload["spans"])


# --------------------------------------------------------------------------
# the profiler entry point
# --------------------------------------------------------------------------


class _FakeProfile:
    """Stands in for ``torch.profiler.profile``: records its activities
    and the path its trace is exported to."""

    calls: list = []

    def __init__(self, activities=None):
        _FakeProfile.calls.append(("activities", tuple(activities)))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        _FakeProfile.calls.append(("export", path))


class TestProfileSession:
    @pytest.fixture
    def fake_profiler(self, monkeypatch):
        import torch.profiler

        _FakeProfile.calls = []
        monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
        return _FakeProfile.calls

    def test_wraps_profiler_inside_correlated_span(
        self, telemetry, fake_profiler, tmp_path
    ):
        import torch.profiler

        with trace.profile_session(str(tmp_path), name="prof"):
            pass
        assert fake_profiler[0][0] == "activities"
        assert torch.profiler.ProfilerActivity.CPU in fake_profiler[0][1]
        kind, path = fake_profiler[1]
        assert kind == "export" and path.startswith(str(tmp_path))
        assert os.path.basename(path).startswith("prof-")
        spans = [s for s in obs.TRACER.completed() if s.name == "prof"]
        assert spans and spans[0].attrs == {"trace_dir": str(tmp_path)}
        names = [e["name"] for e in trace.events()
                 if e["kind"] == "instant"]
        assert names == ["profile.start", "profile.stop"]

    def test_falsy_dir_is_noop(self, telemetry, fake_profiler):
        with trace.profile_session(None):
            pass
        with trace.profile_session(""):
            pass
        assert fake_profiler == []
        assert trace.events() == []
        assert obs.TRACER.completed() == []

    def test_deprecated_shim_routes_here(self, telemetry, fake_profiler,
                                         tmp_path):
        from photon_tpu_torch.utils import profile_trace

        with pytest.warns(DeprecationWarning, match="profile_session"):
            with profile_trace(str(tmp_path)):
                pass
        assert [c[0] for c in fake_profiler] == ["activities", "export"]
        # the shim inherits the correlation contract
        assert any(s.name == "torch_profiler"
                   for s in obs.TRACER.completed())
