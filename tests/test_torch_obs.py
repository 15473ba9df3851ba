"""The port's telemetry layer (``photon_tpu_torch.obs``), ported from
``tests/test_obs.py``: the span tracer (hierarchy, disabled is free, the
wait at a span's exit), the metrics registry (labels and the
thread-safety hammer), convergence traces, the exporters (the JSONL
schema and its validator, held against the JAX package's validator
too; the summary table; the snapshot of a real fit).

Not ported: the JAX package's five fused-fit cases (its fused fit is
ROADMAP Queue A item 8) and its program-audit contract (the port has
no traced programs to audit).
"""

from __future__ import annotations

import json
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from photon_tpu import obs as jax_obs
from photon_tpu_torch import obs


@pytest.fixture
def telemetry():
    """Enabled telemetry with clean state; restores the global flag."""
    was = obs.enabled()
    obs.reset()
    obs.enable()
    yield obs
    obs.TRACER.enabled = was
    obs.reset()


@pytest.fixture
def telemetry_off():
    was = obs.enabled()
    obs.reset()
    obs.disable()
    yield obs
    obs.TRACER.enabled = was
    obs.reset()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_span_nesting_builds_paths(telemetry):
    with obs.span("outer"):
        with obs.span("inner"):
            pass
        with obs.span("inner"):
            pass
    with obs.span("solo"):
        pass
    agg = obs.snapshot()["spans"]
    assert agg["outer"]["count"] == 1
    assert agg["outer/inner"]["count"] == 2
    assert agg["solo"]["count"] == 1
    assert agg["outer"]["seconds"] >= agg["outer/inner"]["seconds"]


def test_span_disabled_yields_none_and_records_nothing(telemetry_off):
    with obs.span("ghost") as sp:
        assert sp is None
    assert obs.TRACER.completed() == []
    assert obs.snapshot()["spans"] == {}


def test_span_threads_root_their_own_subtrees(telemetry):
    def work():
        with obs.span("worker"):
            pass

    t = threading.Thread(target=work, name="pool-thread")
    with obs.span("driver"):
        t.start()
        t.join()
    agg = obs.snapshot()["spans"]
    # The worker span is a root of its own thread, not a child of
    # "driver" (per-thread stacks; the thread label disambiguates).
    assert set(agg) == {"driver", "worker"}
    spans = {s.path: s for s in obs.TRACER.completed()}
    assert spans["worker"].thread == "pool-thread"


def test_span_sync_failure_does_not_corrupt_thread_stack(
    telemetry, monkeypatch
):
    """A device failure surfacing at the span's wait must still pop and
    record the span: a dead span left on the thread's stack would
    prefix every later span on that thread."""
    from photon_tpu_torch.obs import spans

    def boom(tree):
        raise RuntimeError("device failure")

    monkeypatch.setattr(spans, "wait_for", boom)
    with pytest.raises(RuntimeError, match="device failure"):
        with obs.span("root") as sp:
            sp.sync = object()
    failed = obs.TRACER.completed()[-1]
    assert failed.path == "root"
    assert failed.device_wait_seconds is None  # the wait never completed
    with obs.span("after"):
        pass
    assert obs.TRACER.completed()[-1].path == "after"  # no root/ prefix


def test_span_sync_measures_device_wait(telemetry, monkeypatch):
    """The wait at exit synchronizes the current stream of each CUDA
    tensor's device (none for a CPU tensor) and is recorded; the record
    does not keep the tensors."""
    from photon_tpu_torch.obs import spans

    waited = []
    real = spans.wait_for
    monkeypatch.setattr(spans, "wait_for",
                        lambda tree: (waited.append(tree), real(tree)))
    with obs.span("root") as sp:
        assert sp is not None
        sp.sync = {"w": torch.arange(128.0) * 2.0}
    done = obs.TRACER.completed()[-1]
    assert len(waited) == 1
    assert done.device_wait_seconds is not None
    assert 0.0 <= done.device_wait_seconds <= done.seconds
    assert done.sync is None  # tensors are not pinned by records
    devices = set()
    spans._cuda_devices([torch.ones(2), (torch.zeros(1),)], devices)
    assert devices == set()  # a CPU tensor needs no wait


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_registry_counter_gauge_histogram(telemetry):
    obs.REGISTRY.counter("c_total", kind="x").inc()
    obs.REGISTRY.counter("c_total", kind="x").inc(2.0)
    obs.REGISTRY.counter("c_total", kind="y").inc()
    obs.REGISTRY.gauge("g").set(7.5)
    for v in (1.0, 3.0, 2.0):
        obs.REGISTRY.histogram("h", stage="s").observe(v)
    snap = obs.REGISTRY.snapshot()
    assert snap["counters"]["c_total{kind=x}"] == 3.0
    assert snap["counters"]["c_total{kind=y}"] == 1.0
    assert snap["gauges"]["g"] == 7.5
    h = snap["histograms"]["h{stage=s}"]
    assert h == {"count": 3, "sum": 6.0, "min": 1.0, "max": 3.0}


def test_registry_thread_hammer_no_lost_updates(telemetry):
    """The no-torn-no-lost-updates contract the ingest pools rely on:
    16 threads x 500 increments + observations must all land."""
    threads, per = 16, 500

    def hammer(tid):
        for i in range(per):
            obs.REGISTRY.counter("hammer_total").inc()
            obs.REGISTRY.counter("hammer_total", thread=tid % 4).inc()
            obs.REGISTRY.histogram("hammer_seconds").observe(1.0)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        for f in [pool.submit(hammer, t) for t in range(threads)]:
            f.result()
    snap = obs.REGISTRY.snapshot()
    assert snap["counters"]["hammer_total"] == threads * per
    assert (
        sum(
            v for k, v in snap["counters"].items()
            if k.startswith("hammer_total{")
        )
        == threads * per
    )
    h = snap["histograms"]["hammer_seconds"]
    assert h["count"] == threads * per
    assert h["sum"] == pytest.approx(threads * per)


def test_pipeline_stats_thread_hammer_no_lost_updates(
    telemetry, monkeypatch
):
    """PIPELINE_STATS accounting under the executor pools: stage
    seconds and counts accumulate exactly, from the real chunk pool AND
    a raw thread pool, with no lost or torn updates."""
    from photon_tpu_torch.data.pipeline import PipelineStats, chunk_executor

    monkeypatch.delenv("PHOTON_TPU_SERIAL_INGEST", raising=False)
    stats = PipelineStats()
    threads, per = 8, 200

    def hammer():
        for _ in range(per):
            with stats.stage("hammer"):
                pass
            stats.add("fixed", 0.001)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        for f in [pool.submit(hammer) for _ in range(threads)]:
            f.result()
    # The ingest pipeline's own chunk pool path too (degrades to in-line
    # under forced-serial env; the accounting contract is identical).
    for f in [chunk_executor.submit(hammer) for _ in range(4)]:
        f.result()

    total = (threads + 4) * per
    assert stats._counts["hammer"] == total
    assert stats._counts["fixed"] == total
    assert stats.seconds("fixed") == pytest.approx(total * 0.001)
    assert stats.seconds("hammer") >= 0.0
    rep = stats.report()
    assert rep["stages"]["hammer"] == pytest.approx(
        stats.seconds("hammer"), abs=1e-3)


def test_metrics_listener_feeds_registry_from_event_bus(telemetry):
    from photon_tpu_torch.algorithm.coordinate_descent import (
        CoordinateUpdateRecord,
    )
    from photon_tpu_torch.events import (
        CoordinateUpdateEvent,
        EventEmitter,
        FitEndEvent,
    )

    emitter = EventEmitter([obs.metrics_listener])
    rec = CoordinateUpdateRecord(
        iteration=0, coordinate_id="global", seconds=0.25,
        diagnostics=None, evaluation=None,
    )
    emitter.send_event(CoordinateUpdateEvent(rec))
    emitter.send_event(FitEndEvent(config_index=0, result=None))
    snap = obs.REGISTRY.snapshot()
    assert (
        snap["counters"]["coordinate_updates_total{coordinate=global}"]
        == 1.0
    )
    assert snap["counters"]["fit_configs_total"] == 1.0
    h = snap["histograms"][
        "coordinate_update_dispatch_seconds{coordinate=global}"
    ]
    assert h["count"] == 1 and h["sum"] == pytest.approx(0.25)


# ---------------------------------------------------------------------------
# convergence traces
# ---------------------------------------------------------------------------


def test_convergence_record_and_async_fetch(telemetry):
    arr = np.arange(2 * 1 * 5, dtype=np.float32).reshape(2, 1, 5)
    obs.convergence.record(("per-user",), arr)
    traces = obs.convergence.traces()
    assert len(traces) == 1
    series = traces[0]["per-user"]
    assert list(series) == list(obs.convergence.METRICS)
    assert series["loss"] == [0.0, 5.0]
    assert series["weight_norm_sq"] == [4.0, 9.0]
    snap = obs.convergence.snapshot()
    assert snap["fits_recorded"] == 1
    assert snap["last"]["per-user"]["grad_norm"] == [1.0, 6.0]


def test_convergence_traces_are_bounded(telemetry):
    from photon_tpu_torch.obs.convergence import _MAX_TRACES

    arr = np.zeros((1, 1, 5), np.float32)
    for _ in range(_MAX_TRACES + 5):
        obs.convergence.record(("c",), arr)
    snap = obs.convergence.snapshot()
    assert snap["fits_recorded"] == _MAX_TRACES + 5
    assert len(obs.convergence.traces()) == _MAX_TRACES


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------


def test_snapshot_is_json_serializable(tmp_path):
    """One telemetry-enabled fit of the port (its unfused loop, on the
    CPU): the snapshot round-trips through JSON with the absorbed
    pipeline and compile reports present, the ``coord:<cid>`` spans
    nested under ``fit/config:0`` and the convergence section empty
    (the fused fit that records it is not ported)."""
    import test_torch_train as tt

    was = obs.enabled()
    obs.reset()
    obs.enable()
    try:
        _, pdata = tt.both_datasets(tt.synth(n=600), dtype=torch.float32)
        _, pest = tt.both_estimators("logistic", tt.FE_1RE,
                                     num_iterations=1)
        pest.prepare(pdata)
        pest.fit(pdata)
        snap = obs.snapshot()
    finally:
        obs.TRACER.enabled = was
        obs.reset()
    round_tripped = json.loads(json.dumps(snap))
    assert round_tripped["enabled"] is True
    assert round_tripped["pipeline"] is not None
    assert round_tripped["compile_cache"] is not None
    assert "degraded_reports" not in round_tripped
    assert "health" not in round_tripped
    assert {"prepare", "fit/config:0", "fit/config:0/coord:global",
            "fit/config:0/coord:per-user"} <= set(round_tripped["spans"])
    assert round_tripped["convergence"] == {
        "fits_recorded": 0, "metrics": list(obs.convergence.METRICS),
        "last": None}
    assert round_tripped["host"]["process_index"] == 0
    assert round_tripped["host"]["process_count"] == 1


def test_jsonl_write_and_validate(telemetry, tmp_path):
    with obs.span("root") as sp:
        sp.sync = torch.ones(8)
    obs.REGISTRY.counter("c").inc()
    obs.REGISTRY.gauge("g").set(1.0)
    obs.REGISTRY.histogram("h").observe(2.0)
    obs.convergence.record(("cid",), np.zeros((1, 1, 5), np.float32))
    path = str(tmp_path / "t.jsonl")
    n = obs.write_jsonl(path)
    assert obs.validate_jsonl(path) == n
    lines = [json.loads(l) for l in open(path)]
    assert lines[0]["type"] == "telemetry"
    assert lines[0]["version"] == 1
    assert lines[0]["spans_dropped"] == 0
    types = {l["type"] for l in lines}
    assert {"span", "counter", "gauge", "histogram", "series",
            "report"} <= types
    series = [l for l in lines if l["type"] == "series"]
    assert {s["metric"] for s in series} == set(obs.convergence.METRICS)
    # The JAX package's validator reads the port's stream too.
    assert jax_obs.validate_jsonl(path) == n


def test_validate_jsonl_rejects_schema_violations(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type": "telemetry", "version": 1}\n{"type": "span"}\n')
    with pytest.raises(ValueError, match="span record missing"):
        obs.validate_jsonl(str(bad))
    noheader = tmp_path / "nh.jsonl"
    noheader.write_text('{"type": "counter", "series": "c", "value": 1}\n')
    with pytest.raises(ValueError, match="header"):
        obs.validate_jsonl(str(noheader))
    # A blank first line must not smuggle a headerless stream through.
    blank = tmp_path / "blank.jsonl"
    blank.write_text('\n{"type": "counter", "series": "c", "value": 1}\n')
    with pytest.raises(ValueError, match="header"):
        obs.validate_jsonl(str(blank))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    with pytest.raises(ValueError, match="empty"):
        obs.validate_jsonl(str(empty))
    unknown = tmp_path / "unknown.jsonl"
    unknown.write_text('{"type": "telemetry", "version": 1}\n'
                       '{"type": "health", "data": {}}\n')
    with pytest.raises(ValueError, match="unknown record type"):
        obs.validate_jsonl(str(unknown))


def test_summary_table_renders_all_sections(telemetry):
    with obs.span("a"):
        with obs.span("b"):
            pass
    obs.REGISTRY.counter("c_total").inc(3)
    obs.REGISTRY.histogram("h").observe(0.5)
    obs.convergence.record(("cid",), np.zeros((1, 1, 5), np.float32))
    table = obs.summary_table()
    assert "a/b" not in table  # tree renders leaf names, indented
    assert "c_total = 3" in table
    assert "convergence: 1 fit(s) recorded" in table
    assert "spans" in table and "histograms" in table
