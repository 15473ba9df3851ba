"""The port's live-monitoring layer (``photon_tpu_torch.obs.monitor``),
ported from ``tests/test_monitor.py``.

33 of the reference's 43 cases run on the port: the Prometheus text
renderer and the shared validator; rolling-window quantile accuracy
(within one bucket growth factor of the exact percentile) and window
aging; the space-saving sketch's top-K guarantee; multi-window SLO burn
rates; the HTTP exporter (``/healthz``, ``/readyz``, ``/metrics``, scrape
accounting); and the queue's per-coordinate cold counters, window
quantiles, SLO burn and hotness, with the scrape hammer (concurrent
scrapes while the queue serves, under a time limit of its own, with no
graph captured). Time moves on a fake clock, never by sleeping; every
server binds ``127.0.0.1:0`` and stops in ``finally`` (its ``with``).
The ten ``TestBenchTrend*`` cases wait for ``cli.benchtrend`` (ROADMAP
Queue A item 10's last part).

Then the two packages side by side: the same traffic through both
queues, on fake clocks, gives ``metrics_families`` with the same family
names, types and sample label sets, and the port's exposition passes the
reference's ``validate_exposition``.
"""

from __future__ import annotations

import json
import math
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from photon_tpu_torch.io import model_io
from photon_tpu_torch.obs import monitor
from photon_tpu_torch.obs.monitor import (
    MonitorServer,
    RollingHistogram,
    SloPolicy,
    SloTracker,
    SpaceSavingSketch,
)
from photon_tpu_torch.serve.driver import drive, synthetic_requests
from photon_tpu_torch.serve.programs import ScorePrograms, ShapeLadder
from photon_tpu_torch.serve.queue import MicroBatchQueue
from photon_tpu_torch.serve.tables import CoefficientTables

D, DU, E, S = 6, 5, 9, 3
# The scrape hammer's own time limit, seconds.
HAMMER_LIMIT_S = 120.0


@pytest.fixture
def rng():
    return np.random.default_rng(20260803)


def _model_arrays(rng, *, entities=E, coordinates=(("per-user", None),)):
    """The reference test's linear GLMix: a dense fixed effect and
    per-user tables whose projector comes from a fixed seed.
    ``coordinates`` names each random coordinate and its entity keys
    (None: ``"0".."E-1"``)."""
    prng = np.random.default_rng(1234)
    proj = np.sort(
        np.stack([prng.permutation(DU)[:S] for _ in range(entities)]),
        axis=1,
    ).astype(np.int64)
    task = "LINEAR_REGRESSION"
    arrays = {"global/means": rng.normal(size=D).astype(np.float32)}
    manifest = {"global": {"kind": "fixed", "shard": "features",
                           "task": task}}
    for name, keys in coordinates:
        arrays[f"{name}/coefficients"] = rng.normal(
            size=(entities, S)).astype(np.float32)
        arrays[f"{name}/proj_all"] = proj
        manifest[name] = {
            "kind": "random", "re_type": "userId", "shard": "userShard",
            "task": task, "entity_keys": list(
                keys or [str(i) for i in range(entities)]),
        }
    return arrays, manifest


def _programs(rng, rungs=(1, 8), **kw):
    model = model_io.game_model_from_numpy(*_model_arrays(rng, **kw), "cpu")
    tables = CoefficientTables.from_game_model(model, "float32", "cpu")
    return tables, ScorePrograms(tables, ladder=ShapeLadder(rungs))


class _FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# exposition renderer + shared validator
# ---------------------------------------------------------------------------


class TestExposition:
    def test_registry_families_round_trip(self):
        snap = {
            "counters": {"a_total": 3.0, 'b_total{coordinate=per-user}': 1.0},
            "gauges": {"depth": 2.5},
            "histograms": {
                "lat_seconds": {
                    "count": 4, "sum": 0.2, "min": 0.01, "max": 0.1,
                },
            },
        }
        text = monitor.render_exposition(
            monitor.registry_families(snap)
        )
        n = monitor.validate_exposition(text)
        assert n >= 5
        assert 'b_total{coordinate="per-user"} 1' in text
        assert "lat_seconds_count 4" in text
        assert "lat_seconds_max 0.1" in text

    def test_metric_name_sanitized(self):
        assert monitor.metric_name("a b/c-d") == "a_b_c_d"
        assert monitor.metric_name("9lives").startswith("_")

    def test_label_values_escaped(self):
        text = monitor.render_exposition([
            monitor.family(
                "m", "gauge", "h",
                [("", {"k": 'va"l\\ue\n'}, 1.0)],
            )
        ])
        monitor.validate_exposition(text)
        assert '\\"' in text and "\\n" in text

    def test_validator_rejects_bad_name(self):
        with pytest.raises(ValueError, match="bad metric name"):
            monitor.validate_exposition(
                "# HELP 9bad x\n# TYPE 9bad gauge\n9bad 1\n"
            )

    def test_validator_rejects_orphan_sample(self):
        with pytest.raises(ValueError, match="no HELP/TYPE"):
            monitor.validate_exposition("orphan_metric 1\n")

    def test_validator_rejects_unknown_type(self):
        with pytest.raises(ValueError, match="unknown type"):
            monitor.validate_exposition(
                "# HELP m x\n# TYPE m widget\nm 1\n"
            )

    def test_validator_rejects_nonmonotone_buckets(self):
        text = (
            "# HELP h x\n# TYPE h histogram\n"
            'h_bucket{le="0.1"} 5\nh_bucket{le="1"} 3\n'
            'h_bucket{le="+Inf"} 5\nh_count 5\nh_sum 0.5\n'
        )
        with pytest.raises(ValueError, match="not monotone"):
            monitor.validate_exposition(text)

    def test_validator_requires_inf_bucket(self):
        text = (
            "# HELP h x\n# TYPE h histogram\n"
            'h_bucket{le="0.1"} 5\nh_count 5\nh_sum 0.5\n'
        )
        with pytest.raises(ValueError, match=r"\+Inf"):
            monitor.validate_exposition(text)

    def test_validator_checks_count_matches_inf(self):
        text = (
            "# HELP h x\n# TYPE h histogram\n"
            'h_bucket{le="+Inf"} 5\nh_count 7\nh_sum 0.5\n'
        )
        with pytest.raises(ValueError, match="_count"):
            monitor.validate_exposition(text)

    def test_rolling_histogram_family_validates(self):
        h = RollingHistogram(window_s=10, num_windows=2)
        for v in (0.001, 0.01, 0.2, 5.0, 120.0):
            h.observe(v)
        text = monitor.render_exposition([
            h.prometheus_family("lat_window_seconds", "test")
        ])
        monitor.validate_exposition(text)
        assert 'lat_window_seconds_bucket{le="+Inf"} 5' in text


# ---------------------------------------------------------------------------
# rolling-window quantiles
# ---------------------------------------------------------------------------


class TestRollingHistogram:
    def test_windowed_p99_tracks_exact_within_bucket_tolerance(self, rng):
        """The acceptance criterion: on a replayed latency trace, the
        windowed quantile sits within one bucket growth factor of the
        exact percentile."""
        growth = 2 ** 0.25
        h = RollingHistogram(
            window_s=1e9, num_windows=2,
            bounds=monitor.log_bucket_bounds(growth=growth),
        )
        lat = rng.lognormal(mean=-5.0, sigma=1.2, size=20_000)
        for v in lat:
            h.observe(float(v))
        exact = np.sort(lat)
        for q in (0.5, 0.9, 0.99):
            est = h.quantile(q)
            ex = float(exact[max(0, math.ceil(q * len(lat)) - 1)])
            assert ex / growth <= est <= ex * growth, (q, est, ex)

    def test_degrading_tail_visible_in_window_not_whole_run(self):
        """The reason the ring exists: after a long healthy phase, a
        degraded tail dominates the WINDOW immediately while whole-run
        percentiles still average it away."""
        clock = _FakeClock()
        h = RollingHistogram(window_s=1.0, num_windows=3, clock=clock)
        whole_run = []
        for _ in range(10_000):
            h.observe(0.001)
            whole_run.append(0.001)
        clock.t += 5.0  # healthy phase ages fully out of the ring
        for _ in range(100):
            h.observe(0.5)
            whole_run.append(0.5)
        windowed = h.quantile(0.99)
        exact_whole = float(np.percentile(np.asarray(whole_run), 99))
        assert windowed >= 0.5 / 1.2  # window sees the degraded tail
        assert exact_whole <= 0.01  # the whole run hides it

    def test_rotation_drops_old_windows(self):
        clock = _FakeClock()
        h = RollingHistogram(window_s=1.0, num_windows=2, clock=clock)
        h.observe(1.0)
        assert h.snapshot()["count"] == 1
        clock.t += 10.0
        assert h.snapshot()["count"] == 0
        assert h.quantile(0.99) is None

    def test_partial_rotation_keeps_recent(self):
        clock = _FakeClock()
        h = RollingHistogram(window_s=1.0, num_windows=4, clock=clock)
        h.observe(1.0)
        clock.t += 1.5
        h.observe(2.0)
        assert h.snapshot()["count"] == 2  # both inside the 4s span
        clock.t += 3.0  # first obs now out of the ring
        assert h.snapshot()["count"] == 1

    def test_bad_specs_raise(self):
        with pytest.raises(ValueError):
            RollingHistogram(window_s=0)
        with pytest.raises(ValueError):
            monitor.log_bucket_bounds(lo=1.0, hi=0.5)
        with pytest.raises(ValueError):
            RollingHistogram().quantile(1.5)


# ---------------------------------------------------------------------------
# space-saving sketch
# ---------------------------------------------------------------------------


class TestSpaceSavingSketch:
    def test_top_k_on_skewed_stream(self, rng):
        sketch = SpaceSavingSketch(16)
        # Zipf-ish: entity i appears ~ 1/(i+1); the heavy head must
        # surface with counts >= truth (space-saving overestimates).
        truth: dict[str, int] = {}
        for _ in range(20_000):
            key = str(int(rng.zipf(1.5)) % 1000)
            truth[key] = truth.get(key, 0) + 1
            sketch.observe(key)
        top_true = sorted(truth, key=truth.get, reverse=True)[:4]
        top_sketch = [item["key"] for item in sketch.top(8)]
        for key in top_true:
            assert key in top_sketch, (key, top_sketch[:8])
        for item in sketch.top():
            if item["key"] in truth:
                assert item["count"] >= truth[item["key"]]
                assert (
                    item["count"] - item["error"] <= truth[item["key"]]
                )

    def test_capacity_bounded(self):
        sketch = SpaceSavingSketch(4)
        for i in range(100):
            sketch.observe(f"k{i}")
        assert len(sketch.top()) == 4
        assert sketch.observed() == 100


# ---------------------------------------------------------------------------
# SLO burn rates
# ---------------------------------------------------------------------------


class TestSloTracker:
    def test_clean_traffic_burns_nothing(self):
        t = SloTracker(SloPolicy(p99_ms=100.0))
        for _ in range(500):
            t.observe_request(0.001)
        t.observe_lookups(1000, 0)
        rep = t.report()
        for name in ("p99_ms", "error_rate", "cold_entity_rate"):
            assert rep[name]["burn_short"] == 0.0
            assert rep[name]["burn_long"] == 0.0
        assert rep["healthy"]

    def test_error_burn_and_latency_burn(self):
        t = SloTracker(SloPolicy(p99_ms=10.0, error_rate=0.01))
        for _ in range(98):
            t.observe_request(0.001)
        t.observe_request(None, error=True)
        t.observe_request(0.5)  # over the 10ms target
        rep = t.report()
        # 1 error in 100 = 1% observed over a 1% budget -> burn ~1
        assert rep["error_rate"]["burn_long"] == pytest.approx(1.0, rel=0.1)
        # 1 slow request in 99 latencies over a 1% budget -> burn ~1
        assert rep["p99_ms"]["burn_long"] == pytest.approx(1.0, rel=0.1)

    def test_cold_budget_burn(self):
        t = SloTracker(SloPolicy(cold_entity_rate=0.1))
        t.observe_lookups(100, 40)  # 40% cold over a 10% budget
        rep = t.report()
        assert rep["cold_entity_rate"]["burn_long"] == pytest.approx(4.0)
        assert not rep["healthy"]

    def test_multi_window_recovery(self):
        clock = _FakeClock()
        t = SloTracker(
            SloPolicy(error_rate=0.01, short_window_s=1.0,
                      long_window_s=4.0),
            clock=clock,
        )
        t.observe_request(None, error=True)
        rep = t.report()
        assert rep["error_rate"]["burn_short"] > 0
        clock.t += 2.0  # violation ages out of the SHORT window only
        t.observe_request(0.001)
        rep = t.report()
        assert rep["error_rate"]["burn_short"] == 0.0
        assert rep["error_rate"]["burn_long"] > 0.0
        clock.t += 10.0  # ...and then out of the long window too
        t.observe_request(0.001)
        rep = t.report()
        assert rep["error_rate"]["burn_long"] == 0.0

    def test_observe_errors_bulk(self):
        t = SloTracker(SloPolicy(error_rate=0.5))
        t.observe_errors(3)
        assert t.report()["error_rate"]["bad"] == 3

    def test_families_validate(self):
        t = SloTracker()
        t.observe_request(0.001)
        text = monitor.render_exposition(t.prometheus_families())
        monitor.validate_exposition(text)
        assert 'slo_burn_rate{slo="p99_ms",window="short"}' in text

    def test_bad_policy_raises(self):
        with pytest.raises(ValueError):
            SloPolicy(p99_ms=-1)
        with pytest.raises(ValueError):
            SloPolicy(short_window_s=10, long_window_s=5)


# ---------------------------------------------------------------------------
# the HTTP exporter
# ---------------------------------------------------------------------------


class TestMonitorServer:
    def _get(self, url, timeout=5):
        return urllib.request.urlopen(url, timeout=timeout)

    def test_healthz_metrics_and_404(self):
        with MonitorServer(0) as srv:
            assert self._get(srv.url + "/healthz").read() == b"ok\n"
            text = self._get(srv.url + "/metrics").read().decode()
            monitor.validate_exposition(text)
            assert "monitor_scrapes_total" in text
            with pytest.raises(urllib.error.HTTPError) as exc:
                self._get(srv.url + "/nope")
            assert exc.value.code == 404
            stats = srv.scrape_stats()
            assert stats["scrapes"]["/metrics"] == 1
            assert stats["scrape_errors"] == 0

    def test_readyz_flips_with_probe(self):
        state = {"ready": False}
        with MonitorServer(
            0, readiness=lambda: (state["ready"], {"detail": 1})
        ) as srv:
            with pytest.raises(urllib.error.HTTPError) as exc:
                self._get(srv.url + "/readyz")
            assert exc.value.code == 503
            state["ready"] = True
            body = json.loads(self._get(srv.url + "/readyz").read())
            assert body == {"ready": True, "detail": 1}

    def test_collector_failure_is_500_not_crash(self):
        def bad():
            raise RuntimeError("collector exploded")

        with MonitorServer(0, collectors=[bad]) as srv:
            with pytest.raises(urllib.error.HTTPError) as exc:
                self._get(srv.url + "/metrics")
            assert exc.value.code == 500
            # the server survives and keeps answering
            assert self._get(srv.url + "/healthz").read() == b"ok\n"
            assert srv.scrape_stats()["scrape_errors"] == 1


# ---------------------------------------------------------------------------
# queue integration + the scrape-while-serving hammer
# ---------------------------------------------------------------------------


class TestQueueMonitoring:
    def test_per_coordinate_cold_counters(self, rng):
        tables, programs = self._programs_two_coords(rng)
        with MicroBatchQueue(programs, max_linger_s=0.0) as q:
            # warm entity for per-user; ALWAYS-cold entity for
            # per-user2 (empty intersection of the two vocabularies
            # shows exactly what the global rate hides).
            feats = {
                "features": np.zeros(D, np.float32),
                "userShard": np.zeros(DU, np.float32),
            }
            for _ in range(10):
                q.submit(feats, {"userId": "0"}).result(timeout=30)
        stats = q.stats()
        per = stats["per_coordinate"]
        assert per["per-user"]["cold_entity_rate"] == 0.0
        assert per["per-user2"]["cold_entity_rate"] == 1.0
        # the aggregate averages the two coordinates away
        assert stats["cold_entity_rate"] == pytest.approx(0.5)
        health = q.health()
        assert health["cold_entity_rate_by_coordinate"] == {
            "per-user": 0.0, "per-user2": 1.0,
        }

    def _programs_two_coords(self, rng):
        """Two random coordinates SHARING re_type userId with disjoint
        vocabularies (the motivating case for per-coordinate rates)."""
        return _programs(rng, coordinates=(
            ("per-user", None),
            ("per-user2", [f"other-{i}" for i in range(E)]),
        ))

    def test_health_carries_window_and_slo(self, rng):
        tables, programs = _programs(rng)
        q = MicroBatchQueue(
            programs, max_linger_s=0.0,
            slo=SloPolicy(p99_ms=60_000.0),
        )
        with q:
            reqs = synthetic_requests(
                tables, programs, 40, cold_fraction=0.0, seed=3
            )
            for feats, ids in reqs:
                q.submit(feats, ids).result(timeout=30)
            health = q.health()
        assert health["window_latency"]["count"] == 40
        assert health["window_latency"]["p99_ms"] is not None
        assert health["slo"]["healthy"]
        assert health["slo"]["error_rate"]["burn_long"] == 0.0

    def test_hotness_sketch_sees_hot_entity(self, rng):
        tables, programs = _programs(rng)
        with MicroBatchQueue(programs, max_linger_s=0.0) as q:
            feats = {
                "features": np.zeros(D, np.float32),
                "userShard": np.zeros(DU, np.float32),
            }
            for i in range(30):
                q.submit(
                    feats, {"userId": "3" if i % 2 else str(i % E)}
                ).result(timeout=30)
        top = q.hotness_top(3)["per-user"]
        assert top[0]["key"] == "3"
        assert top[0]["count"] >= 15

    def test_rejected_submits_burn_error_budget(self, rng):
        tables, programs = _programs(rng)
        q = MicroBatchQueue(
            programs, max_linger_s=0.0, slo=SloPolicy(error_rate=0.01)
        )
        with q:
            pass  # closed immediately
        from photon_tpu_torch.serve.queue import QueueClosed

        with pytest.raises(QueueClosed):
            q.submit({"features": np.zeros(D, np.float32),
                      "userShard": np.zeros(DU, np.float32)},
                     {"userId": "0"})
        assert q.slo_tracker.report()["error_rate"]["bad"] == 1

    def test_scrape_while_serving_hammer(self, rng):
        """The concurrent scrape hammer: scraper threads hit /metrics,
        /healthz and /readyz continuously while the queue serves a full
        drive, all under ``HAMMER_LIMIT_S``: every scrape returns a
        valid exposition and the drive captures no graph (the port's
        counterpart of the reference's zero compile events)."""
        tables, programs = _programs(rng)
        reqs = synthetic_requests(
            tables, programs, 400, cold_fraction=0.1, seed=11
        )
        q = MicroBatchQueue(
            programs, max_linger_s=0.001, slo=SloPolicy(p99_ms=60_000.0)
        )
        stop = threading.Event()
        deadline = time.monotonic() + HAMMER_LIMIT_S
        errors: list = []
        scrape_counts = [0, 0, 0]

        def scraper(idx):
            while not stop.is_set() and time.monotonic() < deadline:
                try:
                    text = urllib.request.urlopen(
                        srv.url + "/metrics", timeout=5
                    ).read().decode()
                    monitor.validate_exposition(text)
                    urllib.request.urlopen(
                        srv.url + "/healthz", timeout=5
                    ).read()
                    try:
                        urllib.request.urlopen(
                            srv.url + "/readyz", timeout=5
                        ).read()
                    except urllib.error.HTTPError:
                        pass  # 503 before ready is a valid answer
                    scrape_counts[idx] += 1
                except Exception as exc:  # noqa: BLE001 — the test fails on ANY scrape error
                    errors.append(exc)
                    return

        result: dict = {}

        def serve():
            result["summary"] = drive(q, reqs)

        with q, MonitorServer(
            0, collectors=[q.metrics_families],
            readiness=lambda: (not q.health()["breaker_open"], {}),
        ) as srv:
            threads = [
                threading.Thread(target=scraper, args=(i,), daemon=True)
                for i in range(3)
            ]
            for t in threads:
                t.start()
            before = programs.stats["programs_compiled"]
            serving = threading.Thread(target=serve, daemon=True)
            serving.start()
            serving.join(max(deadline - time.monotonic(), 0.0))
            after = programs.stats["programs_compiled"]
            stop.set()
            for t in threads:
                t.join(timeout=10)
        assert not serving.is_alive(), "the drive outlived its time limit"
        assert not errors, errors[:3]
        assert all(c > 0 for c in scrape_counts), scrape_counts
        summary = result["summary"]
        assert summary["errors"] == 0
        assert after - before == 0  # scraping captured nothing
        assert summary["slo"]["error_rate"]["burn_long"] == 0.0

    def test_worker_wakeup_samples_depth_gauge(self, rng):
        from photon_tpu_torch import obs

        tables, programs = _programs(rng)
        was = obs.enabled()
        obs.reset()
        obs.enable()
        try:
            with MicroBatchQueue(programs, max_linger_s=0.0) as q:
                feats = {
                    "features": np.zeros(D, np.float32),
                    "userShard": np.zeros(DU, np.float32),
                }
                q.submit(feats, {"userId": "0"}).result(timeout=30)
                q.close()
            gauges = obs.REGISTRY.snapshot()["gauges"]
            assert "serve_queue_depth" in gauges
            assert gauges["serve_breaker_open"] == 0.0
        finally:
            obs.reset()
            obs.TRACER.enabled = was


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------


def _family_shape(fams) -> dict:
    return {f["name"]: (f["type"], sorted(
        (suffix, tuple(sorted(labels))) for suffix, labels, _ in
        f["samples"])) for f in fams}


def test_queue_metrics_families_match_the_reference(rng, tmp_path):
    """The same requests through both queues, one at a time, on fake
    clocks: the same family names, types and sample label sets (labels
    values included: coordinates, quantiles, hot entity keys, bucket
    bounds), and every rendering passes the reference's validator."""
    from photon_tpu.obs import monitor as jax_monitor
    from photon_tpu.serve.queue import MicroBatchQueue as JaxQueue
    from test_torch_serve_degraded import jax_queue_model, jax_server

    arrays, manifest = _model_arrays(rng)
    model = model_io.game_model_from_numpy(arrays, manifest, "cpu")
    tables = CoefficientTables.from_game_model(model, "float32", "cpu")
    ours = ScorePrograms(tables, ladder=ShapeLadder((1, 8)))
    theirs = jax_server(jax_queue_model(arrays, manifest, tmp_path, "m"),
                        "float32", (1, 8))
    reqs = synthetic_requests(tables, ours, 24, cold_fraction=0.2, seed=5)
    shapes, texts = {}, {}
    for side, queue_cls, programs, policy in (
            ("pt", MicroBatchQueue, ours, SloPolicy),
            ("jax", JaxQueue, theirs, jax_monitor.SloPolicy)):
        clock = _FakeClock()
        q = queue_cls(programs, max_linger_s=0.0,
                      slo=policy(p99_ms=60_000.0))
        q.latency._clock = clock
        q.slo_tracker._clock = clock
        try:
            for feats, ids in reqs:
                q.submit(feats, ids).result(timeout=30)
                clock.t += 0.25
            fams = q.metrics_families()
        finally:
            q.close()
        shapes[side] = _family_shape(fams)
        texts[side] = jax_monitor.render_exposition(fams)
    assert shapes["pt"] == shapes["jax"]
    for text in texts.values():
        assert jax_monitor.validate_exposition(text) > 0
    assert "serve_hot_entity_requests" in shapes["pt"]
    assert "slo_burn_rate" in shapes["pt"]


def test_monitor_server_render_passes_the_reference_validator(rng):
    from photon_tpu.obs import monitor as jax_monitor

    _, programs = _programs(rng)
    with MicroBatchQueue(programs, max_linger_s=0.0,
                         slo=SloPolicy()) as q:
        q.submit({"features": np.zeros(D, np.float32),
                  "userShard": np.zeros(DU, np.float32)},
                 {"userId": "1"}).result(timeout=30)
        srv = MonitorServer(0, collectors=[q.metrics_families])
        with srv:
            text = urllib.request.urlopen(
                srv.url + "/metrics", timeout=5).read().decode()
            body = json.loads(urllib.request.urlopen(
                srv.url + "/readyz", timeout=5).read())
    assert jax_monitor.validate_exposition(text) > 0
    assert body == {"ready": True}
    assert "process_uptime_seconds" in text
