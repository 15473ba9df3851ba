"""The port's model and data health layer (``photon_tpu_torch.obs.health``),
ported from ``tests/test_health.py``.

52 of the reference's 55 cases run on the port: sketch algebra (merge
laws and byte-stable serialization, exact), PSI/KS drift scoring,
calibration/ECE on hand-computed fixtures, coefficient movement,
numerics sentinels (on numpy blocks and on parked tensors), the serve
tap (through the port's ``MicroBatchQueue`` on the CPU), the gate
policy, kill-and-resume of the streaming ingest's sketch, the
``health_*`` /metrics families and the snapshot and flight sections.
Three wait, named here:

- ``TestSentinels::test_fused_fit_parks_sentinel_when_armed``: the port
  has no fused fit to park a convergence block (ROADMAP Queue A item 8
  gets the hook);
- ``TestPilotHealthGate`` and ``TestPilotHealthConfig``: the pilot
  (its ROADMAP item).

Then the two packages side by side on the same seeded numpy inputs: a
``DataSketch``, a ``CalibrationSketch`` summary and a ``compare``
report serialize to the same bytes (exact), and ``coefficient_movement``
on a reference ``GameModel`` and its port counterpart, carried across
by the npz checkpoint, agrees within 1e-12 (float64 norms of the same
float32 coefficients).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest

from photon_tpu_torch.io import model_io
from photon_tpu_torch.obs import health
from photon_tpu_torch.obs.health import (
    CalibrationSketch,
    DataSketch,
    DistSketch,
    FeatureMoments,
    HealthGatePolicy,
    coefficient_movement,
    compare,
    count_undefined_groups,
    ks,
    psi,
    signed_log_bounds,
)


@pytest.fixture(autouse=True)
def _clean_health():
    """The port's process-global health state starts (and ends) clean
    and disarmed."""
    health.reset()
    health.disable()
    yield
    health.reset()
    health.disable()


# ---------------------------------------------------------------------------
# DistSketch
# ---------------------------------------------------------------------------


class TestDistSketch:
    def test_moments_missing_and_quantiles(self):
        sk = DistSketch()
        sk.observe(np.asarray(
            [1.0, 2.0, 3.0, np.nan, np.inf, -np.inf], dtype=np.float64))
        assert sk.count == 3
        assert sk.missing == 3
        assert sk.missing_rate() == 0.5
        assert sk.mean() == pytest.approx(2.0)
        assert sk.min == 1.0 and sk.max == 3.0
        # Quantile reports the bucket upper bound holding the exact one
        # (within one growth factor above): p0+ must be >= the min's
        # bucket, p100 <= max's bucket bound.
        assert sk.quantile(0.0) >= 1.0
        assert sk.quantile(1.0) >= 3.0

    def test_empty_summary_is_none(self):
        sk = DistSketch()
        assert sk.mean() is None
        assert sk.quantile(0.5) is None
        assert sk.missing_rate() is None

    def test_merge_commutative_and_associative(self):
        # Integer-valued observations: float sums are exact, so the
        # algebra laws hold EXACTLY, not approximately.
        rng = np.random.default_rng(7)
        chunks = [
            rng.integers(-50, 50, size=200).astype(np.float64)
            for _ in range(3)
        ]
        sketches = []
        for c in chunks:
            sk = DistSketch()
            sk.observe(c)
            sketches.append(sk)

        def clone(s):
            return DistSketch.from_dict(s.to_dict())

        ab_c = clone(sketches[0]).merge(clone(sketches[1])).merge(
            clone(sketches[2]))
        a_bc = clone(sketches[0]).merge(
            clone(sketches[1]).merge(clone(sketches[2])))
        ba = clone(sketches[1]).merge(clone(sketches[0]))
        ab = clone(sketches[0]).merge(clone(sketches[1]))
        assert ab_c.to_bytes_like() == a_bc.to_bytes_like()
        assert ab.to_bytes_like() == ba.to_bytes_like()

    def test_serialization_round_trip_byte_stable(self):
        sk = DistSketch()
        sk.observe(np.asarray([0.1, -2.5, 1e5, 3.14159], np.float64))
        raw = json.dumps(
            sk.to_dict(), sort_keys=True, separators=(",", ":"))
        again = DistSketch.from_dict(json.loads(raw))
        raw2 = json.dumps(
            again.to_dict(), sort_keys=True, separators=(",", ":"))
        assert raw == raw2

    def test_merge_bounds_mismatch_raises(self):
        a = DistSketch()
        b = DistSketch(signed_log_bounds(per_decade=1))
        with pytest.raises(ValueError, match="bucket bounds"):
            a.merge(b)


# Comparable canonical bytes for a bare DistSketch (tests only — the
# product contract is DataSketch.to_bytes).
def _dist_bytes(self):
    return json.dumps(
        self.to_dict(), sort_keys=True, separators=(",", ":")
    ).encode()


DistSketch.to_bytes_like = _dist_bytes


# ---------------------------------------------------------------------------
# PSI / KS
# ---------------------------------------------------------------------------


class TestDriftScores:
    def test_psi_zero_on_identical(self):
        sk = DistSketch()
        sk.observe(np.random.default_rng(0).normal(size=500))
        assert psi(sk.counts, sk.counts) == 0.0
        assert ks(sk.counts, sk.counts) == 0.0

    def test_psi_symmetric(self):
        rng = np.random.default_rng(1)
        a, b = DistSketch(), DistSketch()
        a.observe(rng.normal(size=1000))
        b.observe(rng.normal(size=1000) + 2.0)
        assert psi(a.counts, b.counts) == pytest.approx(
            psi(b.counts, a.counts))

    def test_psi_fires_on_shift_not_on_resample(self):
        rng = np.random.default_rng(2)
        a, b, c = DistSketch(), DistSketch(), DistSketch()
        a.observe(rng.normal(size=4000))
        b.observe(rng.normal(size=4000))  # same distribution
        c.observe(rng.normal(size=4000) + 4.0)  # shifted
        assert psi(a.counts, b.counts) < 0.1
        assert psi(a.counts, c.counts) > 1.0
        assert ks(a.counts, c.counts) > 0.5

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError, match="aligned"):
            psi([1, 2], [1, 2, 3])
        with pytest.raises(ValueError, match="aligned"):
            ks([1, 2], [1, 2, 3])

    def test_empty_histogram_scores_zero(self):
        assert psi([0, 0], [1, 2]) == 0.0
        assert ks([0, 0], [1, 2]) == 0.0


# ---------------------------------------------------------------------------
# FeatureMoments
# ---------------------------------------------------------------------------


class TestFeatureMoments:
    def test_matches_reference_loop(self):
        rng = np.random.default_rng(3)
        idx = rng.integers(0, 6, size=(50, 3))
        val = rng.normal(size=(50, 3))
        val[val == 0.0] = 1.0
        fm = FeatureMoments(6)
        fm.update(idx, val)
        counts = np.zeros(7)
        sums = np.zeros(7)
        for i, v in zip(idx.reshape(-1), val.reshape(-1)):
            counts[i] += 1
            sums[i] += v
        np.testing.assert_array_equal(fm.counts, counts.astype(np.int64))
        np.testing.assert_allclose(fm.sums, sums)

    def test_zero_values_are_padding(self):
        fm = FeatureMoments(4)
        fm.update(np.asarray([[0, 0]]), np.asarray([[1.5, 0.0]]))
        assert fm.counts[0] == 1  # the 0.0 slot is ELL padding

    def test_overflow_cap_pools(self):
        fm = FeatureMoments(100, cap=4)
        fm.update(np.asarray([2, 50, 99]), np.asarray([1.0, 2.0, 3.0]))
        assert fm.counts[2] == 1
        assert fm.counts[4] == 2  # 50 and 99 pooled into the cap slot
        assert fm.sums[4] == pytest.approx(5.0)

    def test_dense_requests_share_zero_is_absent_semantics(self):
        # The serve tap's dense fold uses the SAME zero-is-absent
        # convention as the sparse/ELL train side (ingest drops
        # explicit zeros at decode) — otherwise identical traffic
        # would read as skew against the training sketch.
        ds = DataSketch()
        ds.update_requests_dense(
            "s", np.asarray([[0.0, 1.0, 2.0], [0.0, 0.0, 4.0]]))
        blk = ds.shards["s"]
        np.testing.assert_array_equal(
            blk["moments"].counts[:3], [0, 1, 2])
        np.testing.assert_allclose(
            blk["moments"].sums[:3], [0.0, 1.0, 6.0])
        assert blk["values"].count == 3  # zeros are absent, not 0.0
        assert blk["nnz"].mean() == pytest.approx(1.5)

    def test_merge_shape_mismatch_raises(self):
        with pytest.raises(ValueError, match="shapes"):
            FeatureMoments(4).merge(FeatureMoments(5))


# ---------------------------------------------------------------------------
# DataSketch + compare
# ---------------------------------------------------------------------------


def _window(rng, n=200, d=8, shift=0.0):
    idx = rng.integers(0, d, size=(n, 3))
    val = rng.normal(size=(n, 3)) + shift
    return (
        rng.normal(size=n) + shift, np.zeros(n), np.ones(n),
        {"s": (idx, val)}, {"s": d},
    )


class TestDataSketch:
    def test_update_merge_and_byte_stability(self, tmp_path):
        rng = np.random.default_rng(4)
        whole = DataSketch()
        parts = [DataSketch(), DataSketch()]
        w1 = _window(rng, n=100)
        w2 = _window(rng, n=150)
        for sk, w in ((parts[0], w1), (parts[1], w2)):
            sk.update_window(*w)
        whole.update_window(*w1)
        whole.update_window(*w2)
        merged = DataSketch.from_dict(parts[0].to_dict()).merge(parts[1])
        assert merged.to_bytes() == whole.to_bytes()
        path = str(tmp_path / "sketch.json")
        whole.save(path)
        loaded = DataSketch.load(path)
        assert loaded.to_bytes() == whole.to_bytes()

    def test_schema_version_refused(self):
        with pytest.raises(ValueError, match="schema_version"):
            DataSketch.from_dict({"schema_version": 99, "rows": 0})

    def test_compare_identical_vs_shifted(self):
        rng = np.random.default_rng(5)
        a, b, c = DataSketch(), DataSketch(), DataSketch()
        a.update_window(*_window(rng, n=2000))
        b.update_window(*_window(rng, n=2000))
        c.update_window(*_window(rng, n=2000, shift=4.0))
        same = compare(a, b)
        moved = compare(a, c)
        assert same["max_psi"] < 0.1
        assert moved["max_psi"] > 1.0
        assert moved["max_psi_surface"] is not None
        tops = moved["shards"]["s"]["top_moved_features"]
        assert tops and tops[0]["mean_shift"] > 1.0
        # The renderer covers every compared surface.
        text = health.render_comparison(moved)
        assert "column:label" in text and "shard:s/values" in text

    def test_compare_intersection_only(self):
        a, b = DataSketch(), DataSketch()
        a.column("label").observe(np.asarray([1.0]))
        b.column("score").observe(np.asarray([0.5]))
        rep = compare(a, b)
        assert rep["columns"] == {}


# ---------------------------------------------------------------------------
# calibration / ECE
# ---------------------------------------------------------------------------


class TestCalibration:
    def test_ece_hand_computed(self):
        # Two bins. Bin0: preds (0.2, 0.2) labels (0, 1): conf 0.2,
        # acc 0.5 -> |0.3| * 2. Bin1: preds (0.8, 0.8) labels (1, 1):
        # conf 0.8, acc 1.0 -> |0.2| * 2. ECE = (0.6 + 0.4) / 4 = 0.25.
        cal = CalibrationSketch(bins=2)
        cal.update(np.asarray([0.2, 0.2, 0.8, 0.8]),
                   np.asarray([0.0, 1.0, 1.0, 1.0]))
        assert cal.ece() == pytest.approx(0.25)

    def test_perfectly_calibrated_is_zero(self):
        cal = CalibrationSketch(bins=1)
        cal.update(np.asarray([0.5, 0.5]), np.asarray([0.0, 1.0]))
        assert cal.ece() == pytest.approx(0.0)

    def test_empty_is_none_and_merge(self):
        assert CalibrationSketch().ece() is None
        a, b = CalibrationSketch(bins=2), CalibrationSketch(bins=2)
        a.update(np.asarray([0.2]), np.asarray([0.0]))
        b.update(np.asarray([0.8]), np.asarray([1.0]))
        whole = CalibrationSketch(bins=2)
        whole.update(np.asarray([0.2, 0.8]), np.asarray([0.0, 1.0]))
        assert a.merge(b).ece() == pytest.approx(whole.ece())
        with pytest.raises(ValueError, match="bin"):
            a.merge(CalibrationSketch(bins=3))

    def test_top_edge_clips_into_last_bin(self):
        cal = CalibrationSketch(bins=10)
        cal.update(np.asarray([1.0]), np.asarray([1.0]))
        assert cal.counts[9] == 1

    def test_calibration_sink_binary_only(self):
        from photon_tpu_torch.types import TaskType

        assert health.calibration_sink(TaskType.LINEAR_REGRESSION) is None
        pair = health.calibration_sink(TaskType.LOGISTIC_REGRESSION)
        assert pair is not None
        cal, sink = pair
        # Margin 0 -> p = 0.5; huge margins clip finite.
        sink(np.asarray([0.0, 100.0]), np.asarray([1.0, 1.0]))
        assert cal.counts.sum() == 2
        assert cal.ece() is not None and math.isfinite(cal.ece())


# ---------------------------------------------------------------------------
# coefficient movement + model scan
# ---------------------------------------------------------------------------


def _model_arrays(fe, re_rows, entity_keys):
    """The reference test's logistic GLMix (a fixed effect on
    ``features`` and a per-user table whose projector is the identity)
    as npz-checkpoint arrays and manifest."""
    s = re_rows.shape[1]
    arrays = {
        "global/means": np.asarray(fe, dtype=np.float32),
        "per-user/coefficients": np.asarray(re_rows, dtype=np.float32),
        "per-user/proj_all": np.tile(
            np.arange(s), (re_rows.shape[0], 1)).astype(np.int64),
    }
    task = "LOGISTIC_REGRESSION"
    manifest = {
        "global": {"kind": "fixed", "shard": "features", "task": task},
        "per-user": {"kind": "random", "re_type": "userId",
                     "shard": "features", "task": task,
                     "entity_keys": list(entity_keys)},
    }
    return arrays, manifest


def _game_model(fe, re_rows, entity_keys):
    return model_io.game_model_from_numpy(
        *_model_arrays(fe, re_rows, entity_keys), "cpu")

class TestCoefficientMovement:
    def test_norms_and_top_entities(self):
        old = _game_model(
            np.zeros(4), np.zeros((3, 2)), ("a", "b", "c"))
        new = _game_model(
            np.asarray([3.0, 4.0, 0.0, 0.0]),
            np.asarray([[0.0, 0.0], [6.0, 8.0], [0.0, 1.0]]),
            ("a", "b", "c"),
        )
        m = coefficient_movement(old, new)
        assert m["global"]["l2"] == pytest.approx(5.0)
        assert m["global"]["linf"] == pytest.approx(4.0)
        top = m["per-user"]["top_moved_entities"]
        assert top[0]["entity"] == "b"
        assert top[0]["l2"] == pytest.approx(10.0)
        # rel_l2 vs a zero old norm reports the raw scale.
        assert m["per-user"]["rel_l2"] > 1.0

    def test_structure_change_is_flagged_not_compared(self):
        old = _game_model(np.zeros(4), np.zeros((3, 2)), ("a", "b", "c"))
        new = _game_model(
            np.zeros(4), np.zeros((4, 2)), ("a", "b", "c", "d"))
        m = coefficient_movement(old, new)
        assert m["per-user"]["structure_changed"] is True

    def test_scan_model_flags_nonfinite(self):
        ok = _game_model(np.zeros(4), np.zeros((2, 2)), ("a", "b"))
        assert health.scan_model(ok) == []
        bad = _game_model(
            np.asarray([0.0, np.nan, 0.0, np.inf]),
            np.zeros((2, 2)), ("a", "b"))
        msgs = health.scan_model(bad)
        assert len(msgs) == 1
        assert "global" in msgs[0] and "2 non-finite" in msgs[0]


# ---------------------------------------------------------------------------
# numerics sentinels
# ---------------------------------------------------------------------------


class TestSentinels:
    def test_report_names_coordinate_metric_iteration(self):
        health.enable()
        arr = np.zeros((3, 2, 5))
        arr[1, 0, 1] = np.nan  # iter 1, coord 0, metric grad_norm
        arr[2, 1, 4] = np.inf  # iter 2, coord 1, metric weight_norm_sq
        health.sentinel_watch(("fe", "re"), arr)
        rep = health.numerics_report()
        assert rep["fits_scanned"] == 1
        assert rep["nonfinite_total"] == 2
        by_coord = {v["coordinate"]: v for v in rep["violations"]}
        assert by_coord["fe"]["metric"] == "grad_norm"
        assert by_coord["fe"]["first_iteration"] == 1
        assert by_coord["re"]["metric"] == "weight_norm_sq"

    def test_since_seq_windows_out_old_fits(self):
        health.enable()
        bad = np.full((1, 1, 5), np.nan)
        health.sentinel_watch(("c",), bad)
        mark = health.sentinel_seq()
        health.sentinel_watch(("c",), np.zeros((1, 1, 5)))
        rep = health.numerics_report(since_seq=mark)
        assert rep["fits_scanned"] == 1
        assert rep["nonfinite_total"] == 0
        # The full scan still sees the old violation.
        assert health.numerics_report()["nonfinite_total"] == 5

    def test_parked_tensor_copies_to_host_at_report_time(self):
        """The port parks a tensor and copies it (``.cpu()``) only when
        a report reads it; the copy is cached for later reports."""
        import torch

        health.enable()
        block = torch.zeros((2, 1, 5), dtype=torch.float64)
        block[1, 0, 0] = float("nan")
        health.sentinel_watch(("c",), block)
        assert health.raw_snapshot()["sentinels_parked"] == 1
        rep = health.numerics_report()
        assert rep["nonfinite_total"] == 1
        assert rep["violations"][0]["metric"] == "loss"
        assert rep["violations"][0]["first_iteration"] == 1
        assert health.numerics_report() == rep


# ---------------------------------------------------------------------------
# serve tap
# ---------------------------------------------------------------------------


class TestServeTap:
    def test_disabled_is_noop(self):
        health.observe_serve_batch(
            [{"s": np.zeros(3, np.float32)}], np.asarray([0.5]))
        snap = health.serve_snapshot()
        assert snap["batches_seen"] == 0
        assert snap["requests_sampled"] == 0

    def test_sample_rate_and_sketch_contents(self):
        health.enable()
        health.set_serve_sample_every(2)
        for i in range(4):
            health.observe_serve_batch(
                [
                    {"dense": np.full(3, float(i), np.float32),
                     "sparse": (np.asarray([0, 2], np.int32),
                                np.asarray([1.0, 2.0], np.float32))},
                ],
                np.asarray([0.1 * i]),
            )
        snap = health.serve_snapshot()
        assert snap["batches_seen"] == 4
        assert snap["batches_sampled"] == 2  # every 2nd batch
        assert snap["requests_sampled"] == 2
        sk = health.serve_sketch()
        assert sk.columns["score"].count == 2
        assert set(sk.shards) == {"dense", "sparse"}
        # Zero-is-absent on BOTH layouts: the i=0 batch's all-zero
        # dense vector contributes nothing; the i=2 batch's three 2.0s
        # do. Sparse values are nonzero by construction.
        assert sk.shards["dense"]["values"].count == 3
        assert sk.shards["sparse"]["values"].count == 4

    def test_save_serve_sketch_round_trips(self, tmp_path):
        health.enable()
        health.set_serve_sample_every(1)
        health.observe_serve_batch(
            [{"s": np.ones(2, np.float32)}], np.asarray([1.5]))
        path = str(tmp_path / "serve.json")
        n = health.save_serve_sketch(path)
        assert n == 1
        assert DataSketch.load(path).columns["score"].count == 1

    def test_sample_every_validation(self):
        with pytest.raises(ValueError):
            health.set_serve_sample_every(0)

    def test_queue_feeds_tap_when_armed(self):
        """End to end through the port's micro-batch queue on the CPU:
        armed health samples dispatched batches (features + served
        scores)."""
        from photon_tpu_torch.serve.driver import synthetic_requests
        from photon_tpu_torch.serve.programs import ScorePrograms, ShapeLadder
        from photon_tpu_torch.serve.queue import MicroBatchQueue
        from photon_tpu_torch.serve.tables import CoefficientTables

        model = _game_model(
            np.asarray([0.5, -0.5, 0.0, 0.25]),
            np.zeros((2, 2), np.float32), ("u0", "u1"))
        tables = CoefficientTables.from_game_model(model, "float32", "cpu")
        programs = ScorePrograms(tables, ladder=ShapeLadder((1, 4)))
        requests = synthetic_requests(
            tables, programs, 4, cold_fraction=0.0, seed=1)
        health.enable()
        health.set_serve_sample_every(1)
        with MicroBatchQueue(programs, max_linger_s=0.001) as queue:
            futs = [
                queue.submit(feats, ids) for feats, ids in requests
            ]
            for f in futs:
                f.result(timeout=10)
        snap = health.serve_snapshot()
        assert snap["requests_sampled"] == 4
        assert health.serve_sketch().columns["score"].count == 4

    def test_raising_tap_is_logged_and_the_batch_served(
            self, monkeypatch, caplog):
        """A tap that raises must not strand the futures: the queue logs
        it and serves the batch."""
        from photon_tpu_torch.serve.driver import synthetic_requests
        from photon_tpu_torch.serve.programs import ScorePrograms, ShapeLadder
        from photon_tpu_torch.serve.queue import MicroBatchQueue
        from photon_tpu_torch.serve.tables import CoefficientTables

        def boom(*a, **k):
            raise RuntimeError("tap exploded")

        model = _game_model(np.ones(4), np.zeros((2, 2)), ("u0", "u1"))
        tables = CoefficientTables.from_game_model(model, "float32", "cpu")
        programs = ScorePrograms(tables, ladder=ShapeLadder((1, 4)))
        health.enable()
        monkeypatch.setattr(health, "observe_serve_batch", boom)
        with MicroBatchQueue(programs, max_linger_s=0.0) as queue:
            futs = [queue.submit(f, i) for f, i in synthetic_requests(
                tables, programs, 6, cold_fraction=0.0, seed=2)]
            scores = [f.result(timeout=10) for f in futs]
        assert len(scores) == 6 and all(np.isfinite(scores))
        assert "serve health tap failed" in caplog.text


# ---------------------------------------------------------------------------
# gate policy
# ---------------------------------------------------------------------------


class TestHealthGatePolicy:
    def test_each_threshold_produces_its_reason(self):
        policy = HealthGatePolicy(
            max_drift_psi=0.2, max_skew_psi=0.3, max_ece=0.1,
            max_coefficient_rel_l2=1.0, forbid_nonfinite=True,
            min_skew_requests=1,
        )
        reasons = policy.evaluate(
            drift={"max_psi": 0.5, "max_psi_surface": "column:label"},
            skew={"max_psi": 0.9, "max_psi_surface": "shard:s/values"},
            skew_requests=10,
            ece=0.4,
            movement={"per-user": {"rel_l2": 3.0}},
            nonfinite={
                "nonfinite_total": 2,
                "violations": [{
                    "coordinate": "fe", "metric": "loss",
                    "first_iteration": 0, "count": 2,
                }],
            },
            model_scan=["coordinate 'fe': 1 non-finite coefficient(s)"],
        )
        assert len(reasons) == 6
        assert all(r.startswith("health:") for r in reasons)
        kinds = {r.split(" ")[0] for r in reasons}
        assert kinds == {
            "health:drift", "health:skew", "health:calibration",
            "health:coefficients", "health:numerics",
        }

    def test_healthy_inputs_pass(self):
        policy = HealthGatePolicy(
            max_drift_psi=0.5, max_skew_psi=0.5, max_ece=0.5,
            max_coefficient_rel_l2=10.0,
        )
        assert policy.evaluate(
            drift={"max_psi": 0.01, "max_psi_surface": "x"},
            skew={"max_psi": 0.01, "max_psi_surface": "x"},
            skew_requests=1000,
            ece=0.05,
            movement={"c": {"rel_l2": 0.1}},
            nonfinite={"nonfinite_total": 0, "violations": []},
        ) == []

    def test_skew_skipped_below_min_requests(self):
        policy = HealthGatePolicy(
            max_drift_psi=None, max_skew_psi=0.1, min_skew_requests=64)
        assert policy.evaluate(
            skew={"max_psi": 5.0, "max_psi_surface": "x"},
            skew_requests=3,
        ) == []

    def test_absent_surfaces_never_guess(self):
        assert HealthGatePolicy().evaluate() == []

    def test_structure_change_skips_movement_gate(self):
        policy = HealthGatePolicy(max_coefficient_rel_l2=0.1)
        assert policy.evaluate(
            movement={"c": {"structure_changed": True}}) == []


# ---------------------------------------------------------------------------
# evaluation coverage helper
# ---------------------------------------------------------------------------


class TestUndefinedGroups:
    def test_counts_and_mean_over_defined_only(self):
        out = count_undefined_groups({
            "AUC": np.asarray([0.5, np.nan, 0.9, np.nan]),
        })
        assert out["AUC"]["groups"] == 4
        assert out["AUC"]["undefined_groups"] == 2
        assert out["AUC"]["mean_defined"] == pytest.approx(0.7)

    def test_all_undefined_mean_is_none(self):
        out = count_undefined_groups({"AUC": np.asarray([np.nan])})
        assert out["AUC"]["mean_defined"] is None
        assert out["AUC"]["undefined_groups"] == 1


# ---------------------------------------------------------------------------
# streaming-ingest sketches: persistence + kill-and-resume identity
# ---------------------------------------------------------------------------


from photon_tpu_torch.data.stream import (  # noqa: E402
    SKETCH_FILE,
    StreamingIngest,
)
from photon_tpu_torch.io.avro_data import (  # noqa: E402
    read_training_examples,
    write_training_examples,
)
from photon_tpu_torch.resilience import (  # noqa: E402
    FaultPlan,
    InjectedCrash,
    faults,
)
from photon_tpu_torch.types import DELIMITER  # noqa: E402

def _write_shards(shard_dir, *, n_per=30, shards=4, d=4, seed=9):
    os.makedirs(shard_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = 0
    for si in range(shards):
        y = rng.normal(size=n_per)
        rows = [
            [(f"f{j}{DELIMITER}t", float(rng.normal()))
             for j in rng.choice(d, size=2, replace=False)]
            for _ in range(n_per)
        ]
        meta = [{"userId": f"u{rng.integers(0, 5)}"}
                for _ in range(n_per)]
        write_training_examples(
            os.path.join(shard_dir, f"part-{si:05d}.avro"),
            y, rows, metadata=meta,
            uids=np.arange(base, base + n_per),
        )
        base += n_per
    return shard_dir


class TestStreamSketches:
    def test_disarmed_run_writes_no_sketch(self, tmp_path):
        shard_dir = _write_shards(str(tmp_path / "shards"))
        _, imap = read_training_examples(shard_dir, device="cpu")
        work = tmp_path / "off"
        _, stats = StreamingIngest(
            shard_dir, work_dir=str(work),
            index_maps={"features": imap}, id_tag_names=["userId"],
            device="cpu",
        ).run()
        assert not (work / SKETCH_FILE).exists()
        assert "health_sketch_path" not in stats

    def test_armed_run_sketches_every_row(self, tmp_path):
        shard_dir = _write_shards(str(tmp_path / "shards"))
        _, imap = read_training_examples(shard_dir, device="cpu")
        health.enable()
        work = tmp_path / "on"
        _, stats = StreamingIngest(
            shard_dir, work_dir=str(work),
            index_maps={"features": imap}, id_tag_names=["userId"],
            device="cpu",
        ).run()
        path = stats["health_sketch_path"]
        assert path == str(work / SKETCH_FILE)
        sketch = DataSketch.load(path)
        assert sketch.rows == 30 * 4
        assert set(sketch.columns) == {"label", "offset", "weight"}
        # 2 drawn features + the intercept slot per row (the decoder
        # appends (intercept_index, 1.0), matching read_merged).
        assert sketch.shards["features"]["values"].count == 30 * 4 * 3
        # The run also registers the in-process train reference.
        assert health.train_sketch() is not None
        assert health.train_sketch().rows == sketch.rows

    def test_kill_and_resume_sketch_byte_identical(self, tmp_path):
        """The satellite contract: a killed-and-resumed window ingest
        reproduces the UNINTERRUPTED run's sketch byte for byte (the
        resumed windows re-fold from their spills in window order)."""
        shard_dir = _write_shards(str(tmp_path / "shards"))
        _, imap = read_training_examples(shard_dir, device="cpu")
        health.enable()

        def ingest(work, resume=False):
            return StreamingIngest(
                shard_dir, work_dir=str(work),
                index_maps={"features": imap},
                id_tag_names=["userId"], window_shards=1,
                resume=resume, device="cpu",
            )

        uninterrupted = tmp_path / "whole"
        ingest(uninterrupted).run()
        want = DataSketch.load(
            str(uninterrupted / SKETCH_FILE)).to_bytes()

        killed = tmp_path / "killed"
        with faults.injected(FaultPlan(
            [dict(point="io.shard_read", nth=3, error="crash")]
        )):
            with pytest.raises(InjectedCrash):
                ingest(killed).run()
        # The partial sketch committed beside the cursor covers the
        # committed windows only.
        partial = DataSketch.load(str(killed / SKETCH_FILE))
        assert 0 < partial.rows < 120
        ingest(killed, resume=True).run()
        got = DataSketch.load(str(killed / SKETCH_FILE)).to_bytes()
        assert got == want


# ---------------------------------------------------------------------------
# monitor + exporter surfaces
# ---------------------------------------------------------------------------


class TestSurfaces:
    def test_families_empty_when_disabled(self):
        assert health.metrics_families() == []

    def test_families_render_and_validate(self):
        from photon_tpu_torch.obs.monitor import (
            render_exposition,
            validate_exposition,
        )

        health.enable()
        health.record_gate({
            "reasons": ["health:drift PSI 0.5 > 0.25 on column:label"],
            "drift": {"max_psi": 0.5, "max_psi_surface": "column:label"},
            "skew": None,
            "ece": 0.12,
        })
        fams = health.metrics_families()
        names = {f["name"] for f in fams}
        assert {"health_enabled", "health_gate_violations",
                "health_drift_max_psi", "health_ece"} <= names
        validate_exposition(render_exposition(fams))

    def test_monitor_render_includes_health(self):
        from photon_tpu_torch.obs.monitor import MonitorServer

        health.enable()
        text = MonitorServer(0).render()
        assert "health_enabled 1" in text

    def test_snapshot_and_flight_sections(self):
        from photon_tpu_torch import obs

        health.enable()
        health.sentinel_watch(("c",), np.zeros((1, 1, 5)))
        snap = obs.snapshot()
        assert snap["health"]["sentinels_parked"] == 1
        assert snap["health"]["numerics"]["nonfinite_total"] == 0
        raw = health.raw_snapshot()
        assert "numerics" not in raw  # crash path never materializes


class TestReviewFixes:
    """Regression pins for the review pass: non-finite calibration
    inputs, the serve-tap window, and spec-sized sparse moments."""

    def test_calibration_nonfinite_counts_missing_not_crash(self):
        cal = CalibrationSketch(bins=2)
        cal.update(
            np.asarray([np.nan, 0.2, np.inf, 0.8]),
            np.asarray([1.0, 0.0, 1.0, np.nan]),
        )
        # Only the one fully-finite pair binned; three pairs missing.
        assert int(cal.counts.sum()) == 1
        assert cal.missing == 3
        assert math.isfinite(cal.ece())
        # The sink path survives a NaN-scoring candidate end to end —
        # the gate (not a bincount crash) gets to judge it.
        from photon_tpu_torch.types import TaskType

        sk, sink = health.calibration_sink(
            TaskType.LOGISTIC_REGRESSION)
        sink(np.asarray([np.nan, 0.0]), np.asarray([1.0, 1.0]))
        assert sk.missing == 1 and int(sk.counts.sum()) == 1
        # Round-trips carry the missing counter.
        assert CalibrationSketch.from_dict(sk.to_dict()).missing == 1

    def test_serve_mark_windows_the_tap(self):
        health.enable()
        health.set_serve_sample_every(1)

        def fold(value, n=8):
            health.observe_serve_batch(
                [{"s": np.full(3, value, np.float32)}
                 for _ in range(n)],
                np.full(n, value),
            )

        fold(0.0, n=64)  # "a month of history"
        mark = health.serve_mark()
        fold(100.0, n=8)  # the fresh shift
        whole = health.serve_sketch()
        window = health.serve_sketch(since=mark)
        assert whole.rows == 72
        assert window.rows == 8
        # In the window the shift is the WHOLE distribution; in the
        # cumulative tap it is 1/9 of the mass — diluted.
        assert window.columns["score"].mean() == pytest.approx(100.0)
        train = DataSketch()
        train.column("score").observe(np.zeros(64))
        psi_window = compare(train, window)["max_psi"]
        psi_whole = compare(train, whole)["max_psi"]
        assert psi_window > psi_whole

    def test_sparse_tap_moments_sized_by_spec_width(self):
        health.enable()
        health.set_serve_sample_every(1)
        # First sampled batch touches only low indices; the WIDTHS
        # argument (the serving spec's feature-space size) must size
        # the moments anyway, so they align with a training sketch's
        # vocabulary-sized moments.
        health.observe_serve_batch(
            [{"s": (np.asarray([0, 2], np.int32),
                    np.asarray([1.0, 2.0], np.float32))}],
            np.asarray([0.5]),
            widths={"s": 100},
        )
        serve = health.serve_sketch()
        assert serve.shards["s"]["moments"].num_features == 100
        train = DataSketch()
        train.update_window(
            np.asarray([1.0]), np.zeros(1), np.ones(1),
            {"s": (np.asarray([[50]]), np.asarray([[3.0]]))},
            {"s": 100},
        )
        rep = compare(train, serve)
        assert "top_moved_features" in rep["shards"]["s"]

    def test_dist_diff_exact_on_counts_and_moments(self):
        rng = np.random.default_rng(8)
        a = DistSketch()
        a.observe(rng.integers(-20, 20, size=100).astype(np.float64))
        base = a.clone()
        tail = rng.integers(-20, 20, size=50).astype(np.float64)
        a.observe(tail)
        d = a.diff_from(base)
        want = DistSketch()
        want.observe(tail)
        np.testing.assert_array_equal(d.counts, want.counts)
        assert d.count == want.count
        assert d.sum == pytest.approx(want.sum)
        assert d.mean() == pytest.approx(want.mean())


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def _fill(mod, seed, shift=0.0):
    """One seeded DataSketch in ``mod``'s package: two train windows,
    serve-side dense and sparse requests and a score column."""
    rng = np.random.default_rng(seed)
    sk = mod.DataSketch()
    for n in (120, 80):
        sk.update_window(*_window(rng, n=n, shift=shift))
    sk.update_requests_dense(
        "dense", rng.normal(size=(30, 5)) * (rng.uniform(size=(30, 5)) > 0.3))
    sk.update_requests_sparse(
        "sparse", rng.integers(0, 50, size=60),
        rng.normal(size=60) + shift, 50, 20)
    sk.column("score").observe(
        np.concatenate([rng.normal(size=40), [np.nan, np.inf]]))
    return sk


class TestMatchesReference:
    def test_data_sketch_bytes_equal(self):
        from photon_tpu.obs import health as jax_health

        ours, theirs = _fill(health, 31), _fill(jax_health, 31)
        assert ours.to_bytes() == theirs.to_bytes()
        # Each package loads the other's bytes to the same bytes.
        assert (jax_health.DataSketch.from_dict(json.loads(
            ours.to_bytes())).to_bytes() == theirs.to_bytes())
        assert health.DataSketch.from_dict(json.loads(
            theirs.to_bytes())).to_bytes() == ours.to_bytes()

    def test_calibration_summary_bytes_equal(self):
        from photon_tpu.obs import health as jax_health
        from photon_tpu.types import TaskType as JaxTaskType
        from photon_tpu_torch.types import TaskType

        rng = np.random.default_rng(32)
        margins = rng.normal(scale=3.0, size=500)
        labels = (rng.uniform(size=500) < 0.4).astype(np.float64)
        margins[:3] = np.nan
        ours, sink = health.calibration_sink(TaskType.LOGISTIC_REGRESSION)
        theirs, jsink = jax_health.calibration_sink(
            JaxTaskType.LOGISTIC_REGRESSION)
        sink(margins, labels)
        jsink(margins, labels)
        assert _canonical(ours.summary()) == _canonical(theirs.summary())
        assert _canonical(ours.to_dict()) == _canonical(theirs.to_dict())

    def test_compare_report_bytes_equal(self):
        from photon_tpu.obs import health as jax_health

        ours = health.compare(_fill(health, 33), _fill(health, 34, 1.5))
        theirs = jax_health.compare(
            _fill(jax_health, 33), _fill(jax_health, 34, 1.5))
        assert ours["max_psi"] > 0.1
        assert _canonical(ours) == _canonical(theirs)
        assert health.render_comparison(ours) == (
            jax_health.render_comparison(theirs))

    def test_coefficient_movement_matches_within_1e_12(self, tmp_path):
        from photon_tpu.io import model_io as jax_model_io
        from photon_tpu.obs import health as jax_health

        rng = np.random.default_rng(35)
        keys = tuple(f"u{i}" for i in range(6))
        pair = []
        for name, scale in (("old", 1.0), ("new", 1.3)):
            model = _game_model(rng.normal(size=4) * scale,
                                rng.normal(size=(6, 3)) * scale, keys)
            path = model_io.save_checkpoint(model, str(tmp_path / name))
            pair.append((model, jax_model_io.load_checkpoint(path)))
        ours = coefficient_movement(pair[0][0], pair[1][0], top_k=4)
        theirs = jax_health.coefficient_movement(
            pair[0][1], pair[1][1], top_k=4)
        assert set(ours) == set(theirs) == {"global", "per-user"}
        for cid in ours:
            for key in ("l2", "linf", "norm_old", "rel_l2"):
                assert ours[cid][key] == pytest.approx(
                    theirs[cid][key], abs=1e-12, rel=0)
        top = [e["entity"] for e in ours["per-user"]["top_moved_entities"]]
        assert top == [e["entity"] for e in
                       theirs["per-user"]["top_moved_entities"]]
        assert health.scan_model(pair[1][0]) == jax_health.scan_model(
            pair[1][1]) == []
