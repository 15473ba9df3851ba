"""The port's pilot (``photon_tpu_torch.pilot``, ``cli.pilot``) against the
JAX package's, on the CPU.

- The 27 cases of ``tests/test_pilot.py`` on the port: the state file,
  the generation ring, the promotion gate, the cycle, chaos at every
  stage, the serve-layer swap it promotes through, a real SIGTERM'd
  ``python -m photon_tpu_torch.cli.pilot --device cpu`` subprocess
  between the ring commit and the reload, and ``evaluate_model``. The
  reload-machinery cases that ``tests/test_torch_serve_degraded.py``
  already runs on the bare queue are parametrised over the bare queue
  and the ``PilotServer``. On the CPU nothing is captured: a structure
  change captures 0 graphs here and one a rung on the card (the ``cuda``
  cases).
- ``tests/test_health.py``'s ``TestPilotHealthGate`` and
  ``TestPilotHealthConfig``.
- Both packages' ``Pilot`` on the same shards, bootstrap then one more
  cycle: in float64 (the conftest's x64) the same stage sequence,
  counters and gate reasons, every generation's coefficients and every
  evaluation within 1e-12; in float32 the same gate outcomes and the
  coefficients within PR 5's f32 bounds (fixed effect 5e-4, random
  effects 2e-3; CHANGES.md).
- On-disk formats: a work dir the reference's pilot wrote (parked
  mid-PROMOTE) is resumed by the port's, and the port's
  ``pilot-state.json``, ``ring.json`` and ``pilot-vocab.json`` are read
  by the reference's ``load_state``, ``GenerationRing`` and ``Pilot``,
  byte for byte as the reference writes them.
- Both CLIs on one config file: equal exit codes, the same exit JSON
  keys and counters.
- Every ``pilot.*`` fault point fires; a candidate with a NaN
  coefficient is refused through ``scan_model`` while the numerics
  sentinels scanned no fit (the port has no fused fit: ROADMAP item 8).

The shards come from the reference's own writers (``write_day``,
``write_training_examples``; ``_write_pilot_day`` for the health
cases). The JAX side is imported where it is used, so the ``cuda``
cases run without JAX (``--noconftest -m cuda``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from photon_tpu_torch import optim
from photon_tpu_torch.algorithm.problems import GLMOptimizationConfiguration
from photon_tpu_torch.data.random_effect import RandomEffectDataConfiguration
from photon_tpu_torch.estimators.game_estimator import (
    FixedEffectCoordinateConfiguration,
    GameEstimator,
    RandomEffectCoordinateConfiguration,
)
from photon_tpu_torch.evaluation.evaluators import EvaluatorSpec
from photon_tpu_torch.obs import health
from photon_tpu_torch.pilot import (
    GenerationRing,
    HealthGatePolicy,
    MODE_SERVE_ONLY,
    ObservePolicy,
    Pilot,
    PilotConfig,
    PilotServer,
    PilotState,
    PromotionGate,
    load_state,
)
from photon_tpu_torch.pilot.state import commit_state
from photon_tpu_torch.resilience import (
    FaultPlan,
    InjectedCrash,
    faults,
    reset_retry_stats,
    retry_stats,
)
from photon_tpu_torch.resilience.errors import CorruptModelError
from photon_tpu_torch.serve.queue import MicroBatchQueue
from photon_tpu_torch.types import TaskType

REPO_ROOT = Path(__file__).resolve().parents[1]
# Two f32 fits, one from each package, each within PR 5's bound of
# float64 (CHANGES.md): the fixed effect 5e-4, the random effects 2e-3.
FE_F32, RE_F32 = 5e-4, 2e-3
F64 = 1e-12


@pytest.fixture(autouse=True)
def _clean():
    """The port's fault plan, retry counters and health layer are
    process-global (the conftest resets only the JAX package's)."""
    faults.disarm()
    reset_retry_stats()
    health.reset()
    health.disable()
    yield
    faults.disarm()
    health.reset()
    health.disable()


def write_day(shard_dir, day: int, seed: int | None = None) -> None:
    """The reference's day writer (tests/test_pilot.py)."""
    from test_pilot import write_day as jax_write_day

    jax_write_day(shard_dir, day, seed)


def _l2(w):
    return GLMOptimizationConfiguration(
        regularization=optim.RegularizationContext(
            optim.RegularizationType.L2),
        regularization_weight=w,
    )


def make_estimator(device="cpu"):
    """tests/test_pilot.py's estimator on the port."""
    return GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {
            "global": FixedEffectCoordinateConfiguration(
                "features", _l2(1e-2)),
            "per-user": RandomEffectCoordinateConfiguration(
                RandomEffectDataConfiguration("userId", "features"),
                _l2(1.0),
            ),
        },
        num_iterations=1,
        evaluators=["AUC"],
        device=device,
    )


def make_config(tmp_path, **overrides) -> PilotConfig:
    defaults = dict(
        stream_dir=str(tmp_path / "shards"),
        work_dir=str(tmp_path / "work"),
        estimator_factory=make_estimator,
        keep_generations=3,
        gate=PromotionGate(min_delta={"AUC": -1.0}),
        observe=ObservePolicy(window_s=0.0),
        backoff_base_s=0.01,
        device="cpu",
    )
    defaults.update(overrides)
    return PilotConfig(**defaults)


def make_server(model, device="cpu"):
    return PilotServer(model, rungs=(1, 4), max_linger_s=0.001,
                       device=device)


@pytest.fixture
def pilot_env(tmp_path):
    write_day(tmp_path / "shards", 0)
    return tmp_path


def _requests_for(server, n: int, seed: int = 0):
    from photon_tpu_torch.serve.driver import synthetic_requests

    return synthetic_requests(
        server.programs.tables, server.programs, n, seed=seed
    )


# --------------------------------------------------------------------------
# state machine + ring units
# --------------------------------------------------------------------------


class TestStateFile:
    def test_roundtrip(self, tmp_path):
        state = PilotState(stage="TRAIN", cycle=3, promotions=2,
                           processed_shards=["a", "b"])
        commit_state(str(tmp_path), state)
        loaded = load_state(str(tmp_path))
        assert loaded.stage == "TRAIN"
        assert loaded.cycle == 3
        assert loaded.promotions == 2
        assert loaded.processed_shards == ["a", "b"]

    def test_missing_is_none(self, tmp_path):
        assert load_state(str(tmp_path)) is None

    def test_future_schema_refused(self, tmp_path):
        commit_state(str(tmp_path), PilotState())
        path = tmp_path / "pilot-state.json"
        doc = json.loads(path.read_text())
        doc["schema_version"] = 99
        path.write_text(json.dumps(doc))
        with pytest.raises(ValueError, match="schema_version"):
            load_state(str(tmp_path))


def _tiny_model(scale: float = 1.0):
    from photon_tpu_torch.models.game import FixedEffectModel, GameModel
    from photon_tpu_torch.models.glm import (
        Coefficients,
        GeneralizedLinearModel,
    )

    rng = np.random.default_rng(5)
    return GameModel({
        "global": FixedEffectModel(
            GeneralizedLinearModel(
                Coefficients(means=torch.from_numpy(
                    scale * rng.normal(size=3).astype(np.float32))),
                TaskType.LOGISTIC_REGRESSION,
            ),
            "features",
        ),
    })


class TestGenerationRing:
    def test_stage_commit_rollback_and_bound(self, tmp_path):
        ring = GenerationRing(str(tmp_path), keep=2)
        gens = []
        for i in range(4):
            g = ring.stage_candidate(
                _tiny_model(float(i + 1)), cycle=i + 1)
            assert ring.staged == g
            ring.commit_live(g)
            assert ring.live == g
            assert ring.staged is None
            gens.append(g)
        # Bounded: only the `keep` newest survive, files pruned too.
        assert len(ring.entries()) == 2
        npzs = [p for p in os.listdir(tmp_path) if p.endswith(".npz")]
        assert len(npzs) == 2
        prev = ring.previous(ring.live)
        assert prev == gens[-2]
        ring.mark_rolled_back(gens[-1], to=prev, reason="slo burn")
        assert ring.live == prev
        bad = [e for e in ring.entries() if e["gen"] == gens[-1]][0]
        assert bad["rolled_back"] and bad["rollback_reason"] == "slo burn"
        # A rolled-back generation is never a rollback target again.
        assert ring.previous(gens[-1]) == prev
        # Loads land on the device asked for, the values intact.
        model = ring.load(prev, "cpu")
        want = _tiny_model(float(len(gens) - 1))
        torch.testing.assert_close(
            model["global"].model.coefficients.means,
            want["global"].model.coefficients.means, rtol=0, atol=0)

    def test_load_verifies_hash(self, tmp_path):
        ring = GenerationRing(str(tmp_path), keep=2)
        g = ring.stage_candidate(_tiny_model(), cycle=1)
        ring.commit_live(g)
        with open(ring.path(g), "r+b") as f:
            f.seek(0)
            f.write(b"\x00\x00\x00\x00")
        with pytest.raises(CorruptModelError, match="sha256"):
            ring.load(g, "cpu")

    def test_keep_floor(self, tmp_path):
        with pytest.raises(ValueError, match="keep"):
            GenerationRing(str(tmp_path), keep=1)


class TestPromotionGate:
    def test_direction_aware_deltas(self):
        specs = [EvaluatorSpec.parse("AUC"), EvaluatorSpec.parse("RMSE")]
        gate = PromotionGate(min_delta={"AUC": 0.0, "RMSE": 0.01})
        assert gate.decide(
            specs, {"AUC": 0.8, "RMSE": 0.40}, {"AUC": 0.7, "RMSE": 0.42}
        ) == []
        reasons = gate.decide(
            specs, {"AUC": 0.8, "RMSE": 0.415},
            {"AUC": 0.7, "RMSE": 0.42},
        )
        assert len(reasons) == 1 and "RMSE" in reasons[0]
        assert "0.415" in reasons[0] and "0.42" in reasons[0]

    def test_negative_delta_is_an_allowance(self):
        specs = [EvaluatorSpec.parse("AUC")]
        gate = PromotionGate(min_delta={"AUC": -0.05})
        assert gate.decide(specs, {"AUC": 0.66}, {"AUC": 0.70}) == []
        assert gate.decide(specs, {"AUC": 0.60}, {"AUC": 0.70}) != []

    def test_primary_gated_by_default(self):
        specs = [EvaluatorSpec.parse("AUC")]
        assert PromotionGate().decide(
            specs, {"AUC": 0.69}, {"AUC": 0.70}) != []

    def test_missing_gated_metric_refuses(self):
        specs = [EvaluatorSpec.parse("AUC")]
        gate = PromotionGate(min_delta={"LOGISTIC_LOSS": 0.0})
        reasons = gate.decide(specs, {"AUC": 0.8}, {"AUC": 0.7})
        assert any("LOGISTIC_LOSS" in r for r in reasons)


# --------------------------------------------------------------------------
# the cycle
# --------------------------------------------------------------------------


class TestPilotCycle:
    def test_bootstrap_then_values_only_promotion(self, pilot_env):
        cfg = make_config(pilot_env)
        pilot = Pilot(cfg, server_factory=make_server)
        r1 = pilot.run_cycle()
        assert r1["promotion"]["generation"] == 1
        assert pilot.ring.live == 1
        assert pilot.state.promotions == 1
        assert r1["staleness_seconds"] is not None
        assert pilot.run_cycle() == {"stage": "IDLE", "new_shards": 0}
        # Day 2: warm-start retrain, values-only hot reload (the pinned
        # vocabulary and saturated supports keep the structure).
        write_day(pilot_env / "shards", 1)
        before = pilot.server.programs.stats["programs_compiled"]
        programs = pilot.server.programs
        r2 = pilot.run_cycle()
        assert r2["promotion"]["values_only"] is True
        assert r2["promotion"]["programs_compiled"] == 0
        assert r2["promotion"]["compile_events"] == 0
        assert pilot.server.programs is programs
        assert pilot.server.programs.stats["programs_compiled"] == before
        assert pilot.server.reload_compile_events == 0
        assert pilot.ring.live == 2
        for feats, ids in _requests_for(pilot.server, 3):
            assert isinstance(
                pilot.server.submit(feats, ids).result(timeout=10.0),
                float,
            )
        assert pilot.state.processed_shards == [
            "part-000.avro", "part-001.avro"]
        pilot.server.close()

    def test_gate_refusal_records_reasons_and_postmortem(
        self, pilot_env, tmp_path
    ):
        from photon_tpu_torch.obs import flight

        cfg = make_config(
            pilot_env, gate=PromotionGate(min_delta={"AUC": 10.0}))
        pilot = Pilot(cfg, server_factory=make_server)
        pilot.run_cycle()  # bootstrap passes (no incumbent)
        assert pilot.state.promotions == 1
        write_day(pilot_env / "shards", 1)
        flight_dir = tmp_path / "flight"
        rec = flight.install(str(flight_dir), signals=False)
        try:
            r = pilot.run_cycle()
        finally:
            flight.uninstall()
            assert rec is not None
        assert r["refused"] and "AUC" in r["refused"][0]
        assert pilot.state.refusals == 1
        assert pilot.state.promotions == 1
        assert pilot.ring.live == 1
        assert pilot.state.last_refusal["reasons"] == r["refused"]
        assert list(flight_dir.glob("flight-*.json")), \
            "refusal must dump a post-mortem"
        assert pilot.run_cycle() == {"stage": "IDLE", "new_shards": 0}
        pilot.server.close()

    def test_cycle_dirs_pruned(self, pilot_env):
        cfg = make_config(pilot_env, keep_cycle_dirs=1)
        pilot = Pilot(cfg, server_factory=make_server)
        for day in range(3):
            if day:
                write_day(pilot_env / "shards", day)
            assert "promotion" in pilot.run_cycle()
        dirs = sorted(
            p.name for p in (pilot_env / "work").glob("cycle-*"))
        assert dirs == ["cycle-00003"], dirs
        pilot.server.close()

    def test_validation_dir_gates_on_holdout(self, pilot_env):
        write_day(pilot_env / "holdout", 0, seed=77)
        cfg = make_config(
            pilot_env, validation_dir=str(pilot_env / "holdout"))
        pilot = Pilot(cfg, server_factory=make_server)
        r1 = pilot.run_cycle()
        assert "promotion" in r1 and r1["candidate_metrics"]["AUC"] > 0
        write_day(pilot_env / "shards", 1)
        r2 = pilot.run_cycle()
        assert "promotion" in r2
        assert r2["serving_metrics"] is not None
        assert (pilot_env / "work" / "cycle-00002"
                / "validate-ingest").is_dir()
        pilot.server.close()

    def test_staleness_gauge_exported(self, pilot_env):
        from photon_tpu_torch import obs
        from photon_tpu_torch.obs.monitor import (
            MonitorServer,
            validate_exposition,
        )

        cfg = make_config(pilot_env)
        pilot = Pilot(cfg, server_factory=make_server)
        pilot.run_cycle()
        snap = obs.REGISTRY.snapshot()["gauges"]
        assert snap.get("pilot_promotions_total") == 1.0
        assert snap.get("pilot_staleness_seconds", 0) > 0
        fams = {f["name"]: f for f in pilot.metrics_families()}
        stage = fams["pilot_cycle_stage_state"]
        hot = [s for s in stage["samples"] if s[2] == 1.0]
        assert hot == [("", {"state": "IDLE"}, 1.0)]
        events = {
            s[1]["kind"]: s[2]
            for s in fams["pilot_cycle_events_total"]["samples"]
        }
        assert events["promotion"] == 1.0
        # The collector must not repeat the registry's plain gauges: a
        # duplicate family name fails the whole /metrics render.
        assert "pilot_staleness_seconds" not in fams
        text = MonitorServer(
            0, collectors=[pilot.metrics_families]
        ).render()
        validate_exposition(text)
        assert "pilot_staleness_seconds" in text
        assert "pilot_cycle_stage_state" in text
        pilot.server.close()


# --------------------------------------------------------------------------
# chaos: every stage killed / poisoned, pilot resumes
# --------------------------------------------------------------------------


class TestPilotChaos:
    def test_transient_ingest_fault_is_retried(self, pilot_env):
        cfg = make_config(pilot_env)
        pilot = Pilot(cfg, server_factory=make_server)
        plan = FaultPlan([dict(point="pilot.ingest", nth=1)], seed=3)
        with faults.injected(plan):
            r = pilot.run_cycle()
        assert "error" not in r
        assert pilot.state.promotions == 1
        assert retry_stats()["recovered"] >= 1
        pilot.server.close()

    def test_poison_train_fails_then_resumes_at_train(self, pilot_env):
        cfg = make_config(pilot_env)
        pilot = Pilot(cfg, server_factory=make_server)
        plan = FaultPlan(
            [dict(point="pilot.train", nth=1, error="poison")], seed=3)
        with faults.injected(plan):
            r = pilot.run_cycle()
        assert "error" in r and "Poison" in r["error"]
        assert pilot.state.stage == "TRAIN"
        assert pilot.state.consecutive_failures == 1
        assert pilot.backoff_s() > 0
        r2 = pilot.run_cycle()
        assert r2["promotion"]["generation"] == 1
        assert pilot.state.consecutive_failures == 0
        pilot.server.close()

    def test_crash_mid_promote_resumes_staged_generation(
        self, pilot_env
    ):
        cfg = make_config(pilot_env)
        pilot = Pilot(cfg, server_factory=make_server)
        pilot.run_cycle()
        write_day(pilot_env / "shards", 1)
        # nth=2: the first check fires inside the staged npz's write,
        # the second between "generation durable" and "serving
        # switched".
        plan = FaultPlan(
            [dict(point="pilot.promote", nth=2, error="crash")], seed=3)
        with faults.injected(plan):
            with pytest.raises(InjectedCrash):
                pilot.run_cycle()
        assert pilot.ring.live == 1
        assert pilot.ring.staged == 2
        assert load_state(cfg.work_dir).stage == "PROMOTE"
        pilot.server.close()
        # Restart: a fresh pilot serves the OLD live generation, then
        # finishes the staged promotion.
        pilot2 = Pilot(cfg, server_factory=make_server)
        pilot2.server = make_server(pilot2.ring.load(pilot2.ring.live,
                                                     "cpu"))
        r = pilot2.run_cycle()
        assert r["promotion"]["generation"] == 2
        assert pilot2.ring.live == 2
        assert pilot2.ring.staged is None
        assert pilot2.state.promotions == 2
        pilot2.server.close()

    def test_crash_mid_ring_write_leaves_old_generation(self, pilot_env):
        cfg = make_config(pilot_env)
        pilot = Pilot(cfg, server_factory=make_server)
        pilot.run_cycle()
        write_day(pilot_env / "shards", 1)
        plan = FaultPlan(
            [dict(point="pilot.promote", nth=1, error="crash")], seed=3)
        with faults.injected(plan):
            with pytest.raises(InjectedCrash):
                pilot.run_cycle()
        pilot.server.close()
        pilot2 = Pilot(cfg, server_factory=make_server)
        assert pilot2.ring.live == 1
        assert pilot2.ring.staged is None
        assert load_state(cfg.work_dir).stage == "PROMOTE"
        # No temp file of the torn write is left beside the ring.
        assert not [p for p in os.listdir(pilot2.ring.directory)
                    if ".tmp." in p]
        r = pilot2.run_cycle()
        assert r["promotion"]["generation"] == 2
        pilot2.server.close()

    def test_consecutive_failures_degrade_to_serve_only(self, pilot_env):
        cfg = make_config(pilot_env, max_consecutive_failures=2)
        pilot = Pilot(cfg, server_factory=make_server)
        pilot.run_cycle()
        write_day(pilot_env / "shards", 1)
        plan = FaultPlan([
            dict(point="pilot.validate", nth=n, error="poison")
            for n in (1, 2)
        ], seed=3)
        with faults.injected(plan):
            assert "error" in pilot.run_cycle()
            assert pilot.state.mode != MODE_SERVE_ONLY
            assert "error" in pilot.run_cycle()
        assert pilot.state.mode == MODE_SERVE_ONLY
        r = pilot.run_cycle()
        assert r["mode"] == MODE_SERVE_ONLY
        feats, ids = _requests_for(pilot.server, 1)[0]
        assert isinstance(
            pilot.server.submit(feats, ids).result(timeout=10.0), float)
        pilot.reset_serve_only()
        r = pilot.run_cycle()
        assert r["promotion"]["generation"] == 2
        pilot.server.close()

    def test_slo_burn_rolls_back_to_previous_generation(
        self, pilot_env, tmp_path
    ):
        from photon_tpu_torch.obs import flight

        cfg = make_config(
            pilot_env,
            observe=ObservePolicy(
                window_s=2.0, poll_s=0.05, max_dispatch_errors=0),
        )
        pilot = Pilot(cfg, server_factory=make_server)
        pilot.run_cycle()
        write_day(pilot_env / "shards", 1)
        plan = FaultPlan(
            [dict(point="serve.dispatch", probability=1.0,
                  error="poison")],
            seed=3,
        )

        def burn():
            deadline = time.time() + 30.0
            while time.time() < deadline:
                if load_state(cfg.work_dir).stage == "OBSERVE":
                    break
                time.sleep(0.02)
            faults.arm(plan)
            for feats, ids in _requests_for(pilot.server, 4, seed=9):
                try:
                    pilot.server.submit(feats, ids).exception(
                        timeout=10.0)
                except Exception:  # noqa: BLE001 - burn traffic only
                    pass

        t = threading.Thread(target=burn, daemon=True)
        flight_dir = tmp_path / "flight"
        flight.install(str(flight_dir), signals=False)
        try:
            t.start()
            r = pilot.run_cycle()
        finally:
            t.join(timeout=30.0)
            faults.disarm()
            flight.uninstall()
        assert r["rollback"]["rolled_back"] is True
        assert r["rollback"]["from"] == 2 and r["rollback"]["to"] == 1
        assert pilot.ring.live == 1
        assert pilot.state.rollbacks == 1
        entry = [e for e in pilot.ring.entries() if e["gen"] == 2][0]
        assert entry["rolled_back"]
        assert "dispatch error" in entry["rollback_reason"]
        assert list(flight_dir.glob("flight-*.json")), \
            "rollback must dump a post-mortem"
        feats, ids = _requests_for(pilot.server, 1)[0]
        assert isinstance(
            pilot.server.submit(feats, ids).result(timeout=10.0), float)
        pilot.server.close()


# --------------------------------------------------------------------------
# serve-layer swap machinery the pilot promotes through
# --------------------------------------------------------------------------


def _serving_model(scale: float, entities: int, device="cpu"):
    """tests/test_pilot.py's two-coordinate serving model."""
    from photon_tpu_torch.io.model_io import game_model_from_numpy

    rng = np.random.default_rng(11)
    prng = np.random.default_rng(12)
    s, du = 2, 4
    proj = np.sort(
        np.stack([prng.permutation(du)[:s] for _ in range(entities)]),
        axis=1,
    ).astype(np.int64)
    task = TaskType.LOGISTIC_REGRESSION.value
    arrays = {
        "global/means": (scale * rng.normal(size=4)).astype(np.float32),
        "per-user/coefficients": (
            scale * rng.normal(size=(entities, s))).astype(np.float32),
        "per-user/proj_all": proj,
    }
    manifest = {
        "global": {"kind": "fixed", "shard": "features", "task": task},
        "per-user": {"kind": "random", "re_type": "userId",
                     "shard": "userShard", "task": task,
                     "entity_keys": [str(i) for i in range(entities)]},
    }
    return game_model_from_numpy(arrays, manifest, device)


# The bare queue (tests/test_torch_serve_degraded.py runs it too) and the
# pilot's server bundle around it.
FRONTS = ["queue", "pilot_server"]


def _front(kind: str, server: PilotServer):
    return server.queue if kind == "queue" else server


class TestReloadMachinery:
    @pytest.mark.parametrize("kind", FRONTS)
    def test_quiesce_drops_nothing(self, kind):
        server = make_server(_serving_model(1.0, entities=5))
        front = _front(kind, server)
        reqs = _requests_for(server, 24, seed=1)
        futures = []

        def producer():
            for feats, ids in reqs:
                futures.append(front.submit(feats, ids))

        t = threading.Thread(target=producer, daemon=True)
        with server.queue.quiesce():
            t.start()
            time.sleep(0.15)  # requests pile up against the pause
        t.join(timeout=10.0)
        for fut in futures:
            assert fut.exception(timeout=10.0) is None
        assert len(futures) == 24
        server.close()

    def test_quiesce_entered_mid_linger_blocks_the_pop(self):
        """A worker already waiting for batch-mates when quiesce()
        begins must park again instead of popping when the linger
        expires."""
        server = make_server(_serving_model(1.0, entities=5))
        queue = MicroBatchQueue(
            server.programs, max_linger_s=0.05, max_batch=4
        )
        feats, ids = _requests_for(server, 1)[0]
        fut = queue.submit(feats, ids)
        time.sleep(0.01)  # the worker enters its linger wait
        with queue.quiesce():
            time.sleep(0.3)
            assert not fut.done(), \
                "request dispatched inside the quiesce window"
        assert fut.exception(timeout=10.0) is None
        queue.close()
        server.close()

    @pytest.mark.parametrize("kind", FRONTS)
    def test_structure_change_swaps_ladder_under_quiesce(self, kind):
        server = make_server(_serving_model(1.0, entities=5))
        reload = (server.queue.reload_model if kind == "queue"
                  else server.reload)
        out1 = reload(_serving_model(2.0, entities=5))
        assert out1["values_only"] is True
        assert out1["programs_compiled"] == 0
        # The entity vocabulary grows: new tables and a new ladder,
        # swapped without dropping the queue. On the CPU no graph is
        # captured (the cuda case counts one a rung).
        out2 = reload(_serving_model(2.0, entities=9))
        assert out2["values_only"] is False
        assert out2["programs_compiled"] == 0
        if kind == "pilot_server":
            assert out2["compile_events"] == 0
            assert server.reload_compile_events == 0
        assert server.queue.programs.tables.random[
            "per-user"].num_entities == 9
        front = _front(kind, server)
        feats, ids = _requests_for(server, 1)[0]
        assert isinstance(front.submit(feats, ids).result(timeout=10.0),
                          float)
        assert server.health()["table_generation"] == 2
        server.close()

    def test_serve_cli_reload_model(self, tmp_path):
        from photon_tpu_torch.cli import serve as cli_serve
        from photon_tpu_torch.io.model_io import save_checkpoint

        save_checkpoint(_serving_model(1.0, entities=5),
                        str(tmp_path / "base.npz"), fault_point=None)
        save_checkpoint(_serving_model(3.0, entities=5),
                        str(tmp_path / "v2.npz"), fault_point=None)
        out_path = tmp_path / "serve.json"
        rc = cli_serve.main([
            "--checkpoint", str(tmp_path / "base.npz"),
            "--synthetic", "64",
            "--batch-sizes", "1,8",
            "--reload-model", str(tmp_path / "v2.npz"),
            "--no-flight",
            "--device", "cpu",
            "--json", str(out_path),
        ])
        assert rc == 0
        out = json.loads(out_path.read_text())
        assert out["errors"] == 0
        (reload_info,) = out["reloads"]
        assert reload_info["values_only"] is True
        assert reload_info["programs_compiled"] == 0
        assert reload_info["summary"]["errors"] == 0


# --------------------------------------------------------------------------
# SIGTERM between ring commit and reload, through the CLI
# --------------------------------------------------------------------------


def _pilot_cli_config(tmp_path) -> str:
    """tests/test_pilot.py's CLI config (one file for both packages)."""
    from test_pilot import _pilot_cli_config as jax_config

    return jax_config(tmp_path)


def _run_pilot_cli(tmp_path, config, *extra, env_extra=None, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env.pop(faults.ENV_VAR, None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "photon_tpu_torch.cli.pilot",
         "--config", config, "--device", "cpu", "--poll-interval", "0.2",
         "--max-cycles", "1", "--flight-dir", str(tmp_path),
         "--json", str(tmp_path / "out.json"), *extra],
        cwd=REPO_ROOT, env=env, timeout=timeout,
        capture_output=True,
    )


class TestKillDuringPromotionSubprocess:
    def test_sigterm_between_ring_commit_and_reload(self, tmp_path):
        """A real pilot process takes SIGTERM after the new
        generation's ring commit and before the serving reload: the
        committed state leaves the server on the old generation and the
        pilot resumable, and a plain restart finishes the promotion."""
        write_day(tmp_path / "shards", 0)
        config = _pilot_cli_config(tmp_path)
        proc = _run_pilot_cli(tmp_path, config)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        out = json.loads((tmp_path / "out.json").read_text())
        assert out["promotions"] == 1 and out["generation_live"] == 1

        # pilot.promote call 2 is after the ring commit, before the
        # reload; the flight recorder's chained handler dumps, restores
        # the default disposition, and the process dies of SIGTERM.
        write_day(tmp_path / "shards", 1)
        plan = json.dumps({
            "seed": 7,
            "faults": [{"point": "pilot.promote", "nth": 2,
                        "error": "sigterm"}],
        })
        proc = _run_pilot_cli(
            tmp_path, config, env_extra={faults.ENV_VAR: plan})
        assert proc.returncode in (
            -signal.SIGTERM, 128 + signal.SIGTERM,
        ), (proc.returncode, proc.stderr.decode()[-2000:])
        ring = GenerationRing(
            str(tmp_path / "work" / "generations"), keep=3)
        assert ring.live == 1
        assert ring.staged == 2
        state = load_state(str(tmp_path / "work"))
        assert state.stage == "PROMOTE"
        assert state.promotions == 1
        assert list(tmp_path.glob("flight-*.json"))

        proc = _run_pilot_cli(tmp_path, config)
        assert proc.returncode == 0, proc.stderr.decode()[-2000:]
        out = json.loads((tmp_path / "out.json").read_text())
        assert out["promotions"] == 2
        assert out["generation_live"] == 2
        assert out["stage"] == "IDLE"
        ring = GenerationRing(
            str(tmp_path / "work" / "generations"), keep=3)
        assert ring.live == 2 and ring.staged is None


# --------------------------------------------------------------------------
# evaluate_model: the gate's ruler
# --------------------------------------------------------------------------


class TestEvaluateModel:
    def test_matches_fit_recorded_evaluation(self, pilot_env):
        from photon_tpu_torch.data.stream import StreamingIngest

        data, _ = StreamingIngest(
            str(pilot_env / "shards"),
            work_dir=str(pilot_env / "ingest"),
            device="cpu",
        ).run()
        est = make_estimator()
        result = est.fit(data, validation=data)[0]
        rescored = est.evaluate_model(result.model, data, data)
        assert rescored.evaluations["AUC"] == pytest.approx(
            result.evaluation.evaluations["AUC"], abs=1e-6)


# --------------------------------------------------------------------------
# tests/test_health.py's pilot cases
# --------------------------------------------------------------------------


def _write_pilot_day(shard_dir, day, rng, shift=0.0):
    """The reference's health-case writer (tests/test_health.py)."""
    from test_health import _write_pilot_day as jax_writer

    jax_writer(shard_dir, day, rng, shift=shift)


class TestPilotHealthGate:
    def test_shifted_day_refused_with_health_reason(self, tmp_path):
        shard_dir = str(tmp_path / "shards")
        rng = np.random.default_rng(20260804)
        _write_pilot_day(shard_dir, 0, rng)
        cfg = PilotConfig(
            stream_dir=shard_dir,
            work_dir=str(tmp_path / "work"),
            estimator_factory=make_estimator,
            gate=PromotionGate(min_delta={"AUC": -1.0}),
            observe=ObservePolicy(window_s=0.05, poll_s=0.02),
            health=HealthGatePolicy(
                max_drift_psi=0.25, max_ece=1.0, forbid_nonfinite=True,
            ),
            device="cpu",
        )
        pilot = Pilot(cfg)
        assert health.enabled()  # the pilot armed the layer
        boot = pilot.run_cycle()
        assert "promotion" in boot, boot
        assert os.path.exists(pilot._health_sketch_path())

        _write_pilot_day(shard_dir, 1, rng, shift=0.0)
        clean = pilot.run_cycle()
        assert "promotion" in clean, clean
        assert clean["health"]["reasons"] == []
        assert clean["health"]["drift"]["max_psi"] < 0.25

        _write_pilot_day(shard_dir, 2, rng, shift=4.0)
        shifted = pilot.run_cycle()
        reasons = shifted.get("refused") or []
        assert any(r.startswith("health:drift") for r in reasons), (
            shifted)
        assert shifted["health"]["drift"]["max_psi"] > 0.25
        assert pilot.state.last_health["reasons"] == reasons
        reloaded = load_state(cfg.work_dir)
        assert reloaded.last_health["reasons"] == reasons
        assert reloaded.refusals == 1
        assert pilot.state.stage == "IDLE"


class TestPilotHealthConfig:
    def test_omitted_drift_key_keeps_documented_default(self):
        from photon_tpu_torch.cli.pilot import _build_pilot_config

        raw = {
            "stream_dir": "/tmp/x", "work_dir": "/tmp/y",
            "task": "LOGISTIC_REGRESSION",
            "coordinates": {"global": {
                "type": "fixed", "feature_shard": "features",
                "regularization": {"type": "L2", "weight": 0.01},
            }},
            "health": {"forbid_nonfinite": True},
        }
        assert _build_pilot_config(raw).health.max_drift_psi == 0.25
        raw["health"]["max_drift_psi"] = None
        assert _build_pilot_config(raw).health.max_drift_psi is None
        raw["health"]["max_drift_psi"] = 0.5
        assert _build_pilot_config(raw).health.max_drift_psi == 0.5


# --------------------------------------------------------------------------
# the two packages side by side
# --------------------------------------------------------------------------


def _record_stages(pilot) -> list:
    """Every committed stage of ``pilot`` from here on."""
    seen: list = []
    commit = pilot._commit

    def recording():
        seen.append(pilot.state.stage)
        commit()

    pilot._commit = recording
    return seen


_COUNTERS = ("stage", "cycle", "mode", "processed_shards",
             "cycles_completed", "promotions", "rollbacks", "refusals",
             "failures", "consecutive_failures", "deadline_overruns")


def _ring_arrays(ring_dir) -> dict:
    """{gen: {key: array}} of a ring's generations, read with numpy."""
    meta = json.loads((Path(ring_dir) / "ring.json").read_text())
    out = {}
    for e in meta["entries"]:
        with np.load(Path(ring_dir) / e["file"]) as z:
            out[e["gen"]] = {k: z[k] for k in z.files}
    return out


def _assert_rings_close(jax_dir, port_dir, fe_tol, re_tol):
    want, got = _ring_arrays(jax_dir), _ring_arrays(port_dir)
    assert sorted(got) == sorted(want)
    for gen in want:
        assert sorted(got[gen]) == sorted(want[gen])
        for key, a in want[gen].items():
            b = got[gen][key]
            assert b.dtype == a.dtype, (gen, key)
            if key.endswith("/proj_all") or key == "__manifest__":
                if key == "__manifest__":
                    a = json.loads(bytes(a).decode())
                    b = json.loads(bytes(b).decode())
                assert (np.array_equal(a, b) if key != "__manifest__"
                        else a == b), (gen, key)
                continue
            tol = fe_tol if key.startswith("global/") else re_tol
            np.testing.assert_allclose(b, a, rtol=0, atol=tol,
                                       err_msg=f"generation {gen} {key}")


def _both_pilots(tmp_path, *, dtype, scenario):
    """The reference's and the port's ``Pilot`` on one shard directory
    (each with its own work dir): their configs and server factories."""
    import test_pilot as jax_tp

    from photon_tpu import pilot as jax_pilot
    from photon_tpu.obs.health import HealthGatePolicy as JaxHealth

    gate = {"promote": {"AUC": -1.0}, "holdout": {"AUC": -1.0},
            "refuse": {"AUC": 10.0}, "health": {"AUC": -1.0}}[scenario]
    validation_dir = (str(tmp_path / "holdout")
                      if scenario == "holdout" else None)
    jax_health = port_health = None
    if scenario == "health":
        jax_health = JaxHealth(max_drift_psi=0.25, max_ece=1.0,
                               max_coefficient_rel_l2=100.0)
        port_health = HealthGatePolicy(max_drift_psi=0.25, max_ece=1.0,
                                       max_coefficient_rel_l2=100.0)
    jcfg = jax_pilot.PilotConfig(
        stream_dir=str(tmp_path / "shards"),
        work_dir=str(tmp_path / "jax-work"),
        estimator_factory=jax_tp.make_estimator,
        validation_dir=validation_dir,
        keep_generations=3,
        gate=jax_pilot.PromotionGate(min_delta=gate),
        observe=jax_pilot.ObservePolicy(window_s=0.0),
        backoff_base_s=0.01,
        ingest_kwargs={"dtype": "float64" if dtype == torch.float64
                       else "float32"},
        health=jax_health,
    )
    pcfg = make_config(
        tmp_path, work_dir=str(tmp_path / "port-work"),
        validation_dir=validation_dir,
        gate=PromotionGate(min_delta=gate),
        ingest_kwargs={"dtype": dtype},
        health=port_health,
    )
    return jcfg, jax_tp.make_server, pcfg


def _drive_both(tmp_path, *, dtype, scenario):
    """Bootstrap and one more cycle through both pilots; returns their
    reports, stage sequences and states."""
    from photon_tpu import pilot as jax_pilot

    rng = np.random.default_rng(20260804)
    if scenario == "health":
        _write_pilot_day(tmp_path / "shards", 0, rng)
    else:
        write_day(tmp_path / "shards", 0)
    if scenario == "holdout":
        write_day(tmp_path / "holdout", 0, seed=77)
    jcfg, jax_server, pcfg = _both_pilots(tmp_path, dtype=dtype,
                                          scenario=scenario)
    jp = jax_pilot.Pilot(jcfg, server_factory=jax_server)
    pp = Pilot(pcfg, server_factory=make_server)
    jstages, pstages = _record_stages(jp), _record_stages(pp)
    reports = {"jax": [], "port": []}
    try:
        for day in range(2):
            if day:
                if scenario == "health":
                    _write_pilot_day(tmp_path / "shards", day, rng,
                                     shift=4.0)
                else:
                    write_day(tmp_path / "shards", day)
            reports["jax"].append(jp.run_cycle())
            reports["port"].append(pp.run_cycle())
    finally:
        for p in (jp, pp):
            if p.server is not None:
                p.server.close()
    return reports, (jstages, pstages), (jp, pp)


# Reports differ, by design, only where the JAX package compiles an XLA
# ladder at bootstrap and the port captures no graph on the CPU.
_REPORT_SKIP = {"staleness_seconds", "attribution"}
_PROMOTION_SKIP = {"programs_compiled", "compile_events"}


@pytest.mark.parametrize("scenario", ["promote", "refuse", "holdout",
                                      "health"])
def test_cycles_match_the_reference_in_float64(tmp_path, scenario):
    reports, (jstages, pstages), (jp, pp) = _drive_both(
        tmp_path, dtype=torch.float64, scenario=scenario)
    assert pstages == jstages
    for k in _COUNTERS:
        assert getattr(pp.state, k) == getattr(jp.state, k), k
    for jr, pr in zip(reports["jax"], reports["port"]):
        assert set(pr) == set(jr)
        for key in set(jr) - _REPORT_SKIP:
            want, got = jr[key], pr[key]
            if key in ("candidate_metrics", "serving_metrics"):
                assert (got is None) == (want is None)
                if want is not None:
                    assert set(got) == set(want)
                    for m in want:
                        assert got[m] == pytest.approx(want[m], abs=F64)
            elif key == "promotion":
                for pk in set(want) - _PROMOTION_SKIP:
                    assert got[pk] == want[pk], pk
            elif key == "health":
                assert got["reasons"] == want["reasons"]
                # No drift reference before the first promotion.
                assert (got["drift"] is None) == (want["drift"] is None)
                if want["drift"] is not None:
                    assert got["drift"]["max_psi_surface"] == \
                        want["drift"]["max_psi_surface"]
                    assert got["drift"]["max_psi"] == pytest.approx(
                        want["drift"]["max_psi"], abs=F64)
                assert got["ece"] == pytest.approx(want["ece"], abs=F64)
            else:
                assert got == want, key
    if scenario == "refuse":
        assert pp.state.last_refusal["reasons"] == \
            jp.state.last_refusal["reasons"]
    if scenario == "health":
        assert any(r.startswith("health:drift")
                   for r in reports["port"][1]["refused"])
    _assert_rings_close(tmp_path / "jax-work" / "generations",
                        tmp_path / "port-work" / "generations", F64, F64)


@pytest.mark.parametrize("scenario", ["promote", "refuse"])
def test_cycles_match_the_reference_in_float32(tmp_path, scenario):
    reports, (jstages, pstages), (jp, pp) = _drive_both(
        tmp_path, dtype=torch.float32, scenario=scenario)
    assert pstages == jstages
    for jr, pr in zip(reports["jax"], reports["port"]):
        assert ("promotion" in pr) == ("promotion" in jr)
        assert [r.split(":")[0] for r in pr.get("refused", [])] == \
            [r.split(":")[0] for r in jr.get("refused", [])]
    for k in _COUNTERS:
        assert getattr(pp.state, k) == getattr(jp.state, k), k
    _assert_rings_close(tmp_path / "jax-work" / "generations",
                        tmp_path / "port-work" / "generations",
                        FE_F32, RE_F32)


# --------------------------------------------------------------------------
# on-disk formats: each package resumes the other's work dir
# --------------------------------------------------------------------------


def test_port_resumes_a_reference_work_dir(tmp_path):
    """The reference's pilot bootstraps, then crashes between its ring
    commit and the reload; the port's pilot reads its state, ring and
    pinned vocabulary, finishes the staged promotion, and runs one more
    cycle warm-started from the reference's generation."""
    import test_pilot as jax_tp

    from photon_tpu import pilot as jax_pilot
    from photon_tpu.resilience import FaultPlan as JaxPlan
    from photon_tpu.resilience import InjectedCrash as JaxCrash
    from photon_tpu.resilience import faults as jax_faults

    write_day(tmp_path / "shards", 0)
    jcfg = jax_tp.make_config(tmp_path)
    jp = jax_pilot.Pilot(jcfg, server_factory=jax_tp.make_server)
    jp.run_cycle()
    write_day(tmp_path / "shards", 1)
    plan = JaxPlan([dict(point="pilot.promote", nth=2, error="crash")],
                   seed=3)
    with jax_faults.injected(plan):
        with pytest.raises(JaxCrash):
            jp.run_cycle()
    jp.server.close()

    pilot = Pilot(make_config(tmp_path), server_factory=make_server)
    assert pilot.state.stage == "PROMOTE"
    assert (pilot.ring.live, pilot.ring.staged) == (1, 2)
    pilot.server = make_server(pilot.ring.load(pilot.ring.live, "cpu"))
    r = pilot.run_cycle()
    assert r["promotion"]["generation"] == 2
    assert pilot.state.promotions == 2
    write_day(tmp_path / "shards", 2)
    r3 = pilot.run_cycle()
    assert r3["promotion"]["generation"] == 3
    # The reference's pinned vocabulary keyed the port's ingest, so the
    # retrain kept the structure: a values-only reload.
    assert r3["promotion"]["values_only"] is True
    assert pilot.state.processed_shards == [
        "part-000.avro", "part-001.avro", "part-002.avro"]
    pilot.server.close()


def test_reference_reads_the_port_work_dir(tmp_path):
    """The port's pilot writes its files; the reference reads each one,
    and re-serializes it to the same bytes, then resumes the work dir
    with a cycle of its own."""
    import test_pilot as jax_tp

    from photon_tpu import pilot as jax_pilot
    from photon_tpu.pilot import state as jax_state

    write_day(tmp_path / "shards", 0)
    cfg = make_config(tmp_path)
    pilot = Pilot(cfg, server_factory=make_server)
    pilot.run_cycle()
    write_day(tmp_path / "shards", 1)
    pilot.run_cycle()
    pilot.server.close()

    work = tmp_path / "work"
    loaded = jax_pilot.load_state(str(work))
    assert loaded.promotions == 2 and loaded.stage == "IDLE"
    assert json.dumps(dataclasses.asdict(loaded), indent=2,
                      sort_keys=True).encode() == \
        (work / jax_state.STATE_FILE).read_bytes()
    ring = jax_pilot.GenerationRing(str(work / "generations"), keep=3)
    assert (ring.live, ring.staged) == (2, None)
    assert json.dumps(ring._meta, indent=2, sort_keys=True).encode() == \
        (work / "generations" / "ring.json").read_bytes()
    model = ring.load(2)  # the hash check passes on the port's bytes
    want = pilot.ring.load(2, "cpu")
    np.testing.assert_array_equal(
        np.asarray(model["global"].model.coefficients.means),
        want["global"].model.coefficients.means.numpy())
    jp = jax_pilot.Pilot(jax_tp.make_config(tmp_path),
                         server_factory=jax_tp.make_server)
    vocab = jp._pinned_vocab()
    assert vocab == pilot._pinned_vocab()
    assert json.dumps(vocab, indent=2, sort_keys=True).encode() == \
        (work / "pilot-vocab.json").read_bytes()
    jp.server = jax_tp.make_server(jp.ring.load(jp.ring.live))
    write_day(tmp_path / "shards", 2)
    r = jp.run_cycle()
    assert r["promotion"]["generation"] == 3
    assert r["promotion"]["values_only"] is True
    jp.server.close()


# --------------------------------------------------------------------------
# both CLIs on one config file
# --------------------------------------------------------------------------

# Exit-JSON values that must agree; times, ports and traffic counts vary.
_CLI_SAME = ("metric", "stopped", "cycles", "mode", "stage", "promotions",
             "rollbacks", "refusals", "failures", "deadline_overruns",
             "generation_live", "last_refusal", "last_rollback",
             "last_health")


def test_both_clis_agree_on_one_config(tmp_path, monkeypatch, capsys):
    from photon_tpu.cli import pilot as jax_cli

    from photon_tpu_torch.cli import pilot as port_cli

    # The reference's CLI points JAX's persistent cache at HOME unless
    # told not to.
    monkeypatch.setenv("PHOTON_COMPILE_CACHE", "off")
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    write_day(tmp_path / "shards", 0)
    config = _pilot_cli_config(tmp_path)
    outs = {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", port_cli.main, ["--device", "cpu"])):
        root = tmp_path / name
        root.mkdir()
        runs = []
        for day in range(2):
            if day:
                write_day(tmp_path / "shards", day)
            rc = main([
                "--config", config, "--work-dir", str(root / "work"),
                "--poll-interval", "0.05", "--max-cycles", "1",
                "--traffic-qps", "200", "--monitor-port", "0",
                "--flight-dir", str(root), "--json", str(root / "out.json"),
                *extra,
            ])
            line = json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1])
            assert line == json.loads((root / "out.json").read_text())
            runs.append((rc, line))
        outs[name] = runs
        (tmp_path / "shards" / "part-001.avro").unlink()
    for (jrc, jout), (prc, pout) in zip(outs["jax"], outs["port"]):
        assert prc == jrc == 0
        assert set(pout) == set(jout)
        for key in _CLI_SAME:
            assert pout[key] == jout[key], key
        assert [{k: g[k] for k in ("gen", "cycle", "rolled_back")}
                for g in pout["generations"]] == \
            [{k: g[k] for k in ("gen", "cycle", "rolled_back")}
             for g in jout["generations"]]
        assert set(pout["traffic"]) == set(jout["traffic"])
        for key in ("errors", "submit_errors", "stranded"):
            assert pout["traffic"][key] == jout["traffic"][key] == 0
        assert set(pout["monitor"]) == set(jout["monitor"])
        assert (pout["last_promotion"]["values_only"]
                == jout["last_promotion"]["values_only"])
    # A restarted run serves its live generation from the start.
    assert outs["port"][1][1]["traffic"]["served"] > 0
    assert outs["jax"][1][1]["traffic"]["served"] > 0
    # The second run's values-only promotion captured no graph in the
    # port (the reference's compile-cache listener counts 0 as well).
    assert outs["port"][1][1]["serving_reload_compile_events"] == 0
    assert outs["jax"][1][1]["serving_reload_compile_events"] == 0


# --------------------------------------------------------------------------
# fault points and the non-finite candidate
# --------------------------------------------------------------------------

_POINTS = ("pilot.ingest", "pilot.train", "pilot.validate",
           "pilot.promote", "pilot.rollback")


def test_pilot_points_are_reached_as_the_reference_reaches_them(pilot_env):
    """A plan that never fires counts the calls: one each for ingest,
    train and validate, two for promote a clean cycle, none for
    rollback."""
    cfg = make_config(pilot_env)
    pilot = Pilot(cfg, server_factory=make_server)
    plan = FaultPlan([dict(point=p, nth=10_000) for p in _POINTS])
    with faults.injected(plan):
        pilot.run_cycle()
        write_day(pilot_env / "shards", 1)
        pilot.run_cycle()
    assert plan._counts == {"pilot.ingest": 2, "pilot.train": 2,
                            "pilot.validate": 2, "pilot.promote": 4,
                            "pilot.rollback": 0}
    pilot.server.close()


@pytest.mark.parametrize("point", _POINTS)
def test_each_pilot_point_fires(pilot_env, monkeypatch, point):
    cfg = make_config(pilot_env)
    pilot = Pilot(cfg, server_factory=make_server)
    pilot.run_cycle()
    write_day(pilot_env / "shards", 1)
    if point == "pilot.rollback":
        # Any burn verdict rolls back; the point fires before the
        # rollback loads its target.
        monkeypatch.setattr(Pilot, "_burn_verdict",
                            lambda self, baseline: "forced burn")
    plan = FaultPlan([dict(point=point, nth=1, error="poison")])
    with faults.injected(plan):
        r = pilot.run_cycle()
        fired = faults.fired()
    assert fired == [{"point": point, "call": 1, "error": "poison"}]
    assert "Poison" in r["error"]
    want_stage = {"pilot.ingest": "INGEST", "pilot.train": "TRAIN",
                  "pilot.validate": "VALIDATE", "pilot.promote": "PROMOTE",
                  "pilot.rollback": "OBSERVE"}[point]
    assert pilot.state.stage == want_stage
    assert pilot.ring.live == (2 if point == "pilot.rollback" else 1)
    pilot.server.close()


def test_nonfinite_candidate_refused_by_scan_model(pilot_env, monkeypatch):
    """The port's sentinels scan no fit (only the JAX package's fused
    fit parks one), so a non-finite candidate is refused through
    ``scan_model``'s look at its coefficients."""
    from photon_tpu_torch.models.game import FixedEffectModel
    from photon_tpu_torch.models.glm import (
        Coefficients,
        GeneralizedLinearModel,
    )

    cfg = make_config(pilot_env, health=HealthGatePolicy(
        max_drift_psi=None, forbid_nonfinite=True))
    pilot = Pilot(cfg, server_factory=make_server)
    assert "promotion" in pilot.run_cycle()
    write_day(pilot_env / "shards", 1)
    train = Pilot._train

    def poisoned(self, data):
        model, init = train(self, data)
        fe = model["global"]
        means = fe.model.coefficients.means.clone()
        means[0] = float("nan")
        return model.updated("global", FixedEffectModel(
            GeneralizedLinearModel(Coefficients(means=means), fe.task),
            fe.feature_shard_id)), init

    monkeypatch.setattr(Pilot, "_train", poisoned)
    r = pilot.run_cycle()
    assert health.numerics_report()["fits_scanned"] == 0
    assert r["refused"] == [
        "health:numerics coordinate 'global': 1 non-finite "
        f"coefficient(s) of {r['health']['model_scan'][0].split()[-1]}"]
    assert pilot.state.refusals == 1 and pilot.ring.live == 1
    pilot.server.close()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels "
                    "have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_reload_counts_captured_graphs(cuda_device):
    """``PilotServer.reload``'s ``compile_events`` counts the graphs the
    reload captured: none for a values-only reload, one a rung for a
    structure change."""
    rungs = (1, 8, 64)
    server = PilotServer(_serving_model(1.0, 5, cuda_device), rungs=rungs,
                         max_linger_s=0.001, device=cuda_device)
    assert server.programs.stats["programs_compiled"] == len(rungs)
    out = server.reload(_serving_model(2.0, 5, cuda_device))
    assert (out["values_only"], out["compile_events"]) == (True, 0)
    out = server.reload(_serving_model(2.0, 9, cuda_device))
    assert out["values_only"] is False
    assert out["compile_events"] == out["programs_compiled"] == len(rungs)
    assert server.reload_compile_events == len(rungs)
    feats, ids = _requests_for(server, 1)[0]
    assert np.isfinite(server.submit(feats, ids).result(timeout=30.0))
    server.close()


@pytest.mark.cuda
def test_cuda_cycle_promotes_into_the_captured_ladder(cuda_device,
                                                      tmp_path):
    """Bootstrap and a values-only promotion on the card: the fit
    launches the Newton kernel, the ladder is captured once, and the
    promotion captures nothing."""
    from photon_tpu_torch.algorithm import random_effect as ra
    from photon_tpu_torch.io.avro_data import write_training_examples
    from photon_tpu_torch.ops import newton_kernel as nk
    from photon_tpu_torch.types import DELIMITER

    def day(k):
        rng = np.random.default_rng(100 + k)
        rows, y, meta = [], [], []
        for u in range(4):
            for fs in ([0, 1, 2], [1, 2, 3], [0, 2, 3], [0, 1, 3]):
                vals = rng.normal(size=3)
                rows.append([(f"f{j}{DELIMITER}t", float(v))
                             for j, v in zip(fs, vals)])
                z = float(vals.sum()) * 0.5
                y.append(float(rng.uniform() < 1 / (1 + np.exp(-z))))
                meta.append({"userId": f"u{u}"})
        os.makedirs(tmp_path / "shards", exist_ok=True)
        write_training_examples(
            str(tmp_path / "shards" / f"part-{k:03d}.avro"), np.array(y),
            rows, metadata=meta)

    day(0)
    cfg = make_config(tmp_path, device="cuda",
                      estimator_factory=lambda: make_estimator("cuda"))
    pilot = Pilot(cfg, server_factory=lambda m: make_server(m, "cuda"))
    nk.launches = ra.plain_route_solves = 0
    r1 = pilot.run_cycle()
    assert r1["promotion"]["programs_compiled"] == 2
    day(1)
    r2 = pilot.run_cycle()
    assert r2["promotion"]["values_only"] is True
    assert r2["promotion"]["compile_events"] == 0
    assert nk.launches > 0 and ra.plain_route_solves == 0
    feats, ids = _requests_for(pilot.server, 1)[0]
    assert np.isfinite(pilot.server.submit(feats, ids).result(timeout=30))
    pilot.server.close()
    shutil.rmtree(tmp_path / "work", ignore_errors=True)
