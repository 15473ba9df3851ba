"""The always-on train → validate → promote → rollback loop (port of
``photon_tpu/pilot/loop.py``).

The ``Pilot`` watches a shard directory and, per cycle: freezes the
shard snapshot, streams it in through ``data/stream.py`` (bounded
memory, integrity manifest, resumable cursor), retrains warm-started
from the live generation under the training checkpointer, gates the
promotion on the evaluation suite against the model serving now,
hot-reloads the live scorer through ``MicroBatchQueue.reload_model``
(values-only: nothing recaptured; structure change: the new ladder
captured off the request path and swapped under quiesce), then watches
the post-promotion SLO burn and rolls back to the previous ring
generation when it crosses the declared threshold.

Every stage runs on ``PilotConfig.device`` (default ``cuda``): the
stream lands its dataset there, the fit launches the Newton kernel for
every random-effect bucket and the segment-sum kernel for the fixed
effect's transpose, the validation's grouped AUC sums on the segment-sum
kernel, and the server replays the serve kernel's captured graphs. The
trainer runs on this thread while the queue's worker replays graphs on
its own; neither waits on the other's host syncs.

- **Atomic state machine**: every IDLE → INGEST → TRAIN → VALIDATE →
  PROMOTE → OBSERVE transition commits ``pilot-state.json`` through
  ``atomic_write_bytes``; a killed pilot resumes at the committed stage
  (``pilot/state.py``).
- **Stage retry and deadlines**: each stage runs under
  ``resilience.retry`` behind its fault point (``pilot.ingest``,
  ``pilot.train``, ``pilot.validate``, ``pilot.promote``,
  ``pilot.rollback``); a stage past its declared deadline is an overrun
  and counts toward degradation.
- **Degrade, never die**: consecutive failed (or overrun) cycles back
  off exponentially and, past ``max_consecutive_failures``, drop the
  pilot to SERVE-ONLY: the live scorer keeps serving the last good
  generation; ``reset_serve_only()`` re-arms it.
- **Bounded rollback inventory**: ``pilot/ring.py`` keeps the newest N
  generations on disk; a promotion commits staged, then live, so a kill
  between the generation's write and the reload leaves the server on
  the old generation and the promotion resumable.
- **Every bad outcome leaves evidence**: refusals record their reasons
  in the state file; refusals and rollbacks dump a flight-recorder
  post-mortem (``obs/flight.py``).

Every cycle ingests every shard of the directory, processed ones
included, as the JAX package's does: the cycle trains on the whole
history, so its ingest grows with the days.

Vocabulary pinning: by default the first cycle's scanned vocabulary is
committed (``pilot-vocab.json``) and reused by every later cycle, so
retrains keep the feature spaces. A random effect whose entities or
projectors change is still a structure change, promoted through the
quiesced ladder swap.

The numerics sentinels (``obs.health.numerics_report``) are fed only by
the JAX package's fused fit, which the port does not have (ROADMAP
item 8): here they scan no fit, and ``forbid_nonfinite`` refuses a
non-finite candidate through ``obs.health.scan_model``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

from photon_tpu_torch.pilot.ring import GenerationRing
from photon_tpu_torch.pilot.state import (
    MODE_ACTIVE,
    MODE_SERVE_ONLY,
    STAGES,
    PilotState,
    commit_state,
    load_state,
)

logger = logging.getLogger(__name__)

_VOCAB_FILE = "pilot-vocab.json"


@dataclasses.dataclass(frozen=True)
class PromotionGate:
    """Candidate-against-serving promotion policy.

    ``min_delta`` maps a metric name to the improvement required IN THE
    METRIC'S BETTER DIRECTION (+0.01 on RMSE means at least 0.01 lower);
    a negative value is a regression allowance. With
    ``require_primary`` the primary metric must not regress (``>= 0``)
    unless named. The first generation (no incumbent) passes.
    """

    min_delta: dict = dataclasses.field(default_factory=dict)
    require_primary: bool = True

    def decide(self, specs, candidate: dict, incumbent: dict) -> list[str]:
        """Refusal reasons (empty: promote)."""
        reasons = []
        by_name = {s.name: s for s in specs}
        gated = dict(self.min_delta)
        if self.require_primary and specs:
            gated.setdefault(specs[0].name, 0.0)
        for metric, need in gated.items():
            spec = by_name.get(metric)
            if spec is None or metric not in candidate \
                    or metric not in incumbent:
                reasons.append(
                    f"{metric}: gated metric not evaluated "
                    f"(have {sorted(candidate)})")
                continue
            sign = 1.0 if spec.bigger_is_better else -1.0
            improvement = sign * (candidate[metric] - incumbent[metric])
            if improvement < need:
                reasons.append(
                    f"{metric}: improvement {improvement:+.6g} < "
                    f"required {need:+.6g} (candidate "
                    f"{candidate[metric]:.6g} vs serving "
                    f"{incumbent[metric]:.6g})")
        return reasons


@dataclasses.dataclass(frozen=True)
class ObservePolicy:
    """The post-promotion observation window and its rollback
    triggers."""

    window_s: float = 2.0
    poll_s: float = 0.25
    # Any of these crossing rolls the promotion back:
    max_dispatch_errors: int = 0  # dispatch-error delta over the window
    max_error_burn: float = 0.0  # error-rate SLO short-window burn
    rollback_on_breaker: bool = True


@dataclasses.dataclass(frozen=True)
class PilotConfig:
    """Everything the control loop needs, declared once."""

    stream_dir: str
    work_dir: str
    estimator_factory: object  # () -> GameEstimator
    # A held-out validation shard directory (or file): the gate then
    # scores candidate and incumbent on it, streamed each cycle under
    # the pinned vocabulary. Without it the gate compares in-sample,
    # which favours an overfit candidate.
    validation_dir: str | None = None
    window_shards: int = 1
    keep_generations: int = 3
    # Per-cycle work dirs (ingest spills, training checkpoints, the
    # candidate npz) kept after their cycle completes.
    keep_cycle_dirs: int = 2
    gate: PromotionGate = dataclasses.field(default_factory=PromotionGate)
    observe: ObservePolicy = dataclasses.field(
        default_factory=ObservePolicy)
    # Per-stage soft deadlines in seconds (lower-cased stage name ->
    # budget). A stage that finishes past its budget is an OVERRUN:
    # recorded and counted toward degradation, its work kept.
    stage_deadline_s: dict = dataclasses.field(default_factory=dict)
    max_consecutive_failures: int = 3
    backoff_base_s: float = 1.0
    backoff_cap_s: float = 60.0
    retry: object = None  # resilience.RetryPolicy | None (the default)
    pin_vocabulary: bool = True
    ingest_kwargs: dict = dataclasses.field(default_factory=dict)
    # Health promotion gates (obs/health.py ``HealthGatePolicy``; None:
    # off). When set the pilot arms the health layer: every cycle's
    # ingest is sketched, and VALIDATE scores drift (against the last
    # promoted cycle's sketch), train/serve skew (against the queue's
    # request tap), calibration, coefficient movement and non-finite
    # coefficients; a violation refuses the promotion with ``health:*``
    # reasons (state file and flight post-mortem).
    health: object = None  # obs.health.HealthGatePolicy | None
    # Where the stream lands its data, the generations load and the
    # server factory builds its tables: the GPU unless "cpu" is asked.
    device: str = "cuda"


class Pilot:
    """The supervisor. One control thread runs the stages in order and
    commits each transition; serving concurrency stays inside the queue
    it supervises."""

    def __init__(self, config: PilotConfig, *, server=None,
                 server_factory=None):
        from photon_tpu_torch import device as device_mod

        self.config = config
        # Refuse a missing GPU before anything is committed.
        self.device = device_mod.resolve(config.device)
        self.server = server
        self.server_factory = server_factory
        os.makedirs(config.work_dir, exist_ok=True)
        self.ring = GenerationRing(
            os.path.join(config.work_dir, "generations"),
            keep=config.keep_generations,
        )
        self.state = load_state(config.work_dir) or PilotState()
        if config.health is not None:
            # Ingest sketching and the serve tap key off the one
            # obs.health flag (host bookkeeping only).
            from photon_tpu_torch.obs import health

            health.enable()
        self._commit()

    # -- plumbing ----------------------------------------------------------

    def _commit(self) -> None:
        commit_state(self.config.work_dir, self.state)
        self._export_gauges()

    def _cycle_dir(self, cycle: int | None = None) -> str:
        c = self.state.cycle if cycle is None else cycle
        return os.path.join(self.config.work_dir, f"cycle-{c:05d}")

    def _retry_policy(self):
        from photon_tpu_torch.resilience.retry import DEFAULT_POLICY

        return self.config.retry or DEFAULT_POLICY

    def _stage_run(self, stage: str, point: str, fn):
        """One stage body: fault point and transient retry inside,
        deadline bookkeeping outside. Returns ``fn()``'s result."""
        from photon_tpu_torch.resilience import retry

        t0 = time.monotonic()
        out = retry.retrying_check(
            point, fn, site=point, policy=self._retry_policy()
        )
        took = time.monotonic() - t0
        budget = self.config.stage_deadline_s.get(stage.lower())
        if budget is not None and took > budget:
            self.state.deadline_overruns += 1
            self.state.consecutive_failures += 1
            self._maybe_degrade(
                f"stage {stage} overran its {budget:g}s deadline "
                f"({took:.3f}s)")
            self._commit()
            logger.warning(
                "pilot: stage %s finished but overran its deadline "
                "(%.3fs > %gs) — counted toward degradation",
                stage, took, budget)
        return out

    def _maybe_degrade(self, why: str) -> None:
        if (
            self.state.mode == MODE_ACTIVE
            and self.state.consecutive_failures
            >= self.config.max_consecutive_failures
        ):
            self.state.mode = MODE_SERVE_ONLY
            self.state.last_error = why
            logger.error(
                "pilot: %d consecutive failure(s) — degrading to "
                "SERVE-ONLY mode (the live scorer keeps serving; "
                "reset_serve_only() re-arms the trainer): %s",
                self.state.consecutive_failures, why)

    def reset_serve_only(self) -> None:
        """Operator action: re-arm a pilot that degraded to
        serve-only."""
        self.state.mode = MODE_ACTIVE
        self.state.consecutive_failures = 0
        self._commit()

    def backoff_s(self) -> float:
        """The sleep before the next cycle attempt: exponential in the
        consecutive-failure count, capped."""
        n = self.state.consecutive_failures
        if n <= 0:
            return 0.0
        return min(
            self.config.backoff_base_s * (2.0 ** (n - 1)),
            self.config.backoff_cap_s,
        )

    # -- shard watching ----------------------------------------------------

    def _all_shards(self) -> list[str]:
        from photon_tpu_torch.io.avro_data import data_shard_files

        return [
            os.path.basename(p)
            for p in data_shard_files(self.config.stream_dir)
        ]

    def pending_shards(self) -> tuple[list[str], list[str]]:
        """(all shards, shards not yet trained into a generation)."""
        all_shards = self._all_shards()
        seen = set(self.state.processed_shards)
        return all_shards, [s for s in all_shards if s not in seen]

    def _landed_at(self, names: list[str]) -> float:
        stamps = []
        for name in names:
            try:
                stamps.append(os.path.getmtime(
                    os.path.join(self.config.stream_dir, name)))
            except OSError:
                pass
        return max(stamps) if stamps else time.time()

    # -- vocabulary pin ----------------------------------------------------

    def _vocab_path(self) -> str:
        return os.path.join(self.config.work_dir, _VOCAB_FILE)

    def _pinned_vocab(self) -> dict | None:
        path = self._vocab_path()
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    @staticmethod
    def _vocab_of(ingest) -> dict:
        return {
            "maps": {
                s: dict(m.items())
                for s, m in ingest.resolved_maps.items()
            },
            "id_tag_names": list(
                ingest.id_tag_names if ingest.id_tag_names != "auto"
                else ()
            ),
            "response_field": ingest.response_field,
        }

    def _save_vocab(self, ingest) -> None:
        from photon_tpu_torch.io.model_io import atomic_write_bytes

        atomic_write_bytes(
            self._vocab_path(),
            json.dumps(self._vocab_of(ingest), indent=2,
                       sort_keys=True).encode(),
        )

    # -- stages ------------------------------------------------------------

    def _vocab_kwargs(self) -> dict:
        """Ingest kwargs carrying the pinned vocabulary (or, unpinned,
        the current cycle's resolved one, set by ``_ingest``)."""
        from photon_tpu_torch.data.index_map import IndexMap

        kwargs = dict(self.config.ingest_kwargs)
        vocab = self._pinned_vocab() if self.config.pin_vocabulary else None
        if vocab is None:
            vocab = getattr(self, "_cycle_vocab", None)
        if vocab is not None:
            kwargs.setdefault("index_maps", {
                s: IndexMap({k: int(v) for k, v in fwd.items()})
                for s, fwd in vocab["maps"].items()
            })
            kwargs.setdefault("id_tag_names", vocab["id_tag_names"])
            kwargs.setdefault("response_field", vocab["response_field"])
        return kwargs

    def _run_ingest(self, stream_dir: str, work_name: str,
                    shard_names: list | None):
        from photon_tpu_torch.data.stream import (
            MANIFEST_FILE,
            StreamingIngest,
        )
        from photon_tpu_torch.resilience.errors import ResumeMismatchError

        ingest_dir = os.path.join(self._cycle_dir(), work_name)
        kwargs = self._vocab_kwargs()

        def build(resume: bool):
            return StreamingIngest(
                stream_dir,
                work_dir=ingest_dir,
                shard_names=shard_names,
                window_shards=self.config.window_shards,
                resume=resume,
                device=self.device,
                **kwargs,
            )

        resume = os.path.exists(os.path.join(ingest_dir, MANIFEST_FILE))
        try:
            ingest = build(resume)
            data, stats = ingest.run()
        except ResumeMismatchError as exc:
            if not resume:
                raise
            # The interrupted attempt ran under another ingest identity
            # (typically: the first cycle committed the vocabulary pin
            # between its ingest and its crash). A fresh ingest under
            # the current identity is always right; resume only saves
            # time.
            logger.warning(
                "pilot: ingest resume refused (%s); re-ingesting "
                "cycle %d %s fresh", exc, self.state.cycle, work_name)
            import shutil

            shutil.rmtree(ingest_dir, ignore_errors=True)
            ingest = build(False)
            data, stats = ingest.run()
        return data, stats, ingest

    def _ingest(self):
        had_pin = (
            self.config.pin_vocabulary
            and self._pinned_vocab() is not None
        )
        data, stats, ingest = self._run_ingest(
            self.config.stream_dir, "ingest",
            list(self.state.cycle_shards),
        )
        if self.config.pin_vocabulary and not had_pin:
            self._save_vocab(ingest)
        # This cycle's health sketch (None unless the layer is armed):
        # VALIDATE's drift and skew evidence, and on promotion the next
        # cycle's reference.
        self._cycle_sketch = getattr(ingest, "health_sketch", None)
        # The resolved vocabulary keys the validation ingest too, so a
        # held-out set indexes features exactly as training did.
        self._cycle_vocab = self._vocab_of(ingest)
        return data, stats

    def _validation_data(self):
        """This cycle's held-out validation dataset, or None without
        ``validation_dir`` (the gate then compares in-sample)."""
        if self.config.validation_dir is None:
            return None
        data, _, _ = self._run_ingest(
            self.config.validation_dir, "validate-ingest", None
        )
        return data

    def _candidate_path(self) -> str:
        return os.path.join(self._cycle_dir(), "candidate.npz")

    def _load_candidate(self):
        from photon_tpu_torch.io.model_io import load_checkpoint

        return load_checkpoint(self._candidate_path(), self.device)

    def _train(self, data):
        """Warm-started retrain under the training checkpointer; commits
        the candidate npz so a VALIDATE or PROMOTE resume never
        retrains."""
        from photon_tpu_torch.io.model_io import save_checkpoint
        from photon_tpu_torch.resilience.checkpoint import (
            TrainingCheckpointer,
            load_config_final,
            load_training_checkpoint,
            training_static_key,
        )

        if os.path.exists(self._candidate_path()):
            # An earlier attempt finished TRAIN and committed the
            # candidate before dying mid-transition: keep its work.
            return self._load_candidate(), self._init_model()
        est = self.config.estimator_factory()
        init = self._init_model()
        ckpt_dir = os.path.join(self._cycle_dir(), "train")
        key = training_static_key(est, None)
        resume = None
        if os.path.exists(os.path.join(ckpt_dir, "manifest.json")):
            resume = load_training_checkpoint(ckpt_dir, self.device)
        checkpointer = TrainingCheckpointer(ckpt_dir, key)
        try:
            results = est.fit(
                data,
                initial_model=init,
                checkpointer=checkpointer,
                resume=resume,
            )
            model = results[0].model
        except ValueError as exc:
            # The crash window between the last iteration's checkpoint
            # (with its config-final artifact) and the candidate commit:
            # the chain says "already completed"; finalize from it.
            if resume is None or "already completed" not in str(exc):
                raise
            model = load_config_final(ckpt_dir, 0, key, self.device)
        save_checkpoint(model, self._candidate_path(), fault_point=None)
        return model, init

    def _init_model(self):
        return (
            self.ring.load(self.ring.live, self.device)
            if self.ring.live is not None else None
        )

    def _validate(self, data, candidate, init):
        """Candidate against serving through one evaluation ruler (the
        held-out set when configured, else in-sample), plus the health
        gates when ``config.health`` is set. Returns (candidate metrics,
        incumbent metrics or None, refusal reasons, health block or
        None)."""
        from photon_tpu_torch.evaluation.evaluators import EvaluatorSpec

        val = self._validation_data()
        if val is None:
            val = data
        est = self.config.estimator_factory()
        policy = self.config.health
        cal = sink = None
        if policy is not None and policy.max_ece is not None:
            from photon_tpu_torch.obs import health

            pair = health.calibration_sink(est.task)
            if pair is not None:
                cal, sink = pair
        cand = est.evaluate_model(
            candidate, data, val, initial_model=init, score_sink=sink
        )
        reasons: list[str] = []
        inc_m = None
        if init is not None:
            inc = est.evaluate_model(
                init, data, val, initial_model=init
            )
            inc_m = dict(inc.evaluations)
            specs = [
                s if isinstance(s, EvaluatorSpec)
                else EvaluatorSpec.parse(s)
                for s in (est.evaluators or ())
            ] or [cand.primary_evaluator]
            reasons = self.config.gate.decide(
                specs, dict(cand.evaluations), inc_m
            )
        health_block = None
        if policy is not None:
            h_reasons, health_block = self._health_gate(
                policy, candidate, init, cal
            )
            reasons.extend(h_reasons)
        return dict(cand.evaluations), inc_m, reasons, health_block

    def _health_sketch_path(self) -> str:
        """The last PROMOTED cycle's ingest sketch: the drift reference
        of the next cycle's gate."""
        return os.path.join(
            self.config.work_dir, "pilot-health-sketch.json"
        )

    def _health_gate(self, policy, candidate, init, cal):
        """Score every armed health surface and apply the policy.
        Returns (``health:`` reasons, block): the block is the recorded
        evidence (cycle report, ``state.last_health``, the ``health_*``
        gauges)."""
        from photon_tpu_torch.obs import health

        block: dict = {}
        drift = None
        cycle_sketch = getattr(self, "_cycle_sketch", None)
        ref_path = self._health_sketch_path()
        if cycle_sketch is not None and os.path.exists(ref_path):
            try:
                ref = health.DataSketch.load(ref_path)
                drift = health.compare(ref, cycle_sketch)
            except (OSError, ValueError, KeyError) as exc:
                # A rotted reference must not wedge the loop: the drift
                # gate degrades, visibly, to "no reference".
                block["drift_error"] = repr(exc)
                logger.warning(
                    "pilot: health reference sketch unreadable (%s); "
                    "drift gate skipped this cycle", exc)
        skew = None
        skew_requests = 0
        if policy.max_skew_psi is not None and cycle_sketch is not None:
            serve_sk = health.serve_sketch(
                since=getattr(self, "_serve_mark", None)
            )
            skew_requests = serve_sk.rows
            if serve_sk.shards:
                skew = health.compare(cycle_sketch, serve_sk)
        ece = cal.ece() if cal is not None else None
        movement = (
            health.coefficient_movement(init, candidate)
            if init is not None else None
        )
        nonfinite = health.numerics_report(
            since_seq=getattr(self, "_sentinel_mark", 0)
        )
        scan = health.scan_model(candidate)
        reasons = policy.evaluate(
            drift=drift,
            skew=skew,
            skew_requests=skew_requests,
            ece=ece,
            movement=movement,
            nonfinite=nonfinite,
            model_scan=scan,
        )
        block.update({
            "reasons": list(reasons),
            "drift": None if drift is None else {
                "max_psi": drift["max_psi"],
                "max_ks": drift["max_ks"],
                "max_psi_surface": drift["max_psi_surface"],
            },
            "skew": None if skew is None else {
                "max_psi": skew["max_psi"],
                "max_psi_surface": skew["max_psi_surface"],
                "requests_sampled": skew_requests,
            },
            "ece": ece,
            "coefficient_movement": movement,
            "nonfinite_total": nonfinite["nonfinite_total"],
            "model_scan": list(scan),
        })
        health.record_gate(block)
        self.state.last_health = dict(block)
        return reasons, block

    def _promote(self, candidate, metrics) -> dict:
        """Staged, then live. ``pilot.promote`` fires twice a clean
        cycle: inside the generation npz's atomic write (the ring commit
        can die mid-write) and between the ring commit and the serving
        reload."""
        from photon_tpu_torch.resilience import faults, retry

        gen = self.ring.staged
        if gen is None:
            gen = self.ring.stage_candidate(
                candidate, cycle=self.state.cycle, metrics=metrics
            )
        faults.check("pilot.promote")
        reload_out = {"values_only": None, "programs_compiled": 0}
        if self.server is None and self.server_factory is not None:
            self.server = self.server_factory(candidate)
            reload_out = {
                "values_only": None,
                "programs_compiled":
                    self.server.programs.stats["programs_compiled"],
            }
        elif self.server is not None:
            reload_out = retry.call_with_retry(
                lambda: self.server.reload(candidate),
                site="pilot.promote.reload",
                policy=self._retry_policy(),
            )
        self.ring.commit_live(gen)
        # The cycle's ingest sketch becomes THE drift reference, after
        # the ring commit (a refused or crashed promotion keeps the old
        # one; a PROMOTE resumed in a new process has no sketch and
        # keeps it too).
        sketch = getattr(self, "_cycle_sketch", None)
        if self.config.health is not None and sketch is not None:
            sketch.save(self._health_sketch_path())
        return {
            "generation": gen,
            "values_only": reload_out.get("values_only"),
            "programs_compiled": reload_out.get("programs_compiled", 0),
            "compile_events": reload_out.get("compile_events"),
            "table_generation": reload_out.get("generation"),
        }

    def _observe_baseline(self) -> dict:
        if self.server is None:
            return {}
        h = self.server.health()
        return {
            "dispatch_errors": h.get("dispatch_errors", 0),
            "requests": h.get("requests", 0),
        }

    def _burn_verdict(self, baseline: dict) -> str | None:
        """The rollback trigger's description, or None."""
        if self.server is None:
            return None
        policy = self.config.observe
        h = self.server.health()
        # A restart resets the queue's counters: rebase, so a baseline
        # from before the crash never masks (or invents) burn.
        base_err = min(
            baseline.get("dispatch_errors", 0),
            h.get("dispatch_errors", 0),
        )
        err_delta = h.get("dispatch_errors", 0) - base_err
        if policy.rollback_on_breaker and h.get("breaker_open"):
            return (
                "dispatch circuit breaker OPEN post-promotion "
                f"(after {h.get('consecutive_failures')} consecutive "
                "failures)")
        if err_delta > policy.max_dispatch_errors:
            return (
                f"{err_delta} dispatch error(s) inside the observation "
                f"window (budget {policy.max_dispatch_errors})")
        slo = h.get("slo") or {}
        err = slo.get("error_rate") or {}
        burn = err.get("burn_short") or 0.0
        if burn > policy.max_error_burn:
            return (
                f"error-rate SLO short-window burn {burn:g} > budget "
                f"{policy.max_error_burn:g}")
        return None

    def _observe(self, started_at: float, baseline: dict) -> str | None:
        """Watch the window out; returns the rollback trigger or
        None."""
        policy = self.config.observe
        while True:
            verdict = self._burn_verdict(baseline)
            if verdict is not None:
                return verdict
            remaining = policy.window_s - (time.time() - started_at)
            if remaining <= 0 or self.server is None:
                return None
            time.sleep(min(policy.poll_s, max(remaining, 0.01)))

    def _rollback(self, reason: str) -> dict:
        """Roll back to the previous ring generation; the flight
        recorder gets a post-mortem either way."""
        from photon_tpu_torch.obs import flight
        from photon_tpu_torch.resilience import faults, retry

        bad = self.ring.live
        target = self.ring.previous(bad)
        if target is None:
            # Nothing older to serve: keep the current generation (a
            # degraded scorer beats none) and say so.
            logger.error(
                "pilot: rollback wanted (%s) but generation %s has no "
                "predecessor in the ring; keeping it live", reason, bad)
            flight.dump(f"pilot.rollback-impossible:gen-{bad}")
            return {"rolled_back": False, "reason": reason}
        faults.check("pilot.rollback")
        model = self.ring.load(target, self.device)
        if self.server is not None:
            retry.call_with_retry(
                lambda: self.server.reload(model),
                site="pilot.rollback.reload",
                policy=self._retry_policy(),
            )
            self.server.reset_breaker()
        self.ring.mark_rolled_back(bad, to=target, reason=reason)
        self.state.rollbacks += 1
        self.state.last_rollback = {
            "cycle": self.state.cycle,
            "from_generation": bad,
            "to_generation": target,
            "reason": reason,
            "at": time.time(),
        }
        flight.dump(f"pilot.rollback:gen-{bad}")
        logger.warning(
            "pilot: ROLLED BACK generation %s -> %s (%s)",
            bad, target, reason)
        return {
            "rolled_back": True, "from": bad, "to": target,
            "reason": reason,
        }

    # -- the cycle ---------------------------------------------------------

    def run_cycle(self) -> dict:
        """One supervision pass: trigger (or resume) a cycle and drive
        it to IDLE. Returns a report; stage failures are recorded,
        committed and retried with backoff on the next pass, never
        raised. Only ``InjectedCrash`` and BaseExceptions (signals)
        propagate: they model process death."""
        from photon_tpu_torch.resilience.errors import InjectedCrash

        if self.state.mode == MODE_SERVE_ONLY:
            return {
                "mode": MODE_SERVE_ONLY,
                "stage": self.state.stage,
                "last_error": self.state.last_error,
            }
        if self.state.stage == "IDLE":
            all_shards, new = self.pending_shards()
            if not new:
                self._export_gauges()
                return {"stage": "IDLE", "new_shards": 0}
            self.state.cycle += 1
            self.state.stage = "INGEST"
            self.state.cycle_shards = list(all_shards)
            self.state.new_shards = list(new)
            self.state.landed_at = self._landed_at(new)
            # Process-local windows of this cycle (a resumed cycle has
            # none and reports conservatively): the cost ledger's
            # attribution, the numerics sentinels, the serve tap.
            from photon_tpu_torch.obs import health as _health_mod
            from photon_tpu_torch.obs import ledger

            self._ledger_mark = ledger.mark()
            self._sentinel_mark = (
                _health_mod.sentinel_seq()
                if self.config.health is not None else 0
            )
            self._serve_mark = (
                _health_mod.serve_mark()
                if self.config.health is not None else None
            )
            self._commit()
            logger.info(
                "pilot: cycle %d triggered by %d new shard(s)",
                self.state.cycle, len(new))
        try:
            return self._drive_cycle()
        except InjectedCrash:
            raise  # a 'crash' fault models process death
        except Exception as exc:  # noqa: BLE001 - the supervisor
            # outlives what it supervises: record, commit, back off,
            # resume at the committed stage next pass.
            self.state.failures += 1
            self.state.consecutive_failures += 1
            self.state.last_error = f"{type(exc).__name__}: {exc}"
            self._maybe_degrade(self.state.last_error)
            self._commit()
            logger.exception(
                "pilot: cycle %d failed at stage %s (failure streak "
                "%d); will resume there after backoff",
                self.state.cycle, self.state.stage,
                self.state.consecutive_failures)
            return {
                "stage": self.state.stage,
                "cycle": self.state.cycle,
                "error": self.state.last_error,
                "mode": self.state.mode,
                "backoff_s": self.backoff_s(),
            }

    def _drive_cycle(self) -> dict:
        report: dict = {"cycle": self.state.cycle}
        self._cycle_overruns_baseline = self.state.deadline_overruns
        data = None
        candidate = init = None
        stage = self.state.stage
        self.state.require_stage(*STAGES[1:])

        if stage in ("INGEST", "TRAIN", "VALIDATE"):
            data, stats = self._stage_run(
                "INGEST", "pilot.ingest", self._ingest
            )
            report["ingest"] = {
                "rows": stats["rows_ingested"],
                "quarantined": stats["shards_quarantined"],
            }
            if stage == "INGEST":
                self.state.stage = stage = "TRAIN"
                self._commit()

        if stage in ("TRAIN", "VALIDATE"):
            if stage == "TRAIN":
                candidate, init = self._stage_run(
                    "TRAIN", "pilot.train", lambda: self._train(data)
                )
                self.state.stage = stage = "VALIDATE"
                self._commit()
            else:
                # Resumed at VALIDATE: TRAIN committed the candidate
                # before the transition.
                candidate = self._load_candidate()
                init = self._init_model()

        if stage == "VALIDATE":
            cand_m, inc_m, reasons, health_block = self._stage_run(
                "VALIDATE", "pilot.validate",
                lambda: self._validate(data, candidate, init),
            )
            report["candidate_metrics"] = cand_m
            report["serving_metrics"] = inc_m
            if health_block is not None:
                report["health"] = health_block
            if reasons:
                return self._refuse(report, reasons)
            self.state.stage = stage = "PROMOTE"
            self._commit()

        if stage == "PROMOTE":
            if candidate is None:
                candidate = self._load_candidate()
            promoted = self._promote_with_deadline(candidate, report)
            report["promotion"] = promoted
            staleness = (
                time.time() - self.state.landed_at
                if self.state.landed_at else None
            )
            self.state.staleness_seconds = staleness
            self.state.promotions += 1
            self.state.last_promotion = {
                "cycle": self.state.cycle,
                "generation": promoted["generation"],
                "values_only": promoted.get("values_only"),
                "staleness_seconds": staleness,
                "at": time.time(),
            }
            report["staleness_seconds"] = staleness
            self.state.stage = stage = "OBSERVE"
            self.state.last_error = None
            self._commit()

        if stage == "OBSERVE":
            started = (self.state.last_promotion or {}).get(
                "at", time.time()
            )
            baseline = self._observe_baseline()
            verdict = self._observe(started, baseline)
            if verdict is not None:
                report["rollback"] = self._rollback(verdict)
            return self._finish_cycle(report)
        raise AssertionError(f"unreachable pilot stage {stage!r}")

    def _promote_with_deadline(self, candidate, report) -> dict:
        """PROMOTE fires its fault point inline (``_promote``), so this
        wrapper adds only the deadline bookkeeping; the reload sub-step
        retries inside."""
        t0 = time.monotonic()
        out = self._promote(candidate, report.get("candidate_metrics"))
        took = time.monotonic() - t0
        budget = self.config.stage_deadline_s.get("promote")
        if budget is not None and took > budget:
            self.state.deadline_overruns += 1
            self.state.consecutive_failures += 1
            self._maybe_degrade(
                f"stage PROMOTE overran its {budget:g}s deadline")
            self._commit()
        return out

    def _refuse(self, report: dict, reasons: list[str]) -> dict:
        from photon_tpu_torch.obs import flight

        self.state.refusals += 1
        self.state.last_refusal = {
            "cycle": self.state.cycle,
            "reasons": list(reasons),
            "candidate_metrics": report.get("candidate_metrics"),
            "serving_metrics": report.get("serving_metrics"),
            "at": time.time(),
        }
        report["refused"] = list(reasons)
        flight.dump(f"pilot.refusal:cycle-{self.state.cycle}")
        logger.warning(
            "pilot: cycle %d promotion REFUSED: %s",
            self.state.cycle, "; ".join(reasons))
        return self._finish_cycle(report)

    def _finish_cycle(self, report: dict) -> dict:
        """Back to IDLE. The cycle's shards are processed either way: a
        refused or rolled-back candidate still consumed the data, and
        the next cycle waits for new shards."""
        clean = (
            "error" not in report
            and self.state.deadline_overruns
            == getattr(self, "_cycle_overruns_baseline", 0)
        )
        self.state.processed_shards = list(self.state.cycle_shards)
        self.state.cycle_shards = []
        self.state.new_shards = []
        self.state.stage = "IDLE"
        self.state.cycles_completed += 1
        if clean:
            self.state.consecutive_failures = 0
        self._commit()
        self._prune_cycle_dirs()
        report["stage"] = "IDLE"
        report["mode"] = self.state.mode
        from photon_tpu_torch.obs import ledger

        mark = getattr(self, "_ledger_mark", None)
        self._ledger_mark = None
        if ledger.enabled() and mark is not None:
            # This cycle's seconds by (coordinate, phase, program); a
            # resumed cycle has no mark and reports no window.
            report["attribution"] = ledger.attribution_since(mark)
        return report

    def _prune_cycle_dirs(self) -> None:
        """Per-cycle work dirs past ``keep_cycle_dirs`` are deleted,
        after the IDLE commit: the ring holds the durable generations;
        a completed cycle's dir is debugging context."""
        import re
        import shutil

        keep = max(int(self.config.keep_cycle_dirs), 0)
        pat = re.compile(r"^cycle-(\d+)$")
        found = []
        for name in os.listdir(self.config.work_dir):
            m = pat.match(name)
            if m is not None:
                found.append((int(m.group(1)), name))
        for _, name in sorted(found)[:-keep] if keep else sorted(found):
            shutil.rmtree(
                os.path.join(self.config.work_dir, name),
                ignore_errors=True,
            )

    # -- daemon loop -------------------------------------------------------

    def run_forever(self, *, poll_interval_s: float = 5.0,
                    max_cycles: int | None = None,
                    idle_timeout_s: float | None = None,
                    should_stop=None) -> dict:
        """Poll, cycle, sleep, until ``max_cycles`` completed cycles
        (promotions and refusals), ``idle_timeout_s`` without new
        shards, or ``should_stop()``. Failure backoff stretches the
        sleep; the loop never raises for supervised failures."""
        last_work = time.time()
        cycles = 0
        while True:
            if should_stop is not None and should_stop():
                return {"stopped": "requested", "cycles": cycles}
            report = self.run_cycle()
            if report.get("stage") == "IDLE" and "cycle" in report:
                cycles += 1
                last_work = time.time()
                if max_cycles is not None and cycles >= max_cycles:
                    return {"stopped": "max_cycles", "cycles": cycles}
            elif "error" in report:
                last_work = time.time()
            elif (
                idle_timeout_s is not None
                and time.time() - last_work > idle_timeout_s
            ):
                return {"stopped": "idle", "cycles": cycles}
            time.sleep(max(poll_interval_s, self.backoff_s())
                       if "error" in report else poll_interval_s)

    # -- observability -----------------------------------------------------

    def _export_gauges(self) -> None:
        """The pilot_* registry gauges (they reach /metrics through the
        registry collector; set whatever the telemetry flag)."""
        try:
            from photon_tpu_torch import obs

            s = self.state
            g = obs.REGISTRY.gauge
            g("pilot_promotions_total").set(s.promotions)
            g("pilot_rollbacks_total").set(s.rollbacks)
            g("pilot_refusals_total").set(s.refusals)
            g("pilot_cycles_completed_total").set(s.cycles_completed)
            g("pilot_cycle_stage").set(STAGES.index(s.stage))
            g("pilot_serve_only").set(
                1.0 if s.mode == MODE_SERVE_ONLY else 0.0)
            g("pilot_consecutive_failures").set(s.consecutive_failures)
            g("pilot_deadline_overruns_total").set(s.deadline_overruns)
            if s.staleness_seconds is not None:
                g("pilot_staleness_seconds").set(s.staleness_seconds)
            if self.ring.live is not None:
                g("pilot_generation_live").set(self.ring.live)
        except Exception:  # noqa: BLE001 - telemetry never alters the
            # control loop.
            logger.debug("pilot gauges unavailable", exc_info=True)

    def metrics_families(self) -> list[dict]:
        """The /metrics collector (register with ``MonitorServer``): the
        labelled outcome counters and the one-hot stage state-set, the
        families the flat registry gauges cannot express. The plain
        gauges reach /metrics through the registry collector
        (``_export_gauges``); emitting them here too would collide on
        the family name."""
        from photon_tpu_torch.obs import monitor

        s = self.state
        return [
            monitor.family(
                "pilot_cycle_events_total", "counter",
                "control-loop outcomes by kind",
                [
                    ("", {"kind": "promotion"}, float(s.promotions)),
                    ("", {"kind": "rollback"}, float(s.rollbacks)),
                    ("", {"kind": "refusal"}, float(s.refusals)),
                    ("", {"kind": "failure"}, float(s.failures)),
                    ("", {"kind": "deadline_overrun"},
                     float(s.deadline_overruns)),
                ],
            ),
            monitor.state_family(
                "pilot_cycle_stage_state", STAGES, s.stage,
                "one-hot pilot state-machine stage",
            ),
        ]
