"""CoordinateDescent: the GAME outer loop with residual-score bookkeeping
(port of ``photon_tpu/algorithm/coordinate_descent.py``).

Coordinate k trains against the base offsets plus the sum of every
other coordinate's scores; its new scores then replace its old ones in
the running total, ``total - old + new`` (CoordinateDescent.scala:442,
583). Every coordinate's scores are one [n] tensor in canonical row
order. Locked coordinates contribute scores and are never retrained.

With a ``ValidationContext`` the validation scores are kept the same
way, one [n_val] tensor per coordinate, and after every update only the
updated coordinate's are swapped into their total; the suite then
evaluates the total, and the best full model by the primary evaluator
is kept (descendWithValidation, :493 and :312-333).

Each update is a ``coord:<cid>`` telemetry span carrying its iteration
(host time only: the span waits for nothing, so it adds no host sync);
with an ``emitter`` the loop sends a ``CoordinateUpdateEvent`` per
update and a ``CoordinateRollbackEvent`` per rolled-back one.

With a ``FitLedgerFeed`` (the estimator makes one when telemetry and
the cost ledger are both on) the loop times every update for the cost
ledger; without one it adds nothing.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable

import torch

from photon_tpu_torch import obs
from photon_tpu_torch.evaluation.suite import (
    EvaluationResults,
    EvaluationSuite,
)
from photon_tpu_torch.models.game import GameModel
from photon_tpu_torch.resilience import faults
from photon_tpu_torch.resilience.errors import NonFiniteUpdateError

logger = logging.getLogger(__name__)

# The cost ledger's name for the unfused fit's program: this loop of
# coordinate updates (the fused fit books "fused_fit" and "materialize").
FIT_PROGRAM = "coordinate_descent"
# Host syncs made by ``FitLedgerFeed.close``: one a fit on the card with
# the ledger armed, none on the CPU or with the ledger off.
feed_syncs = 0
# Each thread's timing events, reused by its next feed: a feed resolves
# every event it recorded before it returns, so none is still pending
# when the next fit records it again (creating and destroying a CUDA
# event per update costs more than recording one).
_events = threading.local()


def _sub_add(total: torch.Tensor, old: torch.Tensor,
             new: torch.Tensor) -> torch.Tensor:
    """summedScores - oldScores + previousScores."""
    return total - old + new


def _model_weight_tensors(model) -> list:
    glm = getattr(model, "model", model)
    coefs = getattr(glm, "coefficients", None)
    if coefs is None:
        return []
    means = getattr(coefs, "means", None)
    if means is not None:
        return [means]
    return [coefs] if isinstance(coefs, torch.Tensor) else []


def _update_is_finite(model, scores: torch.Tensor) -> bool:
    """One host sync: are the update's scores and weights all finite?"""
    return all(bool(torch.isfinite(t).all())
               for t in [scores, *_model_weight_tensors(model)])


def register_kernel_census(newton_shapes, segment_sites) -> None:
    """Register, with their counts from ``analysis/costmodel.py``, the
    Newton bucket shapes (``newton_step/<B>x<R>x<S>``) and segment-sum
    sites (``segment_sum/<site>``) a fit launched on the card."""
    from photon_tpu_torch.analysis import costmodel
    from photon_tpu_torch.obs import ledger
    from photon_tpu_torch.ops import segment_reduce

    for shape in newton_shapes:
        ledger.register_program(
            "newton_step/{}x{}x{}".format(*shape), phase="fit",
            cost=costmodel.newton_step_cost(shape))
    for site in segment_sites:
        ledger.register_program(
            f"segment_sum/{site}", phase="fit",
            cost=segment_reduce.site_cost(site))


class FitLedgerFeed:
    """The cost ledger's feed of one fit (the JAX package's
    ``FusedFit._ledger_record``, on this loop).

    ``start``/``stop`` bracket each coordinate update (train, score and
    the non-finite check). On the card each bracket is a pair of CUDA
    events recorded on the current stream, so the window is the device's
    time from reaching the update to finishing it, not the time to
    enqueue it; the events add no launch and no sync, and ``close``
    resolves them all with ONE sync on the last (counted in
    ``feed_syncs``). On the CPU every op completes before it returns, so
    the windows are ``perf_counter`` stamps. The events are this
    thread's, made once and recorded again by every later fit.

    ``close`` books, under program ``FIT_PROGRAM`` and phase ``fit``,
    the windows to one ``(cid, "fit", FIT_PROGRAM)`` row a coordinate
    (``record_dispatch(..., parts=...)``), the rest of the fit's
    measured wall (validation, checkpoints, host work between updates)
    to the ``("-", "host", "unattributed")`` row, and the slabs'
    resident bytes under ``FIT_PROGRAM + "/slabs"``. It registers the
    fit's program (measured-only: no static count covers a loop of
    solver iterations) and, with their counts from
    ``analysis/costmodel.py``, every Newton bucket shape
    (``newton_step/<B>x<R>x<S>``) and segment-sum site
    (``segment_sum/<site>``) the fit launched on the card.
    """

    def __init__(self, device):
        from photon_tpu_torch.ops import newton_kernel, segment_reduce

        self.cuda = torch.device(device).type == "cuda"
        self.updates: list = []
        if self.cuda:
            self.stream = torch.cuda.current_stream(device)
            self.pool = _events.__dict__.setdefault("pool", [])
            self.used = 0
        self._newton0 = dict(newton_kernel.launches_by_shape)
        self._segment0 = dict(segment_reduce.launches_by_site)
        self.t0 = time.perf_counter()

    def start(self):
        if self.cuda:
            if self.used == len(self.pool):
                self.pool.append(torch.cuda.Event(enable_timing=True))
            event = self.pool[self.used]
            self.used += 1
            event.record(self.stream)
            return event
        return time.perf_counter()

    def stop(self, cid: str, start) -> None:
        self.updates.append((cid, start, self.start()))

    def close(self, slab_bytes: int = 0) -> None:
        """Resolve the windows and book the fit."""
        global feed_syncs
        from photon_tpu_torch.obs import ledger
        from photon_tpu_torch.ops import newton_kernel, segment_reduce

        if self.cuda and self.updates:
            self.updates[-1][2].synchronize()
            feed_syncs += 1
        t1 = time.perf_counter()
        parts: dict = {}
        for cid, a, b in self.updates:
            s = a.elapsed_time(b) / 1e3 if self.cuda else b - a
            parts[cid] = parts.get(cid, 0.0) + s
        named = sum(parts.values())
        wall = t1 - self.t0
        ledger.register_program(FIT_PROGRAM, phase="fit")
        register_kernel_census(
            [s for s, n in newton_kernel.launches_by_shape.items()
             if n > self._newton0.get(s, 0)],
            [s for s, n in segment_reduce.launches_by_site.items()
             if n > self._segment0.get(s, 0)])
        if parts:
            ledger.record_dispatch(FIT_PROGRAM, named, phase="fit",
                                   start=self.t0, end=t1, parts=parts)
        ledger.record_unattributed(max(wall - named, 0.0))
        ledger.set_resident(f"{FIT_PROGRAM}/slabs", slab_bytes)


@dataclasses.dataclass(frozen=True)
class ValidationContext:
    """The validation suite and one scorer per coordinate:
    ``scorers[k](model)`` is coordinate k's score of every validation
    row."""

    suite: EvaluationSuite
    scorers: dict[str, Callable[[Any], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class CoordinateUpdateRecord:
    """One coordinate update: solver diagnostics and the host time the
    update took (training is asynchronous on the card, so this is the
    time to issue it plus any sync the solver made)."""

    iteration: int
    coordinate_id: str
    # None for a fused fit's record with telemetry off: one graph runs
    # the whole fit, so no update has a time of its own.
    seconds: float | None
    diagnostics: Any
    evaluation: EvaluationResults | None = None
    # True when the update was non-finite and the previous iterate kept.
    rolled_back: bool = False


@dataclasses.dataclass(frozen=True)
class CoordinateDescentResult:
    model: GameModel  # after the last iteration
    best_model: GameModel  # best by validation (``model`` without it)
    best_evaluation: EvaluationResults | None
    history: tuple


class CoordinateDescent:
    """Reference: algorithm/CoordinateDescent.scala:43. ``update_sequence``
    lists coordinate ids in update order; ids in ``locked_coordinates``
    need a model in ``initial_models`` and only score."""

    def __init__(self, update_sequence: list, num_iterations: int, *,
                 locked_coordinates: set | None = None,
                 non_finite_guard: bool = False, emitter=None):
        if num_iterations < 1:
            raise ValueError(f"num_iterations must be >= 1: {num_iterations}")
        if len(set(update_sequence)) != len(update_sequence):
            raise ValueError(f"duplicate coordinate id in {update_sequence}")
        self.update_sequence = list(update_sequence)
        self.num_iterations = num_iterations
        self.locked_coordinates = set(locked_coordinates or ())
        self.non_finite_guard = bool(non_finite_guard)
        # events.EventEmitter, or None: no events.
        self.emitter = emitter
        if not [c for c in update_sequence
                if c not in self.locked_coordinates]:
            raise ValueError(
                "update sequence contains no trainable coordinates "
                "(CoordinateDescent.scala:71 checkInvariants)")

    def run(self, coordinates: dict, initial_models: dict | None = None,
            validation: ValidationContext | None = None, *,
            seed: int = 0, start_iteration: int = 0, on_iteration=None,
            initial_best=None,
            ledger_feed: FitLedgerFeed | None = None
            ) -> CoordinateDescentResult:
        """Train every coordinate by block coordinate descent.

        ``start_iteration`` resumes mid-descent: iterations before it
        are baked into ``initial_models``, and the rest run with the
        seeds the uninterrupted run would have used. ``initial_best``,
        a ``(model, evaluation)`` pair, seeds the best-by-validation
        tracking on resume. ``on_iteration(it, model, best_model)``
        runs after each outer iteration (the checkpointer's hook), and
        the ``cd.iteration`` fault point right after it.
        ``ledger_feed`` (a ``FitLedgerFeed``) times each update.
        """
        if not 0 <= start_iteration <= self.num_iterations:
            raise ValueError(
                f"start_iteration {start_iteration} outside "
                f"[0, {self.num_iterations}]")
        for cid in self.update_sequence:
            if cid not in coordinates:
                raise KeyError(f"no coordinate for id {cid!r}")
        initial_models = dict(initial_models or {})
        for cid in self.locked_coordinates:
            if cid not in initial_models:
                raise ValueError(
                    f"locked coordinate {cid!r} needs an initial model "
                    "(partialRetrainLockedCoordinates invariant)")
        models: dict = {}
        scores: dict = {}
        total = None
        for cid in self.update_sequence:
            if cid in initial_models:
                models[cid] = initial_models[cid]
                s = coordinates[cid].score(models[cid])
                scores[cid] = s
                total = s if total is None else total + s

        history = []
        best_model, best_eval = initial_best or (None, None)
        all_ids = set(self.update_sequence)
        val_scores: dict = {}
        val_total = None
        for it in range(start_iteration, self.num_iterations):
            for cid in self.update_sequence:
                if cid in self.locked_coordinates:
                    continue
                coord = coordinates[cid]
                t0 = time.perf_counter()
                rolled_back = False
                with obs.span(f"coord:{cid}", attrs={"iteration": it}):
                    window = (None if ledger_feed is None
                              else ledger_feed.start())
                    residuals = None
                    if total is not None:
                        residuals = total
                        if cid in scores:
                            residuals = residuals - scores[cid]
                    model, diag = coord.train(
                        residuals=residuals, initial_model=models.get(cid),
                        seed=seed + it)
                    new_scores = coord.score(model)
                    if self.non_finite_guard and not _update_is_finite(
                            model, new_scores):
                        if cid not in models:
                            raise NonFiniteUpdateError(
                                f"coordinate {cid!r} produced non-finite "
                                f"loss/weights on its first update (CD "
                                f"iteration {it}): no previous iterate to "
                                "roll back to")
                        rolled_back = True
                    elif total is None:
                        total = new_scores
                    elif cid in scores:
                        total = _sub_add(total, scores[cid], new_scores)
                    else:
                        total = total + new_scores
                    if ledger_feed is not None:
                        ledger_feed.stop(cid, window)
                if rolled_back:
                    logger.warning(
                        "CD iter %d coordinate %s: non-finite update "
                        "rolled back to the previous iterate", it, cid)
                    if obs.enabled():
                        obs.REGISTRY.counter(
                            "coordinate_rollbacks_total", coordinate=cid
                        ).inc()
                        obs.trace.instant("cd.rollback", cat="resilience",
                                          coordinate=cid, iteration=it)
                    record = CoordinateUpdateRecord(
                        it, cid, time.perf_counter() - t0, diag,
                        rolled_back=True)
                    history.append(record)
                    if self.emitter is not None:
                        from photon_tpu_torch.events import (
                            CoordinateRollbackEvent,
                        )

                        self.emitter.send_event(
                            CoordinateRollbackEvent(record))
                    continue
                models[cid] = model
                scores[cid] = new_scores
                seconds = time.perf_counter() - t0
                evaluation = None
                if validation is not None:
                    # Only the updated coordinate is rescored; warm-start
                    # and locked models enter on their first appearance.
                    for vid, m in models.items():
                        if vid == cid or vid not in val_scores:
                            vs = validation.scorers[vid](m)
                            old = val_scores.get(vid)
                            if val_total is None:
                                val_total = vs
                            elif old is None:
                                val_total = val_total + vs
                            else:
                                val_total = _sub_add(val_total, old, vs)
                            val_scores[vid] = vs
                    evaluation = validation.suite.evaluate(val_total)
                    primary = validation.suite.primary
                    # Only a full model (every coordinate trained or
                    # seeded) may be the best.
                    if set(models) == all_ids and (
                            best_eval is None or primary.better_than(
                                evaluation.primary_evaluation,
                                best_eval.primary_evaluation)):
                        best_eval = evaluation
                        best_model = GameModel(dict(models))
                    logger.info("CD iter %d coordinate %s: %s (%.2fs)", it,
                                cid, evaluation.evaluations, seconds)
                else:
                    logger.info("CD iter %d coordinate %s (%.2fs)", it, cid,
                                seconds)
                record = CoordinateUpdateRecord(
                    it, cid, seconds, diag, evaluation)
                history.append(record)
                if self.emitter is not None:
                    from photon_tpu_torch.events import CoordinateUpdateEvent

                    self.emitter.send_event(CoordinateUpdateEvent(record))
            # The end of an outer iteration is the recovery point: the
            # checkpoint commits, then the kill-and-resume fault point.
            if on_iteration is not None:
                on_iteration(it, GameModel(dict(models)), best_model)
            faults.check("cd.iteration")
        final = GameModel(dict(models))
        return CoordinateDescentResult(
            model=final,
            best_model=final if best_model is None else best_model,
            best_evaluation=best_eval,
            history=tuple(history))
