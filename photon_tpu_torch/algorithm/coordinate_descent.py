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
"""

from __future__ import annotations

import dataclasses
import logging
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
    seconds: float
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
            initial_best=None) -> CoordinateDescentResult:
        """Train every coordinate by block coordinate descent.

        ``start_iteration`` resumes mid-descent: iterations before it
        are baked into ``initial_models``, and the rest run with the
        seeds the uninterrupted run would have used. ``initial_best``,
        a ``(model, evaluation)`` pair, seeds the best-by-validation
        tracking on resume. ``on_iteration(it, model, best_model)``
        runs after each outer iteration (the checkpointer's hook), and
        the ``cd.iteration`` fault point right after it.
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
