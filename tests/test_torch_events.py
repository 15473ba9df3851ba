"""The port's event system (``photon_tpu_torch.events``): the listener
registry and the estimator's training events, ported from
``tests/test_events.py``.

Reference: photon-client event/EventEmitter.scala:24 (listener registry
with synchronous ``sendEvent`` fan-out) and Event.scala:65 (typed event
classes). The estimator case runs the same fit through both packages
and compares the event sequences.
"""

import numpy as np
import pytest
import torch

from photon_tpu_torch import optim
from photon_tpu_torch import types
from photon_tpu_torch.algorithm import problems
from photon_tpu_torch.data import random_effect as re_mod
from photon_tpu_torch.data.dataset import DenseFeatures
from photon_tpu_torch.data.game_data import make_game_dataset
from photon_tpu_torch.estimators import game_estimator as est_mod
from photon_tpu_torch.events import (
    CoordinateUpdateEvent,
    EventEmitter,
    FitEndEvent,
    PhotonEvent,
)


def test_emitter_registry():
    got = []
    emitter = EventEmitter()
    listener = got.append
    emitter.add_listener(listener)
    e = PhotonEvent()
    emitter.send_event(e)
    assert got == [e]
    emitter.remove_listener(listener)
    emitter.send_event(e)
    assert got == [e]


def test_listener_mutation_during_emit_does_not_skip():
    """The fan-out iterates a snapshot taken under the emitter's lock:
    a listener removing itself mid-emit must not skip the listener that
    followed it (the classic mutate-during-iteration bug the pre-fix
    in-place loop had)."""
    emitter = EventEmitter()
    got = []

    def self_removing(e):
        emitter.remove_listener(self_removing)
        got.append("self")

    emitter.add_listener(self_removing)
    emitter.add_listener(lambda e: got.append("tail"))
    emitter.send_event(PhotonEvent())
    assert got == ["self", "tail"]
    got.clear()
    emitter.send_event(PhotonEvent())
    assert got == ["tail"]


def test_listener_added_during_emit_sees_next_event_only():
    emitter = EventEmitter()
    got = []

    def adder(e):
        got.append("adder")
        emitter.add_listener(lambda ev: got.append("late"))
        emitter.remove_listener(adder)

    emitter.add_listener(adder)
    emitter.send_event(PhotonEvent())
    assert got == ["adder"]  # the late listener missed the live emit
    emitter.send_event(PhotonEvent())
    assert got == ["adder", "late"]


def test_concurrent_register_during_fanout_hammer():
    """Registry mutation from another thread while the training thread
    fans out: the CONCURRENCY_AUDIT contract's runtime counterpart —
    no exception, no deadlock, and the stable listener sees every
    event exactly once."""
    import threading

    emitter = EventEmitter()
    count = [0]
    emitter.add_listener(lambda e: count.__setitem__(0, count[0] + 1))
    stop = threading.Event()

    def churn():
        flip = lambda e: None  # noqa: E731 — identity matters, not body
        while not stop.is_set():
            emitter.add_listener(flip)
            emitter.remove_listener(flip)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    try:
        n = 500
        for _ in range(n):
            emitter.send_event(PhotonEvent())
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert count[0] == n


def test_listener_exception_propagates():
    emitter = EventEmitter([lambda e: (_ for _ in ()).throw(RuntimeError("x"))])
    with pytest.raises(RuntimeError):
        emitter.send_event(PhotonEvent())


def _raiser(e):
    raise RuntimeError("listener boom")


def test_safe_listeners_logs_and_continues(caplog):
    """safe_listeners=True: one raising listener must not abort the
    fan-out — the failure is logged, later listeners still run."""
    got = []
    emitter = EventEmitter(
        [_raiser, got.append], safe_listeners=True
    )
    e = PhotonEvent()
    import logging

    with caplog.at_level(logging.ERROR, logger="photon_tpu_torch.events"):
        emitter.send_event(e)  # does not raise
    assert got == [e]
    assert any(
        "listener" in r.getMessage() and "continuing" in r.getMessage()
        for r in caplog.records
    )


def test_isolate_overrides_per_call():
    """send_event(isolate=...) overrides the constructor default in
    BOTH directions; the synchronous default semantics stay pinned."""
    got = []
    strict = EventEmitter([_raiser, got.append])  # default: propagate
    with pytest.raises(RuntimeError, match="listener boom"):
        strict.send_event(PhotonEvent())
    assert got == []
    strict.send_event(PhotonEvent(), isolate=True)
    assert len(got) == 1

    safe = EventEmitter([_raiser, got.append], safe_listeners=True)
    safe.send_event(PhotonEvent())  # isolated by default
    assert len(got) == 2
    with pytest.raises(RuntimeError, match="listener boom"):
        safe.send_event(PhotonEvent(), isolate=False)
    assert len(got) == 2


def _events_fit(pkg, game, listeners, d):
    """A two-coordinate linear GLMix fit of ``pkg`` (the JAX package's
    or the port's modules) with ``listeners``."""
    optim_, problems, re_mod, est_mod, types = pkg
    l2 = optim_.RegularizationContext(optim_.RegularizationType.L2)
    est = est_mod.GameEstimator(
        types.TaskType.LINEAR_REGRESSION,
        {
            "global": est_mod.FixedEffectCoordinateConfiguration(
                "s", problems.GLMOptimizationConfiguration(
                    regularization=l2, regularization_weight=0.1)),
            "per-u": est_mod.RandomEffectCoordinateConfiguration(
                re_mod.RandomEffectDataConfiguration("u", "s"),
                problems.GLMOptimizationConfiguration(
                    regularization=l2, regularization_weight=1.0)),
        },
        intercept_indices={"s": d - 1},
        num_iterations=2,
        listeners=listeners,
        **({"device": "cpu"} if pkg[0] is optim else {"mesh": "off"}),
    )
    return est.fit(game)


def test_estimator_emits_training_events(rng):
    """The port's estimator emits the events the JAX package's does, in
    the same order, each wrapping the exact history record."""
    import photon_tpu.algorithm.problems as jax_problems
    import photon_tpu.data.random_effect as jax_re
    import photon_tpu.estimators.game_estimator as jax_est
    import photon_tpu.events as jax_events
    import photon_tpu.types as jax_types
    from photon_tpu import optim as jax_optim
    from photon_tpu.data.dataset import DenseFeatures as JaxDense
    from photon_tpu.data.game_data import make_game_dataset as jax_make

    n, d, e = 300, 5, 8
    x = rng.normal(size=(n, d)).astype(np.float64)
    x[:, -1] = 1.0
    users = rng.integers(0, e, size=n)
    y = x @ rng.normal(size=d) + 0.1 * rng.normal(size=n)
    game = make_game_dataset(y, {"s": DenseFeatures(x)},
                             id_tags={"u": users}, device="cpu")
    jgame = jax_make(y, {"s": JaxDense(x)}, id_tags={"u": users})

    events, jevents = [], []
    results = _events_fit(
        (optim, problems, re_mod, est_mod, types), game, [events.append],
        d)
    _events_fit((jax_optim, jax_problems, jax_re, jax_est, jax_types),
                jgame, [jevents.append], d)

    updates = [ev for ev in events if isinstance(ev, CoordinateUpdateEvent)]
    ends = [ev for ev in events if isinstance(ev, FitEndEvent)]
    # 2 CD iterations x 2 coordinates, one config.
    assert [(u.iteration, u.coordinate_id) for u in updates] == [
        (0, "global"), (0, "per-u"), (1, "global"), (1, "per-u")]
    assert all(u.record.seconds >= 0 for u in updates)
    # Events wrap the exact history records.
    assert [u.record for u in updates] == list(results[0].descent.history)
    assert len(ends) == 1 and ends[0].config_index == 0
    assert ends[0].result is results[0]
    # The same sequence as the JAX package's.
    assert [(type(ev).__name__, getattr(ev, "iteration", None),
             getattr(ev, "coordinate_id", None)) for ev in events] == [
        (type(ev).__name__, getattr(ev, "iteration", None),
         getattr(ev, "coordinate_id", None)) for ev in jevents]
    assert all(isinstance(ev, jax_events.PhotonEvent) for ev in jevents)


def test_rollback_emits_rollback_event():
    """A non-finite update rolled back by the guard sends a
    CoordinateRollbackEvent wrapping the rolled-back record and, with
    telemetry on, counts the rollback and marks a ``cd.rollback``
    instant."""
    from photon_tpu_torch import obs
    from photon_tpu_torch.algorithm.coordinate_descent import (
        CoordinateDescent,
    )
    from photon_tpu_torch.events import CoordinateRollbackEvent

    class Coord:
        def __init__(self):
            self.calls = 0

        def train(self, residuals=None, initial_model=None, seed=0):
            self.calls += 1
            value = 1.0 if self.calls == 1 else float("nan")
            return torch.full((3,), value), None

        def score(self, model):
            return model.clone()

    got = []
    was = obs.enabled()
    obs.reset()
    obs.enable()
    try:
        res = CoordinateDescent(["c"], 2, non_finite_guard=True,
                                emitter=EventEmitter([got.append])).run(
            {"c": Coord()})
        snap = obs.REGISTRY.snapshot()
        instants = [ev for ev in obs.trace.events()
                    if ev["name"] == "cd.rollback"]
    finally:
        obs.TRACER.enabled = was
        obs.reset()
    rollbacks = [ev for ev in got if isinstance(ev, CoordinateRollbackEvent)]
    assert len(rollbacks) == 1 and rollbacks[0].iteration == 1
    assert rollbacks[0].record.rolled_back
    assert rollbacks[0].record is res.history[-1]
    assert snap["counters"]["coordinate_rollbacks_total{coordinate=c}"] == 1
    assert instants[0]["args"] == {"coordinate": "c", "iteration": 1}
