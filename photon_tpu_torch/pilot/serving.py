"""The pilot's in-process serving stack (port of
``photon_tpu/pilot/serving.py``): tables, ladder and queue, swappable.

One object owns ``CoefficientTables``, ``ScorePrograms`` and
``MicroBatchQueue`` on one device, so the control loop has one handle
to hot-swap (``reload``), probe (``health``) and close. ``reload`` is
``MicroBatchQueue.reload_model``: a values-only refresh copies the new
coefficients into the live tables, which the captured graphs read at
their next replay (nothing recaptured); a structure change captures the
new ladder off the request path and swaps it in inside the queue's
quiesce window. Serving is never torn down for a promotion.

``compile_events`` (``reload``'s key, and ``reload_compile_events``
summed over every reload) counts the CUDA graphs a reload captured: the
JAX package counts XLA compile-cache events under the same name, and
the port has no XLA cache. A values-only reload captures none, a
structure change one a rung; on the CPU nothing is captured.
"""

from __future__ import annotations


class PilotServer:
    """The live scorer the pilot promotes into. All the concurrency
    lives in the queue; this object is the bundle."""

    def __init__(
        self,
        model,
        *,
        rungs=(1, 8, 64),
        max_linger_s: float = 0.002,
        slo=None,
        breaker_threshold: int | None = None,
        queue_kwargs: dict | None = None,
        device=None,
    ):
        from photon_tpu_torch.serve.programs import ScorePrograms, ShapeLadder
        from photon_tpu_torch.serve.queue import MicroBatchQueue
        from photon_tpu_torch.serve.tables import CoefficientTables

        self.tables = CoefficientTables.from_game_model(
            model, device=device)
        self.programs = ScorePrograms(
            self.tables, ladder=ShapeLadder(tuple(rungs))
        )
        self.queue = MicroBatchQueue(
            self.programs,
            max_linger_s=max_linger_s,
            slo=slo,
            breaker_threshold=breaker_threshold,
            **(queue_kwargs or {}),
        )

    #: Graphs captured by every ``reload`` (the JAX package's
    #: compile-cache events; module docstring).
    reload_compile_events: int = 0

    def reload(self, model) -> dict:
        out = self.queue.reload_model(model)
        # A structure change adopted a new ladder: track it, so the
        # submit-side helpers (synthetic traffic) read the live specs.
        self.programs = self.queue.programs
        out["compile_events"] = int(out["programs_compiled"])
        self.reload_compile_events += out["compile_events"]
        return out

    def submit(self, features, entity_ids=None, **kw):
        return self.queue.submit(features, entity_ids, **kw)

    def health(self) -> dict:
        return self.queue.health()

    def reset_breaker(self) -> None:
        self.queue.reset_breaker()

    def close(self, timeout: float | None = None) -> bool:
        return self.queue.close(timeout)

    def __enter__(self) -> "PilotServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close(self.queue.close_timeout_s)
