"""Slice sampler for GP kernel hyperparameters.

Port of ``photon_tpu/hyperparameter/slice_sampler.py``, the counterpart of
photon-lib hyperparameter/SliceSampler.scala:52 — the classic Neal (2003)
step-out / shrink procedure. The control flow is host-side numpy (slice
sampling is inherently sequential and data-dependent), and so is the
log-density callback the GP gives it (``kernels.log_likelihood_np``). The
explicit ``np.random.default_rng`` draws the same stream as the reference's
sampler for the same seed.
"""

from __future__ import annotations

import numpy as np


class SliceSampler:
    """Reference: SliceSampler.scala:52 (stepSize 1.0, maxStepsOut 1000)."""

    def __init__(self, step_size: float = 1.0, max_steps_out: int = 1000,
                 rng: np.random.Generator | None = None, seed: int = 0):
        self.step_size = step_size
        self.max_steps_out = max_steps_out
        self.rng = rng if rng is not None else np.random.default_rng(seed)

    def draw(self, x: np.ndarray, logp) -> np.ndarray:
        """One sample along a uniformly random direction (draw :70-76)."""
        direction = self.rng.normal(size=x.shape[0])
        direction = direction / np.linalg.norm(direction)
        return self._draw_along(np.asarray(x, dtype=float), logp, direction)

    def draw_dimension_wise(self, x: np.ndarray, logp) -> np.ndarray:
        """One Gibbs sweep: each axis in shuffled order (drawDimensionWise)."""
        x = np.asarray(x, dtype=float)
        dims = self.rng.permutation(x.shape[0])
        for i in dims:
            direction = np.zeros(x.shape[0])
            direction[i] = 1.0
            x = self._draw_along(x, logp, direction)
        return x

    def _draw_along(self, x, logp, direction) -> np.ndarray:
        y = np.log(self.rng.uniform()) + float(logp(x))
        lower, upper = self._step_out(x, y, logp, direction)
        # Shrink until a point on the slice is found (draw :94-113).
        for _ in range(1000):
            t = self.rng.uniform()
            new_x = lower + t * (upper - lower)
            if float(logp(new_x)) > y:
                return new_x
            if new_x @ direction < x @ direction:
                lower = new_x
            elif new_x @ direction > x @ direction:
                upper = new_x
            else:
                raise RuntimeError("Slice size shrank to zero.")
        raise RuntimeError("slice sampler failed to find an acceptable point")

    def _step_out(self, x, y, logp, direction):
        """Widen the slice until both ends fall below y (stepOut :135-155)."""
        lower = x - direction * self.rng.uniform() * self.step_size
        upper = lower + direction * self.step_size
        steps = 0
        while float(logp(lower)) > y and steps < self.max_steps_out:
            lower = lower - direction * self.step_size
            steps += 1
        steps = 0
        while float(logp(upper)) > y and steps < self.max_steps_out:
            upper = upper + direction * self.step_size
            steps += 1
        return lower, upper
