"""Pointwise GLM losses l(z, y) with first and second derivatives in z
(port of ``photon_tpu/ops/losses.py``).

Each family is elementwise over a margin tensor ``z = offset + X @ w``
and a label tensor ``y``:

- logistic: labels in {0, 1} or {-1, 1} (anything above 0.5 is
  positive); l = log1p(exp(-|z|)) + max(z, 0) - 1[y > 0.5] z.
- squared: l = (z - y)^2 / 2.
- poisson: l = exp(zc) - y zc with zc = min(z, POISSON_MAX_MARGIN), so
  loss, dz and dzz stay finite in f32 and remain the exact derivatives of
  one clamped function.
- smoothed hinge: labels mapped to {-1, 1}; piecewise quadratic; dzz = 1
  (the identity-Hessian approximation of the reference).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from photon_tpu_torch.types import TaskType

POSITIVE_RESPONSE_THRESHOLD = 0.5
POISSON_MAX_MARGIN = 30.0

Fn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """A pointwise loss and its derivatives in the margin; ``mean`` is
    the inverse link."""

    name: str
    loss: Fn
    dz: Fn
    dzz: Fn
    mean: Callable[[torch.Tensor], torch.Tensor]


def _is_positive(y: torch.Tensor) -> torch.Tensor:
    return (y > POSITIVE_RESPONSE_THRESHOLD).to(y.dtype)


def _logistic_loss(z, y):
    return (torch.log1p(torch.exp(-z.abs())) + z.clamp(min=0.0)
            - _is_positive(y) * z)


def _logistic_dz(z, y):
    return torch.sigmoid(z) - _is_positive(y)


def _logistic_dzz(z, y):
    s = torch.sigmoid(z)
    return s * (1.0 - s)


def _poisson_margin(z):
    return z.clamp(max=POISSON_MAX_MARGIN)


def _poisson_loss(z, y):
    zc = _poisson_margin(z)
    return torch.exp(zc) - y * zc


def _poisson_dz(z, y):
    return torch.exp(_poisson_margin(z)) - y


def _poisson_dzz(z, y):
    return torch.exp(_poisson_margin(z))


def _sign_label(y):
    return torch.where(y < POSITIVE_RESPONSE_THRESHOLD, -1.0, 1.0).to(y.dtype)


def _hinge_loss(z, y):
    t = _sign_label(y) * z
    return torch.where(
        t <= 0.0, 0.5 - t,
        torch.where(t < 1.0, 0.5 * (1.0 - t) ** 2, torch.zeros_like(t)))


def _hinge_dz(z, y):
    s = _sign_label(y)
    t = s * z
    dt = torch.where(t < 0.0, -torch.ones_like(t),
                     torch.where(t < 1.0, t - 1.0, torch.zeros_like(t)))
    return dt * s


LOGISTIC = PointwiseLoss("logistic", _logistic_loss, _logistic_dz,
                         _logistic_dzz, torch.sigmoid)
SQUARED = PointwiseLoss(
    "squared",
    lambda z, y: 0.5 * (z - y) * (z - y),
    lambda z, y: z - y,
    lambda z, y: torch.ones_like(z),
    lambda z: z,
)
POISSON = PointwiseLoss("poisson", _poisson_loss, _poisson_dz, _poisson_dzz,
                        lambda z: torch.exp(_poisson_margin(z)))
SMOOTHED_HINGE = PointwiseLoss(
    "smoothed_hinge", _hinge_loss, _hinge_dz,
    lambda z, y: torch.ones_like(z), lambda z: z,
)

_BY_TASK = {
    TaskType.LOGISTIC_REGRESSION: LOGISTIC,
    TaskType.LINEAR_REGRESSION: SQUARED,
    TaskType.POISSON_REGRESSION: POISSON,
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: SMOOTHED_HINGE,
}
_BY_NAME = {loss.name: loss for loss in _BY_TASK.values()}


def get_loss(name_or_task: str | TaskType) -> PointwiseLoss:
    """Look up a pointwise loss by name or by training task."""
    if isinstance(name_or_task, TaskType):
        return _BY_TASK[name_or_task]
    try:
        return _BY_NAME[name_or_task]
    except KeyError:
        raise ValueError(
            f"Unknown loss {name_or_task!r}; known: {sorted(_BY_NAME)}"
        ) from None
