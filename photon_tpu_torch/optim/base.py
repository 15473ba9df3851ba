"""Optimizer configuration, convergence reasons, results and the
convergence cascade (port of ``photon_tpu/optim/base.py``).

Absolute tolerances come from the state at zero coefficients, even on a
warm start (Optimizer.scala:167-170). The cascade order is the
reference's: MAX_ITERATIONS, then OBJECTIVE_NOT_IMPROVING, then
FUNCTION_VALUES_CONVERGED, then GRADIENT_CONVERGED (Optimizer.scala:
126-139). ``convergence_code`` works elementwise, so one call serves a
single solve and a whole bucket of per-entity solves.

A solve over a column-sharded fixed effect (``parallel.mesh
.FeatureShardedSparse``) runs on each rank's slice of every vector
inside ``sharded_over(mesh)``: ``l2norm``, ``dot`` and the batched
solvers' inner products are then this rank's partial sums added over
the ranks (``across_shards``: ``Mesh.sum_parts``, the same bits on every
rank), where the reference's XLA inserts the psum of a sharded
``jnp.dot``. Outside it the vectors are whole and nothing crosses.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import threading
from typing import NamedTuple

import torch


class OptimizerType(enum.Enum):
    LBFGS = "LBFGS"
    TRON = "TRON"


class ConvergenceReason(enum.IntEnum):
    NOT_CONVERGED = 0
    MAX_ITERATIONS = 1
    FUNCTION_VALUES_CONVERGED = 2
    GRADIENT_CONVERGED = 3
    OBJECTIVE_NOT_IMPROVING = 4


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Solver configuration (LBFGS.scala:148-154 defaults: tolerance
    1e-7, 100 iterations, 10 corrections). ``box_constraints`` is a
    (lower, upper) pair for L-BFGS-B."""

    optimizer_type: OptimizerType = OptimizerType.LBFGS
    tolerance: float = 1e-7
    max_iterations: int = 100
    num_corrections: int = 10
    max_improvement_failures: int = 5
    max_cg_iterations: int = 20
    max_line_search_iterations: int = 25
    box_constraints: tuple | None = None

    @staticmethod
    def lbfgs(**kw) -> "OptimizerConfig":
        return OptimizerConfig(optimizer_type=OptimizerType.LBFGS, **kw)

    @staticmethod
    def tron(**kw) -> "OptimizerConfig":
        kw.setdefault("tolerance", 1e-5)
        kw.setdefault("max_iterations", 15)
        return OptimizerConfig(optimizer_type=OptimizerType.TRON, **kw)


class OptResult(NamedTuple):
    """Solver output. ``loss_history`` has ``max_iterations + 1``
    entries, padded with the initial value past the last iteration."""

    coefficients: torch.Tensor
    value: torch.Tensor
    gradient_norm: torch.Tensor
    iterations: torch.Tensor
    convergence_reason: torch.Tensor
    loss_history: torch.Tensor


class Tolerances(NamedTuple):
    loss_abs: torch.Tensor
    gradient_abs: torch.Tensor


_SHARDS = threading.local()


@contextlib.contextmanager
def sharded_over(mesh):
    """Solve on this rank's slices of vectors sharded over ``mesh`` (a
    ``parallel.mesh.Mesh``; None: whole vectors) in this thread."""
    prev = getattr(_SHARDS, "mesh", None)
    _SHARDS.mesh = mesh
    try:
        yield
    finally:
        _SHARDS.mesh = prev


def across_shards(*partials: torch.Tensor) -> tuple:
    """The sums over the ranks of a sharded solve's partial inner
    products (one collective for all of them), or the partials as they
    are outside ``sharded_over``."""
    mesh = getattr(_SHARDS, "mesh", None)
    if mesh is None:
        return partials
    from photon_tpu_torch.parallel.mesh import SITE_INNER_PRODUCTS

    return mesh.sum_parts(*partials, site=SITE_INNER_PRODUCTS)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.dot`` of two vectors, summed over the ranks of a sharded
    solve."""
    return across_shards(torch.dot(a, b))[0]


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(across_shards(torch.sum(x * x, dim=-1))[0])


def absolute_tolerances(fun, template: torch.Tensor,
                        tolerance: float) -> Tolerances:
    """Tolerances from the zero-coefficient state."""
    f0, g0 = fun(torch.zeros_like(template))
    return Tolerances(torch.abs(f0) * tolerance, l2norm(g0) * tolerance)


def convergence_code(
    *,
    iteration: torch.Tensor,
    max_iterations: int,
    loss_delta: torch.Tensor,
    gradient_norm: torch.Tensor,
    tol: Tolerances,
    not_improving: torch.Tensor | None = None,
) -> torch.Tensor:
    """The reference's convergence cascade: a reason code per element,
    0 while still running."""
    if not_improving is None:
        not_improving = torch.zeros_like(loss_delta, dtype=torch.bool)
    code = torch.where(
        gradient_norm <= tol.gradient_abs,
        int(ConvergenceReason.GRADIENT_CONVERGED),
        int(ConvergenceReason.NOT_CONVERGED),
    )
    code = torch.where(torch.abs(loss_delta) <= tol.loss_abs,
                       int(ConvergenceReason.FUNCTION_VALUES_CONVERGED), code)
    code = torch.where(not_improving,
                       int(ConvergenceReason.OBJECTIVE_NOT_IMPROVING), code)
    code = torch.where(iteration >= max_iterations,
                       int(ConvergenceReason.MAX_ITERATIONS), code)
    return code.to(torch.int32)


# Box bounds on their device, by (id of the bounds, dtype, device); each
# entry keeps its bounds alive, so no id is reused. The oldest entries go
# past _MAX_BOUNDS.
_BOUNDS: dict = {}
_MAX_BOUNDS = 64


def box_bounds(box_constraints: tuple, like: torch.Tensor) -> tuple:
    """(lower, upper) as tensors of ``like``'s dtype and device, made once
    per bounds object and kept: a fit's first (eager) solve makes them,
    so a CUDA-graph capture of a later solve copies nothing from the
    host (which a capture refuses)."""
    key = (id(box_constraints), like.dtype, str(like.device))
    hit = _BOUNDS.get(key)
    if hit is None:
        while len(_BOUNDS) >= _MAX_BOUNDS:
            _BOUNDS.pop(next(iter(_BOUNDS)))
        hit = _BOUNDS[key] = (box_constraints, tuple(
            torch.as_tensor(b, dtype=like.dtype, device=like.device)
            for b in box_constraints))
    return hit[1]


def project_box(w: torch.Tensor, box_constraints: tuple | None):
    """Clip coefficients into (lower, upper) after an accepted step
    (OptimizationUtils.projectCoefficientsToSubspace)."""
    if box_constraints is None:
        return w
    lower, upper = box_bounds(box_constraints, w)
    return torch.clamp(w, lower, upper)
