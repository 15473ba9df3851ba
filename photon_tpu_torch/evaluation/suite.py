"""EvaluationSuite: evaluators bundled over one dataset's columns (port
of ``photon_tpu/evaluation/suite.py``).

Counterpart of photon-lib evaluation/EvaluationSuite.scala:59-90 and
EvaluationResults.scala. Rows live in one canonical order, so evaluation
is elementwise: the evaluated score is the model score plus the row's
offset (EvaluationSuite.scala:62-66).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.evaluation.evaluators import (
    EvaluatorSpec,
    evaluate_at_threshold,
    evaluate_single,
    grouped_auc,
    grouped_auc_per_group,
    grouped_precision_at_k,
    grouped_precision_at_k_per_group,
)


@dataclasses.dataclass(frozen=True)
class EvaluationResults:
    """Reference: evaluation/EvaluationResults.scala."""

    evaluations: dict[str, float]
    primary_evaluator: EvaluatorSpec

    @property
    def primary_evaluation(self) -> float:
        return self.evaluations[self.primary_evaluator.name]


@dataclasses.dataclass(frozen=True)
class EvaluationSuite:
    """Evaluators and the dataset columns they run against.

    ``group_ids`` maps an id tag name (e.g. "queryId") to integer group
    codes aligned with the rows and their number of groups. The first
    spec is the primary evaluator, used for model selection.
    """

    specs: tuple[EvaluatorSpec, ...]
    labels: torch.Tensor
    offsets: torch.Tensor
    weights: torch.Tensor
    group_ids: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.specs:
            raise ValueError("EvaluationSuite needs at least one evaluator")
        for spec in self.specs:
            if (spec.group_tag is not None
                    and spec.group_tag not in self.group_ids):
                raise ValueError(
                    f"evaluator {spec.name} needs id tag {spec.group_tag!r}, "
                    f"got {sorted(self.group_ids)}")

    @property
    def primary(self) -> EvaluatorSpec:
        return self.specs[0]

    def _z(self, scores) -> torch.Tensor:
        z = torch.as_tensor(scores)
        return z.to(self.labels.device, self.labels.dtype) + self.offsets

    def evaluate(self, scores) -> EvaluationResults:
        z = self._z(scores)
        out: dict[str, float] = {}
        for spec in self.specs:
            if spec.threshold_metric is not None:
                out[spec.name] = float(evaluate_at_threshold(
                    spec.threshold_metric, z, self.labels, spec.threshold,
                    self.weights))
                continue
            if spec.group_tag is not None:
                codes, num_groups = self.group_ids[spec.group_tag]
                if spec.precision_k is not None:
                    val = grouped_precision_at_k(
                        z, self.labels, codes, num_groups, spec.precision_k)
                elif spec.evaluator_type.value != "AUC":
                    raise NotImplementedError(
                        f"grouped {spec.evaluator_type} not supported "
                        "as a summary metric (reference MultiEvaluator "
                        "supports AUC and precision@k)")
                else:
                    val = grouped_auc(z, self.labels, codes, num_groups,
                                      self.weights)
            else:
                val = evaluate_single(spec.evaluator_type, z, self.labels,
                                      self.weights)
            out[spec.name] = float(val)
        return EvaluationResults(out, self.primary)

    def evaluate_per_group(self, scores) -> dict[str, np.ndarray]:
        """Metric name -> [num_groups] values of every grouped evaluator,
        NaN where the metric is undefined (a single-class AUC group)."""
        z = self._z(scores)
        out: dict[str, np.ndarray] = {}
        for spec in self.specs:
            if spec.group_tag is None:
                continue
            codes, num_groups = self.group_ids[spec.group_tag]
            if spec.precision_k is not None:
                vals, valid = grouped_precision_at_k_per_group(
                    z, self.labels, codes, num_groups, spec.precision_k)
            elif spec.evaluator_type.value != "AUC":
                raise NotImplementedError(
                    f"grouped {spec.evaluator_type} not supported: "
                    "evaluate_per_group implements AUC and precision@k")
            else:
                vals, valid = grouped_auc_per_group(
                    z, self.labels, codes, num_groups, self.weights)
            out[spec.name] = np.where(valid.cpu().numpy(),
                                      vals.cpu().numpy(), np.nan)
        return out


def make_suite(
    specs: list,
    labels,
    offsets=None,
    weights=None,
    group_ids: dict | None = None,
    dtype: torch.dtype = torch.float64,
) -> EvaluationSuite:
    """An ``EvaluationSuite`` over ``labels`` (and offsets, weights) in
    ``dtype`` on the labels' device."""
    labels = torch.as_tensor(labels)
    dev = labels.device
    labels = labels.to(dtype)
    n = labels.shape[0]

    def column(x, fill: float) -> torch.Tensor:
        if x is None:
            return torch.full((n,), fill, dtype=dtype, device=dev)
        return torch.as_tensor(x).to(dev, dtype)

    parsed = tuple(
        s if isinstance(s, EvaluatorSpec) else EvaluatorSpec.parse(s)
        for s in specs
    )
    return EvaluationSuite(
        specs=parsed,
        labels=labels,
        offsets=column(offsets, 0.0),
        weights=column(weights, 1.0),
        group_ids={
            name: (torch.as_tensor(codes).to(dev), int(num))
            for name, (codes, num) in (group_ids or {}).items()
        },
    )


def encode_group_ids(raw_ids) -> tuple[torch.Tensor, int, dict]:
    """Host: arbitrary group keys to dense codes: ([n] int32 codes,
    number of groups, key -> code)."""
    raw = np.asarray(raw_ids)
    uniq, codes = np.unique(raw, return_inverse=True)
    vocab = {k.item() if hasattr(k, "item") else k: i
             for i, k in enumerate(uniq)}
    return torch.from_numpy(codes.astype(np.int32)), len(uniq), vocab
