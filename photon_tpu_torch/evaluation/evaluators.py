"""Evaluation metrics as sorts and segment sums (port of
``photon_tpu/evaluation/evaluators.py``).

Counterpart of the reference's evaluation framework: ``EvaluatorType``
(photon-lib evaluation/EvaluatorType.scala:59-65), the
``SingleEvaluator`` implementations (photon-api evaluation/*Evaluator.scala),
the weighted tie-aware local AUC (AreaUnderROCCurveLocalEvaluator.scala:72),
``PrecisionAtKLocalEvaluator`` (:76) and the grouped ``MultiEvaluator``
(photon-lib evaluation/MultiEvaluator.scala:36: a metric per group,
NaN/Inf groups dropped, the unweighted mean over groups). A grouped AUC
is one stable two-key sort plus segment sums and running sums, on
whatever device the scores lie.

On the card the f32 sums run in a fixed order, so two evaluations of
the same scores are bit-identical: the segment sums (every caller's ids
are sorted) go through the deterministic segment-sum kernel
(``segment_reduce.sorted_segment_sum``, no float atomics), and the
running sums through ``running_sum``, a float64 scan whose partial sums
are fixed by its block layout, rounded once to the labels' dtype as
the CPU's ``torch.cumsum`` rounds its float64 accumulator. On the CPU
both stay ``index_add_`` and ``torch.cumsum``.

The reference's formula quirks are kept:
- loss evaluators return the weighted SUM of pointwise losses, not a mean;
- SQUARED_LOSS is sum(w * (s-y)^2) (SquaredLossEvaluator.scala undoes the
  pointwise loss's 1/2), and RMSE = sqrt(squared_loss / n) over the
  unweighted count (RMSEEvaluator.scala);
- precision@k divides by k, not by min(k, group size)
  (PrecisionAtKLocalEvaluator.scala:50);
- AUPR is unweighted, with the (0, firstPrecision) anchor point of Spark's
  BinaryClassificationMetrics (AreaUnderPRCurveEvaluator.scala).
"""

from __future__ import annotations

import dataclasses
import enum
import math

import torch

from photon_tpu_torch.ops import losses as losses_mod
from photon_tpu_torch.ops import segment_reduce

_POS = 0.5  # MathConst.POSITIVE_RESPONSE_THRESHOLD


class EvaluatorType(enum.Enum):
    """Names match EvaluatorType.scala, so configs and CLIs stay
    compatible; MAE / MSE / PEAK_F1 come from the legacy driver's metric
    family (photon-client evaluation/Evaluation.scala:33-41)."""

    AUC = "AUC"
    AUPR = "AUPR"
    RMSE = "RMSE"
    LOGISTIC_LOSS = "LOGISTIC_LOSS"
    POISSON_LOSS = "POISSON_LOSS"
    SMOOTHED_HINGE_LOSS = "SMOOTHED_HINGE_LOSS"
    SQUARED_LOSS = "SQUARED_LOSS"
    MAE = "MAE"
    MSE = "MSE"
    PEAK_F1 = "PEAK_F1"

    @property
    def bigger_is_better(self) -> bool:
        """The model-selection comparator direction (EvaluatorType.op)."""
        return self in (
            EvaluatorType.AUC, EvaluatorType.AUPR, EvaluatorType.PEAK_F1
        )

    def better_than(self, a: float, b: float) -> bool:
        return a > b if self.bigger_is_better else a < b


# Threshold-based binary metric names (legacy driver Evaluation.scala:196).
THRESHOLD_METRICS = ("PRECISION", "RECALL", "F1", "ACCURACY")


def _ones(scores: torch.Tensor, weights) -> torch.Tensor:
    return torch.ones_like(scores) if weights is None else weights


def _argsort(keys: torch.Tensor) -> torch.Tensor:
    """Stable ascending order (``jnp.argsort``)."""
    return torch.sort(keys, stable=True).indices


def _lexsort(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """Stable order by ``major`` then ``minor`` (``jnp.lexsort((minor,
    major))``)."""
    first = _argsort(minor)
    return first[_argsort(major[first])]


def _segment_sum(values: torch.Tensor, ids: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Sums of ``values`` by SORTED ``ids``: the segment-sum kernel for
    f32 on the card, ``index_add_`` otherwise."""
    if values.device.type == "cuda" and values.dtype == torch.float32:
        return segment_reduce.sorted_segment_sum(values, ids, n,
                                                 site="evaluation")
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids.long(), values)


# Elements a row of ``running_sum``'s blocked scan.
SCAN_BLOCK = 1024


def running_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum of a 1-D tensor, each sum accumulated in
    float64 and rounded once to ``x``'s dtype. On the CPU
    ``torch.cumsum``, which accumulates a float32 scan in float64.
    Elsewhere ``blocked_running_sum`` on the float64 values: a 1-D
    ``torch.cumsum`` of more than one tile on the card is a single-pass
    scan whose partial sums depend on the run's timing, and one in
    float32 rounds at every step, where the grouped AUC's differences of
    running sums near the total negative weight cannot afford it. A 1-D
    float64 ``torch.cumsum`` repeats itself only while its sums are
    exact, which f32 values spanning fewer than 53 - log2(n) bits
    guarantee and wider weights do not (``chip_smoke.py``'s
    ``scan_stability`` counts the runs that differ)."""
    if x.device.type == "cpu":
        return torch.cumsum(x, 0)
    return blocked_running_sum(x.double()).to(x.dtype)


def blocked_running_sum(x: torch.Tensor) -> torch.Tensor:
    """A running sum with a fixed order of additions, on any device:
    ``x`` in rows of ``SCAN_BLOCK``, each row scanned along its length
    (PyTorch's row scan, one fixed tree a row), the row totals scanned
    the same way (recursively), and each row's predecessor total added
    to it."""
    n = x.shape[0]
    if n <= SCAN_BLOCK:
        # Two rows keep the scan on the row kernel.
        return torch.stack([x, torch.zeros_like(x)]).cumsum(1)[0]
    rows = -(-n // SCAN_BLOCK)
    blocks = torch.nn.functional.pad(x, (0, rows * SCAN_BLOCK - n)).view(
        rows, SCAN_BLOCK).cumsum(1)
    carry = blocked_running_sum(blocks[:-1, -1].contiguous())
    blocks[1:] += carry[:, None]
    return blocks.reshape(-1)[:n]


# --------------------------------------------------------------------------
# Single (whole-dataset) evaluators
# --------------------------------------------------------------------------


def auc_roc(scores, labels, weights=None) -> torch.Tensor:
    """Weighted, tie-aware area under the ROC curve (the reference's
    sweep, AreaUnderROCCurveLocalEvaluator:72): ties give half credit,
    weights weight both class counts; NaN when a class is absent."""
    n = scores.shape[0]
    w = _ones(scores, weights)
    s, y, w = _grouped_sort(scores, labels, w)
    gid = torch.zeros(n, dtype=torch.int64, device=scores.device)
    return _segment_auc(s, y, w, gid, 1)[0]


def auc_pr(scores, labels) -> torch.Tensor:
    """Unweighted area under the precision-recall curve, Spark-style:
    thresholds at distinct scores, trapezoid rule, (0, firstPrecision)
    anchor (Spark BinaryClassificationMetrics.pr / SPARK-21806)."""
    n = scores.shape[0]
    order = _argsort(-scores)
    s = scores[order]
    y = (labels[order] > _POS).to(scores.dtype)
    tp = running_sum(y)
    fp = running_sum(1.0 - y)
    total_pos = tp[-1]
    # Only tie-block ends are curve points.
    is_boundary = torch.cat([s[1:] != s[:-1],
                             torch.ones(1, dtype=torch.bool,
                                        device=s.device)])
    precision = tp / torch.clamp(tp + fp, min=1.0)
    recall = tp / torch.clamp(total_pos, min=1.0)
    idx = torch.nonzero(is_boundary).flatten()
    num_pts = idx.shape[0]
    idx = torch.cat([idx, torch.full((n - num_pts,), n - 1,
                                     dtype=idx.dtype, device=idx.device)])
    p_pts = precision[idx]
    r_pts = recall[idx]
    valid = torch.arange(n, device=s.device) < num_pts
    p_prev = torch.cat([p_pts[:1], p_pts[:-1]])
    r_prev = torch.cat([torch.zeros(1, dtype=s.dtype, device=s.device),
                        r_pts[:-1]])
    areas = (r_pts - r_prev) * 0.5 * (p_pts + p_prev)
    return torch.sum(torch.where(valid, areas, torch.zeros_like(areas)))


def _weighted_loss_sum(loss, scores, labels, weights):
    return torch.sum(_ones(scores, weights) * loss.loss(scores, labels))


def logistic_loss(scores, labels, weights=None):
    return _weighted_loss_sum(losses_mod.LOGISTIC, scores, labels, weights)


def poisson_loss(scores, labels, weights=None):
    return _weighted_loss_sum(losses_mod.POISSON, scores, labels, weights)


def squared_loss(scores, labels, weights=None):
    """sum(w * (s - y)^2): the evaluator undoes the pointwise loss's 1/2
    (SquaredLossEvaluator.scala)."""
    return 2.0 * _weighted_loss_sum(losses_mod.SQUARED, scores, labels,
                                    weights)


def smoothed_hinge_loss(scores, labels, weights=None):
    return _weighted_loss_sum(losses_mod.SMOOTHED_HINGE, scores, labels,
                              weights)


def mae(scores, labels, weights=None):
    """Weighted mean absolute error (Evaluation.scala MEAN_ABSOLUTE_ERROR)."""
    w = _ones(scores, weights)
    return torch.sum(w * torch.abs(scores - labels)) / torch.sum(w)


def mse(scores, labels, weights=None):
    """Weighted mean squared error (Evaluation.scala MEAN_SQUARE_ERROR)."""
    w = _ones(scores, weights)
    d = scores - labels
    return torch.sum(w * d * d) / torch.sum(w)


def _confusion_weights(scores, labels, threshold, weights):
    """Weighted (tp, fp, fn, tn) at a mean-space threshold: the cut on
    the margin is logit(threshold) (Evaluation.scala thresholds the model
    mean)."""
    t = math.log(threshold) - math.log1p(-threshold)
    w = _ones(scores, weights)
    zero = torch.zeros_like(w)
    pred = scores >= t
    pos = labels > _POS
    tp = torch.sum(torch.where(pred & pos, w, zero))
    fp = torch.sum(torch.where(pred & ~pos, w, zero))
    fn = torch.sum(torch.where(~pred & pos, w, zero))
    tn = torch.sum(torch.where(~pred & ~pos, w, zero))
    return tp, fp, fn, tn


def _ratio(num, den):
    return torch.where(den > 0, num / torch.clamp(den, min=1e-300),
                       torch.zeros_like(den))


def precision_at_threshold(scores, labels, threshold, weights=None):
    tp, fp, _, _ = _confusion_weights(scores, labels, threshold, weights)
    return _ratio(tp, tp + fp)


def recall_at_threshold(scores, labels, threshold, weights=None):
    tp, _, fn, _ = _confusion_weights(scores, labels, threshold, weights)
    return _ratio(tp, tp + fn)


def f1_at_threshold(scores, labels, threshold, weights=None):
    tp, fp, fn, _ = _confusion_weights(scores, labels, threshold, weights)
    return _ratio(2.0 * tp, 2.0 * tp + fp + fn)


def accuracy_at_threshold(scores, labels, threshold, weights=None):
    tp, fp, fn, tn = _confusion_weights(scores, labels, threshold, weights)
    return _ratio(tp + tn, tp + fp + fn + tn)


def peak_f1(scores, labels, weights=None):
    """Max F1 over every score threshold, tie-aware (Evaluation.scala
    PEAK_F1_SCORE): sorted descending, F1 at a cut is
    2 tp / (predicted + positives), and only tie-block ends are cuts."""
    w = _ones(scores, weights)
    order = _argsort(-scores)
    s = scores[order]
    pos_w = torch.where(labels[order] > _POS, w[order],
                        torch.zeros_like(w))
    tp = running_sum(pos_w)
    pred = running_sum(w[order])
    f1 = 2.0 * tp / torch.clamp(pred + tp[-1], min=1e-300)
    block_end = torch.cat([s[:-1] != s[1:],
                           torch.ones(1, dtype=torch.bool, device=s.device)])
    return torch.max(torch.where(block_end, f1,
                                 torch.full_like(f1, float("-inf"))))


def rmse(scores, labels, weights=None):
    """sqrt(sum(w * (s-y)^2) / n) (RMSEEvaluator.scala: the squared loss
    over the unweighted count)."""
    return torch.sqrt(squared_loss(scores, labels, weights)
                      / scores.shape[0])


_SINGLE = {
    EvaluatorType.AUC: lambda s, y, w: auc_roc(s, y, w),
    EvaluatorType.AUPR: lambda s, y, w: auc_pr(s, y),
    EvaluatorType.RMSE: rmse,
    EvaluatorType.LOGISTIC_LOSS: logistic_loss,
    EvaluatorType.POISSON_LOSS: poisson_loss,
    EvaluatorType.SMOOTHED_HINGE_LOSS: smoothed_hinge_loss,
    EvaluatorType.SQUARED_LOSS: squared_loss,
    EvaluatorType.MAE: mae,
    EvaluatorType.MSE: mse,
    EvaluatorType.PEAK_F1: peak_f1,
}

_THRESHOLD = {
    "PRECISION": precision_at_threshold,
    "RECALL": recall_at_threshold,
    "F1": f1_at_threshold,
    "ACCURACY": accuracy_at_threshold,
}


def evaluate_at_threshold(metric: str, scores, labels, threshold: float,
                          weights=None):
    return _THRESHOLD[metric](scores, labels, threshold, weights)


def evaluate_single(evaluator_type: EvaluatorType, scores, labels,
                    weights=None):
    return _SINGLE[evaluator_type](scores, labels, weights)


# --------------------------------------------------------------------------
# Grouped (multi) evaluators
# --------------------------------------------------------------------------


def _grouped_sort(scores, labels, weights, group_ids=None):
    """Columns in (group asc, score asc) order (+ the sorted groups)."""
    if group_ids is None:
        order = _argsort(scores)
        return scores[order], labels[order], weights[order]
    order = _lexsort(scores, group_ids)
    return scores[order], labels[order], weights[order], group_ids[order]


def _segment_auc(s, y, w, gid, num_groups):
    """Per-group weighted tie-aware AUC; inputs sorted by (gid, score
    asc). Each positive row earns the negative weight strictly below it
    in its group plus half its tie block's; normalized by (positive
    total * negative total) per group; NaN or inf where a class is
    missing."""
    n = s.shape[0]
    zero = torch.zeros_like(w)
    pos_w = torch.where(y > _POS, w, zero)
    neg_w = torch.where(y > _POS, zero, w)
    gid = gid.long()

    # Tie blocks: a new block where the group or the score changes.
    first = torch.ones(1, dtype=torch.bool, device=s.device)
    new_block = torch.cat([first, (s[1:] != s[:-1]) | (gid[1:] != gid[:-1])])
    tid = torch.cumsum(new_block.long(), 0) - 1

    neg_per_tie = _segment_sum(neg_w, tid, n)
    # Negative weight strictly below each tie block, less the negatives
    # of earlier groups.
    neg_below_tie = running_sum(neg_per_tie) - neg_per_tie
    neg_per_group = _segment_sum(neg_w, gid, num_groups)
    group_offset = running_sum(neg_per_group) - neg_per_group
    credit = pos_w * (neg_below_tie[tid] - group_offset[gid]
                      + 0.5 * neg_per_tie[tid])

    raw = _segment_sum(credit, gid, num_groups)
    pos_per_group = _segment_sum(pos_w, gid, num_groups)
    return raw / (pos_per_group * neg_per_group)


def grouped_auc_per_group(scores, labels, group_ids, num_groups,
                          weights=None):
    """(per-group AUC [G], validity mask [G]): single-class groups are
    invalid (MultiEvaluator.scala:50-65)."""
    w = _ones(scores, weights)
    s, y, w, g = _grouped_sort(scores, labels, w, group_ids)
    per_group = _segment_auc(s, y, w, g, num_groups)
    return per_group, torch.isfinite(per_group)


def grouped_auc(scores, labels, group_ids, num_groups, weights=None):
    """Mean per-group AUC over the groups with both classes
    (AreaUnderROCCurveMultiEvaluator)."""
    per_group, finite = grouped_auc_per_group(
        scores, labels, group_ids, num_groups, weights)
    kept = torch.where(finite, per_group, torch.zeros_like(per_group))
    return torch.sum(kept) / torch.clamp(torch.sum(finite), min=1)


def grouped_precision_at_k_per_group(scores, labels, group_ids,
                                     num_groups, k: int):
    """(per-group precision@k [G], presence mask [G])."""
    order = _lexsort(-scores, group_ids)
    g = group_ids[order].long()
    y = labels[order]
    n = scores.shape[0]
    pos = torch.arange(n, device=scores.device)
    start = torch.full((num_groups,), n, dtype=pos.dtype,
                       device=scores.device)
    start = start.scatter_reduce(0, g, pos, reduce="amin")
    rank = pos - start[g]
    hit = (rank < k) & (y > _POS)
    hits = _segment_sum(hit.to(scores.dtype), g, num_groups)
    sizes = _segment_sum(torch.ones_like(scores), g, num_groups)
    return hits / k, sizes > 0


def grouped_precision_at_k(scores, labels, group_ids, num_groups, k: int):
    """Mean per-group precision@k (hits in the top k by score, over k)
    (PrecisionAtKMultiEvaluator)."""
    per_group, present = grouped_precision_at_k_per_group(
        scores, labels, group_ids, num_groups, k)
    kept = torch.where(present, per_group, torch.zeros_like(per_group))
    return torch.sum(kept) / torch.clamp(torch.sum(present), min=1)


@dataclasses.dataclass(frozen=True)
class EvaluatorSpec:
    """One requested metric: a single evaluator, a multi evaluator bound
    to an id tag, or a threshold metric. String forms mirror the
    reference's evaluator ids: ``AUC``, ``AUC:userId``,
    ``PRECISION@5:queryId``, ``F1=0.25``."""

    evaluator_type: EvaluatorType | None = None
    group_tag: str | None = None
    precision_k: int | None = None
    threshold_metric: str | None = None
    threshold: float | None = None

    @property
    def name(self) -> str:
        if self.threshold_metric is not None:
            return f"{self.threshold_metric}={self.threshold:g}"
        if self.precision_k is not None:
            return f"PRECISION@{self.precision_k}:{self.group_tag}"
        if self.evaluator_type is None:
            raise ValueError("EvaluatorSpec names no metric")
        if self.group_tag is not None:
            return f"{self.evaluator_type.value}:{self.group_tag}"
        return self.evaluator_type.value

    @property
    def bigger_is_better(self) -> bool:
        if self.precision_k is not None or self.threshold_metric is not None:
            return True
        return self.evaluator_type.bigger_is_better

    def better_than(self, a: float, b: float) -> bool:
        return a > b if self.bigger_is_better else a < b

    @staticmethod
    def parse(spec: str) -> "EvaluatorSpec":
        spec = spec.strip()
        if "=" in spec:
            head, t = spec.split("=", 1)
            head = head.strip().upper()
            if ":" in t:
                raise ValueError(
                    f"threshold metrics do not support group tags "
                    f"(got {spec!r}); the reference's per-group evaluation "
                    f"covers AUC and precision@k only "
                    f"(MultiEvaluatorType.scala:52-66)"
                )
            if head not in THRESHOLD_METRICS:
                raise ValueError(
                    f"unknown threshold metric {head!r}; expected one of "
                    f"{THRESHOLD_METRICS}"
                )
            threshold = float(t)
            if not 0.0 < threshold < 1.0:
                raise ValueError(
                    f"threshold metric cut must be in (0, 1): it applies "
                    f"to the model mean; got {threshold}"
                )
            return EvaluatorSpec(threshold_metric=head, threshold=threshold)
        if ":" in spec:
            head, tag = spec.split(":", 1)
            if head.upper().startswith("PRECISION@"):
                return EvaluatorSpec(group_tag=tag,
                                     precision_k=int(head.split("@", 1)[1]))
            return EvaluatorSpec(EvaluatorType(head.upper()), group_tag=tag)
        return EvaluatorSpec(EvaluatorType(spec.upper()))
