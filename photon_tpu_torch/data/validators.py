"""Row-level input data sanity checks (port of
``photon_tpu/data/validators.py``).

Counterpart of photon-client data/DataValidators.scala:405: per-task
validator stacks over (label, features, offset, weight), gated by
VALIDATE_FULL / VALIDATE_SAMPLE / VALIDATE_DISABLED (the driver's
default is DISABLED, GameDriver.scala:223). Every check is a vectorized
numpy reduction over the dataset's host mirror; one ValueError lists
every failed check and how many rows failed it (sanityCheckData
:230-253).
"""

from __future__ import annotations

import enum

import numpy as np

from photon_tpu_torch.data.game_data import GameDataset
from photon_tpu_torch.types import TaskType

# MathConst.EPSILON: weights must be significantly above zero.
_EPSILON = 1e-12

# BinaryClassifier.{positive,negative}ClassLabel (BinaryClassifier.scala:75).
POSITIVE_CLASS_LABEL = 1.0
NEGATIVE_CLASS_LABEL = 0.0


class DataValidationType(enum.Enum):
    """Reference: DataValidationType (VALIDATE_FULL/SAMPLE/DISABLED)."""

    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    VALIDATE_DISABLED = "VALIDATE_DISABLED"

    @staticmethod
    def parse(value: "DataValidationType | str") -> "DataValidationType":
        if isinstance(value, DataValidationType):
            return value
        v = value.upper()
        if not v.startswith("VALIDATE_"):
            v = "VALIDATE_" + v
        return DataValidationType(v)


def _label_validators(task: TaskType):
    """(mask_fn, message) of the task's label check (the smoothed hinge
    uses the logistic stack)."""
    if task in (TaskType.LOGISTIC_REGRESSION,
                TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        return (
            lambda y: (y == POSITIVE_CLASS_LABEL)
            | (y == NEGATIVE_CLASS_LABEL),
            "Data contains row(s) with non-binary label(s)",
        )
    if task == TaskType.POISSON_REGRESSION:
        return (
            lambda y: np.isfinite(y) & (y >= 0),
            "Data contains row(s) with invalid (-, Inf, or NaN) label(s)",
        )
    return (
        np.isfinite,
        "Data contains row(s) with invalid (+/- Inf or NaN) label(s)",
    )


def sanity_check_data(
    data: GameDataset,
    task: TaskType,
    validation_type: DataValidationType | str = (
        DataValidationType.VALIDATE_FULL),
    *,
    check_labels: bool = True,
    seed: int = 0,
) -> None:
    """Raise ValueError listing every failed check (sanityCheckData).

    ``check_labels=False`` is the scoring driver's variant (scoring rows
    may carry dummy labels). VALIDATE_SAMPLE checks a deterministic 10%
    row subsample (the reference's RDD.sample(fraction = 0.10)).
    """
    validation_type = DataValidationType.parse(validation_type)
    if validation_type == DataValidationType.VALIDATE_DISABLED:
        return

    n = data.num_samples
    if validation_type == DataValidationType.VALIDATE_SAMPLE:
        keep = max(n // 10, min(n, 1))
        rows = np.random.default_rng(seed).choice(n, size=keep,
                                                  replace=False)
    else:
        rows = slice(None)

    labels = data.host_column("labels")[rows]
    offsets = data.host_column("offsets")[rows]
    weights = data.host_column("weights")[rows]

    errors: list[str] = []

    def check(mask: np.ndarray, message: str) -> None:
        bad = int((~mask).sum())
        if bad:
            errors.append(f"{message} [{bad} row(s)]")

    seen_tables: set[int] = set()
    for shard_id in sorted(data.feature_shards):
        feats = data.feature_shards[shard_id]
        # Aliased shard names can share one feature table; scan it once.
        if id(feats) in seen_tables:
            continue
        seen_tables.add(id(feats))
        _, values, _ = data.host_shard_coo(shard_id)
        finite = np.isfinite(values[rows]).all(axis=1)
        tail = data.host_shard_tail(shard_id)
        if tail is not None:
            # A DualEll shard's overflow entries belong to their rows.
            bad = np.zeros(n, dtype=bool)
            bad[tail[0][~np.isfinite(tail[2])]] = True
            finite = finite & ~bad[rows]
        check(
            finite,
            "Data contains row(s) with invalid (+/- Inf or NaN) "
            f"feature(s): {shard_id}",
        )
    check(
        np.isfinite(offsets),
        "Data contains row(s) with invalid (+/- Inf or NaN) offset(s)",
    )
    check(
        np.isfinite(weights) & (weights > _EPSILON),
        "Data contains row(s) with invalid (-, 0, Inf, or NaN) weight(s)",
    )
    if check_labels:
        label_mask, message = _label_validators(task)
        check(label_mask(labels), message)

    if errors:
        raise ValueError("Data Validation failed:\n" + "\n".join(errors))
