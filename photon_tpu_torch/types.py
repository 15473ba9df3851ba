"""Domain enums and feature keys (the port's own copy of
``photon_tpu/types.py``; photon-lib Types.scala:21-44)."""

from __future__ import annotations

import enum

DELIMITER = "\x01"
INTERCEPT_NAME = "(INTERCEPT)"
INTERCEPT_TERM = ""
# The delimiter-joined (name, term) pair of the intercept, "(INTERCEPT)\x01"
# (photon-client Constants.scala:40-42).
INTERCEPT_KEY = f"{INTERCEPT_NAME}{DELIMITER}{INTERCEPT_TERM}"


class TaskType(enum.Enum):
    """Training task, determining loss function and link function."""

    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"


def make_feature_key(name: str, term: str = "") -> str:
    """Join an Avro (name, term) pair into a flat feature key."""
    return f"{name}{DELIMITER}{term}"


def split_feature_key(key: str) -> tuple[str, str]:
    """Inverse of ``make_feature_key``; keys without a delimiter have an
    empty term."""
    parts = key.split(DELIMITER)
    return (parts[0], parts[1]) if len(parts) == 2 else (parts[0], "")
