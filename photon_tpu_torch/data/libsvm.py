"""libsvm text ingest into a GLMBatch (port of
``photon_tpu/data/libsvm.py``).

Counterpart of the reference's libsvm input path (photon-client
io/deprecated, the legacy driver's a9a fixture): the quickest route to
the standard GLM benchmark datasets.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from photon_tpu_torch.data.dataset import GLMBatch, make_sparse_batch


def read_libsvm(
    path: str | Path,
    *,
    num_features: int | None = None,
    add_intercept: bool = True,
    binary_labels_to01: bool = True,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> GLMBatch:
    """Read a libsvm file into an ELL batch on ``device`` (default
    ``cuda``). libsvm indices are 1-based and land at column idx - 1;
    with ``add_intercept`` an all-ones column is appended at index
    d - 1. Labels -1/+1 become 0/1 when ``binary_labels_to01``."""
    labels: list[float] = []
    rows: list[list[tuple[int, float]]] = []
    max_idx = -1
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        labels.append(float(parts[0]))
        row = []
        for tok in parts[1:]:
            if tok.startswith("#"):
                break
            k, v = tok.split(":")
            idx = int(k) - 1
            if idx < 0:
                raise ValueError(f"libsvm index must be >= 1, got {k}")
            max_idx = max(max_idx, idx)
            row.append((idx, float(v)))
        rows.append(row)

    base = num_features if num_features is not None else max_idx + 1
    if base <= max_idx:
        raise ValueError(f"num_features={base} but saw index {max_idx}")
    d = base + (1 if add_intercept else 0)
    if add_intercept:
        for row in rows:
            row.append((d - 1, 1.0))

    y = np.asarray(labels, dtype=np.float64)
    if binary_labels_to01 and y.min() < 0:
        y = (y > 0).astype(np.float64)
    return make_sparse_batch(rows, d, y, dtype=dtype, device=device)
