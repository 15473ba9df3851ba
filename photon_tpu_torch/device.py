"""Where the port runs: the GPU unless the caller asks for the CPU.

Every entry point takes a ``device`` argument and resolves it here. The
default is ``cuda``; asking for ``cuda`` on a machine without a GPU
raises. Nothing in the port drops to the CPU on its own. Under a
launcher (``LOCAL_RANK`` set, one process per device:
``parallel/mesh.py``) a bare ``cuda`` is this rank's card,
``cuda:{LOCAL_RANK mod device_count}``; ranks past the card count share
cards.
"""

from __future__ import annotations

import os

import torch

# The column-sharded fixed effect, which raises until it is ported.
COLUMN_SHARDING_NOT_PORTED = (
    "the column-sharded fixed effect (feature_sharding 'column', or "
    "'auto' above AUTO_COLUMN_SHARDING_THRESHOLD features on a mesh: "
    "FeatureShardedSparse, shard_features_by_column), the second part of "
    "item 12")


def resolve(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "photon_tpu_torch runs on the GPU by default and found no "
                "CUDA device; pass device='cpu' to run the plain PyTorch "
                "path on the CPU"
            )
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK", "")
            dev = torch.device(
                "cuda", int(local) % torch.cuda.device_count()
                if local.isdigit() else torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
