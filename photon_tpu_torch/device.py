"""Where the port runs: the GPU unless the caller asks for the CPU.

Every entry point takes a ``device`` argument and resolves it here. The
default is ``cuda``; asking for ``cuda`` on a machine without a GPU
raises. Nothing in the port drops to the CPU on its own.
"""

from __future__ import annotations

import torch

# Every entry point runs on one device; a mesh raises with this.
MESH_NOT_PORTED = "multi-device scoring: ROADMAP Queue A item 12"


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
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
