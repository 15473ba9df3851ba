"""Multi-device execution: one process per device in a
``torch.distributed`` process group (``parallel/mesh.py``)."""

from photon_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    init_from_env,
    make_mesh,
    resolve_mesh,
    shard_batch,
    shard_random_effect_dataset,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "init_from_env",
    "make_mesh",
    "resolve_mesh",
    "shard_batch",
    "shard_random_effect_dataset",
]
