"""GameDataset: the canonical columnar table every coordinate trains
against (port of ``photon_tpu/data/game_data.py``).

Labels, offsets and weights, one feature matrix per shard and integer
coded id tags, all in one canonical row order on one device. The host
keeps numpy mirrors of what it was built from, so the random-effect
planner (numpy) never copies the device data back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch import device as device_mod
from photon_tpu_torch.data.dataset import (
    DenseFeatures,
    DualEllFeatures,
    Features,
    GLMBatch,
    SparseFeatures,
)
from photon_tpu_torch.data.pipeline import PIPELINE_STATS

# A raw array at least this large is copied from pinned memory.
_PINNED_COPY_MIN_BYTES = 1 << 20


@dataclasses.dataclass(frozen=True)
class IdTag:
    """One grouping column: dense int codes plus the key vocabulary.
    Keys are normalized to str, as the checkpoint stores them."""

    codes: torch.Tensor  # [n] int32, on the dataset's device
    vocab: dict  # str key -> code
    inverse: tuple  # code -> str key
    codes_np: np.ndarray  # host mirror of ``codes``

    @property
    def num_groups(self) -> int:
        return len(self.inverse)

    def host_codes(self) -> np.ndarray:
        return self.codes_np

    @staticmethod
    def from_raw(raw_ids, device: torch.device) -> "IdTag":
        uniq, codes = np.unique(np.asarray(raw_ids), return_inverse=True)
        keys = tuple(
            str(k.item() if hasattr(k, "item") else k) for k in uniq
        )
        if len(set(keys)) != len(keys):
            raise ValueError("id tag keys collide after str normalization")
        codes = codes.astype(np.int32)
        return IdTag(
            codes=torch.from_numpy(codes).to(device),
            vocab={k: i for i, k in enumerate(keys)},
            inverse=keys,
            codes_np=codes,
        )


@dataclasses.dataclass(frozen=True)
class GameDataset:
    """Columnar GAME table in canonical row order on ``device``."""

    labels: torch.Tensor  # [n]
    offsets: torch.Tensor  # [n]
    weights: torch.Tensor  # [n]
    feature_shards: dict  # shard id -> Features
    id_tags: dict  # tag name -> IdTag
    host: dict  # numpy mirrors: "labels"/"offsets"/"weights", ("shard", id)
    uids: np.ndarray | None = None

    @property
    def num_samples(self) -> int:
        return int(self.labels.shape[0])

    @property
    def device(self) -> torch.device:
        return self.labels.device

    @property
    def dtype(self) -> torch.dtype:
        return self.labels.dtype

    def host_column(self, name: str) -> np.ndarray:
        return self.host[name]

    def host_shard_coo(self, shard_id: str):
        """Host ``(indices [n, k], values [n, k], d)`` ELL view of a
        feature shard (a dense shard broadcasts ``arange(d)``). For a
        ``DualEllFeatures`` shard it is the bounded-width slab only: the
        overflow is ``host_shard_tail``'s."""
        return self.host[("shard", shard_id)]

    def host_shard_tail(self, shard_id: str):
        """Host ``(rows, indices, values)`` COO overflow of a
        ``DualEllFeatures`` shard (rows ascending), or None for a
        rectangular shard or an empty tail."""
        if shard_id not in self.feature_shards:
            raise KeyError(shard_id)
        return self.host.get(("tail", shard_id))

    def shard_batch(self, shard_id: str) -> GLMBatch:
        return GLMBatch(self.feature_shards[shard_id], self.labels,
                        self.offsets, self.weights)

    def tag_codes(self, tag: str) -> tuple[torch.Tensor, int]:
        """(the [n] int32 group codes of id tag ``tag``, its number of
        groups)."""
        t = self.id_tags[tag]
        return t.codes, t.num_groups


def _host_array(a, dtype) -> np.ndarray:
    """A numpy copy (or view) of a host array or a tensor on any
    device."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def _device_shard(spec: tuple, put) -> Features:
    """The device features of one shard's host spec: ``(x,)``,
    ``(idx, val, d)`` or ``(idx, val, d, tail)``."""
    if len(spec) == 1:
        return DenseFeatures(put(spec[0]))
    if len(spec) == 3:
        return SparseFeatures(put(spec[0]), put(spec[1]), spec[2])
    idx, val, d, (tr, ti, tv) = spec
    return DualEllFeatures(put(idx), put(val), put(tr), put(ti), put(tv), d)


def make_game_dataset(
    labels,
    feature_shards: dict,
    *,
    offsets=None,
    weights=None,
    id_tags: dict | None = None,
    uids=None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> GameDataset:
    """Build a GameDataset from numpy arrays. ``feature_shards`` maps a
    shard id to ``DenseFeatures(x)`` or ``SparseFeatures(idx, val, d)``
    holding numpy arrays, or to a ``DualEllFeatures`` (its tensors on
    any device); everything is copied to ``device`` (default
    ``cuda``) once, in the ``raw_transfer`` stage of ``PIPELINE_STATS``,
    and the numpy inputs stay as the host mirror."""
    dev = device_mod.resolve(device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    labels_np = np.asarray(labels, dtype=np_dtype)
    n = labels_np.shape[0]
    offsets_np = (np.zeros(n, np_dtype) if offsets is None
                  else np.asarray(offsets, dtype=np_dtype))
    weights_np = (np.ones(n, np_dtype) if weights is None
                  else np.asarray(weights, dtype=np_dtype))
    host: dict = {
        "labels": labels_np, "offsets": offsets_np, "weights": weights_np,
    }

    specs: dict[str, tuple] = {}
    for name, feats in feature_shards.items():
        if isinstance(feats, DenseFeatures):
            x = np.asarray(feats.x, dtype=np_dtype)
            if x.shape[0] != n:
                raise ValueError(f"feature shard {name!r} has {x.shape[0]} "
                                 f"rows, expected {n}")
            d = x.shape[1]
            host[("shard", name)] = (
                np.broadcast_to(np.arange(d, dtype=np.int32), x.shape), x, d)
            specs[name] = (x,)
        elif isinstance(feats, SparseFeatures):
            idx = np.asarray(feats.indices, dtype=np.int32)
            val = np.asarray(feats.values, dtype=np_dtype)
            if idx.shape[0] != n:
                raise ValueError(f"feature shard {name!r} has "
                                 f"{idx.shape[0]} rows, expected {n}")
            host[("shard", name)] = (idx, val, feats.d)
            specs[name] = (idx, val, feats.d)
        elif isinstance(feats, DualEllFeatures):
            idx = _host_array(feats.indices, np.int32)
            val = _host_array(feats.values, np_dtype)
            if idx.shape[0] != n:
                raise ValueError(f"feature shard {name!r} has "
                                 f"{idx.shape[0]} rows, expected {n}")
            tail = (_host_array(feats.tail_rows, np.int32),
                    _host_array(feats.tail_indices, np.int32),
                    _host_array(feats.tail_values, np_dtype))
            host[("shard", name)] = (idx, val, feats.d)
            if tail[0].size:
                host[("tail", name)] = tail
            specs[name] = (idx, val, feats.d, tail)
        else:
            raise TypeError(f"feature shard {name!r}: expected Dense, "
                            f"Sparse or DualEll features, got "
                            f"{type(feats).__name__}")

    pinned: list = []

    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda" and t.nbytes >= _PINNED_COPY_MIN_BYTES:
            # From pinned memory the copy runs at the link's rate without
            # blocking; the pinned copy lives until the sync below.
            t = t.pin_memory()
            pinned.append(t)
            return t.to(dev, non_blocking=True)
        return t.to(dev)

    # Every device copy of the raw data, timed as one stage.
    with PIPELINE_STATS.stage("raw_transfer"):
        shards: dict[str, Features] = {
            name: _device_shard(spec, put) for name, spec in specs.items()}
        columns = [put(a) for a in (labels_np, offsets_np, weights_np)]
        if pinned:
            torch.cuda.current_stream(dev).synchronize()
    return GameDataset(
        labels=columns[0],
        offsets=columns[1],
        weights=columns[2],
        feature_shards=shards,
        id_tags={k: IdTag.from_raw(v, dev)
                 for k, v in (id_tags or {}).items()},
        host=host,
        uids=None if uids is None else np.asarray(uids),
    )
