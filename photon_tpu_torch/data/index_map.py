"""Feature index maps: feature key (name and term) <-> column index
(the port's own copy of ``photon_tpu/data/index_map.py``).

Counterparts of the reference's IndexMap hierarchy (photon-api
index/IndexMap.scala:54, DefaultIndexMap.scala:27,
IdentityIndexMapLoader.scala:24) and the off-heap PalDBIndexMap
(index/PalDBIndexMap.scala:43): a dict-backed ``IndexMap`` and the
array-backed ``HashedIndexMap`` for multi-million-feature vocabularies,
both with the same deterministic index assignment (sorted keys, the
intercept last) and save/load.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from photon_tpu_torch.types import INTERCEPT_KEY

FeatureKey = str


class IndexMap:
    """Bidirectional feature key <-> index map for one feature shard."""

    def __init__(self, name_to_index: dict[FeatureKey, int]):
        self._forward = dict(name_to_index)
        self._backward = {i: n for n, i in self._forward.items()}
        if len(self._backward) != len(self._forward):
            raise ValueError("index map has duplicate indices")

    # -- reference IndexMap trait surface -----------------------------------

    def get_index(self, name: FeatureKey) -> int | None:
        return self._forward.get(name)

    def get_feature_name(self, index: int) -> FeatureKey | None:
        return self._backward.get(index)

    def __len__(self) -> int:
        return len(self._forward)

    def __contains__(self, name: FeatureKey) -> bool:
        return name in self._forward

    def items(self):
        return self._forward.items()

    @property
    def has_intercept(self) -> bool:
        return INTERCEPT_KEY in self._forward

    @property
    def intercept_index(self) -> int | None:
        return self._forward.get(INTERCEPT_KEY)

    # -- construction --------------------------------------------------------

    @staticmethod
    def from_feature_names(
        names, *, add_intercept: bool = True
    ) -> "IndexMap":
        """Build deterministically from a collection of feature keys.

        Reference: DefaultIndexMapLoader scans the data for distinct keys and
        zips them with indices; we sort for run-to-run determinism, then
        append the intercept last (the reference also treats the intercept as
        just another feature key added during ingest).
        """
        uniq = sorted(set(names) - {INTERCEPT_KEY})
        mapping = {n: i for i, n in enumerate(uniq)}
        if add_intercept:
            mapping[INTERCEPT_KEY] = len(mapping)
        return IndexMap(mapping)

    @staticmethod
    def identity(num_features: int, *, add_intercept: bool = False) -> "IndexMap":
        """Pre-indexed data (libsvm-style): name == str(index).

        Reference: IdentityIndexMapLoader.scala:24.
        """
        mapping: dict[FeatureKey, int] = {str(i): i for i in range(num_features)}
        if add_intercept:
            mapping[INTERCEPT_KEY] = num_features
        return IndexMap(mapping)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self._forward))

    @staticmethod
    def load(path: str | Path) -> "IndexMap":
        return IndexMap(json.loads(Path(path).read_text()))


class HashedIndexMap:
    """Array-backed feature map for multi-million-feature vocabularies.

    TPU-native counterpart of PalDBIndexMap (photon-client
    index/PalDBIndexMap.scala:43): where the reference sidesteps JVM heap
    limits with partitioned off-heap PalDB stores, this sidesteps Python
    dict overhead (~100+ bytes per entry plus per-string objects) with four
    numpy arrays — sorted 64-bit key hashes, their indices, and an
    offset-indexed UTF-8 name blob (~25 bytes/feature total at typical key
    lengths, a ~10x reduction). Lookup is a binary search plus an exact
    name check against the blob, so hash collisions between a probe and a
    stored key cannot mis-resolve. Persisted as one ``.npz``.

    Same surface as ``IndexMap`` (get_index / get_feature_name / len /
    contains / items / intercept) and the same deterministic index
    assignment (sorted keys, intercept last), so the two are
    interchangeable everywhere a shard map flows.
    """

    def __init__(self, hashes, indices, pos_by_index, offsets, blob):
        self._hashes = hashes  # [n] uint64, sorted
        self._indices = indices  # [n] int64 — index at hash position
        self._pos_by_index = pos_by_index  # [n] int64 — hash position by idx
        self._offsets = offsets  # [n + 1] int64 into blob, hash order
        self._blob = blob  # uint8 utf-8 concatenation, hash order

    @staticmethod
    def _hash(key: str):
        return np.uint64(int.from_bytes(
            hashlib.blake2b(key.encode(), digest_size=8).digest(), "little"
        ))

    @staticmethod
    def from_feature_names(names, *, add_intercept: bool = True):
        uniq = sorted(set(str(n) for n in names) - {INTERCEPT_KEY})
        if add_intercept:
            uniq.append(INTERCEPT_KEY)
        n = len(uniq)
        hashes = np.empty(n, dtype=np.uint64)
        for i, k in enumerate(uniq):
            hashes[i] = HashedIndexMap._hash(k)
        order = np.argsort(hashes, kind="stable")
        hashes = hashes[order]
        if n and (hashes[1:] == hashes[:-1]).any():
            raise ValueError(
                "64-bit hash collision between distinct feature keys; "
                "use the dict-backed IndexMap for this vocabulary"
            )
        indices = order.astype(np.int64)  # uniq position == index
        pos_by_index = np.empty(n, dtype=np.int64)
        pos_by_index[indices] = np.arange(n, dtype=np.int64)
        encoded = [uniq[i].encode() for i in order]
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        blob = np.frombuffer(b"".join(encoded), dtype=np.uint8)
        return HashedIndexMap(hashes, indices, pos_by_index, offsets, blob)

    def _name_at_pos(self, pos: int) -> str:
        lo, hi = int(self._offsets[pos]), int(self._offsets[pos + 1])
        return bytes(self._blob[lo:hi]).decode()

    def get_index(self, name: FeatureKey) -> int | None:
        if self._hashes.size == 0:
            return None
        key = str(name)
        h = self._hash(key)
        pos = int(np.searchsorted(self._hashes, h))
        if pos >= self._hashes.size or self._hashes[pos] != h:
            return None
        # Exact verification against the blob: a probe key that collides
        # with a stored hash must not resolve to the stored key's index.
        if self._name_at_pos(pos) != key:
            return None
        return int(self._indices[pos])

    def get_feature_name(self, index: int) -> FeatureKey | None:
        if not 0 <= index < len(self):
            return None
        return self._name_at_pos(int(self._pos_by_index[index]))

    def __len__(self) -> int:
        return int(self._hashes.size)

    def __contains__(self, name: FeatureKey) -> bool:
        return self.get_index(name) is not None

    def items(self):
        for idx in range(len(self)):
            yield self.get_feature_name(idx), idx

    @property
    def has_intercept(self) -> bool:
        return self.get_index(INTERCEPT_KEY) is not None

    @property
    def intercept_index(self) -> int | None:
        return self.get_index(INTERCEPT_KEY)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str | Path) -> None:
        # Write through a file object so the archive lands at EXACTLY the
        # given path (np.savez_compressed on a string appends ".npz",
        # silently breaking the save/load round trip for other suffixes).
        with open(path, "wb") as f:
            np.savez_compressed(
                f,
                hashes=self._hashes,
                indices=self._indices,
                pos_by_index=self._pos_by_index,
                offsets=self._offsets,
                blob=self._blob,
            )

    @staticmethod
    def load(path: str | Path) -> "HashedIndexMap":
        with np.load(str(path)) as z:
            return HashedIndexMap(
                z["hashes"], z["indices"], z["pos_by_index"],
                z["offsets"], z["blob"],
            )
