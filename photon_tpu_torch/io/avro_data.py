"""Avro training data ingest: TrainingExampleAvro -> GameDataset (the
port of ``photon_tpu/io/avro_data.py``).

Counterpart of AvroDataReader (photon-client
data/avro/AvroDataReader.scala:54): reads TrainingExampleAvro records (uid /
label / features: [FeatureAvro name,term,value] / weight / offset /
metadataMap), merges the configured feature bags into per-shard ELL feature
matrices keyed by a feature index map (name+term joined with
Constants.DELIMITER, AvroDataReader readMerged :85-145), and surfaces
metadataMap entries as id tags (the GameDatum idTagToValueMap used for
random-effect grouping and grouped evaluation, GameConverters.scala:44).

``read_training_examples`` reads the single-bag TrainingExampleAvro layout
(one shard named "features"); ``read_merged`` is the full readMerged: each
configured shard unions one or more feature-bag record fields, with
top-level id columns and/or metadataMap entries as id tags. The dataset's
tensors land on ``device`` (default ``cuda``).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from photon_tpu_torch.data.dataset import SparseFeatures
from photon_tpu_torch.data.game_data import GameDataset, make_game_dataset
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.io import avro
from photon_tpu_torch.resilience.errors import CorruptShardError
from photon_tpu_torch.types import make_feature_key, split_feature_key

# Codec-layer failure shapes a truncated or bit-rotted container
# surfaces as: varint/sync EOFs and structural ValueErrors from the
# interpreter decoder, zlib errors from a torn deflate block, struct
# errors from a cut float, KeyErrors from a half-decoded record.
_DECODE_ERRORS = (
    ValueError, EOFError, KeyError, zlib.error, struct.error,
)


def data_shard_files(path: str) -> list[str]:
    """The concrete part files a file-or-directory input resolves to
    (the HDFS part-* layout) — sorted, so iteration order is the stable
    ingest order every manifest/cursor offset is defined against."""
    if os.path.isfile(path):
        return [path]
    return [
        os.path.join(path, name)
        for name in sorted(os.listdir(path))
        if name.endswith(".avro")
    ]


def checked_iter_container_dir(path: str):
    """``avro.iter_container_dir`` with codec failures translated: every
    decode failure becomes a ``CorruptShardError`` naming the part file,
    so an operator can act on one shard instead of rereading a whole
    directory."""
    for part in data_shard_files(path):
        try:
            yield from avro.iter_container(part)
        except _DECODE_ERRORS as exc:
            raise CorruptShardError(
                f"training data shard {part}: Avro decode failed "
                f"({type(exc).__name__}: {exc}) — the shard is "
                "truncated or not a valid container"
            ) from exc


def resolve_input_columns(
    input_columns: dict[str, str] | None,
) -> dict[str, str | None]:
    """Reserved-column name resolution, the full InputColumnsNames
    surface (InputColumnsNames.scala:80-88) — shared by ``read_merged``
    and the streaming ingest so both paths speak the same remapping."""
    cols: dict[str, str | None] = {
        "uid": "uid",
        "response": None,
        "offset": "offset",
        "weight": "weight",
        "metadataMap": "metadataMap",
    }
    if input_columns:
        unknown = sorted(set(input_columns) - set(cols))
        if unknown:
            raise ValueError(
                f"unknown input_columns key(s) {unknown}; reserved columns "
                f"are {sorted(cols)} (InputColumnsNames.scala:80-88)")
        cols.update(input_columns)
    return cols


def build_index_map_from_records(
    records, *, add_intercept: bool = True
) -> IndexMap:
    """Scan records for distinct (name, term) keys — the DefaultIndexMap
    path (GameDriver.prepareFeatureMaps data-scan branch)."""
    keys = set()
    for rec in records:
        for f in rec["features"]:
            keys.add(make_feature_key(f["name"], f["term"]))
    return IndexMap.from_feature_names(keys, add_intercept=add_intercept)


def read_training_examples(
    path: str,
    *,
    index_map: IndexMap | None = None,
    id_tag_names: list[str] | None = None,
    input_columns: dict[str, str] | None = None,
    add_intercept: bool = True,
    dtype: torch.dtype = torch.float32,
    records: list[dict] | None = None,
    device=None,
) -> tuple[GameDataset, IndexMap]:
    """Read a TrainingExampleAvro file/dir into a GameDataset.

    ``id_tag_names`` picks metadataMap entries to expose as id tags; when
    None every metadata key found in the data is used. ``input_columns``
    remaps the reserved record fields (see ``read_merged``). ``records``
    supplies already-parsed Avro records for ``path`` to skip a re-parse;
    without it the file is STREAMED block by block (peak host memory is the
    output arrays plus one decode chunk, not a list of record dicts).
    """
    response = (input_columns or {}).get("response", "label")
    game, maps = read_merged(
        path,
        feature_shards={"features": ["features"]},
        index_maps=None if index_map is None else {"features": index_map},
        id_tag_names="auto" if id_tag_names is None else id_tag_names,
        response_field=response,
        input_columns=input_columns,
        add_intercept=add_intercept,
        dtype=dtype,
        records=records,
        device=device,
    )
    return game, maps["features"]


_CHUNK_ROWS = 65_536


class _EllBuilder:
    """Incremental ELL assembly: rows arrive in chunks, each chunk packs at
    its own width, chunks concatenate (padded to the global max width) at
    the end. Peak memory = the final arrays + one chunk of Python rows —
    never a whole-dataset list of per-row tuples."""

    def __init__(self, num_features: int, dtype=np.float32):
        self.chunks: list[tuple[np.ndarray, np.ndarray]] = []
        self.k = 1
        self.num_features = num_features
        self.dtype = dtype

    def add_chunk(self, rows: list) -> None:
        if not rows:
            return
        k_c = max(max((len(r) for r in rows), default=0), 1)
        self.k = max(self.k, k_c)
        idx = np.zeros((len(rows), k_c), dtype=np.int32)
        val = np.zeros((len(rows), k_c), dtype=self.dtype)
        for i, row in enumerate(rows):
            for j, (fi, fv) in enumerate(row):
                idx[i, j] = fi
                val[i, j] = fv
        # Range check (rows_to_ell's guard): a non-contiguous index map
        # must raise here, not silently clamp inside the device gather.
        if idx.size and (int(idx.max()) >= self.num_features
                         or int(idx.min()) < 0):
            raise ValueError(
                f"feature index out of range [0, {self.num_features}): "
                f"min {int(idx.min())}, max {int(idx.max())}"
            )
        self.chunks.append((idx, val))

    def finish(self) -> tuple[np.ndarray, np.ndarray]:
        if not self.chunks:
            return (np.zeros((0, 1), np.int32), np.zeros((0, 1), self.dtype))
        k = self.k
        idx = np.concatenate([
            np.pad(i, ((0, 0), (0, k - i.shape[1]))) for i, _ in self.chunks
        ])
        val = np.concatenate([
            np.pad(v, ((0, 0), (0, k - v.shape[1]))) for _, v in self.chunks
        ])
        self.chunks.clear()
        return idx, val


def read_merged(
    path: str,
    *,
    feature_shards: dict[str, list[str]],
    index_maps: dict[str, IndexMap] | None = None,
    id_columns: list[str] | None = None,
    id_tag_names=None,  # list[str] | None | "auto"
    response_field: str | None = None,
    input_columns: dict[str, str] | None = None,
    add_intercept: bool | dict[str, bool] = True,
    dtype: torch.dtype = torch.float32,
    records: list[dict] | None = None,
    device=None,
) -> tuple[GameDataset, dict[str, IndexMap]]:
    """Read a multi-bag Avro layout into a multi-shard GameDataset.

    The full AvroDataReader.readMerged semantics (AvroDataReader.scala
    :85-145): each feature SHARD is the union of one or more feature-bag
    record fields (FeatureShardConfiguration.featureBags) — e.g. the Yahoo!
    Music layout's ``userFeatures``/``songFeatures``/``features`` bags —
    packed into its own ELL matrix against its own index map. ``id_columns``
    exposes top-level record fields (userId, songId, ...) as id tags;
    ``id_tag_names`` additionally picks metadataMap entries (``"auto"`` =
    every key found in the data). The response comes from ``response_field``
    (auto: "response" then "label"). ``add_intercept`` may be per-shard
    (FeatureShardConfiguration's hasIntercept flag) or one bool for all.

    STREAMING: without a pre-parsed ``records`` list the file is decoded
    block by block, twice when a scan pass is needed (vocabulary build /
    metadata-key discovery / response-field probe) — peak host memory is
    the output arrays plus one decode block, the O(batch) requirement of
    the ingest pipeline (the reference amortizes the same passes across a
    cluster, AvroDataReader.scala:85).

    ``input_columns`` remaps ALL reserved record fields, the full
    InputColumnsNames surface (InputColumnsNames.scala:80-88): keys
    "uid" / "response" / "offset" / "weight" / "metadataMap", each mapped
    to the actual field name in the data. ``response_field`` (legacy
    single-field form) takes precedence over ``input_columns["response"]``.
    """
    cols = resolve_input_columns(input_columns)
    if response_field is None:
        response_field = cols["response"]
    uid_col = cols["uid"]
    offset_col = cols["offset"]
    weight_col = cols["weight"]
    meta_col = cols["metadataMap"]

    def shard_intercept(shard: str) -> bool:
        if isinstance(add_intercept, dict):
            return add_intercept.get(shard, True)
        return add_intercept

    if records is not None and not isinstance(records, (list, tuple)):
        # The scan + build passes each iterate; a one-shot iterable would
        # be exhausted by the first.
        records = list(records)

    def stream():
        if records is not None:
            return iter(records)
        return checked_iter_container_dir(path)

    missing_maps = [
        s for s in feature_shards
        if index_maps is None or s not in index_maps
    ]
    need_scan = (
        bool(missing_maps) or id_tag_names == "auto"
        or response_field is None
    )
    # With prebuilt maps and explicit tags, the only scan need is the
    # response-field probe — one record, not a full decode pass.
    probe_only = not missing_maps and id_tag_names != "auto"
    out_maps: dict[str, IndexMap] = dict(
        (s, index_maps[s]) for s in feature_shards
        if index_maps is not None and s in index_maps
    )
    if need_scan:
        keysets: dict[str, set] = {s: set() for s in missing_maps}
        meta_keys: set[str] = set()
        first = None
        for rec in stream():
            if first is None:
                first = rec
                if probe_only:
                    break
            for shard in missing_maps:
                ks = keysets[shard]
                for bag in feature_shards[shard]:
                    for f in rec.get(bag) or ():
                        ks.add(make_feature_key(f["name"], f["term"]))
            if id_tag_names == "auto":
                meta_keys.update((rec.get(meta_col) or {}).keys())
        if first is None:
            raise ValueError(f"no records in {path}")
        if response_field is None:
            for candidate in ("response", "label"):
                if candidate in first:
                    response_field = candidate
                    break
            else:
                raise ValueError(
                    "records carry neither 'response' nor 'label'; pass "
                    "response_field explicitly")
        if id_tag_names == "auto":
            id_tag_names = sorted(meta_keys)
        for shard in missing_maps:
            out_maps[shard] = IndexMap.from_feature_names(
                keysets.pop(shard), add_intercept=shard_intercept(shard))

    id_columns = list(id_columns or ())
    overlap = set(id_columns) & set(id_tag_names or ())
    if overlap:
        raise ValueError(
            f"id name(s) {sorted(overlap)} listed in both id_columns and "
            "id_tag_names; each id tag must come from exactly one source")

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    labels_chunks: list[np.ndarray] = []
    offsets_chunks: list[np.ndarray] = []
    weights_chunks: list[np.ndarray] = []
    uids_chunks: list[np.ndarray] = []
    builders = {
        s: _EllBuilder(len(out_maps[s]), np_dtype) for s in feature_shards
    }
    tag_names = list(id_columns)
    for t in id_tag_names or ():
        if t not in tag_names:
            tag_names.append(t)
    # Tag values flush to numpy string-array chunks like every other
    # column — a per-row Python list would break the O(batch) contract.
    tag_chunks: dict[str, list] = {t: [] for t in tag_names}

    # Chunk-local accumulators, flushed to arrays every _CHUNK_ROWS rows.
    c_labels: list = []
    c_offsets: list = []
    c_weights: list = []
    c_uids: list = []
    c_rows: dict[str, list] = {s: [] for s in feature_shards}
    c_tags: dict[str, list] = {t: [] for t in tag_names}

    def flush():
        if not c_labels:
            return
        labels_chunks.append(np.asarray(c_labels, dtype=np.float64))
        offsets_chunks.append(np.asarray(c_offsets, dtype=np.float64))
        weights_chunks.append(np.asarray(c_weights, dtype=np.float64))
        uids_chunks.append(np.asarray(c_uids, dtype=np.int64))
        for s in feature_shards:
            builders[s].add_chunk(c_rows[s])
            c_rows[s].clear()
        for t in tag_names:
            tag_chunks[t].append(np.asarray(c_tags[t]))
            c_tags[t].clear()
        c_labels.clear()
        c_offsets.clear()
        c_weights.clear()
        c_uids.clear()

    i = -1
    for i, rec in enumerate(stream()):
        c_labels.append(rec[response_field])
        c_offsets.append(
            rec[offset_col] if rec.get(offset_col) is not None else 0.0)
        c_weights.append(
            rec[weight_col] if rec.get(weight_col) is not None else 1.0)
        c_uids.append(_uid_to_int(rec.get(uid_col), i))
        for shard, bags in feature_shards.items():
            imap = out_maps[shard]
            row = []
            for bag in bags:
                for f in rec.get(bag) or ():
                    idx = imap.get_index(
                        make_feature_key(f["name"], f["term"]))
                    if idx is not None and f["value"] != 0.0:
                        row.append((idx, float(f["value"])))
            if imap.intercept_index is not None:
                row.append((imap.intercept_index, 1.0))
            c_rows[shard].append(row)
        for col in id_columns:
            if col not in rec or rec[col] is None:
                raise ValueError(f"record {i} is missing id column {col!r}")
            c_tags[col].append(rec[col])
        meta = rec.get(meta_col) or {}
        for t in id_tag_names or ():
            if t not in meta:
                raise ValueError(
                    f"record {i} is missing id tag {t!r} in metadataMap")
            c_tags[t].append(meta[t])
        if len(c_labels) >= _CHUNK_ROWS:
            flush()
    flush()
    if i < 0:
        raise ValueError(f"no records in {path}")

    shards = {}
    for shard in feature_shards:
        indices, values = builders[shard].finish()
        # Numpy-backed: make_game_dataset keeps the host mirror (the
        # dataset-build planner reads it) and copies to the device once.
        shards[shard] = SparseFeatures(
            indices, values, len(out_maps[shard]))
    game = make_game_dataset(
        np.concatenate(labels_chunks),
        shards,
        offsets=np.concatenate(offsets_chunks),
        weights=np.concatenate(weights_chunks),
        id_tags={
            t: np.concatenate(chunks)
            for t, chunks in tag_chunks.items() if chunks
        },
        uids=np.concatenate(uids_chunks),
        dtype=dtype,
        device=device,
    )
    return game, out_maps


def _uid_to_int(uid, position: int) -> int:
    """Stable int64 sample id from an Avro uid string.

    The deterministic reservoir sampling keys on these
    (build_random_effect_dataset byteswap64 hashing), so they must track the
    record's real identity — numeric uids pass through, other strings get a
    stable CRC-based hash, absent uids fall back to file position (the
    reference's GameConverters hashes the row when no uid column exists).
    """
    if uid is None:
        return position
    s = str(uid)
    try:
        return int(s)
    except ValueError:
        import zlib

        return (zlib.crc32(s.encode()) << 31) | (
            zlib.crc32(s[::-1].encode())
        )


TRAINING_EXAMPLE_SCHEMA = {
    "name": "TrainingExampleAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {
            "items": {
                "name": "FeatureAvro",
                "namespace": "com.linkedin.photon.avro.generated",
                "type": "record",
                "fields": [
                    {"name": "name", "type": "string"},
                    {"name": "term", "type": "string"},
                    {"name": "value", "type": "double"},
                ],
            },
            "type": "array",
        }},
        {"name": "metadataMap", "default": None,
         "type": ["null", {"type": "map", "values": "string"}]},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
    ],
}


RESPONSE_PREDICTION_SCHEMA = {
    "name": "SimplifiedResponsePrediction",
    "namespace": "com.linkedin.photon.avro.generated",
    "type": "record",
    "doc": (
        "Response prediction format truncated with the only field photon "
        "is expecting"
    ),
    "fields": [
        {"name": "response", "type": "double"},
        {"name": "features", "type": {
            "items": {
                "name": "FeatureAvro",
                "namespace": "com.linkedin.photon.avro.generated",
                "type": "record",
                "fields": [
                    {"name": "name", "type": "string"},
                    {"name": "term", "type": "string"},
                    {"name": "value", "type": "double"},
                ],
            },
            "type": "array",
        }},
        {"name": "weight", "type": "double", "default": 1.0},
        {"name": "offset", "type": "double", "default": 0.0},
    ],
}


def write_response_predictions(
    path: str,
    responses,
    feature_rows,  # list of [(feature_key, value)] in name+term key form
    *,
    weights=None,
    offsets=None,
) -> None:
    """SimplifiedResponsePrediction writer
    (photon-avro-schemas ResponsePredictionAvro.avsc) — the reference's
    response-prediction data layout; readable back via ``read_merged`` with
    ``response_field="response"`` (AvroDataReader handles both layouts
    uniformly)."""
    responses = np.asarray(responses)

    def rec(i):
        feats = []
        for key, val in feature_rows[i]:
            name, term = split_feature_key(key)
            feats.append({"name": name, "term": term, "value": float(val)})
        return {
            "response": float(responses[i]),
            "features": feats,
            "weight": 1.0 if weights is None else float(weights[i]),
            "offset": 0.0 if offsets is None else float(offsets[i]),
        }

    avro.write_container(
        path,
        RESPONSE_PREDICTION_SCHEMA,
        (rec(i) for i in range(responses.shape[0])),
    )


def training_example_schema(bags=()) -> dict:
    """``TRAINING_EXAMPLE_SCHEMA`` with one more FeatureAvro array field
    per name in ``bags`` after ``features`` (the multi-bag layout that
    ``read_merged`` reads, e.g. ``userFeatures`` and ``movieFeatures``)."""
    if not bags:
        return TRAINING_EXAMPLE_SCHEMA
    fields = list(TRAINING_EXAMPLE_SCHEMA["fields"])
    at = 1 + next(i for i, f in enumerate(fields) if f["name"] == "features")
    extra = [{"name": b, "default": [], "type": {
        "items": "com.linkedin.photon.avro.generated.FeatureAvro",
        "type": "array"}} for b in bags]
    return {**TRAINING_EXAMPLE_SCHEMA,
            "fields": fields[:at] + extra + fields[at:]}


def write_training_examples(
    path: str,
    labels,
    feature_rows,  # list of [(feature_key, value)] in name+term key form
    *,
    offsets=None,
    weights=None,
    metadata=None,  # list[dict[str, str]]
    uids=None,
    bags: dict | None = None,  # bag name -> rows like feature_rows
) -> None:
    """TrainingExampleAvro writer (AvroDataWriter.scala:159), for tests
    and data-prep tooling. ``bags`` adds feature bags beside
    ``features`` (``training_example_schema``); without it the file is
    byte for byte the JAX package's but for the sync marker."""
    labels = np.asarray(labels)
    bags = dict(bags or {})

    def ntv(rows):
        feats = []
        for key, val in rows:
            name, term = split_feature_key(key)
            feats.append({"name": name, "term": term, "value": float(val)})
        return feats

    def rec(i):
        out = {
            "uid": None if uids is None else str(uids[i]),
            "label": float(labels[i]),
            "features": ntv(feature_rows[i]),
            "metadataMap": None if metadata is None else metadata[i],
            "weight": None if weights is None else float(weights[i]),
            "offset": None if offsets is None else float(offsets[i]),
        }
        for name, rows in bags.items():
            out[name] = ntv(rows[i])
        return out

    avro.write_container(
        path,
        training_example_schema(tuple(bags)),
        (rec(i) for i in range(labels.shape[0])),
    )
