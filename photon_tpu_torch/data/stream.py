"""Fault-tolerant out-of-core streaming ingest (port of
``photon_tpu/data/stream.py``).

The in-memory readers hold the whole dataset's record stream before
planning; production datasets do not fit one host. ``StreamingIngest``
iterates a directory of Avro shards in bounded-memory WINDOWS: the
record dicts of at most two windows exist at any moment, decode of
window k+1 runs on the ingest chunk pool while window k's device copy
drains on a side stream, and the final ``GameDataset`` assembles from
per-window arrays on the device: peak host memory is the output columns
plus O(window), never a whole-dataset record list.

The robustness layers:

- **Integrity manifest** (``ingest-manifest.json``, committed through
  ``io/model_io.atomic_write_bytes``): per-shard size, sha256 and record
  count. A truncated or bit-rotted shard raises ``CorruptShardError``
  NAMING THE FILE, at read (size or checksum mismatch) or at decode
  (codec failure, record-count mismatch).
- **Bounded-loss quarantine** (``max_bad_shards`` / ``max_bad_fraction``,
  default 0 = abort): above zero a corrupt shard is skipped, counted and
  surfaced: ``ingested_fraction`` and the quarantined paths ride the
  stats dict (and the training summary), and the registry's
  ``stream_ingested_fraction``, ``stream_quarantined_shards`` and
  ``stream_rows_ingested`` gauges.
- **Transient-I/O retry**: shard read and decode run inside
  ``resilience.retry`` behind the ``io.shard_read`` / ``io.shard_decode``
  fault points; ``errors.is_transient`` classifies EIO-style OSErrors. A
  checksum mismatch after a clean read is corruption, never retried.
- **Resumable cursor** (``ingest-cursor.json``): each window's arrays
  spill to an atomic npz and the cursor (manifest hash, config key, next
  shard, quarantine set) commits at the shard boundary. A killed ingest
  resumes where it stopped, reloading committed windows from their
  spills: the resumed dataset, and so every packed plan buffer built
  from it, is byte-identical to the uninterrupted run's.
- **Health sketch** (``ingest-sketch.json``): with ``obs.health``
  armed, every window folds, in window order, into one ``DataSketch``
  saved beside the cursor at each commit (a resumed run re-folds the
  committed windows from their spills, so the file is byte-identical to
  the uninterrupted run's) and registered with
  ``obs.health.set_train_sketch`` at the end.

On the card a window's arrays are copied from pinned host tensors with
``non_blocking`` copies on a side stream, an event recorded behind them;
``_assemble`` waits on each window's event before ``torch.cat``. Formats,
knobs and semantics: ``DATA.md`` (the format document of both
packages).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import logging
import os
import threading
import time

import numpy as np
import torch

from photon_tpu_torch import device as device_mod
from photon_tpu_torch.data.dataset import SparseFeatures
from photon_tpu_torch.data.game_data import GameDataset, IdTag
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.io import avro
from photon_tpu_torch.io.avro_data import (
    _DECODE_ERRORS,
    _uid_to_int,
    data_shard_files,
    resolve_input_columns,
)
from photon_tpu_torch.resilience.errors import (
    CorruptShardError,
    ResumeMismatchError,
)
from photon_tpu_torch.types import make_feature_key

logger = logging.getLogger(__name__)

MANIFEST_FILE = "ingest-manifest.json"
CURSOR_FILE = "ingest-cursor.json"
VOCAB_FILE = "ingest-vocab.json"
SKETCH_FILE = "ingest-sketch.json"
SCHEMA_VERSION = 1


# --------------------------------------------------------------------------
# integrity manifest
# --------------------------------------------------------------------------


def _hash_file(path: str) -> tuple[str, int]:
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
            size += len(block)
    return h.hexdigest(), size


def _count_records(path: str) -> int | None:
    """Record count from the container's block headers (no record
    decode). None when the file cannot even be block-scanned — such a
    shard is already corrupt and will quarantine at decode time."""
    try:
        return sum(
            count for _, count, _ in avro.iter_container_block_bytes(path)
        )
    except (OSError, *_DECODE_ERRORS):
        return None


def build_shard_manifest(
    stream_dir: str, shard_names: list[str] | None = None
) -> dict:
    """Scan ``stream_dir``'s Avro shards into the integrity manifest.

    Per shard: file name (relative), byte size, sha256, record count
    (from block headers — cheap), and the cumulative record offset
    (the stable global row position ``_uid_to_int`` falls back to for
    uid-less records, independent of quarantine decisions so resume
    and quarantine never shift downstream sampling keys).

    ``shard_names`` (base names) restricts the manifest to an explicit
    snapshot, so shards landing mid-run wait for the next run instead of
    changing the manifest under a committed cursor.
    """
    wanted = None if shard_names is None else set(shard_names)
    shards = []
    offset = 0
    for path in data_shard_files(stream_dir):
        if wanted is not None and os.path.basename(path) not in wanted:
            continue
        digest, size = _hash_file(path)
        records = _count_records(path)
        shards.append({
            "name": os.path.basename(path),
            "size": size,
            "sha256": digest,
            "records": records,
            "row_offset": offset,
        })
        offset += records or 0
    if not shards:
        raise ValueError(f"no .avro shards under {stream_dir}")
    return {"schema_version": SCHEMA_VERSION, "shards": shards}


def _manifest_bytes(manifest: dict) -> bytes:
    return json.dumps(manifest, indent=2, sort_keys=True).encode("utf-8")


def _atomic_json(path: str, payload: dict) -> None:
    from photon_tpu_torch.io.model_io import atomic_write_bytes

    atomic_write_bytes(path, _manifest_bytes(payload))


# --------------------------------------------------------------------------
# quarantine policy + stats
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuarantinePolicy:
    """Bounded-loss corrupt-shard policy.

    The budget is ``max(max_bad_shards, floor(max_bad_fraction *
    total_shards))``; the default (both 0) aborts on the FIRST corrupt
    shard — losing data silently is worse than failing loudly, so
    degraded-continue is an explicit opt-in with a bound.
    """

    max_bad_shards: int = 0
    max_bad_fraction: float = 0.0

    def __post_init__(self):
        if self.max_bad_shards < 0:
            raise ValueError("max_bad_shards must be >= 0")
        if not (0.0 <= self.max_bad_fraction <= 1.0):
            raise ValueError("max_bad_fraction must be in [0, 1]")

    def budget(self, total_shards: int) -> int:
        return max(
            int(self.max_bad_shards),
            int(self.max_bad_fraction * total_shards),
        )


class StreamStats:
    """Thread-safe ingest accounting (decode worker + training thread)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seconds: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._quarantined: dict[str, str] = {}  # path -> reason

    def add_seconds(self, name: str, seconds: float) -> None:
        with self._lock:
            self._seconds[name] = self._seconds.get(name, 0.0) + seconds

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def quarantine(self, path: str, reason: str) -> None:
        with self._lock:
            self._quarantined[path] = reason

    def quarantined(self) -> dict[str, str]:
        with self._lock:
            return dict(self._quarantined)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "seconds": dict(self._seconds),
                "counts": dict(self._counts),
                "quarantined": dict(self._quarantined),
            }


# --------------------------------------------------------------------------
# decoded window
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Window:
    """One decoded window's arrays (host numpy, window-local widths)."""

    index: int
    rows: int
    labels: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray
    uids: np.ndarray
    tags: dict[str, np.ndarray]
    shards: dict[str, tuple[np.ndarray, np.ndarray]]  # (idx, val)
    quarantined: list[tuple[str, CorruptShardError]]
    # The window's device tensors, set by _transfer_window on the
    # training thread; None until then (or for an all-quarantined empty
    # window). On the card their copy runs on a side stream behind
    # ``event``, from the pinned host tensors in ``staging``, which stay
    # referenced until that event has completed.
    devs: object = None
    event: object = None
    staging: object = None


def _pack_rows(
    rows: list, num_features: int, dtype
) -> tuple[np.ndarray, np.ndarray]:
    """ELL-pack one window's rows at the WINDOW width (the final pad to
    the global width happens at assembly, exactly like the in-memory
    ``_EllBuilder``), with the same out-of-range guard."""
    k = max(max((len(r) for r in rows), default=0), 1)
    idx = np.zeros((len(rows), k), dtype=np.int32)
    val = np.zeros((len(rows), k), dtype=dtype)
    for i, row in enumerate(rows):
        for j, (fi, fv) in enumerate(row):
            idx[i, j] = fi
            val[i, j] = fv
    if idx.size and (
        int(idx.max()) >= num_features or int(idx.min()) < 0
    ):
        raise ValueError(
            f"feature index out of range [0, {num_features}): "
            f"min {int(idx.min())}, max {int(idx.max())}")
    return idx, val


# --------------------------------------------------------------------------
# the streaming ingest
# --------------------------------------------------------------------------


class StreamingIngest:
    """Stream a directory of TrainingExampleAvro shards into a
    ``GameDataset`` with bounded memory, integrity checking, bounded-
    loss quarantine, transient-I/O retry, and a resumable cursor.

    ``work_dir`` holds the run's durable state: the integrity manifest,
    the vocabulary artifact (when maps are data-derived), per-window
    spill files, and the cursor. ``resume=True`` continues a killed
    ingest from its committed cursor (manifest hash + ingest config
    must match — ``ResumeMismatchError`` otherwise) and reloads
    completed windows from their spills, so the resumed dataset is
    byte-identical to the uninterrupted one. The dataset's tensors land
    on ``device`` (default ``cuda``), in ``dtype``.
    """

    def __init__(
        self,
        stream_dir: str,
        *,
        work_dir: str,
        feature_shards: dict[str, list[str]] | None = None,
        index_maps: dict[str, IndexMap] | None = None,
        id_tag_names=None,  # list[str] | None ("auto") | "auto"
        id_columns: list[str] | None = None,
        response_field: str | None = None,
        input_columns: dict[str, str] | None = None,
        add_intercept: bool | dict[str, bool] = True,
        dtype: torch.dtype = torch.float32,
        device=None,
        window_shards: int = 1,
        quarantine: QuarantinePolicy | None = None,
        resume: bool = False,
        shard_names: list[str] | None = None,
    ):
        if window_shards < 1:
            raise ValueError("window_shards must be >= 1")
        self.stream_dir = stream_dir
        self.work_dir = work_dir
        # Explicit shard snapshot (base names): the manifest — and
        # therefore the cursor and every downstream row offset — covers
        # exactly these files, whatever lands in stream_dir later. A
        # resumed run keeps the COMMITTED manifest's snapshot.
        self.shard_names = (
            None if shard_names is None else [str(s) for s in shard_names]
        )
        self.feature_shards = dict(
            feature_shards or {"features": ["features"]}
        )
        self.index_maps = dict(index_maps) if index_maps else None
        self.id_tag_names = (
            "auto" if id_tag_names is None else id_tag_names
        )
        self.id_columns = list(id_columns or ())
        self.response_field = response_field
        self.cols = resolve_input_columns(input_columns)
        if self.response_field is None:
            self.response_field = self.cols["response"]
        self.add_intercept = add_intercept
        self.np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.device = device_mod.resolve(device)
        self.window_shards = int(window_shards)
        self.quarantine = quarantine or QuarantinePolicy()
        self.resume = bool(resume)
        self.stats = StreamStats()
        overlap = set(self.id_columns) & set(
            self.id_tag_names if self.id_tag_names != "auto" else ()
        )
        if overlap:
            raise ValueError(
                f"id name(s) {sorted(overlap)} listed in both id_columns "
                "and id_tag_names; each id tag must come from exactly "
                "one source")
        # Frozen at construction, BEFORE the vocab scan resolves
        # "auto"/probed fields in place — the cursor and vocab artifact
        # are pinned to the configuration as the CALLER stated it, so a
        # resumed run (which re-resolves from the committed artifact)
        # computes the same key.
        self._frozen_config_key = self._config_key()

    # -- config identity ---------------------------------------------------

    def _shard_intercept(self, shard: str) -> bool:
        if isinstance(self.add_intercept, dict):
            return self.add_intercept.get(shard, True)
        return bool(self.add_intercept)

    @staticmethod
    def _map_digest(m) -> str:
        """Content identity of a prebuilt index map: every (index, key)
        pair, in index order. A regenerated vocabulary of the SAME size
        but different key->index assignment must fail the resume config
        check — size alone would silently mix feature mappings across
        the resume boundary."""
        h = hashlib.sha1()
        for i in range(len(m)):
            h.update(f"{i}\t{m.get_feature_name(i)}\n".encode())
        return h.hexdigest()

    def _config_key(self) -> str:
        """Identity of everything a resumed ingest must share with the
        run that wrote the cursor — a changed window size, shard
        layout, or vocabulary would silently produce different packed
        buffers than the run being resumed."""
        maps = self.index_maps or {}
        parts = [
            repr(sorted(
                (s, tuple(bags)) for s, bags in self.feature_shards.items()
            )),
            repr(self.id_tag_names),
            repr(sorted(self.id_columns)),
            repr(self.response_field),
            repr(sorted(self.cols.items())),
            repr(sorted(
                (s, self._shard_intercept(s)) for s in self.feature_shards
            )),
            repr(str(self.np_dtype)),
            repr(self.window_shards),
            repr(sorted(
                (s, self._map_digest(m)) for s, m in maps.items()
            )),
        ]
        return hashlib.sha1("\n".join(parts).encode()).hexdigest()

    # -- manifest ----------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.work_dir, MANIFEST_FILE)

    def _ensure_manifest(self) -> tuple[dict, str]:
        """Load (resume) or build+commit the integrity manifest; returns
        (manifest, sha256-of-committed-bytes) — the hash every cursor
        and vocab artifact is pinned to."""
        os.makedirs(self.work_dir, exist_ok=True)
        path = self._manifest_path()
        producer = os.path.join(self.stream_dir, MANIFEST_FILE)
        if self.resume:
            if not os.path.exists(path):
                raise ResumeMismatchError(
                    f"--resume-ingest: no committed manifest at {path}; "
                    "nothing to resume — run a fresh ingest")
            with open(path, "rb") as f:
                raw = f.read()
            return json.loads(raw.decode()), hashlib.sha256(raw).hexdigest()
        if os.path.exists(producer):
            # A producer-committed manifest travels WITH the data: trust
            # it (the point is detecting rot after it was written).
            with open(producer, "rb") as f:
                raw = f.read()
            manifest = json.loads(raw.decode())
            if self.shard_names is not None:
                wanted = set(self.shard_names)
                manifest = dict(
                    manifest,
                    shards=[
                        s for s in manifest["shards"]
                        if s["name"] in wanted
                    ],
                )
                raw = _manifest_bytes(manifest)
        else:
            manifest = build_shard_manifest(
                self.stream_dir, self.shard_names
            )
            raw = _manifest_bytes(manifest)
        from photon_tpu_torch.io.model_io import atomic_write_bytes

        atomic_write_bytes(path, raw)
        return manifest, hashlib.sha256(raw).hexdigest()

    # -- shard read / decode (the retried, fault-injected boundary) --------

    def _shard_path(self, info: dict) -> str:
        return os.path.join(self.stream_dir, info["name"])

    def _read_verify(self, info: dict) -> bytes:
        """Read the shard's bytes ONCE and verify size+sha256 against
        the manifest; returns the verified buffer so the decode pass
        never re-reads the disk (and there is no TOCTOU window between
        checksum and decode). Transient read faults (EIO-style, or the
        injected ``io.shard_read`` kind) are retried by the wrapper; an
        intact read with the wrong bytes is corruption — typed, never
        retried.
        """
        from photon_tpu_torch.resilience import retry

        path = self._shard_path(info)

        def once() -> bytes:
            with open(path, "rb") as f:
                data = f.read()
            digest = hashlib.sha256(data).hexdigest()
            if len(data) != info["size"] or digest != info["sha256"]:
                raise CorruptShardError(
                    f"shard {path}: size/checksum mismatch vs ingest "
                    f"manifest (size {len(data)} vs {info['size']}, "
                    f"sha256 {digest[:12]}... vs "
                    f"{info['sha256'][:12]}...) — the shard was "
                    "truncated or modified after the manifest was "
                    "committed")
            return data

        return retry.retrying_check(
            "io.shard_read", once, site="stream.shard_read"
        )

    def _iter_shard(self, info: dict, data: bytes):
        """Typed-error record stream over one shard's verified bytes."""
        path = self._shard_path(info)
        try:
            yield from avro.iter_container_bytes(data, name=path)
        except _DECODE_ERRORS as exc:
            raise CorruptShardError(
                f"shard {path}: Avro decode failed "
                f"({type(exc).__name__}: {exc}) — the shard is "
                "truncated or not a valid container") from exc

    def _decode_shard(
        self, info: dict, maps: dict[str, IndexMap], data: bytes
    ):
        """Decode one verified shard into column lists + ELL rows.

        Runs INSIDE the retry wrapper: a transient decode fault redoes
        the whole shard into fresh lists (no partial double-append). A
        record count disagreeing with the manifest is corruption.
        """
        from photon_tpu_torch.resilience import retry

        path = self._shard_path(info)
        tag_names = self._tag_names()

        def once():
            labels: list = []
            offsets: list = []
            weights: list = []
            uids: list = []
            tags: dict[str, list] = {t: [] for t in tag_names}
            rows: dict[str, list] = {s: [] for s in self.feature_shards}
            base = int(info.get("row_offset") or 0)
            n = 0
            for i, rec in enumerate(self._iter_shard(info, data)):
                n += 1
                if self.response_field not in rec:
                    # Typed like the id-tag cases below: schema drift in
                    # ONE shard must name the file and stay eligible for
                    # the quarantine policy, not abort the run with a
                    # bare KeyError from a pool thread.
                    raise CorruptShardError(
                        f"shard {path}: record {i} is missing response "
                        f"field {self.response_field!r}")
                labels.append(rec[self.response_field])
                off = rec.get(self.cols["offset"])
                offsets.append(off if off is not None else 0.0)
                wt = rec.get(self.cols["weight"])
                weights.append(wt if wt is not None else 1.0)
                uids.append(_uid_to_int(rec.get(self.cols["uid"]), base + i))
                for shard, bags in self.feature_shards.items():
                    imap = maps[shard]
                    row = []
                    for bag in bags:
                        for f in rec.get(bag) or ():
                            idx = imap.get_index(
                                make_feature_key(f["name"], f["term"]))
                            if idx is not None and f["value"] != 0.0:
                                row.append((idx, float(f["value"])))
                    if imap.intercept_index is not None:
                        row.append((imap.intercept_index, 1.0))
                    rows[shard].append(row)
                meta = rec.get(self.cols["metadataMap"]) or {}
                for col in self.id_columns:
                    if col not in rec or rec[col] is None:
                        raise CorruptShardError(
                            f"shard {path}: record {i} is missing id "
                            f"column {col!r}")
                    tags[col].append(rec[col])
                for t in tag_names:
                    if t in self.id_columns:
                        continue
                    if t not in meta:
                        raise CorruptShardError(
                            f"shard {path}: record {i} is missing id "
                            f"tag {t!r} in metadataMap")
                    tags[t].append(meta[t])
            if info.get("records") is not None and n != info["records"]:
                raise CorruptShardError(
                    f"shard {path}: decoded {n} record(s) but the "
                    f"ingest manifest records {info['records']} — the "
                    "container lost blocks after the manifest was "
                    "committed")
            return labels, offsets, weights, uids, tags, rows

        return retry.retrying_check(
            "io.shard_decode", once, site="stream.shard_decode"
        )

    # -- the window decode thunk (chunk-pool thread entry) -----------------

    def _decode_window(
        self,
        widx: int,
        infos: list[dict],
        maps: dict[str, IndexMap],
        known_bad: frozenset,
    ) -> _Window:
        """Decode one window of shards into numpy arrays. Pure
        file-read + numpy, no CUDA call (the device transfer stays on
        the training thread). Corrupt shards are recorded, not raised:
        the training thread applies the quarantine budget so the
        decision is made in deterministic window order."""
        t0 = time.perf_counter()
        labels: list = []
        offsets: list = []
        weights: list = []
        uids: list = []
        tag_names = self._tag_names()
        tags: dict[str, list] = {t: [] for t in tag_names}
        rows: dict[str, list] = {s: [] for s in self.feature_shards}
        quarantined: list[tuple[str, CorruptShardError]] = []
        for info in infos:
            path = self._shard_path(info)
            if path in known_bad:
                continue
            try:
                data = self._read_verify(info)
                ls, os_, ws, us, tg, rw = self._decode_shard(
                    info, maps, data
                )
            except CorruptShardError as exc:
                quarantined.append((path, exc))
                continue
            labels.extend(ls)
            offsets.extend(os_)
            weights.extend(ws)
            uids.extend(us)
            for t in tag_names:
                tags[t].extend(tg[t])
            for s in self.feature_shards:
                rows[s].extend(rw[s])
            self.stats.count("shards_decoded")
        n = len(labels)
        window = _Window(
            index=widx,
            rows=n,
            # float64 accumulation then one cast — the same chunk
            # semantics as the in-memory reader, so streamed values are
            # bit-identical to read_merged's.
            labels=np.asarray(labels, np.float64).astype(self.np_dtype),
            offsets=np.asarray(offsets, np.float64).astype(self.np_dtype),
            weights=np.asarray(weights, np.float64).astype(self.np_dtype),
            uids=np.asarray(uids, dtype=np.int64),
            tags={t: np.asarray(v) for t, v in tags.items()},
            shards={
                s: _pack_rows(rows[s], len(maps[s]), self.np_dtype)
                for s in self.feature_shards
            },
            quarantined=quarantined,
        )
        self.stats.add_seconds("decode", time.perf_counter() - t0)
        self.stats.count("rows_decoded", n)
        return window

    def _tag_names(self) -> list[str]:
        names = list(self.id_columns)
        tag_src = self.id_tag_names if self.id_tag_names != "auto" else ()
        for t in tag_src:
            if t not in names:
                names.append(t)
        return names

    # -- vocabulary scan ---------------------------------------------------

    def _vocab_path(self) -> str:
        return os.path.join(self.work_dir, VOCAB_FILE)

    def _resolve_vocab(
        self, manifest: dict, manifest_sha: str, budget: int
    ) -> dict[str, IndexMap]:
        """Prebuilt maps pass through; otherwise one streamed scan pass
        builds the missing vocabularies / discovers metadata tag names
        / probes the response field, with the same retry + quarantine
        semantics as the build pass, and commits the result so a
        resumed ingest reuses the identical vocabulary."""
        missing = [
            s for s in self.feature_shards
            if self.index_maps is None or s not in self.index_maps
        ]
        need_scan = bool(missing) or self.id_tag_names == "auto"
        out: dict[str, IndexMap] = dict(self.index_maps or {})

        vocab_path = self._vocab_path()
        # The committed vocabulary is reused ONLY on resume: a fresh run
        # must re-scan (and re-verify) every shard — an operator who
        # repaired a previously quarantined shard gets its rows back
        # instead of the artifact's stale quarantine set silently
        # excluding a now-healthy file.
        if need_scan and self.resume and os.path.exists(vocab_path):
            with open(vocab_path) as f:
                art = json.load(f)
            if (
                art.get("manifest_sha256") == manifest_sha
                and art.get("config_key") == self._frozen_config_key
            ):
                for s, fwd in art["maps"].items():
                    out[s] = IndexMap({k: int(v) for k, v in fwd.items()})
                self.id_tag_names = list(art["id_tag_names"])
                self.response_field = art["response_field"]
                for path, reason in art.get("quarantined", {}).items():
                    self.stats.quarantine(path, reason)
                restored = self.stats.quarantined()
                if len(restored) > budget:
                    # The artifact was committed under a LOOSER policy;
                    # this run's budget refuses the recorded loss.
                    raise CorruptShardError(
                        f"{len(restored)} shard(s) were quarantined by "
                        "the run that committed this vocabulary "
                        f"({sorted(restored)}) but the current policy "
                        f"allows {budget}; raise max_bad_shards/"
                        "max_bad_fraction or repair the shards")
                return out
            raise ResumeMismatchError(
                f"--resume-ingest: the committed vocabulary at "
                f"{vocab_path} was built from a different manifest "
                "or ingest configuration; run a fresh ingest")

        if need_scan:
            keysets: dict[str, set] = {s: set() for s in missing}
            meta_keys: set[str] = set()
            first = None
            t0 = time.perf_counter()
            for info in manifest["shards"]:
                path = self._shard_path(info)
                try:
                    data = self._read_verify(info)
                    got_first = self._scan_shard(
                        info, data, keysets, meta_keys, first is None
                    )
                except CorruptShardError as exc:
                    self.stats.quarantine(path, str(exc))
                    if len(self.stats.quarantined()) > budget:
                        raise
                    logger.warning(
                        "streaming ingest: quarantined %s at scan (%s)",
                        path, exc)
                    continue
                if first is None:
                    first = got_first
            self.stats.add_seconds("scan", time.perf_counter() - t0)
            if first is None:
                raise ValueError(
                    f"no decodable records under {self.stream_dir}")
            if self.response_field is None:
                for candidate in ("response", "label"):
                    if candidate in first:
                        self.response_field = candidate
                        break
                else:
                    raise ValueError(
                        "records carry neither 'response' nor 'label'; "
                        "pass response_field explicitly")
            if self.id_tag_names == "auto":
                self.id_tag_names = sorted(meta_keys)
            for s in missing:
                out[s] = IndexMap.from_feature_names(
                    keysets.pop(s),
                    add_intercept=self._shard_intercept(s),
                )
            _atomic_json(vocab_path, {
                "schema_version": SCHEMA_VERSION,
                "manifest_sha256": manifest_sha,
                "config_key": self._frozen_config_key,
                "maps": {
                    s: dict(out[s].items())
                    for s in sorted(self.feature_shards)
                },
                "id_tag_names": list(self.id_tag_names),
                "response_field": self.response_field,
                "quarantined": self.stats.quarantined(),
            })
        elif self.response_field is None:
            self.response_field = self._probe_response(manifest)
        return out

    def _scan_shard(
        self, info: dict, data: bytes, keysets: dict, meta_keys: set,
        want_first: bool,
    ):
        """One shard's scan pass (inside the retry wrapper)."""
        from photon_tpu_torch.resilience import retry

        def once():
            first = None
            for rec in self._iter_shard(info, data):
                if want_first and first is None:
                    first = rec
                for s, ks in keysets.items():
                    for bag in self.feature_shards[s]:
                        for f in rec.get(bag) or ():
                            ks.add(make_feature_key(f["name"], f["term"]))
                if self.id_tag_names == "auto":
                    meta_keys.update(
                        (rec.get(self.cols["metadataMap"]) or {}).keys()
                    )
            return first

        return retry.retrying_check(
            "io.shard_decode", once, site="stream.shard_scan"
        )

    def _probe_response(self, manifest: dict) -> str:
        for info in manifest["shards"]:
            try:
                first = next(
                    iter(avro.iter_container(self._shard_path(info)))
                )
            except (*_DECODE_ERRORS, OSError, StopIteration):
                continue
            for candidate in ("response", "label"):
                if candidate in first:
                    return candidate
            break
        raise ValueError(
            "records carry neither 'response' nor 'label'; pass "
            "response_field explicitly")

    # -- cursor + spills ---------------------------------------------------

    def _cursor_path(self) -> str:
        return os.path.join(self.work_dir, CURSOR_FILE)

    def _sketch_path(self) -> str:
        return os.path.join(self.work_dir, SKETCH_FILE)

    def _spill_path(self, widx: int) -> str:
        return os.path.join(self.work_dir, f"window-{widx:05d}.npz")

    def _commit_cursor(
        self, manifest_sha: str, next_shard: int, windows: int, rows: int
    ) -> None:
        _atomic_json(self._cursor_path(), {
            "schema_version": SCHEMA_VERSION,
            "manifest_sha256": manifest_sha,
            "config_key": self._frozen_config_key,
            "next_shard": int(next_shard),
            "windows_committed": int(windows),
            "rows_ingested": int(rows),
            "window_shards": self.window_shards,
            "quarantined": self.stats.quarantined(),
        })

    def _load_cursor(self, manifest_sha: str) -> dict | None:
        path = self._cursor_path()
        if not os.path.exists(path):
            return None
        with open(path) as f:
            cursor = json.load(f)
        if cursor.get("schema_version") != SCHEMA_VERSION:
            raise ResumeMismatchError(
                f"ingest cursor {path}: schema_version "
                f"{cursor.get('schema_version')!r} is not the supported "
                f"{SCHEMA_VERSION}")
        if cursor.get("manifest_sha256") != manifest_sha:
            raise ResumeMismatchError(
                f"ingest cursor {path} was committed against a different "
                "shard manifest — the stream directory changed since the "
                "interrupted run; run a fresh ingest")
        if cursor.get("config_key") != self._frozen_config_key:
            raise ResumeMismatchError(
                f"ingest cursor {path} was committed under a different "
                "ingest configuration (shards/tags/window/vocabulary "
                "changed); run a fresh ingest")
        return cursor

    def _spill_window(self, window: _Window) -> None:
        """Atomically spill one window's arrays so a resumed ingest
        reloads them instead of re-reading + re-decoding the shards."""
        from photon_tpu_torch.io.model_io import atomic_write_bytes

        arrays: dict[str, np.ndarray] = {
            "labels": window.labels,
            "offsets": window.offsets,
            "weights": window.weights,
            "uids": window.uids,
        }
        for t, v in window.tags.items():
            arrays[f"tag/{t}"] = v
        for s, (idx, val) in window.shards.items():
            arrays[f"shard/{s}/idx"] = idx
            arrays[f"shard/{s}/val"] = val
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        atomic_write_bytes(self._spill_path(window.index), buf.getbuffer())

    def _load_spill(self, widx: int) -> _Window:
        path = self._spill_path(widx)
        try:
            with np.load(path) as z:
                tags = {}
                shards = {}
                for key in z.files:
                    if key.startswith("tag/"):
                        tags[key[4:]] = z[key]
                    elif key.startswith("shard/") and key.endswith("/idx"):
                        s = key[len("shard/"):-len("/idx")]
                        shards[s] = (z[key], z[f"shard/{s}/val"])
                return _Window(
                    index=widx,
                    rows=int(z["labels"].shape[0]),
                    labels=z["labels"],
                    offsets=z["offsets"],
                    weights=z["weights"],
                    uids=z["uids"],
                    tags=tags,
                    shards=shards,
                    quarantined=[],
                )
        except (OSError, ValueError, KeyError, EOFError) as exc:
            raise ResumeMismatchError(
                f"ingest spill {path} is missing or unreadable ({exc}); "
                "the work dir was pruned mid-chain — run a fresh ingest"
            ) from exc

    # -- the run -----------------------------------------------------------

    def run(self) -> tuple[GameDataset, dict]:
        """Stream-ingest the directory; returns (dataset, stats)."""
        from photon_tpu_torch.data.pipeline import (
            PIPELINE_STATS,
            chunk_executor,
        )

        t_run = time.perf_counter()
        manifest, manifest_sha = self._ensure_manifest()
        shards = manifest["shards"]
        budget = self.quarantine.budget(len(shards))
        maps = self._resolve_vocab(manifest, manifest_sha, budget)
        # The resolved (possibly data-scanned) vocabularies: the CLI
        # reads these after run() for the validation read and the models.
        self.resolved_maps = dict(maps)
        self.manifest_sha256 = manifest_sha
        # Data-health sketching (obs/health.py; off by default): with
        # the health layer armed, every window folds into one
        # bounded-memory DataSketch, saved beside the cursor
        # (SKETCH_FILE) at every cursor commit. Windows decode on the
        # chunk pool, but float moment sums are not associative bit for
        # bit, so the fold runs here, on the consuming thread, in window
        # order; a resumed run re-folds the committed windows from their
        # spills in the same order, so a kill-and-resume ingest writes
        # the uninterrupted run's sketch byte for byte.
        from photon_tpu_torch.obs import health

        sketch = health.DataSketch() if health.enabled() else None
        widths = {s: len(maps[s]) for s in self.feature_shards}
        self.health_sketch = sketch

        cursor = self._load_cursor(manifest_sha) if self.resume else None
        start_window = 0
        rows_ingested = 0
        resumed_from = None
        windows: list[_Window] = []
        if cursor is not None:
            start_window = int(cursor["windows_committed"])
            rows_ingested = int(cursor["rows_ingested"])
            resumed_from = int(cursor["next_shard"])
            for path, reason in cursor.get("quarantined", {}).items():
                self.stats.quarantine(path, reason)
            restored = self.stats.quarantined()
            if len(restored) > budget:
                # The cursor was committed under a LOOSER policy; this
                # run's budget refuses the recorded loss, also when the
                # ingest was complete and no window would re-check it.
                raise CorruptShardError(
                    f"{len(restored)} shard(s) were quarantined by the "
                    f"run that committed this cursor "
                    f"({sorted(restored)}) but the current policy "
                    f"allows {budget}; raise max_bad_shards/"
                    "max_bad_fraction or repair the shards and run a "
                    "fresh ingest")
            for w in range(start_window):
                window = self._load_spill(w)
                self._transfer_window(window, PIPELINE_STATS)
                if sketch is not None:
                    sketch.update_window(
                        window.labels, window.offsets, window.weights,
                        window.shards, widths)
                windows.append(window)
            logger.info(
                "streaming ingest: resumed at shard %d/%d (%d window "
                "spill(s) reloaded, %d rows)", resumed_from, len(shards),
                start_window, rows_ingested)

        # Window plan: consecutive groups over the FULL manifest order
        # (already-quarantined shards are skipped inside the decode, so
        # the window -> shard mapping is identical across resumes).
        specs = [
            (w, shards[lo:lo + self.window_shards])
            for w, lo in enumerate(
                range(0, len(shards), self.window_shards))
        ]
        known_bad = frozenset(self.stats.quarantined())
        pending: tuple[int, object] | None = None
        todo = specs[start_window:]
        if todo:
            widx, infos = todo[0]
            pending = (0, chunk_executor.submit(
                self._decode_window, widx, infos, maps, known_bad))
        while pending is not None:
            i, fut = pending
            # Double buffer: window i+1 starts decoding on the chunk
            # pool BEFORE window i's result is consumed, so its decode
            # overlaps window i's device copy and spill.
            pending = None
            if i + 1 < len(todo):
                widx, infos = todo[i + 1]
                pending = (i + 1, chunk_executor.submit(
                    self._decode_window, widx, infos, maps, known_bad))
            try:
                window = fut.result()
            except BaseException:
                self._drain(pending)
                raise
            for path, exc in window.quarantined:
                self.stats.quarantine(path, str(exc))
                logger.warning(
                    "streaming ingest: quarantined %s (%s)", path, exc)
            if len(self.stats.quarantined()) > budget:
                self._drain(pending)
                if window.quarantined:
                    raise window.quarantined[-1][1]
                raise CorruptShardError(  # pragma: no cover — the
                    # cursor-restore check above already refuses an
                    # inherited over-budget set.
                    f"quarantined shards exceed the policy budget "
                    f"({budget}): {sorted(self.stats.quarantined())}")
            self._transfer_window(window, PIPELINE_STATS)
            self._spill_window(window)
            if sketch is not None:
                sketch.update_window(
                    window.labels, window.offsets, window.weights,
                    window.shards, widths)
            windows.append(window)
            rows_ingested += window.rows
            next_shard = min(
                (todo[i][0] + 1) * self.window_shards, len(shards))
            self._commit_cursor(
                manifest_sha, next_shard, todo[i][0] + 1, rows_ingested)
            if sketch is not None:
                # At the same shard boundary as the cursor: a resumed
                # run that reloads these windows lands on this file.
                sketch.save(self._sketch_path())

        data = self._assemble(windows, maps, PIPELINE_STATS)
        stats = self._final_stats(
            manifest, rows_ingested, resumed_from,
            time.perf_counter() - t_run)
        if sketch is not None:
            sketch.save(self._sketch_path())
            health.set_train_sketch(sketch)
            stats["health_sketch_path"] = self._sketch_path()
        return data, stats

    def _drain(self, pending) -> None:
        """Consume an in-flight decode future on the error path (its
        outcome is discarded by design; a dropped future would hide a
        second failure)."""
        if pending is None:
            return
        try:
            pending[1].result()
        except Exception as exc:  # noqa: BLE001 — the primary error wins
            logger.warning(
                "streaming ingest: in-flight window decode also failed "
                "while aborting: %r", exc)

    # -- device transfer + assembly ----------------------------------------

    def _side_stream(self):
        stream = getattr(self, "_stream", None)
        if stream is None:
            stream = self._stream = torch.cuda.Stream(self.device)
            self._in_flight: list[_Window] = []
        return stream

    def _release_staging(self) -> None:
        """Drop the pinned host copies of the windows whose copy has
        completed, so the caching host allocator hands their memory to
        the next window: at most a few windows' pinned memory is held."""
        pending = []
        for w in self._in_flight:
            if w.event.query():
                w.staging = None
            else:
                pending.append(w)
        self._in_flight = pending

    def _transfer_window(self, window: _Window, pstats) -> None:
        """Start the window's copy to the device. On the card: pinned
        host tensors, ``non_blocking`` copies on a side stream and an
        event recorded behind them, so the copy drains while the next
        window decodes on the chunk pool. Runs on the training thread."""
        if window.rows == 0:
            window.devs = None
            return
        arrays = [window.labels, window.offsets, window.weights]
        for s in sorted(window.shards):
            idx, val = window.shards[s]
            arrays.extend((idx, val))
        t0 = time.perf_counter()
        with pstats.stage("stream_transfer"):
            host = [torch.from_numpy(np.ascontiguousarray(a))
                    for a in arrays]
            if self.device.type != "cuda":
                window.devs = [t.to(self.device) for t in host]
            else:
                side = self._side_stream()
                self._release_staging()
                window.staging = [t.pin_memory() for t in host]
                with torch.cuda.stream(side):
                    window.devs = [t.to(self.device, non_blocking=True)
                                   for t in window.staging]
                    window.event = torch.cuda.Event()
                    window.event.record(side)
                self._in_flight.append(window)
        self.stats.add_seconds("transfer", time.perf_counter() - t0)

    def _assemble(
        self, windows: list[_Window], maps: dict[str, IndexMap], pstats
    ) -> GameDataset:
        """Concatenate the per-window arrays into the final GameDataset:
        host mirrors from the numpy windows (byte-identical to the
        in-memory reader's layout), device columns from the transferred
        window tensors (each ELL slab padded to the widest window's
        width, one ``torch.cat`` per column)."""
        live = [w for w in windows if w.rows > 0]
        if not live:
            raise ValueError(
                f"no records ingested from {self.stream_dir} "
                f"(quarantined: {sorted(self.stats.quarantined())})")
        host: dict = {
            "labels": np.concatenate([w.labels for w in live]),
            "offsets": np.concatenate([w.offsets for w in live]),
            "weights": np.concatenate([w.weights for w in live]),
        }
        uids = np.concatenate([w.uids for w in live])
        tag_names = self._tag_names()
        id_tags = {
            t: IdTag.from_raw(np.concatenate([w.tags[t] for w in live]),
                              self.device)
            for t in tag_names
        }

        shard_names = sorted(self.feature_shards)
        widths = {
            s: max(w.shards[s][0].shape[1] for w in live)
            for s in shard_names
        }
        for s in shard_names:
            k = widths[s]
            host[("shard", s)] = (
                np.concatenate([
                    np.pad(w.shards[s][0],
                           ((0, 0), (0, k - w.shards[s][0].shape[1])))
                    for w in live
                ]),
                np.concatenate([
                    np.pad(w.shards[s][1],
                           ((0, 0), (0, k - w.shards[s][1].shape[1])))
                    for w in live
                ]),
                len(maps[s]),
            )

        with pstats.stage("stream_assemble"):
            if self.device.type == "cuda":
                # The window tensors were made on the side stream: the
                # current stream waits for each copy, and the caching
                # allocator learns they are used here too.
                current = torch.cuda.current_stream(self.device)
                for w in live:
                    current.wait_event(w.event)
                    for t in w.devs:
                        t.record_stream(current)

            def col(j):
                return torch.cat([w.devs[j] for w in live])

            labels_dev, offsets_dev, weights_dev = col(0), col(1), col(2)
            feature_shards = {}
            for si, s in enumerate(shard_names):
                k = widths[s]
                parts_idx = []
                parts_val = []
                for w in live:
                    di = w.devs[3 + 2 * si]
                    dv = w.devs[3 + 2 * si + 1]
                    pad = k - di.shape[1]
                    if pad:
                        di = torch.nn.functional.pad(di, (0, pad))
                        dv = torch.nn.functional.pad(dv, (0, pad))
                    parts_idx.append(di)
                    parts_val.append(dv)
                feature_shards[s] = SparseFeatures(
                    torch.cat(parts_idx), torch.cat(parts_val),
                    len(maps[s]))
            for w in live:
                # The pinned host copies are released only once their
                # copy has completed.
                if w.event is not None:
                    w.event.synchronize()
                w.devs = w.staging = w.event = None
        return GameDataset(
            labels=labels_dev,
            offsets=offsets_dev,
            weights=weights_dev,
            feature_shards=feature_shards,
            id_tags=id_tags,
            uids=uids,
            host=host,
        )

    def _final_stats(
        self, manifest: dict, rows: int, resumed_from, wall: float
    ) -> dict:
        snap = self.stats.snapshot()
        quarantined = snap["quarantined"]
        known = [
            s["records"] for s in manifest["shards"]
            if s["records"] is not None
        ]
        expected = sum(known)
        if len(known) < len(manifest["shards"]) and known:
            # Unscannable shards (records=None) are already corrupt;
            # estimate their rows at the known-shard mean so the
            # fraction still reflects the loss.
            expected += int(
                (len(manifest["shards"]) - len(known))
                * (sum(known) / len(known)))
        fraction = (rows / expected) if expected else 0.0
        stats = {
            "manifest_sha256": getattr(self, "manifest_sha256", None),
            "work_dir": self.work_dir,
            "shards_total": len(manifest["shards"]),
            "shards_ingested": len(manifest["shards"]) - len(quarantined),
            "shards_quarantined": len(quarantined),
            "quarantined_paths": sorted(quarantined),
            "rows_ingested": int(rows),
            "expected_rows": int(expected),
            "ingested_fraction": round(min(fraction, 1.0), 6),
            "window_shards": self.window_shards,
            "resumed_from_shard": resumed_from,
            "scan_seconds": round(snap["seconds"].get("scan", 0.0), 4),
            "decode_seconds": round(snap["seconds"].get("decode", 0.0), 4),
            "transfer_seconds": round(
                snap["seconds"].get("transfer", 0.0), 4),
            "wall_seconds": round(wall, 4),
            "rows_per_sec": round(rows / wall, 1) if wall > 0 else None,
        }
        # Process-wide retry counters: zero on a clean run; after
        # injected or real transients the recovery count is visible.
        from photon_tpu_torch.resilience import retry_stats

        stats["retry"] = retry_stats()
        # The ingest's health as registry gauges (not gated on the
        # telemetry flag, as in the JAX package).
        from photon_tpu_torch import obs

        obs.REGISTRY.gauge("stream_ingested_fraction").set(
            stats["ingested_fraction"])
        obs.REGISTRY.gauge("stream_quarantined_shards").set(
            len(quarantined))
        obs.REGISTRY.gauge("stream_rows_ingested").set(rows)
        return stats
