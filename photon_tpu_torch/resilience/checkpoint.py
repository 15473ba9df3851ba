"""Crash-safe training checkpoints: atomic writes and a validating
manifest (port of ``photon_tpu/resilience/checkpoint.py``).

After every outer coordinate-descent iteration the estimator hands the
``TrainingCheckpointer`` the whole ``GameModel``, and it commits one
loadable recovery point:

1. the model ``.npz`` goes to a temp name, is fsynced and renamed to
   ``checkpoint-c<config>-i<iter>.npz``, and the directory is fsynced
   (``io.model_io.atomic_write_bytes``; the ``checkpoint.write`` fault
   point sits in the mid-write window);
2. ``manifest.json`` (schema version, the configuration's static key,
   config index and iteration, the npz name and its sha256) is then
   committed the same way. It is the single commit point: a crash
   before its rename leaves the previous manifest naming the previous,
   still present, npz;
3. superseded npz files are removed only after that commit.

Loading reads the manifest (``CheckpointError`` when it is absent or of
another schema), checks the npz's hash (``CorruptModelError`` on a
mismatch) and decodes the model. The static key pins what a checkpoint
may resume: ``--resume`` under a changed configuration raises
``ResumeMismatchError``.

The files are the JAX package's layout, so either package loads the
other's checkpoints; each computes the static key from its own
configuration types, so a resume stays within one package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import re
import time

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 1
MANIFEST_FILE = "manifest.json"

# Completed-config final artifacts (``config-c<idx>-final.npz``) are
# RETAINED across later configs: a resumed multi-config run rebuilds
# the completed configs' results from them so the returned list lines
# up with the full grid (select_best / tuning / artifact indices).
# The in-progress config's best-by-validation model is retained the
# same way (``config-c<idx>-best.npz``, rewritten whenever the best
# improves): the per-iteration chain holds final-iteration state, so
# without it a resumed run would restart best selection from scratch
# and could silently return a worse model than the uninterrupted run.

_FINAL_RE = re.compile(r"^config-c(\d+)-final\.npz$")
_BEST_RE = re.compile(r"^config-c(\d+)-best\.npz$")


def _final_name(config_index: int) -> str:
    return f"config-c{config_index:03d}-final.npz"


def _best_name(config_index: int) -> str:
    return f"config-c{config_index:03d}-best.npz"


def training_static_key(estimator, opt_config_sequence=None) -> str:
    """Hashable identity of everything a resumed run must share with
    the run that wrote the checkpoint.

    Built from dataclass reprs (deterministic for the frozen config
    dataclasses involved) of: task, per-coordinate configurations,
    update sequence, iteration count, locked coordinates, incremental
    flag, normalization shard names, and the optimization-config grid.
    Data contents are deliberately NOT keyed: resuming on refreshed
    data is warm-start territory, not a config mismatch.
    """
    parts = [
        repr(estimator.task),
        repr(sorted(
            (cid, repr(cfg))
            for cid, cfg in estimator.coordinate_configs.items()
        )),
        repr(list(estimator.update_sequence)),
        repr(int(estimator.num_iterations)),
        repr(sorted(estimator.locked_coordinates)),
        repr(bool(estimator.incremental_training)),
        repr(sorted(estimator.normalization)),
    ]
    if opt_config_sequence is not None:
        parts.append(repr([
            sorted((cid, repr(c)) for cid, c in cfgs.items())
            for cfgs in opt_config_sequence
        ]))
    return hashlib.sha1("\n".join(parts).encode("utf-8")).hexdigest()


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _atomic_write_json(path: str, payload: dict) -> None:
    from photon_tpu_torch.io.model_io import atomic_write_bytes

    atomic_write_bytes(
        path,
        json.dumps(payload, indent=2, sort_keys=True).encode("utf-8"),
    )


@dataclasses.dataclass(frozen=True)
class TrainingCheckpoint:
    """A loaded recovery point (what ``fit(resume=...)`` consumes)."""

    model: object  # GameModel
    config_index: int
    iteration: int  # last COMPLETED outer CD iteration of that config
    static_key: str
    interrupted: bool
    manifest: dict
    path: str  # the npz the model came from


class TrainingCheckpointer:
    """Writes one recovery point per completed outer CD iteration.

    Single-writer by design: only the training thread calls ``save``
    (the estimator invokes it from the CD loop's iteration callback),
    so it owns no locks. ``write_emergency`` re-commits the LAST saved
    state with ``interrupted=True`` — the CLI's signal handler calls it
    so an operator can tell a clean stop from a killed one.
    """

    def __init__(self, directory: str, static_key: str):
        self.directory = directory
        self.static_key = static_key
        self._last: tuple[object, int, int] | None = None
        self._committed_fname: str | None = None
        os.makedirs(directory, exist_ok=True)
        # Adopt what an interrupted run left behind so this instance's
        # GC keeps retaining it: the manifest-referenced npz (a fresh
        # checkpointer healing a config-final must not delete the
        # committed recovery point it is finalizing FROM) and the
        # best-model artifact (after a resume the best may never
        # improve again, so the hook may never rewrite the file —
        # losing it would strand the NEXT resume without the
        # pre-crash best).
        mpath = os.path.join(directory, MANIFEST_FILE)
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    self._committed_fname = json.load(f).get("file")
            except (OSError, json.JSONDecodeError):
                pass  # unreadable manifest: load will surface it
        self._best_fname: str | None = None
        for name in sorted(os.listdir(directory)):
            if _BEST_RE.match(name):
                self._best_fname = name
        # The final artifact THIS instance committed for the config in
        # progress. ``save``'s GC only retains finals at index <
        # config_index (an on-disk final at the CURRENT index is stale
        # debris from an earlier run reusing the directory), so the
        # emergency re-commit after ``save_config_final(ci)`` — cursor
        # still at ci — must pin its own final explicitly or destroy
        # the artifact the resume path depends on.
        self._final_fname: str | None = None
        # Run provenance riding every manifest commit (the ``run``
        # block): the init-model digest of a warm-started run.
        self._run_meta: dict | None = None

    def set_run_meta(self, meta: dict | None) -> None:
        """Attach run provenance (the init-model digest) to
        every subsequent manifest commit. JSON-serializable values only;
        None clears."""
        self._run_meta = None if meta is None else dict(meta)

    def save(
        self,
        model,
        *,
        config_index: int,
        iteration: int,
        interrupted: bool = False,
    ) -> str:
        """Commit one recovery point; returns the npz path."""
        from photon_tpu_torch.io.model_io import (
            atomic_write_bytes,
            checkpoint_bytes,
        )

        # The emergency re-commit gets its OWN filename: writing over
        # the npz the current manifest references would open a window
        # (after the npz os.replace, before the manifest commit) where
        # a second kill leaves the manifest's sha256 pointing at
        # changed bytes — the crash-safety layer destroying its only
        # recovery point.
        suffix = "-interrupted" if interrupted else ""
        fname = (
            f"checkpoint-c{config_index:03d}-i{iteration:03d}"
            f"{suffix}.npz"
        )
        path = os.path.join(self.directory, fname)
        meta = {
            "schema_version": SCHEMA_VERSION,
            "static_key": self.static_key,
            "config_index": int(config_index),
            "iteration": int(iteration),
            "interrupted": bool(interrupted),
        }
        # Step 1: the npz, carrying the loop state in its own embedded
        # manifest so the artifact is self-contained.
        data = checkpoint_bytes(model, meta)
        atomic_write_bytes(path, data, fault_point="checkpoint.write")
        digest = hashlib.sha256(data).hexdigest()
        # Step 2: the manifest commit point (hashed from the bytes
        # written, never re-read).
        manifest = dict(meta)
        manifest["file"] = fname
        manifest["sha256"] = digest
        manifest["written_at"] = time.time()
        if self._run_meta is not None:
            manifest["run"] = dict(self._run_meta)
        _atomic_write_json(
            os.path.join(self.directory, MANIFEST_FILE), manifest
        )
        self._last = (model, int(config_index), int(iteration))
        self._committed_fname = fname
        keep = {fname}
        if self._best_fname is not None:
            keep.add(self._best_fname)
        if self._final_fname is not None:
            keep.add(self._final_fname)
        self._gc(keep=keep, final_max=int(config_index) - 1)
        logger.info(
            "checkpoint: config %d iteration %d committed to %s",
            config_index, iteration, path)
        return path

    def save_best(self, model, *, config_index: int) -> str:
        """Retain the in-progress config's best-by-validation model
        (``config-c<idx>-best.npz``, rewritten atomically whenever the
        best improves — the estimator's iteration hook commits it
        BEFORE the iteration's manifest, so a crash at any point leaves
        a best no newer than one replayed iteration ahead of the
        cursor). A resumed run seeds CD's best tracking from it;
        ``save_config_final`` supersedes it when the config completes."""
        from photon_tpu_torch.io.model_io import save_checkpoint

        fname = _best_name(config_index)
        path = os.path.join(self.directory, fname)
        save_checkpoint(model, path, extra_meta={
            "schema_version": SCHEMA_VERSION,
            "static_key": self.static_key,
            "config_index": int(config_index),
            "kind": "config_best",
        })
        self._best_fname = fname
        return path

    def save_config_final(self, model, *, config_index: int) -> str:
        """Persist a completed config's BEST model as a retained
        artifact (``config-c<idx>-final.npz``). The iteration manifest
        stays the recovery point; these files exist so a resumed run
        can rebuild the completed configs' ``GameFitResult`` entries
        (the per-iteration chain holds final-iteration models, not the
        best-by-validation model this config actually contributed)."""
        from photon_tpu_torch.io.model_io import save_checkpoint

        fname = _final_name(config_index)
        path = os.path.join(self.directory, fname)
        save_checkpoint(model, path, extra_meta={
            "schema_version": SCHEMA_VERSION,
            "static_key": self.static_key,
            "config_index": int(config_index),
            "kind": "config_final",
        })
        keep = {fname}
        if self._committed_fname is not None:
            keep.add(self._committed_fname)
        # The config's best artifact is superseded: the final IS the
        # best model this config contributed — let the GC drop it.
        self._best_fname = None
        self._final_fname = fname
        self._gc(keep=keep, final_max=int(config_index))
        logger.info(
            "checkpoint: config %d final model retained at %s",
            config_index, path)
        return path

    def write_emergency(self) -> str | None:
        """Re-commit the last saved state flagged ``interrupted`` (the
        signal-handler path). None when nothing was ever saved — an
        interrupt during ingest has no loop state to persist."""
        if self._last is None:
            return None
        model, ci, it = self._last
        return self.save(
            model, config_index=ci, iteration=it, interrupted=True
        )

    def _gc(self, *, keep: set, final_max: int) -> None:
        """Drop superseded npz files + stale tmp debris (post-commit).

        Config-final artifacts with index <= ``final_max`` are
        retained for resume; finals at a HIGHER index are stale debris
        from an earlier, deeper run reusing this directory."""
        for name in os.listdir(self.directory):
            if name in keep or name == MANIFEST_FILE:
                continue
            m = _FINAL_RE.match(name)
            if m is not None and int(m.group(1)) <= final_max:
                continue
            if name.startswith(("checkpoint-", "config-")) \
                    or ".tmp." in name:
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError:  # pragma: no cover — concurrent cleanup
                    pass


def load_training_checkpoint(directory: str,
                             device=None) -> TrainingCheckpoint:
    """Load the committed recovery point under ``directory``.

    Raises ``CheckpointError`` when there is none (or a future schema),
    ``CorruptModelError`` when the npz does not match its manifest hash
    or fails to decode.
    """
    from photon_tpu_torch.io.model_io import load_checkpoint
    from photon_tpu_torch.resilience.errors import (
        CheckpointError,
        CorruptModelError,
    )

    mpath = os.path.join(directory, MANIFEST_FILE)
    if not os.path.exists(mpath):
        raise CheckpointError(
            f"no training checkpoint manifest at {mpath}")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        raise CheckpointError(
            f"checkpoint manifest {mpath} unreadable: {exc}") from exc
    version = manifest.get("schema_version")
    if version != SCHEMA_VERSION:
        raise CheckpointError(
            f"checkpoint manifest {mpath}: schema_version {version!r} "
            f"is not the supported {SCHEMA_VERSION}")
    path = os.path.join(directory, manifest["file"])
    if not os.path.exists(path):
        raise CheckpointError(
            f"checkpoint manifest {mpath} names {manifest['file']!r} "
            "but the file is missing")
    digest = _sha256(path)
    if digest != manifest.get("sha256"):
        raise CorruptModelError(
            f"checkpoint {path}: sha256 {digest} does not match the "
            f"manifest's {manifest.get('sha256')} — the file is torn "
            "or was modified after commit")
    model = load_checkpoint(path, device)
    return TrainingCheckpoint(
        model=model,
        config_index=int(manifest["config_index"]),
        iteration=int(manifest["iteration"]),
        static_key=str(manifest["static_key"]),
        interrupted=bool(manifest.get("interrupted", False)),
        manifest=manifest,
        path=path,
    )


def has_config_final(directory: str, config_index: int) -> bool:
    """Whether a completed config's retained final artifact exists —
    distinguishes 'training truly completed' from 'crashed in the
    window between the last-iteration checkpoint and the config-final
    retention'."""
    return os.path.exists(
        os.path.join(directory, _final_name(config_index))
    )


def load_config_best(
    directory: str, config_index: int, static_key: str | None = None,
    device=None,
):
    """Load the in-progress config's retained best-by-validation model
    (the artifact ``save_best`` wrote), or None when there is none —
    missing is normal (no validation, or no full-model best committed
    yet). Raises ``ResumeMismatchError`` when it was written under a
    different training static key."""
    from photon_tpu_torch.io.model_io import load_checkpoint_meta

    path = os.path.join(directory, _best_name(config_index))
    if not os.path.exists(path):
        return None
    model, meta = load_checkpoint_meta(path, device)
    _check_static_key(path, meta, static_key)
    return model


def load_config_final(
    directory: str, config_index: int, static_key: str | None = None,
    device=None,
):
    """Load a completed config's retained final model (the artifact
    ``save_config_final`` wrote). Raises ``CheckpointError`` when the
    artifact is missing and ``ResumeMismatchError`` when it was written
    under a different training static key."""
    from photon_tpu_torch.io.model_io import load_checkpoint_meta
    from photon_tpu_torch.resilience.errors import CheckpointError

    path = os.path.join(directory, _final_name(config_index))
    if not os.path.exists(path):
        raise CheckpointError(
            f"resume needs {path} to rebuild completed config "
            f"{config_index}'s result, but it is missing — the "
            "checkpoint directory was pruned or predates config-final "
            "retention; retrain from scratch")
    model, meta = load_checkpoint_meta(path, device)
    _check_static_key(path, meta, static_key)
    return model


def _check_static_key(
    path: str, meta: dict | None, static_key: str | None
) -> None:
    """Raise ``ResumeMismatchError`` when an artifact's recorded
    training static key differs from this run's (either side None =
    nothing to compare)."""
    from photon_tpu_torch.resilience.errors import ResumeMismatchError

    written_key = (meta or {}).get("static_key")
    if static_key is not None and written_key is not None \
            and written_key != static_key:
        raise ResumeMismatchError(
            f"{path} was written under training static key "
            f"{written_key[:12]}..., this run computes "
            f"{static_key[:12]}... — the configuration changed")
