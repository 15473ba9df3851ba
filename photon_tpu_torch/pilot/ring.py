"""Bounded on-disk ring of model generations (port of
``photon_tpu/pilot/ring.py``): promote forward, roll back.

Every promotion stages the candidate as ``gen-%06d.npz`` (the native
checkpoint format, written atomically with the ``pilot.promote`` fault
point in its mid-write window) and records it in ``ring.json``, first
as ``staged``, then as ``live`` once the serving reload committed. A
pilot killed between the two restarts with the server on the old
generation and the ring naming the candidate to finish promoting.

Rollback flips ``live`` back to the newest older generation and marks
the abandoned one ``rolled_back`` (kept on disk for the post-mortem
until retention prunes it). Retention keeps the newest ``keep``
generations plus whatever is live or staged.

``ring.json`` has the JAX package's fields and bytes, and the ``.npz``
files are the checkpoint format both packages read, so either package
continues the other's ring.
"""

from __future__ import annotations

import json
import os
import time

RING_FILE = "ring.json"
SCHEMA_VERSION = 1


class GenerationRing:
    """The pilot's model-generation store under ``<dir>/``."""

    def __init__(self, directory: str, *, keep: int = 3):
        if keep < 2:
            # One previous generation is the least a rollback needs.
            raise ValueError("keep must be >= 2 (live + at least one "
                             "rollback target)")
        self.directory = directory
        self.keep = int(keep)
        os.makedirs(directory, exist_ok=True)
        self._meta = self._load()

    # -- durable meta ------------------------------------------------------

    def _ring_path(self) -> str:
        return os.path.join(self.directory, RING_FILE)

    def _load(self) -> dict:
        path = self._ring_path()
        if not os.path.exists(path):
            return {
                "schema_version": SCHEMA_VERSION,
                "live": None,
                "staged": None,
                "entries": [],
            }
        with open(path) as f:
            meta = json.load(f)
        if meta.get("schema_version") != SCHEMA_VERSION:
            raise ValueError(
                f"generation ring {path}: schema_version "
                f"{meta.get('schema_version')!r} is not the supported "
                f"{SCHEMA_VERSION}")
        return meta

    def _commit(self) -> None:
        from photon_tpu_torch.io.model_io import atomic_write_bytes

        atomic_write_bytes(
            self._ring_path(),
            json.dumps(self._meta, indent=2, sort_keys=True).encode(),
        )

    # -- queries -----------------------------------------------------------

    @property
    def live(self) -> int | None:
        return self._meta["live"]

    @property
    def staged(self) -> int | None:
        return self._meta["staged"]

    def entries(self) -> list[dict]:
        return [dict(e) for e in self._meta["entries"]]

    def _entry(self, gen: int) -> dict:
        for e in self._meta["entries"]:
            if e["gen"] == gen:
                return e
        raise KeyError(f"generation {gen} is not in the ring")

    def path(self, gen: int) -> str:
        return os.path.join(self.directory, self._entry(gen)["file"])

    def live_path(self) -> str | None:
        return None if self.live is None else self.path(self.live)

    def load(self, gen: int, device=None):
        """One generation's ``GameModel`` on ``device`` (default
        ``cuda``), its file checked against the ring's sha256."""
        from photon_tpu_torch.io.model_io import (
            artifact_digest,
            load_checkpoint,
        )
        from photon_tpu_torch.resilience.errors import CorruptModelError

        entry = self._entry(gen)
        path = self.path(gen)
        digest = artifact_digest(path)
        if digest != entry["sha256"]:
            raise CorruptModelError(
                f"generation {gen} at {path}: sha256 {digest[:12]}... "
                f"does not match the ring's {entry['sha256'][:12]}... — "
                "the artifact is torn or was modified after commit")
        return load_checkpoint(path, device)

    def previous(self, gen: int) -> int | None:
        """The newest generation older than ``gen`` that was never
        rolled back: the rollback target."""
        candidates = [
            e["gen"] for e in self._meta["entries"]
            if e["gen"] < gen and not e.get("rolled_back")
        ]
        return max(candidates) if candidates else None

    # -- transitions -------------------------------------------------------

    def stage_candidate(self, model, *, cycle: int, metrics=None) -> int:
        """Write ``model`` as the next generation and record it STAGED
        (not yet serving). The write fires ``pilot.promote`` between the
        temp file and its rename."""
        from photon_tpu_torch.io.model_io import (
            artifact_digest,
            save_checkpoint,
        )

        gen = 1 + max(
            [e["gen"] for e in self._meta["entries"]], default=0
        )
        fname = f"gen-{gen:06d}.npz"
        path = save_checkpoint(
            model,
            os.path.join(self.directory, fname),
            extra_meta={
                "schema_version": SCHEMA_VERSION,
                "kind": "pilot_generation",
                "gen": gen,
                "cycle": int(cycle),
            },
            fault_point="pilot.promote",
        )
        self._meta["entries"].append({
            "gen": gen,
            "file": fname,
            "sha256": artifact_digest(path),
            "cycle": int(cycle),
            "created_at": time.time(),
            "metrics": dict(metrics or {}),
        })
        self._meta["staged"] = gen
        self._commit()
        return gen

    def commit_live(self, gen: int) -> None:
        """Flip ``gen`` live (its serving reload committed) and prune
        past the retention bound."""
        self._entry(gen)  # must exist
        self._meta["live"] = gen
        if self._meta["staged"] == gen:
            self._meta["staged"] = None
        dropped = self._prune()
        self._commit()
        self._remove_files(dropped)

    def mark_rolled_back(self, gen: int, *, to: int, reason: str) -> None:
        """Record a rollback: ``gen`` is abandoned (kept on disk until
        retention prunes it), ``to`` is live again."""
        entry = self._entry(gen)
        entry["rolled_back"] = True
        entry["rollback_reason"] = reason
        entry["rolled_back_at"] = time.time()
        self._entry(to)
        self._meta["live"] = to
        if self._meta["staged"] == gen:
            self._meta["staged"] = None
        dropped = self._prune()
        self._commit()
        self._remove_files(dropped)

    def _prune(self) -> list[dict]:
        """Retention: the newest ``keep`` generations plus live and
        staged. The dropped entries' files are deleted only after the
        meta commit: a crash between the two leaves an orphan file,
        never an entry pointing at nothing."""
        entries = sorted(self._meta["entries"], key=lambda e: e["gen"])
        protected = {self._meta["live"], self._meta["staged"]}
        kept, dropped = [], []
        overflow = len(entries) - self.keep
        for e in entries:
            if overflow > 0 and e["gen"] not in protected:
                dropped.append(e)
                overflow -= 1
            else:
                kept.append(e)
        self._meta["entries"] = kept
        return dropped

    def _remove_files(self, dropped: list[dict]) -> None:
        for e in dropped:
            try:
                os.remove(os.path.join(self.directory, e["file"]))
            except OSError:  # a concurrent cleanup
                pass
