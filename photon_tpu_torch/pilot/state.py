"""The pilot's durable state machine (port of ``photon_tpu/pilot/state.py``).

The one authority on where a cycle stands is ``pilot-state.json``, and
it changes only through the atomic write every other durable artifact
uses (``io/model_io.atomic_write_bytes``: temp file, fsync, rename). A
killed pilot restarted against the same work dir reads the committed
stage and resumes there: mid-TRAIN through the training checkpointer,
mid-PROMOTE by promoting the staged generation again, mid-OBSERVE by
re-opening the observation window.

Stage graph (one cycle)::

    IDLE -> INGEST -> TRAIN -> VALIDATE -> PROMOTE -> OBSERVE -> IDLE
                                  |                      |
                                  v (gate refusal)       v (SLO burn)
                                IDLE                 ROLLBACK -> IDLE

ROLLBACK is not a committed stage: it runs inside OBSERVE's transition
back to IDLE, under the ``pilot.rollback`` fault point, so a crash
mid-rollback resumes at OBSERVE and decides again.

The file's bytes are the JAX package's (the same fields, ``indent=2``,
sorted keys, ``SCHEMA_VERSION`` 1), so either package resumes the
other's work dir.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

SCHEMA_VERSION = 1
STATE_FILE = "pilot-state.json"

# Committed stages, in cycle order. The index is the
# ``pilot_cycle_stage`` gauge's value.
STAGES = ("IDLE", "INGEST", "TRAIN", "VALIDATE", "PROMOTE", "OBSERVE")

MODE_ACTIVE = "active"
MODE_SERVE_ONLY = "serve-only"


@dataclasses.dataclass
class PilotState:
    """Everything a restarted pilot needs to continue mid-cycle."""

    stage: str = "IDLE"
    cycle: int = 0
    mode: str = MODE_ACTIVE
    # ``processed_shards``: already trained into a promoted (or refused)
    # generation; ``cycle_shards``: the cycle's frozen snapshot
    # (processed + new, in manifest order); ``new_shards``: the delta
    # that triggered it.
    processed_shards: list = dataclasses.field(default_factory=list)
    cycle_shards: list = dataclasses.field(default_factory=list)
    new_shards: list = dataclasses.field(default_factory=list)
    # When the cycle's newest shard landed (its mtime): the zero point
    # of the staleness metric.
    landed_at: float | None = None
    consecutive_failures: int = 0
    deadline_overruns: int = 0
    failures: int = 0
    last_error: str | None = None
    # Control-loop totals, durable across restarts (the pilot_* gauges
    # read them).
    cycles_completed: int = 0
    promotions: int = 0
    rollbacks: int = 0
    refusals: int = 0
    last_refusal: dict | None = None
    last_promotion: dict | None = None
    last_rollback: dict | None = None
    # The last health-gate decision (obs/health.py): reasons and the
    # measured numbers; None until a health-armed cycle validates.
    last_health: dict | None = None
    staleness_seconds: float | None = None
    updated_at: float = 0.0
    schema_version: int = SCHEMA_VERSION

    def require_stage(self, *allowed: str) -> None:
        if self.stage not in allowed:
            raise ValueError(
                f"pilot state machine: stage {self.stage!r} is not one "
                f"of {allowed}")


def state_path(work_dir: str) -> str:
    return os.path.join(work_dir, STATE_FILE)


def commit_state(work_dir: str, state: PilotState) -> None:
    """Atomically commit ``state``, the transition primitive: a pilot
    killed at any instant leaves the previous committed stage or the
    new one, never a torn file."""
    from photon_tpu_torch.io.model_io import atomic_write_bytes

    os.makedirs(work_dir, exist_ok=True)
    state.updated_at = time.time()
    payload = dataclasses.asdict(state)
    atomic_write_bytes(
        state_path(work_dir),
        json.dumps(payload, indent=2, sort_keys=True).encode("utf-8"),
    )


def load_state(work_dir: str) -> PilotState | None:
    """The committed state, or None for a fresh work dir. A state file
    of another schema version raises."""
    path = state_path(work_dir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        raw = json.load(f)
    version = raw.pop("schema_version", None)
    if version != SCHEMA_VERSION:
        raise ValueError(
            f"pilot state {path}: schema_version {version!r} is not the "
            f"supported {SCHEMA_VERSION}")
    known = {f.name for f in dataclasses.fields(PilotState)}
    state = PilotState(**{k: v for k, v in raw.items() if k in known})
    state.require_stage(*STAGES)
    return state
