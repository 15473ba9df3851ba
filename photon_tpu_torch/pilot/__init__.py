"""photon_tpu_torch.pilot: the always-on train → validate → promote →
rollback control loop (port of ``photon_tpu/pilot``).

A supervisor that watches a shard directory, stream-ingests new data,
retrains warm-started, gates the promotion on the evaluation suite
against the serving model, hot-reloads the live scorer, watches the
post-promotion SLO burn and rolls back from a bounded on-disk ring of
generations. Its state machine, stages, gate and rollback policy are
the JAX package's (PILOT.md); every stage runs on the GPU unless the
config asks for the CPU.

Run it: ``python -m photon_tpu_torch.cli.pilot --config pilot.yaml``.
"""

from __future__ import annotations

from photon_tpu_torch.obs.health import HealthGatePolicy
from photon_tpu_torch.pilot.loop import (
    ObservePolicy,
    Pilot,
    PilotConfig,
    PromotionGate,
)
from photon_tpu_torch.pilot.ring import GenerationRing
from photon_tpu_torch.pilot.serving import PilotServer
from photon_tpu_torch.pilot.state import (
    MODE_ACTIVE,
    MODE_SERVE_ONLY,
    STAGES,
    PilotState,
    load_state,
)

__all__ = [
    "GenerationRing",
    "HealthGatePolicy",
    "MODE_ACTIVE",
    "MODE_SERVE_ONLY",
    "ObservePolicy",
    "Pilot",
    "PilotConfig",
    "PilotServer",
    "PilotState",
    "PromotionGate",
    "STAGES",
    "load_state",
]
