"""Host identity and run id: the provenance block of every obs artifact
(port of the first part of ``photon_tpu/obs/fleet.py``).

``host_identity()`` is stamped into the snapshot, the JSONL header, the
flight dump and the Chrome trace's ``otherData``, so no artifact is
anonymous. The process index and count come from the environment
(``RANK`` and ``WORLD_SIZE``, as ``torch.distributed`` launchers set
them; 0 and 1 on one card). The device kind and count come from
``torch.cuda``, read only once the process has initialized CUDA, so
stamping never creates a CUDA context as a side effect.

``resolve_monitor_port`` offsets a ``--monitor-port`` by the process
index. The rest of the JAX module (clock alignment, bundles, the fleet
merge and the straggler report) waits for ROADMAP Queue A item 10's
last part.

Threading: the cached identity and the run id are guarded by ``_lock``.
"""

from __future__ import annotations

import os
import socket
import sys
import threading

_lock = threading.Lock()
_identity: dict | None = None
_run_id: str | None = None


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw.isdigit() else default


def _probe_identity() -> dict:
    """The provenance block of this process; a CUDA query that fails
    leaves nulls, never a failed snapshot or dump."""
    ident: dict = {
        "process_index": _env_int("RANK", 0),
        "process_count": _env_int("WORLD_SIZE", 1),
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "device_kind": None,
        "local_device_count": None,
        "global_device_count": None,
        "torch_version": None,
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        ident["torch_version"] = getattr(torch, "__version__", None)
        try:
            if torch.cuda.is_initialized():
                n = torch.cuda.device_count()
                ident["local_device_count"] = n
                ident["global_device_count"] = n * ident["process_count"]
                if n:
                    ident["device_kind"] = torch.cuda.get_device_name(
                        torch.cuda.current_device())
        except Exception:  # noqa: BLE001 - a runtime mid-teardown
            pass
    return ident


def host_identity(*, refresh: bool = False) -> dict:
    """The host-identity block (cached; ``refresh=True`` probes again)."""
    global _identity
    with _lock:
        cached = _identity
    if cached is None or refresh or (
            cached["device_kind"] is None and _cuda_up()):
        probed = _probe_identity()
        with _lock:
            _identity = cached = probed
    out = dict(cached)
    out["run_id"] = run_id()
    return out


def resolve_monitor_port(port: int, process_index: int | None = None
                         ) -> int:
    """The per-process ``/metrics`` bind port: ``port + process_index``,
    so several processes sharing a host never collide on one
    ``--monitor-port`` value. Port 0 (ephemeral: the OS picks) passes
    through untouched."""
    if port <= 0:
        return port
    k = (host_identity()["process_index"] if process_index is None
         else int(process_index))
    return port + k


def _cuda_up() -> bool:
    torch = sys.modules.get("torch")
    try:
        return torch is not None and torch.cuda.is_initialized()
    except Exception:  # noqa: BLE001
        return False


def set_run_id(value: str | None) -> None:
    """Pin the run id every artifact of this run carries."""
    global _run_id
    with _lock:
        _run_id = value


def run_id() -> str | None:
    """An explicit ``set_run_id`` wins, else ``PHOTON_RUN_ID``, else
    None."""
    with _lock:
        rid = _run_id
    return rid if rid is not None else os.environ.get("PHOTON_RUN_ID")


def reset() -> None:
    """Drop the cached identity and run id (part of ``obs.reset()``)."""
    global _identity, _run_id
    with _lock:
        _identity = None
        _run_id = None
