"""Shared CLI plumbing (port of ``photon_tpu/cli/common.py``): logging
set-up, and the multi-process hooks.

Every process of a run executes the same program on the same data, as
every host does in the reference. ``maybe_init_distributed`` starts the
``torch.distributed`` group under a launcher (``parallel.mesh.
init_from_env``: ``torchrun`` or the variables it exports) and marks
the init half of the fleet clock handshake; ``fetch_global`` brings a
tensor (the port's gathered scores are whole on every rank) to numpy;
``is_coordinator`` is rank 0, the one process that writes artifacts.
``distributed_session`` tears the group down when the CLI returns or
raises, so a rank that fails ends its peers' collectives instead of
leaving them waiting.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch


def maybe_init_distributed(device=None) -> bool:
    """Start the process group when a launcher exported a
    ``WORLD_SIZE`` above 1 (this rank on ``device``: ``cuda`` is
    ``cuda:{LOCAL_RANK mod device_count}``); returns True when this call
    started it. Marks the init half of the fleet clock-alignment
    handshake (``obs.fleet.mark_init``) on every call, so a bundle
    committed later bounds how far this host's clock mapping drifted
    over the run."""
    import torch.distributed as dist

    from photon_tpu_torch.obs import fleet
    from photon_tpu_torch.parallel import mesh as mesh_mod

    started = False
    if not dist.is_initialized():
        started = mesh_mod.init_from_env(device) is not None
    fleet.mark_init()
    if started:
        logging.getLogger("photon.cli").info(
            "process group up: rank %d/%d, backend %s", dist.get_rank(),
            dist.get_world_size(), dist.get_backend())
    return started


@contextlib.contextmanager
def distributed_session(device=None):
    """``maybe_init_distributed`` for one CLI run. Yields a dict whose
    ``"clean"`` the run sets False for a non-zero exit code. The group
    this call started is torn down on the way out: after a barrier when
    the run ended cleanly, at once when it raised or failed (the other
    ranks' collectives then fail instead of waiting)."""
    from photon_tpu_torch.parallel import mesh as mesh_mod

    started = maybe_init_distributed(device)
    session = {"clean": True}
    try:
        yield session
    except BaseException:
        session["clean"] = False
        raise
    finally:
        if started:
            if session["clean"]:
                import torch.distributed as dist

                dist.barrier()
            mesh_mod.shutdown()


def fetch_global(x) -> np.ndarray:
    """The whole array on this host, as numpy (the port's mesh scores
    are gathered whole on every rank)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def is_coordinator() -> bool:
    """True on the process that writes the artifacts: rank 0 of the
    process group, or the single process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


@contextlib.contextmanager
def cli_logging(verbose: bool, log_file: str | None,
                fmt: str = "%(asctime)s %(name)s %(levelname)s %(message)s"):
    """Console logging at WARNING (INFO with ``verbose``) plus an
    optional INFO-level file sink (the PhotonLogger equivalent,
    util/PhotonLogger.scala:34). The handlers are detached and closed on
    exit, so repeated ``main()`` calls in one process leak nothing."""
    root = logging.getLogger()
    console = logging.StreamHandler()
    console.setLevel(logging.INFO if verbose else logging.WARNING)
    console.setFormatter(logging.Formatter(fmt))
    handlers = [console]
    if log_file:
        sink = logging.FileHandler(log_file)
        sink.setLevel(logging.INFO)
        sink.setFormatter(logging.Formatter(fmt))
        handlers.append(sink)
    prev_level = root.level
    root.setLevel(
        logging.INFO if (verbose or log_file) else logging.WARNING)
    for h in handlers:
        root.addHandler(h)
    try:
        yield
    finally:
        for h in handlers:
            root.removeHandler(h)
            h.close()
        root.setLevel(prev_level)
