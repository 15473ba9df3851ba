"""Shared CLI plumbing (port of ``photon_tpu/cli/common.py``): logging
set-up, and the single-process answers of the multi-host hooks.

The port runs on one device in one process: ``maybe_init_distributed``
starts nothing (it marks the init half of the fleet clock handshake),
``fetch_global`` returns its argument as numpy, and this process is the
coordinator. ``resolve_mesh`` accepts only the mesh settings that mean
one device.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from photon_tpu_torch.device import MESH_NOT_PORTED


def maybe_init_distributed() -> bool:
    """No multi-host runtime to start; returns False. Marks the init
    half of the fleet clock-alignment handshake (``obs.fleet.mark_init``)
    on every call, so a bundle committed later bounds how far this
    host's clock mapping drifted over the run."""
    from photon_tpu_torch.obs import fleet

    fleet.mark_init()
    return False


def fetch_global(x) -> np.ndarray:
    """The whole array on this host, as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def is_coordinator() -> bool:
    """True: the single process writes the artifacts."""
    return True


def resolve_mesh(spec: str | None) -> None:
    """``--mesh``: ``auto`` resolves to no mesh on one card, as do
    ``off`` and ``1``; anything else asks for multi-device scoring and
    raises."""
    if spec is None or str(spec).strip().lower() in ("auto", "off", "1"):
        return None
    raise NotImplementedError(f"--mesh {spec}: {MESH_NOT_PORTED}")


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
