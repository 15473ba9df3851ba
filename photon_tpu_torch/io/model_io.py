"""Native GameModel checkpoints (port of
``photon_tpu/io/model_io.py:583-770``).

One ``.npz`` file: per fixed coordinate ``<name>/means`` (and
``<name>/variances``), per random coordinate ``<name>/coefficients``,
``<name>/proj_all`` (and ``<name>/variances``), plus a ``__manifest__``
entry holding the JSON manifest as uint8 bytes. The format is the JAX
package's own, byte for byte in layout, so a checkpoint written by
either package loads in the other. ``game_model_to_numpy`` and
``game_model_from_numpy`` are the bridge that carries weights across:
the arrays and manifest as the checkpoint keys them, and back.
"""

from __future__ import annotations

import io
import json
import os
import zipfile

import numpy as np
import torch

from photon_tpu_torch import device as device_mod
from photon_tpu_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.types import TaskType

MANIFEST_KEY = "__manifest__"
_META_KEY = "__meta__"


class CorruptModelError(ValueError):
    """A model artifact exists but cannot be decoded (truncated or torn
    file, or not a checkpoint at all)."""


def _ckpt_path(path: str) -> str:
    """np.savez appends .npz; normalize so save and load agree."""
    return path if path.endswith(".npz") else path + ".npz"


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _atomic_write(path: str, data) -> None:
    """Write to an fsynced temp sibling, then rename over ``path``: a
    crash leaves the old file or the new one, never a torn write."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def game_model_to_numpy(model: GameModel) -> tuple[dict, dict]:
    """(arrays, manifest) of ``model``, keyed as the checkpoint keys them;
    ``game_model_from_numpy`` inverts it. This is the bridge that carries
    a trained model between the two packages."""
    arrays: dict[str, np.ndarray] = {}
    manifest: dict[str, dict] = {}
    for name, sub in model.items():
        if isinstance(sub, FixedEffectModel):
            coefs = sub.model.coefficients
            arrays[f"{name}/means"] = _to_numpy(coefs.means)
            if coefs.variances is not None:
                arrays[f"{name}/variances"] = _to_numpy(coefs.variances)
            manifest[name] = {
                "kind": "fixed",
                "shard": sub.feature_shard_id,
                "task": sub.task.value,
            }
        elif isinstance(sub, RandomEffectModel):
            arrays[f"{name}/coefficients"] = _to_numpy(sub.coefficients)
            arrays[f"{name}/proj_all"] = np.asarray(sub.proj_all)
            if sub.variances is not None:
                arrays[f"{name}/variances"] = _to_numpy(sub.variances)
            manifest[name] = {
                "kind": "random",
                "re_type": sub.random_effect_type,
                "shard": sub.feature_shard_id,
                "task": sub.task.value,
                "entity_keys": [str(k) for k in sub.entity_keys],
            }
        else:
            raise TypeError(f"unknown sub-model type for {name!r}")
    return arrays, manifest


def save_checkpoint(
    model: GameModel, path: str, *, extra_meta: dict | None = None
) -> str:
    """Write ``model`` as one ``.npz`` checkpoint; returns the path."""
    path = _ckpt_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, manifest = game_model_to_numpy(model)
    if _META_KEY in manifest:
        raise ValueError(
            f"model coordinate name {_META_KEY!r} collides with the "
            "checkpoint metadata key")
    if extra_meta is not None:
        manifest[_META_KEY] = dict(extra_meta)
    arrays[MANIFEST_KEY] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    _atomic_write(path, buf.getbuffer())
    return path


def game_model_from_numpy(
    arrays: dict[str, np.ndarray], manifest: dict, device=None
) -> GameModel:
    """The port's ``GameModel`` from numpy parameters keyed as the
    checkpoint keys them (``<name>/means``, ``<name>/coefficients``,
    ``<name>/proj_all``, ``<name>/variances``) and the checkpoint's
    manifest (without its ``__meta__`` entry). Tensors land on
    ``device`` (default ``cuda``)."""
    dev = device_mod.resolve(device)

    def tensor(key: str) -> torch.Tensor:
        arr = np.asarray(arrays[key])
        if arr.dtype.kind != "f":
            raise ValueError(f"{key}: expected float coefficients, got "
                             f"{arr.dtype}")
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    def optional(key: str) -> torch.Tensor | None:
        return tensor(key) if key in arrays else None

    models: dict[str, object] = {}
    for name, info in manifest.items():
        task = TaskType(info["task"])
        if info["kind"] == "fixed":
            coefs = Coefficients(
                means=tensor(f"{name}/means"),
                variances=optional(f"{name}/variances"),
            )
            models[name] = FixedEffectModel(
                GeneralizedLinearModel(coefs, task), info["shard"]
            )
        elif info["kind"] == "random":
            models[name] = RandomEffectModel(
                coefficients=tensor(f"{name}/coefficients"),
                random_effect_type=info["re_type"],
                feature_shard_id=info["shard"],
                task=task,
                proj_all=np.asarray(arrays[f"{name}/proj_all"]),
                variances=optional(f"{name}/variances"),
                entity_keys=tuple(info["entity_keys"]),
            )
        else:
            raise ValueError(
                f"coordinate {name!r}: unknown kind {info['kind']!r}")
    return GameModel(models)


def load_checkpoint(path: str, device=None) -> GameModel:
    """Load a native checkpoint onto ``device`` (default ``cuda``)."""
    return load_checkpoint_meta(path, device)[0]


def load_checkpoint_meta(
    path: str, device=None
) -> tuple[GameModel, dict | None]:
    """Load a native checkpoint plus its ``extra_meta`` (None when the
    file has none). A truncated or foreign file raises
    ``CorruptModelError``; filesystem errors propagate as they are."""
    path = _ckpt_path(path)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    dev = device_mod.resolve(device)
    try:
        with np.load(path) as z:
            manifest = json.loads(bytes(z[MANIFEST_KEY]).decode())
            meta = manifest.pop(_META_KEY, None)
            arrays = {k: z[k] for k in z.files if k != MANIFEST_KEY}
        return game_model_from_numpy(arrays, manifest, dev), meta
    except (zipfile.BadZipFile, ValueError, KeyError, EOFError) as exc:
        raise CorruptModelError(
            f"checkpoint {path}: failed to decode "
            f"({type(exc).__name__}: {exc}): the npz is truncated or not "
            "a photon checkpoint"
        ) from exc
