"""GameModel save and load (port of ``photon_tpu/io/model_io.py``).

Two forms:

- The reference's Avro model directory (ModelProcessingUtils.scala:77-240),
  which ``save_game_model`` writes and ``load_game_model`` reads::

    <dir>/model-metadata.json
    <dir>/fixed-effect/<name>/id-info                  (one line: shard id)
    <dir>/fixed-effect/<name>/coefficients/part-00000.avro
    <dir>/random-effect/<name>/id-info                 (REType, shard id)
    <dir>/random-effect/<name>/coefficients/part-00000.avro

  one BayesianLinearModelAvro record per GLM (per entity for a random
  effect), means and variances as NameTermValueAvro lists keyed by the
  feature index map, with the reference JVM's model and loss class
  names; zero means are dropped on save. The files are byte for byte
  the JAX package's but for each container's random sync marker.
- The native checkpoint: one ``.npz`` file, per fixed coordinate
  ``<name>/means`` (and ``<name>/variances``), per random coordinate
  ``<name>/coefficients``, ``<name>/proj_all`` (and
  ``<name>/variances``), plus a ``__manifest__`` entry holding the JSON
  manifest as uint8 bytes, in the JAX package's layout, so a checkpoint
  written by either package loads in the other. ``game_model_to_numpy``
  and ``game_model_from_numpy`` carry weights across: the arrays and
  manifest as the checkpoint keys them, and back.

Loaders put tensors on ``device`` (default ``cuda``).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile

import numpy as np
import torch

from photon_tpu_torch import device as device_mod
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.io import avro
from photon_tpu_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    random_effect_model_to_glms,
)
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.resilience import faults
from photon_tpu_torch.resilience.errors import CorruptModelError
from photon_tpu_torch.types import (
    TaskType,
    make_feature_key,
    split_feature_key,
)

ID_INFO = "id-info"
METADATA_FILE = "model-metadata.json"
FIXED_EFFECT = "fixed-effect"
RANDOM_EFFECT = "random-effect"
COEFFICIENTS = "coefficients"
DEFAULT_AVRO_FILE = "part-00000.avro"

# Reference JVM class names (the loader dispatches on them,
# ModelProcessingUtils.scala:371-391).
_MODEL_CLASS = {
    TaskType.LOGISTIC_REGRESSION:
        "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel",
    TaskType.LINEAR_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel",
    TaskType.POISSON_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.PoissonRegressionModel",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        "com.linkedin.photon.ml.supervised.classification.SmoothedHingeLossLinearSVMModel",
}
_CLASS_TO_TASK = {v: k for k, v in _MODEL_CLASS.items()}
_LOSS_CLASS = {
    TaskType.LOGISTIC_REGRESSION:
        "com.linkedin.photon.ml.function.LogisticLossFunction",
    TaskType.LINEAR_REGRESSION:
        "com.linkedin.photon.ml.function.SquaredLossFunction",
    TaskType.POISSON_REGRESSION:
        "com.linkedin.photon.ml.function.PoissonLossFunction",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        "com.linkedin.photon.ml.function.SmoothedHingeLossFunction",
}

NAME_TERM_VALUE_SCHEMA = {
    "name": "NameTermValueAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "type": "record",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string"},
        {"name": "value", "type": "double"},
    ],
}
BAYESIAN_LINEAR_MODEL_SCHEMA = {
    "name": "BayesianLinearModelAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "type": "record",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "means",
         "type": {"items": NAME_TERM_VALUE_SCHEMA, "type": "array"}},
        {"name": "variances", "default": None,
         "type": ["null", {"items": "NameTermValueAvro", "type": "array"}]},
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}
SCORING_RESULT_SCHEMA = {
    "name": "ScoringResultAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": ["null", "double"], "default": None},
        {"name": "modelId", "type": "string"},
        {"name": "predictionScore", "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "metadataMap", "default": None,
         "type": ["null", {"type": "map", "values": "string"}]},
    ],
}


def _resolve_index(index_map: IndexMap, name: str, term: str) -> int | None:
    """Inverse of the save side's ``split_feature_key``: a key without a
    delimiter saves as (name, term=""), so an empty term also tries the
    bare name (identity index maps "0", "1", ... would otherwise drop
    every feature on load)."""
    idx = index_map.get_index(make_feature_key(name, term))
    if idx is None and term == "":
        idx = index_map.get_index(name)
    return idx


def _ntv_list(values: np.ndarray, indices, index_map: IndexMap,
              sparsity_threshold: float) -> list[dict]:
    out = []
    for idx, v in zip(indices, values):
        if abs(float(v)) <= sparsity_threshold:
            continue
        key = index_map.get_feature_name(int(idx))
        if key is None:
            raise KeyError(f"feature index {idx} not in index map")
        name, term = split_feature_key(key)
        out.append({"name": name, "term": term, "value": float(v)})
    return out


def _glm_to_record(model_id: str, task: TaskType, means: np.ndarray,
                   variances: np.ndarray | None, indices: np.ndarray,
                   index_map: IndexMap, sparsity_threshold: float) -> dict:
    rec = {
        "modelId": model_id,
        "modelClass": _MODEL_CLASS[task],
        "means": _ntv_list(means, indices, index_map, sparsity_threshold),
        "variances": None,
        "lossFunction": _LOSS_CLASS[task],
    }
    if variances is not None:
        # Variances keep the full support (threshold -1), including
        # coefficients whose mean is exactly zero (L1 solutions).
        rec["variances"] = _ntv_list(variances, indices, index_map, -1.0)
    return rec


def _record_to_coefficients(rec: dict, index_map: IndexMap, dim: int,
                            dtype: torch.dtype, dev: torch.device):
    means = np.zeros(dim)
    for ntv in rec["means"]:
        idx = _resolve_index(index_map, ntv["name"], ntv["term"])
        if idx is not None:
            means[idx] = ntv["value"]
    variances = None
    if rec.get("variances"):
        variances = np.zeros(dim)
        for ntv in rec["variances"]:
            idx = _resolve_index(index_map, ntv["name"], ntv["term"])
            if idx is not None:
                variances[idx] = ntv["value"]
    task = _CLASS_TO_TASK.get(rec.get("modelClass") or "")

    def put(a):
        return None if a is None else torch.from_numpy(a).to(dev, dtype)

    return Coefficients(means=put(means), variances=put(variances)), task


def save_game_model(
    model: GameModel,
    output_dir: str,
    index_maps: dict[str, IndexMap],
    *,
    task: TaskType | None = None,
    optimization_configurations: dict | None = None,
    sparsity_threshold: float = 0.0,
) -> None:
    """Write ``model`` as an Avro model directory
    (saveGameModelToHDFS, ModelProcessingUtils.scala:77-130)."""
    os.makedirs(output_dir, exist_ok=True)
    task = task if task is not None else model.task
    with open(os.path.join(output_dir, METADATA_FILE), "w") as f:
        json.dump({
            "modelType": task.value,
            "optimizationConfigurations":
                optimization_configurations or {},
        }, f, indent=2)

    for name, sub in model.items():
        if isinstance(sub, FixedEffectModel):
            base = os.path.join(output_dir, FIXED_EFFECT, name)
            os.makedirs(os.path.join(base, COEFFICIENTS), exist_ok=True)
            with open(os.path.join(base, ID_INFO), "w") as f:
                f.write(sub.feature_shard_id + "\n")
            coefs = sub.model.coefficients
            means = _to_numpy(coefs.means)
            rec = _glm_to_record(
                name, sub.model.task, means,
                None if coefs.variances is None
                else _to_numpy(coefs.variances),
                np.arange(means.shape[0]),
                index_maps[sub.feature_shard_id], sparsity_threshold,
            )
            avro.write_container(
                os.path.join(base, COEFFICIENTS, DEFAULT_AVRO_FILE),
                BAYESIAN_LINEAR_MODEL_SCHEMA, [rec],
            )
        elif isinstance(sub, RandomEffectModel):
            base = os.path.join(output_dir, RANDOM_EFFECT, name)
            os.makedirs(os.path.join(base, COEFFICIENTS), exist_ok=True)
            with open(os.path.join(base, ID_INFO), "w") as f:
                f.write(sub.random_effect_type + "\n")
                f.write(sub.feature_shard_id + "\n")
            imap = index_maps[sub.feature_shard_id]
            records = [
                _glm_to_record(entity_id, sub.task, coefs.means,
                               coefs.variances, coefs.feature_indices, imap,
                               sparsity_threshold)
                for entity_id, coefs in
                random_effect_model_to_glms(sub).items()
            ]
            avro.write_container(
                os.path.join(base, COEFFICIENTS, DEFAULT_AVRO_FILE),
                BAYESIAN_LINEAR_MODEL_SCHEMA, records,
            )
        else:
            raise TypeError(f"unknown sub-model type for {name!r}")


def model_feature_shard_ids(model_dir: str) -> set[str]:
    """The feature shard ids a saved model directory references: the
    last line of each sub-model's ``id-info`` (fixed effects write one
    line, random effects two)."""
    shards: set[str] = set()
    for kind in (FIXED_EFFECT, RANDOM_EFFECT):
        base = os.path.join(model_dir, kind)
        if not os.path.isdir(base):
            continue
        for name in os.listdir(base):
            with open(os.path.join(base, name, ID_INFO)) as f:
                shards.add(f.read().strip().splitlines()[-1])
    return shards


def _read_coefficients_dir(coef_dir: str, what: str) -> list:
    """Avro coefficient read; every decode failure becomes a
    ``CorruptModelError`` naming the directory and the cause."""
    try:
        return avro.read_container_dir(coef_dir)
    except (ValueError, EOFError, KeyError) as exc:
        raise CorruptModelError(
            f"{what} coefficients under {coef_dir}: Avro decode failed "
            f"({type(exc).__name__}: {exc}): the file is truncated or "
            "not a BayesianLinearModelAvro container"
        ) from exc


def load_game_model(
    input_dir: str,
    index_maps: dict[str, IndexMap],
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> tuple[GameModel, dict]:
    """Read an Avro model directory (loadGameModelFromHDFS,
    ModelProcessingUtils.scala:143-240): (model, metadata), coefficients
    in ``dtype`` on ``device`` (default ``cuda``). Random effects are
    laid out as the padded [E, S] matrix, each entity's projector row
    its saved support in ascending feature order; features the index
    maps lack are dropped."""
    dev = device_mod.resolve(device)
    meta_path = os.path.join(input_dir, METADATA_FILE)
    try:
        with open(meta_path) as f:
            metadata = json.load(f)
    except json.JSONDecodeError as exc:
        raise CorruptModelError(
            f"model metadata {meta_path}: not valid JSON ({exc})"
        ) from exc
    task = TaskType(metadata["modelType"])
    models: dict[str, object] = {}

    fe_dir = os.path.join(input_dir, FIXED_EFFECT)
    if os.path.isdir(fe_dir):
        for name in sorted(os.listdir(fe_dir)):
            base = os.path.join(fe_dir, name)
            with open(os.path.join(base, ID_INFO)) as f:
                shard = f.read().strip().splitlines()[0]
            imap = index_maps[shard]
            records = _read_coefficients_dir(
                os.path.join(base, COEFFICIENTS),
                f"fixed-effect model {name!r}",
            )
            if len(records) != 1:
                raise ValueError(
                    f"fixed-effect model {name!r}: expected 1 record, "
                    f"got {len(records)}"
                )
            coefs, rec_task = _record_to_coefficients(
                records[0], imap, len(imap), dtype, dev)
            models[name] = FixedEffectModel(
                GeneralizedLinearModel(coefs, rec_task or task), shard
            )

    re_dir = os.path.join(input_dir, RANDOM_EFFECT)
    if os.path.isdir(re_dir):
        for name in sorted(os.listdir(re_dir)):
            base = os.path.join(re_dir, name)
            with open(os.path.join(base, ID_INFO)) as f:
                lines = f.read().strip().splitlines()
            re_type, shard = lines[0], lines[1]
            coef_dir = os.path.join(base, COEFFICIENTS)
            # A partial-retrain layout ships id-info with no coefficients:
            # an empty model set, which needs no index map for its shard.
            records = (
                _read_coefficients_dir(
                    coef_dir, f"random-effect model {name!r}")
                if os.path.isdir(coef_dir) else []
            )
            imap = index_maps[shard] if records else None
            entity_ids, supports, means_list, var_list = [], [], [], []
            any_var = False
            for rec in records:
                entity_ids.append(rec["modelId"])
                mmap: dict[int, float] = {}
                for ntv in rec["means"]:
                    idx = _resolve_index(imap, ntv["name"], ntv["term"])
                    if idx is not None:
                        mmap[idx] = ntv["value"]
                vmap: dict[int, float] = {}
                if rec.get("variances"):
                    for ntv in rec["variances"]:
                        idx = _resolve_index(imap, ntv["name"], ntv["term"])
                        if idx is not None:
                            vmap[idx] = ntv["value"]
                    any_var = True
                # Support: the union of means and variances (L1 solutions
                # carry exact-zero means whose variances must survive).
                idxs = np.asarray(sorted(set(mmap) | set(vmap)),
                                  dtype=np.int64)
                supports.append(idxs)
                means_list.append(
                    np.array([mmap.get(int(i), 0.0) for i in idxs]))
                var_list.append(
                    np.array([vmap.get(int(i), 0.0) for i in idxs])
                    if vmap else None)
            e_cnt = len(records)
            s_max = max(max((s.size for s in supports), default=1), 1)
            w = np.zeros((e_cnt, s_max))
            v = np.zeros((e_cnt, s_max)) if any_var else None
            proj = np.full((e_cnt, s_max), -1, dtype=np.int64)
            for e in range(e_cnt):
                k = supports[e].size
                proj[e, :k] = supports[e]
                w[e, :k] = means_list[e]
                if v is not None and var_list[e] is not None:
                    v[e, :k] = var_list[e]
            rec_task = _CLASS_TO_TASK.get(
                (records[0].get("modelClass") or "") if records else "")
            models[name] = RandomEffectModel(
                coefficients=torch.from_numpy(w).to(dev, dtype),
                random_effect_type=re_type,
                feature_shard_id=shard,
                task=rec_task or task,
                proj_all=proj,
                variances=(None if v is None
                           else torch.from_numpy(v).to(dev, dtype)),
                entity_keys=tuple(entity_ids),
            )

    if not models:
        raise ValueError(f"no models found under {input_dir}")
    return GameModel(models), metadata


def save_scores(
    path: str,
    scores: np.ndarray,
    *,
    model_id: str = "",
    uids: np.ndarray | None = None,
    labels: np.ndarray | None = None,
    weights: np.ndarray | None = None,
) -> None:
    """ScoringResultAvro writer (ScoreProcessingUtils.scala:88)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    scores = np.asarray(scores)

    def rec(i):
        return {
            "uid": None if uids is None else str(uids[i]),
            "label": None if labels is None else float(labels[i]),
            "modelId": model_id,
            "predictionScore": float(scores[i]),
            "weight": None if weights is None else float(weights[i]),
            "metadataMap": None,
        }

    avro.write_container(
        path, SCORING_RESULT_SCHEMA, (rec(i) for i in range(scores.shape[0]))
    )


FEATURE_SUMMARIZATION_SCHEMA = {
    "name": "FeatureSummarizationResultAvro",
    "namespace": "com.linkedin.photon.avro.generated",
    "type": "record",
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": "string"},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}


def save_feature_stats(path: str, stats, index_map: IndexMap) -> None:
    """The per-feature summary artifact: one record per feature but the
    intercept, its metrics map holding max/min/mean/normL1/normL2/
    numNonzeros/variance (ModelProcessingUtils.writeBasicStatistics,
    ModelProcessingUtils.scala:514-560), as ``<path>/part-00000.avro``."""
    os.makedirs(path, exist_ok=True)
    zeros = np.zeros(stats.dim)
    l1 = zeros if stats.norm_l1 is None else stats.norm_l1
    l2 = zeros if stats.norm_l2 is None else stats.norm_l2

    def records():
        for idx in range(stats.dim):
            if idx == stats.intercept_index:
                continue
            key = index_map.get_feature_name(idx)
            if key is None:
                continue
            name, term = split_feature_key(key)
            yield {
                "featureName": name,
                "featureTerm": term,
                "metrics": {
                    "max": float(stats.max[idx]),
                    "min": float(stats.min[idx]),
                    "mean": float(stats.mean[idx]),
                    "normL1": float(l1[idx]),
                    "normL2": float(l2[idx]),
                    "numNonzeros": float(stats.num_nonzeros[idx]),
                    "variance": float(stats.variance[idx]),
                },
            }

    avro.write_container(os.path.join(path, "part-00000.avro"),
                         FEATURE_SUMMARIZATION_SCHEMA, records())


def load_feature_stats(path: str) -> dict[str, dict[str, float]]:
    """A stats artifact read back: feature key -> metrics map."""
    return {
        make_feature_key(rec["featureName"], rec["featureTerm"]): {
            k: float(v) for k, v in rec["metrics"].items()}
        for rec in avro.read_container_dir(path)
    }


def artifact_digest(path: str) -> str:
    """sha256 identity of a model artifact: a checkpoint's content
    hash, or for an Avro model directory the hash of every file's
    relative name and content in sorted order."""
    h = hashlib.sha256()
    if os.path.isfile(path):
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        return h.hexdigest()
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            full = os.path.join(root, name)
            h.update(os.path.relpath(full, path).encode())
            with open(full, "rb") as f:
                for block in iter(lambda: f.read(1 << 20), b""):
                    h.update(block)
    return h.hexdigest()


def load_initial_model(
    path: str, index_maps: dict[str, IndexMap] | None = None, *,
    device=None, dtype: torch.dtype = torch.float32,
) -> tuple[GameModel, str]:
    """A warm-start model from either artifact form, and its
    ``artifact_digest``: a native ``.npz`` checkpoint, or an Avro model
    directory (which needs ``index_maps``)."""
    if os.path.isfile(path) or path.endswith(".npz"):
        return (load_checkpoint(path, device),
                artifact_digest(_ckpt_path(path)))
    if os.path.isfile(os.path.join(path, METADATA_FILE)):
        if index_maps is None:
            raise ValueError(
                f"init model {path} is an Avro model directory; loading "
                "it needs the feature index maps (name+term keyed "
                "records): pass index_maps, or point at a native .npz "
                "checkpoint instead")
        model, _ = load_game_model(path, index_maps, device=device,
                                   dtype=dtype)
        return model, artifact_digest(path)
    raise FileNotFoundError(
        f"init model {path}: neither a checkpoint npz nor an Avro "
        f"model directory (no {METADATA_FILE})")


MANIFEST_KEY = "__manifest__"
_META_KEY = "__meta__"


def _ckpt_path(path: str) -> str:
    """np.savez appends .npz; normalize so save and load agree."""
    return path if path.endswith(".npz") else path + ".npz"


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()
    return np.asarray(t)


def fsync_dir(path: str) -> None:
    """Make a rename durable: fsync the directory that holds it."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data, *,
                       fault_point: str | None = None) -> None:
    """Write to an fsynced temp sibling, rename it over ``path`` and
    fsync the directory: a crash leaves the old file or the new one,
    never a torn write. ``fault_point`` names the injection point fired
    between the write and the rename (the mid-write crash window)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if fault_point is not None:
            faults.check(fault_point)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    fsync_dir(os.path.dirname(path) or ".")


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


def checkpoint_bytes(model: GameModel, extra_meta: dict | None = None
                     ) -> memoryview:
    """The ``.npz`` bytes of ``model``'s checkpoint; ``extra_meta``
    rides in the manifest under a reserved key."""
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
    return buf.getbuffer()


def save_checkpoint(
    model: GameModel, path: str, *, extra_meta: dict | None = None,
    fault_point: str | None = "checkpoint.write",
) -> str:
    """Write ``model`` as one ``.npz`` checkpoint, atomically; returns
    the path."""
    path = _ckpt_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    atomic_write_bytes(path, checkpoint_bytes(model, extra_meta),
                       fault_point=fault_point)
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
