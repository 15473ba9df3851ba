"""Device-resident coefficient tables for online scoring (port of
``photon_tpu/serve/tables.py``).

A ``GameModel`` becomes lookup tables: one [d] weight vector per fixed
coordinate and, per random coordinate, the padded [E, S] coefficient
matrix beside its [E, S] int32 projector on the device, plus a host map
entity key -> row. An entity missing from the map gets code -1 and
scores through the fixed effects only.

``reload`` with unchanged structure copies the new values into the live
tensors in place (the JAX package's donated swap writes the old
buffers' memory the same way): the score ladder's captured CUDA graphs
hold these tensors' device pointers, so a rebound tensor would go on
being served from the old one with no error. A structure change
rebuilds the tables and returns False, and the caller builds new
``ScorePrograms``; ``rebuild_from`` does the whole swap, with the new
ladder built before a ``quiesce`` window. ``build_index_maps_from_model``
gives a standalone server the feature index maps of an Avro model
directory.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from photon_tpu_torch import device as device_mod
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_tpu_torch.ops import precision as precision_mod
from photon_tpu_torch.types import TaskType, make_feature_key


@dataclasses.dataclass
class FixedTable:
    """One fixed-effect coordinate: the dense [d] weight vector."""

    name: str
    feature_shard_id: str
    task: TaskType
    weights: torch.Tensor  # [d]

    @property
    def num_features(self) -> int:
        return int(self.weights.shape[0])


@dataclasses.dataclass
class RandomTable:
    """One random-effect coordinate: padded per-entity coefficients."""

    name: str
    random_effect_type: str
    feature_shard_id: str
    task: TaskType
    weights: torch.Tensor  # [E, S]
    proj: torch.Tensor  # [E, S] int32, -1 pad
    entity_keys: tuple  # row i <-> entity_keys[i]
    entity_rows: dict  # str key -> row index
    # Widest feature id the projector names + 1, taken on the host at
    # build: the model alone does not record the shard width.
    num_features: int = 1

    @property
    def num_entities(self) -> int:
        return int(self.weights.shape[0])

    def code_for(self, key) -> int:
        """Row index for an entity key; -1 = cold (fixed-effect-only)."""
        row = self.entity_rows.get(str(key))
        return -1 if row is None else row


@dataclasses.dataclass
class CoefficientTables:
    """Device-resident serving state for one GameModel."""

    fixed: dict[str, FixedTable]
    random: dict[str, RandomTable]
    task: TaskType
    device: torch.device
    # +1 per reload, in place or rebuilt.
    generation: int = 0
    precision: str = precision_mod.FLOAT32

    def coordinate_stats(self) -> dict:
        return {
            "generation": self.generation,
            "fixed": {
                n: {"features": t.num_features}
                for n, t in self.fixed.items()
            },
            "random": {
                n: {
                    "entities": t.num_entities,
                    "re_type": t.random_effect_type,
                    "sub_dim": int(t.weights.shape[1]),
                }
                for n, t in self.random.items()
            },
        }

    def codes_for(self, entity_ids: dict) -> dict[str, int]:
        """Per-coordinate row codes for one request (-1 = cold); the
        request's entity id is keyed by the coordinate's re_type."""
        return {
            name: t.code_for(entity_ids.get(t.random_effect_type, ""))
            for name, t in self.random.items()
        }

    @staticmethod
    def from_game_model(
        model: GameModel, precision: str | None = None, device=None
    ) -> "CoefficientTables":
        dev = device_mod.resolve(device)
        resolved = precision_mod.resolve(precision)

        def put(t: torch.Tensor) -> torch.Tensor:
            t = torch.as_tensor(t)
            if not t.is_floating_point():
                raise TypeError(f"coefficients must be float, not {t.dtype}")
            return precision_mod.in_storage(t.to(dev), resolved).contiguous()

        fixed: dict[str, FixedTable] = {}
        random: dict[str, RandomTable] = {}
        for name, sub in model.items():
            if isinstance(sub, FixedEffectModel):
                fixed[name] = FixedTable(
                    name=name,
                    feature_shard_id=sub.feature_shard_id,
                    task=sub.task,
                    weights=put(sub.model.coefficients.means),
                )
            elif isinstance(sub, RandomEffectModel):
                keys = tuple(str(k) for k in sub.entity_keys)
                proj = np.asarray(sub.proj_all).astype(np.int32)
                random[name] = RandomTable(
                    name=name,
                    random_effect_type=sub.random_effect_type,
                    feature_shard_id=sub.feature_shard_id,
                    task=sub.task,
                    weights=put(sub.coefficients),
                    proj=torch.from_numpy(
                        np.ascontiguousarray(proj)).to(dev),
                    entity_keys=keys,
                    entity_rows={k: i for i, k in enumerate(keys)},
                    num_features=(
                        int(proj.max(initial=-1)) + 1 if proj.size else 1
                    ),
                )
            else:
                raise TypeError(f"unknown sub-model type for {name!r}")
        tables = CoefficientTables(
            fixed=fixed, random=random, task=model.task, device=dev,
            precision=resolved,
        )
        tables.account_resident()
        return tables

    def account_resident(self) -> None:
        """Book every table's device bytes into the cost ledger's
        resident account (owner ``table/<coordinate>``; one flag check
        when the ledger is off). Called at build and after every
        reload, so the account and its peak follow the serving
        footprint, the transient double residency of a rebuild
        included."""
        from photon_tpu_torch.obs import ledger

        if not ledger.enabled():
            return
        for n, t in self.fixed.items():
            ledger.set_resident(f"table/{n}", ledger.tree_nbytes(t.weights))
        for n, t in self.random.items():
            ledger.set_resident(f"table/{n}",
                                ledger.tree_nbytes((t.weights, t.proj)))

    def structure_key(self) -> tuple:
        """What the score ladder specializes on: coordinate names,
        shard wiring, and table shapes and dtypes."""
        fe = tuple(
            (n, t.feature_shard_id, tuple(t.weights.shape),
             str(t.weights.dtype))
            for n, t in self.fixed.items()
        )
        re = tuple(
            (n, t.random_effect_type, t.feature_shard_id,
             tuple(t.weights.shape), str(t.weights.dtype))
            for n, t in self.random.items()
        )
        return (fe, re)

    def _values_only_delta(self, new: "CoefficientTables") -> bool:
        """True when ``new`` differs from the live tables only in
        coefficient values: same structure, projectors and entity
        vocabularies, so every row code keeps its meaning."""
        if new.structure_key() != self.structure_key():
            return False
        for name, t in self.random.items():
            src = new.random[name]
            if src.entity_keys != t.entity_keys:
                return False
            if not torch.equal(src.proj, t.proj):
                return False
        return True

    def reload(self, model: GameModel) -> bool:
        """Bring a refreshed model's coefficients into the live tables.

        Returns True for a values-only refresh: the new values are
        copied in place into the tensors the score ladder reads, on the
        current stream, so a later dispatch sees them and an earlier one
        has read the old ones. Returns False for a structure change
        (coordinates, shapes, dtype, projectors or vocabularies moved):
        the tables are rebuilt, which is not safe under live dispatch,
        and the caller must build new ``ScorePrograms``.
        """
        return self._reload_built(CoefficientTables.from_game_model(
            model, self.precision, self.device))

    def _reload_built(self, new: "CoefficientTables") -> bool:
        """``reload`` against an already built new generation."""
        self.generation += 1
        if not self._values_only_delta(new):
            self.fixed = new.fixed
            self.random = new.random
            self.task = new.task
            self.account_resident()
            return False
        with torch.no_grad():
            for name, t in self.fixed.items():
                t.weights.copy_(new.fixed[name].weights)
                t.task = new.fixed[name].task
            for name, t in self.random.items():
                t.weights.copy_(new.random[name].weights)
                t.task = new.random[name].task
        self.task = new.task
        self.account_resident()
        return True

    def rebuild_from(
        self,
        model: GameModel,
        *,
        programs=None,
        quiesce=None,
        adopt=None,
        prebuilt: "CoefficientTables | None" = None,
    ):
        """A reload of any kind, the score ladder rebuilt when the
        structure changed.

        A values-only delta is copied in place (``_reload_built``) and
        returns None. Otherwise the new generation's tables (``prebuilt``
        when the caller built them already) and, when ``programs`` (the
        live ``ScorePrograms``) is given, a new ladder with the same
        rungs and request layout over them (its graphs captured on the
        card) are built first, while the old generation keeps serving.
        Then, inside ``quiesce()`` (a context-manager factory such as
        ``MicroBatchQueue.quiesce``; None: the caller guarantees no live
        dispatch), the tables swap in, the generation moves on, the new
        ladder is rebound to this tables object and ``adopt`` (when
        given) receives it. Returns the new ``ScorePrograms`` (None
        without ``programs``).
        """
        import contextlib

        from photon_tpu_torch.serve.programs import ScorePrograms

        new = prebuilt if prebuilt is not None else (
            CoefficientTables.from_game_model(model, self.precision,
                                              self.device))
        if self._values_only_delta(new):
            self._reload_built(new)
            return None
        new_programs = None
        if programs is not None:
            new_programs = ScorePrograms(new, ladder=programs.ladder,
                                         specs=programs.given_specs)
        ctx = quiesce() if quiesce is not None else contextlib.nullcontext()
        with ctx:
            self.generation += 1
            self.fixed = new.fixed
            self.random = new.random
            self.task = new.task
            if new_programs is not None:
                # The swapped dicts hold the very tensors the new
                # graphs were captured on.
                new_programs.tables = self
            if adopt is not None:
                adopt(new_programs)
        # Outside the quiesce window: re-book the new generation.
        self.account_resident()
        return new_programs


def build_index_maps_from_model(model_dir: str) -> dict[str, IndexMap]:
    """Per-shard index maps recovered from a saved model's own records.

    A standalone server has no dataset to build index maps from; the
    model directory names every feature the model can use (each
    BayesianLinearModelAvro record keys its coefficients by (name,
    term)). The union of keys per feature shard, sorted, is a complete
    and deterministic serving map: a feature the model never weighted is
    absent, and its coefficient is zero either way.
    """
    from photon_tpu_torch.io import avro
    from photon_tpu_torch.io.model_io import COEFFICIENTS, ID_INFO

    shard_keys: dict[str, set] = {}
    for kind in ("fixed-effect", "random-effect"):
        base = os.path.join(model_dir, kind)
        if not os.path.isdir(base):
            continue
        for name in sorted(os.listdir(base)):
            with open(os.path.join(base, name, ID_INFO)) as f:
                shard = f.read().strip().splitlines()[-1]
            keys = shard_keys.setdefault(shard, set())
            coef_dir = os.path.join(base, name, COEFFICIENTS)
            if not os.path.isdir(coef_dir):
                continue
            for rec in avro.read_container_dir(coef_dir):
                for ntv in rec["means"]:
                    keys.add(make_feature_key(ntv["name"], ntv["term"]))
                for ntv in rec.get("variances") or ():
                    keys.add(make_feature_key(ntv["name"], ntv["term"]))
    return {
        shard: IndexMap({k: i for i, k in enumerate(sorted(keys))})
        for shard, keys in shard_keys.items()
    }
