"""The port's training CLI against the JAX package's, on the CPU.

Every CLI case writes its data files with numpy from a seed, runs
``photon_tpu.cli.train.main`` and ``photon_tpu_torch.cli.train.main
--device cpu`` on the same files (each config with ``"mesh": "off"``,
so that the reference trains on one device under the test conftest's
eight virtual ones), loads both output directories with the port's
``load_game_model`` and compares them. The cases mirror the reference's
own CLI tests (``tests/test_cli.py``, ``tests/test_resilience.py``).

Tolerances. Both CLIs read Avro and libsvm into float32 and train in
float32 (the reference's readers make f32 data whether or not x64 is
on), so each f32 fit ends within the bounds derived for an f32 solve
against float64 in ``tests/test_torch_wide.py`` (module docstring):
fixed effects 5e-4, random effects 2e-3. Two f32 fits,
one from each package, are then within twice that of each other:
- fixed effects within ``FE_ATOL`` = 1e-3 and random effects within
  ``RE_ATOL`` = 4e-3 (the largest seen here: 6.9e-4 and 5.0e-4, on the
  logistic grid);
- evaluations within ``EVAL_TOL`` = 1e-5 relative on the same model:
  the port's evaluator on the reference's saved model against the
  reference's reported evaluation, and on the port's own saved model
  against the port's. Two different f32 models may rank a pair of rows
  differently, so the two CLIs' evaluations are not compared with each
  other; the best configuration index must be equal;
- a resumed run against the uninterrupted one: rtol 1e-4 / atol 1e-6,
  the reference's documented resume tolerance;
- the estimator in float64 with validation: per-update evaluations
  within 1e-9 relative and coefficients within rtol 1e-6 / atol 1e-8, as
  ``tests/test_torch_train.py`` holds a float64 fit;
- module ports on float64 arrays (feature statistics, normalization
  contexts): rtol 1e-12, the same formulas with sums in another order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import signal

import numpy as np
import pytest
import torch

from photon_tpu_torch.cli import train as pt_train
from photon_tpu_torch.io import avro
from photon_tpu_torch.io.avro_data import (
    read_merged,
    read_training_examples,
    write_training_examples,
)
from photon_tpu_torch.io.model_io import load_game_model
from photon_tpu_torch.models.game import RandomEffectModel
from photon_tpu_torch.resilience import faults, load_training_checkpoint
from photon_tpu_torch.types import DELIMITER

FE_ATOL, RE_ATOL = 1e-3, 4e-3
EVAL_TOL = 1e-5
N_USERS, D = 20, 5
KEYS = [f"f{i}{DELIMITER}t" for i in range(D)]


def write_glmix(path, n, seed, task="linear", gen_seed=20260729):
    """A TrainingExampleAvro file of a GLMix problem: D dense features,
    a per-user effect over N_USERS users in the metadata. The generating
    weights come from ``gen_seed``, the rows from ``seed``."""
    g = np.random.default_rng(gen_seed)
    u_eff, w = g.normal(size=N_USERS), g.normal(size=D)
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, D))
    uid = r.integers(0, N_USERS, size=n)
    z = x @ w + u_eff[uid]
    if task == "linear":
        y = z + 0.1 * r.normal(size=n)
    elif task == "logistic":
        y = (r.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(float)
    else:
        y = r.poisson(np.exp(0.3 * z)).astype(float)
    rows = [[(KEYS[j], float(x[i, j])) for j in range(D)] for i in range(n)]
    write_training_examples(str(path), y, rows,
                            metadata=[{"userId": f"u{u}"} for u in uid],
                            uids=np.arange(n))


TASKS = {"linear": ("LINEAR_REGRESSION", "RMSE"),
         "logistic": ("LOGISTIC_REGRESSION", "AUC"),
         "poisson": ("POISSON_REGRESSION", "POISSON_LOSS")}


@pytest.fixture
def glmix(tmp_path):
    """The reference's ``glmix_avro`` fixture: 1,500 train and 500
    validation rows of a linear GLMix."""
    train, val = tmp_path / "train.avro", tmp_path / "val.avro"
    write_glmix(train, 1500, 1)
    write_glmix(val, 500, 2)
    return train, val


def make_config(tmp_path, train, val, **overrides):
    """The reference test's ``_config``: a linear GLMix with ``global``
    and ``per-user``, two iterations, RMSE; ``output_dir`` is filled in
    per package by ``run_both``."""
    cfg = {
        "task": "LINEAR_REGRESSION",
        "input": {"format": "avro", "train_path": str(train),
                  "validation_path": None if val is None else str(val),
                  "id_tags": ["userId"]},
        "coordinates": {
            "global": {"type": "fixed",
                       "regularization": {"type": "L2", "weights": [0.01]}},
            "per-user": {"type": "random", "random_effect_type": "userId",
                         "regularization": {"type": "L2",
                                            "weights": [1.0]}},
        },
        "num_iterations": 2,
        "evaluators": ["RMSE"],
        "mesh": "off",
    }
    cfg.update(overrides)
    return cfg


def run_cli(main, cfg: dict, path, *args) -> tuple[int, dict | None]:
    """Write ``cfg`` to ``path`` and run one CLI main in this process;
    (exit code, its last stdout line as JSON or None)."""
    path.write_text(json.dumps(cfg))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--config", str(path), *args])
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None


def run_both(tmp_path, cfg: dict, *args, port_args=()):
    """Both CLIs on ``cfg``, each into its own ``<side>/out`` (and
    ``<side>/summary`` when the config asks for feature stats): a dict
    side -> (output dir, last stdout line)."""
    from photon_tpu.cli import train as jax_train

    out = {}
    for side, main, extra in (("jax", jax_train.main, ()),
                              ("pt", pt_train.main,
                               ("--device", "cpu", *port_args))):
        root = tmp_path / side
        root.mkdir(exist_ok=True)
        c = dict(cfg, output_dir=str(root / "out"))
        if "data_summary_dir" in cfg:
            c["data_summary_dir"] = str(root / "summary")
        rc, line = run_cli(main, c, root / "cfg.json", *args, *extra)
        assert rc == 0, side
        out[side] = (root / "out", line)
    return out


def dense_coordinates(model) -> dict:
    """Coordinate -> fixed-effect means, or entity key -> dense [d]
    coefficients (zeros off the entity's support)."""
    out = {}
    for cid, m in model.items():
        if isinstance(m, RandomEffectModel):
            coefs = m.coefficients.double().numpy()
            d = int(np.max(m.proj_all)) + 1
            ent = {}
            for e, key in enumerate(m.entity_keys):
                row = np.zeros(d)
                slots = m.proj_all[e] >= 0
                row[m.proj_all[e][slots]] = coefs[e][slots]
                ent[str(key)] = row
            out[cid] = ent
        else:
            out[cid] = m.model.coefficients.means.double().numpy()
    return out


def assert_models_close(a, b, fe_atol=FE_ATOL, re_atol=RE_ATOL, rtol=0.0):
    da, db = dense_coordinates(a), dense_coordinates(b)
    assert da.keys() == db.keys()
    for cid in da:
        if isinstance(da[cid], dict):
            assert da[cid].keys() == db[cid].keys(), cid
            for key in da[cid]:
                x, y = da[cid][key], db[cid][key]
                d = max(len(x), len(y))
                np.testing.assert_allclose(
                    np.pad(x, (0, d - len(x))), np.pad(y, (0, d - len(y))),
                    rtol=rtol, atol=re_atol, err_msg=f"{cid}/{key}")
        else:
            np.testing.assert_allclose(da[cid], db[cid], rtol=rtol,
                                       atol=fe_atol, err_msg=cid)


def single_bag_maps(train):
    """The index maps the CLIs build from a single-bag training file."""
    _, imap = read_training_examples(str(train), device="cpu")
    return {"features": imap}


def val_dataset(path, maps, shards=None):
    """The port's read of a validation file against the training maps,
    as the CLIs read it."""
    if shards:
        return read_merged(str(path), feature_shards=shards, index_maps=maps,
                           id_columns=["userId", "songId"], device="cpu")[0]
    return read_training_examples(str(path), index_map=maps["features"],
                                  id_tag_names=["userId"], device="cpu")[0]


def load(out_dir, maps, sub="best"):
    return load_game_model(str(out_dir / "models" / sub), maps,
                           device="cpu")[0]


def summary(out_dir) -> dict:
    return json.loads((out_dir / "training-summary.json").read_text())


def evaluate(model, val, evaluators) -> dict:
    """The port's f32 evaluation of ``model`` on the dataset ``val``."""
    from photon_tpu_torch.transformers import GameTransformer, evaluate_scores

    return evaluate_scores(val, GameTransformer(model).score(val),
                           evaluators).evaluations


def assert_summaries_match(runs, val=None, maps=None, saved=("best",)):
    """Same configurations and best index; with the validation dataset
    ``val`` and the index ``maps``, each saved model (``saved`` names
    the model directories, config_<i> or best) evaluated by the port
    reproduces what each CLI reported for it."""
    js, ps = summary(runs["jax"][0]), summary(runs["pt"][0])
    assert ps["best_configuration_index"] == js["best_configuration_index"]
    assert ps["num_configurations"] == js["num_configurations"]
    for jc, pc in zip(js["configurations"], ps["configurations"],
                      strict=True):
        assert pc["config"] == jc["config"]
        assert pc["evaluation"].keys() == jc["evaluation"].keys()
    jl, pl = runs["jax"][1], runs["pt"][1]
    assert pl.keys() == jl.keys()
    assert pl["best_configuration"] == jl["best_configuration"]
    if val is None:
        return
    best = ps["best_configuration_index"]
    for sub in saved:
        i = best if sub == "best" else int(sub.split("_")[1])
        for side, s in (("jax", js), ("pt", ps)):
            reported = s["configurations"][i]["evaluation"]
            got = evaluate(load(runs[side][0], maps, sub), val,
                           list(reported))
            for k, v in reported.items():
                assert got[k] == pytest.approx(v, rel=EVAL_TOL), (side, k)


def test_end_to_end_linear_glmix(tmp_path, glmix):
    """``TestTrainCLI::test_end_to_end``: the layout, the frozen RMSE
    threshold, and the two CLIs' models and evaluations."""
    train, val = glmix
    runs = run_both(tmp_path, make_config(tmp_path, train, val))
    out_dir, line = runs["pt"]
    assert line["evaluation"]["RMSE"] < 0.3
    assert (out_dir / "training-summary.json").is_file()
    model_dir = out_dir / "models" / "best"
    for f in ("model-metadata.json", "fixed-effect/global/id-info",
              "random-effect/per-user/id-info", "checkpoint.npz"):
        assert (model_dir / f).is_file(), f
    maps = single_bag_maps(train)
    assert_summaries_match(runs, val_dataset(val, maps), maps)
    assert_models_close(load(out_dir, maps), load(runs["jax"][0], maps))
    assert set(summary(out_dir)["seconds"]) >= {
        "read", "validate", "stats", "prepare", "fit", "select",
        "save_models", "group_evaluation", "fit_per_configuration"}


@pytest.mark.parametrize("task", ["logistic", "poisson"])
def test_lambda_grid_selects_best(tmp_path, task):
    """``test_lambda_grid_selects_best`` on a logistic and a Poisson
    GLMix: a two-point grid per coordinate (four configurations), the
    best by the task's primary evaluator, every model saved."""
    train, val = tmp_path / "t.avro", tmp_path / "v.avro"
    write_glmix(train, 1200, 3, task)
    write_glmix(val, 400, 4, task)
    name, metric = TASKS[task]
    cfg = make_config(
        tmp_path, train, val, task=name, evaluators=[metric],
        coordinates={
            "global": {"type": "fixed", "regularization": {
                "type": "L2", "weights": [1000.0, 0.01]}},
            "per-user": {"type": "random", "random_effect_type": "userId",
                         "regularization": {"type": "L2",
                                            "weights": [0.5, 50.0]}},
        },
        model_output_mode="ALL")
    runs = run_both(tmp_path, cfg)
    s = summary(runs["pt"][0])
    best = s["best_configuration_index"]
    maps = single_bag_maps(train)
    saved = ["best" if i == best else f"config_{i}" for i in range(4)]
    assert_summaries_match(runs, val_dataset(val, maps), maps, saved)
    assert s["num_configurations"] == 4
    lams = [(c["config"]["global"]["lambda"],
             c["config"]["per-user"]["lambda"]) for c in s["configurations"]]
    assert lams == [(1000.0, 50.0), (1000.0, 0.5), (0.01, 50.0),
                    (0.01, 0.5)]
    assert best in (2, 3)
    for sub in saved:
        assert_models_close(load(runs["pt"][0], maps, sub),
                            load(runs["jax"][0], maps, sub))


def test_libsvm_input_with_standardization(tmp_path, rng):
    """``test_libsvm_input``: libsvm train and validation, -1/+1 labels,
    STANDARDIZATION of the one fixed effect."""
    n, d = 400, 6
    x = rng.normal(size=(n, d))
    w = rng.normal(size=d)
    y = (x @ w + 0.5 * rng.normal(size=n) > 0).astype(int)
    path = tmp_path / "a1a.txt"
    path.write_text("\n".join(
        f"{2 * y[i] - 1} " + " ".join(f"{j + 1}:{x[i, j]:.6f}"
                                      for j in range(d))
        for i in range(n)))
    cfg = make_config(
        tmp_path, path, None, task="LOGISTIC_REGRESSION",
        input={"format": "libsvm", "train_path": str(path),
               "validation_path": str(path)},
        coordinates={"global": {"type": "fixed", "regularization": {
            "type": "L2", "weights": [0.1]}}},
        evaluators=["AUC"], normalization="STANDARDIZATION")
    runs = run_both(tmp_path, cfg)
    assert runs["pt"][1]["evaluation"]["AUC"] > 0.85
    from photon_tpu_torch.data.index_map import IndexMap
    from photon_tpu_torch.types import TaskType

    maps = {"features": IndexMap.identity(d, add_intercept=True)}
    val, _ = pt_train._libsvm_game(path, TaskType.LOGISTIC_REGRESSION, "cpu",
                                   maps["features"])
    assert_summaries_match(runs, val, maps)
    assert_models_close(load(runs["pt"][0], maps), load(runs["jax"][0], maps))


def test_standardization_of_the_fixed_effect(tmp_path, glmix):
    """Avro GLMix with the fixed effect trained in the standardized
    space (its context from the feature statistics)."""
    train, val = glmix
    runs = run_both(tmp_path, make_config(
        tmp_path, train, val, normalization="STANDARDIZATION"))
    maps = single_bag_maps(train)
    assert_summaries_match(runs, val_dataset(val, maps), maps)
    assert_models_close(load(runs["pt"][0], maps), load(runs["jax"][0], maps))


@pytest.mark.parametrize("mode,dirs", [
    ("NONE", None),
    ("BEST", {"best"}),
    ("EXPLICIT", {"best", "config_0"}),
    ("ALL", {"best", "config_0"}),
])
def test_output_modes(tmp_path, glmix, mode, dirs):
    """``TestObservability::test_output_modes``: which models land under
    models/ for a two-point grid whose second point wins."""
    train, val = glmix
    cfg = make_config(
        tmp_path, train, val, model_output_mode=mode,
        coordinates={"global": {"type": "fixed", "regularization": {
            "type": "L2", "weights": [100.0, 0.01]}}})
    runs = run_both(tmp_path, cfg)
    maps = single_bag_maps(train)
    assert_summaries_match(runs, val_dataset(val, maps), maps,
                           sorted(dirs or ()))
    for side in ("jax", "pt"):
        out_dir = runs[side][0]
        assert (out_dir / "training-summary.json").is_file()
        if dirs is None:
            assert not (out_dir / "models").exists()
        else:
            assert {p.name for p in (out_dir / "models").iterdir()} == dirs
    if dirs is not None:
        assert (runs["pt"][0] / "models" / "best" / "checkpoint.npz"
                ).is_file()


def test_per_group_evaluation_files(tmp_path, rng):
    """``test_per_group_evaluation_output``: grouped AUC per user beside
    the models, equal between the two CLIs."""
    n, d, users = 900, 4, 8
    keys = [f"f{i}{DELIMITER}t" for i in range(d)]
    w = rng.normal(size=d)

    def write(path, seed):
        r = np.random.default_rng(seed)
        x = r.normal(size=(n, d))
        uid = r.integers(0, users, size=n)
        y = (x @ w + 0.5 * r.normal(size=n) > 0).astype(float)
        write_training_examples(
            str(path), y, [[(keys[j], float(x[i, j])) for j in range(d)]
                           for i in range(n)],
            metadata=[{"userId": f"u{u}"} for u in uid])

    tr, va = tmp_path / "t.avro", tmp_path / "v.avro"
    write(tr, 1)
    write(va, 2)
    cfg = make_config(
        tmp_path, tr, va, task="LOGISTIC_REGRESSION",
        coordinates={"global": {"type": "fixed", "regularization": {
            "type": "L2", "weights": [0.1]}}},
        evaluators=["AUC", "AUC:userId"])
    runs = run_both(tmp_path, cfg)
    maps = single_bag_maps(tr)
    assert_summaries_match(runs, val_dataset(va, maps), maps)
    from photon_tpu_torch.transformers import (
        GameTransformer,
        evaluation_suite,
    )

    val = val_dataset(va, maps)
    suite = evaluation_suite(val, ["AUC:userId"])
    keys = val.id_tags["userId"].inverse
    for side in ("jax", "pt"):
        ge = runs[side][0] / "group-evaluation" / "0"
        written = json.loads((ge / "AUC_userId.json").read_text())
        want = suite.evaluate_per_group(GameTransformer(
            load(runs[side][0], maps)).score(val))["AUC:userId"]
        assert len(written) == users and list(written) == list(keys)
        for k, v in zip(keys, want):
            assert written[k] == pytest.approx(v, rel=EVAL_TOL), (side, k)
            assert 0.0 <= written[k] <= 1.0 and k.startswith("u")


YAHOO_SCHEMA = {
    "name": "YahooStyleExample", "type": "record", "namespace": "test",
    "fields": [
        {"name": "userId", "type": "long"},
        {"name": "songId", "type": "long"},
        {"name": "response", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": {
            "name": "F", "type": "record", "namespace": "test",
            "fields": [{"name": "name", "type": "string"},
                       {"name": "term", "type": "string"},
                       {"name": "value", "type": "double"}]}}},
        {"name": "userFeatures", "type": {"type": "array",
                                          "items": "test.F"}},
        {"name": "songFeatures", "type": {"type": "array",
                                          "items": "test.F"}},
    ],
}


def write_yahoo(path, seed, n=1200, users=12, songs=6):
    """``TestMultiShardAvro._write``: Yahoo!-Music-shaped records with
    features / userFeatures / songFeatures bags, ids as long columns."""
    rng = np.random.default_rng(seed)
    d, du, ds = 4, 3, 2
    w = rng.normal(size=d)
    wu = rng.normal(size=(users, du + 1)) * 0.5
    ws = rng.normal(size=(songs, ds + 1)) * 0.5

    def bag(prefix, vals):
        return [{"name": prefix, "term": str(j), "value": float(v)}
                for j, v in enumerate(vals)]

    recs = []
    for _ in range(n):
        u, s = int(rng.integers(0, users)), int(rng.integers(0, songs))
        x, xu, xs = (rng.normal(size=k) for k in (d, du, ds))
        y = (x @ w + np.r_[xu, 1.0] @ wu[u] + np.r_[xs, 1.0] @ ws[s]
             + 0.1 * rng.normal())
        recs.append({"userId": u, "songId": s, "response": float(y),
                     "features": bag("g", x), "userFeatures": bag("u", xu),
                     "songFeatures": bag("s", xs)})
    avro.write_container(str(path), YAHOO_SCHEMA, recs)


def multi_bag_config(tmp_path, tr, va, shards, coords):
    return make_config(
        tmp_path, tr, va,
        input={"format": "avro", "train_path": str(tr),
               "validation_path": None if va is None else str(va),
               "feature_shards": shards, "id_columns": ["userId", "songId"]},
        coordinates=coords, num_iterations=3)


def yahoo_coords(user_shard="userShard"):
    return {
        "global": {"type": "fixed", "feature_shard": "globalShard",
                   "regularization": {"type": "L2", "weights": [1e-3]}},
        "per-user": {"type": "random", "feature_shard": user_shard,
                     "random_effect_type": "userId",
                     "regularization": {"type": "L2", "weights": [0.1]}},
        "per-song": {"type": "random", "feature_shard": "songShard",
                     "random_effect_type": "songId",
                     "regularization": {"type": "L2", "weights": [0.1]}},
    }


def test_multi_bag_shards(tmp_path):
    """``test_multi_shard_glmix_end_to_end``: global, per-user and
    per-song, each on its own shard of its own bags."""
    tr, va = tmp_path / "t.avro", tmp_path / "v.avro"
    write_yahoo(tr, 0)
    write_yahoo(va, 0, n=400)
    shards = {"globalShard": ["features"], "userShard": ["userFeatures"],
              "songShard": ["songFeatures"]}
    runs = run_both(tmp_path, multi_bag_config(tmp_path, tr, va, shards,
                                               yahoo_coords()))
    assert runs["pt"][1]["evaluation"]["RMSE"] < 0.25
    _, maps = read_merged(str(tr), feature_shards=shards,
                          id_columns=["userId", "songId"], device="cpu")
    assert_summaries_match(runs, val_dataset(va, maps, shards), maps)
    assert_models_close(load(runs["pt"][0], maps), load(runs["jax"][0], maps))


def test_per_shard_intercept_flag(tmp_path):
    """``test_per_shard_intercept_flag``: a shard may opt out of its
    intercept slot."""
    tr = tmp_path / "t.avro"
    write_yahoo(tr, 0, n=300)
    shards = {"globalShard": {"bags": ["features"], "intercept": True},
              "userShard": {"bags": ["userFeatures"], "intercept": False},
              "songShard": {"bags": ["songFeatures"], "intercept": True}}
    runs = run_both(tmp_path, multi_bag_config(tmp_path, tr, None, shards,
                                               yahoo_coords()))
    _, maps = read_merged(
        str(tr), feature_shards={k: v["bags"] for k, v in shards.items()},
        id_columns=["userId", "songId"],
        add_intercept={k: v["intercept"] for k, v in shards.items()},
        device="cpu")
    assert maps["userShard"].intercept_index is None
    assert maps["globalShard"].intercept_index is not None
    assert_models_close(load(runs["pt"][0], maps), load(runs["jax"][0], maps))


def test_train_on_a_vocabulary_from_cli_index(tmp_path, glmix):
    """``test_train_with_prebuilt_index``: the port's ``cli.index``
    builds the vocabulary both CLIs train on."""
    from photon_tpu_torch.cli import index as pt_index
    from photon_tpu_torch.cli.index import load_index_maps

    train, val = glmix
    vocab = tmp_path / "vocab"
    with contextlib.redirect_stdout(io.StringIO()):
        assert pt_index.main(["--input", str(train),
                              "--output", str(vocab)]) == 0
    cfg = make_config(tmp_path, train, val, input={
        "format": "avro", "train_path": str(train),
        "validation_path": str(val), "id_tags": ["userId"],
        "feature_index_dir": str(vocab)})
    runs = run_both(tmp_path, cfg)
    assert runs["pt"][1]["evaluation"]["RMSE"] < 0.3
    maps = load_index_maps(str(vocab))
    assert_summaries_match(runs, val_dataset(val, maps), maps)
    assert_models_close(load(runs["pt"][0], maps), load(runs["jax"][0], maps))


def test_feature_stats_artifact(tmp_path, glmix):
    """``test_feature_stats_artifact``: per-shard
    FeatureSummarizationResultAvro beside numpy over the written rows,
    and equal to the reference's artifact."""
    from photon_tpu.io.model_io import load_feature_stats as jax_load
    from photon_tpu_torch.io.model_io import load_feature_stats
    from photon_tpu_torch.types import make_feature_key

    train, val = glmix
    cfg = make_config(tmp_path, train, val, data_summary_dir="set",
                      evaluators=["RMSE", "MAE", "MSE"])
    runs = run_both(tmp_path, cfg)
    assert {"MAE", "MSE"} <= set(runs["pt"][1]["evaluation"])
    stats = load_feature_stats(str(tmp_path / "pt" / "summary" / "features"))
    theirs = jax_load(str(tmp_path / "jax" / "summary" / "features"))
    assert len(stats) == D and stats.keys() == theirs.keys()
    for key in stats:
        assert stats[key].keys() == theirs[key].keys()
        for m, v in theirs[key].items():
            assert stats[key][m] == pytest.approx(v, rel=1e-12, abs=1e-12)
    vals = np.array([f["value"] for r in avro.read_container_dir(str(train))
                     for f in r["features"]
                     if f["name"] == "f0" and f["term"] == "t"])
    m = stats[make_feature_key("f0", "t")]
    assert set(m) == {"max", "min", "mean", "normL1", "normL2",
                      "numNonzeros", "variance"}
    np.testing.assert_allclose(m["mean"], vals.mean(), rtol=1e-6)
    np.testing.assert_allclose(m["max"], vals.max(), rtol=1e-6)
    np.testing.assert_allclose(m["normL1"], np.abs(vals).sum(), rtol=1e-6)
    np.testing.assert_allclose(m["normL2"], np.sqrt((vals ** 2).sum()),
                               rtol=1e-6)
    np.testing.assert_allclose(m["variance"], vals.var(ddof=1), rtol=1e-5)


def test_log_file_sink(tmp_path, glmix):
    """``test_log_file_sink``: --log-file keeps the run's INFO records,
    each stage's "executed in" line among them."""
    train, val = glmix
    log_path = tmp_path / "photon.log"
    rc, _ = run_cli(pt_train.main, make_config(
        tmp_path, train, val, num_iterations=1,
        output_dir=str(tmp_path / "out")), tmp_path / "c.json",
        "--device", "cpu", "--log-file", str(log_path))
    assert rc == 0
    text = log_path.read_text()
    assert "fit executed in" in text and "CD iter 0 coordinate" in text


def test_date_range_over_daily_directories(tmp_path):
    """``date_range`` selects base/yyyy/MM/dd directories; the records of
    the selected days train as one dataset (``tests/test_paths.py``)."""
    base, vbase = tmp_path / "daily", tmp_path / "vdaily"
    for day, seed in (("01", 11), ("02", 12), ("03", 13)):
        for root, n in ((base, 500), (vbase, 200)):
            p = root / "2026" / "03" / day
            p.mkdir(parents=True)
            write_glmix(p / "part-00000.avro", n, seed + n)
    cfg = make_config(tmp_path, base, vbase)
    cfg["input"]["date_range"] = "20260302-20260303"
    runs = run_both(tmp_path, cfg)
    assert summary(runs["pt"][0])["num_training_rows"] == 1000
    recs = (avro.read_container_dir(str(base / "2026/03/02"))
            + avro.read_container_dir(str(base / "2026/03/03")))
    _, imap = read_training_examples("unused", records=recs, device="cpu")
    maps = {"features": imap}
    vrecs = (avro.read_container_dir(str(vbase / "2026/03/02"))
             + avro.read_container_dir(str(vbase / "2026/03/03")))
    val, _ = read_training_examples("unused", index_map=imap, records=vrecs,
                                    id_tag_names=["userId"], device="cpu")
    assert_summaries_match(runs, val, maps)
    assert_models_close(load(runs["pt"][0], maps), load(runs["jax"][0], maps))


@pytest.fixture
def x64_off():
    """The JAX package in its default configuration, x64 off, for the
    block: under x64 it loads an Avro model directory in float64 and
    its f32 fit refuses the float64 warm start (ROADMAP Queue C)."""
    import jax

    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("source", ["init_model", "warm_start_model_dir"])
def test_warm_start(tmp_path, glmix, source, request):
    """A first run's best model seeds a second one: ``--init-model``
    with its native ``checkpoint.npz``, or the config's
    ``warm_start_model_dir`` with its Avro model directory (the JAX
    side then with x64 off); both CLIs start from the same model."""
    train, val = glmix
    (tmp_path / "first").mkdir()
    first = run_both(tmp_path / "first",
                     make_config(tmp_path, train, val, num_iterations=1))
    best_dir = first["jax"][0] / "models" / "best"
    cfg = make_config(tmp_path, train, val, num_iterations=1)
    if source == "init_model":
        runs = run_both(tmp_path, cfg, "--init-model",
                        str(best_dir / "checkpoint.npz"))
    else:
        request.getfixturevalue("x64_off")
        runs = run_both(tmp_path, dict(cfg,
                                       warm_start_model_dir=str(best_dir)))
    maps = single_bag_maps(train)
    assert_summaries_match(runs, val_dataset(val, maps), maps)
    assert_models_close(load(runs["pt"][0], maps), load(runs["jax"][0], maps))
    cold = load(first["pt"][0], maps)
    warm = load(runs["pt"][0], maps)
    # One more pass from the first model moves it, but not far.
    diff = np.abs(dense_coordinates(warm)["global"]
                  - dense_coordinates(cold)["global"])
    assert 0.0 < diff.max() < 0.1


def test_incremental_training_refuses_a_model_without_variances(
        tmp_path, glmix):
    """Incremental training needs the prior's variances; a model trained
    without them is refused by both CLIs, and without a model at all
    too."""
    from photon_tpu.cli import train as jax_train

    train, val = glmix
    first = run_both(tmp_path, make_config(tmp_path, train, val,
                                           num_iterations=1))
    cfg = make_config(tmp_path, train, val, incremental_training=True,
                      warm_start_model_dir=str(first["pt"][0] / "models"
                                               / "best"),
                      output_dir=str(tmp_path / "inc"))
    for main, extra in ((jax_train.main, ()),
                        (pt_train.main, ("--device", "cpu"))):
        with pytest.raises(ValueError, match="missing variance"):
            run_cli(main, cfg, tmp_path / "inc.json", *extra)
    cfg.pop("warm_start_model_dir")
    with pytest.raises(ValueError, match="no warm_start_model_dir"):
        run_cli(pt_train.main, cfg, tmp_path / "inc.json", "--device", "cpu")


def resume_config(tmp_path, glmix, out):
    train, val = glmix
    return make_config(tmp_path, train, val, num_iterations=3,
                       output_dir=str(out))


@pytest.fixture
def fault_plan(monkeypatch):
    """Arm ``PHOTON_TPU_FAULT_PLAN`` for the CLI; disarmed afterwards."""

    def arm(*specs):
        monkeypatch.setenv(faults.ENV_VAR, json.dumps({"faults": list(specs)}))

    yield arm
    faults.disarm()


def test_crash_resume_matches_uninterrupted(tmp_path, glmix, fault_plan,
                                            monkeypatch):
    """``TestResume::test_crash_resume_matches_uninterrupted`` through
    the CLI: a crash at the second ``cd.iteration``, then ``--resume``,
    ends where the uninterrupted run ends."""
    from photon_tpu_torch.resilience import InjectedCrash

    ckpt = tmp_path / "ckpt"
    fault_plan({"point": "cd.iteration", "nth": 2, "error": "crash"})
    with pytest.raises(InjectedCrash):
        run_cli(pt_train.main, resume_config(tmp_path, glmix,
                                             tmp_path / "a"),
                tmp_path / "a.json", "--device", "cpu",
                "--checkpoint-dir", str(ckpt))
    faults.disarm()
    monkeypatch.delenv(faults.ENV_VAR)
    state = load_training_checkpoint(str(ckpt), "cpu")
    assert (state.config_index, state.iteration) == (0, 1)
    rc, _ = run_cli(pt_train.main, resume_config(tmp_path, glmix,
                                                 tmp_path / "a"),
                    tmp_path / "a.json", "--device", "cpu",
                    "--resume", str(ckpt))
    assert rc == 0
    cfg = resume_config(tmp_path, glmix, tmp_path / "b")
    rc, _ = run_cli(pt_train.main, cfg, tmp_path / "b.json", "--device",
                    "cpu", "--checkpoint-dir", str(tmp_path / "ckpt_b"))
    assert rc == 0
    maps = single_bag_maps(glmix[0])
    assert_models_close(load(tmp_path / "a", maps), load(tmp_path / "b", maps),
                        fe_atol=1e-6, re_atol=1e-6, rtol=1e-4)
    # ...and the uninterrupted run is the reference's.
    runs = run_both(tmp_path, cfg)
    assert_models_close(load(tmp_path / "b", maps),
                        load(runs["jax"][0], maps))


def test_sigterm_mid_fit_commits_emergency_checkpoint(tmp_path, glmix,
                                                      fault_plan,
                                                      monkeypatch):
    """``test_sigterm_mid_fit_commits_emergency_checkpoint``: a real
    SIGTERM after iteration 1's checkpoint exits 128 + 15 with the state
    re-committed as interrupted, and ``--resume`` finishes the run."""
    ckpt = tmp_path / "ckpt"
    cfg = resume_config(tmp_path, glmix, tmp_path / "out")
    fault_plan({"point": "cd.iteration", "nth": 2, "error": "sigterm"})
    rc, _ = run_cli(pt_train.main, cfg, tmp_path / "c.json", "--device",
                    "cpu", "--checkpoint-dir", str(ckpt))
    assert rc == 128 + signal.SIGTERM
    state = load_training_checkpoint(str(ckpt), "cpu")
    assert state.interrupted
    assert (state.config_index, state.iteration) == (0, 1)
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    faults.disarm()
    monkeypatch.delenv(faults.ENV_VAR)
    rc, _ = run_cli(pt_train.main, cfg, tmp_path / "c.json", "--device",
                    "cpu", "--resume", str(ckpt))
    assert rc == 0
    final = load_training_checkpoint(str(ckpt), "cpu")
    assert not final.interrupted and final.iteration == 2


def test_multi_config_resume_rebuilds_the_completed_config(
        tmp_path, glmix, fault_plan, monkeypatch):
    """``test_multi_config_resume_preserves_all_results`` through the
    CLI: a crash in the second configuration's first iteration; the
    resumed run rebuilds the first from its retained artifact, so both
    results, the best index and the saved models equal the
    uninterrupted run's."""
    from photon_tpu_torch.resilience import InjectedCrash

    train, val = glmix
    grid = {"per-user": {"type": "random", "random_effect_type": "userId",
                         "regularization": {"type": "L2",
                                            "weights": [0.5, 200.0]}}}
    cfgs = {side: make_config(tmp_path, train, val, num_iterations=3,
                              model_output_mode="ALL",
                              coordinates={**make_config(
                                  tmp_path, train, val)["coordinates"],
                                  **grid},
                              output_dir=str(tmp_path / side))
            for side in ("a", "b")}
    ckpt = tmp_path / "ckpt"
    fault_plan({"point": "cd.iteration", "nth": 4, "error": "crash"})
    with pytest.raises(InjectedCrash):
        run_cli(pt_train.main, cfgs["a"], tmp_path / "a.json", "--device",
                "cpu", "--checkpoint-dir", str(ckpt))
    faults.disarm()
    monkeypatch.delenv(faults.ENV_VAR)
    state = load_training_checkpoint(str(ckpt), "cpu")
    assert (state.config_index, state.iteration) == (1, 0)
    for side, flag, d in (("a", "--resume", ckpt),
                          ("b", "--checkpoint-dir", tmp_path / "ckpt_b")):
        assert run_cli(pt_train.main, cfgs[side], tmp_path / f"{side}.json",
                       "--device", "cpu", flag, str(d))[0] == 0
    sa, sb = summary(tmp_path / "a"), summary(tmp_path / "b")
    assert sa["best_configuration_index"] == sb["best_configuration_index"]
    assert sa["seconds"]["fit_per_configuration"][0] is None
    for ca, cb in zip(sa["configurations"], sb["configurations"],
                      strict=True):
        assert ca["evaluation"]["RMSE"] == pytest.approx(
            cb["evaluation"]["RMSE"], rel=1e-4)
    maps = single_bag_maps(train)
    best = sa["best_configuration_index"]
    for i in range(2):
        sub = "best" if i == best else f"config_{i}"
        assert_models_close(load(tmp_path / "a", maps, sub),
                            load(tmp_path / "b", maps, sub),
                            fe_atol=1e-6, re_atol=1e-6, rtol=1e-4)


def test_resume_finalizes_a_config_that_died_before_its_final_artifact(
        tmp_path, glmix, fault_plan, monkeypatch):
    """A crash in the write of the config-final artifact, after the last
    iteration's checkpoint: the resume finalizes the result from the
    checkpoint chain instead of refusing, and writes the artifact."""
    from photon_tpu_torch.resilience import InjectedCrash

    train, _ = glmix
    cfg = make_config(tmp_path, train, None, output_dir=str(tmp_path / "a"))
    ckpt = tmp_path / "ckpt"
    # Writes: iteration 0, iteration 1, then the config-final artifact.
    fault_plan({"point": "checkpoint.write", "nth": 3, "error": "crash"})
    with pytest.raises(InjectedCrash):
        run_cli(pt_train.main, cfg, tmp_path / "a.json", "--device", "cpu",
                "--checkpoint-dir", str(ckpt))
    faults.disarm()
    monkeypatch.delenv(faults.ENV_VAR)
    assert not (ckpt / "config-c000-final.npz").exists()
    assert not any(".tmp." in f for f in os.listdir(ckpt))
    assert run_cli(pt_train.main, cfg, tmp_path / "a.json", "--device",
                   "cpu", "--resume", str(ckpt))[0] == 0
    assert (ckpt / "config-c000-final.npz").exists()
    state = load_training_checkpoint(str(ckpt), "cpu")
    maps = single_bag_maps(train)
    assert_models_close(load(tmp_path / "a", maps), state.model,
                        fe_atol=0.0, re_atol=0.0)
    with pytest.raises(ValueError, match="nothing to resume"):
        run_cli(pt_train.main, cfg, tmp_path / "a.json", "--device", "cpu",
                "--resume", str(ckpt))


def test_resume_refuses_a_changed_configuration(tmp_path, glmix):
    """The manifest's static key pins the configuration."""
    from photon_tpu_torch.resilience import ResumeMismatchError

    ckpt = tmp_path / "ckpt"
    cfg = resume_config(tmp_path, glmix, tmp_path / "out")
    assert run_cli(pt_train.main, cfg, tmp_path / "c.json", "--device",
                   "cpu", "--checkpoint-dir", str(ckpt))[0] == 0
    cfg["num_iterations"] = 4
    with pytest.raises(ResumeMismatchError):
        run_cli(pt_train.main, cfg, tmp_path / "c.json", "--device", "cpu",
                "--resume", str(ckpt))


def test_train_then_score_round_trip(tmp_path, glmix):
    """``TestScoreCLI::test_train_then_score``: each package's
    ``cli.score`` on its own ``cli.train`` output; the port's scores and
    evaluation match the reference's, and its evaluation the training
    summary's."""
    from photon_tpu.cli import score as jax_score
    from photon_tpu_torch.cli import score as pt_score

    train, val = glmix
    runs = run_both(tmp_path, make_config(tmp_path, train, val))
    scores, evals = {}, {}
    for side, main, extra in (("jax", jax_score.main, ("--mesh", "off")),
                              ("pt", pt_score.main, ("--device", "cpu"))):
        out = tmp_path / f"scores_{side}"
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["--model-dir", str(runs[side][0] / "models" /
                                            "best"),
                         "--input", str(val), "--output", str(out),
                         "--evaluators", "RMSE", "--id-tags", "userId",
                         *extra]) == 0
        recs = avro.read_container_dir(str(out / "part-00000.avro"))
        scores[side] = np.array([r["predictionScore"] for r in recs])
        evals[side] = json.loads((out / "evaluation.json").read_text())
    assert len(scores["pt"]) == 500 and np.isfinite(scores["pt"]).all()
    # The two models agree within FE_ATOL / RE_ATOL per coefficient;
    # a row's score sums D + 1 + the user's slots of them.
    np.testing.assert_allclose(scores["pt"], scores["jax"], rtol=0,
                               atol=(D + 1) * FE_ATOL + RE_ATOL)
    assert evals["pt"]["RMSE"] < 0.3
    assert evals["pt"]["RMSE"] == pytest.approx(evals["jax"]["RMSE"],
                                                abs=1e-4)
    trained = summary(runs["pt"][0])["configurations"][0]["evaluation"]
    assert evals["pt"]["RMSE"] == pytest.approx(trained["RMSE"],
                                                abs=EVAL_TOL)


# (args, config overrides, environment, the error and its message).
UNPORTED = [
    (["--distributed", "--fleet-dir", "f"], {}, {"WORLD_SIZE": "2"},
     ValueError, "WORLD_SIZE=2 but RANK, MASTER_ADDR, MASTER_PORT not set"),
    (["--distributed"], {}, {"WORLD_SIZE": "2", "RANK": "0"},
     ValueError, "WORLD_SIZE=2 but MASTER_ADDR, MASTER_PORT not set"),
    ([], {"mesh": 4}, {}, ValueError,
     "mesh setting requests 4 devices but only 1 are visible"),
    ([], {"global": {"feature_sharding": "column"}}, {}, NotImplementedError,
     r"second part of item 12\) is not ported .*ROADMAP Queue A item 12\)"),
]


# Each case keeps the id it had before the item-6 cases (13-16, 18, 19)
# were ported and moved to FORMERLY_UNPORTED below, the item-9 cases
# (0-2, the streaming flags) to tests/test_torch_stream.py, the
# item-11 cases (10 and 17, hyperparameter tuning and a weight range) to
# the tuning tests below, and the item-10 telemetry cases (3-5, 9 and
# 20: --telemetry, --trace, --flight-dir, profile_dir, --no-flight; and
# 6, --monitor-port) to tests/test_torch_obs_cli.py. Cases 7 and 8 were
# --fleet-dir (item 10) and --distributed alone; with item 12's mesh
# ported, a launcher's WORLD_SIZE of 2 starts a process group, and the
# cases, under their old ids, hold that one without its rendezvous
# variables is refused before anything is read. Cases 11 and 12 hold the
# refusals that stay: a mesh larger than the process group, and the
# column-sharded fixed effect (item 12's second part). Mesh training on
# real ranks is tests/test_torch_mesh_ranks.py's.
UNPORTED_IDS = ["7-item10", "8-item12", "11-item12", "12-item12"]


@pytest.mark.parametrize("args,overrides,env,error,match", UNPORTED,
                         ids=UNPORTED_IDS)
def test_unported_options_raise_naming_their_item(tmp_path, glmix, args,
                                                  overrides, env, error,
                                                  match, monkeypatch):
    train, val = glmix
    out = tmp_path / "out"
    cfg = make_config(tmp_path, train, val, output_dir=str(out))
    for key, value in overrides.items():
        if key in cfg["coordinates"]:
            cfg["coordinates"][key] = {**cfg["coordinates"][key], **value}
        else:
            cfg[key] = value
    for key in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(error, match=match):
        run_cli(pt_train.main, cfg, tmp_path / "c.json", "--device", "cpu",
                *args)


# ---------------------------------------------------------------------------
# --distributed: a 1-rank fleet on one process
# ---------------------------------------------------------------------------


def _bundle(fleet_dir) -> tuple[dict, list]:
    """The committed rank-0 bundle under ``fleet_dir`` and its spans."""
    host = os.path.join(str(fleet_dir), "obs-host-0")
    with open(os.path.join(host, "bundle.json")) as f:
        bundle = json.load(f)
    with open(os.path.join(host, "spans.jsonl")) as f:
        spans = [r for r in map(json.loads, f) if r["type"] == "span"]
    return bundle, spans


def _expected_run_id(fleet_dir) -> str:
    import zlib

    digest = zlib.crc32(os.path.abspath(str(fleet_dir)).encode("utf-8"))
    return f"train-{digest & 0xffffffff:08x}"


def test_distributed_ships_a_one_rank_bundle(tmp_path, glmix, monkeypatch):
    from photon_tpu_torch import obs
    from photon_tpu_torch.cli import fleetview
    from photon_tpu_torch.obs import ledger

    monkeypatch.delenv("PHOTON_RUN_ID", raising=False)
    monkeypatch.delenv("PHOTON_FLEET_DIR", raising=False)
    train, val = glmix
    cfg = make_config(tmp_path, train, val,
                      output_dir=str(tmp_path / "out"))
    was = obs.enabled()
    fleet = tmp_path / "fleet"
    rc, line = run_cli(pt_train.main, cfg, tmp_path / "c.json", "--device",
                       "cpu", "--distributed", "--fleet-dir", str(fleet))
    assert rc == 0 and line is not None
    # The run restores the flags it found.
    assert obs.enabled() == was and not ledger.enabled()
    bundle, spans = _bundle(fleet)
    assert bundle["schema"] == 1
    assert bundle["host"]["process_index"] == 0
    assert bundle["host"]["process_count"] == 1
    assert bundle["host"]["run_id"] == _expected_run_id(fleet)
    # The init sample was taken after the run's obs.reset(), at the start.
    clock = bundle["clock"]
    assert clock["init"] != clock["commit"]
    assert 0.0 <= clock["skew_bound_seconds"] < 1.0
    assert bundle["ledger"]["enabled"] is True
    report_path = tmp_path / "report.json"
    with contextlib.redirect_stdout(io.StringIO()):
        assert fleetview.main(["--run-dir", str(fleet), "--expect-ranks",
                               "1", "--json", str(report_path)]) == 0
    report = json.loads(report_path.read_text())
    assert report["ranks"] == [0] and report["gaps"] == []
    assert report["per_rank"][0]["attributed_seconds"] > 0


def test_distributed_bundle_names_the_run_coordinates(tmp_path, glmix,
                                                      monkeypatch):
    monkeypatch.delenv("PHOTON_FLEET_DIR", raising=False)
    train, val = glmix
    cfg = make_config(tmp_path, train, val,
                      output_dir=str(tmp_path / "out"))
    rc, _ = run_cli(pt_train.main, cfg, tmp_path / "c.json", "--device",
                    "cpu", "--distributed")
    assert rc == 0
    bundle, spans = _bundle(tmp_path / "out" / "fleet")
    coords = set(cfg["coordinates"])
    # Two iterations: a coord:<cid> span per update.
    for cid in coords:
        assert sum(sp["name"] == f"coord:{cid}" for sp in spans) == 2, cid
    rows = {(r["coordinate"], r["phase"], r["program"]): r
            for r in bundle["ledger"]["rows"]}
    for cid in coords:
        row = rows[(cid, "fit", "coordinate_descent")]
        assert row["seconds"] > 0 and row["dispatches"] == 1
    assert ("-", "host", "unattributed") in rows
    assert "coordinate_descent" in bundle["ledger"]["programs"]
    assert bundle["ledger"]["resident_bytes"][
        "coordinate_descent/slabs"] > 0


@pytest.mark.parametrize("mode", ["flag", "env", "default"])
def test_fleet_dir_resolves_as_the_reference_does(tmp_path, glmix,
                                                  monkeypatch, mode):
    """``--fleet-dir``, else ``$PHOTON_FLEET_DIR``, else
    ``<output_dir>/fleet``: both CLIs ship their bundle to the same
    place, stamped with the run id derived from its path."""
    from photon_tpu.cli import train as jax_train

    monkeypatch.delenv("PHOTON_RUN_ID", raising=False)
    monkeypatch.delenv("PHOTON_FLEET_DIR", raising=False)
    train, val = glmix
    for side, main, extra in (("jax", jax_train.main, ()),
                              ("pt", pt_train.main, ("--device", "cpu"))):
        root = tmp_path / side
        root.mkdir()
        cfg = make_config(tmp_path, train, val, output_dir=str(root / "out"))
        args = ["--distributed", *extra]
        # The flag wins over the environment, which wins over the default.
        monkeypatch.setenv("PHOTON_FLEET_DIR", str(root / "fleet-env"))
        if mode == "flag":
            args += ["--fleet-dir", str(root / "fleet-flag")]
            want = root / "fleet-flag"
        elif mode == "env":
            want = root / "fleet-env"
        else:
            monkeypatch.delenv("PHOTON_FLEET_DIR")
            want = root / "out" / "fleet"
        rc, _ = run_cli(main, cfg, root / "c.json", *args)
        assert rc == 0, side
        bundle, _ = _bundle(want)
        assert bundle["host"]["run_id"] == _expected_run_id(want), side
        shipped = sorted(p.relative_to(root).as_posix()
                         for p in root.rglob("bundle.json"))
        assert shipped == [f"{want.relative_to(root).as_posix()}/"
                           "obs-host-0/bundle.json"], side


def test_world_size_above_one_raises_naming_item_12(tmp_path, glmix,
                                                    monkeypatch):
    """A launcher's WORLD_SIZE of 2 starts a process group (item 12): one
    without its rendezvous variables is refused before anything is read
    or written; WORLD_SIZE 1 runs as one process."""
    train, val = glmix
    out = tmp_path / "out"
    cfg = make_config(tmp_path, train, val, output_dir=str(out))
    for key in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError,
                       match=r"WORLD_SIZE=2 but RANK, MASTER_ADDR, "
                             r"MASTER_PORT not set: launch with torchrun"):
        run_cli(pt_train.main, cfg, tmp_path / "c.json", "--device", "cpu")
    # Refused before anything was read or written.
    assert not out.exists()
    monkeypatch.setenv("WORLD_SIZE", "1")
    rc, _ = run_cli(pt_train.main, cfg, tmp_path / "c.json", "--device",
                    "cpu", "--distributed")
    assert rc == 0 and (out / "fleet" / "obs-host-0" / "bundle.json").exists()


# The options of ROADMAP Queue A item 6 that raised until they were
# ported; each now trains through both CLIs.
FORMERLY_UNPORTED = [
    {"global": {"optimizer": {"type": "TRON"}}},
    {"global": {"optimizer": {"box_constraints": [-1, 1]}}},
    {"global": {"regularization": {"type": "L1", "weights": [1]}}},
    {"global": {"regularization": {"type": "ELASTIC_NET", "weights": [1]}}},
    {"per-user": {"variance_computation": "SIMPLE"}},
    {"global": {"down_sampling_rate": 0.5}},
]


def reference_box_constraints(monkeypatch):
    """The reference's config reader leaves ``box_constraints`` unread;
    hand it to the reference's OptimizerConfig as the port's reader
    does, so that both CLIs solve the same problem."""
    from photon_tpu.cli import config as jax_config

    parse = jax_config._parse_optimizer

    def with_box(d):
        box = d.get("box_constraints")
        cfg = parse(d)
        return cfg if box is None else dataclasses.replace(
            cfg, box_constraints=tuple(float(b) for b in box))

    monkeypatch.setattr(jax_config, "_parse_optimizer", with_box)


def reference_draws(monkeypatch):
    """The port's down-sampling draws replaced by the reference's
    (``jax.random.uniform(jax.random.key(seed), shape)``): the two
    generators differ, the masks that use them do not."""
    import jax

    from photon_tpu_torch.data import sampling

    monkeypatch.setattr(
        sampling, "draw_uniforms",
        lambda n, seed, like: torch.tensor(np.asarray(jax.random.uniform(
            jax.random.key(seed), (n,)))).to(like.device))


@pytest.mark.parametrize("overrides", FORMERLY_UNPORTED,
                         ids=["tron", "box", "l1", "elastic_net",
                              "variances", "down_sampling"])
def test_formerly_unported_options_match_the_reference(tmp_path, glmix,
                                                       overrides,
                                                       monkeypatch):
    """TRON, box constraints (L-BFGS-B), L1 and elastic net (OWL-QN),
    SIMPLE variances and down-sampling through both CLIs: the same
    summaries and best configuration, the models within FE_ATOL /
    RE_ATOL, the saved variances within rtol 1e-5 (f32 sums of the same
    squared-loss curvature, which does not depend on the coefficients),
    and each CLI's evaluation reproduced by the port."""
    train, val = glmix
    cfg = make_config(tmp_path, train, val)
    for key, value in overrides.items():
        cfg["coordinates"][key] = {**cfg["coordinates"][key], **value}
    reference_box_constraints(monkeypatch)
    if "down_sampling_rate" in overrides.get("global", {}):
        reference_draws(monkeypatch)
    runs = run_both(tmp_path, cfg)
    maps = single_bag_maps(train)
    assert_summaries_match(runs, val_dataset(val, maps), maps)
    pmodel, jmodel = load(runs["pt"][0], maps), load(runs["jax"][0], maps)
    assert_models_close(pmodel, jmodel)
    means = pmodel["global"].model.coefficients.means.numpy()
    if "box_constraints" in str(overrides):
        assert means.min() >= -1.0 and means.max() <= 1.0
        assert (np.abs(means) == 1.0).any(), "the box should bind"
    if "L1" in str(overrides) or "ELASTIC" in str(overrides):
        np.testing.assert_array_equal(
            means == 0.0,
            jmodel["global"].model.coefficients.means.numpy() == 0.0)
    if "variance_computation" in str(overrides):
        pv, jv = (m["per-user"].variances.numpy() for m in (pmodel, jmodel))
        assert np.isfinite(pv).any()
        np.testing.assert_allclose(pv, jv, rtol=1e-5)
    else:
        assert pmodel["per-user"].variances is None


def test_incremental_training_from_the_ports_own_model(tmp_path, glmix):
    """A first run with SIMPLE variances writes them to its Avro model
    and checkpoint (they read back equal); a second run with
    ``incremental_training`` and ``--init-model`` on the first run's
    best checkpoint trains with the prior, in each package from its own
    model; ``cli.score`` of each second model on the validation file
    agrees with the other's."""
    from photon_tpu.cli import score as jax_score
    from photon_tpu_torch.cli import score as pt_score
    from photon_tpu_torch.io.model_io import load_checkpoint

    train, val = glmix
    var = {"variance_computation": "SIMPLE"}
    cfg = make_config(tmp_path, train, val, num_iterations=1)
    for cid in ("global", "per-user"):
        cfg["coordinates"][cid] = {**cfg["coordinates"][cid], **var}
    (tmp_path / "first").mkdir()
    first = run_both(tmp_path / "first", cfg)
    maps = single_bag_maps(train)
    avro_model = load(first["pt"][0], maps)
    ckpt = load_checkpoint(str(first["pt"][0] / "models" / "best" /
                                "checkpoint.npz"), device="cpu")
    np.testing.assert_array_equal(
        avro_model["global"].model.coefficients.variances.numpy(),
        ckpt["global"].model.coefficients.variances.numpy())
    for m in (avro_model, ckpt):
        assert np.isfinite(m["per-user"].variances.numpy()).any()
    dense = {k: v for k, v in dense_coordinates(ckpt).items()}
    assert dense.keys() == {"global", "per-user"}

    inc = dict(cfg, incremental_training=True, num_iterations=1)
    runs = {}
    for side, main, extra in (("jax", None, ()),
                              ("pt", pt_train.main, ("--device", "cpu"))):
        from photon_tpu.cli import train as jax_train

        main = main or jax_train.main
        root = tmp_path / side
        root.mkdir()
        c = dict(inc, output_dir=str(root / "out"))
        rc, line = run_cli(main, c, root / "cfg.json", "--init-model",
                           str(first[side][0] / "models" / "best" /
                               "checkpoint.npz"), *extra)
        assert rc == 0, side
        runs[side] = (root / "out", line)
    assert_summaries_match(runs, val_dataset(val, maps), maps)
    second = load(runs["pt"][0], maps)
    assert_models_close(second, load(runs["jax"][0], maps))
    # The prior holds the refit near the first model.
    moved = np.abs(dense_coordinates(second)["global"]
                   - dense_coordinates(avro_model)["global"]).max()
    assert 0.0 < moved < 0.05
    scores = {}
    for side, main, extra in (("jax", jax_score.main, ("--mesh", "off")),
                              ("pt", pt_score.main, ("--device", "cpu"))):
        out = tmp_path / f"scores_{side}"
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["--model-dir", str(runs[side][0] / "models" /
                                            "best"),
                         "--input", str(val), "--output", str(out),
                         *extra]) == 0
        recs = avro.read_container_dir(str(out / "part-00000.avro"))
        scores[side] = np.array([r["predictionScore"] for r in recs])
    np.testing.assert_allclose(scores["pt"], scores["jax"], rtol=0,
                               atol=(D + 1) * FE_ATOL + RE_ATOL)


def test_yaml_config_and_its_absence(tmp_path, glmix, monkeypatch):
    """A YAML config trains as its JSON twin does; without PyYAML the
    error says to use JSON."""
    import sys

    from photon_tpu_torch.cli.config import TrainingConfig

    train, val = glmix
    cfg = make_config(tmp_path, train, val, output_dir=str(tmp_path / "o"))
    as_json = tmp_path / "c.json"
    as_json.write_text(json.dumps(cfg))
    as_yaml = tmp_path / "c.yaml"
    # JSON is a subset of YAML.
    as_yaml.write_text(json.dumps(cfg, indent=2))
    try:
        import yaml  # noqa: F401
    except ImportError:
        pass
    else:
        assert TrainingConfig.load(str(as_yaml)) == TrainingConfig.load(
            str(as_json))
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="as JSON"):
        TrainingConfig.load(str(as_yaml))
    assert TrainingConfig.load(str(as_json)).num_iterations == 2


# ---------------------------------------------------------------------------
# the modules under the CLI, against the JAX package's
# ---------------------------------------------------------------------------


def stats_features(rng, kind):
    """The same float64 features for both packages: dense, or ELL with
    padding slots, absent columns and a zero-weight row."""
    n, d = 60, 7
    if kind == "dense":
        x = rng.normal(size=(n, d))
        x[:, 3] = 0.0
        return (("dense", x),), d
    idx = np.stack([rng.choice(d - 1, size=3, replace=False)
                    for _ in range(n)]).astype(np.int32)
    val = rng.normal(size=(n, 3))
    val[::5, 2] = 0.0  # a padding slot
    return (("sparse", idx, val),), d


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_feature_statistics_match_the_reference(rng, kind):
    from photon_tpu.data import dataset as jax_ds
    from photon_tpu.stat import FeatureDataStatistics as JaxStats
    from photon_tpu_torch.data import dataset as pt_ds
    from photon_tpu_torch.stat import FeatureDataStatistics

    (spec,), d = stats_features(rng, kind)
    weights = rng.uniform(0.5, 2.0, size=60)
    weights[7] = 0.0
    if kind == "dense":
        jf = jax_ds.DenseFeatures(spec[1])
        pf = pt_ds.DenseFeatures(torch.tensor(spec[1]))
    else:
        jf = jax_ds.SparseFeatures(spec[1], spec[2], d)
        pf = pt_ds.SparseFeatures(torch.tensor(spec[1]),
                                  torch.tensor(spec[2]), d)
    want = JaxStats.from_features(jf, weights, intercept_index=d - 1)
    got = FeatureDataStatistics.from_features(pf, torch.tensor(weights),
                                              intercept_index=d - 1)
    for f in ("mean", "variance", "min", "max", "num_nonzeros", "norm_l1",
              "norm_l2"):
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    assert got.count == pytest.approx(want.count, rel=1e-12)
    assert got.intercept_index == d - 1


@pytest.mark.parametrize("kind", ["NONE", "SCALE_WITH_STANDARD_DEVIATION",
                                  "SCALE_WITH_MAX_MAGNITUDE",
                                  "STANDARDIZATION"])
def test_normalization_contexts_match_the_reference(rng, kind):
    import jax.numpy as jnp

    from photon_tpu.ops import normalization as jax_norm
    from photon_tpu_torch.ops import normalization as pt_norm

    d = 6
    stats = dict(mean=rng.normal(size=d), variance=rng.uniform(size=d),
                 min_=-rng.uniform(size=d), max_=rng.uniform(size=d))
    stats["variance"][2] = 0.0  # a constant column keeps factor 1
    stats["min_"][1] = stats["max_"][1] = 0.0
    want = jax_norm.build_normalization_context(
        jax_norm.NormalizationType(kind), intercept_index=d - 1,
        **{k: jnp.asarray(v) for k, v in stats.items()})
    got = pt_norm.build_normalization_context(
        pt_norm.NormalizationType(kind), intercept_index=d - 1,
        **{k: torch.tensor(v) for k, v in stats.items()})
    for f in ("factors", "shifts"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    assert got.intercept_index == want.intercept_index
    if kind != "NONE":
        w = torch.tensor(rng.normal(size=d))
        back = got.coef_to_original_space(got.coef_to_transformed_space(w))
        np.testing.assert_allclose(back.numpy(), w.numpy(), rtol=1e-12)


def test_libsvm_reader_matches_the_reference(tmp_path):
    from photon_tpu.data.libsvm import read_libsvm as jax_read
    from photon_tpu_torch.data.libsvm import read_libsvm

    path = tmp_path / "a.txt"
    path.write_text("# comment\n+1 1:0.5 3:-2\n-1 2:1.25 # tail\n\n"
                    "1 4:3 1:1\n")
    for kw in ({}, {"num_features": 6, "add_intercept": False}):
        want, got = jax_read(path, **kw), read_libsvm(path, device="cpu",
                                                      **kw)
        assert got.num_features == want.num_features
        for f in ("labels", "offsets", "weights"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        np.testing.assert_array_equal(got.features.indices.numpy(),
                                      np.asarray(want.features.indices))
        np.testing.assert_array_equal(got.features.values.numpy(),
                                      np.asarray(want.features.values))
    with pytest.raises(ValueError, match=">= 1"):
        path.write_text("1 0:1\n")
        read_libsvm(path, device="cpu")


def test_date_and_days_ranges_match_the_reference(tmp_path):
    import datetime

    from photon_tpu.io import paths as jax_paths
    from photon_tpu_torch.io import paths

    for day in ("2026/02/27", "2026/03/01", "2026/03/04"):
        (tmp_path / day).mkdir(parents=True)
    rng_ = paths.DateRange.from_string("20260226-20260303")
    assert paths.paths_for_date_range(str(tmp_path), rng_) == (
        jax_paths.paths_for_date_range(
            str(tmp_path), jax_paths.DateRange.from_string(
                "20260226-20260303")))
    today = datetime.date(2026, 3, 5)
    got = paths.DaysRange.from_string("6-1").to_date_range(today)
    want = jax_paths.DaysRange.from_string("6-1").to_date_range(today)
    assert (got.start, got.end) == (want.start, want.end)
    with pytest.raises(FileNotFoundError):
        paths.paths_for_date_range(
            str(tmp_path), paths.DateRange.from_string("20250101-20250102"))
    with pytest.raises(ValueError):
        paths.DateRange.from_string("20260303-20260301")


def test_fault_plans_fire_as_the_reference_does():
    """One seeded plan, both packages: the same calls fire."""
    from photon_tpu.resilience import faults as jax_faults

    plan = {"seed": 7, "faults": [
        {"point": "cd.iteration", "probability": 0.3, "error": "transient"},
        {"point": "checkpoint.write", "nth": 3, "error": "poison"}]}
    fired = {}
    for name, mod in (("jax", jax_faults), ("pt", faults)):
        with mod.injected(mod.FaultPlan.from_json(json.dumps(plan))):
            for _ in range(20):
                for point in ("cd.iteration", "checkpoint.write"):
                    try:
                        mod.check(point)
                    except RuntimeError:
                        pass
            fired[name] = mod.fired()
    assert fired["pt"] == fired["jax"] and len(fired["pt"]) > 1
    faults.check("cd.iteration")  # disarmed: nothing fires
    with pytest.raises(ValueError, match="unknown injection point"):
        faults.FaultSpec(point="nowhere", nth=1)


def test_checkpoints_load_across_the_packages(tmp_path):
    """A checkpoint directory the port writes loads in the JAX package
    and one the JAX package writes loads in the port, with the same
    arrays, cursor and flags."""
    from photon_tpu.resilience import checkpoint as jax_ckpt
    from photon_tpu_torch.io.model_io import (
        game_model_from_numpy,
        game_model_to_numpy,
    )
    from photon_tpu_torch.resilience import TrainingCheckpointer

    arrays = {"g/means": np.arange(4.0, dtype=np.float32),
              "u/coefficients": np.ones((3, 2), np.float32),
              "u/proj_all": np.array([[0, 1], [1, 2], [0, -1]])}
    manifest = {"g": {"kind": "fixed", "shard": "s",
                      "task": "LOGISTIC_REGRESSION"},
                "u": {"kind": "random", "re_type": "userId", "shard": "s",
                      "task": "LOGISTIC_REGRESSION",
                      "entity_keys": ["a", "b", "c"]}}
    model = game_model_from_numpy(arrays, manifest, "cpu")
    ck = TrainingCheckpointer(str(tmp_path / "pt"), "KEY")
    ck.save(model, config_index=0, iteration=0)
    ck.save(model, config_index=0, iteration=1)
    ck.save_config_final(model, config_index=0)
    assert ck.write_emergency().endswith("-interrupted.npz")
    theirs = jax_ckpt.load_training_checkpoint(str(tmp_path / "pt"))
    assert (theirs.config_index, theirs.iteration, theirs.interrupted,
            theirs.static_key) == (0, 1, True, "KEY")
    assert sorted(os.listdir(tmp_path / "pt")) == [
        "checkpoint-c000-i001-interrupted.npz", "config-c000-final.npz",
        "manifest.json"]
    jck = jax_ckpt.TrainingCheckpointer(str(tmp_path / "jax"), "KEY2")
    jck.save(theirs.model, config_index=1, iteration=2)
    ours = load_training_checkpoint(str(tmp_path / "jax"), "cpu")
    assert (ours.config_index, ours.iteration, ours.interrupted) == (
        1, 2, False)
    got, _ = game_model_to_numpy(ours.model)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)


def test_train_cli_runs_on_cuda_unless_asked_for_the_cpu(tmp_path, glmix):
    """No fallback: without ``--device cpu`` the CLI trains on ``cuda``
    and, on a machine without a GPU, raises instead of training on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the default resolves to it")
    train, val = glmix
    cfg = make_config(tmp_path, train, val, output_dir=str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_cli(pt_train.main, cfg, tmp_path / "c.json")
    assert not (tmp_path / "o" / "models").exists()


# ---------------------------------------------------------------------------
# hyperparameter tuning (ROADMAP Queue A item 11): the cases 10-item11 and
# 17-item11 of the unported list above now train through both CLIs.
# ---------------------------------------------------------------------------

BAD_GRID = {"type": "fixed", "regularization": {
    "type": "L2", "weights": [1e4], "weight_range": [1e-4, 1e4]}}


def tuned_lambdas(out_dir) -> list:
    return [c["config"]["global"]["lambda"]
            for c in summary(out_dir)["configurations"]]


def test_tuning_improves_over_bad_grid(tmp_path, glmix):
    """``TestHyperparameterTuningCLI::test_tuning_improves_over_bad_grid``
    through both CLIs: RANDOM tuning over the fixed effect's
    ``weight_range`` evaluates 4 more configurations, the same lambdas
    bit for bit (the same Sobol draws), and the selected model beats the
    badly over-regularized grid's."""
    train, val = glmix
    cfg = make_config(tmp_path, train, val, coordinates={"global": BAD_GRID},
                      hyperparameter_tuning={"mode": "RANDOM",
                                             "iterations": 4, "seed": 7})
    runs = run_both(tmp_path, cfg)
    maps = single_bag_maps(train)
    assert_summaries_match(runs, val_dataset(val, maps), maps)
    assert tuned_lambdas(runs["pt"][0]) == tuned_lambdas(runs["jax"][0])
    s = summary(runs["pt"][0])
    assert s["num_configurations"] == 5  # 1 grid + 4 tuned
    assert s["num_tuned_configurations"] == 4
    assert summary(runs["jax"][0])["num_tuned_configurations"] == 4
    rmses = [c["evaluation"]["RMSE"] for c in s["configurations"]]
    # The grid model is badly over-regularized; tuning must beat it.
    assert min(rmses[1:]) < rmses[0]
    assert s["best_configuration_index"] != 0
    assert_models_close(load(runs["pt"][0], maps), load(runs["jax"][0], maps))


@pytest.mark.parametrize("mode", ["EXPLICIT", "TUNED"])
def test_tuned_and_explicit_output_modes(tmp_path, glmix, mode):
    """``TestObservability::test_output_modes``'s EXPLICIT and TUNED
    cases through both CLIs: a grid of two and two RANDOM candidates;
    EXPLICIT saves the best and the grid's models, never a tuned one,
    TUNED the best and the tuned ones; both packages save the same
    directories."""
    train, val = glmix
    cfg = make_config(
        tmp_path, train, val, model_output_mode=mode,
        coordinates={"global": {"type": "fixed", "regularization": {
            "type": "L2", "weights": [100.0, 0.01]}}},
        hyperparameter_tuning={"mode": "RANDOM", "iterations": 2,
                               "seed": 3})
    runs = run_both(tmp_path, cfg)
    dirs = {side: {p.name for p in (runs[side][0] / "models").iterdir()}
            for side in runs}
    assert dirs["pt"] == dirs["jax"]
    assert "best" in dirs["pt"]
    assert summary(runs["pt"][0])["num_configurations"] == 4
    if mode == "EXPLICIT":
        # Grid indices 0-1; the tuned models (2-3) never get a config dir.
        assert not {"config_2", "config_3"} & dirs["pt"]
        assert dirs["pt"] - {"best"} <= {"config_0", "config_1"}
    else:
        assert not {"config_0", "config_1"} & dirs["pt"]
        assert dirs["pt"] - {"best"} <= {"config_2", "config_3"}
    maps = single_bag_maps(train)
    assert_summaries_match(runs, val_dataset(val, maps), maps,
                           sorted(dirs["pt"]))


def test_bayesian_tuning_in_float64_matches_the_reference(tmp_path, glmix,
                                                          monkeypatch):
    """A BAYESIAN run of both CLIs with both packages' readers in float64
    (the fits in float64 on each side): the same best configuration
    index, and every configuration's lambda within 1e-9 (its candidate
    comes from a GP over evaluations that agree to rounding)."""
    from test_torch_glm_cli import float64_readers

    train, val = glmix
    cfg = make_config(tmp_path, train, val, coordinates={"global": BAD_GRID},
                      hyperparameter_tuning={"mode": "BAYESIAN",
                                             "iterations": 4, "seed": 5})
    with float64_readers(monkeypatch):
        runs = run_both(tmp_path, cfg)
    js, ps = summary(runs["jax"][0]), summary(runs["pt"][0])
    assert ps["best_configuration_index"] == js["best_configuration_index"]
    assert ps["num_tuned_configurations"] == 4
    np.testing.assert_allclose(tuned_lambdas(runs["pt"][0]),
                               tuned_lambdas(runs["jax"][0]), rtol=1e-9)
    for jc, pc in zip(js["configurations"], ps["configurations"],
                      strict=True):
        assert pc["evaluation"]["RMSE"] == pytest.approx(
            jc["evaluation"]["RMSE"], rel=1e-9)


def incremental_tuning(package: str, rng_seed: int = 20260729) -> list:
    """``TestIncrementalWithTuning`` in one package, float64 on the CPU:
    a prior model, an incremental refit on new rows, then two RANDOM
    candidates each retrained with the prior forwarded. Returns each
    candidate's (lambdas, RMSE)."""
    import importlib

    jax_side = package == "photon_tpu"
    pkg = importlib.import_module(package)
    problems = importlib.import_module(f"{package}.algorithm.problems")
    dataset = importlib.import_module(f"{package}.data.dataset")
    game_data = importlib.import_module(f"{package}.data.game_data")
    re_data = importlib.import_module(f"{package}.data.random_effect")
    ge = importlib.import_module(f"{package}.estimators.game_estimator")
    hp = importlib.import_module(f"{package}.hyperparameter")
    tuner = importlib.import_module(f"{package}.hyperparameter.tuner")
    task = importlib.import_module(f"{package}.types").TaskType
    if jax_side:
        import jax.numpy as jnp

        dtype, kw = jnp.float64, {}
    else:
        dtype, kw = torch.float64, {"device": "cpu"}
    rng = np.random.default_rng(rng_seed)
    w, u_eff = rng.normal(size=4), rng.normal(size=6)

    def data(seed, n=600):
        r = np.random.default_rng(seed)
        x = r.normal(size=(n, 4))
        uid = r.integers(0, 6, size=n)
        y = x @ w + u_eff[uid] + 0.05 * r.normal(size=n)
        return game_data.make_game_dataset(
            y, {"shard": dataset.DenseFeatures(x),
                "bias": dataset.DenseFeatures(np.ones((n, 1)))},
            id_tags={"userId": uid}, dtype=dtype, **kw)

    l2 = pkg.optim.RegularizationContext(pkg.optim.RegularizationType.L2)
    simple = problems.VarianceComputationType.SIMPLE

    def estimator(incremental, **extra):
        return ge.GameEstimator(task.LINEAR_REGRESSION, {
            "global": ge.FixedEffectCoordinateConfiguration(
                "shard", problems.GLMOptimizationConfiguration(
                    regularization=l2, regularization_weight=1e-3,
                    variance_computation=simple)),
            "per-user": ge.RandomEffectCoordinateConfiguration(
                re_data.RandomEffectDataConfiguration("userId", "bias"),
                problems.GLMOptimizationConfiguration(
                    regularization=l2, regularization_weight=0.1,
                    variance_computation=simple))},
            num_iterations=2, incremental_training=incremental, **extra,
            **kw)

    prior = estimator(False).fit(data(3))[0].model
    train2, val = data(4), data(5)
    est = estimator(True, evaluators=["RMSE"])
    base = est.fit(train2, val, initial_model=prior)[0]
    fn = hp.GameEstimatorEvaluationFunction(
        est, base.config, train2, val, is_opt_max=False,
        initial_model=prior)
    tuned = tuner.search(2, fn.num_params, "RANDOM", fn,
                         fn.convert_observations([base]), seed=1)
    return [({cid: c.regularization_weight for cid, c in r.config.items()},
             r.evaluation.primary_evaluation) for r in tuned]


def test_tuner_retrains_forward_the_initial_model():
    """``TestIncrementalWithTuning``: with ``incremental_training`` the
    tuner's candidates forward the initial model into each retrain
    (instead of failing the validation invariant) and are evaluated;
    both packages, in float64, draw the same lambdas and evaluate them
    within 1e-9."""
    got = incremental_tuning("photon_tpu_torch")
    want = incremental_tuning("photon_tpu")
    assert len(got) == len(want) == 2
    for (g_lams, g_rmse), (w_lams, w_rmse) in zip(got, want):
        assert g_lams == w_lams
        assert np.isfinite(g_rmse)
        assert g_rmse == pytest.approx(w_rmse, rel=1e-9)


@pytest.mark.parametrize("case", ["no_validation", "nothing_tunable"])
def test_tuning_is_skipped_without_validation_or_a_tunable_coordinate(
        tmp_path, glmix, case, caplog):
    """Both CLIs warn and skip the tuner when the config has no
    validation file, or no coordinate with an L1, L2 or elastic-net
    weight to tune: the grid's configurations only, none tuned."""
    train, val = glmix
    cfg = make_config(tmp_path, train, None if case == "no_validation"
                      else val,
                      hyperparameter_tuning={"mode": "RANDOM",
                                             "iterations": 3, "seed": 1})
    if case == "nothing_tunable":
        for c in cfg["coordinates"].values():
            c["regularization"] = {"type": "NONE"}
    with caplog.at_level("WARNING"):
        runs = run_both(tmp_path, cfg)
    assert caplog.text.count("skipping") == 2
    for side in runs:
        s = summary(runs[side][0])
        assert (s["num_configurations"], s["num_tuned_configurations"]) == (
            1, 0), side
