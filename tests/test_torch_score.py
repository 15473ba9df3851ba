"""The port's batch-scoring slice against the JAX package's, on the CPU.

Seeded TrainingExampleAvro files (three feature bags, user and movie ids
in the metadata, 10% cold users) and GAME model directories go through
both packages: the rung ladder's ``score_dataset``, the whole
``cli.score.main`` (the reference with ``--mesh off``, so that it takes
its ladder route too), ``GameTransformer``, the evaluators and the data
validators. The JAX side is imported where it is used, so that the
tests marked ``cuda`` run on a machine that has no JAX.

Tolerances:
- f32 scores: 1e-5 (the same f32 products summed in another order);
- f64 scores (``GameTransformer`` on float64 data and models): 1e-9;
- ``evaluation.json``: 5e-6 relative. Both packages evaluate in the
  labels' dtype, f32 from the Avro readers, and differ only in the order
  of their f32 sums. Over these 300 rows a running sum of weighted
  credits rounds at about sqrt(300) u ~ 1e-6 (u = 2**-24), and a metric
  combines a few such sums; the largest difference seen is 2.9e-6
  relative (AUC:userId, the mean of 12 groups' AUCs);
- evaluators on float64 arrays: 1e-12 relative (the same sums in another
  order);
- the kernel against its plain version on the card: 1e-5 (f32) and 5e-2
  (bf16), the serving gates.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from photon_tpu_torch.cli import score as score_cli
from photon_tpu_torch.cli import serve as serve_cli
from photon_tpu_torch.cli.index import (
    build_shard_vocabularies,
    parse_shard_spec,
)
from photon_tpu_torch.data.index_map import IndexMap
from photon_tpu_torch.evaluation import evaluators as ev
from photon_tpu_torch.evaluation.suite import encode_group_ids, make_suite
from photon_tpu_torch.io import avro, avro_data, model_io
from photon_tpu_torch.ops import _build
from photon_tpu_torch.ops import newton_kernel as nk
from photon_tpu_torch.ops import segment_reduce as sr
from photon_tpu_torch.ops import serve_kernel
from photon_tpu_torch.serve.programs import (
    ScorePrograms,
    ShapeLadder,
    specs_from_dataset,
)
from photon_tpu_torch.serve.tables import (
    CoefficientTables,
    build_index_maps_from_model,
)
from photon_tpu_torch.transformers import GameTransformer
from photon_tpu_torch.types import TaskType, make_feature_key

SHARD_SPEC = ["global=features", "userShard=userFeatures",
              "movieShard=movieFeatures"]
ID_TAGS = ["userId", "movieId"]
EVALUATORS = ["AUC", "RMSE", "AUC:userId"]
DG, DU, DM = 10, 6, 4
USERS, MOVIES = 12, 5
F32, F64 = 1e-5, 1e-9
EVAL_REL = 5e-6
# The GPU run's evaluation.json against the CPU run's, relative: both
# f32, in another order. The largest difference read on an NVIDIA H100
# 80GB HBM3 (700 W) was 3.4e-7 (AUC:userId; AUC 1.8e-7, RMSE 6.2e-8);
# the bound is about six times that.
GPU_CPU_EVAL_REL = 2e-6


def write_data(path, n, seed=0, cold=0.1):
    """A TrainingExampleAvro file: 1-4 global features (some with a
    term), 1-3 user and 1-2 movie features per row."""
    rng = np.random.default_rng(seed)

    def rows(prefix, width, most):
        return [[(make_feature_key(f"{prefix}{j}", "t" if j % 3 == 0
                                   else ""), float(rng.normal()))
                 for j in rng.choice(width, size=rng.integers(1, most + 1),
                                     replace=False)]
                for _ in range(n)]

    meta = [{"userId": (f"user{rng.integers(0, USERS)}"
                        if rng.uniform() > cold else f"cold{i}"),
             "movieId": f"movie{rng.integers(0, MOVIES)}"}
            for i in range(n)]
    avro_data.write_training_examples(
        str(path), (rng.uniform(size=n) < 0.4).astype(float),
        rows("g", DG, 4), offsets=rng.normal(size=n) * 0.1,
        weights=rng.uniform(0.5, 2.0, size=n), metadata=meta,
        uids=[f"r{i}" for i in range(n)],
        bags={"userFeatures": rows("u", DU, 3),
              "movieFeatures": rows("m", DM, 2)},
    )


def data_maps(path, spec=SHARD_SPEC):
    """The index maps the scoring CLI builds from the data."""
    recs = avro.read_container_dir(str(path))
    return {s: IndexMap.from_feature_names(
        [make_feature_key(n, t) for n, t in pairs])
        for s, pairs in build_shard_vocabularies(
            recs, parse_shard_spec(spec)).items()}


def model_arrays(maps, seed=1, extra=0, shards=None):
    """Checkpoint-keyed arrays of a logistic GLMix over ``maps``: a fixed
    effect on ``global``, per-user (12 users) and per-movie (5 movies)
    coordinates, and ``extra`` more random coordinates alternating
    between the two id types, each with its own entity vocabulary.
    ``shards`` renames every coordinate's shard (one-shard models)."""
    rng = np.random.default_rng(seed)
    task = "LOGISTIC_REGRESSION"
    gshard = shards or "global"
    arrays = {"global/means": rng.normal(size=len(maps[gshard]))}
    manifest = {"global": {"kind": "fixed", "shard": gshard, "task": task}}
    coords = [("per-user", "userId", "userShard", "user", USERS),
              ("per-movie", "movieId", "movieShard", "movie", MOVIES)]
    for i in range(extra):
        user = i % 2 == 0
        coords.append((f"extra-{i}", "userId" if user else "movieId",
                       "userShard" if user else "movieShard",
                       "user" if user else "movie",
                       USERS - i // 2 if user else MOVIES))
    for name, rt, shard, key, e in coords:
        shard = shards or shard
        d = len(maps[shard])
        s = max(1, d - 1 - len(arrays) % 2)
        proj = np.stack([np.sort(rng.choice(d, size=s, replace=False))
                         for _ in range(e)]).astype(np.int64)
        arrays[f"{name}/coefficients"] = rng.normal(size=(e, s)) * 0.5
        arrays[f"{name}/proj_all"] = proj
        keys = [f"{key}{j}" for j in rng.permutation(e)]
        manifest[name] = {"kind": "random", "re_type": rt, "shard": shard,
                          "task": task, "entity_keys": keys}
    return arrays, manifest


def f32(arrays):
    """The model's coefficients in float32, as a serving model holds
    them (the JAX package keeps float64 tables as they are)."""
    return {k: v.astype(np.float32) if v.dtype.kind == "f" else v
            for k, v in arrays.items()}


@pytest.fixture
def files(tmp_path):
    """(data path, model directory, index maps, arrays, manifest)."""
    data = tmp_path / "data.avro"
    write_data(data, 300)
    maps = data_maps(data)
    arrays, manifest = model_arrays(maps)
    model = model_io.game_model_from_numpy(arrays, manifest, "cpu")
    model_io.save_game_model(model, str(tmp_path / "model"), maps)
    return data, tmp_path / "model", maps, arrays, manifest


def jax_model(tmp_path, arrays, manifest, name="bridge"):
    """The same model in the JAX package, through the npz checkpoint."""
    from photon_tpu.io import model_io as jax_model_io

    return jax_model_io.load_checkpoint(model_io.save_checkpoint(
        model_io.game_model_from_numpy(arrays, manifest, "cpu"),
        str(tmp_path / f"{name}.npz")))


def port_data(path, maps, dtype=torch.float32):
    data, _ = avro_data.read_merged(
        str(path), feature_shards=parse_shard_spec(SHARD_SPEC),
        index_maps=maps, id_tag_names=ID_TAGS, dtype=dtype, device="cpu")
    return data


def jax_data(path, maps, dtype=None):
    import jax.numpy as jnp

    from photon_tpu.data.index_map import IndexMap as JaxIndexMap
    from photon_tpu.io import avro_data as jax_avro_data

    data, _ = jax_avro_data.read_merged(
        str(path), feature_shards=parse_shard_spec(SHARD_SPEC),
        index_maps={s: JaxIndexMap(dict(m.items())) for s, m in maps.items()},
        id_tag_names=ID_TAGS, dtype=dtype or jnp.float32)
    return data


def read_scores(path):
    recs = avro.read_container_dir(str(path))
    return recs, np.array([r["predictionScore"] for r in recs])


@pytest.mark.parametrize("n", [1, 7, 1023, 1024, 1025, 8192, 8193, 20000])
@pytest.mark.parametrize("rungs", [score_cli.BATCH_RUNGS, (1, 8, 64, 512)])
def test_chunk_plan_matches_the_reference(rungs, n):
    from photon_tpu.serve.programs import ShapeLadder as JaxLadder

    plan = ShapeLadder(rungs).chunk_plan(n)
    assert plan == JaxLadder(rungs).chunk_plan(n)
    assert sum(hi - lo for lo, hi, _ in plan) == n


@pytest.mark.parametrize("mode", ["unset", "force"])
def test_score_dataset_matches_the_reference(tmp_path, monkeypatch, files,
                                             mode):
    """The rung ladder of both packages over the same dataset: the JAX
    side with the switch unset (its XLA chain) on the batch ladder, and
    with ``force`` (its Pallas body, interpreted) on a small ladder."""
    from photon_tpu.serve.programs import ScorePrograms as JaxPrograms
    from photon_tpu.serve.programs import ShapeLadder as JaxLadder
    from photon_tpu.serve.programs import (
        specs_from_dataset as jax_specs_from_dataset,
    )
    from photon_tpu.serve.tables import CoefficientTables as JaxTables

    path, _, maps, arrays, manifest = files
    arrays = f32(arrays)
    rungs = score_cli.BATCH_RUNGS if mode == "unset" else (8, 64)
    if mode == "force":
        monkeypatch.setenv("PHOTON_SERVE_KERNEL", "force")
    data = port_data(path, maps)
    model = model_io.game_model_from_numpy(arrays, manifest, "cpu")
    tables = CoefficientTables.from_game_model(model, "float32", "cpu")
    progs = ScorePrograms(tables, ladder=ShapeLadder(rungs),
                          specs=specs_from_dataset(data))
    got = progs.score_dataset(data)
    jdata = jax_data(path, maps)
    jprogs = JaxPrograms(JaxTables.from_game_model(
        jax_model(tmp_path, arrays, manifest)), ladder=JaxLadder(rungs),
        specs=jax_specs_from_dataset(jdata), compile_now=False)
    assert jprogs.use_kernel == (mode == "force")
    ref = jprogs.score_dataset(jdata)
    assert got.shape == (300,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=F32, rtol=0)
    assert progs.stats["serve_kernel"] == "plain"
    assert progs.stats["dispatches"] == jprogs.stats["dispatches"]
    # The same rows through the port's own GameTransformer.
    np.testing.assert_allclose(
        got, GameTransformer(model).score(data).numpy(), atol=F32, rtol=0)


def _run_cli(module, model_dir, data, out, *extra):
    return module.main([
        "--model-dir", str(model_dir), "--input", str(data),
        "--output", str(out), "--evaluators", *EVALUATORS, *extra])


@pytest.mark.parametrize("layout", ["bags", "single"])
def test_score_cli_matches_the_reference(tmp_path, files, capsys, layout):
    from photon_tpu.cli import score as jax_score_cli

    if layout == "bags":
        data, model_dir = files[0], files[1]
        extra = ["--feature-shards", *SHARD_SPEC, "--id-tags", *ID_TAGS]
    else:
        # One feature bag and a model on one shard id other than
        # "features": the CLI aliases the table under the model's name.
        data = tmp_path / "single.avro"
        write_data(data, 200, seed=5)
        maps = data_maps(data, ["global=features", "userShard=features",
                                "movieShard=features"])
        arrays, manifest = model_arrays(maps, seed=6, shards="global")
        model_dir = tmp_path / "single-model"
        model_io.save_game_model(
            model_io.game_model_from_numpy(arrays, manifest, "cpu"),
            str(model_dir), maps)
        extra = ["--id-tags", *ID_TAGS]
    assert _run_cli(score_cli, model_dir, data, tmp_path / "ours", *extra,
                    "--device", "cpu", "--data-validation", "FULL") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _run_cli(jax_score_cli, model_dir, data, tmp_path / "theirs",
                    *extra, "--mesh", "off") == 0
    ours, s_ours = read_scores(tmp_path / "ours" / "part-00000.avro")
    theirs, s_theirs = read_scores(tmp_path / "theirs" / "part-00000.avro")
    assert len(ours) == len(theirs) == (300 if layout == "bags" else 200)
    for a, b in zip(ours, theirs):
        assert {k: v for k, v in a.items() if k != "predictionScore"} == {
            k: v for k, v in b.items() if k != "predictionScore"}
    np.testing.assert_allclose(s_ours, s_theirs, atol=F32, rtol=0)
    ev_ours = json.loads((tmp_path / "ours" / "evaluation.json").read_text())
    ev_theirs = json.loads(
        (tmp_path / "theirs" / "evaluation.json").read_text())
    assert list(ev_ours) == list(ev_theirs) == EVALUATORS
    for k in EVALUATORS:
        assert ev_ours[k] == pytest.approx(ev_theirs[k], rel=EVAL_REL)
    assert line["evaluation"] == ev_ours
    assert line["serve_kernel"] == "plain" and line["device"] == "cpu"
    assert line["chunks"] == 1 and line["dispatches"]["1024"] == 1
    assert set(line["seconds"]) == {
        "decode", "index_build", "dataset_build", "model_load",
        "validation", "tables", "score", "evaluation", "write"}


def test_score_cli_refusals(tmp_path, files):
    data, model_dir = files[0], files[1]
    out = tmp_path / "o"
    # A mesh larger than the process group (one process here) raises
    # with the reference's words; mesh scoring runs on spawned ranks in
    # tests/test_torch_mesh_ranks.py.
    with pytest.raises(ValueError, match="mesh setting requests 4 devices "
                                         "but only 1 are visible"):
        _run_cli(score_cli, model_dir, data, out, "--device", "cpu",
                 "--mesh", "4", "--feature-shards", *SHARD_SPEC)
    with pytest.raises(ValueError, match="multiple feature shards"):
        _run_cli(score_cli, model_dir, data, out, "--device", "cpu")
    with pytest.raises(ValueError, match="only defines"):
        _run_cli(score_cli, model_dir, data, out, "--device", "cpu",
                 "--feature-shards", "global=features")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _run_cli(score_cli, model_dir, data, out,
                     "--feature-shards", *SHARD_SPEC)


def test_batch_scoring_raises_for_a_shard_with_no_row_layout():
    """A shard that is neither dense nor ELL (the dual-ELL layout) has
    no per-row serving layout: ``specs_from_dataset`` raises
    ``TypeError`` with the reference's words, and the batch scorer
    scores such a dataset through ``GameTransformer``, as the
    reference's does."""
    import types

    from test_torch_dual_ell import _dual_estimators, dual_games

    data = types.SimpleNamespace(feature_shards={"features": object()})
    with pytest.raises(TypeError, match="no fixed per-row serving layout"):
        specs_from_dataset(data)
    game_dual, game_sparse, _ = dual_games(np.random.default_rng(17))
    model = _dual_estimators(listener=True)[1].fit(game_sparse)[0].model
    with pytest.raises(TypeError, match="DualEll tails span rows"):
        specs_from_dataset(game_dual)
    report: dict = {}
    scores, _ = score_cli.score_game_dataset(model, game_dual,
                                             report=report)
    assert report["serve_kernel"] == "transformer"
    np.testing.assert_allclose(
        scores, GameTransformer(model).score(game_sparse).numpy(),
        rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_game_transformer_matches_the_reference(tmp_path, files, dtype):
    import jax.numpy as jnp

    from photon_tpu.transformers import GameTransformer as JaxTransformer

    path, _, maps, arrays, manifest = files
    tdt = torch.float32 if dtype == "float32" else torch.float64
    data = port_data(path, maps, tdt)
    jdata = jax_data(path, maps, jnp.float32 if dtype == "float32"
                     else jnp.float64)
    model = model_io.game_model_from_numpy(
        f32(arrays) if dtype == "float32" else arrays, manifest, "cpu")
    jmodel = jax_model(tmp_path, *model_io.game_model_to_numpy(model))
    scores, evaluation = GameTransformer(model).transform(data, EVALUATORS)
    jscores, jevaluation = JaxTransformer(jmodel).transform(jdata,
                                                            EVALUATORS)
    assert scores.dtype == tdt
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=F32 if dtype == "float32" else F64,
                               rtol=0)
    for k in EVALUATORS:
        assert evaluation.evaluations[k] == pytest.approx(
            jevaluation.evaluations[k], rel=EVAL_REL)
    # On a mesh (here one rank) the scores are the same; a mesh that is
    # not a parallel.mesh.Mesh is refused.
    from photon_tpu_torch.parallel.mesh import Mesh

    np.testing.assert_allclose(
        GameTransformer(model, mesh=Mesh(0, 1, torch.device("cpu"))).score(
            data).numpy(),
        scores.numpy(), rtol=1e-12, atol=1e-12)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh or None"):
        GameTransformer(model, mesh=object())


def _metric_inputs(seed=9, n=400, groups=15):
    """Scores with heavy ties, weights, labels, and groups of which two
    have one class only and one id has no row."""
    rng = np.random.default_rng(seed)
    s = np.round(rng.normal(size=n), 1)
    y = (rng.uniform(size=n) < 0.45).astype(np.float64)
    w = rng.uniform(0.1, 3.0, size=n)
    g = rng.integers(0, groups - 1, size=n)
    y[g == 0] = 1.0
    y[g == 1] = 0.0
    return s, y, w, g, groups


def test_evaluation_runs_in_the_labels_dtype_as_the_reference():
    """``evaluate_scores`` builds its suite in the labels' dtype, as the
    reference's does. On 5,000 f32 rows the f32 AUC differs from the
    exact float64 one by 1.5e-6, the size of the difference between the
    port's old float64 evaluation and the reference's; the port's f32
    AUC is now within a few f32 ulps (3e-7) of the reference's, and a
    float64 dataset still evaluates in float64."""
    import jax.numpy as jnp

    from photon_tpu.data import dataset as jax_ds
    from photon_tpu.data import game_data as jax_gd
    from photon_tpu.transformers import evaluate_scores as jax_evaluate
    from photon_tpu_torch.data import dataset as pt_ds
    from photon_tpu_torch.data import game_data as pt_gd
    from photon_tpu_torch.transformers import evaluate_scores

    n = 5000
    rng = np.random.default_rng(2)
    y = (rng.uniform(size=n) < 0.4).astype(float)
    w = rng.uniform(0.5, 2.0, size=n)
    z = (rng.normal(size=n) + y).astype(np.float32)
    users = rng.integers(0, 50, size=n)
    x = rng.normal(size=(n, 2))

    def port(dtype):
        data = pt_gd.make_game_dataset(
            y, {"f": pt_ds.DenseFeatures(x)}, weights=w,
            id_tags={"userId": users}, dtype=dtype, device="cpu")
        return evaluate_scores(data, torch.from_numpy(z).to(dtype),
                               ["AUC"]).evaluations["AUC"]

    jdata = jax_gd.make_game_dataset(
        y, {"f": jax_ds.DenseFeatures(x)}, weights=w,
        id_tags={"userId": users}, dtype=jnp.float32)
    theirs = jax_evaluate(jdata, jnp.asarray(z), ["AUC"]).evaluations["AUC"]
    exact = ev.auc_roc(torch.from_numpy(z).double(),
                       torch.from_numpy(y), torch.from_numpy(w)).item()
    assert port(torch.float64) == pytest.approx(exact, rel=1e-12)
    assert abs(theirs - exact) > 1e-6
    assert abs(port(torch.float32) - theirs) <= 3e-7


SINGLE = [t.value for t in ev.EvaluatorType]
METRICS = (SINGLE + ["PRECISION=0.5", "RECALL=0.3", "F1=0.6",
                     "ACCURACY=0.45", "AUC:group", "PRECISION@1:group",
                     "PRECISION@3:group"])


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("metric", METRICS)
def test_evaluators_match_the_reference(metric, weighted):
    import jax.numpy as jnp

    from photon_tpu.evaluation.suite import make_suite as jax_make_suite

    s, y, w, g, groups = _metric_inputs()
    if metric == "POISSON_LOSS":
        y = np.round(np.abs(y * 3 + s))
    if metric in ("SQUARED_LOSS", "RMSE", "MAE", "MSE"):
        y = y + s * 0.3
    weights = w if weighted else None
    ours = make_suite([metric], torch.from_numpy(y), weights=(
        None if weights is None else torch.from_numpy(weights)),
        group_ids={"group": (torch.from_numpy(g), groups)})
    theirs = jax_make_suite([metric], jnp.asarray(y), weights=(
        None if weights is None else jnp.asarray(weights)),
        group_ids={"group": (jnp.asarray(g), groups)},
        dtype=jnp.float64)
    got = ours.evaluate(torch.from_numpy(s)).evaluations
    want = theirs.evaluate(jnp.asarray(s)).evaluations
    assert list(got) == list(want)
    for k in got:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15), k
    if ":" in metric:
        per = ours.evaluate_per_group(torch.from_numpy(s))
        jper = theirs.evaluate_per_group(jnp.asarray(s))
        np.testing.assert_allclose(per[metric], jper[metric], rtol=1e-12)
        if metric == "AUC:group":
            # The single-class groups and the empty group are undefined.
            assert np.isnan(per[metric][[0, 1, groups - 1]]).all()


def test_evaluator_specs_and_group_codes_match_the_reference():
    from photon_tpu.evaluation.evaluators import EvaluatorSpec as JaxSpec
    from photon_tpu.evaluation.suite import (
        encode_group_ids as jax_encode_group_ids,
    )

    for spec in METRICS + ["auc", "precision@5:q", "f1=0.25"]:
        ours, theirs = ev.EvaluatorSpec.parse(spec), JaxSpec.parse(spec)
        assert ours.name == theirs.name
        assert ours.bigger_is_better == theirs.bigger_is_better
    for bad in ("F1=0.5:q", "FOO=0.5", "F1=1.5", "NOPE"):
        with pytest.raises(ValueError):
            ev.EvaluatorSpec.parse(bad)
    raw = np.array(["b", "a", "c", "a", "b"])
    codes, num, vocab = encode_group_ids(raw)
    jcodes, jnum, jvocab = jax_encode_group_ids(raw)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert (num, vocab) == (jnum, jvocab)


VALIDATION_CASES = ["clean", "nan-feature", "zero-weight", "inf-offset",
                    "bad-label", "many"]


@pytest.mark.parametrize("vtype", ["FULL", "SAMPLE", "DISABLED"])
@pytest.mark.parametrize("case", VALIDATION_CASES)
def test_sanity_check_verdicts_match_the_reference(case, vtype):
    import jax.numpy as jnp

    from photon_tpu.data.dataset import SparseFeatures as JaxSparse
    from photon_tpu.data.game_data import (
        make_game_dataset as jax_make_game_dataset,
    )
    from photon_tpu.data.validators import (
        sanity_check_data as jax_sanity_check_data,
    )
    from photon_tpu.types import TaskType as JaxTask
    from photon_tpu_torch.data.dataset import SparseFeatures
    from photon_tpu_torch.data.game_data import make_game_dataset
    from photon_tpu_torch.data.validators import sanity_check_data

    rng = np.random.default_rng(10)
    n = 40
    y = rng.integers(0, 2, size=n).astype(float)
    idx = rng.integers(0, 5, size=(n, 3)).astype(np.int32)
    val = rng.normal(size=(n, 3))
    off = np.zeros(n)
    w = np.ones(n)
    rows = np.arange(n) if case == "many" else np.array([3])
    if case in ("nan-feature", "many"):
        val[rows, 1] = np.nan
    if case in ("zero-weight", "many"):
        w[rows] = 0.0
    if case in ("inf-offset", "many"):
        off[rows] = np.inf
    if case in ("bad-label", "many"):
        y[rows] = 0.5
    data = make_game_dataset(y, {"s": SparseFeatures(idx, val, 5)},
                             offsets=off, weights=w, device="cpu")
    jdata = jax_make_game_dataset(
        y, {"s": JaxSparse(idx, val.astype(np.float32), 5)}, offsets=off,
        weights=w, dtype=jnp.float32)
    for check_labels in (True, False):
        outcomes = []
        for fn, d, task in (
                (sanity_check_data, data, TaskType.LOGISTIC_REGRESSION),
                (jax_sanity_check_data, jdata,
                 JaxTask.LOGISTIC_REGRESSION)):
            try:
                fn(d, task, vtype, check_labels=check_labels)
                outcomes.append(None)
            except ValueError as exc:
                outcomes.append(str(exc))
        assert outcomes[0] == outcomes[1]
        if vtype == "FULL":
            assert (outcomes[0] is None) == (
                case == "clean" or (case == "bad-label"
                                    and not check_labels))


def test_twelve_coordinates_match_the_reference_chain(tmp_path, files):
    """One ScorePrograms serves 12 active coordinates (a fixed effect
    and 11 random ones, two coordinates per id type sharing no entity
    vocabulary) and matches the JAX package's per-coordinate chain."""
    from photon_tpu.serve.programs import ScorePrograms as JaxPrograms
    from photon_tpu.serve.programs import ShapeLadder as JaxLadder
    from photon_tpu.serve.programs import (
        specs_from_dataset as jax_specs_from_dataset,
    )
    from photon_tpu.serve.tables import CoefficientTables as JaxTables

    path, _, maps = files[:3]
    arrays, manifest = model_arrays(maps, seed=11, extra=9)
    model = model_io.game_model_from_numpy(arrays, manifest, "cpu")
    tables = CoefficientTables.from_game_model(model, "float32", "cpu")
    data = port_data(path, maps)
    progs = ScorePrograms(tables, ladder=ShapeLadder((64, 256)),
                          specs=specs_from_dataset(data))
    assert len(progs._fe_names) + len(progs._re_names) == 12
    got = progs.score_dataset(data)
    jdata = jax_data(path, maps)
    jprogs = JaxPrograms(JaxTables.from_game_model(
        jax_model(tmp_path, arrays, manifest)), ladder=JaxLadder((64, 256)),
        specs=jax_specs_from_dataset(jdata), compile_now=False)
    np.testing.assert_allclose(got, jprogs.score_dataset(jdata), atol=F32,
                               rtol=0)


class _Recorder:
    """Stands in for the kernel library: records each launch's params."""

    def __init__(self):
        self.calls = []

    def __call__(self, params_ref, bf16, stream):
        p = params_ref._obj
        self.calls.append(dict(
            n_coords=p.n_coords, n_fixed=p.n_fixed, n_pairs=p.n_pairs,
            accumulate=p.accumulate, rung=p.rung,
            pair_base=list(p.pair_base), s=[p.c[i].s for i in range(8)],
            out=p.out))
        return 0


def test_more_than_eight_coordinates_launch_in_groups(monkeypatch):
    """The launcher's packing, checked without a card: 12 coordinates
    become a launch of 8 that writes the output and one of 4 that adds
    into it; the pair bases restart in each group."""
    rec = _Recorder()
    monkeypatch.setattr(serve_kernel, "load", lambda: None)
    monkeypatch.setattr(serve_kernel, "_launch_fn", rec)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    rng = np.random.default_rng(12)
    rung, d = 4, 6
    x = torch.from_numpy(rng.normal(size=(rung, d)).astype(np.float32))
    slots = [2, 3, 1, 4, 2, 5, 3, 2, 1, 6, 2]
    re_ws = tuple(torch.ones(3, s) for s in slots)
    re_projs = tuple(torch.zeros(3, s, dtype=torch.int32) for s in slots)
    codes = tuple(torch.zeros(rung, dtype=torch.int32) for _ in slots)
    before = serve_kernel.launches
    out = serve_kernel._launch(
        (torch.ones(d),), re_ws, re_projs, (x,), codes,
        spec_kinds=("dense",), fe_feat=(0,), re_feat=(0,) * len(slots))
    assert serve_kernel.launches - before == 2 == len(rec.calls)
    first, second = rec.calls
    assert (first["n_coords"], first["n_fixed"], first["accumulate"]) == (
        8, 1, 0)
    assert (second["n_coords"], second["n_fixed"], second["accumulate"]) == (
        4, 0, 1)
    assert first["n_pairs"] == sum(slots[:7])
    assert first["pair_base"][:7] == list(np.cumsum([0] + slots[:6]))
    assert first["pair_base"][7] == first["n_pairs"]
    assert second["pair_base"] == list(np.cumsum([0] + slots[7:10])) + [
        sum(slots[7:])] * 4
    assert first["s"] == [0] + slots[:7] and second["s"][:4] == slots[7:]
    assert first["out"] == second["out"] == out.data_ptr()
    assert first["rung"] == rung


SWITCH_VALUES = {None: "auto", "auto": "auto", "junk": "auto",
                 "force": "force", "ON": "force", "1": "force",
                 "off": "off", "0": "off", "False": "off"}


@pytest.mark.parametrize("raw", list(SWITCH_VALUES),
                         ids=lambda v: str(v))
def test_switches_choose_the_route_they_name(monkeypatch, files, raw):
    """Each switch value's route. On the CPU every value runs the plain
    version (``force`` there means plain, as ``auto`` does); ``off``
    also sends the Newton and segment route gates to their plain
    routes, as the reference's gates do."""
    for name in ("PHOTON_SERVE_KERNEL", "PHOTON_NEWTON_KERNEL",
                 "PHOTON_SEGMENT_KERNEL"):
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
        assert _build.kernel_off(name) == (SWITCH_VALUES[raw] == "off")
    off = SWITCH_VALUES[raw] == "off"
    assert serve_kernel.kernel_supported() == (not off)
    lr = TaskType.LOGISTIC_REGRESSION
    assert nk.kernel_supported(lr, torch.float32, 64, 17) == (not off)
    assert sr.kernel_supported(100, 100, torch.float32) == (not off)
    assert sr.densify_supported(4, 8, 3, 200, torch.float32) == (not off)
    model = model_io.game_model_from_numpy(*files[3:], "cpu")
    progs = ScorePrograms(CoefficientTables.from_game_model(
        model, "float32", "cpu"))
    assert progs.stats["serve_kernel"] == "plain" and not progs.use_kernel
    vals = torch.tensor([1.0, 2.0, 3.0])
    ids = torch.tensor([0, 0, 2], dtype=torch.int32)
    before = sr.launches
    assert sr.segment_sum(vals, ids, 3).tolist() == [3.0, 0.0, 3.0]
    assert sr.launches == before


def test_serve_cli_serves_a_model_directory(tmp_path, files, capsys):
    from photon_tpu.serve.tables import (
        build_index_maps_from_model as jax_build_maps,
    )

    model_dir = files[1]
    ours = build_index_maps_from_model(str(model_dir))
    theirs = jax_build_maps(str(model_dir))
    assert {s: sorted(m.items()) for s, m in ours.items()} == {
        s: sorted(m.items()) for s, m in theirs.items()}
    assert serve_cli.main(["--model-dir", str(model_dir), "--synthetic",
                           "200", "--device", "cpu", "--batch-sizes",
                           "1,8,64"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["errors"] == 0 and line["model"] == str(model_dir)
    assert line["serve_kernel"] == "plain"
    assert line["tables"]["random"]["per-user"]["entities"] == USERS


def test_rebuild_from_swaps_structure_and_copies_values(files):
    arrays, manifest = files[3:]
    model = model_io.game_model_from_numpy(arrays, manifest, "cpu")
    tables = CoefficientTables.from_game_model(model, "float32", "cpu")
    progs = ScorePrograms(tables, ladder=ShapeLadder((1, 8)))
    live = tables.random["per-user"].weights
    scaled = model_io.game_model_from_numpy(
        {k: v * 2 if k.endswith("coefficients") else v
         for k, v in arrays.items()}, manifest, "cpu")
    assert tables.rebuild_from(scaled, programs=progs) is None
    assert tables.random["per-user"].weights is live
    torch.testing.assert_close(live, 2 * torch.from_numpy(
        arrays["per-user/coefficients"]).float())
    grown = dict(arrays)
    grown["per-user/coefficients"] = np.vstack(
        [arrays["per-user/coefficients"], arrays["per-user/coefficients"]])
    grown["per-user/proj_all"] = np.vstack(
        [arrays["per-user/proj_all"], arrays["per-user/proj_all"]])
    man = json.loads(json.dumps(manifest))
    man["per-user"]["entity_keys"] += [f"new{i}" for i in range(USERS)]
    adopted = []
    new = tables.rebuild_from(
        model_io.game_model_from_numpy(grown, man, "cpu"), programs=progs,
        adopt=adopted.append)
    assert isinstance(new, ScorePrograms) and adopted == [new]
    assert new.tables is tables and new.ladder == progs.ladder
    assert tables.random["per-user"].num_entities == 2 * USERS
    assert tables.generation == 2


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_score_dataset_is_one_launch_per_chunk(cuda_device, tmp_path,
                                                    monkeypatch):
    """Rung 8192 on ELL shards: every chunk one kernel launch, equal to
    the plain route (``PHOTON_SERVE_KERNEL=off``) on the card."""
    path = tmp_path / "big.avro"
    write_data(path, 20_000, seed=13)
    maps = data_maps(path)
    arrays, manifest = model_arrays(maps, seed=14)
    model = model_io.game_model_from_numpy(f32(arrays), manifest,
                                           cuda_device)
    data, _ = avro_data.read_merged(
        str(path), feature_shards=parse_shard_spec(SHARD_SPEC),
        index_maps=maps, id_tag_names=ID_TAGS, device=cuda_device)
    tables = CoefficientTables.from_game_model(model, "float32", cuda_device)
    ladder = ShapeLadder(score_cli.BATCH_RUNGS)
    progs = ScorePrograms(tables, ladder=ladder,
                          specs=specs_from_dataset(data))
    before = serve_kernel.launches
    got = progs.score_dataset(data)
    assert progs.stats["serve_kernel"] == "cuda"
    assert serve_kernel.launches - before == len(ladder.chunk_plan(20_000))
    monkeypatch.setenv("PHOTON_SERVE_KERNEL", "off")
    plain = ScorePrograms(tables, ladder=ladder,
                          specs=specs_from_dataset(data))
    before = serve_kernel.launches
    ref = plain.score_dataset(data)
    assert plain.stats["serve_kernel"] == "plain"
    assert serve_kernel.launches == before
    np.testing.assert_allclose(got, ref, atol=F32, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rung", [1, 512])
def test_cuda_twelve_coordinates_kernel_matches_plain(cuda_device, files,
                                                      rung, wdtype):
    path, _, maps = files[:3]
    arrays, manifest = model_arrays(maps, seed=11, extra=9)
    model = model_io.game_model_from_numpy(f32(arrays), manifest,
                                           cuda_device)
    tables = CoefficientTables.from_game_model(model, wdtype, cuda_device)
    data = port_data(path, maps)
    progs = ScorePrograms(tables, ladder=ShapeLadder((rung,)),
                          specs=specs_from_dataset(data))
    leaves = []
    for s in progs.shard_order:
        f = data.feature_shards[s]
        leaves.append(progs.specs[s].slice_rows(
            (f.indices.to(cuda_device), f.values.to(cuda_device)), 0,
            min(rung, 300), rung))
    codes = tuple(torch.randint(-1, 12, (rung,), dtype=torch.int32,
                                device=cuda_device)
                  for _ in progs._re_names)
    ops = progs._device_operands(tuple(leaves), codes)
    before = serve_kernel.launches
    got = serve_kernel.fused_score(**ops)
    torch.cuda.synchronize()
    assert serve_kernel.launches - before == 2
    ref = serve_kernel.fused_score_reference(**ops)
    tol = F32 if wdtype == "float32" else 5e-2
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_score_cli_matches_the_cpu_run(cuda_device, tmp_path, files,
                                            capsys):
    data, model_dir = files[0], files[1]
    extra = ["--feature-shards", *SHARD_SPEC, "--id-tags", *ID_TAGS]
    before = serve_kernel.launches
    assert _run_cli(score_cli, model_dir, data, tmp_path / "gpu",
                    *extra) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert serve_kernel.launches - before == line["chunks"] == 1
    assert line["serve_kernel"] == "cuda"
    assert _run_cli(score_cli, model_dir, data, tmp_path / "cpu", *extra,
                    "--device", "cpu") == 0
    _, gpu = read_scores(tmp_path / "gpu" / "part-00000.avro")
    _, cpu = read_scores(tmp_path / "cpu" / "part-00000.avro")
    np.testing.assert_allclose(gpu, cpu, atol=F32, rtol=0)
    a = json.loads((tmp_path / "gpu" / "evaluation.json").read_text())
    b = json.loads((tmp_path / "cpu" / "evaluation.json").read_text())
    # Both in the labels' f32: the same sums in another order.
    rel = {k: abs(a[k] - b[k]) / abs(b[k]) for k in EVALUATORS}
    with capsys.disabled():
        print(f"\nGPU against CPU evaluation.json, relative: {rel}")
    for k in EVALUATORS:
        assert a[k] == pytest.approx(b[k], rel=GPU_CPU_EVAL_REL)
