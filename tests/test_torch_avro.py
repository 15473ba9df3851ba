"""The port's Avro layer against the JAX package's, on the CPU.

Covers the container codec (``io/avro.py``), the native block decoder
(``native/``), the feature index maps (``data/index_map.py``), the
TrainingExampleAvro readers (``io/avro_data.py``) and the Avro model
directory (``io/model_io.py``). Each test writes or reads the same
seeded data with both packages.

Tolerances: none. Avro writes are compared byte for byte with the
container's random 16-byte sync marker fixed (``os.urandom`` patched for
both writers); reads must give equal records, equal index maps and
equal arrays; coefficients cross the packages as Avro doubles and load
as float64 exactly.
"""

from __future__ import annotations

import io as _io
import os

import numpy as np
import pytest
import torch

from photon_tpu.data import index_map as jax_index_map
from photon_tpu.io import avro as jax_avro
from photon_tpu.io import avro_data as jax_avro_data
from photon_tpu.io import model_io as jax_model_io
from photon_tpu.native import get_avro_decoder as jax_get_decoder

from photon_tpu_torch import native
from photon_tpu_torch.data.index_map import HashedIndexMap, IndexMap
from photon_tpu_torch.io import avro, avro_data, model_io
from photon_tpu_torch.resilience.errors import (
    CorruptModelError,
    CorruptShardError,
)
from photon_tpu_torch.types import INTERCEPT_KEY, make_feature_key

SYNC = bytes(range(16))
BAGS = ("userFeatures", "movieFeatures")


@pytest.fixture
def fixed_sync(monkeypatch):
    """Both writers draw their sync marker from ``os.urandom``."""
    monkeypatch.setattr(os, "urandom", lambda n: SYNC[:n])


def _ntv(rng, prefix, width, k):
    cols = rng.choice(width, size=k, replace=False)
    return [{"name": f"{prefix}{c}", "term": "t" if c % 3 == 0 else "",
             "value": float(rng.normal())} for c in cols]


def training_records(n, seed=0, bags=()):
    """TrainingExampleAvro records with every optional field both set
    and absent, long and negative values, and unicode strings."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rec = {
            "uid": None if i % 7 == 3 else f"row-{i}-é",
            "label": float(rng.integers(0, 2)),
            "features": _ntv(rng, "g", 12, int(rng.integers(0, 5))),
            "metadataMap": (None if i % 11 == 5 else
                            {"userId": f"u{rng.integers(0, 9)}",
                             "movieId": str(int(rng.integers(-3, 4)))}),
            "weight": None if i % 4 == 0 else float(rng.uniform(0.1, 3)),
            "offset": None if i % 5 == 0 else float(rng.normal() * 1e9),
        }
        for b in bags:
            rec[b] = _ntv(rng, b[0], 6, int(rng.integers(1, 4)))
        out.append(rec)
    return out


def model_records(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{
        "modelId": f"entity-{i}",
        "modelClass": (None if i % 3 == 0 else
                       "com.linkedin.photon.ml.supervised.classification."
                       "LogisticRegressionModel"),
        "means": _ntv(rng, "f", 20, int(rng.integers(0, 6))),
        "variances": (None if i % 2 else
                      _ntv(rng, "f", 20, int(rng.integers(0, 3)))),
        "lossFunction": None,
    } for i in range(n)]


def score_records(n, seed=2):
    rng = np.random.default_rng(seed)
    return [{
        "uid": str(i), "label": float(rng.integers(0, 2)),
        "modelId": "LOGISTIC_REGRESSION",
        "predictionScore": float(rng.normal()),
        "weight": None if i % 2 else 1.5, "metadataMap": None,
    } for i in range(n)]


CONTAINERS = {
    "training": (avro_data.TRAINING_EXAMPLE_SCHEMA,
                 lambda: training_records(40)),
    "training-bags": (avro_data.training_example_schema(BAGS),
                      lambda: training_records(40, bags=BAGS)),
    "model": (model_io.BAYESIAN_LINEAR_MODEL_SCHEMA,
              lambda: model_records(30)),
    "scores": (model_io.SCORING_RESULT_SCHEMA, lambda: score_records(50)),
    "response": (avro_data.RESPONSE_PREDICTION_SCHEMA, lambda: [
        {"response": 1.0, "features": [], "weight": 2.0, "offset": -1.0}]),
}


def test_port_schemas_are_the_reference_schemas():
    assert avro_data.TRAINING_EXAMPLE_SCHEMA == (
        jax_avro_data.TRAINING_EXAMPLE_SCHEMA)
    assert avro_data.RESPONSE_PREDICTION_SCHEMA == (
        jax_avro_data.RESPONSE_PREDICTION_SCHEMA)
    assert model_io.BAYESIAN_LINEAR_MODEL_SCHEMA == (
        jax_model_io.BAYESIAN_LINEAR_MODEL_SCHEMA)
    assert model_io.SCORING_RESULT_SCHEMA == (
        jax_model_io.SCORING_RESULT_SCHEMA)
    assert avro_data.training_example_schema(()) is (
        avro_data.TRAINING_EXAMPLE_SCHEMA)


@pytest.mark.parametrize("codec", ["deflate", "null"])
@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_containers_are_byte_identical_and_cross_read(
        tmp_path, fixed_sync, name, codec):
    schema, make = CONTAINERS[name]
    recs = make()
    ours, theirs = tmp_path / "ours.avro", tmp_path / "theirs.avro"
    avro.write_container(str(ours), schema, recs, codec=codec,
                         sync_interval=16)
    jax_avro.write_container(str(theirs), schema, recs, codec=codec,
                             sync_interval=16)
    assert ours.read_bytes() == theirs.read_bytes()
    assert jax_avro.read_container(str(ours)) == (schema, recs)
    assert avro.read_container(str(theirs)) == (schema, recs)
    assert avro.encode_records(schema, recs) == jax_avro.encode_records(
        schema, recs)


def test_random_sync_markers_differ_only_in_the_marker(tmp_path):
    schema, make = CONTAINERS["scores"]
    recs = make()
    a, b = tmp_path / "a.avro", tmp_path / "b.avro"
    avro.write_container(str(a), schema, recs)
    jax_avro.write_container(str(b), schema, recs)
    ra, rb = a.read_bytes(), b.read_bytes()
    assert len(ra) == len(rb)
    sync_a, sync_b = ra[-16:], rb[-16:]
    assert ra.replace(sync_a, SYNC) == rb.replace(sync_b, SYNC)


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_schema_fingerprints_are_equal(name):
    schema, _ = CONTAINERS[name]
    assert avro.parsing_canonical_form(schema) == (
        jax_avro.parsing_canonical_form(schema))
    assert avro.schema_fingerprint(schema) == (
        jax_avro.schema_fingerprint(schema))


@pytest.fixture
def decoder():
    """The port's native decoder; the JAX package's own native tests
    skip the same way on a machine with no C compiler or headers."""
    mod = native.get_avro_decoder()
    if mod is None:
        pytest.skip("no working C compiler for the native decoder")
    return mod


def test_native_decoder_builds_under_the_checkout(decoder):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(native.BUILD_DIR) == os.path.join(repo, "build", "native")
    assert any(p.name.startswith("photon_avrodec_")
               for p in native.BUILD_DIR.iterdir())


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_native_decoder_matches_the_interpreter(decoder, name):
    """The native decoder against the port's interpreter codec and the
    JAX package's native decoder on the same block."""
    schema, make = CONTAINERS[name]
    recs = make()
    data = avro.encode_records(schema, recs)
    parsed = avro.Schema(schema)
    program = avro.schema_to_program(parsed.root)
    got = list(decoder.decode_block(data, len(recs), program))
    buf = _io.BytesIO(data)
    interp = [avro._decode(buf, parsed.root) for _ in recs]
    assert got == interp == recs
    ref = jax_get_decoder()
    if ref is not None:
        assert list(ref.decode_block(data, len(recs), program)) == got


def test_container_reads_count_the_native_decoder(tmp_path, decoder):
    schema, make = CONTAINERS["training"]
    path = tmp_path / "t.avro"
    avro.write_container(str(path), schema, make(), sync_interval=8)
    before = dict(avro.DECODED_BLOCKS)
    assert len(avro.read_container_dir(str(path))) == 40
    assert avro.DECODED_BLOCKS["native"] - before["native"] == 5
    assert avro.DECODED_BLOCKS["python"] == before["python"]


def _feature_names(seed=3, n=60):
    rng = np.random.default_rng(seed)
    names = {make_feature_key(f"f{rng.integers(0, 500)}",
                              "" if rng.uniform() < 0.5 else "t")
             for _ in range(n)}
    return sorted(names) + [INTERCEPT_KEY]


@pytest.mark.parametrize("add_intercept", [True, False])
@pytest.mark.parametrize("kind", ["dict", "hashed"])
def test_index_maps_equal_the_reference(tmp_path, kind, add_intercept):
    names = _feature_names()
    ours_cls = IndexMap if kind == "dict" else HashedIndexMap
    theirs_cls = (jax_index_map.IndexMap if kind == "dict"
                  else jax_index_map.HashedIndexMap)
    ours = ours_cls.from_feature_names(names, add_intercept=add_intercept)
    theirs = theirs_cls.from_feature_names(names,
                                           add_intercept=add_intercept)
    assert len(ours) == len(theirs)
    assert sorted(ours.items()) == sorted(theirs.items())
    for key in names + ["absent\x01", "f1"]:
        assert ours.get_index(key) == theirs.get_index(key)
        assert (key in ours) == (key in theirs)
    for i in range(-1, len(ours) + 1):
        assert ours.get_feature_name(i) == theirs.get_feature_name(i)
    assert ours.intercept_index == theirs.intercept_index
    assert ours.has_intercept == theirs.has_intercept == add_intercept
    path = tmp_path / ("m.json" if kind == "dict" else "m.npz")
    ours.save(path)
    assert sorted(theirs_cls.load(path).items()) == sorted(theirs.items())
    theirs.save(path)
    assert sorted(ours_cls.load(path).items()) == sorted(ours.items())


def test_identity_index_map_equals_the_reference():
    ours = IndexMap.identity(7, add_intercept=True)
    theirs = jax_index_map.IndexMap.identity(7, add_intercept=True)
    assert sorted(ours.items()) == sorted(theirs.items())


def _write_training(path, n=120, seed=4, bags=BAGS):
    """A TrainingExampleAvro file from the port's writer with feature
    bags, metadata, uids, weights and offsets."""
    rng = np.random.default_rng(seed)

    def rows(prefix, width):
        return [[(make_feature_key(f"{prefix}{c}", "t" if c % 4 == 0
                                   else ""), float(rng.normal()))
                 for c in rng.choice(width, size=rng.integers(1, 5),
                                     replace=False)]
                for _ in range(n)]

    avro_data.write_training_examples(
        str(path), rng.integers(0, 2, size=n).astype(float), rows("g", 9),
        offsets=rng.normal(size=n), weights=rng.uniform(0.5, 2, size=n),
        metadata=[{"userId": f"u{rng.integers(0, 8)}",
                   "movieId": f"m{rng.integers(0, 4)}"} for _ in range(n)],
        uids=[f"id{i}" if i % 3 else str(i) for i in range(n)],
        bags={b: rows(b[0], 5) for b in bags},
    )


def test_training_writer_is_byte_identical(tmp_path, fixed_sync):
    rng = np.random.default_rng(5)
    n = 30
    labels = rng.integers(0, 2, size=n).astype(float)
    rows = [[(make_feature_key(f"g{c}", ""), float(rng.normal()))
             for c in range(int(rng.integers(0, 4)))] for _ in range(n)]
    meta = [{"userId": f"u{i % 4}"} for i in range(n)]
    kw = dict(offsets=rng.normal(size=n), weights=rng.uniform(size=n),
              metadata=meta, uids=list(range(n)))
    ours, theirs = tmp_path / "o.avro", tmp_path / "t.avro"
    avro_data.write_training_examples(str(ours), labels, rows, **kw)
    jax_avro_data.write_training_examples(str(theirs), labels, rows, **kw)
    assert ours.read_bytes() == theirs.read_bytes()
    avro_data.write_response_predictions(str(ours), labels, rows)
    jax_avro_data.write_response_predictions(str(theirs), labels, rows)
    assert ours.read_bytes() == theirs.read_bytes()


def _assert_same_dataset(ours, theirs):
    np.testing.assert_array_equal(ours.host_column("labels"),
                                  np.asarray(theirs.labels))
    np.testing.assert_array_equal(ours.host_column("offsets"),
                                  np.asarray(theirs.offsets))
    np.testing.assert_array_equal(ours.host_column("weights"),
                                  np.asarray(theirs.weights))
    np.testing.assert_array_equal(ours.uids, theirs.uids)
    assert set(ours.feature_shards) == set(theirs.feature_shards)
    for s, feats in theirs.feature_shards.items():
        mine = ours.feature_shards[s]
        np.testing.assert_array_equal(mine.indices.numpy(),
                                      np.asarray(feats.indices))
        np.testing.assert_array_equal(mine.values.numpy(),
                                      np.asarray(feats.values))
        assert mine.d == feats.d
    assert set(ours.id_tags) == set(theirs.id_tags)
    for t, tag in theirs.id_tags.items():
        assert ours.id_tags[t].inverse == tuple(str(k) for k in tag.inverse)
        np.testing.assert_array_equal(ours.id_tags[t].host_codes(),
                                      np.asarray(tag.host_codes()))


def _same_maps(ours: dict, theirs: dict):
    assert set(ours) == set(theirs)
    for s in ours:
        assert sorted(ours[s].items()) == sorted(theirs[s].items())


def test_read_training_examples_matches_the_reference(tmp_path):
    path = tmp_path / "d.avro"
    _write_training(path, bags=())
    ours, omap = avro_data.read_training_examples(str(path), device="cpu")
    theirs, tmap = jax_avro_data.read_training_examples(str(path))
    _assert_same_dataset(ours, theirs)
    _same_maps({"f": omap}, {"f": tmap})
    ours_b = avro_data.build_index_map_from_records(
        avro.read_container_dir(str(path)))
    theirs_b = jax_avro_data.build_index_map_from_records(
        jax_avro.read_container_dir(str(path)))
    _same_maps({"f": ours_b}, {"f": theirs_b})


@pytest.mark.parametrize("tags", ["auto", "listed", "columns"])
def test_read_merged_matches_the_reference(tmp_path, tags):
    path = tmp_path / "d.avro"
    _write_training(path)
    shards = {"global": ["features"], "user": ["userFeatures", "features"],
              "movie": ["movieFeatures"]}
    kw = dict(feature_shards=shards,
              add_intercept={"global": True, "user": False, "movie": True})
    if tags == "auto":
        kw["id_tag_names"] = "auto"
    elif tags == "listed":
        kw["id_tag_names"] = ["movieId"]
    else:
        kw["id_tag_names"] = ["userId", "movieId"]
        kw["records"] = avro.read_container_dir(str(path))
    ours, omaps = avro_data.read_merged(str(path), device="cpu", **kw)
    theirs, tmaps = jax_avro_data.read_merged(str(path), **kw)
    _assert_same_dataset(ours, theirs)
    _same_maps(omaps, tmaps)


def test_input_columns_remap_matches_the_reference(tmp_path):
    """--input-columns: the response, weight and uid read from other
    fields (InputColumnsNames.scala:80-88)."""
    schema = {**avro_data.TRAINING_EXAMPLE_SCHEMA,
              "fields": avro_data.TRAINING_EXAMPLE_SCHEMA["fields"] + [
                  {"name": "resp", "type": "double"},
                  {"name": "sampleWeight", "type": "double"},
                  {"name": "rowKey", "type": "string"}]}
    rng = np.random.default_rng(6)
    recs = [{**r, "resp": float(i % 2), "sampleWeight": 0.5 + i,
             "rowKey": f"k{i}"}
            for i, r in enumerate(training_records(25, seed=6))]
    for r in recs:
        r["metadataMap"] = {"userId": f"u{rng.integers(0, 3)}"}
    path = tmp_path / "remap.avro"
    avro.write_container(str(path), schema, recs)
    cols = {"response": "resp", "weight": "sampleWeight", "uid": "rowKey"}
    ours, _ = avro_data.read_training_examples(
        str(path), input_columns=cols, device="cpu")
    theirs, _ = jax_avro_data.read_training_examples(
        str(path), input_columns=cols)
    _assert_same_dataset(ours, theirs)
    np.testing.assert_array_equal(ours.host_column("weights"),
                                  0.5 + np.arange(25, dtype=np.float32))
    with pytest.raises(ValueError, match="unknown input_columns"):
        avro_data.resolve_input_columns({"label": "x"})


@pytest.mark.parametrize("cut", [20, 200, -7])
def test_corrupt_shard_raises_naming_the_file(tmp_path, cut):
    good = tmp_path / "part-00000.avro"
    _write_training(good, n=60)
    bad = tmp_path / "part-00001.avro"
    raw = good.read_bytes()
    bad.write_bytes(raw[:cut])
    with pytest.raises(CorruptShardError, match="part-00001.avro"):
        avro_data.read_training_examples(str(tmp_path), device="cpu")
    assert avro_data.data_shard_files(str(tmp_path)) == [str(good),
                                                         str(bad)]


def _model_arrays(seed=7):
    """Checkpoint-keyed arrays of a GLMix model over named features:
    a fixed effect on ``global`` (with variances), a per-user
    coordinate on ``userShard`` with pad slots and an entity with no
    slot, a per-movie coordinate with variances and an exact-zero mean."""
    rng = np.random.default_rng(seed)
    maps = {
        "global": IndexMap.from_feature_names(
            [make_feature_key(f"g{i}", "t" if i % 2 else "")
             for i in range(8)]),
        "userShard": IndexMap.from_feature_names(
            [make_feature_key(f"u{i}") for i in range(6)]),
        "movieShard": IndexMap.from_feature_names(
            [make_feature_key(f"m{i}") for i in range(5)],
            add_intercept=False),
    }
    means = rng.normal(size=len(maps["global"]))
    means[2] = 0.0  # dropped on save
    arrays = {"global/means": means,
              "global/variances": rng.uniform(size=len(maps["global"]))}
    task = "LOGISTIC_REGRESSION"
    manifest = {"global": {"kind": "fixed", "shard": "global", "task": task}}
    for name, rt, shard, e, s in (("per-user", "userId", "userShard", 6, 4),
                                  ("per-movie", "movieId", "movieShard",
                                   4, 3)):
        d = len(maps[shard])
        proj = np.stack([np.sort(rng.choice(d, size=s, replace=False))
                         for _ in range(e)]).astype(np.int64)
        w = rng.normal(size=(e, s))
        if name == "per-user":
            proj[1, -1] = -1
            proj[3, :] = -1  # an entity with no slot is not saved
        else:
            w[0, 1] = 0.0
            arrays[f"{name}/variances"] = rng.uniform(size=(e, s))
        arrays[f"{name}/coefficients"] = w
        arrays[f"{name}/proj_all"] = proj
        manifest[name] = {"kind": "random", "re_type": rt, "shard": shard,
                          "task": task,
                          "entity_keys": [f"{rt}{i}" for i in range(e)]}
    return arrays, manifest, maps


def _jax_maps(maps):
    return {s: jax_index_map.IndexMap(dict(m.items()))
            for s, m in maps.items()}


def _coef_arrays(model):
    out = {}
    for name, sub in model.items():
        if hasattr(sub, "model"):
            out[f"{name}/means"] = np.asarray(sub.model.coefficients.means)
            v = sub.model.coefficients.variances
        else:
            out[f"{name}/coefficients"] = np.asarray(sub.coefficients)
            out[f"{name}/proj_all"] = np.asarray(sub.proj_all)
            out[f"{name}/keys"] = tuple(sub.entity_keys)
            v = sub.variances
        if v is not None:
            out[f"{name}/variances"] = np.asarray(v)
    return out


def _assert_models_equal(ours, theirs):
    a = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in _coef_arrays(ours).items()}
    b = _coef_arrays(theirs)
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], tuple):
            assert a[k] == b[k], k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_game_model_directories_are_byte_identical(tmp_path, fixed_sync):
    arrays, manifest, maps = _model_arrays()
    ours = model_io.game_model_from_numpy(arrays, manifest, "cpu")
    model_io.save_game_model(ours, str(tmp_path / "ours"), maps)
    ckpt = model_io.save_checkpoint(ours, str(tmp_path / "m.npz"))
    theirs = jax_model_io.load_checkpoint(ckpt)
    jax_model_io.save_game_model(theirs, str(tmp_path / "theirs"),
                                 _jax_maps(maps))
    a, b = _files(tmp_path / "ours"), _files(tmp_path / "theirs")
    assert set(a) == set(b) and len(a) == 7
    for name in a:
        assert a[name] == b[name], name
    assert model_io.model_feature_shard_ids(str(tmp_path / "ours")) == (
        jax_model_io.model_feature_shard_ids(str(tmp_path / "theirs")))


def test_game_model_loads_across_the_packages(tmp_path):
    arrays, manifest, maps = _model_arrays()
    ours = model_io.game_model_from_numpy(arrays, manifest, "cpu")
    model_io.save_game_model(ours, str(tmp_path / "ours"), maps)
    theirs = jax_model_io.load_checkpoint(
        model_io.save_checkpoint(ours, str(tmp_path / "m.npz")))
    jax_model_io.save_game_model(theirs, str(tmp_path / "theirs"),
                                 _jax_maps(maps))
    # Each package loads the other's directory; both loads agree.
    port_loaded, meta = model_io.load_game_model(
        str(tmp_path / "theirs"), maps, device="cpu", dtype=torch.float64)
    jax_loaded, jmeta = jax_model_io.load_game_model(
        str(tmp_path / "ours"), _jax_maps(maps))
    assert meta == jmeta == {"modelType": "LOGISTIC_REGRESSION",
                             "optimizationConfigurations": {}}
    _assert_models_equal(port_loaded, jax_loaded)
    assert port_loaded["per-user"].num_entities == 5  # the empty one left
    assert port_loaded["global"].model.coefficients.means.dtype == (
        torch.float64)
    f32, _ = model_io.load_game_model(str(tmp_path / "ours"), maps,
                                      device="cpu")
    assert f32["per-movie"].coefficients.dtype == torch.float32


def test_load_initial_model_takes_both_forms(tmp_path):
    arrays, manifest, maps = _model_arrays()
    ours = model_io.game_model_from_numpy(arrays, manifest, "cpu")
    model_io.save_game_model(ours, str(tmp_path / "dir"), maps)
    ckpt = model_io.save_checkpoint(ours, str(tmp_path / "m.npz"))
    from_dir, d1 = model_io.load_initial_model(
        str(tmp_path / "dir"), maps, device="cpu", dtype=torch.float64)
    from_npz, d2 = model_io.load_initial_model(ckpt, device="cpu")
    assert d1 == jax_model_io.artifact_digest(str(tmp_path / "dir"))
    assert d2 == jax_model_io.artifact_digest(ckpt)
    np.testing.assert_array_equal(
        from_npz["global"].model.coefficients.means.numpy(),
        arrays["global/means"])
    assert from_dir["per-user"].num_entities == 5
    with pytest.raises(ValueError, match="index_maps"):
        model_io.load_initial_model(str(tmp_path / "dir"))
    with pytest.raises(FileNotFoundError):
        model_io.load_initial_model(str(tmp_path / "nothing"))


def test_corrupt_model_coefficients_raise(tmp_path):
    arrays, manifest, maps = _model_arrays()
    model = model_io.game_model_from_numpy(arrays, manifest, "cpu")
    model_io.save_game_model(model, str(tmp_path / "m"), maps)
    part = (tmp_path / "m" / "random-effect" / "per-user" / "coefficients"
            / "part-00000.avro")
    part.write_bytes(part.read_bytes()[:60])
    with pytest.raises(CorruptModelError, match="per-user"):
        model_io.load_game_model(str(tmp_path / "m"), maps, device="cpu")
    (tmp_path / "m" / "model-metadata.json").write_text("{")
    with pytest.raises(CorruptModelError, match="not valid JSON"):
        model_io.load_game_model(str(tmp_path / "m"), maps, device="cpu")
    assert model_io.CorruptModelError is CorruptModelError


def test_save_scores_is_byte_identical(tmp_path, fixed_sync):
    rng = np.random.default_rng(8)
    scores = rng.normal(size=20).astype(np.float32)
    kw = dict(model_id="m", uids=np.arange(20), labels=np.ones(20),
              weights=rng.uniform(size=20).astype(np.float32))
    model_io.save_scores(str(tmp_path / "o" / "p.avro"), scores, **kw)
    jax_model_io.save_scores(str(tmp_path / "t" / "p.avro"), scores, **kw)
    assert (tmp_path / "o" / "p.avro").read_bytes() == (
        tmp_path / "t" / "p.avro").read_bytes()
