"""The port's ingest pipeline (``photon_tpu_torch.data.pipeline``) and the
planner's packed transfer, on the CPU.

The JAX package's ``tests/test_ingest_pipeline.py`` cases (its program
contracts wait for ROADMAP Queue A item 13): the pipelined planner
byte-identical to the serial path, ``_bucket_rows`` against its
full-scan form, the chunked packed transfer byte-identical to one copy,
the stage accounting, a killed-and-resumed streaming ingest giving
byte-identical packed plan buffers, and the shape oracle and the warm
stage (:261-400; the port's warm capture stands for the reference's
ahead-of-time compile, and on the CPU builds only the static key, so
its first fit equals the serial-ingest fit as the reference's does).
Then the port's own:
the packed buffer equal to the reference's, byte for byte, on the lazy
layout and the materialized arrays equal on the wide one; the
estimator's one packed transfer for every coordinate, pipelined against
serial on the logistic and the wide layouts; no CUDA-bound call off the
calling thread; and each fault point of the pipeline firing.
"""

from __future__ import annotations

import contextlib
import os
import threading

import numpy as np
import pytest
import torch

from photon_tpu_torch.data import pipeline
from photon_tpu_torch.data.dataset import DenseFeatures, SparseFeatures
from photon_tpu_torch.data.game_data import make_game_dataset
from photon_tpu_torch.data.random_effect import (
    RandomEffectDataConfiguration,
    _bucket_rows,
    _plan_random_effect,
    build_random_effect_dataset,
    predict_plan_shapes,
    skeleton_random_effect_dataset,
)
from photon_tpu_torch.resilience import (
    FaultPlan,
    InjectedCrash,
    TransientError,
    faults,
    reset_retry_stats,
    retry_stats,
)
from photon_tpu_torch.utils import compile_cache


@pytest.fixture(autouse=True)
def _clean():
    faults.disarm()
    reset_retry_stats()
    yield
    faults.disarm()
    reset_retry_stats()


@contextlib.contextmanager
def ingest_mode(*, serial: bool, threads: int = 2, chunk_min: int = 8):
    """Force the serial or the pipelined ingest path for one build."""
    saved = {k: os.environ.get(k)
             for k in ("PHOTON_TPU_SERIAL_INGEST",
                       "PHOTON_TPU_INGEST_THREADS")}
    saved_chunk = pipeline._CHUNK_MIN_ROWS
    os.environ["PHOTON_TPU_SERIAL_INGEST"] = "1" if serial else ""
    os.environ["PHOTON_TPU_INGEST_THREADS"] = str(threads)
    # Tiny fixtures must still take the chunked code paths.
    pipeline._CHUNK_MIN_ROWS = chunk_min
    pipeline.reset_executors()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        pipeline._CHUNK_MIN_ROWS = saved_chunk
        pipeline.reset_executors()


def _fixture(kind: str, n: int = 600, e: int = 41, d: int = 7, seed: int = 3,
             package=None):
    """(GameDataset, config) pairs covering the determinism matrix; with
    ``package`` (the reference's modules) the same data there."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, e, size=n)
    y = rng.normal(size=n).astype(np.float32)
    kw: dict = {}
    if kind == "dense_cap":
        feats = ("dense", rng.normal(size=(n, d)).astype(np.float32))
        kw = dict(active_data_upper_bound=6)
    elif kind == "dense_nocap":
        feats = ("dense", rng.normal(size=(n, d)).astype(np.float32))
    elif kind == "dense_zeros":
        x = rng.normal(size=(n, d)).astype(np.float32)
        x[x < 0.3] = 0.0
        feats = ("dense", x)
        kw = dict(active_data_upper_bound=8)
    elif kind == "dense_empty_entities":
        # The lower bound deactivates small entities; entity 0 has no
        # row at all.
        codes = rng.integers(1, e, size=n)
        head = np.repeat(np.arange(1, e), 3)
        codes[: head.size] = head
        feats = ("dense", rng.normal(size=(n, d)).astype(np.float32))
        kw = dict(active_data_upper_bound=5, active_data_lower_bound=4)
    elif kind == "sparse":
        idx = rng.integers(0, d, size=(n, 3)).astype(np.int32)
        val = rng.normal(size=(n, 3)).astype(np.float32)
        val[val < -1.0] = 0.0
        feats = ("sparse", idx, val)
        kw = dict(active_data_upper_bound=7)
    else:  # pragma: no cover
        raise KeyError(kind)
    if package is None:
        shard = (DenseFeatures(feats[1]) if feats[0] == "dense"
                 else SparseFeatures(feats[1], feats[2], d))
        data = make_game_dataset(y, {"s": shard}, id_tags={"g": codes},
                                 device="cpu")
        return data, RandomEffectDataConfiguration("g", "s", **kw)
    ds_mod, gd_mod, re_mod = package
    shard = (ds_mod.DenseFeatures(feats[1]) if feats[0] == "dense"
             else ds_mod.SparseFeatures(feats[1], feats[2], d))
    data = gd_mod.make_game_dataset(y, {"s": shard}, id_tags={"g": codes})
    return data, re_mod.RandomEffectDataConfiguration("g", "s", **kw)


FIXTURES = ("dense_cap", "dense_nocap", "dense_zeros",
            "dense_empty_entities", "sparse")


def _build(kind: str, *, serial: bool):
    with ingest_mode(serial=serial):
        data, cfg = _fixture(kind)
        return build_random_effect_dataset(
            data, cfg, intercept_index=cfg.feature_shard_id and 6)


def _assert_same_packed(a, b):
    """Byte-for-byte packed-buffer and BlockPlan equality: the diff
    harness of the serial-against-pipelined tests and the streaming
    kill-and-resume tests."""
    buf_a = np.asarray(a.packed_view.buffer)
    buf_b = np.asarray(b.packed_view.buffer)
    assert buf_a.dtype == buf_b.dtype == np.int32
    assert buf_a.shape == buf_b.shape
    assert bytes(buf_a) == bytes(buf_b)
    assert a.packed_view.shapes == b.packed_view.shapes
    assert len(a.blocks) == len(b.blocks)
    for ba, bb in zip(a.blocks, b.blocks):
        for f in ("entity_codes", "row_ids", "row_counts", "proj",
                  "intercept_slots"):
            np.testing.assert_array_equal(
                np.asarray(getattr(ba, f)), np.asarray(getattr(bb, f)), f)
    np.testing.assert_array_equal(a.covered_np, b.covered_np)
    np.testing.assert_array_equal(a.proj_all, b.proj_all)
    np.testing.assert_array_equal(a.sub_dims, b.sub_dims)
    assert a.max_sub_dim == b.max_sub_dim


@pytest.mark.parametrize("kind", FIXTURES)
def test_parallel_planner_bit_identical_to_serial(kind):
    """Pipelined planning gives byte-identical packed buffers and the
    same BlockPlan metadata as the serial path."""
    a = _build(kind, serial=True)
    b = _build(kind, serial=False)
    _assert_same_packed(a, b)


# ---------------------------------------------------------------------------
# _bucket_rows against its full-scan form
# ---------------------------------------------------------------------------


def _bucket_rows_full_scan_reference(plan, members):
    """One full-table boolean scan per bucket: the semantic reference the
    span-arithmetic ``_bucket_rows`` must match bit for bit."""
    is_member = np.zeros(plan.active.shape[0] + 1, dtype=bool)
    is_member[members] = True
    sorted_codes = plan.codes[plan.perm]
    sel = plan.keep_sorted & is_member[sorted_codes]
    rows_flat = plan.perm[sel]
    owner = sorted_codes[sel]
    member_rank = np.zeros(plan.active.shape[0], dtype=np.int64)
    member_rank[members] = np.arange(members.size)
    t_of = member_rank[owner]
    r_of = plan.rank_sorted[sel]
    return rows_flat, t_of, r_of, plan.counts[members]


@pytest.mark.parametrize("kind", FIXTURES)
def test_bucket_rows_matches_full_scan_reference(kind):
    with ingest_mode(serial=True):
        data, cfg = _fixture(kind)
        plan = _plan_random_effect(data, cfg, intercept_index=None,
                                   extra_features=None)
    for cap, members in sorted(plan.bucket_members.items()):
        got = _bucket_rows(plan, members)
        want = _bucket_rows_full_scan_reference(plan, members)
        for g, w, name in zip(got, want,
                              ("rows_flat", "t_of", "r_of", "counts_b")):
            np.testing.assert_array_equal(g, w, f"{name} @ cap {cap}")
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)


def test_bucket_rows_does_no_full_table_passes():
    """The selection touches only starts / counts / perm spans, never
    the full-n codes, keep or rank arrays: poisoning them proves it."""
    with ingest_mode(serial=True):
        data, cfg = _fixture("dense_cap")
        plan = _plan_random_effect(data, cfg, intercept_index=None,
                                   extra_features=None)
    reference = {cap: _bucket_rows_full_scan_reference(plan, members)
                 for cap, members in plan.bucket_members.items()}
    plan.codes = None
    plan.keep_sorted = None
    plan.rank_sorted = None
    plan.sorted_codes = None
    for cap, members in sorted(plan.bucket_members.items()):
        for g, w in zip(_bucket_rows(plan, members), reference[cap]):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the packed transfer
# ---------------------------------------------------------------------------


def _arrays():
    rng = np.random.default_rng(0)
    return [rng.integers(-50, 50, size=s).astype(np.int32)
            for s in ((13,), (7, 5), (3, 4, 2), (1,), (29,))]


def test_packed_device_put_chunked_is_byte_identical(monkeypatch):
    """The chunked copy == the single-copy buffer."""
    arrays = _arrays()
    with ingest_mode(serial=False):
        # Shrink the granule so the tiny layout spans several chunks.
        monkeypatch.setattr(pipeline, "_TRANSFER_GRANULE_ELEMS", 16)
        monkeypatch.setattr(pipeline, "transfer_chunk_elems", lambda: 32)
        pipeline.PIPELINE_STATS.reset()
        buf_chunked, shapes_c = pipeline.packed_to_device(arrays, "cpu")
        monkeypatch.setattr(pipeline, "transfer_chunk_elems",
                            lambda: 1 << 20)
        buf_single, shapes_s = pipeline.packed_to_device(arrays, "cpu")
        transfers = pipeline.PIPELINE_STATS.transfers()
    assert shapes_c == shapes_s
    a, b = buf_chunked.numpy(), buf_single.numpy()
    assert a.shape == b.shape == (pipeline.padded_len(102),) == (112,)
    assert bytes(a) == bytes(b)
    assert [t["chunks"] for t in transfers] == [4, 1]
    assert all(t["payload_bytes"] == 4 * 102 for t in transfers)


def test_padded_len_matches_granule():
    g = pipeline._TRANSFER_GRANULE_ELEMS
    assert pipeline.padded_len(1) == g
    assert pipeline.padded_len(g) == g
    assert pipeline.padded_len(g + 1) == 2 * g


def test_packed_buffer_carries_float32_by_its_bits(monkeypatch):
    """float32 arrays ride the int32 buffer as their bits and come back
    equal through the views, chunked or not; float64 falls back to the
    array-by-array copy."""
    from photon_tpu_torch.data import random_effect as re_mod

    rng = np.random.default_rng(1)
    arrays = [rng.normal(size=(5, 3)).astype(np.float32),
              np.arange(7, dtype=np.int32),
              np.array([np.nan, -0.0, np.inf], np.float32)]
    with ingest_mode(serial=False):
        monkeypatch.setattr(pipeline, "_TRANSFER_GRANULE_ELEMS", 4)
        monkeypatch.setattr(pipeline, "transfer_chunk_elems", lambda: 8)
        devs = re_mod._plan_arrays_to_device(arrays, torch.device("cpu"))
    assert isinstance(devs, re_mod.PackedPlanArrays)
    for a, t in zip(arrays, devs.device_arrays()):
        assert t.numpy().dtype == a.dtype and t.numpy().tobytes() == \
            a.tobytes()
    view = devs.view(1, 3)
    assert view.shapes == ((7,), (3,))
    assert view.device_arrays()[0].numpy().tolist() == list(range(7))
    mixed = re_mod._plan_arrays_to_device(
        [np.ones(3, np.float64), np.arange(2, dtype=np.int32)], "cpu")
    assert isinstance(mixed, re_mod._ListPlanArrays)
    assert mixed.device_arrays()[0].dtype == torch.float64


def test_transfer_packed_fault_is_retried():
    """``transfer.packed``: a transient fault re-runs the whole copy,
    counted, and the buffer is the clean run's."""
    arrays = _arrays()
    clean, _ = pipeline.packed_to_device(arrays, "cpu")
    with faults.injected(FaultPlan([dict(point="transfer.packed",
                                         nth=1)])):
        buf, _ = pipeline.packed_to_device(arrays, "cpu")
        fired = faults.fired()
    assert fired == [{"point": "transfer.packed", "call": 1,
                      "error": "transient"}]
    assert retry_stats()["retries"] == 1 and retry_stats()["recovered"] == 1
    assert bytes(buf.numpy()) == bytes(clean.numpy())


def test_ingest_chunk_fault_surfaces_from_the_pool():
    """``ingest.chunk``: a chunk worker's failure reaches the caller
    (after every chunk finished), never a silently unwritten span."""
    codes = np.arange(64, dtype=np.int64)
    with ingest_mode(serial=False, threads=4):
        out = pipeline.map_chunked(lambda c: c * 2, np.empty(64, np.int64),
                                   codes)
        np.testing.assert_array_equal(out, codes * 2)
        with faults.injected(FaultPlan([dict(point="ingest.chunk", nth=2,
                                             error="crash")])):
            with pytest.raises(InjectedCrash, match="ingest.chunk"):
                pipeline.map_chunked(lambda c: c * 2,
                                     np.empty(64, np.int64), codes)
            assert [f["point"] for f in faults.fired()] == ["ingest.chunk"]
        counts = pipeline.bincount_chunked(codes % 5, 5)
    np.testing.assert_array_equal(counts, np.bincount(codes % 5))


# ---------------------------------------------------------------------------
# stage accounting
# ---------------------------------------------------------------------------


def test_reset_discards_stale_generation_stage():
    """A stage spanning a reset() records nothing into the new report;
    the keep list preserves stages recorded before the estimator."""
    stats = pipeline.PipelineStats()
    with stats.stage("compile"):
        stats.reset()
    assert stats.report()["compile_seconds"] == 0.0
    stats.add("raw_transfer", 1.5)
    stats.add("plan", 2.0)
    stats.reset(keep=("raw_transfer",))
    rep = stats.report()
    assert rep["stages"].get("raw_transfer") == 1.5
    assert rep["plan_seconds"] == 0.0


def test_stage_reraises_body_exceptions():
    stats = pipeline.PipelineStats()
    with pytest.raises(RuntimeError, match="boom"):
        with stats.stage("compile"):
            raise RuntimeError("boom")
    assert "compile" in stats.report()["stages"]


def test_pipeline_stats_report_shape():
    stats = pipeline.PipelineStats()
    with stats.stage("plan"):
        pass
    stats.add("compile", 2.0)
    stats.add("compile_wait", 0.5)
    rep = stats.report()
    for key in ("plan_seconds", "pack_seconds", "transfer_seconds",
                "compile_seconds", "compile_wait_seconds",
                "compile_overlap_fraction", "stages"):
        assert key in rep
    assert rep["compile_overlap_fraction"] == 0.75
    assert pipeline.PipelineStats().report()[
        "compile_overlap_fraction"] is None


def test_serial_env_flag_round_trips():
    with ingest_mode(serial=True):
        assert pipeline.serial_ingest()
    with ingest_mode(serial=False):
        assert not pipeline.serial_ingest()


# ---------------------------------------------------------------------------
# the reference's packed buffers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", FIXTURES)
def test_packed_buffer_equals_the_references(kind):
    """The lazy layout's packed plan buffer, pipelined, is the
    reference's byte for byte (same arrays, same order, same padding)."""
    from photon_tpu.data import dataset as jax_dataset
    from photon_tpu.data import game_data as jax_game_data
    from photon_tpu.data import random_effect as jax_re

    jdata, jcfg = _fixture(kind, package=(jax_dataset, jax_game_data,
                                          jax_re))
    jds = jax_re.build_random_effect_dataset(jdata, jcfg,
                                             intercept_index=6)
    pds = _build(kind, serial=False)
    ref = np.asarray(jds.packed_view.buffer)
    got = pds.packed_view.buffer.numpy()
    assert ref.dtype == got.dtype and ref.shape == got.shape
    assert ref.tobytes() == got.tobytes()
    assert tuple(jds.packed_view.shapes) == pds.packed_view.shapes


# ---------------------------------------------------------------------------
# the estimator: one packed transfer, pipelined against serial
# ---------------------------------------------------------------------------


def _logistic_setup():
    """The training tests' logistic GLMix: per-user and per-movie on the
    lazy layout."""
    import test_torch_train as tt

    from photon_tpu_torch.estimators import game_estimator as est_mod

    arrays = tt.synth()
    _, data = tt.both_datasets(arrays, dtype=torch.float32)
    coords = {
        "global": est_mod.FixedEffectCoordinateConfiguration("global"),
        "per-user": est_mod.RandomEffectCoordinateConfiguration(
            RandomEffectDataConfiguration(**tt.RE_CONFIGS[0])),
        "per-movie": est_mod.RandomEffectCoordinateConfiguration(
            RandomEffectDataConfiguration(**tt.RE_CONFIGS[2])),
    }
    return data, coords


def _wide_setup():
    """The wide tests' squared-loss GLMix: per-movie materialized on the
    tag shard, per-user lazy."""
    import test_torch_wide as tw

    from photon_tpu_torch.estimators import game_estimator as est_mod

    _, data = tw.both_datasets(tw.synth(), dtype=torch.float32)
    coords = {
        "global": est_mod.FixedEffectCoordinateConfiguration("global"),
        "per-user": est_mod.RandomEffectCoordinateConfiguration(
            RandomEffectDataConfiguration(**tw.USER)),
        "per-movie": est_mod.RandomEffectCoordinateConfiguration(
            RandomEffectDataConfiguration(**tw.MOVIE)),
    }
    return data, coords


def _prepare(data, coords, *, serial: bool):
    from photon_tpu_torch.estimators.game_estimator import GameEstimator
    from photon_tpu_torch.types import TaskType

    with ingest_mode(serial=serial):
        est = GameEstimator(TaskType.LOGISTIC_REGRESSION, coords,
                            device="cpu")
        datasets, _ = est.prepare(data)
        return datasets, pipeline.PIPELINE_STATS.transfers()


@pytest.mark.parametrize("setup", [_logistic_setup, _wide_setup],
                         ids=["logistic", "wide"])
def test_estimator_plans_pipelined_equal_serial_in_one_transfer(setup):
    """Every random-effect coordinate's plan arrays reach the device in
    ONE packed transfer, and the pipelined prepare's buffer is the
    serial one's byte for byte, on the lazy and the materialized
    layout."""
    data, coords = setup()
    serial, t_serial = _prepare(data, coords, serial=True)
    piped, t_piped = _prepare(data, coords, serial=False)
    assert len(t_serial) == len(t_piped) == 1
    re_ids = [cid for cid in coords if cid != "global"]
    buf = serial[re_ids[0]].packed_view.buffer
    assert all(serial[c].packed_view.buffer is buf for c in re_ids)
    assert t_piped[0]["arrays"] == sum(
        len(piped[c].packed_view) for c in re_ids)
    assert bytes(buf.numpy()) == bytes(
        piped[re_ids[0]].packed_view.buffer.numpy())
    layouts = {serial[c].is_lazy for c in re_ids}
    assert layouts == ({True} if setup is _logistic_setup
                       else {True, False})


def test_materialized_arrays_equal_the_references():
    """The wide layout's blocks and score table, through the packed
    buffer's views, equal the reference's arrays bit for bit."""
    import test_torch_wide as tw

    jdata, pdata = tw.both_datasets(tw.synth(seed=4), dtype=torch.float32)
    jds, pds = tw.both_re_datasets(jdata, pdata, tw.MOVIE)
    assert not pds.is_lazy
    for jb, pb in zip(jds.blocks, pds.blocks, strict=True):
        for f in tw.BLOCK_FIELDS:
            tw.assert_same_bytes(getattr(jb, f), getattr(pb, f), f)
    for f in tw.TABLE_FIELDS:
        tw.assert_same_bytes(getattr(jds, f), getattr(pds, f), f)


def test_no_device_copy_off_the_calling_thread(monkeypatch):
    """The pools plan on the host only: every ``Tensor.to`` of a
    pipelined prepare runs on the calling thread."""
    data, coords = _logistic_setup()
    threads = []
    to = torch.Tensor.to

    def spy(self, *a, **kw):
        threads.append(threading.current_thread().name)
        return to(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    _prepare(data, coords, serial=False)
    assert threads and set(threads) == {threading.current_thread().name}


def test_ingest_plan_fault_propagates_from_the_plan_pool():
    """``ingest.plan``: a planner thunk dying on the plan pool reaches
    prepare's caller; the other coordinate's planner still finishes."""
    data, coords = _logistic_setup()
    with faults.injected(FaultPlan([dict(point="ingest.plan", nth=1,
                                         error="crash")])):
        with pytest.raises(InjectedCrash, match="ingest.plan"):
            _prepare(data, coords, serial=False)
        # One call per coordinate, the fixed effect's included.
        assert len(faults.fired()) == 1
    with faults.injected(FaultPlan([dict(point="ingest.plan", nth=2,
                                         error="transient")])):
        with pytest.raises(TransientError):
            _prepare(data, coords, serial=True)


# ---------------------------------------------------------------------------
# the shape oracle and the warm stage
# ---------------------------------------------------------------------------

# The fixtures whose shard is dense with no exact zero: the oracle's
# prediction is the built layout there.
PREDICTABLE = ("dense_cap", "dense_nocap", "dense_empty_entities")


def _jax_fixture(kind: str):
    from photon_tpu.data import dataset as jax_dataset
    from photon_tpu.data import game_data as jax_game_data
    from photon_tpu.data import random_effect as jax_re

    return _fixture(kind, package=(jax_dataset, jax_game_data, jax_re))


def _same_prediction(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None
    assert set(got) == set(want)
    for key, value in want.items():
        ref = value
        if key == "buckets":
            ref = [tuple(int(v) for v in b) for b in value]
        elif key == "packed_shapes":
            ref = tuple(tuple(int(v) for v in sh) for sh in value)
        else:
            ref = int(value)
        assert got[key] == ref, key


@pytest.mark.parametrize("kind", FIXTURES)
def test_shape_oracle_equals_the_references(kind):
    """The oracle's dict is the reference's on the same data; where the
    shard is fully dense it is the built layout (packed shapes, widest
    subspace, kept rows), the warm capture's precondition."""
    from photon_tpu.data import random_effect as jax_re

    with ingest_mode(serial=True):
        data, cfg = _fixture(kind)
        pred = predict_plan_shapes(data, cfg)
        jdata, jcfg = _jax_fixture(kind)
        _same_prediction(pred, jax_re.predict_plan_shapes(jdata, jcfg))
        ds = build_random_effect_dataset(data, cfg, intercept_index=None)
    if kind in PREDICTABLE:
        assert pred["packed_shapes"] == ds.packed_view.shapes
        assert pred["max_sub_dim"] == ds.max_sub_dim
        assert pred["kept_total"] == int(ds.covered_np.sum())


@pytest.mark.parametrize("change", [
    "sparse", "score_table_width_cap", "features_to_samples_ratio",
    "wide"])
def test_shape_oracle_declines_what_the_reference_declines(change):
    import dataclasses

    from photon_tpu.data import random_effect as jax_re

    kind = "sparse" if change == "sparse" else "dense_cap"
    kw = {"d": 130} if change == "wide" else {}
    extra = {"score_table_width_cap": 3,
             "features_to_samples_ratio": 0.5}.get(change)
    with ingest_mode(serial=True):
        data, cfg = _fixture(kind, **kw)
        jdata, jcfg = _fixture(kind, package=_jax_modules(), **kw)
        if extra is not None:
            cfg = dataclasses.replace(cfg, **{change: extra})
            jcfg = dataclasses.replace(jcfg, **{change: extra})
        assert jax_re.predict_plan_shapes(jdata, jcfg) is None
        assert predict_plan_shapes(data, cfg) is None
        assert skeleton_random_effect_dataset(data, cfg) is None


def _jax_modules():
    from photon_tpu.data import dataset as jax_dataset
    from photon_tpu.data import game_data as jax_game_data
    from photon_tpu.data import random_effect as jax_re

    return jax_dataset, jax_game_data, jax_re


def test_skeleton_is_shape_faithful_and_copies_nothing(monkeypatch):
    """The skeleton's plan arrays are zeros at the predicted shapes, its
    raw leaves the dataset's own tensors, and building it calls no
    ``Tensor.to``."""
    with ingest_mode(serial=True):
        data, cfg = _fixture("dense_cap")
        ds = build_random_effect_dataset(data, cfg, intercept_index=None)
    calls = []
    to = torch.Tensor.to
    monkeypatch.setattr(torch.Tensor, "to",
                        lambda self, *a, **k: calls.append(1) or to(
                            self, *a, **k))
    skel = skeleton_random_effect_dataset(data, cfg)
    monkeypatch.setattr(torch.Tensor, "to", to)
    assert not calls
    assert skel.packed_view.shapes == ds.packed_view.shapes
    assert skel.packed_view.buffer.shape == ds.packed_view.buffer.shape
    assert not skel.packed_view.buffer.any()
    assert skel.score_codes is data.id_tags["g"].codes
    assert skel.blocks[0].raw is data.feature_shards["s"]
    assert skel.blocks[0].raw_labels is data.labels
    assert [tuple(b.row_ids.shape) for b in skel.blocks] == [
        tuple(b.row_ids.shape) for b in ds.blocks]
    np.testing.assert_array_equal(
        skel.passive_rows_device().numpy(),
        np.arange(int(ds.covered_np.sum()), data.num_samples))


def _tiny():
    import test_torch_fused_fit_cuda as tf

    return tf.tiny_glmix()


def _model_tables(result) -> dict:
    out = {}
    for cid, m in result.model.items():
        c = (m.coefficients if hasattr(m, "coefficients")
             else m.model.coefficients.means)
        out[cid] = c.numpy()
    return out


def test_warm_stage_first_fit_identical_to_serial():
    """The warm stage changes which program runs the first fit, never
    what it computes: the pipelined estimator's first fused fit equals
    the serial-ingest fit bit for bit, took the warm artifact, and the
    report has the compile stages."""
    with ingest_mode(serial=True):
        est_s, data_s = _tiny()
        want = _model_tables(est_s.fit(data_s)[0])
        assert est_s._aot_future is None
    before = compile_cache.cache_stats()
    with ingest_mode(serial=False):
        est_p, data_p = _tiny()
        got = _model_tables(est_p.fit(data_p)[0])
        fused = next(reversed(est_p._fused_cache.values()))
        report = pipeline.PIPELINE_STATS.report()
        compile_s = pipeline.PIPELINE_STATS.seconds("compile")
    after = compile_cache.cache_stats()
    assert fused._aot is not None and fused._aot["captured"] is None
    for cid in want:
        np.testing.assert_array_equal(want[cid], got[cid], cid)
    # The report rounds to 0.1 ms; on the CPU the stage is shorter.
    assert compile_s > 0.0
    assert "compile_wait" in report["stages"]
    assert 0.0 <= report["compile_overlap_fraction"] <= 1.0
    assert after["aot_compiles"] == before["aot_compiles"] + 1
    assert after["aot_failures"] == before["aot_failures"]


def _stale_pair(device="cpu"):
    """A dense shard with a dead column: every real subspace drops it,
    so the oracle's fully dense prediction is wrong for every entity."""
    from photon_tpu_torch.data.dataset import DenseFeatures
    from photon_tpu_torch.estimators.game_estimator import (
        FixedEffectCoordinateConfiguration,
        GameEstimator,
        RandomEffectCoordinateConfiguration,
    )
    from photon_tpu_torch.types import TaskType

    rng = np.random.default_rng(11)
    n, e, d, du = 120, 9, 5, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, -1] = 1.0
    xu = rng.normal(size=(n, du)).astype(np.float32)
    xu[:, 0] = 0.0
    xu[:, -1] = 1.0
    users = rng.integers(0, e, size=n)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    data = make_game_dataset(
        y, {"global": DenseFeatures(x), "userShard": DenseFeatures(xu)},
        id_tags={"userId": users}, device=device)
    est = GameEstimator(
        TaskType.LINEAR_REGRESSION,
        {"global": FixedEffectCoordinateConfiguration("global"),
         "per-user": RandomEffectCoordinateConfiguration(
             RandomEffectDataConfiguration("userId", "userShard"))},
        intercept_indices={"global": d - 1, "userShard": du - 1},
        num_iterations=2, device=device)
    return est, data


def test_stale_shape_prediction_is_discarded():
    """A wrong prediction's artifact is dropped (its static key is not
    the built generation's) and the fit equals the serial run's."""
    with ingest_mode(serial=True):
        est_s, data_s = _stale_pair()
        skel = skeleton_random_effect_dataset(
            data_s, est_s.coordinate_configs["per-user"].data)
        built = est_s.prepare(data_s)[0]["per-user"]
        assert skel is not None
        assert skel.packed_view.shapes != built.packed_view.shapes
        want = _model_tables(est_s.fit(data_s)[0])
    with ingest_mode(serial=False):
        est_p, data_p = _stale_pair()
        got = _model_tables(est_p.fit(data_p)[0])
        fused = next(reversed(est_p._fused_cache.values()))
        compile_s = pipeline.PIPELINE_STATS.seconds("compile")
    assert fused._aot is None, "a stale artifact was taken"
    assert compile_s > 0.0
    for cid in want:
        np.testing.assert_array_equal(want[cid], got[cid], cid)


def test_declined_warm_stage_records_no_compile_stage():
    """A declined prediction (a sparse shard) leaves compile_seconds at
    0 and the overlap fraction None."""
    from photon_tpu_torch.estimators.game_estimator import (
        GameEstimator,
        RandomEffectCoordinateConfiguration,
    )
    from photon_tpu_torch.types import TaskType

    with ingest_mode(serial=True):
        data, cfg = _fixture("sparse")
        est = GameEstimator(
            TaskType.LINEAR_REGRESSION,
            {"per-g": RandomEffectCoordinateConfiguration(cfg)},
            device="cpu")
        pipeline.PIPELINE_STATS.reset()
        assert est._warm_capture(data) is None
        rep = pipeline.PIPELINE_STATS.report()
    assert rep["compile_seconds"] == 0.0
    assert rep["compile_overlap_fraction"] is None


def test_warm_stage_eligibility_follows_the_reference():
    """No warm stage with validation, an initial model, incremental
    training, a listener, or the serial ingest."""
    est, data = _tiny()
    with ingest_mode(serial=False):
        assert est._warm_capture_eligible(None, None)
        assert not est._warm_capture_eligible(data, None)
        assert not est._warm_capture_eligible(None, object())
        est.incremental_training = True
        assert not est._warm_capture_eligible(None, None)
        est.incremental_training = False
        est.emitter = object()
        assert not est._warm_capture_eligible(None, None)
        est.emitter = None
    with ingest_mode(serial=True):
        assert not est._warm_capture_eligible(None, None)


def test_compile_aot_fault_is_retried_and_recovers():
    """``compile.aot``: a transient fault at the warm stage's first
    attempt is retried, the stage recovers and its artifact is taken."""
    before = compile_cache.cache_stats()
    with ingest_mode(serial=False):
        est, data = _tiny()
        with faults.injected(FaultPlan([dict(point="compile.aot",
                                             nth=1)])):
            est.prepare(data)
            est._aot_future.result()
            fired = faults.fired()
        est.fit(data)
        fused = next(reversed(est._fused_cache.values()))
    assert fired == [{"point": "compile.aot", "call": 1,
                      "error": "transient"}]
    assert retry_stats()["retries"] == 1 and retry_stats()["recovered"] == 1
    assert fused._aot is not None
    after = compile_cache.cache_stats()
    assert after["aot_compiles"] == before["aot_compiles"] + 1
    assert after["aot_failures"] == before["aot_failures"]


def test_failed_warm_stage_is_counted_and_the_fit_still_runs():
    """A warm stage that fails past its retries is logged and counted in
    ``aot_failures``; the first fit then builds its program itself."""
    with ingest_mode(serial=True):
        est_s, data_s = _tiny()
        want = _model_tables(est_s.fit(data_s)[0])
    before = compile_cache.cache_stats()
    with ingest_mode(serial=False):
        est, data = _tiny()
        with faults.injected(FaultPlan([dict(point="compile.aot",
                                             error="poison", nth=1)])):
            got = _model_tables(est.fit(data)[0])
        fused = next(reversed(est._fused_cache.values()))
    assert fused._aot is None
    assert compile_cache.cache_stats()["aot_failures"] == (
        before["aot_failures"] + 1)
    for cid in want:
        np.testing.assert_array_equal(want[cid], got[cid], cid)


def test_compile_pool_shuts_down_with_the_others():
    with ingest_mode(serial=False):
        fut = pipeline.compile_executor.submit(lambda: 7)
        assert fut.result() == 7
        assert pipeline.compile_executor._pool is not None
        pipeline.reset_executors()
        assert pipeline.compile_executor._pool is None


# ---------------------------------------------------------------------------
# streaming kill-and-resume determinism
# ---------------------------------------------------------------------------


STREAM_KINDS = ("cap", "sparse", "empty_entities")


def _write_stream_fixture(kind: str, shard_dir: str):
    """Avro-shard counterparts of the determinism matrix: dense-ish rows
    under an active-data cap, sparse rows with exact zeros, and a lower
    bound deactivating small entities. Returns the RE config."""
    from photon_tpu_torch.io.avro_data import write_training_examples
    from photon_tpu_torch.types import DELIMITER

    os.makedirs(shard_dir, exist_ok=True)
    rng = np.random.default_rng(11)
    n_per, shards, d, e = 48, 5, 6, 13
    if kind == "cap":
        kw = dict(active_data_upper_bound=6)
    elif kind == "sparse":
        kw = dict(active_data_upper_bound=7)
    else:
        kw = dict(active_data_upper_bound=5, active_data_lower_bound=4)
    base = 0
    for si in range(shards):
        y = rng.normal(size=n_per)
        rows = []
        for _ in range(n_per):
            feats = range(d) if kind == "cap" else rng.choice(
                d, size=3, replace=False)
            rows.append([(f"f{j}{DELIMITER}t", float(v)) for j in feats
                         if (v := rng.normal()) > -0.8 or kind == "cap"])
        lo = 1 if kind == "empty_entities" else 0
        meta = [{"g": f"e{rng.integers(lo, e)}"} for _ in range(n_per)]
        write_training_examples(
            os.path.join(shard_dir, f"part-{si:05d}.avro"),
            y, rows, metadata=meta, uids=np.arange(base, base + n_per))
        base += n_per
    return RandomEffectDataConfiguration("g", "features", **kw)


@pytest.mark.parametrize("kind", STREAM_KINDS)
def test_streaming_kill_resume_packed_buffers_byte_identical(kind,
                                                             tmp_path):
    """Kill the streaming ingest after shard k (a crash-kind fault),
    resume from the cursor: the resumed dataset's packed plan buffers
    are byte-identical to the uninterrupted run's."""
    from photon_tpu_torch.data.stream import StreamingIngest
    from photon_tpu_torch.io.avro_data import read_training_examples

    shard_dir = str(tmp_path / "shards")
    cfg = _write_stream_fixture(kind, shard_dir)
    with ingest_mode(serial=True):
        _, imap = read_training_examples(shard_dir, device="cpu")

        def ingest(work, **kw):
            return StreamingIngest(shard_dir, work_dir=str(tmp_path / work),
                                   index_maps={"features": imap},
                                   id_tag_names=["g"], device="cpu", **kw)

        full, _ = ingest("full").run()
        with faults.injected(FaultPlan(
                [dict(point="io.shard_read", nth=4, error="crash")])):
            with pytest.raises(InjectedCrash):
                ingest("killed").run()
        resumed, stats = ingest("killed", resume=True).run()
        assert stats["resumed_from_shard"] == 3
        a = build_random_effect_dataset(full, cfg, intercept_index=None)
        b = build_random_effect_dataset(resumed, cfg, intercept_index=None)
    _assert_same_packed(a, b)
    assert bytes(full.labels.numpy()) == bytes(resumed.labels.numpy())
    fa = full.feature_shards["features"]
    fb = resumed.feature_shards["features"]
    assert bytes(fa.values.numpy()) == bytes(fb.values.numpy())
    np.testing.assert_array_equal(full.id_tags["g"].codes.numpy(),
                                  resumed.id_tags["g"].codes.numpy())


# ---------------------------------------------------------------------------
# on the card: pinned staging, the side stream and its events
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned, streamed copies run "
                    "only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("chunked", [False, True])
def test_cuda_packed_transfer_matches_the_host_bytes(cuda_device, chunked,
                                                     monkeypatch):
    """The packed buffer on the card, one copy or double-buffered
    chunks, holds the host layout byte for byte, and its float32 views
    give the host arrays back."""
    from photon_tpu_torch.data import random_effect as re_mod

    rng = np.random.default_rng(7)
    arrays = [rng.integers(-9, 9, size=(37, 3)).astype(np.int32),
              rng.normal(size=(11, 5)).astype(np.float32),
              np.arange(101, dtype=np.int32),
              rng.normal(size=(3,)).astype(np.float32)]
    with ingest_mode(serial=False):
        monkeypatch.setattr(pipeline, "_TRANSFER_GRANULE_ELEMS", 8)
        monkeypatch.setattr(pipeline, "transfer_chunk_elems",
                            (lambda: 16) if chunked else (lambda: 1 << 20))
        pipeline.PIPELINE_STATS.reset()
        devs = re_mod._plan_arrays_to_device(arrays, cuda_device)
        n_chunks = pipeline.PIPELINE_STATS.transfers()[0]["chunks"]
    layout = pipeline._Layout(arrays)
    host = np.empty(layout.n_pad, np.int32)
    layout.fill(host, 0, layout.n_pad)
    assert devs.buffer.device.type == "cuda"
    assert devs.buffer.cpu().numpy().tobytes() == host.tobytes()
    assert n_chunks == (-(-layout.n_pad // 16) if chunked else 1)
    for a, t in zip(arrays, devs.device_arrays()):
        assert t.cpu().numpy().tobytes() == a.tobytes()


@pytest.mark.cuda
def test_cuda_raw_dataset_copies_from_pinned_memory(cuda_device):
    """Arrays past the pinned-copy threshold reach the card equal."""
    rng = np.random.default_rng(2)
    n = 70_000
    idx = rng.integers(0, 9, size=(n, 5)).astype(np.int32)
    val = rng.normal(size=(n, 5)).astype(np.float32)
    data = make_game_dataset(rng.normal(size=n), {"s": SparseFeatures(
        idx, val, 9)}, id_tags={"g": rng.integers(0, 50, size=n)},
        device=cuda_device)
    torch.cuda.synchronize()
    f = data.feature_shards["s"]
    assert f.indices.cpu().numpy().tobytes() == idx.tobytes()
    assert f.values.cpu().numpy().tobytes() == val.tobytes()
    assert data.labels.cpu().numpy().tobytes() == data.host[
        "labels"].tobytes()


@pytest.mark.cuda
def test_cuda_streamed_dataset_and_plans_equal_the_cpu_run(cuda_device,
                                                           tmp_path):
    """The streaming ingest on the card (pinned windows, side-stream
    copies, assembly after each window's event) gives the CPU run's
    dataset, and its pipelined packed plan buffer the serial one's."""
    from photon_tpu_torch.data.stream import StreamingIngest
    from photon_tpu_torch.io.avro_data import read_training_examples

    shard_dir = str(tmp_path / "shards")
    cfg = _write_stream_fixture("sparse", shard_dir)
    _, imap = read_training_examples(shard_dir, device="cpu")
    out = {}
    for dev in ("cpu", cuda_device):
        out[str(dev)] = StreamingIngest(
            shard_dir, work_dir=str(tmp_path / f"w-{dev.__str__()}"),
            index_maps={"features": imap}, id_tag_names=["g"],
            window_shards=2, device=dev).run()[0]
    cpu, gpu = out["cpu"], out[str(cuda_device)]
    torch.cuda.synchronize()
    for col in ("labels", "offsets", "weights"):
        assert getattr(gpu, col).cpu().numpy().tobytes() == getattr(
            cpu, col).numpy().tobytes()
    for f in ("indices", "values"):
        assert getattr(gpu.feature_shards["features"], f).cpu().numpy(
        ).tobytes() == getattr(cpu.feature_shards["features"],
                               f).numpy().tobytes()
    builds = {}
    for serial in (True, False):
        with ingest_mode(serial=serial):
            builds[serial] = build_random_effect_dataset(
                gpu, cfg, intercept_index=None)
    torch.cuda.synchronize()
    assert torch.equal(builds[True].packed_view.buffer,
                       builds[False].packed_view.buffer)
    ref = build_random_effect_dataset(cpu, cfg, intercept_index=None)
    assert builds[False].packed_view.buffer.cpu().numpy().tobytes() == \
        ref.packed_view.buffer.numpy().tobytes()


def _cuda_tiny():
    import test_torch_fused_fit_cuda as tf

    return tf.tiny_glmix(device="cuda")


@pytest.mark.cuda
def test_cuda_warm_capture_is_adopted_bit_for_bit(cuda_device):
    """On the card an eligible prepare captures the fused graph on the
    compile pool's thread; the first fit adopts it (no capture inside
    its window, which is attributed) and equals bit for bit the fit of
    an estimator that captured at first use."""
    with ingest_mode(serial=True):
        est_s, data_s = _cuda_tiny()
        want = _model_tables_cuda(est_s.fit(data_s)[0])
    before = compile_cache.cache_stats()
    with ingest_mode(serial=False):
        est, data = _cuda_tiny()
        est.prepare(data)
        art = est._aot_future.result()
        assert art is not None and art["captured"] is not None
        cap = art["captured"]
        del art
        got = _model_tables_cuda(est.fit(data)[0])
        fused = next(reversed(est._fused_cache.values()))
        report = pipeline.PIPELINE_STATS.report()
    assert fused.captured() is cap and cap.adopted
    assert len(fused._graphs) == 1
    assert report["compile_seconds"] > 0.0
    assert 0.0 <= report["compile_overlap_fraction"] <= 1.0
    after = compile_cache.cache_stats()
    assert after["aot_compiles"] == before["aot_compiles"] + 1
    assert after["aot_failures"] == before["aot_failures"]
    for cid in want:
        np.testing.assert_array_equal(want[cid], got[cid], cid)


def _model_tables_cuda(result) -> dict:
    torch.cuda.synchronize()
    out = {}
    for cid, m in result.model.items():
        c = (m.coefficients if hasattr(m, "coefficients")
             else m.model.coefficients.means)
        out[cid] = c.cpu().numpy()
    return out


@pytest.mark.cuda
def test_cuda_stale_warm_capture_is_dropped(cuda_device):
    """A wrong prediction's graph is dropped on the calling thread and
    the first fit captures its own, equal to the serial run's."""
    with ingest_mode(serial=True):
        est_s, data_s = _stale_pair("cuda")
        want = _model_tables_cuda(est_s.fit(data_s)[0])
    with ingest_mode(serial=False):
        est, data = _stale_pair("cuda")
        got = _model_tables_cuda(est.fit(data)[0])
        fused = next(reversed(est._fused_cache.values()))
    assert fused._aot is None
    assert len(fused._graphs) == 1
    assert not fused.captured().adopted
    for cid in want:
        np.testing.assert_array_equal(want[cid], got[cid], cid)


@pytest.mark.cuda
def test_cuda_warm_capture_copies_nothing_from_the_host(cuda_device,
                                                        monkeypatch):
    """No host-to-device copy runs off the calling thread during a warm
    capture: the compile pool's thread allocates, launches and captures
    only."""
    off_thread = []
    to = torch.Tensor.to
    main = threading.current_thread().name

    def spy(self, *a, **kw):
        out = to(self, *a, **kw)
        if (threading.current_thread().name != main
                and self.device.type == "cpu" and out.device.type == "cuda"):
            off_thread.append(threading.current_thread().name)
        return out

    with ingest_mode(serial=False):
        est, data = _cuda_tiny()
        monkeypatch.setattr(torch.Tensor, "to", spy)
        est.prepare(data)
        art = est._aot_future.result()
        monkeypatch.setattr(torch.Tensor, "to", to)
    assert art is not None and art["captured"] is not None
    assert off_thread == []

