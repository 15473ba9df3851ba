"""The port's streaming ingest (``photon_tpu_torch.data.stream``) and the
training CLI's ``--stream-dir``, on the CPU.

The JAX package's ``tests/test_stream.py`` case by case on the port
(manifest integrity, streamed equals in-memory, corrupt-shard
quarantine, transient-I/O retry, cursor resume, warm start, the CLI),
then the two packages side by side on the same shard directory: the
streamed datasets equal bit for bit, ``ingest-manifest.json`` byte for
byte, the stats dicts on every key that is not a time, and both
``cli.train --stream-dir`` models within the training-CLI tests' f32
bounds (fixed effect 1e-3, random effects 4e-3; ``test_torch_train_cli``'s
module docstring). The ingest's registry gauges are checked on the
quarantine case. With the health layer armed, ``ingest-sketch.json``
is byte-identical to the reference's on the same shards, and a killed
and resumed ingest (the pipelined and the serial planner) writes the
uninterrupted run's sketch byte for byte (exact). The reference's
program-contract test waits for ROADMAP Queue A item 13 and is not
checked here.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from photon_tpu_torch.data import pipeline
from photon_tpu_torch.data.stream import (
    CURSOR_FILE,
    MANIFEST_FILE,
    SKETCH_FILE,
    QuarantinePolicy,
    StreamingIngest,
    build_shard_manifest,
)
from photon_tpu_torch.io.avro_data import (
    checked_iter_container_dir,
    read_training_examples,
    write_training_examples,
)
from photon_tpu_torch.resilience import (
    FaultPlan,
    InjectedCrash,
    faults,
    reset_retry_stats,
    retry_stats,
)
from photon_tpu_torch.resilience.errors import (
    CorruptShardError,
    ResumeMismatchError,
    TransientError,
    is_transient,
)
from photon_tpu_torch.types import DELIMITER

N_PER_SHARD = 40
N_SHARDS = 5
D = 4
E = 7
# Two f32 fits, one from each package (test_torch_train_cli.py).
FE_ATOL, RE_ATOL = 1e-3, 4e-3
TIME_KEYS = ("scan_seconds", "decode_seconds", "transfer_seconds",
             "wall_seconds", "rows_per_sec")


@pytest.fixture(autouse=True)
def _clean():
    faults.disarm()
    reset_retry_stats()
    yield
    faults.disarm()
    reset_retry_stats()


def _write_shards(shard_dir, *, n_per=N_PER_SHARD, shards=N_SHARDS,
                  d=D, e=E, seed=3):
    os.makedirs(shard_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = 0
    for si in range(shards):
        y = rng.normal(size=n_per)
        rows = [
            [(f"f{j}{DELIMITER}t", float(rng.normal()))
             for j in rng.choice(d, size=3, replace=False)]
            for _ in range(n_per)
        ]
        meta = [{"userId": f"u{rng.integers(0, e)}"} for _ in range(n_per)]
        write_training_examples(
            os.path.join(shard_dir, f"part-{si:05d}.avro"),
            y, rows, metadata=meta, uids=np.arange(base, base + n_per),
        )
        base += n_per
    return shard_dir


@pytest.fixture()
def shard_dir(tmp_path):
    return _write_shards(str(tmp_path / "shards"))


def _ingest(shard_dir, work_dir, **kw):
    kw.setdefault("id_tag_names", ["userId"])
    return StreamingIngest(shard_dir, work_dir=str(work_dir), device="cpu",
                           **kw)


def _read(shard_dir):
    return read_training_examples(shard_dir, device="cpu")


def _truncate(path, keep=None):
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 2 if keep is None else keep(len(raw))])
    return raw


def _assert_datasets_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.labels), np.asarray(b.labels))
    np.testing.assert_array_equal(
        np.asarray(a.offsets), np.asarray(b.offsets))
    np.testing.assert_array_equal(
        np.asarray(a.weights), np.asarray(b.weights))
    fa, fb = a.feature_shards["features"], b.feature_shards["features"]
    assert bytes(np.asarray(fa.indices)) == bytes(np.asarray(fb.indices))
    assert bytes(np.asarray(fa.values)) == bytes(np.asarray(fb.values))
    assert fa.d == fb.d
    assert set(a.id_tags) == set(b.id_tags)
    for t in a.id_tags:
        np.testing.assert_array_equal(
            np.asarray(a.id_tags[t].codes), np.asarray(b.id_tags[t].codes))
        assert a.id_tags[t].inverse == b.id_tags[t].inverse
    np.testing.assert_array_equal(a.uids, b.uids)
    ia, va, da = a.host_shard_coo("features")
    ib, vb, db = b.host_shard_coo("features")
    assert bytes(ia) == bytes(ib) and bytes(va) == bytes(vb) and da == db


@pytest.fixture()
def serial_ingest_env(monkeypatch):
    """Inline window decode: deterministic nth-call fault accounting
    (the prefetch worker would otherwise interleave per-point call
    counts across windows)."""
    monkeypatch.setenv("PHOTON_TPU_SERIAL_INGEST", "1")
    pipeline.reset_executors()
    yield
    monkeypatch.delenv("PHOTON_TPU_SERIAL_INGEST", raising=False)
    pipeline.reset_executors()


def _crash_at_third_read(shard_dir, work, imap, **kw):
    with faults.injected(FaultPlan(
            [dict(point="io.shard_read", nth=3, error="crash")])):
        with pytest.raises(InjectedCrash):
            _ingest(shard_dir, work, index_maps={"features": imap},
                    **kw).run()


class TestManifest:
    def test_build_records_size_hash_count_offset(self, shard_dir):
        manifest = build_shard_manifest(shard_dir)
        assert len(manifest["shards"]) == N_SHARDS
        offset = 0
        for info in manifest["shards"]:
            path = os.path.join(shard_dir, info["name"])
            assert info["size"] == os.path.getsize(path)
            assert len(info["sha256"]) == 64
            assert info["records"] == N_PER_SHARD
            assert info["row_offset"] == offset
            offset += info["records"]

    def test_run_commits_manifest_and_cursor(self, shard_dir, tmp_path):
        work = tmp_path / "work"
        _ingest(shard_dir, work).run()
        assert (work / MANIFEST_FILE).is_file()
        cursor = json.loads((work / CURSOR_FILE).read_text())
        assert cursor["next_shard"] == N_SHARDS
        assert cursor["rows_ingested"] == N_PER_SHARD * N_SHARDS
        assert cursor["quarantined"] == {}

    def test_unscannable_shard_records_none(self, shard_dir):
        p = os.path.join(shard_dir, "part-00001.avro")
        with open(p, "wb") as f:
            f.write(b"Obj\x01garbage")
        manifest = build_shard_manifest(shard_dir)
        assert manifest["shards"][1]["records"] is None


class TestStreamedEqualsInMemory:
    @pytest.mark.parametrize("window_shards", [1, 2, N_SHARDS])
    def test_equality(self, shard_dir, tmp_path, window_shards):
        mem, imap = _read(shard_dir)
        ds, stats = _ingest(
            shard_dir, tmp_path / f"w{window_shards}",
            index_maps={"features": imap},
            window_shards=window_shards,
        ).run()
        _assert_datasets_equal(mem, ds)
        assert stats["ingested_fraction"] == 1.0
        assert stats["shards_quarantined"] == 0
        assert stats["rows_ingested"] == mem.num_samples

    def test_scanned_vocab_matches_in_memory(self, shard_dir, tmp_path):
        """No prebuilt maps: the streamed scan pass derives the same
        vocabulary and auto tag names as the in-memory reader."""
        mem, imap = _read(shard_dir)
        ing = _ingest(shard_dir, tmp_path / "scan", id_tag_names=None)
        ds, _ = ing.run()
        assert dict(ing.resolved_maps["features"].items()) == dict(
            imap.items())
        assert ing.id_tag_names == ["userId"]
        _assert_datasets_equal(mem, ds)


class TestCorruptShards:
    def test_truncated_data_shard_raises_typed_error_naming_file(
        self, shard_dir
    ):
        p = os.path.join(shard_dir, "part-00002.avro")
        _truncate(p)
        with pytest.raises(CorruptShardError, match="part-00002.avro"):
            list(checked_iter_container_dir(shard_dir))
        with pytest.raises(CorruptShardError, match="part-00002.avro"):
            _read(shard_dir)

    def test_default_policy_aborts_on_first_corrupt_shard(
        self, shard_dir, tmp_path
    ):
        _, imap = _read(shard_dir)
        _truncate(os.path.join(shard_dir, "part-00001.avro"),
                  lambda n: n - 30)
        with pytest.raises(CorruptShardError, match="part-00001.avro"):
            _ingest(shard_dir, tmp_path / "abort",
                    index_maps={"features": imap}).run()

    def test_checksum_mismatch_after_manifest_is_corruption(
        self, shard_dir, tmp_path, serial_ingest_env
    ):
        """Bit rot after the manifest commit (same size, other bytes) is
        caught by the checksum at read time, naming the file, on a shard
        the killed run never reached."""
        _, imap = _read(shard_dir)
        work = tmp_path / "rot"
        _crash_at_third_read(shard_dir, work, imap)
        p = os.path.join(shard_dir, "part-00003.avro")
        raw = bytearray(open(p, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        with open(p, "wb") as f:
            f.write(bytes(raw))
        with pytest.raises(CorruptShardError,
                           match="checksum mismatch") as exc_info:
            _ingest(shard_dir, work, index_maps={"features": imap},
                    resume=True).run()
        assert "part-00003.avro" in str(exc_info.value)

    def test_quarantine_skips_counts_and_surfaces(
        self, shard_dir, tmp_path
    ):
        _, imap = _read(shard_dir)
        p = os.path.join(shard_dir, "part-00002.avro")
        _truncate(p)
        ds, stats = _ingest(
            shard_dir, tmp_path / "q",
            index_maps={"features": imap},
            quarantine=QuarantinePolicy(max_bad_fraction=0.25),
        ).run()
        assert stats["shards_quarantined"] == 1
        assert stats["quarantined_paths"] == [p]
        assert stats["rows_ingested"] == N_PER_SHARD * (N_SHARDS - 1)
        assert 0.0 < stats["ingested_fraction"] < 1.0
        assert ds.num_samples == stats["rows_ingested"]
        # Health surface: the registry gauges carry the degradation.
        from photon_tpu_torch import obs

        gauges = obs.REGISTRY.snapshot()["gauges"]
        assert gauges.get("stream_ingested_fraction") == stats[
            "ingested_fraction"]
        assert gauges.get("stream_quarantined_shards") == 1
        assert gauges.get("stream_rows_ingested") == stats["rows_ingested"]

    def test_quarantine_budget_exceeded_aborts(self, shard_dir, tmp_path):
        _, imap = _read(shard_dir)
        for name in ("part-00001.avro", "part-00003.avro"):
            _truncate(os.path.join(shard_dir, name))
        with pytest.raises(CorruptShardError):
            _ingest(shard_dir, tmp_path / "over",
                    index_maps={"features": imap},
                    quarantine=QuarantinePolicy(max_bad_shards=1)).run()

    def test_policy_validation(self):
        with pytest.raises(ValueError):
            QuarantinePolicy(max_bad_shards=-1)
        with pytest.raises(ValueError):
            QuarantinePolicy(max_bad_fraction=1.5)
        assert QuarantinePolicy(max_bad_fraction=0.5).budget(10) == 5
        assert QuarantinePolicy(max_bad_shards=3).budget(10) == 3


class TestTransientRetry:
    def test_eio_is_transient_checksum_is_not(self):
        import errno

        assert is_transient(OSError(errno.EIO, "Input/output error"))
        assert is_transient(OSError(errno.ESTALE, "Stale file handle"))
        assert not is_transient(OSError(errno.ENOENT, "No such file"))
        assert not is_transient(CorruptShardError("bad shard"))

    def test_injected_transients_retried_to_success(
        self, shard_dir, tmp_path, serial_ingest_env
    ):
        _, imap = _read(shard_dir)
        plan = FaultPlan([
            dict(point="io.shard_read", nth=1),
            dict(point="io.shard_decode", nth=1),
        ], seed=7)
        with faults.injected(plan):
            _, stats = _ingest(shard_dir, tmp_path / "retry",
                               index_maps={"features": imap}).run()
            fired = faults.fired()
        assert len(fired) == 2
        s = retry_stats()
        assert s["retries"] == 2 and s["exhausted"] == 0
        assert s["recovered"] >= 1
        assert stats["ingested_fraction"] == 1.0
        assert stats["retry"] == s
        # ...and a clean rerun records ZERO retries.
        reset_retry_stats()
        _ingest(shard_dir, tmp_path / "clean",
                index_maps={"features": imap}).run()
        assert retry_stats() == {
            "retries": 0, "recovered": 0, "exhausted": 0,
            "backoff_seconds": 0.0,
        }

    def test_exhausted_transients_propagate(
        self, shard_dir, tmp_path, serial_ingest_env
    ):
        _, imap = _read(shard_dir)
        plan = FaultPlan([dict(point="io.shard_read", nth=n)
                          for n in (1, 2, 3)])
        with faults.injected(plan):
            with pytest.raises(TransientError):
                _ingest(shard_dir, tmp_path / "exhaust",
                        index_maps={"features": imap}).run()
        assert retry_stats()["exhausted"] == 1


class TestCursorResume:
    def test_kill_and_resume_is_byte_identical(
        self, shard_dir, tmp_path, serial_ingest_env
    ):
        _, imap = _read(shard_dir)
        full, _ = _ingest(shard_dir, tmp_path / "full",
                          index_maps={"features": imap}).run()
        work = tmp_path / "killed"
        _crash_at_third_read(shard_dir, work, imap)
        cursor = json.loads((work / CURSOR_FILE).read_text())
        assert 0 < cursor["next_shard"] < N_SHARDS
        resumed, stats = _ingest(shard_dir, work,
                                 index_maps={"features": imap},
                                 resume=True).run()
        assert stats["resumed_from_shard"] == cursor["next_shard"]
        _assert_datasets_equal(full, resumed)

    def test_resume_without_cursor_refuses(self, shard_dir, tmp_path):
        with pytest.raises(ResumeMismatchError, match="nothing to resume"):
            _ingest(shard_dir, tmp_path / "none", resume=True).run()

    def test_resume_under_changed_config_refuses(
        self, shard_dir, tmp_path, serial_ingest_env
    ):
        _, imap = _read(shard_dir)
        work = tmp_path / "cfg"
        _crash_at_third_read(shard_dir, work, imap, window_shards=1)
        with pytest.raises(ResumeMismatchError):
            _ingest(shard_dir, work, index_maps={"features": imap},
                    window_shards=2, resume=True).run()

    def test_resume_after_data_change_refuses(
        self, shard_dir, tmp_path, serial_ingest_env
    ):
        """The cursor pins the manifest; a shard rewritten between the
        kill and the resume fails the checksum, never silently mixes."""
        _, imap = _read(shard_dir)
        work = tmp_path / "mix"
        _crash_at_third_read(shard_dir, work, imap)
        p = os.path.join(shard_dir, "part-00004.avro")
        write_training_examples(
            p, np.ones(3), [[(f"f0{DELIMITER}t", 1.0)]] * 3,
            metadata=[{"userId": "u0"}] * 3, uids=np.arange(3),
        )
        with pytest.raises(CorruptShardError, match="part-00004.avro"):
            _ingest(shard_dir, work, index_maps={"features": imap},
                    resume=True).run()

    def test_resume_under_substituted_same_size_vocab_refuses(
        self, shard_dir, tmp_path, serial_ingest_env
    ):
        """A regenerated vocabulary of the SAME size but another
        key->index assignment fails the resume's config check."""
        from photon_tpu_torch.data.index_map import IndexMap

        _, imap = _read(shard_dir)
        work = tmp_path / "vocab"
        _crash_at_third_read(shard_dir, work, imap)
        keys = [k for k, _ in sorted(imap.items(), key=lambda kv: kv[1])]
        permuted = IndexMap({
            k: i for i, k in enumerate(keys[1:-1][::-1] + [keys[0]])
        } | {keys[-1]: len(keys) - 1})
        assert len(permuted) == len(imap)
        assert permuted.intercept_index == imap.intercept_index
        with pytest.raises(ResumeMismatchError):
            _ingest(shard_dir, work, index_maps={"features": permuted},
                    resume=True).run()

    def test_resume_under_tighter_quarantine_budget_refuses(
        self, shard_dir, tmp_path
    ):
        _, imap = _read(shard_dir)
        _truncate(os.path.join(shard_dir, "part-00002.avro"))
        work = tmp_path / "tight"
        _ingest(shard_dir, work, index_maps={"features": imap},
                quarantine=QuarantinePolicy(max_bad_fraction=0.25)).run()
        with pytest.raises(CorruptShardError, match="current policy"):
            _ingest(shard_dir, work, index_maps={"features": imap},
                    resume=True).run()

    def test_fresh_run_rescans_after_shard_repair(
        self, shard_dir, tmp_path
    ):
        """A repaired shard comes back in a FRESH ingest in the same
        work dir: the committed vocabulary's stale quarantine set does
        not exclude it."""
        p = os.path.join(shard_dir, "part-00002.avro")
        raw = _truncate(p)
        work = tmp_path / "repair"
        _, stats = _ingest(
            shard_dir, work, id_tag_names=None,
            quarantine=QuarantinePolicy(max_bad_fraction=0.25),
        ).run()
        assert stats["shards_quarantined"] == 1
        with open(p, "wb") as f:
            f.write(raw)  # repair
        _, stats2 = _ingest(
            shard_dir, work, id_tag_names=None,
            quarantine=QuarantinePolicy(max_bad_fraction=0.25),
        ).run()
        assert stats2["shards_quarantined"] == 0
        assert stats2["ingested_fraction"] == 1.0
        assert stats2["rows_ingested"] == N_PER_SHARD * N_SHARDS

    def test_missing_response_field_is_typed_and_quarantinable(
        self, shard_dir, tmp_path
    ):
        from photon_tpu_torch.io import avro
        from photon_tpu_torch.io.avro_data import RESPONSE_PREDICTION_SCHEMA

        _, imap = _read(shard_dir)
        p = os.path.join(shard_dir, "part-00001.avro")
        avro.write_container(p, RESPONSE_PREDICTION_SCHEMA, [{
            "response": 1.0,
            "features": [{"name": "f0", "term": "t", "value": 1.0}],
            "weight": 1.0, "offset": 0.0,
        }])
        with pytest.raises(CorruptShardError,
                           match="part-00001.avro.*response"):
            _ingest(shard_dir, tmp_path / "drift",
                    index_maps={"features": imap},
                    response_field="label").run()
        _, stats = _ingest(
            shard_dir, tmp_path / "drift2",
            index_maps={"features": imap}, response_field="label",
            quarantine=QuarantinePolicy(max_bad_shards=1),
        ).run()
        assert stats["shards_quarantined"] == 1

    def test_resume_of_completed_ingest_reloads_spills(
        self, shard_dir, tmp_path
    ):
        _, imap = _read(shard_dir)
        work = tmp_path / "done"
        first, _ = _ingest(shard_dir, work,
                           index_maps={"features": imap}).run()
        again, stats = _ingest(shard_dir, work,
                               index_maps={"features": imap},
                               resume=True).run()
        assert stats["resumed_from_shard"] == N_SHARDS
        _assert_datasets_equal(first, again)


class TestWarmStart:
    def _estimator(self):
        from photon_tpu_torch import optim
        from photon_tpu_torch.algorithm.problems import (
            GLMOptimizationConfiguration,
        )
        from photon_tpu_torch.data.random_effect import (
            RandomEffectDataConfiguration,
        )
        from photon_tpu_torch.estimators.game_estimator import (
            FixedEffectCoordinateConfiguration,
            GameEstimator,
            RandomEffectCoordinateConfiguration,
        )
        from photon_tpu_torch.types import TaskType

        def l2(w):
            return GLMOptimizationConfiguration(
                regularization=optim.RegularizationContext(
                    optim.RegularizationType.L2),
                regularization_weight=w,
            )

        return GameEstimator(
            TaskType.LINEAR_REGRESSION,
            {
                "global": FixedEffectCoordinateConfiguration(
                    "features", l2(0.01)),
                "per-user": RandomEffectCoordinateConfiguration(
                    RandomEffectDataConfiguration("userId", "features"),
                    l2(0.5)),
            },
            num_iterations=2,
            device="cpu",
        )

    def test_fit_init_model_path_matches_loaded_model(
        self, shard_dir, tmp_path
    ):
        from photon_tpu_torch.io.model_io import (
            load_checkpoint,
            save_checkpoint,
        )

        _, imap = _read(shard_dir)
        day1, _ = _ingest(shard_dir, tmp_path / "d1",
                          index_maps={"features": imap}).run()
        model1 = self._estimator().fit(day1)[0].model
        ckpt = str(tmp_path / "day1.npz")
        save_checkpoint(model1, ckpt)

        day2, _ = _ingest(shard_dir, tmp_path / "d2",
                          index_maps={"features": imap}).run()
        by_path = self._estimator().fit(day2, init_model=ckpt)[0].model
        by_model = self._estimator().fit(
            day2, initial_model=load_checkpoint(ckpt, "cpu"))[0].model
        np.testing.assert_array_equal(
            np.asarray(by_path["global"].model.coefficients.means),
            np.asarray(by_model["global"].model.coefficients.means))
        np.testing.assert_array_equal(
            np.asarray(by_path["per-user"].coefficients),
            np.asarray(by_model["per-user"].coefficients))

    def test_fit_rejects_both_warm_start_forms(self, shard_dir, tmp_path):
        _, imap = _read(shard_dir)
        day1, _ = _ingest(shard_dir, tmp_path / "both",
                          index_maps={"features": imap}).run()
        model = self._estimator().fit(day1)[0].model
        with pytest.raises(ValueError, match="exactly one"):
            self._estimator().fit(day1, initial_model=model,
                                  init_model=model)

    def test_artifact_digest_stability(self, tmp_path):
        from photon_tpu_torch.io.model_io import artifact_digest

        f = tmp_path / "a.npz"
        f.write_bytes(b"hello")
        assert artifact_digest(str(f)) == artifact_digest(str(f))
        d = tmp_path / "model"
        (d / "sub").mkdir(parents=True)
        (d / "x").write_bytes(b"1")
        (d / "sub" / "y").write_bytes(b"2")
        d1 = artifact_digest(str(d))
        (d / "x").write_bytes(b"changed")
        assert artifact_digest(str(d)) != d1

    def test_load_initial_model_dir_requires_maps(self, tmp_path):
        from photon_tpu_torch.io.model_io import (
            METADATA_FILE,
            load_initial_model,
        )

        d = tmp_path / "avmodel"
        d.mkdir()
        (d / METADATA_FILE).write_text("{}")
        with pytest.raises(ValueError, match="index maps"):
            load_initial_model(str(d), device="cpu")
        with pytest.raises(FileNotFoundError):
            load_initial_model(str(tmp_path / "missing"), device="cpu")


def _cli_config(tmp_path, out="out", mesh=False):
    cfg = {
        "task": "LINEAR_REGRESSION",
        "input": {
            "format": "avro",
            "train_path": "unused-under-stream-dir",
            "id_tags": ["userId"],
        },
        "coordinates": {
            "global": {
                "type": "fixed",
                "regularization": {"type": "L2", "weights": [0.01]},
            },
            "per-user": {
                "type": "random",
                "random_effect_type": "userId",
                "regularization": {"type": "L2", "weights": [0.5]},
            },
        },
        "num_iterations": 2,
        "output_dir": str(tmp_path / out),
    }
    if mesh:
        # The reference trains on one device under the test conftest's
        # eight virtual ones.
        cfg["mesh"] = "off"
    path = tmp_path / f"{out}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


class TestCLI:
    def test_stream_train_end_to_end_with_provenance(
        self, shard_dir, tmp_path
    ):
        from photon_tpu_torch.cli.train import main as train_main

        cfg = _cli_config(tmp_path)
        ckpt = str(tmp_path / "ckpt")
        assert train_main([
            "--config", cfg, "--stream-dir", shard_dir, "--device", "cpu",
            "--checkpoint-dir", ckpt, "--stream-window", "2",
        ]) == 0
        summary = json.loads(
            (tmp_path / "out" / "training-summary.json").read_text())
        si = summary["streaming_ingest"]
        assert si["ingested_fraction"] == 1.0
        assert si["rows_ingested"] == N_PER_SHARD * N_SHARDS
        assert si["work_dir"] == os.path.join(ckpt, "ingest-work")
        manifest = json.loads(
            (tmp_path / "ckpt" / "manifest.json").read_text())
        cursor_meta = manifest["run"]["ingest_cursor"]
        assert cursor_meta["manifest_sha256"] == si["manifest_sha256"]
        assert cursor_meta["rows_ingested"] == si["rows_ingested"]

        # Day 2: warm-start from the saved checkpoint, resume the
        # completed ingest from its cursor (spill reloads).
        init = str(tmp_path / "out" / "models" / "best" / "checkpoint.npz")
        assert train_main([
            "--config", cfg, "--stream-dir", shard_dir, "--device", "cpu",
            "--checkpoint-dir", ckpt, "--stream-window", "2",
            "--resume-ingest", "--init-model", init,
        ]) == 0
        manifest = json.loads(
            (tmp_path / "ckpt" / "manifest.json").read_text())
        assert "init_model" in manifest["run"]
        assert "ingest_cursor" in manifest["run"]
        assert len(manifest["run"]["init_model"]["sha256"]) == 64
        summary = json.loads(
            (tmp_path / "out" / "training-summary.json").read_text())
        assert summary["streaming_ingest"]["resumed_from_shard"] \
            == N_SHARDS

    def test_quarantine_run_reports_degraded_fraction(
        self, shard_dir, tmp_path
    ):
        from photon_tpu_torch.cli.train import main as train_main

        p = os.path.join(shard_dir, "part-00001.avro")
        _truncate(p)
        cfg = _cli_config(tmp_path)
        assert train_main([
            "--config", cfg, "--stream-dir", shard_dir, "--device", "cpu",
            "--max-bad-fraction", "0.25",
        ]) == 0
        summary = json.loads(
            (tmp_path / "out" / "training-summary.json").read_text())
        si = summary["streaming_ingest"]
        assert si["ingested_fraction"] < 1.0
        assert si["shards_quarantined"] == 1
        assert si["quarantined_paths"] == [p]
        assert si["work_dir"] == str(tmp_path / "out" / "ingest-work")

    def test_resume_ingest_requires_stream_dir(self, tmp_path):
        from photon_tpu_torch.cli.train import main as train_main

        with pytest.raises(SystemExit):
            train_main(["--config", _cli_config(tmp_path),
                        "--resume-ingest", "--device", "cpu"])


@pytest.mark.parametrize("field,value,match", [
    ("format", "libsvm", "Avro"),
    ("date_range", "20260101-20260102", "date_range"),
])
def test_cli_refuses_stream_dir_with_other_inputs(shard_dir, tmp_path,
                                                  field, value, match):
    """The reference's checks: Avro input only, no date ranges."""
    from photon_tpu_torch.cli.train import main as train_main

    cfg = json.loads(open(_cli_config(tmp_path)).read())
    cfg["input"][field] = value
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=match):
        train_main(["--config", str(path), "--stream-dir", shard_dir,
                    "--device", "cpu"])


# ---------------------------------------------------------------------------
# the two packages on the same shards
# ---------------------------------------------------------------------------


def _reference_ingest(shard_dir, work, index_maps=None, quarantine=None,
                      **kw):
    """The reference's StreamingIngest on the same arguments, with its
    own IndexMap and QuarantinePolicy types."""
    from photon_tpu.data import stream as jax_stream
    from photon_tpu.data.index_map import IndexMap as JaxIndexMap

    if index_maps is not None:
        index_maps = {s: JaxIndexMap(dict(m.items()))
                      for s, m in index_maps.items()}
    if quarantine is not None:
        quarantine = jax_stream.QuarantinePolicy(
            quarantine.max_bad_shards, quarantine.max_bad_fraction)
    return jax_stream.StreamingIngest(shard_dir, work_dir=str(work),
                                      index_maps=index_maps,
                                      quarantine=quarantine, **kw)


def _assert_matches_reference(jds, pds):
    for col in ("labels", "offsets", "weights"):
        a, b = np.asarray(getattr(jds, col)), getattr(pds, col).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), col
    assert set(jds.feature_shards) == set(pds.feature_shards)
    for s in jds.feature_shards:
        jf, pf = jds.feature_shards[s], pds.feature_shards[s]
        for f in ("indices", "values"):
            a, b = np.asarray(getattr(jf, f)), getattr(pf, f).numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (s, f)
        assert jf.d == pf.d
        for a, b in zip(jds.host_shard_coo(s), pds.host_shard_coo(s)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert set(jds.id_tags) == set(pds.id_tags)
    for t in jds.id_tags:
        assert (np.asarray(jds.id_tags[t].codes).tobytes()
                == pds.id_tags[t].codes.numpy().tobytes())
        assert jds.id_tags[t].inverse == pds.id_tags[t].inverse
    assert jds.uids.tobytes() == pds.uids.tobytes()


def _untimed(stats, drop=()):
    return {k: v for k, v in stats.items()
            if k not in TIME_KEYS and k not in drop}


@pytest.mark.parametrize("window_shards", [1, 2])
@pytest.mark.parametrize("scan", [False, True], ids=["maps", "scan"])
def test_streamed_dataset_matches_reference(shard_dir, tmp_path,
                                            window_shards, scan):
    """The same shards through both packages, one after the other in
    the same work dir: the datasets and index maps bit for bit, the
    manifest byte for byte, the stats on every untimed key."""
    work = tmp_path / "work"
    kw = dict(window_shards=window_shards,
              id_tag_names=None if scan else ["userId"],
              index_maps=None if scan else {"features": _read(shard_dir)[1]})
    jing = _reference_ingest(shard_dir, work, **kw)
    jds, jstats = jing.run()
    jman = (work / MANIFEST_FILE).read_bytes()
    ping = _ingest(shard_dir, work, **kw)
    pds, pstats = ping.run()
    pman = (work / MANIFEST_FILE).read_bytes()
    _assert_matches_reference(jds, pds)
    assert jman == pman
    assert _untimed(jstats) == _untimed(pstats)
    assert jing.id_tag_names == ping.id_tag_names == ["userId"]
    assert (dict(jing.resolved_maps["features"].items())
            == dict(ping.resolved_maps["features"].items()))


def test_quarantine_and_resume_match_reference(shard_dir, tmp_path,
                                               serial_ingest_env):
    """A truncated shard under a budget of one, then a crash at the
    ninth shard read and a resume: both packages quarantine the same
    path, report the same fraction and resume at the same shard, with
    equal datasets."""
    from photon_tpu.data import pipeline as jax_pipeline
    from photon_tpu.resilience import faults as jax_faults

    jax_pipeline.reset_executors()
    _truncate(os.path.join(shard_dir, "part-00001.avro"))
    kw = dict(id_tag_names=["userId"], window_shards=2,
              quarantine=QuarantinePolicy(max_bad_shards=1))
    runs = {}
    for side, make, fmod in (("jax", _reference_ingest, jax_faults),
                             ("pt", _ingest, faults)):
        work = tmp_path / f"work-{side}"
        clean = make(shard_dir, work, **kw).run()
        with fmod.injected(fmod.FaultPlan(
                [dict(point="io.shard_read", nth=9, error="crash")])):
            with pytest.raises(Exception, match="injected crash"):
                make(shard_dir, work, **kw).run()
        runs[side] = (clean, make(shard_dir, work, resume=True,
                                  **kw).run())
    jax_pipeline.reset_executors()
    for (jds, jstats), (pds, pstats) in zip(runs["jax"], runs["pt"]):
        _assert_matches_reference(jds, pds)
        assert (_untimed(jstats, ("work_dir",))
                == _untimed(pstats, ("work_dir",)))
    clean, resumed = runs["pt"]
    assert clean[1]["shards_quarantined"] == 1
    assert resumed[1]["resumed_from_shard"] == 4


def test_stream_cli_models_match_reference(shard_dir, tmp_path):
    """``cli.train --stream-dir`` of both packages on the same shards:
    the same streaming stats and best configuration, the models within
    the training-CLI tests' f32 bounds."""
    from photon_tpu.cli import train as jax_train

    from photon_tpu_torch.cli.train import main as pt_main
    from photon_tpu_torch.io.model_io import load_game_model

    _, imap = _read(shard_dir)
    maps = {"features": imap}
    out = {}
    for side, main, extra in (("jax", jax_train.main, ()),
                              ("pt", pt_main, ("--device", "cpu"))):
        root = tmp_path / side
        root.mkdir()
        cfg = _cli_config(root, mesh=True)
        assert main(["--config", cfg, "--stream-dir", shard_dir,
                     "--stream-window", "2", *extra]) == 0
        summary = json.loads(
            (root / "out" / "training-summary.json").read_text())
        model, _ = load_game_model(str(root / "out" / "models" / "best"),
                                   maps, device="cpu")
        out[side] = (summary, model)
    (js, jm), (ps, pm) = out["jax"], out["pt"]
    assert ps["best_configuration_index"] == js["best_configuration_index"]
    drop = TIME_KEYS + ("work_dir",)
    assert ({k: v for k, v in ps["streaming_ingest"].items()
             if k not in drop}
            == {k: v for k, v in js["streaming_ingest"].items()
                if k not in drop})
    np.testing.assert_allclose(
        pm["global"].model.coefficients.means.numpy(),
        jm["global"].model.coefficients.means.numpy(), rtol=0,
        atol=FE_ATOL)
    assert pm["per-user"].entity_keys == jm["per-user"].entity_keys
    np.testing.assert_array_equal(pm["per-user"].proj_all,
                                  jm["per-user"].proj_all)
    np.testing.assert_allclose(pm["per-user"].coefficients.numpy(),
                               jm["per-user"].coefficients.numpy(), rtol=0,
                               atol=RE_ATOL)


# -- the data-health sketch ------------------------------------------------


@pytest.fixture
def health_armed():
    from photon_tpu.obs import health as jax_health
    from photon_tpu_torch.obs import health

    for h in (health, jax_health):
        h.reset()
        h.enable()
    yield health
    for h in (health, jax_health):
        h.reset()
        h.disable()


@pytest.mark.parametrize("window_shards", [1, 2])
def test_health_sketch_matches_reference(shard_dir, tmp_path, health_armed,
                                         window_shards):
    """Both packages armed, the same shards: each writes
    ``ingest-sketch.json`` beside its cursor, byte for byte the same,
    and registers it as the in-process train sketch."""
    from photon_tpu.obs import health as jax_health

    kw = dict(window_shards=window_shards,
              index_maps={"features": _read(shard_dir)[1]})
    _, jstats = _reference_ingest(shard_dir, tmp_path / "j", **kw).run()
    _, pstats = _ingest(shard_dir, tmp_path / "p", **kw).run()
    want = (tmp_path / "j" / SKETCH_FILE).read_bytes()
    got = (tmp_path / "p" / SKETCH_FILE).read_bytes()
    assert got == want
    assert pstats["health_sketch_path"] == str(tmp_path / "p" / SKETCH_FILE)
    assert health_armed.train_sketch().to_bytes() == got
    assert jax_health.train_sketch().to_bytes() == want
    sketch = health_armed.DataSketch.load(pstats["health_sketch_path"])
    assert sketch.rows == N_PER_SHARD * N_SHARDS
    # Three drawn features and the intercept per row.
    assert sketch.shards["features"]["values"].count == (
        N_PER_SHARD * N_SHARDS * 4)


@pytest.mark.parametrize("serial", [False, True], ids=["pipelined", "serial"])
def test_kill_and_resume_sketch_byte_identical(shard_dir, tmp_path,
                                               health_armed, monkeypatch,
                                               serial):
    """A crash at the third shard read, then a resume: the committed
    windows re-fold from their spills in window order, so the sketch
    equals the uninterrupted run's byte for byte, whether the windows
    decode on the chunk pool or inline."""
    if serial:
        monkeypatch.setenv("PHOTON_TPU_SERIAL_INGEST", "1")
    pipeline.reset_executors()
    imap = _read(shard_dir)[1]
    kw = dict(window_shards=1, index_maps={"features": imap})
    _ingest(shard_dir, tmp_path / "whole", **kw).run()
    want = (tmp_path / "whole" / SKETCH_FILE).read_bytes()
    killed = tmp_path / "killed"
    with faults.injected(FaultPlan(
            [dict(point="io.shard_read", nth=3, error="crash")])):
        with pytest.raises(InjectedCrash):
            _ingest(shard_dir, killed, **kw).run()
    partial = health_armed.DataSketch.load(str(killed / SKETCH_FILE))
    assert 0 < partial.rows < N_PER_SHARD * N_SHARDS
    _ingest(shard_dir, killed, resume=True, **kw).run()
    assert (killed / SKETCH_FILE).read_bytes() == want
    monkeypatch.delenv("PHOTON_TPU_SERIAL_INGEST", raising=False)
    pipeline.reset_executors()


def test_disarmed_ingest_writes_no_sketch(shard_dir, tmp_path):
    from photon_tpu_torch.obs import health

    assert not health.enabled()
    _, stats = _ingest(shard_dir, tmp_path / "off",
                       index_maps={"features": _read(shard_dir)[1]}).run()
    assert not (tmp_path / "off" / SKETCH_FILE).exists()
    assert "health_sketch_path" not in stats
