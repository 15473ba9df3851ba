"""The port's serving slice against the JAX package's, on the CPU.

A model made with numpy from a seed is saved by the JAX package's
``save_checkpoint`` and loaded by the port's ``load_checkpoint`` (the
weight carry-across); the same requests then go through the JAX
``MicroBatchQueue`` and the port's, and every per-request score must
agree: 1e-5 for f32 tables, 5e-2 for bf16 tables (the serving parity
gate; see tests/test_torch_serve_kernel.py for why bf16 differs at all).
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.io import model_io as jax_io
from photon_tpu.models.game import FixedEffectModel as JaxFixed
from photon_tpu.models.game import GameModel as JaxGame
from photon_tpu.models.game import RandomEffectModel as JaxRandom
from photon_tpu.models.glm import Coefficients as JaxCoefficients
from photon_tpu.models.glm import GeneralizedLinearModel as JaxGLM
from photon_tpu.serve.programs import ScorePrograms as JaxPrograms
from photon_tpu.serve.programs import ShapeLadder as JaxLadder
from photon_tpu.serve.queue import MicroBatchQueue as JaxQueue
from photon_tpu.serve.tables import CoefficientTables as JaxTables
from photon_tpu.types import TaskType as JaxTask

from photon_tpu_torch.cli import serve as serve_cli
from photon_tpu_torch.io import model_io
from photon_tpu_torch.ops import serve_kernel
from photon_tpu_torch.serve.driver import drive, synthetic_requests
from photon_tpu_torch.serve.programs import ScorePrograms, ShapeLadder
from photon_tpu_torch.serve.queue import MicroBatchQueue, QueueClosed
from photon_tpu_torch.serve.tables import CoefficientTables

D, DU, DM = 6, 8, 5
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
RUNGS = (1, 8, 64)


def _re(rng, entities, width, slots):
    proj = np.stack([
        np.sort(rng.choice(width, size=slots, replace=False))
        for _ in range(entities)
    ]).astype(np.int64)
    proj[1, -1] = -1
    return rng.normal(size=(entities, slots)).astype(np.float32), proj


def jax_model(seed=7, users=12, scale=1.0) -> JaxGame:
    """A fixed effect plus per-user and per-movie coordinates."""
    rng = np.random.default_rng(seed)
    task = JaxTask.LOGISTIC_REGRESSION
    wu, pu = _re(rng, users, DU, 4)
    wm, pm = _re(rng, 5, DM, 3)

    def random(w, p, re_type, shard):
        return JaxRandom(
            coefficients=jnp.asarray(w * scale), random_effect_type=re_type,
            feature_shard_id=shard, task=task, proj_all=p,
            entity_keys=tuple(f"{re_type}-{i}" for i in range(len(w))),
        )

    means = rng.normal(size=D).astype(np.float32) * scale
    return JaxGame({
        "global": JaxFixed(JaxGLM(JaxCoefficients(jnp.asarray(means)), task),
                           "features"),
        "per-user": random(wu, pu, "userId", "userShard"),
        "per-movie": random(wm, pm, "movieId", "movieShard"),
    })


def port_model_via_checkpoint(tmp_path, name="m", **kw):
    path = str(tmp_path / f"{name}.npz")
    jax_io.save_checkpoint(jax_model(**kw), path)
    return model_io.load_checkpoint(path, "cpu"), path


def port_server(model, precision="float32"):
    tables = CoefficientTables.from_game_model(model, precision, "cpu")
    return tables, ScorePrograms(tables, ladder=ShapeLadder(RUNGS))


def queue_scores(queue, requests) -> np.ndarray:
    futs = [queue.submit(f, ids) for f, ids in requests]
    return np.array([f.result(timeout=60) for f in futs], np.float32)


def test_checkpoint_written_by_jax_loads_in_the_port(tmp_path):
    jm = jax_model()
    path = str(tmp_path / "ckpt.npz")
    jax_io.save_checkpoint(jm, path, extra_meta={"day": 3})
    pm, meta = model_io.load_checkpoint_meta(path, "cpu")
    assert meta == {"day": 3}
    assert list(pm.models) == list(jm.models)
    np.testing.assert_array_equal(
        pm["global"].model.coefficients.means.numpy(),
        np.asarray(jm["global"].model.coefficients.means))
    for name in ("per-user", "per-movie"):
        j, p = jm[name], pm[name]
        np.testing.assert_array_equal(p.coefficients.numpy(),
                                      np.asarray(j.coefficients))
        np.testing.assert_array_equal(p.proj_all, j.proj_all)
        assert p.entity_keys == j.entity_keys
        assert (p.random_effect_type, p.feature_shard_id) == (
            j.random_effect_type, j.feature_shard_id)
        assert p.task.value == j.task.value


def test_checkpoint_written_by_the_port_loads_in_jax(tmp_path):
    pm, _ = port_model_via_checkpoint(tmp_path)
    path = model_io.save_checkpoint(pm, str(tmp_path / "back"))
    jm = jax_io.load_checkpoint(path)
    for name, sub in pm.items():
        ours = (sub.model.coefficients.means if name == "global"
                else sub.coefficients)
        theirs = (jm[name].model.coefficients.means if name == "global"
                  else jm[name].coefficients)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_corrupt_and_missing_checkpoints(tmp_path):
    _, path = port_model_via_checkpoint(tmp_path)
    torn = tmp_path / "torn.npz"
    torn.write_bytes(open(path, "rb").read()[:200])
    with pytest.raises(model_io.CorruptModelError):
        model_io.load_checkpoint(str(torn), "cpu")
    with pytest.raises(FileNotFoundError):
        model_io.load_checkpoint(str(tmp_path / "absent.npz"), "cpu")


@pytest.mark.parametrize("max_batch", [None, 8])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_jax_checkpoint_serves_the_same_scores_through_the_port_queue(
    tmp_path, monkeypatch, precision, max_batch
):
    monkeypatch.setenv("PHOTON_SERVE_KERNEL", "off")
    model, path = port_model_via_checkpoint(tmp_path)
    tables, programs = port_server(model, precision)
    requests = synthetic_requests(tables, programs, 150, cold_fraction=0.2,
                                  seed=1)
    jtables = JaxTables.from_game_model(jax_io.load_checkpoint(path),
                                        precision)
    jprograms = JaxPrograms(jtables, ladder=JaxLadder(RUNGS))
    with JaxQueue(jprograms, max_linger_s=0.001) as jq:
        ref = queue_scores(jq, requests)
    with MicroBatchQueue(programs, max_batch=max_batch,
                         max_linger_s=0.001) as q:
        got = queue_scores(q, requests)
        summary = drive(q, requests)
    np.testing.assert_allclose(got, ref, atol=TOL[precision], rtol=0)
    assert summary["errors"] == 0
    assert summary["requests"] == 150 - summary["warmup_requests"]
    assert 0.0 < summary["cold_entity_rate"] < 0.5
    assert set(summary["cold_entity_rate_by_coordinate"]) == {
        "per-user", "per-movie"}


def test_values_only_reload_matches_a_fresh_build(tmp_path):
    model, _ = port_model_via_checkpoint(tmp_path)
    tables, programs = port_server(model)
    requests = synthetic_requests(tables, programs, 8, seed=2)
    feats, codes, _ = programs.pack_requests(requests)
    before = programs.score_padded(feats, codes, 8)
    live = tables.random["per-user"].weights
    refreshed, _ = port_model_via_checkpoint(tmp_path, "r", scale=2.0)
    assert tables.reload(refreshed) is True
    assert tables.generation == 1
    assert tables.random["per-user"].weights is live  # copied in place
    after = programs.score_padded(feats, codes, 8)
    _, fresh = port_server(refreshed)
    np.testing.assert_array_equal(after, fresh.score_padded(feats, codes, 8))
    assert not np.allclose(after, before)


def test_structure_change_reload_returns_false(tmp_path):
    model, _ = port_model_via_checkpoint(tmp_path)
    tables, _ = port_server(model)
    grown, _ = port_model_via_checkpoint(tmp_path, "g", users=13)
    assert tables.reload(grown) is False
    assert tables.random["per-user"].num_entities == 13
    assert tables.generation == 1


def test_serve_cli_on_cpu(tmp_path, capsys):
    _, path = port_model_via_checkpoint(tmp_path)
    out_json = tmp_path / "summary.json"
    rc = serve_cli.main([
        "--checkpoint", path, "--synthetic", "300", "--batch-sizes",
        "1,8,64", "--device", "cpu", "--precision", "bfloat16",
        "--json", str(out_json),
    ])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(out_json.read_text())
    for key in ("p50_ms", "p99_ms", "qps", "batch_fill_fraction",
                "cold_entity_rate", "dispatches", "kernel_launches",
                "compile_events_during_serving"):
        assert key in line
    assert line["errors"] == 0 and line["device"] == "cpu"
    assert line["precision"] == "bfloat16"
    assert line["kernel_launches"] == 0  # the CPU runs the plain version
    assert sum(line["dispatches"].values()) >= line["batches"] > 0


def test_entry_points_default_to_the_gpu(tmp_path):
    _, path = port_model_via_checkpoint(tmp_path)
    if torch.cuda.is_available():
        model = model_io.load_checkpoint(path)
        assert model["global"].model.coefficients.means.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_io.load_checkpoint(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.build_server(path)


def test_queue_close_drains_and_rejects(tmp_path):
    model, _ = port_model_via_checkpoint(tmp_path)
    tables, programs = port_server(model)
    requests = synthetic_requests(tables, programs, 40, seed=3)
    q = MicroBatchQueue(programs, max_linger_s=0.05)
    futs = [q.submit(f, ids) for f, ids in requests]
    assert q.close(timeout=60)
    assert all(f.done() and f.exception() is None for f in futs)
    with pytest.raises(QueueClosed):
        q.submit(*requests[0])
    assert q.stats()["batched_requests"] == 40


def test_quiesce_holds_dispatch(tmp_path):
    model, _ = port_model_via_checkpoint(tmp_path)
    tables, programs = port_server(model)
    requests = synthetic_requests(tables, programs, 4, seed=4)
    with MicroBatchQueue(programs, max_linger_s=0.0) as q:
        with q.quiesce():
            fut = q.submit(*requests[0])
            time.sleep(0.05)
            assert not fut.done()
        assert fut.result(timeout=60) == pytest.approx(
            queue_scores(q, requests[:1])[0])


def test_dispatch_error_goes_to_its_batch_only(tmp_path):
    model, _ = port_model_via_checkpoint(tmp_path)
    tables, programs = port_server(model)
    good = synthetic_requests(tables, programs, 2, seed=5)
    bad = ({"features": np.zeros(D + 1, np.float32)}, {})
    with MicroBatchQueue(programs, max_linger_s=0.0) as q:
        with pytest.raises(ValueError):
            q.submit(*bad).result(timeout=60)
        assert np.isfinite(queue_scores(q, good)).all()
        assert q.stats()["dispatch_errors"] == 1


def test_ladder_rungs():
    ladder = ShapeLadder((64, 1, 8, 8))
    assert ladder.rungs == (1, 8, 64)
    assert [ladder.rung_for(n) for n in (1, 2, 8, 9, 64)] == [1, 8, 8, 64, 64]
    with pytest.raises(ValueError):
        ladder.rung_for(65)
    with pytest.raises(ValueError):
        ShapeLadder((0,))


def test_kernel_launch_counter_is_untouched_on_cpu(tmp_path):
    model, _ = port_model_via_checkpoint(tmp_path)
    tables, programs = port_server(model)
    before = serve_kernel.launches
    programs.score_padded(*programs.pack_requests(
        synthetic_requests(tables, programs, 3, seed=6))[:2], 3)
    assert serve_kernel.launches == before
