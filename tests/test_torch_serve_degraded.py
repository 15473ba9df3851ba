"""The port's serving queue in degraded mode, its hot reload and
``cli.serve --input``, against the JAX package's.

The JAX package's ``TestDegradedServing`` (tests/test_serve.py, 12
cases) and ``TestPipelinedStaging`` (4 cases) run case by case on the
port's ``MicroBatchQueue`` with the same model shape and assert the same
outcomes. Then parity: the same model and requests through both
packages' queues give the same scores (1e-5 with f32 tables, 5e-2 with
bf16 tables, the serving gates; see tests/test_torch_serve_kernel.py for
why bf16 differs at all) before a reload, after a values-only reload and
after a structure-change reload, and the same ``health()`` counters
under one deterministic fault plan; ``cli.serve --model-dir --input``
runs as the JAX package's does on the same Avro files, and its
per-request scores equal the port's ``cli.score`` on the same rows
within 1e-5.

On the CPU there are no CUDA graphs and every dispatch is eager; the
tests marked ``cuda`` check the captured ladder on the card. The JAX
side is imported where it is used, so those run without JAX.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from photon_tpu_torch.cli import score as score_cli
from photon_tpu_torch.cli import serve as serve_cli
from photon_tpu_torch.io import model_io
from photon_tpu_torch.ops import serve_kernel
from photon_tpu_torch.resilience import (
    CircuitOpenError,
    DeadlineExceededError,
    FaultPlan,
    OverloadedError,
    PoisonError,
    ShutdownError,
    faults,
    reset_retry_stats,
)
from photon_tpu_torch.serve.driver import drive, synthetic_requests
from photon_tpu_torch.serve.programs import ScorePrograms, ShapeLadder
from photon_tpu_torch.serve.queue import MicroBatchQueue
from photon_tpu_torch.serve.tables import CoefficientTables

D, DU, E, S = 6, 5, 9, 3
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.fixture(autouse=True)
def _clean():
    faults.disarm()
    reset_retry_stats()
    yield
    faults.disarm()


@pytest.fixture
def rng():
    return np.random.default_rng(20260729)


def glmix_arrays(rng, *, scale=1.0, entities=E, task="LINEAR_REGRESSION"):
    """The JAX package's test model: a dense fixed effect and a per-user
    coordinate whose projector comes from a fixed seed, so two draws
    with equal ``entities`` differ only in coefficient values."""
    prng = np.random.default_rng(1234)
    proj = np.sort(np.stack([prng.permutation(DU)[:S]
                             for _ in range(entities)]), axis=1)
    arrays = {
        "global/means": (scale * rng.normal(size=D)).astype(np.float32),
        "per-user/coefficients": (
            scale * rng.normal(size=(entities, S))).astype(np.float32),
        "per-user/proj_all": proj.astype(np.int64),
    }
    manifest = {
        "global": {"kind": "fixed", "shard": "features", "task": task},
        "per-user": {"kind": "random", "re_type": "userId",
                     "shard": "userShard", "task": task,
                     "entity_keys": [str(i) for i in range(entities)]},
    }
    return arrays, manifest


def glmix_model(rng, device="cpu", **kw):
    return model_io.game_model_from_numpy(*glmix_arrays(rng, **kw), device)


def server(rng, rungs=(1, 4), precision="float32", device="cpu", **kw):
    tables = CoefficientTables.from_game_model(
        glmix_model(rng, device, **kw), precision, device)
    return tables, ScorePrograms(tables, ladder=ShapeLadder(rungs))


def request(rng, user="1"):
    return ({"features": rng.normal(size=D).astype(np.float32),
             "userShard": rng.normal(size=DU).astype(np.float32)},
            {"userId": user})


def requests(seed, n):
    prng = np.random.default_rng(seed)
    return [({"features": prng.normal(size=D).astype(np.float32),
              "userShard": prng.normal(size=DU).astype(np.float32)},
             {"userId": str(i % (E + 2))})  # some cold
            for i in range(n)]


def wait_drained(q):
    deadline = time.time() + 10
    while q.stats()["queued_now"] and time.time() < deadline:
        time.sleep(0.01)


# -- TestDegradedServing ----------------------------------------------------


def test_expired_deadline_fails_fast_before_dispatch(rng):
    _, programs = server(rng)
    with MicroBatchQueue(programs, max_batch=4, max_linger_s=0.2) as q:
        dead = q.submit(*request(rng), deadline_s=0.0)
        assert isinstance(dead.exception(timeout=10), DeadlineExceededError)
        ok = q.submit(*request(rng))
        assert np.isfinite(ok.result(timeout=10))
    stats = q.stats()
    assert stats["deadline_expired"] == 1
    assert stats["batched_requests"] == 1


def test_default_deadline_applies(rng):
    _, programs = server(rng)
    with MicroBatchQueue(programs, max_batch=4, max_linger_s=0.2,
                         default_deadline_s=0.0) as q:
        fut = q.submit(*request(rng))
        assert isinstance(fut.exception(timeout=10), DeadlineExceededError)


def test_deadline_tighter_than_linger_is_served(rng):
    _, programs = server(rng)
    with MicroBatchQueue(programs, max_batch=4, max_linger_s=5.0) as q:
        t0 = time.perf_counter()
        fut = q.submit(*request(rng), deadline_s=0.25)
        assert np.isfinite(fut.result(timeout=10))
        assert time.perf_counter() - t0 < 2.0
    stats = q.stats()
    assert stats["deadline_expired"] == 0
    assert stats["batched_requests"] == 1


def test_shed_beyond_watermark(rng):
    _, programs = server(rng)
    release = threading.Event()

    class Slow:
        ladder = programs.ladder
        tables = programs.tables

        def pack_requests(self, reqs):
            release.wait(30)
            return programs.pack_requests(reqs)

        def score_padded(self, *a):
            return programs.score_padded(*a)

    q = MicroBatchQueue(Slow(), max_batch=1, max_linger_s=0.0,
                        shed_watermark=2)
    try:
        first = q.submit(*request(rng))
        wait_drained(q)
        queued = [q.submit(*request(rng)) for _ in range(2)]
        with pytest.raises(OverloadedError):
            q.submit(*request(rng))
        assert q.stats()["shed"] == 1
        release.set()
        assert np.isfinite(first.result(timeout=10))
        for f in queued:
            assert np.isfinite(f.result(timeout=10))
    finally:
        release.set()
        q.close()


def test_transient_dispatch_fault_is_retried(rng):
    _, programs = server(rng)
    plan = FaultPlan([dict(point="serve.dispatch", nth=1,
                           error="transient")])
    with faults.injected(plan):
        with MicroBatchQueue(programs, max_linger_s=0.001) as q:
            assert np.isfinite(q.submit(*request(rng)).result(timeout=10))
    stats = q.stats()
    assert stats["dispatch_retries"] == 1
    assert stats["dispatch_errors"] == 0


def test_poison_fans_out_to_its_batch_only(rng):
    _, programs = server(rng)
    plan = FaultPlan([dict(point="serve.dispatch", nth=1, error="poison")])
    with faults.injected(plan):
        with MicroBatchQueue(programs, max_batch=4,
                             max_linger_s=0.01) as q:
            bad = [q.submit(*request(rng)) for _ in range(4)]
            for f in bad:
                f.exception(timeout=10)
            good = [q.submit(*request(rng)) for _ in range(4)]
            for f in good:
                assert np.isfinite(f.result(timeout=10))
    assert all(isinstance(f.exception(), PoisonError) for f in bad)
    stats = q.stats()
    assert stats["dispatch_errors"] == 1
    assert stats["dispatch_retries"] == 0


def test_breaker_trips_drains_and_resets(rng):
    _, programs = server(rng)
    plan = FaultPlan([dict(point="serve.dispatch", probability=1.0,
                           error="poison")], seed=1)
    q = MicroBatchQueue(programs, max_batch=1, max_linger_s=0.0,
                        breaker_threshold=2)
    try:
        with faults.injected(plan):
            futs = [q.submit(*request(rng)) for _ in range(2)]
            for f in futs:
                assert isinstance(f.exception(timeout=10), PoisonError)
            with pytest.raises(CircuitOpenError):
                q.submit(*request(rng))
        health = q.health()
        assert health["breaker_open"] is True
        assert health["breaker_trips"] == 1
        assert health["breaker_rejected"] == 1
        q.reset_breaker()
        assert np.isfinite(q.submit(*request(rng)).result(timeout=10))
        assert q.health()["breaker_open"] is False
    finally:
        q.close()


def test_breaker_drains_the_staged_batch_too(rng):
    """The breaker's drain takes the pending deque and the batch the
    pipelined worker already staged: no future strands."""
    _, programs = server(rng, rungs=(1, 2))
    release, submitted = threading.Event(), threading.Event()

    class Failing:
        ladder = programs.ladder
        tables = programs.tables

        def pack_requests(self, reqs):
            submitted.wait(30)  # all six queued before the first pack
            return programs.pack_requests(reqs)

        def dispatch_padded(self, *a):
            return None

        def fetch_padded(self, handle, exclude_seconds=0.0):
            release.wait(30)
            raise PoisonError("device fault")

    q = MicroBatchQueue(Failing(), max_batch=2, max_linger_s=0.0,
                        breaker_threshold=1)
    try:
        futs = [q.submit(*request(rng)) for _ in range(6)]
        submitted.set()
        deadline = time.time() + 10
        while q.stats()["staged_batches"] == 0 and time.time() < deadline:
            time.sleep(0.01)
        release.set()
        errors = [type(f.exception(timeout=10)) for f in futs]
        assert PoisonError in errors and CircuitOpenError in errors
        assert q.stats()["staged_batches"] == 1
    finally:
        release.set()
        q.close()


def test_close_timeout_strands_queued_requests(rng):
    _, programs = server(rng)
    release = threading.Event()

    class Wedged:
        ladder = programs.ladder
        tables = programs.tables

        def pack_requests(self, reqs):
            release.wait(60)
            raise RuntimeError("wedged dispatch released")

        def score_padded(self, *a):  # pragma: no cover
            raise AssertionError

    q = MicroBatchQueue(Wedged(), max_batch=1, max_linger_s=0.0,
                        dispatch_retry=None)
    try:
        in_flight = q.submit(*request(rng))
        wait_drained(q)
        queued = q.submit(*request(rng))
        t0 = time.time()
        assert q.close(timeout=0.3) is False
        assert time.time() - t0 < 5
        assert isinstance(queued.exception(timeout=1), ShutdownError)
        assert q.stats()["shutdown_stranded"] == 1
        assert not in_flight.done()
    finally:
        release.set()


def test_wedged_dispatch_cannot_hang_context_exit(rng):
    _, programs = server(rng)
    release = threading.Event()

    class Wedged:
        ladder = programs.ladder
        tables = programs.tables

        def pack_requests(self, reqs):
            release.wait(60)
            raise RuntimeError("wedged dispatch released")

        def score_padded(self, *a):  # pragma: no cover
            raise AssertionError

    try:
        t0 = time.time()
        with MicroBatchQueue(Wedged(), max_batch=1, max_linger_s=0.0,
                             dispatch_retry=None,
                             close_timeout_s=0.3) as q:
            q.submit(*request(rng))
            wait_drained(q)
            queued = q.submit(*request(rng))
        assert time.time() - t0 < 8
        assert isinstance(queued.exception(timeout=1), ShutdownError)
        t0 = time.time()
        assert q.close() is False
        assert time.time() - t0 < 2
        assert q.stats()["shutdown_stranded"] == 1
    finally:
        release.set()


def test_close_without_timeout_still_drains(rng):
    _, programs = server(rng)
    q = MicroBatchQueue(programs, max_linger_s=10.0)
    futs = [q.submit(*request(rng)) for _ in range(5)]
    assert q.close() is True
    assert all(np.isfinite(f.result(timeout=1)) for f in futs)


def test_health_snapshot_fields(rng):
    tables, programs = server(rng)
    with MicroBatchQueue(programs, max_linger_s=0.001, shed_watermark=100,
                         breaker_threshold=8, default_deadline_s=5.0) as q:
        q.submit(*request(rng)).result(timeout=10)
        health = q.health()
    assert health["queue_depth"] == 0
    assert health["requests"] == 1
    assert health["breaker_open"] is False
    assert health["shed"] == 0
    assert health["deadline_expired"] == 0
    assert health["dispatch_retries"] == 0
    assert health["shed_watermark"] == 100
    assert health["breaker_threshold"] == 8
    assert health["table_generation"] == 0
    tables.reload(glmix_model(np.random.default_rng(5), scale=2.0))
    assert q.health()["table_generation"] == 1


def test_clean_run_records_zero_degraded_events(rng):
    tables, programs = server(rng)
    reqs = synthetic_requests(tables, programs, 120, seed=3)
    with MicroBatchQueue(programs, max_linger_s=0.001, shed_watermark=4096,
                         breaker_threshold=8,
                         default_deadline_s=30.0) as q:
        out = drive(q, reqs, warmup=20)
    assert out["errors"] == 0
    health = q.health()
    for key in ("shed", "deadline_expired", "dispatch_retries",
                "dispatch_errors", "breaker_trips"):
        assert health[key] == 0, (key, health)


# -- TestPipelinedStaging ---------------------------------------------------


def test_pipelined_matches_serial_byte_identical(rng):
    arrays = glmix_arrays(rng)
    reqs = requests(7, 60)
    outs = {}
    for pipelined in (False, True):
        tables = CoefficientTables.from_game_model(
            model_io.game_model_from_numpy(*arrays, "cpu"), "float32",
            "cpu")
        programs = ScorePrograms(tables, ladder=ShapeLadder((1, 4)))
        with MicroBatchQueue(programs, max_linger_s=0.001,
                             pipeline_staging=pipelined) as q:
            futs = [q.submit(*r) for r in reqs]
            outs[pipelined] = np.asarray(
                [f.result(timeout=30) for f in futs])
        if pipelined:
            assert q.stats()["staged_batches"] >= 1
    assert np.array_equal(outs[False], outs[True])


def test_staging_stats_surfaced(rng):
    _, programs = server(rng, rungs=(1, 4, 16))
    # 200 requests, not the JAX package's 30: the producer stays ahead
    # of the worker, so some batch is staged however the threads run.
    with MicroBatchQueue(programs, max_linger_s=0.001) as q:
        for f in [q.submit(*r) for r in requests(9, 200)]:
            f.result(timeout=30)
    stats = q.stats()
    assert stats["staged_batches"] >= 1
    assert 0.0 <= stats["staging_overlap_fraction"] <= 1.0
    assert stats["staging_seconds"] >= 0.0
    assert q.health()["pipeline_staging"] is True
    # The staging counters reach the queue's /metrics families.
    fams = {f["name"]: f for f in q.metrics_families()}
    assert fams["serve_staged_batches_total"]["samples"][0][2] == float(
        stats["staged_batches"])
    assert 0.0 <= fams["serve_staging_overlap_fraction"]["samples"][0][
        2] <= 1.0


def test_hammer_quiesce_and_reload_mid_stream(rng):
    """Concurrent producers, a quiesce window and two values-only
    reloads on the live pipelined queue: every future resolves and the
    counters balance."""
    _, programs = server(rng, rungs=(1, 4, 16))
    futures: list = []
    lock = threading.Lock()
    with MicroBatchQueue(programs, max_linger_s=0.001, max_queue=64) as q:

        def producer(seed):
            prng = np.random.default_rng(seed)
            for _ in range(40):
                fut = q.submit(
                    {"features": prng.normal(size=D).astype(np.float32),
                     "userShard": prng.normal(size=DU).astype(np.float32)},
                    {"userId": str(seed % E)})
                with lock:
                    futures.append(fut)

        threads = [threading.Thread(target=producer, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for attempt in range(2):
            out = q.reload_model(
                glmix_model(np.random.default_rng(100 + attempt)))
            assert out["values_only"] is True
            assert out["programs_compiled"] == 0
        with q.quiesce():
            time.sleep(0.01)
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    assert len(futures) == 160
    assert all(f.done() for f in futures)
    assert np.isfinite([f.result(timeout=1) for f in futures]).all()
    stats = q.stats()
    assert stats["requests"] == 160
    assert stats["batched_requests"] == 160
    assert stats["dispatch_errors"] == 0


def test_serial_flag_disables_staging(rng):
    _, programs = server(rng, rungs=(1, 4, 16))
    with MicroBatchQueue(programs, max_linger_s=0.001,
                         pipeline_staging=False) as q:
        for f in [q.submit(*r) for r in requests(5, 12)]:
            assert np.isfinite(f.result(timeout=30))
    stats = q.stats()
    assert stats["staged_batches"] == 0
    assert stats["staging_overlapped_seconds"] == 0.0
    assert q.health()["pipeline_staging"] is False


# -- the queue's other surfaces ---------------------------------------------


@pytest.mark.parametrize("kw", [dict(slo="policy"),
                                dict(latency_window_s=5.0),
                                dict(hotness_k=8)])
def test_observability_options_raise_naming_item_10(rng, kw):
    """The queue's live-monitoring options, which raised naming ROADMAP
    item 10 until it was ported (the name is kept): each is accepted
    and shows in ``health()`` and the hotness sketches."""
    from photon_tpu_torch.obs.monitor import SloPolicy

    if kw.get("slo") == "policy":
        kw = dict(slo=SloPolicy(p99_ms=60_000.0))
    _, programs = server(rng)
    with MicroBatchQueue(programs, max_linger_s=0.0, **kw) as q:
        for f in [q.submit(*r) for r in requests(3, 12)]:
            f.result(timeout=30)
        health = q.health()
    assert health["window_latency"]["count"] == 12
    assert health["window_latency"]["window_seconds"] == (
        kw.get("latency_window_s", 10.0) * 6)
    assert ("slo" in health) == ("slo" in kw)
    if "slo" in kw:
        assert health["slo"]["healthy"]
    assert q.hotness["per-user"].k == kw.get("hotness_k", 64)


def test_cpu_ladder_captures_nothing(rng):
    """No CUDA graphs on the CPU: compile_all captures nothing and every
    dispatch is the eager plain version."""
    _, programs = server(rng, rungs=(1, 8))
    programs.compile_all()
    assert programs.stats["programs_compiled"] == 0
    assert programs.compile_rung(8) is None
    with pytest.raises(ValueError, match="not a ladder rung"):
        programs.compile_rung(3)
    feats, codes, _ = programs.pack_requests(requests(1, 5))
    handle = programs.dispatch_padded(feats, codes, 5)
    assert handle.graph is None
    assert programs.fetch_padded(handle).shape == (5,)


def test_structure_reload_on_the_live_queue(rng):
    """A structure change (more entities) swaps tables and ladder
    inside one quiesce window while producers keep submitting: nothing
    is dropped, and the adopted ladder scores the new model."""
    tables, programs = server(rng, rungs=(1, 4))
    grown = glmix_model(np.random.default_rng(3), entities=E + 4)
    reqs = requests(11, 80)
    with MicroBatchQueue(programs, max_linger_s=0.001) as q:
        first = [q.submit(*r) for r in reqs[:40]]
        info = q.reload_model(grown)
        second = [q.submit(*r) for r in reqs[40:]]
        vals = [f.result(timeout=30) for f in first + second]
        assert q.programs is not programs
        assert q.programs.tables is tables
    assert info["values_only"] is False
    assert info["generation"] == 1 and info["quiesce_seconds"] >= 0
    assert np.isfinite(vals).all()
    _, fresh = server(np.random.default_rng(3), rungs=(1, 4),
                      entities=E + 4)
    feats, codes, _ = fresh.pack_requests(reqs[40:44])
    np.testing.assert_array_equal(
        vals[40:44], fresh.score_padded(feats, codes, 4))
    assert q.stats()["requests"] == 80


def test_traffic_loop_serves_a_live_queue_across_a_reload(rng):
    """The open-ended load generator on its own thread, a structure
    reload in the middle: every submitted request is counted as served,
    nothing errors or strands."""
    from photon_tpu_torch.serve.driver import traffic_loop

    _, programs = server(rng, rungs=(1, 4, 16))
    counts = dict(served=0, errors=0, submit_errors=0, stranded=0,
                  last_error=None)
    stop = threading.Event()
    with MicroBatchQueue(programs, max_linger_s=0.001) as q:
        loop = threading.Thread(target=traffic_loop,
                                args=(lambda: q, 2000.0, stop, counts),
                                kwargs=dict(batch=16))
        loop.start()
        time.sleep(0.2)
        q.reload_model(glmix_model(np.random.default_rng(9),
                                   entities=E + 3))
        time.sleep(0.2)
        stop.set()
        loop.join(timeout=60)
        assert not loop.is_alive()
        requests_seen = q.stats()["requests"]
    assert counts["served"] == requests_seen > 100
    assert counts["errors"] == counts["submit_errors"] == 0
    assert counts["stranded"] == 0


# -- parity with the JAX package's queue ------------------------------------


def jax_queue_model(arrays, manifest, tmp_path, name):
    from photon_tpu.io import model_io as jax_model_io

    path = model_io.save_checkpoint(
        model_io.game_model_from_numpy(arrays, manifest, "cpu"),
        str(tmp_path / f"{name}.npz"))
    return jax_model_io.load_checkpoint(path)


def jax_server(model, precision, rungs):
    from photon_tpu.serve.programs import ScorePrograms as JaxPrograms
    from photon_tpu.serve.programs import ShapeLadder as JaxLadder
    from photon_tpu.serve.tables import CoefficientTables as JaxTables

    tables = JaxTables.from_game_model(model, precision)
    return JaxPrograms(tables, ladder=JaxLadder(rungs))


def queue_scores(queue, reqs) -> np.ndarray:
    futs = [queue.submit(f, ids) for f, ids in reqs]
    return np.array([f.result(timeout=60) for f in futs], np.float32)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_queue_scores_match_the_reference_across_reloads(
        tmp_path, monkeypatch, precision):
    """Before a reload, after a values-only reload and after a
    structure-change reload, the same requests score the same through
    both packages' live queues."""
    from photon_tpu.serve.queue import MicroBatchQueue as JaxQueue

    monkeypatch.setenv("PHOTON_SERVE_KERNEL", "off")
    rungs = (1, 8, 32)
    base = glmix_arrays(np.random.default_rng(1))
    refreshed = glmix_arrays(np.random.default_rng(2), scale=2.0)
    grown = glmix_arrays(np.random.default_rng(3), entities=E + 5)
    reqs = requests(4, 60)
    ours, theirs = [], []
    jq = JaxQueue(jax_server(jax_queue_model(*base, tmp_path, "b"),
                             precision, rungs), max_linger_s=0.001)
    tables = CoefficientTables.from_game_model(
        model_io.game_model_from_numpy(*base, "cpu"), precision, "cpu")
    q = MicroBatchQueue(ScorePrograms(tables, ladder=ShapeLadder(rungs)),
                        max_linger_s=0.001)
    infos = []
    try:
        for step, arrays in enumerate((None, refreshed, grown)):
            if arrays is not None:
                mine = q.reload_model(
                    model_io.game_model_from_numpy(*arrays, "cpu"))
                ref = jq.reload_model(
                    jax_queue_model(*arrays, tmp_path, f"r{step}"))
                infos.append((mine, ref))
            ours.append(queue_scores(q, reqs))
            theirs.append(queue_scores(jq, reqs))
    finally:
        q.close()
        jq.close()
    for mine, ref in infos:
        assert mine["values_only"] == ref["values_only"]
        assert mine["generation"] == ref["generation"]
    assert [m["values_only"] for m, _ in infos] == [True, False]
    for got, want in zip(ours, theirs):
        np.testing.assert_allclose(got, want, atol=TOL[precision], rtol=0)
    assert not np.allclose(ours[0], ours[1])
    assert q.health()["table_generation"] == 2


def test_health_counters_match_the_reference_under_a_fault_plan(
        tmp_path, monkeypatch):
    """One deterministic plan through both queues, a request at a time:
    two transient ``serve.dispatch`` faults (retried, then served), two
    poison batches (the second trips a breaker of threshold 2), a
    rejected submit, a reset, a served request."""
    from photon_tpu.resilience import CircuitOpenError as JaxCircuitOpen
    from photon_tpu.resilience import FaultPlan as JaxFaultPlan
    from photon_tpu.resilience import faults as jax_faults
    from photon_tpu.serve.queue import MicroBatchQueue as JaxQueue

    monkeypatch.setenv("PHOTON_SERVE_KERNEL", "off")
    arrays = glmix_arrays(np.random.default_rng(1))
    plan = [dict(point="serve.dispatch", nth=1, error="transient"),
            dict(point="serve.dispatch", nth=2, error="transient"),
            dict(point="serve.dispatch", nth=4, error="poison"),
            dict(point="serve.dispatch", nth=5, error="poison")]
    reqs = requests(8, 5)

    def run(queue, injected, plan_cls, open_error):
        outcomes = []
        with injected(plan_cls(plan)):
            for r in reqs[:3]:
                exc = queue.submit(*r).exception(timeout=30)
                outcomes.append(type(exc).__name__ if exc else "served")
            with pytest.raises(open_error):
                queue.submit(*reqs[3])
            queue.reset_breaker()
            outcomes.append(type(queue.submit(*reqs[4]).exception(
                timeout=30)).__name__)
        return outcomes, queue.health()

    tables = CoefficientTables.from_game_model(
        model_io.game_model_from_numpy(*arrays, "cpu"), "float32", "cpu")
    mine_q = MicroBatchQueue(ScorePrograms(tables, ladder=ShapeLadder((1,))),
                             max_linger_s=0.0, breaker_threshold=2,
                             shed_watermark=64, default_deadline_s=30.0)
    theirs_q = JaxQueue(jax_server(jax_queue_model(*arrays, tmp_path, "h"),
                                   "float32", (1,)),
                        max_linger_s=0.0, breaker_threshold=2,
                        shed_watermark=64, default_deadline_s=30.0)
    try:
        mine, mine_health = run(mine_q, faults.injected, FaultPlan,
                                CircuitOpenError)
        theirs, their_health = run(theirs_q, jax_faults.injected,
                                   JaxFaultPlan, JaxCircuitOpen)
    finally:
        mine_q.close()
        theirs_q.close()
    assert mine == theirs == ["served", "PoisonError", "PoisonError",
                              "NoneType"]
    assert set(mine_health) == set(their_health)
    timing = {"staging_overlap_fraction", "window_latency"}
    for key in set(mine_health) - timing:
        assert mine_health[key] == their_health[key], key
    assert mine_health["dispatch_retries"] == 2
    assert mine_health["dispatch_errors"] == 2
    assert mine_health["breaker_trips"] == 1
    assert mine_health["breaker_rejected"] == 1


# -- cli.serve --input ------------------------------------------------------


def single_bag_files(tmp_path):
    """One feature bag, a model on one shard (as test_torch_score's
    single layout), and a values-only refresh of it."""
    from test_torch_score import data_maps, model_arrays, write_data

    data = tmp_path / "data.avro"
    write_data(data, 200, seed=5)
    maps = data_maps(data, ["global=features", "userShard=features",
                            "movieShard=features"])
    dirs = []
    for name, scale in (("model", 1.0), ("refresh", 2.0)):
        arrays, manifest = model_arrays(maps, seed=6, shards="global")
        arrays = {k: v * scale if k.endswith(("means", "coefficients"))
                  else v for k, v in arrays.items()}
        model_io.save_game_model(
            model_io.game_model_from_numpy(arrays, manifest, "cpu"),
            str(tmp_path / name), maps)
        dirs.append(tmp_path / name)
    return data, dirs


def test_serve_cli_input_matches_score_cli_and_the_reference(
        tmp_path, capsys):
    from photon_tpu.cli import serve as jax_serve_cli
    from test_torch_score import read_scores

    data, (model_dir, refresh_dir) = single_bag_files(tmp_path)
    common = ["--model-dir", str(model_dir), "--input", str(data),
              "--id-tags", "userId", "movieId", "--batch-sizes", "1,8,64",
              "--deadline-ms", "30000", "--shed-watermark", "100000",
              "--breaker-threshold", "8"]
    npy = tmp_path / "served.npy"
    assert serve_cli.main(common + ["--device", "cpu", "--scores", str(npy),
                                    "--reload-model", str(refresh_dir)]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # The JAX package keys a reloaded model directory by its own records
    # and rebuilds the ladder with the default dense layout, which the
    # file's ELL requests do not fit (ROADMAP Queue C): its run reloads
    # nothing.
    assert jax_serve_cli.main(common + ["--no-flight"]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert score_cli.main(["--model-dir", str(model_dir), "--input",
                           str(data), "--output", str(tmp_path / "scored"),
                           "--id-tags", "userId", "movieId",
                           "--device", "cpu"]) == 0
    capsys.readouterr()
    _, batch = read_scores(tmp_path / "scored" / "part-00000.avro")
    served = np.load(npy)
    assert served.shape == batch.shape == (200,)
    np.testing.assert_allclose(served, batch, atol=1e-5, rtol=0)
    for out in (ours, theirs):
        assert out["errors"] == 0 and out["requests"] == theirs["requests"]
        assert out["health"]["shed"] == out["health"]["deadline_expired"] \
            == out["health"]["dispatch_errors"] == 0
        assert out["health"]["breaker_threshold"] == 8
    assert len(ours["reloads"]) == 1
    assert ours["reloads"][0]["summary"]["errors"] == 0
    assert ours["reloads"][0]["values_only"] is True
    assert ours["reloads"][0]["programs_compiled"] == 0
    assert ours["health"]["table_generation"] == 1
    assert ours["cold_entity_rate"] == theirs["cold_entity_rate"]
    assert set(ours["dispatches"]) == set(theirs["dispatches"]) == {
        "1", "8", "64"}


def test_serve_cli_input_needs_a_model_directory(tmp_path):
    with pytest.raises(SystemExit):
        serve_cli.main(["--checkpoint", str(tmp_path / "m.npz"),
                        "--input", str(tmp_path / "d.avro")])


# The live-monitoring and health flags of cli.serve, each with a value.
OBSERVABILITY_FLAGS = {
    "monitor_port": "0", "slo_p99_ms": "60000", "slo_error_rate": "0.01",
    "slo_cold_rate": "0.5", "slo_window_s": "2", "health_sketch": None,
}


@pytest.mark.parametrize("flag", OBSERVABILITY_FLAGS)
def test_serve_cli_observability_flags_raise_naming_item_10(
        tmp_path, flag, rng, capsys):
    """The flags raised naming ROADMAP item 10 until it was ported (the
    name is kept): each now runs a served drive on the CPU and shows in
    the summary (tests/test_torch_health_cli.py runs them together)."""
    from photon_tpu_torch.obs import health

    ckpt = model_io.save_checkpoint(glmix_model(rng),
                                    str(tmp_path / "m.npz"))
    value = OBSERVABILITY_FLAGS[flag] or str(tmp_path / "serve.json")
    argv = ["--checkpoint", ckpt, "--synthetic", "40", "--batch-sizes",
            "1,8", "--device", "cpu", "--no-flight",
            "--" + flag.replace("_", "-"), value]
    try:
        assert serve_cli.main(argv) == 0
    finally:
        health.reset()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["errors"] == 0
    assert "slo" in out and "window_latency" in out
    if flag == "monitor_port":
        assert out["monitor"]["port"] > 0
    elif flag == "health_sketch":
        assert out["health_sketch"]["requests_sampled"] > 0
        assert not health.enabled()  # the armed state is restored
    else:
        target = float(value) * (12 if flag == "slo_window_s" else 1)
        key = {"slo_p99_ms": ("p99_ms", "target"),
               "slo_error_rate": ("error_rate", "target"),
               "slo_cold_rate": ("cold_entity_rate", "target"),
               "slo_window_s": ("windows_s", "long")}[flag]
        assert out["slo"][key[0]][key[1]] == pytest.approx(target)


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernel "
                    "have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_cuda_every_rung_is_one_captured_graph(cuda_device, precision):
    """compile_all captures one graph per rung; a dispatch is a replay
    that runs the kernel (counted by replay, never as a Python launch)
    and scores exactly as the eager kernel call."""
    rng = np.random.default_rng(3)
    tables, programs = server(rng, rungs=(1, 8, 64), precision=precision,
                              device=cuda_device)
    assert programs.stats["programs_compiled"] == 3
    assert programs.stats["graph_device_bytes"] > 0
    for n in (1, 5, 64):
        feats, codes, _ = programs.pack_requests(requests(n, n))
        launches, replays = serve_kernel.launches, serve_kernel.replay_launches
        got = programs.score_padded(feats, codes, n)
        assert serve_kernel.launches == launches
        assert serve_kernel.replay_launches == replays + 1
        eager = programs.fetch_padded(programs.dispatch_eager(feats, codes,
                                                              n))
        np.testing.assert_array_equal(got, eager)
        plain = serve_kernel.fused_score_reference(
            **programs.operands(feats, codes))[:n].cpu().numpy()
        np.testing.assert_allclose(got, plain, atol=TOL[precision], rtol=0)
    assert programs.stats["programs_compiled"] == 3


@pytest.mark.cuda
def test_cuda_uncaptured_rung_is_refused(cuda_device):
    _, programs = server(np.random.default_rng(4), rungs=(1, 8),
                         device=cuda_device)
    lazy = ScorePrograms(programs.tables, ladder=programs.ladder,
                         compile_now=False)
    feats, codes, _ = lazy.pack_requests(requests(2, 2))
    with pytest.raises(ValueError, match="no captured graph"):
        lazy.dispatch_padded(feats, codes, 2)


@pytest.mark.cuda
def test_cuda_reloads_keep_or_recapture_the_ladder(cuda_device):
    """A values-only reload is served by the same graphs (copied in
    place, nothing recaptured); a structure change captures one new
    ladder and releases the old one. Scores equal a fresh build's."""
    reqs = requests(6, 40)
    _, programs = server(np.random.default_rng(1), rungs=(1, 8, 64),
                         device=cuda_device)
    with MicroBatchQueue(programs, max_linger_s=0.001) as q:
        queue_scores(q, reqs)
        info = q.reload_model(glmix_model(np.random.default_rng(2),
                                          cuda_device, scale=2.0))
        assert info == {"values_only": True, "generation": 1,
                        "programs_compiled": 0}
        assert q.programs is programs
        assert programs.stats["programs_compiled"] == 3
        got = queue_scores(q, reqs)
        _, fresh = server(np.random.default_rng(2), rungs=(1, 8, 64),
                          device=cuda_device, scale=2.0)
        np.testing.assert_array_equal(got, queue_scores_direct(fresh, reqs))
        info = q.reload_model(glmix_model(np.random.default_rng(3),
                                          cuda_device, entities=E + 4))
        assert info["values_only"] is False
        assert info["programs_compiled"] == 3
        assert info["released_device_bytes"] > 0
        got = queue_scores(q, reqs)
    _, fresh = server(np.random.default_rng(3), rungs=(1, 8, 64),
                      device=cuda_device, entities=E + 4)
    np.testing.assert_array_equal(got, queue_scores_direct(fresh, reqs))


def queue_scores_direct(programs, reqs) -> np.ndarray:
    """Each request alone through a ladder, rung 1."""
    out = []
    for r in reqs:
        feats, codes, _ = programs.pack_requests([r])
        out.append(programs.score_padded(feats, codes, 1)[0])
    return np.asarray(out, np.float32)


@pytest.mark.cuda
def test_cuda_pipelined_matches_serial_byte_identical(cuda_device):
    reqs = requests(7, 300)
    outs = {}
    for pipelined in (False, True):
        _, programs = server(np.random.default_rng(1), rungs=(1, 8, 64),
                             device=cuda_device)
        with MicroBatchQueue(programs, max_linger_s=0.001,
                             pipeline_staging=pipelined) as q:
            outs[pipelined] = queue_scores(q, reqs)
    assert np.array_equal(outs[False], outs[True])


@pytest.mark.cuda
def test_cuda_off_switch_captures_the_plain_version(cuda_device,
                                                    monkeypatch):
    reqs = requests(9, 8)
    _, kernel = server(np.random.default_rng(1), rungs=(8,),
                       device=cuda_device)
    monkeypatch.setenv("PHOTON_SERVE_KERNEL", "off")
    _, plain = server(np.random.default_rng(1), rungs=(8,),
                      device=cuda_device)
    assert plain.stats["serve_kernel"] == "plain"
    assert plain.stats["programs_compiled"] == 1
    feats, codes, _ = plain.pack_requests(reqs)
    replays = serve_kernel.replay_launches
    got = plain.score_padded(feats, codes, 8)
    assert serve_kernel.replay_launches == replays
    np.testing.assert_allclose(got, kernel.score_padded(feats, codes, 8),
                               atol=TOL["float32"], rtol=0)
