"""The port's fused whole fit on the card (``cuda`` cases, no JAX):
run with ``python -m pytest --noconftest tests/test_torch_fused_fit_cuda.py
-m cuda``. ``tiny_glmix`` is the reference's
``analysis.program._tiny_glmix`` on the port, shared with
``test_torch_fused_fit.py``.

- a WHILE loop captured into a CUDA graph equals the eager loop;
- a fused fit replayed with new lambdas equals the unfused fits, within
  the f32 bounds of the card's kernel route (fixed effect rtol 1e-3,
  random effects 2e-3);
- the returned models are clones, never the graph's output buffers;
- the device launch counters read, for a replay, the Newton launches
  its diagnostics imply (one a WHILE iteration);
- a random effect with box constraints (the batched L-BFGS-B route)
  replays equal to the unfused fit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_tpu_torch import optim
from photon_tpu_torch.algorithm import fused_fit as pt_ff
from photon_tpu_torch.algorithm.problems import GLMOptimizationConfiguration
from photon_tpu_torch.data import dataset as pt_dataset
from photon_tpu_torch.data import game_data as pt_game_data
from photon_tpu_torch.data import random_effect as pt_re
from photon_tpu_torch.estimators import game_estimator as pt_est
from photon_tpu_torch.events import EventEmitter
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.utils import device_loop


def reg_pt(weight, kind="L2"):
    return GLMOptimizationConfiguration(
        regularization=optim.RegularizationContext(
            getattr(optim.RegularizationType, kind)),
        regularization_weight=weight)


def tiny_glmix(num_iterations=2, n=96, e=7, device="cpu"):
    """The reference's ``analysis.program._tiny_glmix`` on the port, f32
    on ``device``."""
    d, du = 5, 4
    rng = np.random.default_rng(20260803)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, -1] = 1.0
    xu = rng.normal(size=(n, du)).astype(np.float32)
    xu[:, -1] = 1.0
    users = rng.integers(0, e, size=n)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    data = pt_game_data.make_game_dataset(
        y, {"global": pt_dataset.DenseFeatures(x),
            "userShard": pt_dataset.DenseFeatures(xu)},
        id_tags={"userId": users}, device=device)
    est = pt_est.GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"global": pt_est.FixedEffectCoordinateConfiguration(
            "global", reg_pt(0.01)),
         "per-user": pt_est.RandomEffectCoordinateConfiguration(
             pt_re.RandomEffectDataConfiguration("userId", "userShard"),
             reg_pt(0.5))},
        intercept_indices={"global": d - 1, "userShard": du - 1},
        num_iterations=num_iterations, device=device)
    return est, data


def cuda_tiny(num_iterations=2):
    return tiny_glmix(num_iterations, device="cuda")


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_captured_while_loop_equals_the_eager_loop():
    x0 = torch.arange(64, device="cuda", dtype=torch.float32)

    def run():
        s = type("S", (), {})()
        s.x = x0.clone()
        s.n = torch.zeros(64, dtype=torch.int64, device="cuda")

        def body(active):
            s.x = torch.where(active, s.x * 1.5 + 1.0, s.x)
            s.n = s.n + active.long()

        device_loop.while_loop(lambda: s.x < 1000.0, body, (s,),
                               any_running=lambda m: bool(m.any()))
        return s

    eager = run()
    graph = device_loop.new_graph()
    with device_loop.capture(graph, "cuda") as cap:
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    assert cap.conditional_nodes == 1
    assert torch.equal(captured.x, eager.x)
    assert torch.equal(captured.n, eager.n)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_replayed_fused_fit_with_new_lambdas_equals_unfused_fits():
    est, data = cuda_tiny()
    seq = [{"global": reg_pt(w)} for w in (0.1, 0.01)]
    fused = est.fit(data, opt_config_sequence=seq)
    assert est._fused_cache is not None
    (ff,) = est._fused_cache.values()
    assert len(ff._graphs) == 2  # cold and warm twins
    unf, _ = cuda_tiny()
    unf.emitter = EventEmitter([lambda e: None])
    plain = unf.fit(data, opt_config_sequence=seq)
    for f, u in zip(fused, plain):
        for cid, a in coef_maps_cpu(f.model).items():
            np.testing.assert_allclose(a, coef_maps_cpu(u.model)[cid],
                                       rtol=1e-3, atol=2e-3)


def coef_maps_cpu(model):
    return {cid: (m.coefficients if hasattr(m, "coefficients")
                  else m.model.coefficients.means).cpu().numpy()
            for cid, m in model.items()}


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_returned_models_do_not_alias_graph_buffers():
    est, data = cuda_tiny()
    first = est.fit(data)[0].model
    keep = {cid: t.clone() for cid, t in (
        (cid, m.coefficients if hasattr(m, "coefficients")
         else m.model.coefficients.means) for cid, m in first.items())}
    est.fit(data, opt_config_sequence=[{"global": reg_pt(5.0)}])
    (ff,) = est._fused_cache.values()
    outs = [t.data_ptr() for cap in ff._graphs.values()
            for t in pt_ff._leaves(cap.out)]
    for cid, m in first.items():
        t = m.coefficients if hasattr(m, "coefficients") \
            else m.model.coefficients.means
        assert t.data_ptr() not in outs
        assert torch.equal(t, keep[cid])


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_graph_launch_counters_count_every_replayed_iteration():
    """A fused fit's replay runs the Newton kernel once a WHILE
    iteration: the device counters read what its diagnostics say."""
    device_loop.count_graph_launches("cuda")
    est, data = cuda_tiny()
    est.fit(data)  # the capture
    device_loop.reset_graph_launches()
    res = est.fit(data)[0]
    launches = device_loop.graph_launches("newton_step")
    datasets, _ = est.prepare(data)
    want = 0
    for rec in res.descent.history:
        if rec.coordinate_id != "per-user":
            continue
        its = rec.diagnostics.iterations
        for eb in datasets["per-user"].device_blocks():
            want += int(its[eb.entity_codes.cpu().numpy()].max())
    assert launches == want > 0


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_random_effect_box_constraints_replay_inside_the_graph():
    """A random effect with box constraints (the batched L-BFGS-B route,
    its loops WHILE nodes, its bounds made by the eager pass before the
    capture) replays equal to the unfused fit, within the f32 bounds."""
    import dataclasses

    def boxed():
        est, data = cuda_tiny()
        cfg = est.coordinate_configs["per-user"]
        est.coordinate_configs["per-user"] = dataclasses.replace(
            cfg, optimization=dataclasses.replace(
                cfg.optimization, optimizer=dataclasses.replace(
                    cfg.optimization.optimizer, box_constraints=(-0.2, 0.2))))
        return est, data

    est, data = boxed()
    est.fit(data)
    fused = est.fit(data)[0]
    assert est._fused_cache is not None
    unf, _ = boxed()
    unf.emitter = EventEmitter([lambda e: None])
    plain = unf.fit(data)[0]
    for cid, a in coef_maps_cpu(fused.model).items():
        np.testing.assert_allclose(a, coef_maps_cpu(plain.model)[cid],
                                   rtol=1e-3, atol=2e-3)
    w = coef_maps_cpu(fused.model)["per-user"]
    assert w.min() >= -0.2 and w.max() <= 0.2
