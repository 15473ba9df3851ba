"""The port's mesh in one process: ``parallel/mesh.py`` against the
reference's ``photon_tpu/parallel/mesh.py`` on the same inputs.

- ``resolve_mesh``: the reference's cases and messages (its world is the
  conftest's 8 CPU devices, the port's a single process); a count above
  the group's size raises with the reference's words;
- ``pad_batch``: the same padded arrays, and the same ``DualEllFeatures``
  refusal, word for word;
- ``shard_batch`` and ``shard_random_effect_dataset`` on every rank of a
  3-rank mesh (sharding issues no collective, so the ranks are
  ``Mesh(rank=k, size=3)`` here): the ranks' shares, in rank order, are
  the reference's arrays sharded over 3 of its devices, element for
  element, fills and host mirrors included;
- ``match_partition_rules``: the reference's specs, as strings;
- a real mesh (one rank) keeps a fit unfused with the
  reference's reason, and its fit and scores match the fit without a
  mesh to 1e-12 (its scores come from the raw features, not the slabs:
  sums in another order);
- the DualEll fixed effect stays whole on a mesh, and the column route
  (``feature_sharding`` ``column``, or ``auto`` past the threshold)
  gives a rank its feature range of the features, the rows whole.
The mesh on real ranks is ``tests/test_torch_mesh_ranks.py``'s.
"""

from __future__ import annotations

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.data import dataset as jax_dataset
from photon_tpu.data import game_data as jax_game_data
from photon_tpu.data import random_effect as jax_re
from photon_tpu.parallel import mesh as jax_mesh
from photon_tpu_torch.algorithm import fused_fit as pt_ff
from photon_tpu_torch.data import dataset as pt_dataset
from photon_tpu_torch.data import game_data as pt_game_data
from photon_tpu_torch.data import random_effect as pt_re
from photon_tpu_torch.obs import fleet
from photon_tpu_torch.parallel import mesh as pt_mesh
from photon_tpu_torch.parallel.mesh import Mesh
from photon_tpu_torch.transformers import GameTransformer

CPU = torch.device("cpu")


def fake_ranks(size: int) -> list:
    """Every rank's ``Mesh`` of a ``size``-rank group, for the sharding
    steps, which issue no collective."""
    return [Mesh(rank=k, size=size, device=CPU) for k in range(size)]


# ---------------------------------------------------------------------------
# resolve_mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("setting", ["off", "none", "1", "OFF", None, False,
                                     1, True, "auto"])
def test_resolve_mesh_single_process_settings(setting):
    """Every setting that means one device is None in one process, as
    the reference's are on one device ("auto" and True too)."""
    assert pt_mesh.resolve_mesh(setting, device="cpu") is None
    if setting not in ("auto", True):
        assert jax_mesh.resolve_mesh(setting) is None


@pytest.mark.parametrize("setting,exc", [
    ("fof", ValueError), ("0", ValueError), (0, ValueError),
    (-2, ValueError), (2.5, TypeError)])
def test_resolve_mesh_refusals_match_reference(setting, exc):
    with pytest.raises(exc) as jerr:
        jax_mesh.resolve_mesh(setting)
    with pytest.raises(exc) as perr:
        pt_mesh.resolve_mesh(setting, device="cpu")
    assert str(perr.value) == str(jerr.value)


def test_resolve_mesh_above_the_world_and_passthrough():
    """A count above the group raises with the reference's words (here
    the group is this one process); a ``Mesh`` passes through."""
    world = len(jax.devices())
    with pytest.raises(ValueError) as jerr:
        jax_mesh.resolve_mesh(world + 1)
    with pytest.raises(ValueError) as perr:
        pt_mesh.resolve_mesh("2", device="cpu")
    assert str(jerr.value) == (f"mesh setting requests {world + 1} devices "
                               f"but only {world} are visible")
    assert str(perr.value) == ("mesh setting requests 2 devices but only "
                               "1 are visible")
    mesh = Mesh(rank=0, size=1, device=CPU)
    assert pt_mesh.resolve_mesh(mesh) is mesh and mesh.axis_name == "data"
    with pytest.raises(RuntimeError, match="no torch.distributed process"):
        pt_mesh.make_mesh(device="cpu")


def test_init_from_env_single_process_and_missing_rendezvous(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pt_mesh.init_from_env("cpu") is None
    monkeypatch.setenv("WORLD_SIZE", "2")
    for k in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError,
                       match="RANK, MASTER_ADDR, MASTER_PORT not set"):
        pt_mesh.init_from_env("cpu")


def test_global_card_count_counts_shared_cards_once(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert fleet._global_cards(1, 1) == 1
    assert fleet._global_cards(8, 1) == 8
    assert fleet._global_cards(1, 2) == 1  # two ranks on one card
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert fleet._global_cards(4, 8) == 8  # two hosts of four cards


# ---------------------------------------------------------------------------
# pad_batch and shard_batch
# ---------------------------------------------------------------------------


def batches(n=11, d=4, k=3, seed=3):
    """A dense and an ELL batch of each package on the same rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k))
    y, off, w = rng.normal(size=n), rng.normal(size=n), rng.uniform(size=n)
    out = {}
    for name, jf, pf in (
            ("dense", jax_dataset.DenseFeatures(jnp.asarray(x)),
             pt_dataset.DenseFeatures(torch.tensor(x))),
            ("sparse", jax_dataset.SparseFeatures(jnp.asarray(idx),
                                                  jnp.asarray(val), d),
             pt_dataset.SparseFeatures(torch.tensor(idx), torch.tensor(val),
                                       d))):
        out[name] = (
            jax_dataset.GLMBatch(jf, jnp.asarray(y), jnp.asarray(off),
                                 jnp.asarray(w)),
            pt_dataset.GLMBatch(pf, torch.tensor(y), torch.tensor(off),
                                torch.tensor(w)))
    return out


def leaves(batch) -> list:
    f = batch.features
    feats = [f.x] if hasattr(f, "x") else [f.indices, f.values]
    return [np.asarray(a) for a in
            (*feats, batch.labels, batch.offsets, batch.weights)]


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("multiple", [1, 3, 4, 11])
def test_pad_batch_matches_reference(kind, multiple):
    jb, pb = batches()[kind]
    for a, b in zip(leaves(jax_dataset.pad_batch(jb, multiple)),
                    leaves(pt_mesh.pad_batch(pb, multiple)), strict=True):
        np.testing.assert_array_equal(b, a)


def test_pad_batch_refuses_dual_ell_with_reference_words():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 9, size=(7, 5)).astype(np.int32)
    val = rng.normal(size=(7, 5))
    jf = jax_dataset.ell_to_dual_ell(idx, val, 9, 2)
    pf = pt_dataset.ell_to_dual_ell(idx, val, 9, 2, dtype=torch.float64,
                                    device="cpu")
    y = np.zeros(7)
    jb = jax_dataset.GLMBatch(jf, jnp.asarray(y), jnp.asarray(y),
                              jnp.asarray(y))
    pb = pt_dataset.GLMBatch(pf, torch.tensor(y), torch.tensor(y),
                             torch.tensor(y))
    with pytest.raises(TypeError) as jerr:
        jax_dataset.pad_batch(jb, 2)
    with pytest.raises(TypeError) as perr:
        pt_mesh.pad_batch(pb, 2)
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(TypeError) as serr:
        pt_mesh.shard_batch(pb, fake_ranks(2)[1])
    assert str(serr.value) == str(jerr.value)
    # A multiple already met pads nothing, as the reference's does.
    assert pt_mesh.pad_batch(pb, 7) is pb


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("size", [2, 3, 4])
def test_shard_batch_shares_are_the_padded_batch(kind, size):
    jb, pb = batches()[kind]
    shares = [pt_mesh.shard_batch(pb, m) for m in fake_ranks(size)]
    for k, s in enumerate(shares):
        assert s.mesh.rank == k and s.logical_rows == 11
        assert s.num_samples == -(-11 // size)
    whole = [np.concatenate(parts) for parts in
             zip(*(leaves(s) for s in shares))]
    for a, b in zip(leaves(jax_dataset.pad_batch(jb, size)), whole,
                    strict=True):
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# shard_random_effect_dataset
# ---------------------------------------------------------------------------


def re_datasets(lazy: bool, seed=6, n=300, d=4, e=23):
    """One random-effect dataset of each package on the same rows:
    skewed entity sizes over several buckets, lazy or materialized."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0
    users = np.minimum(rng.zipf(1.5, size=n) - 1, e - 1)
    y = rng.normal(size=n)
    cfg = dict(random_effect_type="userId", feature_shard_id="u",
               bucket_caps=(4, 16, 64))
    jdata = jax_game_data.make_game_dataset(
        y, {"u": jax_dataset.DenseFeatures(x)}, id_tags={"userId": users},
        dtype=jnp.float64)
    pdata = pt_game_data.make_game_dataset(
        y, {"u": pt_dataset.DenseFeatures(x)}, id_tags={"userId": users},
        dtype=torch.float64, device="cpu")
    jds = jax_re.build_random_effect_dataset(
        jdata, jax_re.RandomEffectDataConfiguration(**cfg),
        intercept_index=d - 1, lazy=lazy)
    pds = pt_re.build_random_effect_dataset(
        pdata, pt_re.RandomEffectDataConfiguration(**cfg),
        intercept_index=d - 1, lazy=lazy)
    return jds, pds


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "materialized"])
def test_shard_random_effect_dataset_matches_reference(lazy):
    """Over 3 ranks: each bucket's entity axis padded with the
    reference's inert fills, each rank its contiguous share; the shares
    in rank order equal the reference's arrays sharded over 3 of its
    devices, and the host mirrors cover every rank, padded."""
    jds, pds = re_datasets(lazy)
    jsh = jax_mesh.shard_random_effect_dataset(
        jds, jax_mesh.make_mesh(jax.devices()[:3]))
    shards = [pt_mesh.shard_random_effect_dataset(pds, m)
              for m in fake_ranks(3)]
    assert len(pds.blocks) > 1
    names = (pt_re._PLAN_FIELDS if lazy else
             [f.name for f in dataclasses.fields(pt_re.EntityBlocks)])
    for i, jb in enumerate(jsh.device_plans()):
        b = jb.num_entities
        assert b % 3 == 0
        for s in shards:
            assert s.blocks[i].num_entities == b // 3
            np.testing.assert_array_equal(s.block_codes_np[i],
                                          np.asarray(jsh.block_codes_np[i]))
            np.testing.assert_array_equal(
                s.block_intercepts_np[i],
                np.asarray(jsh.block_intercepts_np[i]))
            assert s.real_entity_mask(i).sum() == pds.blocks[i].num_entities
        for name in names:
            want = getattr(jb, name)
            if want is None:
                assert all(getattr(s.blocks[i], name) is None
                           for s in shards)
                continue
            got = torch.cat([getattr(s.blocks[i], name) for s in shards])
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{i}/{name}")
    # The raw leaves stay whole on every rank.
    for s in shards:
        if lazy:
            assert s.blocks[0].raw is pds.raw
        assert s.mesh.size == 3 and s.device_plans() is s.blocks


def test_match_partition_rules_matches_reference():
    names = ["fe/features", "fe/labels", "fe/weights", "fe/uids",
             "re/block0/entity_codes", "re/block12/row_ids",
             "re/block3/proj", "re/block1/intercept_slots", "re/raw",
             "re/raw/x", "re/score_codes", "re/score_values", "coef/means",
             "coef", "fe/scalar"]
    leaves = {n: np.zeros((4,) if n != "fe/scalar" else ()) for n in names}
    jspecs, jmatch = jax_mesh.match_partition_rules(
        jax_mesh.PARTITION_RULES, leaves)
    pspecs, pmatch = pt_mesh.match_partition_rules(
        pt_mesh.PARTITION_RULES, leaves)
    assert {k: str(v) for k, v in pspecs.items()} == {
        k: str(v) for k, v in jspecs.items()}
    assert pmatch == jmatch
    assert [str(r[1]) for r in pt_mesh.PARTITION_RULES] == [
        str(r[1]) for r in jax_mesh.PARTITION_RULES]
    assert [r[0] for r in pt_mesh.PARTITION_RULES] == [
        r[0] for r in jax_mesh.PARTITION_RULES]
    bad = {"re/unknown": np.zeros(3)}
    with pytest.raises(ValueError) as jerr:
        jax_mesh.match_partition_rules(jax_mesh.PARTITION_RULES, bad)
    with pytest.raises(ValueError) as perr:
        pt_mesh.match_partition_rules(pt_mesh.PARTITION_RULES, bad)
    assert str(perr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the estimator and the transformer on a mesh
# ---------------------------------------------------------------------------


def _linear_estimators(unfused=False):
    """``test_torch_fused_fit``'s linear GLMix: both packages'
    estimators (``unfused`` attaches a listener) and datasets."""
    from test_torch_fused_fit import (
        both_datasets,
        both_estimators,
        game_arrays,
    )

    jdata, pdata = both_datasets(game_arrays(7))
    jest, pest = both_estimators(unfused=unfused)
    return jest, pest, jdata, pdata


def test_mesh_keeps_a_fit_unfused_with_the_reference_reason():
    """A real mesh (one rank) makes the fit ineligible with the
    reference's words, runs no warm capture and the unfused loop, and
    fits and scores as the fit without a mesh does."""
    from photon_tpu.algorithm import fused_fit as jax_ff

    jest, pest, jdata, pdata = _linear_estimators()
    mesh = Mesh(rank=0, size=1, device=CPU)
    pest.mesh = mesh
    datasets, _ = pest.prepare(pdata)
    assert pest._aot_future is None
    fe = datasets["global"]
    assert fe.mesh is mesh and fe.logical_rows == pdata.num_samples
    pc = pest._build_coordinates(datasets, {}, {})
    jc = jest._build_coordinates(jest.prepare(jdata)[0], {}, {})
    reasons = pt_ff.fuse_ineligibility_reasons(pc, mesh=mesh)
    assert reasons == jax_ff.fuse_ineligibility_reasons(jc, mesh=mesh)
    assert reasons[0].startswith("mesh execution: fusing would fold")
    res = pest.fit(pdata)[0]
    assert pest._fused_cache is None
    _, plain, _, pdata2 = _linear_estimators(unfused=True)
    want = plain.fit(pdata2)[0]
    for cid in ("global", "per-user"):
        a, b = res.model[cid], want.model[cid]
        a = a.model.coefficients.means if cid == "global" else a.coefficients
        b = b.model.coefficients.means if cid == "global" else b.coefficients
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=cid)
    np.testing.assert_allclose(
        GameTransformer(res.model, mesh=mesh).score(pdata).numpy(),
        GameTransformer(res.model).score(pdata).numpy(), rtol=1e-12,
        atol=1e-12)


def test_dual_ell_fixed_effect_stays_whole_and_column_route_raises(
        caplog, monkeypatch):
    from photon_tpu_torch.estimators import game_estimator as pt_est

    _, pest, _, pdata = _linear_estimators()
    mesh = fake_ranks(2)[1]
    cfg = pest.coordinate_configs["global"]
    host = pdata.host_shard_coo(cfg.feature_shard_id)
    dual = pt_dataset.ell_to_dual_ell(host[0], host[1], host[2], 2,
                                      dtype=torch.float64, device="cpu")
    dual_data = dataclasses.replace(pdata, feature_shards={
        **pdata.feature_shards, cfg.feature_shard_id: dual})
    with caplog.at_level(logging.INFO):
        batch = pest._fixed_effect_batch(dual_data, "global", cfg, mesh)
    assert batch.mesh is None and batch.features is dual
    assert "DualEll features are not row-shardable" in caplog.text
    dense = pest._fixed_effect_batch(pdata, "global", cfg, mesh)
    assert dense.mesh is mesh and dense.num_samples == -(
        -pdata.num_samples // 2)
    column = dataclasses.replace(cfg, feature_sharding="column")
    d = pdata.feature_shards[cfg.feature_shard_id].num_features
    d_local = -(-d // 2)
    col = pest._fixed_effect_batch(pdata, "global", column, mesh)
    # Rank 1 of 2 holds the second half of the features, the rows whole.
    assert isinstance(col.features, pt_mesh.FeatureShardedSparse)
    assert col.mesh is None and col.num_samples == pdata.num_samples
    assert (col.features.d, col.features.logical_d) == (2 * d_local, d)
    assert col.features.lo == d_local and col.num_features == d_local
    auto = dataclasses.replace(cfg, feature_sharding="auto")
    assert pest._fixed_effect_batch(pdata, "global", auto, mesh).mesh is mesh
    monkeypatch.setattr(pt_est, "AUTO_COLUMN_SHARDING_THRESHOLD", 2)
    assert isinstance(
        pest._fixed_effect_batch(pdata, "global", auto, mesh).features,
        pt_mesh.FeatureShardedSparse)
    # Without a mesh every mode is the replicated batch.
    assert pest._fixed_effect_batch(pdata, "global", column, None).mesh is None
    with pytest.raises(ValueError, match="feature_sharding"):
        pt_est.FixedEffectCoordinateConfiguration("x", feature_sharding="r")
