"""The fixed effect's sparse transpose (``SparseFeatures.rmatvec`` and
``rmatvec_sq``) on the sorted segment sum.

On the CPU the port's transpose runs ``sorted_segment_sum_plain`` over
the slots sorted once by (row block, feature id) and adds the blocks'
sums; it is held against

- the reference's ``.at[].add`` (``photon_tpu.data.dataset``) in float32,
  within the rounding of two sums taken in different orders: per
  feature, 2 (L - 1) u sum |v| over its L slots (u = 2**-24);
- the port's former ``index_add_`` over the unsorted slots in float64,
  within 1e-12 (the same sums, grouped by row block).

The tests marked ``cuda`` need a GPU and no JAX (run them with
``--noconftest -m cuda``): two transposes on the card are equal bit for
bit, launch the segment-sum kernel at the ``fixed_effect`` site, and
match the plain version within the same rounding bound; float64, which
the kernel does not take, raises.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_tpu_torch.data.dataset import SparseFeatures, transpose_block_rows
from photon_tpu_torch.ops import segment_reduce as sr

U32 = 2.0 ** -24


def ell(seed: int, n: int = 3000, k: int = 7, d: int = 50):
    """An ELL matrix whose rows hold k - 1 ids drawn from d - 1 (with
    repeats, which the transpose sums) and last the intercept id d - 1,
    as the readers lay it out; values N(0, 1), and a row vector g."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d - 1, size=(n, k - 1))
    idx = np.concatenate([idx, np.full((n, 1), d - 1)], axis=1)
    val = rng.normal(size=(n, k))
    val[:, -1] = 1.0
    return idx.astype(np.int32), val, rng.normal(size=n), d


def order_bound(idx, contrib, d) -> np.ndarray:
    """2 (L - 1) u sum |v| per feature: how far two f32 sums of the same
    L values in different orders can be apart."""
    flat = idx.ravel()
    count = np.bincount(flat, minlength=d)
    mag = np.bincount(flat, np.abs(contrib).ravel(), minlength=d)
    return 2.0 * np.maximum(count - 1, 0) * U32 * mag + 1e-30


def features(idx, val, d, dtype, device="cpu"):
    return SparseFeatures(torch.from_numpy(idx).to(device),
                          torch.from_numpy(val).to(device, dtype), d)


@pytest.mark.parametrize("seed", [0, 1])
def test_rmatvec_matches_the_reference_in_float32(seed):
    import jax.numpy as jnp

    from photon_tpu.data.dataset import SparseFeatures as JaxSparse

    idx, val, g, d = ell(seed)
    val32, g32 = val.astype(np.float32), g.astype(np.float32)
    ours = features(idx, val32, d, torch.float32)
    ref = JaxSparse(jnp.asarray(idx), jnp.asarray(val32), d)
    for name, contrib in (("rmatvec", val32 * g32[:, None]),
                          ("rmatvec_sq", val32 * val32 * g32[:, None])):
        got = getattr(ours, name)(torch.from_numpy(g32)).numpy()
        want = np.asarray(getattr(ref, name)(jnp.asarray(g32)))
        assert got.dtype == np.float32
        assert np.all(np.abs(got.astype(np.float64) - want)
                      <= order_bound(idx, contrib, d)), name


@pytest.mark.parametrize("seed", [0, 1])
def test_rmatvec_matches_the_index_add_in_float64(seed):
    idx, val, g, d = ell(seed)
    ours = features(idx, val, d, torch.float64)
    gt = torch.from_numpy(g)
    flat = torch.from_numpy(idx).reshape(-1).long()
    for got, contrib in ((ours.rmatvec(gt), val * g[:, None]),
                         (ours.rmatvec_sq(gt), val * val * g[:, None])):
        want = torch.zeros(d, dtype=torch.float64).index_add_(
            0, flat, torch.from_numpy(contrib).reshape(-1))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_transpose_plan_is_built_once_and_sorted():
    idx, val, g, d = ell(2, n=500)
    f = features(idx, val, d, torch.float64)
    plan = f.transpose_plan()
    f.rmatvec(torch.from_numpy(g))
    f.rmatvec_sq(torch.from_numpy(g))
    assert f.transpose_plan() is plan
    ids = plan.ids.numpy()
    assert plan.ids.dtype == torch.int32 and plan.rows.dtype == torch.int32
    assert np.all(np.diff(ids) >= 0)
    # Keys are block * d + id over blocks of equal rows.
    block_rows = transpose_block_rows(500, idx.shape[1], d)
    assert plan.parts == -(-500 // block_rows) > 1
    rows = plan.rows.numpy()
    keys = (np.arange(idx.size) // idx.shape[1] // block_rows) * d \
        + idx.ravel()
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(ids, keys[order])
    np.testing.assert_array_equal(rows, order // idx.shape[1])
    # Stable: each feature's slots in row order, values carried along.
    same = np.diff(ids) == 0
    assert np.all(np.diff(rows)[same] >= 0)
    np.testing.assert_array_equal(plan.values.numpy(), val.ravel()[order])


@pytest.mark.parametrize("shape,parts", [((1, 1, 1), 1), ((7, 3, 2), 2),
                                         ((262_144, 9, 64), 8192),
                                         ((40_000, 12, 300_000), 1),
                                         ((3000, 7, 50), 104)])
def test_transpose_blocks_cover_every_row(shape, parts):
    """Blocks of equal rows, ``parts`` of them, their keys below
    ``parts * d`` (int32), and one block where d fills the target."""
    n, k, d = shape
    block_rows = transpose_block_rows(n, k, d)
    assert -(-n // block_rows) == parts
    assert (n - 1) // block_rows == parts - 1
    assert parts * d < 2**31


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3000, 7, 50), (262_144, 9, 64),
                                   (40_000, 12, 300_000)])
def test_cuda_rmatvec_is_bit_identical_and_matches_plain(cuda_device,
                                                         shape):
    n, k, d = shape
    idx, val, g, d = ell(5, n=n, k=k, d=d)
    val32, g32 = val.astype(np.float32), g.astype(np.float32)
    f = features(idx, val32, d, torch.float32, cuda_device)
    gt = torch.from_numpy(g32).to(cuda_device)
    plan = f.transpose_plan()
    plain_vals = {"rmatvec": plan.values * gt[plan.rows.long()],
                  "rmatvec_sq": plan.values * plan.values
                  * gt[plan.rows.long()]}
    for name, contrib in (("rmatvec", val32 * g32[:, None]),
                          ("rmatvec_sq", val32 * val32 * g32[:, None])):
        before = sr.launches_by_site.get("fixed_effect", 0)
        a = getattr(f, name)(gt)
        b = getattr(f, name)(gt)
        torch.cuda.synchronize()
        assert sr.launches_by_site.get("fixed_effect", 0) == before + 2
        assert torch.equal(a, b)
        plain = sr.sorted_segment_sum_plain(
            plain_vals[name], plan.ids, plan.parts * d).view(
                plan.parts, d).sum(0)
        diff = (a - plain).abs().double().cpu().numpy()
        assert np.all(diff <= order_bound(idx, contrib, d)), name


@pytest.mark.cuda
def test_cuda_float64_transpose_raises(cuda_device):
    idx, val, g, d = ell(6, n=200)
    f = features(idx, val, d, torch.float64, cuda_device)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        f.rmatvec(torch.from_numpy(g).to(cuda_device))
