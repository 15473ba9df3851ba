"""The port's segment-sum reduces against the JAX package's.

The same numpy inputs, made from a seed, go through both packages. The
JAX side runs its Pallas ``_windowed_sum`` body in interpret mode
(``PHOTON_SEGMENT_KERNEL=force``, set by each test); on the CPU the
port's wrappers run ``sorted_segment_sum_plain``, the CUDA kernel's
plain PyTorch version. Reduces stay under 20,000 elements: the
interpreter is slow.

Tolerances:
- integer-valued fixtures are compared exactly: every partial sum is an
  integer below 2**24, so f32 sums in any order are exact, and a dropped
  or double-counted element shows;
- real values: rtol 1e-6 / atol 1e-6, f32 sums taken in another order.

The tests marked ``cuda`` hold the CUDA kernel against its plain version
and need a GPU; they skip on a machine without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_tpu_torch.ops import segment_reduce as sr


@pytest.fixture
def jax_sr(monkeypatch):
    """The reference module with its Pallas kernel forced (interpreted
    on the CPU)."""
    import jax

    from photon_tpu.ops import segment_reduce

    monkeypatch.setenv("PHOTON_SEGMENT_KERNEL", "force")
    jax.clear_caches()
    yield segment_reduce
    jax.clear_caches()


def _jnp(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _int_values(rng, size, lo=-3, hi=4):
    return rng.integers(lo, hi, size=size).astype(np.float32)


# ---------------------------------------------------------------------------
# sorted_segment_sum
# ---------------------------------------------------------------------------


def _segment_fixture(kind: str, rng):
    """(values, ids, n, multiplicity) of one named case."""
    if kind == "duplicates":
        n = 2_531
        ids = np.repeat(np.arange(n), rng.integers(0, 4, n)).astype(np.int32)
        return _int_values(rng, ids.size), ids, n, 3
    if kind == "empty_segments":
        n = 4_099
        ids = np.asarray([5, 5, 2_049, 4_098], np.int32)
        return np.asarray([1.5, 2.5, -1.0, 4.0], np.float32), ids, n, 2
    if kind == "dropped_ids":
        n = 1_283
        ids = np.asarray([0, 1, 7, n, n, n + 5], np.int32)
        return np.asarray([1, 2, 3, 100, 100, 100], np.float32), ids, n, 3
    if kind == "long_run":
        n = 37
        ids = np.concatenate([[0, 3], np.full(5_000, 11), [36]]).astype(
            np.int32)
        return _int_values(rng, ids.size), ids, n, 5_000 // 1_024 + 1
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["duplicates", "empty_segments",
                                  "dropped_ids", "long_run"])
def test_sorted_segment_sum_matches_reference_exactly(kind, jax_sr):
    vals, ids, n, mult = _segment_fixture(kind, np.random.default_rng(0))
    want = np.asarray(jax_sr.sorted_segment_sum(
        _jnp(vals), _jnp(ids), n, multiplicity=mult))
    sr.reset_counts()
    got = sr.sorted_segment_sum(_t(vals), _t(ids), n, multiplicity=mult)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert sr.launches == 0  # CPU tensors launch nothing


def test_bf16_values_accumulate_in_f32(jax_sr):
    # 1024 + 1 == 1024 in bf16: a bf16 accumulator would stop counting.
    m = 4_096
    ids = np.zeros(m, np.int32)
    import jax.numpy as jnp

    want = np.asarray(jax_sr.sorted_segment_sum(
        jnp.ones(m, jnp.bfloat16), _jnp(ids), 7, multiplicity=m // 1_024))
    got = sr.sorted_segment_sum(torch.ones(m, dtype=torch.bfloat16),
                                _t(ids), 7, multiplicity=m // 1_024)
    assert got.dtype == torch.float32 and got[0] == float(m)
    np.testing.assert_array_equal(got.numpy(), want)


def test_real_values_match_reference(jax_sr):
    rng = np.random.default_rng(3)
    n = 1_537
    ids = np.sort(rng.integers(0, n + 40, 6_000)).astype(np.int32)
    vals = rng.normal(size=ids.size).astype(np.float32)
    want = np.asarray(jax_sr.sorted_segment_sum(
        _jnp(vals), _jnp(ids), n, multiplicity=4))
    got = sr.sorted_segment_sum(_t(vals), _t(ids), n, multiplicity=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_sorted_segment_sum_has_no_coverage_gate(jax_sr):
    # A multiplicity past _MAX_K_TILES: the reference takes XLA's
    # segment_sum; the run reduction needs no window and sums it all the
    # same, on the card through the kernel.
    m, n = 300, 1_021
    ids = np.zeros(m, np.int32)
    want = np.asarray(jax_sr.sorted_segment_sum(
        _jnp(np.ones(m, np.float32)), _jnp(ids), n, multiplicity=m * 400))
    sr.reset_counts()
    out = sr.sorted_segment_sum(torch.ones(m), _t(ids), n,
                                multiplicity=m * 400)
    np.testing.assert_array_equal(out.numpy(), want)
    assert out[0] == float(m) and sr.launches == 0
    # f64 values, which only CPU tensors take, sum in f64; an empty
    # reduce is zeros.
    v = torch.tensor([1.0, 1e-12, 2.0], dtype=torch.float64)
    out = sr.sorted_segment_sum(v, torch.tensor([0, 0, 2], dtype=torch.int32),
                                4)
    assert out.dtype == torch.float64 and out[0] == 1.0 + 1e-12
    out = sr.sorted_segment_sum(torch.ones(0),
                                torch.zeros(0, dtype=torch.int32), 4)
    assert out.tolist() == [0.0] * 4 and sr.launches == 0


# ---------------------------------------------------------------------------
# the four wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("values", ["integer", "real"])
def test_scatter_add_rows_matches_reference(values, jax_sr):
    # The bucket scorer's shape: invalid lanes alias row 0 and must add
    # nothing.
    rng = np.random.default_rng(1)
    b, r, n = 37, 29, 1_201
    row_ids = rng.permutation(n)[: b * r].reshape(b, r).astype(np.int32)
    zb = (_int_values(rng, (b, r)) if values == "integer"
          else rng.normal(size=(b, r)).astype(np.float32))
    valid = rng.uniform(size=(b, r)) < 0.7
    row_ids = np.where(valid, row_ids, 0).astype(np.int32)
    z = (_int_values(rng, n) if values == "integer"
         else rng.normal(size=n).astype(np.float32))
    want = np.asarray(jax_sr.scatter_add_rows(
        _jnp(z), _jnp(row_ids), _jnp(zb), _jnp(valid)))
    got = sr.scatter_add_rows(_t(z), _t(row_ids), _t(zb), _t(valid)).numpy()
    if values == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _ell_fixture(seed=0, b=3, r=17, k=4, s=140):
    rng = np.random.default_rng(seed)
    bi = rng.integers(0, s, size=(b, r, k)).astype(np.int32)
    bv = _int_values(rng, (b, r, k))
    bv[:, -3:] = 0.0  # padding rows
    w = rng.integers(0, 3, size=(b, r)).astype(np.float32)
    return bi, bv, w


def _window_bounds(bi, bv, s):
    """(grad_mult, hess_mult) as the planner computes them."""
    b = bi.shape[0]
    ent = np.arange(b, dtype=np.int64)[:, None, None]
    nz = bv != 0
    gids = (ent * s + bi)[nz]
    grad = sr.window_bound_from_counts(sr.window_counts_np(gids, b * s).max())
    pair_nz = nz[:, :, :, None] & nz[:, :, None, :]
    pids = (ent[..., None] * (s * s) + bi[:, :, :, None].astype(np.int64) * s
            + bi[:, :, None, :])[pair_nz]
    hess = sr.window_bound_from_counts(
        sr.window_counts_np(pids, b * s * s).max())
    return grad, hess


def _gram_both(jax_sr, bi, bv, w, s, storage=torch.float32):
    import jax.numpy as jnp

    grad, hess = _window_bounds(bi, bv, s)
    jv = jnp.asarray(bv).astype(jnp.bfloat16 if storage == torch.bfloat16
                                else jnp.float32)
    want = (jax_sr.ell_gram_blocks(_jnp(bi), jv, _jnp(w), s,
                                   multiplicity=hess),
            jax_sr.ell_segment_slots(_jnp(bi), jv, _jnp(w), s,
                                     multiplicity=grad))
    pv = _t(bv).to(storage)
    got = (sr.ell_gram_blocks(_t(bi), pv, _t(w), s, multiplicity=hess),
           sr.ell_segment_slots(_t(bi), pv, _t(w), s, multiplicity=grad))
    return [np.asarray(a) for a in want], [g.numpy() for g in got]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_gram_and_slots_match_reference_exactly(storage, jax_sr):
    bi, bv, w = _ell_fixture()
    want, got = _gram_both(jax_sr, bi, bv, w, 140,
                           getattr(torch, storage))
    assert got[0].shape == (3, 140, 140) and got[1].shape == (3, 140)
    assert got[0].dtype == np.float32
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # The products land where X^T W X puts them.
    x = np.zeros((3, 17, 140))
    for bb, rr, j in np.ndindex(*bi.shape):
        x[bb, rr, bi[bb, rr, j]] += bv[bb, rr, j]
    np.testing.assert_array_equal(
        got[0], np.einsum("br,brs,brt->bst", w, x, x).astype(np.float32))


def test_duplicate_slots_within_a_row_sum(jax_sr):
    s = 133
    bi = np.asarray([[[5, 5, 60], [7, 5, 5]]], np.int32)
    bv = np.asarray([[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]], np.float32)
    w = np.asarray([[2.0, 1.0]], np.float32)
    want, got = _gram_both(jax_sr, bi, bv, w, s)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1][0, 5] == 2.0 * 3.0 + 1.0 * 11.0


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_densify_matches_reference_with_duplicate_slots(storage, jax_sr):
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    b, r, k, s = 11, 13, 7, 151
    xi = rng.integers(0, s, size=(b, r, k)).astype(np.int32)
    xi[0, 0, :3] = 5
    xi[1, 2, :] = 149  # one slot repeated across a whole row
    xv = _int_values(rng, (b, r, k))
    jdt = jnp.bfloat16 if storage == "bfloat16" else jnp.float32
    want = np.asarray(jax_sr.densify_ell_blocks(
        _jnp(xi), jnp.asarray(xv).astype(jdt), s).astype(jnp.float32))
    got = sr.densify_ell_blocks(_t(xi), _t(xv).to(getattr(torch, storage)),
                                s)
    assert got.dtype == getattr(torch, storage) and got.shape == (b, r, s)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert got[1, 2, 149] == float(xv[1, 2].sum())


def test_densify_real_values_match_reference(jax_sr):
    rng = np.random.default_rng(7)
    b, r, k, s = 6, 40, 9, 193
    xi = rng.integers(0, s, size=(b, r, k)).astype(np.int32)
    xv = rng.normal(size=(b, r, k)).astype(np.float32)
    want = np.asarray(jax_sr.densify_ell_blocks(_jnp(xi), _jnp(xv), s))
    got = sr.densify_ell_blocks(_t(xi), _t(xv), s).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# gates and host helpers
# ---------------------------------------------------------------------------


def test_window_helpers_match_reference(jax_sr):
    rng = np.random.default_rng(5)
    for n in (1, 1_023, 1_024, 1_025, 9_000):
        ids = rng.integers(0, n, size=500).astype(np.int64)
        np.testing.assert_array_equal(sr.window_counts_np(ids, n),
                                      jax_sr.window_counts_np(ids, n))
    for c in (0, 1, 1_023, 1_024, 1_025, 70_000):
        assert (sr.window_bound_from_counts(c)
                == jax_sr.window_bound_from_counts(c))


GRID = [(b, r, k, s) for b in (1, 300, 11_000) for r in (16, 64, 4_096)
        for k in (1, 9, 33) for s in (17, 129, 193, 1_024, 1_025)]


def test_gram_and_densify_gates_match_reference_on_a_grid(jax_sr):
    import jax.numpy as jnp

    for (b, r, k, s) in GRID:
        for gm, hm in ((1, 1), (3, 1), (62, 2), (63, 1), (1, 64)):
            assert sr.ell_gram_supported(
                b, r, k, s, grad_mult=gm, hess_mult=hm
            ) == jax_sr.ell_gram_supported(
                b, r, k, s, grad_mult=gm, hess_mult=hm), (b, r, k, s, gm, hm)
    # densify_ell_blocks returns None exactly where the reference does.
    for s in (17, 193, 1_024, 1_025):
        for k in (1, 9, 3_000):
            shape = (2, 3, k)
            want = jax_sr.densify_ell_blocks(
                jnp.zeros(shape, jnp.int32), jnp.zeros(shape, jnp.float32), s)
            got = sr.densify_ell_blocks(torch.zeros(shape, dtype=torch.int32),
                                        torch.zeros(shape), s)
            assert (got is None) == (want is None), (s, k)
            assert sr.densify_supported(*shape, s, torch.float32) == (
                want is not None)


@pytest.mark.parametrize("s", [151, 1_100], ids=["narrow", "past_densify"])
def test_densify_ell_matches_the_scatter_add(s):
    # The 'ell' route's densify: any width, duplicate slots summed. On
    # the CPU it is the reference's scatter-add; it equals the windowed
    # densify wherever that one serves.
    rng = np.random.default_rng(12)
    b, r, k = 5, 11, 6
    xi = rng.integers(0, s, size=(b, r, k)).astype(np.int32)
    xi[0, 0, :3] = 7
    xv = _int_values(rng, (b, r, k))
    got = sr.densify_ell(_t(xi), _t(xv), s)
    want = np.zeros((b, r, s), np.float32)
    for bb, rr, j in np.ndindex(b, r, k):
        want[bb, rr, xi[bb, rr, j]] += xv[bb, rr, j]
    np.testing.assert_array_equal(got.numpy(), want)
    windowed = sr.densify_ell_blocks(_t(xi), _t(xv), s)
    assert (windowed is None) == (s > sr._OUT_TILE)
    if windowed is not None:
        assert torch.equal(windowed, got)
    # f64 values keep f64 on the CPU.
    got64 = sr.densify_ell(_t(xi), _t(xv.astype(np.float64)), s)
    assert got64.dtype == torch.float64
    np.testing.assert_array_equal(got64.numpy(), want)


def test_kernel_supported_keeps_dtype_and_size_rules_only(jax_sr):
    import jax.numpy as jnp

    for pdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16),
                     (torch.float64, jnp.float64), (torch.int32, jnp.int32)):
        for m, n in ((10, 10), (0, 10), (10, 0), (2**31, 5), (5, 2**31)):
            assert sr.kernel_supported(m, n, pdt) == jax_sr.kernel_supported(
                m, n, jdt), (pdt, m, n)


def test_unforced_reference_gate_is_backend_bound_and_the_port_is_not(
        monkeypatch):
    from photon_tpu.ops import segment_reduce as jsr

    monkeypatch.delenv("PHOTON_SEGMENT_KERNEL", raising=False)
    import jax.numpy as jnp

    assert not jsr.kernel_supported(100, 100, jnp.float32)  # CPU backend
    assert sr.kernel_supported(100, 100, torch.float32)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", ["dtype", "ids_dtype", "length", "rank",
                                 "empty"])
def test_wrapper_launch_checks_its_operands(bad):
    vals, ids, n = torch.ones(6), torch.zeros(6, dtype=torch.int32), 4
    if bad == "dtype":
        vals = vals.double()
    elif bad == "ids_dtype":
        ids = ids.long()
    elif bad == "length":
        ids = ids[:5]
    elif bad == "rank":
        vals, ids = vals.reshape(2, 3), ids.reshape(2, 3)
    else:
        vals, ids = vals[:0], ids[:0]
    before = sr.launches
    with pytest.raises(ValueError):
        sr._launch(vals, ids, n, "test")
    assert sr.launches == before


def test_wrapper_launch_raises_without_nvcc_and_counts_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine can build the kernel")
    before = sr.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        sr._launch(torch.ones(6), torch.zeros(6, dtype=torch.int32), 4,
                   "test")
    assert sr.launches == before


def test_cpu_tensors_take_the_plain_version():
    sr.reset_counts()
    out = sr.segment_sum(torch.tensor([1.0, 2.0, 4.0]),
                         torch.tensor([0, 0, 2], dtype=torch.int32), 3)
    assert out.tolist() == [3.0, 0.0, 4.0]
    assert sr.launches == 0 and sr.launches_by_site == {}


# ---------------------------------------------------------------------------
# the CUDA kernel (needs a GPU)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _assert_kernel_close(got, want, vals, ids, n):
    """Real values: |kernel - plain| <= 1e-6 * (1 + sum |v| of the
    segment), both f32 sums in other orders."""
    mag = sr.sorted_segment_sum_plain(vals.abs(), ids, n)
    assert bool(((got - want).abs() <= 1e-6 * (1.0 + mag)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["duplicates", "empty_segments",
                                  "dropped_ids", "long_run"])
def test_cuda_kernel_matches_plain_exactly(cuda_device, kind):
    vals, ids, n, _ = _segment_fixture(kind, np.random.default_rng(0))
    v, i = _t(vals).to(cuda_device), _t(ids).to(cuda_device)
    before = sr.launches
    got = sr.segment_sum(v, i, n)
    torch.cuda.synchronize()
    assert sr.launches == before + 1
    assert torch.equal(got, sr.sorted_segment_sum_plain(v, i, n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_real_values_and_repeatable(cuda_device, dtype):
    rng = np.random.default_rng(9)
    n = 300_000
    ids = np.sort(rng.integers(0, n + 1_000, 1_000_000)).astype(np.int32)
    v = _t(rng.normal(size=ids.size).astype(np.float32)).to(
        cuda_device, getattr(torch, dtype))
    i = _t(ids).to(cuda_device)
    a = sr.segment_sum(v, i, n)
    b = sr.segment_sum(v, i, n)
    torch.cuda.synchronize()
    assert torch.equal(a, b)  # bit-identical runs: no atomics
    _assert_kernel_close(a, sr.sorted_segment_sum_plain(v, i, n), v.float(),
                         i, n)


@pytest.mark.cuda
def test_cuda_wrappers_match_plain(cuda_device):
    bi, bv, w = _ell_fixture(seed=4, b=40, r=64, k=9, s=170)
    grad, hess = _window_bounds(bi, bv, 170)
    for dev in ("cpu", cuda_device):
        args = (_t(bi).to(dev), _t(bv).to(dev), _t(w).to(dev), 170)
        gram = sr.ell_gram_blocks(*args, multiplicity=hess).cpu()
        slots = sr.ell_segment_slots(*args, multiplicity=grad).cpu()
        dense = sr.densify_ell_blocks(*args[:2], 170).cpu()
        if dev == "cpu":
            want = (gram, slots, dense)
    for got, exp in zip((gram, slots, dense), want):
        assert torch.equal(got, exp)  # integer fixture: exact


@pytest.mark.cuda
def test_cuda_ungated_reduces_launch_the_kernel(cuda_device):
    # Shapes the reference's windows refuse still launch the kernel: a
    # multiplicity past _MAX_K_TILES, and densify past _OUT_TILE slots.
    m, n = 70_000, 5
    ids = torch.zeros(m, dtype=torch.int32, device=cuda_device)
    vals = torch.ones(m, device=cuda_device)
    sr.reset_counts()
    out = sr.sorted_segment_sum(vals, ids, n, multiplicity=m)
    torch.cuda.synchronize()
    assert out[0].item() == float(m)
    assert sr.launches_by_site == {"segment_reduce": 1}
    rng = np.random.default_rng(13)
    b, r, k, s = 7, 64, 9, 1_100
    xi = rng.integers(0, s, size=(b, r, k)).astype(np.int32)
    xv = _int_values(rng, (b, r, k))
    got = sr.densify_ell(_t(xi).to(cuda_device), _t(xv).to(cuda_device), s)
    torch.cuda.synchronize()
    assert sr.launches_by_site["segment_reduce/densify_ell"] == 1
    assert torch.equal(got.cpu(), sr.densify_ell_plain(_t(xi), _t(xv), s))
    with pytest.raises(ValueError, match="dtype"):
        sr.densify_ell(_t(xi).to(cuda_device),
                       _t(xv).to(cuda_device, torch.float64), s)


def _tiling_fixture(kind: str, rng):
    """(ids, n) of one edge of the kernel's output tiling: tiles of 1,024
    to 16,384 segments, a block owning several once there are more tiles
    than resident blocks, input streamed 1,024 elements a step."""
    if kind == "long_runs":
        # Runs longer than a step and than a tile, around step-sized ones.
        lens = [20_000, 1_023, 1_024, 1_025, 2_048, 2_049, 1, 9_000, 3]
        return np.repeat(np.arange(len(lens)) * 3, lens), 40
    if kind == "runs_across_tiles":
        # 586 tiles of 1,024: more than the resident blocks of an H100.
        n = 600_000
        return np.repeat(np.arange(n), rng.integers(0, 6, n)), n
    if kind == "gaps_and_empty_tiles":
        # Nothing in the first and last tiles, long stretches of empty
        # tiles between clusters, and n not a multiple of 4 or of a tile.
        ids = np.r_[np.sort(rng.integers(40_000, 41_000, 5_000)),
                    np.sort(rng.integers(1_700_000, 1_700_010, 300)),
                    np.sort(rng.integers(2_500_000, 2_900_000, 20_000))]
        return ids, 3_000_007
    if kind == "all_dropped_high":
        return np.full(5_000, 7), 7
    if kind == "all_dropped_low":
        return np.full(5_000, -4), 7
    if kind == "dropped_both_ends":
        return np.r_[np.full(3_000, -1), np.arange(10).repeat(300),
                     np.full(3_000, 12)], 11
    if kind == "one_value":
        return np.array([9_999_990]), 10_000_000
    if kind == "dense":
        # Many elements per segment: the launcher's smallest tile.
        return np.sort(rng.integers(0, 3_000, 300_000)), 3_000
    raise ValueError(kind)


TILING_CASES = ["long_runs", "runs_across_tiles", "gaps_and_empty_tiles",
                "all_dropped_high", "all_dropped_low", "dropped_both_ends",
                "one_value", "dense"]


def _launch_into(out, vals, ids):
    """The C launcher straight into ``out``, with no fill of its own."""
    import ctypes

    sr.load()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = sr._launch_fn(vals.data_ptr(), sr._VALUE_KIND[vals.dtype],
                       ids.data_ptr(), int(vals.shape[0]), int(out.shape[0]),
                       ctypes.c_void_p(out.data_ptr()), stream)
    assert rc == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", TILING_CASES)
def test_cuda_kernel_tiling_edges_exact(cuda_device, kind, dtype):
    """Integer values (exact in bf16 and in any f32 order): the kernel
    equals the plain version bit for bit, twice over, and writes every
    output of a NaN-filled buffer, aligned and not 16-byte aligned."""
    rng = np.random.default_rng(21)
    ids, n = _tiling_fixture(kind, rng)
    ids = np.sort(ids).astype(np.int32)
    vals = _int_values(rng, ids.size)
    v = _t(vals).to(cuda_device, getattr(torch, dtype))
    i = _t(ids).to(cuda_device)
    before = sr.launches
    a = sr.segment_sum(v, i, n)
    b = sr.segment_sum(v, i, n)
    torch.cuda.synchronize()
    assert sr.launches == before + 2
    want = sr.sorted_segment_sum_plain(v, i, n)
    assert torch.equal(a, want) and torch.equal(a, b)
    for shift in (0, 1):
        buf = torch.full((n + shift,), float("nan"), device=cuda_device)
        _launch_into(buf[shift:], v, i)
        torch.cuda.synchronize()
        assert torch.equal(buf[shift:], want)
