"""The port's fused serve score against the JAX package's.

The same model and requests, made with numpy from a seed, go through
the JAX ``ScorePrograms`` and the port's. The JAX side runs either its
Pallas kernel body in interpret mode (``PHOTON_SERVE_KERNEL=force``) or
its per-coordinate XLA chain (``off``); on the CPU the port runs the
kernel's plain PyTorch version, ``fused_score_reference``.

Tolerances: f32 tables agree to 1e-5 (the same products, summed in
another order in f32). bf16 tables agree to 5e-2, the serving parity
gate of PERFORMANCE.md ("serving_kernel_parity_maxdiff"): the port
rounds each bf16 product as the Pallas body is written, but XLA on the
CPU keeps bf16 products in f32 (its excess-precision default), and the
XLA chain forms the dense fixed-effect products in f32 by design. With
excess precision off, the port equals the Pallas body exactly in bf16
(``test_bf16_rounding_matches_the_pallas_body_exactly``, run in a
subprocess because XLA reads its flags once per process).

Projector ids are distinct within a row (the trained-model invariant).
The tests marked ``cuda`` hold the CUDA kernel against its plain version
and need a GPU; they skip on a machine without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_tpu_torch.io.model_io import game_model_from_numpy
from photon_tpu_torch.models.game import _score_raw_dense, _score_raw_sparse
from photon_tpu_torch.ops import serve_kernel
from photon_tpu_torch.serve.programs import (
    FeatureSpec,
    ScorePrograms,
    ShapeLadder,
)
from photon_tpu_torch.serve.tables import CoefficientTables

D, DU, E, S = 7, 8, 9, 4
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def model_arrays(entities=E, seed=3):
    """Checkpoint-keyed numpy parameters and manifest of a small GLMix
    model: a fixed effect on ``features`` and a per-user coordinate on
    ``userShard`` whose first entity has a -1 pad slot."""
    rng = np.random.default_rng(seed)
    if entities:
        proj = np.stack([
            np.sort(rng.choice(DU, size=S, replace=False))
            for _ in range(entities)
        ]).astype(np.int64)
        proj[0, -1] = -1
        coeffs = rng.normal(size=(entities, S)).astype(np.float32)
    else:
        proj = np.zeros((0, 1), np.int64)
        coeffs = np.zeros((0, 1), np.float32)
    arrays = {
        "global/means": rng.normal(size=D).astype(np.float32),
        "per-user/coefficients": coeffs,
        "per-user/proj_all": proj,
    }
    task = "LOGISTIC_REGRESSION"
    manifest = {
        "global": {"kind": "fixed", "shard": "features", "task": task},
        "per-user": {
            "kind": "random", "re_type": "userId", "shard": "userShard",
            "task": task,
            "entity_keys": [str(i) for i in range(entities)],
        },
    }
    return arrays, manifest


def jax_model(arrays, manifest):
    # JAX is imported where it is used, so that the `cuda` tests of this
    # file also run on a machine that has no JAX.
    import jax.numpy as jnp

    from photon_tpu.models.game import FixedEffectModel as JaxFixed
    from photon_tpu.models.game import GameModel as JaxGame
    from photon_tpu.models.game import RandomEffectModel as JaxRandom
    from photon_tpu.models.glm import Coefficients as JaxCoefficients
    from photon_tpu.models.glm import GeneralizedLinearModel as JaxGLM
    from photon_tpu.types import TaskType as JaxTask

    task = JaxTask.LOGISTIC_REGRESSION
    re = manifest["per-user"]
    return JaxGame({
        "global": JaxFixed(
            JaxGLM(JaxCoefficients(jnp.asarray(arrays["global/means"])),
                   task),
            "features",
        ),
        "per-user": JaxRandom(
            coefficients=jnp.asarray(arrays["per-user/coefficients"]),
            random_effect_type=re["re_type"],
            feature_shard_id=re["shard"],
            task=task,
            proj_all=arrays["per-user/proj_all"],
            entity_keys=tuple(re["entity_keys"]),
        ),
    })


def dense_requests(rng, n, entities=E, cold_every=4):
    reqs = []
    for i in range(n):
        feats = {
            "features": rng.normal(size=D).astype(np.float32),
            "userShard": rng.normal(size=DU).astype(np.float32),
        }
        cold = cold_every and i % cold_every == cold_every - 1
        ids = {} if cold else {"userId": str(i % max(entities, 1))}
        reqs.append((feats, ids))
    return reqs


def ell(rng, d, k=3):
    return (rng.choice(d, size=k, replace=False).astype(np.int32),
            rng.normal(size=k).astype(np.float32))


def sparse_requests(rng, n, *, dense_fe=False):
    reqs = []
    for i in range(n):
        feats = {
            "features": (rng.normal(size=D).astype(np.float32)
                         if dense_fe else ell(rng, D)),
            "userShard": ell(rng, DU),
        }
        reqs.append((feats, {} if i % 4 == 3 else {"userId": str(i % E)}))
    return reqs


def jax_scores(arrays, manifest, reqs, precision, mode, monkeypatch,
               specs=None, rungs=(1, 8)):
    from photon_tpu.serve.programs import FeatureSpec as JaxSpec
    from photon_tpu.serve.programs import ScorePrograms as JaxPrograms
    from photon_tpu.serve.programs import ShapeLadder as JaxLadder
    from photon_tpu.serve.tables import CoefficientTables as JaxTables

    monkeypatch.setenv("PHOTON_SERVE_KERNEL", mode)
    tables = JaxTables.from_game_model(jax_model(arrays, manifest), precision)
    jspecs = None if specs is None else {
        s: JaxSpec(v.kind, v.d, v.k) for s, v in specs.items()
    }
    progs = JaxPrograms(tables, ladder=JaxLadder(rungs), specs=jspecs,
                        compile_now=False)
    assert progs.use_kernel == (mode == "force")
    progs.compile_rung(progs.ladder.rung_for(len(reqs)))
    feats, codes, _ = progs.pack_requests(reqs)
    return progs.score_padded(feats, codes, len(reqs))


def port_scores(arrays, manifest, reqs, precision, specs=None, rungs=(1, 8)):
    model = game_model_from_numpy(arrays, manifest, "cpu")
    tables = CoefficientTables.from_game_model(model, precision, "cpu")
    progs = ScorePrograms(tables, ladder=ShapeLadder(rungs), specs=specs)
    feats, codes, _ = progs.pack_requests(reqs)
    return progs.score_padded(feats, codes, len(reqs))


SPARSE_SPECS = {
    "features": FeatureSpec("sparse", D, k=3),
    "userShard": FeatureSpec("sparse", DU, k=3),
}
MIXED_SPECS = {
    "features": FeatureSpec("dense", D),
    "userShard": FeatureSpec("sparse", DU, k=3),
}


def _case(name, rng):
    """(requests, specs, entities) of one named parity case."""
    if name.startswith("dense"):
        return dense_requests(rng, int(name.split("-")[1])), None, E
    if name.startswith("sparse"):
        return (sparse_requests(rng, int(name.split("-")[1])),
                SPARSE_SPECS, E)
    if name == "mixed":
        return sparse_requests(rng, 5, dense_fe=True), MIXED_SPECS, E
    if name == "all-cold":
        return [(f, {}) for f, _ in dense_requests(rng, 8)], None, E
    if name == "empty-re":
        reqs = [({"features": rng.normal(size=D).astype(np.float32)}, {})
                for _ in range(3)]
        return reqs, None, 0
    raise KeyError(name)


CASES = ["dense-1", "dense-8", "sparse-1", "sparse-8", "mixed", "all-cold",
         "empty-re"]


@pytest.mark.parametrize("mode", ["force", "off"])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_port_matches_jax_serve_score(monkeypatch, case, precision, mode):
    rng = np.random.default_rng(11 + CASES.index(case))
    reqs, specs, entities = _case(case, rng)
    arrays, manifest = model_arrays(entities)
    ref = jax_scores(arrays, manifest, reqs, precision, mode, monkeypatch,
                     specs=specs)
    got = port_scores(arrays, manifest, reqs, precision, specs=specs)
    assert got.shape == ref.shape == (len(reqs),)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=TOL[precision], rtol=0)


_EXACT_SCRIPT = """
import json, os, sys
import numpy as np
sys.path.insert(0, {tests!r})
import test_torch_serve_kernel as t

class Env:
    def setenv(self, key, value):
        os.environ[key] = value

diffs = {{}}
for case in t.CASES:
    rng = np.random.default_rng(11 + t.CASES.index(case))
    reqs, specs, entities = t._case(case, rng)
    arrays, manifest = t.model_arrays(entities)
    ref = t.jax_scores(arrays, manifest, reqs, "bfloat16", "force", Env(),
                       specs=specs)
    got = t.port_scores(arrays, manifest, reqs, "bfloat16", specs=specs)
    diffs[case] = float(np.abs(got - ref).max())
print(json.dumps(diffs))
"""


def test_bf16_rounding_matches_the_pallas_body_exactly():
    """With XLA's excess precision off, the Pallas body rounds every
    bf16 product as written; the port's plain version then agrees with
    it to f32 summation order (1e-6) on every case, not just to 5e-2."""
    import json
    import os
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(tests), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _EXACT_SCRIPT.format(tests=tests)],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    diffs = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(diffs) == set(CASES)
    assert max(diffs.values()) <= 1e-6, diffs


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_random_effect_scorers_match_jax(kind, precision):
    """The per-row gather scorers of models/game against the JAX
    scatter-then-gather ones, with cold, out-of-range and pad cases."""
    import jax.numpy as jnp

    from photon_tpu.models.game import _score_raw_dense as jax_raw_dense
    from photon_tpu.models.game import _score_raw_sparse as jax_raw_sparse

    rng = np.random.default_rng(5)
    arrays, _ = model_arrays()
    w = arrays["per-user/coefficients"]
    proj = arrays["per-user/proj_all"].astype(np.int32)
    codes = np.array([0, 3, -1, 8, 2, -1, 1, 4], np.int32)
    wdt_t = torch.bfloat16 if precision == "bfloat16" else torch.float32
    wdt_j = jnp.bfloat16 if precision == "bfloat16" else jnp.float32
    wt = torch.from_numpy(w).to(wdt_t)
    wj = jnp.asarray(w).astype(wdt_j)
    if kind == "dense":
        x = rng.normal(size=(8, DU)).astype(np.float32)
        got = _score_raw_dense(wt, torch.from_numpy(codes),
                               torch.from_numpy(x), torch.from_numpy(proj))
        ref = jax_raw_dense(wj, jnp.asarray(codes), jnp.asarray(x),
                            jnp.asarray(proj))
    else:
        idx = np.stack([ell(rng, DU)[0] for _ in range(8)])
        val = rng.normal(size=(8, 3)).astype(np.float32)
        got = _score_raw_sparse(wt, torch.from_numpy(codes),
                                torch.from_numpy(idx), torch.from_numpy(val),
                                torch.from_numpy(proj))
        ref = jax_raw_sparse(wj, jnp.asarray(codes), jnp.asarray(idx),
                             jnp.asarray(val), jnp.asarray(proj))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               atol=TOL[precision], rtol=0)


def _operands(rng, rung, *, sparse, wdtype=torch.float32, cold=0.25,
              device="cpu"):
    """fused_score operands at the small fixture's widths."""
    arrays, _ = model_arrays()
    fe_w = torch.from_numpy(arrays["global/means"]).to(wdtype)
    re_w = torch.from_numpy(arrays["per-user/coefficients"]).to(wdtype)
    re_p = torch.from_numpy(arrays["per-user/proj_all"].astype(np.int32))
    codes = rng.integers(0, E, size=rung).astype(np.int32)
    codes[rng.uniform(size=rung) < cold] = -1
    if sparse:
        feats = tuple(
            (torch.from_numpy(rng.integers(-1, d + 1, size=(rung, 3))
                              .astype(np.int32)),
             torch.from_numpy(rng.normal(size=(rung, 3)).astype(np.float32)))
            for d in (D, DU)
        )
        kinds = ("sparse", "sparse")
    else:
        feats = tuple(
            torch.from_numpy(rng.normal(size=(rung, d)).astype(np.float32))
            for d in (D, DU)
        )
        kinds = ("dense", "dense")

    def to(t):
        return t.to(device)

    feats = tuple(
        tuple(map(to, f)) if isinstance(f, tuple) else to(f) for f in feats
    )
    return dict(
        fe_ws=(to(fe_w),), re_ws=(to(re_w),), re_projs=(to(re_p),),
        feats=feats, codes=(to(torch.from_numpy(codes)),),
        spec_kinds=kinds, fe_feat=(0,), re_feat=(1,),
    )


def test_wrapper_on_cpu_is_the_plain_version():
    ops = _operands(np.random.default_rng(2), 8, sparse=True)
    before = serve_kernel.launches
    got = serve_kernel.fused_score(**ops)
    assert torch.equal(got, serve_kernel.fused_score_reference(**ops))
    assert serve_kernel.launches == before


@pytest.mark.parametrize("bad", ["int64-codes", "f64-features",
                                 "mixed-table-dtypes", "strided-features",
                                 "short-codes", "no-coordinates"])
def test_kernel_path_rejects_bad_operands(bad):
    """The CUDA path checks its operands before it launches; the checks
    need no GPU, so they run here through the launch path directly."""
    ops = _operands(np.random.default_rng(4), 8, sparse=False)
    if bad == "int64-codes":
        ops["codes"] = (ops["codes"][0].long(),)
    elif bad == "f64-features":
        ops["feats"] = (ops["feats"][0].double(), ops["feats"][1])
    elif bad == "mixed-table-dtypes":
        ops["re_ws"] = (ops["re_ws"][0].to(torch.bfloat16),)
    elif bad == "strided-features":
        x = torch.zeros(8, 2 * D)[:, ::2]
        ops["feats"] = (x, ops["feats"][1])
    elif bad == "short-codes":
        ops["codes"] = (ops["codes"][0][:4],)
    else:
        ops.update(fe_ws=(), fe_feat=(), re_ws=(), re_projs=(), re_feat=(),
                   codes=())
    with pytest.raises(ValueError):
        serve_kernel._launch(**ops)


def test_kernel_path_without_nvcc_raises_instead_of_falling_back(
    monkeypatch, tmp_path
):
    """Valid operands on the kernel path need the built library; with
    no nvcc the launch raises and counts nothing."""
    from photon_tpu_torch.ops import _build

    monkeypatch.setattr(serve_kernel, "_launch_fn", None)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    ops = _operands(np.random.default_rng(6), 8, sparse=False)
    before = serve_kernel.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        serve_kernel._launch(**ops)
    assert serve_kernel.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rung", [1, 8, 64, 512])
def test_cuda_kernel_matches_plain_version(cuda_device, rung, wdtype, sparse):
    ops = _operands(np.random.default_rng(rung), rung, sparse=sparse,
                    wdtype=wdtype, device=cuda_device)
    before = serve_kernel.launches
    got = serve_kernel.fused_score(**ops)
    torch.cuda.synchronize()
    assert serve_kernel.launches == before + 1
    ref = serve_kernel.fused_score_reference(**ops)
    tol = 1e-5 if wdtype == torch.float32 else 5e-2
    assert got.shape == (rung,) and got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= tol


# Edges of the kernel's design: (kind, layout, d, slots, k, shard) per
# coordinate, each on the named shard. Lane l takes the row's (coordinate,
# slot) pairs l, l + 32, ..., so 17 + 9 + 40 + 70 pairs take five rounds,
# with a coordinate split across rounds; two random coordinates may share
# a shard.
DESIGN_CASES = {
    **{f"coords-{n}": [("fixed", "dense", 20, 0, 0, 0)] + [
        ("random", "dense" if i % 2 else "ell", 24, 6 + i, 5, i + 1)
        for i in range(n - 1)] for n in range(1, 9)},
    "random-only": [("random", "ell", 30, 9, 4, 0)],
    "wide-slots": [("fixed", "ell", 64, 0, 8, 0),
                   ("random", "dense", 17, 17, 0, 1),
                   ("random", "ell", 90, 9, 6, 2),
                   ("random", "dense", 80, 40, 0, 3),
                   ("random", "ell", 200, 70, 12, 4)],
    "wide-ell": [("fixed", "ell", 300, 0, 40, 0),
                 ("random", "ell", 300, 50, 40, 0),
                 ("random", "ell", 60, 33, 37, 1)],
    "wide-dense": [("fixed", "dense", 64, 0, 0, 0),
                   ("random", "dense", 300, 17, 0, 1),
                   ("random", "dense", 9, 9, 0, 2)],
    "many-shards": [("random", "dense", 250, 5 + i, 0, i) for i in range(5)]
    + [("random", "ell", 100, 7, 60, 5)],
    "shared-shard": [("random", "dense", 40, 17, 0, 0),
                     ("random", "dense", 40, 9, 0, 0),
                     ("fixed", "dense", 40, 0, 0, 0)],
}


def _design_operands(rng, rung, coords, *, wdtype, device, entities=50):
    """fused_score operands for DESIGN_CASES: weights and features
    N(0, 0.3); projector rows distinct feature ids with -1 pads; ELL ids
    in [-1, d]; codes cold (-1) or past the table a fifth of the time
    each."""
    shards = {}
    for _, layout, d, _, k, si in coords:
        if si in shards:
            continue
        if layout == "dense":
            shards[si] = ("dense", torch.from_numpy(
                rng.normal(size=(rung, d)).astype(np.float32) * 0.3))
        else:
            shards[si] = ("sparse", (
                torch.from_numpy(rng.integers(-1, d + 1, size=(rung, k))
                                 .astype(np.int32)),
                torch.from_numpy(rng.normal(size=(rung, k))
                                 .astype(np.float32) * 0.3)))
    order = sorted(shards)
    fe_ws, fe_feat, re_ws, re_projs, re_feat, codes = [], [], [], [], [], []
    for kind, _, d, s, _, si in coords:
        if kind == "fixed":
            fe_ws.append(torch.from_numpy(
                rng.normal(size=d).astype(np.float32) * 0.3).to(wdtype))
            fe_feat.append(order.index(si))
            continue
        proj = np.full((entities, s), -1, np.int32)
        for e in range(entities):
            live = min(s, d) - int(rng.integers(0, 2))
            proj[e, :live] = rng.choice(d, size=live, replace=False)
        re_ws.append(torch.from_numpy(
            rng.normal(size=(entities, s)).astype(np.float32) * 0.3).to(
                wdtype))
        re_projs.append(torch.from_numpy(proj))
        re_feat.append(order.index(si))
        code = rng.integers(0, entities, size=rung).astype(np.int32)
        u = rng.uniform(size=rung)
        code[u < 0.2] = -1
        code[(u >= 0.2) & (u < 0.4)] = entities + 3
        codes.append(torch.from_numpy(code))

    def to(t):
        return t.to(device)

    feats = tuple(tuple(map(to, shards[si][1])) if shards[si][0] == "sparse"
                  else to(shards[si][1]) for si in order)
    return dict(fe_ws=tuple(map(to, fe_ws)), re_ws=tuple(map(to, re_ws)),
                re_projs=tuple(map(to, re_projs)), feats=feats,
                codes=tuple(map(to, codes)),
                spec_kinds=tuple(shards[si][0] for si in order),
                fe_feat=tuple(fe_feat), re_feat=tuple(re_feat))


def test_design_operands_are_valid_fused_score_inputs():
    """The CUDA cases' operands run through the plain version here."""
    rng = np.random.default_rng(0)
    for name, coords in DESIGN_CASES.items():
        ops = _design_operands(rng, 8, coords, wdtype=torch.float32,
                               device="cpu")
        z = serve_kernel.fused_score(**ops)
        assert z.shape == (8,) and bool(z.isfinite().all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("rung", [1, 8, 64, 512])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(DESIGN_CASES))
def test_cuda_kernel_at_its_design_edges(cuda_device, case, wdtype, rung):
    """f32: within 1e-5 (1 + the row's sum of |products|), the same
    products summed in another order; bf16: the serving gate 5e-2.
    Cold and past-the-table codes contribute exactly 0: a model whose
    only coordinate is random scores such rows 0."""
    rng = np.random.default_rng(rung)
    ops = _design_operands(rng, rung, DESIGN_CASES[case], wdtype=wdtype,
                           device=cuda_device)
    before = serve_kernel.launches
    got = serve_kernel.fused_score(**ops)
    torch.cuda.synchronize()
    assert serve_kernel.launches == before + 1
    ref = serve_kernel.fused_score_reference(**ops)
    assert got.shape == (rung,) and got.dtype == torch.float32
    if wdtype == torch.float32:
        mag = serve_kernel.fused_score_reference(**{
            **ops, "fe_ws": tuple(w.abs() for w in ops["fe_ws"]),
            "re_ws": tuple(w.abs() for w in ops["re_ws"]),
            "feats": tuple(tuple((f[0], f[1].abs())) if isinstance(f, tuple)
                           else f.abs() for f in ops["feats"])})
        assert bool(((got - ref).abs() <= 1e-5 * (1.0 + mag)).all())
    else:
        assert float((got - ref).abs().max()) <= 5e-2
    if case == "random-only":
        code = ops["codes"][0]
        cold = (code < 0) | (code >= ops["re_ws"][0].shape[0])
        assert bool((got[cold] == 0).all())


def test_params_mirror_matches_the_cuda_source():
    """The ctypes mirrors name the CUDA structs' fields in their order
    (the loader also checks the size against the built library)."""
    import re
    from pathlib import Path

    src = (Path(serve_kernel.__file__).resolve().parents[2]
           / serve_kernel.SOURCE).read_text()
    for struct, mirror in (("Coord", serve_kernel._Coord),
                           ("ServeParams", serve_kernel._Params)):
        body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S)[1]
        body = re.sub(r"//[^\n]*", "", body)
        names = re.findall(r"(\w+)(?:\[\w+\])?;", body)
        assert names == [f[0] for f in mirror._fields_], struct
