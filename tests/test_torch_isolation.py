"""photon_tpu_torch stands alone: no JAX, nothing of photon_tpu, and the
GPU unless the CPU is asked for."""

from __future__ import annotations

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import photon_tpu_torch
from photon_tpu_torch import device as device_mod

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "photon_tpu_torch"


def _submodules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages(
            photon_tpu_torch.__path__, "photon_tpu_torch.")
    )


def test_every_submodule_imports_without_jax_or_photon_tpu():
    mods = _submodules()
    assert "photon_tpu_torch.ops.serve_kernel" in mods
    script = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'photon_tpu' or m.startswith('photon_tpu.')]\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def _imported_names(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_source_file_imports_jax_or_photon_tpu(path):
    names = list(_imported_names(ast.parse(path.read_text())))
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "jaxlib", "photon_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_device_resolve_defaults_to_cuda_and_never_falls_back():
    assert device_mod.resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert device_mod.resolve().type == "cuda"
        return
    for asked in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_mod.resolve(asked)


def test_device_resolve_rejects_other_devices():
    with pytest.raises(ValueError):
        device_mod.resolve("meta")


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    """Without the package beside it (and here, without a GPU too) the
    smoke script exits non-zero and prints no ``ok`` line."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
