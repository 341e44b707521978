"""Packaging of the port: isle_tpu_torch ships with its CUDA sources, adds
no console script, and none of its sources imports jax."""

import pathlib
import re
import subprocess
import sys
import tomllib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "isle_tpu_torch"


def test_every_package_dir_has_init():
    for d in [PKG, *PKG.rglob("*")]:
        if d.is_dir() and d.name not in ("__pycache__", "csrc"):
            assert (d / "__init__.py").exists(), f"missing __init__.py in {d}"


def test_sources_do_not_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    sources = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in sources:
        assert not pat.search(f.read_text()), f"{f} imports jax"


def test_pyproject_ships_the_port():
    meta = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert "isle_tpu*" in meta["tool"]["setuptools"]["packages"]["find"][
        "include"]
    data = meta["tool"]["setuptools"]["package-data"]["isle_tpu_torch"]
    assert {"csrc/*.cu", "csrc/*.cuh"} <= set(data)
    assert any(d.startswith("torch") for d in
               meta["project"]["optional-dependencies"]["torch"])
    assert not any("torch" in s for s in meta["project"]["scripts"])
    assert list(PKG.glob("csrc/*.cu"))


@pytest.mark.parametrize("module", [
    "isle_tpu_torch", "isle_tpu_torch.mwu", "isle_tpu_torch.inferencer",
    "isle_tpu_torch.cli.infer", "isle_tpu_torch.cli.train",
    "isle_tpu_torch.trainer", "isle_tpu_torch.elkans",
])
def test_import_pulls_in_no_jax(module):
    """The card's host has no jax: importing a module of the port (and the
    package's lazy exports) loads no jax."""
    code = (
        "import importlib, sys\n"
        f"m = importlib.import_module({module!r})\n"
        "if m.__name__ == 'isle_tpu_torch':\n"
        "    m.Inferencer, m.InferConfig, m.Trainer\n"
        "assert not [n for n in sys.modules if n.split('.')[0] == 'jax'], "
        "'jax imported'\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
