"""Packaging of the port: isle_tpu_torch ships with its CUDA sources, adds
no console script, and none of its sources imports jax."""

import pathlib
import re
import tomllib

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
