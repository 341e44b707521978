"""The C shim of the port's handle API (isle_tpu_torch/csrc/
isle_capi_torch.cpp): built from the repository's sources with g++ and
python3-config, then driven by the plain-C smoke host of the reference
shim (native/capi_smoke.c: dlopen, CreateTrainer / feedData / finalizeData
/ Train / GetBasicModel / GetNumEdgeTopics / DestroyTrainer, no Python of
its own). The embedded interpreter trains on the CPU (ISLE_CAPI_DEVICE)
with jax, isle_tpu and bench refused by a meta-path finder, so the shim
reaches nothing of the JAX package. Modelled on tests/test_capi_abi.py."""

import os
import shutil
import subprocess
import sysconfig

import pytest

from isle_tpu_torch import _build_capi

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BLOCK = (
    "import sys\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'isle_tpu', 'bench'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, _Block())\n"
)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(smoke binary, shim library), compiled into a temporary directory."""
    missing = _build_capi.toolchain()
    if missing is not None:
        pytest.skip(f"{missing} not found: the C shim cannot be built here")
    tmp = tmp_path_factory.mktemp("capi_abi")
    lib = _build_capi.build_shim(str(tmp))
    smoke = str(tmp / "capi_smoke")
    subprocess.run(
        [shutil.which("cc") or "gcc", "-O2", "-Wall", "-o", smoke,
         os.path.join(ROOT, "native", "capi_smoke.c"), "-ldl", "-lm"],
        check=True, capture_output=True, timeout=300)
    return smoke, lib


def _env(**extra):
    site = sysconfig.get_paths()["purelib"]
    env = dict(os.environ, PYTHONPATH=f"{ROOT}:{site}",
               ISLE_CAPI_BOOTSTRAP=BLOCK, OMP_NUM_THREADS="2")
    env.pop("ISLE_CAPI_DEVICE", None)
    env.pop("ISLE_CAPI_EDGE_TOPICS", None)
    env.update(extra)
    return env


def _run(built, tmp_path, **extra):
    return subprocess.run(list(built), env=_env(**extra), capture_output=True,
                          text=True, timeout=600, cwd=str(tmp_path))


def test_shim_builds_into_the_asked_directory(built):
    smoke, lib = built
    assert os.path.basename(lib) == _build_capi.LIB_NAME
    assert os.path.getsize(lib) > 0 and os.access(smoke, os.X_OK)
    assert _build_capi.BUILD_DIR.endswith(os.path.join("build",
                                                       "isle_tpu_torch"))
    symbols = subprocess.run(["nm", "-D", "--defined-only", lib],
                             capture_output=True, text=True, timeout=60)
    if symbols.returncode == 0:  # the eight entry points, unmangled
        for name in ("CreateTrainer", "DestroyTrainer", "feedData",
                     "finalizeData", "Train", "GetBasicModel",
                     "GetNumEdgeTopics", "GetEdgeModel"):
            assert f" T {name}\n" in symbols.stdout, name


def test_capi_smoke_from_c_host(built, tmp_path):
    out = _run(built, tmp_path, ISLE_CAPI_DEVICE="cpu")
    assert out.returncode == 0, out.stderr + out.stdout
    assert "CAPI SMOKE OK" in out.stdout
    assert "blocked" not in out.stderr


def test_capi_smoke_with_edge_topics(built, tmp_path):
    out = _run(built, tmp_path, ISLE_CAPI_DEVICE="cpu",
               ISLE_CAPI_EDGE_TOPICS="6")
    assert out.returncode == 0, out.stderr + out.stdout
    assert "CAPI SMOKE OK" in out.stdout
    assert int(out.stdout.split()[-3]) > 0  # edge topics


def test_capi_device_defaults_to_the_card(built, tmp_path):
    """Without ISLE_CAPI_DEVICE the trainers are made for "cuda": on a
    host without a card the smoke host fails, it does not train on the
    CPU behind the caller's back."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    out = _run(built, tmp_path)
    assert out.returncode != 0
    assert "CAPI SMOKE OK" not in out.stdout
    assert "cuda" in out.stderr.lower(), out.stderr
