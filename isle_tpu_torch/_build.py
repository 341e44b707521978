"""Build the CUDA kernels of csrc/ with nvcc at first use and bind them
with ctypes.

The library goes into build/isle_tpu_torch/ at the repository root, named
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing file. nvcc compiles the plain C
interface in seconds; torch.utils.cpp_extension.load, which includes
PyTorch's headers, takes minutes. A failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "isle_tpu_torch",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
# Every pointer and the stream are c_void_p: a bare Python int would be
# passed as a 32-bit int and cut the address.
_SIGNATURES = {
    "isle_segsum_onehot_i32": [_P, _P, _P, _I64, _I, _I, _I64, _P, _I, _P],
    "isle_segsum_onehot_f32": [
        _P, _P, _P, _P, _I64, _I, _I, _I64, _P, _P, _I, _P,
    ],
    "isle_segsum_gather_rows_f32": [
        _P, _P, _P, _P, _I64, _I64, _I, _I, _I64, _I, _P, _P, _P, _I, _P,
    ],
    "isle_segsum_gather_rows_narrow_f32": [
        _P, _P, _P, _P, _I64, _I64, _I, _I, _I64, _I, _P, _P, _P, _I, _P,
    ],
}


@dataclasses.dataclass(frozen=True)
class Kernels:
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an up-to-date library was found
    ptxas_log: str  # nvcc's -Xptxas -v report of this build ("" if reused)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "isle_tpu_torch/csrc cannot be built"
    )


def _build() -> tuple:
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(s, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"libisle_segsum_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    # atomic: a process building at the same time never loads a partial
    # file
    os.replace(tmp, path)
    return path, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def kernels() -> Kernels:
    """The built and bound kernel library (built once per process)."""
    path, seconds, log = _build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Kernels(lib=lib, path=path, build_seconds=seconds, ptxas_log=log)
