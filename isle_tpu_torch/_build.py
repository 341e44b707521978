"""Build the CUDA kernels of csrc/ with nvcc at first use and bind them
with ctypes.

The library goes into build/isle_tpu_torch/ at the repository root, named
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing file; ptxas's register and spill report
of the build is kept beside it and returned with it. Each source compiles in an nvcc of
its own, all started together, and one more nvcc links the objects. nvcc
compiles the plain C interface in seconds;
torch.utils.cpp_extension.load, which includes PyTorch's headers, takes
minutes. A failed build raises.
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
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    "isle_chunk_onehot_partials_f32": [
        _P, _P, _I64, _I, _I64, _I, _I, _P, _I, _P,
    ],
    "isle_row_gather_bulk_f32": [_P, _P, _I64, _I, _I, _I64, _I, _P, _I, _P],
    "isle_micro_kernel_info": [_I, _I64, _I, _I64, _I, _I, _P],
    "isle_pack_kept_lengths": [_P, _P, _P, _I64, _I, _I, _P, _I, _P],
    "isle_pack_fill": [_P, _P, _P, _P, _I64, _I, _I, _P, _P, _P, _P, _I, _P],
}


@dataclasses.dataclass(frozen=True)
class Kernels:
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an up-to-date library was found
    ptxas_log: str  # nvcc's -Xptxas -v report of the build that made `path`


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "isle_tpu_torch/csrc cannot be built"
    )


def _raise_if_failed(cmd: list, returncode: int, log: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {returncode}: "
                           f"{' '.join(cmd)}\n{log}")


def _build() -> tuple:
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(s, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"libisle_segsum_{h.hexdigest()[:16]}.so")
    log_path = f"{path}.ptxas.log"
    if os.path.exists(path) and os.path.exists(log_path):
        with open(log_path) as f:
            return path, 0.0, f.read()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
            for o, s in zip(objs, sources)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        _raise_if_failed(cmd, proc.returncode, log)
    link = [nvcc, *GENCODE, "-shared", "-o", tmp, *objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    _raise_if_failed(link, proc.returncode, proc.stdout + proc.stderr)
    seconds = time.perf_counter() - t0
    for o in objs:
        os.remove(o)
    log = "".join(logs)
    # the report is kept beside the library, so that a reused build is
    # still checked for spills; both are renamed into place, the library
    # last (atomic: a process building at the same time never loads a
    # partial file, and a library it finds has its report)
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", log_path)
    os.replace(tmp, path)
    return path, seconds, log


def build_alone(src: str, name: str, entries) -> ctypes.CDLL:
    """One .cu source (an earlier version of a kernel, which a probe times
    beside the current one) built alone with the port's flags into
    build/<name>/lib<name>.so, its `entries` bound with their signatures."""
    out_dir = os.path.join(os.path.dirname(BUILD_DIR), name)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"lib{name}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", path, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _raise_if_failed(cmd, proc.returncode, proc.stdout + proc.stderr)
    lib = ctypes.CDLL(path)
    for entry in entries:
        fn = getattr(lib, entry)
        fn.argtypes = _SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return lib


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
