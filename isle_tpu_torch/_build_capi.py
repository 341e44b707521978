"""Build the C shim of the handle API, csrc/isle_capi_torch.cpp, into a
shared library that a non-Python host can dlopen: g++ with the flags of
`python3-config --includes` and `python3-config --ldflags --embed` (the
recipe of isle_tpu's Makefile), so the library links the interpreter it
embeds.

    python -m isle_tpu_torch._build_capi [out_dir]

writes libisle_trainer_torch.so into out_dir (default:
build/isle_tpu_torch/ at the repository root) and prints its path. The
host process then sets PYTHONPATH (the package's directory and the
site-packages that hold torch) and ISLE_CAPI_DEVICE ("cuda", the default,
or "cpu"); csrc/isle_capi_torch.cpp lists the rest. A failed build raises.
"""

from __future__ import annotations

import os
import shlex
import shutil
import subprocess
import sys
from typing import Optional

from ._build import BUILD_DIR, CSRC

SOURCE = os.path.join(CSRC, "isle_capi_torch.cpp")
LIB_NAME = "libisle_trainer_torch.so"
CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]


def toolchain() -> Optional[str]:
    """None when g++ and python3-config are both on PATH, else the name
    of the missing tool."""
    for tool in ("g++", "python3-config"):
        if shutil.which(tool) is None:
            return tool
    return None


def _python_config(*flags: str) -> list:
    out = subprocess.run(["python3-config", *flags], capture_output=True,
                         text=True, check=True, timeout=60)
    return shlex.split(out.stdout)


def build_shim(out_dir: Optional[str] = None) -> str:
    """Compile the shim into out_dir and return the library's path."""
    missing = toolchain()
    if missing is not None:
        raise RuntimeError(f"{missing} not found: the C shim cannot be built")
    out_dir = out_dir or BUILD_DIR
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, LIB_NAME)
    ldflags = _python_config("--ldflags", "--embed")
    # the host finds libpython where the build found it
    rpaths = [f"-Wl,-rpath,{f[2:]}" for f in ldflags if f.startswith("-L")]
    cmd = ["g++", *CXXFLAGS, *_python_config("--includes"), "-o", path,
           SOURCE, *ldflags, *rpaths]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    return path


if __name__ == "__main__":
    print(build_shim(sys.argv[1] if len(sys.argv) > 1 else None))
