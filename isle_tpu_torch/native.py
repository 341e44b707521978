"""ctypes bindings to the port's own C I/O library, csrc/isle_io.cpp
(isle_tpu's entry points and bytes out, parsing and writing on every
core): the TDF parser, the entry check and sort/dedup, the (major, minor)
ordering and the text writers (reference include/utils.h:96-487).

The library is built at first use with g++ (-O3 -fPIC -std=c++17
-pthread -shared) into build/isle_tpu_torch/ at the repository root,
named by a hash of the source and the flags, under a file lock so that
processes starting together build it once; a failed build raises. Each
function
has a numpy plain version (`*_plain`) that writes the same bytes and
returns the same arrays; the wrappers take it only where g++ is missing.
`backend()` says which of the two runs.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

from ._build import BUILD_DIR, CSRC

SOURCE = os.path.join(CSRC, "isle_io.cpp")
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared"]

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "isle_count_entries": [ctypes.c_char_p],
    "isle_parse_tdf": [ctypes.c_char_p, _I64P, _I64P, _I64P, ctypes.c_int64],
    "isle_write_sparse_model": [
        ctypes.c_char_p, _F32P, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32,
    ],
    "isle_check_entries": [_I64P, _I64P, ctypes.c_int64],
    "isle_sort_dedup_entries": [_I64P, _I64P, _I64P, ctypes.c_int64],
    "isle_order_by": [_I32P, _I32P, _I64P, ctypes.c_int64],
    "isle_write_if_triples": [
        ctypes.c_char_p, _I32P, _I32P, _F32P, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
    ],
    "isle_write_iii_triples": [
        ctypes.c_char_p, _I32P, _I32P, _I32P, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ],
}


def build() -> str:
    """The library's path, compiling csrc/isle_io.cpp first where no
    build of this source and these flags exists. The compiler writes a
    temporary file that is renamed into place, under an exclusive lock
    on a file beside it: a process that waited on the lock finds the
    library and builds nothing."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(CXXFLAGS).encode() + f.read())
    path = os.path.join(BUILD_DIR, f"libisle_io_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = ["g++", *CXXFLAGS, "-o", tmp, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed with exit code {proc.returncode}: "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    """The built and bound library, or None where g++ is missing."""
    if shutil.which("g++") is None:
        return None
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int64
    return lib


def backend() -> str:
    """"native" where the C library runs, "numpy" where the plain
    versions do (no g++)."""
    return "numpy" if _load() is None else "native"


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def parse_tdf_plain(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        arr = np.array(f.read().split(), dtype=np.int64)
    if arr.size % 3 != 0:
        raise ValueError(f"{path}: token count {arr.size} not a multiple of 3")
    arr = arr.reshape(-1, 3)
    return arr[:, 0] - 1, arr[:, 1] - 1, arr[:, 2]


def parse_tdf(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse 1-based `<doc> <word> <count>` lines into 0-based int64
    arrays: the library counts the triples, then each core reads its own
    byte range of the file and fills its part. The ids are rebased in
    place: the arrays returned are the only copy."""
    lib = _load()
    if lib is None:
        return parse_tdf_plain(path)
    n = lib.isle_count_entries(path.encode())
    if n == -2:
        raise ValueError(f"{path}: token count not a multiple of 3")
    if n < 0:
        raise OSError(f"cannot read {path}")
    docs, words, counts = (np.empty(n, dtype=np.int64) for _ in range(3))
    got = lib.isle_parse_tdf(path.encode(), _ptr(docs, _I64P),
                             _ptr(words, _I64P), _ptr(counts, _I64P), n)
    if got < 0:
        raise OSError(f"parse failed for {path}")
    docs, words, counts = docs[:got], words[:got], counts[:got]
    docs -= 1
    words -= 1
    return docs, words, counts


def sort_dedup_entries_plain(docs, words, counts):
    order = np.lexsort((words, docs))
    docs, words, counts = docs[order], words[order], counts[order]
    if len(docs) > 1:
        keep = np.empty(len(docs), dtype=bool)
        keep[0] = True
        keep[1:] = (docs[1:] != docs[:-1]) | (words[1:] != words[:-1])
        docs, words, counts = docs[keep], words[keep], counts[keep]
    return docs, words, counts


def _sortable(a: np.ndarray) -> bool:
    """An array the C sort may work in: C-contiguous writable int64."""
    return (a.dtype == np.int64 and a.flags.c_contiguous
            and a.flags.writeable)


def sort_dedup_entries(docs, words, counts, overwrite: bool = False,
                       log=None):
    """Sort by (doc, word) and keep the first of each duplicate pair
    (std::sort + std::unique, src/trainer.cpp:237-247). Where ids lie in
    [0, 2^31): entries already in strictly increasing order are kept as
    they are (one check, no sort), else the library's radix sort, which
    needs beside the arrays only 8 bytes an entry and raises MemoryError
    where it cannot have them. Other ids, or no g++, take the plain
    lexsort. Returns new arrays, or with overwrite=True (int64 arrays the
    caller gives up) the given ones, sorted in place, or views of them.
    `log`, where given, is called with the name of the path taken."""
    log = log or (lambda path: None)
    lib = _load()
    n = len(docs)
    if lib is None or n == 0:
        log("numpy lexsort" + ("" if n else " (no entries)"))
        return sort_dedup_entries_plain(docs, words, counts)
    arrays = [np.asarray(a) for a in (docs, words, counts)]
    owned = overwrite and all(map(_sortable, arrays)) and not any(
        np.may_share_memory(a, b) for i, a in enumerate(arrays)
        for b in arrays[i + 1:])
    if not owned:
        arrays = [np.array(a, np.int64) for a in arrays]
    d, w, c = arrays
    state = lib.isle_check_entries(_ptr(d, _I64P), _ptr(w, _I64P), n)
    where = "in place" if owned else "on copies"
    if state == 1:
        log(f"none needed (already sorted and unique, {where})")
        return d, w, c
    if state == 0:
        m = lib.isle_sort_dedup_entries(_ptr(d, _I64P), _ptr(w, _I64P),
                                        _ptr(c, _I64P), n)
        if m == -1:
            raise MemoryError(
                f"the ingest sort could not allocate its {8 * n} bytes of "
                f"indices for {n} entries")
        if m >= 0:
            log(f"native radix sort ({where})")
            return d[:m], w[:m], c[:m]
    log("numpy lexsort (ids past int32 or entries past 2^32 - 1)")
    return sort_dedup_entries_plain(docs, words, counts)


def order_by_plain(major: np.ndarray, minor: np.ndarray) -> np.ndarray:
    return np.lexsort((minor, major))


def order_by(major: np.ndarray, minor: np.ndarray) -> np.ndarray:
    """The stable permutation sorting non-negative int32 ids by (major,
    minor), as int64."""
    lib = _load()
    n = len(major)
    if lib is not None and n:
        ma = np.ascontiguousarray(major, np.int32)
        mi = np.ascontiguousarray(minor, np.int32)
        perm = np.empty(n, np.int64)
        if lib.isle_order_by(_ptr(ma, _I32P), _ptr(mi, _I32P),
                             _ptr(perm, _I64P), n) == 0:
            return perm
    return order_by_plain(major, minor)


def _triples(a, b, c, c_dtype):
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    c = np.ascontiguousarray(c, c_dtype)
    assert len(b) == len(a) and len(c) == len(a)
    return a, b, c


def write_float_triples_plain(path: str, a, b, v, base_a: int = 1,
                              base_b: int = 1) -> None:
    a, b, v = _triples(a, b, v, np.float32)
    with open(path, "w") as f:
        for i in range(len(a)):
            f.write(f"{a[i] + base_a}\t{b[i] + base_b}\t{v[i]:.6f}\n")


def write_float_triples(path: str, a: np.ndarray, b: np.ndarray,
                        v: np.ndarray, base_a: int = 1,
                        base_b: int = 1) -> None:
    """`<a+base_a>\\t<b+base_b>\\t<v:.6f>` lines (DocCatchword.tsv,
    DocTopicCatchwordSums.tsv, the inference top-topics files)."""
    lib = _load()
    if lib is None:
        return write_float_triples_plain(path, a, b, v, base_a, base_b)
    a, b, v = _triples(a, b, v, np.float32)
    if lib.isle_write_if_triples(path.encode(), _ptr(a, _I32P),
                                 _ptr(b, _I32P), _ptr(v, _F32P), len(a),
                                 base_a, base_b) < 0:
        raise OSError(f"cannot write {path}")


def write_int_triples_plain(path: str, a, b, c, base_a: int = 1,
                            base_b: int = 1, base_c: int = 1) -> None:
    a, b, c = _triples(a, b, c, np.int32)
    with open(path, "w") as f:
        for i in range(len(a)):
            f.write(f"{a[i] + base_a}\t{b[i] + base_b}\t{c[i] + base_c}\n")


def write_int_triples(path: str, a: np.ndarray, b: np.ndarray,
                      c: np.ndarray, base_a: int = 1, base_b: int = 1,
                      base_c: int = 1) -> None:
    """`<a>\\t<b>\\t<c>` integer lines (TopTwoTopicsPerDoc.txt,
    src/trainer.cpp:1008-1040; with base_c = 0 a TDF file)."""
    lib = _load()
    if lib is None:
        return write_int_triples_plain(path, a, b, c, base_a, base_b, base_c)
    a, b, c = _triples(a, b, c, np.int32)
    if lib.isle_write_iii_triples(path.encode(), _ptr(a, _I32P),
                                  _ptr(b, _I32P), _ptr(c, _I32P), len(a),
                                  base_a, base_b, base_c) < 0:
        raise OSError(f"cannot write {path}")


def write_sparse_model_plain(path: str, model: np.ndarray,
                             base: int = 1) -> None:
    model = np.asarray(model, dtype=np.float32)
    with open(path, "w") as f:
        for t in range(model.shape[1]):
            col = model[:, t]
            for w in np.nonzero(col > 1e-8)[0]:
                f.write(f"{t + base}\t{w + base}\t{col[w]:.10f}\n")


def write_sparse_model(path: str, model: np.ndarray, base: int = 1) -> None:
    """`<topic>\\t<word>\\t<weight>` lines for entries > 1e-8 of a
    (vocab, topics) model, topic-major, `base`-based ids
    (DenseMatrix::write_to_file_as_sparse, src/denseMatrix.cpp:153-187)."""
    lib = _load()
    if lib is None:
        return write_sparse_model_plain(path, model, base)
    model = np.asarray(model, dtype=np.float32)
    vocab, ntopics = model.shape
    buf = np.ascontiguousarray(model.T)  # the C writer is column-major
    if lib.isle_write_sparse_model(path.encode(), _ptr(buf, _F32P), vocab,
                                   ntopics, base) < 0:
        raise OSError(f"cannot write {path}")
