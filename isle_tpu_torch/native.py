"""ctypes bindings to the repository's C I/O library, native/libisle_io.so
(built with `make -C native`), with numpy fallbacks that write the same
bytes when it has not been built. The port's copy of isle_tpu/native.py,
for the functions the port calls: the TDF parser, the entry sort/dedup and
the buffered text writers (reference include/utils.h:96-487).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native", "libisle_io.so",
)

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
    "isle_sort_dedup_entries": [_I64P, _I64P, _I64P, ctypes.c_int64],
    "isle_write_if_triples": [
        ctypes.c_char_p, _I32P, _I32P, _F32P, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
    ],
    "isle_write_iii_triples": [
        ctypes.c_char_p, _I32P, _I32P, _I32P, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ],
}


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    """The library with every entry point above, or None (not built, or
    an older build without one of them)."""
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is None:
            return None
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int64
    return lib


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def parse_tdf(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse 1-based `<doc> <word> <count>` lines into 0-based int64
    arrays: the native two-pass mmap parser, else numpy."""
    lib = _load()
    if lib is None:
        with open(path, "rb") as f:
            arr = np.array(f.read().split(), dtype=np.int64)
        if arr.size % 3 != 0:
            raise ValueError(
                f"{path}: token count {arr.size} not a multiple of 3")
        arr = arr.reshape(-1, 3)
        return arr[:, 0] - 1, arr[:, 1] - 1, arr[:, 2]
    n = lib.isle_count_entries(path.encode())
    if n < 0:
        raise OSError(f"cannot read {path}")
    docs, words, counts = (np.empty(n, dtype=np.int64) for _ in range(3))
    got = lib.isle_parse_tdf(path.encode(), _ptr(docs, _I64P),
                             _ptr(words, _I64P), _ptr(counts, _I64P), n)
    if got < 0:
        raise OSError(f"parse failed for {path}")
    return docs[:got] - 1, words[:got] - 1, counts[:got]


def sort_dedup_entries(docs, words, counts):
    """Sort by (doc, word) and keep the first of each duplicate pair
    (std::sort + std::unique, src/trainer.cpp:237-247). Native radix sort
    when ids fit in int32 (it returns < 0 on failure and past 2^32 - 1
    entries), numpy lexsort otherwise. Returns new arrays."""
    lib = _load()
    n = len(docs)
    if (lib is not None and n and int(docs.max()) < 2**31
            and int(words.max()) < 2**31):
        d = np.array(docs, np.int64)
        w = np.array(words, np.int64)
        c = np.array(counts, np.int64)
        m = lib.isle_sort_dedup_entries(_ptr(d, _I64P), _ptr(w, _I64P),
                                        _ptr(c, _I64P), n)
        if m >= 0:
            return d[:m], w[:m], c[:m]
    order = np.lexsort((words, docs))
    docs, words, counts = docs[order], words[order], counts[order]
    if len(docs) > 1:
        keep = np.empty(len(docs), dtype=bool)
        keep[0] = True
        keep[1:] = (docs[1:] != docs[:-1]) | (words[1:] != words[:-1])
        docs, words, counts = docs[keep], words[keep], counts[keep]
    return docs, words, counts


def write_float_triples(path: str, a: np.ndarray, b: np.ndarray,
                        v: np.ndarray, base_a: int = 1,
                        base_b: int = 1) -> None:
    """`<a+base_a>\\t<b+base_b>\\t<v:.6f>` lines (DocCatchword.tsv,
    DocTopicCatchwordSums.tsv, the inference top-topics files)."""
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    v = np.ascontiguousarray(v, np.float32)
    n = len(a)
    assert len(b) == n and len(v) == n
    lib = _load()
    if lib is not None:
        if lib.isle_write_if_triples(path.encode(), _ptr(a, _I32P),
                                     _ptr(b, _I32P), _ptr(v, _F32P), n,
                                     base_a, base_b) < 0:
            raise OSError(f"cannot write {path}")
        return
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"{a[i] + base_a}\t{b[i] + base_b}\t{v[i]:.6f}\n")


def write_int_triples(path: str, a: np.ndarray, b: np.ndarray,
                      c: np.ndarray, base_a: int = 1, base_b: int = 1,
                      base_c: int = 1) -> None:
    """`<a>\\t<b>\\t<c>` integer lines (TopTwoTopicsPerDoc.txt,
    src/trainer.cpp:1008-1040)."""
    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    c = np.ascontiguousarray(c, np.int32)
    n = len(a)
    assert len(b) == n and len(c) == n
    lib = _load()
    if lib is not None:
        if lib.isle_write_iii_triples(path.encode(), _ptr(a, _I32P),
                                      _ptr(b, _I32P), _ptr(c, _I32P), n,
                                      base_a, base_b, base_c) < 0:
            raise OSError(f"cannot write {path}")
        return
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"{a[i] + base_a}\t{b[i] + base_b}\t{c[i] + base_c}\n")


def write_sparse_model(path: str, model: np.ndarray, base: int = 1) -> None:
    """`<topic>\\t<word>\\t<weight>` lines for entries > 1e-8 of a
    (vocab, topics) model, topic-major, `base`-based ids
    (DenseMatrix::write_to_file_as_sparse, src/denseMatrix.cpp:153-187)."""
    model = np.asarray(model, dtype=np.float32)
    vocab, ntopics = model.shape
    lib = _load()
    if lib is not None:
        buf = np.ascontiguousarray(model.T)  # the C writer is column-major
        if lib.isle_write_sparse_model(path.encode(), _ptr(buf, _F32P),
                                       vocab, ntopics, base) < 0:
            raise OSError(f"cannot write {path}")
        return
    with open(path, "w") as f:
        for t in range(ntopics):
            col = model[:, t]
            for w in np.nonzero(col > 1e-8)[0]:
                f.write(f"{t + base}\t{w + base}\t{col[w]:.10f}\n")
