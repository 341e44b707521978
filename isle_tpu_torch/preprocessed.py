"""Preprocessed binary corpus artifacts, the "big-data mode" ingest: the
port's copy of isle_tpu/preprocessed.py (numpy on the host), so either
package loads what the other saved.

Format (reference src/trainer.cpp:296-362), a sidecar set around a prefix
<f>:
    <f>_tr.info : text: vocab_size num_docs nnz avg_doc_sz
    <f>_tr.csr  : float32[nnz]  normalized CSC values (doc-major)
    <f>_tr.col  : int32[nnz]    word ids (doc-major)
    <f>_tr.off  : int64[num_docs+1] CSC offsets
    <f>.csr / <f>.col / <f>.off : the same matrix in CSR (word-major)
The loader reads the doc-major set; the word-major copy is written for the
reference's tools.
"""

from __future__ import annotations

import numpy as np

from .corpus import Corpus


def save_preprocessed(corpus, prefix: str) -> None:
    with open(prefix + "_tr.info", "w") as f:
        f.write(f"{corpus.vocab_size} {corpus.num_docs} {corpus.nnz} "
                f"{corpus.avg_doc_sz}\n")
    corpus.vals.astype(np.float32).tofile(prefix + "_tr.csr")
    corpus.rows.astype(np.int32).tofile(prefix + "_tr.col")
    corpus.offsets.astype(np.int64).tofile(prefix + "_tr.off")
    docs = corpus.doc_ids()
    order = np.lexsort((docs, corpus.rows))
    corpus.vals[order].astype(np.float32).tofile(prefix + ".csr")
    docs[order].astype(np.int32).tofile(prefix + ".col")
    row_offsets = np.zeros(corpus.vocab_size + 1, np.int64)
    np.add.at(row_offsets, corpus.rows.astype(np.int64) + 1, 1)
    np.cumsum(row_offsets, out=row_offsets)
    row_offsets.tofile(prefix + ".off")


def load_preprocessed(prefix: str) -> Corpus:
    with open(prefix + "_tr.info") as f:
        parts = f.read().split()
    vocab_size, num_docs, nnz = int(parts[0]), int(parts[1]), int(parts[2])
    avg_doc_sz = float(parts[3])
    vals = np.fromfile(prefix + "_tr.csr", dtype=np.float32, count=nnz)
    rows = np.fromfile(prefix + "_tr.col", dtype=np.int32, count=nnz)
    offsets = np.fromfile(prefix + "_tr.off", dtype=np.int64,
                          count=num_docs + 1)
    return Corpus(
        vocab_size=vocab_size,
        num_docs=num_docs,
        offsets=offsets,
        rows=rows,
        counts=None,  # raw counts are not part of the artifact
        vals=vals,
        avg_doc_sz=avg_doc_sz,
        nz_docs=int((np.diff(offsets) > 0).sum()),
    )
