"""Device-resident sparse term-document matrices and the SpMM primitives
the pipeline reduces to: the port of isle_tpu/sparse.py.

A (vocab x num_docs) matrix is dual-sorted COO on one device: d_* sorted
by (doc, word) (the CSC order), w_* sorted by (word, doc) (the CSR order).
Unlike isle_tpu.sparse.DocSparse there is no padding to a static length:
every array is exactly nnz long, int32 indices and float32 values.

The two SpMM directions are one function, segsum.segsum_gather_rows
(a hand-written kernel on the card, its plain version on the CPU), over
one of the two sorted streams:

    B^T X : out[d, :] += val * X[word, :]   over the doc-sorted stream
    B  Y  : out[w, :] += val * Y[doc, :]    over the word-sorted stream

`chunk` is the kernel's slice length (entries per slice); the CPU path
ignores it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .segsum import DEFAULT_CHUNK, segsum_gather_rows, segsum_onehot


@dataclasses.dataclass(frozen=True)
class DocSparse:
    d_word: torch.Tensor
    d_doc: torch.Tensor
    d_val: torch.Tensor
    w_word: torch.Tensor
    w_doc: torch.Tensor
    w_val: torch.Tensor
    vocab: int
    num_docs: int

    @property
    def nnz(self) -> int:
        return self.d_word.numel()

    @property
    def device(self) -> torch.device:
        return self.d_word.device

    @staticmethod
    def from_corpus(corpus, device) -> "DocSparse":
        """From a corpus.Corpus, whose CSC arrays are doc-sorted."""
        return DocSparse.from_doc_sorted(
            corpus.rows, corpus.doc_ids(), corpus.vals, corpus.vocab_size,
            corpus.num_docs, device)

    @staticmethod
    def from_doc_sorted(words, docs, vals, vocab: int, num_docs: int,
                        device) -> "DocSparse":
        """From host COO arrays sorted by (doc, word); the word-sorted
        copy is made on the device by one sort of word * (D + 1) + doc."""
        D = int(num_docs)
        dw = torch.as_tensor(np.asarray(words, np.int32)).to(device)
        dd = torch.as_tensor(np.asarray(docs, np.int32)).to(device)
        dv = torch.as_tensor(np.asarray(vals, np.float32)).to(device)
        key = dw.long() * (D + 1) + dd.long()
        perm = torch.sort(key, stable=True).indices
        return DocSparse(
            d_word=dw, d_doc=dd, d_val=dv,
            w_word=dw[perm], w_doc=dd[perm], w_val=dv[perm],
            vocab=int(vocab), num_docs=D,
        )

    @staticmethod
    def from_numpy(d_word, d_doc, d_val, w_word, w_doc, w_val, vocab: int,
                   num_docs: int, device) -> "DocSparse":
        """From the six arrays of an isle_tpu.sparse.DocSparse as numpy.
        Its padded entries (word == vocab, at the end of both orders) are
        dropped, so the streams come out exactly nnz long."""
        nnz = int(np.count_nonzero(np.asarray(d_word) < vocab))

        def up(a, dtype):
            return torch.from_numpy(np.array(a[:nnz], dtype)).to(device)

        return DocSparse(
            d_word=up(d_word, np.int32), d_doc=up(d_doc, np.int32),
            d_val=up(d_val, np.float32), w_word=up(w_word, np.int32),
            w_doc=up(w_doc, np.int32), w_val=up(w_val, np.float32),
            vocab=int(vocab), num_docs=int(num_docs),
        )


def bt_x(sp: DocSparse, X: torch.Tensor, chunk: int = DEFAULT_CHUNK):
    """B^T X: (num_docs, width) from X (vocab, width)."""
    return segsum_gather_rows(sp.d_doc, sp.d_word, sp.d_val, X.contiguous(),
                              sp.num_docs, chunk=chunk)[:sp.num_docs]


def b_y(sp: DocSparse, Y: torch.Tensor, chunk: int = DEFAULT_CHUNK):
    """B Y: (vocab, width) from Y (num_docs, width)."""
    return segsum_gather_rows(sp.w_word, sp.w_doc, sp.w_val, Y.contiguous(),
                              sp.vocab, chunk=chunk)[:sp.vocab]


def gram_x(sp: DocSparse, X: torch.Tensor, chunk: int = DEFAULT_CHUNK):
    """(B B^T) X, the eigensolver operator."""
    return b_y(sp, bt_x(sp, X, chunk), chunk)


def doc_l2sq(sp: DocSparse, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Per-document squared l2 norms: segsum_onehot of val^2 over the
    doc-sorted stream into one column, so on the card they are bit-equal
    from run to run."""
    return segsum_onehot(sp.d_doc, None, sp.d_val * sp.d_val, sp.num_docs, 1,
                         chunk=chunk)[:sp.num_docs, 0]


def frobenius_sq(sp: DocSparse) -> torch.Tensor:
    return doc_l2sq(sp).sum()


def spmm_flops(sp: DocSparse, width: int) -> int:
    """FLOPs of one bt_x or b_y call (2*nnz*width)."""
    return 2 * sp.nnz * width


def to_dense(sp: DocSparse) -> np.ndarray:
    """Host float64 densification (small problems: the dense eigensolver)."""
    out = np.zeros((sp.vocab, sp.num_docs), np.float64)
    np.add.at(
        out,
        (sp.d_word.cpu().numpy(), sp.d_doc.cpu().numpy()),
        sp.d_val.cpu().numpy().astype(np.float64),
    )
    return out
