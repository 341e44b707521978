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

A layout may also carry a tile-ordered copy of the word-sorted stream
(with_doc_tiles: the trainers' COO B and every hybrid tail do): the
entries cut into tiles of DOC_TILE docs, sorted by (word, doc) within
each tile. B Y then runs one pass of the gather kernel per tile
(segsum.segsum_gather_rows_tiled), each gathering from one L2-sized
slice of Y, where segsum.gather_path says so.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import obs, segsum, staging
from .segsum import DEFAULT_CHUNK, segsum_gather_rows, segsum_onehot

# Docs a tile of the tile-ordered word stream (with_doc_tiles): a (T, 128)
# float32 slice of Y is 33.5 MB, inside the H100's 50 MB L2. One size for
# every layout, so the in-core, sharded and streamed layouts of one B tile
# alike. A module value, so that tests reach several tiles at a small
# size.
DOC_TILE = 65536


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
    # the tile-ordered copy of the word stream (with_doc_tiles), or none
    t_word: Optional[torch.Tensor] = None
    t_doc: Optional[torch.Tensor] = None
    t_val: Optional[torch.Tensor] = None
    tile_rows: int = 0  # docs a tile; 0: no tiles
    # entry offsets: tile t is [tile_starts[t], tile_starts[t + 1])
    tile_starts: Tuple[int, ...] = ()

    @property
    def nnz(self) -> int:
        return self.d_word.numel()

    @property
    def device(self) -> torch.device:
        return self.d_word.device

    @staticmethod
    def from_corpus(corpus, device, timer=None) -> "DocSparse":
        """From a corpus.Corpus in its CSC form. The word ids and values
        go to the device as they are, through pinned staging by entry
        ranges of staging.DEFAULT_CHUNK_ENTRIES on a card (views of the
        corpus's arrays on the CPU), the offsets beside them; each
        entry's doc id is made there from the offsets; then the
        word-sorted copy, as from_doc_sorted makes it. With a Timer,
        spans of the copies, the doc ids and the sort, the bytes read
        from the host and those that went through the staging."""
        device = torch.device(device)
        offsets = np.ascontiguousarray(corpus.offsets, np.int64)
        nnz = int(offsets[-1])
        rows = torch.from_numpy(np.ascontiguousarray(corpus.rows[:nnz],
                                                     np.int32))
        vals = torch.from_numpy(np.ascontiguousarray(corpus.vals[:nnz],
                                                     np.float32))
        with obs.span(timer, "upload: copy to device"):
            obs.count(timer, "upload bytes",
                      rows.nbytes + vals.nbytes + offsets.nbytes)
            off = torch.from_numpy(offsets).to(device)
            if device.type == "cuda":
                dw = torch.empty(nnz, dtype=torch.int32, device=device)
                dv = torch.empty(nnz, dtype=torch.float32, device=device)
                obs.count(timer, "upload staged bytes", staging.upload(
                    (rows, vals), (dw, dv), staging.DEFAULT_CHUNK_ENTRIES))
            else:
                dw, dv = rows.to(device), vals.to(device)
        with obs.span(timer, "upload: doc ids"):
            dd = doc_ids_from_offsets(off, 0, nnz)
        return DocSparse._word_sorted(dw, dd, dv, corpus.vocab_size,
                                      corpus.num_docs, timer)

    @staticmethod
    def from_doc_sorted(words, docs, vals, vocab: int, num_docs: int,
                        device, timer=None) -> "DocSparse":
        """From host COO arrays sorted by (doc, word); the word-sorted
        copy is made on the device by one sort of word * (D + 1) + doc.
        With a Timer, spans of the copies and the sort, and the bytes
        copied."""
        with obs.span(timer, "upload: copy to device"):
            host = (np.asarray(words, np.int32), np.asarray(docs, np.int32),
                    np.asarray(vals, np.float32))
            obs.count(timer, "upload bytes", sum(a.nbytes for a in host))
            dw, dd, dv = (torch.as_tensor(a).to(device) for a in host)
        return DocSparse._word_sorted(dw, dd, dv, vocab, num_docs, timer)

    @staticmethod
    def _word_sorted(dw, dd, dv, vocab: int, num_docs: int,
                     timer=None) -> "DocSparse":
        """From the doc-sorted arrays on the device, with the word-sorted
        copy made by one sort of word * (D + 1) + doc."""
        D = int(num_docs)
        with obs.span(timer, "upload: word-order sort"):
            key = dw.long() * (D + 1) + dd.long()
            perm = torch.sort(key, stable=True).indices
            w_word, w_doc, w_val = dw[perm], dd[perm], dv[perm]
        return DocSparse(
            d_word=dw, d_doc=dd, d_val=dv,
            w_word=w_word, w_doc=w_doc, w_val=w_val,
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


def doc_ids_from_offsets(offsets: torch.Tensor, first: int, nnz: int
                         ) -> torch.Tensor:
    """The doc id (int32) of each entry of docs [first, first + n), from
    their n + 1 CSC offsets (int64) on any device, made there: what
    corpus.doc_ids() holds for those docs. nnz is offsets[n] -
    offsets[0], which the caller knows without reading the device."""
    lens = offsets[1:] - offsets[:-1]
    return torch.repeat_interleave(
        torch.arange(first, first + lens.numel(), dtype=torch.int32,
                     device=offsets.device), lens, output_size=nnz)


def bt_x(sp: DocSparse, X: torch.Tensor, chunk: int = DEFAULT_CHUNK):
    """B^T X: (num_docs, width) from X (vocab, width)."""
    return segsum_gather_rows(sp.d_doc, sp.d_word, sp.d_val, X.contiguous(),
                              sp.num_docs, chunk=chunk)[:sp.num_docs]


def with_doc_tiles(sp: DocSparse, tile_rows: Optional[int] = None
                   ) -> DocSparse:
    """sp with a tile-ordered copy of its word stream: the entries sorted
    by (doc // T, word, doc), T = tile_rows (DOC_TILE by default), and the
    entry offsets of the ceil(num_docs / T) tiles (an empty tile has two
    equal offsets). One stable sort of the word stream by tile on the
    device; 12 bytes an entry more."""
    T = DOC_TILE if tile_rows is None else int(tile_rows)
    if T < 1:
        raise ValueError(f"tile_rows must be positive, got {T}")
    tile = torch.div(sp.w_doc, T, rounding_mode="floor")
    order = torch.sort(tile, stable=True).indices
    ntiles = max(-(-sp.num_docs // T), 1)
    counts = torch.bincount(tile.long(), minlength=ntiles)
    starts = (0, *torch.cumsum(counts, 0).tolist())
    return dataclasses.replace(
        sp, t_word=sp.w_word[order], t_doc=sp.w_doc[order],
        t_val=sp.w_val[order], tile_rows=T, tile_starts=starts)


def b_y(sp: DocSparse, Y: torch.Tensor, chunk: int = DEFAULT_CHUNK):
    """B Y: (vocab, width) from Y (num_docs, width); over the doc tiles
    where the layout has them and segsum.gather_path takes them (the
    tiled passes choose their own slice length, so `chunk` is the
    untiled kernel's)."""
    Y = Y.contiguous()
    if segsum.gather_path(Y.shape[1], Y.numel() * 4,
                          sp.tile_rows) == "tiled":
        return segsum.segsum_gather_rows_tiled(
            sp.t_word, sp.t_doc, sp.t_val, Y, sp.vocab,
            sp.tile_starts)[:sp.vocab]
    return segsum_gather_rows(sp.w_word, sp.w_doc, sp.w_val, Y, sp.vocab,
                              chunk=chunk)[:sp.vocab]


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
