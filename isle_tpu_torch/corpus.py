"""Host-side corpus ingest: term-document-frequency parsing, entry
sort/dedup, CSC assembly and per-document normalization. The port's copy
of isle_tpu/corpus.py (the parts the port calls), numpy on the host.

Reference ingest path: include/utils.h:96-229 `DocWordEntriesReader`,
src/trainer.cpp:214-362 `feed_data`/`finalize_data`,
src/sparseMatrix.cpp:58-167 `populate_CSC`/`normalize_docs`.

Conventions (include/sparseMatrix.h:31-38): the term-document matrix is CSC
with documents as columns and words as rows, 0-based. TDF text files are
1-based `<doc_id> <word_id> <count>` triples.

The trainer and the inferencer read only a corpus's arrays (vocab_size,
num_docs, offsets, rows, vals, avg_doc_sz, nz_docs, nnz, doc_ids()), so
any object with those, isle_tpu.corpus.Corpus among them, can be handed
to them; the streamed trainer's resident loader reads `counts`,
doc_sums() and vals_match() as well where the object has counts.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from . import native


def read_tdf_entries(
    path: str, max_entries: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a 1-based TDF file into 0-based (doc, word, count) arrays
    (DocWordEntriesReader::read_from_file, include/utils.h:104-156)."""
    docs, words, counts = native.parse_tdf(path)
    if max_entries is not None and len(docs) > max_entries:
        docs, words, counts = (
            docs[:max_entries], words[:max_entries], counts[:max_entries],
        )
    return docs, words, counts


@dataclasses.dataclass
class Corpus:
    """A normalized term-document matrix in host CSC form.

    vocab_size, num_docs : logical dims (empty docs kept as zero columns).
    offsets : int64[num_docs+1] CSC column offsets.
    rows    : int32[nnz] word ids, sorted within each doc.
    counts  : float32[nnz] raw counts (the reference's vals_CSC).
    vals    : float32[nnz] normalized values (normalized_vals_CSC).
    avg_doc_sz : the reference computes `(FPTYPE)(total_word_count /
        _nz_docs)` with INTEGER division (src/sparseMatrix.cpp:98); so
        does this.
    nz_docs : number of non-empty documents.
    """

    vocab_size: int
    num_docs: int
    offsets: np.ndarray
    rows: np.ndarray
    counts: Optional[np.ndarray]
    vals: np.ndarray
    avg_doc_sz: float
    nz_docs: int

    @property
    def nnz(self) -> int:
        return int(self.offsets[-1])

    def doc_ids(self) -> np.ndarray:
        """Flattened doc id per nnz entry (COO row of the CSC layout)."""
        return np.repeat(
            np.arange(self.num_docs, dtype=np.int32),
            np.diff(self.offsets).astype(np.int64),
        )

    def doc_sums(self, empty_value: float = 1.0) -> np.ndarray:
        """Per-doc raw count sums in float32 (requires counts). Empty docs
        get `empty_value` (1.0 keeps later divisions harmless)."""
        assert self.counts is not None
        ds = np.full(self.num_docs, np.float32(empty_value), np.float32)
        if self.nnz:
            lengths = np.diff(self.offsets)
            # a boundary-sampled cumsum, exact for integer counts in
            # float64 (reduceat would misplace trailing empty docs)
            cs = np.concatenate(
                [[0.0], np.cumsum(self.counts, dtype=np.float64)]
            )
            s = (cs[self.offsets[1:]] - cs[self.offsets[:-1]]).astype(
                np.float32
            )
            s[lengths == 0] = empty_value
            ds[:] = s
        return ds

    def vals_match(self, expected_fn) -> bool:
        """True when `vals` equals `expected_fn(counts, per-entry
        doc_sums)` bit for bit on every entry: the check before a loader
        rebuilds the values from the raw counts on the device. Checked in
        full: Corpus is a plain dataclass whose vals callers can replace,
        and a sampled check could pass where unsampled entries differ."""
        if self.counts is None or self.nnz == 0:
            return False
        ds = self.doc_sums()
        per_entry = np.repeat(ds, np.diff(self.offsets).astype(np.int64))
        expect = expected_fn(self.counts, per_entry)
        return bool(np.array_equal(
            expect.astype(np.float32), self.vals.astype(np.float32)
        ))

    def normalized_to_one(self) -> "Corpus":
        """The same docs scaled to unit sum, the values that
        from_entries(normalize_to_one=True) gives them (inference's
        input), from the raw counts without a new sort or copy of the
        other arrays (requires counts)."""
        assert self.counts is not None
        per_entry = np.repeat(self.doc_sums(),
                              np.diff(self.offsets).astype(np.int64))
        return dataclasses.replace(
            self, vals=(self.counts / per_entry).astype(np.float32))

    @staticmethod
    def from_entries(
        docs: np.ndarray,
        words: np.ndarray,
        counts: np.ndarray,
        vocab_size: int = 0,
        num_docs: int = 0,
        tf_idf: bool = False,
        normalize_to_one: bool = False,
        sort_dedup: bool = True,
        int_normalized: bool = False,
    ) -> "Corpus":
        """Assemble and normalize (finalize_data -> populate_CSC ->
        normalize_docs, src/trainer.cpp:232-299,
        src/sparseMatrix.cpp:58-167).

        normalize_to_one=False scales each doc to sum avg_doc_sz
        (training); True scales it to unit sum (inference).
        int_normalized=True is USE_INT_NORMALIZED_COUNTS: values become
        ceil(avg_doc_sz * count / doc_sum) (src/sparseMatrix.cpp:149-152),
        stored as float32; incompatible with normalize_to_one.
        """
        docs = np.asarray(docs)
        words = np.asarray(words)
        counts = np.asarray(counts)
        if sort_dedup:
            docs, words, counts = native.sort_dedup_entries(
                docs, words, counts)

        if num_docs == 0:
            num_docs = int(docs[-1]) + 1 if len(docs) else 0
        if vocab_size == 0:
            vocab_size = int(words.max()) + 1 if len(words) else 0

        if tf_idf:
            # The reference's tf-idf loop iterates the entries BY VALUE
            # (src/trainer.cpp:274-275), so upstream the flag changes
            # nothing. This is the intended transform, count <-
            # ceil(idf[word] * count), idf = log(num_docs / doc_freq), as
            # isle_tpu implements it; bit-parity runs keep tf_idf=False.
            df = np.bincount(words, minlength=vocab_size).astype(np.float32)
            with np.errstate(divide="ignore"):
                idf = np.log(np.float32(num_docs) / df)
            counts = np.ceil(idf[words] * counts.astype(np.float32)).astype(
                counts.dtype)

        nnz = len(docs)
        offsets = np.zeros(num_docs + 1, dtype=np.int64)
        np.add.at(offsets, docs.astype(np.int64) + 1, 1)
        offsets = np.cumsum(offsets)
        assert offsets[-1] == nnz

        fcounts = counts.astype(np.float32)
        doc_sums = np.zeros(num_docs, dtype=np.float32)
        # per-doc sums by a boundary-sampled cumsum (exact for integer
        # counts in float64; reduceat would misplace trailing empty docs)
        if nnz:
            cs = np.concatenate([[0.0], np.cumsum(counts, dtype=np.float64)])
            doc_sums = (cs[offsets[1:]] - cs[offsets[:-1]]).astype(
                np.float32)

        nz_docs = int((np.diff(offsets) > 0).sum())
        total = int(counts.astype(np.uint64).sum()) if not tf_idf else int(
            fcounts.sum())
        avg_doc_sz = float(np.float32(total // max(nz_docs, 1)))

        per_entry_sum = np.repeat(doc_sums, np.diff(offsets).astype(np.int64))
        if int_normalized:
            assert not normalize_to_one, (
                "USE_INT_NORMALIZED_COUNTS is a training-side count_t "
                "build; unit-mass normalization asserts in the reference "
                "(src/sparseMatrix.cpp:150)"
            )
            vals = np.ceil(
                np.float32(avg_doc_sz) * fcounts / per_entry_sum
            ).astype(np.float32)
        elif normalize_to_one:
            # val / doc_sum (src/sparseMatrix.cpp:157-158)
            vals = (fcounts / per_entry_sum).astype(np.float32)
        else:
            # avg_doc_sz * (val / doc_sum), the division first in float32
            # (src/sparseMatrix.cpp:158-159)
            vals = (np.float32(avg_doc_sz)
                    * (fcounts / per_entry_sum)).astype(np.float32)

        return Corpus(
            vocab_size=vocab_size,
            num_docs=num_docs,
            offsets=offsets,
            rows=words.astype(np.int32),
            counts=fcounts,
            vals=vals,
            avg_doc_sz=avg_doc_sz,
            nz_docs=nz_docs,
        )

    @staticmethod
    def from_tdf_file(
        path: str,
        vocab_size: int = 0,
        num_docs: int = 0,
        max_entries: Optional[int] = None,
        tf_idf: bool = False,
        normalize_to_one: bool = False,
        doc_base_offset: int = 0,
        int_normalized: bool = False,
    ) -> "Corpus":
        docs, words, counts = read_tdf_entries(path, max_entries)
        if doc_base_offset:
            docs = docs - doc_base_offset
        return Corpus.from_entries(
            docs, words, counts, vocab_size=vocab_size, num_docs=num_docs,
            tf_idf=tf_idf, normalize_to_one=normalize_to_one,
            int_normalized=int_normalized,
        )


class EntryFeeder:
    """Iterative ingest, the C-API feed path
    (drivers/trainer_export.cpp:48-57 -> src/trainer.cpp:214-228). Words
    arrive 1-based, as in feed_data."""

    def __init__(self) -> None:
        self._docs: List[np.ndarray] = []
        self._words: List[np.ndarray] = []
        self._counts: List[np.ndarray] = []

    def feed(self, doc: int, words: np.ndarray, counts: np.ndarray) -> None:
        n = len(words)
        self._docs.append(np.full(n, doc, dtype=np.int64))
        self._words.append(np.asarray(words, dtype=np.int64) - 1)
        self._counts.append(np.asarray(counts))

    def finalize(
        self, vocab_size: int = 0, num_docs: int = 0, tf_idf: bool = False,
        int_normalized: bool = False,
    ) -> Corpus:
        def cat(parts):
            return np.concatenate(parts) if parts else np.zeros(0, np.int64)

        return Corpus.from_entries(
            cat(self._docs), cat(self._words), cat(self._counts),
            vocab_size=vocab_size, num_docs=num_docs, tf_idf=tf_idf,
            int_normalized=int_normalized,
        )


def read_vocab_file(path: str, vocab_size: int) -> List[str]:
    """Word list, one word per line (src/utils.cpp:6-26); missing words
    are named word_<1-based id>."""
    words: List[str] = []
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                words.append(line.strip())
                if len(words) >= vocab_size:
                    break
    except OSError:
        pass
    while len(words) < vocab_size:
        words.append(f"word_{len(words) + 1}")
    return words
