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
import time
from typing import Callable, List, Optional, Tuple

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


DOC_BLOCK = 1 << 16  # docs the assembly normalizes at a time


def _doc_sums(counts: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
              total: int) -> np.ndarray:
    """Per-doc sums of the counts in float32, bit-equal to isle_tpu's
    float64 cumsum sampled at the doc boundaries. Where that cumsum is
    exact (integer counts, none negative, `total` their uint64 sum below
    2^53), each doc's integer sum, one np.add.reduceat over the non-empty
    docs (no array of the entries' size); else the cumsum itself."""
    sums = np.zeros(len(lengths), np.int64)
    if not len(counts):
        return sums.astype(np.float32)
    if counts.dtype.kind in "iu" and total < 2**53 and counts.min() >= 0:
        nz = lengths > 0
        sums[nz] = np.add.reduceat(counts, offsets[:-1][nz])
        return sums.astype(np.float64).astype(np.float32)
    cs = np.concatenate([[0.0], np.cumsum(counts, dtype=np.float64)])
    return (cs[offsets[1:]] - cs[offsets[:-1]]).astype(np.float32)


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
        entries = [np.asarray(docs), np.asarray(words), np.asarray(counts)]
        if sort_dedup:
            entries = list(native.sort_dedup_entries(*entries))
        return Corpus._assemble(entries, vocab_size, num_docs, tf_idf,
                                normalize_to_one, int_normalized,
                                doc_sorted=sort_dedup)

    @staticmethod
    def _assemble(entries: list, vocab_size: int, num_docs: int,
                  tf_idf: bool, normalize_to_one: bool,
                  int_normalized: bool, doc_sorted: bool) -> "Corpus":
        """from_entries' assembly of [docs, words, counts], a list it
        empties so that each array goes as soon as it has been read (the
        caller keeps no other reference where host memory counts): the
        offsets from the docs, the rows from the words, then the values
        from the counts, in as few full-size temporaries as the results
        allow, each bit-equal to isle_tpu's. doc_sorted: the docs are
        known to be in ascending order (else they are checked)."""
        docs, words, counts = entries
        entries.clear()
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
        if nnz and 0 <= docs[0] and docs[-1] < num_docs and (
                doc_sorted or bool((docs[1:] >= docs[:-1]).all())):
            # doc-sorted: each offset is where its doc starts
            offsets = np.searchsorted(docs, np.arange(num_docs + 1))
        else:
            offsets = np.zeros(num_docs + 1, dtype=np.int64)
            np.add.at(offsets, docs.astype(np.int64) + 1, 1)
            offsets = np.cumsum(offsets)
        assert offsets[-1] == nnz
        del docs
        rows = words.astype(np.int32)
        del words

        fcounts = counts.astype(np.float32)
        lengths = np.diff(offsets)
        nz_docs = int(np.count_nonzero(lengths))
        total = int(counts.sum(dtype=np.uint64))
        doc_sums = _doc_sums(counts, offsets, lengths, total)
        if tf_idf:
            total = int(fcounts.sum())
        del counts
        avg_doc_sz = float(np.float32(total // max(nz_docs, 1)))

        assert not (int_normalized and normalize_to_one), (
            "USE_INT_NORMALIZED_COUNTS is a training-side count_t build; "
            "unit-mass normalization asserts in the reference "
            "(src/sparseMatrix.cpp:150)")
        avg = np.float32(avg_doc_sz)
        vals = np.empty(nnz, np.float32)
        # a block of docs at a time, each entry over its doc's sum
        for da in range(0, num_docs, DOC_BLOCK):
            db = min(da + DOC_BLOCK, num_docs)
            a, b = offsets[da], offsets[db]
            per_entry_sum = np.repeat(doc_sums[da:db], lengths[da:db])
            part, out = fcounts[a:b], vals[a:b]
            if int_normalized:
                # ceil(avg_doc_sz * count / doc_sum)
                # (src/sparseMatrix.cpp:149-152)
                out[:] = np.ceil(avg * part / per_entry_sum)
            else:
                # val / doc_sum (src/sparseMatrix.cpp:157-158), in float32
                np.divide(part, per_entry_sum, out=out)
                if not normalize_to_one:
                    # avg_doc_sz * (val / doc_sum), the division first
                    # (src/sparseMatrix.cpp:158-159)
                    np.multiply(avg, out, out=out)

        return Corpus(
            vocab_size=vocab_size,
            num_docs=num_docs,
            offsets=offsets,
            rows=rows,
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
        log: Optional[Callable[[str], None]] = None,
    ) -> "Corpus":
        """from_entries of a TDF file's entries, which this process owns:
        the ids are rebased and the entries sorted in place, and each
        array is let go as soon as the assembly has read it. `log`, where
        given, gets one line: the parse, sort and assembly seconds and
        the sort's path."""
        t0 = time.perf_counter()
        entries = list(read_tdf_entries(path, max_entries))
        if doc_base_offset:
            entries[0] -= doc_base_offset
        t1 = time.perf_counter()
        path_taken = []
        entries = list(native.sort_dedup_entries(
            *entries, overwrite=True, log=path_taken.append))
        t2 = time.perf_counter()
        out = Corpus._assemble(entries, vocab_size, num_docs, tf_idf,
                               normalize_to_one, int_normalized,
                               doc_sorted=True)
        if log is not None:
            log(f"ingest: text I/O {native.backend()}, parse {t1 - t0:.2f} "
                f"s, sort {t2 - t1:.2f} s, assembly "
                f"{time.perf_counter() - t2:.2f} s; sort {path_taken[0]}")
        return out


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
