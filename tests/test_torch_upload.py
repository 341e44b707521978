"""The in-core upload (sparse.DocSparse.from_corpus): the corpus's CSC
arrays cross as they are and each entry's doc id is made from the
offsets, bit-equal to the COO upload (from_doc_sorted) of the host's
doc ids; and the pinned staging's host side (staging.upload by entry
ranges, which may split a doc), which runs on the CPU without pinning.
The staged copies themselves are held on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from isle_tpu_torch import obs, staging
from isle_tpu_torch.corpus import Corpus
from isle_tpu_torch.sparse import DocSparse, doc_ids_from_offsets
from torch_cases import csc_corpus

FIELDS = ("d_word", "d_doc", "d_val", "w_word", "w_doc", "w_val")

# doc lengths of each case: empty docs first, last and in runs; one doc;
# a doc longer than the chunk caps below; no entry at all
LENGTHS = {
    "empty_first": [0, 0, 5, 3, 7, 1],
    "empty_last": [4, 9, 2, 0, 0],
    "empty_runs": [3, 0, 0, 0, 6, 0, 2, 0, 0, 8, 1],
    "one_doc": [23],
    "long_doc": [2, 61, 3, 0, 40, 1],
    "no_entries": [0, 0, 0],
}


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_from_corpus_is_bit_equal_to_the_coo_upload(case):
    corpus = csc_corpus(LENGTHS[case])
    got = DocSparse.from_corpus(corpus, "cpu")
    ref = DocSparse.from_doc_sorted(corpus.rows, corpus.doc_ids(),
                                    corpus.vals, corpus.vocab_size,
                                    corpus.num_docs, "cpu")
    for f in FIELDS:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert (got.vocab, got.num_docs) == (ref.vocab, ref.num_docs)


def test_from_corpus_never_asks_the_corpus_for_its_doc_ids(monkeypatch):
    """The doc ids are made from the offsets, not by the host's repeat
    over every entry."""
    corpus = csc_corpus(LENGTHS["empty_runs"])

    def refuse(self):
        raise AssertionError("from_corpus called corpus.doc_ids()")

    monkeypatch.setattr(Corpus, "doc_ids", refuse)
    sp = DocSparse.from_corpus(corpus, "cpu")
    assert sp.nnz == corpus.nnz


def test_the_upload_counts_what_it_reads_from_the_host():
    """rows, vals and offsets: 8 bytes an entry and 8 a doc and one; on
    the CPU nothing goes through the staging."""
    corpus = csc_corpus(LENGTHS["long_doc"])
    t = obs.Timer()
    DocSparse.from_corpus(corpus, "cpu", timer=t)
    assert t.counters["upload bytes"] == (8 * corpus.nnz
                                          + 8 * (corpus.num_docs + 1))
    assert "upload staged bytes" not in t.counters
    assert {"upload: copy to device", "upload: doc ids",
            "upload: word-order sort"} <= {n for n, *_ in t.spans}


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_doc_ids_from_offsets_are_the_corpus_doc_ids(case):
    """Over the whole corpus and over doc ranges (global ids), as a
    loader takes them."""
    corpus = csc_corpus(LENGTHS[case])
    D, off = corpus.num_docs, corpus.offsets
    for lo, hi in [(0, D), (min(1, D), D), (D // 3, max(D // 3, D - 1))]:
        a, b = int(off[lo]), int(off[hi])
        got = doc_ids_from_offsets(torch.from_numpy(off[lo:hi + 1]), lo,
                                   b - a)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), corpus.doc_ids()[a:b])


@pytest.mark.parametrize("cap", [1, 4, 7, 16, 1000])
@pytest.mark.parametrize("case", ["empty_runs", "long_doc"])
def test_staged_upload_by_entry_ranges_splits_docs(case, cap):
    """staging.upload's host side: every entry range through the two
    slots into its slice of the destination, the last range short, a
    range that ends inside a doc (the largest doc longer than the cap)
    allowed; the bytes staged are 8 an entry for word ids and values."""
    corpus = csc_corpus(LENGTHS[case])
    n = corpus.nnz
    splits = [a for a in range(cap, n, cap) if a not in set(corpus.offsets)]
    if cap < max(np.diff(corpus.offsets)):
        assert splits  # some range boundary falls inside a doc
    rows = torch.from_numpy(corpus.rows)
    vals = torch.from_numpy(corpus.vals)
    dw = torch.full((n,), -1, dtype=torch.int32)
    dv = torch.full((n,), -1.0, dtype=torch.float32)
    assert staging.upload((rows, vals), (dw, dv), cap) == 8 * n
    assert torch.equal(dw, rows) and torch.equal(dv, vals)


def test_staging_alternates_its_slots_and_refuses_a_long_copy():
    st = staging.Staging(4, (torch.int32,), "cpu", own=True)
    src = torch.arange(9, dtype=torch.int32)
    s0, w0 = st.stage((src[:4],))
    s1, _ = st.stage((src[4:7],))
    s2, _ = st.stage((src[7:],))
    assert s0 is s2 and s0 is not s1 and w0 >= 0.0
    assert s0.dev[0][:2].tolist() == [7, 8]
    assert s1.dev[0][:3].tolist() == [4, 5, 6]
    with pytest.raises(ValueError, match="more than a slot holds"):
        st.stage((src[:5],))
