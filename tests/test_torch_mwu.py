"""The port's MWU inference (isle_tpu_torch.mwu) against isle_tpu.mwu on
the CPU, on corpora and models made with numpy from a seed.

Convergence flags must be equal exactly; weights and both LLH arrays
within rtol 1e-4, atol 1e-6 (the contractions sum float32 in another
order). isle_tpu takes its compact-upload path whenever the counts allow
it; that path rebuilds the same float32 `a`, so it is the reference as
it stands."""

import numpy as np
import pytest
import torch

from isle_tpu import mwu as jmwu
from isle_tpu.corpus import Corpus
from isle_tpu_torch import mwu

RTOL, ATOL = 1e-4, 1e-6


def make_model(rng, V, k):
    """Column-normalized, half zeros, word 0 with no mass (dropped)."""
    M = rng.random((V, k)).astype(np.float32)
    M[M < 0.5] = 0.0
    M[0] = 0.0
    M /= np.maximum(M.sum(axis=0, keepdims=True), 1e-9)
    return M


def make_corpus(rng, V, lengths):
    docs, words, counts = [], [], []
    for d, n in enumerate(lengths):
        ws = np.sort(rng.choice(V, size=min(n, V), replace=False))
        docs += [d] * len(ws)
        words += ws.tolist()
        counts += rng.integers(1, 7, len(ws)).tolist()
    return Corpus.from_entries(
        np.array(docs, np.int64), np.array(words, np.int64),
        np.array(counts, np.int64), vocab_size=V, num_docs=len(lengths),
        normalize_to_one=True,
    )


def _case(name, seed):
    """(model, corpus, infer_all keyword arguments) of one named case."""
    rng = np.random.default_rng(seed)
    if name == "uniform":
        V, k = 60, 6
        return (make_model(rng, V, k),
                make_corpus(rng, V, rng.integers(2, 12, 40)), {})
    if name == "skewed":  # lengths across several fine buckets
        V, k = 700, 5
        lengths = [1, 3, 30, 64, 65, 120, 150, 200, 350, 600]
        return make_model(rng, V, k), make_corpus(rng, V, lengths), {}
    if name == "small_blocks":
        V, k = 50, 4
        return (make_model(rng, V, k),
                make_corpus(rng, V, rng.integers(2, 9, 37)),
                dict(block_size=4))
    if name == "top_n":
        V, k = 80, 8
        return (make_model(rng, V, k),
                make_corpus(rng, V, rng.integers(3, 15, 30)),
                dict(top_n=5))
    if name == "lf_retry":  # Lf so small that exp overflows: retries
        V, k = 60, 6
        return (make_model(rng, V, k),
                make_corpus(rng, V, rng.integers(4, 12, 40)),
                dict(Lf=1e-3))
    raise KeyError(name)


def _both(M, corpus, **kw):
    kw = {"iters": 15, "Lf": 10.0, **kw}
    ref = jmwu.infer_all(M, jmwu.build_infer_batch(corpus, M.sum(axis=1)),
                         **kw)
    got = mwu.infer_all(M, mwu.build_infer_batch(corpus, M.sum(axis=1)),
                        device="cpu", **kw)
    return got, ref


def _assert_same(got, ref):
    np.testing.assert_array_equal(got[1], ref[1])
    for g, r in zip((got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["uniform", "skewed", "small_blocks",
                                  "top_n", "lf_retry"])
def test_infer_all_matches_jax(name, seed):
    M, corpus, kw = _case(name, seed)
    got, ref = _both(M, corpus, **kw)
    _assert_same(got, ref)
    conv = got[1]
    if name == "lf_retry":
        # some docs settle only after Lf doublings, some never
        assert 0 < conv.sum() < corpus.num_docs
        assert conv.sum() > _both(M, corpus, Lf=1e-3, max_guesses=1)[0][
            1].sum()
    else:  # a one-word doc may hold only words without model mass
        assert conv.mean() > 0.85
    if name == "top_n":
        assert ((got[0] > 0).sum(axis=1) == 5).all()


def _with_empty_docs(seed):
    """A model half of whose words have no mass and a corpus whose first,
    middle and last docs are empty, with docs that keep no word."""
    rng = np.random.default_rng(seed)
    V, k = 90, 4
    M = make_model(rng, V, k)
    M[rng.random(V) < 0.5] = 0.0
    lengths = rng.integers(1, 40, 60)
    lengths[[0, 30, 59]] = 0
    return M, make_corpus(rng, V, lengths)


@pytest.mark.parametrize("case", ["skewed", "empty docs"])
def test_build_infer_batch_matches_jax(case):
    """The packed arrays equal isle_tpu's: each doc's kept words fill its
    row from the start, in order, and pads stay V and 0."""
    if case == "skewed":
        M, corpus, _ = _case("skewed", 4)
    else:
        M, corpus = _with_empty_docs(6)
        assert (np.diff(corpus.offsets) == 0).sum() == 3
    got = mwu.build_infer_batch(corpus, M.sum(axis=1))
    ref = jmwu.build_infer_batch(corpus, M.sum(axis=1))
    np.testing.assert_array_equal(got.word_idx, ref.word_idx)
    np.testing.assert_array_equal(got.a, ref.a)
    np.testing.assert_array_equal(got.words_in_doc, ref.words_in_doc)
    assert got.avg_doc_sz == ref.avg_doc_sz and got.num_docs == ref.num_docs
    assert got.word_idx.shape[1] % 8 == 0


def test_small_blocks_equal_one_block():
    M, corpus, _ = _case("small_blocks", 5)
    batch = mwu.build_infer_batch(corpus, M.sum(axis=1))
    one = mwu.infer_all(M, batch, 15, 10.0, device="cpu")
    small = mwu.infer_all(M, batch, 15, 10.0, block_size=4, device="cpu")
    np.testing.assert_array_equal(one[1], small[1])
    for a, b in zip(one, small):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_empty_doc_is_unconverged():
    """Doc 1 has no entries and doc 2 only a word without model mass."""
    V, k = 5, 3
    M = np.full((V, k), 0.2, np.float32)
    M[4] = 0.0
    corpus = Corpus.from_entries(
        np.array([0, 0, 2]), np.array([1, 2, 4]), np.array([4, 1, 3]),
        vocab_size=V, num_docs=3, normalize_to_one=True,
    )
    got, ref = _both(M, corpus)
    _assert_same(got, ref)
    weights, conv, llh_doc, llh_w = got
    assert conv.tolist() == [True, False, False]
    assert (llh_doc[1:] == 0).all() and (llh_w[1:] == 0).all()
    assert (weights[1:] == np.float32(1.0 / k)).all()


def test_top_n_ties_break_to_the_lowest_index():
    """Two identical model columns give exactly equal weights: the top-n
    report keeps the lower topic first, as jax.lax.top_k does."""
    rng = np.random.default_rng(6)
    V, k = 40, 6
    M = make_model(rng, V, k)
    M[:, 4] = M[:, 1]
    corpus = make_corpus(rng, V, rng.integers(4, 12, 25))
    got, ref = _both(M, corpus, top_n=2)
    _assert_same(got, ref)
    full = mwu.infer_all(M, mwu.build_infer_batch(corpus, M.sum(axis=1)),
                         15, 10.0, device="cpu")[0]
    assert (full[:, 1] == full[:, 4]).all()
    w = torch.tensor([[0.1, 0.3, 0.2, 0.3, 0.1]])
    vals, idx = mwu.top_n_rows(w, 3)
    assert idx.tolist() == [[1, 3, 2]] and vals[0, 0] == vals[0, 1]


def test_core_runs_in_float64():
    """The float64 plain core (the card's reference in chip_smoke.py)
    agrees with float32 on a well-conditioned case."""
    M, corpus, _ = _case("uniform", 7)
    batch = mwu.build_infer_batch(corpus, M.sum(axis=1))
    k = M.shape[1]
    out = {}
    for dt in (torch.float32, torch.float64):
        Mw = torch.cat([torch.as_tensor(M, dtype=dt), torch.zeros(1, k,
                                                                  dtype=dt)])
        out[dt] = mwu.mwu_core(Mw, torch.from_numpy(batch.word_idx),
                               torch.from_numpy(batch.a).to(dt), 15, 10.0, 10)
    w32, c32, s32 = out[torch.float32]
    w64, c64, s64 = out[torch.float64]
    assert torch.equal(c32, c64) and w64.dtype == torch.float64
    np.testing.assert_allclose(w32.numpy(), w64.numpy(), atol=1e-5)
    np.testing.assert_allclose(s32.numpy(), s64.numpy(), rtol=1e-4)
