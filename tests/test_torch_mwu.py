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
from isle_tpu_torch import mwu, pack

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


def _at_the_threshold(seed):
    """Words whose mass is exactly float32(1e-10) (dropped: the keep test
    is `> 1e-10`) and the next float32 above it (kept), in every doc."""
    rng = np.random.default_rng(seed)
    V, k = 120, 4
    M = make_model(rng, V, k)
    M[10:20] = 0.0
    M[10:15, 0] = np.float32(1e-10)
    M[15:20, 1] = np.nextafter(np.float32(1e-10), np.float32(1.0))
    corpus = make_corpus(rng, V, rng.integers(1, 30, 50))
    d, w = corpus.doc_ids(), corpus.rows
    extra = np.arange(10, 20)
    corpus = Corpus.from_entries(
        np.concatenate([d, np.repeat(np.arange(50), 10)]),
        np.concatenate([w, np.tile(extra, 50)]),
        np.concatenate([rng.integers(1, 7, len(w)), np.ones(500, int)]),
        vocab_size=V, num_docs=50, normalize_to_one=True)
    return M, corpus


def _all_dropped(seed):
    """Docs (the first, one in the middle, the last) that hold only words
    without model mass, beside docs that keep some."""
    rng = np.random.default_rng(seed)
    V, k = 80, 5
    M = make_model(rng, V, k)
    M[:20] = 0.0
    lengths = rng.integers(1, 25, 30)
    docs, words = [], []
    for doc, n in enumerate(lengths):
        pool = 20 if doc in (0, 15, 29) else V
        ws = np.sort(rng.choice(pool, size=min(n, pool), replace=False))
        docs += [doc] * len(ws)
        words += ws.tolist()
    corpus = Corpus.from_entries(
        np.array(docs), np.array(words), rng.integers(1, 7, len(words)),
        vocab_size=V, num_docs=30, normalize_to_one=True)
    return M, corpus


@pytest.mark.parametrize("case", ["skewed", "empty docs", "threshold word",
                                  "all dropped doc"])
def test_build_infer_batch_matches_jax(case):
    """The packed arrays equal isle_tpu's: each doc's kept words fill its
    row from the start, in order, and pads stay V and 0. So do those of
    the device pack's plain PyTorch version (pack_on_device on the CPU,
    its bucket rows widened to (D, L)), and both packs' kept lengths."""
    if case == "skewed":
        M, corpus, _ = _case("skewed", 4)
    elif case == "empty docs":
        M, corpus = _with_empty_docs(6)
        assert (np.diff(corpus.offsets) == 0).sum() == 3
    elif case == "threshold word":
        M, corpus = _at_the_threshold(8)
    else:
        M, corpus = _all_dropped(9)
    got = mwu.build_infer_batch(corpus, M.sum(axis=1))
    ref = jmwu.build_infer_batch(corpus, M.sum(axis=1))
    np.testing.assert_array_equal(got.word_idx, ref.word_idx)
    np.testing.assert_array_equal(got.a, ref.a)
    np.testing.assert_array_equal(got.words_in_doc, ref.words_in_doc)
    assert got.avg_doc_sz == ref.avg_doc_sz and got.num_docs == ref.num_docs
    assert got.word_idx.shape[1] % 8 == 0
    kept = (ref.word_idx < corpus.vocab_size).sum(axis=1)
    np.testing.assert_array_equal(got.kept_len, kept)
    plain = mwu.pack_on_device(corpus, M.sum(axis=1), "cpu")
    wi, av = mwu.padded_rows(plain, corpus.vocab_size)
    np.testing.assert_array_equal(wi, ref.word_idx)
    np.testing.assert_array_equal(av, ref.a)
    np.testing.assert_array_equal(plain.kept_len, kept)
    assert plain.width == got.word_idx.shape[1]
    # the device layout: each bucket's rows at its width, nothing more
    assert plain.word_idx.numel() == sum(
        edge * len(sel)
        for edge, sel in mwu.length_buckets(kept, plain.width))
    np.testing.assert_array_equal(plain.words_in_doc, ref.words_in_doc)
    if case == "threshold word":  # each doc keeps 15..19, drops 10..14
        w = ref.word_idx
        assert not np.isin(w, np.arange(10, 15)).any()
        assert (np.isin(w, np.arange(15, 20)).sum(axis=1) == 5).all()
    if case == "all dropped doc":
        assert kept[[0, 15, 29]].tolist() == [0, 0, 0]
        assert (kept > 0).sum() > 20


def test_infer_all_from_a_device_batch_is_bit_equal():
    """infer_all on a batch of tensors (pack_on_device: its blocks cut by
    an index on the batch's device) gives the same bits as on the host
    batch, with the tail blocks padded, and with top_n."""
    M, corpus, _ = _case("skewed", 5)
    host = mwu.build_infer_batch(corpus, M.sum(axis=1))
    dev = mwu.pack_on_device(corpus, M.sum(axis=1), "cpu")
    assert isinstance(dev.word_idx, torch.Tensor)
    for kw in (dict(), dict(block_size=3, top_n=2)):
        a = mwu.infer_all(M, host, 15, 10.0, device="cpu", **kw)
        b = mwu.infer_all(M, dev, 15, 10.0, device="cpu", **kw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_pack_refuses_a_keep_table_past_shared_memory():
    """Each block of the pack kernels holds the keep table in shared
    memory: the wrappers raise, on every device, where the table is more
    than a block's 227 KB, and take the largest vocabulary that fits."""
    off = torch.zeros(2, dtype=torch.int64)
    rows = torch.zeros(0, dtype=torch.int32)
    most = 8 * pack.TABLE_BYTES_MAX
    for V in (most, most + 1):
        table = torch.from_numpy(pack.keep_table(np.ones(V, np.float32)))
        if V == most:
            assert pack.pack_kept_lengths(off, rows, table, V).tolist() == [0]
            wi, a = pack.pack_fill(off, rows, rows.float(), table, V,
                                   torch.zeros(1, dtype=torch.int64),
                                   torch.full((1,), 8, dtype=torch.int32), 8)
            assert (wi == V).all() and (a == 0).all()
        else:
            with pytest.raises(ValueError, match="shared memory"):
                pack.pack_kept_lengths(off, rows, table, V)


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
