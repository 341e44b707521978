"""isle_tpu_torch.hybrid (the dense-head / sparse-tail layout) and
matops against isle_tpu.hybrid, isle_tpu.matops and isle_tpu.elkans.

Both sides take the same corpus and the same ζ (isle_tpu's). The layouts
must be equal exactly: the head words (ties across the head's edge
included), the head's occupancy, head_nnz, nnz, original_cols and the
multiset of tail (word, doc) entries with their values; isle_tpu's tail
is read through h_to_doc_sparse_vals with its pads dropped. Products
within rtol 1e-5, with an atol of 1e-6 of the product's largest value
for the elements whose sum cancels to near zero: isle_tpu's CPU backend
computes its mixed bf16 x f32 dot exactly, the port's plain head
product in float32, and the tails sum in other orders. The head
product's split GEMM (the card's route) is held to its algebra here on
the CPU, with a float64 product standing in for the tensor cores."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isle_tpu import elkans as jel
from isle_tpu import hybrid as jhy
from isle_tpu import matops as jmo
from isle_tpu import sparse as jsp
from isle_tpu import thresholds as jth
from isle_tpu.config import HyperParams
from isle_tpu_torch import elkans, hybrid, matops, sparse
from torch_parity import HEAD_BYTES, biting_corpus, golden_corpus

CHUNK = 256
TOL = dict(rtol=1e-5, atol=1e-5)
CORPORA = {"golden": golden_corpus, "biting": biting_corpus}


def _inputs(name, drop=False):
    """(isle_tpu's A, the port's A, ζ as numpy) of one corpus at k = 4."""
    corpus = CORPORA[name]()
    J = jsp.DocSparse.from_corpus(corpus, chunk=CHUNK)
    A = sparse.DocSparse.from_numpy(
        *(np.asarray(a) for a in (J.d_word, J.d_doc, J.d_val, J.w_word,
                                  J.w_doc, J.w_val)),
        J.vocab, J.num_docs, "cpu")
    hp = HyperParams(few_samples_threshold_drop=drop, bad_threshold_drop=drop)
    z, _ = jth.compute_thresholds_jax(J.d_word, J.d_val, J.vocab,
                                      corpus.avg_doc_sz, corpus.nz_docs, 4,
                                      hp)
    return J, A, np.array(z)


def _both(name, budget, drop=False, sample=None):
    """isle_tpu's and the port's hybrid_from_thresholds on one corpus.
    With `sample` both sample docs at that rate from the uniforms of one
    key. Returns (ref, original_cols, frob), (got, original_cols, frob)."""
    J, A, z = _inputs(name, drop)
    kw, pkw = {}, {}
    if sample is not None:
        key = jax.random.PRNGKey(7)
        kw = dict(sample_rate=sample, key=key)
        pkw = dict(sample_rate=sample, uniforms=torch.from_numpy(np.array(
            jax.random.uniform(key, (A.num_docs,), jnp.float32))))
    ref = jhy.hybrid_from_thresholds(J, jnp.asarray(z), budget, chunk=CHUNK,
                                     **kw)
    got = hybrid.hybrid_from_thresholds(A, torch.from_numpy(z), budget,
                                        **pkw)
    return ref, got


def _ref_tail(h):
    """isle_tpu's tail as (word, doc, val) entries, pads dropped."""
    w, d, v = (np.asarray(a) for a in jhy.h_to_doc_sparse_vals(h))
    keep = w < h.vocab
    return w[keep], d[keep], v[keep]


def _sorted_entries(w, d, v):
    order = np.lexsort((d, w))
    return w[order], d[order], v[order]


def assert_same_layout(ref, got):
    """Every part of two hybrid layouts, exactly."""
    (h, ref_cols, ref_frob), (g, cols, frob) = ref, got
    np.testing.assert_array_equal(cols, ref_cols)
    np.testing.assert_allclose(frob, ref_frob, rtol=1e-6)
    assert (g.vocab, g.num_docs) == (h.vocab, h.num_docs)
    np.testing.assert_array_equal(g.head_words.numpy(),
                                  np.asarray(h.head_words))
    assert g.head.dtype == torch.bfloat16
    np.testing.assert_array_equal(g.head.float().numpy() != 0,
                                  np.asarray(h.head, np.float32) != 0)
    assert set(np.unique(g.head.float().numpy())) <= {0.0, 1.0}
    assert (g.head_nnz, g.nnz) == (h.head_nnz, h.nnz)
    np.testing.assert_array_equal(g.row_scale.numpy(),
                                  np.asarray(h.row_scale))
    t = g.tail
    ref_entries = _sorted_entries(*_ref_tail(h))
    for got_e, ref_e in zip(_sorted_entries(t.d_word.numpy(), t.d_doc.numpy(),
                                            t.d_val.numpy()), ref_entries):
        np.testing.assert_array_equal(got_e, ref_e)
    # the word-sorted stream holds the same entries, sorted by (word, doc)
    for got_e, ref_e in zip((t.w_word.numpy(), t.w_doc.numpy(),
                             t.w_val.numpy()), ref_entries):
        np.testing.assert_array_equal(got_e, ref_e)
    assert np.all(np.diff(t.d_doc.numpy()) >= 0)


def _rows(n, W, seed):
    return np.random.default_rng(seed).standard_normal((n, W)).astype(
        np.float32)


def assert_same_products(h, g, W=6):
    """B^T X, B Y, the Gram operator, the doc norms and the flops."""
    X, Y = _rows(h.vocab, W, 0), _rows(h.num_docs, W, 1)
    for got, ref in (
        (matops.mat_bt_x(g, torch.from_numpy(X), 64),
         jmo.mat_bt_x(h, jnp.asarray(X), CHUNK)),
        (matops.mat_b_y(g, torch.from_numpy(Y), 64),
         jmo.mat_b_y(h, jnp.asarray(Y), CHUNK)),
        (matops.mat_gram_x(g, torch.from_numpy(X)),
         jmo.mat_gram_x(h, jnp.asarray(X), CHUNK)),
        (matops.mat_doc_l2sq(g), jmo.mat_doc_l2sq(h, CHUNK)),
    ):
        assert got.dtype == torch.float32
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())
    assert matops.mat_spmm_flops(g, W) == jmo.mat_spmm_flops(h, W)
    np.testing.assert_allclose(matops.mat_to_dense(g), jmo.mat_to_dense(h),
                               rtol=0, atol=0)


# (corpus, budget) of a partial head: 48 of golden's 400 words, 30 of
# biting's 200 (whose thresholds drop docs, so nz_docs < num_docs)
PARTIAL = [("golden", HEAD_BYTES), ("biting", HEAD_BYTES)]


@pytest.mark.parametrize("name,budget", PARTIAL)
def test_partial_head_layout_and_products(name, budget):
    ref, got = _both(name, budget)
    assert 8 < got[0].num_head < got[0].vocab
    assert 0 < got[0].head_nnz < got[0].nnz
    assert_same_layout(ref, got)
    assert_same_products(ref[0], got[0])


def test_head_budget_counts_every_doc_of_a_without_sampling():
    """Unsampled, the head's rows come from A.num_docs, not from the docs
    B keeps (isle_tpu/hybrid.py:803): at a budget where the two rules
    differ, the head has A's count of rows."""
    _, A, z = _inputs("biting")
    nz = len(hybrid.threshold_and_copy(A, torch.from_numpy(z))[1])
    assert nz < A.num_docs
    budget = 30 * 2 * nz
    want = budget // (2 * A.num_docs)
    assert want < budget // (2 * nz) == 30
    ref, got = _both("biting", budget)
    assert got[0].num_head == want
    assert_same_layout(ref, got)


def test_tied_counts_across_the_head_edge():
    """The head's last row and the first word left out have the same
    count: the lower word id goes in, as jax.lax.top_k has it."""
    _, A, z = _inputs("golden")
    B, _ = hybrid.threshold_and_copy(A, torch.from_numpy(z))
    counts = np.sort(hybrid.word_counts(B).numpy())[::-1]
    R = next(r for r in range(9, len(counts)) if counts[r - 1] == counts[r])
    budget = R * 2 * A.num_docs
    ref, got = _both("golden", budget)
    g = got[0]
    assert g.num_head == R
    c = hybrid.word_counts(B).numpy()
    inside = np.zeros(len(c), bool)
    inside[g.head_words.numpy()] = True
    edge = c[inside].min()
    assert (c[~inside] == edge).any(), "no tie across the head's edge"
    tied_in = np.flatnonzero(inside & (c == edge))
    tied_out = np.flatnonzero(~inside & (c == edge))
    assert tied_in.max() < tied_out.min()
    assert_same_layout(ref, got)


def test_top_words_breaks_ties_by_word_id():
    counts = torch.tensor([3, 5, 5, 1, 5, 3, 0], dtype=torch.int32)
    assert hybrid.top_words(counts, 2).tolist() == [1, 2]
    assert hybrid.top_words(counts, 4).tolist() == [0, 1, 2, 4]
    assert hybrid.top_words(counts, 7).tolist() == list(range(7))


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_all_head_leaves_an_empty_tail(name):
    """A budget past the vocabulary puts every word in the head: the tail
    is empty and its kernels get no entry."""
    ref, got = _both(name, 1 << 30)
    g = got[0]
    assert g.num_head == g.vocab and g.tail.nnz == 0
    assert g.head_nnz == g.nnz
    assert_same_layout(ref, got)
    assert_same_products(ref[0], g)


def test_dropped_words_have_zero_scale():
    """ζ = +inf (both drop flags): a dropped word keeps no entry, enters
    an all-head layout with row scale 0 and leaves every product finite
    (tests/test_hybrid.py:277's case)."""
    ref, got = _both("biting", 1 << 30, drop=True)
    g = got[0]
    _, _, z = _inputs("biting", drop=True)
    dropped = np.flatnonzero(~np.isfinite(z))
    assert dropped.size and np.isin(dropped, g.head_words.numpy()).all()
    assert (g.row_scale.numpy()[dropped] == 0).all()
    assert np.isfinite(g.row_scale.numpy()).all()
    X = torch.from_numpy(_rows(g.vocab, 4, 2))
    assert torch.isfinite(matops.mat_gram_x(g, X)).all()
    assert_same_layout(ref, got)
    assert_same_products(ref[0], g)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_sampled_layout_budgets_over_the_kept_docs(name):
    """Sampling at rate 0.5 from the uniforms of one key: the same docs,
    and a head budgeted over the docs sampling keeps."""
    ref, got = _both(name, HEAD_BYTES, sample=0.5)
    g = got[0]
    assert g.num_docs < CORPORA[name]().num_docs
    assert g.num_head == min(g.vocab, HEAD_BYTES // (2 * g.num_docs))
    assert_same_layout(ref, got)
    assert_same_products(ref[0], g)


def test_docs_of_a_checkpoint_rebuild_the_sampled_layout():
    """`docs` (a checkpoint's original_cols) in place of the draws: the
    layout of the sampled run, head budget included."""
    _, got = _both("golden", HEAD_BYTES, sample=0.5)
    _, A, z = _inputs("golden")
    again, cols, _ = hybrid.hybrid_from_thresholds(
        A, torch.from_numpy(z), HEAD_BYTES, sample_rate=0.5, docs=got[1])
    np.testing.assert_array_equal(cols, got[1])
    assert torch.equal(again.head_words, got[0].head_words)
    assert torch.equal(again.head, got[0].head)


def test_cap_below_eight_rows_is_refused():
    """The int32 flat-index cap (reached at test size through flat_cap)
    leaves fewer than 8 head rows: both packages refuse."""
    J, A, z = _inputs("golden")
    cap = 5 * (A.num_docs + 1)
    assert hybrid.max_head_rows(A.num_docs, cap) == 4
    with pytest.raises(ValueError, match="max_head_rows=4"):
        jhy.hybrid_from_thresholds(J, jnp.asarray(z), HEAD_BYTES,
                                   chunk=CHUNK, flat_cap=cap)
    with pytest.raises(ValueError, match="max_head_rows=4"):
        hybrid.hybrid_from_thresholds(A, torch.from_numpy(z), HEAD_BYTES,
                                      flat_cap=cap)
    B, _ = hybrid.threshold_and_copy(A, torch.from_numpy(z))
    with pytest.raises(ValueError, match="max_head_rows=4"):
        hybrid.to_hybrid(B, 20, torch.ones(A.vocab), flat_cap=cap)
    # a cap of 9 rows limits the head to them
    cap = 10 * (B.num_docs + 1)
    assert hybrid.to_hybrid(B, 20, torch.ones(A.vocab),
                            flat_cap=cap).num_head == 9


def test_max_head_rows_is_the_references():
    for D in (0, 1, 250, 300_000, 238_000_000, 300_000_000):
        assert hybrid.max_head_rows(D) == jhy.max_head_rows(D)
    assert hybrid.max_head_rows(300_000) == 7153


def test_head_rows_are_aligned_for_the_tensor_cores():
    """The head's rows start at multiples of 8 cells (16 bytes) whatever
    the doc count, so cuBLAS takes it as it is, transposed or not."""
    ref, got = _both("golden", HEAD_BYTES)
    g = got[0]
    assert g.num_docs % 8 != 0
    assert g.head.stride(0) % 8 == 0 and g.head.stride(1) == 1
    assert g.head.stride(0) >= g.num_docs


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_elkans_flagged_dists_match_isle_tpu(name):
    """The exact distances of a set of flagged docs: the tail's mini
    stream plus the flagged docs' head columns (isle_tpu/elkans.py:
    150-158)."""
    (h, _, _), (g, _, _) = _both(name, HEAD_BYTES)
    rng = np.random.default_rng(3)
    D, V, k = g.num_docs, g.vocab, 4
    centers = rng.random((k, V)).astype(np.float32)
    flagged = rng.random(D) < 0.4
    docs_l2 = matops.mat_doc_l2sq(g)
    ids, dist = elkans._flagged_dists(
        g, torch.from_numpy(flagged), torch.from_numpy(centers), docs_l2,
        CHUNK)
    m = int(flagged.sum())
    ref_ids, ref_dist = jel._flagged_dists(
        h, jnp.asarray(flagged), jnp.asarray(centers),
        jnp.asarray(docs_l2.numpy()), m, h.td_word.shape[0])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(dist.numpy(), np.asarray(ref_dist), **TOL)


@pytest.mark.parametrize("algo", ["lloyds", "elkans"])
def test_full_space_kmeans_matches_isle_tpu(algo):
    """Lloyd's and Elkan's on the hybrid layout from the same centers:
    assignments equal, centers within 1e-5."""
    from isle_tpu import kmeans as jkm
    from isle_tpu_torch import kmeans

    (h, _, _), (g, _, _) = _both("biting", HEAD_BYTES)
    centers = np.random.default_rng(4).random((4, g.vocab)).astype(
        np.float32)
    if algo == "lloyds":
        c, a = kmeans.run_lloyds_full(g, torch.from_numpy(centers), 10)
        rc, ra = jkm.run_lloyds_full(h, jnp.asarray(centers), 10,
                                     chunk=CHUNK)
    else:
        c, a = elkans.run_elkans(g, torch.from_numpy(centers), 10)
        rc, ra = jel.run_elkans(h, jnp.asarray(centers), 10, chunk=CHUNK)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), **TOL)


def test_coo_layout_dispatches_to_sparse():
    _, A, _ = _inputs("golden")
    X = torch.from_numpy(_rows(A.vocab, 3, 5))
    assert torch.equal(matops.mat_bt_x(A, X), sparse.bt_x(A, X))
    assert torch.equal(matops.mat_gram_x(A, X), sparse.gram_x(A, X))
    assert matops.mat_spmm_flops(A, 3) == sparse.spmm_flops(A, 3)
    np.testing.assert_array_equal(matops.mat_to_dense(A), sparse.to_dense(A))


# ---------------------------------------------------------------------------
# The head product
# ---------------------------------------------------------------------------


def test_split3_holds_float32_to_its_last_bit():
    """hi + mid + lo gives back random float32 values of every magnitude
    from 1e-30 to 1e38 within 2^-24 relative, each piece bf16."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20_000)
         * 10.0 ** rng.uniform(-30, 38, 20_000)).astype(np.float32)
    x = np.concatenate([x, np.float32([0.0, 1.0, -1.0, 3.0e38, 1.1e-30])])
    pieces = hybrid.split3(torch.from_numpy(x))
    assert all(p.dtype == torch.bfloat16 for p in pieces)
    back = sum(p.double() for p in pieces).numpy()
    err = np.abs(back - x.astype(np.float64))
    assert np.all(err <= 2.0 ** -24 * np.abs(x.astype(np.float64)))
    # two pieces are not enough: the split needs the third
    two = (pieces[0].double() + pieces[1].double()).numpy()
    assert np.max(np.abs(two - x) / np.maximum(np.abs(x), 1e-38)) > 2 ** -20


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("W", [1, 3, 100, 128])
def test_split_gemm_algebra(transpose, W):
    """The card's route, with a float64 product of the bf16 pieces in
    place of the tensor cores' exact partial products: the pieces side
    by side (3W columns padded to a multiple of 8), head Y summed over
    doc blocks, the column blocks added lo + mid, then hi, agree with the
    float64 product within float32 rounding."""
    rng = np.random.default_rng(W)
    R, D = 37, 53
    head = torch.from_numpy(rng.random((R, D)) < 0.3).to(torch.bfloat16)
    other = torch.from_numpy(_rows(D if not transpose else R, W, W + 1)
                             * 10.0 ** rng.uniform(-3, 3))
    widths = []

    def mm(a, b):
        widths.append(b.shape[1])
        return (a.double() @ b.double()).float()

    a = head.T if transpose else head
    if transpose:
        got = hybrid._split_gemm(a, other, mm)
        assert widths == [-(-3 * W // 8) * 8]
    else:  # the docs in blocks of 16, as head_dot sums them
        got = hybrid._split_gemm(a, other, hybrid._in_doc_blocks(mm, 16))
        assert widths == [-(-3 * W // 8) * 8] * 4
    ref = a.double() @ other.double()
    scale = a.double() @ other.double().abs()
    assert torch.all((got.double() - ref).abs() <= 4e-7 * scale + 1e-30)
    plain = hybrid.head_dot_plain(head, other, transpose)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-6 * float(scale.max()))


def test_head_dot_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(1)
    head = torch.from_numpy(rng.random((9, 20)) < 0.5).to(torch.bfloat16)
    X = torch.from_numpy(_rows(9, 4, 2))
    calls = hybrid.head_dot.calls
    assert torch.equal(hybrid.head_dot(head, X, True),
                       hybrid.head_dot_plain(head, X, True))
    assert hybrid.head_dot.calls == calls  # counted on the card only
