"""Each ported module against its isle_tpu function, on the same inputs.

The port runs on the CPU (the plain versions of its kernels); the JAX side
runs its Pallas segment sums in interpret mode with real plans (each test
asserts the plan exists, so isle_tpu did not take its XLA scatter). Both
sides take the same DocSparse: isle_tpu's, handed to the port through
DocSparse.from_numpy. Integer results (ζ, counts, catchword sets, top-two
pairs, k-means seeds and assignments) must be equal; float32 results
within 1e-5, since the two frameworks sum in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isle_tpu import bmatrix as jbm
from isle_tpu import catchwords as jcw
from isle_tpu import kmeans as jkm
from isle_tpu import linalg as jla
from isle_tpu import sparse as jsp
from isle_tpu import thresholds as jth
from isle_tpu import topic_model as jtm
from isle_tpu.config import HyperParams
from isle_tpu.pallas_ops import plan_segments
from isle_tpu_torch import bmatrix, catchwords, kmeans, linalg, sparse, \
    thresholds, topic_model
from torch_parity import JaxDraws, biting_corpus, golden_corpus

CHUNK = 256
CORPORA = {"golden": golden_corpus, "biting": biting_corpus}


def _both(corpus):
    """(isle_tpu DocSparse, the port's DocSparse) of one corpus."""
    J = jsp.DocSparse.from_corpus(corpus, chunk=CHUNK)
    A = sparse.DocSparse.from_numpy(
        *(np.asarray(a) for a in (J.d_word, J.d_doc, J.d_val, J.w_word,
                                  J.w_doc, J.w_val)),
        J.vocab, J.num_docs, "cpu",
    )
    return J, A


def _thresholded(corpus, J, drop):
    """isle_tpu's B of one corpus (k = 4) and the port's copy of it; with
    `drop` both drop flags are on, so some words have ζ = +inf."""
    hp = HyperParams(few_samples_threshold_drop=drop, bad_threshold_drop=drop)
    z, _ = jth.compute_thresholds_jax(J.d_word, J.d_val, J.vocab,
                                      corpus.avg_doc_sz, corpus.nz_docs, 4,
                                      hp)
    JB, _ = jbm.threshold_and_copy(J, z, chunk=CHUNK)
    B = sparse.DocSparse.from_numpy(
        *(np.asarray(a) for a in (JB.d_word, JB.d_doc, JB.d_val, JB.w_word,
                                  JB.w_doc, JB.w_val)),
        JB.vocab, JB.num_docs, "cpu",
    )
    return JB, B


# The matrices the catchword and topic-model stages are held on: the
# corpus A, and the biting corpus's B with the drop flags off and on.
MATRICES = ["golden-A", "biting-A", "biting-B", "biting-B-drop"]


def _matrix(which):
    name, kind = which.split("-", 1)
    corpus = CORPORA[name]()
    J, A = _both(corpus)
    if kind != "A":
        J, A = _thresholded(corpus, J, kind == "B-drop")
    return J, A


def _plan(seg, n):
    plan = plan_segments(seg, n, chunk=CHUNK)
    assert plan is not None
    return plan


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_docsparse_and_spmm(name):
    corpus = CORPORA[name]()
    J, A = _both(corpus)
    assert A.nnz == corpus.nnz == J.nnz
    # from_corpus sorts the word-sorted copy on the device itself
    B = sparse.DocSparse.from_corpus(corpus, "cpu")
    for f in ("d_word", "d_doc", "d_val", "w_word", "w_doc", "w_val"):
        assert torch.equal(getattr(A, f), getattr(B, f)), f
    rng = np.random.default_rng(0)
    X = rng.normal(size=(J.vocab, 6)).astype(np.float32)
    Y = rng.normal(size=(J.num_docs, 6)).astype(np.float32)
    for got, ref in (
        (sparse.bt_x(A, torch.from_numpy(X), 300), jsp.bt_x(J, jnp.asarray(X))),
        (sparse.b_y(A, torch.from_numpy(Y), 300), jsp.b_y(J, jnp.asarray(Y))),
        (sparse.gram_x(A, torch.from_numpy(X)), jsp.gram_x(J, jnp.asarray(X))),
        (sparse.doc_l2sq(A), jsp.doc_l2sq(J)),
    ):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(sparse.frobenius_sq(A)),
                               float(jsp.frobenius_sq(J)), rtol=1e-5)


@pytest.mark.parametrize("which", MATRICES)
def test_doc_l2sq_matches_jax(which):
    """doc_l2sq (segsum_onehot into one column) against
    isle_tpu.sparse.doc_l2sq, on A and on the biting corpus's B, the
    matrix the main path takes the norms of."""
    J, A = _matrix(which)
    np.testing.assert_allclose(sparse.doc_l2sq(A).numpy(),
                               np.asarray(jsp.doc_l2sq(J)), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("width", [1, 100, 128])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_spmm_on_cpu_launches_no_kernel(name, width):
    """bt_x and b_y on CPU tensors take segsum_gather_rows's plain version
    (no launch) and equal isle_tpu.sparse.bt_x / b_y, on Krylov-like
    blocks of mixed sign."""
    from isle_tpu_torch import segsum

    J, A = _both(CORPORA[name]())
    rng = np.random.default_rng(width)
    X = rng.normal(size=(J.vocab, width)).astype(np.float32)
    Y = rng.normal(size=(J.num_docs, width)).astype(np.float32)
    segsum.reset_launch_counts()
    got_x = sparse.bt_x(A, torch.from_numpy(X))
    got_y = sparse.b_y(A, torch.from_numpy(Y))
    assert segsum.launch_counts() == {
        "segsum_onehot": 0, "segsum_gather_rows": 0,
    }
    assert got_x.shape == (J.num_docs, width)
    assert got_y.shape == (J.vocab, width)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(
        jsp.bt_x(J, jnp.asarray(X)))[:, :width], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(
        jsp.b_y(J, jnp.asarray(Y)))[:, :width], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_thresholds_and_b(name, drop):
    corpus = CORPORA[name]()
    J, A = _both(corpus)
    k = 4
    hp = HyperParams(few_samples_threshold_drop=drop, bad_threshold_drop=drop)
    ref_z, ref_nnz = jth.compute_thresholds_jax(
        J.w_word, J.w_val, J.vocab, corpus.avg_doc_sz, corpus.nz_docs, k,
        hp, plan=_plan(J.w_word, J.vocab), interpret=True,
    )
    z, nnz = thresholds.compute_thresholds(
        A, corpus.avg_doc_sz, corpus.nz_docs, k, hp)
    np.testing.assert_array_equal(z.numpy(), np.asarray(ref_z))
    assert nnz == int(ref_nnz)
    if name == "biting":
        assert (z > 1).any() and (torch.isinf(z).any() == drop)

    JB, ref_cols = jbm.threshold_and_copy(J, ref_z, chunk=CHUNK)
    B, cols = bmatrix.threshold_and_copy(A, z)
    np.testing.assert_array_equal(cols, ref_cols)
    assert B.num_docs == JB.num_docs and B.nnz == JB.nnz
    for f in ("d_word", "d_doc", "d_val", "w_word", "w_doc", "w_val"):
        np.testing.assert_array_equal(
            getattr(B, f).numpy(), np.asarray(getattr(JB, f))[: JB.nnz], f)


def _clusters(rng, D, k, drop_frac=0.1):
    cluster = rng.integers(0, k, D).astype(np.int32)
    cluster[rng.random(D) < drop_frac] = -1
    sizes = np.bincount(cluster[cluster >= 0], minlength=k).astype(np.int32)
    return cluster, sizes


@pytest.mark.parametrize("r", [1, 3, 40])
@pytest.mark.parametrize("which", MATRICES)
def test_rth_highest_and_catchwords(which, r):
    """The last cluster is three docs sharing a word: for r >= 3 that
    (word, cluster) group is the degenerate full-cluster case."""
    J, A = _matrix(which)
    k = 6
    cluster, _ = _clusters(np.random.default_rng(r), J.num_docs, k)
    cluster[cluster == k - 1] = 0
    words, docs, vals = (x.numpy() for x in (A.d_word, A.d_doc, A.d_val))
    word = np.bincount(words).argmax()
    cluster[docs[words == word][:3]] = k - 1
    sizes = np.bincount(cluster[cluster >= 0], minlength=k).astype(np.int32)
    ref = jcw.rth_highest(J, jnp.asarray(cluster), jnp.asarray(sizes), k, r,
                          plan=_plan(J.w_word, J.vocab), interpret=True)
    got = catchwords.rth_highest(A, torch.from_numpy(cluster),
                                 torch.from_numpy(sizes), k, r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    vals = np.sort(vals[words == word][:3])[::-1]
    assert got[k - 1, word] == vals[min(r, 3) - 1]
    cw = catchwords.find_catchwords(got, 1.1).numpy()
    np.testing.assert_array_equal(cw, np.asarray(jcw.find_catchwords(ref, 1.1)))


@pytest.mark.parametrize("which", MATRICES)
def test_construct_topic_model(which):
    J, A = _matrix(which)
    k = 5
    rng = np.random.default_rng(11)
    cluster, _ = _clusters(rng, J.num_docs, k)
    cwt = np.full(J.vocab, -1, np.int32)
    cwt[rng.permutation(J.vocab)[: 6 * k]] = np.arange(6 * k) % k
    cwt[cwt == k - 1] = -1  # one topic without catchwords
    rank = HyperParams().model_rank_threshold(J.num_docs, k)
    ref_m, ref_p = jtm.construct_topic_model(
        J, jnp.asarray(cwt), jnp.asarray(cluster), k, rank,
        want_top_pairs=True, plan_d=_plan(J.d_doc, J.num_docs),
        plan_w=_plan(J.w_word, J.vocab), interpret=True,
    )
    m, p = topic_model.construct_topic_model(
        A, torch.from_numpy(cwt), torch.from_numpy(cluster), k, rank,
        want_top_pairs=True,
    )
    np.testing.assert_allclose(m.numpy(), np.asarray(ref_m), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(p, ref_p):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mass = topic_model.doc_topic_mass(A, torch.from_numpy(cwt), k)
    ref_mass = jtm.doc_topic_mass(J, jnp.asarray(cwt), k,
                                  plan=_plan(J.d_doc, J.num_docs),
                                  interpret=True)
    np.testing.assert_allclose(mass.numpy(), np.asarray(ref_mass), rtol=1e-5,
                               atol=1e-6)


def test_block_ks_matches_jax():
    """The same start block through both solvers: eigenvalues within rtol
    1e-4, eigenvectors equal up to sign."""
    J, A = _both(golden_corpus())
    nev, blk = 5, 32
    key = jax.random.PRNGKey(4)
    ref = jla.block_ks(lambda B_, X: jsp.gram_x(B_, X), J.vocab, nev,
                       blk=blk, key=key, op_data=J)
    got = linalg.block_ks(lambda X: sparse.gram_x(A, X), A.vocab, nev,
                          JaxDraws.from_keys(eig=key), "cpu", blk=blk)
    assert got.nconv == ref.nconv == nev
    np.testing.assert_allclose(got.evals, ref.evals, rtol=1e-4)
    U = got.evecs.numpy()
    U_ref = np.asarray(ref.evecs)
    np.testing.assert_allclose(linalg.align_signs(U, U_ref), U_ref,
                               atol=2e-4)
    # ... and the dense oracle agrees
    Bd = sparse.to_dense(A)
    w, _ = linalg.dense_topk_eigh(Bd @ Bd.T, nev)
    np.testing.assert_allclose(got.evals, w, rtol=1e-4)


def test_kmeans_matches_jax():
    """Same draws -> same k-means++ seeds; then identical Lloyd's
    assignments in the projected and in the full space."""
    rng = np.random.default_rng(5)
    k, kdim, D = 12, 6, 240
    mus = rng.standard_normal((k, kdim)) * 3
    P = (mus[rng.integers(0, k, D)] + rng.standard_normal((D, kdim))).T
    P = np.ascontiguousarray(P, np.float32)
    key = jax.random.PRNGKey(9)
    ref_idx, ref_c, ref_res = jkm.kmeans_init_on_projected(
        jnp.asarray(P), k, 2, key)
    idx, c, res = kmeans.kmeans_init_on_projected(
        torch.from_numpy(P), k, 2, JaxDraws.from_keys(km=key))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(res, ref_res, rtol=1e-5)
    ref_c, ref_a = jkm.run_lloyds_projected(jnp.asarray(P), ref_c, 10)
    c, a = kmeans.run_lloyds_projected(torch.from_numpy(P), c, 10)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref_a))
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=1e-5,
                               atol=1e-5)

    J, A = _both(golden_corpus())
    seeds = rng.choice(J.num_docs, 5, replace=False)
    C0 = sparse.to_dense(A)[:, seeds].T.astype(np.float32)
    ref_c, ref_a = jkm.run_lloyds_full(J, jnp.asarray(C0), 10)
    c, a = kmeans.run_lloyds_full(A, torch.from_numpy(C0), 10)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref_a))
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=1e-5,
                               atol=1e-6)


def _projected_case(seed, k=12, kdim=6, D=240):
    rng = np.random.default_rng(seed)
    mus = rng.standard_normal((k, kdim)) * 3
    P = (mus[rng.integers(0, k, D)] + rng.standard_normal((D, kdim))).T
    return np.ascontiguousarray(P, np.float32), rng


@pytest.mark.parametrize("seed", [5, 6])
def test_projected_lloyds_sums_in_a_fixed_order(seed):
    """The projected Lloyd's takes its cluster sums as a one-hot product,
    as isle_tpu does, and holds no index_add_ (float atomics on the card,
    whose order changes from run to run): two runs are bit-equal, and the
    result is isle_tpu's."""
    import inspect

    P, rng = _projected_case(seed)
    k = 12
    C0 = P[:, rng.choice(P.shape[1], k, replace=False)].T.copy()
    runs = [kmeans.run_lloyds_projected(torch.from_numpy(P),
                                        torch.from_numpy(C0), 10)
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    ref_c, ref_a = jkm.run_lloyds_projected(jnp.asarray(P), jnp.asarray(C0),
                                            10)
    np.testing.assert_array_equal(runs[0][1].numpy(), np.asarray(ref_a))
    np.testing.assert_allclose(runs[0][0].numpy(), np.asarray(ref_c),
                               rtol=1e-5, atol=1e-5)
    for fn in (kmeans.run_lloyds_projected, kmeans._weighted_lloyds,
               kmeans.kmeansbb_on_projected, kmeans._cluster_sums):
        body = inspect.getsource(fn).split('"""')[-1]
        assert "index_add" not in body, fn.__name__


@pytest.mark.parametrize("seed", [7, 8])
def test_weighted_lloyds_sums_in_a_fixed_order(seed):
    """The weighted Lloyd's of k-means||: bit-equal from run to run, equal
    to a float64 loop over the clusters, and to isle_tpu's."""
    P, rng = _projected_case(seed, D=90)
    k = 5
    w = rng.integers(1, 9, P.shape[1]).astype(np.float32)
    C0 = P[:, rng.choice(P.shape[1], k, replace=False)].T.copy()
    args = (torch.from_numpy(P), torch.from_numpy(w), torch.from_numpy(C0))
    (c1, r1), (c2, r2) = (kmeans._weighted_lloyds(*args, reps=1)
                          for _ in range(2))
    assert torch.equal(c1, c2) and torch.equal(r1, r2)
    P64, C64 = P.astype(np.float64), C0.astype(np.float64)
    d = ((P64.T[:, None, :] - C64[None]) ** 2).sum(axis=2)
    a = d.argmin(axis=1)
    want = np.stack([
        (P64[:, a == t] * w[a == t]).sum(axis=1) / max(w[a == t].sum(), 1e-30)
        if (a == t).any() else np.zeros(P.shape[0]) for t in range(k)])
    np.testing.assert_allclose(c1.numpy(), want, rtol=1e-5, atol=1e-5)

    ref_c, ref_r = jkm._weighted_lloyds(jnp.asarray(P), jnp.asarray(w),
                                        jnp.asarray(C0), reps=3)
    got_c, got_r = kmeans._weighted_lloyds(*args, reps=3)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got_r), float(ref_r), rtol=1e-5)
