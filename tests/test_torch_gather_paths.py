"""The gather kernel's two paths beside the wide one, on the CPU: the
tile-ordered copy of the word stream (sparse.with_doc_tiles) and the
product over it (segsum.segsum_gather_rows_tiled, which on a CPU tensor
chains segsum_gather_rows_plain over the tiles), the narrow wrapper, and
the dispatch rule (segsum.gather_path).

The tile size is forced small (sparse.DOC_TILE) so that the small corpora
of tests/torch_parity.py span several tiles. The products are held
against sparse.b_y within 1e-6 relative (the same sums, chained over the
tiles in another order) and, in the hybrid layout, against isle_tpu's
h_b_y / h_gram_x (Pallas in interpret mode) within test_torch_hybrid.py's
tolerance: rtol 1e-5, atol 1e-6 of the product's largest value. The
kernels themselves are held to these plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isle_tpu import hybrid as jhy
from isle_tpu import matops as jmo
from isle_tpu import sparse as jsp
from isle_tpu import thresholds as jth
from isle_tpu.config import HyperParams
from isle_tpu_torch import hybrid, matops, segsum, sparse
from isle_tpu_torch import sharding as sh
from test_torch_trainer import CPU, HYBRID, HYBRID_CASES, \
    _assert_same_result, _config, _jax, _port
from torch_cases import gather_case, t
from torch_parity import HEAD_BYTES, REFERENCE_TPU, REFERENCE_TPU_HYBRID, \
    biting_corpus, golden_corpus

CHUNK = 256
CORPORA = {"golden": golden_corpus, "biting": biting_corpus}


def _random_sparse(seed, V=60, D=1000, nnz=3000, gap=(300, 400)):
    """A DocSparse with no doc in [gap[0], gap[1]) and word 0 in every
    tenth doc, so a tile of 100 docs is empty and a word spans tiles."""
    rng = np.random.default_rng(seed)
    docs = np.concatenate([np.arange(gap[0]), np.arange(gap[1], D)])
    w = rng.integers(1, V, nnz)
    d = rng.choice(docs, nnz)
    w = np.concatenate([w, np.zeros(D // 10, np.int64)])
    d = np.concatenate([d, np.arange(0, D, 10)])
    keep = (d < gap[0]) | (d >= gap[1])
    w, d = w[keep], d[keep]
    pairs = np.unique(d * V + w)
    d, w = pairs // V, pairs % V
    v = rng.random(len(d)).astype(np.float32) + 0.5
    return sparse.DocSparse.from_doc_sorted(w, d, v, V, D, "cpu")


def _entries(word, doc, val):
    order = np.lexsort((doc.numpy(), word.numpy()))
    return [a.numpy()[order] for a in (word, doc, val)]


@pytest.mark.parametrize("T", [100, 128, 333, 1000, 4096])
def test_tile_order_is_a_permutation_sorted_within_tiles(T):
    sp = _random_sparse(0)
    tl = sparse.with_doc_tiles(sp, T)
    ntiles = -(-sp.num_docs // T)
    assert tl.tile_rows == T and len(tl.tile_starts) == ntiles + 1
    assert tl.tile_starts[0] == 0 and tl.tile_starts[-1] == sp.nnz
    # the same entries
    for got, want in zip(_entries(tl.t_word, tl.t_doc, tl.t_val),
                         _entries(sp.w_word, sp.w_doc, sp.w_val)):
        np.testing.assert_array_equal(got, want)
    # the word stream itself is untouched
    assert torch.equal(tl.w_word, sp.w_word) and torch.equal(tl.w_doc,
                                                             sp.w_doc)
    docs = sp.w_doc.numpy()
    spans = 0
    word0_tiles = {d // T for d in range(0, sp.num_docs, 10)
                   if not 300 <= d < 400}
    for i in range(ntiles):
        a, b = tl.tile_starts[i], tl.tile_starts[i + 1]
        assert b - a == int(np.sum((docs >= i * T) & (docs < (i + 1) * T)))
        w, d = tl.t_word[a:b].numpy(), tl.t_doc[a:b].numpy()
        assert np.all((d >= i * T) & (d < (i + 1) * T))
        key = w.astype(np.int64) * (sp.num_docs + 1) + d
        assert np.all(np.diff(key) > 0)  # sorted by (word, doc)
        spans += int(np.any(w == 0))
    assert spans == len(word0_tiles) > (T < 1000)  # word 0 spans tiles
    if T == 100:
        assert tl.tile_starts[3] == tl.tile_starts[4]  # docs 300-399


def test_one_tile_keeps_the_word_order():
    sp = _random_sparse(1)
    tl = sparse.with_doc_tiles(sp, sp.num_docs)
    assert tl.tile_starts == (0, sp.nnz)
    assert torch.equal(tl.t_word, sp.w_word) and torch.equal(tl.t_doc,
                                                             sp.w_doc)


def test_with_doc_tiles_refuses_a_bad_size():
    with pytest.raises(ValueError, match="tile_rows"):
        sparse.with_doc_tiles(_random_sparse(2), 0)


@pytest.mark.parametrize("W", [1, 5, 100])
@pytest.mark.parametrize("T", [64, 100, 250])
def test_tiled_plain_chain_equals_b_y(W, T):
    sp = _random_sparse(3)
    tl = sparse.with_doc_tiles(sp, T)
    Y = torch.from_numpy(np.random.default_rng(W).standard_normal(
        (sp.num_docs, W)).astype(np.float32))
    want = sparse.b_y(sp, Y).double()
    got = segsum.segsum_gather_rows_tiled(
        tl.t_word, tl.t_doc, tl.t_val, Y, sp.vocab, tl.tile_starts)[:-1]
    scale = sparse.b_y(sp, Y.abs()).double()
    assert torch.all((got.double() - want).abs() <= 1e-6 * scale + 1e-30)
    # sparse.b_y on the tiled layout: tiled where the dispatch says so
    path = segsum.gather_path(W, Y.numel() * 4, tl.tile_rows)
    assert path == ("narrow" if W <= segsum.NARROW_MAX_WIDTH else "tiled")
    torch.testing.assert_close(sparse.b_y(tl, Y).double(), want, rtol=1e-6,
                               atol=1e-6 * float(scale.max()))


def test_tiled_plain_chains_init():
    sp = _random_sparse(4)
    tl = sparse.with_doc_tiles(sp, 128)
    rng = np.random.default_rng(5)
    Y = torch.from_numpy(rng.random((sp.num_docs, 3)).astype(np.float32))
    init = torch.from_numpy(rng.random((sp.vocab + 1, 3)).astype(np.float32))
    got = segsum.segsum_gather_rows_tiled(tl.t_word, tl.t_doc, tl.t_val, Y,
                                          sp.vocab, tl.tile_starts, init)
    want = segsum.segsum_gather_rows_plain(sp.w_word, sp.w_doc, sp.w_val, Y,
                                           sp.vocab, init)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # an all-empty stream returns init (or zeros)
    e = torch.zeros(0, dtype=torch.int32)
    empty = segsum.segsum_gather_rows_tiled(e, e, e.float(), Y, sp.vocab,
                                            (0, 0, 0), init)
    assert torch.equal(empty, init)
    zeros = segsum.segsum_gather_rows_tiled(e, e, e.float(), Y, sp.vocab,
                                            (0, 0))
    assert torch.equal(zeros, torch.zeros(sp.vocab + 1, 3))


@pytest.mark.parametrize("starts", [(), (1, 5), (0, 3), (0, 9, 5, 8)])
def test_tiled_wrapper_refuses_bad_offsets(starts):
    seg, idx, val, table, S = gather_case(0, n=8)
    with pytest.raises(ValueError, match="tile_starts"):
        segsum.segsum_gather_rows_tiled(t(seg), t(idx), t(val), t(table), S,
                                        starts)


def test_narrow_wrapper_on_the_cpu_is_the_plain_version():
    seg, idx, val, table, S = gather_case(6, W=3)
    segsum.reset_launch_counts()
    got = segsum.segsum_gather_rows_narrow(t(seg), t(idx), t(val), t(table),
                                           S)
    want = segsum.segsum_gather_rows_plain(t(seg), t(idx), t(val), t(table),
                                           S)
    assert torch.equal(got, want)
    assert set(segsum.launch_counts().values()) == {0}


def test_narrow_kernel_refuses_a_wide_table_on_any_device():
    seg, idx, val, table, S = gather_case(
        7, W=segsum.NARROW_MAX_WIDTH + 1)
    with pytest.raises(ValueError, match="at most 16 columns"):
        segsum.segsum_gather_rows_narrow(t(seg), t(idx), t(val), t(table), S)
    with pytest.raises(ValueError, match="kernel must be"):
        segsum.segsum_gather_rows(t(seg), t(idx), t(val), t(table), S,
                                  kernel="tiled")


# the dispatch rule: (width, table bytes, tile rows) -> path
@pytest.mark.parametrize("width,table_bytes,tile_rows,want", [
    (1, 4 * 300_000, 0, "narrow"),
    (1, 4 * 300_000, 65_536, "narrow"),  # the Lanczos B y on a tiled tail
    (1, 4 * 102_660, 0, "narrow"),  # the Lanczos B^T x
    (128, 4 * 128 * 300_000, 0, "wide"),  # COO B Y: no tiles
    (128, 4 * 128 * 300_000, 65_536, "tiled"),  # the hybrid tail's B Y
    (100, 4 * 100 * 300_000, 65_536, "tiled"),  # the tail's B onehot
    (128, 4 * 128 * 65_536, 65_536, "wide"),  # one tile: nothing to tile
    (128, 4 * 128 * 65_537, 65_536, "tiled"),
    (100, 4 * 100 * 102_660, 0, "wide"),
])
def test_dispatch_rule(width, table_bytes, tile_rows, want):
    assert segsum.gather_path(width, table_bytes, tile_rows) == want


def test_dispatch_rule_narrow_up_to_the_measured_width():
    N = segsum.NARROW_MAX_WIDTH
    # the kernel's own widest table (csrc/segsum.cu)
    src = open(segsum.__file__.replace("segsum.py", "csrc/segsum.cu")).read()
    assert f"constexpr int kNarrowMaxW = {N};" in src
    big = 4 * 1024 * 300_000
    for W in range(1, N + 1):
        assert segsum.gather_path(W, big, 65_536) == "narrow"
    assert segsum.gather_path(N + 1, 0, 0) == "wide"
    assert segsum.gather_path(N + 1, big, 65_536) == "tiled"


# -- the hybrid layout with several tiles, against isle_tpu -----------------


def _both(name, T, monkeypatch):
    """isle_tpu's and the port's hybrid layouts of one corpus at k = 4
    with a partial head, the port's tail in tiles of T docs."""
    monkeypatch.setattr(sparse, "DOC_TILE", T)
    corpus = CORPORA[name]()
    J = jsp.DocSparse.from_corpus(corpus, chunk=CHUNK)
    A = sparse.DocSparse.from_numpy(
        *(np.asarray(a) for a in (J.d_word, J.d_doc, J.d_val, J.w_word,
                                  J.w_doc, J.w_val)),
        J.vocab, J.num_docs, "cpu")
    z, _ = jth.compute_thresholds_jax(J.d_word, J.d_val, J.vocab,
                                      corpus.avg_doc_sz, corpus.nz_docs, 4,
                                      HyperParams())
    z = np.array(z)
    ref, *_ = jhy.hybrid_from_thresholds(J, jnp.asarray(z), HEAD_BYTES,
                                         chunk=CHUNK)
    got, *_ = hybrid.hybrid_from_thresholds(A, torch.from_numpy(z),
                                            HEAD_BYTES)
    return ref, got


@pytest.mark.parametrize("T", [16, 64])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_hybrid_tail_tiles_match_isle_tpu(name, T, monkeypatch):
    h, g = _both(name, T, monkeypatch)
    tail = g.tail
    assert tail.tile_rows == T and len(tail.tile_starts) - 1 == -(
        -g.num_docs // T) > 1
    rng = np.random.default_rng(T)
    W = 24
    X = rng.standard_normal((g.vocab, W)).astype(np.float32)
    Y = rng.standard_normal((g.num_docs, W)).astype(np.float32)
    assert segsum.gather_path(W, Y.nbytes, T) == (
        "narrow" if W <= segsum.NARROW_MAX_WIDTH else "tiled")
    for got, ref in (
        (hybrid.h_b_y(g, torch.from_numpy(Y)), jhy.h_b_y(h, jnp.asarray(Y),
                                                         CHUNK)),
        (hybrid.h_gram_x(g, torch.from_numpy(X)),
         jhy.h_gram_x(h, jnp.asarray(X), CHUNK)),
        (matops.mat_b_y(g, torch.from_numpy(Y)),
         jmo.mat_b_y(h, jnp.asarray(Y), CHUNK)),
    ):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())
    # the tiled product is the untiled one within float32 reordering
    untiled = sparse.b_y(sparse.DocSparse(
        tail.d_word, tail.d_doc, tail.d_val, tail.w_word, tail.w_doc,
        tail.w_val, tail.vocab, tail.num_docs), torch.from_numpy(Y))
    torch.testing.assert_close(sparse.b_y(tail, torch.from_numpy(Y)),
                               untiled, rtol=1e-6, atol=1e-6)


def test_every_layout_tiles_the_tail(monkeypatch):
    """to_hybrid (the streamed build) and sharding.shard_hybrid reach
    split_by_head, which tiles the tail with the module's one size."""
    monkeypatch.setattr(sparse, "DOC_TILE", 32)
    corpus = golden_corpus()
    A = sparse.DocSparse.from_corpus(corpus, "cpu")
    scale = torch.ones(A.vocab)
    h = hybrid.to_hybrid(A, 10, scale)
    mesh = sh.Mesh("cpu")
    S = sh.shard_doc_sparse(corpus.rows, corpus.doc_ids(), corpus.vals,
                            A.vocab, A.num_docs, mesh)
    hs = sh.shard_hybrid(S, scale, mesh, 2 * A.num_docs * 10)
    for tail in (h.tail, hs.local.tail):
        assert tail.tile_rows == 32
        assert tail.tile_starts[-1] == tail.nnz
        for got, want in zip(_entries(tail.t_word, tail.t_doc, tail.t_val),
                             _entries(tail.w_word, tail.w_doc, tail.w_val)):
            np.testing.assert_array_equal(got, want)
    # at world size 1 the rank's tail is the in-core one, tiles and all
    assert torch.equal(hs.local.tail.t_doc, h.tail.t_doc)
    assert hs.local.tail.tile_starts == h.tail.tile_starts


# the slice end to end: the trainer with B (COO) or the hybrid tail in
# several tiles, its B Y over them
@pytest.mark.parametrize("layout", ["hybrid", "coo"])
@pytest.mark.parametrize("case", ["biting", "elkans", "golden"])
def test_trainer_with_tiles_matches_jax_trainer(tmp_path, case, layout,
                                                monkeypatch):
    monkeypatch.setattr(sparse, "DOC_TILE", 48)
    make, k, seed, hyper = HYBRID_CASES[case]
    corpus = make()
    tpu, gpu = ((REFERENCE_TPU_HYBRID, HYBRID) if layout == "hybrid"
                else (REFERENCE_TPU, CPU))
    cfg = _config(k, seed, HyperParams(**hyper), tpu=tpu)
    ref = _jax(corpus, cfg, tmp_path / "jax")
    got = _port(corpus, cfg, tmp_path / "torch", gpu=gpu)
    _assert_same_result(got, ref)
