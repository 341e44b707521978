"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a CUDA device:
the kernels have no CPU mode. The card's host has no jax, and
tests/conftest.py imports it, so run this file there without the
conftest:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py

Counts must be exactly equal; float32 sums within rtol 1e-5, atol 1e-6:
both kernels sum floats in a fixed order of their own (no float atomics,
so two launches are bit-equal), other than the plain version's.
"""

import numpy as np
import pytest
import torch

from isle_tpu_torch import segsum
from torch_cases import gather_case, onehot_case, t

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda(dev, *arrays):
    return [None if a is None else t(a).to(dev) for a in arrays]


def _check_onehot(got, ref, with_val):
    torch.cuda.synchronize()
    if with_val:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    else:
        assert got.dtype == torch.int32 and torch.equal(got, ref)


@pytest.mark.parametrize("chunk", [256, 2048])
@pytest.mark.parametrize("with_val", [False, True])
def test_segsum_onehot_matches_plain(dev, with_val, chunk):
    seg, col, val, S, k = onehot_case(7, with_val)
    args = _cuda(dev, seg, col, val)
    before = segsum.segsum_onehot.launches
    got = segsum.segsum_onehot(*args, S, k, chunk=chunk)
    assert segsum.segsum_onehot.launches == before + 1
    _check_onehot(got, segsum.segsum_onehot_plain(*args, S, k), with_val)


def _onehot_stream(n, S, ncols, seed, with_val):
    """A sorted stream with a head segment of 30% of the entries (across
    many slices), the rest Zipf-spread over S segments, a tenth of the
    columns masked (-1) and a few entries outside [0, S] at both ends."""
    rng = np.random.default_rng(seed)
    seg = np.minimum((np.exp(rng.random(n) * np.log(S)) - 1).astype(
        np.int64), S - 1)
    seg[: int(0.3 * n)] = S // 3
    seg[:5] = -2
    seg[-5:] = S + 1
    seg = np.sort(seg).astype(np.int32)
    col = rng.integers(0, ncols, n).astype(np.int32)
    col[rng.random(n) < 0.1] = -1
    val = (rng.random(n) + 0.5).astype(np.float32) if with_val else None
    return seg, col, val


@pytest.mark.parametrize("with_val", [False, True])
@pytest.mark.parametrize("ncols", [1, 7, 100, 635, 3000])
def test_segsum_onehot_every_path(dev, ncols, with_val):
    """Each window shape of the kernel's 1024-cell row window: many rows
    (1, 7, 100 columns), one row (the ζ histogram's 635) and column tiles
    (3000), against the plain version in float64."""
    S = 4_000
    seg, col, val = _onehot_stream(60_000, S, ncols, ncols, with_val)
    s, c, v = _cuda(dev, seg, col, val)
    got = segsum.segsum_onehot(s, c, v, S, ncols)
    if with_val:
        ref = segsum.segsum_onehot_plain(s, c, v.double(), S, ncols)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-6)
    else:
        _check_onehot(got, segsum.segsum_onehot_plain(s, c, None, S, ncols),
                      False)


@pytest.mark.parametrize("chunk", [7, 2048])
@pytest.mark.parametrize("with_val", [False, True])
def test_segsum_onehot_without_col(dev, with_val, chunk):
    """col=None (every entry in column 0, no column array read) equals a
    col of zeros and the plain version; float sums bit-equal across two
    launches."""
    S = 4_000
    seg, _, val = _onehot_stream(60_000, S, 1, 14, with_val)
    s, v = _cuda(dev, seg, val)
    zeros = torch.zeros_like(s)
    got = segsum.segsum_onehot(s, None, v, S, 1, chunk=chunk)
    _check_onehot(got, segsum.segsum_onehot_plain(s, None, v, S, 1),
                  with_val)
    assert torch.equal(got, segsum.segsum_onehot(s, zeros, v, S, 1,
                                                 chunk=chunk))
    assert torch.equal(got, segsum.segsum_onehot(s, None, v, S, 1,
                                                 chunk=chunk))


@pytest.mark.parametrize("with_val", [False, True])
@pytest.mark.parametrize("chunk", [1, 7, 256, 2048, 65536])
def test_segsum_onehot_any_chunk(dev, chunk, with_val):
    """Slices of one entry up to one slice for the whole stream."""
    S, k = 700, 9
    seg, col, val = _onehot_stream(20_000, S, k, 11, with_val)
    s, c, v = _cuda(dev, seg, col, val)
    init = None
    if with_val:
        init = torch.full((S + 1, k), 0.25, device=dev)
    got = segsum.segsum_onehot(s, c, v, S, k, init=init, chunk=chunk)
    _check_onehot(got, segsum.segsum_onehot_plain(s, c, v, S, k, init=init),
                  with_val)


@pytest.mark.parametrize("ncols", [1, 100])
def test_segsum_onehot_two_launches_bit_equal(dev, ncols):
    """No float atomics: the same input gives the same bits, on a head
    segment that crosses many slices (its parts added by the edge
    kernel in slice order)."""
    seg, col, val = _onehot_stream(400_000, 30_000, ncols, 12, True)
    args = _cuda(dev, seg, col, val)
    a = segsum.segsum_onehot(*args, 30_000, ncols)
    b = segsum.segsum_onehot(*args, 30_000, ncols)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_segsum_onehot_empty_and_init(dev):
    """An empty stream launches nothing and returns zeros or init; init
    seeds the counts too and is not written in place."""
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    before = segsum.segsum_onehot.launches
    assert not segsum.segsum_onehot(z, z, None, 6, 4).any()
    init = torch.full((7, 4), 3.0, device=dev)
    assert torch.equal(segsum.segsum_onehot(z, z, z.float(), 6, 4,
                                            init=init), init)
    assert segsum.segsum_onehot.launches == before
    seg, col, _ = _onehot_stream(30_000, 900, 5, 13, False)
    s, c = _cuda(dev, seg, col)
    init = torch.randint(0, 50, (901, 5), dtype=torch.int32, device=dev)
    keep = init.clone()
    got = segsum.segsum_onehot(s, c, None, 900, 5, init=init, chunk=512)
    _check_onehot(got, segsum.segsum_onehot_plain(s, c, None, 900, 5,
                                                  init=init), False)
    assert torch.equal(init, keep)


@pytest.mark.parametrize("chunk", [256, 2048, 4096])
@pytest.mark.parametrize("W", [1, 5, 100, 128, 300])
def test_segsum_gather_rows_matches_plain(dev, W, chunk):
    seg, idx, val, table, S = gather_case(8, W=W)
    args = _cuda(dev, seg, idx, val, table)
    before = segsum.segsum_gather_rows.launches
    got = segsum.segsum_gather_rows(*args, S, chunk=chunk)
    assert segsum.segsum_gather_rows.launches == before + 1
    ref = segsum.segsum_gather_rows_plain(*args, S)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["one_run", "all_distinct", "spill_only",
                                    "outside"])
def test_extreme_streams(dev, layout):
    """One run across every chunk edge (the kernels' carries at both ends
    of every slice), a new segment at every entry, a stream that is all
    spill row, and one whose segments run from below 0 to past the spill
    row; a tenth of the gather indices lie outside the table."""
    n, S, k, W = 5000, 6000, 3, 40
    rng = np.random.default_rng(1)
    seg = {"one_run": np.full(n, 17), "all_distinct": np.arange(n),
           "spill_only": np.full(n, S),
           "outside": np.linspace(-300, S + 300, n).astype(np.int64),
           }[layout].astype(np.int32)
    col = rng.integers(0, k, n).astype(np.int32)
    val = rng.random(n).astype(np.float32)
    table = rng.random((50, W)).astype(np.float32)
    idx = rng.integers(-3, 53, n).astype(np.int32)
    s, c, v, i, tb = _cuda(dev, seg, col, val, idx, table)
    for with_val in (False, True):
        vv = v if with_val else None
        _check_onehot(segsum.segsum_onehot(s, c, vv, S, k, chunk=512),
                      segsum.segsum_onehot_plain(s, c, vv, S, k), with_val)
    got = segsum.segsum_gather_rows(s, i, v, tb, S, chunk=512)
    ref = segsum.segsum_gather_rows_plain(s, i, v, tb, S)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_init_carry_and_checks(dev):
    seg, col, val, S, k = onehot_case(3, True)
    s, c, v = _cuda(dev, seg, col, val)
    init = torch.full((S + 1, k), 2.0, device=dev)
    got = segsum.segsum_onehot(s, c, v, S, k, init=init)
    torch.testing.assert_close(got, segsum.segsum_onehot(s, c, v, S, k) + 2.0)
    assert torch.all(init == 2.0)
    with pytest.raises(ValueError, match="col"):
        segsum.segsum_onehot(s, c.cpu(), v, S, k)
    seg, idx, val, table, S = gather_case(4)
    s, i, v, tb = _cuda(dev, seg, idx, val, table)
    init = torch.full((S + 1, tb.shape[1]), -1.5, device=dev)
    got = segsum.segsum_gather_rows(s, i, v, tb, S, init=init)
    torch.testing.assert_close(
        got, segsum.segsum_gather_rows_plain(s, i, v, tb, S, init=init))
    assert torch.all(init == -1.5)
    with pytest.raises(ValueError, match="chunk"):
        segsum.segsum_gather_rows(s, i, v, tb, S, chunk=0)
    with pytest.raises(ValueError, match="table"):
        segsum.segsum_gather_rows(s, i, v, tb.cpu(), S)


def _zipf_stream(n, S, rows, seed):
    """A sorted stream whose head segment holds 40% of the entries (a Zipf
    head word), the rest Zipf-spread over S segments."""
    rng = np.random.default_rng(seed)
    seg = np.minimum((np.exp(rng.random(n) * np.log(S)) - 1).astype(
        np.int64), S - 1)
    seg[: int(0.4 * n)] = 3
    seg = np.sort(seg).astype(np.int32)
    idx = rng.integers(0, rows, n).astype(np.int32)
    val = (rng.random(n) + 0.5).astype(np.float32)
    return seg, idx, val


def test_gather_rows_run_across_many_slices(dev):
    """A head segment of 80,000 entries crosses 156 slices of 512: its sum
    is the carry kernel's, added in slice order."""
    n, S, rows, W = 200_000, 5_000, 3_000, 100
    seg, idx, val = _zipf_stream(n, S, rows, 4)
    table = np.random.default_rng(5).random((rows, W)).astype(np.float32)
    s, i, v, tb = _cuda(dev, seg, idx, val, table)
    got = segsum.segsum_gather_rows(s, i, v, tb, S, chunk=512)
    ref = segsum.segsum_gather_rows_plain(s, i, v.double(), tb.double(), S)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("W", [7, 128])
def test_gather_rows_two_launches_bit_equal(dev, W):
    """No float atomics: the same input gives the same bits."""
    seg, idx, val = _zipf_stream(300_000, 20_000, 10_000, 6)
    table = np.random.default_rng(7).normal(size=(10_000, W)).astype(
        np.float32)
    args = _cuda(dev, seg, idx, val, table)
    a = segsum.segsum_gather_rows(*args, 20_000)
    b = segsum.segsum_gather_rows(*args, 20_000)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_gather_rows_empty_stream(dev):
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    tb = torch.ones((4, 8), device=dev)
    before = segsum.segsum_gather_rows.launches
    got = segsum.segsum_gather_rows(z, z, z.float(), tb, 6)
    assert segsum.segsum_gather_rows.launches == before
    assert got.shape == (7, 8) and not got.any()
    init = torch.full((7, 8), 3.0, device=dev)
    assert torch.equal(segsum.segsum_gather_rows(z, z, z.float(), tb, 6,
                                                 init=init), init)


def test_spmm_on_the_card_matches_plain(dev):
    """sparse.bt_x and sparse.b_y launch the kernel; each element within
    1e-5 of |B| |X| (the plain version on absolute values, in float64) of
    the plain version, since a Krylov block has mixed signs."""
    from isle_tpu_torch import sparse

    rng = np.random.default_rng(8)
    V, D, nnz = 3_000, 4_000, 150_000
    key = np.unique(rng.integers(0, D, nnz) * V
                    + np.minimum((np.exp(rng.random(nnz) * np.log(V)) - 1)
                                 .astype(np.int64), V - 1))
    d, w = key // V, key % V
    dv = (rng.random(key.size) * 3).astype(np.float32)
    order = np.lexsort((d, w))
    sp = sparse.DocSparse(
        *(torch.from_numpy(a).to(dev) for a in (
            w.astype(np.int32), d.astype(np.int32), dv,
            w[order].astype(np.int32), d[order].astype(np.int32),
            dv[order])), vocab=V, num_docs=D)
    X = torch.from_numpy(rng.normal(size=(V, 128)).astype(np.float32)).to(dev)
    Y = torch.from_numpy(rng.normal(size=(D, 100)).astype(np.float32)).to(dev)
    cases = (
        (sparse.bt_x, X, (sp.d_doc, sp.d_word, sp.d_val), D),
        (sparse.b_y, Y, (sp.w_word, sp.w_doc, sp.w_val), V),
    )
    for fn, T, (s, i, v), S in cases:
        before = segsum.segsum_gather_rows.launches
        got = fn(sp, T)
        assert segsum.segsum_gather_rows.launches == before + 1
        ref = segsum.segsum_gather_rows_plain(s, i, v.double(), T.double(),
                                              S)[:S]
        bound = segsum.segsum_gather_rows_plain(
            s, i, v.double().abs(), T.double().abs(), S)[:S]
        torch.cuda.synchronize()
        assert got.shape == ref.shape
        assert bool(((got.double() - ref).abs() <= 1e-5 * bound).all())


def _exact_corpus():
    """(corpus, k): every doc's counts add up to 64, the corpus's average,
    so each normalized value is its count and each catchword mass an
    integer sum, exact in float32 whatever the order of the sum."""
    from isle_tpu_torch import Corpus

    rng = np.random.default_rng(0)
    V, D, k = 300, 600, 5
    d = np.repeat(np.arange(D), 25)
    w = np.where(rng.random(d.size) < 0.7,
                 rng.integers(0, V // k, d.size) + (d % k) * (V // k),
                 rng.integers(0, V, d.size))
    key = np.unique(d * V + w)
    d, w = key // V, key % V
    # one count a word, the rest of the doc's 64 spread over its words
    per_doc = np.bincount(d, minlength=D)
    counts = 1 + np.concatenate([rng.multinomial(64 - m, np.full(m, 1 / m))
                                 for m in per_doc])
    corpus = Corpus.from_entries(d, w, counts, vocab_size=V, num_docs=D)
    assert corpus.avg_doc_sz == 64
    np.testing.assert_array_equal(corpus.vals, counts)
    return corpus, k


def test_trainer_on_the_card_matches_the_cpu(dev, tmp_path):
    """The whole slice on the card (both kernels launched) against the same
    slice on the CPU with the plain versions, on the corpus of exact
    masses: the card's masses equal the CPU's bit for bit, two topics
    that tie tie on both and both take the first (argmax), so the top-two
    topics and the edge topics must match."""
    from isle_tpu_torch import GpuConfig, TrainConfig, Trainer

    corpus, k = _exact_corpus()
    cfg = TrainConfig(num_topics=k, seed=2, compute_edge_topics=True,
                      max_edge_topics=8)
    runs = {}
    segsum.reset_launch_counts()
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg, output_dir=str(tmp_path / device), quiet=True,
                     gpu=GpuConfig(device=device))
        tr.load_corpus(corpus)
        tr.train()
        tr.train_edge_topics()
        runs[device] = tr
        if device == "cuda":
            counts = segsum.launch_counts()
            assert counts["segsum_onehot"] >= 3, counts
            assert counts["segsum_gather_rows"] >= 1, counts
    g, c = runs["cuda"], runs["cpu"]
    np.testing.assert_array_equal(g.cluster_of_doc, c.cluster_of_doc)
    np.testing.assert_allclose(g.evalues, c.evalues, rtol=1e-4)
    np.testing.assert_allclose(g.model, c.model, rtol=1e-4, atol=1e-6)
    for a, b in zip(g.top_pairs, c.top_pairs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g.edge_pairs, c.edge_pairs)
    np.testing.assert_allclose(g.edge_model, c.edge_model, rtol=1e-4,
                               atol=1e-6)


def test_sharded_trainer_on_the_card_matches_the_single_device_one(
        dev, tmp_path):
    """The sharded trainer at world size 1 (a mesh without a group) on the
    card: each stage launches exactly what the single-device stage
    launches, and the results are its results bit for bit."""
    from isle_tpu_torch import GpuConfig, TrainConfig, Trainer
    from isle_tpu_torch.sharding import Mesh

    corpus, k = _exact_corpus()
    cfg = TrainConfig(num_topics=k, seed=2, compute_edge_topics=True,
                      max_edge_topics=8)
    runs = {}
    for name, mesh in (("single", None), ("sharded", Mesh("cuda"))):
        segsum.reset_launch_counts()
        tr = Trainer(cfg, output_dir=str(tmp_path / name), quiet=True,
                     gpu=GpuConfig(device="cuda"), mesh=mesh)
        tr.load_corpus(corpus)
        tr.train()
        runs[name] = (tr, segsum.launch_counts())
    (g, g_counts), (c, c_counts) = runs["sharded"], runs["single"]
    # the single-device B stage also logs Frob(B): one more doc-norm launch
    assert g_counts["segsum_gather_rows"] == c_counts["segsum_gather_rows"]
    assert g_counts["segsum_onehot"] == c_counts["segsum_onehot"] - 1
    np.testing.assert_array_equal(g.original_cols, c.original_cols)
    np.testing.assert_array_equal(g.cluster_of_doc, c.cluster_of_doc)
    np.testing.assert_array_equal(g.evalues, c.evalues)
    np.testing.assert_array_equal(g.model, c.model)
    for a, b in zip(g.top_pairs, c.top_pairs):
        np.testing.assert_array_equal(a, b)


def test_kmeanspp_seeds_are_reproducible_on_the_card(dev):
    """k-means++ on 300,000 projected docs, the same draws five times: the
    same seeds and residual each time. torch.cumsum on the card adds its
    tiles in an order that changes from launch to launch, which is why
    the seeding takes its cumulative sum on the host; and the projected
    Lloyd's from those seeds ends in the same centers, bit for bit."""
    from isle_tpu_torch import kmeans
    from isle_tpu_torch.rng import Draws

    g = torch.Generator().manual_seed(3)
    P = torch.randn((8, 300_000), generator=g).to(dev)
    runs = []
    for _ in range(5):
        idx, centers, residual = kmeans.kmeans_init_on_projected(
            P, 50, 1, Draws(7))
        centers, assign = kmeans.run_lloyds_projected(P, centers, 3)
        runs.append((idx, residual, centers, assign))
    for idx, residual, centers, assign in runs[1:]:
        assert torch.equal(idx, runs[0][0]) and residual == runs[0][1]
        assert torch.equal(centers, runs[0][2])
        assert torch.equal(assign, runs[0][3])


def test_mwu_on_the_card_matches_the_cpu(dev):
    """MWU inference (plain PyTorch on the card: isle_tpu's MWU is XLA,
    not Pallas) against the same call on the CPU, with a tiny Lf on half
    the runs so that the float32 overflow retries happen on the card."""
    from isle_tpu_torch import Corpus, mwu

    rng = np.random.default_rng(3)
    V, D, k = 500, 400, 12
    M = rng.random((V, k)).astype(np.float32)
    M[M < 0.6] = 0.0
    M /= M.sum(axis=0, keepdims=True)
    d = np.repeat(np.arange(D), rng.integers(1, 90, D))
    key = np.unique(d * V + rng.integers(0, V, d.size))
    corpus = Corpus.from_entries(key // V, key % V,
                                 rng.integers(1, 6, key.size), vocab_size=V,
                                 num_docs=D, normalize_to_one=True)
    batch = mwu.build_infer_batch(corpus, M.sum(axis=1))
    for Lf, top_n in ((10.0, 0), (10.0, 5), (1e-3, 0)):
        g = mwu.infer_all(M, batch, 15, Lf, top_n=top_n, device=dev)
        c = mwu.infer_all(M, batch, 15, Lf, top_n=top_n, device="cpu")
        np.testing.assert_array_equal(g[1], c[1])
        for a, b in zip((g[0], g[2], g[3]), (c[0], c[2], c[3])):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def _doc_ordered_chunks(n, S, rows, seed, pieces=5):
    """A stream in doc order whose word-keyed sums cross every chunk: the
    segments (words) of each piece are sorted on their own, as the streamed
    passes sort a chunk by word. Returns a list of (seg, idx, val)."""
    rng = np.random.default_rng(seed)
    out = []
    for part in np.array_split(np.arange(n), pieces):
        seg = np.sort(np.minimum(
            (np.exp(rng.random(part.size) * np.log(S)) - 1).astype(np.int64),
            S - 1)).astype(np.int32)
        idx = rng.integers(0, rows, part.size).astype(np.int32)
        val = (rng.random(part.size) + 0.5).astype(np.float32)
        out.append((seg, idx, val))
    return out


@pytest.mark.parametrize("with_val", [False, True])
def test_onehot_init_carried_over_chunks(dev, with_val):
    """The streamed histogram's use: each chunk's launch takes the running
    result as init. Over five chunks the counts equal one plain pass over
    the whole stream exactly, float sums within rtol 1e-5 of float64, and
    a second accumulation is bit-equal; init is never written."""
    S, ncols = 3_000, 37
    chunks = _doc_ordered_chunks(100_000, S, ncols, 21)

    def accumulate():
        acc = torch.zeros((S + 1, ncols), device=dev,
                          dtype=torch.float32 if with_val else torch.int32)
        for seg, col, val in chunks:
            s, c, v = _cuda(dev, seg, col, val if with_val else None)
            prev, keep = acc, acc.clone()
            acc = segsum.segsum_onehot(s, c, v, S, ncols, init=acc)
            assert acc.data_ptr() != prev.data_ptr()
            assert torch.equal(prev, keep)
        return acc

    got = accumulate()
    seg, col, val = (np.concatenate(x) for x in zip(*chunks))
    s, c, v = _cuda(dev, seg, col, val)
    if with_val:
        ref = segsum.segsum_onehot_plain(s, c, v.double(), S, ncols)
        torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got, segsum.segsum_onehot_plain(s, c, None, S,
                                                           ncols))
    assert torch.equal(got, accumulate())


@pytest.mark.parametrize("W", [1, 100])
def test_gather_rows_init_carried_over_chunks(dev, W):
    """The streamed model accumulation's use: five word-sorted chunks added
    into a running (S + 1, W) result through init."""
    S, rows = 3_000, 2_000
    chunks = _doc_ordered_chunks(100_000, S, rows, 22)
    table = torch.from_numpy(np.random.default_rng(23).random(
        (rows, W)).astype(np.float32)).to(dev)

    def accumulate():
        acc = torch.zeros((S + 1, W), device=dev)
        for seg, idx, val in chunks:
            prev, keep = acc, acc.clone()
            acc = segsum.segsum_gather_rows(*_cuda(dev, seg, idx, val), table,
                                            S, init=acc)
            assert torch.equal(prev, keep)
        return acc

    got = accumulate()
    seg, idx, val = (np.concatenate(x) for x in zip(*chunks))
    s, i, v = _cuda(dev, seg, idx, val)
    ref = segsum.segsum_gather_rows_plain(s, i, v.double(), table.double(),
                                          S)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, accumulate())


def test_gram_operator_at_width_one(dev):
    """The Lanczos matvec: sparse.gram_x on a (V, 1) vector of mixed signs
    launches the gather kernel twice at W = 1 and equals the plain version
    in float64 within 1e-5 |B| |B^T| |x|."""
    from isle_tpu_torch import sparse

    corpus, _ = _exact_corpus()
    A = sparse.DocSparse.from_corpus(corpus, dev)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(A.vocab, 1)).astype(np.float32)).to(dev)
    before = segsum.segsum_gather_rows.launches
    got = sparse.gram_x(A, x)
    assert segsum.segsum_gather_rows.launches == before + 2

    def plain(vec):
        y = segsum.segsum_gather_rows_plain(
            A.d_doc, A.d_word, A.d_val.double(), vec, A.num_docs)
        return segsum.segsum_gather_rows_plain(
            A.w_word, A.w_doc, A.w_val.double(), y[:A.num_docs],
            A.vocab)[:A.vocab]

    ref, bound = plain(x.double()), plain(x.double().abs())
    torch.cuda.synchronize()
    assert got.shape == (A.vocab, 1)
    assert bool(((got.double() - ref).abs() <= 1e-5 * bound).all())


def test_chunk_loader_on_the_card(dev):
    """Every chunk arrives on the card as the corpus holds it, through the
    two staging slots, whether the caller takes the chunks one after the
    other or loads a range on its own; the copies are accounted for."""
    from isle_tpu_torch.streaming import ChunkLoader

    corpus, _ = _exact_corpus()
    loader = ChunkLoader(corpus, 1500, dev)
    assert len(loader.ranges) >= 5 and len(loader._slots) == 2
    docs = corpus.doc_ids()
    for _ in range(2):  # a second pass reuses the buffers
        seen = 0
        for lo, hi, w, v, d in loader.chunks():
            a, b = int(corpus.offsets[lo]), int(corpus.offsets[hi])
            assert a == seen and w.is_cuda and v.is_cuda and d.is_cuda
            np.testing.assert_array_equal(w.cpu().numpy(), corpus.rows[a:b])
            np.testing.assert_array_equal(v.cpu().numpy(), corpus.vals[a:b])
            np.testing.assert_array_equal(d.cpu().numpy(), docs[a:b])
            seen = b
        assert seen == corpus.nnz
    lo, hi = loader.ranges[2]
    w, v, d = loader.load(lo, hi)
    a, b = int(corpus.offsets[lo]), int(corpus.offsets[hi])
    np.testing.assert_array_equal(w.cpu().numpy(), corpus.rows[a:b])
    assert loader.bytes_copied == (
        corpus.offsets.nbytes + 8 * (2 * corpus.nnz + b - a))
    assert loader.copy_wait_ms() >= 0.0 and loader.host_wait_seconds >= 0.0


@pytest.mark.parametrize("sampled", [False, True])
def test_streamed_trainer_on_the_card(dev, tmp_path, sampled):
    """The out-of-core trainer on the card against the in-core trainer on
    the card, same seed: ζ, B's docs, clusters, catchwords and top-two
    topics exactly (the corpus's masses are exact in float32), the model
    within rtol 1e-4; every streamed accumulation launched a kernel."""
    from isle_tpu_torch import GpuConfig, TrainConfig, Trainer
    from isle_tpu_torch.streaming import StreamedTrainer

    corpus, k = _exact_corpus()
    cfg = TrainConfig(num_topics=k, seed=2, compute_edge_topics=True,
                      max_edge_topics=8, sample_docs=sampled,
                      sample_rate=0.6 if sampled else 0.0)
    gpu = GpuConfig(device="cuda")
    ref = Trainer(cfg, output_dir=str(tmp_path / "incore"), quiet=True,
                  gpu=gpu)
    ref.load_corpus(corpus)
    ref.train()
    got = StreamedTrainer(cfg, output_dir=str(tmp_path / "streamed"),
                          chunk_entries=1500, gpu=gpu)
    got.load_corpus(corpus)
    segsum.reset_launch_counts()
    got.train()
    counts = segsum.launch_counts()
    chunks = len(got.loader.ranges)
    assert chunks >= 5
    # the histogram and the mass (and the sampling weights) a chunk each
    assert counts["segsum_onehot"] >= (3 if sampled else 2) * chunks, counts
    # the model accumulation a chunk each, besides the SpMMs
    assert counts["segsum_gather_rows"] >= chunks + 2, counts
    np.testing.assert_array_equal(got.original_cols, ref.original_cols)
    np.testing.assert_array_equal(got.cluster_of_doc, ref.cluster_of_doc)
    for a, b in zip(got.catchwords, ref.catchwords):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.top_pairs, ref.top_pairs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.evalues, ref.evalues, rtol=1e-4)
    np.testing.assert_allclose(got.model, ref.model, rtol=1e-4, atol=1e-6)
    # and the in-core trainer finishes the streamed run's checkpoints
    import os
    os.remove(os.path.join(got.run_dir, "ckpt_model.npz"))
    back = Trainer(cfg, output_dir=str(tmp_path / "streamed"), quiet=True,
                   gpu=gpu)
    back.load_corpus(corpus)
    back.train(resume=True)
    np.testing.assert_allclose(back.model, got.model, rtol=1e-5, atol=1e-7)


def test_lanczos_on_the_card_matches_the_cpu(dev, tmp_path):
    """eigensolver="lanczos" on the card (width-1 launches of the gather
    kernel) against the CPU: eigenvalues within rtol 1e-4, the same
    clusters."""
    from isle_tpu_torch import GpuConfig, HyperParams, TrainConfig, Trainer

    corpus, k = _exact_corpus()
    cfg = TrainConfig(num_topics=k, seed=2,
                      hyper=HyperParams(eigensolver="lanczos"))
    runs = {}
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg, output_dir=str(tmp_path / device), quiet=True,
                     gpu=GpuConfig(device=device))
        tr.load_corpus(corpus)
        before = segsum.segsum_gather_rows.launches
        tr.train()
        if device == "cuda":
            assert segsum.segsum_gather_rows.launches - before >= \
                2 * tr.op_counter.calls
        runs[device] = tr
    g, c = runs["cuda"], runs["cpu"]
    assert g.op_counter.calls == c.op_counter.calls > 0
    np.testing.assert_allclose(g.evalues, c.evalues, rtol=1e-4)
    np.testing.assert_array_equal(g.cluster_of_doc, c.cluster_of_doc)
    np.testing.assert_allclose(g.model, c.model, rtol=1e-4, atol=1e-6)
