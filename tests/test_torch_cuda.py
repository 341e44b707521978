"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a CUDA device:
the kernels have no CPU mode. The card's host has no jax, and
tests/conftest.py imports it, so run this file there without the
conftest:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py

Counts must be exactly equal; float32 sums within rtol 1e-5, atol 1e-6
(the onehot kernel's atomics add in another order on every run; the gather
kernel sums in a fixed order of its own, other than the plain version's).
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


@pytest.mark.parametrize("layout", ["one_run", "all_distinct", "spill_only"])
def test_extreme_streams(dev, layout):
    """One run across every chunk edge (the gather kernel's carries at
    both ends of every slice), a new segment at every entry, and a stream
    that is all spill row; a tenth of the gather indices lie outside the
    table."""
    n, S, k, W = 5000, 6000, 3, 40
    rng = np.random.default_rng(1)
    seg = {"one_run": np.full(n, 17), "all_distinct": np.arange(n),
           "spill_only": np.full(n, S)}[layout].astype(np.int32)
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


def test_trainer_on_the_card_matches_the_cpu(dev, tmp_path):
    """The whole slice on the card (both kernels launched) against the same
    slice on the CPU with the plain versions."""
    from isle_tpu_torch import Corpus, GpuConfig, TrainConfig, Trainer

    rng = np.random.default_rng(0)
    V, D, k = 300, 600, 5
    d = np.repeat(np.arange(D), 25)
    w = np.where(rng.random(d.size) < 0.7,
                 rng.integers(0, V // k, d.size) + (d % k) * (V // k),
                 rng.integers(0, V, d.size))
    key = np.unique(d * V + w)
    corpus = Corpus.from_entries(key // V, key % V,
                                 rng.integers(1, 6, key.size),
                                 vocab_size=V, num_docs=D)
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
    np.testing.assert_allclose(g.edge_model, c.edge_model, rtol=1e-4,
                               atol=1e-6)


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
