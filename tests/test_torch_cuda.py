"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a CUDA device:
the kernels have no CPU mode. The card's host has no jax, and
tests/conftest.py imports it, so run this file there without the
conftest:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py

Counts must be exactly equal; float32 sums within rtol 1e-5, atol 1e-6
(atomics add in another order on every run)."""

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
@pytest.mark.parametrize("W", [5, 100, 300])
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
    """One run across every chunk edge (only atomics at both ends), a new
    segment at every entry, and a stream that is all spill row."""
    n, S, k, W = 5000, 6000, 3, 40
    rng = np.random.default_rng(1)
    seg = {"one_run": np.full(n, 17), "all_distinct": np.arange(n),
           "spill_only": np.full(n, S)}[layout].astype(np.int32)
    col = rng.integers(0, k, n).astype(np.int32)
    val = rng.random(n).astype(np.float32)
    table = rng.random((50, W)).astype(np.float32)
    idx = rng.integers(0, 50, n).astype(np.int32)
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
    with pytest.raises(ValueError, match="chunk"):
        segsum.segsum_gather_rows(s, i, v, tb, S, chunk=8192)
    with pytest.raises(ValueError, match="table"):
        segsum.segsum_gather_rows(s, i, v, tb.cpu(), S)


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
