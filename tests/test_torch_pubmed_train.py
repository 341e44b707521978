"""What training at UCI PubMed's scale-test deployment (sampling 0.1, up
to 2000 edge topics) asks of the port. The spans and counters of the
importance sampling of documents and of the hybrid split
(isle_tpu_torch/bmatrix.py, hybrid.py, trainer.py): a sampled in-core
job records the sampling's spans inside the B stage, the sampled docs'
count, B's and the head's entries and the edge topics built; an
unsampled job records no sampling span. The edge vectors
(topic_model.edge_vectors): numpy's on the CPU, and on the card the same
bits (run there: python3 -m pytest --noconftest -q
tests/test_torch_pubmed_train.py -m cuda)."""

import numpy as np
import pytest
import torch

from isle_tpu_torch import bmatrix, obs
from isle_tpu_torch.config import GpuConfig, TrainConfig
from isle_tpu_torch.corpus import Corpus
from isle_tpu_torch.synth import synth_corpus
from isle_tpu_torch.topic_model import construct_edge_topics_v2, \
    edge_vectors
from isle_tpu_torch.trainer import Trainer

SAMPLE_SPANS = {"sample: doc weights", "sample: race"}
B_STAGE = {True: "creating thresholded matrix (fused hybrid)",
           False: "creating thresholded and scaled matrix"}


def _names(timer):
    return {name for name, *_ in timer.spans}


def _corpus():
    d, w, c = synth_corpus(400, 600, 12000, seed=3)
    return Corpus.from_entries(d, w, c, vocab_size=400, num_docs=600)


def _train(tmp_path, sample, hybrid=True):
    """A tiny in-core job; returns (trainer, the masks dice_select
    returned, nnz(B) as the job logged it)."""
    masks, info = [], []
    real = bmatrix.dice_select

    def spy(*args, **kw):
        sel = real(*args, **kw)
        masks.append(sel)
        return sel

    cfg = TrainConfig(num_topics=8, seed=2, compute_edge_topics=True,
                      max_edge_topics=10, sample_docs=sample,
                      sample_rate=0.3 if sample else 0.0)
    gpu = GpuConfig(device="cpu") if hybrid else GpuConfig(
        device="cpu", dense_head_bytes=0)
    tr = Trainer(cfg, output_dir=str(tmp_path), quiet=True, gpu=gpu)
    tr.logger.add_sink("info", info.append)
    bmatrix.dice_select = spy
    try:
        tr.load_corpus(_corpus())
        tr.train()
        tr.train_edge_topics()
    finally:
        bmatrix.dice_select = real
    nnz_b = [int(m.split("nnz(B): ")[1].split()[0]) for m in info
             if "nnz(B): " in m]
    return tr, masks, nnz_b[-1]


@pytest.fixture(scope="module")
def sampled(tmp_path_factory):
    return _train(tmp_path_factory.mktemp("sampled"), True)


@pytest.fixture(scope="module")
def unsampled(tmp_path_factory):
    return _train(tmp_path_factory.mktemp("unsampled"), False)


def test_a_sampled_job_records_the_sampling_spans_in_the_b_stage(sampled):
    tr, _, _ = sampled
    t = tr.timer
    assert SAMPLE_SPANS <= _names(t)
    for name, parent, start, end in t.spans:
        if name in SAMPLE_SPANS:
            assert parent == B_STAGE[True] and start <= end
    assert [n for n, *_ in t.spans].count("sample: race") == 1


def test_sampled_docs_is_the_count_of_the_race_mask(sampled):
    tr, masks, _ = sampled
    (mask,) = masks
    n = int(mask.sum())
    assert tr.timer.counters["sampled docs"] == n
    # every doc of B was sampled; a sampled doc left empty is not in B
    assert 0 < len(tr.original_cols) <= n < tr.corpus.num_docs
    assert bool(mask[torch.as_tensor(tr.original_cols).long()].all())


def test_the_head_carries_part_of_b(sampled):
    tr, _, nnz_b = sampled
    c = tr.timer.counters
    assert c["B nnz"] == nnz_b > 0
    assert 0 < c["hybrid head nnz"] <= c["B nnz"]


def test_edge_topics_counts_the_edge_models_columns(sampled, unsampled):
    for tr, _, _ in (sampled, unsampled):
        assert tr.timer.counters["edge topics"] == tr.edge_model.shape[1] > 0
        assert "edge topics: build" in _names(tr.timer)


def test_an_unsampled_job_records_no_sampling_span(unsampled):
    tr, masks, nnz_b = unsampled
    t = tr.timer
    assert masks == []
    assert not any(n.startswith("sample:") for n in _names(t))
    assert "sampled docs" not in t.counters
    assert t.counters["B nnz"] == nnz_b
    assert t.counters["hybrid head nnz"] <= nnz_b


def test_the_coo_layout_samples_with_spans_and_splits_nothing(tmp_path):
    tr, masks, _ = _train(tmp_path, True, hybrid=False)
    t = tr.timer
    assert SAMPLE_SPANS <= _names(t)
    assert {p for n, p, *_ in t.spans if n in SAMPLE_SPANS} == {B_STAGE[False]}
    assert t.counters["sampled docs"] == int(masks[0].sum())
    assert "B nnz" not in t.counters and "hybrid head nnz" not in t.counters


@pytest.mark.parametrize("timer", [None, "timer", "lines"])
def test_dice_select_counts_only_into_a_timer(timer):
    class Lines:  # a timer= that only takes diagnostic lines
        def diag(self, msg):
            pass

    t = {None: None, "timer": obs.Timer(), "lines": Lines()}[timer]
    weights = torch.tensor([2.0, 0.0, 1.0, 4.0, 3.0, 1.0])
    u = torch.tensor([0.25, 0.9, 0.5, 0.0625, 0.7, 0.2])
    sel = bmatrix.dice_select(weights, 0.5, u, timer=t)
    plain = bmatrix.dice_select(weights, 0.5, u)
    assert torch.equal(sel, plain) and int(sel.sum()) >= 4
    assert not bool(sel[1])  # a doc of no weight has dice 0
    if timer == "timer":
        assert t.counters == {"sampled docs": int(sel.sum())}
        assert _names(t) == {"sample: race"}


def test_threshold_and_copy_passes_its_timer_to_the_sampling():
    corpus = _corpus()
    from isle_tpu_torch.sparse import DocSparse

    A = DocSparse.from_corpus(corpus, "cpu")
    zetas = torch.ones(corpus.vocab_size)
    u = torch.rand(corpus.num_docs, generator=torch.Generator().manual_seed(1))
    t = obs.Timer()
    B, cols = bmatrix.threshold_and_copy(A, zetas, sample_rate=0.2,
                                         uniforms=u, timer=t)
    B0, cols0 = bmatrix.threshold_and_copy(A, zetas, sample_rate=0.2,
                                           uniforms=u)
    assert np.array_equal(cols, cols0) and B.nnz == B0.nnz
    assert _names(t) == SAMPLE_SPANS
    assert t.counters["sampled docs"] >= len(cols) > 0


# -- the edge vectors ---------------------------------------------------------

def _model(vocab=3000, k=100, seed=0):
    g = torch.Generator().manual_seed(seed)
    m = torch.rand(vocab, k, generator=g, dtype=torch.float64) ** 4
    return (m / m.sum(dim=0)).to(torch.float32).numpy()


def _pairs(k=100, n=2000, seed=1):
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(k, (n,), generator=g)
    b = (a + 1 + torch.randint(k - 1, (n,), generator=g)) % k
    return a.numpy().astype(np.int32), b.numpy().astype(np.int32)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_edge_vectors_off_the_card_are_numpys_float32_sum(device):
    model = _model()
    a, b = _pairs()
    edge = edge_vectors(model, a, b, 0.7, device)
    want = (np.float32(0.7) * model[:, a]
            + np.float32(0.3) * model[:, b]).astype(np.float32)
    assert edge.dtype == np.float32
    assert np.array_equal(edge, want)


def test_construct_edge_topics_v2_takes_a_device():
    model = _model(400, 8)
    t1 = np.array([0, 0, 0, 1, 2, 2, 5], np.int32)
    t2 = np.array([1, 1, 2, 0, 3, 3, 6], np.int32)
    valid = np.array([True, True, True, True, True, False, True])
    edge, sel = construct_edge_topics_v2(t1, t2, valid, model, 8, 3,
                                         device=torch.device("cpu"))
    edge0, sel0 = construct_edge_topics_v2(t1, t2, valid, model, 8, 3)
    assert np.array_equal(sel, sel0) and np.array_equal(edge, edge0)
    assert edge.shape == (400, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("vocab,n", [(3000, 7), (141043, 2000)])
def test_edge_vectors_on_the_card_are_numpys_bits(vocab, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card's path of edge_vectors)")
    model = _model(vocab)
    a, b = _pairs(n=n)
    for ratio in (0.7, 0.55):
        edge = edge_vectors(model, a, b, ratio, torch.device("cuda"))
        plain = edge_vectors(model, a, b, ratio)
        assert edge.dtype == plain.dtype and edge.shape == plain.shape
        assert np.array_equal(edge, plain)
