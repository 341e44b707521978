"""The benchmark's inputs: the frozen generator against the port's copy,
and the normalized values against the port's Corpus functions."""

import numpy as np
import pytest
import torch

from conftest import SEED
from portbench.gen import hashed, inputs

SHAPES = [(3000, 4000, 120000), (141043, 2000, 60000), (102660, 1500, 90000)]


@pytest.mark.parametrize("vocab,docs,nnz", SHAPES)
@pytest.mark.parametrize("seed", [0, 7, SEED & 0xFFFFFFFF])
def test_frozen_generator_is_bit_equal_to_the_ports(vocab, docs, nnz, seed):
    from isle_tpu_torch import synth

    ours = hashed.synth_corpus_hashed(vocab, docs, nnz, seed, "cpu")
    theirs = synth.synth_corpus_hashed(vocab, docs, nnz, seed, "cpu")
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_gen_seed_folds_any_whole_number():
    assert inputs.gen_seed(SEED) == SEED & 0xFFFFFFFF
    assert inputs.gen_seed(-1) == 0xFFFFFFFF
    assert inputs.stream_seed(SEED, 0) != inputs.stream_seed(SEED, 1)


@pytest.mark.parametrize("seed", [3, SEED])
def test_normalized_values_equal_the_ports_corpus(seed):
    from isle_tpu_torch.synth import corpus_from_csc

    shape = dict(vocab=3000, docs=4000, nnz_target=120000)
    off, rows, counts = inputs.corpus_csc(shape, seed, "cpu")
    corpus = corpus_from_csc(off.numpy(), rows.numpy(), counts.numpy(),
                             shape["vocab"])
    train = inputs.normalized(off, counts, unit=False)
    assert np.array_equal(train["vals"].numpy(), corpus.vals)
    assert train["avg_doc_sz"] == corpus.avg_doc_sz
    assert train["nz_docs"] == corpus.nz_docs
    unit = inputs.normalized(off, counts, unit=True)
    assert np.array_equal(unit["vals"].numpy(),
                          corpus.normalized_to_one().vals)


def test_topic_model_is_column_stochastic_and_seeded():
    M = inputs.topic_model(3000, 10, SEED, "cpu")
    assert M.dtype == torch.float32 and M.shape == (3000, 10)
    assert torch.all(M >= 0)
    assert torch.allclose(M.double().sum(dim=0), torch.ones(10,
                                                            dtype=torch.float64),
                          atol=1e-6)
    empty = (M.sum(dim=1) == 0).double().mean()
    assert 0.005 < float(empty) < 0.05
    assert torch.equal(M, inputs.topic_model(3000, 10, SEED, "cpu"))
    assert not torch.equal(M, inputs.topic_model(3000, 10, SEED + 1, "cpu"))


def test_ranges_and_samples():
    ranges = inputs.doc_ranges(8_200_000, 10)
    assert ranges[0] == (0, 820_000) and ranges[-1][1] == 8_200_000
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    lengths = np.arange(100)[::-1]
    s = inputs.sample_docs(SEED, 500, 600, lengths, 20, 5, 3)
    assert np.all(np.diff(s) > 0) and s.min() >= 500 and s.max() < 600
    assert set(range(500, 505)) <= set(s.tolist())  # the longest docs
    assert np.array_equal(s, inputs.sample_docs(SEED, 500, 600, lengths,
                                                20, 5, 3))
