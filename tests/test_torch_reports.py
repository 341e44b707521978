"""The diagnostic reports, the preprocessed ingest, edge topics v1 and the
handle API of the port, against isle_tpu on the golden corpus of
tests/torch_parity.py.

Both trainers train the same corpus with the same draws (block_ks, block
size 8) and write every report. Files whose content is integers, corpus
values or words are byte-equal; files of float sums (the doc-topic
catchword sums, M_hat_avg, the spectrum of A) are compared as numbers,
within the tolerance stated at each test: the two packages add float32
values in another order."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isle_tpu import capi as jcapi
from isle_tpu import preprocessed as jpre
from isle_tpu import sparse as jsp
from isle_tpu import topic_model as jtm
from isle_tpu.config import HyperParams, TrainConfig
from isle_tpu.trainer import Trainer as JaxTrainer
from isle_tpu_torch import capi, preprocessed, topic_model
from isle_tpu_torch.config import GpuConfig
from isle_tpu_torch.corpus import Corpus
from isle_tpu_torch.sparse import DocSparse
from isle_tpu_torch.trainer import Trainer
from torch_parity import REFERENCE_TPU, JaxDraws, biting_corpus, \
    golden_corpus

CPU = GpuConfig(device="cpu", dense_head_bytes=0)  # as REFERENCE_TPU
K = 5


def _write_reports(tr):
    tr.train_edge_topics()
    tr.write_model_to_file()
    tr.write_edgemodel_to_file()
    tr.output_doc_topic()
    tr.print_top_two_topics()
    tr.print_log_combinatorial()
    tr.print_distinct_top_five_sets()
    return dict(coherence=tr.output_avg_topic_coherence(),
                spectrum=tr.compute_input_svd())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reports")
    corpus = golden_corpus()
    cfg = TrainConfig(num_topics=K, seed=0, compute_edge_topics=True,
                      max_edge_topics=6, tpu=REFERENCE_TPU,
                      hyper=HyperParams(block_ks_block_size=8))
    ref = JaxTrainer(cfg, output_dir=str(tmp / "jax"), quiet=True)
    ref.corpus = corpus
    ref._post_ingest()
    got = Trainer(cfg, output_dir=str(tmp / "torch"), quiet=True, gpu=CPU,
                  draws=JaxDraws(cfg.seed))
    got.load_corpus(corpus)
    out = {}
    for name, tr in (("ref", ref), ("got", got)):
        tr.logs = []
        tr.logger.add_sink("info", tr.logs.append)
        tr.train()
        out[name] = _write_reports(tr)
    for a, b in zip(got.catchwords, ref.catchwords):
        np.testing.assert_array_equal(a, b)
    return got, ref, out


def _read(tr, name):
    with open(os.path.join(tr.run_dir, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", [
    "DocCatchword.tsv", "TopTwoTopicsPerDoc.txt", "LogCombinatorial.txt",
    "TopWordsPerTopic_avg.txt", "TopWordsPerTopic_catch.txt",
    "EdgeTopicComposition.txt",
])
def test_report_files_byte_equal(runs, name):
    got, ref, _ = runs
    assert _read(got, name) == _read(ref, name) and len(_read(got, name)) > 0


def test_doc_topic_catchword_sums(runs):
    """The same (doc, topic) pairs; sums within rtol 1e-5 (float32 sums in
    another order)."""
    got, ref, _ = runs
    g, r = (np.loadtxt(os.path.join(t.run_dir, "DocTopicCatchwordSums.tsv"),
                       ndmin=2) for t in (got, ref))
    assert g.shape == r.shape and len(g) > 0
    g, r = (x[np.lexsort((x[:, 0], x[:, 1]))] for x in (g, r))
    np.testing.assert_array_equal(g[:, :2], r[:, :2])
    np.testing.assert_allclose(g[:, 2], r[:, 2], rtol=1e-5)
    assert np.all(np.diff(g[:, 1]) >= 0)


def test_m_hat_avg(runs):
    """The dense dump of the catchword-free model within 1e-5, one row of
    vocab weights per topic."""
    got, ref, _ = runs
    g, r = (np.loadtxt(os.path.join(t.run_dir, "M_hat_avg"), ndmin=2)
            for t in (got, ref))
    assert g.shape == (K, got.corpus.vocab_size)
    np.testing.assert_allclose(g, r, atol=1e-5)
    np.testing.assert_allclose(g.sum(axis=1), 1.0, atol=1e-5)


def test_avg_topic_coherence(runs):
    _, _, out = runs
    (g_avg, g_all), (r_avg, r_all) = (out[n]["coherence"]
                                      for n in ("got", "ref"))
    np.testing.assert_allclose(g_all, r_all, rtol=1e-5)
    assert g_avg == pytest.approx(r_avg, rel=1e-5) and len(g_all) == K


def test_input_svd_spectrum(runs):
    """A_squared_spectrum.txt within rtol 1e-4 (block_ks at tolerance 1e-4
    from other start blocks: the port draws its own for seed + 1)."""
    got, ref, out = runs
    g, r = (np.loadtxt(os.path.join(t.run_dir, "A_squared_spectrum.txt"))
            for t in (got, ref))
    assert g.shape == (K,) and np.all(np.diff(g) <= 0)
    np.testing.assert_allclose(g, r, rtol=1e-4)
    np.testing.assert_allclose(out["got"]["spectrum"], g, rtol=1e-6)


def test_distinct_top_five_and_log_lines(runs):
    got, ref, _ = runs
    for prefix in ("Distinct top five sets:", "Total number of catchwords:"):
        g, r = ([m for m in t.logs if m.startswith(prefix)]
                for t in (got, ref))
        assert g == r and len(g) == 1


def test_get_model_and_edge_model(runs, tmp_path):
    got, ref, _ = runs
    assert got.get_model() is got.model
    np.testing.assert_allclose(got.get_model(), ref.get_model(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got.get_edge_model(), ref.get_edge_model(),
                               rtol=1e-4, atol=1e-6)
    fresh = Trainer(got.config, output_dir=str(tmp_path), quiet=True,
                    gpu=CPU)
    assert fresh.get_edge_model() is None
    with pytest.raises(RuntimeError, match="train first"):
        fresh.get_model()


def test_reports_share_one_upload(runs):
    got, _, _ = runs
    A = got._device_A()
    got.output_avg_topic_coherence()
    got.compute_input_svd()
    assert got._device_A() is A


SIDECARS = ("_tr.info", "_tr.csr", "_tr.col", "_tr.off", ".csr", ".col",
            ".off")


def test_preprocessed_round_trip(tmp_path):
    corpus = biting_corpus()
    prefix = str(tmp_path / "pp")
    preprocessed.save_preprocessed(corpus, prefix)
    back = preprocessed.load_preprocessed(prefix)
    assert isinstance(back, Corpus) and back.counts is None
    for f in ("vocab_size", "num_docs", "avg_doc_sz", "nz_docs", "nnz"):
        assert getattr(back, f) == getattr(corpus, f), f
    for f in ("offsets", "rows", "vals"):
        np.testing.assert_array_equal(getattr(back, f), getattr(corpus, f))


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_preprocessed_cross_package(tmp_path, saver):
    """Either package loads what the other saved, and both write the same
    bytes."""
    corpus = biting_corpus()
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    preprocessed.save_preprocessed(corpus, ours)
    jpre.save_preprocessed(corpus, theirs)
    for ext in SIDECARS:
        with open(ours + ext, "rb") as a, open(theirs + ext, "rb") as b:
            assert a.read() == b.read(), ext
    if saver == "port":
        back = jpre.load_preprocessed(ours)
    else:
        back = preprocessed.load_preprocessed(theirs)
    for f in ("offsets", "rows", "vals"):
        np.testing.assert_array_equal(getattr(back, f), getattr(corpus, f))
    assert back.avg_doc_sz == corpus.avg_doc_sz


def test_trainer_load_preprocessed(tmp_path):
    """Training from the sidecars gives the model of the run on the corpus
    itself (the raw counts, absent from the artifact, are not needed)."""
    corpus = biting_corpus()
    prefix = str(tmp_path / "pp")
    preprocessed.save_preprocessed(corpus, prefix)
    cfg = TrainConfig(num_topics=4, seed=3,
                      hyper=HyperParams(block_ks_block_size=8))
    a = Trainer(cfg, output_dir=str(tmp_path / "a"), quiet=True, gpu=CPU)
    a.load_preprocessed(prefix)
    a.train()
    b = Trainer(cfg, output_dir=str(tmp_path / "b"), quiet=True, gpu=CPU)
    b.load_corpus(corpus)
    b.train()
    np.testing.assert_array_equal(a.model, b.model)
    with pytest.raises(ValueError, match="raw counts unavailable"):
        a.print_log_combinatorial()


def test_edge_topics_v1_literal():
    """The example of tests/test_variants.py."""
    w = np.array([0, 1, 2, 3, 4, 5], np.int32)
    d = np.array([0, 0, 1, 2, 3, 4], np.int32)
    v = torch.ones(6)
    tw, td = torch.from_numpy(w), torch.from_numpy(d)
    A = DocSparse(d_word=tw, d_doc=td, d_val=v, w_word=tw, w_doc=td,
                  w_val=v, vocab=6, num_docs=5)
    t1 = np.array([0, 0, 1, 2, 2], np.int32)
    t2 = np.array([1, 1, 2, 0, 0], np.int32)
    valid = np.array([True, True, True, True, False])
    edge, sel = topic_model.construct_edge_topics_v1(A, t1, t2, valid, None,
                                                     3, 2)
    np.testing.assert_array_equal(sel, [[0, 1, 2], [1, 2, 1]])
    np.testing.assert_allclose(edge[:, 0], [0.5, 0.5, 0.5, 0, 0, 0])
    np.testing.assert_allclose(edge[:, 1], [0, 0, 0, 1, 0, 0])


@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_edge_topics_v1_matches_jax(seed, mapped):
    """Random top-two pairs on the biting corpus: the selected pairs
    exactly, the doc-average edge vectors within 1e-5."""
    corpus = biting_corpus()
    rng = np.random.default_rng(seed)
    D, k = corpus.num_docs, 5
    n = D // 2 if mapped else D
    ids = np.sort(rng.choice(D, n, replace=False)) if mapped else None
    t1 = rng.integers(0, k, n).astype(np.int32)
    t2 = ((t1 + rng.integers(1, k, n)) % k).astype(np.int32)
    valid = rng.random(n) < 0.8
    JA = jsp.DocSparse.from_corpus(corpus, chunk=256)
    ref_edge, ref_sel = jtm.construct_edge_topics_v1(
        JA, t1, t2, valid, ids, k, 7, min_docs=2)
    edge, sel = topic_model.construct_edge_topics_v1(
        DocSparse.from_corpus(corpus, "cpu"), t1, t2, valid, ids, k, 7,
        min_docs=2)
    np.testing.assert_array_equal(sel, ref_sel)
    assert edge.shape == (corpus.vocab_size, 7) and edge.dtype == np.float32
    np.testing.assert_allclose(edge, ref_edge, atol=1e-5)


def _feed(api, h, V, D, k, seed=2):
    rng = np.random.default_rng(seed)
    block = V // k
    for d in range(D):
        t = d % k
        ws = np.unique(np.concatenate([
            rng.integers(t * block, (t + 1) * block, 8),
            rng.integers(0, V, 2)])) + 1
        api.feedData(h, d, ws, rng.integers(1, 4, len(ws)), len(ws))
    api.finalizeData(h)


@pytest.mark.parametrize("edges", [False, True])
def test_capi_round_trip(tmp_path, edges):
    """create -> feed -> train -> get model -> destroy on the CPU, with
    and without edge topics; the buffers are topic after topic."""
    V, D, k = 40, 120, 3
    logs = []
    h = capi.CreateTrainer(V, D, k, output_dir=str(tmp_path), seed=0,
                           compute_edge_topics=edges, max_edge_topics=4,
                           log_callback=logs.append, device="cpu")
    assert isinstance(h, int)
    _feed(capi, h, V, D, k)
    capi.Train(h)
    model = capi.GetBasicModel(h)
    assert model.shape == (V * k,) and model.dtype == np.float32
    np.testing.assert_allclose(model.reshape(k, V).sum(axis=1), 1.0,
                               rtol=1e-4)
    tr = capi._handles[h]
    np.testing.assert_array_equal(model.reshape(k, V).T, tr.model)
    assert tr.device.type == "cpu" and len(logs) > 0
    n = capi.GetNumEdgeTopics(h)
    if edges:
        assert 0 < n <= 4
        em = capi.GetEdgeModel(h)
        np.testing.assert_array_equal(em.reshape(n, V).T, tr.edge_model)
    else:
        assert n == 0 and capi.GetEdgeModel(h) is None
    capi.DestroyTrainer(h)
    assert h not in capi._handles
    capi.DestroyTrainer(h)  # a second destroy is a no-op
    with pytest.raises(KeyError):
        capi.GetBasicModel(h)


def test_capi_surface_matches_jax():
    """The same entry points with the same leading arguments; the port
    adds `device`."""
    import inspect

    names = [n for n in dir(jcapi) if n[0].isupper() or n in (
        "feedData", "finalizeData")]
    names = [n for n in names if inspect.isfunction(getattr(jcapi, n))]
    assert len(names) == 8
    for n in names:
        ours = list(inspect.signature(getattr(capi, n)).parameters)
        theirs = list(inspect.signature(getattr(jcapi, n)).parameters)
        assert ours[:len(theirs)] == theirs, n
        assert ours[len(theirs):] == (["device"] if n == "CreateTrainer"
                                      else []), n
