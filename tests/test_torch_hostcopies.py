"""The port's own copies of isle_tpu's host modules (config, corpus,
native, io_text, diagnostics) and of bench.py's synthetic corpus, held
against the originals on the same inputs: the same fields and defaults,
equal arrays, byte-identical files."""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

from isle_tpu import config as jconfig
from isle_tpu import corpus as jcorpus
from isle_tpu import diagnostics as jdiag
from isle_tpu import io_text as jio
from isle_tpu import native as jnative
from isle_tpu_torch import config, corpus, diagnostics, io_text, native, \
    synth

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _fields(cls):
    return {f.name: (f.default, f.default_factory)
            for f in dataclasses.fields(cls) if f.name != "tpu"}


@pytest.mark.parametrize("name", ["HyperParams", "TrainConfig",
                                  "InferConfig"])
def test_config_fields_and_defaults(name):
    ours, ref = getattr(config, name), getattr(jconfig, name)
    assert "tpu" not in {f.name for f in dataclasses.fields(ours)}
    got, want = _fields(ours), _fields(ref)
    assert list(got) == list(want)
    for k, (default, factory) in want.items():
        if factory is dataclasses.MISSING:
            assert got[k][0] == default, k
        else:  # hyper: a default-constructed HyperParams on both sides
            assert dataclasses.asdict(got[k][1]()) == \
                dataclasses.asdict(factory())


@pytest.mark.parametrize("kw", [
    dict(num_topics=100),
    dict(num_topics=7, sample_docs=True, sample_rate=0.25, tf_idf=True,
         seed=11, hyper=dict(eps1=0.02, rho=1.3, eps3=4.0)),
])
def test_config_methods(kw):
    hyper = kw.pop("hyper", {})
    ours = config.TrainConfig(**kw, hyper=config.HyperParams(**hyper))
    ref = jconfig.TrainConfig(**kw, hyper=jconfig.HyperParams(**hyper))
    assert ours.log_dir_name() == ref.log_dir_name()
    for args in ((5_000, 7), (300_000, 100), (17, 3)):
        for m in ("count_gr", "count_eq", "catchword_rank",
                  "model_rank_threshold"):
            assert getattr(ours.hyper, m)(*args) == \
                getattr(ref.hyper, m)(*args), m
    assert ours.hyper.catchword_rank(1000, 10, 0.5) == \
        ref.hyper.catchword_rank(1000, 10, 0.5)
    oi, ri = (m.InferConfig(num_topics=4, vocab_size=9, iters=3)
              for m in (config, jconfig))
    assert (oi.resolved_iters(), oi.resolved_Lf()) == \
        (ri.resolved_iters(), ri.resolved_Lf())


def _entries(seed, n=4000, V=300, D=200):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, D, n)
    w = rng.integers(0, V, n)
    c = rng.integers(1, 9, n)
    return d, w, c  # unsorted, with duplicate (doc, word) pairs


def _same_corpus(a, b):
    for f in ("vocab_size", "num_docs", "avg_doc_sz", "nz_docs"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("offsets", "rows", "counts", "vals"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert np.array_equal(a.doc_ids(), b.doc_ids())


@pytest.mark.parametrize("opts", [
    dict(), dict(normalize_to_one=True), dict(tf_idf=True),
    dict(int_normalized=True), dict(vocab_size=400, num_docs=250),
])
def test_corpus_from_entries(opts):
    d, w, c = _entries(1)
    _same_corpus(corpus.Corpus.from_entries(d, w, c, **opts),
                 jcorpus.Corpus.from_entries(d, w, c, **opts))


@pytest.mark.parametrize("opts", [
    dict(), dict(max_entries=1500, normalize_to_one=True),
    dict(doc_base_offset=3, num_docs=210),
])
def test_corpus_from_tdf_file(tmp_path, opts):
    d, w, c = _entries(2)
    path = str(tmp_path / "c.tdf")
    with open(path, "w") as f:
        for x in zip(d + 4, w + 1, c):
            f.write("%d %d %d\n" % x)
    assert all(np.array_equal(a, b) for a, b in zip(
        native.parse_tdf(path), jnative.parse_tdf(path)))
    _same_corpus(corpus.Corpus.from_tdf_file(path, **opts),
                 jcorpus.Corpus.from_tdf_file(path, **opts))


def test_entry_feeder_and_vocab_file(tmp_path):
    d, w, c = _entries(3, n=600)
    feeders = corpus.EntryFeeder(), jcorpus.EntryFeeder()
    for doc in np.unique(d):
        m = d == doc
        for fd in feeders:
            fd.feed(int(doc), w[m] + 1, c[m])
    _same_corpus(*(fd.finalize(vocab_size=300) for fd in feeders))
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("alpha\nbeta\n gamma \n")
    for n in (2, 5):
        assert corpus.read_vocab_file(str(vocab), n) == \
            jcorpus.read_vocab_file(str(vocab), n)
    assert corpus.read_vocab_file(str(tmp_path / "none"), 3) == \
        jcorpus.read_vocab_file(str(tmp_path / "none"), 3)


def _model(seed, V=60, k=5):
    rng = np.random.default_rng(seed)
    m = rng.random((V, k)).astype(np.float32)
    m[m < 0.5] = 0.0
    return m / np.maximum(m.sum(axis=0, keepdims=True), 1e-30)


def _write_both(tmp_path, name, write):
    """Writes with the port's modules and with isle_tpu's; returns both
    files' bytes."""
    out = []
    for tag, mods in (("ours", (io_text, native)), ("ref", (jio, jnative))):
        path = tmp_path / f"{name}.{tag}"
        write(str(path), *mods)
        out.append(path.read_bytes())
    return out


@pytest.mark.parametrize("writer", [
    "sparse_model", "top_words", "top_topics", "edge_composition",
    "float_triples", "int_triples",
])
def test_writers_are_byte_identical(tmp_path, writer):
    model = _model(4)
    rng = np.random.default_rng(5)
    weights = rng.dirichlet(np.ones(5), size=40).astype(np.float32)
    conv = rng.random(40) < 0.8
    a, b = rng.integers(0, 50, 30), rng.integers(0, 9, 30)
    v = rng.random(30).astype(np.float32)
    pairs = np.array([[1, 2, 5], [0, 3, 2]])
    words = [f"w{i}" for i in range(60)]
    write = {
        "sparse_model": lambda p, io, nv: io.write_sparse_model(p, model),
        "top_words": lambda p, io, nv: io.write_top_words(p, model, words, 7),
        "top_topics": lambda p, io, nv: io.write_top_topics(
            p, weights, conv, doc_begin=11, top_n=3),
        "edge_composition": lambda p, io, nv: io.write_edge_composition(
            p, pairs),
        "float_triples": lambda p, io, nv: nv.write_float_triples(
            p, a, b, v, base_a=0),
        "int_triples": lambda p, io, nv: nv.write_int_triples(p, a, b, b),
    }[writer]
    ours, ref = _write_both(tmp_path, writer, write)
    assert ours == ref and len(ours) > 0


def test_sparse_model_round_trip(tmp_path):
    model = _model(6)
    path = str(tmp_path / "M")
    io_text.write_sparse_model(path, model)
    got = io_text.load_sparse_model(path, 5, 60)
    assert np.array_equal(got, jio.load_sparse_model(path, 5, 60))
    np.testing.assert_allclose(got, model, atol=1e-9)
    assert io_text.top_words_per_topic(model, 4) == \
        jio.top_words_per_topic(model, 4)


def test_diagnostics_match():
    d, w, c = _entries(7, n=3000, V=60, D=150)
    ours = corpus.Corpus.from_entries(d, w, c, vocab_size=60)
    ref = jcorpus.Corpus.from_entries(d, w, c, vocab_size=60)
    model = _model(8)
    assert np.array_equal(diagnostics.topic_coherence(ours, model, 5),
                          jdiag.topic_coherence(ref, model, 5))
    assert diagnostics.topic_diversity(model) == \
        jdiag.topic_diversity(model)


@pytest.mark.parametrize("seed", [0, 5])
def test_synth_corpus_matches_bench(seed):
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    got = synth.synth_corpus(2_000, 3_000, 60_000, seed)
    want = bench.synth_corpus(2_000, 3_000, 60_000, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
