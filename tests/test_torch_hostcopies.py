"""The port's own copies of isle_tpu's host modules (config, corpus,
native, io_text, diagnostics, preprocessed, obs's Logger) and of
bench.py's synthetic corpus, held
against the originals on the same inputs: the same fields and defaults,
equal arrays, byte-identical files."""

import dataclasses
import importlib.util
import pathlib
import tracemalloc

import numpy as np
import pytest

from isle_tpu import config as jconfig
from isle_tpu import corpus as jcorpus
from isle_tpu import diagnostics as jdiag
from isle_tpu import io_text as jio
from isle_tpu import native as jnative
from isle_tpu import obs as jobs
from isle_tpu import preprocessed as jpre
from isle_tpu_torch import config, corpus, diagnostics, io_text, native, \
    obs, preprocessed, synth

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


@pytest.mark.parametrize("kind", ["float", "past 2^53", "negative"])
def test_corpus_from_entries_counts_of_every_kind(kind):
    """The assembly sums a doc's integer counts exactly only where
    isle_tpu's float64 cumsum is exact too; float counts, integer counts
    whose total passes 2^53 and negative counts take the cumsum, and
    every kind gives isle_tpu's corpus bit for bit."""
    d, w, c = native.sort_dedup_entries_plain(*_entries(3))
    last0 = int(np.searchsorted(d, 1)) - 1  # doc 0's last entry
    if kind == "float":
        c = c + 0.37
    else:
        # a first count of 2^60: the float64 cumsum drops the small counts
        # after it (with a last count of -2^60 in the same doc, doc 0's
        # uint64 total stays small)
        c = c.copy()
        c[0] = 2**60
        if kind == "negative":
            c[last0] = -(2**60)
    for opts in (dict(), dict(normalize_to_one=True),
                 dict(vocab_size=400, num_docs=250)):
        opts["sort_dedup"] = False  # the sort casts counts to int64
        with np.errstate(divide="ignore"):  # doc 0's float sum is 0
            _same_corpus(corpus.Corpus.from_entries(d, w, c, **opts),
                         jcorpus.Corpus.from_entries(d, w, c, **opts))


@pytest.mark.parametrize("opts", [
    dict(), dict(normalize_to_one=True), dict(tf_idf=True),
    dict(int_normalized=True), dict(vocab_size=400, num_docs=250),
])
def test_corpus_doc_sums_and_vals_match(opts):
    """Corpus.doc_sums (empty docs at 1.0 or another value) and
    Corpus.vals_match against isle_tpu's: the same sums bit for bit and the
    same verdict, for the training expression and for one that fails;
    without counts, vals_match is False on both."""
    d, w, c = _entries(1)
    keep = d % 7 != 3  # every seventh doc empty
    d, w, c = d[keep], w[keep], c[keep]
    ours = corpus.Corpus.from_entries(d, w, c, **opts)
    ref = jcorpus.Corpus.from_entries(d, w, c, **opts)
    assert (np.diff(ours.offsets) == 0).any()
    for empty in (1.0, 0.0):
        x, y = ours.doc_sums(empty), ref.doc_sums(empty)
        assert x.dtype == y.dtype and np.array_equal(x.view(np.int32),
                                                     y.view(np.int32))
    avg = np.float32(ours.avg_doc_sz)
    for fn in (lambda k, ds: avg * (k.astype(np.float32) / ds),
               lambda k, ds: k.astype(np.float32) / ds):
        assert ours.vals_match(fn) == ref.vals_match(fn)
    assert ours.vals_match(
        lambda k, ds: avg * (k.astype(np.float32) / ds)) == (
        not opts.get("normalize_to_one") and not opts.get("int_normalized"))
    none = dataclasses.replace(ours, counts=None)
    assert not none.vals_match(lambda k, ds: k)
    assert not dataclasses.replace(ref, counts=None).vals_match(
        lambda k, ds: k)


@pytest.mark.parametrize("in_order", [False, True])
@pytest.mark.parametrize("opts", [
    dict(), dict(max_entries=1500, normalize_to_one=True),
    dict(doc_base_offset=3, num_docs=210),
])
def test_corpus_from_tdf_file(tmp_path, opts, in_order):
    """The ingest (the parse rebasing in place, the sort in the parsed
    arrays or its check that they are in order, the assembly letting
    each array go) gives isle_tpu's corpus bit for bit, from a file in
    no order with duplicate pairs and from one in (doc, word) order."""
    d, w, c = _entries(2)
    if in_order:
        d, w, c = native.sort_dedup_entries_plain(d, w, c)
    path = str(tmp_path / "c.tdf")
    with open(path, "w") as f:
        for x in zip(d + 4, w + 1, c):
            f.write("%d %d %d\n" % x)
    assert all(np.array_equal(a, b) for a, b in zip(
        native.parse_tdf(path), jnative.parse_tdf(path)))
    lines = []
    _same_corpus(corpus.Corpus.from_tdf_file(path, log=lines.append, **opts),
                 jcorpus.Corpus.from_tdf_file(path, **opts))
    (line,) = lines
    assert line.startswith(f"ingest: text I/O {native.backend()}, parse ")
    assert line.endswith("; sort " + (
        "none needed (already sorted and unique, in place)" if in_order
        else "native radix sort (in place)"))


@pytest.mark.parametrize("in_order", [False, True])
def test_tdf_ingest_numpy_bytes_per_entry(tmp_path, in_order):
    """Corpus.from_tdf_file holds at its peak no more numpy bytes than the
    parse's three int64 arrays, 24 an entry, and a few arrays a doc: the
    parse rebases in place, the sort works in the parsed arrays (its
    indices, 8 bytes an entry, are the C library's), the assembly lets
    each array go once read, sums each doc's integer counts exactly
    without a float64 cumsum of them all, and divides a block of docs at
    a time. Copies of the parse, of the sort's input, of the offsets'
    doc ids and of the counts in float64 would take 72 an entry here."""
    n, D, V = 400_000, 5_000, 3_000
    rng = np.random.default_rng(5)
    d, w, c = rng.integers(0, D, n), rng.integers(0, V, n), \
        rng.integers(1, 9, n)
    if in_order:
        d, w, c = native.sort_dedup_entries_plain(d, w, c)
    path = str(tmp_path / "c.tdf")
    native.write_int_triples(path, d, w, c, 1, 1, 0)
    tracemalloc.start()
    try:
        got = corpus.Corpus.from_tdf_file(path, vocab_size=V, num_docs=D)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak <= 24 * len(d) + 64 * D + (1 << 18)
    _same_corpus(got, jcorpus.Corpus.from_tdf_file(path, vocab_size=V,
                                                   num_docs=D))


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
    "sparse_model", "dense_model", "top_words", "top_topics",
    "edge_composition", "float_triples", "int_triples",
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
        "dense_model": lambda p, io, nv: io.write_dense_model(p, model),
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


@pytest.mark.parametrize("k", [5, 1])
def test_dense_model_round_trip(tmp_path, k):
    """A dense model written by either package reads back the same in
    both, within the %.8g of the file; a file of the wrong shape is
    refused by both."""
    model = _model(7, k=k)
    for tag, io in (("ours", io_text), ("ref", jio)):
        path = str(tmp_path / f"M_hat_avg.{tag}")
        io.write_dense_model(path, model)
        got = io_text.load_dense_model(path, k, 60)
        assert got.dtype == np.float32 and got.shape == (60, k)
        assert got.flags.c_contiguous
        assert np.array_equal(got, jio.load_dense_model(path, k, 60))
        np.testing.assert_allclose(got, model, rtol=1e-7)
        with pytest.raises(ValueError, match="dense model"):
            io_text.load_dense_model(path, k, 59)
        with pytest.raises(AssertionError):
            jio.load_dense_model(path, k, 59)


def test_diagnostics_match():
    d, w, c = _entries(7, n=3000, V=60, D=150)
    ours = corpus.Corpus.from_entries(d, w, c, vocab_size=60)
    ref = jcorpus.Corpus.from_entries(d, w, c, vocab_size=60)
    model = _model(8)
    assert np.array_equal(diagnostics.topic_coherence(ours, model, 5),
                          jdiag.topic_coherence(ref, model, 5))
    assert diagnostics.topic_diversity(model) == \
        jdiag.topic_diversity(model)


def _diag_corpora(seed):
    d, w, c = _entries(seed, n=3000, V=60, D=150)
    return (corpus.Corpus.from_entries(d, w, c, vocab_size=60),
            jcorpus.Corpus.from_entries(d, w, c, vocab_size=60))


@pytest.mark.parametrize("seed", [7, 9])
def test_report_diagnostics_match(seed):
    """log_combinatorial, count_distinct_top_five, doc_frequency and
    joint_doc_frequency, the functions behind the diagnostic reports."""
    ours, ref = _diag_corpora(seed)
    got, want = diagnostics.log_combinatorial(ours), \
        jdiag.log_combinatorial(ref)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    counts = [(diagnostics.count_distinct_top_five(ours, m),
               jdiag.count_distinct_top_five(ref, m)) for m in (0, 1, 2, 5)]
    assert all(a == b for a, b in counts) and counts[0][0] > 0
    words = np.array([0, 3, 17, 59])
    assert np.array_equal(diagnostics.doc_frequency(ours, words),
                          jdiag.doc_frequency(ref, words))
    J = diagnostics.joint_doc_frequencies(ours, words)
    for i, a in enumerate(words):
        for j, b in enumerate(words):
            n = diagnostics.joint_doc_frequency(ours, int(a), int(b))
            assert n == jdiag.joint_doc_frequency(ref, int(a), int(b))
            assert n == J[i, j]
    empty = corpus.Corpus.from_entries(
        np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64),
        vocab_size=5, num_docs=3)
    assert diagnostics.count_distinct_top_five(empty, 0) == 0
    ours.counts = None
    with pytest.raises(ValueError, match="raw counts"):
        diagnostics.log_combinatorial(ours)


def test_preprocessed_files_are_byte_identical(tmp_path):
    ours, ref = _diag_corpora(11)
    preprocessed.save_preprocessed(ours, str(tmp_path / "ours"))
    jpre.save_preprocessed(ref, str(tmp_path / "ref"))
    for ext in ("_tr.info", "_tr.csr", "_tr.col", "_tr.off", ".csr", ".col",
                ".off"):
        a = (tmp_path / ("ours" + ext)).read_bytes()
        assert a == (tmp_path / ("ref" + ext)).read_bytes() and a, ext
    got = preprocessed.load_preprocessed(str(tmp_path / "ref"))
    want = jpre.load_preprocessed(str(tmp_path / "ours"))
    assert got.counts is None and want.counts is None
    got.counts = want.counts = ours.counts
    _same_corpus(got, want)
    _same_corpus(got, ours)


def test_logger_sinks_and_close(tmp_path):
    """The handle API's log sinks: both Loggers hand the same messages to
    a sink and write the same files."""
    seen = {}
    for tag, mod in (("ours", obs), ("ref", jobs)):
        log = mod.Logger(str(tmp_path / tag), quiet=True)
        seen[tag] = []
        for ch in ("info", "warning", "error"):
            log.add_sink(ch, seen[tag].append)
        log.info("a")
        log.warning("b")
        log.diag("c")
        mod.Timer(log).diag("d")
        log.close()
        log.close()
    assert seen["ours"] == seen["ref"] == ["a", "WARNING: b"]
    for name in ("diagnosticLog.txt", "timerLog.txt"):
        assert (tmp_path / "ours" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_synth_corpus_matches_bench(seed):
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    got = synth.synth_corpus(2_000, 3_000, 60_000, seed)
    want = bench.synth_corpus(2_000, 3_000, 60_000, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
