"""isle_tpu's PubMed scale test (benchmarks/pubmed_scale.py) on the port,
at CPU sizes.

The generator chip_smoke.py's phase P runs at 8.2M docs on the card,
isle_tpu_torch.synth.synth_corpus_hashed (synth_corpus's recipe from a
counter-based integer hash), gives the digests phase P pins on the card
(chip_smoke.PUBMED_PINS), deterministically, and a corpus with
synth_corpus's statistics; synth.corpus_from_csc builds the Corpus of its
arrays bit for bit as Corpus.from_entries does. On the generator's corpus,
with the scale test's config (document sampling at rate 0.1, edge topics,
several chunks), the port's StreamedTrainer on the resident and the wire
loader is held against isle_tpu's streamed trainer (its Pallas callers in
interpret mode), and the port's in-core Trainer against its streamed run,
as phase P holds them on the card."""

import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from isle_tpu import streaming as jst
from isle_tpu.config import TrainConfig
from isle_tpu_torch import bmatrix, streaming, synth
from isle_tpu_torch.config import GpuConfig
from isle_tpu_torch.corpus import Corpus
from isle_tpu_torch.rng import Draws
from isle_tpu_torch.sparse import DocSparse
from isle_tpu_torch.trainer import Trainer
from torch_parity import HEAD_BYTES, REFERENCE_TPU, JaxDraws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the vocabulary of PubMed and 1/1000 of its docs and nnz target: the cut
# chip_smoke.py pins
CUT = dict(vocab=141_043, docs=8_200, nnz=730_000)
# the trainers' corpus: small enough for isle_tpu's interpret mode, with
# several chunks of CHUNK entries and 150 docs sampled at rate 0.1
SMALL = dict(vocab=640, docs=1_500, nnz=30_000)
CHUNK = 4096
K, SEED, RATE = 4, 7, 0.1
B_FIELDS = ("d_word", "d_doc", "d_val", "w_word", "w_doc", "w_val")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _generate(shape, seed=0):
    return tuple(t.numpy() for t in synth.synth_corpus_hashed(
        shape["vocab"], shape["docs"], shape["nnz"], seed, "cpu"))


@pytest.fixture(scope="module")
def cut():
    return _generate(CUT)


def test_generator_gives_chip_smokes_pins(cut):
    """The digests phase P0 holds the card's arrays to: the cut's offsets,
    rows and counts, and the last raw draws at the full PubMed shape."""
    cs = _chip_smoke()
    assert cs.PUBMED_PIN_CUT == CUT
    assert cs.pubmed_pins("cpu") == cs.PUBMED_PINS
    for name, a in zip(("offsets", "rows", "counts"), cut):
        assert cs.PUBMED_PINS[name] == _sha(a), name
    assert synth.raw_draws(cs.PUBMED["nnz"]) == 949_000_000


def test_generator_is_deterministic(cut, monkeypatch):
    """The same seed gives the same arrays whatever the block of draws
    made at once; another seed others."""
    monkeypatch.setattr(synth, "_BLOCK", 1 << 17)
    again = _generate(CUT)
    for a, b in zip(cut, again):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    other = _generate(CUT, seed=1)
    assert other[1].tobytes() != cut[1].tobytes()
    assert [a.dtype for a in cut] == [np.int64, np.int32, np.uint8]


def test_pairs_unique_in_doc_word_order(cut):
    """Unique (doc, word) pairs in (doc, word) order, words below the
    vocabulary, counts uniform in [1, 7]."""
    offsets, rows, counts = cut
    V, D = CUT["vocab"], CUT["docs"]
    assert offsets.shape == (D + 1,) and offsets[0] == 0
    assert offsets[-1] == len(rows) == len(counts)
    assert np.all(np.diff(offsets) >= 0)
    docs = np.repeat(np.arange(D, dtype=np.int64), np.diff(offsets))
    assert np.all(np.diff(docs * V + rows) > 0)
    assert rows.min() >= 0 and rows.max() < V
    hist = np.bincount(counts, minlength=8)
    assert hist[0] == 0 and len(hist) == 8
    assert np.all(np.abs(hist[1:] / len(counts) - 1 / 7) < 0.005)


def test_recipe_is_synth_corpus(cut):
    """At the same shape the hashed draws give synth_corpus's corpus in
    law: nnz within 1%, the same share of the 100 head words, of word 0,
    and of entries in their doc's band."""
    offsets, rows, _ = cut
    d, w, _ = synth.synth_corpus(CUT["vocab"], CUT["docs"], CUT["nnz"], 0)
    docs = np.repeat(np.arange(CUT["docs"]), np.diff(offsets))
    assert abs(len(rows) / len(w) - 1) < 0.01
    bsz = CUT["vocab"] // 64

    def shares(words, ds):
        return np.array([np.mean(words < 100), np.mean(words == 0),
                         np.mean(words // bsz == ds % 64)])

    np.testing.assert_allclose(shares(rows, docs), shares(w, d), atol=0.005)


@pytest.mark.parametrize("n", [1, 2, 7, 2_203, 141_043])
def test_zipf_bounds_are_the_inverse_cdf(n):
    """The rank of a 53-bit uniform m (u = m 2^-53) is the count of
    zipf_bounds(n) at or below m: floor(n^u) - 1, synth_corpus's rank,
    but where float64 rounding puts n^u at a rank's boundary."""
    bounds = synth.zipf_bounds(n)
    assert bounds.shape == (max(n - 1, 0),)
    assert np.all(np.diff(bounds) > 0) and np.all(bounds <= 1 << 53)
    m = np.random.default_rng(n).integers(0, 1 << 53, 200_000)
    got = np.searchsorted(bounds, m, side="right")
    want = synth._zipf_ranks(m * 2.0 ** -53, n)
    assert np.all(np.abs(got - want) <= 1)
    assert np.mean(got != want) < 1e-4
    assert got.max() <= n - 1


def test_log_is_basic_operations():
    """synth._ln agrees with numpy's log to 4 ulp over the table's range."""
    x = np.arange(1, 300_000, dtype=np.float64)
    got, want = synth._ln(x), np.log(x)
    assert np.all(np.abs(got - want) <= 4 * np.spacing(np.maximum(want, 1)))


def test_hash_words_are_32_bit_and_a_bijection():
    """Every word is in [0, 2^32); the mixer is a bijection (2^20
    consecutive counters give 2^20 words), and streams differ."""
    idx = torch.arange(1 << 20, dtype=torch.int64)
    a = synth.hash_words(0, 0, idx)
    assert int(a.min()) >= 0 and int(a.max()) < 1 << 32
    assert torch.unique(a).numel() == idx.numel()
    assert torch.unique(synth._mix32(idx)).numel() == idx.numel()
    assert abs(float(a.double().mean()) / 2**32 - 0.5) < 1e-3
    b = synth.hash_words(0, 1, idx)
    assert float((a == b).double().mean()) < 1e-5
    assert synth._mix32(123_456) == int(synth._mix32(torch.tensor(123_456)))


def _entries(case):
    """(docs, words, counts, vocab, num_docs) in (doc, word) order."""
    rng = np.random.default_rng(3)
    if case == "generator":
        offsets, rows, counts = _generate(dict(vocab=2_000, docs=500,
                                               nnz=20_000))
        docs = np.repeat(np.arange(500), np.diff(offsets))
        return docs, rows, counts, 2_000, 500
    if case == "empty":
        return (np.zeros(0, np.int64),) * 3 + (5, 3)
    # docs 0-3 and the last four empty, and gaps
    d = np.sort(rng.choice(np.arange(4, 90), 600))
    w = rng.integers(0, 50, 600)
    key = np.unique(d * 50 + w)
    d, w = key // 50, key % 50
    c = (rng.integers(1, 30, len(d)) if case == "int counts"
         else rng.random(len(d)).astype(np.float32) * 9)
    return d, w, c, 50, 94


@pytest.mark.parametrize("case", ["generator", "int counts", "float counts",
                                  "empty"])
def test_corpus_from_csc_equals_from_entries(case):
    """Offsets, rows, counts, vals, avg_doc_sz and nz_docs bit for bit."""
    d, w, c, V, D = _entries(case)
    want = Corpus.from_entries(d, w, c, vocab_size=V, num_docs=D,
                               sort_dedup=False)
    offsets = np.zeros(D + 1, np.int64)
    np.cumsum(np.bincount(d, minlength=D), out=offsets[1:])
    got = synth.corpus_from_csc(offsets, w, c, V)
    for f in ("offsets", "rows", "counts", "vals"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert (got.avg_doc_sz, got.nz_docs, got.num_docs, got.vocab_size) == \
        (want.avg_doc_sz, want.nz_docs, want.num_docs, want.vocab_size)


@pytest.fixture(scope="module")
def small():
    offsets, rows, counts = _generate(SMALL)
    return synth.corpus_from_csc(offsets, rows, counts, SMALL["vocab"])


def _config():
    return TrainConfig(num_topics=K, seed=SEED, sample_docs=True,
                       sample_rate=RATE, compute_edge_topics=True,
                       max_edge_topics=6, tpu=REFERENCE_TPU)


def _streamed(corpus, out, draws=None, **gpu):
    tr = streaming.StreamedTrainer(
        _config(), output_dir=str(out), chunk_entries=CHUNK,
        gpu=GpuConfig(device="cpu", **{"dense_head_bytes": 0, **gpu}),
        draws=draws)
    tr.load_corpus(corpus)
    tr.train()
    tr.train_edge_topics()
    return tr


def _svd(tr) -> dict:
    with np.load(os.path.join(tr.run_dir, "ckpt_svd.npz")) as z:
        return dict(z)


@pytest.fixture(scope="module")
def jax_run(small, tmp_path_factory):
    tr = jst.StreamedTrainer(_config(), output_dir=str(
        tmp_path_factory.mktemp("jax")), chunk_entries=CHUNK)
    tr._t.corpus = small
    tr._t._post_ingest()
    tr.train()
    tr.train_edge_topics()
    return tr


def test_small_corpus_is_the_scale_tests(small):
    """Several chunks, uint8 counts (the resident loader's form at
    PubMed), ζ = 1 on every word, as in the reference's own scale run."""
    assert len(list(streaming.doc_chunks(small, CHUNK))) >= 6
    assert streaming.counts_dtype(small) == np.uint8


@pytest.mark.parametrize("loader", ["resident", "wire"])
def test_streamed_trainer_matches_isle_tpu(tmp_path, small, jax_run, loader):
    """The port's StreamedTrainer (isle_tpu's draws replayed) against
    isle_tpu's on the generator's corpus, sampled at 0.1 with edge
    topics: ζ, original_cols, clusters, catchwords and top-two topics
    exactly, eigenvalues within rtol 1e-4, the model and the edge model
    within rtol 1e-4, atol 1e-6 (the streamed parity tests')."""
    got = _streamed(small, tmp_path, JaxDraws(SEED, streamed_sampling=True),
                    resident_corpus_bytes=0 if loader == "wire" else 6 << 30)
    want = (streaming.ChunkLoader if loader == "wire"
            else streaming.ResidentLoader)
    assert type(got.loader) is want
    ours, ref = _svd(got), _svd(jax_run)
    assert ours["zetas"].tobytes() == ref["zetas"].tobytes()
    assert np.all(ours["zetas"] == 1.0)
    np.testing.assert_array_equal(got.original_cols, jax_run.original_cols)
    assert 0 < len(got.original_cols) <= RATE * SMALL["docs"] + 1
    np.testing.assert_array_equal(got.cluster_of_doc, jax_run.cluster_of_doc)
    for a, b in zip(got.catchwords, jax_run.catchwords):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.top_pairs, jax_run.top_pairs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.evalues, jax_run.evalues, rtol=1e-4)
    np.testing.assert_allclose(got.model, jax_run.model, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(got.edge_pairs, jax_run.edge_pairs)
    np.testing.assert_allclose(got.edge_model, jax_run.edge_model,
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("head_bytes", [0, HEAD_BYTES])
def test_in_core_and_wire_match_the_resident_run(tmp_path, small,
                                                 head_bytes):
    """Phase P's gates on the port's own draws, COO and with a partial
    hybrid head: the wire run ends bit for bit where the resident run
    ends (P2); the in-core Trainer's ζ, original_cols and B equal the
    streamed run's, its eigenvalues within rtol 1e-4 and its model within
    1e-6 (P3)."""
    res = _streamed(small, tmp_path / "res", dense_head_bytes=head_bytes)
    wire = _streamed(small, tmp_path / "wire", dense_head_bytes=head_bytes,
                     resident_corpus_bytes=0)
    assert isinstance(res.loader, streaming.ResidentLoader)
    for key in ("zetas", "original_cols"):
        np.testing.assert_array_equal(_svd(wire)[key], _svd(res)[key])
    for key in ("cluster_of_doc", "model", "edge_model", "edge_pairs"):
        np.testing.assert_array_equal(getattr(wire, key), getattr(res, key))
    ic = Trainer(_config(), output_dir=str(tmp_path / "ic"), quiet=True,
                 gpu=GpuConfig(device="cpu", dense_head_bytes=head_bytes))
    ic.load_corpus(small)
    ic.train()
    ours, ref = _svd(ic), _svd(res)
    for key in ("zetas", "original_cols"):
        np.testing.assert_array_equal(ours[key], ref[key])
    np.testing.assert_allclose(ours["evalues"], ref["evalues"], rtol=1e-4)
    z = torch.from_numpy(ref["zetas"])
    select = torch.zeros(SMALL["docs"], dtype=torch.bool)
    select[torch.from_numpy(res.original_cols).long()] = True
    B, cols = streaming.streamed_build_b(small, z, select, res.loader)
    IB, in_cols = bmatrix.threshold_and_copy(
        DocSparse.from_corpus(small, "cpu"), z, sample_rate=RATE,
        uniforms=Draws(SEED).doc_sample_uniforms(SMALL["docs"]))
    np.testing.assert_array_equal(cols, in_cols)
    for f in B_FIELDS:
        assert torch.equal(getattr(B, f), getattr(IB, f)), f
    np.testing.assert_array_equal(ic.cluster_of_doc, res.cluster_of_doc)
    np.testing.assert_allclose(ic.model, res.model, rtol=0, atol=1e-6)

