"""The device-resident streamed corpus and the middle's memory plan
(isle_tpu_torch.streaming: ResidentLoader, get_corpus_loader,
plan_middle_budget, planned_middle) against the wire loader and against
isle_tpu's.

Chunks and values are compared bit for bit (the counts form rebuilds the
values with Corpus.from_entries' expression), the loader and plan
decisions exactly. Trained runs on the resident loader equal the wire
runs (GpuConfig.resident_corpus_bytes=0) bit for bit, and isle_tpu's
StreamedTrainer to the tolerances of tests/test_torch_streaming.py."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from isle_tpu import streaming as jst
from isle_tpu.config import HyperParams, TrainConfig
from isle_tpu.corpus import Corpus as JaxCorpus
from isle_tpu_torch import streaming
from isle_tpu_torch.config import GpuConfig
from isle_tpu_torch.corpus import Corpus
from isle_tpu_torch.trainer import Trainer
from torch_cases import RESIDENT_CORPORA as CORPORA
from torch_cases import resident_corpus as _corpus
from torch_parity import HEAD_BYTES, REFERENCE_TPU, REFERENCE_TPU_HYBRID, \
    JaxDraws, biting_corpus

K = 4
CHUNK = 300  # entries: 29 chunks of the biting corpus
WIRE = GpuConfig(device="cpu", dense_head_bytes=0, resident_corpus_bytes=0)
RESIDENT = GpuConfig(device="cpu", dense_head_bytes=0)  # the default budget
GIB = 1 << 30


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32)


def _same_chunks(a, b):
    got, want = list(a.chunks()), list(b.chunks())
    assert [c[:2] for c in got] == [c[:2] for c in want]
    for x, y in zip(got, want):
        for s, t in zip(x[2:], y[2:]):
            assert s.dtype == t.dtype
            np.testing.assert_array_equal(_bits(s), _bits(t))
    return got


@pytest.mark.parametrize("doc_range", [None, (37, 121), (155, 160)])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_resident_chunks_equal_the_wire_chunks(name, doc_range):
    """Every chunk (words, values, docs) equals ChunkLoader's bit for bit,
    the values equal the corpus's, in both forms; load() gives what
    chunks() gives, and the slabs hold one copy of the range."""
    corpus = _corpus(name)
    res = streaming.ResidentLoader(corpus, 64, "cpu", doc_range)
    want = CORPORA[name][2]
    assert res.count_dtype == (None if want is None else np.dtype(want))
    wire = streaming.ChunkLoader(corpus, 64, "cpu", doc_range)
    chunks = _same_chunks(res, wire)
    lo, hi = res.doc_range
    a, b = int(corpus.offsets[lo]), int(corpus.offsets[hi])
    if chunks:
        np.testing.assert_array_equal(
            np.concatenate([_bits(c[3]) for c in chunks]),
            corpus.vals[a:b].view(np.int32))
        for lo_c, hi_c, w, v, d in chunks:
            for x, y in zip(res.load(lo_c, hi_c), (w, v, d)):
                assert torch.equal(x, y)
    assert res.fill_count == 1 and res.held
    words, second, _, doc_sums, _ = res._slabs
    assert words.numel() == second.numel() == b - a
    if want is not None:  # the doc sums made on the device: the host's
        np.testing.assert_array_equal(doc_sums.numpy().view(np.int32),
                                      corpus.doc_sums()[lo:hi].view(np.int32))
    assert res.copy_wait_ms() == 0.0


def test_empty_docs_and_an_empty_range():
    corpus = _corpus("uint8")
    lens = np.diff(corpus.offsets)
    assert (lens[3::4] == 0).all()
    res = streaming.ResidentLoader(corpus, 64, "cpu", (7, 7))
    assert res.ranges == [] and list(res.chunks()) == []
    with pytest.raises(ValueError, match="non-empty part"):
        res.load(7, 8)


def _reference_corpora():
    """The corpora of tests/test_streaming.py's resident-loader test, both
    forms: (name, isle_tpu corpus, the port's corpus of the same arrays)."""
    rng = np.random.default_rng(17)
    V, D = 50, 140
    d = np.sort(rng.integers(0, D, 1100))
    w = rng.integers(0, V, len(d))
    key = np.unique(d.astype(np.int64) * V + w)
    d, w = (key // V).astype(np.int64), (key % V).astype(np.int64)
    cnt = rng.integers(1, 8, len(key)).astype(np.int64)
    big = rng.choice(len(key), 5, replace=False)
    cnt[big] = rng.integers(15, 70000, 5)
    counts = JaxCorpus.from_entries(d, w, cnt, vocab_size=V, num_docs=D)
    vals = dataclasses.replace(
        counts,
        vals=(counts.counts.astype(np.float32)
              / np.repeat(counts.doc_sums(), np.diff(counts.offsets))
              ).astype(np.float32),
    )
    out = []
    for name, ref in (("counts", counts), ("vals", vals)):
        ours = Corpus(**{f.name: getattr(ref, f.name)
                         for f in dataclasses.fields(Corpus)})
        out.append((name, ref, ours))
    return out


@pytest.mark.parametrize("which", [0, 1])
def test_chunks_equal_isle_tpu_resident_loader(which):
    """The same chunks as isle_tpu's ResidentLoader on JAX's CPU: its
    padded chunks' first cnt entries, and the same form."""
    name, ref_corpus, corpus = _reference_corpora()[which]
    ref = jst.ResidentLoader(ref_corpus, 128)
    res = streaming.ResidentLoader(corpus, 128, "cpu")
    assert (ref._plan is None) == (res.count_dtype is None) == \
        (name == "vals")
    if ref._plan is not None:
        assert np.dtype(ref._plan.cdtype) == res.count_dtype
    n = 0
    for lo, hi, w, v, d in res.chunks():
        cnt = w.numel()
        for mine, theirs in zip((w, v, d), ref(lo, hi)):
            theirs = np.asarray(theirs)
            assert theirs.shape == (128,)
            np.testing.assert_array_equal(mine.numpy(), theirs[:cnt])
        n += 1
    assert n == len(list(jst.doc_chunks(ref_corpus, 128))) > 3


@pytest.mark.parametrize("which", [0, 1])
def test_loader_choice_equals_isle_tpu(which):
    """get_corpus_loader and resident_bytes decide as isle_tpu's do at
    budgets of 0, 16 bytes, exactly the slab size and 1 GiB."""
    _, ref_corpus, corpus = _reference_corpora()[which]
    plan = jst._compact_plan(ref_corpus, 128)
    slab = jst.ResidentLoader.resident_bytes(ref_corpus, 128, plan)
    form = streaming.counts_dtype(corpus)
    assert streaming.ResidentLoader.resident_bytes(corpus, 128, form) == slab
    for budget in (0, 16, slab - 1, slab, GIB):
        ref = jst.get_corpus_loader(ref_corpus, 128, resident_bytes=budget)
        got = streaming.get_corpus_loader(corpus, 128, "cpu", budget)
        assert isinstance(got, streaming.ResidentLoader) == \
            isinstance(ref, jst.ResidentLoader), budget
        assert isinstance(got, streaming.ResidentLoader) == \
            (budget >= slab), budget
        if isinstance(got, streaming.ResidentLoader):
            assert got.slab_bytes == slab
        else:
            assert isinstance(got, streaming.ChunkLoader)


def test_resident_bytes_of_a_range():
    """A rank's slab bytes: its entries and docs in the reference's
    formula, the chunk's slack once."""
    corpus = _corpus("uint16")
    lo, hi = 40, 100
    n = int(corpus.offsets[hi] - corpus.offsets[lo])
    assert streaming.ResidentLoader.resident_bytes(
        corpus, 64, np.uint16, (lo, hi)) == (n + 64) * 6 + 8 * (hi - lo + 8)
    assert streaming.ResidentLoader.resident_bytes(
        corpus, 64, None, (lo, hi)) == (n + 64) * 8 + 8 * (hi - lo + 8)


def _outcome(keep, head, cfg):
    if not keep:
        return "release"
    return "full" if head == cfg else "shrunk" if head else "no head"


# (hbm, slab, nnz_b, cfg_head): one case of each outcome, and the edges
PLAN_CASES = [
    (80 * GIB, 261_096_564, 47_544_996, 4 * GIB),
    (8 * GIB, 261_096_564, 47_544_996, 4 * GIB),
    (4 * GIB, 261_096_564, 47_544_996, 4 * GIB),
    (2 * GIB, 261_096_564, 47_544_996, 4 * GIB),
    (4 * GIB, 261_096_564, 47_544_996, 0),
    (GIB + (256 << 20), 0, 0, 4 * GIB),
    (GIB + (256 << 20) - 1, 0, 0, 4 * GIB),
    (GIB, 0, 0, 4 * GIB),
    (GIB - 1, 0, 0, 4 * GIB),
]


def test_plan_middle_budget_reaches_every_outcome():
    seen = set()
    for case in PLAN_CASES:
        got = streaming.plan_middle_budget(*case)
        assert got == jst.plan_middle_budget(*case), case
        seen.add(_outcome(*got, case[3]))
    assert seen == {"full", "shrunk", "no head", "release"}
    # the NYTimes shape's plan at 8 GiB: a head of 2,690,776,588 bytes
    assert streaming.plan_middle_budget(*PLAN_CASES[1]) == \
        (True, 2_690_776_588)


@settings(max_examples=300, deadline=None, database=None)
@given(hbm=st.integers(0, 96 * GIB), slab=st.integers(0, 16 * GIB),
       nnz_b=st.integers(0, 1 << 30), head=st.integers(0, 8 * GIB))
def test_plan_middle_budget_equals_isle_tpu(hbm, slab, nnz_b, head):
    assert streaming.plan_middle_budget(hbm, slab, nnz_b, head) == \
        jst.plan_middle_budget(hbm, slab, nnz_b, head)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    return biting_corpus()


def _config(sampled=False, tpu=REFERENCE_TPU):
    kw = dict(sample_docs=True, sample_rate=0.5) if sampled else {}
    return TrainConfig(num_topics=K, seed=3, compute_edge_topics=True,
                       max_edge_topics=6, hyper=HyperParams(), tpu=tpu, **kw)


def _streamed(cfg, corpus, out, gpu=RESIDENT, resume=False, draws="jax"):
    if draws == "jax":
        draws = JaxDraws(cfg.seed, streamed_sampling=cfg.sample_docs)
    st_ = streaming.StreamedTrainer(cfg, output_dir=str(out),
                                    chunk_entries=CHUNK, gpu=gpu, draws=draws)
    st_.load_corpus(corpus)
    st_.train(resume=resume)
    st_.train_edge_topics()
    return st_


def _jax_streamed(cfg, corpus, out):
    tr = jst.StreamedTrainer(cfg, output_dir=str(out), chunk_entries=CHUNK)
    tr._t.corpus = corpus
    tr._t._post_ingest()
    tr.train()
    tr.train_edge_topics()
    return tr


RESULTS = ("original_cols", "cluster_of_doc", "evalues", "centers", "model",
           "catchword_thresholds", "edge_model", "edge_pairs")


def _bit_equal(a, b):
    for f in RESULTS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for x, y in zip(a.catchwords, b.catchwords):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.top_pairs, b.top_pairs):
        np.testing.assert_array_equal(x, y)
    for stage in ("svd", "kmeans"):
        with np.load(f"{a.run_dir}/ckpt_{stage}.npz") as x, \
                np.load(f"{b.run_dir}/ckpt_{stage}.npz") as y:
            for key in x.files:
                np.testing.assert_array_equal(x[key], y[key], key)


@pytest.fixture(scope="module")
def wire_runs(tmp_path_factory, corpus):
    tmp = tmp_path_factory.mktemp("wire")
    return {s: _streamed(_config(s), corpus, tmp / str(s), gpu=WIRE)
            for s in (False, True)}


@pytest.mark.parametrize("sampled", [False, True])
def test_default_run_equals_the_wire_run_and_isle_tpu(tmp_path, corpus,
                                                      wire_runs, sampled):
    """A default StreamedTrainer fills its slabs once and ends bit for bit
    where the wire run ends: ζ, original_cols, B, clusters, catchwords,
    the model and the edge model; and where isle_tpu's streamed trainer
    (resident as well, by its default) ends, to the streaming tests'
    tolerances."""
    cfg = _config(sampled)
    got = _streamed(cfg, corpus, tmp_path / "port")
    wire = wire_runs[sampled]
    assert isinstance(got.loader, streaming.ResidentLoader)
    assert isinstance(wire.loader, streaming.ChunkLoader)
    assert got.loader.fill_count == 1 and got.loader.held
    assert len(got.loader.ranges) > 20
    _bit_equal(got, wire)
    with np.load(f"{got.run_dir}/ckpt_svd.npz") as z:
        zetas = torch.from_numpy(z["zetas"])
    select = None
    if sampled:
        select = torch.zeros(corpus.num_docs, dtype=torch.bool)
        select[torch.from_numpy(got.original_cols).long()] = True
    B, cols = streaming.streamed_build_b(corpus, zetas, select, got.loader)
    WB, wcols = streaming.streamed_build_b(corpus, zetas, select,
                                           wire.loader)
    np.testing.assert_array_equal(cols, wcols)
    for f in ("d_word", "d_doc", "d_val", "w_word", "w_doc", "w_val"):
        assert torch.equal(getattr(B, f), getattr(WB, f)), f
    assert got.loader.fill_count == 1

    ref = _jax_streamed(cfg, corpus, tmp_path / "jax")
    assert isinstance(ref._loader, jst.ResidentLoader)
    np.testing.assert_array_equal(got.original_cols, ref.original_cols)
    np.testing.assert_array_equal(got.cluster_of_doc, ref.cluster_of_doc)
    for a, b in zip(got.catchwords, ref.catchwords):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.evalues, ref.evalues, rtol=1e-4)
    np.testing.assert_allclose(got.model, ref.model, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.edge_pairs, ref.edge_pairs)
    np.testing.assert_allclose(got.edge_model, ref.edge_model, rtol=1e-4,
                               atol=1e-6)


def test_hybrid_run_equals_the_wire_run(tmp_path, corpus):
    """The hybrid layout at a partial head, resident and over the wire."""
    cfg = _config(tpu=REFERENCE_TPU_HYBRID)
    got = _streamed(cfg, corpus, tmp_path / "res",
                    gpu=GpuConfig(device="cpu", dense_head_bytes=HEAD_BYTES))
    wire = _streamed(cfg, corpus, tmp_path / "wire",
                     gpu=GpuConfig(device="cpu", dense_head_bytes=HEAD_BYTES,
                                   resident_corpus_bytes=0))
    assert "hybrid layout" in [s for s, *_ in got.timer.phases]
    _bit_equal(got, wire)


@pytest.mark.parametrize("stage,fills", [("model", 0), ("kmeans", 1),
                                         ("svd", 1)])
def test_a_resume_fills_only_for_the_passes_it_runs(tmp_path, corpus,
                                                    wire_runs, stage, fills):
    """A resume that skips every pass never fills the slabs; one that runs
    the finish passes (after kmeans) or B and the finish (after svd) fills
    them once. Each ends where the wire run ended."""
    cfg = _config()
    first = _streamed(cfg, corpus, tmp_path)
    later = ("svd", "kmeans", "model")
    for s in later[later.index(stage) + 1:]:
        (tmp_path / first.run_dir / f"ckpt_{s}.npz").unlink()
    got = _streamed(cfg, corpus, tmp_path, resume=True)
    if fills == 0:
        assert got.loader is None
    else:
        assert got.loader.fill_count == fills
    np.testing.assert_array_equal(got.model, wire_runs[False].model)
    np.testing.assert_array_equal(got.cluster_of_doc,
                                  wire_runs[False].cluster_of_doc)


def _nnz_b(run) -> int:
    with np.load(f"{run.run_dir}/ckpt_svd.npz") as z:
        zetas = torch.from_numpy(z["zetas"])
    return streaming.streamed_build_b(run.corpus, zetas, None,
                                      run.loader)[0].nnz


def _hbm_for(run, outcome: str, head: int = 4 * GIB) -> int:
    """An hbm_bytes that gives plan_middle_budget's `outcome` for the
    run's slabs and B, and the plan it gives."""
    slab, nnz = run.loader.slab_bytes, _nnz_b(run)
    base = slab + (1 << 30)
    hbm = {"shrunk": base + 96 * nnz + (300 << 20),
           "no head": base + 96 * nnz + (100 << 20),
           "release": base + 30 * nnz - 1}[outcome]
    plan = streaming.plan_middle_budget(hbm, slab, nnz, head)
    assert plan == jst.plan_middle_budget(hbm, slab, nnz, head)
    assert _outcome(*plan, head) == outcome
    return hbm


def test_plan_outcomes_in_the_trainer(tmp_path, corpus, wire_runs):
    """hbm_bytes drives the plan: a shrunk head (every word still fits it
    at this size: the full head's results), no head (the COO wire run's
    results) and a release (two fills, the held run's results)."""
    logs = []
    full = _streamed(_config(), corpus, tmp_path / "full",
                     gpu=GpuConfig(device="cpu"))
    runs = {}
    for outcome in ("shrunk", "no head", "release"):
        gpu = GpuConfig(device="cpu", hbm_bytes=_hbm_for(full, outcome))
        st_ = streaming.StreamedTrainer(
            _config(), output_dir=str(tmp_path / outcome),
            chunk_entries=CHUNK, gpu=gpu, draws=JaxDraws(3))
        st_.logger.add_sink("info", logs.append)
        st_.load_corpus(corpus)
        st_.train()
        st_.train_edge_topics()
        runs[outcome] = st_
    stages = {o: [s for s, *_ in r.timer.phases] for o, r in runs.items()}
    assert "hybrid layout" in stages["shrunk"]
    assert "hybrid layout" not in stages["no head"]
    assert any("dense head budget 300 MiB" in m for m in logs)
    _bit_equal(runs["shrunk"], full)
    _bit_equal(runs["no head"], wire_runs[False])
    assert runs["release"].loader.fill_count == 2
    assert runs["shrunk"].loader.fill_count == 1
    assert runs["no head"].loader.fill_count == 1
    _bit_equal(runs["release"], full)


def test_the_footprint_warning(tmp_path, corpus):
    """The in-core trainer warns where isle_tpu's estimate (6 x 4 x nnz +
    the head budget + 8 x 4 x D x k bytes) exceeds hbm_bytes, and never
    on the CPU without a limit."""
    est = 24 * corpus.nnz + 32 * corpus.num_docs * K
    for hbm, warned in ((est - 1, True), (est, False), (0, False)):
        tr = Trainer(_config(), output_dir=str(tmp_path / str(hbm)),
                     quiet=True, gpu=GpuConfig(device="cpu",
                                               dense_head_bytes=0,
                                               hbm_bytes=hbm))
        seen = []
        tr.logger.add_sink("warning", seen.append)
        tr.load_corpus(corpus)
        tr.train()
        hit = [m for m in seen if "estimated device footprint" in m]
        assert len(hit) == warned, (hbm, seen)


class _OutOfMemoryOnce:
    """run_lloyds_full that raises `error` on its first call."""

    def __init__(self, real, error):
        self.real, self.error, self.calls = real, error, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        if self.calls == 1:
            raise self.error
        return self.real(*args, **kw)


def _with_faults(monkeypatch, error):
    fault = _OutOfMemoryOnce(streaming.run_lloyds_full, error)
    monkeypatch.setattr(streaming, "run_lloyds_full", fault)
    solves = []
    real = streaming.solve_gram_eigens

    def counted(*args, **kw):
        solves.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(streaming, "solve_gram_eigens", counted)
    return fault, solves


def test_out_of_memory_with_slabs_held_retries_once(tmp_path, corpus,
                                                    wire_runs, monkeypatch):
    fault, solves = _with_faults(monkeypatch,
                                 torch.OutOfMemoryError("injected"))
    seen = []
    st_ = streaming.StreamedTrainer(_config(), output_dir=str(tmp_path),
                                    chunk_entries=CHUNK, gpu=RESIDENT,
                                    draws=JaxDraws(3))
    st_.logger.add_sink("warning", seen.append)
    st_.load_corpus(corpus)
    st_.train()
    st_.train_edge_topics()
    assert fault.calls == 2 and len(solves) == 1
    assert any("ran out of device memory" in m for m in seen), seen
    assert st_.loader.fill_count == 2  # released for the retry, refilled
    _bit_equal(st_, wire_runs[False])


@pytest.mark.parametrize("case", ["wire", "released by the plan",
                                  "not memory"])
def test_other_failures_propagate(tmp_path, corpus, monkeypatch, case):
    """Out of memory with no slabs held (the wire loader, or slabs the plan
    released) and any other error leave the middle as they came."""
    error = (ValueError("injected") if case == "not memory"
             else torch.OutOfMemoryError("injected"))
    fault, solves = _with_faults(monkeypatch, error)
    gpu = {"wire": WIRE, "released by the plan": GpuConfig(
        device="cpu", dense_head_bytes=0, hbm_bytes=1),
        "not memory": RESIDENT}[case]
    st_ = streaming.StreamedTrainer(_config(), output_dir=str(tmp_path),
                                    chunk_entries=CHUNK, gpu=gpu,
                                    draws=JaxDraws(3))
    st_.load_corpus(corpus)
    with pytest.raises(type(error), match="injected"):
        st_.train()
    assert fault.calls == 1 and len(solves) == 1
    assert not st_.is_training_complete
