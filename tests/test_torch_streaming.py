"""The out-of-core path (isle_tpu_torch.streaming) against isle_tpu's.

The reference runs as its own tests/test_streaming.py runs it, with the
configuration of tests/torch_parity.py (COO layout, Pallas segment sums
forced on, so its streamed callers of both kernels run in interpret mode
on the CPU). The port runs on the CPU, where both segment sums take their
plain versions. Integer results (chunk ranges, ζ, nnz, B, original_cols,
clusters, catchwords, top-two topics) are exact; the float sums of the
mass and the model are within 1e-5 whatever the number of chunks, and the
trained models within rtol 1e-4, atol 1e-6 with isle_tpu's draws
replayed."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isle_tpu import streaming as jst
from isle_tpu.config import HyperParams, TrainConfig
from isle_tpu.trainer import Trainer as JaxTrainer
from isle_tpu_torch import bmatrix, streaming, thresholds, topic_model
from isle_tpu_torch.config import GpuConfig
from isle_tpu_torch.sparse import DocSparse
from isle_tpu_torch.trainer import Trainer
from torch_parity import HEAD_BYTES, REFERENCE_TPU, REFERENCE_TPU_HYBRID, \
    JaxDraws, biting_corpus

CPU = GpuConfig(device="cpu", dense_head_bytes=0)  # as REFERENCE_TPU
HYBRID = GpuConfig(device="cpu", dense_head_bytes=HEAD_BYTES)
K = 4
# chunk sizes giving 1, 3 and 29 chunks of the biting corpus (8,353 nnz)
CHUNKS = {"one": 8400, "three": 3100, "many": 300}


@pytest.fixture(scope="module")
def corpus():
    return biting_corpus()


def _loader(corpus, entries):
    return streaming.ChunkLoader(corpus, entries, "cpu")


@pytest.mark.parametrize("entries", [30, 300, 2048, 1 << 20])
def test_doc_chunks_equal(corpus, entries):
    got = list(streaming.doc_chunks(corpus, entries))
    assert got == list(jst.doc_chunks(corpus, entries))
    assert got[0][0] == 0 and got[-1][1] == corpus.num_docs
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
    off = corpus.offsets
    assert all(off[hi] - off[lo] <= entries for lo, hi in got)


def test_doc_chunks_refuses_a_doc_larger_than_a_chunk(corpus):
    with pytest.raises(ValueError, match="smaller than the largest doc"):
        list(streaming.doc_chunks(corpus, 5))
    with pytest.raises(AssertionError):
        list(jst.doc_chunks(corpus, 5))


@pytest.mark.parametrize("entries", [300, 2048])
def test_chunk_loader_chunks(corpus, entries):
    """Every chunk is the corpus's own doc range, unpadded, and load()
    gives what chunks() gives."""
    loader = _loader(corpus, entries)
    docs = corpus.doc_ids()
    seen = 0
    for lo, hi, w, v, d in loader.chunks():
        a, b = int(corpus.offsets[lo]), int(corpus.offsets[hi])
        assert a == seen and w.dtype == torch.int32 and d.dtype == torch.int32
        np.testing.assert_array_equal(w.numpy(), corpus.rows[a:b])
        np.testing.assert_array_equal(v.numpy(), corpus.vals[a:b])
        np.testing.assert_array_equal(d.numpy(), docs[a:b])
        for x, y in zip(loader.load(lo, hi), (w, v, d)):
            assert torch.equal(x, y)
        seen = b
    assert seen == corpus.nnz and loader.copy_wait_ms() == 0.0


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("chunks", sorted(CHUNKS))
def test_streamed_thresholds_exact(corpus, chunks, drop):
    hp = HyperParams(few_samples_threshold_drop=drop, bad_threshold_drop=drop)
    z_ref, nnz_ref = jst.streamed_thresholds(
        corpus, K, hp, chunk_entries=CHUNKS[chunks], pallas=True,
        pallas_chunk=256)
    z, nnz = streaming.streamed_thresholds(
        corpus, K, hp, _loader(corpus, CHUNKS[chunks]))
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_ref))
    assert nnz == nnz_ref
    assert (z.numpy() > 1).sum() >= 8  # the thresholds bite
    assert np.isinf(z.numpy()).any() == drop
    # and the in-core stage on the whole corpus
    z_in, nnz_in = thresholds.compute_thresholds(
        DocSparse.from_corpus(corpus, "cpu"), corpus.avg_doc_sz,
        corpus.nz_docs, K, hp)
    assert torch.equal(z, z_in) and nnz == nnz_in


def _zetas(corpus, hp=HyperParams()):
    return streaming.streamed_thresholds(corpus, K, hp,
                                         _loader(corpus, 1 << 20))[0]


def test_streamed_doc_weights(corpus):
    z = _zetas(corpus, HyperParams(few_samples_threshold_drop=True))
    ref = jst.streamed_doc_weights(corpus, jnp.asarray(z.numpy()), 300)
    got = streaming.streamed_doc_weights(corpus, z, _loader(corpus, 300))
    assert got.shape == (corpus.num_docs,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("chunks", sorted(CHUNKS))
def test_streamed_build_b_exact(corpus, chunks, sampled):
    """B and original_cols equal isle_tpu's streamed B and the port's
    in-core B, with and without a doc selection."""
    z = _zetas(corpus)
    select = None
    if sampled:
        w = streaming.streamed_doc_weights(corpus, z, _loader(corpus, 300))
        u = torch.from_numpy(np.random.default_rng(4).random(
            corpus.num_docs, np.float32))
        select = bmatrix.dice_select(w, 0.5, u)
        assert 0.3 * corpus.num_docs < int(select.sum()) < corpus.num_docs
    B, cols = streaming.streamed_build_b(
        corpus, z, select, _loader(corpus, CHUNKS[chunks]))
    JB, ref_cols = jst.streamed_build_b(
        corpus, jnp.asarray(z.numpy()),
        None if select is None else jnp.asarray(select.numpy()),
        spmm_chunk=256, chunk_entries=CHUNKS[chunks])
    np.testing.assert_array_equal(cols, ref_cols)
    assert (B.nnz, B.num_docs) == (JB.nnz, JB.num_docs)
    assert len(cols) < corpus.num_docs  # docs are dropped
    for f in ("d_word", "d_doc", "d_val", "w_word", "w_doc", "w_val"):
        np.testing.assert_array_equal(
            getattr(B, f).numpy(), np.asarray(getattr(JB, f))[: JB.nnz], f)
    A = DocSparse.from_corpus(corpus, "cpu")
    IB, in_cols = bmatrix.threshold_and_copy(
        A, z, docs=None if select is None
        else np.flatnonzero(select.numpy()))
    np.testing.assert_array_equal(cols, in_cols)
    for f in ("d_word", "d_doc", "d_val", "w_word", "w_doc", "w_val"):
        assert torch.equal(getattr(B, f), getattr(IB, f)), f


def _topic_inputs(corpus, seed=5):
    rng = np.random.default_rng(seed)
    V, D = corpus.vocab_size, corpus.num_docs
    cw_topic = np.full(V, -1, np.int32)
    cw_topic[rng.choice(V, size=V // 3, replace=False)] = rng.integers(
        0, K, V // 3)
    return cw_topic, rng.integers(-1, K, D).astype(np.int32)


@pytest.mark.parametrize("chunks", sorted(CHUNKS))
def test_streamed_mass_and_model(corpus, chunks):
    """The doc-topic mass and the model within 1e-5 of isle_tpu's streamed
    Pallas route and of the port's in-core stage, for 1, 3 and many
    chunks; the top-two topics exactly."""
    cw_topic, cluster = _topic_inputs(corpus)
    cwt, cl = torch.from_numpy(cw_topic), torch.from_numpy(cluster)
    loader = _loader(corpus, CHUNKS[chunks])
    if chunks != "one":
        assert len(loader.ranges) >= 3
    ref_model, ref_pairs = jst.streamed_topic_model(
        corpus, cw_topic, cluster, K, 2, want_top_pairs=True,
        chunk_entries=CHUNKS[chunks], pallas=True, pallas_chunk=256)
    model, pairs = streaming.streamed_topic_model(
        corpus, cwt, cl, K, 2, True, loader)
    np.testing.assert_allclose(model.numpy(), np.asarray(ref_model),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(pairs, ref_pairs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    A = DocSparse.from_corpus(corpus, "cpu")
    mass = streaming.streamed_doc_topic_mass(corpus, cwt, K, loader)
    np.testing.assert_allclose(
        mass.numpy(), topic_model.doc_topic_mass(A, cwt, K).numpy(),
        rtol=1e-5, atol=1e-6)
    in_model, in_pairs = topic_model.construct_topic_model(
        A, cwt, cl, K, 2, want_top_pairs=True)
    np.testing.assert_allclose(model.numpy(), in_model.numpy(), rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(pairs, in_pairs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chunks", sorted(CHUNKS))
def test_streamed_model_accumulation_gathers_local_rows(corpus, chunks):
    """Each chunk gathers from its own docs' rows of W by local doc id:
    the sum over the chunks is A W, within 1e-5 of the dense product in
    float64."""
    rng = np.random.default_rng(8)
    W = rng.random((corpus.num_docs, K)).astype(np.float32)
    got = streaming.streamed_model_accumulation(
        corpus, torch.from_numpy(W), _loader(corpus, CHUNKS[chunks]))
    A = np.zeros((corpus.vocab_size, corpus.num_docs))
    A[corpus.rows, corpus.doc_ids()] = corpus.vals
    np.testing.assert_allclose(got.numpy(), A @ W.astype(np.float64),
                               rtol=1e-5, atol=1e-6)


def test_incore_doc_weights_equal_streamed(corpus):
    """bmatrix.doc_weights on the whole corpus against the streamed
    weights; doc_dice is 0 where the weight is 0 and u^(1/w) elsewhere."""
    z = _zetas(corpus, HyperParams(few_samples_threshold_drop=True))
    A = DocSparse.from_corpus(corpus, "cpu")
    keep = torch.floor(A.d_val + 0.5) >= z[A.d_word]
    w = bmatrix.doc_weights(A, keep, z)
    got = streaming.streamed_doc_weights(corpus, z, _loader(corpus, 300))
    np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-6)
    u = torch.from_numpy(np.random.default_rng(4).random(
        corpus.num_docs, np.float32))
    dice = bmatrix.doc_dice(w, u).numpy()
    pos = w.numpy() > 0
    assert pos.any() and np.all(dice[~pos] == 0.0)
    np.testing.assert_allclose(
        dice[pos], u.numpy()[pos] ** (1.0 / w.numpy()[pos]), rtol=1e-6)


@pytest.mark.parametrize("sampled", [False, True])
def test_stage_launches_follow_the_stages(tmp_path, corpus, sampled):
    """One snapshot of the kernels' launch counts a marked stage, in stage
    order; on the CPU no kernel is launched."""
    got = _port_streamed(_config("sample_docs" if sampled else "default"),
                         corpus, tmp_path, draws=None)
    labels = [label for label, _ in got.stage_launches]
    want = ["streamed thresholds", "streamed doc sampling",
            "streamed B construction", "eigen solve (B B^T)", "k-means",
            "streamed catchwords", "streamed topic model"]
    if not sampled:
        want.remove("streamed doc sampling")
    assert labels == want
    for _, counts in got.stage_launches:
        assert counts == {"segsum_onehot": 0, "segsum_gather_rows": 0,
                          "segsum_gather_rows_narrow": 0,
                          "segsum_gather_rows_tiled": 0}


def test_streamed_filter_clustered(corpus):
    _, cluster = _topic_inputs(corpus)
    sub = streaming.streamed_filter_clustered(
        corpus, torch.from_numpy(cluster), _loader(corpus, 300))
    keep = cluster[corpus.doc_ids()] >= 0
    np.testing.assert_array_equal(sub.d_word.numpy(), corpus.rows[keep])
    np.testing.assert_array_equal(sub.d_doc.numpy(), corpus.doc_ids()[keep])
    np.testing.assert_array_equal(sub.d_val.numpy(), corpus.vals[keep])
    order = np.lexsort((sub.d_doc.numpy(), sub.d_word.numpy()))
    np.testing.assert_array_equal(sub.w_word.numpy(),
                                  sub.d_word.numpy()[order])
    np.testing.assert_array_equal(sub.w_doc.numpy(),
                                  sub.d_doc.numpy()[order])
    assert (sub.vocab, sub.num_docs) == (corpus.vocab_size, corpus.num_docs)


OPTIONS = {
    "default": {},
    "sample_docs": dict(cfg=dict(sample_docs=True, sample_rate=0.5)),
    "elkans": dict(hp=dict(kmeans_algo_for_sparse="elkans")),
    "lanczos": dict(hp=dict(eigensolver="lanczos")),
    "dense_kmeansmcmc": dict(hp=dict(eigensolver="dense",
                                     kmeans_init_method="kmeansmcmc")),
}


def _config(option, seed=3, tpu=REFERENCE_TPU):
    o = OPTIONS[option]
    return TrainConfig(
        num_topics=K, seed=seed, compute_edge_topics=True, max_edge_topics=6,
        hyper=HyperParams(**o.get("hp", {})), tpu=tpu, **o.get("cfg", {}),
    )


def _jax_streamed(cfg, corpus, out, resume=False):
    tr = jst.StreamedTrainer(cfg, output_dir=str(out), chunk_entries=2048)
    tr._t.corpus = corpus
    tr._t._post_ingest()
    tr.train(resume=resume)
    return tr


def _port_streamed(cfg, corpus, out, resume=False, draws="jax",
                   chunk_entries=2048, gpu=CPU):
    if draws == "jax":
        draws = JaxDraws(cfg.seed, streamed_sampling=cfg.sample_docs)
    tr = streaming.StreamedTrainer(cfg, output_dir=str(out),
                                   chunk_entries=chunk_entries, gpu=gpu,
                                   draws=draws)
    tr.load_corpus(corpus)
    tr.train(resume=resume)
    return tr


def _port_incore(cfg, corpus, out, resume=False, draws=None):
    tr = Trainer(cfg, output_dir=str(out), quiet=True, gpu=CPU, draws=draws)
    tr.load_corpus(corpus)
    tr.train(resume=resume)
    return tr


def _same_run(got, ref, exact_model=False):
    np.testing.assert_array_equal(got.original_cols, ref.original_cols)
    np.testing.assert_array_equal(got.cluster_of_doc, ref.cluster_of_doc)
    for a, b in zip(got.catchwords, ref.catchwords):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.top_pairs, ref.top_pairs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.evalues, ref.evalues, rtol=1e-4)
    if exact_model:
        np.testing.assert_array_equal(got.model, ref.model)
    else:
        np.testing.assert_allclose(got.model, ref.model, rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_streamed_trainer_matches_jax_streamed_trainer(tmp_path, corpus,
                                                       option):
    cfg = _config(option)
    ref = _jax_streamed(cfg, corpus, tmp_path / "jax")
    got = _port_streamed(cfg, corpus, tmp_path / "torch")
    assert len(got.loader.ranges) >= 3 and got.is_training_complete
    _same_run(got, ref)
    ref.train_edge_topics()
    got.train_edge_topics()
    np.testing.assert_array_equal(got.edge_pairs, ref.edge_pairs)
    np.testing.assert_allclose(got.edge_model, ref.edge_model, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got.model.sum(axis=0), 1.0, atol=1e-5)
    if option == "sample_docs":
        assert len(got.original_cols) < 0.6 * corpus.num_docs


@pytest.mark.parametrize("option", ["default", "sample_docs", "elkans"])
def test_streamed_hybrid_matches_jax_streamed_trainer(tmp_path, corpus,
                                                      option):
    """Both streamed trainers with the hybrid layout at a partial head
    (isle_tpu's streamed budget over B's docs, isle_tpu/streaming.py:
    1259-1277): the results of the COO case, the same stage labels."""
    from isle_tpu_torch.hybrid import max_head_rows

    cfg = _config(option, tpu=REFERENCE_TPU_HYBRID)
    ref = _jax_streamed(cfg, corpus, tmp_path / "jax")
    got = _port_streamed(cfg, corpus, tmp_path / "torch", gpu=HYBRID)
    _same_run(got, ref)
    labels = [label for label, *_ in got.timer.phases]
    assert labels == [label for label, *_ in ref.timer.phases]
    assert "hybrid layout" in labels
    nb = len(got.original_cols)
    assert 8 <= min(HEAD_BYTES // (2 * nb), max_head_rows(nb)) < corpus.vocab_size


def test_streamed_hybrid_below_eight_rows_stays_coo(tmp_path, corpus):
    """A budget of fewer than 8 head rows over B's docs leaves B in the
    COO layout, as isle_tpu's streamed middle does: the COO results."""
    from isle_tpu_torch.hybrid import HybridSparse

    cfg = _config("default")
    small = GpuConfig(device="cpu", dense_head_bytes=2 * corpus.num_docs * 7)
    seen = []
    real = streaming.solve_gram_eigens

    def spy(B, *a, **kw):
        seen.append(B)
        return real(B, *a, **kw)

    streaming.solve_gram_eigens = spy
    try:
        got = _port_streamed(cfg, corpus, tmp_path / "small", gpu=small)
    finally:
        streaming.solve_gram_eigens = real
    assert not isinstance(seen[0], HybridSparse)
    ref = _port_streamed(cfg, corpus, tmp_path / "coo")
    _same_run(got, ref, exact_model=True)


def test_streamed_trainer_matches_incore_trainer(tmp_path, corpus):
    """Without sampling both of the port's trainers take the same draws
    from one seed: the streamed run ends where the in-core run ends,
    whatever the chunk size, and one loader serves every pass."""
    cfg = _config("default")
    ref = _port_incore(cfg, corpus, tmp_path / "incore")
    for entries in (300, 1 << 20):
        got = _port_streamed(cfg, corpus, tmp_path / f"s{entries}",
                             draws=None, chunk_entries=entries)
        _same_run(got, ref)
        assert got.op_counter.calls == ref.op_counter.calls
        loader = got.loader
        got.train()
        assert got.loader is loader


@pytest.mark.parametrize("entries", [300, 1 << 20])
def test_streamed_doc_topic_report_comes_from_chunks(tmp_path, corpus,
                                                     monkeypatch, entries):
    """output_doc_topic after a streamed run writes both files byte for
    byte as the in-core trainer does, and takes its (D, k) mass from the
    chunk loader: the whole corpus never goes to the device."""
    cfg = _config("default")
    ref = _port_incore(cfg, corpus, tmp_path / "incore")
    ref.output_doc_topic()
    got = _port_streamed(cfg, corpus, tmp_path / "streamed", draws=None,
                         chunk_entries=entries)
    _same_run(got, ref)

    def no_upload(self):
        raise AssertionError("the streamed report put all of A on the device")

    monkeypatch.setattr(Trainer, "_device_A", no_upload)
    got.output_doc_topic()
    assert got.A is None and got._t.A is None
    for name in ("DocTopicCatchwordSums.tsv", "DocCatchword.tsv"):
        with open(os.path.join(got.run_dir, name), "rb") as f, \
                open(os.path.join(ref.run_dir, name), "rb") as g:
            data = f.read()
            assert data == g.read() and len(data) > 0, name


def _drop_checkpoints_after(run_dir, stage):
    later = ("svd", "kmeans", "model")
    for s in later[later.index(stage) + 1:]:
        os.remove(os.path.join(run_dir, f"ckpt_{s}.npz"))


@pytest.mark.parametrize("stage", ["svd", "kmeans", "model"])
@pytest.mark.parametrize("option", ["default", "sample_docs"])
def test_streamed_resume_from_jax_checkpoints(tmp_path, corpus, option,
                                              stage):
    """isle_tpu's streamed trainer writes the checkpoints; the port's
    resumes from each stage and ends where the reference ended."""
    cfg = _config(option)
    ref = _jax_streamed(cfg, corpus, tmp_path)
    _drop_checkpoints_after(ref.run_dir, stage)
    got = _port_streamed(cfg, corpus, tmp_path, resume=True)
    _same_run(got, ref, exact_model=stage == "model")


@pytest.mark.parametrize("stage", ["svd", "kmeans"])
def test_jax_streamed_resumes_from_port_checkpoints(tmp_path, corpus, stage):
    cfg = _config("sample_docs")
    ours = _port_streamed(cfg, corpus, tmp_path)
    _drop_checkpoints_after(ours.run_dir, stage)
    ref = _jax_streamed(cfg, corpus, tmp_path, resume=True)
    _same_run(ours, ref)


@pytest.mark.parametrize("stage", ["svd", "kmeans", "model"])
@pytest.mark.parametrize("first", ["incore", "streamed"])
def test_switch_between_incore_and_streamed(tmp_path, corpus, first, stage):
    """A sampled run started by one of the port's trainers and resumed by
    the other from each stage's checkpoint ends where the first ended."""
    cfg = _config("sample_docs")
    start, finish = ((_port_incore, _port_streamed) if first == "incore"
                     else (_port_streamed, _port_incore))
    a = start(cfg, corpus, tmp_path, draws=None)
    _drop_checkpoints_after(a.run_dir, stage)
    b = finish(cfg, corpus, tmp_path, resume=True, draws=None)
    _same_run(b, a, exact_model=stage == "model")
    if stage != "model":
        np.testing.assert_allclose(b.model, a.model, rtol=1e-5, atol=1e-7)


def test_resume_refuses_another_corpus(tmp_path, corpus):
    cfg = _config("default")
    _port_streamed(cfg, corpus, tmp_path)
    with pytest.raises(ValueError, match="different corpus"):
        _port_streamed(cfg, biting_corpus(seed=1), tmp_path, resume=True)


@pytest.mark.parametrize("trainer", ["streamed", "incore"])
def test_mesh_raises(tmp_path, corpus, trainer):
    gpu = GpuConfig(device="cpu", mesh_shape=(4,))
    cfg = _config("default")
    if trainer == "streamed":
        tr = streaming.StreamedTrainer(cfg, output_dir=str(tmp_path),
                                       gpu=gpu)
    else:
        tr = Trainer(cfg, output_dir=str(tmp_path), quiet=True, gpu=gpu)
    tr.load_corpus(corpus)
    # both shard over the ranks of a process group, and there is none
    with pytest.raises(RuntimeError, match="process group"):
        tr.train()
    assert not tr.is_training_complete


def test_streamed_trainer_needs_data(tmp_path):
    tr = streaming.StreamedTrainer(_config("default"),
                                   output_dir=str(tmp_path), gpu=CPU)
    with pytest.raises(RuntimeError, match="load data first"):
        tr.train()
