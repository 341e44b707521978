"""GpuConfig.break_head_cap (the hybrid head past isle_tpu's int32 row cap)
against isle_tpu's TpuConfig.break_head_cap.

isle_tpu builds a head past the cap in doc blocks (_scatter_head); the
port writes it at an int64 index and lifts only the head-size rule. The
cap is reached at test size through a small flat_cap, or through
hybrid.FLAT_CAP in the trainers, while isle_tpu's own cap does not bind:
with the switch both packages build the head the budget asks for. The
layouts are held as tests/test_torch_hybrid.py holds them (head words,
the head bit for bit, tail, dense B exactly; products within rtol 1e-5),
the trainers as the parity tests hold them (clusters, catchwords and
original_cols exactly, eigenvalues and the model within rtol 1e-4).
Both packages refuse the same inputs: fewer than 8 capped rows without
the switch, a doc block narrower than 8 with it. The sharded layouts keep
the cap, as isle_tpu's do."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isle_tpu import hybrid as jhy
from isle_tpu import matops as jmo
from isle_tpu import sparse as jsp
from isle_tpu.config import HyperParams, TrainConfig
from isle_tpu.trainer import Trainer as JaxTrainer
from isle_tpu_torch import hybrid, matops, sparse, streaming, trainer
from isle_tpu_torch.config import GpuConfig
from isle_tpu_torch.trainer import Trainer
from test_torch_hybrid import assert_same_layout
from torch_parity import HEAD_BYTES, REFERENCE_TPU, REFERENCE_TPU_HYBRID, \
    JaxDraws, biting_corpus

# (60 x 45) at flat_cap 400: the cap is 400 // 46 - 1 = 7 rows, and
# isle_tpu builds a head of 25 rows in 4 doc blocks of at most
# 400 // 26 - 1 = 14 docs
V, D, FLAT = 60, 45, 400
CAP_ON = dataclasses.replace(REFERENCE_TPU_HYBRID, break_head_cap=True)


def _row_constant(seed):
    """A Zipf-spread (V x D) matrix whose row w holds s[w] in every
    nonzero, the shape of the thresholded B, in both packages."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, V + 1)
    mask = rng.random((V, D)) < 0.3 * probs[:, None] * V / probs.sum()
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    w, d = w[order], d[order]
    s = np.sqrt(rng.integers(1, 9, V)).astype(np.float32)
    J = jsp.DocSparse.build(w, d, s[w], V, D, chunk=256)
    A = sparse.DocSparse.from_numpy(
        *(np.asarray(a) for a in (J.d_word, J.d_doc, J.d_val, J.w_word,
                                  J.w_doc, J.w_val)), V, D, "cpu")
    return J, A, s


def _products(h, g, W=6):
    """h_bt_x and h_b_y of the port's layout g against isle_tpu's h."""
    rng = np.random.default_rng(W)
    X = rng.standard_normal((V, W)).astype(np.float32)
    Y = rng.standard_normal((g.num_docs, W)).astype(np.float32)
    for got, ref in ((matops.mat_bt_x(g, torch.from_numpy(X)),
                      jmo.mat_bt_x(h, jnp.asarray(X), 256)),
                     (matops.mat_b_y(g, torch.from_numpy(Y)),
                      jmo.mat_b_y(h, jnp.asarray(Y), 256))):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("seed,num_head", [(0, 25), (1, 8), (2, 43)])
def test_layout_past_the_cap(seed, num_head):
    """to_hybrid with the switch at flat_cap 400: the head isle_tpu builds
    in doc blocks, bit for bit, and the layout the port builds at its
    real cap (the switch lifts only the head-size rule)."""
    J, A, s = _row_constant(seed)
    assert hybrid.max_head_rows(D, FLAT) == 7 < num_head
    ref = jhy.to_hybrid(J, num_head, chunk=256, row_scale=jnp.asarray(s),
                        break_head_cap=True, flat_cap=FLAT)
    got = hybrid.to_hybrid(A, num_head, torch.from_numpy(s), flat_cap=FLAT,
                           break_head_cap=True)
    assert got.num_head == ref.num_head == num_head
    np.testing.assert_array_equal(got.head_words.numpy(),
                                  np.asarray(ref.head_words))
    np.testing.assert_array_equal(got.head.float().numpy(),
                                  np.asarray(ref.head, np.float32))
    assert (got.head_nnz, got.nnz) == (ref.head_nnz, ref.nnz)
    np.testing.assert_array_equal(matops.mat_to_dense(got),
                                  jmo.mat_to_dense(ref))
    _products(ref, got)
    plain = hybrid.to_hybrid(A, num_head, torch.from_numpy(s))
    assert torch.equal(plain.head_words, got.head_words)
    assert torch.equal(plain.head, got.head)
    assert torch.equal(plain.tail.d_word, got.tail.d_word)
    assert torch.equal(plain.tail.w_doc, got.tail.w_doc)


def test_layout_without_the_switch_is_refused_under_eight_rows():
    J, A, s = _row_constant(0)
    with pytest.raises(ValueError, match="max_head_rows=7"):
        jhy.to_hybrid(J, 25, chunk=256, row_scale=jnp.asarray(s),
                      flat_cap=FLAT)
    with pytest.raises(ValueError, match="max_head_rows=7"):
        hybrid.to_hybrid(A, 25, torch.from_numpy(s), flat_cap=FLAT)


@pytest.mark.parametrize("num_head", [44, 60])
def test_a_doc_block_under_eight_is_refused_with_the_switch(num_head):
    """At 44 rows isle_tpu's doc blocks would be 400 // 45 - 1 = 7 docs
    wide: both packages refuse, and at 43 rows both build (above)."""
    J, A, s = _row_constant(0)
    with pytest.raises(ValueError, match="column block < 8"):
        jhy.to_hybrid(J, num_head, chunk=256, row_scale=jnp.asarray(s),
                      break_head_cap=True, flat_cap=FLAT)
    with pytest.raises(ValueError, match="column block < 8"):
        hybrid.to_hybrid(A, num_head, torch.from_numpy(s), flat_cap=FLAT,
                         break_head_cap=True)


def test_a_head_within_the_flat_cap_is_built_at_once():
    """Where (rows + 1) (docs + 1) fits the cap, isle_tpu scatters the head
    at once with or without the switch: the same head in both packages,
    switch on or off."""
    J, A, s = _row_constant(3)
    flat = 9 * (D + 1)  # the cap is 8 rows
    heads = []
    for cap_off in (False, True):
        ref = jhy.to_hybrid(J, 8, chunk=256, row_scale=jnp.asarray(s),
                            break_head_cap=cap_off, flat_cap=flat)
        got = hybrid.to_hybrid(A, 8, torch.from_numpy(s), flat_cap=flat,
                               break_head_cap=cap_off)
        np.testing.assert_array_equal(got.head.float().numpy(),
                                      np.asarray(ref.head, np.float32))
        heads.append(got.head)
    assert torch.equal(*heads) and heads[0].shape == (8, D)


# ---------------------------------------------------------------------------
# The fused builder
# ---------------------------------------------------------------------------


def _fused_inputs():
    """tests/test_hybrid.py's fused-builder case: (70 x 90), counts 1-6,
    ζ 1-3; at flat_cap 400 the cap is 400 // 91 - 1 = 3 rows."""
    rng = np.random.default_rng(31)
    Vf, Df = 70, 90
    w, d = np.nonzero(rng.random((Vf, Df)) < 0.3)
    order = np.lexsort((w, d))
    w, d = w[order], d[order]
    v = rng.integers(1, 7, len(w)).astype(np.float32)
    J = jsp.DocSparse.build(w, d, v, Vf, Df, chunk=512)
    A = sparse.DocSparse.from_numpy(
        *(np.asarray(a) for a in (J.d_word, J.d_doc, J.d_val, J.w_word,
                                  J.w_doc, J.w_val)), Vf, Df, "cpu")
    z = rng.integers(1, 4, Vf).astype(np.float32)
    return J, A, z


@pytest.mark.parametrize("sample", [None, 0.5])
def test_fused_builder_past_the_cap(sample):
    """hybrid_from_thresholds with the switch at a budget of 12 rows over
    A's docs against a cap of 3: isle_tpu's layout (its blocked builds,
    the single-sync one and the sampled one, at the draws of one key)."""
    J, A, z = _fused_inputs()
    assert hybrid.max_head_rows(A.num_docs, FLAT) == 3
    budget = 12 * 2 * A.num_docs
    kw, pkw = {}, {}
    if sample is not None:
        key = jax.random.PRNGKey(7)
        kw = dict(sample_rate=sample, key=key)
        pkw = dict(sample_rate=sample, uniforms=torch.from_numpy(np.array(
            jax.random.uniform(key, (A.num_docs,), jnp.float32))))
    ref = jhy.hybrid_from_thresholds(J, jnp.asarray(z), budget, chunk=512,
                                     break_head_cap=True, flat_cap=FLAT, **kw)
    got = hybrid.hybrid_from_thresholds(A, torch.from_numpy(z), budget,
                                        break_head_cap=True, flat_cap=FLAT,
                                        **pkw)
    g = got[0]
    if sample is None:
        assert g.num_head == 12
    else:
        assert g.num_docs < A.num_docs
        assert g.num_head == budget // (2 * g.num_docs) > 12
    assert_same_layout(ref, got)
    np.testing.assert_array_equal(matops.mat_to_dense(g),
                                  jmo.mat_to_dense(ref[0]))
    _products_fused(ref[0], g)
    # without the switch: the cap over the docs the budget counts
    cap = hybrid.max_head_rows(A.num_docs if sample is None else g.num_docs,
                               FLAT)
    assert cap < 8
    with pytest.raises(ValueError, match=f"max_head_rows={cap}"):
        hybrid.hybrid_from_thresholds(A, torch.from_numpy(z), budget,
                                      flat_cap=FLAT, **pkw)
    with pytest.raises(ValueError, match=f"max_head_rows={cap}"):
        jhy.hybrid_from_thresholds(J, jnp.asarray(z), budget, chunk=512,
                                   flat_cap=FLAT, **kw)


def _products_fused(h, g, W=5):
    rng = np.random.default_rng(W)
    X = rng.standard_normal((g.vocab, W)).astype(np.float32)
    ref = np.asarray(jmo.mat_gram_x(h, jnp.asarray(X), 512))
    got = matops.mat_gram_x(g, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


def test_fused_builder_refuses_a_narrow_doc_block():
    """A budget of 60 rows at flat_cap 400 over 90 docs: isle_tpu's blocks
    would be 400 // 61 - 1 = 5 docs wide. Both refuse before building."""
    J, A, z = _fused_inputs()
    budget = 60 * 2 * A.num_docs
    with pytest.raises(ValueError, match="column block < 8"):
        jhy.hybrid_from_thresholds(J, jnp.asarray(z), budget, chunk=512,
                                   break_head_cap=True, flat_cap=FLAT)
    with pytest.raises(ValueError, match="column block < 8"):
        hybrid.hybrid_from_thresholds(A, torch.from_numpy(z), budget,
                                      break_head_cap=True, flat_cap=FLAT)


def test_head_rows_rule():
    """The budget rule with and without the switch, at the NYTimes shape
    (300,000 docs, 102,660 words) and at the cap's edges."""
    R = hybrid.head_rows
    assert R(4096 << 20, 102_660, 300_000) == 7153
    assert R(8 << 30, 102_660, 300_000) == 7153
    assert R(8 << 30, 102_660, 300_000, break_head_cap=True) == 14_316
    assert R(16 << 30, 102_660, 300_000, break_head_cap=True) == 28_633
    assert R(4096 << 20, 102_660, 300_000, break_head_cap=True) == 7158
    assert R(1, 102_660, 300_000, break_head_cap=True) == 8
    assert R(1 << 40, 50, 300_000, break_head_cap=True) == 50
    # isle_tpu's int32 cap would leave under 8 rows: the switch builds on
    assert hybrid.max_head_rows(300_000_000) == 6
    with pytest.raises(ValueError, match="max_head_rows=6"):
        R(8 << 30, 102_660, 300_000_000)
    assert R(8 << 30, 102_660, 300_000_000, break_head_cap=True) == 14


# ---------------------------------------------------------------------------
# The trainers
# ---------------------------------------------------------------------------


def _config(tpu, sampled=False, edge=True):
    kw = dict(sample_docs=True, sample_rate=0.5) if sampled else {}
    if edge:
        kw.update(compute_edge_topics=True, max_edge_topics=6)
    return TrainConfig(num_topics=4, seed=3, hyper=HyperParams(), tpu=tpu,
                       **kw)


def _same(got, ref):
    np.testing.assert_array_equal(got.original_cols, ref.original_cols)
    np.testing.assert_array_equal(got.cluster_of_doc, ref.cluster_of_doc)
    assert len(got.catchwords) == len(ref.catchwords)
    for a, b in zip(got.catchwords, ref.catchwords):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.evalues, ref.evalues, rtol=1e-4)
    np.testing.assert_allclose(got.model, ref.model, rtol=1e-4, atol=1e-6)
    assert (got.top_pairs is None) == (ref.top_pairs is None)
    for a, b in zip(got.top_pairs or (), ref.top_pairs or ()):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def solved(monkeypatch):
    """The B each trainer's eigensolve gets, in order (solve_gram_eigens
    of trainer.py and streaming.py wrapped)."""
    seen = []
    for mod in (trainer, streaming):
        real = mod.solve_gram_eigens

        def spy(B, *a, _real=real, **kw):
            seen.append(B)
            return _real(B, *a, **kw)

        monkeypatch.setattr(mod, "solve_gram_eigens", spy)
    return seen


@pytest.fixture(scope="module")
def corpus():
    return biting_corpus()


def _port(cfg, corpus, out, gpu, warnings=None):
    tr = Trainer(cfg, output_dir=str(out), quiet=True, gpu=gpu,
                 draws=JaxDraws(cfg.seed))
    if warnings is not None:
        tr.logger.add_sink("warning", warnings.append)
    tr.load_corpus(corpus)
    tr.train()
    tr.train_edge_topics()
    return tr


def _jax(cfg, corpus, out):
    tr = JaxTrainer(cfg, output_dir=str(out), quiet=True)
    tr.corpus = corpus
    tr._post_ingest()
    tr.train()
    tr.train_edge_topics()
    return tr


# hybrid.FLAT_CAP giving a cap of 12 rows, and one of 4 (under 8), over
# the biting corpus's 400 docs; HEAD_BYTES asks for 30 rows
CAPS = {12: 13 * 401, 4: 5 * 401}


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("cap", sorted(CAPS))
def test_trainer_past_the_cap(tmp_path, monkeypatch, solved, corpus, cap,
                              sampled):
    """Trainer with the switch at a lowered cap builds the head of the
    budget, as isle_tpu's Trainer with TpuConfig(break_head_cap=True),
    whose cap does not bind here: the same head rows (its diagnostic
    line) and results."""
    monkeypatch.setattr(hybrid, "FLAT_CAP", CAPS[cap])
    assert hybrid.max_head_rows(corpus.num_docs) == cap
    cfg = _config(CAP_ON, sampled)
    ref = _jax(cfg, corpus, tmp_path / "jax")
    got = _port(cfg, corpus, tmp_path / "torch", dataclasses.replace(
        GpuConfig(device="cpu", dense_head_bytes=HEAD_BYTES),
        break_head_cap=True))
    B = solved[-1]
    assert isinstance(B, hybrid.HybridSparse)
    docs = corpus.num_docs if not sampled else B.num_docs
    assert B.num_head == HEAD_BYTES // (2 * docs) > cap
    _same(got, ref)
    np.testing.assert_array_equal(got.edge_pairs, ref.edge_pairs)
    logs = [open(f"{t.run_dir}/diagnosticLog.txt").read() for t in (got, ref)]
    line = [ln for ln in logs[1].splitlines() if "hybrid layout:" in ln]
    assert line and f"{B.num_head} dense head rows" in line[0]
    assert line[0].split("] ")[-1] in logs[0]


def test_trainer_without_the_switch_keeps_the_cap(tmp_path, monkeypatch,
                                                  solved, corpus):
    """The switch off at a cap of 12 rows: a 12-row head, isle_tpu's
    results at a budget of 12 rows; at a cap of 4, the COO layout with
    the trainer's warning."""
    monkeypatch.setattr(hybrid, "FLAT_CAP", CAPS[12])
    gpu = GpuConfig(device="cpu", dense_head_bytes=HEAD_BYTES)
    got = _port(_config(REFERENCE_TPU_HYBRID), corpus, tmp_path / "t12", gpu)
    assert solved[-1].num_head == 12
    ref = _jax(_config(dataclasses.replace(
        REFERENCE_TPU, dense_head_bytes=12 * 2 * corpus.num_docs)), corpus,
        tmp_path / "j12")
    _same(got, ref)
    monkeypatch.setattr(hybrid, "FLAT_CAP", CAPS[4])
    warnings = []
    _port(_config(REFERENCE_TPU_HYBRID), corpus, tmp_path / "t4", gpu,
          warnings)
    assert not isinstance(solved[-1], hybrid.HybridSparse)
    assert any("falling back to the COO layout" in m for m in warnings)


def _streamed(cfg, corpus, out, gpu):
    st = streaming.StreamedTrainer(
        cfg, output_dir=str(out), chunk_entries=2048, gpu=gpu,
        draws=JaxDraws(cfg.seed, streamed_sampling=cfg.sample_docs))
    st.load_corpus(corpus)
    st.train()
    return st


def _jax_streamed(cfg, corpus, out):
    from isle_tpu import streaming as jst

    tr = jst.StreamedTrainer(cfg, output_dir=str(out), chunk_entries=2048)
    tr._t.corpus = corpus
    tr._t._post_ingest()
    tr.train()
    return tr


@pytest.fixture(scope="module")
def jax_streamed(tmp_path_factory, corpus):
    """isle_tpu's streamed trainer with the switch on (its cap does not
    bind at this size)."""
    return _jax_streamed(_config(CAP_ON, edge=False), corpus,
                         tmp_path_factory.mktemp("jax_streamed"))


@pytest.mark.parametrize("loader", ["wire", "resident"])
def test_streamed_trainer_past_the_cap(tmp_path, monkeypatch, solved, corpus,
                                       jax_streamed, loader):
    """StreamedTrainer's middle with the switch at a cap of 4 rows builds
    the head of the budget over B's docs (isle_tpu/streaming.py:
    1259-1277), on either loader: isle_tpu's results; without the switch
    the same run stays COO (fewer than 8 capped rows)."""
    monkeypatch.setattr(hybrid, "FLAT_CAP", CAPS[4])
    resident = dict(resident_corpus_bytes=0) if loader == "wire" else {}
    gpu = GpuConfig(device="cpu", dense_head_bytes=HEAD_BYTES, **resident)
    cfg = _config(CAP_ON, edge=False)
    got = _streamed(cfg, corpus, tmp_path / "on",
                    dataclasses.replace(gpu, break_head_cap=True))
    assert isinstance(got.loader, streaming.ResidentLoader) == \
        (loader == "resident")
    B = solved[-1]
    nb = len(got.original_cols)
    assert isinstance(B, hybrid.HybridSparse)
    assert B.num_head == HEAD_BYTES // (2 * nb) > 8
    assert hybrid.max_head_rows(nb) == 4
    _same(got, jax_streamed)
    _streamed(cfg, corpus, tmp_path / "off", gpu)
    assert not isinstance(solved[-1], hybrid.HybridSparse)


def test_streamed_plan_shrinks_the_head_past_the_cap(tmp_path, monkeypatch,
                                                     solved, corpus):
    """plan_middle_budget is cap-free in both packages: a head budget the
    plan shrank (hbm_bytes leaves 300 MiB of a 1 GiB budget) reaches the
    middle as it is, and with the switch at a cap of 4 rows every word
    enters the head, as in isle_tpu's streamed trainer at the same
    hbm_bytes; without the switch B stays COO."""
    monkeypatch.setattr(hybrid, "FLAT_CAP", CAPS[4])
    probe = _streamed(_config(REFERENCE_TPU, edge=False), corpus,
                      tmp_path / "probe", GpuConfig(device="cpu",
                                                    dense_head_bytes=0))
    nnz_b = solved[-1].nnz
    slab = probe.loader.slab_bytes
    hbm = slab + (1 << 30) + 96 * nnz_b + (300 << 20)
    keep, head = streaming.plan_middle_budget(hbm, slab, nnz_b, 1 << 30)
    assert keep and head == 300 << 20
    tpu = dataclasses.replace(CAP_ON, dense_head_bytes=1 << 30,
                              hbm_bytes=hbm)
    cfg = _config(tpu, edge=False)
    gpu = GpuConfig(device="cpu", dense_head_bytes=1 << 30, hbm_bytes=hbm)
    got = _streamed(cfg, corpus, tmp_path / "on",
                    dataclasses.replace(gpu, break_head_cap=True))
    B = solved[-1]
    assert isinstance(B, hybrid.HybridSparse) and B.num_head == B.vocab
    ref = _jax_streamed(cfg, corpus, tmp_path / "jax")
    _same(got, ref)
    _streamed(cfg, corpus, tmp_path / "off", gpu)
    assert not isinstance(solved[-1], hybrid.HybridSparse)


# ---------------------------------------------------------------------------
# The sharded layouts keep the cap
# ---------------------------------------------------------------------------


def _jax_shard_hybrid_rows(corpus, tpu):
    """isle_tpu.sharding.shard_hybrid's head rows over a one-device mesh
    for the thresholded B of `corpus` at tpu's head budget."""
    from isle_tpu import sharding as jsh
    from isle_tpu.hybrid import row_scale_from_zetas

    mesh = jsh.make_mesh(1)
    V_, D_ = corpus.vocab_size, corpus.num_docs
    docs = corpus.doc_ids()
    ssp = jsh.shard_doc_sparse(corpus.rows, docs, corpus.vals, V_, D_, mesh)
    ws = jsh.shard_by_word(corpus.rows, docs, corpus.vals, V_, D_, mesh)
    zetas, _ = jsh.sharded_thresholds(ws, corpus.avg_doc_sz, corpus.nz_docs,
                                      4, HyperParams(), mesh)
    B, _ = jsh.sharded_threshold_and_copy(ssp, zetas, mesh)
    H = jsh.shard_hybrid(B, row_scale_from_zetas(zetas), mesh,
                         tpu.dense_head_bytes)
    return H.num_head, B.docs_per_shard


def test_sharded_trainer_keeps_the_cap(tmp_path, monkeypatch):
    """One rank over gloo (tests/torch_dist_worker.py) with a cap of 12
    rows: shard_hybrid builds 12 rows whatever the switch says, as
    isle_tpu's shard_hybrid on one device with its cap lowered alike
    (isle_tpu/sharding.py:1023-1027); the runs with and without the
    switch are bit-equal and end with isle_tpu's results (its trainer on
    one device, which builds the budget's 30 rows)."""
    from isle_tpu.corpus import Corpus as JaxCorpus
    from test_torch_sharded_trainer import CORPORA, HYBRID, K, \
        _assert_same, _jax_sharded, _job, _record_draws
    from torch_dist_worker import load_rank, run_ranks

    (d, w, c), Vs, Ds = CORPORA["synth"]
    np.savez(tmp_path / "synth.npz", docs=d, words=w, counts=c, vocab=Vs,
             num_docs=Ds)
    flat = 13 * (Ds + 1)
    monkeypatch.setattr(jhy, "_INT32_FLAT_CAP", flat)
    rows, dps = _jax_shard_hybrid_rows(
        JaxCorpus.from_entries(d, w, c, vocab_size=Vs, num_docs=Ds), CAP_ON)
    assert dps == Ds and rows == 12 < HEAD_BYTES // (2 * Ds)
    ref = _jax_sharded(tmp_path, "base", CAP_ON, (1,))
    _record_draws(tmp_path / "base_draws.npz", Vs, Ds,
                  len(ref.original_cols), K)
    jobs = [dict(_job(tmp_path, 1, "base", name, gpu=dict(HYBRID, **gpu),
                      flat_cap=flat), infer=False)
            for name, gpu in (("on", dict(break_head_cap=True)),
                              ("off", {}))]
    results = run_ranks(1, jobs, str(tmp_path / "out"), limit=300)
    assert results[0][0] == 0, results[0][1]
    on, off = (load_rank(str(tmp_path / "out"), n, 0) for n in ("on", "off"))
    for key in on:
        if key not in ("stages", "collective_calls"):
            np.testing.assert_array_equal(on[key], off[key], key)
    assert "hybrid layout (sharded)" in list(on["stages"])
    _assert_same(on, ref)
    for job in jobs:
        run_dir = f"{job['out_dir']}/{ref.config.log_dir_name()}"
        assert "sharded hybrid layout: 12 global head rows" in \
            open(f"{run_dir}/diagnosticLog.txt").read()
