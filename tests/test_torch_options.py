"""The training options beyond the defaults — document sampling, Elkan's,
the k-means|| and AFK-MC^2 seedings, centers copied from the seed
columns of B, and use_explicit_projected_matrix=False — against isle_tpu.

End to end, each option trains the biting corpus with isle_tpu's Trainer
(the reference configuration of tests/torch_parity.py) and with the port
on the CPU replaying the same key schedule: integer results exactly
(original_cols, clusters, catchword sets), models within rtol 1e-4, atol
1e-6. Each new module is also held against its isle_tpu function on the
same inputs. Elkan's is held against isle_tpu's Elkan's: it may differ
from Lloyd's only on exact ties. A sampled run resumes from its stage
checkpoints, either package's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isle_tpu import bmatrix as jbm
from isle_tpu import elkans as jel
from isle_tpu import kmeans as jkm
from isle_tpu import sparse as jsp
from isle_tpu import thresholds as jth
from isle_tpu.config import HyperParams, TrainConfig
from isle_tpu.trainer import Trainer as JaxTrainer
from isle_tpu_torch import bmatrix, elkans, kmeans, sparse
from isle_tpu_torch.config import GpuConfig
from isle_tpu_torch.trainer import Trainer, check_supported
from torch_parity import REFERENCE_TPU, JaxDraws, biting_corpus

CHUNK = 256
CPU = GpuConfig(device="cpu", dense_head_bytes=0)  # as REFERENCE_TPU
OPTIONS = {
    "sample_docs": dict(cfg=dict(sample_docs=True, sample_rate=0.5)),
    "elkans": dict(hp=dict(kmeans_algo_for_sparse="elkans")),
    "kmeansbb": dict(hp=dict(kmeans_init_method="kmeansbb")),
    "kmeansmcmc": dict(hp=dict(kmeans_init_method="kmeansmcmc")),
    "lowd_off": dict(hp=dict(enable_kmeans_on_lowd=False)),
    "lowd_off_mcmc": dict(hp=dict(enable_kmeans_on_lowd=False,
                                  kmeans_init_method="kmeansmcmc")),
    "implicit_projection": dict(hp=dict(use_explicit_projected_matrix=False,
                                        doc_block_size=64)),
}


def _config(option, seed=3):
    o = OPTIONS[option]
    return TrainConfig(
        num_topics=4, seed=seed, compute_edge_topics=True, max_edge_topics=6,
        hyper=HyperParams(**o.get("hp", {})), tpu=REFERENCE_TPU,
        **o.get("cfg", {}),
    )


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_matches_jax_trainer(tmp_path, option):
    corpus = biting_corpus()
    cfg = _config(option)
    check_supported(cfg)
    ref = JaxTrainer(cfg, output_dir=str(tmp_path / "jax"), quiet=True)
    ref.corpus = corpus
    ref._post_ingest()
    ref.train()
    ref.train_edge_topics()
    got = Trainer(cfg, output_dir=str(tmp_path / "torch"), quiet=True,
                  gpu=CPU, draws=JaxDraws(cfg.seed))
    got.load_corpus(corpus)
    got.train()
    got.train_edge_topics()
    np.testing.assert_array_equal(got.original_cols, ref.original_cols)
    np.testing.assert_array_equal(got.cluster_of_doc, ref.cluster_of_doc)
    for a, b in zip(got.catchwords, ref.catchwords):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.evalues, ref.evalues, rtol=1e-4)
    np.testing.assert_allclose(got.model, ref.model, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.edge_pairs, ref.edge_pairs)
    if option == "sample_docs":
        # sampling halves the docs B keeps, and r uses the sample rate
        assert len(got.original_cols) < 0.6 * corpus.num_docs
        r = cfg.hyper.catchword_rank(corpus.num_docs, 4, 0.5)
        assert r < cfg.hyper.catchword_rank(corpus.num_docs, 4)


def test_check_supported_rejects_only_lanczos():
    """The name is from when Lanczos was the one option not ported:
    check_supported now accepts every eigensolver isle_tpu's single-device
    trainer accepts, and refuses what that refuses, as ValueError."""
    for option in OPTIONS:
        check_supported(_config(option))
    for eig in ("block_ks", "dense", "lanczos"):
        check_supported(TrainConfig(
            num_topics=4, hyper=HyperParams(eigensolver=eig)))
    with pytest.raises(ValueError, match="unknown eigensolver 'arpack'"):
        check_supported(TrainConfig(
            num_topics=4, hyper=HyperParams(eigensolver="arpack")))
    with pytest.raises(ValueError, match="seed docs"):
        check_supported(TrainConfig(num_topics=4, hyper=HyperParams(
            enable_kmeans_on_lowd=False, kmeans_init_method="kmeansbb")))
    for bad in (dict(kmeans_init_method="random"),
                dict(kmeans_algo_for_sparse="hamerly")):
        with pytest.raises(ValueError, match="unknown kmeans"):
            check_supported(TrainConfig(num_topics=4,
                                        hyper=HyperParams(**bad)))


def _port_of(J):
    return sparse.DocSparse.from_numpy(
        *(np.asarray(a) for a in (J.d_word, J.d_doc, J.d_val, J.w_word,
                                  J.w_doc, J.w_val)),
        J.vocab, J.num_docs, "cpu",
    )


def _biting_A():
    corpus = biting_corpus()
    J = jsp.DocSparse.from_corpus(corpus, chunk=CHUNK)
    z, _ = jth.compute_thresholds_jax(J.d_word, J.d_val, J.vocab,
                                      corpus.avg_doc_sz, corpus.nz_docs, 4,
                                      HyperParams())
    return J, _port_of(J), z


@pytest.mark.parametrize("rate", [0.25, 0.5, 1.0, 1.5])
def test_sampled_threshold_and_copy(rate):
    """Same uniforms -> the same selected docs and the same B; a rate >= 1
    keeps every doc (the pivot clamp)."""
    J, A, z = _biting_A()
    key = jax.random.PRNGKey(11)
    JB, ref_cols = jbm.threshold_and_copy(J, z, sample_rate=rate, key=key,
                                          chunk=CHUNK)
    draws = JaxDraws.from_keys(b=key)
    B, cols = bmatrix.threshold_and_copy(
        A, torch.from_numpy(np.array(z)), sample_rate=rate,
        uniforms=draws.doc_sample_uniforms(A.num_docs))
    np.testing.assert_array_equal(cols, ref_cols)
    assert B.nnz == JB.nnz
    for f in ("d_word", "d_doc", "d_val", "w_word", "w_doc", "w_val"):
        np.testing.assert_array_equal(
            getattr(B, f).numpy(), np.asarray(getattr(JB, f))[: JB.nnz], f)
    _, all_cols = bmatrix.threshold_and_copy(A, torch.from_numpy(
        np.array(z)))
    if rate >= 1.0:
        np.testing.assert_array_equal(cols, all_cols)
    else:
        assert len(cols) < len(all_cols)


def _projected(seed=5, k=12, kdim=6, D=240):
    rng = np.random.default_rng(seed)
    mus = rng.standard_normal((k, kdim)) * 3
    P = (mus[rng.integers(0, k, D)] + rng.standard_normal((D, kdim))).T
    return np.ascontiguousarray(P, np.float32)


@pytest.mark.parametrize("method", ["kmeansbb", "kmeansmcmc"])
@pytest.mark.parametrize("seed", [0, 1])
def test_seedings_match_jax(method, seed):
    """Same draws -> the same seeds (AFK-MC^2) and centers (both)."""
    P = _projected(seed)
    k = 12
    key = jax.random.PRNGKey(seed + 20)
    ref_idx, ref_c, ref_res = jkm.kmeans_init_on_projected(
        jnp.asarray(P), k, 2, key, method=method, mcmc_sample_size=64)
    idx, c, res = kmeans.kmeans_init_on_projected(
        torch.from_numpy(P), k, 2, JaxDraws.from_keys(km=key),
        method=method, mcmc_sample_size=64)
    if method == "kmeansbb":
        assert idx is None and ref_idx is None
    else:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(res, ref_res, rtol=1e-5)


def test_weighted_kmeanspp_and_lloyds_match_jax():
    P = _projected(3)
    rng = np.random.default_rng(3)
    w = rng.integers(0, 5, P.shape[1]).astype(np.float32)
    key = jax.random.PRNGKey(2)
    ref = jkm._weighted_kmeanspp(jnp.asarray(P), jnp.asarray(w), 8, key)
    got = kmeans._weighted_kmeanspp(torch.from_numpy(P), torch.from_numpy(w),
                                    8, JaxDraws.from_keys(loop=key))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref_c, ref_r = jkm._weighted_lloyds(jnp.asarray(P), jnp.asarray(w), ref,
                                        reps=10)
    c, r = kmeans._weighted_lloyds(torch.from_numpy(P), torch.from_numpy(w),
                                   got, reps=10)
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(r), float(ref_r), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mcmc_chain_matches_literal(seed):
    rng = np.random.default_rng(seed)
    n = 300
    dmin = rng.random(n).astype(np.float32)
    dmin[rng.random(n) < 0.2] = 0.0  # zero distances take the ratio-1 path
    q_s = (rng.random(n) + 0.1).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    assert kmeans.mcmc_chain(dmin, q_s, u) == jkm.mcmc_chain_literal(
        dmin, q_s, u)


def _biting_B():
    J, A, z = _biting_A()
    JB, _ = jbm.threshold_and_copy(J, z, chunk=CHUNK)
    return JB, _port_of(JB)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_elkans_matches_jax(seed):
    """Random docs as start centers: the same assignment and centers as
    isle_tpu's Elkan's, and the fixpoint Lloyd's reaches from there."""
    JB, B = _biting_B()
    rng = np.random.default_rng(seed)
    k = 6
    C0 = sparse.to_dense(B)[:, rng.choice(B.num_docs, k, replace=False)]
    C0 = np.ascontiguousarray(C0.T, np.float32)
    ref_c, ref_a = jel.run_elkans(JB, jnp.asarray(C0), 20, chunk=CHUNK)
    c, a = elkans.run_elkans(B, torch.from_numpy(C0), 20, chunk=CHUNK)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref_a))
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=1e-5,
                               atol=1e-6)
    lc, la = kmeans.run_lloyds_full(B, torch.from_numpy(C0), 20, chunk=CHUNK)
    np.testing.assert_array_equal(a.numpy(), la.numpy())


def _drop_checkpoints_after(run_dir, stage):
    later = ("svd", "kmeans", "model")
    for s in later[later.index(stage) + 1:]:
        os.remove(os.path.join(run_dir, f"ckpt_{s}.npz"))


@pytest.mark.parametrize("draws", ["jax", "default"])
def test_sampled_resume_from_jax_svd_checkpoint(tmp_path, draws):
    """The JAX trainer samples docs and writes ckpt_svd; the port resumes
    from it. B keeps the checkpoint's docs, which U was computed on,
    whatever the port's own draw source would have sampled; with jax's
    draws the whole result equals the JAX run's."""
    corpus = biting_corpus()
    cfg = _config("sample_docs")
    ref = JaxTrainer(cfg, output_dir=str(tmp_path), quiet=True)
    ref.corpus = corpus
    ref._post_ingest()
    ref.train()
    _drop_checkpoints_after(ref.run_dir, "svd")
    got = Trainer(cfg, output_dir=str(tmp_path), quiet=True, gpu=CPU,
                  draws=JaxDraws(cfg.seed) if draws == "jax" else None)
    got.load_corpus(corpus)
    got.train(resume=True)
    np.testing.assert_array_equal(got.original_cols, ref.original_cols)
    np.testing.assert_array_equal(np.flatnonzero(got.cluster_of_doc >= 0),
                                  ref.original_cols)
    if draws == "jax":
        np.testing.assert_array_equal(got.cluster_of_doc, ref.cluster_of_doc)
        np.testing.assert_allclose(got.model, ref.model, rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("stage", ["svd", "kmeans"])
def test_sampled_resume_matches_uninterrupted_run(tmp_path, stage):
    """With the default draw source, a sampled run resumed from its own
    stage checkpoint ends where the uninterrupted run ended: each stage
    draws from a stream of its own."""
    corpus = biting_corpus()
    cfg = _config("sample_docs")

    def port():
        tr = Trainer(cfg, output_dir=str(tmp_path), quiet=True, gpu=CPU)
        tr.load_corpus(corpus)
        return tr

    full = port()
    full.train()
    _drop_checkpoints_after(full.run_dir, stage)
    got = port()
    got.train(resume=True)
    np.testing.assert_array_equal(got.original_cols, full.original_cols)
    np.testing.assert_array_equal(got.cluster_of_doc, full.cluster_of_doc)
    np.testing.assert_array_equal(got.model, full.model)
