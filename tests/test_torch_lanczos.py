"""The port's Lanczos eigensolver (isle_tpu_torch.linalg.lanczos) and the
eigensolver warm start, against the dense oracle and against isle_tpu.

Same operator, same draws (tests/torch_parity.JaxDraws replays the
reference's start vector and refill directions): eigenvalues within rtol
1e-4, eigenvectors up to sign. The rank-deficient cases reach the
breakdown refill. The trainer option runs end to end on the CPU against
isle_tpu's trainer, and GpuConfig.eigen_warm_start is held to what
tests/test_parity_flags.py asks of TpuConfig.eigen_warm_start."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isle_tpu import linalg as jlinalg
from isle_tpu.config import HyperParams, TrainConfig
from isle_tpu.trainer import Trainer as JaxTrainer
from isle_tpu_torch import linalg
from isle_tpu_torch.config import GpuConfig
from isle_tpu_torch.rng import Draws
from isle_tpu_torch.trainer import Trainer
from torch_parity import REFERENCE_TPU, JaxDraws, biting_corpus

HI = jax.lax.Precision.HIGHEST
CPU = GpuConfig(device="cpu", dense_head_bytes=0)  # as REFERENCE_TPU


def _gram(seed, dim=120, rank=None):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((dim, rank or dim // 2)).astype(np.float32)
    return A, (A @ A.T).astype(np.float32)


def _ops(A):
    """B (B^T x) on the same factor, for the port and for isle_tpu."""
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    return (lambda X: At @ (At.T @ X),
            lambda X: jnp.matmul(Aj, jnp.matmul(Aj.T, X, precision=HI),
                                 precision=HI))


def _separated(w_ref):
    gaps = np.abs(np.diff(w_ref))
    ok = np.ones(len(w_ref), bool)
    ok[1:] &= gaps > 1e-3 * w_ref[0]
    ok[:-1] &= gaps > 1e-3 * w_ref[0]
    return ok


@pytest.mark.parametrize("seed,nev", [(2, 6), (3, 10)])
def test_lanczos_matches_dense_oracle(seed, nev):
    A, S = _gram(seed)
    op, _ = _ops(A)
    res = linalg.lanczos(op, 120, nev, Draws(seed), "cpu", tol=1e-5)
    w_ref, v_ref = linalg.dense_topk_eigh(S, nev)
    assert res.nconv == nev
    assert res.op_calls == (2 * nev + 8) + (nev + 8) * res.restarts
    np.testing.assert_allclose(res.evals, w_ref, rtol=1e-4)
    U = linalg.align_signs(res.evecs.numpy(), v_ref.astype(np.float32))
    ok = _separated(w_ref)
    np.testing.assert_allclose(U[:, ok], v_ref[:, ok], atol=5e-3)


@pytest.mark.parametrize("seed,nev,steps", [(1, 6, None), (4, 5, 3)])
def test_lanczos_matches_jax_with_replayed_draws(seed, nev, steps):
    """The same start vector and refill directions: the same restarts and
    operator calls, eigenvalues within rtol 1e-4, U up to sign. steps=3
    forces restarts."""
    A, S = _gram(seed)
    op, jop = _ops(A)
    key = jax.random.PRNGKey(seed + 10)
    ref = jlinalg.lanczos_device(jop, 120, nev, tol=1e-5, key=key,
                                 steps_per_restart=steps)
    got = linalg.lanczos(op, 120, nev, JaxDraws.from_keys(eig=key), "cpu",
                         tol=1e-5, steps_per_restart=steps)
    assert (got.nconv, got.restarts, got.op_calls) == \
        (ref.nconv, ref.restarts, ref.op_calls)
    if steps:
        assert got.restarts > 0
    np.testing.assert_allclose(got.evals, ref.evals, rtol=1e-4)
    Uref = np.asarray(ref.evecs)
    U = linalg.align_signs(got.evecs.numpy(), Uref)
    ok = _separated(np.asarray(ref.evals, np.float64))
    np.testing.assert_allclose(U[:, ok], Uref[:, ok], atol=5e-3)


@pytest.mark.parametrize("draws", ["default", "jax"])
@pytest.mark.parametrize("rank,nev", [(6, 10), (3, 8)])
def test_lanczos_rank_deficient_breakdown(rank, nev, draws):
    """nev > rank: the recurrence breaks down and refills with fresh
    directions; the tail eigenvalues are exactly 0, the basis stays
    orthonormal and its tail spans the null space."""
    dim = 300
    A, S = _gram(rank, dim=dim, rank=rank)
    op, jop = _ops(A)
    key = jax.random.PRNGKey(0)
    src = Draws(0) if draws == "default" else JaxDraws.from_keys(eig=key)
    res = linalg.lanczos(op, dim, nev, src, "cpu", tol=1e-4, max_restarts=12)
    w_ref, _ = linalg.dense_topk_eigh(S.astype(np.float64), nev)
    assert res.nconv == nev
    np.testing.assert_array_equal(res.evals[rank:], 0.0)
    np.testing.assert_allclose(res.evals[:rank], w_ref[:rank], rtol=1e-4)
    E = res.evecs.numpy().astype(np.float64)
    assert np.abs(E.T @ E - np.eye(nev)).max() < 1e-5
    tail = np.linalg.norm(S.astype(np.float64) @ E[:, rank:], axis=0)
    assert tail.max() < 1e-3 * w_ref[0]
    if draws == "jax":
        ref = jlinalg.lanczos_device(jop, dim, nev, tol=1e-4,
                                     max_restarts=12, key=key)
        assert (res.nconv, res.restarts) == (ref.nconv, ref.restarts)
        np.testing.assert_allclose(res.evals, ref.evals, rtol=1e-4,
                                   atol=1e-6 * w_ref[0])


class _CountingDraws(Draws):
    """Draws that notes the steps it was asked a refill direction for."""

    def __init__(self, seed):
        super().__init__(seed)
        self.refilled = []

    def lanczos_refill(self, j, dim):
        self.refilled.append(j)
        return super().lanczos_refill(j, dim)


@pytest.mark.parametrize("rank,nev", [(60, 6), (6, 10)])
def test_lanczos_refills_only_the_steps_that_break_down(rank, nev):
    """A full-rank run draws no refill direction; a rank-deficient one
    draws them for its broken steps, in step order within a sweep, and
    counts each step's operator call once."""
    dim = 300
    A, _ = _gram(rank, dim=dim, rank=rank)
    op, _ = _ops(A)
    calls = []

    def counted(X):
        calls.append(1)
        return op(X)

    src = _CountingDraws(0)
    res = linalg.lanczos(counted, dim, nev, src, "cpu", tol=1e-4,
                         max_restarts=12)
    assert res.nconv == nev
    assert res.op_calls == (2 * nev + 8) + (nev + 8) * res.restarts
    if rank >= nev + 8:
        assert src.refilled == [] and len(calls) == res.op_calls
    else:
        assert len(src.refilled) >= nev - rank
        assert src.refilled[0] >= rank - 1
        assert len(calls) > res.op_calls  # steps behind a refill, again


def test_lanczos_repeated_leading_eigenvalue():
    rng = np.random.default_rng(42)
    dim, nev = 200, 8
    Q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    lam = np.concatenate([np.full(5, 5.0), [1.0, 0.5, 0.25],
                          np.full(dim - 8, 0.01)])
    A = (Q * np.sqrt(lam)).astype(np.float32)
    op, _ = _ops(A)
    res = linalg.lanczos(op, dim, nev, Draws(1), "cpu", tol=1e-4,
                         max_restarts=30)
    w_ref, _ = linalg.dense_topk_eigh((A @ A.T).astype(np.float64), nev)
    assert res.nconv == nev
    np.testing.assert_allclose(res.evals, w_ref, rtol=1e-4)


def test_lanczos_ncv_exceeds_dim():
    op, _ = _ops(_gram(0, dim=20)[0])
    with pytest.raises(ValueError, match="ncv=25 exceeds dim=20"):
        linalg.lanczos(op, 20, 8, Draws(0), "cpu")


def test_lanczos_start_vector():
    """A nonzero start vector replaces the random one (a zero one does
    not): started at the dominant eigenvector, the first Ritz value is
    there after the first pass."""
    A, S = _gram(5)
    op, _ = _ops(A)
    w_ref, v_ref = linalg.dense_topk_eigh(S, 4)
    v0 = torch.from_numpy(v_ref[:, 0].astype(np.float32))
    warm = linalg.lanczos(op, 120, 4, Draws(0), "cpu", tol=1e-5,
                          start_vector=v0)
    cold = linalg.lanczos(op, 120, 4, Draws(0), "cpu", tol=1e-5)
    zero = linalg.lanczos(op, 120, 4, Draws(0), "cpu", tol=1e-5,
                          start_vector=torch.zeros(120))
    for res in (warm, cold, zero):
        np.testing.assert_allclose(res.evals, w_ref, rtol=1e-4)
    np.testing.assert_array_equal(zero.evals, cold.evals)
    assert not np.array_equal(warm.evecs.numpy(), cold.evecs.numpy())


def _train(trainer_cls, cfg, corpus, out, **kw):
    tr = trainer_cls(cfg, output_dir=str(out), quiet=True, **kw)
    if trainer_cls is JaxTrainer:
        tr.corpus = corpus
        tr._post_ingest()
    else:
        tr.load_corpus(corpus)
    tr.train()
    return tr


@pytest.mark.parametrize("strict", [False, True])
def test_trainer_lanczos_matches_jax_trainer(tmp_path, strict):
    corpus = biting_corpus()
    cfg = TrainConfig(
        num_topics=4, seed=3, tpu=REFERENCE_TPU,
        hyper=HyperParams(eigensolver="lanczos", block_ks_strict=strict))
    ref = _train(JaxTrainer, cfg, corpus, tmp_path / "jax")
    got = _train(Trainer, cfg, corpus, tmp_path / "torch", gpu=CPU,
                 draws=JaxDraws(cfg.seed))
    assert got.op_counter.calls == ref.op_counter.calls > 0
    np.testing.assert_allclose(got.evalues, ref.evalues, rtol=1e-4)
    np.testing.assert_array_equal(got.cluster_of_doc, ref.cluster_of_doc)
    for a, b in zip(got.catchwords, ref.catchwords):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.model, ref.model, rtol=1e-4, atol=1e-6)


def test_trainer_lanczos_agrees_with_block_ks(tmp_path):
    corpus = biting_corpus()

    def run(eig):
        cfg = TrainConfig(num_topics=4, seed=0, hyper=HyperParams(
            block_ks_block_size=8, eigensolver=eig))
        return _train(Trainer, cfg, corpus, tmp_path / eig, gpu=CPU)

    a, b = run("block_ks"), run("lanczos")
    np.testing.assert_allclose(a.evalues, b.evalues, rtol=1e-3, atol=1e-3)


def test_trainer_lanczos_nonconvergence(tmp_path):
    """One restart at a tolerance no float32 run meets: strict raises
    naming the solver, non-strict warns and goes on."""
    corpus = biting_corpus()
    hp = dict(eigensolver="lanczos", block_ks_max_iters=0,
              block_ks_tolerance=1e-12)
    cfg = TrainConfig(num_topics=4, seed=0,
                      hyper=HyperParams(block_ks_strict=True, **hp))
    tr = Trainer(cfg, output_dir=str(tmp_path), quiet=True, gpu=CPU)
    tr.load_corpus(corpus)
    with pytest.raises(RuntimeError, match="lanczos converged only"):
        tr.train()
    cfg = TrainConfig(num_topics=4, seed=0, hyper=HyperParams(**hp))
    tr = Trainer(cfg, output_dir=str(tmp_path), quiet=True, gpu=CPU)
    seen = []
    tr.logger.add_sink("warning", seen.append)
    tr.load_corpus(corpus)
    tr.train()
    assert any("lanczos converged only" in m for m in seen)
    assert np.isfinite(tr.model).all()


@pytest.mark.parametrize("eig", ["block_ks", "lanczos"])
def test_eigen_warm_start(tmp_path, eig):
    """A second run in the same output directory seeds the solver from
    the first run's checkpointed U and reproduces its model; a U of
    another vocab warns and starts cold."""
    corpus = biting_corpus()
    hp = HyperParams(block_ks_block_size=8, eigensolver=eig)
    cfg = TrainConfig(num_topics=4, seed=1, hyper=hp)

    def train(gpu):
        tr = Trainer(cfg, output_dir=str(tmp_path), quiet=True, gpu=gpu)
        seen = []
        tr.logger.add_sink("info", seen.append)
        tr.logger.add_sink("warning", seen.append)
        tr.load_corpus(corpus)
        tr.train()
        return tr, seen

    cold, seen = train(CPU)
    assert not any("eigen_warm_start" in m for m in seen)
    assert cold._warm_start_block(corpus.vocab_size) is None
    warm_gpu = GpuConfig(device="cpu", dense_head_bytes=0,
                         eigen_warm_start=True)
    warm, seen = train(warm_gpu)
    assert any("seeding the eigensolver" in m for m in seen)
    np.testing.assert_allclose(np.sort(warm.evalues), np.sort(cold.evalues),
                               rtol=1e-3)
    np.testing.assert_allclose(warm.model, cold.model, atol=2e-3)
    if eig == "block_ks":  # fewer operator calls from the old subspace
        assert warm.op_counter.calls <= cold.op_counter.calls
    # a checkpoint of another vocab
    import os
    path = os.path.join(cold.run_dir, "ckpt_svd.npz")
    with np.load(path) as z:
        ck = dict(z)
    ck["U"] = ck["U"][:-3]
    np.savez(path, **ck)
    again, seen = train(warm_gpu)
    assert any("cold-starting" in m for m in seen)
    np.testing.assert_array_equal(again.evalues, cold.evalues)
