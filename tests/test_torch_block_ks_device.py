"""The port's default eigensolver, linalg.block_ks_device (the restart
loop and its float64 Ritz step on the tensors' device), against
isle_tpu.linalg.block_ks_device and against the port's host-driven
block_ks.

Same operator, same key (tests/torch_parity.JaxDraws replays the
reference's start block): nconv, restarts and operator calls equal,
eigenvalues within rtol 1e-4, eigenvectors within atol 2e-4 up to sign
(the tolerances of test_torch_modules.test_block_ks_matches_jax; the
port's Ritz step is float64, the reference's float32). The trainer with
GpuConfig's defaults is held against isle_tpu's trainer with
TpuConfig.device_loop_solver=True at tests/test_golden.py's tolerances."""

import collections
import os

import jax
import numpy as np
import pytest
import torch

from isle_tpu import linalg as jla
from isle_tpu import sparse as jsp
from isle_tpu.config import HyperParams, TrainConfig
from isle_tpu.trainer import Trainer as JaxTrainer
from isle_tpu_torch import linalg, sparse
from isle_tpu_torch.config import GpuConfig
from isle_tpu_torch.trainer import Trainer
from torch_parity import HEAD_BYTES, REFERENCE_TPU_DEVICE_LOOP, \
    REFERENCE_TPU_HYBRID_DEVICE_LOOP, JaxDraws, biting_corpus, golden_corpus

NEV, BLK = 5, 32
CORPORA = {"golden": golden_corpus, "biting": biting_corpus}


def _operators(name):
    """(isle_tpu's DocSparse, the port's copy of it) of one corpus."""
    J = jsp.DocSparse.from_corpus(CORPORA[name](), chunk=256)
    A = sparse.DocSparse.from_numpy(
        *(np.asarray(a) for a in (J.d_word, J.d_doc, J.d_val, J.w_word,
                                  J.w_doc, J.w_val)),
        J.vocab, J.num_docs, "cpu",
    )
    return J, A


def _solve_both(name, start=None, **kw):
    """The reference's and the port's device loops on one corpus's Gram
    operator with the same key, blk and options; `start` (numpy) is the
    start block of both."""
    J, A = _operators(name)
    key = jax.random.PRNGKey(4)
    ref = jla.block_ks_device(
        lambda B_, X: jsp.gram_x(B_, X), J.vocab, NEV, blk=BLK, key=key,
        op_data=J, start_block=None if start is None else jax.numpy.asarray(
            start), **kw)
    got = linalg.block_ks_device(
        lambda X: sparse.gram_x(A, X), A.vocab, NEV,
        JaxDraws.from_keys(eig=key), "cpu", blk=BLK,
        start_block=None if start is None else torch.from_numpy(start),
        **kw)
    return got, ref


def _assert_same_solve(got, ref):
    assert (got.nconv, got.restarts, got.op_calls) == \
        (ref.nconv, ref.restarts, ref.op_calls)
    assert got.evals.dtype == np.float32
    np.testing.assert_allclose(got.evals, np.asarray(ref.evals), rtol=1e-4)
    U = got.evecs.numpy()
    U_ref = np.asarray(ref.evecs)
    np.testing.assert_allclose(linalg.align_signs(U, U_ref), U_ref,
                               atol=2e-4)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_block_ks_device_matches_jax(name):
    got, ref = _solve_both(name)
    assert got.nconv == NEV
    _assert_same_solve(got, ref)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_start_block_matches_jax(name):
    """A warm start (three columns of a previous basis, topped up with
    the random block) seeds both loops alike."""
    J, _ = _operators(name)
    rng = np.random.default_rng(11)
    start = rng.standard_normal((J.vocab, 3)).astype(np.float32)
    got, ref = _solve_both(name, start=start)
    _assert_same_solve(got, ref)
    cold, _ = _solve_both(name)
    assert not np.array_equal(got.evecs.numpy(), cold.evecs.numpy())


@pytest.mark.parametrize("max_restarts", [0, 1])
def test_restart_cap_matches_jax(max_restarts):
    """max_restarts=0: the first truncate only, nothing converged on the
    golden corpus; 1: one restart."""
    got, ref = _solve_both("golden", max_restarts=max_restarts)
    assert got.restarts == max_restarts
    assert got.nconv < NEV
    _assert_same_solve(got, ref)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_device_loop_matches_host_loop(name):
    """The port's two loops: the same restarts and operator calls, one
    diagnostic line for the device loop's solve against one a restart."""
    _, A = _operators(name)
    key = jax.random.PRNGKey(4)

    class Lines:
        def __init__(self):
            self.lines = []

        def diag(self, msg):
            self.lines.append(msg)

    runs = {}
    for solver in (linalg.block_ks_device, linalg.block_ks):
        timer = Lines()
        res = solver(lambda X: sparse.gram_x(A, X), A.vocab, NEV,
                     JaxDraws.from_keys(eig=key), "cpu", blk=BLK,
                     timer=timer)
        runs[solver.__name__] = res, timer.lines
    (got, lines), (host, host_lines) = runs["block_ks_device"], \
        runs["block_ks"]
    _assert_same_solve(got, host)
    assert len(lines) == 1 and lines[0].startswith(
        f"block_ks_device: {got.restarts} restarts, nconv={NEV}/{NEV}")
    assert len(host_lines) == host.restarts + 1


def test_device_loop_reads_back_one_count_a_restart(monkeypatch):
    """Nothing of a restart comes to the host but the converged count
    (int() of a 0-d tensor); the eigenvalues come back once, at the end.
    The host loop reads its mask, zero modes, norms and eigenvalues back
    every restart."""
    rng = np.random.default_rng(3)
    F = torch.from_numpy(rng.standard_normal((300, 40)).astype(np.float32))

    def op(X):
        return F @ (F.T @ X)

    reads = collections.Counter()
    for name in ("cpu", "numpy", "item", "tolist", "__int__", "__float__",
                 "__bool__"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            reads[_name] += 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    key = jax.random.PRNGKey(5)
    res = linalg.block_ks_device(op, 300, NEV, JaxDraws.from_keys(eig=key),
                                 "cpu", blk=BLK)
    device_reads = dict(reads)
    reads.clear()
    host = linalg.block_ks(op, 300, NEV, JaxDraws.from_keys(eig=key), "cpu",
                           blk=BLK)
    monkeypatch.undo()
    assert res.restarts == host.restarts >= 1
    assert device_reads == {"__int__": res.restarts + 1, "cpu": 1,
                            "numpy": 1}, device_reads
    assert reads["cpu"] >= 5 * (host.restarts + 1), dict(reads)


def test_block_ks_strict_raises_as_reference(tmp_path):
    """No restart at a tolerance no float32 run meets: with
    block_ks_strict both trainers raise the same error."""
    hp = HyperParams(block_ks_strict=True, block_ks_max_iters=0,
                     block_ks_tolerance=1e-12)
    cfg = TrainConfig(num_topics=5, seed=7, hyper=hp,
                      tpu=REFERENCE_TPU_DEVICE_LOOP)
    errors = []
    for tr in (JaxTrainer(cfg, output_dir=str(tmp_path / "jax"), quiet=True),
               Trainer(cfg, output_dir=str(tmp_path / "torch"), quiet=True,
                       gpu=GpuConfig(device="cpu", dense_head_bytes=0),
                       draws=JaxDraws(cfg.seed))):
        if isinstance(tr, Trainer):
            tr.load_corpus(golden_corpus())
        else:
            tr.corpus = golden_corpus()
            tr._post_ingest()
        with pytest.raises(RuntimeError, match="block_ks converged only") \
                as err:
            tr.train()
        errors.append(str(err.value).split(" (block_ks_strict")[0])
    assert errors[0] == errors[1] == (
        "block_ks converged only 0/5 eigenpairs within 0 restarts")


# (corpus, k, seed, the reference's TpuConfig, the port's head budget)
TRAINER_CASES = {
    "golden": (golden_corpus, 5, 7, REFERENCE_TPU_DEVICE_LOOP, 0),
    "biting": (biting_corpus, 4, 3, REFERENCE_TPU_DEVICE_LOOP, 0),
    "golden-hybrid": (golden_corpus, 5, 7, REFERENCE_TPU_HYBRID_DEVICE_LOOP,
                      HEAD_BYTES),
}


def _train(tr, corpus):
    if isinstance(tr, Trainer):
        tr.load_corpus(corpus)
    else:
        tr.corpus = corpus
        tr._post_ingest()
    tr.train()
    tr.train_edge_topics()
    return tr


@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_trainer_default_matches_jax_device_loop(tmp_path, case):
    """The port's trainer with GpuConfig's default solver against
    isle_tpu's with its default, device_loop_solver=True: ζ,
    original_cols, clusters and catchword sets exact, the same restarts
    and operator calls, eigenvalues and the models within rtol 1e-4,
    atol 1e-6."""
    make, k, seed, tpu, head_bytes = TRAINER_CASES[case]
    cfg = TrainConfig(num_topics=k, seed=seed, compute_edge_topics=True,
                      max_edge_topics=6, tpu=tpu)
    ref = _train(JaxTrainer(cfg, output_dir=str(tmp_path / "jax"),
                            quiet=True), make())
    got = _train(Trainer(cfg, output_dir=str(tmp_path / "torch"), quiet=True,
                         gpu=GpuConfig(device="cpu",
                                       dense_head_bytes=head_bytes),
                         draws=JaxDraws(seed)), make())
    with np.load(os.path.join(got.run_dir, "ckpt_svd.npz")) as z, \
            np.load(os.path.join(ref.run_dir, "ckpt_svd.npz")) as r:
        np.testing.assert_array_equal(z["zetas"], r["zetas"])
    np.testing.assert_array_equal(got.original_cols, ref.original_cols)
    np.testing.assert_array_equal(got.cluster_of_doc, ref.cluster_of_doc)
    assert len(got.catchwords) == len(ref.catchwords)
    for a, b in zip(got.catchwords, ref.catchwords):
        np.testing.assert_array_equal(a, b)
    assert got.op_counter.calls == ref.op_counter.calls > 0
    np.testing.assert_allclose(got.evalues, ref.evalues, rtol=1e-4)
    np.testing.assert_allclose(got.model, ref.model, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.edge_model, ref.edge_model, rtol=1e-4,
                               atol=1e-6)
    # one diagnostic line for the solve in both, the same restarts and
    # nconv
    lines = []
    for tr in (got, ref):
        with open(os.path.join(tr.run_dir, "diagnosticLog.txt")) as f:
            mine = [ln.split("] ")[-1] for ln in f
                    if "block_ks" in ln]
        assert len(mine) == 1 and mine[0].startswith("block_ks_device: "), \
            mine
        lines.append(mine[0].split(", ")[:2])
    assert lines[0] == lines[1]


def test_gpu_config_defaults_to_the_device_loop():
    """GpuConfig's default is isle_tpu's TpuConfig's."""
    from isle_tpu.config import TpuConfig

    assert GpuConfig().device_loop_solver is True
    assert TpuConfig().device_loop_solver is True
