"""The port's training slice end to end against isle_tpu's Trainer.

Both trainers take the same corpus; the port replays isle_tpu's key
schedule through tests/torch_parity.JaxDraws and runs on the CPU with the
plain versions of its kernels, the JAX trainer runs the reference
configuration (COO layout, both Pallas segment sums in interpret mode).
Integer results must be equal; eigenvalues within rtol 1e-4 and the
models within rtol 1e-4, atol 1e-6: the two frameworks sum float32 in
another order, and the eigensolver's restarts amplify that to ~1e-6
relative in U."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from isle_tpu.config import HyperParams, TrainConfig
from isle_tpu.trainer import Trainer as JaxTrainer
from isle_tpu_torch.config import GpuConfig
from isle_tpu_torch.trainer import Trainer, state_from_numpy
from torch_parity import HEAD_BYTES, REFERENCE_TPU, REFERENCE_TPU_HYBRID, \
    JaxDraws, biting_corpus, golden_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = GpuConfig(device="cpu", dense_head_bytes=0)  # as REFERENCE_TPU
HYBRID = GpuConfig(device="cpu", dense_head_bytes=HEAD_BYTES)


def _config(k, seed, hyper=None, edge=6, tpu=REFERENCE_TPU):
    return TrainConfig(
        num_topics=k, seed=seed, compute_edge_topics=True,
        max_edge_topics=edge, hyper=hyper or HyperParams(), tpu=tpu,
    )


def _run(tr, corpus, resume=False):
    if isinstance(tr, Trainer):
        tr.load_corpus(corpus)
    else:
        tr.corpus = corpus
        tr._post_ingest()
    tr.train(resume=resume)
    tr.train_edge_topics()
    return tr


def _jax(corpus, cfg, out):
    return _run(JaxTrainer(cfg, output_dir=str(out), quiet=True), corpus)


def _port(corpus, cfg, out, resume=False, gpu=CPU):
    tr = Trainer(cfg, output_dir=str(out), quiet=True, gpu=gpu,
                 draws=JaxDraws(cfg.seed))
    return _run(tr, corpus, resume)


def _assert_same_result(got, ref):
    np.testing.assert_array_equal(got.cluster_of_doc, ref.cluster_of_doc)
    np.testing.assert_array_equal(got.original_cols, ref.original_cols)
    assert len(got.catchwords) == len(ref.catchwords)
    for a, b in zip(got.catchwords, ref.catchwords):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.evalues, ref.evalues, rtol=1e-4)
    np.testing.assert_allclose(got.model, ref.model, rtol=1e-4, atol=1e-6)
    for a, b in zip(got.top_pairs, ref.top_pairs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.edge_pairs, ref.edge_pairs)
    np.testing.assert_allclose(got.edge_model, ref.edge_model, rtol=1e-4,
                               atol=1e-6)


def test_golden_corpus_matches_jax_trainer(tmp_path):
    corpus = golden_corpus()
    cfg = _config(5, 7)
    ref = _jax(corpus, cfg, tmp_path / "jax")
    got = _port(corpus, cfg, tmp_path / "torch")
    _assert_same_result(got, ref)
    # ... and the committed golden fixture of tests/test_golden.py
    fix = np.load(os.path.join(ROOT, "tests", "golden_tiny.npz"))
    np.testing.assert_array_equal(got.cluster_of_doc, fix["cluster_of_doc"])
    np.testing.assert_allclose(got.model, fix["model"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("drop", [False, True])
def test_biting_corpus_matches_jax_trainer(tmp_path, drop):
    """Thresholding bites (some ζ > 1, some docs dropped); with `drop`
    both drop flags are on and words get ζ = +inf."""
    corpus = biting_corpus()
    hp = HyperParams(few_samples_threshold_drop=drop, bad_threshold_drop=drop)
    cfg = _config(4, 3, hp)
    ref = _jax(corpus, cfg, tmp_path / "jax")
    got = _port(corpus, cfg, tmp_path / "torch")
    with np.load(os.path.join(got.run_dir, "ckpt_svd.npz")) as z:
        zetas = z["zetas"]
        assert np.isfinite(zetas).all() != drop
        assert (zetas[np.isfinite(zetas)] > 1).any()
    assert len(got.original_cols) < corpus.num_docs
    _assert_same_result(got, ref)


# isle_tpu's default engine, the hybrid layout, with a partial head: the
# in-core options that reach B's products in another way
HYBRID_CASES = {
    "golden": (golden_corpus, 5, 7, {}),
    "biting": (biting_corpus, 4, 3, {}),
    "biting-drop": (biting_corpus, 4, 3, dict(
        few_samples_threshold_drop=True, bad_threshold_drop=True)),
    "elkans": (biting_corpus, 4, 3, dict(kmeans_algo_for_sparse="elkans")),
    "seed-columns": (golden_corpus, 5, 7, dict(enable_kmeans_on_lowd=False)),
    "dense-eigensolver": (biting_corpus, 4, 3, dict(eigensolver="dense")),
}


@pytest.mark.parametrize("case", sorted(HYBRID_CASES))
def test_hybrid_layout_matches_jax_trainer(tmp_path, case):
    """The hybrid layout in both trainers (REFERENCE_TPU_HYBRID and the
    port's dense_head_bytes at the same budget): the same results as the
    COO parity tests, and the same stage labels and head as isle_tpu's."""
    make, k, seed, hyper = HYBRID_CASES[case]
    corpus = make()
    cfg = _config(k, seed, HyperParams(**hyper), tpu=REFERENCE_TPU_HYBRID)
    ref = _jax(corpus, cfg, tmp_path / "jax")
    got = _port(corpus, cfg, tmp_path / "torch", gpu=HYBRID)
    _assert_same_result(got, ref)
    with np.load(os.path.join(got.run_dir, "ckpt_svd.npz")) as z, \
            np.load(os.path.join(ref.run_dir, "ckpt_svd.npz")) as r:
        np.testing.assert_array_equal(z["zetas"], r["zetas"])
    labels = [label for label, *_ in got.timer.phases]
    assert labels == [label for label, *_ in ref.timer.phases]
    assert "creating thresholded matrix (fused hybrid)" in labels
    heads = [open(os.path.join(t.run_dir, "diagnosticLog.txt")).read()
             for t in (got, ref)]
    line = [ln for ln in heads[1].splitlines() if "hybrid layout" in ln]
    assert line and line[0].split("] ")[-1] in heads[0]


def test_hybrid_coo_fallback_past_the_head_cap(tmp_path, monkeypatch):
    """Where the int32 cap leaves fewer than 8 head rows (reached at test
    size through hybrid.FLAT_CAP), the trainer warns and trains B in the
    COO layout: isle_tpu's COO results."""
    from isle_tpu_torch import hybrid

    corpus = biting_corpus()
    monkeypatch.setattr(hybrid, "FLAT_CAP", 5 * (corpus.num_docs + 1))
    cfg = _config(4, 3)
    ref = _jax(corpus, cfg, tmp_path / "jax")
    tr = Trainer(cfg, output_dir=str(tmp_path / "torch"), quiet=True,
                 gpu=HYBRID, draws=JaxDraws(cfg.seed))
    logs = []
    tr.logger.add_sink("warning", logs.append)
    got = _run(tr, corpus)
    assert any("falling back to the COO layout" in m for m in logs), logs
    assert "creating thresholded and scaled matrix" in [
        label for label, *_ in got.timer.phases]
    _assert_same_result(got, ref)


def test_default_config_trains_the_hybrid_layout(tmp_path):
    """GpuConfig's default budget is isle_tpu's, 4 GiB: at test size every
    word is in the head, and the run matches isle_tpu's default engine."""
    import dataclasses

    assert GpuConfig().dense_head_bytes == 4096 << 20
    corpus = golden_corpus()
    cfg = _config(5, 7, tpu=dataclasses.replace(
        REFERENCE_TPU, dense_head_bytes=4096 << 20))
    ref = _jax(corpus, cfg, tmp_path / "jax")
    got = _port(corpus, cfg, tmp_path / "torch",
                gpu=GpuConfig(device="cpu"))
    assert "creating thresholded matrix (fused hybrid)" in [
        label for label, *_ in got.timer.phases]
    _assert_same_result(got, ref)


def test_resume_from_jax_checkpoints(tmp_path):
    """State carried across: the JAX trainer writes its stage checkpoints,
    the port finishes the pipeline from ckpt_kmeans.npz."""
    corpus = biting_corpus(seed=1)
    cfg = _config(4, 5)
    ref = _jax(corpus, cfg, tmp_path)
    os.remove(os.path.join(ref.run_dir, "ckpt_model.npz"))
    got = _port(corpus, cfg, tmp_path, resume=True)
    for a, b in zip(got.catchwords, ref.catchwords):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.catchword_thresholds,
                                  ref.catchword_thresholds)
    np.testing.assert_allclose(got.model, ref.model, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.edge_pairs, ref.edge_pairs)


def test_state_from_numpy_keeps_arrays():
    ck = {"svd": {"U": np.arange(6, dtype=np.float32).reshape(3, 2),
                  "original_cols": np.array([0, 2], np.int32)}}
    st = state_from_numpy(ck, "cpu")
    assert st["svd"]["U"].dtype == torch.float32
    assert st["svd"]["original_cols"].dtype == torch.int32
    np.testing.assert_array_equal(st["svd"]["U"].numpy(), ck["svd"]["U"])


def test_cli_writes_the_run_directory(tmp_path):
    """python -m isle_tpu_torch.cli.train, the 12-argument contract, on the
    CPU; sample=1 trains too, into its own run directory."""
    from test_end_to_end import planted_corpus

    text, _ = planted_corpus(np.random.default_rng(7), 48, 160, 4)
    tdf = tmp_path / "c.tdf"
    tdf.write_text(text)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("".join(f"w{i}\n" for i in range(48)))
    from isle_tpu_torch.cli.train import main

    args = [str(tdf), str(vocab), str(tmp_path / "out"), "48", "160", "0",
            "4", "0", "0", "0", "1", "3", "--device", "cpu"]
    assert main(args) == 0
    run = os.path.join(tmp_path, "out", os.listdir(tmp_path / "out")[0])
    for name in ("M_hat_catch_sparse", "TopWordsPerTopic_catch.txt",
                 "DocCatchword.tsv", "DocTopicCatchwordSums.tsv",
                 "EdgeModel_sparse", "EdgeTopicComposition.txt",
                 "TopTwoTopicsPerDoc.txt", "ckpt_model.npz"):
        assert os.path.exists(os.path.join(run, name)), name
    sampled = list(args)
    sampled[8], sampled[9] = "1", "0.5"
    assert main(sampled) == 0
    assert len(os.listdir(tmp_path / "out")) == 2
    assert main([]) == 1


def test_trains_with_jax_blocked(tmp_path):
    """The card's host has no jax: import isle_tpu_torch and train the
    tiny corpus on the CPU with `jax` blocked in sys.modules."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.path.insert(0, {ROOT!r})
import numpy as np
from isle_tpu.corpus import Corpus
from isle_tpu.config import TrainConfig
from isle_tpu_torch import GpuConfig, Trainer
rng = np.random.default_rng(0)
d = np.repeat(np.arange(60), 8)
w = (rng.integers(0, 10, d.size) + 10 * (d % 3)).astype(np.int64)
key = np.unique(d * 100 + w)
c = Corpus.from_entries(key // 100, key % 100, rng.integers(1, 5, key.size),
                        vocab_size=30, num_docs=60)
tr = Trainer(TrainConfig(num_topics=3, seed=1), output_dir={str(tmp_path)!r},
             quiet=True, gpu=GpuConfig(device="cpu"))
tr.load_corpus(c)
tr.train()
assert tr.model.shape == (30, 3) and np.isfinite(tr.model).all()
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def _trace_events(profile_dir):
    import json

    files = os.listdir(profile_dir)
    assert len(files) == 1 and files[0].endswith(".json"), files
    with open(os.path.join(profile_dir, files[0])) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.parametrize("kind", ["incore", "streamed"])
def test_profile_dir_writes_a_trace(tmp_path, kind):
    """GpuConfig.profile_dir: train() runs inside a torch.profiler trace, a
    Chrome trace lands in the directory, it holds operator events and one
    marker at the end of every timed stage, and the run's results are
    those of an untraced run."""
    from isle_tpu_torch.obs import STAGE_MARK
    from isle_tpu_torch.streaming import StreamedTrainer

    corpus = biting_corpus()
    cfg = _config(4, seed=1)
    make = (Trainer if kind == "incore" else
            lambda *a, **kw: StreamedTrainer(*a, chunk_entries=2048, **kw))
    prof = str(tmp_path / "prof")
    plain = make(cfg, output_dir=str(tmp_path / "plain"), quiet=True, gpu=CPU)
    traced = make(cfg, output_dir=str(tmp_path / "traced"), quiet=True,
                  gpu=GpuConfig(device="cpu", dense_head_bytes=0,
                                profile_dir=prof))
    for tr in (plain, traced):
        tr.load_corpus(corpus)
        tr.train()
    assert not os.path.exists(str(tmp_path / "plain" / "prof"))
    np.testing.assert_array_equal(traced.cluster_of_doc, plain.cluster_of_doc)
    np.testing.assert_array_equal(traced.model, plain.model)
    events = _trace_events(prof)
    assert any(e.get("cat") == "cpu_op" for e in events)
    marks = [e["name"][len(STAGE_MARK):] for e in events
             if e.get("name", "").startswith(STAGE_MARK)]
    staged = [label for label, _ in traced.stage_launches]
    assert marks == staged and len(marks) >= 5
    assert traced._tracing is False


def test_profile_dir_without_a_profiler_warns_and_trains(tmp_path,
                                                         monkeypatch):
    """Where the profiler cannot start, a warning is logged and the run
    goes on untraced, as isle_tpu's trainer does."""
    import torch.profiler

    def broken(*a, **kw):
        raise RuntimeError("no profiler on this back end")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    prof = str(tmp_path / "prof")
    tr = Trainer(_config(4, seed=1), output_dir=str(tmp_path), quiet=True,
                 gpu=GpuConfig(device="cpu", profile_dir=prof))
    logs = []
    tr.logger.add_sink("warning", logs.append)
    tr.load_corpus(biting_corpus())
    tr.train()
    assert tr.is_training_complete and os.listdir(prof) == []
    assert any("torch profiler unavailable" in m for m in logs), logs


def test_profiler_is_not_imported_without_profile_dir():
    """An untraced run pays nothing for the option: torch.profiler's
    machinery is reached only inside profiler_trace with a directory."""
    from isle_tpu_torch.obs import Logger, profiler_trace

    with profiler_trace("", Logger(None, quiet=True), False) as path:
        assert path is None
    assert GpuConfig().profile_dir == ""
