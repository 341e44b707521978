"""The port's inference path end to end on the CPU: Inferencer.infer_file
against isle_tpu's on a TDF written by the test (the same top-topics
files: doc and topic ids equal, weights within 1e-5; the same aggregates
within 1e-5), and the CLI round trip — isle_tpu_torch.cli.train with
sample=1 writes M_hat_catch_sparse, isle_tpu_torch.cli.infer reads it
back."""

import os
import subprocess
import sys

import numpy as np
import pytest

from isle_tpu.config import InferConfig
from isle_tpu.inferencer import Inferencer as JaxInferencer
from isle_tpu_torch.config import GpuConfig
from isle_tpu_torch.inferencer import Inferencer
from test_end_to_end import planted_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, K = 60, 240, 4


def _model(rng):
    """A planted model: topic t puts most mass on its word block."""
    M = rng.random((V, K)).astype(np.float32) * 0.1
    for t in range(K):
        M[t * (V // K):(t + 1) * (V // K), t] += 1.0
    M[7] = 0.0  # a word without model mass
    return M / M.sum(axis=0, keepdims=True)


def _read_report(path):
    rows = [line.split("\t") for line in open(path).read().splitlines()]
    return (np.array([[int(r[0]), int(r[1])] for r in rows]),
            np.array([float(r[2]) for r in rows]))


@pytest.mark.parametrize("max_entries", [None, 20000])
def test_infer_file_matches_jax(tmp_path, max_entries):
    """Doc ids rebased to doc_begin = 101; with max_entries the per-word
    average divides by the argument, not the entry count (the quirk of
    ISLEInfer.cpp:183)."""
    rng = np.random.default_rng(3)
    text, _ = planted_corpus(rng, V, D, K)
    text = "".join(
        f"{int(d) + 100} {w} {c}\n"
        for d, w, c in (line.split() for line in text.splitlines()))
    tdf = tmp_path / "held_out.tdf"
    tdf.write_text(text)
    M = _model(rng)
    cfg = InferConfig(num_topics=K, vocab_size=V)
    results = {}
    for name, cls, extra in (("jax", JaxInferencer, {}),
                             ("torch", Inferencer,
                              {"gpu": GpuConfig(device="cpu")})):
        inf = cls(cfg, model=M, output_dir=str(tmp_path / name), quiet=True,
                  **extra)
        results[name] = inf.infer_file(str(tdf), 101, 101 + D,
                                       max_entries=max_entries)
    got, ref = results["torch"], results["jax"]
    assert got.num_converged == ref.num_converged > 0.9 * D
    np.testing.assert_array_equal(got.converged, ref.converged)
    for f in ("avg_llh_per_converged_doc", "avg_llh_per_word"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=1e-5)
    if max_entries:
        assert got.avg_llh_per_word == pytest.approx(
            got.llh_weighted.sum() / max_entries, rel=1e-6)
    name = f"top_topics_iters_15_Lf_10.000000_doc_101_to_{101 + D}"
    ids, w = _read_report(tmp_path / "torch" / name)
    ref_ids, ref_w = _read_report(tmp_path / "jax" / name)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(w, ref_w, atol=1e-5)
    assert ids[:, 0].min() >= 101


def test_cli_round_trip(tmp_path):
    """Train with sample=1 through the port's CLI, then infer the same
    TDF from the written model: > 90% of docs converge. A wrong number of
    arguments returns 1."""
    from isle_tpu_torch.cli import infer, train

    rng = np.random.default_rng(7)
    text, _ = planted_corpus(rng, V, D, K)
    tdf = tmp_path / "c.tdf"
    tdf.write_text(text)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("".join(f"w{i}\n" for i in range(V)))
    nnz = len(text.splitlines())
    assert train.main([str(tdf), str(vocab), str(tmp_path / "out"), str(V),
                       str(D), "0", str(K), "0", "1", "0.5", "0", "0",
                       "--device", "cpu", "--seed", "2"]) == 0
    (run,) = os.listdir(tmp_path / "out")
    assert "_sample_1_rate_0.500_" in run
    model = os.path.join(tmp_path, "out", run, "M_hat_catch_sparse")
    out = tmp_path / "infer"
    assert infer.main([model, str(tdf), str(out), str(K), str(V), "1",
                       str(D + 1), str(nnz), "0", "0", "0",
                       "--device", "cpu"]) == 0
    report = out / f"top_topics_iters_15_Lf_10.000000_doc_1_to_{D + 1}"
    docs = {int(line.split("\t")[0])
            for line in report.read_text().splitlines()}
    assert len(docs) > 0.9 * D
    assert infer.main([model, str(tdf)]) == 1
    assert infer.main([model, str(tdf), str(out), str(K), str(V), "1",
                       str(D + 1), str(nnz), "0", "0", "0", "--device"]) == 1


def test_infer_imports_no_jax(tmp_path):
    """The card's host has no jax: run the inference CLI on the CPU with
    `jax` blocked in sys.modules."""
    rng = np.random.default_rng(1)
    text, _ = planted_corpus(rng, V, 40, K)
    tdf = tmp_path / "c.tdf"
    tdf.write_text(text)
    model = tmp_path / "model"
    from isle_tpu import io_text

    io_text.write_sparse_model(str(model), _model(rng))
    code = f"""
import sys
sys.modules["jax"] = None
sys.path.insert(0, {ROOT!r})
from isle_tpu_torch.cli.infer import main
rc = main([{str(model)!r}, {str(tdf)!r}, {str(tmp_path / "o")!r}, "{K}",
           "{V}", "1", "41", "0", "0", "0", "0", "--device", "cpu"])
assert rc == 0
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
print("OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")
