"""Smoke run of isle_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from isle_tpu_torch/csrc, trains at the NYTimes shape of bench.py
(vocab 102,660, docs 300,000, 48M nnz, k = 100, edge topics max 2000,
random corpus from a seed), and holds each kernel against its plain
PyTorch version on the main path's own streams.

    python3 chip_smoke.py [--docs N] [--seed S]

--docs cuts the number of documents (the nnz scales with it; vocab and k
stay) and says so on its own line. Phases, in order:

  1. the card (nvidia-smi name and power limit) and torch/CUDA versions;
  2. the kernel build, timed;
  3. a small corpus (bench.py's TINY shape) trained on the card and on
     the CPU (plain versions): equal clusters, eigenvalues within rtol
     1e-4, models within rtol 1e-4, atol 1e-6;
  4. the main path: Trainer.train() + train_edge_topics() at the NYTimes
     shape with the launch counts reset just before and read just after;
  5. kernel against plain version on that run's streams (ζ histogram,
     r-th group counts, doc-topic mass, model SpMM), each timed with CUDA
     events: counts exactly equal; sums within rtol 1e-5 of the plain
     version taken in float64 (atomics reorder float32 sums);
  6. checks of the result: both kernels launched on the main path, every
     model column sums (in float64) to 1 within 1e-5 or is all zero,
     eigenvalues finite and descending, at least one catchword.

Prints a JSON line of the kernels, the card's line, and last
{"ok": true, "device": {...}}. Any failure raises (exit code 1); without a
CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
NYT = dict(vocab=102_660, docs=300_000, nnz=48_000_000, k=100, edges=2000)
TINY = dict(vocab=2_000, docs=3_000, nnz=120_000, k=10, edges=20)
REPS = 5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_corpus(shape: dict, seed: int):
    from bench import synth_corpus
    from isle_tpu_torch import Corpus

    d, w, c = synth_corpus(shape["vocab"], shape["docs"], shape["nnz"], seed)
    # synth_corpus returns unique (doc, word) pairs in (doc, word) order
    return Corpus.from_entries(d, w, c, vocab_size=shape["vocab"],
                               num_docs=shape["docs"], sort_dedup=False)


def train(corpus, shape: dict, seed: int, device: str, out: str):
    from isle_tpu_torch import GpuConfig, TrainConfig, Trainer

    cfg = TrainConfig(num_topics=shape["k"], seed=seed,
                      compute_edge_topics=True, max_edge_topics=shape["edges"])
    tr = Trainer(cfg, output_dir=out, quiet=True,
                 gpu=GpuConfig(device=device))
    tr.load_corpus(corpus)
    tr.train()
    tr.train_edge_topics()
    return tr


def time_ms(fn) -> float:
    """Mean milliseconds of fn() over REPS launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def check_tiny(seed: int, out: str) -> None:
    corpus = make_corpus(TINY, seed)
    gpu = train(corpus, TINY, seed, "cuda", os.path.join(out, "tiny_cuda"))
    cpu = train(corpus, TINY, seed, "cpu", os.path.join(out, "tiny_cpu"))
    assert np.array_equal(gpu.cluster_of_doc, cpu.cluster_of_doc), \
        "tiny: clusters differ between the card and the CPU"
    np.testing.assert_allclose(gpu.evalues, cpu.evalues, rtol=1e-4)
    np.testing.assert_allclose(gpu.model, cpu.model, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gpu.edge_model, cpu.edge_model, rtol=1e-4,
                               atol=1e-6)
    print(f"tiny corpus {TINY}: card == CPU (clusters equal, model max abs "
          f"diff {np.abs(gpu.model - cpu.model).max():.3e})")


def compare_kernels(tr) -> dict:
    """Each kernel against its plain version on the main path's streams."""
    from isle_tpu_torch import segsum, thresholds, topic_model

    A = tr.A
    hp, k = tr.config.hyper, tr.config.num_topics
    V, D = A.vocab, A.num_docs
    dev = A.device
    for name, s in (("w_word", A.w_word), ("d_doc", A.d_doc)):
        assert bool(torch.all(s[1:] >= s[:-1])), f"{name} is not sorted"
    cluster = torch.as_tensor(tr.cluster_of_doc).to(dev)
    cwt = torch.full((V,), -1, dtype=torch.int32)
    for t, cw in enumerate(tr.catchwords):
        cwt[torch.as_tensor(cw, dtype=torch.long)] = t
    cwt = cwt.to(dev)
    F = thresholds.freq_bound(tr.corpus.avg_doc_sz)
    mass = topic_model.doc_topic_mass(A, cwt, k)
    has_cw = torch.bincount(cwt[cwt >= 0].long(), minlength=k) > 0
    thr = topic_model.model_thresholds(mass, has_cw,
                                       hp.model_rank_threshold(D, k))
    W = topic_model._contribution_weights(mass, thr, cluster)

    onehot = [  # (use, seg, col, val, num_segments, ncols)
        ("zeta histogram", A.w_word, thresholds.hist_cols(A.w_val, F), None,
         V, F + 1),
        ("r-th group counts", A.w_word, cluster[A.w_doc], None, V, k),
        ("doc-topic mass", A.d_doc, cwt[A.d_word], A.d_val, D, k),
    ]
    uses = {"segsum_onehot": [], "segsum_gather_rows": []}
    for use, seg, col, val, S, nc in onehot:
        got = segsum.segsum_onehot(seg, col, val, S, nc)
        if val is None:
            ref = segsum.segsum_onehot_plain(seg, col, None, S, nc)
            assert torch.equal(got, ref), f"{use}: counts differ"
            err = 0.0
        else:
            ref = segsum.segsum_onehot_plain(seg, col, val.double(), S, nc)
            err = float((got.double() - ref).abs().max())
            assert torch.allclose(got.double(), ref, rtol=1e-5, atol=0), \
                f"{use}: max abs err {err}"
        uses["segsum_onehot"].append(dict(
            use=use, n=seg.numel(), shape=[S + 1, nc], max_abs_err=err,
            ms=time_ms(lambda: segsum.segsum_onehot(seg, col, val, S, nc)),
            plain_ms=time_ms(lambda: segsum.segsum_onehot_plain(
                seg, col, val, S, nc)),
        ))
    args = (A.w_word, A.w_doc, A.w_val)
    got = segsum.segsum_gather_rows(*args, W, V)
    ref = segsum.segsum_gather_rows_plain(A.w_word, A.w_doc, A.w_val.double(),
                                          W.double(), V)
    err = float((got.double() - ref).abs().max())
    assert torch.allclose(got.double(), ref, rtol=1e-5, atol=0), \
        f"model SpMM: max abs err {err}"
    uses["segsum_gather_rows"].append(dict(
        use="model SpMM B W", n=A.nnz, shape=[V + 1, k], max_abs_err=err,
        ms=time_ms(lambda: segsum.segsum_gather_rows(*args, W, V)),
        plain_ms=time_ms(lambda: segsum.segsum_gather_rows_plain(
            *args, W, V)),
    ))
    return uses


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=NYT["docs"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    sys.path.insert(0, ROOT)
    from isle_tpu_torch import segsum
    from isle_tpu_torch._build import kernels

    t0 = time.perf_counter()
    lib = kernels()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s) -> {os.path.relpath(lib.path)}")
    for line in lib.ptxas_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    out = os.path.join(ROOT, "build", "chip_smoke")
    check_tiny(args.seed, out)

    shape = dict(NYT)
    if args.docs != NYT["docs"]:
        shape.update(docs=args.docs,
                     nnz=NYT["nnz"] * args.docs // NYT["docs"])
        print(f"CUT: docs {NYT['docs']} -> {shape['docs']}, nnz target "
              f"{NYT['nnz']} -> {shape['nnz']} (vocab and k unchanged)")
    t0 = time.perf_counter()
    corpus = make_corpus(shape, args.seed)
    print(f"corpus {shape}: nnz {corpus.nnz}, built in "
          f"{time.perf_counter() - t0:.1f} s (host)")

    torch.cuda.reset_peak_memory_stats()
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    tr = train(corpus, shape, args.seed, "cuda", os.path.join(out, "nyt"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.launch_counts()
    print(f"main path: train + edge topics {wall:.2f} s wall, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"kernel launches {launches}")
    for label, w, _ in tr.timer.phases:
        print(f"  stage {label}: {w:.3f} s")

    uses = compare_kernels(tr)
    for name, rows in uses.items():
        for u in rows:
            print(f"  {name} [{u['use']}] n={u['n']} out={u['shape']}: "
                  f"kernel {u['ms']:.3f} ms, plain {u['plain_ms']:.3f} ms, "
                  f"max abs err {u['max_abs_err']:.3e}")

    assert launches["segsum_onehot"] > 0, "segsum_onehot not launched"
    assert launches["segsum_gather_rows"] > 0, \
        "segsum_gather_rows not launched"
    model = tr.model
    assert model.shape == (shape["vocab"], shape["k"])
    assert np.isfinite(model).all() and np.isfinite(tr.edge_model).all()
    # summed in float64: a float32 sum of 102,660 entries drifts by ~1e-5
    sums = model.sum(axis=0, dtype=np.float64)
    zero = ~model.any(axis=0)
    assert np.all(zero | (np.abs(sums - 1.0) <= 1e-5)), sums
    ev = np.asarray(tr.evalues)
    assert np.isfinite(ev).all() and np.all(np.diff(ev) <= 0), ev
    n_cw = sum(len(c) for c in tr.catchwords)
    assert n_cw > 0, "no catchwords"
    print(f"result: {n_cw} catchwords, {tr.edge_model.shape[1]} edge topics, "
          f"{int(zero.sum())} empty topics, lambda_1 {ev[0]:.6g}, "
          f"lambda_k {ev[-1]:.6g}")
    assert "jax" not in sys.modules, "the port imported jax"

    source = "isle_tpu_torch/csrc/segsum.cu"
    replaces = {"segsum_onehot": "isle_tpu/pallas_ops.py:236",
                "segsum_gather_rows": "isle_tpu/pallas_ops.py:203"}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces[name],
             launches=launches[name],
             max_abs_err=max(u["max_abs_err"] for u in rows),
             ms=sum(u["ms"] for u in rows),
             plain_ms=sum(u["plain_ms"] for u in rows), uses=rows)
        for name, rows in uses.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
