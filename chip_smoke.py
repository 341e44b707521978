"""Smoke run of isle_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from isle_tpu_torch/csrc, trains at the NYTimes shape of bench.py
(vocab 102,660, docs 300,000, 48M nnz, k = 100, edge topics max 2000,
random corpus from a seed), holds each kernel against its plain PyTorch
version on the main path's own streams, and infers the same documents
with the trained model (MWU, ISLEInfer's path).

    python3 chip_smoke.py [--docs N] [--seed S]

--docs cuts the number of documents (the nnz scales with it; vocab and k
stay) and says so on its own line. Phases, in order:

  1. the card (nvidia-smi name and power limit) and torch/CUDA versions;
  2. the kernel build, timed;
  3. a small corpus (bench.py's TINY shape) trained on the card and on
     the CPU (plain versions): equal clusters, eigenvalues within rtol
     1e-4, models within rtol 1e-4, atol 1e-6, top-two topics per doc
     equal but where the doc's catchword masses tie (check_tiny);
  4. the main path: Trainer.train() + train_edge_topics() at the NYTimes
     shape with the launch counts reset just before and read just after;
  5. kernel against plain version on that run's streams (ζ histogram,
     r-th group counts, doc-topic mass, model SpMM), each timed with CUDA
     events: counts exactly equal; sums within rtol 1e-5 of the plain
     version taken in float64 (atomics reorder float32 sums);
  6. checks of the result: both kernels launched on the main path, every
     model column sums (in float64) to 1 within 1e-5 or is all zero,
     eigenvalues finite and descending, at least one catchword;
  7. each training option beyond the defaults (document sampling at rate
     0.5, Elkan's, k-means||, AFK-MC^2, centers from the seed columns of
     B, use_explicit_projected_matrix=False) on the small corpus with
     the dense eigensolver and torch's deterministic algorithms (block
     KS and atomics are phase 3's), card against CPU
     with the tolerances of phase 3, and an inference of the small corpus
     with its model: convergence flags equal, weights within rtol 1e-4,
     atol 1e-6;
  8. inference at full width: the NYTimes docs normalized to unit mass,
     inferred with phase 4's model (iters 15, Lf 10) twice, top 5 per doc
     as the CLI reads them and full weights: wall time, host packing
     time, converged share, average LLHs, peak device memory. Checks:
     every converged row of the full weights sums to 1 within 1e-2, the
     LLHs are finite, at least 90% of docs converge, and on a fixed
     sample of 2,048 docs the card's weights equal a float64 CPU run of
     the plain MWU core within atol 1e-4 with the same convergence flags.
     Whether the two runs' weights are bit-equal is printed. MWU reaches
     no kernel: the launch counts of this run are printed, not required.

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


# The training options beyond the defaults, run on the small corpus.
OPTIONS = {
    "sample_docs rate 0.5": dict(sample_docs=True, sample_rate=0.5),
    "elkans": dict(hyper=dict(kmeans_algo_for_sparse="elkans")),
    "kmeansbb": dict(hyper=dict(kmeans_init_method="kmeansbb")),
    "kmeansmcmc": dict(hyper=dict(kmeans_init_method="kmeansmcmc")),
    "enable_kmeans_on_lowd=False": dict(
        hyper=dict(enable_kmeans_on_lowd=False)),
    # the same product as the default in the port: run to show the option
    # is accepted
    "use_explicit_projected_matrix=False": dict(
        hyper=dict(use_explicit_projected_matrix=False)),
}
MWU_SAMPLE = 2048


def synth_entries(shape: dict, seed: int):
    from bench import synth_corpus

    return synth_corpus(shape["vocab"], shape["docs"], shape["nnz"], seed)


def make_corpus(entries, shape: dict, normalize_to_one: bool = False):
    from isle_tpu_torch import Corpus

    d, w, c = entries
    # synth_corpus returns unique (doc, word) pairs in (doc, word) order
    return Corpus.from_entries(d, w, c, vocab_size=shape["vocab"],
                               num_docs=shape["docs"], sort_dedup=False,
                               normalize_to_one=normalize_to_one)


def train(corpus, shape: dict, seed: int, device: str, out: str,
          hyper=None, **cfg_kw):
    from isle_tpu_torch import GpuConfig, HyperParams, TrainConfig, Trainer

    cfg = TrainConfig(num_topics=shape["k"], seed=seed,
                      compute_edge_topics=True, max_edge_topics=shape["edges"],
                      hyper=HyperParams(**(hyper or {})), **cfg_kw)
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


def tie_flips(gpu, cpu) -> np.ndarray:
    """Docs whose top-two topics differ between the card and the CPU. The
    card's float atomics sum a doc's catchword masses in another order,
    so where two topics' masses tie the argmax may pick the other one:
    each such pick must have the mass of the CPU's pick within rtol 1e-5
    (the CPU's masses). Returns the doc ids."""
    from isle_tpu_torch.topic_model import doc_topic_mass

    g, c = gpu.top_pairs, cpu.top_pairs
    assert np.array_equal(g[2], c[2]), "top-two valid flags differ"
    flip = np.flatnonzero((g[0] != c[0]) | (g[1] != c[1]))
    if flip.size:
        cwt = np.full(cpu.corpus.vocab_size, -1, np.int32)
        for t, words in enumerate(cpu.catchwords):
            cwt[words] = t
        mass = doc_topic_mass(cpu._device_A(), torch.as_tensor(cwt),
                              len(cpu.catchwords)).numpy()
        for got, ref in zip(g[:2], c[:2]):
            np.testing.assert_allclose(
                mass[flip, got[flip]], mass[flip, ref[flip]], rtol=1e-5,
                err_msg="top-two topics differ beyond a tie")
    return flip


def check_tiny(corpus, seed: int, out: str, label: str = "",
               **opts):
    """The small corpus trained on the card and on the CPU with the same
    options: equal clusters, eigenvalues within rtol 1e-4, models within
    rtol 1e-4, atol 1e-6, top-two topics equal up to ties (tie_flips),
    and edge topics within rtol 1e-4, atol 1e-6 of the CPU's edge
    construction from the card's top-two topics. Returns the card's
    trainer."""
    from isle_tpu_torch.topic_model import construct_edge_topics_v2

    tag = label.replace(" ", "_").replace("=", "_")
    gpu = train(corpus, TINY, seed, "cuda",
                os.path.join(out, f"tiny_cuda{tag}"), **opts)
    cpu = train(corpus, TINY, seed, "cpu",
                os.path.join(out, f"tiny_cpu{tag}"), **opts)
    assert np.array_equal(gpu.cluster_of_doc, cpu.cluster_of_doc), \
        f"tiny {label}: clusters differ between the card and the CPU"
    np.testing.assert_allclose(gpu.evalues, cpu.evalues, rtol=1e-4)
    np.testing.assert_allclose(gpu.model, cpu.model, rtol=1e-4, atol=1e-6)
    flips = tie_flips(gpu, cpu)
    hp = cpu.config.hyper
    edge, pairs = construct_edge_topics_v2(
        *gpu.top_pairs, cpu.model, TINY["k"], TINY["edges"],
        min_docs=hp.edge_topic_min_docs,
        primary_ratio=hp.edge_topic_primary_ratio)
    assert np.array_equal(gpu.edge_pairs, pairs), f"tiny {label}: edge pairs"
    np.testing.assert_allclose(gpu.edge_model, edge, rtol=1e-4, atol=1e-6)
    print(f"tiny corpus {TINY}{' ' + label if label else ''}: card == CPU "
          f"(clusters equal, {len(gpu.original_cols)} docs in B, model max "
          f"abs diff {np.abs(gpu.model - cpu.model).max():.3e}, top-two "
          f"topics flipped on ties in {flips.size} docs)")
    return gpu


def inferencer(model: np.ndarray, device: str, out: str):
    from isle_tpu_torch import GpuConfig, InferConfig, Inferencer

    V, k = model.shape
    return Inferencer(InferConfig(num_topics=k, vocab_size=V), model=model,
                      output_dir=out, quiet=True,
                      gpu=GpuConfig(device=device))


def check_tiny_infer(tr, corpus, out: str) -> None:
    """The small corpus inferred with its model on the card and on the
    CPU: equal convergence flags, weights and LLHs within rtol 1e-4, atol
    1e-6."""
    res = {dev: inferencer(tr.model, dev, os.path.join(out, f"infer_{dev}"))
           .infer_corpus(corpus) for dev in ("cuda", "cpu")}
    g, c = res["cuda"], res["cpu"]
    assert np.array_equal(g.converged, c.converged), \
        "tiny inference: convergence differs between the card and the CPU"
    for f in ("weights", "llh_per_doc", "llh_weighted"):
        np.testing.assert_allclose(getattr(g, f), getattr(c, f), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    print(f"tiny inference: card == CPU ({g.num_converged}/{corpus.num_docs} "
          f"converged, weights max abs diff "
          f"{np.abs(g.weights - c.weights).max():.3e})")


def mwu_sample_check(entries, shape: dict, model: np.ndarray, weights,
                     converged, seed: int) -> float:
    """A fixed sample of docs through the plain MWU core in float64 on the
    CPU, against the card's weights: within atol 1e-4, the same
    convergence flags. Returns the max abs difference."""
    from isle_tpu_torch import HyperParams
    from isle_tpu_torch.mwu import build_infer_batch, mwu_core

    hp = HyperParams()
    d, w, c = entries
    V, k = model.shape
    n = min(MWU_SAMPLE, shape["docs"])
    sample = np.sort(np.random.default_rng(seed).choice(
        shape["docs"], n, replace=False))
    keep = np.isin(d, sample)
    sub = make_corpus((np.searchsorted(sample, d[keep]), w[keep], c[keep]),
                      dict(shape, docs=n), normalize_to_one=True)
    batch = build_infer_batch(sub, model.sum(axis=1))
    Mw = torch.cat([torch.from_numpy(model).double(),
                    torch.zeros(1, k, dtype=torch.float64)])
    w64, c64 = [], []
    for lo in range(0, n, 256):
        wi = batch.word_idx[lo:lo + 256]
        L = max(int((wi < V).sum(axis=1).max()), 1)
        wt, ct, _ = mwu_core(Mw, torch.from_numpy(wi[:, :L]),
                             torch.from_numpy(batch.a[lo:lo + 256, :L])
                             .double(), hp.infer_iters_default,
                             hp.infer_Lf_default, hp.infer_max_guesses)
        w64.append(wt.numpy())
        c64.append(ct.numpy())
    w64, c64 = np.concatenate(w64), np.concatenate(c64)
    assert np.array_equal(c64, converged[sample]), \
        "inference: convergence flags differ from the float64 CPU run"
    w64 = np.where(c64[:, None], w64, 1.0 / k)
    err = float(np.abs(weights[sample] - w64).max())
    assert err <= 1e-4, f"inference: max abs err {err} against float64"
    return err


def infer_full(tr, entries, shape: dict, seed: int, out: str) -> None:
    """Phase 8: infer the NYTimes docs with the trained model."""
    from isle_tpu_torch import segsum

    t0 = time.perf_counter()
    corpus = make_corpus(entries, shape, normalize_to_one=True)
    print(f"inference corpus: {corpus.num_docs} docs normalized to unit "
          f"mass in {time.perf_counter() - t0:.1f} s (host)")
    runs = {}
    for top_n in (5, 0):
        inf = inferencer(tr.model, "cuda", os.path.join(out, "infer_nyt"))
        assert inf.device.type == "cuda"
        torch.cuda.reset_peak_memory_stats()
        segsum.reset_launch_counts()
        t0 = time.perf_counter()
        res = inf.infer_corpus(corpus, top_n=top_n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = segsum.launch_counts()
        pack = dict((label, w) for label, w, _ in inf.timer.phases)[
            "pack inference batch"]
        runs[top_n] = res
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"inference top_n={top_n}: {wall:.3f} s wall "
              f"(build_infer_batch {pack:.3f} s host), converged "
              f"{res.num_converged}/{corpus.num_docs}, avg LLH per "
              f"converged doc {res.avg_llh_per_converged_doc:.6f}, avg LLH "
              f"per word {res.avg_llh_per_word:.6f}, peak device memory "
              f"{peak:.2f} GiB, kernel launches {launches}")
    top, full = runs[5], runs[0]
    conv = full.converged
    assert np.array_equal(conv, top.converged), \
        "inference: the two runs converge on other docs"
    assert conv.mean() >= 0.9, f"inference: only {conv.mean():.3f} converged"
    sums = full.weights[conv].sum(axis=1, dtype=np.float64)
    assert np.all(np.abs(sums - 1.0) <= 1e-2), "inference: rows off 1"
    for r in (top, full):
        assert np.isfinite(r.llh_per_doc).all() and \
            np.isfinite(r.llh_weighted).all(), "inference: LLH not finite"
        assert np.isfinite(r.avg_llh_per_converged_doc) and \
            np.isfinite(r.avg_llh_per_word)
    # the top-5 run's kept weights against the same entries of the full run
    kept = (top.weights > 0) & conv[:, None]
    bit_equal = bool(np.array_equal(top.weights[kept], full.weights[kept]))
    err = mwu_sample_check(entries, shape, tr.model, full.weights, conv, seed)
    print(f"inference checks: rows sum to 1 within "
          f"{np.abs(sums - 1.0).max():.2e}; top-5 run bit-equal to the full "
          f"run: {bit_equal}; {min(MWU_SAMPLE, shape['docs'])}-doc sample "
          f"vs float64 CPU max abs "
          f"err {err:.3e}")


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
    tiny_entries = synth_entries(TINY, args.seed)
    tiny = make_corpus(tiny_entries, TINY)
    tiny_tr = check_tiny(tiny, args.seed, out)

    shape = dict(NYT)
    if args.docs != NYT["docs"]:
        shape.update(docs=args.docs,
                     nnz=NYT["nnz"] * args.docs // NYT["docs"])
        print(f"CUT: docs {NYT['docs']} -> {shape['docs']}, nnz target "
              f"{NYT['nnz']} -> {shape['nnz']} (vocab and k unchanged)")
    t0 = time.perf_counter()
    entries = synth_entries(shape, args.seed)
    corpus = make_corpus(entries, shape)
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

    # 7. the other training options and a small inference, card == CPU.
    # Lloyd's meets near ties that rounding decides, so the options run
    # where the card projects the docs exactly as the CPU does: the dense
    # eigensolver (U from the host) and PyTorch's deterministic
    # algorithms (index_add_ without atomics). Phase 3 runs the default
    # path as it is.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label, opts in OPTIONS.items():
            hyper = dict(opts.get("hyper", {}), eigensolver="dense")
            check_tiny(tiny, args.seed, out, label,
                       **{**opts, "hyper": hyper})
    finally:
        torch.use_deterministic_algorithms(False)
    check_tiny_infer(tiny_tr, make_corpus(tiny_entries, TINY,
                                          normalize_to_one=True), out)

    # 8. inference at full width with the main path's model
    tr.A = None  # the training corpus leaves the card
    del corpus
    torch.cuda.empty_cache()
    infer_full(tr, entries, shape, args.seed, out)
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
