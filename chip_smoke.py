"""Smoke run of isle_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from isle_tpu_torch/csrc, trains at the NYTimes shape (vocab 102,660, docs
300,000, 48M nnz, k = 100, edge topics max 2000, the random corpus of
isle_tpu_torch.synth from a seed), holds each kernel against its plain
PyTorch version on the main path's own streams, and infers the same
documents with the trained model (MWU, ISLEInfer's path).

    python3 chip_smoke.py [--docs N] [--seed S]

--docs cuts the number of documents (the nnz scales with it; vocab and k
stay) and says so on its own line. Phases, in order:

  1. the card (nvidia-smi name and power limit) and torch/CUDA versions;
  2. the kernel build, timed, with ptxas's registers and spills per
     kernel (a spill fails the run);
  3. a small corpus (the TINY shape below) trained on the card and on
     the CPU (plain versions): equal clusters, eigenvalues within rtol
     1e-4, models within rtol 1e-4, atol 1e-6, top-two topics per doc
     equal but where the doc's catchword masses tie (check_tiny);
  4. the main path: Trainer.train() + train_edge_topics() at the NYTimes
     shape with the launch counts reset just before and read just after;
     then three more training runs of the same corpus and seed: their
     walls, and each one's clusters, catchwords, doc-topic mass, centers,
     model and edge model REQUIRED equal to the first run's, bit for bit
     (no float atomics are left on the path, the projected Lloyd's sums
     by a one-hot matmul, and k-means++ takes its cumulative sum on the
     host); beside them, how many distinct results torch.cumsum gives on
     the card for 200 launches on one vector of the corpus's doc count
     (printed: it is why that sum left the card);
  5. kernel against plain version on the main path's streams, each use
     timed with CUDA events beside its bound (bytes: the stream, the
     table and the output once, at 3.35 TB/s; operations at 67 TFLOP/s
     float32) and one PyTorch library call for the same function:
     segsum_onehot's ζ histogram, r-th group counts, doc-topic mass and
     doc norms of B (library: index_put_ with accumulate=True; the doc
     norms take no column array, and sparse.doc_l2sq is also timed whole
     beside the index_add_ it replaced), each with the row window of its
     kernel, counts exactly equal, sums within rtol 1e-5 of the plain
     version in float64 (the kernel sums float32 in its own fixed order),
     and two launches bit-equal;
     segsum_gather_rows's model SpMM B W (width
     100), eigensolver B^T X and B Y (width 128) and Lloyd's B^T C and
     B onehot (width 100) on the thresholded matrix B (library:
     torch.sparse.mm on a CSR copy of the stream, built outside the
     timed window), each element within 1e-5 |B| |X| of the plain
     version in float64 (|B| |X|: the plain version on absolute values;
     Krylov blocks have mixed signs), and two launches bit-equal;
  6. checks of the result: segsum_onehot launched at least once per
     use on the main path, segsum_gather_rows at least twice per
     eigensolver operator call and
     per full-space Lloyd's iteration plus the projection and the model
     SpMM, every model column sums (in float64) to 1 within 1e-5 or is
     all zero, eigenvalues finite and descending, at least one
     catchword;
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

Between 7 and 8, with the in-core corpus off the card:

  M1. the sharded trainer (Trainer with a sharding.Mesh) at world size 1
     over a one-rank NCCL group whose rendezvous is a file under the
     output directory (if torch.distributed has no NCCL the line says so
     and the mesh has no group), at the NYTimes shape with edge topics,
     launch counts reset just before and read just after, torch's
     library SpMM and sparse constructors made to raise meanwhile: ζ,
     original_cols, clusters and catchword sets equal phase 4's exactly,
     the model within 1e-6; every stage's launches (Trainer.stage_launches)
     equal the in-core stage's; wall, stage walls, peak device memory, the
     collectives' count and the time inside them;
  M2. doc-parallel inference over the same group on the first 20,000 docs
     against the single-device Inferencer: convergence flags equal,
     weights within rtol 2e-5;
  M3. the C shim (isle_tpu_torch/csrc/isle_capi_torch.cpp) built with g++
     and native/capi_smoke.c run against it with ISLE_CAPI_DEVICE=cuda;
  M4. one more in-core run with GpuConfig.profile_dir: the Chrome trace
     must exist and hold CUDA kernel events and a marker for every stage;
     from it, how the eigensolve's time splits into the SpMM kernels, QR,
     the orthogonalization matmuls, other kernels, copies and idle device
     time, with the host's time in the Ritz eigh and in synchronizes;

  S1. streamed training (isle_tpu_torch.streaming.StreamedTrainer) of the
     same corpus at full width, chunk_entries 2^22 (12 chunks), launch
     counts reset just before and read just after: ζ, original_cols and
     B exactly equal to the in-core stages', eigenvalues within rtol 1e-4
     of phase 4's, model columns sum to 1 within 1e-5; stage walls, train
     wall, peak device memory, bytes copied to the card and the share of
     the wall spent waiting for copies. The launch counts are read at
     the end of every stage (Trainer.stage_launches), and each streamed
     pass must have launched its kernel exactly once a chunk: the
     histogram, the mass and the model accumulation, and nothing in the B
     construction. Then a second StreamedTrainer
     resumes from phase 4's ckpt_svd.npz and ckpt_kmeans.npz: the same
     catchwords, the same top-two topics but where a doc's two masses tie
     (within rtol 1e-5: the chunks shift the kernel's order of summing),
     the model within rtol 1e-4, atol 1e-6. Then a third trains with
     document sampling at rate 0.5, the case in which B shrinks to fit
     the card: the sampling weights launch once a chunk as well, ζ
     equals the in-core run's, and the sampled docs and B equal the
     in-core stage's with the same draws (a doc may flip only where its
     dice ties the pivot within rounding);
  S2. the streamed uses of both kernels on a middle chunk against their
     plain versions, as phase 5 does it: the ζ histogram and the model
     accumulation with the carry of the chunks before as `init`, the
     doc-topic mass and the sampling weights on the chunk's local doc ids
     (and the mass once more with a non-zero init); the bound counts the
     chunk's stream, the chunk's rows of the table and the carry read
     and written once; the chunk's sort by word is timed beside them.
     Each use's launches are the counts read from S1's runs;
  S3. Lanczos: the small corpus with eigensolver="lanczos" card against
     CPU (as phase 7), and at the NYTimes shape linalg.lanczos on the
     streamed B against phase 4's block_ks eigenvalues within rtol 1e-3,
     with restarts, operator calls, wall and the width-1 launches' times;
  S4. the reports on the small corpus, card against CPU:
     A_squared_spectrum.txt within rtol 1e-4, M_hat_avg within 1e-5, edge
     topics v1 within 1e-5 with the same selected pairs.

Prints a JSON line of the kernels (per kernel: launches on the driven
paths (in-core, the three streamed runs and Lanczos, each also under
"launches_by_path", the sharded and the traced run among them), max error, and the sums of ms, plain_ms, bound_ms
and library_ms over the uses that a driven path launched, every use
listed under "uses"), the card's line, and last
{"ok": true, "device": {...}}. Any failure raises (exit code 1); without a
CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import datetime
import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
NYT = dict(vocab=102_660, docs=300_000, nnz=48_000_000, k=100, edges=2000)
TINY = dict(vocab=2_000, docs=3_000, nnz=120_000, k=10, edges=20)
REPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# kCells of csrc/segsum.cu: the cells of a warp's window of output rows in
# segsum_onehot (one row of the ζ histogram's 635 columns, 10 of 100)
ONEHOT_WINDOW_CELLS = 1024


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
STREAM_CHUNK_ENTRIES = 1 << 22
STREAM_SAMPLE_RATE = 0.5
ONEHOT, GATHER = "segsum_onehot", "segsum_gather_rows"


def synth_entries(shape: dict, seed: int):
    from isle_tpu_torch.synth import synth_corpus

    return synth_corpus(shape["vocab"], shape["docs"], shape["nnz"], seed)


def make_corpus(entries, shape: dict, normalize_to_one: bool = False):
    from isle_tpu_torch import Corpus

    d, w, c = entries
    # synth_corpus returns unique (doc, word) pairs in (doc, word) order
    return Corpus.from_entries(d, w, c, vocab_size=shape["vocab"],
                               num_docs=shape["docs"], sort_dedup=False,
                               normalize_to_one=normalize_to_one)


def train(corpus, shape: dict, seed: int, device: str, out: str,
          hyper=None, mesh=None, profile_dir: str = "", **cfg_kw):
    from isle_tpu_torch import GpuConfig, HyperParams, TrainConfig, Trainer

    cfg = TrainConfig(num_topics=shape["k"], seed=seed,
                      compute_edge_topics=True, max_edge_topics=shape["edges"],
                      hyper=HyperParams(**(hyper or {})), **cfg_kw)
    tr = Trainer(cfg, output_dir=out, quiet=True, mesh=mesh,
                 gpu=GpuConfig(device=device, profile_dir=profile_dir))
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


def tie_flips(gpu, cpu) -> tuple:
    """Docs whose top-two topics differ between the card and the CPU. The
    card sums a doc's catchword masses in another order than the CPU, so
    where two topics' masses tie the argmax may pick the other one:
    each such pick must have the mass of the CPU's pick within rtol 1e-5
    (the CPU's masses). Returns the doc ids and the largest relative gap
    between the two picks' masses."""
    from isle_tpu_torch.topic_model import doc_topic_mass

    g, c = gpu.top_pairs, cpu.top_pairs
    assert np.array_equal(g[2], c[2]), "top-two valid flags differ"
    flip = np.flatnonzero((g[0] != c[0]) | (g[1] != c[1]))
    gap = 0.0
    if flip.size:
        cwt = np.full(cpu.corpus.vocab_size, -1, np.int32)
        for t, words in enumerate(cpu.catchwords):
            cwt[words] = t
        mass = doc_topic_mass(cpu._device_A(), torch.as_tensor(cwt),
                              len(cpu.catchwords)).numpy().astype(np.float64)
        for got, ref in zip(g[:2], c[:2]):
            a, b = mass[flip, got[flip]], mass[flip, ref[flip]]
            np.testing.assert_allclose(
                a, b, rtol=1e-5, err_msg="top-two topics differ beyond a tie")
            gap = max(gap, float((np.abs(a - b) / np.abs(b)).max()))
    return flip, gap


def check_tiny(corpus, seed: int, out: str, label: str = "",
               **opts):
    """The small corpus trained on the card and on the CPU with the same
    options: equal clusters, eigenvalues within rtol 1e-4, models within
    rtol 1e-4, atol 1e-6, top-two topics equal up to ties (tie_flips),
    and edge topics within rtol 1e-4, atol 1e-6 of the CPU's edge
    construction from the card's top-two topics. Returns the card's and
    the CPU's trainer."""
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
    flips, gap = tie_flips(gpu, cpu)
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
          f"topics flipped on ties in {flips.size} docs, largest relative "
          f"mass gap {gap:.3e})")
    return gpu, cpu


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


def bound(nbytes: int, ops: int) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def onehot_window(nc: int) -> dict:
    """The row window segsum_onehot's kernel reduces `nc` columns in:
    rows of ONEHOT_WINDOW_CELLS cells, column tiles per row."""
    ct = min(nc, ONEHOT_WINDOW_CELLS)
    return {"window_rows": ONEHOT_WINDOW_CELLS // ct,
            "column_tiles": -(-nc // ct)}


def onehot_use(use, seg, col, val, S, nc, launches, whole=None,
               init=None, chunk=2048) -> dict:
    """segsum_onehot against its plain version and index_put_, two
    launches bit-equal. `whole`: {label: fn} of the caller's function
    around the kernel and what it replaced, each timed too. `init`: the
    carry of a streamed use, read once and written once in the bound."""
    from isle_tpu_torch import segsum

    got = segsum.segsum_onehot(seg, col, val, S, nc, init=init, chunk=chunk)
    again = segsum.segsum_onehot(seg, col, val, S, nc, init=init,
                                 chunk=chunk)
    bit_equal = bool(torch.equal(got, again))
    assert bit_equal, f"{use}: two launches differ"
    del again
    if val is None:
        ref = segsum.segsum_onehot_plain(seg, col, None, S, nc, init=init)
        assert torch.equal(got, ref), f"{use}: counts differ"
        err = 0.0
    else:
        ref = segsum.segsum_onehot_plain(
            seg, col, val.double(), S, nc,
            init=None if init is None else init.double())
        err = float((got.double() - ref).abs().max())
        assert torch.allclose(got.double(), ref, rtol=1e-5, atol=0), \
            f"{use}: max abs err {err}"
    n = seg.numel()
    dtype = got.dtype
    # the library call on the entries the kernel counts, indexed outside
    # the timed window
    ok = (seg >= 0) & (seg <= S)
    if col is not None:
        ok &= (col >= 0) & (col < nc)
    si = seg[ok].long()
    ci = torch.zeros_like(si) if col is None else col[ok].long()
    vi = (torch.ones(si.numel(), dtype=dtype, device=seg.device)
          if val is None else val[ok])

    def library():
        start = (torch.zeros((S + 1, nc), dtype=dtype, device=seg.device)
                 if init is None else init.clone())
        return start.index_put_((si, ci), vi, accumulate=True)

    lib_err = float((library().double() - ref.double()).abs().max())
    # seg, col and val where given, read once; the carry read once where
    # there is one; the output written once
    per_entry = 4 + (col is not None) * 4 + (val is not None) * 4
    nbytes = n * per_entry + got.numel() * 4 * (1 + (init is not None))
    bound_ms, bound_by = bound(nbytes, n)
    return dict(
        use=use, n=n, shape=[S + 1, nc], launches=launches, max_abs_err=err,
        bit_equal=bit_equal, window=onehot_window(nc),
        with_init=init is not None, slice_len=chunk,
        whole_ms={label: time_ms(fn) for label, fn in (whole or {}).items()},
        ms=time_ms(lambda: segsum.segsum_onehot(seg, col, val, S, nc,
                                                init=init, chunk=chunk)),
        plain_ms=time_ms(lambda: segsum.segsum_onehot_plain(
            seg, col, val, S, nc, init=init)),
        library_ms=time_ms(library), library_max_abs_err=lib_err,
        bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
    )


def gather_use(use, seg, idx, val, table, S, launches, init=None,
               chunk=2048) -> dict:
    """segsum_gather_rows against its plain version and torch.sparse.mm:
    each element within 1e-5 |B| |X| of the float64 plain version, two
    launches bit-equal. `init`: the carry of a streamed use, read once
    and written once in the bound; `table` holds the rows the stream can
    index and no others, each counted once."""
    from isle_tpu_torch import segsum

    got = segsum.segsum_gather_rows(seg, idx, val, table, S, init=init,
                                    chunk=chunk)
    again = segsum.segsum_gather_rows(seg, idx, val, table, S, init=init,
                                      chunk=chunk)
    bit_equal = bool(torch.equal(got, again))
    assert bit_equal, f"{use}: two launches differ"
    del again
    ref = segsum.segsum_gather_rows_plain(
        seg, idx, val.double(), table.double(), S,
        init=None if init is None else init.double())
    scale = segsum.segsum_gather_rows_plain(
        seg, idx, val.double().abs(), table.double().abs(), S,
        init=None if init is None else init.double().abs())
    diff = (got.double() - ref).abs()
    err = float(diff.max())
    worst = float((diff / scale.clamp(min=1e-300)).max())
    assert bool((diff <= 1e-5 * scale).all()), \
        f"{use}: max abs err {err}, max err / (|B| |X|) {worst}"
    del scale, diff
    rows, W = table.shape
    n = seg.numel()
    # the library call: cuSPARSE SpMM on a CSR copy of the sorted stream
    # (made outside the timed window); the port never calls it
    crow = torch.zeros(S + 1, dtype=torch.int64, device=seg.device)
    crow[1:] = torch.cumsum(torch.bincount(seg.long(), minlength=S + 1)[:S],
                            0)
    csr = torch.sparse_csr_tensor(crow.int(), idx, val, size=(S, rows),
                                  check_invariants=False)

    def library():
        out = torch.sparse.mm(csr, table)
        return out if init is None else out + init[:S]

    lib_err = float((library().double() - ref[:S]).abs().max())
    del ref
    nbytes = (n * 12 + table.numel() * 4
              + got.numel() * 4 * (1 + (init is not None)))
    bound_ms, bound_by = bound(nbytes, 2 * n * W)
    return dict(
        use=use, n=n, shape=[S + 1, W], table=[rows, W], launches=launches,
        max_abs_err=err, err_over_abs_bound=worst, bit_equal=bit_equal,
        with_init=init is not None, slice_len=chunk,
        ms=time_ms(lambda: segsum.segsum_gather_rows(seg, idx, val, table,
                                                     S, init=init,
                                                     chunk=chunk)),
        plain_ms=time_ms(lambda: segsum.segsum_gather_rows_plain(
            seg, idx, val, table, S, init=init)),
        library_ms=time_ms(library), library_max_abs_err=lib_err,
        bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
    )


def lloyds_reps(tr) -> int:
    """Full-space Lloyd's iterations of the run, from its diagnostic log."""
    path = os.path.join(tr.run_dir, "diagnosticLog.txt")
    with open(path) as f:
        reps = [int(line.split("ran ")[1].split()[0]) for line in f
                if line.startswith("full lloyds ran ")]
    assert reps, f"no full-space Lloyd's line in {path}"
    return reps[-1]


def catchword_topics(tr, device="cuda") -> torch.Tensor:
    """(vocab,) int32 on `device`: each catchword's topic in run `tr`, -1
    for the other words."""
    cwt = torch.full((tr.corpus.vocab_size,), -1, dtype=torch.int32)
    for t, cw in enumerate(tr.catchwords):
        cwt[torch.as_tensor(cw, dtype=torch.long)] = t
    return cwt.to(device)


def onehot_streams(tr) -> tuple:
    """The main path's segsum_onehot uses of a trained run, as (use, seg,
    col, val, S, ncols, launches on the main path), and the thresholded
    matrix B: the ζ histogram, the r-th group counts and the doc-topic
    mass on A's streams, the doc norms (sparse.doc_l2sq) on B's."""
    from isle_tpu_torch import bmatrix, thresholds

    A = tr.A
    hp, k = tr.config.hyper, tr.config.num_topics
    V, D = A.vocab, A.num_docs
    for name, s in (("w_word", A.w_word), ("d_doc", A.d_doc)):
        assert bool(torch.all(s[1:] >= s[:-1])), f"{name} is not sorted"
    cluster = torch.as_tensor(tr.cluster_of_doc).to(A.device)
    cwt = catchword_topics(tr)
    F = thresholds.freq_bound(tr.corpus.avg_doc_sz)

    # B as the main path built it (no sampling: the same thresholds)
    zetas, _ = thresholds.compute_thresholds(
        A, tr.corpus.avg_doc_sz, tr.corpus.nz_docs, k, hp)
    B, cols = bmatrix.threshold_and_copy(A, zetas)
    assert np.array_equal(cols, tr.original_cols), "B differs from the run's"
    return (
        ("zeta histogram", A.w_word, thresholds.hist_cols(A.w_val, F), None,
         V, F + 1, 1),
        ("r-th group counts", A.w_word, cluster[A.w_doc], None, V, k, 1),
        ("doc-topic mass", A.d_doc, cwt[A.d_word], A.d_val, D, k, 1),
        # sparse.doc_l2sq: Frob(B) and the full-space Lloyd's
        ("doc norms of B", B.d_doc, None, B.d_val * B.d_val, B.num_docs, 1,
         2),
    ), B


def compare_kernels(tr, launches: dict, seed: int) -> dict:
    """Each kernel against its plain version, at the main path's shapes on
    its own streams: A's for the three onehot uses and the model SpMM,
    the thresholded B's for the doc norms and the SpMM of the eigensolver
    and of Lloyd's."""
    from isle_tpu_torch import sparse, topic_model

    A = tr.A
    hp, k = tr.config.hyper, tr.config.num_topics
    V, D = A.vocab, A.num_docs
    dev = A.device
    cluster = torch.as_tensor(tr.cluster_of_doc).to(dev)
    cwt = catchword_topics(tr)
    mass = topic_model.doc_topic_mass(A, cwt, k)
    has_cw = torch.bincount(cwt[cwt >= 0].long(), minlength=k) > 0
    thr = topic_model.model_thresholds(mass, has_cw,
                                       hp.model_rank_threshold(D, k))
    Wc = topic_model._contribution_weights(mass, thr, cluster)
    del mass
    streams, B = onehot_streams(tr)

    def index_add_l2sq():  # sparse.doc_l2sq before it ran on the kernel
        return torch.zeros(B.num_docs, device=dev).index_add_(
            0, B.d_doc, B.d_val * B.d_val)

    whole = {"doc norms of B": {
        "sparse.doc_l2sq": lambda: sparse.doc_l2sq(B),
        "index_add_ (before)": index_add_l2sq}}
    uses = {"segsum_onehot": [], "segsum_gather_rows": []}
    for use, seg, col, val, S, nc, n_launch in streams:
        uses["segsum_onehot"].append(
            onehot_use(use, seg, col, val, S, nc, n_launch, whole.get(use)))
    del streams
    calls, reps = tr.op_counter.calls, lloyds_reps(tr)
    blk = hp.block_ks_block_size
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((V, blk), generator=g).to(dev)  # a Krylov block
    Y = sparse.bt_x(B, X)
    centers = torch.as_tensor(tr.centers).T.contiguous().to(dev)
    assign = torch.as_tensor(tr.cluster_of_doc[tr.original_cols]).long().to(
        dev)
    onehot = torch.nn.functional.one_hot(assign, k).to(torch.float32)
    d_stream = (B.d_doc, B.d_word, B.d_val)
    w_stream = (B.w_word, B.w_doc, B.w_val)
    for use, stream, table, S, n_launch in (
        ("model SpMM B W", (A.w_word, A.w_doc, A.w_val), Wc, V, 1),
        ("eigensolver B^T X", d_stream, X, B.num_docs, calls),
        ("eigensolver B Y", w_stream, Y, V, calls),
        ("Lloyd's B^T C (+ projection)", d_stream, centers, B.num_docs,
         reps + 1),
        ("Lloyd's B onehot", w_stream, onehot, V, reps),
    ):
        uses["segsum_gather_rows"].append(
            gather_use(use, *stream, table, S, n_launch))
    return uses


def run_mass(tr) -> torch.Tensor:
    """The doc-topic mass of a run (segsum_onehot on the card), from its
    catchwords."""
    from isle_tpu_torch.topic_model import doc_topic_mass

    return doc_topic_mass(tr.A, catchword_topics(tr), len(tr.catchwords))


def cumsum_probe(n: int, launches: int = 200) -> None:
    """How reproducible torch.cumsum is on the card: distinct results of
    `launches` launches on one vector of n floats (beside torch.sum and a
    float32 matmul reduced over n, which the path still runs there)."""
    g = torch.Generator().manual_seed(0)
    x = ((torch.rand(n, generator=g) ** 4) * 50).cuda()
    a = torch.randn((100, n), generator=g).cuda()

    def distinct(fn):
        seen = []
        for _ in range(launches):
            out = fn()
            if not any(torch.equal(out, s) for s in seen):
                seen.append(out)
        return len(seen)

    print(f"reproducibility on the card, {launches} launches on one input "
          f"of {n} floats: torch.cumsum {distinct(lambda: torch.cumsum(x, 0))}"
          f" distinct results, torch.sum {distinct(lambda: torch.sum(x))}, "
          f"float32 matmul (100 x {n}) @ ({n} x 100) "
          f"{distinct(lambda: a @ a.T)}")


def train_again(corpus, shape, seed, out, first) -> None:
    """One more training run of the same corpus and seed: its wall, and
    its results required equal to the first run's, bit for bit."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = train(corpus, shape, seed, "cuda", out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_cw = [sum(len(c) for c in t.catchwords) for t in (first, tr)]
    n_edge = [t.edge_model.shape[1] for t in (first, tr)]
    same = {
        "clusters": np.array_equal(tr.cluster_of_doc, first.cluster_of_doc),
        "catchwords": all(np.array_equal(a, b) for a, b in
                          zip(tr.catchwords, first.catchwords)),
        "doc-topic mass": bool(torch.equal(run_mass(tr), run_mass(first))),
        "eigenvalues": np.array_equal(tr.evalues, first.evalues),
        "centers": np.array_equal(tr.centers, first.centers),
        "model": np.array_equal(tr.model, first.model),
        "edge model": np.array_equal(tr.edge_model, first.edge_model),
    }
    print(f"repeated training run: {wall:.2f} s wall; catchwords {n_cw[1]} "
          f"(first {n_cw[0]}), edge topics {n_edge[1]} (first {n_edge[0]}); "
          + ", ".join(f"{name} equal: {ok}" for name, ok in same.items()))
    tr.A = None
    differ = [name for name, ok in same.items() if not ok]
    assert not differ, \
        f"a repeated run of one tree differs from the first in {differ}"


def print_uses(uses: dict, path: str) -> None:
    for name, rows in uses.items():
        for u in rows:
            print(f"  {name} [{u['use']}] n={u['n']} out={u['shape']}: "
                  f"kernel {u['ms']:.3f} ms, plain {u['plain_ms']:.3f} ms, "
                  f"library {u['library_ms']:.3f} ms, bound "
                  f"{u['bound_ms']:.3f} ms "
                  f"({u['bound_by']}: {u['bound_bytes']} B), launches on "
                  f"the {path} {u['launches']}, max abs err "
                  f"{u['max_abs_err']:.3e}, bit-equal across two launches "
                  f"{u['bit_equal']}"
                  + (f", window {u['window']['window_rows']} row(s) x "
                     f"{u['shape'][1]} columns in "
                     f"{u['window']['column_tiles']} column tile(s)"
                     if "window" in u else "")
                  + "".join(f"; {label} {ms:.3f} ms"
                            for label, ms in u.get("whole_ms", {}).items()))


def run_dir_arrays(tr, stage: str) -> dict:
    with np.load(os.path.join(tr.run_dir, f"ckpt_{stage}.npz")) as z:
        return dict(z)


def streamed_trainer(corpus, shape, seed, out, **cfg_kw):
    from isle_tpu_torch import GpuConfig, TrainConfig
    from isle_tpu_torch.streaming import StreamedTrainer

    cfg = TrainConfig(num_topics=shape["k"], seed=seed,
                      compute_edge_topics=True,
                      max_edge_topics=shape["edges"], **cfg_kw)
    st = StreamedTrainer(cfg, output_dir=out, quiet=True,
                         chunk_entries=STREAM_CHUNK_ENTRIES,
                         gpu=GpuConfig(device="cuda"))
    st.load_corpus(corpus)
    return st


def stage_launches(tr) -> dict:
    """{stage: {kernel: launches within the stage}} of a run whose launch
    counts were set to 0 just before it."""
    per, last = {}, {ONEHOT: 0, GATHER: 0}
    for label, now in tr.stage_launches:
        per[label] = {name: now[name] - last[name] for name in now}
        last = now
    return per


def check_streamed_launches(per: dict, chunks: int, label: str) -> None:
    """Every streamed pass of a run launched its kernel exactly once a
    chunk (the catchword pass: one launch for the group counts), by the
    counts read at the end of each stage."""
    want = {
        "streamed thresholds": (chunks, 0),  # the ζ histogram
        "streamed doc sampling": (chunks, 0),  # the doc weights
        "streamed B construction": (0, 0),
        "streamed catchwords": (1, 0),  # the r-th group counts
        # the doc-topic mass and the model accumulation
        "streamed topic model": (chunks, chunks),
    }
    for stage, counts in per.items():
        if stage in want:
            assert (counts[ONEHOT], counts[GATHER]) == want[stage], \
                f"{label}: stage {stage!r} launched {counts}, expected " \
                f"(onehot, gather) = {want[stage]} with {chunks} chunks"
    print(f"{label}: launches by stage (segsum_onehot, segsum_gather_rows): "
          + "; ".join(f"{stage} ({c[ONEHOT]}, {c[GATHER]})"
                      for stage, c in per.items()))


def run_streamed(st) -> tuple:
    """train() + train_edge_topics() of a streamed trainer with the launch
    counts set to 0 just before. Returns (wall seconds, (peak device GiB,
    GiB held on the card before the run), launch counts, launches by
    stage)."""
    from isle_tpu_torch import segsum

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    st.train()
    st.train_edge_topics()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (wall, (torch.cuda.max_memory_allocated() / 2**30, held),
            segsum.launch_counts(), stage_launches(st))


def print_streamed_run(label, st, wall, peak, launches) -> None:
    loader = st.loader
    wait_s = loader.copy_wait_ms() / 1e3
    copied = loader.bytes_copied
    print(f"{label}: train + edge topics {wall:.2f} s wall in "
          f"{len(loader.ranges)} chunks of at most {STREAM_CHUNK_ENTRIES} "
          f"entries, peak device memory {peak[0]:.2f} GiB ({peak[1]:.2f} "
          f"GiB of it held before the run), kernel launches "
          f"{launches}; {copied} bytes copied to the card "
          f"({copied / (8 * loader.corpus.nnz):.2f} passes over the "
          f"corpus's word ids and values); the stream waited {wait_s:.4f} s "
          f"for copies ({wait_s / wall:.2%} of the wall), the host "
          f"{loader.host_wait_seconds:.4f} s for a free staging buffer "
          f"({loader.host_wait_seconds / wall:.2%})")
    for stage, w, _ in st.timer.phases:
        print(f"  {label} stage {stage}: {w:.3f} s")


def assert_same_b(B, IB) -> None:
    assert B.num_docs == IB.num_docs
    for f in ("d_word", "d_doc", "d_val", "w_word", "w_doc", "w_val"):
        assert torch.equal(getattr(B, f), getattr(IB, f)), f"streamed B: {f}"


def streamed_phase(corpus, shape, seed, out, tr):
    """Phase S1. Returns the streamed trainer, its launch counts, its
    launches by stage and B on the card."""
    from isle_tpu_torch import bmatrix, streaming
    from isle_tpu_torch.sparse import DocSparse

    st = streamed_trainer(corpus, shape, seed, os.path.join(out, "nyt_s"))
    wall, peak, launches, per = run_streamed(st)
    loader = st.loader
    print_streamed_run("streamed path", st, wall, peak, launches)
    check_streamed_launches(per, len(loader.ranges), "streamed path")
    assert "streamed doc sampling" not in per
    assert per["eigen solve (B B^T)"][GATHER] >= 2 * st.op_counter.calls

    ours, ref = run_dir_arrays(st, "svd"), run_dir_arrays(tr, "svd")
    assert np.array_equal(ours["zetas"], ref["zetas"]), "streamed zetas"
    assert np.array_equal(ours["original_cols"], ref["original_cols"])
    np.testing.assert_allclose(ours["evalues"], ref["evalues"], rtol=1e-4)
    sums = st.model.sum(axis=0, dtype=np.float64)
    zero = ~st.model.any(axis=0)
    assert np.all(zero | (np.abs(sums - 1.0) <= 1e-5)), sums
    assert np.isfinite(st.model).all() and np.isfinite(st.edge_model).all()
    # B: the in-core stage on the whole corpus against the streamed one
    A = DocSparse.from_corpus(corpus, "cuda")
    z = torch.from_numpy(ref["zetas"]).cuda()
    IB, in_cols = bmatrix.threshold_and_copy(A, z)
    B, cols = streaming.streamed_build_b(corpus, z, None, loader)
    assert np.array_equal(cols, in_cols)
    assert_same_b(B, IB)
    del A, IB
    n_cw = sum(len(c) for c in st.catchwords)
    print(f"streamed checks: zetas, original_cols and B ({B.nnz} nnz, "
          f"{B.num_docs} docs) equal the in-core stages'; eigenvalues max "
          f"rel diff {np.abs(ours['evalues'] / ref['evalues'] - 1).max():.2e}"
          f"; {n_cw} catchwords, {st.edge_model.shape[1]} edge topics, "
          f"{int(zero.sum())} empty topics; clusters equal the in-core "
          f"run's: {np.array_equal(st.cluster_of_doc, tr.cluster_of_doc)}")
    return st, launches, per, B


def streamed_resume_phase(corpus, shape, seed, out, tr, loader) -> dict:
    """Phase S1's second part: the finish passes, from the in-core run's
    svd and kmeans checkpoints, against the in-core run's results.
    Returns the run's launch counts."""
    from isle_tpu_torch import segsum, streaming

    st = streamed_trainer(corpus, shape, seed, os.path.join(out, "nyt_r"))
    for stage in ("svd", "kmeans", "model"):
        path = os.path.join(st.run_dir, f"ckpt_{stage}.npz")
        if os.path.exists(path):
            os.remove(path)
        if stage != "model":
            shutil.copy(os.path.join(tr.run_dir, f"ckpt_{stage}.npz"), path)
    torch.cuda.synchronize()
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    st.train(resume=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.launch_counts()
    per = stage_launches(st)
    assert set(per) == {"streamed catchwords", "streamed topic model"}, per
    check_streamed_launches(per, len(st.loader.ranges), "streamed resume")
    assert np.array_equal(st.cluster_of_doc, tr.cluster_of_doc)
    for t, (a, b) in enumerate(zip(st.catchwords, tr.catchwords)):
        assert np.array_equal(a, b), f"resumed run: catchwords of topic {t}"
    g, c = st.top_pairs, tr.top_pairs
    assert np.array_equal(g[2], c[2]), "resumed run: top-two valid flags"
    flip = np.flatnonzero((g[0] != c[0]) | (g[1] != c[1]))
    if flip.size:  # each must be a tie of the doc's two masses
        mass = streaming.streamed_doc_topic_mass(
            corpus, catchword_topics(st), shape["k"],
            loader).cpu().numpy().astype(np.float64)
        for got, ref in zip(g[:2], c[:2]):
            np.testing.assert_allclose(
                mass[flip, got[flip]], mass[flip, ref[flip]], rtol=1e-5,
                err_msg="resumed run: top-two topics differ beyond a tie")
    np.testing.assert_allclose(st.model, tr.model, rtol=1e-4, atol=1e-6)
    print(f"streamed resume from the in-core run's svd + kmeans "
          f"checkpoints: {wall:.2f} s wall; catchwords equal, top-two "
          f"topics equal but {flip.size} docs that flip on a tie, model max "
          f"abs diff {np.abs(st.model - tr.model).max():.3e}")
    return launches


def streamed_sampling_phase(corpus, shape, seed, out, tr) -> tuple:
    """Phase S1's third part: a streamed run with document sampling, and
    its selection and B against the in-core stage's with the same draws.
    Returns (launch counts, launches by stage)."""
    from isle_tpu_torch import bmatrix, streaming
    from isle_tpu_torch.rng import Draws
    from isle_tpu_torch.sparse import DocSparse

    rate, D = STREAM_SAMPLE_RATE, shape["docs"]
    st = streamed_trainer(corpus, shape, seed, os.path.join(out, "nyt_ss"),
                          sample_docs=True, sample_rate=rate)
    wall, peak, launches, per = run_streamed(st)
    loader = st.loader
    print_streamed_run(f"streamed path, sampled at rate {rate}", st, wall,
                       peak, launches)
    check_streamed_launches(per, len(loader.ranges), "streamed, sampled")
    assert "streamed doc sampling" in per
    sums = st.model.sum(axis=0, dtype=np.float64)
    zero = ~st.model.any(axis=0)
    assert np.all(zero | (np.abs(sums - 1.0) <= 1e-5)), sums
    assert np.isfinite(st.model).all() and np.isfinite(st.edge_model).all()
    ours, ref = run_dir_arrays(st, "svd"), run_dir_arrays(tr, "svd")
    assert np.array_equal(ours["zetas"], ref["zetas"]), "sampled run: zetas"
    cols = ours["original_cols"]

    # the in-core stage on the whole corpus with the same uniforms
    A = DocSparse.from_corpus(corpus, "cuda")
    z = torch.from_numpy(ref["zetas"]).cuda()
    u = Draws(seed).doc_sample_uniforms(D)
    IB, in_cols = bmatrix.threshold_and_copy(A, z, sample_rate=rate,
                                             uniforms=u)
    w_in = bmatrix.doc_weights(A, torch.floor(A.d_val + 0.5) >= z[A.d_word],
                               z)
    del A
    w_st = streaming.streamed_doc_weights(corpus, z, loader)
    assert torch.allclose(w_st, w_in, rtol=1e-5, atol=0), "doc weights"
    flips = np.setxor1d(cols, in_cols)
    if flips.size:  # only docs whose dice tie the pivot within rounding
        dice = bmatrix.doc_dice(w_in, u)
        pivot = torch.sort(dice, descending=True).values[
            min(int(rate * D), D - 1)]
        gap = (dice[torch.from_numpy(flips).long().cuda()] - pivot).abs()
        assert bool((gap <= 2e-7).all()), \
            f"sampled run: {flips.size} docs differ beyond a tie at the pivot"
    else:
        sel = torch.zeros(D, dtype=torch.bool, device="cuda")
        sel[torch.from_numpy(cols).long().cuda()] = True
        B, b_cols = streaming.streamed_build_b(corpus, z, sel, loader)
        assert np.array_equal(b_cols, in_cols)
        assert_same_b(B, IB)
    print(f"streamed sampling checks: zetas equal the in-core run's; "
          f"{len(cols)} of {D} docs kept; doc weights max rel diff to the "
          f"in-core stage's "
          f"{float(((w_st - w_in).abs() / w_in.clamp(min=1e-30)).max()):.2e}"
          f"; docs that flip on a tie at the pivot: {flips.size}"
          + ("" if flips.size else "; B equals the in-core stage's")
          + f"; {sum(len(c) for c in st.catchwords)} catchwords, "
          f"{st.edge_model.shape[1]} edge topics")
    return launches, per


def middle_chunk(tr, corpus, loader) -> SimpleNamespace:
    """The loader's middle chunk as the streamed stages hand it to the
    kernels, from run `tr`'s ζ, catchwords and clusters: the doc-ordered
    chunk (w, v, d, docs [lo, hi)), its word-sorted streams for the
    histogram (hs, hr) and the model accumulation (ms, md on local doc
    ids, mv; table: the chunk's rows of the contribution weights), the
    two carries as they stand before it (hist, model), and the slice
    length of the word-keyed sums."""
    from isle_tpu_torch import segsum, streaming, thresholds, topic_model

    hp, k = tr.config.hyper, tr.config.num_topics
    V, D = corpus.vocab_size, corpus.num_docs
    F = thresholds.freq_bound(corpus.avg_doc_sz)
    dev = loader.device
    mid = len(loader.ranges) // 2
    cwt = catchword_topics(tr, dev)
    cluster = torch.from_numpy(tr.cluster_of_doc).to(dev)
    zetas = torch.from_numpy(run_dir_arrays(tr, "svd")["zetas"]).to(dev)
    mass = streaming.streamed_doc_topic_mass(corpus, cwt, k, loader)
    thr = topic_model.model_thresholds(
        mass, topic_model.has_catchwords(cwt, k),
        hp.model_rank_threshold(D, k))
    Wc = topic_model._contribution_weights(mass, thr, cluster)
    del mass
    hist = torch.zeros((V + 1, F + 1), dtype=torch.int32, device=dev)
    model = torch.zeros((V + 1, k), dtype=torch.float32, device=dev)
    for i, (lo, hi, w, v, d) in enumerate(loader.chunks()):
        if i == mid:
            w, v, d = w.clone(), v.clone(), d.clone()
            break
        ws, rs = streaming._sort_by_word(w, thresholds.hist_cols(v, F))
        hist = segsum.segsum_onehot(ws, rs, None, V, F + 1, init=hist)
        ws, ds, vs = streaming._sort_by_word(w, d - lo, v)
        model = segsum.segsum_gather_rows(ws, ds, vs, Wc[lo:hi], V,
                                          init=model)
    assert bool(hist.any()) and bool(model.any())
    hs, hr = streaming._sort_by_word(w, thresholds.hist_cols(v, F))
    ms, md, mv = streaming._sort_by_word(w, d - lo, v)
    for name, stream in (("hist", hs), ("model", ms), ("docs", d)):
        assert bool(torch.all(stream[1:] >= stream[:-1])), f"{name} unsorted"
    return SimpleNamespace(
        index=mid, lo=lo, hi=hi, w=w, v=v, d=d, F=F, k=k, V=V, cwt=cwt,
        zetas=zetas, hist=hist, model=model, hs=hs, hr=hr, ms=ms, md=md,
        mv=mv, table=Wc[lo:hi],
        word_slice=streaming.word_slice_len(w.numel(), V, tr.gpu.seg_chunk))


def streamed_uses(st, corpus, launched: dict) -> dict:
    """Phase S2: both kernels' streamed uses on a middle chunk. `launched`:
    the launches of each use as read from S1's runs."""
    from isle_tpu_torch import streaming, thresholds

    loader = st.loader
    c = middle_chunk(st, corpus, loader)
    w, v, F, k, V = c.w, c.v, c.F, c.k, c.V
    n, rows = w.numel(), c.hi - c.lo
    sort_ms = {
        "sort by word, 1 payload (histogram)": time_ms(
            lambda: streaming._sort_by_word(w, thresholds.hist_cols(v, F))),
        "sort by word, 2 payloads (model)": time_ms(
            lambda: streaming._sort_by_word(w, c.d - c.lo, v)),
    }
    local = c.d - c.lo
    z = c.zetas[w]
    wcol = torch.where(torch.floor(v + 0.5) >= z, 0, -1).to(torch.int32)
    mass_init = torch.rand((rows + 1, k), device=loader.device)
    uses = {
        ONEHOT: [
            onehot_use("streamed zeta histogram, chunk with init", c.hs, c.hr,
                       None, V, F + 1, launched["histogram"], init=c.hist,
                       chunk=c.word_slice),
            onehot_use("streamed doc-topic mass, chunk's local docs", local,
                       c.cwt[w], v, rows, k, launched["mass"]),
            # no streamed stage passes the mass an init: checked, not driven
            onehot_use("streamed doc-topic mass, local docs with init",
                       local, c.cwt[w], v, rows, k, 0, init=mass_init),
            onehot_use("streamed sampling weights, chunk's local docs",
                       local, wcol, z, rows, 1, launched["weights"]),
        ],
        GATHER: [
            gather_use("streamed model accumulation, chunk with init", c.ms,
                       c.md, c.mv, c.table, V, launched["model"],
                       init=c.model, chunk=c.word_slice),
        ],
    }
    print(f"streamed uses on chunk {c.index} of {len(loader.ranges)} (docs "
          f"[{c.lo}, {c.hi}), {n} entries; the word-keyed sums in slices of "
          f"{c.word_slice} entries, streaming.word_slice_len): "
          + "; ".join(f"{label} {ms_:.3f} ms"
                      for label, ms_ in sort_ms.items()))
    print_uses(uses, "streamed paths")
    return uses


def lanczos_phase(B, tr, seed: int, chunk: int) -> tuple:
    """Phase S3 at the NYTimes shape: linalg.lanczos on B B^T, all k
    eigenvalues with the trainer's tolerance and cap on restarts, against
    the main path's block_ks eigenvalues. Returns (the width-1 uses, the
    launch counts of the solve)."""
    from isle_tpu_torch import linalg, segsum, sparse
    from isle_tpu_torch.rng import Draws

    hp = tr.config.hyper
    V, nev = B.vocab, tr.config.num_topics
    torch.cuda.synchronize()
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    res = linalg.lanczos(lambda X: sparse.gram_x(B, X, chunk), V, nev,
                         Draws(seed), B.device, tol=hp.block_ks_tolerance,
                         max_restarts=hp.block_ks_max_iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.launch_counts()
    assert launches[GATHER] == 2 * res.op_calls, launches
    assert res.nconv == nev, \
        f"lanczos converged {res.nconv}/{nev} in {res.restarts} restarts"
    ref = np.asarray(tr.evalues)
    np.testing.assert_allclose(res.evals, ref, rtol=1e-3)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((V, 1), generator=g).to(B.device)
    y = sparse.bt_x(B, x, chunk)
    uses = [
        gather_use("Lanczos B^T x, width 1", B.d_doc, B.d_word, B.d_val, x,
                   B.num_docs, res.op_calls),
        gather_use("Lanczos B y, width 1", B.w_word, B.w_doc, B.w_val, y,
                   V, res.op_calls),
    ]
    print(f"lanczos at the NYTimes shape: {nev} eigenvalues in {wall:.2f} s "
          f"wall, {res.restarts} restarts, {res.op_calls} operator calls "
          f"({launches[GATHER]} width-1 launches), max rel "
          f"diff to block_ks {np.abs(res.evals / ref - 1).max():.2e}")
    print_uses({GATHER: uses}, "Lanczos solve")
    return uses, launches


def reports_phase(gpu, cpu) -> None:
    """Phase S4: the spectrum of A, the catchword-free model and edge
    topics v1 of the small corpus, card against CPU (the same top-two
    pairs go to both v1 constructions)."""
    from isle_tpu_torch.topic_model import construct_edge_topics_v1

    out = {}
    for name, tr in (("cuda", gpu), ("cpu", cpu)):
        tr.compute_input_svd()
        tr.output_avg_topic_coherence()
        spectrum = np.loadtxt(os.path.join(tr.run_dir,
                                           "A_squared_spectrum.txt"))
        m_hat = np.loadtxt(os.path.join(tr.run_dir, "M_hat_avg"), ndmin=2)
        edge, sel = construct_edge_topics_v1(
            tr._device_A(), *cpu.top_pairs, None, TINY["k"], TINY["edges"],
            min_docs=cpu.config.hyper.edge_topic_min_docs)
        assert tr._device_A().device.type == name
        out[name] = (spectrum, m_hat, edge, sel)
    g, c = out["cuda"], out["cpu"]
    np.testing.assert_allclose(g[0], c[0], rtol=1e-4)
    np.testing.assert_allclose(g[1], c[1], atol=1e-5)
    np.testing.assert_allclose(g[2], c[2], atol=1e-5)
    assert np.array_equal(g[3], c[3]) and len(g[3]) > 0
    print(f"tiny reports: card == CPU (A_squared_spectrum max rel diff "
          f"{np.abs(g[0] / c[0] - 1).max():.2e}, M_hat_avg max abs diff "
          f"{np.abs(g[1] - c[1]).max():.2e}, edge topics v1: "
          f"{len(g[3])} pairs equal, max abs diff "
          f"{np.abs(g[2] - c[2]).max():.2e})")


INFER_SLICE_DOCS = 20_000
# the sharded trainer's stage labels beside the in-core stage each stands for
SHARDED_STAGES = {
    "upload A to device (sharded)": "upload A to device",
    "computing thresholds": "computing thresholds",
    "creating thresholded and scaled matrix (sharded)":
        "creating thresholded and scaled matrix",
    "eigen solve (B B^T, sharded)": "eigen solve (B B^T)",
    "project docs": "project docs",
    "k-means seeds initialization": "k-means seeds initialization",
    "converging Lloyds k-means on B_k": "converging Lloyds k-means on B_k",
    "k-means on B (sharded)": "k-means on B",
    "collecting word freqs in clusters (sharded)":
        "collecting word freqs in clusters",
    "finding catchwords for clusters": "finding catchwords for clusters",
    "constructing topic vectors (sharded)": "constructing topic vectors",
}


@contextlib.contextmanager
def no_library_spmm():
    """torch's sparse product and sparse constructors raise inside: a run
    that passes took every product through the port's kernels."""
    def refuse(*a, **kw):
        raise AssertionError("the port called a torch.sparse routine")

    names = ("mm", "addmm", "sum")
    saved = {n: getattr(torch.sparse, n) for n in names}
    ctors = {n: getattr(torch, n) for n in
             ("sparse_coo_tensor", "sparse_csr_tensor")}
    for n in names:
        setattr(torch.sparse, n, refuse)
    for n in ctors:
        setattr(torch, n, refuse)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.sparse, n, fn)
        for n, fn in ctors.items():
            setattr(torch, n, fn)


def one_rank_mesh(out: str):
    """A sharding.Mesh of this process alone: over a one-rank NCCL group
    (rendezvous: a file under `out`) where torch.distributed has NCCL,
    else without a group. Returns (mesh, the line that says which)."""
    import torch.distributed as dist

    from isle_tpu_torch.sharding import Mesh

    if not (dist.is_available() and dist.is_nccl_available()):
        return Mesh("cuda"), ("torch.distributed has no NCCL on this host: "
                              "the mesh has NO process group, every "
                              "collective is the identity")
    os.makedirs(out, exist_ok=True)
    rendezvous = os.path.join(out, "nccl_rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"file://{rendezvous}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=300),
        device_id=torch.device("cuda", torch.cuda.current_device()))
    mesh = Mesh.from_process_group("cuda")
    # the first collective makes NCCL's communicator: outside every timing
    mesh.all_reduce(torch.zeros(8, device="cuda"))
    torch.cuda.synchronize()
    return mesh, (f"one-rank NCCL group (world size {mesh.world}, rank "
                  f"{mesh.rank}), made and warmed in "
                  f"{time.perf_counter() - t0:.2f} s")


def sharded_phase(corpus, shape, seed, out, tr, mesh, per_incore) -> tuple:
    """Phase M1. Returns (the sharded trainer, its launch counts, its
    launches by stage)."""
    from isle_tpu_torch import segsum

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls0, sec0 = mesh.collective_calls, mesh.collective_seconds()
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    with no_library_spmm():
        sh = train(corpus, shape, seed, "cuda", os.path.join(out, "nyt_m"),
                   mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.launch_counts()
    coll_s = mesh.collective_seconds() - sec0
    per = stage_launches(sh)
    print(f"sharded path, world size {mesh.world}: train + edge topics "
          f"{wall:.2f} s wall, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, kernel "
          f"launches {launches}; {mesh.collective_calls - calls0} "
          f"collectives, {coll_s:.4f} s inside them ({coll_s / wall:.2%} of "
          f"the wall); {card_line()}")
    for label, w, _ in sh.timer.phases:
        print(f"  sharded stage {label}: {w:.3f} s")
    assert sh.mesh is mesh and sh.A is None
    ours, ref = run_dir_arrays(sh, "svd"), run_dir_arrays(tr, "svd")
    assert np.array_equal(ours["zetas"], ref["zetas"]), "sharded zetas"
    assert np.array_equal(ours["original_cols"], ref["original_cols"])
    assert np.array_equal(sh.cluster_of_doc, tr.cluster_of_doc), \
        "sharded clusters differ from the in-core run's"
    for t, (a, b) in enumerate(zip(sh.catchwords, tr.catchwords)):
        assert np.array_equal(a, b), f"sharded run: catchwords of topic {t}"
    np.testing.assert_allclose(sh.evalues, tr.evalues, rtol=1e-4)
    np.testing.assert_allclose(sh.model, tr.model, rtol=0, atol=1e-6)
    for a, b in zip(sh.top_pairs, tr.top_pairs):
        assert np.array_equal(a, b), "sharded run: top-two topics"
    assert np.array_equal(sh.edge_pairs, tr.edge_pairs)
    # stage by stage the launches of the in-core run: each rank's local
    # products are the same wrappers. The in-core B stage also logs
    # Frob(B), one more launch of the doc norms.
    for stage, counts in per.items():
        want = dict(per_incore[SHARDED_STAGES.get(stage, stage)])
        if stage.startswith("creating thresholded"):
            want[ONEHOT] -= 1
        assert counts == want, \
            f"sharded stage {stage!r} launched {counts}, in core {want}"
    assert per["eigen solve (B B^T, sharded)"][GATHER] == \
        2 * sh.op_counter.calls
    print("sharded checks: zetas, original_cols, clusters, catchwords, "
          "top-two topics and edge pairs equal the in-core run's; model max "
          f"abs diff {np.abs(sh.model - tr.model).max():.3e} (bit-equal: "
          f"{np.array_equal(sh.model, tr.model)}), eigenvalues bit-equal: "
          f"{np.array_equal(sh.evalues, tr.evalues)}; no torch.sparse call; "
          "launches by stage (segsum_onehot, segsum_gather_rows): "
          + "; ".join(f"{stage} ({c[ONEHOT]}, {c[GATHER]})"
                      for stage, c in per.items()))
    return sh, launches, per


def sharded_infer_phase(tr, entries, shape, out, mesh) -> None:
    """Phase M2: the first INFER_SLICE_DOCS docs inferred on one device
    and doc-parallel over the mesh."""
    from isle_tpu_torch import GpuConfig, InferConfig, Inferencer

    d, w, c = entries
    n = min(INFER_SLICE_DOCS, shape["docs"])
    keep = d < n
    sub = make_corpus((d[keep], w[keep], c[keep]), dict(shape, docs=n),
                      normalize_to_one=True)
    V, k = tr.model.shape
    res, walls = {}, {}
    for name, m in (("single", None), ("mesh", mesh)):
        inf = Inferencer(InferConfig(num_topics=k, vocab_size=V),
                         model=tr.model, quiet=True, mesh=m,
                         output_dir=os.path.join(out, f"infer_m_{name}"),
                         gpu=GpuConfig(device="cuda"))
        calls0 = mesh.collective_calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[name] = inf.infer_corpus(sub, top_n=5)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        if m is not None and mesh.group is not None:
            assert mesh.collective_calls > calls0, "no gather at the end"
    g, r = res["mesh"], res["single"]
    assert np.array_equal(g.converged, r.converged), \
        "doc-parallel inference: convergence flags differ"
    np.testing.assert_allclose(g.weights, r.weights, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(g.llh_per_doc, r.llh_per_doc, rtol=2e-5,
                               atol=1e-5)
    print(f"doc-parallel inference, world size {mesh.world}, {n} docs: "
          f"{walls['mesh']:.3f} s wall (single device {walls['single']:.3f} "
          f"s), {g.num_converged} converged, weights bit-equal to the "
          f"single-device run: {np.array_equal(g.weights, r.weights)}")


def capi_phase(out: str) -> None:
    """Phase M3: the C shim built from the checkout and the plain-C smoke
    host of native/ run against it on the card."""
    from isle_tpu_torch import _build_capi

    t0 = time.perf_counter()
    lib = _build_capi.build_shim()
    smoke = os.path.join(out, "capi_smoke")
    os.makedirs(out, exist_ok=True)
    subprocess.run(
        [shutil.which("cc") or "gcc", "-O2", "-Wall", "-o", smoke,
         os.path.join(ROOT, "native", "capi_smoke.c"), "-ldl", "-lm"],
        check=True, capture_output=True, text=True, timeout=300)
    built = time.perf_counter() - t0
    env = dict(os.environ, ISLE_CAPI_DEVICE="cuda", ISLE_CAPI_EDGE_TOPICS="6",
               PYTHONPATH=os.pathsep.join([ROOT] + [p for p in sys.path
                                                    if p]))
    t0 = time.perf_counter()
    run = subprocess.run([smoke, lib], env=env, capture_output=True,
                         text=True, timeout=600, cwd=out)
    assert run.returncode == 0 and "CAPI SMOKE OK" in run.stdout, \
        f"capi_smoke failed ({run.returncode}):\n{run.stdout}{run.stderr}"
    print(f"C shim: {os.path.relpath(lib)} built with g++ and the smoke "
          f"host with cc in {built:.2f} s; native/capi_smoke.c on cuda in "
          f"{time.perf_counter() - t0:.2f} s: {run.stdout.strip()}")


def _union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, -1.0
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def eigensolve_split(events: list) -> dict:
    """Where the eigensolve's time went, from the events of a
    GpuConfig.profile_dir trace: the stage's window is cut by the
    trainer's stage markers; a kernel belongs to the operator whose
    CPU-side call launched it (by the trace's correlation ids).
    Milliseconds."""
    from isle_tpu_torch.obs import STAGE_MARK

    events = [e for e in events if e.get("ph") == "X"]
    marks = sorted((e["ts"], e["name"][len(STAGE_MARK):]) for e in events
                   if e.get("name", "").startswith(STAGE_MARK))
    labels = [name for _, name in marks]
    assert "eigen solve (B B^T)" in labels, labels
    i = labels.index("eigen solve (B B^T)")
    lo, hi = marks[i - 1][0], marks[i][0]

    def inside(e):
        return lo <= e["ts"] < hi

    def spans(name):
        ops = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "cpu_op" and e["name"] == name
                     and inside(e))
        return ops, [a for a, _ in ops]

    qr_ops, qr_starts = spans("aten::linalg_qr")
    mm_ops, mm_starts = spans("aten::mm")

    def within(ops, starts, ts):
        j = bisect.bisect_right(starts, ts) - 1
        return j >= 0 and ts < ops[j][1]

    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    device = {"SpMM kernels (segsum_gather_rows)": 0.0,
              "QR (kernels launched by aten::linalg_qr)": 0.0,
              "matmuls (kernels launched by aten::mm)": 0.0,
              "other kernels": 0.0, "copies": 0.0}
    busy = []
    n_kernels = 0
    for e in events:
        cat = e.get("cat")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset") or not inside(e):
            continue
        busy.append((e["ts"], e["ts"] + e["dur"]))
        ts = launch_ts.get(e.get("args", {}).get("correlation"), e["ts"])
        if cat != "kernel":
            key = "copies"
        elif "segsum" in e["name"]:
            key = "SpMM kernels (segsum_gather_rows)"
        elif within(qr_ops, qr_starts, ts):
            key = "QR (kernels launched by aten::linalg_qr)"
        elif within(mm_ops, mm_starts, ts):
            key = "matmuls (kernels launched by aten::mm)"
        else:
            key = "other kernels"
        n_kernels += cat == "kernel"
        device[key] += e["dur"] / 1e3
    window = (hi - lo) / 1e3
    host = {}
    for name in ("aten::linalg_eigh", "aten::linalg_qr", "aten::mm"):
        host[name] = sum(e["dur"] for e in events if e.get("cat") == "cpu_op"
                         and e["name"] == name and inside(e)) / 1e3
    host["synchronizes and blocking copies (cuda runtime)"] = sum(
        e["dur"] for e in events if e.get("cat") == "cuda_runtime"
        and inside(e) and ("Synchronize" in e["name"]
                           or e["name"].startswith("cudaMemcpy"))) / 1e3
    return dict(window_ms=window, device_ms=device,
                device_idle_ms=window - _union_seconds(busy) / 1e3,
                host_ms=host, kernels=n_kernels,
                qr_calls=len(qr_ops), mm_calls=len(mm_ops))


def traced_phase(corpus, shape, seed, out, tr) -> tuple:
    """Phase M4. Returns (launch counts, launches by stage) of the traced
    run."""
    from isle_tpu_torch import segsum
    from isle_tpu_torch.obs import STAGE_MARK

    profile_dir = os.path.join(out, "profile")
    shutil.rmtree(profile_dir, ignore_errors=True)
    torch.cuda.synchronize()
    segsum.reset_launch_counts()
    t0 = time.perf_counter()
    traced = train(corpus, shape, seed, "cuda", os.path.join(out, "nyt_p"),
                   profile_dir=profile_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = segsum.launch_counts()
    traced.A = None
    assert np.array_equal(traced.cluster_of_doc, tr.cluster_of_doc) and \
        np.array_equal(traced.model, tr.model), \
        "the traced run differs from the untraced one"
    files = os.listdir(profile_dir)
    assert len(files) == 1 and files[0].endswith(".json"), files
    path = os.path.join(profile_dir, files[0])
    t0 = time.perf_counter()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels, "the trace holds no CUDA kernel event"
    assert any("segsum" in e["name"] for e in kernels), \
        "the trace holds none of the port's kernels"
    marks = [e["name"][len(STAGE_MARK):] for e in events
             if e.get("name", "").startswith(STAGE_MARK)]
    assert marks == [label for label, _ in traced.stage_launches], marks
    n_events = len(events)
    del kernels
    split = eigensolve_split(events)
    del events
    stage = dict((label, w) for label, w, _ in traced.timer.phases)[
        "eigen solve (B B^T)"]
    print(f"traced run (GpuConfig.profile_dir): train + edge topics "
          f"{wall:.2f} s wall with the profiler on (trace export "
          f"included), trace {os.path.getsize(path) / 2**20:.1f} MiB, "
          f"{n_events} events, read in {time.perf_counter() - t0:.1f} s; "
          f"results equal the untraced run's; {card_line()}")
    print(f"  eigensolve under the profiler: stage {stage:.3f} s, window "
          f"between its markers {split['window_ms']:.1f} ms, "
          f"{split['kernels']} kernels, {split['qr_calls']} QR calls, "
          f"{split['mm_calls']} mm calls; device: "
          + "; ".join(f"{name} {ms:.1f} ms"
                      for name, ms in split["device_ms"].items())
          + f"; device idle {split['device_idle_ms']:.1f} ms; host: "
          + "; ".join(f"{name} {ms:.1f} ms"
                      for name, ms in split["host_ms"].items()))
    return launches, stage_launches(traced)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=NYT["docs"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    T0 = time.perf_counter()
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
    spills = 0
    for line in lib.ptxas_log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            print(f"  ptxas: {line.strip()}")
        if "spill stores" in line:
            spills += int(line.split("bytes spill stores")[0].split(",")[-1])
    assert spills == 0, f"ptxas spilled {spills} bytes"

    out = os.path.join(ROOT, "build", "chip_smoke")
    tiny_entries = synth_entries(TINY, args.seed)
    tiny = make_corpus(tiny_entries, TINY)
    tiny_tr, tiny_cpu = check_tiny(tiny, args.seed, out)

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
    per_incore = stage_launches(tr)
    print(f"main path: train + edge topics {wall:.2f} s wall, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"kernel launches {launches}")
    for label, w, _ in tr.timer.phases:
        print(f"  stage {label}: {w:.3f} s")

    for again in ("nyt2", "nyt3", "nyt4"):
        train_again(corpus, shape, args.seed, os.path.join(out, again), tr)
    cumsum_probe(shape["docs"])

    uses = compare_kernels(tr, launches, args.seed)
    print_uses(uses, "main path")

    need = sum(u["launches"] for u in uses["segsum_onehot"])
    assert launches["segsum_onehot"] >= need, \
        f"segsum_onehot launched {launches['segsum_onehot']} times on the " \
        f"main path, fewer than its {need} uses"
    # every eigensolver operator call (bt_x + b_y), every full-space
    # Lloyd's iteration (bt_x + b_y), the projection and the model SpMM
    need = sum(u["launches"] for u in uses["segsum_gather_rows"])
    assert launches["segsum_gather_rows"] >= need, \
        f"segsum_gather_rows launched {launches['segsum_gather_rows']} " \
        f"times on the main path, fewer than its {need} SpMM calls"
    print(f"segsum_gather_rows on the main path: "
          f"{launches['segsum_gather_rows']} launches for {need} SpMM calls "
          f"({tr.op_counter.calls} eigensolver operator calls, "
          f"{lloyds_reps(tr)} full-space Lloyd's iterations)")
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
    # algorithms (index_add_ without atomics in the projected Lloyd's).
    # Phase 3 runs the default path as it is.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label, opts in OPTIONS.items():
            hyper = dict(opts.get("hyper", {}), eigensolver="dense")
            check_tiny(tiny, args.seed, out, label,
                       **{**opts, "hyper": hyper})
        # S3 on the small corpus: Lanczos, card against CPU
        check_tiny(tiny, args.seed, out, "lanczos",
                   hyper=dict(eigensolver="lanczos"))
    finally:
        torch.use_deterministic_algorithms(False)
    check_tiny_infer(tiny_tr, make_corpus(tiny_entries, TINY,
                                          normalize_to_one=True), out)

    reports_phase(tiny_tr, tiny_cpu)

    # M1-M4: the sharded trainer and doc-parallel inference at world size
    # 1, the C shim, the traced run. The in-core corpus leaves the card
    # first.
    tr.A = None
    torch.cuda.empty_cache()
    import torch.distributed as dist

    mesh, mesh_line = one_rank_mesh(out)
    print(f"sharded phases: {mesh_line}")
    try:
        sh, m_launches, m_per = sharded_phase(corpus, shape, args.seed, out,
                                              tr, mesh, per_incore)
        sharded_calls, sharded_reps = sh.op_counter.calls, lloyds_reps(sh)
        del sh
        torch.cuda.empty_cache()
        sharded_infer_phase(tr, entries, shape, out, mesh)
    finally:
        if mesh.group is not None:
            dist.destroy_process_group()
    capi_phase(os.path.join(out, "capi"))
    p_launches, _ = traced_phase(corpus, shape, args.seed, out, tr)
    torch.cuda.empty_cache()
    # each use's launches on the sharded run, beside the main path's
    sharded_use_launches = {
        "zeta histogram": 1, "r-th group counts": 1, "doc-topic mass": 1,
        "doc norms of B": 1, "model SpMM B W": 1,
        "eigensolver B^T X": sharded_calls, "eigensolver B Y": sharded_calls,
        "Lloyd's B^T C (+ projection)": sharded_reps + 1,
        "Lloyd's B onehot": sharded_reps,
    }
    for rows in uses.values():
        for u in rows:
            u["launches_sharded"] = sharded_use_launches[u["use"]]
    assert m_launches[ONEHOT] == sum(
        u["launches_sharded"] for u in uses[ONEHOT])
    assert m_launches[GATHER] == sum(
        u["launches_sharded"] for u in uses[GATHER])
    print("launches on the sharded run by use: " + "; ".join(
        f"{u['use']} {u['launches_sharded']}"
        for rows in uses.values() for u in rows))

    # S1-S3: out of core.
    st, s_launches, s_per, B = streamed_phase(corpus, shape, args.seed, out,
                                              tr)
    r_launches = streamed_resume_phase(corpus, shape, args.seed, out, tr,
                                       st.loader)
    ss_launches, ss_per = streamed_sampling_phase(corpus, shape, args.seed,
                                                  out, tr)
    s_uses = streamed_uses(st, corpus, {
        "histogram": s_per["streamed thresholds"][ONEHOT],
        "mass": s_per["streamed topic model"][ONEHOT],
        "model": s_per["streamed topic model"][GATHER],
        "weights": ss_per["streamed doc sampling"][ONEHOT],
    })
    l_uses, l_launches = lanczos_phase(B, tr, args.seed, tr.gpu.seg_chunk)
    for name in (ONEHOT, GATHER):
        uses[name] += s_uses[name]
    uses[GATHER] += l_uses
    by_path = {name: {"in-core": launches[name],
                      "sharded, world size 1": m_launches[name],
                      "in-core, traced": p_launches[name],
                      "streamed": s_launches[name],
                      "streamed, resumed": r_launches[name],
                      "streamed, sampled": ss_launches[name],
                      "lanczos": l_launches[name]} for name in uses}
    del st, B

    # 8. inference at full width with the main path's model
    del corpus
    torch.cuda.empty_cache()
    infer_full(tr, entries, shape, args.seed, out)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "isle_tpu", "bench")]
    assert not bad, f"the port imported {bad}"

    source = "isle_tpu_torch/csrc/segsum.cu"
    replaces = {ONEHOT: "isle_tpu/pallas_ops.py:236",
                GATHER: "isle_tpu/pallas_ops.py:203"}

    # the times are summed over the uses that a driven path launched
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=source, replaces=replaces[name],
             launches=sum(by_path[name].values()),
             launches_by_path=by_path[name],
             max_abs_err=max(u["max_abs_err"] for u in rows),
             **{key: sum(u[key] for u in rows if u["launches"] > 0)
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
             bound_by="bytes" if all(u["bound_by"] == "bytes" for u in rows)
             else "operations", uses=rows)
        for name, rows in uses.items()
    ]}))
    print(f"chip_smoke: {time.perf_counter() - T0:.1f} s in all")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
