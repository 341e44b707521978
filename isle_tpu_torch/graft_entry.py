"""The entry points of __graft_entry__.py for the port: one
step of the flagship pipeline on a toy problem (entry) and the whole
pipeline over the ranks of a torch.distributed group (dryrun_multichip).

    python -m isle_tpu_torch.graft_entry [--device cpu|cuda] [--dryrun N]

runs entry() on the device (the card by default) and prints its outputs'
shapes, then the dry run over N ranks (default: every card, or one rank
on the CPU), one process a rank: NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import multiprocessing
import os
import sys
import tempfile
import time

import numpy as np
import torch

# The dry run's whole limit: ranks still running after it are killed.
DRYRUN_LIMIT_S = 900.0


def _require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); pass "
            "device='cpu' to run on the host")
    return device


def _toy_sparse(device, V=512, D=1024, nnz_per_doc=12, seed=0):
    """The toy matrix of __graft_entry__._toy_sparse from the same seed,
    a DocSparse on `device`."""
    from .sparse import DocSparse

    rng = np.random.default_rng(seed)
    docs = np.repeat(np.arange(D, dtype=np.int64), nnz_per_doc)
    words = rng.integers(0, V, D * nnz_per_doc)
    order = np.lexsort((words, docs))
    words, docs = words[order], docs[order]
    # drop duplicate (doc, word) pairs
    keep = np.ones(len(words), bool)
    keep[1:] = (docs[1:] != docs[:-1]) | (words[1:] != words[:-1])
    words, docs = words[keep], docs[keep]
    vals = rng.integers(1, 5, len(words)).astype(np.float32)
    return DocSparse.from_doc_sorted(words, docs, vals, V, D, device)


def entry(device="cuda"):
    """One step of the flagship pipeline: the eigensolver's Gram operator,
    one full-space Lloyd's iteration and one batched MWU step, on the toy
    problem of __graft_entry__.entry() (the same seeds). It runs eagerly.
    Returns (fn, example_args); fn(*args) -> (Y (V, 128), assign (D,),
    new_centers (k, V), w (64, k))."""
    from .kmeans import lloyds_iter_full
    from .sparse import doc_l2sq, gram_x

    device = _require_device(device)
    sp = _toy_sparse(device)
    V, k = sp.vocab, 16
    rng = np.random.default_rng(1)

    def put(a):
        return torch.from_numpy(a).to(device)

    X = put(rng.standard_normal((V, 128)).astype(np.float32))
    centers = put(rng.standard_normal((k, V)).astype(np.float32))
    Mw = put(np.abs(rng.standard_normal((V + 1, k))).astype(np.float32))
    word_idx = put(rng.integers(0, V, (64, 32)).astype(np.int32))
    a = put(np.abs(rng.standard_normal((64, 32))).astype(np.float32))

    def fn(sp, X, centers, Mw, word_idx, a):
        Y = gram_x(sp, X)
        new_centers, assign = lloyds_iter_full(sp, centers, doc_l2sq(sp),
                                               centers.shape[0])
        # one MWU gradient step, batched
        Mb = Mw[word_idx.long()]
        w = torch.full((a.shape[0], Mw.shape[1]), 1.0 / Mw.shape[1],
                       dtype=torch.float32, device=a.device)
        z = torch.einsum("blk,bk->bl", Mb, w)
        g = torch.einsum("blk,bl->bk", Mb,
                         torch.where(a > 0, a / z, torch.zeros_like(a)))
        w = w * torch.exp(0.1 * g)
        w = w / torch.sum(w, dim=1, keepdim=True)
        return Y, assign, new_centers, w

    return fn, (sp, X, centers, Mw, word_idx, a)


def _legs(n: int, device: str, mesh) -> None:
    """The three legs of __graft_entry__.dryrun_multichip on this rank:
    the same corpora, seeds, configurations and checks. Rank 0 prints."""
    from .config import GpuConfig, HyperParams, TrainConfig
    from .corpus import Corpus
    from .mwu import build_infer_batch, infer_all
    from .streaming import StreamedTrainer
    from .trainer import Trainer

    def say(line: str) -> None:
        if mesh is None or mesh.rank == 0:
            print(line, flush=True)

    rng = np.random.default_rng(0)
    V, D, k = 96, 50 * n, 4
    block = V // k
    docs, words, counts = [], [], []
    for d in range(D):
        t = rng.integers(0, k)
        ws = np.concatenate(
            [rng.integers(t * block, (t + 1) * block, 18),
             rng.integers(0, V, 4)]
        )
        ws, cs = np.unique(ws, return_counts=True)
        docs.append(np.full(len(ws), d))
        words.append(ws)
        counts.append(cs)
    corpus = Corpus.from_entries(
        np.concatenate(docs), np.concatenate(words), np.concatenate(counts),
        vocab_size=V, num_docs=D, sort_dedup=True,
    )
    cfg = TrainConfig(
        num_topics=k,
        seed=0,
        compute_edge_topics=True,
        max_edge_topics=6,
        hyper=HyperParams(block_ks_block_size=8),
    )
    gpu = GpuConfig(device=device, mesh_shape=(n,))
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, output_dir=tmp, quiet=True, gpu=gpu, mesh=mesh)
        tr.load_corpus(corpus)
        tr.train()
        tr.train_edge_topics()
        assert tr.model.shape == (V, k)
        assert np.allclose(tr.model.sum(axis=0), 1.0, rtol=1e-4)
        ncw = sum(len(c) for c in tr.catchwords)

        infer_corpus = dataclasses.replace(
            corpus,
            vals=(corpus.vals / np.float32(corpus.avg_doc_sz)).astype(
                np.float32
            ),
        )
        batch = build_infer_batch(infer_corpus, tr.model.sum(axis=1))
        w, conv, llh, _ = infer_all(tr.model, batch, iters=15, Lf=10.0,
                                    device=device, mesh=mesh)
    say(
        f"dryrun_multichip OK: {n} devices, full sharded train() "
        f"(model {tr.model.shape}, {ncw} catchwords, "
        f"{tr.edge_model.shape[1]} edge topics) + sharded MWU "
        f"({int(conv.sum())}/{D} converged)"
    )

    # the same corpus out of core on the same mesh
    # (streaming_sharded.py), model against leg 1's
    with tempfile.TemporaryDirectory() as tmp:
        ts = StreamedTrainer(cfg, output_dir=tmp, quiet=True,
                             chunk_entries=256, gpu=gpu, mesh=mesh)
        ts.load_corpus(corpus)
        ts.train()
        assert ts.model.shape == (V, k)
        assert np.allclose(ts.model.sum(axis=0), 1.0, rtol=1e-4)
        assert np.allclose(ts.model, tr.model, atol=2e-3), (
            "streamed-mesh model diverged from sharded in-core model"
        )
        chunks = len(ts.loader.ranges)
        if mesh is not None:
            chunks = max(mesh.row_counts(chunks))
    say(
        f"dryrun_multichip OK: streamed x mesh leg "
        f"({chunks} chunks/shard, model agrees with the "
        f"in-core sharded run)"
    )

    # mid-size: uneven shards and thousands of docs (ragged shards, the
    # all-reduces' order of summing beyond the toy shape)
    V2, D2, k2 = 2048, 3000 * n + 37, 20
    block2 = V2 // k2
    d2 = np.repeat(np.arange(D2, dtype=np.int64), 14)
    t2 = (d2 % k2).astype(np.int64)
    rng2 = np.random.default_rng(1)
    w2 = np.where(
        rng2.random(len(d2)) < 0.8,
        t2 * block2 + rng2.integers(0, block2, len(d2)),
        rng2.integers(0, V2, len(d2)),
    )
    key2 = np.unique(d2 * V2 + w2)
    corpus2 = Corpus.from_entries(
        (key2 // V2), (key2 % V2),
        rng2.integers(1, 6, len(key2)).astype(np.int64),
        vocab_size=V2, num_docs=D2, sort_dedup=True,
    )
    cfg2 = dataclasses.replace(cfg, num_topics=k2, compute_edge_topics=False)
    with tempfile.TemporaryDirectory() as tmp:
        tm = Trainer(cfg2, output_dir=tmp, quiet=True, gpu=gpu, mesh=mesh)
        tm.load_corpus(corpus2)
        tm.train()
        assert tm.model.shape == (V2, k2)
        assert np.allclose(tm.model.sum(axis=0), 1.0, rtol=1e-4)
        assigned = (tm.cluster_of_doc >= 0).mean()
    say(
        f"dryrun_multichip OK: mid-size leg (V={V2}, D={D2}, k={k2}, "
        f"nnz={corpus2.nnz}, uneven shards, {assigned:.0%} docs assigned)"
    )


def _dryrun_rank(rank: int, n: int, device: str, rendezvous: str) -> None:
    """One rank of the dry run, in a process of its own: join the group
    through `rendezvous` (a file) as torchrun's ranks would, run the
    legs, leave the group."""
    import torch.distributed as dist

    from .sharding import mesh_from_env

    os.environ.update(WORLD_SIZE=str(n), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # n ranks share the host's cores
    device, mesh = mesh_from_env(device, init_method=f"file://{rendezvous}")
    try:
        _legs(n, device, mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dryrun_multichip(n: int, device="cuda") -> None:
    """The whole pipeline over n ranks of a torch.distributed group that
    this call starts, one process a rank (NCCL on the card, one card a
    rank; gloo on the CPU), in the three legs of
    __graft_entry__.dryrun_multichip: (1) Trainer over the mesh with edge
    topics, then doc-parallel MWU inference of the same docs; (2) the
    out-of-core StreamedTrainer on the same mesh, its model within 2e-3
    of leg 1's; (3) a mid-size run (V=2048, D=3000n+37, k=20) with uneven
    shards. Rank 0 prints one `dryrun_multichip OK: ...` line a leg.
    Raises if the card has fewer than n devices, if a rank fails (the
    others are killed then) or if the ranks outlast DRYRUN_LIMIT_S."""
    on_card = _require_device(device).type == "cuda"
    if on_card:
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(
                f"dryrun_multichip({n}) needs {n} CUDA devices, this host "
                f"has {have}")
        from ._build import kernels

        kernels()  # one build for every rank
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_dryrun_rank,
                             args=(r, n, str(device), rendezvous))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DRYRUN_LIMIT_S
        try:
            # until every rank is done, one has failed, or the limit
            while (any(p.exitcode is None for p in procs)
                   and not any(p.exitcode for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join(timeout=30)
    codes = [p.exitcode for p in procs]
    if codes != [0] * n:
        raise RuntimeError(
            f"dryrun_multichip({n}, {device!r}): the ranks exited with codes "
            f"{codes} (a negative code: killed after another rank failed or "
            f"after {DRYRUN_LIMIT_S:.0f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dryrun", type=int, default=None, metavar="N",
                    help="ranks of the dry run (default: every card, or "
                         "one rank on the CPU)")
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    if args.device == "cuda":
        torch.cuda.synchronize()
    print("entry() run OK:", [tuple(o.shape) for o in out], flush=True)
    n = args.dryrun or (torch.cuda.device_count() if args.device == "cuda"
                        else 1)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
