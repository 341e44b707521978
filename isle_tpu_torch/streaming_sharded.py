"""Out-of-core training over several GPUs: the port of
isle_tpu/streaming_sharded.py to torch.distributed, one process a card.

Every rank streams only its own contiguous doc range [r*dps, (r+1)*dps),
dps = ceil(D / S) (the split of sharding.shard_doc_sparse), through a
ChunkLoader of its own, and runs the single-device streamed stages of
streaming.py on it:

  1. ζ: the running (V+1, F+1) int32 histogram of the rank's chunks, one
     all-reduce, then zeta_from_hist on every rank (integers: the same
     bits everywhere);
  2. sampling: the rank's doc weights, gathered; the dice and the pivot
     over all docs from the same uniforms, and rank 0's selection;
  3. B: streamed_build_b on the rank's chunks, its kept docs renumbered
     locally, as the rank's part of a ShardedDocSparse (the in-core
     sharded B of sharding.sharded_threshold_and_copy, exactly);
  4-9. the sharded middle of the in-core trainer (Trainer._sharded_middle)
     on that B, unchanged;
  10. the r-th highest statistic: each rank keeps its chunks' entries of
     clustered docs, the (V,) counts per word are all-reduced so that
     every rank cuts the same word ranges, and one all-to-all sends each
     entry to the rank that owns its word: a rank receives only its own
     word range (isle_tpu pulls every shard's entries to one host);
  12. the topic model: the (D_r, k) catchword mass stays on its rank. The
     per-topic model threshold, the rank_threshold-th largest mass, comes
     from a bitwise binary search over the non-negative float32 bit
     patterns with an all-reduced count a step (sharded_model_thresholds);
     the top-two topics are gathered; each rank accumulates A W over its
     chunks and one all-reduce sums the (V, k) model.

Every branch that guards a collective reads a value that is the same on
every rank (the configuration, the broadcast checkpoints, all-reduced
counts), and a rank that holds no doc of A or of B still joins every
collective. Integer results equal the single-device streamed path's;
float sums that pass an all-reduce agree to rounding.

A rank's loader is a ResidentLoader over its own range (the counterpart
of isle_tpu's ShardedResidentLoader, its slabs filled once, in the stage
"sharded resident corpus fill") where the largest rank's slabs fit
GpuConfig.resident_corpus_bytes, and a ChunkLoader on every rank
otherwise (where isle_tpu refuses the run). The middle takes the memory
plan and the out-of-memory retry of the single-device trainer
(streaming.planned_middle) on the largest rank's slab bytes and nnz(B)
and the smallest device memory, so that every rank decides alike; the
retry assumes that every rank runs out of memory at the same step, as
isle_tpu's single program does (a rank that fails alone leaves the others
in a collective until the group's timeout).

Not ported: the flat and padded indices _put / _flat_doc_index /
_padded_row_index (the shards here are ragged).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .bmatrix import dice_select, docs_mask
from .catchwords import catchword_topic_map, find_catchwords
from .segsum import DEFAULT_CHUNK
from .sharding import Mesh, ShardedDocSparse, WordSharded, doc_range, \
    join_doc_shards, sharded_rth_highest, word_bounds_of_counts
from .streaming import Loader, ResidentLoader, _concat, \
    counts_dtype, planned_middle, streamed_build_b, \
    streamed_doc_topic_mass, streamed_doc_weights, streamed_histogram, \
    streamed_model_accumulation, zetas_of_histogram
from .topic_model import _contribution_weights, has_catchwords, \
    l1_normalize_columns, top_two_topics

# float32 +inf as int32 bits: above every finite non-negative mass
_INF_BITS = 0x7F800000


def sharded_streamed_thresholds(corpus, num_topics: int, hyper,
                                loader: Loader, mesh: Mesh,
                                seg_chunk: int = DEFAULT_CHUNK
                                ) -> Tuple[torch.Tensor, int]:
    """ζ from the rank's chunks: its running histogram, one all-reduce of
    the (V+1, F+1) int32 counts (261 MB at the NYTimes shape), and the
    selection on every rank. Returns (zetas float32 (V,), post-threshold
    nnz), equal to streaming.streamed_thresholds on the whole corpus."""
    hist = mesh.all_reduce(streamed_histogram(corpus, loader, seg_chunk))
    return zetas_of_histogram(hist, corpus, num_topics, hyper)


def sharded_streamed_doc_weights(corpus, zetas: torch.Tensor,
                                 loader: Loader, mesh: Mesh,
                                 seg_chunk: int = DEFAULT_CHUNK
                                 ) -> torch.Tensor:
    """The (D,) sampling weights of every doc on every rank: each rank's
    streamed_doc_weights, gathered in doc order (4 bytes a doc)."""
    return mesh.all_gather_rows(
        streamed_doc_weights(corpus, zetas, loader, seg_chunk))


def sharded_streamed_build_b(corpus, zetas: torch.Tensor,
                             select_docs: Optional[torch.Tensor],
                             loader: Loader, mesh: Mesh
                             ) -> Tuple[ShardedDocSparse, np.ndarray]:
    """B from the rank's chunks, its kept docs renumbered from 0, as its
    part of a ShardedDocSparse; `select_docs` is a (D,) bool mask over
    every doc. Returns (B, original_cols of all ranks): what
    sharding.sharded_threshold_and_copy builds on the same mesh."""
    B, cols = streamed_build_b(corpus, zetas, select_docs, loader)
    return join_doc_shards(B, cols, mesh)


def sharded_streamed_filter_clustered(corpus, cluster_of_doc: torch.Tensor,
                                      loader: Loader, mesh: Mesh
                                      ) -> WordSharded:
    """The entries of A whose doc has a cluster (cluster_of_doc: (D,)
    global), word-sharded: each rank filters its chunks, the per-word
    counts are all-reduced into word_bounds that every rank cuts alike,
    and one all-to-all sends each entry to the rank that owns its word.
    A rank receives the other ranks' entries in rank order, so in doc
    order, and sorts them by word (stable): equal to
    sharding.shard_by_word of the whole filtered matrix."""
    V, D = corpus.vocab_size, corpus.num_docs
    dev = loader.device
    parts = []
    for _, _, w, v, d in loader.chunks():
        keep = cluster_of_doc[d] >= 0
        parts.append((w[keep], d[keep], v[keep]))
    w = _concat([p[0] for p in parts], torch.int32, dev)
    d = _concat([p[1] for p in parts], torch.int32, dev)
    v = _concat([p[2] for p in parts], torch.float32, dev)
    del parts
    counts = mesh.all_reduce(torch.bincount(w, minlength=V).to(torch.int64))
    bounds = word_bounds_of_counts(counts.cpu().numpy(), mesh.world)
    # the owner of word x: the last rank whose range starts at or below x
    owner = torch.searchsorted(
        torch.from_numpy(bounds[1:-1].astype(np.int32)).to(dev), w,
        right=True, out_int32=True)
    order = torch.sort(owner, stable=True).indices
    send = torch.bincount(owner, minlength=mesh.world).tolist()
    # one exchange for all three fields: the values travel as their bits
    rows = torch.stack([w, d, v.view(torch.int32)], dim=1)[order]
    got = mesh.all_to_all_rows(rows, send)
    lo, hi = int(bounds[mesh.rank]), int(bounds[mesh.rank + 1])
    ws, perm = torch.sort(got[:, 0] - lo, stable=True)
    return WordSharded(
        w_word=ws, w_doc=got[:, 1][perm].contiguous(),
        w_val=got[:, 2][perm].contiguous().view(torch.float32),
        vocab=hi - lo, num_docs=D, word_bounds=tuple(int(b) for b in bounds),
        nnz=int(counts.sum()))


def sharded_model_thresholds(mass: torch.Tensor,
                             has_catchwords: torch.Tensor,
                             rank_threshold: int, num_docs: int,
                             mesh: Mesh) -> torch.Tensor:
    """Per topic, the rank_threshold-th largest doc mass over every rank's
    docs, without gathering the (D, k) mass: `mass` is this rank's (D_r,
    k) rows. The non-negative float32 values order as their int32 bit
    patterns, so a binary search over the bits finds the largest v with
    count(mass >= v) >= r, which is the r-th largest: 31 fixed steps from
    [0, +inf), each one all-reduce of a (k,) int64 count. As
    topic_model.model_thresholds: 0 where fewer than r docs have a
    positive mass, where the topic has no catchword, or for every topic
    when r <= 0 or r > num_docs. Exact: equal to model_thresholds on the
    gathered mass."""
    k = mass.shape[1]
    dev = mass.device
    if rank_threshold <= 0 or rank_threshold > num_docs:
        return torch.zeros(k, dtype=torch.float32, device=dev)

    def count_ge(v: torch.Tensor) -> torch.Tensor:
        return mesh.all_reduce(
            torch.sum(mass >= v[None, :], dim=0, dtype=torch.int64))

    pos_counts = mesh.all_reduce(
        torch.sum(mass > 0.0, dim=0, dtype=torch.int64))
    # invariant: count_ge(lo) >= r > count_ge(hi)
    lo = torch.zeros(k, dtype=torch.int64, device=dev)
    hi = torch.full((k,), _INF_BITS, dtype=torch.int64, device=dev)
    for _ in range(31):
        mid = lo + (hi - lo) // 2
        ok = count_ge(mid.to(torch.int32).view(torch.float32)) \
            >= rank_threshold
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    thr = lo.to(torch.int32).view(torch.float32)
    thr = torch.where(pos_counts >= rank_threshold, thr, 0.0)
    return torch.where(has_catchwords, thr, 0.0)


def sharded_top_two_topics(mass: torch.Tensor, mesh: Mesh):
    """topic_model.top_two_topics of every doc on every rank, from this
    rank's (D_r, k) mass: (t1, t2, valid) gathered in doc order (`valid`
    as uint8: NCCL moves no bool)."""
    t1, t2, valid = top_two_topics(mass)
    return (mesh.all_gather_rows(t1), mesh.all_gather_rows(t2),
            mesh.all_gather_rows(valid.to(torch.uint8)).to(torch.bool))


def sharded_streamed_model(corpus, W: torch.Tensor, loader: Loader,
                           mesh: Mesh, seg_chunk: int = DEFAULT_CHUNK
                           ) -> torch.Tensor:
    """The (V, k) l1-normalized model on every rank: each rank's A W over
    its chunks (W: its (D_r, k) rows), one all-reduce."""
    model = streamed_model_accumulation(corpus, W, loader, seg_chunk)
    return l1_normalize_columns(mesh.all_reduce(model.contiguous()))


def _rank_loader(st, doc_range: Tuple[int, int]) -> Loader:
    """The rank's loader over its docs `doc_range`: a ResidentLoader on
    every rank where the largest rank's slabs fit
    GpuConfig.resident_corpus_bytes (one all-reduce), else a ChunkLoader
    on every rank."""
    t = st._t
    budget = t.gpu.resident_corpus_bytes
    corpus = t.corpus
    if budget and corpus.nnz:
        form = counts_dtype(corpus)
        mine = ResidentLoader.resident_bytes(corpus, st.chunk_entries, form,
                                             doc_range)
        largest = int(t.mesh.all_max(torch.tensor(
            [mine], dtype=torch.int64, device=t.device)))
        if largest <= budget:
            if not (isinstance(st.loader, ResidentLoader)
                    and st.loader.corpus is corpus
                    and st.loader.doc_range == tuple(doc_range)):
                st.loader = None  # its buffers go before the next's
                st.loader = ResidentLoader(corpus, st.chunk_entries,
                                           t.device, doc_range, form)
            return st.loader
    return st._chunk_loader(doc_range, resident_bytes=0)


def train_sharded_streamed(st, resume: bool = False) -> None:
    """StreamedTrainer.train's body under a mesh: the streamed passes over
    each rank's doc range, the in-core sharded middle on the B they
    build. The checkpoint files and the draw streams are the other
    trainers', so a run resumes across trainers and world sizes; rank 0
    alone reads and writes the run directory, and the checkpoints reach
    the other ranks by a broadcast."""
    t = st._t
    mesh = t.mesh
    cfg = t.config
    hp = cfg.hyper
    k = cfg.num_topics
    corpus = t.corpus
    D = corpus.num_docs
    chunk = t.gpu.seg_chunk
    dev = t.device
    t.logger.info(f"sharded streamed training on {mesh.world} rank(s)")

    ck = mesh.broadcast_object(
        t._load_checkpoints() if resume and t.is_writer else {})
    if t._restore_model_checkpoint(ck):
        return
    loader = _rank_loader(st, doc_range(D, mesh))
    if isinstance(loader, ResidentLoader):
        loader.fill()
        t._mark("sharded resident corpus fill")

    if "svd" in ck:
        zetas = torch.from_numpy(ck["svd"]["zetas"]).to(dev)
        t.original_cols = ck["svd"]["original_cols"]
        t.logger.info("resumed thresholds from 'svd' checkpoint")
    else:
        zetas, new_nnz = sharded_streamed_thresholds(corpus, k, hp, loader,
                                                     mesh, chunk)
        t.logger.info(f"Entries above threshold: {new_nnz}")
        t._mark("streamed thresholds (sharded)")

    if "kmeans" in ck:
        t.centers = ck["kmeans"]["centers"]
        t.cluster_of_doc = ck["kmeans"]["cluster_of_doc"]
        if "svd" in ck:
            t.evalues = ck["svd"]["evalues"]
        t.logger.info("resumed clustering from 'kmeans' checkpoint")
        _finish_sharded_streamed(st, t.cluster_of_doc, loader)
        return

    # the docs of B: the checkpoint's on resume (U was computed on them),
    # rank 0's sample, or all
    select = None
    if "svd" in ck:
        select = docs_mask(t.original_cols, D, dev)
    elif cfg.sample_docs:
        weights = sharded_streamed_doc_weights(corpus, zetas, loader, mesh,
                                               chunk)
        select = mesh.broadcast(dice_select(
            weights, cfg.sample_rate, t.draws.doc_sample_uniforms(D)))
        t._mark("streamed doc sampling (sharded)")
    B, original_cols = sharded_streamed_build_b(corpus, zetas, select,
                                                 loader, mesh)
    if "svd" in ck and not np.array_equal(original_cols, t.original_cols):
        raise ValueError(
            f"checkpoint 'svd' in {t.run_dir}: its original_cols do not "
            "match its zetas on this corpus"
        )
    t.original_cols = original_cols
    t.logger.info(
        f"Columns remaining after thresholding: {B.num_docs} "
        f"nnz(B): {B.nnz} per-rank docs: {B.doc_counts}"
    )
    t._mark("streamed B construction (sharded)")
    if B.nnz == 0 or B.num_docs == 0:  # all-reduced: every rank raises
        raise ValueError(
            "thresholding dropped every entry (nnz(B)=0): the corpus "
            "is too sparse for these hyperparameters"
        )

    def agree(slab: int, nnz_b: int, limit: int) -> Tuple[int, int, int]:
        got = mesh.all_max(torch.tensor([slab, nnz_b, -limit],
                                        dtype=torch.int64, device=dev))
        return int(got[0]), int(got[1]), -int(got[2])

    cluster_of_doc = planned_middle(
        t, loader, B.local.nnz,
        lambda head, state: t._sharded_middle(
            B, zetas, original_cols, ck, head, streamed=True, state=state),
        agree)
    del B
    _finish_sharded_streamed(st, cluster_of_doc, loader)


def _finish_sharded_streamed(st, cluster_of_doc: np.ndarray,
                             loader: Loader) -> None:
    """Catchword statistics by word range, catchwords (rank 0's), and the
    topic model from the rank-local mass."""
    t = st._t
    mesh = t.mesh
    cfg = t.config
    hp = cfg.hyper
    k, D = cfg.num_topics, t.corpus.num_docs
    chunk = t.gpu.seg_chunk
    dev = t.device
    sizes = np.bincount(cluster_of_doc[cluster_of_doc >= 0],
                        minlength=k).astype(np.int32)
    cluster_t = torch.from_numpy(
        np.ascontiguousarray(cluster_of_doc, np.int32)).to(dev)
    r = max(hp.catchword_rank(
        D, k, cfg.sample_rate if cfg.sample_docs else None), 1)
    ws = sharded_streamed_filter_clustered(t.corpus, cluster_t, loader, mesh)
    thr = sharded_rth_highest(ws, cluster_t, torch.from_numpy(sizes).to(dev),
                              k, r, mesh, chunk)
    del ws
    t.catchword_thresholds = thr.cpu().numpy()
    is_cw = mesh.broadcast(find_catchwords(thr, hp.rho)).cpu().numpy()
    del thr
    cwt = torch.from_numpy(catchword_topic_map(is_cw)).to(dev)
    t.catchwords = [np.flatnonzero(is_cw[i]) for i in range(k)]
    t._mark("streamed catchwords (sharded)")

    mass = streamed_doc_topic_mass(t.corpus, cwt, k, loader, chunk)
    thr_m = sharded_model_thresholds(mass, has_catchwords(cwt, k),
                                     hp.model_rank_threshold(D, k), D, mesh)
    extra = {}
    if cfg.compute_edge_topics:
        t.top_pairs = tuple(x.cpu().numpy()
                            for x in sharded_top_two_topics(mass, mesh))
        extra = dict(t1=t.top_pairs[0], t2=t.top_pairs[1],
                     valid=t.top_pairs[2])
    lo, hi = loader.doc_range
    W = _contribution_weights(mass, thr_m, cluster_t[lo:hi])
    del mass
    model = sharded_streamed_model(t.corpus, W, loader, mesh, chunk)
    t.model = model.cpu().numpy()
    t._mark("streamed topic model (sharded)")
    t._checkpoint("model", model=t.model, is_cw=is_cw,
                  catchword_thresholds=t.catchword_thresholds, **extra)
    t.is_training_complete = True
