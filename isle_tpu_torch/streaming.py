"""Out-of-core training on one device: the corpus A stays in host memory
and crosses to the device a doc-range chunk at a time; only the
thresholded (and sampled) matrix B, the projection and the filtered A of
the clustered docs live on the device. The port of isle_tpu/streaming.py
(doc_chunks, the streamed stages and StreamedTrainer,
isle_tpu/streaming.py:604-1418) for corpora whose dual-sorted arrays do not
fit the card (UCI PubMed: 8.2M docs, 787M nnz).

Every stage that touches A is an additive or a filtering pass over the
chunks:
  1. threshold histogram      (V+1, F+1) int32, added up chunk by chunk
  2. doc weights + sampling   (D,) float32, a chunk's docs at a time
  3. B construction           per-chunk keep mask and compaction
  4. r-th highest statistics  per-chunk filter to the clustered docs, then
                              the in-core catchwords.rth_highest
  5. doc-topic mass           (D, k) float32, a chunk's docs at a time
  6. topic-model accumulation (V+1, k) float32, added up chunk by chunk
Every accumulation is one of the two segment sums of segsum.py (the
hand-written kernels on the card, their plain versions on the CPU), so
the streamed run counts and sums what the in-core run does. A doc never
straddles two chunks: the doc-keyed sums (2, 5) run on the chunk's local
doc ids into that chunk's rows and need no carry. A word reaches every
chunk: the word-keyed sums (1, 6) sort the chunk by word on the device
and pass the running result as the kernel's `init`; over c chunks they
add in another order than one in-core launch, so counts stay exact and
float sums move within 1e-5.

isle_tpu's upload codecs, resident slabs and fill pipeline
(isle_tpu/streaming.py:64-602) answer a slow host link and have no
counterpart: ChunkLoader copies the corpus's own arrays through pinned
staging buffers on a side stream, the next chunk's copy under the current
chunk's work.
"""

from __future__ import annotations

import collections
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .bmatrix import dice_select
from .catchwords import catchword_topic_map, find_catchwords, rth_highest
from .elkans import run_elkans
from .kmeans import kmeans_init_on_projected, run_lloyds_full, \
    run_lloyds_projected
from .segsum import DEFAULT_CHUNK, segsum_gather_rows, segsum_onehot
from .sparse import DocSparse, bt_x, spmm_flops
from .thresholds import freq_bound, hist_cols, zeta_from_hist
from .topic_model import _contribution_weights, has_catchwords, \
    l1_normalize_columns, model_thresholds, top_two_topics
from .trainer import Trainer, check_supported, solve_gram_eigens

DEFAULT_CHUNK_ENTRIES = 1 << 24


def doc_chunks(corpus, target_entries: int) -> Iterator[Tuple[int, int]]:
    """Yield (doc_lo, doc_hi) ranges of at most target_entries nnz each
    (a doc never straddles two ranges)."""
    D = corpus.num_docs
    offsets = corpus.offsets
    max_doc = int(np.diff(offsets).max()) if D else 0
    if max_doc > target_entries:
        raise ValueError(
            f"chunk_entries={target_entries} smaller than the largest doc "
            f"({max_doc} nnz)"
        )
    lo = 0
    while lo < D:
        # the largest hi with offsets[hi] - offsets[lo] <= target_entries
        hi = int(np.searchsorted(offsets, offsets[lo] + target_entries,
                                 side="right") - 1)
        hi = max(min(hi, D), lo + 1)
        yield lo, hi
        lo = hi


class _Slot:
    """One of ChunkLoader's two buffers: pinned staging and its device
    copy for word ids and values, and the event of its last copy."""

    def __init__(self, cap: int, device: torch.device):
        self.pin_w = torch.empty(cap, dtype=torch.int32, pin_memory=True)
        self.pin_v = torch.empty(cap, dtype=torch.float32, pin_memory=True)
        self.dev_w = torch.empty(cap, dtype=torch.int32, device=device)
        self.dev_v = torch.empty(cap, dtype=torch.float32, device=device)
        self.copied = torch.cuda.Event()


class ChunkLoader:
    """Doc-range chunks of a host corpus on `device`.

    load(lo, hi) -> (words int32, vals float32, docs int32), each
    offsets[hi] - offsets[lo] long (chunks are not padded): the entries of
    docs [lo, hi) in doc order. chunks() yields (lo, hi, words, vals,
    docs) over doc_chunks(corpus, chunk_entries) with the next chunk's
    copy in flight. On a CPU device the tensors are views of the corpus's
    arrays. On the card the word ids and values go through two slots of
    pinned staging and device buffers, allocated once here: a copy runs on
    a side stream after the work enqueued on the slot's previous content,
    and the tensors returned are valid until the second next load. The doc
    ids are built on the card from the offsets (uploaded once).

    bytes_copied, host_wait_seconds (the host waiting for a staging buffer
    to be free) and copy_wait_ms() (the current stream waiting for a
    chunk's copy) account for the copies.
    """

    def __init__(self, corpus, chunk_entries: int, device):
        self.corpus = corpus
        self.device = torch.device(device)
        self.chunk_entries = int(chunk_entries)
        self.ranges: List[Tuple[int, int]] = list(
            doc_chunks(corpus, self.chunk_entries))
        self._rows = torch.from_numpy(
            np.ascontiguousarray(corpus.rows, np.int32))
        self._vals = torch.from_numpy(
            np.ascontiguousarray(corpus.vals, np.float32))
        self._offsets = np.asarray(corpus.offsets, np.int64)
        self._off_dev = torch.from_numpy(self._offsets).to(self.device)
        self.bytes_copied = 0
        self.host_wait_seconds = 0.0
        self._waits: list = []
        self._turn = 0
        self._slots: list = []
        if self.device.type == "cuda":
            off = self._offsets
            cap = max((int(off[hi] - off[lo]) for lo, hi in self.ranges),
                      default=0)
            self._stream = torch.cuda.Stream(self.device)
            self._slots = [_Slot(max(cap, 1), self.device) for _ in range(2)]
            self.bytes_copied += self._offsets.nbytes

    def _span(self, lo: int, hi: int) -> Tuple[int, int]:
        return int(self._offsets[lo]), int(self._offsets[hi])

    def _start_copy(self, lo: int, hi: int):
        """Start the copy of docs [lo, hi) into the next slot."""
        a, b = self._span(lo, hi)
        if not self._slots:
            return None
        slot = self._slots[self._turn]
        self._turn ^= 1
        n = b - a
        if n > slot.pin_w.numel():
            raise ValueError(
                f"docs [{lo}, {hi}) hold {n} entries, more than a chunk of "
                f"this loader ({slot.pin_w.numel()})"
            )
        t0 = time.perf_counter()
        slot.copied.synchronize()  # the staging buffers are free again
        self.host_wait_seconds += time.perf_counter() - t0
        slot.pin_w[:n].copy_(self._rows[a:b])
        slot.pin_v[:n].copy_(self._vals[a:b])
        # the work enqueued so far holds the last reader of the slot
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            slot.dev_w[:n].copy_(slot.pin_w[:n], non_blocking=True)
            slot.dev_v[:n].copy_(slot.pin_v[:n], non_blocking=True)
            slot.copied.record(self._stream)
        self.bytes_copied += 8 * n
        return slot

    def _take(self, slot, lo: int, hi: int):
        """The chunk's tensors, once the current stream has its copy."""
        a, b = self._span(lo, hi)
        if slot is None:
            w, v = self._rows[a:b], self._vals[a:b]
        else:
            main = torch.cuda.current_stream(self.device)
            before = torch.cuda.Event(enable_timing=True)
            after = torch.cuda.Event(enable_timing=True)
            before.record(main)
            main.wait_event(slot.copied)
            after.record(main)
            self._waits.append((before, after))
            w, v = slot.dev_w[:b - a], slot.dev_v[:b - a]
        lens = self._off_dev[lo + 1:hi + 1] - self._off_dev[lo:hi]
        d = torch.repeat_interleave(
            torch.arange(lo, hi, dtype=torch.int32, device=self.device),
            lens, output_size=b - a)
        return w, v, d

    def load(self, lo: int, hi: int):
        return self._take(self._start_copy(lo, hi), lo, hi)

    def chunks(self):
        ranges = iter(self.ranges)
        pending: collections.deque = collections.deque()

        def start_next():
            r = next(ranges, None)
            if r is not None:
                pending.append((r, self._start_copy(*r)))

        start_next()
        start_next()
        while pending:
            (lo, hi), slot = pending.popleft()
            yield (lo, hi) + self._take(slot, lo, hi)
            start_next()

    def copy_wait_ms(self) -> float:
        """Milliseconds the current stream has waited for chunk copies
        since the last call (synchronizes the device)."""
        if self.device.type != "cuda":
            return 0.0
        torch.cuda.synchronize(self.device)
        ms = sum(a.elapsed_time(b) for a, b in self._waits)
        self._waits.clear()
        return ms


def word_slice_len(n: int, vocab: int, seg_chunk: int) -> int:
    """Entries per kernel slice for a word-keyed sum over a chunk of n
    entries. A chunk holds a fraction of the corpus's entries a word, so
    a slice of the in-core length would span that many more output rows
    and leave the card with few slices: keep about six rows a slice (a
    power of two, at least 256 entries, at most seg_chunk)."""
    per_row = 6 * n // (vocab + 1)
    return max(256, min(seg_chunk, 1 << max(per_row, 1).bit_length() - 1))


def _sort_by_word(w: torch.Tensor, *payloads: torch.Tensor):
    """A doc-ordered chunk in word order (stable), with its payloads."""
    ws, perm = torch.sort(w, stable=True)
    return (ws,) + tuple(p[perm] for p in payloads)


def streamed_thresholds(corpus, num_topics: int, hyper, loader: ChunkLoader,
                        seg_chunk: int = DEFAULT_CHUNK):
    """Stage 1: the ζ cutoffs without A on the device. Each chunk is
    sorted by word and counted into the running (V+1, F+1) int32 histogram
    by segsum_onehot. Returns (zetas float32[V], post-threshold nnz),
    equal to thresholds.compute_thresholds on the whole corpus."""
    V = corpus.vocab_size
    F = freq_bound(corpus.avg_doc_sz)
    hist = torch.zeros((V + 1, F + 1), dtype=torch.int32,
                       device=loader.device)
    for _, _, w, v, _ in loader.chunks():
        ws, rs = _sort_by_word(w, hist_cols(v, F))
        hist = segsum_onehot(ws, rs, None, V, F + 1, init=hist,
                             chunk=word_slice_len(ws.numel(), V, seg_chunk))
    hist = hist[:V]
    hist[:, 0] = 0
    zeta, nnz_w = zeta_from_hist(
        hist,
        hyper.count_gr(corpus.nz_docs, num_topics),
        hyper.count_eq(corpus.nz_docs, num_topics),
        few_drop=hyper.few_samples_threshold_drop,
        bad_drop=hyper.bad_threshold_drop,
    )
    return zeta.to(torch.float32), int(nnz_w.sum())


def streamed_doc_weights(corpus, zetas: torch.Tensor, loader: ChunkLoader,
                         seg_chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Stage 2 input: per-doc importance weights, the sum of ζ over a
    doc's entries that pass their threshold
    (src/sparseMatrix.cpp:1383-1397)."""
    weights = torch.zeros(corpus.num_docs, dtype=torch.float32,
                          device=loader.device)
    for lo, hi, w, v, d in loader.chunks():
        z = zetas[w]
        col = torch.where(torch.floor(v + 0.5) >= z, 0, -1).to(torch.int32)
        weights[lo:hi] = segsum_onehot(d - lo, col, z, hi - lo, 1,
                                       chunk=seg_chunk)[:hi - lo, 0]
    return weights


def _concat(parts: list, dtype: torch.dtype, device) -> torch.Tensor:
    return (torch.cat(parts) if parts
            else torch.zeros(0, dtype=dtype, device=device))


def streamed_build_b(corpus, zetas: torch.Tensor,
                     select_docs: Optional[torch.Tensor],
                     loader: ChunkLoader) -> Tuple[DocSparse, np.ndarray]:
    """Stage 3: B (thresholded, sqrt-ζ, docs renumbered, dual-sorted) put
    together on the device from streamed chunks; with `select_docs` (a
    (D,) bool mask) only those docs. Equal to bmatrix.threshold_and_copy
    on the whole corpus. Returns (B, original_cols host int32)."""
    D, V = corpus.num_docs, corpus.vocab_size
    dev = loader.device
    zetas = zetas.to(device=dev, dtype=torch.float32)
    sqz = torch.sqrt(zetas)
    parts_w, parts_d = [], []
    for _, _, w, v, d in loader.chunks():
        keep = torch.floor(v + 0.5) >= zetas[w]
        if select_docs is not None:
            keep &= select_docs[d]
        parts_w.append(w[keep])
        parts_d.append(d[keep])
    dw = _concat(parts_w, torch.int32, dev)
    dd_glob = _concat(parts_d, torch.int32, dev)
    del parts_w, parts_d
    occ = torch.zeros(D, dtype=torch.bool, device=dev)
    occ[dd_glob] = True
    new_doc = (torch.cumsum(occ, 0) - 1).to(torch.int32)
    original_cols = torch.nonzero(occ)[:, 0].to(torch.int32).cpu().numpy()
    dd = new_doc[dd_glob]
    del dd_glob
    dv = sqz[dw]
    nz_docs = len(original_cols)
    perm = torch.sort(dw.long() * (nz_docs + 1) + dd.long(),
                      stable=True).indices
    B = DocSparse(
        d_word=dw, d_doc=dd, d_val=dv, w_word=dw[perm], w_doc=dd[perm],
        w_val=dv[perm], vocab=V, num_docs=nz_docs,
    )
    return B, original_cols


def streamed_filter_clustered(corpus, cluster_of_doc: torch.Tensor,
                              loader: ChunkLoader) -> DocSparse:
    """Stage 4 input: the entries of A whose doc has a cluster (global doc
    ids kept), as a device DocSparse for catchwords.rth_highest."""
    D, V = corpus.num_docs, corpus.vocab_size
    dev = loader.device
    parts = []
    for _, _, w, v, d in loader.chunks():
        keep = cluster_of_doc[d] >= 0
        parts.append((w[keep], d[keep], v[keep]))
    dw = _concat([p[0] for p in parts], torch.int32, dev)
    dd = _concat([p[1] for p in parts], torch.int32, dev)
    dv = _concat([p[2] for p in parts], torch.float32, dev)
    del parts
    perm = torch.sort(dw.long() * (D + 1) + dd.long(), stable=True).indices
    return DocSparse(
        d_word=dw, d_doc=dd, d_val=dv, w_word=dw[perm], w_doc=dd[perm],
        w_val=dv[perm], vocab=V, num_docs=D,
    )


def streamed_doc_topic_mass(corpus, cw_topic: torch.Tensor, num_topics: int,
                            loader: ChunkLoader,
                            seg_chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Stage 5: the (D, k) catchword mass per doc. A chunk's docs are rows
    [lo, hi) and no other chunk's, so segsum_onehot runs on the local doc
    ids d - lo and writes that block: no carry."""
    mass = torch.zeros((corpus.num_docs, num_topics), dtype=torch.float32,
                       device=loader.device)
    for lo, hi, w, v, d in loader.chunks():
        mass[lo:hi] = segsum_onehot(d - lo, cw_topic[w], v, hi - lo,
                                    num_topics, chunk=seg_chunk)[:hi - lo]
    return mass


def streamed_model_accumulation(corpus, W: torch.Tensor, loader: ChunkLoader,
                                seg_chunk: int = DEFAULT_CHUNK
                                ) -> torch.Tensor:
    """Stage 6: A W, (V, k) from the (D, k) doc weights W. Each chunk is
    sorted by word and added to the running model by segsum_gather_rows
    (its `init`), which gathers from the chunk's own rows of W by local
    doc id."""
    V = corpus.vocab_size
    model = torch.zeros((V + 1, W.shape[1]), dtype=torch.float32,
                        device=loader.device)
    for lo, hi, w, v, d in loader.chunks():
        ws, ds, vs = _sort_by_word(w, d - lo, v)
        model = segsum_gather_rows(
            ws, ds, vs, W[lo:hi], V, init=model,
            chunk=word_slice_len(ws.numel(), V, seg_chunk))
    return model[:V]


def streamed_topic_model(
    corpus,
    cw_topic: torch.Tensor,  # (vocab,) int32 owning topic, -1 else
    cluster_of_doc: torch.Tensor,  # (num_docs,) int32, -1 = dropped doc
    num_topics: int,
    rank_threshold: int,
    want_top_pairs: bool,
    loader: ChunkLoader,
    seg_chunk: int = DEFAULT_CHUNK,
):
    """Stages 5-6 over streamed A, with the semantics of
    topic_model.construct_topic_model. Returns (Model (vocab, k)
    l1-normalized, (t1, t2, valid) or None)."""
    mass = streamed_doc_topic_mass(corpus, cw_topic, num_topics, loader,
                                   seg_chunk)
    thr = model_thresholds(mass, has_catchwords(cw_topic, num_topics),
                           rank_threshold)
    pairs = top_two_topics(mass) if want_top_pairs else None
    W = _contribution_weights(mass, thr, cluster_of_doc)
    del mass  # (D, k) floats, 3.3 GB at 8.2M docs and k = 100
    model = streamed_model_accumulation(corpus, W, loader, seg_chunk)
    return l1_normalize_columns(model), pairs


class StreamedTrainer:
    """The out-of-core variant of Trainer: the same pipeline and the same
    stage checkpoints (a run may switch between the two at any
    checkpoint), with A streamed from host memory. Everything but train()
    is the wrapped Trainer's (ingest, train_edge_topics, the writers, the
    results)."""

    def __init__(self, config, output_dir: str = ".", quiet: bool = True,
                 chunk_entries: int = DEFAULT_CHUNK_ENTRIES, **trainer_kw):
        self._t = Trainer(config, output_dir=output_dir, quiet=quiet,
                          **trainer_kw)
        self.chunk_entries = chunk_entries
        self.loader: Optional[ChunkLoader] = None
        # output_doc_topic's mass comes from chunks too: a corpus that
        # needed this trainer does not fit the card for its report either
        self._t._doc_topic_mass = self._streamed_doc_topic_mass

    def __getattr__(self, name):
        return getattr(self._t, name)

    def _chunk_loader(self) -> ChunkLoader:
        """One loader (and one set of staging buffers) for every pass of
        this trainer over its corpus."""
        t = self._t
        if self.loader is None or self.loader.corpus is not t.corpus:
            self.loader = ChunkLoader(t.corpus, self.chunk_entries, t.device)
        return self.loader

    def _streamed_doc_topic_mass(self, cw_topic: torch.Tensor
                                 ) -> torch.Tensor:
        t = self._t
        return streamed_doc_topic_mass(
            t.corpus, cw_topic, t.config.num_topics, self._chunk_loader(),
            t.gpu.seg_chunk)

    def train(self, resume: bool = False) -> None:
        """Run the streamed pipeline; with resume=True, completed stages
        restore from the run directory's checkpoints (Trainer's files).
        GpuConfig.profile_dir traces the run as it does Trainer.train."""
        t = self._t
        if t.corpus is None:
            raise RuntimeError("load data first")
        check_supported(t.config)
        t.gpu.require_single_device()
        t.run_traced(lambda: self._train_inner(resume))

    def _train_inner(self, resume: bool) -> None:
        t = self._t
        cfg = t.config
        hp = cfg.hyper
        k = cfg.num_topics
        corpus = t.corpus
        D, V = corpus.num_docs, corpus.vocab_size
        chunk = t.gpu.seg_chunk
        dev = t.device

        ck = t._load_checkpoints() if resume else {}
        if t._restore_model_checkpoint(ck):
            return
        loader = self._chunk_loader()

        if "svd" in ck:
            zetas = torch.from_numpy(ck["svd"]["zetas"]).to(dev)
            t.original_cols = ck["svd"]["original_cols"]
            t.logger.info("resumed thresholds from 'svd' checkpoint")
        else:
            zetas, new_nnz = streamed_thresholds(corpus, k, hp, loader, chunk)
            t.logger.info(f"Entries above threshold: {new_nnz}")
            t._mark("streamed thresholds")

        if "kmeans" in ck:
            t.centers = ck["kmeans"]["centers"]
            t.cluster_of_doc = ck["kmeans"]["cluster_of_doc"]
            if "svd" in ck:
                t.evalues = ck["svd"]["evalues"]
            t.logger.info("resumed clustering from 'kmeans' checkpoint")
            self._finish(t.cluster_of_doc, loader)
            return

        # the docs of B: the checkpoint's on resume (U was computed on
        # them), the sampled ones, or all
        select = None
        if "svd" in ck:
            select = torch.zeros(D, dtype=torch.bool, device=dev)
            select[torch.from_numpy(t.original_cols).long().to(dev)] = True
        elif cfg.sample_docs:
            weights = streamed_doc_weights(corpus, zetas, loader, chunk)
            select = dice_select(weights, cfg.sample_rate,
                                 t.draws.doc_sample_uniforms(D))
            t._mark("streamed doc sampling")
        B, original_cols = streamed_build_b(corpus, zetas, select, loader)
        if "svd" in ck and not np.array_equal(original_cols, t.original_cols):
            raise ValueError(
                f"checkpoint 'svd' in {t.run_dir}: its original_cols do not "
                "match its zetas on this corpus"
            )
        t.original_cols = original_cols
        t.logger.info(
            f"Columns remaining after thresholding: {B.num_docs} "
            f"nnz(B): {B.nnz}"
        )
        t._mark("streamed B construction")
        if B.nnz == 0 or B.num_docs == 0:
            raise ValueError(
                "thresholding dropped every entry (nnz(B)=0): the corpus "
                "is too sparse for these hyperparameters"
            )

        if "svd" in ck:
            t.evalues = ck["svd"]["evalues"]
            U = torch.from_numpy(ck["svd"]["U"]).to(dev)
            t.logger.info("resumed eigenvectors from 'svd' checkpoint")
        else:
            t.evalues, U, stats = solve_gram_eigens(
                B, V, k, cfg, t.draws, chunk, timer=t.timer, logger=t.logger,
                start_block=t._warm_start_block(V),
            )
            if stats is not None:
                res, op_width = stats
                t.op_counter.add(res.op_seconds,
                                 spmm_flops(B, op_width) * res.op_calls,
                                 res.op_calls)
            t._mark("eigen solve (B B^T)")
            t._checkpoint("svd", U=U.cpu().numpy(), evalues=t.evalues,
                          zetas=zetas.cpu().numpy(),
                          original_cols=original_cols)

        # seeding and Lloyd's on the projected docs, then the full space
        # (as isle_tpu's streamed trainer: always through the projection)
        if not hp.enable_kmeans_on_lowd:
            t.logger.warning(
                "the streamed trainer always runs k-means on the projected "
                "docs first: enable_kmeans_on_lowd=False is ignored")
        P = bt_x(B, U, chunk).T
        _, centers_lowd, _ = kmeans_init_on_projected(
            P, k, hp.kmeans_init_reps, t.draws,
            method=hp.kmeans_init_method,
            mcmc_sample_size=hp.kmeansmcmc_sample_size,
        )
        centers_lowd, _ = run_lloyds_projected(
            P, centers_lowd, hp.max_kmeans_lowd_reps)
        full_kmeans = (run_elkans if hp.kmeans_algo_for_sparse == "elkans"
                       else run_lloyds_full)
        centers_full, assign = full_kmeans(
            B, centers_lowd @ U.T, hp.max_kmeans_reps, timer=t.timer,
            chunk=chunk)
        t.centers = centers_full.cpu().numpy()
        t._mark("k-means")

        cluster_of_doc = np.full(D, -1, np.int32)
        cluster_of_doc[original_cols] = assign.cpu().numpy().astype(np.int32)
        t.cluster_of_doc = cluster_of_doc
        t._checkpoint("kmeans", centers=t.centers,
                      cluster_of_doc=cluster_of_doc)
        # B, the projection and the centers leave the device before the
        # (D, k) working set of the last stages arrives
        del B, U, P, centers_lowd, centers_full, assign
        self._finish(cluster_of_doc, loader)

    def _finish(self, cluster_of_doc: np.ndarray,
                loader: ChunkLoader) -> None:
        """Catchword statistics, catchwords and the topic matrix."""
        t = self._t
        cfg = t.config
        hp = cfg.hyper
        k, D = cfg.num_topics, t.corpus.num_docs
        chunk = t.gpu.seg_chunk
        sizes = np.bincount(cluster_of_doc[cluster_of_doc >= 0],
                            minlength=k).astype(np.int32)
        cluster_t = torch.from_numpy(
            np.ascontiguousarray(cluster_of_doc, np.int32)).to(t.device)
        r = max(hp.catchword_rank(
            D, k, cfg.sample_rate if cfg.sample_docs else None), 1)
        A_sub = streamed_filter_clustered(t.corpus, cluster_t, loader)
        thr = rth_highest(A_sub, cluster_t,
                          torch.from_numpy(sizes).to(t.device), k, r, chunk)
        del A_sub
        t.catchword_thresholds = thr.cpu().numpy()
        is_cw = find_catchwords(thr, hp.rho).cpu().numpy()
        del thr
        cwt = catchword_topic_map(is_cw)
        t.catchwords = [np.flatnonzero(is_cw[i]) for i in range(k)]
        t._mark("streamed catchwords")

        model, pairs = streamed_topic_model(
            t.corpus, torch.from_numpy(cwt).to(t.device), cluster_t, k,
            hp.model_rank_threshold(D, k),
            want_top_pairs=cfg.compute_edge_topics, loader=loader,
            seg_chunk=chunk,
        )
        t.model = model.cpu().numpy()
        extra = {}
        if pairs is not None:
            t.top_pairs = tuple(x.cpu().numpy() for x in pairs)
            extra = dict(t1=t.top_pairs[0], t2=t.top_pairs[1],
                         valid=t.top_pairs[2])
        t._mark("streamed topic model")
        t._checkpoint("model", model=t.model, is_cw=is_cw,
                      catchword_thresholds=t.catchword_thresholds, **extra)
        t.is_training_complete = True
