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
float sums move within 1e-5. Between B and the finish the middle runs on
the device as Trainer's does, on B's hybrid layout (hybrid.py) where
GpuConfig.dense_head_bytes asks for one, as isle_tpu's streamed middle.

The corpus reaches the device through one of two loaders: a
ResidentLoader copies it once, into slabs that every pass decodes its
chunks from (isle_tpu's ResidentLoader, isle_tpu/streaming.py:421-552),
where its slabs fit GpuConfig.resident_corpus_bytes; a ChunkLoader copies
every chunk on every pass otherwise. Both copy through pinned staging on a
side stream. Between B and the middle, plan_middle_budget decides whether
the slabs stay held and with how large a dense head, and a middle that
runs out of device memory with the slabs held runs again with them
released (planned_middle). isle_tpu's wire codecs (u16 word deltas,
nibble-packed counts and their exception lists,
isle_tpu/streaming.py:64-206) answer a slow host link and have no
counterpart.
"""

from __future__ import annotations

import collections
import copy
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .bmatrix import dice_select
from .catchwords import catchword_topic_map, find_catchwords, rth_highest
from .elkans import run_elkans
from .hybrid import max_head_rows, row_scale_from_zetas, to_hybrid
from .kmeans import kmeans_init_on_projected, run_lloyds_full, \
    run_lloyds_projected
from .matops import mat_bt_x
from .segsum import DEFAULT_CHUNK, segsum_gather_rows, segsum_onehot
from .sharding import require_mesh
from .sparse import DocSparse, doc_ids_from_offsets, with_doc_tiles
from .staging import DEFAULT_CHUNK_ENTRIES, Staging
from .thresholds import freq_bound, hist_cols, zeta_from_hist
from .topic_model import _contribution_weights, has_catchwords, \
    l1_normalize_columns, model_thresholds, top_two_topics
from .trainer import Trainer, check_supported, solve_gram_eigens


def doc_chunks(corpus, target_entries: int,
               doc_range: Optional[Tuple[int, int]] = None
               ) -> Iterator[Tuple[int, int]]:
    """Yield (doc_lo, doc_hi) ranges of at most target_entries nnz each
    (a doc never straddles two ranges) over the docs of `doc_range`
    (lo, hi), the whole corpus by default. The largest doc of the whole
    corpus bounds target_entries, so every rank of a mesh refuses the
    same setting."""
    D = corpus.num_docs
    offsets = corpus.offsets
    max_doc = int(np.diff(offsets).max()) if D else 0
    if max_doc > target_entries:
        raise ValueError(
            f"chunk_entries={target_entries} smaller than the largest doc "
            f"({max_doc} nnz)"
        )
    lo, end = (0, D) if doc_range is None else doc_range
    while lo < end:
        # the largest hi with offsets[hi] - offsets[lo] <= target_entries
        hi = int(np.searchsorted(offsets, offsets[lo] + target_entries,
                                 side="right") - 1)
        hi = max(min(hi, end), lo + 1)
        yield lo, hi
        lo = hi


class Loader:
    """What both chunk loaders share. A loader hands out doc-range chunks
    of a host corpus on `device`, over the docs `doc_range` = (lo, hi)
    (the whole corpus by default; a rank of a mesh takes its own range).

    load(lo, hi) -> (words int32, vals float32, docs int32), each
    offsets[hi] - offsets[lo] long (chunks are not padded): the entries of
    docs [lo, hi) in doc order, global doc ids. chunks() yields (lo, hi,
    words, vals, docs) over doc_chunks(corpus, chunk_entries, doc_range),
    the next chunk's copy, where there is one, in flight.

    bytes_copied, host_wait_seconds (the host waiting for a staging buffer
    to be free) and copy_wait_ms() (the current stream waiting for a
    chunk's copy) account for the copies to the card. A copy goes through
    one of two slots of pinned staging on a side stream, after the work
    enqueued so far on the current stream (which holds the last reader of
    the slot's content).
    """

    def __init__(self, corpus, chunk_entries: int, device,
                 doc_range: Optional[Tuple[int, int]] = None):
        self.corpus = corpus
        self.device = torch.device(device)
        self.chunk_entries = int(chunk_entries)
        lo, hi = (0, corpus.num_docs) if doc_range is None else doc_range
        self.doc_range = (int(lo), int(hi))
        self.ranges: List[Tuple[int, int]] = list(
            doc_chunks(corpus, self.chunk_entries, self.doc_range))
        self._offsets = np.asarray(corpus.offsets, np.int64)
        self.bytes_copied = 0
        self.host_wait_seconds = 0.0
        self._waits: list = []
        self._staging: Optional[Staging] = None

    def _span(self, lo: int, hi: int) -> Tuple[int, int]:
        return int(self._offsets[lo]), int(self._offsets[hi])

    def _cap(self) -> int:
        """The entries of the range's largest chunk."""
        return max(b - a for a, b in (self._span(*r) for r in self.ranges))

    @property
    def _slots(self) -> list:
        """The two staging slots, while the loader holds them."""
        return self._staging.slots if self._staging is not None else []

    def _open_staging(self, dtypes, own: bool) -> None:
        self._staging = Staging(self._cap(), dtypes, self.device, own)

    def _stage(self, srcs, dsts=None):
        """Copy the host tensors `srcs` (one length) into the device
        tensors `dsts`, else into the next slot's own buffers; returns
        the slot."""
        slot, waited = self._staging.stage(srcs, dsts)
        self.host_wait_seconds += waited
        self.bytes_copied += srcs[0].numel() * sum(
            p.element_size() for p in slot.pin)
        return slot

    def _doc_ids(self, off_dev: torch.Tensor, lo: int, hi: int
                 ) -> torch.Tensor:
        """The global doc id of each entry of docs [lo, hi), from the
        range's offsets on the device."""
        a, b = self._span(lo, hi)
        base = self.doc_range[0]
        return doc_ids_from_offsets(off_dev[lo - base:hi + 1 - base], lo,
                                    b - a)

    def _start(self, lo: int, hi: int):
        """Start what chunk [lo, hi) needs before _take (a copy)."""
        raise NotImplementedError

    def _take(self, started, lo: int, hi: int):
        """Chunk [lo, hi) as (words, vals, docs) on the device."""
        raise NotImplementedError

    def load(self, lo: int, hi: int):
        first, end = self.doc_range
        if not first <= lo < hi <= end:
            raise ValueError(f"docs [{lo}, {hi}) are not a non-empty part "
                             f"of this loader's range [{first}, {end})")
        return self._take(self._start(lo, hi), lo, hi)

    def chunks(self):
        ranges = iter(self.ranges)
        pending: collections.deque = collections.deque()

        def start_next():
            r = next(ranges, None)
            if r is not None:
                pending.append((r, self._start(*r)))

        start_next()
        start_next()
        while pending:
            (lo, hi), started = pending.popleft()
            yield (lo, hi) + self._take(started, lo, hi)
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


class ChunkLoader(Loader):
    """A Loader that copies every chunk on every pass. On a CPU device the
    tensors are views of the corpus's arrays. On the card the word ids and
    values go through the two slots, each with device buffers of its own,
    allocated once here and sized by the range's largest chunk (none for
    an empty range): the tensors returned are valid until the second next
    load. The doc ids are built on the card from the range's offsets
    (uploaded once)."""

    def __init__(self, corpus, chunk_entries: int, device,
                 doc_range: Optional[Tuple[int, int]] = None):
        super().__init__(corpus, chunk_entries, device, doc_range)
        self._rows = torch.from_numpy(
            np.ascontiguousarray(corpus.rows, np.int32))
        self._vals = torch.from_numpy(
            np.ascontiguousarray(corpus.vals, np.float32))
        lo, hi = self.doc_range
        range_offsets = self._offsets[lo:hi + 1]
        self._off_dev = torch.from_numpy(range_offsets).to(self.device)
        if self.device.type == "cuda" and self.ranges:
            self._open_staging((torch.int32, torch.float32), own=True)
            self.bytes_copied += range_offsets.nbytes

    def _start(self, lo: int, hi: int):
        if not self._slots:
            return None
        a, b = self._span(lo, hi)
        return self._stage((self._rows[a:b], self._vals[a:b]))

    def _take(self, slot, lo: int, hi: int):
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
            w, v = slot.dev[0][:b - a], slot.dev[1][:b - a]
        return w, v, self._doc_ids(self._off_dev, lo, hi)


def counts_dtype(corpus) -> Optional[np.dtype]:
    """The numpy dtype the resident counts form keeps a corpus's raw counts
    in, or None where the values cannot be rebuilt from them: the rule of
    isle_tpu's _compact_plan (isle_tpu/streaming.py:208-256). The counts
    must be integral, and avg * (count / doc_sum) in float32, the count
    cast to the dtype, must give `vals` bit for bit on every entry; the
    dtype is uint8 below 256, uint16 below 65536, int32 otherwise."""
    counts = getattr(corpus, "counts", None)
    if counts is None:
        return None
    if corpus.nnz and not bool(np.all(counts == np.floor(counts))):
        return None
    cmax = float(counts.max()) if corpus.nnz else 0.0
    dtype = np.dtype(np.uint8 if cmax < 256
                     else np.uint16 if cmax < 65536 else np.int32)
    avg = np.float32(corpus.avg_doc_sz)
    if corpus.nnz and not corpus.vals_match(
            lambda c, ds: avg * (c.astype(dtype).astype(np.float32) / ds)):
        return None
    return dtype


# the dtype a slab holds counts of each dtype in: uint16 as its bits in
# int16, the smallest dtype every PyTorch build moves and converts on the
# card
_COUNT_STORAGE = {np.dtype(np.uint8): (np.uint8, torch.uint8),
                  np.dtype(np.uint16): (np.int16, torch.int16),
                  np.dtype(np.int32): (np.int32, torch.int32)}


def _count_values(c: torch.Tensor) -> torch.Tensor:
    """A slab's counts as their values (uint16 counts are kept as their
    bits in int16)."""
    return c.to(torch.int32) & 0xFFFF if c.dtype == torch.int16 else c


class ResidentLoader(Loader):
    """A Loader that copies its range of the corpus to the device once, into
    slabs that every pass decodes its chunks from: isle_tpu's
    ResidentLoader (isle_tpu/streaming.py:421-552). Two forms:

      - counts form, where counts_dtype(corpus) gives a dtype: word ids
        int32, the raw counts in that dtype and the doc sums float32;
        a chunk's values are avg * (count / doc_sum), the expression of
        Corpus.from_entries in its order, so equal to `vals` bit for bit;
      - vals form otherwise: word ids int32 and the values float32,
        verbatim.

    `form`: "auto" (counts_dtype's choice), or what counts_dtype returned
    (None for the vals form). Doc ids come from the range's offsets, kept
    on the device beside the slabs. The fill is lazy, on the first load
    (a resume that skips every pass never pays it), and goes chunk by
    chunk through the two staging slots into each chunk's part of the
    slabs, allocated whole beforehand. fill_count and fill_seconds (host
    clock, until the copies have ended) count the fills; release() frees
    the slabs, and the next load fills them again. The tensors returned
    are views of the slabs or made from them: valid until release().
    """

    def __init__(self, corpus, chunk_entries: int, device,
                 doc_range: Optional[Tuple[int, int]] = None, form="auto"):
        super().__init__(corpus, chunk_entries, device, doc_range)
        self.count_dtype = counts_dtype(corpus) if form == "auto" else form
        self.fill_count = 0
        self.fill_seconds = 0.0
        self._slabs = None

    @staticmethod
    def resident_bytes(corpus, chunk_entries: int, count_dtype,
                       doc_range: Optional[Tuple[int, int]] = None) -> int:
        """isle_tpu's ResidentLoader.resident_bytes (isle_tpu/streaming.py:
        449-452) over the docs of `doc_range`: (entries + chunk_entries) x
        (4 + the bytes of a count, or 4 of a value) + 8 x (docs + 8). The
        chunk's slack and the 8 bytes a doc are the reference's (its padded
        store window, its offsets and doc sums), kept so that both packages
        take the same loader for the same corpus and budget."""
        lo, hi = (0, corpus.num_docs) if doc_range is None else doc_range
        entries = int(corpus.offsets[hi]) - int(corpus.offsets[lo])
        size = 4 if count_dtype is None else np.dtype(count_dtype).itemsize
        return (entries + chunk_entries) * (4 + size) + 8 * (hi - lo + 8)

    @property
    def slab_bytes(self) -> int:
        return self.resident_bytes(self.corpus, self.chunk_entries,
                                   self.count_dtype, self.doc_range)

    @property
    def held(self) -> bool:
        """Whether the slabs are on the device."""
        return self._slabs is not None

    def fill(self) -> None:
        """Copy the range to the device, unless the slabs are held."""
        if self._slabs is not None:
            return
        t0 = time.perf_counter()
        corpus, dev = self.corpus, self.device
        first, end = self.doc_range
        a0, b0 = self._span(first, end)
        rows = np.ascontiguousarray(corpus.rows, np.int32)
        if self.count_dtype is None:
            host, dtype = np.ascontiguousarray(corpus.vals, np.float32), None
            second = torch.empty(b0 - a0, dtype=torch.float32, device=dev)
        else:
            host = corpus.counts
            dtype, storage = _COUNT_STORAGE[np.dtype(self.count_dtype)]
            second = torch.empty(b0 - a0, dtype=storage, device=dev)
        words = torch.empty(b0 - a0, dtype=torch.int32, device=dev)
        cuda = dev.type == "cuda" and bool(self.ranges)
        if cuda:
            self._open_staging((torch.int32, second.dtype), own=False)
        for lo, hi in self.ranges:
            a, b = self._span(lo, hi)
            srcs = (torch.from_numpy(rows[a:b]), torch.from_numpy(
                host[a:b] if dtype is None
                else host[a:b].astype(self.count_dtype).view(dtype)))
            dsts = (words[a - a0:b - a0], second[a - a0:b - a0])
            if cuda:
                self._stage(srcs, dsts)
            else:
                for d, src in zip(dsts, srcs):
                    d.copy_(src)
        if cuda:
            self._staging.finish()
            self._staging = None  # the pinned staging goes with the fill
        off = torch.from_numpy(self._offsets[first:end + 1]).to(dev)
        if dev.type == "cuda":
            self.bytes_copied += off.nbytes
        doc_sums = avg = None
        if dtype is not None:
            # Corpus.doc_sums() of the range, from the slabs: the counts are
            # integral, so their int64 sums are exact, and each rounds to
            # float32 as the host's exact float64 sum does
            sums = torch.zeros(end - first, dtype=torch.int64, device=dev)
            for lo, hi in self.ranges:
                a, b = self._span(lo, hi)
                sums.index_add_(0, self._doc_ids(off, lo, hi) - first,
                                _count_values(second[a - a0:b - a0]).long())
            doc_sums = torch.where(off[1:] > off[:-1],
                                   sums.to(torch.float32), 1.0)
            avg = torch.tensor(np.float32(corpus.avg_doc_sz), device=dev)
        self._slabs = (words, second, off, doc_sums, avg)
        self.fill_count += 1
        self.fill_seconds += time.perf_counter() - t0

    def release(self) -> None:
        """Free the slabs: the next load fills them again."""
        self._slabs = None

    def _start(self, lo: int, hi: int):
        self.fill()
        return None

    def _take(self, _, lo: int, hi: int):
        words, second, off, doc_sums, avg = self._slabs
        a, b = self._span(lo, hi)
        a0 = int(self._offsets[self.doc_range[0]])
        w, c = words[a - a0:b - a0], second[a - a0:b - a0]
        d = self._doc_ids(off, lo, hi)
        if doc_sums is None:
            return w, c, d
        # divided by the gathered float32 doc sums, never by a scalar (a
        # scalar divisor becomes a multiply by its reciprocal on the card)
        v = avg * (_count_values(c).to(torch.float32)
                   / doc_sums[d - self.doc_range[0]])
        return w, v, d


def get_corpus_loader(corpus, chunk_entries: int, device,
                      resident_bytes: int,
                      doc_range: Optional[Tuple[int, int]] = None) -> Loader:
    """The loader of the streamed passes over the docs `doc_range`: a
    ResidentLoader where its slabs fit `resident_bytes`
    (ResidentLoader.resident_bytes, the rule of isle_tpu's
    get_corpus_loader, isle_tpu/streaming.py:590-602), else a
    ChunkLoader."""
    if resident_bytes and corpus.nnz:
        form = counts_dtype(corpus)
        if ResidentLoader.resident_bytes(corpus, chunk_entries, form,
                                         doc_range) <= resident_bytes:
            return ResidentLoader(corpus, chunk_entries, device, doc_range,
                                  form)
    return ChunkLoader(corpus, chunk_entries, device, doc_range)


# isle_tpu's constants of the middle's memory plan
# (isle_tpu/streaming.py:555-564): the peak temporaries of the hybrid
# build beside a full head, measured at the PubMed shape, and those of the
# middle without a head (B itself and the eigensolver and k-means state),
# each a nonzero of B; a reserve; the smallest head worth building.
_MIDDLE_TEMP_B_PER_NNZ = 96
_MIDDLE_NOHEAD_B_PER_NNZ = 30
_MIDDLE_RESERVE = 1 << 30
_MIN_HEAD_BYTES = 256 << 20


def plan_middle_budget(hbm_bytes: int, slab_bytes: int, nnz_b: int,
                       cfg_head_bytes: int) -> Tuple[bool, int]:
    """Whether the resident slabs stay held through the middle stages, and
    with how large a dense head: isle_tpu's plan_middle_budget
    (isle_tpu/streaming.py:567-587). A refill costs a pass over the host
    link and the head saves seconds of SpMM, so where both do not fit the
    head shrinks into what is left, then goes, and the slabs are released
    only where even the middle without a head does not fit. Returns
    (keep_slabs, head_bytes): the head budget to build with when the
    slabs are kept, else the configured one."""
    room = (hbm_bytes - slab_bytes - _MIDDLE_TEMP_B_PER_NNZ * nnz_b
            - _MIDDLE_RESERVE)
    if cfg_head_bytes > 0 and room >= _MIN_HEAD_BYTES:
        return True, int(min(cfg_head_bytes, room))
    room_nohead = (hbm_bytes - slab_bytes
                   - _MIDDLE_NOHEAD_B_PER_NNZ * nnz_b - _MIDDLE_RESERVE)
    if room_nohead >= 0:
        return True, 0
    return False, cfg_head_bytes


def planned_middle(t, loader: Loader, nnz_b: int, run, agree=None):
    """run(head_bytes, state) -> the middle's result, with the head budget
    plan_middle_budget gives while `loader`'s resident slabs are held (on
    GpuConfig.hbm_limit(); no plan without a limit), and once more with
    the slabs released and the configured head if the held attempt runs
    out of device memory: isle_tpu/streaming.py:1221-1350. `state` (a
    dict) lasts over both attempts, so that the retry reuses the
    eigenpairs, and the retry draws what the first attempt drew (the
    trainer's draw source as it stood before it), as isle_tpu's retry
    takes the same keys. Any other error, or running out of memory with
    no slabs held, propagates. `agree` maps (slab bytes, nnz_b, limit) to
    the values every rank of a mesh plans with."""
    gpu = t.gpu
    head = cfg_head = gpu.dense_head_bytes
    held = isinstance(loader, ResidentLoader) and loader.held
    limit = gpu.hbm_limit()
    if held and limit is not None:
        slab, nnz, limit = (loader.slab_bytes, nnz_b, limit) \
            if agree is None else agree(loader.slab_bytes, nnz_b, limit)
        keep, head = plan_middle_budget(limit, slab, nnz, cfg_head)
        if not keep:
            loader.release()
            held = False
        elif head != cfg_head:
            t.logger.info(f"holding the resident corpus ({slab >> 20} MiB) "
                          f"through the middle; dense head budget "
                          f"{head >> 20} MiB")
    state: dict = {}
    draws = copy.deepcopy(t.draws) if held else None
    try:
        return run(head, state)
    except torch.OutOfMemoryError:
        if not held:
            raise
    # out of the except block: the error's frames, and the failed
    # attempt's tensors with them, are gone
    t.logger.warning("the middle stages ran out of device memory with the "
                     "resident corpus held; releasing the slabs and "
                     "retrying (the finish passes will refill)")
    loader.release()
    if t.device.type == "cuda":
        torch.cuda.empty_cache()
    t.draws = draws
    return run(cfg_head, state)


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


def streamed_histogram(corpus, loader: Loader,
                       seg_chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """The running (V+1, F+1) int32 histogram of rounded frequencies over
    the loader's chunks: each chunk sorted by word and counted by
    segsum_onehot on top of the chunks before it (its `init`). Row V is
    the spill row."""
    V = corpus.vocab_size
    F = freq_bound(corpus.avg_doc_sz)
    hist = torch.zeros((V + 1, F + 1), dtype=torch.int32,
                       device=loader.device)
    for _, _, w, v, _ in loader.chunks():
        ws, rs = _sort_by_word(w, hist_cols(v, F))
        hist = segsum_onehot(ws, rs, None, V, F + 1, init=hist,
                             chunk=word_slice_len(ws.numel(), V, seg_chunk))
    return hist


def zetas_of_histogram(hist: torch.Tensor, corpus, num_topics: int, hyper):
    """ζ from the whole corpus's streamed_histogram. Returns (zetas
    float32[V], post-threshold nnz)."""
    hist = hist[:corpus.vocab_size]
    hist[:, 0] = 0
    zeta, nnz_w = zeta_from_hist(
        hist,
        hyper.count_gr(corpus.nz_docs, num_topics),
        hyper.count_eq(corpus.nz_docs, num_topics),
        few_drop=hyper.few_samples_threshold_drop,
        bad_drop=hyper.bad_threshold_drop,
    )
    return zeta.to(torch.float32), int(nnz_w.sum())


def streamed_thresholds(corpus, num_topics: int, hyper, loader: Loader,
                        seg_chunk: int = DEFAULT_CHUNK):
    """Stage 1: the ζ cutoffs without A on the device, from the running
    histogram of the chunks. Returns (zetas float32[V], post-threshold
    nnz), equal to thresholds.compute_thresholds on the whole corpus."""
    return zetas_of_histogram(streamed_histogram(corpus, loader, seg_chunk),
                              corpus, num_topics, hyper)


def streamed_doc_weights(corpus, zetas: torch.Tensor, loader: Loader,
                         seg_chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Stage 2 input: per-doc importance weights, the sum of ζ over a
    doc's entries that pass their threshold
    (src/sparseMatrix.cpp:1383-1397), for the docs of the loader's range
    (row 0 is its first doc)."""
    first, end = loader.doc_range
    weights = torch.zeros(end - first, dtype=torch.float32,
                          device=loader.device)
    for lo, hi, w, v, d in loader.chunks():
        z = zetas[w]
        col = torch.where(torch.floor(v + 0.5) >= z, 0, -1).to(torch.int32)
        weights[lo - first:hi - first] = segsum_onehot(
            d - lo, col, z, hi - lo, 1, chunk=seg_chunk)[:hi - lo, 0]
    return weights


def _concat(parts: list, dtype: torch.dtype, device) -> torch.Tensor:
    return (torch.cat(parts) if parts
            else torch.zeros(0, dtype=dtype, device=device))


def streamed_build_b(corpus, zetas: torch.Tensor,
                     select_docs: Optional[torch.Tensor],
                     loader: Loader) -> Tuple[DocSparse, np.ndarray]:
    """Stage 3: B (thresholded, sqrt-ζ, docs renumbered, dual-sorted) put
    together on the device from streamed chunks of the loader's range;
    with `select_docs` (a (D,) bool mask over the whole corpus) only those
    docs. B's docs are the range's kept docs renumbered from 0. Over the
    whole corpus it equals bmatrix.threshold_and_copy. Returns (B,
    original_cols: the global ids of B's docs, host int32)."""
    V = corpus.vocab_size
    first, end = loader.doc_range
    dev = loader.device
    zetas = zetas.to(device=dev, dtype=torch.float32)
    sqz = torch.sqrt(zetas)
    parts_w, parts_d = [], []
    for _, _, w, v, d in loader.chunks():
        keep = torch.floor(v + 0.5) >= zetas[w]
        if select_docs is not None:
            keep &= select_docs[d]
        parts_w.append(w[keep])
        parts_d.append(d[keep] - first)
    dw = _concat(parts_w, torch.int32, dev)
    dd_range = _concat(parts_d, torch.int32, dev)
    del parts_w, parts_d
    occ = torch.zeros(end - first, dtype=torch.bool, device=dev)
    occ[dd_range] = True
    new_doc = (torch.cumsum(occ, 0) - 1).to(torch.int32)
    original_cols = (torch.nonzero(occ)[:, 0].to(torch.int32).cpu().numpy()
                     + np.int32(first))
    dd = new_doc[dd_range]
    del dd_range
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
                              loader: Loader) -> DocSparse:
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
                            loader: Loader,
                            seg_chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Stage 5: the catchword mass of the loader's docs, (docs of its
    range, k); row 0 is the range's first doc. A chunk's docs are rows
    [lo, hi) and no other chunk's, so segsum_onehot runs on the local doc
    ids d - lo and writes that block: no carry."""
    first, end = loader.doc_range
    mass = torch.zeros((end - first, num_topics), dtype=torch.float32,
                       device=loader.device)
    for lo, hi, w, v, d in loader.chunks():
        mass[lo - first:hi - first] = segsum_onehot(
            d - lo, cw_topic[w], v, hi - lo, num_topics,
            chunk=seg_chunk)[:hi - lo]
    return mass


def streamed_model_accumulation(corpus, W: torch.Tensor, loader: Loader,
                                seg_chunk: int = DEFAULT_CHUNK
                                ) -> torch.Tensor:
    """Stage 6: A W over the loader's docs, (V, k), from their rows W
    (docs of its range, k; row 0 is the range's first doc). Each chunk is
    sorted by word and added to the running model by segsum_gather_rows
    (its `init`), which gathers from the chunk's own rows of W by local
    doc id."""
    V = corpus.vocab_size
    first = loader.doc_range[0]
    model = torch.zeros((V + 1, W.shape[1]), dtype=torch.float32,
                        device=loader.device)
    for lo, hi, w, v, d in loader.chunks():
        ws, ds, vs = _sort_by_word(w, d - lo, v)
        model = segsum_gather_rows(
            ws, ds, vs, W[lo - first:hi - first], V, init=model,
            chunk=word_slice_len(ws.numel(), V, seg_chunk))
    return model[:V]


def streamed_topic_model(
    corpus,
    cw_topic: torch.Tensor,  # (vocab,) int32 owning topic, -1 else
    cluster_of_doc: torch.Tensor,  # (num_docs,) int32, -1 = dropped doc
    num_topics: int,
    rank_threshold: int,
    want_top_pairs: bool,
    loader: Loader,
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
    results). With a mesh (Trainer's `mesh`, or GpuConfig.mesh_shape on
    an initialised process group) every rank streams its own doc range
    (streaming_sharded.py)."""

    def __init__(self, config, output_dir: str = ".", quiet: bool = True,
                 chunk_entries: int = DEFAULT_CHUNK_ENTRIES, **trainer_kw):
        self._t = Trainer(config, output_dir=output_dir, quiet=quiet,
                          **trainer_kw)
        self.chunk_entries = chunk_entries
        self.loader: Optional[Loader] = None
        # output_doc_topic's mass comes from chunks too: a corpus that
        # needed this trainer does not fit the card for its report either
        self._t._doc_topic_mass = self._streamed_doc_topic_mass

    def __getattr__(self, name):
        return getattr(self._t, name)

    def _chunk_loader(self, doc_range: Optional[Tuple[int, int]] = None,
                      resident_bytes: Optional[int] = None) -> Loader:
        """One loader (and one set of buffers or slabs) for every pass of
        this trainer over its corpus's docs `doc_range` (all of them by
        default): get_corpus_loader's choice under `resident_bytes`,
        GpuConfig.resident_corpus_bytes by default."""
        t = self._t
        want = (0, t.corpus.num_docs) if doc_range is None else doc_range
        budget = (t.gpu.resident_corpus_bytes if resident_bytes is None
                  else resident_bytes)
        if (self.loader is None or self.loader.corpus is not t.corpus
                or self.loader.doc_range != tuple(want)
                or (isinstance(self.loader, ResidentLoader) and not budget)):
            self.loader = None  # its buffers go before the next's
            self.loader = get_corpus_loader(t.corpus, self.chunk_entries,
                                            t.device, budget, want)
        return self.loader

    def _streamed_doc_topic_mass(self, cw_topic: torch.Tensor
                                 ) -> torch.Tensor:
        """The whole corpus's mass, through a loader over every doc: the
        training loader on one device, and under a mesh rank 0's report,
        with no collective, over the wire (a pass read once holds no
        second copy of the corpus)."""
        t = self._t
        loader = self._chunk_loader(
            resident_bytes=None if t.mesh is None else 0)
        return streamed_doc_topic_mass(
            t.corpus, cw_topic, t.config.num_topics, loader, t.gpu.seg_chunk)

    def train(self, resume: bool = False) -> None:
        """Run the streamed pipeline; with resume=True, completed stages
        restore from the run directory's checkpoints (Trainer's files).
        GpuConfig.profile_dir traces the run as it does Trainer.train."""
        t = self._t
        if t.corpus is None:
            raise RuntimeError("load data first")
        check_supported(t.config)
        require_mesh(t.gpu, t.mesh)
        if t.mesh is None:
            t.run_traced(lambda: self._train_inner(resume))
        else:
            from .streaming_sharded import train_sharded_streamed

            t.run_traced(lambda: train_sharded_streamed(self, resume))

    def _train_inner(self, resume: bool) -> None:
        t = self._t
        cfg = t.config
        hp = cfg.hyper
        k = cfg.num_topics
        corpus = t.corpus
        D = corpus.num_docs
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

        centers_full, assign = planned_middle(
            t, loader, B.nnz,
            lambda head, state: self._middle(B, zetas, original_cols, ck,
                                             head, state))
        t.centers = centers_full.cpu().numpy()
        t._mark("k-means")

        cluster_of_doc = np.full(D, -1, np.int32)
        cluster_of_doc[original_cols] = assign.cpu().numpy().astype(np.int32)
        t.cluster_of_doc = cluster_of_doc
        t._checkpoint("kmeans", centers=t.centers,
                      cluster_of_doc=cluster_of_doc)
        # B and the centers leave the device before the (D, k) working set
        # of the last stages arrives
        del B, centers_full, assign
        self._finish(cluster_of_doc, loader)

    def _middle(self, B: DocSparse, zetas: torch.Tensor,
                original_cols: np.ndarray, ck: dict, head_bytes: int,
                state: dict):
        """B's layout, the eigenpairs and k-means: returns (centers_full,
        assign). The hybrid layout takes isle_tpu's streamed head rule
        (isle_tpu/streaming.py:1259-1277) under `head_bytes`, capped at
        max_head_rows unless GpuConfig.break_head_cap is set: at least 8
        head rows, or B stays COO, its B Y over doc tiles (sparse.b_y) as
        the hybrid tail's. The eigenpairs come from the svd checkpoint in
        `ck`, else from `state` (an earlier attempt of this middle), else
        from the solver, and are then checkpointed and kept in `state`."""
        t = self._t
        cfg = t.config
        hp = cfg.hyper
        k, V = cfg.num_topics, t.corpus.vocab_size
        chunk = t.gpu.seg_chunk
        num_head = min(V, head_bytes // max(2 * B.num_docs, 1))
        if not t.gpu.break_head_cap:
            num_head = min(num_head, max_head_rows(B.num_docs))
        if head_bytes > 0 and num_head >= 8:
            Bh = to_hybrid(B, num_head, row_scale_from_zetas(zetas),
                           break_head_cap=t.gpu.break_head_cap)
        else:
            Bh = with_doc_tiles(B)
        if head_bytes > 0:
            t._mark("hybrid layout")

        if "svd" in ck:
            t.evalues = ck["svd"]["evalues"]
            U = torch.from_numpy(ck["svd"]["U"]).to(t.device)
            t.logger.info("resumed eigenvectors from 'svd' checkpoint")
        elif "U" in state:
            t.evalues, U = state["evalues"], state["U"]
            t.logger.info("reusing the eigenvectors of the attempt that ran "
                          "out of device memory")
        else:
            t.evalues, U, stats = solve_gram_eigens(
                Bh, V, k, cfg, t.draws, chunk, timer=t.timer,
                logger=t.logger, start_block=t._warm_start_block(V),
                device_loop=t.gpu.device_loop_solver,
            )
            if stats is not None:
                t.op_counter.add(stats.op_calls)
            t._mark("eigen solve (B B^T)")
            t._checkpoint("svd", U=U.cpu().numpy(), evalues=t.evalues,
                          zetas=zetas.cpu().numpy(),
                          original_cols=original_cols)
            state["evalues"], state["U"] = t.evalues, U

        # seeding and Lloyd's on the projected docs, then the full space
        # (as isle_tpu's streamed trainer: always through the projection)
        if not hp.enable_kmeans_on_lowd:
            t.logger.warning(
                "the streamed trainer always runs k-means on the projected "
                "docs first: enable_kmeans_on_lowd=False is ignored")
        P = mat_bt_x(Bh, U, chunk).T
        _, centers_lowd, _ = kmeans_init_on_projected(
            P, k, hp.kmeans_init_reps, t.draws,
            method=hp.kmeans_init_method,
            mcmc_sample_size=hp.kmeansmcmc_sample_size,
        )
        centers_lowd, _ = run_lloyds_projected(
            P, centers_lowd, hp.max_kmeans_lowd_reps)
        del P
        full_kmeans = (run_elkans if hp.kmeans_algo_for_sparse == "elkans"
                       else run_lloyds_full)
        return full_kmeans(Bh, centers_lowd @ U.T, hp.max_kmeans_reps,
                           timer=t.timer, chunk=chunk)

    def _finish(self, cluster_of_doc: np.ndarray,
                loader: Loader) -> None:
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
