"""Training and inference over several GPUs: the port of
isle_tpu/sharding.py to torch.distributed.

isle_tpu shards under one controller: jax.shard_map over a device mesh,
every shard padded to a common length. PyTorch's model is one process a
card, so here every rank runs the same program (SPMD) and a `Mesh` is this
rank's view of the others: its rank, the world size, the process group
(NCCL for CUDA tensors, gloo for CPU tensors) and its device. A Mesh with
no group is a world of one whose collectives are the identity, so one code
path serves 1 and N ranks.

The layout follows the reference (SURVEY.md §5.7-5.8):

  - the DOCUMENT axis is sharded: rank s owns docs [s*dps, (s+1)*dps),
    dps = ceil(D / S), as an ordinary sparse.DocSparse under LOCAL doc ids
    in both sort orders, unpadded. Every local product is therefore the
    existing sparse.bt_x / sparse.b_y / segsum call and launches the same
    two kernels on the card;
  - B^T X keeps X replicated and gives this rank's doc rows with no
    communication; B Y and (B B^T) X end in one all-reduce of (V, W);
  - k-means assignments stay local; the center sums and counts are
    all-reduced, and Lloyd's stops from an all-reduced count of changed
    assignments, the same on every rank;
  - ζ thresholds and the r-th highest catchword statistic run on a second,
    WORD-sharded copy (nnz-balanced contiguous word ranges, local word
    ids, global doc ids): a rank selection over a word's entries cannot be
    all-reduced from doc shards. ζ runs there too, as in the reference
    (the alternative, an all-reduce of every rank's (V, F+1) int32
    histogram, moves 261 MB at the NYTimes shape; both are exact). The
    per-word results are assembled by an all-gather of ragged pieces;
  - k- and vocab-sized state (U, centers, the model, the projected docs
    and the (D, k) catchword mass) is replicated;
  - the hybrid layout (ShardedHybrid, isle_tpu/sharding.py:952-1186):
    the head words are chosen once from the all-reduced word counts, so
    every rank splits its docs by the same words; each rank holds its
    (R, local docs) head slab and its local tail, and the products above
    run on them through matops.

Every branch that decides whether a collective is reached is taken from a
value that is the same on every rank. Integer results equal the
single-device path's exactly; float sums that pass through an all-reduce
agree to rounding, since the ranks' partials are added in another order.

The reference pads shards because shard_map needs uniform shapes
(sharding.py:173-189) and compacts doc rows through a flat index
(_doc_flat_index, :570); ragged shards need neither here: compact_doc_rows
is an all-gather of ragged pieces and pad_doc_rows a slice. The one
place where the reference's padded slots change a result is
`sharded_train_step` (:503-567), whose k-means counts include them: each
layout keeps the reference's slot count, `docs_per_shard`, for it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import bmatrix
from .catchwords import rth_highest
from .hybrid import max_head_rows, split_by_head, top_words, word_counts
from .kmeans import _means, lloyds_iter_full, run_lloyds_full
from .matops import mat_b_y, mat_bt_x, mat_doc_l2sq
from .segsum import DEFAULT_CHUNK, segsum_onehot
from .sparse import DocSparse, doc_l2sq
from .thresholds import compute_thresholds
from .topic_model import doc_topic_mass

# A collective that a lost rank never joins ends in an error after this
# long, on every rank that waits in it.
GROUP_TIMEOUT = datetime.timedelta(minutes=30)


class Mesh:
    """This rank's view of the ranks that train together. `group` None is
    a world of one with no process group: every collective returns its
    argument. Collectives count their calls and their time
    (`collective_seconds()`: host clock on the CPU, CUDA events on the
    card, read at the end so that no run waits for its own clock)."""

    def __init__(self, device, group=None, rank: int = 0, world: int = 1):
        self.device = torch.device(device)
        self.group = group
        self.rank = rank
        self.world = world
        self.collective_calls = 0
        self._seconds = 0.0
        self._events: List[tuple] = []

    @classmethod
    def from_process_group(cls, device, group=None) -> "Mesh":
        """The mesh of an initialised torch.distributed: the default
        group, or `group`."""
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "training over several devices needs an initialised "
                "torch.distributed process group (start the run under "
                "torchrun, or call torch.distributed.init_process_group)")
        group = group if group is not None else dist.group.WORLD
        return cls(device, group, dist.get_rank(group),
                   dist.get_world_size(group))

    @contextlib.contextmanager
    def _timed(self):
        self.collective_calls += 1
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._seconds += time.perf_counter() - t0

    def collective_seconds(self) -> float:
        """Seconds spent inside collectives so far."""
        for start, end in self._events:
            end.synchronize()
            self._seconds += start.elapsed_time(end) / 1e3
        self._events.clear()
        return self._seconds

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the ranks, in place; returns `t`."""
        if self.group is not None:
            with self._timed():
                dist.all_reduce(t, group=self.group)
        return t

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise largest of `t` over the ranks, in place; returns
        `t`."""
        if self.group is not None:
            with self._timed():
                dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`t` as rank `src` holds it, in place; returns `t`. `src` counts
        within this mesh's group."""
        if self.group is not None:
            with self._timed():
                if t.dtype == torch.bool:  # NCCL moves no bool
                    u = t.to(torch.uint8)
                    dist.broadcast(u, dist.get_global_rank(self.group, src),
                                   group=self.group)
                    t.copy_(u.to(torch.bool))
                else:
                    dist.broadcast(t, dist.get_global_rank(self.group, src),
                                   group=self.group)
        return t

    def broadcast_object(self, obj, src: int = 0):
        """A picklable host object as rank `src` holds it."""
        if self.group is None:
            return obj
        box = [obj]
        with self._timed():
            dist.broadcast_object_list(
                box, dist.get_global_rank(self.group, src), group=self.group,
                device=self.device)
        return box[0]

    def row_counts(self, n: int) -> Tuple[int, ...]:
        """The `n` of every rank, in rank order."""
        if self.group is None:
            return (int(n),)
        mine = torch.tensor([n], dtype=torch.int64, device=self.device)
        out = [torch.empty_like(mine) for _ in range(self.world)]
        with self._timed():
            dist.all_gather(out, mine, group=self.group)
        return tuple(int(x) for x in torch.cat(out).tolist())

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors joined along dim 0 in rank order. The pieces
        may differ in length (a rank may hold none): the lengths go round
        first and every piece is padded to the longest."""
        if self.group is None:
            return t
        counts = self.row_counts(t.shape[0])
        pad = t.new_zeros((max(counts),) + tuple(t.shape[1:]))
        pad[: t.shape[0]] = t
        out = [torch.empty_like(pad) for _ in range(self.world)]
        with self._timed():
            dist.all_gather(out, pad, group=self.group)
        return torch.cat([o[:c] for o, c in zip(out, counts)])

    def all_to_all_rows(self, t: torch.Tensor,
                        send_counts: List[int]) -> torch.Tensor:
        """Rows [sum(send_counts[:j]), sum(send_counts[:j + 1])) of `t` go
        to rank j; returns the rows every rank sent here, joined in rank
        order. The splits may be ragged (a rank may send or receive none):
        the counts go round first."""
        if self.group is None:
            return t
        send = torch.tensor(send_counts, dtype=torch.int64,
                            device=self.device)
        recv = torch.empty_like(send)
        with self._timed():
            dist.all_to_all_single(recv, send, group=self.group)
        recv_counts = recv.tolist()
        out = t.new_empty((sum(recv_counts),) + tuple(t.shape[1:]))
        with self._timed():
            dist.all_to_all_single(
                out, t.contiguous(), output_split_sizes=recv_counts,
                input_split_sizes=[int(c) for c in send_counts],
                group=self.group)
        return out

    def all_equal(self, a: torch.Tensor, b: torch.Tensor) -> bool:
        """Whether a == b on every rank: the same answer on every rank."""
        differ = torch.tensor([0 if torch.equal(a, b) else 1],
                              dtype=torch.int32, device=self.device)
        return int(self.all_reduce(differ)) == 0

    def row_slice(self, n: int) -> slice:
        """This rank's contiguous share of n rows, ceil(n / world) each."""
        per = -(-n // self.world)
        return slice(min(self.rank * per, n), min((self.rank + 1) * per, n))


def default_mesh(gpu, device) -> Optional[Mesh]:
    """The mesh a GpuConfig asks for when its caller named none: that of
    the initialised torch.distributed if mesh_shape holds more than one
    device, else None (a single device). Before the process group exists
    it is None as well: require_mesh then refuses the run."""
    if gpu.mesh_devices() <= 1 or not (dist.is_available()
                                       and dist.is_initialized()):
        return None
    return Mesh.from_process_group(device)


def require_mesh(gpu, mesh: Optional[Mesh]) -> None:
    """Raise unless `mesh` has the ranks GpuConfig.mesh_shape asks for."""
    want = gpu.mesh_devices()
    if want <= 1:
        return
    if mesh is None:
        raise RuntimeError(
            f"mesh_shape={gpu.mesh_shape} needs an initialised "
            "torch.distributed process group before the trainer is made "
            "(start the run under torchrun, or call "
            "torch.distributed.init_process_group)")
    if mesh.world != want:
        raise RuntimeError(
            f"mesh_shape={gpu.mesh_shape} asks for {want} devices, the "
            f"process group has {mesh.world} ranks")


def mesh_from_env(device: str, init_method: Optional[str] = None
                  ) -> Tuple[str, Optional[Mesh]]:
    """The launch under torchrun: with WORLD_SIZE > 1 in the environment,
    initialise the process group as rank RANK (NCCL for a CUDA device,
    gloo for the CPU), bind this rank to cuda:LOCAL_RANK and return
    (device, Mesh). The rendezvous is torchrun's (env://), or
    `init_method` (a torch.distributed URL, e.g. file://PATH) for ranks
    that a program starts itself. Started alone: (device, None) and
    nothing else happens."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return device, None
    on_card = torch.device(device).type == "cuda"
    if on_card:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if on_card else "gloo", init_method=init_method,
            rank=int(os.environ["RANK"]), world_size=world,
            timeout=GROUP_TIMEOUT)
    return device, Mesh.from_process_group(device)


# ---------------------------------------------------------------------------
# The two shardings of a matrix
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedDocSparse:
    """This rank's contiguous doc range of a (vocab x num_docs) matrix:
    `local` holds its entries under LOCAL doc ids 0..local.num_docs, in
    both sort orders; `doc_counts[s]` docs live on rank s, so local doc j
    is doc `doc_start + j` of the whole matrix. `docs_per_shard` is the
    doc slots of a shard in isle_tpu's padded layout of the same matrix
    (docs and empty pads): ceil(num_docs / S) for a corpus's shards, the
    largest rank's count rounded up to 8 for a thresholded B."""

    local: DocSparse
    doc_counts: Tuple[int, ...]
    doc_start: int
    nnz: int  # entries on all ranks
    docs_per_shard: int

    @property
    def vocab(self) -> int:
        return self.local.vocab

    @property
    def num_docs(self) -> int:
        return sum(self.doc_counts)

    @property
    def device(self) -> torch.device:
        return self.local.device


def doc_starts(num_docs: int, shards: int) -> np.ndarray:
    """(shards + 1,) first docs of the contiguous doc ranges, dps =
    ceil(num_docs / shards) each (the last ranges may be short or
    empty)."""
    dps = -(-int(num_docs) // shards)
    return np.minimum(np.arange(shards + 1) * dps, int(num_docs))


def doc_range(num_docs: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's docs [lo, hi) of a matrix of num_docs docs."""
    starts = doc_starts(num_docs, mesh.world)
    return int(starts[mesh.rank]), int(starts[mesh.rank + 1])


def shard_doc_sparse(words, docs, vals, vocab: int, num_docs: int,
                     mesh: Mesh) -> ShardedDocSparse:
    """Cut this rank's doc range out of host COO arrays sorted by (doc,
    word) and put it on the mesh's device."""
    lo, hi = doc_range(num_docs, mesh)
    docs = np.asarray(docs)
    e_lo, e_hi = np.searchsorted(docs, [lo, hi])
    local = DocSparse.from_doc_sorted(
        np.asarray(words)[e_lo:e_hi], docs[e_lo:e_hi] - lo,
        np.asarray(vals)[e_lo:e_hi], vocab, hi - lo, mesh.device)
    counts = np.diff(doc_starts(num_docs, mesh.world))
    return ShardedDocSparse(
        local=local, doc_counts=tuple(int(x) for x in counts),
        doc_start=lo, nnz=len(docs),
        docs_per_shard=-(-int(num_docs) // mesh.world))


@dataclasses.dataclass(frozen=True)
class ShardedHybrid(ShardedDocSparse):
    """This rank's doc range of B in the hybrid layout: `local` is a
    hybrid.HybridSparse whose head words are the same on every rank."""

    @property
    def num_head(self) -> int:
        return self.local.num_head


def shard_hybrid(ssp: ShardedDocSparse, row_scale: torch.Tensor, mesh: Mesh,
                 head_budget_bytes: int,
                 flat_cap: Optional[int] = None) -> ShardedHybrid:
    """The hybrid layout of a sharded B (isle_tpu/sharding.py:998-1100):
    one all-reduce of the (vocab,) word counts, the same head words on
    every rank, each rank's own head slab and tail. The head size is
    isle_tpu's: min(vocab, max(8, budget // (2 dps S)), max_head_rows(dps))
    with dps its padded docs per shard (`docs_per_shard`)."""
    V, S = ssp.vocab, mesh.world
    counts = mesh.all_reduce(word_counts(ssp.local))
    dps = ssp.docs_per_shard
    # capped whatever GpuConfig.break_head_cap says, as isle_tpu's
    # shard_hybrid is (isle_tpu/sharding.py:1023-1027): both packages
    # choose the same head words on a mesh
    num_head = int(min(V, max(8, head_budget_bytes // max(2 * dps * S, 1)),
                       max_head_rows(dps, flat_cap)))
    local = split_by_head(ssp.local, top_words(counts, num_head), row_scale)
    return ShardedHybrid(local=local, doc_counts=ssp.doc_counts,
                         doc_start=ssp.doc_start, nnz=ssp.nnz,
                         docs_per_shard=dps)


@dataclasses.dataclass(frozen=True)
class WordSharded:
    """This rank's contiguous word range [word_bounds[rank],
    word_bounds[rank + 1]) of a matrix, sorted by (word, doc): word ids
    LOCAL to the range, doc ids global. Its field names are those the
    word-sorted consumers read of a DocSparse (w_word, w_doc, w_val,
    vocab, device), with `vocab` the number of words of this range, so
    thresholds.compute_thresholds and catchwords.rth_highest take it as
    it is."""

    w_word: torch.Tensor
    w_doc: torch.Tensor
    w_val: torch.Tensor
    vocab: int  # words in this rank's range
    num_docs: int
    word_bounds: Tuple[int, ...]  # (S + 1,) over the whole vocabulary
    nnz: int  # entries on all ranks

    @property
    def device(self) -> torch.device:
        return self.w_word.device


def word_bounds(words: np.ndarray, vocab: int, shards: int) -> np.ndarray:
    """(shards + 1,) word ids that cut the vocabulary into contiguous
    ranges of about equal entry counts: the cuts of
    isle_tpu.sharding.shard_by_word (the word of the sorted stream's entry
    s * n / S, plus one), from a count per word instead of a sort."""
    return word_bounds_of_counts(np.bincount(words, minlength=vocab), shards)


def word_bounds_of_counts(counts: np.ndarray, shards: int) -> np.ndarray:
    """word_bounds from the (vocab,) entry count of every word, which the
    ranks of a mesh can sum without holding each other's entries."""
    counts = np.asarray(counts)
    vocab, n = len(counts), int(counts.sum())
    if shards == 1 or n == 0:
        return np.array([0] * shards + [vocab], np.int64)
    cum = np.cumsum(counts)
    targets = np.minimum((np.arange(1, shards) * n) // shards, n - 1)
    cuts = np.searchsorted(cum, targets, side="right") + 1
    bounds = np.concatenate([[0], cuts, [vocab]]).astype(np.int64)
    return np.minimum(np.maximum.accumulate(bounds), vocab)


def shard_by_word(words, docs, vals, vocab: int, num_docs: int,
                  mesh: Mesh) -> WordSharded:
    """Cut this rank's word range out of host COO arrays sorted by (doc,
    word); the stable sort by word on the device keeps each word's docs
    ascending."""
    words = np.asarray(words)
    bounds = word_bounds(words, vocab, mesh.world)
    lo, hi = int(bounds[mesh.rank]), int(bounds[mesh.rank + 1])
    # the whole vocabulary (a world of one): no copy through a mask
    mine = slice(None) if (lo, hi) == (0, vocab) else \
        (words >= lo) & (words < hi)
    dev = mesh.device
    w = torch.as_tensor(np.asarray(words[mine] - lo, np.int32)).to(dev)
    d = torch.as_tensor(np.asarray(np.asarray(docs)[mine], np.int32)).to(dev)
    v = torch.as_tensor(np.asarray(np.asarray(vals)[mine], np.float32)).to(dev)
    ws, perm = torch.sort(w, stable=True)
    return WordSharded(
        w_word=ws, w_doc=d[perm], w_val=v[perm], vocab=hi - lo,
        num_docs=int(num_docs), word_bounds=tuple(int(b) for b in bounds),
        nnz=len(words))


# ---------------------------------------------------------------------------
# Word-parallel stages
# ---------------------------------------------------------------------------


def sharded_thresholds(ws: WordSharded, avg_doc_sz: float, nz_docs: int,
                       num_topics: int, hyper, mesh: Mesh,
                       seg_chunk: int = DEFAULT_CHUNK
                       ) -> Tuple[torch.Tensor, int]:
    """ζ per word, each rank over its own words with no traffic but the
    assembly of the (vocab,) result. Returns (zetas float32 (vocab,) on
    the device, post-threshold nnz)."""
    zeta, nnz = compute_thresholds(ws, avg_doc_sz, nz_docs, num_topics,
                                   hyper, seg_chunk)
    total = mesh.all_reduce(
        torch.tensor([nnz], dtype=torch.int64, device=mesh.device))
    return mesh.all_gather_rows(zeta), int(total)


def sharded_rth_highest(ws: WordSharded, cluster_of_doc: torch.Tensor,
                        cluster_sizes: torch.Tensor, num_topics: int, r: int,
                        mesh: Mesh, seg_chunk: int = DEFAULT_CHUNK
                        ) -> torch.Tensor:
    """The r-th highest value per (cluster, word), each rank over its own
    words; `cluster_of_doc` (num_docs,) is global. Returns thresholds
    (num_topics, vocab) on every rank."""
    thr = rth_highest(ws, cluster_of_doc, cluster_sizes, num_topics, r,
                      seg_chunk)  # (k, this rank's words)
    return mesh.all_gather_rows(thr.T.contiguous()).T.contiguous()


# ---------------------------------------------------------------------------
# Doc-parallel products
# ---------------------------------------------------------------------------


def sharded_bt_x(ssp: ShardedDocSparse, X: torch.Tensor, mesh: Mesh,
                 chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """B^T X for this rank's docs, (local docs, width); X replicated. No
    communication. Either layout (a ShardedHybrid's local part is
    hybrid)."""
    return mat_bt_x(ssp.local, X, chunk)


def sharded_b_y(ssp: ShardedDocSparse, Y: torch.Tensor, mesh: Mesh,
                chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """B Y, (vocab, width) on every rank, from this rank's rows Y (local
    docs, width): the local product and one all-reduce."""
    return mesh.all_reduce(mat_b_y(ssp.local, Y, chunk))


def sharded_gram_x(ssp: ShardedDocSparse, X: torch.Tensor, mesh: Mesh,
                   chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """(B B^T) X with one all-reduce: the eigensolver's operator."""
    return sharded_b_y(ssp, sharded_bt_x(ssp, X, mesh, chunk), mesh, chunk)


def sharded_spmm_flops(ssp: ShardedDocSparse, width: int) -> int:
    """FLOPs of one sharded bt_x or b_y over all ranks (2 * nnz * width)."""
    return 2 * ssp.nnz * width


def compact_doc_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's doc rows (local docs, ...) -> every doc's rows in doc
    order, on every rank."""
    return mesh.all_gather_rows(x)


def pad_doc_rows(W: torch.Tensor, ssp: ShardedDocSparse) -> torch.Tensor:
    """The inverse of compact_doc_rows: this rank's rows of a tensor that
    holds a row for every doc of `ssp`."""
    return W[ssp.doc_start: ssp.doc_start + ssp.local.num_docs]


def sharded_doc_l2sq(ssp: ShardedDocSparse, mesh: Mesh,
                     chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Squared l2 norms of this rank's docs."""
    return mat_doc_l2sq(ssp.local, chunk)


def sharded_doc_topic_mass(ssp: ShardedDocSparse, cw_topic: torch.Tensor,
                           num_topics: int, mesh: Mesh,
                           seg_chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Catchword mass of this rank's docs, (local docs, num_topics)."""
    return doc_topic_mass(ssp.local, cw_topic, num_topics, seg_chunk)


# ---------------------------------------------------------------------------
# B construction
# ---------------------------------------------------------------------------


def sharded_threshold_and_copy(
    ssp: ShardedDocSparse, zetas: torch.Tensor, mesh: Mesh,
    sample_rate: Optional[float] = None,
    uniforms: Optional[torch.Tensor] = None,
    docs: Optional[np.ndarray] = None,
) -> Tuple[ShardedDocSparse, np.ndarray]:
    """bmatrix.threshold_and_copy on the mesh: each rank filters its docs
    and renumbers the ones left LOCALLY. Sampling needs the pivot over all
    docs (src/sparseMatrix.cpp:1383-1417): the weights are summed locally
    and gathered, the (num_docs,) dice and pivot come from the same
    `uniforms` everywhere, and rank 0's selection is the one every rank
    takes. `docs` (a checkpoint's original_cols) selects instead of
    sampling. Returns (B, original_cols): global doc ids, ascending, the
    single-device result (shards are contiguous doc ranges)."""
    A = ssp.local
    zetas = zetas.to(device=A.device, dtype=torch.float32)
    sel = None
    if docs is not None:
        sel = bmatrix.docs_mask(docs, ssp.num_docs, A.device)
    elif sample_rate is not None:
        keep_d = torch.floor(A.d_val + 0.5) >= zetas[A.d_word]
        weights = mesh.all_gather_rows(bmatrix.doc_weights(A, keep_d, zetas))
        sel = mesh.broadcast(
            bmatrix.dice_select(weights, sample_rate, uniforms))
    if sel is not None:
        sel = pad_doc_rows(sel, ssp)
    B, cols = bmatrix.copy_kept(A, zetas, sel)
    return join_doc_shards(B, cols + np.int32(ssp.doc_start), mesh)


def join_doc_shards(B: DocSparse, cols: np.ndarray, mesh: Mesh
                    ) -> Tuple[ShardedDocSparse, np.ndarray]:
    """This rank's B (its kept docs renumbered from 0; `cols` their global
    ids, ascending) as the rank's part of a ShardedDocSparse: the doc
    counts and the nnz of every rank go round. Returns (B, original_cols
    of all ranks, in doc order)."""
    counts = mesh.row_counts(B.num_docs)
    nnz = mesh.all_reduce(
        torch.tensor([B.nnz], dtype=torch.int64, device=B.device))
    out = ShardedDocSparse(
        local=B, doc_counts=counts, doc_start=sum(counts[: mesh.rank]),
        nnz=int(nnz), docs_per_shard=max(-(-max(counts) // 8) * 8, 8))
    cols = torch.from_numpy(np.asarray(cols, np.int32)).to(B.device)
    return out, mesh.all_gather_rows(cols).cpu().numpy()


# ---------------------------------------------------------------------------
# Full-space k-means
# ---------------------------------------------------------------------------


def sharded_update_centers(ssp: ShardedDocSparse, assign: torch.Tensor,
                           k: int, mesh: Mesh,
                           chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Cluster means (k, vocab) under this rank's `assign`ments and the
    other ranks': all-reduced sums and counts
    (src/sparseMatrix.cpp:1631-1646 on the mesh)."""
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(torch.float32)
    sums = sharded_b_y(ssp, onehot, mesh, chunk)  # (vocab, k)
    counts = mesh.all_reduce(onehot.sum(dim=0))
    return _means(sums.T, counts)


def mesh_hooks(ssp: ShardedDocSparse, mesh: Mesh) -> dict:
    """The two places where a full-space k-means over this rank's docs
    meets the other ranks (the hooks of kmeans.run_lloyds_full and
    elkans.run_elkans)."""
    return dict(
        update_centers=lambda sp, assign, k, chunk: sharded_update_centers(
            ssp, assign, k, mesh, chunk),
        unchanged=mesh.all_equal,
    )


def gather_assignment(assign: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """Every doc's cluster in doc order, as a host int32 array."""
    return mesh.all_gather_rows(assign.to(torch.int32)).cpu().numpy()


def sharded_run_lloyds_full(ssp: ShardedDocSparse, centers: torch.Tensor,
                            max_reps: int, mesh: Mesh, timer=None,
                            chunk: int = DEFAULT_CHUNK
                            ) -> Tuple[torch.Tensor, np.ndarray]:
    """Lloyd's on B (ShardedDocSparse or ShardedHybrid, isle_tpu's
    make_sharded_h_lloyds_step among them) in the full vocab space on the
    mesh: local distances and argmin, all-reduced center update, and a
    stop that every rank
    takes together. Returns (centers (k, vocab) on every rank, assign:
    host (num_docs,) int32 in B's doc order)."""
    centers, assign = run_lloyds_full(
        ssp.local, centers, max_reps, timer=timer, chunk=chunk,
        **mesh_hooks(ssp, mesh))
    return centers, gather_assignment(assign, mesh)


# ---------------------------------------------------------------------------
# The composite training step
# ---------------------------------------------------------------------------


def _coo_only(ssp: ShardedDocSparse) -> None:
    if isinstance(ssp, ShardedHybrid):
        raise TypeError(
            "sharded_train_step reads the COO streams of a ShardedDocSparse "
            "(isle_tpu's step has no hybrid form); pass the COO layout, "
            "not a ShardedHybrid")


def sharded_train_step(ssp: ShardedDocSparse, mesh: Mesh, num_topics: int):
    """One composite training step with every collective pattern of the
    pipeline (isle_tpu/sharding.py:503-567): the eigensolver operator, a
    k-means assignment local to each rank with an all-reduced center
    update, and an all-reduced word histogram. Returns
    step(ssp, X, centers) -> (Y, assign, new_centers, hist):

      Y            (vocab, W) = (B B^T) X on every rank, one all-reduce;
      assign       int32 (local docs,), first-index argmin of ||x||^2 +
                   ||c||^2 - 2 x.c over this rank's docs;
      new_centers  (k, vocab) on every rank: the all-reduced sums over the
                   all-reduced counts, 0 for an empty cluster;
      hist         float32 (vocab,): entries per word over all ranks.

    Four all-reduces a step; on the card four segsum_gather_rows and two
    segsum_onehot launches. The reference's step is jitted and cached by
    shape and mesh (_cached_step); this one runs eagerly and caches
    nothing.

    The counts are the reference's, pads included: isle_tpu gives every
    shard `docs_per_shard` doc slots, and a slot with no doc has norm 0
    and dots 0, so it is assigned to the center of least ||c||^2 and
    counted there, though it adds nothing to the sums. This port's shards
    hold no pads, so each rank adds its `docs_per_shard - local docs` to
    that cluster's count. The production Lloyd's (sharded_run_lloyds_full,
    isle_tpu's make_sharded_lloyds_step) counts real docs only. COO
    only: a ShardedHybrid raises TypeError."""
    _coo_only(ssp)
    k = num_topics

    def step(ssp: ShardedDocSparse, X: torch.Tensor, centers: torch.Tensor):
        _coo_only(ssp)
        local = ssp.local
        Y = sharded_gram_x(ssp, X, mesh)
        pads = ssp.docs_per_shard - local.num_docs

        def update_centers(sp, assign, k, chunk):
            onehot = torch.nn.functional.one_hot(assign, k).to(torch.float32)
            sums = sharded_b_y(ssp, onehot, mesh, chunk)  # (vocab, k)
            counts = onehot.sum(dim=0)
            if pads:
                counts[torch.argmin(torch.sum(centers * centers, dim=1))] += \
                    pads
            return _means(sums.T, mesh.all_reduce(counts))

        new_centers, assign = lloyds_iter_full(
            local, centers, doc_l2sq(local), k,
            update_centers=update_centers)
        hist = segsum_onehot(local.w_word, None, None, local.vocab,
                             1)[:local.vocab, 0]
        hist = mesh.all_reduce(hist).to(torch.float32)
        return Y, assign.to(torch.int32), new_centers, hist

    return step
