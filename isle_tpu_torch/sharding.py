"""Training and inference over several GPUs: the port of
isle_tpu/sharding.py (without its hybrid layout) to torch.distributed.

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
    and the (D, k) catchword mass) is replicated.

Every branch that decides whether a collective is reached is taken from a
value that is the same on every rank. Integer results equal the
single-device path's exactly; float sums that pass through an all-reduce
agree to rounding, since the ranks' partials are added in another order.

The reference pads shards because shard_map needs uniform shapes
(sharding.py:173-189) and compacts doc rows through a flat index
(_doc_flat_index, :570); ragged shards need neither here: compact_doc_rows
is an all-gather of ragged pieces and pad_doc_rows a slice.
`sharded_train_step` (:503-567) is the jitted entry that only
__graft_entry__.py drives; nothing in the port calls it, so it has no
counterpart (ROADMAP.md).
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
from .kmeans import _means, run_lloyds_full
from .segsum import DEFAULT_CHUNK
from .sparse import DocSparse, b_y, bt_x, doc_l2sq
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


def mesh_from_env(device: str) -> Tuple[str, Optional[Mesh]]:
    """The launch under torchrun: with WORLD_SIZE > 1 in the environment,
    initialise the process group (NCCL for a CUDA device, gloo for the
    CPU; the rendezvous torchrun set up), bind this rank to
    cuda:LOCAL_RANK and return (device, Mesh). Started alone: (device,
    None) and nothing else happens."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return device, None
    on_card = torch.device(device).type == "cuda"
    if on_card:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if on_card else "gloo",
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
    is doc `doc_start + j` of the whole matrix."""

    local: DocSparse
    doc_counts: Tuple[int, ...]
    doc_start: int
    nnz: int  # entries on all ranks

    @property
    def vocab(self) -> int:
        return self.local.vocab

    @property
    def num_docs(self) -> int:
        return sum(self.doc_counts)

    @property
    def device(self) -> torch.device:
        return self.local.device


def shard_doc_sparse(words, docs, vals, vocab: int, num_docs: int,
                     mesh: Mesh) -> ShardedDocSparse:
    """Cut this rank's doc range out of host COO arrays sorted by (doc,
    word) and put it on the mesh's device."""
    S, D = mesh.world, int(num_docs)
    dps = -(-D // S)
    starts = np.minimum(np.arange(S + 1) * dps, D)
    lo, hi = int(starts[mesh.rank]), int(starts[mesh.rank + 1])
    docs = np.asarray(docs)
    e_lo, e_hi = np.searchsorted(docs, [lo, hi])
    local = DocSparse.from_doc_sorted(
        np.asarray(words)[e_lo:e_hi], docs[e_lo:e_hi] - lo,
        np.asarray(vals)[e_lo:e_hi], vocab, hi - lo, mesh.device)
    return ShardedDocSparse(
        local=local, doc_counts=tuple(int(x) for x in np.diff(starts)),
        doc_start=lo, nnz=len(docs))


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
    n = len(words)
    if shards == 1 or n == 0:
        return np.array([0] * shards + [vocab], np.int64)
    cum = np.cumsum(np.bincount(words, minlength=vocab))
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
    communication."""
    return bt_x(ssp.local, X, chunk)


def sharded_b_y(ssp: ShardedDocSparse, Y: torch.Tensor, mesh: Mesh,
                chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """B Y, (vocab, width) on every rank, from this rank's rows Y (local
    docs, width): the local product and one all-reduce."""
    return mesh.all_reduce(b_y(ssp.local, Y, chunk))


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
    return doc_l2sq(ssp.local, chunk)


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
    cols = torch.from_numpy(cols + np.int32(ssp.doc_start)).to(A.device)
    counts = mesh.row_counts(B.num_docs)
    nnz = mesh.all_reduce(
        torch.tensor([B.nnz], dtype=torch.int64, device=A.device))
    out = ShardedDocSparse(
        local=B, doc_counts=counts, doc_start=sum(counts[: mesh.rank]),
        nnz=int(nnz))
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
    """Lloyd's on B in the full vocab space on the mesh: local distances
    and argmin, all-reduced center update, and a stop that every rank
    takes together. Returns (centers (k, vocab) on every rank, assign:
    host (num_docs,) int32 in B's doc order)."""
    centers, assign = run_lloyds_full(
        ssp.local, centers, max_reps, timer=timer, chunk=chunk,
        **mesh_hooks(ssp, mesh))
    return centers, gather_assignment(assign, mesh)
