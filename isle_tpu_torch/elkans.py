"""Elkan's triangle-inequality k-means on B in the full vocab space: the
port of isle_tpu/elkans.py (run_elkans; reference src/sparseMatrix.cpp:
2242-2492, selected by kmeans_algo_for_sparse="elkans").

Each doc keeps an upper bound ub on its distance to its own center and
lower bounds lb to every center. Per rep the centers move, the bounds
shift by the movement, and only the docs the doc-level filter flags
(ub > s[own] and ub > min over other centers of lb, a conservative union
of the paper's per-center conditions) get exact distances: their entries
are gathered out of the doc-sorted stream into a mini stream of exactly
their size, and one SpMM runs over it. isle_tpu rounds that subset up to
power-of-two buckets to bound XLA recompiles; here it keeps its size.

Ties caveat: a pruned doc keeps its assignment when d(i, own) <= d(i, c);
on an exact tie Lloyd's first-index argmin could pick a lower-indexed
center instead, so tie-breaking (and only tie-breaking) may differ from
Lloyd's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .hybrid import HybridSparse, head_bt_x
from .kmeans import update_centers_full
from .matops import mat_bt_x, mat_doc_l2sq
from .segsum import DEFAULT_CHUNK, segsum_gather_rows


def _dists(dots: torch.Tensor, docs_l2: torch.Tensor,
           centers: torch.Tensor) -> torch.Tensor:
    c_l2 = torch.sum(centers * centers, dim=1)
    d2 = docs_l2[:, None] + c_l2[None, :] - 2.0 * dots
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _flagged_dists(sp, flagged: torch.Tensor, centers: torch.Tensor,
                   docs_l2: torch.Tensor, chunk: int):
    """Exact distances of the flagged docs only. Returns (ids (m,) doc
    ids, dist (m, k)). In the hybrid layout the mini stream is cut from
    the tail, and the flagged docs' head columns add one head product
    (isle_tpu/elkans.py:150-158)."""
    hybrid = isinstance(sp, HybridSparse)
    st = sp.tail if hybrid else sp
    ids = torch.nonzero(flagged)[:, 0]
    rank = torch.cumsum(flagged.to(torch.int64), 0) - 1
    ent = flagged[st.d_doc]
    # non-decreasing: the stream is doc-sorted
    seg = rank[st.d_doc[ent]].to(torch.int32)
    m = ids.numel()
    X = centers.T.contiguous()
    dots = segsum_gather_rows(seg, st.d_word[ent], st.d_val[ent], X, m,
                              chunk=chunk)[:m]
    if hybrid:
        dots = dots + head_bt_x(sp, X, cols=ids)
    return ids, _dists(dots, docs_l2[ids], centers)


def _half_center_dists(centers: torch.Tensor) -> torch.Tensor:
    """s[c] = half the distance from center c to its nearest other."""
    k = centers.shape[0]
    c_l2 = torch.sum(centers * centers, dim=1)
    cc = torch.sqrt(torch.clamp(
        c_l2[:, None] + c_l2[None, :] - 2.0 * (centers @ centers.T), min=0.0))
    cc = cc + torch.diag(torch.full((k,), float("inf"), device=cc.device))
    return 0.5 * cc.amin(dim=1)


def run_elkans(sp, centers: torch.Tensor, max_reps: int,
               timer=None, chunk: int = DEFAULT_CHUNK,
               update_centers=update_centers_full, unchanged=torch.equal
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elkan's on B in either layout (matops). Returns (centers (k,
    vocab), assignment int64 (num_docs,)). The
    same fixpoint as Lloyd's up to exact-tie ordering (module
    docstring); stops when a rep reproduces the previous rep's
    assignment. `update_centers` and `unchanged` are the hooks of
    kmeans.run_lloyds_full, where elkans_sharded meets the other ranks;
    the bounds, the filter and the exact distances of the flagged docs
    stay with the rank that holds the docs."""
    k = centers.shape[0]
    D = sp.num_docs
    docs_l2 = mat_doc_l2sq(sp, chunk)
    dist = _dists(mat_bt_x(sp, centers.T.contiguous(), chunk), docs_l2,
                  centers)
    assign = torch.argmin(dist, dim=1)
    ub = dist.amin(dim=1)
    lb = dist
    prev = None
    for rep in range(max_reps):
        centers_new = update_centers(sp, assign, k, chunk)
        move = torch.linalg.norm(centers_new - centers, dim=1)  # (k,)
        centers = centers_new
        s = _half_center_dists(centers)
        # shift the bounds by the movement; the doc-level filter
        ub = ub + move[assign]
        lb = torch.clamp(lb - move[None, :], min=0.0)
        others_lb = lb.scatter(1, assign[:, None], float("inf")).amin(dim=1)
        flagged = (ub > s[assign]) & (ub > others_lb)
        n_docs = int(flagged.sum())
        if timer is not None:
            timer.diag(f"elkans rep {rep}: {n_docs}/{D} docs flagged")
        assign_next = assign
        if n_docs > 0:
            ids, dmini = _flagged_dists(sp, flagged, centers, docs_l2, chunk)
            assign_next = assign.clone()
            assign_next[ids] = torch.argmin(dmini, dim=1)
            ub[ids] = dmini.amin(dim=1)  # ub and lb are fresh tensors
            lb[ids] = dmini
        if prev is not None and unchanged(assign_next, prev):
            assign = assign_next
            if timer is not None:
                timer.diag(f"elkans converged at rep {rep}")
            break
        prev = assign_next
        assign = assign_next
    return update_centers(sp, assign, k, chunk), assign
