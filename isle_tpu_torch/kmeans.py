"""k-means: D^2 (k-means++) seeding on the projected docs and Lloyd's
iterations on the projected and full vocab spaces. The port of the main
path of isle_tpu/kmeans.py (kmeans_init_on_projected for "kmeanspp",
_kmeanspp_loop, run_lloyds_projected, run_lloyds_full).

Reference semantics (src/sparseMatrix.cpp:2133-2209, 1586-1746): the first
center is uniform; each round draws up to ceil(1 + sqrt(max(s-5, 0)))
candidates from the D^2 distribution without refreshing min-dist between
draws, rejects duplicates, and refreshes min-dist once against the
previous round's batch; distances clamp at zero. Lloyd's assigns by
first-index argmin, a center is its cluster's mean (zero when empty), and
iteration stops when memberships repeat (that rep still updates centers)
or after max_reps.

The k-means++ rounds run as a host loop: per round one device pass for
min-dist and its cumulative sum, a searchsorted of the round's dice, and a
sequential accept loop over the (at most ~12) candidates on the host.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .sparse import DEFAULT_CHUNK, DocSparse, b_y, bt_x, doc_l2sq


def kmeanspp_on_projected(P: torch.Tensor, k: int, draws
                          ) -> Tuple[torch.Tensor, float]:
    """P: (kdim, D) projected docs. Returns (center doc ids int64 (k,) on
    P's device, residual)."""
    kdim, D = P.shape
    dev = P.device
    nb_max = 1 + int(math.ceil(math.sqrt(max(k - 5, 1)))) + 1
    docs_l2 = torch.sum(P * P, dim=0)
    first = draws.kmeanspp_first(D)
    min_dist = torch.full((D,), torch.finfo(torch.float32).max,
                          dtype=torch.float32, device=dev)
    chosen = np.zeros(D, bool)
    chosen[first] = True
    centers = [first]
    fresh = [first]  # centers added in the previous round (refresh set)
    while len(centers) < k:
        if fresh:
            C = P[:, torch.tensor(fresh, device=dev)]
            dists = (docs_l2[:, None] + torch.sum(C * C, dim=0)[None, :]
                     - 2.0 * (P.T @ C))
            min_dist = torch.minimum(
                min_dist, torch.clamp(dists, min=0.0).amin(dim=1))
        cumul = torch.cumsum(min_dist, 0)
        total = cumul[-1]
        if float(total) <= 0.0:
            # Every distinct doc is already a center (duplicate-doc
            # corpora): fill the remaining slots by cycling from the first
            # center, as isle_tpu does, instead of drawing forever.
            centers += [(centers[0] + s) % D for s in range(len(centers), k)]
            break
        nb = int(math.ceil(1.0 + math.sqrt(max(len(centers) - 5, 0))))
        dice = draws.kmeanspp_dice(nb_max).to(dev) * total
        cand = torch.clamp(torch.searchsorted(cumul, dice, right=True),
                           max=D - 1).cpu().numpy()
        fresh = []
        for i in range(min(nb, nb_max)):
            c = int(cand[i])
            if len(centers) < k and not chosen[c]:
                chosen[c] = True
                centers.append(c)
                fresh.append(c)
    # Residual as the reference reports it: cumulative min-dist through the
    # second-to-last doc (src/sparseMatrix.cpp:2207 reads dist_cumul[D-1]).
    residual = float(torch.cumsum(min_dist, 0)[-2]) if D > 1 else 0.0
    return torch.tensor(centers, dtype=torch.int64, device=dev), residual


def kmeans_init_on_projected(P: torch.Tensor, k: int, reps: int, draws,
                             method: str = "kmeanspp"):
    """Best-of-`reps` k-means++ seeding. Returns (seed doc ids, centers
    (k, kdim), residual)."""
    if method != "kmeanspp":
        raise NotImplementedError(
            f"kmeans_init_method={method!r} is not ported yet (kmeanspp only)"
        )
    best = None
    for _ in range(reps):
        idx, residual = kmeanspp_on_projected(P, k, draws)
        if best is None or residual < best[2]:
            best = (idx, P[:, idx].T, residual)
    return best


def _assign(dots: torch.Tensor, docs_l2: torch.Tensor,
            centers: torch.Tensor) -> torch.Tensor:
    """First-index argmin_c ||x_d||^2 + ||c||^2 - 2 x_d.c (FPimin)."""
    c_l2 = torch.sum(centers * centers, dim=1)
    dists = docs_l2[:, None] + c_l2[None, :] - 2.0 * dots
    return torch.argmin(dists, dim=1)


def _means(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """sums (k, dim) / counts (k,), a zero row for an empty cluster."""
    return torch.where(counts[:, None] > 0,
                       sums / torch.clamp(counts, min=1.0)[:, None], 0.0)


def run_lloyds_projected(P: torch.Tensor, centers: torch.Tensor,
                         max_reps: int, timer=None):
    """Lloyd's on the projected docs P (kdim, D) from centers (k, kdim).
    Returns (centers, assignment)."""
    k = centers.shape[0]
    D = P.shape[1]
    docs_l2 = torch.sum(P * P, dim=0)
    ones = torch.ones(D, dtype=torch.float32, device=P.device)
    assign = torch.full((D,), -1, dtype=torch.int64, device=P.device)
    reps = 0
    for reps in range(1, max_reps + 1):
        prev, assign = assign, _assign(P.T @ centers.T, docs_l2, centers)
        sums = torch.zeros((k, P.shape[0]), dtype=torch.float32,
                           device=P.device).index_add_(0, assign, P.T)
        counts = torch.zeros(k, dtype=torch.float32,
                             device=P.device).index_add_(0, assign, ones)
        centers = _means(sums, counts)
        if torch.equal(assign, prev):
            break
    if timer is not None:
        timer.diag(f"projected lloyds ran {reps} reps (max {max_reps})")
    return centers, assign


def run_lloyds_full(sp: DocSparse, centers: torch.Tensor, max_reps: int,
                    timer=None, chunk: int = DEFAULT_CHUNK):
    """Lloyd's on B in the full vocab space from centers (k, vocab).
    Returns (centers, assignment int64 (num_docs,))."""
    k = centers.shape[0]
    docs_l2 = doc_l2sq(sp)
    assign = torch.full((sp.num_docs,), -1, dtype=torch.int64,
                        device=sp.device)
    reps = 0
    for reps in range(1, max_reps + 1):
        prev, assign = assign, _assign(
            bt_x(sp, centers.T.contiguous(), chunk), docs_l2, centers)
        onehot = torch.nn.functional.one_hot(assign, k).to(torch.float32)
        sums = b_y(sp, onehot, chunk)  # (vocab, k)
        centers = _means(sums.T, onehot.sum(dim=0))
        if torch.equal(assign, prev):
            break
    if timer is not None:
        timer.diag(f"full lloyds ran {reps} reps (max {max_reps})")
    return centers, assign
