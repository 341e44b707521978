"""k-means: seeding on the projected docs (k-means++, k-means|| and
AFK-MC^2) and Lloyd's iterations on the projected and full vocab spaces.
The port of isle_tpu/kmeans.py (kmeans_init_on_projected and the three
seedings, run_lloyds_projected, run_lloyds_full and its iteration
lloyds_iter_full).

Reference semantics (src/sparseMatrix.cpp:2133-2209, 1586-1746): the first
center is uniform; each round draws up to ceil(1 + sqrt(max(s-5, 0)))
candidates from the D^2 distribution without refreshing min-dist between
draws, rejects duplicates, and refreshes min-dist once against the
previous round's batch; distances clamp at zero. Lloyd's assigns by
first-index argmin, a center is its cluster's mean (zero when empty), and
iteration stops when memberships repeat (that rep still updates centers)
or after max_reps.

The k-means++ rounds run as a host loop: per round one device pass for
min-dist, its cumulative sum and a searchsorted of the round's dice on the
host (a sequential float sum, the same on every run), and a sequential
accept loop over the (at most ~12) candidates.
k-means|| and AFK-MC^2 keep isle_tpu's deviations from the reference
(documented in their docstrings); AFK-MC^2's accept/reject chain is
sequential and runs on the host in float32 over the chain's batch.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .matops import mat_b_y, mat_bt_x, mat_doc_l2sq
from .segsum import DEFAULT_CHUNK


def _dists_to(P: torch.Tensor, docs_l2: torch.Tensor,
              C: torch.Tensor) -> torch.Tensor:
    """(D, c) squared distances of the docs P (kdim, D) to the columns of
    C (kdim, c), clamped at zero."""
    d = docs_l2[:, None] + torch.sum(C * C, dim=0)[None, :] - 2.0 * (P.T @ C)
    return torch.clamp(d, min=0.0)


def _dists_to_doc(P: torch.Tensor, docs_l2: torch.Tensor,
                  i: int) -> torch.Tensor:
    """(D,) squared distances of the docs to doc i, clamped at zero."""
    return torch.clamp(docs_l2 + docs_l2[i] - 2.0 * (P.T @ P[:, i]), min=0.0)


def kmeanspp_on_projected(P: torch.Tensor, k: int, draws
                          ) -> Tuple[torch.Tensor, float]:
    """P: (kdim, D) projected docs. Returns (center doc ids int64 (k,) on
    P's device, residual)."""
    kdim, D = P.shape
    dev = P.device
    nb_max = 1 + int(math.ceil(math.sqrt(max(k - 5, 1)))) + 1
    docs_l2 = torch.sum(P * P, dim=0)
    first = draws.seeding_first(D)
    min_dist = torch.full((D,), torch.finfo(torch.float32).max,
                          dtype=torch.float32, device=dev)
    chosen = np.zeros(D, bool)
    chosen[first] = True
    centers = [first]
    fresh = [first]  # centers added in the previous round (refresh set)
    while len(centers) < k:
        if fresh:
            C = P[:, torch.tensor(fresh, device=dev)]
            min_dist = torch.minimum(min_dist,
                                     _dists_to(P, docs_l2, C).amin(dim=1))
        # The cumulative sum runs on the host, in order: a float scan on
        # the card adds its tiles' partial sums in an order that changes
        # from run to run, and one ulp moves a draw that falls on a
        # boundary to the next doc, a whole clustering with it.
        cumul = torch.cumsum(min_dist.cpu(), 0)
        total = cumul[-1]
        if float(total) <= 0.0:
            # Every distinct doc is already a center (duplicate-doc
            # corpora): fill the remaining slots by cycling from the first
            # center, as isle_tpu does, instead of drawing forever.
            centers += [(centers[0] + s) % D for s in range(len(centers), k)]
            break
        nb = int(math.ceil(1.0 + math.sqrt(max(len(centers) - 5, 0))))
        dice = draws.uniform(nb_max) * total
        cand = torch.clamp(torch.searchsorted(cumul, dice, right=True),
                           max=D - 1).numpy()
        fresh = []
        for i in range(min(nb, nb_max)):
            c = int(cand[i])
            if len(centers) < k and not chosen[c]:
                chosen[c] = True
                centers.append(c)
                fresh.append(c)
    # Residual as the reference reports it: cumulative min-dist through the
    # second-to-last doc (src/sparseMatrix.cpp:2207 reads dist_cumul[D-1]).
    residual = float(torch.cumsum(min_dist.cpu(), 0)[-2]) if D > 1 else 0.0
    return torch.tensor(centers, dtype=torch.int64, device=dev), residual


def kmeansbb_on_projected(P: torch.Tensor, k: int, draws, timer=None
                          ) -> Tuple[torch.Tensor, float]:
    """k-means|| oversampling init (isle_tpu.kmeans.kmeansbb_on_projected,
    reference FPDenseMatrix::kmeansbb, src/denseMatrix.cpp:681-783): R = 10
    + 5 ln k rounds; per round every doc independently becomes a candidate
    with prob L*min_dist/total, L = k/2; candidates are weighted by the
    docs closest to them and reduced to k centers by weighted k-means++
    and 10 weighted Lloyd's steps. isle_tpu's two repairs of reference
    bugs are kept: candidate coordinates are the sampled docs, and the
    final weighted Lloyd's starts from weighted D^2 seeds. Returns
    (centers (k, kdim), residual)."""
    kdim, D = P.shape
    L = max(int(0.5 * k), 1)
    R = 10 + 5 * int(math.log(max(k, 2)))
    docs_l2 = torch.sum(P * P, dim=0)
    first = draws.seeding_first(D)
    cand = [first]
    min_dist = _dists_to_doc(P, docs_l2, first)
    for _ in range(R):
        total = float(torch.sum(min_dist))
        if total <= 0:
            break
        u = draws.uniform(D).to(P.device)
        newly = torch.nonzero(u < L * min_dist / total)[:, 0]
        if newly.numel() == 0:
            continue
        cand.extend(newly.tolist())
        min_dist = torch.minimum(
            min_dist, _dists_to(P, docs_l2, P[:, newly]).amin(dim=1))
    cand = sorted(set(cand))
    Pc = P[:, torch.tensor(cand, device=P.device)]  # (kdim, C)
    # weight candidates by the number of docs closest to them
    closest = torch.argmin(
        docs_l2[:, None] + torch.sum(Pc * Pc, dim=0)[None, :]
        - 2.0 * (P.T @ Pc), dim=1)
    # integer counts: their sum does not depend on the order of adding
    weights = torch.bincount(closest, minlength=len(cand)).to(torch.float32)
    centers = _weighted_kmeanspp(Pc, weights, k, draws.fork())
    centers, residual = _weighted_lloyds(Pc, weights, centers, reps=10)
    if timer is not None:
        timer.diag(f"kmeansbb: {len(cand)} candidates -> {k} centers")
    return centers, float(residual)


def _weighted_kmeanspp(P: torch.Tensor, w: torch.Tensor, k: int,
                       draws) -> torch.Tensor:
    """k D^2 picks, each with probability ~ max(min_dist * w, 1e-30) (the
    first ~ w); duplicates are not rejected. Returns (k, kdim)."""
    docs_l2 = torch.sum(P * P, dim=0)
    first = draws.categorical(w)
    idx = [first]
    min_dist = _dists_to_doc(P, docs_l2, first)
    for _ in range(1, k):
        nxt = draws.categorical(min_dist * w)
        idx.append(nxt)
        min_dist = torch.minimum(min_dist, _dists_to_doc(P, docs_l2, nxt))
    return P[:, torch.tensor(idx, device=P.device)].T


def _weighted_lloyds(P: torch.Tensor, w: torch.Tensor, centers: torch.Tensor,
                     reps: int):
    """`reps` weighted Lloyd's steps; residual is the weighted sum of the
    last assignment's clamped distances."""
    docs_l2 = torch.sum(P * P, dim=0)
    k = centers.shape[0]
    residual = torch.zeros((), dtype=torch.float32)
    for _ in range(reps):
        dists = (docs_l2[:, None] + torch.sum(centers * centers, dim=1)[None, :]
                 - 2.0 * (P.T @ centers.T))
        assign = torch.argmin(dists, dim=1)
        residual = torch.sum(torch.clamp(dists.amin(dim=1), min=0.0) * w)
        sums, counts = _cluster_sums(P * w[None, :], assign, k, w)
        centers = torch.where(counts[:, None] > 0, sums / counts[:, None],
                              0.0)
    return centers, residual


def mcmc_chain(dmin: np.ndarray, q_s: np.ndarray, u: np.ndarray) -> int:
    """The Metropolis accept/reject recurrence of AFK-MC^2 over one batch
    (reference src/denseMatrix.cpp:841-869), in float32 as
    isle_tpu.kmeans._mcmc_chain_step runs it. Returns the final chain
    position."""
    dmin = dmin.astype(np.float32)
    q_s = q_s.astype(np.float32)
    u = u.astype(np.float32)
    cur = 0
    for s in range(1, len(dmin)):
        denom = dmin[cur] * q_s[s]
        ratio = (dmin[s] * q_s[cur]) / denom if denom > 0.0 else 1.0
        if ratio > u[s]:
            cur = s
    return cur


def kmeansmcmc_on_projected(P: torch.Tensor, k: int, draws,
                            sample_size: int = 10000, timer=None):
    """AFK-MC^2 Markov-chain seeding (isle_tpu.kmeans.
    kmeansmcmc_on_projected, reference src/denseMatrix.cpp:785-883):
    between exact min-dist refreshes, each new center is the end of a
    Metropolis chain over `sample_size` proposals drawn from the stale
    distribution q = 0.5 d^2/total + 0.5/D (isle_tpu's repair of the
    reference's sign bug). Returns (center doc ids int64 (k,), centers
    (k, kdim), residual)."""
    kdim, D = P.shape
    dev = P.device
    sample_size = min(sample_size, max(D, 2))
    docs_l2 = torch.sum(P * P, dim=0)
    first = draws.seeding_first(D)
    centers = [first]
    min_dist = _dists_to_doc(P, docs_l2, first)
    processed = 1
    refresh = 1
    while len(centers) < k:
        # refresh exact min-dists vs centers added since the last refresh
        if len(centers) > processed:
            Cn = P[:, torch.tensor(centers[processed:], device=dev)]
            min_dist = torch.minimum(
                min_dist, _dists_to(P, docs_l2, Cn).amin(dim=1))
            processed = len(centers)
        total = torch.clamp(torch.sum(min_dist), min=1e-30)
        q = 0.5 * min_dist / total + 0.5 / D
        refresh += 1
        for _ in range(refresh):
            if len(centers) >= k:
                break
            samp, u = draws.mcmc_proposals(q, sample_size)
            samp = samp.to(dev)
            Cs = P[:, samp]
            dmin = _dists_to(Cs, torch.sum(Cs * Cs, dim=0),
                             P[:, torch.tensor(centers, device=dev)]
                             ).amin(dim=1)
            cur = mcmc_chain(dmin.cpu().numpy(), q[samp].cpu().numpy(),
                             u.numpy())
            centers.append(int(samp[cur]))
    residual = float(torch.sum(min_dist))
    if timer is not None:
        timer.diag(f"kmeansmcmc picked {k} centers")
    idx = torch.tensor(centers[:k], dtype=torch.int64, device=dev)
    return idx, P[:, idx].T, residual


def kmeans_init_on_projected(P: torch.Tensor, k: int, reps: int, draws,
                             method: str = "kmeanspp", timer=None,
                             mcmc_sample_size: int = 10000):
    """Best-of-`reps` seeding with the configured method
    (kmeans_init_on_projected_space src/sparseMatrix.cpp:2212-2238).
    Returns (seed doc ids, or None for kmeansbb; centers (k, kdim);
    residual)."""
    best = None
    for _ in range(reps):
        if method == "kmeansbb":
            centers, residual = kmeansbb_on_projected(P, k, draws,
                                                      timer=timer)
            idx = None
        elif method == "kmeansmcmc":
            idx, centers, residual = kmeansmcmc_on_projected(
                P, k, draws, sample_size=mcmc_sample_size, timer=timer)
        elif method == "kmeanspp":
            idx, residual = kmeanspp_on_projected(P, k, draws)
            centers = P[:, idx].T
        else:
            raise ValueError(f"unknown kmeans_init_method {method!r}")
        if best is None or residual < best[2]:
            best = (idx, centers, residual)
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


def _cluster_sums(P: torch.Tensor, assign: torch.Tensor, k: int,
                  weights=None):
    """(sums (k, kdim), counts (k,)) of the columns of P (kdim, D) by
    cluster, as the one-hot product isle_tpu.kmeans takes. A matmul sums
    in an order the input fixes, where index_add_ on the card adds with
    float atomics in an order that changes from run to run. The product
    accumulates in float64 and is rounded to float32 once, so the result
    does not depend on the library's order of summation either: the card
    and the CPU give the same centers, and Lloyd's the same near ties.
    `weights` (D,) are summed into the counts in place of ones."""
    onehot = torch.nn.functional.one_hot(assign, k).to(torch.float64)
    counts = (onehot.sum(dim=0) if weights is None
              else onehot.T @ weights.to(torch.float64))
    sums = onehot.T @ P.T.to(torch.float64)
    return sums.to(torch.float32), counts.to(torch.float32)


def run_lloyds_projected(P: torch.Tensor, centers: torch.Tensor,
                         max_reps: int, timer=None):
    """Lloyd's on the projected docs P (kdim, D) from centers (k, kdim).
    Returns (centers, assignment)."""
    k = centers.shape[0]
    D = P.shape[1]
    docs_l2 = torch.sum(P * P, dim=0)
    assign = torch.full((D,), -1, dtype=torch.int64, device=P.device)
    reps = 0
    for reps in range(1, max_reps + 1):
        prev, assign = assign, _assign(P.T @ centers.T, docs_l2, centers)
        centers = _means(*_cluster_sums(P, assign, k))
        if torch.equal(assign, prev):
            break
    if timer is not None:
        timer.diag(f"projected lloyds ran {reps} reps (max {max_reps})")
    return centers, assign


def update_centers_full(sp, assign: torch.Tensor, k: int,
                        chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Cluster means (k, vocab) of B's docs under `assign`; B in either
    layout (matops)."""
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(torch.float32)
    sums = mat_b_y(sp, onehot, chunk)  # (vocab, k)
    return _means(sums.T, onehot.sum(dim=0))


def lloyds_iter_full(sp, centers: torch.Tensor, docs_l2: torch.Tensor,
                     k: int, chunk: int = DEFAULT_CHUNK,
                     update_centers=update_centers_full):
    """One Lloyd's iteration on B in the full vocab space (isle_tpu.kmeans.
    _lloyds_iter_full): the assignment, then the centers under it. Returns
    (centers (k, vocab), assignment int64 (num_docs,))."""
    assign = _assign(mat_bt_x(sp, centers.T.contiguous(), chunk), docs_l2,
                     centers)
    return update_centers(sp, assign, k, chunk), assign


def run_lloyds_full(sp, centers: torch.Tensor, max_reps: int,
                    timer=None, chunk: int = DEFAULT_CHUNK,
                    update_centers=update_centers_full,
                    unchanged=torch.equal):
    """Lloyd's on B (either layout, matops) in the full vocab space from
    centers (k, vocab). Returns (centers, assignment int64 (num_docs,)).

    The two hooks are where a run over several ranks meets the others
    (sharding.sharded_run_lloyds_full): `update_centers(sp, assign, k,
    chunk)` gives the cluster means and `unchanged(assign, prev)` says
    whether Lloyd's may stop. `sp` then holds this rank's docs."""
    k = centers.shape[0]
    docs_l2 = mat_doc_l2sq(sp, chunk)
    assign = torch.full((sp.num_docs,), -1, dtype=torch.int64,
                        device=sp.device)
    reps = 0
    for reps in range(1, max_reps + 1):
        prev = assign
        centers, assign = lloyds_iter_full(sp, centers, docs_l2, k, chunk,
                                           update_centers)
        if unchanged(assign, prev):
            break
    if timer is not None:
        timer.diag(f"full lloyds ran {reps} reps (max {max_reps})")
    return centers, assign
