"""Catchword identification: the r-th highest per-(word, cluster) frequency
and the dominance predicate. The port of isle_tpu/catchwords.py
(reference src/sparseMatrix.cpp:491-524, 573-594).

thr[t, w] is the r-th largest normalized frequency of word w among the
docs of cluster t when the group holds more than r entries; 0 otherwise,
except the degenerate case r >= |cluster| with w in every doc of the
cluster, which takes the group minimum. Two passes:

  1. exact int32 group counts (V, k) from segsum_onehot over the
     word-sorted stream (col = the doc's cluster, -1 outside any);
  2. compaction of the entries of selected groups, sorted by (group asc,
     value desc) with two stable sorts, and one gather per group at the
     exclusive prefix sum of the selected groups' sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from .segsum import DEFAULT_CHUNK, segsum_onehot
from .sparse import DocSparse


def _group_selection(counts2, csz_row, r: int):
    """(selected, degenerate): a group is selected when it holds more than
    r entries, or in the degenerate full-cluster case."""
    degenerate = (
        (counts2 <= r) & (r >= csz_row) & (counts2 == csz_row) & (csz_row > 0)
    )
    return (counts2 > r) | degenerate, degenerate


def rth_highest(
    A: DocSparse,
    cluster_of_doc: torch.Tensor,  # (num_docs,) int32, -1 = no cluster
    cluster_sizes: torch.Tensor,  # (num_topics,) int32
    num_topics: int,
    r: int,
    seg_chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """Returns thresholds (num_topics, vocab) float32."""
    if r < 1:
        raise ValueError(
            "r = 0 is undefined in the reference (vector[-1] read)")
    V, k = A.vocab, num_topics
    col = cluster_of_doc[A.w_doc]  # the entry's cluster, -1 outside any
    counts2 = segsum_onehot(A.w_word, col, None, V, k, chunk=seg_chunk)[:V]
    sel, degenerate = _group_selection(counts2, cluster_sizes[None, :], r)

    key = A.w_word.long() * k + torch.clamp(col, min=0).long()
    selm = (col >= 0) & sel.reshape(-1)[key]
    ckey, cval = key[selm], A.w_val[selm]
    by_val = torch.argsort(cval, descending=True, stable=True)
    by_key = torch.argsort(ckey[by_val], stable=True)
    sval = cval[by_val][by_key]
    if sval.numel() == 0:
        sval = torch.zeros(1, dtype=torch.float32, device=A.device)

    cnt = counts2.reshape(-1).long()
    sizes_sel = torch.where(sel.reshape(-1), cnt, 0)
    starts = torch.cumsum(sizes_sel, 0) - sizes_sel
    last = sval.numel() - 1
    rth = sval[torch.clamp(starts + (r - 1), 0, last)].reshape(V, k)
    gmin = sval[torch.clamp(starts + cnt - 1, 0, last)].reshape(V, k)
    thr = torch.where(counts2 > r, rth, 0.0)
    thr = torch.where(degenerate, gmin, thr)
    return thr.T.contiguous()


def find_catchwords(thresholds: torch.Tensor, rho: float) -> torch.Tensor:
    """Boolean (num_topics, vocab): t's threshold strictly exceeds rho times
    every other topic's threshold."""
    k = thresholds.shape[0]
    if k == 1:
        return torch.zeros_like(thresholds, dtype=torch.bool)
    scaled = rho * thresholds
    top = scaled.amax(dim=0)
    top_idx = torch.argmax(scaled, dim=0)
    is_top = torch.arange(k, device=thresholds.device)[:, None] == top_idx
    second = torch.where(is_top, -torch.inf, scaled).amax(dim=0)
    others_max = torch.where(is_top, second, top)
    return thresholds > others_max


def catchword_topic_map(is_cw: np.ndarray) -> np.ndarray:
    """(vocab,) int32: owning topic per catchword, -1 otherwise. Catchwords
    are exclusive by construction (strict dominance)."""
    k, V = is_cw.shape
    out = np.full(V, -1, np.int32)
    t, w = np.nonzero(is_cw)
    out[w] = t
    return out
