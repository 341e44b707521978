"""Topic-matrix construction and edge topics: the port of
isle_tpu/topic_model.py (reference src/sparseMatrix.cpp:597-838,
src/trainer.cpp:1118-1168).

  1. per-doc catchword mass (D, k): segsum_onehot over the doc-sorted
     stream, col = the word's catchword topic (-1 otherwise), val = the
     normalized count;
  2. top-2 topics per doc (first-index argmax, both masses positive);
  3. per-topic threshold: the rank_threshold-th largest mass (0 when fewer
     docs qualify or the topic has no catchwords);
  4. Model = B W with W[d, t] = (mass[d, t] > thr[t]) + (cluster[d] == t),
     through segsum_gather_rows over the word-sorted stream (sparse.b_y);
  5. l1 normalization per topic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .segsum import DEFAULT_CHUNK, segsum_onehot
from .sparse import DocSparse, b_y


def doc_topic_mass(A: DocSparse, cw_topic: torch.Tensor, num_topics: int,
                   seg_chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """(num_docs, num_topics) catchword mass per doc."""
    return segsum_onehot(
        A.d_doc, cw_topic[A.d_word], A.d_val, A.num_docs, num_topics,
        chunk=seg_chunk,
    )[: A.num_docs]


def model_thresholds(mass: torch.Tensor, has_catchwords: torch.Tensor,
                     rank_threshold: int) -> torch.Tensor:
    """Per-topic rank_threshold-th largest mass (0 if fewer than
    rank_threshold docs have positive mass, or no catchwords)."""
    D, k = mass.shape
    if rank_threshold <= 0 or rank_threshold > D:
        thr = torch.zeros(k, dtype=torch.float32, device=mass.device)
    else:
        svals = torch.sort(mass, dim=0, descending=True).values
        thr = svals[rank_threshold - 1]
        pos_counts = torch.sum(mass > 0.0, dim=0)
        thr = torch.where(pos_counts >= rank_threshold, thr, 0.0)
    return torch.where(has_catchwords, thr, 0.0)


def top_two_topics(mass: torch.Tensor):
    """First-index max and runner-up per doc. Returns (t1, t2, valid) with
    valid = both masses strictly positive."""
    k = mass.shape[1]
    v1 = mass.amax(dim=1)
    t1 = torch.argmax(mass, dim=1)
    cols = torch.arange(k, device=mass.device)[None, :]
    masked = torch.where(cols == t1[:, None], -torch.inf, mass)
    v2 = masked.amax(dim=1)
    t2 = torch.argmax(masked, dim=1)
    valid = (v1 > 0.0) & (v2 > 0.0)
    return t1.to(torch.int32), t2.to(torch.int32), valid


def _contribution_weights(mass: torch.Tensor, thr: torch.Tensor,
                          cluster_of_doc: torch.Tensor) -> torch.Tensor:
    """W (D, k) = (mass > thr) + one-hot of the doc's cluster."""
    W = (mass > thr[None, :]).to(torch.float32)
    docs = torch.nonzero(cluster_of_doc >= 0)[:, 0]
    W[docs, cluster_of_doc[docs].long()] += 1.0
    return W


def has_catchwords(cw_topic: torch.Tensor, num_topics: int) -> torch.Tensor:
    """(num_topics,) bool: the topic owns at least one catchword."""
    owned = cw_topic[cw_topic >= 0].long()
    return torch.bincount(owned, minlength=num_topics)[:num_topics] > 0


def l1_normalize_columns(model: torch.Tensor) -> torch.Tensor:
    """Each nonzero column divided by its sum."""
    sums = torch.sum(model, dim=0)
    return torch.where(sums[None, :] != 0.0, model / sums[None, :], model)


def construct_topic_model(
    A: DocSparse,
    cw_topic: torch.Tensor,  # (vocab,) int32 owning topic, -1 else
    cluster_of_doc: torch.Tensor,  # (num_docs,) int32, -1 = dropped doc
    num_topics: int,
    rank_threshold: int,
    want_top_pairs: bool = False,
    seg_chunk: int = DEFAULT_CHUNK,
):
    """Returns (Model (vocab, k) l1-normalized, (t1, t2, valid) or None)."""
    has_cw = has_catchwords(cw_topic, num_topics)
    mass = doc_topic_mass(A, cw_topic, num_topics, seg_chunk)
    thr = model_thresholds(mass, has_cw, rank_threshold)
    pairs = top_two_topics(mass) if want_top_pairs else None
    W = _contribution_weights(mass, thr, cluster_of_doc)
    del mass
    return l1_normalize_columns(b_y(A, W, seg_chunk)), pairs


def construct_edge_topics_v1(
    A: DocSparse,
    t1: np.ndarray,
    t2: np.ndarray,
    valid: np.ndarray,
    original_doc_ids: Optional[np.ndarray],
    num_topics: int,
    max_edge_topics: int,
    min_docs: int = 1,
    seg_chunk: int = DEFAULT_CHUNK,
) -> Tuple[np.ndarray, np.ndarray]:
    """Edge topics v1, the doc-average variant (src/trainer.cpp:1042-1114):
    an edge vector is the mean of the normalized counts of the docs whose
    top-two pair selected it. t1/t2/valid are per doc, indexed like A's
    docs unless original_doc_ids maps them. The pairs are selected as in
    v2; one SpMM (sparse.b_y at width n_edges) gives all edge vectors.
    Returns (edge_model (vocab, n_edges), selected pairs (n_edges, 3))."""
    k = num_topics
    keys = t1.astype(np.int64) * k + t2.astype(np.int64)
    doc_ids = (np.arange(len(t1)) if original_doc_ids is None
               else original_doc_ids)
    keys_v, docs_v = keys[valid], doc_ids[valid]
    counts = np.bincount(keys_v, minlength=k * k)
    cand = np.nonzero(counts >= max(min_docs, 1))[0]
    order = np.lexsort((cand % k, cand // k, -counts[cand]))
    cand = cand[order][:max_edge_topics]
    edge_of_pair = np.full(k * k, -1, np.int64)
    edge_of_pair[cand] = np.arange(len(cand))
    e = edge_of_pair[keys_v]  # the doc's edge topic, -1 for none
    picked = e >= 0
    W = np.zeros((A.num_docs, len(cand)), np.float32)
    W[docs_v[picked], e[picked]] = 1.0 / counts[cand][e[picked]]
    edge = b_y(A, torch.from_numpy(W).to(A.device), seg_chunk).cpu().numpy()
    sel = np.stack(
        [(cand // k).astype(np.int32), (cand % k).astype(np.int32),
         counts[cand].astype(np.int32)], axis=1,
    )
    return edge.astype(np.float32), sel


def edge_vectors(model: np.ndarray, a: np.ndarray, b: np.ndarray,
                 primary_ratio: float,
                 device: Optional[torch.device] = None) -> np.ndarray:
    """(vocab, len(a)) float32: primary_ratio * model[:, a] + (1 -
    primary_ratio) * model[:, b], each ratio rounded to float32, each
    product rounded and then the sum, as numpy's float32 arithmetic does.
    On a CUDA device the model's columns are gathered and combined there
    (a multiply, a multiply, an add: no fused multiply-add, so the bits
    are numpy's) and the result copied back; elsewhere host numpy, its
    plain version. The host version's two column gathers of a (vocab,
    n) result took 2.4 ms an edge topic at V = 141,043 on the H100's
    host: 4.8 s of a job at 2000 edge topics."""
    if device is None or torch.device(device).type != "cuda":
        edge = (primary_ratio * model[:, a]
                + (1.0 - primary_ratio) * model[:, b])
        return edge.astype(np.float32)
    m = torch.from_numpy(np.ascontiguousarray(model, np.float32)).to(device)
    ia, ib = (torch.from_numpy(np.asarray(x, np.int64)).to(device)
              for x in (a, b))
    edge = m[:, ia].mul_(primary_ratio)
    edge.add_(m[:, ib].mul_(1.0 - primary_ratio))
    return edge.cpu().numpy()


def construct_edge_topics_v2(
    t1: np.ndarray,
    t2: np.ndarray,
    valid: np.ndarray,
    model: np.ndarray,
    num_topics: int,
    max_edge_topics: int,
    min_docs: int = 1,
    primary_ratio: float = 0.7,
    device: Optional[torch.device] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (edge_model (vocab, n_edges), selected pairs (n_edges, 3) of
    [t1, t2, count]): pairs with >= min_docs docs, count-descending with
    (t1, t2) ties ascending, truncated to max_edge_topics; edge vector =
    primary_ratio * topic_a + (1 - primary_ratio) * topic_b (edge_vectors,
    on `device` where it is a card). A copy of
    isle_tpu.topic_model.construct_edge_topics_v2, whose pair selection
    runs on the host (the per-doc pairs are small)."""
    k = num_topics
    keys = t1.astype(np.int64) * k + t2.astype(np.int64)
    keys = keys[valid]
    counts = np.bincount(keys, minlength=k * k)
    cand = np.nonzero(counts >= max(min_docs, 1))[0]
    order = np.lexsort((cand % k, cand // k, -counts[cand]))
    cand = cand[order][:max_edge_topics]
    a = (cand // k).astype(np.int32)
    b = (cand % k).astype(np.int32)
    edge = edge_vectors(model, a, b, primary_ratio, device)
    sel = np.stack([a, b, counts[cand].astype(np.int32)], axis=1)
    return edge, sel
