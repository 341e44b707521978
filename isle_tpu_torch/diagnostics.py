"""Topic diagnostics the training reports print: coherence, document
frequencies, topic diversity, the log-combinatorial statistic and the
distinct top-5 multisets. The port's copy of isle_tpu/diagnostics.py
(reference src/sparseMatrix.cpp:170-215, 841-1048,
src/trainer.cpp:750-771), numpy on the host.
"""

from __future__ import annotations

import numpy as np

from .io_text import top_words_per_topic


def doc_frequency(corpus, words: np.ndarray) -> np.ndarray:
    """#docs containing each word (src/sparseMatrix.cpp:969-1015)."""
    df = np.bincount(corpus.rows, minlength=corpus.vocab_size)
    return df[words]


def joint_doc_frequency(corpus, w1: int, w2: int) -> int:
    """#docs containing both words (src/sparseMatrix.cpp:841-967)."""
    docs = corpus.doc_ids()
    d1 = set(docs[corpus.rows == w1].tolist())
    d2 = set(docs[corpus.rows == w2].tolist())
    return len(d1 & d2)


def joint_doc_frequencies(corpus, words: np.ndarray) -> np.ndarray:
    """All-pairs joint document frequencies of `words`: J = Z^T Z with Z
    the (docs, |words|) word-in-doc indicator, built one doc block at a
    time so host memory stays bounded."""
    T = len(words)
    D = corpus.num_docs
    idx = np.full(corpus.vocab_size, -1, np.int64)
    idx[words] = np.arange(T)
    sel = idx[corpus.rows] >= 0
    docs = corpus.doc_ids()[sel]
    cols = idx[corpus.rows[sel]]
    J = np.zeros((T, T), np.float64)
    block = max(1, (1 << 28) // max(4 * T, 1))  # ~256 MB of Z per block
    edges = np.arange(0, max(D, 1) + block, block)
    bounds = np.searchsorted(docs, edges)  # docs is doc-major sorted
    for i in range(len(edges) - 1):
        a, b = bounds[i], bounds[i + 1]
        if a == b:
            continue
        lo = edges[i]
        Z = np.zeros((min(lo + block, D) - lo, T), np.float32)
        Z[docs[a:b] - lo, cols[a:b]] = 1.0
        J += (Z.T @ Z).astype(np.float64)
    return J.astype(np.int64)


def topic_coherence(corpus, model: np.ndarray, num_words: int = 5,
                    eps: float = 1e-5) -> np.ndarray:
    """Per-topic UMass-style coherence over the top `num_words` words:
    sum over l > m of log((joint_df(w_l, w_m) + eps) / df(w_m))."""
    k = model.shape[1]
    tops = top_words_per_topic(model, num_words)
    needed = sorted({w for top in tops for w, _ in top})
    pos = {w: i for i, w in enumerate(needed)}
    J = joint_doc_frequencies(corpus, np.asarray(needed, np.int64))
    df = np.bincount(corpus.rows, minlength=corpus.vocab_size)
    out = np.zeros(k, np.float64)
    for t in range(k):
        ws = np.asarray([pos[w] for w, wt in tops[t] if wt > 0.0], np.int64)
        dfw = np.asarray([df[w] for w, wt in tops[t] if wt > 0.0])
        n = len(ws)
        if n < 2:
            continue
        Jt = J[np.ix_(ws, ws)].astype(np.float64)
        l_idx, m_idx = np.tril_indices(n, k=-1)
        denom = dfw[m_idx].astype(np.float64)
        vals = Jt[l_idx, m_idx]
        mask = denom > 0
        out[t] = np.log((vals[mask] + eps) / denom[mask]).sum()
    return out.astype(np.float32)


def topic_diversity(model: np.ndarray) -> float:
    """Average squared distance of topic vectors to the mean topic vector
    (src/trainer.cpp:750-771)."""
    avg = model.mean(axis=1)
    d = model - avg[:, None]
    return float(np.mean(np.sum(d * d, axis=0)))


def log_combinatorial(corpus) -> np.ndarray:
    """Per-doc log multinomial coefficient log(n! / prod c_w!)
    (src/sparseMatrix.cpp:1017-1048)."""
    from scipy.special import gammaln

    counts = corpus.counts
    if counts is None:
        raise ValueError("raw counts unavailable")
    D = corpus.num_docs
    doc_total = np.zeros(D)
    np.add.at(doc_total, corpus.doc_ids(), counts)
    term = np.zeros(D)
    np.add.at(term, corpus.doc_ids(), gammaln(counts + 1.0))
    return (gammaln(doc_total + 1.0) - term).astype(np.float32)


def count_distinct_top_five(corpus, min_count: int) -> int:
    """#top-5-word multisets occurring in more than `min_count` docs
    (src/sparseMatrix.cpp:170-215), by one global lexsort: entries rank
    by (doc, -val, position), the tie order of a stable argsort per doc;
    the first 5 of a doc are its multiset, and word-sorted rows dedupe
    with np.unique."""
    D = corpus.num_docs
    nnz = corpus.nnz
    if nnz == 0:
        return 0
    docs = corpus.doc_ids().astype(np.int64)
    order = np.lexsort((np.arange(nnz), -corpus.vals, docs))
    sdoc = docs[order]
    srow = corpus.rows[order]
    starts = np.searchsorted(sdoc, np.arange(D))
    rank = np.arange(nnz) - starts[sdoc]
    take = rank < 5
    td, tw, tr = sdoc[take], srow[take], rank[take]
    keep = np.bincount(td, minlength=D) > 0
    # (docs with entries, 5) word matrix, short docs padded with vocab_size
    M = np.full((D, 5), corpus.vocab_size, np.int64)
    M[td, tr] = tw
    M = np.sort(M[keep], axis=1)  # the multiset's canonical form
    _, counts = np.unique(M, axis=0, return_counts=True)
    return int((counts > min_count).sum())
