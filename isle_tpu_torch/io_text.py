"""Text model artifacts: the sparse model file and its loader, the
top-words and top-topics reports, the edge-topic composition. The port's
copy of isle_tpu/io_text.py (the parts the port calls); the formats are
the reference's, so models interoperate both ways:

  - sparse model (`M_hat_catch_sparse`): `<topic>\\t<word>\\t<weight>`
    lines, 1-based ids, entries > 1e-8, topic-major
    (src/denseMatrix.cpp:153-187); the loader reads it into a word-major
    (vocab, num_topics) array (src/infer.cpp:125-249);
  - dense model (`M_hat_avg`): one tab-separated row of vocab weights
    per topic (src/denseMatrix.cpp:124-151), and its loader;
  - top words (`TopWordsPerTopic_catch.txt`, src/trainer.cpp:855-886);
  - top topics per doc (drivers/ISLEInfer.cpp:100-111).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from . import native


def write_sparse_model(path: str, model: np.ndarray, base: int = 1) -> None:
    """model: (vocab, num_topics)."""
    native.write_sparse_model(path, model, base=base)


def write_dense_model(path: str, model: np.ndarray) -> None:
    with open(path, "w") as f:
        for t in range(model.shape[1]):
            f.write("\t".join(f"{x:.8g}" for x in model[:, t]))
            f.write("\n")


def load_sparse_model(path: str, num_topics: int, vocab_size: int,
                      base: int = 1) -> np.ndarray:
    """Returns a (vocab, num_topics) float32 array (word-major rows)."""
    data = np.loadtxt(path, dtype=np.float64, ndmin=2)
    out = np.zeros((vocab_size, num_topics), np.float32)
    if data.size == 0:
        return out
    t = data[:, 0].astype(np.int64) - base
    w = data[:, 1].astype(np.int64) - base
    out[w, t] = data[:, 2].astype(np.float32)
    return out


def load_dense_model(path: str, num_topics: int,
                     vocab_size: int) -> np.ndarray:
    """A dense model file as a (vocab, num_topics) float32 array."""
    data = np.loadtxt(path, dtype=np.float32, ndmin=2)
    if data.shape != (num_topics, vocab_size):
        raise ValueError(f"{path}: a ({num_topics}, {vocab_size}) dense "
                         f"model expected, read {data.shape}")
    return data.T.copy()


def top_words_per_topic(model: np.ndarray,
                        n: int) -> List[List[Tuple[int, float]]]:
    """Top-n (word, weight) per topic, weight-descending, ties to the lower
    word id (DenseMatrix::find_n_top_words, src/denseMatrix.cpp:93-107)."""
    out = []
    for t in range(model.shape[1]):
        col = model[:, t]
        idx = np.argsort(-col, kind="stable")[:n]
        out.append([(int(i), float(col[i])) for i in idx])
    return out


def write_top_words(path: str, model: np.ndarray,
                    vocab_words: Sequence[str], n: int) -> None:
    with open(path, "w") as f:
        for top in top_words_per_topic(model, n):
            f.write("\t".join(vocab_words[w] for w, _ in top))
            f.write("\n")


def write_top_topics(path: str, weights: np.ndarray, converged: np.ndarray,
                     doc_begin: int = 1, top_n: int = 5) -> None:
    """Per-doc top topics above uniform mass, at most top_n, as
    `<doc>\\t<topic>\\t<weight>` with 1-based topic ids: doc ascending,
    then weight descending, ties to the lower topic id
    (drivers/ISLEInfer.cpp:100-111). weights: (num_docs, k)."""
    D, k = weights.shape
    w = np.asarray(weights, np.float32)
    sel = (w > np.float32(1.0 / k)) & np.asarray(converged, bool)[:, None]
    dd, tt = np.nonzero(sel)
    vv = w[dd, tt]
    order = np.lexsort((tt, -vv, dd))
    dd, tt, vv = dd[order], tt[order], vv[order]
    if len(dd):  # rank within each doc's run; keep the first top_n
        starts = np.flatnonzero(np.concatenate([[True], dd[1:] != dd[:-1]]))
        run_start = np.repeat(
            starts, np.diff(np.concatenate([starts, [len(dd)]])))
        keep = np.arange(len(dd)) - run_start < top_n
        dd, tt, vv = dd[keep], tt[keep], vv[keep]
    native.write_float_triples(path, dd, tt, vv, base_a=doc_begin, base_b=1)


def write_edge_composition(path: str, selected_pairs: np.ndarray) -> None:
    """`<t1>\\t<t2>\\t<count>` lines (print_edge_topic_composition,
    src/trainer.cpp:1171-1199)."""
    with open(path, "w") as f:
        for a, b, c in selected_pairs:
            f.write(f"{a}\t{b}\t{c}\n")
