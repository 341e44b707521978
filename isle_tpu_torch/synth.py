"""A synthetic bag-of-words corpus from a seed, with the word statistics of
UCI NYTimes: the corpus chip_smoke.py trains on. The same generator as
the repository's bench.py (synth_corpus), kept here so the port needs
nothing outside its package.
"""

from __future__ import annotations

import numpy as np


def _zipf_ranks(u: np.ndarray, n: int) -> np.ndarray:
    """Inverse-CDF sampling of ranks 0..n-1 with P(r) ~ 1/(r+1): the
    Zipf(alpha=1) word-frequency law of real bag-of-words corpora."""
    return np.minimum(
        (np.exp(u * np.log(float(n))) - 1.0).astype(np.int64), n - 1
    )


def synth_corpus(vocab: int, docs: int, nnz: int, seed: int = 0):
    """(doc, word, count) int64 arrays of unique (doc, word) pairs in
    (doc, word) order, about `nnz` of them. Words follow Zipf(1), as in
    NYTimes (a few thousand head words carry most tokens), with planted
    topic structure: each doc draws half its tokens from one of 64 word
    bands, Zipf-skewed within the band. Counts are uniform in [1, 7]."""
    rng = np.random.default_rng(seed)
    # Zipf draws collapse under (doc, word) dedup: oversample so the
    # distinct pair count (the matrix nnz) reaches the target.
    raw = int(nnz * 1.30)
    d = rng.integers(0, docs, raw, dtype=np.int64)
    w = _zipf_ranks(rng.random(raw), vocab)
    band = (d % 64).astype(np.int64)
    use_band = rng.random(raw) < 0.5
    bsz = max(vocab // 64, 1)
    band_w = band * bsz + _zipf_ranks(rng.random(raw), bsz)
    w = np.where(use_band, band_w, w)
    key = np.unique(d * vocab + w)
    d = (key // vocab).astype(np.int64)
    w = (key % vocab).astype(np.int64)
    c = rng.integers(1, 8, len(key), dtype=np.int64)
    return d, w, c


BITE_MAX_COUNT = 1000  # bite_counts' largest count


def bite_counts(docs: np.ndarray, seed: int = 1) -> np.ndarray:
    """New counts for synth_corpus's (doc, word) pairs (`docs`: their doc
    ids, in (doc, word) order) on which the ζ thresholds bite: Zipf(2)
    counts capped at BITE_MAX_COUNT, so a frequent word's largest rounded
    frequencies stand apart and its ζ rises above 1; and in every doc d
    with d % 100 == 7, every count 1 but the first entry's, which gets
    BITE_MAX_COUNT, so the doc's other normalized values are small (below
    0.5 where the doc holds many entries against avg_doc_sz, and then
    under every ζ). Returns int64 counts."""
    rng = np.random.default_rng(seed)
    c = np.minimum(rng.zipf(2.0, len(docs)), BITE_MAX_COUNT)
    flat = docs % 100 == 7
    first = flat & np.concatenate([[True], docs[1:] != docs[:-1]])
    c[flat] = 1
    c[first] = BITE_MAX_COUNT
    return c
