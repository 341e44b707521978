"""A synthetic bag-of-words corpus from a seed, with the word statistics of
UCI NYTimes: the corpus chip_smoke.py trains on. The same generator as
the repository's bench.py (synth_corpus), kept here so the port needs
nothing outside its package.

synth_corpus_hashed makes the same recipe on the card, in seconds at UCI
PubMed's shape (8.2M docs, 949M draws), from draws of its own: a
counter-based integer hash, so the CPU and the card give the same arrays
bit for bit. corpus_from_csc builds the Corpus of its arrays without
per-entry doc ids.
"""

from __future__ import annotations

import numpy as np
import torch

from .corpus import Corpus


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
    # the distinct keys in order by a sort and a neighbour test: np.unique
    # gives the same keys, but under numpy 2.3.5 it is over 100x slower
    # than the sort at the NYTimes shape
    key = np.sort(d * vocab + w)
    keep = np.ones(len(key), bool)
    keep[1:] = key[1:] != key[:-1]
    key = key[keep]
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


# ---------------------------------------------------------------------------
# The recipe of synth_corpus on the card
# ---------------------------------------------------------------------------

# The mixer of the counter-based hash (a 32-bit integer hash): every
# product of a value below 2^32 with _MUL fits in an int64, and every
# shifted value is non-negative, so torch computes the same words on the
# CPU and on the card with no wrapping multiply and no signed shift.
_MUL = 0x45D9F3B
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_LN2 = 0.6931471805599453  # the float64 nearest ln 2
# the streams of synth_corpus_hashed's draws
_DOC, _WORD_HI, _WORD_LO, _USE_BAND, _BAND_HI, _BAND_LO, _COUNT = range(7)
_OVERSAMPLE = 1.30  # synth_corpus's raw draws per target nonzero
_BANDS = 64
# draws hashed (and counts made) at once: bounds the temporaries on the
# device; the draws are counter-based, so the arrays do not depend on it
_BLOCK = 1 << 26


def _mix32(x):
    """A bijection of [0, 2^32) (ints or int64 tensors) that mixes every
    input bit into every output bit."""
    x = (((x >> 16) ^ x) * _MUL) & _M32
    x = (((x >> 16) ^ x) * _MUL) & _M32
    return (x >> 16) ^ x


def hash_words(seed: int, stream: int, idx: torch.Tensor) -> torch.Tensor:
    """Word idx (int64 counters in [0, 2^32)) of stream `stream` of the
    seed, each an int64 in [0, 2^32)."""
    base = _mix32(seed & _M32)
    k1 = _mix32((base + _GOLDEN * (2 * stream + 1)) & _M32)
    k2 = _mix32((base + _GOLDEN * (2 * stream + 2)) & _M32)
    return _mix32((_mix32(idx ^ k1) + k2) & _M32)


def _ln(x: np.ndarray) -> np.ndarray:
    """ln of positive float64 values from frexp and the atanh series, in
    basic IEEE operations only: the same bits on every machine (a libm's
    or numpy's vector log may round the last bit otherwise, and move a
    rank at a boundary)."""
    m, e = np.frexp(x)  # x = m 2^e, m in [0.5, 1)
    s = (m - 1.0) / (m + 1.0)  # |s| <= 1/3
    s2 = s * s
    acc = np.zeros_like(s)
    for k in range(20, -1, -1):
        acc = acc * s2 + 1.0 / (2 * k + 1)
    return e * _LN2 + 2.0 * s * acc


def zipf_bounds(n: int) -> np.ndarray:
    """(n - 1,) int64: ceil(2^53 ln(j + 1) / ln n) for j = 1 .. n - 1. The
    rank of a 53-bit uniform m (u = m 2^-53) is the count of bounds <= m,
    floor(n^u) - 1: synth_corpus's inverse-CDF Zipf(1) rank, decided by
    integer comparisons."""
    if n < 2:
        return np.zeros(0, np.int64)
    j = np.arange(2, n + 1, dtype=np.float64)
    t = _ln(j) / _ln(np.array([float(n)]))[0]
    return np.ceil(t * 2.0 ** 53).astype(np.int64)


def _uniform53(seed: int, hi: int, lo: int, idx: torch.Tensor):
    """53-bit uniforms as int64 in [0, 2^53), from two streams."""
    return (hash_words(seed, hi, idx) << 21) | (hash_words(seed, lo, idx)
                                                >> 11)


def _zipf_ranks_hashed(bounds: torch.Tensor, m: torch.Tensor):
    if bounds.numel() == 0:
        return torch.zeros_like(m)
    return torch.searchsorted(bounds, m, right=True)


def synth_keys_hashed(vocab: int, docs: int, seed: int, lo: int, hi: int,
                      device="cuda", bounds=None) -> torch.Tensor:
    """Raw draws lo .. hi - 1 of synth_corpus_hashed as int64 keys doc *
    vocab + word: the doc uniform, the word Zipf(1) over the vocabulary,
    or (half of the draws) a Zipf(1) rank inside the doc's band d % 64 of
    vocab // 64 words. `bounds`: the two zipf_bounds tables on `device`
    (made here by default)."""
    dev = torch.device(device)
    bsz = max(vocab // _BANDS, 1)
    if bounds is None:
        bounds = tuple(torch.from_numpy(zipf_bounds(n)).to(dev)
                       for n in (vocab, bsz))
    idx = torch.arange(lo, hi, dtype=torch.int64, device=dev)
    d = (hash_words(seed, _DOC, idx) * docs) >> 32
    w = _zipf_ranks_hashed(bounds[0], _uniform53(seed, _WORD_HI, _WORD_LO,
                                                 idx))
    band_w = (d % _BANDS) * bsz + _zipf_ranks_hashed(
        bounds[1], _uniform53(seed, _BAND_HI, _BAND_LO, idx))
    use_band = hash_words(seed, _USE_BAND, idx) < (1 << 31)
    return d * vocab + torch.where(use_band, band_w, w)


def raw_draws(nnz: int) -> int:
    """The raw draws of synth_corpus and synth_corpus_hashed for an nnz
    target."""
    return int(nnz * _OVERSAMPLE)


def synth_corpus_hashed(vocab: int, docs: int, nnz: int, seed: int = 0,
                        device="cuda"):
    """synth_corpus's recipe on `device` from hashed draws: int(nnz x
    1.30) raw draws (synth_keys_hashed, _BLOCK at a time), deduplicated
    in (doc, word) order by a sort on the device, and counts uniform in
    [1, 7], one a unique pair. Returns (offsets int64 (docs + 1,), rows
    int32, counts uint8) on `device`: the CSC arrays of Corpus. The same
    bits on the CPU and on the card."""
    raw = raw_draws(nnz)
    if not (0 < docs < 1 << 31 and 0 < vocab and docs * vocab < 1 << 62
            and raw < 1 << 32 and 0 <= seed <= _M32):
        raise ValueError(f"synth_corpus_hashed: vocab {vocab}, docs {docs}, "
                         f"{raw} draws or seed {seed} out of range")
    dev = torch.device(device)
    bsz = max(vocab // _BANDS, 1)
    bounds = tuple(torch.from_numpy(zipf_bounds(n)).to(dev)
                   for n in (vocab, bsz))
    keys = torch.empty(raw, dtype=torch.int64, device=dev)
    for lo in range(0, raw, _BLOCK):
        hi = min(lo + _BLOCK, raw)
        keys[lo:hi] = synth_keys_hashed(vocab, docs, seed, lo, hi, dev,
                                        bounds)
    keys = torch.unique(keys, sorted=True)
    offsets = torch.searchsorted(
        keys, torch.arange(docs + 1, dtype=torch.int64, device=dev) * vocab)
    n = keys.numel()
    rows = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(n, dtype=torch.uint8, device=dev)
    for lo in range(0, n, _BLOCK):
        hi = min(lo + _BLOCK, n)
        rows[lo:hi] = keys[lo:hi] % vocab
        idx = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        counts[lo:hi] = 1 + ((hash_words(seed, _COUNT, idx) * 7) >> 32)
    return offsets, rows, counts


def corpus_from_csc(offsets: np.ndarray, rows: np.ndarray,
                    counts: np.ndarray, vocab_size: int) -> Corpus:
    """The training Corpus of CSC arrays (offsets (docs + 1,), rows sorted
    within each doc, counts), equal bit for bit to Corpus.from_entries of
    the same entries with sort_dedup=False: the same doc sums (a float64
    cumsum sampled at the offsets), avg_doc_sz and values, without the
    per-entry doc ids and np.add.at of the offsets."""
    offsets = np.asarray(offsets, np.int64)
    counts = np.asarray(counts)
    num_docs = len(offsets) - 1
    lengths = np.diff(offsets)
    doc_sums = np.zeros(num_docs, dtype=np.float32)
    if offsets[-1]:
        cs = np.empty(len(counts) + 1, np.float64)
        cs[0] = 0.0
        np.cumsum(counts, dtype=np.float64, out=cs[1:])
        doc_sums = (cs[offsets[1:]] - cs[offsets[:-1]]).astype(np.float32)
        del cs
    nz_docs = int((lengths > 0).sum())
    total = int(counts.sum(dtype=np.uint64)
                if np.issubdtype(counts.dtype, np.integer)
                else counts.astype(np.uint64).sum())
    avg_doc_sz = float(np.float32(total // max(nz_docs, 1)))
    fcounts = counts.astype(np.float32)
    vals = fcounts / np.repeat(doc_sums, lengths)
    np.multiply(np.float32(avg_doc_sz), vals, out=vals)
    return Corpus(vocab_size=int(vocab_size), num_docs=num_docs,
                  offsets=offsets, rows=np.asarray(rows, np.int32),
                  counts=fcounts, vals=vals, avg_doc_sz=avg_doc_sz,
                  nz_docs=nz_docs)
