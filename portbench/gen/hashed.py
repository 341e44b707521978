"""The benchmark's frozen copy of the port's hashed corpus generator
(isle_tpu_torch/synth.py: synth_corpus_hashed and what it calls): a
counter-based integer hash gives the same bits on the CPU and on the
card, so a seed makes the same corpus anywhere. The recipe is the one of
the repository's bench.py corpus: Zipf(1) words over the vocabulary, half
of the draws Zipf(1) inside the doc's band d % 64 of vocab // 64 words,
the (doc, word) pairs made distinct, counts uniform in [1, 7].

Kept here, and not imported from the port, because the benchmark's
traffic may not change when the program does. portbench/tests holds it
bit-equal to the port's copy.
"""

from __future__ import annotations

import numpy as np
import torch

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
