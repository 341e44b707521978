"""Segment-sum inputs and small corpora made with numpy from a seed, shared
by the port's CPU tests and its card-only tests (this module imports no
jax: the card's host has none)."""

import numpy as np
import torch

CHUNK = 256


def sorted_stream(rng, n, num_segments, avg_run):
    """Sorted segment ids, ~avg_run entries per present segment, padded
    with a spill tail (id == num_segments) — tests/test_pallas_ops.py."""
    ids = np.sort(
        rng.choice(num_segments, size=max(1, n // avg_run), replace=False)
    )
    runs = rng.poisson(avg_run - 1, size=len(ids)) + 1
    seg = np.repeat(ids, runs)[:n]
    if len(seg) < n:
        seg = np.concatenate(
            [seg, np.full(n - len(seg), num_segments, np.int64)]
        )
    return np.sort(seg).astype(np.int32)


def onehot_case(seed, with_val, n=8 * CHUNK, S=500, k=7):
    rng = np.random.default_rng(seed)
    seg = sorted_stream(rng, n, S, avg_run=20)
    col = rng.integers(-1, k, n).astype(np.int32)  # -1 = masked out
    val = (rng.random(n).astype(np.float32) + 0.5) if with_val else None
    return seg, col, val, S, k


ONEHOT_KINDS = ["wide", "head", "masked", "beyond", "init", "nocol"]


def onehot_kind_case(kind, with_val, n=8 * CHUNK, S=500):
    """segsum_onehot inputs past onehot_case's mixed stream, one per kind:
    "wide" (635 columns, the ζ histogram's width), "head" (one segment
    holds 60% of the entries, across many chunk edges), "masked" (every
    column -1), "beyond" (a fifth of the entries in segments past the
    spill row S, which add nothing), "init" (a carried-in output) and
    "nocol" (one column, every col 0: the port's col=None).
    Returns (seg, col, val, S, ncols, init)."""
    rng = np.random.default_rng(10 + ONEHOT_KINDS.index(kind))
    k = {"wide": 635, "nocol": 1}.get(kind, 7)
    seg = sorted_stream(rng, n, S, avg_run=20)
    if kind == "head":
        seg[rng.random(n) < 0.6] = 123
        seg = np.sort(seg)
    if kind == "beyond":
        past = rng.random(n) < 0.2
        seg = np.sort(np.where(past, S + 1 + rng.integers(0, 5, n), seg))
    col = rng.integers(-1, k, n).astype(np.int32)
    if kind == "masked":
        col[:] = -1
    if kind == "nocol":
        col[:] = 0
    val = (rng.random(n).astype(np.float32) + 0.5) if with_val else None
    init = None
    if kind == "init":
        init = (rng.random((S + 1, k)).astype(np.float32) if with_val
                else rng.integers(0, 9, (S + 1, k)).astype(np.int32))
    return seg.astype(np.int32), col, val, S, k, init


def gather_case(seed, n=8 * CHUNK, S=300, rows=90, W=5):
    rng = np.random.default_rng(seed)
    seg = sorted_stream(rng, n, S, avg_run=12)
    idx = rng.integers(0, rows + 10, n).astype(np.int32)  # >= rows: no row
    val = rng.random(n).astype(np.float32) + 0.5
    table = rng.random((rows, W)).astype(np.float32)
    return seg, idx, val, table, S


def t(x):
    return None if x is None else torch.from_numpy(x)


def dead_tail_entries(seed=0, V=200, D=400, k=4, nc=12, dead_from=300):
    """(docs, words, counts) of tests/torch_parity.biting_corpus with a
    dead tail: thresholding bites (the nc common words get ζ well above 1
    and every 20th doc is dropped), and the docs from `dead_from` on hold
    each common word once, so every one of them falls under ζ: the ranks
    that own only such docs keep none of them in B."""
    rng = np.random.default_rng(seed)
    docs, words, counts = [], [], []
    for d in range(D):
        if d % 20 == 19 or d >= dead_from:
            ws, c = np.arange(nc), np.ones(nc, np.int64)
        else:
            band = d % k
            n = int(rng.integers(6, 20))
            ws = np.unique(np.concatenate([
                np.flatnonzero(rng.random(nc) < 0.8),
                nc + rng.integers(band * 40, band * 40 + 40, n // 2),
                rng.integers(nc, V, n - n // 2),
            ]))
            c = rng.integers(1, 4, len(ws))
            common = ws < nc
            c[common] = rng.geometric(0.06, int(common.sum()))
        docs += [d] * len(ws)
        words += ws.tolist()
        counts += c.tolist()
    return np.array(docs), np.array(words), np.array(counts)


# name: (entries kind, Corpus.from_entries options, the counts dtype the
# resident loader takes, None for its vals form)
RESIDENT_CORPORA = {
    "uint8": ("uint8", {}, np.uint8),
    "uint16": ("uint16", {}, np.uint16),
    "int32": ("int32", {}, np.int32),
    "tf_idf": ("uint8", dict(tf_idf=True), np.uint8),
    "unit_mass": ("uint8", dict(normalize_to_one=True), None),
    "int_normalized": ("uint8", dict(int_normalized=True), None),
}


def resident_entries(kind: str, seed: int = 17):
    """(docs, words, counts, V, D) with every fourth doc empty: counts of
    1-7, or with a few large ones that need uint16 or int32."""
    rng = np.random.default_rng(seed)
    V, D = 50, 160
    d = rng.integers(0, D, 1300)
    d = np.sort(d[d % 4 != 3])
    w = rng.integers(0, V, len(d))
    key = np.unique(d.astype(np.int64) * V + w)
    d, w = key // V, key % V
    c = rng.integers(1, 8, len(key))
    big = rng.choice(len(key), 5, replace=False)
    if kind == "uint16":
        c[big] = rng.integers(256, 65536, 5)
    elif kind == "int32":
        c[big] = rng.integers(65536, 1 << 20, 5)
    return d, w, c, V, D


def resident_corpus(name: str):
    """RESIDENT_CORPORA[name] as the port's Corpus."""
    from isle_tpu_torch.corpus import Corpus

    kind, opts, _ = RESIDENT_CORPORA[name]
    d, w, c, V, D = resident_entries(kind)
    return Corpus.from_entries(d, w, c, vocab_size=V, num_docs=D, **opts)


def csc_corpus(lengths, vocab=80, seed=0):
    """A corpus.Corpus of the given doc lengths (CSC): each doc's distinct
    word ids sorted, positive float32 values, no counts."""
    from isle_tpu_torch.corpus import Corpus

    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    rows = np.concatenate([np.sort(rng.choice(vocab, n, replace=False))
                           for n in lengths]).astype(np.int32)
    vals = (rng.random(rows.size) + 0.25).astype(np.float32)
    return Corpus(vocab_size=vocab, num_docs=lengths.size, offsets=offsets,
                  rows=rows, counts=None, vals=vals, avg_doc_sz=1.0,
                  nz_docs=int((lengths > 0).sum()))
