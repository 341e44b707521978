"""Segment-sum inputs made with numpy from a seed, shared by the port's CPU
tests and its card-only tests (this module imports no jax: the card's host
has none)."""

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


def gather_case(seed, n=8 * CHUNK, S=300, rows=90, W=5):
    rng = np.random.default_rng(seed)
    seg = sorted_stream(rng, n, S, avg_run=12)
    idx = rng.integers(0, rows + 10, n).astype(np.int32)  # >= rows: no row
    val = rng.random(n).astype(np.float32) + 0.5
    table = rng.random((rows, W)).astype(np.float32)
    return seg, idx, val, table, S


def t(x):
    return None if x is None else torch.from_numpy(x)
