"""Per-word frequency thresholds (the ζ_w cutoffs): the port of
isle_tpu/thresholds.py.

Every rounded normalized frequency lies in [0, F] with F = round(avg_doc_sz)
+ 1, so ζ comes from a (vocab, F+1) histogram, a reversed cumulative sum
and row-wise masked maxima (see isle_tpu/thresholds.py for the reference
semantics this reproduces). The histogram is exact int32 counts from
segsum_onehot on the word-sorted stream.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .segsum import DEFAULT_CHUNK, segsum_onehot
from .sparse import DocSparse


def freq_bound(avg_doc_sz: float) -> int:
    """Upper bound F on rounded normalized frequencies."""
    return int(np.floor(avg_doc_sz + 0.5)) + 1


def hist_cols(w_val: torch.Tensor, F: int) -> torch.Tensor:
    """Histogram column per entry: round-half-away(val) clipped to [0, F]."""
    return torch.clamp(torch.floor(w_val + 0.5), 0, F).to(torch.int32)


def zeta_from_hist(hist: torch.Tensor, count_gr: int, count_eq: int,
                   few_drop: bool = False, bad_drop: bool = False):
    """ζ selection from a (vocab, F+1) histogram whose column v counts the
    entries that round to v (column 0 zeroed): the torch form of
    isle_tpu.thresholds._zeta_from_hist. Returns (zeta, nnz_per_word);
    zeta is int64 unless a drop flag is set, then float32 with +inf for
    dropped words."""
    F1 = hist.shape[1]
    n_ge = torch.flip(torch.cumsum(torch.flip(hist, [1]), dim=1), [1])
    size = n_ge[:, 1] if F1 > 1 else torch.zeros_like(n_ge[:, 0])
    v_idx = torch.arange(F1, device=hist.device)[None, :]
    start = torch.where(n_ge >= count_gr, v_idx, 0).amax(dim=1)
    eligible = (
        (hist > 0) & (hist < count_eq) & (v_idx <= start[:, None])
        & (v_idx >= 1)
    )
    zeta = torch.where(eligible, v_idx, 0).amax(dim=1)
    absent = size == 0
    too_few = (count_gr > size) & ~absent
    exhausted = (zeta == 0) & ~too_few & ~absent
    zeta = torch.where(zeta == 0, 1, zeta)
    zeta = torch.where(too_few, 1, zeta)
    zeta = torch.where(absent, 1, zeta)
    nnz_per_word = torch.take_along_dim(
        n_ge, torch.clamp(zeta, max=F1 - 1)[:, None], dim=1
    )[:, 0]
    nnz_per_word = torch.where(absent, 0, nnz_per_word)
    if few_drop or bad_drop:
        drop = (too_few & few_drop) | (exhausted & bad_drop)
        zeta = torch.where(drop, torch.inf, zeta.to(torch.float32))
        nnz_per_word = torch.where(drop, 0, nnz_per_word)
    return zeta, nnz_per_word


def compute_thresholds(
    A: DocSparse,
    avg_doc_sz: float,
    nz_docs: int,
    num_topics: int,
    hyper,
    seg_chunk: int = DEFAULT_CHUNK,
) -> Tuple[torch.Tensor, int]:
    """Returns (zetas float32[vocab] on A's device, post-threshold nnz)."""
    F = freq_bound(avg_doc_sz)
    hist = segsum_onehot(
        A.w_word, hist_cols(A.w_val, F), None, A.vocab, F + 1,
        chunk=seg_chunk,
    )[: A.vocab]
    hist[:, 0] = 0
    zeta, nnz_w = zeta_from_hist(
        hist,
        hyper.count_gr(nz_docs, num_topics),
        hyper.count_eq(nz_docs, num_topics),
        few_drop=hyper.few_samples_threshold_drop,
        bad_drop=hyper.bad_threshold_drop,
    )
    return zeta.to(torch.float32), int(nnz_w.sum())
