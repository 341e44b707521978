"""Construction of the thresholded, sqrt-scaled matrix B from the
normalized corpus A, with optional importance sampling of documents: the
port of isle_tpu.bmatrix.threshold_and_copy (reference
src/sparseMatrix.cpp:1285-1435).

Keep entries with round(val) >= ζ[word], set their value to sqrt(ζ[word]),
drop documents left empty and renumber the rest in order; original_cols
maps the new column ids to the original doc ids. Both sort orders are
compacted with boolean masks; the renumbering is monotone, so the
word-sorted copy stays sorted by (word, new doc).

Sampling (sampled_threshold_and_copy, src/sparseMatrix.cpp:1365-1435):
a doc's weight is the sum of ζ over its surviving entries; an exponential
race dice = u^(1/weight) (0 for weight 0) keeps the top sample_rate
fraction: pivot = the floor(sample_rate * num_docs)-th largest dice,
clamped to the last doc (so a rate >= 1 keeps every doc), and docs with
dice >= pivot stay. The uniforms u come from the draw source.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .segsum import segsum_onehot
from .sparse import DocSparse


def doc_dice(weights: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Each doc's dice u^(1/weight) of the exponential race (0 for weight
    0)."""
    u = uniforms.to(device=weights.device, dtype=torch.float32)
    return torch.where(
        weights > 0.0,
        torch.pow(u, 1.0 / torch.clamp(weights, min=1e-30)), 0.0)


def dice_select(weights: torch.Tensor, sample_rate: float,
                uniforms: torch.Tensor) -> torch.Tensor:
    """The exponential race over per-doc weights
    (src/sparseMatrix.cpp:1399-1417): a boolean mask of the docs whose
    dice reach the pivot."""
    D = weights.numel()
    dice = doc_dice(weights, uniforms)
    pivot_index = min(int(sample_rate * D), D - 1)
    pivot = torch.sort(dice, descending=True).values[pivot_index]
    return dice >= pivot


def doc_weights(A: DocSparse, keep_d: torch.Tensor,
                zetas: torch.Tensor) -> torch.Tensor:
    """Each doc's sampling weight: a segment sum of its kept entries' ζ
    (column -1 drops an entry), summed in a fixed order on the card."""
    D = A.num_docs
    col = torch.where(keep_d, 0, -1).to(torch.int32)
    return segsum_onehot(A.d_doc, col, zetas[A.d_word], D, 1)[:D, 0]


def sample_select(A: DocSparse, keep_d: torch.Tensor, zetas: torch.Tensor,
                  sample_rate: float, uniforms: torch.Tensor) -> torch.Tensor:
    """Importance-sampled doc selection (src/sparseMatrix.cpp:1383-1417).
    Returns a boolean per-doc mask."""
    return dice_select(doc_weights(A, keep_d, zetas), sample_rate, uniforms)


def threshold_and_copy(
    A: DocSparse, zetas: torch.Tensor, sample_rate: Optional[float] = None,
    uniforms: Optional[torch.Tensor] = None,
    docs: Optional[np.ndarray] = None,
) -> Tuple[DocSparse, np.ndarray]:
    """Returns (B, original_cols host int32 array). With sample_rate,
    `uniforms` holds the (num_docs,) draws of the sampling. With `docs`
    (the original_cols of a checkpoint), B keeps only those docs: a
    resumed run rebuilds the selection it checkpointed, drawn by whichever
    source wrote it, instead of drawing anew."""
    zetas = zetas.to(device=A.device, dtype=torch.float32)
    sel = None
    if docs is not None:
        sel = docs_mask(docs, A.num_docs, A.device)
    elif sample_rate is not None:
        keep_d = torch.floor(A.d_val + 0.5) >= zetas[A.d_word]
        sel = sample_select(A, keep_d, zetas, sample_rate, uniforms)
    return copy_kept(A, zetas, sel)


def docs_mask(docs: np.ndarray, num_docs: int, device) -> torch.Tensor:
    """(num_docs,) bool on `device`: True at the doc ids `docs`."""
    sel = torch.zeros(num_docs, dtype=torch.bool, device=device)
    sel[torch.as_tensor(np.asarray(docs), dtype=torch.long).to(device)] = True
    return sel


def copy_kept(A: DocSparse, zetas: torch.Tensor,
              sel: Optional[torch.Tensor] = None
              ) -> Tuple[DocSparse, np.ndarray]:
    """B from the entries of A that reach their word's ζ, of the docs
    where `sel` (a (num_docs,) bool mask; None: every doc) is True.
    Returns (B, original_cols): the docs left non-empty, renumbered in
    order."""
    keep_d = torch.floor(A.d_val + 0.5) >= zetas[A.d_word]
    keep_w = torch.floor(A.w_val + 0.5) >= zetas[A.w_word]
    if sel is not None:
        keep_d &= sel[A.d_doc]
        keep_w &= sel[A.w_doc]
    occ = torch.zeros(A.num_docs, dtype=torch.bool, device=A.device)
    occ[A.d_doc[keep_d]] = True
    new_doc = (torch.cumsum(occ, 0) - 1).to(torch.int32)
    original_cols = torch.nonzero(occ)[:, 0].to(torch.int32).cpu().numpy()
    sz = torch.sqrt(zetas)

    def compact(word, doc, keep):
        w = word[keep]
        return w, new_doc[doc[keep]], sz[w]

    dw, dd, dv = compact(A.d_word, A.d_doc, keep_d)
    ww, wd, wv = compact(A.w_word, A.w_doc, keep_w)
    B = DocSparse(
        d_word=dw, d_doc=dd, d_val=dv, w_word=ww, w_doc=wd, w_val=wv,
        vocab=A.vocab, num_docs=len(original_cols),
    )
    return B, original_cols
