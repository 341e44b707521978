"""Construction of the thresholded, sqrt-scaled matrix B from the
normalized corpus A: the port of isle_tpu.bmatrix.threshold_and_copy
(reference src/sparseMatrix.cpp:1285-1362).

Keep entries with round(val) >= ζ[word], set their value to sqrt(ζ[word]),
drop documents left empty and renumber the rest in order; original_cols
maps the new column ids to the original doc ids. Both sort orders are
compacted with boolean masks; the renumbering is monotone, so the
word-sorted copy stays sorted by (word, new doc). Importance sampling of
documents is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .sparse import DocSparse


def threshold_and_copy(
    A: DocSparse, zetas: torch.Tensor
) -> Tuple[DocSparse, np.ndarray]:
    """Returns (B, original_cols host int32 array)."""
    zetas = zetas.to(device=A.device, dtype=torch.float32)
    keep_d = torch.floor(A.d_val + 0.5) >= zetas[A.d_word]
    occ = torch.zeros(A.num_docs, dtype=torch.bool, device=A.device)
    occ[A.d_doc[keep_d]] = True
    new_doc = (torch.cumsum(occ, 0) - 1).to(torch.int32)
    original_cols = torch.nonzero(occ)[:, 0].to(torch.int32).cpu().numpy()
    sz = torch.sqrt(zetas)

    def compact(word, doc, keep):
        w = word[keep]
        return w, new_doc[doc[keep]], sz[w]

    dw, dd, dv = compact(A.d_word, A.d_doc, keep_d)
    keep_w = torch.floor(A.w_val + 0.5) >= zetas[A.w_word]
    ww, wd, wv = compact(A.w_word, A.w_doc, keep_w)
    B = DocSparse(
        d_word=dw, d_doc=dd, d_val=dv, w_word=ww, w_doc=wd, w_val=wv,
        vocab=A.vocab, num_docs=len(original_cols),
    )
    return B, original_cols
