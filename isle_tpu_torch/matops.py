"""The SpMM surface the middle stages call, dispatched on B's layout: the
port of isle_tpu/matops.py:26-53 and mat_to_dense (:145-205). The
eigensolver, the projection, the seeding copy and Lloyd's or Elkan's run
the same code on the COO layout (sparse.DocSparse) and on the hybrid
layout (hybrid.HybridSparse). The sharded layouts (sharding.py) hold one
of the two as this rank's `local` part and call these on it.

mat_bt_x_blockwise, isle_tpu's verification path for
use_explicit_projected_matrix=False, has no counterpart: bt_x streams B
without a (docs, width) intermediate, so the option is the same product.
"""

from __future__ import annotations

import numpy as np
import torch

from .hybrid import HybridSparse, h_b_y, h_bt_x, h_doc_l2sq, h_gram_x, \
    h_spmm_flops, h_to_dense
from .segsum import DEFAULT_CHUNK
from .sparse import b_y, bt_x, doc_l2sq, gram_x, spmm_flops, to_dense


def mat_bt_x(m, X: torch.Tensor, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """B^T X, (num_docs, W)."""
    if isinstance(m, HybridSparse):
        return h_bt_x(m, X, chunk)
    return bt_x(m, X, chunk)


def mat_b_y(m, Y: torch.Tensor, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """B Y, (vocab, W)."""
    if isinstance(m, HybridSparse):
        return h_b_y(m, Y, chunk)
    return b_y(m, Y, chunk)


def mat_gram_x(m, X: torch.Tensor, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """(B B^T) X."""
    if isinstance(m, HybridSparse):
        return h_gram_x(m, X, chunk)
    return gram_x(m, X, chunk)


def mat_doc_l2sq(m, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Per-doc squared l2 norms, (num_docs,)."""
    if isinstance(m, HybridSparse):
        return h_doc_l2sq(m, chunk)
    return doc_l2sq(m, chunk)


def mat_spmm_flops(m, width: int) -> int:
    """FLOPs of one mat_bt_x or mat_b_y at `width`."""
    if isinstance(m, HybridSparse):
        return h_spmm_flops(m, width)
    return spmm_flops(m, width)


def mat_to_dense(m) -> np.ndarray:
    """Host float64 (vocab, num_docs) densification, for the dense
    eigensolver on small problems."""
    if isinstance(m, HybridSparse):
        return h_to_dense(m)
    return to_dense(m)
