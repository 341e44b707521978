"""Elkan's triangle-inequality k-means over several ranks: the port of
isle_tpu/elkans_sharded.py (sharded_run_elkans) on top of elkans.py.

Every ingredient of Elkan's is local to the rank that holds a doc, or
replicated:

  - a doc's state (assignment, upper bound, k lower bounds) lives with
    its rank;
  - the bounds filter and the exact distances of the flagged docs are
    local: a doc's entries never leave its rank and the centers are on
    every rank;
  - only the center update communicates, the all-reduced one-hot product
    of the sharded Lloyd's step (sharding.sharded_update_centers), and
    the stop is an all-reduced count, so every rank leaves the loop in
    the same rep.

isle_tpu sizes the mini pass of a rep by the cross-shard maximum of the
flagged docs and entries (make_elkans_mini, :204-213), because shard_map
runs one program of static shapes on every device. Here each rank's mini
stream has exactly the size of its own flagged docs, and a rank with none
skips the pass: nothing in it is a collective.

The same fixpoint as Lloyd's up to exact-tie ordering (elkans.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .elkans import run_elkans
from .segsum import DEFAULT_CHUNK
from .sharding import Mesh, ShardedDocSparse, gather_assignment, mesh_hooks


def sharded_run_elkans(ssp: ShardedDocSparse, centers: torch.Tensor,
                       max_reps: int, mesh: Mesh, timer=None,
                       chunk: int = DEFAULT_CHUNK
                       ) -> Tuple[torch.Tensor, np.ndarray]:
    """The return contract of sharding.sharded_run_lloyds_full: (centers
    (k, vocab) on every rank, assign: host (num_docs,) int32 in B's doc
    order)."""
    centers, assign = run_elkans(
        ssp.local, centers, max_reps, timer=timer, chunk=chunk,
        **mesh_hooks(ssp, mesh))
    return centers, gather_assignment(assign, mesh)
