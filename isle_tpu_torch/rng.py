"""Random draws of the training pipeline, behind one small source object.

isle_tpu draws randomness in three places: the Krylov start block
(isle_tpu/linalg.py:63), k-means++'s first doc (isle_tpu/kmeans.py:50-51)
and its per-round dice (isle_tpu/kmeans.py:101-102). The port asks a draw
source for exactly those, in the same order, so a test can swap in a
source that replays isle_tpu's jax.random key schedule and hold the port
against the reference draw for draw. `Draws` is the default source: one
CPU torch.Generator seeded from TrainConfig.seed, so a seed gives the same
draws on the CPU and on the card.
"""

from __future__ import annotations

import torch


class Draws:
    def __init__(self, seed: int):
        self.gen = torch.Generator(device="cpu")
        self.gen.manual_seed(int(seed))

    def krylov_start(self, dim: int, blk: int) -> torch.Tensor:
        """(dim, blk) float32 standard normals (CPU)."""
        return torch.randn(dim, blk, generator=self.gen, dtype=torch.float32)

    def kmeanspp_first(self, num_docs: int) -> int:
        """First k-means++ center, uniform over [0, num_docs). Called once
        per seeding rep, before that rep's rounds."""
        return int(torch.randint(num_docs, (), generator=self.gen))

    def kmeanspp_dice(self, n: int) -> torch.Tensor:
        """(n,) float32 uniforms in [0, 1) for one k-means++ round (CPU)."""
        return torch.rand(n, generator=self.gen, dtype=torch.float32)
