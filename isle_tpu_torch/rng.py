"""Random draws of the training pipeline, behind one small source object.

isle_tpu draws randomness with jax.random in these places: the document
sampling uniforms (isle_tpu/bmatrix.py:59), the Krylov start block
(isle_tpu/linalg.py:63), the Lanczos start vector and refill directions
(isle_tpu/linalg.py:521, :472) and the seedings of isle_tpu/kmeans.py: each
rep's first center (:50-51, :197, :365), the k-means++ dice (:101-102),
the k-means|| round uniforms (:209), the weighted k-means++ picks of
k-means|| (:248, :258) and the AFK-MC^2 proposals (:304, :315). The port
asks a draw source for exactly those, in the same order, so a test can
swap in a source that replays isle_tpu's key schedule and hold the port
against the reference draw for draw. `Draws` is the default source: CPU
torch.Generators seeded from TrainConfig.seed, so a seed gives the same
draws on the CPU and on the card. As the reference splits one key per
stage, the sampling, the Krylov start and the seedings each draw from a
stream of their own: a run resumed after a stage draws what the
uninterrupted run drew after it. Every draw returns CPU tensors or
Python ints.
"""

from __future__ import annotations

import torch


def _generator(seed: int) -> torch.Generator:
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return gen


class Draws:
    def __init__(self, seed: int):
        root = _generator(int(seed))
        self._b, self._eig, self._km = (
            _generator(int(torch.randint(1 << 62, (), generator=root)))
            for _ in range(3)
        )

    def doc_sample_uniforms(self, num_docs: int) -> torch.Tensor:
        """(num_docs,) float32 uniforms in [0, 1) for the importance
        sampling of documents."""
        return torch.rand(num_docs, generator=self._b, dtype=torch.float32)

    def krylov_start(self, dim: int, blk: int) -> torch.Tensor:
        """(dim, blk) float32 standard normals."""
        return torch.randn(dim, blk, generator=self._eig, dtype=torch.float32)

    def lanczos_start(self, dim: int) -> torch.Tensor:
        """(dim,) float32 standard normals: the Lanczos start vector."""
        return torch.randn(dim, generator=self._eig, dtype=torch.float32)

    def lanczos_refill(self, j: int, dim: int) -> torch.Tensor:
        """(dim,) float32 standard normals: the direction Lanczos step `j`
        continues with when its recurrence breaks down. Called for those
        steps only, in step order."""
        return torch.randn(dim, generator=self._eig, dtype=torch.float32)

    def seeding_first(self, num_docs: int) -> int:
        """First center of a seeding rep, uniform over [0, num_docs).
        Called once per rep of every seeding method, before its other
        draws."""
        return int(torch.randint(num_docs, (), generator=self._km))

    def uniform(self, n: int) -> torch.Tensor:
        """(n,) float32 uniforms in [0, 1): one k-means++ round's dice or
        one k-means|| round's per-doc coins."""
        return torch.rand(n, generator=self._km, dtype=torch.float32)

    def fork(self) -> "Draws":
        """The source for a nested routine that the reference hands its
        own key (k-means||'s weighted k-means++); here the same stream."""
        return self

    def categorical(self, weights: torch.Tensor) -> int:
        """One index drawn with probability proportional to
        max(weights, 1e-30) (a (n,) float32 tensor)."""
        p = torch.clamp(weights.detach().cpu().double(), min=1e-30)
        return int(torch.multinomial(p, 1, generator=self._km))

    def mcmc_proposals(self, q: torch.Tensor, n: int):
        """One AFK-MC^2 chain's batch: (n,) int64 indices drawn with
        replacement from the distribution q, and (n,) float32 uniforms."""
        idx = torch.multinomial(q.detach().cpu().double(), n,
                                replacement=True, generator=self._km)
        return idx, torch.rand(n, generator=self._km, dtype=torch.float32)
