"""Shared inputs for the tests that hold isle_tpu_torch against isle_tpu:
a draw source replaying isle_tpu's jax.random key schedule, the
reference configurations (COO, and the hybrid layout with a partial
head), and two small corpora made with numpy from a seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from isle_tpu.config import TpuConfig
from isle_tpu.corpus import Corpus

# The isle_tpu configuration the port is held against: the COO layout
# (no hybrid dense head), both Pallas segment sums forced on (interpret
# mode on the CPU, with real plans at a 256-entry chunk), a small SpMM
# chunk so padding stays small, and the host-driven block_ks loop.
REFERENCE_TPU = TpuConfig(
    dense_head_bytes=0, pallas_segsum="on", pallas_chunk=256,
    spmm_chunk=1 << 12, device_loop_solver=False,
)

# The same with isle_tpu's default eigensolver loop, block_ks_device (the
# port's GpuConfig default): the tests of the port's device loop.
REFERENCE_TPU_DEVICE_LOOP = dataclasses.replace(REFERENCE_TPU,
                                                device_loop_solver=True)

# The same with the hybrid layout, isle_tpu's default engine, at a head
# budget that leaves the head PARTIAL at test size (the default 4 GiB
# would put every word in it): 48 of golden_corpus's 400 words, 30 of
# biting_corpus's 200 (24,000 bytes over 250 or 400 docs of 2 bytes).
HEAD_BYTES = 24_000
REFERENCE_TPU_HYBRID = dataclasses.replace(REFERENCE_TPU,
                                           dense_head_bytes=HEAD_BYTES)
REFERENCE_TPU_HYBRID_DEVICE_LOOP = dataclasses.replace(
    REFERENCE_TPU_HYBRID, device_loop_solver=True)


class JaxDraws:
    """isle_tpu_torch.rng.Draws replaying isle_tpu's key schedule:
    PRNGKey(seed) split once for B (trainer.py:377; the sampling
    uniforms, bmatrix.py:59), once for the eigensolver (:433; Lanczos draws
    its start vector from that key and each step's refill direction from
    the key folded with the step index, linalg.py:521, :472) and once for
    k-means (:478). kmeans.py:156 splits per seeding rep; every seeding
    splits the rep key for its first center (:50, :196, :364) and then
    draws from the rest of it: k-means++ and k-means|| split it for each
    round (:101, :208), k-means|| hands a split to its weighted k-means++
    (:236), which splits for each pick (:247, :256), and AFK-MC^2 splits
    it for each chain (:393) and that again for its proposals and
    uniforms (:303)."""

    def __init__(self, seed: int, streamed_sampling: bool = False):
        """streamed_sampling: the schedule of isle_tpu's StreamedTrainer
        with sample_docs, which splits once more between the sampling and
        the eigensolver (streaming.py:1204, :1215)."""
        key = jax.random.PRNGKey(seed)
        key, self._b = jax.random.split(key)
        if streamed_sampling:
            key, _ = jax.random.split(key)
        key, self._eig = jax.random.split(key)
        key, self._km = jax.random.split(key)

    @classmethod
    def from_keys(cls, eig=None, km=None, b=None, loop=None):
        """The draws of a block_ks call given `key=eig`, of a
        kmeans_init_on_projected call given `key=km`, of a
        threshold_and_copy call given `key=b`, and of a routine handed
        `key=loop` directly (a weighted k-means++ or one seeding rep)."""
        d = cls.__new__(cls)
        d._eig, d._km, d._b, d._loop = eig, km, b, loop
        return d

    def doc_sample_uniforms(self, num_docs):
        return _to_torch(jax.random.uniform(self._b, (num_docs,),
                                            dtype=jnp.float32))

    def krylov_start(self, dim, blk):
        return _to_torch(jax.random.normal(self._eig, (dim, blk), jnp.float32))

    def lanczos_start(self, dim):
        return _to_torch(jax.random.normal(self._eig, (dim,), jnp.float32))

    def lanczos_refill(self, j, dim):
        # linalg.py:472: the key folded with the step index
        return _to_torch(jax.random.normal(
            jax.random.fold_in(self._eig, j), (dim,), jnp.float32))

    def seeding_first(self, num_docs):
        self._km, rep = jax.random.split(self._km)
        self._loop, sub = jax.random.split(rep)
        return int(jax.random.randint(sub, (), 0, num_docs))

    def _sub(self):
        self._loop, sub = jax.random.split(self._loop)
        return sub

    def uniform(self, n):
        return _to_torch(jax.random.uniform(self._sub(), (n,), jnp.float32))

    def fork(self):
        return JaxDraws.from_keys(loop=self._sub())

    def categorical(self, weights):
        logits = jnp.log(jnp.maximum(jnp.asarray(_np(weights)), 1e-30))
        return int(jax.random.categorical(self._sub(), logits))

    def mcmc_proposals(self, q, n):
        s1, s2 = jax.random.split(self._sub())
        idx = jax.random.categorical(s1, jnp.log(jnp.asarray(_np(q))),
                                     shape=(n,))
        return (_to_torch(idx).long(),
                _to_torch(jax.random.uniform(s2, (n,))))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def golden_corpus():
    """The corpus of tests/test_golden.py (V=400, D=250, k=5)."""
    rng = np.random.default_rng(42)
    V, D, k = 400, 250, 5
    docs, words, counts = [], [], []
    for d in range(D):
        band = d % k
        n = int(rng.integers(10, 40))
        ws = np.unique(np.concatenate([
            rng.integers(band * 60, band * 60 + 60, n // 2),
            rng.integers(0, V, n - n // 2),
        ]))
        for w in np.sort(ws):
            docs.append(d)
            words.append(int(w))
            counts.append(int(rng.integers(1, 6)))
    return Corpus.from_entries(
        np.array(docs), np.array(words), np.array(counts),
        vocab_size=V, num_docs=D,
    )


def biting_corpus(seed: int = 0, V: int = 200, D: int = 400, k: int = 4,
                  nc: int = 12):
    """A corpus where thresholding bites: the nc common words sit in most
    docs with heavy-tailed counts, so their ζ lands well above 1 (about
    20-32), and every 20th doc holds each common word once, so all its
    values (avg_doc_sz / nc) fall under ζ and the doc is dropped. With
    few_samples_threshold_drop the rare words get ζ = +inf as well."""
    rng = np.random.default_rng(seed)
    docs, words, counts = [], [], []
    for d in range(D):
        if d % 20 == 19:
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
    return Corpus.from_entries(
        np.array(docs), np.array(words), np.array(counts),
        vocab_size=V, num_docs=D,
    )
