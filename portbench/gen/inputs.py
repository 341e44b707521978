"""The benchmark's inputs, made from --seed on the device: the corpus of a
configuration (the frozen hashed generator), its normalized values, the
inference model, and the doc ranges of a traffic mix. Both the program
and the plain reference get these same arrays."""

from __future__ import annotations

import numpy as np
import torch

from . import hashed

BANDS = 64  # the generator's planted word bands
_M32 = 0xFFFFFFFF


def gen_seed(seed: int) -> int:
    """The generator's 32-bit seed of a run's --seed (any whole number)."""
    return int(seed) & _M32


def stream_seed(seed: int, stream: int) -> int:
    """A seed for a torch.Generator of one purpose (the model, a sample),
    mixed from --seed so that the purposes draw apart."""
    return int(hashed.hash_words(gen_seed(seed), 100 + stream,
                                 torch.tensor([0]))[0])


def corpus_csc(shape: dict, seed: int, device) -> tuple:
    """(offsets int64 (docs + 1,), rows int32, counts uint8) on `device`:
    the configuration's corpus, shape["nnz_target"] giving the draws."""
    return hashed.synth_corpus_hashed(
        shape["vocab"], shape["docs"], shape["nnz_target"], gen_seed(seed),
        device)


def normalized(offsets: torch.Tensor, counts: torch.Tensor,
               unit: bool) -> dict:
    """ISLE's normalized values of a CSC corpus, in float32 as the
    reference's loader makes them (src/sparseMatrix.cpp): each count over
    its doc's sum of counts, times avg_doc_sz (the integer division of all
    counts by the non-empty docs) unless `unit` (inference's unit mass).
    Returns {vals, doc_sums (float32, per doc), avg_doc_sz, nz_docs}."""
    lengths = offsets[1:] - offsets[:-1]
    cs = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                     device=counts.device)
    torch.cumsum(counts.to(torch.int64), 0, out=cs[1:])
    sums = (cs[offsets[1:]] - cs[offsets[:-1]]).to(torch.float32)
    nz_docs = int((lengths > 0).sum())
    total = int(cs[-1])
    avg_doc_sz = float(np.float32(total // max(nz_docs, 1)))
    vals = counts.to(torch.float32) / torch.repeat_interleave(sums, lengths)
    if not unit:
        vals *= np.float32(avg_doc_sz)
    return dict(vals=vals, doc_sums=sums, avg_doc_sz=avg_doc_sz,
                nz_docs=nz_docs)


def topic_model(vocab: int, k: int, seed: int, device) -> torch.Tensor:
    """(vocab, k) float32 column-stochastic topic model from the seed, with
    the generator's word laws: topic t is half Zipf(1) over the vocabulary
    and half Zipf(1) inside band t % 64, each entry times a log-normal
    factor exp(N(0, 1/4)); 2% of the words (drawn) have no mass in any
    topic, so inference drops them as it drops words a trained model
    lacks."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(stream_seed(seed, 0))
    bsz = max(vocab // BANDS, 1)
    v = torch.arange(vocab, dtype=torch.float64, device=dev)
    base = 1.0 / (v + 1.0)
    base /= base.sum()
    band_of = torch.div(v, bsz, rounding_mode="floor")[:, None]
    t_band = (torch.arange(k, device=dev) % BANDS)[None, :]
    rank = v[:, None] - t_band * bsz
    band = torch.where(band_of == t_band, 1.0 / (rank + 1.0), 0.0)
    band /= band.sum(dim=0, keepdim=True)
    noise = torch.exp(0.5 * torch.randn(vocab, k, generator=g, device=dev,
                                         dtype=torch.float64))
    keep = torch.rand(vocab, generator=g, device=dev,
                      dtype=torch.float64) >= 0.02
    M = (0.5 * base[:, None] + 0.5 * band) * noise * keep[:, None]
    M /= M.sum(dim=0, keepdim=True)
    return M.to(torch.float32)


def doc_ranges(docs: int, n: int) -> list:
    """n contiguous [lo, hi) doc ranges covering the corpus, as ISLEInfer's
    doc_begin / doc_end cut a file."""
    edges = [docs * i // n for i in range(n + 1)]
    return list(zip(edges[:-1], edges[1:]))


def sample_docs(seed: int, lo: int, hi: int, lengths: np.ndarray,
                count: int, longest: int, stream: int) -> np.ndarray:
    """Sorted doc ids in [lo, hi) to compare: `count` drawn from the seed
    and the `longest` docs of the range (`lengths`: the range's doc
    lengths)."""
    g = torch.Generator()
    g.manual_seed(stream_seed(seed, 1 + stream))
    n = hi - lo
    drawn = torch.randperm(n, generator=g)[:min(count, n)].numpy()
    top = np.argsort(-lengths, kind="stable")[:min(longest, n)]
    return lo + np.unique(np.concatenate([drawn, top]))
