"""Batched multiplicative-weight-update (MWU) inference: the port of
isle_tpu/mwu.py (build_infer_batch, _mwu_core, infer_all), on one device
or doc-parallel over the ranks of a sharding.Mesh.

Reference semantics (src/infer.cpp:364-493):
  - per doc, words whose total model mass is <= 1e-10 are dropped from the
    slice; `words_in_doc` counts ALL words, the padded slots only the kept
    ones.
  - MWU: w starts uniform; per iteration t (0-based),
        grad = M^T (a / (M w)),  eta = sqrt(2 ln k / (t+1)) / Lf,
        w <- normalize(w * exp(eta * grad))
    after `iters` iterations a doc is converged iff sum(w) is finite,
    nonzero and within 0.01 of 1; a non-finite or zero sum doubles that
    doc's Lf and retries, up to `max_guesses` runs; a finite-but-off sum
    is settled as unconverged.
  - log-likelihood: s = sum_d a_d log((M w)_d); llh_per_doc = s *
    avg_doc_sz, llh_weighted = s * words_in_doc. Unconverged docs report
    uniform 1/k weights and (0, 0).

Docs are padded to a common width (pad slots gather the zero spill row V)
and processed in length buckets and blocks; a block's model rows are
gathered once and reused by every iteration and retry. The two
contractions are batched matvecs, here torch.bmm in full float32 (the
package turns TF32 off). The retry's overflow is a float32 overflow:
run the core in float32 to reproduce the reference's retries. MWU
reaches no Pallas kernel in isle_tpu, so nothing here is a CUDA kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MAX_NNZS = 20000  # include/infer.h:52


@dataclasses.dataclass
class InferBatch:
    """Host-side padded layout of the inference corpus."""

    word_idx: np.ndarray  # (num_docs, L) int32, pad = vocab
    a: np.ndarray  # (num_docs, L) float32, pad = 0
    words_in_doc: np.ndarray  # (num_docs,) int32 (pre-filter count)
    num_docs: int
    avg_doc_sz: float


def build_infer_batch(corpus, model_mass: np.ndarray,
                      pad_to: int = 8) -> InferBatch:
    """Pack a normalized-to-one corpus into padded per-doc arrays, dropping
    words with model mass <= 1e-10 (src/infer.cpp:375-386)."""
    offsets, rows, vals = corpus.offsets, corpus.rows, corpus.vals
    D, V = corpus.num_docs, corpus.vocab_size
    keep = model_mass[rows] > 1e-10
    lengths = np.diff(offsets)
    # the kept entries of each non-empty doc, an integer sum a doc
    kept_len = np.zeros(D, np.int64)
    nz = lengths > 0
    if len(rows):
        kept_len[nz] = np.add.reduceat(keep.view(np.uint8), offsets[:-1][nz],
                                       dtype=np.int64)
    L = int(max(kept_len.max() if D else 0, 1))
    L = ((L + pad_to - 1) // pad_to) * pad_to
    if L >= MAX_NNZS:
        raise ValueError(f"doc with {L} nnz exceeds MAX_NNZS={MAX_NNZS}")

    # a doc's kept entries fill its row from the start, in their order:
    # the filled slots in row-major order take the kept entries in order
    filled = np.arange(L) < kept_len[:, None]
    word_idx = np.full((D, L), V, np.int32)
    word_idx[filled] = rows[keep]
    a = np.zeros((D, L), np.float32)
    a[filled] = vals[keep]
    return InferBatch(
        word_idx=word_idx,
        a=a,
        words_in_doc=lengths.astype(np.int32),
        num_docs=D,
        avg_doc_sz=corpus.avg_doc_sz,
    )


def _run(Mb: torch.Tensor, a: torch.Tensor, iters: int,
         Lf: torch.Tensor) -> torch.Tensor:
    """`iters` MWU steps from uniform weights. Mb (bs, L, k) gathered model
    rows, a (bs, L), Lf (bs,). Returns w (bs, k)."""
    bs, _, k = Mb.shape
    two_log_k = 2.0 * torch.tensor(math.log(k), dtype=Mb.dtype)
    w = torch.full((bs, k), 1.0 / k, dtype=Mb.dtype, device=Mb.device)
    pos = a > 0
    for t in range(iters):
        z = torch.bmm(Mb, w[:, :, None])[:, :, 0]  # (bs, L)
        ratio = torch.where(pos, a / z, 0.0)  # pad slots: 0/0, masked
        g = torch.bmm(ratio[:, None, :], Mb)[:, 0, :]  # (bs, k)
        eta = torch.sqrt(two_log_k / float(t + 1)) / Lf
        w = w * torch.exp(eta[:, None] * g)
        w = w / torch.sum(w, dim=1, keepdim=True)
    return w


def mwu_core(Mw: torch.Tensor, word_idx: torch.Tensor, a: torch.Tensor,
             iters: int, Lf0: float, max_guesses: int):
    """MWU for one block (the plain version of isle_tpu.mwu._mwu_core).

    Mw (V+1, k) model with a zero spill row, word_idx (bs, L) long or int
    with pad = V, a (bs, L) in Mw's dtype. Returns (w (bs, k), converged
    (bs,) bool, s (bs,) = sum a log z). Unconverged rows keep the uniform
    start. Each guess reruns only the docs not yet settled; the guess
    loop is on the host, one readback per guess."""
    bs, _ = word_idx.shape
    k = Mw.shape[1]
    Mb = Mw[word_idx.long()]  # (bs, L, k), gathered once
    has_words = torch.sum(a > 0, dim=1) > 0
    w = torch.full((bs, k), 1.0 / k, dtype=Mw.dtype, device=Mw.device)
    conv = torch.zeros(bs, dtype=torch.bool, device=Mw.device)
    Lf = torch.full((bs,), Lf0, dtype=Mw.dtype, device=Mw.device)
    todo = torch.arange(bs, device=Mw.device)
    for _ in range(max_guesses):
        if todo.numel() == bs:  # first guess: no copy of Mb
            w_new = _run(Mb, a, iters, Lf)
        else:
            w_new = _run(Mb[todo], a[todo], iters, Lf[todo])
        s = torch.sum(w_new, dim=1)
        finite = torch.isfinite(s) & (s != 0.0)
        ok = finite & (torch.abs(1.0 - s) <= 0.01) & has_words[todo]
        w[todo[ok]] = w_new[ok]
        conv[todo[ok]] = True
        # finite-but-off docs never converge (same Lf -> same result);
        # non-finite docs double Lf and retry.
        retry = ~finite & has_words[todo]
        todo = todo[retry]
        if todo.numel() == 0:
            break
        Lf[todo] *= 2.0
    z = torch.bmm(Mb, w[:, :, None])[:, :, 0]
    logz = torch.where(a > 0, torch.log(z), 0.0)
    s = torch.sum(a * logz, dim=1)
    return w, conv, s


def top_n_rows(w: torch.Tensor, n: int):
    """Per-row top n (values, indices), ties to the lowest index: the
    order of jax.lax.top_k and of a stable descending argsort."""
    vals, idx = torch.sort(w, dim=1, descending=True, stable=True)
    return vals[:, :n], idx[:, :n]


def _gather_rows(mesh, mine, weights, conv, s_all) -> None:
    """Fill every rank's rows of the three result arrays, in place, with
    the values of the rank that inferred them (the rows `mine` are this
    rank's)."""
    dev = mesh.device
    docs = (np.concatenate(mine) if mine else np.zeros(0, np.int64))

    def everyone(a):
        return mesh.all_gather_rows(
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)).cpu().numpy()

    all_docs = everyone(docs.astype(np.int64))
    weights[all_docs] = everyone(weights[docs])
    conv[all_docs] = everyone(conv[docs].astype(np.uint8)).astype(bool)
    s_all[all_docs] = everyone(s_all[docs])


def infer_all(
    model: np.ndarray,  # (vocab, k) column-l1-normalized topic model
    batch: InferBatch,
    iters: int,
    Lf: float,
    block_size: int = 0,
    max_guesses: int = 10,
    top_n: int = 0,
    device="cuda",
    mesh=None,
):
    """Run MWU over every doc on `device`. Returns (weights (D, k),
    converged (D,), llh_per_doc (D,), llh_weighted (D,)) as numpy.
    Unconverged docs keep uniform weights and zero llh
    (ISLEInfer.cpp:95-111).

    With top_n > 0 only each doc's top_n weights come back from the
    device; the rest of each converged row is 0.0 filler (below the
    `> 1/k` report cut), as in isle_tpu.

    With `mesh` (a sharding.Mesh) each rank takes a contiguous share of
    every block's rows, with the model on every rank: the form of the
    reference's parallel-for over doc blocks (ISLEInfer.cpp:64-117) for
    one process a card. MWU is row-parallel, so the loop holds no
    collective; at the end every rank gathers the others' rows and
    returns the whole result."""
    device = torch.device(device)
    V, k = model.shape
    D, L = batch.word_idx.shape
    top_n = min(top_n, k)
    Mw = torch.cat([torch.as_tensor(model, dtype=torch.float32),
                    torch.zeros((1, k), dtype=torch.float32)]).to(device)
    weights = np.full((D, k), 1.0 / k, np.float32)
    conv = np.zeros(D, bool)
    s_all = np.zeros(D, np.float32)

    # Bucket docs by kept length: the padded layout is front-loaded, so a
    # doc with n kept words only needs the first n columns. Fine edges
    # (multiples of 64 through 512) keep padding waste small.
    kept = (batch.word_idx < V).sum(axis=1)
    fine = [64, 128, 192, 256, 320, 384, 448, 512, 1024, 2048, 8192]
    edges = [e for e in fine if e < L] + [L]
    mine = []  # the docs this rank inferred, block by block
    prev = -1
    for edge in edges:
        sel = np.flatnonzero((kept > prev) & (kept <= edge))
        prev = edge
        if len(sel) == 0:
            continue
        bs_cap = block_size
        if bs_cap <= 0:
            # keep the gathered block under ~2 GiB
            bs_cap = max(1, min(len(sel), (1 << 29) // max(edge * k, 1)))
            bs_cap = int(2 ** math.floor(math.log2(bs_cap)))
        # the rows of a block that one rank takes
        cap = bs_cap if mesh is None else -(-bs_cap // mesh.world)
        for lo in range(0, len(sel), bs_cap):
            idx = sel[lo:lo + bs_cap]
            if mesh is not None:  # this rank's rows of the block
                idx = idx[mesh.row_slice(len(idx))]
            bs = len(idx)
            if bs == 0:
                continue
            wi = batch.word_idx[idx, :edge]
            av = batch.a[idx, :edge]
            if bs < cap:  # pad the tail block to the block shape
                wi = np.concatenate(
                    [wi, np.full((cap - bs, edge), V, np.int32)])
                av = np.concatenate(
                    [av, np.zeros((cap - bs, edge), np.float32)])
            w, c, s = mwu_core(
                Mw, torch.from_numpy(wi).to(device),
                torch.from_numpy(av).to(device), iters, Lf, max_guesses,
            )
            if top_n:
                tv, ti = (x[:bs].cpu().numpy() for x in top_n_rows(w, top_n))
                rows = np.zeros((bs, k), np.float32)
                np.put_along_axis(rows, ti, tv, axis=1)
                weights[idx] = rows
            else:
                weights[idx] = w[:bs].cpu().numpy()
            conv[idx] = c[:bs].cpu().numpy()
            s_all[idx] = s[:bs].cpu().numpy()
            mine.append(idx)
    if mesh is not None:
        _gather_rows(mesh, mine, weights, conv, s_all)
    llh_doc = np.where(conv, s_all * np.float32(batch.avg_doc_sz), 0.0)
    llh_weighted = np.where(conv, s_all * batch.words_in_doc, 0.0)
    weights = np.where(conv[:, None], weights, np.float32(1.0 / k))
    return weights, conv, llh_doc, llh_weighted
