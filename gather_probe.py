"""Where the gather kernel's paths stand against cuSPARSE on one NVIDIA
GPU, at the NYTimes shape of chip_smoke.py, with the slice length swept.

    python3 gather_probe.py [--docs N] [--seed S]

The corpus is made on the card in a second (chip_smoke.py's host synthesis
takes minutes): isle_tpu_torch.synth's recipe (Zipf(1) words, half of a
doc's draws from one of 64 Zipf-skewed word bands, unique (doc, word)
pairs), drawn with torch's generator, so its entries are not chip_smoke's
but follow the same law. B is that corpus as a DocSparse with random
values; the hybrid tail is B without its 7,153 most frequent words (the
head chip_smoke's default layout takes), tiled as the layout tiles it.
Per use, CUDA events, mean of 5 after a warm-up:

  1. width 1 (the Lanczos matvecs): the narrow and the wide kernel on B's
     doc-sorted (B^T x) and word-sorted (B y) streams, at slices of 512
     to 4096 entries, beside torch.sparse.mm on a CSR copy;
  2. the word-sorted products at widths 128 and 100 (B Y, B onehot) on the
     hybrid tail and on B: the untiled wide kernel and the tiled passes,
     each at slices of 256 to 2048 entries, beside torch.sparse.mm.

Prints the card's line, one line per use and a JSON line of the numbers;
exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import chip_smoke as cs

CHUNKS_NARROW = (512, 1024, 2048, 4096)
CHUNKS_TILED = (256, 512, 1024, 2048)
HEAD_ROWS = 7153  # the default layout's head at the NYTimes shape


def synth_on_card(vocab: int, docs: int, nnz: int, seed: int):
    """isle_tpu_torch.synth.synth_corpus's recipe on the card: (doc, word)
    int64 pairs, unique, in (doc, word) order."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    raw = int(nnz * 1.30)

    def zipf(n, size):
        u = torch.rand(size, generator=g, device="cuda", dtype=torch.float64)
        return torch.clamp((torch.exp(u * torch.log(torch.tensor(
            float(n), dtype=torch.float64))) - 1.0).long(), max=n - 1)

    d = torch.randint(0, docs, (raw,), generator=g, device="cuda")
    w = zipf(vocab, raw)
    bsz = max(vocab // 64, 1)
    band_w = (d % 64) * bsz + zipf(bsz, raw)
    use_band = torch.rand(raw, generator=g, device="cuda") < 0.5
    w = torch.where(use_band, band_w, w)
    key = torch.unique(d * vocab + w)
    return key // vocab, key % vocab


def doc_sparse(d, w, vocab, docs, seed):
    from isle_tpu_torch.sparse import DocSparse

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    val = torch.rand(d.numel(), generator=g, device="cuda") + 0.5
    perm = torch.sort(w * (docs + 1) + d, stable=True).indices
    dw, dd = w.to(torch.int32), d.to(torch.int32)
    return DocSparse(d_word=dw, d_doc=dd, d_val=val, w_word=dw[perm],
                     w_doc=dd[perm], w_val=val[perm], vocab=vocab,
                     num_docs=docs)


def library(seg, idx, val, table, S):
    """torch.sparse.mm on a CSR copy of the sorted stream (made here,
    outside the timed call)."""
    crow = torch.zeros(S + 1, dtype=torch.int64, device=seg.device)
    crow[1:] = torch.cumsum(torch.bincount(seg.long(), minlength=S + 1)[:S],
                            0)
    csr = torch.sparse_csr_tensor(crow.int(), idx, val, size=(S, len(table)),
                                  check_invariants=False)
    return lambda: torch.sparse.mm(csr, table)


def bound_ms(n, table, S) -> float:
    return cs.bound(n * 12 + table.numel() * 4 + (S + 1) * table.shape[1]
                    * 4, 2 * n * table.shape[1])[0]


def width_one(B, seed) -> list:
    from isle_tpu_torch import segsum

    g = torch.Generator().manual_seed(seed + 2)
    x = torch.randn((B.vocab, 1), generator=g).cuda()
    y = torch.randn((B.num_docs, 1), generator=g).cuda()
    rows = []
    for use, (s, i, v), table, S in (
            ("B^T x", (B.d_doc, B.d_word, B.d_val), x, B.num_docs),
            ("B y", (B.w_word, B.w_doc, B.w_val), y, B.vocab)):
        row = dict(use=f"{use}, width 1", n=s.numel(),
                   bound_ms=bound_ms(s.numel(), table, S),
                   library_ms=cs.time_ms(library(s, i, v, table, S)))
        for kernel in ("narrow", "wide"):
            row[kernel] = {c: cs.time_ms(
                lambda c=c, k=kernel: segsum.segsum_gather_rows(
                    s, i, v, table, S, chunk=c, kernel=k))
                for c in CHUNKS_NARROW}
        rows.append(row)
    return rows


def word_sorted(sp, label, seed) -> list:
    from isle_tpu_torch import segsum

    g = torch.Generator().manual_seed(seed + 3)
    D = sp.num_docs
    onehot = torch.nn.functional.one_hot(
        torch.randint(0, 100, (D,), generator=g), 100).float().cuda()
    Y = torch.randn((D, 128), generator=g).cuda()
    w_stream = (sp.w_word, sp.w_doc, sp.w_val)
    t_stream = (sp.t_word, sp.t_doc, sp.t_val)
    rows = []
    for use, table in (("B Y, width 128", Y), ("B onehot, width 100",
                                               onehot)):
        row = dict(use=f"{label} {use}", n=sp.nnz, tiles=len(
            segsum.tile_spans(sp.tile_starts)),
            bound_ms=bound_ms(sp.nnz, table, sp.vocab),
            library_ms=cs.time_ms(library(*w_stream, table, sp.vocab)))
        row["untiled"] = {c: cs.time_ms(
            lambda c=c: segsum.segsum_gather_rows(
                *w_stream, table, sp.vocab, chunk=c, kernel="wide"))
            for c in CHUNKS_TILED}
        row["tiled"] = {c: cs.time_ms(
            lambda c=c: segsum.segsum_gather_rows_tiled(
                *t_stream, table, sp.vocab, sp.tile_starts, chunk=c))
            for c in CHUNKS_TILED}
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=cs.NYT["docs"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device", file=sys.stderr)
        return 2
    from isle_tpu_torch import hybrid, sparse

    card = cs.card_line()
    print(card)
    V, D = cs.NYT["vocab"], args.docs
    t0 = time.perf_counter()
    d, w = synth_on_card(V, D, cs.NYT["nnz"] * D // cs.NYT["docs"],
                         args.seed)
    B = doc_sparse(d, w, V, D, args.seed)
    del d, w
    H = hybrid.to_hybrid(B, HEAD_ROWS, torch.ones(V, device="cuda"))
    tail = H.tail
    del H
    torch.cuda.synchronize()
    print(f"corpus on the card: vocab {V}, docs {D}, nnz {B.nnz}, hybrid "
          f"tail {tail.nnz} entries in {len(tail.tile_starts) - 1} tiles of "
          f"{tail.tile_rows} docs; {time.perf_counter() - t0:.1f} s")
    rows = width_one(B, args.seed)
    rows += word_sorted(tail, "hybrid tail", args.seed)
    rows += word_sorted(sparse.with_doc_tiles(B), "COO", args.seed)
    for r in rows:
        print(f"{r['use']}: n {r['n']}, cuSPARSE {r['library_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.3f} ms; " + "; ".join(
                  f"{k} " + ", ".join(f"{c}: {ms:.3f}" for c, ms in
                                      r[k].items())
                  for k in ("narrow", "wide", "untiled", "tiled") if k in r)
              + " (ms by slice length)")
    print(json.dumps({"card": card, "uses": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
