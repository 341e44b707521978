"""The plain reference of a training job with importance sampling of
documents (ISLE's sampled_threshold_and_copy, reference
src/sparseMatrix.cpp:1365-1435, and the catchword rank over the sampled
docs, src/trainer.cpp:580-584), in plain PyTorch on any device, importing
nothing of the program. It adds to train_ref's pipeline, whose functions
it reuses:

  each doc's weight: the sum of ζ over its entries that reach their
  word's ζ (float64: exact for integer ζ);
  the exponential race: dice = u^(1/weight) (0 for weight 0), the pivot
  the floor(rate * docs)-th largest dice, clamped to the last doc, and
  the docs whose dice reach the pivot kept (ties included);
  B over the kept docs; the r-th highest statistic at
  r = eps2 * w0 * docs * rate / (2k).

The uniforms u come from the seed by the program's stated rule
(isle_tpu_torch/rng.py): a CPU torch.Generator seeded with the seed; its
first draw, an integer below 2^62, seeds the sampling's own CPU
generator, whose first draws are the docs' float32 uniforms, in doc
order. The rule is written out here in plain torch.

`judge` holds a job's outputs against it as train_ref.judge does, and
adds `sample_off`: the docs whose side of the pivot, by the float64
race, differs from the program's (its original_cols). The program's
race is float32, as the source's is: its dice and its pivot may each lie
a few float32 steps from the float64 values, so a doc whose float64 dice
lies within `band(pivot)` of the float64 pivot is exempt. From there the
judge follows the program's own sampled docs through B, the eigenpairs,
its clustering (by what it says), the catchwords, the model, the top
pairs and the edge topics.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from portbench.reference import train_ref
from portbench.reference.train_ref import BMatrix, Entries, _means, \
    _rel_gap, catchwords, edge_pairs, edge_vectors, masses, \
    misassigned_share, rounder, rth_highest, top_eigs, top_two, \
    topic_model, zetas

# float32 products in float32 on the card, not TF32 (the program's own
# setting too)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the exemption band's width over the pivot, as a share of it: the float32
# race rounds 1/weight (2^-24 of it, which moves the dice by 2^-24 of
# |ln dice|) and the power (within 4 float32 steps, 2^-21 of the dice),
# once for a doc's dice and once for the pivot's; 2^-20 (1 + |ln pivot|)
# holds both with room
BAND_SHARE = 2.0 ** -20


def sampling_uniforms(seed: int, num_docs: int) -> torch.Tensor:
    """(num_docs,) float32 uniforms in [0, 1) on the CPU: the program's
    sampling draws of a job seeded with `seed`."""
    root = torch.Generator(device="cpu")
    root.manual_seed(int(seed))
    stream = torch.Generator(device="cpu")
    stream.manual_seed(int(torch.randint(1 << 62, (), generator=root)))
    return torch.rand(num_docs, generator=stream, dtype=torch.float32)


def doc_weights(E: Entries, zeta: torch.Tensor,
                q=rounder("fp32")) -> torch.Tensor:
    """(docs,) float64: the sum of ζ over each doc's entries that reach
    their word's ζ."""
    keep = torch.floor(q(E.val) + 0.5) >= zeta[E.word]
    return torch.zeros(E.num_docs, dtype=torch.float64,
                       device=E.device).index_add_(
        0, E.doc[keep], zeta[E.word[keep]].double())


def race(weights: torch.Tensor, uniforms: torch.Tensor, rate: float):
    """The exponential race in float64: (dice, pivot, kept), kept the
    docs whose dice reach the pivot, the floor(rate * docs)-th largest
    dice counted from 0 and clamped to the last doc."""
    u = uniforms.to(device=weights.device, dtype=torch.float64)
    w = weights.to(torch.float64)
    dice = torch.where(w > 0, u ** (1.0 / torch.clamp(w, min=1e-300)), 0.0)
    D = dice.numel()
    pivot = float(torch.sort(dice, descending=True).values[
        min(int(rate * D), D - 1)])
    return dice, pivot, dice >= pivot


def band(pivot: float) -> float:
    """The exemption band about a float64 pivot (BAND_SHARE)."""
    if pivot <= 0.0:
        return 0.0
    return BAND_SHARE * pivot * (1.0 + abs(math.log(pivot)))


def sampled(E: Entries, kept: torch.Tensor) -> Entries:
    """E with the values of the docs outside `kept` set to 0, which no ζ
    (at least 1) keeps: B of the result is B over the kept docs."""
    out = copy.copy(E)
    out.val = torch.where(kept[E.doc], E.val, 0.0)
    return out


def catchword_rank(hp: dict, docs: int, k: int, rate: float) -> int:
    """r over the sampled docs (src/trainer.cpp:580-584), at least 1."""
    return train_ref.catchword_rank(hp, float(docs) * rate, k)


def krylov_steps(Bm: BMatrix, blk: int) -> int:
    """train_ref.top_eigs' Krylov blocks, as many as keep the space (blk
    a block) within B's docs: a sampled B has a tenth of the docs, and a
    space wider than B's rank fills with rounding noise that the second
    orthogonalization does not make orthogonal."""
    return max(1, min(6, Bm.ncols // blk))


def pipeline(E: Entries, shape: dict, train: dict, seed: int,
             precision: str, edge_cols) -> dict:
    """The whole sampled training job in `precision` (train_ref.pipeline
    with the race before B), with the outputs the judge reads of a
    program's job."""
    q = rounder(precision)
    dt = torch.float64 if precision == "fp64" else torch.float32
    hp, k, rate = train["hyper"], shape["k"], train["sample_rate"]
    gen = torch.Generator(device=E.device)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    z = zetas(E, shape["avg_doc_sz"], shape["nz_docs"], k, hp, q)
    kept = race(doc_weights(E, z, q), sampling_uniforms(seed, E.num_docs),
                rate)[2]
    Bm = BMatrix(sampled(E, kept), z, dt, q)
    del kept
    tol = 1e-6 if precision == "fp64" else 1e-3
    blk = max(hp["block_ks_block_size"], k)
    evals, U = top_eigs(Bm, k, blk, gen, tol=tol,
                        steps=krylov_steps(Bm, blk), max_restarts=20)
    centers, assign = train_ref.kmeans(Bm, U, k, hp, gen)
    cod = torch.full((E.num_docs,), -1, dtype=torch.int64, device=E.device)
    cod[Bm.original_cols] = assign
    thr = rth_highest(E, cod, k, catchword_rank(hp, E.num_docs, k, rate), q)
    is_cw = catchwords(thr, hp["rho"])
    mass = masses(E, is_cw, k, q)
    model = topic_model(E, mass, is_cw, cod, k, hp, q)
    t1, t2, valid = top_two(mass)
    del mass
    pairs = edge_pairs(t1, t2, valid, k, train["max_edge_topics"],
                       hp["edge_topic_min_docs"])
    edges = edge_vectors(model, pairs, hp["edge_topic_primary_ratio"])

    def host(x):
        return x.cpu().numpy()

    pairs_h = host(pairs)
    cols = edge_cols(len(pairs_h))
    return dict(
        zetas=host(z), original_cols=host(Bm.original_cols), nnz_b=Bm.nnz,
        evalues=host(evals).astype(np.float32),
        U=host(U).astype(np.float32), centers=host(centers),
        cluster_of_doc=host(cod).astype(np.int32),
        thr=host(thr), is_cw=host(is_cw), model=host(model),
        top_pairs=(host(t1), host(t2), host(valid)),
        edge_pairs=pairs_h, edge_cols=host(edges)[:, cols].astype(np.float32),
    )


def judge(prog: dict, E: Entries, shape: dict, train: dict,
          seed: int) -> tuple:
    """The numbers compared of one sampled job's outputs `prog` (the keys
    of train_ref.judge) against the reference: ({name: value}, facts)."""
    hp, k, dev = train["hyper"], shape["k"], E.device
    rate = train["sample_rate"]
    out = {}
    z = zetas(E, shape["avg_doc_sz"], shape["nz_docs"], k, hp)
    zp = torch.as_tensor(np.asarray(prog["zetas"], np.float32)).to(dev)
    out["zeta_words_off"] = int((zp != z).sum()) if zp.shape == z.shape \
        else E.vocab

    # the race: the program's docs against the float64 pivot's sides
    dice, pivot, kept = race(doc_weights(E, z),
                             sampling_uniforms(seed, E.num_docs), rate)
    weighted = dice > 0
    oc = np.asarray(prog["original_cols"], np.int64)
    in_prog = torch.zeros(E.num_docs, dtype=torch.bool, device=dev)
    in_prog[torch.as_tensor(oc).to(dev)] = True
    near = (dice - pivot).abs() <= band(pivot)
    out["sample_off"] = int(((in_prog != (kept & weighted)) & ~near).sum())
    facts = dict(pivot=pivot, band=band(pivot), band_docs=int(near.sum()),
                 sampled_ref=int((kept & weighted).sum()),
                 sampled_prog=len(oc))
    del dice, kept, weighted, near

    # B over the program's docs
    Bm = BMatrix(sampled(E, in_prog), z, torch.float64, rounder("fp64"))
    del in_prog
    oc_ref = Bm.original_cols.cpu().numpy()
    out["b_off"] = int(len(np.setxor1d(oc, oc_ref))
                       + abs(int(prog["nnz_b"]) - Bm.nnz))

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    blk = max(hp["block_ks_block_size"], k)
    evals, _ = top_eigs(Bm, k, blk, gen, tol=1e-5,
                        steps=krylov_steps(Bm, blk))
    ev = torch.as_tensor(np.asarray(prog["evalues"], np.float64)).to(dev)
    out["eig_rel_gap"] = float(((ev - evals).abs() / evals.abs()).max()) \
        if ev.shape == evals.shape else float("inf")
    U = torch.as_tensor(np.asarray(prog["U"], np.float64)).to(dev)
    U = U / torch.linalg.vector_norm(U, dim=0)
    res = torch.linalg.vector_norm(Bm.gram(U) - U * evals, dim=0)
    out["eigvec_residual"] = float(res.max() / evals[0])
    del U

    cod = torch.as_tensor(np.asarray(prog["cluster_of_doc"],
                                     np.int64)).to(dev)
    assign = cod[Bm.original_cols]
    clustered = assign >= 0
    # docs outside every cluster go to a (k+1)-th cluster, then dropped
    means = _means(Bm, torch.where(clustered, assign, k), k + 1)[:k]
    Cp = torch.as_tensor(np.asarray(prog["centers"], np.float64)).to(dev)
    out["center_gap"] = _rel_gap(Cp.cpu(), means.cpu())
    out["misassigned_share"] = misassigned_share(Bm, Cp, assign) \
        if bool(clustered.all()) and Cp.shape == means.shape else 1.0
    facts.update(nnz_b=Bm.nnz, docs_b=Bm.ncols, vocab=E.vocab)
    del Bm, means, Cp, assign, clustered

    thr = rth_highest(E, cod, k, catchword_rank(hp, E.num_docs, k, rate))
    is_cw = catchwords(thr, hp["rho"])
    tp = torch.as_tensor(np.asarray(prog["thr"], np.float32)).to(dev)
    cp = torch.as_tensor(np.asarray(prog["is_cw"], bool)).to(dev)
    out["catchword_off"] = int((tp != thr).sum() + (cp != is_cw).sum()) \
        if tp.shape == thr.shape and cp.shape == is_cw.shape \
        else k * E.vocab
    mass = masses(E, is_cw, k)
    model = topic_model(E, mass, is_cw, cod, k, hp)
    out["model_gap"] = _rel_gap(prog["model"], model.cpu())
    # each doc's top two topics, judged by the reference's masses, as
    # train_ref.judge does
    pt1, pt2, pvalid = (torch.as_tensor(np.asarray(x)).to(dev).long()
                        for x in prog["top_pairs"])
    pvalid = pvalid.bool()
    valid = top_two(mass)[2]
    top2 = torch.topk(mass, 2, dim=1).values
    tol = 1e-6 * top2[:, :1]
    got1 = mass.gather(1, pt1.clamp(0, k - 1)[:, None])[:, 0]
    got2 = mass.gather(1, pt2.clamp(0, k - 1)[:, None])[:, 0]
    ok = (pt1 != pt2) & (got1 >= top2[:, 0] - tol[:, 0]) \
        & (got2 >= top2[:, 1] - tol[:, 0])
    out["top_pair_off"] = int((pvalid != valid).sum()
                              + (valid & pvalid & ~ok).sum())
    del mass, top2, tol, got1, got2, ok, valid
    pairs = edge_pairs(pt1, pt2, pvalid, k, train["max_edge_topics"],
                       hp["edge_topic_min_docs"]).cpu().numpy()
    pe = np.asarray(prog["edge_pairs"], np.int64)
    out["edge_pairs_off"] = abs(len(pe) - len(pairs)) + (
        int((pe != pairs).any(axis=1).sum()) if pe.shape == pairs.shape
        else len(pairs))
    edges = edge_vectors(model, torch.as_tensor(pairs).to(dev),
                         hp["edge_topic_primary_ratio"]).cpu().numpy()
    cols = [c for c in shape["edge_cols"] if c < len(pairs)]
    out["edge_gap"] = _rel_gap(np.asarray(prog["edge_cols"])[:, :len(cols)],
                               edges[:, cols])
    return out, facts
