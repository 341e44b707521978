"""The plain reference of a training job (ISLE's pipeline, reference
src/trainer.cpp:425-685), in plain PyTorch on any device, importing
nothing of the program:

  ζ thresholds -> B (kept entries, sqrt(ζ) values) -> top-k eigenpairs of
  B B^T -> [k-means++ on U^T B, Lloyd's there, lifted, Lloyd's on B] ->
  r-th highest frequency per (word, cluster) -> catchwords -> topic model
  (catchword mass, its rank threshold, B W) -> top-two topics -> edge
  topics.

`judge` holds a job's outputs against it. The clustering is a local
optimum that depends on the draws and on rounding at every k-means++
pick, so the judge does not cluster again: it checks the program's
clustering by what it says (its centers are the means of B's columns
under its assignment, and few docs lie nearer another center than their
own, as after ten of Lloyd's steps on B) and follows that clustering
through the stages after it. `pipeline` runs the whole job, its own
k-means included, in the precision asked for: the control puts it, in
bfloat16, in the program's place.

Values are float32 as the corpus gives them; sums that decide a
comparison are taken in float64 (the catchword mass and the model's sums
of float32 values are then exact), and the eigenpairs in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

def rounder(precision: str):
    """x -> x rounded to the precision's mantissa (bf16: the operands of a
    bfloat16 product accumulated in float32), in x's dtype."""
    if precision == "bf16":
        return lambda x: x.to(torch.bfloat16).to(x.dtype)
    if precision in ("fp32", "fp64"):
        return lambda x: x
    raise ValueError(f"unknown precision {precision!r}")


class Entries:
    """The corpus on `device`, one entry a nonzero in doc order: doc,
    word (int64) and the normalized value (float32)."""

    def __init__(self, offsets, rows, vals, vocab: int, device):
        dev = torch.device(device)
        off = torch.as_tensor(np.asarray(offsets, np.int64)).to(dev)
        self.num_docs = int(off.numel() - 1)
        self.vocab = int(vocab)
        self.doc = torch.repeat_interleave(
            torch.arange(self.num_docs, device=dev), off[1:] - off[:-1])
        self.word = torch.as_tensor(np.asarray(rows)).to(dev).long()
        self.val = torch.as_tensor(np.asarray(vals, np.float32)).to(dev)
        self.device = dev


def zetas(E: Entries, avg_doc_sz: float, nz_docs: int, k: int,
          hp: dict, q=rounder("fp32")) -> torch.Tensor:
    """(vocab,) float32 ζ: a word's frequencies are its values rounded
    half away from zero; start = the largest frequency that at least
    count_gr of its entries reach; ζ = the largest frequency in [1, start]
    that holds at least one and fewer than count_eq entries, and 1 where
    none does, where fewer than count_gr entries reach 1, or where the
    word is absent (src/sparseMatrix.cpp:365-430, no drop flags)."""
    if hp.get("few_samples_threshold_drop") or hp.get("bad_threshold_drop"):
        raise ValueError("the reference implements ζ without drop flags")
    F = int(math.floor(avg_doc_sz + 0.5)) + 1
    freq = torch.clamp(torch.floor(q(E.val) + 0.5), 0, F).long()
    hist = torch.bincount(E.word * (F + 1) + freq,
                          minlength=E.vocab * (F + 1)).view(E.vocab, F + 1)
    hist[:, 0] = 0
    count_gr = max(int(hp["w0"] * float(nz_docs) / (2.0 * k)), 1)
    count_eq = max(int(math.ceil(3.0 * hp["eps1"] * hp["w0"]
                                 * float(nz_docs) / k)), 1)
    reach = torch.flip(torch.cumsum(torch.flip(hist, [1]), 1), [1])
    v = torch.arange(F + 1, device=E.device)[None, :]
    start = torch.where(reach >= count_gr, v, 0).amax(dim=1)
    ok = (hist > 0) & (hist < count_eq) & (v >= 1) & (v <= start[:, None])
    zeta = torch.where(ok, v, 0).amax(dim=1)
    return torch.where(zeta == 0, 1, zeta).to(torch.float32)


class BMatrix:
    """B = the entries whose frequency reaches their word's ζ, valued
    sqrt(ζ), over the docs left non-empty, renumbered in order; held as
    CSR both ways in `dtype` for the products."""

    def __init__(self, E: Entries, zeta: torch.Tensor, dtype, q):
        keep = torch.floor(q(E.val) + 0.5) >= zeta[E.word]
        doc, word = E.doc[keep], E.word[keep]
        occ = torch.zeros(E.num_docs, dtype=torch.bool, device=E.device)
        occ[doc] = True
        self.original_cols = torch.nonzero(occ)[:, 0]
        col = (torch.cumsum(occ, 0) - 1)[doc]
        val = q(torch.sqrt(zeta)[word]).to(dtype)
        self.vocab, self.ncols, self.nnz = E.vocab, int(occ.sum()), int(
            keep.sum())
        self.dtype, self.q = dtype, q
        self.bt = _csr(col, word, val, self.ncols, self.vocab)
        by_word = torch.argsort(word, stable=True)
        self.b = _csr(word[by_word], col[by_word], val[by_word], self.vocab,
                      self.ncols)
        self.col_l2 = torch.zeros(self.ncols, dtype=torch.float64,
                                  device=E.device).index_add_(
            0, col, val.double() ** 2)

    def bt_x(self, X: torch.Tensor) -> torch.Tensor:
        return torch.sparse.mm(self.bt, self.q(X.to(self.dtype)))

    def b_y(self, Y: torch.Tensor) -> torch.Tensor:
        return torch.sparse.mm(self.b, self.q(Y.to(self.dtype)))

    def gram(self, X: torch.Tensor) -> torch.Tensor:
        return self.b_y(self.bt_x(X))


def _csr(row, col, val, nrows: int, ncols: int):
    """A CSR matrix of entries already sorted by row."""
    crow = torch.zeros(nrows + 1, dtype=torch.int64, device=row.device)
    torch.cumsum(torch.bincount(row, minlength=nrows), 0, out=crow[1:])
    return torch.sparse_csr_tensor(crow, col, val, (nrows, ncols),
                                   check_invariants=False)


def top_eigs(Bm: BMatrix, k: int, blk: int, gen: torch.Generator,
             tol: float = 1e-6, steps: int = 6, max_restarts: int = 60):
    """The k largest eigenpairs of B B^T, descending: (values, vectors
    (vocab, k)). Block Krylov: `steps` blocks of width `blk` (at least k)
    from the start block, orthogonalized twice, a Rayleigh-Ritz step on
    their span, and a restart from the top `blk` Ritz vectors until every
    one of the top k has a residual under tol times the largest value."""
    V, dt, dev = Bm.vocab, Bm.dtype, Bm.b.device
    blk = max(blk, k)
    steps = max(1, min(steps, V // blk))
    X = torch.linalg.qr(torch.randn(V, blk, generator=gen, dtype=dt,
                                    device=dev)).Q
    for _ in range(max_restarts):
        Qs, Ws = [X], []
        for j in range(steps):
            W = Bm.gram(Qs[-1])
            Ws.append(W)
            if j + 1 < steps:
                Z = W
                for _ in range(2):
                    for Qi in Qs:
                        Z = Z - Qi @ (Qi.T @ Z)
                Qs.append(torch.linalg.qr(Z).Q)
        Q, W = torch.cat(Qs, 1), torch.cat(Ws, 1)
        H = Q.T @ W
        theta, C = torch.linalg.eigh((H + H.T) / 2)
        theta, C = theta.flip(0)[:blk], C.flip(1)[:, :blk]
        X, GX = Q @ C, W @ C
        del Q, W, Qs, Ws
        res = torch.linalg.vector_norm(GX - X * theta, dim=0)
        if float(res[:k].max()) <= tol * float(theta[0]):
            break
    return theta[:k], X[:, :k]


def cluster_sizes(cluster_of_doc: torch.Tensor, k: int) -> torch.Tensor:
    c = cluster_of_doc[cluster_of_doc >= 0]
    return torch.bincount(c.long(), minlength=k)[:k]


def rth_highest(E: Entries, cluster_of_doc: torch.Tensor, k: int, r: int,
                q=rounder("fp32")) -> torch.Tensor:
    """(k, vocab) float32: of the entries of word w in the docs of cluster
    t, the r-th largest value when there are more than r; the smallest
    when the word is in every doc of a cluster of at most r docs; 0
    otherwise (src/sparseMatrix.cpp:491-524)."""
    V = E.vocab
    col = cluster_of_doc[E.doc].long()
    m = col >= 0
    key, val = E.word[m] * k + col[m], q(E.val[m])
    by_val = torch.argsort(val, descending=True, stable=True)
    key, val = key[by_val], val[by_val]
    by_key = torch.argsort(key, stable=True)
    val = val[by_key]
    if val.numel() == 0:
        val = torch.zeros(1, dtype=torch.float32, device=E.device)
    cnt = torch.bincount(key, minlength=V * k)
    start = torch.cumsum(cnt, 0) - cnt
    last = val.numel() - 1
    rth = torch.where(cnt > r, val[torch.clamp(start + r - 1, 0, last)],
                      0.0)
    size = cluster_sizes(cluster_of_doc, k).repeat(V)
    whole = (cnt <= r) & (r >= size) & (cnt == size) & (size > 0)
    least = val[torch.clamp(start + cnt - 1, 0, last)]
    return torch.where(whole, least, rth).view(V, k).T.contiguous()


def catchwords(thr: torch.Tensor, rho: float) -> torch.Tensor:
    """(k, vocab) bool: the word's threshold in topic t exceeds rho times
    its threshold in every other topic (float32 arithmetic)."""
    k = thr.shape[0]
    scaled = thr * rho
    out = torch.zeros_like(thr, dtype=torch.bool)
    for t in range(k):
        others = torch.cat([scaled[:t], scaled[t + 1:]]).amax(dim=0) \
            if k > 1 else torch.full_like(thr[0], float("inf"))
        out[t] = thr[t] > others
    return out


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Row-wise index of the first largest value."""
    cols = torch.arange(x.shape[1], device=x.device)[None, :]
    top = x.amax(dim=1, keepdim=True)
    return torch.where(x == top, cols, x.shape[1]).amin(dim=1)


def masses(E: Entries, is_cw: torch.Tensor, k: int,
           q=rounder("fp32")) -> torch.Tensor:
    """(docs, k) float32 catchword mass: a doc's values of topic t's
    catchwords summed in float64 (exactly, for these values) and rounded
    once."""
    t_of, w_of = torch.nonzero(is_cw, as_tuple=True)
    cw_topic = torch.full((E.vocab,), -1, dtype=torch.int64, device=E.device)
    cw_topic[w_of] = t_of
    ct = cw_topic[E.word]
    m = ct >= 0
    mass = torch.zeros(E.num_docs * k, dtype=torch.float64, device=E.device)
    mass.index_add_(0, E.doc[m] * k + ct[m], q(E.val[m]).double())
    return mass.view(E.num_docs, k).to(torch.float32)


def topic_model(E: Entries, mass: torch.Tensor, is_cw: torch.Tensor,
                cluster_of_doc: torch.Tensor, k: int, hp: dict,
                q=rounder("fp32")) -> torch.Tensor:
    """(vocab, k) float32 with unit column sums: topic t's threshold is
    the rank_threshold-th largest catchword mass (0 with fewer positive
    masses or no catchwords); the model is A W, W = (mass > threshold) +
    the doc's cluster (src/sparseMatrix.cpp:597-838), normalized per
    topic."""
    D, V = E.num_docs, E.vocab
    rank = int(hp["eps3"] * hp["w0"] * float(D) / (float(k) * 2.0))
    if 0 < rank <= D:
        thr = torch.sort(mass, dim=0, descending=True).values[rank - 1]
        thr = torch.where((mass > 0).sum(dim=0) >= rank, thr, 0.0)
    else:
        thr = torch.zeros(k, dtype=torch.float32, device=E.device)
    thr = torch.where(is_cw.any(dim=1), thr, 0.0)
    W = (mass > thr[None, :]).to(torch.float64)
    docs = torch.nonzero(cluster_of_doc >= 0)[:, 0]
    W[docs, cluster_of_doc[docs].long()] += 1.0
    A = _csr(*_by_word(E.word, E.doc, q(E.val).double()), V, D)
    model = torch.sparse.mm(A, W)
    sums = model.sum(dim=0)
    model = torch.where(sums[None, :] != 0, model / sums[None, :], model)
    return model.to(torch.float32)


def top_two(mass: torch.Tensor) -> tuple:
    """Each doc's (first, second) topic by catchword mass, ties to the
    lower topic, and whether both masses are positive."""
    k = mass.shape[1]
    t1 = first_argmax(mass)
    cols = torch.arange(k, device=mass.device)[None, :]
    rest = torch.where(cols == t1[:, None], -torch.inf, mass)
    t2 = first_argmax(rest)
    valid = (mass.amax(dim=1) > 0) & (rest.amax(dim=1) > 0)
    return t1, t2, valid


def catchword_rank(hp: dict, docs: int, k: int) -> int:
    """r of the r-th highest statistic (src/trainer.cpp:580-584), at
    least 1."""
    return max(int(math.floor(hp["eps2"] * hp["w0"] * float(docs)
                              / (2.0 * k))), 1)


def _by_word(word, doc, val):
    order = torch.argsort(word, stable=True)
    return word[order], doc[order], val[order]


def edge_pairs(t1, t2, valid, k: int, max_edges: int, min_docs: int):
    """(n, 3) int64 [t1, t2, docs] of the top-two pairs held by at least
    min_docs docs, most docs first, ties by (t1, t2)."""
    keys = (t1 * k + t2)[valid]
    counts = torch.bincount(keys, minlength=k * k)
    cand = torch.nonzero(counts >= max(min_docs, 1))[:, 0]
    cand = cand[torch.argsort(-counts[cand], stable=True)][:max_edges]
    return torch.stack([cand // k, cand % k, counts[cand]], dim=1)


def edge_vectors(model: torch.Tensor, pairs: torch.Tensor,
                 ratio: float) -> torch.Tensor:
    a, b = pairs[:, 0], pairs[:, 1]
    return ratio * model[:, a].double() + (1.0 - ratio) * model[:, b].double()


# ---------------------------------------------------------------------------
# The whole job, its own clustering included (the control)
# ---------------------------------------------------------------------------

def _means(B: BMatrix, assign: torch.Tensor, k: int) -> torch.Tensor:
    onehot = torch.nn.functional.one_hot(assign, k).to(B.dtype)
    sums = torch.sparse.mm(B.b, onehot)  # (vocab, k)
    counts = onehot.sum(dim=0)
    return torch.where(counts[None, :] > 0,
                       sums / torch.clamp(counts, min=1)[None, :], 0.0).T


def _dense_means(P: torch.Tensor, assign: torch.Tensor, k: int):
    sums = torch.zeros(k, P.shape[1], dtype=torch.float64, device=P.device)
    sums.index_add_(0, assign, P.double())
    counts = torch.bincount(assign, minlength=k)[:k].double()
    return torch.where(counts[:, None] > 0,
                       sums / torch.clamp(counts, min=1)[:, None],
                       0.0).to(P.dtype)


def _assign(dots, docs_l2, centers):
    c_l2 = (centers.double() ** 2).sum(dim=1)
    d = docs_l2[:, None] + c_l2[None, :] - 2.0 * dots.double()
    return torch.argmin(d, dim=1)


def sq_dists(Bm: BMatrix, centers: torch.Tensor) -> torch.Tensor:
    """(B's columns, k) float64 squared distances of each doc of B to
    each center, in exact arithmetic as far as float64 goes."""
    C = centers.to(torch.float64)
    d = Bm.col_l2[:, None] + (C * C).sum(dim=1)[None, :] \
        - 2.0 * Bm.bt_x(C.T.contiguous()).double()
    return torch.clamp(d, min=0.0)


def misassigned_share(Bm: BMatrix, centers: torch.Tensor,
                      assign: torch.Tensor) -> float:
    """The share of B's docs that lie farther from their own center than
    from the nearest one, by more than a millionth of their squared
    norms: the docs one more Lloyd's step would move."""
    d = sq_dists(Bm, centers)
    own = d.gather(1, assign.long().clamp(0, d.shape[1] - 1)[:, None])[:, 0]
    tie = 1e-6 * (Bm.col_l2 + (centers.double() ** 2).sum(dim=1)[
        assign.long().clamp(0, d.shape[1] - 1)])
    return float(((own - d.amin(dim=1)) > tie).double().mean())


def kmeans(Bm: BMatrix, U: torch.Tensor, k: int, hp: dict,
           gen: torch.Generator):
    """k-means++ on the projected docs U^T B, Lloyd's there, the centers
    lifted through U, Lloyd's on B: (centers (k, vocab), assignment of
    B's columns)."""
    q = Bm.q
    P = Bm.bt_x(U).to(torch.float32)  # (ncols, k)
    n = P.shape[0]
    p_l2 = (P.double() ** 2).sum(dim=1)

    def d2(i):
        return torch.clamp(p_l2 + p_l2[i] - 2.0 * (q(P) @ q(P[i])).double(),
                           min=0.0)

    picks = [int(torch.randint(n, (1,), generator=gen,
                               device=gen.device).cpu())]
    dmin = d2(picks[0])
    for _ in range(1, k):
        s = float(dmin.sum())
        i = int(torch.multinomial(dmin / s, 1, generator=gen).cpu()) \
            if s > 0 else (picks[-1] + 1) % n
        picks.append(i)
        dmin = torch.minimum(dmin, d2(i))
    C = P[torch.tensor(picks, device=P.device)]
    assign = None
    for _ in range(hp["max_kmeans_lowd_reps"]):
        new = _assign(q(P) @ q(C).T, p_l2, C)
        C = _dense_means(P, new, k)
        if assign is not None and torch.equal(new, assign):
            break
        assign = new
    Cf = (q(C) @ q(U.to(torch.float32)).T).to(Bm.dtype)  # (k, vocab)
    assign = None
    for _ in range(hp["max_kmeans_reps"]):
        new = _assign(Bm.bt_x(Cf.T.contiguous()), Bm.col_l2, Cf)
        Cf = _means(Bm, new, k)
        if assign is not None and torch.equal(new, assign):
            break
        assign = new
    return Cf.to(torch.float32), new


def pipeline(E: Entries, shape: dict, train: dict, seed: int,
             precision: str, edge_cols) -> dict:
    """The whole training job in `precision`, with the outputs the judge
    reads of a program's job (`edge_cols(n)`: the edge topics compared of
    a job that made n)."""
    q = rounder(precision)
    dt = torch.float64 if precision == "fp64" else torch.float32
    hp, k = train["hyper"], shape["k"]
    gen = torch.Generator(device=E.device)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    z = zetas(E, shape["avg_doc_sz"], shape["nz_docs"], k, hp, q)
    Bm = BMatrix(E, z, dt, q)
    tol = 1e-6 if precision == "fp64" else 1e-3
    evals, U = top_eigs(Bm, k, hp["block_ks_block_size"], gen, tol=tol,
                        max_restarts=20)
    centers, assign = kmeans(Bm, U, k, hp, gen)
    cod = torch.full((E.num_docs,), -1, dtype=torch.int64, device=E.device)
    cod[Bm.original_cols] = assign
    thr = rth_highest(E, cod, k, catchword_rank(hp, E.num_docs, k), q)
    is_cw = catchwords(thr, hp["rho"])
    mass = masses(E, is_cw, k, q)
    model = topic_model(E, mass, is_cw, cod, k, hp, q)
    t1, t2, valid = top_two(mass)
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


# ---------------------------------------------------------------------------
# The judge
# ---------------------------------------------------------------------------

def _rel_gap(a, b) -> float:
    """max |a - b| over max |b| (0 when both are empty)."""
    a = torch.as_tensor(np.asarray(a), dtype=torch.float64)
    b = torch.as_tensor(np.asarray(b), dtype=torch.float64)
    if a.shape != b.shape:
        return float("inf")
    if b.numel() == 0:
        return 0.0
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


def judge(prog: dict, E: Entries, shape: dict, train: dict,
          seed: int) -> tuple:
    """The numbers compared of one job's outputs `prog` against the
    reference: ({name: value}, facts of the reference's B). `prog` holds
    zetas, original_cols, nnz_b, evalues, U, centers, cluster_of_doc,
    thr, is_cw, model, top_pairs, edge_pairs and edge_cols (the columns
    `shape['edge_cols']` of the edge model)."""
    hp, k, dev = train["hyper"], shape["k"], E.device
    out = {}
    z = zetas(E, shape["avg_doc_sz"], shape["nz_docs"], k, hp)
    zp = torch.as_tensor(np.asarray(prog["zetas"], np.float32)).to(dev)
    out["zeta_words_off"] = int((zp != z).sum()) if zp.shape == z.shape \
        else E.vocab
    Bm = BMatrix(E, z, torch.float64, rounder("fp64"))
    oc_ref = Bm.original_cols.cpu().numpy()
    oc = np.asarray(prog["original_cols"])
    out["b_off"] = int(len(np.setxor1d(oc, oc_ref))
                       + abs(int(prog["nnz_b"]) - Bm.nnz))

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    evals, _ = top_eigs(Bm, k, hp["block_ks_block_size"], gen, tol=1e-5)
    ev = torch.as_tensor(np.asarray(prog["evalues"], np.float64)).to(dev)
    out["eig_rel_gap"] = float(((ev - evals).abs() / evals.abs()).max()) \
        if ev.shape == evals.shape else float("inf")
    U = torch.as_tensor(np.asarray(prog["U"], np.float64)).to(dev)
    U = U / torch.linalg.vector_norm(U, dim=0)
    res = torch.linalg.vector_norm(Bm.gram(U) - U * evals, dim=0)
    out["eigvec_residual"] = float(res.max() / evals[0])

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

    thr = rth_highest(E, cod, k, catchword_rank(hp, E.num_docs, k))
    is_cw = catchwords(thr, hp["rho"])
    tp = torch.as_tensor(np.asarray(prog["thr"], np.float32)).to(dev)
    cp = torch.as_tensor(np.asarray(prog["is_cw"], bool)).to(dev)
    out["catchword_off"] = int((tp != thr).sum() + (cp != is_cw).sum()) \
        if tp.shape == thr.shape and cp.shape == is_cw.shape \
        else k * E.vocab
    mass = masses(E, is_cw, k)
    model = topic_model(E, mass, is_cw, cod, k, hp)
    out["model_gap"] = _rel_gap(prog["model"], model.cpu())
    # each doc's top two topics, judged by the reference's masses: the
    # program's pair has to hold the doc's two largest masses, where two
    # masses equal in exact arithmetic may come out in either order
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
    # the edge topics: the pairs the program's own top pairs select, and
    # the edge vectors of the reference's model
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
    facts = dict(nnz_b=Bm.nnz, docs_b=Bm.ncols, vocab=E.vocab)
    return out, facts
