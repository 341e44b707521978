"""The plain reference of an inference job: ISLEInfer's MWU (reference
src/infer.cpp:364-493) for a set of docs, in plain PyTorch, importing
nothing of the program.

Per doc, the words whose total model mass is at most 1e-10 are left
out; w starts uniform; iteration t (from 0) takes
    g = M^T (a / (M w)),  eta = sqrt(2 ln k / (t + 1)) / Lf,
    w <- w exp(eta g) / sum(w exp(eta g));
after `iters` iterations the doc has converged if sum(w) is finite,
nonzero and within 0.01 of 1; a non-finite or zero sum doubles the
doc's Lf and runs again, up to `max_guesses` runs. The log-likelihood
s = sum_j a_j ln((M w)_j) is reported as s avg_doc_sz and s words_in_doc;
a doc that never converges keeps uniform weights and reports 0. The
configuration states float32 (an overflow of w exp(eta g) is what makes a
doc run again), so the reference runs in float32, its products as sums
of elementwise products; the control rounds every product's operands to
bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .train_ref import rounder

MASS_FLOOR = 1e-10
# a doc's weights are determined at float32 where the float32 reference
# and its float64 witness give top-n weights this close (PERF.md: in a
# few docs in 10^4 the weights fall near float32's least values while MWU
# swings between two topics, and the result varies by 1e-2 with the order
# of the sums)
DETERMINED = 1e-3


def _run(Mb, a, iters: int, Lf, q):
    n, _, k = Mb.shape
    dt = Mb.dtype
    two_log_k = torch.tensor(2.0 * math.log(k), dtype=dt)
    w = torch.full((n, k), 1.0 / k, dtype=dt, device=Mb.device)
    pos = a > 0
    Mq = q(Mb)
    for t in range(iters):
        z = (Mq * q(w)[:, None, :]).sum(dim=2)
        ratio = torch.where(pos, a / z, 0.0)
        g = (q(ratio)[:, :, None] * Mq).sum(dim=1)
        eta = torch.sqrt(two_log_k / float(t + 1)) / Lf
        w = w * torch.exp(eta[:, None] * g)
        w = w / w.sum(dim=1, keepdim=True)
    return w


def _pack(model: torch.Tensor, words: list, vals: list):
    """(Mb (n, L, k), a (n, L)) in the model's dtype: each doc's kept
    words' model rows and values, padded with zeros."""
    dev = model.device
    mass = model.sum(dim=1).cpu().numpy()
    kept = [(np.asarray(wd, np.int64), np.asarray(va, np.float32))
            for wd, va in zip(words, vals)]
    kept = [(wd[mass[wd] > MASS_FLOOR], va[mass[wd] > MASS_FLOOR])
            for wd, va in kept]
    n = len(kept)
    L = max([len(wd) for wd, _ in kept] + [1])
    idx = np.full((n, L), -1, np.int64)
    a = np.zeros((n, L), np.float32)
    for i, (wd, va) in enumerate(kept):
        idx[i, :len(wd)] = wd
        a[i, :len(va)] = va
    idx = torch.from_numpy(idx).to(dev)
    a = torch.from_numpy(a).to(dev).to(model.dtype)
    Mb = torch.where((idx >= 0)[:, :, None], model[torch.clamp(idx, min=0)],
                     0.0)
    return Mb, a


def mwu_block(model: torch.Tensor, words: list, vals: list, iters: int,
              Lf0, max_guesses: int, q):
    """MWU over one block of docs (`words`, `vals`: per doc int64 word ids
    and float32 unit-mass values) in the model's dtype, from Lf0 (a
    number, or one a doc). Returns (w (n, k), converged (n,), s (n,),
    runs (n,): the runs each doc took)."""
    dev, dt = model.device, model.dtype
    Mb, a = _pack(model, words, vals)
    n, k = Mb.shape[0], model.shape[1]
    has_words = (a > 0).sum(dim=1) > 0
    w = torch.full((n, k), 1.0 / k, dtype=dt, device=dev)
    conv = torch.zeros(n, dtype=torch.bool, device=dev)
    runs = torch.zeros(n, dtype=torch.int64, device=dev)
    Lf = torch.as_tensor(Lf0, dtype=dt).to(dev).expand(n).clone()
    todo = torch.arange(n, device=dev)
    for _ in range(max_guesses):
        runs[todo] += 1
        wn = _run(Mb[todo], a[todo], iters, Lf[todo], q)
        s = wn.sum(dim=1)
        finite = torch.isfinite(s) & (s != 0)
        ok = finite & ((1.0 - s).abs() <= 0.01) & has_words[todo]
        w[todo[ok]] = wn[ok]
        conv[todo[ok]] = True
        todo = todo[~finite & has_words[todo]]
        if todo.numel() == 0:
            break
        Lf[todo] *= 2.0
    z = (q(Mb) * q(w)[:, None, :]).sum(dim=2)
    logz = torch.where(a > 0, torch.log(z), 0.0)
    return w, conv, (a * logz).sum(dim=1), runs


def infer(model: np.ndarray, docs: list, avg_doc_sz: float, iters: int,
          Lf: float, max_guesses: int, top_n: int, precision: str,
          device, block: int = 2048, runs=None) -> dict:
    """The outputs a job reports for `docs` (a list of (words, unit-mass
    values) pairs, all of one range, whose avg_doc_sz is given): weights
    (n, k) holding each converged doc's top_n weights and 0 elsewhere,
    uniform rows where unconverged; converged; llh_doc = s avg_doc_sz and
    llh_w = s words_in_doc where converged, else 0; runs. With precision
    "fp64" (the witness), each doc runs once in float64 from the Lf at
    which the float32 reference settled it (`runs`: its runs)."""
    q = rounder(precision)
    dt = torch.float64 if precision == "fp64" else torch.float32
    M = torch.as_tensor(np.asarray(model, np.float32)).to(device).to(dt)
    k = M.shape[1]
    Lf0 = np.full(len(docs), float(Lf)) if runs is None \
        else float(Lf) * 2.0 ** (np.asarray(runs) - 1)
    guesses = 1 if precision == "fp64" else max_guesses
    parts = []
    for lo in range(0, len(docs), block):
        chunk = docs[lo:lo + block]
        parts.append(mwu_block(M, [d[0] for d in chunk],
                               [d[1] for d in chunk], iters,
                               Lf0[lo:lo + block], guesses, q))
    w, conv, s, runs = (torch.cat(x) for x in zip(*parts))
    if top_n:
        vals, ix = torch.sort(w, dim=1, descending=True, stable=True)
        top = torch.zeros_like(w).scatter_(1, ix[:, :top_n],
                                           vals[:, :top_n])
        w = torch.where(conv[:, None], top, w)
    w = torch.where(conv[:, None], w, 1.0 / k)
    words_in_doc = torch.tensor([len(d[0]) for d in docs],
                                dtype=dt, device=M.device)
    zero = torch.zeros_like(s)
    return dict(
        weights=w.cpu().numpy(), converged=conv.cpu().numpy(),
        llh_doc=torch.where(conv, s * float(np.float32(avg_doc_sz)),
                            zero).cpu().numpy(),
        llh_w=torch.where(conv, s * words_in_doc, zero).cpu().numpy(),
        runs=runs.cpu().numpy())


def doc_gaps(prog: dict, ref: dict, top_n: int) -> np.ndarray:
    """Each doc's weight gap as judge takes it (0 where either side did
    not converge)."""
    cp, cr = np.asarray(prog["converged"]), np.asarray(ref["converged"])
    both = cp & cr
    out = np.zeros(len(cp))
    wp = np.asarray(prog["weights"], np.float64)[both]
    wr = np.asarray(ref["weights"], np.float64)[both]
    if len(wp):
        tp = np.argsort(-wp, axis=1, kind="stable")[:, :top_n]
        tr = np.argsort(-wr, axis=1, kind="stable")[:, :top_n]
        rows = np.arange(len(wp))[:, None]
        gap = np.abs(wp[rows, tp] - wr[rows, tp]).max(axis=1)
        least = wp[rows, tp].min(axis=1)
        missed = ~(tr[:, :, None] == tp[:, None, :]).any(axis=2)
        over = np.where(missed, wr[rows, tr] - least[:, None], 0.0)
        out[both] = np.maximum(gap, over.max(axis=1))
    return out


def determined(ref: dict, witness: dict, top_n: int) -> np.ndarray:
    """The docs whose reported weights float32 determines: the float32
    reference and its float64 witness converge alike and agree within
    DETERMINED."""
    return (np.asarray(ref["converged"]) == np.asarray(witness["converged"])) \
        & (doc_gaps(witness, ref, top_n) <= DETERMINED)


def judge(prog: dict, ref: dict, top_n: int, sure: np.ndarray) -> dict:
    """The numbers compared of the program's outputs for a set of docs
    against the reference's (dicts of infer's keys): converged flags that
    differ; and over the docs `sure` (determined), the widest gap of a
    reported top-n weight (a reported weight against the reference's
    value of that topic, and a topic in the reference's top n that the
    program left out, by how far its weight exceeds the least weight the
    program did report) and the widest relative gap of either
    log-likelihood."""
    cp, cr = np.asarray(prog["converged"]), np.asarray(ref["converged"])
    out = {"converged_off": int((cp != cr).sum())}
    both = cp & cr & sure
    gaps = doc_gaps(prog, ref, top_n)[sure]
    out["weight_gap"] = float(gaps.max()) if len(gaps) else 0.0
    llh = 0.0
    for key in ("llh_doc", "llh_w"):
        a = np.asarray(prog[key], np.float64)[both]
        b = np.asarray(ref[key], np.float64)[both]
        if len(a):
            llh = max(llh, float((np.abs(a - b)
                                  / np.maximum(np.abs(b), 1e-30)).max()))
    out["llh_gap"] = llh
    return out
