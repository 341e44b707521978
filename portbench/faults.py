"""Faults planted in the program under a run of the harness, each of
which the correctness check has to read as not correct: a step that
returns its state unchanged, half of the batch left out with the mean
taken over the rest, and an answer altered where it is produced (one
card: no exchange between chips to leave out). The tests plant them at a
size the CPU holds; on the card, at the cell's own size:

    python3 portbench/faults.py --workload <cell> --fault <name> --seeds 1,2,3

prints, a seed a line, the numbers compared beside their limits.
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lloyds_state_unchanged(setattr_):
    """Lloyd's full-space step returns the centers it was given."""
    from isle_tpu_torch import kmeans

    orig = kmeans.lloyds_iter_full

    def stuck(sp, centers, *args, **kw):
        _, assign = orig(sp, centers, *args, **kw)
        return centers, assign

    setattr_(kmeans, "lloyds_iter_full", stuck)


def lloyds_half_batch(setattr_):
    """Lloyd's centers are the means of the first half of the docs."""
    from isle_tpu_torch import kmeans

    orig = kmeans.lloyds_iter_full

    def half_means(sp, assign, k, chunk):
        onehot = torch.nn.functional.one_hot(assign.long(), k).float()
        onehot[len(assign) // 2:] = 0.0
        sums = kmeans.mat_b_y(sp, onehot, chunk)
        return kmeans._means(sums.T, onehot.sum(dim=0))

    def half(sp, centers, docs_l2, k, chunk=kmeans.DEFAULT_CHUNK, *_a, **_k):
        return orig(sp, centers, docs_l2, k, chunk, half_means)

    setattr_(kmeans, "lloyds_iter_full", half)


def projected_state_unchanged(setattr_):
    """Lloyd's in the projected space returns the k-means++ centers it was
    given."""
    from isle_tpu_torch import trainer

    orig = trainer.run_lloyds_projected

    def stuck(P, centers, *args, **kw):
        _, assign = orig(P, centers, *args, **kw)
        return centers, assign

    setattr_(trainer, "run_lloyds_projected", stuck)


def projected_half_batch(setattr_):
    """Lloyd's centers in the projected space are the means of the first
    half of the docs."""
    from isle_tpu_torch import kmeans

    orig = kmeans._cluster_sums

    def half(P, assign, k, weights=None):
        h = max(assign.numel() // 2, 1)
        return orig(P[:, :h], assign[:h], k,
                    None if weights is None else weights[:h])

    setattr_(kmeans, "_cluster_sums", half)


def lloyds_one_rep(setattr_):
    """Lloyd's on B stops after its first step: every later step returns
    its state unchanged."""
    from isle_tpu_torch import trainer

    orig = trainer.run_lloyds_full

    def once(sp, centers, max_reps, *args, **kw):
        return orig(sp, centers, 1, *args, **kw)

    setattr_(trainer, "run_lloyds_full", once)


def model_altered(setattr_):
    """One entry of the topic model is off by 1e-3 where it is made."""
    from isle_tpu_torch import trainer

    orig = trainer.construct_topic_model

    def altered(*args, **kw):
        model, pairs = orig(*args, **kw)
        model = model.clone()
        model[0, 0] += 1e-3
        return model, pairs

    setattr_(trainer, "construct_topic_model", altered)


def mwu_state_unchanged(setattr_):
    """MWU's iterations return the uniform weights they start from."""
    from isle_tpu_torch import mwu

    def stuck(Mb, a, iters, Lf):
        n, _, k = Mb.shape
        return torch.full((n, k), 1.0 / k, dtype=Mb.dtype, device=Mb.device)

    setattr_(mwu, "_run", stuck)


def mwu_half_batch(setattr_):
    """MWU infers the first half of each block's docs; the rest stay
    uniform and unconverged."""
    from isle_tpu_torch import mwu

    orig = mwu.mwu_core

    def half(Mw, word_idx, a, iters, Lf0, max_guesses):
        n, k = word_idx.shape[0], Mw.shape[1]
        h = max(n // 2, 1)
        w, c, s = orig(Mw, word_idx[:h], a[:h], iters, Lf0, max_guesses)
        w2 = torch.full((n, k), 1.0 / k, dtype=w.dtype, device=w.device)
        c2 = torch.zeros(n, dtype=torch.bool, device=w.device)
        s2 = torch.zeros(n, dtype=s.dtype, device=w.device)
        w2[:h], c2[:h], s2[:h] = w, c, s
        return w2, c2, s2

    setattr_(mwu, "mwu_core", half)


def weight_altered(setattr_):
    """The first doc's largest weight is off by 0.1 where it is made."""
    from isle_tpu_torch import inferencer

    orig = inferencer.infer_all

    def altered(*args, **kw):
        weights, conv, llh_doc, llh_w = orig(*args, **kw)
        weights = weights.copy()
        weights[0, weights[0].argmax()] += 0.1
        return weights, conv, llh_doc, llh_w

    setattr_(inferencer, "infer_all", altered)


# the faults of each traffic kind, and the number that reads each
FAULTS = {
    "train_jobs": [(lloyds_state_unchanged, "center_gap"),
                   (lloyds_half_batch, "center_gap"),
                   (lloyds_one_rep, "misassigned_share"),
                   (model_altered, "model_gap")],
    "infer_ranges": [(mwu_state_unchanged, "weight_gap"),
                     (mwu_half_batch, "converged_off"),
                     (weight_altered, "weight_gap")],
}
# faults whose products lie within the sound runs' spread, so that no
# comparison of a job's products can catch them (PERF.md gives their
# readings): Lloyd's on B, over every doc, follows the projected stage
SILENT = {"train_jobs": [projected_state_unchanged, projected_half_batch],
          "infer_ranges": []}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    from portbench import harness

    traffic = harness.cell_files(harness.workload(bench, args.workload))[1]
    kind = traffic["kind"]
    plant = {f.__name__: f for f in [f for f, _ in FAULTS[kind]]
             + SILENT[kind]}[args.fault]
    undo = []

    def setattr_(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    plant(setattr_)
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            r = harness.run_cell(bench, args.workload, seed, args.seconds,
                                 False, "cuda")
            print(json.dumps({"workload": args.workload, "fault": args.fault,
                              "seed": seed, "correct": r["correct"],
                              "checks": r["checks"]}), flush=True)
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
