"""Traffic kind `infer_ranges`: a closed loop of ISLEInfer jobs over a
corpus cut into doc ranges, as ISLEInfer's doc_begin / doc_end cut a
file. Each job is Inferencer(model, InferConfig).infer_corpus(range,
top_n), the CLI's call, on the next range in turn: the host's pack of
the inference batch and MWU on the card."""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench.gen import inputs
from portbench.kinds import bytes_under
from portbench.reference import infer_ref


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 workdir: str):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.workdir = workdir
        self.shape = config["shape"]
        self.infer = config["infer"]

    def setup(self) -> None:
        from isle_tpu_torch.config import GpuConfig
        from isle_tpu_torch.corpus import Corpus

        V, D = self.shape["vocab"], self.shape["docs"]
        off, rows, counts = inputs.corpus_csc(self.shape, self.seed,
                                              self.device)
        vals = inputs.normalized(off, counts, unit=True)["vals"]
        self.off = off.cpu().numpy()
        self.rows = rows.cpu().numpy()
        self.counts = counts.cpu().numpy()
        self.vals = vals.cpu().numpy()
        del off, rows, counts, vals
        self.model = inputs.topic_model(V, self.shape["k"], self.seed,
                                        self.device).cpu().numpy()
        self.ranges = inputs.doc_ranges(D, self.traffic["ranges"])
        self.corpora, self.samples = [], []
        for r, (lo, hi) in enumerate(self.ranges):
            a, b = self.off[lo], self.off[hi]
            off_r = self.off[lo:hi + 1] - a
            lengths = np.diff(off_r)
            nz = int((lengths > 0).sum())
            total = int(self.counts[a:b].sum(dtype=np.int64))
            self.corpora.append(Corpus(
                vocab_size=V, num_docs=hi - lo, offsets=off_r,
                rows=self.rows[a:b], counts=None, vals=self.vals[a:b],
                avg_doc_sz=float(np.float32(total // max(nz, 1))),
                nz_docs=nz))
            self.samples.append(inputs.sample_docs(
                self.seed, lo, hi, lengths,
                self.traffic["docs_compared_per_range"],
                self.traffic["longest_compared_per_range"], r))
        self.gpu = GpuConfig(device=self.device.type,
                             **self.config.get("gpu", {}))

    def job(self, i: int, mark=None) -> dict:
        from isle_tpu_torch.config import HyperParams, InferConfig
        from isle_tpu_torch.inferencer import Inferencer

        r = max(i, 0) % len(self.ranges)
        cfg = InferConfig(
            num_topics=self.shape["k"], vocab_size=self.shape["vocab"],
            iters=self.infer["iters"], Lf=self.infer["Lf"],
            hyper=HyperParams(infer_max_guesses=self.infer["max_guesses"]))
        inf = Inferencer(cfg, model=self.model,
                         output_dir=os.path.join(self.workdir, f"job{i}"),
                         quiet=True, gpu=self.gpu)
        if mark is not None:
            from portbench.trace import STAGE_END, stage_label
            inf.logger.add_sink("timer", lambda m: mark(
                STAGE_END + stage_label(m)))
        res = inf.infer_corpus(self.corpora[r], top_n=self.infer["top_n"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        lo = self.ranges[r][0]
        s = self.samples[r] - lo
        rec = dict(
            units=self.ranges[r][1] - lo, range=r,
            phases={lab: w for lab, w, _ in inf.timer.phases},
            outputs=dict(weights=res.weights[s], converged=res.converged[s],
                         llh_doc=res.llh_per_doc[s],
                         llh_w=res.llh_weighted[s]))
        inf.logger.close()
        rec["written"] = bytes_under(inf.output_dir)
        return rec

    def end_to_end(self, recs: list, window_s: float) -> dict:
        return {"infer_docs_per_s": sum(r["units"] for r in recs)
                / window_s}

    def release(self) -> None:
        self.corpora = None

    def _reference(self, r: int, precision: str, runs=None) -> dict:
        docs = [(self.rows[self.off[d]:self.off[d + 1]],
                 self.vals[self.off[d]:self.off[d + 1]])
                for d in self.samples[r]]
        lo, hi = self.ranges[r]
        a, b = self.off[lo], self.off[hi]
        nz = int((np.diff(self.off[lo:hi + 1]) > 0).sum())
        avg = float(np.float32(int(self.counts[a:b].sum(dtype=np.int64))
                               // max(nz, 1)))
        return infer_ref.infer(
            self.model, docs, avg, self.infer["iters"], self.infer["Lf"],
            self.infer["max_guesses"], self.infer["top_n"], precision,
            self.device, runs=runs)

    def _references(self, r: int) -> tuple:
        """The reference of range r's sampled docs, and which of them
        float32 determines."""
        ref = self._reference(r, "fp32")
        witness = self._reference(r, "fp64", runs=ref["runs"])
        return ref, infer_ref.determined(ref, witness, self.infer["top_n"])

    def judge(self, recs: list) -> tuple:
        """Every sampled doc of every job of the window, against the
        reference run once a range."""
        refs, numbers, worst = {}, {}, []
        top_n = self.infer["top_n"]
        for rec in recs:
            r = rec["range"]
            if r not in refs:
                refs[r] = self._references(r)
            ref, sure = refs[r]
            _merge(numbers, infer_ref.judge(rec["outputs"], ref, top_n, sure))
            gaps = infer_ref.doc_gaps(rec["outputs"], ref, top_n)
            worst += [(float(g), bool(sure[i]), int(ref["runs"][i]),
                       int(self.samples[r][i]))
                      for i, g in enumerate(gaps)]
        worst.sort(reverse=True)
        runs = np.concatenate([ref["runs"] for ref, _ in refs.values()])
        facts = dict(
            docs_compared=len(worst),
            docs_undetermined=int(sum(not s for _, s, _, _ in worst)),
            reference_reruns=int((runs > 1).sum()),
            worst_docs=[dict(gap=g, determined=s, reference_runs=n, doc=d,
                             entries=int(self.off[d + 1] - self.off[d]))
                        for g, s, n, d in worst[:5]])
        return numbers, facts

    def control(self, precision: str) -> dict:
        """The reference in `precision` in the program's place, on the
        sampled docs of every range."""
        numbers = {}
        for r in range(len(self.ranges)):
            ref, sure = self._references(r)
            _merge(numbers, infer_ref.judge(self._reference(r, precision),
                                            ref, self.infer["top_n"], sure))
        return numbers


def _merge(numbers: dict, got: dict) -> None:
    """Fold one job's numbers into the run's: docs counted, gaps at their
    widest."""
    for name, v in got.items():
        if name not in numbers:
            numbers[name] = v
        elif name == "converged_off":
            numbers[name] += v
        else:
            numbers[name] = max(numbers[name], v)
