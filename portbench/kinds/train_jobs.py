"""Traffic kind `train_jobs`: a closed loop of whole training jobs, as
ISLETrain runs them. Each job is a fresh Trainer on the corpus made in
set-up: load_corpus, train(), train_edge_topics(), ending in a
synchronize; every job uploads the corpus again and writes its stage
checkpoints into a directory of its own."""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from portbench.gen import inputs
from portbench.kinds import bytes_under
from portbench.reference import train_ref

NNZ_B = re.compile(r"nnz\(B\): (\d+)")
# the program's diagnostic lines that count a job's iterations
WORK = {"restarts": re.compile(r"block_ks\w*: (\d+) restarts"),
        "lloyds_projected_reps": re.compile(r"projected lloyds ran (\d+) reps"),
        "lloyds_full_reps": re.compile(r"full lloyds ran (\d+) reps")}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 workdir: str):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.workdir = workdir
        self.shape = config["shape"]
        self.train = config["train"]

    # -- set-up -----------------------------------------------------------

    def setup(self) -> None:
        from isle_tpu_torch.config import GpuConfig
        from isle_tpu_torch.corpus import Corpus

        off, rows, counts = inputs.corpus_csc(self.shape, self.seed,
                                              self.device)
        norm = inputs.normalized(off, counts, unit=False)
        self.csc = dict(offsets=off.cpu().numpy(), rows=rows.cpu().numpy(),
                        vals=norm["vals"].cpu().numpy())
        self.facts = dict(nnz=len(self.csc["rows"]),
                          avg_doc_sz=norm["avg_doc_sz"],
                          nz_docs=norm["nz_docs"])
        self.corpus = Corpus(
            vocab_size=self.shape["vocab"], num_docs=self.shape["docs"],
            offsets=self.csc["offsets"], rows=self.csc["rows"],
            counts=counts.cpu().numpy().astype(np.float32),
            vals=self.csc["vals"], avg_doc_sz=norm["avg_doc_sz"],
            nz_docs=norm["nz_docs"])
        del off, rows, counts, norm
        self.gpu = GpuConfig(device=self.device.type,
                             **self.config.get("gpu", {}))

    def edge_cols(self, n_edges: int) -> list:
        """The edge topics compared of a job that made `n_edges`: a sample
        drawn from the seed."""
        g = torch.Generator()
        g.manual_seed(inputs.stream_seed(self.seed, 50))
        n = self.traffic["edge_columns_compared"]
        return sorted(torch.randperm(n_edges, generator=g)[:n].tolist())

    def _train_config(self):
        from isle_tpu_torch.config import HyperParams, TrainConfig

        t = self.train
        return TrainConfig(
            num_topics=self.shape["k"], tf_idf=t["tf_idf"],
            sample_docs=t["sample_docs"], sample_rate=t["sample_rate"],
            compute_edge_topics=t["edge_topics"],
            max_edge_topics=t["max_edge_topics"], seed=self.seed,
            hyper=HyperParams(**t["hyper"]))

    # -- a job ------------------------------------------------------------

    def job(self, i: int, mark=None) -> dict:
        from isle_tpu_torch.trainer import Trainer

        tr = Trainer(self._train_config(),
                     output_dir=os.path.join(self.workdir, f"job{i}"),
                     quiet=True, gpu=self.gpu)
        info, diag = [], []
        tr.logger.add_sink("info", info.append)
        tr.logger.add_sink("diagnostic", diag.append)
        if mark is not None:
            from portbench.trace import STAGE_END, stage_label
            tr.logger.add_sink("timer", lambda m: mark(
                STAGE_END + stage_label(m)))
        tr.load_corpus(self.corpus)
        tr.train()
        tr.train_edge_topics()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        nnz_b = [int(m.group(1)) for m in map(NNZ_B.search, info) if m]
        n_edges = tr.edge_model.shape[1]
        work = {name: int(m.group(1)) for name, pat in WORK.items()
                for m in map(pat.search, diag) if m}
        work["edge_topics"] = n_edges
        rec = dict(
            units=1, phases={lab: w for lab, w, _ in tr.timer.phases},
            op_calls=tr.op_counter.calls, run_dir=tr.run_dir,
            work=work,
            outputs=dict(
                nnz_b=nnz_b[-1] if nnz_b else -1,
                original_cols=tr.original_cols, evalues=tr.evalues,
                centers=tr.centers, cluster_of_doc=tr.cluster_of_doc,
                thr=tr.catchword_thresholds, catchwords=tr.catchwords,
                model=tr.model, top_pairs=tr.top_pairs,
                edge_pairs=tr.edge_pairs,
                edge_cols=tr.edge_model[:, self.edge_cols(n_edges)]))
        tr.logger.close()
        rec["written"] = bytes_under(os.path.dirname(tr.run_dir))
        # the job's other files go at once: the judge reads ckpt_svd.npz
        # alone, and a file removed this soon after its write seldom
        # reaches the disk
        for name in os.listdir(tr.run_dir):
            if name != "ckpt_svd.npz":
                os.remove(os.path.join(tr.run_dir, name))
        return rec

    def end_to_end(self, recs: list, window_s: float) -> dict:
        return {"train_s": window_s / len(recs)}

    # -- after the window -------------------------------------------------

    def release(self) -> None:
        self.corpus = None

    def judge(self, recs: list) -> tuple:
        """Judge one job of the window, drawn from the seed."""
        g = torch.Generator()
        g.manual_seed(inputs.stream_seed(self.seed, 51))
        j = int(torch.randint(len(recs), (1,), generator=g))
        rec = recs[j]
        out = dict(rec["outputs"])
        with np.load(os.path.join(rec["run_dir"], "ckpt_svd.npz")) as z:
            out["zetas"], out["U"] = z["zetas"], z["U"]
        k, V = self.shape["k"], self.shape["vocab"]
        is_cw = np.zeros((k, V), bool)
        for t, words in enumerate(out.pop("catchwords")):
            is_cw[t, words] = True
        out["is_cw"] = is_cw
        E, shape = self._reference_inputs(len(out["edge_pairs"]))
        numbers, facts = train_ref.judge(out, E, shape, self.train,
                                         self.seed)
        facts.update(judged_job=j, width=self.train["hyper"][
            "block_ks_block_size"], nnz=self.facts["nnz"])
        return numbers, facts

    def control(self, precision: str) -> dict:
        """The reference's whole job in `precision`, judged in the
        program's place."""
        E, shape = self._reference_inputs(0)
        out = train_ref.pipeline(E, shape, self.train, self.seed, precision,
                                 self.edge_cols)
        shape["edge_cols"] = self.edge_cols(len(out["edge_pairs"]))
        return train_ref.judge(out, E, shape, self.train, self.seed)[0]

    def _reference_inputs(self, n_edges: int) -> tuple:
        E = train_ref.Entries(self.csc["offsets"], self.csc["rows"],
                              self.csc["vals"], self.shape["vocab"],
                              self.device)
        shape = dict(k=self.shape["k"], avg_doc_sz=self.facts["avg_doc_sz"],
                     nz_docs=self.facts["nz_docs"],
                     edge_cols=self.edge_cols(n_edges))
        return E, shape
