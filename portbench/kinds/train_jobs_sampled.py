"""Traffic kind `train_jobs_sampled`: the closed loop of whole training
jobs of `train_jobs` (a fresh Trainer on the corpus made in set-up:
load_corpus, train(), train_edge_topics(), a synchronize) for a
configuration that samples its documents, judged against the sampling
reference (portbench/reference/train_sampled_ref.py).

Each job trains with a seed of its own, drawn from --seed and the job's
index: a retrained model samples its docs and seeds its k-means anew. The
training seed decides how many edge topics a job builds (at UCI PubMed's
shape about 1,000 to 2000), so a window of jobs on one seed would time one draw
of that work, and a window of jobs on seeds of their own times its mean."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from portbench.gen import inputs
from portbench.kinds import train_jobs
from portbench.reference import train_sampled_ref

# the streams of the jobs' training seeds: job i (-1 the warm-up) draws
# from TRAIN_SEEDS + i
TRAIN_SEEDS = 1000


class Cell(train_jobs.Cell):
    def train_seed(self, i: int) -> int:
        """The training seed of job `i` (-1 the warm-up)."""
        return inputs.stream_seed(self.seed, TRAIN_SEEDS + i)

    def _train_config(self):
        return dataclasses.replace(super()._train_config(),
                                   seed=self._job_seed)

    def job(self, i: int, mark=None) -> dict:
        self._job_seed = self.train_seed(i)
        rec = super().job(i, mark)
        rec["train_seed"] = self._job_seed
        return rec

    def judge(self, recs: list) -> tuple:
        """Judge one job of the window, drawn from the seed, against the
        reference on that job's training seed."""
        g = torch.Generator()
        g.manual_seed(inputs.stream_seed(self.seed, 51))
        j = int(torch.randint(len(recs), (1,), generator=g))
        rec = recs[j]
        out = dict(rec["outputs"])
        with np.load(os.path.join(rec["run_dir"], "ckpt_svd.npz")) as z:
            out["zetas"], out["U"] = z["zetas"], z["U"]
        is_cw = np.zeros((self.shape["k"], self.shape["vocab"]), bool)
        for t, words in enumerate(out.pop("catchwords")):
            is_cw[t, words] = True
        out["is_cw"] = is_cw
        E, shape = self._reference_inputs(len(out["edge_pairs"]))
        numbers, facts = train_sampled_ref.judge(out, E, shape, self.train,
                                                 rec["train_seed"])
        facts.update(judged_job=j, train_seed=rec["train_seed"],
                     train_seeds=[r["train_seed"] for r in recs],
                     nnz=self.facts["nnz"])
        return numbers, facts

    def control(self, precision: str) -> dict:
        """The sampling reference's whole job in `precision`, judged in the
        program's place."""
        E, shape = self._reference_inputs(0)
        out = train_sampled_ref.pipeline(E, shape, self.train, self.seed,
                                         precision, self.edge_cols)
        shape["edge_cols"] = self.edge_cols(len(out["edge_pairs"]))
        return train_sampled_ref.judge(out, E, shape, self.train,
                                       self.seed)[0]
