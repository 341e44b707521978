"""Inference orchestration: load a sparse model, normalize held-out docs to
unit mass, run batched MWU on one device, and write the per-doc
top-topic report plus the convergence / log-likelihood aggregates. The
port of isle_tpu/inferencer.py (ISLEInfer.cpp:10-190,
src/infer.cpp:327-493) without the mesh."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from . import io_text
from .config import GpuConfig, InferConfig
from .corpus import Corpus
from .mwu import build_infer_batch, infer_all
from .obs import Logger, Timer


@dataclasses.dataclass
class InferResult:
    weights: np.ndarray  # (num_docs, k); uniform rows where unconverged
    converged: np.ndarray  # (num_docs,) bool
    llh_per_doc: np.ndarray
    llh_weighted: np.ndarray
    num_converged: int
    avg_llh_per_converged_doc: float
    avg_llh_per_word: float


class Inferencer:
    def __init__(
        self,
        config: InferConfig,
        model: Optional[np.ndarray] = None,
        model_file: Optional[str] = None,
        output_dir: str = ".",
        quiet: bool = False,
        gpu: Optional[GpuConfig] = None,
    ):
        self.config = config
        self.device = (gpu or GpuConfig()).torch_device()
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.logger = Logger(output_dir, quiet=quiet)
        self.timer = Timer(self.logger)
        if model is None:
            if model_file is None:
                raise ValueError("give a model or a model_file")
            model = io_text.load_sparse_model(
                model_file, config.num_topics, config.vocab_size, base=1
            )
            self.timer.next("load sparse model")
        if model.shape != (config.vocab_size, config.num_topics):
            raise ValueError(
                f"model shape {model.shape} != (vocab_size, num_topics) "
                f"{(config.vocab_size, config.num_topics)}"
            )
        self.model = model.astype(np.float32)
        self.model_mass = self.model.sum(axis=1)

    def infer_corpus(self, corpus: Corpus, top_n: int = 0,
                     max_entries: Optional[int] = None) -> InferResult:
        """top_n > 0 reads back only each doc's top_n weights (the CLI
        report needs at most 5, ISLEInfer.cpp:100-111); other
        entries of converged InferResult.weights rows are 0.0 filler.

        max_entries, when given, is the avg-LLH-per-word divisor exactly
        as the CLI uses its max_entries ARGUMENT — not the actual entry
        count — even when the file holds fewer entries
        (ISLEInfer.cpp:183)."""
        cfg = self.config
        batch = build_infer_batch(corpus, self.model_mass)
        self.timer.next("pack inference batch")
        weights, conv, llh_doc, llh_w = infer_all(
            self.model,
            batch,
            iters=cfg.resolved_iters(),
            Lf=cfg.resolved_Lf(),
            max_guesses=cfg.hyper.infer_max_guesses,
            top_n=top_n,
            device=self.device,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timer.next("MWU inference")
        nconv = int(conv.sum())
        D = corpus.num_docs
        total_entries = max_entries if max_entries else corpus.nnz
        # Aggregates exactly as the CLI reports them
        # (ISLEInfer.cpp:166-183).
        avg_doc = (
            (float(D) / nconv) * llh_doc.sum() / nconv if nconv else 0.0
        )
        avg_word = llh_w.sum() / total_entries if total_entries else 0.0
        self.logger.info(
            f"Number of docs for which inference converged: {nconv} (of {D})"
        )
        self.logger.info(f"Avg LLH per document for converged docs: {avg_doc:.6f}")
        self.logger.info(f"Avg LLH per word: {avg_word:.6f}")
        return InferResult(
            weights=weights,
            converged=conv,
            llh_per_doc=llh_doc,
            llh_weighted=llh_w,
            num_converged=nconv,
            avg_llh_per_converged_doc=float(avg_doc),
            avg_llh_per_word=float(avg_word),
        )

    def infer_file(
        self,
        tdf_path: str,
        doc_begin: int,
        doc_end: int,
        max_entries: Optional[int] = None,
        write_outputs: bool = True,
    ) -> InferResult:
        """Full CLI path: read TDF (doc ids rebased to doc_begin), normalize
        each doc to unit mass, infer, write the top-topics files."""
        cfg = self.config
        corpus = Corpus.from_tdf_file(
            tdf_path,
            vocab_size=cfg.vocab_size,
            num_docs=doc_end - doc_begin,
            max_entries=max_entries,
            normalize_to_one=True,
            doc_base_offset=doc_begin - 1,
        )
        self.timer.next("load inference data")
        # The file report needs only the top-5 topics per doc.
        result = self.infer_corpus(corpus, top_n=5, max_entries=max_entries)
        if write_outputs:
            # One output file per 1M-doc block, as the reference's parallel
            # inference path does (ISLEInfer.cpp:66-84).
            block = 1_000_000
            D = corpus.num_docs
            for lo in range(0, max(D, 1), block):
                hi = min(lo + block, D)
                name = (
                    f"top_topics_iters_{cfg.resolved_iters()}"
                    f"_Lf_{cfg.resolved_Lf():.6f}"
                    f"_doc_{doc_begin + lo}_to_{doc_begin + hi}"
                )
                io_text.write_top_topics(
                    os.path.join(self.output_dir, name),
                    result.weights[lo:hi],
                    result.converged[lo:hi],
                    doc_begin=doc_begin + lo,
                )
            self.timer.next("write top topics")
        return result
