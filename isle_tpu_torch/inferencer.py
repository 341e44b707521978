"""Inference orchestration: load a sparse model, normalize held-out docs to
unit mass, run batched MWU on one device or doc-parallel over the ranks
of a mesh, and write the per-doc top-topic report plus the convergence /
log-likelihood aggregates. The port of isle_tpu/inferencer.py
(ISLEInfer.cpp:10-190, src/infer.cpp:327-493)."""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from . import io_text
from .config import GpuConfig, InferConfig
from .corpus import Corpus
from .mwu import build_infer_batch, infer_all
from .obs import Logger, Timer, mark_stage_in_trace, profiler_trace
from .sharding import Mesh, default_mesh, require_mesh

# the docs of one top-topics report file, as ISLEInfer.cpp:66-84 fixes it
REPORT_BLOCK_DOCS = 1_000_000


@dataclasses.dataclass
class InferResult:
    weights: np.ndarray  # (num_docs, k); uniform rows where unconverged
    converged: np.ndarray  # (num_docs,) bool
    llh_per_doc: np.ndarray
    llh_weighted: np.ndarray
    num_converged: int
    avg_llh_per_converged_doc: float
    avg_llh_per_word: float


def report_name(config: InferConfig, lo: int, hi: int) -> str:
    """The name of the report of docs [lo, hi) (1-based ids)."""
    return (f"top_topics_iters_{config.resolved_iters()}"
            f"_Lf_{config.resolved_Lf():.6f}_doc_{lo}_to_{hi}")


def write_report_blocks(output_dir: str, config: InferConfig,
                        result: InferResult, doc_begin: int) -> List[str]:
    """The top-topics report of `result` (doc `doc_begin` first), one
    file a block of REPORT_BLOCK_DOCS docs, as the reference's parallel
    inference path writes it (ISLEInfer.cpp:66-84). Returns the paths in
    doc order; their concatenation is the report of all the docs."""
    D = len(result.converged)
    paths = []
    for lo in range(0, max(D, 1), REPORT_BLOCK_DOCS):
        hi = min(lo + REPORT_BLOCK_DOCS, D)
        path = os.path.join(output_dir, report_name(
            config, doc_begin + lo, doc_begin + hi))
        io_text.write_top_topics(path, result.weights[lo:hi],
                                 result.converged[lo:hi],
                                 doc_begin=doc_begin + lo)
        paths.append(path)
    return paths


class Inferencer:
    def __init__(
        self,
        config: InferConfig,
        model: Optional[np.ndarray] = None,
        model_file: Optional[str] = None,
        output_dir: str = ".",
        quiet: bool = False,
        gpu: Optional[GpuConfig] = None,
        mesh: Optional[Mesh] = None,
    ):
        """`mesh` (or a GpuConfig.mesh_shape of more than one device, on
        an initialised torch.distributed) infers doc-parallel over its
        ranks: every rank holds the model and the corpus and returns the
        whole result; rank 0 alone writes the output directory."""
        self.config = config
        self.gpu = gpu or GpuConfig()
        self.device = self.gpu.torch_device()
        self.mesh = mesh if mesh is not None else default_mesh(
            self.gpu, self.device)
        self.is_writer = self.mesh is None or self.mesh.rank == 0
        self.output_dir = output_dir
        if self.is_writer:
            os.makedirs(output_dir, exist_ok=True)
        self.logger = Logger(output_dir if self.is_writer else None,
                             quiet=quiet or not self.is_writer)
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
        with self.timer.span("pack: model mass"):
            self.model = model.astype(np.float32)
            self.model_mass = self.model.sum(axis=1)
        self._tracing = False  # inside a GpuConfig.profile_dir trace

    def infer_corpus(self, corpus: Corpus, top_n: int = 0,
                     max_entries: Optional[int] = None) -> InferResult:
        """top_n > 0 reads back only each doc's top_n weights (the CLI
        report needs at most 5, ISLEInfer.cpp:100-111); other
        entries of converged InferResult.weights rows are 0.0 filler.

        max_entries, when given, is the avg-LLH-per-word divisor exactly
        as the CLI uses its max_entries ARGUMENT — not the actual entry
        count — even when the file holds fewer entries
        (ISLEInfer.cpp:183).

        GpuConfig.profile_dir runs it inside a torch.profiler trace, as
        Trainer.train, written to <profile_dir>/infer_<pid>_<time>.json
        (rank 0 only), with the stage ends marked in it."""
        require_mesh(self.gpu, self.mesh)
        profile_dir = self.gpu.profile_dir if self.is_writer else ""
        with profiler_trace(profile_dir, self.logger,
                            self.device.type == "cuda", name="infer") as path:
            self._tracing = path is not None
            try:
                weights, conv, llh_doc, llh_w = self._infer(corpus, top_n)
            finally:
                self._tracing = False
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

    def _infer(self, corpus: Corpus, top_n: int):
        """The pack and MWU stages of infer_corpus."""
        cfg = self.config
        batch = build_infer_batch(corpus, self.model_mass, timer=self.timer,
                                  device=self.device)
        self._next("pack inference batch")
        if self.mesh is not None:
            self.logger.info(
                f"sharded inference on {self.mesh.world} rank(s)")
        out = infer_all(
            self.model,
            batch,
            iters=cfg.resolved_iters(),
            Lf=cfg.resolved_Lf(),
            max_guesses=cfg.hyper.infer_max_guesses,
            top_n=top_n,
            device=self.device,
            mesh=self.mesh,
            timer=self.timer,
        )
        with self.timer.span("stage end: device wait"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._next("MWU inference")
        return out

    def _next(self, label: str) -> None:
        self.timer.next(label)
        if self._tracing:
            mark_stage_in_trace(label)

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
            log=self.logger.info,
        )
        self.timer.next("load inference data")
        # The file report needs only the top-5 topics per doc.
        result = self.infer_corpus(corpus, top_n=5, max_entries=max_entries)
        if write_outputs and self.is_writer:
            write_report_blocks(self.output_dir, cfg, result, doc_begin)
            self.timer.next("write top topics")
        return result
