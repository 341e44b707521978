"""Training orchestration: the port of isle_tpu.trainer's in-core paths,
on one device (Trainer._train_inner + _finish_train,
isle_tpu/trainer.py:300-582) and over several, one process a card
(_train_sharded + _finish_train_sharded, :588-875, on sharding.py), with
train_edge_topics, the stage checkpoints and the writers the training CLI
calls. B takes the hybrid layout (hybrid.py) when GpuConfig.dense_head_bytes
is positive, the default, as isle_tpu's does; the middle stages reach it
through matops.

Stage order (reference src/trainer.cpp:425-654):
  ingest -> ζ thresholds -> B = threshold + sqrt-scale [+ document
  sampling] -> truncated SVD of B B^T -> seeding (k-means++, k-means||
  or AFK-MC^2) on U^T B -> Lloyd's (projected) -> lift centers [or copy
  the seed columns of B] -> Lloyd's or Elkan's (full space) -> remap
  clusters to original docs -> r-th highest stats -> catchwords -> topic
  matrix [-> edge topics].

Checkpoints use isle_tpu's ckpt_{svd,kmeans,model}.npz schema and corpus
stamp, so train(resume=True) finishes a run from the checkpoints that the
JAX trainer wrote (and the other way round).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import io_text, native
from .bmatrix import threshold_and_copy
from .catchwords import catchword_topic_map, find_catchwords, rth_highest
from .config import GpuConfig, TrainConfig
from .corpus import Corpus, EntryFeeder, read_vocab_file
from .preprocessed import load_preprocessed
from .diagnostics import count_distinct_top_five, log_combinatorial, \
    topic_coherence, topic_diversity
from .elkans import run_elkans
from .hybrid import hybrid_from_thresholds, max_head_rows, \
    row_scale_from_zetas
from .kmeans import kmeans_init_on_projected, run_lloyds_full, \
    run_lloyds_projected
from .linalg import block_ks, block_ks_device, dense_topk_eigh, lanczos
from .matops import mat_b_y, mat_bt_x, mat_gram_x, mat_to_dense
from .obs import Logger, OpCounter, Timer, mark_stage_in_trace, \
    profiler_trace
from .rng import Draws
from .segsum import launch_counts
from .sharding import Mesh, default_mesh, require_mesh
from .sparse import DocSparse, frobenius_sq, gram_x, to_dense, \
    with_doc_tiles
from .thresholds import compute_thresholds
from .topic_model import _contribution_weights, construct_edge_topics_v2, \
    construct_topic_model, doc_topic_mass, has_catchwords, \
    l1_normalize_columns, model_thresholds, top_two_topics


def check_supported(cfg: TrainConfig) -> None:
    """Raise ValueError for the settings isle_tpu refuses as well. Every
    single-device option of isle_tpu's trainer is covered."""
    hp = cfg.hyper
    if hp.eigensolver not in ("dense", "block_ks", "lanczos"):
        raise ValueError(f"unknown eigensolver {hp.eigensolver!r}")
    if hp.kmeans_init_method not in ("kmeanspp", "kmeansbb", "kmeansmcmc"):
        raise ValueError(
            f"unknown kmeans_init_method {hp.kmeans_init_method!r}")
    if hp.kmeans_algo_for_sparse not in ("lloyds", "elkans"):
        raise ValueError(
            f"unknown kmeans_algo_for_sparse {hp.kmeans_algo_for_sparse!r}")
    if not hp.enable_kmeans_on_lowd and hp.kmeans_init_method == "kmeansbb":
        # the centers are copied from the seed docs' columns of B, and
        # k-means|| has no seed docs (hyperparams.h:56-58)
        raise ValueError(
            "enable_kmeans_on_lowd=False needs seed docs: use "
            "kmeans_init_method 'kmeanspp' or 'kmeansmcmc'"
        )


def state_from_numpy(ck: dict, device) -> dict:
    """Stage checkpoints as numpy ({stage: {name: ndarray}}, the contents
    of isle_tpu's ckpt_*.npz) -> the same dict of tensors on `device`."""
    return {
        stage: {
            name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for name, a in arrays.items()
        }
        for stage, arrays in ck.items()
    }


def solve_gram_eigens(B, V: int, k: int, cfg: TrainConfig,
                      draws, chunk: int, timer=None, logger=None,
                      start_block: Optional[torch.Tensor] = None,
                      op=None, dense_gram=None, device_loop: bool = True):
    """Top-k eigenpairs of B B^T by hyper.eigensolver, shared by the
    in-core, the streamed and the sharded trainer: block Krylov-Schur,
    Lanczos, or the dense oracle when asked for or when k is too close to
    V for a Krylov space. `device_loop` (GpuConfig.device_loop_solver)
    runs block Krylov-Schur's restart loop on the device
    (linalg.block_ks_device), else on the host (linalg.block_ks).
    `start_block` (a previous run's U) seeds block Krylov-Schur's start
    block and, by its first column, Lanczos's start vector. For a
    DocSparse or HybridSparse B the operator is matops.mat_gram_x; the
    sharded trainer hands in `op` (X -> (B B^T) X on every rank) and
    `dense_gram` (-> the (V, V) float64 Gram matrix on the host).
    Returns (evalues np.float32[k], U (V, k) tensor, stats) with stats None
    for the dense oracle and the EigResult otherwise."""
    hp = cfg.hyper
    eigensolver = hp.eigensolver  # validated by check_supported
    if eigensolver != "dense" and 2 * k + 2 >= V:
        if logger:
            logger.warning(
                f"k={k} too close to vocab={V} for a Krylov solver; "
                "falling back to the dense eigensolver"
            )
        eigensolver = "dense"
    if eigensolver == "dense":
        if dense_gram is None:
            Bd = mat_to_dense(B)
            gram = Bd @ Bd.T
        else:
            gram = dense_gram()
        w, U = dense_topk_eigh(gram, k)
        U = torch.as_tensor(U, dtype=torch.float32).to(B.device)
        return w.astype(np.float32), U, None

    if op is None:
        def op(X):
            return mat_gram_x(B, X, chunk)

    common = dict(tol=hp.block_ks_tolerance,
                  max_restarts=hp.block_ks_max_iters, timer=timer)
    if eigensolver == "lanczos":
        res = lanczos(
            op, V, k, draws, B.device, **common,
            start_vector=None if start_block is None else start_block[:, 0],
        )
    else:
        solver = block_ks_device if device_loop else block_ks
        res = solver(op, V, k, draws, B.device, blk=hp.block_ks_block_size,
                     start_block=start_block, **common)
    if res.nconv < k:
        if hp.block_ks_strict:
            raise RuntimeError(
                f"{eigensolver} converged only {res.nconv}/{k} eigenpairs "
                f"within {hp.block_ks_max_iters} restarts "
                f"(block_ks_strict=True; evals head "
                f"{res.evals[:4].tolist()})"
            )
        if logger:
            logger.warning(
                f"{eigensolver} converged only {res.nconv}/{k} eigenpairs")
    return res.evals, res.evecs, res


class Trainer:
    def __init__(
        self,
        config: TrainConfig,
        output_dir: str = ".",
        vocab_file: Optional[str] = None,
        quiet: bool = False,
        gpu: Optional[GpuConfig] = None,
        draws=None,
        mesh: Optional[Mesh] = None,
    ):
        """`mesh` (sharding.Mesh) trains over its ranks, every rank
        running this same trainer on the whole host corpus; without it,
        a GpuConfig.mesh_shape of more than one device takes the mesh of
        the initialised torch.distributed. Only rank 0 writes the run
        directory (logs, checkpoints, a trace), and only it should call
        the writers below."""
        self.config = config
        self.gpu = gpu or GpuConfig()
        self.device = self.gpu.torch_device()
        self.mesh = mesh if mesh is not None else default_mesh(
            self.gpu, self.device)
        mesh = self.mesh
        self.is_writer = mesh is None or mesh.rank == 0
        self.draws = draws if draws is not None else Draws(config.seed)
        self.output_dir = output_dir
        self.run_dir = os.path.join(output_dir, config.log_dir_name())
        if self.is_writer:
            os.makedirs(self.run_dir, exist_ok=True)
        self.logger = Logger(self.run_dir if self.is_writer else None,
                             quiet=quiet or not self.is_writer)
        self.timer = Timer(self.logger)
        self.op_counter = OpCounter("gram SpMM")
        # (stage, segsum.launch_counts() at its end), one per _mark
        self.stage_launches: List[tuple] = []
        self.vocab_file = vocab_file
        self.corpus: Optional[Corpus] = None
        self.vocab_words: List[str] = []
        self._feeder: Optional[EntryFeeder] = None
        self.is_training_complete = False
        self.A: Optional[DocSparse] = None  # the corpus on the device
        self._tracing = False  # inside a GpuConfig.profile_dir trace

        # Results (host numpy, as isle_tpu.trainer.Trainer keeps them)
        self.model: Optional[np.ndarray] = None  # (vocab, k)
        self.edge_model: Optional[np.ndarray] = None
        self.edge_pairs: Optional[np.ndarray] = None
        self.evalues: Optional[np.ndarray] = None
        self.centers: Optional[np.ndarray] = None  # (k, vocab)
        self.cluster_of_doc: Optional[np.ndarray] = None
        self.catchword_thresholds: Optional[np.ndarray] = None  # (k, vocab)
        self.catchwords: Optional[List[np.ndarray]] = None
        self.top_pairs = None
        self.original_cols: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    # Ingest
    # ------------------------------------------------------------------

    def load_data_from_file(self, tdf_path: str) -> None:
        c = self.config
        self.corpus = Corpus.from_tdf_file(
            tdf_path,
            vocab_size=c.vocab_size,
            num_docs=c.num_docs,
            tf_idf=c.tf_idf,
            int_normalized=c.hyper.use_int_normalized_counts,
            log=self.logger.info,
        )
        self._post_ingest()
        self.timer.next("load + finalize data")

    def feed_data(self, doc: int, words, counts) -> None:
        """One document: 0-based doc id, 1-based word ids, counts."""
        if self._feeder is None:
            self._feeder = EntryFeeder()
        self._feeder.feed(doc, words, counts)

    def finalize_data(self) -> None:
        if self._feeder is None:
            raise RuntimeError("feed_data first")
        c = self.config
        self.corpus = self._feeder.finalize(
            vocab_size=c.vocab_size, num_docs=c.num_docs, tf_idf=c.tf_idf,
            int_normalized=c.hyper.use_int_normalized_counts,
        )
        self._feeder = None
        self._post_ingest()
        self.timer.next("finalize data")

    def load_preprocessed(self, prefix: str) -> None:
        """The binary sidecar artifacts of preprocessed.py
        (src/trainer.cpp:296-362)."""
        self.corpus = load_preprocessed(prefix)
        self.A = None
        self._post_ingest()
        self.timer.next("load preprocessed data")

    def load_corpus(self, corpus: Corpus) -> None:
        """Train on an already assembled corpus.Corpus (or any object with
        its arrays, isle_tpu.corpus.Corpus among them)."""
        self.corpus = corpus
        self.A = None
        self._post_ingest()

    def _post_ingest(self) -> None:
        cfg = self.config
        object.__setattr__(cfg, "vocab_size", self.corpus.vocab_size)
        object.__setattr__(cfg, "num_docs", self.corpus.num_docs)
        self.vocab_words = read_vocab_file(
            self.vocab_file or "", self.corpus.vocab_size
        )
        self.logger.info(
            f"#docs: {self.corpus.num_docs}  #vocab: {self.corpus.vocab_size}  "
            f"nnz: {self.corpus.nnz}  nz_docs: {self.corpus.nz_docs}  "
            f"avg_doc_sz: {self.corpus.avg_doc_sz}"
        )

    def _mark(self, label: str) -> None:
        """Close a timed stage once the device has finished its work, and
        note the kernels' launch counts as they stand at its end."""
        with self.timer.span("stage end: device wait"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.timer.next(label)
        self.stage_launches.append((label, launch_counts()))
        if self._tracing:
            mark_stage_in_trace(label)

    def _device_A(self) -> DocSparse:
        """The corpus on the device: training and the reports
        (output_doc_topic, output_avg_topic_coherence, compute_input_svd)
        share one upload."""
        if self.A is None:
            self.A = DocSparse.from_corpus(self.corpus, self.device,
                                           timer=self.timer)
        return self.A

    def _doc_topic_mass(self, cw_topic: torch.Tensor) -> torch.Tensor:
        """The (num_docs, k) catchword mass for output_doc_topic, from the
        corpus on the device. StreamedTrainer puts its chunked pass here,
        so that its report never uploads the whole corpus."""
        return doc_topic_mass(self._device_A(), cw_topic,
                              self.config.num_topics, self.gpu.seg_chunk)

    def _warm_start_block(self, V: int) -> Optional[torch.Tensor]:
        """GpuConfig.eigen_warm_start: the U of the previous run's
        ckpt_svd.npz in this run directory, to seed the eigensolver; None
        (a cold start) without the flag, without the file, or when its
        vocab differs."""
        if not self.gpu.eigen_warm_start:
            return None
        path = os.path.join(self.run_dir, "ckpt_svd.npz")
        try:
            with np.load(path) as z:
                U = z["U"]
        except (OSError, KeyError):
            return None
        if U.shape[0] != V:
            self.logger.warning(
                f"eigen_warm_start: checkpointed U has vocab {U.shape[0]} "
                f"!= {V}; cold-starting"
            )
            return None
        self.logger.info(
            f"eigen_warm_start: seeding the eigensolver from checkpointed "
            f"U {U.shape}"
        )
        return torch.as_tensor(U, dtype=torch.float32).to(self.device)

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def train(self, resume: bool = False) -> None:
        """Run the pipeline; with resume=True, completed stages restore
        from the run directory's checkpoints (isle_tpu's schema)."""
        if self.corpus is None:
            raise RuntimeError("load data first")
        check_supported(self.config)
        require_mesh(self.gpu, self.mesh)
        inner = (self._train_inner if self.mesh is None
                 else self._train_sharded)
        self.run_traced(lambda: inner(resume))

    def run_traced(self, body) -> None:
        """body() inside the trace GpuConfig.profile_dir asks for (rank 0
        only), with the stage ends marked in it; plainly without one."""
        profile_dir = self.gpu.profile_dir if self.is_writer else ""
        with profiler_trace(profile_dir, self.logger,
                            self.device.type == "cuda") as path:
            self._tracing = path is not None
            try:
                body()
            finally:
                self._tracing = False

    def _train_inner(self, resume: bool = False) -> None:
        cfg = self.config
        hp = cfg.hyper
        k = cfg.num_topics
        V = self.corpus.vocab_size
        D = self.corpus.num_docs
        chunk = self.gpu.seg_chunk

        ck = self._load_checkpoints() if resume else {}
        if self._restore_model_checkpoint(ck):
            return
        st = state_from_numpy(ck, self.device)

        # isle_tpu's rough in-core footprint (isle_tpu/trainer.py:316-326):
        # the dual-sorted A (6 arrays), the head budget and (D, k)-class
        # working sets. Corpora past it belong in streaming.StreamedTrainer.
        est = 6 * 4 * self.corpus.nnz + self.gpu.dense_head_bytes \
            + 8 * 4 * D * k
        limit = self.gpu.hbm_limit()
        if limit is not None and est > limit:
            self.logger.warning(
                f"estimated device footprint ~{est / 2**30:.1f} GiB may "
                f"exceed the device's {limit / 2**30:.1f} GiB; consider "
                "streaming.StreamedTrainer (out-of-core) for this corpus"
            )

        A = self._device_A()
        self._mark("upload A to device")

        # 1. thresholds
        if "svd" in ck:
            zetas = st["svd"]["zetas"]
            self.original_cols = ck["svd"]["original_cols"]
            self.logger.info("resumed thresholds from 'svd' checkpoint")
        else:
            zetas, new_nnz = compute_thresholds(
                A, self.corpus.avg_doc_sz, self.corpus.nz_docs, k, hp,
                chunk,
            )
            self.logger.info(f"Entries above threshold: {new_nnz}")
            self._mark("computing thresholds")

        if "kmeans" in ck:
            self.centers = ck["kmeans"]["centers"]
            cluster_of_doc = ck["kmeans"]["cluster_of_doc"]
            self.cluster_of_doc = cluster_of_doc
            if "svd" in ck:
                self.evalues = ck["svd"]["evalues"]
            sizes = np.bincount(
                cluster_of_doc[cluster_of_doc >= 0], minlength=k
            ).astype(np.int32)
            self.logger.info("resumed clustering from 'kmeans' checkpoint")
            self._finish_train(A, cluster_of_doc, sizes)
            return

        # 2-3. B (+ importance sampling of documents); on resume, the
        # checkpointed docs, which U was computed on. In the hybrid layout
        # (isle_tpu/trainer.py:372-422) unless the head's cap refuses D
        # and GpuConfig.break_head_cap does not lift it.
        sample = cfg.sample_rate if cfg.sample_docs else None
        select = dict(sample_rate=sample)
        if "svd" in ck:
            select["docs"] = self.original_cols
        elif sample is not None:
            select["uniforms"] = self.draws.doc_sample_uniforms(D)
        budget = self.gpu.dense_head_bytes
        use_hybrid = budget > 0 and (self.gpu.break_head_cap
                                     or max_head_rows(D) >= 8)
        if budget > 0 and not use_hybrid:
            self.logger.warning(
                f"num_docs={D} exceeds the int32 flat-scatter head "
                "capacity; falling back to the COO layout"
            )
        if use_hybrid:
            B, original_cols, frob_sq = hybrid_from_thresholds(
                A, zetas, budget, break_head_cap=self.gpu.break_head_cap,
                timer=self.timer, **select)
        else:
            B, original_cols = threshold_and_copy(A, zetas, timer=self.timer,
                                                  **select)
            frob_sq = float(frobenius_sq(B))
            # B Y over doc tiles (sparse.b_y), as the hybrid tail's
            B = with_doc_tiles(B)
        if "svd" in ck and not np.array_equal(original_cols,
                                              self.original_cols):
            raise ValueError(
                f"checkpoint 'svd' in {self.run_dir}: its original_cols "
                "do not match its zetas on this corpus"
            )
        self.original_cols = original_cols
        self.logger.info(
            f"Columns remaining after thresholding: {B.num_docs}  "
            f"nnz(B): {B.nnz}  Frob(B): {np.sqrt(frob_sq):.4f}"
        )
        if use_hybrid:
            self.logger.diag(
                f"hybrid layout: {B.num_head} dense head rows cover "
                f"{B.head_nnz / max(B.nnz, 1):.0%} of nnz"
            )
            self._mark("creating thresholded matrix (fused hybrid)")
        else:
            self._mark("creating thresholded and scaled matrix")
        if B.nnz == 0 or B.num_docs == 0:
            raise ValueError(
                "thresholding dropped every entry (nnz(B)=0): the corpus "
                "is too sparse for these hyperparameters — check the "
                "few_samples_threshold_drop / bad_threshold_drop flags "
                "and eps2/eps3/w0_c"
            )

        # 4-5. truncated SVD of B B^T
        if "svd" in ck:
            self.evalues = ck["svd"]["evalues"]
            U = st["svd"]["U"]
            self.logger.info("resumed eigenvectors from 'svd' checkpoint")
        else:
            self.evalues, U, stats = solve_gram_eigens(
                B, V, k, cfg, self.draws, chunk, timer=self.timer,
                logger=self.logger, start_block=self._warm_start_block(V),
                device_loop=self.gpu.device_loop_solver,
            )
            if stats is not None:
                self.op_counter.add(stats.op_calls)
                self.logger.info(self.op_counter.summary())
        self._print_eigen_data(self.evalues, k)
        self._mark("eigen solve (B B^T)")
        if "svd" not in ck:
            self._checkpoint("svd", U=U.cpu().numpy(), evalues=self.evalues,
                             zetas=zetas.cpu().numpy(),
                             original_cols=original_cols)

        # 6. projected docs P = U^T B (k x D_B). mat_bt_x already streams
        # B without a (docs, width) intermediate, so
        # use_explicit_projected_matrix=False (isle_tpu's doc-blockwise
        # product) is the same product here.
        P = mat_bt_x(B, U, chunk).T
        self._mark("project docs")

        # 7. seeding + Lloyd's in the projected space
        seeds, centers_lowd, init_residual = kmeans_init_on_projected(
            P, k, hp.kmeans_init_reps, self.draws,
            method=hp.kmeans_init_method, timer=self.timer,
            mcmc_sample_size=hp.kmeansmcmc_sample_size,
        )
        self.logger.info(f"Best k-means init residual: {init_residual:.4f}")
        self._mark("k-means seeds initialization")
        if hp.enable_kmeans_on_lowd:
            centers_lowd, _ = run_lloyds_projected(
                P, centers_lowd, hp.max_kmeans_lowd_reps, timer=self.timer
            )
            centers_full = centers_lowd @ U.T
            self._mark("converging Lloyds k-means on B_k")
        else:  # the seed docs' columns of B
            onehot = torch.nn.functional.one_hot(seeds, B.num_docs)
            centers_full = mat_b_y(B, onehot.T.to(torch.float32), chunk).T

        # 8. Lloyd's or Elkan's on B in the full vocab space
        full_kmeans = (run_elkans if hp.kmeans_algo_for_sparse == "elkans"
                       else run_lloyds_full)
        centers_full, assign = full_kmeans(
            B, centers_full, hp.max_kmeans_reps, timer=self.timer, chunk=chunk
        )
        self.centers = centers_full.cpu().numpy()
        self._mark("k-means on B")

        # 9. remap cluster membership to original doc ids
        assign_h = assign.cpu().numpy().astype(np.int32)
        cluster_of_doc = np.full(D, -1, np.int32)
        cluster_of_doc[original_cols] = assign_h
        self.cluster_of_doc = cluster_of_doc
        sizes = np.bincount(assign_h, minlength=k).astype(np.int32)
        self._checkpoint("kmeans", centers=self.centers,
                         cluster_of_doc=cluster_of_doc)
        del B, P
        self._finish_train(A, cluster_of_doc, sizes)

    def _finish_train(self, A: DocSparse, cluster_of_doc: np.ndarray,
                      sizes: np.ndarray) -> None:
        """Stages 10-12: catchword statistics, catchwords, topic matrix."""
        cfg = self.config
        hp = cfg.hyper
        k, D = cfg.num_topics, self.corpus.num_docs
        seg_chunk = self.gpu.seg_chunk
        cluster_t = torch.as_tensor(cluster_of_doc, dtype=torch.int32).to(
            self.device)

        # 10. r-th highest element per (word, topic)
        r = hp.catchword_rank(
            D, k, cfg.sample_rate if cfg.sample_docs else None)
        if r < 1:
            self.logger.warning(
                f"catchword rank r={r} < 1 (tiny corpus); clamping to 1"
            )
            r = 1
        thr = rth_highest(
            A, cluster_t,
            torch.as_tensor(sizes, dtype=torch.int32).to(self.device),
            k, r, seg_chunk,
        )
        self.catchword_thresholds = thr.cpu().numpy()
        self._mark("collecting word freqs in clusters")

        # 11. catchwords
        is_cw_h = find_catchwords(thr, hp.rho).cpu().numpy()
        cwt = catchword_topic_map(is_cw_h)
        self.catchwords = [np.flatnonzero(is_cw_h[t]) for t in range(k)]
        self._mark("finding catchwords for clusters")

        # 12. topic model (+ top-2 pairs for edge topics)
        model, pairs = construct_topic_model(
            A,
            torch.as_tensor(cwt).to(self.device),
            cluster_t,
            k,
            hp.model_rank_threshold(D, k),
            want_top_pairs=cfg.compute_edge_topics,
            seg_chunk=seg_chunk,
        )
        self.model = model.cpu().numpy()
        extra = {}
        if pairs is not None:
            self.top_pairs = tuple(x.cpu().numpy() for x in pairs)
            extra = dict(t1=self.top_pairs[0], t2=self.top_pairs[1],
                         valid=self.top_pairs[2])
        self._mark("constructing topic vectors")
        self._checkpoint(
            "model",
            model=self.model,
            is_cw=is_cw_h,
            catchword_thresholds=self.catchword_thresholds,
            **extra,
        )
        self.is_training_complete = True

    # ------------------------------------------------------------------
    # Training over several ranks (GpuConfig.mesh_shape, sharding.Mesh)
    # ------------------------------------------------------------------

    def _train_sharded(self, resume: bool = False) -> None:
        """The same pipeline with every stage that streams the nonzeros
        sharded over the mesh's ranks (isle_tpu/trainer.py:588-810): ζ and
        the r-th highest statistic by word range, everything else by doc
        range, the eigensolver's operator, the center updates and the
        model SpMM ending in an all-reduce. k- and vocab-sized state is
        replicated. Every rank runs this method on the whole host corpus,
        cuts its own ranges from it, and ends with the same results.

        The stages, their checkpoint files and the three draw streams are
        the single-device path's, so a run may resume on another world
        size. Stages that every rank computes alone from replicated
        floats (the eigensolve, the seeding, the projected Lloyd's, the
        catchwords, the model thresholds, the top-two topics) are
        followed by a broadcast of rank 0's result: no rank decides a
        branch that holds a collective on a float that only it computed.
        Rank 0 alone reads and writes the run directory."""
        from .sharding import shard_by_word, shard_doc_sparse, \
            sharded_threshold_and_copy, sharded_thresholds

        mesh = self.mesh
        cfg = self.config
        hp = cfg.hyper
        k = cfg.num_topics
        V = self.corpus.vocab_size
        D = self.corpus.num_docs
        chunk = self.gpu.seg_chunk
        dev = self.device
        self.logger.info(f"sharded training on {mesh.world} rank(s)")

        ck = mesh.broadcast_object(
            self._load_checkpoints() if resume and self.is_writer else {})
        if self._restore_model_checkpoint(ck):
            return
        st = state_from_numpy(ck, dev)

        doc_ids = self.corpus.doc_ids()
        ssp_A = shard_doc_sparse(self.corpus.rows, doc_ids, self.corpus.vals,
                                 V, D, mesh)
        ws_A = shard_by_word(self.corpus.rows, doc_ids, self.corpus.vals,
                             V, D, mesh)
        del doc_ids
        self._mark("upload A to device (sharded)")

        # 1. thresholds, by word range
        if "svd" in ck:
            zetas = st["svd"]["zetas"]
            self.original_cols = ck["svd"]["original_cols"]
            self.logger.info("resumed thresholds from 'svd' checkpoint")
        else:
            zetas, new_nnz = sharded_thresholds(
                ws_A, self.corpus.avg_doc_sz, self.corpus.nz_docs, k, hp,
                mesh, chunk)
            self.logger.info(f"Entries above threshold: {new_nnz}")
            self._mark("computing thresholds")

        if "kmeans" in ck:
            self.centers = ck["kmeans"]["centers"]
            cluster_of_doc = ck["kmeans"]["cluster_of_doc"]
            self.cluster_of_doc = cluster_of_doc
            if "svd" in ck:
                self.evalues = ck["svd"]["evalues"]
            sizes = np.bincount(
                cluster_of_doc[cluster_of_doc >= 0], minlength=k
            ).astype(np.int32)
            self.logger.info("resumed clustering from 'kmeans' checkpoint")
            self._finish_train_sharded(ssp_A, ws_A, cluster_of_doc, sizes)
            return

        # 2-3. B, by doc range (+ importance sampling of documents); on
        # resume, the checkpointed docs, which U was computed on
        if "svd" in ck:
            B, original_cols = sharded_threshold_and_copy(
                ssp_A, zetas, mesh, docs=self.original_cols)
            if not np.array_equal(original_cols, self.original_cols):
                raise ValueError(
                    f"checkpoint 'svd' in {self.run_dir}: its original_cols "
                    "do not match its zetas on this corpus"
                )
        else:
            sample = cfg.sample_rate if cfg.sample_docs else None
            B, original_cols = sharded_threshold_and_copy(
                ssp_A, zetas, mesh, sample_rate=sample,
                uniforms=None if sample is None
                else self.draws.doc_sample_uniforms(D),
            )
        self.original_cols = original_cols
        self.logger.info(
            f"Columns remaining after thresholding: {B.num_docs}  "
            f"nnz(B): {B.nnz}  per-rank docs: {B.doc_counts}"
        )
        self._mark("creating thresholded and scaled matrix (sharded)")
        if B.nnz == 0 or B.num_docs == 0:
            raise ValueError(
                "thresholding dropped every entry (nnz(B)=0): the corpus "
                "is too sparse for these hyperparameters — check the "
                "few_samples_threshold_drop / bad_threshold_drop flags "
                "and eps2/eps3/w0_c"
            )

        cluster_of_doc = self._sharded_middle(B, zetas, original_cols, ck,
                                              self.gpu.dense_head_bytes)
        del B
        sizes = np.bincount(cluster_of_doc[cluster_of_doc >= 0],
                            minlength=k).astype(np.int32)
        self._finish_train_sharded(ssp_A, ws_A, cluster_of_doc, sizes)

    def _sharded_middle(self, B, zetas: torch.Tensor,
                        original_cols: np.ndarray, ck: dict,
                        head_bytes: int, streamed: bool = False,
                        state: Optional[dict] = None) -> np.ndarray:
        """Stages 4-9 on the mesh from B (a ShardedDocSparse), shared by
        _train_sharded and the sharded streamed trainer
        (streaming_sharded.py): with a dense head budget `head_bytes`
        (GpuConfig.dense_head_bytes, or the streamed trainer's plan), B's
        hybrid layout (sharding.shard_hybrid) for the products below; the
        eigensolve, whose operator ends in an all-reduce, with rank 0's U
        everywhere; the projected docs, gathered; the seeding and the
        projected Lloyd's, replicated, with rank 0's centers everywhere;
        Lloyd's or Elkan's on B in the full space, as
        isle_tpu/trainer.py:695-797 and streaming_sharded.py:881-945
        (the seeding copy and the dense Gram from the COO B, as there).
        Writes the svd (unless resumed from `ck`) and kmeans
        checkpoints and returns cluster_of_doc. `streamed` takes
        isle_tpu's streamed stage labels (the eigensolve's when it ran,
        then one for all of k-means) and always clusters through the
        projection, as isle_tpu's streamed trainers do. `state`, where
        given, keeps the eigenpairs for a later call (the streamed
        trainer's retry after running out of memory)."""
        from .elkans_sharded import sharded_run_elkans
        from .sharding import compact_doc_rows, pad_doc_rows, shard_hybrid, \
            sharded_b_y, sharded_bt_x, sharded_gram_x, \
            sharded_run_lloyds_full

        mesh = self.mesh
        cfg = self.config
        hp = cfg.hyper
        k = cfg.num_topics
        V, D = B.vocab, self.corpus.num_docs
        chunk = self.gpu.seg_chunk
        dev = self.device
        mark = (lambda label: None) if streamed else self._mark
        lowd = hp.enable_kmeans_on_lowd
        if streamed and not lowd:
            self.logger.warning(
                "the streamed trainer always runs k-means on the projected "
                "docs first: enable_kmeans_on_lowd=False is ignored")
            lowd = True

        if head_bytes > 0 and B.num_docs > 0:
            B_op = shard_hybrid(B, row_scale_from_zetas(zetas), mesh,
                                head_bytes)
            self.logger.diag(
                f"sharded hybrid layout: {B_op.num_head} global head rows")
            self._mark("hybrid layout (sharded)")
        else:  # the rank's B Y over doc tiles (sparse.b_y)
            B_op = dataclasses.replace(B, local=with_doc_tiles(B.local))

        # 4-5. truncated SVD of B B^T: the operator ends in an all-reduce
        reused = state is not None and "U" in state
        if "svd" in ck:
            self.evalues = ck["svd"]["evalues"]
            U = torch.from_numpy(np.ascontiguousarray(ck["svd"]["U"])).to(dev)
            self.logger.info("resumed eigenvectors from 'svd' checkpoint")
        elif reused:
            self.evalues, U = state["evalues"], state["U"]
            self.logger.info("reusing the eigenvectors of the attempt that "
                             "ran out of device memory")
        else:
            start = self._warm_start_block(V) if self.is_writer else None
            start = mesh.broadcast_object(
                None if start is None else start.cpu())

            def dense_gram():
                Bd = to_dense(B.local)
                gram = torch.from_numpy(Bd @ Bd.T).to(dev)
                return mesh.all_reduce(gram).cpu().numpy()

            evalues, U, stats = solve_gram_eigens(
                B, V, k, cfg, self.draws, chunk, timer=self.timer,
                logger=self.logger,
                start_block=None if start is None else start.to(dev),
                op=lambda X: sharded_gram_x(B_op, X, mesh, chunk),
                dense_gram=dense_gram,
                device_loop=self.gpu.device_loop_solver,
            )
            U = mesh.broadcast(U.contiguous())
            self.evalues = mesh.broadcast(
                torch.from_numpy(evalues).to(dev)).cpu().numpy()
            if stats is not None:
                self.op_counter.add(stats.op_calls)
                self.logger.info(self.op_counter.summary())
            if state is not None:
                state["evalues"], state["U"] = self.evalues, U
        self._print_eigen_data(self.evalues, k)
        if not (streamed and "svd" in ck):
            self._mark("eigen solve (B B^T, sharded)")
        if "svd" not in ck and not reused:
            self._checkpoint("svd", U=U.cpu().numpy(), evalues=self.evalues,
                             zetas=zetas.cpu().numpy(),
                             original_cols=original_cols)

        # 6. projected docs P = U^T B, replicated (k x D_B: small)
        P = compact_doc_rows(sharded_bt_x(B_op, U, mesh, chunk), mesh).T
        mark("project docs")

        # 7. seeding + Lloyd's in the projected space: replicated dense
        # work from the same draws, then rank 0's result everywhere
        seeds, centers_lowd, init_residual = kmeans_init_on_projected(
            P, k, hp.kmeans_init_reps, self.draws,
            method=hp.kmeans_init_method, timer=self.timer,
            mcmc_sample_size=hp.kmeansmcmc_sample_size,
        )
        self.logger.info(f"Best k-means init residual: {init_residual:.4f}")
        mark("k-means seeds initialization")
        if lowd:
            centers_lowd, _ = run_lloyds_projected(
                P, centers_lowd, hp.max_kmeans_lowd_reps, timer=self.timer
            )
            centers_full = mesh.broadcast(centers_lowd.contiguous()) @ U.T
            mark("converging Lloyds k-means on B_k")
        else:  # the seed docs' columns of B
            seeds = mesh.broadcast(seeds.contiguous())
            onehot = torch.nn.functional.one_hot(seeds, B.num_docs)
            centers_full = sharded_b_y(
                B, pad_doc_rows(onehot.T.to(torch.float32), B).contiguous(),
                mesh, chunk).T
        del P

        # 8. Lloyd's or Elkan's on B in the full vocab space
        full_kmeans = (sharded_run_elkans
                       if hp.kmeans_algo_for_sparse == "elkans"
                       else sharded_run_lloyds_full)
        centers_full, assign_h = full_kmeans(
            B_op, centers_full, hp.max_kmeans_reps, mesh, timer=self.timer,
            chunk=chunk)
        del B_op
        self.centers = centers_full.cpu().numpy()
        self._mark("k-means (sharded)" if streamed
                   else "k-means on B (sharded)")

        # 9. remap cluster membership to original doc ids
        cluster_of_doc = np.full(D, -1, np.int32)
        cluster_of_doc[original_cols] = assign_h
        self.cluster_of_doc = cluster_of_doc
        self._checkpoint("kmeans", centers=self.centers,
                         cluster_of_doc=cluster_of_doc)
        return cluster_of_doc

    def _finish_train_sharded(self, ssp_A, ws_A, cluster_of_doc: np.ndarray,
                              sizes: np.ndarray) -> None:
        """Stages 10-12 on the mesh (isle_tpu/trainer.py:812-874): the
        catchword statistic by word range, the doc-topic mass by doc
        range, the model SpMM all-reduced."""
        from .sharding import compact_doc_rows, pad_doc_rows, sharded_b_y, \
            sharded_doc_topic_mass, sharded_rth_highest

        mesh = self.mesh
        cfg = self.config
        hp = cfg.hyper
        k, D = cfg.num_topics, self.corpus.num_docs
        chunk = self.gpu.seg_chunk
        dev = self.device
        cluster_t = torch.as_tensor(cluster_of_doc, dtype=torch.int32).to(dev)

        # 10. r-th highest element per (word, topic)
        r = hp.catchword_rank(
            D, k, cfg.sample_rate if cfg.sample_docs else None)
        if r < 1:
            self.logger.warning(
                f"catchword rank r={r} < 1 (tiny corpus); clamping to 1"
            )
            r = 1
        thr = sharded_rth_highest(
            ws_A, cluster_t,
            torch.as_tensor(sizes, dtype=torch.int32).to(dev), k, r, mesh,
            chunk)
        self.catchword_thresholds = thr.cpu().numpy()
        self._mark("collecting word freqs in clusters (sharded)")

        # 11. catchwords
        is_cw_h = mesh.broadcast(find_catchwords(thr, hp.rho)).cpu().numpy()
        cwt = catchword_topic_map(is_cw_h)
        self.catchwords = [np.flatnonzero(is_cw_h[t]) for t in range(k)]
        self._mark("finding catchwords for clusters")

        # 12. topic model (+ top-2 pairs for edge topics): the (D, k) mass
        # is gathered, its per-topic thresholds and the top-two topics are
        # rank 0's, and each rank weighs its own docs for the model SpMM
        cwt_t = torch.as_tensor(cwt).to(dev)
        mass = compact_doc_rows(
            sharded_doc_topic_mass(ssp_A, cwt_t, k, mesh, chunk), mesh)
        thr_m = mesh.broadcast(model_thresholds(
            mass, has_catchwords(cwt_t, k), hp.model_rank_threshold(D, k)))
        extra = {}
        if cfg.compute_edge_topics:
            self.top_pairs = tuple(
                mesh.broadcast(x).cpu().numpy() for x in top_two_topics(mass))
            extra = dict(t1=self.top_pairs[0], t2=self.top_pairs[1],
                         valid=self.top_pairs[2])
        W = _contribution_weights(pad_doc_rows(mass, ssp_A), thr_m,
                                  pad_doc_rows(cluster_t, ssp_A))
        del mass
        model = l1_normalize_columns(sharded_b_y(ssp_A, W, mesh, chunk))
        self.model = model.cpu().numpy()
        self._mark("constructing topic vectors (sharded)")
        self._checkpoint(
            "model",
            model=self.model,
            is_cw=is_cw_h,
            catchword_thresholds=self.catchword_thresholds,
            **extra,
        )
        self.is_training_complete = True

    def train_edge_topics(self) -> None:
        """Edge (compound) topics (src/trainer.cpp:673-685)."""
        if not self.is_training_complete:
            raise RuntimeError("train basic topics first")
        if not self.config.compute_edge_topics:
            raise RuntimeError("edge topic flag is off")
        t1, t2, valid = self.top_pairs
        with self.timer.span("edge topics: build"):
            self.edge_model, self.edge_pairs = construct_edge_topics_v2(
                t1,
                t2,
                valid,
                self.model,
                self.config.num_topics,
                self.config.max_edge_topics,
                min_docs=self.config.hyper.edge_topic_min_docs,
                primary_ratio=self.config.hyper.edge_topic_primary_ratio,
                device=self.device,
            )
        self.timer.count("edge topics", self.edge_model.shape[1])
        self.logger.info(f"#Edge topics: {self.edge_model.shape[1]}")
        self.timer.next("constructing edge topic model")

    # ------------------------------------------------------------------
    # Outputs (the writers isle_tpu/cli/train.py calls)
    # ------------------------------------------------------------------

    def write_model_to_file(self) -> None:
        self._require_trained()
        io_text.write_sparse_model(
            os.path.join(self.run_dir, "M_hat_catch_sparse"), self.model
        )
        self.timer.next("output model")
        io_text.write_top_words(
            os.path.join(self.run_dir, "TopWordsPerTopic_catch.txt"),
            self.model,
            self.vocab_words,
            max(self.config.hyper.coherence_num_words, 10),
        )
        self.timer.next("output topwords")

    def write_edgemodel_to_file(self) -> None:
        if self.edge_model is None:
            return
        io_text.write_sparse_model(
            os.path.join(self.run_dir, "EdgeModel_sparse"), self.edge_model
        )
        io_text.write_edge_composition(
            os.path.join(self.run_dir, "EdgeTopicComposition.txt"),
            self.edge_pairs,
        )
        self.timer.next("output edge model")

    def output_doc_topic(self) -> None:
        """DocCatchword.tsv (one `<doc>\\t<word>\\t<val>` line per entry
        whose word is a catchword) and DocTopicCatchwordSums.tsv (every
        positive per-doc catchword-topic mass, by topic asc then sum
        desc); 1-based ids (src/trainer.cpp:874-1010)."""
        self._require_trained()
        k = self.config.num_topics
        cwt = np.full(self.corpus.vocab_size, -1, np.int32)
        for t in range(k):
            cwt[self.catchwords[t]] = t
        self.logger.info(
            f"Total number of catchwords: {int((cwt >= 0).sum())}"
        )
        rows = self.corpus.rows
        mask = cwt[rows] >= 0
        native.write_float_triples(
            os.path.join(self.run_dir, "DocCatchword.tsv"),
            self.corpus.doc_ids()[mask], rows[mask], self.corpus.vals[mask],
        )
        mass = self._doc_topic_mass(
            torch.as_tensor(cwt).to(self.device)).cpu().numpy()
        dd, tt = np.nonzero(mass)
        vv = mass[dd, tt]
        order = np.lexsort((-vv, tt))
        native.write_float_triples(
            os.path.join(self.run_dir, "DocTopicCatchwordSums.tsv"),
            dd[order], tt[order], vv[order],
        )
        self.timer.next("writing document catchword weights")

    def print_top_two_topics(self) -> None:
        """TopTwoTopicsPerDoc.txt: `<doc>\\t<top1>\\t<top2>` (1-based),
        doc-ascending (src/trainer.cpp:1008-1040)."""
        if self.top_pairs is None:
            raise RuntimeError("train with compute_edge_topics")
        t1, t2, valid = self.top_pairs
        d = np.flatnonzero(valid).astype(np.int32)
        native.write_int_triples(
            os.path.join(self.run_dir, "TopTwoTopicsPerDoc.txt"),
            d, t1[d], t2[d],
        )
        self.timer.next("printing top 2 topics/doc")

    def output_topic_diversity(self) -> float:
        """Average squared distance of topic vectors to the mean topic
        vector (src/trainer.cpp:750-771)."""
        self._require_trained()
        div = topic_diversity(self.model)
        self.logger.info(f"Average topic diversity: {div:.6f}")
        self.timer.next("calculating diversity")
        return div

    def output_avg_topic_coherence(self) -> Tuple[float, np.ndarray]:
        """Coherence of the catchword-free cluster-average model
        (src/trainer.cpp:705-748): construct_topic_model with no
        catchwords (every topic takes its cluster average), coherence over
        its top words, the dense dump M_hat_avg and
        TopWordsPerTopic_avg.txt. Returns (avg coherence, per-topic
        coherences)."""
        self._require_trained()
        cfg = self.config
        k = cfg.num_topics
        nw = cfg.hyper.coherence_num_words
        cwt = torch.full((self.corpus.vocab_size,), -1, dtype=torch.int32,
                         device=self.device)
        avg_model, _ = construct_topic_model(
            self._device_A(), cwt,
            torch.as_tensor(self.cluster_of_doc, dtype=torch.int32).to(
                self.device),
            k, cfg.hyper.model_rank_threshold(self.corpus.num_docs, k),
            seg_chunk=self.gpu.seg_chunk,
        )
        avg_model = avg_model.cpu().numpy()
        coherences = topic_coherence(self.corpus, avg_model, nw,
                                     cfg.hyper.coherence_eps)
        avg = float(np.mean(coherences))
        self.logger.info(f"Avg coherence without catchwords: {avg:.6f}")
        self._mark("computing coherence without catchwords")
        io_text.write_dense_model(
            os.path.join(self.run_dir, "M_hat_avg"), avg_model)
        self.timer.next("writing Mhat to file")
        io_text.write_top_words(
            os.path.join(self.run_dir, "TopWordsPerTopic_avg.txt"),
            avg_model, self.vocab_words, max(nw, 10),
        )
        self.timer.next("writing top words to file")
        return avg, coherences

    def compute_input_svd(self) -> np.ndarray:
        """Spectrum of the normalized matrix A, the reference's diagnostic
        dump (src/trainer.cpp:409-423): block_ks on A A^T with the draws
        of seed + 1. Writes A_squared_spectrum.txt and returns the squared
        singular values."""
        A = self._device_A()
        hp, k = self.config.hyper, self.config.num_topics
        res = block_ks(
            lambda X: gram_x(A, X, self.gpu.seg_chunk),
            self.corpus.vocab_size, k, Draws(self.config.seed + 1),
            self.device, blk=hp.block_ks_block_size,
            tol=hp.block_ks_tolerance, max_restarts=hp.block_ks_max_iters,
        )
        path = os.path.join(self.run_dir, "A_squared_spectrum.txt")
        with open(path, "w") as f:
            for v in res.evals:
                f.write(f"{v:.8g}\n")
        self._print_eigen_data(res.evals, k)
        self._mark("input SVD diagnostic")
        return res.evals

    def print_log_combinatorial(self) -> None:
        """LogCombinatorial.txt: the per-doc log multinomial statistic
        (src/trainer.cpp:378-389)."""
        path = os.path.join(self.run_dir, "LogCombinatorial.txt")
        with open(path, "w") as f:
            for v in log_combinatorial(self.corpus):
                f.write(f"{v:.6g}\n")
        self.timer.next("print log combinatorial")

    def print_distinct_top_five_sets(self) -> None:
        """Distinct top-5-word multiset counts (src/trainer.cpp:393-407)."""
        counts = [
            count_distinct_top_five(self.corpus, m)
            for m in (2, 5, 10, 20, 50, 100, 200, 500)
        ]
        self.logger.info(
            "Distinct top five sets: " + " ".join(str(c) for c in counts)
        )
        self.timer.next("distinct top-5 words")

    def get_model(self) -> np.ndarray:
        """The (vocab, k) model, GetBasicModel of the handle API."""
        self._require_trained()
        return self.model

    def get_edge_model(self) -> Optional[np.ndarray]:
        return self.edge_model

    def output_cluster_summary(self) -> None:
        """Catchwords, top words, cluster details, coherence, topic
        diversity (src/trainer.cpp:776-829, 750-771)."""
        self._require_trained()
        k = self.config.num_topics
        nw = self.config.hyper.coherence_num_words
        tops = io_text.top_words_per_topic(self.model, max(nw, 10))
        coh = topic_coherence(
            self.corpus, self.model, nw, self.config.hyper.coherence_eps
        )
        sizes = np.bincount(
            self.cluster_of_doc[self.cluster_of_doc >= 0], minlength=k
        )
        for t in range(k):
            cw = self.catchwords[t] if self.catchwords else []
            words = ", ".join(self.vocab_words[w] for w, _ in tops[t][:10])
            self.logger.info(
                f"---- Topic {t}: cluster_size={sizes[t]} "
                f"#catchwords={len(cw)} coherence={coh[t]:.4f}\n"
                f"     top words: {words}"
            )
            if len(cw) and self.catchword_thresholds is not None:
                thr_t = self.catchword_thresholds[t]
                detail = " ".join(
                    f"{self.vocab_words[w]}:{w}({thr_t[w]:.6g})" for w in cw
                )
                self.logger.diag(f"Catchwords:\n{detail} ")
        self.logger.info(f"Avg coherence: {float(np.mean(coh)):.4f}")
        self.logger.info(
            f"Average topic diversity: {topic_diversity(self.model):.6f}"
        )
        self.timer.next("output summary")

    # ------------------------------------------------------------------

    def _require_trained(self) -> None:
        if not self.is_training_complete:
            raise RuntimeError("train first")

    def _print_eigen_data(self, evalues: np.ndarray, k: int) -> None:
        """Singular values are sqrt of the Gram eigenvalues."""
        sv = np.sqrt(np.maximum(evalues, 0.0))
        self.logger.info(
            f"Singular values (top {min(5, k)}): "
            + ", ".join(f"{x:.4f}" for x in sv[:5])
            + f" ... lambda_k={sv[-1]:.4f}  sum={sv.sum():.2f}"
        )

    def _restore_model_checkpoint(self, ck: dict) -> bool:
        """Restore the final 'model' checkpoint (plus kmeans/svd context);
        True when training is already complete."""
        if "model" not in ck:
            return False
        k = self.config.num_topics
        m = ck["model"]
        self.model = m["model"]
        if "is_cw" in m:
            is_cw = m["is_cw"]
            self.catchwords = [np.flatnonzero(is_cw[t]) for t in range(k)]
            self.catchword_thresholds = m.get("catchword_thresholds")
        if "t1" in m:
            self.top_pairs = (m["t1"], m["t2"], m["valid"])
        if "kmeans" in ck:
            self.centers = ck["kmeans"]["centers"]
            self.cluster_of_doc = ck["kmeans"]["cluster_of_doc"]
        if "svd" in ck:
            self.evalues = ck["svd"]["evalues"]
            self.original_cols = ck["svd"]["original_cols"]
        self.logger.info("resumed from 'model' checkpoint")
        self.is_training_complete = True
        return True

    def _corpus_stamp(self) -> np.ndarray:
        """(vocab, num_docs, nnz) stamped into every stage checkpoint, so a
        checkpoint from another corpus is refused on resume."""
        c = self.corpus
        return np.array([c.vocab_size, c.num_docs, c.nnz], np.int64)

    def _load_checkpoints(self) -> dict:
        out = {}
        stamp = self._corpus_stamp()
        for stage in ("svd", "kmeans", "model"):
            path = os.path.join(self.run_dir, f"ckpt_{stage}.npz")
            if os.path.exists(path):
                with np.load(path, allow_pickle=False) as z:
                    ck = dict(z)
                got = ck.pop("corpus_stamp", None)
                if got is not None and not np.array_equal(got, stamp):
                    raise ValueError(
                        f"checkpoint '{stage}' in {self.run_dir} was "
                        f"written for a different corpus "
                        f"(vocab/docs/nnz {got.tolist()} vs "
                        f"{stamp.tolist()}); delete the stale "
                        "checkpoints or train without resume"
                    )
                out[stage] = ck
                self.logger.diag(f"found checkpoint '{stage}' at {path}")
        return out

    def _checkpoint(self, stage: str, **arrays) -> None:
        if not self.is_writer:
            return
        path = os.path.join(self.run_dir, f"ckpt_{stage}.npz")
        arrays = {k: v for k, v in arrays.items() if v is not None}
        arrays["corpus_stamp"] = self._corpus_stamp()
        with self.timer.span("checkpoint write"):
            np.savez(path, **arrays)
            self.timer.count("checkpoint bytes", os.path.getsize(path))
        self.logger.diag(f"checkpointed stage '{stage}' -> {path}")
