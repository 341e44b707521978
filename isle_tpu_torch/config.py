"""Run-time configuration of the port.

HyperParams, TrainConfig and InferConfig are the port's own copies of
isle_tpu/config.py's dataclasses: the same field names, defaults,
validation and log_dir_name(), without the `tpu` field (TpuConfig's
Pallas plans, precision modes and tunnel codecs have no counterpart
here). GpuConfig holds the few knobs that map the pipeline onto the card,
TpuConfig's dense_head_bytes and break_head_cap (the hybrid layout,
hybrid.py), resident_corpus_bytes and hbm_bytes (the streamed trainer's
resident corpus and memory plan, streaming.py) among them.

Defaults follow the reference's compile-time constants
(include/hyperparams.h:8-82, include/types.h:23-86).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

__all__ = ["GpuConfig", "HyperParams", "InferConfig", "TrainConfig"]


@dataclasses.dataclass(frozen=True)
class HyperParams:
    """Algorithm constants of the TSVD topic-model pipeline.

    Names and defaults follow reference include/hyperparams.h:8-82.
    """

    # Provable-algorithm constants (hyperparams.h:8-12).
    w0: float = 1.0
    eps1: float = 1.0 / 60.0
    eps2: float = 1.0 / 3.0
    rho: float = 1.1
    eps3: float = 5.0

    # USE_INT_NORMALIZED_COUNTS (hyperparams.h:14; include/types.h:82-86):
    # normalized values are ceil(avg_doc_sz * count / doc_sum) integers.
    use_int_normalized_counts: bool = False

    # FEW_SAMPLES_THRESHOLD_DROP (hyperparams.h:16-21): a word in fewer
    # docs than count_gr gets zeta = +inf (dropped) instead of 1.
    few_samples_threshold_drop: bool = False

    # BAD_THRESHOLD_DROP (hyperparams.h:23-25): a word whose downward zeta
    # walk exhausts gets zeta = +inf (dropped) instead of 1.
    bad_threshold_drop: bool = False

    # Eigensolver (hyperparams.h:31-40): "block_ks" (the reference's
    # default), "lanczos" (single-vector thick-restart Lanczos, the
    # independent cross-check) or "dense" (the full dense
    # eigendecomposition oracle, for small problems). The reference's
    # block size is 10; 128 is isle_tpu's default, kept so both packages
    # take the same Krylov blocks.
    eigensolver: str = "block_ks"
    block_ks_max_iters: int = 100
    block_ks_block_size: int = 128
    block_ks_tolerance: float = 1e-4
    # Raise if fewer than nev pairs converge within the restart cap, as
    # the reference's assert does (src/sparseMatrix.cpp:1207); False
    # warns and proceeds.
    block_ks_strict: bool = False

    # Streaming block size over documents (hyperparams.h:42).
    doc_block_size: int = 1 << 18

    # USE_EXPLICIT_PROJECTED_MATRIX (hyperparams.h:44).
    use_explicit_projected_matrix: bool = True

    # k-means configuration (hyperparams.h:46-68).
    kmeans_init_method: str = "kmeanspp"  # kmeanspp | kmeansbb | kmeansmcmc
    kmeans_init_reps: int = 1
    # AFK-MC^2 Markov-chain batch size (hyperparams.h:54).
    kmeansmcmc_sample_size: int = 10000
    enable_kmeans_on_lowd: bool = True
    max_kmeans_lowd_reps: int = 10
    kmeans_algo_for_sparse: str = "lloyds"  # lloyds | elkans
    max_kmeans_reps: int = 10

    # Topic construction (hyperparams.h:72-79).
    avg_cluster_for_catchless_topic: bool = True
    edge_topic_min_docs: int = 1
    edge_topic_primary_ratio: float = 0.7

    # Coherence reporting (hyperparams.h:74-75).
    coherence_eps: float = 1e-5
    coherence_num_words: int = 5

    # Inference defaults (hyperparams.h:81-82; include/infer.h:52).
    infer_iters_default: int = 15
    infer_Lf_default: float = 10.0
    infer_max_guesses: int = 10  # Lf-doubling retries (src/infer.cpp:416)

    def count_gr(self, nz_docs: int, num_topics: int) -> int:
        """#(freqs > zeta) requirement (src/sparseMatrix.cpp:370)."""
        c = int(self.w0 * float(nz_docs) / (2.0 * float(num_topics)))
        return max(c, 1)

    def count_eq(self, nz_docs: int, num_topics: int) -> int:
        """#(freqs == zeta) cap (src/sparseMatrix.cpp:371)."""
        c = int(
            math.ceil(3.0 * self.eps1 * self.w0 * float(nz_docs)
                      / float(num_topics))
        )
        return max(c, 1)

    def catchword_rank(
        self, num_docs: int, num_topics: int,
        sample_rate: Optional[float] = None,
    ) -> int:
        """r for the r-th-highest catchword statistic
        (src/trainer.cpp:580-584)."""
        n = (float(num_docs) if sample_rate is None
             else float(num_docs) * sample_rate)
        return int(math.floor(self.eps2 * self.w0 * n
                              / (2.0 * float(num_topics))))

    def model_rank_threshold(self, num_docs: int, num_topics: int) -> int:
        """Per-topic doc-sum rank threshold (src/sparseMatrix.cpp:722)."""
        return int(self.eps3 * self.w0 * float(num_docs)
                   / (float(num_topics) * 2.0))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Everything `ISLETrain` takes on the CLI (drivers/ISLETrain.cpp:9-32)
    plus the seed and hyperparameter overrides."""

    num_topics: int
    vocab_size: int = 0  # 0 = infer from data (src/trainer.cpp:249-261)
    num_docs: int = 0  # 0 = infer from data
    tf_idf: bool = False
    sample_docs: bool = False
    sample_rate: float = 0.0
    compute_edge_topics: bool = False
    max_edge_topics: int = 0
    seed: int = 0
    hyper: HyperParams = dataclasses.field(default_factory=HyperParams)

    def log_dir_name(self) -> str:
        """Config-encoded run-directory name (src/utils.cpp:28-48)."""
        h = self.hyper
        return (
            f"log_t_{self.num_topics}_eps1_{h.eps1:.6f}_eps2_{h.eps2:.6f}"
            f"_eps3_{h.eps3:.6f}_rho_{h.rho:.2f}"
            f"_sample_{int(self.sample_docs)}_rate_{self.sample_rate:.3f}"
            f"_tfidf_{int(self.tf_idf)}_seed_{self.seed}"
        )


@dataclasses.dataclass(frozen=True)
class InferConfig:
    """Everything `ISLEInfer` takes on the CLI
    (drivers/ISLEInfer.cpp:10-36)."""

    num_topics: int
    vocab_size: int
    iters: int = 0  # 0 = INFER_ITERS_DEFAULT
    Lf: float = 0.0  # 0 = INFER_LF_DEAFULT
    hyper: HyperParams = dataclasses.field(default_factory=HyperParams)

    def resolved_iters(self) -> int:
        return self.iters if self.iters > 0 else self.hyper.infer_iters_default

    def resolved_Lf(self) -> float:
        return self.Lf if self.Lf > 0.0 else self.hyper.infer_Lf_default


@dataclasses.dataclass(frozen=True)
class GpuConfig:
    # Where the tensors live: "cuda" (the card; kernels launch) or "cpu"
    # (plain PyTorch versions, the test path).
    device: str = "cuda"
    # Entries per slice (one warp's work unit) of the segment-sum kernels
    # of csrc/segsum.cu: segsum_onehot and segsum_gather_rows, and so the
    # SpMM.
    seg_chunk: int = 2048
    # Budget in bytes of the dense head of the hybrid layout (hybrid.py):
    # B's most frequent words as a bf16 binary (words x docs) matrix, its
    # products on the tensor cores, the other entries a sparse tail on
    # segsum_gather_rows. isle_tpu's TpuConfig.dense_head_bytes and its
    # default, so a default run of either package takes the same path;
    # 0 keeps all of B in the COO layout (sparse.py).
    dense_head_bytes: int = 4096 << 20
    # Lift isle_tpu's int32 row cap on the dense head (hybrid.max_head_rows:
    # 7,153 rows at 300,000 docs, about 4 GiB of head at any doc count),
    # so that the in-core and streamed trainers build budget // (2 docs)
    # rows; the sharded layouts keep the cap, as isle_tpu's do.
    # isle_tpu's TpuConfig.break_head_cap and its default. The port
    # indexes the head in int64, so no doc blocks are needed here; raise
    # dense_head_bytes together with it.
    break_head_cap: bool = False
    # Streamed (out-of-core) runs: the device bytes a resident copy of the
    # corpus may take (streaming.ResidentLoader: word ids int32 and the
    # raw counts in their smallest integer dtype, about 5 bytes an entry,
    # or the values float32), so that the corpus crosses the host link
    # once instead of once a pass. isle_tpu's
    # TpuConfig.resident_corpus_bytes and its default, so a default run of
    # either package takes the same loader; 0, or a corpus over the
    # budget, copies the chunks on every pass (streaming.ChunkLoader).
    resident_corpus_bytes: int = 6 << 30
    # Device memory the streamed trainer plans its middle stages in
    # (streaming.plan_middle_budget: whether the resident corpus stays
    # held beside B's layout, and with how large a dense head) and the
    # in-core trainer holds its footprint estimate against. 0 takes the
    # card's total memory, and on a CPU device sets no limit (the slabs
    # stay held, the configured head is built). isle_tpu's
    # TpuConfig.hbm_bytes, whose 14 GiB describe a v5e.
    hbm_bytes: int = 0
    # Seed the eigensolver from the U of the previous run's ckpt_svd.npz
    # in the same run directory (block_ks: the start block; lanczos: its
    # first column), isle_tpu's TpuConfig.eigen_warm_start.
    eigen_warm_start: bool = False
    # Run the eigensolver's restart loop on the device, its Ritz step a
    # float64 eigh there (linalg.block_ks_device: no host readback a
    # restart but the stop test's), isle_tpu's
    # TpuConfig.device_loop_solver; False takes the host-driven loop with
    # per-restart diagnostics (linalg.block_ks). Lanczos and the dense
    # oracle ignore it.
    device_loop_solver: bool = True
    # Devices along the document axis, isle_tpu's TpuConfig.mesh_shape:
    # one process a card on torch.distributed, as many ranks as the shape
    # asks for (sharding.py). Trainer, StreamedTrainer and Inferencer
    # shard over them.
    mesh_shape: Optional[Tuple[int, ...]] = None
    # When set, Trainer.train() and StreamedTrainer.train() run inside a
    # torch.profiler trace (CPU and, on the card, CUDA activities) whose
    # Chrome trace is written into this directory: isle_tpu's
    # TpuConfig.profile_dir.
    profile_dir: str = ""

    def mesh_devices(self) -> int:
        """Total devices asked for by mesh_shape (1 = a single device)."""
        return math.prod(self.mesh_shape) if self.mesh_shape else 1

    def torch_device(self) -> torch.device:
        return torch.device(self.device)

    def hbm_limit(self) -> Optional[int]:
        """hbm_bytes as the planners read it: the bytes given, else the
        card's total memory, else (0 on a CPU device) None, no limit."""
        if self.hbm_bytes:
            return self.hbm_bytes
        dev = self.torch_device()
        if dev.type == "cuda":
            return torch.cuda.get_device_properties(dev).total_memory
        return None
