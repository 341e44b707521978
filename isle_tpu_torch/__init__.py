"""isle-tpu-torch: the PyTorch + CUDA port of isle_tpu for NVIDIA Hopper
cards (H100): training in core (Trainer), out of core (StreamedTrainer)
and over several cards, one process a card on torch.distributed
(Trainer or StreamedTrainer with GpuConfig.mesh_shape, sharding.py,
streaming_sharded.py), MWU inference
(Inferencer, doc-parallel over the same ranks), the reports, both CLIs
and the handle API behind a C shim (capi.py, csrc/isle_capi_torch.cpp);
graft_entry.py holds the entry points of __graft_entry__.py (one
pipeline step, and a dry run over ranks that it starts).

The package keeps isle_tpu's module names so each counterpart is easy to
find (isle_tpu/thresholds.py -> isle_tpu_torch/thresholds.py, ...). Its
two Pallas segment sums (isle_tpu/pallas_ops.py) are hand-written CUDA
kernels for sm_90a in csrc/segsum.cu, built with nvcc at first use; on a
CPU tensor each wrapper runs its plain PyTorch version instead.

B's products run on isle_tpu's default engine, the hybrid dense-head /
sparse-tail layout (hybrid.py, through matops.py), unless
GpuConfig(dense_head_bytes=0) keeps B in the COO layout.

It imports nothing of isle_tpu and no jax: the host modules it needs
(config, corpus, native, io_text, diagnostics, obs) are its own copies,
and synth.py holds the synthetic NYTimes-shape corpus of chip_smoke.py.

Public surface:
    GpuConfig, HyperParams, TrainConfig  — configuration (config.py)
    InferConfig                          — inference configuration
    Corpus, EntryFeeder                  — host ingest (corpus.py)
    Trainer                              — training (trainer.py)
    StreamedTrainer                      — out-of-core training
                                           (streaming.py)
    Inferencer                           — MWU inference (inferencer.py)

TF32: importing the package turns TF32 off for float32 matmuls and
convolutions. TF32 keeps ~10 mantissa bits, the Hopper analog of the
TPU's DEFAULT-precision bf16 truncation of float32 dots; the eigensolver,
projections and Lloyd's steps need full float32. It also forbids cuBLAS
reduced-precision reductions of bf16 products: the hybrid layout's head
product (hybrid.head_dot) runs in bf16 on the tensor cores and must sum
in float32.
"""

import torch

from .config import GpuConfig, HyperParams, InferConfig, TrainConfig
from .corpus import Corpus, EntryFeeder

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__all__ = ["Corpus", "EntryFeeder", "GpuConfig", "HyperParams",
           "InferConfig", "Inferencer", "StreamedTrainer", "TrainConfig",
           "Trainer"]


def __getattr__(name):
    if name == "Trainer":
        from .trainer import Trainer

        return Trainer
    if name == "StreamedTrainer":
        from .streaming import StreamedTrainer

        return StreamedTrainer
    if name == "Inferencer":
        from .inferencer import Inferencer

        return Inferencer
    raise AttributeError(name)
