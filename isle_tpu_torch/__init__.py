"""isle-tpu-torch: the PyTorch + CUDA port of isle_tpu's single-device
in-core training path and its MWU inference, for one NVIDIA Hopper card
(H100).

The package keeps isle_tpu's module names so each counterpart is easy to
find (isle_tpu/thresholds.py -> isle_tpu_torch/thresholds.py, ...). Its
two Pallas segment sums (isle_tpu/pallas_ops.py) are hand-written CUDA
kernels for sm_90a in csrc/segsum.cu, built with nvcc at first use; on a
CPU tensor each wrapper runs its plain PyTorch version instead.

Only these jax-free host modules of isle_tpu are imported: config
(HyperParams, TrainConfig), corpus, native, io_text, diagnostics,
preprocessed and obs (Logger, Timer, OpCounter). Nothing here imports jax.

Public surface:
    GpuConfig, HyperParams, TrainConfig  — configuration (config.py)
    InferConfig                          — inference configuration
    Corpus                               — host ingest (isle_tpu.corpus)
    Trainer                              — in-core training (trainer.py)
    Inferencer                           — MWU inference (inferencer.py)

TF32: importing the package turns TF32 off for float32 matmuls and
convolutions. TF32 keeps ~10 mantissa bits, the Hopper analog of the
TPU's DEFAULT-precision bf16 truncation of float32 dots; the eigensolver,
projections and Lloyd's steps need full float32.
"""

import torch
from isle_tpu.corpus import Corpus

from .config import GpuConfig, HyperParams, TrainConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["Corpus", "GpuConfig", "HyperParams", "InferConfig", "Inferencer",
           "TrainConfig", "Trainer"]


def __getattr__(name):
    if name == "Trainer":
        from .trainer import Trainer

        return Trainer
    if name == "Inferencer":
        from .inferencer import Inferencer

        return Inferencer
    if name == "InferConfig":
        from .config import InferConfig

        return InferConfig
    raise AttributeError(name)
