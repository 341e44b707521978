"""Run-time configuration of the port.

HyperParams, TrainConfig and InferConfig are isle_tpu's own (jax-free)
dataclasses; their `tpu` field is ignored. GpuConfig holds the few knobs
that map the pipeline onto the card; no TpuConfig knob comes over (the
hybrid layout, Pallas plans, precision modes and tunnel codecs have no
counterpart).
"""

from __future__ import annotations

import dataclasses

import torch

from isle_tpu.config import HyperParams, InferConfig, TrainConfig

__all__ = ["GpuConfig", "HyperParams", "InferConfig", "TrainConfig"]


@dataclasses.dataclass(frozen=True)
class GpuConfig:
    # Where the tensors live: "cuda" (the card; kernels launch) or "cpu"
    # (plain PyTorch versions, the test path).
    device: str = "cuda"
    # Entries per streamed SpMM step. Bounds the gathered (chunk, width)
    # intermediate: an unchunked gather at the NYTimes shape (48M entries,
    # width 128) would be ~25 GB.
    spmm_chunk: int = 1 << 21
    # Entries per CUDA block in the segment-sum kernels (csrc/segsum.cu).
    seg_chunk: int = 2048

    def torch_device(self) -> torch.device:
        return torch.device(self.device)
