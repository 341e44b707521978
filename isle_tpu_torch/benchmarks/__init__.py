"""The port's micro-benchmark drivers, counterparts of the repository's
benchmarks/ scripts that run a TPU kernel:

    python -m isle_tpu_torch.benchmarks.micro_pallas         (micro_pallas.py)
    python -m isle_tpu_torch.benchmarks.micro_pallas_gather  (micro_pallas_gather.py)

They run on the card (--device cuda, the default) and time by the
reference's rule: the least of 5 runs after a warm-up, here with CUDA
events.
"""

from __future__ import annotations

import torch

REPS = 5


def min_ms(fn, reps: int = REPS) -> float:
    """The least milliseconds of `reps` calls of fn() after one warm-up,
    each call between its own pair of CUDA events."""
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return min(start.elapsed_time(end) for start, end in pairs)


def maxrel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The benchmarks' error measure: max |got - ref| / max |ref|."""
    ref = ref.double()
    return float((got.double() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def require_card(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit(f"the micro-benchmarks time CUDA kernels: no CUDA "
                         f"device for --device {device}")
    return dev
