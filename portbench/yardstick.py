"""The benchmark's yardstick: the card's published peaks, the least bytes
of the eigensolve's Gram apply, and the card's name and power limit.

The peaks are NVIDIA's data sheet for the H100 SXM part, dense rates,
at the full 700 W power limit; a card set below it runs slower, so every
run prints the limit it found (card_line).
"""

from __future__ import annotations

import shutil
import subprocess

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense

# B held as COO: an int32 word, an int32 doc and a float32 value an entry
COO_BYTES_PER_ENTRY = 12


def gram_apply_bytes(nnz_b: int, vocab: int, docs: int, width: int) -> int:
    """The least bytes of one Gram apply X -> B (B^T X) at block width
    `width`: B^T X then B Y, each reading B once as COO and its operand
    once and writing its output once, in float32."""
    one = COO_BYTES_PER_ENTRY * nnz_b + 4 * (vocab + docs) * width
    return 2 * one


def gram_apply_seconds(nnz_b: int, vocab: int, docs: int, width: int,
                       calls: int) -> float:
    """The least seconds of `calls` Gram applies, bound by HBM bandwidth
    (their operations, 4 nnz(B) width each, take a tenth of that time
    at the float32 rate)."""
    return calls * gram_apply_bytes(nnz_b, vocab, docs, width) \
        / HBM_BYTES_PER_S


def card_info() -> dict:
    """The card's name and power limit as nvidia-smi reads them; empty
    strings where nvidia-smi is missing or fails."""
    out = {"name": "", "power_limit": ""}
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return out
    try:
        proc = subprocess.run(
            [smi, "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return out
    line = proc.stdout.strip().splitlines()[0] if proc.stdout.strip() \
        else ""
    if "," in line:
        name, limit = (s.strip() for s in line.split(",", 1))
        out.update(name=name, power_limit=limit)
    return out


def card_line() -> str:
    info = card_info()
    return (f"card: {info['name'] or 'unknown'}, power limit "
            f"{info['power_limit'] or 'unknown'}")
