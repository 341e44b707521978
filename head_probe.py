"""Accuracy and time of the hybrid layout's head product on one NVIDIA GPU,
at the NYTimes head shape (isle_tpu_torch.hybrid.head_dot: one bf16 GEMM
with a float32 output over the operand's three bf16 pieces).

    python3 head_probe.py [--docs N] [--rows R]

A random binary head of R rows over N docs whose row densities fall like
a Zipf head (the first rows in nearly every doc, the last in about 0.5%),
with an aligned row stride as hybrid.py allocates it. For widths 128,
100 and 1 in both directions (head^T X and head Y), against the float64
product on a sample of rows:

  - head_dot as the port runs it;
  - the same split GEMM over doc blocks of 8,192 / 32,768 docs added in
    order, which shortens the float32 accumulation of head Y (K = docs);
  - cuBLAS's float32 GEMM on the head upcast to float32 (TF32 off).

Prints each variant's largest error over |head| |X| (elementwise) and
over ||head|| ||X|| (Frobenius), its time (CUDA events, mean of 5 after
a warm-up) and the bound: the head read once at 3.35 TB/s or 3 x 2 R N W
operations at the 989 TFLOP/s bf16 peak. Last, head^T X at width 128
over N - 1 docs two ways: the head's rows at the aligned stride
hybrid.py gives them, and a contiguous copy whose rows start anywhere
(why hybrid._alloc_head pads the stride). Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
REPS = 5


def time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def blocked(head, other, transpose, blk):
    """head_dot's split GEMM over blocks of `blk` docs, added in order."""
    from isle_tpu_torch import hybrid

    def mm(a, b):
        return torch.mm(a, b, out_dtype=torch.float32)

    D = head.shape[1]
    if transpose:  # docs are the output rows: blocks are independent
        return torch.cat([hybrid._split_gemm(head[:, lo:lo + blk].T, other,
                                             mm)
                          for lo in range(0, D, blk)])
    out = None
    for lo in range(0, D, blk):
        part = hybrid._split_gemm(head[:, lo:lo + blk], other[lo:lo + blk],
                                  mm)
        out = part if out is None else out + part
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=300_000)
    ap.add_argument("--rows", type=int, default=7_153)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("head_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from isle_tpu_torch import hybrid

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    R, D = args.rows, args.docs
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    head = hybrid._alloc_head(R, D, dev)
    density = 0.9 * (torch.arange(R, device=dev) + 1.0) ** -0.75 + 0.005
    for lo in range(0, R, 512):  # row blocks keep the temporaries small
        hi = min(lo + 512, R)
        head[lo:hi] = (torch.rand((hi - lo, D), device=dev, generator=g)
                       < density[lo:hi, None]).to(torch.bfloat16)
    nnz = int(head.sum(dtype=torch.float64))
    print(f"head {R} x {D} bf16 ({R * D * 2 / 1e9:.3f} GB), {nnz} ones "
          f"({nnz / (R * D):.3%}), rows from {float(density[0]):.1%} to "
          f"{float(density[-1]):.2%} dense")
    # sample rows: the densest and a spread of the rest
    rows = torch.cat([torch.arange(64, device=dev),
                      torch.linspace(64, R - 1, 64, device=dev).long()])
    cols = torch.arange(0, D, max(D // 4096, 1), device=dev)
    for W in (128, 100, 1):
        for transpose in (False, True):
            n = R if transpose else D
            X = torch.randn((n, W), device=dev, generator=g)
            if transpose:  # the sample: some doc rows of head^T X
                sub = head[:, cols].double()
                ref, scale = sub.T @ X.double(), sub.T @ X.double().abs()
                pick = cols
            else:
                sub = head[rows].double()
                ref, scale = sub @ X.double(), sub @ X.double().abs()
                pick = rows
            del sub
            variants = {
                "head_dot": lambda: hybrid.head_dot(head, X, transpose),
                "blocked 8192": lambda: blocked(head, X, transpose, 8192),
                "blocked 32768": lambda: blocked(head, X, transpose, 32768),
                "float32 GEMM, head upcast": lambda: hybrid.head_dot_plain(
                    head, X, transpose),
            }
            t_bytes = R * D * 2 / 3.35e12
            t_ops = 3 * 2 * R * D * W / 989e12
            bound = max(t_bytes, t_ops) * 1e3
            direction = "head^T X" if transpose else "head Y"
            print(f"{direction}, width {W}: bound {bound:.3f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'})")
            for name, fn in variants.items():
                got = fn()[pick].double()
                err = (got - ref).abs()
                elem = float((err / scale.clamp(min=1e-300)).max())
                normw = float(torch.linalg.norm(got - ref)
                              / torch.linalg.norm(scale))
                print(f"  {name}: {time_ms(fn):.3f} ms, max err / (|head| "
                      f"|X|) {elem:.2e}, ||err|| / || |head| |X| || "
                      f"{normw:.2e}")
            del X, ref, scale
    X = torch.randn((R, 128), device=dev, generator=g)
    view = head[:, :D - 1]
    packed = view.contiguous()
    aligned_ms = time_ms(lambda: hybrid.head_dot(view, X, True))
    packed_ms = time_ms(lambda: hybrid.head_dot(packed, X, True))
    print(f"head^T X, width 128, {D - 1} docs: rows at stride "
          f"{view.stride(0)} {aligned_ms:.3f} ms, rows packed at stride "
          f"{packed.stride(0)} {packed_ms:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
