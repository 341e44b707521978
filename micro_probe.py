"""The micro-benchmarks' kernels (csrc/micro.cu) against an earlier
version of the same source, on one NVIDIA GPU, at the shapes of
chip_smoke.py's phase M.

    python3 micro_probe.py --old path/to/micro.cu [--seed S]

The current source is built as the port builds it (isle_tpu_torch/
_build.py); the --old one (for example `git show <commit>:isle_tpu_torch/
csrc/micro.cu` saved under build/) is built alone by nvcc with the same
flags into a second library, each loaded through its own ctypes.CDLL. At
both drivers' shapes (isle_tpu_torch/benchmarks/: n = 2^24, W = 128,
chunk 2048 over the two segment streams and three modes; 2^22 rows of a
102,660 x 128 table at the four (chunk, depth)) it

  1. holds the new chunk_partials kernels bit for bit against the old ones
     and both gathers against index_select;
  2. times old, new, new, old with the drivers' min_ms (least of 5 after
     a warm-up, CUDA events), beside the library call (index_add_,
     index_select) and the bound (chip_smoke.bound);
  3. prints each new kernel's threads, dynamic shared memory, registers,
     blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
     grid (micro_kernels.kernel_info), and ptxas's lines for micro.cu.

Prints the card's line, a line per use and a JSON line of the numbers;
exits with code 1 if a kernel differs, 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

import chip_smoke as cs

ENTRIES = ("isle_chunk_onehot_partials_f32", "isle_row_gather_bulk_f32")


def partials_with(lib, rank, g, chunk: int, rcap: int, mode: str):
    from isle_tpu_torch import micro_kernels as mk
    from isle_tpu_torch.segsum import _launch_args, _raise_on_error

    n, W = g.shape
    out = torch.empty((n // chunk, rcap, W), dtype=torch.float32,
                      device=g.device)
    device, stream = _launch_args(g)
    _raise_on_error("partials", lib.isle_chunk_onehot_partials_f32(
        rank.data_ptr(), g.data_ptr(), n, W, chunk, rcap,
        mk.MODES.index(mode), out.data_ptr(), device, stream))
    return out


def gather_with(lib, idx, tab, chunk: int, depth: int):
    from isle_tpu_torch.segsum import _launch_args, _raise_on_error

    out = torch.empty((idx.numel(), tab.shape[1]), dtype=torch.float32,
                      device=tab.device)
    device, stream = _launch_args(idx)
    _raise_on_error("gather", lib.isle_row_gather_bulk_f32(
        idx.data_ptr(), tab.data_ptr(), idx.numel(), tab.shape[0],
        tab.shape[1], chunk, depth, out.data_ptr(), device, stream))
    return out


def in_turns(old_fn, new_fn) -> tuple:
    """(old ms, new ms): min_ms of old, new, new, old; each side's least."""
    from isle_tpu_torch.benchmarks import min_ms

    a1, b1, b2, a2 = (min_ms(f) for f in (old_fn, new_fn, new_fn, old_fn))
    return min(a1, a2), min(b1, b2)


def info_line(info: dict) -> str:
    return (f"{info['threads']} threads, {info['smem_bytes']} B shared, "
            f"{info['registers']} registers, {info['blocks_per_sm']} "
            f"blocks/SM, grid {info['grid']}")


def partials_uses(old, seed: int) -> list:
    from isle_tpu_torch import micro_kernels as mk
    from isle_tpu_torch.benchmarks import micro_pallas as bp

    n, W, C = cs.MICRO["n"], cs.MICRO["width"], cs.MICRO["chunk"]
    rows = []
    for label, avg_run, segments in bp.STREAMS:
        nseg = segments(n)
        seg, g = bp.stream_inputs(n, W, avg_run, nseg, seed, "cuda")
        rank2d, ids, rcap = mk.plan_ranks(seg, C)
        rank = rank2d.view(-1)
        library_ms = min(in_turns(lambda: bp.index_add_sum(seg, g, nseg),
                                  lambda: bp.index_add_sum(seg, g, nseg)))
        nchunks = n // C
        part_bytes = n * W * 4 + n * 4 + nchunks * rcap * W * 4
        for mode in mk.MODES:
            equal = torch.equal(partials_with(old, rank, g, C, rcap, mode),
                                mk.chunk_partials(rank, g, C, rcap, mode))
            old_ms, new_ms = in_turns(
                lambda: partials_with(old, rank, g, C, rcap, mode),
                lambda: mk.chunk_partials(rank, g, C, rcap, mode))
            passes = {"highest": 0, "split2": 2, "default": 1}[mode]
            if passes:
                bound_ms, bound_by = cs.bound(part_bytes,
                                              passes * 2 * rcap * W * n,
                                              cs.BF16_FLOPS)
            else:
                bound_ms, bound_by = cs.bound(part_bytes, n * W)
            info = mk.kernel_info(mode, n, W, C, rcap)
            use = f"{label.split()[0]} {mode}"
            print(f"[{use}] rcap {rcap}: old {old_ms:.3f} ms, new "
                  f"{new_ms:.3f} ms ({old_ms / new_ms:.2f}x), bound "
                  f"{bound_ms:.3f} ms ({bound_by}; new at "
                  f"{bound_ms / new_ms:.0%}, old at {bound_ms / old_ms:.0%})"
                  f", index_add_ {library_ms:.3f} ms; new bit-equal to old "
                  f"{equal}; {info_line(info)}")
            rows.append(dict(use=use, rcap=rcap, old_ms=old_ms,
                             new_ms=new_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms,
                             bit_equal_to_old=equal, **info))
        del seg, g, rank2d, ids, rank
        torch.cuda.empty_cache()
    return rows


def gather_uses(old, seed: int) -> list:
    from isle_tpu_torch import micro_kernels as mk
    from isle_tpu_torch.benchmarks import micro_pallas_gather as bg

    n, V, W = cs.MICRO["gather_n"], cs.MICRO["gather_rows"], cs.MICRO["width"]
    idx, tab = bg.gather_inputs(n, V, W, seed, "cuda")
    base = torch.index_select(tab, 0, idx)
    bound_ms, bound_by = cs.bound(n * 4 + V * W * 4 + n * W * 4, 0)
    rows = []
    for chunk, depth in bg.SWEEP:
        exact_new = torch.equal(mk.row_gather_async(idx, tab, chunk, depth),
                                base)
        exact_old = torch.equal(gather_with(old, idx, tab, chunk, depth),
                                base)
        old_ms, new_ms = in_turns(
            lambda: gather_with(old, idx, tab, chunk, depth),
            lambda: mk.row_gather_async(idx, tab, chunk, depth))
        lib_ms = min(in_turns(lambda: torch.index_select(tab, 0, idx),
                              lambda: torch.index_select(tab, 0, idx)))
        info = mk.kernel_info("gather", n, W, chunk, depth)
        use = f"C={chunk} depth={depth}"
        print(f"[gather {use}] old {old_ms:.3f} ms, new {new_ms:.3f} ms "
              f"({old_ms / new_ms:.2f}x), index_select {lib_ms:.3f} ms "
              f"(new {lib_ms / new_ms:.2f}x of it), bound {bound_ms:.3f} ms "
              f"(new at {bound_ms / new_ms:.0%}); exact new {exact_new}, "
              f"old {exact_old}; {info_line(info)}")
        rows.append(dict(use=use, old_ms=old_ms, new_ms=new_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, exact_new=exact_new,
                         exact_old=exact_old, **info))
    del idx, tab, base
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="an earlier csrc/micro.cu to build and compare")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("micro_probe: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card)
    sys.path.insert(0, cs.ROOT)
    from isle_tpu_torch import _build

    log = _build.kernels().ptxas_log
    in_micro = False
    for line in log.splitlines():
        if "Compiling entry" in line:
            in_micro = "partials" in line or "row_gather" in line
        if in_micro and any(w in line for w in ("Compiling entry", "registers",
                                                "spill")):
            print(f"  ptxas: {line.strip()}")
    old = _build.build_alone(os.path.abspath(args.old), "micro_probe",
                              ENTRIES)
    print(f"old: {args.old}")
    res = dict(card=card, old=args.old, partials=partials_uses(old, args.seed),
               gather=gather_uses(old, args.seed))
    print(json.dumps(res))
    print(card)
    ok = all(u["bit_equal_to_old"] for u in res["partials"]) and all(
        u["exact_new"] for u in res["gather"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
