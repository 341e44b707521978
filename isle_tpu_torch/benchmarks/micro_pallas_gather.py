"""A row gather by one bulk asynchronous copy a row against the library's
row gather, on the card: the port's counterpart of
benchmarks/micro_pallas_gather.py.

    python -m isle_tpu_torch.benchmarks.micro_pallas_gather [--n 4194304]
        [--rows 102660] [--width 128] [--seed 0] [--device cuda]

A normal table (rows, W) and n uniform row ids, drawn on the card from
--seed; torch.index_select timed, then micro_kernels.row_gather_async at
the reference's (chunk, depth) sweep, each with whether it equals
index_select bit for bit.
"""

from __future__ import annotations

import argparse

import torch

from .. import micro_kernels as mk
from . import min_ms, require_card

SWEEP = ((1024, 8), (1024, 32), (1024, 128), (4096, 256))


def gather_inputs(n: int, V: int, W: int, seed: int, device) -> tuple:
    """(idx int32 (n,), tab float32 (V, W)) on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tab = torch.randn((V, W), generator=gen, device=device)
    idx = torch.randint(0, V, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    return idx, tab


def run_sweep(idx, tab) -> dict:
    """Times index_select and the sweep as micro_pallas_gather.main does,
    prints its lines and returns {"index_select": ms, (chunk, depth):
    {"ms", "exact", "launches"}}."""
    n = idx.numel()
    res = {"index_select": min_ms(lambda: torch.index_select(tab, 0, idx))}
    base = torch.index_select(tab, 0, idx)
    print(f"index_select:       {res['index_select']:8.3f} ms "
          f"({n / res['index_select'] / 1e3:7.1f} Mrows/s)")
    for chunk, depth in SWEEP:
        before = mk.row_gather_async.launches
        t = min_ms(lambda: mk.row_gather_async(idx, tab, chunk, depth))
        ok = torch.equal(mk.row_gather_async(idx, tab, chunk, depth), base)
        res[chunk, depth] = dict(ms=t, exact=ok, launches=(
            mk.row_gather_async.launches - before))
        print(f"bulk-copy gather C={chunk:5d} depth={depth:4d}: {t:8.3f} ms "
              f"({n / t / 1e3:7.1f} Mrows/s) exact={ok}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--rows", type=int, default=102_660)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_card(args.device)
    print("device:", torch.cuda.get_device_name(dev))
    idx, tab = gather_inputs(args.n, args.rows, args.width, args.seed, dev)
    res = run_sweep(idx, tab)
    return 0 if all(r["exact"] for k, r in res.items()
                    if k != "index_select") else 1


if __name__ == "__main__":
    raise SystemExit(main())
