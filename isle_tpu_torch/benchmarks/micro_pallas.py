"""One-hot chunk partials on the tensor cores against a scatter, on the card:
the port's counterpart of benchmarks/micro_pallas.py.

    python -m isle_tpu_torch.benchmarks.micro_pallas [--n 16777216]
        [--width 128] [--chunk 2048] [--seed 0] [--device cuda]

For each of the reference's two sorted segment streams ("doc-dir", runs of
110 over max(n / 100, 2^18) segments; "word-tail", runs of 16 over
max(2^17, 2 n / 16)) and rows g (n, W) drawn on the card from --seed, it
times the library's scatter-add (index_add_), the port's own segment sum
(segsum.segsum_gather_rows over idx = arange(n)), the rank plan, and for
each mode ("highest", "split2", "default") the partials kernel alone and
the partials plus the scatter of them (micro_kernels.chunk_partials and
scatter_partials), each with its maxrelerr against index_add_'s sums.
"""

from __future__ import annotations

import argparse

import torch

from .. import micro_kernels as mk
from .. import segsum
from . import maxrel, min_ms, require_card

# (label, average run, segments for n entries), as micro_pallas.main
STREAMS = (
    ("doc-dir (avg 110/seg)", 110, lambda n: max(n // 100, 1 << 18)),
    ("word-tail (avg 16/seg)", 16, lambda n: max(1 << 17, 2 * (n // 16))),
)


def stream_inputs(n: int, W: int, avg_run: int, num_segments: int,
                  seed: int, device) -> tuple:
    """(seg int32 (n,), g float32 (n, W)) on `device`: the reference's
    segment stream (make_sorted_segments at its seed 0) and normal rows
    from a torch.Generator seeded with `seed`."""
    seg = torch.from_numpy(
        mk.make_sorted_segments(n, avg_run, num_segments)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn((n, W), generator=gen, device=device)
    return seg, g


def index_add_sum(seg, g, num_segments):
    """The library's scatter-add: (num_segments, W) float32."""
    out = torch.zeros((num_segments, g.shape[1]), dtype=g.dtype,
                      device=g.device)
    return out.index_add_(0, seg, g)


def arange_sum(seg, g, num_segments):
    """The port's own segment sum: segsum_gather_rows with g as the table
    and idx = arange(n), val = 1."""
    n = seg.numel()
    idx = torch.arange(n, dtype=torch.int32, device=g.device)
    val = torch.ones(n, dtype=torch.float32, device=g.device)
    return segsum.segsum_gather_rows(seg, idx, val, g, num_segments)[
        :num_segments]


def run_stream(label: str, seg, g, num_segments: int, chunk: int) -> dict:
    """Times one stream as micro_pallas.main does, prints its lines and
    returns the milliseconds: "index_add", "arange", "plan", and per mode
    {"kernel", "with_scatter", "maxrelerr", "launches"} (launches: the
    partials kernel's, timing runs included); with "rcap"."""
    n = seg.numel()
    res = {}
    base = index_add_sum(seg, g, num_segments)
    res["index_add"] = min_ms(lambda: index_add_sum(seg, g, num_segments))
    print(f"[{label}] index_add_: {res['index_add']:8.3f} ms "
          f"({n / res['index_add'] / 1e3:7.1f} Mrows/s)")
    res["arange"] = min_ms(lambda: arange_sum(seg, g, num_segments))
    err = maxrel(arange_sum(seg, g, num_segments), base)
    print(f"[{label}] segsum_gather_rows(arange): {res['arange']:8.3f} ms "
          f"({n / res['arange'] / 1e3:7.1f} Mrows/s)  maxrelerr={err:.2e}")
    res["plan"] = min_ms(lambda: mk.plan_ranks(seg, chunk))
    rank2d, ids, rcap = mk.plan_ranks(seg, chunk)
    rank = rank2d.view(-1)
    res["rcap"] = rcap
    print(f"[{label}] plan (once per matrix): {res['plan']:8.3f} ms, "
          f"rcap={rcap}")
    for mode in mk.MODES:
        before = mk.chunk_partials.launches
        kernel = min_ms(lambda: mk.chunk_partials(rank, g, chunk, rcap,
                                                  mode))

        def both():
            return mk.scatter_partials(
                mk.chunk_partials(rank, g, chunk, rcap, mode), ids,
                num_segments)

        t = min_ms(both)
        err = maxrel(both(), base)
        res[mode] = dict(kernel=kernel, with_scatter=t, maxrelerr=err,
                         launches=mk.chunk_partials.launches - before)
        print(f"[{label}] partials ({mode:7s}): kernel {kernel:8.3f} ms, "
              f"with the scatter {t:8.3f} ms ({n / t / 1e3:7.1f} Mrows/s)  "
              f"maxrelerr={err:.2e}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_card(args.device)
    print("device:", torch.cuda.get_device_name(dev))
    for label, avg_run, segments in STREAMS:
        nseg = segments(args.n)
        seg, g = stream_inputs(args.n, args.width, avg_run, nseg, args.seed,
                               dev)
        run_stream(label, seg, g, nseg, args.chunk)
        del seg, g
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
