"""Where segsum_onehot's time goes on one NVIDIA GPU, on the main path's
own streams at the NYTimes shape of chip_smoke.py. One training run makes
the four onehot streams (chip_smoke.onehot_streams: the ζ histogram, the
r-th group counts, the doc-topic mass, the doc norms of B); then, per use:

  1. a torch.profiler trace of REPS calls of the wrapper: device time per
     CUDA kernel a call (segsum_onehot_kernel, segsum_onehot_edges_kernel)
     and the device's busy share of the calls' span;
  2. the kernel alone (CUDA events), and the same kernel on the same
     stream with every column masked (-1): the entries are staged and
     every output row is stored, nothing accumulates;
  3. what PyTorch takes for the same bytes: reading each input array once
     (amax of each, which keeps int32: a sum of int32 widens to int64 and
     runs at a fraction of the memory rate) and writing the output once
     (fill_), CUDA events.

The kernel against (2) is what the reduction costs; (2) against (3) what
staging the entries and storing the rows cost beyond moving the bytes.
The doc norms take no column array; their masked run reads one (4 bytes
an entry more).

Last, the word-keyed streamed uses by slice length (what
streaming.word_slice_len chooses from): the middle chunk of the corpus in
chunks of chip_smoke.STREAM_CHUNK_ENTRIES, with the carries of the chunks
before it, through the ζ histogram with and without `init` and through
segsum_gather_rows's model accumulation with `init`, at 128 to 4096
entries a slice.

With --old (an earlier csrc/segsum.cu, for example `git show
<commit>:isle_tpu_torch/csrc/segsum.cu` saved under build/), that source
is built alone with the port's nvcc flags into a second library, and
each float use (the doc-topic mass, the doc norms of B) runs on both,
timed in turns (old, new, new, old; each side's least), each held to the
float64 sum: its largest error, and the share of cells equal to the
float64 sum rounded once.

    python3 onehot_probe.py [--docs N] [--seed S] [--old SEGSUM_CU]

Prints the card's line, one line per use and a JSON line of the numbers;
exits with code 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

import chip_smoke as cs


def trace(fn) -> dict:
    """Device time per CUDA kernel per call of fn, over cs.REPS calls
    after a warm-up, and the busy share of the kernels' span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(cs.REPS):
            fn()
        torch.cuda.synchronize()
    per_kernel, lo, hi = {}, None, None
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + (end - start)
        lo = start if lo is None else min(lo, start)
        hi = end if hi is None else max(hi, end)
    if not per_kernel:
        return {"kernels_us": None, "busy_share": None}
    busy = sum(per_kernel.values())
    return {
        "kernels_us": {
            name.replace("(anonymous namespace)::", "").split("(")[0]:
            us / cs.REPS for name, us in per_kernel.items()},
        "busy_share": busy / (hi - lo) if hi > lo else None,
    }


def probe_use(use, seg, col, val, S, nc) -> dict:
    from isle_tpu_torch import segsum

    n = seg.numel()
    masked = torch.full_like(seg, -1)
    dtype = torch.int32 if val is None else torch.float32
    out = torch.empty((S + 1, nc), dtype=dtype, device=seg.device)
    arrays = [a for a in (seg, col, val) if a is not None]
    nbytes = sum(a.numel() * 4 for a in arrays) + out.numel() * 4
    bound_ms, _ = cs.bound(nbytes, n)
    r = dict(
        use=use, n=n, shape=[S + 1, nc],
        window=cs.onehot_window(nc, val is not None),
        bound_ms=bound_ms, bound_bytes=nbytes,
        ms=cs.time_ms(lambda: segsum.segsum_onehot(seg, col, val, S, nc)),
        masked_ms=cs.time_ms(
            lambda: segsum.segsum_onehot(seg, masked, val, S, nc)),
        read_ms=cs.time_ms(lambda: [a.amax() for a in arrays]),
        write_ms=cs.time_ms(lambda: out.fill_(0)),
        trace=trace(lambda: segsum.segsum_onehot(seg, col, val, S, nc)),
    )
    r["gb_per_s"] = nbytes / r["ms"] / 1e6
    return r


def old_against_new(old, use, seg, col, val, S, nc) -> dict:
    """A float use on the --old library (float32 sums and carries) and on
    the current one, timed in turns, each against the float64 sum."""
    from isle_tpu_torch import segsum

    n, chunk = seg.numel(), segsum.DEFAULT_CHUNK
    out = torch.empty((S + 1, nc), dtype=torch.float32, device=seg.device)
    carry = torch.empty((-(-n // chunk), 2, nc), dtype=torch.float32,
                        device=seg.device)
    device, stream = segsum._launch_args(seg)

    def run_old():
        rc = old.isle_segsum_onehot_f32(
            seg.data_ptr(), None if col is None else col.data_ptr(),
            val.data_ptr(), None, n, S, nc, chunk, out.data_ptr(),
            carry.data_ptr(), device, stream)
        assert rc == 0, rc
        return out

    def run_new():
        return segsum.segsum_onehot(seg, col, val, S, nc)

    ref = segsum.segsum_onehot_plain(seg, col, val.double(), S, nc)
    err = {}
    for side, fn in (("old", run_old), ("new", run_new)):
        got = fn().double()
        err[side] = (float((got - ref).abs().max()),
                     float((got == ref.float().double()).double().mean()))
    a1, b1, b2, a2 = (cs.time_ms(f) for f in (run_old, run_new, run_new,
                                              run_old))
    r = dict(use=use, old_ms=min(a1, a2), new_ms=min(b1, b2),
             old_max_abs_err=err["old"][0], new_max_abs_err=err["new"][0],
             old_exact_share=err["old"][1], new_exact_share=err["new"][1])
    print(f"{use}, old against new: old {r['old_ms']:.4f} ms, new "
          f"{r['new_ms']:.4f} ms; max abs err against the float64 sum old "
          f"{r['old_max_abs_err']:.3e}, new {r['new_max_abs_err']:.3e}; "
          f"cells equal to the float64 sum rounded once: old "
          f"{r['old_exact_share']:.4%}, new {r['new_exact_share']:.4%}")
    return r


SLICE_LENGTHS = (128, 256, 512, 1024, 2048, 4096)


def slice_sweep(tr, corpus) -> list:
    from isle_tpu_torch import segsum
    from isle_tpu_torch.streaming import ChunkLoader

    c = cs.middle_chunk(
        tr, corpus, ChunkLoader(corpus, cs.STREAM_CHUNK_ENTRIES, "cuda"))
    ncols = c.F + 1
    print(f"chunk {c.index}: docs [{c.lo}, {c.hi}), {c.w.numel()} entries; "
          f"streaming.word_slice_len takes {c.word_slice}")
    rows = []
    for n in SLICE_LENGTHS:
        r = dict(
            slice_len=n,
            histogram_init_ms=cs.time_ms(lambda: segsum.segsum_onehot(
                c.hs, c.hr, None, c.V, ncols, init=c.hist, chunk=n)),
            histogram_ms=cs.time_ms(lambda: segsum.segsum_onehot(
                c.hs, c.hr, None, c.V, ncols, chunk=n)),
            model_init_ms=cs.time_ms(lambda: segsum.segsum_gather_rows(
                c.ms, c.md, c.mv, c.table, c.V, init=c.model, chunk=n)),
        )
        rows.append(r)
        print(f"  slice length {n}: histogram with init "
              f"{r['histogram_init_ms']:.3f} ms, without init "
              f"{r['histogram_ms']:.3f} ms; model accumulation with init "
              f"{r['model_init_ms']:.3f} ms")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=cs.NYT["docs"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--old", default="",
                    help="an earlier csrc/segsum.cu to time the float uses "
                         "against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("onehot_probe: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    sys.path.insert(0, cs.ROOT)
    from isle_tpu_torch import _build

    _build.kernels()
    old = (_build.build_alone(os.path.abspath(args.old), "onehot_probe",
                              ["isle_segsum_onehot_f32"])
           if args.old else None)
    shape = dict(cs.NYT)
    if args.docs != cs.NYT["docs"]:
        shape.update(docs=args.docs,
                     nnz=cs.NYT["nnz"] * args.docs // cs.NYT["docs"])
        print(f"CUT: docs {cs.NYT['docs']} -> {shape['docs']}")
    t0 = time.perf_counter()
    corpus = cs.make_corpus(cs.synth_entries(shape, args.seed), shape)
    print(f"corpus {shape}: nnz {corpus.nnz}, built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    tr = cs.train(corpus, shape, args.seed, "cuda",
                  os.path.join(cs.ROOT, "build", "onehot_probe"))
    streams, _ = cs.onehot_streams(tr)
    rows = []
    for use, seg, col, val, S, nc, _ in streams:
        r = probe_use(use, seg, col, val, S, nc)
        rows.append(r)
        tr_ = r["trace"]
        kern = ("not measured" if tr_["kernels_us"] is None else ", ".join(
            f"{k} {us:.1f} us" for k, us in tr_["kernels_us"].items()))
        busy = ("not measured" if tr_["busy_share"] is None
                else f"{tr_['busy_share']:.3f}")
        print(f"{use} n={r['n']} out={r['shape']}: kernel {r['ms']:.4f} ms "
              f"({r['gb_per_s']:.0f} GB/s of the bound's bytes), every "
              f"column masked {r['masked_ms']:.4f} ms, PyTorch read "
              f"{r['read_ms']:.4f} ms + write {r['write_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms; trace per call: {kern}; device "
              f"busy share {busy}")
    against = [old_against_new(old, use, seg, col, val, S, nc)
               for use, seg, col, val, S, nc, _ in streams
               if old is not None and val is not None]
    sweep = slice_sweep(tr, corpus)
    print(json.dumps({"card": card, "uses": rows, "slice_sweep": sweep,
                      "old_against_new": against}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
