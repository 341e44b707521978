"""ISLEInfer in fresh processes on one NVIDIA GPU, one tree against
another: what a user pays for each run of the CLI, first job and all.

    python3 infer_probe.py --config NAME [--docs N] [--widest W]
        [--seed S] [--runs R] [--api] TREE [TREE ...]

Makes the corpus of portbench's configuration NAME (configs/NAME.json:
its vocabulary, docs and draws, or N docs and the draws scaled to them;
portbench's frozen generator, on the card; with --widest, doc 1 holds W
distinct words, each once, so that one doc is far wider than the rest)
and writes it as a 1-based TDF file, and a topic model of its vocabulary (portbench.gen.inputs's, k from
the configuration) as a sparse model file, under build/infer_probe/.
Each TREE is a checkout of the repository; its kernels are built first,
in a process of its own, and the build's seconds printed (nvcc runs once
a checkout). Then R rounds, each running `isle_tpu_torch.cli.infer` from
every TREE in turn (the order reversed every other round), each in a
fresh process. Printed for each run: the wall from launch to exit, the
CLI's stages, the seconds of each span of the pack and MWU stages
(obs.recent_timers, which both trees record), the card's peak of memory
reserved, and the report's sha256 (equal across trees).

With --api the runs use the library as a program embedding it does: in
a fresh process the corpus read from the TDF file and the model from its
file, then two jobs, each a new Inferencer given the model in memory and
infer_corpus(top_n=5); no CUDA call comes before the first job. Each
round runs two such processes a tree: one untraced (both jobs' stages
and spans printed) and one whose first job runs inside a torch.profiler
trace (GpuConfig.profile_dir), printed per pack span as the seconds of
the CUDA runtime calls and of the device's copies and kernels inside it.

Before the runs, the card's cost of fresh memory, in a process of its
own: the seconds to allocate and zero 0.5, 2 and 6 GB the first time, the
same again from the allocator's cache, and after torch.cuda.empty_cache
(memory the process takes from the card anew).

Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "infer_probe")

# run in each tree's process: the CLI in this process, then its Timer
CLI_RUN = r"""
import json, sys, time
import torch
from isle_tpu_torch import obs
from isle_tpu_torch.cli import infer
rc = infer.main(sys.argv[1:])
t = obs.recent_timers()[-1]
print("PROBE " + json.dumps(dict(
    rc=rc, stages={label: wall for label, wall, _ in t.phases},
    spans=t.span_seconds(),
    reserved_gib=torch.cuda.max_memory_reserved() / 2**30)))
"""

API_RUN = r"""
import glob, json, os, sys
import torch
from isle_tpu_torch import Corpus, GpuConfig, InferConfig, Inferencer, \
    io_text
model_file, tdf, out, k, V, D, traced = sys.argv[1:]
k, V, D = int(k), int(V), int(D)
corpus = Corpus.from_tdf_file(tdf, vocab_size=V, num_docs=D,
                              normalize_to_one=True)
M = io_text.load_sparse_model(model_file, k, V)
jobs, prof = [], os.path.join(out, "prof")
for job in range(2):
    gpu = GpuConfig(device="cuda",
                    profile_dir=prof if traced == "1" and job == 0 else "")
    inf = Inferencer(InferConfig(num_topics=k, vocab_size=V), model=M,
                     output_dir=out, quiet=True, gpu=gpu)
    inf.infer_corpus(corpus, top_n=5)
    t = inf.timer
    jobs.append(dict(stages={label: wall for label, wall, _ in t.phases},
                     spans=t.span_seconds()))
split = {}
for path in glob.glob(os.path.join(prof, "*.json")):
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    for r in [e for e in ev if e["name"].startswith("isle: pack")]:
        lo, hi = r["ts"], r["ts"] + r["dur"]
        inside = {}
        for e in ev:
            if e.get("cat") in ("cuda_runtime", "gpu_memcpy",
                                "kernel") and lo <= e["ts"] <= hi:
                key = (e["cat"], e["name"][:48])
                inside[key] = inside.get(key, 0.0) + e["dur"] / 1e6
        top = sorted(inside.items(), key=lambda x: -x[1])[:6]
        split[r["name"]] = dict(s=r["dur"] / 1e6, inside=[
            (c, n, round(v, 4)) for (c, n), v in top])
print("PROBE " + json.dumps(dict(rc=0, jobs=jobs, split=split,
    reserved_gib=torch.cuda.max_memory_reserved() / 2**30)))
"""

ALLOC = r"""
import json, time, torch
torch.cuda.init()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
out = {}
for gb in (0.5, 2, 6):
    n = int(gb * 1e9)
    for when in ("fresh", "cached", "after empty_cache"):
        if when == "after empty_cache":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        x = torch.empty(n, dtype=torch.uint8, device="cuda")
        t1 = time.perf_counter()
        x.zero_()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[f"{gb} GB {when}"] = dict(alloc_s=t1 - t0, zero_s=t2 - t1)
        del x
    torch.cuda.empty_cache()
print("ALLOC " + json.dumps(out))
"""


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_inputs(config: str, docs: int, widest: int, seed: int) -> tuple:
    """(tdf path, model path, cli arguments after the paths' places)."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from isle_tpu_torch import native
    from portbench.gen import inputs

    with open(os.path.join(ROOT, "portbench", "configs",
                           f"{config}.json")) as f:
        cfg = json.load(f)
    shape = dict(cfg["shape"])
    if docs and docs != shape["docs"]:
        shape["nnz_target"] = shape["nnz_target"] * docs // shape["docs"]
        shape["docs"] = docs
    V, D, k = shape["vocab"], shape["docs"], shape["k"]
    os.makedirs(OUT, exist_ok=True)
    tdf, model = os.path.join(OUT, "corpus.tdf"), os.path.join(OUT, "model")
    t0 = time.perf_counter()
    off, rows, counts = inputs.corpus_csc(shape, seed, "cuda")
    lengths = (off[1:] - off[:-1]).cpu().numpy()
    rows, counts = rows.cpu().numpy(), counts.cpu().numpy().astype(np.int32)
    if widest:  # doc 0's entries replaced by words 0 .. widest - 1
        cut = int(lengths[0])
        rows = np.concatenate([np.arange(widest, dtype=rows.dtype),
                               rows[cut:]])
        counts = np.concatenate([np.ones(widest, np.int32), counts[cut:]])
        lengths[0] = widest
    doc_ids = np.repeat(np.arange(D, dtype=np.int64), lengths)
    native.write_int_triples(tdf, doc_ids, rows, counts, 1, 1, 0)
    nnz = len(rows)
    del off, rows, counts, doc_ids
    M = inputs.topic_model(V, k, seed, "cuda").cpu().numpy()
    native.write_sparse_model(model, M)
    torch.cuda.empty_cache()
    print(f"inputs: {config} cut to {D} docs of {shape['docs']}: vocab {V}, "
          f"{nnz} entries, the widest doc {int(lengths.max())}, k {k}, "
          f"written in {time.perf_counter() - t0:.1f} s")
    return tdf, model, [str(k), str(V), "1", str(D + 1), str(nnz), "0",
                        "0", "0"]


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


def run_tree(tree: str, tdf: str, model: str, rest: list, tag: str,
             runner: str = CLI_RUN) -> dict:
    out = os.path.join(OUT, tag)
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", runner, model, tdf, out, *rest], cwd=tree,
        capture_output=True, text=True, timeout=1800)
    wall = time.perf_counter() - t0
    line = [x for x in proc.stdout.splitlines() if x.startswith("PROBE ")]
    if proc.returncode != 0 or not line:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    res = json.loads(line[-1][len("PROBE "):])
    reports = sorted(n for n in os.listdir(out) if n.startswith("top_"))
    res.update(wall=wall, sha256=[sha256(os.path.join(out, n))[:16]
                                  for n in reports])
    return res


def api_runs(tree: str, tdf: str, model: str, rest: list, tag: str,
             r: int) -> None:
    """--api: a tree's untraced process, then its traced one."""
    k, V, D = rest[0], rest[1], str(int(rest[3]) - 1)
    for traced in ("0", "1"):
        res = run_tree(tree, tdf, model, [k, V, D, traced],
                       f"{tag}_t{traced}", API_RUN)
        for j, job in enumerate(res["jobs"]):
            mine = {n: round(s, 4) for n, s in job["spans"].items()
                    if n.startswith(("pack", "mwu"))}
            print(f"run {r} {tree} {'traced' if traced == '1' else 'untraced'}"
                  f" process, job {j + 1}: stages " + ", ".join(
                      f"{name} {s:.3f}" for name, s in job["stages"].items())
                  + f"; spans {mine}")
        for name, part in res["split"].items():
            print(f"  traced job 1, {name}: {part['s']:.4f} s, inside: "
                  f"{part['inside']}")
        print(f"  process wall {res['wall']:.2f} s, reserved "
              f"{res['reserved_gib']:.2f} GiB")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--docs", type=int, default=0)
    ap.add_argument("--widest", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--api", action="store_true")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("infer_probe: no CUDA device", file=sys.stderr)
        return 2
    print(card_line())
    trees = [os.path.abspath(t) for t in args.trees]
    proc = subprocess.run([sys.executable, "-c", ALLOC], capture_output=True,
                          text=True, timeout=600, check=True)
    print(proc.stdout.strip())
    for tree in trees:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "from isle_tpu_torch._build import "
             "kernels; print(kernels().build_seconds)"], cwd=tree,
            capture_output=True, text=True, timeout=900, check=True)
        print(f"build {tree}: nvcc {float(proc.stdout):.2f} s, the process "
              f"{time.perf_counter() - t0:.2f} s")
    tdf, model, rest = make_inputs(args.config, args.docs, args.widest,
                                   args.seed)
    for r in range(args.runs):
        for i, tree in enumerate(trees if r % 2 == 0 else trees[::-1]):
            if args.api:
                api_runs(tree, tdf, model, rest, f"r{r}_{i}", r)
                continue
            res = run_tree(tree, tdf, model, rest, f"r{r}_{i}")
            mine = {n: round(s, 4) for n, s in res["spans"].items()
                    if n.startswith(("pack", "mwu"))}
            print(f"run {r} {tree}: wall {res['wall']:.2f} s, stages "
                  + ", ".join(f"{k} {v:.3f}" for k, v in
                              res["stages"].items())
                  + f"; spans {mine}; reserved {res['reserved_gib']:.2f} GiB;"
                  f" report sha256 {res['sha256']}")
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
