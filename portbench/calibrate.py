"""The distinct (doc, word) pairs the frozen generator makes at a
configuration's shape for given draw targets and seeds: how each
configuration's nnz_target was chosen to land within 1% of the published
nonzero count.

    python3 portbench/calibrate.py --config <config> --targets 1,2 \
        --seeds 0,1
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--targets", required=True)
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.gen import inputs

    with open(os.path.join(ROOT, "portbench", "configs",
                           f"{args.config}.json")) as f:
        config = json.load(f)
    shape, published = config["shape"], config["published"]["nnz"]
    for target in (int(t) for t in args.targets.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            off, rows, counts = inputs.corpus_csc(
                dict(shape, nnz_target=target), seed, args.device)
            n = rows.numel()
            print(json.dumps({"config": args.config, "target": target,
                              "seed": seed, "distinct": n,
                              "of_published": n / published}), flush=True)
            del off, rows, counts
            if args.device == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
