"""The benchmark's one command:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It prints the card and its power limit first (standard error), each
number the check compared beside its limit last (standard error), and one
JSON object as the last line of standard output. Without a card, or with
fewer than the cell asks for, it exits with 2 and prints no result; with
JAX or the JAX package loaded once the window has closed, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the build and kernel caches at fixed paths inside the checkout
    cache = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)

    import torch

    from portbench import harness, yardstick

    t_import = time.perf_counter()

    chips = harness.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"portbench: {args.workload}, seed {args.seed}, "
          f"{yardstick.card_line()}", file=sys.stderr, flush=True)
    t_card = time.perf_counter()
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    # the first of set-up's parts: the imports, then the card's look-up
    result["facts"]["start_parts_s"] = [t_import - T_START,
                                        t_card - t_import]
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
