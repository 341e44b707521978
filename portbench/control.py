"""The control of a cell's correctness check: the plain reference put in
the program's place, computed in the next precision below the one the
configuration states (bfloat16 operands, float32 sums, for float32), and
judged as the program's outputs are. A sound check reads it as not
correct. Not run by the benchmark's runs:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

prints, a seed a line, the numbers compared beside their limits.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(bench: dict, name: str, seed: int, device, precision: str,
            base: str = None) -> dict:
    """{number: value} of the control of cell `name` on `seed` (`base`:
    the directory of the configs and traffic, portbench's own by
    default)."""
    import importlib

    from portbench import harness

    wl = harness.workload(bench, name)
    config, traffic = harness.cell_files(wl, base or harness.HERE)
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    workdir = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        cell = kind.Cell(config, traffic, seed, device, workdir)
        cell.setup()
        return cell.control(precision)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    from portbench import harness

    limits = harness.cell_files(harness.workload(bench, args.workload))[0][
        "limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control(bench, args.workload, seed, args.device,
                          args.precision)
        failed = sorted(n for n, v in numbers.items() if v > limits[n])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision,
                          "numbers": numbers, "limits": limits,
                          "fails": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
