"""One run of one cell, on whatever device it is given: set-up, warm-up,
the measured window, the plain reference's judgement, and the result's
metrics. run.py drives it on the card; the tests drive it on the CPU.

Everything is found by name: the cell's entry in BENCHMARK.json names a
configuration (portbench/configs/<config>.json) and a traffic mix
(portbench/traffic/<traffic>.json), whose `kind` names the job loop
(portbench/kinds/<kind>.py); each per-layer metric is read by
portbench/metrics/<metric>.py.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from portbench import trace as tracing

HERE = os.path.dirname(os.path.abspath(__file__))
# whole top-level module names no run may load: JAX, and the JAX package
# and its benchmark, whose names the port's begins with
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "isle_tpu", "bench",
                       "benchmarks"})


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def workload(bench: dict, name: str) -> dict:
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return wl
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_files(wl: dict, base: str = HERE) -> tuple:
    """(config, traffic) of a cell, read from their files under `base`."""
    config = load_json(os.path.join(base, "configs", f"{wl['config']}.json"))
    traffic = load_json(os.path.join(base, "traffic",
                                     f"{wl['traffic']}.json"))
    return config, traffic


def reports(bench: dict, metric: dict, cell: str) -> bool:
    """Whether the cell reports `metric`: its `workloads`, or else every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moved = [m for m in bench["end_to_end"] if m["name"] == metric["moves"]]
    return bool(moved) and cell in moved[0].get("workloads", [cell])


def metric_reader(name: str, base: str = HERE):
    path = os.path.join(base, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = None, base: str = HERE) -> dict:
    """One run; returns the result's object, its `checks` last. `base`
    holds the configs, traffic and metrics directories."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    wl = workload(bench, name)
    config, traffic = cell_files(wl, base)
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        t_inputs = time.perf_counter()
        cell = kind.Cell(config, traffic, seed, device, workdir)
        cell.setup()
        t_warm = time.perf_counter()
        cell.job(-1)  # the warm-up: one job of the cell's own shapes
        shutil.rmtree(os.path.join(workdir, "job-1"), ignore_errors=True)
        _sync(device)
        setup_s = time.perf_counter() - t_start
        # set-up's parts: the process's start and imports, the inputs
        # (with the CUDA context), the warm-up job
        setup_parts = [t_inputs - t_start, t_warm - t_inputs,
                       t_start + setup_s - t_warm]
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        n_traced = traffic["traced_jobs"] if trace else 0
        tracer = tracing.Tracer(device.type == "cuda",
                                os.path.join(workdir, "trace.json")) \
            if trace else None
        if tracer:  # started before the window: the profiler's own start
            tracer.start()  # takes seconds
        recs = []
        w0 = time.perf_counter()
        while True:
            i = len(recs)
            mark = tracer.mark if i < n_traced else None
            if mark:
                mark(tracing.JOB_START + str(i))
            t_job = time.perf_counter()
            rec = cell.job(i, mark)
            rec["wall_s"] = time.perf_counter() - t_job
            if mark:
                mark(tracing.JOB_END + str(i))
                if i == n_traced - 1:
                    tracer.stop()
            rec["traced"] = mark is not None
            recs.append(rec)
            if time.perf_counter() - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
        if tracer:
            tracer.stop()
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
        e2e = cell.end_to_end(recs, window_s)
        summary = tracing.summarize(tracer.events()) if tracer else None

        cell.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_judge = time.perf_counter()
        numbers, facts = cell.judge(recs)
        facts["judge_s"] = time.perf_counter() - t_judge
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    limits = config["limits"]
    checks = {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    if trace:
        ctx = dict(jobs=[r for r in recs if not r["traced"]]
                   or recs, traced=[r for r in recs if r["traced"]],
                   summary=summary, facts=facts, config=config)
        metrics = {}
        for m in bench["per_layer"]:
            if reports(bench, m, name):
                v = metric_reader(m["name"], base)(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if m["name"] in e2e}
        unit = [m["unit"] for m in bench["end_to_end"]
                if m["name"] == "setup_s"][0]
        metrics["setup_s"] = {"value": setup_s, "unit": unit}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(recs), "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = sum(j["busy_s"] for j in summary["jobs"])
        dev["window_s"] = sum(j["window_s"] for j in summary["jobs"])
        result["breakdown"] = tracing.breakdown(summary)
    # what each job of the window took and did, to tell the work a seed
    # makes from the machine's noise
    stages = {}
    for r in recs:
        for label, sec in r["phases"].items():
            stages.setdefault(label, []).append(sec)
    facts.update(setup_parts_s=setup_parts,
                 job_s=[r["wall_s"] for r in recs], stage_s_by_job=stages,
                 work=[r["work"] for r in recs if "work" in r],
                 bytes_written=sum(r["written"] for r in recs))
    result["facts"] = facts
    result["checks"] = checks
    return result
