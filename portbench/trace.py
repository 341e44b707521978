"""The traced run: a torch.profiler trace over whole jobs of the window,
with markers the benchmark sets at each job's start and end and at the
end of each of the program's timer stages, reduced to what the per-layer
metrics and the result's `device` and `breakdown` read."""

from __future__ import annotations

import collections
import json
import os

import torch

MARK = "portbench: "
JOB_START, JOB_END, STAGE_END = "job start ", "job end ", "stage end "
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def stage_label(timer_message: str) -> str:
    """The stage of one of the program's timer lines, "Time for <stage>:
    <cpu>s user, <wall>s wall"."""
    body = timer_message[len("Time for "):] \
        if timer_message.startswith("Time for ") else timer_message
    return body[:body.rindex(": ")] if ": " in body else body


class Tracer:
    """One profiler over the traced jobs; `mark` drops a named marker."""

    def __init__(self, on_card: bool, path: str):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.path = path
        self.active = False

    def start(self) -> None:
        self.prof.__enter__()
        self.active = True

    def stop(self) -> None:
        if self.active:
            self.prof.__exit__(None, None, None)
            self.active = False

    @staticmethod
    def mark(name: str) -> None:
        with torch.profiler.record_function(MARK + name):
            pass

    def events(self) -> list:
        """The trace's complete events, read back from its Chrome export
        (the file is removed)."""
        self.prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                return [e for e in json.load(f)["traceEvents"]
                        if e.get("ph") == "X"]
        finally:
            os.remove(self.path)


def _union(intervals: list) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _clip(intervals: list, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def summarize(events: list) -> dict:
    """Per traced job: its window (job start to job end marker) and the
    device's busy time in it (the union of kernels, copies and sets), and
    per stage (between consecutive stage markers, the first from the job's
    start) its span and busy time; over all traced jobs, the device
    operations by total time. Times in seconds."""
    marks = sorted((e["ts"], e["name"][len(MARK):]) for e in events
                   if e.get("name", "").startswith(MARK))
    dev = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("cat") in DEVICE_CATS]
    busy_iv = [(a, b) for a, b, _ in dev]
    jobs, start = [], None
    for ts, name in marks:
        if name.startswith(JOB_START):
            start, stages, prev = ts, [], ts
        elif name.startswith(STAGE_END) and start is not None:
            stages.append((name[len(STAGE_END):], prev, ts))
            prev = ts
        elif name.startswith(JOB_END) and start is not None:
            stages.append(("until the job's end", prev, ts))
            jobs.append(dict(
                window_s=(ts - start) / 1e6,
                busy_s=_union(_clip(busy_iv, start, ts)) / 1e6,
                stages=[dict(label=lab, span_s=(b - a) / 1e6,
                             busy_s=_union(_clip(busy_iv, a, b)) / 1e6)
                        for lab, a, b in stages]))
            start = None
    ops = collections.Counter()
    for a, b, name in dev:
        ops[name] += (b - a) / 1e6
    return dict(jobs=jobs, device_ops=ops)


def breakdown(summary: dict) -> dict:
    """The result's breakdown: the ten device operations that took most
    time, and the ten stages with the most idle device time."""
    idle = collections.Counter()
    for job in summary["jobs"]:
        for st in job["stages"]:
            idle[f"device idle in {st['label']}"] += st["span_s"] \
                - st["busy_s"]
    return {
        "device_ops": [[name[:160], s] for name, s
                       in summary["device_ops"].most_common(10)],
        "idle_gaps": [[name, s] for name, s in idle.most_common(10)],
    }


def stage_busy(summary: dict, label: str) -> tuple:
    """(span, busy) seconds of the stage `label` summed over the traced
    jobs."""
    span = busy = 0.0
    for job in summary["jobs"]:
        for st in job["stages"]:
            if st["label"] == label:
                span += st["span_s"]
                busy += st["busy_s"]
    return span, busy
