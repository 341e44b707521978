"""What the per-layer metrics' readers share: a stage's mean per job from
the program's timer, and the device's idle share of the traced jobs. A
reader returns None where it finds nothing to read."""

from __future__ import annotations

import statistics


def stage_mean(ctx: dict, label: str):
    """Mean seconds per job of the program's timer stage `label`, over the
    window's untraced jobs (all jobs where every one was traced)."""
    vals = [r["phases"][label] for r in ctx["jobs"] if label in r["phases"]]
    return statistics.fmean(vals) if vals else None


def idle_pct(ctx: dict):
    """Percent of the traced jobs' wall in which no kernel, copy or set
    ran on the card."""
    summary = ctx["summary"]
    jobs = summary["jobs"] if summary else []
    window = sum(j["window_s"] for j in jobs)
    busy = sum(j["busy_s"] for j in jobs)
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (window - busy) / window
