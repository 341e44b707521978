"""What the per-layer metrics that read the program's own spans and
counters share. The program keeps its last Timers in memory
(isle_tpu_torch.obs.recent_timers), one a job; the window's untraced
jobs made the last of them. A reader returns None where it finds nothing
to read: a program without that record, or Timers whose stages are not
the jobs' own."""

from __future__ import annotations

import statistics


def job_timers(ctx: dict):
    """The Timers of ctx's jobs, in order, or None where the program keeps
    none or the last Timers' stage walls differ from the jobs' phases."""
    from isle_tpu_torch import obs

    recent = getattr(obs, "recent_timers", None)
    jobs = ctx["jobs"]
    if recent is None or not jobs:
        return None
    timers = recent()[-len(jobs):]
    if len(timers) != len(jobs):
        return None
    for t, rec in zip(timers, jobs):
        if {label: w for label, w, _ in t.phases} != rec["phases"]:
            return None
    return timers


def span_mean(ctx: dict, *names: str):
    """Mean seconds per job of the program's spans named `names`, each
    span whole, or None where no job has one."""
    timers = job_timers(ctx)
    if timers is None or not any(n in names for t in timers
                                 for n, *_ in t.spans):
        return None
    return statistics.fmean(
        sum(end - start for n, _, start, end in t.spans if n in names)
        for t in timers)


def counter_sums(ctx: dict, *names: str):
    """The program's counters `names` summed over the jobs, or None where
    no job counted one of them."""
    timers = job_timers(ctx)
    if timers is None or not all(any(n in t.counters for t in timers)
                                 for n in names):
        return None
    return [sum(t.counters.get(n, 0) for t in timers) for n in names]
