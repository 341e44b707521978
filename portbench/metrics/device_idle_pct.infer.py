"""device_idle_pct.infer: percent of the traced inference jobs' wall (job
start to the synchronize at its end) in which no kernel, copy or set ran
on the card (the union of the profiler's device intervals)."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
