"""mwu_pad_pct.infer: percent of MWU's block slots that hold no kept
entry, from the program's counters "mwu slots" (a block's rows times its
width, the tail block padded to the block's rows) and "mwu entries" (the
kept entries of a block's docs), summed over the jobs."""

from portbench.spans import counter_sums


def read(ctx):
    sums = counter_sums(ctx, "mwu slots", "mwu entries")
    if sums is None or sums[0] <= 0:
        return None
    slots, entries = sums
    return 100.0 * (slots - entries) / slots
