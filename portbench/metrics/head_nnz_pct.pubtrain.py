"""head_nnz_pct.pubtrain: percent of B's entries that the hybrid layout's
dense head carries on the tensor cores, from the program's counters
"hybrid head nnz" and "B nnz" (hybrid.split_by_head), summed over the
jobs: under a sampled job's head budget, taken over its sampled docs."""

from portbench.spans import counter_sums


def read(ctx):
    sums = counter_sums(ctx, "hybrid head nnz", "B nnz")
    if sums is None or sums[1] <= 0:
        return None
    head, total = sums
    return 100.0 * head / total
