"""upload_copy_gbps.pubtrain: GB/s of the in-core corpus upload's copy
to the card, the program's counter "upload staged bytes" (the word ids
and values that sparse.DocSparse.from_corpus sends through pinned
staging) per job over the mean of its span "upload: copy to device"
(which ends once the host has waited for the last copy). A program
without the counter (pageable copies) reads nothing."""

from portbench.spans import counter_sums, job_timers, span_mean


def read(ctx):
    timers = job_timers(ctx)
    sums = counter_sums(ctx, "upload staged bytes")
    seconds = span_mean(ctx, "upload: copy to device")
    if timers is None or sums is None or not seconds:
        return None
    return sums[0] / len(timers) / seconds / 1e9
