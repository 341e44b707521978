"""edge_build_ms_per_topic.pubtrain: milliseconds of the program's span
"edge topics: build" (topic_model.construct_edge_topics_v2: the pairs
chosen on the host, the edge vectors made on the card and copied back)
per edge topic built, from the counter "edge topics" (Trainer.
train_edge_topics), summed over the jobs: the seed's count of edge
topics does not move it."""

from portbench.spans import counter_sums, job_timers


def read(ctx):
    timers = job_timers(ctx)
    sums = counter_sums(ctx, "edge topics")
    if timers is None or sums is None or sums[0] <= 0:
        return None
    build = sum(end - start for t in timers
                for n, _, start, end in t.spans if n == "edge topics: build")
    return 1000.0 * build / sums[0]
