"""edge_build_s.train: seconds per training job in the program's span
"edge topics: build" (topic_model.construct_edge_topics_v2 on the host),
the stage "constructing edge topic model" less the model checkpoint's
write."""

from portbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "edge topics: build")
