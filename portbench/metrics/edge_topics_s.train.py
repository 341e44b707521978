"""edge_topics_s.train: seconds per training job of the program's stage
"constructing edge topic model" (train_edge_topics: the host's
topic_model.construct_edge_topics_v2; the stage's clock also holds the
model checkpoint written at the end of train())."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, "constructing edge topic model")
