"""checkpoint_write_s.train: seconds per training job in the program's
span "checkpoint write" (Trainer._checkpoint: np.savez of the svd, kmeans
and model checkpoints, each written after a stage's end and so timed in
the next stage: "project docs", "collecting word freqs in clusters" and
"constructing edge topic model")."""

from portbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "checkpoint write")
