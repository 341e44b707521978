"""upload_s.train: seconds per training job of the program's stage "upload
A to device" (sparse.DocSparse.from_corpus, the corpus to the card,
ending in a synchronize; the stage's clock starts at the Trainer's
construction)."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, "upload A to device")
