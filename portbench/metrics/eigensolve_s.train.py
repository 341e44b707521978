"""eigensolve_s.train: seconds per training job of the program's stage
"eigen solve (B B^T)" (linalg.block_ks_device through
trainer.solve_gram_eigens, ending in a synchronize; the svd checkpoint is
written after the stage's end, in "project docs")."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, "eigen solve (B B^T)")
