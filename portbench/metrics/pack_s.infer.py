"""pack_s.infer: seconds per inference job of the program's stage "pack
inference batch" (mwu.build_infer_batch on the host; the stage's clock
starts at the Inferencer's construction)."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, "pack inference batch")
