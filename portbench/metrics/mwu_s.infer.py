"""mwu_s.infer: seconds per inference job of the program's stage "MWU
inference" (mwu.infer_all: MWU on the card in blocks, torch.bmm, and the
results' readback, ending in a synchronize)."""

from portbench.readers import stage_mean


def read(ctx):
    return stage_mean(ctx, "MWU inference")
