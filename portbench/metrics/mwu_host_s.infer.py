"""mwu_host_s.infer: seconds per inference job in the program's spans
"mwu: block slice", "mwu: copy to device" and "mwu: write back"
(mwu.infer_all: each block's numpy slice, its two copies to the card, its
top-n and results read back and written into the host's arrays), inside
the stage "MWU inference"."""

from portbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "mwu: block slice", "mwu: copy to device",
                     "mwu: write back")
