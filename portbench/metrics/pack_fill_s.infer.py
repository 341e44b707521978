"""pack_fill_s.infer: seconds per inference job in the program's span
"pack: fill" (mwu.build_infer_batch: the padded (docs, width) word and
value arrays filled on the host), inside the stage "pack inference
batch"."""

from portbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "pack: fill")
