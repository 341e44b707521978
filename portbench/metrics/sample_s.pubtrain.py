"""sample_s.pubtrain: seconds per sampled training job in the program's
spans "sample: doc weights" (bmatrix.doc_weights: each doc's ζ mass on
the card) and "sample: race" (bmatrix.dice_select: the dice, the pivot's
sort and the kept docs' count read back, which waits for both), inside
the stage "creating thresholded matrix (fused hybrid)"."""

from portbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "sample: doc weights", "sample: race")
