"""eigensolve_roofline.train: the least time of the eigensolve's Gram
applies over the card's busy time inside the stage "eigen solve (B B^T)"
of the traced jobs, in percent. The applies are counted by the program's
Trainer.op_counter; the least time of one is its bytes with B held as
COO, read once by B^T X and once by B Y with each operand and output
once, at the card's HBM bandwidth (portbench/yardstick.py); nnz(B) and
B's docs are the reference's."""

from portbench.trace import stage_busy
from portbench.yardstick import gram_apply_seconds


def read(ctx):
    if not ctx["summary"] or not ctx["traced"]:
        return None
    _, busy = stage_busy(ctx["summary"], "eigen solve (B B^T)")
    if busy <= 0:
        return None
    f = ctx["facts"]
    calls = sum(r["op_calls"] for r in ctx["traced"])
    least = gram_apply_seconds(f["nnz_b"], f["vocab"], f["docs_b"],
                               f["width"], calls)
    return 100.0 * least / busy
