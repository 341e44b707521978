"""Faults planted in the program's sampling of documents, each of which
the correctness check of a `train_jobs_sampled` cell has to read as not
correct, beside the faults of `train_jobs` (portbench/faults.py), which
the sampled job runs too. The tests plant them at a size the CPU holds;
on the card, at the cell's own size (faults.py's runner, with this
kind's faults beside its own):

    python3 portbench/faults_sampled.py --workload <cell> --fault <name> \
        --seeds 1,2,3
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script
    sys.path.insert(0, ROOT)

from portbench import faults  # noqa: E402


def race_ignores_weights(setattr_):
    """The race's dice are the uniforms alone: the docs' weights are
    left out."""
    from isle_tpu_torch import bmatrix

    def dice(weights, uniforms):
        return uniforms.to(device=weights.device, dtype=torch.float32)

    setattr_(bmatrix, "doc_dice", dice)


def catchword_rank_all_docs(setattr_):
    """The catchword rank is taken over every doc, not the sampled
    ones."""
    from isle_tpu_torch.config import HyperParams

    orig = HyperParams.catchword_rank

    def over_all(self, num_docs, num_topics, sample_rate=None):
        return orig(self, num_docs, num_topics)

    setattr_(HyperParams, "catchword_rank", over_all)


def pivot_one_off(setattr_):
    """The pivot is the dice one place further down the race's order: one
    doc more is kept, none where that dice equals the pivot's. At UCI
    PubMed's 8.2M docs about 25 docs share the pivot's float32 value, so
    the fault keeps the same docs there and no comparison can read it;
    the tests catch it at a size the CPU holds."""
    from isle_tpu_torch import bmatrix

    def select(weights, sample_rate, uniforms, timer=None):
        D = weights.numel()
        dice = bmatrix.doc_dice(weights, uniforms)
        index = min(int(sample_rate * D) + 1, D - 1)
        return dice >= torch.sort(dice, descending=True).values[index]

    setattr_(bmatrix, "dice_select", select)


# the faults of the sampling, and the number that reads each
SAMPLING = [(race_ignores_weights, "sample_off"),
            (catchword_rank_all_docs, "catchword_off"),
            (pivot_one_off, "sample_off")]
# Lloyd's on B stopped after one step is silent here: at 820,000 sampled
# docs one step leaves 0.03-0.31% of B's docs nearer another center, and
# sound runs leave up to 0.14% after their ten (PERF.md gives the readings)
FAULTS = {"train_jobs_sampled": [
    f for f in faults.FAULTS["train_jobs"]
    if f[0] is not faults.lloyds_one_rep] + SAMPLING}
SILENT = {"train_jobs_sampled": faults.SILENT["train_jobs"]
          + [faults.lloyds_one_rep]}


def main(argv=None) -> int:
    faults.FAULTS.update(FAULTS)
    faults.SILENT.update(SILENT)
    return faults.main(argv)


if __name__ == "__main__":
    sys.exit(main())
