"""The correctness check at a size the CPU holds: sound runs of the
program come out correct; the control (the reference in bfloat16 in the
program's place) and each fault a cell can have, planted in the program
under a run of the harness, come out not correct. One card, so no
exchange between chips to leave out."""

import pytest

from conftest import SEED
from portbench import control, faults, harness

CELLS = ["nytimes-train", "pubmed-infer"]


def _run(bench, base, cell, seed=SEED):
    return harness.run_cell(bench, cell, seed, 0.5, False, "cpu", base=base)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [SEED, 17])
def test_sound_runs_are_correct(bench, tiny_base, cell, seed):
    r = _run(bench, tiny_base, cell, seed)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_is_not_correct(bench, tiny_base, cell):
    numbers = control.control(bench, cell, SEED, "cpu", "bf16", tiny_base)
    limits = harness.cell_files(harness.workload(bench, cell),
                                tiny_base)[0]["limits"]
    assert any(v > limits[n] for n, v in numbers.items()), numbers


# -- faults planted in the program (portbench/faults.py) --------------------

KINDS = {"nytimes-train": "train_jobs", "pubmed-infer": "infer_ranges"}
FAULTS = [(cell, plant, number) for cell, kind in KINDS.items()
          for plant, number in faults.FAULTS[kind]]


@pytest.mark.parametrize("cell,plant,caught_by", FAULTS,
                         ids=[f[1].__name__ for f in FAULTS])
def test_a_planted_fault_is_not_correct(bench, tiny_base, monkeypatch, cell,
                                        plant, caught_by):
    plant(monkeypatch.setattr)
    r = _run(bench, tiny_base, cell)
    assert not r["correct"]
    c = r["checks"][caught_by]
    assert c["value"] > c["limit"], r["checks"]
