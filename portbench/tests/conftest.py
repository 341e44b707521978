"""Fixtures of the benchmark's own tests: BENCHMARK.json, and a copy of
portbench's configs, traffic and metrics with each configuration cut to
a size the CPU runs in seconds (its limits, traffic and options as
committed)."""

import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
# a few threads a test process: pytest-xdist's workers share the cores
torch.set_num_threads(2)

TINY_SHAPE = {"vocab": 3000, "docs": 4000, "nnz_target": 120000, "k": 10}
TINY_EDGES = 30
SEED = 2**31 + 12345  # more than 32 signed bits hold: seeds can be this large


@pytest.fixture(scope="session")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def make_tiny_base(dest: str) -> str:
    src = os.path.join(ROOT, "portbench")
    for sub in ("traffic", "metrics"):
        shutil.copytree(os.path.join(src, sub), os.path.join(dest, sub))
    os.makedirs(os.path.join(dest, "configs"))
    for name in os.listdir(os.path.join(src, "configs")):
        with open(os.path.join(src, "configs", name)) as f:
            cfg = json.load(f)
        cfg["shape"] = dict(TINY_SHAPE)
        if "train" in cfg:
            cfg["train"]["max_edge_topics"] = TINY_EDGES
        with open(os.path.join(dest, "configs", name), "w") as f:
            json.dump(cfg, f)
    return dest


@pytest.fixture
def tiny_base(tmp_path):
    return make_tiny_base(str(tmp_path / "portbench"))
