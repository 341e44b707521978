"""A configuration, a traffic mix and a per-layer metric added as files
are found by their names, with no edit of the harness."""

import copy
import json
import os

from conftest import SEED
from portbench import harness

NEW_METRIC = '''
def read(ctx):
    return float(len(ctx["jobs"]))
'''
SILENT_METRIC = '''
def read(ctx):
    return None
'''


def test_new_files_are_found_by_name(bench, tiny_base):
    with open(os.path.join(tiny_base, "configs",
                           "uci-nytimes-k100.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny-new"
    cfg["train"]["max_edge_topics"] = 12
    with open(os.path.join(tiny_base, "configs", "tiny-new.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(tiny_base, "traffic", "train_jobs.json")) as f:
        traffic = json.load(f)
    traffic["traced_jobs"] = 1
    with open(os.path.join(tiny_base, "traffic", "one_traced.json"),
              "w") as f:
        json.dump(traffic, f)
    for name, body in (("jobs_seen.new", NEW_METRIC),
                       ("nothing_to_read.new", SILENT_METRIC)):
        with open(os.path.join(tiny_base, "metrics", f"{name}.py"),
                  "w") as f:
            f.write(body)
    b = copy.deepcopy(bench)
    b["workloads"].append({"name": "new-cell", "config": "tiny-new",
                           "traffic": "one_traced", "chips": 1,
                           "why": "a test"})
    b["end_to_end"][0]["workloads"].append("new-cell")
    for name in ("jobs_seen.new", "nothing_to_read.new"):
        b["per_layer"].append({"name": name, "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "Test", "moves": "train_s",
                               "workloads": ["new-cell"]})
    r = harness.run_cell(b, "new-cell", SEED, 0.5, True, "cpu",
                         base=tiny_base)
    assert r["correct"], r["checks"]
    assert r["metrics"]["jobs_seen.new"]["value"] >= 1
    assert "nothing_to_read.new" not in r["metrics"]
    # a metric that lists its cells is read in those alone
    assert "upload_s.train" not in r["metrics"]
    assert len(r["facts"]) and r["facts"]["vocab"] == 3000
    assert list(r)[-1] == "checks"


def test_a_metric_without_workloads_follows_its_end_to_end_metric(bench):
    m = {"name": "x", "moves": "train_s"}
    assert harness.reports(bench, m, "nytimes-train")
    assert not harness.reports(bench, m, "pubmed-infer")
    assert harness.reports(bench, {"name": "y", "moves": "setup_s"},
                           "pubmed-infer")
