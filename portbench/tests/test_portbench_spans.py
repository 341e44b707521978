"""The per-layer metrics that read the program's own spans and counters
(portbench/spans.py): each reads a number on a tiny traced run of its
cell on the CPU, and reads nothing where the program's last Timers are
not the window's jobs or the program keeps no such record."""

import copy

import pytest

from conftest import SEED
from portbench import harness

SPAN_METRICS = {
    "nytimes-train": ["upload_copy_s.train", "checkpoint_write_s.train",
                      "edge_build_s.train"],
    "pubmed-infer": ["pack_fill_s.infer", "mwu_host_s.infer",
                     "mwu_pad_pct.infer"],
}


@pytest.fixture(scope="module")
def traced(bench, tmp_path_factory):
    """cell -> (the traced run's result, the ctx its readers were given,
    the program's recent Timers at the run's end, the tiny base)."""
    from conftest import make_tiny_base
    from isle_tpu_torch import obs

    base = make_tiny_base(str(tmp_path_factory.mktemp("tiny") / "portbench"))
    out = {}
    for cell in SPAN_METRICS:
        ctxs = []
        real = harness.metric_reader

        def spy(name, base_=harness.HERE, _real=real):
            read = _real(name, base_)

            def wrapped(ctx):
                ctxs.append(ctx)
                return read(ctx)
            return wrapped

        harness.metric_reader = spy
        try:
            r = harness.run_cell(bench, cell, SEED, 0.5, True, "cpu",
                                 base=base)
        finally:
            harness.metric_reader = real
        out[cell] = (r, ctxs[0], obs.recent_timers(), base)
    return out


CASES = [(cell, m) for cell, ms in SPAN_METRICS.items() for m in ms]


@pytest.mark.parametrize("cell,metric", CASES)
def test_the_metric_reads_a_number_on_a_traced_run(bench, traced, cell,
                                                   metric):
    r, *_ = traced[cell]
    assert r["correct"], r["checks"]
    v = r["metrics"][metric]["value"]
    assert isinstance(v, float) and v >= 0.0
    if metric.endswith("_pct.infer"):
        assert v < 100.0
    spec = [m for m in bench["per_layer"] if m["name"] == metric][0]
    assert r["metrics"][metric]["unit"] == spec["unit"]


@pytest.mark.parametrize("cell,metric", CASES)
def test_the_metric_reads_nothing_where_the_timers_are_not_the_jobs(
        monkeypatch, traced, cell, metric):
    from isle_tpu_torch import obs

    _, ctx, timers, base = traced[cell]
    monkeypatch.setattr(obs, "recent_timers", lambda: list(timers))
    read = harness.metric_reader(metric, base)
    assert read(ctx) is not None
    off = copy.copy(ctx)
    off["jobs"] = [dict(r, phases=dict(r["phases"])) for r in ctx["jobs"]]
    label = next(iter(off["jobs"][0]["phases"]))
    off["jobs"][0]["phases"][label] += 1.0
    assert read(off) is None
    more = dict(ctx, jobs=ctx["jobs"] + ctx["jobs"][:1])  # one job too many
    assert read(more) is None


@pytest.mark.parametrize("cell,metric", CASES)
def test_the_metric_reads_nothing_without_the_programs_record(
        monkeypatch, traced, cell, metric):
    from isle_tpu_torch import obs

    _, ctx, _, base = traced[cell]
    monkeypatch.delattr(obs, "recent_timers")
    assert harness.metric_reader(metric, base)(ctx) is None
