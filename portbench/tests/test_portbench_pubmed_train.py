"""The cell pubmed-train at a size the CPU holds: sound runs of the sampled
training job come out correct; the control (the sampling reference in
bfloat16 in the program's place) and each fault of the program's
sampling (portbench/faults_sampled.py), planted under a run of the
harness, come out not correct, each by the number named. The
reference's race against a case worked by hand, its uniforms against the
program's draws, and the cell's per-layer metrics on a traced run."""

import copy

import pytest
import torch

from conftest import SEED
from portbench import control, faults_sampled, harness
from portbench.reference import train_sampled_ref as ref

CELL = "pubmed-train"
METRICS = ["sample_s.pubtrain", "head_nnz_pct.pubtrain",
           "edge_build_ms_per_topic.pubtrain"]


def _run(bench, base, seed=SEED, trace=False):
    return harness.run_cell(bench, CELL, seed, 0.5, trace, "cpu", base=base)


@pytest.mark.parametrize("seed", [SEED, 17])
def test_sound_runs_are_correct(bench, tiny_base, seed):
    r = _run(bench, tiny_base, seed)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    f = r["facts"]
    assert r["checks"]["sample_off"]["value"] == 0
    # a tenth of the tiny shape's 4000 docs, and the ties at the pivot
    assert f["sampled_prog"] >= 400 and f["docs_b"] == f["sampled_prog"]
    assert set(r["metrics"]) == {"train_s", "setup_s"}


def test_each_job_trains_on_a_seed_of_its_own(bench, tiny_base):
    """The window's jobs train on seeds drawn from --seed and their index,
    and the judge holds the judged job to the reference on its seed."""
    from portbench.kinds import train_jobs_sampled as kind

    r = _run(bench, tiny_base)
    assert r["correct"], r["checks"]
    f = r["facts"]
    cell = kind.Cell({"shape": {}, "train": {}}, {}, SEED, "cpu", "")
    assert f["train_seeds"] == [cell.train_seed(i)
                                for i in range(r["attempted"])]
    assert len(set(f["train_seeds"] + [cell.train_seed(-1), SEED])) \
        == r["attempted"] + 2
    assert f["train_seed"] == f["train_seeds"][f["judged_job"]]


def test_a_job_judged_on_another_seed_is_not_correct(bench, tiny_base,
                                                     monkeypatch):
    """The judge's sampling follows the judged job's seed: told the run's
    seed in its place, it reads the job's docs as sampled off."""
    from portbench.kinds import train_jobs_sampled as kind

    job = kind.Cell.job

    def told_the_run_seed(self, i, mark=None):
        return dict(job(self, i, mark), train_seed=self.seed)

    monkeypatch.setattr(kind.Cell, "job", told_the_run_seed)
    r = _run(bench, tiny_base)
    assert not r["correct"]
    assert r["checks"]["sample_off"]["value"] > 0


def test_the_bf16_control_is_not_correct(bench, tiny_base):
    numbers = control.control(bench, CELL, SEED, "cpu", "bf16", tiny_base)
    limits = harness.cell_files(harness.workload(bench, CELL),
                                tiny_base)[0]["limits"]
    assert set(numbers) == set(limits)
    assert any(v > limits[n] for n, v in numbers.items()), numbers


FAULTS = faults_sampled.FAULTS["train_jobs_sampled"]


@pytest.mark.parametrize("plant,caught_by", FAULTS,
                         ids=[f[0].__name__ for f in FAULTS])
def test_a_planted_fault_is_not_correct(bench, tiny_base, monkeypatch, plant,
                                        caught_by):
    plant(monkeypatch.setattr)
    r = _run(bench, tiny_base)
    assert not r["correct"]
    c = r["checks"][caught_by]
    assert c["value"] > c["limit"], r["checks"]


# -- the reference's race -----------------------------------------------------

WEIGHTS = [2.0, 0.0, 1.0, 4.0, 2.0, 1.0]
UNIFORMS = [0.25, 0.9, 0.5, 0.0625, 0.81, 0.36]
# dice u^(1/w): 0.5, 0 (no weight), 0.5, 0.5, 0.9, 0.36; in order 0.9,
# 0.5, 0.5, 0.5, 0.36, 0
CASES = [
    # floor(0.4 * 6) = 2: the pivot 0.5, and every doc tied with it kept
    (0.4, 0.5, [True, False, True, True, True, False]),
    (0.5, 0.5, [True, False, True, True, True, False]),
    (0.1, 0.9, [False, False, False, False, True, False]),  # index 0
    (0.7, 0.36, [True, False, True, True, True, True]),
    # a rate of 1 or more is clamped to the last doc: every doc reaches it
    (1.0, 0.0, [True] * 6),
    (2.5, 0.0, [True] * 6),
]


@pytest.mark.parametrize("rate,pivot,kept", CASES)
def test_the_race_matches_a_case_worked_by_hand(rate, pivot, kept):
    from isle_tpu_torch import bmatrix

    w = torch.tensor(WEIGHTS, dtype=torch.float64)
    u = torch.tensor(UNIFORMS, dtype=torch.float32)
    dice, p, mask = ref.race(w, u, rate)
    assert p == pytest.approx(pivot, rel=1e-7)  # u is float32: 0.81, 0.36
    assert mask.tolist() == kept
    assert dice[1] == 0.0 and dice[4] == pytest.approx(0.9, rel=1e-7)
    # the program's float32 race keeps the same docs here
    assert bmatrix.dice_select(w.float(), rate, u).tolist() == kept


def test_the_band_is_a_few_float32_steps_of_the_pivot():
    for p in (0.9964, 0.5, 0.01):
        step = float(torch.finfo(torch.float32).eps) * p  # at most 2 ulps
        assert 4 * step <= ref.band(p) <= 64 * step * (1 + abs(
            torch.log(torch.tensor(p)).item()))
    assert ref.band(0.0) == 0.0


@pytest.mark.parametrize("seed", [SEED, 0, 7])
def test_the_uniforms_are_the_programs_sampling_draws(seed):
    from isle_tpu_torch.rng import Draws

    assert torch.equal(ref.sampling_uniforms(seed, 5000),
                       Draws(seed).doc_sample_uniforms(5000))


def test_the_catchword_rank_is_over_the_sampled_docs():
    from isle_tpu_torch.config import HyperParams

    hp = {"eps2": 1.0 / 3.0, "w0": 1.0}
    for docs, k in ((8_200_000, 100), (4000, 10), (30, 10)):
        assert ref.catchword_rank(hp, docs, k, 0.1) == max(
            HyperParams().catchword_rank(docs, k, 0.1), 1)


# -- the cell's per-layer metrics ---------------------------------------------

@pytest.fixture(scope="module")
def traced(bench, tmp_path_factory):
    """(the traced run's result, the ctx its readers were given, the
    program's recent Timers at the run's end, the tiny base)."""
    from conftest import make_tiny_base
    from isle_tpu_torch import obs

    base = make_tiny_base(str(tmp_path_factory.mktemp("tiny") / "portbench"))
    ctxs = []
    real = harness.metric_reader

    def spy(name, base_=harness.HERE):
        read = real(name, base_)

        def wrapped(ctx):
            ctxs.append(ctx)
            return read(ctx)
        return wrapped

    harness.metric_reader = spy
    try:
        r = _run(bench, base, trace=True)
    finally:
        harness.metric_reader = real
    return r, ctxs[0], obs.recent_timers(), base


@pytest.mark.parametrize("metric", METRICS)
def test_the_metric_reads_a_number_on_a_traced_run(bench, traced, metric):
    r, *_ = traced
    assert r["correct"], r["checks"]
    v = r["metrics"][metric]["value"]
    assert isinstance(v, float) and v >= 0.0
    spec = [m for m in bench["per_layer"] if m["name"] == metric][0]
    assert r["metrics"][metric]["unit"] == spec["unit"]
    assert spec["workloads"] == [CELL] and spec["moves"] == "train_s"
    if metric == "head_nnz_pct.pubtrain":
        assert 0.0 < v <= 100.0


@pytest.mark.parametrize("metric", METRICS)
def test_the_metric_reads_nothing_where_the_timers_are_not_the_jobs(
        monkeypatch, traced, metric):
    from isle_tpu_torch import obs

    _, ctx, timers, base = traced
    monkeypatch.setattr(obs, "recent_timers", lambda: list(timers))
    read = harness.metric_reader(metric, base)
    assert read(ctx) is not None
    off = copy.copy(ctx)
    off["jobs"] = [dict(r, phases=dict(r["phases"])) for r in ctx["jobs"]]
    label = next(iter(off["jobs"][0]["phases"]))
    off["jobs"][0]["phases"][label] += 1.0
    assert read(off) is None


@pytest.mark.parametrize("metric", METRICS)
def test_the_metric_reads_nothing_without_the_programs_record(
        monkeypatch, traced, metric):
    """A program without the spans and counters (the parent of the
    change that added them) leaves the metric out."""
    from isle_tpu_torch import obs

    _, ctx, timers, base = traced
    bare = []
    for t in timers:
        b = obs.Timer()
        b.phases = t.phases
        b.spans = [s for s in t.spans if not s[0].startswith("sample:")]
        b.counters = {}
        bare.append(b)
    monkeypatch.setattr(obs, "recent_timers", lambda: bare)
    assert harness.metric_reader(metric, base)(ctx) is None
    monkeypatch.delattr(obs, "recent_timers")
    assert harness.metric_reader(metric, base)(ctx) is None
