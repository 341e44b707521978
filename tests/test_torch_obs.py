"""The port's span and counter record (isle_tpu_torch/obs.py): spans and
their parents inside a Timer's stages, self time, counters, the bounded
list of recent Timers, the profiler ranges, and the spans and counters a
tiny training job and a tiny inference job record on the CPU."""

import json
import os
import re

import numpy as np
import pytest
import torch

from isle_tpu_torch import obs
from isle_tpu_torch.config import GpuConfig, InferConfig, TrainConfig
from isle_tpu_torch.corpus import Corpus
from isle_tpu_torch.inferencer import Inferencer
from isle_tpu_torch.mwu import build_infer_batch
from isle_tpu_torch.synth import synth_corpus
from isle_tpu_torch.trainer import Trainer

CPU = GpuConfig(device="cpu")


def _names(timer):
    return {name for name, *_ in timer.spans}


def test_spans_nest_under_the_open_span_else_the_open_stage():
    t = obs.Timer()
    with t.span("outer"):
        with t.span("inner"):
            pass
        with obs.span(t, "inner"):
            pass
    t.next("stage one")
    with t.span("later"):
        pass
    # a span is recorded at its end; a stage's own spans take its label
    # when next() closes it
    assert [(n, p) for n, p, *_ in t.spans[:3]] == [
        ("inner", "outer"), ("inner", "outer"), ("outer", "stage one")]
    assert t.spans[3][1] is None  # its stage is still open
    t.next("stage two")
    assert t.spans[3][:2] == ("later", "stage two")
    assert [p[0] for p in t.phases] == ["stage one", "stage two"]
    for _, _, start, end in t.spans:
        assert start <= end


def test_self_time_leaves_out_the_spans_inside():
    t = obs.Timer()
    t.spans = [("a", "b", 1.0, 2.0), ("a", "b", 3.0, 3.5),
               ("b", "stage", 0.0, 5.0), ("c", "stage", 6.0, 7.0)]
    assert t.span_seconds() == {"a": 1.5, "b": 5.0, "c": 1.0}
    assert t.self_seconds() == {"a": 1.5, "b": 3.5, "c": 1.0}


def test_a_span_records_when_its_body_raises():
    t = obs.Timer()
    with pytest.raises(ValueError):
        with t.span("fails"):
            raise ValueError("x")
    assert _names(t) == {"fails"} and t._open == []


def test_counters_add_up():
    t = obs.Timer()
    t.count("a")
    t.count("a", 4)
    obs.count(t, "b", 2)
    obs.count(None, "b", 2)
    with obs.span(None, "nothing"):
        pass

    class Lines:  # a timer= that only takes diagnostic lines
        def diag(self, msg):
            pass

    obs.count(Lines(), "b", 2)
    with obs.span(Lines(), "nothing"):
        pass
    assert t.counters == {"a": 5, "b": 2} and t.spans == []


def test_recent_timers_are_the_last_256_oldest_first():
    made = [obs.Timer() for _ in range(300)]
    got = obs.recent_timers()
    assert len(got) == 256 and got == made[-256:]
    newest = obs.Timer()
    assert obs.recent_timers()[-2:] == [made[-1], newest]


def test_no_record_function_without_a_profiler(monkeypatch):
    def refused(*a, **kw):
        raise AssertionError("record_function opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    t = obs.Timer()
    with t.span("plain"):
        pass
    assert _names(t) == {"plain"}


def test_spans_are_profiler_ranges_inside_the_job(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    t = obs.Timer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("job"):
            with t.span("outer"):
                with t.span("inner"):
                    torch.ones(8).sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"}
    job, outer, inner = (events[n] for n in
                         ("job", obs.SPAN_MARK + "outer",
                          obs.SPAN_MARK + "inner"))

    def inside(a, b):
        return b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]

    assert inside(inner, outer) and inside(outer, job)
    assert _names(t) == {"outer", "inner"}


# -- the program's spans and counters ----------------------------------------

TRAIN_SPANS = {"upload: doc ids", "upload: copy to device",
               "upload: word-order sort", "stage end: device wait",
               "eigensolve: start block", "eigensolve: expand",
               "eigensolve: ritz",
               "eigensolve: stop test", "checkpoint write",
               "edge topics: build"}
INFER_SPANS = {"pack: model mass", "pack: keep mask", "pack: fill",
               "mwu: set-up", "mwu: block slice", "mwu: copy to device",
               "mwu: core", "mwu: write back", "mwu: results",
               "stage end: device wait"}
TRAIN_STAGES = ["upload A to device", "computing thresholds",
                "creating thresholded matrix (fused hybrid)",
                "eigen solve (B B^T)", "project docs",
                "k-means seeds initialization",
                "converging Lloyds k-means on B_k", "k-means on B",
                "collecting word freqs in clusters",
                "finding catchwords for clusters",
                "constructing topic vectors", "constructing edge topic model"]
MWU_COUNTERS = {"mwu blocks", "mwu guesses", "mwu slots", "mwu entries"}


def _corpus(vocab=400, docs=600, nnz=12000, unit=False):
    d, w, c = synth_corpus(vocab, docs, nnz, seed=3)
    corpus = Corpus.from_entries(d, w, c, vocab_size=vocab, num_docs=docs)
    if unit:  # each doc's values sum to one, as inference takes them
        vals = corpus.vals.astype(np.float64)
        sums = np.add.reduceat(vals, corpus.offsets[:-1][
            np.diff(corpus.offsets) > 0])
        lengths = np.diff(corpus.offsets)
        per = np.repeat(sums, lengths[lengths > 0])
        corpus.vals = (vals / per).astype(np.float32)
    return corpus


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cfg = TrainConfig(num_topics=8, seed=2, compute_edge_topics=True,
                      max_edge_topics=10)
    tr = Trainer(cfg, output_dir=str(tmp_path_factory.mktemp("train")),
                 quiet=True, gpu=CPU)
    tr.load_corpus(_corpus())
    tr.train()
    tr.train_edge_topics()
    return tr


def test_a_training_job_records_every_span_and_counter(trained):
    t = trained.timer
    assert TRAIN_SPANS <= _names(t), TRAIN_SPANS - _names(t)
    stages = [label for label, *_ in t.phases]
    assert stages == TRAIN_STAGES  # spans move no stage boundary
    # every span sits in a stage of the job, or in one of its spans
    assert {p for _, p, *_ in t.spans} <= set(stages) | _names(t)
    parent = {n: p for n, p, *_ in t.spans}
    assert parent["upload: copy to device"] == "upload A to device"
    assert parent["edge topics: build"] == "constructing edge topic model"
    assert parent["eigensolve: ritz"] == "eigen solve (B B^T)"
    writes = [p for n, p, *_ in t.spans if n == "checkpoint write"]
    assert len(writes) == 3  # svd, kmeans, model
    files = [os.path.join(trained.run_dir, f"ckpt_{s}.npz")
             for s in ("svd", "kmeans", "model")]
    assert t.counters["checkpoint bytes"] == sum(map(os.path.getsize, files))
    # the CSC arrays the upload reads: word ids, values and offsets
    corpus = trained.corpus
    assert t.counters["upload bytes"] == (8 * corpus.nnz
                                          + 8 * (corpus.num_docs + 1))
    with open(os.path.join(trained.run_dir, "diagnosticLog.txt")) as f:
        restarts = re.search(r"block_ks_device: (\d+) restarts", f.read())
    assert t.counters.get("eigensolve restarts", 0) == int(restarts[1])


def test_an_inference_job_records_every_span_and_counter(tmp_path):
    corpus = _corpus(unit=True)
    rng = np.random.default_rng(0)
    model = rng.random((400, 6)).astype(np.float32)
    model[:40] = 0.0  # words of no mass are dropped from the batch
    model /= model.sum(axis=0)
    cfg = InferConfig(num_topics=6, vocab_size=400)
    inf = Inferencer(cfg, model=model, output_dir=str(tmp_path), quiet=True,
                     gpu=CPU)
    res = inf.infer_corpus(corpus, top_n=3)
    t = inf.timer
    assert [label for label, *_ in t.phases] == ["pack inference batch",
                                                 "MWU inference"]
    assert INFER_SPANS <= _names(t), INFER_SPANS - _names(t)
    parent = {n: p for n, p, *_ in t.spans}
    assert parent["pack: model mass"] == "pack inference batch"
    assert parent["mwu: write back"] == "MWU inference"
    assert MWU_COUNTERS <= set(t.counters), t.counters
    batch = build_infer_batch(corpus, model.sum(axis=1))
    kept = int((batch.word_idx < 400).sum())
    assert 0 < kept < corpus.nnz
    assert t.counters["mwu entries"] == kept
    assert t.counters["mwu slots"] >= kept
    assert t.counters["mwu guesses"] >= t.counters["mwu blocks"] >= 1
    assert res.num_converged > 0


@pytest.mark.cuda
def test_an_inference_job_on_the_card_records_the_card_pack(tmp_path):
    """On the card the batch is packed there: the spans of the CSR's copy,
    the keep mask and the fill in the pack stage, the counters `pack on
    card` and `pack bytes to device` (offsets, rows, vals, keep table,
    the rows' starts and widths),
    no `mwu: copy to device` (the blocks are cut on the card), and both
    pack kernels in the job's device trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the pack kernels have no CPU mode)")
    corpus = _corpus(unit=True)
    rng = np.random.default_rng(0)
    model = rng.random((400, 6)).astype(np.float32)
    model[:40] = 0.0
    model /= model.sum(axis=0)
    prof = str(tmp_path / "prof")
    inf = Inferencer(InferConfig(num_topics=6, vocab_size=400), model=model,
                     output_dir=str(tmp_path / "out"), quiet=True,
                     gpu=GpuConfig(device="cuda", profile_dir=prof))
    res = inf.infer_corpus(corpus, top_n=3)
    (trace,) = os.listdir(prof)
    with open(os.path.join(prof, trace)) as f:
        kernels = {e.get("name", "") for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"}
    for name in ("pack_kept_lengths_kernel", "pack_fill_kernel"):
        assert any(name in k for k in kernels), sorted(kernels)
    t = inf.timer
    card = INFER_SPANS - {"mwu: copy to device"} | {"pack: copy to device"}
    assert card <= _names(t), card - _names(t)
    assert "mwu: copy to device" not in _names(t)
    parent = {n: p for n, p, *_ in t.spans}
    for name in ("pack: copy to device", "pack: keep mask", "pack: fill"):
        assert parent[name] == "pack inference batch"
    assert t.counters["pack on card"] == 1
    table = 4 * -(-400 // 32)
    assert t.counters["pack bytes to device"] == (
        8 * corpus.nnz + 8 * (corpus.num_docs + 1) + table
        + 12 * corpus.num_docs)  # each row's start and width
    kept = int((build_infer_batch(corpus, model.sum(axis=1)).word_idx
                < 400).sum())
    assert t.counters["mwu entries"] == kept
    assert MWU_COUNTERS <= set(t.counters) and res.num_converged > 0


def test_profile_dir_traces_inference(tmp_path):
    corpus = _corpus(unit=True)
    model = np.full((400, 4), 1.0 / 400, np.float32)
    prof = str(tmp_path / "prof")
    inf = Inferencer(InferConfig(num_topics=4, vocab_size=400), model=model,
                     output_dir=str(tmp_path / "out"), quiet=True,
                     gpu=GpuConfig(device="cpu", profile_dir=prof))
    inf.infer_corpus(corpus, top_n=2)
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].startswith("infer_"), files
    with open(os.path.join(prof, files[0])) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {obs.STAGE_MARK + "pack inference batch",
            obs.STAGE_MARK + "MWU inference"} <= names
    assert {obs.SPAN_MARK + n for n in INFER_SPANS
            if n != "pack: model mass"} <= names
    assert inf._tracing is False
