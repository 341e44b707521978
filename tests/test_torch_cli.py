"""The port's ISLETrain and ISLEInfer CLIs against isle_tpu's, on the CPU.

Two corpora, each written as a 1-based TDF file: one whose ζ thresholds
bite (torch_parity.biting_corpus), trained unsampled, and a small cut of
the PubMed scale test's (synth.synth_corpus_hashed) trained with its
config, document sampling at 0.1. isle_tpu.cli.train and
isle_tpu_torch.cli.train (--device cpu, the port's draws replaced by
isle_tpu's key schedule) train on each with edge topics, in this
process. Their run directories
must hold the same files: the integer files and the top words byte for
byte, the float files with the same (row, column) lines and values within
the golden tolerance of 1e-4. Then each ISLEInfer reads its own written
model and infers the file: the reports list the same (doc, topic) pairs
with weights within 1e-4. Last, the report split in blocks of a few docs
follows ISLEInfer.cpp's `_doc_<lo>_to_<hi>` names and concatenates to the
one-file report. Last, each CLI's "peak RSS" is its own process's."""

import filecmp
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import isle_tpu.obs
from isle_tpu.cli import infer as jinfer
from isle_tpu.cli import train as jtrain
from isle_tpu_torch import inferencer, native, synth
from isle_tpu_torch import trainer as port_trainer
from isle_tpu_torch.cli import infer, train
from torch_parity import JaxDraws, biting_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, EDGES, SEED = 4, 6, 3
# the corpora and configs: <sample 0/1> and <sample_rate>, and the docs a
# report block holds in test_report_blocks (three blocks of each corpus)
SCALE_CUT = dict(vocab=640, docs=1_500, nnz=30_000)  # test_torch_pubmed's
CASES = {
    "bite": dict(sample="0", rate="0", block=150),
    "scale": dict(sample="1", rate="0.1", block=500),
}
TOL = 1e-4  # tests/test_golden.py's
# files compared byte for byte, and files compared as parsed numbers
EXACT_FILES = ("TopTwoTopicsPerDoc.txt", "EdgeTopicComposition.txt",
               "TopWordsPerTopic_catch.txt")
FLOAT_FILES = ("M_hat_catch_sparse", "EdgeModel_sparse", "DocCatchword.tsv",
               "DocTopicCatchwordSums.tsv")
REPORT = "top_topics_iters_15_Lf_10.000000_doc_1_to_{}"


def _run_dir(out):
    (name,) = os.listdir(out)
    return os.path.join(out, name)


def _corpus(case: str):
    if case == "bite":
        return biting_corpus()
    c = SCALE_CUT
    arrays = synth.synth_corpus_hashed(c["vocab"], c["docs"], c["nnz"], 0,
                                       "cpu")
    return synth.corpus_from_csc(*(a.numpy() for a in arrays), c["vocab"])


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tmp_path_factory):
    """Both routes' run directories and reports, and the inputs."""
    case = CASES[request.param]
    tmp = tmp_path_factory.mktemp(f"cli_{request.param}")
    corpus = _corpus(request.param)
    V, D, nnz = corpus.vocab_size, corpus.num_docs, corpus.nnz
    tdf, vocab = str(tmp / "c.tdf"), str(tmp / "vocab")
    with open(tdf, "w") as f:
        for x in zip(corpus.doc_ids() + 1, corpus.rows + 1,
                     corpus.counts.astype(np.int64)):
            f.write("%d %d %d\n" % x)
    with open(vocab, "w") as f:
        f.write("".join(f"word{w}\n" for w in range(V)))
    args = [str(V), str(D), "0", str(K), "0", case["sample"], case["rate"],
            "1", str(EDGES), "--seed", str(SEED)]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # the suite sets JAX's compilation cache; the CLI would move it
        mp.setattr(isle_tpu.obs, "enable_compilation_cache",
                   lambda *a, **kw: None)
        mp.setattr(port_trainer, "Draws", JaxDraws)
        for tag, tmain, imain, dev in (
                ("jax", jtrain.main, jinfer.main, []),
                ("torch", train.main, infer.main, ["--device", "cpu"])):
            assert tmain([tdf, vocab, str(tmp / tag), *args, *dev]) == 0
            run = _run_dir(tmp / tag)
            assert imain([os.path.join(run, "M_hat_catch_sparse"), tdf,
                          str(tmp / f"{tag}_infer"), str(K), str(V), "1",
                          str(D + 1), str(nnz), "0", "0", "0", *dev]) == 0
            out[tag] = (run, str(tmp / f"{tag}_infer"))
    return dict(out, tdf=tdf, tmp=tmp, V=V, D=D, nnz=nnz,
                block=case["block"])


def _keyed(path):
    """A file of `<a>\\t<b>\\t<value>` lines as {(a, b): value}."""
    rows = np.loadtxt(path, ndmin=2)
    return {(int(a), int(b)): v for a, b, v in rows}


@pytest.mark.parametrize("name", EXACT_FILES + FLOAT_FILES)
def test_run_directories_match(runs, name):
    ours, ref = (os.path.join(runs[tag][0], name) for tag in ("torch", "jax"))
    if name in EXACT_FILES:
        assert filecmp.cmp(ours, ref, shallow=False)
        return
    got, want = _keyed(ours), _keyed(ref)
    assert len(want) > 0 and got.keys() == want.keys()
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=0, atol=TOL)


def test_run_directories_hold_the_same_files(runs):
    names = [sorted(os.listdir(runs[tag][0])) for tag in ("torch", "jax")]
    assert names[0] == names[1]
    assert set(EXACT_FILES + FLOAT_FILES) <= set(names[0])


def test_infer_reports_match(runs):
    name = REPORT.format(runs["D"] + 1)
    got, want = (_keyed(os.path.join(runs[tag][1], name))
                 for tag in ("torch", "jax"))
    assert len({d for d, _ in want}) > 0.9 * runs["D"]
    assert got.keys() == want.keys()
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=0, atol=TOL)


def test_report_blocks(runs, monkeypatch, capsys):
    """inferencer.REPORT_BLOCK_DOCS at a third of the docs or a little
    more (150 of the biting corpus's 400): three files named for their
    docs ([1, 151), [151, 301) and [301, 401) there), whose concatenation
    is the one-file report; the start line names the device and the text
    I/O."""
    B = runs["block"]
    monkeypatch.setattr(inferencer, "REPORT_BLOCK_DOCS", B)
    run, one = runs["torch"]
    out = runs["tmp"] / "blocks"
    D = runs["D"]
    assert infer.main([os.path.join(run, "M_hat_catch_sparse"), runs["tdf"],
                       str(out), str(K), str(runs["V"]), "1", str(D + 1),
                       str(runs["nnz"]), "0", "0", "0",
                       "--device", "cpu"]) == 0
    assert f"ISLEInfer on cpu, text I/O {native.backend()}\n" in \
        capsys.readouterr().out
    edges = list(range(1, D + 1, B)) + [D + 1]
    names = [f"top_topics_iters_15_Lf_10.000000_doc_{lo}_to_{hi}"
             for lo, hi in zip(edges[:-1], edges[1:])]
    assert len(names) == 3
    assert sorted(n for n in os.listdir(out)
                  if n.startswith("top_topics")) == sorted(names)
    blocks = b"".join((out / n).read_bytes() for n in names)
    with open(os.path.join(one, REPORT.format(D + 1)), "rb") as f:
        assert blocks == f.read()


def test_normalized_to_one_is_infer_files_normalization():
    """Corpus.normalized_to_one (how phase P5 of chip_smoke.py feeds
    ISLEInfer's path without a TDF file) gives the values infer_file's
    reader gives, from_entries(normalize_to_one=True), bit for bit."""
    from isle_tpu_torch.corpus import Corpus

    c = biting_corpus()
    d, w, n = c.doc_ids(), c.rows, c.counts.astype(np.int64)
    unit = Corpus.from_entries(d, w, n, vocab_size=c.vocab_size,
                               num_docs=c.num_docs, normalize_to_one=True)
    got = Corpus.from_entries(d, w, n, vocab_size=c.vocab_size,
                              num_docs=c.num_docs).normalized_to_one()
    assert got.vals.dtype == np.float32
    assert np.array_equal(got.vals, unit.vals)
    for f in ("offsets", "rows", "counts"):
        assert np.array_equal(getattr(got, f), getattr(unit, f))


def test_end_line_reports_the_process_own_peak():
    """A CLI started while this process holds a touched GiB reports its
    own peak RSS (VmHWM, which exec resets), well below the GiB, not
    ru_maxrss, which Linux carries from the starting process across fork
    and exec."""
    ballast = np.ones(1 << 27)  # 1 GiB of float64, every page touched
    assert train.status_bytes("VmRSS") >= ballast.nbytes
    code = ("import torch\n"
            "from isle_tpu_torch.cli.train import PeakRss, end_line, "
            "status_bytes\n"
            "print(end_line('ISLETrain', torch.device('cpu'), PeakRss()))\n"
            "print(status_bytes('VmHWM'))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, check=True,
                          timeout=300)
    line, hwm = proc.stdout.splitlines()[-2:]
    prefix = "ISLETrain done, peak RSS "
    assert line.startswith(prefix) and line.endswith(" GiB"), line
    got = float(line[len(prefix):-len(" GiB")]) * 2**30
    assert got < ballast.nbytes / 2
    assert abs(got - int(hwm)) <= 0.01 * 2**30
    del ballast


def test_peak_rss_without_vmhwm(monkeypatch):
    """Where /proc/self/status has VmRSS but no VmHWM (gVisor's), the
    peak is the largest VmRSS a thread reads every period, and says so;
    without either the line says the figure is unknown."""
    real = train.status_bytes
    monkeypatch.setattr(train, "status_bytes", lambda field, *a: None
                        if field == "VmHWM" else real(field, *a))
    peak = train.PeakRss(period=0.01)
    held = np.ones(1 << 25)  # 256 MiB, touched
    rss = real("VmRSS")
    for _ in range(500):
        if peak.sampled >= rss:
            break
        time.sleep(0.01)
    del held
    line = train.end_line("ISLEInfer", torch.device("cpu"), peak)
    assert line.endswith("GiB (VmRSS read every 0.01 s: no VmHWM here)")
    assert float(line.split()[4]) * 2**30 >= rss - 0.01 * 2**30
    monkeypatch.setattr(train, "status_bytes", lambda *a: None)
    assert train.end_line("ISLEInfer", torch.device("cpu"),
                          train.PeakRss()) == \
        "ISLEInfer done, peak RSS unknown"
    assert real("VmHWM", "/nonexistent/status") is None
