"""The port's ISLETrain and ISLEInfer CLIs against isle_tpu's, on the CPU.

A corpus whose ζ thresholds bite (torch_parity.biting_corpus) is written
as a 1-based TDF file; isle_tpu.cli.train and isle_tpu_torch.cli.train
(--device cpu, the port's draws replaced by isle_tpu's key schedule)
train on it with edge topics, in this process. Their run directories
must hold the same files: the integer files and the top words byte for
byte, the float files with the same (row, column) lines and values within
the golden tolerance of 1e-4. Then each ISLEInfer reads its own written
model and infers the file: the reports list the same (doc, topic) pairs
with weights within 1e-4. Last, the report split in blocks of a few docs
follows ISLEInfer.cpp's `_doc_<lo>_to_<hi>` names and concatenates to the
one-file report."""

import filecmp
import os

import numpy as np
import pytest

import isle_tpu.obs
from isle_tpu.cli import infer as jinfer
from isle_tpu.cli import train as jtrain
from isle_tpu_torch import inferencer, native
from isle_tpu_torch import trainer as port_trainer
from isle_tpu_torch.cli import infer, train
from torch_parity import JaxDraws, biting_corpus

K, EDGES, SEED = 4, 6, 3
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both routes' run directories and reports, and the inputs."""
    tmp = tmp_path_factory.mktemp("cli")
    corpus = biting_corpus()
    V, D, nnz = corpus.vocab_size, corpus.num_docs, corpus.nnz
    tdf, vocab = str(tmp / "c.tdf"), str(tmp / "vocab")
    with open(tdf, "w") as f:
        for x in zip(corpus.doc_ids() + 1, corpus.rows + 1,
                     corpus.counts.astype(np.int64)):
            f.write("%d %d %d\n" % x)
    with open(vocab, "w") as f:
        f.write("".join(f"word{w}\n" for w in range(V)))
    args = [str(V), str(D), "0", str(K), "0", "0", "0", "1", str(EDGES),
            "--seed", str(SEED)]
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
    return dict(out, tdf=tdf, tmp=tmp, V=V, D=D, nnz=nnz)


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
    """inferencer.REPORT_BLOCK_DOCS at 150 docs: three files named for
    docs [1, 151), [151, 301) and [301, 401), whose concatenation is the
    one-file report; the start line names the device and the text I/O."""
    monkeypatch.setattr(inferencer, "REPORT_BLOCK_DOCS", 150)
    run, one = runs["torch"]
    out = runs["tmp"] / "blocks"
    D = runs["D"]
    assert infer.main([os.path.join(run, "M_hat_catch_sparse"), runs["tdf"],
                       str(out), str(K), str(runs["V"]), "1", str(D + 1),
                       str(runs["nnz"]), "0", "0", "0",
                       "--device", "cpu"]) == 0
    assert f"ISLEInfer on cpu, text I/O {native.backend()}\n" in \
        capsys.readouterr().out
    edges = list(range(1, D + 1, 150)) + [D + 1]
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
