"""The corpus whose ζ thresholds bite (isle_tpu_torch.synth.bite_counts:
synth_corpus's (doc, word) pairs with heavy-tailed counts) against
isle_tpu.

At the full NYTimes shape (vocab 102,660, 300,000 docs, 47,544,996 nnz, k
= 100) the port's compute_thresholds on a CPU DocSparse equals
isle_tpu.thresholds.compute_thresholds_np exactly, by default and with
each drop flag, and both equal the digests chip_smoke.py pins for the
card (so the card is held against isle_tpu there without JAX). No doc
drops out of B at that shape: a flat doc's first entry (count 1000)
takes about 0.86 avg_doc_sz, above its word's ζ. At the smallest cut
found where a word's ζ rises above 1 and a doc is dropped from B (vocab
100, 400 docs, 5 entries a doc, k = 4), the port's in-core trainer
equals isle_tpu's on the same draws, and the resident streamed run
keeps the counts as uint16 and ends where the in-core run ends."""

import hashlib
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isle_tpu.bmatrix import threshold_and_copy as jax_threshold_and_copy
from isle_tpu.config import HyperParams, TrainConfig
from isle_tpu.sparse import DocSparse as JaxDocSparse
from isle_tpu.thresholds import compute_thresholds_np
from isle_tpu.trainer import Trainer as JaxTrainer
from isle_tpu_torch import bmatrix, streaming, thresholds
from isle_tpu_torch.config import GpuConfig
from isle_tpu_torch.corpus import Corpus
from isle_tpu_torch.sparse import DocSparse
from isle_tpu_torch.synth import BITE_MAX_COUNT, bite_counts, synth_corpus
from isle_tpu_torch.trainer import Trainer
from torch_parity import REFERENCE_TPU, JaxDraws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NYT = dict(vocab=102_660, docs=300_000, nnz=48_000_000, k=100)
# the smallest cut of the recipe found with a word's ζ above 1 and a doc
# dropped by default (each drop flag drops more)
CUT = dict(vocab=100, docs=400, nnz=2_000, k=4)
FLAGS = {"default": {},
         "few_samples_threshold_drop": dict(few_samples_threshold_drop=True),
         "bad_threshold_drop": dict(bad_threshold_drop=True)}
# isle_tpu's numbers at the full shape: (words with a finite ζ above 1,
# words at ζ = +inf, post-threshold nnz)
FULL = {"default": (130, 0, 38_008_938),
        "few_samples_threshold_drop": (130, 98_363, 13_857_375),
        "bad_threshold_drop": (130, 4_166, 24_352_295)}
CPU = GpuConfig(device="cpu", dense_head_bytes=0)


def _bite_corpus(shape) -> Corpus:
    d, w, _ = synth_corpus(shape["vocab"], shape["docs"], shape["nnz"], 0)
    return Corpus.from_entries(d, w, bite_counts(d, 1),
                               vocab_size=shape["vocab"],
                               num_docs=shape["docs"], sort_dedup=False)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_bite_counts_are_the_recipe():
    """The same counts from the same seed, others from another; Zipf(2)
    capped at BITE_MAX_COUNT; in every doc d with d % 100 == 7 the first
    entry BITE_MAX_COUNT and the others 1."""
    d, _, _ = synth_corpus(2_000, 3_000, 120_000, 0)
    c = bite_counts(d, 1)
    assert c.dtype == np.int64 and c.shape == d.shape
    np.testing.assert_array_equal(c, bite_counts(d, 1))
    assert not np.array_equal(c, bite_counts(d, 2))
    assert c.min() == 1 and c.max() == BITE_MAX_COUNT
    rng = np.random.default_rng(1)
    want = np.minimum(rng.zipf(2.0, len(d)), BITE_MAX_COUNT)
    flat = d % 100 == 7
    np.testing.assert_array_equal(c[~flat], want[~flat])
    for doc in np.unique(d[flat]):
        cd = c[d == doc]
        assert cd[0] == BITE_MAX_COUNT and np.all(cd[1:] == 1), doc


@pytest.fixture(scope="module")
def full():
    """The recipe at the full NYTimes shape: the corpus and the port's A
    on the CPU."""
    corpus = _bite_corpus(NYT)
    return corpus, DocSparse.from_corpus(corpus, "cpu")


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_full_width_thresholds_match_isle_tpu(full, flag):
    """ζ bit for bit and the post-threshold nnz: the port's
    compute_thresholds against isle_tpu's numpy oracle at the NYTimes
    shape, by default and with each drop flag; B's nnz and docs from the
    port's threshold_and_copy; all equal to chip_smoke.py's pins."""
    corpus, A = full
    hp = HyperParams(**FLAGS[flag])
    args = (corpus.avg_doc_sz, corpus.nz_docs, NYT["k"], hp)
    want, want_nnz = compute_thresholds_np(corpus.rows, corpus.vals,
                                           corpus.vocab_size, *args)
    got, nnz = thresholds.compute_thresholds(A, *args)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    assert nnz == want_nnz
    finite = np.isfinite(want)
    assert (int((want[finite] > 1).sum()), int((~finite).sum()),
            want_nnz) == FULL[flag]
    assert corpus.avg_doc_sz == 822.0  # F = 823: 824 histogram columns
    B, cols = bmatrix.threshold_and_copy(A, got)
    assert B.nnz == nnz
    pin = _chip_smoke().BITE_PINS[flag]
    assert pin["zeta_sha256"] == _sha(want)
    assert pin["zeta_above_1"] == FULL[flag][0]
    assert pin["zeta_max"] == float(want[finite].max())
    assert pin["zeta_inf"] == FULL[flag][1]
    assert pin["nnz_b"] == want_nnz
    assert pin["docs_b"] == len(cols)
    assert pin["original_cols_sha256"] == _sha(cols.astype(np.int32))


@pytest.fixture(scope="module")
def cut():
    return _bite_corpus(CUT)


def _config(flag="default", sampled=False):
    kw = dict(sample_docs=True, sample_rate=0.5) if sampled else {}
    return TrainConfig(num_topics=CUT["k"], seed=5, compute_edge_topics=True,
                       max_edge_topics=6, hyper=HyperParams(**FLAGS[flag]),
                       tpu=REFERENCE_TPU, **kw)


def _svd(tr) -> dict:
    with np.load(os.path.join(tr.run_dir, "ckpt_svd.npz")) as z:
        return dict(z)


def _b_builds(corpus, zetas, cfg) -> tuple:
    """(nnz(B), original_cols) of the port's B build and of isle_tpu's,
    sampled as `cfg` says with the trainers' draws."""
    rate = cfg.sample_rate if cfg.sample_docs else None
    draws = JaxDraws(cfg.seed)
    B, cols = bmatrix.threshold_and_copy(
        DocSparse.from_corpus(corpus, "cpu"), torch.from_numpy(zetas),
        sample_rate=rate,
        uniforms=draws.doc_sample_uniforms(corpus.num_docs) if rate else None)
    JB, jcols = jax_threshold_and_copy(JaxDocSparse.from_corpus(corpus),
                                       jnp.asarray(zetas), sample_rate=rate,
                                       key=draws._b if rate else None)
    return (B.nnz, cols), (JB.nnz, jcols)


@pytest.mark.parametrize("case", ["default", "few_samples_threshold_drop",
                                  "bad_threshold_drop", "sample_docs"])
def test_cut_trainer_matches_isle_tpu(tmp_path, cut, case):
    """The port's in-core trainer against isle_tpu's on the same draws
    (tests/torch_parity.JaxDraws) at the cut: ζ, nnz(B) and original_cols
    exactly (docs dropped by the thresholds, by the drop flags' +inf, or
    by sampling), clusters and catchwords equal, the model within rtol
    1e-4, atol 1e-6."""
    sampled = case == "sample_docs"
    cfg = _config("default" if sampled else case, sampled)
    ref = JaxTrainer(cfg, output_dir=str(tmp_path / "jax"), quiet=True)
    ref.corpus = cut
    ref._post_ingest()
    ref.train()
    got = Trainer(cfg, output_dir=str(tmp_path / "torch"), quiet=True,
                  gpu=CPU, draws=JaxDraws(cfg.seed))
    got.load_corpus(cut)
    got.train()
    ours, theirs = _svd(got), _svd(ref)
    assert ours["zetas"].tobytes() == theirs["zetas"].tobytes()
    finite = np.isfinite(ours["zetas"])
    assert (ours["zetas"][finite] > 1).sum() >= 1
    np.testing.assert_array_equal(got.original_cols, ref.original_cols)
    assert len(got.original_cols) < cut.num_docs  # a doc was dropped
    (nnz, cols), (jnnz, jcols) = _b_builds(cut, ours["zetas"], cfg)
    assert nnz == jnnz
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_array_equal(cols, got.original_cols)
    np.testing.assert_array_equal(got.cluster_of_doc, ref.cluster_of_doc)
    for a, b in zip(got.catchwords, ref.catchwords):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.evalues, ref.evalues, rtol=1e-4)
    np.testing.assert_allclose(got.model, ref.model, rtol=1e-4, atol=1e-6)


def test_cut_resident_run_is_uint16_and_equals_in_core(tmp_path, cut):
    """The largest count is BITE_MAX_COUNT: the resident loader keeps the
    counts as uint16, its chunks' values equal the corpus's bit for bit,
    and the streamed run on it ends where the in-core run ends (ζ,
    original_cols, B, clusters, catchwords; the model within 1e-6)."""
    cfg = _config()
    assert streaming.counts_dtype(cut) == np.uint16
    st = streaming.StreamedTrainer(cfg, output_dir=str(tmp_path / "st"),
                                   chunk_entries=256, gpu=CPU)
    st.load_corpus(cut)
    st.train()
    loader = st.loader
    assert isinstance(loader, streaming.ResidentLoader)
    assert loader.count_dtype == np.uint16 and loader.fill_count == 1
    assert len(loader.ranges) > 3
    vals = np.concatenate([v.numpy() for _, _, _, v, _ in loader.chunks()])
    assert vals.view(np.int32).tobytes() == cut.vals.view(np.int32).tobytes()
    ic = Trainer(cfg, output_dir=str(tmp_path / "ic"), quiet=True, gpu=CPU)
    ic.load_corpus(cut)
    ic.train()
    ours, theirs = _svd(st), _svd(ic)
    for key in ("zetas", "original_cols"):
        np.testing.assert_array_equal(ours[key], theirs[key])
    z = torch.from_numpy(ours["zetas"])
    B, cols = streaming.streamed_build_b(cut, z, None, loader)
    IB, icols = bmatrix.threshold_and_copy(DocSparse.from_corpus(cut, "cpu"),
                                           z)
    np.testing.assert_array_equal(cols, icols)
    for f in ("d_word", "d_doc", "d_val", "w_word", "w_doc", "w_val"):
        assert torch.equal(getattr(B, f), getattr(IB, f)), f
    np.testing.assert_array_equal(st.cluster_of_doc, ic.cluster_of_doc)
    for a, b in zip(st.catchwords, ic.catchwords):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(st.model, ic.model, rtol=0, atol=1e-6)


def _chain_drift(v: np.float32, longest: int, batch: int) -> float:
    """The largest relative drift from the exact sum over runs of 1 to
    `longest` copies of v, summed in float32 chains of at most `batch`
    adds whose sums are then added in order (csrc/segsum.cu's wide
    gather kernel: a chain a staged batch)."""
    worst, chain, part = 0.0, np.float32(0), np.float32(0)
    for m in range(1, longest + 1):
        chain = np.float32(chain + v)
        if m % batch == 0:
            part, chain = np.float32(part + chain), np.float32(0)
        exact = float(v) * m
        worst = max(worst, abs(float(np.float32(part + chain)) - exact) / exact)
    return worst


def test_equal_runs_drift_in_one_chain_but_not_in_batches():
    """Why the wide gather kernel sums a run in chains of a staged batch
    (kStage = 128 entries): on the bite corpus a word's run in B holds up
    to 2,048 entries of one value, sqrt(ζ), and B onehot sums them. One
    float32 chain of such a run drifts past the 1e-5 the kernel is held to
    (chip_smoke.py, against float64); chains of 128 stay 5x inside it."""
    values = [np.float32(np.sqrt(np.float32(z)))
              for z in (2, 3, 5, 6, 7, 8, 10, 11, 12, 13, 708)]
    one_chain = max(_chain_drift(v, 2_048, 2_048) for v in values)
    batched = max(_chain_drift(v, 2_048, 128) for v in values)
    assert one_chain > 1e-5
    assert batched < 2e-6
