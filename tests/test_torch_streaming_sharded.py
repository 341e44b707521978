"""Out-of-core training over several ranks (isle_tpu_torch.streaming_sharded)
on gloo at world sizes 1, 2 and 4, against isle_tpu's sharded streamed
trainer on the forced host devices of tests/conftest.py, against the
port's single-device StreamedTrainer and against its in-core sharded
Trainer. Modelled on tests/test_torch_sharded_trainer.py: one spawn per
world size, every rank runs the jobs below through
tests/torch_dist_worker.py, and the reference's draws reach the ranks as
recorded arrays.

original_cols, clusters, catchword sets and top-two topics are equal
exactly; eigenvalues within rtol 1e-3, centers within rtol 1e-4 / atol
1e-5, the model and the edge model within rtol 1e-4 / atol 1e-6. The
stages are held exactly against their in-core sharded counterparts: ζ and
each rank's B against sharded_threshold_and_copy, each rank's word shard
of the clustered docs against shard_by_word, the mass rows against
doc_topic_mass, and the distributed rank selection against
model_thresholds on the gathered mass."""

import dataclasses
import math
import os
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isle_tpu import topic_model as jax_topic_model
from isle_tpu.config import HyperParams as JaxHyperParams
from isle_tpu.config import TrainConfig as JaxTrainConfig
from isle_tpu.corpus import Corpus as JaxCorpus
from isle_tpu.streaming import StreamedTrainer as JaxStreamedTrainer
from isle_tpu_torch import sharding, streaming, streaming_sharded
from isle_tpu_torch.config import GpuConfig, HyperParams, TrainConfig
from isle_tpu_torch.corpus import Corpus
from isle_tpu_torch.sharding import Mesh
from isle_tpu_torch.streaming import StreamedTrainer
from isle_tpu_torch.topic_model import model_thresholds, top_two_topics
from test_torch_sharded_trainer import CORPORA as TRAIN_CORPORA
from torch_dist_worker import load_rank, run_ranks
from torch_parity import HEAD_BYTES, REFERENCE_TPU, REFERENCE_TPU_HYBRID, \
    JaxDraws

WORLDS = [1, 2, 4]
CPU = GpuConfig(device="cpu", dense_head_bytes=0)  # as REFERENCE_TPU
COO = dict(dense_head_bytes=0)
HYBRID = dict(dense_head_bytes=HEAD_BYTES)
# the base job with the hybrid layout at a partial head (ShardedHybrid),
# streamed and in core, at these world sizes
HYBRID_WORLDS = [1, 2]
K, SEED, BLK = 4, 5, 8
EDGE = dict(compute_edge_topics=True, max_edge_topics=6)
CHUNK = 400  # entries: 20-21 chunks of a corpus at world size 1
RATE = 0.5


def _few_entries():
    """Five docs: at world size 4 (dps 2) the last rank holds none."""
    rng = np.random.default_rng(7)
    docs, words, counts = [], [], []
    for d in range(5):
        ws = np.unique(rng.integers(0, 30, 9))
        docs += [d] * len(ws)
        words += ws.tolist()
        counts += rng.integers(1, 5, len(ws)).tolist()
    return np.array(docs), np.array(words), np.array(counts)


CORPORA = dict(TRAIN_CORPORA, few=(_few_entries(), 30, 5))

# name: (corpus, TrainConfig fields), each trained streamed and in core
JOBS = {
    "base": ("synth", EDGE),
    "sampled": ("synth", dict(EDGE, sample_docs=True, sample_rate=RATE)),
    # thresholds bite, and the last rank of four keeps no doc of B
    "biting": ("biting", EDGE),
}


def _config(name, jax=False):
    corpus_name, cfg_kw = JOBS[name]
    if jax:
        return JaxTrainConfig(
            num_topics=K, seed=SEED,
            tpu=dataclasses.replace(REFERENCE_TPU, mesh_shape=(4,)),
            hyper=JaxHyperParams(block_ks_block_size=BLK), **cfg_kw)
    return TrainConfig(num_topics=K, seed=SEED,
                       hyper=HyperParams(block_ks_block_size=BLK), **cfg_kw)


def _corpus(corpus_name, jax=False):
    (d, w, c), V, D = CORPORA[corpus_name]
    cls = JaxCorpus if jax else Corpus
    return cls.from_entries(d, w, c, vocab_size=V, num_docs=D)


def _draws(name):
    return JaxDraws(SEED, streamed_sampling="sample_docs" in JOBS[name][1])


def _record_draws(path, name, V, D, docs_in_b, rounds=64):
    """What _draws(name) hands the default path, as arrays; the seeding
    draws its first center among the `docs_in_b` docs of B."""
    draws = _draws(name)
    nb_max = 1 + int(math.ceil(math.sqrt(max(K - 5, 1)))) + 1
    first = draws.seeding_first(docs_in_b)
    np.savez(
        path,
        doc_sample_uniforms=draws.doc_sample_uniforms(D).numpy(),
        krylov_start=draws.krylov_start(V, BLK).numpy(),
        seeding_first=np.array([first]),
        seeding_docs=np.array([docs_in_b]),
        uniform=np.stack([draws.uniform(nb_max).numpy()
                          for _ in range(rounds)])[None],
    )


def _streamed(name, out, draws="jax", resume=False, mesh=None):
    if draws == "jax":
        draws = _draws(name)
    st = StreamedTrainer(_config(name), output_dir=str(out),
                         chunk_entries=CHUNK, gpu=CPU, draws=draws,
                         mesh=mesh)
    st.load_corpus(_corpus(JOBS[name][0]))
    st.train(resume=resume)
    st.train_edge_topics()
    return st


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("streaming_sharded")
    for name, ((d, w, c), V, D) in CORPORA.items():
        np.savez(tmp / f"{name}.npz", docs=d, words=w, counts=c, vocab=V,
                 num_docs=D)
    return tmp


@pytest.fixture(scope="module")
def single(tmp):
    """The port's single-device StreamedTrainer on every job, the
    reference's draws fed in."""
    return {name: _streamed(name, tmp / "single" / name) for name in JOBS}


def _jax_streamed(tmp, name, cfg, tag=""):
    tr = JaxStreamedTrainer(cfg, output_dir=str(tmp / "jax" / (name + tag)),
                            chunk_entries=1024)
    tr._t.corpus = _corpus(JOBS[name][0], jax=True)
    tr._t._post_ingest()
    tr.train()
    tr.train_edge_topics()
    return tr


@pytest.fixture(scope="module")
def jax_runs(tmp):
    """isle_tpu's StreamedTrainer on a mesh of four host devices."""
    return {name: _jax_streamed(tmp, name, _config(name, jax=True))
            for name in JOBS}


@pytest.fixture(scope="module")
def jax_hybrid(tmp):
    """isle_tpu's StreamedTrainer with its hybrid layout on a mesh of two
    host devices (the port's two ranks choose the same head)."""
    cfg = dataclasses.replace(
        _config("base", jax=True),
        tpu=dataclasses.replace(REFERENCE_TPU_HYBRID, mesh_shape=(2,)))
    return _jax_streamed(tmp, "base", cfg, "_hybrid")


def _train_job(tmp, world, name, job_name=None, streamed=True, gpu=COO,
               **extra):
    corpus_name, cfg_kw = JOBS[name]
    job_name = job_name or name
    job = dict(
        kind="train", name=job_name, corpus=str(tmp / f"{corpus_name}.npz"),
        draws=str(tmp / f"{name}_draws.npz"), k=K, seed=SEED, cfg=cfg_kw,
        hyper=dict(block_ks_block_size=BLK), gpu=gpu,
        out_dir=str(tmp / f"world{world}" / job_name), **extra)
    if streamed:
        job["chunk_entries"] = CHUNK
    return job


# the resident loader's cases, at these world sizes: the wire run
# (resident_corpus_bytes=0), a budget that every rank's slab but the
# largest fits (every rank streams over the wire), slabs that the plan
# releases (hbm_bytes=1: two fills) and an out-of-memory error in the
# middle on every rank (one retry, one eigensolve)
RESIDENT_WORLDS = [1, 2]


def _slab_bytes(corpus_name, world):
    """Each rank's ResidentLoader.resident_bytes at `world` ranks."""
    corpus = _corpus(corpus_name)
    form = streaming.counts_dtype(corpus)
    D = corpus.num_docs
    dps = -(-D // world)
    return [streaming.ResidentLoader.resident_bytes(
        corpus, CHUNK, form, (min(r * dps, D), min((r + 1) * dps, D)))
        for r in range(world)]


def _resident_jobs(tmp, world):
    slabs = _slab_bytes("synth", world)
    assert len(set(slabs)) == world  # the ranks' slabs differ
    return [
        _train_job(tmp, world, "base", "base_wire",
                   gpu=dict(COO, resident_corpus_bytes=0)),
        _train_job(tmp, world, "base", "base_largest_over",
                   gpu=dict(COO, resident_corpus_bytes=max(slabs) - 1)),
        _train_job(tmp, world, "base", "base_largest_fits",
                   gpu=dict(COO, resident_corpus_bytes=max(slabs))),
        _train_job(tmp, world, "base", "hybrid_released",
                   gpu=dict(HYBRID, hbm_bytes=1)),
        _train_job(tmp, world, "base", "base_oom", oom_once=True),
    ]


def _seed_checkpoints(src_run_dir, job, stages):
    run_dir = os.path.join(job["out_dir"], _config("base").log_dir_name())
    os.makedirs(run_dir, exist_ok=True)
    for stage in stages:
        shutil.copy(os.path.join(src_run_dir, f"ckpt_{stage}.npz"), run_dir)


def _stage_inputs(path, corpus_name):
    (_, _, _), V, D = CORPORA[corpus_name]
    rng = np.random.default_rng(11)
    cw_topic = np.full(V, -1, np.int32)
    cw_topic[rng.choice(V, size=V // 3, replace=False)] = rng.integers(
        0, K, V // 3)
    cw_topic[cw_topic == 3] = -1  # topic 3 owns no catchword
    np.savez(
        path,
        uniforms=rng.random(D, dtype=np.float32),
        cluster_of_doc=rng.integers(-1, K, D).astype(np.int32),
        cw_topic=cw_topic,
        W=rng.random((D, K)).astype(np.float32),
        crafted_mass=CRAFTED_MASS, crafted_has_cw=CRAFTED_HAS_CW,
    )


def _crafted_mass():
    """(30, 6) masses: topic 0 full of ties, topic 1 half exact zeros,
    topic 2 three positives, topic 3 gated (no catchwords), topic 4 all
    zero, topic 5 distinct values of every magnitude."""
    rng = np.random.default_rng(3)
    m = np.zeros((30, 6), np.float32)
    m[:, 0] = rng.choice(np.float32([0.25, 0.5, 1.5]), 30)
    m[::2, 1] = rng.random(15, dtype=np.float32)
    m[[4, 17, 28], 2] = np.float32([2.0, 3.0, 2.0])
    m[:, 3] = rng.random(30, dtype=np.float32) + 1.0
    m[:, 5] = (rng.random(30) * 10.0 ** rng.integers(-30, 30, 30)).astype(
        np.float32)
    return m


CRAFTED_MASS = _crafted_mass()
CRAFTED_HAS_CW = np.array([True, True, True, False, True, True])
CRAFTED_RANKS = [0, 1, 2, 3, 4, 7, 15, 16, 29, 30, 31]
STAGE_CORPORA = ["synth", "biting", "few"]


def _stage_job(tmp, corpus_name):
    inputs = tmp / f"{corpus_name}_stage_inputs.npz"
    _stage_inputs(inputs, corpus_name)
    D = CORPORA[corpus_name][2]
    return dict(
        kind="streamed_stages", name=f"stages_{corpus_name}",
        corpus=str(tmp / f"{corpus_name}.npz"), inputs=str(inputs), k=K,
        chunk_entries=CHUNK if D > 5 else 16, sample_rate=RATE,
        ranks=[0, 1, 2, 5, D // 3, D, D + 1],
        crafted_ranks=CRAFTED_RANKS)


@pytest.fixture(scope="module")
def runs(tmp, single):
    """{world: {job: [each rank's results]}}. The resumed jobs start from
    the single-device streamed run's checkpoints."""
    for name, st in single.items():
        _, V, D = CORPORA[JOBS[name][0]]
        _record_draws(tmp / f"{name}_draws.npz", name, V, D,
                      len(st.original_cols))
    out = {}
    for world in WORLDS:
        jobs = [_train_job(tmp, world, name) for name in JOBS]
        jobs += [_train_job(tmp, world, name, name + "_incore",
                            streamed=False) for name in JOBS]
        jobs.append(_train_job(tmp, world, "base", "base_again"))
        if world in RESIDENT_WORLDS:
            jobs += _resident_jobs(tmp, world)
        if world in HYBRID_WORLDS:
            jobs += [_train_job(tmp, world, "base", "hybrid" + tag,
                                streamed=not tag, gpu=HYBRID)
                     for tag in ("", "_incore")]
        for stages in (("svd",), ("svd", "kmeans")):
            job = _train_job(tmp, world, "base", "resume_" + stages[-1],
                             resume=True)
            _seed_checkpoints(single["base"].run_dir, job, stages)
            jobs.append(job)
        jobs += [_stage_job(tmp, c) for c in STAGE_CORPORA]
        odir = str(tmp / f"out{world}")
        results = run_ranks(world, jobs, odir, limit=400)
        for rank, (code, log) in enumerate(results):
            assert code == 0, f"world {world} rank {rank}: {code}\n{log}"
        out[world] = {j["name"]: [load_rank(odir, j["name"], r)
                                  for r in range(world)] for j in jobs}
    return out


def _catchwords(tr):
    is_cw = np.zeros((K, tr.corpus.vocab_size), bool)
    for t, words in enumerate(tr.catchwords):
        is_cw[t, words] = True
    return is_cw


def _assert_same(r, tr):
    """A rank's results `r` against a trainer `tr` (the port's or
    isle_tpu's)."""
    np.testing.assert_array_equal(r["original_cols"], tr.original_cols)
    np.testing.assert_array_equal(r["cluster_of_doc"], tr.cluster_of_doc)
    np.testing.assert_array_equal(r["is_cw"], _catchwords(tr))
    for key, want in zip(("t1", "t2", "valid"), tr.top_pairs):
        np.testing.assert_array_equal(r[key], np.asarray(want), key)
    np.testing.assert_allclose(r["evalues"], tr.evalues, rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(r["centers"], tr.centers, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(r["model"], tr.model, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(r["edge_pairs"], tr.edge_pairs)
    np.testing.assert_allclose(r["edge_model"], tr.edge_model, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(JOBS))
@pytest.mark.parametrize("world", WORLDS)
def test_matches_isle_tpu_sharded_streamed_trainer(runs, jax_runs, world,
                                                   name):
    _assert_same(runs[world][name][0], jax_runs[name])


@pytest.mark.parametrize("name", sorted(JOBS))
@pytest.mark.parametrize("world", WORLDS)
def test_matches_the_single_device_streamed_trainer(runs, single, world,
                                                    name):
    _assert_same(runs[world][name][0], single[name])


@pytest.mark.parametrize("name", sorted(JOBS))
@pytest.mark.parametrize("world", WORLDS)
def test_matches_the_incore_sharded_trainer(runs, world, name):
    """The in-core sharded Trainer at the same world size, with the same
    draws: the same run, A on the ranks' devices instead of streamed."""
    got, want = runs[world][name][0], runs[world][name + "_incore"][0]
    for key in ("original_cols", "cluster_of_doc", "is_cw", "t1", "t2",
                "valid", "edge_pairs"):
        np.testing.assert_array_equal(got[key], want[key], key)
    for key, rtol, atol in (("evalues", 1e-3, 1e-4), ("centers", 1e-4, 1e-5),
                            ("model", 1e-4, 1e-6),
                            ("edge_model", 1e-4, 1e-6)):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("world", HYBRID_WORLDS)
def test_hybrid_matches_the_incore_sharded_hybrid(runs, world):
    """The hybrid layout of the streamed B on the mesh
    (Trainer._sharded_middle's shard_hybrid): the in-core sharded hybrid
    run at the same world size, exactly where the COO case is exact."""
    got, want = runs[world]["hybrid"][0], runs[world]["hybrid_incore"][0]
    assert "hybrid layout (sharded)" in list(got["stages"])
    assert "hybrid layout (sharded)" in list(want["stages"])
    for key in ("original_cols", "cluster_of_doc", "is_cw", "t1", "t2",
                "valid", "edge_pairs"):
        np.testing.assert_array_equal(got[key], want[key], key)
    for key, rtol, atol in (("evalues", 1e-3, 1e-4), ("centers", 1e-4, 1e-5),
                            ("model", 1e-4, 1e-6),
                            ("edge_model", 1e-4, 1e-6)):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=atol, err_msg=key)


def test_hybrid_matches_isle_tpu_sharded_streamed_hybrid(runs, jax_hybrid):
    """World size 2 against isle_tpu's sharded streamed trainer with its
    hybrid layout on two devices: the results, and both name the layout's
    stage alike."""
    r = runs[2]["hybrid"][0]
    _assert_same(r, jax_hybrid)
    label = "hybrid layout (sharded)"
    assert label in [name for name, *_ in jax_hybrid.timer.phases]
    assert label in list(r["stages"])


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_ends_with_the_same_bits(runs, world):
    """k- and vocab-sized state is replicated: each rank holds exactly
    rank 0's results (the loader each took and its fills among them), and
    rank 0 alone holds the run directory's files."""
    names = list(JOBS) + ["resume_svd", "resume_kmeans"]
    if world in HYBRID_WORLDS:
        names.append("hybrid")
    if world in RESIDENT_WORLDS:
        names += [j["name"] for j in _resident_jobs(pathlib.Path("."),
                                                    world)]
    for name in names:
        rs = runs[world][name]
        assert rs[0]["holds_log_files"], name
        for r in rs[1:]:
            assert not r["holds_log_files"], name
            assert int(r["collective_calls"]) == int(
                rs[0]["collective_calls"])
            for key in rs[0]:
                if key not in ("holds_log_files", "collective_calls"):
                    np.testing.assert_array_equal(r[key], rs[0][key],
                                                  f"{name}: {key}")


@pytest.mark.parametrize("world", WORLDS)
def test_two_runs_at_one_world_size_are_bit_equal(runs, world):
    a, b = runs[world]["base"][0], runs[world]["base_again"][0]
    for key in a:
        if key != "collective_calls":
            np.testing.assert_array_equal(a[key], b[key], key)


@pytest.mark.parametrize("stage", ["svd", "kmeans"])
@pytest.mark.parametrize("world", WORLDS)
def test_resumes_from_single_device_streamed_checkpoints(runs, single,
                                                         world, stage):
    """Any world size resumes from a single-device streamed run: after
    `stage` the run ends where that run ended, and it skipped the stages
    before."""
    r = runs[world]["resume_" + stage][0]
    _assert_same(r, single["base"])
    stages = list(r["stages"])
    assert "streamed thresholds (sharded)" not in stages
    assert "eigen solve (B B^T, sharded)" not in stages
    assert ("k-means (sharded)" in stages) == (stage == "svd")
    assert ("streamed B construction (sharded)" in stages) == (stage == "svd")
    assert "streamed topic model (sharded)" in stages


def test_single_device_resumes_from_sharded_streamed_checkpoints(tmp, runs):
    src = tmp / "world4" / "base" / _config("base").log_dir_name()
    for stage in ("svd", "kmeans", "model"):
        assert (src / f"ckpt_{stage}.npz").exists(), stage
    out = tmp / "back_to_one"
    run_dir = out / _config("base").log_dir_name()
    os.makedirs(run_dir)
    for stage in ("svd", "kmeans"):
        shutil.copy(src / f"ckpt_{stage}.npz", run_dir)
    st = _streamed("base", out, draws=None, resume=True)
    assert [s for s, *_ in st.timer.phases][:2] == [
        "streamed catchwords", "streamed topic model"]
    _assert_same(runs[4]["base"][0], st)


@pytest.mark.parametrize("world", WORLDS)
def test_stage_labels_are_the_references(runs, jax_runs, world):
    """isle_tpu's labels, its resident corpus fill among them: a default
    run fills each rank's slabs as isle_tpu's does."""
    for name in JOBS:
        want = [label for label, *_ in jax_runs[name].timer.phases
                if "edge" not in label]
        assert want[0] == "sharded resident corpus fill"
        got = [s for s in runs[world][name][0]["stages"] if "edge" not in s]
        assert got == want, name
        assert bool(runs[world][name][0]["resident"])


def _bit_equal_runs(got, want, label):
    for key in want:
        if key not in ("collective_calls", "stages", "resident",
                       "fill_count", "solves", "lloyds"):
            np.testing.assert_array_equal(got[key], want[key],
                                          f"{label}: {key}")


@pytest.mark.parametrize("world", RESIDENT_WORLDS)
def test_resident_runs_equal_the_wire_run(runs, world):
    """On the resident loader (each rank's own range, filled once) the
    sharded streamed run ends bit for bit where the wire run ends; a
    budget that the largest rank's slab exceeds sends every rank over the
    wire, one that it fits keeps every rank resident."""
    r = runs[world]
    wire = r["base_wire"][0]
    assert not wire["resident"]
    assert "sharded resident corpus fill" not in list(wire["stages"])
    for name, resident in (("base", True), ("base_largest_fits", True),
                           ("base_largest_over", False)):
        for rank in r[name]:
            assert bool(rank["resident"]) == resident, name
            assert int(rank["fill_count"]) == int(resident), name
        _bit_equal_runs(r[name][0], wire, name)


@pytest.mark.parametrize("world", RESIDENT_WORLDS)
def test_released_slabs_refill_for_the_finish(runs, world):
    """hbm_bytes too small for the middle beside the slabs: every rank
    releases them before the middle and fills them again for the finish
    passes, and the run ends where the held hybrid run ends."""
    r = runs[world]["hybrid_released"]
    for rank in r:
        assert int(rank["fill_count"]) == 2
    if world in HYBRID_WORLDS:
        _bit_equal_runs(r[0], runs[world]["hybrid"][0], "released")


@pytest.mark.parametrize("world", RESIDENT_WORLDS)
def test_out_of_memory_in_the_middle_retries_once(runs, world):
    """An out-of-memory error in the full-space Lloyd's on every rank:
    the slabs are released, the middle runs once more without solving
    again, and the run ends where the uninterrupted run ends."""
    for rank in runs[world]["base_oom"]:
        assert (int(rank["solves"]), int(rank["lloyds"])) == (1, 2)
        assert int(rank["fill_count"]) == 2
    _bit_equal_runs(runs[world]["base_oom"][0], runs[world]["base"][0],
                    "retried")


@pytest.mark.parametrize("world", WORLDS)
def test_thresholds_bite_and_a_rank_keeps_no_doc_of_b(runs, single, world):
    st = single["biting"]
    assert st.original_cols.max() < 300 < st.corpus.num_docs
    r = runs[world]["biting"][0]
    assert (r["cluster_of_doc"][300:] == -1).all()
    with np.load(os.path.join(st.run_dir, "ckpt_svd.npz")) as z:
        assert z["zetas"].max() > 5


# ---------------------------------------------------------------------------
# Stages, on the ranks' chunks, against their in-core sharded counterparts
# ---------------------------------------------------------------------------


def _stage_ranks(runs, world, corpus_name):
    return runs[world][f"stages_{corpus_name}"]


@pytest.mark.parametrize("corpus_name", STAGE_CORPORA)
@pytest.mark.parametrize("world", WORLDS)
def test_doc_range_chunks(runs, world, corpus_name):
    """Each rank's loader covers its own range [r*dps, (r+1)*dps) in
    doc-aligned chunks of at most chunk_entries, and the ranges of all
    ranks cover the corpus once."""
    corpus = _corpus(corpus_name)
    off = corpus.offsets
    D = corpus.num_docs
    dps = -(-D // world)
    ends = []
    for rank, r in enumerate(_stage_ranks(runs, world, corpus_name)):
        lo, hi = r["doc_range"]
        assert (lo, hi) == (min(rank * dps, D), min((rank + 1) * dps, D))
        ranges = [tuple(x) for x in r["ranges"]]
        assert ranges == list(streaming.doc_chunks(
            corpus, CHUNK if D > 5 else 16, (lo, hi)))
        if ranges:
            assert ranges[0][0] == lo and ranges[-1][1] == hi
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        ends.append((lo, hi))
    assert ends[0][0] == 0 and ends[-1][1] == D
    if corpus_name == "few" and world == 4:
        assert ends[-1] == (5, 5)  # a rank that holds no doc of A


@pytest.mark.parametrize("corpus_name", STAGE_CORPORA)
@pytest.mark.parametrize("world", WORLDS)
def test_each_pass_calls_the_kernels_once_a_chunk(runs, world, corpus_name):
    """(segsum_onehot, segsum_gather_rows) calls of each streamed pass of
    a rank: one a chunk of its own range, none for the B passes and the
    filter."""
    for r in _stage_ranks(runs, world, corpus_name):
        n = len(r["ranges"])
        want = {"thresholds": (n, 0), "weights": (n, 0), "B": (0, 0),
                "Bs": (0, 0), "filter": (0, 0), "mass": (n, 0),
                "model": (0, n)}
        for label, calls in want.items():
            assert tuple(r["calls_" + label]) == calls, label


@pytest.mark.parametrize("corpus_name", STAGE_CORPORA)
@pytest.mark.parametrize("world", WORLDS)
def test_zetas_and_b_equal_the_incore_sharded_stages(runs, world,
                                                     corpus_name):
    """ζ (one all-reduce of the histogram) equals the word-sharded ζ and
    the single-device streamed ζ; every rank's B, in both sort orders,
    with and without sampling, equals sharded_threshold_and_copy's."""
    corpus = _corpus(corpus_name)
    z, nnz = streaming.streamed_thresholds(
        corpus, K, HyperParams(), streaming.ChunkLoader(corpus, 1 << 20,
                                                        "cpu"))
    for r in _stage_ranks(runs, world, corpus_name):
        np.testing.assert_array_equal(r["zetas"], z.numpy())
        np.testing.assert_array_equal(r["zetas"], r["zetas_incore"])
        assert int(r["new_nnz"]) == int(r["new_nnz_incore"]) == nnz
        for tag in ("B", "Bs"):
            for f in ("d_word", "d_doc", "d_val", "w_word", "w_doc",
                      "w_val", "cols", "meta", "counts"):
                np.testing.assert_array_equal(
                    r[f"{tag}_{f}"], r[f"I{tag}_{f}"], f"{tag}: {f}")


@pytest.mark.parametrize("corpus_name", STAGE_CORPORA)
@pytest.mark.parametrize("world", WORLDS)
def test_clustered_filter_equals_shard_by_word(tmp, runs, world,
                                              corpus_name):
    """The word shard each rank receives by the all-to-all equals what
    shard_by_word cuts for that rank from the whole filtered matrix."""
    corpus = _corpus(corpus_name)
    with np.load(tmp / f"{corpus_name}_stage_inputs.npz") as z:
        cluster = z["cluster_of_doc"]
    docs = corpus.doc_ids()
    keep = cluster[docs] >= 0
    for rank, r in enumerate(_stage_ranks(runs, world, corpus_name)):
        want = sharding.shard_by_word(
            corpus.rows[keep], docs[keep], corpus.vals[keep],
            corpus.vocab_size, corpus.num_docs, Mesh("cpu", None, rank, world))
        np.testing.assert_array_equal(r["sub_word"], want.w_word.numpy())
        np.testing.assert_array_equal(r["sub_doc"], want.w_doc.numpy())
        np.testing.assert_array_equal(r["sub_val"], want.w_val.numpy())
        assert int(r["sub_vocab"]) == want.vocab
        assert tuple(r["sub_bounds"]) == want.word_bounds
        assert int(r["sub_nnz"]) == want.nnz == int(keep.sum())
        assert int(r["sub_num_docs"]) == want.num_docs


@pytest.mark.parametrize("corpus_name", STAGE_CORPORA)
@pytest.mark.parametrize("world", WORLDS)
def test_mass_rows_and_model(runs, world, corpus_name):
    """Each rank's (D_r, k) mass equals doc_topic_mass of its in-core doc
    shard exactly; the gathered top-two topics equal top_two_topics of the
    gathered mass; the model equals the in-core sharded B W."""
    rs = _stage_ranks(runs, world, corpus_name)
    for r in rs:
        np.testing.assert_array_equal(r["mass"], r["mass_incore"])
        np.testing.assert_allclose(r["model"], r["model_incore"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(r["model"], rs[0]["model"])
    mass = np.concatenate([r["mass"] for r in rs])
    assert mass.shape == (CORPORA[corpus_name][2], K)
    for key, want in zip(("t1", "t2", "valid"),
                         top_two_topics(torch.from_numpy(mass))):
        for r in rs:
            np.testing.assert_array_equal(r[key], want.numpy(), key)


@pytest.mark.parametrize("corpus_name", STAGE_CORPORA)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_model_thresholds_are_exact(tmp, runs, world,
                                            corpus_name):
    """The bitwise search with all-reduced counts, on each rank's share
    of the mass, equals model_thresholds and isle_tpu's model_thresholds
    on the gathered mass, exactly, for every rank r: on the corpus's mass
    (topic 3 gated) and on crafted masses with ties, exact zeros, a topic
    short of r positives, a gated topic and an all-zero topic."""
    rs = _stage_ranks(runs, world, corpus_name)
    with np.load(tmp / f"{corpus_name}_stage_inputs.npz") as z:
        cw_topic = z["cw_topic"]
    has_cw = np.bincount(cw_topic[cw_topic >= 0], minlength=K)[:K] > 0
    assert not has_cw[3] and has_cw[:3].all()
    mass = np.concatenate([r["mass"] for r in rs])
    D = mass.shape[0]
    cases = [(mass, has_cw, "thr_", [0, 1, 2, 5, D // 3, D, D + 1]),
             (CRAFTED_MASS, CRAFTED_HAS_CW, "crafted_thr_", CRAFTED_RANKS)]
    for m, cw, prefix, ranks in cases:
        for r_thr in ranks:
            want = model_thresholds(torch.from_numpy(m),
                                    torch.from_numpy(cw), r_thr).numpy()
            ref = np.asarray(jax_topic_model.model_thresholds(
                jnp.asarray(m), jnp.asarray(cw), r_thr))
            np.testing.assert_array_equal(want, ref)
            for r in rs:
                np.testing.assert_array_equal(r[f"{prefix}{r_thr}"], want,
                                              f"{prefix}{r_thr}")
    # the crafted cases reach every gate
    thr7 = rs[0]["crafted_thr_7"]
    assert thr7[0] > 0 and thr7[2] == 0 and thr7[3] == 0 and thr7[4] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_all_to_all_rows_is_ragged(runs, world):
    """Rank r sends (r + j) % 3 rows to rank j (none at times): each rank
    receives its slice of every rank's rows, in rank order."""
    rs = _stage_ranks(runs, world, "few")
    for j, r in enumerate(rs):
        want = []
        for src, s in enumerate(rs):
            send = [(src + i) % 3 for i in range(world)]
            a = sum(send[:j])
            want.append(s["a2a_sent"][a:a + send[j]] + 1000 * src)
        np.testing.assert_array_equal(r["a2a_got"], np.concatenate(want))


# ---------------------------------------------------------------------------
# In one process
# ---------------------------------------------------------------------------


def test_group_less_mesh_streams_in_process(tmp, single):
    """A world of one without a process group takes the sharded streamed
    path with every collective the identity: the single-device streamed
    result, bit for bit, with the reference's labels."""
    mesh = Mesh("cpu")
    st = _streamed("base", tmp / "groupless", mesh=mesh)
    ref = single["base"]
    assert [s for s, *_ in st.timer.phases][:2] == [
        "sharded resident corpus fill", "streamed thresholds (sharded)"]
    for f in ("original_cols", "cluster_of_doc", "evalues", "centers",
              "model", "edge_model"):
        np.testing.assert_array_equal(getattr(st, f), getattr(ref, f), f)
    assert mesh.collective_calls == 0
    assert st.loader.doc_range == (0, st.corpus.num_docs)


def test_report_streams_the_whole_corpus_on_rank_zero(tmp, monkeypatch):
    """output_doc_topic after a sharded streamed run takes its mass from a
    loader over every doc and calls no collective: rank 0 writes it
    alone. Here a mesh of one rank of two (no group): its training range
    is half the corpus, its report the whole of it."""
    from isle_tpu_torch.trainer import Trainer

    st = _streamed("base", tmp / "report_ref", mesh=Mesh("cpu"))
    st.output_doc_topic()
    ref = os.path.join(st.run_dir, "DocTopicCatchwordSums.tsv")
    half = StreamedTrainer(_config("base"), output_dir=str(tmp / "report"),
                           chunk_entries=CHUNK, gpu=CPU,
                           mesh=Mesh("cpu", None, 0, 2))
    half.load_corpus(_corpus("synth"))
    for name in ("catchwords", "is_training_complete", "cluster_of_doc"):
        setattr(half._t, name, getattr(st, name))
    half._chunk_loader(sharding.doc_range(half.corpus.num_docs, half.mesh))
    assert half.loader.doc_range == (0, 200)

    def no_upload(self):
        raise AssertionError("the report put all of A on the device")

    monkeypatch.setattr(Trainer, "_device_A", no_upload)
    calls = half.mesh.collective_calls
    half.output_doc_topic()
    assert half.loader.doc_range == (0, 400)
    assert half.mesh.collective_calls == calls
    with open(ref, "rb") as f, open(os.path.join(
            half.run_dir, "DocTopicCatchwordSums.tsv"), "rb") as g:
        assert f.read() == g.read()


def test_a_mesh_without_its_process_group_raises(tmp):
    """mesh_shape=(4,) with no process group: a RuntimeError naming it,
    never a single-device run."""
    st = StreamedTrainer(_config("base"), output_dir=str(tmp / "nogroup"),
                         gpu=GpuConfig(device="cpu", mesh_shape=(4,)))
    st.load_corpus(_corpus("synth"))
    with pytest.raises(RuntimeError, match="process group"):
        st.train()
    assert st.loader is None and not st.is_training_complete


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_word_bounds_of_counts_equal_word_bounds(shards):
    (d, w, c), V, D = CORPORA["biting"]
    counts = np.bincount(w, minlength=V)
    np.testing.assert_array_equal(
        sharding.word_bounds_of_counts(counts, shards),
        sharding.word_bounds(w, V, shards))
    np.testing.assert_array_equal(
        sharding.word_bounds_of_counts(np.zeros(V, np.int64), shards),
        sharding.word_bounds(np.zeros(0, np.int64), V, shards))


def test_sharded_model_thresholds_group_less_equals_model_thresholds():
    mesh = Mesh("cpu")
    m = torch.from_numpy(CRAFTED_MASS)
    cw = torch.from_numpy(CRAFTED_HAS_CW)
    for r in CRAFTED_RANKS:
        assert torch.equal(
            streaming_sharded.sharded_model_thresholds(m, cw, r, 30, mesh),
            model_thresholds(m, cw, r))
    assert mesh.collective_calls == 0
