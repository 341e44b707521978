"""The port's trainer and inferencer over gloo at world sizes 1, 2 and 4,
against isle_tpu's sharded trainer on the forced host devices of
tests/conftest.py and against the port's single-device trainer. Modelled
on tests/test_sharded_trainer.py.

One spawn per world size (a module-scoped fixture); every rank runs the
jobs below through tests/torch_dist_worker.py and writes its trainer's
results. The reference's draws reach the ranks as recorded arrays: this
process, which has jax, records what tests/torch_parity.JaxDraws draws for
the seed (the sampling uniforms, the Krylov start block, the seeding's
first center and its k-means++ dice) and a rank replays them.

original_cols, clusters, catchword sets and top-two topics are equal
exactly; eigenvalues within rtol 1e-3, centers within rtol 1e-4 / atol
1e-5, the model within rtol 1e-4 / atol 1e-6 (an all-reduce adds the
ranks' partial sums in another order than one device does). Two runs at
one world size are bit-equal, and every rank ends with rank 0's bits."""

import dataclasses
import math
import os
import shutil

import numpy as np
import pytest

from isle_tpu.config import HyperParams as JaxHyperParams
from isle_tpu.config import TrainConfig as JaxTrainConfig
from isle_tpu.corpus import Corpus as JaxCorpus
from isle_tpu.trainer import Trainer as JaxTrainer
from isle_tpu_torch.config import GpuConfig, HyperParams, InferConfig, \
    TrainConfig
from isle_tpu_torch.corpus import Corpus
from isle_tpu_torch.inferencer import Inferencer
from isle_tpu_torch.sharding import Mesh
from isle_tpu_torch.trainer import Trainer
from torch_cases import dead_tail_entries
from torch_dist_worker import load_rank, run_ranks
from torch_parity import REFERENCE_TPU, JaxDraws

WORLDS = [1, 2, 4]
CPU = GpuConfig(device="cpu")
K, SEED, BLK = 4, 5, 8
EDGE = dict(compute_edge_topics=True, max_edge_topics=6)
CKPTS = ("svd", "kmeans", "model")


def _synth_entries(rng, V, D, k, words_per_doc=24):
    """The corpus of tests/test_sharded_trainer.py."""
    block = V // k
    docs, words, counts = [], [], []
    for d in range(D):
        t = rng.integers(0, k)
        n_main = int(words_per_doc * 0.85)
        ws = np.concatenate([
            rng.integers(t * block, (t + 1) * block, n_main),
            rng.integers(0, V, words_per_doc - n_main),
        ])
        ws, cs = np.unique(ws, return_counts=True)
        docs.append(np.full(len(ws), d))
        words.append(ws)
        counts.append(cs)
    return np.concatenate(docs), np.concatenate(words), np.concatenate(counts)


CORPORA = {
    # name: (entries, vocab, docs)
    "synth": (_synth_entries(np.random.default_rng(3), 96, 400, K), 96, 400),
    # thresholds bite, and the last rank of four keeps no doc in B
    "biting": (dead_tail_entries(), 200, 400),
}

# name: (corpus, TrainConfig fields, HyperParams fields, infer too). The
# first four are also trained by isle_tpu's sharded trainer.
JOBS = {
    "base": ("synth", EDGE, {}, True),
    "sampled": ("synth", dict(sample_docs=True, sample_rate=0.5), {}, False),
    "elkans": ("synth", EDGE, dict(kmeans_algo_for_sparse="elkans"), False),
    "biting": ("biting", EDGE, {}, False),
    "seedcols": ("synth", {}, dict(enable_kmeans_on_lowd=False), False),
    "dense": ("biting", {}, dict(eigensolver="dense"), False),
}
JAX_JOBS = ["base", "sampled", "elkans", "biting"]


def _record_draws(path, V, D, docs_in_b, k, rounds=64):
    """What JaxDraws(SEED) hands the default path, as arrays; the seeding
    draws its first center among the `docs_in_b` docs of B."""
    draws = JaxDraws(SEED)
    nb_max = 1 + int(math.ceil(math.sqrt(max(k - 5, 1)))) + 1
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


def _port_config(name):
    _, cfg_kw, hyper, _ = JOBS[name]
    return TrainConfig(num_topics=K, seed=SEED,
                       hyper=HyperParams(block_ks_block_size=BLK, **hyper),
                       **cfg_kw)


def _port_corpus(name, **kw):
    (d, w, c), V, D = CORPORA[JOBS[name][0]]
    return Corpus.from_entries(d, w, c, vocab_size=V, num_docs=D, **kw)


def _finish(tr, corpus, resume=False):
    tr.load_corpus(corpus)
    tr.train(resume=resume)
    if tr.config.compute_edge_topics:
        tr.train_edge_topics()
    return tr


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_trainer")
    for name, ((d, w, c), V, D) in CORPORA.items():
        np.savez(tmp / f"{name}.npz", docs=d, words=w, counts=c, vocab=V,
                 num_docs=D)
    return tmp


@pytest.fixture(scope="module")
def single(tmp):
    """The port's single-device trainer on every job, the reference's
    draws fed in."""
    return {name: _finish(
        Trainer(_port_config(name), output_dir=str(tmp / "single" / name),
                quiet=True, gpu=CPU, draws=JaxDraws(SEED)),
        _port_corpus(name)) for name in JOBS}


@pytest.fixture(scope="module")
def jax_runs(tmp):
    """isle_tpu's sharded trainer on a mesh of four host devices."""
    out = {}
    tpu = dataclasses.replace(REFERENCE_TPU, mesh_shape=(4,))
    for name in JAX_JOBS:
        corpus_name, cfg_kw, hyper, _ = JOBS[name]
        (d, w, c), V, D = CORPORA[corpus_name]
        cfg = JaxTrainConfig(
            num_topics=K, seed=SEED, tpu=tpu,
            hyper=JaxHyperParams(block_ks_block_size=BLK, **hyper), **cfg_kw)
        tr = JaxTrainer(cfg, output_dir=str(tmp / "jax" / name), quiet=True)
        tr.corpus = JaxCorpus.from_entries(d, w, c, vocab_size=V, num_docs=D)
        tr._post_ingest()
        tr.train()
        if cfg.compute_edge_topics:
            tr.train_edge_topics()
        out[name] = tr
    return out


def _job(tmp, world, name, job_name=None, **extra):
    corpus_name, cfg_kw, hyper, infer = JOBS[name]
    job_name = job_name or name
    return dict(
        kind="train", name=job_name, corpus=str(tmp / f"{corpus_name}.npz"),
        draws=str(tmp / f"{name}_draws.npz"), k=K, seed=SEED,
        cfg=cfg_kw, hyper=dict(block_ks_block_size=BLK, **hyper),
        out_dir=str(tmp / f"world{world}" / job_name), infer=infer, **extra)


def _seed_checkpoints(src_run_dir, job, stages):
    """Put the `stages` checkpoints of a finished run where `job` will
    look for them."""
    run_dir = os.path.join(job["out_dir"], _port_config("base").log_dir_name())
    os.makedirs(run_dir, exist_ok=True)
    for stage in stages:
        shutil.copy(os.path.join(src_run_dir, f"ckpt_{stage}.npz"), run_dir)


@pytest.fixture(scope="module")
def runs(tmp, single):
    """{world: {job: [each rank's results]}}. A world's resumed jobs start
    from the checkpoints of ANOTHER world size: the single-device run's
    for world 1, then each world's from the world before it."""
    out = {}
    for name, tr in single.items():
        _, V, D = CORPORA[JOBS[name][0]]
        _record_draws(tmp / f"{name}_draws.npz", V, D,
                      len(tr.original_cols), K)
    ckpt_src = single["base"].run_dir
    for world in WORLDS:
        jobs = [_job(tmp, world, name) for name in JOBS]
        jobs.append(_job(tmp, world, "base", "base_again"))
        for stages in (("svd",), ("svd", "kmeans")):
            job = _job(tmp, world, "base", "resume_" + stages[-1],
                       resume=True)
            _seed_checkpoints(ckpt_src, job, stages)
            jobs.append(job)
        odir = str(tmp / f"out{world}")
        results = run_ranks(world, jobs, odir, limit=400)
        for rank, (code, log) in enumerate(results):
            assert code == 0, f"world {world} rank {rank}: {code}\n{log}"
        out[world] = {j["name"]: [load_rank(odir, j["name"], r)
                                  for r in range(world)] for j in jobs}
        ckpt_src = os.path.join(jobs[0]["out_dir"],
                                _port_config("base").log_dir_name())
    return out


def _catchwords(tr):
    is_cw = np.zeros((K, tr.corpus.vocab_size), bool)
    for t, words in enumerate(tr.catchwords):
        is_cw[t, words] = True
    return is_cw


def _assert_same(r, tr, exact_floats=False):
    """A rank's results `r` against a trainer `tr` (the port's or
    isle_tpu's)."""
    np.testing.assert_array_equal(r["original_cols"], tr.original_cols)
    np.testing.assert_array_equal(r["cluster_of_doc"], tr.cluster_of_doc)
    np.testing.assert_array_equal(r["is_cw"], _catchwords(tr))
    np.testing.assert_allclose(r["evalues"], tr.evalues, rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(r["centers"], tr.centers, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(r["catchword_thresholds"],
                               tr.catchword_thresholds, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["model"], tr.model, rtol=1e-4, atol=1e-6)
    if tr.top_pairs is not None:
        for key, want in zip(("t1", "t2", "valid"), tr.top_pairs):
            np.testing.assert_array_equal(r[key], np.asarray(want), key)
    if tr.edge_pairs is not None:
        np.testing.assert_array_equal(r["edge_pairs"], tr.edge_pairs)
        np.testing.assert_allclose(r["edge_model"], tr.edge_model, rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("name", sorted(JOBS))
@pytest.mark.parametrize("world", WORLDS)
def test_matches_the_single_device_trainer(runs, single, world, name):
    _assert_same(runs[world][name][0], single[name])


@pytest.mark.parametrize("name", JAX_JOBS)
@pytest.mark.parametrize("world", WORLDS)
def test_matches_isle_tpu_sharded_trainer(runs, jax_runs, world, name):
    _assert_same(runs[world][name][0], jax_runs[name])


@pytest.mark.parametrize("name", JAX_JOBS)
def test_single_device_port_matches_isle_tpu_sharded(single, jax_runs, name):
    """The third side of the triangle, with the same draws."""
    tr, ref = single[name], jax_runs[name]
    np.testing.assert_array_equal(tr.original_cols, ref.original_cols)
    np.testing.assert_array_equal(tr.cluster_of_doc, ref.cluster_of_doc)
    np.testing.assert_array_equal(_catchwords(tr), _catchwords(ref))
    np.testing.assert_allclose(tr.model, ref.model, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_ends_with_the_same_bits(runs, world):
    """k- and vocab-sized state is replicated: each rank holds exactly
    rank 0's results, and rank 0 alone holds the run directory's files."""
    for name, rs in runs[world].items():
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
def test_resumes_from_another_world_sizes_checkpoints(runs, single, world,
                                                      stage):
    """The stage files hold whole arrays, so any world size resumes from
    any other's: after `stage` the run ends where the full run ended, and
    it skipped the stages before."""
    r = runs[world]["resume_" + stage][0]
    _assert_same(r, single["base"])
    stages = list(r["stages"])
    assert "eigen solve (B B^T, sharded)" not in stages or stage == "svd"
    if stage == "kmeans":
        assert "k-means on B (sharded)" not in stages
        assert "creating thresholded and scaled matrix (sharded)" not in stages
    else:
        assert "k-means on B (sharded)" in stages
    assert "constructing topic vectors (sharded)" in stages


def test_single_device_resumes_from_a_sharded_runs_checkpoints(tmp, runs,
                                                               single):
    src = tmp / "world4" / "base" / _port_config("base").log_dir_name()
    for stage in CKPTS:
        assert (src / f"ckpt_{stage}.npz").exists(), stage
    out = tmp / "back_to_one"
    run_dir = out / _port_config("base").log_dir_name()
    os.makedirs(run_dir)
    for stage in ("svd", "kmeans"):
        shutil.copy(src / f"ckpt_{stage}.npz", run_dir)
    tr = _finish(Trainer(_port_config("base"), output_dir=str(out),
                         quiet=True, gpu=CPU), _port_corpus("base"),
                 resume=True)
    _assert_same(runs[4]["base"][0], tr)
    with np.load(src / "ckpt_svd.npz") as got, \
            np.load(os.path.join(single["base"].run_dir,
                                 "ckpt_svd.npz")) as ref:
        assert sorted(got.files) == sorted(ref.files)
        np.testing.assert_array_equal(got["zetas"], ref["zetas"])
        np.testing.assert_array_equal(got["corpus_stamp"],
                                      ref["corpus_stamp"])


@pytest.mark.parametrize("world", WORLDS)
def test_stage_labels_are_the_references(runs, jax_runs, world):
    want = [label for label, *_ in jax_runs["base"].timer.phases
            if "edge" not in label]
    got = [s for s in runs[world]["base"][0]["stages"] if "edge" not in s]
    assert got == want


@pytest.mark.parametrize("world", WORLDS)
def test_thresholds_bite_and_a_rank_is_left_empty(runs, single, world):
    """The biting corpus: words with ζ > 1, docs dropped, and none of the
    docs of the last quarter survive, so at world size 4 the last rank
    holds no doc of B through the eigensolve and k-means."""
    tr = single["biting"]
    with np.load(os.path.join(tr.run_dir, "ckpt_svd.npz")) as z:
        assert z["zetas"].max() > 5
    assert tr.original_cols.max() < 300 < tr.corpus.num_docs
    r = runs[world]["biting"][0]
    assert (r["cluster_of_doc"][300:] == -1).all()
    assert (r["cluster_of_doc"][r["original_cols"]] >= 0).all()


@pytest.mark.parametrize("top_n", [0, 2])
@pytest.mark.parametrize("world", WORLDS)
def test_doc_parallel_mwu_matches_single_device(runs, single, world, top_n):
    """Each rank infers its share of every block's rows; all ranks return
    the whole result: converged flags exact, weights within rtol 2e-5."""
    tr = single["base"]
    inf = Inferencer(
        InferConfig(num_topics=K, vocab_size=tr.corpus.vocab_size, iters=15,
                    Lf=10.0),
        model=runs[world]["base"][0]["model"],
        output_dir=os.path.join(tr.run_dir, f"infer{world}"), quiet=True,
        gpu=CPU)
    ref = inf.infer_corpus(_port_corpus("base", normalize_to_one=True),
                           top_n=top_n)
    assert ref.num_converged > 0.9 * tr.corpus.num_docs
    tag = f"infer{top_n}_"
    for r in runs[world]["base"]:
        np.testing.assert_array_equal(r[tag + "converged"], ref.converged)
        np.testing.assert_allclose(r[tag + "weights"], ref.weights,
                                   rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(r[tag + "llh"], ref.llh_per_doc,
                                   rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(r[tag + "llh_weighted"],
                                   ref.llh_weighted, rtol=2e-5, atol=1e-4)


def test_group_less_mesh_trains_in_process(tmp, single):
    """A world of one without a process group takes the sharded path with
    every collective the identity: the single-device result, bit for
    bit."""
    mesh = Mesh("cpu")
    tr = _finish(
        Trainer(_port_config("base"), output_dir=str(tmp / "groupless"),
                quiet=True, gpu=CPU, draws=JaxDraws(SEED), mesh=mesh),
        _port_corpus("base"))
    ref = single["base"]
    assert [s for s, *_ in tr.timer.phases][0] == \
        "upload A to device (sharded)"
    np.testing.assert_array_equal(tr.cluster_of_doc, ref.cluster_of_doc)
    np.testing.assert_array_equal(tr.model, ref.model)
    np.testing.assert_array_equal(tr.evalues, ref.evalues)
    assert mesh.collective_calls == 0
    launches = dict(tr.stage_launches)
    assert "k-means on B (sharded)" in launches


def test_a_failing_rank_brings_the_others_down(tmp):
    """One rank raises before a collective the others enter: the others
    fail in it (the peer is gone, or the group's timeout) instead of
    waiting, and the launcher's own limit is never needed."""
    import time

    t0 = time.monotonic()
    results = run_ranks(2, [dict(kind="fail", name="fail")],
                        str(tmp / "fail"), limit=200)
    took = time.monotonic() - t0
    codes = [code for code, _ in results]
    assert all(code not in (0, None) for code in codes), results
    assert "rank 1 fails on purpose" in results[1][1]
    assert took < 150, took


def test_mesh_shape_must_match_the_group(tmp):
    """GpuConfig.mesh_shape asks for ranks that no process group has."""
    tr = Trainer(_port_config("base"), output_dir=str(tmp / "nogroup"),
                 quiet=True, gpu=GpuConfig(device="cpu", mesh_shape=(2,)))
    tr.load_corpus(_port_corpus("base"))
    with pytest.raises(RuntimeError, match="process group"):
        tr.train()
    tr = Trainer(_port_config("base"), output_dir=str(tmp / "nogroup"),
                 quiet=True, gpu=GpuConfig(device="cpu", mesh_shape=(2,)),
                 mesh=Mesh("cpu"))
    tr.load_corpus(_port_corpus("base"))
    with pytest.raises(RuntimeError, match="asks for 2 devices"):
        tr.train()


def _launch_like_torchrun(module, argv, world, cwd, limit=240):
    """Start `world` processes of a CLI with the environment torchrun
    gives them (a rendezvous on localhost); kill whatever outlives
    `limit` seconds. Returns [(exit code, output)] by rank."""
    import socket
    import subprocess
    import sys
    import time

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=root)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv], env=env, cwd=str(cwd),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + limit
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate(timeout=30)
        out.append((p.returncode, text))
    return out


def test_both_clis_under_a_torchrun_environment(tmp, single):
    """WORLD_SIZE, RANK and LOCAL_RANK in the environment: the training
    CLI joins the group, trains with mesh_shape=(2,) and rank 0 alone
    writes the run directory; the inference CLI then splits the docs over
    the ranks and writes one report. Both equal a run started alone."""
    from isle_tpu_torch.cli import infer as cli_infer
    from isle_tpu_torch.cli import train as cli_train

    (d, w, c), V, D = CORPORA["synth"]
    tdf = tmp / "synth.tdf"
    with open(tdf, "w") as f:
        for x in zip(d + 1, w + 1, c):
            f.write("%d %d %d\n" % x)
    args = [str(tdf), "", None, str(V), str(D), str(len(d)), str(K), "0", "0",
            "0", "1", "6", "--seed", str(SEED), "--device", "cpu"]
    outs = {}
    for tag in ("alone", "two"):
        args[2] = str(tmp / f"cli_{tag}")
        if tag == "alone":
            assert cli_train.main(list(args)) == 0
        else:
            results = _launch_like_torchrun("isle_tpu_torch.cli.train", args,
                                            2, tmp)
            assert [code for code, _ in results] == [0, 0], results
            assert "Model written to" in results[0][1]
            assert "Model written to" not in results[1][1]
        (run_dir,) = [p for p in (tmp / f"cli_{tag}").iterdir()]
        outs[tag] = run_dir
    names = sorted(p.name for p in outs["alone"].iterdir())
    assert names == sorted(p.name for p in outs["two"].iterdir())
    assert "M_hat_catch_sparse" in names and "ckpt_model.npz" in names
    for name in ("TopTwoTopicsPerDoc.txt", "EdgeTopicComposition.txt",
                 "DocCatchword.tsv"):
        assert (outs["alone"] / name).read_bytes() == \
            (outs["two"] / name).read_bytes(), name
    with np.load(outs["alone"] / "ckpt_model.npz") as a, \
            np.load(outs["two"] / "ckpt_model.npz") as b:
        np.testing.assert_allclose(b["model"], a["model"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_array_equal(b["is_cw"], a["is_cw"])

    model_file = str(outs["alone"] / "M_hat_catch_sparse")
    iargs = [model_file, str(tdf), None, str(K), str(V), "1", str(D + 1),
             "0", "0", "0", "0", "--device", "cpu"]
    reports = {}
    for tag in ("alone", "two"):
        iargs[2] = str(tmp / f"cli_infer_{tag}")
        if tag == "alone":
            assert cli_infer.main(list(iargs)) == 0
        else:
            results = _launch_like_torchrun("isle_tpu_torch.cli.infer",
                                            iargs, 2, tmp)
            assert [code for code, _ in results] == [0, 0], results
        reports[tag] = {p.name: p.read_bytes()
                        for p in (tmp / f"cli_infer_{tag}").iterdir()
                        if p.name.startswith("top_topics")}
    assert len(reports["alone"]) == 1
    assert reports["two"].keys() == reports["alone"].keys()
    (name,) = reports["alone"]
    a, b = (np.array(r[name].split(), np.float64).reshape(-1, 3)
            for r in (reports["alone"], reports["two"]))
    assert len(a) > 0
    np.testing.assert_array_equal(b[:, :2], a[:, :2])  # doc, topic
    np.testing.assert_allclose(b[:, 2], a[:, 2], rtol=2e-5)
