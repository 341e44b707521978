"""isle_tpu_torch.sharding over gloo at world sizes 1, 2 and 4, each
function against the port's single-device function and against
isle_tpu.sharding on the forced host devices of tests/conftest.py.

One spawn per world size (a module-scoped fixture): every rank runs the
"sharding" job of tests/torch_dist_worker.py and writes its results to an
.npz file. Integer results (the shards themselves, ζ, original_cols,
assignments, the r-th highest values, which are selections) are equal
exactly; float sums that pass an all-reduce within rtol 1e-4, atol 1e-5.

The main corpus makes thresholding bite (ζ up to ~30, docs dropped) and
leaves the last rank of a four-rank world without a doc in B: docs 300 to
399 hold only words that fall under their ζ. A second corpus has fewer
docs than ranks.

sharded_train_step runs on each corpus's shards and on B's, against
isle_tpu.sharding.sharded_train_step on a mesh of as many host devices as
ranks: isle_tpu's padded doc slots enter its k-means counts, and how many
there are depends on the number of shards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isle_tpu import sharding as jsh
from isle_tpu.config import HyperParams
from isle_tpu.corpus import Corpus as JaxCorpus
from isle_tpu_torch import bmatrix, catchwords, elkans, kmeans, sparse, \
    thresholds, topic_model
from isle_tpu_torch.corpus import Corpus
from isle_tpu_torch.sharding import Mesh, word_bounds
from torch_cases import dead_tail_entries
from torch_dist_worker import DOC_SPARSE_FIELDS, load_rank, run_ranks
from torch_parity import HEAD_BYTES

WORLDS = [1, 2, 4]
K, R, RATE, WIDTH = 4, 3, 0.5, 5
V, D = 200, 400
DEAD_FROM = 300  # docs from here on are dropped by thresholding
TOL = dict(rtol=1e-4, atol=1e-5)


def _tiny_entries():
    """Three docs: fewer than the ranks of a four-rank world."""
    docs = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2])
    words = np.array([0, 2, 5, 1, 2, 0, 3, 4, 5])
    counts = np.array([2, 1, 3, 1, 1, 4, 1, 2, 1])
    return docs, words, counts


def _inputs(corpus, rng, k, width, num_b_docs):
    Vc, Dc = corpus.vocab_size, corpus.num_docs
    cluster = rng.integers(-1, k, Dc).astype(np.int32)
    return dict(
        X=rng.standard_normal((Vc, width)).astype(np.float32),
        Y=rng.standard_normal((num_b_docs, width)).astype(np.float32),
        centers=rng.random((k, Vc)).astype(np.float32),
        uniforms=rng.random(Dc).astype(np.float32),
        cluster_of_doc=cluster,
        cluster_sizes=np.bincount(cluster[cluster >= 0],
                                  minlength=k).astype(np.int32),
        cw_topic=rng.integers(-1, k, Vc).astype(np.int32),
    )


def _step_inputs(A, rng, k, width):
    """X and centers for sharded_train_step: the centers are rows of k
    distinct docs, so every cluster holds a doc, the one of least ||c||^2
    among them (where isle_tpu's padded slots go)."""
    dense = sparse.to_dense(A)
    docs = rng.choice(min(A.num_docs, DEAD_FROM), k, replace=False)
    return dict(
        step_X=rng.standard_normal((A.vocab, width)).astype(np.float32),
        step_centers=np.ascontiguousarray(dense[:, docs].T, np.float32))


def _single(corpus, inp, k, r, hyper):
    """The port's single-device functions on the same inputs."""
    t = {name: torch.from_numpy(a) for name, a in inp.items()}
    A = sparse.DocSparse.from_corpus(corpus, "cpu")
    zetas, nnz = thresholds.compute_thresholds(
        A, corpus.avg_doc_sz, corpus.nz_docs, k, hyper)
    B, cols = bmatrix.threshold_and_copy(A, zetas)
    Bs, cols_s = bmatrix.threshold_and_copy(A, zetas, sample_rate=RATE,
                                            uniforms=t["uniforms"])
    lc, la = kmeans.run_lloyds_full(B, t["centers"].clone(), 10)
    ec, ea = elkans.run_elkans(B, t["centers"].clone(), 10)
    return dict(
        A=A, zetas=zetas.numpy(), new_nnz=nnz, B=B, cols=cols, Bs=Bs,
        cols_s=cols_s, bt_x=sparse.bt_x(B, t["X"]).numpy(),
        b_y=sparse.b_y(B, t["Y"]).numpy(),
        gram_x=sparse.gram_x(B, t["X"]).numpy(),
        doc_l2sq=sparse.doc_l2sq(B).numpy(),
        lloyds_centers=lc.numpy(), lloyds_assign=la.numpy(),
        elkans_centers=ec.numpy(), elkans_assign=ea.numpy(),
        rth=catchwords.rth_highest(A, t["cluster_of_doc"],
                                   t["cluster_sizes"], k, r).numpy(),
        mass=topic_model.doc_topic_mass(A, t["cw_topic"], k).numpy(),
    )


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The corpora, the inputs and the single-device results, with the
    files the ranks read."""
    tmp = tmp_path_factory.mktemp("sharding")
    hyper = HyperParams()
    out = {"tmp": tmp, "hyper": hyper}
    rng = np.random.default_rng(1)
    step_rng = np.random.default_rng(2)
    for name, (d, w, c), shape, k, r in (
        ("main", dead_tail_entries(V=V, D=D, k=K, dead_from=DEAD_FROM),
         (V, D), K, R),
        ("tiny", _tiny_entries(), (6, 3), 2, 1),
    ):
        corpus = Corpus.from_entries(d, w, c, vocab_size=shape[0],
                                     num_docs=shape[1])
        np.savez(tmp / f"{name}_corpus.npz", docs=d, words=w, counts=c,
                 vocab=shape[0], num_docs=shape[1])
        A = sparse.DocSparse.from_corpus(corpus, "cpu")
        z, _ = thresholds.compute_thresholds(A, corpus.avg_doc_sz,
                                             corpus.nz_docs, k, hyper)
        nb = bmatrix.threshold_and_copy(A, z)[0].num_docs
        inp = _inputs(corpus, rng, k, WIDTH, nb)
        inp.update(_step_inputs(A, step_rng, k, WIDTH))
        np.savez(tmp / f"{name}_inputs.npz", **inp)
        out[name] = dict(corpus=corpus, entries=(d, w, c), inp=inp, k=k, r=r,
                         ref=_single(corpus, inp, k, r, hyper))
    return out


@pytest.fixture(scope="module")
def ranks(case):
    """{world: {job name: [each rank's results]}}, one spawn a world."""
    tmp = case["tmp"]
    out = {}
    for world in WORLDS:
        jobs = [dict(kind="sharding", name=name,
                     corpus=str(tmp / f"{name}_corpus.npz"),
                     inputs=str(tmp / f"{name}_inputs.npz"),
                     k=case[name]["k"], r=case[name]["r"], sample_rate=RATE,
                     head_bytes=HEAD_BYTES if name == "main" else 0)
                for name in ("main", "tiny")]
        odir = str(tmp / f"world{world}")
        results = run_ranks(world, jobs, odir, limit=240)
        for rank, (code, log) in enumerate(results):
            assert code == 0, f"world {world} rank {rank}: {code}\n{log}"
        out[world] = {job["name"]: [load_rank(odir, job["name"], r)
                                    for r in range(world)] for job in jobs}
    return out


@pytest.fixture(scope="module")
def jax_ref(case):
    """isle_tpu.sharding on a mesh of four host devices, main corpus."""
    c = case["main"]
    d, w, cnt = c["entries"]
    corpus = JaxCorpus.from_entries(d, w, cnt, vocab_size=V, num_docs=D)
    mesh = jsh.make_mesh(4)
    doc_ids = corpus.doc_ids()
    ssp = jsh.shard_doc_sparse(corpus.rows, doc_ids, corpus.vals, V, D, mesh)
    ws = jsh.shard_by_word(corpus.rows, doc_ids, corpus.vals, V, D, mesh)
    zetas, nnz = jsh.sharded_thresholds(ws, corpus.avg_doc_sz,
                                        corpus.nz_docs, K, case["hyper"],
                                        mesh)
    B, cols = jsh.sharded_threshold_and_copy(ssp, zetas, mesh)
    key = jax.random.PRNGKey(7)
    Bs, cols_s = jsh.sharded_threshold_and_copy(ssp, zetas, mesh,
                                                sample_rate=RATE, key=key)
    inp = c["inp"]
    X = jnp.asarray(inp["X"])
    lc, la = jsh.sharded_run_lloyds_full(B, jnp.asarray(inp["centers"]), 10,
                                         mesh)
    from isle_tpu.hybrid import row_scale_from_zetas

    H = jsh.shard_hybrid(B, row_scale_from_zetas(zetas), mesh, HEAD_BYTES)
    hc, ha = jsh.sharded_run_lloyds_full(H, jnp.asarray(inp["centers"]), 10,
                                         mesh)
    hybrid = dict(
        head_words=np.asarray(H.head_words),
        head=np.asarray(H.head, np.float32), valid_docs=H.valid_per_shard(),
        bt_x=np.asarray(jsh.compact_doc_rows(jsh.sharded_h_bt_x(H, X, mesh),
                                             B)),
        b_y=np.asarray(jsh.sharded_h_b_y(
            H, jsh.pad_doc_rows(jnp.asarray(inp["Y"]), B, mesh), mesh)),
        gram_x=np.asarray(jsh.sharded_h_gram_x(H, X, mesh)),
        doc_l2sq=np.asarray(jsh.compact_doc_rows(
            jsh.sharded_doc_l2sq(H, mesh)[..., None], B))[:, 0],
        lloyds_centers=np.asarray(hc), lloyds_assign=np.asarray(ha))
    return dict(
        hybrid=hybrid,
        ws=ws, zetas=np.asarray(zetas), new_nnz=int(nnz), cols=cols,
        valid_docs=B.valid_docs, cols_s=cols_s,
        uniforms=np.asarray(jax.random.uniform(key, (D,), jnp.float32)),
        bt_x=np.asarray(jsh.compact_doc_rows(jsh.sharded_bt_x(B, X, mesh),
                                             B)),
        b_y=np.asarray(jsh.sharded_b_y(
            B, jsh.pad_doc_rows(jnp.asarray(inp["Y"]), B, mesh), mesh)),
        gram_x=np.asarray(jsh.sharded_gram_x(B, X, mesh)),
        doc_l2sq=np.asarray(jsh.compact_doc_rows(
            jsh.sharded_doc_l2sq(B, mesh)[..., None], B))[:, 0],
        lloyds_centers=np.asarray(lc), lloyds_assign=np.asarray(la),
        rth=jsh.sharded_rth_highest(ws, inp["cluster_of_doc"],
                                    inp["cluster_sizes"], K, R, mesh),
        mass=np.asarray(jsh.compact_doc_rows(jsh.sharded_doc_topic_mass(
            ssp, jnp.asarray(inp["cw_topic"]), K, mesh), ssp)),
        flops=jsh.sharded_spmm_flops(B, WIDTH),
    )


CASES = [(w, name) for w in WORLDS for name in ("main", "tiny")]


def _joined(rs, prefix, counts_key):
    """The ranks' doc shards under global doc ids, doc-sorted stream."""
    starts = np.concatenate([[0], np.cumsum(rs[0][counts_key])])
    return tuple(np.concatenate(
        [r[f"{prefix}d_{f}"] + (starts[i] if f == "doc" else 0)
         for i, r in enumerate(rs)]) for f in ("word", "doc", "val"))


def _assert_doc_shards(rs, prefix, counts_key, ref):
    """Joined in rank order the shards are the single-device matrix, and
    each shard's word-sorted stream is its doc-sorted one, resorted."""
    for got, f in zip(_joined(rs, prefix, counts_key),
                      ("d_word", "d_doc", "d_val")):
        np.testing.assert_array_equal(got, getattr(ref, f).numpy(), f)
    assert sum(rs[0][counts_key]) == ref.num_docs
    for r in rs:
        dw, dd, dv = (r[f"{prefix}d_{f}"] for f in ("word", "doc", "val"))
        order = np.lexsort((dd, dw))
        np.testing.assert_array_equal(r[f"{prefix}w_word"], dw[order])
        np.testing.assert_array_equal(r[f"{prefix}w_doc"], dd[order])
        np.testing.assert_array_equal(r[f"{prefix}w_val"], dv[order])


@pytest.mark.parametrize("world,name", CASES)
def test_shard_doc_sparse(case, ranks, world, name):
    """Rank s owns docs [s * dps, (s + 1) * dps), dps = ceil(D / S), under
    local ids, unpadded."""
    rs, c = ranks[world][name], case[name]
    Dc = c["corpus"].num_docs
    dps = -(-Dc // world)
    for s, r in enumerate(rs):
        assert r["A_doc_start"] == min(s * dps, Dc)
        want = int(np.clip(Dc - s * dps, 0, dps))
        assert r["A_doc_counts"][s] == want
        assert r["A_nnz"] == c["corpus"].nnz
        if len(r["A_d_doc"]):
            assert 0 <= r["A_d_doc"].min() and r["A_d_doc"].max() < want
    _assert_doc_shards(rs, "A_", "A_doc_counts", c["ref"]["A"])
    if name == "tiny" and world == 4:  # a rank without a doc
        assert rs[3]["A_doc_counts"][3] == 0 and len(rs[3]["A_d_doc"]) == 0


@pytest.mark.parametrize("world,name", CASES)
def test_shard_by_word(case, ranks, world, name):
    """Contiguous word ranges under local word ids, global doc ids; joined
    they are the word-sorted stream of the whole matrix."""
    rs, A = ranks[world][name], case[name]["ref"]["A"]
    bounds = rs[0]["ws_bounds"]
    assert bounds[0] == 0 and bounds[-1] == A.vocab
    assert len(bounds) == world + 1 and np.all(np.diff(bounds) >= 0)
    for s, r in enumerate(rs):
        np.testing.assert_array_equal(r["ws_bounds"], bounds)
        assert r["ws_vocab"] == bounds[s + 1] - bounds[s]
    np.testing.assert_array_equal(
        np.concatenate([r["ws_word"] + bounds[s] for s, r in enumerate(rs)]),
        A.w_word.numpy())
    for f in ("doc", "val"):
        np.testing.assert_array_equal(
            np.concatenate([r[f"ws_{f}"] for r in rs]),
            getattr(A, f"w_{f}").numpy())


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_word_bounds_are_the_reference_cuts(case, jax_ref, shards):
    """The cuts from a count per word are isle_tpu's, which sorts."""
    corpus = case["main"]["corpus"]
    got = word_bounds(corpus.rows, V, shards)
    sw = np.sort(corpus.rows.astype(np.int64))
    n = len(sw)
    cuts = sw[np.minimum((np.arange(1, shards) * n) // shards, n - 1)] + 1
    want = np.maximum.accumulate(np.concatenate([[0], cuts, [V]]))
    np.testing.assert_array_equal(got, want)
    if shards == 4:
        np.testing.assert_array_equal(got[:-1], jax_ref["ws"].word_start)
    # balanced: no range holds much more than its share
    per = np.diff(np.searchsorted(sw, got))
    assert per.max() <= n / shards + np.bincount(corpus.rows).max()


@pytest.mark.parametrize("world,name", CASES)
def test_thresholds_and_b(case, ranks, world, name):
    """ζ, the kept count, original_cols and B equal the single-device
    stage's; thresholding bites on the main corpus."""
    rs, ref = ranks[world][name], case[name]["ref"]
    for s, r in enumerate(rs):
        np.testing.assert_array_equal(r["zetas"], ref["zetas"])
        assert r["new_nnz"] == ref["new_nnz"]
        np.testing.assert_array_equal(r["cols"], ref["cols"])
        assert r["B_nnz"] == ref["B"].nnz
        assert r["B_doc_start"] == sum(r["B_doc_counts"][:s])
    _assert_doc_shards(rs, "B_", "B_doc_counts", ref["B"])
    if name == "main":
        assert ref["zetas"].max() > 5 and ref["B"].num_docs < DEAD_FROM
        assert ref["cols"].max() < DEAD_FROM
        if world == 4:  # every doc of the last rank was dropped
            assert rs[0]["B_doc_counts"][3] == 0
            assert len(rs[3]["B_d_word"]) == 0


@pytest.mark.parametrize("world,name", CASES)
def test_sampled_b(case, ranks, world, name):
    """Sampling takes the pivot over all docs from the same uniforms on
    every rank: the single-device selection and B; and a B rebuilt from
    those docs (a resumed run) keeps exactly them."""
    rs, ref = ranks[world][name], case[name]["ref"]
    for r in rs:
        np.testing.assert_array_equal(r["cols_s"], ref["cols_s"])
        np.testing.assert_array_equal(r["cols_r"], ref["cols_s"])
        assert r["Br_nnz"] == ref["Bs"].nnz
    _assert_doc_shards(rs, "Bs_", "Bs_doc_counts", ref["Bs"])
    if name == "main":
        assert 0 < len(ref["cols_s"]) < len(ref["cols"])


@pytest.mark.parametrize("key", ["bt_x", "b_y", "gram_x", "doc_l2sq",
                                 "mass"])
@pytest.mark.parametrize("world,name", CASES)
def test_products(case, ranks, world, name, key):
    """Local products and all-reduced ones against the single device."""
    for r in ranks[world][name]:
        np.testing.assert_allclose(r[key], case[name]["ref"][key], **TOL)
    B = case[name]["ref"]["B"]
    assert ranks[world][name][0]["flops"] == sparse.spmm_flops(B, WIDTH)


@pytest.mark.parametrize("algo", ["lloyds", "elkans"])
@pytest.mark.parametrize("world,name", CASES)
def test_full_space_kmeans(case, ranks, world, name, algo):
    """Assignments exact, centers to tolerance, every rank the same and
    out of the loop in the same rep (a rank left inside would have hung
    the job)."""
    rs, ref = ranks[world][name], case[name]["ref"]
    for r in rs:
        np.testing.assert_array_equal(r[f"{algo}_assign"],
                                      ref[f"{algo}_assign"])
        np.testing.assert_allclose(r[f"{algo}_centers"],
                                   ref[f"{algo}_centers"], **TOL)
        np.testing.assert_array_equal(r[f"{algo}_centers"],
                                      rs[0][f"{algo}_centers"])
    assert rs[0][f"{algo}_assign"].dtype == np.int32


@pytest.mark.parametrize("world,name", CASES)
def test_rth_highest(case, ranks, world, name):
    """A selection, not a sum: exact."""
    for r in ranks[world][name]:
        np.testing.assert_array_equal(r["rth"], case[name]["ref"]["rth"])
    assert case["main"]["ref"]["rth"].max() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_are_counted(ranks, world):
    """Every rank enters the same collectives; a world of one with a
    process group still goes through them."""
    calls = [int(r["collective_calls"]) for r in ranks[world]["main"]]
    assert len(set(calls)) == 1 and calls[0] > 20


def test_mesh_without_a_group_is_the_identity():
    mesh = Mesh("cpu")
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_reduce(t) is t and mesh.broadcast(t) is t
    assert mesh.all_gather_rows(t) is t and mesh.row_counts(3) == (3,)
    assert mesh.broadcast_object({"a": 1}) == {"a": 1}
    assert mesh.all_equal(t, t.clone()) and not mesh.all_equal(t, t + 1)
    assert mesh.row_slice(7) == slice(0, 7)
    assert mesh.collective_calls == 0 and mesh.collective_seconds() == 0.0
    parts = [Mesh("cpu", rank=r, world=3).row_slice(7) for r in range(3)]
    assert parts == [slice(0, 3), slice(3, 6), slice(6, 7)]


@pytest.mark.parametrize("world", WORLDS)
def test_against_isle_tpu_sharding(case, ranks, jax_ref, world):
    """The same functions of isle_tpu.sharding on four host devices: ζ,
    original_cols, the docs each of four shards keeps and Lloyd's
    assignments exact, float results to tolerance."""
    r = ranks[world]["main"][0]
    np.testing.assert_array_equal(r["zetas"], jax_ref["zetas"])
    assert r["new_nnz"] == jax_ref["new_nnz"]
    np.testing.assert_array_equal(r["cols"], jax_ref["cols"])
    if world == 4:
        assert tuple(r["B_doc_counts"]) == tuple(jax_ref["valid_docs"])
    for key in ("bt_x", "b_y", "gram_x", "doc_l2sq", "mass", "rth",
                "lloyds_centers"):
        np.testing.assert_allclose(r[key], jax_ref[key], **TOL, err_msg=key)
    np.testing.assert_array_equal(r["lloyds_assign"],
                                  jax_ref["lloyds_assign"])
    assert r["flops"] == jax_ref["flops"]


def test_sampling_against_isle_tpu_sharding(case, jax_ref):
    """isle_tpu's sampled selection on its mesh, from the uniforms of its
    key, is what the port selects from the same uniforms (group-less
    mesh: the ranks' agreement is test_sampled_b's)."""
    from isle_tpu_torch import sharding as sh

    corpus = case["main"]["corpus"]
    mesh = Mesh("cpu")
    A = sh.shard_doc_sparse(corpus.rows, corpus.doc_ids(), corpus.vals, V, D,
                            mesh)
    _, cols = sh.sharded_threshold_and_copy(
        A, torch.from_numpy(jax_ref["zetas"]), mesh, sample_rate=RATE,
        uniforms=torch.from_numpy(jax_ref["uniforms"].copy()))
    np.testing.assert_array_equal(cols, jax_ref["cols_s"])


# ---------------------------------------------------------------------------
# The hybrid layout (ShardedHybrid), main corpus
# ---------------------------------------------------------------------------


def _single_hybrid(case, head_words):
    """The single-device hybrid layout of B with the given head words, its
    products on the rank's inputs and both k-means from its centers."""
    from isle_tpu_torch import hybrid, matops

    c = case["main"]
    inp = {name: torch.from_numpy(a) for name, a in c["inp"].items()}
    B = c["ref"]["B"]
    h = hybrid.split_by_head(
        B, torch.from_numpy(head_words),
        hybrid.row_scale_from_zetas(torch.from_numpy(c["ref"]["zetas"])))
    lc, la = kmeans.run_lloyds_full(h, inp["centers"].clone(), 10)
    ec, ea = elkans.run_elkans(h, inp["centers"].clone(), 10)
    return h, dict(
        h_bt_x=matops.mat_bt_x(h, inp["X"]).numpy(),
        h_b_y=matops.mat_b_y(h, inp["Y"]).numpy(),
        h_gram_x=matops.mat_gram_x(h, inp["X"]).numpy(),
        h_doc_l2sq=matops.mat_doc_l2sq(h).numpy(),
        h_lloyds_centers=lc.numpy(), h_lloyds_assign=la.numpy(),
        h_elkans_centers=ec.numpy(), h_elkans_assign=ea.numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_shard_hybrid_layout(case, ranks, world):
    """One set of head words on every rank, chosen from all ranks' counts
    with isle_tpu's head rule over its padded docs per shard; each rank's
    slab is the single-device head's columns of its docs and its tail is
    its docs' share of the single-device tail."""
    from isle_tpu_torch import hybrid

    rs = ranks[world]["main"]
    hw = rs[0]["h_head_words"]
    for r in rs:
        np.testing.assert_array_equal(r["h_head_words"], hw)
    counts = rs[0]["B_doc_counts"]
    dps = max(-(-max(counts) // 8) * 8, 8)
    B = case["main"]["ref"]["B"]
    R = min(V, max(8, HEAD_BYTES // (2 * dps * world)),
            hybrid.max_head_rows(dps))
    assert 8 < len(hw) == R < V
    np.testing.assert_array_equal(
        hw, hybrid.top_words(hybrid.word_counts(B), R).numpy())
    h, _ = _single_hybrid(case, hw)
    head = h.head.to(torch.uint8).numpy()
    starts = np.concatenate([[0], np.cumsum(counts)])
    for s, r in enumerate(rs):
        np.testing.assert_array_equal(r["h_head"],
                                      head[:, starts[s]:starts[s + 1]])
    assert sum(int(r["h_head_nnz"]) for r in rs) == h.head_nnz
    for f in DOC_SPARSE_FIELDS[:3]:
        got = np.concatenate([r[f"h_tail_{f}"] + (starts[s] if f == "d_doc"
                                                  else 0)
                              for s, r in enumerate(rs)])
        np.testing.assert_array_equal(got, getattr(h.tail, f).numpy(), f)


@pytest.mark.parametrize("world", WORLDS)
def test_shard_hybrid_products_and_kmeans(case, ranks, world):
    """Every product on the ShardedHybrid, and Lloyd's and Elkan's on it:
    the single-device hybrid layout of the same head words, assignments
    exactly, sums within the all-reduce's tolerance."""
    rs = ranks[world]["main"]
    _, ref = _single_hybrid(case, rs[0]["h_head_words"])
    for r in rs:
        for key, want in ref.items():
            if key.endswith("assign"):
                np.testing.assert_array_equal(r[key], want, key)
            else:
                np.testing.assert_allclose(r[key], want, **TOL, err_msg=key)


def test_shard_hybrid_against_isle_tpu(ranks, jax_ref):
    """World size 4 against isle_tpu.sharding.shard_hybrid on four
    devices: the head words and every shard's head exactly, the sharded
    hybrid products and Lloyd's within tolerance."""
    rs, ref = ranks[4]["main"], jax_ref["hybrid"]
    np.testing.assert_array_equal(rs[0]["h_head_words"], ref["head_words"])
    for s, r in enumerate(rs):
        valid = ref["valid_docs"][s]
        np.testing.assert_array_equal(r["h_head"] != 0,
                                      ref["head"][s][:, :valid] != 0)
    r = rs[0]
    for key in ("bt_x", "b_y", "gram_x", "doc_l2sq", "lloyds_centers"):
        np.testing.assert_allclose(r["h_" + key], ref[key], **TOL,
                                   err_msg=key)
    np.testing.assert_array_equal(r["h_lloyds_assign"], ref["lloyds_assign"])


# ---------------------------------------------------------------------------
# sharded_train_step
# ---------------------------------------------------------------------------


STEP_CASES = [(w, name, layout) for w in WORLDS for name in ("main", "tiny")
              for layout in ("A", "B")]


@pytest.fixture(scope="module")
def jax_steps(case):
    """isle_tpu.sharding.sharded_train_step at every world size, on each
    corpus's shards and on B's (built from the port's ζ, which equal
    isle_tpu's): {(world, name, layout): results and valid docs a shard}."""
    out = {}
    for world in WORLDS:
        mesh = jsh.make_mesh(world)
        for name in ("main", "tiny"):
            c = case[name]
            corpus, inp = c["corpus"], c["inp"]
            Vc, Dc = corpus.vocab_size, corpus.num_docs
            A = jsh.shard_doc_sparse(corpus.rows, corpus.doc_ids(),
                                     corpus.vals, Vc, Dc, mesh)
            B, _ = jsh.sharded_threshold_and_copy(
                A, jnp.asarray(c["ref"]["zetas"]), mesh)
            for layout, ssp in (("A", A), ("B", B)):
                Y, assign, centers, hist = jsh.sharded_train_step(
                    ssp, mesh, c["k"])(ssp, jnp.asarray(inp["step_X"]),
                                       jnp.asarray(inp["step_centers"]))
                out[world, name, layout] = dict(
                    Y=np.asarray(Y), assign=np.asarray(assign),
                    centers=np.asarray(centers), hist=np.asarray(hist),
                    valid=ssp.valid_per_shard(), dps=ssp.docs_per_shard)
    return out


@pytest.mark.parametrize("world,name,layout", STEP_CASES)
def test_train_step_against_isle_tpu(ranks, jax_steps, world, name, layout):
    """Every rank: the histogram exactly, Y within the all-reduce's
    tolerance, the centers (pads counted as isle_tpu counts them) within
    rtol 1e-5, atol 1e-6, and the rank's assignments exactly those of
    isle_tpu's shard; four collectives a step."""
    ref = jax_steps[world, name, layout]
    tag = f"step_{layout}_"
    for s, r in enumerate(ranks[world][name]):
        np.testing.assert_array_equal(r[tag + "hist"], ref["hist"])
        assert r[tag + "hist"].dtype == np.float32
        np.testing.assert_allclose(r[tag + "Y"], ref["Y"], **TOL)
        np.testing.assert_allclose(r[tag + "centers"], ref["centers"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(r[tag + "assign"],
                                      ref["assign"][s, :ref["valid"][s]])
        assert int(r[tag + "calls"]) == 4


def test_train_step_counts_the_reference_pads(case, ranks, jax_steps):
    """Where isle_tpu's shards hold empty slots, their count goes to the
    center of least ||c||^2 and that cluster's new center is not the mean
    of its docs; every other center is. The centers are doc rows, so that
    cluster holds docs, and some case has pads: the padding rule shows."""
    shown = []
    for world, name, layout in STEP_CASES:
        c, ref = case[name], jax_steps[world, name, layout]
        rs = ranks[world][name]
        tag = f"step_{layout}_"
        assign = np.concatenate([r[tag + "assign"] for r in rs])
        pads = int(world * ref["dps"] - ref["valid"].sum())
        sp = c["ref"]["A" if layout == "A" else "B"]
        plain = kmeans.update_centers_full(
            sp, torch.from_numpy(assign).long(), c["k"]).numpy()
        centers = rs[0][tag + "centers"]
        c_l2 = (c["inp"]["step_centers"].astype(np.float64) ** 2).sum(1)
        least = int(np.argmin(c_l2))
        others = np.arange(c["k"]) != least
        np.testing.assert_allclose(centers[others], plain[others],
                                   rtol=1e-5, atol=1e-6)
        if pads == 0:
            np.testing.assert_allclose(centers, plain, rtol=1e-5, atol=1e-6)
        elif np.any(assign == least):
            assert not np.allclose(centers[least], plain[least], rtol=1e-3)
            shown.append((world, name, layout))
    assert shown, "no case puts isle_tpu's pads into a cluster with docs"
    assert any(layout == "A" for _, _, layout in shown)


def test_train_step_refuses_the_hybrid_layout(case):
    """isle_tpu's step reads the COO streams and has no hybrid form: a
    ShardedHybrid raises, at construction and in the step."""
    from isle_tpu_torch import sharding as sh
    from isle_tpu_torch.hybrid import row_scale_from_zetas

    c = case["main"]
    corpus, mesh = c["corpus"], Mesh("cpu")
    A = sh.shard_doc_sparse(corpus.rows, corpus.doc_ids(), corpus.vals, V, D,
                            mesh)
    B, _ = sh.sharded_threshold_and_copy(
        A, torch.from_numpy(c["ref"]["zetas"]), mesh)
    H = sh.shard_hybrid(B, row_scale_from_zetas(
        torch.from_numpy(c["ref"]["zetas"])), mesh, HEAD_BYTES)
    with pytest.raises(TypeError, match="ShardedHybrid"):
        sh.sharded_train_step(H, mesh, K)
    step = sh.sharded_train_step(B, mesh, K)
    inp = {n: torch.from_numpy(c["inp"][n]) for n in ("step_X",
                                                       "step_centers")}
    with pytest.raises(TypeError, match="ShardedHybrid"):
        step(H, inp["step_X"], inp["step_centers"])
    assert len(step(B, inp["step_X"], inp["step_centers"])) == 4
