"""One rank of a multi-process run of isle_tpu_torch on the CPU (gloo), and
the launcher the tests start the ranks with. This module imports no jax
and nothing of isle_tpu, so a rank is up in a few seconds:

    python tests/torch_dist_worker.py <rank> <world> <rendezvous file>
        <jobs.json> <out_dir>

Every rank reads the same list of jobs and runs them in order over one
process group; each job writes `<out_dir>/<job name>.rank<r>.npz`. A
group that loses a rank fails after GROUP_TIMEOUT seconds on the ranks
that wait for it, and run_ranks kills whatever is left after its own
limit: no test waits for ever.

Job kinds:

  "sharding"  every function of isle_tpu_torch.sharding on the inputs of
              an .npz file, sharded_train_step on the corpus's shards
              and on B's;
  "train"     Trainer over the mesh (the draws replayed from an .npz file
              where given, with "flat_cap" as hybrid.FLAT_CAP), optionally
              resumed, and optionally an
              inference of the training docs with the trained model; with
              "chunk_entries" the out-of-core StreamedTrainer instead
              (with "oom_once" its full-space Lloyd's runs out of memory
              once on every rank);
  "streamed_stages"  every stage of isle_tpu_torch.streaming_sharded on
              the rank's chunks beside its in-core sharded counterpart,
              with the calls of the segment-sum wrappers counted by pass;
  "fail"      rank 1 raises before a collective that the others enter.
"""

import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = 60  # seconds, of every collective and of the rendezvous
DOC_SPARSE_FIELDS = ("d_word", "d_doc", "d_val", "w_word", "w_doc", "w_val")


class ReplayDraws:
    """isle_tpu_torch.rng.Draws from recorded arrays (made by
    tests/torch_parity.JaxDraws in a process that has jax): the sampling
    uniforms, the Krylov start block, and for each seeding rep its first
    center and a run of k-means++ dice, replayed in order."""

    def __init__(self, path: str):
        with np.load(path) as z:
            self._z = dict(z)
        self._rep = -1
        self._round = 0

    def doc_sample_uniforms(self, num_docs):
        u = self._z["doc_sample_uniforms"]
        assert len(u) == num_docs
        return torch.from_numpy(u)

    def krylov_start(self, dim, blk):
        R = self._z["krylov_start"]
        assert R.shape == (dim, blk), (R.shape, dim, blk)
        return torch.from_numpy(R)

    def seeding_first(self, num_docs):
        self._rep += 1
        self._round = 0
        assert num_docs == self._z["seeding_docs"][self._rep]
        return int(self._z["seeding_first"][self._rep])

    def uniform(self, n):
        u = self._z["uniform"][self._rep, self._round]
        assert len(u) == n
        self._round += 1
        return torch.from_numpy(u)


def _corpus(path: str, normalize_to_one: bool = False):
    from isle_tpu_torch import Corpus

    with np.load(path) as z:
        return Corpus.from_entries(
            z["docs"], z["words"], z["counts"], vocab_size=int(z["vocab"]),
            num_docs=int(z["num_docs"]), normalize_to_one=normalize_to_one)


def _doc_sparse_arrays(sp, prefix: str) -> dict:
    return {f"{prefix}{f}": getattr(sp, f).numpy() for f in DOC_SPARSE_FIELDS}


def job_sharding(job: dict, mesh) -> dict:
    from isle_tpu_torch import sharding as sh
    from isle_tpu_torch.config import HyperParams
    from isle_tpu_torch.elkans_sharded import sharded_run_elkans

    corpus = _corpus(job["corpus"])
    with np.load(job["inputs"]) as z:
        inp = {name: torch.from_numpy(z[name]) for name in z.files}
    hyper = HyperParams(**job.get("hyper", {}))
    k, r, V, D = job["k"], job["r"], corpus.vocab_size, corpus.num_docs
    doc_ids = corpus.doc_ids()
    out = {}

    A = sh.shard_doc_sparse(corpus.rows, doc_ids, corpus.vals, V, D, mesh)
    out.update(_doc_sparse_arrays(A.local, "A_"))
    out.update(A_doc_counts=np.array(A.doc_counts), A_doc_start=A.doc_start,
               A_nnz=A.nnz)
    ws = sh.shard_by_word(corpus.rows, doc_ids, corpus.vals, V, D, mesh)
    out.update(ws_word=ws.w_word.numpy(), ws_doc=ws.w_doc.numpy(),
               ws_val=ws.w_val.numpy(), ws_bounds=np.array(ws.word_bounds),
               ws_vocab=ws.vocab)

    zetas, nnz = sh.sharded_thresholds(ws, corpus.avg_doc_sz, corpus.nz_docs,
                                       k, hyper, mesh)
    out.update(zetas=zetas.numpy(), new_nnz=nnz)

    B, cols = sh.sharded_threshold_and_copy(A, zetas, mesh)
    out.update(_doc_sparse_arrays(B.local, "B_"))
    out.update(cols=cols, B_doc_counts=np.array(B.doc_counts),
               B_doc_start=B.doc_start, B_nnz=B.nnz)
    Bs, cols_s = sh.sharded_threshold_and_copy(
        A, zetas, mesh, sample_rate=job["sample_rate"],
        uniforms=inp["uniforms"])
    out.update(_doc_sparse_arrays(Bs.local, "Bs_"))
    out.update(cols_s=cols_s, Bs_doc_counts=np.array(Bs.doc_counts))
    Br, cols_r = sh.sharded_threshold_and_copy(A, zetas, mesh, docs=cols_s)
    out.update(cols_r=cols_r, Br_nnz=Br.nnz)

    bt = sh.sharded_bt_x(B, inp["X"], mesh)
    assert bt.shape[0] == B.local.num_docs
    full_bt = sh.compact_doc_rows(bt, mesh)
    assert torch.equal(sh.pad_doc_rows(full_bt, B), bt)
    out.update(
        bt_x=full_bt.numpy(),
        b_y=sh.sharded_b_y(B, sh.pad_doc_rows(inp["Y"], B).contiguous(),
                           mesh).numpy(),
        gram_x=sh.sharded_gram_x(B, inp["X"], mesh).numpy(),
        doc_l2sq=sh.compact_doc_rows(sh.sharded_doc_l2sq(B, mesh),
                                     mesh).numpy(),
        flops=sh.sharded_spmm_flops(B, inp["X"].shape[1]),
    )
    centers, assign = sh.sharded_run_lloyds_full(B, inp["centers"].clone(),
                                                 10, mesh)
    out.update(lloyds_centers=centers.numpy(), lloyds_assign=assign)
    centers, assign = sharded_run_elkans(B, inp["centers"].clone(), 10, mesh)
    out.update(elkans_centers=centers.numpy(), elkans_assign=assign)

    out.update(_train_steps(A, B, inp, k, mesh))
    out["rth"] = sh.sharded_rth_highest(
        ws, inp["cluster_of_doc"], inp["cluster_sizes"], k, r, mesh).numpy()
    out["mass"] = sh.compact_doc_rows(
        sh.sharded_doc_topic_mass(A, inp["cw_topic"], k, mesh), mesh).numpy()
    if job.get("head_bytes"):
        out.update(_hybrid_products(B, zetas, inp, job["head_bytes"], mesh))
    out["collective_calls"] = mesh.collective_calls
    return out


def _train_steps(A, B, inp: dict, k: int, mesh) -> dict:
    """One sharded_train_step on each layout from the same X and centers,
    with the collectives of the step counted."""
    from isle_tpu_torch import sharding as sh

    out = {}
    for tag, ssp in (("A", A), ("B", B)):
        calls = mesh.collective_calls
        Y, assign, centers, hist = sh.sharded_train_step(ssp, mesh, k)(
            ssp, inp["step_X"], inp["step_centers"])
        out.update({f"step_{tag}_Y": Y.numpy(),
                    f"step_{tag}_assign": assign.numpy(),
                    f"step_{tag}_centers": centers.numpy(),
                    f"step_{tag}_hist": hist.numpy(),
                    f"step_{tag}_calls": mesh.collective_calls - calls})
    return out


def _hybrid_products(B, zetas, inp: dict, head_bytes: int, mesh) -> dict:
    """sharding.shard_hybrid of B: this rank's layout, and every product
    and both full-space k-means on it."""
    from isle_tpu_torch import sharding as sh
    from isle_tpu_torch.elkans_sharded import sharded_run_elkans
    from isle_tpu_torch.hybrid import row_scale_from_zetas

    H = sh.shard_hybrid(B, row_scale_from_zetas(zetas), mesh, head_bytes)
    h = H.local
    out = dict(h_head_words=h.head_words.numpy(),
               h_head=h.head.to(torch.uint8).numpy(), h_head_nnz=h.head_nnz,
               **_doc_sparse_arrays(h.tail, "h_tail_"))
    Y = sh.pad_doc_rows(inp["Y"], B).contiguous()
    out.update(
        h_bt_x=sh.compact_doc_rows(sh.sharded_bt_x(H, inp["X"], mesh),
                                   mesh).numpy(),
        h_b_y=sh.sharded_b_y(H, Y, mesh).numpy(),
        h_gram_x=sh.sharded_gram_x(H, inp["X"], mesh).numpy(),
        h_doc_l2sq=sh.compact_doc_rows(sh.sharded_doc_l2sq(H, mesh),
                                       mesh).numpy(),
    )
    centers, assign = sh.sharded_run_lloyds_full(H, inp["centers"].clone(),
                                                 10, mesh)
    out.update(h_lloyds_centers=centers.numpy(), h_lloyds_assign=assign)
    centers, assign = sharded_run_elkans(H, inp["centers"].clone(), 10, mesh)
    out.update(h_elkans_centers=centers.numpy(), h_elkans_assign=assign)
    return out


TRAINER_FIELDS = ("original_cols", "evalues", "centers", "cluster_of_doc",
                  "model", "catchword_thresholds", "edge_model", "edge_pairs")


def job_train(job: dict, mesh) -> dict:
    from isle_tpu_torch import hybrid

    cap = hybrid.FLAT_CAP
    hybrid.FLAT_CAP = job.get("flat_cap", cap)
    try:
        return _train(job, mesh)
    finally:
        hybrid.FLAT_CAP = cap


def _train(job: dict, mesh) -> dict:
    from isle_tpu_torch import GpuConfig, HyperParams, InferConfig, \
        Inferencer, StreamedTrainer, TrainConfig, Trainer

    corpus = _corpus(job["corpus"])
    cfg = TrainConfig(num_topics=job["k"], seed=job["seed"],
                      hyper=HyperParams(**job.get("hyper", {})),
                      **job.get("cfg", {}))
    gpu = GpuConfig(device="cpu", mesh_shape=(mesh.world,),
                    **job.get("gpu", {}))
    draws = ReplayDraws(job["draws"]) if job.get("draws") else None
    kw = dict(output_dir=job["out_dir"], quiet=True, gpu=gpu, draws=draws,
              mesh=mesh)
    if job.get("chunk_entries"):
        tr = StreamedTrainer(cfg, chunk_entries=job["chunk_entries"], **kw)
    else:
        tr = Trainer(cfg, **kw)
    assert tr.mesh is mesh and tr.is_writer == (mesh.rank == 0)
    tr.load_corpus(corpus)
    calls = {"solves": 0, "lloyds": 0}
    if job.get("oom_once"):
        from isle_tpu_torch import sharding, trainer

        real_solve, real_lloyds = (trainer.solve_gram_eigens,
                                   sharding.sharded_run_lloyds_full)

        def solve(*args, **kw):
            calls["solves"] += 1
            return real_solve(*args, **kw)

        def lloyds(*args, **kw):
            calls["lloyds"] += 1
            if calls["lloyds"] == 1:
                raise torch.OutOfMemoryError("injected")
            return real_lloyds(*args, **kw)

        trainer.solve_gram_eigens = solve
        sharding.sharded_run_lloyds_full = lloyds
    try:
        tr.train(resume=job.get("resume", False))
    finally:
        if job.get("oom_once"):
            trainer.solve_gram_eigens = real_solve
            sharding.sharded_run_lloyds_full = real_lloyds
    if cfg.compute_edge_topics:
        tr.train_edge_topics()
    out = {f: getattr(tr, f) for f in TRAINER_FIELDS
           if getattr(tr, f) is not None}
    is_cw = np.zeros((job["k"], corpus.vocab_size), bool)
    for t, words in enumerate(tr.catchwords):
        is_cw[t, words] = True
    out["is_cw"] = is_cw
    if tr.top_pairs is not None:
        out.update(zip(("t1", "t2", "valid"), tr.top_pairs))
    out["stages"] = np.array([label for label, _, _ in tr.timer.phases])
    if job.get("chunk_entries"):
        from isle_tpu_torch.streaming import ResidentLoader

        out["resident"] = isinstance(tr.loader, ResidentLoader)
        out["fill_count"] = getattr(tr.loader, "fill_count", 0)
        out.update(calls)
    out["holds_log_files"] = bool(tr.logger._files)
    if job.get("infer"):
        unit = _corpus(job["corpus"], normalize_to_one=True)
        inf = Inferencer(
            InferConfig(num_topics=job["k"], vocab_size=corpus.vocab_size,
                        iters=15, Lf=10.0),
            model=tr.model, output_dir=os.path.join(job["out_dir"], "infer"),
            quiet=True, gpu=gpu, mesh=mesh)
        for top_n in (0, 2):
            res = inf.infer_corpus(unit, top_n=top_n)
            tag = f"infer{top_n}_"
            out.update({tag + "weights": res.weights,
                        tag + "converged": res.converged,
                        tag + "llh": res.llh_per_doc,
                        tag + "llh_weighted": res.llh_weighted})
    out["collective_calls"] = mesh.collective_calls
    return out


def job_streamed_stages(job: dict, mesh) -> dict:
    from isle_tpu_torch import sharding as sh
    from isle_tpu_torch import streaming
    from isle_tpu_torch import streaming_sharded as ss
    from isle_tpu_torch.bmatrix import dice_select
    from isle_tpu_torch.config import HyperParams
    from isle_tpu_torch.topic_model import doc_topic_mass, has_catchwords, \
        l1_normalize_columns

    corpus = _corpus(job["corpus"])
    with np.load(job["inputs"]) as z:
        inp = {name: torch.from_numpy(z[name]) for name in z.files}
    hyper = HyperParams(**job.get("hyper", {}))
    k, V, D = job["k"], corpus.vocab_size, corpus.num_docs
    lo, hi = sh.doc_range(D, mesh)
    out = {"doc_range": np.array([lo, hi])}

    # the calls of the two wrappers by pass (on the CPU no kernel launches)
    calls = {"segsum_onehot": 0, "segsum_gather_rows": 0}
    saved = {name: getattr(streaming, name) for name in calls}

    def counted(name):
        def call(*args, **kw):
            calls[name] += 1
            return saved[name](*args, **kw)
        return call

    def counting(label, fn):
        before = dict(calls)
        result = fn()
        out["calls_" + label] = np.array(
            [calls[name] - before[name] for name in calls])
        return result

    for name in calls:
        setattr(streaming, name, counted(name))
    try:
        loader = streaming.ChunkLoader(corpus, job["chunk_entries"], "cpu",
                                       (lo, hi))
        out["ranges"] = np.array(loader.ranges, np.int64).reshape(-1, 2)
        doc_ids = corpus.doc_ids()
        A = sh.shard_doc_sparse(corpus.rows, doc_ids, corpus.vals, V, D,
                                mesh)
        ws = sh.shard_by_word(corpus.rows, doc_ids, corpus.vals, V, D, mesh)

        zetas, nnz = counting("thresholds", lambda: (
            ss.sharded_streamed_thresholds(corpus, k, hyper, loader, mesh)))
        z_in, nnz_in = sh.sharded_thresholds(
            ws, corpus.avg_doc_sz, corpus.nz_docs, k, hyper, mesh)
        out.update(zetas=zetas.numpy(), new_nnz=nnz,
                   zetas_incore=z_in.numpy(), new_nnz_incore=nnz_in)

        weights = counting("weights", lambda: (
            ss.sharded_streamed_doc_weights(corpus, zetas, loader, mesh)))
        out["weights"] = weights.numpy()
        select = mesh.broadcast(dice_select(weights, job["sample_rate"],
                                            inp["uniforms"]))
        for tag, sel, kw in (("B", None, {}),
                             ("Bs", select, dict(
                                 sample_rate=job["sample_rate"],
                                 uniforms=inp["uniforms"]))):
            B, cols = counting(tag, lambda: ss.sharded_streamed_build_b(
                corpus, zetas, sel, loader, mesh))
            IB, in_cols = sh.sharded_threshold_and_copy(A, zetas, mesh, **kw)
            out.update(_doc_sparse_arrays(B.local, tag + "_"))
            out.update(_doc_sparse_arrays(IB.local, "I" + tag + "_"))
            out.update({
                tag + "_cols": cols, "I" + tag + "_cols": in_cols,
                tag + "_meta": np.array(
                    [B.local.num_docs, B.doc_start, B.nnz, B.num_docs]),
                "I" + tag + "_meta": np.array(
                    [IB.local.num_docs, IB.doc_start, IB.nnz, IB.num_docs]),
                tag + "_counts": np.array(B.doc_counts),
                "I" + tag + "_counts": np.array(IB.doc_counts)})

        sub = counting("filter", lambda: ss.sharded_streamed_filter_clustered(
            corpus, inp["cluster_of_doc"], loader, mesh))
        out.update(sub_word=sub.w_word.numpy(), sub_doc=sub.w_doc.numpy(),
                   sub_val=sub.w_val.numpy(), sub_vocab=sub.vocab,
                   sub_bounds=np.array(sub.word_bounds), sub_nnz=sub.nnz,
                   sub_num_docs=sub.num_docs)

        cwt = inp["cw_topic"]
        mass = counting("mass", lambda: streaming.streamed_doc_topic_mass(
            corpus, cwt, k, loader))
        out.update(mass=mass.numpy(),
                   mass_incore=doc_topic_mass(A.local, cwt, k).numpy())
        has_cw = has_catchwords(cwt, k)
        for r in job["ranks"]:
            out[f"thr_{r}"] = ss.sharded_model_thresholds(
                mass, has_cw, r, D, mesh).numpy()
        crafted = inp["crafted_mass"]
        c_lo, c_hi = sh.doc_range(crafted.shape[0], mesh)
        for r in job["crafted_ranks"]:
            out[f"crafted_thr_{r}"] = ss.sharded_model_thresholds(
                crafted[c_lo:c_hi], inp["crafted_has_cw"], r,
                crafted.shape[0], mesh).numpy()
        out.update(zip(("t1", "t2", "valid"),
                       (x.numpy() for x in ss.sharded_top_two_topics(
                           mass, mesh))))

        W = inp["W"][lo:hi].contiguous()
        model = counting("model", lambda: ss.sharded_streamed_model(
            corpus, W, loader, mesh))
        out.update(model=model.numpy(), model_incore=l1_normalize_columns(
            sh.sharded_b_y(A, W, mesh)).numpy())
    finally:
        for name, fn in saved.items():
            setattr(streaming, name, fn)

    # a ragged exchange: rank r sends (r + j) % 3 rows to rank j
    send = [(mesh.rank + j) % 3 for j in range(mesh.world)]
    rows = torch.arange(2 * sum(send), dtype=torch.int32).reshape(-1, 2)
    out["a2a_sent"] = rows.numpy()
    out["a2a_got"] = mesh.all_to_all_rows(rows + 1000 * mesh.rank,
                                          send).numpy()
    out["collective_calls"] = mesh.collective_calls
    return out


def job_fail(job: dict, mesh) -> dict:
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh.all_reduce(torch.zeros(4))
    return {}


JOBS = {"sharding": job_sharding, "train": job_train,
        "streamed_stages": job_streamed_stages, "fail": job_fail}


def main(argv) -> int:
    rank, world = int(argv[1]), int(argv[2])
    rendezvous, jobs_path, out_dir = argv[3:6]
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from isle_tpu_torch.sharding import Mesh

    dist.init_process_group(
        "gloo", init_method=f"file://{rendezvous}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        mesh = Mesh.from_process_group("cpu")
        assert (mesh.rank, mesh.world) == (rank, world)
        with open(jobs_path) as f:
            jobs = json.load(f)
        for job in jobs:
            out = JOBS[job["kind"]](job, mesh)
            np.savez(os.path.join(out_dir, f"{job['name']}.rank{rank}.npz"),
                     **out)
    finally:
        dist.destroy_process_group()
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "isle_tpu", "bench")]
    assert not bad, f"a rank imported {bad}"
    return 0


def run_ranks(world: int, jobs: list, out_dir: str, limit: float = 300.0):
    """Start `world` ranks on `jobs`, wait at most `limit` seconds for all
    of them, and kill the rest. Returns [(exit code, stderr)] by rank; a
    killed rank has exit code None."""
    os.makedirs(out_dir, exist_ok=True)
    jobs_path = os.path.join(out_dir, "jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    rendezvous = os.path.join(out_dir, "rendezvous")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(out_dir, f"rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank),
             str(world), rendezvous, jobs_path, out_dir],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=out_dir))
    deadline = time.monotonic() + limit
    results = []
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p, log in zip(procs, logs):
            code = p.poll()
            if code is None:
                p.kill()
                p.wait(timeout=30)
            log.seek(0)
            results.append((code, log.read()))
            log.close()
    return results


def load_rank(out_dir: str, name: str, rank: int) -> dict:
    with np.load(os.path.join(out_dir, f"{name}.rank{rank}.npz")) as z:
        return dict(z)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
