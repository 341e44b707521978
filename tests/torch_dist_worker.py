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
              an .npz file;
  "train"     Trainer over the mesh (the draws replayed from an .npz file
              where given), optionally resumed, and optionally an
              inference of the training docs with the trained model;
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

    out["rth"] = sh.sharded_rth_highest(
        ws, inp["cluster_of_doc"], inp["cluster_sizes"], k, r, mesh).numpy()
    out["mass"] = sh.compact_doc_rows(
        sh.sharded_doc_topic_mass(A, inp["cw_topic"], k, mesh), mesh).numpy()
    out["collective_calls"] = mesh.collective_calls
    return out


TRAINER_FIELDS = ("original_cols", "evalues", "centers", "cluster_of_doc",
                  "model", "catchword_thresholds", "edge_model", "edge_pairs")


def job_train(job: dict, mesh) -> dict:
    from isle_tpu_torch import GpuConfig, HyperParams, InferConfig, \
        Inferencer, TrainConfig, Trainer

    corpus = _corpus(job["corpus"])
    cfg = TrainConfig(num_topics=job["k"], seed=job["seed"],
                      hyper=HyperParams(**job.get("hyper", {})),
                      **job.get("cfg", {}))
    gpu = GpuConfig(device="cpu", mesh_shape=(mesh.world,))
    draws = ReplayDraws(job["draws"]) if job.get("draws") else None
    tr = Trainer(cfg, output_dir=job["out_dir"], quiet=True, gpu=gpu,
                 draws=draws, mesh=mesh)
    assert tr.mesh is mesh and tr.is_writer == (mesh.rank == 0)
    tr.load_corpus(corpus)
    tr.train(resume=job.get("resume", False))
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


def job_fail(job: dict, mesh) -> dict:
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh.all_reduce(torch.zeros(4))
    return {}


JOBS = {"sharding": job_sharding, "train": job_train, "fail": job_fail}


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
