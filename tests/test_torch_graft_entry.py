"""isle_tpu_torch.graft_entry against __graft_entry__.py: entry() builds
the same toy problem from the same seeds and its step gives the JAX
step's results (jitted on the CPU, Pallas in interpret mode); the dry run
over two and four gloo ranks passes its three legs and prints what the
reference prints.

Tolerances: the assignment exactly; Y within rtol 1e-4 (isle_tpu's own
for the Gram operator); centers and the MWU weights within 1e-5."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import __graft_entry__ as ge
from isle_tpu_torch import graft_entry
from isle_tpu_torch.sparse import DocSparse
from torch_dist_worker import DOC_SPARSE_FIELDS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def both():
    """(JAX fn, JAX args, the port's fn, the port's args on the CPU)."""
    return (*ge.entry(), *graft_entry.entry("cpu"))


def test_entry_builds_the_reference_problem(both):
    _, jargs, _, targs = both
    jsp = jargs[0]
    ref = DocSparse.from_numpy(
        *(np.asarray(getattr(jsp, f)) for f in DOC_SPARSE_FIELDS),
        jsp.vocab, jsp.num_docs, "cpu")
    sp = targs[0]
    assert (sp.vocab, sp.num_docs, sp.nnz) == (ref.vocab, ref.num_docs,
                                               ref.nnz)
    for f in DOC_SPARSE_FIELDS:
        np.testing.assert_array_equal(getattr(sp, f).numpy(),
                                      getattr(ref, f).numpy(), f)
    for got, want in zip(targs[1:], jargs[1:]):
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_entry_step_matches_the_jax_step(both):
    jfn, jargs, fn, args = both
    want = [np.asarray(o) for o in jax.block_until_ready(
        jax.jit(jfn)(*jargs))]
    Y, assign, centers, w = (o.numpy() for o in fn(*args))
    np.testing.assert_allclose(Y, want[0], rtol=1e-4)
    np.testing.assert_array_equal(assign, want[1])
    np.testing.assert_allclose(centers, want[2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w, want[3], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-5)
    assert len(np.unique(assign)) > 1


def test_entry_refuses_a_missing_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(1)


def test_dryrun_needs_a_card_a_rank(monkeypatch):
    """With fewer cards than ranks the dry run raises; it does not carry
    on over gloo."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        graft_entry.dryrun_multichip(2, "cuda")


# What __graft_entry__.dryrun_multichip(n) prints on n host devices.
REFERENCE_LINES = {
    n: [f"dryrun_multichip OK: {n} devices, full sharded train() (model "
        f"(96, 4), 96 catchwords, 6 edge topics) + sharded MWU "
        f"({50 * n}/{50 * n} converged)",
        "dryrun_multichip OK: streamed x mesh leg (4 chunks/shard, model "
        "agrees with the in-core sharded run)",
        f"dryrun_multichip OK: mid-size leg (V=2048, D={3000 * n + 37}, "
        f"k=20, nnz={nnz}, uneven shards, 100% docs assigned)"]
    for n, nnz in ((2, 81119), (4, 161645))
}


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_gloo(n):
    """The CLI: entry() on the CPU, then the three legs over n gloo ranks,
    each rank a process of its own; the lines __graft_entry__ prints."""
    out = subprocess.run(
        [sys.executable, "-m", "isle_tpu_torch.graft_entry", "--device",
         "cpu", "--dryrun", str(n)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.splitlines() == [
        "entry() run OK: [(512, 128), (1024,), (16, 512), (64, 16)]",
        *REFERENCE_LINES[n]]
