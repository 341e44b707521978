"""isle_tpu_torch.micro_kernels against the two micro-benchmarks of
benchmarks/ (micro_pallas.py, micro_pallas_gather.py), on the CPU.

Both scripts are loaded from their files as they are; their Pallas
kernels run in interpret mode, through a stand-in for the loaded module's
`pl` whose pallas_call passes interpret=True. On the CPU each wrapper of
the port runs its plain PyTorch version. Integer plans must be equal; the
segment sums within maxrel 1e-6 (max |out - ref| / max |ref|, the
benchmark's measure): both sides sum float32 in another order. The
`default` mode rounds g to bf16 on the card's tensor cores and on the
TPU's MXU, but JAX's float32 dot on the CPU does not, so the JAX kernel is
fed g already rounded to bf16 there. The gather must be bit-equal.
"""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from isle_tpu_torch import micro_kernels as mk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_bench_{name}", os.path.join(ROOT, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    interp = types.SimpleNamespace(
        **{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = interp
    return mod


@pytest.fixture(scope="module")
def mp():
    return _load("micro_pallas")


@pytest.fixture(scope="module")
def mg():
    return _load("micro_pallas_gather")


def _maxrel(got, ref):
    got, ref = (np.asarray(x, np.float64) for x in (got, ref))
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# (n, avg_run, num_segments, chunk): the benchmark's two streams cut to
# 2^14-2^16 entries, at its chunk of 2048 and at 512
STREAMS = {
    "doc-dir": (1 << 16, 110, 1 << 12, 2048),
    "word-tail": (1 << 16, 16, 1 << 13, 2048),
    "word-tail-512": (1 << 14, 16, 1 << 11, 512),
    "runs-of-1": (1 << 14, 1, 1 << 15, 512),
}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_sorted_segments_and_plan(mp, stream, seed):
    """make_sorted_segments gives the benchmark's array; plan_ranks (and
    its host version) the benchmark's rank2d, ids and rcap exactly, ids
    non-decreasing."""
    n, avg, nseg, chunk = STREAMS[stream]
    seg = mk.make_sorted_segments(n, avg, nseg, seed)
    want = mp.make_sorted_segments(n, avg, nseg, seed)
    assert seg.dtype == want.dtype and np.array_equal(seg, want)
    r_ref, i_ref, c_ref = mp.plan_ranks(jnp.asarray(want), chunk)
    got = mk.plan_ranks(torch.from_numpy(seg), chunk)
    plain = mk.plan_ranks_plain(seg, chunk)
    for rank2d, ids, rcap in (got, plain):
        assert rcap == c_ref
        assert np.array_equal(np.asarray(rank2d), np.asarray(r_ref))
        assert np.array_equal(np.asarray(ids), np.asarray(i_ref))
    assert np.all(np.diff(np.asarray(got[1])) >= 0)


def _case(stream, W, seed=1):
    n, avg, nseg, chunk = STREAMS[stream]
    seg = mk.make_sorted_segments(n, avg, nseg, seed)
    g = np.random.default_rng(seed).standard_normal((n, W)).astype(
        np.float32)
    rank2d, ids, rcap = mk.plan_ranks_plain(seg, chunk)
    return seg, g, rank2d.reshape(-1), ids, rcap, chunk, nseg


def _jax_g(g, mode):
    """The g the JAX kernel is fed: rounded to bf16 for `default` (JAX's
    CPU dot is exact float32; the MXU and the tensor cores round)."""
    if mode == "default":
        return jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32)
    return jnp.asarray(g)


@pytest.mark.parametrize("mode", mk.MODES)
@pytest.mark.parametrize("stream,W", [("doc-dir", 128), ("word-tail", 128),
                                      ("word-tail-512", 8),
                                      ("runs-of-1", 8)])
def test_partials_and_scatter_match_the_pallas_kernel(mp, stream, W, mode):
    """chunk_partials_plain against make_pallas_segsum, and
    scatter_partials of them against pallas_scatter, within maxrel 1e-6."""
    seg, g, rank, ids, rcap, chunk, nseg = _case(stream, W)
    nchunks = len(seg) // chunk
    kern = mp.make_pallas_segsum(chunk, rcap, mode)
    rank_j, g_j = jnp.asarray(rank), _jax_g(g, mode)
    ref = kern(rank_j, g_j, nchunks, W)
    got = mk.chunk_partials(torch.from_numpy(rank), torch.from_numpy(g),
                            chunk, rcap, mode)
    assert got.shape == ref.shape == (nchunks, rcap, W)
    assert _maxrel(got, ref) <= 1e-6
    out = mk.scatter_partials(got, torch.from_numpy(ids), nseg)
    want = mp.pallas_scatter(kern, rank_j, g_j, jnp.asarray(ids), nseg,
                             nchunks, W)
    assert out.shape == want.shape == (nseg, W)
    assert _maxrel(out, want) <= 1e-6


@pytest.mark.parametrize("mode", mk.MODES)
@pytest.mark.parametrize("layout", ["outside", "unused"])
def test_partials_ranks_outside_and_unused(mp, mode, layout):
    """A rank outside [0, rcap) adds nothing (its one-hot column is zero),
    as in the Pallas kernel; rows no entry reaches are exactly zero."""
    chunk, rcap, W, n = 512, 32, 8, 4096
    rng = np.random.default_rng(7)
    if layout == "outside":
        rank = rng.integers(-4, rcap + 4, n).astype(np.int32)
    else:  # only even ranks below 20 occur
        rank = (2 * rng.integers(0, 10, n)).astype(np.int32)
    g = rng.standard_normal((n, W)).astype(np.float32)
    got = mk.chunk_partials(torch.from_numpy(rank), torch.from_numpy(g),
                            chunk, rcap, mode)
    ref = mp.make_pallas_segsum(chunk, rcap, mode)(
        jnp.asarray(rank), _jax_g(g, mode), n // chunk, W)
    assert _maxrel(got, ref) <= 1e-6
    used = np.zeros((n // chunk, rcap), bool)
    ok = (rank >= 0) & (rank < rcap)
    used[(np.arange(n) // chunk)[ok], rank[ok]] = True
    assert not got.numpy()[~used].any()
    if layout == "outside":  # what remains is the sum of the in-range ranks
        keep = torch.from_numpy(np.where(ok, rank, 0))
        g_in = torch.from_numpy(np.where(ok[:, None], g, 0))
        assert torch.equal(got, mk.chunk_partials(keep, g_in, chunk, rcap,
                                                  mode))


@pytest.mark.parametrize("chunk,depth", [(1024, 8), (1024, 32), (1024, 128),
                                         (4096, 256)])
def test_row_gather_matches_the_dma_gather(mg, chunk, depth):
    """row_gather_async (its plain version, tab[idx]) bit-equal to
    make_dma_gather at the benchmark's four (chunk, depth) pairs."""
    V, W, n = 3_001, 128, 1 << 14
    rng = np.random.default_rng(depth)
    tab = rng.standard_normal((V, W)).astype(np.float32)
    idx = rng.integers(0, V, n).astype(np.int32)
    ref = mg.make_dma_gather(chunk, depth, W)(jnp.asarray(idx),
                                              jnp.asarray(tab))
    got = mk.row_gather_async(torch.from_numpy(idx), torch.from_numpy(tab),
                              chunk, depth)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(mk.row_gather_plain(torch.from_numpy(idx),
                                              torch.from_numpy(tab)).numpy(),
                          tab[idx])


def test_wrappers_check_their_arguments():
    """What every wrapper refuses, on any device; a CPU tensor never counts
    a launch."""
    mk.reset_launch_counts()
    g = torch.zeros((1024, 8))
    rank = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        mk.chunk_partials(rank, g, 512, 8, "tf32")
    with pytest.raises(ValueError, match="multiple"):
        mk.chunk_partials(rank, g, 300, 8, "split2")
    with pytest.raises(ValueError, match="int32"):
        mk.chunk_partials(rank.long(), g, 512, 8, "split2")
    with pytest.raises(ValueError, match="depth"):
        mk.row_gather_async(rank, g, 32, 64)
    with pytest.raises(ValueError, match="multiple"):
        mk.plan_ranks(rank[:1000], 512)
    mk.chunk_partials(rank, g, 512, 8, "highest")
    mk.row_gather_async(rank, g, 32, 8)
    assert mk.launch_counts() == {"chunk_partials": 0, "row_gather_async": 0}


def _rank_layout(layout, n, C, rng):
    """(rank, rcap): the rank layouts the card's partials kernels are
    tested on (tests/test_torch_cuda.py), each a window of rank rows a
    k16 step reaches that the plain version must sum the same way."""
    chunks = n // C
    if layout == "random":
        return rng.integers(0, 256, n), 256
    if layout == "descending":
        return np.tile(np.arange(C)[::-1] * 256 // C, chunks), 256
    if layout == "one_rank":
        return np.repeat(rng.integers(0, 256, chunks), C), 256
    if layout == "runs_of_15":
        return np.tile(np.arange(C) // 15, chunks), 256
    if layout == "outside":  # a sorted stream with ranks off both ends
        rank = np.tile(np.arange(C) // 9, chunks)
        bad = rng.random(n) < 0.1
        rank[bad] = rng.choice([-7, -1, 256, 300], int(bad.sum()))
        return rank, 256
    if layout == "passes":  # rcap 512
        return np.tile(np.arange(C) // 2, chunks), 512
    raise ValueError(layout)


@pytest.mark.parametrize("W", [8, 200])
@pytest.mark.parametrize("layout", ["random", "descending", "one_rank",
                                    "runs_of_15", "outside", "passes"])
@pytest.mark.parametrize("mode", mk.MODES)
def test_partials_rank_layouts_match_the_pallas_kernel(mp, mode, layout, W):
    """chunk_partials on the rank layouts of the card's tests (rcap 256
    and 512, ranks random, descending, one a chunk, in runs across rank
    tiles, off both ends) against make_pallas_segsum: within maxrel 1e-6,
    rows no entry reaches exactly zero."""
    C, n = 512, 2048
    rng = np.random.default_rng(len(layout) + W)
    rank_np, rcap = _rank_layout(layout, n, C, rng)
    rank = rank_np.astype(np.int32)
    g = rng.standard_normal((n, W)).astype(np.float32)
    got = mk.chunk_partials(torch.from_numpy(rank), torch.from_numpy(g), C,
                            rcap, mode)
    ref = mp.make_pallas_segsum(C, rcap, mode)(
        jnp.asarray(rank), _jax_g(g, mode), n // C, W)
    assert got.shape == ref.shape == (n // C, rcap, W)
    assert _maxrel(got, ref) <= 1e-6
    used = np.zeros((n // C, rcap), bool)
    ok = (rank >= 0) & (rank < rcap)
    used[(np.arange(n) // C)[ok], rank[ok]] = True
    assert not got.numpy()[~used].any()


@pytest.mark.parametrize("depth,want", [
    # (rows a stage, stages): stages of 32 rows, a shorter last one
    (1, (1, 1)), (3, (3, 1)), (8, (8, 1)), (31, (31, 1)), (32, (32, 1)),
    (33, (32, 2)), (128, (32, 4)), (256, (32, 8)), (257, (32, 9)),
])
def test_gather_shape(depth, want):
    """How the bulk gather cuts a launch: one warp a block, a block a
    chunk (a ragged last one), the ring's stages, and the shared memory:
    the ring, an 8-byte mbarrier a stage and the chunk's indices."""
    n, W, chunk = 40_000, 128, 1024
    sh = mk.gather_shape(n, W, chunk, depth)
    assert (sh["stage_rows"], sh["stages"]) == want
    assert sh["stage_rows"] * (sh["stages"] - 1) < depth <= \
        sh["stage_rows"] * sh["stages"]
    assert sh["threads"] == 32 and sh["blocks"] == 40
    assert sh["smem_bytes"] == depth * W * 4 + want[1] * 8 + chunk * 4


def test_gather_refuses_what_shared_memory_cannot_hold():
    """The ring and the chunk's staged indices must fit a block's shared
    memory (227 KB): the wrapper raises past it, on any device, and takes
    the benchmark's largest point, (4096, 256) at W = 128."""
    idx = torch.zeros(8192, dtype=torch.int32)
    tab = torch.zeros((4, 128))
    assert mk.gather_shape(8192, 128, 4096, 256)["smem_bytes"] <= \
        mk.SMEM_BYTES
    mk.row_gather_async(idx, tab, 4096, 256)
    with pytest.raises(ValueError, match="shared memory"):
        mk.row_gather_async(idx, tab, 8192, 400)  # a 200 KB ring + 32 KB
    with pytest.raises(ValueError, match="shared memory"):
        mk.row_gather_async(idx, torch.zeros((4, 4)), 8192 * 8, 8)
    big = mk.gather_shape(8192, 128, 8192, 400)["smem_bytes"]
    assert big == 400 * 512 + 13 * 8 + 8192 * 4 > mk.SMEM_BYTES


def test_kernel_info_asks_a_cuda_device():
    """kernel_info reads launch shapes from the card: it refuses an unknown
    kernel and a device that is not CUDA before loading anything."""
    with pytest.raises(ValueError, match="kind"):
        mk.kernel_info("tf32", 1 << 16, 128, 2048, 32)
    with pytest.raises(ValueError, match="CUDA"):
        mk.kernel_info("gather", 1 << 16, 128, 1024, 8, device="cpu")
