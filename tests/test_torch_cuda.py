"""The port's CUDA kernels against their plain PyTorch versions, and the
streamed trainer's resident corpus against its wire loader, on the
card. Every test here is marked `cuda` and skips without a CUDA device:
the kernels have no CPU mode. The card's host has no jax, and
tests/conftest.py imports it, so run this file there without the
conftest:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py

Counts must be exactly equal; float32 sums within rtol 1e-5, atol 1e-6:
both kernels sum floats in a fixed order of their own (no float atomics,
so two launches are bit-equal), other than the plain version's;
segsum_onehot accumulates them in float64, where a doc's catchword mass
is exact.
"""

import numpy as np
import pytest
import torch

from isle_tpu_torch import segsum
from torch_cases import gather_case, onehot_case, t

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda(dev, *arrays):
    return [None if a is None else t(a).to(dev) for a in arrays]


def _check_onehot(got, ref, with_val):
    torch.cuda.synchronize()
    if with_val:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    else:
        assert got.dtype == torch.int32 and torch.equal(got, ref)


@pytest.mark.parametrize("chunk", [256, 2048])
@pytest.mark.parametrize("with_val", [False, True])
def test_segsum_onehot_matches_plain(dev, with_val, chunk):
    seg, col, val, S, k = onehot_case(7, with_val)
    args = _cuda(dev, seg, col, val)
    before = segsum.segsum_onehot.launches
    got = segsum.segsum_onehot(*args, S, k, chunk=chunk)
    assert segsum.segsum_onehot.launches == before + 1
    _check_onehot(got, segsum.segsum_onehot_plain(*args, S, k), with_val)


def _onehot_stream(n, S, ncols, seed, with_val):
    """A sorted stream with a head segment of 30% of the entries (across
    many slices), the rest Zipf-spread over S segments, a tenth of the
    columns masked (-1) and a few entries outside [0, S] at both ends."""
    rng = np.random.default_rng(seed)
    seg = np.minimum((np.exp(rng.random(n) * np.log(S)) - 1).astype(
        np.int64), S - 1)
    seg[: int(0.3 * n)] = S // 3
    seg[:5] = -2
    seg[-5:] = S + 1
    seg = np.sort(seg).astype(np.int32)
    col = rng.integers(0, ncols, n).astype(np.int32)
    col[rng.random(n) < 0.1] = -1
    val = (rng.random(n) + 0.5).astype(np.float32) if with_val else None
    return seg, col, val


@pytest.mark.parametrize("with_val", [False, True])
@pytest.mark.parametrize("ncols", [1, 7, 100, 635, 824, 3000])
def test_segsum_onehot_every_path(dev, ncols, with_val):
    """Each window shape of the kernel's row window (1,024 cells of counts,
    512 of float sums): many rows (1, 7, 100 columns), one row (the ζ
    histogram's 635, and 824 on the bite corpus of synth.bite_counts) and
    column tiles (635, 824 and 3000 float sums; 3000 counts), against
    the plain version in float64."""
    S = 4_000
    seg, col, val = _onehot_stream(60_000, S, ncols, ncols, with_val)
    s, c, v = _cuda(dev, seg, col, val)
    got = segsum.segsum_onehot(s, c, v, S, ncols)
    if with_val:
        ref = segsum.segsum_onehot_plain(s, c, v.double(), S, ncols)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-6)
    else:
        _check_onehot(got, segsum.segsum_onehot_plain(s, c, None, S, ncols),
                      False)


@pytest.mark.parametrize("chunk", [7, 2048])
@pytest.mark.parametrize("with_val", [False, True])
def test_segsum_onehot_without_col(dev, with_val, chunk):
    """col=None (every entry in column 0, no column array read) equals a
    col of zeros and the plain version; float sums bit-equal across two
    launches."""
    S = 4_000
    seg, _, val = _onehot_stream(60_000, S, 1, 14, with_val)
    s, v = _cuda(dev, seg, val)
    zeros = torch.zeros_like(s)
    got = segsum.segsum_onehot(s, None, v, S, 1, chunk=chunk)
    _check_onehot(got, segsum.segsum_onehot_plain(s, None, v, S, 1),
                  with_val)
    assert torch.equal(got, segsum.segsum_onehot(s, zeros, v, S, 1,
                                                 chunk=chunk))
    assert torch.equal(got, segsum.segsum_onehot(s, None, v, S, 1,
                                                 chunk=chunk))


@pytest.mark.parametrize("with_val", [False, True])
@pytest.mark.parametrize("chunk", [1, 7, 256, 2048, 65536])
def test_segsum_onehot_any_chunk(dev, chunk, with_val):
    """Slices of one entry up to one slice for the whole stream."""
    S, k = 700, 9
    seg, col, val = _onehot_stream(20_000, S, k, 11, with_val)
    s, c, v = _cuda(dev, seg, col, val)
    init = None
    if with_val:
        init = torch.full((S + 1, k), 0.25, device=dev)
    got = segsum.segsum_onehot(s, c, v, S, k, init=init, chunk=chunk)
    _check_onehot(got, segsum.segsum_onehot_plain(s, c, v, S, k, init=init),
                  with_val)


@pytest.mark.parametrize("ncols", [1, 100])
def test_segsum_onehot_two_launches_bit_equal(dev, ncols):
    """No float atomics: the same input gives the same bits, on a head
    segment that crosses many slices (its parts added by the edge
    kernel in slice order)."""
    seg, col, val = _onehot_stream(400_000, 30_000, ncols, 12, True)
    args = _cuda(dev, seg, col, val)
    a = segsum.segsum_onehot(*args, 30_000, ncols)
    b = segsum.segsum_onehot(*args, 30_000, ncols)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _mass_stream(D, k, seed):
    """A doc-sorted catchword-mass stream as the trainers give it: docs of
    20-200 entries, values avg * (count / doc sum) with counts in [1, 7],
    two thirds of the columns masked (-1)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, 200, D)
    seg = np.repeat(np.arange(D, dtype=np.int32), lens)
    counts = rng.integers(1, 8, len(seg)).astype(np.float32)
    sums = np.add.reduceat(counts, np.concatenate([[0], np.cumsum(lens)[:-1]]))
    val = (np.float32(384.0) * (counts / np.repeat(sums, lens))).astype(
        np.float32)
    col = rng.integers(0, 3 * k, len(seg)).astype(np.int32)
    col[col >= k] = -1
    return seg, col, val, np.concatenate([[0], np.cumsum(lens)])


@pytest.mark.parametrize("with_init", [False, True])
def test_segsum_onehot_float_sums_are_the_exact_sum_rounded(dev, with_init):
    """Float sums accumulate in float64 and round once: on a doc-topic
    mass stream every cell equals the float64 sum rounded to float32, at
    every slice length and over any cut of the stream at doc boundaries
    (the streamed trainer's chunks, on local doc ids), so the in-core and
    the streamed mass are bit-equal."""
    D, k = 3_000, 100
    seg, col, val, off = _mass_stream(D, k, 15)
    s, c, v = _cuda(dev, seg, col, val)
    init = (torch.rand((D + 1, k), device=dev) if with_init else None)
    ref = segsum.segsum_onehot_plain(
        s, c, v.double(), D, k,
        init=None if init is None else init.double()).float()
    for chunk in (1, 7, 128, 2048, 65536):
        got = segsum.segsum_onehot(s, c, v, D, k, init=init, chunk=chunk)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), chunk
    parts = []
    for lo, hi in ((0, 777), (777, 1901), (1901, D)):
        a, b = int(off[lo]), int(off[hi])
        part_init = None if init is None else init[lo:hi + 1].contiguous()
        parts.append(segsum.segsum_onehot(
            s[a:b] - lo, c[a:b], v[a:b], hi - lo, k, init=part_init)[:hi - lo])
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts), ref[:D])


def test_segsum_onehot_empty_and_init(dev):
    """An empty stream launches nothing and returns zeros or init; init
    seeds the counts too and is not written in place."""
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    before = segsum.segsum_onehot.launches
    assert not segsum.segsum_onehot(z, z, None, 6, 4).any()
    init = torch.full((7, 4), 3.0, device=dev)
    assert torch.equal(segsum.segsum_onehot(z, z, z.float(), 6, 4,
                                            init=init), init)
    assert segsum.segsum_onehot.launches == before
    seg, col, _ = _onehot_stream(30_000, 900, 5, 13, False)
    s, c = _cuda(dev, seg, col)
    init = torch.randint(0, 50, (901, 5), dtype=torch.int32, device=dev)
    keep = init.clone()
    got = segsum.segsum_onehot(s, c, None, 900, 5, init=init, chunk=512)
    _check_onehot(got, segsum.segsum_onehot_plain(s, c, None, 900, 5,
                                                  init=init), False)
    assert torch.equal(init, keep)


@pytest.mark.parametrize("chunk", [256, 2048, 4096])
@pytest.mark.parametrize("W", [1, 5, 100, 128, 300])
def test_segsum_gather_rows_matches_plain(dev, W, chunk):
    seg, idx, val, table, S = gather_case(8, W=W)
    args = _cuda(dev, seg, idx, val, table)
    before = segsum.segsum_gather_rows.launches
    got = segsum.segsum_gather_rows(*args, S, chunk=chunk)
    assert segsum.segsum_gather_rows.launches == before + 1
    ref = segsum.segsum_gather_rows_plain(*args, S)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["one_run", "all_distinct", "spill_only",
                                    "outside"])
def test_extreme_streams(dev, layout):
    """One run across every chunk edge (the kernels' carries at both ends
    of every slice), a new segment at every entry, a stream that is all
    spill row, and one whose segments run from below 0 to past the spill
    row; a tenth of the gather indices lie outside the table."""
    n, S, k, W = 5000, 6000, 3, 40
    rng = np.random.default_rng(1)
    seg = {"one_run": np.full(n, 17), "all_distinct": np.arange(n),
           "spill_only": np.full(n, S),
           "outside": np.linspace(-300, S + 300, n).astype(np.int64),
           }[layout].astype(np.int32)
    col = rng.integers(0, k, n).astype(np.int32)
    val = rng.random(n).astype(np.float32)
    table = rng.random((50, W)).astype(np.float32)
    idx = rng.integers(-3, 53, n).astype(np.int32)
    s, c, v, i, tb = _cuda(dev, seg, col, val, idx, table)
    for with_val in (False, True):
        vv = v if with_val else None
        _check_onehot(segsum.segsum_onehot(s, c, vv, S, k, chunk=512),
                      segsum.segsum_onehot_plain(s, c, vv, S, k), with_val)
    got = segsum.segsum_gather_rows(s, i, v, tb, S, chunk=512)
    ref = segsum.segsum_gather_rows_plain(s, i, v, tb, S)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_init_carry_and_checks(dev):
    seg, col, val, S, k = onehot_case(3, True)
    s, c, v = _cuda(dev, seg, col, val)
    init = torch.full((S + 1, k), 2.0, device=dev)
    got = segsum.segsum_onehot(s, c, v, S, k, init=init)
    torch.testing.assert_close(got, segsum.segsum_onehot(s, c, v, S, k) + 2.0)
    assert torch.all(init == 2.0)
    with pytest.raises(ValueError, match="col"):
        segsum.segsum_onehot(s, c.cpu(), v, S, k)
    seg, idx, val, table, S = gather_case(4)
    s, i, v, tb = _cuda(dev, seg, idx, val, table)
    init = torch.full((S + 1, tb.shape[1]), -1.5, device=dev)
    got = segsum.segsum_gather_rows(s, i, v, tb, S, init=init)
    torch.testing.assert_close(
        got, segsum.segsum_gather_rows_plain(s, i, v, tb, S, init=init))
    assert torch.all(init == -1.5)
    with pytest.raises(ValueError, match="chunk"):
        segsum.segsum_gather_rows(s, i, v, tb, S, chunk=0)
    with pytest.raises(ValueError, match="table"):
        segsum.segsum_gather_rows(s, i, v, tb.cpu(), S)


def _zipf_stream(n, S, rows, seed):
    """A sorted stream whose head segment holds 40% of the entries (a Zipf
    head word), the rest Zipf-spread over S segments."""
    rng = np.random.default_rng(seed)
    seg = np.minimum((np.exp(rng.random(n) * np.log(S)) - 1).astype(
        np.int64), S - 1)
    seg[: int(0.4 * n)] = 3
    seg = np.sort(seg).astype(np.int32)
    idx = rng.integers(0, rows, n).astype(np.int32)
    val = (rng.random(n) + 0.5).astype(np.float32)
    return seg, idx, val


def test_gather_rows_run_across_many_slices(dev):
    """A head segment of 80,000 entries crosses 156 slices of 512: its sum
    is the carry kernel's, added in slice order."""
    n, S, rows, W = 200_000, 5_000, 3_000, 100
    seg, idx, val = _zipf_stream(n, S, rows, 4)
    table = np.random.default_rng(5).random((rows, W)).astype(np.float32)
    s, i, v, tb = _cuda(dev, seg, idx, val, table)
    got = segsum.segsum_gather_rows(s, i, v, tb, S, chunk=512)
    ref = segsum.segsum_gather_rows_plain(s, i, v.double(), tb.double(), S)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernel", ["wide", "tiled"])
@pytest.mark.parametrize("chunk", [2048, 65536])
def test_gather_rows_long_runs_of_equal_values(dev, kernel, chunk):
    """The bite corpus's B onehot (synth.bite_counts): runs of up to 2,048
    entries of one irrational value each (a word's sqrt(ζ)) against a 0/1
    table, within 1e-5 |B| |X| of the float64 sum. Summed in one float32
    chain a slice, such runs drift up to 2.7e-5; the kernel's chains are
    at most a staged batch long (tests/test_torch_bite.py)."""
    rng = np.random.default_rng(16)
    zetas = np.array([2, 3, 5, 6, 7, 8, 10, 11, 12, 13, 708], np.float32)
    lens = rng.integers(1_500, 2_049, len(zetas))
    seg = np.repeat(np.arange(len(zetas)), lens).astype(np.int32)
    val = np.repeat(np.sqrt(zetas), lens).astype(np.float32)
    D, k = 30_000, 4
    idx = np.concatenate([np.sort(rng.choice(D, n, replace=False))
                          for n in lens]).astype(np.int32)
    onehot = np.zeros((D, k), np.float32)
    onehot[np.arange(D), (np.arange(D) * 7 // D) % k] = 1.0
    s, i, v, tb = _cuda(dev, seg, idx, val, onehot)
    S = len(zetas)
    if kernel == "tiled":
        got = segsum.segsum_gather_rows_tiled(s, i, v, tb, S,
                                              [0, seg.size], chunk=chunk)
    else:
        got = segsum.segsum_gather_rows(s, i, v, tb, S, chunk=chunk,
                                        kernel="wide")
    _within_abs_bound(got, s, i, v, tb, S)


@pytest.mark.parametrize("W", [7, 128])
def test_gather_rows_two_launches_bit_equal(dev, W):
    """No float atomics: the same input gives the same bits."""
    seg, idx, val = _zipf_stream(300_000, 20_000, 10_000, 6)
    table = np.random.default_rng(7).normal(size=(10_000, W)).astype(
        np.float32)
    args = _cuda(dev, seg, idx, val, table)
    a = segsum.segsum_gather_rows(*args, 20_000)
    b = segsum.segsum_gather_rows(*args, 20_000)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_gather_rows_empty_stream(dev):
    z = torch.zeros(0, dtype=torch.int32, device=dev)
    tb = torch.ones((4, 8), device=dev)
    before = segsum.segsum_gather_rows.launches
    got = segsum.segsum_gather_rows(z, z, z.float(), tb, 6)
    assert segsum.segsum_gather_rows.launches == before
    assert got.shape == (7, 8) and not got.any()
    init = torch.full((7, 8), 3.0, device=dev)
    assert torch.equal(segsum.segsum_gather_rows(z, z, z.float(), tb, 6,
                                                 init=init), init)


def _narrow_stream(n, S, rows, seed):
    """_zipf_stream with a tenth of the gather indices outside the table
    and a few entries in segments below 0 and past the spill row S."""
    seg, idx, val = _zipf_stream(n, S, rows, seed)
    rng = np.random.default_rng(seed + 1)
    bad = rng.random(n) < 0.1
    idx[bad] = rng.choice([-5, -1, rows, rows + 7], int(bad.sum()))
    seg[:5] = -2
    seg[-5:] = S + 3
    return seg, idx, val


def _within_abs_bound(got, s, i, v, tb, S, init=None):
    """got within 1e-5 |B| |X| (+ |init|) of the float64 plain version."""
    ref = segsum.segsum_gather_rows_plain(
        s, i, v.double(), tb.double(), S,
        init=None if init is None else init.double())
    bound = segsum.segsum_gather_rows_plain(
        s, i, v.double().abs(), tb.double().abs(), S,
        init=None if init is None else init.double().abs())
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    err = (got.double() - ref).abs()
    assert bool((err <= 1e-5 * bound).all()), float(err.max())


@pytest.mark.parametrize("chunk", [7, 256, 2048])
@pytest.mark.parametrize("W", [1, 2, 3, 4, 8, 16])
def test_narrow_kernel_matches_plain(dev, W, chunk):
    """segsum_gather_rows_narrow_kernel: runs across batch and slice edges
    (a head segment of 40% of the entries), indices outside the table,
    segments outside [0, S], with and without init; two launches
    bit-equal."""
    n, S, rows = 60_000, 4_000, 2_500
    seg, idx, val = _narrow_stream(n, S, rows, 11)
    table = np.random.default_rng(12).normal(size=(rows, W)).astype(
        np.float32)
    s, i, v, tb = _cuda(dev, seg, idx, val, table)
    init = torch.from_numpy(np.random.default_rng(13).normal(
        size=(S + 1, W)).astype(np.float32)).to(dev)
    for start in (None, init):
        before = segsum.launch_counts()
        got = segsum.segsum_gather_rows_narrow(s, i, v, tb, S, init=start,
                                               chunk=chunk)
        after = segsum.launch_counts()
        assert after["segsum_gather_rows_narrow"] == \
            before["segsum_gather_rows_narrow"] + 1
        assert after["segsum_gather_rows"] == before["segsum_gather_rows"] + 1
        _within_abs_bound(got, s, i, v, tb, S, start)
        again = segsum.segsum_gather_rows_narrow(s, i, v, tb, S, init=start,
                                                 chunk=chunk)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
    assert torch.equal(init, init.clone())


@pytest.mark.parametrize("layout", ["one_run", "all_distinct", "spill_only",
                                    "outside"])
@pytest.mark.parametrize("W", [1, 4])
def test_narrow_kernel_extreme_streams(dev, layout, W):
    """test_extreme_streams's streams on the narrow kernel, at a slice of
    512 entries and of 7 (shorter than a lane's batch)."""
    n, S = 5000, 6000
    rng = np.random.default_rng(2)
    seg = {"one_run": np.full(n, 17), "all_distinct": np.arange(n),
           "spill_only": np.full(n, S),
           "outside": np.linspace(-300, S + 300, n).astype(np.int64),
           }[layout].astype(np.int32)
    val = rng.random(n).astype(np.float32)
    table = rng.random((50, W)).astype(np.float32)
    idx = rng.integers(-3, 53, n).astype(np.int32)
    s, v, i, tb = _cuda(dev, seg, val, idx, table)
    for chunk in (512, 7):
        got = segsum.segsum_gather_rows_narrow(s, i, v, tb, S, chunk=chunk)
        _within_abs_bound(got, s, i, v, tb, S)


def test_dispatch_takes_the_narrow_kernel_at_width_one(dev):
    seg, idx, val, table, S = gather_case(8, W=1)
    args = _cuda(dev, seg, idx, val, table)
    before = segsum.launch_counts()
    got = segsum.segsum_gather_rows(*args, S)
    after = segsum.launch_counts()
    assert {k_: after[k_] - before[k_] for k_ in after} == {
        "segsum_onehot": 0, "segsum_gather_rows": 1,
        "segsum_gather_rows_narrow": 1, "segsum_gather_rows_tiled": 0}
    _within_abs_bound(got, *args, S)
    wide = segsum.segsum_gather_rows(*args, S, kernel="wide")
    _within_abs_bound(wide, *args, S)


def _tiled_sparse(dev, V=3_000, D=20_000, nnz=400_000, seed=14):
    from isle_tpu_torch import sparse

    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, D, nnz) * V
                    + np.minimum((np.exp(rng.random(nnz) * np.log(V)) - 1)
                                 .astype(np.int64), V - 1))
    d, w = key // V, key % V
    val = (rng.random(key.size) * 3 + 0.1).astype(np.float32)
    return sparse.DocSparse.from_doc_sorted(w, d, val, V, D, dev)


@pytest.mark.parametrize("W", [5, 100, 128])
def test_tiled_passes_match_the_untiled_kernel(dev, W):
    """segsum_gather_rows_tiled over doc tiles of 3,000 docs (7 tiles) on
    the card: within 1e-5 |B| |X| of the untiled kernel and of the plain
    version chained over the tiles, two runs bit-equal; sparse.b_y takes
    it on a tiled layout."""
    from isle_tpu_torch import sparse

    sp = sparse.with_doc_tiles(_tiled_sparse(dev), 3_000)
    assert len(sp.tile_starts) == 8
    Y = torch.from_numpy(np.random.default_rng(W).normal(
        size=(sp.num_docs, W)).astype(np.float32)).to(dev)
    args = (sp.t_word, sp.t_doc, sp.t_val, Y, sp.vocab, sp.tile_starts)
    before = segsum.launch_counts()
    got = segsum.segsum_gather_rows_tiled(*args)
    after = segsum.launch_counts()
    assert after["segsum_gather_rows_tiled"] == \
        before["segsum_gather_rows_tiled"] + 1
    assert after["segsum_gather_rows"] == before["segsum_gather_rows"] + 1
    again = segsum.segsum_gather_rows_tiled(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    w_stream = (sp.w_word, sp.w_doc, sp.w_val)
    _within_abs_bound(got, *w_stream, Y, sp.vocab)
    untiled = segsum.segsum_gather_rows(*w_stream, Y, sp.vocab,
                                        kernel="wide")
    bound = segsum.segsum_gather_rows_plain(
        *w_stream[:2], w_stream[2].double().abs(), Y.double().abs(),
        sp.vocab)
    assert bool(((got.double() - untiled.double()).abs()
                 <= 1e-5 * bound).all())
    plain = segsum.segsum_gather_rows_tiled_plain(*args)
    assert bool(((got.double() - plain.double()).abs()
                 <= 1e-5 * bound).all())
    init = torch.full_like(got, 0.25)
    with_init = segsum.segsum_gather_rows_tiled(*args, init=init)
    torch.testing.assert_close(with_init, got + 0.25, rtol=1e-6, atol=1e-5)
    if W > segsum.NARROW_MAX_WIDTH:
        before = segsum.launch_counts()
        via = sparse.b_y(sp, Y)
        assert segsum.launch_counts()["segsum_gather_rows_tiled"] == \
            before["segsum_gather_rows_tiled"] + 1
        assert torch.equal(via, got[:sp.vocab])


def test_spmm_on_the_card_matches_plain(dev):
    """sparse.bt_x and sparse.b_y launch the kernel; each element within
    1e-5 of |B| |X| (the plain version on absolute values, in float64) of
    the plain version, since a Krylov block has mixed signs."""
    from isle_tpu_torch import sparse

    rng = np.random.default_rng(8)
    V, D, nnz = 3_000, 4_000, 150_000
    key = np.unique(rng.integers(0, D, nnz) * V
                    + np.minimum((np.exp(rng.random(nnz) * np.log(V)) - 1)
                                 .astype(np.int64), V - 1))
    d, w = key // V, key % V
    dv = (rng.random(key.size) * 3).astype(np.float32)
    order = np.lexsort((d, w))
    sp = sparse.DocSparse(
        *(torch.from_numpy(a).to(dev) for a in (
            w.astype(np.int32), d.astype(np.int32), dv,
            w[order].astype(np.int32), d[order].astype(np.int32),
            dv[order])), vocab=V, num_docs=D)
    X = torch.from_numpy(rng.normal(size=(V, 128)).astype(np.float32)).to(dev)
    Y = torch.from_numpy(rng.normal(size=(D, 100)).astype(np.float32)).to(dev)
    cases = (
        (sparse.bt_x, X, (sp.d_doc, sp.d_word, sp.d_val), D),
        (sparse.b_y, Y, (sp.w_word, sp.w_doc, sp.w_val), V),
    )
    for fn, T, (s, i, v), S in cases:
        before = segsum.segsum_gather_rows.launches
        got = fn(sp, T)
        assert segsum.segsum_gather_rows.launches == before + 1
        ref = segsum.segsum_gather_rows_plain(s, i, v.double(), T.double(),
                                              S)[:S]
        bound = segsum.segsum_gather_rows_plain(
            s, i, v.double().abs(), T.double().abs(), S)[:S]
        torch.cuda.synchronize()
        assert got.shape == ref.shape
        assert bool(((got.double() - ref).abs() <= 1e-5 * bound).all())


def _binary_head(rng, R, D, dev, density=0.05):
    from isle_tpu_torch.hybrid import _alloc_head

    head = _alloc_head(R, D, dev)
    head.copy_(torch.from_numpy(rng.random((R, D)) < density))
    return head


@pytest.mark.parametrize("block", [32768, 1000])
@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("W", [1, 3, 100, 128])
def test_head_dot_on_the_card_is_float32_exact(dev, W, transpose, block,
                                               monkeypatch):
    """The head product on the tensor cores (one bf16 GEMM, float32 out,
    over the three bf16 pieces of the operand): each element within 2e-6
    of |head| |X| of the float64 product (float32 summation of the 35 to
    150 nonzero terms of a row; the pieces themselves hold the operand to
    2^-24), two launches bit-equal; head Y also summed over 4 blocks of
    docs (hybrid.HEAD_DOC_BLOCK)."""
    from isle_tpu_torch import hybrid

    monkeypatch.setattr(hybrid, "HEAD_DOC_BLOCK", block)

    rng = np.random.default_rng(W)
    R, D = 700, 3001  # an odd doc count: the head's stride is padded
    head = _binary_head(rng, R, D, dev)
    assert head.dtype == torch.bfloat16 and head.stride(0) % 8 == 0
    n = R if transpose else D
    X = torch.from_numpy((rng.standard_normal((n, W))
                          * 10.0 ** rng.uniform(-3, 3, (n, 1)))
                         .astype(np.float32)).to(dev)
    calls = hybrid.head_dot.calls
    got = hybrid.head_dot(head, X, transpose)
    assert hybrid.head_dot.calls == calls + 1
    again = hybrid.head_dot(head, X, transpose)
    h64 = head.double()
    a = h64.T if transpose else h64
    ref, scale = a @ X.double(), a @ X.double().abs()
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert bool(((got.double() - ref).abs() <= 2e-6 * scale).all())


def test_hybrid_products_on_the_card_match_the_cpu(dev):
    """A partial-head layout built on the card equals the CPU's, and its
    products launch the tail's kernels and the head GEMM: within 1e-5 of
    |B| |X| of the CPU's plain products."""
    from isle_tpu_torch import hybrid, matops, sparse

    rng = np.random.default_rng(9)
    V, D, nnz = 2_000, 3_001, 120_000
    key = np.unique(rng.integers(0, D, nnz) * V
                    + np.minimum((np.exp(rng.random(nnz) * np.log(V)) - 1)
                                 .astype(np.int64), V - 1))
    d, w = key // V, key % V
    scale = (rng.random(V) * 3 + 0.5).astype(np.float32)
    layouts = {}
    for device in ("cpu", dev):
        sp = sparse.DocSparse.from_doc_sorted(w, d, scale[w], V, D, device)
        layouts[str(device)] = hybrid.to_hybrid(
            sp, 150, torch.from_numpy(scale).to(device))
    c, g = layouts["cpu"], layouts[str(dev)]
    assert torch.equal(g.head_words.cpu(), c.head_words)
    assert torch.equal(g.head.cpu(), c.head) and g.head_nnz == c.head_nnz
    assert 0 < g.head_nnz < g.nnz
    X = rng.standard_normal((V, 128)).astype(np.float32)
    Y = rng.standard_normal((D, 100)).astype(np.float32)
    absB = hybrid.split_by_head(
        sparse.DocSparse.from_doc_sorted(w, d, np.abs(scale[w]), V, D, "cpu"),
        c.head_words, torch.from_numpy(np.abs(scale)))
    for fn, T in ((matops.mat_bt_x, X), (matops.mat_b_y, Y),
                  (lambda m, _: matops.mat_doc_l2sq(m)[:, None], None)):
        before = (segsum.launch_counts(), hybrid.head_dot.calls)
        got = fn(g, None if T is None else torch.from_numpy(T).to(dev))
        after = (segsum.launch_counts(), hybrid.head_dot.calls)
        assert after[1] == before[1] + 1
        assert sum(after[0].values()) == sum(before[0].values()) + 1
        ref = fn(c, None if T is None else torch.from_numpy(T)).double()
        bound = (fn(absB, None if T is None else torch.from_numpy(np.abs(T)))
                 .double())
        torch.cuda.synchronize()
        assert bool(((got.cpu().double() - ref).abs() <= 1e-5 * bound).all())


def test_head_past_the_cap_on_the_card_matches_the_cpu(dev):
    """GpuConfig.break_head_cap's layout: 150 head rows at a flat_cap
    whose cap is 49 rows, built on the card (the int64 index_put_ of
    split_by_head) equal to the CPU's, the head bit for bit; without the
    switch both build the 49 rows of the cap."""
    from isle_tpu_torch import hybrid, sparse

    rng = np.random.default_rng(10)
    V, D, nnz = 2_000, 3_001, 120_000
    key = np.unique(rng.integers(0, D, nnz) * V
                    + np.minimum((np.exp(rng.random(nnz) * np.log(V)) - 1)
                                 .astype(np.int64), V - 1))
    d, w = key // V, key % V
    scale = (rng.random(V) * 3 + 0.5).astype(np.float32)
    flat = 50 * (D + 1)
    assert hybrid.max_head_rows(D, flat) == 49
    for cap_off, rows in ((True, 150), (False, 49)):
        layouts = {}
        for device in ("cpu", dev):
            sp = sparse.DocSparse.from_doc_sorted(w, d, scale[w], V, D,
                                                  device)
            layouts[str(device)] = hybrid.to_hybrid(
                sp, 150, torch.from_numpy(scale).to(device), flat_cap=flat,
                break_head_cap=cap_off)
        c, g = layouts["cpu"], layouts[str(dev)]
        assert g.num_head == c.num_head == rows
        assert torch.equal(g.head_words.cpu(), c.head_words)
        assert torch.equal(g.head.cpu(), c.head)
        assert g.head_nnz == c.head_nnz and 0 < g.head_nnz < g.nnz
        assert torch.equal(g.tail.d_word.cpu(), c.tail.d_word)
        assert torch.equal(g.tail.w_doc.cpu(), c.tail.w_doc)


def _exact_corpus():
    """(corpus, k): every doc's counts add up to 64, the corpus's average,
    so each normalized value is its count and each catchword mass an
    integer sum, exact in float32 whatever the order of the sum."""
    from isle_tpu_torch import Corpus

    rng = np.random.default_rng(0)
    V, D, k = 300, 600, 5
    d = np.repeat(np.arange(D), 25)
    w = np.where(rng.random(d.size) < 0.7,
                 rng.integers(0, V // k, d.size) + (d % k) * (V // k),
                 rng.integers(0, V, d.size))
    key = np.unique(d * V + w)
    d, w = key // V, key % V
    # one count a word, the rest of the doc's 64 spread over its words
    per_doc = np.bincount(d, minlength=D)
    counts = 1 + np.concatenate([rng.multinomial(64 - m, np.full(m, 1 / m))
                                 for m in per_doc])
    corpus = Corpus.from_entries(d, w, counts, vocab_size=V, num_docs=D)
    assert corpus.avg_doc_sz == 64
    np.testing.assert_array_equal(corpus.vals, counts)
    return corpus, k


@pytest.mark.parametrize("head_bytes", [0, 40_000, 4096 << 20])
def test_trainer_on_the_card_matches_the_cpu(dev, tmp_path, head_bytes):
    """The whole slice on the card (both kernels launched) against the same
    slice on the CPU with the plain versions, on the corpus of exact
    masses: the card's masses equal the CPU's bit for bit, two topics
    that tie tie on both and both take the first (argmax), so the top-two
    topics and the edge topics must match. B in the COO layout, the
    hybrid one with a partial head, and the default (every word in the
    head at this size)."""
    from isle_tpu_torch import GpuConfig, TrainConfig, Trainer

    corpus, k = _exact_corpus()
    cfg = TrainConfig(num_topics=k, seed=2, compute_edge_topics=True,
                      max_edge_topics=8)
    runs = {}
    segsum.reset_launch_counts()
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg, output_dir=str(tmp_path / device), quiet=True,
                     gpu=GpuConfig(device=device,
                                   dense_head_bytes=head_bytes))
        tr.load_corpus(corpus)
        tr.train()
        tr.train_edge_topics()
        runs[device] = tr
        if device == "cuda":
            counts = segsum.launch_counts()
            assert counts["segsum_onehot"] >= 3, counts
            assert counts["segsum_gather_rows"] >= 1, counts
    g, c = runs["cuda"], runs["cpu"]
    np.testing.assert_array_equal(g.cluster_of_doc, c.cluster_of_doc)
    np.testing.assert_allclose(g.evalues, c.evalues, rtol=1e-4)
    np.testing.assert_allclose(g.model, c.model, rtol=1e-4, atol=1e-6)
    for a, b in zip(g.top_pairs, c.top_pairs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g.edge_pairs, c.edge_pairs)
    np.testing.assert_allclose(g.edge_model, c.edge_model, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("head_bytes", [0, 40_000])
def test_trainer_with_tiles_on_the_card_matches_the_cpu(
        dev, tmp_path, monkeypatch, head_bytes):
    """test_trainer_on_the_card_matches_the_cpu's COO and partial-head
    hybrid runs with B (or the tail) in doc tiles of 128 (5 tiles): the
    card's B Y runs the tiled passes and the results equal the CPU
    run's."""
    from isle_tpu_torch import GpuConfig, TrainConfig, Trainer, sparse

    monkeypatch.setattr(sparse, "DOC_TILE", 128)
    corpus, k = _exact_corpus()
    cfg = TrainConfig(num_topics=k, seed=2, compute_edge_topics=True,
                      max_edge_topics=8)
    runs = {}
    for device in ("cuda", "cpu"):
        segsum.reset_launch_counts()
        tr = Trainer(cfg, output_dir=str(tmp_path / device), quiet=True,
                     gpu=GpuConfig(device=device,
                                   dense_head_bytes=head_bytes))
        tr.load_corpus(corpus)
        tr.train()
        tr.train_edge_topics()
        runs[device] = (tr, segsum.launch_counts())
    (g, counts), (c, _) = runs["cuda"], runs["cpu"]
    assert counts["segsum_gather_rows_tiled"] >= 1, counts
    np.testing.assert_array_equal(g.cluster_of_doc, c.cluster_of_doc)
    np.testing.assert_allclose(g.evalues, c.evalues, rtol=1e-4)
    np.testing.assert_allclose(g.model, c.model, rtol=1e-4, atol=1e-6)
    for a, b in zip(g.top_pairs, c.top_pairs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g.edge_pairs, c.edge_pairs)


def test_sharded_trainer_on_the_card_matches_the_single_device_one(
        dev, tmp_path):
    """The sharded trainer at world size 1 (a mesh without a group) on the
    card: each stage launches exactly what the single-device stage
    launches, and the results are its results bit for bit."""
    from isle_tpu_torch import GpuConfig, TrainConfig, Trainer
    from isle_tpu_torch.sharding import Mesh

    corpus, k = _exact_corpus()
    cfg = TrainConfig(num_topics=k, seed=2, compute_edge_topics=True,
                      max_edge_topics=8)
    runs = {}
    for name, mesh in (("single", None), ("sharded", Mesh("cuda"))):
        segsum.reset_launch_counts()
        tr = Trainer(cfg, output_dir=str(tmp_path / name), quiet=True,
                     gpu=GpuConfig(device="cuda"), mesh=mesh)
        tr.load_corpus(corpus)
        tr.train()
        runs[name] = (tr, segsum.launch_counts())
    (g, g_counts), (c, c_counts) = runs["sharded"], runs["single"]
    # the single-device B stage also logs Frob(B): one more doc-norm launch
    assert g_counts["segsum_gather_rows"] == c_counts["segsum_gather_rows"]
    assert g_counts["segsum_onehot"] == c_counts["segsum_onehot"] - 1
    np.testing.assert_array_equal(g.original_cols, c.original_cols)
    np.testing.assert_array_equal(g.cluster_of_doc, c.cluster_of_doc)
    np.testing.assert_array_equal(g.evalues, c.evalues)
    np.testing.assert_array_equal(g.model, c.model)
    for a, b in zip(g.top_pairs, c.top_pairs):
        np.testing.assert_array_equal(a, b)


def test_kmeanspp_seeds_are_reproducible_on_the_card(dev):
    """k-means++ on 300,000 projected docs, the same draws five times: the
    same seeds and residual each time. torch.cumsum on the card adds its
    tiles in an order that changes from launch to launch, which is why
    the seeding takes its cumulative sum on the host; and the projected
    Lloyd's from those seeds ends in the same centers, bit for bit."""
    from isle_tpu_torch import kmeans
    from isle_tpu_torch.rng import Draws

    g = torch.Generator().manual_seed(3)
    P = torch.randn((8, 300_000), generator=g).to(dev)
    runs = []
    for _ in range(5):
        idx, centers, residual = kmeans.kmeans_init_on_projected(
            P, 50, 1, Draws(7))
        centers, assign = kmeans.run_lloyds_projected(P, centers, 3)
        runs.append((idx, residual, centers, assign))
    for idx, residual, centers, assign in runs[1:]:
        assert torch.equal(idx, runs[0][0]) and residual == runs[0][1]
        assert torch.equal(centers, runs[0][2])
        assert torch.equal(assign, runs[0][3])


def test_mwu_on_the_card_matches_the_cpu(dev):
    """MWU inference (plain PyTorch on the card: isle_tpu's MWU is XLA,
    not Pallas) against the same call on the CPU, with a tiny Lf on half
    the runs so that the float32 overflow retries happen on the card."""
    from isle_tpu_torch import Corpus, mwu

    rng = np.random.default_rng(3)
    V, D, k = 500, 400, 12
    M = rng.random((V, k)).astype(np.float32)
    M[M < 0.6] = 0.0
    M /= M.sum(axis=0, keepdims=True)
    d = np.repeat(np.arange(D), rng.integers(1, 90, D))
    key = np.unique(d * V + rng.integers(0, V, d.size))
    corpus = Corpus.from_entries(key // V, key % V,
                                 rng.integers(1, 6, key.size), vocab_size=V,
                                 num_docs=D, normalize_to_one=True)
    batch = mwu.build_infer_batch(corpus, M.sum(axis=1))
    for Lf, top_n in ((10.0, 0), (10.0, 5), (1e-3, 0)):
        g = mwu.infer_all(M, batch, 15, Lf, top_n=top_n, device=dev)
        c = mwu.infer_all(M, batch, 15, Lf, top_n=top_n, device="cpu")
        np.testing.assert_array_equal(g[1], c[1])
        for a, b in zip((g[0], g[2], g[3]), (c[0], c[2], c[3])):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


THRESHOLD = np.float32(1e-10)


def _pack_case(name):
    """(model mass (V,) float32, unit-mass corpus) of one case of the card
    pack. Every case has words of mass exactly float32(1e-10) (0-4,
    dropped) and the next float32 above it (5-9, kept), about 10% of the
    other words without mass, and docs holding each."""
    from isle_tpu_torch import Corpus

    rng = np.random.default_rng(
        {"short": 1, "long": 2, "pad_to": 3, "pubmed_vocab": 4,
         "wide_table": 5}[name])
    V = {"short": 500, "long": 5000, "pad_to": 500, "pubmed_vocab": 141_043,
         "wide_table": 500_000}[name]
    mass = rng.random(V).astype(np.float32)
    mass[rng.random(V) < 0.1] = 0.0
    mass[:5] = THRESHOLD
    mass[5:10] = np.nextafter(THRESHOLD, np.float32(1.0))
    kept_words = np.flatnonzero(mass > 1e-10)
    if name == "short":  # empty docs, a doc that keeps no word
        lengths = rng.integers(0, 40, 300)
        lengths[[0, 150, 299]] = 0
    elif name == "long":  # docs past a warp's 32 entries and 1,024
        lengths = rng.integers(1, 80, 400)
        lengths[[3, 7, 100, 399]] = [33, 1025, 1500, 3000]
    elif name == "pad_to":  # the widest doc keeps 64: L lands on pad_to
        lengths = rng.integers(1, 60, 300)
    else:
        lengths = rng.integers(1, 200, 3000)
    docs, words = [], []
    for d, n in enumerate(lengths):
        if name == "pad_to" and d == 17:
            ws = rng.choice(kept_words, 64, replace=False)
        elif d == 1:  # a doc that keeps no word
            ws = np.concatenate([np.arange(5), np.flatnonzero(mass == 0)[:9]])
        else:
            ws = rng.choice(V, n, replace=False)
            if d % 5 == 2:
                ws = np.union1d(ws, [2, 7])
        docs += [d] * len(ws)
        words += sorted(ws.tolist())
    corpus = Corpus.from_entries(
        np.array(docs), np.array(words), rng.integers(1, 7, len(words)),
        vocab_size=V, num_docs=len(lengths), normalize_to_one=True)
    return mass, corpus


@pytest.mark.parametrize("name", ["short", "long", "pad_to", "pubmed_vocab",
                                  "wide_table"])
def test_pack_on_the_card_matches_the_host(dev, name):
    """build_infer_batch on the card (pack_kept_lengths_kernel, then
    pack_fill_kernel, one launch each) against the host's numpy pack:
    every doc's row (bit for bit, the card's bucket rows widened to the
    host's (D, L)), the kept lengths and L exactly equal, and the card
    holding no slot beyond the buckets' rows. The
    cases: empty docs, a doc that keeps no word, words at the threshold
    and just above it, docs longer than 32 and 1,024 entries, a widest
    doc of 64 kept entries (L on pad_to), PubMed's vocabulary (a table of
    17.6 KB) and 500,000 words (62.5 KB: past the 48 KB default)."""
    from isle_tpu_torch import mwu, pack

    mass, corpus = _pack_case(name)
    host = mwu.build_infer_batch(corpus, mass)
    k0, f0 = pack.pack_kept_lengths.launches, pack.pack_fill.launches
    card = mwu.build_infer_batch(corpus, mass, device=dev)
    torch.cuda.synchronize()
    assert pack.pack_kept_lengths.launches == k0 + 1
    assert pack.pack_fill.launches == f0 + 1
    assert card.word_idx.device.type == "cuda" and card.a.is_cuda
    assert card.width == host.word_idx.shape[1]
    assert card.word_idx.dtype == torch.int32 and card.a.dtype == torch.float32
    assert card.word_idx.numel() == card.a.numel() == sum(
        edge * len(sel)
        for edge, sel in mwu.length_buckets(host.kept_len, card.width))
    wi, a = mwu.padded_rows(card, corpus.vocab_size)
    np.testing.assert_array_equal(wi, host.word_idx)
    np.testing.assert_array_equal(a.view(np.int32), host.a.view(np.int32))
    np.testing.assert_array_equal(card.kept_len, host.kept_len)
    np.testing.assert_array_equal(card.words_in_doc, host.words_in_doc)
    assert card.num_docs == host.num_docs
    assert card.avg_doc_sz == host.avg_doc_sz
    if name == "pad_to":
        assert host.kept_len.max() == 64 == host.word_idx.shape[1]
    if name == "short":
        assert (np.diff(corpus.offsets) == 0).sum() >= 3
    assert host.kept_len[1] == 0  # the doc that keeps no word
    w = host.word_idx
    assert not np.isin(w, np.arange(5)).any() and np.isin(w, [7]).any()
    if name == "long":  # one wide doc does not widen the others' rows
        assert host.kept_len.max() > 1024
        assert card.word_idx.numel() < host.word_idx.size // 4


def test_pack_on_the_card_plain_version_and_checks(dev):
    """The wrappers on CUDA tensors against their plain versions on the
    same tensors: rows of one width for every doc, narrower than the
    widest doc (its entries past the width left out alike) and wider,
    rows of each doc's own width in reverse doc order, and no docs at
    all."""
    from isle_tpu_torch import pack

    mass, corpus = _pack_case("long")
    table = torch.from_numpy(pack.keep_table(mass))
    off = torch.from_numpy(corpus.offsets.astype(np.int64))
    rows = torch.from_numpy(corpus.rows)
    vals = torch.from_numpy(corpus.vals)
    V = corpus.vocab_size
    on = [x.to(dev) for x in (off, rows, vals, table)]
    kept = pack.pack_kept_lengths(on[0], on[1], on[3], V)
    assert torch.equal(kept.cpu(), pack.pack_kept_lengths_plain(
        off, rows, table, V))
    D = corpus.num_docs
    own = (kept.cpu() + 5).to(torch.int32)  # each doc's count and 5 pads
    reverse = torch.cumsum(own.flip(0).to(torch.int64), 0).flip(0) - own
    layouts = [(torch.arange(D) * w, torch.full((D,), w, dtype=torch.int32),
                D * w) for w in (8, 1032)]
    layouts.append((reverse, own, int(own.sum())))
    for start, width, slots in layouts:
        wi, a = pack.pack_fill(*on, V, start.to(dev), width.to(dev), slots)
        pw, pa = pack.pack_fill_plain(off, rows, vals, table, V, start,
                                      width, slots)
        assert torch.equal(wi.cpu(), pw)
        assert torch.equal(a.cpu().view(torch.int32), pa.view(torch.int32))
    empty = torch.zeros(1, dtype=torch.int64, device=dev)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    assert pack.pack_kept_lengths(empty, none, on[3], V).numel() == 0
    wi, a = pack.pack_fill(empty, none, none.float(), on[3], V,
                           empty[:0], none, 0)
    assert wi.shape == (0,) and a.shape == (0,)
    with pytest.raises(ValueError, match="is on"):
        pack.pack_kept_lengths(on[0], rows, on[3], V)


def test_infer_all_from_the_card_batch_is_bit_equal(dev):
    """infer_all on the batch packed on the card (blocks cut there) and on
    the host's batch (blocks cut on the host and copied): the same blocks,
    so bit-equal weights, converged flags and both LLH arrays, with top_n
    0 and 5 and with overflow retries (tiny Lf)."""
    from isle_tpu_torch import Corpus, mwu

    rng = np.random.default_rng(8)
    V, D, k = 700, 900, 12
    M = rng.random((V, k)).astype(np.float32)
    M[M < 0.6] = 0.0
    M[rng.random(V) < 0.05] = 0.0
    M /= M.sum(axis=0, keepdims=True)
    lengths = rng.integers(1, 120, D)
    lengths[[5, 6]] = [300, 600]
    d = np.repeat(np.arange(D), lengths)
    key = np.unique(d * V + rng.integers(0, V, d.size))
    corpus = Corpus.from_entries(key // V, key % V,
                                 rng.integers(1, 6, key.size), vocab_size=V,
                                 num_docs=D, normalize_to_one=True)
    mass = M.sum(axis=1)
    host = mwu.build_infer_batch(corpus, mass)
    card = mwu.build_infer_batch(corpus, mass, device=dev)
    for Lf, top_n, block in ((10.0, 0, 0), (10.0, 5, 0), (1e-3, 0, 64),
                             (10.0, 5, 100)):
        g = mwu.infer_all(M, card, 15, Lf, top_n=top_n, block_size=block,
                          device=dev)
        h = mwu.infer_all(M, host, 15, Lf, top_n=top_n, block_size=block,
                          device=dev)
        for a, b in zip(g, h):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert 0 < g[1].sum() <= D


def _doc_ordered_chunks(n, S, rows, seed, pieces=5):
    """A stream in doc order whose word-keyed sums cross every chunk: the
    segments (words) of each piece are sorted on their own, as the streamed
    passes sort a chunk by word. Returns a list of (seg, idx, val)."""
    rng = np.random.default_rng(seed)
    out = []
    for part in np.array_split(np.arange(n), pieces):
        seg = np.sort(np.minimum(
            (np.exp(rng.random(part.size) * np.log(S)) - 1).astype(np.int64),
            S - 1)).astype(np.int32)
        idx = rng.integers(0, rows, part.size).astype(np.int32)
        val = (rng.random(part.size) + 0.5).astype(np.float32)
        out.append((seg, idx, val))
    return out


@pytest.mark.parametrize("with_val", [False, True])
def test_onehot_init_carried_over_chunks(dev, with_val):
    """The streamed histogram's use: each chunk's launch takes the running
    result as init. Over five chunks the counts equal one plain pass over
    the whole stream exactly, float sums within rtol 1e-5 of float64, and
    a second accumulation is bit-equal; init is never written."""
    S, ncols = 3_000, 37
    chunks = _doc_ordered_chunks(100_000, S, ncols, 21)

    def accumulate():
        acc = torch.zeros((S + 1, ncols), device=dev,
                          dtype=torch.float32 if with_val else torch.int32)
        for seg, col, val in chunks:
            s, c, v = _cuda(dev, seg, col, val if with_val else None)
            prev, keep = acc, acc.clone()
            acc = segsum.segsum_onehot(s, c, v, S, ncols, init=acc)
            assert acc.data_ptr() != prev.data_ptr()
            assert torch.equal(prev, keep)
        return acc

    got = accumulate()
    seg, col, val = (np.concatenate(x) for x in zip(*chunks))
    s, c, v = _cuda(dev, seg, col, val)
    if with_val:
        ref = segsum.segsum_onehot_plain(s, c, v.double(), S, ncols)
        torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got, segsum.segsum_onehot_plain(s, c, None, S,
                                                           ncols))
    assert torch.equal(got, accumulate())


@pytest.mark.parametrize("W", [1, 100])
def test_gather_rows_init_carried_over_chunks(dev, W):
    """The streamed model accumulation's use: five word-sorted chunks added
    into a running (S + 1, W) result through init."""
    S, rows = 3_000, 2_000
    chunks = _doc_ordered_chunks(100_000, S, rows, 22)
    table = torch.from_numpy(np.random.default_rng(23).random(
        (rows, W)).astype(np.float32)).to(dev)

    def accumulate():
        acc = torch.zeros((S + 1, W), device=dev)
        for seg, idx, val in chunks:
            prev, keep = acc, acc.clone()
            acc = segsum.segsum_gather_rows(*_cuda(dev, seg, idx, val), table,
                                            S, init=acc)
            assert torch.equal(prev, keep)
        return acc

    got = accumulate()
    seg, idx, val = (np.concatenate(x) for x in zip(*chunks))
    s, i, v = _cuda(dev, seg, idx, val)
    ref = segsum.segsum_gather_rows_plain(s, i, v.double(), table.double(),
                                          S)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, accumulate())


def test_gram_operator_at_width_one(dev):
    """The Lanczos matvec: sparse.gram_x on a (V, 1) vector of mixed signs
    launches the gather kernel twice at W = 1 and equals the plain version
    in float64 within 1e-5 |B| |B^T| |x|."""
    from isle_tpu_torch import sparse

    corpus, _ = _exact_corpus()
    A = sparse.DocSparse.from_corpus(corpus, dev)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(A.vocab, 1)).astype(np.float32)).to(dev)
    before = segsum.segsum_gather_rows.launches
    got = sparse.gram_x(A, x)
    assert segsum.segsum_gather_rows.launches == before + 2

    def plain(vec):
        y = segsum.segsum_gather_rows_plain(
            A.d_doc, A.d_word, A.d_val.double(), vec, A.num_docs)
        return segsum.segsum_gather_rows_plain(
            A.w_word, A.w_doc, A.w_val.double(), y[:A.num_docs],
            A.vocab)[:A.vocab]

    ref, bound = plain(x.double()), plain(x.double().abs())
    torch.cuda.synchronize()
    assert got.shape == (A.vocab, 1)
    assert bool(((got.double() - ref).abs() <= 1e-5 * bound).all())


def test_chunk_loader_on_the_card(dev):
    """Every chunk arrives on the card as the corpus holds it, through the
    two staging slots, whether the caller takes the chunks one after the
    other or loads a range on its own; the copies are accounted for."""
    from isle_tpu_torch.streaming import ChunkLoader

    corpus, _ = _exact_corpus()
    loader = ChunkLoader(corpus, 1500, dev)
    assert len(loader.ranges) >= 5 and len(loader._slots) == 2
    docs = corpus.doc_ids()
    for _ in range(2):  # a second pass reuses the buffers
        seen = 0
        for lo, hi, w, v, d in loader.chunks():
            a, b = int(corpus.offsets[lo]), int(corpus.offsets[hi])
            assert a == seen and w.is_cuda and v.is_cuda and d.is_cuda
            np.testing.assert_array_equal(w.cpu().numpy(), corpus.rows[a:b])
            np.testing.assert_array_equal(v.cpu().numpy(), corpus.vals[a:b])
            np.testing.assert_array_equal(d.cpu().numpy(), docs[a:b])
            seen = b
        assert seen == corpus.nnz
    lo, hi = loader.ranges[2]
    w, v, d = loader.load(lo, hi)
    a, b = int(corpus.offsets[lo]), int(corpus.offsets[hi])
    np.testing.assert_array_equal(w.cpu().numpy(), corpus.rows[a:b])
    assert loader.bytes_copied == (
        corpus.offsets.nbytes + 8 * (2 * corpus.nnz + b - a))
    assert loader.copy_wait_ms() >= 0.0 and loader.host_wait_seconds >= 0.0


@pytest.mark.parametrize("sampled", [False, True])
def test_streamed_trainer_on_the_card(dev, tmp_path, sampled):
    """The out-of-core trainer on the card against the in-core trainer on
    the card, same seed: ζ, B's docs, clusters, catchwords and top-two
    topics exactly (the corpus's masses are exact in float32), the model
    within rtol 1e-4; every streamed accumulation launched a kernel."""
    from isle_tpu_torch import GpuConfig, TrainConfig, Trainer
    from isle_tpu_torch.streaming import StreamedTrainer

    corpus, k = _exact_corpus()
    cfg = TrainConfig(num_topics=k, seed=2, compute_edge_topics=True,
                      max_edge_topics=8, sample_docs=sampled,
                      sample_rate=0.6 if sampled else 0.0)
    gpu = GpuConfig(device="cuda", dense_head_bytes=0)  # COO's launches
    ref = Trainer(cfg, output_dir=str(tmp_path / "incore"), quiet=True,
                  gpu=gpu)
    ref.load_corpus(corpus)
    ref.train()
    got = StreamedTrainer(cfg, output_dir=str(tmp_path / "streamed"),
                          chunk_entries=1500, gpu=gpu)
    got.load_corpus(corpus)
    segsum.reset_launch_counts()
    got.train()
    counts = segsum.launch_counts()
    chunks = len(got.loader.ranges)
    assert chunks >= 5
    # the histogram and the mass (and the sampling weights) a chunk each
    assert counts["segsum_onehot"] >= (3 if sampled else 2) * chunks, counts
    # the model accumulation a chunk each, besides the SpMMs
    assert counts["segsum_gather_rows"] >= chunks + 2, counts
    np.testing.assert_array_equal(got.original_cols, ref.original_cols)
    np.testing.assert_array_equal(got.cluster_of_doc, ref.cluster_of_doc)
    for a, b in zip(got.catchwords, ref.catchwords):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.top_pairs, ref.top_pairs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.evalues, ref.evalues, rtol=1e-4)
    np.testing.assert_allclose(got.model, ref.model, rtol=1e-4, atol=1e-6)
    # and the in-core trainer finishes the streamed run's checkpoints
    import os
    os.remove(os.path.join(got.run_dir, "ckpt_model.npz"))
    back = Trainer(cfg, output_dir=str(tmp_path / "streamed"), quiet=True,
                   gpu=gpu)
    back.load_corpus(corpus)
    back.train(resume=True)
    np.testing.assert_allclose(back.model, got.model, rtol=1e-5, atol=1e-7)


def test_chunk_loader_over_a_doc_range_on_the_card(dev):
    """A rank's loader: the chunks of its doc range only, its offsets and
    slots sized by that range; an empty range yields nothing and holds no
    slot."""
    from isle_tpu_torch.streaming import ChunkLoader

    corpus, _ = _exact_corpus()
    lo, hi = 150, 420
    loader = ChunkLoader(corpus, 1500, dev, (lo, hi))
    off = corpus.offsets
    assert loader.ranges[0][0] == lo and loader.ranges[-1][1] == hi
    assert loader.bytes_copied == 8 * (hi - lo + 1)
    assert loader._slots[0].pin[0].numel() == max(
        int(off[b] - off[a]) for a, b in loader.ranges)
    docs = corpus.doc_ids()
    seen = int(off[lo])
    for a, b, w, v, d in loader.chunks():
        x, y = int(off[a]), int(off[b])
        assert x == seen and d.is_cuda
        np.testing.assert_array_equal(w.cpu().numpy(), corpus.rows[x:y])
        np.testing.assert_array_equal(v.cpu().numpy(), corpus.vals[x:y])
        np.testing.assert_array_equal(d.cpu().numpy(), docs[x:y])
        seen = y
    assert seen == int(off[hi])
    empty = ChunkLoader(corpus, 1500, dev, (600, 600))
    assert empty.ranges == [] and empty._slots == []
    assert list(empty.chunks()) == []


@pytest.mark.parametrize("chunk", [1000, 2999, 1 << 24])
def test_staged_upload_on_the_card(dev, monkeypatch, chunk):
    """The in-core upload through the pinned staging, by entry ranges that
    split docs (runs of empty docs, a doc longer than a range): the six
    arrays bit-equal to the pageable COO upload of the host's doc ids,
    and 8 bytes an entry staged."""
    from isle_tpu_torch import obs, staging
    from isle_tpu_torch.sparse import DocSparse
    from torch_cases import csc_corpus

    rng = np.random.default_rng(5)
    lengths = np.where(rng.random(2000) < 0.3, 0,
                       rng.integers(1, 40, 2000))
    lengths[700] = 5000
    corpus = csc_corpus(lengths, vocab=6000, seed=5)
    n, D = corpus.nnz, corpus.num_docs
    splits = set(range(chunk, n, chunk)) - set(corpus.offsets.tolist())
    assert n > 10 * 3000 and (chunk > n or splits)
    monkeypatch.setattr(staging, "DEFAULT_CHUNK_ENTRIES", chunk)
    t = obs.Timer()
    got = DocSparse.from_corpus(corpus, dev, timer=t)
    ref = DocSparse.from_doc_sorted(corpus.rows, corpus.doc_ids(),
                                    corpus.vals, corpus.vocab_size, D, dev)
    torch.cuda.synchronize()
    for f in ("d_word", "d_doc", "d_val", "w_word", "w_doc", "w_val"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b), f
    assert t.counters["upload staged bytes"] == 8 * n
    assert t.counters["upload bytes"] == 8 * n + 8 * (D + 1)


def test_group_less_mesh_streamed_on_the_card(dev, tmp_path):
    """StreamedTrainer with a mesh of one rank and no group on the card:
    the sharded streamed path, every pass launching its kernel once a
    chunk, ending bit for bit where the single-device streamed run ends
    (both on the default, resident loader)."""
    from isle_tpu_torch import GpuConfig, TrainConfig
    from isle_tpu_torch.sharding import Mesh
    from isle_tpu_torch.streaming import StreamedTrainer

    corpus, k = _exact_corpus()
    cfg = TrainConfig(num_topics=k, seed=2, compute_edge_topics=True,
                      max_edge_topics=8)
    runs = {}
    for name, mesh in (("single", None), ("sharded", Mesh("cuda"))):
        st = StreamedTrainer(cfg, output_dir=str(tmp_path / name),
                             chunk_entries=1500,
                             gpu=GpuConfig(device="cuda"), mesh=mesh)
        st.load_corpus(corpus)
        segsum.reset_launch_counts()
        st.train()
        runs[name] = (st, segsum.launch_counts())
    (g, g_counts), (c, c_counts) = runs["sharded"], runs["single"]
    assert g_counts == c_counts
    assert g.loader.doc_range == (0, corpus.num_docs)
    assert [s for s, *_ in g.timer.phases][:2] == [
        "sharded resident corpus fill", "streamed thresholds (sharded)"]
    for f in ("original_cols", "cluster_of_doc", "evalues", "model"):
        np.testing.assert_array_equal(getattr(g, f), getattr(c, f), f)
    for a, b in zip(g.top_pairs, c.top_pairs):
        np.testing.assert_array_equal(a, b)


def test_lanczos_on_the_card_matches_the_cpu(dev, tmp_path):
    """eigensolver="lanczos" on the card (width-1 launches of the gather
    kernel) against the CPU: eigenvalues within rtol 1e-4, the same
    clusters."""
    from isle_tpu_torch import GpuConfig, HyperParams, TrainConfig, Trainer

    corpus, k = _exact_corpus()
    cfg = TrainConfig(num_topics=k, seed=2,
                      hyper=HyperParams(eigensolver="lanczos"))
    runs = {}
    for device in ("cuda", "cpu"):
        tr = Trainer(cfg, output_dir=str(tmp_path / device), quiet=True,
                     gpu=GpuConfig(device=device, dense_head_bytes=0))
        tr.load_corpus(corpus)
        before = segsum.segsum_gather_rows.launches
        tr.train()
        if device == "cuda":
            assert segsum.segsum_gather_rows.launches - before >= \
                2 * tr.op_counter.calls
        runs[device] = tr
    g, c = runs["cuda"], runs["cpu"]
    assert g.op_counter.calls == c.op_counter.calls > 0
    np.testing.assert_allclose(g.evalues, c.evalues, rtol=1e-4)
    np.testing.assert_array_equal(g.cluster_of_doc, c.cluster_of_doc)
    np.testing.assert_allclose(g.model, c.model, rtol=1e-4, atol=1e-6)


def _narrow_of(*widths):
    """How many products of these widths the dispatch gives the narrow
    kernel (no layout here has doc tiles)."""
    return sum(segsum.gather_path(w, 0) == "narrow" for w in widths)


def test_train_step_on_the_card_matches_the_cpu(dev):
    """sharding.sharded_train_step on the card (a mesh without a group)
    against the CPU, on the corpus of exact sums with integer X and doc
    rows for centers, so every sum is exact: all four outputs equal; one
    step launches four gathers and two onehots."""
    from isle_tpu_torch import sharding as sh
    from isle_tpu_torch.sparse import to_dense

    corpus, k = _exact_corpus()
    V, D = corpus.vocab_size, corpus.num_docs
    rng = np.random.default_rng(4)
    X = torch.from_numpy(rng.integers(-3, 4, (V, 16)).astype(np.float32))
    outs = {}
    for device in ("cuda", "cpu"):
        mesh = sh.Mesh(device)
        A = sh.shard_doc_sparse(corpus.rows, corpus.doc_ids(), corpus.vals,
                                V, D, mesh)
        centers = torch.from_numpy(np.ascontiguousarray(
            to_dense(A.local)[:, [0, 7, 11, 20, 33]].T, np.float32)).to(device)
        segsum.reset_launch_counts()
        outs[device] = [o.cpu() for o in sh.sharded_train_step(A, mesh, k)(
            A, X.to(device), centers)]
        if device == "cuda":
            # X is 16 wide and k = 5: each width takes its kernel
            assert segsum.launch_counts() == {
                "segsum_onehot": 2, "segsum_gather_rows": 4,
                "segsum_gather_rows_narrow": _narrow_of(16, 16, k, k),
                "segsum_gather_rows_tiled": 0}
    for g, c in zip(outs["cuda"], outs["cpu"]):
        assert g.dtype == c.dtype and torch.equal(g, c)
    assert len(torch.unique(outs["cuda"][1])) > 1


def test_graft_entry_on_the_card_matches_the_cpu(dev):
    """graft_entry.entry() on the card against entry("cpu"): the same
    assignments, Y within rtol 1e-5, atol 1e-4, centers and MWU weights
    within 1e-5."""
    from isle_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    assert args[0].device.type == "cuda"
    segsum.reset_launch_counts()
    got = [o.cpu() for o in fn(*args)]
    # X is 128 wide and k = 16
    assert segsum.launch_counts() == {
        "segsum_onehot": 1, "segsum_gather_rows": 4,
        "segsum_gather_rows_narrow": _narrow_of(128, 128, 16, 16),
        "segsum_gather_rows_tiled": 0}
    cfn, cargs = graft_entry.entry("cpu")
    want = cfn(*cargs)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    assert torch.equal(got[1], want[1])
    for g, c in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, c, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# csrc/micro.cu: chunk_partials and row_gather_async (isle_tpu_torch/
# micro_kernels.py) at the tolerances of chip_smoke.py's phase M: every
# mode within maxrel 1e-6 (max |out - ref| / max |ref|) of its plain
# version, the gather bit-equal to index_select.
# ---------------------------------------------------------------------------


def _maxrel(got, ref):
    torch.cuda.synchronize()
    ref = ref.double()
    return float((got.double() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def _micro_stream(dev, n, W, avg_run, chunk, seed):
    from isle_tpu_torch import micro_kernels as mk

    seg = torch.from_numpy(mk.make_sorted_segments(
        n, avg_run, max(1 << 12, 2 * n // avg_run), seed)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((n, W), generator=gen, device=dev)
    rank2d, ids, rcap = mk.plan_ranks(seg, chunk)
    return seg, g, rank2d.view(-1), ids, rcap


@pytest.mark.parametrize("mode", ["highest", "split2", "default"])
@pytest.mark.parametrize("W,avg_run,chunk", [
    (128, 16, 2048), (128, 110, 2048), (8, 16, 512), (200, 3, 512)])
def test_micro_chunk_partials_matches_plain(dev, mode, W, avg_run, chunk):
    from isle_tpu_torch import micro_kernels as mk

    seg, g, rank, ids, rcap = _micro_stream(dev, 1 << 16, W, avg_run, chunk,
                                            W + avg_run)
    before = mk.chunk_partials.launches
    got = mk.chunk_partials(rank, g, chunk, rcap, mode)
    assert mk.chunk_partials.launches == before + 1
    ref = mk.chunk_partials_plain(rank, g, chunk, rcap, mode)
    assert _maxrel(got, ref) <= 1e-6
    # rows at unused ranks are exactly zero (the scatter's fill ids rely
    # on it), and a second launch is bit-equal
    used = torch.zeros_like(got[..., 0], dtype=torch.bool)
    used.view(-1)[(torch.arange(rank.numel(), device=dev) // chunk) * rcap
                  + rank] = True
    assert not got[~used].any()
    assert torch.equal(got, mk.chunk_partials(rank, g, chunk, rcap, mode))


@pytest.mark.parametrize("mode", ["highest", "split2", "default"])
@pytest.mark.parametrize("layout", ["distinct", "one_rank", "outside"])
def test_micro_chunk_partials_extreme_ranks(dev, mode, layout):
    """Every entry its own rank (rcap = chunk: the tensor-core kernel's two
    passes of 256 rows, the exact kernel's four of 128), one rank for the
    whole chunk, and ranks outside [0, rcap), which add nothing."""
    from isle_tpu_torch import micro_kernels as mk

    C, n, W = 512, 4096, 128
    if layout == "distinct":
        rank = torch.arange(n, device=dev, dtype=torch.int32) % C
        rcap = C
    elif layout == "one_rank":
        rank = torch.zeros(n, device=dev, dtype=torch.int32)
        rcap = 8
    else:
        rank = torch.randint(-3, 40, (n,), device=dev, dtype=torch.int32)
        rcap = 32
    g = torch.randn((n, W), device=dev)
    got = mk.chunk_partials(rank, g, C, rcap, mode)
    ref = mk.chunk_partials_plain(rank, g, C, rcap, mode)
    assert _maxrel(got, ref) <= 1e-6
    if layout == "distinct" and mode == "highest":
        assert torch.equal(got, g.view(n // C, C, W))


def test_micro_plan_and_scatter_on_the_card(dev):
    """plan_ranks on the card equals its host version exactly; partials
    plus scatter_partials equal the segment sums in float64 (split2 within
    1e-5 of the unsplit g, highest within 1e-6)."""
    from isle_tpu_torch import micro_kernels as mk

    n, W, C = 1 << 16, 128, 2048
    seg, g, rank, ids, rcap = _micro_stream(dev, n, W, 16, C, 5)
    r2, i2, c2 = mk.plan_ranks_plain(seg.cpu().numpy(), C)
    assert c2 == rcap
    assert np.array_equal(rank.view(-1, C).cpu().numpy(), r2)
    assert np.array_equal(ids.cpu().numpy(), i2)
    S = int(seg.max()) + 1
    ref = torch.zeros((S, W), dtype=torch.float64, device=dev)
    ref.index_add_(0, seg.long(), g.double())
    for mode, tol in (("highest", 1e-6), ("split2", 1e-5)):
        part = mk.chunk_partials(rank, g, C, rcap, mode)
        assert _maxrel(mk.scatter_partials(part, ids, S), ref) <= tol


@pytest.mark.parametrize("chunk,depth", [(1024, 8), (1024, 32), (1024, 128),
                                         (4096, 256), (100, 3)])
def test_micro_row_gather_is_index_select(dev, chunk, depth):
    from isle_tpu_torch import micro_kernels as mk

    V, W, n = 3_001, 128, 40_000  # n % chunk != 0: a ragged last block
    gen = torch.Generator(device=dev).manual_seed(depth)
    tab = torch.randn((V, W), generator=gen, device=dev)
    idx = torch.randint(0, V, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    before = mk.row_gather_async.launches
    got = mk.row_gather_async(idx, tab, chunk, depth)
    assert mk.row_gather_async.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, torch.index_select(tab, 0, idx))
    assert torch.equal(got, mk.row_gather_async(idx, tab, chunk, depth))
    bad = idx.clone()
    bad[::7] = -1
    bad[1::7] = V
    assert torch.equal(mk.row_gather_async(bad, tab, chunk, depth),
                       mk.row_gather_plain(bad, tab))


def test_micro_row_gather_rejects(dev):
    """depth > chunk, a misaligned table and a row of 20 bytes raise: the
    bulk copy needs 16-byte addresses and sizes, and there is no fallback."""
    from isle_tpu_torch import micro_kernels as mk

    idx = torch.zeros(64, device=dev, dtype=torch.int32)
    tab = torch.randn((10, 128), device=dev)
    with pytest.raises(ValueError, match="depth"):
        mk.row_gather_async(idx, tab, 32, 64)
    shifted = torch.empty(10 * 128 + 1, device=dev)[1:].view(10, 128)
    with pytest.raises(ValueError, match="aligned"):
        mk.row_gather_async(idx, shifted, 32, 8)
    with pytest.raises(ValueError, match="16"):
        mk.row_gather_async(idx, torch.randn((10, 5), device=dev), 32, 8)


def _ranks(layout, n, C, rng):
    """(rank int32 (n,), rcap) of a stream laid out for the m-tile windows
    of the partials kernels: each k16 step's ranks reach only their own
    m16 tiles of rank rows."""
    chunks = n // C
    if layout == "random":  # every m-tile in every step's window
        return rng.integers(0, 256, n), 256
    if layout == "descending":
        return np.tile(np.arange(C)[::-1] * 256 // C, chunks), 256
    if layout == "one_rank":  # one rank a chunk, a different one each
        return np.repeat(rng.integers(0, 256, chunks), C), 256
    if layout == "runs_of_15":  # a window across an m-tile at every step
        return np.tile(np.arange(C) // 15, chunks), 256
    if layout == "outside":  # a sorted stream with ranks off both ends
        rank = np.tile(np.arange(C) // 9, chunks)
        bad = rng.random(n) < 0.1
        rank[bad] = rng.choice([-7, -1, 256, 300], int(bad.sum()))
        return rank, 256
    if layout == "passes":  # rcap 512: two passes of 256 rank rows
        return np.tile(np.arange(C) // 2, chunks), 512
    raise ValueError(layout)


@pytest.mark.parametrize("W", [8, 128, 200])
@pytest.mark.parametrize("layout", ["random", "descending", "one_rank",
                                    "runs_of_15", "outside", "passes"])
@pytest.mark.parametrize("mode", ["highest", "split2", "default"])
def test_micro_partials_rank_windows(dev, mode, layout, W):
    """The partials kernels on rank layouts that the m-tile windows and
    the passes over rank rows must get right: within maxrel 1e-6 of the
    plain version, unused rows exactly zero, ranks outside [0, rcap)
    adding nothing, and two launches bit-equal."""
    from isle_tpu_torch import micro_kernels as mk

    C, n = 1024, 4096
    rng = np.random.default_rng(len(layout) + W)
    rank_np, rcap = _ranks(layout, n, C, rng)
    rank = torch.from_numpy(rank_np.astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((n, W)).astype(
        np.float32)).to(dev)
    got = mk.chunk_partials(rank, g, C, rcap, mode)
    ref = mk.chunk_partials_plain(rank, g, C, rcap, mode)
    assert _maxrel(got, ref) <= 1e-6
    ok = (rank >= 0) & (rank < rcap)
    used = torch.zeros((n // C) * rcap, dtype=torch.bool, device=dev)
    used[((torch.arange(n, device=dev) // C) * rcap + rank)[ok]] = True
    assert not got.view(-1, W)[~used].any()
    assert torch.equal(got, mk.chunk_partials(rank, g, C, rcap, mode))


def test_micro_kernel_info_at_the_benchmark_shapes(dev):
    """What the card gives the micro kernels at the drivers' shapes (n =
    2^24, W = 128, chunk 2048; the gather's four (chunk, depth)): the
    partials' persistent grid fills every SM, two blocks an SM at rcap 32
    and one at rcap 256 (128 KB of sums); the gather a block a chunk, its
    shared memory as gather_shape sizes it, at least one block an SM."""
    from isle_tpu_torch import micro_kernels as mk

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 1 << 24
    for mode in mk.MODES:
        for rcap, per_sm in ((32, 2), (256, 1)):
            info = mk.kernel_info(mode, n, 128, 2048, rcap)
            assert info["threads"] == (128 if mode == "highest" else 256)
            assert info["blocks_per_sm"] == per_sm
            assert info["grid"] == per_sm * sms
            assert info["smem_bytes"] <= mk.SMEM_BYTES
            assert info["registers"] > 0
    for chunk, depth in ((1024, 8), (1024, 32), (1024, 128), (4096, 256)):
        info = mk.kernel_info("gather", 1 << 22, 128, chunk, depth)
        want = mk.gather_shape(1 << 22, 128, chunk, depth)
        assert (info["threads"], info["smem_bytes"], info["grid"]) == (
            want["threads"], want["smem_bytes"], want["blocks"])
        assert info["blocks_per_sm"] >= 1


@pytest.mark.parametrize("W", [4, 128])
@pytest.mark.parametrize("depth", [1, 3, 8, 31, 33, 256])
def test_micro_row_gather_stages(dev, depth, W):
    """The bulk gather at depths that cut the ring into one short stage,
    whole stages of 32 and a short last one, over a ragged last block
    (n % chunk != 0), with out-of-range indices scattered and a whole
    stage of them: bit-equal to index_select where the index is in range,
    zero rows elsewhere."""
    from isle_tpu_torch import micro_kernels as mk

    V, n, chunk = 1_001, 20_000, 300  # 20,000 % 300 = 200
    gen = torch.Generator(device=dev).manual_seed(depth + W)
    tab = torch.randn((V, W), generator=gen, device=dev)
    idx = torch.randint(0, V, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    got = mk.row_gather_async(idx, tab, chunk, depth)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.index_select(tab, 0, idx))
    bad = idx.clone()
    bad[::5] = -3
    bad[2::11] = V
    bad[600:664] = V + 7  # block 2's first 64 rows: whole stages of them
    got = mk.row_gather_async(bad, tab, chunk, depth)
    assert torch.equal(got, mk.row_gather_plain(bad, tab))
    assert torch.equal(got, mk.row_gather_async(bad, tab, chunk, depth))


@pytest.mark.parametrize("doc_range", [None, (37, 121)])
@pytest.mark.parametrize("name", ["uint8", "uint16", "int32", "unit_mass"])
def test_resident_loader_on_the_card(dev, name, doc_range):
    """streaming.ResidentLoader's fill through the pinned staging and its
    decode on the card: every chunk equal bit for bit to the wire loader's
    on the card and the values to the corpus's, in the counts form of each
    dtype and the vals form; a release and a second fill give the same
    chunks, and the bytes copied are the slabs' and the offsets' (a fill
    each)."""
    from isle_tpu_torch import streaming
    from torch_cases import RESIDENT_CORPORA, resident_corpus

    corpus = resident_corpus(name)
    res = streaming.ResidentLoader(corpus, 64, dev, doc_range)
    want = RESIDENT_CORPORA[name][2]
    assert res.count_dtype == (None if want is None else np.dtype(want))
    wire = streaming.ChunkLoader(corpus, 64, dev, doc_range)
    first = [tuple(x.cpu() if torch.is_tensor(x) else x for x in c)
             for c in res.chunks()]
    got = [tuple(x.cpu() if torch.is_tensor(x) else x for x in c)
           for c in wire.chunks()]
    assert len(first) == len(got) > 1
    for a, b in zip(first, got):
        assert a[:2] == b[:2]
        for x, y in zip(a[2:], b[2:]):
            assert x.dtype == y.dtype and torch.equal(
                x.view(torch.int32), y.view(torch.int32))
    lo, hi = res.doc_range
    off = corpus.offsets
    vals = np.concatenate([c[3].numpy() for c in first])
    assert np.array_equal(vals.view(np.int32),
                          corpus.vals[off[lo]:off[hi]].view(np.int32))
    once = res.bytes_copied  # the slabs and the offsets (the doc sums
    # are summed on the card)
    size = 4 + (4 if want is None else np.dtype(want).itemsize)
    assert once == size * int(off[hi] - off[lo]) + 8 * (hi - lo + 1)
    res.release()
    again = [tuple(x.cpu() if torch.is_tensor(x) else x for x in c)
             for c in res.chunks()]
    for a, b in zip(first, again):
        assert a[:2] == b[:2] and all(torch.equal(x, y)
                                      for x, y in zip(a[2:], b[2:]))
    assert res.fill_count == 2 and res.bytes_copied == 2 * once
    assert res.copy_wait_ms() == 0.0
