"""isle_tpu_torch.segsum against isle_tpu.pallas_ops.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs the Pallas kernels in interpret mode with real plans. Streams
are sorted, with runs that straddle the 256-entry chunk edges, masked
columns (-1), out-of-range gather indices and a spill tail; the onehot
cases add 635 columns, a head segment across many chunk edges, every
column masked, segments past the spill row, an init carry and one column
without a col array (col=None against Pallas's col of zeros). Counts must
be exactly equal; sums within rtol 1e-5, atol 1e-6 (float32 sums taken in
another order). tests/test_torch_cuda.py holds the CUDA kernels against
the plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isle_tpu import pallas_ops
from isle_tpu_torch import segsum
from torch_cases import CHUNK, ONEHOT_KINDS, gather_case, onehot_case, \
    onehot_kind_case, t


# an int case is onehot_case's mixed stream from that seed
@pytest.mark.parametrize("case", [0, 1, *ONEHOT_KINDS])
@pytest.mark.parametrize("with_val", [False, True])
def test_segsum_onehot_matches_pallas(case, with_val):
    if isinstance(case, int):
        seg, col, val, S, k = onehot_case(case, with_val)
        init = None
    else:
        seg, col, val, S, k, init = onehot_kind_case(case, with_val)
    plan = pallas_ops.plan_segments(jnp.asarray(seg), S, chunk=CHUNK)
    assert plan is not None
    ref = np.asarray(pallas_ops.segsum_onehot(
        plan, jnp.asarray(col), None if val is None else jnp.asarray(val),
        S, k, interpret=True,
        init=None if init is None else jnp.asarray(init),
    ))
    got = segsum.segsum_onehot(t(seg), None if case == "nocol" else t(col),
                               t(val), S, k, init=t(init)).numpy()
    assert got.shape == ref.shape == (S + 1, k)
    if with_val:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_segsum_gather_rows_matches_pallas(seed):
    seg, idx, val, table, S = gather_case(seed)
    W = table.shape[1]
    plan = pallas_ops.plan_segments(jnp.asarray(seg), S, chunk=CHUNK)
    assert plan is not None
    ref = np.asarray(pallas_ops.segsum_gather_rows(
        plan, jnp.asarray(idx), jnp.asarray(val), jnp.asarray(table), S,
        interpret=True,
    ))[:, :W]
    got = segsum.segsum_gather_rows(t(seg), t(idx), t(val), t(table),
                                    S).numpy()
    assert got.shape == (S + 1, W)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_b_y_seg_matches_b_y_plan():
    """sparse.b_y (segsum_gather_rows on the word-sorted stream, the
    port's one B Y) against isle_tpu's Pallas b_y_plan."""
    from isle_tpu.sparse import DocSparse as JaxDocSparse
    from isle_tpu_torch.sparse import DocSparse, b_y

    rng = np.random.default_rng(6)
    V, D, W = 45, 130, 5
    mask = rng.random((V, D)) < 0.25
    w, d = np.nonzero(mask)
    order = np.lexsort((w, d))
    w, d = w[order], d[order]
    v = rng.random(len(w)).astype(np.float32) * 4
    jsp = JaxDocSparse.build(w, d, v, V, D, chunk=CHUNK)
    plan = pallas_ops.plan_segments(jsp.w_word, V, chunk=CHUNK)
    assert plan is not None
    Y = rng.random((D, W)).astype(np.float32)
    ref = np.asarray(pallas_ops.b_y_plan(jsp, jnp.asarray(Y), plan,
                                         interpret=True))
    sp = DocSparse.from_numpy(
        *(np.asarray(a) for a in (jsp.d_word, jsp.d_doc, jsp.d_val,
                                  jsp.w_word, jsp.w_doc, jsp.w_val)),
        V, D, "cpu",
    )
    got = b_y(sp, t(Y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_init_seeds_the_output():
    seg, col, val, S, k = onehot_case(3, True)
    init = torch.full((S + 1, k), 2.0)
    got = segsum.segsum_onehot(t(seg), t(col), t(val), S, k, init=init)
    base = segsum.segsum_onehot(t(seg), t(col), t(val), S, k)
    torch.testing.assert_close(got, base + 2.0)
    assert torch.all(init == 2.0)  # the carry is not written in place


def test_wrappers_reject_bad_inputs():
    seg, col, val, S, k = onehot_case(4, True)
    with pytest.raises(ValueError, match="col"):
        segsum.segsum_onehot(t(seg), t(col).long(), t(val), S, k)
    with pytest.raises(ValueError, match="val"):
        segsum.segsum_onehot(t(seg), t(col), t(val)[:-1], S, k)
    with pytest.raises(ValueError, match="init"):
        segsum.segsum_onehot(t(seg), t(col), None, S, k,
                             init=torch.zeros(S + 1, k))
    seg, idx, val, table, S = gather_case(4)
    with pytest.raises(ValueError, match="table"):
        segsum.segsum_gather_rows(t(seg), t(idx), t(val),
                                  t(table).double(), S)
    with pytest.raises(ValueError, match="contiguous"):
        segsum.segsum_gather_rows(t(seg)[::2], t(idx)[::2], t(val)[::2],
                                  t(table), S)


def test_cpu_path_launches_no_kernel():
    segsum.reset_launch_counts()
    seg, col, val, S, k = onehot_case(5, False)
    segsum.segsum_onehot(t(seg), t(col), None, S, k)
    assert segsum.launch_counts() == {
        "segsum_onehot": 0, "segsum_gather_rows": 0,
        "segsum_gather_rows_narrow": 0, "segsum_gather_rows_tiled": 0,
    }


def test_reset_launch_counts_clears_every_wrapper():
    segsum.segsum_onehot.launches = 3
    segsum.segsum_gather_rows.launches = 4
    segsum.segsum_gather_rows_narrow.launches = 5
    segsum.segsum_gather_rows_tiled.launches = 6
    segsum.reset_launch_counts()
    assert segsum.launch_counts() == {
        "segsum_onehot": 0, "segsum_gather_rows": 0,
        "segsum_gather_rows_narrow": 0, "segsum_gather_rows_tiled": 0,
    }
