"""Segment sums over a SORTED segment stream: the port's counterpart of
isle_tpu/pallas_ops.py.

Two wrappers, each over one hand-written CUDA kernel (csrc/segsum.cu):

  segsum_onehot(seg, col, val, S, ncols)  out[s, c] += (val or 1) over
      entries with seg == s and col == c; col outside [0, ncols) adds
      nothing. Exact int32 counts without `val`, float32 sums with it.
  segsum_gather_rows(seg, idx, val, table, S)  out[s, :] += val *
      table[idx, :]; idx outside [0, len(table)) adds nothing. The port's
      SpMM (sparse.bt_x, sparse.b_y) runs on it.

Both return (S + 1) rows with the spill row last, the shape of the JAX
wrappers; entries whose segment lies outside [0, S] add nothing. The
kernels find run boundaries themselves, so isle_tpu's plan_segments,
SegPlan and its rank cap have no counterpart here.

Dispatch is by the tensors' device and nothing else: a CPU tensor takes
the plain PyTorch version beside each wrapper (index_add_ on a flat
index), a CUDA tensor launches the kernel or raises. Each wrapper counts
its kernel launches in `.launches`.
"""

from __future__ import annotations

from typing import Optional

import torch

DEFAULT_CHUNK = 2048  # entries per CUDA block (onehot) or slice (rows)
MAX_CHUNK = 1 << 20
PLAIN_CHUNK = 1 << 21  # entries per step of segsum_gather_rows_plain


def _check_1d(name: str, t: torch.Tensor, dtype: torch.dtype, n: int,
              device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.dim() != 1 or t.numel() != n:
        raise ValueError(
            f"{name} must be a 1-D {dtype} tensor of length {n}, got "
            f"{t.dtype} of shape {tuple(t.shape)}"
        )
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_init(init, shape, dtype, device) -> None:
    if init is not None and (
        tuple(init.shape) != shape or init.dtype != dtype
        or init.device != device
    ):
        raise ValueError(
            f"init must be {dtype} of shape {shape} on {device}, got "
            f"{init.dtype} {tuple(init.shape)} on {init.device}"
        )


def _check_chunk(chunk: int, cap: int) -> None:
    if not 1 <= chunk <= cap:
        raise ValueError(f"chunk must lie in [1, {cap}], got {chunk}")


def _launch_args(t: torch.Tensor):
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def _raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def _out(init, shape, dtype, device) -> torch.Tensor:
    if init is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return init.clone()


# ---------------------------------------------------------------------------
# segsum_onehot (replaces _segsum_onehot_call, pallas_ops.py:236)
# ---------------------------------------------------------------------------


def segsum_onehot_plain(
    seg: torch.Tensor,
    col: torch.Tensor,
    val: Optional[torch.Tensor],
    num_segments: int,
    ncols: int,
    init: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of segsum_onehot: one index_add_ on the flat
    index seg * ncols + col. Sums in val's dtype (int32 counts without
    val), on any device; needs no sortedness."""
    dtype = torch.int32 if val is None else val.dtype
    out = _out(init, (num_segments + 1, ncols), dtype, seg.device)
    ok = (col >= 0) & (col < ncols) & (seg >= 0) & (seg <= num_segments)
    flat = seg[ok].long() * ncols + col[ok].long()
    src = (torch.ones(flat.numel(), dtype=dtype, device=seg.device)
           if val is None else val[ok])
    out.view(-1).index_add_(0, flat, src)
    return out


def segsum_onehot(
    seg: torch.Tensor,
    col: torch.Tensor,
    val: Optional[torch.Tensor],
    num_segments: int,
    ncols: int,
    init: Optional[torch.Tensor] = None,
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """(num_segments + 1, ncols): out[s, c] += (val or 1) over entries with
    seg == s and col == c. `seg` must be sorted (not checked here: the
    check costs a pass over the stream). int32 seg/col; float32 val."""
    n, dev = seg.numel(), seg.device
    _check_1d("seg", seg, torch.int32, n, dev)
    _check_1d("col", col, torch.int32, n, dev)
    if val is not None:
        _check_1d("val", val, torch.float32, n, dev)
    if num_segments < 0 or ncols < 1:
        raise ValueError(f"bad num_segments={num_segments} / ncols={ncols}")
    dtype = torch.int32 if val is None else torch.float32
    shape = (num_segments + 1, ncols)
    _check_init(init, shape, dtype, dev)
    if dev.type == "cpu":
        return segsum_onehot_plain(seg, col, val, num_segments, ncols, init)
    if dev.type != "cuda":
        raise ValueError(f"segsum_onehot runs on cpu or cuda, not {dev}")
    _check_chunk(chunk, MAX_CHUNK)
    from ._build import kernels

    lib = kernels().lib
    out = _out(init, shape, dtype, dev)
    if n == 0:
        return out
    device, stream = _launch_args(seg)
    if val is None:
        rc = lib.isle_segsum_onehot_i32(
            seg.data_ptr(), col.data_ptr(), n, num_segments, ncols, chunk,
            out.data_ptr(), device, stream,
        )
    else:
        rc = lib.isle_segsum_onehot_f32(
            seg.data_ptr(), col.data_ptr(), val.data_ptr(), n, num_segments,
            ncols, chunk, out.data_ptr(), device, stream,
        )
    segsum_onehot.launches += 1
    _raise_on_error("segsum_onehot", rc)
    return out


segsum_onehot.launches = 0


# ---------------------------------------------------------------------------
# segsum_gather_rows (replaces _segsum_rows_call, pallas_ops.py:203, with
# the gather of segsum_gather_rows, pallas_ops.py:382)
# ---------------------------------------------------------------------------


def segsum_gather_rows_plain(
    seg: torch.Tensor,
    idx: torch.Tensor,
    val: torch.Tensor,
    table: torch.Tensor,
    num_segments: int,
    init: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of segsum_gather_rows: index_select of table
    rows and index_add_ by segment, PLAIN_CHUNK entries at a time so the
    gathered (chunk, W) rows stay bounded. Sums in table's dtype, on any
    device; needs no sortedness."""
    rows, W = table.shape
    out = _out(init, (num_segments + 1, W), table.dtype, seg.device)
    for a in range(0, seg.numel(), PLAIN_CHUNK):
        s, i, v = (t[a:a + PLAIN_CHUNK] for t in (seg, idx, val))
        ok = (i >= 0) & (i < rows) & (s >= 0) & (s <= num_segments)
        g = table.index_select(0, i[ok]) * v[ok].to(table.dtype)[:, None]
        out.index_add_(0, s[ok], g)
    return out


def segsum_gather_rows(
    seg: torch.Tensor,
    idx: torch.Tensor,
    val: torch.Tensor,
    table: torch.Tensor,
    num_segments: int,
    init: Optional[torch.Tensor] = None,
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """(num_segments + 1, W): out[s, :] += val[e] * table[idx[e], :] over
    entries with seg[e] == s. `seg` must be sorted (not checked here).
    int32 seg/idx; float32 val and (rows, W) table. On the card the sums
    are taken in a fixed order (no atomics): `chunk` entries per slice,
    slices in stream order, so equal inputs give bit-equal outputs."""
    n, dev = seg.numel(), seg.device
    _check_1d("seg", seg, torch.int32, n, dev)
    _check_1d("idx", idx, torch.int32, n, dev)
    _check_1d("val", val, torch.float32, n, dev)
    if (table.dtype != torch.float32 or table.dim() != 2
            or table.device != dev or not table.is_contiguous()):
        raise ValueError(
            f"table must be a contiguous 2-D float32 tensor on {dev}, got "
            f"{table.dtype} {tuple(table.shape)} on {table.device}"
        )
    if num_segments < 0:
        raise ValueError(f"bad num_segments={num_segments}")
    W = table.shape[1]
    shape = (num_segments + 1, W)
    _check_init(init, shape, torch.float32, dev)
    if dev.type == "cpu":
        return segsum_gather_rows_plain(seg, idx, val, table, num_segments,
                                        init)
    if dev.type != "cuda":
        raise ValueError(f"segsum_gather_rows runs on cpu or cuda, not {dev}")
    _check_chunk(chunk, MAX_CHUNK)
    from ._build import kernels

    lib = kernels().lib
    out = _out(init, shape, torch.float32, dev)
    if n == 0 or W == 0:
        return out
    # the partial sums of the runs that cross a slice edge (csrc/segsum.cu)
    slices = -(-n // chunk)
    carry = torch.empty((slices, 2, W), dtype=torch.float32, device=dev)
    carry_seg = torch.empty((slices, 2), dtype=torch.int32, device=dev)
    device, stream = _launch_args(seg)
    rc = lib.isle_segsum_gather_rows_f32(
        seg.data_ptr(), idx.data_ptr(), val.data_ptr(), table.data_ptr(), n,
        table.shape[0], W, num_segments, chunk, int(init is not None),
        out.data_ptr(), carry.data_ptr(), carry_seg.data_ptr(), device,
        stream,
    )
    segsum_gather_rows.launches += 1
    _raise_on_error("segsum_gather_rows", rc)
    return out


segsum_gather_rows.launches = 0


def reset_launch_counts() -> None:
    segsum_onehot.launches = 0
    segsum_gather_rows.launches = 0


def launch_counts() -> dict:
    return {
        "segsum_onehot": segsum_onehot.launches,
        "segsum_gather_rows": segsum_gather_rows.launches,
    }
