"""Segment sums over a SORTED segment stream: the port's counterpart of
isle_tpu/pallas_ops.py.

Two wrappers, each over one hand-written CUDA kernel (csrc/segsum.cu):

  segsum_onehot(seg, col, val, S, ncols)  out[s, c] += (val or 1) over
      entries with seg == s and col == c; col outside [0, ncols) adds
      nothing, col None puts every entry in column 0. Exact int32 counts
      without `val`, float32 sums with it (on the card accumulated in
      float64 and rounded once: the exact sum, whatever the slicing,
      while a cell's n terms lie within a factor 2^29 / n of each
      other).
  segsum_gather_rows(seg, idx, val, table, S)  out[s, :] += val *
      table[idx, :]; idx outside [0, len(table)) adds nothing. The port's
      SpMM (sparse.bt_x, sparse.b_y) runs on it. On the card a table of
      at most NARROW_MAX_WIDTH columns takes the narrow kernel (lanes
      across entries: the width-1 Lanczos matvecs), a wider one the wide
      kernel (lanes across the row).
  segsum_gather_rows_tiled(seg, idx, val, table, S, tile_starts)  the
      same sums over a stream cut into doc tiles (sparse.with_doc_tiles):
      one pass of the wide kernel per tile, each adding into the same
      output, so that each pass gathers from one L2-sized slice of the
      table. sparse.b_y takes it where gather_path says so.

Both return (S + 1) rows with the spill row last, the shape of the JAX
wrappers; entries whose segment lies outside [0, S] add nothing. The
kernels find run boundaries themselves, so isle_tpu's plan_segments,
SegPlan and its rank cap have no counterpart here.

On the card both cut the stream into slices of `chunk` entries, one warp
a slice, and sum floats in an order fixed by the input (no float
atomics): equal inputs give bit-equal outputs. segsum_onehot reduces each
slice in a window of whole output rows in shared memory and writes every
output cell itself (init added), so its output needs no zero-fill;
csrc/segsum.cu describes both designs.

Dispatch is by the tensors' device and nothing else: a CPU tensor takes
the plain PyTorch version beside each wrapper (index_add_ on a flat
index), a CUDA tensor launches the kernel or raises. Each wrapper counts
its kernel launches in `.launches`; segsum_gather_rows.launches counts
every product, whichever kernel or mode ran it, and
segsum_gather_rows_narrow / segsum_gather_rows_tiled count their own.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

DEFAULT_CHUNK = 2048  # entries per slice of either kernel
MAX_CHUNK = 1 << 20
PLAIN_CHUNK = 1 << 21  # entries per step of segsum_gather_rows_plain
# The widest table segsum_gather_rows_narrow_kernel takes (kNarrowMaxW of
# csrc/segsum.cu), and the widest that segsum_gather_rows gives it: at
# every width up to it the narrow kernel ran 3-12x faster than the wide
# one on B's two streams at the NYTimes shape on an H100 (chip_smoke.py
# phase S3 times both at widths 1, 2, 4, 8 and 16; PERF.md).
NARROW_MAX_WIDTH = 16
# Slices a pass of segsum_gather_rows_tiled aims at: four for each warp the
# wide kernel keeps resident on an H100 (132 SMs x 32 warps). A pass holds
# one tile's share of the stream, and at the whole stream's slice length
# (2048) half the warps of a pass over the hybrid tail sat idle; 256 or 512
# entries a slice ran fastest (gather_probe.py, PERF.md).
TILED_PASS_SLICES = 16384


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
    col: Optional[torch.Tensor],
    val: Optional[torch.Tensor],
    num_segments: int,
    ncols: int,
    init: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of segsum_onehot: one index_add_ on the flat
    index seg * ncols + col (col None: column 0). Sums in val's dtype
    (int32 counts without val), on any device; needs no sortedness."""
    dtype = torch.int32 if val is None else val.dtype
    out = _out(init, (num_segments + 1, ncols), dtype, seg.device)
    ok = (seg >= 0) & (seg <= num_segments)
    if col is not None:
        ok &= (col >= 0) & (col < ncols)
    flat = seg[ok].long() * ncols
    if col is not None:
        flat += col[ok].long()
    src = (torch.ones(flat.numel(), dtype=dtype, device=seg.device)
           if val is None else val[ok])
    out.view(-1).index_add_(0, flat, src)
    return out


def segsum_onehot(
    seg: torch.Tensor,
    col: Optional[torch.Tensor],
    val: Optional[torch.Tensor],
    num_segments: int,
    ncols: int,
    init: Optional[torch.Tensor] = None,
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """(num_segments + 1, ncols): out[s, c] += (val or 1) over entries with
    seg == s and col == c; col None puts every entry in column 0 (the
    kernel then reads no column array). `seg` must be sorted (not checked
    here: the check costs a pass over the stream). int32 seg/col; float32
    val. On the card float sums are taken in a fixed order (no atomics):
    equal inputs give bit-equal outputs; they accumulate in float64, so a
    cell whose terms sum exactly there (csrc/segsum.cu) is that sum
    rounded once, whatever `chunk` and wherever the stream starts."""
    n, dev = seg.numel(), seg.device
    _check_1d("seg", seg, torch.int32, n, dev)
    if col is not None:
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
    if n == 0:
        return _out(init, shape, dtype, dev)
    # the kernel writes every cell, init included
    out = torch.empty(shape, dtype=dtype, device=dev)
    if init is not None:
        init = init.contiguous()
    init_ptr = None if init is None else init.data_ptr()
    col_ptr = None if col is None else col.data_ptr()
    device, stream = _launch_args(seg)
    if val is None:
        rc = lib.isle_segsum_onehot_i32(
            seg.data_ptr(), col_ptr, init_ptr, n, num_segments, ncols, chunk,
            out.data_ptr(), device, stream,
        )
    else:
        # the parts of the runs that cross a slice edge (csrc/segsum.cu)
        carry = torch.empty((-(-n // chunk), 2, ncols), dtype=torch.float64,
                            device=dev)
        rc = lib.isle_segsum_onehot_f32(
            seg.data_ptr(), col_ptr, val.data_ptr(), init_ptr, n,
            num_segments, ncols, chunk, out.data_ptr(), carry.data_ptr(),
            device, stream,
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


def gather_path(width: int, table_bytes: int, tile_rows: int = 0) -> str:
    """The gather kernel a product takes on the card: "narrow" up to
    NARROW_MAX_WIDTH columns; "tiled" for a stream with doc tiles of
    `tile_rows` rows (0: none) whose table holds more than one tile;
    else "wide"."""
    if width <= NARROW_MAX_WIDTH:
        return "narrow"
    if tile_rows > 0 and table_bytes > tile_rows * width * 4:
        return "tiled"
    return "wide"


def _check_rows_args(seg, idx, val, table, num_segments, init):
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
    _check_init(init, (num_segments + 1, table.shape[1]), torch.float32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"segsum_gather_rows runs on cpu or cuda, not {dev}")


def _launch_rows(kernel: str, seg, idx, val, table, num_segments, out,
                 accumulate: bool, chunk: int, scratch=None) -> None:
    """One launch of the wide or narrow kernel on the stream, into `out`
    ((num_segments + 1, W), added into when `accumulate`, else rows the
    stream reaches overwritten). `scratch`: (carry, carry_seg) of at
    least ceil(n / chunk) slices, or None to allocate them."""
    n, W = seg.numel(), table.shape[1]
    if n == 0 or W == 0:
        return
    from ._build import kernels

    lib = kernels().lib
    slices = -(-n // chunk)
    # the partial sums of the runs that cross a slice edge (csrc/segsum.cu)
    carry, carry_seg = scratch or (
        torch.empty((slices, 2, W), dtype=torch.float32, device=seg.device),
        torch.empty((slices, 2), dtype=torch.int32, device=seg.device))
    fn = (lib.isle_segsum_gather_rows_narrow_f32 if kernel == "narrow"
          else lib.isle_segsum_gather_rows_f32)
    device, stream = _launch_args(seg)
    rc = fn(
        seg.data_ptr(), idx.data_ptr(), val.data_ptr(), table.data_ptr(), n,
        table.shape[0], W, num_segments, chunk, int(accumulate),
        out.data_ptr(), carry.data_ptr(), carry_seg.data_ptr(), device,
        stream,
    )
    _raise_on_error(f"segsum_gather_rows ({kernel} kernel)", rc)


def segsum_gather_rows(
    seg: torch.Tensor,
    idx: torch.Tensor,
    val: torch.Tensor,
    table: torch.Tensor,
    num_segments: int,
    init: Optional[torch.Tensor] = None,
    chunk: int = DEFAULT_CHUNK,
    kernel: Optional[str] = None,
) -> torch.Tensor:
    """(num_segments + 1, W): out[s, :] += val[e] * table[idx[e], :] over
    entries with seg[e] == s. `seg` must be sorted (not checked here).
    int32 seg/idx; float32 val and (rows, W) table. On the card the sums
    are taken in a fixed order (no atomics): `chunk` entries per slice,
    slices in stream order, so equal inputs give bit-equal outputs.
    `kernel` ("wide" or "narrow") picks the card's kernel; None lets
    gather_path choose by the width."""
    _check_rows_args(seg, idx, val, table, num_segments, init)
    W = table.shape[1]
    if kernel is None:
        kernel = ("narrow" if gather_path(W, table.numel() * 4) == "narrow"
                  else "wide")
    if kernel not in ("wide", "narrow"):
        raise ValueError(f"kernel must be 'wide' or 'narrow', got {kernel}")
    if kernel == "narrow" and W > NARROW_MAX_WIDTH:
        raise ValueError(f"the narrow kernel takes at most "
                         f"{NARROW_MAX_WIDTH} columns, got {W}")
    if seg.device.type == "cpu":
        return segsum_gather_rows_plain(seg, idx, val, table, num_segments,
                                        init)
    _check_chunk(chunk, MAX_CHUNK)
    out = _out(init, (num_segments + 1, W), torch.float32, seg.device)
    if seg.numel() == 0 or W == 0:
        return out
    _launch_rows(kernel, seg, idx, val, table, num_segments, out,
                 init is not None, chunk)
    segsum_gather_rows.launches += 1
    if kernel == "narrow":
        segsum_gather_rows_narrow.launches += 1
    return out


segsum_gather_rows.launches = 0


def segsum_gather_rows_narrow(
    seg: torch.Tensor,
    idx: torch.Tensor,
    val: torch.Tensor,
    table: torch.Tensor,
    num_segments: int,
    init: Optional[torch.Tensor] = None,
    chunk: int = DEFAULT_CHUNK,
) -> torch.Tensor:
    """segsum_gather_rows on segsum_gather_rows_narrow_kernel (tables of
    at most NARROW_MAX_WIDTH columns). `.launches` here counts that
    kernel's launches, through this wrapper or segsum_gather_rows's
    dispatch."""
    return segsum_gather_rows(seg, idx, val, table, num_segments, init,
                              chunk, kernel="narrow")


segsum_gather_rows_narrow.launches = 0


def tile_spans(tile_starts) -> list:
    """(start, end) entry offsets of the non-empty tiles of a tile-ordered
    stream, in tile order."""
    return [(a, b) for a, b in zip(tile_starts[:-1], tile_starts[1:])
            if b > a]


def tiled_pass_chunk(tile_starts) -> int:
    """The slice length of every pass of segsum_gather_rows_tiled: the
    largest tile's entries over TILED_PASS_SLICES, rounded to a power of
    two, at least 128 (a batch of the wide kernel) and at most
    DEFAULT_CHUNK."""
    most = max([b - a for a, b in tile_spans(tile_starts)], default=0)
    c = 1 << max(round(math.log2(max(most / TILED_PASS_SLICES, 1.0))), 7)
    return min(c, DEFAULT_CHUNK)


def segsum_gather_rows_tiled_plain(seg, idx, val, table, num_segments,
                                   tile_starts, init=None) -> torch.Tensor:
    """Plain version of segsum_gather_rows_tiled:
    segsum_gather_rows_plain over each tile's entries, in tile order,
    each tile's output the next one's init."""
    out = init
    for a, b in tile_spans(tile_starts):
        out = segsum_gather_rows_plain(seg[a:b], idx[a:b], val[a:b], table,
                                       num_segments, out)
    if out is None:
        out = torch.zeros((num_segments + 1, table.shape[1]),
                          dtype=table.dtype, device=seg.device)
    return out


def segsum_gather_rows_tiled(
    seg: torch.Tensor,
    idx: torch.Tensor,
    val: torch.Tensor,
    table: torch.Tensor,
    num_segments: int,
    tile_starts,
    init: Optional[torch.Tensor] = None,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """segsum_gather_rows over a stream cut into tiles: entries
    [tile_starts[t], tile_starts[t + 1]) are tile t, each tile sorted by
    seg (sparse.with_doc_tiles: tiles of docs, sorted by (word, doc)
    within each). On the card one pass of the wide kernel per non-empty
    tile, in tile order, each adding its run sums into the same output
    (the kernel's accumulate mode), so a pass gathers only the table rows
    of its tile; the passes' slices are `chunk` entries long, by default
    tiled_pass_chunk(tile_starts). The sum order is tile order, then the
    kernel's within a tile, and equal inputs give bit-equal outputs.
    Counts one call in segsum_gather_rows.launches and one in .launches
    here."""
    _check_rows_args(seg, idx, val, table, num_segments, init)
    starts = [int(x) for x in tile_starts]
    if (not starts or starts[0] != 0 or starts[-1] != seg.numel()
            or any(b < a for a, b in zip(starts[:-1], starts[1:]))):
        raise ValueError(f"tile_starts must rise from 0 to {seg.numel()}, "
                         f"got {starts[:3]}...{starts[-3:]}")
    if seg.device.type == "cpu":
        return segsum_gather_rows_tiled_plain(seg, idx, val, table,
                                              num_segments, starts, init)
    if chunk is None:
        chunk = tiled_pass_chunk(starts)
    _check_chunk(chunk, MAX_CHUNK)
    W = table.shape[1]
    out = _out(init, (num_segments + 1, W), torch.float32, seg.device)
    spans = tile_spans(starts)
    if spans and W > 0:
        # one scratch for every pass: the passes run in order on one stream
        slices = max(-(-(b - a) // chunk) for a, b in spans)
        scratch = (torch.empty((slices, 2, W), dtype=torch.float32,
                               device=seg.device),
                   torch.empty((slices, 2), dtype=torch.int32,
                               device=seg.device))
        # the first pass overwrites the rows it reaches (the rest are 0)
        # unless there is an init; every later pass adds into them
        for p, (a, b) in enumerate(spans):
            _launch_rows("wide", seg[a:b], idx[a:b], val[a:b], table,
                         num_segments, out, p > 0 or init is not None,
                         chunk, scratch)
    segsum_gather_rows.launches += 1
    segsum_gather_rows_tiled.launches += 1
    return out


segsum_gather_rows_tiled.launches = 0

_COUNTED = (segsum_onehot, segsum_gather_rows, segsum_gather_rows_narrow,
            segsum_gather_rows_tiled)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _COUNTED}
