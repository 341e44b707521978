"""The kernels of the two micro-benchmarks of the segment sum and the row
gather: the port's counterparts of benchmarks/micro_pallas.py and
benchmarks/micro_pallas_gather.py, with the host helpers their drivers
(isle_tpu_torch/benchmarks/) need.

  make_sorted_segments(n, avg_run, num_segments, seed)  sorted segment ids
      with runs of about avg_run entries (micro_pallas.py:56-66, the same
      array from the same seed).
  plan_ranks(seg, chunk)  each entry's within-chunk segment rank, the
      segment id of every (chunk, rank) slot and the rank cap
      (micro_pallas.py:87-126), as integer ops on seg's device.
  chunk_partials(rank, g, chunk, rcap, mode)  part[c, r, :] = the sum of
      g[e, :] over the entries e of chunk c with rank[e] == r, by a one-hot
      product (make_pallas_segsum, micro_pallas.py:129-177). Modes:
      "highest" the float32 rows unrounded (each run of equal ranks summed
      in float64), "split2" g = hi + lo in bf16 with float32
      accumulation, "default" g rounded to bf16, one pass.
  scatter_partials(part, ids, num_segments)  adds the partials at their
      segment ids (pallas_scatter, micro_pallas.py:180-183).
  row_gather_async(idx, tab, chunk, depth)  out[i, :] = tab[idx[i], :] by
      one asynchronous copy a row through a ring of `depth` slots
      (make_dma_gather, micro_pallas_gather.py:40-83).

chunk_partials and row_gather_async each wrap one hand-written kernel of
csrc/micro.cu. As in segsum.py, a CPU tensor takes the plain PyTorch
version beside the wrapper, a CUDA tensor launches the kernel or raises,
and each wrapper counts its launches in `.launches`. gather_shape gives
a gather launch's blocks and shared memory as its kernel sizes them;
kernel_info asks the card what a launch of either kernel takes (threads,
shared memory, registers, blocks an SM, grid).
"""

from __future__ import annotations

import numpy as np
import torch

MODES = ("highest", "split2", "default")
_MODE_CODE = {m: i for i, m in enumerate(MODES)}
# chunk_partials takes chunks of a multiple of KTILE entries
# (csrc/micro.cu: kChunkMultiple)
KTILE = 64
# the gather kernel: one warp a block, a stage of up to GATHER_STAGE_ROWS
# rows (one a lane)
GATHER_STAGE_ROWS = 32
# The shared memory a block can have on an H100 (227 KB): row_gather_async
# holds its ring to it on every device, the CPU too. (The C entry also
# refuses a ring past the opt-in limit of the device it runs on.)
SMEM_BYTES = 232_448
# One-hot cells a step of chunk_partials_plain holds (float64: 512 MiB).
PLAIN_ONEHOT_CELLS = 1 << 26


def _check_1d(name, t, dtype, n=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.dim() != 1 or (n is not None and t.numel() != n):
        want = "" if n is None else f" of length {n}"
        raise ValueError(f"{name} must be a 1-D {dtype} tensor{want}, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_table(name, t, device):
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or t.dim() != 2 or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous 2-D float32 tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


# ---------------------------------------------------------------------------
# The segment streams and the rank plan (micro_pallas.py:56-126)
# ---------------------------------------------------------------------------


def make_sorted_segments(n, avg_run, num_segments, seed=0) -> np.ndarray:
    """Sorted int32 segment ids with ~avg_run entries per present segment:
    a copy of micro_pallas.make_sorted_segments (the same array)."""
    rng = np.random.default_rng(seed)
    n_distinct = max(1, n // avg_run)
    ids = np.sort(rng.choice(num_segments, size=n_distinct, replace=False))
    runs = rng.poisson(avg_run - 1, size=n_distinct) + 1
    seg = np.repeat(ids, runs)
    seg = seg[:n]
    if len(seg) < n:
        seg = np.concatenate([seg, np.full(n - len(seg), ids[-1], np.int32)])
    return np.sort(seg).astype(np.int32)


def rank_cap(rmax: int) -> int:
    """The partials' rows a chunk gets: the next power of two above the
    largest rank, at least 8 (micro_pallas.plan_ranks)."""
    return max(8, 1 << int(rmax).bit_length())


def plan_ranks(seg: torch.Tensor, chunk: int):
    """(rank2d int32 (nchunks, chunk), ids int32 (nchunks * rcap,), rcap)
    of a sorted segment stream whose length is a multiple of `chunk`.
    rank2d[c, j] counts the segment changes between the chunk's first
    entry and its entry j; ids[c * rcap + r] is the segment at rank r of
    chunk c, and an unused slot takes the chunk's LAST segment id, so ids
    stays globally non-decreasing (its partial row is zero, so the scatter
    adds nothing there). Integer ops on seg's device (an integer cumsum is
    exact on the card) and one readback, for rcap."""
    _check_1d("seg", seg, torch.int32)
    n = seg.numel()
    if chunk < 1 or n == 0 or n % chunk:
        raise ValueError(f"the stream's length {n} must be a positive "
                         f"multiple of chunk={chunk}")
    nchunks = n // chunk
    new = torch.ones(n, dtype=torch.int32, device=seg.device)
    new[1:] = (seg[1:] != seg[:-1]).to(torch.int32)
    R = torch.cumsum(new, 0, dtype=torch.int32).view(nchunks, chunk)
    rank2d = R - R[:, :1]
    rcap = rank_cap(int(rank2d.max()))
    ids = seg.view(nchunks, chunk)[:, -1:].expand(nchunks, rcap).contiguous()
    flat = (torch.arange(nchunks, device=seg.device)[:, None] * rcap
            + rank2d).view(-1)
    # every entry of a (chunk, rank) slot carries the same id
    ids.view(-1).scatter_(0, flat, seg)
    return rank2d, ids.view(-1), rcap


def plan_ranks_plain(seg: np.ndarray, chunk: int):
    """plan_ranks on the host in numpy, entry by entry of the definition:
    the plain version the card's plan is held against."""
    seg = np.asarray(seg)
    nchunks = seg.size // chunk
    R = np.cumsum(np.r_[True, seg[1:] != seg[:-1]]) - 1
    rank2d = (R.reshape(nchunks, chunk)
              - R.reshape(nchunks, chunk)[:, :1]).astype(np.int32)
    rcap = rank_cap(rank2d.max())
    ids = np.repeat(seg.reshape(nchunks, chunk)[:, -1], rcap)
    flat = (np.arange(seg.size) // chunk) * rcap + rank2d.reshape(-1)
    ids[flat] = seg
    return rank2d, ids.astype(np.int32), rcap


# ---------------------------------------------------------------------------
# chunk_partials (replaces make_pallas_segsum, micro_pallas.py:163)
# ---------------------------------------------------------------------------


def split_bf16(g: torch.Tensor):
    """(hi, lo) float32 tensors holding bf16 values: hi = g rounded to
    bf16 (to nearest even), lo = the residual g - hi rounded to bf16, as
    micro_pallas.py's split2 cuts g."""
    hi = g.to(torch.bfloat16)
    lo = (g - hi.float()).to(torch.bfloat16)
    return hi.float(), lo.float()


def chunk_partials_plain(rank: torch.Tensor, g: torch.Tensor, chunk: int,
                         rcap: int, mode: str) -> torch.Tensor:
    """Plain PyTorch version of chunk_partials: the (rcap, chunk) one-hot
    of each chunk's ranks times the chunk's rows, a batch of chunks at a
    time, in float64 and rounded to float32 once: the exact value of each
    mode's arithmetic ("highest" sums g, "split2" hi + lo, "default" hi;
    every product of a 0/1 cell is exact). A rank outside [0, rcap)
    matches no row and adds nothing."""
    n, W = g.shape
    nchunks = n // chunk
    out = torch.empty((nchunks, rcap, W), dtype=torch.float32,
                      device=g.device)
    rows = torch.arange(rcap, device=g.device)[None, :, None]
    step = max(1, PLAIN_ONEHOT_CELLS // (rcap * chunk))
    for a in range(0, nchunks, step):
        b = min(a + step, nchunks)
        r = rank[a * chunk:b * chunk].view(b - a, 1, chunk).long()
        x = g[a * chunk:b * chunk].view(b - a, chunk, W)
        if mode == "highest":
            y = x.double()
        else:
            hi, lo = split_bf16(x)
            y = hi.double() + lo.double() if mode == "split2" else \
                hi.double()
        out[a:b] = torch.bmm((rows == r).double(), y)
    return out


def chunk_partials(rank: torch.Tensor, g: torch.Tensor, chunk: int,
                   rcap: int, mode: str) -> torch.Tensor:
    """(n / chunk, rcap, W) float32: part[c, r, :] = the sum of g[e, :] over
    the entries e of chunk c (entries [c * chunk, (c + 1) * chunk)) whose
    rank[e] == r; rows no entry reaches are exactly zero and a rank
    outside [0, rcap) adds nothing. int32 rank (n,), float32 g (n, W).

    On the card each block takes a chunk's whole width (up to 128
    columns) and keeps the sums of a pass's rank rows (up to 256) in
    shared memory (kernel_info gives a launch's shape). "split2" and
    "default" run the one-hot product on the tensor cores (mma.sync bf16,
    float32 accumulation), the one-hot built in registers from the ranks,
    only for the n8 tiles of rank rows that a k16 step's ranks reach;
    "highest" sums the float32 rows on the CUDA cores in entry order
    within each rank, each run of equal ranks in float64 (a plan's sorted
    ranks: every partial its float64 sum rounded once). Each needs chunk % KTILE == 0 and W % 8 == 0; equal inputs give
    bit-equal outputs."""
    if mode not in _MODE_CODE:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not isinstance(g, torch.Tensor) or g.dim() != 2:
        raise ValueError("g must be a 2-D tensor")
    n, W = g.shape
    _check_1d("rank", rank, torch.int32, n)
    _check_table("g", g, rank.device)
    if chunk < 1 or n % chunk or rcap < 1:
        raise ValueError(f"n={n} must be a multiple of chunk={chunk}, "
                         f"rcap={rcap} positive")
    dev = rank.device
    if dev.type == "cpu":
        return chunk_partials_plain(rank, g, chunk, rcap, mode)
    if dev.type != "cuda":
        raise ValueError(f"chunk_partials runs on cpu or cuda, not {dev}")
    if chunk % KTILE or W % 8 or rank.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError(f"the kernel takes chunk % {KTILE} == 0, W % 8 == "
                         f"0 and 16-byte aligned rank and g, got chunk="
                         f"{chunk}, W={W}")
    from ._build import kernels
    from .segsum import _launch_args, _raise_on_error

    out = torch.empty((n // chunk, rcap, W), dtype=torch.float32, device=dev)
    if n == 0 or W == 0:
        return out
    device, stream = _launch_args(g)
    _raise_on_error("chunk_partials",
                    kernels().lib.isle_chunk_onehot_partials_f32(
                        rank.data_ptr(), g.data_ptr(), n, W, chunk, rcap,
                        _MODE_CODE[mode], out.data_ptr(), device, stream))
    chunk_partials.launches += 1
    return out


chunk_partials.launches = 0


def scatter_partials(part: torch.Tensor, ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """(num_segments, W): the partial rows added at their segment ids
    (plan_ranks's ids, non-decreasing), on the port's deterministic
    segsum.segsum_gather_rows with seg = ids, idx = arange and val = 1 (no
    float atomics)."""
    from .segsum import segsum_gather_rows

    W = part.shape[-1]
    rows = part.reshape(-1, W)
    _check_1d("ids", ids, torch.int32, rows.shape[0])
    idx = torch.arange(rows.shape[0], dtype=torch.int32, device=ids.device)
    val = torch.ones(rows.shape[0], dtype=torch.float32, device=ids.device)
    return segsum_gather_rows(ids, idx, val, rows, num_segments)[
        :num_segments]


# ---------------------------------------------------------------------------
# row_gather_async (replaces make_dma_gather, micro_pallas_gather.py:69)
# ---------------------------------------------------------------------------


def row_gather_plain(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of row_gather_async: tab[idx], with a zero row
    where idx lies outside [0, len(tab)) (the kernel copies nothing
    there)."""
    ok = (idx >= 0) & (idx < tab.shape[0])
    out = tab.index_select(0, torch.where(ok, idx, 0).long())
    out[~ok] = 0
    return out


def gather_shape(n: int, W: int, chunk: int, depth: int) -> dict:
    """How row_gather_async's kernel cuts a launch (csrc/micro.cu): one
    warp a block and a block a `chunk` rows, the ring of `depth` rows cut
    into stages of up to GATHER_STAGE_ROWS (a shorter last one), and the
    dynamic shared memory a block: the ring, an mbarrier a stage and the
    chunk's indices."""
    stage_rows = min(depth, GATHER_STAGE_ROWS)
    stages = -(-depth // stage_rows)
    return dict(threads=32, stage_rows=stage_rows, stages=stages,
                blocks=-(-n // chunk),
                smem_bytes=depth * W * 4 + stages * 8 + chunk * 4)


def row_gather_async(idx: torch.Tensor, tab: torch.Tensor, chunk: int = 1024,
                     depth: int = 32) -> torch.Tensor:
    """(n, W) float32: out[i, :] = tab[idx[i], :], a zero row where idx
    lies outside [0, len(tab)). int32 idx (n,), float32 tab (V, W).

    On the card one warp a block and a block a `chunk` rows: the block's
    indices are staged in shared memory, lane j issues a bulk asynchronous
    copy (cp.async.bulk, Hopper's TMA engine) of row j of a stage of the
    ring of `depth` rows, and each arrived stage leaves for `out` by one
    bulk copy (gather_shape). It needs depth <= chunk, the ring and the
    chunk's indices within SMEM_BYTES (an H100's limit, held on every
    device), rows of a multiple of 16 bytes and 16-byte aligned tensors,
    and raises otherwise."""
    _check_1d("idx", idx, torch.int32)
    _check_table("tab", tab, idx.device)
    n = idx.numel()
    if not 1 <= depth <= chunk:
        raise ValueError(f"need 1 <= depth <= chunk, got depth={depth}, "
                         f"chunk={chunk}")
    W = tab.shape[1]
    smem = gather_shape(n, W, chunk, depth)["smem_bytes"]
    if smem > SMEM_BYTES:
        raise ValueError(f"a ring of {depth} rows of {W * 4} bytes and "
                         f"{chunk} staged indices need {smem} bytes of "
                         f"shared memory, more than a block's {SMEM_BYTES}")
    dev = idx.device
    if dev.type == "cpu":
        return row_gather_plain(idx, tab)
    if dev.type != "cuda":
        raise ValueError(f"row_gather_async runs on cpu or cuda, not {dev}")
    if (W * 4) % 16 or tab.data_ptr() % 16:
        raise ValueError(f"the bulk copy needs rows of a multiple of 16 "
                         f"bytes and a 16-byte aligned table, got W={W}, "
                         f"address {tab.data_ptr():#x}")
    from ._build import kernels
    from .segsum import _launch_args, _raise_on_error

    out = torch.empty((n, W), dtype=torch.float32, device=dev)
    if n == 0 or W == 0:
        return out
    device, stream = _launch_args(idx)
    _raise_on_error("row_gather_async",
                    kernels().lib.isle_row_gather_bulk_f32(
                        idx.data_ptr(), tab.data_ptr(), n, tab.shape[0], W,
                        chunk, depth, out.data_ptr(), device, stream))
    row_gather_async.launches += 1
    return out


row_gather_async.launches = 0

# kernel_info's kinds: the C entry's `which`
_INFO_KIND = {**_MODE_CODE, "gather": 3}


def kernel_info(kind: str, n: int, W: int, chunk: int, arg: int,
                device="cuda") -> dict:
    """What the card gives a launch of one micro kernel, launching nothing:
    kind "highest", "split2" or "default" (chunk_partials at rcap = arg)
    or "gather" (row_gather_async at depth = arg). Returns threads,
    smem_bytes (dynamic, a block), blocks_per_sm
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers (a
    thread) and grid (blocks launched). Needs a CUDA device."""
    import ctypes

    from ._build import kernels
    from .segsum import _raise_on_error

    if kind not in _INFO_KIND:
        raise ValueError(f"kind must be one of {tuple(_INFO_KIND)}, got "
                         f"{kind!r}")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"kernel_info asks a CUDA device, not {dev}")
    out = (ctypes.c_int64 * 5)()
    _raise_on_error("kernel_info", kernels().lib.isle_micro_kernel_info(
        _INFO_KIND[kind], n, W, chunk, arg,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ctypes.addressof(out)))
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm", "registers",
                     "grid"), out))


_COUNTED = (chunk_partials, row_gather_async)


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in _COUNTED}
