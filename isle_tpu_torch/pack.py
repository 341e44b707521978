"""MWU inference's batch packed on a device: the port's counterpart of the
host pack in mwu.build_infer_batch, from the corpus's CSR (offsets, rows,
vals) to padded rows, one a doc. Each doc's kept entries (words whose
model mass is above 1e-10, src/infer.cpp:375-386) fill its row from the
start, in their order; the rest of the row holds the pad, word `vocab` and
value 0.0. Each row has its own start and width in a flat output, so
mwu.pack_on_device lays the rows out by MWU's length buckets.

  keep_table(model_mass)  the per-word keep bits (int32 words, bit w % 32
      of word w // 32), made on the host by the host pack's own comparison.
  pack_kept_lengths(offsets, rows, table, vocab)  (docs,) int32: each
      doc's kept entries.
  pack_fill(offsets, rows, vals, table, vocab, row_start, row_width,
      slots)  ((slots,) int32 word ids, (slots,) float32 values): doc d's
      row at [row_start[d], row_start[d] + row_width[d]).

Each wrapper is over one hand-written kernel of csrc/pack.cu, which
replaces no Pallas kernel (isle_tpu packs in host numpy); the source says
what bounds the kernels and how their design meets it. The values are
copied, never summed, so the arrays equal the host pack's bit for bit.

As in segsum.py, dispatch is by the tensors' device and nothing else: a
CPU tensor takes the plain PyTorch version beside each wrapper, a CUDA
tensor launches the kernel or raises. Each wrapper counts its kernel
launches in `.launches`. Every block of either kernel holds the table in
shared memory, so on every device a table past TABLE_BYTES_MAX (a
vocabulary of more than 1,859,584 words) raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .segsum import _launch_args, _raise_on_error

# The shared memory a block can have on an H100 (227 KB): the most a keep
# table may take. (The C entry also refuses a table past the opt-in limit
# of the device it runs on.)
TABLE_BYTES_MAX = 232_448


def keep_table(model_mass: np.ndarray) -> np.ndarray:
    """The keep bits of every word: bit w % 32 of int32 word w // 32 is
    `model_mass[w] > 1e-10`, the very comparison of the host pack, so that
    a word at the threshold is kept or dropped alike. At least one word."""
    keep = np.asarray(model_mass) > 1e-10
    packed = np.packbits(keep, bitorder="little")
    bits = np.zeros(4 * _table_words(len(keep)), np.uint8)
    bits[:len(packed)] = packed
    return bits.view("<i4").astype(np.int32)


def _table_words(vocab: int) -> int:
    return max(-(-vocab // 32), 1)


def _check(offsets, rows, vals, table, vocab) -> None:
    dev = offsets.device
    n = rows.numel()
    for name, t, dtype in (("offsets", offsets, torch.int64),
                           ("rows", rows, torch.int32),
                           ("vals", vals, torch.float32),
                           ("table", table, torch.int32)):
        if t is None:
            continue
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if offsets.numel() < 1:
        raise ValueError("offsets needs at least one entry (docs + 1)")
    if vals is not None and vals.numel() != n:
        raise ValueError(f"vals has {vals.numel()} entries, rows {n}")
    if vocab < 1:
        raise ValueError(f"bad vocab={vocab}")
    if table.numel() < _table_words(vocab):
        raise ValueError(f"a table of {table.numel()} words holds fewer "
                         f"than the {vocab} words' bits")
    if table.numel() * 4 > TABLE_BYTES_MAX:
        raise ValueError(f"a keep table of {table.numel() * 4} bytes is "
                         f"more than the {TABLE_BYTES_MAX} bytes of shared "
                         f"memory a block of the pack kernels asks for")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the pack runs on cpu or cuda, not {dev}")


def _kept(rows, table, vocab) -> torch.Tensor:
    """Each entry's keep bit (a word outside [0, vocab) is dropped)."""
    ok = (rows >= 0) & (rows < vocab)
    r = torch.where(ok, rows, 0)
    return ok & (((table[(r >> 5).long()] >> (r & 31)) & 1) == 1)


def pack_kept_lengths_plain(offsets, rows, table, vocab) -> torch.Tensor:
    """Plain PyTorch version of pack_kept_lengths: the difference of an
    integer prefix sum of the keep bits at the doc offsets."""
    csum = torch.zeros(rows.numel() + 1, dtype=torch.int64,
                       device=rows.device)
    torch.cumsum(_kept(rows, table, vocab), 0, out=csum[1:])
    return (csum[offsets[1:]] - csum[offsets[:-1]]).to(torch.int32)


def pack_kept_lengths(offsets: torch.Tensor, rows: torch.Tensor,
                      table: torch.Tensor, vocab: int) -> torch.Tensor:
    """(docs,) int32: the entries of each doc (offsets (docs + 1,) int64
    into rows (int32 word ids)) whose word's bit is set in `table`
    (keep_table's int32 words, on the same device)."""
    _check(offsets, rows, None, table, vocab)
    if offsets.device.type == "cpu":
        return pack_kept_lengths_plain(offsets, rows, table, vocab)
    from ._build import kernels

    docs = offsets.numel() - 1
    kept = torch.empty(docs, dtype=torch.int32, device=offsets.device)
    device, stream = _launch_args(offsets)
    rc = kernels().lib.isle_pack_kept_lengths(
        offsets.data_ptr(), rows.data_ptr(), table.data_ptr(), docs, vocab,
        table.numel(), kept.data_ptr(), device, stream)
    pack_kept_lengths.launches += 1
    _raise_on_error("pack_kept_lengths", rc)
    return kept


pack_kept_lengths.launches = 0


def pack_fill_plain(offsets, rows, vals, table, vocab, row_start,
                    row_width, slots):
    """Plain PyTorch version of pack_fill: a kept entry's slot is the kept
    entries before it in its doc (an integer prefix sum); the kept entries
    go to their slots by one scatter into arrays full of the pad."""
    docs = offsets.numel() - 1
    dev = rows.device
    keep = _kept(rows, table, vocab)
    csum = torch.zeros(rows.numel() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(keep, 0, out=csum[1:])
    doc = torch.repeat_interleave(torch.arange(docs, device=dev),
                                  offsets[1:] - offsets[:-1])
    slot = csum[:-1] - csum[offsets[:-1]][doc]
    put = keep & (slot < row_width[doc])
    flat = row_start[doc[put]] + slot[put]
    word_idx = torch.full((slots,), vocab, dtype=torch.int32, device=dev)
    a = torch.zeros(slots, dtype=torch.float32, device=dev)
    word_idx[flat] = rows[put]
    a[flat] = vals[put]
    return word_idx, a


def pack_fill(offsets: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
              table: torch.Tensor, vocab: int, row_start: torch.Tensor,
              row_width: torch.Tensor, slots: int):
    """((slots,) int32 word_idx, (slots,) float32 a): doc d's row is the
    slots [row_start[d], row_start[d] + row_width[d]) (row_start (docs,)
    int64, row_width (docs,) int32, on the CSR's device): its kept entries
    (pack_kept_lengths's) from the row's first slot, in their order, words
    from `rows` and values from `vals` (float32); the row's other slots
    the pad, `vocab` and 0.0. A doc keeps at most its width (the rest are
    left out). The rows must lie inside the output and not overlap; where
    they tile it, every slot is written (on the card, slots outside every
    row are left as allocated)."""
    _check(offsets, rows, vals, table, vocab)
    docs = offsets.numel() - 1
    for name, t, dtype in (("row_start", row_start, torch.int64),
                           ("row_width", row_width, torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != (docs,) \
                or not t.is_contiguous() or t.device != offsets.device:
            raise ValueError(f"{name} must be a contiguous ({docs},) {dtype} "
                             f"tensor on {offsets.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if slots < 0:
        raise ValueError(f"bad slots={slots}")
    if offsets.device.type == "cpu":
        return pack_fill_plain(offsets, rows, vals, table, vocab, row_start,
                               row_width, slots)
    from ._build import kernels

    word_idx = torch.empty(slots, dtype=torch.int32, device=offsets.device)
    a = torch.empty(slots, dtype=torch.float32, device=offsets.device)
    device, stream = _launch_args(offsets)
    rc = kernels().lib.isle_pack_fill(
        offsets.data_ptr(), rows.data_ptr(), vals.data_ptr(),
        table.data_ptr(), docs, vocab, table.numel(), row_start.data_ptr(),
        row_width.data_ptr(), word_idx.data_ptr(), a.data_ptr(), device,
        stream)
    pack_fill.launches += 1
    _raise_on_error("pack_fill", rc)
    return word_idx, a


pack_fill.launches = 0
