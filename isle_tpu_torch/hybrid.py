"""The hybrid dense-head / sparse-tail layout of the thresholded matrix B:
the port of isle_tpu/hybrid.py in its factored mode, isle_tpu's default
SpMM engine (TpuConfig.dense_head_bytes > 0; here GpuConfig's).

Text is Zipf-distributed, so a few head words hold most of B's entries.
B is split as

    B = B_head + B_tail

  - B_head: the R most frequent words after thresholding, stored DENSE as
    an (R x docs) bfloat16 BINARY occupancy matrix. Every nonzero of B's
    row w equals row_scale[w] = sqrt(zeta_w) (reference
    src/sparseMatrix.cpp:1349), so the pattern and the (V,) row scale
    hold the head exactly, 0 and 1 being exact in bf16. Its products run
    on the tensor cores (head_dot).
  - B_tail: the other entries, a DocSparse in both sort orders with their
    B values, on the segsum_gather_rows kernel like the COO layout, and a
    tile-ordered copy of its word stream (sparse.with_doc_tiles): B_tail Y
    runs a pass per doc tile, each over one L2-sized slice of Y.

isle_tpu pads each tail segment to a multiple of 8 and reduces octets
before a scatter (_pad8_plan, _tail_gather_octsum, hybrid.py:182-311),
because scatters were slow on the TPU; the gather kernel reduces its runs
on chip, so the tail here is a plain dual-sorted COO, cut out of B's two
streams by a mask (both orders survive, no sort). The general mode (float
head, per-entry tail values) has no caller in either package and is not
ported.

isle_tpu caps the head's rows so that its int32 flat scatter index fits
(max_head_rows); TpuConfig.break_head_cap lifts the cap by building the
head in doc blocks (_scatter_head, isle_tpu/hybrid.py:75-137). The port
writes the head at an int64 index, so GpuConfig.break_head_cap lifts the
same head-size rule and needs no blocks; it keeps isle_tpu's one refusal
on that path (_check_doc_blocks), so both packages refuse the same
inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import obs
from .bmatrix import threshold_and_copy
from .segsum import DEFAULT_CHUNK
from .sparse import DocSparse, b_y, bt_x, doc_l2sq, frobenius_sq, \
    to_dense, with_doc_tiles

# isle_tpu builds the head by a scatter at an int32 flat index
# r * (docs + 1) + d (hybrid.py:42-48), and so caps the head's rows at
# max_head_rows unless break_head_cap is set. The port indexes in int64
# but keeps that cap as its head-size rule, so both packages choose the
# same head words. A module value, so that tests reach the cap at a small
# size.
FLAT_CAP = (1 << 31) - (1 << 20)


def row_scale_from_zetas(zetas: torch.Tensor) -> torch.Tensor:
    """sqrt(zeta) per word, 0 where zeta = +inf: a dropped word keeps no
    entry, and its scale must not make 0 * inf = NaN in the head products
    when it is chosen into the head (isle_tpu/hybrid.py:51-61)."""
    z = zetas.to(torch.float32)
    return torch.sqrt(torch.where(torch.isfinite(z), z, 0.0))


def max_head_rows(num_docs: int, flat_cap: Optional[int] = None) -> int:
    """The most head rows isle_tpu's int32 flat index allows at num_docs
    columns; below 8 the hybrid layout is refused."""
    cap = FLAT_CAP if flat_cap is None else flat_cap
    return max(cap // (num_docs + 1) - 1, 0)


def _head_cap(ncols: int, flat_cap: Optional[int]) -> int:
    """max_head_rows, refused below 8 rows as isle_tpu refuses it."""
    cap = max_head_rows(ncols, flat_cap)
    if cap < 8:
        raise ValueError(
            f"num_docs={ncols} exceeds the head capacity "
            f"(max_head_rows={cap}); disable the dense head "
            "(dense_head_bytes=0), shard the docs axis, or set "
            "break_head_cap")
    return cap


def _check_doc_blocks(num_head: int, ncols: int,
                      flat_cap: Optional[int]) -> None:
    """isle_tpu's refusal under break_head_cap (_scatter_head,
    isle_tpu/hybrid.py:98-103): where the head's flat range passes the
    cap, it is built in doc blocks of flat_cap // (num_head + 1) - 1
    columns, and fewer than 8 are refused. The port builds no blocks but
    refuses the same heads."""
    cap = FLAT_CAP if flat_cap is None else flat_cap
    if (num_head + 1) * (ncols + 1) > cap and cap // (num_head + 1) - 1 < 8:
        raise ValueError(
            f"num_head={num_head} leaves a column block < 8 under "
            f"flat_cap={cap}; shrink the head budget")


def head_rows(budget_bytes: int, vocab: int, ncols: int,
              flat_cap: Optional[int] = None,
              break_head_cap: bool = False) -> int:
    """isle_tpu's head size for a budget of bf16 cells over `ncols` docs
    (hybrid.py:790-805, 839-855). Without break_head_cap it is capped at
    max_head_rows and raises where the cap leaves fewer than 8 rows; with
    it, it raises where isle_tpu's doc blocks would be narrower than 8."""
    rows = int(min(vocab, max(8, budget_bytes // max(2 * ncols, 1))))
    if break_head_cap:
        _check_doc_blocks(rows, ncols, flat_cap)
        return rows
    return min(rows, _head_cap(ncols, flat_cap))


@dataclasses.dataclass(frozen=True)
class HybridSparse:
    """B as a bf16 binary dense head over its `head_words` and a COO tail
    of the other words' entries (module docstring)."""

    head_words: torch.Tensor  # (R,) int32, ascending
    head: torch.Tensor  # (R, num_docs) bfloat16, 0 or 1
    row_scale: torch.Tensor  # (vocab,) float32, sqrt(zeta), 0 if dropped
    tail: DocSparse  # the entries of the other words, B's values
    head_nnz: int

    @property
    def vocab(self) -> int:
        return self.tail.vocab

    @property
    def num_docs(self) -> int:
        return self.tail.num_docs

    @property
    def nnz(self) -> int:
        return self.head_nnz + self.tail.nnz

    @property
    def num_head(self) -> int:
        return self.head_words.numel()

    @property
    def device(self) -> torch.device:
        return self.head_words.device


def top_words(counts: torch.Tensor, num_head: int) -> torch.Tensor:
    """The num_head words of the highest counts, ascending, (R,) int32.
    Among equal counts the lower word id goes first, as jax.lax.top_k
    does (torch.topk promises no order on ties): a stable sort of the
    negated counts."""
    order = torch.sort(-counts.to(torch.int64), stable=True).indices
    return torch.sort(order[:num_head]).values.to(torch.int32)


def word_counts(sp: DocSparse) -> torch.Tensor:
    """(vocab,) int32 entries per word of B."""
    return torch.bincount(sp.w_word, minlength=sp.vocab).to(torch.int32)


def _alloc_head(rows: int, cols: int, device) -> torch.Tensor:
    """An (rows, cols) bf16 zero matrix whose rows start 16-byte aligned
    (a row stride rounded up to 8 cells), so cuBLAS's tensor-core
    kernels take it as it is, transposed or not."""
    stride = -(-max(cols, 1) // 8) * 8
    return torch.zeros((rows, stride), dtype=torch.bfloat16,
                       device=device)[:, :cols]


def split_by_head(sp: DocSparse, head_words: torch.Tensor,
                  row_scale: torch.Tensor, timer=None) -> HybridSparse:
    """The hybrid layout of B (sp) with the given head words. The head is
    written by a non-accumulating index_put_ of ones at the int64 flat
    index r * stride + d, so its build is deterministic; the tail is
    both of B's streams masked to the other words, with the tile-ordered
    copy of its word stream (every layout that builds a tail, in core,
    streamed and sharded, builds it here). With a Timer, the counters
    "B nnz" (sp's entries) and "hybrid head nnz" (the head's)."""
    V, D = sp.vocab, sp.num_docs
    dev = sp.device
    R = head_words.numel()
    rank = torch.full((V,), -1, dtype=torch.int32, device=dev)
    rank[head_words.long()] = torch.arange(R, dtype=torch.int32, device=dev)
    r_d = rank[sp.d_word]
    in_head = r_d >= 0
    head = _alloc_head(R, D, dev)
    flat = r_d[in_head].long() * head.stride(0) + sp.d_doc[in_head].long()
    head_nnz = int(flat.numel())
    obs.count(timer, "B nnz", sp.nnz)
    obs.count(timer, "hybrid head nnz", head_nnz)
    base = head.as_strided((head.shape[0] * head.stride(0),), (1,))
    base.index_put_((flat,), torch.ones((), dtype=torch.bfloat16,
                                        device=dev))
    keep_d, keep_w = ~in_head, rank[sp.w_word] < 0
    tail = with_doc_tiles(DocSparse(
        d_word=sp.d_word[keep_d], d_doc=sp.d_doc[keep_d],
        d_val=sp.d_val[keep_d], w_word=sp.w_word[keep_w],
        w_doc=sp.w_doc[keep_w], w_val=sp.w_val[keep_w],
        vocab=V, num_docs=D))
    return HybridSparse(head_words=head_words, head=head,
                        row_scale=row_scale.to(device=dev,
                                               dtype=torch.float32),
                        tail=tail, head_nnz=head_nnz)


def to_hybrid(sp: DocSparse, num_head: int, row_scale: torch.Tensor,
              flat_cap: Optional[int] = None,
              break_head_cap: bool = False, timer=None) -> HybridSparse:
    """The factored hybrid layout of B (isle_tpu/hybrid.py:313-399 with
    row_scale): the num_head words of the most entries (at most vocab,
    and at most the cap without break_head_cap) form the head. Raises
    where the cap leaves fewer than 8 rows, or with break_head_cap where
    isle_tpu's doc blocks would be narrower than 8."""
    num_head = int(min(num_head, sp.vocab))
    if break_head_cap:
        _check_doc_blocks(num_head, sp.num_docs, flat_cap)
    else:
        num_head = min(num_head, _head_cap(sp.num_docs, flat_cap))
    return split_by_head(sp, top_words(word_counts(sp), num_head), row_scale,
                         timer)


def hybrid_from_thresholds(
    A: DocSparse, zetas: torch.Tensor, head_budget_bytes: int,
    sample_rate: Optional[float] = None,
    uniforms: Optional[torch.Tensor] = None,
    docs: Optional[np.ndarray] = None,
    break_head_cap: bool = False,
    flat_cap: Optional[int] = None, timer=None,
) -> Tuple[HybridSparse, np.ndarray, float]:
    """B = threshold_and_copy(A, zetas) in the hybrid layout, with
    isle_tpu's head budget (hybrid.py:758-893): over A.num_docs columns
    without sampling, over the docs kept by sampling with it, capped at
    max_head_rows unless break_head_cap is set. isle_tpu fuses the two
    steps to save TPU scatters; the layout is the same. `docs` (a
    checkpoint's original_cols) selects B's docs in place of the draws,
    under the budget rule of `sample_rate`. `timer` takes the sampling's
    spans and the split's counters. Returns (B, original_cols, Frobenius
    norm of B squared)."""
    if sample_rate is None:  # refused before any work, as isle_tpu's
        num_head = head_rows(head_budget_bytes, A.vocab, A.num_docs,
                             flat_cap, break_head_cap)
    B, original_cols = threshold_and_copy(
        A, zetas, sample_rate=sample_rate, uniforms=uniforms, docs=docs,
        timer=timer)
    if sample_rate is not None:
        num_head = head_rows(head_budget_bytes, A.vocab, B.num_docs,
                             flat_cap, break_head_cap)
    frob_sq = float(frobenius_sq(B))
    return (to_hybrid(B, num_head, row_scale_from_zetas(zetas), flat_cap,
                      break_head_cap, timer),
            original_cols, frob_sq)


# ---------------------------------------------------------------------------
# The head product on the tensor cores
# ---------------------------------------------------------------------------


def split3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """x (float32) as hi + mid + lo, three bfloat16 tensors: each piece is
    the rest rounded to bf16's 8 significant bits, so the three hold x's
    24 to within 2^-24 relative (for normal floats below bf16's largest
    value, 3.39e38)."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.to(torch.float32)
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def head_dot_plain(head: torch.Tensor, other: torch.Tensor,
                   transpose: bool) -> torch.Tensor:
    """Plain version of head_dot: the head in float32, one float32
    matmul."""
    h = head.to(torch.float32)
    return (h.T if transpose else h) @ other


def head_dot(head: torch.Tensor, other: torch.Tensor,
             transpose: bool) -> torch.Tensor:
    """head^T @ other (transpose) or head @ other at float32 accuracy,
    head (R, D) bf16 binary, other float32: isle_tpu's _head_dot at
    Precision.HIGHEST (hybrid.py:452-467).

    On the card: other is split into hi + mid + lo (split3), the three
    pieces side by side as one bf16 operand, and a bf16 GEMM with a
    float32 output (aten::mm.dtype) reads the head once for all three.
    The head is 0/1, so every partial product is exact; the three column
    blocks are added lo + mid, then hi. head @ other sums over the docs
    in blocks of HEAD_DOC_BLOCK. The head is never upcast (8.6 GB at the
    NYTimes shape) and there is no fallback: the GEMM runs or raises. On
    a CPU tensor, head_dot_plain."""
    if head.device.type == "cpu":
        return head_dot_plain(head, other, transpose)

    def mm(a, b):
        return torch.mm(a, b, out_dtype=torch.float32)

    if transpose:
        out = _split_gemm(head.T, other, mm)
    else:
        out = _split_gemm(head, other, _in_doc_blocks(mm, HEAD_DOC_BLOCK))
    head_dot.calls += 1
    return out


head_dot.calls = 0

# head @ other sums over every doc (300,000 at the NYTimes shape). Where
# the terms share a sign, as a head word's docs do in B^T X, one float32
# accumulator over them drifts on the tensor cores: 7.5e-5 of |B| |X| on
# a word of 260,315 docs on an H100 (chip_smoke.py phase H). Blocks of
# this many docs, added in order in float32, bring it to 2e-5 for 5% more
# time at width 128 (head_probe.py, PERF.md).
HEAD_DOC_BLOCK = 32768


def _in_doc_blocks(mm, block: int):
    """mm over blocks of `block` of the summed dimension, the blocks'
    products added in order."""
    def blocked(a, b):
        out = mm(a[:, :block], b[:block])
        for lo in range(block, a.shape[1], block):
            out += mm(a[:, lo:lo + block], b[lo:lo + block])
        return out
    return blocked


def _split_gemm(a: torch.Tensor, other: torch.Tensor, mm) -> torch.Tensor:
    """a @ other through the three bf16 pieces of other: one mm(a,
    pieces) -> float32 over the pieces side by side, the blocks added lo
    + mid, then hi."""
    W = other.shape[1]
    # the pieces' row stride rounded up to 8 cells: aligned for cuBLAS
    pieces = torch.zeros((other.shape[0], -(-3 * W // 8) * 8),
                         dtype=torch.bfloat16, device=other.device)
    for i, p in enumerate(split3(other)):
        pieces[:, i * W:(i + 1) * W] = p
    out = mm(a, pieces)
    return (out[:, 2 * W:3 * W] + out[:, W:2 * W]) + out[:, :W]


def head_bt_x(h: HybridSparse, X: torch.Tensor,
              cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The head's part of B^T X, (num_docs, W), or of the docs `cols`
    only (Elkan's flagged docs, isle_tpu/elkans.py:150-158): the head
    against X's head rows times their row scale. With `cols` the head's
    columns are copied first: as much device memory again as the head
    holds where most docs are flagged, 16 GiB at a 16 GiB head past the
    cap (GpuConfig.break_head_cap)."""
    hw = h.head_words.long()
    head = h.head if cols is None else h.head[:, cols]
    return head_dot(head, X[hw] * h.row_scale[hw][:, None], transpose=True)


def h_bt_x(h: HybridSparse, X: torch.Tensor,
           chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """B^T X, (num_docs, W): the head on the tensor cores plus the tail on
    segsum_gather_rows."""
    return bt_x(h.tail, X, chunk) + head_bt_x(h, X)


def h_b_y(h: HybridSparse, Y: torch.Tensor,
          chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """B Y, (vocab, W). The tail has no entry of a head word, so the head
    rows land in zero rows of the tail's product: a plain add of unique
    rows."""
    out = b_y(h.tail, Y, chunk)
    hw = h.head_words.long()
    head_out = head_dot(h.head, Y[:h.num_docs], transpose=False)
    out[hw] += head_out * h.row_scale[hw][:, None]
    return out


def h_gram_x(h: HybridSparse, X: torch.Tensor,
             chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """(B B^T) X, the eigensolver's operator."""
    return h_b_y(h, h_bt_x(h, X, chunk), chunk)


def h_doc_l2sq(h: HybridSparse, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Per-doc squared norms: the head's row scales squared through the
    same split GEMM (width 1), plus the tail's segsum_onehot."""
    s2 = h.row_scale * h.row_scale
    head_l2 = head_dot(h.head, s2[h.head_words.long()][:, None],
                       transpose=True)[:, 0]
    return head_l2 + doc_l2sq(h.tail, chunk)


def h_spmm_flops(h: HybridSparse, width: int) -> int:
    """FLOPs of one h_bt_x or h_b_y: the tail's entries and every cell of
    the dense head (isle_tpu counts its MXU work the same way)."""
    return 2 * h.tail.nnz * width + 2 * h.num_head * h.num_docs * width


def h_to_dense(h: HybridSparse) -> np.ndarray:
    """Host float64 densification (small problems: the dense
    eigensolver)."""
    out = to_dense(h.tail)
    hw = h.head_words.cpu().numpy()
    scale = h.row_scale.cpu().numpy().astype(np.float64)[hw]
    out[hw] += h.head.cpu().to(torch.float64).numpy() * scale[:, None]
    return out
