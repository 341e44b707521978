// Segment sums over a SORTED segment stream: the two hand-written Hopper
// (sm_90a) kernels of the port. Built by isle_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through the plain C entry points at the end (ctypes).
//
// Replaces the two Pallas kernels of isle_tpu/pallas_ops.py:
//   segsum_onehot_kernel      <- _segsum_onehot_call (pallas_ops.py:236)
//   segsum_gather_rows_kernel <- _segsum_rows_call   (pallas_ops.py:203),
//                                with the row gather of segsum_gather_rows
//                                (pallas_ops.py:382) fused in; and
//   segsum_gather_rows_narrow_kernel, the same function for tables of at
//                                most 16 columns (the width-1 Lanczos
//                                matvecs).
// The TPU kernels build a (rcap, chunk) segment one-hot in VMEM and
// contract it on the MXU, then scatter the partial rows through a plan
// (plan_segments). Here the kernels find the run boundaries themselves, so
// no plan, rank cap or fallback scatter exists. The output keeps the JAX
// wrappers' shape: (num_segments + 1) rows, the spill row last. Entries
// whose segment lies outside [0, num_segments] add nothing.
//
// Both kernels cut the stream into slices of `chunk` consecutive entries
// (an nnz split, so a Zipf head word of 100k+ entries costs what any other
// entries cost) and give each warp one slice at a time, persistent over
// slices. A warp stages its slice's entries a batch at a time with
// cp.async (16-byte copies where aligned) into its own double buffer in
// shared memory: the next batch (of this slice or the warp's next one) is
// in flight while the current one reduces. A run of equal segments that
// crosses a slice edge is summed in parts: slot 0 holds the part of the
// run the slice starts in (begun in an earlier slice), slot 1 the part of
// the run it ends in (continued by a later one).
//
// segsum_onehot: out[seg, col] += (val or 1); without col (a one-column
//   sum such as the doc norms) every entry lies in column 0 and no column
//   array is read.
//   Bound: the stream read once (8 bytes an entry for counts, 12 with
//   values) and the output written once, 0.19 ms for the NYTimes ζ
//   histogram at 3.35 TB/s; a handful of operations an entry.
//   Design:
//   - Work units are (slice, column tile). Rows of the output are split
//     among slices: a slice owns the rows (seg[b0 - 1], seg[b1 - 1]] (the
//     last slice up to num_segments), whether they have entries or not,
//     and writes each owned row whole, zeros and `init` included. Every
//     cell is written once, so the wrapper allocates the output without a
//     zero-fill.
//   - A warp reduces its slice in a window of consecutive rows held dense
//     in shared memory (kOhCells cells: counts 1,024, one row of the ζ
//     histogram's 635 columns; float sums 512, 5 rows of 100). When an
//     entry's row lies past the window, the window's rows are stored
//     (coalesced, whole rows) and it moves on. A row wider than the window
//     takes column tiles, each a pass over the slice. Since every owned row is stored whole anyway, a dense
//     window never moves more global bytes than a sort of the slice's keys
//     would, so there is no sorted-keys path.
//   - Counts: each entry adds 1 to its cell with a shared atomicAdd (exact
//     and order-free; cheaper than grouping lanes with __match_any_sync).
//   - Float sums, in float64, in an order fixed by the input alone: each
//     lane first merges its 4 consecutive entries left to right and the
//     warp packs the ones that add something to the front of the batch
//     (pack_batch); then, per 32 packed entries, one cell for all lanes
//     takes a butterfly sum, distinct cells (a tag per cell tells) add
//     directly, and otherwise the lanes of each cell (__match_any_sync)
//     are gathered in lane order and summed by a segmented scan. A cell is
//     rounded to float32 once, when it is stored. A cell's n float32
//     terms sum exactly in float64 while they lie within a factor 2^29 / n
//     of each other, and then the cell is the exact sum rounded once,
//     whatever the slice length or where the stream starts. A doc's
//     normalized values at counts of small range (1-7 in the UCI-shaped
//     corpora) keep that; squares of counts of wide range need not (1 and
//     1000 over 822 entries: a factor 10^6 against 2^29 / 822), and there
//     the sum is only as close as float64's rounding. That is what makes a
//     doc's catchword mass the same in core and in a streamed chunk: at UCI
//     PubMed's shape many docs' masses tie a topic's rank threshold, and
//     a last-bit difference moves a doc across it (float32 sums moved the
//     two trainers' models apart by more than 1e-6).
//   - The two slot runs: counts add their nonzero cells with atomicAdd
//     into a row that segsum_onehot_edges_kernel has set to init before
//     (exact and order-free); float sums store them into a float64 carry
//     scratch, (num_slices, 2, ncols), and segsum_onehot_edges_kernel adds
//     each crossing run's parts in slice order after. No float atomics:
//     two launches on the same input give bit-equal sums.
//
// segsum_gather_rows: out[seg, :] += val * table[idx, :]. The one kernel of
//   the port's SpMM: B^T X (doc-sorted stream), B Y (word-sorted stream)
//   and the topic model B W.
//   Bound: the least traffic is the stream (12 bytes an entry), the table
//   and the output once, 0.22 ms at the NYTimes model SpMM (47.5M entries,
//   W = 100) at 3.35 TB/s. What the card really moves is one table row per
//   entry, 4 W bytes (19 GB there): where the table is larger than the
//   50 MB L2 the gathers come from HBM, so the kernel is bound by how many
//   row loads it keeps in flight, not by arithmetic (2 W flops an entry).
//   Where the table mostly fits L2 (B^T X: vocab rows, Zipf-skewed) the
//   same holds at L2 latency.
//   Design:
//   - Work units are (slice, column tile): a tile is 32 lanes of one warp
//     across the row, each lane one float4 (W % 4 == 0 and a 16-byte
//     aligned table and output) or one float (any W). W = 100 takes 25
//     lanes, 128 takes 32, W = 300 takes three tiles.
//   - Persistent blocks (the card's SMs x the blocks that fit on one,
//     kRowsBlocksPerSM) of kRowsWarps warps.
//   - Each lane issues kInFlight independent row loads before it adds any
//     of them, so a warp has kInFlight rows in flight instead of one.
//   - A run's sum over the batch in hand stays in registers; at the end of
//     each staged batch of kStage entries it is added into the lane's slot
//     of a shared-memory partial, which holds the run's earlier batches,
//     and the run is stored once, partial plus registers, with a plain
//     store when the slice owns the run. So no float32 chain is longer
//     than kStage adds: runs of up to 2,048 equal irrational values (the
//     words of the bite corpus, synth.bite_counts, in B onehot) summed in
//     one chain drift up to 2.7e-5 from the float64 sum, past the 1e-5 the
//     kernel is held to (1.5e-5 met on the card); in chains of 128, then
//     added, at most 1.8e-6 (tests/test_torch_bite.py). A run
//     that crosses a slice edge leaves its partial sums in a carry scratch,
//     (num_slices, 2, W) floats and (num_slices, 2) segment ids. A second
//     kernel adds each crossing run's partials in slice order in float64
//     and stores the row. No float atomics: two launches on the same input
//     give bit-equal output.
//   - accumulate = 1 adds each run's sum into `out` in place; rows without
//     entries are not touched. The word-sorted product over a table larger
//     than L2 (segsum.py, segsum_gather_rows_tiled) runs the kernel once
//     per doc tile of a tile-ordered copy of the stream, each pass into the
//     same output: a pass gathers only its tile's 65,536 rows (33.5 MB at
//     W = 128), which stay in L2 after first touch, and moves only the
//     output rows its tile reaches. Tile order, then the order within a
//     tile: two runs stay bit-equal.
//
// segsum_gather_rows_narrow: the same sums for W <= 16, above all W = 1
//   (the Lanczos matvecs, 632 launches a solve at the NYTimes shape).
//   Bound: the stream, 12 bytes an entry: 0.17 ms for 47.5M entries at
//   3.35 TB/s. The width-1 table (0.4-1.2 MB) sits whole in L2, so a row
//   load is an L2 hit, and the wide kernel's 32 lanes across the row leave
//   31 idle and each entry waiting on its own load.
//   Design:
//   - One warp per slice, persistent; the same cp.async double-buffered
//     staging of (seg, idx, val) batches. Lanes go across entries: each
//     takes kNarrowPer consecutive entries of the batch and issues all
//     their row loads before it adds any. At W = 1 the loads go with
//     lanes across consecutive entries (a frequent word's docs share
//     sectors) and the products are passed through shared memory.
//   - Each lane merges its entries left to right: runs that begin and end
//     inside it are stored at once; its first and last runs may go on in
//     the lanes around it. A segmented inclusive scan over the lanes'
//     last runs (__shfl_up_sync, a head flag where a run begins) in a
//     fixed tree order completes them; the lane where a run ends stores
//     it, and the batch's last run is carried to the next batch.
//   - Runs that cross a slice edge use the wide kernel's carry slots and
//     segsum_rows_carry_kernel. No float atomics: two launches on one
//     input are bit-equal.
//
// All kernels launch on the caller's stream, allocate nothing (the
// wrapper allocates the output and the carry scratch), and the entry
// points return cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copies `cnt` entries of the stream (seg, idx, val) from e0 into
// one warp's buffers: 16-byte copies where every array is aligned there,
// 4-byte copies for the rest. `idx` (onehot: every column 0) and `val`
// (counts) may be null.
__device__ __forceinline__ void stage_entries(int lane, int* s_seg, int* s_idx,
                                              float* s_val, const int* seg,
                                              const int* idx, const float* val,
                                              int64_t e0, int cnt) {
  int done = 0;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(seg + e0) |
                        (idx ? reinterpret_cast<uintptr_t>(idx + e0) : 0) |
                        (val ? reinterpret_cast<uintptr_t>(val + e0) : 0);
  if ((mis & 15) == 0) {
    done = cnt & ~3;
    for (int i = lane * 4; i < done; i += 128) {
      cp_async16(s_seg + i, seg + e0 + i);
      if (idx) cp_async16(s_idx + i, idx + e0 + i);
      if (val) cp_async16(s_val + i, val + e0 + i);
    }
  }
  for (int i = done + lane; i < cnt; i += 32) {
    cp_async4(s_seg + i, seg + e0 + i);
    if (idx) cp_async4(s_idx + i, idx + e0 + i);
    if (val) cp_async4(s_val + i, val + e0 + i);
  }
}

// The persistent grid: `want` blocks, at most as many as fit on the card.
cudaError_t blocks_on_card(const void* kernel, int threads, int device,
                           int64_t want, int* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return err;
  const int64_t resident =
      static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(want < resident ? want : resident);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// segsum_onehot
// ---------------------------------------------------------------------------

constexpr int kOhWarps = 4;  // warps per block
constexpr int kOhThreads = kOhWarps * 32;
// Entries per staged batch of a warp, and the blocks an SM must hold
// (5, at most 96 registers: the float64 sums spill at 6 and 80). Each
// warp double-buffers its batches. Chosen on the H100 with CUDA events
// on NYTimes-shaped streams: counts ran fastest with 256-entry batches,
// float sums with 128 (pack_batch's 4 entries a lane); more batches in
// flight or more registers cost warps.
template <bool kVal>
constexpr int kOhStage = kVal ? 128 : 256;
constexpr int kOhMinBlocks = 5;
// Cells of one warp's row window: counts are int32, float sums float64
// (half as many, in the same shared memory).
template <bool kVal>
constexpr int kOhCells = kVal ? 512 : 1024;

// The type a segment sum accumulates in: int32 counts in int32, float
// values in float64 (see "Float sums" above).
template <typename T>
struct AccOf {
  using type = T;
};
template <>
struct AccOf<float> {
  using type = double;
};
template <typename T>
using Acc = typename AccOf<T>::type;

template <typename T>
struct OnehotArgs {
  const int* seg;
  const int* col;    // null: every entry in column 0
  const float* val;  // float sums: the values; null for counts
  const T* init;     // added to every cell; null for none
  T* out;            // (num_segments + 1, ncols)
  Acc<T>* carry;     // float sums: (num_slices, 2, ncols); null for counts
  int64_t n;
  int64_t chunk;  // entries per slice
  int64_t num_slices;
  int num_segments;
  int ncols;
  int ct;      // columns of a column tile
  int ntiles;  // column tiles
  int rows;    // rows of the window: kOhCells / ct
};

// A slice's first and last segments and whether its runs cross its edges.
struct SliceEdges {
  int64_t b0, b1;
  int64_t prev;  // seg[b0 - 1]; -1 for the first slice
  int first, last;
  bool starts_before, continues_after;
};

__device__ __forceinline__ SliceEdges slice_edges(const int* seg, int64_t n,
                                                  int64_t chunk,
                                                  int64_t slice) {
  SliceEdges e;
  e.b0 = slice * chunk;
  e.b1 = e.b0 + chunk < n ? e.b0 + chunk : n;
  e.first = seg[e.b0];
  e.last = seg[e.b1 - 1];
  e.prev = e.b0 > 0 ? seg[e.b0 - 1] : -1;
  e.starts_before = e.b0 > 0 && e.prev == e.first;
  e.continues_after = e.b1 < n && seg[e.b1] == e.last;
  return e;
}

__device__ __forceinline__ bool in_rows(int64_t s, int num_segments) {
  return s >= 0 && s <= num_segments;
}

// The row the slice leaves in carry slot 1 (its last run, continued by
// the next slice and not begun before it), or -1.
__device__ __forceinline__ int slot1_row(const SliceEdges& e,
                                         int num_segments) {
  return e.continues_after && !(e.starts_before && e.first == e.last) &&
                 in_rows(e.last, num_segments)
             ? e.last
             : -1;
}

// The unit (slice, column tile) a warp has in hand: the columns
// [c0, c0 + cw), the last row R1 it writes (its rows start at the
// window's first row w0 when the unit opens), its slot rows (-1: none).
struct OnehotUnit {
  int64_t slice, b1, R1, w0;
  int c0, cw, slot0, slot1;
};

template <typename T>
__device__ __forceinline__ void open_unit(const OnehotArgs<T>& a,
                                          int64_t slice, int tile,
                                          OnehotUnit& t) {
  const int S = a.num_segments;
  t.slice = slice;
  t.c0 = tile * a.ct;
  t.cw = a.ncols - t.c0 < a.ct ? a.ncols - t.c0 : a.ct;
  const SliceEdges e = slice_edges(a.seg, a.n, a.chunk, slice);
  t.b1 = e.b1;
  // the rows (prev, last]; the slot 0 row is `prev` itself
  t.w0 = e.starts_before ? e.prev : e.prev + 1;
  if (t.w0 < 0) t.w0 = 0;
  t.R1 = slice == a.num_slices - 1 ? S : (e.last < S ? e.last : S);
  t.slot0 = e.starts_before && in_rows(e.first, S) ? e.first : -1;
  t.slot1 = slot1_row(e, S);
}

// A warp's walk over its batches: unit (slice, tile), then the batch at
// entry st of the slice [st, b1); the units are nwarps apart, that is q
// slices and r tiles (no 64-bit division in the loop).
struct OnehotWalk {
  int64_t slice, st, b1;
  int tile;
};

template <typename T>
__device__ __forceinline__ void walk_to(const OnehotArgs<T>& a,
                                        OnehotWalk& p, int64_t slice,
                                        int tile) {
  p.slice = slice;
  p.tile = tile;
  p.st = slice * a.chunk;
  p.b1 = p.st + a.chunk < a.n ? p.st + a.chunk : a.n;
}

// The next batch: later in the slice, or the first of the next unit.
// Returns whether it opened a new unit.
template <typename T, bool kVal>
__device__ __forceinline__ bool walk_next(const OnehotArgs<T>& a,
                                          OnehotWalk& p, int64_t q, int r) {
  p.st += kOhStage<kVal>;
  if (p.st < p.b1) return false;
  int tile = p.tile + r;
  int64_t slice = p.slice + q;
  if (tile >= a.ntiles) {
    tile -= a.ntiles;
    ++slice;
  }
  walk_to(a, p, slice, tile);
  return true;
}

// Row r's cells that other slices add to as well, from the window (and
// cleared there) or zeros: float sums into carry slot k, counts added to
// the output, which segsum_onehot_edges_kernel has set to init.
template <typename T, bool kVal>
__device__ __forceinline__ void put_slot(const OnehotArgs<T>& a,
                                         const OnehotUnit& t, Acc<T>* buf,
                                         int lane, int k, int64_t r,
                                         bool from_buf) {
  for (int cc = lane; cc < t.cw; cc += 32) {
    Acc<T> x = 0;
    if (from_buf) {
      Acc<T>* const p = buf + (r - t.w0) * t.cw + cc;
      x = *p;
      *p = 0;
    }
    if constexpr (kVal) {
      a.carry[(2 * t.slice + k) * a.ncols + t.c0 + cc] = x;
    } else {
      if (x != 0) atomicAdd(a.out + r * a.ncols + t.c0 + cc, x);
    }
  }
}

// out[i] = init[i] + src[i] (src cleared) for i in [0, cnt), the warp's
// lanes strided, with four loads of init in flight a lane before the first
// add. A streamed caller passes its running result as init, and in the
// plain loop of emit each store waits for its own load of init, a round
// trip to memory a cell: the ζ histogram's chunk launch took 10x the time
// of the same launch without init. Counts only: the float kernel has no
// registers to spare for it (it spilled, and its streamed uses pass no
// init).
template <typename T>
__device__ __forceinline__ void store_span_init(const T* init, T* out,
                                                T* src, bool from_buf,
                                                int64_t cnt, int lane) {
  int64_t i = lane;
  for (; i + 96 < cnt; i += 128) {
    T x0 = init[i], x1 = init[i + 32], x2 = init[i + 64], x3 = init[i + 96];
    if (from_buf) {
      x0 += src[i];
      x1 += src[i + 32];
      x2 += src[i + 64];
      x3 += src[i + 96];
      src[i] = src[i + 32] = src[i + 64] = src[i + 96] = T(0);
    }
    out[i] = x0;
    out[i + 32] = x1;
    out[i + 64] = x2;
    out[i + 96] = x3;
  }
  for (; i < cnt; i += 32) {
    T x = init[i];
    if (from_buf) {
      x += src[i];
      src[i] = T(0);
    }
    out[i] = x;
  }
}

// Stores rows [ra, min(rb, R1 + 1)) of the unit: init plus the window's
// cells (clearing them) or plus nothing (rows without entries here).
// kInit: counts with a.init given, through store_span_init.
template <typename T, bool kVal, bool kInit>
__device__ __forceinline__ void emit(const OnehotArgs<T>& a,
                                     const OnehotUnit& t, Acc<T>* buf,
                                     int lane, int64_t ra, int64_t rb,
                                     bool from_buf) {
  if (rb > t.R1 + 1) rb = t.R1 + 1;
  if (ra >= rb) return;
  if (ra == t.slot0) {
    put_slot<T, kVal>(a, t, buf, lane, 0, ra, from_buf);
    ++ra;
  }
  if (ra < rb && rb - 1 == t.slot1) {
    put_slot<T, kVal>(a, t, buf, lane, 1, rb - 1, from_buf);
    --rb;
  }
  if (ra >= rb) return;
  if (a.ntiles == 1) {  // whole rows: one contiguous span of the output
    const int64_t o = ra * a.ncols;
    const int64_t cnt = (rb - ra) * a.ncols;
    Acc<T>* const src = buf + (from_buf ? (ra - t.w0) * t.cw : 0);
    if constexpr (kInit) {
      store_span_init<T>(a.init + o, a.out + o, src, from_buf, cnt, lane);
    } else {
      for (int64_t i = lane; i < cnt; i += 32) {
        Acc<T> x = a.init ? Acc<T>(a.init[o + i]) : Acc<T>(0);
        if (from_buf) {
          x += src[i];
          src[i] = 0;
        }
        a.out[o + i] = static_cast<T>(x);
      }
    }
  } else {
    for (int64_t r = ra; r < rb; ++r) {
      const int64_t o = r * a.ncols + t.c0;
      Acc<T>* const src = buf + (from_buf ? (r - t.w0) * t.cw : 0);
      if constexpr (kInit) {
        store_span_init<T>(a.init + o, a.out + o, src, from_buf, t.cw, lane);
      } else {
        for (int cc = lane; cc < t.cw; cc += 32) {
          Acc<T> x = a.init ? Acc<T>(a.init[o + cc]) : Acc<T>(0);
          if (from_buf) {
            x += src[cc];
            src[cc] = 0;
          }
          a.out[o + cc] = static_cast<T>(x);
        }
      }
    }
  }
}

// The warp's shared memory: two staged batches, the row window, and
// for float sums the packed batch's values, a tag per window cell and a
// 32-slot scratch, all float64 but the staged values.
template <typename T, bool kVal>
struct __align__(16) OnehotSmem {
  int seg[2][kOhStage<kVal>];
  int col[2][kOhStage<kVal>];
  float val[2][kVal ? kOhStage<kVal> : 4];
  Acc<T> buf[kOhCells<kVal>];
  Acc<T> packed[kVal ? kOhStage<kVal> : 2];
  Acc<T> part[32];
  unsigned char tag[kVal ? kOhCells<kVal> : 4];
  int start[32];
};

// Adds the entries of the `mine` lanes to their window cells. Counts:
// shared atomicAdd (exact, order-free). Float sums, in an order that the
// lanes' positions alone fix: one cell for every lane, a butterfly sum;
// no two lanes on one cell (a tag per cell tells), each adds its own;
// else the lanes of a cell (__match_any_sync) are gathered in lane order
// and summed by a segmented scan.
template <typename T, bool kVal>
__device__ __forceinline__ void accumulate(OnehotSmem<T, kVal>& m, int lane,
                                           bool mine, int cell, Acc<T> v) {
  const unsigned live = __ballot_sync(kFull, mine);
  if (live == 0) return;
  if constexpr (!kVal) {
    if (mine) atomicAdd(m.buf + cell, 1);
  } else {
    const int lead = __ffs(live) - 1;
    const int cell0 = __shfl_sync(kFull, cell, lead);
    if (__all_sync(kFull, !mine || cell == cell0)) {
      Acc<T> x = mine ? v : 0.0;
      for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
      if (lane == lead) m.buf[cell] += x;
    } else {
      if (mine) m.tag[cell] = static_cast<unsigned char>(lane);
      __syncwarp();
      const bool clash = mine && m.tag[cell] != lane;
      if (!__any_sync(kFull, clash)) {
        if (mine) m.buf[cell] += v;
      } else {
        const unsigned g = __match_any_sync(kFull, mine ? cell : -1 - lane);
        const int size = __popc(g);
        const int rank = __popc(g & ((1u << lane) - 1u));
        // the groups in the order of their first lanes, each contiguous
        const int leader = __ffs(g) - 1;
        int x = lane == leader ? size : 0;
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, x, d);
          if (lane >= d) x += y;
        }
        const int first = __shfl_sync(kFull, x, leader) - size;
        const int pos = first + rank;
        m.part[pos] = mine ? v : 0.0;
        m.start[pos] = first;
        __syncwarp();
        Acc<T> s = m.part[lane];
        const int begin = m.start[lane];
        for (int d = 1; d < 32; d <<= 1) {
          const Acc<T> y = __shfl_up_sync(kFull, s, d);
          if (lane - d >= begin) s += y;
        }
        s = __shfl_sync(kFull, s, pos);  // the group's sum up to this lane
        if (mine && rank == size - 1) m.buf[cell] += s;
      }
    }
  }
  __syncwarp();
}

// Float sums: each lane merges its 4 consecutive entries of the batch in
// slot k in order (neighbours on one cell add up, left to right, in
// float64) and drops those that add nothing here; the warp packs what is
// left to the front of the slot (the sums to `packed`), in stream order.
// Returns the packed count. The
// mass's masked entries (most of its stream) and a doc's run of norms
// then cost the accumulation nothing.
template <typename T, bool kVal>
__device__ __forceinline__ int pack_batch(OnehotSmem<T, kVal>& m, int lane,
                                          int k, int cnt, int num_segments,
                                          int c0, int cw, bool has_col) {
  static_assert(kOhStage<true> == 4 * 32, "4 entries a lane");
  const int base = lane * 4;
  const int4 s4 = *reinterpret_cast<const int4*>(&m.seg[k][base]);
  const int4 c4 = has_col ? *reinterpret_cast<const int4*>(&m.col[k][base])
                          : make_int4(0, 0, 0, 0);
  const float4 v4 = *reinterpret_cast<const float4*>(&m.val[k][base]);
  const int es[4] = {s4.x, s4.y, s4.z, s4.w};
  const int ec[4] = {c4.x, c4.y, c4.z, c4.w};
  const float ev[4] = {v4.x, v4.y, v4.z, v4.w};
  bool ok[4];
  Acc<T> run[4];  // the sum of the run of equal cells ending at j
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ok[j] = base + j < cnt && in_rows(es[j], num_segments) && ec[j] >= c0 &&
            ec[j] < c0 + cw;
    const bool joins = j > 0 && ok[j] && ok[j - 1] && es[j] == es[j - 1] &&
                       ec[j] == ec[j - 1];
    run[j] = joins ? run[j - 1] + ev[j] : Acc<T>(ev[j]);
  }
  bool keep[4];
  int kept = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    keep[j] = ok[j] && !(j < 3 && ok[j + 1] && es[j + 1] == es[j] &&
                         ec[j + 1] == ec[j]);
    kept += keep[j];
  }
  int x = kept;  // inclusive scan of the kept counts
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  const int total = __shfl_sync(kFull, x, 31);
  int pos = x - kept;
  __syncwarp();  // every lane holds its entries before any is overwritten
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (keep[j]) {
      m.seg[k][pos] = es[j];
      m.col[k][pos] = ec[j];
      m.packed[pos] = run[j];
      ++pos;
    }
  }
  __syncwarp();
  return total;
}

// Stages the batch at `pre` into buffer k and walks `pre` on; one
// cp.async group either way.
template <typename T, bool kVal>
__device__ __forceinline__ void stage_next(const OnehotArgs<T>& a,
                                           OnehotSmem<T, kVal>& m, int lane,
                                           OnehotWalk& pre, int64_t q, int r,
                                           int k) {
  if (pre.slice < a.num_slices) {
    const int64_t left = pre.b1 - pre.st;
    stage_entries(lane, m.seg[k], m.col[k], m.val[k], a.seg, a.col,
                  kVal ? a.val : nullptr, pre.st,
                  static_cast<int>(left < kOhStage<kVal> ? left
                                                         : kOhStage<kVal>));
    walk_next<T, kVal>(a, pre, q, r);
  }
  cp_async_commit();
}

// One warp per (slice, column tile) unit, persistent over units. kInit:
// counts with a.init given (see emit).
template <typename T, bool kVal, bool kInit>
__global__ void __launch_bounds__(kOhThreads, kOhMinBlocks)
    segsum_onehot_kernel(const OnehotArgs<T> a) {
  constexpr int kStg = kOhStage<kVal>;
  __shared__ __align__(16) OnehotSmem<T, kVal> smem[kOhWarps];
  const int lane = threadIdx.x & 31;
  OnehotSmem<T, kVal>& m = smem[threadIdx.x >> 5];
  for (int i = lane; i < kOhCells<kVal>; i += 32) m.buf[i] = 0;
  __syncwarp();
  const int S = a.num_segments;
  const int nwarps = gridDim.x * kOhWarps;
  const int u0 = blockIdx.x * kOhWarps + (threadIdx.x >> 5);
  const int64_t q = nwarps / a.ntiles;
  const int r = nwarps % a.ntiles;
  OnehotWalk cur;
  walk_to(a, cur, u0 / a.ntiles, u0 % a.ntiles);
  if (cur.slice >= a.num_slices) return;
  OnehotUnit t;
  open_unit(a, cur.slice, cur.tile, t);

  // the next batch (`pre`) is in flight while the one in buffer k reduces
  OnehotWalk pre = cur;
  stage_next(a, m, lane, pre, q, r, 0);
  for (int k = 0;; k ^= 1) {
    stage_next(a, m, lane, pre, q, r, k ^ 1);
    cp_async_wait_all_but_one();
    __syncwarp();

    const int64_t left = t.b1 - cur.st;
    int cnt = static_cast<int>(left < kStg ? left : kStg);
    if constexpr (kVal) {
      cnt = pack_batch(m, lane, k, cnt, S, t.c0, t.cw, a.col != nullptr);
    }
    for (int g = 0; g < cnt; g += 32) {
      const int i = g + lane;
      int s = -1, c = -1;
      Acc<T> v = 0;
      if (i < cnt) {
        s = m.seg[k][i];
        c = a.col ? m.col[k][i] : 0;
        if constexpr (kVal) v = m.packed[i];
      }
      const bool ok =
          i < cnt && in_rows(s, S) && c >= t.c0 && c < t.c0 + t.cw;
      for (;;) {
        const int64_t lim = t.w0 + a.rows;
        const bool mine = ok && s >= t.w0 && s < lim;
        accumulate<T, kVal>(
            m, lane, mine,
            mine ? static_cast<int>(s - t.w0) * t.cw + c - t.c0 : 0, v);
        const unsigned beyond = __ballot_sync(kFull, ok && s >= lim);
        if (beyond == 0) break;
        // the window is done: store it and the rows up to the next entry's
        const int next = __shfl_sync(kFull, s, __ffs(beyond) - 1);
        emit<T, kVal, kInit>(a, t, m.buf, lane, t.w0, lim, true);
        emit<T, kVal, kInit>(a, t, m.buf, lane, lim, next, false);
        t.w0 = next;
        __syncwarp();  // the cleared cells, before other lanes add to them
      }
    }
    if (left <= kStg) {  // the unit's last batch
      const int64_t lim = t.w0 + a.rows;
      emit<T, kVal, kInit>(a, t, m.buf, lane, t.w0, lim, true);
      emit<T, kVal, kInit>(a, t, m.buf, lane, lim, t.R1 + 1, false);
    }
    __syncwarp();
    if (walk_next<T, kVal>(a, cur, q, r)) {
      if (cur.slice >= a.num_slices) break;
      open_unit(a, cur.slice, cur.tile, t);
    }
  }
}

// The rows of runs that cross a slice edge, one warp per slice with a
// slot 1 run. Counts (no carry): sets the row to init (or 0) before
// segsum_onehot_kernel adds each slice's part. Float sums: after
// segsum_onehot_kernel, adds to init the slot 1 part and the slot 0 parts
// of the following slices the run reaches, in slice order.
template <typename T>
__global__ void __launch_bounds__(kOhThreads)
    segsum_onehot_edges_kernel(const OnehotArgs<T> a) {
  const int lane = threadIdx.x & 31;
  const int64_t slice =
      static_cast<int64_t>(blockIdx.x) * kOhWarps + (threadIdx.x >> 5);
  if (slice >= a.num_slices) return;
  const int s =
      slot1_row(slice_edges(a.seg, a.n, a.chunk, slice), a.num_segments);
  if (s < 0) return;
  int64_t end = slice + 1;  // slices [slice + 1, end) hold the run in slot 0
  if (a.carry) {
    for (;;) {
      // lane q looks at slice end + q; the run reaches the leading ones
      const int64_t j = end + lane;
      const bool same = j < a.num_slices && a.seg[j * a.chunk] == s;
      const unsigned ball = __ballot_sync(kFull, same);
      const int m = ball == kFull ? 32 : __ffs(~ball) - 1;
      end += m;
      if (m < 32) break;
    }
  }
  const int64_t o = static_cast<int64_t>(s) * a.ncols;
  for (int c = lane; c < a.ncols; c += 32) {
    Acc<T> x = a.init ? Acc<T>(a.init[o + c]) : Acc<T>(0);
    if (a.carry) {
      Acc<T> part = a.carry[(2 * slice + 1) * a.ncols + c];
      for (int64_t j = slice + 1; j < end; ++j) {
        part += a.carry[2 * j * a.ncols + c];
      }
      x += part;
    }
    a.out[o + c] = static_cast<T>(x);
  }
}

template <typename T, bool kVal, bool kInit>
cudaError_t launch_onehot_main(const OnehotArgs<T>& a, int device,
                               cudaStream_t stream) {
  const int64_t units = a.num_slices * a.ntiles;
  int grid = 0;
  const cudaError_t err = blocks_on_card(
      reinterpret_cast<const void*>(segsum_onehot_kernel<T, kVal, kInit>),
      kOhThreads, device, (units + kOhWarps - 1) / kOhWarps, &grid);
  if (err != cudaSuccess) return err;
  segsum_onehot_kernel<T, kVal, kInit><<<grid, kOhThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kVal>
cudaError_t launch_onehot(OnehotArgs<T> a, int device, cudaStream_t stream) {
  a.ct = a.ncols < kOhCells<kVal> ? a.ncols : kOhCells<kVal>;
  a.ntiles = (a.ncols + a.ct - 1) / a.ct;
  a.rows = kOhCells<kVal> / a.ct;
  const int edge_blocks =
      static_cast<int>((a.num_slices + kOhWarps - 1) / kOhWarps);
  cudaError_t err;
  if (!kVal) {
    segsum_onehot_edges_kernel<T><<<edge_blocks, kOhThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (!kVal) {
    err = a.init ? launch_onehot_main<T, kVal, true>(a, device, stream)
                 : launch_onehot_main<T, kVal, false>(a, device, stream);
  } else {
    err = launch_onehot_main<T, kVal, false>(a, device, stream);
  }
  if (err != cudaSuccess || !kVal) return err;
  segsum_onehot_edges_kernel<T><<<edge_blocks, kOhThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// segsum_gather_rows
// ---------------------------------------------------------------------------

constexpr int kRowsWarps = 8;  // warps per block
constexpr int kRowsThreads = kRowsWarps * 32;
// 4 blocks (32 warps) an SM, at most 64 registers a thread: on the H100,
// 4 rows in flight in each of 32 warps ran faster than 8 in each of 16
// (the warps overlap one another's waits), and 5 or more blocks spill.
constexpr int kRowsBlocksPerSM = 4;
constexpr int kInFlight = 4;  // row loads a lane issues before it adds
constexpr int kStage = 128;   // entries per staged batch of one warp

struct RowsArgs {
  const int* seg;
  const int* idx;
  const float* val;
  const float* table;
  float* out;
  float* carry;    // (num_slices, 2, W)
  int* carry_seg;  // (num_slices, 2); -1 where the slot holds nothing
  int64_t n;
  int64_t table_rows;
  int64_t chunk;  // entries per slice
  int64_t num_slices;
  int W;
  int num_segments;
  int ntiles;      // column tiles of 32 lanes
  int accumulate;  // 1: out += sums (the init carry); 0: out = sums
};

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ void vzero(float& a) { a = 0.0f; }
__device__ __forceinline__ void vzero(float4& a) {
  a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ void vfma(float& acc, float v, float r) {
  acc = fmaf(v, r, acc);
}
__device__ __forceinline__ void vfma(float4& acc, float v, const float4& r) {
  acc.x = fmaf(v, r.x, acc.x);
  acc.y = fmaf(v, r.y, acc.y);
  acc.z = fmaf(v, r.z, acc.z);
  acc.w = fmaf(v, r.w, acc.w);
}
__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// One warp per (slice, column tile) unit, persistent over units.
template <int VEC>
__global__ void __launch_bounds__(kRowsThreads, kRowsBlocksPerSM)
    segsum_gather_rows_kernel(const RowsArgs a) {
  using V = typename Vec<VEC>::T;
  __shared__ __align__(16) int s_seg[kRowsWarps][2][kStage];
  __shared__ __align__(16) int s_idx[kRowsWarps][2][kStage];
  __shared__ __align__(16) float s_val[kRowsWarps][2][kStage];
  // each thread's sum of the run in hand over the batches before this
  // one, at its threadIdx.x (an address that needs no register kept)
  __shared__ __align__(16) typename Vec<VEC>::T s_part[kRowsThreads];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kRowsWarps;
  const int64_t units = a.num_slices * a.ntiles;
  int64_t u = static_cast<int64_t>(blockIdx.x) * kRowsWarps + w;
  if (u >= units) return;
  const int WV = a.W / VEC;  // vectors per row
  const V* __restrict__ table = reinterpret_cast<const V*>(a.table);
  V* __restrict__ out = reinterpret_cast<V*>(a.out);
  V* __restrict__ carry = reinterpret_cast<V*>(a.carry);

  // the unit in hand
  int64_t slice = 0, b0 = 0, b1 = 0;
  int col = 0;
  // seg_writer: the lane that writes the slice's carry segment ids
  bool active = false, seg_writer = false, starts_before = false,
       continues_after = false;
  // the run in hand
  int cur = 0;
  bool have = false, first = true;
  V acc;
  vzero(acc);
  vzero(s_part[threadIdx.x]);

  auto open_unit = [&]() {
    slice = u / a.ntiles;
    const int tile = static_cast<int>(u - slice * a.ntiles);
    b0 = slice * a.chunk;
    b1 = b0 + a.chunk < a.n ? b0 + a.chunk : a.n;
    col = tile * 32 + lane;
    active = col < WV;
    seg_writer = tile == 0 && lane == 0;
    starts_before = b0 > 0 && a.seg[b0 - 1] == a.seg[b0];
    continues_after = b1 < a.n && a.seg[b1] == a.seg[b1 - 1];
    have = false;
    first = true;
    if (seg_writer) {
      a.carry_seg[2 * slice] = -1;
      a.carry_seg[2 * slice + 1] = -1;
    }
  };
  // Stores the sum of the run `cur` (the batches before this one in the
  // lane's shared slot, which it clears, plus acc): into the carry slot 0
  // when the run began before this slice, slot 1 when it goes on after
  // it, else into its output row, which no other unit writes.
  auto flush = [&](bool last) {
    V sum = s_part[threadIdx.x];
    vadd(sum, acc);
    vzero(s_part[threadIdx.x]);
    const bool in_range = cur >= 0 && cur <= a.num_segments;
    int slot = -1;
    if (first && starts_before) {
      slot = 0;
    } else if (last && continues_after) {
      slot = 1;
    }
    first = false;
    if (slot >= 0) {
      if (seg_writer) {
        a.carry_seg[2 * slice + slot] = in_range ? cur : -1;
      }
      if (in_range && active) carry[(2 * slice + slot) * WV + col] = sum;
    } else if (in_range && active) {
      V* p = out + static_cast<int64_t>(cur) * WV + col;
      if (a.accumulate) {
        V o = *p;
        vadd(o, sum);
        *p = o;
      } else {
        *p = sum;
      }
    }
  };

  open_unit();
  int buf = 0;
  int64_t st = b0;  // first entry of the batch in hand
  stage_entries(lane, s_seg[w][0], s_idx[w][0], s_val[w][0], a.seg, a.idx,
                a.val, st,
                static_cast<int>(b1 - st < kStage ? b1 - st : kStage));
  cp_async_commit();
  for (;;) {
    // the next batch: later in this slice, or the first of the next unit
    int64_t nu = u, nst = st + kStage, nend = b1;
    if (nst >= b1) {
      nu = u + nwarps;
      if (nu < units) {
        const int64_t ns = nu / a.ntiles;
        nst = ns * a.chunk;
        nend = nst + a.chunk < a.n ? nst + a.chunk : a.n;
      }
    }
    if (nu < units) {
      stage_entries(lane, s_seg[w][buf ^ 1], s_idx[w][buf ^ 1],
                    s_val[w][buf ^ 1], a.seg, a.idx, a.val, nst,
                    static_cast<int>(nend - nst < kStage ? nend - nst
                                                         : kStage));
    }
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncwarp();

    const int cnt = static_cast<int>(b1 - st < kStage ? b1 - st : kStage);
    const int* bs = s_seg[w][buf];
    const int* bi = s_idx[w][buf];
    const float* bv = s_val[w][buf];
    for (int g = 0; g < cnt; g += kInFlight) {
      V r[kInFlight];
#pragma unroll
      for (int p = 0; p < kInFlight; ++p) {
        vzero(r[p]);
        const int i = g + p;
        if (i < cnt && active) {
          const int row = bi[i];
          if (row >= 0 && row < a.table_rows) {
            r[p] = __ldg(table + static_cast<int64_t>(row) * WV + col);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < kInFlight; ++p) {
        const int i = g + p;
        if (i < cnt) {
          const int s = bs[i];
          if (!have || s != cur) {
            if (have) flush(false);
            cur = s;
            have = true;
            vzero(acc);
          }
          vfma(acc, bv[i], r[p]);
        }
      }
    }
    if (st + kStage >= b1 && have) {
      flush(true);
    } else if (have) {  // the run goes on: its batch joins the partial
      V part = s_part[threadIdx.x];
      vadd(part, acc);
      s_part[threadIdx.x] = part;
      vzero(acc);
    }
    __syncwarp();
    if (nu >= units) break;
    if (nu != u) {
      u = nu;
      open_unit();
    }
    st = nst;
    buf ^= 1;
  }
}

// Adds every slice-crossing run: the run that slice `a` ends in (carry
// slot 1), plus slot 0 of each following slice that the run reaches, in
// slice order, in float64 (a frequent word's run crosses hundreds of
// slices); then stores the row, rounded once. One warp per (slice, tile
// of 32 columns), a lane a column (a.ntiles tiles of 32 floats, whatever
// the vector width of the kernel that filled the slots).
__global__ void __launch_bounds__(kRowsThreads)
    segsum_rows_carry_kernel(const RowsArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t u =
      static_cast<int64_t>(blockIdx.x) * kRowsWarps + (threadIdx.x >> 5);
  if (u >= a.num_slices * a.ntiles) return;
  const int64_t slice = u / a.ntiles;
  const int tile = static_cast<int>(u - slice * a.ntiles);
  const int s = a.carry_seg[2 * slice + 1];
  if (s < 0) return;
  const int W = a.W;
  const int col = tile * 32 + lane;
  const bool active = col < W;
  const float* carry = a.carry;
  double acc = 0.0;
  if (active) acc += carry[(2 * slice + 1) * W + col];
  for (int64_t j = slice + 1;; j += 32) {
    // lane q looks at slice j + q; the run reaches the leading ones
    const int64_t jq = j + lane;
    const bool same = jq < a.num_slices && a.carry_seg[2 * jq] == s;
    const unsigned ball = __ballot_sync(kFull, same);
    const int m = ball == kFull ? 32 : __ffs(~ball) - 1;
    if (active) {
      for (int q = 0; q < m; ++q) acc += carry[2 * (j + q) * W + col];
    }
    if (m < 32) break;
  }
  if (active) {
    float* p = a.out + static_cast<int64_t>(s) * W + col;
    if (a.accumulate) {
      *p += static_cast<float>(acc);
    } else {
      *p = static_cast<float>(acc);
    }
  }
}

// ---------------------------------------------------------------------------
// segsum_gather_rows_narrow: the same sums for tables of at most 16 columns
// ---------------------------------------------------------------------------

constexpr int kNarrowMaxW = 16;
constexpr int kNarrowWarps = 4;  // warps per block
constexpr int kNarrowThreads = kNarrowWarps * 32;
// Entries a lane merges per batch (a warp's batch is 32 of these), and the
// blocks an SM must hold: the lane's rows in flight are kNarrowPer * WC
// floats, so the wider tables take fewer entries a lane and fewer blocks.
template <int WC>
constexpr int kNarrowPer = WC <= 2 ? 4 : 2;
template <int WC>
constexpr int kNarrowMinBlocks = WC <= 2 ? 8 : (WC == 4 ? 6 : (WC == 8 ? 4 : 2));

template <typename T, int N>
struct VecOf;
template <>
struct VecOf<int, 4> {
  using type = int4;
};
template <>
struct VecOf<int, 2> {
  using type = int2;
};
template <>
struct VecOf<float, 4> {
  using type = float4;
};
template <>
struct VecOf<float, 2> {
  using type = float2;
};

// dst = src[0, E): vector reads of shared memory (E is 2, 4 or 8 and src
// is E-aligned), so that 32 lanes reading E consecutive entries each do
// not queue on the same banks.
template <int E, typename T>
__device__ __forceinline__ void read_lane(const T* src, T (&dst)[E]) {
  constexpr int N = E % 4 == 0 ? 4 : 2;
  using V = typename VecOf<T, N>::type;
#pragma unroll
  for (int q = 0; q < E; q += N) {
    const V v = *reinterpret_cast<const V*>(src + q);
    dst[q] = v.x;
    dst[q + 1] = v.y;
    if constexpr (N == 4) {
      dst[q + 2] = v.z;
      dst[q + 3] = v.w;
    }
  }
}

// Stores the sum of run `s` of the slice: into carry slot 0 when the run
// began in an earlier slice, slot 1 when it goes on in a later one (the
// slots of segsum_gather_rows_kernel, so segsum_rows_carry_kernel adds
// them), else into its output row, which no other warp writes.
template <int WC>
__device__ __forceinline__ void narrow_store(const RowsArgs& a,
                                             const SliceEdges& e,
                                             int64_t slice, int s,
                                             const float (&x)[WC]) {
  if (!in_rows(s, a.num_segments)) return;
  float* dst;
  bool add = false;
  if (e.starts_before && s == e.first) {
    dst = a.carry + 2 * slice * a.W;
  } else if (e.continues_after && s == e.last) {
    dst = a.carry + (2 * slice + 1) * a.W;
  } else {
    dst = a.out + static_cast<int64_t>(s) * a.W;
    add = a.accumulate != 0;
  }
#pragma unroll
  for (int c = 0; c < WC; ++c) {
    if (c < a.W) dst[c] = add ? dst[c] + x[c] : x[c];
  }
}

// One warp per slice, persistent over slices; lanes across entries (the
// wide kernel puts them across the row, which at W = 1 leaves 31 of 32
// idle). WC: W rounded up to 1, 2, 4, 8 or 16.
template <int WC>
__global__ void __launch_bounds__(kNarrowThreads, kNarrowMinBlocks<WC>)
    segsum_gather_rows_narrow_kernel(const RowsArgs a) {
  constexpr int E = kNarrowPer<WC>;
  constexpr int kStg = 32 * E;
  __shared__ __align__(16) int s_seg[kNarrowWarps][2][kStg];
  __shared__ __align__(16) int s_idx[kNarrowWarps][2][kStg];
  __shared__ __align__(16) float s_val[kNarrowWarps][2][kStg];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kNarrowWarps;
  int64_t slice = static_cast<int64_t>(blockIdx.x) * kNarrowWarps + w;
  if (slice >= a.num_slices) return;
  const int W = a.W;
  // whole rows as float4 where every row starts 16-byte aligned
  const bool v4 = WC >= 4 && W == WC &&
                  (reinterpret_cast<uintptr_t>(a.table) & 15) == 0;
  const int S = a.num_segments;

  SliceEdges e;
  auto open_slice = [&]() {
    e = slice_edges(a.seg, a.n, a.chunk, slice);
    if (lane == 0) {
      a.carry_seg[2 * slice] =
          e.starts_before && in_rows(e.first, S) ? e.first : -1;
      a.carry_seg[2 * slice + 1] = slot1_row(e, S);
    }
  };
  open_slice();

  // the run that the warp's last batch ended in, held by every lane
  bool have = false;
  int cseg = 0;
  float C[WC];
#pragma unroll
  for (int c = 0; c < WC; ++c) C[c] = 0.0f;

  int buf = 0;
  int64_t st = e.b0;  // first entry of the batch in hand
  stage_entries(lane, s_seg[w][0], s_idx[w][0], s_val[w][0], a.seg, a.idx,
                a.val, st,
                static_cast<int>(e.b1 - st < kStg ? e.b1 - st : kStg));
  cp_async_commit();
  for (;;) {
    // the next batch: later in this slice, or the first of the next one
    int64_t ns = slice, nst = st + kStg, nend = e.b1;
    if (nst >= e.b1) {
      ns = slice + nwarps;
      if (ns < a.num_slices) {
        nst = ns * a.chunk;
        nend = nst + a.chunk < a.n ? nst + a.chunk : a.n;
      }
    }
    if (ns < a.num_slices) {
      stage_entries(lane, s_seg[w][buf ^ 1], s_idx[w][buf ^ 1],
                    s_val[w][buf ^ 1], a.seg, a.idx, a.val, nst,
                    static_cast<int>(nend - nst < kStg ? nend - nst : kStg));
    }
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncwarp();

    const int cnt = static_cast<int>(e.b1 - st < kStg ? e.b1 - st : kStg);
    const int base = lane * E;
    const int nv = cnt - base < 0 ? 0 : (cnt - base < E ? cnt - base : E);
    const int last_lane = (cnt - 1) / E;  // the last lane with entries
    int sj[E];
    read_lane<E>(s_seg[w][buf] + base, sj);
    // p: val * table[idx] of the lane's entries, every row load in flight
    // before any is used; the table is small, so these are L2 (or L1) hits
    float p[E][WC];
    if constexpr (WC == 1) {
      // the loads with lanes across consecutive entries (a frequent
      // word's docs share sectors), the products written back over the
      // staged values, then each lane reads its own E entries'
      float* bv = s_val[w][buf];
      const int* bi = s_idx[w][buf];
      float x[E];
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int i = j * 32 + lane;
        const int row = bi[i];
        x[j] = i < cnt && row >= 0 && row < a.table_rows
                   ? __ldg(a.table + row)
                   : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < E; ++j) bv[j * 32 + lane] *= x[j];
      __syncwarp();
      float q[E];
      read_lane<E>(bv + base, q);
#pragma unroll
      for (int j = 0; j < E; ++j) p[j][0] = q[j];
    } else {
      int ij[E];
      float vj[E];
      read_lane<E>(s_idx[w][buf] + base, ij);
      read_lane<E>(s_val[w][buf] + base, vj);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const bool ok = j < nv && ij[j] >= 0 && ij[j] < a.table_rows;
        const float* row =
            a.table + static_cast<int64_t>(ok ? ij[j] : 0) * W;
        if constexpr (WC >= 4) {
          if (v4) {
#pragma unroll
            for (int c = 0; c < WC; c += 4) {
              const float4 q =
                  ok ? __ldg(reinterpret_cast<const float4*>(row + c))
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              p[j][c] = q.x;
              p[j][c + 1] = q.y;
              p[j][c + 2] = q.z;
              p[j][c + 3] = q.w;
            }
            continue;
          }
        }
#pragma unroll
        for (int c = 0; c < WC; ++c) {
          p[j][c] = ok && c < W ? __ldg(row + c) : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < E; ++j) {
#pragma unroll
        for (int c = 0; c < WC; ++c) p[j][c] *= vj[j];
      }
    }

    // the run carried in from the last batch goes on in lane 0's first
    // entry, or ends at the batch edge and is stored
    const bool cont = have && __shfl_sync(kFull, sj[0], 0) == cseg;
    if (have && !cont && lane == 0) narrow_store<WC>(a, e, slice, cseg, C);

    // the lane's entries merged left to right: its first run (F), the
    // runs that begin and end inside it (stored here), its last run (acc)
    float F[WC], acc[WC];
    const bool join_carry = lane == 0 && cont;
#pragma unroll
    for (int c = 0; c < WC; ++c) {
      acc[c] = (join_carry ? C[c] : 0.0f) + p[0][c];
      F[c] = 0.0f;
    }
    bool multi = false;
    const int s_first = sj[0];
    int s_last = sj[0];
#pragma unroll
    for (int j = 1; j < E; ++j) {
      if (j < nv) {
        if (sj[j] != s_last) {
          if (multi) {
            narrow_store<WC>(a, e, slice, s_last, acc);
          } else {
#pragma unroll
            for (int c = 0; c < WC; ++c) F[c] = acc[c];
            multi = true;
          }
#pragma unroll
          for (int c = 0; c < WC; ++c) acc[c] = p[j][c];
          s_last = sj[j];
        } else {
#pragma unroll
          for (int c = 0; c < WC; ++c) acc[c] += p[j][c];
        }
      }
    }

    // segmented inclusive scan of the lanes' last runs, in a fixed tree:
    // x ends as the sum of run s_last over this lane and the lanes before
    // it that the run reaches (a head: the run begins in this lane)
    const int prev_last = __shfl_up_sync(kFull, s_last, 1);
    const bool joins = lane > 0 && s_first == prev_last;
    bool h = multi || !joins;
    float x[WC];
#pragma unroll
    for (int c = 0; c < WC; ++c) x[c] = acc[c];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const bool hy = __shfl_up_sync(kFull, h, d);
#pragma unroll
      for (int c = 0; c < WC; ++c) {
        const float y = __shfl_up_sync(kFull, x[c], d);
        if (lane >= d && !h) x[c] = y + x[c];
      }
      if (lane >= d) h = h || hy;
    }
    // the first run of a lane that holds more than one ends in it: the
    // lanes before it that the run reaches, then its own entries
    float pred[WC];
#pragma unroll
    for (int c = 0; c < WC; ++c) pred[c] = __shfl_up_sync(kFull, x[c], 1);
    if (multi && lane <= last_lane) {
#pragma unroll
      for (int c = 0; c < WC; ++c) F[c] = joins ? pred[c] + F[c] : F[c];
      narrow_store<WC>(a, e, slice, s_first, F);
    }
    // the last run ends here unless the next lane goes on with it
    const int next_first = __shfl_down_sync(kFull, s_first, 1);
    if (lane < last_lane && next_first != s_last) {
      narrow_store<WC>(a, e, slice, s_last, x);
    }
    // the batch's last run is carried to the next batch of the slice
    cseg = __shfl_sync(kFull, s_last, last_lane);
#pragma unroll
    for (int c = 0; c < WC; ++c) C[c] = __shfl_sync(kFull, x[c], last_lane);
    have = true;
    if (st + kStg >= e.b1) {  // the slice's last batch
      if (lane == 0) narrow_store<WC>(a, e, slice, cseg, C);
      have = false;
    }
    __syncwarp();
    if (ns >= a.num_slices) break;
    if (ns != slice) {
      slice = ns;
      open_slice();
    }
    st = nst;
    buf ^= 1;
  }
}

template <int WC>
cudaError_t launch_gather_rows_narrow(RowsArgs a, int device,
                                      cudaStream_t stream) {
  a.ntiles = 1;  // segsum_rows_carry_kernel: one tile of 32 lanes, W <= 16
  int grid = 0;
  cudaError_t err = blocks_on_card(
      reinterpret_cast<const void*>(segsum_gather_rows_narrow_kernel<WC>),
      kNarrowThreads, device,
      (a.num_slices + kNarrowWarps - 1) / kNarrowWarps, &grid);
  if (err != cudaSuccess) return err;
  segsum_gather_rows_narrow_kernel<WC>
      <<<grid, kNarrowThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segsum_rows_carry_kernel<<<
      static_cast<int>((a.num_slices + kRowsWarps - 1) / kRowsWarps),
      kRowsThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_gather_rows(RowsArgs a, int device, cudaStream_t stream) {
  a.ntiles = (a.W / VEC + 31) / 32;
  const int64_t units = a.num_slices * a.ntiles;
  const int64_t unit_blocks = (units + kRowsWarps - 1) / kRowsWarps;
  int grid = 0;
  cudaError_t err = blocks_on_card(
      reinterpret_cast<const void*>(segsum_gather_rows_kernel<VEC>),
      kRowsThreads, device, unit_blocks, &grid);
  if (err != cudaSuccess) return err;
  segsum_gather_rows_kernel<VEC><<<grid, kRowsThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the carry kernel takes the slots a float at a time
  RowsArgs c = a;
  c.ntiles = (a.W + 31) / 32;
  segsum_rows_carry_kernel<<<
      static_cast<int>((a.num_slices * c.ntiles + kRowsWarps - 1) /
                       kRowsWarps),
      kRowsThreads, 0, stream>>>(c);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Entry points: each makes `device` current (this library links its own
// static CUDA runtime, whose current device is not PyTorch's), launches on
// `stream` (PyTorch's current stream of that device), and returns
// cudaGetLastError() as an int, 0 on success.

extern "C" {

// out: (num_segments + 1, ncols), uninitialised: every cell is written.
// init: the same shape, or null. col: null puts every entry in column 0.
int isle_segsum_onehot_i32(const int* seg, const int* col, const int* init,
                           int64_t n, int num_segments, int ncols,
                           int64_t chunk, int* out, int device,
                           void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n <= 0 || ncols <= 0 || chunk <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  OnehotArgs<int> a{};
  a.seg = seg;
  a.col = col;
  a.init = init;
  a.out = out;
  a.n = n;
  a.chunk = chunk;
  a.num_slices = (n + chunk - 1) / chunk;
  a.num_segments = num_segments;
  a.ncols = ncols;
  return static_cast<int>(launch_onehot<int, false>(
      a, device, static_cast<cudaStream_t>(stream)));
}

// As isle_segsum_onehot_i32, with float values; carry: (ceil(n / chunk),
// 2, ncols) doubles of scratch, uninitialised.
int isle_segsum_onehot_f32(const int* seg, const int* col, const float* val,
                           const float* init, int64_t n, int num_segments,
                           int ncols, int64_t chunk, float* out,
                           double* carry, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n <= 0 || ncols <= 0 || chunk <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  OnehotArgs<float> a{};
  a.seg = seg;
  a.col = col;
  a.val = val;
  a.init = init;
  a.out = out;
  a.carry = carry;
  a.n = n;
  a.chunk = chunk;
  a.num_slices = (n + chunk - 1) / chunk;
  a.num_segments = num_segments;
  a.ncols = ncols;
  return static_cast<int>(launch_onehot<float, true>(
      a, device, static_cast<cudaStream_t>(stream)));
}

// carry: (ceil(n / chunk), 2, W) floats and carry_seg: (ceil(n / chunk), 2)
// ints of scratch, both uninitialised; accumulate = 1 adds into `out`
// (the init carry), 0 overwrites the rows the stream reaches.
int isle_segsum_gather_rows_f32(const int* seg, const int* idx,
                                const float* val, const float* table,
                                int64_t n, int64_t table_rows, int W,
                                int num_segments, int64_t chunk,
                                int accumulate, float* out, float* carry,
                                int* carry_seg, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n <= 0 || W <= 0 || chunk <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  RowsArgs a{};
  a.seg = seg;
  a.idx = idx;
  a.val = val;
  a.table = table;
  a.out = out;
  a.carry = carry;
  a.carry_seg = carry_seg;
  a.n = n;
  a.table_rows = table_rows;
  a.chunk = chunk;
  a.num_slices = (n + chunk - 1) / chunk;
  a.W = W;
  a.num_segments = num_segments;
  a.accumulate = accumulate;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 =
      W % 4 == 0 && aligned16(table) && aligned16(out) && aligned16(carry);
  return static_cast<int>(vec4 ? launch_gather_rows<4>(a, device, s)
                               : launch_gather_rows<1>(a, device, s));
}

// As isle_segsum_gather_rows_f32, on segsum_gather_rows_narrow_kernel:
// W at most 16 (cudaErrorInvalidValue otherwise).
int isle_segsum_gather_rows_narrow_f32(const int* seg, const int* idx,
                                       const float* val, const float* table,
                                       int64_t n, int64_t table_rows, int W,
                                       int num_segments, int64_t chunk,
                                       int accumulate, float* out,
                                       float* carry, int* carry_seg,
                                       int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (W > kNarrowMaxW) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || W <= 0 || chunk <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  RowsArgs a{};
  a.seg = seg;
  a.idx = idx;
  a.val = val;
  a.table = table;
  a.out = out;
  a.carry = carry;
  a.carry_seg = carry_seg;
  a.n = n;
  a.table_rows = table_rows;
  a.chunk = chunk;
  a.num_slices = (n + chunk - 1) / chunk;
  a.W = W;
  a.num_segments = num_segments;
  a.accumulate = accumulate;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (W == 1) {
    err = launch_gather_rows_narrow<1>(a, device, s);
  } else if (W <= 2) {
    err = launch_gather_rows_narrow<2>(a, device, s);
  } else if (W <= 4) {
    err = launch_gather_rows_narrow<4>(a, device, s);
  } else if (W <= 8) {
    err = launch_gather_rows_narrow<8>(a, device, s);
  } else {
    err = launch_gather_rows_narrow<16>(a, device, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
