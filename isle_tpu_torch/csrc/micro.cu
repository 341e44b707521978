// The kernels of the two micro-benchmarks, hand-written for Hopper
// (sm_90a). Built with csrc/segsum.cu by isle_tpu_torch/_build.py and bound
// through the plain C entry points at the end (ctypes); the wrappers are
// isle_tpu_torch/micro_kernels.py.
//
// Replaces the two Pallas kernels of benchmarks/:
//   chunk_onehot_partials_kernel<mode>
//       <- make_pallas_segsum(chunk, rcap, mode).segsum
//          (benchmarks/micro_pallas.py:129-177, pallas_call at :163)
//   row_gather_bulk_kernel
//       <- make_dma_gather(chunk, depth, width).gather
//          (benchmarks/micro_pallas_gather.py:40-83, pallas_call at :69)
//
// chunk_onehot_partials: part[c, r, :] = sum of g[e, :] over the entries e
//   of chunk c whose within-chunk rank is r, for r in [0, rcap). The TPU
//   kernel builds the (rcap, chunk) one-hot in VMEM and contracts it with
//   the chunk's rows on the MXU; the one-hot never reaches HBM.
//   Bound: g read once and the partials written once (4 W bytes an entry
//   plus 4 W rcap / chunk): 2.6-2.9 ms at n = 2^24, W = 128 at 3.35 TB/s.
//   The work that is not zero is one row of products an entry, far under
//   that; the dense product over all rcap rows (rcap = 256: 1.1 TFLOP a
//   pass) is what the MXU does and what this design avoids.
//   Design, all three modes: a persistent grid of blocks, each walking its
//   items (chunk, column block of up to kColBlock = 128 columns, pass of
//   up to kMaxPassRows = 256 rank rows) as one stream of tiles of kKTile
//   entries. The tiles (g's rows, padded by 4 floats, and their ranks)
//   arrive by cp.async through a ring of kStages in shared memory, so
//   kStages - 1 tiles stay in flight across the items' boundaries and an
//   item's epilogue overlaps the next one's loads. The partials of the
//   pass's rank rows live in shared memory (128 KB at 256 rows), each
//   word owned by one thread, so only the ring needs the block's barrier;
//   the epilogue writes every row (unused ones as zeros) and clears them.
//   At W = 128 a block reads each byte of g once, and rcap <= 256 is one
//   pass.
//   "split2", "default" (8 warps, warp w the columns [16 w, 16 w + 16)):
//   the product runs transposed, part^T = g^T onehot^T, so that g's rows
//   are the A operand of mma.sync.m16n8k16 (16 columns by a k16 step's 16
//   entries, read from the tile and rounded to bf16 once: hi, then the
//   residual lo for split2) and the one-hot of 8 rank rows the B operand
//   (compares of the step's ranks in registers). Each warp reduces a
//   step's in-range ranks to their window (__reduce_min_sync /
//   __reduce_max_sync) and issues mma.sync only for the n8 tiles of rank
//   rows inside it: sorted ranks reach one or two of 32 on the word-tail
//   stream, random ranks all of them. Each product starts from zero and
//   is added on the CUDA cores to the tile's sums, kept in the mma's
//   fragment layout ((n8 tile, warp, lane) -> a float4); a tile's steps
//   are added in order in registers, one read and one write of the sums a
//   tile. A tile outside the window would have added +0.0, so the sums are
//   those of the dense product. Not wgmma: its B operand comes from shared
//   memory, so each step's one-hot would be written there and fenced
//   first, and its products would still be added from zero on the CUDA
//   cores; a step's work is one or two n8 tiles, too little to hide that.
//   "highest" (128 threads, one a column): the float32 rows unrounded
//   (Hopper has no exact float32 tensor-core path and TF32 is off in this
//   port). A thread walks the entries in order, sums each run of equal
//   ranks in float64 in a register and adds it, rounded to float32 once,
//   into its rank's row of its column: the sum runs in entry order within
//   each rank, and a plan's sorted ranks make each partial its float64
//   sum rounded once (a float32 sum of the benchmark's runs of 110
//   drifted 1.3e-6 of the largest sum from float64 on an H100, past the
//   1e-6 its check allows).
//   No mode needs the ranks sorted, and none uses atomics: two launches on
//   the same input are bit-equal.
//
// row_gather_bulk: out[i, :] = tab[idx[i], :]. The TPU kernel issues one
//   async DMA a row through a ring of `depth` semaphores; Hopper's
//   counterpart of the DMA engine is its bulk-copy (TMA) engine.
//   Bound: idx, the table and the output once, 0.66 ms at n = 2^22,
//   V = 102,660, W = 128 (a table just over the 50 MB L2: 1.29 ms if every
//   row came from HBM).
//   Design: one warp a block and `chunk` rows a block, so that a small ring
//   leaves many blocks an SM. The block's indices are staged in shared
//   memory first, so no copy waits on a global load. The ring of `depth`
//   rows is cut into stages of S = min(depth, 32) rows (a shorter last
//   one), each with one mbarrier. Lane j issues the cp.async.bulk of a
//   stage's row j, and lane 0 arms the barrier with the stage's bytes (a
//   ballot of the lanes with a row in range); a lane whose index lies
//   outside [0, V) writes a zero row with st.shared and fences it for the
//   bulk engine. An arrived stage is S consecutive rows of `out`, so it
//   leaves by one bulk shared -> global copy (a bulk group of lane 0), and
//   the stage is refilled once the engine has read it: the rows never
//   pass through registers. With two stages or more the refill trails the
//   store by one stage, so the others stay in flight meanwhile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>
#include <vector>

namespace {

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two floats rounded to bf16 (to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the residual of pack_bf16(a, b), rounded to bf16
__device__ __forceinline__ uint32_t pack_bf16_residual(float a, float b) {
  const float ha = __bfloat162float(__float2bfloat16_rn(a));
  const float hb = __bfloat162float(__float2bfloat16_rn(b));
  return pack_bf16(a - ha, b - hb);
}

// D += A B, m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed; a wait past 2^34 clocks
// (about 9 s) traps, so that a copy that never lands fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  } while (!done);
}

// `bytes` global -> shared by the bulk-copy engine, completing on `bar`
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` shared -> global by the bulk-copy engine, in this thread's bulk
// group (then cp.async.bulk.commit_group)
__device__ __forceinline__ void bulk_copy_s2g(void* dst, const void* src,
                                              uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// until every bulk group of this thread has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------- chunk_onehot_partials

constexpr int kKTile = 32;         // entries a staged tile (two k16 steps)
constexpr int kStages = 5;         // tiles in the ring, kStages - 1 in flight
constexpr int kColBlock = 128;     // columns a block: W <= 128 in one
constexpr int kStride = kColBlock + 4;  // floats a staged row: the A
                                        // fragments' reads hit 32 banks
constexpr int kMaxPassRows = 256;  // rank rows a pass: 128 KB of sums
constexpr int kChunkMultiple = 64; // micro_kernels.KTILE
constexpr size_t kTileBytes =
    kKTile * kStride * sizeof(float) + kKTile * sizeof(int);
constexpr size_t kRingBytes = kStages * kTileBytes;
constexpr int kTcWarps = kColBlock / 16;  // 16 columns a warp
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kExactThreads = kColBlock;  // one column a thread
constexpr uint32_t kBf16One = 0x3F80u;

__host__ __device__ constexpr int partials_threads(int mode) {
  return mode == 0 ? kExactThreads : kTcThreads;
}

// The rank rows a pass covers: rcap rounded up to a multiple of 16, at most
// kMaxPassRows.
int pass_rows_of(int rcap) {
  return rcap >= kMaxPassRows ? kMaxPassRows : (rcap + 15) / 16 * 16;
}

size_t partials_smem(int pass_rows) {
  return static_cast<size_t>(pass_rows) * kColBlock * sizeof(float) +
         kRingBytes;
}

// Stage entries [e0, e0 + kKTile): g's columns [col0, col0 + ncols) into the
// tile's padded rows (the rest stay unset and are never read) and the
// entries' ranks after them.
template <int THREADS>
__device__ __forceinline__ void stage_tile(unsigned char* stage,
                                           const float* __restrict__ g,
                                           const int* __restrict__ rank,
                                           int64_t e0, int W, int col0,
                                           int ncols) {
  float* tile = reinterpret_cast<float*>(stage);
  int* ranks = reinterpret_cast<int*>(stage + kKTile * kStride * sizeof(float));
#pragma unroll
  for (int j = 0; j < kKTile * kColBlock / 4 / THREADS; ++j) {
    const int q = threadIdx.x + j * THREADS;
    const int row = q / (kColBlock / 4);
    const int col = (q % (kColBlock / 4)) * 4;
    if (col < ncols) {
      cp_async_16(tile + row * kStride + col, g + (e0 + row) * W + col0 + col);
    }
  }
  if (threadIdx.x < kKTile / 4) {
    cp_async_16(ranks + threadIdx.x * 4, rank + e0 + threadIdx.x * 4);
  }
}

// An item of the persistent loop: chunk c, column block cb, pass p.
struct Item {
  int64_t c;
  int col0, ncols, row0, rows;
};

__device__ __forceinline__ Item item_at(int64_t i, int ncb, int npass, int W,
                                        int rcap, int pass_rows) {
  Item it;
  const int p = static_cast<int>(i % npass);
  const int64_t rest = i / npass;
  it.c = rest / ncb;
  it.col0 = static_cast<int>(rest % ncb) * kColBlock;
  it.ncols = min(kColBlock, W - it.col0);
  it.row0 = p * pass_rows;
  it.rows = min(pass_rows, rcap - it.row0);
  return it;
}

// MODE: 0 highest, 1 split2, 2 default. The block walks items blockIdx.x,
// blockIdx.x + gridDim.x, ... of nchunks x column blocks x passes.
template <int MODE>
__global__ void __launch_bounds__(partials_threads(MODE), MODE == 0 ? 1 : 2)
    chunk_onehot_partials_kernel(const int* __restrict__ rank,
                                 const float* __restrict__ g, int W,
                                 int chunk, int rcap, int pass_rows,
                                 int64_t items, float* __restrict__ out) {
  constexpr int T = partials_threads(MODE);
  constexpr bool SPLIT = MODE == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + static_cast<size_t>(pass_rows) * kColBlock *
                                   sizeof(float);
  const int ncb = (W + kColBlock - 1) / kColBlock;
  const int npass = (rcap + pass_rows - 1) / pass_rows;
  const int ntiles = chunk / kKTile;
  const int64_t mine =
      items > blockIdx.x ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t total = mine * ntiles;  // tiles this block consumes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;

  // MODE 0: thread t owns column t of every row, acc[r * kColBlock + t];
  // else warp w owns columns [16 w, 16 w + 16): a float4 a lane of every n8
  // tile of rank rows, acc4[(nt * kTcWarps + w) * 32 + lane]
  float4* acc4 = reinterpret_cast<float4*>(acc);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (MODE == 0) {
    for (int r = 0; r < pass_rows; ++r) acc[r * kColBlock + threadIdx.x] = 0.0f;
  } else {
    for (int nt = 0; nt < pass_rows / 8; ++nt) {
      acc4[(nt * kTcWarps + warp) * 32 + lane] = zero4;
    }
  }

  // the staged tile's place in the block's stream: its item and tile
  int64_t s_item = blockIdx.x;
  int s_t = 0;
  Item s_it = item_at(s_item, ncb, npass, W, rcap, pass_rows);
  auto stage_next = [&](int64_t q) {
    if (q < total) {
      stage_tile<T>(ring + (q % kStages) * kTileBytes, g, rank,
                    s_it.c * chunk + s_t * kKTile, W, s_it.col0, s_it.ncols);
      if (++s_t == ntiles) {
        s_t = 0;
        s_item += gridDim.x;
        if (s_item < items) {
          s_it = item_at(s_item, ncb, npass, W, rcap, pass_rows);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int q = 0; q < kStages - 1; ++q) stage_next(q);

  int64_t item = blockIdx.x;
  Item it = item_at(item, ncb, npass, W, rcap, pass_rows);
  int t = 0;
  int cur = -1;       // MODE 0: the current run's rank (pass-relative)
  double run = 0.0;   // and its float64 sum
  for (int64_t q = 0; q < total; ++q) {
    cp_async_wait<kStages - 2>();
    // tile q has landed for every thread, and every thread is done with
    // tile q - 1, whose buffer the next copy overwrites
    __syncthreads();
    stage_next(q + kStages - 1);
    const unsigned char* stage = ring + (q % kStages) * kTileBytes;
    const float* tile = reinterpret_cast<const float*>(stage);
    const int* rk = reinterpret_cast<const int*>(
        stage + kKTile * kStride * sizeof(float));
    const bool last = t == ntiles - 1;

    if (MODE == 0) {
      const int col = threadIdx.x;
      if (col < it.ncols) {
        float* mine_acc = acc + col;
        // the tile's ranks and values first, before any sum is stored, so
        // that the loads overlap and only the float64 adds chain
        int rs[kKTile];
        float xs[kKTile];
#pragma unroll
        for (int e = 0; e < kKTile; ++e) {
          rs[e] = rk[e];
          xs[e] = tile[e * kStride + col];
        }
#pragma unroll
        for (int e = 0; e < kKTile; ++e) {
          const int r = rs[e] - it.row0;
          const float x = xs[e];
          if (r != cur) {
            if (static_cast<unsigned>(cur) < static_cast<unsigned>(it.rows)) {
              mine_acc[cur * kColBlock] += static_cast<float>(run);
            }
            cur = r;
            run = 0.0;
          }
          run += static_cast<double>(x);
        }
        if (last) {
          if (static_cast<unsigned>(cur) < static_cast<unsigned>(it.rows)) {
            mine_acc[cur * kColBlock] += static_cast<float>(run);
          }
          cur = -1;
          run = 0.0;
          float* o = out + (it.c * rcap + it.row0) * W + it.col0 + col;
          for (int r = 0; r < it.rows; ++r) {
            o[static_cast<int64_t>(r) * W] = mine_acc[r * kColBlock];
            mine_acc[r * kColBlock] = 0.0f;
          }
        }
      }
    } else if (warp * 16 < it.ncols) {  // warp-uniform
      // The product's transpose, part^T = g^T onehot^T: g's 16 columns of
      // the warp are the A operand (m16 x k16, the tile's 16 entries), the
      // one-hot of an n8 tile of rank rows the B operand (k16 x n8).
      float4* slots = acc4 + warp * 32 + lane;
      const bool hi_live = warp * 16 + 8 < it.ncols;  // columns gq + 8
      // the tile's kKTile / 16 k16 steps: ranks, A fragments and windows,
      // all read before any sum is stored
      constexpr int KS = kKTile / 16;
      int r[KS][4], lo[KS], hi[KS];
      uint32_t ah[KS][4], al[KS][4];
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int kb = s * 16 + 2 * tq;
        r[s][0] = rk[kb] - it.row0;
        r[s][1] = rk[kb + 1] - it.row0;
        r[s][2] = rk[kb + 8] - it.row0;
        r[s][3] = rk[kb + 9] - it.row0;
        // A fragment: columns gq and gq + 8 of the warp's 16 at entries
        // kb, kb + 1 (registers 0, 1) and kb + 8, kb + 9 (2, 3)
        const float* p = tile + kb * kStride + warp * 16 + gq;
        float x[8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* q = p + 8 * h * kStride;
          x[4 * h] = q[0];
          x[4 * h + 1] = q[kStride];
          x[4 * h + 2] = hi_live ? q[8] : 0.0f;
          x[4 * h + 3] = hi_live ? q[kStride + 8] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[s][i] = pack_bf16(x[2 * i], x[2 * i + 1]);
          if (SPLIT) al[s][i] = pack_bf16_residual(x[2 * i], x[2 * i + 1]);
        }
      }
      // each step's window of ranks inside the pass's rows, in n8 tiles
      // ([lo, hi] empty as [INT_MAX >> 3, -1] when no rank is inside)
      int nlo = INT_MAX, nhi = -1;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        int l = INT_MAX, h = -1;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (static_cast<unsigned>(r[s][i]) <
              static_cast<unsigned>(it.rows)) {
            l = min(l, r[s][i]);
            h = max(h, r[s][i]);
          }
        }
        lo[s] = __reduce_min_sync(0xffffffffu, l) >> 3;
        hi[s] = __reduce_max_sync(0xffffffffu, h) >> 3;
        nlo = min(nlo, lo[s]);
        nhi = max(nhi, hi[s]);
      }
      for (int nt = nlo; nt <= nhi; ++nt) {
        const int rr = nt * 8 + gq;  // the rank row of the lane's B column
        float4* slot = slots + nt * kTcWarps * 32;
        float4 v = *slot;
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          if (nt < lo[s] || nt > hi[s]) continue;  // a product of zeros
          // the one-hot B fragment: entries kb, kb + 1 (register 0) and
          // kb + 8, kb + 9 (register 1) at rank row rr, the first of each
          // pair in the low half
          const uint32_t b0 = (r[s][0] == rr ? kBf16One : 0u) |
                              (r[s][1] == rr ? kBf16One << 16 : 0u);
          const uint32_t b1 = (r[s][2] == rr ? kBf16One : 0u) |
                              (r[s][3] == rr ? kBf16One << 16 : 0u);
          // the step's product from zero, then one float32 add (round to
          // nearest) into the running sum, step by step: the tensor cores'
          // own accumulation truncates, and fed the running sum it drifted
          // 2.6e-6 of the largest sum from the exact value over the
          // benchmark's runs of 110 (on an H100)
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(d, ah[s], b0, b1);
          if (SPLIT) mma_bf16(d, al[s], b0, b1);
          v.x += d[0];
          v.y += d[1];
          v.z += d[2];
          v.w += d[3];
        }
        *slot = v;
      }
      if (last) {
        // d's rows are the columns gq, gq + 8; its columns the rank rows
        // 2 tq, 2 tq + 1 of an n8 tile
        float* o = out + (it.c * rcap + it.row0 + 2 * tq) * W + it.col0 +
                   warp * 16 + gq;
        for (int nt = 0; nt * 8 < it.rows; ++nt) {
          float4* slot = slots + nt * kTcWarps * 32;
          const float4 v = *slot;
          *slot = zero4;
          const int r0 = nt * 8 + 2 * tq;
          float* row = o + static_cast<int64_t>(nt) * 8 * W;
          if (r0 < it.rows) {
            row[0] = v.x;
            if (hi_live) row[8] = v.z;
          }
          if (r0 + 1 < it.rows) {
            row[W] = v.y;
            if (hi_live) row[W + 8] = v.w;
          }
        }
      }
    }
    if (last) {
      t = 0;
      item += gridDim.x;
      if (item < items) it = item_at(item, ncb, npass, W, rcap, pass_rows);
    } else {
      ++t;
    }
  }
}

// threads, dynamic shared memory, work items, grid and blocks an SM of a
// launch
struct LaunchShape {
  int threads;
  size_t smem;
  int64_t items;
  unsigned grid;
  int blocks_per_sm;
};

// The blocks of `threads` an SM holds at `smem` bytes of dynamic shared
// memory, and the SMs, of `kernel` on `device`. Asked of the card at the
// first launch of each (kernel, threads, smem, device) and kept: that
// launch also lets the kernel take the device's whole opt-in shared memory
// (so a shape asked earlier still launches after a smaller one) with the
// carveout at its most. A shape past the opt-in limit is refused.
struct Occupancy {
  int per_sm, sms;
};

template <typename K>
cudaError_t prepare(K kernel, int threads, size_t smem, int device,
                    Occupancy* occ) {
  struct Seen {
    const void* kernel;
    int threads;
    size_t smem;
    int device;
    Occupancy occ;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  const void* key = reinterpret_cast<const void*>(kernel);
  const std::lock_guard<std::mutex> lock(mu);
  for (const Seen& s : seen) {
    if (s.kernel == key && s.threads == threads && s.smem == smem &&
        s.device == device) {
      *occ = s.occ;
      return cudaSuccess;
    }
  }
  int optin = 0;
  Occupancy o{0, 0};
  cudaFuncAttributes attr;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const int dynamic = optin - static_cast<int>(attr.sharedSizeBytes);
  if (smem > static_cast<size_t>(dynamic)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (o.per_sm < 1) return cudaErrorInvalidConfiguration;
  err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return err;
  seen.push_back(Seen{key, threads, smem, device, o});
  *occ = o;
  return cudaSuccess;
}

// a persistent grid: as many blocks as the card holds at once, at most
// one an item
template <int MODE>
cudaError_t partials_shape(int64_t n, int W, int chunk, int rcap, int device,
                           LaunchShape* shape) {
  const int pass_rows = pass_rows_of(rcap);
  const int64_t items = n / chunk * ((W + kColBlock - 1) / kColBlock) *
                        ((rcap + pass_rows - 1) / pass_rows);
  const int threads = partials_threads(MODE);
  const size_t smem = partials_smem(pass_rows);
  Occupancy occ;
  const cudaError_t err = prepare(chunk_onehot_partials_kernel<MODE>,
                                  threads, smem, device, &occ);
  if (err != cudaSuccess) return err;
  const int64_t slots = static_cast<int64_t>(occ.per_sm) * occ.sms;
  *shape = LaunchShape{threads, smem, items,
                       static_cast<unsigned>(items < slots ? items : slots),
                       occ.per_sm};
  return cudaSuccess;
}

template <int MODE>
cudaError_t launch_partials(const int* rank, const float* g, int64_t n,
                            int W, int chunk, int rcap, float* out,
                            int device, cudaStream_t stream) {
  LaunchShape sh;
  const cudaError_t err = partials_shape<MODE>(n, W, chunk, rcap, device, &sh);
  if (err != cudaSuccess) return err;
  chunk_onehot_partials_kernel<MODE><<<sh.grid, sh.threads, sh.smem, stream>>>(
      rank, g, W, chunk, rcap, pass_rows_of(rcap), sh.items, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------- row_gather

constexpr int kGatherStage = 32;  // rows a stage: one a lane

__host__ __device__ int gather_stage_rows(int depth) {
  return depth < kGatherStage ? depth : kGatherStage;
}

// the ring, a barrier a stage and the block's indices
// (micro_kernels.gather_shape)
size_t gather_smem(int64_t chunk, int depth, int W) {
  const int S = gather_stage_rows(depth);
  return static_cast<size_t>(depth) * W * sizeof(float) +
         static_cast<size_t>((depth + S - 1) / S) * sizeof(uint64_t) +
         static_cast<size_t>(chunk) * sizeof(int);
}

__global__ void __launch_bounds__(32)
    row_gather_bulk_kernel(const int* __restrict__ idx,
                           const float* __restrict__ tab, int64_t n, int V,
                           int W, int chunk, int depth,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = gather_stage_rows(depth);
  const int NS = (depth + S - 1) / S;
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(depth) * W * sizeof(float));
  int* sidx = reinterpret_cast<int*>(full + NS);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk;
  const int rows = static_cast<int>(min(static_cast<int64_t>(chunk),
                                        n - base));
  const uint32_t row_bytes = static_cast<uint32_t>(W) * sizeof(float);
  const int lane = threadIdx.x;

  for (int i = lane; i < rows; i += 32) sidx[i] = __ldg(idx + base + i);
  if (lane == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // fill k: stage k % NS, rows [row0, row0 + size) of the block, the stage's
  // (k / NS)-th use; the fills walk the rows in order
  const int nfills = rows / depth * NS +
                     (rows % depth + S - 1) / S;
  auto first_row = [&](int k) { return k / NS * depth + k % NS * S; };
  auto size_of = [&](int k) {
    return min(min(S, depth - k % NS * S), rows - first_row(k));
  };
  auto fill = [&](int k) {
    const int st = k % NS, row0 = first_row(k);
    const bool mine = lane < size_of(k);
    const int r = mine ? sidx[row0 + lane] : 0;
    const bool ok = mine && static_cast<unsigned>(r) < static_cast<unsigned>(V);
    const unsigned copies = __ballot_sync(0xffffffffu, ok);
    float* slot = ring + static_cast<size_t>(st * S + lane) * W;
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[st], __popc(copies) * row_bytes);
    }
    if (ok) {
      bulk_copy_g2s(slot, tab + static_cast<int64_t>(r) * W, row_bytes,
                    &full[st]);
    } else if (mine) {  // a zero row, made visible to the bulk engine
      float4* z = reinterpret_cast<float4*>(slot);
      for (int q = 0; q < W / 4; ++q) z[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
  };

  for (int k = 0; k < min(NS, nfills); ++k) fill(k);
  for (int k = 0; k < nfills; ++k) {
    const int st = k % NS;
    mbar_wait(&full[st], (k / NS) & 1);
    __syncwarp();  // the stage's zero rows are written and fenced
    if (lane == 0) {
      bulk_copy_s2g(out + (base + first_row(k)) * W,
                    ring + static_cast<size_t>(st) * S * W,
                    static_cast<uint32_t>(size_of(k)) * row_bytes);
      bulk_commit();
    }
    // refill the stage stored one step ago (this one when there is one)
    const int j = NS > 1 ? k - 1 : k;
    if (j >= 0 && j + NS < nfills) {
      if (lane == 0) {
        if (NS > 1) {
          bulk_wait_read<1>();
        } else {
          bulk_wait_read<0>();
        }
      }
      __syncwarp();
      fill(j + NS);
    }
  }
  if (lane == 0) bulk_wait_all();
}

// a block a `chunk` rows
cudaError_t gather_shape(int64_t n, int W, int64_t chunk, int depth,
                         int device, LaunchShape* shape) {
  const size_t smem = gather_smem(chunk, depth, W);
  Occupancy occ;
  const cudaError_t err =
      prepare(row_gather_bulk_kernel, 32, smem, device, &occ);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (n + chunk - 1) / chunk;
  *shape = LaunchShape{32, smem, blocks, static_cast<unsigned>(blocks),
                       occ.per_sm};
  return cudaSuccess;
}

}  // namespace

extern "C" {

// out: (n / chunk, rcap, W), uninitialised: every cell is written.
// mode: 0 highest (exact float32), 1 split2, 2 default (bf16, one pass).
// Needs chunk % 64 == 0, W % 8 == 0, n % chunk == 0 and 16-byte aligned
// rank and g (the wrapper checks). Returns cudaGetLastError() as an int.
int isle_chunk_onehot_partials_f32(const int* rank, const float* g,
                                   int64_t n, int W, int64_t chunk, int rcap,
                                   int mode, float* out, int device,
                                   void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n <= 0 || W <= 0 || chunk <= 0 || rcap <= 0 ||
      chunk % kChunkMultiple || W % 8 || n % chunk || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int C = static_cast<int>(chunk);
  switch (mode) {
    case 0:
      return static_cast<int>(
          launch_partials<0>(rank, g, n, W, C, rcap, out, device, s));
    case 1:
      return static_cast<int>(
          launch_partials<1>(rank, g, n, W, C, rcap, out, device, s));
    default:
      return static_cast<int>(
          launch_partials<2>(rank, g, n, W, C, rcap, out, device, s));
  }
}

// out: (n, W), uninitialised: every row is written. Needs 1 <= depth <=
// chunk, W * 4 % 16 == 0, 16-byte aligned tab and out and the ring, the
// stages' barriers and the chunk's indices within a block's shared memory
// (the wrapper checks; past the device's opt-in limit this entry returns
// cudaErrorInvalidValue).
int isle_row_gather_bulk_f32(const int* idx, const float* tab, int64_t n,
                             int V, int W, int64_t chunk, int depth,
                             float* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n <= 0 || W <= 0 || depth < 1 || depth > chunk || (W * 4) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaunchShape sh;
  const cudaError_t err = gather_shape(n, W, chunk, depth, device, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  row_gather_bulk_kernel<<<sh.grid, sh.threads, sh.smem,
                           static_cast<cudaStream_t>(stream)>>>(
      idx, tab, n, V, W, static_cast<int>(chunk), depth, out);
  return static_cast<int>(cudaGetLastError());
}

// What a launch of the kernel `which` (0-2: chunk_onehot_partials in mode
// 0-2 at rcap = arg; 3: row_gather_bulk at depth = arg) takes on this
// device: out[0] threads a block, out[1] dynamic shared memory bytes,
// out[2] blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// out[3] registers a thread, out[4] blocks in the grid. Launches nothing.
int isle_micro_kernel_info(int which, int64_t n, int W, int64_t chunk,
                           int arg, int device, int64_t* out) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n <= 0 || W <= 0 || chunk <= 0 || arg <= 0 || which < 0 || which > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int C = static_cast<int>(chunk);
  LaunchShape sh;
  cudaFuncAttributes attr;
  cudaError_t err;
  switch (which) {
    case 0:
      err = partials_shape<0>(n, W, C, arg, device, &sh);
      if (err == cudaSuccess) {
        err = cudaFuncGetAttributes(&attr, chunk_onehot_partials_kernel<0>);
      }
      break;
    case 1:
      err = partials_shape<1>(n, W, C, arg, device, &sh);
      if (err == cudaSuccess) {
        err = cudaFuncGetAttributes(&attr, chunk_onehot_partials_kernel<1>);
      }
      break;
    case 2:
      err = partials_shape<2>(n, W, C, arg, device, &sh);
      if (err == cudaSuccess) {
        err = cudaFuncGetAttributes(&attr, chunk_onehot_partials_kernel<2>);
      }
      break;
    default:
      err = gather_shape(n, W, chunk, arg, device, &sh);
      if (err == cudaSuccess) {
        err = cudaFuncGetAttributes(&attr, row_gather_bulk_kernel);
      }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = sh.threads;
  out[1] = static_cast<int64_t>(sh.smem);
  out[2] = sh.blocks_per_sm;
  out[3] = attr.numRegs;
  out[4] = sh.grid;
  return 0;
}

}  // extern "C"
