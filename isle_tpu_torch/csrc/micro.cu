// The kernels of the two micro-benchmarks, hand-written for Hopper
// (sm_90a). Built with csrc/segsum.cu by isle_tpu_torch/_build.py and bound
// through the plain C entry points at the end (ctypes); the wrappers are
// isle_tpu_torch/micro_kernels.py.
//
// Replaces the two Pallas kernels of benchmarks/:
//   chunk_onehot_partials_kernel (and _exact_kernel)
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
//   plus 4 W rcap / chunk): 2.6-2.9 ms at n = 2^24, W = 128 at 3.35 TB/s;
//   the dense product's 2 rcap W bf16 operations an entry (rcap = 256:
//   1.1 TFLOP, 1.1 ms at 989 TFLOP/s a pass) stay under that.
//   Design ("split2", "default"): one block of 16 warps per (chunk,
//   column block). The chunk's rows arrive 64 entries at a time with
//   cp.async into a double buffer of float32 tiles in shared memory (the
//   next tile is in flight while this one multiplies). The warps are RG
//   row groups by 16 / RG column groups: each owns 16 columns (two n8
//   tiles) and MT m16 tiles of rank rows (MT <= 4: 32 accumulators a
//   thread; at 8 ptxas spilled under the 128 registers that 512 threads
//   leave), so a pass covers RG x MT x 16 rank rows and a block
//   16 x 16 / RG columns: rcap = 256 (the word-tail stream) takes one pass
//   of four row groups over 64-column blocks. Per k16 step a warp
//   reads its B fragments from the float32 tile, rounds them to bf16
//   (__float2bfloat16_rn: hi, then the residual lo for split2) and builds
//   the one-hot A fragments in registers by comparing the step's four
//   ranks a lane holds with the rows of each m-tile: the one-hot exists
//   only as mma.sync.m16n8k16 operands. Each k16 step's product starts
//   from zero and is added to the float32 running sum on the CUDA cores.
//   The product is dense over all rcap
//   rows, as the MXU computes it; rcap above 256 takes more passes over the
//   chunk. Rows at unused ranks come out exactly zero.
//   Design ("highest"): the float32 rows unrounded, on the CUDA cores
//   (Hopper has no exact float32 tensor-core path and TF32 is off in this
//   port): one thread a column walks the chunk's entries in order, sums
//   each run of equal ranks in float64 in a register and adds it, rounded
//   to float32 once, into its rank's row of a per-column accumulator in
//   shared memory (each thread touches only its own column: no
//   synchronisation, and the sum runs in entry order within each rank).
//   With sorted ranks (a plan's) every row is one run, so each partial is
//   its float64 sum rounded once: a float32 sum of the benchmark's runs of
//   110 drifted 1.3e-6 of the largest sum from float64 on an H100, past
//   the 1e-6 its check allows. Up to kExactPassRows ranks a pass.
//   Neither mode needs the ranks sorted, and neither uses atomics: two
//   launches on the same input are bit-equal.
//
// row_gather_bulk: out[i, :] = tab[idx[i], :]. The TPU kernel issues one
//   async DMA a row through a ring of `depth` semaphores; Hopper's
//   counterpart of the DMA engine is its bulk-copy (TMA) engine.
//   Bound: idx, the table and the output once, 0.66 ms at n = 2^22,
//   V = 102,660, W = 128 (a table just over the 50 MB L2: 1.29 ms if every
//   row came from HBM).
//   Design: one block per `chunk` rows; a ring of `depth` row slots in
//   dynamic shared memory, each with a "full" and an "empty" mbarrier. One
//   elected thread (warp 0, lane 0) issues one cp.async.bulk a row into
//   slot i % depth: the first `depth` rows without waiting (warm-up), then
//   each after the slot's previous row was stored (steady state). The
//   other kGatherConsumers warps, each owning every kGatherConsumers-th
//   slot, wait on their slots' phases in row order and store each row to
//   `out` with 128-bit stores, then release the slot (the drain is the
//   consumers finishing the last `depth` rows). An idx outside [0, V)
//   copies nothing and gives a zero row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when `bytes` is 0
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
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

// ------------------------------------------------- chunk_onehot_partials

constexpr int kKTile = 64;  // entries a staged tile
constexpr int kWarps = 16;  // row groups x column groups
constexpr int kThreads = kWarps * 32;
constexpr uint32_t kBf16One = 0x3F80u;
constexpr int kColBlock = 128;  // columns of an exact-kernel block
constexpr int kExactThreads = kColBlock;
constexpr int kExactPassRows = 128;  // 64 KB of accumulators a block
constexpr int kExactUnroll = 8;

// A block of RG row groups: 16 / RG column groups of 16 columns; its
// staged tiles' rows are padded by 4 floats, so that the B fragments'
// reads (lanes 8 columns by 4 row pairs) hit 32 distinct banks.
template <int RG>
struct TcShape {
  static constexpr int kCols = kWarps / RG * 16;
  static constexpr int kStride = kCols + 4;
  static constexpr int kTileFloats = kKTile * kStride;
  static constexpr size_t kSmem =
      2 * (kTileFloats * sizeof(float) + kKTile * sizeof(int));
};

// stage entries [k0, k0 + kKTile) of the chunk starting at e0: g's columns
// [col0, col0 + ncols) (zero beyond) and the ranks
template <int COLS>
__device__ __forceinline__ void stage_tile(float* tile, int* ranks,
                                           const float* __restrict__ g,
                                           const int* __restrict__ rank,
                                           int64_t e0, int k0, int W,
                                           int col0, int ncols) {
#pragma unroll
  for (int j = 0; j < kKTile * COLS / 4 / kThreads; ++j) {
    const int q = threadIdx.x + j * kThreads;
    const int row = q / (COLS / 4);
    const int col = (q % (COLS / 4)) * 4;
    const bool in = col < ncols;
    const float* src = in ? g + (e0 + k0 + row) * W + col0 + col : g;
    cp_async_16(tile + row * (COLS + 4) + col, src, in ? 16 : 0);
  }
  if (threadIdx.x < kKTile / 4) {
    cp_async_16(ranks + threadIdx.x * 4, rank + e0 + k0 + threadIdx.x * 4,
                16);
  }
  cp_async_commit();
}

// MT: m16 tiles of rank rows a warp holds; RG: row groups of warps;
// SPLIT: hi and lo passes
template <int MT, int RG, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    chunk_onehot_partials_kernel(const int* __restrict__ rank,
                                 const float* __restrict__ g, int W,
                                 int chunk, int rcap,
                                 float* __restrict__ out) {
  using S = TcShape<RG>;
  constexpr int kStride = S::kStride, kTileFloats = S::kTileFloats;
  extern __shared__ __align__(16) unsigned char smem[];
  float* tiles = reinterpret_cast<float*>(smem);
  int* ranks = reinterpret_cast<int*>(smem + 2 * kTileFloats * sizeof(float));

  const int c = blockIdx.x;
  const int col0 = blockIdx.y * S::kCols;
  const int ncols = min(S::kCols, W - col0);
  const int64_t e0 = static_cast<int64_t>(c) * chunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wn = warp % (kWarps / RG), wm = warp / (kWarps / RG);
  const bool cols_live = wn * 16 < ncols;  // warp-uniform
  const int ntiles = chunk / kKTile;

  for (int pass = 0; pass < rcap; pass += RG * MT * 16) {
    const int mrow0 = pass + wm * MT * 16;
    float acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

    stage_tile<S::kCols>(tiles, ranks, g, rank, e0, 0, W, col0, ncols);
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait_all();
      // tile t has landed for every thread, and every warp is done with
      // tile t - 1, whose buffer the next copy overwrites
      __syncthreads();
      if (t + 1 < ntiles) {
        stage_tile<S::kCols>(tiles + ((t + 1) & 1) * kTileFloats,
                   ranks + ((t + 1) & 1) * kKTile, g, rank, e0,
                   (t + 1) * kKTile, W, col0, ncols);
      }
      const float* tile = tiles + (t & 1) * kTileFloats;
      const int* rk = ranks + (t & 1) * kKTile;
      if (!cols_live) continue;
      // two k16 steps unrolled, not four: fully unrolled, ptxas spilled 16
      // and 4 bytes in the split2 kernels of MT 4 and 2 with two row groups
#pragma unroll 2
      for (int s = 0; s < kKTile / 16; ++s) {
        const int kb = s * 16 + 2 * tq;
        const int r0 = rk[kb], r1 = rk[kb + 1], r2 = rk[kb + 8],
                  r3 = rk[kb + 9];
        // B fragments: rows kb, kb + 1, kb + 8, kb + 9 of column gq of
        // each n8 tile
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* p = tile + kb * kStride + wn * 16 + nt * 8 + gq;
          const float x0 = p[0], x1 = p[kStride];
          const float x2 = p[8 * kStride], x3 = p[9 * kStride];
          bh[nt][0] = pack_bf16(x0, x1);
          bh[nt][1] = pack_bf16(x2, x3);
          if (SPLIT) {
            bl[nt][0] = pack_bf16_residual(x0, x1);
            bl[nt][1] = pack_bf16_residual(x2, x3);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mrow0 + mt * 16 >= rcap) continue;  // rows never stored
          const int rl = mrow0 + mt * 16 + gq, rh = rl + 8;
          // the one-hot A fragment: rows rl, rh; columns kb, kb + 1,
          // kb + 8, kb + 9 (the low half the first of each pair)
          uint32_t a[4];
          a[0] = (r0 == rl ? kBf16One : 0u) | (r1 == rl ? kBf16One << 16 : 0u);
          a[1] = (r0 == rh ? kBf16One : 0u) | (r1 == rh ? kBf16One << 16 : 0u);
          a[2] = (r2 == rl ? kBf16One : 0u) | (r3 == rl ? kBf16One << 16 : 0u);
          a[3] = (r2 == rh ? kBf16One : 0u) | (r3 == rh ? kBf16One << 16 : 0u);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            // the step's product from zero, then one float32 add (round to
            // nearest) into the running sum: the tensor cores' own
            // accumulation truncates, and fed the running sum it drifted
            // 2.6e-6 of the largest sum from the exact value over the
            // benchmark's runs of 110 (on an H100)
            float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(t, a, bh[nt][0], bh[nt][1]);
            if (SPLIT) mma_bf16(t, a, bl[nt][0], bl[nt][1]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] += t[i];
          }
        }
      }
    }
    __syncthreads();  // the next pass restages buffer 0

    if (!cols_live) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int rl = mrow0 + mt * 16 + gq;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = wn * 16 + nt * 8 + 2 * tq;
        if (col >= ncols) continue;
        float* o = out + (static_cast<int64_t>(c) * rcap + rl) * W + col0 + col;
        if (rl < rcap) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        }
        if (rl + 8 < rcap) {
          *reinterpret_cast<float2*>(o + 8 * static_cast<int64_t>(W)) =
              make_float2(acc[mt][nt][2], acc[mt][nt][3]);
        }
      }
    }
  }
}

// "highest": exact float32, one thread a column, entries in order
__global__ void __launch_bounds__(kExactThreads)
    chunk_onehot_partials_exact_kernel(const int* __restrict__ rank,
                                       const float* __restrict__ g, int W,
                                       int chunk, int rcap, int pass_rows,
                                       float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // (pass_rows, kColBlock)
  const int c = blockIdx.x;
  const int col = blockIdx.y * kColBlock + threadIdx.x;
  const bool live = col < W;
  const int64_t e0 = static_cast<int64_t>(c) * chunk;
  float* mine = acc + threadIdx.x;

  for (int pass = 0; pass < rcap; pass += pass_rows) {
    const int rows = min(pass_rows, rcap - pass);
    for (int r = 0; r < rows; ++r) mine[r * kColBlock] = 0.0f;
    // the current run of equal ranks, summed in float64 and added to its
    // row once it ends
    int cur = -1;
    double run = 0.0;
    for (int e = 0; e < chunk; e += kExactUnroll) {
      int r[kExactUnroll];
      float x[kExactUnroll];
#pragma unroll
      for (int u = 0; u < kExactUnroll; ++u) {
        r[u] = __ldg(rank + e0 + e + u) - pass;
        x[u] = live ? __ldg(g + (e0 + e + u) * W + col) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kExactUnroll; ++u) {
        if (r[u] != cur) {
          if (static_cast<unsigned>(cur) < static_cast<unsigned>(rows)) {
            mine[cur * kColBlock] += static_cast<float>(run);
          }
          cur = r[u];
          run = 0.0;
        }
        run += static_cast<double>(x[u]);
      }
    }
    if (static_cast<unsigned>(cur) < static_cast<unsigned>(rows)) {
      mine[cur * kColBlock] += static_cast<float>(run);
    }
    if (live) {
      float* o = out + (static_cast<int64_t>(c) * rcap + pass) * W + col;
      for (int r = 0; r < rows; ++r) o[static_cast<int64_t>(r) * W] =
          mine[r * kColBlock];
    }
  }
}

template <int MT, int RG, bool SPLIT>
cudaError_t launch_tc(const int* rank, const float* g, int64_t n, int W,
                      int chunk, int rcap, float* out, cudaStream_t stream) {
  using S = TcShape<RG>;
  auto kernel = chunk_onehot_partials_kernel<MT, RG, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n / chunk),
                  static_cast<unsigned>((W + S::kCols - 1) / S::kCols));
  kernel<<<grid, kThreads, S::kSmem, stream>>>(rank, g, W, chunk, rcap, out);
  return cudaGetLastError();
}

template <bool SPLIT>
cudaError_t launch_tc_rows(const int* rank, const float* g, int64_t n,
                           int W, int chunk, int rcap, float* out,
                           cudaStream_t stream) {
  // rows a pass covers: RG row groups x MT m16 tiles
  if (rcap <= 32) {
    return launch_tc<1, 2, SPLIT>(rank, g, n, W, chunk, rcap, out, stream);
  }
  if (rcap <= 64) {
    return launch_tc<2, 2, SPLIT>(rank, g, n, W, chunk, rcap, out, stream);
  }
  if (rcap <= 128) {
    return launch_tc<4, 2, SPLIT>(rank, g, n, W, chunk, rcap, out, stream);
  }
  return launch_tc<4, 4, SPLIT>(rank, g, n, W, chunk, rcap, out, stream);
}

// ---------------------------------------------------------- row_gather

constexpr int kGatherConsumers = 8;  // warps that store rows
constexpr int kGatherThreads = 32 * (kGatherConsumers + 1);

__global__ void __launch_bounds__(kGatherThreads)
    row_gather_bulk_kernel(const int* __restrict__ idx,
                           const float* __restrict__ tab, int64_t n, int V,
                           int W, int chunk, int depth,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(depth) * W * sizeof(float));
  uint64_t* empty = full + depth;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk;
  const int rows = static_cast<int>(min(static_cast<int64_t>(chunk),
                                        n - base));
  const int d = min(depth, rows);
  const uint32_t bytes = static_cast<uint32_t>(W) * sizeof(float);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < d; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    if (lane == 0) {
      auto issue = [&](int i) {
        const int s = i % d;
        const int r = __ldg(idx + base + i);
        if (static_cast<unsigned>(r) < static_cast<unsigned>(V)) {
          mbar_arrive_expect_tx(&full[s], bytes);
          bulk_copy_g2s(ring + static_cast<size_t>(s) * W,
                        tab + static_cast<int64_t>(r) * W, bytes, &full[s]);
        } else {
          mbar_arrive(&full[s]);  // nothing to copy: a zero row
        }
      };
      for (int i = 0; i < d; ++i) issue(i);  // warm-up
      for (int i = d; i < rows; ++i) {       // steady state
        // the slot's previous row (i - d, its (i / d - 1)-th use) stored
        mbar_wait(&empty[i % d], (i / d - 1) & 1);
        issue(i);
      }
    }
  } else {
    // Consumer warp w stores the rows of slots w, w + kGatherConsumers, ...
    // in row order (round f of slot s is row f d + s), so each slot's
    // phases are waited on by one warp, in order: a wait on parity f & 1
    // cannot pass on the slot's phase f - 2. The last round is the drain.
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int f = 0; f * d < rows; ++f) {
      for (int s = warp - 1; s < d; s += kGatherConsumers) {
        const int i = f * d + s;
        if (i >= rows) break;
        mbar_wait(&full[s], f & 1);
        const bool ok = static_cast<unsigned>(__ldg(idx + base + i)) <
                        static_cast<unsigned>(V);
        const float4* src = reinterpret_cast<const float4*>(
            ring + static_cast<size_t>(s) * W);
        float4* dst = reinterpret_cast<float4*>(out + (base + i) * W);
        for (int q = lane; q < W / 4; q += 32) dst[q] = ok ? src[q] : zero;
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
  }
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
  if (n <= 0 || W <= 0 || chunk <= 0 || rcap <= 0 || chunk % kKTile ||
      W % 8 || n % chunk || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int C = static_cast<int>(chunk);
  if (mode == 1) {
    return static_cast<int>(launch_tc_rows<true>(rank, g, n, W, C, rcap, out,
                                                 s));
  }
  if (mode == 2) {
    return static_cast<int>(launch_tc_rows<false>(rank, g, n, W, C, rcap,
                                                  out, s));
  }
  const dim3 grid(static_cast<unsigned>(n / chunk),
                  static_cast<unsigned>((W + kColBlock - 1) / kColBlock));
  const int pass_rows = min(rcap, kExactPassRows);
  const size_t smem = static_cast<size_t>(pass_rows) * kColBlock *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_onehot_partials_exact_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_onehot_partials_exact_kernel<<<grid, kExactThreads, smem, s>>>(
      rank, g, W, C, rcap, pass_rows, out);
  return static_cast<int>(cudaGetLastError());
}

// out: (n, W), uninitialised: every row is written. Needs 1 <= depth <=
// chunk, W * 4 % 16 == 0 and 16-byte aligned tab and out (the wrapper
// checks), a ring of depth * W * 4 bytes of shared memory.
int isle_row_gather_bulk_f32(const int* idx, const float* tab, int64_t n,
                             int V, int W, int64_t chunk, int depth,
                             float* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n <= 0 || W <= 0 || depth < 1 || depth > chunk || (W * 4) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(depth) * W * sizeof(float) +
                      2 * static_cast<size_t>(depth) * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      row_gather_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n + chunk - 1) / chunk);
  row_gather_bulk_kernel<<<blocks, kGatherThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      idx, tab, n, V, W, static_cast<int>(chunk), depth, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
