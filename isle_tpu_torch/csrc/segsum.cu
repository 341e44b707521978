// Segment sums over a SORTED segment stream: the two hand-written Hopper
// (sm_90a) kernels of the port. Built by isle_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound through the plain C entry points at the end (ctypes).
//
// Replaces the two Pallas kernels of isle_tpu/pallas_ops.py:
//   segsum_onehot_kernel      <- _segsum_onehot_call (pallas_ops.py:236)
//   segsum_gather_rows_kernel <- _segsum_rows_call   (pallas_ops.py:203),
//                                with the row gather of segsum_gather_rows
//                                (pallas_ops.py:382) fused in.
// The TPU kernels build a (rcap, chunk) segment one-hot in VMEM and
// contract it on the MXU, then scatter the partial rows through a plan
// (plan_segments). Here the kernels find the run boundaries themselves, so
// no plan, rank cap or fallback scatter exists. The output keeps the JAX
// wrappers' shape: (num_segments + 1) rows, the spill row last. Entries
// whose segment lies outside [0, num_segments] add nothing.
//
// segsum_onehot: one 4-byte atomic read-modify-write in L2 per flushed
//   register run, plus 8-12 bytes of stream read per entry. Sorted streams
//   send many neighbours to the same counter (a frequent word's histogram
//   bin), and same-address atomics serialise. Each thread therefore walks a
//   contiguous slice of its chunk and merges equal (segment, column)
//   neighbours in a register before its atomic.
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
//   - Work units are (slice, column tile): a slice is `chunk` consecutive
//     entries (an nnz split, so a Zipf head word of 100k+ entries costs
//     what any other entries cost), a tile is 32 lanes of one warp across
//     the row, each lane one float4 (W % 4 == 0 and a 16-byte aligned
//     table and output) or one float (any W). W = 100 takes 25 lanes, 128
//     takes 32, W = 300 takes three tiles.
//   - Persistent blocks (the card's SMs x the blocks that fit on one,
//     kRowsBlocksPerSM) of kRowsWarps warps; each warp walks units in a
//     grid-stride loop.
//   - A warp stages its slice's (seg, idx, val) kStage entries at a time
//     with cp.async into its own double buffer in shared memory: the next
//     batch (of this slice or the warp's next one) is in flight while the
//     current batch gathers.
//   - Each lane issues kInFlight independent row loads before it adds any
//     of them, so a warp has kInFlight rows in flight instead of one.
//   - A run's sum stays in registers and is stored once, with a plain store
//     when the slice owns the run. A run that crosses a slice edge leaves
//     its partial sums in a carry scratch, (num_slices, 2, W) floats and
//     (num_slices, 2) segment ids: slot 0 for the run the slice starts in
//     (begun in an earlier slice), slot 1 for the run it ends in
//     (continued by a later one). A second kernel adds each crossing run's
//     partials in slice order and stores the row. No float atomics: two
//     launches on the same input give bit-equal output.
//
// Both kernels launch on the caller's stream, allocate nothing (the
// wrapper allocates the output and the carry scratch), and return
// cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOnehotThreads = 256;

// out[seg * ncols + col] += (kHasVal ? val : 1) over the chunk's entries;
// col outside [0, ncols) adds nothing. T is int (exact counts) or float.
template <typename T, bool kHasVal>
__global__ void segsum_onehot_kernel(const int* __restrict__ seg,
                                     const int* __restrict__ col,
                                     const float* __restrict__ val,
                                     int64_t n, int num_segments, int ncols,
                                     int chunk, T* __restrict__ out) {
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t c1 = c0 + chunk < n ? c0 + chunk : n;
  const int per = (chunk + blockDim.x - 1) / blockDim.x;
  int64_t e = c0 + static_cast<int64_t>(threadIdx.x) * per;
  const int64_t e_end = e + per < c1 ? e + per : c1;
  int64_t cur = -1;  // flat output offset of the run held in `acc`
  T acc = 0;
  for (; e < e_end; ++e) {
    const int s = seg[e];
    const int c = col[e];
    if (s < 0 || s > num_segments || c < 0 || c >= ncols) continue;
    const int64_t off = static_cast<int64_t>(s) * ncols + c;
    T v;
    if constexpr (kHasVal) {
      v = val[e];
    } else {
      v = 1;
    }
    if (off == cur) {
      acc += v;
    } else {
      if (cur >= 0) atomicAdd(out + cur, acc);
      cur = off;
      acc = v;
    }
  }
  if (cur >= 0) atomicAdd(out + cur, acc);
}

int num_chunks(int64_t n, int chunk) {
  return static_cast<int>((n + chunk - 1) / chunk);
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
constexpr int kStage = 128;   // entries per staged batch of one warp
constexpr int kInFlight = 4;  // row loads a lane issues before it adds

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

// Copies `cnt` <= kStage entries of the stream from e0 into one buffer:
// 16-byte copies where all three arrays are aligned there, 4-byte copies
// for the rest.
__device__ __forceinline__ void stage_entries(const RowsArgs& a, int lane,
                                              int* s_seg, int* s_idx,
                                              float* s_val, int64_t e0,
                                              int cnt) {
  int done = 0;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(a.seg + e0) |
                        reinterpret_cast<uintptr_t>(a.idx + e0) |
                        reinterpret_cast<uintptr_t>(a.val + e0);
  if ((mis & 15) == 0) {
    done = cnt & ~3;
    for (int i = lane * 4; i < done; i += 128) {
      cp_async16(s_seg + i, a.seg + e0 + i);
      cp_async16(s_idx + i, a.idx + e0 + i);
      cp_async16(s_val + i, a.val + e0 + i);
    }
  }
  for (int i = done + lane; i < cnt; i += 32) {
    cp_async4(s_seg + i, a.seg + e0 + i);
    cp_async4(s_idx + i, a.idx + e0 + i);
    cp_async4(s_val + i, a.val + e0 + i);
  }
}

// One warp per (slice, column tile) unit, persistent over units.
template <int VEC>
__global__ void __launch_bounds__(kRowsThreads, kRowsBlocksPerSM)
    segsum_gather_rows_kernel(const RowsArgs a) {
  using V = typename Vec<VEC>::T;
  __shared__ __align__(16) int s_seg[kRowsWarps][2][kStage];
  __shared__ __align__(16) int s_idx[kRowsWarps][2][kStage];
  __shared__ __align__(16) float s_val[kRowsWarps][2][kStage];

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
  // Stores the sum of the run `cur`: into the carry slot 0 when the run
  // began before this slice, slot 1 when it goes on after it, else into
  // its output row, which no other unit writes.
  auto flush = [&](bool last) {
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
      if (in_range && active) carry[(2 * slice + slot) * WV + col] = acc;
    } else if (in_range && active) {
      V* p = out + static_cast<int64_t>(cur) * WV + col;
      if (a.accumulate) {
        V o = *p;
        vadd(o, acc);
        *p = o;
      } else {
        *p = acc;
      }
    }
  };

  open_unit();
  int buf = 0;
  int64_t st = b0;  // first entry of the batch in hand
  stage_entries(a, lane, s_seg[w][0], s_idx[w][0], s_val[w][0], st,
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
      stage_entries(a, lane, s_seg[w][buf ^ 1], s_idx[w][buf ^ 1],
                    s_val[w][buf ^ 1], nst,
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
    if (st + kStage >= b1 && have) flush(true);
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
// slice order; then stores the row. One warp per (slice, column tile).
template <int VEC>
__global__ void __launch_bounds__(kRowsThreads)
    segsum_rows_carry_kernel(const RowsArgs a) {
  using V = typename Vec<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int64_t u =
      static_cast<int64_t>(blockIdx.x) * kRowsWarps + (threadIdx.x >> 5);
  if (u >= a.num_slices * a.ntiles) return;
  const int64_t slice = u / a.ntiles;
  const int tile = static_cast<int>(u - slice * a.ntiles);
  const int s = a.carry_seg[2 * slice + 1];
  if (s < 0) return;
  const int WV = a.W / VEC;
  const int col = tile * 32 + lane;
  const bool active = col < WV;
  const V* carry = reinterpret_cast<const V*>(a.carry);
  V acc;
  vzero(acc);
  if (active) acc = carry[(2 * slice + 1) * WV + col];
  for (int64_t j = slice + 1;; j += 32) {
    // lane q looks at slice j + q; the run reaches the leading ones
    const int64_t jq = j + lane;
    const bool same = jq < a.num_slices && a.carry_seg[2 * jq] == s;
    const unsigned ball = __ballot_sync(0xffffffffu, same);
    const int m = ball == 0xffffffffu ? 32 : __ffs(~ball) - 1;
    if (active) {
      for (int q = 0; q < m; ++q) vadd(acc, carry[2 * (j + q) * WV + col]);
    }
    if (m < 32) break;
  }
  if (active) {
    V* p = reinterpret_cast<V*>(a.out) + static_cast<int64_t>(s) * WV + col;
    if (a.accumulate) {
      V o = *p;
      vadd(o, acc);
      *p = o;
    } else {
      *p = acc;
    }
  }
}

template <int VEC>
cudaError_t launch_gather_rows(RowsArgs a, int device, cudaStream_t stream) {
  a.ntiles = (a.W / VEC + 31) / 32;
  const int64_t units = a.num_slices * a.ntiles;
  const int64_t unit_blocks = (units + kRowsWarps - 1) / kRowsWarps;
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, segsum_gather_rows_kernel<VEC>, kRowsThreads, 0);
  if (err != cudaSuccess) return err;
  const int64_t resident =
      static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid =
      static_cast<int>(unit_blocks < resident ? unit_blocks : resident);
  segsum_gather_rows_kernel<VEC><<<grid, kRowsThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segsum_rows_carry_kernel<VEC>
      <<<static_cast<int>(unit_blocks), kRowsThreads, 0, stream>>>(a);
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

int isle_segsum_onehot_i32(const int* seg, const int* col, int64_t n,
                           int num_segments, int ncols, int chunk, int* out,
                           int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n > 0) {
    segsum_onehot_kernel<int, false>
        <<<num_chunks(n, chunk), kOnehotThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(seg, col, nullptr, n,
                                                num_segments, ncols, chunk,
                                                out);
  }
  return static_cast<int>(cudaGetLastError());
}

int isle_segsum_onehot_f32(const int* seg, const int* col, const float* val,
                           int64_t n, int num_segments, int ncols, int chunk,
                           float* out, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n > 0) {
    segsum_onehot_kernel<float, true>
        <<<num_chunks(n, chunk), kOnehotThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(seg, col, val, n,
                                                num_segments, ncols, chunk,
                                                out);
  }
  return static_cast<int>(cudaGetLastError());
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

}  // extern "C"
