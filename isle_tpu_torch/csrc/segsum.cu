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
// (plan_segments). Here a block owns one chunk of the stream and finds the
// run boundaries itself, so no plan, rank cap or fallback scatter exists.
// The output keeps the JAX wrappers' shape: (num_segments + 1) rows, the
// spill row last. Entries whose segment lies outside [0, num_segments]
// add nothing.
//
// What bounds them on the H100:
//   onehot:      one 4-byte atomic read-modify-write in L2 per flushed
//                register run, plus 8-12 bytes of stream read per entry.
//                Sorted streams send many neighbours to the same counter
//                (a frequent word's histogram bin), and same-address
//                atomics serialise. Each thread therefore walks a
//                contiguous slice of its chunk and merges equal (segment,
//                column) neighbours in a register before its atomic.
//   gather_rows: the row gather, 4*W bytes from table[idx] per entry
//                (at the NYTimes shape ~19 GB for 48M entries at W = 100,
//                the table does not fit the 50 MB L2). Threads span the W
//                columns, so each gathered row is one coalesced load. The
//                sum of a run stays in a register and is written once per
//                run; only a chunk's first and last runs, which a
//                neighbouring chunk may share, use float atomics.
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOnehotThreads = 256;
constexpr int kRowsMaxThreads = 256;

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

// Adds one run's sum into out[s, c]. Only the chunk's first and last runs
// can be shared with a neighbouring chunk; interior runs of a sorted
// stream belong to this block alone and take a plain add.
__device__ __forceinline__ void flush_run(float* __restrict__ out, int s,
                                          int c, int W, int num_segments,
                                          int first, int last, float acc) {
  if (s < 0 || s > num_segments) return;
  float* p = out + static_cast<int64_t>(s) * W + c;
  if (s == first || s == last) {
    atomicAdd(p, acc);
  } else {
    *p += acc;
  }
}

// out[seg, c] += val * table[idx, c] for c in this block's column tile;
// idx outside [0, table_rows) adds nothing. Dynamic shared memory holds
// the chunk's (seg, idx, val) so every thread reads them as broadcasts.
__global__ void segsum_gather_rows_kernel(const int* __restrict__ seg,
                                          const int* __restrict__ idx,
                                          const float* __restrict__ val,
                                          const float* __restrict__ table,
                                          int64_t n, int64_t table_rows,
                                          int W, int num_segments, int chunk,
                                          float* __restrict__ out) {
  extern __shared__ int smem[];
  int* s_seg = smem;
  int* s_idx = smem + chunk;
  float* s_val = reinterpret_cast<float*>(smem + 2 * chunk);
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int len = static_cast<int>(n - c0 < chunk ? n - c0 : chunk);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    s_seg[i] = seg[c0 + i];
    s_idx[i] = idx[c0 + i];
    s_val[i] = val[c0 + i];
  }
  __syncthreads();
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= W) return;
  const int first = s_seg[0];
  const int last = s_seg[len - 1];
  int cur = first;
  float acc = 0.0f;
  for (int i = 0; i < len; ++i) {
    const int s = s_seg[i];
    if (s != cur) {
      flush_run(out, cur, c, W, num_segments, first, last, acc);
      cur = s;
      acc = 0.0f;
    }
    const int64_t r = s_idx[i];
    if (r >= 0 && r < table_rows) acc += s_val[i] * table[r * W + c];
  }
  flush_run(out, cur, c, W, num_segments, first, last, acc);
}

int num_chunks(int64_t n, int chunk) {
  return static_cast<int>((n + chunk - 1) / chunk);
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

int isle_segsum_gather_rows_f32(const int* seg, const int* idx,
                                const float* val, const float* table,
                                int64_t n, int64_t table_rows, int W,
                                int num_segments, int chunk, float* out,
                                int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n > 0 && W > 0) {
    int threads = ((W + 31) / 32) * 32;
    if (threads > kRowsMaxThreads) threads = kRowsMaxThreads;
    const dim3 grid(num_chunks(n, chunk), (W + threads - 1) / threads);
    const size_t smem = static_cast<size_t>(chunk) * 3 * sizeof(int);
    segsum_gather_rows_kernel<<<grid, threads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        seg, idx, val, table, n, table_rows, W, num_segments, chunk, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
