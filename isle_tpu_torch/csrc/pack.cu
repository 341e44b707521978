// MWU inference's batch packed on the card: each doc's kept entries (words
// whose model mass is above 1e-10, src/infer.cpp:375-386) fill the doc's
// row from the start, in their order; the rest of the row holds the pad,
// word `vocab` and value 0.0f. A doc's row starts at its own offset of the
// flat output and has its own width, so that the caller lays the rows out
// by MWU's length buckets (each bucket's rows one after another, at the
// bucket's width) and never at the widest doc's width. Built by
// isle_tpu_torch/_build.py beside segsum.cu and bound through the plain C
// entry points at the end (ctypes); isle_tpu_torch/pack.py wraps them.
//
// Replaces no Pallas kernel: isle_tpu packs the batch in host numpy
// (isle_tpu/mwu.py build_infer_batch) and its MWU reaches no Pallas kernel.
// The port's host pack held the card idle for most of an inference job at
// UCI PubMed's shape (PERF.md), so the batch is packed here, from the
// corpus's CSR (offsets, rows, vals), and MWU's blocks are cut from it on
// the card.
//
//   pack_kept_lengths_kernel  kept[d] = the kept entries of doc d (int32).
//   pack_fill_kernel          the row of every doc: word_idx and a from
//                             row_start[d], row_width[d] slots.
//
// Bound: memory. The kept lengths read `rows` once (4 bytes an entry: 193
// MB, 0.06 ms at 3.35 TB/s for a PubMed range of 48.3M entries); the fill
// reads `rows` and `vals` (8 bytes an entry) and writes every slot of the
// two outputs once (8 bytes a slot: at most 0.84 GB at 820,000 docs x 128,
// less where shorter docs take narrower buckets), about 0.35 ms. No
// arithmetic on values: they are copied, so every row equals the host's
// row bit for bit.
//
// Design:
// - The keep test reads a per-word bit table that the host makes from the
//   model mass with the host pack's own comparison (`model_mass > 1e-10`
//   on float32), never the mass: a sum in another order, or a comparison in
//   another type, could flip a word at the threshold. Each block stages the
//   table (vocab / 8 bytes: 17.6 KB at PubMed's 141,043 words) in shared
//   memory once, so an entry's test is one shared-memory read.
// - One warp a doc, in a grid-stride loop over docs. The lanes read 32
//   consecutive entries (coalesced) and test their bits; __ballot_sync
//   gives the warp its kept lanes and __popc their count.
// - The fill walks a doc the same way. A kept lane's slot is the doc's
//   running count plus the kept lanes below it (__popc of the ballot under
//   the lane mask), so the kept entries keep their order, and a value is
//   read only where its word is kept. After the doc's entries the warp
//   writes the pads from the kept count to the row's width. Where the rows
//   tile the output, as the caller lays them, the kernel writes every slot
//   itself, so the outputs are allocated without a fill.
// - A word outside [0, vocab) counts as dropped (the table has no bit for
//   it); the port's corpora hold none.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPackWarps = 16;  // warps per block
constexpr int kPackThreads = kPackWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

struct PackArgs {
  const int64_t* offsets;  // (docs + 1,)
  const int* rows;         // word ids, (offsets[docs],)
  const float* vals;       // the fill only
  const unsigned* keep;    // `words` 32-bit words; bit w % 32 of word w / 32
  int64_t docs;
  int vocab;
  int words;
  const int64_t* row_start;  // the fill only: a doc's first slot, (docs,)
  const int* row_width;      // the fill only: a doc's slots, (docs,)
  int* kept;                 // the kept lengths only, (docs,)
  int* word_idx;             // the fill only, the flat output
  float* a;                  // the fill only, the flat output
};

__device__ __forceinline__ void stage_table(const PackArgs& p,
                                            unsigned* table) {
  for (int i = threadIdx.x; i < p.words; i += blockDim.x) {
    table[i] = p.keep[i];
  }
  __syncthreads();
}

__device__ __forceinline__ bool is_kept(const unsigned* table, int word,
                                        int vocab) {
  return static_cast<unsigned>(word) < static_cast<unsigned>(vocab) &&
         ((table[word >> 5] >> (word & 31)) & 1u);
}

__global__ void __launch_bounds__(kPackThreads)
    pack_kept_lengths_kernel(PackArgs p) {
  extern __shared__ unsigned table[];
  stage_table(p, table);
  const int lane = threadIdx.x & 31;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kPackWarps;
  for (int64_t d = static_cast<int64_t>(blockIdx.x) * kPackWarps +
                   (threadIdx.x >> 5);
       d < p.docs; d += step) {
    const int64_t end = p.offsets[d + 1];
    int count = 0;
    for (int64_t base = p.offsets[d]; base < end; base += 32) {
      const int64_t i = base + lane;
      const bool k = i < end && is_kept(table, p.rows[i], p.vocab);
      count += __popc(__ballot_sync(kFull, k));
    }
    if (lane == 0) p.kept[d] = count;
  }
}

__global__ void __launch_bounds__(kPackThreads) pack_fill_kernel(PackArgs p) {
  extern __shared__ unsigned table[];
  stage_table(p, table);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;  // the lanes under this one
  const int64_t step = static_cast<int64_t>(gridDim.x) * kPackWarps;
  for (int64_t d = static_cast<int64_t>(blockIdx.x) * kPackWarps +
                   (threadIdx.x >> 5);
       d < p.docs; d += step) {
    const int64_t end = p.offsets[d + 1];
    const int width = p.row_width[d];
    int* wi = p.word_idx + p.row_start[d];
    float* av = p.a + p.row_start[d];
    int count = 0;
    for (int64_t base = p.offsets[d]; base < end; base += 32) {
      const int64_t i = base + lane;
      const int word = i < end ? p.rows[i] : -1;
      const bool k = is_kept(table, word, p.vocab);
      const unsigned m = __ballot_sync(kFull, k);
      const int slot = count + __popc(m & below);
      if (k && slot < width) {
        wi[slot] = word;
        av[slot] = p.vals[i];
      }
      count += __popc(m);
    }
    for (int j = count + lane; j < width; j += 32) {
      wi[j] = p.vocab;
      av[j] = 0.0f;
    }
  }
}

// One launch of `kernel` over p.docs docs, a warp a doc: as many blocks as
// the card holds at once (each stages the table once), or fewer where there
// are fewer docs. The table is the block's dynamic shared memory; past the
// 48 KB default the kernel is given the room, up to the device's opt-in
// limit (cudaErrorInvalidValue beyond it).
cudaError_t launch_pack(void (*kernel)(PackArgs), const PackArgs& p,
                        int device, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(p.words) * sizeof(unsigned);
  int optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(kernel), kPackThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t want = (p.docs + kPackWarps - 1) / kPackWarps;
  const int64_t resident =
      static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(want < resident ? want : resident);
  kernel<<<grid, kPackThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Entry points: each makes `device` current (this library links its own
// static CUDA runtime, whose current device is not PyTorch's), launches on
// `stream` (PyTorch's current stream of that device), and returns
// cudaGetLastError() as an int, 0 on success.

extern "C" {

// kept: (docs,) int32, uninitialised: every doc's count is written.
int isle_pack_kept_lengths(const int64_t* offsets, const int* rows,
                           const unsigned* keep, int64_t docs, int vocab,
                           int words, int* kept, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (docs <= 0) return static_cast<int>(cudaGetLastError());
  PackArgs p{};
  p.offsets = offsets;
  p.rows = rows;
  p.keep = keep;
  p.docs = docs;
  p.vocab = vocab;
  p.words = words;
  p.kept = kept;
  return static_cast<int>(launch_pack(pack_kept_lengths_kernel, p, device,
                                      static_cast<cudaStream_t>(stream)));
}

// word_idx int32 and a float32: the flat outputs, uninitialised; doc d's
// row is their slots [row_start[d], row_start[d] + row_width[d]), every one
// of them written (a doc keeping more than its width has the rest left out).
int isle_pack_fill(const int64_t* offsets, const int* rows, const float* vals,
                   const unsigned* keep, int64_t docs, int vocab, int words,
                   const int64_t* row_start, const int* row_width,
                   int* word_idx, float* a, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (docs <= 0) return static_cast<int>(cudaGetLastError());
  PackArgs p{};
  p.offsets = offsets;
  p.rows = rows;
  p.vals = vals;
  p.keep = keep;
  p.docs = docs;
  p.vocab = vocab;
  p.words = words;
  p.row_start = row_start;
  p.row_width = row_width;
  p.word_idx = word_idx;
  p.a = a;
  return static_cast<int>(launch_pack(pack_fill_kernel, p, device,
                                      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
