// The port's C I/O library: memory-mapped TDF parsing, the ingest
// sort/dedup and buffered text writers (the reference's native I/O layer,
// include/utils.h:96-487: an mmap char-parser and a buffered writer with
// hand-rolled formatters). A copy of isle_tpu's isle_io.cpp with the same
// entry points and the same bytes out; the host side of a training or
// inference run parses and writes on one core, so their speed adds
// straight to the end-to-end wall.
//
// Exposed through a C ABI that isle_tpu_torch/native.py binds with ctypes;
// that module builds this file with g++ at first use
// (-O3 -fPIC -std=c++17 -shared) into build/isle_tpu_torch/.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open_file(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) {
      ::close(fd);
      return false;
    }
    size = static_cast<size_t>(st.st_size);
    if (size == 0) {
      data = nullptr;
      return true;
    }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
      ::close(fd);
      return false;
    }
    madvise(p, size, MADV_SEQUENTIAL);
    data = static_cast<const char*>(p);
    return true;
  }

  ~MappedFile() {
    if (data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

// Parse up to `cap` whitespace-separated non-negative integers starting at
// *pos; returns count parsed into out[0..n).
inline bool parse_u64(const char*& p, const char* end, uint64_t& out) {
  while (p < end && !isdigit(static_cast<unsigned char>(*p))) ++p;
  if (p >= end) return false;
  uint64_t v = 0;
  while (p < end && isdigit(static_cast<unsigned char>(*p))) {
    v = v * 10 + static_cast<uint64_t>(*p - '0');
    ++p;
  }
  out = v;
  return true;
}

// Stable LSD radix sort of (key, idx) pairs by key, 11-bit digits,
// skipping all-zero high bits. One core: ~4-5x faster than the previous
// comparator std::sort over 16-byte structs at the 48M-entry NYTimes
// ingest (the reference leans on __gnu_parallel::sort with 28 threads,
// include/parallel.h:79; on one core the constant factor is the whole
// game). Stability preserves original order among equal
// keys, which keeps the keep-first dedup semantics without tie-break
// fields. Returns false on allocation failure.
bool radix_sort_pairs(uint64_t* key, uint32_t* idx, int64_t n) {
  if (n <= 1) return true;
  uint64_t ormask = 0;
  for (int64_t i = 0; i < n; ++i) ormask |= key[i];
  int bits = 64 - __builtin_clzll(ormask | 1);
  constexpr int kRB = 11;
  constexpr int kR = 1 << kRB;
  uint64_t* kbuf =
      static_cast<uint64_t*>(malloc(sizeof(uint64_t) * static_cast<size_t>(n)));
  uint32_t* ibuf =
      static_cast<uint32_t*>(malloc(sizeof(uint32_t) * static_cast<size_t>(n)));
  if (!kbuf || !ibuf) {
    free(kbuf);
    free(ibuf);
    return false;
  }
  uint64_t* ksrc = key;
  uint32_t* isrc = idx;
  uint64_t* kdst = kbuf;
  uint32_t* idst = ibuf;
  int64_t count[kR];
  for (int shift = 0; shift < bits; shift += kRB) {
    memset(count, 0, sizeof(count));
    for (int64_t i = 0; i < n; ++i)
      ++count[(ksrc[i] >> shift) & (kR - 1)];
    int64_t run = 0;
    for (int d = 0; d < kR; ++d) {
      int64_t c = count[d];
      count[d] = run;
      run += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      int64_t p = count[(ksrc[i] >> shift) & (kR - 1)]++;
      kdst[p] = ksrc[i];
      idst[p] = isrc[i];
    }
    std::swap(ksrc, kdst);
    std::swap(isrc, idst);
  }
  if (ksrc != key) {
    memcpy(key, ksrc, sizeof(uint64_t) * static_cast<size_t>(n));
    memcpy(idx, isrc, sizeof(uint32_t) * static_cast<size_t>(n));
  }
  free(kbuf);
  free(ibuf);
  return true;
}

}  // namespace

extern "C" {

// Count the number of `<doc> <word> <count>` triples in the file.
// Returns -1 on I/O error, -2 on token count not divisible by 3.
int64_t isle_count_entries(const char* path) {
  MappedFile f;
  if (!f.open_file(path)) return -1;
  const char* p = f.data;
  const char* end = f.data + f.size;
  int64_t tokens = 0;
  bool in_num = false;
  for (; p < end; ++p) {
    bool d = isdigit(static_cast<unsigned char>(*p));
    if (d && !in_num) ++tokens;
    in_num = d;
  }
  if (tokens % 3 != 0) return -2;
  return tokens / 3;
}

// Fill docs/words/counts (1-based ids preserved; caller rebases).
// Returns the number of triples written, or -1 on error.
int64_t isle_parse_tdf(const char* path, int64_t* docs, int64_t* words,
                       int64_t* counts, int64_t cap) {
  MappedFile f;
  if (!f.open_file(path)) return -1;
  const char* p = f.data;
  const char* end = f.data + f.size;
  int64_t n = 0;
  uint64_t a, b, c;
  while (n < cap) {
    if (!parse_u64(p, end, a)) break;
    if (!parse_u64(p, end, b)) return -1;  // truncated triple
    if (!parse_u64(p, end, c)) return -1;
    docs[n] = static_cast<int64_t>(a);
    words[n] = static_cast<int64_t>(b);
    counts[n] = static_cast<int64_t>(c);
    ++n;
  }
  return n;
}

// Write `<topic>\t<word>\t<weight>\n` for entries > 1e-8, topic-major,
// `base`-based ids, 10-decimal weights (reference sparse model format,
// src/denseMatrix.cpp:169-180). model is column-major (vocab x ntopics)
// i.e. model[w + v * t]. Returns bytes written or -1.
int64_t isle_write_sparse_model(const char* path, const float* model,
                                int64_t vocab, int64_t ntopics,
                                int32_t base) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  // Large stdio buffer: one fwrite per ~4MB.
  static const size_t kBuf = 4u << 20;
  std::string buf;
  buf.reserve(kBuf + 256);
  char line[80];
  int64_t total = 0;
  for (int64_t t = 0; t < ntopics; ++t) {
    const float* col = model + t * vocab;
    for (int64_t w = 0; w < vocab; ++w) {
      float v = col[w];
      if (v > 1e-8f) {
        int len = snprintf(line, sizeof(line), "%lld\t%lld\t%.10f\n",
                           static_cast<long long>(t + base),
                           static_cast<long long>(w + base),
                           static_cast<double>(v));
        buf.append(line, static_cast<size_t>(len));
        if (buf.size() >= kBuf) {
          fwrite(buf.data(), 1, buf.size(), f);
          total += static_cast<int64_t>(buf.size());
          buf.clear();
        }
      }
    }
  }
  if (!buf.empty()) {
    fwrite(buf.data(), 1, buf.size(), f);
    total += static_cast<int64_t>(buf.size());
  }
  fclose(f);
  return total;
}

// Write `<a>\t<b>\t<v>\n` lines, v at fixed 6 decimals (the reference's
// ftoa_mv 6-decimal float format, include/utils.h:431-478; used for
// DocCatchword.tsv / DocTopicCatchwordSums.tsv, src/trainer.cpp:874-1010,
// and the inference top-topics files, drivers/ISLEInfer.cpp:100-111).
// base_a/base_b are added to the raw ids (callers keep 0-based arrays and
// print 1-based). Returns bytes written or -1 on I/O error.
int64_t isle_write_if_triples(const char* path, const int32_t* a,
                              const int32_t* b, const float* v, int64_t n,
                              int32_t base_a, int32_t base_b) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  static const size_t kBuf = 4u << 20;
  std::string buf;
  buf.reserve(kBuf + 256);
  char line[96];
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    int len = snprintf(line, sizeof(line), "%d\t%d\t%.6f\n", a[i] + base_a,
                       b[i] + base_b, static_cast<double>(v[i]));
    buf.append(line, static_cast<size_t>(len));
    if (buf.size() >= kBuf) {
      fwrite(buf.data(), 1, buf.size(), f);
      total += static_cast<int64_t>(buf.size());
      buf.clear();
    }
  }
  if (!buf.empty()) {
    fwrite(buf.data(), 1, buf.size(), f);
    total += static_cast<int64_t>(buf.size());
  }
  fclose(f);
  return total;
}

// Write `<a>\t<b>\t<c>\n` integer triples (TopTwoTopicsPerDoc.txt,
// src/trainer.cpp:1008-1040). Returns bytes written or -1.
int64_t isle_write_iii_triples(const char* path, const int32_t* a,
                               const int32_t* b, const int32_t* c, int64_t n,
                               int32_t base_a, int32_t base_b,
                               int32_t base_c) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  static const size_t kBuf = 4u << 20;
  std::string buf;
  buf.reserve(kBuf + 256);
  char line[64];
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    int len = snprintf(line, sizeof(line), "%d\t%d\t%d\n", a[i] + base_a,
                       b[i] + base_b, c[i] + base_c);
    buf.append(line, static_cast<size_t>(len));
    if (buf.size() >= kBuf) {
      fwrite(buf.data(), 1, buf.size(), f);
      total += static_cast<int64_t>(buf.size());
      buf.clear();
    }
  }
  if (!buf.empty()) {
    fwrite(buf.data(), 1, buf.size(), f);
    total += static_cast<int64_t>(buf.size());
  }
  fclose(f);
  return total;
}

// Sort entries by (doc, word) keeping first occurrence of duplicates
// (the ingest sort/dedup, reference src/trainer.cpp:237-247, made
// deterministic). In-place on the three arrays; returns the deduplicated
// count, -1 on allocation failure, or -2 when n exceeds the 2^32-1
// capacity of the u32 index payload (callers should fall back to a
// host sort that indexes 64-bit).
int64_t isle_sort_dedup_entries(int64_t* docs, int64_t* words,
                                int64_t* counts, int64_t n) {
  if (n > INT64_C(0xFFFFFFFF)) return -2;  // idx payload is u32
  uint64_t* key =
      static_cast<uint64_t*>(malloc(sizeof(uint64_t) * static_cast<size_t>(n)));
  uint32_t* idx =
      static_cast<uint32_t*>(malloc(sizeof(uint32_t) * static_cast<size_t>(n)));
  if ((!key || !idx) && n > 0) {
    free(key);
    free(idx);
    return -1;
  }
  for (int64_t i = 0; i < n; ++i) {
    key[i] = (static_cast<uint64_t>(docs[i]) << 32) |
             static_cast<uint32_t>(words[i]);
    idx[i] = static_cast<uint32_t>(i);
  }
  if (!radix_sort_pairs(key, idx, n)) {
    free(key);
    free(idx);
    return -1;
  }
  // compact: stability means the first among equal keys is the lowest
  // original index (keep-first dedup, reference src/trainer.cpp:237-247)
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0 || key[i] != key[i - 1]) {
      key[m] = key[i];
      idx[m] = idx[i];
      ++m;
    }
  }
  // materialize outputs (counts gathered via original index from a copy,
  // since counts[] is also an output)
  int64_t* counts_copy =
      static_cast<int64_t*>(malloc(sizeof(int64_t) * static_cast<size_t>(n)));
  if (!counts_copy && n > 0) {
    free(key);
    free(idx);
    return -1;
  }
  memcpy(counts_copy, counts, sizeof(int64_t) * static_cast<size_t>(n));
  for (int64_t i = 0; i < m; ++i) {
    docs[i] = static_cast<int64_t>(key[i] >> 32);
    words[i] = static_cast<int64_t>(key[i] & 0xffffffffu);
    counts[i] = counts_copy[idx[i]];
  }
  free(counts_copy);
  free(key);
  free(idx);
  return m;
}

// Permutation sorting int32 (seg_major, seg_minor) pairs — used for the
// word-major (CSR) ordering of already doc-sorted entries. perm must have
// room for n int64s. Returns 0, -1 on allocation failure, or -2 when n
// exceeds the u32 index capacity (see isle_sort_dedup_entries).
int64_t isle_order_by(const int32_t* major, const int32_t* minor,
                      int64_t* perm, int64_t n) {
  if (n > INT64_C(0xFFFFFFFF)) return -2;  // idx payload is u32
  uint64_t* key =
      static_cast<uint64_t*>(malloc(sizeof(uint64_t) * static_cast<size_t>(n)));
  uint32_t* idx =
      static_cast<uint32_t*>(malloc(sizeof(uint32_t) * static_cast<size_t>(n)));
  if ((!key || !idx) && n > 0) {
    free(key);
    free(idx);
    return -1;
  }
  for (int64_t i = 0; i < n; ++i) {
    key[i] = (static_cast<uint64_t>(static_cast<uint32_t>(major[i])) << 32) |
             static_cast<uint32_t>(minor[i]);
    idx[i] = static_cast<uint32_t>(i);
  }
  if (!radix_sort_pairs(key, idx, n)) {
    free(key);
    free(idx);
    return -1;
  }
  for (int64_t i = 0; i < n; ++i) perm[i] = static_cast<int64_t>(idx[i]);
  free(key);
  free(idx);
  return 0;
}

}  // extern "C"
