// The port's C I/O library: TDF parsing, the ingest
// sort/dedup and buffered text writers (the reference's native I/O layer,
// include/utils.h:96-487: an mmap char-parser and a buffered writer with
// hand-rolled formatters). Same entry points and the same bytes out as
// isle_tpu's isle_io.cpp; the parse and the writers run on every core the
// process may use (the reference leans on its 28 threads the same way),
// since at UCI PubMed's size (787M entries, a 13 GB TDF file, writers of
// hundreds of millions of lines) one core would take minutes a file.
//
// Exposed through a C ABI that isle_tpu_torch/native.py binds with ctypes;
// that module builds this file with g++ at first use
// (-O3 -fPIC -std=c++17 -pthread -shared) into build/isle_tpu_torch/.

#include <algorithm>
#include <cerrno>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sched.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

inline bool is_digit(char c) {
  return static_cast<unsigned char>(c - '0') < 10;
}

// The cores this process may run on (its affinity mask), at least 1.
int worker_count() {
  cpu_set_t set;
  int n = 0;
  if (sched_getaffinity(0, sizeof(set), &set) == 0) n = CPU_COUNT(&set);
  if (n <= 0) n = static_cast<int>(std::thread::hardware_concurrency());
  return std::max(1, std::min(n, 64));
}

// fn(t) for t in [0, T): t = 0 on the calling thread, the others on
// threads of their own; where a thread cannot start, its part runs here.
template <class Fn>
void parallel_for(int T, const Fn& fn) {
  std::vector<std::thread> threads;
  std::vector<int> inline_parts;
  for (int t = 1; t < T; ++t) {
    try {
      threads.emplace_back(fn, t);
    } catch (...) {
      inline_parts.push_back(t);
    }
  }
  fn(0);
  for (int t : inline_parts) fn(t);
  for (auto& th : threads) th.join();
}

// A file read with pread: each worker reads its own byte range, a chunk
// of kReadChunk bytes at a time, into a buffer of its own (no mapping:
// the resident set stays a few MB, and on a user-space kernel such as
// gVisor a read costs less than the page faults of a mapping).
constexpr size_t kReadChunk = 4 << 20;

struct InputFile {
  int fd = -1;
  size_t size = 0;

  bool open_file(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = static_cast<size_t>(st.st_size);
    return true;
  }

  // fn(p, end) for each chunk of [lo, hi) in order, while it returns
  // true. Returns false on a read error.
  template <class Fn>
  bool read_range(size_t lo, size_t hi, const Fn& fn) const {
    std::vector<char> buf(std::min(kReadChunk, hi - lo));
    while (lo < hi) {
      ssize_t got = pread(fd, buf.data(), std::min(buf.size(), hi - lo),
                          static_cast<off_t>(lo));
      if (got < 0 && errno == EINTR) continue;
      if (got <= 0) return false;
      if (!fn(buf.data(), buf.data() + got)) return true;
      lo += static_cast<size_t>(got);
    }
    return true;
  }

  ~InputFile() {
    if (fd >= 0) ::close(fd);
  }
};

// [begin, end) byte ranges of the file, one a worker, whose borders never
// fall inside a run of digits: a token (a maximal run of digits) lies in
// exactly one range. Each border moves on from size / T * i past the
// pairs of digits it finds.
std::vector<size_t> token_ranges(const InputFile& f, int T) {
  const size_t size = f.size;
  std::vector<size_t> bounds(static_cast<size_t>(T) + 1, size);
  bounds[0] = 0;
  for (int i = 1; i < T; ++i) {
    size_t pos = std::max(bounds[i - 1], size / T * i);
    if (pos > 0 && pos < size) {
      size_t at = pos - 1;  // the pair (at, at + 1) is looked at
      for (;;) {
        char w[256];
        ssize_t got = pread(f.fd, w, sizeof(w), static_cast<off_t>(at));
        if (got < 2) {
          at = size - 1;
          break;
        }
        ssize_t k = 0;
        while (k + 1 < got && is_digit(w[k]) && is_digit(w[k + 1])) ++k;
        at += static_cast<size_t>(k);
        if (k + 1 < got) break;
      }
      pos = at + 1;
    }
    bounds[i] = pos;
  }
  return bounds;
}

struct TokenCounts {
  std::vector<size_t> bounds;
  std::vector<int64_t> first;  // the index of each range's first token
  int64_t total = 0;
  bool ok = true;
};

// The tokens of each range, counted on T workers.
TokenCounts count_all(const InputFile& f, int T) {
  TokenCounts tc;
  tc.bounds = token_ranges(f, T);
  std::vector<int64_t> per(static_cast<size_t>(T), 0);
  std::vector<char> ok(static_cast<size_t>(T), 1);
  parallel_for(T, [&](int t) {
    bool in_num = false;
    int64_t tokens = 0;
    ok[t] = f.read_range(tc.bounds[t], tc.bounds[t + 1],
                         [&](const char* p, const char* end) {
      for (; p < end; ++p) {
        bool d = is_digit(*p);
        tokens += d && !in_num;
        in_num = d;
      }
      return true;
    });
    per[t] = tokens;
  });
  tc.first.resize(static_cast<size_t>(T));
  for (int t = 0; t < T; ++t) {
    tc.first[t] = tc.total;
    tc.total += per[t];
    tc.ok = tc.ok && ok[t];
  }
  return tc;
}

// Stable LSD radix sort of (key, idx) pairs by key, 11-bit digits,
// skipping all-zero high bits, with the caller's buffers kbuf and ibuf
// (n each) as the other half of every pass. Returns true when the sorted
// pairs ended in (kbuf, ibuf), false when in (key, idx). Stability
// keeps equal keys in their original order, which gives the keep-first
// dedup its meaning without tie-break fields.
bool radix_sort_pairs(uint64_t* key, uint32_t* idx, uint64_t* kbuf,
                      uint32_t* ibuf, int64_t n) {
  if (n <= 1) return false;
  uint64_t ormask = 0;
  for (int64_t i = 0; i < n; ++i) ormask |= key[i];
  int bits = 64 - __builtin_clzll(ormask | 1);
  constexpr int kRB = 11;
  constexpr int kR = 1 << kRB;
  uint64_t* ksrc = key;
  uint32_t* isrc = idx;
  uint64_t* kdst = kbuf;
  uint32_t* idst = ibuf;
  std::vector<int64_t> count(kR);
  for (int shift = 0; shift < bits; shift += kRB) {
    std::fill(count.begin(), count.end(), 0);
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
  return ksrc == kbuf;
}

// Writes the items [0, items) in order, each formatted by fill(item,
// out) on a worker thread: a round formats one item a worker while this
// thread writes the round before. Returns the bytes written, or -1 where
// the file cannot be opened or written.
template <class Fill>
int64_t ordered_write(const char* path, int64_t items, const Fill& fill) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  const int T = worker_count();
  std::vector<std::string> bufs[2] = {std::vector<std::string>(T),
                                      std::vector<std::string>(T)};
  int64_t total = 0;
  bool ok = true;
  auto write_round = [&](std::vector<std::string>& round) {
    for (auto& b : round) {
      if (ok && !b.empty() && fwrite(b.data(), 1, b.size(), f) != b.size())
        ok = false;
      total += static_cast<int64_t>(b.size());
      b.clear();
    }
  };
  const int64_t rounds = (items + T - 1) / T;
  for (int64_t r = 0; r <= rounds; ++r) {
    std::vector<std::string>& cur = bufs[r % 2];
    std::vector<std::string>& prev = bufs[(r + 1) % 2];
    std::thread writer;
    bool wrote = false;
    if (r > 0) {
      try {
        writer = std::thread([&] { write_round(prev); });
        wrote = true;
      } catch (...) {
      }
    }
    if (r < rounds) {
      parallel_for(T, [&](int t) {
        int64_t item = r * T + t;
        if (item < items) fill(item, cur[t]);
      });
    }
    if (wrote) {
      writer.join();
    } else if (r > 0) {
      write_round(prev);
    }
  }
  if (fclose(f) != 0) ok = false;
  return ok ? total : -1;
}

// The lines a triple writer formats in one item.
constexpr int64_t kLinesPerItem = 1 << 18;

}  // namespace

extern "C" {

// Count the number of `<doc> <word> <count>` triples in the file.
// Returns -1 on I/O error, -2 on token count not divisible by 3.
int64_t isle_count_entries(const char* path) {
  InputFile f;
  if (!f.open_file(path)) return -1;
  if (f.size == 0) return 0;
  TokenCounts tc = count_all(f, worker_count());
  if (!tc.ok) return -1;
  if (tc.total % 3 != 0) return -2;
  return tc.total / 3;
}

// Fill docs/words/counts (1-based ids preserved; caller rebases) with the
// first min(cap, triples in the file) triples. Returns the number of
// triples written, or -1 on error (a file whose tokens run out inside a
// triple before cap triples were read).
int64_t isle_parse_tdf(const char* path, int64_t* docs, int64_t* words,
                       int64_t* counts, int64_t cap) {
  InputFile f;
  if (!f.open_file(path)) return -1;
  if (f.size == 0 || cap <= 0) return 0;
  const int T = worker_count();
  TokenCounts tc = count_all(f, T);
  if (!tc.ok) return -1;
  int64_t n = tc.total / 3;
  if (n >= cap) {
    n = cap;
  } else if (tc.total % 3 != 0) {
    return -1;  // truncated triple
  }
  const int64_t want = 3 * n;
  int64_t* out[3] = {docs, words, counts};
  std::vector<char> ok(static_cast<size_t>(T), 1);
  parallel_for(T, [&](int t) {
    int64_t j = tc.first[t];
    if (j >= want) return;
    int field = static_cast<int>(j % 3);
    int64_t row = j / 3;
    bool in_num = false;
    uint64_t v = 0;
    auto emit = [&] {
      out[field][row] = static_cast<int64_t>(v);
      if (++field == 3) {
        field = 0;
        ++row;
      }
      ++j;
      v = 0;
      in_num = false;
    };
    ok[t] = f.read_range(tc.bounds[t], tc.bounds[t + 1],
                         [&](const char* p, const char* end) {
      for (; p < end; ++p) {
        if (is_digit(*p)) {
          v = v * 10 + static_cast<uint64_t>(*p - '0');
          in_num = true;
        } else if (in_num) {
          emit();
          if (j >= want) return false;
        }
      }
      return true;
    });
    if (in_num && j < want) emit();  // a token that ends the range
  });
  for (char k : ok)
    if (!k) return -1;
  return n;
}

// Write `<topic>\t<word>\t<weight>\n` for entries > 1e-8, topic-major,
// `base`-based ids, 10-decimal weights (reference sparse model format,
// src/denseMatrix.cpp:169-180). model is column-major (vocab x ntopics)
// i.e. model[w + v * t]. Returns bytes written or -1.
int64_t isle_write_sparse_model(const char* path, const float* model,
                                int64_t vocab, int64_t ntopics,
                                int32_t base) {
  return ordered_write(path, ntopics, [&](int64_t t, std::string& out) {
    const float* col = model + t * vocab;
    char line[128];
    for (int64_t w = 0; w < vocab; ++w) {
      float v = col[w];
      if (v > 1e-8f) {
        int len = snprintf(line, sizeof(line), "%lld\t%lld\t%.10f\n",
                           static_cast<long long>(t + base),
                           static_cast<long long>(w + base),
                           static_cast<double>(v));
        out.append(line, static_cast<size_t>(len));
      }
    }
  });
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
  int64_t items = (n + kLinesPerItem - 1) / kLinesPerItem;
  return ordered_write(path, items, [&](int64_t item, std::string& out) {
    char line[128];
    int64_t hi = std::min(n, (item + 1) * kLinesPerItem);
    for (int64_t i = item * kLinesPerItem; i < hi; ++i) {
      int len = snprintf(line, sizeof(line), "%d\t%d\t%.6f\n", a[i] + base_a,
                         b[i] + base_b, static_cast<double>(v[i]));
      out.append(line, static_cast<size_t>(len));
    }
  });
}

// Write `<a>\t<b>\t<c>\n` integer triples (TopTwoTopicsPerDoc.txt,
// src/trainer.cpp:1008-1040; a TDF file with base_c = 0). Returns bytes
// written or -1.
int64_t isle_write_iii_triples(const char* path, const int32_t* a,
                               const int32_t* b, const int32_t* c, int64_t n,
                               int32_t base_a, int32_t base_b,
                               int32_t base_c) {
  int64_t items = (n + kLinesPerItem - 1) / kLinesPerItem;
  return ordered_write(path, items, [&](int64_t item, std::string& out) {
    char line[64];
    int64_t hi = std::min(n, (item + 1) * kLinesPerItem);
    for (int64_t i = item * kLinesPerItem; i < hi; ++i) {
      int len = snprintf(line, sizeof(line), "%d\t%d\t%d\n", a[i] + base_a,
                         b[i] + base_b, c[i] + base_c);
      out.append(line, static_cast<size_t>(len));
    }
  });
}

// Whether entries with ids in [0, 2^31) are already in strictly
// increasing (doc, word) order, so that the sort/dedup below would leave
// them as they are: 1 if so, 0 if not, -3 where an id lies outside
// [0, 2^31) (the sort below does not take such ids).
int64_t isle_check_entries(const int64_t* docs, const int64_t* words,
                           int64_t n) {
  const int64_t lim = INT64_C(1) << 31;
  bool sorted = true;
  for (int64_t i = 0; i < n; ++i) {
    if (docs[i] < 0 || docs[i] >= lim || words[i] < 0 || words[i] >= lim)
      return -3;
    if (i > 0 && sorted &&
        (docs[i] < docs[i - 1] ||
         (docs[i] == docs[i - 1] && words[i] <= words[i - 1])))
      sorted = false;
  }
  return sorted ? 1 : 0;
}

// Sort entries by (doc, word) keeping first occurrence of duplicates
// (the ingest sort/dedup, reference src/trainer.cpp:237-247, made
// deterministic), for ids in [0, 2^31). In place: the three arrays are
// the sort's buffers too (the keys take the docs' and the words' room),
// so beside them it allocates only two u32 index arrays, and it does so
// before it touches the arrays. Returns the deduplicated count, -1 on
// allocation failure (the arrays as they were), or -2 when n exceeds the
// 2^32-1 capacity of the u32 index payload (callers should fall back to
// a host sort that indexes 64-bit).
int64_t isle_sort_dedup_entries(int64_t* docs, int64_t* words,
                                int64_t* counts, int64_t n) {
  if (n > INT64_C(0xFFFFFFFF)) return -2;  // idx payload is u32
  if (n <= 1) return n;
  uint32_t* idx =
      static_cast<uint32_t*>(malloc(sizeof(uint32_t) * static_cast<size_t>(n)));
  uint32_t* ibuf =
      static_cast<uint32_t*>(malloc(sizeof(uint32_t) * static_cast<size_t>(n)));
  if (!idx || !ibuf) {
    free(idx);
    free(ibuf);
    return -1;
  }
  // key = doc << wbits | word: the (doc, word) order in as few bits as
  // the words need, so that the radix sort makes no pass over zeros
  uint64_t wor = 0;
  for (int64_t i = 0; i < n; ++i) wor |= static_cast<uint64_t>(words[i]);
  const int wbits = 64 - __builtin_clzll(wor | 1);
  const uint64_t wmask = (UINT64_C(1) << wbits) - 1;
  uint64_t* key = reinterpret_cast<uint64_t*>(docs);
  uint64_t* spare = reinterpret_cast<uint64_t*>(words);
  for (int64_t i = 0; i < n; ++i) {
    key[i] = (static_cast<uint64_t>(docs[i]) << wbits) |
             static_cast<uint64_t>(words[i]);
    idx[i] = static_cast<uint32_t>(i);
  }
  uint32_t* order = idx;
  if (radix_sort_pairs(key, idx, spare, ibuf, n)) {
    std::swap(key, spare);
    order = ibuf;
  }
  // compact: stability means the first among equal keys is the lowest
  // original index (keep-first dedup, reference src/trainer.cpp:237-247)
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0 || key[i] != key[m - 1]) {
      key[m] = key[i];
      order[m] = order[i];
      ++m;
    }
  }
  // the counts through the spare buffer, then the ids out of the keys
  int64_t* gathered = reinterpret_cast<int64_t*>(spare);
  for (int64_t i = 0; i < m; ++i) gathered[i] = counts[order[i]];
  memcpy(counts, gathered, sizeof(int64_t) * static_cast<size_t>(m));
  int64_t* key_ids = reinterpret_cast<int64_t*>(key);
  int64_t* other = reinterpret_cast<int64_t*>(spare);
  bool key_in_docs = key_ids == docs;
  for (int64_t i = 0; i < m; ++i) {
    uint64_t k = key[i];
    if (key_in_docs) {
      other[i] = static_cast<int64_t>(k & wmask);  // words
      key_ids[i] = static_cast<int64_t>(k >> wbits);
    } else {
      other[i] = static_cast<int64_t>(k >> wbits);  // docs
      key_ids[i] = static_cast<int64_t>(k & wmask);
    }
  }
  free(idx);
  free(ibuf);
  return m;
}

// Permutation sorting int32 (seg_major, seg_minor) pairs — used for the
// word-major (CSR) ordering of already doc-sorted entries. perm must have
// room for n int64s. Returns 0, -1 on allocation failure, or -2 when n
// exceeds the u32 index capacity (see isle_sort_dedup_entries).
int64_t isle_order_by(const int32_t* major, const int32_t* minor,
                      int64_t* perm, int64_t n) {
  if (n > INT64_C(0xFFFFFFFF)) return -2;  // idx payload is u32
  size_t sz = static_cast<size_t>(n);
  uint64_t* key = static_cast<uint64_t*>(malloc(sizeof(uint64_t) * sz));
  uint32_t* idx = static_cast<uint32_t*>(malloc(sizeof(uint32_t) * sz));
  uint64_t* kbuf = static_cast<uint64_t*>(malloc(sizeof(uint64_t) * sz));
  uint32_t* ibuf = static_cast<uint32_t*>(malloc(sizeof(uint32_t) * sz));
  if ((!key || !idx || !kbuf || !ibuf) && n > 0) {
    free(key);
    free(idx);
    free(kbuf);
    free(ibuf);
    return -1;
  }
  for (int64_t i = 0; i < n; ++i) {
    key[i] = (static_cast<uint64_t>(static_cast<uint32_t>(major[i])) << 32) |
             static_cast<uint32_t>(minor[i]);
    idx[i] = static_cast<uint32_t>(i);
  }
  const uint32_t* sorted =
      radix_sort_pairs(key, idx, kbuf, ibuf, n) ? ibuf : idx;
  for (int64_t i = 0; i < n; ++i) perm[i] = static_cast<int64_t>(sorted[i]);
  free(key);
  free(idx);
  free(kbuf);
  free(ibuf);
  return 0;
}

}  // extern "C"
