// Native graph-ingest and TSV-emit runtime for svinet-tpu.
//
// Counterpart of the reference's C++ data layer
// (reference: Network::read, src/network.cc:10-159, and the save_model
// writers, src/linksampling.cc:804-837). The compute path is JAX/XLA;
// this file is the host runtime around it: multithreaded edge-list
// parsing (mmap + hand-rolled integer scanning, one thread per chunk)
// and buffered TSV matrix emission, callable from Python via ctypes.
//
// Build: make -C native   (produces libsvinet_native.so)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <string>
#include <thread>
#include <vector>

namespace {

struct ChunkResult {
  std::vector<int64_t> vals;
};

// Scan whitespace-separated decimal integers in [begin, end).
// Comment lines (starting with '#' or '%', as in SNAP edge files) are
// skipped to end-of-line so header text like "# Nodes: 18772" never
// enters the token stream as edge data.
void scan_chunk(const char* begin, const char* end, ChunkResult* out) {
  out->vals.reserve((end - begin) / 8);
  const char* p = begin;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                       *p == '\r' || *p == ','))
      ++p;
    if (p >= end) break;
    if (*p == '#' || *p == '%') {  // comment: skip to end of line
      while (p < end && *p != '\n') ++p;
      continue;
    }
    bool neg = false;
    if (*p == '-') { neg = true; ++p; }
    int64_t v = 0;
    bool got = false;
    while (p < end && *p >= '0' && *p <= '9') {
      v = v * 10 + (*p - '0');
      ++p;
      got = true;
    }
    if (got) out->vals.push_back(neg ? -v : v);
    else ++p;  // skip junk byte
  }
}

}  // namespace

extern "C" {

// Parse a whitespace/comma-separated integer file into an int64 buffer.
// Returns a malloc'd buffer the caller frees with svinet_free; *out_count
// receives the number of integers. Returns nullptr on error.
int64_t* svinet_parse_ints(const char* path, int64_t* out_count,
                           int nthreads) {
  *out_count = 0;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return nullptr;
  }
  size_t size = static_cast<size_t>(st.st_size);
  const char* data = static_cast<const char*>(
      mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (data == MAP_FAILED) return nullptr;
  madvise(const_cast<char*>(data), size, MADV_SEQUENTIAL);

  int t = nthreads > 0 ? nthreads
                       : static_cast<int>(std::thread::hardware_concurrency());
  if (t < 1) t = 1;
  if (size < (1 << 20)) t = 1;  // small file: single thread

  // chunk boundaries aligned to NEWLINES: keeps tokens intact and makes
  // sure no thread starts scanning in the middle of a comment line
  std::vector<const char*> bounds(t + 1);
  bounds[0] = data;
  bounds[t] = data + size;
  for (int i = 1; i < t; ++i) {
    const char* p = data + (size * i) / t;
    while (p < data + size && *p != '\n') ++p;
    bounds[i] = p;
  }

  std::vector<ChunkResult> results(t);
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int i = 0; i < t; ++i)
    threads.emplace_back(scan_chunk, bounds[i], bounds[i + 1], &results[i]);
  for (auto& th : threads) th.join();
  munmap(const_cast<char*>(data), size);

  size_t total = 0;
  for (auto& r : results) total += r.vals.size();
  int64_t* out = static_cast<int64_t*>(malloc(total * sizeof(int64_t)));
  if (!out) return nullptr;
  size_t off = 0;
  for (auto& r : results) {
    memcpy(out + off, r.vals.data(), r.vals.size() * sizeof(int64_t));
    off += r.vals.size();
  }
  *out_count = static_cast<int64_t>(total);
  return out;
}

void svinet_free(void* p) { free(p); }

// Write an (n, k) float32 matrix as TSV rows:
//   <seq>\t<ext_id>\t<v0>\t...\t<vk-1>\n     with `decimals` precision.
// Returns 0 on success, -1 on ANY write error (ENOSPC etc.) so the
// Python caller can fall back instead of trusting a truncated file.
namespace {

// Fast fixed-decimal formatter: "%.<d>f" via int64 math (~10x fprintf).
// Falls back to snprintf for values the int64 path can't represent.
inline void append_fixed(std::string* out, double v, int decimals,
                         int64_t pow10) {
  // fall back when the SCALED value could overflow llround (int64 holds
  // ~9.2e18; fabs(NaN) fails the comparison too, so NaN/inf also fall
  // through) OR when it sits on a rounding half-boundary — llround is
  // half-away-from-zero while printf/Python round the exact binary
  // value half-even, so exact halves must delegate to libc for
  // byte-parity with the fallback writers
  double sd = v * static_cast<double>(pow10);
  double frac = sd - std::floor(sd);
  if (!(fabs(sd) < 9.0e18) || fabs(frac - 0.5) < 1e-6) {
    char tmp[64];
    snprintf(tmp, sizeof tmp, "%.*f", decimals, v);
    out->append(tmp);
    return;
  }
  int64_t scaled = llround(sd);
  // sign from the INPUT, not the scaled magnitude: printf prints
  // "-0.00000" for tiny negative values
  if (std::signbit(v) && v == v) {
    out->push_back('-');
  }
  if (scaled < 0) {
    scaled = -scaled;
  }
  int64_t ip = scaled / pow10, fp = scaled % pow10;
  char tmp[32];
  char* p = tmp + sizeof tmp;
  do { *--p = static_cast<char>('0' + ip % 10); ip /= 10; } while (ip);
  out->append(p, tmp + sizeof tmp - p);
  if (decimals > 0) {
    out->push_back('.');
    char* q = tmp + decimals;
    for (int d = decimals - 1; d >= 0; --d) { tmp[d] = static_cast<char>('0' + fp % 10); fp /= 10; }
    out->append(tmp, q);
  }
}

inline void append_int(std::string* out, int64_t v) {
  if (v < 0) { out->push_back('-'); v = -v; }
  char tmp[24];
  char* p = tmp + sizeof tmp;
  do { *--p = static_cast<char>('0' + v % 10); v /= 10; } while (v);
  out->append(p, tmp + sizeof tmp - p);
}

// Shared body: rows "<seq>\t<ext>\t<vals...>[\t<extra>]\n", parallel
// per-chunk formatting into strings, sequential ordered fwrite.
int write_matrix_impl(const char* path, const float* m, int64_t n,
                      int64_t k, const int64_t* ext_ids, int decimals,
                      const int64_t* extra) {
  if (decimals < 0 || decimals > 17) return -1;
  int64_t pow10 = 1;
  for (int d = 0; d < decimals; ++d) pow10 *= 10;
  int t = static_cast<int>(std::thread::hardware_concurrency());
  if (t < 1) t = 1;
  if (n < 4096) t = 1;
  std::vector<std::string> parts(static_cast<size_t>(t));
  auto worker = [&](int ti, int64_t lo, int64_t hi) {
    std::string& s = parts[static_cast<size_t>(ti)];
    s.reserve(static_cast<size_t>((hi - lo) * (k * (decimals + 3) + 24)));
    for (int64_t i = lo; i < hi; ++i) {
      append_int(&s, i);
      s.push_back('\t');
      append_int(&s, ext_ids ? ext_ids[i] : i);
      for (int64_t j = 0; j < k; ++j) {
        s.push_back('\t');
        append_fixed(&s, static_cast<double>(m[i * k + j]), decimals,
                     pow10);
      }
      if (extra) {
        s.push_back('\t');
        append_int(&s, extra[i]);
      }
      s.push_back('\n');
    }
  };
  std::vector<std::thread> threads;
  int64_t per = (n + t - 1) / t;
  for (int ti = 0; ti < t; ++ti) {
    int64_t lo = ti * per, hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    threads.emplace_back(worker, ti, lo, hi);
  }
  for (auto& th : threads) th.join();
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  bool ok = true;
  for (const auto& s : parts)
    if (!s.empty())
      ok = ok && fwrite(s.data(), 1, s.size(), f) == s.size();
  if (fclose(f) != 0) ok = false;
  return ok ? 0 : -1;
}

}  // namespace

int svinet_write_matrix_tsv(const char* path, const float* m, int64_t n,
                            int64_t k, const int64_t* ext_ids,
                            int decimals) {
  return write_matrix_impl(path, m, n, k, ext_ids, decimals, nullptr);
}

// groups.txt flavor: an extra int64 column (the argmax group) after the
// value columns (reference schema: src/linksampling.cc:1455-1476).
int svinet_write_matrix_tsv_extra(const char* path, const float* m,
                                  int64_t n, int64_t k,
                                  const int64_t* ext_ids, int decimals,
                                  const int64_t* extra) {
  return write_matrix_impl(path, m, n, k, ext_ids, decimals, extra);
}

// Write an (e, 2) int64 edge array as "<src>\t<dst>\n" lines.
int svinet_write_edges_tsv(const char* path, const int64_t* edges,
                           int64_t e) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  std::vector<char> buf(1 << 22);
  setvbuf(f, buf.data(), _IOFBF, buf.size());
  bool ok = true;
  for (int64_t i = 0; i < e && ok; ++i)
    ok = fprintf(f, "%lld\t%lld\n",
                 static_cast<long long>(edges[2 * i]),
                 static_cast<long long>(edges[2 * i + 1])) >= 0;
  if (fclose(f) != 0) ok = false;
  return ok ? 0 : -1;
}

// -preprocess: per-node "informative zeros" via the reference's 2-hop walk
// (reference: Network::set_neighborhood_sets, src/network.cc:558-686):
// round-robin over node i's neighbors, taking up to `per_neighbor` unseen
// 2-hop nodes from each per cycle, until `limit` zeros are collected or
// every neighbor's adjacency is exhausted. Parallel over nodes with
// per-thread visit-stamp arrays; results written to `path` in the
// reference's binary layout (uint32 node, uint64 count, uint32[count]).
// Exactly matches the Python fallback's output ordering.
int svinet_preprocess_neighbors(const char* path, const int64_t* row_ptr,
                                const int32_t* col_idx, int64_t n,
                                int limit, int per_neighbor, int nthreads) {
  int t = nthreads > 0 ? nthreads
                       : static_cast<int>(std::thread::hardware_concurrency());
  if (t < 1) t = 1;
  if (n < 1024) t = 1;

  std::vector<std::vector<uint32_t>> zeros(static_cast<size_t>(n));

  auto worker = [&](int64_t lo, int64_t hi) {
    std::vector<uint32_t> stamp(static_cast<size_t>(n), 0);
    uint32_t cur = 0;
    std::vector<int64_t> pos;
    std::vector<uint8_t> exhausted;
    for (int64_t i = lo; i < hi; ++i) {
      int64_t b = row_ptr[i], e = row_ptr[i + 1];
      int64_t deg = e - b;
      if (deg == 0) continue;
      ++cur;
      stamp[static_cast<size_t>(i)] = cur;
      for (int64_t r = b; r < e; ++r)
        stamp[static_cast<size_t>(col_idx[r])] = cur;
      pos.assign(static_cast<size_t>(deg), 0);
      exhausted.assign(static_cast<size_t>(deg), 0);
      for (int64_t j = 0; j < deg; ++j)
        pos[static_cast<size_t>(j)] = row_ptr[col_idx[b + j]];
      auto& out = zeros[static_cast<size_t>(i)];
      out.reserve(static_cast<size_t>(limit));
      int64_t n_exhausted = 0;
      while (static_cast<int>(out.size()) < limit && n_exhausted < deg) {
        for (int64_t j = 0; j < deg; ++j) {
          if (exhausted[static_cast<size_t>(j)] ||
              static_cast<int>(out.size()) >= limit)
            continue;
          int32_t q = col_idx[b + j];
          int64_t qe = row_ptr[q + 1];
          int c = 0;
          int64_t& k = pos[static_cast<size_t>(j)];
          while (k < qe && static_cast<int>(out.size()) < limit) {
            int32_t p = col_idx[k++];
            if (stamp[static_cast<size_t>(p)] != cur) {
              out.push_back(static_cast<uint32_t>(p));
              stamp[static_cast<size_t>(p)] = cur;
              if (++c >= per_neighbor) break;
            }
          }
          if (k >= qe) {
            exhausted[static_cast<size_t>(j)] = 1;
            ++n_exhausted;
          }
        }
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int i = 0; i < t; ++i) {
    int64_t lo = (n * i) / t, hi = (n * (i + 1)) / t;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();

  FILE* f = fopen(path, "w");
  if (!f) return -1;
  std::vector<char> buf(1 << 22);
  setvbuf(f, buf.data(), _IOFBF, buf.size());
  bool ok = true;
  for (int64_t i = 0; i < n && ok; ++i) {
    uint32_t id = static_cast<uint32_t>(i);
    uint64_t cnt = zeros[static_cast<size_t>(i)].size();
    ok = fwrite(&id, 4, 1, f) == 1 && fwrite(&cnt, 8, 1, f) == 1;
    if (ok && cnt)
      ok = fwrite(zeros[static_cast<size_t>(i)].data(), 4, cnt, f) == cnt;
  }
  if (fclose(f) != 0) ok = false;
  return ok ? 0 : -1;
}

}  // extern "C"
