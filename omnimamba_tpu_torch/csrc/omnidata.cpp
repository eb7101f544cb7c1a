// omnidata: native reader of the pretokenized T2I corpus, the port's own copy.
//
// mmap the JSONL once, index line offsets with a threaded scan, and fill
// int32 token batches + raw caption bytes directly into caller buffers with
// a zero-allocation schema scanner (rows are {"captions": [...], "tokens":
// [...]}). Bound to Python with ctypes by omnimamba_tpu_torch/data/native.py,
// which builds it with g++ at first use into omnimamba_tpu_torch/build/
// (ops/kernel_build.build_host_library).
//
// Build by hand: g++ -O3 -shared -fPIC -std=c++17 -pthread omnidata.cpp -o libomnidata.so

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Dataset {
  int fd = -1;
  const char* data = nullptr;
  size_t size = 0;
  std::vector<size_t> line_starts;  // offset of each line
  std::vector<size_t> line_ends;
};

// threaded newline index
void index_lines(Dataset* ds) {
  const char* d = ds->data;
  size_t n = ds->size;
  unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
  if (n < (1u << 20)) nthreads = 1;
  std::vector<std::vector<size_t>> newlines(nthreads);
  std::vector<std::thread> threads;
  size_t chunk = n / nthreads + 1;
  for (unsigned t = 0; t < nthreads; ++t) {
    threads.emplace_back([&, t]() {
      size_t lo = t * chunk, hi = std::min(n, lo + chunk);
      for (size_t i = lo; i < hi; ++i)
        if (d[i] == '\n') newlines[t].push_back(i);
    });
  }
  for (auto& th : threads) th.join();
  size_t start = 0;
  for (auto& v : newlines)
    for (size_t nl : v) {
      if (nl > start) {  // skip empty lines
        ds->line_starts.push_back(start);
        ds->line_ends.push_back(nl);
      }
      start = nl + 1;
    }
  if (start < n) {
    ds->line_starts.push_back(start);
    ds->line_ends.push_back(n);
  }
}

// --- minimal schema scanner ------------------------------------------------

const char* find_key(const char* p, const char* end, const char* key) {
  size_t klen = strlen(key);
  while (p + klen + 2 < end) {
    p = static_cast<const char*>(memchr(p, '"', end - p));
    if (!p) return nullptr;
    if (static_cast<size_t>(end - p) > klen + 1 && memcmp(p + 1, key, klen) == 0 &&
        p[klen + 1] == '"') {
      p += klen + 2;
      while (p < end && (*p == ' ' || *p == ':')) ++p;
      return p;
    }
    ++p;
  }
  return nullptr;
}

// parse "[1, 2, 3]" into out (up to max_n); returns count or -1
int parse_int_array(const char* p, const char* end, int32_t* out, int max_n) {
  while (p < end && *p != '[') ++p;
  if (p >= end) return -1;
  ++p;
  int n = 0;
  while (p < end && n < max_n) {
    while (p < end && (*p == ' ' || *p == ',')) ++p;
    if (p < end && *p == ']') return n;
    bool neg = false;
    if (*p == '-') { neg = true; ++p; }
    long v = 0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; any = true; }
    if (!any) return -1;
    out[n++] = static_cast<int32_t>(neg ? -v : v);
  }
  return n;
}

// count strings in `["a", "b", ...]`; fills (start,len) pairs up to max_n
int scan_string_array(const char* p, const char* end, const char** starts,
                      int* lens, int max_n) {
  while (p < end && *p != '[') ++p;
  if (p >= end) return -1;
  ++p;
  int n = 0;
  while (p < end && n < max_n) {
    while (p < end && (*p == ' ' || *p == ',')) ++p;
    if (p < end && *p == ']') return n;
    if (p >= end || *p != '"') return n;
    const char* s = ++p;
    // scan to closing quote honoring backslash escapes
    while (p < end) {
      if (*p == '\\') { p += 2; continue; }
      if (*p == '"') break;
      ++p;
    }
    starts[n] = s;
    lens[n] = static_cast<int>(p - s);
    ++n;
    if (p < end) ++p;
  }
  return n;
}

uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97f4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

}  // namespace

extern "C" {

void* od_open(const char* path) {
  auto* ds = new Dataset();
  ds->fd = open(path, O_RDONLY);
  if (ds->fd < 0) { delete ds; return nullptr; }
  struct stat st;
  if (fstat(ds->fd, &st) != 0) { close(ds->fd); delete ds; return nullptr; }
  ds->size = static_cast<size_t>(st.st_size);
  ds->data = static_cast<const char*>(
      mmap(nullptr, ds->size, PROT_READ, MAP_PRIVATE, ds->fd, 0));
  if (ds->data == MAP_FAILED) { close(ds->fd); delete ds; return nullptr; }
  madvise(const_cast<char*>(ds->data), ds->size, MADV_WILLNEED);
  index_lines(ds);
  return ds;
}

int64_t od_num_rows(void* handle) {
  return static_cast<Dataset*>(handle)->line_starts.size();
}

// Fill a T2I batch: tokens (n, num_tokens) int32; one randomly chosen caption
// per row copied into caption_buf (cap_stride bytes each, NUL-terminated),
// caption_lens[i] = byte length. Returns 0 on success, -(row+1) on parse
// error. Threaded over rows.
int od_fill_t2i_batch(void* handle, const int64_t* indices, int n,
                      int num_tokens, int32_t* tokens_out, char* caption_buf,
                      int cap_stride, int32_t* caption_lens, uint64_t seed) {
  auto* ds = static_cast<Dataset*>(handle);
  std::vector<int> errs(n, 0);
  unsigned nthreads = std::min<unsigned>(
      std::max(1u, std::thread::hardware_concurrency()), (unsigned)n);
  std::vector<std::thread> threads;
  size_t per = (n + nthreads - 1) / nthreads;
  for (unsigned t = 0; t < nthreads; ++t) {
    threads.emplace_back([&, t]() {
      for (size_t i = t * per; i < std::min<size_t>(n, (t + 1) * per); ++i) {
        int64_t row = indices[i];
        if (row < 0 || row >= (int64_t)ds->line_starts.size()) { errs[i] = 1; continue; }
        const char* p = ds->data + ds->line_starts[row];
        const char* end = ds->data + ds->line_ends[row];
        const char* tp = find_key(p, end, "tokens");
        if (!tp || parse_int_array(tp, end, tokens_out + i * num_tokens,
                                   num_tokens) != num_tokens) {
          errs[i] = 1;
          continue;
        }
        const char* cp = find_key(p, end, "captions");
        const char* starts[64];
        int lens[64];
        int ncap = cp ? scan_string_array(cp, end, starts, lens, 64) : -1;
        if (ncap <= 0) { errs[i] = 1; continue; }
        int k = static_cast<int>(splitmix64(seed ^ (uint64_t)row) % ncap);
        int len = std::min(lens[k], cap_stride - 1);
        memcpy(caption_buf + i * cap_stride, starts[k], len);
        caption_buf[i * cap_stride + len] = '\0';
        caption_lens[i] = len;
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int i = 0; i < n; ++i)
    if (errs[i]) return -(i + 1);
  return 0;
}

void od_close(void* handle) {
  auto* ds = static_cast<Dataset*>(handle);
  if (ds->data && ds->data != MAP_FAILED)
    munmap(const_cast<char*>(ds->data), ds->size);
  if (ds->fd >= 0) close(ds->fd);
  delete ds;
}

}  // extern "C"
