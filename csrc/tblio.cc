// Fast .tbl table IO — native runtime component of the engine.
//
// The reference persists relations as "key payload\n" text rows
// (reference: src/datagen/generator.c:200-213 write_relation, enabled by
// --enable-persist).  Python-side formatting is ~50x too slow for the
// 128M-row benchmark relations, so the writer/reader live here: manual
// integer formatting into large buffers, multi-threaded chunk formatting,
// single sequential write.
//
// Built by avx_sort_merge_joins_tpu.datagen.native into csrc/build/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// formats v into buf backwards, returns pointer to first char
inline char* fmt_i32(char* end, int32_t v) {
  uint32_t u = v < 0 ? uint32_t(-(int64_t)v) : uint32_t(v);
  char* p = end;
  do {
    *--p = char('0' + u % 10);
    u /= 10;
  } while (u);
  if (v < 0) *--p = '-';
  return p;
}

struct Chunk {
  std::vector<char> buf;
  size_t len = 0;
};

}  // namespace

extern "C" {

// Write n "key payload" rows to path (mode "wb" truncates, "ab" appends —
// the append form backs the STREAMING persist of distributed materialize:
// per-card output chunks flush sequentially so no full join output ever
// sits in host memory, reference: src/datagen/generator.c:200-213).
static int tbl_write_mode(const char* path, const int32_t* keys,
                          const int32_t* payloads, int64_t n, int nthreads,
                          const char* mode) {
  if (nthreads < 1) nthreads = 1;
  int64_t per = (n + nthreads - 1) / nthreads;
  std::vector<Chunk> chunks(nthreads);
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; t++) {
    ts.emplace_back([&, t] {
      int64_t lo = t * per, hi = std::min(n, lo + per);
      if (lo >= hi) return;
      Chunk& c = chunks[t];
      c.buf.resize(size_t(hi - lo) * 24 + 64);
      char* out = c.buf.data();
      char tmp[16];
      for (int64_t i = lo; i < hi; i++) {
        char* e = tmp + 12;
        char* p = fmt_i32(e, keys[i]);
        memcpy(out, p, e - p);
        out += e - p;
        *out++ = ' ';
        e = tmp + 12;
        p = fmt_i32(e, payloads[i]);
        memcpy(out, p, e - p);
        out += e - p;
        *out++ = '\n';
      }
      c.len = out - c.buf.data();
    });
  }
  for (auto& th : ts) th.join();
  FILE* f = fopen(path, mode);
  if (!f) return -1;
  for (auto& c : chunks)
    if (c.len && fwrite(c.buf.data(), 1, c.len, f) != c.len) {
      fclose(f);
      return -2;
    }
  return fclose(f) == 0 ? 0 : -3;
}

int tbl_write(const char* path, const int32_t* keys, const int32_t* payloads,
              int64_t n, int nthreads) {
  return tbl_write_mode(path, keys, payloads, n, nthreads, "wb");
}

int tbl_append(const char* path, const int32_t* keys, const int32_t* payloads,
               int64_t n, int nthreads) {
  return tbl_write_mode(path, keys, payloads, n, nthreads, "ab");
}

// Read up to cap rows from path into keys/payloads; returns rows read or <0.
int64_t tbl_read(const char* path, int32_t* keys, int32_t* payloads,
                 int64_t cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size_t(sz) + 1);
  if (sz > 0 && fread(buf.data(), 1, size_t(sz), f) != size_t(sz)) {
    fclose(f);
    return -2;
  }
  fclose(f);
  buf[size_t(sz)] = '\0';
  const char* p = buf.data();
  const char* end = p + sz;
  int64_t row = 0;
  while (p < end && row < cap) {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r')) p++;
    if (p >= end) break;
    bool neg = *p == '-';
    if (neg) p++;
    int64_t k = 0;
    while (p < end && *p >= '0' && *p <= '9') k = k * 10 + (*p++ - '0');
    while (p < end && *p == ' ') p++;
    bool neg2 = *p == '-';
    if (neg2) p++;
    int64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    keys[row] = int32_t(neg ? -k : k);
    payloads[row] = int32_t(neg2 ? -v : v);
    row++;
  }
  return row;
}

}  // extern "C"
