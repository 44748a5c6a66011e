// NIfTI byte-stream codec + threaded batch loader — native C++ tier.
//
// The reference vendors niftilib + znzlib + zlib (~35k LoC of C under
// source/IRTKSimple2/nifti) as its L0 I/O layer.  Here the same capability
// is split: header/affine semantics live in Python (io/nifti1.py, ~220
// lines) while the byte-level work — file read, gzip inflate/deflate,
// and multi-file threaded prefetch (the "data loader") — is this C++
// module, loaded via ctypes with a pure-Python fallback.
//
// gzip framing is handled by zlib with windowBits=15+32 (auto-detect
// zlib/gzip) for reads and 15+16 (gzip) for writes, the same framing
// znzlib uses (IRTKSimple2/nifti/znzlib/znzlib.c).

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Read whole file into a malloc'd buffer. Returns nullptr on error.
unsigned char* read_raw(const char* path, long long* out_len) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  const long long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  unsigned char* buf = (unsigned char*)std::malloc(n > 0 ? n : 1);
  if (buf && n > 0 && (long long)std::fread(buf, 1, n, f) != n) {
    std::free(buf);
    buf = nullptr;
  }
  std::fclose(f);
  if (buf) *out_len = n;
  return buf;
}

bool is_gzip(const unsigned char* buf, long long n) {
  return n >= 2 && buf[0] == 0x1f && buf[1] == 0x8b;
}

// Inflate a gzip/zlib stream into a growing buffer.
unsigned char* inflate_all(const unsigned char* src, long long n,
                           long long* out_len) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 32) != Z_OK) return nullptr;
  long long cap = n * 4 + (1 << 20);
  unsigned char* out = (unsigned char*)std::malloc(cap);
  if (!out) {
    inflateEnd(&zs);
    return nullptr;
  }
  zs.next_in = const_cast<unsigned char*>(src);
  zs.avail_in = (uInt)n;
  long long total = 0;
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    if (total == cap) {
      cap *= 2;
      unsigned char* nb = (unsigned char*)std::realloc(out, cap);
      if (!nb) {
        std::free(out);
        inflateEnd(&zs);
        return nullptr;
      }
      out = nb;
    }
    zs.next_out = out + total;
    zs.avail_out = (uInt)(cap - total);
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      std::free(out);
      inflateEnd(&zs);
      return nullptr;
    }
    total = (long long)zs.total_out;
    if (ret == Z_OK && zs.avail_in == 0 && zs.avail_out > 0) break;
  }
  inflateEnd(&zs);
  *out_len = total;
  return out;
}

}  // namespace

extern "C" {

// Read a file; if gzip-framed, inflate. Returns malloc'd buffer (free
// with fr_nz_free) or nullptr. out_len receives the byte count.
unsigned char* fr_nz_read(const char* path, long long* out_len) {
  long long raw_len = 0;
  unsigned char* raw = read_raw(path, &raw_len);
  if (!raw) return nullptr;
  if (!is_gzip(raw, raw_len)) {
    *out_len = raw_len;
    return raw;
  }
  long long n = 0;
  unsigned char* out = inflate_all(raw, raw_len, &n);
  std::free(raw);
  if (out) *out_len = n;
  return out;
}

void fr_nz_free(unsigned char* p) { std::free(p); }

// Threaded batch read: paths[i] -> bufs[i]/lens[i] (each malloc'd; free
// individually with fr_nz_free; failed entries are nullptr/0).
// Returns the number of successfully read files.
int fr_nz_read_many(int n, const char** paths, unsigned char** bufs,
                    long long* lens, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> pool;
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += nthreads) {
      lens[i] = 0;
      bufs[i] = fr_nz_read(paths[i], &lens[i]);
    }
  };
  for (int t = 0; t < nthreads && t < n; t++) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
  int ok = 0;
  for (int i = 0; i < n; i++) ok += bufs[i] != nullptr;
  return ok;
}

// Write buf to path; gzip-compress when gzip != 0 (level 1..9).
// Returns 0 on success.
int fr_nz_write(const char* path, const unsigned char* buf, long long len,
                int gzip_frame, int level) {
  if (!gzip_frame) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    const bool ok = (long long)std::fwrite(buf, 1, len, f) == len;
    std::fclose(f);
    return ok ? 0 : -1;
  }
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (level < 1 || level > 9) level = 6;
  if (deflateInit2(&zs, level, Z_DEFLATED, 15 + 16, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    return -1;
  const long long cap = deflateBound(&zs, (uLong)len) + 64;
  unsigned char* out = (unsigned char*)std::malloc(cap);
  if (!out) {
    deflateEnd(&zs);
    return -1;
  }
  zs.next_in = const_cast<unsigned char*>(buf);
  zs.avail_in = (uInt)len;
  zs.next_out = out;
  zs.avail_out = (uInt)cap;
  const int ret = deflate(&zs, Z_FINISH);
  const long long total = (long long)zs.total_out;
  deflateEnd(&zs);
  int rc = -1;
  if (ret == Z_STREAM_END) {
    FILE* f = std::fopen(path, "wb");
    if (f) {
      rc = (long long)std::fwrite(out, 1, total, f) == total ? 0 : -1;
      std::fclose(f);
    }
  }
  std::free(out);
  return rc;
}

}  // extern "C"
