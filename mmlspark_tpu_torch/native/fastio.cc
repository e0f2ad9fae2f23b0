// Native IO engine for the binary datasource.
//
// The port's copy of mmlspark_tpu/native/fastio.cc: the directory scan,
// the thread-pool bulk read and the Spark-compatible murmur3 are the
// reference's, unchanged; the reference's CPython wrappers are replaced by
// plain C functions over pointers and sizes, loaded with ctypes (which
// releases the GIL for the call, as the reference's wrappers did around
// their IO).  native/__init__.py builds it at first use, as it builds the
// other host kernels, and io/binary.py reads through it.

#include <dirent.h>
#include <fnmatch.h>
#include <sys/stat.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Entry {
  std::string path;
  long long size;
  double mtime;
};

bool ScanDir(const std::string& root, const char* pattern, bool recursive,
             std::vector<Entry>* out, std::string* err) {
  DIR* dir = opendir(root.c_str());
  if (!dir) {
    *err = "cannot open directory: " + root;
    return false;
  }
  std::vector<std::string> subdirs;
  struct dirent* de;
  std::vector<Entry> local;
  while ((de = readdir(dir)) != nullptr) {
    if (std::strcmp(de->d_name, ".") == 0 || std::strcmp(de->d_name, "..") == 0)
      continue;
    std::string full = root + "/" + de->d_name;
    struct stat lst;
    if (lstat(full.c_str(), &lst) != 0) continue;
    bool is_symlink = S_ISLNK(lst.st_mode);
    struct stat st;
    if (stat(full.c_str(), &st) != 0) continue;  // broken symlink etc.
    if (S_ISDIR(st.st_mode)) {
      // never recurse through directory symlinks (os.walk
      // followlinks=False semantics: no cycles, no duplicate rows)
      if (recursive && !is_symlink) subdirs.push_back(full);
    } else if (S_ISREG(st.st_mode)) {
      if (pattern == nullptr || fnmatch(pattern, de->d_name, 0) == 0) {
        local.push_back(Entry{full, static_cast<long long>(st.st_size),
                              static_cast<double>(st.st_mtime)});
      }
    }
  }
  closedir(dir);
  // deterministic order: files of this dir sorted, then subdirs sorted
  std::sort(local.begin(), local.end(),
            [](const Entry& a, const Entry& b) { return a.path < b.path; });
  out->insert(out->end(), local.begin(), local.end());
  std::sort(subdirs.begin(), subdirs.end());
  for (const auto& sd : subdirs) {
    if (!ScanDir(sd, pattern, recursive, out, err)) return false;
  }
  return true;
}

// Read one file fully into a caller-provided buffer.  Returns bytes read
// or -1.
long long ReadWhole(const std::string& path, char* buf, long long cap) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return -1;
  long long total = 0;
  while (total < cap) {
    size_t got = std::fread(buf + total, 1,
                            static_cast<size_t>(cap - total), f);
    if (got == 0) break;
    total += static_cast<long long>(got);
  }
  std::fclose(f);
  return total;
}

// MurmurHash3 x86 32-bit, bit-compatible with Spark's Murmur3_x86_32 on
// UTF-8 bytes (featurize/hashing.py documents the parity contract).
uint32_t Murmur3_32(const unsigned char* data, size_t len, uint32_t seed) {
  const uint32_t c1 = 0xCC9E2D51u, c2 = 0x1B873593u;
  uint32_t h = seed;
  size_t n4 = len / 4 * 4;
  for (size_t i = 0; i < n4; i += 4) {
    uint32_t k;
    std::memcpy(&k, data + i, 4);  // little-endian hosts only (x86/arm64)
    k *= c1;
    k = (k << 15) | (k >> 17);
    k *= c2;
    h ^= k;
    h = (h << 13) | (h >> 19);
    h = h * 5 + 0xE6546B64u;
  }
  if (n4 < len) {
    unsigned char tail[4] = {0, 0, 0, 0};
    std::memcpy(tail, data + n4, len - n4);
    uint32_t k;
    std::memcpy(&k, tail, 4);
    k *= c1;
    k = (k << 15) | (k >> 17);
    k *= c2;
    h ^= k;
  }
  h ^= static_cast<uint32_t>(len);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Copy `s` into a malloc'd buffer the caller frees with
// mmlspark_io_free.
char* Dup(const std::string& s, int64_t* len) {
  char* p = static_cast<char*>(std::malloc(s.size() ? s.size() : 1));
  if (p && !s.empty()) std::memcpy(p, s.data(), s.size());
  *len = static_cast<int64_t>(s.size());
  return p;
}

}  // namespace

extern "C" {

void mmlspark_io_free(void* p) { std::free(p); }

// Scan `root` (files of each directory sorted, then its subdirectories
// sorted; directory symlinks are not followed).  On success *out holds
// `*count` records, each an int64 path length, the path's bytes, an int64
// size and a double mtime; returns 0.  On failure *out holds the error
// message and 2 is returned; 1 is an allocation failure.  The caller frees
// *out with mmlspark_io_free.
int mmlspark_scan_dir(const char* root, const char* pattern, int recursive,
                      char** out, int64_t* out_len, int64_t* count) {
  std::vector<Entry> entries;
  std::string err;
  if (!ScanDir(root, pattern, recursive != 0, &entries, &err)) {
    *out = Dup(err, out_len);
    return *out ? 2 : 1;
  }
  std::string buf;
  for (const Entry& e : entries) {
    int64_t n = static_cast<int64_t>(e.path.size());
    int64_t sz = static_cast<int64_t>(e.size);
    buf.append(reinterpret_cast<const char*>(&n), sizeof(n));
    buf.append(e.path);
    buf.append(reinterpret_cast<const char*>(&sz), sizeof(sz));
    buf.append(reinterpret_cast<const char*>(&e.mtime), sizeof(e.mtime));
  }
  *count = static_cast<int64_t>(entries.size());
  *out = Dup(buf, out_len);
  return *out ? 0 : 1;
}

// The size of each of the `n` paths: a regular file's st_size, else 0.
void mmlspark_file_sizes(const char* const* paths, int64_t n,
                         int64_t* sizes) {
  for (int64_t i = 0; i < n; ++i) {
    struct stat st;
    sizes[i] = (stat(paths[i], &st) == 0 && S_ISREG(st.st_mode))
                   ? static_cast<int64_t>(st.st_size)
                   : 0;
  }
}

// Read file i fully into bufs[i] (sizes[i] bytes) on `n_threads` threads.
// Returns the number of files that could not be read or changed size.
int64_t mmlspark_read_files(const char* const* paths, int64_t n,
                            char* const* bufs, const int64_t* sizes,
                            int n_threads) {
  std::atomic<long long> next(0);
  std::atomic<int64_t> failures(0);
  int workers = n_threads < 1 ? 1 : n_threads;
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(workers));
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&]() {
      while (true) {
        long long i = next.fetch_add(1);
        if (i >= n) break;
        long long got = ReadWhole(paths[i], bufs[i], sizes[i]);
        if (got != sizes[i]) failures.fetch_add(1);
      }
    });
  }
  for (auto& t : pool) t.join();
  return failures.load();
}

// Murmur3_x86_32 of each of the `n` byte strings data[offsets[i] :
// offsets[i + 1]], as signed int32 (like the JVM).
void mmlspark_murmur3_batch(const char* data, const int64_t* offsets,
                            int64_t n, uint32_t seed, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = static_cast<int32_t>(Murmur3_32(
        reinterpret_cast<const unsigned char*>(data + offsets[i]),
        static_cast<size_t>(offsets[i + 1] - offsets[i]), seed));
  }
}

}  // extern "C"
