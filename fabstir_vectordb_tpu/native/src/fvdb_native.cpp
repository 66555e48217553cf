// fvdb_native: host-side runtime primitives for the vector DB.
//
// Native (C++) equivalents of the reference's native runtime components
// (reference: the Rust crate's storage/cache layer - src/storage/*,
// src/core/chunk_cache.rs - and the wasm-bindgen brute-force index,
// bindings/wasm/src/index.rs). Exposed through a plain C ABI consumed from
// Python via ctypes; the same sources compile under emscripten for a
// browser build (no JS engine dependencies).
//
// Components:
//   1. Atomic filesystem blob IO (put = tmp + rename, mkdir -p).
//   2. Thread-pool parallel multi-get (the ChunkLoader fan-out).
//   3. Byte-bounded LRU cache with hit/miss/eviction stats
//      (reference: src/core/chunk_cache.rs:12-172).
//   4. InMemoryIndex: brute-force cosine-distance index + scalar filter,
//      feature parity with the reference WASM InMemoryIndex/SearchFilter
//      (reference: bindings/wasm/src/index.rs:41-331).

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <list>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#define FVDB_API extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// 1. Filesystem blob IO
// ---------------------------------------------------------------------------

static int mkdir_p(const std::string& path) {
  std::string cur;
  for (size_t i = 0; i < path.size(); ++i) {
    cur += path[i];
    if (path[i] == '/' && cur.size() > 1) {
      if (mkdir(cur.c_str(), 0755) != 0 && errno != EEXIST) return -1;
    }
  }
  if (!cur.empty() && mkdir(cur.c_str(), 0755) != 0 && errno != EEXIST)
    return -1;
  return 0;
}

FVDB_API void fvdb_free(void* p) { free(p); }

// Returns 0 on success, 1 not-found, -1 error. *out is malloc'd.
FVDB_API int fvdb_fs_get(const char* path, uint8_t** out, int64_t* out_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return errno == ENOENT ? 1 : -1;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  uint8_t* buf = (uint8_t*)malloc(n > 0 ? n : 1);
  if (!buf) { fclose(f); return -1; }
  size_t got = fread(buf, 1, n, f);
  fclose(f);
  if ((long)got != n) { free(buf); return -1; }
  *out = buf;
  *out_len = n;
  return 0;
}

// Atomic write: parent mkdir -p, write tmp, rename.
FVDB_API int fvdb_fs_put(const char* path, const uint8_t* data, int64_t len) {
  std::string p(path);
  size_t slash = p.rfind('/');
  if (slash != std::string::npos) {
    if (mkdir_p(p.substr(0, slash)) != 0) return -1;
  }
  std::string tmp = p + ".tmp." + std::to_string(getpid());
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  size_t wrote = fwrite(data, 1, len, f);
  if (fflush(f) != 0 || (int64_t)wrote != len) {
    fclose(f);
    remove(tmp.c_str());
    return -1;
  }
  fclose(f);
  if (rename(tmp.c_str(), p.c_str()) != 0) {
    remove(tmp.c_str());
    return -1;
  }
  return 0;
}

FVDB_API int fvdb_fs_delete(const char* path) {
  if (remove(path) != 0 && errno != ENOENT) return -1;
  return 0;
}

FVDB_API int fvdb_fs_exists(const char* path) {
  struct stat st;
  return stat(path, &st) == 0 && S_ISREG(st.st_mode) ? 1 : 0;
}

// Parallel multi-get: paths joined by '\n'. Results written into caller
// arrays. status[i]: 0 ok, 1 missing, -1 error.
FVDB_API int fvdb_fs_get_many(const char* joined_paths, int n,
                              uint8_t** bufs, int64_t* lens, int* status,
                              int n_threads) {
  std::vector<std::string> paths;
  paths.reserve(n);
  {
    const char* s = joined_paths;
    for (int i = 0; i < n; ++i) {
      const char* e = strchr(s, '\n');
      if (!e) e = s + strlen(s);
      paths.emplace_back(s, e - s);
      s = (*e) ? e + 1 : e;
    }
  }
  std::atomic<int> next(0);
  int workers = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> pool;
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= n) return;
        status[i] = fvdb_fs_get(paths[i].c_str(), &bufs[i], &lens[i]);
      }
    });
  }
  for (auto& th : pool) th.join();
  return 0;
}

// ---------------------------------------------------------------------------
// 2. Byte-bounded LRU cache
// ---------------------------------------------------------------------------

struct LruCache {
  struct Entry {
    std::string key;
    std::vector<uint8_t> data;
  };
  std::list<Entry> order;  // front = most recent
  std::unordered_map<std::string, std::list<Entry>::iterator> map;
  int64_t max_bytes;
  int64_t bytes = 0;
  int64_t hits = 0, misses = 0, evictions = 0;
  std::mutex mu;
};

FVDB_API void* fvdb_cache_new(int64_t max_bytes) {
  auto* c = new LruCache();
  c->max_bytes = max_bytes;
  return c;
}

FVDB_API void fvdb_cache_destroy(void* h) { delete (LruCache*)h; }

FVDB_API int fvdb_cache_put(void* h, const char* key, const uint8_t* data,
                            int64_t len) {
  auto* c = (LruCache*)h;
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = c->map.find(key);
  if (it != c->map.end()) {
    c->bytes -= (int64_t)it->second->data.size();
    c->order.erase(it->second);
    c->map.erase(it);
  }
  c->order.push_front({key, std::vector<uint8_t>(data, data + len)});
  c->map[key] = c->order.begin();
  c->bytes += len;
  while (c->bytes > c->max_bytes && c->order.size() > 1) {
    auto& victim = c->order.back();
    c->bytes -= (int64_t)victim.data.size();
    c->map.erase(victim.key);
    c->order.pop_back();
    c->evictions++;
  }
  return 0;
}

// Returns 0 hit (malloc'd copy in *out), 1 miss.
FVDB_API int fvdb_cache_get(void* h, const char* key, uint8_t** out,
                            int64_t* out_len) {
  auto* c = (LruCache*)h;
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = c->map.find(key);
  if (it == c->map.end()) {
    c->misses++;
    return 1;
  }
  c->order.splice(c->order.begin(), c->order, it->second);
  c->hits++;
  auto& data = it->second->data;
  uint8_t* buf = (uint8_t*)malloc(data.size() > 0 ? data.size() : 1);
  memcpy(buf, data.data(), data.size());
  *out = buf;
  *out_len = (int64_t)data.size();
  return 0;
}

FVDB_API int fvdb_cache_remove(void* h, const char* key) {
  auto* c = (LruCache*)h;
  std::lock_guard<std::mutex> lock(c->mu);
  auto it = c->map.find(key);
  if (it == c->map.end()) return 1;
  c->bytes -= (int64_t)it->second->data.size();
  c->order.erase(it->second);
  c->map.erase(it);
  return 0;
}

FVDB_API void fvdb_cache_stats(void* h, int64_t* hits, int64_t* misses,
                               int64_t* evictions, int64_t* bytes,
                               int64_t* entries) {
  auto* c = (LruCache*)h;
  std::lock_guard<std::mutex> lock(c->mu);
  *hits = c->hits;
  *misses = c->misses;
  *evictions = c->evictions;
  *bytes = c->bytes;
  *entries = (int64_t)c->order.size();
}

// ---------------------------------------------------------------------------
// 3. InMemoryIndex: brute-force cosine index + scalar filter
//    (parity: bindings/wasm/src/index.rs - add/search/update/delete,
//     duplicate & dimension checks, distance = 1 - cosine)
// ---------------------------------------------------------------------------

struct InMemoryIndex {
  int dim = 0;
  std::vector<std::string> ids;
  std::vector<float> data;   // row-major
  std::vector<float> norms;  // row L2 norms
  std::unordered_map<std::string, int> id_to_row;
  std::vector<uint8_t> deleted;
  std::mutex mu;
};

FVDB_API void* fvdb_index_new(int dim) {
  auto* ix = new InMemoryIndex();
  ix->dim = dim;
  return ix;
}

FVDB_API void fvdb_index_destroy(void* h) { delete (InMemoryIndex*)h; }

// 0 ok, 1 duplicate id, 2 dim mismatch.
FVDB_API int fvdb_index_add(void* h, const char* id, const float* vec,
                            int dim) {
  auto* ix = (InMemoryIndex*)h;
  std::lock_guard<std::mutex> lock(ix->mu);
  if (dim != ix->dim) return 2;
  if (ix->id_to_row.count(id)) return 1;
  int row = (int)ix->ids.size();
  ix->ids.emplace_back(id);
  ix->data.insert(ix->data.end(), vec, vec + dim);
  float n = 0.f;
  for (int i = 0; i < dim; ++i) n += vec[i] * vec[i];
  ix->norms.push_back(std::sqrt(n));
  ix->deleted.push_back(0);
  ix->id_to_row[id] = row;
  return 0;
}

// 0 ok, 1 unknown id, 2 dim mismatch.
FVDB_API int fvdb_index_update(void* h, const char* id, const float* vec,
                               int dim) {
  auto* ix = (InMemoryIndex*)h;
  std::lock_guard<std::mutex> lock(ix->mu);
  if (dim != ix->dim) return 2;
  auto it = ix->id_to_row.find(id);
  if (it == ix->id_to_row.end()) return 1;
  int row = it->second;
  std::memcpy(&ix->data[(size_t)row * dim], vec, dim * sizeof(float));
  float n = 0.f;
  for (int i = 0; i < dim; ++i) n += vec[i] * vec[i];
  ix->norms[row] = std::sqrt(n);
  return 0;
}

FVDB_API int fvdb_index_delete(void* h, const char* id) {
  auto* ix = (InMemoryIndex*)h;
  std::lock_guard<std::mutex> lock(ix->mu);
  auto it = ix->id_to_row.find(id);
  if (it == ix->id_to_row.end()) return 1;
  ix->deleted[it->second] = 1;
  ix->id_to_row.erase(it);
  return 0;
}

FVDB_API int fvdb_index_len(void* h) {
  auto* ix = (InMemoryIndex*)h;
  std::lock_guard<std::mutex> lock(ix->mu);
  return (int)ix->id_to_row.size();
}

// Search: cosine distance (1 - cos), ascending. out_rows receives row
// indices; fetch ids with fvdb_index_id. allow_rows: optional bitmask
// (length = rows) for pre-filtered search; NULL = all.
FVDB_API int fvdb_index_search(void* h, const float* q, int dim, int k,
                               const uint8_t* allow_rows, int* out_rows,
                               float* out_dists) {
  auto* ix = (InMemoryIndex*)h;
  std::lock_guard<std::mutex> lock(ix->mu);
  if (dim != ix->dim) return -2;
  float qn = 0.f;
  for (int i = 0; i < dim; ++i) qn += q[i] * q[i];
  qn = std::sqrt(qn);
  int n = (int)ix->ids.size();
  std::vector<std::pair<float, int>> scored;
  scored.reserve(n);
  for (int r = 0; r < n; ++r) {
    if (ix->deleted[r]) continue;
    if (allow_rows && !allow_rows[r]) continue;
    const float* x = &ix->data[(size_t)r * dim];
    float dot = 0.f;
    for (int i = 0; i < dim; ++i) dot += q[i] * x[i];
    float denom = qn * ix->norms[r];
    float cos = denom > 1e-30f ? dot / denom : 0.f;
    scored.emplace_back(1.0f - cos, r);
  }
  int kk = std::min(k, (int)scored.size());
  std::partial_sort(scored.begin(), scored.begin() + kk, scored.end());
  for (int i = 0; i < kk; ++i) {
    out_dists[i] = scored[i].first;
    out_rows[i] = scored[i].second;
  }
  return kk;
}

// ---------------------------------------------------------------------------
// 4. Vector math + cosine k-means (parity: bindings/wasm/src/vector.rs
//    Vector/VectorBatch/cosine_similarity/euclidean_distance and
//    bindings/wasm/src/video.rs VideoClustering::cluster)
// ---------------------------------------------------------------------------

static float cosine_sim(const float* a, const float* b, int dim) {
  float dot = 0.f, na = 0.f, nb = 0.f;
  for (int i = 0; i < dim; ++i) {
    dot += a[i] * b[i];
    na += a[i] * a[i];
    nb += b[i] * b[i];
  }
  na = std::sqrt(na);
  nb = std::sqrt(nb);
  return (na > 0.f && nb > 0.f) ? dot / (na * nb) : 0.f;
}

FVDB_API float fvdb_vec_cosine(const float* a, const float* b, int dim) {
  return cosine_sim(a, b, dim);
}

FVDB_API float fvdb_vec_euclidean(const float* a, const float* b, int dim) {
  float s = 0.f;
  for (int i = 0; i < dim; ++i) {
    float d = a[i] - b[i];
    s += d * d;
  }
  return std::sqrt(s);
}

FVDB_API float fvdb_vec_magnitude(const float* a, int dim) {
  float s = 0.f;
  for (int i = 0; i < dim; ++i) s += a[i] * a[i];
  return std::sqrt(s);
}

// Cosine similarity of one query against n row-major vectors (VectorBatch::
// compute_similarities). Threaded for large n.
FVDB_API void fvdb_vec_batch_cosine(const float* rows, int n, int dim,
                                    const float* q, float* out,
                                    int n_threads) {
  int workers = std::max(1, std::min(n_threads, n));
  if (workers == 1 || n < 1024) {
    for (int r = 0; r < n; ++r)
      out[r] = cosine_sim(rows + (size_t)r * dim, q, dim);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> pool;
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int r = next.fetch_add(1);
        if (r >= n) return;
        out[r] = cosine_sim(rows + (size_t)r * dim, q, dim);
      }
    });
  }
  for (auto& th : pool) th.join();
}

// K-means with cosine distance (1 - cos), deterministic strided init and
// convergence when no assignment changes — the reference browser-side
// clustering algorithm (video.rs:244-308). Returns iterations used.
FVDB_API int fvdb_kmeans_cosine(const float* data, int n, int dim, int k,
                                int max_iterations, int* assignments,
                                float* centroids) {
  if (n <= 0 || k <= 0) return 0;
  if (k > n) k = n;
  int step = n / k;
  for (int j = 0; j < k; ++j)
    memcpy(centroids + (size_t)j * dim, data + (size_t)(j * step) * dim,
           dim * sizeof(float));
  for (int i = 0; i < n; ++i) assignments[i] = 0;

  int iter = 0;
  for (; iter < max_iterations; ++iter) {
    bool changed = false;
    for (int i = 0; i < n; ++i) {
      float best_d = 3.4e38f;
      int best = 0;
      for (int j = 0; j < k; ++j) {
        float d = 1.0f - cosine_sim(data + (size_t)i * dim,
                                    centroids + (size_t)j * dim, dim);
        if (d < best_d) {
          best_d = d;
          best = j;
        }
      }
      if (assignments[i] != best) {
        assignments[i] = best;
        changed = true;
      }
    }
    if (!changed) break;
    for (int j = 0; j < k; ++j) {
      float* c = centroids + (size_t)j * dim;
      int count = 0;
      std::vector<double> acc(dim, 0.0);
      for (int i = 0; i < n; ++i) {
        if (assignments[i] != j) continue;
        const float* x = data + (size_t)i * dim;
        for (int d = 0; d < dim; ++d) acc[d] += x[d];
        count++;
      }
      if (count > 0)
        for (int d = 0; d < dim; ++d) c[d] = (float)(acc[d] / count);
    }
  }
  return iter;
}

// Copies the row's id into buf (up to buf_len-1 chars). Returns id length.
FVDB_API int fvdb_index_id(void* h, int row, char* buf, int buf_len) {
  auto* ix = (InMemoryIndex*)h;
  std::lock_guard<std::mutex> lock(ix->mu);
  if (row < 0 || row >= (int)ix->ids.size()) return -1;
  const std::string& s = ix->ids[row];
  int n = std::min((int)s.size(), buf_len - 1);
  memcpy(buf, s.data(), n);
  buf[n] = 0;
  return (int)s.size();
}

FVDB_API int fvdb_index_get(void* h, const char* id, float* out_vec) {
  auto* ix = (InMemoryIndex*)h;
  std::lock_guard<std::mutex> lock(ix->mu);
  auto it = ix->id_to_row.find(id);
  if (it == ix->id_to_row.end()) return 1;
  memcpy(out_vec, &ix->data[(size_t)it->second * ix->dim],
         ix->dim * sizeof(float));
  return 0;
}
