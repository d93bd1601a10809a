// Sharded sparse embedding table — the parameter-server storage engine.
// Native equivalent of the reference's MemorySparseTable
// (paddle/fluid/distributed/ps/table/memory_sparse_table.cc): a striped
// hash table of feature-id -> embedding row (+ optimizer slots), with the
// sparse update rules (paddle/fluid/distributed/ps/table/sparse_sgd_rule.cc)
// applied server-side on push. Rows are created on first pull with uniform
// init, like the reference's accessor Init.
//
// Threading: N_SHARD stripes, each its own mutex + open hash map, so
// concurrent pulls/pushes from DataLoader workers and the async
// communicator scale (the reference shards by feasign % shard_num the same
// way).
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int N_SHARD = 32;

enum Rule { SGD = 0, ADAGRAD = 1, ADAM = 2 };

struct Shard {
  std::mutex mu;
  std::unordered_map<int64_t, size_t> index;  // key -> row offset
  std::vector<float> rows;                    // row_width per entry
  std::vector<int64_t> slot_keys;             // key at rows offset i*row_width
};

struct Table {
  int dim = 0;
  int slot = 0;     // extra floats per row for optimizer state
  Rule rule = SGD;
  float lr = 0.05f;
  float init_range = 0.01f;
  float beta1 = 0.9f, beta2 = 0.999f, eps = 1e-8f;
  uint64_t seed = 0;
  Shard shards[N_SHARD];

  int row_width() const { return dim + slot; }

  Shard& shard_of(int64_t key) {
    return shards[(uint64_t)key % N_SHARD];
  }

  // caller holds the shard lock
  float* row(Shard& s, int64_t key, bool create) {
    auto it = s.index.find(key);
    if (it != s.index.end()) return s.rows.data() + it->second;
    if (!create) return nullptr;
    size_t off = s.rows.size();
    s.rows.resize(off + row_width());
    // deterministic per-key init (reference: accessor's uniform initializer;
    // determinism means every worker pulling a fresh key agrees)
    std::mt19937_64 gen(seed ^ (uint64_t)key);
    std::uniform_real_distribution<float> u(-init_range, init_range);
    float* r = s.rows.data() + off;
    for (int i = 0; i < dim; i++) r[i] = u(gen);
    for (int i = dim; i < row_width(); i++) r[i] = 0.f;
    s.index.emplace(key, off);
    s.slot_keys.push_back(key);
    return r;
  }
};

}  // namespace

extern "C" {

void* ptn_pstable_create(int dim, const char* rule, float lr,
                         float init_range, uint64_t seed) {
  auto* t = new Table();
  t->dim = dim;
  t->lr = lr;
  t->init_range = init_range;
  t->seed = seed;
  if (strcmp(rule, "adagrad") == 0) {
    t->rule = ADAGRAD;
    t->slot = dim;                // per-dim g2 accumulator
  } else if (strcmp(rule, "adam") == 0) {
    t->rule = ADAM;
    t->slot = 2 * dim + 1;        // m, v, step
  } else {
    t->rule = SGD;
    t->slot = 0;
  }
  return t;
}

void ptn_pstable_pull(void* tp, const int64_t* keys, int64_t n, float* out) {
  auto* t = (Table*)tp;
  for (int64_t i = 0; i < n; i++) {
    Shard& s = t->shard_of(keys[i]);
    std::lock_guard<std::mutex> g(s.mu);
    const float* r = t->row(s, keys[i], true);
    memcpy(out + i * t->dim, r, t->dim * sizeof(float));
  }
}

void ptn_pstable_push(void* tp, const int64_t* keys, int64_t n,
                      const float* grads) {
  auto* t = (Table*)tp;
  const int D = t->dim;
  for (int64_t i = 0; i < n; i++) {
    Shard& s = t->shard_of(keys[i]);
    std::lock_guard<std::mutex> g(s.mu);
    float* r = t->row(s, keys[i], true);
    const float* gr = grads + i * D;
    switch (t->rule) {
      case SGD:
        for (int d = 0; d < D; d++) r[d] -= t->lr * gr[d];
        break;
      case ADAGRAD: {
        float* g2 = r + D;
        for (int d = 0; d < D; d++) {
          g2[d] += gr[d] * gr[d];
          r[d] -= t->lr * gr[d] / (std::sqrt(g2[d]) + t->eps);
        }
        break;
      }
      case ADAM: {
        float* m = r + D;
        float* v = r + 2 * D;
        float& step = r[3 * D];
        step += 1.f;
        float bc1 = 1.f - std::pow(t->beta1, step);
        float bc2 = 1.f - std::pow(t->beta2, step);
        for (int d = 0; d < D; d++) {
          m[d] = t->beta1 * m[d] + (1 - t->beta1) * gr[d];
          v[d] = t->beta2 * v[d] + (1 - t->beta2) * gr[d] * gr[d];
          r[d] -= t->lr * (m[d] / bc1) / (std::sqrt(v[d] / bc2) + t->eps);
        }
        break;
      }
    }
  }
}

// Pull rows AND optimizer-state slots (for the device-resident cache,
// reference: ps_gpu_wrapper.cc BuildPull copies values+slots to GPU).
// out: (n, dim); state: (n, slot) — untouched when slot == 0.
void ptn_pstable_pull_state(void* tp, const int64_t* keys, int64_t n,
                            float* out, float* state) {
  auto* t = (Table*)tp;
  for (int64_t i = 0; i < n; i++) {
    Shard& s = t->shard_of(keys[i]);
    std::lock_guard<std::mutex> g(s.mu);
    const float* r = t->row(s, keys[i], true);
    memcpy(out + i * t->dim, r, t->dim * sizeof(float));
    if (t->slot > 0)
      memcpy(state + i * t->slot, r + t->dim, t->slot * sizeof(float));
  }
}

// Assign row values (and optionally optimizer state) directly — the
// end-of-pass flush of device-updated rows (reference: ps_gpu_wrapper.cc
// EndPass copying GPU values back into the table).
void ptn_pstable_assign(void* tp, const int64_t* keys, int64_t n,
                        const float* vals, const float* state) {
  auto* t = (Table*)tp;
  for (int64_t i = 0; i < n; i++) {
    Shard& s = t->shard_of(keys[i]);
    std::lock_guard<std::mutex> g(s.mu);
    float* r = t->row(s, keys[i], true);
    memcpy(r, vals + i * t->dim, t->dim * sizeof(float));
    if (state != nullptr && t->slot > 0)
      memcpy(r + t->dim, state + i * t->slot, t->slot * sizeof(float));
  }
}

// Remove rows (for the SSD tier's LRU hot-cache eviction: spilled rows
// leave the in-memory table so hot capacity is a real bound). Swap-remove:
// the last row fills the hole, O(1) per key via the slot_keys back-map.
void ptn_pstable_erase(void* tp, const int64_t* keys, int64_t n) {
  auto* t = (Table*)tp;
  const int w = t->row_width();
  for (int64_t i = 0; i < n; i++) {
    Shard& s = t->shard_of(keys[i]);
    std::lock_guard<std::mutex> g(s.mu);
    auto it = s.index.find(keys[i]);
    if (it == s.index.end()) continue;
    size_t off = it->second;
    size_t last = s.rows.size() - w;
    if (off != last) {
      memcpy(s.rows.data() + off, s.rows.data() + last, w * sizeof(float));
      int64_t moved = s.slot_keys.back();
      s.slot_keys[off / w] = moved;
      s.index[moved] = off;
    }
    s.rows.resize(last);
    s.slot_keys.pop_back();
    s.index.erase(it);
  }
}

int64_t ptn_pstable_size(void* tp) {
  auto* t = (Table*)tp;
  int64_t n = 0;
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> g(s.mu);
    n += (int64_t)s.index.size();
  }
  return n;
}

// binary format: u64 magic | i32 dim | i32 slot | u64 count | (key, row)*
int ptn_pstable_save(void* tp, const char* path) {
  auto* t = (Table*)tp;
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint64_t magic = 0x7073746162ull;
  int64_t count = ptn_pstable_size(tp);
  int32_t dim = t->dim, slot = t->slot;
  fwrite(&magic, 8, 1, f);
  fwrite(&dim, 4, 1, f);
  fwrite(&slot, 4, 1, f);
  fwrite(&count, 8, 1, f);
  int w = t->row_width();
  for (auto& s : t->shards) {
    std::lock_guard<std::mutex> g(s.mu);
    for (auto& kv : s.index) {
      fwrite(&kv.first, 8, 1, f);
      fwrite(s.rows.data() + kv.second, sizeof(float), w, f);
    }
  }
  fclose(f);
  return 0;
}

int ptn_pstable_load(void* tp, const char* path) {
  auto* t = (Table*)tp;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint64_t magic = 0;
  int32_t dim = 0, slot = 0;
  int64_t count = 0;
  if (fread(&magic, 8, 1, f) != 1 || magic != 0x7073746162ull ||
      fread(&dim, 4, 1, f) != 1 || fread(&slot, 4, 1, f) != 1 ||
      fread(&count, 8, 1, f) != 1 || dim != t->dim || slot != t->slot) {
    fclose(f);
    return -2;
  }
  int w = t->row_width();
  std::vector<float> buf(w);
  for (int64_t i = 0; i < count; i++) {
    int64_t key;
    if (fread(&key, 8, 1, f) != 1 ||
        fread(buf.data(), sizeof(float), w, f) != (size_t)w) {
      fclose(f);
      return -3;
    }
    Shard& s = t->shard_of(key);
    std::lock_guard<std::mutex> g(s.mu);
    float* r = t->row(s, key, true);
    memcpy(r, buf.data(), w * sizeof(float));
  }
  fclose(f);
  return 0;
}

void ptn_pstable_destroy(void* tp) { delete (Table*)tp; }

}  // extern "C"
