// Auto-growth best-fit host arena allocator.
// Native equivalent of the reference's default GPU allocator strategy
// (paddle/fluid/memory/allocation/auto_growth_best_fit_allocator.cc): a
// free-list keyed by size over mmap'd chunks, with split-on-alloc and
// neighbor coalescing on free. On TPU the device side is owned by
// PjRt/XLA; this arena serves the HOST staging path (DataLoader batch
// assembly, checkpoint IO buffers) where malloc churn on multi-MB blocks
// costs real throughput.
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <sys/mman.h>

namespace {

constexpr uint64_t ALIGN = 64;

struct Block {
  uint64_t size;
  bool free;
  uint64_t chunk_id;  // blocks coalesce only within their chunk
};

struct Arena {
  std::mutex mu;
  uint64_t chunk_bytes;
  uint64_t next_chunk = 0;
  std::map<uint8_t*, Block> blocks;                 // by address
  std::multimap<uint64_t, uint8_t*> free_by_size;   // size -> address
  std::map<uint8_t*, uint64_t> chunks;              // base -> size
  uint64_t allocated = 0;   // bytes handed out
  uint64_t reserved = 0;    // bytes mmap'd
  uint64_t peak = 0;

  void erase_free_entry(uint8_t* p, uint64_t size) {
    auto range = free_by_size.equal_range(size);
    for (auto it = range.first; it != range.second; ++it) {
      if (it->second == p) {
        free_by_size.erase(it);
        return;
      }
    }
  }
};

uint64_t align_up(uint64_t n, uint64_t a) { return (n + a - 1) & ~(a - 1); }

}  // namespace

extern "C" {

void* ptn_arena_create(uint64_t chunk_bytes) {
  auto* a = new Arena();
  a->chunk_bytes = chunk_bytes ? chunk_bytes : (64ull << 20);
  return a;
}

void* ptn_arena_alloc(void* ap, uint64_t size) {
  auto* a = (Arena*)ap;
  size = align_up(size ? size : 1, ALIGN);
  std::lock_guard<std::mutex> g(a->mu);

  auto it = a->free_by_size.lower_bound(size);  // best fit
  if (it == a->free_by_size.end()) {
    // round-up division: chunk_bytes need not be a power of two
    uint64_t chunk = ((size + a->chunk_bytes - 1) / a->chunk_bytes)
                     * a->chunk_bytes;
    void* mem = mmap(nullptr, chunk, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (mem == MAP_FAILED) return nullptr;
    auto* base = (uint8_t*)mem;
    a->chunks[base] = chunk;
    a->reserved += chunk;
    a->blocks[base] = {chunk, true, a->next_chunk++};
    a->free_by_size.emplace(chunk, base);
    it = a->free_by_size.lower_bound(size);
  }

  uint8_t* p = it->second;
  Block& b = a->blocks[p];
  a->free_by_size.erase(it);
  if (b.size >= size + ALIGN) {  // split the tail back onto the free list
    uint64_t rest = b.size - size;
    a->blocks[p + size] = {rest, true, b.chunk_id};
    a->free_by_size.emplace(rest, p + size);
    b.size = size;
  }
  b.free = false;
  a->allocated += b.size;
  if (a->allocated > a->peak) a->peak = a->allocated;
  return p;
}

int ptn_arena_free(void* ap, void* ptr) {
  auto* a = (Arena*)ap;
  std::lock_guard<std::mutex> g(a->mu);
  auto it = a->blocks.find((uint8_t*)ptr);
  if (it == a->blocks.end() || it->second.free) return -1;
  it->second.free = true;
  a->allocated -= it->second.size;

  // coalesce with next
  auto next = std::next(it);
  if (next != a->blocks.end() && next->second.free &&
      next->second.chunk_id == it->second.chunk_id &&
      it->first + it->second.size == next->first) {
    a->erase_free_entry(next->first, next->second.size);
    it->second.size += next->second.size;
    a->blocks.erase(next);
  }
  // coalesce with prev
  if (it != a->blocks.begin()) {
    auto prev = std::prev(it);
    if (prev->second.free && prev->second.chunk_id == it->second.chunk_id &&
        prev->first + prev->second.size == it->first) {
      a->erase_free_entry(prev->first, prev->second.size);
      prev->second.size += it->second.size;
      a->blocks.erase(it);
      it = prev;
    }
  }
  a->free_by_size.emplace(it->second.size, it->first);
  return 0;
}

void ptn_arena_stats(void* ap, uint64_t* allocated, uint64_t* reserved,
                     uint64_t* peak) {
  auto* a = (Arena*)ap;
  std::lock_guard<std::mutex> g(a->mu);
  *allocated = a->allocated;
  *reserved = a->reserved;
  *peak = a->peak;
}

void ptn_arena_destroy(void* ap) {
  auto* a = (Arena*)ap;
  for (auto& [base, size] : a->chunks) munmap(base, size);
  delete a;
}

}  // extern "C"
