// Shared-memory ring buffer: variable-size record MPMC queue across
// processes. Native transport for the multi-process DataLoader — the
// TPU-native equivalent of the reference's shared-memory tensor plumbing
// (paddle/fluid/memory/allocation/mmap_allocator.cc) combined with its
// blocking queue (paddle/fluid/framework/blocking_queue.h): worker
// processes pickle batches into the ring; the trainer process drains it
// without a Python-level pipe round trip.
//
// Layout in the shm segment:
//   [RingHeader][data bytes ...]
// Records are 8-byte aligned: u64 len | payload | pad. A len of SKIP_MARK
// means "wrap to offset 0". head/tail are monotonic byte offsets.
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <pthread.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t SKIP_MARK = ~0ull;

struct RingHeader {
  uint64_t magic;
  uint64_t capacity;   // data area size in bytes
  uint64_t head;       // monotonic write offset
  uint64_t tail;       // monotonic read offset
  uint32_t closed;
  uint32_t _pad;
  pthread_mutex_t mu;
  pthread_cond_t not_full;
  pthread_cond_t not_empty;
};

constexpr uint64_t MAGIC = 0x70746e5f72696e67ull;  // "ptn_ring"

struct Ring {
  RingHeader* h;
  uint8_t* data;
  uint64_t map_len;
  std::string name;
  bool owner;
};

uint64_t align8(uint64_t n) { return (n + 7) & ~7ull; }

void abs_deadline(timespec* ts, int timeout_ms) {
  clock_gettime(CLOCK_REALTIME, ts);
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

int lock_robust(pthread_mutex_t* mu) {
  int rc = pthread_mutex_lock(mu);
  if (rc == EOWNERDEAD) {           // a worker died holding the lock
    pthread_mutex_consistent(mu);
    rc = 0;
  }
  return rc;
}

}  // namespace

extern "C" {

void* ptn_ring_create(const char* name, uint64_t capacity) {
  shm_unlink(name);  // stale segment from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t total = sizeof(RingHeader) + capacity;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* h = (RingHeader*)mem;
  memset(h, 0, sizeof(RingHeader));
  h->capacity = capacity;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&h->not_full, &ca);
  pthread_cond_init(&h->not_empty, &ca);
  h->magic = MAGIC;

  auto* r = new Ring{h, (uint8_t*)mem + sizeof(RingHeader), total, name, true};
  return r;
}

void* ptn_ring_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* h = (RingHeader*)mem;
  if (h->magic != MAGIC) {
    munmap(mem, (size_t)st.st_size);
    return nullptr;
  }
  auto* r = new Ring{h, (uint8_t*)mem + sizeof(RingHeader),
                     (uint64_t)st.st_size, name, false};
  return r;
}

// 0 ok, -1 timeout, -2 closed, -3 too large, -4 wait/lock failure
int ptn_ring_put(void* rp, const void* buf, uint64_t len, int timeout_ms) {
  auto* r = (Ring*)rp;
  RingHeader* h = r->h;
  uint64_t need = 8 + align8(len);
  if (need > h->capacity) return -3;

  timespec ts;
  if (timeout_ms >= 0) abs_deadline(&ts, timeout_ms);
  if (lock_robust(&h->mu) != 0) return -4;
  for (;;) {
    if (h->closed) {
      pthread_mutex_unlock(&h->mu);
      return -2;
    }
    // empty ring: rewind offsets so a wrap never straddles the boundary
    // with no reader able to free space behind it (deadlock otherwise when
    // to_end + need > capacity)
    if (h->head == h->tail && h->head % h->capacity != 0) {
      h->head = h->tail = 0;
    }
    uint64_t used = h->head - h->tail;
    uint64_t off = h->head % h->capacity;
    uint64_t to_end = h->capacity - off;
    // if the record would wrap, a skip marker consumes `to_end` bytes
    uint64_t eff = (to_end >= need) ? need : to_end + need;
    if (h->capacity - used >= eff) {
      if (to_end < need) {
        if (to_end >= 8) memcpy(r->data + off, &SKIP_MARK, 8);
        h->head += to_end;
        off = 0;
      }
      memcpy(r->data + off, &len, 8);
      memcpy(r->data + off + 8, buf, len);
      h->head += need;
      pthread_cond_signal(&h->not_empty);
      pthread_mutex_unlock(&h->mu);
      return 0;
    }
    int rc = (timeout_ms < 0)
                 ? pthread_cond_wait(&h->not_full, &h->mu)
                 : pthread_cond_timedwait(&h->not_full, &h->mu, &ts);
    if (rc == EOWNERDEAD) {
      // a peer died holding the lock while we were waiting: the implicit
      // re-lock inside cond_wait reported it — recover the mutex or every
      // later lock fails ENOTRECOVERABLE
      pthread_mutex_consistent(&h->mu);
    } else if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    } else if (rc != 0) {
      pthread_mutex_unlock(&h->mu);
      return -4;  // wait machinery failed — distinct from -3 (too large)
    }
  }
}

// 0 ok (malloc'd copy in *out, free with ptn_buf_free), -1 timeout,
// -2 closed-and-drained, -4 wait failure
int ptn_ring_get(void* rp, void** out, uint64_t* out_len, int timeout_ms) {
  auto* r = (Ring*)rp;
  RingHeader* h = r->h;
  timespec ts;
  if (timeout_ms >= 0) abs_deadline(&ts, timeout_ms);
  if (lock_robust(&h->mu) != 0) return -4;
  for (;;) {
    while (h->head != h->tail) {
      uint64_t off = h->tail % h->capacity;
      uint64_t len;
      // wrap marker can be implicit (less than 8 bytes left) or explicit
      if (h->capacity - off < 8) {
        h->tail += h->capacity - off;
        continue;
      }
      memcpy(&len, r->data + off, 8);
      if (len == SKIP_MARK) {
        h->tail += h->capacity - off;
        continue;
      }
      void* copy = malloc(len ? len : 1);
      memcpy(copy, r->data + off + 8, len);
      h->tail += 8 + align8(len);
      pthread_cond_signal(&h->not_full);
      pthread_mutex_unlock(&h->mu);
      *out = copy;
      *out_len = len;
      return 0;
    }
    if (h->closed) {
      pthread_mutex_unlock(&h->mu);
      return -2;
    }
    int rc = (timeout_ms < 0)
                 ? pthread_cond_wait(&h->not_empty, &h->mu)
                 : pthread_cond_timedwait(&h->not_empty, &h->mu, &ts);
    if (rc == EOWNERDEAD) {
      pthread_mutex_consistent(&h->mu);
    } else if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    } else if (rc != 0) {
      pthread_mutex_unlock(&h->mu);
      return -4;
    }
  }
}

void ptn_ring_close(void* rp) {
  auto* r = (Ring*)rp;
  if (lock_robust(&r->h->mu) == 0) {
    r->h->closed = 1;
    pthread_cond_broadcast(&r->h->not_empty);
    pthread_cond_broadcast(&r->h->not_full);
    pthread_mutex_unlock(&r->h->mu);
  }
}

void ptn_ring_release(void* rp) {
  auto* r = (Ring*)rp;
  bool owner = r->owner;
  std::string name = r->name;
  munmap((void*)((uint8_t*)r->h), r->map_len);
  if (owner) shm_unlink(name.c_str());
  delete r;
}

void ptn_buf_free(void* p) { free(p); }

}  // extern "C"
