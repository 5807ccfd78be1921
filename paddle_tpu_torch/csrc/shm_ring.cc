// Shared-memory ring queue: the DataLoader's transport from its forked
// worker processes to the parent (C ABI, loaded with ctypes).
//
// The port's own copy of the ring part of the JAX package's native core
// (paddle_tpu/core/native/ptcore.cc, section 3: ShmHeader, ShmQueue and
// pt_shmq_*), byte for byte in what it does; the tracer and the TCP store
// of that file are not part of it. Host code: no device, no kernel.
//
// Build (paddle_tpu_torch/core/__init__.py does it at first use):
//   g++ -std=c++17 -O2 -shared -fPIC -pthread shm_ring.cc -o libshm_ring.so
//
// Layout in the shm segment:
//   Header { pthread_mutex_t mu; pthread_cond_t not_full, not_empty;
//            u64 capacity, head, tail, count; }   (process-shared)
//   data[capacity]  byte ring; each message is u64 length + payload.

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <string>

extern "C" {

namespace {

struct ShmHeader {
  pthread_mutex_t mu;
  pthread_cond_t not_full;
  pthread_cond_t not_empty;
  uint64_t capacity;
  uint64_t head;   // read offset
  uint64_t tail;   // write offset
  uint64_t used;   // bytes in ring
};

struct ShmQueue {
  ShmHeader* h;
  char* data;
  size_t total;
  std::string name;
  bool owner;
};

void ring_write(ShmQueue* q, const char* src, uint64_t n) {
  uint64_t cap = q->h->capacity;
  uint64_t tail = q->h->tail;
  uint64_t first = std::min(n, cap - tail);
  memcpy(q->data + tail, src, first);
  if (n > first) memcpy(q->data, src + first, n - first);
  q->h->tail = (tail + n) % cap;
  q->h->used += n;
}

void ring_read(ShmQueue* q, char* dst, uint64_t n) {
  uint64_t cap = q->h->capacity;
  uint64_t head = q->h->head;
  uint64_t first = std::min(n, cap - head);
  memcpy(dst, q->data + head, first);
  if (n > first) memcpy(dst + first, q->data, n - first);
  q->h->head = (head + n) % cap;
  q->h->used -= n;
}

int wait_ms(pthread_cond_t* cv, pthread_mutex_t* mu, int timeout_ms) {
  if (timeout_ms < 0) return pthread_cond_wait(cv, mu);
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  ts.tv_sec += timeout_ms / 1000;
  ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts.tv_nsec >= 1000000000L) {
    ts.tv_sec += 1;
    ts.tv_nsec -= 1000000000L;
  }
  return pthread_cond_timedwait(cv, mu, &ts);
}

}  // namespace

void* pt_shmq_create(const char* name, uint64_t capacity) {
  size_t total = sizeof(ShmHeader) + capacity;
  shm_unlink(name);  // stale segment from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd,
                   0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* h = static_cast<ShmHeader*>(mem);
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
  h->capacity = capacity;
  h->head = h->tail = h->used = 0;
  auto* q = new ShmQueue{h, static_cast<char*>(mem) + sizeof(ShmHeader),
                         total, name, true};
  return q;
}

void* pt_shmq_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, static_cast<size_t>(st.st_size),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* h = static_cast<ShmHeader*>(mem);
  auto* q = new ShmQueue{h, static_cast<char*>(mem) + sizeof(ShmHeader),
                         static_cast<size_t>(st.st_size), name, false};
  return q;
}

namespace {
int lock_robust(pthread_mutex_t* mu) {
  int rc = pthread_mutex_lock(mu);
  if (rc == EOWNERDEAD) {  // a worker died holding the lock
    pthread_mutex_consistent(mu);
    rc = 0;
  }
  return rc;
}
}  // namespace

// Push one message. Returns 0 ok, -1 timeout/error, -2 message too big.
int pt_shmq_push(void* handle, const void* buf, uint64_t len,
                 int timeout_ms) {
  auto* q = static_cast<ShmQueue*>(handle);
  uint64_t need = len + 8;
  if (need > q->h->capacity) return -2;
  if (lock_robust(&q->h->mu) != 0) return -1;
  while (q->h->capacity - q->h->used < need) {
    if (wait_ms(&q->h->not_full, &q->h->mu, timeout_ms) != 0) {
      pthread_mutex_unlock(&q->h->mu);
      return -1;
    }
  }
  ring_write(q, reinterpret_cast<const char*>(&len), 8);
  ring_write(q, static_cast<const char*>(buf), len);
  pthread_cond_signal(&q->h->not_empty);
  pthread_mutex_unlock(&q->h->mu);
  return 0;
}

// Pop one message into buf. Returns message length; if it exceeds
// buf_len the message is dropped and -2 returned; -1 on timeout.
int64_t pt_shmq_pop(void* handle, void* buf, uint64_t buf_len,
                    int timeout_ms) {
  auto* q = static_cast<ShmQueue*>(handle);
  if (lock_robust(&q->h->mu) != 0) return -1;
  while (q->h->used < 8) {
    if (wait_ms(&q->h->not_empty, &q->h->mu, timeout_ms) != 0) {
      pthread_mutex_unlock(&q->h->mu);
      return -1;
    }
  }
  uint64_t len;
  ring_read(q, reinterpret_cast<char*>(&len), 8);
  int64_t result;
  if (len > buf_len) {
    // drain and drop
    uint64_t remaining = len;
    char scratch[4096];
    while (remaining) {
      uint64_t chunk = std::min<uint64_t>(remaining, sizeof(scratch));
      ring_read(q, scratch, chunk);
      remaining -= chunk;
    }
    result = -2;
  } else {
    ring_read(q, static_cast<char*>(buf), len);
    result = static_cast<int64_t>(len);
  }
  pthread_cond_signal(&q->h->not_full);
  pthread_mutex_unlock(&q->h->mu);
  return result;
}

uint64_t pt_shmq_size(void* handle) {
  auto* q = static_cast<ShmQueue*>(handle);
  return q->h->used;
}

void pt_shmq_close(void* handle) {
  auto* q = static_cast<ShmQueue*>(handle);
  bool owner = q->owner;
  std::string name = q->name;
  munmap(q->h, q->total);
  if (owner) shm_unlink(name.c_str());
  delete q;
}

}  // extern "C"
