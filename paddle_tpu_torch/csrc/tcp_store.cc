// TCP store: the rendezvous key-value server and its client (C ABI,
// loaded with ctypes). Rank 0 of a job hosts the server; every rank
// (rank 0 too) is a client.
//
// The port's own copy of the store part of the JAX package's native core
// (paddle_tpu/core/native/ptcore.cc, section 2: StoreServer, serve_client,
// pt_store_*), byte for byte on the wire, so that a client of either
// package works against a server of the other. Host code: no device, no
// kernel.
//
// Build (paddle_tpu_torch/core/__init__.py does it at first use):
//   g++ -std=c++17 -O2 -shared -fPIC -pthread tcp_store.cc -o libtcp_store.so
//
// Wire protocol (little endian):
//   request:  u8 op | u32 klen | key | u32 vlen | value
//     op: 0=SET 1=GET 2=ADD(value = i64 delta) 3=WAIT 4=DELETE 5=CHECK
//   response: u32 vlen | value            (GET/ADD; ADD returns i64)
//             u8 status                   (SET/WAIT/DELETE/CHECK)
// GET and WAIT block server-side until the key exists.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <climits>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

namespace {

struct StoreServer {
  int listen_fd = -1;
  std::thread accept_thread;
  std::vector<std::thread> workers;
  std::vector<int> client_fds;   // guarded by mu; for shutdown wakeup
  std::map<std::string, std::string> kv;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};
};

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n) {
    ssize_t r = recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t r = send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

void serve_client(StoreServer* s, int fd) {
  for (;;) {
    uint8_t op;
    uint32_t klen, vlen;
    if (!read_full(fd, &op, 1) || !read_full(fd, &klen, 4)) break;
    if (klen > (1u << 20)) break;
    std::string key(klen, '\0');
    if (!read_full(fd, key.data(), klen) || !read_full(fd, &vlen, 4)) break;
    if (vlen > (1u << 28)) break;
    std::string val(vlen, '\0');
    if (vlen && !read_full(fd, val.data(), vlen)) break;

    if (op == 0) {  // SET
      {
        std::lock_guard<std::mutex> lk(s->mu);
        s->kv[key] = val;
      }
      s->cv.notify_all();
      uint8_t ok = 0;
      if (!write_full(fd, &ok, 1)) break;
    } else if (op == 1 || op == 3) {  // GET / WAIT
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv.wait(lk, [&] {
        return s->stop.load() || s->kv.count(key) > 0;
      });
      if (s->stop.load()) break;
      if (op == 1) {
        std::string v = s->kv[key];
        lk.unlock();
        uint32_t n = static_cast<uint32_t>(v.size());
        if (!write_full(fd, &n, 4) || !write_full(fd, v.data(), n)) break;
      } else {
        lk.unlock();
        uint8_t ok = 0;
        if (!write_full(fd, &ok, 1)) break;
      }
    } else if (op == 2) {  // ADD
      int64_t delta = 0;
      memcpy(&delta, val.data(), std::min<size_t>(8, val.size()));
      int64_t result;
      {
        std::lock_guard<std::mutex> lk(s->mu);
        int64_t cur = 0;
        auto it = s->kv.find(key);
        if (it != s->kv.end() && it->second.size() == 8)
          memcpy(&cur, it->second.data(), 8);
        result = cur + delta;
        std::string enc(8, '\0');
        memcpy(enc.data(), &result, 8);
        s->kv[key] = enc;
      }
      s->cv.notify_all();
      uint32_t n = 8;
      if (!write_full(fd, &n, 4) || !write_full(fd, &result, 8)) break;
    } else if (op == 4) {  // DELETE
      {
        std::lock_guard<std::mutex> lk(s->mu);
        s->kv.erase(key);
      }
      uint8_t ok = 0;
      if (!write_full(fd, &ok, 1)) break;
    } else if (op == 5) {  // CHECK (non-blocking existence)
      uint8_t exists;
      {
        std::lock_guard<std::mutex> lk(s->mu);
        exists = s->kv.count(key) ? 1 : 0;
      }
      if (!write_full(fd, &exists, 1)) break;
    } else {
      break;
    }
  }
  {
    // deregister before closing so stop() never shutdown()s a reused fd
    std::lock_guard<std::mutex> lk(s->mu);
    auto it = std::find(s->client_fds.begin(), s->client_fds.end(), fd);
    if (it != s->client_fds.end()) s->client_fds.erase(it);
  }
  close(fd);
}

}  // namespace

void* pt_store_server_start(int port) {
  auto* s = new StoreServer();
  s->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) <
          0 ||
      listen(s->listen_fd, 128) < 0) {
    close(s->listen_fd);
    delete s;
    return nullptr;
  }
  s->accept_thread = std::thread([s] {
    for (;;) {
      int fd = accept(s->listen_fd, nullptr, nullptr);
      if (fd < 0) break;  // listen_fd closed => shutdown
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> lk(s->mu);
      if (s->stop.load()) {
        close(fd);
        break;
      }
      s->client_fds.push_back(fd);
      s->workers.emplace_back(serve_client, s, fd);
    }
  });
  return s;
}

// Bound port (for port=0 auto-assign).
int pt_store_server_port(void* handle) {
  auto* s = static_cast<StoreServer*>(handle);
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &len) <
      0)
    return -1;
  return ntohs(addr.sin_port);
}

void pt_store_server_stop(void* handle) {
  auto* s = static_cast<StoreServer*>(handle);
  s->stop.store(true);
  s->cv.notify_all();
  shutdown(s->listen_fd, SHUT_RDWR);
  close(s->listen_fd);
  if (s->accept_thread.joinable()) s->accept_thread.join();
  {
    // wake workers blocked in recv() on live client sockets
    std::lock_guard<std::mutex> lk(s->mu);
    for (int fd : s->client_fds) shutdown(fd, SHUT_RDWR);
  }
  for (auto& w : s->workers)
    if (w.joinable()) w.join();  // must all exit before s is freed
  delete s;
}

struct StoreClient {
  int fd = -1;
  std::mutex mu;
};

void* pt_store_client_connect(const char* host, int port, int timeout_ms) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return nullptr;
  }
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    close(fd);
    if (std::chrono::steady_clock::now() > deadline) return nullptr;
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
    fd = socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new StoreClient();
  c->fd = fd;
  return c;
}

namespace {
bool send_req(StoreClient* c, uint8_t op, const char* key, const void* val,
              uint32_t vlen) {
  uint32_t klen = static_cast<uint32_t>(strlen(key));
  return write_full(c->fd, &op, 1) && write_full(c->fd, &klen, 4) &&
         write_full(c->fd, key, klen) && write_full(c->fd, &vlen, 4) &&
         (vlen == 0 || write_full(c->fd, val, vlen));
}
}  // namespace

int pt_store_set(void* handle, const char* key, const void* val, int len) {
  auto* c = static_cast<StoreClient*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  if (!send_req(c, 0, key, val, static_cast<uint32_t>(len))) return -1;
  uint8_t ok;
  return read_full(c->fd, &ok, 1) ? 0 : -1;
}

// Returns value length (may exceed buf_len: caller re-calls with bigger
// buffer — value re-fetched), or -1 on error.
int pt_store_get(void* handle, const char* key, void* buf, int buf_len) {
  auto* c = static_cast<StoreClient*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  if (!send_req(c, 1, key, nullptr, 0)) return -1;
  uint32_t n;
  if (!read_full(c->fd, &n, 4)) return -1;
  std::string v(n, '\0');
  if (n && !read_full(c->fd, v.data(), n)) return -1;
  if (static_cast<int>(n) <= buf_len && buf) memcpy(buf, v.data(), n);
  return static_cast<int>(n);
}

int64_t pt_store_add(void* handle, const char* key, int64_t delta) {
  auto* c = static_cast<StoreClient*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  if (!send_req(c, 2, key, &delta, 8)) return INT64_MIN;
  uint32_t n;
  int64_t result;
  if (!read_full(c->fd, &n, 4) || n != 8 || !read_full(c->fd, &result, 8))
    return INT64_MIN;
  return result;
}

int pt_store_wait(void* handle, const char* key) {
  auto* c = static_cast<StoreClient*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  if (!send_req(c, 3, key, nullptr, 0)) return -1;
  uint8_t ok;
  return read_full(c->fd, &ok, 1) ? 0 : -1;
}

int pt_store_delete(void* handle, const char* key) {
  auto* c = static_cast<StoreClient*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  if (!send_req(c, 4, key, nullptr, 0)) return -1;
  uint8_t ok;
  return read_full(c->fd, &ok, 1) ? 0 : -1;
}

int pt_store_check(void* handle, const char* key) {
  auto* c = static_cast<StoreClient*>(handle);
  std::lock_guard<std::mutex> lk(c->mu);
  if (!send_req(c, 5, key, nullptr, 0)) return -1;
  uint8_t exists;
  return read_full(c->fd, &exists, 1) ? exists : -1;
}

void pt_store_client_close(void* handle) {
  auto* c = static_cast<StoreClient*>(handle);
  close(c->fd);
  delete c;
}

}  // extern "C"
