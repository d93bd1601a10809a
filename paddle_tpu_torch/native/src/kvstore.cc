// TCP key-value coordination store: the multi-host rendezvous service.
// Native equivalent of the reference's TCPStore
// (paddle/fluid/distributed/store/tcp_store.cc, tcp_utils.cc): the rank-0
// process runs the server; every rank connects a client and uses
// set/get/wait/add to bootstrap process groups (the role ncclUniqueId
// broadcast + barrier play in the reference's init).
//
// Protocol (length-prefixed, little-endian):
//   request:  u8 cmd | u32 klen | key | u64 vlen | value
//   response: u8 ok  | u64 vlen | value     (ok: 1=found 0=miss/err 2=timeout)
// Commands: 1=SET 2=GET(nonblock) 3=WAIT(get, block until set; optional i64
//           timeout_ms payload) 4=ADD(i64) 5=DELETE
#include <arpa/inet.h>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// the port is reachable by anything on the network: cap lengths so a stray
// scanner's garbage can't drive a huge allocation (uncaught bad_alloc in a
// worker thread would terminate the whole trainer)
constexpr uint32_t kMaxKeyLen = 1u << 16;
constexpr uint64_t kMaxValLen = 1ull << 30;

bool read_full(int fd, void* buf, size_t n) {
  auto* p = (uint8_t*)buf;
  while (n) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  auto* p = (const uint8_t*)buf;
  while (n) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::map<std::string, std::string> kv;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  std::vector<int> client_fds;
  std::thread acceptor;
  bool stopping = false;

  void handle(int fd, size_t slot) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    for (;;) {
      uint8_t cmd;
      uint32_t klen;
      uint64_t vlen;
      if (!read_full(fd, &cmd, 1) || !read_full(fd, &klen, 4)) break;
      if (klen > kMaxKeyLen) break;  // malformed/hostile: drop connection
      std::string key(klen, '\0');
      if (klen && !read_full(fd, &key[0], klen)) break;
      if (!read_full(fd, &vlen, 8)) break;
      if (vlen > kMaxValLen) break;
      std::string val(vlen, '\0');
      if (vlen && !read_full(fd, &val[0], vlen)) break;

      uint8_t ok = 1;
      std::string out;
      switch (cmd) {
        case 1: {  // SET
          std::lock_guard<std::mutex> g(mu);
          kv[key] = val;
          cv.notify_all();
          break;
        }
        case 2: {  // GET
          std::lock_guard<std::mutex> g(mu);
          auto it = kv.find(key);
          if (it == kv.end()) ok = 0;
          else out = it->second;
          break;
        }
        case 3: {  // WAIT (blocking get, optional i64 timeout_ms payload)
          int64_t tmo = -1;
          if (val.size() == 8) memcpy(&tmo, val.data(), 8);
          std::unique_lock<std::mutex> g(mu);
          auto pred = [&] { return stopping || kv.count(key); };
          bool signalled = true;
          if (tmo < 0) cv.wait(g, pred);
          else signalled = cv.wait_for(g, std::chrono::milliseconds(tmo), pred);
          if (!signalled) ok = 2;           // timeout
          else if (!kv.count(key)) ok = 0;  // stopping
          else out = kv[key];
          break;
        }
        case 4: {  // ADD
          int64_t delta = 0;
          if (val.size() == 8) memcpy(&delta, val.data(), 8);
          std::lock_guard<std::mutex> g(mu);
          int64_t cur = 0;
          auto it = kv.find(key);
          if (it != kv.end() && it->second.size() == 8)
            memcpy(&cur, it->second.data(), 8);
          cur += delta;
          std::string v(8, '\0');
          memcpy(&v[0], &cur, 8);
          kv[key] = v;
          out = v;
          cv.notify_all();
          break;
        }
        case 5: {  // DELETE
          std::lock_guard<std::mutex> g(mu);
          kv.erase(key);
          break;
        }
        default:
          ok = 0;
      }
      uint64_t olen = out.size();
      if (!write_full(fd, &ok, 1) || !write_full(fd, &olen, 8)) break;
      if (olen && !write_full(fd, out.data(), olen)) break;
    }
    // deregister before close so stop() never shutdown()s a recycled fd
    {
      std::lock_guard<std::mutex> g(mu);
      client_fds[slot] = -1;
    }
    ::close(fd);
  }
};

struct Client {
  int fd = -1;
  std::mutex mu;  // one request in flight per client
};

}  // namespace

extern "C" {

void* ptn_store_server_start(int port) {
  auto* s = new Server();
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons((uint16_t)port);
  if (bind(s->listen_fd, (sockaddr*)&addr, sizeof(addr)) != 0 ||
      listen(s->listen_fd, 128) != 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(s->listen_fd, (sockaddr*)&addr, &alen);
  s->port = ntohs(addr.sin_port);

  s->acceptor = std::thread([s] {
    for (;;) {
      int fd = ::accept(s->listen_fd, nullptr, nullptr);
      if (fd < 0) break;  // listen_fd closed on stop
      std::lock_guard<std::mutex> g(s->mu);
      if (s->stopping) {
        ::close(fd);
        break;
      }
      s->client_fds.push_back(fd);
      size_t slot = s->client_fds.size() - 1;
      s->workers.emplace_back([s, fd, slot] { s->handle(fd, slot); });
    }
  });
  return s;
}

int ptn_store_server_port(void* sp) { return ((Server*)sp)->port; }

void ptn_store_server_stop(void* sp) {
  auto* s = (Server*)sp;
  {
    std::lock_guard<std::mutex> g(s->mu);
    s->stopping = true;
    s->cv.notify_all();
  }
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  if (s->acceptor.joinable()) s->acceptor.join();
  // acceptor is gone: workers/client_fds can no longer grow. Kick every
  // handler off its socket, then join so no thread outlives the Server.
  {
    std::lock_guard<std::mutex> g(s->mu);
    for (int fd : s->client_fds)
      if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
  }
  for (auto& t : s->workers)
    if (t.joinable()) t.join();
  delete s;
}

void* ptn_store_client_connect(const char* host, int port, int timeout_ms) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return nullptr;
  }
  // simple retry loop: the server rank may come up later
  // (timeout_ms < 0 = retry forever)
  int waited = 0;
  while (connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    ::close(fd);
    if (timeout_ms >= 0 && waited >= timeout_ms) return nullptr;
    usleep(100 * 1000);
    waited += 100;
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return nullptr;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new Client();
  c->fd = fd;
  return c;
}

// returns 0 ok / -1 not-found-or-error / -2 timeout;
// GET/WAIT/ADD fill *out (malloc'd)
static int request(Client* c, uint8_t cmd, const char* key, const void* val,
                   uint64_t vlen, void** out, uint64_t* out_len) {
  std::lock_guard<std::mutex> g(c->mu);
  uint32_t klen = (uint32_t)strlen(key);
  if (!write_full(c->fd, &cmd, 1) || !write_full(c->fd, &klen, 4) ||
      !write_full(c->fd, key, klen) || !write_full(c->fd, &vlen, 8))
    return -1;
  if (vlen && !write_full(c->fd, val, vlen)) return -1;
  uint8_t ok;
  uint64_t olen;
  if (!read_full(c->fd, &ok, 1) || !read_full(c->fd, &olen, 8)) return -1;
  if (olen > kMaxValLen) return -1;
  std::string o(olen, '\0');
  if (olen && !read_full(c->fd, &o[0], olen)) return -1;
  if (ok == 2) return -2;
  if (!ok) return -1;
  if (out) {
    *out = malloc(olen ? olen : 1);
    memcpy(*out, o.data(), olen);
    *out_len = olen;
  }
  return 0;
}

int ptn_store_set(void* cp, const char* key, const void* val, uint64_t len) {
  return request((Client*)cp, 1, key, val, len, nullptr, nullptr);
}

int ptn_store_get(void* cp, const char* key, void** out, uint64_t* len) {
  return request((Client*)cp, 2, key, nullptr, 0, out, len);
}

int ptn_store_wait(void* cp, const char* key, int64_t timeout_ms, void** out,
                   uint64_t* len) {
  if (timeout_ms < 0)
    return request((Client*)cp, 3, key, nullptr, 0, out, len);
  return request((Client*)cp, 3, key, &timeout_ms, 8, out, len);
}

int ptn_store_add(void* cp, const char* key, int64_t delta, int64_t* result) {
  void* out = nullptr;
  uint64_t olen = 0;
  int rc = request((Client*)cp, 4, key, &delta, 8, &out, &olen);
  if (rc == 0 && olen == 8) memcpy(result, out, 8);
  else rc = -1;
  free(out);
  return rc;
}

int ptn_store_delete(void* cp, const char* key) {
  return request((Client*)cp, 5, key, nullptr, 0, nullptr, nullptr);
}

void ptn_store_client_close(void* cp) {
  auto* c = (Client*)cp;
  ::close(c->fd);
  delete c;
}

}  // extern "C"
