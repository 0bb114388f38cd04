// TCPStore: rendezvous key-value store for multi-host startup.
//
// Reference: paddle/phi/core/distributed/store/tcp_store.h + tcp_utils.cc —
// the master rank runs a socket server; every rank (master included)
// connects as a client; SET/GET/ADD/WAIT requests rendezvous process groups
// (created in python/paddle/distributed/parallel.py:1134).
//
// Role: the launch and elastic layers need a tiny rendezvous KV (who is
// alive, barrier at init, exchanging coordinator addresses). Design is a
// fresh single-reactor implementation: one acceptor + poll loop thread on
// the master, blocking request/response clients, length-prefixed frames.
//
// Wire format: [u8 op][u32 klen][key][u64 vlen][value]
//   ops: 0=SET 1=GET 2=ADD 3=WAIT(key exists) 4=PING
//        5=BARRIER_ENTER(value=u64 world_size,u64 rank; payload=u64 round)
//        6=BARRIER_CHECK(value=u64 round; status 0 when that round completed)
// Response: [i64 status/len][payload]   (status<0 = not found/timeout)
//
// Barriers are tracked server-side per prefix as (round, member-rank set,
// last_completed): entering assigns the server's current round, so a rank
// that restarts (elastic) simply joins the live round — no client-local
// generation state to desynchronize. Membership is a rank SET, not a
// counter, so a rank retrying after a timeout re-enters idempotently
// instead of double-counting and completing the round alone.
#include "export.h"

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstring>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace pt {
void set_error(const std::string& msg);
}

namespace {

using Clock = std::chrono::steady_clock;

enum Op : uint8_t { OP_SET = 0, OP_GET = 1, OP_ADD = 2, OP_WAIT = 3,
                    OP_PING = 4, OP_BARRIER_ENTER = 5, OP_BARRIER_CHECK = 6 };

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= w;
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= r;
  }
  return true;
}

// ---------------- master-side server ----------------
class StoreServer {
 public:
  explicit StoreServer(int port) : port_(port) {}

  bool start() {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return fail("socket() failed");
    int yes = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &yes, sizeof(yes));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(port_);
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) != 0)
      return fail("bind() failed (port in use?)");
    if (::listen(listen_fd_, 128) != 0) return fail("listen() failed");
    running_ = true;
    thread_ = std::thread([this] { loop(); });
    return true;
  }

  void stop() {
    running_ = false;
    if (listen_fd_ >= 0) ::shutdown(listen_fd_, SHUT_RDWR), ::close(listen_fd_);
    if (thread_.joinable()) thread_.join();
    for (auto& c : conns_) ::close(c.fd);
  }

  ~StoreServer() { stop(); }

 private:
  bool fail(const char* msg) {
    pt::set_error(msg);
    if (listen_fd_ >= 0) ::close(listen_fd_);
    return false;
  }

  // Per-connection state: reads are non-blocking and buffered so one
  // slow/partial client can never stall the reactor (the other ranks'
  // GET/WAIT polls keep being served while a frame trickles in).
  struct Conn {
    int fd;
    std::string inbuf;
  };

  void loop() {
    while (running_) {
      std::vector<pollfd> fds;
      fds.push_back({listen_fd_, POLLIN, 0});
      for (auto& c : conns_) fds.push_back({c.fd, POLLIN, 0});
      int rc = ::poll(fds.data(), fds.size(), 200);
      if (rc <= 0) continue;
      if (fds[0].revents & POLLIN) {
        int c = ::accept(listen_fd_, nullptr, nullptr);
        if (c >= 0) {
          int yes = 1;
          ::setsockopt(c, IPPROTO_TCP, TCP_NODELAY, &yes, sizeof(yes));
          // reads use MSG_DONTWAIT (never stall the reactor); writes stay
          // blocking but bounded so a stuck reader fails after 5s instead
          // of hanging every rank
          timeval tv{5, 0};
          ::setsockopt(c, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
          conns_.push_back({c, {}});
        }
      }
      std::vector<int> dead;
      for (size_t i = 1; i < fds.size(); ++i) {
        if (!(fds[i].revents & (POLLIN | POLLHUP | POLLERR))) continue;
        if (!drain(conns_[i - 1])) dead.push_back(fds[i].fd);
      }
      for (int fd : dead) {
        ::close(fd);
        conns_.erase(std::remove_if(conns_.begin(), conns_.end(),
                                    [fd](const Conn& c) { return c.fd == fd; }),
                     conns_.end());
      }
    }
  }

  // Read whatever is available without blocking, then process every
  // complete frame in the buffer. Returns false when the peer is gone.
  bool drain(Conn& conn) {
    char chunk[65536];
    while (true) {
      ssize_t r = ::recv(conn.fd, chunk, sizeof(chunk), MSG_DONTWAIT);
      if (r > 0) {
        conn.inbuf.append(chunk, r);
        if (static_cast<size_t>(r) < sizeof(chunk)) break;
        continue;
      }
      if (r == 0) return false;  // orderly shutdown
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      return false;
    }
    while (true) {
      const std::string& b = conn.inbuf;
      if (b.size() < 5) return true;
      uint32_t klen;
      std::memcpy(&klen, b.data() + 1, 4);
      if (b.size() < size_t{5} + klen + 8) return true;
      uint64_t vlen;
      std::memcpy(&vlen, b.data() + 5 + klen, 8);
      size_t frame = size_t{5} + klen + 8 + vlen;
      if (b.size() < frame) return true;
      uint8_t op = static_cast<uint8_t>(b[0]);
      std::string key = b.substr(5, klen);
      std::string val = b.substr(5 + klen + 8, vlen);
      conn.inbuf.erase(0, frame);
      if (!respond(conn.fd, op, key, val)) return false;
    }
  }

  bool respond(int fd, uint8_t op, const std::string& key,
               const std::string& val) {
    int64_t status = 0;
    std::string payload;
    {
      std::lock_guard<std::mutex> l(mu_);
      switch (op) {
        case OP_SET:
          data_[key] = val;
          break;
        case OP_GET: {
          auto it = data_.find(key);
          if (it == data_.end()) {
            status = -1;
          } else {
            payload = it->second;
            status = static_cast<int64_t>(payload.size());
          }
          break;
        }
        case OP_ADD: {
          int64_t delta = 0;
          std::memcpy(&delta, val.data(), std::min<size_t>(8, val.size()));
          int64_t cur = 0;
          auto it = data_.find(key);
          if (it != data_.end())
            std::memcpy(&cur, it->second.data(),
                        std::min<size_t>(8, it->second.size()));
          cur += delta;
          std::string enc(8, '\0');
          std::memcpy(enc.data(), &cur, 8);
          data_[key] = enc;
          payload = enc;
          status = 8;
          break;
        }
        case OP_WAIT:
          status = data_.count(key) ? 0 : -1;
          break;
        case OP_BARRIER_ENTER: {
          uint64_t world = 0, rank = 0;
          if (val.size() >= 8) std::memcpy(&world, val.data(), 8);
          if (val.size() >= 16) std::memcpy(&rank, val.data() + 8, 8);
          Barrier& b = barriers_[key];
          int64_t round = b.round;
          b.members.insert(static_cast<int64_t>(rank));
          if (world > 0 && b.members.size() >= world) {
            b.completed = b.round;
            b.round += 1;
            b.members.clear();
          }
          std::string enc(8, '\0');
          std::memcpy(enc.data(), &round, 8);
          payload = enc;
          status = 8;
          break;
        }
        case OP_BARRIER_CHECK: {
          int64_t round = 0;
          std::memcpy(&round, val.data(), std::min<size_t>(8, val.size()));
          auto it = barriers_.find(key);
          status = (it != barriers_.end() && it->second.completed >= round)
                       ? 0
                       : -1;
          break;
        }
        case OP_PING:
          status = 0;
          break;
        default:
          status = -2;
      }
    }
    if (!send_all(fd, &status, 8)) return false;
    if (status > 0 && !send_all(fd, payload.data(), payload.size()))
      return false;
    return true;
  }

  int port_;
  int listen_fd_ = -1;
  std::atomic<bool> running_{false};
  std::thread thread_;
  struct Barrier {
    int64_t round = 0;
    int64_t completed = -1;
    std::set<int64_t> members;
  };

  std::vector<Conn> conns_;
  std::mutex mu_;
  std::map<std::string, std::string> data_;
  std::map<std::string, Barrier> barriers_;
};

// ---------------- client ----------------
class StoreClient {
 public:
  StoreClient(std::string host, int port) : host_(std::move(host)),
                                            port_(port) {}

  bool connect(int timeout_ms) {
    auto deadline = Clock::now() + std::chrono::milliseconds(timeout_ms);
    while (Clock::now() < deadline) {
      fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
      sockaddr_in addr{};
      addr.sin_family = AF_INET;
      addr.sin_port = htons(port_);
      if (::inet_pton(AF_INET, host_.c_str(), &addr.sin_addr) != 1) {
        pt::set_error("bad host (numeric IPv4 expected): " + host_);
        ::close(fd_);
        return false;
      }
      if (::connect(fd_, reinterpret_cast<sockaddr*>(&addr),
                    sizeof(addr)) == 0) {
        int yes = 1;
        ::setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &yes, sizeof(yes));
        return true;
      }
      ::close(fd_);
      std::this_thread::sleep_for(std::chrono::milliseconds(100));
    }
    pt::set_error("connect timeout to " + host_);
    return false;
  }

  ~StoreClient() {
    if (fd_ >= 0) ::close(fd_);
  }

  int64_t request(uint8_t op, const std::string& key, const std::string& val,
                  std::string* out) {
    std::lock_guard<std::mutex> l(mu_);
    uint32_t klen = key.size();
    uint64_t vlen = val.size();
    if (!send_all(fd_, &op, 1) || !send_all(fd_, &klen, 4) ||
        (klen && !send_all(fd_, key.data(), klen)) ||
        !send_all(fd_, &vlen, 8) ||
        (vlen && !send_all(fd_, val.data(), vlen))) {
      pt::set_error("store send failed");
      return -3;
    }
    int64_t status;
    if (!recv_all(fd_, &status, 8)) {
      pt::set_error("store recv failed");
      return -3;
    }
    if (status > 0 && out) {
      out->resize(status);
      if (!recv_all(fd_, out->data(), status)) {
        pt::set_error("store recv payload failed");
        return -3;
      }
    }
    return status;
  }

 private:
  std::string host_;
  int port_;
  int fd_ = -1;
  std::mutex mu_;
};

struct Store {
  std::unique_ptr<StoreServer> server;  // only on the master
  std::unique_ptr<StoreClient> client;
};

}  // namespace

PT_EXPORT pt_store_t pt_store_create(const char* host, int port,
                                     int is_master, int /*world_size*/,
                                     int timeout_ms) {
  auto* s = new Store();
  if (is_master) {
    s->server = std::make_unique<StoreServer>(port);
    if (!s->server->start()) {
      delete s;
      return nullptr;
    }
  }
  s->client = std::make_unique<StoreClient>(host ? host : "127.0.0.1", port);
  if (!s->client->connect(timeout_ms)) {
    delete s;
    return nullptr;
  }
  return s;
}

PT_EXPORT void pt_store_destroy(pt_store_t h) {
  delete static_cast<Store*>(h);
}

PT_EXPORT int pt_store_set(pt_store_t h, const char* key, const uint8_t* data,
                           int64_t len) {
  auto* s = static_cast<Store*>(h);
  std::string val(reinterpret_cast<const char*>(data), len);
  return s->client->request(OP_SET, key, val, nullptr) >= 0 ? 0 : -1;
}

PT_EXPORT int64_t pt_store_get(pt_store_t h, const char* key, uint8_t* buf,
                               int64_t cap, int timeout_ms) {
  auto* s = static_cast<Store*>(h);
  auto deadline = Clock::now() + std::chrono::milliseconds(timeout_ms);
  while (true) {
    std::string out;
    int64_t st = s->client->request(OP_GET, key, "", &out);
    if (st >= 0) {
      int64_t n = std::min<int64_t>(st, cap);
      std::memcpy(buf, out.data(), n);
      return st;
    }
    if (st == -3 || Clock::now() >= deadline) return -1;
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
}

PT_EXPORT int64_t pt_store_add(pt_store_t h, const char* key, int64_t delta) {
  auto* s = static_cast<Store*>(h);
  std::string val(8, '\0');
  std::memcpy(val.data(), &delta, 8);
  std::string out;
  int64_t st = s->client->request(OP_ADD, key, val, &out);
  if (st != 8) return INT64_MIN;
  int64_t cur;
  std::memcpy(&cur, out.data(), 8);
  return cur;
}

PT_EXPORT int pt_store_wait(pt_store_t h, const char* key, int timeout_ms) {
  auto* s = static_cast<Store*>(h);
  auto deadline = Clock::now() + std::chrono::milliseconds(timeout_ms);
  while (true) {
    int64_t st = s->client->request(OP_WAIT, key, "", nullptr);
    if (st == 0) return 0;
    if (st == -3 || Clock::now() >= deadline) {
      pt::set_error(std::string("wait timeout for key ") + key);
      return -1;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
}

PT_EXPORT int pt_store_barrier(pt_store_t h, const char* prefix, int rank,
                               int world_size, int timeout_ms) {
  // server-tracked round barrier: ENTER joins the server's current round
  // for this prefix, then polls until that round completes. Reusing a
  // prefix starts a fresh round, and a restarted rank joins the live round
  // (no client-local generation state).
  auto* s = static_cast<Store*>(h);
  std::string enter(16, '\0');
  int64_t ws = world_size, rk = rank;
  std::memcpy(enter.data(), &ws, 8);
  std::memcpy(enter.data() + 8, &rk, 8);
  std::string out;
  if (s->client->request(OP_BARRIER_ENTER, prefix, enter, &out) != 8) {
    pt::set_error("barrier enter failed");
    return -1;
  }
  int64_t round;
  std::memcpy(&round, out.data(), 8);
  std::string rv(8, '\0');
  std::memcpy(rv.data(), &round, 8);
  auto deadline = Clock::now() + std::chrono::milliseconds(timeout_ms);
  while (true) {
    int64_t st = s->client->request(OP_BARRIER_CHECK, prefix, rv, nullptr);
    if (st == 0) return 0;
    if (st == -3 || Clock::now() >= deadline) {
      pt::set_error("barrier timeout (prefix " + std::string(prefix) +
                    ", round " + std::to_string(round) + ")");
      return -1;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
}
