// kubeml_native — the host-side data plane of kubeml_tpu_torch: the round
// packer, the f32 -> bf16 cast and the tensor store with its unix-socket
// server. Host code, built with the C++ compiler (not nvcc) by
// kubeml_tpu_torch/native/build.py; the C ABI and the socket framing are
// those of the JAX package's native library, so either package's client
// reads the other's server.
//
//  1. kml_pack — parallel gather/pad of per-worker sample slices into the
//     uniform [N, steps, B, ...] round tensor that feeds the device (the
//     reference's equivalent work is Mongo cursor decode + DataLoader
//     collation).
//
//  2. TensorStore — an in-memory tensor KV with the reference's key semantics
//     ("jobId:layer" reference weights, "jobId:layer/funcId" per-worker
//     tensors, prefix delete = clearTensors, ml/pkg/model/utils.go:140-158,
//     ml/pkg/train/util.go:211-244) plus a unix-domain-socket server so
//     separate processes (standalone job runners) can exchange tensors
//     without Redis.
//
// Plain C ABI for ctypes; no Python.h dependency. C++17, POSIX.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <errno.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// 1. Parallel round packing
// ---------------------------------------------------------------------------

void pack_worker_range(uint8_t* dst, const uint8_t* const* srcs,
                       const int64_t* counts, int64_t per_round,
                       int64_t item_bytes, int32_t w0, int32_t w1) {
  for (int32_t w = w0; w < w1; ++w) {
    uint8_t* slot = dst + static_cast<int64_t>(w) * per_round * item_bytes;
    int64_t c = counts[w];
    if (c > per_round) c = per_round;
    if (srcs[w] != nullptr && c > 0) {
      std::memcpy(slot, srcs[w], static_cast<size_t>(c) * item_bytes);
    } else {
      c = 0;
    }
    if (c < per_round) {
      std::memset(slot + c * item_bytes, 0,
                  static_cast<size_t>(per_round - c) * item_bytes);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. TensorStore
// ---------------------------------------------------------------------------

struct Tensor {
  std::string dtype;
  std::vector<int64_t> shape;
  std::string data;
};

struct Store {
  std::shared_mutex mu;
  // std::map so prefix scans are ordered range scans
  std::map<std::string, Tensor> items;
  std::atomic<int64_t> bytes{0};
};

std::mutex g_reg_mu;
std::unordered_map<int64_t, std::shared_ptr<Store>> g_stores;
std::atomic<int64_t> g_next_handle{1};

std::shared_ptr<Store> find_store(int64_t h) {
  std::lock_guard<std::mutex> lk(g_reg_mu);
  auto it = g_stores.find(h);
  return it == g_stores.end() ? nullptr : it->second;
}

constexpr int32_t kMaxNdim = 8;
constexpr uint32_t kMaxKeyLen = 4096;
constexpr uint8_t kMaxDtypeLen = 16;
// per-tensor ceiling for the socket server: a desynced or hostile client must
// not be able to drive resize() into bad_alloc (8 GiB covers any real layer)
constexpr uint64_t kMaxTensorBytes = 8ull << 30;

// ---------------------------------------------------------------------------
// 3. Unix-socket server (RedisAI stand-in for multi-process deployments)
//
// Framing (all little-endian):
//   request : u8 op | u32 klen | key bytes | op payload
//   SET (1) : u8 dlen | dtype | u8 ndim | i64 shape[ndim] | u64 nbytes | data
//   GET (2) : -
//   DEL (3) : -
//   DELP(4) : -            (key is the prefix)
//   KEYS(5) : -            (key is the prefix; may be empty)
//   COUNT(6): -            (key empty)
//   PING(7) : -
// response: i64 status (>=0 ok / -1 missing / -2 malformed), then for
//   GET ok  : u8 dlen | dtype | u8 ndim | i64 shape[ndim] | u64 nbytes | data
//   KEYS ok : u64 len | newline-joined keys
//   DELP/COUNT ok: status carries the count
// ---------------------------------------------------------------------------

bool read_exact(int fd, void* buf, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool send_status(int fd, int64_t status) {
  return write_exact(fd, &status, sizeof(status));
}

void handle_conn_inner(std::shared_ptr<Store> store, int fd) {
  for (;;) {
    uint8_t op;
    if (!read_exact(fd, &op, 1)) break;
    uint32_t klen;
    if (!read_exact(fd, &klen, 4)) break;
    if (klen > kMaxKeyLen) {
      send_status(fd, -2);
      break;
    }
    std::string key(klen, '\0');
    if (klen && !read_exact(fd, key.data(), klen)) break;

    if (op == 1) {  // SET
      uint8_t dlen, ndim;
      if (!read_exact(fd, &dlen, 1)) break;
      if (dlen > kMaxDtypeLen) {
        send_status(fd, -2);
        break;
      }
      std::string dtype(dlen, '\0');
      if (dlen && !read_exact(fd, dtype.data(), dlen)) break;
      if (!read_exact(fd, &ndim, 1)) break;
      if (ndim > kMaxNdim) {
        send_status(fd, -2);
        break;
      }
      std::vector<int64_t> shape(ndim);
      if (ndim && !read_exact(fd, shape.data(), ndim * sizeof(int64_t))) break;
      uint64_t nbytes;
      if (!read_exact(fd, &nbytes, 8)) break;
      if (nbytes > kMaxTensorBytes) {
        send_status(fd, -2);
        break;  // stream is desynced past repair; drop the connection
      }
      Tensor t;
      t.dtype = std::move(dtype);
      t.shape = std::move(shape);
      t.data.resize(nbytes);
      if (nbytes && !read_exact(fd, t.data.data(), nbytes)) break;
      {
        std::unique_lock<std::shared_mutex> lk(store->mu);
        auto it = store->items.find(key);
        if (it != store->items.end())
          store->bytes -= static_cast<int64_t>(it->second.data.size());
        store->bytes += static_cast<int64_t>(nbytes);
        store->items[key] = std::move(t);
      }
      if (!send_status(fd, 0)) break;
    } else if (op == 2) {  // GET
      // copy out under the read lock, write to the socket after releasing it:
      // a slow client must never block writers (SET takes the unique lock)
      Tensor copy;
      bool found = false;
      {
        std::shared_lock<std::shared_mutex> lk(store->mu);
        auto it = store->items.find(key);
        if (it != store->items.end()) {
          copy = it->second;
          found = true;
        }
      }
      if (!found) {
        if (!send_status(fd, -1)) break;
        continue;
      }
      if (!send_status(fd, 0)) break;
      uint8_t dlen = static_cast<uint8_t>(copy.dtype.size());
      uint8_t ndim = static_cast<uint8_t>(copy.shape.size());
      uint64_t nbytes = copy.data.size();
      bool ok = write_exact(fd, &dlen, 1) &&
                write_exact(fd, copy.dtype.data(), dlen) &&
                write_exact(fd, &ndim, 1) &&
                (ndim == 0 ||
                 write_exact(fd, copy.shape.data(), ndim * sizeof(int64_t))) &&
                write_exact(fd, &nbytes, 8) &&
                (nbytes == 0 || write_exact(fd, copy.data.data(), nbytes));
      if (!ok) break;
    } else if (op == 3) {  // DEL
      std::unique_lock<std::shared_mutex> lk(store->mu);
      auto it = store->items.find(key);
      int64_t status = -1;
      if (it != store->items.end()) {
        store->bytes -= static_cast<int64_t>(it->second.data.size());
        store->items.erase(it);
        status = 0;
      }
      lk.unlock();
      if (!send_status(fd, status)) break;
    } else if (op == 4) {  // DEL PREFIX (clearTensors: DEL jobId*)
      std::unique_lock<std::shared_mutex> lk(store->mu);
      int64_t n = 0;
      auto it = store->items.lower_bound(key);
      while (it != store->items.end() && it->first.compare(0, key.size(), key) == 0) {
        store->bytes -= static_cast<int64_t>(it->second.data.size());
        it = store->items.erase(it);
        ++n;
      }
      lk.unlock();
      if (!send_status(fd, n)) break;
    } else if (op == 5) {  // KEYS (prefix scan)
      std::string joined;
      {
        std::shared_lock<std::shared_mutex> lk(store->mu);
        auto it = key.empty() ? store->items.begin() : store->items.lower_bound(key);
        for (; it != store->items.end(); ++it) {
          if (!key.empty() && it->first.compare(0, key.size(), key) != 0) break;
          joined += it->first;
          joined += '\n';
        }
      }
      if (!joined.empty()) joined.pop_back();
      if (!send_status(fd, 0)) break;
      uint64_t len = joined.size();
      if (!write_exact(fd, &len, 8)) break;
      if (len && !write_exact(fd, joined.data(), len)) break;
    } else if (op == 6) {  // COUNT
      int64_t n;
      {
        std::shared_lock<std::shared_mutex> lk(store->mu);
        n = static_cast<int64_t>(store->items.size());
      }
      if (!send_status(fd, n)) break;
    } else if (op == 7) {  // PING
      if (!send_status(fd, 0)) break;
    } else {
      send_status(fd, -2);
      break;
    }
  }
  ::close(fd);
}

void handle_conn(std::shared_ptr<Store> store, int fd) {
  // detached thread: an escaping exception (e.g. bad_alloc on a huge SET)
  // would std::terminate the whole process — contain it to this connection
  try {
    handle_conn_inner(std::move(store), fd);
  } catch (...) {
    ::close(fd);
  }
}

struct Server {
  int listen_fd = -1;
  std::string path;
  std::thread accept_thread;
  std::atomic<bool> stopping{false};
};

std::mutex g_srv_mu;
std::unordered_map<int64_t, std::unique_ptr<Server>> g_servers;
std::atomic<int64_t> g_next_srv{1};

}  // namespace

extern "C" {

// --- packing ---

void kml_pack(uint8_t* dst, const uint8_t* const* srcs, const int64_t* counts,
              int64_t per_round, int64_t item_bytes, int32_t n,
              int32_t n_threads) {
  if (n <= 0 || per_round <= 0 || item_bytes <= 0) return;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  if (n_threads == 1) {
    pack_worker_range(dst, srcs, counts, per_round, item_bytes, 0, n);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  int32_t per = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int32_t w0 = t * per;
    int32_t w1 = std::min(n, w0 + per);
    if (w0 >= w1) break;
    ts.emplace_back(pack_worker_range, dst, srcs, counts, per_round, item_bytes,
                    w0, w1);
  }
  for (auto& t : ts) t.join();
}

// f32 -> bf16 (round-to-nearest-even), multithreaded. The host-side cast that
// halves host->HBM transfer bytes for bf16 training; numpy's ml_dtypes cast is
// scalar-slow, this is a linear pass.
static inline uint16_t f32_to_bf16_rne(uint32_t bits) {
  // NaN must stay NaN (quiet); otherwise round to nearest even on bit 16
  if ((bits & 0x7fffffffu) > 0x7f800000u) return static_cast<uint16_t>((bits >> 16) | 0x0040u);
  uint32_t rounding_bias = 0x7fffu + ((bits >> 16) & 1u);
  return static_cast<uint16_t>((bits + rounding_bias) >> 16);
}

static void cast_range(const uint32_t* src, uint16_t* dst, int64_t lo, int64_t hi) {
  for (int64_t i = lo; i < hi; ++i) dst[i] = f32_to_bf16_rne(src[i]);
}

void kml_f32_to_bf16(const float* src, uint16_t* dst, int64_t n,
                     int32_t n_threads) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  if (n_threads < 1) n_threads = 1;
  if (n < (1 << 16) || n_threads == 1) {
    cast_range(s, dst, 0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(cast_range, s, dst, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// --- tensor store (in-process) ---

int64_t kml_store_new() {
  auto s = std::make_shared<Store>();
  std::lock_guard<std::mutex> lk(g_reg_mu);
  int64_t h = g_next_handle++;
  g_stores[h] = std::move(s);
  return h;
}

void kml_store_free(int64_t h) {
  std::lock_guard<std::mutex> lk(g_reg_mu);
  g_stores.erase(h);
}

int32_t kml_store_set(int64_t h, const char* key, const char* dtype,
                      const int64_t* shape, int32_t ndim, const void* data,
                      int64_t nbytes) {
  auto s = find_store(h);
  if (!s || ndim < 0 || ndim > kMaxNdim || nbytes < 0) return -2;
  Tensor t;
  t.dtype = dtype;
  t.shape.assign(shape, shape + ndim);
  t.data.assign(static_cast<const char*>(data), static_cast<size_t>(nbytes));
  std::unique_lock<std::shared_mutex> lk(s->mu);
  auto it = s->items.find(key);
  if (it != s->items.end())
    s->bytes -= static_cast<int64_t>(it->second.data.size());
  s->bytes += nbytes;
  s->items[key] = std::move(t);
  return 0;
}

int32_t kml_store_meta(int64_t h, const char* key, char* dtype_out,
                       int64_t* shape_out, int32_t* ndim_out,
                       int64_t* nbytes_out) {
  auto s = find_store(h);
  if (!s) return -2;
  std::shared_lock<std::shared_mutex> lk(s->mu);
  auto it = s->items.find(key);
  if (it == s->items.end()) return -1;
  const Tensor& t = it->second;
  std::snprintf(dtype_out, kMaxDtypeLen + 1, "%s", t.dtype.c_str());
  *ndim_out = static_cast<int32_t>(t.shape.size());
  for (size_t i = 0; i < t.shape.size(); ++i) shape_out[i] = t.shape[i];
  *nbytes_out = static_cast<int64_t>(t.data.size());
  return 0;
}

int64_t kml_store_get(int64_t h, const char* key, void* out, int64_t cap) {
  auto s = find_store(h);
  if (!s) return -2;
  std::shared_lock<std::shared_mutex> lk(s->mu);
  auto it = s->items.find(key);
  if (it == s->items.end()) return -1;
  const Tensor& t = it->second;
  if (static_cast<int64_t>(t.data.size()) > cap) return -3;
  std::memcpy(out, t.data.data(), t.data.size());
  return static_cast<int64_t>(t.data.size());
}

int32_t kml_store_del(int64_t h, const char* key) {
  auto s = find_store(h);
  if (!s) return -2;
  std::unique_lock<std::shared_mutex> lk(s->mu);
  auto it = s->items.find(key);
  if (it == s->items.end()) return -1;
  s->bytes -= static_cast<int64_t>(it->second.data.size());
  s->items.erase(it);
  return 0;
}

int64_t kml_store_del_prefix(int64_t h, const char* prefix) {
  auto s = find_store(h);
  if (!s) return -2;
  std::string p(prefix);
  std::unique_lock<std::shared_mutex> lk(s->mu);
  int64_t n = 0;
  auto it = s->items.lower_bound(p);
  while (it != s->items.end() && it->first.compare(0, p.size(), p) == 0) {
    s->bytes -= static_cast<int64_t>(it->second.data.size());
    it = s->items.erase(it);
    ++n;
  }
  return n;
}

int64_t kml_store_keys(int64_t h, const char* prefix, char* out, int64_t cap) {
  auto s = find_store(h);
  if (!s) return -2;
  std::string p(prefix);
  std::string joined;
  {
    std::shared_lock<std::shared_mutex> lk(s->mu);
    auto it = p.empty() ? s->items.begin() : s->items.lower_bound(p);
    for (; it != s->items.end(); ++it) {
      if (!p.empty() && it->first.compare(0, p.size(), p) != 0) break;
      joined += it->first;
      joined += '\n';
    }
  }
  if (!joined.empty()) joined.pop_back();
  int64_t len = static_cast<int64_t>(joined.size());
  if (out != nullptr && cap > 0) {
    int64_t c = std::min(len, cap);
    std::memcpy(out, joined.data(), static_cast<size_t>(c));
  }
  return len;
}

int64_t kml_store_count(int64_t h) {
  auto s = find_store(h);
  if (!s) return -2;
  std::shared_lock<std::shared_mutex> lk(s->mu);
  return static_cast<int64_t>(s->items.size());
}

int64_t kml_store_bytes(int64_t h) {
  auto s = find_store(h);
  if (!s) return -2;
  return s->bytes.load();
}

// --- tensor store server (unix domain socket) ---

int64_t kml_server_start(int64_t store_handle, const char* socket_path) {
  auto store = find_store(store_handle);
  if (!store) return -1;
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_un addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sun_family = AF_UNIX;
  if (std::strlen(socket_path) >= sizeof(addr.sun_path)) {
    ::close(fd);
    return -1;
  }
  std::strcpy(addr.sun_path, socket_path);
  ::unlink(socket_path);
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(fd, 64) != 0) {
    ::close(fd);
    return -1;
  }
  auto srv = std::make_unique<Server>();
  srv->listen_fd = fd;
  srv->path = socket_path;
  Server* raw = srv.get();
  srv->accept_thread = std::thread([raw, store]() {
    for (;;) {
      // checked at the top so the stop path's wake-up connection (below)
      // always lands on an exit check, whether accept() was blocked or not
      if (raw->stopping.load()) return;
      int cfd = ::accept(raw->listen_fd, nullptr, nullptr);
      if (cfd < 0) {
        if (raw->stopping.load() || (errno != EINTR && errno != ECONNABORTED))
          return;
        continue;
      }
      std::thread(handle_conn, store, cfd).detach();
    }
  });
  std::lock_guard<std::mutex> lk(g_srv_mu);
  int64_t h = g_next_srv++;
  g_servers[h] = std::move(srv);
  return h;
}

void kml_server_stop(int64_t h) {
  std::unique_ptr<Server> srv;
  {
    std::lock_guard<std::mutex> lk(g_srv_mu);
    auto it = g_servers.find(h);
    if (it == g_servers.end()) return;
    srv = std::move(it->second);
    g_servers.erase(it);
  }
  srv->stopping.store(true);
  // shutdown() does NOT wake a blocked accept() on an AF_UNIX listener on
  // every kernel (observed hanging forever on 4.4) — a self-connection
  // does, and the accept loop's top-of-loop stopping check turns it into
  // a clean exit whichever state the thread was in
  int wake = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (wake >= 0) {
    sockaddr_un addr;
    std::memset(&addr, 0, sizeof(addr));
    addr.sun_family = AF_UNIX;
    std::strncpy(addr.sun_path, srv->path.c_str(), sizeof(addr.sun_path) - 1);
    ::connect(wake, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
    ::close(wake);
  }
  ::shutdown(srv->listen_fd, SHUT_RDWR);
  if (srv->accept_thread.joinable()) srv->accept_thread.join();
  ::close(srv->listen_fd);
  ::unlink(srv->path.c_str());
}

int32_t kml_version() { return 1; }

}  // extern "C"
