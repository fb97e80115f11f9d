// Native trajectory data loader (the dm_control_torch copy of
// dm_control_tpu/native/trajloader.cc).
//
// Reference counterpart: dm_control/scripts/dataset.py:142-160 __getitem__
// + torch DataLoader worker processes.  The reference pays one Python call
// per sample and per-worker process IPC; here block gathering and batch
// assembly run in C++ worker threads over the memory-resident dataset,
// with a double-buffered prefetch ring so the next batch is being built
// while the accelerator consumes the current one.  Python sees contiguous
// [batch, block, dim] float32 buffers through ctypes — zero copies on the
// Python side.
//
// Build: g++ -O3 -shared -fPIC -pthread trajloader.cc -o libtrajloader.so
//        (driven by dm_control_torch/native/__init__.py, into
//        dm_control_torch/_build/ under a name hashed from source and flags)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Dataset {
  const float* obs;        // [n, obs_dim]
  const float* act;        // [n, act_dim]
  int64_t n;
  int obs_dim;
  int act_dim;
  const int64_t* starts;   // valid block start indices (episode-safe)
  int64_t n_starts;
  int block;
};

// xorshift128+ — deterministic, seedable, fast
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed ^ 0x9E3779B97F4A7C15ull;
    s1 = (seed << 1) | 1;
    for (int i = 0; i < 8; ++i) next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
};

void gather_range(const Dataset& ds, const int64_t* sample_starts,
                  int lo, int hi, float* out_obs, float* out_act) {
  const size_t obs_row = static_cast<size_t>(ds.obs_dim);
  const size_t act_row = static_cast<size_t>(ds.act_dim);
  const size_t obs_blk = static_cast<size_t>(ds.block) * obs_row;
  const size_t act_blk = static_cast<size_t>(ds.block) * act_row;
  for (int b = lo; b < hi; ++b) {
    const int64_t s = sample_starts[b];
    std::memcpy(out_obs + b * obs_blk, ds.obs + s * obs_row,
                obs_blk * sizeof(float));
    std::memcpy(out_act + b * act_blk, ds.act + s * act_row,
                act_blk * sizeof(float));
  }
}

void gather_batch(const Dataset& ds, const int64_t* sample_starts,
                  int batch, int n_threads, float* out_obs,
                  float* out_act) {
  if (n_threads <= 1 || batch < 2 * n_threads) {
    gather_range(ds, sample_starts, 0, batch, out_obs, out_act);
    return;
  }
  std::vector<std::thread> workers;
  const int chunk = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int lo = t * chunk;
    const int hi = lo + chunk < batch ? lo + chunk : batch;
    if (lo >= hi) break;
    workers.emplace_back([&, lo, hi] {
      gather_range(ds, sample_starts, lo, hi, out_obs, out_act);
    });
  }
  for (auto& w : workers) w.join();
}

struct Loader {
  Dataset ds;
  int batch;
  int n_threads;
  Rng rng;
  std::vector<int64_t> starts_buf;
  std::vector<float> obs_buf;   // prefetched batch
  std::vector<float> act_buf;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  bool ready = false;
  bool want = true;
  std::atomic<bool> stop{false};

  Loader(Dataset d, int batch_, uint64_t seed, int n_threads_)
      : ds(d), batch(batch_), n_threads(n_threads_), rng(seed) {
    starts_buf.resize(batch);
    obs_buf.resize(static_cast<size_t>(batch) * ds.block * ds.obs_dim);
    act_buf.resize(static_cast<size_t>(batch) * ds.block * ds.act_dim);
    worker = std::thread([this] { run(); });
  }

  void fill() {
    for (int b = 0; b < batch; ++b) {
      starts_buf[b] =
          ds.starts[rng.next() % static_cast<uint64_t>(ds.n_starts)];
    }
    gather_batch(ds, starts_buf.data(), batch, n_threads, obs_buf.data(),
                 act_buf.data());
  }

  void run() {
    while (true) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return want || stop.load(); });
        if (stop.load()) return;
        want = false;
      }
      fill();
      {
        std::lock_guard<std::mutex> lk(mu);
        ready = true;
      }
      cv.notify_all();
    }
  }

  void next(float* out_obs, float* out_act) {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return ready; });
    std::memcpy(out_obs, obs_buf.data(), obs_buf.size() * sizeof(float));
    std::memcpy(out_act, act_buf.data(), act_buf.size() * sizeof(float));
    ready = false;
    want = true;   // kick the next prefetch
    lk.unlock();
    cv.notify_all();
  }

  ~Loader() {
    stop.store(true);
    cv.notify_all();
    worker.join();
  }
};

}  // namespace

extern "C" {

// One-shot threaded gather of explicit starts.
void tl_gather(const float* obs, const float* act, int64_t n, int obs_dim,
               int act_dim, int block, const int64_t* sample_starts,
               int batch, int n_threads, float* out_obs, float* out_act) {
  Dataset ds{obs, act, n, obs_dim, act_dim, nullptr, 0, block};
  gather_batch(ds, sample_starts, batch, n_threads, out_obs, out_act);
}

void* tl_create(const float* obs, const float* act, int64_t n, int obs_dim,
                int act_dim, const int64_t* starts, int64_t n_starts,
                int block, int batch, uint64_t seed, int n_threads) {
  Dataset ds{obs, act, n, obs_dim, act_dim, starts, n_starts, block};
  return new Loader(ds, batch, seed, n_threads);
}

void tl_next(void* h, float* out_obs, float* out_act) {
  static_cast<Loader*>(h)->next(out_obs, out_act);
}

void tl_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
