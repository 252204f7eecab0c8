// Thread-pool file writer — the native IO tier of the runtime.
//
// The sampler's crash-resilience contract (reference pspec.py:625-638:
// rewrite every sample file each write interval) makes the flush path
// write hundreds of .npy files per interval at scale (6 files x baselines
// x chains). Python's serial np.save serializes all of it on the host
// thread between device chunks; this pool fans the writes out over
// threads and the Python side overlaps submission with the next chunk,
// waiting only before the checkpoint is durably recorded.
//
// Deliberately dtype-agnostic: Python builds the .npy header bytes
// (numpy.lib.format) and the pool writes header+payload verbatim, so the
// C++ side has no numpy format knowledge to drift out of date.
//
// The port's own copy of the JAX package's native/fastio.cpp, so that the
// installed hydra_pspec_torch needs nothing outside itself.
// Build: at first use by hydra_pspec_torch/utils/fastio.py
//   (g++ -O2 -std=c++17 -fPIC -pthread -shared, zero deps), into
//   hydra_pspec_torch/_build/. Python binding: the same module (ctypes).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
  std::string path;
  std::vector<unsigned char> payload;  // header + data, owned copy
};

struct Pool {
  std::vector<std::thread> workers;
  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv_push;   // workers wait for work
  std::condition_variable cv_done;   // waiters wait for drain
  size_t inflight = 0;               // queued + being written
  std::atomic<bool> stop{false};
  std::atomic<long long> write_ns{0};
  std::atomic<long long> errors{0};

  explicit Pool(int nthreads) {
    for (int i = 0; i < nthreads; ++i) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [this] { return stop || !queue.empty(); });
        if (queue.empty()) {
          if (stop) return;
          continue;
        }
        job = std::move(queue.front());
        queue.pop_front();
      }
      auto t0 = std::chrono::steady_clock::now();
      // write to a temp file then rename: a crash mid-write never leaves a
      // truncated sample file behind (matches utils/io.py checkpoint style)
      std::string tmp = job.path + ".tmp";
      FILE* f = std::fopen(tmp.c_str(), "wb");
      bool ok = f != nullptr;
      if (ok) {
        ok = std::fwrite(job.payload.data(), 1, job.payload.size(), f) ==
             job.payload.size();
        ok = (std::fclose(f) == 0) && ok;
      }
      if (ok) ok = (std::rename(tmp.c_str(), job.path.c_str()) == 0);
      if (!ok) errors.fetch_add(1);
      auto t1 = std::chrono::steady_clock::now();
      write_ns.fetch_add(
          std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0)
              .count());
      {
        std::lock_guard<std::mutex> lk(mu);
        --inflight;
        if (inflight == 0) cv_done.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

void* fastio_create(int nthreads) {
  if (nthreads < 1) nthreads = 1;
  return new Pool(nthreads);
}

// Queue one file write; data is copied before returning (the caller may
// free/reuse its buffer immediately).
int fastio_submit(void* pool_, const char* path, const void* header,
                  uint64_t header_len, const void* data, uint64_t data_len) {
  auto* pool = static_cast<Pool*>(pool_);
  Job job;
  job.path = path;
  job.payload.resize(header_len + data_len);
  std::memcpy(job.payload.data(), header, header_len);
  std::memcpy(job.payload.data() + header_len, data, data_len);
  {
    std::lock_guard<std::mutex> lk(pool->mu);
    ++pool->inflight;
    pool->queue.push_back(std::move(job));
  }
  pool->cv_push.notify_one();
  return 0;
}

// Block until every queued write has hit the filesystem; returns the
// number of failed writes since creation.
long long fastio_wait(void* pool_) {
  auto* pool = static_cast<Pool*>(pool_);
  std::unique_lock<std::mutex> lk(pool->mu);
  pool->cv_done.wait(lk, [pool] { return pool->inflight == 0; });
  return pool->errors.load();
}

double fastio_write_seconds(void* pool_) {
  return static_cast<Pool*>(pool_)->write_ns.load() * 1e-9;
}

void fastio_destroy(void* pool_) {
  auto* pool = static_cast<Pool*>(pool_);
  {
    std::lock_guard<std::mutex> lk(pool->mu);
    pool->stop = true;
  }
  pool->cv_push.notify_all();
  for (auto& t : pool->workers) t.join();
  delete pool;
}

}  // extern "C"
