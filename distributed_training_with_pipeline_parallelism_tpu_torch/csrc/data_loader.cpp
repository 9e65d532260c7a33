// Native (C++) prefetching token-batch loader.
//
// The runtime-native twin of utils/data.py's TokenFileDataset: random crops
// of seq_length+1 tokens from a flat binary token file (GPT-2-style packed
// corpus), assembled into int32 [B, S] token/target pairs by background
// threads and handed to Python through a bounded queue. The file is mmap'd
// read-only so the host working set stays at O(touched pages); crop
// assembly (gather + widen to int32 + next-token shift) runs off the Python
// thread entirely, so the train loop's host time is one memcpy per batch.
//
// Exposed via ctypes (see utils/data_native.py); no Python.h dependency.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int DTYPE_U16 = 0;
constexpr int DTYPE_I32 = 1;

// splitmix64: tiny, high-quality, and trivially seedable per thread.
struct SplitMix64 {
  uint64_t s;
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
};

struct Loader {
  const void* map = nullptr;
  size_t map_bytes = 0;
  int fd = -1;
  int64_t n_tokens = 0;
  int64_t seq = 0;
  int64_t batch = 0;
  int dtype = DTYPE_U16;
  int depth = 4;

  std::vector<std::thread> threads;
  std::deque<std::vector<int32_t>> queue;  // each: [tokens | targets], 2*B*S
  std::mutex mu;
  std::condition_variable cv_space, cv_item, cv_readers;
  std::atomic<bool> stop{false};
  int readers = 0;  // in-flight dtpp_dl_next calls (guarded by mu)

  int32_t tok_at(int64_t i) const {
    return dtype == DTYPE_U16
               ? static_cast<int32_t>(static_cast<const uint16_t*>(map)[i])
               : static_cast<const int32_t*>(map)[i];
  }

  void worker(uint64_t seed) {
    SplitMix64 rng{seed};
    const uint64_t n_starts =
        static_cast<uint64_t>(n_tokens - seq);  // crop is seq+1 long
    while (!stop.load(std::memory_order_relaxed)) {
      std::vector<int32_t> buf(2 * batch * seq);
      int32_t* toks = buf.data();
      int32_t* tgts = toks + batch * seq;
      for (int64_t r = 0; r < batch; ++r) {
        const int64_t start = static_cast<int64_t>(rng.next() % n_starts);
        for (int64_t j = 0; j < seq; ++j) {
          toks[r * seq + j] = tok_at(start + j);
          tgts[r * seq + j] = tok_at(start + j + 1);
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || static_cast<int>(queue.size()) < depth;
      });
      if (stop.load()) return;
      queue.push_back(std::move(buf));
      cv_item.notify_one();
    }
  }

  ~Loader() {
    {
      // The store+notify must happen under the mutex: a worker that has
      // evaluated its wait predicate but not yet blocked would otherwise
      // miss the wakeup and sleep forever, deadlocking join() below.
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv_space.notify_all();
    cv_item.notify_all();
    for (auto& t : threads)
      if (t.joinable()) t.join();
    if (map != nullptr) munmap(const_cast<void*>(map), map_bytes);
    if (fd >= 0) close(fd);
  }
};

void set_err(char* err, int errlen, const std::string& msg) {
  if (err != nullptr && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

void* dtpp_dl_open(const char* path, int64_t seq, int64_t batch, int dtype,
                   uint64_t seed, int n_threads, int depth, char* err,
                   int errlen) {
  if (seq <= 0 || batch <= 0 || n_threads <= 0 || depth <= 0) {
    set_err(err, errlen, "seq, batch, n_threads, depth must be positive");
    return nullptr;
  }
  if (dtype != DTYPE_U16 && dtype != DTYPE_I32) {
    set_err(err, errlen, "dtype code must be 0 (uint16) or 1 (int32)");
    return nullptr;
  }
  auto ld = std::make_unique<Loader>();
  ld->fd = open(path, O_RDONLY);
  if (ld->fd < 0) {
    set_err(err, errlen, std::string("cannot open ") + path);
    return nullptr;
  }
  struct stat st;
  if (fstat(ld->fd, &st) != 0) {
    set_err(err, errlen, std::string("cannot stat ") + path);
    return nullptr;
  }
  ld->map_bytes = static_cast<size_t>(st.st_size);
  const size_t tok_bytes = dtype == DTYPE_U16 ? 2 : 4;
  ld->n_tokens = static_cast<int64_t>(ld->map_bytes / tok_bytes);
  if (ld->n_tokens < seq + 1) {
    set_err(err, errlen,
            "file holds " + std::to_string(ld->n_tokens) +
                " tokens, need at least " + std::to_string(seq + 1));
    return nullptr;
  }
  ld->map = mmap(nullptr, ld->map_bytes, PROT_READ, MAP_SHARED, ld->fd, 0);
  if (ld->map == MAP_FAILED) {
    ld->map = nullptr;
    set_err(err, errlen, std::string("mmap failed for ") + path);
    return nullptr;
  }
  madvise(const_cast<void*>(ld->map), ld->map_bytes, MADV_RANDOM);
  ld->seq = seq;
  ld->batch = batch;
  ld->dtype = dtype;
  ld->depth = depth;
  for (int t = 0; t < n_threads; ++t) {
    // distinct, deterministic stream per thread
    ld->threads.emplace_back(&Loader::worker, ld.get(),
                             seed + 0x517cc1b727220a95ULL * (t + 1));
  }
  return ld.release();
}

// Blocks until a batch is ready; copies into caller buffers of B*S int32 each.
// Safe against a concurrent dtpp_dl_close: close() waits for in-flight
// readers (the `readers` count) before freeing the Loader.
int dtpp_dl_next(void* handle, int32_t* toks_out, int32_t* tgts_out) {
  auto* ld = static_cast<Loader*>(handle);
  std::vector<int32_t> buf;
  size_t n = 0;
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    ++ld->readers;
    ld->cv_item.wait(lk, [&] { return ld->stop.load() || !ld->queue.empty(); });
    const bool closing = ld->queue.empty();
    if (!closing) {
      buf = std::move(ld->queue.front());
      ld->queue.pop_front();
      ld->cv_space.notify_one();
      n = static_cast<size_t>(ld->batch * ld->seq);
    }
    if (--ld->readers == 0) ld->cv_readers.notify_all();
    if (closing) return 1;
    // `ld` must not be touched after unlock: close() may free it as soon as
    // readers hits zero. Everything needed below is in locals.
  }
  std::memcpy(toks_out, buf.data(), n * sizeof(int32_t));
  std::memcpy(tgts_out, buf.data() + n, n * sizeof(int32_t));
  return 0;
}

// Unblock every in-flight and future dtpp_dl_next (they return 1) without
// freeing the Loader. Callers that may race next() against close() should
// stop first, drain their readers, then close.
void dtpp_dl_stop(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(ld->mu);
  ld->stop.store(true);
  ld->cv_item.notify_all();
  ld->cv_space.notify_all();
}

void dtpp_dl_close(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    ld->stop.store(true);
    ld->cv_item.notify_all();
    ld->cv_space.notify_all();
    ld->cv_readers.wait(lk, [&] { return ld->readers == 0; });
  }
  delete ld;  // ~Loader joins the (already stopping) worker threads
}

}  // extern "C"
