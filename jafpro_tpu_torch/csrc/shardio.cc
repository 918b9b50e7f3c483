// shardio: threaded packed-shard batch reader for the training input
// pipeline (the port's own copy of the JAX package's native/shardio.cc:
// the same order of records, so both packages draw the same batches from
// the same shards and seed). One change: with loop=0 the copy's
// shardio_next returns -1 once every worker has run out of records, where
// the original waits for a batch that never comes.
//
// In place of the reference's multiprocess torch DataLoader
// (train/4.convLSTM_flowpro_interval.py:199-200), samples are pre-packed
// into fixed-size binary records (jafpro_tpu_torch/data/shardio.py) and
// this library streams them with:
//   * a worker-thread pool doing positional reads (pread) straight into
//     contiguous batch buffers (no Python in the loop),
//   * a ring of prefetched batches so training steps never wait on disk,
//   * optional per-epoch shuffling: Fisher-Yates driven by a
//     std::mt19937_64 seeded from (seed, epoch).
//
// C ABI (ctypes):
//   shardio_open(paths, n_paths, record_bytes, header_bytes, batch, depth,
//                threads, seed, shuffle, loop) -> handle
//     (header_bytes: per-file prefix to skip; the Python layer validates
//      the magic/spec-hash header and passes its size)
//   shardio_next(handle, out_ptr) -> record index of the first element,
//                                    or -1 at the end of the stream (!loop)
//   shardio_num_records(handle)
//   shardio_close(handle)
//
// Built with g++ at first use by jafpro_tpu_torch/cuda_build.py.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <random>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Record {
  int file;
  uint64_t offset;
};

struct Batch {
  std::vector<uint8_t> data;
  int64_t first_index;
};

struct Reader {
  std::vector<int> fds;
  std::vector<Record> records;
  uint64_t record_bytes = 0;
  int batch = 1;
  int depth = 2;
  bool shuffle = false;
  bool loop = true;
  uint64_t seed = 0;

  // Per-epoch permutations: epoch e's order is a deterministic function of
  // (seed, e), generated lazily and cached for the two epochs a batch can
  // straddle.  A global record counter (cursor) addresses into the virtual
  // concatenation of epoch permutations, so workers never coordinate a
  // reshuffle — they just derive (epoch, slot) from the counter.
  std::vector<uint64_t> perm[2];
  uint64_t perm_epoch[2] = {~0ull, ~0ull};
  std::atomic<uint64_t> cursor{0};

  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::deque<Batch> ready;
  bool stop = false;
  int running = 0;  // workers still filling batches (guarded by mu)
  std::vector<std::thread> workers;

  ~Reader() {
    {
      std::lock_guard<std::mutex> l(mu);
      stop = true;
    }
    cv_ready.notify_all();
    cv_space.notify_all();
    for (auto& t : workers) t.join();
    for (int fd : fds) close(fd);
  }

  // Returns epoch e's permutation, generating it on first use.  Caller
  // holds mu.  Fisher-Yates seeded by splitmix64(seed, e) so every epoch
  // visits all records in a fresh order (reference DataLoader shuffle=True
  // semantics, train/4:199).
  const std::vector<uint64_t>& permutation(uint64_t e) {
    int slot = static_cast<int>(e & 1);
    if (perm_epoch[slot] != e) {
      auto& p = perm[slot];
      p.resize(records.size());
      for (uint64_t i = 0; i < p.size(); ++i) p[i] = i;
      if (shuffle) {
        std::mt19937_64 rng(seed ^ (0x9e3779b97f4a7c15ULL * (e + 1)));
        for (uint64_t i = p.size(); i > 1; --i) {
          std::swap(p[i - 1], p[rng() % i]);
        }
      }
      perm_epoch[slot] = e;
    }
    return perm[slot];
  }

  bool fill_one() {
    uint64_t start;
    uint64_t n = records.size();
    std::vector<uint64_t> idxs(batch);
    {
      std::lock_guard<std::mutex> l(mu);
      start = cursor.fetch_add(batch);
      if (start + batch > n && !loop) return false;
      for (int i = 0; i < batch; ++i) {
        uint64_t g = start + i;
        idxs[i] = permutation(g / n)[g % n];
      }
    }
    Batch b;
    b.data.resize(record_bytes * batch);
    b.first_index = static_cast<int64_t>(start % n);
    for (int i = 0; i < batch; ++i) {
      const Record& r = records[idxs[i]];
      uint64_t done = 0;
      while (done < record_bytes) {
        ssize_t got = pread(fds[r.file], b.data.data() + i * record_bytes + done,
                            record_bytes - done, r.offset + done);
        if (got <= 0) { memset(b.data.data() + i * record_bytes + done, 0,
                               record_bytes - done); break; }
        done += got;
      }
    }
    std::unique_lock<std::mutex> l(mu);
    cv_space.wait(l, [&] { return stop || (int)ready.size() < depth; });
    if (stop) return false;
    ready.push_back(std::move(b));
    cv_ready.notify_one();
    return true;
  }

  void worker() {
    while (true) {
      {
        std::lock_guard<std::mutex> l(mu);
        if (stop) return;
      }
      if (!fill_one()) break;
    }
    std::lock_guard<std::mutex> l(mu);
    --running;
    cv_ready.notify_all();
  }
};

}  // namespace

extern "C" {

void* shardio_open(const char** paths, int n_paths, uint64_t record_bytes,
                   uint64_t header_bytes, int batch, int depth, int threads,
                   uint64_t seed, int shuffle, int loop) {
  auto* r = new Reader();
  r->record_bytes = record_bytes;
  r->batch = batch;
  r->depth = depth < 1 ? 1 : depth;
  r->shuffle = shuffle != 0;
  r->loop = loop != 0;
  r->seed = seed;
  for (int i = 0; i < n_paths; ++i) {
    int fd = open(paths[i], O_RDONLY);
    if (fd < 0) { delete r; return nullptr; }
    struct stat st;
    fstat(fd, &st);
    uint64_t payload = st.st_size > (off_t)header_bytes
                           ? st.st_size - header_bytes : 0;
    uint64_t n = payload / record_bytes;
    int file_id = static_cast<int>(r->fds.size());
    r->fds.push_back(fd);
    for (uint64_t j = 0; j < n; ++j) {
      r->records.push_back({file_id, header_bytes + j * record_bytes});
    }
  }
  if (r->records.empty()) { delete r; return nullptr; }
  int nt = threads < 1 ? 1 : threads;
  r->running = nt;
  for (int i = 0; i < nt; ++i) {
    r->workers.emplace_back([r] { r->worker(); });
  }
  return r;
}

int64_t shardio_num_records(void* h) {
  return static_cast<Reader*>(h)->records.size();
}

int64_t shardio_next(void* h, void* out) {
  auto* r = static_cast<Reader*>(h);
  std::unique_lock<std::mutex> l(r->mu);
  r->cv_ready.wait(l, [&] {
    return r->stop || !r->ready.empty() || r->running == 0;
  });
  if (r->ready.empty()) return -1;
  Batch b = std::move(r->ready.front());
  r->ready.pop_front();
  r->cv_space.notify_one();
  l.unlock();
  memcpy(out, b.data.data(), b.data.size());
  return b.first_index;
}

void shardio_close(void* h) { delete static_cast<Reader*>(h); }

}  // extern "C"
