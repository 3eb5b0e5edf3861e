// Host-side async file I/O for the NVMe tier (the ZeRO-Infinity swap layer).
//
// A copy of the JAX package's engine (csrc/aio/dstpu_aio.cpp), built for the
// PyTorch port by deepspeed_tpu_torch/ops/op_builder.py (build_host) with
// g++ into build/deepspeed_tpu_torch/. Reference: csrc/aio/py_lib/
// py_ds_aio.cpp (aio_handle: pread/pwrite + async_* + wait over a libaio
// O_DIRECT engine with a pinned-buffer thread pool). The card never touches
// these files: the swap traffic is host memory <-> disk, into pinned host
// tensors that the port copies to and from the device on its own streams.
// A portable pthread pool over pread(2)/pwrite(2) (O_DIRECT attempted,
// buffered fallback) gives the same API and overlap without libaio.
//
// Exposed as a plain C ABI consumed via ctypes (deepspeed_tpu_torch/ops/
// aio.py); no pybind, no PyTorch headers.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -o libdstpu_aio.so dstpu_aio.cpp -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Task {
  int64_t ticket;
  bool write;
  std::string path;
  void *buf;
  int64_t size;
  int64_t offset;
};

// One I/O attempt: open -> full pread/pwrite loop -> close. 0 on success.
// A short READ (EOF before the buffer is full) is an error too: callers
// always know the exact byte count, so a truncated swap file must surface
// instead of leaving uninitialized tail bytes. Durability (fsync) is a
// separate explicit barrier (dstpu_aio_fsync) so N tasks on one file don't
// serialize on N flushes.
int do_io_once(const Task &t, bool odirect) {
  int flags = t.write ? (O_WRONLY | O_CREAT) : O_RDONLY;
#ifdef O_DIRECT
  if (odirect)
    flags |= O_DIRECT;
#endif
  int fd = ::open(t.path.c_str(), flags, 0644);
  if (fd < 0)
    return -1;
  char *p = static_cast<char *>(t.buf);
  int64_t left = t.size, off = t.offset;
  while (left > 0) {
    ssize_t n = t.write ? ::pwrite(fd, p, left, off) : ::pread(fd, p, left, off);
    if (n < 0) {
      ::close(fd);
      return -1;
    }
    if (n == 0)
      break; // EOF on read
    p += n;
    off += n;
    left -= n;
  }
  ::close(fd);
  return (left != 0) ? -1 : 0;
}

int do_io(const Task &t, bool use_odirect) {
  if (use_odirect) {
    // O_DIRECT can fail at open() (fs refuses) OR at pread/pwrite (EINVAL on
    // unaligned buffer/size/offset); either way fall back to buffered.
    if (do_io_once(t, true) == 0)
      return 0;
  }
  return do_io_once(t, false);
}

struct Handle {
  explicit Handle(int n_threads, bool odirect)
      : use_odirect(odirect), next_ticket(1), stopping(false) {
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { this->run(); });
  }

  ~Handle() {
    {
      std::unique_lock<std::mutex> lk(mu);
      stopping = true;
    }
    cv.notify_all();
    for (auto &w : workers)
      w.join();
  }

  int64_t submit(bool write, const char *path, void *buf, int64_t size,
                 int64_t offset) {
    std::unique_lock<std::mutex> lk(mu);
    int64_t ticket = next_ticket++;
    queue.push_back(Task{ticket, write, path, buf, size, offset});
    pending.emplace(ticket, 1); // 1 = in flight
    cv.notify_one();
    return ticket;
  }

  // Blocks until the ticket completes; returns its status (0 ok, -1 error,
  // -2 never submitted). Failures survive a wait_all drain: that path moves
  // them into drained_failed so each failed ticket still reports -1 to its
  // own waiter exactly once.
  int wait(int64_t ticket) {
    std::unique_lock<std::mutex> lk(mu);
    if (ticket <= 0 || ticket >= next_ticket)
      return -2;
    done_cv.wait(lk, [&] {
      auto it = pending.find(ticket);
      return it == pending.end() || it->second != 1;
    });
    auto it = pending.find(ticket);
    if (it == pending.end()) {
      auto f = drained_failed.find(ticket);
      if (f != drained_failed.end()) {
        drained_failed.erase(f);
        return -1;
      }
      return 0; // drained earlier by wait_all, successfully
    }
    int st = it->second == 0 ? 0 : -1;
    pending.erase(it);
    return st;
  }

  int wait_all() {
    std::unique_lock<std::mutex> lk(mu);
    done_cv.wait(lk, [&] {
      for (auto &kv : pending)
        if (kv.second == 1)
          return false;
      return true;
    });
    int st = 0;
    for (auto &kv : pending)
      if (kv.second != 0) {
        st = -1;
        drained_failed.insert(kv.first);
      }
    pending.clear();
    return st;
  }

private:
  void run() {
    for (;;) {
      Task t;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stopping || !queue.empty(); });
        if (stopping && queue.empty())
          return;
        t = std::move(queue.front());
        queue.pop_front();
      }
      int st = do_io(t, use_odirect);
      {
        std::unique_lock<std::mutex> lk(mu);
        pending[t.ticket] = (st == 0) ? 0 : 2;
      }
      done_cv.notify_all();
    }
  }

  bool use_odirect;
  std::mutex mu;
  std::condition_variable cv, done_cv;
  std::deque<Task> queue;
  std::unordered_map<int64_t, int> pending; // 1 in-flight, 0 ok, 2 error
  std::unordered_set<int64_t> drained_failed; // failures drained by wait_all
  std::vector<std::thread> workers;
  int64_t next_ticket;
  bool stopping;
};

} // namespace

extern "C" {

void *dstpu_aio_new(int n_threads, int use_odirect) {
  if (n_threads <= 0)
    n_threads = 4;
  return new Handle(n_threads, use_odirect != 0);
}

void dstpu_aio_free(void *h) { delete static_cast<Handle *>(h); }

int64_t dstpu_aio_submit_read(void *h, const char *path, void *buf,
                              int64_t size, int64_t offset) {
  return static_cast<Handle *>(h)->submit(false, path, buf, size, offset);
}

int64_t dstpu_aio_submit_write(void *h, const char *path, void *buf,
                               int64_t size, int64_t offset) {
  return static_cast<Handle *>(h)->submit(true, path, buf, size, offset);
}

int dstpu_aio_wait(void *h, int64_t ticket) {
  return static_cast<Handle *>(h)->wait(ticket);
}

int dstpu_aio_wait_all(void *h) { return static_cast<Handle *>(h)->wait_all(); }

// Synchronous convenience (submit + wait).
int dstpu_aio_pread(void *h, const char *path, void *buf, int64_t size,
                    int64_t offset) {
  Handle *hd = static_cast<Handle *>(h);
  return hd->wait(hd->submit(false, path, buf, size, offset));
}

int dstpu_aio_pwrite(void *h, const char *path, void *buf, int64_t size,
                     int64_t offset) {
  Handle *hd = static_cast<Handle *>(h);
  return hd->wait(hd->submit(true, path, buf, size, offset));
}

// Durability barrier: one fsync per file, called by the host after draining
// the writes it cares about (pipelined_optimizer_swapper semantics). fsync
// failure (ENOSPC/EIO) is reported, not swallowed.
int dstpu_aio_fsync(const char *path) {
  int fd = ::open(path, O_RDWR);
  if (fd < 0)
    return -1;
  int rc = ::fsync(fd);
  ::close(fd);
  return rc == 0 ? 0 : -1;
}

} // extern "C"
