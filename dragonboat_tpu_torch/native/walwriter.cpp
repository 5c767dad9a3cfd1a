// Native WAL writer with group commit.
//
// reference: dragonboat's LogDB commits many shards' updates with one
// batched fsync per step-worker iteration (engine.go -> SaveRaftState
// [U]).  This writer extends that batching ACROSS worker threads: all
// appends that arrive while an fsync is in flight are coalesced into
// the next single write+fsync, and every caller blocks only until its
// own bytes are durable.  Python callers enter through ctypes, which
// releases the GIL for the duration — so a slow fsync never stalls the
// interpreter.
//
// Build: g++ -O2 -shared -fPIC -pthread -o libwalwriter.so walwriter.cpp
//
// Exposed C ABI (see native/__init__.py for the ctypes binding):
//   wal_open(path)                -> handle (NULL on error)
//   wal_append(h, buf, len, sync) -> total bytes appended so far, or -1
//   wal_size(h)                   -> bytes appended
//   wal_sync(h)                   -> 0 once everything queued is durable
//   wal_close(h)                  -> 0 (flushes + fsyncs first)

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>

namespace {

struct Wal {
  int fd = -1;
  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  std::string pending;       // bytes queued but not yet written
  uint64_t queued_seq = 0;   // ticket of the newest queued batch
  uint64_t synced_seq = 0;   // newest ticket known durable
  int64_t total = 0;         // bytes appended (queued + written)
  bool stop = false;
  bool io_error = false;
  std::thread syncer;

  void run() {
    std::string batch;
    for (;;) {
      uint64_t seq;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop || !pending.empty(); });
        if (pending.empty() && stop) return;
        batch.swap(pending);
        seq = queued_seq;
      }
      bool ok = true;
      const char* p = batch.data();
      size_t left = batch.size();
      while (left > 0) {
        ssize_t n = ::write(fd, p, left);
        if (n < 0) {
          if (errno == EINTR) continue;
          ok = false;
          break;
        }
        p += n;
        left -= static_cast<size_t>(n);
      }
      if (ok && ::fsync(fd) != 0) ok = false;
      batch.clear();
      {
        std::lock_guard<std::mutex> lk(mu);
        if (!ok) io_error = true;
        synced_seq = seq;
        cv_done.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

void* wal_open(const char* path) {
  int fd = ::open(path, O_WRONLY | O_APPEND | O_CREAT | O_CLOEXEC, 0644);
  if (fd < 0) return nullptr;
  Wal* w = new Wal();
  w->fd = fd;
  off_t sz = ::lseek(fd, 0, SEEK_END);
  w->total = sz < 0 ? 0 : static_cast<int64_t>(sz);
  w->syncer = std::thread([w] { w->run(); });
  return w;
}

int64_t wal_append(void* h, const char* buf, int64_t len, int32_t sync) {
  Wal* w = static_cast<Wal*>(h);
  uint64_t my_seq;
  int64_t total;
  {
    std::unique_lock<std::mutex> lk(w->mu);
    if (w->io_error || w->stop) return -1;
    if (len <= 0) return w->total;  // empty append must not take a ticket
    w->pending.append(buf, static_cast<size_t>(len));
    my_seq = ++w->queued_seq;
    w->total += len;
    total = w->total;
    w->cv_work.notify_one();
    if (sync) {
      w->cv_done.wait(lk, [&] { return w->synced_seq >= my_seq || w->io_error; });
      if (w->io_error) return -1;
    }
  }
  return total;
}

int64_t wal_size(void* h) {
  Wal* w = static_cast<Wal*>(h);
  std::lock_guard<std::mutex> lk(w->mu);
  return w->total;
}

int32_t wal_sync(void* h) {
  Wal* w = static_cast<Wal*>(h);
  std::unique_lock<std::mutex> lk(w->mu);
  uint64_t target = w->queued_seq;
  w->cv_work.notify_one();
  w->cv_done.wait(lk, [&] { return w->synced_seq >= target || w->io_error; });
  return w->io_error ? -1 : 0;
}

int32_t wal_close(void* h) {
  Wal* w = static_cast<Wal*>(h);
  {
    std::unique_lock<std::mutex> lk(w->mu);
    uint64_t target = w->queued_seq;
    w->cv_work.notify_one();
    w->cv_done.wait(lk, [&] { return w->synced_seq >= target || w->io_error; });
    w->stop = true;
    w->cv_work.notify_one();
  }
  w->syncer.join();
  int rc = w->io_error ? -1 : 0;
  if (w->fd >= 0) {
    ::fsync(w->fd);
    ::close(w->fd);
  }
  delete w;
  return rc;
}

}  // extern "C"
