// rs_native_io — striped file IO for the host side of the file pipeline.
//
// The host staging copies of the reference encoder (encode.cu:389-398) as
// preads and pwrites between the filesystem and host buffers: the k rows of
// an encode segment from one file (rs_stripe_read), the k rows of a decode
// segment from k chunk files (rs_gather_rows), and the p parity rows of a
// segment to p chunk files (rs_scatter_write).  The destination of a read
// may be pinned memory, so a segment lands where the H2D copy reads it.
//
// The rows of a call are independent (distinct fds or offsets), so they fan
// out over a few std::thread workers; one thread copies a page-cache or
// tmpfs row at a few GB/s, well below the card's copy engines.  A short
// read or write fails the whole call: zero-filled data would encode wrong
// parity or decode wrong bytes.  Plain extern "C" for ctypes.

#include <fcntl.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Threads for one call of `rows` rows and `total_bytes` bytes.  Threading
// pays only when the volume dwarfs a thread's start (~50 us); below 1 MiB
// the serial loop wins.  RS_NATIVE_IO_THREADS caps the pool (0/1 = serial);
// the page-cache copy saturates well before all cores, so the default cap
// is 8.
int io_threads(int rows, long long total_bytes) {
  if (rows < 2 || total_bytes < (1 << 20)) return 1;
  int cap = 8;
  if (const char* env = std::getenv("RS_NATIVE_IO_THREADS")) {
    cap = std::atoi(env);
    if (cap < 1) cap = 1;
  }
  unsigned hw = std::thread::hardware_concurrency();
  int nt = hw ? static_cast<int>(hw) : 1;
  if (nt > cap) nt = cap;
  return nt < rows ? nt : rows;
}

// fn(row) over rows 0..k-1 on nt threads, round-robin (rows are of about
// one size).  fn returns false on failure; a failure fails the call, and
// the workers finish their current row and stop.  Stride 0 runs on the
// calling thread.
template <typename Fn>
bool run_rows(int k, int nt, Fn fn) {
  if (nt <= 1) {
    for (int i = 0; i < k; ++i)
      if (!fn(i)) return false;
    return true;
  }
  std::atomic<bool> ok{true};
  std::vector<std::thread> workers;
  workers.reserve(nt - 1);
  for (int w = 1; w < nt; ++w) {
    workers.emplace_back([&, w]() {
      for (int i = w; i < k && ok.load(std::memory_order_relaxed); i += nt)
        if (!fn(i)) ok.store(false, std::memory_order_relaxed);
    });
  }
  for (int i = 0; i < k && ok.load(std::memory_order_relaxed); i += nt)
    if (!fn(i)) ok.store(false, std::memory_order_relaxed);
  for (auto& th : workers) th.join();
  return ok.load();
}

}  // namespace

extern "C" {

// The k stripe rows of a file segment into dst[k x cols]: row i is bytes
// [i*chunk + off, i*chunk + off + cols) of the file, cut at the chunk's end
// and at total_size, and zero-padded.  Returns the bytes read, or -1 when
// the file cannot be opened or ends before total_size.
long long rs_stripe_read(const char* path, uint8_t* dst, long long chunk,
                         int k, long long off, long long cols,
                         long long total_size) {
  const int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  // pread carries its own offset, so the rows share one fd.
  std::atomic<long long> got_total{0};
  const bool ok = run_rows(k, io_threads(k, static_cast<long long>(k) * cols),
                           [&](int i) {
    uint8_t* row = dst + static_cast<long long>(i) * cols;
    const long long lo = static_cast<long long>(i) * chunk + off;
    long long hi = lo + cols;
    const long long chunk_end = static_cast<long long>(i + 1) * chunk;
    if (hi > chunk_end) hi = chunk_end;
    if (hi > total_size) hi = total_size;
    long long want = hi - lo;
    if (want < 0) want = 0;
    long long done = 0;
    while (done < want) {
      const ssize_t n = pread(fd, row + done, static_cast<size_t>(want - done),
                              lo + done);
      if (n <= 0) return false;
      done += n;
    }
    got_total.fetch_add(done, std::memory_order_relaxed);
    if (done < cols) std::memset(row + done, 0, static_cast<size_t>(cols - done));
    return true;
  });
  close(fd);
  return ok ? got_total.load() : -1;
}

// cols bytes at offset off of each of k open chunk files into dst[k x cols].
// A chunk file holds the whole chunk, so a short read is an error.  Returns
// 0, or -1 on any failed or short read.
int rs_gather_rows(const int* fds, uint8_t* dst, int k, long long off,
                   long long cols) {
  const bool ok = run_rows(k, io_threads(k, static_cast<long long>(k) * cols),
                           [&](int i) {
    uint8_t* row = dst + static_cast<long long>(i) * cols;
    long long done = 0;
    while (done < cols) {
      const ssize_t n = pread(fds[i], row + done,
                              static_cast<size_t>(cols - done), off + done);
      if (n <= 0) return false;
      done += n;
    }
    return true;
  });
  return ok ? 0 : -1;
}

// The p rows of src[p x cols] to p open files at offset off.  Returns 0, or
// -1 on a failed or short write.
int rs_scatter_write(const int* fds, const uint8_t* src, int p,
                     long long cols, long long off) {
  const bool ok = run_rows(p, io_threads(p, static_cast<long long>(p) * cols),
                           [&](int i) {
    const uint8_t* row = src + static_cast<long long>(i) * cols;
    long long done = 0;
    while (done < cols) {
      const ssize_t n = pwrite(fds[i], row + done,
                               static_cast<size_t>(cols - done), off + done);
      if (n <= 0) return false;
      done += n;
    }
    return true;
  });
  return ok ? 0 : -1;
}

}  // extern "C"
