// Native tfrecord reader: mmap + hardware CRC32C + threaded prefetch.
//
// The host side of the input pipeline in place of TF's C++ queue-runner
// input kernels (SURVEY.md §2.2 "Queue runners / threaded input"): one
// reader thread streams records from memory-mapped tfrecord files into a
// bounded queue; Python drains it through a small C API (ctypes binding in
// multibox_tpu_torch/data/_native.py, which also builds this file with g++
// at first use).
//
// Record framing (TFRecord):
//   uint64 length | uint32 masked_crc32c(length) | data | uint32 masked_crc32c(data)
// masked_crc = rotr(crc32c(x), 15) + 0xa282ead8.
//
// The records, their order and the error messages are those of the Python
// reader (data/tfrecord.py::TFRecordReader); a file that cannot be opened
// reports its errno, so that the binding raises the OSError open() would.

#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli). SSE4.2 hardware path with table fallback.
// ---------------------------------------------------------------------------

uint32_t crc32c_table[256];

struct TableInit {
  TableInit() {
    const uint32_t poly = 0x82F63B78u;
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k)
        crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
      crc32c_table[i] = crc;
    }
  }
} table_init;

uint32_t crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
#if defined(__SSE4_2__)
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, data, 8);
    crc = static_cast<uint32_t>(_mm_crc32_u64(crc, v));
    data += 8;
    n -= 8;
  }
  while (n) {
    crc = _mm_crc32_u8(crc, *data++);
    --n;
  }
#else
  for (size_t i = 0; i < n; ++i)
    crc = (crc >> 8) ^ crc32c_table[(crc ^ data[i]) & 0xFF];
#endif
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ---------------------------------------------------------------------------
// Reader
// ---------------------------------------------------------------------------

// One record's bytes, malloc'd by the reader thread and handed to the
// caller as is (freed with mbx_free_record).
struct Record {
  char* data;
  size_t size;
};

struct MappedFile {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;

  // Returns 0, or the errno of the failure.
  int open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return errno;
    struct stat st;
    if (fstat(fd, &st) != 0) return errno;
    if (S_ISDIR(st.st_mode)) return EISDIR;
    size = static_cast<size_t>(st.st_size);
    if (size == 0) {
      base = nullptr;
      return 0;
    }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) return errno;
    madvise(p, size, MADV_SEQUENTIAL);
    base = static_cast<const uint8_t*>(p);
    return 0;
  }
  ~MappedFile() {
    if (base) munmap(const_cast<uint8_t*>(base), size);
    if (fd >= 0) close(fd);
  }
};

class RecordStream {
 public:
  RecordStream(std::vector<std::string> paths, int num_threads,
               size_t queue_capacity, bool verify_crc)
      : paths_(std::move(paths)),
        capacity_(queue_capacity),
        verify_crc_(verify_crc) {
    (void)num_threads;  // single reader preserves file order; IO is mmap'd
    worker_ = std::thread([this] { Run(); });
  }

  ~RecordStream() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      cancelled_ = true;
    }
    cv_pop_.notify_all();
    cv_push_.notify_all();
    if (worker_.joinable()) worker_.join();
    for (Record& r : queue_) free(r.data);
  }

  // Returns: 1 = record (the caller owns out->data), 0 = end of stream,
  // -1 = error.
  int Next(Record* out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_pop_.wait(lk, [this] { return !queue_.empty() || done_ || cancelled_; });
    if (!queue_.empty()) {
      *out = queue_.front();
      queue_.pop_front();
      cv_push_.notify_one();
      return 1;
    }
    return failed_ ? -1 : 0;
  }

  // Read only after Next returned -1 (the worker has stopped writing).
  const std::string& error() const { return error_; }
  int error_errno() const { return error_errno_; }

 private:
  void Run() {
    for (const auto& path : paths_) {
      MappedFile f;
      if (int err = f.open(path.c_str())) {
        Fail(path, err);  // the message is the path; the binding adds errno
        return;
      }
      size_t pos = 0;
      while (pos < f.size) {
        if (f.size - pos < 12) {
          Fail("truncated record header in " + path);
          return;
        }
        uint64_t length;
        memcpy(&length, f.base + pos, 8);
        uint32_t len_crc;
        memcpy(&len_crc, f.base + pos + 8, 4);
        if (verify_crc_ && masked_crc(f.base + pos, 8) != len_crc) {
          Fail("corrupt length crc in " + path);
          return;
        }
        // Overflow-safe: `length` comes from the file; `pos+12+length+4`
        // could wrap for a corrupt huge value and pass a naive check.
        const size_t remaining = f.size - (pos + 12);
        if (remaining < 4 || length > remaining - 4) {
          Fail("truncated record body in " + path);
          return;
        }
        const uint8_t* data = f.base + pos + 12;
        uint32_t data_crc;
        memcpy(&data_crc, data + length, 4);
        if (verify_crc_ && masked_crc(data, length) != data_crc) {
          Fail("corrupt record crc in " + path);
          return;
        }
        // malloc(0) may return NULL: keep every record's pointer valid.
        char* buf = static_cast<char*>(malloc(length ? length : 1));
        memcpy(buf, data, length);
        if (!Push(Record{buf, static_cast<size_t>(length)})) {
          free(buf);
          return;  // cancelled
        }
        pos += 12 + length + 4;
      }
    }
    Finish();
  }

  bool Push(Record rec) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_push_.wait(lk, [this] { return queue_.size() < capacity_ || cancelled_; });
    if (cancelled_) return false;
    queue_.push_back(rec);
    cv_pop_.notify_one();
    return true;
  }

  void Fail(std::string msg, int err = 0) {
    std::lock_guard<std::mutex> lk(mu_);
    error_ = std::move(msg);
    error_errno_ = err;
    failed_ = true;
    done_ = true;
    cv_pop_.notify_all();
  }

  void Finish() {
    std::lock_guard<std::mutex> lk(mu_);
    done_ = true;
    cv_pop_.notify_all();
  }

  std::vector<std::string> paths_;
  size_t capacity_;
  bool verify_crc_;
  std::deque<Record> queue_;
  std::mutex mu_;
  std::condition_variable cv_pop_, cv_push_;
  bool done_ = false;
  bool failed_ = false;
  bool cancelled_ = false;
  std::string error_;
  int error_errno_ = 0;
  std::thread worker_;
};

}  // namespace

// ---------------------------------------------------------------------------
// C API (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

void* mbx_stream_open(const char** paths, int num_paths, int verify_crc,
                      int queue_capacity) {
  std::vector<std::string> v;
  v.reserve(num_paths);
  for (int i = 0; i < num_paths; ++i) v.emplace_back(paths[i]);
  return new RecordStream(std::move(v), 1,
                          queue_capacity > 0 ? queue_capacity : 256,
                          verify_crc != 0);
}

// Returns 1 and sets *data/*size on success (caller must mbx_free_record),
// 0 at end of stream, -1 on error (message via mbx_stream_error; for a
// file that cannot be opened the message is its path and mbx_stream_errno
// the errno).
int mbx_stream_next(void* stream, char** data, uint64_t* size) {
  Record rec{nullptr, 0};
  int r = static_cast<RecordStream*>(stream)->Next(&rec);
  if (r != 1) return r;
  *data = rec.data;
  *size = rec.size;
  return 1;
}

void mbx_free_record(char* data) { free(data); }

const char* mbx_stream_error(void* stream) {
  return static_cast<RecordStream*>(stream)->error().c_str();
}

int mbx_stream_errno(void* stream) {
  return static_cast<RecordStream*>(stream)->error_errno();
}

void mbx_stream_close(void* stream) {
  delete static_cast<RecordStream*>(stream);
}

uint32_t mbx_crc32c(const uint8_t* data, uint64_t n) { return crc32c(data, n); }

uint32_t mbx_masked_crc32c(const uint8_t* data, uint64_t n) {
  return masked_crc(data, n);
}

}  // extern "C"
