// Native ingest runtime for the c_ofdm modem.
//
// Host-side counterpart of the reference's SDR ingest path: the pthread +
// two-semaphore double buffer of rx.cpp:48-66 / st_rx.cpp:43-106, the int16
// staging of sdr/sdr.hpp:208-273, and the int16 -> float conversion of
// OFDM/Frame.hpp:472-516 (whose AVX2 version the reference left commented
// out).  Exposed as a C ABI for ctypes.
//
// Design: a producer thread pulls fixed-size int16-IQ buffers from a source
// (file replay, pipe/socket fd, or synthetic loop) into a lock-free-ish ring
// of slots; the consumer (Python feeding the device) pops filled slots,
// converts to float32 planar-complex in place of the copy, and recycles them.
// Conversion happens on the consumer thread at memcpy-like speed so the
// device feed path stays a single pass over the data.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include <unistd.h>

extern "C" {

struct IngestRing;

// source kinds
enum SourceKind : int32_t {
  SRC_FILE_REPLAY = 0,   // read file, loop forever
  SRC_FD_STREAM = 1,     // read(2) from a file descriptor until EOF
  SRC_SYNTH_ZERO = 2,    // zeros (throughput baseline)
};

struct IngestStats {
  uint64_t buffers_produced;
  uint64_t buffers_consumed;
  uint64_t bytes_ingested;
  uint64_t producer_waits;   // producer blocked on full ring
  uint64_t consumer_waits;   // consumer blocked on empty ring
};

}  // extern "C"

namespace {

struct Slot {
  std::vector<int16_t> data;   // interleaved IQ, 2 * samples int16
  std::atomic<bool> full{false};
};

}  // namespace

struct IngestRing {
  int64_t samples_per_buf = 0;   // complex samples per buffer
  int32_t n_slots = 0;
  int32_t kind = SRC_FILE_REPLAY;
  int fd = -1;
  FILE* file = nullptr;
  std::unique_ptr<Slot[]> slots;
  std::atomic<int64_t> head{0};  // next slot to fill (producer)
  std::atomic<int64_t> tail{0};  // next slot to drain (consumer)
  std::atomic<bool> stop{false};
  std::atomic<bool> eof{false};
  std::thread producer;
  std::mutex mu;
  std::condition_variable cv_slot_free;
  std::condition_variable cv_slot_full;
  IngestStats stats{};

  void produce_loop() {
    const size_t bytes = size_t(samples_per_buf) * 2 * sizeof(int16_t);
    while (!stop.load(std::memory_order_acquire)) {
      int64_t h = head.load(std::memory_order_relaxed);
      Slot& s = slots[h % n_slots];
      if (s.full.load(std::memory_order_acquire)) {
        std::unique_lock<std::mutex> lk(mu);
        stats.producer_waits++;
        cv_slot_free.wait_for(lk, std::chrono::milliseconds(50), [&] {
          return stop.load() || !s.full.load(std::memory_order_acquire);
        });
        continue;
      }
      size_t got = 0;
      char* dst = reinterpret_cast<char*>(s.data.data());
      if (kind == SRC_SYNTH_ZERO) {
        got = bytes;  // leave buffer as-is: pure transport benchmark
      } else if (kind == SRC_FILE_REPLAY) {
        while (got < bytes) {
          size_t r = fread(dst + got, 1, bytes - got, file);
          if (r == 0) {
            if (feof(file)) { rewind(file); continue; }
            stop.store(true); break;
          }
          got += r;
        }
      } else {  // SRC_FD_STREAM
        while (got < bytes && !stop.load()) {
          ssize_t r = ::read(fd, dst + got, bytes - got);
          if (r <= 0) { eof.store(true); stop.store(true); break; }
          got += size_t(r);
        }
        if (got < bytes) memset(dst + got, 0, bytes - got);
      }
      if (stop.load() && got == 0) break;
      stats.buffers_produced++;
      stats.bytes_ingested += got;
      s.full.store(true, std::memory_order_release);
      head.store(h + 1, std::memory_order_release);
      cv_slot_full.notify_one();
    }
    eof.store(true);
    cv_slot_full.notify_all();
  }
};

extern "C" {

IngestRing* ingest_create(int32_t kind, const char* path_or_fd,
                          int64_t samples_per_buf, int32_t n_slots) {
  auto* r = new IngestRing();
  r->samples_per_buf = samples_per_buf;
  r->n_slots = n_slots;
  r->kind = kind;
  if (kind == SRC_FILE_REPLAY) {
    r->file = fopen(path_or_fd, "rb");
    if (!r->file) { delete r; return nullptr; }
  } else if (kind == SRC_FD_STREAM) {
    r->fd = atoi(path_or_fd);
  }
  r->slots = std::make_unique<Slot[]>(size_t(n_slots));
  for (int32_t i = 0; i < n_slots; ++i)
    r->slots[i].data.resize(size_t(samples_per_buf) * 2);
  r->producer = std::thread([r] { r->produce_loop(); });
  return r;
}

// Pop one filled buffer, converting int16 IQ -> float32 interleaved into out
// (length 2*samples_per_buf floats).  Returns 1 on success, 0 on EOF/stop,
// -1 on timeout.
int32_t ingest_pop_f32(IngestRing* r, float* out, int32_t timeout_ms) {
  int64_t t = r->tail.load(std::memory_order_relaxed);
  Slot& s = r->slots[t % r->n_slots];
  if (!s.full.load(std::memory_order_acquire)) {
    std::unique_lock<std::mutex> lk(r->mu);
    r->stats.consumer_waits++;
    bool ok = r->cv_slot_full.wait_for(
        lk, std::chrono::milliseconds(timeout_ms),
        [&] { return s.full.load(std::memory_order_acquire) ||
                     r->eof.load(); });
    if (!s.full.load(std::memory_order_acquire))
      return ok && r->eof.load() ? 0 : -1;
  }
  const int16_t* src = s.data.data();
  const int64_t n = r->samples_per_buf * 2;
  // single-pass widening convert; auto-vectorizes under -O3
  for (int64_t i = 0; i < n; ++i) out[i] = float(src[i]);
  s.full.store(false, std::memory_order_release);
  r->tail.store(t + 1, std::memory_order_release);
  r->cv_slot_free.notify_one();
  r->stats.buffers_consumed++;
  return 1;
}

// Raw pop without conversion (int16 out), for transport microbenchmarks.
int32_t ingest_pop_i16(IngestRing* r, int16_t* out, int32_t timeout_ms) {
  int64_t t = r->tail.load(std::memory_order_relaxed);
  Slot& s = r->slots[t % r->n_slots];
  if (!s.full.load(std::memory_order_acquire)) {
    std::unique_lock<std::mutex> lk(r->mu);
    r->stats.consumer_waits++;
    bool ok = r->cv_slot_full.wait_for(
        lk, std::chrono::milliseconds(timeout_ms),
        [&] { return s.full.load(std::memory_order_acquire) ||
                     r->eof.load(); });
    if (!s.full.load(std::memory_order_acquire))
      return ok && r->eof.load() ? 0 : -1;
  }
  memcpy(out, s.data.data(),
         size_t(r->samples_per_buf) * 2 * sizeof(int16_t));
  s.full.store(false, std::memory_order_release);
  r->tail.store(t + 1, std::memory_order_release);
  r->cv_slot_free.notify_one();
  r->stats.buffers_consumed++;
  return 1;
}

void ingest_stats(IngestRing* r, IngestStats* out) { *out = r->stats; }

void ingest_destroy(IngestRing* r) {
  if (!r) return;
  r->stop.store(true);
  r->cv_slot_free.notify_all();
  r->cv_slot_full.notify_all();
  if (r->producer.joinable()) r->producer.join();
  if (r->file) fclose(r->file);
  delete r;
}

// Standalone conversion kernel (Frame.hpp:472-516 counterpart).
void convert_i16_to_f32(const int16_t* src, float* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) dst[i] = float(src[i]);
}

}  // extern "C"
