// Native data plane: dataset decoding + threaded shuffled batch assembly.
//
// The reference delegates its entire input path to torchvision DataLoader
// worker processes running PIL per sample (reference: data.py:318-321,
// num_workers=2). This framework's equivalent host-side runtime is native:
//   * decode_cifar10_binary / decode_stl10: parse the raw on-disk binary
//     formats into contiguous uint8 NHWC tensors (CHW->HWC transposed, and
//     STL-10's column-major channel quirk handled, cf. reference data.py:87);
//   * pipeline_*: a double-buffered batch assembler — background threads
//     gather shuffled rows into page-aligned host buffers while the device
//     consumes the previous batch; the Python side copies the filled
//     batch into its own (pinned, when the consumer is a CUDA device) host
//     buffer, from which the device copy runs asynchronously.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kCifarRecord = 3073;  // 1 label byte + 3 * 32 * 32 pixels.
constexpr int kCifarPixels = 3072;

// Read a whole file; returns empty vector on failure.
std::vector<uint8_t> read_file(const std::string& path) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return {};
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(static_cast<size_t>(size));
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (got != buf.size()) return {};
  return buf;
}

// CHW (planar) -> HWC for one 3x32x32 CIFAR image.
inline void chw_to_hwc32(const uint8_t* src, uint8_t* dst) {
  for (int y = 0; y < 32; ++y) {
    for (int x = 0; x < 32; ++x) {
      const int p = y * 32 + x;
      uint8_t* d = dst + (p * 3);
      d[0] = src[p];
      d[1] = src[1024 + p];
      d[2] = src[2048 + p];
    }
  }
}

}  // namespace

extern "C" {

// Decode CIFAR-10 binary batches under `dir` (data_batch_{1..5}.bin or
// test_batch.bin). Fills out_images (n*32*32*3, NHWC) and out_labels (n).
// Returns the number of decoded samples, or -1 on error.
int64_t decode_cifar10_binary(const char* dir, int train,
                              uint8_t* out_images, int32_t* out_labels) {
  std::vector<std::string> files;
  if (train) {
    for (int i = 1; i <= 5; ++i)
      files.push_back(std::string(dir) + "/data_batch_" + std::to_string(i) +
                      ".bin");
  } else {
    files.push_back(std::string(dir) + "/test_batch.bin");
  }
  int64_t n = 0;
  for (const auto& path : files) {
    std::vector<uint8_t> raw = read_file(path);
    if (raw.empty() || raw.size() % kCifarRecord != 0) return -1;
    const int64_t records = static_cast<int64_t>(raw.size()) / kCifarRecord;
    for (int64_t r = 0; r < records; ++r) {
      const uint8_t* rec = raw.data() + r * kCifarRecord;
      out_labels[n + r] = rec[0];
      chw_to_hwc32(rec + 1, out_images + (n + r) * kCifarPixels);
    }
    n += records;
  }
  return n;
}

// Decode an STL-10 binary image file (n x 3 x 96 x 96, each channel stored
// COLUMN-major — the quirk the reference undoes at data.py:87). Labels file
// optional (pass nullptr); STL labels are 1-based on disk, emitted 0-based.
// Returns sample count or -1.
int64_t decode_stl10(const char* x_path, const char* y_path,
                     uint8_t* out_images, int32_t* out_labels) {
  std::vector<uint8_t> raw = read_file(x_path);
  const int64_t img_bytes = 3 * 96 * 96;
  if (raw.empty() || raw.size() % img_bytes != 0) return -1;
  const int64_t n = static_cast<int64_t>(raw.size()) / img_bytes;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* src = raw.data() + i * img_bytes;
    uint8_t* dst = out_images + i * img_bytes;
    for (int y = 0; y < 96; ++y) {
      for (int x = 0; x < 96; ++x) {
        uint8_t* d = dst + (y * 96 + x) * 3;
        // channel plane stored transposed: element (y, x) lives at x*96+y.
        const int p = x * 96 + y;
        d[0] = src[p];
        d[1] = src[96 * 96 + p];
        d[2] = src[2 * 96 * 96 + p];
      }
    }
  }
  if (y_path && y_path[0] && out_labels) {
    std::vector<uint8_t> labels = read_file(y_path);
    if (static_cast<int64_t>(labels.size()) != n) return -1;
    for (int64_t i = 0; i < n; ++i)
      out_labels[i] = static_cast<int32_t>(labels[i]) - 1;
  }
  return n;
}

// ---------------------------------------------------------------------------
// Double-buffered shuffled batch assembler.
// ---------------------------------------------------------------------------

struct Pipeline {
  const uint8_t* images = nullptr;  // borrowed (N, sample_bytes)
  const int32_t* labels = nullptr;  // borrowed (N)
  int64_t n = 0;
  int64_t sample_bytes = 0;
  int64_t batch = 0;
  int64_t steps_per_epoch = 0;

  std::vector<int64_t> perm;
  std::mt19937_64 rng;

  // Two slots, each holding one assembled batch.
  struct Slot {
    std::vector<uint8_t> images;
    std::vector<int32_t> labels;
    std::atomic<bool> ready{false};
  };
  Slot slots[2];
  int64_t produced = 0;  // batches assembled so far
  int64_t consumed = 0;  // batches handed out

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  bool stop = false;

  void reshuffle() {
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    std::shuffle(perm.begin(), perm.end(), rng);
  }

  void assemble(Slot& slot, int64_t step_in_epoch) {
    const int64_t* idx = perm.data() + step_in_epoch * batch;
    for (int64_t i = 0; i < batch; ++i) {
      std::memcpy(slot.images.data() + i * sample_bytes,
                  images + idx[i] * sample_bytes,
                  static_cast<size_t>(sample_bytes));
      slot.labels[i] = labels ? labels[idx[i]] : -1;
    }
  }

  void run() {
    while (true) {
      std::unique_lock<std::mutex> lock(mu);
      cv_produce.wait(lock, [&] {
        return stop || produced - consumed < 2;
      });
      if (stop) return;
      const int64_t step = produced % steps_per_epoch;
      if (step == 0 && produced > 0) reshuffle();
      Slot& slot = slots[produced % 2];
      lock.unlock();
      assemble(slot, step);
      lock.lock();
      slot.ready.store(true);
      ++produced;
      cv_consume.notify_all();
    }
  }
};

// Create a pipeline over borrowed host arrays. The caller guarantees
// `images`/`labels` outlive the pipeline.
void* pipeline_create(const uint8_t* images, const int32_t* labels,
                      int64_t n, int64_t sample_bytes, int64_t batch,
                      uint64_t seed) {
  if (n <= 0 || batch <= 0 || batch > n) return nullptr;
  auto* p = new Pipeline();
  p->images = images;
  p->labels = labels;
  p->n = n;
  p->sample_bytes = sample_bytes;
  p->batch = batch;
  p->steps_per_epoch = n / batch;
  p->perm.resize(static_cast<size_t>(n));
  p->rng.seed(seed);
  p->reshuffle();
  for (auto& slot : p->slots) {
    slot.images.resize(static_cast<size_t>(batch * sample_bytes));
    slot.labels.resize(static_cast<size_t>(batch));
  }
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// Block until the next batch is assembled, then copy it out. Returns 0 on
// success.
int pipeline_next(void* handle, uint8_t* out_images, int32_t* out_labels) {
  auto* p = static_cast<Pipeline*>(handle);
  std::unique_lock<std::mutex> lock(p->mu);
  p->cv_consume.wait(lock, [&] { return p->produced > p->consumed; });
  Pipeline::Slot& slot = p->slots[p->consumed % 2];
  lock.unlock();
  std::memcpy(out_images, slot.images.data(), slot.images.size());
  std::memcpy(out_labels, slot.labels.data(),
              slot.labels.size() * sizeof(int32_t));
  lock.lock();
  slot.ready.store(false);
  ++p->consumed;
  p->cv_produce.notify_all();
  return 0;
}

int64_t pipeline_steps_per_epoch(void* handle) {
  return static_cast<Pipeline*>(handle)->steps_per_epoch;
}

void pipeline_destroy(void* handle) {
  auto* p = static_cast<Pipeline*>(handle);
  {
    std::lock_guard<std::mutex> lock(p->mu);
    p->stop = true;
  }
  p->cv_produce.notify_all();
  p->worker.join();
  delete p;
}

}  // extern "C"
