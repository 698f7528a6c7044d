// FwRecords native loader: mmap reader + deterministic crop-batch assembly.
//
// TPU-native equivalent of the tf.data C++ pipeline the reference delegates
// to (/root/reference/dataset.py:21-28): random aligned crops of (audio,
// mel) pairs assembled into contiguous batch buffers off the Python GIL,
// with a background producer thread keeping a bounded queue of ready
// batches.  Bound from Python via ctypes (flowavenet_tpu/data/native_loader.py).
//
// Record format: see flowavenet_tpu/data/records.py (FWRECv1).
// Sampling is counter-based on (seed, step) like the Python CropDataset so
// resume is deterministic; the PRNG is splitmix64 (not numpy Philox, so the
// native and Python loaders are each deterministic but not bit-identical to
// one another).

#include <atomic>
#include <condition_variable>
#include <cstdint>
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

namespace {

constexpr char kMagic[8] = {'F', 'W', 'R', 'E', 'C', 'v', '1', '\0'};

struct RecordMeta {
  int64_t audio_len;
  int64_t mel_frames;
  int64_t mel_bins;
  int64_t speaker_id;
  uint64_t offset;  // offset of header start
};

// splitmix64: fast, high-quality counter-based mixing.
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97f4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct Batch {
  uint64_t step;
  std::vector<float> audio;
  std::vector<float> mel;
  std::vector<int32_t> sid;
};

struct Loader {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::vector<RecordMeta> meta;
  int64_t mel_bins = 0;

  // prefetch state
  std::thread producer;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::deque<Batch> queue;
  size_t depth = 0;
  std::atomic<bool> stop{false};
  uint64_t seed = 0, next_step = 0;
  int batch = 0, mel_crop = 0, hop = 0;

  ~Loader() {
    stop_prefetch();
    if (base) munmap(const_cast<uint8_t*>(base), size);
    if (fd >= 0) close(fd);
  }

  void stop_prefetch() {
    stop.store(true);
    cv_put.notify_all();
    cv_get.notify_all();
    if (producer.joinable()) producer.join();
    {
      std::lock_guard<std::mutex> l(mu);
      queue.clear();
    }
    stop.store(false);
  }

  // Every in-range crop assumes audio_len >= mel_frames * hop (the writer
  // contract, records.py).  A record violating it would make fill_with read
  // the NEXT record's header bytes as audio — fail loudly instead.
  int64_t first_misaligned(int hop_) const {
    for (size_t i = 0; i < meta.size(); ++i)
      if (meta[i].audio_len < meta[i].mel_frames * int64_t(hop_))
        return int64_t(i);
    return -1;
  }

  void fill_with(uint64_t seed_, uint64_t step, int batch_, int mel_crop_,
                 int hop_, float* audio_out, float* mel_out,
                 int32_t* sid_out) const {
    const int64_t time_crop = int64_t(mel_crop_) * hop_;
    const size_t n = meta.size();
    for (int b = 0; b < batch_; ++b) {
      // counter-based draws: (seed, step, slot, draw)
      uint64_t k0 = splitmix64(seed_ ^ splitmix64(step) ^
                               splitmix64(uint64_t(b) << 32));
      const RecordMeta& m = meta[k0 % n];
      float* adst = audio_out + size_t(b) * time_crop;
      float* mdst = mel_out + size_t(b) * mel_crop_ * mel_bins;
      const uint8_t* rec = base + m.offset + 32;  // skip header
      const float* asrc = reinterpret_cast<const float*>(rec);
      const float* msrc =
          reinterpret_cast<const float*>(rec + m.audio_len * 4);
      int64_t avail = m.mel_frames - mel_crop_;
      if (avail > 0) {
        int64_t start = int64_t(splitmix64(k0) % uint64_t(avail));
        std::memcpy(adst, asrc + start * hop_, time_crop * 4);
        std::memcpy(mdst, msrc + start * mel_bins,
                    size_t(mel_crop_) * mel_bins * 4);
      } else {
        // short clip: copy everything, zero-pad the tail (the reference
        // crashes here, train.py:241-243)
        int64_t f = std::min<int64_t>(m.mel_frames, mel_crop_);
        int64_t t = std::min<int64_t>(m.audio_len, f * hop_);
        std::memset(adst, 0, time_crop * 4);
        std::memset(mdst, 0, size_t(mel_crop_) * mel_bins * 4);
        std::memcpy(adst, asrc, t * 4);
        std::memcpy(mdst, msrc, size_t(f) * mel_bins * 4);
      }
      sid_out[b] = int32_t(m.speaker_id);
    }
  }

  void produce_loop() {
    const int64_t time_crop = int64_t(mel_crop) * hop;
    while (!stop.load()) {
      Batch out;
      {
        std::unique_lock<std::mutex> l(mu);
        cv_put.wait(l, [&] { return stop.load() || queue.size() < depth; });
        if (stop.load()) return;
        out.step = next_step++;
      }
      out.audio.resize(size_t(batch) * time_crop);
      out.mel.resize(size_t(batch) * mel_crop * mel_bins);
      out.sid.resize(batch);
      fill_with(seed, out.step, batch, mel_crop, hop, out.audio.data(),
                out.mel.data(), out.sid.data());
      {
        std::lock_guard<std::mutex> l(mu);
        queue.push_back(std::move(out));
      }
      cv_get.notify_one();
    }
  }
};

}  // namespace

extern "C" {

Loader* fwrec_open(const char* data_path) {
  int fd = open(data_path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (p == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* l = new Loader();
  l->fd = fd;
  l->base = static_cast<const uint8_t*>(p);
  l->size = st.st_size;
  if (l->size < 8 || std::memcmp(l->base, kMagic, 8) != 0) {
    delete l;
    return nullptr;
  }
  // walk records sequentially (headers are self-describing; no .fwidx
  // needed on the native path)
  uint64_t off = 8;
  while (off + 32 <= l->size) {
    const int64_t* h = reinterpret_cast<const int64_t*>(l->base + off);
    RecordMeta m{h[0], h[1], h[2], h[3], off};
    uint64_t next = off + 32 + uint64_t(m.audio_len) * 4 +
                    uint64_t(m.mel_frames) * m.mel_bins * 4;
    if (m.audio_len < 0 || m.mel_frames < 0 || m.mel_bins <= 0 ||
        next > l->size)
      break;
    l->meta.push_back(m);
    off = next;
  }
  if (l->meta.empty()) {
    delete l;
    return nullptr;
  }
  l->mel_bins = l->meta[0].mel_bins;
  return l;
}

int64_t fwrec_count(Loader* l) { return l ? int64_t(l->meta.size()) : -1; }
int64_t fwrec_mel_bins(Loader* l) { return l ? l->mel_bins : -1; }

void fwrec_record_meta(Loader* l, int64_t i, int64_t* out4) {
  const RecordMeta& m = l->meta[i];
  out4[0] = m.audio_len;
  out4[1] = m.mel_frames;
  out4[2] = m.mel_bins;
  out4[3] = m.speaker_id;
}

// Synchronous deterministic batch for a given step (stateless w.r.t. the
// prefetch configuration, so it can run concurrently with it).
// Returns 0, or ~index of the first audio/mel-misaligned record.
int64_t fwrec_batch(Loader* l, uint64_t seed, uint64_t step, int batch,
                    int mel_crop, int hop, float* audio_out, float* mel_out,
                    int32_t* sid_out) {
  int64_t bad = l->first_misaligned(hop);
  if (bad >= 0) return ~bad;
  l->fill_with(seed, step, batch, mel_crop, hop, audio_out, mel_out,
               sid_out);
  return 0;
}

// Background producer: bounded queue of ready batches.
// Returns 0, or ~index of the first audio/mel-misaligned record.
int fwrec_prefetch_start(Loader* l, uint64_t seed, uint64_t start_step,
                         int batch, int mel_crop, int hop, int depth) {
  int64_t bad = l->first_misaligned(hop);
  if (bad >= 0) return int(~bad);
  l->stop_prefetch();
  l->seed = seed;
  l->next_step = start_step;
  l->batch = batch;
  l->mel_crop = mel_crop;
  l->hop = hop;
  l->depth = depth > 0 ? depth : 2;
  l->producer = std::thread([l] { l->produce_loop(); });
  return 0;
}

// Blocks until a batch is ready; returns its step.
int64_t fwrec_prefetch_next(Loader* l, float* audio_out, float* mel_out,
                            int32_t* sid_out) {
  std::unique_lock<std::mutex> lock(l->mu);
  l->cv_get.wait(lock, [&] { return l->stop.load() || !l->queue.empty(); });
  if (l->queue.empty()) return -1;
  Batch b = std::move(l->queue.front());
  l->queue.pop_front();
  lock.unlock();
  l->cv_put.notify_one();
  std::memcpy(audio_out, b.audio.data(), b.audio.size() * 4);
  std::memcpy(mel_out, b.mel.data(), b.mel.size() * 4);
  std::memcpy(sid_out, b.sid.data(), b.sid.size() * 4);
  return int64_t(b.step);
}

void fwrec_close(Loader* l) { delete l; }

}  // extern "C"
