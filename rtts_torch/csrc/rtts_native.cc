// rtts native runtime: threaded clip loader + host-side audio DSP.
//
// Host code, built with g++ (not nvcc) by rtts_torch/data/native_loader.py
// at first use: a C++ thread-pool clip loader with an LRU cache and async
// prefetch that collates padded batches directly into caller (numpy)
// buffers off the Python thread, plus wav decode / polyphase resample /
// silence trim for the offline preprocessing stage.  Everything from the
// first #include on is the JAX package's native/rtts_native.cc, byte for byte
// (tests/test_torch_copies.py), so both packages read and write the same
// clips and batches.
//
// Clip file format ".rclip" (little-endian):
//   magic  "RCLP" | u32 version=1
//   u32 n_tokens | u32 n_frames | u32 n_mels | u32 n_samples
//   i32 tokens[n_tokens]
//   f32 mel[n_frames * n_mels]
//   f32 audio[n_samples]
//
// C ABI only (consumed via ctypes).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <list>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Clip {
  std::vector<int32_t> tokens;
  std::vector<float> mel;    // n_frames * n_mels
  std::vector<float> audio;
  uint32_t n_frames = 0, n_mels = 0;
  size_t bytes() const {
    return tokens.size() * 4 + mel.size() * 4 + audio.size() * 4;
  }
};

bool read_clip(const std::string& path, Clip* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  char magic[4];
  uint32_t hdr[5];
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "RCLP", 4) != 0 ||
      std::fread(hdr, 4, 5, f) != 5 || hdr[0] != 1) {
    std::fclose(f);
    return false;
  }
  uint32_t n_tokens = hdr[1], n_frames = hdr[2], n_mels = hdr[3],
           n_samples = hdr[4];
  out->tokens.resize(n_tokens);
  out->mel.resize(size_t(n_frames) * n_mels);
  out->audio.resize(n_samples);
  out->n_frames = n_frames;
  out->n_mels = n_mels;
  bool ok =
      std::fread(out->tokens.data(), 4, n_tokens, f) == n_tokens &&
      std::fread(out->mel.data(), 4, out->mel.size(), f) == out->mel.size() &&
      std::fread(out->audio.data(), 4, n_samples, f) == n_samples;
  std::fclose(f);
  return ok;
}

class Loader {
 public:
  Loader(std::vector<std::string> paths, int n_workers, size_t cache_bytes)
      : paths_(std::move(paths)), cache_cap_(cache_bytes), stop_(false) {
    n_workers = std::max(1, n_workers);
    for (int i = 0; i < n_workers; ++i)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void Prefetch(const int* indices, int n) {
    std::lock_guard<std::mutex> lk(mu_);
    for (int i = 0; i < n; ++i) {
      int idx = indices[i];
      if (idx < 0 || size_t(idx) >= paths_.size()) continue;
      if (cache_.count(idx) || pending_.count(idx)) continue;
      pending_.insert({idx, true});
      queue_.push_back(idx);
    }
    cv_.notify_all();
  }

  // Blocking fetch: returns shared_ptr to the clip (loads inline on miss).
  std::shared_ptr<Clip> Get(int idx) {
    if (idx < 0 || size_t(idx) >= paths_.size()) return nullptr;
    {
      std::unique_lock<std::mutex> lk(mu_);
      auto it = cache_.find(idx);
      if (it != cache_.end()) {
        Touch(idx);
        return it->second.clip;
      }
      if (pending_.count(idx)) {
        // a worker is on it; wait for completion
        done_cv_.wait(lk, [&] { return cache_.count(idx) || !pending_.count(idx); });
        auto it2 = cache_.find(idx);
        if (it2 != cache_.end()) {
          Touch(idx);
          return it2->second.clip;
        }
      }
    }
    // load inline
    auto clip = std::make_shared<Clip>();
    if (!read_clip(paths_[idx], clip.get())) return nullptr;
    Insert(idx, clip);
    return clip;
  }

  int64_t cache_hits() const { return hits_.load(); }
  int64_t cache_misses() const { return misses_.load(); }

 private:
  struct Entry {
    std::shared_ptr<Clip> clip;
    std::list<int>::iterator lru_it;
  };

  void WorkerLoop() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || !queue_.empty(); });
        if (stop_) return;
        idx = queue_.front();
        queue_.pop_front();
      }
      auto clip = std::make_shared<Clip>();
      bool ok = read_clip(paths_[idx], clip.get());
      {
        std::lock_guard<std::mutex> lk(mu_);
        pending_.erase(idx);
        if (ok) InsertLocked(idx, clip);
      }
      done_cv_.notify_all();
    }
  }

  void Insert(int idx, std::shared_ptr<Clip> clip) {
    std::lock_guard<std::mutex> lk(mu_);
    InsertLocked(idx, std::move(clip));
  }

  void InsertLocked(int idx, std::shared_ptr<Clip> clip) {
    if (cache_.count(idx)) return;
    cache_size_ += clip->bytes();
    lru_.push_front(idx);
    cache_[idx] = {std::move(clip), lru_.begin()};
    while (cache_size_ > cache_cap_ && lru_.size() > 1) {
      int victim = lru_.back();
      lru_.pop_back();
      auto it = cache_.find(victim);
      if (it != cache_.end()) {
        cache_size_ -= it->second.clip->bytes();
        cache_.erase(it);
      }
    }
  }

  void Touch(int idx) {
    auto it = cache_.find(idx);
    if (it == cache_.end()) return;
    lru_.erase(it->second.lru_it);
    lru_.push_front(idx);
    it->second.lru_it = lru_.begin();
    hits_.fetch_add(1);
  }

  std::vector<std::string> paths_;
  size_t cache_cap_;
  size_t cache_size_ = 0;
  std::unordered_map<int, Entry> cache_;
  std::unordered_map<int, bool> pending_;
  std::list<int> lru_;
  std::deque<int> queue_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::atomic<bool> stop_;
  std::atomic<int64_t> hits_{0}, misses_{0};
};

}  // namespace

extern "C" {

void* rtts_loader_create(const char* const* paths, int n_clips, int n_workers,
                         int64_t cache_bytes) {
  std::vector<std::string> p(paths, paths + n_clips);
  return new Loader(std::move(p), n_workers, size_t(cache_bytes));
}

void rtts_loader_destroy(void* loader) { delete static_cast<Loader*>(loader); }

void rtts_loader_prefetch(void* loader, const int* indices, int n) {
  static_cast<Loader*>(loader)->Prefetch(indices, n);
}

// Collate a padded TTS batch directly into caller buffers.
// tokens: (bsz, t_pad) i32; tmask: (bsz, t_pad) u8;
// mel: (bsz, m_pad, n_mels) f32; mmask: (bsz, m_pad) u8.
// Returns 0 on success, -1 on any failed clip.
int rtts_loader_fill_batch(void* loader, const int* indices, int bsz,
                           int t_pad, int m_pad, int n_mels, int32_t* tokens,
                           uint8_t* tmask, float* mel, uint8_t* mmask) {
  Loader* L = static_cast<Loader*>(loader);
  std::memset(tokens, 0, sizeof(int32_t) * bsz * t_pad);
  std::memset(tmask, 0, sizeof(uint8_t) * bsz * t_pad);
  std::memset(mel, 0, sizeof(float) * size_t(bsz) * m_pad * n_mels);
  std::memset(mmask, 0, sizeof(uint8_t) * bsz * m_pad);
  for (int r = 0; r < bsz; ++r) {
    auto clip = L->Get(indices[r]);
    if (!clip || int(clip->n_mels) != n_mels) return -1;
    int nt = std::min<int>(clip->tokens.size(), t_pad);
    std::memcpy(tokens + size_t(r) * t_pad, clip->tokens.data(),
                sizeof(int32_t) * nt);
    std::memset(tmask + size_t(r) * t_pad, 1, nt);
    int nf = std::min<int>(clip->n_frames, m_pad);
    std::memcpy(mel + (size_t(r) * m_pad) * n_mels, clip->mel.data(),
                sizeof(float) * size_t(nf) * n_mels);
    std::memset(mmask + size_t(r) * m_pad, 1, nf);
  }
  return 0;
}

// Vocoder crops: per row, copy `frames` mel frames starting at
// frame_offsets[r] and the matching `frames*hop` audio samples.
int rtts_loader_fill_crops(void* loader, const int* indices,
                           const int* frame_offsets, int bsz, int frames,
                           int hop, int n_mels, float* mel, float* audio) {
  Loader* L = static_cast<Loader*>(loader);
  for (int r = 0; r < bsz; ++r) {
    auto clip = L->Get(indices[r]);
    if (!clip || int(clip->n_mels) != n_mels) return -1;
    int f0 = frame_offsets[r];
    if (f0 < 0 || uint32_t(f0 + frames) > clip->n_frames) return -2;
    std::memcpy(mel + size_t(r) * frames * n_mels,
                clip->mel.data() + size_t(f0) * n_mels,
                sizeof(float) * size_t(frames) * n_mels);
    size_t s0 = size_t(f0) * hop, ns = size_t(frames) * hop;
    if (s0 + ns > clip->audio.size()) return -3;
    std::memcpy(audio + size_t(r) * ns, clip->audio.data() + s0,
                sizeof(float) * ns);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Host-side audio DSP (offline preprocessing)
// ---------------------------------------------------------------------------

// 16-bit PCM wav decode (mono-mixdown). Returns n_samples or -1.
int64_t rtts_wav_read_pcm16(const char* path, float** out_samples,
                            int* out_rate) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  auto fail = [&]() -> int64_t {
    std::fclose(f);
    return -1;
  };
  char riff[4], wave[4];
  uint32_t size;
  if (std::fread(riff, 1, 4, f) != 4 || std::memcmp(riff, "RIFF", 4) ||
      std::fread(&size, 4, 1, f) != 1 || std::fread(wave, 1, 4, f) != 4 ||
      std::memcmp(wave, "WAVE", 4))
    return fail();
  uint16_t channels = 0, bits = 0;
  uint32_t rate = 0;
  std::vector<int16_t> pcm;
  for (;;) {
    char id[4];
    uint32_t chunk_size;
    if (std::fread(id, 1, 4, f) != 4 || std::fread(&chunk_size, 4, 1, f) != 1)
      break;
    if (!std::memcmp(id, "fmt ", 4)) {
      uint16_t fmt;
      uint32_t byte_rate;
      uint16_t block_align;
      if (std::fread(&fmt, 2, 1, f) != 1 || std::fread(&channels, 2, 1, f) != 1 ||
          std::fread(&rate, 4, 1, f) != 1 || std::fread(&byte_rate, 4, 1, f) != 1 ||
          std::fread(&block_align, 2, 1, f) != 1 || std::fread(&bits, 2, 1, f) != 1)
        return fail();
      std::fseek(f, chunk_size - 16, SEEK_CUR);
      if (fmt != 1 || bits != 16) return fail();
    } else if (!std::memcmp(id, "data", 4)) {
      pcm.resize(chunk_size / 2);
      if (std::fread(pcm.data(), 2, pcm.size(), f) != pcm.size()) return fail();
      break;
    } else {
      std::fseek(f, chunk_size, SEEK_CUR);
    }
  }
  std::fclose(f);
  if (!rate || !channels || pcm.empty()) return -1;
  size_t n = pcm.size() / channels;
  float* out = static_cast<float*>(std::malloc(n * sizeof(float)));
  for (size_t i = 0; i < n; ++i) {
    float acc = 0;
    for (int c = 0; c < channels; ++c) acc += pcm[i * channels + c];
    out[i] = acc / (32768.0f * channels);
  }
  *out_samples = out;
  *out_rate = int(rate);
  return int64_t(n);
}

void rtts_free(void* p) { std::free(p); }

static uint64_t gcd_u64(uint64_t a, uint64_t b) {
  while (b) {
    uint64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Polyphase windowed-sinc resample. Returns output length.
int64_t rtts_resample(const float* x, int64_t n, int orig_sr, int target_sr,
                      float** out) {
  if (orig_sr == target_sr) {
    float* y = static_cast<float*>(std::malloc(n * sizeof(float)));
    std::memcpy(y, x, n * sizeof(float));
    *out = y;
    return n;
  }
  uint64_t g = gcd_u64(orig_sr, target_sr);
  int64_t up = target_sr / g, down = orig_sr / g;
  double cutoff = 0.5 / std::max(up, down);
  int taps_per_phase = 32;
  int64_t num_taps = taps_per_phase * std::max(up, down);
  if (num_taps % 2 == 0) num_taps += 1;
  int64_t half = num_taps / 2;
  // Kaiser beta 8.6 window
  const double beta = 8.6;
  auto bessel_i0 = [](double v) {
    double sum = 1.0, term = 1.0;
    for (int i = 1; i < 32; ++i) {
      term *= (v / (2.0 * i)) * (v / (2.0 * i));
      sum += term;
      if (term < 1e-12 * sum) break;
    }
    return sum;
  };
  double i0b = bessel_i0(beta);
  std::vector<double> h(num_taps);
  for (int64_t i = 0; i < num_taps; ++i) {
    double t = double(i) - half;
    double sinc = (t == 0) ? 2 * cutoff
                           : std::sin(2 * M_PI * cutoff * t) / (M_PI * t);
    double w = bessel_i0(beta * std::sqrt(std::max(
                   0.0, 1.0 - (t / half) * (t / half)))) / i0b;
    h[i] = sinc * w * up;
  }
  int64_t out_len = (n * up) / down;
  float* y = static_cast<float*>(std::malloc(out_len * sizeof(float)));
  // y[j] = sum_i x[i] * h[j*down - i*up + half] (polyphase evaluation)
  for (int64_t j = 0; j < out_len; ++j) {
    int64_t center = j * down;  // position in upsampled grid
    double acc = 0;
    // taps at upsampled positions center - k where (center - k) % up == 0
    int64_t k_lo = center - half, k_hi = center + half;
    int64_t i_lo = (k_lo + up - 1) / up;  // ceil division
    if (i_lo < 0) i_lo = 0;
    int64_t i_hi = k_hi / up;
    if (i_hi >= n) i_hi = n - 1;
    for (int64_t i = i_lo; i <= i_hi; ++i) {
      int64_t tap = center - i * up + half;
      acc += double(x[i]) * h[tap];
    }
    y[j] = float(acc);
  }
  *out = y;
  return out_len;
}

// Energy-gate silence trim; returns [start, end) via out params.
void rtts_trim_silence(const float* x, int64_t n, int sample_rate,
                       float threshold_db, float frame_ms, int64_t* start,
                       int64_t* end) {
  int64_t frame = std::max<int64_t>(1, int64_t(sample_rate * frame_ms / 1000));
  int64_t n_frames = n / frame;
  *start = 0;
  *end = n;
  if (n_frames == 0) return;
  int64_t first = -1, last = -1;
  for (int64_t fi = 0; fi < n_frames; ++fi) {
    double acc = 0;
    for (int64_t i = 0; i < frame; ++i) {
      double v = x[fi * frame + i];
      acc += v * v;
    }
    double db = 10.0 * std::log10(acc / frame + 1e-10);
    if (db > threshold_db) {
      if (first < 0) first = fi;
      last = fi;
    }
  }
  if (first < 0) return;
  *start = first * frame;
  *end = (last + 1) * frame;
}

// Write an .rclip file. Returns 0 on success.
int rtts_clip_write(const char* path, const int32_t* tokens, int n_tokens,
                    const float* mel, int n_frames, int n_mels,
                    const float* audio, int n_samples) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint32_t hdr[5] = {1, uint32_t(n_tokens), uint32_t(n_frames),
                     uint32_t(n_mels), uint32_t(n_samples)};
  bool ok = std::fwrite("RCLP", 1, 4, f) == 4 &&
            std::fwrite(hdr, 4, 5, f) == 5 &&
            std::fwrite(tokens, 4, n_tokens, f) == size_t(n_tokens) &&
            std::fwrite(mel, 4, size_t(n_frames) * n_mels, f) ==
                size_t(n_frames) * n_mels &&
            std::fwrite(audio, 4, n_samples, f) == size_t(n_samples);
  std::fclose(f);
  return ok ? 0 : -1;
}

}  // extern "C"
