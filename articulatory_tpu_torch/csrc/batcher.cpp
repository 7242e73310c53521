// Host C++ batch assembly for the a2w random-window training batches: a
// threaded .npy corpus cache and crop (the port's copy of the JAX
// package's native/src/batcher.cpp, which data/native_loader.py binds).
//
// The C++ counterpart of data/collate.py::SpeechCollater's random_window
// mode with AR context windows: utterances are read into memory once, and
// each batch is cropped and packed into caller-owned contiguous float32
// buffers by a worker pool, so Python never touches per-sample data. A
// plain C ABI for ctypes.
//
// Build: ops/_build.py::host_library("batcher"), g++ -O3 -fPIC -pthread
// -shared -std=c++17 into articulatory_tpu_torch/build/.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------- npy io
struct NpyArray {
  std::vector<float> data;
  int64_t rows = 0;
  int64_t cols = 1;  // 1 for 1-D arrays
};

bool parse_npy_header(std::ifstream& f, std::string& descr, bool& fortran,
                      std::vector<int64_t>& shape) {
  char magic[6];
  f.read(magic, 6);
  if (std::memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  uint8_t ver[2];
  f.read(reinterpret_cast<char*>(ver), 2);
  uint32_t header_len = 0;
  if (ver[0] == 1) {
    uint16_t len16;
    f.read(reinterpret_cast<char*>(&len16), 2);
    header_len = len16;
  } else {
    f.read(reinterpret_cast<char*>(&header_len), 4);
  }
  std::string header(header_len, '\0');
  f.read(header.data(), header_len);

  auto find_val = [&](const std::string& key) -> std::string {
    size_t p = header.find("'" + key + "'");
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    size_t end = header.find(',', p);
    // shape tuple contains commas; handle separately
    return header.substr(p + 1, end - p - 1);
  };

  std::string d = find_val("descr");
  size_t q1 = d.find('\'');
  size_t q2 = d.rfind('\'');
  descr = (q1 != std::string::npos && q2 > q1) ? d.substr(q1 + 1, q2 - q1 - 1)
                                               : "";
  fortran = header.find("'fortran_order': True") != std::string::npos;

  size_t sp = header.find("'shape'");
  sp = header.find('(', sp);
  size_t se = header.find(')', sp);
  std::string tup = header.substr(sp + 1, se - sp - 1);
  shape.clear();
  size_t pos = 0;
  while (pos < tup.size()) {
    while (pos < tup.size() && !isdigit(tup[pos])) pos++;
    if (pos >= tup.size()) break;
    size_t e = pos;
    while (e < tup.size() && isdigit(tup[e])) e++;
    shape.push_back(std::stoll(tup.substr(pos, e - pos)));
    pos = e;
  }
  return true;
}

bool load_npy(const std::string& path, NpyArray& out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::string descr;
  bool fortran;
  std::vector<int64_t> shape;
  if (!parse_npy_header(f, descr, fortran, shape)) return false;
  if (fortran || shape.empty() || shape.size() > 2) return false;
  out.rows = shape[0];
  out.cols = shape.size() == 2 ? shape[1] : 1;
  const int64_t n = out.rows * out.cols;
  out.data.resize(n);
  if (descr == "<f4") {
    f.read(reinterpret_cast<char*>(out.data.data()), n * 4);
    // a truncated payload sets failbit+eofbit but gcount() exposes the
    // short read — reject it instead of training on a zero-filled tail
    if (f.gcount() != static_cast<std::streamsize>(n * 4)) return false;
  } else if (descr == "<f8") {
    std::vector<double> tmp(n);
    f.read(reinterpret_cast<char*>(tmp.data()), n * 8);
    if (f.gcount() != static_cast<std::streamsize>(n * 8)) return false;
    for (int64_t i = 0; i < n; i++) out.data[i] = static_cast<float>(tmp[i]);
  } else {
    return false;
  }
  return true;
}

// ------------------------------------------------------------- thread pool
class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; i++) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task();
        }
      });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      tasks_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

// xorshift128+ RNG (deterministic given seed; independent per batch item)
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed ^ 0x9E3779B97F4A7C15ULL;
    s1 = (seed << 1) | 1;
    next();
    next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  int64_t randint(int64_t lo, int64_t hi) {  // [lo, hi)
    return lo + static_cast<int64_t>(next() % static_cast<uint64_t>(hi - lo));
  }
};

struct Utterance {
  NpyArray audio;  // (T,) float
  NpyArray art;    // (T', C)
};

struct Batcher {
  int64_t batch_max_steps;
  int64_t hop_size;
  int64_t ar_len;  // waveform-domain AR context (0 = off)
  int n_threads;
  std::vector<Utterance> utts;
  ThreadPool* pool;
};

}  // namespace

extern "C" {

void* ab_create(int64_t batch_max_steps, int64_t hop_size, int64_t ar_len,
                int n_threads) {
  auto* b = new Batcher();
  b->batch_max_steps = batch_max_steps;
  b->hop_size = hop_size;
  b->ar_len = ar_len;
  b->n_threads = n_threads > 0 ? n_threads : 4;
  b->pool = new ThreadPool(b->n_threads);
  return b;
}

void ab_destroy(void* handle) {
  auto* b = static_cast<Batcher*>(handle);
  delete b->pool;
  delete b;
}

// Returns utterance index (>= 0) or -1 on load failure.
int64_t ab_add_utterance(void* handle, const char* audio_npy,
                         const char* art_npy) {
  auto* b = static_cast<Batcher*>(handle);
  Utterance u;
  if (!load_npy(audio_npy, u.audio)) return -1;
  if (!load_npy(art_npy, u.art)) return -1;
  // truncate art to len(audio)/hop (collater invariant, train.py:986)
  int64_t max_frames = u.audio.rows / b->hop_size;
  if (u.art.rows > max_frames) u.art.rows = max_frames;
  // the collate output buffer is sized from utterance 0's channel count; a
  // heterogeneous corpus would write out of bounds — reject it here
  if (!b->utts.empty() && u.art.cols != b->utts[0].art.cols) return -1;
  b->utts.push_back(std::move(u));
  return static_cast<int64_t>(b->utts.size() - 1);
}

int64_t ab_num_utterances(void* handle) {
  return static_cast<int64_t>(static_cast<Batcher*>(handle)->utts.size());
}

int64_t ab_art_dim(void* handle) {
  auto* b = static_cast<Batcher*>(handle);
  return b->utts.empty() ? 0 : b->utts[0].art.cols;
}

int64_t ab_utt_frames(void* handle, int64_t idx) {
  auto* b = static_cast<Batcher*>(handle);
  return b->utts[idx].art.rows;
}

// Assemble one random_window batch for utterance `indices[0..n)`.
// audio_out: (n, batch_max_steps), art_out: (n, frames, C),
// ar_out: (n, ar_len) or nullptr when ar_len == 0.
// Returns 0 on success, -1 if any utterance is too short.
int ab_collate(void* handle, const int64_t* indices, int n, uint64_t seed,
               float* audio_out, float* art_out, float* ar_out) {
  auto* b = static_cast<Batcher*>(handle);
  const int64_t frames = b->batch_max_steps / b->hop_size;
  std::atomic<int> status{0};
  std::atomic<int> remaining{n};
  std::mutex done_mu;
  std::condition_variable done_cv;

  for (int i = 0; i < n; i++) {
    b->pool->submit([=, &status, &remaining, &done_mu, &done_cv] {
      const Utterance& u = b->utts[indices[i]];
      const int64_t c = u.art.cols;
      const int64_t max_start = u.art.rows - frames;  // exclusive bound
      if (max_start <= 0) {
        status.store(-1);
      } else {
        Rng rng(seed * 0x2545F4914F6CDD1DULL + static_cast<uint64_t>(i));
        const int64_t start_frame = rng.randint(0, max_start);
        const int64_t wav_start = start_frame * b->hop_size;
        std::memcpy(audio_out + static_cast<int64_t>(i) * b->batch_max_steps,
                    u.audio.data.data() + wav_start,
                    sizeof(float) * b->batch_max_steps);
        std::memcpy(art_out + static_cast<int64_t>(i) * frames * c,
                    u.art.data.data() + start_frame * c,
                    sizeof(float) * frames * c);
        if (ar_out != nullptr && b->ar_len > 0) {
          float* dst = ar_out + static_cast<int64_t>(i) * b->ar_len;
          const int64_t avail =
              wav_start >= b->ar_len ? b->ar_len : wav_start;
          const int64_t pad = b->ar_len - avail;
          std::memset(dst, 0, sizeof(float) * pad);
          std::memcpy(dst + pad, u.audio.data.data() + wav_start - avail,
                      sizeof(float) * avail);
        }
      }
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(done_mu);
        done_cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining.load() == 0; });
  return status.load();
}

}  // extern "C"
