// Native host-side runtime: WAV decode + mmap'd GGML checkpoint parsing.
//
// The port's own copy of the JAX package's C++ sidecar
// (whisper_tpu/runtime/native/whisper_rt.cc); it runs on the host only:
//   - wrt_load_wav: PCM 8/16/24/32-bit and float WAV, i16 -> f32 by /32768,
//     multichannel downmix;
//   - wrt_open_ggml: the checkpoint is mmap'd and its tensor records indexed
//     in one pass; tensor bytes are returned as pointers into the mapping;
//   - wrt_loader_*: a threaded WAV prefetcher.
//
// Exposed as a small C ABI consumed via ctypes (whisper_tpu_torch/runtime/native.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kGgmlMagic = 0x67676d6c;

struct WavHandle {
  int rate = 0;
  std::vector<float> data;
};

struct LoaderHandle {
  std::vector<std::string> paths;
  std::vector<void*> results;
  std::vector<uint8_t> done;
  std::atomic<int> next_job{0};
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> threads;
};

struct TensorRec {
  std::string name;
  int ftype = 0;
  int n_dims = 0;
  int ne[4] = {1, 1, 1, 1};
  const void* data = nullptr;
};

struct GgmlHandle {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t size = 0;
  std::string error;

  int header[11] = {0};
  int n_mel = 0, n_fft = 0;
  const float* filters = nullptr;
  std::vector<std::pair<const char*, int>> tokens;  // ptr into map, len
  std::vector<TensorRec> tensors;
};

template <typename T>
bool read_pod(const uint8_t*& p, const uint8_t* end, T* out) {
  if (p + sizeof(T) > end) return false;
  memcpy(out, p, sizeof(T));
  p += sizeof(T);
  return true;
}

}  // namespace

extern "C" {

// ---------------- WAV ----------------

void* wrt_load_wav(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto fail = [&]() -> void* {
    fclose(f);
    return nullptr;
  };
  char riff[4], wave[4];
  uint32_t riff_size;
  if (fread(riff, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) != 0) return fail();
  if (fread(&riff_size, 4, 1, f) != 1) return fail();
  if (fread(wave, 1, 4, f) != 4 || memcmp(wave, "WAVE", 4) != 0) return fail();

  uint16_t audio_format = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  std::vector<uint8_t> pcm;
  // chunk walk
  for (;;) {
    char id[4];
    uint32_t sz;
    if (fread(id, 1, 4, f) != 4 || fread(&sz, 4, 1, f) != 1) break;
    if (memcmp(id, "fmt ", 4) == 0) {
      std::vector<uint8_t> fmt(sz);
      if (fread(fmt.data(), 1, sz, f) != sz) return fail();
      if (sz < 16) return fail();
      memcpy(&audio_format, fmt.data() + 0, 2);
      memcpy(&channels, fmt.data() + 2, 2);
      memcpy(&rate, fmt.data() + 4, 4);
      memcpy(&bits, fmt.data() + 14, 2);
      if (audio_format == 0xFFFE && sz >= 40) {  // WAVE_FORMAT_EXTENSIBLE
        uint16_t sub;
        memcpy(&sub, fmt.data() + 24, 2);
        audio_format = sub;
      }
    } else if (memcmp(id, "data", 4) == 0) {
      pcm.resize(sz);
      if (fread(pcm.data(), 1, sz, f) != sz) return fail();
    } else {
      fseek(f, (sz + 1) & ~1u, SEEK_CUR);  // chunks are 2-byte aligned
      continue;
    }
    if (sz & 1) fseek(f, 1, SEEK_CUR);
  }
  fclose(f);
  if (!rate || !channels || pcm.empty()) return nullptr;
  if (audio_format != 1 && audio_format != 3) return nullptr;  // PCM or float

  auto* h = new WavHandle;
  h->rate = static_cast<int>(rate);
  const size_t bytes_per = bits / 8;
  const size_t n_frames = pcm.size() / (bytes_per * channels);
  h->data.resize(n_frames);
  const uint8_t* p = pcm.data();
  for (size_t i = 0; i < n_frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* s = p + (i * channels + c) * bytes_per;
      double val = 0.0;
      if (audio_format == 3 && bits == 32) {
        float fv;
        memcpy(&fv, s, 4);
        val = fv;
      } else if (bits == 16) {
        int16_t v;
        memcpy(&v, s, 2);
        val = v / 32768.0;
      } else if (bits == 8) {
        val = (static_cast<int>(s[0]) - 128) / 128.0;
      } else if (bits == 24) {
        int32_t v = (s[0] | (s[1] << 8) | (s[2] << 16));
        if (v & 0x800000) v |= 0xFF000000;
        val = v / 8388608.0;
      } else if (bits == 32) {
        int32_t v;
        memcpy(&v, s, 4);
        val = v / 2147483648.0;
      }
      acc += val;
    }
    h->data[i] = static_cast<float>(acc / channels);
  }
  return h;
}

int wrt_wav_rate(void* h) { return static_cast<WavHandle*>(h)->rate; }
long long wrt_wav_len(void* h) {
  return static_cast<long long>(static_cast<WavHandle*>(h)->data.size());
}
const float* wrt_wav_data(void* h) { return static_cast<WavHandle*>(h)->data.data(); }
void wrt_wav_free(void* h) { delete static_cast<WavHandle*>(h); }

// ---------------- GGML ----------------

void* wrt_open_ggml(const char* path) {
  auto* h = new GgmlHandle;
  h->fd = open(path, O_RDONLY);
  if (h->fd < 0) {
    h->error = "cannot open file";
    return h;
  }
  struct stat st;
  fstat(h->fd, &st);
  h->size = static_cast<size_t>(st.st_size);
  h->map = static_cast<const uint8_t*>(
      mmap(nullptr, h->size, PROT_READ, MAP_PRIVATE, h->fd, 0));
  if (h->map == MAP_FAILED) {
    h->map = nullptr;
    h->error = "mmap failed";
    return h;
  }
  madvise(const_cast<uint8_t*>(h->map), h->size, MADV_SEQUENTIAL);

  const uint8_t* p = h->map;
  const uint8_t* end = h->map + h->size;
  uint32_t magic;
  if (!read_pod(p, end, &magic) || magic != kGgmlMagic) {
    h->error = "bad magic";
    return h;
  }
  for (int i = 0; i < 11; ++i) {
    if (!read_pod(p, end, &h->header[i])) {
      h->error = "truncated header";
      return h;
    }
  }
  if (!read_pod(p, end, &h->n_mel) || !read_pod(p, end, &h->n_fft)) {
    h->error = "truncated filters";
    return h;
  }
  h->filters = reinterpret_cast<const float*>(p);
  const size_t filter_bytes =
      static_cast<size_t>(h->n_mel) * h->n_fft * sizeof(float);
  if (p + filter_bytes > end) {
    h->error = "truncated filter data";
    return h;
  }
  p += filter_bytes;

  int n_vocab = 0;
  if (!read_pod(p, end, &n_vocab)) {
    h->error = "truncated vocab";
    return h;
  }
  h->tokens.reserve(n_vocab);
  for (int i = 0; i < n_vocab; ++i) {
    uint32_t len;
    if (!read_pod(p, end, &len) || p + len > end) {
      h->error = "truncated token";
      return h;
    }
    h->tokens.emplace_back(reinterpret_cast<const char*>(p), static_cast<int>(len));
    p += len;
  }

  // Tensor records until fewer than 12 bytes remain.
  while (end - p >= 12) {
    TensorRec rec;
    int name_len;
    if (!read_pod(p, end, &rec.n_dims) || !read_pod(p, end, &name_len) ||
        !read_pod(p, end, &rec.ftype)) {
      h->error = "truncated tensor header";
      return h;
    }
    if (rec.n_dims < 1 || rec.n_dims > 4 || name_len <= 0 || name_len > 512) {
      h->error = "corrupt tensor header";
      return h;
    }
    size_t n_elems = 1;
    for (int d = 0; d < rec.n_dims; ++d) {
      if (!read_pod(p, end, &rec.ne[d])) {
        h->error = "truncated tensor dims";
        return h;
      }
      n_elems *= static_cast<size_t>(rec.ne[d]);
    }
    if (p + name_len > end) {
      h->error = "truncated tensor name";
      return h;
    }
    rec.name.assign(reinterpret_cast<const char*>(p), name_len);
    p += name_len;
    const size_t bytes = n_elems * (rec.ftype == 0 ? 4 : 2);
    if (p + bytes > end) {
      h->error = "truncated tensor data: " + rec.name;
      return h;
    }
    rec.data = p;
    p += bytes;
    h->tensors.push_back(std::move(rec));
  }
  return h;
}

const char* wrt_ggml_error(void* hp) {
  auto* h = static_cast<GgmlHandle*>(hp);
  return h->error.empty() ? nullptr : h->error.c_str();
}

const int* wrt_ggml_header(void* hp) { return static_cast<GgmlHandle*>(hp)->header; }

const float* wrt_ggml_filters(void* hp, int* n_mel, int* n_fft) {
  auto* h = static_cast<GgmlHandle*>(hp);
  *n_mel = h->n_mel;
  *n_fft = h->n_fft;
  return h->filters;
}

int wrt_ggml_n_vocab(void* hp) {
  return static_cast<int>(static_cast<GgmlHandle*>(hp)->tokens.size());
}

const char* wrt_ggml_token(void* hp, int i, int* len) {
  auto* h = static_cast<GgmlHandle*>(hp);
  *len = h->tokens[i].second;
  return h->tokens[i].first;
}

int wrt_ggml_n_tensors(void* hp) {
  return static_cast<int>(static_cast<GgmlHandle*>(hp)->tensors.size());
}

const char* wrt_ggml_tensor_name(void* hp, int i) {
  return static_cast<GgmlHandle*>(hp)->tensors[i].name.c_str();
}

void wrt_ggml_tensor_info(void* hp, int i, int* ftype, int* n_dims, int* ne,
                          const void** data) {
  auto& rec = static_cast<GgmlHandle*>(hp)->tensors[i];
  *ftype = rec.ftype;
  *n_dims = rec.n_dims;
  for (int d = 0; d < 4; ++d) ne[d] = rec.ne[d];
  *data = rec.data;
}

void wrt_ggml_close(void* hp) {
  auto* h = static_cast<GgmlHandle*>(hp);
  if (h->map) munmap(const_cast<uint8_t*>(h->map), h->size);
  if (h->fd >= 0) close(h->fd);
  delete h;
}

// ---------------- Async audio loader ----------------
//
// Producer-consumer WAV prefetcher: N worker threads pull file indices from
// an atomic counter and decode (8/16/24/32-bit + float, downmix) while the
// Python side stages earlier items to the device, so a caller that
// transcribes many files never waits on disk or decode.

void* wrt_loader_open(const char** paths, int n, int n_threads) {
  auto* h = new LoaderHandle;
  h->paths.assign(paths, paths + n);
  h->results.assign(n, nullptr);
  h->done.assign(n, 0);
  int t = n_threads < 1 ? 1 : (n_threads > n ? n : n_threads);
  for (int i = 0; i < t; ++i) {
    h->threads.emplace_back([h]() {
      for (;;) {
        int j = h->next_job.fetch_add(1);
        if (j >= static_cast<int>(h->paths.size())) return;
        void* w = wrt_load_wav(h->paths[j].c_str());
        {
          std::lock_guard<std::mutex> lk(h->mu);
          h->results[j] = w;
          h->done[j] = 1;
        }
        h->cv.notify_all();
      }
    });
  }
  return h;
}

// Blocks until item `index` is decoded; transfers ownership of the WavHandle
// (free with wrt_wav_free). Returns nullptr if that file failed to decode.
void* wrt_loader_get(void* hp, int index) {
  auto* h = static_cast<LoaderHandle*>(hp);
  if (index < 0 || index >= static_cast<int>(h->paths.size())) return nullptr;
  std::unique_lock<std::mutex> lk(h->mu);
  h->cv.wait(lk, [&] { return h->done[index] != 0; });
  void* w = h->results[index];
  h->results[index] = nullptr;
  return w;
}

void wrt_loader_close(void* hp) {
  auto* h = static_cast<LoaderHandle*>(hp);
  for (auto& t : h->threads) t.join();
  for (void* w : h->results) {
    if (w) wrt_wav_free(w);
  }
  delete h;
}

}  // extern "C"
