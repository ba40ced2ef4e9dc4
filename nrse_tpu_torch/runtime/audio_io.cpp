// Native audio runtime: WAV decode, polyphase resample, parallel batch load.
//
// The port's own copy of nrse_tpu/runtime/audio_io.cpp (unchanged below
// this header).  It plays the role of the reference's torchaudio/
// DataLoader-worker C++ path (torchaudio.load/Resample at
// src/utils/audio_utils.py:27,35 and the DataLoader num_workers=8
// processes at noisy_speech_dataset.py:178-192): the host-side hot loop
// that keeps the card fed.  Python binds via ctypes
// (nrse_tpu_torch/runtime/native.py); semantics mirror the pure-Python
// fallback in nrse_tpu_torch/audio/io.py exactly (that module is the
// behavioural spec).
//
// Build: g++ at first use, by nrse_tpu_torch/runtime/native.py, into
// build/nrse_tpu_torch/libnrse_audio_<source hash>.so

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;

struct Wav {
  std::vector<float> samples;  // mono
  int sample_rate = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Decode a RIFF/WAVE file: PCM 8/16/24/32-bit or IEEE float32/64,
// arbitrary channel count (downmixed by mean).  Returns false on any
// malformed input (the Python caller treats that as "file invalid").
bool decode_wav(const char* path, Wav* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) != 0 ||
      memcmp(hdr + 8, "WAVE", 4) != 0) {
    fclose(f);
    return false;
  }
  uint16_t format = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  std::vector<uint8_t> data;
  bool have_fmt = false, have_data = false;
  uint8_t chdr[8];
  while (fread(chdr, 1, 8, f) == 8) {
    uint32_t csize = rd_u32(chdr + 4);
    if (memcmp(chdr, "fmt ", 4) == 0) {
      std::vector<uint8_t> fmt(csize);
      if (fread(fmt.data(), 1, csize, f) != csize) break;
      if (csize < 16) break;
      format = rd_u16(fmt.data());
      channels = rd_u16(fmt.data() + 2);
      sr = rd_u32(fmt.data() + 4);
      bits = rd_u16(fmt.data() + 14);
      if (format == 0xFFFE && csize >= 26) format = rd_u16(fmt.data() + 24);
      have_fmt = true;
    } else if (memcmp(chdr, "data", 4) == 0) {
      data.resize(csize);
      size_t got = fread(data.data(), 1, csize, f);
      data.resize(got);
      have_data = true;
    } else {
      fseek(f, csize + (csize & 1), SEEK_CUR);
      continue;
    }
    if (csize & 1) fseek(f, 1, SEEK_CUR);
    if (have_fmt && have_data) break;
  }
  fclose(f);
  if (!have_fmt || !have_data || channels == 0 || sr == 0) return false;

  size_t bytes_per = bits / 8;
  if (bytes_per == 0) return false;
  size_t frames = data.size() / (bytes_per * channels);
  out->samples.resize(frames);
  out->sample_rate = (int)sr;
  const uint8_t* p = data.data();
  const float inv_ch = 1.0f / channels;

  for (size_t i = 0; i < frames; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* s = p + (i * channels + c) * bytes_per;
      float v = 0.0f;
      if (format == 3) {  // IEEE float
        if (bits == 32) {
          float fv;
          memcpy(&fv, s, 4);
          v = fv;
        } else if (bits == 64) {
          double dv;
          memcpy(&dv, s, 8);
          v = (float)dv;
        } else {
          return false;
        }
      } else if (format == 1) {  // PCM
        if (bits == 16) {
          int16_t iv;
          memcpy(&iv, s, 2);
          v = iv / 32768.0f;
        } else if (bits == 32) {
          int32_t iv;
          memcpy(&iv, s, 4);
          v = (float)(iv / 2147483648.0);
        } else if (bits == 8) {
          v = ((int)s[0] - 128) / 128.0f;
        } else if (bits == 24) {
          int32_t iv = (int32_t)s[0] | ((int32_t)s[1] << 8) |
                       ((int32_t)s[2] << 16);
          if (iv & 0x800000) iv -= 0x1000000;
          v = iv / 8388608.0f;
        } else {
          return false;
        }
      } else {
        return false;
      }
      acc += v;
    }
    out->samples[i] = acc * inv_ch;
  }
  return true;
}

// Windowed-sinc polyphase resample (same kernel as the Python fallback:
// rolloff 0.9476, 24 zero crossings, Hann^2 window).
void resample(const std::vector<float>& in, int in_sr, int out_sr,
              std::vector<float>* out) {
  if (in_sr == out_sr) {
    *out = in;
    return;
  }
  int g = 1;
  {  // gcd
    int a = in_sr, b = out_sr;
    while (b) {
      int t = a % b;
      a = b;
      b = t;
    }
    g = a;
  }
  const int up = out_sr / g, down = in_sr / g;
  const double rolloff = 0.9475937167399596;
  const double zeros = 24.0;
  const double cutoff = rolloff * std::min(1.0, (double)up / down);
  const int width = (int)std::ceil(zeros / cutoff);

  const int64_t n = (int64_t)in.size();
  const int64_t out_len = (int64_t)std::ceil((double)n * up / down);
  out->assign(out_len, 0.0f);

  for (int64_t m = 0; m < out_len; ++m) {
    // output sample m sits at input position m*down/up
    const int64_t num = m * (int64_t)down;
    const int64_t center = num / up;
    const double frac = (double)(num % up) / up;
    double acc = 0.0;
    for (int i = -width; i <= width; ++i) {
      const int64_t k = center + i;
      if (k < 0 || k >= n) continue;
      const double t = ((double)i - frac) * cutoff;
      if (std::fabs(t) >= zeros) continue;
      const double w = std::cos(std::min(std::fabs(t) / zeros, 1.0) *
                                kPi / 2);
      const double sinc = (t == 0.0) ? 1.0 : std::sin(kPi * t) / (kPi * t);
      acc += in[k] * sinc * w * w * cutoff;
    }
    (*out)[m] = (float)acc;
  }
}

// xorshift PRNG for reproducible random crops
uint64_t xorshift(uint64_t* s) {
  uint64_t x = *s;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  return *s = x;
}

// decode -> mono -> resample -> crop/pad -> validate; mirrors
// nrse_tpu/audio/io.py::load_and_process_audio.  Returns actual length
// (pre-pad) in *out_len, -1 on failure.
int load_one(const char* path, int target_sr, int64_t max_samples,
             int random_crop, uint64_t seed, float* out,
             int64_t* out_len) {
  Wav wav;
  if (!decode_wav(path, &wav)) return -1;
  std::vector<float> x;
  if (wav.sample_rate != target_sr) {
    resample(wav.samples, wav.sample_rate, target_sr, &x);
  } else {
    x = std::move(wav.samples);
  }
  int64_t n = (int64_t)x.size();
  int64_t start = 0;
  if (n > max_samples) {
    if (random_crop) {
      uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ull;
      start = (int64_t)(xorshift(&s) % (uint64_t)(n - max_samples + 1));
    }
    n = max_samples;
  }
  float peak = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    float v = x[start + i];
    if (std::isnan(v)) return -1;
    out[i] = v;
    peak = std::max(peak, std::fabs(v));
  }
  for (int64_t i = n; i < max_samples; ++i) out[i] = 0.0f;
  if (peak < 1e-8f) return -1;  // near-silent
  *out_len = n;
  return 0;
}

}  // namespace

extern "C" {

// Single-file decode at native rate (for nrse_tpu/audio/io.py::load_audio).
// out must hold max_out floats; returns sample count written (mono) and
// sets *sr_out, or -1 on failure.
int64_t nrse_decode_wav(const char* path, float* out, int64_t max_out,
                        int32_t* sr_out) {
  Wav wav;
  if (!decode_wav(path, &wav)) return -1;
  const int64_t n = std::min<int64_t>((int64_t)wav.samples.size(), max_out);
  memcpy(out, wav.samples.data(), n * sizeof(float));
  *sr_out = wav.sample_rate;
  return n;
}

// Probe: returns the decoded mono length or -1 (for sizing buffers).
int64_t nrse_wav_length(const char* path, int32_t* sr_out) {
  Wav wav;
  if (!decode_wav(path, &wav)) return -1;
  *sr_out = wav.sample_rate;
  return (int64_t)wav.samples.size();
}

// Parallel batch load: decode+resample+crop/pad `batch` files with
// `threads` workers into out[batch, max_samples]; lengths[i] gets the
// pre-pad length or -1 on failure (caller applies retry policy).
void nrse_load_batch(const char** paths, int32_t batch, int32_t target_sr,
                     int64_t max_samples, int32_t random_crop,
                     const uint64_t* seeds, int32_t threads, float* out,
                     int64_t* lengths) {
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= batch) break;
      int64_t len = 0;
      int rc = load_one(paths[i], target_sr, max_samples, random_crop,
                        seeds ? seeds[i] : (uint64_t)(i + 1),
                        out + (int64_t)i * max_samples, &len);
      lengths[i] = (rc == 0) ? len : -1;
    }
  };
  int n_threads = std::max(1, (int)threads);
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Cold-cache readahead: advise the kernel that these files are about to
// be read (POSIX_FADV_WILLNEED queues async page-cache readahead).  The
// first epoch over a cold corpus is bound by the disk's latency; advising
// a few batches ahead of the decode pool overlaps that latency with
// compute.  Open+advise+close per
// file is a handful of syscalls (~µs) — callers may still run it off the
// hot thread.
void nrse_readahead(const char** paths, int32_t n) {
  for (int32_t i = 0; i < n; ++i) {
    int fd = open(paths[i], O_RDONLY);
    if (fd < 0) continue;
    posix_fadvise(fd, 0, 0, POSIX_FADV_WILLNEED);
    close(fd);
  }
}

}  // extern "C"
