// Native audio IO for sdtk_tpu_torch: WAV decode, mono mixdown, polyphase
// resampling, and a threaded batch loader.
//
// This is the framework's data-plane replacement for the reference
// toolkit's ffmpeg subprocess calls (speechmatics_backend.py:231-281,
// speaker_samples:280-326): decoding happens in-process, in parallel, and
// feeds device batches fast enough that the host never starves the chip
// (BASELINE.md ≥1000 audio-s/s/chip needs ~32 MB/s of decoded PCM per
// chip; this loader sustains GB/s).
//
// C ABI (ctypes-bound in sdtk_tpu_torch/utils/nativelib.py, called from
// sdtk_tpu_torch/utils/audio.py):
//   sdtk_decode_wav       one file → float32 mono @ target rate
//   sdtk_decode_wav_batch N files on a thread pool
//   sdtk_free             release buffers returned by the decoders

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

struct Decoded {
  float* data = nullptr;
  int64_t n = 0;
  int sample_rate = 0;
  int error = 0;  // 0 ok, 1 open, 2 format, 3 alloc
};

// ---------------------------------------------------------------------------
// WAV parsing (PCM 8/16/24/32 + IEEE float 32/64)
// ---------------------------------------------------------------------------

Decoded decode_wav_file(const char* path) {
  Decoded out;
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    out.error = 1;
    return out;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size > 0 ? size : 0);
  if (size <= 44 || std::fread(buf.data(), 1, size, f) != (size_t)size) {
    std::fclose(f);
    out.error = 2;
    return out;
  }
  std::fclose(f);

  if (std::memcmp(buf.data(), "RIFF", 4) || std::memcmp(buf.data() + 8, "WAVE", 4)) {
    out.error = 2;
    return out;
  }

  uint16_t fmt_code = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* payload = nullptr;
  uint32_t payload_len = 0;

  size_t pos = 12;
  while (pos + 8 <= (size_t)size) {
    uint32_t chunk_len;
    std::memcpy(&chunk_len, buf.data() + pos + 4, 4);
    const uint8_t* body = buf.data() + pos + 8;
    if (!std::memcmp(buf.data() + pos, "fmt ", 4) && chunk_len >= 16) {
      std::memcpy(&fmt_code, body, 2);
      std::memcpy(&channels, body + 2, 2);
      std::memcpy(&sr, body + 4, 4);
      std::memcpy(&bits, body + 14, 2);
      if (fmt_code == 0xFFFE) fmt_code = 1;  // extensible → assume PCM
    } else if (!std::memcmp(buf.data() + pos, "data", 4)) {
      payload = body;
      payload_len = chunk_len;
      if (pos + 8 + payload_len > (size_t)size) payload_len = size - pos - 8;
    }
    pos += 8 + chunk_len + (chunk_len & 1);
  }
  if (!payload || !channels || !sr) {
    out.error = 2;
    return out;
  }

  int64_t frames;
  switch (bits) {
    case 8: frames = payload_len / channels; break;
    case 16: frames = payload_len / (2 * channels); break;
    case 24: frames = payload_len / (3 * channels); break;
    case 32: frames = payload_len / (4 * channels); break;
    case 64: frames = payload_len / (8 * channels); break;
    default: out.error = 2; return out;
  }

  float* mono = static_cast<float*>(std::malloc(frames * sizeof(float)));
  if (!mono) {
    out.error = 3;
    return out;
  }
  // Fast paths for the dominant encodings: branch-free per-sample loops
  // the compiler auto-vectorizes (AVX2/AVX-512 with -march=native).  The
  // scalar switch loop below cost ~43% of end-to-end decode+resample
  // time on 16-bit mono input (evals/benchmark_decode.py, r3 profile).
  if (fmt_code == 1 && bits == 16 && channels == 1) {
    const int16_t* s = reinterpret_cast<const int16_t*>(payload);
    constexpr float kInv = 1.0f / 32768.0f;
    for (int64_t i = 0; i < frames; ++i) mono[i] = s[i] * kInv;
  } else if (fmt_code == 1 && bits == 16 && channels == 2) {
    const int16_t* s = reinterpret_cast<const int16_t*>(payload);
    constexpr float kInv = 0.5f / 32768.0f;
    for (int64_t i = 0; i < frames; ++i)
      mono[i] = (static_cast<int32_t>(s[2 * i]) + s[2 * i + 1]) * kInv;
  } else if (fmt_code == 3 && bits == 32 && channels == 1) {
    std::memcpy(mono, payload, frames * sizeof(float));
  } else {
    const double inv_ch = 1.0 / channels;
    for (int64_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      for (int c = 0; c < channels; ++c) {
        int64_t idx = i * channels + c;
        double v = 0.0;
        if (fmt_code == 3) {  // IEEE float
          if (bits == 32) {
            float x;
            std::memcpy(&x, payload + idx * 4, 4);
            v = x;
          } else {
            double x;
            std::memcpy(&x, payload + idx * 8, 8);
            v = x;
          }
        } else {
          switch (bits) {
            case 8: v = (payload[idx] - 128) / 128.0; break;
            case 16: {
              int16_t x;
              std::memcpy(&x, payload + idx * 2, 2);
              v = x / 32768.0;
              break;
            }
            case 24: {
              int32_t x = payload[idx * 3] | (payload[idx * 3 + 1] << 8) |
                          (payload[idx * 3 + 2] << 16);
              if (x >= (1 << 23)) x -= (1 << 24);
              v = x / 8388608.0;
              break;
            }
            case 32: {
              int32_t x;
              std::memcpy(&x, payload + idx * 4, 4);
              v = x / 2147483648.0;
              break;
            }
          }
        }
        acc += v;
      }
      mono[i] = static_cast<float>(acc * inv_ch);
    }
  }
  out.data = mono;
  out.n = frames;
  out.sample_rate = static_cast<int>(sr);
  return out;
}

// ---------------------------------------------------------------------------
// Polyphase windowed-sinc resampler
// ---------------------------------------------------------------------------

int64_t gcd64(int64_t a, int64_t b) { return b ? gcd64(b, a % b) : a; }

// Resample x (n samples @ sr_in) to sr_out.  Kaiser-less Hann-windowed sinc,
// 16 taps per phase — same design family as scipy.signal.resample_poly.
Decoded resample(const float* x, int64_t n, int sr_in, int sr_out) {
  Decoded out;
  if (sr_in == sr_out) {
    out.data = static_cast<float*>(std::malloc(n * sizeof(float)));
    if (!out.data) {
      out.error = 3;
      return out;
    }
    std::memcpy(out.data, x, n * sizeof(float));
    out.n = n;
    out.sample_rate = sr_out;
    return out;
  }
  int64_t g = gcd64(sr_in, sr_out);
  int64_t up = sr_out / g, down = sr_in / g;

  const int kHalfTaps = 16;  // per-side zero crossings at the lower rate
  const int kTaps = 2 * kHalfTaps;
  double cutoff = (up > down) ? 1.0 : (double)up / down;  // anti-alias
  int64_t n_out = (n * up) / down;

  out.data = static_cast<float*>(std::malloc(n_out * sizeof(float)));
  if (!out.data) {
    out.error = 3;
    return out;
  }

  // Output sample t sits at input position center = t*down/up
  //   = c + p/up  with  c = (t*down)/up,  p = (t*down)%up.
  // The tap weight for input index i = c - kHalfTaps + 1 + k depends only
  // on (p, k), so precompute the polyphase filter bank once: the hot loop
  // is then a pure 32-tap FIR MAC (no per-sample transcendentals — the
  // naive form costs ~64 sin/cos per output sample and loses to NumPy).
  std::vector<float> bank((size_t)up * kTaps);
  for (int64_t p = 0; p < up; ++p) {
    double frac = (double)p / up;
    for (int k = 0; k < kTaps; ++k) {
      double dist = (kHalfTaps - 1 - k) + frac;  // center - i
      double d = dist * cutoff;
      double sinc = (std::abs(d) < 1e-12) ? 1.0 : std::sin(M_PI * d) / (M_PI * d);
      double w = 0.5 + 0.5 * std::cos(M_PI * dist / kHalfTaps);  // Hann
      bank[(size_t)p * kTaps + k] = static_cast<float>(sinc * cutoff * w);
    }
  }

  int64_t c = 0, p = 0;  // running (t*down) divmod up — no int division
  for (int64_t t = 0; t < n_out; ++t) {
    const float* __restrict h = &bank[(size_t)p * kTaps];
    int64_t lo = c - kHalfTaps + 1;
    float acc = 0.0f;
    if (lo >= 0 && lo + kTaps <= n) {
      // Hot path: fixed-length FIR accumulated in 16 contiguous lanes —
      // the inner j-loop maps to one AVX-512 (or two AVX2) FMA per
      // 16-tap block, with the reassociation made explicit so it's
      // legal without -ffast-math.
      const float* __restrict xp = x + lo;
      float lane[16] = {0.0f};
      for (int k = 0; k < kTaps; k += 16)
        for (int j = 0; j < 16; ++j) lane[j] += xp[k + j] * h[k + j];
      float s0 = 0.0f, s1 = 0.0f;
      for (int j = 0; j < 8; ++j) {
        s0 += lane[j];
        s1 += lane[8 + j];
      }
      acc = s0 + s1;
    } else {
      for (int k = 0; k < kTaps; ++k) {
        int64_t i = lo + k;
        if (i >= 0 && i < n) acc += x[i] * h[k];
      }
    }
    out.data[t] = acc;
    // advance center by down/up: (c*up + p) += down
    c += down / up;
    p += down % up;
    if (p >= up) {
      c += 1;
      p -= up;
    }
  }
  out.n = n_out;
  out.sample_rate = sr_out;
  return out;
}

}  // namespace

extern "C" {

// Decode one WAV to float32 mono at target_sr (0 = keep native rate).
// Returns 0 on success; caller frees *out_data with sdtk_free.
int sdtk_decode_wav(const char* path, int target_sr, float** out_data,
                    int64_t* out_n, int* out_sr) {
  Decoded d = decode_wav_file(path);
  if (d.error) return d.error;
  if (target_sr > 0 && d.sample_rate != target_sr) {
    Decoded r = resample(d.data, d.n, d.sample_rate, target_sr);
    std::free(d.data);
    if (r.error) return r.error;
    d = r;
  }
  *out_data = d.data;
  *out_n = d.n;
  *out_sr = d.sample_rate;
  return 0;
}

// Batch decode on a thread pool.  Arrays are length n_files; per-file
// error codes land in out_errors.  n_threads<=0 → hardware concurrency.
void sdtk_decode_wav_batch(const char** paths, int n_files, int target_sr,
                           int n_threads, float** out_data, int64_t* out_n,
                           int* out_sr, int* out_errors) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_files) return;
      out_errors[i] =
          sdtk_decode_wav(paths[i], target_sr, &out_data[i], &out_n[i], &out_sr[i]);
    }
  };
  std::vector<std::thread> pool;
  int n_spawn = n_threads < n_files ? n_threads : n_files;
  for (int i = 0; i < n_spawn; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

void sdtk_free(float* ptr) { std::free(ptr); }

}  // extern "C"
