// Fused waveform -> log-mel frontend for Hopper (sm_90a).
//
// Replaces the Pallas kernel sdtk_tpu/ops/research/fbank_wave.py:log_mel_wave
// (body in _kernel_factory).  It computes ops/fbank.py:raw_log_mel at
// center=False: per-row preemphasis with x[-1] = 0, 400-sample frames at
// hop 160, the Hann-windowed DFT into 257 bins, power, the 257 -> 80 mel
// projection, then ln(x + floor) or 10*log10(max(x, floor)).  Frames,
// spectra and power never leave the block.  CMN and the frame mask stay in
// the Python wrapper (ops/fbank_wave.py), as in the TPU kernel's wrapper.
//
// Rounding follows the JAX frontend: preemphasis in f32, frames rounded to
// the compute type, bases and mel matrix given in it, products summed in
// f32, power rounded to it before the mel product.
//
// Bound: at the main-path shape (128 rows x 16000 samples -> 98 frames) the
// work is ~5.7 GFLOP against 12.7 MB of traffic, so on the bf16 tensor
// cores the card could do it in ~5.8 us (compute-bound).
//
// Design.  The TPU kernel's hop-blocked layout, 160 -> 256 lane padding and
// per-shift GEMM split exist for Mosaic's (8, 128) tiling; none of it is
// needed here.  The kernel is dft_mma.cuh's (its header holds the design:
// tensor cores for bf16, CUDA cores for f32) over this file's frame source.
// The (batch, t_frames) frames are numbered row by row, so a block's tile of
// frames may span waveform rows.  The block reads the samples its frames
// cover once, coalesced, preemphasizes them in f32 (so the folded-basis
// cancellation of the TPU kernel does not arise), rounds them and keeps them
// in a part of shared memory the kernel does not use yet; from there each
// frame is copied to its row of the tile, 16 bytes at a time when hop and
// win allow it: one pass over device memory whatever the overlap, any hop.

#include "dft_mma.cuh"

namespace {

struct WaveFrames {
  const float* x;  // (batch, n)
  int n, t_frames, hop;
  float coeff;

  // x[s] - coeff * x[s - 1] in f32 (the caller gives 0 for x[-1]), no FMA contraction
  __device__ __forceinline__ float preemph(float v, float prev) const {
    return coeff > 0.f ? __fsub_rn(v, __fmul_rn(coeff, prev)) : v;
  }

  // `stage` (`cap` values of T) is scratch: the samples the tile's frames cover
  // go there once, preemphasized and rounded, each waveform row's after the
  // row's before it; the frames are then cut out of it.  Several passes where
  // the scratch is too small for the whole tile.
  template <int R, typename T>
  __device__ __forceinline__ void fill(T* dst, int stride, int rows, int m0, int m_frames, int win,
                                       T* stage, int cap) const {
    constexpr int V = 16 / sizeof(T);     // values per 16-byte copy
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int m_end = min(m0 + rows, m_frames);
    const int span = (t_frames - 1) * hop + win;  // samples the frames of a whole row cover
    const bool vec = hop % V == 0 && win % V == 0 && stride % V == 0;
    for (int m = m0; m < m_end;) {
      const int b0 = m / t_frames, base = (m - b0 * t_frames) * hop;
      // where frame f >= m starts in the scratch: rows follow each other `span` apart
      auto offset = [&](int f) {
        const int b = f / t_frames;
        return (b - b0) * span + (f - b * t_frames) * hop - base;
      };
      int me = m_end;  // this pass: frames [m, me), as many as fit (frame m always does)
      if (offset(m_end - 1) + win > cap) {
        int lo = m, hi = m_end - 1;
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (offset(mid) + win <= cap) lo = mid; else hi = mid;
        }
        me = lo + 1;
      }
      const int ext = offset(me - 1) + win;

      // 1. scratch value q is sample s of row b0 + r, with q + base = r * span + s;
      // four a thread where they are 16 bytes of one row, else one
      if (n % 4 == 0 && hop % 4 == 0 && win % 4 == 0 && dft::aligned16(x)) {
        constexpr int U = 8;  // groups of four a thread has in flight
        int r = (4 * tid + base) / span, s = 4 * tid + base - r * span;
        for (int q0 = 4 * tid; q0 < ext; q0 += 4 * U * nthr) {
          float4 v[U];
          float prev[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {  // no branch around a load: they start together
            const float* p = x + (size_t)(b0 + r) * n + s;
            const bool in = q0 + 4 * u * nthr < ext;
            v[u] = __ldg(reinterpret_cast<const float4*>(in ? p : x));
            prev[u] = in && s > 0 ? __ldg(p - 1) : 0.f;
            for (s += 4 * nthr; s >= span; s -= span) ++r;
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int q = q0 + 4 * u * nthr;
            if (q >= ext) break;
            dft::store4(stage + q, make_float4(preemph(v[u].x, prev[u]), preemph(v[u].y, v[u].x),
                                               preemph(v[u].z, v[u].y), preemph(v[u].w, v[u].z)));
          }
        }
      } else {
        constexpr int U = 8;  // samples a thread has in flight
        int r = (tid + base) / span, s = tid + base - r * span;
        for (int q0 = tid; q0 < ext; q0 += U * nthr) {
          float v[U], prev[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float* p = x + (size_t)(b0 + r) * n + s;
            const bool in = q0 + u * nthr < ext;
            v[u] = __ldg(in ? p : x);
            prev[u] = in && s > 0 ? __ldg(p - 1) : 0.f;
            for (s += nthr; s >= span; s -= span) ++r;
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int q = q0 + u * nthr;
            if (q >= ext) break;
            stage[q] = dft::cvt<T>(preemph(v[u], prev[u]));
          }
        }
      }
      __syncthreads();

      // 2. frame f, sample c is scratch value offset(f) + c.  A warp copies a
      // frame at a time, 16 bytes a lane where every frame starts on a 16-byte
      // boundary, else value by value; its frames' rows are tracked without a
      // division a frame.
      constexpr int FB = 4;  // frames a warp has in flight
      const int warp = tid >> 5, lane = tid & 31, warps = nthr >> 5;
      int b = (m + warp) / t_frames, t = m + warp - b * t_frames;
      for (int f = m + warp; f < me; f += FB * warps) {
        const T* from[FB];
#pragma unroll
        for (int i = 0; i < FB; ++i) {  // frames f + i * warps (used only where < me)
          from[i] = stage + (b - b0) * span + t * hop - base;
          for (t += warps; t >= t_frames; t -= t_frames) ++b;
        }
        T* to = dst + (size_t)(f - m0) * stride;
        if (vec) {
          for (int c = lane * V; c < win; c += 32 * V) {
            uint4 v[FB];
#pragma unroll
            for (int i = 0; i < FB; ++i)
              if (f + i * warps < me) v[i] = *reinterpret_cast<const uint4*>(from[i] + c);
#pragma unroll
            for (int i = 0; i < FB; ++i)
              if (f + i * warps < me)
                *reinterpret_cast<uint4*>(to + (size_t)i * warps * stride + c) = v[i];
          }
        } else {
          for (int c = lane; c < win; c += 32) {
            T v[FB];
#pragma unroll
            for (int i = 0; i < FB; ++i)
              if (f + i * warps < me) v[i] = from[i][c];
#pragma unroll
            for (int i = 0; i < FB; ++i)
              if (f + i * warps < me) to[(size_t)i * warps * stride + c] = v[i];
          }
        }
      }
      __syncthreads();  // the scratch is free for the next pass, or for its owner
      m = me;
    }
  }
};

}  // namespace

// x (batch, n) f32; out (batch, t_frames, n_mels) f32.  bf16 compute (`bf16`
// nonzero): `packed` from ops/fbank.py:pack_dft_operands, wr/wi/mel unused.
// f32 compute: wr, wi (win, n_freqs) and mel (n_freqs, n_mels) f32, `packed`
// unused.  All contiguous on the current device.  Returns a cudaError_t.
extern "C" int log_mel_wave_launch(const void* x, const void* wr, const void* wi, const void* mel,
                                   const void* packed, void* out, int batch, int n, int t_frames,
                                   int hop, int win, int n_freqs, int n_mels, float coeff,
                                   int log_db, float log_floor, int bf16, void* stream) {
  if (batch <= 0 || t_frames <= 0 || n_freqs <= 0 || n_mels <= 0 || hop <= 0 || win <= 0 ||
      (long long)(t_frames - 1) * hop + win > n || (long long)batch * t_frames > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const WaveFrames src{static_cast<const float*>(x), n, t_frames, hop, coeff};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dft::launch_mma(src, packed, out, batch * t_frames, win, n_freqs, n_mels, log_db,
                           log_floor, s);
  return dft::launch_fma(src, wr, wi, mel, out, batch * t_frames, win, n_freqs, n_mels, log_db,
                         log_floor, s);
}
