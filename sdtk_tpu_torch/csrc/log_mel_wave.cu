// Fused waveform -> log-mel frontend for Hopper (sm_90a), CUDA cores.
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
// the compute type T, bases and mel matrix given in T, products summed in
// f32, power rounded to T before the mel product.  T is float or bf16.
//
// Bound: at the main-path shape (128 rows x 16000 samples -> 98 frames) the
// work is ~5.7 GFLOP against 12.7 MB of traffic, so on the tensor cores the
// card could do it in ~5.8 us (compute-bound).  This first version runs on
// the CUDA cores and is bound by shared-memory loads feeding the FMAs.
//
// Design.  The TPU kernel's hop-blocked layout, 160 -> 256 lane padding and
// per-shift GEMM split exist for Mosaic's (8, 128) tiling; none of it is
// needed here.  One block per (row, tile of FT = 32 frames):
//   1. the tile's waveform span ((FT-1)*hop + win samples, ~21 KB) is read
//      once into shared memory, preemphasized in f32 and rounded to T — so
//      the folded-basis cancellation of the TPU kernel does not arise;
//   2. the windowed bases (L2-resident, 2 x 400 x 257 in T) are staged
//      NC rows at a time into shared memory; each thread keeps a register
//      tile of FPT = 4 frames x KJ = 9 bins (bin = lane + 32 j) of re and im;
//      the frame samples are warp-wide broadcasts, the basis reads are
//      conflict-free;
//   3. power (rounded to T) goes to shared memory over the same space, then
//      each thread computes mel outputs as dot products over the bins and
//      writes the log.
// wgmma / TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FT = 32;        // frames per block
constexpr int FPT = 4;        // frames per thread (one warp shares them)
constexpr int THREADS = 256;  // 8 warps x FPT = FT frames
constexpr int KJ = 9;         // bins per lane: KP = 32 * KJ = 288 >= n_freqs
constexpr int KP = 32 * KJ;
constexpr int NC = 8;         // basis rows staged per step

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round a float to T and back (round to nearest even, as JAX's astype).
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__host__ __device__ inline int span_floats(int hop, int win) { return (FT - 1) * hop + win + NC; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
log_mel_wave_kernel(const float* __restrict__ x, const T* __restrict__ wr,
                    const T* __restrict__ wi, const T* __restrict__ mel,
                    float* __restrict__ out, int n, int t_frames, int hop, int win,
                    int n_freqs, int n_mels, float coeff, int log_db, float log_floor) {
  extern __shared__ float smem[];
  const int span = span_floats(hop, win);
  float* sig = smem;               // span floats (zero beyond the signal)
  float* br = smem + span;         // NC x KP
  float* bi = br + NC * KP;        // NC x KP
  float* power = smem;             // FT x n_freqs, reuses the space after the DFT

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FT;
  const int s0 = t0 * hop;
  const float* xb = x + (size_t)b * n;

  // 1. waveform span -> preemphasis (f32, no contraction) -> rounded to T
  for (int i = tid; i < span; i += THREADS) {
    const int j = s0 + i;
    float v = 0.f;
    if (j < n) {
      v = xb[j];
      if (coeff > 0.f) {
        const float prev = j > 0 ? xb[j - 1] : 0.f;
        v = __fsub_rn(v, __fmul_rn(coeff, prev));
      }
    }
    sig[i] = round_to<T>(v);
  }

  // 2. windowed DFT: re/im for FPT frames x KJ bins per thread
  const int f0 = warp * FPT;
  float re[FPT][KJ], im[FPT][KJ];
#pragma unroll
  for (int q = 0; q < FPT; ++q)
#pragma unroll
    for (int j = 0; j < KJ; ++j) re[q][j] = im[q][j] = 0.f;

  for (int c0 = 0; c0 < win; c0 += NC) {
    __syncthreads();  // signal written / previous basis rows consumed
    for (int i = tid; i < NC * KP; i += THREADS) {
      const int r = i / KP, k = i - r * KP, row = c0 + r;
      float vr = 0.f, vi = 0.f;
      if (row < win && k < n_freqs) {
        vr = to_f(wr[row * n_freqs + k]);
        vi = to_f(wi[row * n_freqs + k]);
      }
      br[i] = vr;
      bi[i] = vi;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      float xs[FPT];
#pragma unroll
      for (int q = 0; q < FPT; ++q) xs[q] = sig[(f0 + q) * hop + c0 + r];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float vr = br[r * KP + lane + 32 * j];
        const float vi = bi[r * KP + lane + 32 * j];
#pragma unroll
        for (int q = 0; q < FPT; ++q) {
          re[q][j] = fmaf(xs[q], vr, re[q][j]);
          im[q][j] = fmaf(xs[q], vi, im[q][j]);
        }
      }
    }
  }
  __syncthreads();  // all reads of sig/br/bi done before power overwrites them

  // 3. power, rounded to T
#pragma unroll
  for (int q = 0; q < FPT; ++q)
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int k = lane + 32 * j;
      if (k < n_freqs)
        power[(f0 + q) * n_freqs + k] =
            round_to<T>(__fadd_rn(__fmul_rn(re[q][j], re[q][j]), __fmul_rn(im[q][j], im[q][j])));
    }
  __syncthreads();

  // 4. mel product and log
  for (int i = tid; i < FT * n_mels; i += THREADS) {
    const int f = i / n_mels, m = i - f * n_mels, t = t0 + f;
    if (t >= t_frames) break;  // i only grows, so every later i is past the end too
    const float* pw = power + f * n_freqs;
    float acc = 0.f;
    for (int k = 0; k < n_freqs; ++k) acc = fmaf(pw[k], to_f(mel[k * n_mels + m]), acc);
    out[((size_t)b * t_frames + t) * n_mels + m] =
        log_db ? 10.f * log10f(fmaxf(acc, log_floor)) : logf(acc + log_floor);
  }
}

template <typename T>
int launch(const void* x, const void* wr, const void* wi, const void* mel, void* out, int batch,
           int n, int t_frames, int hop, int win, int n_freqs, int n_mels, float coeff,
           int log_db, float log_floor, cudaStream_t stream) {
  const int span = span_floats(hop, win);
  int floats = span + 2 * NC * KP;
  if (FT * n_freqs > floats) floats = FT * n_freqs;
  const size_t smem = (size_t)floats * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(log_mel_wave_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((t_frames + FT - 1) / FT, batch);
  log_mel_wave_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const T*>(wr), static_cast<const T*>(wi),
      static_cast<const T*>(mel), static_cast<float*>(out), n, t_frames, hop, win, n_freqs,
      n_mels, coeff, log_db, log_floor);
  return (int)cudaGetLastError();
}

}  // namespace

// x (batch, n) f32; wr, wi (win, n_freqs) and mel (n_freqs, n_mels) in the
// compute type (bf16 when `bf16` is nonzero, else f32); out (batch, t_frames,
// n_mels) f32.  All contiguous on the current device.  Returns a cudaError_t.
extern "C" int log_mel_wave_launch(const void* x, const void* wr, const void* wi, const void* mel,
                                   void* out, int batch, int n, int t_frames, int hop, int win,
                                   int n_freqs, int n_mels, float coeff, int log_db,
                                   float log_floor, int bf16, void* stream) {
  if (batch <= 0 || batch > 65535 || t_frames <= 0 || n_freqs > KP || hop <= 0 || win <= 0 ||
      (t_frames - 1) * hop + win > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, wr, wi, mel, out, batch, n, t_frames, hop, win, n_freqs,
                                 n_mels, coeff, log_db, log_floor, s);
  return launch<float>(x, wr, wi, mel, out, batch, n, t_frames, hop, win, n_freqs, n_mels, coeff,
                       log_db, log_floor, s);
}
