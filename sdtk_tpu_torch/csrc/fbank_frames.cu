// Log-mel from materialized frames for Hopper (sm_90a), CUDA cores.
//
// Replaces the Pallas kernel sdtk_tpu/ops/research/fbank_frames.py:
// fbank_frames_pallas: (M, win) frames -> windowed DFT (bases with the
// analysis window folded in) -> power -> mel projection -> ln(x + floor),
// giving (M, n_mels) f32.  The spectra and power never leave the block.
//
// Rounding follows the JAX kernel and this package's log_mel_wave.cu: the
// frames are rounded to the compute type T, the bases and the mel matrix are
// given in T, products are summed in f32, and the power is rounded to T
// before the mel product.  T is float or bf16.  Like the TPU kernel it
// always takes the natural log; the mel matrix (fmin 20 Hz) is the caller's.
//
// Bound: at the diarizer's frame count (M = 128 x 98 = 12 544, win 400, 257
// bins, 80 mels) the work is ~5.5 GFLOP against ~24 MB of traffic (frames
// in, log-mel out, bases once); on the bf16 tensor cores the card could do
// it in ~7 us (bytes-bound).  This first version runs on the CUDA cores and,
// like log_mel_wave.cu, is bound by the shared-memory loads feeding the
// FMAs.
//
// Design.  One block per tile of FT = 32 frames, the layout of
// log_mel_wave.cu with the framing taken out:
//   1. the tile's frames (32 x 400 f32, 51 KB: dynamic shared memory) are
//      read once with coalesced loads and rounded to T;
//   2. the bases (L2-resident) are staged NC rows at a time; each thread
//      keeps FPT = 4 frames x KJ = 9 bins (bin = lane + 32 j) of re and im,
//      the frame samples are warp-wide broadcasts;
//   3. power (rounded to T) is written over the frames, then each thread
//      computes mel outputs as dot products over the bins and writes ln.

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
fbank_frames_kernel(const float* __restrict__ frames, const T* __restrict__ wr,
                    const T* __restrict__ wi, const T* __restrict__ mel,
                    float* __restrict__ out, int m_frames, int win, int n_freqs, int n_mels,
                    float log_floor) {
  extern __shared__ float smem[];
  float* sig = smem;               // FT x win (zero past the last frame)
  float* br = smem + FT * win;     // NC x KP
  float* bi = br + NC * KP;        // NC x KP
  float* power = smem;             // FT x n_freqs, reuses the space after the DFT

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * FT;
  const int rows = min(FT, m_frames - t0);

  // 1. the tile's frames, rounded to T
  const float* src = frames + (size_t)t0 * win;
  for (int i = tid; i < FT * win; i += THREADS)
    sig[i] = i < rows * win ? round_to<T>(src[i]) : 0.f;

  // 2. windowed DFT: re/im for FPT frames x KJ bins per thread
  const int f0 = warp * FPT;
  float re[FPT][KJ], im[FPT][KJ];
#pragma unroll
  for (int q = 0; q < FPT; ++q)
#pragma unroll
    for (int j = 0; j < KJ; ++j) re[q][j] = im[q][j] = 0.f;

  for (int c0 = 0; c0 < win; c0 += NC) {
    __syncthreads();  // frames written / previous basis rows consumed
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
      if (c0 + r >= win) break;  // uniform across the block
      float xs[FPT];
#pragma unroll
      for (int q = 0; q < FPT; ++q) xs[q] = sig[(f0 + q) * win + c0 + r];
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

  // 3. power, rounded to T (no FMA contraction: as the plain version)
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

  // 4. mel product and natural log
  for (int i = tid; i < rows * n_mels; i += THREADS) {
    const int f = i / n_mels, m = i - f * n_mels;
    const float* pw = power + f * n_freqs;
    float acc = 0.f;
    for (int k = 0; k < n_freqs; ++k) acc = fmaf(pw[k], to_f(mel[k * n_mels + m]), acc);
    out[(size_t)(t0 + f) * n_mels + m] = logf(acc + log_floor);
  }
}

template <typename T>
int launch(const void* frames, const void* wr, const void* wi, const void* mel, void* out,
           int m_frames, int win, int n_freqs, int n_mels, float log_floor,
           cudaStream_t stream) {
  int floats = FT * win + 2 * NC * KP;
  if (FT * n_freqs > floats) floats = FT * n_freqs;
  const size_t smem = (size_t)floats * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fbank_frames_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (m_frames + FT - 1) / FT;
  fbank_frames_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(frames), static_cast<const T*>(wr), static_cast<const T*>(wi),
      static_cast<const T*>(mel), static_cast<float*>(out), m_frames, win, n_freqs, n_mels,
      log_floor);
  return (int)cudaGetLastError();
}

}  // namespace

// frames (m_frames, win) f32; wr, wi (win, n_freqs) and mel (n_freqs,
// n_mels) in the compute type (bf16 when `bf16` is nonzero, else f32); out
// (m_frames, n_mels) f32.  All contiguous on the current device.  Returns a
// cudaError_t.
extern "C" int fbank_frames_launch(const void* frames, const void* wr, const void* wi,
                                   const void* mel, void* out, int m_frames, int win, int n_freqs,
                                   int n_mels, float log_floor, int bf16, void* stream) {
  if (m_frames <= 0 || win <= 0 || n_freqs <= 0 || n_freqs > KP || n_mels <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(frames, wr, wi, mel, out, m_frames, win, n_freqs, n_mels,
                                 log_floor, s);
  return launch<float>(frames, wr, wi, mel, out, m_frames, win, n_freqs, n_mels, log_floor, s);
}
