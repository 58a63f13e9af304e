// Fused identify scoring for Hopper (sm_90a): cosine -> max over windows ->
// top-k of a tile of profile rows, CUDA cores, float32 arithmetic.
//
// Replaces the Pallas kernel sdtk_tpu/ops/research/topk_pallas.py:
// identify_topk_pallas.  Queries (W, D) f32 and profiles (N, D) f32 or bf16,
// neither normalized.  For each profile row j the kernel computes
// m_j = max over windows w of qn_w . pn_j (x normalized as x * rsqrt(sum x^2
// + 1e-24)), with rows past N at -inf, and each block writes the top kc of
// its tile as (score descending, row ascending) pairs, kc = min(k, 512).
// The (W, N) score matrix never reaches device memory.  The wrapper
// (ops/topk_fused.py) merges the nblocks * kc survivors; every global
// top-k row ranks <= k in its own tile, and for k >= 512 every row
// survives, so the merge is exact for any k.
//
// Bound: at the catalog shape W = 64, N = 100 000, D = 192 with f32
// profiles the card must read 76.8 MB (22.9 us at 3.35 TB/s) and do
// 2 WND = 2.46 GFLOP (36.7 us at 67 TFLOP/s, f32 CUDA cores), so operations
// bind.  No TF32 or bf16 tensor cores: the scores are held to 1e-5.  This
// first version is bound by shared-memory loads feeding the FMAs.
//
// Design.  The TPU kernel runs its grid in order with a 2048-row tile and
// selects with k unrolled max+mask passes.  Here blocks run in parallel:
//   - a block owns TILE = 512 profile rows, so N = 100 000 gives 196 blocks
//     for the 132 SMs;
//   - it computes the 512 inverse profile norms once, then walks W in
//     chunks of 64 windows (W is unbounded: a 10-minute query has ~400),
//     and within a chunk the tile in 8 sub-tiles of 64 rows; each 64 x 64
//     score tile is a small GEMM through shared memory (D stepped 32 at a
//     time, 4 x 4 outputs a thread), reduced over its windows (windows
//     past W are left out of the max) into a running max per row;
//   - the tile's 512 (score, row) pairs are bitonic-sorted in shared
//     memory and the first kc written out (the whole sorted tile when
//     k >= 512, so k has no cap and costs nothing extra).
// Shared memory stays under 48 KB whatever W and D are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int TILE = 512;    // profile rows per block
constexpr int BW = 64;       // windows per chunk
constexpr int BR = 64;       // profile rows per sub-tile
constexpr int BK = 32;       // columns of D per step
constexpr int TW = 4;        // windows per thread
constexpr int TR = 4;        // rows per thread
constexpr int THREADS = 256; // (BW / TW) x (BR / TR)
constexpr int LD = BW + 1;   // padded shared row

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// (score, row) order of the result: higher score first, then lower row.
__device__ __forceinline__ bool worse(float sa, int ia, float sb, int ib) {
  return sa < sb || (sa == sb && ia > ib);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
identify_topk_kernel(const float* __restrict__ q, const T* __restrict__ p,
                     float* __restrict__ cand_s, int* __restrict__ cand_i, int w, int n, int d,
                     int kc) {
  __shared__ float inv_p[TILE], best[TILE];
  __shared__ int rows[TILE];
  __shared__ float inv_q[BW];
  __shared__ float qs[BK * LD], ps[BK * LD];
  __shared__ float red[(BW / TW) * BR];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int base = blockIdx.x * TILE;
  const int tx = tid % (BR / TR), ty = tid / (BR / TR);

  // inverse norms of the tile's rows; running maxima start at -inf
  for (int r = warp; r < TILE; r += THREADS / 32) {
    const int g = base + r;
    float s = 0.f;
    if (g < n)
      for (int c = lane; c < d; c += 32) {
        const float v = to_f(p[(size_t)g * d + c]);
        s = fmaf(v, v, s);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      inv_p[r] = rsqrtf(s + 1e-24f);
      best[r] = -CUDART_INF_F;
      rows[r] = g;
    }
  }

  for (int w0 = 0; w0 < w; w0 += BW) {
    __syncthreads();  // inv_p/best written; previous chunk's inv_q consumed
    for (int r = warp; r < BW; r += THREADS / 32) {
      const int g = w0 + r;
      float s = 0.f;
      if (g < w)
        for (int c = lane; c < d; c += 32) {
          const float v = q[(size_t)g * d + c];
          s = fmaf(v, v, s);
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) inv_q[r] = rsqrtf(s + 1e-24f);
    }
    __syncthreads();

    for (int r0 = 0; r0 < TILE; r0 += BR) {
      float acc[TW][TR];
#pragma unroll
      for (int a = 0; a < TW; ++a)
#pragma unroll
        for (int b = 0; b < TR; ++b) acc[a][b] = 0.f;

      for (int k0 = 0; k0 < d; k0 += BK) {
        for (int i = tid; i < BW * BK; i += THREADS) {
          const int r = i / BK, c = i - r * BK, cc = k0 + c;
          const int gw = w0 + r, gp = base + r0 + r;
          qs[c * LD + r] = (gw < w && cc < d) ? q[(size_t)gw * d + cc] * inv_q[r] : 0.f;
          ps[c * LD + r] = (gp < n && cc < d) ? to_f(p[(size_t)gp * d + cc]) * inv_p[r0 + r] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int c = 0; c < BK; ++c) {
          float a[TW], b[TR];
#pragma unroll
          for (int i = 0; i < TW; ++i) a[i] = qs[c * LD + ty * TW + i];
#pragma unroll
          for (int j = 0; j < TR; ++j) b[j] = ps[c * LD + tx * TR + j];
#pragma unroll
          for (int i = 0; i < TW; ++i)
#pragma unroll
            for (int j = 0; j < TR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }

      // max over this thread's windows (those past W left out), then over
      // the 16 threads that share a row
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        float m = -CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < TW; ++i)
          if (w0 + ty * TW + i < w) m = fmaxf(m, acc[i][j]);
        red[ty * BR + tx * TR + j] = m;
      }
      __syncthreads();
      if (tid < BR) {
        float m = best[r0 + tid];
        for (int t = 0; t < BW / TW; ++t) m = fmaxf(m, red[t * BR + tid]);
        best[r0 + tid] = base + r0 + tid < n ? m : -CUDART_INF_F;
      }
      // red is rewritten only after the next sub-tile's k-loop barriers
    }
  }
  __syncthreads();

  // bitonic sort of the tile's (score, row) pairs, best first
  for (int size = 2; size <= TILE; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < TILE / 2; i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const bool up = (lo & size) == 0;
        if (worse(best[lo], rows[lo], best[hi], rows[hi]) == up) {
          const float s = best[lo];
          best[lo] = best[hi];
          best[hi] = s;
          const int r = rows[lo];
          rows[lo] = rows[hi];
          rows[hi] = r;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < kc; i += THREADS) {
    cand_s[(size_t)blockIdx.x * kc + i] = best[i];
    cand_i[(size_t)blockIdx.x * kc + i] = rows[i];
  }
}

}  // namespace

// q (w, d) f32; p (n, d) in bf16 when `bf16` is nonzero, else f32; cand_s
// (ceil(n / 512), kc) f32 and cand_i (ceil(n / 512), kc) int32, 1 <= kc <=
// 512.  All contiguous on the current device.  Returns a cudaError_t.
extern "C" int identify_topk_launch(const void* q, const void* p, void* cand_s, void* cand_i,
                                    int w, int n, int d, int kc, int bf16, void* stream) {
  if (w <= 0 || n <= 0 || d <= 0 || kc <= 0 || kc > TILE) return (int)cudaErrorInvalidValue;
  const int blocks = (n + TILE - 1) / TILE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    identify_topk_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(p),
        static_cast<float*>(cand_s), static_cast<int*>(cand_i), w, n, d, kc);
  else
    identify_topk_kernel<float><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(p), static_cast<float*>(cand_s),
        static_cast<int*>(cand_i), w, n, d, kc);
  return (int)cudaGetLastError();
}
