// Fused cosine scoring for Hopper (sm_90a), CUDA cores, float32.
//
// Replaces the Pallas kernel sdtk_tpu/ops/cosine.py:cosine_pallas: queries
// (Q, D) and profiles (N, D), neither normalized, give the (Q, N) cosine
// matrix.  Rows are normalized as the TPU kernel does, x * rsqrt(sum x^2 +
// 1e-24), and the product of the normalized rows is summed in f32 FMAs.
// No TF32 or bf16 tensor cores: scores are held to 1e-5.
//
// Bound: at the dense identify shape (32, 4096, 192) the card must move
// 4 (QD + ND + QN) = 3.7 MB and do 2 QND = 50 MFLOP; at 3.35 TB/s and
// 67 TFLOP/s (f32, CUDA cores) that is ~1.1 us, bound by bytes.  This first
// version is bound by shared-memory loads feeding the FMAs and by the few
// blocks a small Q gives.
//
// Design.  The TPU kernel's 128 x 128 tiles are sized for the MXU; here a
// block owns a 64 x 64 output tile (256 threads, 4 x 4 outputs each):
//   1. each warp computes inverse norms of the block's 64 query and 64
//      profile rows (lane-strided sums, shuffle reduction) into shared
//      memory, so no normalized copy of either matrix is written;
//   2. D is stepped BK = 32 columns at a time: both tiles are read with
//      coalesced loads, scaled by their row's inverse norm and stored
//      transposed ([k][row], padded to 65 floats: conflict-free stores);
//   3. each thread accumulates its 4 x 4 outputs with FMAs.
// Rows and columns past Q, N or D are masked (zeros in, nothing written).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // profile rows per block
constexpr int BK = 32;   // columns of D per step
constexpr int TM = 4;    // outputs per thread along Q
constexpr int TN = 4;    // outputs per thread along N
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int LD = BM + 1;                      // padded shared row

__global__ void __launch_bounds__(THREADS)
cosine_kernel(const float* __restrict__ q, const float* __restrict__ p, float* __restrict__ out,
              int nq, int np, int d) {
  __shared__ float inv_q[BM], inv_p[BN];
  __shared__ float qs[BK * LD], ps[BK * LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  // 1. inverse norms of the block's rows
  for (int r = warp; r < BM + BN; r += THREADS / 32) {
    const bool is_q = r < BM;
    const int g = is_q ? row0 + r : col0 + (r - BM);
    const float* src = is_q ? q : p;
    float s = 0.f;
    if (g < (is_q ? nq : np))
      for (int k = lane; k < d; k += 32) {
        const float v = src[(size_t)g * d + k];
        s = fmaf(v, v, s);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) (is_q ? inv_q[r] : inv_p[r - BM]) = rsqrtf(s + 1e-24f);
  }
  __syncthreads();

  // 2-3. normalized tiles through shared memory, 4 x 4 FMAs per thread
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, k = i - r * BK, kk = k0 + k;
      const int gq = row0 + r, gp = col0 + r;
      qs[k * LD + r] = (gq < nq && kk < d) ? q[(size_t)gq * d + kk] * inv_q[r] : 0.f;
      ps[k * LD + r] = (gp < np && kk < d) ? p[(size_t)gp * d + kk] * inv_p[r] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = qs[k * LD + ty * TM + m];
#pragma unroll
      for (int n = 0; n < TN; ++n) b[n] = ps[k * LD + tx * TN + n];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = row0 + ty * TM + m;
    if (r >= nq) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int c = col0 + tx * TN + n;
      if (c < np) out[(size_t)r * np + c] = acc[m][n];
    }
  }
}

}  // namespace

// q (nq, d), p (np, d), out (nq, np): float32, contiguous, on the current
// device.  Returns a cudaError_t.
extern "C" int cosine_launch(const void* q, const void* p, void* out, int nq, int np, int d,
                             void* stream) {
  if (nq <= 0 || np <= 0 || d <= 0 || (nq + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((np + BN - 1) / BN, (nq + BM - 1) / BM);
  cosine_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(p), static_cast<float*>(out), nq,
      np, d);
  return (int)cudaGetLastError();
}
