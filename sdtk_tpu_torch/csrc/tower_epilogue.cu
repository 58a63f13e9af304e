// The ECAPA / x-vector tower's epilogue after a convolution, in one pass
// over its bf16 output (sm_90a): ReLU -> eval BatchNorm in f32 -> bf16 ->
// frame mask, and, after a Res2 split, the next split's input beside it.
//
// Replaces no TPU kernel: XLA fuses this chain into the convolution's
// consumer on the TPU, while the port's eager PyTorch ran it as six passes
// (relu, a cast to f32, batch_norm, a cast back, the mask's cast, the
// multiply) plus, for a Res2 split, an add and the final cat.
//
// Function, for y (B, C, T) bf16, per-channel f32 (scale, shift), a (B, T)
// bool mask, each element:
//   e = bf16(fma(max(y, 0), scale[c], shift[c]))   (BatchNorm on)
//   e = max(y, 0)                                 (BatchNorm off)
//   e = bf16(e * mask[b, t])                      (mask on)
// out[b, c, t] = e, and with `add` given, sum[b, c, t] = bf16(add + e).
// scale = gamma * (1 / sqrt(var + eps)), shift = fma(-mean, scale, beta) are
// the constants PyTorch's eval batch_norm applies on the CPU, which it also
// applies as one fma a value; so the plain version (ops/tower_epilogue.py)
// and the eager chain on the CPU give these bits.  ReLU keeps NaN and the
// mask multiplies (inf * 0 is NaN), as the eager ops do.  Rounding is to
// nearest even, as PyTorch's casts and bf16 add round.
//
// Bound: bytes.  Per element 2 B in and 2 B out (4 more with a Res2 sum),
// the mask's B T bytes and 8 C of constants; no arithmetic to speak of.  At
// the batch cell's (1024, 512, 298) that is 625 MB, 187 us at 3.35 TB/s.
//
// Design.  A thread owns 8 consecutive elements of a batch row's (C, T)
// block: one 16-byte load of y and one 16-byte store of out (and of add and
// sum), when C T is a multiple of 8 and every pointer and batch stride is
// 16-byte aligned; else 8 scalar accesses.  Its 8 elements' channels and
// times are the same in every batch row, so it reads their constants and
// time indices into registers once and then walks batch rows gridDim.y
// apart, two at a time with both rows' loads issued before either is
// used.  grid.y is cut so that about 8 192 blocks cover the tensor: each
// thread then walks 4-5 rows at (1024, 512, 298), 7 % faster on the card
// than one row a thread.  The mask is read as bytes (B T of them, L2-resident).  `out` and `add` may be
// channel slices of a wider buffer: only their batch stride differs from
// C T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;  // bf16 values: one 16-byte access
constexpr int MAX_GRID_Y = 65535;
constexpr int TARGET_BLOCKS = 8192;  // 62 blocks an SM: rows a block walks = B / (8192 / grid.x)

struct Args {
  const __nv_bfloat16* y;
  const float* scale;  // with shift: BatchNorm on; both null: off
  const float* shift;
  const unsigned char* mask;  // (B, T) bool; null: no mask
  __nv_bfloat16* out;
  long long out_bs;  // elements between batch rows of out
  const __nv_bfloat16* add;  // with sum: the Res2 next-split input; null: none
  long long add_bs;
  __nv_bfloat16* sum;  // (B, C, T) contiguous
  int b, c, t;
};

union Pack {
  uint4 raw;
  __nv_bfloat16 h[PER_THREAD];
};

template <bool VEC>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int n, __nv_bfloat16 (&v)[PER_THREAD]) {
  if (VEC) {
    Pack u;
    u.raw = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) v[k] = u.h[k];
  } else {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) v[k] = k < n ? p[k] : __float2bfloat16_rn(0.f);
  }
}

template <bool VEC>
__device__ __forceinline__ void store8(__nv_bfloat16* p, int n, const __nv_bfloat16 (&v)[PER_THREAD]) {
  if (VEC) {
    Pack u;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) u.h[k] = v[k];
    *reinterpret_cast<uint4*>(p) = u.raw;
  } else {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k)
      if (k < n) p[k] = v[k];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) tower_epilogue_kernel(const Args a) {
  const int per = a.c * a.t;  // the host checks that it fits
  const int pos0 = (blockIdx.x * THREADS + threadIdx.x) * PER_THREAD;
  if (pos0 >= per) return;
  const int n = min(PER_THREAD, per - pos0);

  // this thread's channels' constants and its times, the same in every row
  float sc[PER_THREAD], sh[PER_THREAD];
  int tk[PER_THREAD];
  {
    int ci = pos0 / a.t, ti = pos0 - ci * a.t;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int cc = min(ci, a.c - 1);  // past the end (k >= n): any channel
      tk[k] = ti;
      sc[k] = a.scale ? __ldg(a.scale + cc) : 1.f;
      sh[k] = a.scale ? __ldg(a.shift + cc) : 0.f;
      if (++ti == a.t) ti = 0, ++ci;
    }
  }

  // two batch rows an iteration: both rows' loads are in flight together
  for (int b0 = blockIdx.y; b0 < a.b; b0 += 2 * gridDim.y) {
    const int rows = b0 + gridDim.y < a.b ? 2 : 1;
    __nv_bfloat16 v[2][PER_THREAD], s[2][PER_THREAD];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r < rows) {
        const long long bi = b0 + r * gridDim.y;
        load8<VEC>(a.y + bi * per + pos0, n, v[r]);
        if (a.add) load8<VEC>(a.add + bi * a.add_bs + pos0, n, s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r >= rows) break;
      const long long bi = b0 + r * gridDim.y;
      const unsigned char* m = a.mask ? a.mask + bi * a.t : nullptr;
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        float x = __bfloat162float(v[r][k]);
        x = x < 0.f ? 0.f : x;  // NaN stays NaN, as torch.relu keeps it
        __nv_bfloat16 e = a.scale ? __float2bfloat16_rn(__fmaf_rn(x, sc[k], sh[k]))
                                  : __float2bfloat16_rn(x);
        if (m && k < n) e = __float2bfloat16_rn(__bfloat162float(e) * (m[tk[k]] ? 1.f : 0.f));
        v[r][k] = e;
        if (a.add) s[r][k] = __float2bfloat16_rn(__bfloat162float(s[r][k]) + __bfloat162float(e));
      }
      store8<VEC>(a.out + bi * a.out_bs + pos0, n, v[r]);
      if (a.add) store8<VEC>(a.sum + bi * per + pos0, n, s[r]);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int tower_epilogue_launch(const void* y, const void* scale, const void* shift,
                                     const void* mask, void* out, long long out_bs,
                                     const void* add, long long add_bs, void* sum, int b, int c,
                                     int t, void* stream) {
  if (b < 0 || c < 0 || t < 0 || !y || !out || (!scale != !shift) || (!add != !sum))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || c == 0 || t == 0) return 0;
  const long long per = (long long)c * t;
  if (per > 0x7fffffffLL - (long long)THREADS * PER_THREAD || out_bs < per ||
      (add && add_bs < per))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(scale),
               static_cast<const float*>(shift), static_cast<const unsigned char*>(mask),
               static_cast<__nv_bfloat16*>(out), out_bs, static_cast<const __nv_bfloat16*>(add),
               add_bs, static_cast<__nv_bfloat16*>(sum), b, c, t};
  const bool vec = per % PER_THREAD == 0 && out_bs % PER_THREAD == 0 && aligned16(y) &&
                   aligned16(out) &&
                   (!add || (add_bs % PER_THREAD == 0 && aligned16(add) && aligned16(sum)));
  const int gx = (int)((per + THREADS * PER_THREAD - 1) / (THREADS * PER_THREAD));
  int gy = (TARGET_BLOCKS + gx - 1) / gx;  // each block walks b / gy rows
  gy = gy < b ? gy : b;
  const dim3 grid((unsigned)gx, (unsigned)(gy < MAX_GRID_Y ? gy : MAX_GRID_Y));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    tower_epilogue_kernel<true><<<grid, THREADS, 0, s>>>(a);
  else
    tower_epilogue_kernel<false><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
