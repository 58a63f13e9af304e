// Frames -> windowed DFT -> power -> mel -> log, the core shared by
// log_mel_wave.cu and fbank_frames.cu (Hopper, sm_90a).
//
// A kernel here is a template over a frame source `Src`: the one thing the
// two .cu files define.  `src.fill` writes a tile of the flattened (M, win)
// frame matrix into shared memory in the compute type (for the waveform
// kernel: framed and preemphasized on the way).  Everything after that is
// the same function: DFT bases and mel matrix given in the compute type,
// products summed in f32, power rounded to the compute type before the mel
// product, then ln(x + floor) or 10*log10(max(x, floor)).
//
// bf16 compute: log_mel_mma_kernel, tensor cores (wgmma.m64n64k16 for the
// DFT, wgmma.m64n80k16 for the mel product, bf16 x bf16 -> f32; the products
// are exact in f32, so only the order of the f32 sums differs from the plain
// PyTorch version).
//   * A block owns MT = 128 frames, held in shared memory as bf16 at a row
//     stride of KP + 8 (KP = win rounded up to 16): the 16 bytes of padding
//     put the 8 rows of an ldmatrix on distinct banks.  Its two warpgroups
//     own 64 frames each, a warp 16 of them.
//   * The loops run bins-outer.  The operands come packed by the host
//     (ops/fbank.py:pack_dft_operands) in chunks of 32 bins: 64 basis rows
//     (32 of re, 32 of im) over K, then 80 mel rows over the chunk's bins,
//     both in the core-matrix order that a wgmma descriptor without swizzle
//     reads.  One thread starts a chunk's copy from L2 as two bulk copies
//     (TMA) that complete on an mbarrier; the basis rows go round a ring of
//     buffers, the mel rows round a ring of their own.
//   * A is read from registers, B from shared memory.  Up to win 400 a warp
//     loads the A fragments of all 25 k-steps once (100 registers); a chunk is
//     then one uninterrupted run of 25 wgmma, the frames' space becomes a
//     third buffer of the ring, and with two accumulators in turn chunk j+1's
//     wgmma is started before chunk j's power and mel product, which run
//     beside it.  For longer windows the fragments are loaded k-step by
//     k-step, two sets in turn, and the chunks follow each other.
//   * The accumulator of a chunk is eight n8 tiles, re then im, each laid out
//     as an mma.sync accumulator.  A warp forms re^2 + im^2 in these registers,
//     rounds to bf16, and feeds each pair of tiles straight in as an A
//     fragment of the mel wgmma (the accumulator layout of two adjacent n8
//     tiles is the A layout of a k-step).  Power never leaves registers; the
//     (16 x 80) f32 mel tile stays in registers until the log.
//   * Only wgmma writes an accumulator (the first of a run overwrites it): an
//     ordinary instruction that did so while a wgmma is in flight would make
//     ptxas wait after every wgmma (its remark C7515).
//   * More than 80 mels: blockIdx.y walks groups of 80 (the DFT is
//     recomputed for each group).  Any n_freqs; win up to 576 by shared
//     memory.  Frames past M compute on zeros and are masked on the store.
//   * What binds it at (128, 16000) (tools/bench_logmel.py --phases, H100): of
//     a block's 34 000 clocks the chunks take 17 500, against 15 100 for
//     their wgmma at the card's peak, and the frames' way into shared memory
//     11 500, which nothing overlaps (one block a SM).  A block has 8 warps, so
//     each instruction outside the wgmma costs about 5 clocks: the fill moves
//     four samples an instruction and the log is the hardware's for that
//     reason.
//
// f32 compute: log_mel_fma_kernel, the CUDA cores (TF32 would keep ~3
// digits and break the f32 tolerance).  One block per 32 frames; each
// thread keeps 4 frames x 9 bins of re and im; the bases are staged 8 rows
// at a time through shared memory.  Not a serving type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Built with -DDFT_PHASE_CLOCKS (tools/bench_logmel.py --phases), the bf16 kernel's
// first block writes clock64() at its phase boundaries; dft_phase_clocks_read copies
// them out after a launch.
#ifdef DFT_PHASE_CLOCKS
__device__ long long dft_phase_clocks[8];
#define DFT_CLOCK(i) \
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) dft_phase_clocks[i] = clock64()
extern "C" int dft_phase_clocks_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, dft_phase_clocks, sizeof(dft_phase_clocks));
}
#else
#define DFT_CLOCK(i)
#endif

namespace dft {

// ---- packed-operand geometry (ops/fbank.py:pack_dft_operands writes it) ----
constexpr int BINS = 32;        // bins per chunk: a wgmma of n = 64, re then im
constexpr int NB = BINS / 16;   // k-steps of the mel wgmma per chunk
constexpr int DFT_TILES = BINS / 8;  // n8 accumulator tiles of re, as many of im
constexpr int KPAD = 8;         // bf16 of padding after each K row of the frames
constexpr int MEL_GROUP = 80;   // mels per block: a wgmma of n = 80
constexpr int MEL_TILES = MEL_GROUP / 8;
constexpr int MEL_ELEMS = MEL_GROUP * BINS;  // a chunk's mel rows for one group of mels

constexpr int WARPS = 8;        // 16 frames (one m16 tile) a warp
constexpr int THREADS = 32 * WARPS;
constexpr int MT = 16 * WARPS;  // frames per block
constexpr int KRES = 25;        // k-steps of A a warp can keep in registers (win <= 400)
constexpr int BARS = 4;         // mbarriers: chunk j's copy completes on barrier j % BARS
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may ask for

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Warpgroup mma: d (m64n64 f32, 16 rows a warp, each n8 tile laid out as an
// mma.sync accumulator) += a (m64k16 bf16 from registers, each warp's 16 rows as
// an mma.sync A fragment) * b (k16n64 bf16 in shared memory, by descriptor).
// With `accumulate` 0, d = a * b whatever d held.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t b_desc, int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
}
// The same with n = 80, for the mel product.
__device__ __forceinline__ void wgmma_m64n80k16(float (&d)[10][4], const uint32_t (&a)[4],
                                                uint64_t b_desc, int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from reading an accumulator before the wait for its wgmma
template <int N> __device__ __forceinline__ void fence_registers(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
template <int V> struct Int { static constexpr int value = V; };
// orders what ordinary loads and stores did to shared memory before what the
// async proxy (bulk copies, wgmma's reads) does next
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a wgmma B operand (rows x K, K contiguous) held without swizzle
// as core matrices of 8 rows x 8 k, each 128 contiguous bytes: the matrix at
// `p` (bits 0-13, in units of 16 bytes), the next along K 128 bytes on (bits
// 16-29), the next 8 rows `row_group_bytes` on (bits 32-45).  A k-step of 16
// moves the start by 256 bytes: add 16 to the descriptor.
__device__ __forceinline__ uint64_t b_descriptor(const void* p, int row_group_bytes) {
  return ((uint64_t)(row_group_bytes >> 4) << 32) | ((uint64_t)(128 >> 4) << 16) |
         (uint64_t)((smem_u32(p) >> 4) & 0x3FFF);
}

// Bulk copies (TMA) that complete on an mbarrier.  One thread arms the barrier
// with the bytes to come and starts the copies; every thread then waits for
// the barrier's phase.  The copies and wgmma's reads both go through the async
// proxy, so no proxy fence stands between them.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// dst, src and bytes multiples of 16
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Wait for the phase of `parity` (the barrier's n-th use has parity n & 1).  A
// copy that never lands traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (int spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (spins > (1 << 20)) __trap();
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as JAX's astype
}

// four values, converted to T, to p (16-byte aligned for float, 8 for bf16)
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A frame source `Src` has `fill<R>(dst, stride, rows, m0, m_frames, win, stage,
// cap)`: it writes samples [0, win) of the tile's frames m0 + f < m_frames (f <
// rows) to dst[f * stride + c], converted to T; R is rows / (warps of the
// block).  `stage` is `cap` >= win values of shared memory, 16-byte aligned,
// that it may use as scratch; it leaves the block synchronized if it does.
// The kernels zero what is left with zero_rest.

// For a source whose frame m starts at row_ptr(m): each warp copies its R rows,
// lane by lane along a row (coalesced), the loads of all R rows started before
// the first store: enough bytes in flight to cover the latency of device
// memory.  Four samples a lane where every row starts on a 16-byte boundary
// (the block has few warps, so the instructions per sample are what it costs),
// else one.
template <int R, typename T, typename RowPtr>
__device__ __forceinline__ void fill_rows(T* dst, int stride, int m0, int m_frames, int win,
                                          RowPtr row_ptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (win % 4 == 0 && stride % 4 == 0 && aligned16(row_ptr(0))) {
    for (int c = 4 * lane; c < win; c += 128) {
      float4 v[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int m = m0 + warp * R + i;
        v[i] = __ldg(reinterpret_cast<const float4*>(row_ptr(m < m_frames ? m : 0) + c));
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (m0 + warp * R + i < m_frames) store4(dst + (warp * R + i) * stride + c, v[i]);
    }
    return;
  }
  for (int c = lane; c < win; c += 32) {
    float v[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = m0 + warp * R + i;
      v[i] = __ldg(row_ptr(m < m_frames ? m : 0) + c);  // no branch around the load
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (m0 + warp * R + i < m_frames) dst[(warp * R + i) * stride + c] = cvt<T>(v[i]);
  }
}

// Zero what the products read beyond the frames: the columns [win, kp) of the
// tile's valid rows (K padded to whole k-steps) and the rows past the last
// frame, which compute on zeros and are masked on the store.
template <typename T>
__device__ __forceinline__ void zero_rest(T* dst, int stride, int rows, int m0, int m_frames,
                                          int win, int kp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int valid = min(rows, m_frames - m0);
  if (win < kp)
    for (int f = warp; f < valid; f += warps)
      for (int c = win + lane; c < kp; c += 32) dst[f * stride + c] = cvt<T>(0.f);
  for (int f = valid + warp; f < rows; f += warps)
    for (int c = lane; c < kp; c += 32) dst[f * stride + c] = cvt<T>(0.f);
}

// re^2 + im^2 without FMA contraction, as the plain version computes it
__device__ __forceinline__ float power_of(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// FAST: the hardware's base-2 logarithm (absolute error of lg2 below 2^-21), far
// inside what a flipped bf16 rounding of one power bin moves the bf16 kernel's
// output; a fifth of the instructions of logf.
template <bool FAST>
__device__ __forceinline__ float log_of(float v, int log_db, float log_floor) {
  if constexpr (FAST)
    return log_db ? 10.f * __log10f(fmaxf(v, log_floor)) : __logf(v + log_floor);
  return log_db ? 10.f * log10f(fmaxf(v, log_floor)) : logf(v + log_floor);
}

// ---------------------------------------------------------------- bf16, mma

template <typename Src, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
log_mel_mma_kernel(const Src src, const __nv_bfloat16* __restrict__ packed,
                   float* __restrict__ out, int m_frames, int win, int ks, int n_chunks,
                   int n_mels, int nmp, int stages, int log_db, float log_floor) {
  // Shared memory: the frames, `stages` buffers for the basis rows of a chunk (2,
  // or 1 for the longest windows), the mel rows of the chunks in flight.  With
  // RESIDENT the frames are dead once every warp holds its A fragments, and
  // their space is a third buffer.
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int kp = ks - KPAD;               // K: win rounded up to 16
  const int basis_elems = 2 * BINS * kp;  // 64 basis rows (re, then im)
  const int mel_slots = RESIDENT ? 4 : stages;
  __nv_bfloat16* frames = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // MT x ks
  __nv_bfloat16* ring = frames + MT * ks;                              // stages x basis_elems
  __nv_bfloat16* mel_ring = ring + stages * basis_elems;               // mel_slots x MEL_ELEMS
  uint64_t* bars = reinterpret_cast<uint64_t*>(mel_ring + mel_slots * MEL_ELEMS);  // BARS
  const size_t chunk_elems = (size_t)basis_elems + (size_t)nmp * BINS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * MT;
  const int mel0 = blockIdx.y * MEL_GROUP;

  auto basis_of = [&](int j) {
    if constexpr (RESIDENT) return j % 3 == 2 ? frames : ring + (j % 3) * basis_elems;
    return ring + (j % stages) * basis_elems;
  };
  auto mel_of = [&](int j) { return mel_ring + (j % mel_slots) * MEL_ELEMS; };
  // Thread 0 starts the copy of chunk j: its basis rows, then this block's 80 mel
  // rows, both onto barrier j % BARS, which every thread waits on with `landed`.
  // Before it, every thread is done with the buffers (`release`).
  auto start_copy = [&](int j) {
    if (tid != 0 || j >= n_chunks) return;
    const __nv_bfloat16* g = packed + (size_t)j * chunk_elems;
    uint64_t* bar = bars + j % BARS;
    mbar_expect(bar, (basis_elems + MEL_ELEMS) * 2);
    bulk_copy(basis_of(j), g, basis_elems * 2, bar);
    bulk_copy(mel_of(j), g + basis_elems + (size_t)blockIdx.y * MEL_ELEMS, MEL_ELEMS * 2, bar);
  };
  auto release = [&] {
    fence_proxy_async();  // ordinary loads and stores touched them (the frames, the scratch)
    __syncthreads();
  };
  auto landed = [&](int j) { mbar_wait(bars + j % BARS, (j / BARS) & 1); };
  if (tid == 0) {
    for (int i = 0; i < BARS; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  DFT_CLOCK(0);  // start
  if (stages > 1) start_copy(0);

  // the tile's frames, rounded to bf16; zero past win and past the last frame
  // (scratch for the source: the last buffer beside the frames, not yet copied into)
  src.template fill<16>(frames, ks, MT, m0, m_frames, win, ring + (stages - 1) * basis_elems,
                        basis_elems);
  zero_rest(frames, ks, MT, m0, m_frames, win, kp);
  DFT_CLOCK(1);  // the frames are in shared memory

  // A fragment of a warp's 16 frames x 16 k by ldmatrix: lanes 0-15 give rows
  // 0-15 at k 0, lanes 16-31 the same rows at k 8.
  const uint32_t a_base = smem_u32(frames + (warp * 16 + (lane & 15)) * ks + (lane >> 4) * 8);

  // A chunk's accumulator: n8 tiles of its bins, re then im.  Its power, 16
  // bins at a time, is an A fragment of the mel wgmma (the accumulator layout of
  // two adjacent n8 tiles is the A layout of a k-step).  `first`: macc is
  // overwritten, not added to (no other instruction ever writes it).
  float macc[MEL_TILES][4];
  uint32_t pa[NB][4];
  auto mel_product = [&](float (&acc)[2 * DFT_TILES][4], int j) {
    fence_registers(acc);  // not read before the wait above this call
#pragma unroll
    for (int n = 0; n < DFT_TILES; ++n) {
      const float(&re)[4] = acc[n], (&im)[4] = acc[DFT_TILES + n];
      pa[n / 2][2 * (n % 2)] = pack_bf16(power_of(re[0], im[0]), power_of(re[1], im[1]));
      pa[n / 2][2 * (n % 2) + 1] = pack_bf16(power_of(re[2], im[2]), power_of(re[3], im[3]));
    }
    const uint64_t m_desc = b_descriptor(mel_of(j), BINS * 16);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < NB; ++n) wgmma_m64n80k16(macc, pa[n], m_desc + n * 16, j > 0 || n > 0);
    wgmma_commit();
  };

  if constexpr (RESIDENT) {
    // A of all k-steps stays in registers: loaded once, then a chunk is one
    // uninterrupted run of wgmma that reads only B from shared memory.  Two
    // accumulators in turn: chunk j + 1's wgmma is started before chunk j's
    // power and mel product, which then run beside it.
    uint32_t a[KRES][4];
    float acc[2][2 * DFT_TILES][4];
    auto dft = [&](float (&d)[2 * DFT_TILES][4], int j) {
      const uint64_t b_desc = b_descriptor(basis_of(j), kp * 16);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < KRES; ++i)  // the first overwrites d: no other instruction writes it
        if (i * 16 < kp) wgmma_m64n64k16(d, a[i], b_desc + i * 16, i > 0);
      wgmma_commit();
    };
    // chunk j in acc[P]: its wgmma is in flight, chunk j + 1's copy under way
    auto step = [&](auto parity, int j) {
      constexpr int P = decltype(parity)::value;
      if (j + 1 < n_chunks) {
        release();        // every warp is past chunk j-1 (or, j = 0, holds its A fragments)
        // basis over that of chunk j-1 (j = 0: over the frames), mel over that of chunk j-2
        start_copy(j + 2);
        landed(j + 1);
        dft(acc[1 - P], j + 1);
      }
      // all done but the newest group: chunk j's wgmma, and the mel wgmma that read pa
      if (j + 1 < n_chunks) wgmma_wait<1>(); else wgmma_wait<0>();
      mel_product(acc[P], j);
    };
    release();  // the frames visible; the source is done with its scratch
    start_copy(1);
    landed(0);
#pragma unroll
    for (int i = 0; i < KRES; ++i)
      if (i * 16 < kp) ldmatrix_x4(a[i], a_base + i * 32);
    dft(acc[0], 0);
    DFT_CLOCK(2);  // chunk 0 landed, A in registers, the first wgmma started
    for (int j = 0; j < n_chunks; j += 2) {
      step(Int<0>{}, j);
      if (j + 1 < n_chunks) step(Int<1>{}, j + 1);
    }
  } else {
    for (int j = 0; j < n_chunks; ++j) {
      release();  // the frames visible; every warp is past chunk j-1
      start_copy(stages == 1 ? j : j + 1);  // one buffer: its copy is not overlapped
      landed(j);

      const uint64_t b_desc = b_descriptor(basis_of(j), kp * 16);
      float acc[2 * DFT_TILES][4];
      // Two sets of A fragments: the one wgmma k-step i-1 read is loaded for
      // k-step i+1 as soon as that wgmma is done, while k-step i runs.  The load
      // past the last k-step reads the row padding; nothing uses it.
      uint32_t a0[4], a1[4];
      ldmatrix_x4(a0, a_base);
#pragma unroll 1
      for (int k = 0; k < kp; k += 32) {
        wgmma_fence();
        wgmma_m64n64k16(acc, a0, b_desc + k, k > 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (k + 16 < kp) {
          ldmatrix_x4(a1, a_base + (k + 16) * 2);
          wgmma_fence();
          wgmma_m64n64k16(acc, a1, b_desc + k + 16);
          wgmma_commit();
          wgmma_wait<1>();
          ldmatrix_x4(a0, a_base + (k + 32) * 2);
        }
      }
      wgmma_wait<0>();
      mel_product(acc, j);
      wgmma_wait<0>();
    }
  }
  wgmma_wait<0>();
  fence_registers(macc);
  DFT_CLOCK(3);  // all chunks done

  // log and store.  macc[i] holds rows lane/4 and lane/4 + 8, mels 8i +
  // 2*(lane%4) and + 1: a pair a lane, so with an even n_mels 4 lanes write a
  // whole 32-byte sector of a row.
  const bool pairs = (n_mels & 1) == 0;  // then every pair is 8-byte aligned
#pragma unroll
  for (int i = 0; i < MEL_TILES; ++i) {
    const int mel = mel0 + 8 * i + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp * 16 + (lane >> 2) + 8 * h;
      if (m >= m_frames || mel >= n_mels) continue;
      float* p = out + (size_t)m * n_mels + mel;
      const float v0 = log_of<true>(macc[i][2 * h], log_db, log_floor);
      const float v1 = log_of<true>(macc[i][2 * h + 1], log_db, log_floor);
      if (pairs) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
      } else {
        p[0] = v0;
        if (mel + 1 < n_mels) p[1] = v1;
      }
    }
  }
  DFT_CLOCK(4);  // stored
}

// packed: (n_chunks, 2 * BINS * kp + nmp * BINS) bf16 from pack_dft_operands (nmp: n_mels
// rounded up to whole groups of 80); out (m_frames, n_mels) f32.
template <typename Src>
int launch_mma(const Src& src, const void* packed, void* out, int m_frames, int win, int n_freqs,
               int n_mels, int log_db, float log_floor, cudaStream_t stream) {
  const int kp = (win + 15) / 16 * 16, ks = kp + KPAD;
  const int n_chunks = (n_freqs + BINS - 1) / BINS;
  const int groups = (n_mels + MEL_GROUP - 1) / MEL_GROUP;
  const size_t frames_bytes = (size_t)MT * ks * 2, basis_bytes = (size_t)2 * BINS * kp * 2;
  const bool resident = kp <= 16 * KRES;
  // basis buffers beside the frames: 2 where they fit (always with `resident`), else 1;
  // mel rows: 4 chunks' with `resident`, else as many as basis buffers
  int stages = 2;
  auto bytes = [&] {
    return frames_bytes + stages * basis_bytes + (resident ? 4 : stages) * MEL_ELEMS * 2 + BARS * 8;
  };
  if (bytes() > SMEM_LIMIT) stages = 1;
  const size_t smem = bytes();
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = resident ? log_mel_mma_kernel<Src, true> : log_mel_mma_kernel<Src, false>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((m_frames + MT - 1) / MT, groups);
  kernel<<<grid, THREADS, smem, stream>>>(
      src, static_cast<const __nv_bfloat16*>(packed), static_cast<float*>(out), m_frames, win, ks,
      n_chunks, n_mels, groups * MEL_GROUP, stages, log_db, log_floor);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32, fma

constexpr int FT = 32;             // frames per block
constexpr int FPT = 4;             // frames per thread (one warp shares them)
constexpr int FMA_THREADS = 256;   // 8 warps x FPT = FT frames
constexpr int KJ = 9;              // bins per lane: FMA_BINS = 32 * KJ >= n_freqs
constexpr int FMA_BINS = 32 * KJ;
constexpr int NC = 8;              // basis rows staged per step

template <typename Src>
__global__ void __launch_bounds__(FMA_THREADS)
log_mel_fma_kernel(const Src src, const float* __restrict__ wr, const float* __restrict__ wi,
                   const float* __restrict__ mel, float* __restrict__ out, int m_frames, int win,
                   int n_freqs, int n_mels, int log_db, float log_floor) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sig = reinterpret_cast<float*>(smem_raw);  // FT x win (zero past the last frame)
  float* br = sig + FT * win;                       // NC x FMA_BINS
  float* bi = br + NC * FMA_BINS;                   // NC x FMA_BINS
  float* power = sig;                               // FT x n_freqs, reuses the space after the DFT

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * FT;
  const int rows = min(FT, m_frames - t0);

  // 1. the tile's frames
  src.template fill<FPT>(sig, win, FT, t0, m_frames, win, br, 2 * NC * FMA_BINS);
  zero_rest(sig, win, FT, t0, m_frames, win, win);

  // 2. windowed DFT: re/im for FPT frames x KJ bins per thread
  const int f0 = warp * FPT;
  float re[FPT][KJ], im[FPT][KJ];
#pragma unroll
  for (int q = 0; q < FPT; ++q)
#pragma unroll
    for (int j = 0; j < KJ; ++j) re[q][j] = im[q][j] = 0.f;

  for (int c0 = 0; c0 < win; c0 += NC) {
    __syncthreads();  // frames written / previous basis rows consumed
    for (int i = tid; i < NC * FMA_BINS; i += FMA_THREADS) {
      const int r = i / FMA_BINS, k = i - r * FMA_BINS, row = c0 + r;
      float vr = 0.f, vi = 0.f;
      if (row < win && k < n_freqs) {
        vr = wr[row * n_freqs + k];
        vi = wi[row * n_freqs + k];
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
        const float vr = br[r * FMA_BINS + lane + 32 * j];
        const float vi = bi[r * FMA_BINS + lane + 32 * j];
#pragma unroll
        for (int q = 0; q < FPT; ++q) {
          re[q][j] = fmaf(xs[q], vr, re[q][j]);
          im[q][j] = fmaf(xs[q], vi, im[q][j]);
        }
      }
    }
  }
  __syncthreads();  // all reads of sig/br/bi done before power overwrites them

  // 3. power
#pragma unroll
  for (int q = 0; q < FPT; ++q)
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int k = lane + 32 * j;
      if (k < n_freqs) power[(f0 + q) * n_freqs + k] = power_of(re[q][j], im[q][j]);
    }
  __syncthreads();

  // 4. mel product and log
  for (int i = tid; i < rows * n_mels; i += FMA_THREADS) {
    const int f = i / n_mels, m = i - f * n_mels;
    const float* pw = power + f * n_freqs;
    float acc = 0.f;
    for (int k = 0; k < n_freqs; ++k) acc = fmaf(pw[k], mel[k * n_mels + m], acc);
    out[(size_t)(t0 + f) * n_mels + m] = log_of<false>(acc, log_db, log_floor);
  }
}

// wr, wi (win, n_freqs) and mel (n_freqs, n_mels) f32; out (m_frames, n_mels) f32.
template <typename Src>
int launch_fma(const Src& src, const void* wr, const void* wi, const void* mel, void* out,
               int m_frames, int win, int n_freqs, int n_mels, int log_db, float log_floor,
               cudaStream_t stream) {
  if (n_freqs > FMA_BINS) return (int)cudaErrorInvalidValue;
  int floats = FT * win + 2 * NC * FMA_BINS;
  if (FT * n_freqs > floats) floats = FT * n_freqs;
  const size_t smem = (size_t)floats * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(log_mel_fma_kernel<Src>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (m_frames + FT - 1) / FT;
  log_mel_fma_kernel<Src><<<grid, FMA_THREADS, smem, stream>>>(
      src, static_cast<const float*>(wr), static_cast<const float*>(wi),
      static_cast<const float*>(mel), static_cast<float*>(out), m_frames, win, n_freqs, n_mels,
      log_db, log_floor);
  return (int)cudaGetLastError();
}

}  // namespace dft
