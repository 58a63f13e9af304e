// Fused identify scoring for Hopper (sm_90a): cosine -> max over windows ->
// top-k of each 512-row tile of profile rows, with f32-accurate products on
// the tensor cores (3xTF32, mma.sync), in two passes.
//
// Replaces the Pallas kernel sdtk_tpu/ops/research/topk_pallas.py:29
// identify_topk_pallas.  Queries (W, D) f32 and profiles (N, D) f32 or bf16,
// neither normalized.  With x normalized as x * rsqrt(sum x^2 + 1e-24), the
// function is m_j = max over windows w of qn_w . pn_j, and the result the
// top min(k, N) rows by m, score descending, lower row first among equal
// scores.  The (W, N) score matrix never reaches device memory.
//
// Bound: at the catalog shape W = 64, N = 100 000, D = 192 with f32
// profiles the card must read 76.8 MB (22.9 us at 3.35 TB/s) and do
// 2 WND = 2.46 GFLOP of f32-accurate products.  The fastest f32-accurate
// route on the card is three TF32 tensor-core products (3xTF32), 495 / 3 =
// 165 TFLOP/s: 14.9 us.  So bytes bind (22.9 us).  Bf16 profile values
// are exact in TF32, so two TF32 products are f32-accurate there (495 / 2
// TFLOP/s: 9.9 us), and bytes bind again (38.4 MB, 11.5 us).  On the f32
// CUDA cores (67 TFLOP/s) the products alone would take 36.7 us.
//
// Design.  The TPU kernel runs its grid in order, one 2048-row tile a step,
// and selects with k unrolled max+mask passes.  Here the product and the
// selection are separate kernels, so that each has the blocks it needs:
//
//   identify_topk_split: the queries normalized and split once a call into
//   TF32 halves, big = tf32(qn) and small = tf32(qn - big) (round to
//   nearest, ties away, as cvt.rna.tf32.f32), into a (2, W, D) scratch.
//
//   Pass A, identify_topk_max: a persistent grid, one block of 8 warps an
//   SM (its shared memory is 166-218 KB).  The split query chunk of up to
//   64 windows is copied into the block's shared memory once, and, when
//   W <= 64 and D <= 224, kept there for every tile the block walks (wider
//   rows go in slabs of 224 columns).  The block's four warp pairs share
//   that copy and nothing else: each walks its own tiles of 32 profile rows
//   (N = 8 192 gives 256 tiles, N = 100 000 gives 3 125) with its own ring
//   and barriers, so that one pair's landing and waiting overlap the
//   others' products.  Profile rows stream through a pair's 3-stage ring of
//   16-byte cp.async copies, 32 columns a chunk, that runs two chunks ahead
//   across tiles (scalar copies when D or the pointer is not 16-byte
//   aligned).  As a chunk lands it is split once:
//   big halves in place, small halves beside them (bf16 rows widen to f32
//   values that TF32 holds exactly, so they have no small half and take
//   two products, not three), and each row's sum of squares accumulates
//   from it, so a profile row is read from device memory once.  Each warp
//   owns 32 windows x 32 rows: mma.sync.m16n8k8 TF32 into f32, small x big
//   and big x small first, then big x big; fragments are read as float4,
//   with the k slots of two k8 steps laid on four adjacent columns, from
//   rows padded to 16 mod 32 floats, so no read conflicts.  The inverse
//   norm of a profile row is applied after the window max,
//   m_j = inv_p_j * max_w(qn_w . p_j): a positive f32 factor is monotone,
//   so the max is the same.  Windows past W are left out of the max.  m
//   goes to device memory as (N,) f32 (0.4 MB at catalog scale, against
//   76.8 MB of profiles read).
//
//   Pass B, identify_topk_select: a block bitonic-sorts a tile of 512 rows
//   of m by (score, row), one pair a thread (rows past N at -inf, behind
//   every real row), and writes the first kc = min(k, 512).  Every global
//   top-k row ranks <= k in its own tile, and for k >= 512 every row
//   survives, so the wrapper's merge of the survivors (ops/topk_fused.py,
//   as the JAX wrapper merges with lax.top_k) is exact for any k.
//

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

// Built with -DTOPK_PHASE_CLOCKS (tools/bench_topk.py --phases), thread 0 of
// pass A's first block sums the SM clocks it spends in each phase;
// identify_topk_phase_clocks_read copies them out after a launch.
#ifdef TOPK_PHASE_CLOCKS
__device__ long long topk_phase_clocks[8];
#define TOPK_CLOCK_START long long t_last = clock64(), t_sum[6] = {0, 0, 0, 0, 0, 0}
#define TOPK_CLOCK(i)                     \
  do {                                    \
    const long long t_now = clock64();    \
    t_sum[i] += t_now - t_last;           \
    t_last = t_now;                       \
  } while (0)
#define TOPK_CLOCK_STORE                                             \
  if (blockIdx.x == 0 && threadIdx.x == 0)                           \
    for (int i = 0; i < 6; ++i) topk_phase_clocks[i] = t_sum[i]
extern "C" int identify_topk_phase_clocks_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, topk_phase_clocks, sizeof(topk_phase_clocks));
}
#else
#define TOPK_CLOCK_START
#define TOPK_CLOCK(i)
#define TOPK_CLOCK_STORE
#endif

namespace {

constexpr int BR = 32;        // profile rows per tile of a warp pair
constexpr int PAIRS = 4;      // warp pairs in a block, each walking its own tiles
constexpr int PT = 64;        // threads of a warp pair
constexpr int THREADS = PAIRS * PT;
constexpr int WC = 64;        // windows per chunk: a pair's two warps take 32 each
constexpr int BK = 32;        // columns per ring stage
constexpr int NST = 3;        // ring stages
constexpr int DS = 224;       // columns of a query slab held in shared memory
constexpr int LDP = BK + 16;  // f32 stage row; = 16 mod 32 floats: conflict-free float4 fragments
constexpr int SEL_TILE = 512;  // rows per pass-B tile, one a thread

template <typename T>
__host__ __device__ constexpr int raw_ld() {  // elements of T per ring row (16-byte multiple)
  return std::is_same<T, float>::value ? LDP : BK + 16;  // bf16: 8-byte reads conflict-free
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Row stride of the split queries in device memory: D rounded up to 4.
__host__ __device__ constexpr int split_ld(int d) { return cdiv(d, 4) * 4; }
// Columns per query row in shared memory: the slab rounded up to BK, + 16.
__host__ __device__ inline int query_ld(int d) { return cdiv(imin(d, DS), BK) * BK + 16; }

template <typename T>
size_t smem_bytes(int d) {
  // big and small query halves (shared by the pairs); each pair's ring and
  // the small half (f32) or the widened chunk (bf16) of its landed chunk
  return (size_t)2 * WC * query_ld(d) * 4 +
         (size_t)PAIRS * (NST * BR * raw_ld<T>() * sizeof(T) + BR * LDP * 4);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A barrier for the 64 threads of warp pair `pair` (barrier 0 is the block's).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(pair + 1), "n"(PT) : "memory");
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as an f32:
// what cvt.rna.tf32.f32 gives for finite x, in two integer instructions
// (half a TF32 ulp added to the magnitude, the 13 low bits cleared).
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// c += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32 in, f32 out.
__device__ __forceinline__ void mma_tf32(float (&c)[4], float a0, float a1, float a2, float a3,
                                         float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
        "r"(__float_as_uint(a3)), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// (score, row) order of the result: higher score first, then lower row.
__device__ __forceinline__ bool worse(float sa, int ia, float sb, int ib) {
  return sa < sb || (sa == sb && ia > ib);
}

// Where a warp pair is in its stream of ring chunks: its tile, window
// chunk, query slab and chunk of columns, in that nesting (tile outermost).
struct Cursor {
  int tile, wc, s0, kc;
};

__device__ __forceinline__ int slab_chunks(int s0, int d) { return cdiv(imin(d - s0, DS), BK); }

__device__ __forceinline__ void advance(Cursor& c, int nwc, int d, int stride) {
  if (++c.kc < slab_chunks(c.s0, d)) return;
  c.kc = 0;
  if ((c.s0 += DS) < d) return;
  c.s0 = 0;
  if (++c.wc < nwc) return;
  c.wc = 0;
  c.tile += stride;
}

// Rows base.. of p, columns k0..k0+BK into one ring stage of a pair (pt:
// the thread within the pair); zeros past N and D.
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(T* st, const T* __restrict__ p, int base, int k0, int n,
                                           int d, int pt) {
  constexpr int LD = raw_ld<T>(), PER = 16 / sizeof(T), ROW = BK / PER;
  if (VEC) {
#pragma unroll
    for (int u = 0; u < BR * ROW / PT; ++u) {
      const int i = pt + u * PT, r = i / ROW, c = (i % ROW) * PER, g = base + r;
      const bool ok = g < n && k0 + c < d;  // d % PER == 0: a chunk is whole or empty
      cp_async16(st + r * LD + c, ok ? p + (size_t)g * d + k0 + c : p, ok ? 16 : 0);
    }
  } else {
    for (int i = pt; i < BR * BK; i += PT) {
      const int r = i / BK, c = i % BK, g = base + r;
      st[r * LD + c] = (g < n && k0 + c < d) ? p[(size_t)g * d + k0 + c] : T(0.f);
    }
  }
}

// A pair's landed stage, split for 3xTF32, adding each row's squares to
// ss[0..1] when `norms`.  Thread (warp v of the pair, lane l) takes rows
// 8v + l/4 and 16 more, columns 4(l % 4) + 16i: a quarter warp reads two
// rows' 64 bytes, which lie in the two halves of the banks.  f32: the big
// halves replace the stage in place, the small halves go to `aux`.  bf16:
// the values widen into `aux`; they are TF32 already, so there is no small
// half.  Returns the big halves.
template <typename T>
__device__ __forceinline__ const float* land(T* st, float* aux, bool norms, float (&ss)[2], int pt,
                                             int pair) {
  const int r0 = (pt >> 5) * 8 + ((pt & 31) >> 2), c0 = 4 * (pt & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < BK / 16; ++i) {
      const int r = r0 + 16 * h, c = c0 + 16 * i;
      float4 v;
      if constexpr (std::is_same<T, float>::value) {
        v = *reinterpret_cast<const float4*>(st + r * LDP + c);
        const float4 big = make_float4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
        *reinterpret_cast<float4*>(st + r * LDP + c) = big;
        *reinterpret_cast<float4*>(aux + r * LDP + c) =
            make_float4(tf32(v.x - big.x), tf32(v.y - big.y), tf32(v.z - big.z), tf32(v.w - big.w));
      } else {
        const uint2 raw = *reinterpret_cast<const uint2*>(st + r * raw_ld<T>() + c);
        v.x = __uint_as_float(raw.x << 16);  // bf16 -> f32 is the top half of the f32 word
        v.y = __uint_as_float(raw.x & 0xffff0000u);
        v.z = __uint_as_float(raw.y << 16);
        v.w = __uint_as_float(raw.y & 0xffff0000u);
        *reinterpret_cast<float4*>(aux + r * LDP + c) = v;
      }
      if (norms) ss[h] = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, ss[h]))));
    }
  pair_sync(pair);
  if constexpr (std::is_same<T, float>::value)
    return st;
  else
    return aux;
}

// Windows w0.. and columns s0..s0+min(D-s0, DS) of the split queries
// (big halves, then small) into qb and qsm, zeros past W up to the next 32
// (a warp's windows); 16-byte cp.async copies, all in flight at once.  A
// block-wide step: every pair reaches it at the same window chunk and
// slab.  The wait also drains the thread's ring copies.
__device__ void stage_queries(float* qb, float* qsm, const float* __restrict__ qsplit, int w0,
                              int s0, int w, int d, int ldq, int warp, int lane) {
  __syncthreads();  // earlier readers of qb and qsm are done
  const int cols = imin(d - s0, DS), ld = split_ld(d);
  const int rows = imin(cdiv(w - w0, 32) * 32, WC);  // the rows that live warps read
  const float* small = qsplit + (size_t)w * ld;
  for (int r = warp; r < rows; r += THREADS / 32)
    for (int c = 4 * lane; c < ldq; c += 128) {
      const bool ok = w0 + r < w && c < cols;
      const size_t at = (size_t)(w0 + r) * ld + s0 + c;
      cp_async16(qb + r * ldq + c, ok ? qsplit + at : qsplit, ok ? 16 : 0);
      cp_async16(qsm + r * ldq + c, ok ? small + at : qsplit, ok ? 16 : 0);
    }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// After a pair barrier: the maxima a finished (tile, window chunk) left in
// red into the running max of its rows, and at the tile's end
// m = inv_p * max (threads 0..31 of the pair, one row each).
__device__ __forceinline__ void merge_maxima(int& pending, int tile, float& best,
                                             const float (&red)[2][BR], const float* inv_p,
                                             float* __restrict__ m, int n, int pt) {
  if (pending && pt < BR) {
    best = fmaxf(best, fmaxf(red[0][pt], red[1][pt]));
    if (pending == 2) {
      if (tile * BR + pt < n) m[tile * BR + pt] = best * inv_p[pt];
      best = -CUDART_INF_F;
    }
  }
  pending = 0;
}

}  // namespace

// The kernels sit outside the anonymous namespace, so that their names in a
// profile start with identify_topk_.

// The queries normalized and split for 3xTF32 once a call: qsplit holds
// (2, W, split_ld(D)) f32, big halves then small, zeros in the padding.
// One warp a window.
__global__ void __launch_bounds__(256)
identify_topk_split(const float* __restrict__ q, float* __restrict__ qsplit, int w, int d) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= w) return;
  const int ld = split_ld(d);
  const float* x = q + (size_t)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(x[c], x[c], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float inv = rsqrtf(s + 1e-24f);
  for (int c = lane; c < ld; c += 32) {
    const float v = c < d ? x[c] * inv : 0.f, big = tf32(v);
    qsplit[(size_t)row * ld + c] = big;
    qsplit[(size_t)(w + row) * ld + c] = tf32(v - big);
  }
}

// Pass A.  Four warp pairs share the block's query copy; each walks its own
// 32-row tiles with its own ring and barriers, so that one pair's landing
// and waiting overlap the others' products.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
identify_topk_max(const float* __restrict__ qsplit, const T* __restrict__ p,
                  float* __restrict__ m, int w, int n, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float inv_p[PAIRS][BR], red[PAIRS][2][BR];
  constexpr int RLD = raw_ld<T>();
  constexpr bool F32 = std::is_same<T, float>::value;
  const int ldq = query_ld(d);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = warp >> 1, pt = tid & (PT - 1);
  const int g = lane >> 2, t = lane & 3;  // mma fragment row and column group
  const int wq = (warp & 1) * 32;         // the warp's windows within the chunk
  float* qb = reinterpret_cast<float*>(smem);
  float* qsm = qb + WC * ldq;
  T* ring = reinterpret_cast<T*>(qsm + WC * ldq) + pair * NST * BR * RLD;
  float* aux = reinterpret_cast<float*>(reinterpret_cast<T*>(qsm + WC * ldq) +
                                        PAIRS * NST * BR * RLD) + pair * BR * LDP;

  const int ntiles = cdiv(n, BR), nwc = cdiv(w, WC), stride = gridDim.x * PAIRS;
  const bool resident = nwc == 1 && d <= DS;  // one query chunk for every tile
  // Copying a new query chunk is a block-wide step, so without a resident
  // chunk every pair walks the same number of tiles (those past N zero).
  const int limit = resident ? ntiles : cdiv(ntiles, stride) * stride;
  TOPK_CLOCK_START;
  if (resident) stage_queries(qb, qsm, qsplit, 0, 0, w, d, ldq, warp, lane);
  TOPK_CLOCK(0);

  // The ring runs NST - 1 chunks ahead of the products, across tiles.
  Cursor ahead{(int)blockIdx.x * PAIRS + pair, 0, 0, 0}, at = ahead;
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (ahead.tile < limit) {
      load_stage<T, VEC>(ring + s * BR * RLD, p, ahead.tile * BR, ahead.s0 + ahead.kc * BK, n, d,
                         pt);
      advance(ahead, nwc, d, stride);
    }
    cp_async_commit();
  }

  float acc[2][4][4];  // [window m16][row n8][fragment]
  float best = -CUDART_INF_F, ss[2] = {0.f, 0.f};
  // A finished (tile, window chunk) leaves its maxima in red; they are
  // merged after the next barrier (1: into best, 2: and the tile's m
  // written), so that finishing one costs no barrier of its own.
  int pending = 0, pending_tile = 0;
  for (int slot = 0; at.tile < limit; slot = slot + 1 == NST ? 0 : slot + 1) {
    const int w0 = at.wc * WC;
    if (at.kc == 0) {
      if (!resident) stage_queries(qb, qsm, qsplit, w0, at.s0, w, d, ldq, warp, lane);
      if (at.s0 == 0)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      TOPK_CLOCK(0);
    }
    cp_async_wait<NST - 2>();
    pair_sync(pair);  // chunk `at` landed; the previous chunk's readers are done
    merge_maxima(pending, pending_tile, best, red[pair], inv_p[pair], m, n, pt);
    TOPK_CLOCK(1);
    if (ahead.tile < limit) {
      load_stage<T, VEC>(ring + (slot == 0 ? NST - 1 : slot - 1) * BR * RLD, p, ahead.tile * BR,
                         ahead.s0 + ahead.kc * BK, n, d, pt);
      advance(ahead, nwc, d, stride);
    }
    cp_async_commit();
    const float* pb = land(ring + slot * BR * RLD, aux, at.wc == 0, ss, pt, pair);
    TOPK_CLOCK(2);
    if (w0 + wq < w) {  // this warp has a window before W
      // Within 16 columns, thread t holds columns 4t..4t+3 of its rows: the
      // first k8 step takes 4t, 4t+1 as its k slots t, t+4, the second
      // 4t+2, 4t+3.  A and B use the same order, so the sum is the same.
      const float* qk = qb + at.kc * BK + 4 * t;
      const float* qs = qsm + at.kc * BK + 4 * t;
#pragma unroll
      for (int k = 0; k < BK; k += 16) {
        float4 ab[2][2], as[2][2], bb[4], bs[4];  // A: [m16][rows g, g + 8]; B: [n8]
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = (wq + 16 * i + 8 * h + g) * ldq + k;
            ab[i][h] = *reinterpret_cast<const float4*>(qk + row);
            as[i][h] = *reinterpret_cast<const float4*>(qs + row);
          }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = (8 * j + g) * LDP + k + 4 * t;
          bb[j] = *reinterpret_cast<const float4*>(pb + row);
          bs[j] = F32 ? *reinterpret_cast<const float4*>(aux + row) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        // small terms first, then big x big; the 8 accumulators in turn, so
        // that no mma waits for the one before it
#pragma unroll
        for (int term = 0; term < 6; ++term) {
          const bool second = term >= 3;  // the k8 step of columns 4t+2, 4t+3
          const int kind = term % 3;      // small x big, big x small, big x big
          if (!F32 && kind == 1) continue;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float4 lo = kind == 0 ? as[i][0] : ab[i][0], hi = kind == 0 ? as[i][1] : ab[i][1];
            const float a0 = second ? lo.z : lo.x, a1 = second ? hi.z : hi.x;
            const float a2 = second ? lo.w : lo.y, a3 = second ? hi.w : hi.y;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 b = kind == 1 ? bs[j] : bb[j];
              mma_tf32(acc[i][j], a0, a1, a2, a3, second ? b.z : b.x, second ? b.w : b.y);
            }
          }
        }
      }
    }
    TOPK_CLOCK(3);

    if (at.kc + 1 == slab_chunks(at.s0, d) && at.s0 + DS >= d) {  // (tile, window chunk) done
      // max over this thread's 4 windows (those past W left out), then over
      // the 8 lanes and the 2 warps that share a row.  Fragment e of
      // acc[i][j] is window wq + 16i + g + 8(e / 2), row 8j + 2t + e % 2.
      const int wb = w0 + wq + g;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float mx = -CUDART_INF_F;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (wb + 16 * i < w) mx = fmaxf(mx, acc[i][j][e]);
            if (wb + 16 * i + 8 < w) mx = fmaxf(mx, acc[i][j][e + 2]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          if (g == 0) red[pair][warp & 1][8 * j + 2 * t + e] = mx;
        }
      if (at.wc == 0) {  // every column of the tile has passed through `land`
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
          ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
          if ((lane & 3) == 0) inv_p[pair][(pt >> 5) * 8 + (lane >> 2) + 16 * h] = rsqrtf(ss[h] + 1e-24f);
          ss[h] = 0.f;
        }
      }
      pending = at.wc + 1 == nwc ? 2 : 1;
      pending_tile = at.tile;
      TOPK_CLOCK(4);
    }
    advance(at, nwc, d, stride);
  }
  pair_sync(pair);
  merge_maxima(pending, pending_tile, best, red[pair], inv_p[pair], m, n, pt);
  TOPK_CLOCK(5);
  TOPK_CLOCK_STORE;
}

// Bitonic sort of a 512-row tile of m, one (score, row) pair a thread:
// partners closer than a warp swap by shuffle, farther ones through shared
// memory.  The first kc pairs are written out, rows as int64 (the index
// type of the wrapper's merge).
__global__ void __launch_bounds__(SEL_TILE)
identify_topk_select(const float* __restrict__ m, float* __restrict__ cand_s,
                     long long* __restrict__ cand_i, int n, int kc) {
  __shared__ float xs[SEL_TILE];
  __shared__ int xr[SEL_TILE];
  const int i = threadIdx.x, g = blockIdx.x * SEL_TILE + i;
  float s = g < n ? m[g] : -CUDART_INF_F;
  int r = g;
  for (int size = 2; size <= SEL_TILE; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      float os;
      int orow;
      if (stride >= 32) {
        xs[i] = s;
        xr[i] = r;
        __syncthreads();
        os = xs[i ^ stride];
        orow = xr[i ^ stride];
        __syncthreads();
      } else {
        os = __shfl_xor_sync(0xffffffffu, s, stride);
        orow = __shfl_xor_sync(0xffffffffu, r, stride);
      }
      // an ascending run (best first) keeps the better pair at its lower index
      const bool keep_better = ((i & stride) == 0) == ((i & size) == 0);
      if (worse(s, r, os, orow) == keep_better) {
        s = os;
        r = orow;
      }
    }
  if (i < kc) {
    cand_s[(size_t)blockIdx.x * kc + i] = s;
    cand_i[(size_t)blockIdx.x * kc + i] = r;
  }
}

namespace {

// Pass A on the current device: the shared-memory limit raised once per
// process (again only for a wider D), and a persistent grid of as many
// blocks as fit on the SMs, at most one per PAIRS tiles.
template <typename T, bool VEC>
cudaError_t launch_max(const float* qsplit, const T* p, float* m, int w, int n, int d,
                       cudaStream_t s) {
  static size_t raised = 0;  // per instantiation
  static int grid_for = -1, grid_cap = 0;
  const size_t bytes = smem_bytes<T>(d);
  cudaError_t err;
  if (bytes > raised) {
    err = cudaFuncSetAttribute(identify_topk_max<T, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    raised = bytes;
  }
  if (grid_for != (int)bytes) {
    int dev, sms, per_sm;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, identify_topk_max<T, VEC>,
                                                             THREADS, bytes)) != cudaSuccess)
      return err;
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
    grid_for = (int)bytes;
  }
  const int blocks = cdiv(cdiv(n, BR), PAIRS);
  identify_topk_max<T, VEC><<<imin(blocks, grid_cap), THREADS, bytes, s>>>(qsplit, p, m, w, n,
                                                                           d);
  return cudaGetLastError();
}

}  // namespace

// q (w, d) f32; p (n, d) in bf16 when `bf16` is nonzero, else f32; qsplit
// (2, w, ceil(d / 4) * 4) f32 scratch, 16-byte aligned; m (n,) f32 scratch;
// cand_s (ceil(n / 512), kc) f32 and cand_i (ceil(n / 512), kc) int64,
// 1 <= kc <= 512.  All contiguous on the current device.  The three kernels (the
// queries' split, pass A, pass B) go on `stream`.  Returns a cudaError_t.
extern "C" int identify_topk_launch(const void* q, const void* p, void* qsplit, void* m,
                                    void* cand_s, void* cand_i, int w, int n, int d, int kc,
                                    int bf16, void* stream) {
  if (w <= 0 || n <= 0 || d <= 0 || kc <= 0 || kc > SEL_TILE) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* qf = static_cast<float*>(qsplit);
  float* mf = static_cast<float*>(m);
  identify_topk_split<<<cdiv(w, 8), 256, 0, s>>>(static_cast<const float*>(q), qf, w, d);
  const bool aligned = reinterpret_cast<uintptr_t>(p) % 16 == 0;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (bf16) {
    const auto* pb = static_cast<const __nv_bfloat16*>(p);
    err = aligned && d % 8 == 0 ? launch_max<__nv_bfloat16, true>(qf, pb, mf, w, n, d, s)
                                : launch_max<__nv_bfloat16, false>(qf, pb, mf, w, n, d, s);
  } else {
    const auto* pf = static_cast<const float*>(p);
    err = aligned && d % 4 == 0 ? launch_max<float, true>(qf, pf, mf, w, n, d, s)
                                : launch_max<float, false>(qf, pf, mf, w, n, d, s);
  }
  if (err != cudaSuccess) return (int)err;
  identify_topk_select<<<cdiv(n, SEL_TILE), SEL_TILE, 0, s>>>(
      mf, static_cast<float*>(cand_s), static_cast<long long*>(cand_i), n, kc);
  return (int)cudaGetLastError();
}
