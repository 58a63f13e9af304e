// Fused cosine scoring for Hopper (sm_90a): f32-accurate products on the
// tensor cores (3xTF32, mma.sync), the rows' inverse norms applied after the
// product.
//
// Replaces the Pallas kernel sdtk_tpu/ops/cosine.py:94 cosine_pallas:
// queries (Q, D) and profiles (N, D) f32, neither normalized, give the
// (Q, N) f32 matrix out_ij = (q_i . p_j) inv_q_i inv_p_j with
// inv_x = rsqrt(sum x^2 + 1e-24), which is the product of the rows
// normalized as the TPU kernel normalizes them.  A zero row scores exactly
// 0 (every product of it is 0).
//
// Bound: at the dense identify shape (29, 8 192, 192) the card must move
// 4 (QD + ND + QN) = 7.26 MB, 2.17 us at 3.35 TB/s, and do 2 QND =
// 91.2 MFLOP of f32-accurate products.  Its fastest route for them is three
// TF32 tensor-core products (3xTF32), 495 / 3 = 165 TFLOP/s: 0.55 us.  So
// bytes bind, four to one, and the profiles are 87 % of them.  For a
// 5-minute query, (199, 8 192, 192), bytes (3.87 us) and 3xTF32 products
// (3.79 us) are even; on the f32 CUDA cores (67 TFLOP/s) the products alone
// would take 9.3 us.
//
// Design.  A block of 4 warps owns one tile of 32 profile rows (N = 8 192
// gives 256 tiles: at most 107 KB of shared memory a block, so two blocks a
// SM and every tile in flight in one wave on 132 SMs) and walks the queries
// in chunks of 32 rows (29 pads to 32).
//
//   Landing.  A tile is one block's whole work at Q <= 32, so there is no
//   steady state for a ring to reach: the whole tile (24 KB at D = 192) and
//   the first query chunk are issued at once as 16-byte cp.async copies
//   (4-byte copies when D % 4 != 0 or a pointer is not 16-byte aligned), and
//   the kernel pays one memory round trip.  Each of a warp's column groups
//   is a commit group of its own, so its products start as soon as it has
//   landed, under the copies of the next.  The queries are read from device
//   memory (L2-resident, 22 KB at Q = 29) by every block and need no
//   separate launch.  With D <= 224 the tile stays resident while the next
//   query chunk lands in a second stage (chunks looped in the block measured
//   faster than chunks in the grid's y, which re-read the tile); wider rows
//   go through two stages of 128-column slabs of tile and queries.  In shared memory a row's 16
//   columns of a group lie 16 floats apart (= 16 mod 32), so the float4
//   fragment reads below are free of bank conflicts without padding.
//
//   Products.  The columns are cut into groups of 16, and warp w takes
//   groups w, w + 4, ...: its own columns, which it alone copies and reads,
//   so landing needs no block barrier.  Each warp accumulates all 32 x 32
//   outputs of its groups in 8 mma.sync.m16n8k8 accumulators.  Every landed
//   value is read by one lane once a query chunk, as a float4 fragment (the
//   k slots of two k8 steps on four adjacent columns, alike for A and B),
//   squared into its row's sum, and split in registers into big = tf32(x)
//   and small = tf32(x - big) (round to nearest, ties away); the products
//   run small x big and big x small first, then big x big, the 8
//   accumulators in turn so that no mma waits for the one before it.  So a
//   profile row is read from device memory once, and its norm comes from
//   the landed values.
//
//   Epilogue.  The four warps' partial products and row sums meet in
//   shared memory; each thread sums four adjacent outputs, scales them by
//   inv_q inv_p and writes them as one 16-byte store (scalar stores when
//   N % 4 != 0), a warp writing whole 128-byte rows.  Rows past Q and
//   columns past N are masked; zeros fill what lies past Q, N and D.

#include <cuda_runtime.h>
#include <stdint.h>

// Built with -DCOSINE_PHASE_CLOCKS, thread 0 of block 0 sums the SM clocks it
// spends waiting for copies, in products and in the epilogue;
// cosine_phase_clocks_read copies them out after a launch.
#ifdef COSINE_PHASE_CLOCKS
__device__ long long cosine_phase_clocks[3];
#define COSINE_CLOCK_START long long t_last = clock64(), t_sum[3] = {0, 0, 0}
#define COSINE_CLOCK(i)                   \
  do {                                    \
    const long long t_now = clock64();    \
    t_sum[i] += t_now - t_last;           \
    t_last = t_now;                       \
  } while (0)
#define COSINE_CLOCK_STORE                                           \
  if (blockIdx.x == 0 && threadIdx.x == 0)                           \
    for (int i = 0; i < 3; ++i) cosine_phase_clocks[i] = t_sum[i]
extern "C" int cosine_phase_clocks_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, cosine_phase_clocks, sizeof(cosine_phase_clocks));
}
#else
#define COSINE_CLOCK_START
#define COSINE_CLOCK(i)
#define COSINE_CLOCK_STORE
#endif

namespace {

constexpr int QC = 32;                  // query rows per chunk
constexpr int BR = 32;                  // profile rows per tile: one block
constexpr int WARPS = 4;                // warp w takes column groups w, w + 4, ...
constexpr int THREADS = WARPS * 32;
constexpr int GW = 16;                  // columns per group
constexpr int GROUP = 32 * GW;          // floats of a group of 32 rows
constexpr int RESIDENT_GROUPS = 14;     // D <= 224: the tile lands whole and stays
constexpr int SLAB_GROUPS = 8;          // wider rows: 128-column slabs, two stages
constexpr int LDR = BR + 8;             // row of a warp's partial products

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Column groups in a slab: all of D's when the tile is resident.
__host__ __device__ constexpr int slab_groups(int d) {
  return cdiv(d, GW) <= RESIDENT_GROUPS ? cdiv(d, GW) : SLAB_GROUPS;
}

// Resident: the tile and two query stages; else two stages of a tile slab
// and a query slab.  Then the four warps' partial products.
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return ((size_t)(cdiv(d, GW) <= RESIDENT_GROUPS ? 3 : 4) * slab_groups(d) * GROUP +
          (size_t)WARPS * QC * LDR) * sizeof(float);
}
constexpr size_t SMEM_RESIDENT = smem_bytes(RESIDENT_GROUPS * GW);  // the widest resident tile
constexpr size_t SMEM_SLABS = smem_bytes(RESIDENT_GROUPS * GW + 1);
constexpr size_t SMEM_MAX = SMEM_RESIDENT > SMEM_SLABS ? SMEM_RESIDENT : SMEM_SLABS;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Wait until at most n of this thread's commit groups are in flight (n < 8:
// a warp has at most 4 groups of an item, and one item ahead).
__device__ __forceinline__ void cp_async_wait_for(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as an f32:
// what cvt.rna.tf32.f32 gives for finite x, in two integer instructions.
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// c += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32 in, f32
// out.  Not volatile, so that ptxas may interleave independent accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], float a0, float a1, float a2, float a3,
                                         float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
        "r"(__float_as_uint(a3)), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// Rows row0..row0+31 (zeros from `rows` on), columns col0..col0+15 (zeros
// from d on) of x (rows of d floats) into one group in shared memory, by
// the 32 lanes of a warp: four 16-byte copies a lane, four lanes a row.
template <bool VEC>
__device__ __forceinline__ void load_group(float* dst, const float* __restrict__ x, int row0,
                                           int rows, int col0, int d, int lane) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = lane + 32 * u, r = i >> 2, c = 4 * (i & 3), row = row0 + r, col = col0 + c;
    float* s = dst + r * GW + c;
    if (VEC) {  // d % 4 == 0: four columns are all before d or all past it
      const bool ok = row < rows && col < d;
      cp_async16(s, ok ? x + (size_t)row * d + col : x, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row < rows && col + e < d;
        cp_async4(s + e, ok ? x + (size_t)row * d + col + e : x, ok ? 4 : 0);
      }
    }
  }
}

__device__ __forceinline__ float4 tf32_big(float4 v) {
  return make_float4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
}
__device__ __forceinline__ float4 tf32_small(float4 v, float4 big) {
  return make_float4(tf32(v.x - big.x), tf32(v.y - big.y), tf32(v.z - big.z), tf32(v.w - big.w));
}
__device__ __forceinline__ float squares(float4 v, float s) {
  return fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, s))));
}

// One group of 16 columns into the warp's 32 x 32 products.  Lane (g, t)
// reads columns 4t..4t+3 of query rows 16i + 8h + g and of profile rows
// 8j + g: the first k8 step takes columns 4t, 4t+1 as its k slots t, t+4,
// the second 4t+2, 4t+3 (A and B alike, so the sum is the same).  Adds the
// squares of what it reads to sq (queries) and, when `pnorm`, sp (profiles).
__device__ __forceinline__ void group_product(float (&acc)[2][4][4], float (&sq)[2][2],
                                              float (&sp)[4], const float* qg, const float* pg,
                                              bool pnorm, int g, int t) {
  float4 ab[2][2], as[2][2], bb[4], bs[4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(qg + (16 * i + 8 * h + g) * GW + 4 * t);
      sq[i][h] = squares(v, sq[i][h]);
      ab[i][h] = tf32_big(v);
      as[i][h] = tf32_small(v, ab[i][h]);
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(pg + (8 * j + g) * GW + 4 * t);
    if (pnorm) sp[j] = squares(v, sp[j]);
    bb[j] = tf32_big(v);
    bs[j] = tf32_small(v, bb[j]);
  }
  // small terms first, then big x big; the 8 accumulators in turn
#pragma unroll
  for (int term = 0; term < 6; ++term) {
    const bool second = term >= 3;  // the k8 step of columns 4t+2, 4t+3
    const int kind = term % 3;      // small x big, big x small, big x big
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

// A lane's row sums, over the 4 lanes of a row, into part[8 * slot + g].
__device__ __forceinline__ void store_rows(float* part, float s, int slot, int g, int t) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  if (t == 0) part[8 * slot + g] = s;
}

}  // namespace

// Outside the anonymous namespace, so that its name in a profile starts
// with cosine_.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
cosine_kernel(const float* __restrict__ q, const float* __restrict__ p, float* __restrict__ out,
              int nq, int np, int d, int vec_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sq_part[WARPS][QC], sp_part[WARPS][BR];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int groups = cdiv(d, GW), sg = slab_groups(d), nslab = cdiv(groups, sg);
  const bool resident = nslab == 1;
  const int items = cdiv(nq, QC) * nslab, row0 = blockIdx.x * BR;
  // resident: [tile][stage 0: queries][stage 1: queries]; else stages of
  // [queries][tile]; then the partial products
  const int stage = (resident ? 1 : 2) * sg * GROUP;
  float* const stages = smem + (resident ? sg * GROUP : 0);
  float* const red = stages + 2 * stage;
  COSINE_CLOCK_START;

  // Item k is query chunk k / nslab, slab k % nslab, in stage k % 2.
  // Each of the warp's groups is a commit group of its own, so that its
  // products start as soon as it has landed.  A warp copies and reads only
  // its own groups, so a warp barrier orders it.
  auto mine = [&](int k) {  // this warp's groups in item k
    const int ng = imin(sg, groups - (k % nslab) * sg);
    return ng > warp ? cdiv(ng - warp, WARPS) : 0;
  };
  auto issue = [&](int k) {
    const int c = k / nslab, s = k % nslab;
    float* st = stages + (k & 1) * stage;
    for (int i = 0, gl = warp; i < mine(k); ++i, gl += WARPS) {
      const int col0 = (s * sg + gl) * GW;
      load_group<VEC>(st + gl * GROUP, q, c * QC, nq, col0, d, lane);
      if (!resident)
        load_group<VEC>(st + (sg + gl) * GROUP, p, row0, np, col0, d, lane);
      else if (k == 0)
        load_group<VEC>(smem + gl * GROUP, p, row0, np, col0, d, lane);
      cp_async_commit();
    }
  };

  float acc[2][4][4], sq[2][2], sp[4] = {0.f, 0.f, 0.f, 0.f}, ip[4];
  issue(0);
  for (int k = 0; k < items; ++k) {
    const int c = k / nslab, s = k % nslab;
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sq[i][0] = sq[i][1] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      }
    }
    const int next = k + 1 < items ? mine(k + 1) : 0, cnt = mine(k);
    if (next) issue(k + 1);
    const float* st = stages + (k & 1) * stage;
    const float* tile = resident ? smem : st + sg * GROUP;
    for (int i = 0, gl = warp; i < cnt; ++i, gl += WARPS) {
      cp_async_wait_for(cnt - 1 - i + next);  // group i of item k landed
      __syncwarp();
      COSINE_CLOCK(0);
      group_product(acc, sq, sp, st + gl * GROUP, tile + gl * GROUP, k < nslab, g, t);
      COSINE_CLOCK(1);
    }
    __syncwarp();  // stage k % 2 read before item k + 2 is copied into it
    if (s + 1 < nslab) continue;

    // Chunk c done: the warps' partial products and row sums meet in
    // shared memory.  Fragment e of acc[i][j] is query row 16i + g + 8(e/2),
    // profile row 8j + 2t + e % 2.
    float* rw = red + warp * QC * LDR;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float2*>(rw + (16 * i + g) * LDR + 8 * j + 2 * t) =
            make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(rw + (16 * i + g + 8) * LDR + 8 * j + 2 * t) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) store_rows(sq_part[warp], sq[i][h], 2 * i + h, g, t);
    if (k < nslab)
#pragma unroll
      for (int j = 0; j < 4; ++j) store_rows(sp_part[warp], sp[j], j, g, t);
    __syncthreads();

    // Four adjacent outputs a thread, scaled by both inverse norms: the
    // thread's columns are the same in every chunk, so their inverse norms
    // are taken once.
    const int cc = 4 * (threadIdx.x % (BR / 4)), col = row0 + cc;
    if (k < nslab)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ip[e] = rsqrtf(sp_part[0][cc + e] + sp_part[1][cc + e] + sp_part[2][cc + e] +
                       sp_part[3][cc + e] + 1e-24f);
#pragma unroll
    for (int m = 0; m < QC * BR / 4 / THREADS; ++m) {
      const int r = threadIdx.x / (BR / 4) + m * (THREADS / (BR / 4)), row = c * QC + r;
      if (row >= nq || col >= np) continue;
      float4 v = *reinterpret_cast<const float4*>(red + r * LDR + cc);
#pragma unroll
      for (int w = 1; w < WARPS; ++w) {
        const float4 o = *reinterpret_cast<const float4*>(red + w * QC * LDR + r * LDR + cc);
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
      const float iq =
          rsqrtf(sq_part[0][r] + sq_part[1][r] + sq_part[2][r] + sq_part[3][r] + 1e-24f);
      const float o[4] = {v.x * iq * ip[0], v.y * iq * ip[1], v.z * iq * ip[2], v.w * iq * ip[3]};
      float* dst = out + (size_t)row * np + col;
      if (vec_out) {  // np % 4 == 0: the four columns are all before np
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < np) dst[e] = o[e];
      }
    }
    if (k + 1 < items) __syncthreads();  // the partials read before the next chunk writes them
    COSINE_CLOCK(2);
  }
  COSINE_CLOCK_STORE;
}

namespace {

// The shared-memory limit and carveout are raised once a process (per
// instantiation), to what the widest layout needs.
template <bool VEC>
cudaError_t launch(const float* q, const float* p, float* out, int nq, int np, int d, int vec_out,
                   cudaStream_t s) {
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        cosine_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_MAX);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cosine_kernel<VEC>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  cosine_kernel<VEC><<<cdiv(np, BR), THREADS, smem_bytes(d), s>>>(q, p, out, nq, np, d, vec_out);
  return cudaGetLastError();
}

}  // namespace

// q (nq, d), p (np, d), out (nq, np): float32, contiguous, on the current
// device.  Returns a cudaError_t.
extern "C" int cosine_launch(const void* q, const void* p, void* out, int nq, int np, int d,
                             void* stream) {
  if (nq <= 0 || np <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* pf = static_cast<const float*>(p);
  auto* of = static_cast<float*>(out);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const int vec_out = np % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<true>(qf, pf, of, nq, np, d, vec_out, s)
                   : launch<false>(qf, pf, of, nq, np, d, vec_out, s));
}
