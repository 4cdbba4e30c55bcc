// Variants of the frozen-correspondence scoring block, for the variant
// studies that ran on the TPU:
//
// * the variant kernels replace experiments/kernel_variants.py:make_kernel
//   (zdtype x reduction x particle tile) and
//   experiments/pallas_variants.py:make_scores (dot_dot, dot_vpusum,
//   vpu_outer x tile):  out[b, j] = -sum_n mask[b, n] *
//   exp(-max(z[b, n, j], 0) / 2),  z = w[b, n, :] . phi[b, j, :];
// * the block kernels replace experiments/rollout_score_variants.py:make_kernel
//   (base, exp2, noclamp, bf16mm, bf16all): I serial iterations of the
//   [N, P] score block of one solve and its column sums, each iteration tied
//   to the last by the minimum over all P particles.
//
// Each TPU variant axis keeps its GPU form:
// * z route (ZR).  kZF32: the FP32 pipes, an fmaf chain in feature order.
//   kZOuter: the FP32 pipes, the feature-outer loop z = z + phi_f * w_f,
//   every product and sum rounded (no FMA), in feature order.  kZBF16: the
//   tensor cores, mma.sync.m16n8k16 on bf16 operands (rounded to nearest
//   even), f32 accumulation.  kZTF32: the tensor cores, mma.sync.m16n8k8 on
//   TF32 operands (cvt.rna: 10 mantissa bits, ties away from zero).
// * point reduction (RED).  kRedCores: mask * s summed on the FP32 pipes
//   (fmaf; exact products for a 0/1 mask).  kRedMMA: a second mma, the
//   scores and the mask its operands, in bf16 on the bf16 route and TF32
//   otherwise (s and mask rounded so).
// * particles per block: the TPU tile (grid = B x ceil(P / tile)).
//
// What bounds them on an H100.  The FP32 routes: the FP32 pipes, 16
// multiply-adds per (point, particle) pair (the outer route's 16 products
// and 16 sums each take an issue slot), plus the clamp, the exp's argument
// and the sum.  The tensor-core routes: the one exp per pair on the
// special-function units (16 lanes per SM against 128 FP32 lanes).  Bytes
// are a few percent of either.  The first version (one warp per 16
// particles for every route, w rows read from shared memory with 4-way bank
// conflicts, the full expf) ran 32-48 SASS instructions per pair on the FP32
// routes and reached 6.5-29% of its bound; its E3 kernel ran one 512-thread
// block per solve, 64 of 132 SMs at B=64.  This design:
//
// * The register-tile routes (variant_kernel_tile: f32 and outer with the
//   reduction on the cores; block_kernel_f32: E3's base, exp2, noclamp) take
//   K3's inner loop (score.cu): each thread holds 4 particles' phi in
//   registers and walks the points n = 0..N-1 in order; each w row is four
//   broadcast LDS.128 for 4 independent chains; the sum over points is in
//   order in one thread.
// * w staged as -w/2 where the score is exp(-max(z, 0)/2) (f32, outer, TF32,
//   base, noclamp): a power of two, so z' = -z/2 bit for bit and no multiply
//   by -1/2 is left in the loop.  TF32 w is rounded first and then halved
//   (exact; the mma aligns its sum to the largest term, so halved operands
//   give the halved sum unless something underflows).  exp2's -log2(e)/2
//   and bf16all's bf16 chain are not powers of two and keep their multiply;
//   bf16mm and the bf16 route keep w as bf16 and multiply z by -1/2, since
//   their time goes to the exps, not to the FP32 pipes.
// * max(z, 0) as PTX min.NaN / max.NaN, which keeps a NaN.
// * exp(u) as 2^(u log2 e) on MUFU.EX2 (ex2.approx.ftz, the instruction
//   exp2f itself compiles to, without its subnormal guard): a score below
//   2^-126 counts 0, every other one is within |u| 2^-24 relative of
//   exp2f's.  exp2 and bf16all's 2^e are MUFU.EX2 as exp2f is.
// * f32 z with the reduction on the tensor cores (variant_kernel_tmma: E1's
//   v0, v0t) keeps the register tile, transposed for the mma: a warp holds
//   32 particles, lane (g, q) the 4 particles g + 8t and the points q, q + 4
//   of every 8; the reduction mma takes the mask as A (its rows all alike)
//   and the TF32 scores as B, so each lane's scores are already its B
//   fragment.  w rows are padded to 20 floats, so the 4 rows a warp reads at
//   once fall on 4 distinct bank groups.
// * The tensor-core z routes (variant_kernel_mma; block_kernel_bf16: E3's
//   bf16mm, bf16all) stage w once per block in the order the lanes read
//   their B fragments (TF32: two LDS.128 per 16 points, bf16 pairs: one),
//   and the mask pre-converted in the reduction's form (one LDS.128 or
//   LDS.64 per 16 points, broadcast to the 8 lanes of a column).
// * E3: one solve per thread-block cluster of C CTAs (launch_cluster, C
//   chosen by ops/_build.py:choose_cluster), split over particles: each CTA
//   stages the solve's whole w and scores a contiguous P / C of the
//   particles against all N points, so every particle's point sum keeps its
//   order.  An iteration's minimum is each CTA's minimum, then cluster_min
//   over the C CTAs through distributed shared memory after one cluster
//   barrier (the slot double-buffered by iteration parity); the next
//   iteration's phi * (1 + carry * 0) waits on it, so the iterations still
//   serialise.  At B=64 the f32 kernel runs C=2 (128 CTAs in one wave).
//
// Numerics: --fmad=false, no fast math.  Each route's roundings are those of
// the plain versions in ops/score_variants.py, so a kernel and its plain
// version differ by the order of the sums (the mma's internal order
// included) and the ulps of the exp.

#include <cuda_bf16.h>

#include <algorithm>

#include "pso_common.cuh"

namespace {

namespace cg = cooperative_groups;
using ndt::dot_row;
using ndt::ex2;
using ndt::kLog2e;
using ndt::max_nan;
using ndt::min_nan;

constexpr int kFeat = 16;
constexpr int kTile = 4;             // particles per thread, register-tile routes
constexpr int kTileThreads = 512;    // variant_kernel_tile, at most
constexpr int kTmmaThreads = 512;    // variant_kernel_tmma, at most
constexpr int kMmaThreads = 512;     // variant_kernel_mma, at most
constexpr int kBlockThreads = 512;   // block kernels
constexpr int kRowPad = 20;          // floats per w row, variant_kernel_tmma

enum ZRoute { kZF32 = 0, kZBF16 = 1, kZTF32 = 2, kZOuter = 3 };
enum Reduce { kRedCores = 0, kRedMMA = 1 };
enum Score { kExp = 0, kExp2 = 1, kNoClamp = 2, kBF16All = 3 };

// float32(0.5 * log2(e)) and its bfloat16 rounding (0.7213475 -> 185/256).
constexpr float kLog2eHalf = 0.7213475204444817f;
constexpr float kLog2eHalfBF16 = 0.72265625f;
// -log2(e) / 2, exact from float32(log2 e): z * kNegHalfLog2e rounds to the
// bits of (-z / 2) * log2(e), since -z / 2 is exact.
constexpr float kNegHalfLog2e = -0.5f * kLog2e;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ int smid() {
  int r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

// D += A B, m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B, m16n8k8, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float d[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The score from z' = -z/2 (w staged as -w/2): exp(min(z', 0)), or exp(z')
// without the clamp.
template <bool kClamp = true>
__device__ __forceinline__ float score_half(float zh) {
  return ex2((kClamp ? min_nan(zh, 0.0f) : zh) * kLog2e);
}

// The score from z itself: exp(-max(z, 0)/2) (kExp: score_half of -z/2,
// with the two multiplies folded into one of the same bits), or
// exp2(-log2(e)/2 * max(z, 0)) (kExp2).
template <int SC>
__device__ __forceinline__ float score_raw(float z) {
  if constexpr (SC == kExp2) {
    return ex2(-kLog2eHalf * max_nan(z, 0.0f));
  } else {
    return ex2(min_nan(z * kNegHalfLog2e, 0.0f));
  }
}

// bf16all's scores of two slots: max(z, 0) rounded to bf16, its bf16
// product with bf16(log2(e)/2) (the f32 product of two bf16s is exact, so
// one rounding either way), 2^e rounded to bf16.  Packed conversions and a
// packed multiply, where single F2F conversions (3 per score) held the
// conversion pipe.
__device__ __forceinline__ float2 score_bf16all2(float z0, float z1) {
  const __nv_bfloat162 zc = __floats2bfloat162_rn(max_nan(z0, 0.0f), max_nan(z1, 0.0f));
  const float2 e = __bfloat1622float2(__hmul2(zc, __float2bfloat162_rn(-kLog2eHalfBF16)));
  return __bfloat1622float2(__floats2bfloat162_rn(ex2(e.x), ex2(e.y)));
}

// z of a row loaded as four float4s: the fmaf chain, or the outer route's
// unfused z = z + phi_f * w_f in feature order.
template <int ZR>
__device__ __forceinline__ float row_z(const float4& a, const float4& b, const float4& c,
                                       const float4& d, const float phi[kFeat]) {
  if constexpr (ZR == kZOuter) {
    const float r[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                         c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
    float z = r[0] * phi[0];
#pragma unroll
    for (int f = 1; f < kFeat; ++f) z = z + r[f] * phi[f];
    return z;
  } else {
    return dot_row<kFeat>(a, b, c, d, phi);
  }
}

// Sum across the four lanes that share a particle row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// ---- Staging, in the order the lanes read.

// w [n, 16] as the B fragments of the z mma, for lane (g, q) of group k (the
// points 16 k .. 16 k + 15), zero past n.  bf16 (m16n8k16, bf16 pairs): entry
// k * 32 + lane = {b0, b1} of point 16 k + g, then of 16 k + 8 + g; b0 the
// features (2q, 2q + 1), b1 (2q + 8, 2q + 9).  TF32 (m16n8k8, -w/2 of the
// rounded w): entry (2 k + t) * 32 + lane = the point 16 k + 8 t + g's
// features q, q + 4 (first k-step), 8 + q, 12 + q (second).
template <int ZR>
__device__ void stage_w_frags(const float* wb, int n, int groups, uint4* s_wf, int threads) {
  constexpr int kWords = ZR == kZBF16 ? 1 : 2;  // uint4s per lane and group
  for (int e = threadIdx.x; e < groups * 32 * kWords; e += threads) {
    const int lane = e & 31;
    const int g = lane >> 2;
    const int q = lane & 3;
    auto at = [&](int pt, int f) -> float { return pt < n ? wb[(size_t)pt * kFeat + f] : 0.0f; };
    uint32_t v[4];
    if constexpr (ZR == kZBF16) {
      const int k = e >> 5;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int pt = 16 * k + 8 * t + g;
        v[2 * t] = pack_bf16(at(pt, 2 * q), at(pt, 2 * q + 1));
        v[2 * t + 1] = pack_bf16(at(pt, 2 * q + 8), at(pt, 2 * q + 9));
      }
    } else {
      const int kt = e >> 5;  // 2 k + t
      const int pt = 8 * kt + g;
      const int fs[4] = {q, q + 4, 8 + q, 12 + q};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = __float_as_uint(-0.5f * __uint_as_float(to_tf32(at(pt, fs[i]))));
      }
    }
    s_wf[e] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// The mask of group k for the 8 lanes of column q, in the reduction's form:
// cores, the four floats m[16 k + 2q], m[+1], m[16 k + 8 + 2q], m[+1]; TF32
// mma, the same rounded to TF32; bf16 mma, two bf16 pairs of them.  Zero
// past n.
template <int ZR, int RED>
__device__ void stage_mask_frags(const float* mb, int n, int groups, uint4* s_mf, int threads) {
  for (int e = threadIdx.x; e < groups * 4; e += threads) {
    const int k = e >> 2;
    const int q = e & 3;
    float m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pt = 16 * k + 8 * (i >> 1) + 2 * q + (i & 1);
      m[i] = pt < n ? mb[pt] : 0.0f;
    }
    if constexpr (RED == kRedMMA && ZR == kZBF16) {
      s_mf[e] = make_uint4(pack_bf16(m[0], m[1]), pack_bf16(m[2], m[3]), 0u, 0u);
    } else if constexpr (RED == kRedMMA) {
      s_mf[e] = make_uint4(to_tf32(m[0]), to_tf32(m[1]), to_tf32(m[2]), to_tf32(m[3]));
    } else {
      s_mf[e] = make_uint4(__float_as_uint(m[0]), __float_as_uint(m[1]), __float_as_uint(m[2]),
                           __float_as_uint(m[3]));
    }
  }
}

// The A fragments of a warp's particle rows r0 = pb + g and r1 = pb + g + 8
// (zero at or past `end`) of a feature-major phi [16, P], times `scale`:
// bf16, a[0..3] for m16n8k16; TF32, a[0..3] and a[4..7] for the two k-steps
// of m16n8k8.
template <int ZR>
__device__ __forceinline__ void phi_frags(const float* phi_b, int p, int r0, int r1, int end,
                                          int q, float scale, uint32_t a[8]) {
  auto at = [&](int r, int f) -> float {
    return r < end ? phi_b[(size_t)f * p + r] * scale : 0.0f;
  };
  if constexpr (ZR == kZBF16) {
    a[0] = pack_bf16(at(r0, 2 * q), at(r0, 2 * q + 1));
    a[1] = pack_bf16(at(r1, 2 * q), at(r1, 2 * q + 1));
    a[2] = pack_bf16(at(r0, 2 * q + 8), at(r0, 2 * q + 9));
    a[3] = pack_bf16(at(r1, 2 * q + 8), at(r1, 2 * q + 9));
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      a[4 * s + 0] = to_tf32(at(r0, 8 * s + q));
      a[4 * s + 1] = to_tf32(at(r1, 8 * s + q));
      a[4 * s + 2] = to_tf32(at(r0, 8 * s + q + 4));
      a[4 * s + 3] = to_tf32(at(r1, 8 * s + q + 4));
    }
  }
}

// z of lane (g, q)'s eight slots for group k: slot 4 t + i is particle row
// g + 8 (i >> 1) and point 16 k + 8 t + 2q + (i & 1) (the mma accumulator
// layout).  TF32: z' = -z/2 (w staged halved).
template <int ZR>
__device__ __forceinline__ void group_z(const uint32_t a[8], const uint4* s_wf, int k, int lane,
                                        float z[8]) {
  float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (ZR == kZBF16) {
    const uint4 bw = s_wf[k * 32 + lane];
    mma_bf16(d0, a, bw.x, bw.y);
    mma_bf16(d1, a, bw.z, bw.w);
  } else {
    const uint4 b0 = s_wf[(2 * k) * 32 + lane];
    const uint4 b1 = s_wf[(2 * k + 1) * 32 + lane];
    mma_tf32(d0, a[0], a[1], a[2], a[3], b0.x, b0.y);
    mma_tf32(d0, a[4], a[5], a[6], a[7], b0.z, b0.w);
    mma_tf32(d1, a[0], a[1], a[2], a[3], b1.x, b1.y);
    mma_tf32(d1, a[4], a[5], a[6], a[7], b1.z, b1.w);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    z[i] = d0[i];
    z[4 + i] = d1[i];
  }
}

// ---- E1, E2: the variant kernels.

// f32 or outer z, the reduction on the cores: K3's register tile.  Block
// (b, y) scores particles [y tile, min(P, (y + 1) tile)) of solve b; thread
// t the particles base + t + i blockDim, i < kTile.
template <int ZR>
__global__ void __launch_bounds__(kTileThreads)
variant_kernel_tile(const float* __restrict__ phi,   // [B, 16, P]
                    const float* __restrict__ w,     // [B, N, 16]
                    const float* __restrict__ mask,  // [B, N]
                    float* __restrict__ out,         // [B, P]
                    int n, int p, int tile) {
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [N, 16]: -w / 2
  float* s_mask = s_w + (size_t)n * kFeat;       // [N]
  const int b = blockIdx.x;
  const int threads = blockDim.x;
  const float* wb = w + (size_t)b * n * kFeat;
  for (int e = threadIdx.x; e < n * kFeat; e += threads) s_w[e] = -0.5f * wb[e];
  for (int i = threadIdx.x; i < n; i += threads) s_mask[i] = mask[(size_t)b * n + i];
  __syncthreads();

  const int j0 = blockIdx.y * tile;
  const int j1 = min(p, j0 + tile);
  const float* phi_b = phi + (size_t)b * kFeat * p;
  for (int base = j0 + threadIdx.x; base < j1; base += kTile * threads) {
    float ph[kTile][kFeat];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int j = base + t * threads;
#pragma unroll
      for (int f = 0; f < kFeat; ++f) ph[t][f] = j < j1 ? phi_b[(size_t)f * p + j] : 0.0f;
    }
    float acc[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) acc[t] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float4* r4 = reinterpret_cast<const float4*>(s_w + (size_t)i * kFeat);
      const float4 ra = r4[0], rb = r4[1], rc = r4[2], rd = r4[3];
      const float m = s_mask[i];
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        acc[t] = fmaf(m, score_half(row_z<ZR>(ra, rb, rc, rd, ph[t])), acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int j = base + t * threads;
      if (j < j1) out[(size_t)b * p + j] = -acc[t];
    }
  }
}

// f32 z, the reduction on the tensor cores (TF32).  Warp w of block (b, y)
// takes 32 particles at a time: lane (g, q) holds phi of particles pb + g +
// 8 t, t < 4, and scores them at points q and q + 4 of every 8 (rows read
// from s_w at a stride of kRowPad floats).  Per 8 points and t, one
// m16n8k8: A = the mask (every row alike), B = the TF32 scores; column c of
// D is particle pb + c + 8 t's running sum.
__global__ void __launch_bounds__(kTmmaThreads)
variant_kernel_tmma(const float* __restrict__ phi,   // [B, 16, P]
                    const float* __restrict__ w,     // [B, N, 16]
                    const float* __restrict__ mask,  // [B, N]
                    float* __restrict__ out,         // [B, P]
                    int n, int p, int tile) {
  extern __shared__ float4 smem4[];
  const int n8 = (n + 7) & ~7;
  float* s_w = reinterpret_cast<float*>(smem4);                      // [n8, kRowPad]: -w / 2
  float2* s_m = reinterpret_cast<float2*>(s_w + (size_t)n8 * kRowPad);  // [n8 / 8, 4]
  const int b = blockIdx.x;
  const int threads = blockDim.x;
  const float* wb = w + (size_t)b * n * kFeat;
  for (int e = threadIdx.x; e < n8 * kFeat; e += threads) {
    const int i = e / kFeat;
    s_w[(size_t)i * kRowPad + e % kFeat] = i < n ? -0.5f * wb[e] : 0.0f;
  }
  for (int e = threadIdx.x; e < (n8 / 8) * 4; e += threads) {
    const int i0 = 8 * (e >> 2) + (e & 3);
    const float m0 = i0 < n ? mask[(size_t)b * n + i0] : 0.0f;
    const float m1 = i0 + 4 < n ? mask[(size_t)b * n + i0 + 4] : 0.0f;
    s_m[e] = make_float2(__uint_as_float(to_tf32(m0)), __uint_as_float(to_tf32(m1)));
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int warps = threads >> 5;
  const int j0 = blockIdx.y * tile;
  const int j1 = min(p, j0 + tile);
  const float* phi_b = phi + (size_t)b * kFeat * p;
  for (int pb = j0 + (threadIdx.x >> 5) * 32; pb < j1; pb += warps * 32) {
    float ph[kTile][kFeat];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int j = pb + g + 8 * t;
#pragma unroll
      for (int f = 0; f < kFeat; ++f) ph[t][f] = j < j1 ? phi_b[(size_t)f * p + j] : 0.0f;
    }
    float d[kTile][4];
#pragma unroll
    for (int t = 0; t < kTile; ++t) d[t][0] = d[t][1] = d[t][2] = d[t][3] = 0.0f;
    for (int k = 0; k < n8 / 8; ++k) {
      const float4* ra = reinterpret_cast<const float4*>(s_w + (size_t)(8 * k + q) * kRowPad);
      const float4* rb = reinterpret_cast<const float4*>(s_w + (size_t)(8 * k + q + 4) * kRowPad);
      const float4 a0 = ra[0], a1 = ra[1], a2 = ra[2], a3 = ra[3];
      const float4 b0 = rb[0], b1 = rb[1], b2 = rb[2], b3 = rb[3];
      const float2 mm = s_m[4 * k + q];
      const uint32_t mq = __float_as_uint(mm.x), mq4 = __float_as_uint(mm.y);
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const float s0 = score_half(dot_row<kFeat>(a0, a1, a2, a3, ph[t]));
        const float s1 = score_half(dot_row<kFeat>(b0, b1, b2, b3, ph[t]));
        mma_tf32(d[t], mq, mq, mq4, mq4, to_tf32(s0), to_tf32(s1));
      }
    }
    if (g == 0) {
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int j = pb + 2 * q + 8 * t;
        if (j < j1) out[(size_t)b * p + j] = -d[t][0];
        if (j + 1 < j1) out[(size_t)b * p + j + 1] = -d[t][1];
      }
    }
  }
}

// TF32 or bf16 z on the tensor cores, the reduction on the cores or the
// tensor cores.  A warp takes 16 particles at a time (the mma's rows); a
// block has a warp per 16 particles of its tile, up to kMmaThreads.
template <int ZR, int RED>
__global__ void __launch_bounds__(kMmaThreads)
variant_kernel_mma(const float* __restrict__ phi,   // [B, 16, P]
                   const float* __restrict__ w,     // [B, N, 16]
                   const float* __restrict__ mask,  // [B, N]
                   float* __restrict__ out,         // [B, P]
                   int n, int p, int tile) {
  constexpr int kWords = ZR == kZBF16 ? 1 : 2;
  extern __shared__ float4 smem4[];
  const int groups = (n + 15) / 16;
  uint4* s_wf = reinterpret_cast<uint4*>(smem4);
  uint4* s_mf = s_wf + (size_t)groups * 32 * kWords;
  const int b = blockIdx.x;
  stage_w_frags<ZR>(w + (size_t)b * n * kFeat, n, groups, s_wf, blockDim.x);
  stage_mask_frags<ZR, RED>(mask + (size_t)b * n, n, groups, s_mf, blockDim.x);
  __syncthreads();

  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int j0 = blockIdx.y * tile;
  const int j1 = min(p, j0 + tile);
  const float* phi_b = phi + (size_t)b * kFeat * p;
  for (int pb = j0 + (threadIdx.x >> 5) * 16; pb < j1; pb += warps * 16) {
    const int r0 = pb + g;
    const int r1 = pb + g + 8;
    uint32_t a[8];
    phi_frags<ZR>(phi_b, p, r0, r1, j1, q, 1.0f, a);
    float acc[2] = {0.0f, 0.0f};
    float dr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < groups; ++k) {
      float s[8];
      group_z<ZR>(a, s_wf, k, lane, s);
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = ZR == kZBF16 ? score_raw<kExp>(s[i]) : score_half(s[i]);
      const uint4 mf = s_mf[4 * k + q];
      if constexpr (RED == kRedCores) {
        const float m[4] = {__uint_as_float(mf.x), __uint_as_float(mf.y), __uint_as_float(mf.z),
                            __uint_as_float(mf.w)};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[(i >> 1) & 1] = fmaf(m[2 * (i >> 2) + (i & 1)], s[i], acc[(i >> 1) & 1]);
        }
      } else if constexpr (ZR == kZBF16) {
        const uint32_t sa[4] = {pack_bf16(s[0], s[1]), pack_bf16(s[2], s[3]),
                                pack_bf16(s[4], s[5]), pack_bf16(s[6], s[7])};
        mma_bf16(dr, sa, mf.x, mf.y);
      } else {
        mma_tf32(dr, to_tf32(s[0]), to_tf32(s[2]), to_tf32(s[1]), to_tf32(s[3]), mf.x, mf.y);
        mma_tf32(dr, to_tf32(s[4]), to_tf32(s[6]), to_tf32(s[5]), to_tf32(s[7]), mf.z, mf.w);
      }
    }
    float c0, c1;
    if constexpr (RED == kRedCores) {
      c0 = quad_sum(acc[0]);
      c1 = quad_sum(acc[1]);
    } else {
      c0 = dr[0];  // every column of D holds the row's sum
      c1 = dr[2];
    }
    if (q == 0) {
      if (r0 < j1) out[(size_t)b * p + r0] = -c0;
      if (r1 < j1) out[(size_t)b * p + r1] = -c1;
    }
  }
}

// ---- E3: the block kernels, one solve per cluster.

// The particles [*j0, *j1) of CTA `rank` of `nranks`: a contiguous
// ceil(P / nranks) each.
__device__ __forceinline__ void particle_slice(int p, int nranks, int rank, int* j0, int* j1) {
  const int per = (p + nranks - 1) / nranks;
  *j0 = min(p, rank * per);
  *j1 = min(p, *j0 + per);
}

// The minimum of every thread's `mn` over the cluster, NaN if any is NaN:
// warps, then the CTA into s_cta[parity], then cluster_min after a cluster
// barrier.  All threads of all CTAs call it and get the same bits.
__device__ __forceinline__ float cluster_iteration_min(float mn, float* s_warp, float* s_cta,
                                                       int parity, int nranks) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mn = min_nan(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = mn;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = s_warp[0];
    for (int i = 1; i < kBlockThreads / 32; ++i) m = min_nan(m, s_warp[i]);
    s_cta[parity] = m;
  }
  cg::this_cluster().sync();
  return ndt::cluster_min(&s_cta[parity], nranks);
}

// Adds the scores of lane (g, q)'s eight slots of group k (bf16 z) to its
// two particles' sums, in slot order; a slot past n adds nothing (only the
// last group, kFull false, checks).
template <int SC, bool kFull>
__device__ __forceinline__ void add_group(const uint32_t a[8], const uint4* s_wf, int k, int lane,
                                          int q, int n, float acc[2]) {
  float s[8];
  group_z<kZBF16>(a, s_wf, k, lane, s);
#pragma unroll
  for (int i = 0; i < 8; i += 2) {  // slots i, i + 1: one particle, two points
    const float2 sc = SC == kBF16All ? score_bf16all2(s[i], s[i + 1])
                                     : make_float2(score_raw<SC>(s[i]), score_raw<SC>(s[i + 1]));
    const int pt = 16 * k + 8 * (i >> 2) + 2 * q;
    float& sum = acc[(i >> 1) & 1];
    if (kFull || pt < n) sum = sum + sc.x;
    if (kFull || pt + 1 < n) sum = sum + sc.y;
  }
}

// base, exp2, noclamp: f32 z, K3's register tile.  Block x of the grid is
// CTA x % C of solve x / C.
template <int SC>
__global__ void __launch_bounds__(kBlockThreads, 1)
block_kernel_f32(const float* __restrict__ phit,  // [B, 16, P]
                 const float* __restrict__ w,     // [B, N, 16]
                 float* __restrict__ c_out,       // [B, P]: the last iteration's -sum_n s
                 float* __restrict__ carry_out,   // [B]
                 int* __restrict__ sm_out,        // [B C] or null: each CTA's SM
                 int n, int p, int iters) {
  constexpr bool kHalf = SC != kExp2;  // base, noclamp: w staged as -w/2
  extern __shared__ float4 smem4[];
  __shared__ float s_warp[kBlockThreads / 32];
  __shared__ float s_cta[2];
  float* s_w = reinterpret_cast<float*>(smem4);  // [N, 16]
  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / nranks;
  const int tid = threadIdx.x;
  if (sm_out != nullptr && tid == 0) sm_out[blockIdx.x] = smid();
  const float* wb = w + (size_t)b * n * kFeat;
  for (int e = tid; e < n * kFeat; e += kBlockThreads) s_w[e] = kHalf ? -0.5f * wb[e] : wb[e];
  __syncthreads();

  int j0, j1;
  particle_slice(p, nranks, rank, &j0, &j1);
  const float* phit_b = phit + (size_t)b * kFeat * p;
  float carry = 0.0f;
  for (int it = 0; it < iters; ++it) {
    // pv = phit * (1 + carry * 0): the serial dependency on the last
    // iteration (without fast math nvcc may not fold carry * 0).
    const float scale = 1.0f + carry * 0.0f;
    float mn = INFINITY;
    for (int base = j0 + tid; base < j1; base += kTile * kBlockThreads) {
      float ph[kTile][kFeat];
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int j = base + t * kBlockThreads;
#pragma unroll
        for (int f = 0; f < kFeat; ++f) {
          ph[t][f] = j < j1 ? phit_b[(size_t)f * p + j] * scale : 0.0f;
        }
      }
      float acc[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) acc[t] = 0.0f;
      for (int i = 0; i < n; ++i) {
        const float4* r4 = reinterpret_cast<const float4*>(s_w + (size_t)i * kFeat);
        const float4 ra = r4[0], rb = r4[1], rc = r4[2], rd = r4[3];
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const float z = dot_row<kFeat>(ra, rb, rc, rd, ph[t]);
          float s;
          if constexpr (SC == kExp) {
            s = score_half(z);
          } else if constexpr (SC == kNoClamp) {
            s = score_half<false>(z);
          } else {
            s = score_raw<SC>(z);
          }
          acc[t] = acc[t] + s;
        }
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int j = base + t * kBlockThreads;
        if (j < j1) {
          const float c = -acc[t];
          if (it == iters - 1) c_out[(size_t)b * p + j] = c;
          mn = min_nan(mn, c);
        }
      }
    }
    carry = carry + cluster_iteration_min(mn, s_warp, s_cta, it & 1, nranks) * 0.0f;
  }
  cluster.sync();  // no CTA leaves while a peer may still read its s_cta
  if (rank == 0 && tid == 0) carry_out[b] = carry;
}

// bf16mm, bf16all: bf16 z on the tensor cores, a warp's 16 particles at a
// time; the slots and their sum order are variant_kernel_mma's.
template <int SC>
__global__ void __launch_bounds__(kBlockThreads)
block_kernel_bf16(const float* __restrict__ phit,  // [B, 16, P]
                  const float* __restrict__ w,     // [B, N, 16]
                  float* __restrict__ c_out,       // [B, P]
                  float* __restrict__ carry_out,   // [B]
                  int* __restrict__ sm_out,        // [B C] or null
                  int n, int p, int iters) {
  extern __shared__ float4 smem4[];
  __shared__ float s_warp[kBlockThreads / 32];
  __shared__ float s_cta[2];
  uint4* s_wf = reinterpret_cast<uint4*>(smem4);  // [groups, 32]
  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / nranks;
  if (sm_out != nullptr && threadIdx.x == 0) sm_out[blockIdx.x] = smid();
  const int groups = (n + 15) / 16;
  stage_w_frags<kZBF16>(w + (size_t)b * n * kFeat, n, groups, s_wf, kBlockThreads);
  __syncthreads();

  constexpr int kWarps = kBlockThreads / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  int j0, j1;
  particle_slice(p, nranks, rank, &j0, &j1);
  const float* phit_b = phit + (size_t)b * kFeat * p;
  float carry = 0.0f;
  for (int it = 0; it < iters; ++it) {
    const float scale = 1.0f + carry * 0.0f;
    float mn = INFINITY;
    for (int pb = j0 + (threadIdx.x >> 5) * 16; pb < j1; pb += kWarps * 16) {
      const int r0 = pb + g;
      const int r1 = pb + g + 8;
      uint32_t a[8];
      phi_frags<kZBF16>(phit_b, p, r0, r1, j1, q, scale, a);
      float acc[2] = {0.0f, 0.0f};
      for (int k = 0; k < n / 16; ++k) add_group<SC, true>(a, s_wf, k, lane, q, n, acc);
      if (n % 16 != 0) add_group<SC, false>(a, s_wf, n / 16, lane, q, n, acc);
      const float c0 = -quad_sum(acc[0]);
      const float c1 = -quad_sum(acc[1]);
      if (r0 < j1) {
        if (it == iters - 1 && q == 0) c_out[(size_t)b * p + r0] = c0;
        mn = min_nan(mn, c0);
      }
      if (r1 < j1) {
        if (it == iters - 1 && q == 0) c_out[(size_t)b * p + r1] = c1;
        mn = min_nan(mn, c1);
      }
    }
    carry = carry + cluster_iteration_min(mn, s_warp, s_cta, it & 1, nranks) * 0.0f;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) carry_out[b] = carry;
}

// ---- Launches.

using VariantFn = void (*)(const float*, const float*, const float*, float*, int, int, int);
using BlockFn = void (*)(const float*, const float*, float*, float*, int*, int, int, int);

// The kernel, threads per block and dynamic shared memory of a variant.
struct VariantLaunch {
  VariantFn fn;
  int threads;
  size_t smem;
};

int round32(int x) { return (x + 31) & ~31; }

bool variant_launch(int zroute, int reduce, int n, int tile, VariantLaunch* out) {
  const size_t groups = (size_t)(n + 15) / 16;
  if (zroute == kZF32 && reduce == kRedMMA) {  // a warp per 32 particles
    const size_t n8 = ((size_t)n + 7) & ~(size_t)7;
    *out = {variant_kernel_tmma, std::min(kTmmaThreads, round32(tile)),
            sizeof(float) * n8 * kRowPad + sizeof(float2) * (n8 / 8) * 4};
    return true;
  }
  if ((zroute == kZF32 || zroute == kZOuter) && reduce == kRedCores) {
    *out = {zroute == kZF32 ? variant_kernel_tile<kZF32> : variant_kernel_tile<kZOuter>,
            std::min(kTileThreads, round32((tile + kTile - 1) / kTile)),
            sizeof(float) * (size_t)n * (kFeat + 1)};
    return true;
  }
  // B fragments (bf16: one uint4 per lane and group, TF32: two), then the
  // mask (one uint4 per column and group).
  const size_t bf16_bytes = sizeof(uint4) * groups * (32 + 4);
  const size_t tf32_bytes = sizeof(uint4) * groups * (64 + 4);
  const int threads = std::min(kMmaThreads, 32 * ((tile + 15) / 16));
  switch (zroute * 2 + reduce) {
    case kZBF16 * 2 + kRedCores:
      *out = {variant_kernel_mma<kZBF16, kRedCores>, threads, bf16_bytes};
      return true;
    case kZBF16 * 2 + kRedMMA:
      *out = {variant_kernel_mma<kZBF16, kRedMMA>, threads, bf16_bytes};
      return true;
    case kZTF32 * 2 + kRedCores:
      *out = {variant_kernel_mma<kZTF32, kRedCores>, threads, tf32_bytes};
      return true;
    case kZTF32 * 2 + kRedMMA:
      *out = {variant_kernel_mma<kZTF32, kRedMMA>, threads, tf32_bytes};
      return true;
    default:
      return false;
  }
}

BlockFn block_fn(int variant) {
  switch (variant) {
    case 0: return block_kernel_f32<kExp>;
    case 1: return block_kernel_f32<kExp2>;
    case 2: return block_kernel_f32<kNoClamp>;
    case 3: return block_kernel_bf16<kExp>;
    case 4: return block_kernel_bf16<kBF16All>;
    default: return nullptr;
  }
}

size_t block_smem(int n, int variant) {
  return variant < 3 ? sizeof(float) * (size_t)n * kFeat
                     : sizeof(uint4) * (size_t)((n + 15) / 16) * 32;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one variant launch, or 0 for a route the kernels
// do not take.
size_t ndt_score_variant_smem_bytes(int n, int zroute, int reduce) {
  VariantLaunch vl;
  return variant_launch(zroute, reduce, n, 16, &vl) ? vl.smem : 0;
}

// Scores B solves' P particles with one variant on `stream`.  zroute: 0 f32,
// 1 bf16, 2 tf32, 3 outer; reduce: 0 cores, 1 mma (not with outer); tile: a
// multiple of 16.  Returns the first CUDA error, or 0.
int ndt_score_variant(const void* phi, const void* w, const void* mask, void* out, int batch,
                      int n, int p, int tile, int zroute, int reduce, void* stream) {
  VariantLaunch vl;
  if (tile < 16 || tile % 16 != 0 || n < 1 || p < 1 || batch < 1 ||
      !variant_launch(zroute, reduce, n, tile, &vl)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = ndt::reserve_smem((const void*)vl.fn, vl.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, (p + tile - 1) / tile);
  vl.fn<<<grid, vl.threads, vl.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(phi), static_cast<const float*>(w),
      static_cast<const float*>(mask), static_cast<float*>(out), n, p, tile);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block launch (the solve's w, in the variant's
// form).
size_t ndt_score_block_smem_bytes(int n, int variant) { return block_smem(n, variant); }

// The most clusters of `cluster` CTAs of a block variant the device holds at
// once, into *out.  Returns the CUDA error, or 0.
int ndt_score_block_max_active_clusters(int n, int variant, int cluster, int* out) {
  const BlockFn fn = block_fn(variant);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return ndt::max_active_clusters(fn, kBlockThreads, cluster, block_smem(n, variant), out);
}

// I serial iterations of the score block of B solves on `stream`, one solve
// per cluster of `cluster` CTAs; variant: 0 base, 1 exp2, 2 noclamp, 3
// bf16mm, 4 bf16all.  Writes the last iteration's column sums c [B, P], the
// carry [B] and, unless sm is null, each CTA's SM [B cluster].  Returns the
// first CUDA error, or 0.
int ndt_score_block(const void* phit, const void* w, void* c, void* carry, void* sm, int batch,
                    int n, int p, int iters, int variant, int cluster, void* stream) {
  const BlockFn fn = block_fn(variant);
  if (fn == nullptr || iters < 1 || n < 1 || p < 1 || batch < 1 || cluster < 1 ||
      cluster > ndt::kMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  return ndt::launch_cluster(fn, batch * cluster, kBlockThreads, cluster, block_smem(n, variant),
                             static_cast<cudaStream_t>(stream), static_cast<const float*>(phit),
                             static_cast<const float*>(w), static_cast<float*>(c),
                             static_cast<float*>(carry), static_cast<int*>(sm), n, p, iters);
}

}  // extern "C"
