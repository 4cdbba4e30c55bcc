// Variants of the frozen-correspondence scoring block, for the variant
// studies that ran on the TPU:
//
// * variant_kernel replaces experiments/kernel_variants.py:make_kernel
//   (zdtype x reduction x particle tile) and
//   experiments/pallas_variants.py:make_scores (dot_dot, dot_vpusum,
//   vpu_outer x tile):  out[b, j] = -sum_n mask[b, n] *
//   exp(-max(z[b, n, j], 0) / 2),  z = w[b, n, :] . phi[b, j, :].
// * block_kernel replaces experiments/rollout_score_variants.py:make_kernel
//   (base, exp2, noclamp, bf16mm, bf16all): one block per solve runs I
//   serial iterations of the [N, P] score block and its column sums, each
//   iteration depending on the last through a block-wide minimum.
//
// Each TPU variant axis has its GPU form:
// * z route (ZR).  kZF32: the FP32 pipes, pso_common.cuh's dot16 chain of
//   fused multiply-adds.  kZBF16: the tensor cores,
//   mma.sync.m16n8k16 with bf16 operands (rounded to nearest even) and f32
//   accumulation.  kZTF32: the tensor cores, mma.sync.m16n8k8 on TF32
//   operands, rounded from f32 by cvt.rna.tf32.f32 (to nearest, ties away
//   from zero; 10 mantissa bits kept).  kZOuter: the FP32 pipes, the
//   feature-outer loop z = z + phi_f * w_f, every product and sum rounded
//   (no FMA), over a register tile of four points and two particles.
// * point reduction (RED).  kRedCores: mask * s summed on the FP32 pipes,
//   then across the four lanes that share a particle.  kRedMMA: the mask as
//   the B operand of a second mma whose A operand is the score tile, in
//   bf16 for the bf16 route and TF32 otherwise (s and mask rounded so).
// * particles per block: the TPU tile (grid = B x ceil(P / tile)).
//
// Layout.  A warp owns 16 particles at a time and walks the points 16 at a
// time.  Each thread holds the eight (particle, point) slots that the mma
// accumulator layout gives it: slot 4t + i is particle row g + 8 (i >> 1)
// and point n0 + 8t + 2q + (i & 1), g = lane / 4, q = lane % 4.  Every route
// fills the same slots, so the reductions are shared.  w [N, 16] (padded to
// a multiple of 16 points with zero rows and mask 0) and the mask live in
// shared memory; phi stays in registers.  The [N, P] scores never reach
// device memory.
//
// What bounds it on an H100: the f32 routes, the FP32 pipes (16
// multiply-adds per (point, particle)); the tensor-core routes, the one
// expf per (point, particle) on the special-function units.  Bytes are a
// few percent of either.  This first version aims at right, not fast:
// w rows are read from shared memory with bank conflicts, and nothing
// overlaps loads with compute.
//
// Numerics: --fmad=false, no fast math.  Each route's roundings are
// repeated by the plain versions in ops/score_variants.py, so a kernel and
// its plain version differ only by the order of the sums (the mma's
// internal order included) and the ulps of expf/exp2f.  A max(z, 0) keeps
// a NaN.

#include <cuda_bf16.h>

#include "pso_common.cuh"

namespace {

constexpr int kFeat = 16;
constexpr int kThreads = 256;      // variant_kernel
constexpr int kBlockThreads = 512;  // block_kernel

enum ZRoute { kZF32 = 0, kZBF16 = 1, kZTF32 = 2, kZOuter = 3 };
enum Reduce { kRedCores = 0, kRedMMA = 1 };
enum Score { kExp = 0, kExp2 = 1, kNoClamp = 2, kBF16All = 3 };

// float32(0.5 * log2(e)) and its bfloat16 rounding (0.7213475 -> 185/256).
constexpr float kLog2eHalf = 0.7213475204444817f;
constexpr float kLog2eHalfBF16 = 0.72265625f;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// One warp's 16 particles in the form its z route reads them: two full
// rows (f32, outer), the bf16 A fragment, or the two TF32 A fragments.
template <int ZR>
struct PhiFrag {
  float ph[2][kFeat];
  uint32_t a[8];
};

// Loads particle rows r0, r1 (zero at or past p) of one solve's
// feature-major phi [16, P], times `scale`.
template <int ZR>
__device__ __forceinline__ void load_phi(PhiFrag<ZR>& fr, const float* phi_b, int p, int r0,
                                         int r1, float scale, int q) {
  auto at = [&](int r, int f) -> float {
    return r < p ? phi_b[(size_t)f * p + r] * scale : 0.0f;
  };
  if constexpr (ZR == kZF32 || ZR == kZOuter) {
#pragma unroll
    for (int f = 0; f < kFeat; ++f) {
      fr.ph[0][f] = at(r0, f);
      fr.ph[1][f] = at(r1, f);
    }
  } else if constexpr (ZR == kZBF16) {
    fr.a[0] = pack_bf16(at(r0, 2 * q), at(r0, 2 * q + 1));
    fr.a[1] = pack_bf16(at(r1, 2 * q), at(r1, 2 * q + 1));
    fr.a[2] = pack_bf16(at(r0, 2 * q + 8), at(r0, 2 * q + 9));
    fr.a[3] = pack_bf16(at(r1, 2 * q + 8), at(r1, 2 * q + 9));
  } else {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      fr.a[4 * s + 0] = to_tf32(at(r0, 8 * s + q));
      fr.a[4 * s + 1] = to_tf32(at(r1, 8 * s + q));
      fr.a[4 * s + 2] = to_tf32(at(r0, 8 * s + q + 4));
      fr.a[4 * s + 3] = to_tf32(at(r1, 8 * s + q + 4));
    }
  }
}

// Shared-memory size of w for a route: f32 or TF32 bits [n_pad, 16], or
// bf16 pairs [n_pad, 8] (half of it used).
__host__ __device__ inline size_t w_floats(int n_pad) { return (size_t)n_pad * kFeat; }

// Stages one solve's w [n, 16] into shared memory in the route's form, with
// zero rows up to n_pad.
template <int ZR>
__device__ void stage_w(const float* wb, int n, int n_pad, float* s_w) {
  if constexpr (ZR == kZBF16) {
    uint32_t* s_wu = reinterpret_cast<uint32_t*>(s_w);
    for (int e = threadIdx.x; e < n_pad * (kFeat / 2); e += blockDim.x) {
      const int i = e / (kFeat / 2);
      const int k = e % (kFeat / 2);
      const float lo = i < n ? wb[(size_t)i * kFeat + 2 * k] : 0.0f;
      const float hi = i < n ? wb[(size_t)i * kFeat + 2 * k + 1] : 0.0f;
      s_wu[e] = pack_bf16(lo, hi);
    }
  } else {
    for (int e = threadIdx.x; e < n_pad * kFeat; e += blockDim.x) {
      const int i = e / kFeat;
      const float v = i < n ? wb[e] : 0.0f;
      if constexpr (ZR == kZTF32) {
        reinterpret_cast<uint32_t*>(s_w)[e] = to_tf32(v);
      } else {
        s_w[e] = v;
      }
    }
  }
}

// z of the thread's eight slots for the 16 points from n0.
template <int ZR>
__device__ __forceinline__ void slot_z(const PhiFrag<ZR>& fr, const float* s_w, int n0, int g,
                                       int q, float z[8]) {
  if constexpr (ZR == kZF32) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* row = s_w + (size_t)(n0 + 8 * t + 2 * q + (i & 1)) * kFeat;
        z[4 * t + i] = ndt::dot16<16>(row, fr.ph[i >> 1]);
      }
    }
  } else if constexpr (ZR == kZOuter) {
#pragma unroll
    for (int k = 0; k < 8; ++k) z[k] = 0.0f;
#pragma unroll
    for (int f = 0; f < kFeat; ++f) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int pt = n0 + 8 * (k >> 2) + 2 * q + (k & 1);
        z[k] = z[k] + fr.ph[(k >> 1) & 1][f] * s_w[(size_t)pt * kFeat + f];
      }
    }
  } else if constexpr (ZR == kZBF16) {
    const uint32_t* s_wu = reinterpret_cast<const uint32_t*>(s_w);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int pt = n0 + 8 * t + g;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_bf16(d, fr.a, s_wu[pt * (kFeat / 2) + q], s_wu[pt * (kFeat / 2) + q + 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) z[4 * t + i] = d[i];
    }
  } else {
    const uint32_t* s_wu = reinterpret_cast<const uint32_t*>(s_w);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const uint32_t* row = s_wu + (size_t)(n0 + 8 * t + g) * kFeat;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_tf32(d, fr.a[0], fr.a[1], fr.a[2], fr.a[3], row[q], row[q + 4]);
      mma_tf32(d, fr.a[4], fr.a[5], fr.a[6], fr.a[7], row[8 + q], row[12 + q]);
#pragma unroll
      for (int i = 0; i < 4; ++i) z[4 * t + i] = d[i];
    }
  }
}

template <int SC>
__device__ __forceinline__ float score(float z) {
  const float zc = z < 0.0f ? 0.0f : z;  // max(z, 0); a NaN stays NaN
  if constexpr (SC == kExp2) {
    return exp2f(-kLog2eHalf * zc);
  } else if constexpr (SC == kNoClamp) {
    return expf(-0.5f * z);
  } else if constexpr (SC == kBF16All) {
    const float e = bf16_round(bf16_round(zc) * -kLog2eHalfBF16);  // bf16 product of bf16s
    return bf16_round(exp2f(e));
  } else {
    return expf(-0.5f * zc);
  }
}

// Sum across the four lanes that share a particle row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <int ZR, int RED>
__global__ void __launch_bounds__(kThreads)
variant_kernel(const float* __restrict__ phi,   // [B, 16, P]
               const float* __restrict__ w,     // [B, N, 16]
               const float* __restrict__ mask,  // [B, N]
               float* __restrict__ out,         // [B, P]
               int n, int p, int tile) {
  extern __shared__ float4 smem4[];
  const int n_pad = (n + 15) & ~15;
  float* s_w = reinterpret_cast<float*>(smem4);
  float* s_mask = s_w + w_floats(n_pad);
  const int b = blockIdx.x;
  stage_w<ZR>(w + (size_t)b * n * kFeat, n, n_pad, s_w);
  for (int i = threadIdx.x; i < n_pad; i += kThreads) {
    s_mask[i] = i < n ? mask[(size_t)b * n + i] : 0.0f;
  }
  __syncthreads();

  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int j0 = blockIdx.y * tile;
  const int j1 = min(p, j0 + tile);
  const float* phi_b = phi + (size_t)b * kFeat * p;
  for (int pb = j0 + (threadIdx.x >> 5) * 16; pb < j1; pb += kWarps * 16) {
    const int r0 = pb + g;
    const int r1 = pb + g + 8;
    PhiFrag<ZR> fr;
    load_phi<ZR>(fr, phi_b, p, r0, r1, 1.0f, q);
    float acc[2] = {0.0f, 0.0f};
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int n0 = 0; n0 < n_pad; n0 += 16) {
      float s[8];
      slot_z<ZR>(fr, s_w, n0, g, q, s);
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] = score<kExp>(s[k]);
      if constexpr (RED == kRedCores) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float m = s_mask[n0 + 8 * (k >> 2) + 2 * q + (k & 1)];
          acc[(k >> 1) & 1] = acc[(k >> 1) & 1] + m * s[k];
        }
      } else if constexpr (ZR == kZBF16) {
        const uint32_t a[4] = {pack_bf16(s[0], s[1]), pack_bf16(s[2], s[3]),
                               pack_bf16(s[4], s[5]), pack_bf16(s[6], s[7])};
        mma_bf16(d, a, pack_bf16(s_mask[n0 + 2 * q], s_mask[n0 + 2 * q + 1]),
                 pack_bf16(s_mask[n0 + 2 * q + 8], s_mask[n0 + 2 * q + 9]));
      } else {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int pt = n0 + 8 * t + 2 * q;
          mma_tf32(d, to_tf32(s[4 * t]), to_tf32(s[4 * t + 2]), to_tf32(s[4 * t + 1]),
                   to_tf32(s[4 * t + 3]), to_tf32(s_mask[pt]), to_tf32(s_mask[pt + 1]));
        }
      }
    }
    float c0, c1;
    if constexpr (RED == kRedCores) {
      c0 = quad_sum(acc[0]);
      c1 = quad_sum(acc[1]);
    } else {
      c0 = d[0];  // every column of D holds the row's sum
      c1 = d[2];
    }
    if (q == 0) {
      if (r0 < j1) out[(size_t)b * p + r0] = -c0;
      if (r1 < j1) out[(size_t)b * p + r1] = -c1;
    }
  }
}

// NaN-propagating block-wide minimum (jnp.min's rule), in every thread.
template <int kT>
__device__ float block_min(float v, int nan, float* s_v, int* s_nan) {
  constexpr int kWarps = kT / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  nan = __any_sync(0xffffffffu, nan);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_v[warp] = v;
    s_nan[warp] = nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = s_v[0];
    int any = s_nan[0];
    for (int i = 1; i < kWarps; ++i) {
      m = fminf(m, s_v[i]);
      any |= s_nan[i];
    }
    s_v[0] = any ? NAN : m;
  }
  __syncthreads();
  const float m = s_v[0];
  __syncthreads();
  return m;
}

template <int ZR, int SC>
__global__ void __launch_bounds__(kBlockThreads)
block_kernel(const float* __restrict__ phit,  // [B, 16, P]
             const float* __restrict__ w,     // [B, N, 16]
             float* __restrict__ c_out,       // [B, P]: the last iteration's -sum_n s
             float* __restrict__ carry_out,   // [B]
             int n, int p, int iters) {
  extern __shared__ float4 smem4[];
  __shared__ float s_min[kBlockThreads / 32];
  __shared__ int s_nan[kBlockThreads / 32];
  const int n_pad = (n + 15) & ~15;
  float* s_w = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x;
  stage_w<ZR>(w + (size_t)b * n * kFeat, n, n_pad, s_w);
  __syncthreads();

  constexpr int kWarps = kBlockThreads / 32;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const float* phit_b = phit + (size_t)b * kFeat * p;
  float carry = 0.0f;
  for (int it = 0; it < iters; ++it) {
    // pv = phit * (1 + carry * 0): the serial dependency on the last
    // iteration (without fast math nvcc may not fold carry * 0).
    const float scale = 1.0f + carry * 0.0f;
    float mn = INFINITY;
    int nan = 0;
    for (int pb = (threadIdx.x >> 5) * 16; pb < p; pb += kWarps * 16) {
      const int r0 = pb + g;
      const int r1 = pb + g + 8;
      PhiFrag<ZR> fr;
      load_phi<ZR>(fr, phit_b, p, r0, r1, scale, q);
      float acc[2] = {0.0f, 0.0f};
      for (int n0 = 0; n0 < n_pad; n0 += 16) {
        float s[8];
        slot_z<ZR>(fr, s_w, n0, g, q, s);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (n0 + 8 * (k >> 2) + 2 * q + (k & 1) < n) {
            acc[(k >> 1) & 1] = acc[(k >> 1) & 1] + score<SC>(s[k]);
          }
        }
      }
      const float c0 = -quad_sum(acc[0]);
      const float c1 = -quad_sum(acc[1]);
      if (it == iters - 1 && q == 0) {
        if (r0 < p) c_out[(size_t)b * p + r0] = c0;
        if (r1 < p) c_out[(size_t)b * p + r1] = c1;
      }
      if (r0 < p) {
        if (isnan(c0)) nan = 1; else mn = fminf(mn, c0);
      }
      if (r1 < p) {
        if (isnan(c1)) nan = 1; else mn = fminf(mn, c1);
      }
    }
    carry = carry + block_min<kBlockThreads>(mn, nan, s_min, s_nan) * 0.0f;
  }
  if (threadIdx.x == 0) carry_out[b] = carry;
}

size_t variant_smem(int n) {
  const int n_pad = (n + 15) & ~15;
  return sizeof(float) * (w_floats(n_pad) + (size_t)n_pad);
}

template <int ZR, int RED>
cudaError_t launch_variant(const float* phi, const float* w, const float* mask, float* out,
                           int batch, int n, int p, int tile, cudaStream_t stream) {
  const size_t smem = variant_smem(n);
  cudaError_t err = cudaFuncSetAttribute(variant_kernel<ZR, RED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch, (p + tile - 1) / tile);
  variant_kernel<ZR, RED><<<grid, kThreads, smem, stream>>>(phi, w, mask, out, n, p, tile);
  return cudaGetLastError();
}

template <int ZR, int SC>
cudaError_t launch_block(const float* phit, const float* w, float* c, float* carry, int batch,
                         int n, int p, int iters, cudaStream_t stream) {
  const size_t smem = sizeof(float) * w_floats((n + 15) & ~15);
  cudaError_t err = cudaFuncSetAttribute(block_kernel<ZR, SC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  block_kernel<ZR, SC><<<batch, kBlockThreads, smem, stream>>>(phit, w, c, carry, n, p, iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one variant launch (w and mask); a block launch
// needs the w part alone.
size_t ndt_score_variant_smem_bytes(int n) { return variant_smem(n); }

// Scores B solves' P particles with one variant on `stream`.  zroute: 0 f32,
// 1 bf16, 2 tf32, 3 outer; reduce: 0 cores, 1 mma (not with outer); tile: a
// multiple of 16.  Returns cudaGetLastError().
int ndt_score_variant(const void* phi, const void* w, const void* mask, void* out, int batch,
                      int n, int p, int tile, int zroute, int reduce, void* stream) {
  if (tile < 16 || tile % 16 != 0) return (int)cudaErrorInvalidValue;
  const float* ph = static_cast<const float*>(phi);
  const float* wf = static_cast<const float*>(w);
  const float* mf = static_cast<const float*>(mask);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = zroute * 2 + reduce;
  switch (key) {
    case kZF32 * 2 + kRedCores:
      return (int)launch_variant<kZF32, kRedCores>(ph, wf, mf, o, batch, n, p, tile, st);
    case kZF32 * 2 + kRedMMA:
      return (int)launch_variant<kZF32, kRedMMA>(ph, wf, mf, o, batch, n, p, tile, st);
    case kZBF16 * 2 + kRedCores:
      return (int)launch_variant<kZBF16, kRedCores>(ph, wf, mf, o, batch, n, p, tile, st);
    case kZBF16 * 2 + kRedMMA:
      return (int)launch_variant<kZBF16, kRedMMA>(ph, wf, mf, o, batch, n, p, tile, st);
    case kZTF32 * 2 + kRedCores:
      return (int)launch_variant<kZTF32, kRedCores>(ph, wf, mf, o, batch, n, p, tile, st);
    case kZTF32 * 2 + kRedMMA:
      return (int)launch_variant<kZTF32, kRedMMA>(ph, wf, mf, o, batch, n, p, tile, st);
    case kZOuter * 2 + kRedCores:
      return (int)launch_variant<kZOuter, kRedCores>(ph, wf, mf, o, batch, n, p, tile, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// I serial iterations of the score block of B solves on `stream`; variant:
// 0 base, 1 exp2, 2 noclamp, 3 bf16mm, 4 bf16all.  Writes the last
// iteration's column sums c [B, P] and the carry [B].  Returns
// cudaGetLastError().
int ndt_score_block(const void* phit, const void* w, void* c, void* carry, int batch, int n,
                    int p, int iters, int variant, void* stream) {
  if (iters < 1) return (int)cudaErrorInvalidValue;
  const float* ph = static_cast<const float*>(phit);
  const float* wf = static_cast<const float*>(w);
  float* co = static_cast<float*>(c);
  float* ca = static_cast<float*>(carry);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return (int)launch_block<kZF32, kExp>(ph, wf, co, ca, batch, n, p, iters, st);
    case 1: return (int)launch_block<kZF32, kExp2>(ph, wf, co, ca, batch, n, p, iters, st);
    case 2: return (int)launch_block<kZF32, kNoClamp>(ph, wf, co, ca, batch, n, p, iters, st);
    case 3: return (int)launch_block<kZBF16, kExp>(ph, wf, co, ca, batch, n, p, iters, st);
    case 4: return (int)launch_block<kZBF16, kBF16All>(ph, wf, co, ca, batch, n, p, iters, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
