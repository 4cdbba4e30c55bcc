// Fused frozen-correspondence scoring: cost[b, j] = -sum_n mask[b, n] *
// exp(-max(w[b, n, :] . phit[b, :, j], 0) / 2).
//
// Replaces ndtpso_slam_tpu/ops/pallas_score.py:_score_kernel.  The block
// stages its solve's w [N, F] (F = 15 or 16 features, padded to 16) and mask
// [N] in shared memory; each thread holds the phi of a register tile of T
// particles and sums over all N points, so the [P, N] score matrix never
// reaches device memory -- the point of the TPU kernel too.  Any P: the
// ragged last tile is masked.
//
// What bounds it on an H100: arithmetic, N * P * (F multiply-adds, the
// clamp, one exp and the masked sum) per solve, on the FP32 pipes, which
// dispatch one instruction per lane per cycle.  So every instruction per
// (particle, point) pair beyond the F fused multiply-adds costs time.  The
// first design (one particle per thread) ran 37.25 per pair in its SASS
// loop (checkout_ab.py's count): 4.5 shared loads (four LDS.128 of w, the
// mask), 19 FFMA (16 of the dot, F = 16 always, and expf's range
// reduction), 4 FMUL and 2 FADD (the -1/2, expf, and the masked sum as a
// multiply and an add under --fmad=false), the clamp as a compare and a
// select, MUFU.EX2, and 4.75 of addressing and loop bookkeeping.  This design:
//
// * a register tile of T particles per thread: each w row (four broadcast
//   LDS.128) and its mask are loaded once for T independent fmaf chains;
// * F a template parameter: 15 features run 15 FFMA, not 16;
// * w staged as -w/2, exact (a power of two), so z' = -z/2 bit for bit and
//   the multiply by -1/2 leaves the loop;
// * the clamp as one min.NaN (PTX, sm_80+), which keeps a NaN as the
//   reference's max(z, 0) does, where fminf would drop it;
// * exp(u) as 2^(u * log2 e) on MUFU.EX2 (ex2.approx.ftz.f32): the
//   instruction exp2f itself compiles to, without the guard (a compare and two
//   predicated multiplies, 3 instructions per pair in the SASS) with which
//   exp2f rescales an argument below -126 to return a subnormal.  A score
//   below 2^-126 counts 0; every other score is exp2f's, and the extra
//   rounding of u * log2 e moves it by at most |u| * 2^-24 relative;
// * the masked sum as one fmaf (exact for a 0/1 mask).
//
// The loop's helpers (dot_row, min_nan, ex2) live in pso_common.cuh, where
// score_variants.cu's register-tile kernels (E1-E3) share them.
//
// Its loop runs 21.5 instructions per pair at F = 15 (22.5 at 16): 15
// FFMA, 2 FMUL (the dot's first product, u * log2 e), 1.25 LDS, one
// FMNMX, one MUFU.EX2 and 1.25 of loop bookkeeping, against the bound's 17
// FMA-equivalents.  A tile of 8 took 168 registers, one block per SM, and
// ran slower than 4 (98 registers, two blocks per SM).
//
// Numerics: built with --fmad=false and without --use_fast_math; z = w . phi
// is the fmaf chain over f = 0..F-1 in order (pso_common.cuh's dot16 order,
// as the plain version's cuBLAS product computes it: the terms cancel
// heavily at 30 m ranges), and the sum over points runs in order
// n = 0..N-1.  The cost is held to its float64 value, within twice the
// plain float32 version's error (chip_smoke.py: SCORE_SLACK).

#include "pso_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4;  // particles per thread
constexpr int kRow = 16;
using ndt::dot_row;
using ndt::ex2;
using ndt::kLog2e;
using ndt::min_nan;

// Block (b, y) scores particles y * T * kThreads + t * kThreads + tid,
// t < T, of solve b.
template <int F, int T>
__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ phit,  // [B, F, P]
             const float* __restrict__ w,     // [B, N, F]
             const float* __restrict__ mask,  // [B, N]
             float* __restrict__ out,         // [B, P]
             int n, int p) {
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [N, kRow]: -w / 2, zero padded
  float* s_mask = s_w + (size_t)n * kRow;        // [N]
  const int b = blockIdx.x;
  const float* wb = w + (size_t)b * n * F;
  for (int e = threadIdx.x; e < n * kRow; e += kThreads) {
    const int i = e / kRow;
    const int f = e % kRow;
    s_w[e] = f < F ? -0.5f * wb[(size_t)i * F + f] : 0.0f;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) s_mask[i] = mask[(size_t)b * n + i];
  __syncthreads();

  const int j0 = blockIdx.y * T * kThreads + threadIdx.x;
  float phi[T][F];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int j = j0 + t * kThreads;
#pragma unroll
    for (int f = 0; f < F; ++f) phi[t][f] = j < p ? phit[((size_t)b * F + f) * p + j] : 0.0f;
  }
  float acc[T];
#pragma unroll
  for (int t = 0; t < T; ++t) acc[t] = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float4* r4 = reinterpret_cast<const float4*>(s_w + (size_t)i * kRow);
    const float4 ra = r4[0], rb = r4[1], rc = r4[2], rd = r4[3];
    const float m = s_mask[i];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      // u = -max(z, 0) / 2 = min(-z / 2, 0), a NaN kept.
      const float u = min_nan(dot_row<F>(ra, rb, rc, rd, phi[t]), 0.0f);
      acc[t] = fmaf(m, ex2(u * kLog2e), acc[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int j = j0 + t * kThreads;
    if (j < p) out[(size_t)b * p + j] = -acc[t];
  }
}

template <int F, int T>
int launch(const void* phit, const void* w, const void* mask, void* out, int batch, int n, int p,
           size_t smem, cudaStream_t stream) {
  cudaError_t err = ndt::reserve_smem((const void*)score_kernel<F, T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, (p + T * kThreads - 1) / (T * kThreads));
  score_kernel<F, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(phit), static_cast<const float*>(w),
      static_cast<const float*>(mask), static_cast<float*>(out), n, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (w rows and mask).
size_t ndt_score_smem_bytes(int n) { return sizeof(float) * (size_t)n * (kRow + 1); }

// Scores B solves' P particles on `stream`.  Returns cudaGetLastError().
int ndt_score(const void* phit, const void* w, const void* mask, void* out, int batch, int n,
              int f_dim, int p, void* stream) {
  if ((f_dim != 15 && f_dim != 16) || n < 1 || p < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ndt_score_smem_bytes(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f_dim == 15 ? launch<15, kTile>(phit, w, mask, out, batch, n, p, smem, s)
                     : launch<16, kTile>(phit, w, mask, out, batch, n, p, smem, s);
}

}  // extern "C"
