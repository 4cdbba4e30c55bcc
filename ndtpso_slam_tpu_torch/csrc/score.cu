// Fused frozen-correspondence scoring: cost[b, j] = -sum_n mask[b, n] *
// exp(-max(w[b, n, :] . phit[b, :, j], 0) / 2).
//
// Replaces ndtpso_slam_tpu/ops/pallas_score.py:_score_kernel.  Grid
// (B, ceil(P / 256)), one thread per particle: the block stages its solve's
// w [N, F] (F = 15 or 16 features, padded to 16) and mask [N] in shared
// memory, each thread holds its particle's phi in registers and sums over
// all N points, so the [P, N] score matrix never reaches device memory --
// the point of the TPU kernel too.  Any P: the ragged last tile is masked.
//
// What bounds it on an H100: arithmetic (N * P * (16 multiplies and adds +
// one expf) per solve), not bytes: a block reads N * 17 floats of w and
// mask once and 16 floats of phi per particle.  Every lane of a warp reads
// the same w row, a shared-memory broadcast.  Moving the K = 16 contraction
// onto the tensor cores is later work.
//
// Numerics: --fmad=false, no fast math; z = w . phi is pso_common.cuh's
// dot16, a chain of fused multiply-adds over f = 0..15 (as the plain
// version's cuBLAS product computes it: the terms cancel heavily at 30 m
// ranges), and the sum over points runs in order n = 0..N-1, so the result
// differs from the plain PyTorch version (two matrix products) only by the
// order of those sums and the ulps of expf.

#include "pso_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 16;

__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ phit,  // [B, F, P]
             const float* __restrict__ w,     // [B, N, F]
             const float* __restrict__ mask,  // [B, N]
             float* __restrict__ out,         // [B, P]
             int n, int f_dim, int p) {
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [N, kRow]
  float* s_mask = s_w + (size_t)n * kRow;        // [N]
  const int b = blockIdx.x;
  const float* wb = w + (size_t)b * n * f_dim;
  for (int e = threadIdx.x; e < n * kRow; e += kThreads) {
    const int i = e / kRow;
    const int f = e % kRow;
    s_w[e] = f < f_dim ? wb[(size_t)i * f_dim + f] : 0.0f;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) s_mask[i] = mask[(size_t)b * n + i];
  __syncthreads();

  const int j = blockIdx.y * kThreads + threadIdx.x;
  if (j >= p) return;
  float phi[kRow];
#pragma unroll
  for (int f = 0; f < kRow; ++f) {
    phi[f] = f < f_dim ? phit[((size_t)b * f_dim + f) * p + j] : 0.0f;
  }
  float acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float z = ndt::dot16<16>(s_w + (size_t)i * kRow, phi);
    const float zc = z < 0.0f ? 0.0f : z;  // max(z, 0); a NaN stays NaN
    acc += s_mask[i] * expf(-0.5f * zc);
  }
  out[(size_t)b * p + j] = -acc;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (w rows and mask).
size_t ndt_score_smem_bytes(int n) { return sizeof(float) * (size_t)n * (kRow + 1); }

// Scores B solves' P particles on `stream`.  Returns cudaGetLastError().
int ndt_score(const void* phit, const void* w, const void* mask, void* out, int batch,
              int n, int f_dim, int p, void* stream) {
  if (f_dim < 1 || f_dim > kRow) return (int)cudaErrorInvalidValue;
  const size_t smem = ndt_score_smem_bytes(n);
  cudaError_t err =
      cudaFuncSetAttribute(score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, (p + kThreads - 1) / kThreads);
  score_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(phit), static_cast<const float*>(w),
      static_cast<const float*>(mask), static_cast<float*>(out), n, f_dim, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
