// Whole-solve PSO scan match with per-particle exact stencil rebinning.
//
// Replaces ndtpso_slam_tpu/ops/pallas_rollout.py:_rollout_local_kernel, both
// branches: Threefry with exact exp (rollout_local), and the turbo branch
// (rollout_local_turbo), whose TPU hardware generator becomes Philox4x32-10
// (the layout of ops/rng.py:philox_uniforms) and which scores with exp2.
// One thread block runs one whole solve: the draws, the population init,
// the synchronous-gbest loop with the first-argmin merge, and every cost
// evaluation, in a single launch.  Per
// (particle, point) an evaluation transforms the point, bins it, and, when
// the cell lies inside the point's 25-cell stencil, loads that stencil lane
// directly (sten[kk][n]) -- the TPU kernel's one-hot select over the 25
// offsets only ever added zeros to this value.  Unbuilt and out-of-stencil
// lanes score exactly 0.
//
// What bounds it on an H100: latency, not bytes or FLOPs.  A solve is a
// chain of 2 + iterations dependent evaluations, each followed by block-wide
// reductions, and sequential SLAM runs one solve at a time (B = 1), so one
// block on one of the 132 SMs does all the work.  The design keeps that
// chain short: the point columns and all particle state sit in shared
// memory, the stencil table (25*N*8 floats: 307 KB at N = 384, above the
// 227 KB a block may hold) is read from global memory, where it stays in L2
// after the first evaluation, and nothing leaves the block until the final
// pose.  Spreading one solve over several SMs is left for later work.
//
// Numerics: build with --fmad=false (no FMA contraction) and without
// --use_fast_math, so every + - * / rounds as in the plain PyTorch version
// and expf/sinf/cosf are the accurate ones; what remains are the last-ulp
// differences of those functions and the order of the point sums.

#include "pso_common.cuh"

namespace {

using namespace ndt;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Params {
  int n_pts;
  int pop;
  int iters;
  int radius;
  int early_exit;
  int philox;    // 0: Threefry (parity stream), 1: Philox (turbo)
  int exp2_mode; // 0: expf(-q/2), 1: exp2f(q * kExp2Scale) (turbo)
  float half;
  float cell_side;
  float w0;
  float c1;
  float c2;
  float w_damping;
  float zdev0, zdev1, zdev2;
};

__global__ void __launch_bounds__(kThreads)
rollout_local_kernel(const uint32_t* __restrict__ keys,   // [B, 2]
                     const float* __restrict__ guesses,   // [B, 3]
                     const float* __restrict__ devs,      // [B, 3]
                     const float* __restrict__ sten_all,  // [B, K2, N, 8]
                     const float* __restrict__ pts_all,   // [B, N, 8]
                     float* __restrict__ out,             // [B, 4]
                     Params prm) {
  const int n = prm.n_pts;
  const int p = prm.pop;
  const int r = prm.radius;
  const int side = 2 * r + 1;
  const int b = blockIdx.x;
  const float* sten = sten_all + (size_t)b * side * side * n * 8;
  const float* pts = pts_all + (size_t)b * n * 8;
  const uint32_t k0 = keys[2 * b];
  const uint32_t k1 = keys[2 * b + 1];
  const float guess[3] = {guesses[3 * b], guesses[3 * b + 1], guesses[3 * b + 2]};
  const float dev[3] = {devs[3 * b], devs[3 * b + 1], devs[3 * b + 2]};
  const float zdev[3] = {prm.zdev0, prm.zdev1, prm.zdev2};

  // Shared memory: point columns, then particle state.  Slot p of pos and
  // cost holds the gbest seed during the init evaluation.
  extern __shared__ float smem[];
  float* s_px = smem;
  float* s_py = s_px + n;
  int* s_ax = reinterpret_cast<int*>(s_py + n);
  int* s_ay = s_ax + n;
  float* s_valid = reinterpret_cast<float*>(s_ay + n);
  float* s_pos = s_valid + n;          // [(p + 1) * 3]
  float* s_vel = s_pos + 3 * (p + 1);  // [p * 3]
  float* s_pbest = s_vel + 3 * p;      // [p * 3]
  float* s_cost = s_pbest + 3 * p;     // [p + 1]
  float* s_pbc = s_cost + (p + 1);     // [p]
  float* s_trig = s_pbc + p;           // [(p + 1) * 2] cos, sin
  __shared__ ArgminScratch<kThreads> red;
  __shared__ float s_gbest[3];
  __shared__ float s_gcost;
  __shared__ int s_stale;

  for (int i = threadIdx.x; i < n; i += kThreads) {
    s_px[i] = pts[8 * i];
    s_py[i] = pts[8 * i + 1];
    s_ax[i] = (int)pts[8 * i + 2];
    s_ay[i] = (int)pts[8 * i + 3];
    s_valid[i] = pts[8 * i + 4];
  }

  // Costs of the poses s_pos[0 .. np) into s_cost (ends synchronised).
  auto evaluate = [&](int np) {
    __syncthreads();
    for (int j = threadIdx.x; j < np; j += kThreads) {
      float s, c;
      sincosf(s_pos[3 * j + 2], &s, &c);
      s_trig[2 * j] = c;
      s_trig[2 * j + 1] = s;
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float half = prm.half;
    const float cell = prm.cell_side;
    for (int j = warp; j < np; j += kWarps) {
      const float c = s_trig[2 * j];
      const float s = s_trig[2 * j + 1];
      const float tx = s_pos[3 * j];
      const float ty = s_pos[3 * j + 1];
      float acc = 0.0f;
      for (int i = lane; i < n; i += 32) {
        const float px = s_px[i];
        const float py = s_py[i];
        const float qx = px * c - py * s + tx;
        const float qy = px * s + py * c + ty;
        const bool inb = (qx > -half) && (qx < half) && (qy > -half) && (qy < half);
        const int di = floor_i32((qx + half) / cell) - s_ax[i];
        const int dj = floor_i32((qy + half) / cell) - s_ay[i];
        if (inb && s_valid[i] != 0.0f && abs(di) <= r && abs(dj) <= r) {
          const int kk = (dj + r) * side + (di + r);
          const float* row = sten + ((size_t)kk * n + i) * 8;
          const float4 a = *reinterpret_cast<const float4*>(row);  // mx my la lb
          const float2 e = *reinterpret_cast<const float2*>(row + 4);  // lc pen
          if (e.y == 0.0f) {
            const float dx = qx - a.x;
            const float dy = qy - a.y;
            const float quad = a.z * dx * dx + 2.0f * a.w * dx * dy + e.x * dy * dy;
            acc += prm.exp2_mode ? exp2f(quad * kExp2Scale) : expf(-0.5f * quad);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) s_cost[j] = -acc;
    }
    __syncthreads();
  };

  // --- init: the population, and the gbest seed in slot p.
  for (int j = threadIdx.x; j <= p; j += kThreads) {
    float u[3];
    init_uniforms(prm.philox, k0, k1, j, p, u);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = guess[k] + (2.0f * u[k] - 1.0f) * (j < p ? dev[k] : zdev[k]);
      s_pos[3 * j + k] = x;
      if (j < p) {
        s_pbest[3 * j + k] = x;
        s_vel[3 * j + k] = 0.0f;
      }
    }
  }
  evaluate(p + 1);
  float bc;
  int bi;
  block_argmin<kThreads>(s_cost, p, &bc, &bi, red);
  if (threadIdx.x == 0) {
    const float g_cost = s_cost[p];
    const bool imp = bc < g_cost;
    for (int k = 0; k < 3; ++k) s_gbest[k] = imp ? s_pos[3 * bi + k] : s_pos[3 * p + k];
    s_gcost = imp ? bc : g_cost;
    s_stale = 0;
  }
  for (int j = threadIdx.x; j < p; j += kThreads) s_pbc[j] = s_cost[j];
  __syncthreads();

  // --- synchronous-gbest loop (core.cpp:78-110).
  float w = prm.w0;
  for (int it = 0; it < prm.iters; ++it) {
    if (prm.early_exit > 0 && s_stale >= prm.early_exit) break;
    for (int j = threadIdx.x; j < p; j += kThreads) {
      float r1[3], r2[3];
      step_uniforms(prm.philox, k0, k1, j, p, it, r1, r2);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int e = 3 * j + k;
        const float x = s_pos[e];
        const float v = w * s_vel[e] + prm.c1 * r1[k] * (s_pbest[e] - x) +
                        prm.c2 * r2[k] * (s_gbest[k] - x);
        s_vel[e] = v;
        s_pos[e] = x + v;
      }
    }
    evaluate(p);
    for (int j = threadIdx.x; j < p; j += kThreads) {
      if (s_cost[j] < s_pbc[j]) {
        s_pbc[j] = s_cost[j];
        for (int k = 0; k < 3; ++k) s_pbest[3 * j + k] = s_pos[3 * j + k];
      }
    }
    __syncthreads();
    block_argmin<kThreads>(s_pbc, p, &bc, &bi, red);
    if (threadIdx.x == 0) {
      if (bc < s_gcost) {
        for (int k = 0; k < 3; ++k) s_gbest[k] = s_pbest[3 * bi + k];
        s_gcost = bc;
        s_stale = 0;
      } else {
        s_stale += 1;
      }
    }
    w = w * prm.w_damping;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[4 * b] = s_gbest[0];
    out[4 * b + 1] = s_gbest[1];
    out[4 * b + 2] = s_gbest[2];
    out[4 * b + 3] = s_gcost;
  }
}

size_t smem_bytes(int n, int p) {
  return sizeof(float) * (5 * (size_t)n + 3 * (size_t)(p + 1) + 6 * (size_t)p +
                          (size_t)(p + 1) + (size_t)p + 2 * (size_t)(p + 1));
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs; the wrapper checks it against the
// device limit before launching.
size_t ndt_rollout_local_smem_bytes(int n_pts, int population) {
  return smem_bytes(n_pts, population);
}

// Launches B solves on `stream`.  Returns cudaGetLastError() after the launch.
int ndt_rollout_local(const void* keys, const void* guesses, const void* devs,
                      const void* sten, const void* pts, void* out, int batch,
                      int n_pts, int population, int iterations, int radius,
                      int early_exit, int philox, int exp2_mode, float half,
                      float cell_side, float w,
                      float c1, float c2, float w_damping, float zdev0,
                      float zdev1, float zdev2, void* stream) {
  const size_t smem = smem_bytes(n_pts, population);
  cudaError_t err = cudaFuncSetAttribute(
      rollout_local_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Params prm{n_pts, population, iterations, radius, early_exit, philox, exp2_mode,
             half, cell_side, w, c1, c2, w_damping, zdev0, zdev1, zdev2};
  rollout_local_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float*>(guesses),
      static_cast<const float*>(devs), static_cast<const float*>(sten),
      static_cast<const float*>(pts), static_cast<float*>(out), prm);
  return (int)cudaGetLastError();
}

}  // extern "C"
