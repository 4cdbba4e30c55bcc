// Whole-solve PSO scan match with correspondences frozen at the incumbent.
//
// Replaces ndtpso_slam_tpu/ops/pallas_rollout.py:_rollout_kernel, every
// branch: Threefry or (turbo) Philox draws, f32 or bf16 scoring operands,
// exp / exp2 / approx (Schraudolph) scoring, and the early exit.  One thread
// block runs one whole solve.  Each evaluation
//
//   1. rebinds every point at the binding pose (the guess at init, then the
//      global best of the previous iteration): the block transforms and bins
//      the points cooperatively and loads each point's cell from its 25-cell
//      stencil directly (sten[kk][.][n]; the TPU kernel's one-hot select only
//      ever added zeros to that value), then builds the 15 quadratic-form
//      coefficients w of models/cost.py:_quadform_bound with the validity
//      mask folded in (w *= mask; w14 += (1 - mask) * 1e9, so a masked point
//      scores exp(-5e8) == 0 exactly) and keeps w in shared memory;
//   2. scores every particle: each thread builds the monomials phi(u) of its
//      particles relative to the binding pose and sums
//      exp(-max(w . phi, 0) / 2) over all points, reading w from shared
//      memory (every lane of a warp reads the same row: a broadcast).
//
// What bounds it on an H100: arithmetic.  An evaluation is N * P * (15
// multiply-adds + one exp) per solve and a solve is 2 + iterations
// evaluations; the inputs (the stencil table, 25 * 8 * N floats: 307 KB at
// N = 384) are read from global memory once per evaluation and stay in L2.
// The particle state (position, velocity, personal best: 10 floats) lives
// in registers, ceil(P / 512) particles per thread, so P = 4096 needs no
// shared memory for it; w takes N * 64 bytes (24.6 KB at N = 384).  A batch
// of B solves is B blocks, one per SM at a time (the 512 threads' registers
// fill an SM).  The scoring loop runs on the FP32 pipes; the K = 15
// contraction could move to the tensor cores (wgmma) in later work.
//
// bf16 scoring rounds both operands (w after the mask fold, and phi) to
// bfloat16, round to nearest even, and accumulates in float32: the product
// of two bf16 values is exact in float32, as in the TPU kernel's MXU.
//
// Numerics: built with --fmad=false and without fast math, so every
// + - * / of the rebind and the PSO update rounds as in the plain PyTorch
// version.  The one contraction, z = w . phi, is pso_common.cuh's dot16, a
// chain of fused multiply-adds as the plain version's matrix product
// computes it.  The differences left are the ulps of sincosf/expf/exp2f and
// the order of the sums.

#include "pso_common.cuh"

namespace {

using namespace ndt;

constexpr int kThreads = 512;
constexpr int kRow = 16;  // floats per w row in shared memory (15 + 1 pad)
constexpr float kBig = 1e9f;

enum ExpMode { kExp = 0, kExp2 = 1, kApprox = 2 };

struct Params {
  int n_pts;
  int pop;
  int iters;
  int radius;
  int early_exit;
  int philox;    // 0: Threefry (parity stream), 1: Philox (turbo)
  int bf16;      // round the scoring operands to bfloat16
  int exp_mode;  // ExpMode
  float half;
  float cell_side;
  float w0;
  float c1;
  float c2;
  float w_damping;
  float zdev0, zdev1, zdev2;
};

// float32 -> bfloat16 -> float32, round to nearest even (PyTorch's rule).
__device__ __forceinline__ float round_bf16(float x) {
  if (isnan(x)) return x;
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// exp(-max(z, 0) / 2) in the chosen form.  The clamp keeps a NaN, as
// jnp.maximum does.
__device__ __forceinline__ float score_of(float z, int mode) {
  const float zc = z < 0.0f ? 0.0f : z;
  if (mode == kExp2) return exp2f(zc * kExp2Scale);
  if (mode == kApprox) {
    // Schraudolph's 2^x: x written into the exponent field by integer
    // arithmetic (pallas_rollout.py, exp_mode="approx").
    float x = zc * kExp2Scale;
    x = x < -126.0f ? -126.0f : x;
    const int i = (int)(x * 8388608.0f) + (127 * (1 << 23) - 366393);
    return __int_as_float(i);
  }
  return expf(-0.5f * zc);
}

// phi(u), u = [cos dth - 1, sin dth, x - bx, y - by, 1], pairs a <= b, and
// a 0 in slot 15 (dot16's pad).
__device__ __forceinline__ void features(const float* pose, const float* bind, int bf16,
                                         float phi[16]) {
  const float dth = pose[2] - bind[2];
  float sn, cs;
  sincosf(dth, &sn, &cs);
  const float u[5] = {cs - 1.0f, sn, pose[0] - bind[0], pose[1] - bind[1], 1.0f};
  int f = 0;
#pragma unroll
  for (int a = 0; a < 5; ++a) {
#pragma unroll
    for (int b = a; b < 5; ++b) {
      const float v = u[a] * u[b];
      phi[f++] = bf16 ? round_bf16(v) : v;
    }
  }
  phi[15] = 0.0f;
}

// Cost contribution of point rows [i0, i1) of s_w (step di) for one phi.
__device__ __forceinline__ float score_rows(const float* s_w, int i0, int i1, int di,
                                            const float phi[16], int mode) {
  float acc = 0.0f;
  for (int i = i0; i < i1; i += di) acc += score_of(dot16<15>(s_w + (size_t)i * kRow, phi), mode);
  return acc;
}

template <int kPPT>
__global__ void __launch_bounds__(kThreads)
rollout_kernel(const uint32_t* __restrict__ keys,   // [B, 2]
               const float* __restrict__ guesses,   // [B, 3]
               const float* __restrict__ devs,      // [B, 3]
               const float* __restrict__ sten_all,  // [B, K2, 8, N]
               const float* __restrict__ pts_all,   // [B, 8, N]
               float* __restrict__ out,             // [B, 4]
               Params prm) {
  const int n = prm.n_pts;
  const int p = prm.pop;
  const int r = prm.radius;
  const int side = 2 * r + 1;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* sten = sten_all + (size_t)b * side * side * 8 * n;
  const float* pts = pts_all + (size_t)b * 8 * n;
  const uint32_t k0 = keys[2 * b];
  const uint32_t k1 = keys[2 * b + 1];
  const float guess[3] = {guesses[3 * b], guesses[3 * b + 1], guesses[3 * b + 2]};
  const float dev[3] = {devs[3 * b], devs[3 * b + 1], devs[3 * b + 2]};
  const float zdev[3] = {prm.zdev0, prm.zdev1, prm.zdev2};

  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [N, kRow]
  __shared__ ArgminScratch<kThreads> red;
  __shared__ float s_sum[kThreads / 32];
  __shared__ float s_cand[3];
  __shared__ float s_gbest[3];
  __shared__ float s_gcost;
  __shared__ int s_stale;

  // Rebind at `bind`: w rows of every point into s_w (ends synchronised).
  auto bind_at = [&](const float* bind) {
    float s0, c0;
    sincosf(bind[2], &s0, &c0);
    const float half = prm.half;
    const float cell = prm.cell_side;
    __syncthreads();  // the previous evaluation has finished reading s_w
    for (int i = tid; i < n; i += kThreads) {
      const float px = pts[i];
      const float py = pts[n + i];
      const int ax = (int)pts[2 * n + i];
      const int ay = (int)pts[3 * n + i];
      const float valid = pts[4 * n + i];
      const float rx = px * c0 - py * s0;
      const float ry = px * s0 + py * c0;
      const float qx = rx + bind[0];
      const float qy = ry + bind[1];
      const bool inb = (qx > -half) && (qx < half) && (qy > -half) && (qy < half);
      const int di = floor_i32((qx + half) / cell) - ax;
      const int dj = floor_i32((qy + half) / cell) - ay;
      float mx = 0.0f, my = 0.0f, la = 0.0f, lb = 0.0f, lc = 0.0f, built = 0.0f;
      if (abs(di) <= r && abs(dj) <= r) {
        const float* lane = sten + (size_t)((dj + r) * side + (di + r)) * 8 * n + i;
        mx = lane[0];
        my = lane[n];
        la = lane[2 * n];
        lb = lane[3 * n];
        lc = lane[4 * n];
        built = lane[5 * n];
      }
      const float mask = built * (inb ? 1.0f : 0.0f) * valid;
      const float gx = rx + bind[0] - mx;
      const float gy = ry + bind[1] - my;
      const float brx[5] = {rx, -ry, 1.0f, 0.0f, gx};
      const float bry[5] = {ry, rx, 0.0f, 1.0f, gy};
      float lbx[5], lby[5];
#pragma unroll
      for (int a = 0; a < 5; ++a) {
        lbx[a] = la * brx[a] + lb * bry[a];
        lby[a] = lb * brx[a] + lc * bry[a];
      }
      float* wrow = s_w + (size_t)i * kRow;
      int f = 0;
#pragma unroll
      for (int a = 0; a < 5; ++a) {
#pragma unroll
        for (int c = a; c < 5; ++c) {
          float m = brx[a] * lbx[c] + bry[a] * lby[c];
          if (a != c) m = 2.0f * m;
          m = m * mask;
          if (f == 14) m = m + (1.0f - mask) * kBig;
          wrow[f++] = prm.bf16 ? round_bf16(m) : m;
        }
      }
      wrow[15] = 0.0f;
    }
    __syncthreads();
  };

  // Particle j = q * kThreads + tid of this thread, q < kPPT.
  float pos[kPPT][3], vel[kPPT][3], pb[kPPT][3], pbc[kPPT];

  // Cost of each of this thread's particles at the current binding.
  auto score_own = [&](const float* bind, float cost[kPPT]) {
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      cost[q] = 0.0f;
      if (q * kThreads + tid < p) {
        float phi[16];
        features(pos[q], bind, prm.bf16, phi);
        cost[q] = -score_rows(s_w, 0, n, 1, phi, prm.exp_mode);
      }
    }
  };

  // First-argmin of pbc over the block; the winner's personal best goes to
  // s_cand.  Returns the minimum (NaN if any cost is NaN).
  auto merge_best = [&]() -> float {
    float bv = INFINITY;
    int bi = 0x7fffffff;
    int nan = 0;
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      const int j = q * kThreads + tid;
      if (j < p) {
        if (isnan(pbc[q])) {
          nan = 1;
        } else if (better(pbc[q], j, bv, bi)) {
          bv = pbc[q];
          bi = j;
        }
      }
    }
    float mv;
    int mi;
    block_argmin_merge<kThreads>(bv, bi, nan, &mv, &mi, red);
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      if (q * kThreads + tid == mi) {
        s_cand[0] = pb[q][0];
        s_cand[1] = pb[q][1];
        s_cand[2] = pb[q][2];
      }
    }
    __syncthreads();
    return mv;
  };

  // --- init (core.cpp:53-69): population, then the global-best seed.
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    const int j = q * kThreads + tid;
    float u[3] = {0.0f, 0.0f, 0.0f};
    if (j < p) init_uniforms(prm.philox, k0, k1, j, p, u);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pos[q][k] = guess[k] + (2.0f * u[k] - 1.0f) * dev[k];
      vel[q][k] = 0.0f;
      pb[q][k] = pos[q][k];
    }
  }
  float g_pos[3];
  {
    float u[3];
    init_uniforms(prm.philox, k0, k1, p, p, u);
#pragma unroll
    for (int k = 0; k < 3; ++k) g_pos[k] = guess[k] + (2.0f * u[k] - 1.0f) * zdev[k];
  }
  bind_at(guess);
  score_own(guess, pbc);
  float g_phi[16];
  features(g_pos, guess, prm.bf16, g_phi);
  const float g_cost =
      -block_sum<kThreads>(score_rows(s_w, tid, n, kThreads, g_phi, prm.exp_mode), s_sum);
  {
    const float bc = merge_best();
    if (tid == 0) {
      const bool imp = bc < g_cost;
      for (int k = 0; k < 3; ++k) s_gbest[k] = imp ? s_cand[k] : g_pos[k];
      s_gcost = imp ? bc : g_cost;
      s_stale = 0;
    }
    __syncthreads();
  }

  // --- synchronous-gbest loop (core.cpp:78-110).
  float w = prm.w0;
  for (int it = 0; it < prm.iters; ++it) {
    if (prm.early_exit > 0 && s_stale >= prm.early_exit) break;
    const float gb[3] = {s_gbest[0], s_gbest[1], s_gbest[2]};
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      const int j = q * kThreads + tid;
      if (j >= p) continue;
      float r1[3], r2[3];
      step_uniforms(prm.philox, k0, k1, j, p, it, r1, r2);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float x = pos[q][k];
        const float v = w * vel[q][k] + prm.c1 * r1[k] * (pb[q][k] - x) +
                        prm.c2 * r2[k] * (gb[k] - x);
        vel[q][k] = v;
        pos[q][k] = x + v;
      }
    }
    bind_at(gb);
    float cost[kPPT];
    score_own(gb, cost);
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      if (q * kThreads + tid < p && cost[q] < pbc[q]) {
        pbc[q] = cost[q];
        pb[q][0] = pos[q][0];
        pb[q][1] = pos[q][1];
        pb[q][2] = pos[q][2];
      }
    }
    const float bc = merge_best();
    if (tid == 0) {
      if (bc < s_gcost) {
        for (int k = 0; k < 3; ++k) s_gbest[k] = s_cand[k];
        s_gcost = bc;
        s_stale = 0;
      } else {
        s_stale += 1;
      }
    }
    w = w * prm.w_damping;
    __syncthreads();
  }
  if (tid == 0) {
    out[4 * b] = s_gbest[0];
    out[4 * b + 1] = s_gbest[1];
    out[4 * b + 2] = s_gbest[2];
    out[4 * b + 3] = s_gcost;
  }
}

template <int kPPT>
int launch(const Params& prm, int batch, size_t smem, cudaStream_t stream,
           const void* keys, const void* guesses, const void* devs, const void* sten,
           const void* pts, void* out) {
  cudaError_t err = cudaFuncSetAttribute(
      rollout_kernel<kPPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rollout_kernel<kPPT><<<batch, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float*>(guesses),
      static_cast<const float*>(devs), static_cast<const float*>(sten),
      static_cast<const float*>(pts), static_cast<float*>(out), prm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (the w rows).
size_t ndt_rollout_smem_bytes(int n_pts) { return sizeof(float) * kRow * (size_t)n_pts; }

// Largest population one launch takes (16 particles per thread).
int ndt_rollout_max_population() { return 16 * kThreads; }

// Launches B solves on `stream`.  Returns cudaGetLastError() after the launch.
int ndt_rollout(const void* keys, const void* guesses, const void* devs, const void* sten,
                const void* pts, void* out, int batch, int n_pts, int population,
                int iterations, int radius, int early_exit, int philox, int bf16,
                int exp_mode, float half, float cell_side, float w, float c1, float c2,
                float w_damping, float zdev0, float zdev1, float zdev2, void* stream) {
  const Params prm{n_pts, population, iterations, radius, early_exit, philox, bf16,
                   exp_mode, half, cell_side, w, c1, c2, w_damping, zdev0, zdev1, zdev2};
  const size_t smem = ndt_rollout_smem_bytes(n_pts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_thread = (population + kThreads - 1) / kThreads;
  if (per_thread <= 1) return launch<1>(prm, batch, smem, s, keys, guesses, devs, sten, pts, out);
  if (per_thread <= 2) return launch<2>(prm, batch, smem, s, keys, guesses, devs, sten, pts, out);
  if (per_thread <= 4) return launch<4>(prm, batch, smem, s, keys, guesses, devs, sten, pts, out);
  if (per_thread <= 8) return launch<8>(prm, batch, smem, s, keys, guesses, devs, sten, pts, out);
  if (per_thread <= 16) return launch<16>(prm, batch, smem, s, keys, guesses, devs, sten, pts, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
