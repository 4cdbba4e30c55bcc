// Device code shared by the port's whole-solve PSO kernels (rollout.cu,
// rollout_local.cu) and the C entry every kernel library exports.
//
// * threefry2x32: the frozen parity stream (ops/rng.py:threefry2x32).
// * philox4x32: the turbo stream (ops/rng.py:philox4x32, counter layout in
//   ops/rng.py:philox_uniforms).
// * u01: u32 -> [0, 1) as (bits >> 8) * 2^-24, exact in float32.
// * init_uniforms / step_uniforms: one particle's draws in either stream.
// * dot16: the fused-multiply-add chain z = w . phi of rollout.cu and score.cu.
// * block_argmin: the first-argmin merge of models/pso.py:_select_min, with
//   its NaN rule.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ndt {

constexpr float kCoordClamp = 1073741824.0f;  // 2^30, see geometry._floor_i32
// exp(-z/2) == 2^(z * kExp2Scale): the turbo modes' exp2 scoring constant,
// float32(-0.5 / ln 2) as in the JAX package.
constexpr float kExp2Scale = (float)(-0.5 / 0.69314718055994530942);

// Philox counter selectors (ops/rng.py: PHILOX_*).
constexpr uint32_t kPhiloxInit = 0;
constexpr uint32_t kPhiloxSeed = 1;
constexpr uint32_t kPhiloxR1 = 0;
constexpr uint32_t kPhiloxR2 = 1;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds.
__device__ inline void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                                    uint32_t* o0, uint32_t* o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[b & 1][r]) ^ x0;
    }
    x0 += ks[(b + 1) % 3];
    x1 += ks[(b + 2) % 3] + (uint32_t)(b + 1);
  }
  *o0 = x0;
  *o1 = x1;
}

// Philox4x32-10 (Random123's philox4x32_10).
__device__ inline void philox4x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                                  uint32_t c2, uint32_t c3, uint32_t out[4]) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

__device__ __forceinline__ float u01(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// Three uniforms (dims x, y, theta) of the Philox counter
// (particle, step, select, 0): words 0..2.
__device__ inline void philox_u3(uint32_t k0, uint32_t k1, uint32_t particle, uint32_t step,
                                 uint32_t select, float u[3]) {
  uint32_t w[4];
  philox4x32(k0, k1, particle, step, select, 0u, w);
  u[0] = u01(w[0]);
  u[1] = u01(w[1]);
  u[2] = u01(w[2]);
}

// Uniforms of the initial position of particle j < p, or, for j == p, of
// the global-best seed: Threefry counters 3 + 3j + k (seed: k), low word;
// Philox counter (j, 0, kPhiloxInit) (seed: (0, 0, kPhiloxSeed)).
__device__ inline void init_uniforms(int philox, uint32_t k0, uint32_t k1, int j, int p,
                                     float u[3]) {
  const bool seed = j == p;
  if (philox) {
    philox_u3(k0, k1, seed ? 0u : (uint32_t)j, 0u, seed ? kPhiloxSeed : kPhiloxInit, u);
    return;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uint32_t lo, hi;
    threefry2x32(k0, k1, seed ? (uint32_t)k : 3u + 3u * (uint32_t)j + (uint32_t)k, 0u, &lo,
                 &hi);
    u[k] = u01(lo);
  }
}

// r1, r2 of particle j at iteration it: Threefry counter
// 3 + 3p + 3p * it + 3j + k, words (lo, hi); Philox counters
// (j, it + 1, kPhiloxR1) and (j, it + 1, kPhiloxR2).
__device__ inline void step_uniforms(int philox, uint32_t k0, uint32_t k1, int j, int p, int it,
                                     float r1[3], float r2[3]) {
  if (philox) {
    philox_u3(k0, k1, (uint32_t)j, (uint32_t)it + 1u, kPhiloxR1, r1);
    philox_u3(k0, k1, (uint32_t)j, (uint32_t)it + 1u, kPhiloxR2, r2);
    return;
  }
  const uint32_t base = 3u + 3u * (uint32_t)p * ((uint32_t)it + 1u) + 3u * (uint32_t)j;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uint32_t lo, hi;
    threefry2x32(k0, k1, base + (uint32_t)k, 0u, &lo, &hi);
    r1[k] = u01(lo);
    r2[k] = u01(hi);
  }
}

// z = w . phi over the first F (15 or 16) features of one 16-float row of w
// (16-byte aligned).  An explicit chain of fused multiply-adds, as the plain
// version's matrix product (cuBLAS) computes it: at 30 m ranges the terms
// reach ~1e4 and cancel down to z ~ 1, so unfused products would cost
// accuracy.
template <int F>
__device__ __forceinline__ float dot16(const float* row, const float phi[16]) {
  static_assert(F == 15 || F == 16, "15 or 16 features");
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 a = r4[0], b = r4[1], c = r4[2], d = r4[3];
  float z = a.x * phi[0];
  z = fmaf(a.y, phi[1], z);
  z = fmaf(a.z, phi[2], z);
  z = fmaf(a.w, phi[3], z);
  z = fmaf(b.x, phi[4], z);
  z = fmaf(b.y, phi[5], z);
  z = fmaf(b.z, phi[6], z);
  z = fmaf(b.w, phi[7], z);
  z = fmaf(c.x, phi[8], z);
  z = fmaf(c.y, phi[9], z);
  z = fmaf(c.z, phi[10], z);
  z = fmaf(c.w, phi[11], z);
  z = fmaf(d.x, phi[12], z);
  z = fmaf(d.y, phi[13], z);
  z = fmaf(d.z, phi[14], z);
  return F == 16 ? fmaf(d.w, phi[15], z) : z;
}

__device__ __forceinline__ int floor_i32(float v) {
  return (int)fminf(fmaxf(floorf(v), -kCoordClamp), kCoordClamp);
}

// a strictly better than b under the first-argmin rule.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// Shared scratch of block_argmin_merge.
template <int kThreads>
struct ArgminScratch {
  float v[kThreads / 32];
  int i[kThreads / 32];
  int nan[kThreads / 32];
};

// Block-wide merge of one candidate per thread: (bv, bi) is the thread's
// best (value, index) and nan whether it saw a NaN.  Returns the minimum
// through *mv (NaN if any thread saw one, as jnp.min gives) and its first
// index through *mi, in every thread.  All threads must call it.
template <int kThreads>
__device__ void block_argmin_merge(float bv, int bi, int nan, float* mv, int* mi,
                                   ArgminScratch<kThreads>& s) {
  constexpr int kWarps = kThreads / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  nan = __any_sync(0xffffffffu, nan);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s.v[warp] = bv;
    s.i[warp] = bi;
    s.nan[warp] = nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = s.v[0];
    int i = s.i[0];
    int any_nan = s.nan[0];
    for (int w = 1; w < kWarps; ++w) {
      if (better(s.v[w], s.i[w], v, i)) {
        v = s.v[w];
        i = s.i[w];
      }
      any_nan |= s.nan[w];
    }
    s.v[0] = any_nan ? NAN : v;
    s.i[0] = i;
  }
  __syncthreads();
  *mv = s.v[0];
  *mi = s.i[0];
  __syncthreads();
}

// First-argmin of c[0..p) in shared or global memory.
template <int kThreads>
__device__ void block_argmin(const float* c, int p, float* mv, int* mi,
                             ArgminScratch<kThreads>& s) {
  float bv = INFINITY;
  int bi = 0x7fffffff;
  int nan = 0;
  for (int j = threadIdx.x; j < p; j += kThreads) {
    const float v = c[j];
    if (isnan(v)) {
      nan = 1;
    } else if (better(v, j, bv, bi)) {
      bv = v;
      bi = j;
    }
  }
  block_argmin_merge<kThreads>(bv, bi, nan, mv, mi, s);
}

// Block-wide sum of one float per thread, in every thread.
template <int kThreads>
__device__ float block_sum(float x, float* scratch) {
  constexpr int kWarps = kThreads / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = scratch[0];
    for (int w = 1; w < kWarps; ++w) t += scratch[w];
    scratch[0] = t;
  }
  __syncthreads();
  const float t = scratch[0];
  __syncthreads();
  return t;
}

}  // namespace ndt

extern "C" const char* ndt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
