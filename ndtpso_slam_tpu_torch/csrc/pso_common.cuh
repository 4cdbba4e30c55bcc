// Device code shared by the port's whole-solve PSO kernels (rollout.cu,
// rollout_local.cu, rollout_bisect.cu) and the C entry every kernel library
// exports.
//
// * threefry2x32: the frozen parity stream (ops/rng.py:threefry2x32).
// * philox4x32: the turbo stream (ops/rng.py:philox4x32, counter layout in
//   ops/rng.py:philox_uniforms).
// * u01: u32 -> [0, 1) as (bits >> 8) * 2^-24, exact in float32.
// * init_uniforms / step_uniforms: one particle's draws in either stream
//   (the stream a template parameter).
// * dot16 / dot15: the fused-multiply-add chain z = w . phi of rollout.cu and
//   score.cu.
// * block_argmin: the first-argmin merge of models/pso.py:_select_min, with
//   its NaN rule.
// * The frozen-correspondence score of rollout.cu (K2) and its staged twin
//   rollout_bisect.cu: bind_point / quad_row (one point's stencil cell and
//   w row at the binding pose), features, score_rows, score_tile (the score
//   loop: rows outside, a register tile of particles inside), score_shared
//   (K2's score of every particle, its state in shared memory), score_mma
//   (the same with bf16 operands, on the tensor cores) and select_particle.  The scoring switches (exp mode,
//   bf16 operands) are template parameters, so the score loop has no
//   runtime branch on them.
// * One solve per thread-block cluster (K1, K2, E3): cluster_total adds the C
//   CTAs' partial costs of one particle in rank order (cluster_total_global:
//   the same for partials in global scratch, the large-population routes),
//   cluster_min takes the minimum of the C CTAs' values with jnp.min's NaN
//   rule, and launch_cluster launches a kernel with its cluster dimension.
// * The frozen score's inner loop of score.cu (K3) and score_variants.cu
//   (E1-E3): ex2 (2^x on MUFU.EX2), min_nan / max_nan (PTX min.NaN /
//   max.NaN) and dot_row (the fmaf chain over a row loaded as four float4s).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

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
template <bool kPhilox>
__device__ inline void init_uniforms(uint32_t k0, uint32_t k1, int j, int p, float u[3]) {
  const bool seed = j == p;
  if (kPhilox) {
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
template <bool kPhilox>
__device__ inline void step_uniforms(uint32_t k0, uint32_t k1, int j, int p, int it, float r1[3],
                                     float r2[3]) {
  if (kPhilox) {
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
// accuracy.  dot15: the same chain over the first 15 features of a row
// already loaded as four float4s.
__device__ __forceinline__ float dot15(const float4& a, const float4& b, const float4& c,
                                       const float4& d, const float phi[16]) {
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
  return fmaf(d.z, phi[14], z);
}

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

// ---- The frozen score's inner loop (score.cu, score_variants.cu).

constexpr float kLog2e = 1.44269504088896340736f;

// 2^x on the special-function unit; a subnormal result flushes to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// min(a, b) that returns NaN when either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// max(a, b) that returns NaN when either operand is NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// z = w . phi over the first F features of a row loaded as four float4s:
// an fmaf chain in feature order.
template <int F>
__device__ __forceinline__ float dot_row(const float4& a, const float4& b, const float4& c,
                                         const float4& d, const float phi[F]) {
  const float r[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                       c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
  float z = r[0] * phi[0];
#pragma unroll
  for (int f = 1; f < F; ++f) z = fmaf(r[f], phi[f], z);
  return z;
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

// ---- The frozen-correspondence score (rollout.cu, rollout_bisect.cu).

constexpr int kWRow = 16;  // floats per w row in shared memory (15 + 1 pad)
constexpr float kMaskBig = 1e9f;

enum ExpMode { kExp = 0, kExp2 = 1, kApprox = 2 };

// float32 -> bfloat16 -> float32, round to nearest even (PyTorch's rule).
__device__ __forceinline__ float round_bf16(float x) {
  if (isnan(x)) return x;
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// exp(-max(z, 0) / 2) in the form kMode.  The clamp keeps a NaN, as
// jnp.maximum does.
template <int kMode>
__device__ __forceinline__ float score_of(float z) {
  const float zc = z < 0.0f ? 0.0f : z;
  if (kMode == kExp2) return exp2f(zc * kExp2Scale);
  if (kMode == kApprox) {
    // Schraudolph's 2^x: x written into the exponent field by integer
    // arithmetic (pallas_rollout.py, exp_mode="approx").
    float x = zc * kExp2Scale;
    x = x < -126.0f ? -126.0f : x;
    const int i = (int)(x * 8388608.0f) + (127 * (1 << 23) - 366393);
    return __int_as_float(i);
  }
  return expf(-0.5f * zc);
}

// One point of a solve bound at the binding pose: its rotated offset, the
// validity mask (built, inside the frame, valid; 0 outside the stencil) and
// its cell's lane of the stencil table (nullptr outside the stencil).
struct BoundPoint {
  float rx, ry, mask;
  const float* lane;
};

// Point i of pts [8, N] (px, py, anchor ix, anchor iy, valid) bound at
// `bind` (c0, s0 its cos and sin) against the radius-r stencil sten
// [(2r + 1)^2, 8, N] (mx, my, la, lb, lc, built) of a frame |q| < half of
// cells `cell` wide.  The cell is a direct load: the TPU kernel's one-hot
// select over the offsets only ever added zeros to it.
__device__ __forceinline__ BoundPoint bind_point(const float* pts, const float* sten, int n,
                                                 int i, const float* bind, float c0, float s0,
                                                 float half, float cell, int r) {
  const int side = 2 * r + 1;
  const float px = pts[i];
  const float py = pts[n + i];
  const int ax = (int)pts[2 * n + i];
  const int ay = (int)pts[3 * n + i];
  const float valid = pts[4 * n + i];
  BoundPoint bp;
  bp.rx = px * c0 - py * s0;
  bp.ry = px * s0 + py * c0;
  const float qx = bp.rx + bind[0];
  const float qy = bp.ry + bind[1];
  const bool inb = (qx > -half) && (qx < half) && (qy > -half) && (qy < half);
  const int di = floor_i32((qx + half) / cell) - ax;
  const int dj = floor_i32((qy + half) / cell) - ay;
  bp.lane = nullptr;
  float built = 0.0f;
  if (abs(di) <= r && abs(dj) <= r) {
    bp.lane = sten + (size_t)((dj + r) * side + (di + r)) * 8 * n + i;
    built = bp.lane[5 * n];
  }
  bp.mask = built * (inb ? 1.0f : 0.0f) * valid;
  return bp;
}

// The 15 quadratic-form coefficients w of models/cost.py:_quadform_bound
// for a bound point, with the mask folded in (w *= mask; w14 += (1 - mask) *
// 1e9, so a masked point scores exp(-5e8) == 0 exactly), rounded to bfloat16
// if bf16, into wrow[0..15] (slot 15: dot16's 0 pad).
template <bool kBf16>
__device__ __forceinline__ void quad_row(const BoundPoint& bp, const float* bind, int n,
                                         float* wrow) {
  float mx = 0.0f, my = 0.0f, la = 0.0f, lb = 0.0f, lc = 0.0f;
  if (bp.lane != nullptr) {
    mx = bp.lane[0];
    my = bp.lane[n];
    la = bp.lane[2 * n];
    lb = bp.lane[3 * n];
    lc = bp.lane[4 * n];
  }
  const float rx = bp.rx, ry = bp.ry, mask = bp.mask;
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
  int f = 0;
#pragma unroll
  for (int a = 0; a < 5; ++a) {
#pragma unroll
    for (int c = a; c < 5; ++c) {
      float m = brx[a] * lbx[c] + bry[a] * lby[c];
      if (a != c) m = 2.0f * m;
      m = m * mask;
      if (f == 14) m = m + (1.0f - mask) * kMaskBig;
      wrow[f++] = kBf16 ? round_bf16(m) : m;
    }
  }
  wrow[15] = 0.0f;
}

// phi(u), u = [cos dth - 1, sin dth, x - bx, y - by, 1], pairs a <= b,
// rounded to bfloat16 if kBf16, and a 0 in slot 15 (dot16's pad).
template <bool kBf16>
__device__ __forceinline__ void features(const float* pose, const float* bind, float phi[16]) {
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
      phi[f++] = kBf16 ? round_bf16(v) : v;
    }
  }
  phi[15] = 0.0f;
}

// Cost contribution of point rows [i0, i1) of s_w [N, kWRow] (step di) for
// one phi.
template <int kMode>
__device__ __forceinline__ float score_rows(const float* s_w, int i0, int i1, int di,
                                            const float phi[16]) {
  float acc = 0.0f;
  for (int i = i0; i < i1; i += di) acc += score_of<kMode>(dot16<15>(s_w + (size_t)i * kWRow, phi));
  return acc;
}

// The score loop: the summed scores of a tile of kT particles over rows
// [0, rows) of s_w, bound at `bind`.  pose_of(t, pose) writes the pose of
// the tile's particle t and returns whether it is live; a dead particle
// scores 0.  Rows run on the outside, the tile on the inside: each w row is
// loaded once (four broadcast LDS.128) for kT independent fmaf chains.  Each
// (row, particle) pair is dot15's chain and each particle's sum runs over
// the rows in order, so z and the sum round as score_rows rounds them.
template <int kT, int kMode, class PoseFn>
__device__ __forceinline__ void score_tile(PoseFn pose_of, const float* bind, const float* s_w,
                                           int rows, float part[kT]) {
  float phi[kT][16];
  bool live[kT];
  bool any = false;
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    float pose[3] = {0.0f, 0.0f, 0.0f};
    live[t] = pose_of(t, pose);
    any |= live[t];
    features<false>(pose, bind, phi[t]);
    part[t] = 0.0f;
  }
  if (!any) return;
  for (int i = 0; i < rows; ++i) {
    const float4* r4 = reinterpret_cast<const float4*>(s_w + (size_t)i * kWRow);
    const float4 a = r4[0], b = r4[1], c = r4[2], d = r4[3];
#pragma unroll
    for (int t = 0; t < kT; ++t) part[t] += score_of<kMode>(dot15(a, b, c, d, phi[t]));
  }
#pragma unroll
  for (int t = 0; t < kT; ++t) part[t] = live[t] ? part[t] : 0.0f;
}

// K2's score of every particle j < p whose position lies in shared memory,
// s_pos [3, P] (component k at k * P + j), over rows [0, rows) of s_w bound
// at `bind`: on_score(j, summed scores) for each, called by thread
// j % kThreads, through score_tile in register tiles of 4 particles.
template <int kThreads, int kMode, class OnScore>
__device__ __forceinline__ void score_shared(const float* s_pos, int p, const float* bind,
                                             const float* s_w, int rows, OnScore on_score) {
  constexpr int kT = 4;
  const int tid = threadIdx.x;
  for (int q0 = 0; q0 * kThreads < p; q0 += kT) {
    float part[kT];
    score_tile<kT, kMode>(
        [&](int t, float pose[3]) {
          const int j = (q0 + t) * kThreads + tid;
          if (j >= p) return false;
          pose[0] = s_pos[j];
          pose[1] = s_pos[p + j];
          pose[2] = s_pos[2 * p + j];
          return true;
        },
        bind, s_w, rows, part);
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int j = (q0 + t) * kThreads + tid;
      if (j < p) on_score(j, part[t]);
    }
  }
}

// Two floats (bfloat16 values already) as one bf16x2 register, lo in the
// low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d = a . b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col),
// d 16 x 8 float32.  The products of two bf16 values are exact in float32.
__device__ __forceinline__ void mma_bf16_m16n8k16(const uint32_t a[4], const uint32_t b[2],
                                                  float d[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f),
        "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// K2's bf16 score on the tensor cores: the function of score_shared with
// bf16 operands.  Each warp takes 32 particles at a time, four tiles of 8: lane l
// builds phi of particle l (bf16) and the B fragments of the four tiles
// come from it by shuffles.  The warp then runs over the rows of s_w (bf16
// values held in float32) 16 points at a time (A = 16 points x the 15
// coefficients and slot 15's 0, exactly k16), one A fragment feeding four
// mma.sync.m16n8k16, one per tile; the clamp, the exp and the point sum run
// on the accumulator fragments, each lane summing its 2 particles of each
// tile over its rows, then a butterfly over the 8 lanes that share them.
// Rows past `rows` in the last block score 0.  on_score(j, summed scores)
// for each particle j < p, from a lane of the warp that owns j.
template <int kThreads, int kMode, class OnScore>
__device__ __forceinline__ void score_mma(const float* s_pos, int p, const float* bind,
                                          const float* s_w, int rows, OnScore on_score) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kTiles = 4;  // tiles of 8 particles per warp step
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // A's rows g, g + 8; B's column (particle) g of a tile
  const int c = lane & 3;   // A's and B's k pairs 2c, 2c + 8; D's columns 2c, 2c + 1
  for (int base = (threadIdx.x >> 5) * 32; base < p; base += kWarps * 32) {
    // phi of particle base + lane, as 8 bf16 pairs (k 2m, 2m + 1).
    float pose[3] = {0.0f, 0.0f, 0.0f};
    if (base + lane < p) {
      pose[0] = s_pos[base + lane];
      pose[1] = s_pos[p + base + lane];
      pose[2] = s_pos[2 * p + base + lane];
    }
    float phi[16];
    features<true>(pose, bind, phi);
    uint32_t q[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) q[m] = pack_bf16x2(phi[2 * m], phi[2 * m + 1]);
    // B of tile t at this lane: pairs c and c + 4 of particle 8t + g.
    uint32_t b[kTiles][2];
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      b[t][0] = b[t][1] = 0u;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const uint32_t v = __shfl_sync(0xffffffffu, q[m], 8 * t + g);
        if (m == c) b[t][0] = v;
        if (m == c + 4) b[t][1] = v;
      }
    }
    float acc[kTiles][2];
#pragma unroll
    for (int t = 0; t < kTiles; ++t) acc[t][0] = acc[t][1] = 0.0f;
    for (int i0 = 0; i0 < rows; i0 += 16) {
      const bool v0 = i0 + g < rows;
      const bool v1 = i0 + g + 8 < rows;
      const float* w0 = s_w + (size_t)(v0 ? i0 + g : 0) * kWRow + 2 * c;
      const float* w1 = s_w + (size_t)(v1 ? i0 + g + 8 : 0) * kWRow + 2 * c;
      const float2 x0 = *reinterpret_cast<const float2*>(w0);
      const float2 x1 = *reinterpret_cast<const float2*>(w1);
      const float2 x2 = *reinterpret_cast<const float2*>(w0 + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(w1 + 8);
      const uint32_t a[4] = {pack_bf16x2(x0.x, x0.y), pack_bf16x2(x1.x, x1.y),
                             pack_bf16x2(x2.x, x2.y), pack_bf16x2(x3.x, x3.y)};
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        float d[4];
        mma_bf16_m16n8k16(a, b[t], d);
        acc[t][0] += v0 ? score_of<kMode>(d[0]) : 0.0f;
        acc[t][1] += v0 ? score_of<kMode>(d[1]) : 0.0f;
        acc[t][0] += v1 ? score_of<kMode>(d[2]) : 0.0f;
        acc[t][1] += v1 ? score_of<kMode>(d[3]) : 0.0f;
      }
    }
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        acc[t][0] += __shfl_xor_sync(0xffffffffu, acc[t][0], off);
        acc[t][1] += __shfl_xor_sync(0xffffffffu, acc[t][1], off);
      }
      const int j0 = base + 8 * t + 2 * c;
      if (g == 0 && j0 < p) on_score(j0, acc[t][0]);
      if (g == 0 && j0 + 1 < p) on_score(j0 + 1, acc[t][1]);
    }
  }
}

// First-argmin of the block's particle values c (jnp.min's rule: NaN if any
// is NaN), this thread's particle q being j = q * stride + base; the
// winner's row of `rows` goes to cand[0..3), zeros when the minimum is NaN
// (no particle equals it).  Several threads may hold the same particle (the
// same value and row).  Returns the minimum.  All threads must call it;
// ends synchronised.
template <int kThreads, int kPPT>
__device__ __forceinline__ float select_particle(const float c[kPPT], const float (*rows)[3],
                                                 int p, int stride, int base,
                                                 ArgminScratch<kThreads>& red, float* cand) {
  float bv = INFINITY;
  int bi = 0x7fffffff;
  int nan = 0;
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    const int j = q * stride + base;
    if (j < p) {
      if (isnan(c[q])) {
        nan = 1;
      } else if (better(c[q], j, bv, bi)) {
        bv = c[q];
        bi = j;
      }
    }
  }
  float mv;
  int mi;
  block_argmin_merge<kThreads>(bv, bi, nan, &mv, &mi, red);
  if (threadIdx.x == 0 && isnan(mv)) cand[0] = cand[1] = cand[2] = 0.0f;
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    if (!isnan(mv) && q * stride + base == mi) {
      cand[0] = rows[q][0];
      cand[1] = rows[q][1];
      cand[2] = rows[q][2];
    }
  }
  __syncthreads();
  return mv;
}

// ---- One solve per thread-block cluster (rollout_local.cu, rollout.cu).
//
// A solve runs on the C CTAs of one cluster; CTA `rank` owns the points
// [rank * S, min((rank + 1) * S, N)), S = ceil(N / C), and every CTA runs
// the whole PSO scaffolding (the same draws, update and bookkeeping).  Each
// evaluation a CTA writes its partial score of every particle into its
// shared part[P + 1]; after a cluster barrier, cluster_total adds the C
// partials of particle j in rank order 0 .. C - 1, so every CTA makes the
// same float32 additions, gets the same bits and takes the same decisions.

constexpr int kMaxCluster = 8;  // the portable maximum

__device__ __forceinline__ float cluster_total(float* part, int j, int nranks) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float t = cluster.map_shared_rank(part, 0)[j];
  for (int r = 1; r < nranks; ++r) t += cluster.map_shared_rank(part, r)[j];
  return t;
}

// The minimum of one value per CTA of the cluster (each CTA's `slot`, read
// through distributed shared memory after a cluster barrier), in rank order,
// NaN if any is NaN (jnp.min's rule): every CTA gets the same bits.
__device__ __forceinline__ float cluster_min(float* slot, int nranks) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float m = *cluster.map_shared_rank(slot, 0);
  for (int r = 1; r < nranks; ++r) m = min_nan(m, *cluster.map_shared_rank(slot, r));
  return m;
}

// The large-population routes of K1 and K2 keep one CTA's particle state in
// a slice of global scratch: [kState, P] by component (position, velocity,
// personal best, its cost; component k of particle j at k * P + j), then the
// partial costs [P + 1].
constexpr int kState = 10;
__host__ __device__ inline size_t slice_floats(int p) { return (kState + 1) * (size_t)p + 1; }

// cluster_total for partials in global memory: each CTA of the cluster owns
// a slice of `stride` floats of scratch, consecutive in rank order from
// `rank0` (rank 0's slice), and keeps its partials at offset `part` in it.
// The reads go to L2 (ld.global.cg): a peer's writes, ordered by the
// cluster barrier, are never read from a stale L1 line.
__device__ __forceinline__ float cluster_total_global(const float* rank0, size_t stride, int j,
                                                     int nranks) {
  float t = __ldcg(rank0 + j);
  for (int r = 1; r < nranks; ++r) t += __ldcg(rank0 + (size_t)r * stride + j);
  return t;
}

// The first point and the number of points of `rank`'s slice.
__device__ __forceinline__ void point_slice(int n, int nranks, int rank, int* i0, int* cnt) {
  const int s = (n + nranks - 1) / nranks;
  *i0 = rank * s;
  const int left = n - *i0;
  *cnt = left < 0 ? 0 : (left < s ? left : s);
}

// A launch configuration of `blocks` CTAs in clusters of `cluster` (a
// divisor of blocks); attr holds the cluster dimension.
inline cudaLaunchConfig_t cluster_config(int blocks, int threads, int cluster, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Raises kernel's dynamic shared memory limit on the current device to at
// least `smem`, calling cudaFuncSetAttribute only when the limit it set
// last for that kernel and device is lower, so a launch of a shape seen
// before costs no attribute call.
inline cudaError_t reserve_smem(const void* kernel, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> reserved;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = reserved[{device, kernel}];
  if (smem <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) have = smem;
  return err;
}

// Launches kernel on a grid of `blocks` CTAs in clusters of `cluster`
// with `smem` bytes of dynamic shared memory.  Returns the first CUDA error
// (reserve_smem, the launch), or 0.  A refused cluster launch is returned,
// never retried at another size.
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kernel)(KArgs...), int blocks, int threads, int cluster, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = reserve_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(blocks, threads, cluster, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The most clusters of `cluster` CTAs of kernel the device can hold at once
// (cudaOccupancyMaxActiveClusters), into *out.  Returns the CUDA error, or 0.
template <typename... KArgs>
int max_active_clusters(void (*kernel)(KArgs...), int threads, int cluster, size_t smem,
                        int* out) {
  cudaError_t err = reserve_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, threads, cluster, smem, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
}

}  // namespace ndt

extern "C" const char* ndt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
