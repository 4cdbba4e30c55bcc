// One cost evaluation's glue of the relocalization's refine and polish
// swarms (models/slam.py:_refine_hypotheses), in one launch in front of the
// fused scoring kernel (score.cu, K3): the PSO bookkeeping of
// models/pso.py:pso_solve_batch and the rebind of
// models/cost.py:bind_points_matmul_window (or bind_points_matmul) at each
// swarm's incumbent, then the features K3 scores.
//
// It replaces no TPU kernel: the JAX package leaves this glue to XLA, which
// fuses it into the jitted solve.  PyTorch ran it as ~140 small kernels per
// evaluation (draws, update, first-min folds, the bind's transform, binning,
// gather and quadratic form, the features), ~1.7 us of the card apiece for
// a few KB of work.  What bounds it on an H100 is latency: 8 swarms of 128
// particles and 384 points read and write ~0.3 MB a launch.  So one CTA per
// swarm and one thread per particle (P = 128; a larger P loops), no cluster,
// no global scratch beyond the state.  Each thread also binds every
// kThreads-th point.
//
// A solve of I iterations is I + 2 launches, each followed by K3 but the
// last:
//
//   init   draws u_g, u_p (pso_common.cuh: init_uniforms); the jittered seed
//          pose and the population; the bind at the guesses; the features
//          of the seed (K3's P = 1 operand) and of the population.
//   step i folds the costs of the poses last scored into the personal and
//          global bests (strict <, the first minimal index, a NaN minimum
//          never wins: models/pso.py:_select_min); draws r1, r2
//          (step_uniforms); updates velocity and position with the
//          inertia the host passes (pso_solve_batch's float32 running
//          product); rebinds every point at the new global best; writes
//          the features of the new positions.
//   final  folds the last costs and writes the global best and its cost.
//
// The state lives in one buffer, [B, 10 P + 4] floats per swarm: position,
// velocity and personal best [3, P] each (component-major), the personal
// best's cost [P], then the global best and its cost.
//
// The window (patch side ps > 0) is read in place from the full [C, 6]
// table: a point binned at global cell (ix, iy) inside the ps x ps window
// at (ox, oy) reads row iy * W + ix, and one outside it is masked.  The
// origin is window_origin's at the anchor (the last trusted pose), taken
// in the kernel.  With ps = 0 the whole table is read at cell_index's
// clipped row, as bind_points_matmul does.
//
// Numerics: built with --fmad=false and without --use_fast_math.  The
// transform, the binning (a division by the cell side is a product with
// its reciprocal, as PyTorch divides a tensor by a scalar on CUDA), the
// quadratic form, the features and the update round every + - * / in the
// plain versions' order, and cosf/sinf are PyTorch's cos/sin, so cell
// indices and masks match the PyTorch binder bit for bit, and so do w,
// the features and the state wherever the elementary functions agree.

#include <climits>

#include "pso_common.cuh"

namespace {

using namespace ndt;

constexpr int kThreads = 128;
constexpr int kF = 15;  // features, the pairs a <= b of the 5 monomials
constexpr int kRow = 6;  // table row: mean x y, icov a b c, built

enum Phase { kInit = 0, kStep = 1, kFinal = 2 };

struct Args {
  float* state;                // [B, 10P + 4]
  const int* keys;             // [B, 2] u32 words
  const float* guess;          // [B, 3] (init)
  const float* anchor;         // [3]: the window is centred on its cell
  const float* tbl;            // [C, 6]
  const float* pts;            // [N, 2]
  const unsigned char* valid;  // [N] bool
  const float* cost_seed;      // [B, 1]: the seed's cost (the first fold)
  const float* cost;           // [B, P]: the costs of the poses last scored
  float* phit_seed;            // [B, 15, 1] (init)
  float* phit;                 // [B, 15, P]
  float* w;                    // [B, N, 15]
  float* mask;                 // [B, N]
  float* out_pose;             // [B, 3] (final)
  float* out_cost;             // [B] (final)
  int p, n, ps, width;
  float half, inv_cell;
  float c1, c2, inertia;
  float dev[3], zdev[3];
  int it, phase, first_fold;
};

__device__ inline size_t state_floats(int p) { return 10 * (size_t)p + 4; }

// The features of pose against bind, feature f at out[f * stride]:
// u = [cos dth - 1, sin dth, x - bx, y - by, 1], the products u_a u_c,
// a <= c (models/cost.py:pose_features_t).
__device__ __forceinline__ void write_features(const float pose[3], const float bind[3],
                                               float* out, int stride) {
  const float dth = pose[2] - bind[2];
  const float u[5] = {cosf(dth) - 1.0f, sinf(dth), pose[0] - bind[0], pose[1] - bind[1], 1.0f};
  int f = 0;
#pragma unroll
  for (int a = 0; a < 5; ++a) {
#pragma unroll
    for (int c = a; c < 5; ++c) out[(size_t)(f++) * stride] = u[a] * u[c];
  }
}

// geometry.cell_coords of one coordinate: floor((v + half) / cell), the
// division a product with the reciprocal.
__device__ __forceinline__ int cell_of(float v, const Args& a) {
  return floor_i32((v + a.half) * a.inv_cell);
}

// Binds the N points of swarm b at `bind` (cost.bind_points_matmul_window,
// or bind_points_matmul with ps = 0): each point's mask and its 15
// coefficients w (models/cost.py:_quadform_bound), zero where masked.
__device__ void bind_points(const Args& a, int b, const float bind[3]) {
  const int wc = a.width;
  int ox = 0, oy = 0;
  if (a.ps > 0) {  // cost.window_origin at the anchor
    const int hi = wc - a.ps;
    ox = min(max(cell_of(a.anchor[0], a) - a.ps / 2, 0), hi);
    oy = min(max(cell_of(a.anchor[1], a) - a.ps / 2, 0), hi);
  }
  const float c0 = cosf(bind[2]);
  const float s0 = sinf(bind[2]);
  for (int i = threadIdx.x; i < a.n; i += kThreads) {
    const float px = a.pts[2 * i];
    const float py = a.pts[2 * i + 1];
    const float rx = px * c0 - py * s0;
    const float ry = px * s0 + py * c0;
    const float qx = rx + bind[0];
    const float qy = ry + bind[1];
    const bool inb = (qx > -a.half) && (qx < a.half) && (qy > -a.half) && (qy < a.half);
    const int ix = cell_of(qx, a);
    const int iy = cell_of(qy, a);
    bool ok = true;
    int row;
    if (a.ps > 0) {
      const int lx = ix - ox;
      const int ly = iy - oy;
      ok = lx >= 0 && lx < a.ps && ly >= 0 && ly < a.ps;
      row = ok ? iy * wc + ix : oy * wc + ox;
    } else {  // geometry.cell_index: ix + W iy in int32, clipped to the grid
      row = (int)((unsigned)ix + (unsigned)wc * (unsigned)iy);
      row = min(max(row, 0), wc * wc - 1);
    }
    const float* g = a.tbl + (size_t)row * kRow;
    const bool m = g[5] > 0.5f && inb && a.valid[i] != 0 && ok;
    float* wr = a.w + ((size_t)b * a.n + i) * kF;
    a.mask[(size_t)b * a.n + i] = m ? 1.0f : 0.0f;
    if (!m) {
#pragma unroll
      for (int f = 0; f < kF; ++f) wr[f] = 0.0f;
      continue;
    }
    const float gx = qx - g[0];
    const float gy = qy - g[1];
    const float la = g[2], lb = g[3], lc = g[4];
    const float bx[5] = {rx, -ry, 1.0f, 0.0f, gx};
    const float by[5] = {ry, rx, 0.0f, 1.0f, gy};
    float lbx[5], lby[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      lbx[c] = la * bx[c] + lb * by[c];
      lby[c] = lb * bx[c] + lc * by[c];
    }
    int f = 0;
#pragma unroll
    for (int r = 0; r < 5; ++r) {
#pragma unroll
      for (int c = r; c < 5; ++c) {
        const float m_rc = bx[r] * lbx[c] + by[r] * lby[c];
        wr[f++] = r == c ? m_rc : 2.0f * m_rc;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) reloc_step_kernel(const Args a) {
  __shared__ ArgminScratch<kThreads> red;
  __shared__ float s_best[4];  // the global best pose, then its cost
  const int b = blockIdx.x;
  const int p = a.p;
  float* st = a.state + (size_t)b * state_floats(p);
  float* pos = st;
  float* vel = st + 3 * (size_t)p;
  float* pb = st + 6 * (size_t)p;
  float* pbc = st + 9 * (size_t)p;
  float* gb = st + 10 * (size_t)p;
  const uint32_t k0 = (uint32_t)a.keys[2 * b];
  const uint32_t k1 = (uint32_t)a.keys[2 * b + 1];
  float* phit = a.phit + (size_t)b * kF * p;

  if (a.phase == kInit) {
    const float g[3] = {a.guess[3 * b], a.guess[3 * b + 1], a.guess[3 * b + 2]};
    for (int j = threadIdx.x; j < p; j += kThreads) {
      float u[3], x[3];
      init_uniforms<false>(k0, k1, j, p, u);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        x[k] = g[k] + (2.0f * u[k] - 1.0f) * a.dev[k];
        pos[k * p + j] = x[k];
        vel[k * p + j] = 0.0f;
      }
      write_features(x, g, phit + j, p);
    }
    if (threadIdx.x == 0) {  // the global best's seed: the guess, jittered
      float u[3], x[3];
      init_uniforms<false>(k0, k1, p, p, u);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        x[k] = g[k] + (2.0f * u[k] - 1.0f) * a.zdev[k];
        gb[k] = x[k];
      }
      write_features(x, g, a.phit_seed + (size_t)b * kF, 1);
    }
    bind_points(a, b, g);
    return;
  }

  // Fold the costs of the poses last scored.
  float bv = INFINITY;
  int bi = INT_MAX;
  int nan = 0;
  for (int j = threadIdx.x; j < p; j += kThreads) {
    const float c = a.cost[(size_t)b * p + j];
    float v;
    if (a.first_fold || c < pbc[j]) {
#pragma unroll
      for (int k = 0; k < 3; ++k) pb[k * p + j] = pos[k * p + j];
      pbc[j] = c;
      v = c;
    } else {
      v = pbc[j];
    }
    if (isnan(v)) {
      nan = 1;
    } else if (better(v, j, bv, bi)) {
      bv = v;
      bi = j;
    }
  }
  float mv;
  int mi;
  block_argmin_merge<kThreads>(bv, bi, nan, &mv, &mi, red);
  const float g_cost = a.first_fold ? a.cost_seed[b] : gb[3];
  const bool improved = mv < g_cost;
  if (improved && mi % kThreads == (int)threadIdx.x) {
#pragma unroll
    for (int k = 0; k < 3; ++k) s_best[k] = pb[k * p + mi];
  }
  if (threadIdx.x == 0) {
    if (!improved) {
#pragma unroll
      for (int k = 0; k < 3; ++k) s_best[k] = gb[k];
    }
    s_best[3] = improved ? mv : g_cost;
  }
  __syncthreads();
  const float g[3] = {s_best[0], s_best[1], s_best[2]};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) gb[k] = s_best[k];
    if (a.phase == kFinal) {
#pragma unroll
      for (int k = 0; k < 3; ++k) a.out_pose[3 * b + k] = s_best[k];
      a.out_cost[b] = s_best[3];
    }
  }
  if (a.phase == kFinal) return;

  // Velocity and position (models/pso.py:pso_solve_batch's order), then the
  // features of the new positions against the global best.
  for (int j = threadIdx.x; j < p; j += kThreads) {
    float r1[3], r2[3], x[3];
    step_uniforms<false>(k0, k1, j, p, a.it, r1, r2);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float xk = pos[k * p + j];
      const float v = a.inertia * vel[k * p + j] + (a.c1 * r1[k]) * (pb[k * p + j] - xk) +
                      (a.c2 * r2[k]) * (g[k] - xk);
      x[k] = xk + v;
      vel[k * p + j] = v;
      pos[k * p + j] = x[k];
    }
    write_features(x, g, phit + j, p);
  }
  bind_points(a, b, g);
}

}  // namespace

extern "C" {

// One launch of phase `phase` (0 init, 1 step `it`, 2 final) over `batch`
// swarms on `stream` of CUDA device `device`.  first_fold: the costs to fold
// are the init's (cost_seed and cost), not an iteration's.  dev3, zdev3:
// host arrays of the deviation and the seed's jitter.  Returns the first CUDA
// error, or 0.
int ndt_reloc_step(void* state, const void* keys, const void* guess, const void* anchor,
                   const void* tbl, const void* pts, const void* valid, const void* cost_seed,
                   const void* cost, void* phit_seed, void* phit, void* w, void* mask,
                   void* out_pose, void* out_cost, int batch, int p, int n, int ps, int width,
                   float half, float inv_cell, float c1, float c2, float inertia,
                   const float* dev3, const float* zdev3, int it, int phase, int first_fold,
                   int device, void* stream) {
  if (batch < 1 || p < 1 || n < 1 || width < 1 || ps < 0 || ps > width || phase < kInit ||
      phase > kFinal || (long long)width * width >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.state = static_cast<float*>(state);
  a.keys = static_cast<const int*>(keys);
  a.guess = static_cast<const float*>(guess);
  a.anchor = static_cast<const float*>(anchor);
  a.tbl = static_cast<const float*>(tbl);
  a.pts = static_cast<const float*>(pts);
  a.valid = static_cast<const unsigned char*>(valid);
  a.cost_seed = static_cast<const float*>(cost_seed);
  a.cost = static_cast<const float*>(cost);
  a.phit_seed = static_cast<float*>(phit_seed);
  a.phit = static_cast<float*>(phit);
  a.w = static_cast<float*>(w);
  a.mask = static_cast<float*>(mask);
  a.out_pose = static_cast<float*>(out_pose);
  a.out_cost = static_cast<float*>(out_cost);
  a.p = p;
  a.n = n;
  a.ps = ps;
  a.width = width;
  a.half = half;
  a.inv_cell = inv_cell;
  a.c1 = c1;
  a.c2 = c2;
  a.inertia = inertia;
  for (int k = 0; k < 3; ++k) {
    a.dev[k] = dev3[k];
    a.zdev[k] = zdev3[k];
  }
  a.it = it;
  a.phase = phase;
  a.first_fold = first_fold;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  reloc_step_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // extern "C"
