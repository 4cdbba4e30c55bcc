// The rollout kernel cut down to one staged kernel, stage by stage.
//
// Replaces experiments/rollout_bisect.py:make_kernel(stage), K2
// (ndtpso_slam_tpu/ops/pallas_rollout.py:_rollout_kernel) reduced to
// a radius-2 stencil on a 32 m frame of 1 m cells, Threefry draws, w = 0.8,
// c1 = c2 = 2, and its pieces switched on one by one:
//
//   stage 0       the draws, the population and the global-best seed, no loop;
//   stage 1       + `iterations` PSO steps, trivial cost -|pos|^2;
//   stage 2       + the 25-cell stencil bind at the incumbent, pseudo-cost
//                 -(sum of the mask + |pos|^2);
//   stages 3-9    + the full quadratic form w . phi -> exp -> sum over points;
//   stages 10-19  stage 0 with constant keys (10, 12: 12345, 67890) and
//                 constant guess 0 / deviation 0.2 (10, 11);
//   stages 20-27  early-return probes on those constants (the TPU script's
//                 :133-183): 20 the seed's row sums over the population, 21,
//                 24, 25 the seed's cost, 22 the population's minimum plus
//                 its pose, 23 the first incumbent plus its cost, 26 ones,
//                 27 stage 10 through a mixed seed/population evaluation.
//
// Output [B, 8, 128], every lane of a row equal: rows 0-2 the global best,
// rows 3-7 its cost (the early-return stages their own rows).
//
// One thread block runs one solve, as K2's kernel does on a cluster of
// C = 1, and the stages 1, 2 and 3 at K2's batch shape split K2's time into
// the draws and the update, the bind, and the score.  The particle state
// lies in shared memory as K2's does ([10, P], thread j % 512 owning
// particle j); the 1 + 3 P * (1 + iterations) Threefry counters are those
// of pso_common.cuh's init_uniforms and step_uniforms (the TPU kernel's
// tf(3 + 3j + k) and tf(3 + 3P + 3P it + 3j + k)); the seed's pose draws
// counter = row with amplitude 0.01.  The bind, the score and the
// first-argmin merge are K2's own device code (pso_common.cuh: bind_point,
// quad_row, score_shared over score_tile, block_argmin), so stage 3's loop
// is K2's:
// each point's stencil cell is a direct load (the TPU kernel's one-hot
// select only ever added zeros to it), points outside the stencil or the
// frame score 0, and a NaN minimum selects no particle (jnp.min's rule).
//
// What bounds it at K2's shape: arithmetic, as K2 (stage 3: the N * P
// scores per evaluation on the FP32 pipes and exps on the special-function
// units; stages 1-2: the Threefry words on the INT32 pipes).
//
// Numerics: --fmad=false and no fast math, so every + - * of the draws, the
// update and the trivial costs rounds as the plain PyTorch version's; stage
// 3's z = w . phi is dot16's fused chain, as K2's.  Left: the ulps of
// sincosf/expf and the order of the sums.

#include "pso_common.cuh"

namespace {

using namespace ndt;

constexpr int kThreads = 512;
constexpr int kRadius = 2;
constexpr int kSide = 2 * kRadius + 1;
constexpr int kK2 = kSide * kSide;
constexpr int kLanes = 128;
constexpr float kHalf = 16.0f;  // half the 32 m frame
constexpr float kCell = 1.0f;
constexpr float kW = 0.8f;
constexpr float kC = 2.0f;
constexpr float kSeedAmp = 0.01f;

enum Cost { kTrivial = 0, kMaskSum = 1, kQuad = 2 };

struct Params {
  int n_pts;
  int pop;
  int iters;
  int stage;
};

// K2's exp mode (rollout.cu), a template parameter there, held at exp with
// float32 operands: stage 3's score loop is K2's score_shared, instantiated
// as K2's rollout mode instantiates it.
constexpr int kMode = kExp;

__device__ __forceinline__ float sq3(const float* pose) {
  return pose[0] * pose[0] + pose[1] * pose[1] + pose[2] * pose[2];
}

template <int kCost>
__global__ void __launch_bounds__(kThreads)
bisect_kernel(const uint32_t* __restrict__ keys,   // [B, 2]
              const float* __restrict__ guesses,   // [B, 3]
              const float* __restrict__ devs,      // [B, 3]
              const float* __restrict__ pts_all,   // [B, 8, N]
              const float* __restrict__ sten_all,  // [B, 25, 8, N]
              float* __restrict__ out,             // [B, 8, 128]
              Params prm) {
  const int n = prm.n_pts;
  const int p = prm.pop;
  const int stage = prm.stage;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* sten = sten_all + (size_t)b * kK2 * 8 * n;
  const float* pts = pts_all + (size_t)b * 8 * n;
  float* o = out + (size_t)b * 8 * kLanes;

  const bool const_keys = stage == 10 || stage == 12 || stage >= 20;
  const bool const_guess = stage == 10 || stage == 11 || stage >= 20;
  constexpr int cost_kind = kCost;
  const uint32_t k0 = const_keys ? 12345u : keys[2 * b];
  const uint32_t k1 = const_keys ? 67890u : keys[2 * b + 1];
  float guess[3], dev[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    guess[k] = const_guess ? 0.0f : guesses[3 * b + k];
    dev[k] = const_guess ? 0.2f : devs[3 * b + k];
  }

  // Shared memory: the w rows [N, kWRow], then K2's particle state
  // [10, P] (component k of particle j at k * P + j: position, velocity,
  // personal best, its cost) and the evaluation's costs [P].  Particle j's
  // state is written and read by thread j % kThreads only, up to the
  // argmin merges.
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  float* s_pos = s_w + (size_t)n * kWRow;
  float* s_vel = s_pos + 3 * (size_t)p;
  float* s_pb = s_vel + 3 * (size_t)p;
  float* s_pbc = s_pb + 3 * (size_t)p;
  float* s_cost = s_pbc + p;
  __shared__ ArgminScratch<kThreads> red;
  __shared__ float s_sum[kThreads / 32];
  __shared__ float s_gbest[3];
  __shared__ float s_gcost;

  // Every lane of row r of this solve's output <- v[r].
  auto write_rows = [&](const float v[8]) {
    for (int i = tid; i < 8 * kLanes; i += kThreads) o[i] = v[i / kLanes];
  };

  // The seed: all 8 rows, counter = row, amplitude 0.01 (rows 3-7 of the
  // guess are 0).
  float g8[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    uint32_t lo, hi;
    threefry2x32(k0, k1, (uint32_t)r, 0u, &lo, &hi);
    g8[r] = (r < 3 ? guess[r] : 0.0f) + (2.0f * u01(lo) - 1.0f) * kSeedAmp;
  }
  if (stage == 26) {
    const float one[8] = {1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
    write_rows(one);
    return;
  }
  if (stage == 20) {  // each row of the seed summed over the population
    float v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float part = 0.0f;
      for (int j = tid; j < p; j += kThreads) part += g8[r];
      v[r] = block_sum<kThreads>(part, s_sum);
    }
    write_rows(v);
    return;
  }

  // The bind at `bind`: the stencil cell of every point; for the pseudo-cost
  // the mask's sum (returned), for the quadratic form the w rows into s_w.
  // Ends synchronised.
  auto bind_at = [&](const float* bind) -> float {
    __syncthreads();  // the previous evaluation has finished reading s_w
    if (cost_kind == kTrivial) return 0.0f;
    float s0, c0;
    sincosf(bind[2], &s0, &c0);
    float msum = 0.0f;
    for (int i = tid; i < n; i += kThreads) {
      const BoundPoint pt = bind_point(pts, sten, n, i, bind, c0, s0, kHalf, kCell, kRadius);
      if (cost_kind == kMaskSum)
        msum += pt.mask;
      else
        quad_row<false>(pt, bind, n, s_w + (size_t)i * kWRow);
    }
    float total = 0.0f;
    if (cost_kind == kMaskSum) total = block_sum<kThreads>(msum, s_sum);
    __syncthreads();
    return total;
  };

  // Cost of every particle at the binding `bind` into s_cost (msum: the
  // bind's mask sum); the quadratic form through K2's score_shared.
  auto score_all = [&](const float* bind, float msum) {
    if (cost_kind == kQuad) {
      score_shared<kThreads, kMode>(s_pos, p, bind, s_w, n,
                                           [&](int j, float part) { s_cost[j] = -part; });
      return;
    }
    for (int j = tid; j < p; j += kThreads) {
      const float pose[3] = {s_pos[j], s_pos[p + j], s_pos[2 * p + j]};
      s_cost[j] = cost_kind == kMaskSum ? -(msum + sq3(pose)) : -sq3(pose);
    }
  };

  // --- the seed's cost at the guess.
  const float msum0 = bind_at(guess);
  float g_cost;
  if (cost_kind == kQuad) {
    float g_phi[16];
    features<false>(g8, guess, g_phi);
    g_cost = -block_sum<kThreads>(score_rows<kMode>(s_w, tid, n, kThreads, g_phi), s_sum);
  } else if (cost_kind == kMaskSum) {
    g_cost = -(msum0 + sq3(g8));
  } else {
    g_cost = -sq3(g8);
  }
  if (stage == 21 || stage == 24 || stage == 25) {
    const float v = g_cost + 0.0f;
    const float rows[8] = {v, v, v, v, v, v, v, v};
    write_rows(rows);
    return;
  }

  // --- the population.
  for (int j = tid; j < p; j += kThreads) {
    float u[3];
    init_uniforms<false>(k0, k1, j, p, u);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = guess[k] + (2.0f * u[k] - 1.0f) * dev[k];
      s_pos[k * p + j] = x;
      s_vel[k * p + j] = 0.0f;
      s_pb[k * p + j] = x;
    }
  }
  score_all(guess, msum0);
  float bc;
  int bi;
  block_argmin<kThreads>(s_cost, p, &bc, &bi, red);
  // The first-argmin particle's pose, zeros when the minimum is NaN.
  float bp[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) bp[k] = isnan(bc) ? 0.0f : s_pos[k * p + bi];
  if (stage == 22) {  // rows 3-7 of the population are 0
    const float rows[8] = {bp[0] + bc, bp[1] + bc, bp[2] + bc, 0.0f + bc,
                           0.0f + bc,  0.0f + bc,  0.0f + bc,  0.0f + bc};
    write_rows(rows);
    return;
  }
  const bool imp = bc < g_cost;
  float gbest[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) gbest[k] = imp ? bp[k] : g8[k];
  float gcost = imp ? bc : g_cost;
  if (stage == 23) {
    float rows[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) rows[r] = (r < 3 ? gbest[r] : (imp ? 0.0f : g8[r])) + gcost;
    write_rows(rows);
    return;
  }

  // --- the PSO loop (stages 1-9).
  if (stage >= 1 && stage < 10) {
    for (int j = tid; j < p; j += kThreads) s_pbc[j] = s_cost[j];
    if (tid == 0) {
      s_gbest[0] = gbest[0];
      s_gbest[1] = gbest[1];
      s_gbest[2] = gbest[2];
      s_gcost = gcost;
    }
    __syncthreads();
    for (int it = 0; it < prm.iters; ++it) {
      const float gb[3] = {s_gbest[0], s_gbest[1], s_gbest[2]};
      for (int j = tid; j < p; j += kThreads) {
        float r1[3], r2[3];
        step_uniforms<false>(k0, k1, j, p, it, r1, r2);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float x = s_pos[k * p + j];
          const float v = kW * s_vel[k * p + j] + kC * r1[k] * (s_pb[k * p + j] - x) +
                          kC * r2[k] * (gb[k] - x);
          s_vel[k * p + j] = v;
          s_pos[k * p + j] = x + v;
        }
      }
      const float msum = bind_at(gb);
      score_all(gb, msum);
      for (int j = tid; j < p; j += kThreads) {
        if (s_cost[j] < s_pbc[j]) {
          s_pbc[j] = s_cost[j];
          s_pb[j] = s_pos[j];
          s_pb[p + j] = s_pos[p + j];
          s_pb[2 * p + j] = s_pos[2 * p + j];
        }
      }
      float bci;
      int bii;
      block_argmin<kThreads>(s_pbc, p, &bci, &bii, red);
      if (tid == 0 && bci < s_gcost) {
        s_gbest[0] = s_pb[bii];
        s_gbest[1] = s_pb[p + bii];
        s_gbest[2] = s_pb[2 * p + bii];
        s_gcost = bci;
      }
      __syncthreads();
    }
    gbest[0] = s_gbest[0];
    gbest[1] = s_gbest[1];
    gbest[2] = s_gbest[2];
    gcost = s_gcost;
  }
  const float rows[8] = {gbest[0], gbest[1], gbest[2], gcost, gcost, gcost, gcost, gcost};
  write_rows(rows);
}

// Each cost kind is its own instantiation, so stage 3's kernel is compiled
// for the quadratic form alone, as K2's is.
template <int kCost>
int launch(const Params& prm, int batch, size_t smem, cudaStream_t stream, const void* keys,
           const void* guesses, const void* devs, const void* pts, const void* sten, void* out) {
  cudaError_t err = cudaFuncSetAttribute(bisect_kernel<kCost>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bisect_kernel<kCost><<<batch, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float*>(guesses),
      static_cast<const float*>(devs), static_cast<const float*>(pts),
      static_cast<const float*>(sten), static_cast<float*>(out), prm);
  return (int)cudaGetLastError();
}

size_t smem_bytes(int n, int p) {
  return sizeof(float) * (kWRow * (size_t)n + 11 * (size_t)p);
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (the w rows, the particle state).
size_t ndt_bisect_smem_bytes(int n_pts, int population) { return smem_bytes(n_pts, population); }

// Runs `stage` of B solves on `stream`.  Returns cudaGetLastError() after
// the launch.
int ndt_rollout_bisect(const void* keys, const void* guesses, const void* devs, const void* pts,
                       const void* sten, void* out, int batch, int n_pts, int population,
                       int iterations, int stage, void* stream) {
  if (stage < 0 || stage > 27 || population < 1 || n_pts < 1 || iterations < 0)
    return (int)cudaErrorInvalidValue;
  const Params prm{n_pts, population, iterations, stage};
  const size_t smem = smem_bytes(n_pts, population);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage < 2 || stage >= 10)
    return launch<kTrivial>(prm, batch, smem, s, keys, guesses, devs, pts, sten, out);
  if (stage == 2) return launch<kMaskSum>(prm, batch, smem, s, keys, guesses, devs, pts, sten, out);
  return launch<kQuad>(prm, batch, smem, s, keys, guesses, devs, pts, sten, out);
}

}  // extern "C"
