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
// One thread block runs one solve, as K2's kernel does, and the stages
// 1, 2 and 3 at K2's batch shape split K2's time into the draws and the
// update, the bind, and the score.  The particles are spread over the
// block's 512 threads, ceil(P / 512) in each thread's registers; the
// 1 + 3 P * (1 + iterations) Threefry counters are those of
// pso_common.cuh's init_uniforms and step_uniforms (the TPU kernel's
// tf(3 + 3j + k) and tf(3 + 3P + 3P it + 3j + k)); the seed's pose draws
// counter = row with amplitude 0.01.  The bind, the score and the
// first-argmin merge are K2's own device code (pso_common.cuh: bind_point,
// quad_row, score_particles, select_particle), so stage 3's loop is K2's:
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
  // K2's scoring switches (rollout.cu), kernel parameters there as here and
  // held at float32 operands and exp, so that stage 3's score loop is
  // compiled as K2's is.
  int bf16;
  int exp_mode;
};

__device__ __forceinline__ float sq3(const float* pose) {
  return pose[0] * pose[0] + pose[1] * pose[1] + pose[2] * pose[2];
}

template <int kPPT>
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
  const int cost_kind = (stage < 2 || stage >= 10) ? kTrivial : (stage == 2 ? kMaskSum : kQuad);
  const uint32_t k0 = const_keys ? 12345u : keys[2 * b];
  const uint32_t k1 = const_keys ? 67890u : keys[2 * b + 1];
  float guess[3], dev[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    guess[k] = const_guess ? 0.0f : guesses[3 * b + k];
    dev[k] = const_guess ? 0.2f : devs[3 * b + k];
  }

  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [N, kWRow]
  __shared__ ArgminScratch<kThreads> red;
  __shared__ float s_sum[kThreads / 32];
  __shared__ float s_cand[3];
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
#pragma unroll
      for (int q = 0; q < kPPT; ++q)
        if (q * kThreads + tid < p) part += g8[r];
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
        quad_row(pt, bind, n, prm.bf16, s_w + (size_t)i * kWRow);
    }
    float total = 0.0f;
    if (cost_kind == kMaskSum) total = block_sum<kThreads>(msum, s_sum);
    __syncthreads();
    return total;
  };

  float pos[kPPT][3], vel[kPPT][3], pb[kPPT][3], pbc[kPPT];

  // Cost of each of this thread's particles at the binding `bind`
  // (msum: the bind's mask sum).
  auto score_own = [&](const float* bind, float msum, float cost[kPPT]) {
    if (cost_kind == kQuad) {
      score_particles<kThreads, kPPT>(pos, p, bind, s_w, n, prm.bf16, prm.exp_mode, cost);
      return;
    }
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      cost[q] = 0.0f;
      if (q * kThreads + tid < p)
        cost[q] = cost_kind == kMaskSum ? -(msum + sq3(pos[q])) : -sq3(pos[q]);
    }
  };

  // --- the seed's cost at the guess.
  const float msum0 = bind_at(guess);
  float g_cost;
  if (cost_kind == kQuad) {
    float g_phi[16];
    features(g8, guess, prm.bf16, g_phi);
    g_cost = -block_sum<kThreads>(score_rows(s_w, tid, n, kThreads, g_phi, prm.exp_mode), s_sum);
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
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    const int j = q * kThreads + tid;
    float u[3] = {0.0f, 0.0f, 0.0f};
    if (j < p) init_uniforms(0, k0, k1, j, p, u);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pos[q][k] = guess[k] + (2.0f * u[k] - 1.0f) * dev[k];
      vel[q][k] = 0.0f;
      pb[q][k] = pos[q][k];
    }
  }
  score_own(guess, msum0, pbc);
  const float bc = select_particle<kThreads, kPPT>(pbc, pos, p, red, s_cand);
  const float bp[3] = {s_cand[0], s_cand[1], s_cand[2]};
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
    if (tid == 0) {
      s_gbest[0] = gbest[0];
      s_gbest[1] = gbest[1];
      s_gbest[2] = gbest[2];
      s_gcost = gcost;
    }
    __syncthreads();
    for (int it = 0; it < prm.iters; ++it) {
      const float gb[3] = {s_gbest[0], s_gbest[1], s_gbest[2]};
#pragma unroll
      for (int q = 0; q < kPPT; ++q) {
        const int j = q * kThreads + tid;
        if (j >= p) continue;
        float r1[3], r2[3];
        step_uniforms(0, k0, k1, j, p, it, r1, r2);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float x = pos[q][k];
          const float v = kW * vel[q][k] + kC * r1[k] * (pb[q][k] - x) + kC * r2[k] * (gb[k] - x);
          vel[q][k] = v;
          pos[q][k] = x + v;
        }
      }
      const float msum = bind_at(gb);
      float cost[kPPT];
      score_own(gb, msum, cost);
#pragma unroll
      for (int q = 0; q < kPPT; ++q) {
        if (q * kThreads + tid < p && cost[q] < pbc[q]) {
          pbc[q] = cost[q];
          pb[q][0] = pos[q][0];
          pb[q][1] = pos[q][1];
          pb[q][2] = pos[q][2];
        }
      }
      const float bci = select_particle<kThreads, kPPT>(pbc, pb, p, red, s_cand);
      if (tid == 0 && bci < s_gcost) {
        s_gbest[0] = s_cand[0];
        s_gbest[1] = s_cand[1];
        s_gbest[2] = s_cand[2];
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

template <int kPPT>
int launch(const Params& prm, int batch, size_t smem, cudaStream_t stream, const void* keys,
           const void* guesses, const void* devs, const void* pts, const void* sten, void* out) {
  cudaError_t err = cudaFuncSetAttribute(
      bisect_kernel<kPPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bisect_kernel<kPPT><<<batch, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const float*>(guesses),
      static_cast<const float*>(devs), static_cast<const float*>(pts),
      static_cast<const float*>(sten), static_cast<float*>(out), prm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs (the w rows).
size_t ndt_bisect_smem_bytes(int n_pts) { return sizeof(float) * kWRow * (size_t)n_pts; }

// Largest population one launch takes (8 particles per thread).
int ndt_bisect_max_population() { return 8 * kThreads; }

// Runs `stage` of B solves on `stream`.  Returns cudaGetLastError() after
// the launch.
int ndt_rollout_bisect(const void* keys, const void* guesses, const void* devs, const void* pts,
                       const void* sten, void* out, int batch, int n_pts, int population,
                       int iterations, int stage, void* stream) {
  if (stage < 0 || stage > 27 || population < 1 || n_pts < 1 || iterations < 0)
    return (int)cudaErrorInvalidValue;
  const Params prm{n_pts, population, iterations, stage, 0, kExp};
  const size_t smem = ndt_bisect_smem_bytes(n_pts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_thread = (population + kThreads - 1) / kThreads;
  if (per_thread <= 1) return launch<1>(prm, batch, smem, s, keys, guesses, devs, pts, sten, out);
  if (per_thread <= 2) return launch<2>(prm, batch, smem, s, keys, guesses, devs, pts, sten, out);
  if (per_thread <= 4) return launch<4>(prm, batch, smem, s, keys, guesses, devs, pts, sten, out);
  if (per_thread <= 8) return launch<8>(prm, batch, smem, s, keys, guesses, devs, pts, sten, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
