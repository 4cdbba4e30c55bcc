// Whole-solve PSO scan match with correspondences frozen at the incumbent.
//
// Replaces ndtpso_slam_tpu/ops/pallas_rollout.py:_rollout_kernel, every
// branch: Threefry or (turbo) Philox draws, f32 or bf16 scoring operands,
// exp / exp2 / approx (Schraudolph) scoring, and the early exit.  One
// thread-block cluster of C CTAs runs one whole solve.  Each evaluation
//
//   1. rebinds the points at the binding pose (the guess at init, then the
//      global best of the previous iteration): each CTA transforms and bins
//      its own slice of the points and loads each point's cell from its
//      25-cell stencil directly (sten[kk][.][n]; the TPU kernel's one-hot
//      select only ever added zeros to that value), then builds the 15
//      quadratic-form coefficients w of models/cost.py:_quadform_bound with
//      the validity mask folded in (w *= mask; w14 += (1 - mask) * 1e9, so a
//      masked point scores exp(-5e8) == 0 exactly) and keeps w in shared
//      memory;
//   2. scores every particle over the CTA's points: the monomials phi(u) of
//      each particle relative to the binding pose, and exp(-max(w . phi,
//      0) / 2) summed over the rows of w -- f32 operands on the FP32 pipes
//      (pso_common.cuh: score_shared, each thread a tile of 4 of its
//      particles, rows outside, the tile inside), bf16 operands on the
//      tensor cores (score_mma, below);
//   3. adds the C CTAs' partial costs in rank order (cluster_total).
//
// What bounds it on an H100: arithmetic, N * P * (15 multiply-adds + one
// exp) per evaluation and 2 + iterations evaluations per solve, on the FP32
// pipes and the special-function units.  What the design does about it:
//
// * The scoring switches (exp mode, bf16 operands) and the draw stream are
//   template parameters (all 12 combinations are compiled, for each route;
//   the C entry dispatches once), so the score loop has no runtime branch: the staged
//   twin (rollout_bisect.cu) measured 4.1 ms of the one-block K2's 37.3 ms
//   in those branches (PERF.md).
// * The f32 score loop loads each w row (four broadcast LDS.128) once per
//   tile of 4 particles and runs the 4 fmaf chains side by side.  The registers
//   that takes come from the particle state, which moved to shared memory
//   ([10, P] floats: position, velocity, personal best and its cost, 160 KB
//   at P = 4096, beside w's 24.6 KB at N = 384; so this route is bounded by
//   shared memory, ~4,700 particles at N = 384, 5,189 at C = 8).
// * Larger populations take the global route (kGlobal): the same code with
//   the state [10, P] and the partial costs [P + 1] in a per-CTA slice of a
//   global scratch buffer the wrapper allocates (B * C slices; every CTA of
//   a cluster still runs the scaffolding redundantly), and only w in shared
//   memory.  Each thread keeps touching only its own particles, j % 512 ==
//   tid, so the accesses are coalesced ([10, P] by component) and need no
//   more synchronization than the shared route's; the peers' partials are
//   read through L2 after the cluster barrier (cluster_total_global).  The
//   state traffic, ~80 B per particle per iteration, stays small beside the
//   score loop's N * 17 operations per particle.
// * Small batches spread over the card: with B = 16 solves, 16 blocks left
//   116 of 132 SMs idle; a cluster of C = 8 CTAs per solve, each binding and
//   scoring N / C points, uses 128 (an H100 holds 15 such clusters at once,
//   so the 16th runs after them).  Every CTA runs the same draws, update
//   and bookkeeping, and adds the partials in the same order, so every CTA
//   takes the same decisions; the early exit reads rank 0's stall count
//   after a cluster barrier, and a last barrier comes before any CTA exits.
//
// bf16 scoring rounds both operands (w after the mask fold, and phi) to
// bfloat16, round to nearest even, and accumulates in float32: the product
// of two bf16 values is exact in float32, as in the TPU kernel's MXU.  The
// contraction runs on the tensor cores (pso_common.cuh: score_mma, one
// mma.sync.m16n8k16 per 16 points x 8 particles; K = 15 coefficients and a
// 0 pad is exactly k16), the exps and the point sums on the accumulator
// fragments; only the order of the additions inside the mma differs from a
// float32 chain.  The f32 route stays on the FP32 pipes (TF32 loses cost
// accuracy at the real workload's ranges).
//
// Numerics: built with --fmad=false and without fast math, so every
// + - * / of the rebind and the PSO update rounds as in the plain PyTorch
// version.  The one contraction, z = w . phi, is pso_common.cuh's dot15, a
// chain of fused multiply-adds as the plain version's matrix product
// computes it.  The differences left are the ulps of sincosf/expf/exp2f and
// the order of the sums (within a rank, then across ranks in rank order).

#include "pso_common.cuh"

namespace {

using namespace ndt;
namespace cg = cooperative_groups;

constexpr int kThreads = 512;

struct Params {
  int n_pts;
  int pop;
  int iters;
  int radius;
  int early_exit;
  float half;
  float cell_side;
  float w0;
  float c1;
  float c2;
  float w_damping;
  float zdev0, zdev1, zdev2;
};

template <bool kPhilox, bool kBf16, int kMode, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
rollout_kernel(const uint32_t* __restrict__ keys,   // [B, 2]
               const float* __restrict__ guesses,   // [B, 3]
               const float* __restrict__ devs,      // [B, 3]
               const float* __restrict__ sten_all,  // [B, K2, 8, N]
               const float* __restrict__ pts_all,   // [B, 8, N]
               float* __restrict__ out,             // [B, 4]
               float* __restrict__ scratch,         // [B * C, slice_floats(P)] (kGlobal)
               Params prm) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = prm.n_pts;
  const int p = prm.pop;
  const int r = prm.radius;
  const int side = 2 * r + 1;
  const int b = blockIdx.x / nranks;
  const int tid = threadIdx.x;
  const float* sten = sten_all + (size_t)b * side * side * 8 * n;
  const float* pts = pts_all + (size_t)b * 8 * n;
  const uint32_t k0 = keys[2 * b];
  const uint32_t k1 = keys[2 * b + 1];
  const float guess[3] = {guesses[3 * b], guesses[3 * b + 1], guesses[3 * b + 2]};
  const float dev[3] = {devs[3 * b], devs[3 * b + 1], devs[3 * b + 2]};
  const float zdev[3] = {prm.zdev0, prm.zdev1, prm.zdev2};
  const int s = (n + nranks - 1) / nranks;
  int i0, cnt;
  point_slice(n, nranks, rank, &i0, &cnt);

  // Shared memory: the w rows of this CTA's points [S, kWRow], the particle
  // state [kState, P] (component k of particle j at k * P + j), and the
  // partial scores [P + 1] its peers read (slot p: the gbest seed); on the
  // global route the state and the partials lie in this CTA's scratch slice.
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  float* s_pos =
      kGlobal ? scratch + (size_t)blockIdx.x * slice_floats(p) : s_w + (size_t)s * kWRow;
  float* s_vel = s_pos + 3 * (size_t)p;
  float* s_pb = s_vel + 3 * (size_t)p;
  float* s_pbc = s_pb + 3 * (size_t)p;
  float* s_part = s_pbc + p;
  __shared__ ArgminScratch<kThreads> red;
  __shared__ float s_sum[kThreads / 32];
  __shared__ float s_gbest[3];
  __shared__ float s_gcost;
  __shared__ int s_stale;

  // Rebind this CTA's points at `bind`: their w rows into s_w (ends
  // synchronised).
  auto bind_at = [&](const float* bind) {
    float s0, c0;
    sincosf(bind[2], &s0, &c0);
    __syncthreads();  // the previous evaluation has finished reading s_w
    for (int il = tid; il < cnt; il += kThreads) {
      const BoundPoint pt =
          bind_point(pts, sten, n, i0 + il, bind, c0, s0, prm.half, prm.cell_side, r);
      quad_row<kBf16>(pt, bind, n, s_w + (size_t)il * kWRow);
    }
    __syncthreads();
  };

  // --- init (core.cpp:53-69): population, then the global-best seed.
  // Particle j's state is written and read by thread j % kThreads only,
  // up to the argmin merges.
  for (int j = tid; j < p; j += kThreads) {
    float u[3];
    init_uniforms<kPhilox>(k0, k1, j, p, u);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = guess[k] + (2.0f * u[k] - 1.0f) * dev[k];
      s_pos[k * p + j] = x;
      s_vel[k * p + j] = 0.0f;
      s_pb[k * p + j] = x;
    }
  }
  float g_pos[3];
  {
    float u[3];
    init_uniforms<kPhilox>(k0, k1, p, p, u);
#pragma unroll
    for (int k = 0; k < 3; ++k) g_pos[k] = guess[k] + (2.0f * u[k] - 1.0f) * zdev[k];
  }

  // Each particle's cost at `bind` handed to on_cost(j, cost), by the
  // thread that owns j; with_seed, the seed's cost returned (0 otherwise).
  // This CTA's partials go to s_part, the totals come from the cluster in
  // rank order.  All threads of all CTAs call it; it ends after a cluster
  // barrier.
  auto evaluate = [&](const float* bind, bool with_seed, auto on_cost) -> float {
    const auto to_part = [&](int j, float part) { s_part[j] = part; };
    if constexpr (kBf16)
      score_mma<kThreads, kMode>(s_pos, p, bind, s_w, cnt, to_part);
    else
      score_shared<kThreads, kMode>(s_pos, p, bind, s_w, cnt, to_part);
    if (with_seed) {
      float g_phi[16];
      features<kBf16>(g_pos, bind, g_phi);
      const float t = block_sum<kThreads>(score_rows<kMode>(s_w, tid, cnt, kThreads, g_phi), s_sum);
      if (tid == 0) s_part[p] = t;
    }
    cluster.sync();
    const auto total = [&](int j) {
      if constexpr (kGlobal)
        return cluster_total_global(s_part - (size_t)rank * slice_floats(p), slice_floats(p), j,
                                    nranks);
      else
        return cluster_total(s_part, j, nranks);
    };
    for (int j = tid; j < p; j += kThreads) on_cost(j, -total(j));
    const float g_cost = with_seed ? -total(p) : 0.0f;
    cluster.sync();
    return g_cost;
  };

  bind_at(guess);
  const float g_cost = evaluate(guess, true, [&](int j, float c) { s_pbc[j] = c; });
  {
    float bc;
    int bi;
    block_argmin<kThreads>(s_pbc, p, &bc, &bi, red);
    if (tid == 0) {
      const bool imp = bc < g_cost;
      for (int k = 0; k < 3; ++k) s_gbest[k] = imp ? s_pb[k * p + bi] : g_pos[k];
      s_gcost = imp ? bc : g_cost;
      s_stale = 0;
    }
    __syncthreads();
  }

  // --- synchronous-gbest loop (core.cpp:78-110).
  float w = prm.w0;
  bool stop = false;
  for (int it = 0; it < prm.iters && !stop; ++it) {
    const float gb[3] = {s_gbest[0], s_gbest[1], s_gbest[2]};
    for (int j = tid; j < p; j += kThreads) {
      float r1[3], r2[3];
      step_uniforms<kPhilox>(k0, k1, j, p, it, r1, r2);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float x = s_pos[k * p + j];
        const float v = w * s_vel[k * p + j] + prm.c1 * r1[k] * (s_pb[k * p + j] - x) +
                        prm.c2 * r2[k] * (gb[k] - x);
        s_vel[k * p + j] = v;
        s_pos[k * p + j] = x + v;
      }
    }
    bind_at(gb);
    evaluate(gb, false, [&](int j, float c) {
      if (c < s_pbc[j]) {
        s_pbc[j] = c;
        s_pb[j] = s_pos[j];
        s_pb[p + j] = s_pos[p + j];
        s_pb[2 * p + j] = s_pos[2 * p + j];
      }
    });
    // The first-argmin personal best.
    float bc;
    int bi;
    block_argmin<kThreads>(s_pbc, p, &bc, &bi, red);
    if (tid == 0) {
      if (bc < s_gcost) {
        for (int k = 0; k < 3; ++k) s_gbest[k] = s_pb[k * p + bi];
        s_gcost = bc;
        s_stale = 0;
      } else {
        s_stale += 1;
      }
    }
    w = w * prm.w_damping;
    __syncthreads();
    if (prm.early_exit > 0) {  // every CTA stops on rank 0's count
      cluster.sync();
      stop = *cluster.map_shared_rank(&s_stale, 0) >= prm.early_exit;
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still read its shared memory
  if (rank == 0 && tid == 0) {
    out[4 * b] = s_gbest[0];
    out[4 * b + 1] = s_gbest[1];
    out[4 * b + 2] = s_gbest[2];
    out[4 * b + 3] = s_gcost;
  }
}

// Dynamic shared memory of one CTA: w's rows, and on the shared route the
// state and the partials.
size_t smem_bytes(int n, int p, int cluster, bool global) {
  const size_t s = (size_t)((n + cluster - 1) / cluster);
  return sizeof(float) * (kWRow * s + (global ? 0 : slice_floats(p)));
}

template <bool kPhilox, bool kBf16, int kMode, bool kGlobal>
int launch(const Params& prm, int batch, int cluster, size_t smem, cudaStream_t stream,
           const void* keys, const void* guesses, const void* devs, const void* sten,
           const void* pts, void* out, void* scratch) {
  return launch_cluster(rollout_kernel<kPhilox, kBf16, kMode, kGlobal>, batch * cluster, kThreads,
                        cluster, smem, stream, static_cast<const uint32_t*>(keys),
                        static_cast<const float*>(guesses), static_cast<const float*>(devs),
                        static_cast<const float*>(sten), static_cast<const float*>(pts),
                        static_cast<float*>(out), static_cast<float*>(scratch), prm);
}

template <bool kPhilox, bool kBf16, bool kGlobal>
int by_exp_mode(int exp_mode, const Params& prm, int batch, int cluster, size_t smem,
                cudaStream_t s, const void* keys, const void* guesses, const void* devs,
                const void* sten, const void* pts, void* out, void* scratch) {
  switch (exp_mode) {
    case kExp:
      return launch<kPhilox, kBf16, kExp, kGlobal>(prm, batch, cluster, smem, s, keys, guesses,
                                                   devs, sten, pts, out, scratch);
    case kExp2:
      return launch<kPhilox, kBf16, kExp2, kGlobal>(prm, batch, cluster, smem, s, keys, guesses,
                                                    devs, sten, pts, out, scratch);
    case kApprox:
      return launch<kPhilox, kBf16, kApprox, kGlobal>(prm, batch, cluster, smem, s, keys, guesses,
                                                      devs, sten, pts, out, scratch);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kGlobal>
int by_route(int philox, int bf16, int exp_mode, const Params& prm, int batch, int cluster,
             size_t smem, cudaStream_t s, const void* keys, const void* guesses, const void* devs,
             const void* sten, const void* pts, void* out, void* scratch) {
  if (philox && bf16)
    return by_exp_mode<true, true, kGlobal>(exp_mode, prm, batch, cluster, smem, s, keys, guesses,
                                            devs, sten, pts, out, scratch);
  if (philox)
    return by_exp_mode<true, false, kGlobal>(exp_mode, prm, batch, cluster, smem, s, keys,
                                             guesses, devs, sten, pts, out, scratch);
  if (bf16)
    return by_exp_mode<false, true, kGlobal>(exp_mode, prm, batch, cluster, smem, s, keys,
                                             guesses, devs, sten, pts, out, scratch);
  return by_exp_mode<false, false, kGlobal>(exp_mode, prm, batch, cluster, smem, s, keys, guesses,
                                            devs, sten, pts, out, scratch);
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA of a cluster of `cluster` needs, on the
// global route (global != 0) or the shared one.
size_t ndt_rollout_smem_bytes(int n_pts, int population, int cluster, int global) {
  return smem_bytes(n_pts, population, cluster, global != 0);
}

// Floats of one CTA's slice of the global route's scratch.
size_t ndt_rollout_slice_floats(int population) { return slice_floats(population); }

// The most clusters of `cluster` CTAs the device holds at once for the
// shape and route, into *out (every instantiation has 512 threads at <= 128
// registers, so one per route stands for all).  Returns the CUDA error, or 0.
int ndt_rollout_max_active_clusters(int n_pts, int population, int cluster, int global, int* out) {
  const size_t smem = smem_bytes(n_pts, population, cluster, global != 0);
  return global ? max_active_clusters(rollout_kernel<false, false, kExp, true>, kThreads, cluster,
                                      smem, out)
                : max_active_clusters(rollout_kernel<false, false, kExp, false>, kThreads, cluster,
                                      smem, out);
}

// Launches B solves on `stream`, one cluster of `cluster` CTAs each: with
// scratch == nullptr on the shared route, else on the global route with
// scratch [B * cluster, slice_floats(population)] floats.  Returns
// cudaGetLastError() after the launch.
int ndt_rollout(const void* keys, const void* guesses, const void* devs, const void* sten,
                const void* pts, void* out, void* scratch, int batch, int n_pts, int population,
                int iterations, int radius, int early_exit, int philox, int bf16,
                int exp_mode, int cluster, float half, float cell_side, float w, float c1,
                float c2, float w_damping, float zdev0, float zdev1, float zdev2, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 || n_pts < 1 ||
      population < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const Params prm{n_pts, population, iterations, radius, early_exit, half, cell_side,
                   w, c1, c2, w_damping, zdev0, zdev1, zdev2};
  const bool global = scratch != nullptr;
  const size_t smem = smem_bytes(n_pts, population, cluster, global);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (global)
    return by_route<true>(philox, bf16, exp_mode, prm, batch, cluster, smem, s, keys, guesses,
                          devs, sten, pts, out, scratch);
  return by_route<false>(philox, bf16, exp_mode, prm, batch, cluster, smem, s, keys, guesses,
                         devs, sten, pts, out, scratch);
}

}  // extern "C"
