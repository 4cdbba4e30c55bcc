// Whole-solve PSO scan match with per-particle exact stencil rebinning.
//
// Replaces ndtpso_slam_tpu/ops/pallas_rollout.py:_rollout_local_kernel, both
// branches: Threefry with exact exp (rollout_local), and the turbo branch
// (rollout_local_turbo), whose TPU hardware generator becomes Philox4x32-10
// (the layout of ops/rng.py:philox_uniforms) and which scores with exp2.
// One thread-block cluster of C CTAs runs one whole solve: the draws, the
// population init, the synchronous-gbest loop with the first-argmin merge,
// and every cost evaluation, in a single launch.  Per (particle, point) an
// evaluation transforms the point, bins it, and, when the cell lies inside
// the point's 25-cell stencil, loads that stencil lane directly
// (sten[kk][n]) -- the TPU kernel's one-hot select over the 25 offsets only
// ever added zeros to this value.  Unbuilt and out-of-stencil lanes score
// exactly 0.
//
// What bounds it on an H100: latency.  A solve is a chain of
// 2 + iterations dependent evaluations, each followed by a first-argmin
// merge, and sequential SLAM runs one solve at a time (B = 1).  On one
// block (the first design) one SM of 132 did all the work and every
// (particle, point) pair waited on an L2 load of its stencil lane (the table,
// 25 * N * 8 floats, 307 KB at N = 384, exceeds one block's 227 KB).  The
// cluster spreads the solve over C SMs (C = 8 at small batches) and the
// table over their shared memory:
//
// * CTA `rank` owns the points [rank * S, (rank + 1) * S), S = ceil(N / C)
//   (points past N are masked), and copies its slice of the table -- the
//   rows of its points are contiguous within each of the 25 lanes of the
//   packed [B, K2, N, 8] layout, 38.4 KB at N = 384, C = 8 -- into shared
//   memory with cp.async at kernel start, overlapped with the init draws.
//   The gathers of the inner loop are shared-memory loads.
// * Every CTA runs the whole PSO scaffolding redundantly (the same draws,
//   update, pbest/gbest and stall bookkeeping), so no particle state is
//   exchanged.  The particle state lives in registers, ceil(P / (512 / G))
//   particles per thread (up to P = 8192); at P < 512 a group of G threads
//   (a power of two <= 32) shares one particle, each thread scoring every
//   G-th point, summed by a butterfly over the group.
// * Above 8,192 particles (rollout_local_global_kernel) the state moves to
//   a per-CTA slice of a global scratch buffer the wrapper allocates, laid
//   out [10, P] by component (position, velocity, personal best, its cost),
//   with the partial costs [P + 1] after it: thread t owns particles
//   j = t, t + 512, ..., so a warp's accesses to one component are 32
//   consecutive floats (coalesced), each thread touches only its own
//   particles, and the layout is K2's, whose argmin and update code it
//   shares.  The score runs over register tiles of 4 of the thread's
//   particles loaded from the slice, as the register route's tile; the
//   state traffic, ~80 B per particle per iteration, is small beside the
//   N point evaluations per particle.  The peers' partials are read
//   through L2 after the cluster barrier (cluster_total_global).
// * Each evaluation writes this CTA's partial score of every particle into
//   its shared part[P + 1]; after a cluster barrier every CTA adds the C
//   partials in rank order (pso_common.cuh: cluster_total), so all CTAs get
//   the same bits and take the same decisions; a second barrier keeps a
//   partial from being overwritten while a peer reads it.  The early exit
//   reads rank 0's stall count after a cluster barrier, and a last barrier
//   comes before any CTA exits.
//
// Numerics: build with --fmad=false (no FMA contraction) and without
// --use_fast_math, so every + - * / rounds as in the plain PyTorch version
// and expf/sinf/cosf are the accurate ones; what remains are the last-ulp
// differences of those functions and the order of the point sums (within a
// rank, then across ranks in rank order).

#include "pso_common.cuh"

namespace {

using namespace ndt;
namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kMaxPPT = 16;
constexpr int kLane = 8;  // floats per stencil lane row: mx my la lb lc pen 0 0
// Each lane of the table slice in shared memory is padded by 4 floats, so
// that lanes kk and kk + 1 of one point lie 16 B apart modulo the 128 B of
// the 32 banks: threads that gather one point from different lanes (one
// thread per particle) hit different banks.  Unpadded, lane strides of
// S * 32 B (1,536 B at S = 48) put them all in the same bank.
constexpr int kLanePad = 4;

struct Params {
  int n_pts;
  int pop;
  int iters;
  int radius;
  int early_exit;
  int philox;     // 0: Threefry (parity stream), 1: Philox (turbo)
  int exp2_mode;  // 0: expf(-q/2), 1: exp2f(q * kExp2Scale) (turbo)
  int group;      // threads per particle, a power of two <= 32
  float half;
  float cell_side;
  // 1 / cell_side when cell_side is a power of two, else 0: then
  // x / cell_side == x * inv_cell bit for bit, and the binning multiplies
  // instead of dividing (two IEEE divisions per particle and point).
  float inv_cell;
  float w0;
  float c1;
  float c2;
  float w_damping;
  float zdev0, zdev1, zdev2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void init_draw(int philox, uint32_t k0, uint32_t k1, int j, int p,
                                          float u[3]) {
  if (philox)
    init_uniforms<true>(k0, k1, j, p, u);
  else
    init_uniforms<false>(k0, k1, j, p, u);
}

__device__ __forceinline__ void step_draw(int philox, uint32_t k0, uint32_t k1, int j, int p,
                                          int it, float r1[3], float r2[3]) {
  if (philox)
    step_uniforms<true>(k0, k1, j, p, it, r1, r2);
  else
    step_uniforms<false>(k0, k1, j, p, it, r1, r2);
}

// A CTA's share of one solve in shared memory: its slice of the stencil
// table [K2, S, 8] (lane stride lane_stride) and its point columns [S], and
// the scoring of one of its points at a pose.
struct PointSlice {
  float* sten;
  float* px;
  float* py;
  int* ax;
  int* ay;
  float* valid;
  int lane_stride;
  int cnt;
  int r;
  int side;
  float half;
  float cell;
  float inv_cell;
  bool exp2_mode;

  // Score of local point i (its columns px, py, ax, ay, valid loaded) at
  // the pose (tx, ty) with cos c, sin sn; branch-free, so a tile of
  // particles runs as independent chains: a point outside its stencil or
  // masked reads lane 0 of its row (which exists) and scores exactly 0.
  __device__ __forceinline__ float score(int i, float pxi, float pyi, int axi, int ayi, bool ok,
                                         float tx, float ty, float c, float sn) const {
    const float qx = pxi * c - pyi * sn + tx;
    const float qy = pxi * sn + pyi * c + ty;
    const bool inb = (qx > -half) && (qx < half) && (qy > -half) && (qy < half);
    float gx = qx + half, gy = qy + half;
    if (inv_cell != 0.0f) {
      gx = gx * inv_cell;
      gy = gy * inv_cell;
    } else {
      gx = gx / cell;
      gy = gy / cell;
    }
    const int di = floor_i32(gx) - axi;
    const int dj = floor_i32(gy) - ayi;
    const bool in_st = abs(di) <= r && abs(dj) <= r;
    const int kk = in_st ? (dj + r) * side + (di + r) : 0;
    const float* row = sten + (size_t)kk * lane_stride + i * kLane;
    const float4 a = *reinterpret_cast<const float4*>(row);      // mx my la lb
    const float2 e = *reinterpret_cast<const float2*>(row + 4);  // lc pen
    const float dx = qx - a.x;
    const float dy = qy - a.y;
    const float quad = a.z * dx * dx + 2.0f * a.w * dx * dy + e.x * dy * dy;
    const float sc = exp2_mode ? exp2f(quad * kExp2Scale) : expf(-0.5f * quad);
    return (inb && ok && in_st && e.y == 0.0f) ? sc : 0.0f;
  }

  // Sum of the scores of points li, li + g, ... < cnt at one pose.
  __device__ __forceinline__ float sum(int li, int g, float tx, float ty, float th) const {
    float sn, c;
    sincosf(th, &sn, &c);
    float acc = 0.0f;
    for (int i = li; i < cnt; i += g)
      acc += score(i, px[i], py[i], ax[i], ay[i], valid[i] != 0.0f, tx, ty, c, sn);
    return acc;
  }
};

// Lays out this CTA's PointSlice at the start of dynamic shared memory and
// starts filling it: the table's rows of points [i0, i0 + cnt) of each lane
// (32 B each, in 16 B asynchronous copies, which the caller waits for with
// cp_async_wait_all) and the point columns (zeros past cnt).  Returns the
// end of the slice.
__device__ __forceinline__ float* load_slice(PointSlice* ps, float* smem, const float* sten,
                                             const float* pts, int n, int s, int i0, int cnt,
                                             const Params& prm) {
  const int side = 2 * prm.radius + 1;
  const int k2 = side * side;
  ps->lane_stride = s * kLane + kLanePad;
  ps->sten = smem;
  ps->px = ps->sten + (size_t)k2 * ps->lane_stride;
  ps->py = ps->px + s;
  ps->ax = reinterpret_cast<int*>(ps->py + s);
  ps->ay = ps->ax + s;
  ps->valid = reinterpret_cast<float*>(ps->ay + s);
  ps->cnt = cnt;
  ps->r = prm.radius;
  ps->side = side;
  ps->half = prm.half;
  ps->cell = prm.cell_side;
  ps->inv_cell = prm.inv_cell;
  ps->exp2_mode = prm.exp2_mode != 0;
  for (int e = threadIdx.x; e < k2 * cnt * 2; e += kThreads) {
    const int kk = e / (cnt * 2);
    const int h = e - kk * cnt * 2;
    cp_async16(ps->sten + (size_t)kk * ps->lane_stride + h * 4,
               sten + ((size_t)kk * n + i0) * kLane + h * 4);
  }
  for (int i = threadIdx.x; i < s; i += kThreads) {
    float px = 0.0f, py = 0.0f, valid = 0.0f;
    int ax = 0, ay = 0;
    if (i < cnt) {
      const float* q = pts + (size_t)(i0 + i) * kLane;
      px = q[0];
      py = q[1];
      ax = (int)q[2];
      ay = (int)q[3];
      valid = q[4];
    }
    ps->px[i] = px;
    ps->py[i] = py;
    ps->ax[i] = ax;
    ps->ay[i] = ay;
    ps->valid[i] = valid;
  }
  return ps->valid + s;
}

template <int kPPT>
__global__ void __launch_bounds__(kThreads)
rollout_local_kernel(const uint32_t* __restrict__ keys,   // [B, 2]
                     const float* __restrict__ guesses,   // [B, 3]
                     const float* __restrict__ devs,      // [B, 3]
                     const float* __restrict__ sten_all,  // [B, K2, N, 8]
                     const float* __restrict__ pts_all,   // [B, N, 8]
                     float* __restrict__ out,             // [B, 4]
                     Params prm) {
  // Particles per register tile of the evaluation: up to 4, 2 where the
  // particle state already fills the registers.
  constexpr int kT = kPPT >= 8 ? 2 : (kPPT < 4 ? kPPT : 4);
  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = prm.n_pts;
  const int p = prm.pop;
  const int k2 = (2 * prm.radius + 1) * (2 * prm.radius + 1);
  const int b = blockIdx.x / nranks;
  const int tid = threadIdx.x;
  const int g = prm.group;
  const int ng = kThreads / g;  // particles per sweep of the block
  const int gi = tid / g;
  const int li = tid - gi * g;
  const float* sten = sten_all + (size_t)b * k2 * n * kLane;
  const float* pts = pts_all + (size_t)b * n * kLane;
  const uint32_t k0 = keys[2 * b];
  const uint32_t k1 = keys[2 * b + 1];
  const float guess[3] = {guesses[3 * b], guesses[3 * b + 1], guesses[3 * b + 2]};
  const float dev[3] = {devs[3 * b], devs[3 * b + 1], devs[3 * b + 2]};
  const float zdev[3] = {prm.zdev0, prm.zdev1, prm.zdev2};
  const int s = (n + nranks - 1) / nranks;
  int i0, cnt;
  point_slice(n, nranks, rank, &i0, &cnt);

  // Shared memory: this CTA's PointSlice (its slice of the stencil table
  // and its point columns), then the partial scores [P + 1] its peers read
  // (slot p: the gbest seed in the init evaluation).  The table's copies
  // complete while the init draws run.
  extern __shared__ float4 smem4[];
  PointSlice ps;
  float* s_part = load_slice(&ps, reinterpret_cast<float*>(smem4), sten, pts, n, s, i0, cnt, prm);
  __shared__ ArgminScratch<kThreads> red;
  __shared__ float s_sum[kThreads / 32];
  __shared__ float s_cand[3];
  __shared__ float s_gbest[3];
  __shared__ float s_gcost;
  __shared__ int s_stale;

  // Particle j = q * ng + gi of this thread, q < kPPT (the g threads of a
  // group hold the same particle and make the same updates).
  float pos[kPPT][3], vel[kPPT][3], pb[kPPT][3], pbc[kPPT];

  // --- init: the population, and the gbest seed (evaluated in slot p).
#pragma unroll
  for (int q = 0; q < kPPT; ++q) {
    const int j = q * ng + gi;
    float u[3] = {0.0f, 0.0f, 0.0f};
    if (j < p) init_draw(prm.philox, k0, k1, j, p, u);
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
    init_draw(prm.philox, k0, k1, p, p, u);
#pragma unroll
    for (int k = 0; k < 3; ++k) g_pos[k] = guess[k] + (2.0f * u[k] - 1.0f) * zdev[k];
  }
  cp_async_wait_all();
  __syncthreads();

  // The cost of each of this thread's particles into cost (0 past the
  // population) and, with_seed, the seed's into *g_cost: this CTA's partials
  // into s_part, then the cluster's totals in rank order.  All threads of
  // all CTAs call it; it ends after a cluster barrier.
  auto evaluate = [&](float cost[kPPT], bool with_seed, float* g_cost) {
    // Points outside, a tile of kT of this thread's particles inside: each
    // point's columns are loaded once for kT independent chains, and each
    // particle's sum still runs over its points in order.
#pragma unroll
    for (int q0 = 0; q0 < kPPT; q0 += kT) {
      float tx[kT], ty[kT], c[kT], sn[kT], acc[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        sincosf(pos[q0 + t][2], &sn[t], &c[t]);
        tx[t] = pos[q0 + t][0];
        ty[t] = pos[q0 + t][1];
        acc[t] = 0.0f;
      }
      if (q0 * ng + gi < p) {  // the tile's first particle is live
        for (int i = li; i < cnt; i += g) {
          const float px = ps.px[i], py = ps.py[i];
          const int ax = ps.ax[i], ay = ps.ay[i];
          const bool valid = ps.valid[i] != 0.0f;
#pragma unroll
          for (int t = 0; t < kT; ++t)
            acc[t] += ps.score(i, px, py, ax, ay, valid, tx[t], ty[t], c[t], sn[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int j = (q0 + t) * ng + gi;
        float a = acc[t];
        for (int off = g >> 1; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
        if (li == 0 && j < p) s_part[j] = a;
      }
    }
    if (with_seed) {
      const float t = block_sum<kThreads>(ps.sum(tid, kThreads, g_pos[0], g_pos[1], g_pos[2]), s_sum);
      if (tid == 0) s_part[p] = t;
    }
    cluster.sync();
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      const int j = q * ng + gi;
      cost[q] = j < p ? -cluster_total(s_part, j, nranks) : 0.0f;
    }
    if (with_seed) *g_cost = -cluster_total(s_part, p, nranks);
    cluster.sync();
  };

  {
    float g_cost;
    evaluate(pbc, true, &g_cost);
    const float bc = select_particle<kThreads, kPPT>(pbc, pb, p, ng, gi, red, s_cand);
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
  bool stop = false;
  for (int it = 0; it < prm.iters && !stop; ++it) {
    const float gb[3] = {s_gbest[0], s_gbest[1], s_gbest[2]};
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      const int j = q * ng + gi;
      if (j >= p) continue;
      float r1[3], r2[3];
      step_draw(prm.philox, k0, k1, j, p, it, r1, r2);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float x = pos[q][k];
        const float v = w * vel[q][k] + prm.c1 * r1[k] * (pb[q][k] - x) +
                        prm.c2 * r2[k] * (gb[k] - x);
        vel[q][k] = v;
        pos[q][k] = x + v;
      }
    }
    float cost[kPPT];
    evaluate(cost, false, nullptr);
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
      if (q * ng + gi < p && cost[q] < pbc[q]) {
        pbc[q] = cost[q];
        pb[q][0] = pos[q][0];
        pb[q][1] = pos[q][1];
        pb[q][2] = pos[q][2];
      }
    }
    // The first-argmin personal best goes to s_cand.
    const float bc = select_particle<kThreads, kPPT>(pbc, pb, p, ng, gi, red, s_cand);
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

// The global route: the register kernel's solve with the particle state in
// this CTA's scratch slice [kState, P] (component k of particle j at
// k * P + j; j % 512 == tid is the thread that owns j) and the partials
// after it.  P > kMaxPPT * kThreads >= 512, so one thread per particle.
__global__ void __launch_bounds__(kThreads)
rollout_local_global_kernel(const uint32_t* __restrict__ keys,   // [B, 2]
                            const float* __restrict__ guesses,   // [B, 3]
                            const float* __restrict__ devs,      // [B, 3]
                            const float* __restrict__ sten_all,  // [B, K2, N, 8]
                            const float* __restrict__ pts_all,   // [B, N, 8]
                            float* __restrict__ out,             // [B, 4]
                            float* __restrict__ scratch,         // [B * C, slice_floats(P)]
                            Params prm) {
  constexpr int kT = 4;  // particles per register tile of the evaluation
  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = prm.n_pts;
  const int p = prm.pop;
  const int k2 = (2 * prm.radius + 1) * (2 * prm.radius + 1);
  const int b = blockIdx.x / nranks;
  const int tid = threadIdx.x;
  const float* sten = sten_all + (size_t)b * k2 * n * kLane;
  const float* pts = pts_all + (size_t)b * n * kLane;
  const uint32_t k0 = keys[2 * b];
  const uint32_t k1 = keys[2 * b + 1];
  const float guess[3] = {guesses[3 * b], guesses[3 * b + 1], guesses[3 * b + 2]};
  const float dev[3] = {devs[3 * b], devs[3 * b + 1], devs[3 * b + 2]};
  const float zdev[3] = {prm.zdev0, prm.zdev1, prm.zdev2};
  const int s = (n + nranks - 1) / nranks;
  int i0, cnt;
  point_slice(n, nranks, rank, &i0, &cnt);

  extern __shared__ float4 smem4[];
  PointSlice ps;
  load_slice(&ps, reinterpret_cast<float*>(smem4), sten, pts, n, s, i0, cnt, prm);
  float* g_pos = scratch + (size_t)blockIdx.x * slice_floats(p);
  float* g_vel = g_pos + 3 * (size_t)p;
  float* g_pb = g_vel + 3 * (size_t)p;
  float* g_pbc = g_pb + 3 * (size_t)p;
  float* g_part = g_pbc + p;
  const float* part_rank0 = g_part - (size_t)rank * slice_floats(p);
  __shared__ ArgminScratch<kThreads> red;
  __shared__ float s_sum[kThreads / 32];
  __shared__ float s_gbest[3];
  __shared__ float s_gcost;
  __shared__ int s_stale;

  // --- init: the population, and the gbest seed (evaluated in slot p).
  for (int j = tid; j < p; j += kThreads) {
    float u[3];
    init_draw(prm.philox, k0, k1, j, p, u);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float x = guess[k] + (2.0f * u[k] - 1.0f) * dev[k];
      g_pos[k * p + j] = x;
      g_vel[k * p + j] = 0.0f;
      g_pb[k * p + j] = x;
    }
  }
  float seed[3];
  {
    float u[3];
    init_draw(prm.philox, k0, k1, p, p, u);
#pragma unroll
    for (int k = 0; k < 3; ++k) seed[k] = guess[k] + (2.0f * u[k] - 1.0f) * zdev[k];
  }
  cp_async_wait_all();
  __syncthreads();

  // Each particle's cost handed to on_cost(j, cost) by the thread that owns
  // j; with_seed, the seed's cost returned (0 otherwise).  All threads of
  // all CTAs call it; it ends after a cluster barrier.
  auto evaluate = [&](bool with_seed, auto on_cost) -> float {
    for (int q0 = 0; q0 * kThreads < p; q0 += kT) {
      float tx[kT], ty[kT], c[kT], sn[kT], acc[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int j = (q0 + t) * kThreads + tid;
        const bool live = j < p;
        sincosf(live ? g_pos[2 * p + j] : 0.0f, &sn[t], &c[t]);
        tx[t] = live ? g_pos[j] : 0.0f;
        ty[t] = live ? g_pos[p + j] : 0.0f;
        acc[t] = 0.0f;
      }
      if (q0 * kThreads + tid < p) {  // the tile's first particle is live
        for (int i = 0; i < cnt; ++i) {
          const float px = ps.px[i], py = ps.py[i];
          const int ax = ps.ax[i], ay = ps.ay[i];
          const bool valid = ps.valid[i] != 0.0f;
#pragma unroll
          for (int t = 0; t < kT; ++t)
            acc[t] += ps.score(i, px, py, ax, ay, valid, tx[t], ty[t], c[t], sn[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int j = (q0 + t) * kThreads + tid;
        if (j < p) g_part[j] = acc[t];
      }
    }
    if (with_seed) {
      const float t = block_sum<kThreads>(ps.sum(tid, kThreads, seed[0], seed[1], seed[2]), s_sum);
      if (tid == 0) g_part[p] = t;
    }
    cluster.sync();
    for (int j = tid; j < p; j += kThreads)
      on_cost(j, -cluster_total_global(part_rank0, slice_floats(p), j, nranks));
    const float g_cost =
        with_seed ? -cluster_total_global(part_rank0, slice_floats(p), p, nranks) : 0.0f;
    cluster.sync();
    return g_cost;
  };

  {
    const float g_cost = evaluate(true, [&](int j, float cst) { g_pbc[j] = cst; });
    float bc;
    int bi;
    block_argmin<kThreads>(g_pbc, p, &bc, &bi, red);
    if (tid == 0) {
      const bool imp = bc < g_cost;
      for (int k = 0; k < 3; ++k) s_gbest[k] = imp ? g_pb[k * p + bi] : seed[k];
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
      step_draw(prm.philox, k0, k1, j, p, it, r1, r2);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float x = g_pos[k * p + j];
        const float v = w * g_vel[k * p + j] + prm.c1 * r1[k] * (g_pb[k * p + j] - x) +
                        prm.c2 * r2[k] * (gb[k] - x);
        g_vel[k * p + j] = v;
        g_pos[k * p + j] = x + v;
      }
    }
    evaluate(false, [&](int j, float cst) {
      if (cst < g_pbc[j]) {
        g_pbc[j] = cst;
        g_pb[j] = g_pos[j];
        g_pb[p + j] = g_pos[p + j];
        g_pb[2 * p + j] = g_pos[2 * p + j];
      }
    });
    // The first-argmin personal best.
    float bc;
    int bi;
    block_argmin<kThreads>(g_pbc, p, &bc, &bi, red);
    if (tid == 0) {
      if (bc < s_gcost) {
        for (int k = 0; k < 3; ++k) s_gbest[k] = g_pb[k * p + bi];
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
  cluster.sync();  // no CTA leaves while a peer may still read its memory
  if (rank == 0 && tid == 0) {
    out[4 * b] = s_gbest[0];
    out[4 * b + 1] = s_gbest[1];
    out[4 * b + 2] = s_gbest[2];
    out[4 * b + 3] = s_gcost;
  }
}

// Dynamic shared memory of one CTA: its PointSlice, and on the register
// route the partials.
size_t smem_bytes(int n, int p, int cluster, int radius, bool global) {
  const size_t s = (size_t)((n + cluster - 1) / cluster);
  const size_t k2 = (size_t)(2 * radius + 1) * (2 * radius + 1);
  return sizeof(float) * ((k2 * kLane + 5) * s + k2 * kLanePad + (global ? 0 : (size_t)p + 1));
}

bool global_route(int population) { return population > kMaxPPT * kThreads; }

template <int kPPT>
int launch(const Params& prm, int batch, int cluster, size_t smem, cudaStream_t stream,
           const void* keys, const void* guesses, const void* devs, const void* sten,
           const void* pts, void* out) {
  return launch_cluster(rollout_local_kernel<kPPT>, batch * cluster, kThreads, cluster, smem,
                        stream, static_cast<const uint32_t*>(keys),
                        static_cast<const float*>(guesses), static_cast<const float*>(devs),
                        static_cast<const float*>(sten), static_cast<const float*>(pts),
                        static_cast<float*>(out), prm);
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA of a cluster of `cluster` needs at this
// population's route; the wrapper checks it against the device limit.
size_t ndt_rollout_local_smem_bytes(int n_pts, int population, int cluster, int radius) {
  return smem_bytes(n_pts, population, cluster, radius, global_route(population));
}

// Floats of one CTA's slice of the global route's scratch.
size_t ndt_rollout_local_slice_floats(int population) { return slice_floats(population); }

// The most clusters of `cluster` CTAs the device holds at once for the
// shape, into *out (every register-route instantiation has 512 threads at
// <= 128 registers, so one stands for all).  Returns the CUDA error, or 0.
int ndt_rollout_local_max_active_clusters(int n_pts, int population, int cluster, int radius,
                                          int* out) {
  const size_t smem = ndt_rollout_local_smem_bytes(n_pts, population, cluster, radius);
  if (global_route(population))
    return max_active_clusters(rollout_local_global_kernel, kThreads, cluster, smem, out);
  return max_active_clusters(rollout_local_kernel<8>, kThreads, cluster, smem, out);
}

// The route threshold: the most particles the register route takes (16
// per thread); larger populations keep their state in global scratch.
int ndt_rollout_local_max_population() { return kMaxPPT * kThreads; }

// Launches B solves on `stream`, one cluster of `cluster` CTAs each; above
// the register route's population, scratch holds [B * cluster,
// slice_floats(population)] floats.  Returns cudaGetLastError() after the
// launch.
int ndt_rollout_local(const void* keys, const void* guesses, const void* devs,
                      const void* sten, const void* pts, void* out, void* scratch, int batch,
                      int n_pts, int population, int iterations, int radius,
                      int early_exit, int philox, int exp2_mode, int cluster, float half,
                      float cell_side, float w, float c1, float c2, float w_damping,
                      float zdev0, float zdev1, float zdev2, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 || n_pts < 1 ||
      population < 1 || batch < 1 || (global_route(population) && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  int group = 1;  // the largest power of two <= min(32, 512 / P)
  while (group < 32 && 2 * group * population <= kThreads) group *= 2;
  int e;
  const float inv_cell = frexpf(cell_side, &e) == 0.5f ? 1.0f / cell_side : 0.0f;
  const Params prm{n_pts, population, iterations, radius, early_exit, philox, exp2_mode, group,
                   half, cell_side, inv_cell, w, c1, c2, w_damping, zdev0, zdev1, zdev2};
  const size_t smem = ndt_rollout_local_smem_bytes(n_pts, population, cluster, radius);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (global_route(population))
    return launch_cluster(rollout_local_global_kernel, batch * cluster, kThreads, cluster, smem, s,
                          static_cast<const uint32_t*>(keys), static_cast<const float*>(guesses),
                          static_cast<const float*>(devs), static_cast<const float*>(sten),
                          static_cast<const float*>(pts), static_cast<float*>(out),
                          static_cast<float*>(scratch), prm);
  const int per_thread = (population + kThreads / group - 1) / (kThreads / group);
  using Launch = int (*)(const Params&, int, int, size_t, cudaStream_t, const void*, const void*,
                         const void*, const void*, const void*, void*);
  Launch go = launch<16>;
  if (per_thread <= 1) go = launch<1>;
  else if (per_thread <= 2) go = launch<2>;
  else if (per_thread <= 4) go = launch<4>;
  else if (per_thread <= 8) go = launch<8>;
  return go(prm, batch, cluster, smem, s, keys, guesses, devs, sten, pts, out);
}

}  // extern "C"
