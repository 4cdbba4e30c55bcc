// In-place row scatter-set: ops[f][idx[i], :] = vals[f][i, :] for every
// field f < n_fields (1-3), rows of W floats, ids outside [0, rows) dropped.
//
// Replaces experiments/scatter_unique_ab.py:_rowdma_kernel, the aliased
// row-DMA scatter into the flat fleet fields (there the caller maps dropped
// ids to a junk row R of an [R + 1, W] operand; so does the study here).
// The TPU kernel could only move 128-float rows: Mosaic rejects narrower
// slices.  Here a row is any width: W = 2 over the fleet's 2.88 M rows is
// the real shape.
//
// Duplicate ids.  Several rows aimed at one target must not mix: a target
// row ends equal to one of them, whole.  So the rows first claim their
// target in an open-addressing hash table of (int32 id, int32 winner)
// slots, both -1 when empty (so rows <= INT_MAX, and no id in range meets
// the empty key): linear probing from mix32(id), a CAS of the key, then
// atomicMax of the row index, so the largest index wins.  Then every
// occupied slot writes its winner's row to its target, once.  Which
// duplicate wins is no promise of the interface (the TPU kernel and the
// library calls promise none); the plain version in ops/row_scatter.py
// picks the same one, so the two can be held bit-equal.
//
// What bounds it on an H100: not bytes (12,288 ids and ~1,760 winning
// rows of 8 B move in well under a microsecond) but latency: the table's
// clear, the claims' atomics and one scattered read and write per target,
// each phase waiting for the one before.  One cooperative launch
// (cudaLaunchKernelEx with the cooperative attribute) of a grid of 256-thread
// blocks, at most as many as the card holds at once, does all three, with a
// grid barrier between them:
//
//   clear: the table of S = 2^k >= 2 M slots (a tensor the wrapper keeps
//          per device and stream), to -1
//          (each thread has loaded its first id before, so the load is in
//          flight across the clear and the barrier);
//   claim: each id claims its slot with L2 atomics, spread over the card;
//   write: each occupied slot writes its winner's row, with the lanes
//          matched to the width: for W <= 4 one thread per slot, its row as
//          one vector where the rows are aligned; wider rows one warp per
//          occupied slot (found by a ballot over 32 slots), its lanes over
//          the row's float4s (W = 128: one row per warp instruction).
//
// No memset, no second launch, no size limit (the loops stride the grid).
// Two designs that kept the table in shared memory lost to this one on the
// card (PERF.md, E4): one spread over a thread-block cluster and claimed
// through distributed shared memory, one cut into a part per block; the
// shared-memory atomics of an SM are served one after another, while L2
// atomics spread over the whole card.

#include <climits>

#include "pso_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kEmpty = -1;
constexpr int kThreads = 256;
constexpr int kNarrow = 4;  // widths written one thread per row

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

struct Fields {
  float* op[3];
  const float* vals[3];
};

// Row i claims target `key` (slots: a power of two, mask its size - 1): the
// first slot on its probe path from mix32(key) that is empty or holds key,
// then the largest row index there.
__device__ __forceinline__ void claim(int2* slots, uint32_t mask, int key, int i) {
  uint32_t h = mix32((uint32_t)key) & mask;
  int* k;
  while (true) {
    k = &slots[h].x;
    const int prev = atomicCAS(k, kEmpty, key);
    if (prev == kEmpty || prev == key) break;
    h = (h + 1) & mask;
  }
  atomicMax(k + 1, i);
}

template <int kVec> struct VecOf;
template <> struct VecOf<1> { using T = float; };
template <> struct VecOf<2> { using T = float2; };
template <> struct VecOf<4> { using T = float4; };

// Writes the winning row of every occupied slot of slots[0, count) to its
// target, in kVec-float vectors (width % kVec == 0, rows aligned to them):
// thread `t` of `nthreads` (a multiple of 32) takes slots t, t + nthreads,
// ...  The slots are read from L2 (ld.global.cg), where the other blocks'
// claims landed, never from a stale L1 line of the clear.
template <int kVec, bool kWarpRow>
__device__ __forceinline__ void write_slots(const int2* slots, int count, int width,
                                            const Fields& fl, int n_fields, int t, int nthreads) {
  using V = typename VecOf<kVec>::T;
  const int nv = width / kVec;
  if (!kWarpRow) {  // width <= kNarrow: every field loaded before any is stored
    for (int s = t; s < count; s += nthreads) {
      const int2 e = __ldcg(slots + s);
      if (e.x == kEmpty) continue;
      V row[3][kNarrow / kVec];
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const V* src = reinterpret_cast<const V*>(fl.vals[f] + (size_t)e.y * width);
#pragma unroll
        for (int c = 0; c < kNarrow / kVec; ++c)
          if (f < n_fields && c < nv) row[f][c] = __ldg(src + c);
      }
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        V* dst = reinterpret_cast<V*>(fl.op[f] + (size_t)e.x * width);
#pragma unroll
        for (int c = 0; c < kNarrow / kVec; ++c)
          if (f < n_fields && c < nv) dst[c] = row[f][c];
      }
    }
    return;
  }
  const int lane = t & 31;
  for (int base = t & ~31; base < count; base += nthreads) {
    const int2 e = base + lane < count ? __ldcg(slots + base + lane) : make_int2(kEmpty, kEmpty);
    unsigned live = __ballot_sync(0xffffffffu, e.x != kEmpty);
    while (live) {
      const int j = __ffs(live) - 1;
      live &= live - 1;
      const int target = __shfl_sync(0xffffffffu, e.x, j);
      const int winner = __shfl_sync(0xffffffffu, e.y, j);
      for (int f = 0; f < n_fields; ++f) {
        const V* src = reinterpret_cast<const V*>(fl.vals[f] + (size_t)winner * width);
        V* dst = reinterpret_cast<V*>(fl.op[f] + (size_t)target * width);
        for (int c = lane; c < nv; c += 32) dst[c] = __ldg(src + c);
      }
    }
  }
}

template <int kVec, bool kWarpRow>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const long long* __restrict__ idx, int m, long long rows, int width, Fields fl,
               int n_fields, int2* slots, uint32_t slot_mask) {
  cg::grid_group grid = cg::this_grid();
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  const int n_slots = (int)slot_mask + 1;
  const long long first = t < m ? idx[t] : -1;  // in flight across the clear and the barrier
  for (int s = t; s < n_slots; s += nthreads) slots[s] = make_int2(kEmpty, kEmpty);
  grid.sync();
  for (int i = t; i < m; i += nthreads) {
    const long long id = i == t ? first : idx[i];
    if (id >= 0 && id < rows) claim(slots, slot_mask, (int)id, i);
  }
  grid.sync();
  write_slots<kVec, kWarpRow>(slots, n_slots, width, fl, n_fields, t, nthreads);
}

using Kernel = void (*)(const long long*, int, long long, int, Fields, int, int2*, uint32_t);

// By [width > kNarrow][log2 kVec].
const Kernel kKernels[2][3] = {
    {scatter_kernel<1, false>, scatter_kernel<2, false>, scatter_kernel<4, false>},
    {scatter_kernel<1, true>, scatter_kernel<2, true>, scatter_kernel<4, true>}};

// log2 of the widest vector (1, 2 or 4 floats) that divides the width and
// whose alignment every operand and vals pointer has.
int vec_log2(int width, const Fields& fl, int n_fields) {
  uintptr_t bits = 0;
  for (int f = 0; f < n_fields; ++f)
    bits |= reinterpret_cast<uintptr_t>(fl.op[f]) | reinterpret_cast<uintptr_t>(fl.vals[f]);
  if (width % 4 == 0 && (bits & 15) == 0) return 2;
  if (width % 2 == 0 && (bits & 7) == 0) return 1;
  return 0;
}

// The most blocks of kernel the current device holds at once (a cooperative
// launch may have no more), asked once per (device, kernel).
cudaError_t coresident_blocks(const void* kernel, int* out) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, int> held;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = held.find({device, kernel});
  if (it != held.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *out = held[{device, kernel}] = per_sm * sms;
  return cudaSuccess;
}

int scatter(const long long* ids, int m, long long rows, int width, const Fields& fl,
            int n_fields, int2* slots, int n_slots, int blocks, cudaStream_t st) {
  const Kernel k = kKernels[width > kNarrow][vec_log2(width, fl, n_fields)];
  int held = 0;
  cudaError_t err = coresident_blocks((const void*)k, &held);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks < held ? blocks : held, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k, ids, m, rows, width, fl, n_fields, slots,
                           (uint32_t)n_slots - 1u);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scatters m rows into n_fields operands of `rows` (<= INT_MAX) x `width`
// floats on `stream` of CUDA device `device`, in one cooperative launch of
// `blocks` blocks, or of as many as the device holds at once if that is
// fewer.  slots: at least 2 * n_slots int32 for the table, which the kernel
// clears, n_slots a power of two >= 2 m.  Returns the first CUDA error, or 0; a refused launch is
// returned, never retried.
int ndt_row_scatter(const void* idx, int m, long long rows, int width, void* op0, void* op1,
                    void* op2, const void* vals0, const void* vals1, const void* vals2,
                    int n_fields, void* slots, int n_slots, int blocks, int device,
                    void* stream) {
  if (n_fields < 1 || n_fields > 3 || width < 1 || rows > INT_MAX || m < 0 ||
      n_slots < 2LL * m || n_slots < 1 || (n_slots & (n_slots - 1)) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  Fields fl;
  void* ops[3] = {op0, op1, op2};
  const void* vals[3] = {vals0, vals1, vals2};
  for (int f = 0; f < 3; ++f) {
    fl.op[f] = static_cast<float*>(ops[f]);
    fl.vals[f] = static_cast<const float*>(vals[f]);
  }
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int ret = scatter(static_cast<const long long*>(idx), m, rows, width, fl, n_fields,
                          static_cast<int2*>(slots), n_slots, blocks,
                          static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return ret;
}

}  // extern "C"
