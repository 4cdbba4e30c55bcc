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
// row ends equal to one of them, whole.  Warps writing one row at the same
// time could interleave their stores, so the rows first claim their target
// in an open-addressing hash table in scratch memory (2^k >= 2 M slots of
// (int32 id, winner), reset by the launch; so rows <= INT_MAX, and no id
// in range meets the empty key -1): claim_kernel takes the largest row
// index per id with atomicMax; write_kernel lets only that row write, one
// warp per row, its lanes over the columns.  Which duplicate wins is no
// promise of the interface (the TPU kernel and the library calls promise
// none); the plain version in ops/row_scatter.py picks the same one, so
// the two can be held bit-equal.
//
// What bounds it on an H100: bytes, M ids and M * W * n_fields floats read
// and as many written, at random rows, so the latency of scattered
// accesses.  This first version aims at right, not fast (two launches and
// a memset; W = 2 leaves 30 lanes of each warp idle).

#include <climits>

#include "pso_common.cuh"

namespace {

constexpr int kEmpty = -1;
constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
claim_kernel(const long long* __restrict__ idx, int m, long long rows, int* keys, int* winner,
             uint32_t slot_mask) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const long long t = idx[i];
  if (t < 0 || t >= rows) return;
  const int key = (int)t;
  uint32_t h = mix32((uint32_t)key) & slot_mask;
  while (true) {
    const int prev = atomicCAS(&keys[h], kEmpty, key);
    if (prev == kEmpty || prev == key) {
      atomicMax(&winner[h], i);
      return;
    }
    h = (h + 1) & slot_mask;
  }
}

__global__ void __launch_bounds__(kThreads)
write_kernel(const long long* __restrict__ idx, int m, long long rows, int width,
             const int* __restrict__ keys, const int* __restrict__ winner, uint32_t slot_mask,
             Fields fl, int n_fields) {
  const int i = (int)(((long long)blockIdx.x * kThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= m) return;
  const long long t = idx[i];
  if (t < 0 || t >= rows) return;
  const int key = (int)t;
  uint32_t h = mix32((uint32_t)key) & slot_mask;
  while (keys[h] != key) h = (h + 1) & slot_mask;
  if (winner[h] != i) return;
  for (int f = 0; f < n_fields; ++f) {
    float* dst = fl.op[f] + (size_t)t * width;
    const float* src = fl.vals[f] + (size_t)i * width;
    for (int c = lane; c < width; c += 32) dst[c] = src[c];
  }
}

}  // namespace

extern "C" {

// Scatters m rows into n_fields operands of `rows` (<= INT_MAX) x `width`
// floats on `stream`.  table: 2 * slots int32 of scratch, slots a power of two >= 2 m.
// Returns cudaGetLastError().
int ndt_row_scatter(const void* idx, int m, long long rows, int width, void* op0, void* op1,
                    void* op2, const void* vals0, const void* vals1, const void* vals2,
                    int n_fields, void* table, int slots, void* stream) {
  if (n_fields < 1 || n_fields > 3 || width < 1 || rows > INT_MAX || slots < 2 * m ||
      (slots & (slots - 1)))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* keys = static_cast<int*>(table);
  int* winner = keys + slots;
  cudaError_t err = cudaMemsetAsync(table, 0xFF, sizeof(int) * 2 * (size_t)slots, st);  // -1
  if (err != cudaSuccess) return (int)err;
  const long long* ids = static_cast<const long long*>(idx);
  const uint32_t slot_mask = (uint32_t)slots - 1u;
  claim_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0, st>>>(ids, m, rows, keys, winner,
                                                                   slot_mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Fields fl;
  void* ops[3] = {op0, op1, op2};
  const void* vals[3] = {vals0, vals1, vals2};
  for (int f = 0; f < 3; ++f) {
    fl.op[f] = static_cast<float*>(ops[f]);
    fl.vals[f] = static_cast<const float*>(vals[f]);
  }
  const long long threads = 32LL * m;
  write_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      ids, m, rows, width, keys, winner, slot_mask, fl, n_fields);
  return (int)cudaGetLastError();
}

}  // extern "C"
