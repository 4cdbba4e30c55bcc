// The single-op probes of the TPU bring-up, one kernel per probe.
//
// Replaces experiments/io_probe.py (k_min, k_smem, k_sten3, k_sten4: the
// four input-layout probes of the rollout kernel) and
// experiments/mosaic_probe.py (k_col3, k_bool11, k_slice11, k_fori_small,
// k_threefry, k_dotgen, k_bcast_out: the single-op probes that bisected a
// Mosaic crash).  On the TPU each answered whether an op compiled; here each
// computes the same function, so it can be held against its plain PyTorch
// version (ops/probes.py) and timed.
//
// io_kernel_warp<probe> (k_min, k_smem): one warp per (solve b, row r) of
// the output [B, 8, 128], several rows per block, no shared memory and no
// barrier.  The warp sums its row of N points (warp_row_sum: float4 loads,
// all of a lane's loads in flight before it adds, then a butterfly) and
// writes the sum to the row's 128 lanes, one float4 per lane.  k_smem adds
// f32(int32(k0 >> 8)), exact in float32, with k0 the low u32 word of
// keys[b, 0] read in the caller's dtype (int64, int32 or uint32: a stride
// in words), so a call is one launch and no other device operation.
// What bounds it: bytes (3.1 MB at B = 256, N = 384), in practice the
// launch and one row's load latency.
//
// io_kernel<probe> (k_sten3, k_sten4): one block per (solve b, row r); the
// block adds the 25 stencil offsets of each point in order k = 0..24, as
// the TPU kernel's loop does, then sums the points.  What bounds it: bytes.
// The [B, 25, 8, N] stencil table (78.6 MB at B = 256, N = 384) is read
// once; each warp reads 32 neighbouring points of one (k, r) row, 25
// independent loads in flight per point.
//
// mosaic_kernel_dotgen (k_dotgen): a grid of 512-thread blocks over the
// columns.  Its function, the column totals sum_n z[n, q] of z[n, q] =
// sum_r x[r, n] x[r, q], is computed summed over n first, sum_r (sum_n
// x[r, n]) x[r, q]: 8 n + 16 P operations where the contraction as written
// takes 16 n P, and no serial chain over n.  Each block's warp r sums row r.
// mosaic_kernel_bcast_out (k_bcast_out) and mosaic_kernel_<probe> (k_col3,
// k_bool11, k_slice11, k_fori_small, k_threefry): a grid of single warps,
// 8 rows x ceil(P / 128) column chunks, the row from blockIdx.y, so no
// divide, no shared memory and no barrier.  Each lane loads its four
// elements of the chunk (one float4 where P % 4 == 0 and the tile is 16-byte
// aligned, else four scalars) before anything else, so their load overlaps
// the warp's own reductions, and stores four results (a float4 where P % 4
// == 0).  bcast_out and fori_small sum whole rows (warp_row_sum; fori_small
// its row and row 0, their loads in flight together), bool11 takes row 0's
// minimum the same way, slice11 reads x[0, 0]; a row is read by each of its
// ceil(P / 128) warps, from L2 after the first.  k_threefry reads its u32
// counters in the caller's dtype at a word stride (2 for int64: the low
// word; 1 for int32 / uint32), so a call is one launch and no other device
// operation.
// What bounds them: a launch; the tile is 16 KB.
//
// Numerics: --fmad=false and no fast math, so every + - * rounds as in
// the plain versions; the sums are taken in another order (a lane's terms
// in order, then a butterfly over the lanes; io_kernel then adds the warps
// in order).  The minimum propagates a NaN, as jnp.min does.

#include "pso_common.cuh"

namespace {

using namespace ndt;

enum IoProbe { kMin = 0, kSmem = 1, kSten3 = 2, kSten4 = 3 };
enum MosaicProbe {
  kCol3 = 0,
  kBool11 = 1,
  kSlice11 = 2,
  kForiSmall = 3,
  kThreefry = 4,
  kDotgen = 5,
  kBcastOut = 6
};

constexpr int kIoThreads = 128;
constexpr int kLanes = 128;  // the TPU output tile's lane width
constexpr int kK2 = 25;      // stencil offsets (radius 2)
constexpr int kRows = 8;
constexpr int kMosaicThreads = 512;  // mosaic_kernel_dotgen: threads per block
constexpr int kMaxDotN = 1024;  // the longest contraction k_dotgen takes
constexpr int kIoWarps = 4;     // io_kernel_warp: rows per block
constexpr int kChunkCols = 128; // the single-warp mosaic kernels: columns per warp
constexpr int kInFlight = 4;    // warp_rows_reduce: loads per lane and row before it adds
static_assert(kLanes == 32 * 4, "io_kernel_warp writes a row as one float4 per lane");
static_assert(kChunkCols == 32 * 4, "a chunk is one float4, or four scalars, per lane");

// The reductions a warp takes of whole rows: the sum, and the
// NaN-propagating minimum (PTX min.NaN; the minimum does not depend on the
// order but for the sign of a zero, so a float4's components go as a tree).
struct RowSum {
  static __device__ __forceinline__ float init() { return 0.0f; }
  static __device__ __forceinline__ float add(float s, float q) { return s + q; }
  static __device__ __forceinline__ float add4(float s, float4 q) {
    return s + q.x + q.y + q.z + q.w;
  }
};
struct RowMinNan {
  static __device__ __forceinline__ float init() { return INFINITY; }
  static __device__ __forceinline__ float add(float m, float q) { return min_nan(m, q); }
  static __device__ __forceinline__ float add4(float m, float4 q) {
    return min_nan(m, min_nan(min_nan(q.x, q.y), min_nan(q.z, q.w)));
  }
};

// Op over each of kN rows of n floats by one warp, the same bits in every
// lane: lane l takes, in order, the elements l, l + 32, l + 64, ... (kVec:
// the float4s l, l + 32, ..., each one's four components in order; the
// rows 16-byte aligned and n % 4 == 0), issuing kInFlight loads of every
// row before it adds them; then a butterfly over the lanes.
template <bool kVec, typename Op, int kN>
__device__ __forceinline__ void warp_rows_reduce(const float* const (&rows)[kN], int n, int lane,
                                                 float (&s)[kN]) {
#pragma unroll
  for (int k = 0; k < kN; ++k) s[k] = Op::init();
  if (kVec) {
    const int n4 = n >> 2;
    for (int base = lane; base < n4; base += 32 * kInFlight) {
      float4 q[kN][kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (base + 32 * j < n4) {
#pragma unroll
          for (int k = 0; k < kN; ++k)
            q[k][j] = __ldg(reinterpret_cast<const float4*>(rows[k]) + base + 32 * j);
        }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (base + 32 * j < n4) {
#pragma unroll
          for (int k = 0; k < kN; ++k) s[k] = Op::add4(s[k], q[k][j]);
        }
    }
  } else {
    for (int base = lane; base < n; base += 32 * kInFlight) {
      float q[kN][kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (base + 32 * j < n) {
#pragma unroll
          for (int k = 0; k < kN; ++k) q[k][j] = __ldg(rows[k] + base + 32 * j);
        }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (base + 32 * j < n) {
#pragma unroll
          for (int k = 0; k < kN; ++k) s[k] = Op::add(s[k], q[k][j]);
        }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kN; ++k) s[k] = Op::add(s[k], __shfl_xor_sync(0xffffffffu, s[k], off));
  }
}

// The sum of a row's n floats by one warp (warp_rows_reduce's order).
template <bool kVec>
__device__ __forceinline__ float warp_row_sum(const float* __restrict__ row, int n, int lane) {
  const float* rows[1] = {row};
  float s[1];
  warp_rows_reduce<kVec, RowSum, 1>(rows, n, lane, s);
  return s[0];
}

// k_min and k_smem over n_rows = 8 B rows of pts [B, 8, N]: warp w of
// block i owns row i * kIoWarps + w.  keys: the u32 word of keys[b, 0] at
// keys[b * key_stride] (k_smem only).
template <int kProbe, bool kVec>
__global__ void __launch_bounds__(kIoWarps * 32)
io_kernel_warp(const float* __restrict__ pts, const uint32_t* __restrict__ keys,
               long long key_stride, float* __restrict__ out, int n_rows, int n) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kIoWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  float sum = warp_row_sum<kVec>(pts + (size_t)row * n, n, lane);
  if (kProbe == kSmem) sum = sum + (float)(int32_t)(__ldg(keys + (row / kRows) * key_stride) >> 8);
  reinterpret_cast<float4*>(out + (size_t)row * kLanes)[lane] = make_float4(sum, sum, sum, sum);
}

template <int kProbe>
__global__ void __launch_bounds__(kIoThreads)
io_kernel(const float* __restrict__ src, float* __restrict__ out, int n) {
  const int b = blockIdx.y;
  const int r = blockIdx.x;
  __shared__ float s_sum[kIoThreads / 32];
  float part = 0.0f;
  for (int i = threadIdx.x; i < n; i += kIoThreads) {
    // [B, 25, 8, N] and its [B, 200, N] view: the same addresses, indexed
    // as each TPU probe indexes them.
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kK2; ++k) {
      const size_t row = kProbe == kSten4 ? ((size_t)b * kK2 + k) * kRows + r
                                          : (size_t)b * kK2 * kRows + kRows * k + r;
      acc = acc + src[row * n + i];
    }
    part += acc;
  }
  const float sum = block_sum<kIoThreads>(part, s_sum);
  float* o = out + ((size_t)b * kRows + r) * kLanes;
  for (int l = threadIdx.x; l < kLanes; l += kIoThreads) o[l] = sum;
}

// Column j = 0..3 of this lane's part of block (c, r)'s chunk, columns
// [128 c, 128 c + 128) of row r: kVec the float4 at 128 c + 4 lane, else the
// columns 128 c + lane + 32 j.
template <bool kVec>
__device__ __forceinline__ int chunk_col(int j) {
  const int lane = threadIdx.x;
  return blockIdx.x * kChunkCols + (kVec ? 4 * lane + j : lane + 32 * j);
}

// This lane's part of the chunk of the [8, P] tile x (columns past P: 0).
template <bool kVec>
__device__ __forceinline__ void load_chunk(const float* __restrict__ x, int p, float (&v)[4]) {
  const float* row = x + (size_t)blockIdx.y * p;
  if (kVec) {
    const int c = chunk_col<true>(0);
    const float4 q = c < p ? __ldg(reinterpret_cast<const float4*>(row + c)) : make_float4(0, 0, 0, 0);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = chunk_col<false>(j);
      v[j] = c < p ? __ldg(row + c) : 0.0f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_chunk(float* __restrict__ out, int p, const float (&v)[4]) {
  float* row = out + (size_t)blockIdx.y * p;
  if (kVec) {
    const int c = chunk_col<true>(0);
    if (c < p) *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = chunk_col<false>(j);
      if (c < p) row[c] = v[j];
    }
  }
}

// k_col3: x + c[r], c = (1, 2, 3, 3, ...).
template <bool kVec>
__global__ void __launch_bounds__(32)
mosaic_kernel_col3(const float* __restrict__ x, float* __restrict__ out, int p) {
  float v[4];
  load_chunk<kVec>(x, p, v);
  const float c = blockIdx.y == 0 ? 1.0f : (blockIdx.y == 1 ? 2.0f : 3.0f);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = v[j] + c;
  store_chunk<kVec>(out, p, v);
}

// k_bool11: x + v, bc row 0's minimum and v = bc if bc < 0.5 else bc + 1.
template <bool kVec>
__global__ void __launch_bounds__(32)
mosaic_kernel_bool11(const float* __restrict__ x, float* __restrict__ out, int p) {
  float v[4];
  load_chunk<kVec>(x, p, v);
  const float* row0[1] = {x};
  float bc[1];
  warp_rows_reduce<kVec, RowMinNan, 1>(row0, p, threadIdx.x, bc);
  const float add = bc[0] < 0.5f ? bc[0] : bc[0] + 1.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = v[j] + add;
  store_chunk<kVec>(out, p, v);
}

// k_slice11: x * (cos(x[0, 0]) + 1), the same cosf in every lane.
template <bool kVec>
__global__ void __launch_bounds__(32)
mosaic_kernel_slice11(const float* __restrict__ x, float* __restrict__ out, int p) {
  float v[4];
  load_chunk<kVec>(x, p, v);
  const float f = cosf(__ldg(x)) + 1.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = v[j] * f;
  store_chunk<kVec>(out, p, v);
}

// k_fori_small: x + a + b + w after fori_loop(0, 5) of (a + 1, b * 1.01,
// w * 0.99) from (row r's sum, row 0's sum, 1), each step rounded.
template <bool kVec>
__global__ void __launch_bounds__(32)
mosaic_kernel_fori_small(const float* __restrict__ x, float* __restrict__ out, int p) {
  float v[4];
  load_chunk<kVec>(x, p, v);
  const float* rows[2] = {x + (size_t)blockIdx.y * p, x};  // row r and row 0, loads in flight together
  float sums[2];
  warp_rows_reduce<kVec, RowSum, 2>(rows, p, threadIdx.x, sums);
  float a = sums[0], b = sums[1];
  float w = 1.0f;
  for (int i = 0; i < 5; ++i) {
    a = a + 1.0f;
    b = b * 1.01f;
    w = w * 0.99f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = v[j] + a + b + w;
  store_chunk<kVec>(out, p, v);
}

// k_threefry: f32(int32(x0 >> 8)), x0 the first word of Threefry-2x32 of
// the counter (xi[r, q], 0) under the key (123, 456); xi[r, q] is the u32
// word at xi + (r P + q) * stride.  kVec: P % 4 == 0, the float4 store.
template <bool kVec>
__global__ void __launch_bounds__(32)
mosaic_kernel_threefry(const uint32_t* __restrict__ xi, long long stride, float* __restrict__ out,
                       int p) {
  const size_t row = (size_t)blockIdx.y * p;
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = chunk_col<kVec>(j);
    w[j] = c < p ? __ldg(xi + (long long)(row + c) * stride) : 0u;
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t x0, x1;
    threefry2x32(123u, 456u, w[j], 0u, &x0, &x1);
    v[j] = (float)(int32_t)(x0 >> 8);
  }
  store_chunk<kVec>(out, p, v);
}

// k_dotgen: out[:, q] = sum_n z[n, q], z[n, q] = sum_r x[r, n] x[r, q]
// (n < n_dot), summed over n first: warp r sums row r's first n_dot
// columns, each lane its columns in order, then a butterfly over the lanes;
// then sum_r s_r x[r, q], r = 0..7 in order.  Every block of the grid over
// q recomputes the 8 row sums.
__global__ void __launch_bounds__(kMosaicThreads)
mosaic_kernel_dotgen(const float* __restrict__ x, float* __restrict__ out, int p, int n_dot) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  __shared__ float s_row[kRows];
  if (warp < kRows) {
    float s = 0.0f;
    for (int c = lane; c < n_dot; c += 32) s += x[warp * p + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) s_row[warp] = s;
  }
  __syncthreads();
  for (int q = blockIdx.x * kMosaicThreads + tid; q < p; q += gridDim.x * kMosaicThreads) {
    float acc = s_row[0] * x[q];
#pragma unroll
    for (int r = 1; r < kRows; ++r) acc = acc + s_row[r] * x[r * p + q];
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[r * p + q] = acc;
  }
}

// k_bcast_out: block (c, r) is one warp; it sums row r and writes columns
// [128 c, 128 c + 128) of it, one float4 per lane where P % 4 == 0.
template <bool kVec>
__global__ void __launch_bounds__(32)
mosaic_kernel_bcast_out(const float* __restrict__ x, float* __restrict__ out, int p) {
  const int lane = threadIdx.x;
  const int r = blockIdx.y;
  const float s = warp_row_sum<kVec>(x + (size_t)r * p, p, lane);
  float* o = out + (size_t)r * p;
  const int c0 = blockIdx.x * kChunkCols;
  if ((p & 3) == 0) {
    const int c = c0 + 4 * lane;
    if (c < p) *reinterpret_cast<float4*>(o + c) = make_float4(s, s, s, s);
  } else {
    const int end = min(c0 + kChunkCols, p);
    for (int c = c0 + lane; c < end; c += 32) o[c] = s;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kProbe>
int launch_io_warp(const void* pts, const void* keys, long long key_stride, void* out, int batch,
                   int n, cudaStream_t st) {
  const int rows = kRows * batch;
  const dim3 grid((rows + kIoWarps - 1) / kIoWarps);
  const float* src = static_cast<const float*>(pts);
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  float* o = static_cast<float*>(out);
  if (n % 4 == 0 && aligned16(pts))
    io_kernel_warp<kProbe, true><<<grid, kIoWarps * 32, 0, st>>>(src, k, key_stride, o, rows, n);
  else
    io_kernel_warp<kProbe, false><<<grid, kIoWarps * 32, 0, st>>>(src, k, key_stride, o, rows, n);
  return (int)cudaGetLastError();
}

template <int kProbe>
int launch_io(const void* src, void* out, int batch, int n, cudaStream_t st) {
  io_kernel<kProbe><<<dim3(kRows, batch), kIoThreads, 0, st>>>(
      static_cast<const float*>(src), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

// Launches the instantiation `vec` (kVec: P % 4 == 0 and, for a float
// tile, 16-byte aligned) or `scalar` on the grid of 8 x ceil(P / 128)
// single warps.
template <typename Kernel, typename... Args>
int launch_chunks(Kernel vec, Kernel scalar, bool use_vec, int p, cudaStream_t st, Args... args) {
  const dim3 grid((p + kChunkCols - 1) / kChunkCols, kRows);
  const Kernel kernel = use_vec ? vec : scalar;
  kernel<<<grid, 32, 0, st>>>(args...);
  return (int)cudaGetLastError();
}

int launch_dotgen(const float* x, float* out, int p, int n_dot, cudaStream_t st) {
  mosaic_kernel_dotgen<<<(p + kMosaicThreads - 1) / kMosaicThreads, kMosaicThreads, 0, st>>>(
      x, out, p, n_dot);
  return (int)cudaGetLastError();
}

// Runs launch() with CUDA device `device` current and then makes the
// caller's current again; returns the first CUDA error, or launch()'s.
template <typename Launch>
int on_device(int device, Launch launch) {
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int ret = launch();
  if (current != device) cudaSetDevice(current);
  return ret;
}

}  // namespace

extern "C" {

// Largest contraction length k_dotgen takes.
int ndt_mosaic_max_dot_n() { return kMaxDotN; }

// One io_probe (IoProbe id) over B solves of N points on `stream` of CUDA
// device `device`: src is pts [B, 8, N] (min, smem) or the stencil
// [B, 25, 8, N] (sten4; sten3 its [B, 200, N] view); keys (smem only) the
// u32 word of keys[b, 0] at keys + b * key_stride words (the low word of an
// int64); out [B, 8, 128].  One launch.  Returns cudaGetLastError() after
// it.
int ndt_io_probe(int probe, const void* src, const void* keys, long long key_stride, void* out,
                 int batch, int n, int device, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || n < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  if (probe == kSmem && (keys == nullptr || key_stride < 1)) return (int)cudaErrorInvalidValue;
  return on_device(device, [&]() {
    switch (probe) {
      case kMin: return launch_io_warp<kMin>(src, keys, key_stride, out, batch, n, st);
      case kSmem: return launch_io_warp<kSmem>(src, keys, key_stride, out, batch, n, st);
      case kSten3: return launch_io<kSten3>(src, out, batch, n, st);
      case kSten4: return launch_io<kSten4>(src, out, batch, n, st);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

// One mosaic_probe (MosaicProbe id) on the [8, P] tile, on `stream` of CUDA
// device `device`: x f32 (every probe but threefry); xi (threefry) the u32
// counter of element e at xi + e * xi_stride words (the low word of an
// int64); out f32 [8, P]; n_dot <= P is k_dotgen's contraction length.  One
// launch.  Returns cudaGetLastError().
int ndt_mosaic_probe(int probe, const void* x, const void* xi, long long xi_stride, void* out,
                     int p, int n_dot, int device, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p < 1 || n_dot < 1 || n_dot > p || n_dot > kMaxDotN) return (int)cudaErrorInvalidValue;
  if (probe == kThreefry && (xi == nullptr || xi_stride < 1)) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  const bool vec = p % 4 == 0 && aligned16(x);
  return on_device(device, [&]() {
    switch (probe) {
      case kCol3:
        return launch_chunks(mosaic_kernel_col3<true>, mosaic_kernel_col3<false>, vec, p, st, xf, o, p);
      case kBool11:
        return launch_chunks(mosaic_kernel_bool11<true>, mosaic_kernel_bool11<false>, vec, p, st, xf,
                             o, p);
      case kSlice11:
        return launch_chunks(mosaic_kernel_slice11<true>, mosaic_kernel_slice11<false>, vec, p, st,
                             xf, o, p);
      case kForiSmall:
        return launch_chunks(mosaic_kernel_fori_small<true>, mosaic_kernel_fori_small<false>, vec, p,
                             st, xf, o, p);
      case kThreefry:  // the counters are read as scalars; only the store is a float4
        return launch_chunks(mosaic_kernel_threefry<true>, mosaic_kernel_threefry<false>, p % 4 == 0,
                             p, st, static_cast<const uint32_t*>(xi), xi_stride, o, p);
      case kDotgen: return launch_dotgen(xf, o, p, n_dot, st);
      case kBcastOut:
        return launch_chunks(mosaic_kernel_bcast_out<true>, mosaic_kernel_bcast_out<false>, vec, p,
                             st, xf, o, p);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

}  // extern "C"
