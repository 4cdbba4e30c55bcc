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
// mosaic_kernel<probe>: one block of 512 threads over the [8, P] tile
// (k_dotgen: a grid of them over the columns).  Row sums and the row-0
// minimum are warp reductions.  k_dotgen's function, the column totals
// sum_n z[n, q] of z[n, q] = sum_r x[r, n] x[r, q], is computed summed over
// n first, sum_r (sum_n x[r, n]) x[r, q]: 8 n + 16 P operations where the
// contraction as written takes 16 n P, and no serial chain over n.
// mosaic_kernel_bcast_out (k_bcast_out): a grid of single warps, 8 rows x
// ceil(P / 128) column chunks; each warp sums its whole row (warp_row_sum)
// and writes its chunk, one float4 per lane, so no barrier and no divide.
// A row is read ceil(P / 128) times, from L2 after the first.
// What bounds them: a launch; the tile is 16 KB.
//
// Numerics: --fmad=false and no fast math, so every + - * rounds as in
// the plain versions; the sums are taken in another order (a lane's terms
// in order, then a butterfly over the lanes; io_kernel and mosaic_kernel
// then add the warps in order).  The minimum propagates a NaN, as jnp.min
// does.

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
constexpr int kMosaicThreads = 512;
constexpr int kMaxDotN = 1024;  // the longest contraction k_dotgen takes
constexpr int kIoWarps = 4;     // io_kernel_warp: rows per block
constexpr int kBcastCols = 128; // mosaic_kernel_bcast_out: columns per warp
constexpr int kInFlight = 4;    // warp_row_sum: loads per lane before it adds
static_assert(kLanes == 32 * 4, "io_kernel_warp writes a row as one float4 per lane");

// The sum of a row's n floats by one warp, the same bits in every lane:
// lane l adds, in order, the elements l, l + 32, l + 64, ... (kVec: the
// float4s l, l + 32, ..., each one's four components in order; the row
// 16-byte aligned and n % 4 == 0), issuing kInFlight loads before it adds
// them; then a butterfly over the lanes.
template <bool kVec>
__device__ __forceinline__ float warp_row_sum(const float* __restrict__ row, int n, int lane) {
  float s = 0.0f;
  if (kVec) {
    const float4* v = reinterpret_cast<const float4*>(row);
    const int n4 = n >> 2;
    for (int base = lane; base < n4; base += 32 * kInFlight) {
      float4 q[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (base + 32 * j < n4) q[j] = __ldg(v + base + 32 * j);
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (base + 32 * j < n4) s = s + q[j].x + q[j].y + q[j].z + q[j].w;
    }
  } else {
    for (int base = lane; base < n; base += 32 * kInFlight) {
      float q[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (base + 32 * j < n) q[j] = __ldg(row + base + 32 * j);
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        if (base + 32 * j < n) s = s + q[j];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
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

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

template <int kProbe>
__global__ void __launch_bounds__(kMosaicThreads)
mosaic_kernel(const float* __restrict__ x, const uint32_t* __restrict__ xi,
              float* __restrict__ out, int p, int n_dot) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  __shared__ float s_row[kRows];

  if (kProbe == kCol3) {
    for (int e = tid; e < kRows * p; e += kMosaicThreads) {
      const int r = e / p;
      out[e] = x[e] + (r == 0 ? 1.0f : (r == 1 ? 2.0f : 3.0f));
    }
    return;
  }
  if (kProbe == kThreefry) {
    for (int e = tid; e < kRows * p; e += kMosaicThreads) {
      uint32_t x0, x1;
      threefry2x32(123u, 456u, xi[e], 0u, &x0, &x1);
      out[e] = (float)(int32_t)(x0 >> 8);
    }
    return;
  }
  if (kProbe == kSlice11) {
    const float f = cosf(x[0]) + 1.0f;
    for (int e = tid; e < kRows * p; e += kMosaicThreads) out[e] = x[e] * f;
    return;
  }
  if (kProbe == kBool11) {
    // The row-0 minimum, NaN-propagating: one warp.
    if (warp == 0) {
      float m = INFINITY;
      for (int c = lane; c < p; c += 32) m = nan_min(x[c], m);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = nan_min(__shfl_xor_sync(0xffffffffu, m, off), m);
      if (lane == 0) s_row[0] = m;
    }
    __syncthreads();
    const float bc = s_row[0];
    const float v = bc < 0.5f ? bc : bc + 1.0f;
    for (int e = tid; e < kRows * p; e += kMosaicThreads) out[e] = x[e] + v;
    return;
  }
  if (kProbe == kForiSmall || kProbe == kDotgen) {
    // Row sums: warp r sums row r (k_dotgen: its first n_dot columns), each
    // lane its columns in order, then a butterfly over the lanes.
    const int len = kProbe == kDotgen ? n_dot : p;
    if (warp < kRows) {
      float s = 0.0f;
      for (int c = lane; c < len; c += 32) s += x[warp * p + c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) s_row[warp] = s;
    }
    __syncthreads();
    if (kProbe == kDotgen) {
      // out[:, q] = sum_n z[n, q], z[n, q] = sum_r x[r, n] x[r, q] (n < n_dot),
      // summed over n first: sum_r s_r x[r, q], r = 0..7 in order.  Every
      // block of the grid over q recomputes the 8 row sums.
      for (int q = blockIdx.x * kMosaicThreads + tid; q < p; q += gridDim.x * kMosaicThreads) {
        float acc = s_row[0] * x[q];
#pragma unroll
        for (int r = 1; r < kRows; ++r) acc = acc + s_row[r] * x[r * p + q];
#pragma unroll
        for (int r = 0; r < kRows; ++r) out[r * p + q] = acc;
      }
      return;
    }
    // fori_loop(0, 5): a + 1, b * 1.01, w * 0.99, each step rounded.
    float b = s_row[0];
    float w = 1.0f;
    float a[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) a[r] = s_row[r];
    for (int i = 0; i < 5; ++i) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = a[r] + 1.0f;
      b = b * 1.01f;
      w = w * 0.99f;
    }
    for (int e = tid; e < kRows * p; e += kMosaicThreads) {
      const int r = e / p;
      float acc = x[e];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        if (rr == r) acc = acc + a[rr];
      out[e] = acc + b + w;
    }
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
  const int c0 = blockIdx.x * kBcastCols;
  if ((p & 3) == 0) {
    const int c = c0 + 4 * lane;
    if (c < p) *reinterpret_cast<float4*>(o + c) = make_float4(s, s, s, s);
  } else {
    const int end = min(c0 + kBcastCols, p);
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

int launch_bcast_out(const void* x, void* out, int p, cudaStream_t st) {
  const dim3 grid((p + kBcastCols - 1) / kBcastCols, kRows);
  const float* src = static_cast<const float*>(x);
  if (p % 4 == 0 && aligned16(x))
    mosaic_kernel_bcast_out<true><<<grid, 32, 0, st>>>(src, static_cast<float*>(out), p);
  else
    mosaic_kernel_bcast_out<false><<<grid, 32, 0, st>>>(src, static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}

template <int kProbe>
int launch_mosaic(const void* x, const void* xi, void* out, int p, int n_dot, cudaStream_t st) {
  // k_dotgen: a grid over the columns; the others: one block.
  const int blocks = kProbe == kDotgen ? (p + kMosaicThreads - 1) / kMosaicThreads : 1;
  mosaic_kernel<kProbe><<<blocks, kMosaicThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(xi), static_cast<float*>(out),
      p, n_dot);
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
// device `device`: x f32 (every probe but threefry), xi u32 (threefry),
// out f32 [8, P]; n_dot <= P is k_dotgen's contraction length.  One launch.
// Returns cudaGetLastError().
int ndt_mosaic_probe(int probe, const void* x, const void* xi, void* out, int p, int n_dot,
                     int device, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p < 1 || n_dot < 1 || n_dot > p || n_dot > kMaxDotN) return (int)cudaErrorInvalidValue;
  return on_device(device, [&]() {
    switch (probe) {
      case kCol3: return launch_mosaic<kCol3>(x, xi, out, p, n_dot, st);
      case kBool11: return launch_mosaic<kBool11>(x, xi, out, p, n_dot, st);
      case kSlice11: return launch_mosaic<kSlice11>(x, xi, out, p, n_dot, st);
      case kForiSmall: return launch_mosaic<kForiSmall>(x, xi, out, p, n_dot, st);
      case kThreefry: return launch_mosaic<kThreefry>(x, xi, out, p, n_dot, st);
      case kDotgen: return launch_mosaic<kDotgen>(x, xi, out, p, n_dot, st);
      case kBcastOut: return launch_bcast_out(x, out, p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

}  // extern "C"
