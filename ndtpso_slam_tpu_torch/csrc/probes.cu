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
// io_kernel<probe>: one block per (solve b, row r) of the output
// [B, 8, 128]; the block sums its row over the N points and writes the sum
// to all 128 lanes.  The stencil probes first add the 25 stencil offsets of
// each point in order k = 0..24, as the TPU kernel's loop does, then sum the
// points.  k_smem adds f32(int32(keys[b, 0] >> 8)), exact in float32.
// What bounds it: bytes.  The [B, 25, 8, N] stencil table (78.6 MB at
// B = 256, N = 384) is read once; each warp reads 32 neighbouring points of
// one (k, r) row, 25 independent loads in flight per point.
//
// mosaic_kernel<probe>: one block of 512 threads over the [8, P] tile.
// Row sums and the row-0 minimum are block reductions in shared memory;
// k_dotgen's contraction z[n, p] = sum_r x[r, n] x[r, p] and its sum over n
// run in the kernel's body, the 8 x n block of x staged in shared memory.
// What bounds it: a launch; the tile is 16 KB.
//
// Numerics: --fmad=false and no fast math, so every + - * rounds as in
// the plain versions; the sums are taken in another order (warp tree, then
// the warps in order).  The minimum propagates a NaN, as jnp.min does.

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
constexpr int kMaxDotN = 1024;  // k_dotgen's contraction length staged in shared memory

template <int kProbe>
__global__ void __launch_bounds__(kIoThreads)
io_kernel(const float* __restrict__ src, const uint32_t* __restrict__ keys,
          float* __restrict__ out, int n) {
  const int b = blockIdx.y;
  const int r = blockIdx.x;
  __shared__ float s_sum[kIoThreads / 32];
  float part = 0.0f;
  for (int i = threadIdx.x; i < n; i += kIoThreads) {
    float v;
    if (kProbe == kMin || kProbe == kSmem) {
      v = src[((size_t)b * kRows + r) * n + i];
    } else {
      // [B, 25, 8, N] and its [B, 200, N] view: the same addresses, indexed
      // as each TPU probe indexes them.
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kK2; ++k) {
        const size_t row = kProbe == kSten4 ? ((size_t)b * kK2 + k) * kRows + r
                                            : (size_t)b * kK2 * kRows + kRows * k + r;
        acc = acc + src[row * n + i];
      }
      v = acc;
    }
    part += v;
  }
  float sum = block_sum<kIoThreads>(part, s_sum);
  if (kProbe == kSmem) sum = sum + (float)(int32_t)(keys[2 * b] >> 8);
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
  __shared__ float s_dot[kRows * kMaxDotN];

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
  if (kProbe == kForiSmall || kProbe == kBcastOut) {
    // Row sums: warp r sums row r.
    if (warp < kRows) {
      float s = 0.0f;
      for (int c = lane; c < p; c += 32) s += x[warp * p + c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) s_row[warp] = s;
    }
    __syncthreads();
    if (kProbe == kBcastOut) {
      for (int e = tid; e < kRows * p; e += kMosaicThreads) out[e] = s_row[e / p];
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
    return;
  }
  if (kProbe == kDotgen) {
    // out[:, q] = sum_n z[n, q], z[n, q] = sum_r x[r, n] x[r, q] (n < n_dot).
    for (int e = tid; e < kRows * n_dot; e += kMosaicThreads) {
      const int r = e / n_dot;
      s_dot[e] = x[r * p + (e - r * n_dot)];
    }
    __syncthreads();
    for (int q = tid; q < p; q += kMosaicThreads) {
      float xq[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) xq[r] = x[r * p + q];
      float acc = 0.0f;
      for (int nn = 0; nn < n_dot; ++nn) {
        float z = s_dot[nn] * xq[0];
#pragma unroll
        for (int r = 1; r < kRows; ++r) z = z + s_dot[r * n_dot + nn] * xq[r];
        acc = acc + z;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) out[r * p + q] = acc;
    }
  }
}

template <int kProbe>
int launch_io(const void* src, const void* keys, void* out, int batch, int n, cudaStream_t st) {
  io_kernel<kProbe><<<dim3(kRows, batch), kIoThreads, 0, st>>>(
      static_cast<const float*>(src), static_cast<const uint32_t*>(keys),
      static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

template <int kProbe>
int launch_mosaic(const void* x, const void* xi, void* out, int p, int n_dot, cudaStream_t st) {
  mosaic_kernel<kProbe><<<1, kMosaicThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(xi), static_cast<float*>(out),
      p, n_dot);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest contraction length k_dotgen takes.
int ndt_mosaic_max_dot_n() { return kMaxDotN; }

// One io_probe (IoProbe id) over B solves of N points: src is pts [B, 8, N]
// (min, smem) or the stencil [B, 25, 8, N] (sten4; sten3 its [B, 200, N]
// view); keys [B, 2] u32 (smem only); out [B, 8, 128].  Returns
// cudaGetLastError() after the launch.
int ndt_io_probe(int probe, const void* src, const void* keys, void* out, int batch, int n,
                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || n < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  switch (probe) {
    case kMin: return launch_io<kMin>(src, keys, out, batch, n, st);
    case kSmem: return launch_io<kSmem>(src, keys, out, batch, n, st);
    case kSten3: return launch_io<kSten3>(src, keys, out, batch, n, st);
    case kSten4: return launch_io<kSten4>(src, keys, out, batch, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One mosaic_probe (MosaicProbe id) on the [8, P] tile: x f32 (every probe
// but threefry), xi u32 (threefry), out f32 [8, P]; n_dot <= P is
// k_dotgen's contraction length.  Returns cudaGetLastError().
int ndt_mosaic_probe(int probe, const void* x, const void* xi, void* out, int p, int n_dot,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p < 1 || n_dot < 1 || n_dot > p || n_dot > kMaxDotN) return (int)cudaErrorInvalidValue;
  switch (probe) {
    case kCol3: return launch_mosaic<kCol3>(x, xi, out, p, n_dot, st);
    case kBool11: return launch_mosaic<kBool11>(x, xi, out, p, n_dot, st);
    case kSlice11: return launch_mosaic<kSlice11>(x, xi, out, p, n_dot, st);
    case kForiSmall: return launch_mosaic<kForiSmall>(x, xi, out, p, n_dot, st);
    case kThreefry: return launch_mosaic<kThreefry>(x, xi, out, p, n_dot, st);
    case kDotgen: return launch_mosaic<kDotgen>(x, xi, out, p, n_dot, st);
    case kBcastOut: return launch_mosaic<kBcastOut>(x, xi, out, p, n_dot, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
