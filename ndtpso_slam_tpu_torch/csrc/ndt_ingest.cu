// One scan into a dense-ring NDT map, in one launch: the node step's map
// update (models/ndt_map.py:ingest_scan's PyTorch path: transform_points,
// cell_index, add_points, then build_touched over this scan's cells and the
// previous scan's).
//
// It replaces no TPU kernel: the JAX package leaves the update to XLA, which
// fuses it.  PyTorch runs it as ~190 elementwise, index and scatter kernels
// of 384-768 elements each, ~1.7 us of the card apiece for a few ns of work.
// What bounds it on an H100 is latency: a scan touches a few hundred cells
// of a map of 360,000, so it reads and writes tens of KB.  One block of up
// to 1,024 threads does all of it, a block barrier between the phases, no
// grid barrier:
//
//   1. transform and bin: beam i by the pose, in transform_points' order of
//      operations, binned as cell_index bins it; an invalid or out-of-frame
//      beam gets the spare row C.  ids[i] is written, and the beam's
//      centred point kept in shared memory.
//   2. a table of the distinct cells of the 2N ids (this scan's, then the
//      previous scan's; ids outside [0, C) left out), open addressing in
//      shared memory: each cell's first position in the 2N ids (atomicMin)
//      and its last beam of this scan (atomicMax).
//   3. ingest: the thread of a cell's first beam adds the cell's beams into
//      cur_sum, cur_count and cur_m2 in ascending beam order, the order of
//      index_add_ on the CPU (and on CUDA under deterministic algorithms):
//      no float atomics, so the map is the same on every run.  It marks the
//      cell created and not built.
//   4. build: the thread of each distinct cell's first position builds it
//      (ndt_map._build_rows, in its order of operations), so no thread reads
//      a row that another writes.  The slot write goes to the pre-rotation
//      slot, as build_touched_stacked's does.
//
// The spare row C is never written (the PyTorch path sends its dropped
// entries there; nothing reads it).  Built with --fmad=false, every + - * /
// rounds as PyTorch's separate kernels round it; a division by a scalar is a
// product with its reciprocal, as PyTorch computes tensor / scalar on CUDA.

#include <climits>

#include "pso_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

template <typename T>
struct Map {
  T* mean_c;         // [C+1, 2]
  T* inv_cov;        // [C+1, 3]
  bool* built;       // [C+1]
  bool* created;     // [C+1]
  T* g_sum;          // [C+1, 2]
  int* g_count;      // [C+1]
  T* g_cov;          // [C+1, 3]
  T* slot_sum;       // [C+1, S, 2]
  int* slot_count;   // [C+1, S]
  T* slot_cov;       // [C+1, S, 3]
  int* slot_idx;     // [C+1]
  int* rot_count;    // [C+1]
  T* cur_sum;        // [C+1, 2]
  int* cur_count;    // [C+1]
  T* cur_m2;         // [C+1, 3]
};

struct Grid {
  double half;    // half the frame side, m
  double side;    // cell side, m
  int width;      // cells per side W
  int cells;      // C = W * W
  int slots;      // window slots S
  int capacity;   // points of a slot before the ring rotates
};

__device__ __forceinline__ float cos_of(float x) { return cosf(x); }
__device__ __forceinline__ double cos_of(double x) { return cos(x); }
__device__ __forceinline__ float sin_of(float x) { return sinf(x); }
__device__ __forceinline__ double sin_of(double x) { return sin(x); }
__device__ __forceinline__ float floor_of(float x) { return floorf(x); }
__device__ __forceinline__ double floor_of(double x) { return floor(x); }
__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }

// geometry._floor_i32: floor, clamp to +-2^30, to int32.
template <typename T>
__device__ __forceinline__ int floor_clamp(T v) {
  T f = floor_of(v);
  const T lim = (T)ndt::kCoordClamp;
  f = f < -lim ? -lim : (f > lim ? lim : f);
  return (int)f;
}

// Fibonacci hashing of a cell id into a table of 2^(32 - shift) slots.
__device__ __forceinline__ uint32_t slot_of(int id, int shift) {
  return ((uint32_t)id * 2654435761u) >> shift;
}

__device__ __forceinline__ int insert(int* key, uint32_t mask, int shift, int id) {
  uint32_t h = slot_of(id, shift);
  while (true) {
    const int prev = atomicCAS(key + h, -1, id);
    if (prev == -1 || prev == id) return (int)h;
    h = (h + 1) & mask;
  }
}

__device__ __forceinline__ int lookup(const int* key, uint32_t mask, int shift, int id) {
  uint32_t h = slot_of(id, shift);
  while (key[h] != id) h = (h + 1) & mask;
  return (int)h;
}

// gaussian.regularized_inverse of the packed covariance (a, b, c).
template <typename T>
__device__ __forceinline__ void regularized_inverse(T a, T b, T c, T* out) {
  const T half_tr = (a + c) * (T)0.5;
  const T d = (a - c) * (T)0.5;
  const T disc = sqrt_of(d * d + b * b);
  const T large = half_tr + disc;
  const T small = half_tr - disc;
  const T floor_eig = (T)1e-3 * large;
  const T det = small < floor_eig ? floor_eig * large : a * c - b * b;
  out[0] = c / det;
  out[1] = -b / det;
  out[2] = a / det;
}

// ndt_map._build_rows for cell id, in place.
template <typename T>
__device__ void build_cell(const Map<T>& m, const Grid& g, int id) {
  const int k = m.slot_idx[id];  // the pre-rotation slot
  const size_t r = (size_t)id * g.slots + k;
  const T cs0 = m.cur_sum[2 * id], cs1 = m.cur_sum[2 * id + 1];
  const int cc = m.cur_count[id];
  const T cm0 = m.cur_m2[3 * id], cm1 = m.cur_m2[3 * id + 1], cm2 = m.cur_m2[3 * id + 2];
  const T gs0 = m.g_sum[2 * id] + cs0 - m.slot_sum[2 * r];
  const T gs1 = m.g_sum[2 * id + 1] + cs1 - m.slot_sum[2 * r + 1];
  const int gc = m.g_count[id] + cc - m.slot_count[r];
  const bool has_stats = gc > 2;
  const T n_w = (T)(gc < 1 ? 1 : gc);
  const T mx = gs0 / n_w, my = gs1 / n_w;
  const T n_cur = (T)cc;
  const T cov[3] = {cm0 - (T)2 * mx * cs0 + n_cur * mx * mx,
                    cm1 - mx * cs1 - my * cs0 + n_cur * mx * my,
                    cm2 - (T)2 * my * cs1 + n_cur * my * my};
  if (has_stats) {
    T covar[3], inv[3];
    for (int j = 0; j < 3; ++j) {
      const T gcov = m.g_cov[3 * id + j] + cov[j] - m.slot_cov[3 * r + j];
      m.g_cov[3 * id + j] = gcov;
      covar[j] = gcov / n_w;
    }
    regularized_inverse(covar[0], covar[1], covar[2], inv);
    m.mean_c[2 * id] = mx;
    m.mean_c[2 * id + 1] = my;
    for (int j = 0; j < 3; ++j) {
      m.inv_cov[3 * id + j] = inv[j];
      m.slot_cov[3 * r + j] = cov[j];
    }
    m.built[id] = true;
  }
  m.g_sum[2 * id] = gs0;
  m.g_sum[2 * id + 1] = gs1;
  m.g_count[id] = gc;
  m.slot_sum[2 * r] = cs0;
  m.slot_sum[2 * r + 1] = cs1;
  m.slot_count[r] = cc;
  if (cc > g.capacity) {
    m.slot_idx[id] = (k + 1) % g.slots;
    m.rot_count[id] += 1;
    m.cur_sum[2 * id] = m.cur_sum[2 * id + 1] = (T)0;
    m.cur_count[id] = 0;
    m.cur_m2[3 * id] = m.cur_m2[3 * id + 1] = m.cur_m2[3 * id + 2] = (T)0;
  }
}

// Shared memory: the centred points [n, 2] of T, the 2N ids, then the table
// of 2^(32 - shift) slots: keys, first positions, last beams.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
ndt_ingest_kernel(Map<T> m, Grid g, const T* __restrict__ pose, const T* __restrict__ points,
                  const bool* __restrict__ valid, const int* __restrict__ prev_ids,
                  int* __restrict__ ids, int n, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* centred = reinterpret_cast<T*>(smem);
  int* list = reinterpret_cast<int*>(centred + 2 * n);
  const int n_slots = 1 << (32 - shift);
  const uint32_t mask = (uint32_t)n_slots - 1u;
  int* key = list + 2 * n;
  int* first = key + n_slots;
  int* last = first + n_slots;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c_cells = g.cells;

  for (int s = tid; s < n_slots; s += nt) {
    key[s] = -1;
    first[s] = INT_MAX;
    last[s] = -1;
  }
  // 1. transform_points, then cell_index.
  const T c = cos_of(pose[2]), s = sin_of(pose[2]);
  const T tx = pose[0], ty = pose[1];
  const T half = (T)g.half, side = (T)g.side;
  const T inv_side = (T)1 / side;
  for (int i = tid; i < n; i += nt) {
    const T px = points[2 * i], py = points[2 * i + 1];
    const T x = px * c - py * s + tx;
    const T y = px * s + py * c + ty;
    const bool inb = x > -half && x < half && y > -half && y < half;
    const int ix = floor_clamp((x + half) * inv_side);
    const int iy = floor_clamp((y + half) * inv_side);
    int idx = (int)((uint32_t)ix + (uint32_t)g.width * (uint32_t)iy);  // wraps as int32 does
    idx = idx < 0 ? 0 : (idx > c_cells - 1 ? c_cells - 1 : idx);
    const int id = valid[i] && inb ? idx : c_cells;
    ids[i] = id;
    list[i] = id;
    centred[2 * i] = x - (((T)(idx % g.width) + (T)0.5) * side - half);
    centred[2 * i + 1] = y - (((T)(idx / g.width) + (T)0.5) * side - half);
  }
  for (int j = tid; j < n; j += nt) list[n + j] = prev_ids[j];
  __syncthreads();
  // 2. the distinct cells.
  for (int q = tid; q < 2 * n; q += nt) {
    const int id = list[q];
    if (id < 0 || id >= c_cells) continue;
    const int h = insert(key, mask, shift, id);
    atomicMin(first + h, q);
    if (q < n) atomicMax(last + h, q);
  }
  __syncthreads();
  // 3. add_points.
  for (int i = tid; i < n; i += nt) {
    const int id = list[i];
    if (id >= c_cells) continue;
    const int h = lookup(key, mask, shift, id);
    if (first[h] != i) continue;
    T sx = m.cur_sum[2 * id], sy = m.cur_sum[2 * id + 1];
    T m0 = m.cur_m2[3 * id], m1 = m.cur_m2[3 * id + 1], m2 = m.cur_m2[3 * id + 2];
    int count = m.cur_count[id];
    for (int j = i, end = last[h]; j <= end; ++j) {
      if (list[j] != id) continue;
      const T qx = centred[2 * j], qy = centred[2 * j + 1];
      sx = sx + qx;
      sy = sy + qy;
      m0 = m0 + qx * qx;
      m1 = m1 + qx * qy;
      m2 = m2 + qy * qy;
      count += 1;
    }
    m.cur_sum[2 * id] = sx;
    m.cur_sum[2 * id + 1] = sy;
    m.cur_m2[3 * id] = m0;
    m.cur_m2[3 * id + 1] = m1;
    m.cur_m2[3 * id + 2] = m2;
    m.cur_count[id] = count;
    m.created[id] = true;
    m.built[id] = false;
  }
  __syncthreads();
  // 4. build_touched.
  for (int q = tid; q < 2 * n; q += nt) {
    const int id = list[q];
    if (id < 0 || id >= c_cells) continue;
    if (first[lookup(key, mask, shift, id)] == q) build_cell(m, g, id);
  }
}

template <typename T>
int launch(void* const* fields, const Grid& g, const void* pose, const void* points,
           const void* valid, const void* prev_ids, void* ids, int n, int shift, int threads,
           size_t smem, cudaStream_t st) {
  Map<T> m;
  m.mean_c = static_cast<T*>(fields[0]);
  m.inv_cov = static_cast<T*>(fields[1]);
  m.built = static_cast<bool*>(fields[2]);
  m.created = static_cast<bool*>(fields[3]);
  m.g_sum = static_cast<T*>(fields[4]);
  m.g_count = static_cast<int*>(fields[5]);
  m.g_cov = static_cast<T*>(fields[6]);
  m.slot_sum = static_cast<T*>(fields[7]);
  m.slot_count = static_cast<int*>(fields[8]);
  m.slot_cov = static_cast<T*>(fields[9]);
  m.slot_idx = static_cast<int*>(fields[10]);
  m.rot_count = static_cast<int*>(fields[11]);
  m.cur_sum = static_cast<T*>(fields[12]);
  m.cur_count = static_cast<int*>(fields[13]);
  m.cur_m2 = static_cast<T*>(fields[14]);
  const void* kernel = (const void*)ndt_ingest_kernel<T>;
  cudaError_t err = ndt::reserve_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ndt_ingest_kernel<T><<<1, threads, smem, st>>>(
      m, g, static_cast<const T*>(pose), static_cast<const T*>(points),
      static_cast<const bool*>(valid), static_cast<const int*>(prev_ids), static_cast<int*>(ids),
      n, shift);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Ingests n beams into the map whose 15 fields (ops/ndt_ingest.py: FIELDS, in
// that order) are `fields`, float64 if is_double else float32, on `stream`
// of CUDA device `device`: one block of `threads` (<= 1024) threads with
// `smem` bytes of dynamic shared memory, a table of 2^(32 - shift) slots.
// Writes ids [n].  Returns the first CUDA error, or 0; a refused launch is
// returned, never retried.
int ndt_ingest(int is_double, void* const* fields, const void* pose, const void* points,
               const void* valid, const void* prev_ids, void* ids, int n, double half,
               double side, int width, int slots, int capacity, int shift, int threads,
               long long smem, int device, void* stream) {
  if (n < 1 || width < 1 || slots < 1 || shift < 1 || shift > 31 || threads < 1 ||
      threads > kMaxThreads || smem < 0 || (long long)width * width >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const Grid g{half, side, width, width * width, slots, capacity};
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ret = is_double
      ? launch<double>(fields, g, pose, points, valid, prev_ids, ids, n, shift, threads,
                       (size_t)smem, st)
      : launch<float>(fields, g, pose, points, valid, prev_ids, ids, n, shift, threads,
                      (size_t)smem, st);
  if (current != device) cudaSetDevice(current);
  return ret;
}

}  // extern "C"
