// bucket_window_partials: the per-window partial grids of one fused
// aggregate round, hand-written for Hopper (sm_90a).
//
// Replaces: horaedb_tpu/ops/pallas_kernels.py::_agg_kernel (launched by
// _pallas_partial_grids; entry points pallas_time_bucket_aggregate and
// pallas_window_partials), fused with the window prologue of
// horaedb_tpu/ops/downsample.py::window_local_partials.
//
// What it computes, per window w and row r (rows [0, n_valid) real):
//   g  = remap ? (gid < 0 ? -1 : remap[w, clamp(gid, 0, R-1)]) : gid
//   tg = ts + shift[w]                     (int32, wrapping)
//   g  = floor(tg / bucket_ms) < total ? g : -1
//   tl = tg - lo[w] * bucket_ms            (int32, wrapping)
//   b  = floor(tl / bucket_ms)
//   the row lands in cell (w, g, b) when 0 <= g < G and 0 <= b < width;
// per cell: count, sum, min, max, and `last` = the value at the max tl,
// the later row winning ties, with last_ts = that tl.  Empty cells read
// count 0, sum 0, min +inf, max -inf, last 0, last_ts INT32_MIN — the
// partial conventions the fused accumulate consumes.
//
// Bound: the kernel must read every row slot once, 12 bytes per slot
// (ts, gid, value), plus remap/shift/lo, and write the grids once
// (4 bytes per cell per field).  At the main path's round shape
// (W=16, cap=131072, G=128, width=128, count+sum) that is 25.2 MB in
// and 2.1 MB out: ~8 us at 3.35 TB/s.  Memory, not arithmetic, bounds
// it: each row costs a handful of integer ops.
//
// Design: the TPU kernel compared every row with every cell of a tile
// (O(rows x cells)); here each thread computes its row's cell directly
// and folds into it with one atomic per field, so the work is O(rows).
// Loads are coalesced (neighbouring threads, neighbouring rows); the
// grids accumulate in global memory, where they stay L2-resident (a
// round's grids are a few MB against 50 MB of L2).  count is an int32
// atomic, sum an f32 atomicAdd (its order varies run to run: sums agree
// with the plain version within rounding, not bit for bit), min/max are
// int32 atomicMin/atomicMax on an order-preserving int image of the
// float, and `last` is a 64-bit atomicMax on the packed key
// ((uint32)(tl ^ 0x80000000) << 32) | row — max ts first, later row on
// ties — whose winning row's value a finalize pass gathers.  Three
// launches per call: identity fill, accumulate, finalize.
// Shared-memory privatisation of the grids and TMA row loads are left
// for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFieldSum = 2;
constexpr int kFieldMin = 4;
constexpr int kFieldMax = 8;
constexpr int kFieldLast = 16;

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) q -= 1;
  return q;
}

// order-preserving int image of a float (an involution): signed int
// comparison of the images matches float comparison of non-NaN values
__device__ __forceinline__ int ordered(int bits) {
  return bits >= 0 ? bits : bits ^ 0x7FFFFFFF;
}

__global__ void init_kernel(long long cells, int fields, int* count_i,
                            float* sum, int* mn_i, int* mx_i,
                            unsigned long long* key) {
  const int pos_inf = ordered((int)0x7F800000u);  // +inf
  const int neg_inf = ordered((int)0xFF800000u);  // -inf
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       c < cells; c += (long long)gridDim.x * blockDim.x) {
    count_i[c] = 0;
    if (fields & kFieldSum) sum[c] = 0.0f;
    if (fields & kFieldMin) mn_i[c] = pos_inf;
    if (fields & kFieldMax) mx_i[c] = neg_inf;
    if (fields & kFieldLast) key[c] = 0ull;
  }
}

__global__ void accumulate_kernel(
    const int* __restrict__ ts, const int* __restrict__ gid,
    const float* __restrict__ vals, const int* __restrict__ remap,
    int remap_len, const int* __restrict__ shift,
    const int* __restrict__ lo, int cap, int n_valid, int num_groups,
    int width, int total_buckets, int bucket_ms, int fields, int* count_i,
    float* sum, int* mn_i, int* mx_i, unsigned long long* key) {
  const int w = blockIdx.y;
  const long long base = (long long)w * cap;
  const int sh = shift ? shift[w] : 0;
  const int lo_w = lo ? lo[w] : 0;
  const unsigned lo_ms = (unsigned)lo_w * (unsigned)bucket_ms;
  const int row0 = blockIdx.x * (kThreads * kRowsPerThread) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = row0 + k * kThreads;
    if (r >= cap || r >= n_valid) break;
    int g = gid[base + r];
    if (remap) {
      const int gi = g < 0 ? 0 : (g >= remap_len ? remap_len - 1 : g);
      g = g >= 0 ? remap[(long long)w * remap_len + gi] : -1;
    }
    const int tg = (int)((unsigned)ts[base + r] + (unsigned)sh);
    if (floor_div(tg, bucket_ms) >= total_buckets) g = -1;
    const int tl = (int)((unsigned)tg - lo_ms);
    const int b = floor_div(tl, bucket_ms);
    // the group bound is checked BEFORE the cell index is formed: an
    // oversized gid must be dropped, never wrapped into a valid cell
    if (g < 0 || g >= num_groups || b < 0 || b >= width) continue;
    const long long cell = ((long long)w * num_groups + g) * width + b;
    const float v = vals[base + r];
    atomicAdd(count_i + cell, 1);
    if (fields & kFieldSum) atomicAdd(sum + cell, v);
    if (fields & kFieldMin) atomicMin(mn_i + cell, ordered(__float_as_int(v)));
    if (fields & kFieldMax) atomicMax(mx_i + cell, ordered(__float_as_int(v)));
    if (fields & kFieldLast) {
      const unsigned long long k64 =
          ((unsigned long long)((unsigned)tl ^ 0x80000000u) << 32) |
          (unsigned)r;
      atomicMax(key + cell, k64);
    }
  }
}

__global__ void finalize_kernel(long long cells, int cells_per_window,
                                int cap, int fields,
                                const float* __restrict__ vals,
                                int* count_i, int* mn_i, int* mx_i,
                                const unsigned long long* __restrict__ key,
                                float* last, int* last_ts) {
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       c < cells; c += (long long)gridDim.x * blockDim.x) {
    const int n = count_i[c];
    // count, min and max are converted IN PLACE: the int images live in
    // the float output buffers
    reinterpret_cast<float*>(count_i)[c] = (float)n;
    if (fields & kFieldMin)
      reinterpret_cast<float*>(mn_i)[c] = __int_as_float(ordered(mn_i[c]));
    if (fields & kFieldMax)
      reinterpret_cast<float*>(mx_i)[c] = __int_as_float(ordered(mx_i[c]));
    if (fields & kFieldLast) {
      if (n > 0) {
        const unsigned long long k = key[c];
        const long long w = c / cells_per_window;
        last[c] = vals[w * cap + (unsigned)(k & 0xFFFFFFFFull)];
        last_ts[c] = (int)((unsigned)(k >> 32) ^ 0x80000000u);
      } else {
        last[c] = 0.0f;
        last_ts[c] = (int)0x80000000u;
      }
    }
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  return (int)(blocks < 1 ? 1 : blocks);
}

}  // namespace

// Plain C entry point (bound through ctypes).  Pointers are device
// pointers; remap, shift and lo may be null (identity remap, zero
// shift/lo).  count, min and max are float32 outputs of W*G*width
// cells; key is an int64 scratch of the same cell count (only read
// when `last` is requested).  Returns the cudaError_t of the first
// failing launch, 0 on success.
extern "C" int horaedb_bucket_window_partials(
    const int* ts, const int* gid, const float* vals, const int* remap,
    int remap_len, const int* shift, const int* lo, int num_windows,
    int cap, int n_valid, int num_groups, int width, int total_buckets,
    int bucket_ms, int fields, float* count, float* sum, float* mn,
    float* mx, float* last, int* last_ts, long long* key, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = (long long)num_windows * num_groups * width;
  if (cells == 0) return 0;
  int* count_i = reinterpret_cast<int*>(count);
  int* mn_i = reinterpret_cast<int*>(mn);
  int* mx_i = reinterpret_cast<int*>(mx);
  unsigned long long* key_u = reinterpret_cast<unsigned long long*>(key);

  init_kernel<<<grid_for(cells), kThreads, 0, s>>>(cells, fields, count_i,
                                                   sum, mn_i, mx_i, key_u);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (cap > 0 && num_windows > 0) {
    dim3 grid((cap + kThreads * kRowsPerThread - 1) /
                  (kThreads * kRowsPerThread),
              num_windows);
    accumulate_kernel<<<grid, kThreads, 0, s>>>(
        ts, gid, vals, remap, remap_len, shift, lo, cap, n_valid,
        num_groups, width, total_buckets, bucket_ms, fields, count_i, sum,
        mn_i, mx_i, key_u);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  finalize_kernel<<<grid_for(cells), kThreads, 0, s>>>(
      cells, num_groups * width, cap, fields, vals, count_i, mn_i, mx_i,
      key_u, last, last_ts);
  err = cudaGetLastError();
  return (int)err;
}
