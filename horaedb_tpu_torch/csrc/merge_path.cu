// Merge-path k-way merge of presorted runs: one level of a pairwise
// merge tree per launch.
//
// Replaces the XLA program horaedb_tpu/ops/merge.py::_kway_merge_perm_impl
// (the device k-way merge the JAX package's fused decode runs on a
// segment of several interleaved SST runs, ops/device_decode.py).  The
// wrapper and the plain PyTorch version are in
// horaedb_tpu_torch/ops/merge.py.
//
// What it computes: perm (cap,) such that gathering rows by perm gives
// the stable sort by (pad, keys..., row), where pad = row >= n_valid and
// the rows of run r, [offsets[r], offsets[r + 1]), already arrive sorted
// by (keys..., row).  num_runs is a power of two; empty runs are allowed.
//
// Each level merges pairs of blocks of `level` runs.  Slot j holds the
// element perm_in[j] (the identity before the first level); elements
// never leave their block's slot range, so the block of slot j is the
// run holding j.  Its new slot is its offset in its own block plus a
// binary-searched count over the partner block: an A-side (lower) element
// counts the B keys strictly less than its own, a B-side element the A
// keys less than or equal to its own.  Every B row index exceeds every A
// row index, so strict/leq is exactly the row tiebreak.  The write is a
// permutation: no two threads write one slot, and the result does not
// depend on the schedule.
//
// Bound on this card: bytes.  A level reads each key column and perm_in
// once and writes perm_out once, (4 K + 8) bytes a slot; the binary
// searches re-read keys through perm, but a main-path segment's keys
// (131,072 slots x 5 columns, 2.6 MB) sit in the 50 MB L2.  This first
// design runs one thread per slot with the whole lexicographic binary
// search in registers: the slot's own keys are loaded once, and each
// step reads the partner's keys through perm (no gathered copy).  The
// key loops are unrolled to MAX_KEYS, so the key pointers stay kernel
// parameters.  Partitioning the merge path into shared-memory tiles is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_KEYS 16
#define MAX_RUNS 128
#define THREADS 256

struct KeyCols {
  const int32_t* col[MAX_KEYS];
};

// lexicographic compare of row f against the keys (pad, mine...) of
// another row: <0, 0, >0
__device__ __forceinline__ int compare_row(const KeyCols& keys, int nkeys,
                                           int n_valid, int f, int pad,
                                           const int32_t (&mine)[MAX_KEYS]) {
  const int pf = f >= n_valid;
  if (pf != pad) return pf - pad;
#pragma unroll
  for (int i = 0; i < MAX_KEYS; ++i) {
    if (i >= nkeys) break;
    const int32_t x = __ldg(keys.col[i] + f);
    if (x != mine[i]) return x < mine[i] ? -1 : 1;
  }
  return 0;
}

__global__ void __launch_bounds__(THREADS)
kway_merge_level(KeyCols keys, int nkeys, const int32_t* __restrict__ offsets,
                 int num_runs, int cap, int n_valid, int level,
                 const int32_t* __restrict__ perm_in,
                 int32_t* __restrict__ perm_out) {
  __shared__ int32_t offs[MAX_RUNS + 1];
  for (int i = threadIdx.x; i <= num_runs; i += blockDim.x) offs[i] = offsets[i];
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cap) return;

  // run of slot j: the last run starting at or before j (an empty run
  // shares its start with the next one, so it never holds a slot)
  int l = 0, h = num_runs + 1;
  while (l < h) {
    const int m = (l + h) >> 1;
    if (offs[m] <= j) l = m + 1; else h = m;
  }
  const int run = min(max(l - 1, 0), num_runs - 1);
  const int base = 2 * level * ((run / level) >> 1);
  const int start = offs[base];
  const int mid = offs[base + level];
  const int end = offs[base + 2 * level];

  const int e = perm_in ? perm_in[j] : j;
  const int pad = e >= n_valid;
  int32_t mine[MAX_KEYS];
#pragma unroll
  for (int i = 0; i < MAX_KEYS; ++i)
    mine[i] = i < nkeys ? __ldg(keys.col[i] + e) : 0;
  const bool in_a = j < mid;
  int lo = in_a ? mid : start;
  int hi = in_a ? end : mid;
  while (lo < hi) {
    const int q = lo + ((hi - lo) >> 1);
    const int f = perm_in ? perm_in[q] : q;
    const int c = compare_row(keys, nkeys, n_valid, f, pad, mine);
    if (in_a ? c < 0 : c <= 0) lo = q + 1; else hi = q;
  }
  perm_out[in_a ? j + (lo - mid) : (j - mid) + lo] = e;
}

extern "C" int horaedb_kway_merge_level(const void* const* key_ptrs, int nkeys,
                                        const int32_t* offsets, int num_runs,
                                        int cap, int n_valid, int level,
                                        const int32_t* perm_in,
                                        int32_t* perm_out, void* stream) {
  if (nkeys < 0 || nkeys > MAX_KEYS || num_runs < 2 || num_runs > MAX_RUNS ||
      level < 1 || level >= num_runs || cap <= 0)
    return (int)cudaErrorInvalidValue;
  KeyCols keys;
  for (int i = 0; i < MAX_KEYS; ++i)
    keys.col[i] = i < nkeys ? (const int32_t*)key_ptrs[i] : nullptr;
  const int blocks = (cap + THREADS - 1) / THREADS;
  kway_merge_level<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      keys, nkeys, offsets, num_runs, cap, n_valid, level, perm_in, perm_out);
  return (int)cudaGetLastError();
}
