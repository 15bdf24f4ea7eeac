// Merge-path k-way merge of presorted runs: one level of a pairwise
// merge tree per launch, each pair of blocks cut into shared-memory tiles.
//
// Replaces the XLA program horaedb_tpu/ops/merge.py::_kway_merge_perm_impl
// (the device k-way merge that horaedb_tpu/ops/device_decode.py runs on a
// segment of several interleaved SST runs).  The wrapper and the plain
// PyTorch version are in horaedb_tpu_torch/ops/merge.py.
//
// What it computes: perm (cap,) such that gathering rows by perm gives
// the stable sort by (pad, keys..., row), where pad = row >= n_valid and
// the rows of run r, [offsets[r], offsets[r + 1]), already arrive sorted
// by (keys..., row).  num_runs is a power of two; empty runs are allowed.
// Level `level` merges each pair of blocks of `level` runs: A = slots
// [start, mid), B = [mid, end).  Slot j holds element perm_in[j] (the
// identity before the first level).  An A element goes before a B
// element iff its (pad, keys...) <= the B element's: every B row index
// exceeds every A row index, so that rule is exactly the row tiebreak.
//
// Bound on this card: bytes.  The function reads each key column once and
// writes perm once: 3,145,748 B for the main path's segment (131,072
// slots, 5 key columns, 4 runs), 0.00094 ms at 3.35 TB/s; a launch costs
// a few microseconds, and the merge tree takes log2(num_runs) of them.
//
// Design, against the first design's three costs (one thread per slot,
// each running a 17-step binary search whose every step waits on a load
// of perm_in and then of the keys; no shortcut for a pair already in
// order; keys read and perm_out written scattered after the first level):
// - Tiles.  The merged output of each block pair is cut into tiles of
//   TILE slots, one CUDA block per tile; no tile crosses a pair.  A block
//   finds its pair and tile from the run offsets, staged in shared memory.
// - In-order pairs are a copy.  If A or B is empty, or A's last element
//   goes before B's first, the pair is already merged: the block copies
//   perm_in over its tile (the identity at the first level), coalesced,
//   with no search.  Every block of the pair makes the same choice.  The
//   main path's segment, [run 0, run 1, pad zone, empty], merges one pair
//   and copies the other at level 1, and copies all of level 2.
// - One diagonal search per tile end.  One warp each finds the co-rank
//   of the tile's first and last diagonal in device memory: how many of
//   the first d merged elements come from A.  Each step probes 32 points
//   at once and narrows the range 32-fold, so about 4 dependent steps
//   cover 72,000 rows.  (A block-wide search of 64 probes a step, the
//   in-order check folded into its first round, measured slower: each
//   step's barrier waits on the slowest of 128 scattered loads.)
// - Staged in shared memory.  The tile's A and B sub-ranges, TILE
//   elements together, are loaded with coalesced reads of perm_in, then
//   each element's key words are gathered through it, every load of a
//   batch predicated so that the batch is one round trip.  Writing each
//   level's merged keys beside perm_out, for the next level to read in
//   slot order (a ping-pong buffer), measured 9-29% slower than this
//   gather at 4, 8 and 128 runs.
// - Merged per thread.  Each thread searches its own diagonal in shared
//   memory (9 steps), then merges its ITEMS outputs with the head of each
//   side in registers, one element loaded a step.  A level's time is this
//   chain of dependent shared-memory steps more than the number of tiles,
//   so ITEMS = 4 beat 8.  Each output records where it came from, and the
//   tile goes out through shared memory: every perm_out write is
//   coalesced and each slot is written exactly once, the same bytes on
//   every launch.
// The compare holds KMAX key words in registers, the fewest of 4, 8 and
// 16 that fit nkeys.  Shared memory is (2 + nkeys) x TILE words, at most
// 36 KB.  PERF.md has the times of each choice.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_KEYS 16
#define MAX_RUNS 128
#define THREADS 128
#define ITEMS 4
#define TILE (THREADS * ITEMS)

static_assert((2 + MAX_KEYS) * TILE * 4 <= 48 * 1024,
              "a tile's shared memory fits without the opt-in");

struct KeyCols {
  const int32_t* col[MAX_KEYS];
};

__device__ __forceinline__ int elem_at(const int32_t* perm_in, int slot) {
  return perm_in ? __ldg(perm_in + slot) : slot;
}

// (pad, keys...) order of two elements whose key words are in registers:
// <0, 0, >0.  KMAX bounds nkeys; the words past nkeys are 0 on both sides.
template <int KMAX>
__device__ __forceinline__ int compare(int ea, const int32_t (&ka)[KMAX],
                                       int eb, const int32_t (&kb)[KMAX],
                                       int n_valid) {
  int c = (ea >= n_valid) - (eb >= n_valid);
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
    if (c == 0) c = (ka[i] > kb[i]) - (ka[i] < kb[i]);
  return c;
}

// key words of element e from device memory, all loads issued at once
template <int KMAX>
__device__ __forceinline__ void load_global(const KeyCols& keys, int nkeys,
                                            int e, int32_t (&k)[KMAX]) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) k[i] = i < nkeys ? __ldg(keys.col[i] + e) : 0;
}

// key words of the staged element at tile position x
template <int KMAX>
__device__ __forceinline__ void load_shared(const int32_t* s_key, int nkeys,
                                            int x, int32_t (&k)[KMAX]) {
#pragma unroll
  for (int i = 0; i < KMAX; ++i) k[i] = i < nkeys ? s_key[i * TILE + x] : 0;
}

// the element at slot sa goes before the element at slot sb
template <int KMAX>
__device__ __forceinline__ bool before_global(const KeyCols& keys, int nkeys,
                                              int n_valid,
                                              const int32_t* perm_in, int sa,
                                              int sb) {
  const int ea = elem_at(perm_in, sa), eb = elem_at(perm_in, sb);
  int32_t ka[KMAX], kb[KMAX];
  load_global<KMAX>(keys, nkeys, ea, ka);
  load_global<KMAX>(keys, nkeys, eb, kb);
  return compare<KMAX>(ea, ka, eb, kb, n_valid) <= 0;
}

// Co-rank of diagonal d in the merge of A = slots [a_lo, a_lo + na) and
// B = [b_lo, b_lo + nb): the count of A elements among the first d
// outputs, i.e. the least i in [max(0, d - nb), min(d, na)] for which
// A[i] does not go before B[d - i - 1].  Run by one whole warp: each
// step probes 32 points of [lo, hi) and keeps the part between the last
// probe that goes before and the first that does not.
template <int KMAX>
__device__ int corank_warp(const KeyCols& keys, int nkeys, int n_valid,
                           const int32_t* perm_in, int a_lo, int na,
                           int b_lo, int nb, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int n = hi - lo;
    const int m =
        n <= 32 ? lo + lane : lo + (int)(((long long)lane * n) >> 5);
    const bool p = m < hi && before_global<KMAX>(keys, nkeys, n_valid,
                                                 perm_in, a_lo + m,
                                                 b_lo + d - m - 1);
    const int c = __popc(__ballot_sync(0xffffffffu, p));
    if (n <= 32) return lo + c;
    if (c == 0) return lo;
    const int next_lo = lo + (int)(((long long)(c - 1) * n) >> 5) + 1;
    if (c < 32) hi = lo + (int)(((long long)c * n) >> 5);
    lo = next_lo;
  }
  return lo;
}

template <int KMAX>
__global__ void __launch_bounds__(THREADS)
kway_merge_level(KeyCols keys, int nkeys,
                 const int32_t* __restrict__ offsets, int num_runs,
                 int n_valid, int level, const int32_t* __restrict__ perm_in,
                 int32_t* __restrict__ perm_out) {
  extern __shared__ int32_t smem[];
  int32_t* s_elem = smem;            // the tile's A elements, then B's
  int32_t* s_from = smem + TILE;     // output x came from position s_from[x]
  int32_t* s_key = smem + 2 * TILE;  // nkeys x TILE key words
  __shared__ int32_t offs[MAX_RUNS + 1];
  __shared__ int s_corank[2];
  __shared__ int s_copy;

  const int tid = threadIdx.x;
  for (int i = tid; i <= num_runs; i += THREADS) offs[i] = offsets[i];
  __syncthreads();

  // this block's pair and its tile within the pair
  const int pairs = num_runs / (2 * level);
  int tile = blockIdx.x, pair = -1;
  for (int p = 0; p < pairs; ++p) {
    const int len = offs[(2 * p + 2) * level] - offs[2 * p * level];
    const int tiles = (len + TILE - 1) / TILE;
    if (tile < tiles) {
      pair = p;
      break;
    }
    tile -= tiles;
  }
  if (pair < 0) return;
  const int start = offs[2 * pair * level];
  const int mid = offs[(2 * pair + 1) * level];
  const int end = offs[(2 * pair + 2) * level];
  const int na = mid - start, nb = end - mid;
  const int d0 = tile * TILE;
  const int d1 = min(d0 + TILE, end - start);
  const int n = d1 - d0;
  const int out0 = start + d0;

  if (tid == 0)
    s_copy = na == 0 || nb == 0 ||
             before_global<KMAX>(keys, nkeys, n_valid, perm_in, mid - 1, mid);
  __syncthreads();
  if (s_copy) {
    int e[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int x = tid + k * THREADS;
      e[k] = x < n ? elem_at(perm_in, out0 + x) : 0;
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (tid + k * THREADS < n) perm_out[out0 + tid + k * THREADS] = e[k];
    return;
  }

  const int warp = tid >> 5;
  if (warp < 2) {
    const int a = corank_warp<KMAX>(keys, nkeys, n_valid, perm_in, start, na,
                                    mid, nb, warp ? d1 : d0);
    if ((tid & 31) == 0) s_corank[warp] = a;
  }
  __syncthreads();
  const int a0 = s_corank[0];
  const int la = s_corank[1] - a0, lb = n - la;
  const int b0 = d0 - a0;

  // stage: the elements with coalesced reads, then their keys; every
  // load of a batch is predicated, not branched around, so a batch is
  // one round trip to memory
  int e[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int x = tid + k * THREADS;
    e[k] = x < n ? elem_at(perm_in, x < la ? start + a0 + x
                                           : mid + b0 + (x - la))
                 : 0;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (tid + k * THREADS < n) s_elem[tid + k * THREADS] = e[k];
  constexpr int KB = KMAX < 8 ? KMAX : 8;
#pragma unroll
  for (int i0 = 0; i0 < KMAX; i0 += KB) {
    int32_t v[KB][ITEMS];
#pragma unroll
    for (int i = 0; i < KB; ++i)
#pragma unroll
      for (int k = 0; k < ITEMS; ++k)
        v[i][k] = i0 + i < nkeys && tid + k * THREADS < n
                      ? __ldg(keys.col[i0 + i] + e[k])
                      : 0;
#pragma unroll
    for (int i = 0; i < KB; ++i)
#pragma unroll
      for (int k = 0; k < ITEMS; ++k)
        if (i0 + i < nkeys && tid + k * THREADS < n)
          s_key[(i0 + i) * TILE + tid + k * THREADS] = v[i][k];
  }
  __syncthreads();

  // this thread's diagonal, then its ITEMS outputs, the head of each
  // side held in registers
  const int dt = tid * ITEMS;
  if (dt < n) {
    int32_t ka[KMAX], kb[KMAX];
    int lo = max(0, dt - lb), hi = min(dt, la);
    while (lo < hi) {
      const int m = (lo + hi) >> 1;
      const int y = la + dt - m - 1;
      load_shared<KMAX>(s_key, nkeys, m, ka);
      load_shared<KMAX>(s_key, nkeys, y, kb);
      if (compare<KMAX>(s_elem[m], ka, s_elem[y], kb, n_valid) <= 0)
        lo = m + 1;
      else
        hi = m;
    }
    int i = lo, j = dt - lo;
    int ea = i < la ? s_elem[i] : 0, eb = j < lb ? s_elem[la + j] : 0;
    load_shared<KMAX>(s_key, nkeys, i < la ? i : 0, ka);
    load_shared<KMAX>(s_key, nkeys, j < lb ? la + j : 0, kb);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (dt + k >= n) break;
      const bool take_a =
          j >= lb || (i < la && compare<KMAX>(ea, ka, eb, kb, n_valid) <= 0);
      s_from[dt + k] = take_a ? i : la + j;
      i += take_a;
      j += !take_a;
      // the next element of the side just taken replaces its head
      const int next = take_a ? (i < la ? i : 0) : (j < lb ? la + j : 0);
      int32_t kn[KMAX];
      load_shared<KMAX>(s_key, nkeys, next, kn);
      const int en = s_elem[next];
#pragma unroll
      for (int q = 0; q < KMAX; ++q) {
        ka[q] = take_a ? kn[q] : ka[q];
        kb[q] = take_a ? kb[q] : kn[q];
      }
      ea = take_a ? en : ea;
      eb = take_a ? eb : en;
    }
  }
  __syncthreads();
  for (int x = tid; x < n; x += THREADS)
    perm_out[out0 + x] = s_elem[s_from[x]];
}

template <int KMAX>
static int launch_level(const KeyCols& keys, int nkeys,
                        const int32_t* offsets, int num_runs, int cap,
                        int n_valid, int level, const int32_t* perm_in,
                        int32_t* perm_out, cudaStream_t stream) {
  const int smem = (2 + nkeys) * TILE * (int)sizeof(int32_t);
  // at most one partial tile per pair beyond cap / TILE full ones
  const int blocks = (cap + TILE - 1) / TILE + num_runs / (2 * level);
  kway_merge_level<KMAX><<<blocks, THREADS, smem, stream>>>(
      keys, nkeys, offsets, num_runs, n_valid, level, perm_in, perm_out);
  return (int)cudaGetLastError();
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
  const cudaStream_t st = (cudaStream_t)stream;
  // the key words a compare holds in registers: the fewest that fit
  if (nkeys <= 4)
    return launch_level<4>(keys, nkeys, offsets, num_runs, cap, n_valid,
                           level, perm_in, perm_out, st);
  if (nkeys <= 8)
    return launch_level<8>(keys, nkeys, offsets, num_runs, cap, n_valid,
                           level, perm_in, perm_out, st);
  return launch_level<MAX_KEYS>(keys, nkeys, offsets, num_runs, cap, n_valid,
                                level, perm_in, perm_out, st);
}
