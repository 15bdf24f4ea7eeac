// Time-bucket aggregate of a round of windows, hand-written for Hopper
// (sm_90a): one accumulate core, two epilogues.
//
// Replaces: horaedb_tpu/ops/pallas_kernels.py::_agg_kernel (launched by
// _pallas_partial_grids; entry points pallas_time_bucket_aggregate and
// pallas_window_partials) fused with the window prologue of
// horaedb_tpu/ops/downsample.py::window_local_partials, and, in the
// round epilogue, the whole XLA program
// horaedb_tpu/storage/read.py::_fused_round_accumulate_jit (vmapped
// window partials, then a per-window scatter into the donated
// query-global accumulator).
//
// What the core computes, per window w and row r < n_valid[w]:
//   g  = remap ? (gid < 0 ? -1 : remap[w, clamp(gid, 0, R-1)]) : gid
//   tg = ts + shift[w]                     (int32, wrapping)
//   g  = floor(tg / bucket_ms) < total ? g : -1
//   tl = tg - lo[w] * bucket_ms            (int32, wrapping)
//   b  = floor(tl / bucket_ms)
//   the row counts when 0 <= g < G and 0 <= b < width (and, in the
//   round epilogue, lo[w] + b < total); its window cell is g * width + b.
// Epilogues:
//   partials (horaedb_bucket_window_partials): cell (w, g, b) of W
//     window grids: count, sum, min, max, and `last` = the value at the
//     max tl, the later row winning ties, with last_ts = that tl.  Empty
//     cells read count 0, sum 0, min +inf, max -inf, last 0, last_ts
//     INT32_MIN.  The sum is the same bytes on every launch, whatever
//     the rows' order (see "Ordered sum" below).
//   round (horaedb_bucket_round_accumulate): cell (g, lo[w] + b) of the
//     query-global accumulator (G, total), updated in place; columns at
//     or past `total` are dropped.  count/sum add, min/max fold (the
//     accumulator starts at +/-F32_MAX, so a cell whose only value is
//     +inf keeps min F32_MAX, as in the reference), and `last` takes the
//     round's value where its range-relative ts tg >= the accumulator's
//     (the later round wins ties).
// A NaN value makes its cell's min and max NaN in both epilogues.
//
// Bound: bytes.  Each valid row is read once (ts, gid, value: 12 B), and
// each touched cell is read and written once per field; a handful of
// integer ops per row is far below the card's rate.  At the main path's
// round (16 windows x ~72,000 valid rows of 131,072 slots, 128 groups,
// count+sum) that is ~14 MB in and ~3 MB of accumulator cells: ~5 us
// at 3.35 TB/s.
//
// Design, against that bound:
// - Per-window row counts (n_valid) bound every read: padding slots are
//   never touched, and a block wholly past its window's rows exits.
// - 16-byte loads: each thread reads 4 consecutive rows of each column
//   with one int4/float4 load (scalar loads on a ragged tail).
// - Cheap per-row arithmetic: the window's remap row is staged in shared
//   memory (no dependent global load per row), and the bucket is one
//   floor division by a double reciprocal with an exact correction, the
//   local bucket following from the global one unless int32 wrapped.
// - Run-length reduction in registers: merge-ordered rows (series, then
//   time) put ~6 consecutive rows in one cell.  A thread folds its own 4
//   rows run by run; a segmented warp scan (__shfl_up_sync) carries the
//   run that crosses lanes, and only the lane that ends a run issues its
//   update.  count/sum add; min, max and the `last` key take the max of
//   order-preserving images.  Unsorted rows give runs of length 1 and the
//   same answer.
// - Updates are atomics straight into the destination, one block per
//   tile of rows; the round epilogue writes no partial grid.  After the
//   run-length reduction, merge-ordered rows leave about one atomic per
//   cell and per warp its run spans, to neighbouring addresses.  The
//   engine groups by series, so a cell's rows in a window are one run at
//   any bucket width, and privatising the grid in shared memory (per
//   block, or per window over a cluster's distributed shared memory)
//   measured slower on the rounds real queries send: PERF.md.
// - min/max into float storage use integer atomics on the float bits
//   (atomicMin on the int for a clear sign bit, atomicMax on the
//   unsigned for a set one), which orders floats exactly; in registers
//   they are order-preserving int images.  A NaN
//   enters as 0xFFFFFFFF (min) or 0x7FFFFFFF (max), whose images are
//   INT32_MIN / INT32_MAX: they beat every other value, stay put, and
//   decode back to a NaN.
// - `last` is one 64-bit atomicMax on ((tg or tl) ^ 0x80000000) << 32 |
//   (w * cap + row + 1): max ts, then later window, then later row.  The
//   values live only for the round, so a second short pass over the
//   round's columns gathers each winner and folds it into the
//   accumulator with the reference's `>=`.
//
// Ordered sum.  count, min, max and `last` above are order-free:
// integral float adds below 2^24 and integer atomics.  A float
// atomicAdd sum is not: a cell whose rows span several warps gets one
// add per warp in launch order, so its bytes change from launch to
// launch.  The parts path's PartsMemo promises that a memo-served part
// equals a recompute byte for byte, and the fused replay that a replay
// equals the full path, so both entries sum in integers, whose addition
// is associative:
//   pass 1 (the accumulate core, sum left out) also takes each cell's
//     exponent bound E = max frexp exponent of its finite non-zero
//     values (atomicMax), and ORs NaN / +inf / -inf flags;
//   pass 2 reads the rows again and adds each finite value as the
//     int64 q = rint(v * 2^(B - E)), |q| <= 2^B, run-length reduced
//     like the other fields, with one 64-bit atomicAdd per run; B =
//     62 - bits(the most rows one cell can take), so no cell's sum can
//     overflow;
//   a finish pass turns each cell's q_sum into float(q_sum * 2^(E - B)),
//     or NaN / +-inf where the flags say so (NaN, or +inf with -inf,
//     gives NaN).
// Each value keeps at least B - 24 >= 6 bits below its own last bit
// relative to the cell's largest value, so the sum is at least as close
// to the exact one as a float32 sum in any order, and it is one fixed
// function of the cell's multiset of values.
//   partials: per-cell scratch of the W window grids; a cell takes at
//     most n_valid rows; the finish pass writes the sum.
//   round: per-cell scratch of the round's columns [col0, col0 + span)
//     (G x span cells, like the `last` key); a cell takes at most
//     W x max_rows rows of the round; the finish pass adds the round's
//     sum to the accumulator's float32 with one add.  The rounds of a
//     query run in order on one stream, so the accumulator's sum is one
//     fixed function of each round's rows and the round order.
// The cost is a second read of the rows.  `ordered = 0` keeps the
// one-pass float atomicAdd sum in either entry; only chip_smoke.py asks
// for it, to count its byte patterns and time it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFieldSum = 2;
constexpr int kFieldMin = 4;
constexpr int kFieldMax = 8;
constexpr int kFieldLast = 16;

constexpr int kThreads = 256;         // one tile of rows per block
constexpr int kRowsPerThread = 4;     // 16-byte loads, 4 rows each
constexpr int kTileRows = kThreads * kRowsPerThread;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// exponent images of the ordered sum: E + kExpBias > 0 for a cell with
// a finite non-zero value (frexp exponents lie in [-148, 128]), 0 for
// none; special-value flags
constexpr int kExpBias = 256;
constexpr int kSpecNan = 1;
constexpr int kSpecPosInf = 2;
constexpr int kSpecNegInf = 4;

struct Args {
  const int* ts;
  const int* gid;
  const float* vals;
  const int* remap;
  const int* shift;
  const int* lo;
  const int* n_valid_w;  // per-window row counts, or null: n_valid
  int remap_len, n_valid, cap, num_groups, width, total, bucket_ms, fields;
  int vec;  // 16-byte loads allowed (aligned columns, cap % 4 == 0)
  double inv_bucket;  // 1.0 / bucket_ms
  float* count;
  float* sum;
  float* mn;
  float* mx;
  unsigned long long* key;
  int col0, span;  // round epilogue: the key scratch's columns
  // ordered sum: per-cell exponent images, special flags, int64 sums,
  // and B (cells of the window grids, or of the round's key columns)
  int* ex;
  int* sp;
  long long* isum;
  int sum_bits;
};

// one run's aggregate; mn/mx are order-preserving int images, ex/sp the
// ordered sum's exponent image (max) and special flags (or)
struct Agg {
  float cnt, sum;
  int mn, mx;
  unsigned long long key;
  int ex, sp;
};

// floor(a / b) for b > 0, exactly: a double-precision estimate (off by
// at most one, as a < 2^31 and inv carries 53 bits) and one correction;
// cheaper than the integer division the compiler would emit
__device__ __forceinline__ int floor_div(int a, int b, double inv) {
  int q = (int)floor((double)a * inv);
  const long long r = (long long)a - (long long)q * b;
  if (r < 0)
    --q;
  else if (r >= b)
    ++q;
  return q;
}

// order-preserving int image of a float (an involution): signed int
// comparison of the images matches float comparison
__device__ __forceinline__ int ordered(int bits) {
  return bits >= 0 ? bits : bits ^ 0x7FFFFFFF;
}

// NaN canonicalised to the image that wins the min (INT32_MIN) / the
// max (INT32_MAX); both decode back to a NaN
__device__ __forceinline__ int min_image(float v) {
  return ordered(isnan(v) ? (int)0xFFFFFFFFu : __float_as_int(v));
}
__device__ __forceinline__ int max_image(float v) {
  return ordered(isnan(v) ? 0x7FFFFFFF : __float_as_int(v));
}

// exact float min/max on float storage through integer atomics
__device__ __forceinline__ void atomic_min_bits(float* p, int bits) {
  if (bits >= 0)
    atomicMin(reinterpret_cast<int*>(p), bits);
  else
    atomicMax(reinterpret_cast<unsigned*>(p), (unsigned)bits);
}
__device__ __forceinline__ void atomic_max_bits(float* p, int bits) {
  if (bits >= 0)
    atomicMax(reinterpret_cast<int*>(p), bits);
  else
    atomicMin(reinterpret_cast<unsigned*>(p), (unsigned)bits);
}

__device__ __forceinline__ int key_ts(unsigned long long k) {
  return (int)((unsigned)(k >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int exp_image(float v) {
  if (!isfinite(v) || v == 0.0f) return 0;
  int e;
  frexpf(v, &e);
  return e + kExpBias;
}

__device__ __forceinline__ int special_bits(float v) {
  if (isnan(v)) return kSpecNan;
  if (isinf(v)) return v > 0.0f ? kSpecPosInf : kSpecNegInf;
  return 0;
}

// window cell (g * width + b) of one row, or -1 when the row does not
// count; *t gets the ts that orders `last` (tg for the round, tl for
// partials).  remap_w: the window's remap row (or null: identity).
template <bool kRound>
__device__ __forceinline__ int row_cell(const Args& a, const int* remap_w,
                                        int sh, int lo_w, int g, int ts,
                                        int* t) {
  if (remap_w) {
    const int gi = g < 0 ? 0 : (g >= a.remap_len ? a.remap_len - 1 : g);
    g = g >= 0 ? remap_w[gi] : -1;
  }
  const int tg = (int)((unsigned)ts + (unsigned)sh);
  const int q = floor_div(tg, a.bucket_ms, a.inv_bucket);
  if (q >= a.total) g = -1;
  const int tl = (int)((unsigned)tg - (unsigned)lo_w * (unsigned)a.bucket_ms);
  // floor(tl / bucket_ms) is q - lo_w unless tl wrapped around int32
  const bool wrapped =
      (long long)tl != (long long)tg - (long long)lo_w * a.bucket_ms;
  const int b = wrapped ? floor_div(tl, a.bucket_ms, a.inv_bucket) : q - lo_w;
  *t = kRound ? tg : tl;
  // the group bound is checked BEFORE the cell index is formed: an
  // oversized gid must be dropped, never wrapped into a valid cell
  if (g < 0 || g >= a.num_groups || b < 0 || b >= a.width) return -1;
  if (kRound) {
    const long long c = (long long)lo_w + b;
    if (c < 0 || c >= a.total) return -1;
  }
  return g * a.width + b;
}

// What the accumulate core folds per row and how a run reaches memory.
// An op provides T (one run's aggregate), make (one row's T), combine,
// shfl_up and emit (a run's update straight into the destination).
//
// AggOp: count, sum, min, max, `last`; with kOrd (the ordered sum's
// pass 1) the float sum is left out and the exponent image and special
// flags are taken instead, into the scratch cell k (the window cell for
// partials, the key cell for the round).
template <bool kRound, bool kExtra, bool kOrd>
struct AggOp {
  using T = Agg;
  static constexpr bool kIsRound = kRound;
  const Args& a;
  int w, lo_w;

  __device__ __forceinline__ T make(float v, int t, long long row,
                                    int /*lc*/) const {
    T x;
    x.cnt = 1.0f;
    x.sum = v;
    x.mn = kExtra ? min_image(v) : 0;
    x.mx = kExtra ? max_image(v) : 0;
    x.key = kExtra ? ((unsigned long long)((unsigned)t ^ 0x80000000u)
                      << 32) |
                         (unsigned long long)(row + 1)
                   : 0ull;
    x.ex = kOrd ? exp_image(v) : 0;
    x.sp = kOrd ? special_bits(v) : 0;
    return x;
  }
  static __device__ __forceinline__ T combine(const T& x, const T& y) {
    T r;
    r.cnt = x.cnt + y.cnt;
    r.sum = kOrd ? 0.0f : x.sum + y.sum;
    r.mn = kExtra ? min(x.mn, y.mn) : 0;
    r.mx = kExtra ? max(x.mx, y.mx) : 0;
    r.key = kExtra ? (x.key > y.key ? x.key : y.key) : 0ull;
    r.ex = kOrd ? max(x.ex, y.ex) : 0;
    r.sp = kOrd ? (x.sp | y.sp) : 0;
    return r;
  }
  static __device__ __forceinline__ T shfl_up(const T& x, int off) {
    T r;
    r.cnt = __shfl_up_sync(kFullMask, x.cnt, off);
    r.sum = kOrd ? 0.0f : __shfl_up_sync(kFullMask, x.sum, off);
    r.mn = kExtra ? __shfl_up_sync(kFullMask, x.mn, off) : 0;
    r.mx = kExtra ? __shfl_up_sync(kFullMask, x.mx, off) : 0;
    r.key = kExtra ? __shfl_up_sync(kFullMask, x.key, off) : 0ull;
    r.ex = kOrd ? __shfl_up_sync(kFullMask, x.ex, off) : 0;
    r.sp = kOrd ? __shfl_up_sync(kFullMask, x.sp, off) : 0;
    return r;
  }
  __device__ __forceinline__ void emit(int lc, const T& x) const {
    if (lc < 0) return;
    long long cell, k = -1;
    if (kRound) {
      const int g = lc / a.width;
      const int c = lo_w + (lc - g * a.width);
      cell = (long long)g * a.total + c;
      if (c >= a.col0 && c < a.col0 + a.span)
        k = (long long)g * a.span + (c - a.col0);
    } else {
      cell = (long long)w * a.num_groups * a.width + lc;
      k = cell;
    }
    atomicAdd(a.count + cell, x.cnt);
    if (!kOrd && (a.fields & kFieldSum)) atomicAdd(a.sum + cell, x.sum);
    if (kOrd && k >= 0) {
      if (x.ex) atomicMax(a.ex + k, x.ex);
      if (x.sp) atomicOr(a.sp + k, x.sp);
    }
    if (!kExtra) return;
    if (a.fields & kFieldMin) atomic_min_bits(a.mn + cell, ordered(x.mn));
    if (a.fields & kFieldMax) atomic_max_bits(a.mx + cell, ordered(x.mx));
    if ((a.fields & kFieldLast) && k >= 0) atomicMax(a.key + k, x.key);
  }
};

// SumOp: pass 2 of the ordered sum: each finite value as the int64
// q = rint(v * 2^(B - E)) of its scratch cell's exponent bound E (from
// pass 1), summed exactly.
template <bool kRound>
struct SumOp {
  using T = long long;
  static constexpr bool kIsRound = kRound;
  const Args& a;
  int w, lo_w;

  // scratch cell of window cell lc (partials: the window grid's cell;
  // round: the key cell of accumulator column lo_w + b, or -1 outside
  // the scratch's columns, as in AggOp::emit)
  __device__ __forceinline__ long long scratch_cell(int lc) const {
    if (lc < 0) return -1;
    if (!kRound) return (long long)w * a.num_groups * a.width + lc;
    const int g = lc / a.width;
    const int c = lo_w + (lc - g * a.width);
    if (c < a.col0 || c >= a.col0 + a.span) return -1;
    return (long long)g * a.span + (c - a.col0);
  }
  __device__ __forceinline__ T make(float v, int /*t*/, long long /*row*/,
                                    int lc) const {
    const long long sc = scratch_cell(lc);
    if (sc < 0 || !isfinite(v) || v == 0.0f) return 0;
    // |v| < 2^E for every finite value of the cell, so |q| <= 2^B
    const int e = __ldg(a.ex + sc) - kExpBias;
    return __double2ll_rn(scalbn((double)v, a.sum_bits - e));
  }
  static __device__ __forceinline__ T combine(T x, T y) { return x + y; }
  static __device__ __forceinline__ T shfl_up(T x, int off) {
    return __shfl_up_sync(kFullMask, x, off);
  }
  __device__ __forceinline__ void emit(int lc, T x) const {
    const long long sc = scratch_cell(lc);
    if (sc < 0 || x == 0) return;
    atomicAdd(reinterpret_cast<unsigned long long*>(a.isum) + sc,
              (unsigned long long)x);
  }
};

// The accumulate core over the block's tile of rows starting at tile0
// (blockDim.x * 4 rows): load, cell, run-length reduction, warp scan,
// one op update per run.  Every thread of the block calls it.  The
// fold's structure depends on the rows alone, never on timing.
template <class Op>
__device__ __forceinline__ void accumulate_tile(
    const Args& a, int w, int nv, int tile0, const int* remap_w, int sh,
    int lo_w, const Op& op) {
  using T = typename Op::T;
  const int lane = threadIdx.x & 31;
  const long long base = (long long)w * a.cap;
  const int r0 = tile0 + threadIdx.x * kRowsPerThread;

  int ts4[kRowsPerThread], g4[kRowsPerThread];
  float v4[kRowsPerThread];
  if (a.vec && r0 + kRowsPerThread <= nv) {
#pragma unroll
    for (int q = 0; q < kRowsPerThread; q += 4) {
      const long long r = base + r0 + q;
      const int4 t = __ldg(reinterpret_cast<const int4*>(a.ts + r));
      const int4 g = __ldg(reinterpret_cast<const int4*>(a.gid + r));
      const float4 v = __ldg(reinterpret_cast<const float4*>(a.vals + r));
      ts4[q] = t.x; ts4[q + 1] = t.y; ts4[q + 2] = t.z; ts4[q + 3] = t.w;
      g4[q] = g.x; g4[q + 1] = g.y; g4[q + 2] = g.z; g4[q + 3] = g.w;
      v4[q] = v.x; v4[q + 1] = v.y; v4[q + 2] = v.z; v4[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = r0 + k;
      const bool ok = r < nv;
      ts4[k] = ok ? __ldg(a.ts + base + r) : 0;
      g4[k] = ok ? __ldg(a.gid + base + r) : -1;
      v4[k] = ok ? __ldg(a.vals + base + r) : 0.0f;
    }
  }

  int cell[kRowsPerThread];
  T x[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    int t;
    cell[k] = row_cell<Op::kIsRound>(a, remap_w, sh, lo_w, g4[k], ts4[k],
                                     &t);
    x[k] = op.make(v4[k], t, base + r0 + k, cell[k]);
  }

  // the thread's own rows, run by run: the head run (from its first
  // row) and the tail run (to its last row) may continue in the
  // neighbouring lanes; runs strictly inside are complete
  T head = x[0], run = x[0];
  const int head_cell = cell[0];
  int run_cell = cell[0];
  bool full = true;  // all rows in one run: head == tail
#pragma unroll
  for (int k = 1; k < kRowsPerThread; ++k) {
    if (cell[k] == run_cell) {
      run = Op::combine(run, x[k]);
    } else {
      if (full) {
        head = run;
        full = false;
      } else {
        op.emit(run_cell, run);
      }
      run = x[k];
      run_cell = cell[k];
    }
  }
  const int tail_cell = run_cell;

  // segmented inclusive scan of the tail runs across the warp: a lane
  // whose rows are one run (`open`) joins the run that ends in the lane
  // before it when the cells match
  T s = run;
  bool open = full;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T o = Op::shfl_up(s, off);
    const int o_cell = __shfl_up_sync(kFullMask, tail_cell, off);
    const int o_open = __shfl_up_sync(kFullMask, (int)open, off);
    if (lane >= off) {
      if (open && o_cell == tail_cell) {
        s = Op::combine(o, s);
        open = o_open != 0;
      } else {
        open = false;
      }
    }
  }
  const T carry = Op::shfl_up(s, 1);
  const int prev_cell = __shfl_up_sync(kFullMask, tail_cell, 1);
  const int next_head = __shfl_down_sync(kFullMask, head_cell, 1);
  if (!full)
    op.emit(head_cell, (lane > 0 && prev_cell == head_cell)
                           ? Op::combine(carry, head)
                           : head);
  // the lane that ends a run issues it
  if (lane == 31 || next_head != tail_cell) op.emit(tail_cell, s);
}

__device__ __forceinline__ int window_rows(const Args& a, int w) {
  return a.n_valid_w ? min(max(a.n_valid_w[w], 0), a.cap) : a.n_valid;
}

// window w's remap row, copied into the block's shared memory where it
// fits (every row looks its group up there); every thread calls it
constexpr int kRemapShared = 1024;
__device__ __forceinline__ const int* stage_remap(const Args& a, int w,
                                                  int* s_remap) {
  if (!a.remap) return nullptr;
  const int* row = a.remap + (long long)w * a.remap_len;
  if (a.remap_len > kRemapShared) return row;
  for (int i = threadIdx.x; i < a.remap_len; i += blockDim.x)
    s_remap[i] = __ldg(row + i);
  __syncthreads();
  return s_remap;
}

// one tile of kTileRows rows of window blockIdx.y per block; kPass 0
// is the AggOp pass, kPass 1 the ordered sum's SumOp pass
template <bool kRound, bool kExtra, bool kOrd, int kPass>
__global__ void __launch_bounds__(kThreads) accumulate_kernel(const Args a) {
  const int w = blockIdx.y;
  const int nv = window_rows(a, w);
  const int tile0 = blockIdx.x * kTileRows;
  if (tile0 >= nv) return;  // whole block past the window's rows
  __shared__ int s_remap[kRemapShared];
  const int* remap_w = stage_remap(a, w, s_remap);
  const int lo_w = a.lo ? a.lo[w] : 0;
  const int sh = a.shift ? a.shift[w] : 0;
  if constexpr (kPass == 0) {
    const AggOp<kRound, kExtra, kOrd> op{a, w, lo_w};
    accumulate_tile(a, w, nv, tile0, remap_w, sh, lo_w, op);
  } else {
    const SumOp<kRound> op{a, w, lo_w};
    accumulate_tile(a, w, nv, tile0, remap_w, sh, lo_w, op);
  }
}

// a cell's ordered sum from its exponent image, special flags and int64
// sum: NaN / +-inf where the flags say so, else q_sum * 2^(E - B)
__device__ __forceinline__ float ordered_sum(int ex, int sp, long long q,
                                             int sum_bits) {
  if ((sp & kSpecNan) ||
      (sp & (kSpecPosInf | kSpecNegInf)) == (kSpecPosInf | kSpecNegInf))
    return __int_as_float(0x7FC00000);
  if (sp & kSpecPosInf) return __int_as_float(0x7F800000);
  if (sp & kSpecNegInf) return __int_as_float((int)0xFF800000u);
  return ex ? (float)scalbn((double)q, ex - kExpBias - sum_bits) : 0.0f;
}

__global__ void partials_init_kernel(long long cells, int fields, int ord,
                                     float* count, float* sum, float* mn,
                                     float* mx, unsigned long long* key,
                                     int* ex, int* sp, long long* isum) {
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       c < cells; c += (long long)gridDim.x * blockDim.x) {
    count[c] = 0.0f;
    if (fields & kFieldSum) sum[c] = 0.0f;
    if (fields & kFieldMin) mn[c] = __int_as_float(0x7F800000);  // +inf
    if (fields & kFieldMax) mx[c] = __int_as_float((int)0xFF800000u);
    if (fields & kFieldLast) key[c] = 0ull;
    if (ord) {
      ex[c] = 0;
      sp[c] = 0;
      isum[c] = 0;
    }
  }
}

// partials: each cell's ordered sum (when `ord`) and its winning row ->
// last, last_ts (when `last` is asked)
__global__ void partials_finish_kernel(long long cells, int fields, int ord,
                                       int sum_bits, const int* __restrict__ ex,
                                       const int* __restrict__ sp,
                                       const long long* __restrict__ isum,
                                       float* sum,
                                       const unsigned long long* __restrict__ key,
                                       const float* __restrict__ vals,
                                       float* last, int* last_ts) {
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       c < cells; c += (long long)gridDim.x * blockDim.x) {
    if (ord) sum[c] = ordered_sum(ex[c], sp[c], isum[c], sum_bits);
    if (fields & kFieldLast) {
      const unsigned long long k = key[c];
      last[c] = k ? vals[(k & 0xFFFFFFFFull) - 1] : 0.0f;
      last_ts[c] = k ? key_ts(k) : (int)0x80000000u;
    }
  }
}

// round: each of the round's key cells -> its ordered sum added to the
// accumulator's (one float add, where the round gave the cell a value),
// and its `last` winner folded in where its ts >= the accumulator's
__global__ void round_finish_kernel(long long cells, int span, int col0,
                                    int total, int ord, int sum_bits,
                                    const int* __restrict__ ex,
                                    const int* __restrict__ sp,
                                    const long long* __restrict__ isum,
                                    float* acc_sum,
                                    const unsigned long long* __restrict__ key,
                                    const float* __restrict__ vals,
                                    float* acc_last, int* acc_last_ts) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < cells; i += (long long)gridDim.x * blockDim.x) {
    const long long g = i / span;
    const long long cell = g * total + col0 + (i - g * span);
    if (ord && (ex[i] | sp[i]))
      acc_sum[cell] += ordered_sum(ex[i], sp[i], isum[i], sum_bits);
    if (!key) continue;
    const unsigned long long k = key[i];
    if (!k) continue;
    const int ts = key_ts(k);
    if (ts >= acc_last_ts[cell]) {
      acc_last[cell] = vals[(k & 0xFFFFFFFFull) - 1];
      acc_last_ts[cell] = ts;
    }
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  return (int)(blocks < 1 ? 1 : blocks);
}

int aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// the accumulate core over rows [0, max_rows) of each window, in one
// epilogue (round or partials) and one pass: the float-sum pass, the
// ordered sum's pass 1 (`ord`) or its pass 2 (int64 adds)
enum Pass { kPassFloat, kPassOrd, kPassOrdSum };

template <bool kRound>
int launch_accumulate(const Args& a, Pass pass, int num_windows,
                      int max_rows, cudaStream_t s) {
  if (num_windows <= 0 || max_rows <= 0) return 0;
  if (num_windows > 65535) return (int)cudaErrorInvalidConfiguration;
  const bool extra = (a.fields & (kFieldMin | kFieldMax | kFieldLast)) != 0;
  const dim3 grid((max_rows + kTileRows - 1) / kTileRows, num_windows);
  switch (pass) {
    case kPassFloat:
      if (extra)
        accumulate_kernel<kRound, true, false, 0><<<grid, kThreads, 0, s>>>(a);
      else
        accumulate_kernel<kRound, false, false, 0><<<grid, kThreads, 0, s>>>(a);
      break;
    case kPassOrd:
      if (extra)
        accumulate_kernel<kRound, true, true, 0><<<grid, kThreads, 0, s>>>(a);
      else
        accumulate_kernel<kRound, false, true, 0><<<grid, kThreads, 0, s>>>(a);
      break;
    case kPassOrdSum:
      accumulate_kernel<kRound, false, false, 1><<<grid, kThreads, 0, s>>>(a);
      break;
  }
  return (int)cudaGetLastError();
}

Args make_args(const int* ts, const int* gid, const float* vals,
               const int* remap, int remap_len, const int* shift,
               const int* lo, const int* n_valid_w, int n_valid, int cap,
               int num_groups, int width, int total, int bucket_ms,
               int fields) {
  Args a{};
  a.ts = ts;
  a.gid = gid;
  a.vals = vals;
  a.remap = remap;
  a.remap_len = remap_len;
  a.shift = shift;
  a.lo = lo;
  a.n_valid_w = n_valid_w;
  a.n_valid = n_valid;
  a.cap = cap;
  a.num_groups = num_groups;
  a.width = width;
  a.total = total;
  a.bucket_ms = bucket_ms;
  a.inv_bucket = 1.0 / bucket_ms;
  a.fields = fields;
  a.vec = cap % kRowsPerThread == 0 && aligned16(ts) && aligned16(gid) &&
          aligned16(vals);
  return a;
}

}  // namespace

// Plain C entry points (bound through ctypes).  Pointers are device
// pointers; remap, shift and lo may be null (identity remap, zero
// shift/lo).  Each returns the cudaError_t of the first failing
// launch, 0 on success.

// Partial grids: count, sum, min, max, last float32 and last_ts int32
// outputs of W*G*width cells; key is an int64 scratch of the same cell
// count (only touched when `last` is requested).  With `ordered` and a
// sum asked, ex/sp (int32) and isum (int64) are per-cell scratch of the
// ordered sum and sum_bits its B.  Launches: init, accumulate (twice
// for the ordered sum), and a finish pass for the ordered sum and
// `last`.
extern "C" int horaedb_bucket_window_partials(
    const int* ts, const int* gid, const float* vals, const int* remap,
    int remap_len, const int* shift, const int* lo, int num_windows,
    int cap, int n_valid, int num_groups, int width, int total_buckets,
    int bucket_ms, int fields, float* count, float* sum, float* mn,
    float* mx, float* last, int* last_ts, long long* key, int ordered,
    int* ex, int* sp, long long* isum, int sum_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = (long long)num_windows * num_groups * width;
  if (cells == 0) return 0;
  const int ord = ordered && (fields & kFieldSum);
  unsigned long long* key_u = reinterpret_cast<unsigned long long*>(key);
  Args a = make_args(ts, gid, vals, remap, remap_len, shift, lo, nullptr,
                     n_valid, cap, num_groups, width, total_buckets,
                     bucket_ms, fields);
  a.count = count;
  a.sum = sum;
  a.mn = mn;
  a.mx = mx;
  a.key = key_u;
  a.ex = ex;
  a.sp = sp;
  a.isum = isum;
  a.sum_bits = sum_bits;
  partials_init_kernel<<<grid_for(cells), kThreads, 0, s>>>(
      cells, fields, ord, count, sum, mn, mx, key_u, ex, sp, isum);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_accumulate<false>(a, ord ? kPassOrd : kPassFloat,
                                 num_windows, n_valid, s);
  if (err) return err;
  if (ord) {
    err = launch_accumulate<false>(a, kPassOrdSum, num_windows, n_valid, s);
    if (err) return err;
  }
  if (!ord && !(fields & kFieldLast)) return 0;
  partials_finish_kernel<<<grid_for(cells), kThreads, 0, s>>>(
      cells, fields, ord, sum_bits, ex, sp, isum, sum, key_u, vals, last,
      last_ts);
  return (int)cudaGetLastError();
}

// One round folded into the query-global accumulator (G, total) in
// place.  n_valid_w: per-window row counts (or null: max_rows rows in
// every window); max_rows bounds the launch grid.  scratch: int64 cells
// for the round's columns [col0, col0 + span), zeroed here: G x span of
// `last` keys (when `last` is requested), then, with `ordered` and a
// sum asked, G x span int64 sums and 2 x G x span int32 of exponent
// images and special flags; sum_bits is the ordered sum's B.  Launches:
// accumulate (twice for the ordered sum), and a finish pass for the
// ordered sum and `last`.
extern "C" int horaedb_bucket_round_accumulate(
    const int* ts, const int* gid, const float* vals, const int* remap,
    int remap_len, const int* shift, const int* lo, const int* n_valid_w,
    int num_windows, int cap, int max_rows, int num_groups, int width,
    int total_buckets, int bucket_ms, int fields, float* acc_count,
    float* acc_sum, float* acc_min, float* acc_max, float* acc_last,
    int* acc_last_ts, long long* scratch, int col0, int span, int ordered,
    int sum_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = (long long)num_groups * span;
  if (cells <= 0) return 0;
  const bool want_last = (fields & kFieldLast) != 0;
  const int ord = ordered && (fields & kFieldSum);
  const long long nscratch = (want_last ? cells : 0) + (ord ? 2 * cells : 0);
  unsigned long long* key =
      want_last ? reinterpret_cast<unsigned long long*>(scratch) : nullptr;
  long long* isum = ord ? scratch + (want_last ? cells : 0) : nullptr;
  int* ex = ord ? reinterpret_cast<int*>(isum + cells) : nullptr;
  int* sp = ord ? ex + cells : nullptr;
  if (nscratch) {
    int err = (int)cudaMemsetAsync(scratch, 0, nscratch * sizeof(long long),
                                   s);
    if (err) return err;
  }
  Args a = make_args(ts, gid, vals, remap, remap_len, shift, lo, n_valid_w,
                     max_rows, cap, num_groups, width, total_buckets,
                     bucket_ms, fields);
  a.count = acc_count;
  a.sum = acc_sum;
  a.mn = acc_min;
  a.mx = acc_max;
  a.key = key;
  a.col0 = col0;
  a.span = span;
  a.ex = ex;
  a.sp = sp;
  a.isum = isum;
  a.sum_bits = sum_bits;
  int err = launch_accumulate<true>(a, ord ? kPassOrd : kPassFloat,
                                    num_windows, max_rows, s);
  if (err) return err;
  if (ord) {
    err = launch_accumulate<true>(a, kPassOrdSum, num_windows, max_rows, s);
    if (err) return err;
  }
  if (!ord && !want_last) return 0;
  round_finish_kernel<<<grid_for(cells), kThreads, 0, s>>>(
      cells, span, col0, total_buckets, ord, sum_bits, ex, sp, isum,
      acc_sum, key, vals, acc_last, acc_last_ts);
  return (int)cudaGetLastError();
}
