// Host-path kernels of horaedb_tpu_torch, with a C ABI loaded through
// ctypes (horaedb_tpu_torch/native/__init__.py): the manifest snapshot
// codec, primary-key run detection for the host merge (the last-value
// operator), SeaHash for metric and series ids, and the batch decode of
// chunk payloads.  The entry points, their arguments and their results
// are those of the JAX package's host library, so either package reads
// what the other writes.
//
// Build: g++ -O3 -fPIC -shared -std=c++17, at first use, into
// horaedb_tpu_torch/build/ (keyed by this file's content).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kSnapshotMagic = 0xCAFE1234u;
constexpr uint8_t kSnapshotVersion = 1;
constexpr size_t kHeaderLen = 14;
constexpr size_t kRecordLen = 32;

inline void put_u32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }
inline void put_u64(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }
inline uint32_t get_u32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t get_u64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }

}  // namespace

extern "C" {

// Mirrors the snapshot record wire layout (little-endian, 32 bytes):
// {id u64, start i64, end i64, size u32, num_rows u32}.
struct SnapshotRecordC {
  uint64_t id;
  int64_t start;
  int64_t end;
  uint32_t size;
  uint32_t num_rows;
};

// Returns bytes written, or -1 if out_cap is too small.
// Layout: 14-byte header {magic u32, version u8, flag u8, length u64} then
// n fixed records.  Only valid on little-endian hosts (x86/ARM servers).
long long snapshot_encode(const SnapshotRecordC* recs, size_t n,
                          uint8_t* out, size_t out_cap) {
  const size_t need = kHeaderLen + n * kRecordLen;
  if (out_cap < need) return -1;
  put_u32(out, kSnapshotMagic);
  out[4] = kSnapshotVersion;
  out[5] = 0;  // flag
  put_u64(out + 6, static_cast<uint64_t>(n * kRecordLen));
  uint8_t* p = out + kHeaderLen;
  for (size_t i = 0; i < n; ++i, p += kRecordLen) {
    put_u64(p, recs[i].id);
    put_u64(p + 8, static_cast<uint64_t>(recs[i].start));
    put_u64(p + 16, static_cast<uint64_t>(recs[i].end));
    put_u32(p + 24, recs[i].size);
    put_u32(p + 28, recs[i].num_rows);
  }
  return static_cast<long long>(need);
}

// Returns record count, or a negative error:
//   -1 truncated header, -2 bad magic, -3 length mismatch,
//   -4 cap too small, -5 unsupported (newer) version,
//   -6 header-only buffer (reference requires record_total_length > 0;
//      an empty snapshot is encoded as zero bytes)
long long snapshot_decode(const uint8_t* buf, size_t len,
                          SnapshotRecordC* out, size_t out_cap) {
  if (len == 0) return 0;
  if (len < kHeaderLen) return -1;
  if (get_u32(buf) != kSnapshotMagic) return -2;
  if (buf[4] > kSnapshotVersion) return -5;
  const uint64_t body = get_u64(buf + 6);
  if (body == 0) return -6;
  if (body != len - kHeaderLen || body % kRecordLen != 0) return -3;
  const size_t n = body / kRecordLen;
  if (out_cap < n) return -4;
  const uint8_t* p = buf + kHeaderLen;
  for (size_t i = 0; i < n; ++i, p += kRecordLen) {
    out[i].id = get_u64(p);
    out[i].start = static_cast<int64_t>(get_u64(p + 8));
    out[i].end = static_cast<int64_t>(get_u64(p + 16));
    out[i].size = get_u32(p + 24);
    out[i].num_rows = get_u32(p + 28);
  }
  return static_cast<long long>(n);
}

// Run-start mask over sorted key columns: out[i] = 1 iff row i differs from
// row i-1 in ANY of the ncols int64 key columns (out[0] = 1 when n > 0).
// Vectorizes under -O3; replaces the per-row scalar compare loop.
void run_starts_i64(const int64_t* const* cols, int ncols, size_t n,
                    uint8_t* out) {
  if (n == 0) return;
  std::memset(out, 0, n);
  out[0] = 1;
  for (int c = 0; c < ncols; ++c) {
    const int64_t* col = cols[c];
    for (size_t i = 1; i < n; ++i) {
      out[i] |= static_cast<uint8_t>(col[i] != col[i - 1]);
    }
  }
}

// Last row index of each run given the run-start mask; returns run count.
size_t run_last_indices(const uint8_t* starts, size_t n, int64_t* out) {
  if (n == 0) return 0;
  size_t k = 0;
  for (size_t i = 1; i < n; ++i) {
    if (starts[i]) out[k++] = static_cast<int64_t>(i) - 1;
  }
  out[k++] = static_cast<int64_t>(n) - 1;
  return k;
}

// ---- SeaHash (v4.x reference semantics) -----------------------------------
// The 64-bit hash the reference specifies for metric/series ids
// (src/metric_engine/src/types.rs uses seahash::hash).  Must produce
// byte-identical results to the pure-Python hash in common/seahash.py
// (tested); the batch entry point hashes many OFFSET-framed keys
// (offsets[i], offsets[i+1]) in one call, so high-cardinality ingest
// pays one FFI hop, not one per key.

namespace {

constexpr uint64_t kSeaK = 0x6EED0E9DA4D94A4Full;
constexpr uint64_t kSeedA = 0x16F11FE89B0D677Cull;
constexpr uint64_t kSeedB = 0xB480A793D8E6C86Cull;
constexpr uint64_t kSeedC = 0x6FE2E5AAF078EBC9ull;
constexpr uint64_t kSeedD = 0x14F994A4C5259381ull;

inline uint64_t sea_diffuse(uint64_t x) {
  x *= kSeaK;
  x ^= (x >> 32) >> (x >> 60);
  return x * kSeaK;
}

inline uint64_t sea_read_tail(const uint8_t* p, size_t len) {
  uint64_t v = 0;
  std::memcpy(&v, p, len);  // little-endian hosts only (x86/ARM LE)
  return v;
}

inline uint64_t seahash_one(const uint8_t* buf, size_t len) {
  uint64_t lanes[4] = {kSeedA, kSeedB, kSeedC, kSeedD};
  size_t i = 0;
  int lane = 0;
  for (; i + 8 <= len; i += 8) {
    uint64_t chunk;
    std::memcpy(&chunk, buf + i, 8);
    lanes[lane] = sea_diffuse(lanes[lane] ^ chunk);
    lane = (lane + 1) & 3;
  }
  if (i < len) {
    uint64_t chunk = sea_read_tail(buf + i, len - i);
    lanes[lane] = sea_diffuse(lanes[lane] ^ chunk);
  }
  uint64_t h = lanes[0] ^ lanes[1] ^ lanes[2] ^ lanes[3];
  return sea_diffuse(h ^ static_cast<uint64_t>(len));
}

}  // namespace

uint64_t seahash64(const uint8_t* buf, size_t len) {
  return seahash_one(buf, len);
}

// Batch: `offsets` has n+1 entries framing n keys inside `buf`
// (key i = buf[offsets[i], offsets[i+1])); hashes land in out[n].
void seahash64_batch(const uint8_t* buf, const int64_t* offsets, size_t n,
                     uint64_t* out) {
  for (size_t i = 0; i < n; ++i) {
    const size_t lo = static_cast<size_t>(offsets[i]);
    const size_t hi = static_cast<size_t>(offsets[i + 1]);
    out[i] = seahash_one(buf + lo, hi - lo);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Chunk codec batch decode (native.decode_chunks_plain states the format).
//
// The RFC's opaque chunk payloads (docs/rfcs/20240827-metric-engine.md:
// 218-231) decode per (series, field) row; a scan touches thousands of
// small chunks, so the per-chunk interpreter overhead of the numpy
// path dominates the chunked cold scan.  This decodes EVERY payload of
// a scan in one call: delta-of-delta timestamps, XOR-mantissa or
// scaled-int-delta values, then per-payload stable sort + last-wins
// timestamp dedup — bit-identical to native.decode_chunks_plain.

namespace {

constexpr uint8_t kChunkMagicV1 = 0xC7;
constexpr uint8_t kChunkMagicV2 = 0xC8;
// v1: magic u8(0) | count u32(1) | ts_base i64(5) -> 13 bytes
constexpr size_t kHeaderV1 = 13;
// v2: magic u8(0) | count u32(1) | base i64(5) | d1 i32(13) |
//     dod_w u8(17) | vmode u8(18) | vp1 u8(19) | vp2 u8(20) |
//     v0 f64(21) -> 29 bytes  (struct "<BIqiBBBBd")
constexpr size_t kHeaderV2 = 29;
constexpr uint32_t kMaxChunkPoints = 1u << 27;

inline int64_t read_i64(const uint8_t* p) {
  int64_t v; std::memcpy(&v, p, 8); return v;
}
inline int32_t read_i32(const uint8_t* p) {
  int32_t v; std::memcpy(&v, p, 4); return v;
}
inline double read_f64(const uint8_t* p) {
  double v; std::memcpy(&v, p, 8); return v;
}

// signed little-endian int of byte width w (1/2/4/8)
inline int64_t read_sint(const uint8_t* p, int w) {
  switch (w) {
    case 1: return static_cast<int8_t>(p[0]);
    case 2: { int16_t v; std::memcpy(&v, p, 2); return v; }
    case 4: { int32_t v; std::memcpy(&v, p, 4); return v; }
    default: { int64_t v; std::memcpy(&v, p, 8); return v; }
  }
}

// low `w` bytes as u64 (little-endian); w in [1, 8]
inline uint64_t read_uint_low(const uint8_t* p, int w) {
  uint64_t v = 0;
  std::memcpy(&v, p, static_cast<size_t>(w));
  return v;
}

// Validate one chunk's header + body length; returns bytes consumed or
// -1 on malformed.  *count_out gets the chunk's point count.  The
// checks mirror the plain decoder's ensures exactly.
long long chunk_span(const uint8_t* p, size_t avail, uint32_t* count_out) {
  if (avail < 1) return -1;
  const uint8_t magic = p[0];
  if (magic == kChunkMagicV1) {
    if (avail < kHeaderV1) return -1;
    uint32_t count; std::memcpy(&count, p + 1, 4);
    if (count < 1 || count > kMaxChunkPoints) return -1;
    const size_t need = kHeaderV1 + size_t(count) * 12;
    if (avail < need) return -1;
    *count_out = count;
    return static_cast<long long>(need);
  }
  if (magic != kChunkMagicV2) return -1;
  if (avail < kHeaderV2) return -1;
  uint32_t count; std::memcpy(&count, p + 1, 4);
  const uint8_t dod_w = p[17], vmode = p[18], vp1 = p[19], vp2 = p[20];
  if (count < 1 || count > kMaxChunkPoints) return -1;
  if (!(dod_w == 0 || dod_w == 1 || dod_w == 2 || dod_w == 4)) return -1;
  if (vmode == 1) {
    if (vp1 > 4 || !(vp2 == 0 || vp2 == 1 || vp2 == 2 || vp2 == 4 ||
                     vp2 == 8)) return -1;
  } else if (vmode == 0) {
    if (vp1 > 7 || vp2 > 8 || vp1 + vp2 > 8) return -1;
  } else {
    return -1;
  }
  const size_t n_dod = count >= 2 ? count - 2 : 0;
  const size_t n_val = count >= 1 ? count - 1 : 0;
  const size_t need = kHeaderV2 + n_dod * dod_w + n_val * vp2;
  if (avail < need) return -1;
  *count_out = count;
  return static_cast<long long>(need);
}

// Decode one pre-validated chunk into ts/val (count points).
void chunk_decode_one(const uint8_t* p, int64_t* ts, double* val) {
  const uint8_t magic = p[0];
  uint32_t count; std::memcpy(&count, p + 1, 4);
  const int64_t base = read_i64(p + 5);
  if (magic == kChunkMagicV1) {
    const uint8_t* deltas = p + kHeaderV1;
    const uint8_t* vals = deltas + size_t(count) * 4;
    for (uint32_t i = 0; i < count; ++i) {
      ts[i] = base + read_i32(deltas + size_t(i) * 4);
      val[i] = read_f64(vals + size_t(i) * 8);
    }
    return;
  }
  const int32_t d1 = read_i32(p + 13);
  const int dod_w = p[17], vmode = p[18], vp1 = p[19], vp2 = p[20];
  const double v0 = read_f64(p + 21);
  const size_t n_dod = count >= 2 ? count - 2 : 0;
  const size_t n_val = count >= 1 ? count - 1 : 0;
  const uint8_t* dod = p + kHeaderV2;
  const uint8_t* body = dod + n_dod * dod_w;

  // timestamps: ts[i+1] = ts[i] + delta[i]; delta[i+1] = delta[i] + dod
  ts[0] = base;
  int64_t t = base, delta = d1;
  for (uint32_t i = 1; i < count; ++i) {
    if (i >= 2) {
      delta += dod_w ? read_sint(dod + size_t(i - 2) * dod_w, dod_w) : 0;
    }
    t += delta;
    ts[i] = t;
  }

  if (vmode == 1) {  // scaled-int deltas
    double scale = 1.0;
    for (int i = 0; i < vp1; ++i) scale *= 10.0;
    // the plain decoder rounds with np.round (half-to-even): nearbyint
    // in the default rounding mode (to-nearest-even) gives the same bits.
    int64_t k = static_cast<int64_t>(__builtin_nearbyint(v0 * scale));
    val[0] = static_cast<double>(k) / scale;
    for (size_t i = 0; i < n_val; ++i) {
      k += vp2 ? read_sint(body + i * vp2, vp2) : 0;
      val[i + 1] = static_cast<double>(k) / scale;
    }
    return;
  }
  // XOR of consecutive f64 bit patterns, shifted/truncated per chunk
  uint64_t bits;
  std::memcpy(&bits, &v0, 8);
  std::memcpy(&val[0], &bits, 8);
  for (size_t i = 0; i < n_val; ++i) {
    const uint64_t x =
        vp2 ? (read_uint_low(body + i * vp2, vp2) << (8 * vp1)) : 0;
    bits ^= x;
    std::memcpy(&val[i + 1], &bits, 8);
  }
}

}  // namespace

extern "C" {

// Pass 1: total decoded point capacity (pre-dedup) across all payloads.
// `offsets` has n+1 entries framing payload i = data[offsets[i],
// offsets[i+1]).  Returns -1 if any payload is malformed.
long long chunk_batch_capacity(const uint8_t* data, const int64_t* offsets,
                               size_t n_payloads) {
  long long total = 0;
  for (size_t i = 0; i < n_payloads; ++i) {
    size_t off = static_cast<size_t>(offsets[i]);
    const size_t end = static_cast<size_t>(offsets[i + 1]);
    while (off < end) {
      uint32_t count = 0;
      const long long used = chunk_span(data + off, end - off, &count);
      if (used < 0) return -1;
      total += count;
      off += static_cast<size_t>(used);
    }
  }
  return total;
}

// Pass 2: decode every payload, then per payload stable-sort by ts and
// keep the LAST point per timestamp (chunks arrive in sequence order —
// the RFC's dedup-by-seq rule, same as native.decode_chunks_plain).  Writes
// surviving points contiguously to ts_out/val_out and each payload's
// survivor count to counts_out.  Returns total points written, or -1
// on malformed input.
long long chunk_batch_decode(const uint8_t* data, const int64_t* offsets,
                             size_t n_payloads, int64_t* ts_out,
                             double* val_out, int64_t* counts_out) {
  long long written = 0;
  for (size_t i = 0; i < n_payloads; ++i) {
    size_t off = static_cast<size_t>(offsets[i]);
    const size_t end = static_cast<size_t>(offsets[i + 1]);
    int64_t* ts = ts_out + written;
    double* val = val_out + written;
    size_t n = 0;
    while (off < end) {
      uint32_t count = 0;
      const long long used = chunk_span(data + off, end - off, &count);
      if (used < 0) return -1;
      chunk_decode_one(data + off, ts + n, val + n);
      n += count;
      off += static_cast<size_t>(used);
    }
    // sorted already? (chunks are internally sorted and usually in
    // window order) — skip the index sort for the common case
    bool sorted = true;
    for (size_t j = 1; j < n; ++j) {
      if (ts[j] < ts[j - 1]) { sorted = false; break; }
    }
    size_t kept;
    if (sorted) {
      // last-wins dedup in place over equal-ts runs
      kept = 0;
      for (size_t j = 0; j < n; ++j) {
        if (j + 1 < n && ts[j + 1] == ts[j]) continue;
        ts[kept] = ts[j];
        val[kept] = val[j];
        ++kept;
      }
    } else {
      std::vector<uint32_t> idx(n);
      for (size_t j = 0; j < n; ++j) idx[j] = static_cast<uint32_t>(j);
      std::stable_sort(idx.begin(), idx.end(),
                       [&](uint32_t a, uint32_t b) { return ts[a] < ts[b]; });
      std::vector<int64_t> st(n);
      std::vector<double> sv(n);
      for (size_t j = 0; j < n; ++j) { st[j] = ts[idx[j]]; sv[j] = val[idx[j]]; }
      kept = 0;
      for (size_t j = 0; j < n; ++j) {
        if (j + 1 < n && st[j + 1] == st[j]) continue;
        ts[kept] = st[j];
        val[kept] = sv[j];
        ++kept;
      }
    }
    counts_out[i] = static_cast<int64_t>(kept);
    written += static_cast<long long>(kept);
  }
  return written;
}

}  // extern "C"
