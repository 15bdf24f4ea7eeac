"""SeaHash — the 64-bit hash the reference specifies for metric/series ids
(ref: src/metric_engine/src/types.rs:40-42 uses seahash::hash; RFC
20240827: metric id = hash(name), TSID = hash(sorted labels)).

Pure-Python implementation of the published SeaHash algorithm (v4.x
reference semantics): four lanes seeded with the standard constants,
8-byte little-endian chunks diffused round-robin, finalized by diffusing
the lane XOR with the byte count.  The reference's metric engine never
persisted data (todo!() bodies), so there is no on-disk compatibility
surface — determinism and distribution are what matter.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1
_K = 0x6EED_0E9D_A4D9_4A4F

_SEED_A = 0x16F1_1FE8_9B0D_677C
_SEED_B = 0xB480_A793_D8E6_C86C
_SEED_C = 0x6FE2_E5AA_F078_EBC9
_SEED_D = 0x14F9_94A4_C525_9381


def _diffuse(x: int) -> int:
    x = (x * _K) & _MASK
    x ^= (x >> 32) >> (x >> 60)
    return (x * _K) & _MASK


def hash64(buf: bytes) -> int:
    """Pure-Python SeaHash of `buf` with the default seed (the spec; see
    module docstring)."""
    a, b, c, d = _SEED_A, _SEED_B, _SEED_C, _SEED_D
    n = len(buf)
    i = 0
    while n - i >= 32:
        a = _diffuse(a ^ int.from_bytes(buf[i:i + 8], "little"))
        b = _diffuse(b ^ int.from_bytes(buf[i + 8:i + 16], "little"))
        c = _diffuse(c ^ int.from_bytes(buf[i + 16:i + 24], "little"))
        d = _diffuse(d ^ int.from_bytes(buf[i + 24:i + 32], "little"))
        i += 32
    lanes = [a, b, c, d]
    lane = 0
    while i < n:
        chunk = buf[i:i + 8]
        lanes[lane] = _diffuse(lanes[lane] ^ int.from_bytes(chunk, "little"))
        lane += 1
        i += 8
    a, b, c, d = lanes
    return _diffuse(a ^ b ^ c ^ d ^ n)
