"""Minimal proto3 wire-format codec.

The reference's manifest delta files are prost-encoded `ManifestUpdate`
messages (ref: src/pb_types/protos/sst.proto:24-47, manifest/mod.rs:133-137).
Rather than depending on generated bindings we implement the handful of
wire primitives proto3 needs — varints, length-delimited fields, packed
repeated scalars — so our delta files are byte-compatible with prost's
output (proto3 rules: default-valued scalar fields are omitted; repeated
scalars are packed).
"""

from __future__ import annotations

from horaedb_tpu_torch.common.error import Error

WIRE_VARINT = 0
WIRE_LEN = 2

_U64_MASK = (1 << 64) - 1


def encode_varint(value: int, out: bytearray) -> None:
    if value < 0:
        raise Error(f"varint must be non-negative, got {value}")
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return


def decode_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise Error("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            if result > _U64_MASK:
                raise Error("varint overflows u64")
            return result, pos
        shift += 7
        if shift >= 64:
            raise Error("varint too long")


def encode_tag(field_number: int, wire_type: int, out: bytearray) -> None:
    encode_varint((field_number << 3) | wire_type, out)


def decode_tag(buf: bytes, pos: int) -> tuple[int, int, int]:
    tag, pos = decode_varint(buf, pos)
    return tag >> 3, tag & 0x7, pos


def encode_u64_field(field_number: int, value: int, out: bytearray) -> None:
    """uint64 field; proto3 omits zero values."""
    if value == 0:
        return
    encode_tag(field_number, WIRE_VARINT, out)
    encode_varint(value, out)


def encode_i64_field(field_number: int, value: int, out: bytearray) -> None:
    """int64 field; negatives sign-extend to a 10-byte varint."""
    if value == 0:
        return
    encode_tag(field_number, WIRE_VARINT, out)
    encode_varint(value & _U64_MASK, out)


def decode_i64(value: int) -> int:
    """Reinterpret a decoded u64 varint as two's-complement i64."""
    return value - (1 << 64) if value >= (1 << 63) else value


def encode_len_field(field_number: int, payload: bytes, out: bytearray) -> None:
    encode_tag(field_number, WIRE_LEN, out)
    encode_varint(len(payload), out)
    out.extend(payload)


def encode_packed_u64_field(field_number: int, values: list[int], out: bytearray) -> None:
    if not values:
        return
    payload = bytearray()
    for v in values:
        encode_varint(v, payload)
    encode_len_field(field_number, bytes(payload), out)


def skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == WIRE_VARINT:
        _, pos = decode_varint(buf, pos)
        return pos
    if wire_type == WIRE_LEN:
        length, pos = decode_varint(buf, pos)
        if pos + length > len(buf):
            raise Error("truncated length-delimited field")
        return pos + length
    if wire_type == 1:  # 64-bit
        return pos + 8
    if wire_type == 5:  # 32-bit
        return pos + 4
    raise Error(f"unsupported wire type: {wire_type}")


def read_len_payload(buf: bytes, pos: int) -> tuple[bytes, int]:
    length, pos = decode_varint(buf, pos)
    if pos + length > len(buf):
        raise Error("truncated length-delimited field")
    return buf[pos : pos + length], pos + length
