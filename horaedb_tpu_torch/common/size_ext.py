"""Human-readable byte sizes ("2GB", "512MiB") for config files.

Mirrors the reference's `ReadableSize` (ref: src/common/src/size_ext.rs:27-165):
binary multipliers (KB == KiB == 1024 bytes), optional fractional values,
bare numbers mean bytes.
"""

from __future__ import annotations

import re

from horaedb_tpu_torch.common.error import Error

_UNIT_B = 1
_UNIT_KB = 1024
_UNIT_MB = 1024**2
_UNIT_GB = 1024**3
_UNIT_TB = 1024**4
_UNIT_PB = 1024**5

_SUFFIXES = {
    "": _UNIT_B,
    "b": _UNIT_B,
    "k": _UNIT_KB,
    "kb": _UNIT_KB,
    "kib": _UNIT_KB,
    "m": _UNIT_MB,
    "mb": _UNIT_MB,
    "mib": _UNIT_MB,
    "g": _UNIT_GB,
    "gb": _UNIT_GB,
    "gib": _UNIT_GB,
    "t": _UNIT_TB,
    "tb": _UNIT_TB,
    "tib": _UNIT_TB,
    "p": _UNIT_PB,
    "pb": _UNIT_PB,
    "pib": _UNIT_PB,
}

_SIZE_RE = re.compile(r"^\s*(\d+(?:\.\d*)?)\s*([a-z]*)\s*$")


class ReadableSize:
    __slots__ = ("bytes",)

    def __init__(self, num_bytes: int):
        if num_bytes < 0:
            raise Error(f"size must be non-negative, got {num_bytes}")
        self.bytes = int(num_bytes)

    @classmethod
    def parse(cls, s: str) -> "ReadableSize":
        m = _SIZE_RE.match(s.lower())
        if m is None:
            raise Error(f"invalid size string: {s!r}")
        value, suffix = float(m.group(1)), m.group(2)
        if suffix not in _SUFFIXES:
            raise Error(f"unknown size suffix in: {s!r}")
        return cls(round(value * _SUFFIXES[suffix]))

    @classmethod
    def kb(cls, n: int) -> "ReadableSize":
        return cls(n * _UNIT_KB)

    @classmethod
    def mb(cls, n: int) -> "ReadableSize":
        return cls(n * _UNIT_MB)

    @classmethod
    def gb(cls, n: int) -> "ReadableSize":
        return cls(n * _UNIT_GB)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ReadableSize) and other.bytes == self.bytes

    def __hash__(self) -> int:
        return hash(self.bytes)

    def __repr__(self) -> str:
        return f"ReadableSize({self})"

    def __str__(self) -> str:
        for suffix, unit in (("PB", _UNIT_PB), ("TB", _UNIT_TB), ("GB", _UNIT_GB),
                             ("MB", _UNIT_MB), ("KB", _UNIT_KB)):
            if self.bytes >= unit and self.bytes % unit == 0:
                return f"{self.bytes // unit}{suffix}"
        return f"{self.bytes}B"
