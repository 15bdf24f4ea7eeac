"""Human-readable durations and the engine wall clock.

Mirrors the reference's `ReadableDuration` ("500ms"/"12h"-style values in
config files, units d/h/m/s/ms in descending order) and `now()` returning
milliseconds since epoch (ref: src/common/src/time_ext.rs:39-217).

Note: the reference's compaction picker mixes this millisecond clock with a
microsecond TTL (picker.rs:57) -- a unit bug SURVEY.md flags; we keep
everything in milliseconds.
"""

from __future__ import annotations

import re
import time

from horaedb_tpu_torch.common.error import Error

_MS_PER_UNIT = {
    "d": 24 * 60 * 60 * 1000,
    "h": 60 * 60 * 1000,
    "m": 60 * 1000,
    "s": 1000,
    "ms": 1,
}

_TOKEN_RE = re.compile(r"(\d+(?:\.\d*)?)(d|h|ms|m|s)")


class ReadableDuration:
    """A duration parsed from / rendered to the "1h30m" config syntax."""

    __slots__ = ("millis",)

    def __init__(self, millis: int):
        if millis < 0:
            raise Error(f"duration must be non-negative, got {millis}")
        self.millis = int(millis)

    @classmethod
    def parse(cls, s: str) -> "ReadableDuration":
        text = s.strip().lower()
        if not text:
            raise Error("empty duration string")
        total = 0.0
        pos = 0
        last_unit_rank = -1
        units = list(_MS_PER_UNIT)
        for m in _TOKEN_RE.finditer(text):
            if m.start() != pos:
                raise Error(f"invalid duration string: {s!r}")
            value, unit = float(m.group(1)), m.group(2)
            rank = units.index(unit)
            if rank <= last_unit_rank:
                # units must appear at most once, in d h m s ms order
                raise Error(f"invalid unit order in duration: {s!r}")
            last_unit_rank = rank
            total += value * _MS_PER_UNIT[unit]
            pos = m.end()
        if pos != len(text):
            raise Error(f"invalid duration string: {s!r}")
        return cls(round(total))

    @classmethod
    def from_millis(cls, millis: int) -> "ReadableDuration":
        return cls(millis)

    @classmethod
    def from_secs(cls, secs: float) -> "ReadableDuration":
        return cls(round(secs * 1000))

    @property
    def seconds(self) -> float:
        return self.millis / 1000.0

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ReadableDuration) and other.millis == self.millis

    def __hash__(self) -> int:
        return hash(self.millis)

    def __repr__(self) -> str:
        return f"ReadableDuration({self})"

    def __str__(self) -> str:
        if self.millis == 0:
            return "0s"
        rem = self.millis
        parts = []
        for unit, ms in _MS_PER_UNIT.items():
            n, rem = divmod(rem, ms)
            if n:
                parts.append(f"{n}{unit}")
        return "".join(parts)


def now_ms() -> int:
    """Wall clock in milliseconds since epoch (ref: time_ext.rs:212-217)."""
    return time.time_ns() // 1_000_000
