"""Framework-wide error type.

The reference uses a single-variant error enum wrapping an arbitrary cause
plus an `ensure!` guard macro (ref: src/common/src/error.rs:18-28,
src/storage/src/macros.rs:35-52).  Python's exception chaining gives us the
anyhow-style context chain for free; `ensure` is the guard helper.
"""

from __future__ import annotations


class Error(Exception):
    """Single framework error; context is carried via `raise ... from e`."""

    @classmethod
    def context(cls, msg: str, cause: BaseException) -> "Error":
        err = cls(msg)
        err.__cause__ = cause
        return err


def ensure(cond: object, msg: str) -> None:
    """Guard helper mirroring the reference's `ensure!` macro."""
    if not cond:
        raise Error(msg)
