"""Predicate evaluation as row masks.

The reference pushes predicates into DataFusion's FilterExec + parquet
pruning (ref: src/storage/src/read.rs:459-475).  Here a filter never
reshapes data mid-pipeline — it produces a validity mask that the
aggregate consumes (masked rows become gid -1).

Predicates are small host-side trees.  Constants are translated to device
codes using the batch's ColumnEncodings (dictionary lookup / epoch shift)
at evaluation time; a constant absent from a dictionary yields an
all-false (Eq/In) or correct-by-order (range) mask via searchsorted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Union

import numpy as np

from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.ops.encode import ColumnEncoding, DeviceBatch

Predicate = Union["Eq", "Ne", "Lt", "Le", "Gt", "Ge", "In", "And", "Or",
                  "Not", "TimeRangePred"]


@dataclass(frozen=True)
class Eq:
    column: str
    value: Any


@dataclass(frozen=True)
class Ne:
    column: str
    value: Any


@dataclass(frozen=True)
class Lt:
    column: str
    value: Any


@dataclass(frozen=True)
class Le:
    column: str
    value: Any


@dataclass(frozen=True)
class Gt:
    column: str
    value: Any


@dataclass(frozen=True)
class Ge:
    column: str
    value: Any


@dataclass(frozen=True)
class In:
    column: str
    values: Sequence[Any]


@dataclass(frozen=True)
class And:
    children: Sequence[Predicate]


@dataclass(frozen=True)
class Or:
    children: Sequence[Predicate]


@dataclass(frozen=True)
class Not:
    child: Predicate


@dataclass(frozen=True)
class TimeRangePred:
    """[start, end) on a timestamp column — the scan's range predicate."""

    column: str
    start: int
    end: int


def _const_code_exact(enc: ColumnEncoding, value: Any):
    """Device constant for an equality compare; None if it cannot match."""
    if enc.kind == "numeric":
        return value
    if enc.kind == "offset":
        off = int(value) - enc.epoch
        return off if -(2**31) <= off < 2**31 else None
    if enc.kind == "dict":
        idx = np.searchsorted(enc.dictionary, value)
        if idx < len(enc.dictionary) and enc.dictionary[idx] == value:
            return int(idx)
        return None
    raise Error(f"unknown encoding kind: {enc.kind}")


def _const_code_lower(enc: ColumnEncoding, value: Any):
    """Device threshold t such that (col_value < value) == (code < t).

    Works for dict codes because np.unique codes are order-preserving.
    """
    if enc.kind == "numeric":
        return value
    if enc.kind == "offset":
        return int(np.clip(int(value) - enc.epoch, -(2**31), 2**31 - 1))
    if enc.kind == "dict":
        return int(np.searchsorted(enc.dictionary, value, side="left"))
    raise Error(f"unknown encoding kind: {enc.kind}")


def _const_code_upper(enc: ColumnEncoding, value: Any):
    """Device threshold t such that (col_value <= value) == (code < t)."""
    if enc.kind in ("numeric", "offset"):
        return _const_code_lower(enc, value)
    if enc.kind == "dict":
        return int(np.searchsorted(enc.dictionary, value, side="right"))
    raise Error(f"unknown encoding kind: {enc.kind}")


def canonical_predicate_key(pred: Optional[Predicate]) -> str:
    """Complete, deterministic identity string for a predicate tree.

    repr() is NOT sufficient: In.values may be a numpy array whose repr
    elides long contents, so two different predicates could collide.
    Every leaf value is rendered in full here.
    """
    if pred is None:
        return ""
    if isinstance(pred, (And, Or)):
        op = "and" if isinstance(pred, And) else "or"
        inner = " ".join(canonical_predicate_key(c) for c in pred.children)
        return f"({op} {inner})"
    if isinstance(pred, Not):
        return f"(not {canonical_predicate_key(pred.child)})"
    if isinstance(pred, In):
        vals = ",".join(repr(v) for v in list(pred.values))
        return f"(in {pred.column} [{vals}])"
    if isinstance(pred, TimeRangePred):
        return f"(range {pred.column} {pred.start} {pred.end})"
    return f"({type(pred).__name__.lower()} {pred.column} {pred.value!r})"


def predicate_columns(pred: Predicate) -> set[str]:
    """All column names a predicate references."""
    if isinstance(pred, (And, Or)):
        out: set[str] = set()
        for c in pred.children:
            out |= predicate_columns(c)
        return out
    if isinstance(pred, Not):
        return predicate_columns(pred.child)
    return {pred.column}


def to_arrow_expression_with_key(pred: Predicate, allowed: set[str]):
    """Translate the safely-pushable part of a predicate tree into a
    pyarrow compute expression for Parquet row-group pruning + pre-merge
    row filtering (the analogue of the reference's ParquetExec pruning
    predicate, read.rs:442-465).

    Only predicates whose columns are ALL in `allowed` (the primary keys)
    may be pushed: dropping rows by PK removes whole groups, which is
    merge-safe; dropping by value columns would un-shadow older rows.

    The translation computes a sound UPPER BOUND of the predicate: in
    positive polarity an unpushable subterm relaxes to TRUE (so And drops
    it, and an Or containing one becomes unpushable), while under Not the
    child must translate exactly (widening under negation would wrongly
    narrow).  Returns (expr, key): expr is None when the bound
    degenerates to TRUE; key is a complete canonical string of the PUSHED
    subtree (scan-cache identity — pyarrow's own str() elides long isin
    lists, and keying the full predicate would duplicate cache entries
    for predicates sharing one pushed subtree).
    """
    import pyarrow.compute as pc

    TRUE = object()  # sentinel: "no constraint" in positive polarity

    def leaf(p: Predicate):
        if predicate_columns(p) - allowed:
            return None
        f = pc.field(p.column)
        if isinstance(p, Eq):
            return f == p.value
        if isinstance(p, Ne):
            return f != p.value
        if isinstance(p, Lt):
            return f < p.value
        if isinstance(p, Le):
            return f <= p.value
        if isinstance(p, Gt):
            return f > p.value
        if isinstance(p, Ge):
            return f >= p.value
        if isinstance(p, In):
            return f.isin(list(p.values))
        if isinstance(p, TimeRangePred):
            return (f >= p.start) & (f < p.end)
        return None

    def strict(p: Predicate):
        """Exact translation as (expr, key); None if not fully pushable."""
        if isinstance(p, (And, Or)):
            parts = [strict(c) for c in p.children]
            if any(x is None for x in parts):
                return None
            out, key = parts[0]
            for x, k in parts[1:]:
                out = (out & x) if isinstance(p, And) else (out | x)
                key = f"({'and' if isinstance(p, And) else 'or'} {key} {k})"
            return out, key
        if isinstance(p, Not):
            inner = strict(p.child)
            if inner is None:
                return None
            return ~inner[0], f"(not {inner[1]})"
        expr = leaf(p)
        return None if expr is None else (expr, repr(p))

    def upper(p: Predicate):
        """Upper bound as (expr, key); TRUE when nothing constrains."""
        if isinstance(p, And):
            parts = [x for x in (upper(c) for c in p.children) if x is not TRUE]
            if not parts:
                return TRUE
            out, key = parts[0]
            for x, k in parts[1:]:
                out = out & x
                key = f"(and {key} {k})"
            return out, key
        if isinstance(p, Or):
            parts = [upper(c) for c in p.children]
            if any(x is TRUE for x in parts):
                return TRUE  # one unconstrained branch unbounds the union
            out, key = parts[0]
            for x, k in parts[1:]:
                out = out | x
                key = f"(or {key} {k})"
            return out, key
        if isinstance(p, Not):
            inner = strict(p.child)  # exact required under negation
            if inner is None:
                return TRUE
            return ~inner[0], f"(not {inner[1]})"
        expr = leaf(p)
        return TRUE if expr is None else (expr, repr(p))

    result = upper(pred)
    if result is TRUE:
        return None, ""
    return result


def eval_predicate(pred: Predicate, batch: DeviceBatch) -> np.ndarray:
    """Evaluate to a (capacity,) bool mask over a batch of host (numpy)
    columns (padding rows unconstrained — callers AND this with the
    batch validity mask).  Scan windows are host-resident, so predicates
    never force a device round trip."""
    xp = np
    if isinstance(pred, And):
        mask = xp.ones(batch.capacity, dtype=bool)
        for c in pred.children:
            mask = mask & eval_predicate(c, batch)
        return mask
    if isinstance(pred, Or):
        mask = xp.zeros(batch.capacity, dtype=bool)
        for c in pred.children:
            mask = mask | eval_predicate(c, batch)
        return mask
    if isinstance(pred, Not):
        return ~eval_predicate(pred.child, batch)

    col = batch.columns[pred.column]
    enc = batch.encodings[pred.column]

    if isinstance(pred, Eq):
        code = _const_code_exact(enc, pred.value)
        if code is None:
            return xp.zeros(batch.capacity, dtype=bool)
        return col == code
    if isinstance(pred, Ne):
        code = _const_code_exact(enc, pred.value)
        if code is None:
            return xp.ones(batch.capacity, dtype=bool)
        return col != code
    if isinstance(pred, In):
        mask = xp.zeros(batch.capacity, dtype=bool)
        for v in pred.values:
            code = _const_code_exact(enc, v)
            if code is not None:
                mask = mask | (col == code)
        return mask
    if isinstance(pred, Lt):
        return col < _const_code_lower(enc, pred.value)
    if isinstance(pred, Le):
        # dict codes have no "<=" constant: use the right-bisect threshold
        if enc.kind == "dict":
            return col < _const_code_upper(enc, pred.value)
        return col <= _const_code_upper(enc, pred.value)
    if isinstance(pred, Gt):
        if enc.kind == "dict":
            return col >= _const_code_upper(enc, pred.value)
        return col > _const_code_lower(enc, pred.value)
    if isinstance(pred, Ge):
        return col >= _const_code_lower(enc, pred.value)
    if isinstance(pred, TimeRangePred):
        lo = _const_code_lower(enc, pred.start)
        hi = _const_code_lower(enc, pred.end)
        return (col >= lo) & (col < hi)
    raise Error(f"unknown predicate: {pred!r}")
