"""Device-native decode: a segment's sidecar columns go to the card as
they are stored, and the card filters, merges, dedups and aggregates
them.

Counterpart of horaedb_tpu/ops/device_decode.py.  The sidecar already
stores columns in the device layout (int32 dict codes, int32 epoch
offsets, float32 values; storage/sidecar.py), so for an eligible
aggregate plan an `EncodedSegment`'s columns upload raw (the stored rows
cross, the padding is zeroed on the card) and the card runs, per
segment:

  leaf filter  — the plan's pushed PK-leaf conjunction evaluated in
                 ENCODED space (constants translated on the host with the
                 same ops.filter helpers the host mask uses);
  merge        — rows to (pk, seq, row) order by one of three routes:
                 presorted (a single run, or runs that check sorted), the
                 k-way merge of presorted runs (ops/merge.kway_merge_perm,
                 the hand kernel of csrc/merge_path.cu), or the full
                 multi-key sort (ops/merge.lex_sort, the counted
                 fallback);
  dedup        — keep the last row of each PK run; dropped rows are
                 MASKED (gid -1), never compacted;
  aggregate    — ONE bucket_window_partials launch (csrc/bucket_agg.cu)
                 over the sorted, masked rows: the kernel the host-decode
                 rounds call, so the part has the conventions
                 storage/combine.py folds.

The output is one per-segment part (group_values, bucket_lo, grids), the
shape the host-decode round emits, so the combine and the PartsMemo are
untouched and host decode stays the bit-identity control ([scan.decode]
mode = "host").  Ineligible plans and segments fall back to host decode
with the reason counted in scan_decode_fallback_total:<reason>.  A
kernel that fails on the card raises; nothing falls back from it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from horaedb_tpu_torch.common import deviceprof
from horaedb_tpu_torch.ops import bucket_agg, encode
from horaedb_tpu_torch.ops import filter as filter_ops
from horaedb_tpu_torch.ops import merge as merge_ops
from horaedb_tpu_torch.ops.filter import (
    _const_code_exact,
    _const_code_lower,
    _const_code_upper,
)
from horaedb_tpu_torch.utils import registry, trace_add

# every way a plan or segment can decline the device decode, so an
# operator can tell a misconfigured query from unsupported data
FALLBACK_REASONS = (
    "append_mode",     # BytesMerge needs exact Arrow bytes
    "no_sidecar",      # the plan can't serve from sidecars at all
    "predicate",       # not a device-evaluable PK conjunction
    "parquet",         # this segment fell back to a parquet read
    "encoding",        # a column's encoding has no device decode
    "dtype",           # a column's dtype isn't the device layout
    "budget",          # the segment exceeds [scan.decode] max_upload_bytes
    "range",           # the epoch-to-range shift overflows int32
    "kway_runs",       # a multi-run segment declined the k-way merge (run
                       # boundaries unknown, runs not sorted, too many
                       # runs): it still decodes on the card, by the sort
    "mesh",            # the 1-D segment mesh keeps its own round scheduler
)

_FALLBACKS = registry.counter(
    "scan_decode_fallback_total",
    "aggregate segments/plans that fell back to host decode (or, for "
    "kway_runs, to the device sort), by reason")
_FALLBACK_CHILDREN = {r: _FALLBACKS.labels(reason=r)
                      for r in FALLBACK_REASONS}

# per-segment routing of the device merge: compacted = one run, sorted
# by construction; checked = the host check proved the runs' concat
# sorted; kway = the runs merged by kway_merge_perm
_SORT_SKIPPED = {
    route: registry.counter(
        "scan_decode_sort_skipped_total",
        "device decode dispatches that skipped the full device sort"
    ).labels(route=route)
    for route in ("compacted", "checked", "kway")
}
_SORT_RAN = registry.counter(
    "scan_decode_sorted_total",
    "device decode dispatches that paid the full device sort")

_STAGE_SECONDS = registry.histogram(
    "scan_stage_seconds", "wall seconds per merge-scan plan stage"
).labels(stage="device_decode")
_STAGE_ROWS = registry.counter(
    "scan_stage_rows_total", "rows entering each plan stage"
).labels(stage="device_decode")
_STAGE_BYTES = registry.counter(
    "scan_stage_bytes_total", "bytes entering each plan stage"
).labels(stage="device_decode")
_D2H_BYTES = registry.counter(
    "scan_decode_d2h_bytes_total",
    "bytes of partial grids copied device-to-host by the device decode")


def note_fallback(reason: str) -> None:
    child = _FALLBACK_CHILDREN.get(reason)
    if child is None:  # an unknown reason still counts, labeled verbatim
        child = _FALLBACK_CHILDREN[reason] = _FALLBACKS.labels(
            reason=reason)
    child.inc()
    trace_add(f"decode_fallback_{reason}", 1)


def fallback_counts() -> dict:
    return {r: c.value for r, c in _FALLBACK_CHILDREN.items()}


# ---------------------------------------------------------------------------
# leaf compilation: predicate leaves -> encoded-space ops
# ---------------------------------------------------------------------------

_OP_EQ, _OP_LT, _OP_LE, _OP_GT, _OP_GE, _OP_RANGE, _OP_IN = range(7)
_EDGE_NAMES = {_OP_LT: "lt", _OP_LE: "le", _OP_GT: "gt", _OP_GE: "ge"}

# an In leaf beyond this many resolved codes would compare (capacity x
# k) on the card: host decode instead
_IN_MAX_CODES = 64

# beyond this many presorted runs the merge tree's log2(k) levels stop
# beating the full sort: decline to the sort route (reason kway_runs)
_KWAY_MAX_RUNS = 64


class _EmptyMatch(Exception):
    """A leaf provably matches nothing (an Eq/In constant absent from the
    dictionary): the segment contributes an empty part, no dispatch."""


_I32_LO, _I32_HI = -(2**31), 2**31 - 1


def _exact_i32(c) -> Optional[int]:
    """An equality constant as int32, or None when it can match no code
    (out of range): the host mask's numpy compare yields all-False
    there."""
    c = int(c)
    return c if _I32_LO <= c <= _I32_HI else None


def _thresh_i32(c) -> int:
    """A comparison threshold clamped to int32.  Callers first resolve
    the out-of-range edges where a clamp would NOT compare identically
    (see _numeric_edge); after that, clamping is exact."""
    return int(np.clip(int(c), _I32_LO, _I32_HI))


# what an out-of-int32 numeric threshold means for each comparison: the
# host mask compares unclamped, so a below-range `col > c` is a
# TAUTOLOGY and an above-range `col >= c` matches NOTHING.  "taut" =
# drop the leaf, "empty" = the leaf matches nothing, None = in range
def _numeric_edge(op: int, t: int) -> Optional[str]:
    if t < _I32_LO:
        return {"lt": "empty", "le": "empty",
                "gt": "taut", "ge": "taut"}[_EDGE_NAMES[op]]
    if t > _I32_HI:
        return {"lt": "taut", "le": "taut",
                "gt": "empty", "ge": "empty"}[_EDGE_NAMES[op]]
    return None


def leaf_shape_supported(leaves) -> bool:
    """Plan-level check: every pushed leaf is a type the device program
    evaluates (constants translate per segment, with its encodings)."""
    F = filter_ops
    for leaf in leaves or []:
        if not isinstance(leaf, (F.Eq, F.Lt, F.Le, F.Gt, F.Ge, F.In,
                                 F.TimeRangePred)):
            return False
        if isinstance(leaf, F.In) and len(list(leaf.values)) > _IN_MAX_CODES:
            return False
    return True


def compile_leaves(leaves, encodings) -> tuple[tuple, tuple]:
    """Translate a leaf conjunction into ((column, opcode), ...) and one
    int32 constant array per leaf, in ENCODED space, with the exact
    semantics of ops.filter.eval_predicate's host mask (the dict-code
    Le/Gt asymmetry included).

    Raises _EmptyMatch when a leaf provably matches nothing and
    ValueError when a leaf/encoding pair has no device form."""
    F = filter_ops
    prog: list = []
    consts: list = []
    for leaf in leaves or []:
        enc = encodings.get(leaf.column)
        if enc is None:
            raise ValueError(f"leaf column {leaf.column!r} missing")
        if isinstance(leaf, F.Eq):
            c = _const_code_exact(enc, leaf.value)
            c = None if c is None else _exact_i32(c)
            if c is None:
                raise _EmptyMatch
            prog.append((leaf.column, _OP_EQ))
            consts.append(np.asarray([c], dtype=np.int32))
        elif isinstance(leaf, F.In):
            codes = sorted(ci for ci in (
                _exact_i32(c) for c in (_const_code_exact(enc, v)
                                        for v in leaf.values)
                if c is not None) if ci is not None)
            if not codes:
                raise _EmptyMatch
            prog.append((leaf.column, _OP_IN))
            consts.append(np.asarray(codes, dtype=np.int32))
        elif isinstance(leaf, (F.Lt, F.Le, F.Gt, F.Ge)):
            # dict thresholds are searchsorted indices (in range);
            # numeric out-of-int32 edges resolve before the clamp
            if enc.kind == "dict":
                if isinstance(leaf, F.Lt):
                    op, t = _OP_LT, _const_code_lower(enc, leaf.value)
                elif isinstance(leaf, F.Le):
                    op, t = _OP_LT, _const_code_upper(enc, leaf.value)
                elif isinstance(leaf, F.Gt):
                    op, t = _OP_GE, _const_code_upper(enc, leaf.value)
                else:
                    op, t = _OP_GE, _const_code_lower(enc, leaf.value)
            else:
                if isinstance(leaf, F.Lt):
                    op, t = _OP_LT, _const_code_lower(enc, leaf.value)
                elif isinstance(leaf, F.Le):
                    op, t = _OP_LE, _const_code_upper(enc, leaf.value)
                elif isinstance(leaf, F.Gt):
                    op, t = _OP_GT, _const_code_lower(enc, leaf.value)
                else:
                    op, t = _OP_GE, _const_code_lower(enc, leaf.value)
                if enc.kind == "numeric":
                    edge = _numeric_edge(op, int(t))
                    if edge == "empty":
                        raise _EmptyMatch
                    if edge == "taut":
                        continue  # no constraint: drop the leaf
            prog.append((leaf.column, op))
            consts.append(np.asarray([_thresh_i32(t)], dtype=np.int32))
        elif isinstance(leaf, F.TimeRangePred):
            lo_t = _const_code_lower(enc, leaf.start)
            hi_t = _const_code_lower(enc, leaf.end)
            lo_edge = hi_edge = None
            if enc.kind == "numeric":
                lo_edge = _numeric_edge(_OP_GE, int(lo_t))
                hi_edge = _numeric_edge(_OP_LT, int(hi_t))
            if lo_edge == "empty" or hi_edge == "empty":
                raise _EmptyMatch
            if lo_edge == "taut" and hi_edge == "taut":
                continue
            if lo_edge == "taut":
                prog.append((leaf.column, _OP_LT))
                consts.append(np.asarray([_thresh_i32(hi_t)],
                                         dtype=np.int32))
            elif hi_edge == "taut":
                prog.append((leaf.column, _OP_GE))
                consts.append(np.asarray([_thresh_i32(lo_t)],
                                         dtype=np.int32))
            else:
                prog.append((leaf.column, _OP_RANGE))
                consts.append(np.asarray(
                    [_thresh_i32(lo_t), _thresh_i32(hi_t)],
                    dtype=np.int32))
        else:
            raise ValueError(f"unsupported leaf {type(leaf).__name__}")
    return tuple(prog), tuple(consts)


# ---------------------------------------------------------------------------
# the device program
# ---------------------------------------------------------------------------


def _leaf_mask(col, op: int, c):
    # a one-element constant broadcasts against the column
    if op == _OP_EQ:
        return col == c
    if op == _OP_LT:
        return col < c
    if op == _OP_LE:
        return col <= c
    if op == _OP_GT:
        return col > c
    if op == _OP_GE:
        return col >= c
    if op == _OP_RANGE:
        return (col >= c[0]) & (col < c[1])
    # _OP_IN: a small resolved-code set, compare-broadcast then any
    return (col[:, None] == c[None, :]).any(dim=1)


def _lex_sorted_np(keys: list) -> bool:
    """Whether unpadded encoded columns are already lex-sorted: one
    vectorized compare pass decides whether the card can skip its merge
    (the host twin of read._is_lex_sorted)."""
    n = len(keys[0])
    if n <= 1:
        return True
    still_equal = np.ones(n - 1, dtype=bool)
    for c in keys:
        if bool(np.any(still_equal & (c[:-1] > c[1:]))):
            return False
        still_equal &= c[:-1] == c[1:]
        if not still_equal.any():
            return True
    return True


def decode_rows_core(cols: tuple, n_valid: int, leaf_consts: tuple,
                     run_offsets, *, key_slots: tuple, num_pks: int,
                     group_pos: int, val_slot: int, leaf_prog: tuple,
                     route: str, num_runs: int):
    """decode -> filter -> merge -> dedup over one segment's uploaded
    columns (torch tensors of the padded capacity).  Returns (keys_s,
    gid, val_s, n_rows): rows in (pk, seq, row) order with dropped rows
    masked to gid -1, n_rows the kept rows (a 0-dim tensor).

    `route` picks how rows reach sorted order:
      presorted — they already are (single run / host-checked);
      kway      — kway_merge_perm over the `num_runs` presorted runs
                  bounded by `run_offsets`, then a stable partition that
                  sinks filter-failed rows, so the valid prefix equals
                  the sort route's;
      sorted    — lex_sort by (invalid, keys..., row), the counted
                  fallback."""
    import torch

    cap = cols[0].shape[0]
    dev = cols[0].device
    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = iota < int(n_valid)
    for (slot, op), c in zip(leaf_prog, leaf_consts):
        valid &= _leaf_mask(cols[slot], op, c)

    if route == "presorted":
        # leaf-failed rows cannot split a run (the leaves are PK-only,
        # so an equal-PK run passes or fails whole); padding trails
        valid_s = valid
        keys_s = tuple(cols[i] for i in key_slots)
        val_s = cols[val_slot]
    elif route == "kway":
        perm = merge_ops.kway_merge_perm(
            tuple(cols[i] for i in key_slots[:num_pks + 1]), run_offsets,
            num_runs=num_runs, n_valid=n_valid).long()
        valid_m = valid[perm]
        vpos = valid_m.to(torch.int64).cumsum(0)
        ipos = (~valid_m).to(torch.int64).cumsum(0)
        pos = torch.where(valid_m, vpos - 1, vpos[-1] + ipos - 1)
        # the partition writes through unique indices: deterministic
        part = torch.empty_like(perm).index_put_((pos,), perm)
        valid_s = valid[part]
        keys_s = tuple(cols[i][part] for i in key_slots)
        val_s = cols[val_slot][part]
    else:
        # (invalid, keys..., row): invalid rows sink as a block, and the
        # row index keeps equal-(pk, seq) duplicates in concat order
        operands = [(~valid).to(torch.int32)] \
            + [cols[i] for i in key_slots] + [iota, cols[val_slot]]
        sorted_ops = merge_ops.lex_sort(tuple(operands),
                                        num_keys=2 + len(key_slots))
        valid_s = sorted_ops[0] == 0
        keys_s = sorted_ops[1:1 + len(key_slots)]
        val_s = sorted_ops[-1]
    # keep the last row of each PK run among surviving rows: valid and
    # (last row | next row invalid | a pk differs from the next row);
    # seq orders a run, it never splits one.  For a valid row, "next row
    # invalid" is "validity changes", so one compare of the stacked
    # (pk..., valid) rows against their successors finds every break
    rows = torch.stack(keys_s[:num_pks] + (valid_s.to(torch.int32),))
    brk = torch.ones(cap, dtype=torch.bool, device=dev)
    torch.any(rows[:, :-1] != rows[:, 1:], dim=0, out=brk[:-1])
    kept = valid_s & brk
    gid = torch.where(kept, keys_s[group_pos], -1)
    return keys_s, gid, val_s, kept.sum()


def decode_aggregate(cols: tuple, n_valid: int, leaf_consts: tuple,
                     shift: int, lo: int, total: int, bucket_ms: int,
                     run_offsets, *, key_slots: tuple, num_pks: int,
                     group_pos: int, ts_pos: int, val_slot: int,
                     leaf_prog: tuple, g_pad: int, width: int, which: tuple,
                     route: str = "sorted", num_runs: int = 0):
    """Encoded columns in, partial grids out: decode_rows_core, then ONE
    bucket_window_partials launch over the sorted, masked rows as a
    one-window round (identity remap over g_pad groups, rows past
    n_valid dropped; no kept row sits there on any route).  The
    counterpart of the JAX package's _decode_aggregate_jit.  Returns
    ({field: (g_pad, width)}, kept rows)."""
    import torch

    keys_s, gid, val_s, n_rows = decode_rows_core(
        cols, n_valid, leaf_consts, run_offsets, key_slots=key_slots,
        num_pks=num_pks, group_pos=group_pos, val_slot=val_slot,
        leaf_prog=leaf_prog, route=route, num_runs=num_runs)
    dev = gid.device
    remap = torch.arange(g_pad, dtype=torch.int32, device=dev)[None]
    shift_t, lo_t = (torch.full((1,), v, dtype=torch.int32, device=dev)
                     for v in (shift, lo))
    grids = bucket_agg.bucket_window_partials(
        keys_s[ts_pos][None], gid[None], val_s[None], remap, shift_t, lo_t,
        total, bucket_ms, num_groups=g_pad, width=width, which=which,
        n_valid=n_valid)
    return {k: v[0] for k, v in grids.items()}, n_rows


# ---------------------------------------------------------------------------
# plan / dispatch / finalize
# ---------------------------------------------------------------------------


@dataclass
class DevicePart:
    """A segment's finished aggregate partial from the device decode,
    riding a segment's windows list beside host windows.  `part` is
    (group_values, bucket_lo, grids), what the host-decode round emits,
    or None when the segment provably contributes nothing (an Eq/In
    constant absent from the dictionary)."""

    part: Optional[tuple]
    n_valid: int   # kept rows after filter and dedup
    nbytes: int    # host bytes of the downloaded grids


class DecodeDispatch:
    """One segment's launched dispatch (the card runs it asynchronously);
    finalize() copies the grids to the host and shapes the part."""

    __slots__ = ("outs", "n_rows", "values", "lo", "w_eff", "bucket_ms",
                 "t_dispatch", "upload_bytes", "src_rows")

    def __init__(self, outs, n_rows, values, lo, w_eff, bucket_ms,
                 t_dispatch, upload_bytes, src_rows):
        self.outs = outs
        self.n_rows = n_rows
        self.values = values
        self.lo = lo
        self.w_eff = w_eff
        self.bucket_ms = bucket_ms
        self.t_dispatch = t_dispatch
        self.upload_bytes = upload_bytes
        self.src_rows = src_rows

    def finalize(self) -> DevicePart:
        import torch

        t0 = time.perf_counter()
        g, w = len(self.values), self.w_eff
        # as the host round emits: the real groups and the query-clipped
        # width, sliced on the card and packed with the kept-row count
        # (every field as its 32-bit pattern) into ONE device-to-host
        # copy; window-local last_ts re-based to range_start-relative
        names = list(self.outs)
        host = deviceprof.download(torch.cat(
            [self.outs[f][:g, :w].reshape(-1).view(torch.int32)
             for f in names]
            + [self.n_rows.to(torch.int32).reshape(1)]))
        _D2H_BYTES.inc(int(host.nbytes))
        grids = {}
        for i, f in enumerate(names):
            a = host[i * g * w:(i + 1) * g * w].reshape(g, w)
            grids[f] = a if f == "last_ts" else a.view(np.float32)
        nbytes = sum(int(a.nbytes) for a in grids.values())
        if "last_ts" in grids:
            lt = grids["last_ts"].astype(np.int64)
            grids["last_ts"] = np.where(
                grids["count"] > 0, lt + self.lo * self.bucket_ms, lt)
        part = DevicePart(part=(self.values, self.lo, grids),
                          n_valid=int(host[-1]), nbytes=nbytes)
        observe_decode_stage(self.t_dispatch + (time.perf_counter() - t0),
                             rows=self.src_rows, nbytes=self.upload_bytes)
        return part


def observe_decode_stage(seconds: float, rows: int, nbytes: int) -> None:
    _STAGE_SECONDS.observe(seconds)
    trace_add("stage_device_decode_ms", seconds * 1e3)
    if rows:
        _STAGE_ROWS.inc(rows)
        trace_add("stage_device_decode_rows", rows)
    if nbytes:
        _STAGE_BYTES.inc(nbytes)
        trace_add("stage_device_decode_bytes", nbytes)


@dataclass
class DecodePlan:
    """One segment's dispatch, PLANNED but not on the card yet: every
    gate passed, leaves compiled, route decided, geometry computed."""

    es: object
    cap: int
    shift: int
    lo: int
    local_ok: bool
    use_width: int
    w_eff: int
    g: int
    g_pad: int
    values: object            # the group dictionary (host array)
    upload_names: list
    key_slots: tuple
    num_pks: int
    group_pos: int
    ts_pos: int
    val_slot: int
    leaf_prog: tuple
    consts: tuple             # host int32 arrays, one per leaf
    route: str                # "presorted" | "kway" | "sorted"
    run_offsets: Optional[np.ndarray]
    num_runs: int
    which: tuple
    bucket_ms: int
    num_buckets: int

    @property
    def n_valid(self) -> int:
        # windows-list accounting (DeviceBatch and DevicePart ride the
        # same lists): source rows, before filter and dedup
        return self.es.n

    def static_key(self) -> tuple:
        """Everything that must match for two plans to share one mesh
        decode round: the decode geometry and the leaf-constant shapes
        (their stacks span the round's slots)."""
        return (self.key_slots, self.num_pks, self.group_pos,
                self.ts_pos, self.val_slot, self.leaf_prog,
                tuple(len(c) for c in self.consts), self.route,
                self.num_runs, self.local_ok, len(self.upload_names),
                self.which)


def plan_dispatch(es, spec, pk_names: list, seq_name: str,
                  leaves, max_bytes: int, width: int,
                  pad_capacity) -> "DecodePlan | DevicePart | str":
    """Validate one EncodedSegment against the device program's layout
    and plan its dispatch WITHOUT touching the card.  Returns a
    DecodePlan, a DevicePart (provably empty segment, no dispatch), or a
    fallback reason (the caller counts it and takes the host path)."""
    encs = es.encodings
    # layout gates, cheapest first
    for name in (spec.group_col, spec.ts_col, spec.value_col, seq_name,
                 *pk_names):
        if name not in es.columns:
            return "encoding"
    ts_enc = encs[spec.ts_col]
    if ts_enc.kind not in ("offset", "numeric"):
        return "encoding"
    g_enc = encs[spec.group_col]
    if g_enc.kind != "dict" or g_enc.dictionary is None \
            or len(g_enc.dictionary) == 0:
        return "encoding"  # codes must BE dense ids over a known space
    if es.columns[spec.value_col].dtype != np.float32:
        return "dtype"
    for name in (spec.ts_col, seq_name, *pk_names):
        if es.columns[name].dtype != np.int32:
            return "dtype"
    shift = int(ts_enc.epoch) - spec.range_start
    if abs(shift) >= 2**31:
        return "range"
    cap = pad_capacity(es.n)

    try:
        prog, consts = compile_leaves(leaves, encs)
    except _EmptyMatch:
        return DevicePart(part=None, n_valid=0, nbytes=0)
    except (ValueError, OverflowError):
        return "predicate"

    # upload slots: pk codes, then seq (the dedup order), then any non-PK
    # group/ts column AFTER seq (they only ride along to come back in
    # sorted row order); the value column and leaf-only columns last
    key_names = list(pk_names)
    key_names.append(seq_name)
    for nm in (spec.group_col, spec.ts_col):
        if nm not in key_names:
            key_names.append(nm)
    slot_of: dict = {}
    upload_names: list = []
    for nm in key_names + [spec.value_col] + [c for c, _op in prog]:
        if nm not in slot_of:
            slot_of[nm] = len(upload_names)
            upload_names.append(nm)
    # device-memory admission over the ACTUAL upload set
    if cap * 4 * len(upload_names) > max_bytes:
        return "budget"

    # routing: one run is sorted by construction; several runs pay the
    # one-pass host check; interleaved runs with known boundaries merge
    # on the card; only what neither admits pays the full sort
    route = "sorted"
    run_offsets = None
    num_runs = 0
    key_arrs = [es.columns[nm] for nm in pk_names] + [es.columns[seq_name]]
    if es.source_runs == 1:
        route = "presorted"
        _SORT_SKIPPED["compacted"].inc()
    elif _lex_sorted_np(key_arrs):
        route = "presorted"
        _SORT_SKIPPED["checked"].inc()
    else:
        rl = es.run_lengths
        offs = None
        if rl and 1 < len(rl) <= _KWAY_MAX_RUNS and sum(rl) == es.n:
            offs = np.cumsum(np.asarray((0,) + tuple(rl), dtype=np.int64))
            if not merge_ops.runs_lex_sorted_np(key_arrs, offs):
                offs = None
        if offs is not None:
            route = "kway"
            # the runs and the trailing pad zone as its own run, padded
            # to a power of two with empty runs
            num_runs = 1 << max(1, int(len(rl))).bit_length()
            run_offsets = np.full(num_runs + 1, cap, dtype=np.int32)
            run_offsets[:len(offs)] = offs
            run_offsets[len(rl)] = es.n  # real runs end at n
            _SORT_SKIPPED["kway"].inc()
        else:
            note_fallback("kway_runs")
            _SORT_RAN.inc()
    local_ok = ts_enc.kind == "offset"
    lo = max(0, shift // spec.bucket_ms) if local_ok else 0
    use_width = width if local_ok else spec.num_buckets
    g = len(g_enc.dictionary)
    g_pad = max(8, 1 << (g - 1).bit_length())
    # a segment starting past the grid keeps no column
    w_eff = max(0, min(use_width, spec.num_buckets - lo))
    return DecodePlan(
        es=es, cap=cap, shift=shift, lo=lo, local_ok=local_ok,
        use_width=use_width, w_eff=w_eff, g=g, g_pad=g_pad,
        values=g_enc.dictionary, upload_names=upload_names,
        key_slots=tuple(slot_of[nm] for nm in key_names),
        num_pks=len(pk_names), group_pos=key_names.index(spec.group_col),
        ts_pos=key_names.index(spec.ts_col),
        val_slot=slot_of[spec.value_col],
        leaf_prog=tuple((slot_of[c], op) for c, op in prog),
        consts=consts, route=route, run_offsets=run_offsets,
        num_runs=num_runs, which=spec.which,
        bucket_ms=spec.bucket_ms, num_buckets=spec.num_buckets)


def execute_plan(dp: DecodePlan, device) -> DecodeDispatch:
    """Upload one planned segment to `device` and launch its dispatch."""
    import torch

    es = dp.es
    t0 = time.perf_counter()
    # ONE host-to-device copy per segment: the stored rows of every
    # upload column (float32 as its int32 bits), the leaf constants and
    # the run offsets, packed; the columns' padding is zeroed on the card
    n, k = es.n, len(dp.upload_names)
    tail = list(dp.consts) + ([] if dp.run_offsets is None
                              else [dp.run_offsets])
    flat = encode.to_device(np.concatenate(
        [es.columns[nm].view(np.int32) for nm in dp.upload_names]
        + [np.asarray(t, np.int32) for t in tail]), device)
    padded = torch.zeros((k, dp.cap), dtype=torch.int32, device=device)
    padded[:, :n] = flat[:k * n].view(k, n)
    cols_dev = list(padded.unbind(0))
    cols_dev[dp.val_slot] = cols_dev[dp.val_slot].view(torch.float32)
    pos, tail_dev = k * n, []
    for t in tail:
        tail_dev.append(flat[pos:pos + len(t)])
        pos += len(t)
    consts_dev = tuple(tail_dev[:len(dp.consts)])
    offs_dev = None if dp.run_offsets is None else tail_dev[-1]
    outs, n_rows = decode_aggregate(
        tuple(cols_dev), es.n, consts_dev, dp.shift, dp.lo, dp.num_buckets,
        dp.bucket_ms, offs_dev, key_slots=dp.key_slots, num_pks=dp.num_pks,
        group_pos=dp.group_pos, ts_pos=dp.ts_pos, val_slot=dp.val_slot,
        leaf_prog=dp.leaf_prog, g_pad=dp.g_pad, width=dp.use_width,
        which=dp.which, route=dp.route, num_runs=dp.num_runs)
    return DecodeDispatch(outs=outs, n_rows=n_rows, values=dp.values,
                          lo=dp.lo, w_eff=dp.w_eff, bucket_ms=dp.bucket_ms,
                          t_dispatch=time.perf_counter() - t0,
                          upload_bytes=int(flat.nbytes), src_rows=es.n)


# one worker thread at a time uploads, dispatches and downloads a
# segment: a dispatch is ~40 short torch calls and two copies, and on the
# card four threads dispatching at once took twice the wall of the same
# dispatches one after another (chip_smoke.py, decode_alone)
_DISPATCH_LOCK = threading.Lock()


def prepare_dispatch(es, spec, pk_names: list, seq_name: str, leaves,
                     max_bytes: int, width: int, pad_capacity, device
                     ) -> "DevicePart | str":
    """plan_dispatch, then (under the dispatch lock) execute_plan and
    finalize: the segment's finished part, or a fallback reason."""
    dp = plan_dispatch(es, spec, pk_names, seq_name, leaves, max_bytes,
                       width, pad_capacity)
    if not isinstance(dp, DecodePlan):
        return dp
    with _DISPATCH_LOCK:
        return execute_plan(dp, device).finalize()
