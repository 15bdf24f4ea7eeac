"""Cross-part aggregate combine of the parts path (a copy of the JAX
package's storage/combine.py, trimmed to what the single-device engine
path needs).

Per-window partial grids (each covering LOCAL buckets [lo, lo + width)
of the query's bucket range) fold on the host, in float64, into the
user-facing (groups, num_buckets) grids:

  sparse combine   parts fold straight into the FINAL output buffers —
                   full-group parts (every window of a scan carries all
                   series) paste as in-place column-slice ops, and
                   finalize converts in place.  The default.
  dense combine    one f64 accumulator set, fancy-indexed
                   read-modify-write per part, then a separate output
                   set: the bit-identity control ([scan.combine]
                   mode = "dense").
  PartsMemo        a byte-bounded per-segment partial memo, keyed by the
                   segment's exact SST set + the range-independent
                   aggregate fingerprint, serves narrowed/refined
                   ranges from prior partials and recomputes only the
                   delta segments.
  top-k pushdown   a TopKSpec folds each group's runs into a SPAN-sized
                   transient, scores it, and materializes only the k
                   winners (combine_top_k): peak materialized output is
                   O(k x buckets) whatever the series cardinality.

Bit-identity contract: for the same parts, sparse and dense give
byte-equal grids — f64 folds run in the same part order with the same
casts, and empty cells read count 0, sum 0, min +inf, max -inf,
avg/last/last_ts NaN.  The fold order and casts are the JAX package's,
so the port's folds equal the reference's for the same parts.

  cluster merge    merge_downsample_results folds per-region downsample
                   results by tsid for the cluster's gather paths.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.storage.scan_cache import ByteLRU
from horaedb_tpu_torch.utils import registry, trace_add

COMBINE_MODES = ("sparse", "dense")

_I64_MIN = np.iinfo(np.int64).min

# combine economics: touched cells (sum of part run cells) against the
# dense output-grid cells, and the output cells actually allocated
_TOUCHED = registry.counter(
    "scan_combine_touched_cells_total",
    "aggregate part cells folded by combine (groups x run width, "
    "summed over parts)")
_GRID = registry.counter(
    "scan_combine_grid_cells_total",
    "dense output-grid cells (groups x buckets) per combine call")
_MATERIALIZED = registry.counter(
    "scan_combine_materialized_cells_total",
    "output cells allocated by combine/finalize (the top-k pushdown "
    "bounds this at k x buckets x aggs)")
_MEMO_HITS = registry.counter(
    "scan_combine_memo_hits_total",
    "delta-summation memo hits (a segment's partials served without "
    "re-scanning)")
_MEMO_MISSES = registry.counter(
    "scan_combine_memo_misses_total", "delta-summation memo misses")
_MEMO_UNCOVERED = registry.counter(
    "scan_combine_memo_uncovered_total",
    "memo entries present but unusable: the new query's grid reaches "
    "buckets the stored partials were clipped away from")
_MEMO_PARTS = registry.counter(
    "scan_combine_memo_parts_served_total",
    "aggregate parts served from the delta-summation memo")


def expand_which(which) -> set:
    """Requested aggregates plus their computation dependencies: avg
    needs sum, count always rides along."""
    want = set(which) | {"count"}
    if "avg" in want:
        want.add("sum")
    return want


def emitted_aggs(which) -> list[str]:
    """Output grid keys for a request, in the canonical emit order."""
    requested = set(which) | {"count"}
    return [k for k in ("count", "sum", "min", "max", "avg", "last",
                        "last_ts")
            if k in requested or (k == "last_ts" and "last" in requested)]


def _empty_result(num_buckets: int, which) -> tuple[np.ndarray, dict]:
    empty = np.zeros((0, num_buckets), dtype=np.float32)
    return np.asarray([]), {k: empty.copy() for k in emitted_aggs(which)}


def _identity_grids(g: int, num_buckets: int, want: set) -> dict:
    """f64 accumulator grids with combine-identity fills, matching the
    partial grids' conventions."""
    acc: dict = {"count": np.zeros((g, num_buckets), dtype=np.float64)}
    if "sum" in want:
        acc["sum"] = np.zeros((g, num_buckets), dtype=np.float64)
    if "min" in want:
        acc["min"] = np.full((g, num_buckets), np.inf, dtype=np.float64)
    if "max" in want:
        acc["max"] = np.full((g, num_buckets), -np.inf, dtype=np.float64)
    if "last" in want:
        acc["last"] = np.zeros((g, num_buckets), dtype=np.float64)
        acc["last_ts"] = np.full((g, num_buckets), _I64_MIN,
                                 dtype=np.int64)
    return acc


def _union_values(parts: list) -> np.ndarray:
    return np.unique(np.concatenate([v for v, _, _ in parts]))


def combine_aggregate_parts(parts: list[tuple[np.ndarray, int, dict]],
                            num_buckets: int,
                            which: tuple = ALL_AGGS
                            ) -> tuple[np.ndarray, dict]:
    """The DENSE fold ([scan.combine] mode = "dense"): one f64
    accumulator set, per-part fancy-indexed read-modify-write, then a
    separate output set built with np.where passes.  Each part is
    (group_values, bucket_lo, grids) with grids covering LOCAL buckets
    [bucket_lo, bucket_lo + width).  `last` combines by latest
    (range-relative) timestamp, the later part winning ties (parts
    arrive in segment/window order)."""
    requested = set(which) | {"count"}
    want = expand_which(requested)
    if not parts:
        return _empty_result(num_buckets, which)
    all_values = _union_values(parts)
    g = len(all_values)
    _GRID.inc(g * num_buckets)
    acc = _identity_grids(g, num_buckets, want)
    for values, lo, p in parts:
        _TOUCHED.inc(len(values) * p["count"].shape[1])
        rows = np.searchsorted(all_values, values)
        width = p["count"].shape[1]
        sl = slice(lo, lo + width)
        acc["count"][rows, sl] += p["count"]
        if "sum" in acc:
            acc["sum"][rows, sl] += p["sum"]
        if "min" in acc:
            acc["min"][rows, sl] = np.minimum(acc["min"][rows, sl],
                                              p["min"])
        if "max" in acc:
            acc["max"][rows, sl] = np.maximum(acc["max"][rows, sl],
                                              p["max"])
        if "last" in acc:
            newer = p["last_ts"].astype(np.int64) >= acc["last_ts"][rows,
                                                                    sl]
            has_data = p["count"] > 0
            take = newer & has_data
            last_rows = acc["last"][rows, sl]
            last_rows[take] = p["last"][take]
            acc["last"][rows, sl] = last_rows
            lt_rows = acc["last_ts"][rows, sl]
            lt_rows[take] = p["last_ts"].astype(np.int64)[take]
            acc["last_ts"][rows, sl] = lt_rows
    empty = acc["count"] == 0
    out = {"count": acc["count"]}
    # sum only when EXPLICITLY requested: it may be present in acc
    # merely as avg's dependency
    if "sum" in acc and "sum" in requested:
        out["sum"] = acc["sum"]
    if "sum" in acc and "avg" in want:
        with np.errstate(invalid="ignore", divide="ignore"):
            out["avg"] = np.where(empty, np.nan,
                                  acc["sum"] / np.maximum(acc["count"], 1))
    # count-0 cells read the +/-inf identities regardless of part
    # coverage, as the fused finalize does
    if "min" in acc:
        out["min"] = np.where(empty, np.inf, acc["min"])
    if "max" in acc:
        out["max"] = np.where(empty, -np.inf, acc["max"])
    if "last" in acc:
        out["last"] = np.where(empty, np.nan, acc["last"])
        out["last_ts"] = np.where(empty, np.nan,
                                  acc["last_ts"].astype(np.float64))
    _MATERIALIZED.inc(g * num_buckets * len(out))
    return all_values, out


def _fold_part(acc: dict, rows, sl: slice, p: dict) -> None:
    """Fold one part into the output buffers.  `rows` is None for a
    FULL part (its group set == the union): the fold is then pure
    in-place column-slice arithmetic.  Subset parts take the same
    fancy-indexed path as the dense fold, so cell values cannot differ
    between the branches."""
    if rows is None:
        acc["count"][:, sl] += p["count"]
        if "sum" in acc:
            acc["sum"][:, sl] += p["sum"]
        if "min" in acc:
            mv = acc["min"][:, sl]
            np.minimum(mv, p["min"], out=mv)
        if "max" in acc:
            xv = acc["max"][:, sl]
            np.maximum(xv, p["max"], out=xv)
        if "last" in acc:
            lt_view = acc["last_ts"][:, sl]
            newer = p["last_ts"].astype(np.int64) >= lt_view
            take = newer & (p["count"] > 0)
            np.copyto(acc["last"][:, sl], p["last"], where=take,
                      casting="same_kind")
            np.copyto(lt_view, p["last_ts"].astype(np.int64), where=take)
        return
    acc["count"][rows, sl] += p["count"]
    if "sum" in acc:
        acc["sum"][rows, sl] += p["sum"]
    if "min" in acc:
        acc["min"][rows, sl] = np.minimum(acc["min"][rows, sl], p["min"])
    if "max" in acc:
        acc["max"][rows, sl] = np.maximum(acc["max"][rows, sl], p["max"])
    if "last" in acc:
        newer = p["last_ts"].astype(np.int64) >= acc["last_ts"][rows, sl]
        take = newer & (p["count"] > 0)
        last_rows = acc["last"][rows, sl]
        last_rows[take] = p["last"][take]
        acc["last"][rows, sl] = last_rows
        lt_rows = acc["last_ts"][rows, sl]
        lt_rows[take] = p["last_ts"].astype(np.int64)[take]
        acc["last_ts"][rows, sl] = lt_rows


def _finalize_in_place(acc: dict, requested: set, want: set) -> dict:
    """Turn fold buffers into the output dict with the dense path's
    cell conventions, in place.  avg divides only where count > 0
    (identical values to sum / max(count, 1) there) and NaNs the
    rest."""
    out = {"count": acc["count"]}
    empty = None
    if "avg" in want or "last" in acc or "min" in acc or "max" in acc:
        empty = acc["count"] == 0
    if "sum" in acc and "sum" in requested:
        out["sum"] = acc["sum"]
    if "sum" in acc and "avg" in want:
        avg = np.empty_like(acc["sum"])
        np.divide(acc["sum"], acc["count"], out=avg, where=~empty)
        avg[empty] = np.nan
        out["avg"] = avg
    if "min" in acc:
        mv = acc["min"]
        mv[empty] = np.inf
        out["min"] = mv
    if "max" in acc:
        xv = acc["max"]
        xv[empty] = -np.inf
        out["max"] = xv
    if "last" in acc:
        last = acc["last"]
        last[empty] = np.nan
        out["last"] = last
        lt = acc["last_ts"].astype(np.float64)
        lt[empty] = np.nan
        out["last_ts"] = lt
    return out


def sparse_combine_parts(parts: list[tuple[np.ndarray, int, dict]],
                         num_buckets: int,
                         which: tuple = ALL_AGGS
                         ) -> tuple[np.ndarray, dict]:
    """The sparse fold ([scan.combine] mode = "sparse", the default):
    parts paste straight into the FINAL output buffers and finalize
    runs in place, so combine allocates exactly ONE grid set.
    Bit-identical to combine_aggregate_parts."""
    requested = set(which) | {"count"}
    want = expand_which(requested)
    if not parts:
        return _empty_result(num_buckets, which)
    all_values = _union_values(parts)
    g = len(all_values)
    _GRID.inc(g * num_buckets)
    acc = _identity_grids(g, num_buckets, want)
    touched = 0
    for values, lo, p in parts:
        width = p["count"].shape[1]
        touched += len(values) * width
        rows = None if len(values) == g else np.searchsorted(all_values,
                                                             values)
        _fold_part(acc, rows, slice(lo, lo + width), p)
    _TOUCHED.inc(touched)
    trace_add("scan_combine_touched_cells", touched)
    trace_add("scan_combine_grid_cells", g * num_buckets)
    out = _finalize_in_place(acc, requested, want)
    _MATERIALIZED.inc(g * num_buckets * len(out))
    trace_add("scan_combine_materialized_cells",
              g * num_buckets * len(out))
    return all_values, out


def combine_parts(parts: list, num_buckets: int, which: tuple = ALL_AGGS,
                  mode: str = "sparse") -> tuple[np.ndarray, dict]:
    """Mode-dispatched combine — the one entry point the reader uses."""
    ensure(mode in COMBINE_MODES,
           f"unknown [scan.combine] mode {mode!r}; expected one of "
           f"{COMBINE_MODES}")
    if mode == "dense":
        return combine_aggregate_parts(parts, num_buckets, which=which)
    return sparse_combine_parts(parts, num_buckets, which=which)


# ---- top-k pushdown --------------------------------------------------------


def _group_membership(parts: list, all_values: np.ndarray
                      ) -> tuple[list[int], list[list]]:
    """Part membership split by shape: full-group parts (every union
    group belongs, local row == union row — the headline scan's common
    shape) as ONE index list, per-group entry lists only for subset
    parts.  Bookkeeping is O(parts + subset cells); expanding full
    parts per group would make it O(groups x parts) — scaling with the
    very cardinality the pushdown exists to bound."""
    g = len(all_values)
    full: list[int] = []
    subset: list[list] = [[] for _ in range(g)]
    for pi, (values, _lo, _p) in enumerate(parts):
        if len(values) == g:
            full.append(pi)
        else:
            for r_local, r in enumerate(
                    np.searchsorted(all_values, values)):
                subset[r].append((pi, int(r_local)))
    return full, subset


def _merged_entries(full: list[int], sub: list, r: int):
    """(part_idx, local_row) pairs for group r in ascending part index
    order — the fold/tie-break order — merged from the full-part
    indices and the group's subset entries."""
    i = j = 0
    while i < len(full) or j < len(sub):
        if j >= len(sub) or (i < len(full) and full[i] < sub[j][0]):
            yield full[i], r
            i += 1
        else:
            yield sub[j]
            j += 1


def _fold_group_span(parts: list, entries,
                     span_lo: int, span_w: int, bufs: dict) -> None:
    """Fold ONE group's runs into span-sized f64 buffers (identity
    -refilled views of reusable full-width scratch), same arithmetic
    and part order as the grid folds (`entries` iterates (part_idx,
    local_row) in ascending part order).  Which aggregates fold is
    encoded by which buffers exist in `bufs`."""
    for name, buf in bufs.items():
        if name == "count" or name == "sum":
            buf[:span_w] = 0.0
        elif name == "min":
            buf[:span_w] = np.inf
        elif name == "max":
            buf[:span_w] = -np.inf
        elif name == "last":
            buf[:span_w] = 0.0
        elif name == "last_ts":
            buf[:span_w] = _I64_MIN
    for pi, r in entries:
        _values, lo, p = parts[pi]
        width = p["count"].shape[1]
        sl = slice(lo - span_lo, lo - span_lo + width)
        bufs["count"][sl] += p["count"][r]
        if "sum" in bufs:
            bufs["sum"][sl] += p["sum"][r]
        if "min" in bufs:
            mv = bufs["min"][sl]
            np.minimum(mv, p["min"][r], out=mv)
        if "max" in bufs:
            xv = bufs["max"][sl]
            np.maximum(xv, p["max"][r], out=xv)
        if "last" in bufs:
            lt_view = bufs["last_ts"][sl]
            newer = p["last_ts"][r].astype(np.int64) >= lt_view
            take = newer & (p["count"][r] > 0)
            np.copyto(bufs["last"][sl], p["last"][r], where=take,
                      casting="same_kind")
            np.copyto(lt_view, p["last_ts"][r].astype(np.int64),
                      where=take)


def _score_deps(by: str) -> set:
    """Buffers a ranking agg needs beyond count."""
    if by == "avg":
        return {"sum"}
    if by == "last":
        return {"last"}  # carries last_ts
    if by == "count":
        return set()
    return {by}


def _full_span(parts: list, full: list[int]) -> Optional[tuple[int, int]]:
    """[lo, hi) bucket span of the full-group parts, computed once —
    every group shares it."""
    if not full:
        return None
    lo = min(parts[pi][1] for pi in full)
    hi = max(parts[pi][1] + parts[pi][2]["count"].shape[1]
             for pi in full)
    return lo, hi


def _group_span(parts: list, fspan: Optional[tuple[int, int]],
                sub: list) -> tuple[int, int]:
    los = [parts[pi][1] for pi, _r in sub]
    his = [parts[pi][1] + parts[pi][2]["count"].shape[1]
           for pi, _r in sub]
    if fspan is not None:
        los.append(fspan[0])
        his.append(fspan[1])
    lo = min(los)
    return lo, max(his) - lo


def rank_top_k(kept_rows: list, scores, tk) -> list:
    """THE top-k ranking: stable argsort over the kept groups' scores
    in ascending group-row order (post-drop sorted order — the dense
    path's tie-break), best first, sliced to k.  Every top-k route
    ranks through it, so their selections cannot drift."""
    score_arr = np.asarray(scores, dtype=np.float64)
    if tk.largest:
        order = np.argsort(-score_arr, kind="stable")
    else:
        order = np.argsort(score_arr, kind="stable")
    return [kept_rows[i] for i in order[:tk.k]]


def _score_buf(bufs: dict, by: str, span_w: int,
               count: np.ndarray) -> np.ndarray:
    """Per-cell ranking values over a group's span, matching the dense
    path's finalized grid cell for cell (only count>0 cells are ever
    read by the score, so avg can divide plainly)."""
    if by == "count":
        return count
    if by == "avg":
        with np.errstate(invalid="ignore", divide="ignore"):
            return bufs["sum"][:span_w] / np.maximum(count, 1)
    return bufs[by][:span_w]


def combine_top_k(parts: list, num_buckets: int, which: tuple,
                  tk) -> tuple[np.ndarray, dict]:
    """Top-k pushdown combine: scores fold per group into a SPAN-sized
    transient, and only the k winners' rows are ever materialized —
    peak output is O(k x buckets x aggs) independent of group
    cardinality.  Bit-identical to dense combine + empty-group drop +
    plan.apply_top_k: same f64 fold order, same score formula
    (best count>0 cell of the ranking grid), same stable tie-break on
    the post-drop sorted group order, rows returned best first."""
    requested = set(which) | {"count"}
    want = expand_which(requested)
    ensure(tk.by in requested or tk.by == "count",
           f"top-k by {tk.by!r} needs that aggregate in the spec's "
           f"`which`; have {sorted(requested)}")
    if not parts:
        return _empty_result(num_buckets, which)
    all_values = _union_values(parts)
    g = len(all_values)
    _GRID.inc(g * num_buckets)
    full, subset = _group_membership(parts, all_values)
    fspan = _full_span(parts, full)
    touched = sum(len(v) * p["count"].shape[1] for v, _lo, p in parts)
    _TOUCHED.inc(touched)
    trace_add("scan_combine_touched_cells", touched)
    trace_add("scan_combine_grid_cells", g * num_buckets)

    # score pass: one reusable full-width scratch per needed buffer
    deps = _score_deps(tk.by)
    score_names = {"count"} | deps | ({"last_ts"} if "last" in deps
                                     else set())
    scratch = {name: np.empty(num_buckets,
                              dtype=np.int64 if name == "last_ts"
                              else np.float64)
               for name in score_names}
    kept_rows: list[int] = []
    scores: list[float] = []
    for r in range(g):
        if not full and not subset[r]:
            continue
        span_lo, span_w = _group_span(parts, fspan, subset[r])
        _fold_group_span(parts, _merged_entries(full, subset[r], r),
                         span_lo, span_w, scratch)
        count = scratch["count"][:span_w]
        has = count > 0
        if not has.any():
            continue  # all-empty group: dropped before ranking,
            # exactly like finalize_aggregate's empty-group cut
        by_vals = _score_buf(scratch, tk.by, span_w, count)
        if tk.largest:
            s = float(np.max(np.where(has, by_vals, -np.inf)))
        else:
            s = float(np.min(np.where(has, by_vals, np.inf)))
        kept_rows.append(r)
        scores.append(s)
    winners = rank_top_k(kept_rows, scores, tk)

    # materialize ONLY the winners, best first.  An all-empty-group
    # result still goes through the identity/finalize pair so dtypes
    # match the dense path's dropped-to-zero-rows grids exactly.
    k_out = len(winners)
    acc = _identity_grids(k_out, num_buckets, want)
    for out_row, r in enumerate(winners):
        for pi, r_local in _merged_entries(full, subset[r], r):
            _values, lo, p = parts[pi]
            row_part = {name: grid[r_local:r_local + 1]
                        for name, grid in p.items()}
            row_acc = {name: grid[out_row:out_row + 1]
                       for name, grid in acc.items()}
            _fold_part(row_acc, None,
                       slice(lo, lo + row_part["count"].shape[1]),
                       row_part)
    out = _finalize_in_place(acc, requested, want)
    _MATERIALIZED.inc(k_out * num_buckets * len(out))
    trace_add("scan_combine_materialized_cells",
              k_out * num_buckets * len(out))
    return all_values[winners], out


class PartsMemo:
    """Byte-bounded per-segment aggregate-partial memo (the delta
    -summation tier).

    Key: the segment's scan-cache identity (segment start + exact SST
    id set + columns + pushdown) plus the RANGE-INDEPENDENT aggregate
    fingerprint (group/ts/value columns, bucket width, bucket PHASE =
    range_start % bucket_ms, requested aggs, canonical predicate).  Any
    write, flush or compaction changes the SST set and misses
    structurally, with no explicit invalidation.

    Value: the segment's combined parts in the recording query's grid
    coordinates, plus that grid's (range_start, num_buckets).  A later
    query with the same phase REBASES: shift each part's bucket_lo by
    the whole-bucket range delta, clip to the new grid, and re-relative
    last_ts — pure slicing, so served parts are bit-identical to a
    recompute (on the card this needs the partial-grid kernel's sum to
    be the same bytes on every launch).  Serving requires the segment's
    overlap with the NEW grid to lie inside the RECORDED grid: a
    widened range reaches buckets the stored parts were clipped away
    from and recomputes.

    Event-loop owned, like the scan cache."""

    def __init__(self, max_bytes: int):
        self.lru = ByteLRU(max_bytes, hits=_MEMO_HITS,
                           misses=_MEMO_MISSES, trace_tier="parts_memo")

    @property
    def enabled(self) -> bool:
        return self.lru.max_bytes > 0

    @staticmethod
    def key(seg_key: tuple, spec, pred_key: str) -> tuple:
        phase = spec.range_start % spec.bucket_ms
        return (seg_key, spec.group_col, spec.ts_col, spec.value_col,
                spec.bucket_ms, phase, spec.which, pred_key)

    def probe(self, seg_key: tuple, seg_start: int, segment_ms: int,
              spec, pred_key: str) -> Optional[list]:
        """Rebased parts for one segment, or None (miss / uncovered)."""
        if not self.enabled:
            return None
        key = self.key(seg_key, spec, pred_key)
        # peek first: an entry that fails the coverage check must NOT
        # count as a hit, so hit/miss is recorded once coverage is known
        entry = self.lru.peek_entry(key)
        if entry is None:
            self.lru.record_miss()
            return None
        old_start = entry["range_start"]
        old_nb = entry["num_buckets"]
        b = spec.bucket_ms
        # same phase (it's in the key), so the range delta is whole
        # buckets and rebasing is exact integer arithmetic
        shift = (old_start - spec.range_start) // b
        b_lo = (seg_start - old_start) // b
        b_hi = (seg_start + segment_ms - 1 - old_start) // b
        lo_i = max(b_lo, -shift)
        hi_i = min(b_hi, -shift + spec.num_buckets - 1)
        if lo_i <= hi_i and (lo_i < 0 or hi_i > old_nb - 1):
            # the new grid reaches buckets outside the recorded grid:
            # stored parts were clipped there — recompute
            _MEMO_UNCOVERED.inc()
            self.lru.record_miss()
            return None
        self.lru.record_hit(key)
        out = []
        delta = old_start - spec.range_start
        for values, lo, p in entry["parts"]:
            nl = lo + shift
            cut = max(0, -nl)
            width = p["count"].shape[1]
            w_eff = min(width - cut, spec.num_buckets - (nl + cut))
            if w_eff <= 0:
                continue
            sl = slice(cut, cut + w_eff)
            grids = {k: v[:, sl] for k, v in p.items() if k != "last_ts"}
            if "last_ts" in p:
                lt = p["last_ts"][:, sl]
                # stored relative to the recording range; re-relative
                # where there is data, keep the sentinel elsewhere
                grids["last_ts"] = np.where(grids["count"] > 0,
                                            lt + delta, lt)
            out.append((values, nl + cut, grids))
        _MEMO_PARTS.inc(len(out))
        trace_add("scan_combine_memo_parts", len(out))
        return out

    def store(self, seg_key: tuple, spec, pred_key: str,
              parts: list) -> None:
        """Record one segment's COMPLETE parts (aggregate_segments
        yields a segment only once all its windows folded).  Parts are
        deep-copied: the originals are views into per-round grid
        stacks, and storing views would pin the whole stack while the
        byte accounting saw only the slice."""
        if not self.enabled:
            return
        copied = []
        nbytes = 0
        for values, lo, p in parts:
            grids = {k: v.copy() for k, v in p.items()}
            values = values.copy()
            nbytes += values.nbytes + sum(v.nbytes
                                          for v in grids.values())
            copied.append((values, lo, grids))
        entry = {"range_start": spec.range_start,
                 "num_buckets": spec.num_buckets, "parts": copied}
        self.lru.put(self.key(seg_key, spec, pred_key), entry,
                     nbytes + 256)

    def clear(self) -> None:
        self.lru.clear()

    def stats(self) -> dict:
        return {"entries": len(self.lru), "bytes": self.lru.total_bytes,
                "max_bytes": self.lru.max_bytes, "hits": self.lru.hits,
                "misses": self.lru.misses}


# ---- cross-region downsample merge (cluster tier) --------------------------


def merge_downsample_results(results: list[dict], num_buckets: int,
                             which: Optional[tuple] = None) -> dict:
    """Merge per-region downsample grids by tsid (the cluster's strict
    and degraded gather paths).  Regions are series-disjoint in steady
    state; during a split's TTL window an overlapping tsid combines
    additively (sum/count/min/max; avg recomputed; `last` takes the
    later sample time).  Allocates only the requested aggs and their
    dependencies — a subset query no longer pays six full grids.

    `which=None` infers the aggregate set from the grids the regions
    actually returned, so the merge follows whatever the fan-out
    requested without a second plumbing path.  When avg must be
    recombined across an overlapping tsid but a region omitted `sum`,
    its sum contribution is reconstructed as avg*count (exact division
    inverse up to one f64 rounding; regions only overlap during a
    split's TTL window)."""
    results = [r for r in results if r["tsids"]]
    if not results:
        return {"tsids": [], "num_buckets": num_buckets, "aggs": {}}
    if which is None:
        which = tuple(sorted({k for r in results for k in r["aggs"]
                              if k in ALL_AGGS}))
    requested = set(which) | {"count"}
    want = expand_which(requested)

    all_tsids = sorted({t for r in results for t in r["tsids"]})
    idx = {t: i for i, t in enumerate(all_tsids)}
    g = len(all_tsids)
    agg: dict = {"count": np.zeros((g, num_buckets))}
    if "sum" in want:
        agg["sum"] = np.zeros((g, num_buckets))
    if "min" in want:
        agg["min"] = np.full((g, num_buckets), np.inf)
    if "max" in want:
        agg["max"] = np.full((g, num_buckets), -np.inf)
    if "last" in want:
        agg["last"] = np.full((g, num_buckets), np.nan)
        agg["last_ts"] = np.full((g, num_buckets), -np.inf)
    for r in results:
        rows = np.asarray([idx[t] for t in r["tsids"]])
        a = r["aggs"]
        counts = np.nan_to_num(np.asarray(a["count"]))
        agg["count"][rows] += counts
        if "sum" in agg:
            if "sum" in a:
                part_sum = np.nan_to_num(np.asarray(a["sum"]))
            else:  # avg-only region: invert the division
                part_sum = np.nan_to_num(np.asarray(a["avg"])) * counts
            agg["sum"][rows] += part_sum
        if "min" in agg and "min" in a:
            agg["min"][rows] = np.fmin(agg["min"][rows],
                                       np.asarray(a["min"]))
        if "max" in agg and "max" in a:
            agg["max"][rows] = np.fmax(agg["max"][rows],
                                       np.asarray(a["max"]))
        if "last" in agg and "last" in a:
            has = counts > 0
            # winner by actual sample time (regions expose last_ts);
            # ties break toward the later region in route order
            cand_ts = np.nan_to_num(
                np.asarray(a["last_ts"], dtype=np.float64), nan=-np.inf)
            take = has & (cand_ts >= agg["last_ts"][rows])
            last_rows = agg["last"][rows]
            last_rows[take] = np.asarray(a["last"])[take]
            agg["last"][rows] = last_rows
            lt_rows = agg["last_ts"][rows]
            lt_rows[take] = cand_ts[take]
            agg["last_ts"][rows] = lt_rows
    empty = agg["count"] == 0
    if "avg" in requested and "sum" in agg:
        with np.errstate(invalid="ignore"):
            agg["avg"] = np.where(empty, np.nan,
                                  agg["sum"] / np.maximum(agg["count"],
                                                          1))
    if "min" in agg:
        agg["min"] = np.where(empty, np.inf, agg["min"])
    if "max" in agg:
        agg["max"] = np.where(empty, -np.inf, agg["max"])
    if "sum" in agg and "sum" not in requested:
        del agg["sum"]  # avg's dependency only — not requested
    return {"tsids": all_tsids, "num_buckets": num_buckets, "aggs": agg}
