"""Merge-scan read path — the north-star pipeline (PyTorch port).

Per time segment (ref: src/storage/src/read.rs:429-494):

  SegmentRead (host, async)  — tier-2 encoded parts first
                               (storage/encoded_cache.py), then the
                               missing SSTs' sidecars (block-pruned under
                               a selective label filter), parquet when a
                               sidecar is missing or invalid (stats-pruned
                               row groups); a segment over the stream
                               threshold is read window by window
  Merge (host, numpy)        — k-way-merge permutation over the
                               pre-sorted SST runs + keep-last dedup,
                               cut into PK-range windows
  Filter (host mask)         — predicate tree -> row mask (gid -1)
  Aggregate (device), one of two paths (fused_aggregate_ok decides):
    fused  — rounds of windows are stacked on the device; each round is
             ONE bucket_round_accumulate call that folds its rows
             straight into a query-global accumulator; only the final
             grids leave the device.  Two-phase: every window is
             collected (pinned in host RAM) before the first round runs.
    parts  — segments stream through rounds of ONE
             bucket_window_partials call each; the round's partial
             grids come to the host once and fold in float64 in
             storage/combine.py (sparse or dense), behind a per-segment
             partial memo (PartsMemo) that serves narrowed ranges.

The fused path's round stacks live in a byte-bounded device LRU (the
stack cache, the scan cache's budget) in two entries per round: the
range-independent columns (ts, gid, val, n_valid) keyed by the round's
window objects, and the range-dependent remap/shift/lo (KBs).  Each
entry holds weak references to its windows and is dropped when they
are gone.  On a CUDA reader the columns are stacked from per-window
device copies memoized on the window, so a query over another
bucket-aligned range uploads only the small arrays (a range that cuts
a segment takes a time leaf, which keys those memos anew).  The parts
path builds its rounds uncached: its plans outgrow the byte bound.  A
completed fused query records its rounds (the fused replay cache, weak
references only): an identical repeat re-runs init -> rounds ->
finalize from the cached stacks in one pool dispatch, with no read, no
prep and no upload; any eviction, dead window or changed SST set takes
the full path and is counted.  drop_hbm_state() empties every
device-side tier and keeps the host windows.

Device decode ([scan.decode], ops/device_decode.py): on the parts path,
an eligible plan sends each sidecar segment's ENCODED columns to the
card raw, where leaf filter, merge, keep-last dedup and one
bucket_window_partials launch replace the host merge, the window cut and
the round stacks; the segment comes back as one finished part.  Mode
"auto" engages on a CUDA reader for the plans the fused gate declines;
"host" keeps host decode everywhere, the bit-identity control.

Cold reads run through the bounded pipeline (storage/pipeline.py):
store fetches, the per-segment decode and the device rounds overlap,
with at most `[scan.pipeline] depth` segments and `inflight_bytes` of
host memory in flight; a scan with no store I/O (every segment
tier-2 resident) and `enabled = false` take the sequential pump, with
bit-identical results.

Row scans decode the merged windows back to Arrow on the host.  Post-
merge host windows are cached per segment (storage/scan_cache.py), so a
repeat query skips the read and the merge; per-SST encoded parts are
cached under them (tier 2), admitted at write time.

Append tables (the chunked data layout) take a host path instead: each
segment's rows read from parquet (never sidecars: BytesMerge needs the
exact Arrow bytes), sorted by (PK, __seq__) and merged by the
BytesMerge operator, uncached; a streamed Append segment merges window
by window and re-resolves its SSTs after a compaction race mid-segment.
Aggregate plans consult the near-data router (scanagent/client.py)
first: covered segments' partials come from their agents while the
local pump scans the rest, and a failed agent segment falls back to the
local pump.  Deadline checkpoints sit between segments and windows, the
tenant scan-byte quota is charged where stage bytes are attributed, and
the reader's caches are memory-ledger accounts.

Meshes (parallel/): `[scan] mesh_devices = N` runs the 1-D segment
mesh — window rounds of N slots through sharded_remap_partials, and
under HORAEDB_MERGE_IMPL=device_sort the windows' merge as
sharded_merge_dedup rounds; `[scan.mesh]` runs the 2-D (time, series)
scan mesh — rounds of time-axis width through mesh_run_partials with the
segmented combine on the mesh, eligible decode plans deferred into
mesh_decode_partials rounds, and top-k queries through the
device-scored, winner-sliced two-pass route.  A round the mesh cannot
serve exactly falls back to the single-device kernel for a counted
reason (scan_mesh_fallback_total{reason}).  Not ported: the device
scalar cache (_scalar_cache), since the port passes the bucket count
and width to the kernel as host ints, so a replay has no scalar to
upload.
"""

from __future__ import annotations

import asyncio
import functools
import logging
import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass
from dataclasses import replace as dc_replace
from typing import AsyncIterator, Optional

import numpy as np
import pyarrow as pa

from horaedb_tpu_torch.common import deviceprof
from horaedb_tpu_torch.common.deadline import checkpoint as deadline_checkpoint
from horaedb_tpu_torch.common.error import Error, ensure
from horaedb_tpu_torch.common.memledger import ledger as memledger
from horaedb_tpu_torch.common.tenant import charge_scan_bytes
from horaedb_tpu_torch.objstore import NotFoundError, ObjectStore
from horaedb_tpu_torch.ops import bucket_agg, device_decode, encode
from horaedb_tpu_torch.ops import filter as filter_ops
from horaedb_tpu_torch.ops import merge as merge_ops
from horaedb_tpu_torch.ops.downsample import (ALL_AGGS, canonical_which,
                                              mean)
from horaedb_tpu_torch.storage import combine as combine_mod
from horaedb_tpu_torch.storage import parquet_io, sidecar
from horaedb_tpu_torch.storage.config import StorageConfig, UpdateMode
from horaedb_tpu_torch.storage.encoded_cache import EncodedSegmentCache
from horaedb_tpu_torch.storage.scan_cache import (
    MEMO_SLOTS,
    ScanCache,
    segment_cache_key,
)
from horaedb_tpu_torch.storage.sst import SstFile, segment_of, sst_path
from horaedb_tpu_torch.storage.types import (
    RESERVED_COLUMN_NAME,
    SEQ_COLUMN_NAME,
    StorageSchema,
    TimeRange,
)
from horaedb_tpu_torch.utils import active_trace, registry, trace_add
from horaedb_tpu_torch.utils.tracing import record_interval

logger = logging.getLogger(__name__)

_SCAN_LATENCY = registry.histogram(
    "storage_scan_seconds", "merge-scan latency per segment")
_ROWS_SCANNED = registry.counter(
    "storage_rows_scanned_total", "rows produced by merge-scan")
# one labeled family per unit (stage= label); per-query attribution
# additionally lands on the ambient trace through _observe_stage
_STAGE_SECONDS = {
    s: registry.histogram("scan_stage_seconds",
                          "wall seconds per merge-scan plan stage"
                          ).labels(stage=s)
    for s in ("segment_read", "sidecar_read", "parquet_read", "merge",
              "stack_build", "device_aggregate", "mesh_aggregate",
              "combine", "window_prep", "fused_finish")
}
# rows and bytes of the segment reads by source: sidecar (tier 2 or the
# store) or parquet; a read's seconds go to segment_read and to its
# source's stage.  Rows entering the merge, bytes of built stacks.
_STAGE_ROWS = {
    s: registry.counter("scan_stage_rows_total",
                        "rows entering each plan stage").labels(stage=s)
    for s in ("sidecar_read", "parquet_read", "merge")
}
_STAGE_BYTES = {
    s: registry.counter("scan_stage_bytes_total",
                        "bytes entering each plan stage").labels(stage=s)
    for s in ("sidecar_read", "parquet_read", "stack_build")
}


def _observe_stage(stage: str, t0_ns: int,
                   t1_ns: Optional[int] = None) -> None:
    """Attribute the interval [t0_ns, t1_ns or now) of
    time.perf_counter_ns() to a plan stage: the cumulative registry
    histogram and, when a request trace is ambient, its profile and
    its span timeline."""
    if t1_ns is None:
        t1_ns = time.perf_counter_ns()
    record_interval(stage, t0_ns, t1_ns, _STAGE_SECONDS[stage])
    trace_add(f"stage_{stage}_ms", (t1_ns - t0_ns) / 1e6)


# plan_stage_snapshot's stages: the JAX package's snapshot keys
# (encode_merge is the port's merge stage), then the port's own
_SNAPSHOT_STAGES = ("parquet_read", "sidecar_read", "encode_merge",
                    "stack_build", "device_decode", "device_aggregate",
                    "mesh_aggregate", "combine", "segment_read", "merge")
_SNAPSHOT_ROWS = ("parquet_read", "sidecar_read", "encode_merge",
                  "device_decode", "merge")
_SNAPSHOT_BYTES = ("parquet_read", "sidecar_read", "stack_build",
                   "device_decode")


def plan_stage_snapshot() -> dict:
    """Cumulative per-stage numbers; diff two snapshots to attribute a
    query's time (the bench's cold-path profile).

    The keys are the JAX package's (`{stage}_s`, `{stage}_calls`,
    `{stage}_rows`, `{stage}_bytes`, and `pipeline_{stage}_*` for the
    pipeline's fetch, decode and device stages) plus the port's own
    stages: `segment_read_s`/`_calls` (a segment's read, whichever its
    source), and `merge_s`/`_calls`/`_rows` (encode + host merge of a
    segment's windows, which the JAX package calls encode_merge: the
    encode_merge keys read the same numbers)."""
    from horaedb_tpu_torch.storage import pipeline as pipeline_mod

    def series(family, stage):
        return family.labels(stage="merge" if stage == "encode_merge"
                             else stage)

    seconds = registry.histogram("scan_stage_seconds")
    rows = registry.counter("scan_stage_rows_total")
    nbytes = registry.counter("scan_stage_bytes_total")
    out = {}
    for s in _SNAPSHOT_STAGES:
        h = series(seconds, s)
        out[f"{s}_s"] = round(h.sum, 6)
        out[f"{s}_calls"] = h.count
    for s in _SNAPSHOT_ROWS:
        out[f"{s}_rows"] = int(series(rows, s).value)
    for s in _SNAPSHOT_BYTES:
        out[f"{s}_bytes"] = int(series(nbytes, s).value)
    stalls = pipeline_mod.stall_counts()
    for s in pipeline_mod.PIPELINE_STAGES:
        h = pipeline_mod.STAGE_SECONDS[s]
        out[f"pipeline_{s}_s"] = round(h.sum, 6)
        out[f"pipeline_{s}_calls"] = h.count
        out[f"pipeline_stalls_{s}"] = stalls[s]
        out[f"pipeline_{s}_rows"] = int(pipeline_mod.STAGE_ROWS[s].value)
        out[f"pipeline_{s}_bytes"] = int(pipeline_mod.STAGE_BYTES[s].value)
    return out


_INCR_REMERGE = registry.counter(
    "scan_incremental_remerge_total",
    "segments re-merged from tier-2-resident parts with only the "
    "missing SSTs fetched (the post-flush path)")
# the parts path's rounds (one bucket_window_partials launch each) and
# its one device-to-host copy per round: the round's partial grids
_PARTS_ROUNDS = registry.counter(
    "scan_parts_rounds_total", "aggregate rounds run by the parts path")
_PARTIALS_D2H_BYTES = registry.counter(
    "scan_partials_d2h_bytes_total",
    "bytes of partial grids copied device-to-host by the parts path")
# the fused replay cache and the device stack cache: a repeat fused
# query replays its recorded rounds, a varied range reuses the cached
# column stacks (ops parity with scan_cache_*)
_REPLAY_HITS = registry.counter(
    "scan_replay_hits_total", "fused-replay plan cache hits")
_REPLAY_ROWS = registry.counter(
    "scan_replay_rows_total",
    "rows served from fused-replay hits without re-scanning")
_REPLAY_MISSES = registry.counter(
    "scan_replay_misses_total", "fused-replay plan cache misses")
_STACK_HITS = registry.counter(
    "scan_stack_cache_hits_total",
    "per-range round-stack LRU hits (small remap/shift/lo entries)")
_STACK_MISSES = registry.counter(
    "scan_stack_cache_misses_total",
    "per-range round-stack LRU misses")
_COLSTACK_HITS = registry.counter(
    "scan_colstack_cache_hits_total",
    "range-independent column-stack LRU hits (the big ts/gid/val "
    "arrays — the expensive reuse)")
_COLSTACK_MISSES = registry.counter(
    "scan_colstack_cache_misses_total",
    "range-independent column-stack LRU misses")


def _stack_counters(key: tuple):
    # the two entry families have different hit economics: conflating
    # them would report ~50% on varied-range workloads even when the
    # expensive column reuse is perfect
    if key and key[0] == "colstack":
        return _COLSTACK_HITS, _COLSTACK_MISSES
    return _STACK_HITS, _STACK_MISSES

# ---- mesh telemetry ([scan] mesh_devices, [scan.mesh]) ---------------------
_MESH_ROUNDS = registry.counter(
    "scan_mesh_rounds_total",
    "window rounds dispatched onto the 2-D scan mesh")
_MESH_PARTS = registry.counter(
    "scan_mesh_parts_total",
    "per-segment run parts produced by the on-mesh segmented combine")
_MESH_PART_CELLS = registry.counter(
    "scan_mesh_part_cells_total",
    "aggregate grid cells downloaded from the mesh (run parts + top-k "
    "winner slices) — the per-slot combine egress the top-k pushdown "
    "bounds at O(k x buckets x aggs) per run")
_MESH_SCORE_CELLS = registry.counter(
    "scan_mesh_score_cells_total",
    "per-group score/has cells downloaded by the top-k mesh path "
    "(O(groups), never O(groups x buckets))")
_MESH_TOPK = registry.counter(
    "scan_mesh_topk_total",
    "top-k queries served by the device-scored, winner-sliced mesh "
    "path")
# every way a round/plan declines the mesh, so an operator can tell a
# misconfigured mesh from unsupported data
MESH_FALLBACK_REASONS = (
    "merge_impl",    # non-host_perm merge layouts keep the legacy path
    "sum_overlap",   # a run's windows share a (group, bucket) sum cell
    "count_bound",   # time_axis x capacity would overflow f32 counts
    "grid_budget",   # round's transient grid exceeds max_grid_bytes
    "lo_range",      # a window's bucket offset exceeds the query grid
    "run_misaligned",  # a run's windows disagree on their first bucket
    "mesh_error",    # a round dispatch raised (lost shard / kernel error)
    "topk_by",       # ranking agg not requested (combine_top_k's rule)
    "topk_router",   # near-data agents cover segments: no global score
    "topk_decode",   # device-decode parts can't join device scoring
    "topk_budget",   # two-phase window pinning exceeds the cache budget
    "additive_topk",  # an additive score add was not provably exact
    "mesh_decode_budget",  # a decode round exceeds upload/grid caps
)
_MESH_FALLBACKS = registry.counter(
    "scan_mesh_fallback_total",
    "mesh scans that left their preferred route, by reason: topk_* "
    "reasons downgrade the egress-bounded winner-sliced top-k to "
    "FULL-WIDTH MESH parts (still on the mesh); every other reason "
    "re-runs that round on the single-device kernel")
_MESH_FALLBACK_CHILDREN = {r: _MESH_FALLBACKS.labels(reason=r)
                           for r in MESH_FALLBACK_REASONS}
_MESH_AXIS_DEVICES = {
    a: registry.gauge(
        "scan_mesh_axis_devices",
        "devices per scan-mesh axis (0 = mesh off)").labels(axis=a)
    for a in ("time", "series")
}


def note_mesh_fallback(reason: str) -> None:
    child = _MESH_FALLBACK_CHILDREN.get(reason)
    if child is None:  # unknown reasons still count, labeled verbatim
        child = _MESH_FALLBACKS.labels(reason=reason)
        _MESH_FALLBACK_CHILDREN[reason] = child
    child.inc()
    trace_add(f"mesh_fallback_{reason}", 1)


def mesh_fallback_counts() -> dict:
    return {r: int(c.value) for r, c in _MESH_FALLBACK_CHILDREN.items()}


class _MeshFallback(Exception):
    """A mesh round declined dispatch for a counted reason — the caller
    re-runs it on the single-device kernel."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


# prep sentinel marking a deferred decode plan in a mesh round's item
# list (host windows carry a real prep tuple, DeviceParts None)
_DECODE_PREP = object()

# fused replay plans kept per reader (weakref-only entries)
_REPLAY_SLOTS = 8
# rows -> bytes conversion for the cache_max_rows knob: a typical engine
# window is ~4 int32/f32 columns (16B) plus the memo allowance
_CACHE_BYTES_PER_ROW = 32
# accumulator identity of `last_ts` (and of an empty cell's partial)
_ACC_TS_MIN = -(2**31)
_F32_MAX = float(np.finfo(np.float32).max)

# [scan.decode] modes (storage/config.ScanDecodeConfig)
DECODE_MODES = ("auto", "device", "host")

# guards every window's memo put: memo stores run on worker-pool
# threads, and the byte accounting must not drift
_MEMO_LOCK = threading.Lock()


def _memo_store(w, key, value, nbytes: int) -> None:
    """Byte-bounded per-window memo put: the scan cache charges each
    window MEMO_SLOTS * (capacity*4 + 128) bytes of memo allowance, and
    this store keeps the real bytes under it.  A same-key put loses to
    the entry already stored (identical computation by a concurrent
    query)."""
    budget = MEMO_SLOTS * (w.capacity * 4 + 128)
    if nbytes > budget:
        return
    with _MEMO_LOCK:
        if key in w.memo:
            return
        if len(w.memo) >= MEMO_SLOTS or w.memo_bytes + nbytes > budget:
            w.memo.clear()
            w.memo_bytes = 0
        w.memo[key] = value
        w.memo_bytes += nbytes


@dataclass
class ScanRequest:
    """(ref: storage.rs:65-70)"""

    range: TimeRange
    predicate: Optional[filter_ops.Predicate] = None
    # indexes into the FULL storage schema (user columns + builtins)
    projections: Optional[list[int]] = None


@dataclass
class AggregateSpec:
    """Downsample pushdown: GROUP BY group_col, time(bucket) computed on
    device straight from the merge output."""

    group_col: str
    ts_col: str
    value_col: str
    range_start: int  # host-time of bucket 0
    bucket_ms: int
    num_buckets: int
    # which aggregates to compute (canonicalized; count always rides
    # along)
    which: tuple = ALL_AGGS

    def __post_init__(self):
        self.which = canonical_which(self.which)


@dataclass
class SegmentPlan:
    segment_start: int
    ssts: list[SstFile]
    columns: list[str]


@dataclass
class ScanPlan:
    segments: list[SegmentPlan]
    mode: UpdateMode
    predicate: Optional[filter_ops.Predicate]
    keep_builtin: bool
    # pyarrow expression pushed into the parquet reads (PK-only subtree
    # of `predicate`); the full predicate still applies post-merge
    pushdown: object = None
    # canonical string of the pushed subtree (scan-cache identity)
    pushdown_key: str = ""
    # flattened conjunction of the same pushed subtree for the sidecar
    # reads (None: shape not prunable)
    prune_leaves: Optional[list] = None
    # True when the pushed subtree IS the whole predicate: the read
    # already filtered exactly these rows, so post-merge re-evaluation
    # is a no-op and is skipped
    pushed_complete: bool = False
    range: Optional[TimeRange] = None
    # False for a compaction rewrite: its inputs are deleted right
    # after, so caching their merge would only evict hot entries
    use_cache: bool = True
    # worker pool of the plan's CPU work ("compact" for rewrites, so
    # they queue behind each other, not in front of serving scans)
    pool: str = "sst"
    # set by aggregate_segments when the plan takes the device decode:
    # sidecar segments then come back as finished DeviceParts
    decode_spec: Optional["AggregateSpec"] = None
    # set for the rollup manager's recomputes (maintenance and the raw
    # tail, rollup/manager.py): the fused gate declines the plan, so it
    # takes the parts route whatever its size, HORAEDB_FUSED_AGG
    # included — the route whose float64 grids the rollup cells store
    parts_route: bool = False
    # set by _cached_windows: whether this scan runs through the
    # pipeline, which the parts pump reads to run its rounds as a
    # background device stage
    pipeline_active: bool = False
    # set alongside decode_spec on [scan.mesh] plans: the decode stage
    # PLANS the dispatch (device_decode.plan_dispatch) but defers the
    # upload — DecodePlans ride the windows lists into the mesh pump,
    # which batches compatible plans into mesh decode rounds
    decode_defer: bool = False


class ParquetReader:
    """Builds and executes per-segment merge-scan plans
    (ref: ParquetReader, read.rs:407-494)."""

    def __init__(self, store: ObjectStore, root_path: str,
                 schema: StorageSchema, config: StorageConfig,
                 segment_duration_ms: int, runtimes=None, device="cuda"):
        self.store = store
        self.root_path = root_path
        self.schema = schema
        self.config = config
        self.segment_duration_ms = segment_duration_ms
        self.runtimes = runtimes
        self.device = device
        # optional async callback (segment_start, scan_range) -> current
        # SstFiles: set by CloudObjectStorage so a streamed Append
        # segment survives a compaction race mid-segment
        # (_stream_window_batches)
        self.resolve_segment_ssts = None
        ensure(config.scan.combine.mode in combine_mod.COMBINE_MODES,
               f"unknown [scan.combine] mode "
               f"{config.scan.combine.mode!r}; expected one of "
               f"{combine_mod.COMBINE_MODES}")
        # bad TOML fails the open, not a dashboard's first cold scan
        ensure(config.scan.decode.mode in DECODE_MODES,
               f"unknown [scan.decode] mode {config.scan.decode.mode!r}; "
               f"expected one of {DECODE_MODES}")
        # conflicting mode COMBINATIONS fail at open too: mode="device"
        # under the 1-D segment mesh would decline every query with a
        # counted fallback
        ensure(not (config.scan.decode.mode == "device"
                    and config.scan.mesh_devices > 0),
               '[scan.decode] mode="device" cannot run on the legacy '
               "1-D segment mesh ([scan] mesh_devices > 0): the device "
               "decode targets the reader's device or the 2-D "
               "[scan.mesh] rounds — change the decode mode or the mesh "
               "config")
        # the meshes take their devices from parallel.mesh.local_devices
        # of the reader's device type: every local card, or the list the
        # tests (8 entries of cpu) and chip_smoke.py install
        from horaedb_tpu_torch.parallel import mesh as mesh_mod

        self.mesh = None
        self._mesh_agg_fns: dict = {}
        self._mesh_merge_fns: dict = {}
        if config.scan.mesh_devices > 0:
            self.mesh = mesh_mod.segment_mesh(
                config.scan.mesh_devices,
                devices=mesh_mod.local_devices(device))
        # the 2-D (time, series) scan mesh ([scan.mesh]): segments shard
        # along `time` (plan-order slot admission), group blocks along
        # `series`, the segmented combine on the mesh — off reproduces
        # the single-device path exactly
        self.scan_mesh = None
        self._mesh_run_fns: dict = {}
        if config.scan.mesh.enabled:
            ensure(config.scan.mesh_devices == 0,
                   "[scan] mesh_devices and [scan.mesh] are mutually "
                   "exclusive — the 2-D mesh supersedes the legacy 1-D "
                   "segment mesh")
            self.scan_mesh = mesh_mod.scan_mesh(
                config.scan.mesh.time, config.scan.mesh.series,
                devices=mesh_mod.local_devices(device))
            _MESH_AXIS_DEVICES["time"].set(self.scan_mesh.shape["time"])
            _MESH_AXIS_DEVICES["series"].set(
                self.scan_mesh.shape["series"])
        # live bytes of device-resident mesh top-k score state (the
        # mesh_state ledger account's pull gauge; event-loop owned)
        self._mesh_state_bytes = 0
        cache_bytes = (config.scan.cache_max_bytes
                       or config.scan.cache_max_rows * _CACHE_BYTES_PER_ROW)
        self.cache_budget_bytes = cache_bytes
        self.scan_cache = ScanCache(cache_bytes)
        self.parts_memo = combine_mod.PartsMemo(
            config.scan.combine.memo_max_bytes)
        # tier 2: host-RAM per-SST encoded parts under the window cache
        # — a window-cache miss rebuilds from host memory, and a changed
        # SST set re-merges with only the missing SSTs fetched.  Also
        # owns the per-SST sidecar-missing negative memo
        self.encoded_cache = EncodedSegmentCache(
            config.scan.cache.tier2_max_bytes,
            write_through=config.scan.cache.write_through)
        # high-water of pipeline in-flight host bytes observed by this
        # reader's scans (pipeline.PipelineBudget)
        self._pipeline_high_water = 0
        # round stacks on the device: key -> (window weakrefs, arrays,
        # bytes), LRU by bytes under the scan cache's budget (host
        # windows live in host RAM, so the stacks are the device's
        # working set).  Worker-pool threads build rounds: locked.
        self._stack_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._stack_cache_lock = threading.Lock()
        self._stack_cache_bytes = 0
        self._stack_cache_max = cache_bytes
        self._stack_cache_hits = 0
        self._stack_cache_misses = 0
        # fused replay plans: a completed fused aggregate's round
        # composition (stack keys and window weakrefs, no device memory
        # pinned); event-loop owned
        self._replay_cache: "OrderedDict[tuple, dict]" = OrderedDict()
        self._replay_hits = 0
        self._replay_misses = 0
        # near-data routing ([scanagent]): a ScanRouter attached here
        # sends covered segments' aggregate scans to their store-shard
        # agents and folds the returned partials through the normal
        # combine (scanagent/client.py); None = the direct-scan control
        self.scan_router = None
        # memory plane: every reader-owned byte budget registers a
        # ledger account tagged with its configured budget; close()
        # deregisters.  Anchored weakly on the reader.  The pipeline
        # module's process account must exist the moment a reader does
        from horaedb_tpu_torch.storage import pipeline as _pipeline  # noqa: F401
        self._mem_accounts = [
            # RESIDENT bytes, not the LRU's charged bytes (which
            # include a worst-case per-window memo allowance)
            memledger.register(
                f"scan_cache:{root_path}",
                lambda r: r._scan_cache_resident_bytes(), anchor=self,
                kind="scan_cache", budget=cache_bytes, owner=root_path),
            # round stacks live on the reader's device: host RAM on a
            # CPU reader, card memory on a CUDA one — there they are
            # not host RSS (memory_device_bytes covers them)
            memledger.register(
                f"stack_cache:{root_path}",
                lambda r: r._stack_cache_bytes, anchor=self,
                kind="stack_cache", budget=self._stack_cache_max,
                owner=root_path, host=not self.on_cuda),
            memledger.register(
                f"encoded_cache:{root_path}",
                lambda r: r.encoded_cache.total_bytes, anchor=self,
                kind="encoded_cache",
                budget=config.scan.cache.tier2_max_bytes,
                owner=root_path),
            memledger.register(
                f"parts_memo:{root_path}",
                lambda r: r.parts_memo.lru.total_bytes, anchor=self,
                kind="parts_memo",
                budget=config.scan.combine.memo_max_bytes,
                owner=root_path),
            # device-resident mesh top-k score state held for the
            # two-pass ranking's duration; decode round stacks ride the
            # stack_cache account above
            memledger.register(
                f"mesh_state:{root_path}",
                lambda r: r._mesh_state_bytes, anchor=self,
                kind="mesh_state", budget=config.scan.mesh.max_grid_bytes,
                owner=root_path, host=not self.on_cuda),
        ]

    @property
    def on_cuda(self) -> bool:
        import torch

        return torch.device(self.device).type == "cuda"

    def close(self) -> None:
        """Release every reader-owned cache tier and deregister ledger
        accounts: a closed table holds no attributable bytes
        (scan_cache_bytes{tier="tier2"} reads 0 afterwards)."""
        self.drop_hbm_state()
        self.scan_cache.clear()
        self.encoded_cache.clear()
        self.parts_memo.clear()
        self._mesh_run_fns.clear()
        self._mesh_agg_fns.clear()
        self._mesh_merge_fns.clear()
        if self.scan_mesh is not None:
            # a closed table reports no phantom mesh (the gauges are
            # process-global, last writer wins)
            _MESH_AXIS_DEVICES["time"].set(0)
            _MESH_AXIS_DEVICES["series"].set(0)
        for acct in self._mem_accounts:
            memledger.deregister(acct)
        self._mem_accounts = []
        # the device plane's families are process-global like the mesh
        # gauges: a closed table leaves them zeroed
        deviceprof.profiler.clear()
        memledger.reset_device_high_water()

    def _scan_cache_resident_bytes(self) -> int:
        """Actual host bytes the window cache holds: column buffers at
        their padded widths plus MATERIALIZED memo bytes — the ledger's
        pull gauge (scan_cache.total_bytes charges the worst-case memo
        allowance up front instead).  A CUDA reader's per-window device
        columns (the "dev_cols" memo) live on the card: they are not
        host RSS, and memory_device_bytes covers them."""
        total = 0
        for windows in self.scan_cache.values():
            for w in windows:
                total += sum(int(c.dtype.itemsize) * w.capacity
                             for c in w.columns.values())
                total += int(w.memo_bytes)
                if self.on_cuda:
                    total -= sum(int(a.nbytes)
                                 for key, cols in list(w.memo.items())
                                 if key[0] == "dev_cols" for a in cols)
        return total

    def drop_hbm_state(self) -> None:
        """Evict everything device-resident that derives from cached
        windows (round stacks, fused-replay plans, per-window memos:
        device column copies and group maps) while KEEPING the post-merge
        windows themselves, which live in host RAM.  The next query
        re-stacks and re-uploads from the host windows instead of
        re-reading and re-merging.  (Tests and benchmarks; production
        eviction is the LRUs' own.)"""
        with self._stack_cache_lock:
            self._stack_cache.clear()
            self._stack_cache_bytes = 0
        self._replay_cache.clear()
        with _MEMO_LOCK:
            for windows in self.scan_cache.values():
                for w in windows:
                    w.memo.clear()
                    w.memo_bytes = 0

    def _mem_delta_marks(self) -> Optional[list]:
        """Per-trace memory attribution: this reader's cache balances at
        scan start; _mem_delta_attribute() adds the deltas to the trace
        as mem_account_delta_<kind> counters, so a cold scan's trace
        shows which tier its resident bytes landed in.  Reads the caches'
        charged totals, integer reads only: this runs twice per traced
        query.  None (no ambient trace, or the ledger disabled) skips
        the bookwork."""
        if not memledger.enabled or active_trace() is None:
            return None
        return [("scan_cache", self.scan_cache.total_bytes),
                ("stack_cache", self._stack_cache_bytes),
                ("encoded_cache", self.encoded_cache.total_bytes),
                ("parts_memo", self.parts_memo.lru.total_bytes)]

    def _mem_delta_attribute(self, marks: Optional[list]) -> None:
        if not marks:
            return
        now = dict(self._mem_delta_marks() or ())
        for kind, before in marks:
            delta = now.get(kind, before) - before
            if delta:
                trace_add(f"mem_account_delta_{kind}", delta)

    def cache_stats(self) -> dict:
        """Every reader-owned cache tier's residency and effectiveness,
        one dict per tier, and the pipeline's settings and high-water."""
        return {
            "scan_cache": {
                "entries": len(self.scan_cache),
                "bytes": self.scan_cache.total_bytes,
                "max_bytes": self.scan_cache.max_bytes,
                "hits": self.scan_cache.hits,
                "misses": self.scan_cache.misses,
            },
            "encoded_cache": self.encoded_cache.stats(),
            "parts_memo": self.parts_memo.stats(),
            "pipeline": {
                "enabled": self.pipeline_on(),
                "depth": self.config.scan.pipeline.depth,
                "inflight_bytes": self.config.scan.pipeline.inflight_bytes,
                "high_water_bytes": self._pipeline_high_water,
            },
            "decode": {
                "mode": self.config.scan.decode.mode,
                "resolved": self._decode_mode(),
                "max_upload_bytes": self.config.scan.decode.max_upload_bytes,
            },
            "stack_cache": {
                "entries": len(self._stack_cache),
                "bytes": self._stack_cache_bytes,
                "max_bytes": self._stack_cache_max,
                "hits": self._stack_cache_hits,
                "misses": self._stack_cache_misses,
            },
            "mesh": self.mesh_stats(),
        }

    def mesh_stats(self) -> dict:
        """The /stats mesh section: axis shape, round/part volume, the
        egress counter the top-k bound is asserted against, and every
        counted fallback reason."""
        from horaedb_tpu_torch.storage import pipeline as pipeline_mod

        shape = None
        if self.scan_mesh is not None:
            shape = {"time": self.scan_mesh.shape["time"],
                     "series": self.scan_mesh.shape["series"]}
        return {
            "enabled": self.scan_mesh is not None,
            "shape": shape,
            "segment_devices": 0 if self.mesh is None else self.mesh.size,
            "devices": [str(d) for d in (
                self.scan_mesh or self.mesh).devices]
            if (self.scan_mesh or self.mesh) is not None else [],
            "rounds": int(_MESH_ROUNDS.value),
            "parts": int(_MESH_PARTS.value),
            "part_cells": int(_MESH_PART_CELLS.value),
            "score_cells": int(_MESH_SCORE_CELLS.value),
            "topk_served": int(_MESH_TOPK.value),
            "fallbacks": {r: int(c.value)
                          for r, c in _MESH_FALLBACK_CHILDREN.items()
                          if c.value},
            "stalls": pipeline_mod.mesh_stall_counts(),
        }

    # ---- plan construction -------------------------------------------------

    def build_plan(self, ssts: list[SstFile], request: ScanRequest,
                   keep_builtin: bool = False, use_cache: bool = True,
                   pool: str = "sst") -> ScanPlan:
        columns = plan_columns(self.schema, request.projections)
        by_segment: dict[int, list[SstFile]] = {}
        for f in ssts:
            by_segment.setdefault(
                segment_of(f, self.segment_duration_ms), []).append(f)
        segments = [
            SegmentPlan(segment_start=seg,
                        ssts=sorted(files, key=lambda f: f.id),
                        columns=columns)
            for seg, files in sorted(by_segment.items())
        ]
        pushdown = None
        pushdown_key = ""
        allowed = set(self.schema.primary_key_names)
        if request.predicate is not None:
            pushdown, pushdown_key = filter_ops.to_arrow_expression_with_key(
                request.predicate, allowed)
        prune_leaves, pushed_complete = parquet_io.conjunct_leaves_ex(
            request.predicate, allowed)
        return ScanPlan(segments=segments, mode=self.schema.update_mode,
                        predicate=request.predicate,
                        keep_builtin=keep_builtin, pushdown=pushdown,
                        pushdown_key=pushdown_key,
                        prune_leaves=prune_leaves,
                        pushed_complete=pushed_complete,
                        range=request.range, use_cache=use_cache,
                        pool=pool)

    # ---- row scans ---------------------------------------------------------

    async def execute(self, plan: ScanPlan) -> AsyncIterator[pa.RecordBatch]:
        """Row scan: one Arrow batch per non-empty merge window, in
        segment order."""
        marks = self._mem_delta_marks()
        seg_iter = self.execute_segments(plan)
        try:
            async for _seg_start, batch in seg_iter:
                if batch is not None:
                    yield batch
        finally:
            await seg_iter.aclose()
            self._mem_delta_attribute(marks)

    async def execute_segments(self, plan: ScanPlan):
        """Row scan with segment attribution: (segment_start, batch) per
        non-empty merge window, then (segment_start, None) once the
        segment is complete — the unit a compaction-race replan skips
        (storage.CloudObjectStorage.scan_segments).  An Append table
        merges each segment on the host through the BytesMerge operator,
        uncached (_append_segment)."""
        if plan.mode is not UpdateMode.OVERWRITE:
            feed = self._segment_feed(plan, plan.segments)
            try:
                async for seg, is_streamed, table, read_s in feed:
                    # cooperative deadline checkpoint: an expired query
                    # aborts between segments, not after a full scan
                    deadline_checkpoint()
                    async for out in self._append_segment(
                            seg, is_streamed, table, read_s, plan):
                        yield out
            finally:
                # an abandoned consumer tears the prefetch down now
                await feed.aclose()
            return
        windows_iter = self._cached_windows(plan)
        try:
            async for seg, windows, read_s in windows_iter:
                elapsed = 0.0  # decode work only: a yield suspends into
                for w in windows:  # the consumer, not scan time
                    # per-window deadline checkpoint (the merge loop's
                    # cooperative cancellation point)
                    deadline_checkpoint()
                    t0 = time.perf_counter()
                    part = await self._run_pool(
                        self._window_to_arrow, w,
                        list(seg.columns), plan, pool=plan.pool)
                    if part is not None and part.num_rows:
                        part = self._strip_builtin(part, plan)
                    elapsed += time.perf_counter() - t0
                    if part is not None and part.num_rows:
                        _ROWS_SCANNED.inc(part.num_rows)
                        yield seg.segment_start, part
                _SCAN_LATENCY.observe(read_s + elapsed)
                yield seg.segment_start, None
        finally:
            await windows_iter.aclose()

    async def _append_segment(self, seg: SegmentPlan, is_streamed: bool,
                              table, read_s: float, plan: ScanPlan):
        """One Append-mode segment's host merge, streamed or bulk.
        Yields (segment_start, batch) parts, then the completion
        marker.  A streamed segment merges window by window, so the
        host bound holds for Append tables too."""
        if is_streamed:
            spent = 0.0
            async for batch in self._stream_window_batches(
                    seg, plan, strict_no_replay=True):
                deadline_checkpoint()
                t0 = time.perf_counter()
                part = await self._run_pool(
                    self._merge_segment_table,
                    pa.Table.from_batches([batch]), plan, pool=plan.pool)
                spent += time.perf_counter() - t0
                if part is not None and part.num_rows:
                    _ROWS_SCANNED.inc(part.num_rows)
                    yield seg.segment_start, part
            _SCAN_LATENCY.observe(spent)
            yield seg.segment_start, None
            return
        t0 = time.perf_counter()
        batch = await self._run_pool(self._merge_segment_table, table,
                                     plan, pool=plan.pool)
        _SCAN_LATENCY.observe(read_s + (time.perf_counter() - t0))
        if batch is not None and batch.num_rows:
            _ROWS_SCANNED.inc(batch.num_rows)
            yield seg.segment_start, batch
        yield seg.segment_start, None

    def _merge_segment_table(self, table: pa.Table,
                             plan: ScanPlan) -> Optional[pa.RecordBatch]:
        """Host (Append/BytesMerge) merge of one segment's table, cut
        into the same PK-range windows as the Overwrite path when the
        segment exceeds the window budget (the sort stays bounded)."""
        if table.num_rows == 0:
            return None
        batch = table.combine_chunks().to_batches()[0]
        window = self.config.scan.max_window_rows
        if batch.num_rows <= window:
            return self._strip_builtin(self._merge_on_host(batch, plan),
                                       plan)
        pk1 = batch.column(batch.schema.names.index(
            self._pk_names_in(batch.schema.names)[0]))
        # dense value-order ranks straight from Arrow (the comparator the
        # merge sort uses); cross-window order then follows value order
        ranks = np.asarray(pa.compute.rank(pk1, sort_keys="ascending",
                                           tiebreaker="dense"))
        parts = []
        for sel in _plan_pk_windows(ranks, window):
            part = self._merge_on_host(batch.take(pa.array(sel)), plan)
            if part is not None and part.num_rows:
                parts.append(part)
        if not parts:
            return None
        merged = (parts[0] if len(parts) == 1 else pa.Table.from_batches(
            parts).combine_chunks().to_batches()[0])
        return self._strip_builtin(merged, plan)

    def _merge_on_host(self, batch: pa.RecordBatch,
                       plan: ScanPlan) -> pa.RecordBatch:
        """Sort by (PK, __seq__) and apply the table's merge operator;
        the full predicate applies after the merge unless the read
        already applied all of it."""
        from horaedb_tpu_torch.storage.operator import build_operator

        pk_names = self._pk_names_in(batch.schema.names)
        sort_keys = [(n, "ascending") for n in pk_names + [SEQ_COLUMN_NAME]]
        batch = batch.take(pa.compute.sort_indices(batch,
                                                   sort_keys=sort_keys))
        names = batch.schema.names
        value_idxes = [names.index(n) for n in names
                       if n not in pk_names and n != SEQ_COLUMN_NAME]
        op = build_operator(plan.mode, value_idxes)
        # explicit indices: a projection may have reordered columns
        merged = op.merge_sorted_batch(
            batch, pk_indices=[names.index(n) for n in pk_names])
        if plan.predicate is not None and not plan.pushed_complete:
            mask = _eval_predicate_host(plan.predicate, merged)
            merged = merged.filter(pa.array(mask))
        return merged

    def _window_to_arrow(self, w: encode.DeviceBatch, names: list[str],
                         plan: ScanPlan) -> Optional[pa.RecordBatch]:
        # Predicates apply AFTER dedup: filtering before would break
        # last-value semantics when the predicate touches value columns
        # (a filtered-out newer row must still shadow an older row)
        arrow = encode.decode_to_arrow(w, names=names)
        if plan.predicate is not None and not plan.pushed_complete:
            mask = filter_ops.eval_predicate(plan.predicate, w)
            arrow = arrow.take(pa.array(np.flatnonzero(mask[:w.n_valid])))
        return arrow

    def _strip_builtin(self, batch: pa.RecordBatch,
                       plan: ScanPlan) -> pa.RecordBatch:
        if plan.keep_builtin:
            return batch
        keep = [c for c in batch.schema.names
                if not self.schema.is_builtin_name(c)]
        return batch.select(keep)

    # ---- segment windows ---------------------------------------------------

    def _cache_key(self, seg: SegmentPlan, plan: ScanPlan):
        # the canonical key of the PUSHED subtree is part of the cached
        # merge output's identity: a pushdown changes which rows were
        # read before the merge
        return segment_cache_key(
            seg.segment_start, (f.id for f in seg.ssts),
            tuple(seg.columns) + (plan.pushdown_key,))

    async def _cached_windows(self, plan: ScanPlan):
        """Per segment, in plan order, yield (seg, post-merge windows,
        read_seconds; 0.0 for a cached segment) —
        from the scan cache when the segment's (SST set, columns,
        pushdown) is unchanged, else by reading and merging it and
        populating the cache.  The reads run through the pipeline
        (storage/pipeline.py) when it is on and the scan has store I/O
        to hide, else through the sequential pump; both give the same
        windows.  A plan with use_cache False neither reads nor fills
        the cache."""
        cached: dict[int, list] = {}
        to_read: list[SegmentPlan] = []
        for seg in plan.segments:
            windows = (self.scan_cache.get(self._cache_key(seg, plan))
                       if plan.use_cache else None)
            if windows is None:
                to_read.append(seg)
            else:
                cached[id(seg)] = windows
        if self.mesh is not None:
            inner = self._cached_windows_mesh(plan, cached, to_read)
            try:
                async for out in inner:
                    yield out
            finally:
                await inner.aclose()
            return
        plan.pipeline_active = (self.pipeline_on()
                                and self._pipeline_has_io(plan, to_read))
        if plan.pipeline_active:
            inner = self._cached_windows_pipelined(plan, cached, to_read)
        else:
            inner = self._cached_windows_pump(plan, cached, to_read)
        try:
            async for out in inner:
                yield out
        finally:
            await inner.aclose()

    async def _cached_windows_pump(self, plan: ScanPlan, cached: dict,
                                   to_read: list):
        """The sequential pump: segment reads prefetched up to
        `prefetch_segments` ahead (_segment_feed), each segment merged
        in plan order on the pool, one at a time."""
        feed = self._segment_feed(plan, to_read)
        try:
            for seg in plan.segments:
                # cooperative deadline checkpoint between segments: a
                # query that ran out of budget stops reading/merging
                # instead of finishing a doomed scan
                deadline_checkpoint()
                if id(seg) in cached:
                    yield seg, cached[id(seg)], 0.0
                    continue
                read_seg, is_streamed, table, read_s = \
                    await feed.__anext__()
                ensure(read_seg is seg, "segment feed out of plan order")
                if is_streamed:
                    windows, read_s = await self._read_streamed_windows(
                        seg, plan)
                elif table.num_rows:
                    windows = await self._run_pool(
                        self._merge_segment, table, plan, pool=plan.pool)
                else:
                    windows = []
                del table
                if plan.use_cache and _cacheable_windows(windows):
                    self.scan_cache.put(self._cache_key(seg, plan), windows)
                yield seg, windows, read_s
        finally:
            await feed.aclose()

    def pipeline_on(self) -> bool:
        """Whether cold scans run through the bounded producer/consumer
        pipeline (storage/pipeline.py); [scan.pipeline] enabled = false
        keeps the sequential pump.  Scans on the 1-D segment mesh keep
        their own round scheduler (_cached_windows_mesh)."""
        return self.config.scan.pipeline.enabled and self.mesh is None

    def _pipeline_has_io(self, plan: ScanPlan, to_read: list) -> bool:
        """Whether pipelining this scan can pay for itself: the pipeline
        hides object-store latency behind decode and device work, so a
        scan whose every bulk segment is already tier-2 resident (zero
        store I/O — the post-flush / warm-tier regime) runs the
        sequential pump instead, where the stages' concurrency would
        only contend for the same host cores.  Streamed segments read
        the store incrementally and any non-resident bulk segment
        fetches it, so either makes the pipeline worthwhile.  The probe
        is the cache's stats-free peek: it bumps no LRU recency and no
        hit/miss counter (the reads that follow do)."""
        if not self._sidecar_plan_ok(plan):
            return bool(to_read)  # every read is a store read
        leaf_cols = {lf.column for lf in plan.prune_leaves or []}

        def resident(seg: SegmentPlan) -> bool:
            if self.encoded_cache.is_assembly_failed(
                    frozenset(f.id for f in seg.ssts)):
                return False
            want = set(seg.columns) | leaf_cols
            return all(self.encoded_cache.peek(f.id, want)
                       for f in seg.ssts)

        return any(self._stream_segment(seg) or not resident(seg)
                   for seg in to_read)

    async def _cached_windows_pipelined(self, plan: ScanPlan,
                                        cached: dict, to_read: list):
        """Pipelined twin of the pump: fetch and decode run as
        background stages (storage/pipeline.py) while this consumer —
        the device stage's doorstep — yields segments in plan order.
        Same windows, same cache puts, same error positions; only the
        schedule differs."""
        from horaedb_tpu_torch.storage.pipeline import ScanPipeline

        pipe = ScanPipeline(self, plan, to_read)
        try:
            for seg in plan.segments:
                # cooperative deadline checkpoint between segments, same
                # position as the pump's
                deadline_checkpoint()
                if id(seg) in cached:
                    yield seg, cached[id(seg)], 0.0
                    continue
                got, windows, read_s = await pipe.next_segment()
                ensure(got is seg, "scan pipeline out of plan order")
                if plan.use_cache and _cacheable_windows(windows):
                    self.scan_cache.put(self._cache_key(seg, plan), windows)
                yield seg, windows, read_s
        finally:
            # deterministic teardown: cancels the stage tasks and AWAITS
            # them, draining any in-flight pool job before the caller
            # proceeds to table/engine teardown
            await pipe.aclose()

    async def _cached_windows_mesh(self, plan: ScanPlan, cached: dict,
                                   to_read: list):
        """Segment-mesh twin of the pump ([scan] mesh_devices): windows
        from DIFFERENT segments batch into rounds of mesh size.  Under
        the default host_perm merge the windows arrive merged and
        deduped on the host, and the mesh engages at the aggregate
        stage (the sharded_remap_partials rounds of _flush_host_round);
        under device_sort each round of unmerged windows runs as one
        sharded_merge_dedup program (shard-local sort and dedup, no
        collectives), whose outputs come back as host windows.
        Segments still yield in plan order, each only after all its
        windows' rounds have run."""
        n_dev = self.mesh.size
        # pinned for the whole scan: window prep and the round program
        # must agree even if set_merge_impl flips mid-scan
        scan_host_perm = merge_ops.merge_impl() == "host_perm"
        feed = self._segment_feed(plan, to_read)
        # buffer entries: [seg, windows (filled in round order),
        #                  outstanding window count, read seconds]
        buffer: list[list] = []
        pending: list = []

        def run_round(round_items: list) -> None:
            from horaedb_tpu_torch.parallel.scan import (
                shard_leading_axis,
                sharded_merge_dedup,
            )

            cap = max(it[3] for it in round_items)
            names = list(round_items[0][1].keys())
            stacks = {}
            for name in names:
                rows = np.zeros((n_dev, cap),
                                dtype=round_items[0][1][name].dtype)
                for d, (_e, cols, _n, wcap, _enc) in enumerate(round_items):
                    rows[d, :wcap] = cols[name]
                stacks[name] = shard_leading_axis(self.mesh, rows)
            n_valid = np.zeros(n_dev, dtype=np.int32)
            for d, it in enumerate(round_items):
                n_valid[d] = it[2]
            pk_names = self._pk_names_in(names)
            value_names = [nm for nm in names
                           if nm not in pk_names and nm != SEQ_COLUMN_NAME]
            fn = self._mesh_merge_fns.get(len(pk_names))
            if fn is None:
                fn = sharded_merge_dedup(self.mesh, num_pks=len(pk_names))
                self._mesh_merge_fns[len(pk_names)] = fn
            out_pks, out_seq, out_vals, _valid, num_runs = fn(
                tuple(stacks[nm] for nm in pk_names),
                stacks[SEQ_COLUMN_NAME],
                tuple(stacks[nm] for nm in value_names), n_valid)
            # the merged windows live on the host, as host_perm's do
            host = {nm: a.numpy() for nm, a in zip(pk_names, out_pks)}
            host[SEQ_COLUMN_NAME] = out_seq.numpy()
            host.update({nm: a.numpy() for nm, a in zip(value_names,
                                                         out_vals)})
            runs_host = num_runs.numpy()
            for d, (entry, _cols, _n, _wcap, enc) in enumerate(round_items):
                entry[1].append(encode.DeviceBatch(
                    columns={nm: host[nm][d] for nm in names},
                    encodings=enc, n_valid=int(runs_host[d]),
                    capacity=cap))
                entry[2] -= 1

        async def enqueue(entry: list, descs: list) -> None:
            if scan_host_perm:
                entry[1].extend(descs)  # merged windows: no merge round
                return
            entry[2] += len(descs)
            for cols, n_win, wcap, enc in descs:
                pending.append((entry, cols, n_win, wcap, enc))
            while len(pending) >= n_dev:
                await self._run_pool(run_round, pending[:n_dev],
                                     pool=plan.pool)
                del pending[:n_dev]

        def prepare(table):
            if scan_host_perm:
                return self._merge_segment(table, plan)
            return self._unmerged_window_descs(table)

        def done(seg0, windows, read_s):
            if plan.use_cache and id(seg0) not in cached \
                    and _cacheable_windows(windows):
                self.scan_cache.put(self._cache_key(seg0, plan), windows)
            return seg0, windows, read_s

        try:
            for seg in plan.segments:
                deadline_checkpoint()  # between-segment cancellation
                if id(seg) in cached:
                    buffer.append([seg, cached[id(seg)], 0, 0.0])
                else:
                    fseg, is_streamed, table, read_s = \
                        await feed.__anext__()
                    ensure(fseg is seg, "segment feed out of plan order")
                    entry = [seg, [], 0, read_s]
                    buffer.append(entry)
                    if is_streamed and scan_host_perm:
                        windows, entry[3] = await self._read_streamed_windows(
                            seg, plan)
                        await enqueue(entry, windows)
                    elif is_streamed:
                        # feed rounds window by window: at most a round's
                        # worth of unmerged host windows is resident
                        es_iter = await self._open_sidecar_stream(seg, plan)
                        if es_iter is not None:
                            try:
                                async for es in es_iter:
                                    await enqueue(entry, await self._run_pool(
                                        prepare, es, pool=plan.pool))
                            except Exception as exc:  # noqa: BLE001
                                # windows already in mesh rounds can't be
                                # retracted: fail to the outer replan
                                raise Error("sidecar stream failed "
                                            f"mid-mesh-round: {exc}") from exc
                            finally:
                                await es_iter.aclose()
                        else:
                            async for batch in self._stream_window_batches(
                                    seg, plan):
                                await enqueue(entry, await self._run_pool(
                                    prepare, pa.Table.from_batches([batch]),
                                    pool=plan.pool))
                    elif table.num_rows:
                        await enqueue(entry, await self._run_pool(
                            prepare, table, pool=plan.pool))
                    del table
                while buffer and buffer[0][2] == 0:
                    seg0, windows, _outstanding, read_s = buffer.pop(0)
                    yield done(seg0, windows, read_s)
            if pending:
                # tail round: pad with empty windows bound to a discard
                # entry so real segments' window lists stay exact
                discard = [None, [], len(pending) - n_dev, 0.0]
                _e, cols0, _n, wcap0, enc0 = pending[-1]
                tail = list(pending)
                while len(tail) < n_dev:
                    tail.append((discard, cols0, 0, wcap0, enc0))
                await self._run_pool(run_round, tail, pool=plan.pool)
                pending.clear()
            while buffer:
                seg0, windows, outstanding, read_s = buffer.pop(0)
                ensure(outstanding == 0, "mesh merge round left windows")
                yield done(seg0, windows, read_s)
        finally:
            await feed.aclose()

    def _unmerged_window_descs(self, table) -> list:
        """The device_sort layout's window prep: encode, cut PK-range
        windows (partitioned on the first non-constant PK), pad — no
        merge.  Returns [(padded host cols, n_win, capacity,
        encodings)] for the segment mesh's merge rounds."""
        if isinstance(table, sidecar.EncodedSegment):
            es = sidecar.apply_leaves_host(table)
            if es.n == 0:
                return []
            dev = _encoded_to_device_batch(es)
            names = list(es.names)
        else:
            if table.num_rows == 0:
                return []
            batch = table.combine_chunks().to_batches()[0]
            dev = encode.encode_batch(batch)
            names = list(batch.schema.names)
        pk_names = self._pk_names_in(names)
        ensure(len(pk_names) == self.schema.num_primary_keys,
               "projection lost primary key columns")
        n = dev.n_valid
        if n == 0:
            return []
        host_cols = {name: np.asarray(c)[:n]
                     for name, c in dev.columns.items()}
        if n <= self.config.scan.max_window_rows:
            return [({kk: np.asarray(v) for kk, v in dev.columns.items()},
                     n, dev.capacity, dev.encodings)]
        part_name = next(
            (nm for nm in pk_names
             if host_cols[nm][0] != host_cols[nm][-1]
             or not bool((host_cols[nm] == host_cols[nm][0]).all())),
            pk_names[0])
        descs = []
        for sel in _plan_pk_windows(host_cols[part_name],
                                    self.config.scan.max_window_rows):
            if not len(sel):
                continue
            n_win = len(sel)
            cap = encode.pad_capacity(n_win)
            descs.append(({kk: np.pad(v[sel], (0, cap - n_win))
                           for kk, v in host_cols.items()},
                          n_win, cap, dev.encodings))
        return descs

    async def _segment_feed(self, plan: ScanPlan,
                            segments: list[SegmentPlan]):
        """The streamed/bulk split: yields (seg, is_streamed,
        table_or_None, read_s) in segment order.  The bulk prefetch is
        primed at once so store reads overlap any streamed segment
        processed before them."""
        streamed = {id(s) for s in segments if self._stream_segment(s)}
        bulk = [s for s in segments if id(s) not in streamed]
        read_iter = self._prefetch_tables(bulk, plan).__aiter__()
        primed: Optional[asyncio.Task] = (
            asyncio.ensure_future(read_iter.__anext__()) if bulk else None)
        try:
            for seg in segments:
                if id(seg) in streamed:
                    yield seg, True, None, 0.0
                    continue
                if primed is not None:
                    step, primed = primed, None
                    read_seg, table, read_s = await step
                else:
                    read_seg, table, read_s = await read_iter.__anext__()
                ensure(read_seg is seg, "segment prefetch out of order")
                yield seg, False, table, read_s
        finally:
            if primed is not None:
                primed.cancel()
                await asyncio.gather(primed, return_exceptions=True)
            # deterministic teardown of the prefetch generator: its read
            # tasks must be cancelled NOW, not at GC-time finalization
            await read_iter.aclose()

    async def _prefetch_tables(self, segments: list[SegmentPlan],
                               plan: ScanPlan):
        """Bounded segment prefetch: store reads overlap downstream work
        while at most scan.prefetch_segments tables are in memory (the
        permit is released only after the consumer is done with a
        segment).  Yields (segment, table, read_seconds)."""
        sem = asyncio.Semaphore(max(1, self.config.scan.prefetch_segments))

        async def read(seg: SegmentPlan):
            await sem.acquire()
            return await self._read_segment_any(seg, plan)

        tasks = [asyncio.create_task(read(seg)) for seg in segments]
        try:
            for seg, task in zip(segments, tasks):
                table, read_s = await task
                try:
                    yield seg, table, read_s
                finally:
                    sem.release()
        finally:
            for task in tasks:
                task.cancel()
            # drain, don't just cancel: a read whose pool job is
            # mid-flight only finishes after the job does, and failed
            # reads' exceptions are retrieved here
            await asyncio.gather(*tasks, return_exceptions=True)

    async def _run_pool(self, fn, *args, pool: str = "sst"):
        """CPU work (parquet codec, host merge, numpy prep, device
        dispatch) runs on a worker pool (`sst` unless the plan names
        another), never on the event loop (ref: dedicated runtimes,
        storage.rs:91-104)."""
        return await parquet_io._run(self.runtimes, pool, fn, *args)

    async def _run_round(self, fn, *args, pool: str) -> tuple:
        """_run_pool for a pipeline device round: (result, t0_ns, t1_ns),
        the interval from the submit to the round's own end on its
        worker.  The pool-queue wait is the stage's; the event loop's
        delay in resuming the caller afterwards is the consumer's (it is
        busy with the fetch and decode stages), so it is left out."""
        t0 = time.perf_counter_ns()
        end: list = []

        def job():
            try:
                return fn(*args)
            finally:
                end.append(time.perf_counter_ns())

        out = await self._run_pool(job, pool=pool)
        return out, t0, end[0]

    async def _read_segment_any(self, seg: SegmentPlan, plan: ScanPlan,
                                runner=None):
        """One bulk segment's cold read — tier 2 and the sidecars serve
        it, with only the missing SSTs fetched; parquet when any SST's
        sidecar is missing or invalid (a data-format choice, not a
        device fallback) — with its stage attribution.  Returns (table,
        read_seconds); `table` is a pa.Table or an EncodedSegment.
        Shared by the pump's prefetch and the pipeline's fetch stage,
        which bounds the CPU-side deserialize concurrency via
        `runner`."""
        t0 = time.perf_counter_ns()
        table = None
        stage = "sidecar_read"
        if self._sidecar_plan_ok(plan):
            table = await self._read_segment_encoded(seg, plan,
                                                     runner=runner)
        if table is None:
            stage = "parquet_read"
            table = await self._read_segment_table(seg, plan)
        t1 = time.perf_counter_ns()
        read_s = (t1 - t0) / 1e9
        _observe_stage("segment_read", t0, t1)
        _STAGE_SECONDS[stage].observe(read_s)
        _STAGE_ROWS[stage].inc(table.num_rows)
        _STAGE_BYTES[stage].inc(table.nbytes)
        trace_add(f"stage_{stage}_ms", read_s * 1e3)
        trace_add(f"stage_{stage}_rows", table.num_rows)
        trace_add(f"stage_{stage}_bytes", table.nbytes)
        # tenant scan-byte budget: charged where the stage bytes are
        # attributed, observed at the deadline checkpoints
        charge_scan_bytes(table.nbytes)
        return table, read_s

    def _sidecar_plan_ok(self, plan: ScanPlan) -> bool:
        """Sidecars serve an OVERWRITE plan whose pushdown (when
        present) has a leaf conjunction the host can evaluate in encoded
        space."""
        if not self.config.scan.use_sidecar:
            return False
        if plan.mode is not UpdateMode.OVERWRITE:
            return False  # Append's BytesMerge needs exact Arrow bytes
        return plan.pushdown is None or plan.prune_leaves is not None

    def _resident_segment_parts(self, seg: SegmentPlan,
                                plan: ScanPlan) -> Optional[list]:
        """Event-loop-side tier-2 residency probe: every SST's encoded
        part for this plan's column set, straight from the cache — or
        None when any part is missing (or a negative memo says the
        sidecar path is doomed), in which case the full fetch path
        decides between store reads and parquet.  The pipeline's fetch
        stage uses it so all-resident segments read nothing."""
        if not self._sidecar_plan_ok(plan):
            return None
        if any(self.encoded_cache.is_missing(f.id) for f in seg.ssts):
            return None
        if self.encoded_cache.is_assembly_failed(
                frozenset(f.id for f in seg.ssts)):
            return None
        want = set(seg.columns) | {lf.column
                                   for lf in plan.prune_leaves or []}
        parts = []
        for f in seg.ssts:
            part = self.encoded_cache.get(f.id, want)
            if part is None:
                return None
            parts.append(part)
        return parts

    def _assemble_resident_segment(self, seg: SegmentPlan, parts: list,
                                   plan: ScanPlan
                                   ) -> Optional[sidecar.EncodedSegment]:
        """Pool-side assemble of tier-2-resident parts with the stage
        attribution the fetch path gives an assembled segment.  None =
        assembly failed (the CALLER memoizes the composition on the
        event loop and falls back to parquet — the cache's negative
        memos are loop-owned)."""
        t0 = time.perf_counter_ns()
        defer = plan.decode_spec is not None
        try:
            es = sidecar.assemble_parts(
                parts, list(seg.columns),
                None if defer else plan.prune_leaves)
        except Exception as exc:  # noqa: BLE001 — cache read only
            logger.warning("sidecar assembly raised for segment %s: %s",
                           seg.segment_start, exc)
            es = None
        if es is None:
            return None
        if defer:
            es.pending_leaves = list(plan.prune_leaves or [])
        t1 = time.perf_counter_ns()
        read_s = (t1 - t0) / 1e9
        _observe_stage("segment_read", t0, t1)
        _STAGE_SECONDS["sidecar_read"].observe(read_s)
        _STAGE_ROWS["sidecar_read"].inc(es.n)
        _STAGE_BYTES["sidecar_read"].inc(es.nbytes)
        trace_add("stage_sidecar_read_ms", read_s * 1e3)
        trace_add("stage_sidecar_read_rows", es.n)
        trace_add("stage_sidecar_read_bytes", es.nbytes)
        charge_scan_bytes(es.nbytes)
        return es

    async def _read_segment_encoded(self, seg: SegmentPlan, plan: ScanPlan,
                                    runner=None
                                    ) -> Optional[sidecar.EncodedSegment]:
        """Segment read that never touches parquet: serve each SST's
        encoded part from tier 2 when resident, fetch only the missing
        SSTs' sidecars (block-pruned under selective leaves), and
        assemble filtered, concatenated encoded columns.  After a flush
        (one new small SST in an otherwise unchanged segment) only that
        SST crosses the wire — and with write-through admission not even
        that.  None (-> parquet) when any SST lacks a valid sidecar.
        `runner` overrides the pool dispatch of the CPU-bound
        deserialize/assemble steps."""
        if any(self.encoded_cache.is_missing(f.id) for f in seg.ssts):
            return None  # known-missing sidecar: skip the GETs entirely
        seg_ids = frozenset(f.id for f in seg.ssts)
        if self.encoded_cache.is_assembly_failed(seg_ids):
            return None  # this exact composition is known unassemblable
        leaves = plan.prune_leaves
        want = set(seg.columns) | {lf.column for lf in leaves or []}

        if runner is None:
            def runner(fn, *args):  # CPU-bound deserialize off the loop
                return self._run_pool(fn, *args, pool=plan.pool)

        parts: list = [None] * len(seg.ssts)
        fetch: list[tuple[int, SstFile]] = []
        for i, f in enumerate(seg.ssts):
            part = self.encoded_cache.get(f.id, want)
            if part is None:
                fetch.append((i, f))
            else:
                parts[i] = part
        if fetch and len(fetch) < len(seg.ssts):
            _INCR_REMERGE.inc()
        # per-SST GETs overlap WITHIN the segment (one gather), and the
        # prefetch or the pipeline overlaps segments on top
        got = await asyncio.gather(*(
            sidecar.load_sst_encoded(
                self.store, sidecar.sidecar_path(self.root_path, f.id),
                want, leaves, runner=runner)
            for _i, f in fetch), return_exceptions=True)
        for (i, f), res in zip(fetch, got):
            if isinstance(res, NotFoundError):
                # permanent for this id (ids are immutable and the
                # sidecar is written before the SST becomes visible)
                self.encoded_cache.mark_missing(f.id)
                return None
            if isinstance(res, BaseException):
                # transient store failure: the sidecar is a cache — the
                # parquet read is authoritative
                logger.warning("sidecar fetch failed for sst %s: %s",
                               f.id, res)
                return None
            if res is None:
                self.encoded_cache.mark_missing(f.id)
                logger.warning("invalid sidecar for sst %s; using "
                               "parquet", f.id)
                return None
            parts[i] = res
            # only COMPLETE parts are cacheable: a block-pruned load
            # returned a row subset tied to this plan's leaves
            if res[1] == f.meta.num_rows:
                self.encoded_cache.put(f.id, res[0], res[1])
        # a device-decode plan DEFERS the exact leaf mask to the
        # dispatch's planning, which selects the surviving rows on the
        # host where the leaves drop rows and leaves the rest to the
        # card's encoded-space mask (a per-segment fallback resolves
        # the pending leaves on the host)
        defer = plan.decode_spec is not None
        try:
            es = await runner(sidecar.assemble_parts, parts,
                              list(seg.columns), None if defer else leaves)
        except Exception as exc:  # noqa: BLE001 — cache read only
            logger.warning("sidecar assembly raised for segment %s: %s",
                           seg.segment_start, exc)
            es = None
        if es is not None and defer:
            es.pending_leaves = list(leaves or [])
        if es is None:
            # cross-SST assembly failed: memoize the COMPOSITION, never
            # the member SSTs (each part deserialized fine, and the same
            # ids may assemble in another composition)
            self.encoded_cache.mark_assembly_failed(seg_ids)
            logger.warning("sidecar assembly failed for segment %s; "
                           "using parquet", seg.segment_start)
        return es

    async def _read_segment_table(self, seg: SegmentPlan,
                                  plan: ScanPlan) -> pa.Table:
        tables = await asyncio.gather(*(
            parquet_io.read_sst(self.store, sst_path(self.root_path, f.id),
                                columns=seg.columns, filters=plan.pushdown,
                                runtimes=self.runtimes, pool=plan.pool,
                                leaves=plan.prune_leaves,
                                # the manifest's size: big SSTs on remote
                                # stores stream into a file-backed mmap
                                size_hint=f.meta.size)
            for f in seg.ssts))
        return pa.concat_tables(tables)

    # ---- streamed segments -------------------------------------------------

    def _stream_segment(self, seg: SegmentPlan) -> bool:
        """True when this segment is read window by window instead of
        whole: manifest row count over the row threshold, OR stored
        byte size over the byte threshold — a wide-schema segment can
        be host-RAM-huge long before it reaches the row knob."""
        row_thresh = self.config.scan.stream_read_min_rows
        if row_thresh <= 0:
            return False  # 0 disables streaming entirely
        rows = sum(f.meta.num_rows for f in seg.ssts)
        if rows <= self.config.scan.max_window_rows:
            # everything fits one window: streaming would pay the
            # planning pass and still materialize the same window
            return False
        if rows > row_thresh:
            return True
        byte_thresh = self.config.scan.stream_read_min_bytes
        return byte_thresh > 0 and sum(
            f.meta.size for f in seg.ssts) > byte_thresh

    async def _read_streamed_windows(self, seg: SegmentPlan,
                                     plan: ScanPlan):
        """One streamed segment's windows: the sidecar stream first, the
        parquet two-pass streamer when a sidecar can't serve it.
        Returns (windows, read_seconds) — shared by the sequential pump
        and the pipeline's decode stage, so the two cannot drift."""
        t0 = time.perf_counter()
        es_iter = await self._open_sidecar_stream(seg, plan)
        if es_iter is not None:
            windows: list = []
            try:
                while True:
                    try:
                        es = await es_iter.__anext__()
                    except StopAsyncIteration:
                        return windows, time.perf_counter() - t0
                    except Exception as exc:  # noqa: BLE001 — the stream's
                        # reads only (a merge or kernel failure below is
                        # never caught): nothing of this segment has been
                        # yielded yet, so a whole-segment parquet read
                        # is clean
                        logger.warning(
                            "sidecar stream failed for segment %s (%s); "
                            "falling back to parquet", seg.segment_start,
                            exc)
                        break
                    windows.extend(await self._run_pool(
                        self._merge_segment, es, plan, pool=plan.pool))
            finally:
                await es_iter.aclose()
        windows = []
        async for batch in self._stream_window_batches(seg, plan):
            windows.extend(await self._run_pool(
                self._merge_batch, batch, pool=plan.pool))
        return windows, time.perf_counter() - t0

    async def _open_sidecar_stream(self, seg: SegmentPlan, plan: ScanPlan):
        """Streamed-segment windows straight from sidecars: PK
        value-range windows planned from per-block stats, each window
        loaded through the pruned loader with synthetic range leaves
        (sidecar.SstStreamSession / plan_stream_windows) — no parquet
        two-pass, no Arrow.  Returns an async generator of
        EncodedSegments, or None when any SST lacks a plannable sidecar
        (the parquet streamer serves the segment instead)."""
        if not self._sidecar_plan_ok(plan):
            return None
        if any(self.encoded_cache.is_missing(f.id) for f in seg.ssts):
            return None
        leaves = plan.prune_leaves or []
        want = set(seg.columns) | {lf.column for lf in leaves}

        def runner(fn, *args):
            return self._run_pool(fn, *args, pool=plan.pool)

        got = await asyncio.gather(*(
            sidecar.SstStreamSession.open(
                self.store, sidecar.sidecar_path(self.root_path, f.id),
                want, runner=runner)
            for f in seg.ssts), return_exceptions=True)
        sessions = []
        for f, res in zip(seg.ssts, got):
            if isinstance(res, NotFoundError) or res is None:
                # permanent per immutable id — the bulk path's memo
                self.encoded_cache.mark_missing(f.id)
                return None
            if isinstance(res, BaseException):
                logger.warning("sidecar stream open failed for sst "
                               "%s: %s", f.id, res)
                return None
            sessions.append(res)
        planned = await sidecar.plan_stream_windows(
            sessions, self._pk_names_in(list(seg.columns)),
            self.config.scan.max_window_rows)
        if planned is None:
            return None
        part_col, ranges = planned

        async def gen():
            rows = nbytes = 0
            for lo, hi in ranges:
                wleaves = list(leaves)
                if lo is not None:
                    wleaves.append(filter_ops.Ge(part_col, lo))
                if hi is not None:
                    wleaves.append(filter_ops.Lt(part_col, hi))
                parts = await asyncio.gather(*(
                    s.load_window(wleaves) for s in sessions))
                if any(p is None for p in parts):
                    raise Error("sidecar stream window failed")
                # a device-decode plan defers the exact window mask to
                # the dispatch — the synthetic range leaves keep windows
                # exactly disjoint there, as the host mask does
                defer = plan.decode_spec is not None
                es = await self._run_pool(
                    sidecar.assemble_parts, list(parts), list(seg.columns),
                    None if defer else wleaves, pool=plan.pool)
                if es is None:
                    raise Error("sidecar stream assembly failed")
                if defer:
                    es.pending_leaves = list(wleaves)
                if es.n:
                    rows += es.n
                    nbytes += es.nbytes
                    yield es
            # counters commit only on a COMPLETE stream: a mid-stream
            # failure re-serves the segment via parquet, which would
            # otherwise count the yielded windows twice
            _STAGE_ROWS["sidecar_read"].inc(rows)
            _STAGE_BYTES["sidecar_read"].inc(nbytes)
            trace_add("stage_sidecar_read_rows", rows)
            trace_add("stage_sidecar_read_bytes", nbytes)
            charge_scan_bytes(nbytes)

        return gen()

    async def _stream_window_batches(self, seg: SegmentPlan,
                                     plan: ScanPlan,
                                     strict_no_replay: bool = False):
        """The parquet streamer (the reference's pull-based batch
        streaming, read.rs:346-385, re-shaped for windows): pass 1 scans
        ONE PK column's values to plan value-range windows of <=
        max_window_rows; pass 2 reads each window's rows via parquet
        predicate pushdown.  Host materialization is bounded by the
        window budget, not the segment size.  Yields one Arrow batch
        per window, PK-range ascending, each encoded WINDOW-LOCALLY
        downstream.

        A compaction that deletes an input mid-segment: the segment's
        current SSTs are resolved again (resolve_segment_ssts; the
        compacted output holds the same rows) and the remaining value
        ranges, which partition rows independently of file boundaries,
        read from them.  After three failed attempts the NotFoundError
        goes to the caller's replan — unless `strict_no_replay` and a
        window was already yielded: an Append consumer has emitted it
        downstream, so a replan would duplicate rows, and the read
        fails with a non-retryable Error instead."""
        import pyarrow.compute as pc

        # one source per SST: local stores mmap, remote stores download
        # the object ONCE and serve both passes and every window from it
        sources = await asyncio.gather(*(
            parquet_io.open_sst_source(self.store,
                                       sst_path(self.root_path, f.id))
            for f in seg.ssts))

        pk_names = self._pk_names_in(seg.columns)
        values = counts = None
        part_col = pk_names[-1]
        for nm in pk_names:
            per_sst = await asyncio.gather(*(
                self._run_pool(src.value_counts, nm, pool=plan.pool)
                for src in sources))
            values, counts = parquet_io.merge_value_counts(per_sst)
            if len(values) == 0:
                return  # segment is empty
            if len(values) > 1:
                part_col = nm
                break
            # constant column: windowing on it cannot bound anything
        window = self.config.scan.max_window_rows
        ranges: list[tuple] = []
        start = acc = 0
        for i, c in enumerate(counts):
            if acc and acc + int(c) > window:
                ranges.append((values[start], values[i - 1]))
                start, acc = i, 0
            acc += int(c)
        if acc:
            ranges.append((values[start], values[-1]))

        def pyval(x):
            return x.item() if hasattr(x, "item") else x

        yielded_any = False
        for lo, hi in ranges:
            # streamed segments can span many windows: check the
            # deadline before paying for each window's pushdown read
            deadline_checkpoint()
            expr = (pc.field(part_col) >= pyval(lo)) \
                & (pc.field(part_col) <= pyval(hi))
            if plan.pushdown is not None:
                expr = expr & plan.pushdown
            refresh = False
            for attempt in range(3):
                try:
                    if refresh:
                        # re-resolution and re-open can race a second
                        # deletion: inside the try, they consume an
                        # attempt too
                        fresh = await self.resolve_segment_ssts(
                            seg.segment_start, plan.range)
                        sources = await asyncio.gather(*(
                            parquet_io.open_sst_source(
                                self.store, sst_path(self.root_path, f.id))
                            for f in fresh))
                        refresh = False
                    if not sources:
                        return  # the whole segment vanished (TTL GC)
                    tables = await asyncio.gather(*(
                        self._run_pool(functools.partial(
                            src.read, columns=seg.columns, filters=expr),
                            pool=plan.pool)
                        for src in sources))
                    break
                except NotFoundError:
                    if self.resolve_segment_ssts is None or attempt == 2:
                        if strict_no_replay and yielded_any:
                            raise Error(
                                f"streamed segment {seg.segment_start} "
                                "lost its SSTs mid-stream after retries; "
                                "failing rather than duplicating "
                                "already-emitted rows")
                        raise
                    refresh = True
            tbl = pa.concat_tables(tables)
            if tbl.num_rows:
                yielded_any = True
                yield tbl.combine_chunks().to_batches()[0]

    def _pk_names_in(self, columns: list[str]) -> list[str]:
        """PK names present, in SCHEMA order — the merge must sort by the
        declared key order even when a projection reordered columns."""
        present = set(columns)
        return [n for n in self.schema.primary_key_names if n in present]

    def _merge_segment(self, table, plan: Optional[ScanPlan] = None
                       ) -> list:
        """Pool-side encode + host merge of one segment's read result
        (pa.Table or sidecar.EncodedSegment) into post-merge windows.

        A plan routed to the device decode (plan.decode_spec set) sends
        an EncodedSegment through the dispatch instead: [DevicePart],
        the segment's finished aggregate partial.  A segment the
        dispatch declines takes the host merge with its reason counted,
        its deferred leaves applied first; a parquet segment of such a
        plan counts "parquet"."""
        decode = plan is not None and plan.decode_spec is not None
        if isinstance(table, sidecar.EncodedSegment):
            if decode:
                part = self._dispatch_device_decode(table, plan)
                if part is not None:
                    # a DevicePart, or on a [scan.mesh] plan a DecodePlan
                    # the mesh pump batches into decode rounds
                    return [part]
            table = sidecar.apply_leaves_host(table)
        elif decode:
            device_decode.note_fallback("parquet")
        if not isinstance(table, sidecar.EncodedSegment):
            if table.num_rows == 0:
                return []
            return self._merge_batch(table.combine_chunks().to_batches()[0])
        t0 = time.perf_counter_ns()
        _STAGE_ROWS["merge"].inc(table.n)
        try:
            return self._merge_windows(_encoded_to_device_batch(table),
                                       list(table.names))
        finally:
            _observe_stage("merge", t0)

    def _merge_batch(self, batch: pa.RecordBatch) -> list:
        """Encode + host merge of one Arrow batch (a parquet segment, or
        one window of the parquet streamer)."""
        t0 = time.perf_counter_ns()
        _STAGE_ROWS["merge"].inc(batch.num_rows)
        try:
            return self._merge_windows(encode.encode_batch(batch),
                                       list(batch.schema.names))
        finally:
            _observe_stage("merge", t0)

    def _dispatch_device_decode(self, es: sidecar.EncodedSegment,
                                plan: ScanPlan
                                ) -> Optional[device_decode.DevicePart]:
        """One EncodedSegment through the device decode, finished; None
        (the reason counted) when its layout can't ride it.  A
        [scan.mesh] plan (decode_defer) gets the segment's DecodePlan
        instead: the mesh pump uploads and runs it in a decode round."""
        spec = plan.decode_spec
        if plan.decode_defer:
            got = device_decode.plan_dispatch(
                es, spec, pk_names=self._pk_names_in(list(es.names)),
                seq_name=SEQ_COLUMN_NAME, leaves=es.pending_leaves or [],
                max_bytes=self.config.scan.decode.max_upload_bytes,
                width=self._window_grid_width(spec),
                pad_capacity=encode.pad_capacity)
            if isinstance(got, str):
                device_decode.note_fallback(got)
                return None
            return got
        got = device_decode.prepare_dispatch(
            es, spec, pk_names=self._pk_names_in(list(es.names)),
            seq_name=SEQ_COLUMN_NAME, leaves=es.pending_leaves or [],
            max_bytes=self.config.scan.decode.max_upload_bytes,
            width=self._window_grid_width(spec),
            pad_capacity=encode.pad_capacity, device=self.device)
        if isinstance(got, str):
            device_decode.note_fallback(got)
            return None
        return got

    def _merge_windows(self, dev: encode.DeviceBatch, names: list) -> list:
        """The host merge (the JAX package's default host_perm layout):
        plan the k-way-merge permutation over the pre-sorted SST runs,
        keep the last row of each PK run, and hand out HOST-resident,
        padded windows of at most max_window_rows (PK-range partitions,
        so every equal-PK run lands in exactly one window)."""
        pk_names = self._pk_names_in(names)
        ensure(len(pk_names) == self.schema.num_primary_keys,
               "projection lost primary key columns")
        n = dev.n_valid
        if n == 0:
            return []
        host_cols = {name: np.asarray(c)[:n]
                     for name, c in dev.columns.items()}

        # sort-operand elision: PK columns constant across the segment
        # cannot affect the order
        def is_const(a: np.ndarray) -> bool:
            return len(a) == 0 or (a[0] == a[-1]
                                   and bool((a == a[0]).all()))

        sort_pk_names = [nm for nm in pk_names
                         if not is_const(host_cols[nm])] or pk_names[:1]
        seq_h = host_cols[SEQ_COLUMN_NAME]
        seq_ordered = bool(np.all(seq_h[1:] >= seq_h[:-1]))
        window = self.config.scan.max_window_rows
        if n <= window:
            selections: list = [None]
        else:
            selections = _plan_pk_windows(host_cols[sort_pk_names[0]],
                                          window)
        return [encode.DeviceBatch(columns=cols, encodings=enc, n_valid=k,
                                   capacity=cap)
                for cols, k, cap, enc in _host_merge_window_descs(
                    dev, host_cols, sort_pk_names, seq_h, seq_ordered,
                    selections, n)]

    # ---- aggregate dispatch ------------------------------------------------

    async def execute_aggregate(self, plan: ScanPlan, spec: AggregateSpec):
        """Merge + downsample, returning (group_values, grids) combined
        across all segments and windows, by the path fused_aggregate_ok
        picks: fused grids are tensors on the reader's device (last_ts a
        host float64 array), parts grids are the combine's host float64
        arrays."""
        marks = self._mem_delta_marks()
        try:
            if self.fused_aggregate_ok(plan):
                return await self.execute_aggregate_fused(plan, spec)
            # collected per segment and folded in segment order:
            # memo-served segments yield out of plan order, and the
            # combine fold order is part of the bit-identity contract
            done: dict[int, list] = {}
            async for seg_start, seg_parts in self.aggregate_segments(
                    plan, spec):
                done[seg_start] = seg_parts
            parts = [p for s in sorted(done) for p in done[s]]
            return self.finalize_aggregate(parts, spec)
        finally:
            # cold scans move megabytes into the cache tiers; the trace
            # shows which account they landed in
            self._mem_delta_attribute(marks)

    def router_covers(self, plan: ScanPlan) -> bool:
        """Whether the attached near-data router would serve any of
        this plan's segments.  scan_aggregate consults it ahead of the
        fused gate: the fused accumulator needs every segment's windows
        host-resident — exactly the shipped-segment cost the agents
        exist to avoid — so covered plans take the parts path."""
        return (self.scan_router is not None
                and plan.range is not None
                and self.scan_router.covers_any(plan.segments))

    def fused_aggregate_ok(self, plan: Optional[ScanPlan] = None) -> bool:
        """Whether the fused device-accumulated aggregate serves this
        scan (see _fused_agg_ok_base for its own gates).  An explicit
        [scan.decode] mode = "device" outranks it for decode-eligible
        plans: the fused accumulator pays host decode for every window,
        the wall the device decode removes.  HORAEDB_FUSED_AGG=1 still
        wins."""
        if not self._fused_agg_ok_base(plan):
            return False
        if os.environ.get("HORAEDB_FUSED_AGG", "") == "1":
            return True
        return not (plan is not None and self._decode_mode() == "device"
                    and self._device_decode_plan_ok(plan, count=False))

    def _fused_agg_ok_base(self, plan: Optional[ScanPlan] = None) -> bool:
        """The fused aggregate's own gate.  The fused path is two-phase
        (all windows are collected before the union group space is
        known), so unlike the parts path it pins every window in host
        RAM for the query: a plan
        whose estimated rows x _CACHE_BYTES_PER_ROW exceed the scan
        cache budget takes the parts path.  HORAEDB_FUSED_AGG=1/0
        forces the fused path on/off, the budget included.

        The JAX package also declines on its XLA-CPU backend, where
        downloads are free and scatters slow.  That clause encodes
        XLA-CPU economics; the port's device="cpu" is a test mode, so
        it has no such clause and its CPU tests keep the fused path.

        A mesh declines it: the 1-D mesh's rounds and the device_sort
        merge layout keep the per-round parts; [scan.mesh] supersedes the
        single-device accumulator with the mesh's parts path."""
        if plan is not None and plan.parts_route:
            return False
        if self.mesh is not None or merge_ops.merge_impl() != "host_perm":
            return False
        if self.scan_mesh is not None:
            return False
        forced = os.environ.get("HORAEDB_FUSED_AGG", "")
        if forced == "1":
            return True
        if forced == "0":
            return False
        if plan is not None:
            est_rows = sum(f.meta.num_rows
                           for seg in plan.segments for f in seg.ssts)
            if est_rows * _CACHE_BYTES_PER_ROW > self.cache_budget_bytes:
                return False
        return True

    def _decode_mode(self) -> str:
        """The [scan.decode] mode in force: HORAEDB_DEVICE_DECODE=1/0
        forces device/host over the config."""
        forced = os.environ.get("HORAEDB_DEVICE_DECODE", "")
        if forced == "1":
            return "device"
        if forced == "0":
            return "host"
        return self.config.scan.decode.mode

    def _device_decode_plan_ok(self, plan: ScanPlan,
                               count: bool = True) -> bool:
        """Plan-level gate of the device decode (ops/device_decode.py).
        Declines are counted in scan_decode_fallback_total:<reason>
        unless `count` is False (the fused gate probes without counting).

        "auto" engages on a CUDA reader for plans the fused aggregate
        declines on its own terms (the oversized cold shape whose
        windows can't pin in RAM anyway); a CPU reader keeps host
        decode.  "device" forces the dispatch wherever structurally
        possible; "host" is the bit-identity control.  The per-SEGMENT
        gates (encodings, dtype, upload budget) are in plan_dispatch."""
        mode = self._decode_mode()
        note = device_decode.note_fallback if count else (lambda _r: None)
        if mode == "host":
            return False
        if mode == "auto" and (not self.on_cuda
                               or self._fused_agg_ok_base(plan)):
            # auto + the 2-D scan mesh rides the mesh decode rounds
            # (plan.decode_defer) on a CUDA reader
            return False
        if self.mesh is not None:
            note("mesh")
            return False
        if plan.mode is not UpdateMode.OVERWRITE:
            note("append_mode")
            return False
        if plan.predicate is not None and not plan.pushed_complete:
            # value-column leaves interact with last-value dedup, and
            # Or/Not shapes have no pushed conjunction: host decode
            # evaluates those after the merge.  Checked before the
            # sidecar gate, which such a predicate also fails
            note("predicate")
            return False
        if not device_decode.leaf_shape_supported(plan.prune_leaves):
            note("predicate")
            return False
        if not self._sidecar_plan_ok(plan):
            note("no_sidecar")
            return False
        return True

    # ---- the parts path ----------------------------------------------------

    async def aggregate_segments(self, plan: ScanPlan, spec: AggregateSpec,
                                 top_k=None):
        """Per segment, yield (segment_start, partial parts) — the
        retryable unit of scan_aggregate (segments already yielded are
        skipped on a replan; a segment is yielded only once ALL its
        windows are aggregated).

        Memo-served segments come first and are dropped from the scan
        plan, so a narrowed/refined range re-scans only the delta
        segments; callers fold parts in sorted segment order, so yield
        order is free.

        [scan.mesh] plans route their local scans through the 2-D mesh
        pump (same yield contract; a round the mesh declines runs on
        the single-device kernel, its reason counted).  `top_k` there
        enables the device-scored winner-sliced route, which bypasses
        the memo (its parts are winner slices) and yields only after all
        compute, so a compaction race replans from zero.  On one device
        every part goes to finalize_aggregate, which ranks."""
        ensure(plan.mode is UpdateMode.OVERWRITE,
               "aggregate pushdown requires Overwrite mode")
        # device decode: an eligible plan threads the spec to the segment
        # reads, whose sidecar segments come back as finished DeviceParts
        # (a copy, so the caller's plan stays reusable)
        if self._device_decode_plan_ok(plan):
            plan = dc_replace(plan, decode_spec=spec)
        use_mesh = self._mesh_plan_ok(plan)
        if use_mesh:
            # decode-eligible plans DEFER the dispatch: DecodePlans ride
            # the windows lists into per-round mesh decode programs
            plan = dc_replace(plan, decode_defer=plan.decode_spec is not None)
            if top_k is not None and self._mesh_topk_ok(plan, spec, top_k):
                pump = self._aggregate_topk_mesh(plan, spec, top_k)
                try:
                    async for out in pump:
                        yield out
                finally:
                    await pump.aclose()
                return
        memo = self.parts_memo
        use_memo = memo.enabled and plan.use_cache
        seg_keys: dict[int, tuple] = {}
        memo_pred_key = ""
        if use_memo:
            memo_pred_key = filter_ops.canonical_predicate_key(
                plan.predicate)
            remaining = []
            for seg in plan.segments:
                key = self._cache_key(seg, plan)
                seg_keys[seg.segment_start] = key
                got = memo.probe(key, seg.segment_start,
                                 self.segment_duration_ms, spec,
                                 memo_pred_key)
                if got is None:
                    remaining.append(seg)
                else:
                    yield seg.segment_start, got
            if len(remaining) < len(plan.segments):
                plan = dc_replace(plan, segments=remaining)
            if not remaining:
                return

        def memo_store(seg_start: int, parts: list) -> None:
            if use_memo:
                memo.store(seg_keys[seg_start], spec, memo_pred_key,
                           parts)

        router = self.scan_router
        covered: list = []
        uncovered = plan.segments
        if (router is not None and router.active
                and plan.range is not None):
            covered, uncovered = router.split(plan.segments)
        # local scans route through the mesh pump when [scan.mesh] is on
        pump_fn = (self._aggregate_segments_mesh if use_mesh
                   else self._aggregate_segments_pump)
        # every pump iteration below carries an explicit aclose on
        # abandonment: the pump's in-flight fetch/decode/device tasks
        # must not outlive a closed consumer into table teardown
        if not covered:
            pump = pump_fn(plan, spec, memo_store)
            try:
                async for out in pump:
                    yield out
            finally:
                await pump.aclose()
            return
        # near-data routing: agent RPCs run as one background gather
        # while the local pump scans the uncovered segments, so the
        # coordinator's store reads and the agents' shard scans overlap
        agent_task = asyncio.create_task(
            router.gather(plan, spec, covered))
        try:
            if uncovered:
                pump = pump_fn(
                    dc_replace(plan, segments=list(uncovered)), spec,
                    memo_store)
                try:
                    async for out in pump:
                        yield out
                finally:
                    await pump.aclose()
            served, failed = await agent_task
            agent_task = None
        finally:
            if agent_task is not None:
                # local-pump failure/cancellation: the gather must not
                # outlive the scan into table teardown
                agent_task.cancel()
                await asyncio.gather(agent_task, return_exceptions=True)
        for seg_start, parts in served:
            memo_store(seg_start, parts)
            yield seg_start, parts
        if failed:
            # THE declared fallback seam: failed covered segments go
            # through the exact local pump the unrouted scan uses —
            # direct store reads happen here and nowhere else on the
            # routed path
            pump = pump_fn(
                dc_replace(plan, segments=list(failed)), spec, memo_store)
            try:
                async for out in pump:
                    yield out
            finally:
                await pump.aclose()

    async def _aggregate_segments_pump(self, plan: ScanPlan,
                                       spec: AggregateSpec, memo_store):
        """The local aggregate pipeline (read -> merge -> device rounds)
        over `plan.segments`.

        Windows from different segments batch into rounds of
        `scan.agg_batch_windows`, one kernel launch per round.  Segments
        partition time and windows partition PKs, so no two windows
        share a (group, bucket, timestamp) cell and the host combine has
        no tie-break subtleties.

        When the scan runs through the pipeline (plan.pipeline_active,
        decided by _cached_windows once it has probed for store I/O),
        ONE round runs as a background task — the device stage — while
        this loop pulls and preps the next windows; rounds still apply
        in dispatch order, so every segment's parts are the sequential
        path's."""
        from horaedb_tpu_torch.storage import pipeline as pipeline_mod

        batch_w = (self.mesh.size if self.mesh is not None
                   else max(1, self.config.scan.agg_batch_windows))
        queue: list = []
        parts: dict[int, list] = {}
        pending: dict[int, int] = {}
        arrived: deque = deque()
        flush_task: Optional[asyncio.Task] = None

        def apply(flushed) -> None:
            for seg_start, part in flushed:
                parts[seg_start].append(part)
                pending[seg_start] -= 1

        async def settle_flush() -> None:
            nonlocal flush_task
            if flush_task is None:
                return
            t, flush_task = flush_task, None
            apply(await t)

        async def flush_round(chunk: list) -> list:
            # the stage's seconds are observed around the round itself
            # (pool-queue wait included), not dispatch-to-settle, which
            # would absorb the consumer's waits on fetch and decode
            out, t0, t1 = await self._run_round(
                self._flush_host_round, chunk, spec, plan, pool=plan.pool)
            pipeline_mod.observe_stage(
                "device", t0, t1_ns=t1,
                rows=sum(w.n_valid for _s, w, _p in chunk))
            return out

        async def flush(k: int) -> None:
            nonlocal flush_task
            chunk = queue[:k]
            del queue[:k]
            if not plan.pipeline_active:
                apply(await self._run_pool(self._flush_host_round, chunk,
                                           spec, plan, pool=plan.pool))
                return
            # stage-boundary checkpoint: no new device round for an
            # expired query (the in-flight one drains via settle)
            deadline_checkpoint()
            await settle_flush()
            flush_task = asyncio.create_task(flush_round(chunk))

        def finished():
            while arrived and pending[arrived[0]] == 0:
                s0 = arrived.popleft()
                seg_parts = parts.pop(s0)
                memo_store(s0, seg_parts)
                yield s0, seg_parts

        try:
            windows_iter = self._cached_windows(plan)
            try:
                async for seg, windows, read_s in windows_iter:
                    t0 = time.perf_counter()
                    s = seg.segment_start
                    arrived.append(s)
                    parts[s] = []
                    pending[s] = 0

                    def prep_windows(ws=windows):
                        out = []
                        for w in ws:
                            # same semantics as the row path: post-dedup
                            # rows
                            _ROWS_SCANNED.inc(w.n_valid)
                            if isinstance(w, device_decode.DevicePart):
                                # a finished partial rides the queue
                                # with prep None, so a segment's parts
                                # keep their order; a provably empty one
                                # never enqueues (no flush would repay
                                # its pending count)
                                if w.part is not None:
                                    out.append((w, None))
                                continue
                            prep = self._window_groups(w, spec, plan)
                            if prep is not None:
                                out.append((w, prep))
                        return out

                    for w, prep in await self._run_pool(prep_windows,
                                                        pool=plan.pool):
                        queue.append((s, w, prep))
                        pending[s] += 1
                    while len(queue) >= batch_w:
                        await flush(batch_w)
                    _SCAN_LATENCY.observe(read_s
                                          + (time.perf_counter() - t0))
                    for out in finished():
                        yield out
            except NotFoundError:
                # a compaction race: the round in flight still lands and
                # the segments it finishes are yielded, so the caller's
                # replan re-reads only the segments left
                await settle_flush()
                for out in finished():
                    yield out
                raise
            finally:
                await windows_iter.aclose()
            if queue:
                await flush(len(queue))
            await settle_flush()
            for out in finished():
                yield out
        finally:
            if flush_task is not None:
                # a cancelled or failed scan drains its in-flight round
                # (the pool job runs to completion regardless), so it
                # never races table teardown
                flush_task.cancel()
                await asyncio.gather(flush_task, return_exceptions=True)

    def _flush_host_round(self, items: list, spec: AggregateSpec,
                          plan: ScanPlan) -> list:
        """One round of host windows (possibly from several segments) as
        ONE bucket_window_partials launch over the round's stacks.

        items: [(seg_start, window, (group_values, gid_full, shift))].
        Returns [(seg_start, (round_values, bucket_lo, partial grids))]
        in item order; every part shares the round's union group values
        (rows a window didn't touch have count 0 and fold away in the
        combine).  The partial grids come to the host once per round;
        padding windows and groups are sliced away on the device first,
        and window-local last_ts is re-based to range-relative.

        Device-decode items (window a DevicePart, prep None) pass their
        finished part through in position, with no launch of their own."""
        if any(it[2] is None for it in items):
            host = [it for it in items if it[2] is not None]
            done = iter(self._flush_host_round(host, spec, plan)
                        if host else ())
            return [(s, w.part) if prep is None else next(done)
                    for s, w, prep in items]
        if self.mesh is not None:
            # one window per segment-mesh slot
            batch_w = self.mesh.size
        else:
            # pow2 width >= len(items): full rounds share one shape, tail
            # rounds use narrower ones
            batch_w = min(max(1, self.config.scan.agg_batch_windows),
                          1 << (len(items) - 1).bit_length())
        round_values = np.unique(np.concatenate([it[2][0] for it in items]))
        g = len(round_values)
        g_pad = max(8, 1 << (g - 1).bit_length())
        cap = max(it[1].capacity for it in items)
        # offset-encoded ts columns bound each window's bucket range (the
        # epoch is the segment table's min ts); anything else takes
        # full-range grids with lo=0
        local_ok = all(it[1].encodings[spec.ts_col].kind == "offset"
                       for it in items)
        width = (self._window_grid_width(spec) if local_ok
                 else spec.num_buckets)
        put = None
        if self.mesh is not None:
            from horaedb_tpu_torch.parallel.scan import shard_leading_axis

            put = functools.partial(shard_leading_axis, self.mesh)
        (ts_s, gid_s, val_s, _nv_d, nv_h, remap_d, shift_d, lo_d,
         lo) = self._build_round_stacks(items, spec, plan, batch_w, cap,
                                        g_pad, width, round_values,
                                        local_ok, put=put)
        t_dev = time.perf_counter_ns()
        # rows past a window's own n_valid carry gid -1, so the round's
        # largest row count bounds every window
        if self.mesh is not None:
            # the program per grid shape, memoized like the JAX
            # package's compiled shard_map closures
            fn_key = (g_pad, width, spec.which)
            fn = self._mesh_agg_fns.get(fn_key)
            if fn is None:
                from horaedb_tpu_torch.parallel.scan import (
                    sharded_remap_partials,
                )

                fn = sharded_remap_partials(self.mesh, num_groups=g_pad,
                                            num_buckets=width,
                                            which=spec.which)
                self._mesh_agg_fns[fn_key] = fn
            stacked = fn(ts_s, gid_s, val_s, remap_d, shift_d, lo_d,
                         spec.num_buckets, spec.bucket_ms,
                         n_valid=int(nv_h.max()))
            host = {k: v.numpy()[:len(items), :g]
                    for k, v in stacked.items()}
        else:
            stacked = bucket_agg.bucket_window_partials(
                ts_s, gid_s, val_s, remap_d, shift_d, lo_d,
                spec.num_buckets, spec.bucket_ms, num_groups=g_pad,
                width=width, which=spec.which, n_valid=int(nv_h.max()))
            host = {k: deviceprof.download(v[:len(items), :g])
                    for k, v in stacked.items()}
        _PARTS_ROUNDS.inc()
        _PARTIALS_D2H_BYTES.inc(sum(int(v.nbytes) for v in host.values()))
        _observe_stage("device_aggregate", t_dev)
        parts = []
        for d in range(len(items)):
            lo_w = int(lo[d])
            # a window starting past the grid (a parquet-streamed chunk
            # whose own epoch lies beyond the range) keeps no column
            w_eff = max(0, min(width, spec.num_buckets - lo_w))
            grids = {k: v[d, :, :w_eff] for k, v in host.items()}
            if "last_ts" in grids:
                # window-local last_ts -> range_start-relative, so parts
                # with different offsets compare correctly
                lt = grids["last_ts"].astype(np.int64)
                grids["last_ts"] = np.where(
                    grids["count"] > 0, lt + lo_w * spec.bucket_ms, lt)
            parts.append((items[d][0], (round_values, lo_w, grids)))
        return parts

    # ---- the 2-D scan mesh ([scan.mesh]) ------------------------------------

    def _mesh_plan_ok(self, plan: ScanPlan) -> bool:
        """Plan-level [scan.mesh] routing gate; the per-round gates (sum
        overlap, count bound, grid budget) live in _run_mesh_round and
        fall back per round, each reason counted."""
        if self.scan_mesh is None:
            return False
        if plan.mode is not UpdateMode.OVERWRITE:
            return False
        if merge_ops.merge_impl() != "host_perm":
            # device_sort windows belong to the 1-D segment mesh; the
            # 2-D scan consumes host-merged windows
            note_mesh_fallback("merge_impl")
            return False
        return True

    def _mesh_topk_ok(self, plan: ScanPlan, spec: AggregateSpec,
                      tk) -> bool:
        """Whether a top-k query takes the device-scored, winner-sliced
        mesh route (egress bounded at O(k x buckets x aggs) per run).
        Selection rankings (min/max/last) score exactly on the mesh;
        additive ones (count/sum/avg) through the compensated (hi, lo)
        plane, with a counted `additive_topk` downgrade when an add is
        not provably exact.  Mixed-provenance scans (near-data partials,
        device-decode parts) keep the full-parts route, still
        mesh-combined."""
        if tk.by not in ("min", "max", "last", "count", "sum", "avg") \
                or not (tk.by == "count" or tk.by in set(spec.which)):
            # combine_top_k's requested-agg rule (count always folds)
            note_mesh_fallback("topk_by")
            return False
        if plan.decode_spec is not None:
            note_mesh_fallback("topk_decode")
            return False
        router = self.scan_router
        if (router is not None and router.active
                and plan.range is not None
                and router.split(plan.segments)[0]):
            # agent-served segments never reach the device score state
            note_mesh_fallback("topk_router")
            return False
        est_rows = sum(f.meta.num_rows
                       for seg in plan.segments for f in seg.ssts)
        if est_rows * _CACHE_BYTES_PER_ROW > self.cache_budget_bytes:
            # two-phase: every window pins in host RAM until the winners
            # are known (the fused path's budget discipline)
            note_mesh_fallback("topk_budget")
            return False
        return True

    @staticmethod
    def _mesh_runs(items: list) -> list[list]:
        """Consecutive same-segment slot runs of one round, as
        [seg_start, first_slot, last_slot] triples (plan-order slot
        admission keeps a segment's windows adjacent)."""
        runs: list[list] = []
        for i, (s, _w, _prep) in enumerate(items):
            if runs and runs[-1][0] == s:
                runs[-1][2] = i
            else:
                runs.append([s, i, i])
        return runs

    def _mesh_round_gates(self, items: list, runs: list,
                          spec: AggregateSpec, g_pad: int, width: int,
                          cap: int, local_ok: bool) -> None:
        """Per-round exactness and budget gates; raises _MeshFallback
        with the counted reason.  Only multi-slot runs combine on the
        mesh, so the exactness gates apply to those alone."""
        T = self.scan_mesh.shape["time"]
        want = combine_mod.expand_which(spec.which)
        multi = any(b > a for _s, a, b in runs)
        if multi and local_ok:
            # the cell-wise run combine is bucket-aligned only when
            # every slot of a run shares its first bucket `lo`: the
            # parquet-streamed fallback encodes each chunk with its OWN
            # epoch, so those runs combine per window off the mesh
            for _s, a, b in runs:
                lo0 = max(0, items[a][2][2] // spec.bucket_ms)
                for i in range(a + 1, b + 1):
                    if max(0, items[i][2][2] // spec.bucket_ms) != lo0:
                        raise _MeshFallback("run_misaligned")
        if multi and T * cap >= (1 << 24):
            # float32 integer adds stay exact below 2^24; a run's
            # combined per-cell count is bounded by slots x capacity
            raise _MeshFallback("count_bound")
        if multi and "sum" in want:
            # a group shared by two windows of one run would float32-add
            # sum cells the host folds in float64.  With the group column
            # the LEADING primary key, window group ranges are ordered,
            # so only adjacent boundary values can repeat; any other
            # group column can recur anywhere — every pair is checked
            lead_pk = (self.schema.primary_key_names[0] == spec.group_col
                       if self.schema.primary_key_names else False)
            for _s, a, b in runs:
                if lead_pk:
                    for i in range(a, b):
                        va, vb = items[i][2][0], items[i + 1][2][0]
                        if len(va) > 0 and len(vb) > 0 and va[-1] == vb[0]:
                            raise _MeshFallback("sum_overlap")
                else:
                    for i in range(a, b):
                        for j in range(i + 1, b + 1):
                            if np.intersect1d(items[i][2][0],
                                              items[j][2][0]).size:
                                raise _MeshFallback("sum_overlap")
        naggs = len(want) + (1 if "last" in want else 0)
        if g_pad * width * 4 * naggs > self.config.scan.mesh.max_grid_bytes:
            raise _MeshFallback("grid_budget")

    def _run_mesh_round(self, items: list, spec: AggregateSpec,
                        plan: ScanPlan, group_space=None,
                        download: bool = True, round_salt: int = 0):
        """One round of host windows on the 2-D scan mesh: per-slot
        window partials (series-sliced group blocks) plus the on-mesh
        segmented time-axis combine (parallel.scan.mesh_run_partials).

        download=True (the streaming pump): downloads each run TAIL's
        combined grids and returns [(seg_start, part, repay)] entries
        shaped like _flush_host_round's parts.  download=False (the
        top-k passes): returns the mesh outputs and the run layout;
        nothing leaves the mesh here."""
        from horaedb_tpu_torch.parallel.scan import (
            mesh_run_partials,
            shard_time_axis,
        )
        from horaedb_tpu_torch.storage import pipeline as pipeline_mod

        mesh = self.scan_mesh
        T = mesh.shape["time"]
        series = mesh.shape["series"]
        ensure(len(items) <= T, "mesh round exceeds the time axis")
        runs = self._mesh_runs(items)
        cap = max(it[1].capacity for it in items)
        if group_space is None:
            group_space = np.unique(
                np.concatenate([it[2][0] for it in items]))
        g = len(group_space)
        g_pad = max(8, series, 1 << (g - 1).bit_length())
        local_ok = all(it[1].encodings[spec.ts_col].kind == "offset"
                       for it in items)
        width = (self._window_grid_width(spec) if local_ok
                 else spec.num_buckets)
        self._mesh_round_gates(items, runs, spec, g_pad, width, cap,
                               local_ok)
        space_fp = (g, hash(group_space.tobytes()))
        # round_salt keeps consecutive rounds of one segment that share
        # (seg0, T, cap, ...) apart in the stack cache
        stack_key = self._round_stack_key(items[0][0], spec, plan, T, cap,
                                          g_pad, width, space_fp) \
            + (round_salt,)
        (ts_s, gid_s, val_s, _nv_d, nv_h, remap_d, shift_d, lo_dev,
         lo) = self._build_round_stacks(
            items, spec, plan, T, cap, g_pad, width, group_space, local_ok,
            stack_key=stack_key,
            put=functools.partial(shard_time_axis, mesh),
            key_salt=("mesh2",))
        if any(int(lo[b]) >= spec.num_buckets for _s, _a, b in runs):
            raise _MeshFallback("lo_range")
        fn_key = (g_pad, width, spec.which)
        fn = self._mesh_run_fns.get(fn_key)
        if fn is None:
            fn = mesh_run_partials(mesh, num_groups=g_pad,
                                   num_buckets=width, which=spec.which)
            self._mesh_run_fns[fn_key] = fn
        # plan-order slot admission: slot i is item i; padding slots get
        # unique negative ids so they never combine
        seg_ids = -(np.arange(T, dtype=np.int32) + 1)
        for ridx, (_s, a, b) in enumerate(runs):
            seg_ids[a:b + 1] = ridx
        t0 = time.perf_counter_ns()
        # the kernel's ordered-sum row bound is the round's largest
        # window, as the single-device round passes it
        out = fn(ts_s, gid_s, val_s, remap_d, shift_d, lo_dev,
                 shard_time_axis(mesh, seg_ids), spec.num_buckets,
                 spec.bucket_ms, n_valid=int(nv_h.max()))
        _MESH_ROUNDS.inc()
        if len(items) < T:
            pipeline_mod.note_mesh_stall("time")
        if g <= (series - 1) * (g_pad // series):
            pipeline_mod.note_mesh_stall("series")
        rows_per_shard = [int(it[1].n_valid) for it in items]
        pad_rows = (T - len(items)) * cap \
            + sum(cap - r for r in rows_per_shard)
        if not download:
            _observe_stage("mesh_aggregate", t0)
            deviceprof.record_round(
                "mesh_run", slots=len(items), capacity=T,
                rows_per_shard=rows_per_shard, padding_rows=pad_rows,
                seconds=(time.perf_counter_ns() - t0) / 1e9)
            return {"out": out, "runs": runs, "lo": lo, "g": g,
                    "width": width}
        entries: list = []
        cells = 0
        t_dl = time.perf_counter()
        for s, a, b in runs:
            lo_run, grids = self._slice_mesh_part(out, b, g, int(lo[b]),
                                                  width, spec, timed=False)
            cells += sum(int(v.shape[0] * v.shape[1])
                         for v in grids.values())
            entries.append((s, (group_space, lo_run, grids), b - a + 1))
        # the tail downloads synced the round: the wall spent waiting
        # lands here, and the downloads charged their own d2h bytes
        # (untimed: their wall is this span's)
        deviceprof.observe_wait(time.perf_counter() - t_dl)
        _observe_stage("mesh_aggregate", t0)
        _MESH_PARTS.inc(len(entries))
        _MESH_PART_CELLS.inc(cells)
        deviceprof.record_round(
            "mesh_run", slots=len(items), capacity=T,
            rows_per_shard=rows_per_shard, padding_rows=pad_rows,
            seconds=(time.perf_counter_ns() - t0) / 1e9)
        return entries

    @staticmethod
    def _slice_mesh_part(out: dict, tail_slot: int, g: int, lo_run: int,
                         width: int, spec: AggregateSpec,
                         timed: bool = True):
        """THE mesh part emission, shared by the streaming download and
        the top-k winner pass: tail slot `tail_slot`'s combined grids
        sliced to the real group count (g < 0 keeps every row, the
        winner-sliced shape) and the query-clipped width, window-local
        last_ts rebased to range_start-relative int64 — the emission
        _flush_host_round's parts use.  `timed=False` inside a span that
        observe_wait charges whole."""
        w_eff = max(0, min(width, spec.num_buckets - lo_run))
        rows = slice(None) if g < 0 else slice(0, g)
        grids = {k: np.ascontiguousarray(
                     v.row(tail_slot, timed)[rows, :w_eff])
                 for k, v in out.items()}
        if "last_ts" in grids:
            lt = grids["last_ts"].astype(np.int64)
            grids["last_ts"] = np.where(
                grids["count"] > 0, lt + lo_run * spec.bucket_ms, lt)
        return lo_run, grids

    def _flush_mesh_round(self, items: list, spec: AggregateSpec,
                          plan: ScanPlan, round_salt: int = 0) -> list:
        """Pool-side mesh round flush: DevicePart entries pass through
        in position, deferred DecodePlans run as mesh decode rounds,
        host windows dispatch onto the mesh — falling back PER ROUND to
        the single-device kernel (_flush_host_round) when a gate
        declines or the dispatch raises, the reason counted.  Returns
        [(seg_start, part_or_None, repaid_windows)]."""
        out: list = []
        host_items: list = []
        deco_items: list = []
        for s, w, prep in items:
            if prep is None:
                out.append((s, w.part, 1))
            elif prep is _DECODE_PREP:
                deco_items.append((s, w))
            else:
                host_items.append((s, w, prep))
        if deco_items:
            out.extend(self._run_mesh_decode_rounds(deco_items, spec))
        if not host_items:
            return out
        try:
            out.extend(self._run_mesh_round(host_items, spec, plan,
                                            round_salt=round_salt))
            return out
        except _MeshFallback as f:
            note_mesh_fallback(f.reason)
        except Exception as exc:  # noqa: BLE001 — counted; the
            # single-device rounds below reproduce the result
            note_mesh_fallback("mesh_error")
            logger.warning("mesh round failed (%s); re-running the round "
                           "on the single-device kernel", exc)
        # single-device rounds are capped at agg_batch_windows; a mesh
        # chunk can be wider, so split it (per-window grids do not
        # depend on the round's composition)
        hb = max(1, self.config.scan.agg_batch_windows)
        flushed: list = []
        for i in range(0, len(host_items), hb):
            flushed.extend(self._flush_host_round(host_items[i:i + hb],
                                                  spec, plan))
        out.extend((s, part, 1) for s, part in flushed)
        return out

    def _run_mesh_decode_rounds(self, deco: list,
                                spec: AggregateSpec) -> list:
        """Batch one flush's deferred DecodePlans into mesh decode
        rounds: plans group by static_key in arrival order, and each
        time-axis-wide chunk runs as ONE mesh dispatch.  A round that
        declines (budget) or fails falls back PER ITEM to the standalone
        dispatch (execute_plan): still device decode, just not
        mesh-placed; reasons counted in scan_mesh_fallback_total."""
        T = self.scan_mesh.shape["time"]
        groups: dict = {}
        order: list = []
        for s, dp in deco:
            k = dp.static_key()
            if k not in groups:
                groups[k] = []
                order.append(k)
            groups[k].append((s, dp))
        entries: list = []
        for k in order:
            grp = groups[k]
            for i in range(0, len(grp), T):
                chunk = grp[i:i + T]
                try:
                    entries.extend(self._run_mesh_decode_round(chunk, spec))
                    continue
                except _MeshFallback as f:
                    note_mesh_fallback(f.reason)
                except Exception as exc:  # noqa: BLE001 — counted; the
                    # per-segment dispatch reproduces the parts
                    note_mesh_fallback("mesh_error")
                    logger.warning("mesh decode round failed (%s); "
                                   "running the per-segment dispatch", exc)
                for s, dp in chunk:
                    with device_decode._DISPATCH_LOCK:
                        part = device_decode.execute_plan(
                            dp, self.device).finalize()
                    entries.append((s, part.part, 1))
        return entries

    def _run_mesh_decode_round(self, chunk: list,
                               spec: AggregateSpec) -> list:
        """ONE mesh program from stored bytes to combined run grids:
        stack the chunk's raw encoded columns one segment per time slot,
        run leaf filter + (k-way merge | sort | presorted) + keep-last
        dedup + bucket aggregate + the segmented combine
        (parallel.scan.mesh_decode_partials), then download run-TAIL
        grids only.

        Slot-local group codes ARE the round rows (identity remap):
        consecutive same-segment slots share a seg id — and so combine
        on the mesh — only when their dictionaries, first bucket, group
        count and clipped width all match AND the combine is exact for
        the requested aggregates (no additive sum cells, the count
        bound); everything else gets its own id and comes back as its
        own part, exactly what the standalone dispatches would emit."""
        from horaedb_tpu_torch.parallel.scan import (
            mesh_decode_partials,
            shard_time_axis,
            stack_time_axis,
        )
        from horaedb_tpu_torch.storage import pipeline as pipeline_mod

        mesh = self.scan_mesh
        T = mesh.shape["time"]
        series = mesh.shape["series"]
        dps = [dp for _s, dp in chunk]
        dp0 = dps[0]
        cap = max(dp.cap for dp in dps)
        g_pad = max(8, series, max(dp.g_pad for dp in dps))
        width = max(dp.use_width for dp in dps)
        want = combine_mod.expand_which(spec.which)
        naggs = len(want) + (1 if "last" in want else 0)
        ncol = len(dp0.upload_names)
        if (T * cap * 4 * ncol > self.config.scan.decode.max_upload_bytes
                or T * g_pad * width * 4 * naggs
                > self.config.scan.mesh.max_grid_bytes):
            raise _MeshFallback("mesh_decode_budget")
        sharable = "sum" not in want and T * cap < (1 << 24)
        seg_ids = -(np.arange(T, dtype=np.int32) + 1)
        rid = -1
        for i, (s, dp) in enumerate(chunk):
            joined = False
            if i and sharable:
                ps, pdp = chunk[i - 1]
                joined = (ps == s and pdp.lo == dp.lo
                          and pdp.shift == dp.shift
                          and pdp.g == dp.g and pdp.w_eff == dp.w_eff
                          and np.array_equal(pdp.values, dp.values))
            if not joined:
                rid += 1
            seg_ids[i] = rid
        t0 = time.perf_counter_ns()
        put = functools.partial(shard_time_axis, mesh)
        # decode round stacks ride the stack cache's LRU and weakref
        # discipline, anchored on the cached EncodedSegments as read (a
        # plan's selected rows follow from its segment and its leaf
        # constants, and their count is in the key)
        ncst = len(dp0.consts)
        stack_key = ("meshdecode", dp0.static_key(), cap, T,
                     tuple((s, dp.shift, dp.lo, dp.rows.n,
                            tuple(c.tobytes() for c in dp.consts))
                           for s, dp in chunk))
        es_list = tuple(dp.es for dp in dps)
        nv = np.zeros(T, dtype=np.int32)
        for t, (_s, dp) in enumerate(chunk):
            nv[t] = dp.rows.n
        cached = self._stack_cache_get(stack_key, es_list)
        if cached is not None:
            cols_dev = cached[:ncol]
            consts_dev = cached[ncol:ncol + ncst]
            offs_dev, shift_dev, lo_dev = cached[ncol + ncst:]
            upload_bytes = 0
        else:
            # one (T, cap) matrix per upload column, assembled on the
            # device from each slot's column; padding slots all zero
            # with n_valid 0 (every row invalid)
            cols_dev = tuple(
                stack_time_axis(mesh, [dp.rows.columns[nm] for dp in dps],
                                cap, dp0.rows.columns[nm].dtype)
                for nm in dp0.upload_names)
            upload_bytes = sum(int(dp.rows.columns[nm].nbytes)
                               for dp in dps for nm in dp0.upload_names)
            shift_np = np.zeros(T, dtype=np.int32)
            lo_np = np.zeros(T, dtype=np.int32)
            consts_np = [np.tile(np.asarray(c, np.int32), (T, 1))
                         for c in dp0.consts]
            if dp0.route == "kway":
                offs_np = np.full((T, dp0.num_runs + 1), cap,
                                  dtype=np.int32)
                offs_np[:, 0] = 0
            else:
                offs_np = np.zeros((T, 1), dtype=np.int32)
            for t, (_s, dp) in enumerate(chunk):
                n = dp.rows.n
                shift_np[t] = dp.shift
                lo_np[t] = dp.lo
                for ci, c in enumerate(dp.consts):
                    consts_np[ci][t] = c
                if dp0.route == "kway":
                    # rebuilt against the ROUND capacity: real run bounds,
                    # the pad zone [n, cap) as its own run, trailing runs
                    # empty at cap (the kway_merge_perm contract)
                    rl = dp.rows.run_lengths
                    real = np.cumsum((0,) + tuple(rl))
                    offs_np[t, :len(real)] = real
                    offs_np[t, len(rl):] = cap
                    offs_np[t, len(rl)] = n
            consts_dev = tuple(put(c) for c in consts_np)
            offs_dev, shift_dev, lo_dev = (put(offs_np), put(shift_np),
                                           put(lo_np))
            self._stack_cache_put(
                stack_key, es_list,
                cols_dev + consts_dev + (offs_dev, shift_dev, lo_dev))
        fn_key = ("decode", dp0.static_key(), g_pad, width)
        fn = self._mesh_run_fns.get(fn_key)
        if fn is None:
            fn = mesh_decode_partials(
                mesh, num_groups=g_pad, num_buckets=width,
                which=spec.which, key_slots=dp0.key_slots,
                num_pks=dp0.num_pks, group_pos=dp0.group_pos,
                ts_pos=dp0.ts_pos, val_slot=dp0.val_slot,
                leaf_prog=dp0.leaf_prog, route=dp0.route,
                num_runs=dp0.num_runs)
            self._mesh_run_fns[fn_key] = fn
        out, _kept = fn(cols_dev, nv, consts_dev, offs_dev, shift_dev,
                        lo_dev, put(seg_ids), spec.num_buckets,
                        spec.bucket_ms)
        _MESH_ROUNDS.inc()
        if len(chunk) < T:
            pipeline_mod.note_mesh_stall("time")
        # run-tail emission, DecodeDispatch.finalize's shape: the tail
        # plan's real group count and clipped width, window-local
        # last_ts rebased to range-relative int64
        entries: list = []
        cells = 0
        src_rows = 0
        a = 0
        t_dl = time.perf_counter()
        for i in range(len(chunk)):
            if i + 1 < len(chunk) and seg_ids[i + 1] == seg_ids[i]:
                continue
            s, dp = chunk[i]
            grids = {k: np.ascontiguousarray(
                         v.row(i, timed=False)[:dp.g, :dp.w_eff])
                     for k, v in out.items()}
            if "last_ts" in grids:
                lt = grids["last_ts"].astype(np.int64)
                grids["last_ts"] = np.where(
                    grids["count"] > 0, lt + dp.lo * spec.bucket_ms, lt)
            cells += sum(int(v.shape[0] * v.shape[1])
                         for v in grids.values())
            src_rows += sum(dp2.rows.n for _s2, dp2 in chunk[a:i + 1])
            entries.append((s, (dp.values, dp.lo, grids), i - a + 1))
            a = i + 1
        deviceprof.observe_wait(time.perf_counter() - t_dl)
        _MESH_PARTS.inc(len(entries))
        _MESH_PART_CELLS.inc(cells)
        deviceprof.record_round(
            "mesh_decode", slots=len(chunk), capacity=T,
            rows_per_shard=[int(dp.rows.n) for _s, dp in chunk],
            padding_rows=(T - len(chunk)) * cap
            + sum(cap - int(dp.rows.n) for _s, dp in chunk),
            upload_bytes=upload_bytes, stack_hit=cached is not None,
            seconds=(time.perf_counter_ns() - t0) / 1e9)
        device_decode.observe_decode_stage(
            t0, rows=src_rows, nbytes=upload_bytes)
        return entries

    async def _aggregate_segments_mesh(self, plan: ScanPlan,
                                       spec: AggregateSpec, memo_store):
        """The mesh twin of _aggregate_segments_pump: the pipeline's
        fetch/decode stages feed this device stage, which admits windows
        to mesh time slots strictly in plan order and flushes rounds of
        time-axis width.  Per-segment run parts come back through the
        same yield/memo contract, so replans, the PartsMemo and the
        sorted-segment fold are untouched."""
        from horaedb_tpu_torch.storage import pipeline as pipeline_mod

        batch_w = self.scan_mesh.shape["time"]
        queue: list = []
        parts: dict[int, list] = {}
        pending: dict[int, int] = {}
        arrived: deque = deque()
        flush_task: Optional[asyncio.Task] = None
        flush_ordinal = 0

        def apply(flushed) -> None:
            for seg_start, part, repay in flushed:
                if part is not None:
                    parts[seg_start].append(part)
                pending[seg_start] -= repay

        async def settle_flush() -> None:
            nonlocal flush_task
            if flush_task is None:
                return
            t, flush_task = flush_task, None
            apply(await t)

        async def flush_round(chunk: list, salt: int) -> list:
            out, t0, t1 = await self._run_round(
                self._flush_mesh_round, chunk, spec, plan, salt,
                pool=plan.pool)
            pipeline_mod.observe_stage(
                "device", t0, t1_ns=t1,
                rows=sum(w.n_valid for _s, w, _p in chunk))
            return out

        async def flush(k: int) -> None:
            nonlocal flush_task, flush_ordinal
            chunk = queue[:k]
            del queue[:k]
            salt = flush_ordinal
            flush_ordinal += 1
            if not plan.pipeline_active:
                apply(await self._run_pool(self._flush_mesh_round, chunk,
                                           spec, plan, salt,
                                           pool=plan.pool))
                return
            # stage-boundary checkpoint: no new mesh round for an
            # expired query (the in-flight one drains via settle)
            deadline_checkpoint()
            await settle_flush()
            flush_task = asyncio.create_task(flush_round(chunk, salt))

        def finished():
            while arrived and pending[arrived[0]] == 0:
                s0 = arrived.popleft()
                seg_parts = parts.pop(s0)
                memo_store(s0, seg_parts)
                yield s0, seg_parts

        try:
            windows_iter = self._cached_windows(plan)
            try:
                async for seg, windows, read_s in windows_iter:
                    t0 = time.perf_counter()
                    s = seg.segment_start
                    arrived.append(s)
                    parts[s] = []
                    pending[s] = 0

                    def prep_windows(ws=windows):
                        out = []
                        for w in ws:
                            _ROWS_SCANNED.inc(w.n_valid)
                            if isinstance(w, device_decode.DecodePlan):
                                # deferred decode: batched into mesh
                                # decode rounds at flush time
                                out.append((w, _DECODE_PREP))
                                continue
                            if isinstance(w, device_decode.DevicePart):
                                if w.part is not None:
                                    out.append((w, None))
                                continue
                            prep = self._window_groups(w, spec, plan)
                            if prep is not None:
                                out.append((w, prep))
                        return out

                    for w, prep in await self._run_pool(prep_windows,
                                                        pool=plan.pool):
                        queue.append((s, w, prep))
                        pending[s] += 1
                    while len(queue) >= batch_w:
                        await flush(batch_w)
                    _SCAN_LATENCY.observe(read_s
                                          + (time.perf_counter() - t0))
                    for out in finished():
                        yield out
            except NotFoundError:
                # a compaction race: the round in flight still lands and
                # the segments it finishes are yielded, so the caller's
                # replan re-reads only the segments left
                await settle_flush()
                for out in finished():
                    yield out
                raise
            finally:
                await windows_iter.aclose()
            if queue:
                await flush(len(queue))
            await settle_flush()
            for out in finished():
                yield out
        finally:
            if flush_task is not None:
                # a cancelled or failed scan drains its in-flight mesh
                # round (the pool job runs to completion regardless), so
                # no task outlives the scan
                flush_task.cancel()
                await asyncio.gather(flush_task, return_exceptions=True)

    async def _aggregate_topk_mesh(self, plan: ScanPlan,
                                   spec: AggregateSpec, tk):
        """Egress-bounded top-k on the scan mesh, two passes over the
        collected windows (two-phase like the fused path; the budget
        gate in _mesh_topk_ok bounds the pinned rows):

          score   every round's segmented-combined grids fold into a
                  device-resident score state, and only a per-group
                  (score, has) vector downloads: O(groups) bytes;
          winners rank on the host with combine.rank_top_k (the tie
                  order combine_top_k uses), then the rounds re-run
                  from the stack cache and download ONLY the k winners'
                  grid rows per run: O(k x buckets x aggs) per part.

        Yields (seg_start, winner-sliced parts); finalize_aggregate's
        combine_top_k then reproduces the full ranking restricted to the
        winners.  A round-level decline (sum overlap, budget, mesh
        error) downgrades the WHOLE query to full-width mesh parts."""
        from horaedb_tpu_torch.parallel import scan as pscan

        T = self.scan_mesh.shape["time"]
        items: list = []
        windows_iter = self._cached_windows(plan)
        try:
            async for seg, windows, read_s in windows_iter:
                s = seg.segment_start

                def prep_windows(ws=windows, s=s):
                    out = []
                    for w in ws:
                        _ROWS_SCANNED.inc(w.n_valid)
                        prep = self._window_groups(w, spec, plan)
                        if prep is not None:
                            out.append((s, w, prep))
                    return out

                items.extend(await self._run_pool(prep_windows,
                                                  pool=plan.pool))
                _SCAN_LATENCY.observe(read_s)
        finally:
            await windows_iter.aclose()
        if not items:
            return
        # canonical fold order: sorted segment, window order within — the
        # order finalize folds parts in
        items.sort(key=lambda it: it[0])
        all_values = np.unique(np.concatenate([it[2][0] for it in items]))
        g = len(all_values)
        series = self.scan_mesh.shape["series"]
        g_pad = max(8, series, 1 << (g - 1).bit_length())
        local_ok = all(it[1].encodings[spec.ts_col].kind == "offset"
                       for it in items)
        width = (self._window_grid_width(spec) if local_ok
                 else spec.num_buckets)
        chunks = [items[i:i + T] for i in range(0, len(items), T)]
        additive = tk.by in ("count", "sum", "avg")
        init = pscan.mesh_additive_init if additive else pscan.mesh_score_init
        state = init(self.scan_mesh, g_pad, spec.num_buckets + width, tk.by)
        # the score state is device-resident for the whole two-pass
        # ranking: accounted (mesh_state) and freed on every exit path
        state_bytes = sum(int(v.nbytes) for st in state for v in st.values())
        self._mesh_state_bytes += state_bytes
        downgrade = None
        finished = None
        try:
            try:
                for ci, chunk in enumerate(chunks):
                    deadline_checkpoint()

                    def score_round(chunk=chunk, ci=ci):
                        got = self._run_mesh_round(
                            chunk, spec, plan, group_space=all_values,
                            download=False, round_salt=ci)
                        out = got["out"]
                        if additive:
                            # TAIL slots only: a tail already holds its
                            # whole run, prefixes would double-count
                            tails = np.zeros(T, dtype=bool)
                            for _s, _a, b in got["runs"]:
                                tails[b] = True
                            return pscan.mesh_additive_update(
                                state, out["count"],
                                out.get("sum", out["count"]), tails,
                                got["lo"], by=tk.by)
                        return pscan.mesh_score_update(
                            state, out[tk.by], out["count"],
                            out.get("last_ts") if tk.by == "last" else None,
                            got["lo"], spec.bucket_ms, by=tk.by)

                    state = await self._run_pool(score_round,
                                                 pool=plan.pool)
            except _MeshFallback as f:
                downgrade = f.reason
            except NotFoundError:
                raise  # compaction race: the caller replans
            except Exception as exc:  # noqa: BLE001 — counted downgrade
                downgrade = "mesh_error"
                logger.warning("mesh top-k scoring failed (%s); serving "
                               "full-width parts", exc)
            if downgrade is None:
                def finish_scores():
                    if not additive:
                        sc, has = pscan.mesh_score_finalize(
                            state, largest=tk.largest,
                            num_buckets=spec.num_buckets)
                        _MESH_SCORE_CELLS.inc(2 * g)
                        return sc[:g].astype(np.float64), has[:g]
                    fin = pscan.mesh_additive_finalize(
                        state, by=tk.by, largest=tk.largest,
                        num_buckets=spec.num_buckets)
                    if fin["lossy"]:
                        # an add was not provably exact: a counted
                        # downgrade, never a drifted winner set
                        return None
                    if tk.by == "avg":
                        # the card cannot divide bit-identically to the
                        # host: avg downloads the (groups, buckets) pairs
                        # and the host runs combine_top_k's formula
                        cnt = (fin["cnt_hi"].astype(np.float64)
                               + fin["cnt_lo"].astype(np.float64))[:g]
                        sm = (fin["sum_hi"].astype(np.float64)
                              + fin["sum_lo"].astype(np.float64))[:g]
                        hs = fin["has"][:g]
                        _MESH_SCORE_CELLS.inc(5 * cnt.size + g)
                        with np.errstate(invalid="ignore", divide="ignore"):
                            cell = sm / np.maximum(cnt, 1)
                        fill = -np.inf if tk.largest else np.inf
                        cell = np.where(hs, cell, fill)
                        sc = (cell.max(axis=1) if tk.largest
                              else cell.min(axis=1))
                        return sc, hs.any(axis=1)
                    sc = (fin["score_hi"].astype(np.float64)
                          + fin["score_lo"].astype(np.float64))[:g]
                    _MESH_SCORE_CELLS.inc(3 * g)
                    return sc, fin["has_any"][:g]

                finished = await self._run_pool(finish_scores,
                                                pool=plan.pool)
        finally:
            state = None
            self._mesh_state_bytes -= state_bytes
        if downgrade is not None or finished is None:
            note_mesh_fallback(downgrade or "additive_topk")
            # full-width mesh parts through the normal chunk flush;
            # finalize's combine_top_k ranks them
            async for out in self._yield_chunks_as_parts(chunks, spec,
                                                         plan):
                yield out
            return
        scores, has_any = finished
        kept = np.flatnonzero(has_any)
        winners = combine_mod.rank_top_k(
            [int(r) for r in kept], scores[kept], tk)
        if not winners:
            return
        w_rows = np.asarray(sorted(winners), dtype=np.int64)
        winner_values = all_values[w_rows]
        seg_parts: dict[int, list] = {}
        cells = 0
        try:
            for ci, chunk in enumerate(chunks):
                deadline_checkpoint()

                def winner_round(chunk=chunk, ci=ci):
                    got = self._run_mesh_round(chunk, spec, plan,
                                               group_space=all_values,
                                               download=False,
                                               round_salt=ci)
                    sliced = pscan.mesh_take_rows(got["out"], w_rows)
                    out = []
                    for s, _a, b in got["runs"]:
                        # the round's OWN grid width: a chunk whose ts
                        # encodings forced full-range grids is wider
                        lo_run, grids = self._slice_mesh_part(
                            sliced, b, -1, int(got["lo"][b]),
                            got["width"], spec)
                        out.append((s, (winner_values, lo_run, grids)))
                    return out

                for s, part in await self._run_pool(winner_round,
                                                    pool=plan.pool):
                    seg_parts.setdefault(s, []).append(part)
                    cells += sum(int(v.shape[0] * v.shape[1])
                                 for v in part[2].values())
        except NotFoundError:
            raise  # compaction race: the caller replans
        except Exception as exc:  # noqa: BLE001 — counted downgrade;
            # nothing was yielded, so full-width parts replace the slices
            note_mesh_fallback(exc.reason if isinstance(exc, _MeshFallback)
                               else "mesh_error")
            logger.warning("mesh top-k winner pass failed (%s); serving "
                           "full-width parts", exc)
            async for out in self._yield_chunks_as_parts(chunks, spec,
                                                         plan):
                yield out
            return
        _MESH_PART_CELLS.inc(cells)
        _MESH_TOPK.inc()
        for s in sorted(seg_parts):
            yield s, seg_parts[s]

    async def _yield_chunks_as_parts(self, chunks: list,
                                     spec: AggregateSpec, plan: ScanPlan):
        """The top-k mesh route's downgrade: flush the collected window
        chunks through the normal mesh round (its per-round fallback
        included) and yield per-segment full parts."""
        seg_parts: dict[int, list] = {}
        for ci, chunk in enumerate(chunks):
            deadline_checkpoint()
            flushed = await self._run_pool(self._flush_mesh_round, chunk,
                                           spec, plan, ci, pool=plan.pool)
            for s, part, _repay in flushed:
                if part is not None:
                    seg_parts.setdefault(s, []).append(part)
        for s in sorted(seg_parts):
            yield s, seg_parts[s]

    def finalize_aggregate(self, parts: list, spec: AggregateSpec,
                           top_k=None):
        """Combine per-window parts into the user-facing grids
        (storage/combine.py, [scan.combine] mode), drop groups with no
        row in any bucket, and expose last_ts as absolute ms.

        A `top_k` spec (plan.TopKSpec) pushes the ranking into the
        combine (combine_top_k): only the k winners' rows are ever
        materialized, never the groups x buckets grid.  In `dense` mode
        the pushdown is off too: the control materializes the full grid
        and ranks with plan.apply_top_k, so the mode flag A/Bs the whole
        path."""
        mode = self.config.scan.combine.mode
        t0 = time.perf_counter_ns()
        try:
            if top_k is not None and mode != "dense":
                # the pushdown drops all-empty groups before ranking,
                # the same groups as the drop below
                group_values, grids = combine_mod.combine_top_k(
                    parts, spec.num_buckets, spec.which, top_k)
            else:
                group_values, grids = combine_mod.combine_parts(
                    parts, spec.num_buckets, which=spec.which, mode=mode)
                # the aligned fast path omits the ts leaf
                # (query_downsample), so boundary-segment rows outside
                # [start, end) can register a group whose every cell is
                # empty
                if len(group_values):
                    nonzero = grids["count"].sum(axis=1) > 0
                    if not nonzero.all():
                        group_values = group_values[nonzero]
                        grids = {k: v[nonzero] for k, v in grids.items()}
                if top_k is not None:
                    from horaedb_tpu_torch.storage.plan import apply_top_k

                    group_values, grids = apply_top_k(group_values, grids,
                                                      top_k)
        finally:
            _observe_stage("combine", t0)
        if len(group_values) and "last_ts" in grids:
            grids["last_ts"] = grids["last_ts"] + spec.range_start
        return group_values, grids

    # ---- fused aggregate ---------------------------------------------------

    async def execute_aggregate_fused(self, plan: ScanPlan,
                                      spec: AggregateSpec,
                                      counted: Optional[set] = None):
        """Merge + downsample with a QUERY-GLOBAL device accumulator:
        rounds of stacked windows aggregate and scatter into one
        (groups, buckets) grid set on the device; nothing is downloaded
        until the final grids.

        Two-phase: all windows are collected first so the union group
        space is known before any round runs (remap targets global rows
        directly).  A completed query is recorded in the replay cache;
        an identical repeat whose windows and stacks are all still
        cached replays its rounds instead (_fused_replay).

        Returns (group_values, grids): grids are tensors on the reader's
        device, except `last_ts`, which comes back as host float64
        absolute ms (int64 range needed).  `counted`: segments whose rows
        an earlier attempt of the same query already counted (a restart
        after a compaction race counts them once).

        Stages: `window_prep` from the entry to the device dispatch (the
        replay check, the windows, their prep and the group space, pool
        hops included), `device_aggregate` on the worker, then
        `fused_finish` here (the empty-group drop, which reads the
        device, and the last_ts rebase)."""
        t_prep = time.perf_counter_ns()
        replay_key = None
        if plan.use_cache:
            replay_key = self._replay_key(plan, spec)
            entry = self._replay_cache.get(replay_key)
            if entry is not None:
                # segment validation reads the (event-loop owned) scan
                # cache here; only the device rounds go to the pool
                grids = None
                if self._replay_segments_valid(entry):
                    _observe_stage("window_prep", t_prep)
                    grids = await self._run_pool(self._fused_replay, entry,
                                                 spec, pool=plan.pool)
                    t_prep = time.perf_counter_ns()
                if grids is not None:
                    self._replay_cache.move_to_end(replay_key)
                    self._replay_hits += 1
                    _REPLAY_HITS.inc()
                    # nothing was read: replayed rows have their own
                    # counter, once per segment across race restarts
                    fresh = [(s, r) for s, r in entry["seg_rows"]
                             if counted is None or s not in counted]
                    if fresh:
                        _REPLAY_ROWS.inc(sum(r for _, r in fresh))
                        if counted is not None:
                            counted.update(s for s, _ in fresh)
                    return _fused_finish(entry["values"], grids, spec)
                self._replay_cache.pop(replay_key, None)
            self._replay_misses += 1
            _REPLAY_MISSES.inc()
        items: list = []
        seg_records: list = []
        seg_rows: list = []
        windows_iter = self._cached_windows(plan)
        try:
            async for seg, windows, read_s in windows_iter:
                s = seg.segment_start
                count_rows = counted is None or s not in counted
                if counted is not None:
                    counted.add(s)

                def prep(ws=windows, s=s, count_rows=count_rows):
                    out = []
                    for w in ws:
                        if count_rows:
                            _ROWS_SCANNED.inc(w.n_valid)
                        pr = self._window_groups(w, spec, plan)
                        if pr is not None:
                            out.append((s, w, pr))
                    return out

                items.extend(await self._run_pool(prep))
                if replay_key is not None:
                    seg_records.append((self._cache_key(seg, plan), tuple(
                        weakref.ref(w) for w in windows)))
                    seg_rows.append((s, sum(w.n_valid for w in windows)))
                if count_rows:
                    _SCAN_LATENCY.observe(read_s)
        finally:
            await windows_iter.aclose()
        if not items:
            _observe_stage("window_prep", t_prep)
            empty = np.zeros((0, spec.num_buckets), dtype=np.float32)
            return np.asarray([]), {k: empty.copy() for k in
                                    set(spec.which) | {"count"}}
        all_values = np.unique(np.concatenate([it[2][0] for it in items]))
        g = len(all_values)
        g_pad = max(8, 1 << (g - 1).bit_length())
        local_ok = all(it[1].encodings[spec.ts_col].kind == "offset"
                       for it in items)
        width = (self._window_grid_width(spec) if local_ok
                 else spec.num_buckets)
        max_w = max(1, self.config.scan.agg_batch_windows)
        space_fp = (g, hash(all_values.tobytes()))
        recorded_rounds: list = []

        def build_rounds():
            # lazy: the next round's stacks are built while the device
            # still runs the previous round's launches
            i = 0
            while i < len(items):
                chunk = items[i:i + max_w]
                batch_w = min(max_w, 1 << (len(chunk) - 1).bit_length())
                cap = max(it[1].capacity for it in chunk)
                # the chunk offset `i` keeps consecutive rounds of one
                # segment that share (seg0, batch_w, cap) apart in the
                # stack cache
                stack_key = self._round_stack_key(
                    chunk[0][0], spec, plan, batch_w, cap, g_pad, width,
                    space_fp) + (i,)
                arrays = self._build_round_stacks(
                    chunk, spec, plan, batch_w, cap, g_pad, width,
                    all_values, local_ok, stack_key=stack_key)
                if replay_key is not None:
                    windows = tuple(it[1] for it in chunk)
                    recorded_rounds.append((
                        stack_key,
                        self._col_stack_key(windows, spec, plan, batch_w,
                                            cap),
                        tuple(weakref.ref(w) for w in windows)))
                i += len(chunk)
                yield arrays

        _observe_stage("window_prep", t_prep)
        grids = await self._run_pool(
            self._fused_run_device_rounds, build_rounds(), spec,
            g, g_pad, width)
        if replay_key is not None:
            self._replay_cache[replay_key] = {
                "segments": seg_records, "rounds": recorded_rounds,
                "values": all_values, "g": g, "g_pad": g_pad,
                "width": width, "seg_rows": seg_rows}
            self._replay_cache.move_to_end(replay_key)
            while len(self._replay_cache) > _REPLAY_SLOTS:
                self._replay_cache.popitem(last=False)
        return _fused_finish(all_values, grids, spec)

    def _replay_key(self, plan: ScanPlan, spec: AggregateSpec) -> tuple:
        """Identity of a fused aggregate over a plan: the per-segment
        scan-cache keys (SST ids + columns + pushdown), the aggregate
        spec and the predicate.  A write or a compaction changes a
        segment's SST set and so the key."""
        seg_keys = tuple(self._cache_key(seg, plan) for seg in plan.segments)
        return (seg_keys, spec.group_col, spec.ts_col, spec.value_col,
                spec.range_start, spec.bucket_ms, spec.num_buckets,
                spec.which,
                filter_ops.canonical_predicate_key(plan.predicate))

    def _replay_segments_valid(self, entry: dict) -> bool:
        """Every segment's scan-cache entry must still hold the exact
        window objects recorded (a re-read, an eviction or a compaction
        breaks the identity).  Runs on the event loop, which owns the
        scan cache."""
        for key, refs in entry["segments"]:
            ws = self.scan_cache.get(key)
            if (ws is None or len(ws) != len(refs)
                    or any(r() is not w for r, w in zip(refs, ws))):
                return False
        return True

    def _fused_replay(self, entry: dict, spec: AggregateSpec):
        """Re-run a recorded fused aggregate in ONE worker-pool dispatch:
        every round's stacks must still be in the stack cache (checked
        before any device work); then the rounds run from them.  Returns
        the device grids, or None to take the full path."""
        rounds = []
        for stack_key, col_key, refs in entry["rounds"]:
            ws = tuple(r() for r in refs)
            if any(w is None for w in ws):
                return None
            cols = self._stack_cache_get(col_key, ws)
            small = self._stack_cache_get(stack_key, ws)
            if cols is None or small is None:
                return None
            rounds.append(cols + small)
        return self._fused_run_device_rounds(
            rounds, spec, entry["g"], entry["g_pad"], entry["width"])

    def _fused_run_device_rounds(self, rounds, spec: AggregateSpec, g: int,
                                 g_pad: int, width: int) -> dict:
        """The fused aggregate's device sequence, shared by the full path
        and the replay: acc init -> one accumulate per round -> finalize
        -> slice to g -> synchronize.  `rounds` is any iterable of stack
        tuples (a lazy generator on the full path, so stack building
        overlaps the device's rounds).  The finalize through the
        synchronize, the host waiting for the rounds, is also the first
        interval of `fused_finish`."""
        import torch

        t0 = time.perf_counter_ns()
        acc = fused_acc_init(num_groups=g_pad, num_buckets=spec.num_buckets,
                             which=spec.which, device=self.device)
        for (ts_s, gid_s, val_s, nv_d, nv_h, remap_d, shift_d, lo_d,
             lo_h) in rounds:
            fused_round_accumulate(acc, ts_s, gid_s, val_s, remap_d, shift_d,
                                   lo_d, lo_h, spec.num_buckets,
                                   spec.bucket_ms, num_groups=g_pad,
                                   width=width, which=spec.which,
                                   n_valid=nv_d, n_valid_host=nv_h)
        t_fin = time.perf_counter_ns()
        final = fused_finalize(acc, spec.which)
        out = {k: v[:g] for k, v in final.items()}
        if self.on_cuda:
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter_ns()
        _observe_stage("fused_finish", t_fin, t1)
        _observe_stage("device_aggregate", t0, t1)
        return out

    def _window_groups(self, w: encode.DeviceBatch, spec: AggregateSpec,
                       plan: ScanPlan):
        """Per-window prep: (group_values, gid_full, ts_shift) or None
        when the window contributes nothing.  Memoized on the window
        (keyed by group column + full predicate) so repeat queries over
        cached windows skip the dense-ification; only the shift depends
        on range_start and is derived per call."""
        memo_key = ("window_groups", spec.group_col, spec.ts_col,
                    filter_ops.canonical_predicate_key(plan.predicate))
        miss = object()
        cached_val = w.memo.get(memo_key, miss)
        if cached_val is miss:
            cached_val = self._window_groups_uncached(w, spec, plan)
            nbytes = 0 if cached_val is None else int(cached_val[1].nbytes)
            _memo_store(w, memo_key, cached_val, nbytes)
        if cached_val is None:
            return None
        group_values, gid_full, epoch = cached_val
        shift = epoch - spec.range_start  # host_ts = dev_ts + epoch
        ensure(abs(shift) < 2**31, "query range too far from segment epoch")
        return group_values, gid_full, shift

    def _window_groups_uncached(self, w: encode.DeviceBatch,
                                spec: AggregateSpec, plan: ScanPlan):
        k = w.n_valid
        cap = w.capacity
        if k == 0:
            return None
        keep = np.arange(cap) < k
        mask_all = True
        if plan.predicate is not None and not plan.pushed_complete:
            mask = filter_ops.eval_predicate(plan.predicate, w)
            mask_all = bool(mask[:k].all())
            keep = keep & mask
            if not mask_all and not keep.any():
                return None
        ts_enc = w.encodings[spec.ts_col]
        ensure(ts_enc.kind in ("offset", "numeric"),
               f"aggregate needs arithmetic timestamps, got "
               f"{ts_enc.kind!r} encoding for {spec.ts_col!r}")
        codes = np.asarray(w.columns[spec.group_col])
        enc_g = w.encodings[spec.group_col]
        if (mask_all and enc_g.kind == "dict" and len(enc_g.dictionary)
                and int(codes[:k].min()) == 0
                and int(codes[:k].max()) == len(enc_g.dictionary) - 1):
            # the window uses the WHOLE dictionary: its codes already
            # ARE the dense ids and the dictionary the sorted values
            gid_full = np.where(keep, codes, -1).astype(np.int32)
            return enc_g.dictionary, gid_full, ts_enc.epoch
        sel_codes = codes[keep]
        if len(sel_codes) == 0:
            return None
        uniq, dense = np.unique(sel_codes, return_inverse=True)
        gid_full = np.full(cap, -1, dtype=np.int32)
        gid_full[keep] = dense.astype(np.int32)
        return (_decode_group_values(uniq, enc_g), gid_full, ts_enc.epoch)

    def _window_grid_width(self, spec: AggregateSpec) -> int:
        """Static per-window grid width: a window's rows span at most one
        segment, so its buckets span at most segment_ms/bucket_ms (+2
        for epoch/range misalignment)."""
        need = self.segment_duration_ms // max(1, spec.bucket_ms) + 2
        return int(min(spec.num_buckets,
                       max(8, 1 << (need - 1).bit_length())))

    def _stack_cache_get(self, key: tuple, windows_now: tuple):
        """The stack cache's arrays under `key`, or None.  An entry whose
        window weakrefs no longer name `windows_now` (a window evicted
        and re-read, or a changed composition) is dropped: a miss."""
        hits, misses = _stack_counters(key)
        with self._stack_cache_lock:
            entry = self._stack_cache.get(key)
            if entry is not None:
                refs, arrays, nbytes = entry
                if len(refs) == len(windows_now) and all(
                        r() is w for r, w in zip(refs, windows_now)):
                    self._stack_cache.move_to_end(key)
                    self._stack_cache_hits += 1
                    hits.inc()
                    return arrays
                del self._stack_cache[key]
                self._stack_cache_bytes -= nbytes
            self._stack_cache_misses += 1
            misses.inc()
            return None

    def _stack_cache_put(self, key: tuple, windows_now: tuple,
                         arrays: tuple) -> None:
        """Store a round's arrays under `key` with weakrefs to its
        windows (no window is pinned), evicting least recently used
        entries past the byte bound; an entry larger than the bound is
        not stored."""
        nbytes = sum(int(a.nbytes) for a in arrays)
        refs = tuple(weakref.ref(w) for w in windows_now)
        with self._stack_cache_lock:
            if nbytes > self._stack_cache_max:
                return
            old = self._stack_cache.pop(key, None)
            if old is not None:
                self._stack_cache_bytes -= old[2]
            self._stack_cache[key] = (refs, arrays, nbytes)
            self._stack_cache_bytes += nbytes
            while (self._stack_cache_bytes > self._stack_cache_max
                   and self._stack_cache):
                _, (_, _, evicted) = self._stack_cache.popitem(last=False)
                self._stack_cache_bytes -= evicted

    def _devcol_stack_ok(self) -> bool:
        """Whether the fused rounds stack from per-window device columns
        (_window_device_cols) instead of a numpy stack and one bulk
        upload per array: on a CUDA reader, where the copies let a
        varied-range query (new round compositions: column-stack misses)
        re-stack arrays already on the device and upload only the small
        ones.  On the CPU the numpy stack is a memcpy."""
        return self.on_cuda

    def _window_device_cols(self, w: encode.DeviceBatch,
                            spec: AggregateSpec, plan: ScanPlan,
                            gid: np.ndarray) -> tuple:
        """(ts, gid, value) device copies of one host window at its own
        capacity: range-independent, memoized on the window."""
        memo_key = ("dev_cols", spec.group_col, spec.ts_col,
                    spec.value_col,
                    filter_ops.canonical_predicate_key(plan.predicate))
        miss = object()
        got = w.memo.get(memo_key, miss)
        if got is not miss:
            return got
        put = lambda a: encode.to_device(a, self.device)
        out = (put(np.asarray(w.columns[spec.ts_col], dtype=np.int32)),
               put(np.asarray(gid, dtype=np.int32)),
               put(np.asarray(w.columns[spec.value_col], dtype=np.float32)))
        _memo_store(w, memo_key, out, sum(int(a.nbytes) for a in out))
        return out

    @staticmethod
    def _round_stack_key(seg0: int, spec: AggregateSpec, plan: ScanPlan,
                         batch_w: int, cap: int, g_pad: int, width: int,
                         space_fp: tuple) -> tuple:
        """Stack-cache identity of one round's RANGE-DEPENDENT small
        arrays (remap, shift, lo); the fused replay records the same
        key, so it is computed one way only."""
        return (seg0, spec.group_col, spec.ts_col, spec.value_col,
                spec.bucket_ms, spec.range_start, batch_w, cap, g_pad, width,
                space_fp, filter_ops.canonical_predicate_key(plan.predicate))

    @staticmethod
    def _col_stack_key(windows_now: tuple, spec: AggregateSpec,
                       plan: ScanPlan, batch_w: int, cap: int) -> tuple:
        """Stack-cache identity of one round's RANGE-INDEPENDENT columns
        (ts, gid, val, n_valid): the round's window object ids (the
        entry's weakrefs guard against id reuse), never the range, so
        every query with the same round composition shares them."""
        return ("colstack", tuple(id(w) for w in windows_now),
                spec.group_col, spec.ts_col, spec.value_col, batch_w, cap,
                filter_ops.canonical_predicate_key(plan.predicate))

    def _build_round_stacks(self, items: list, spec: AggregateSpec,
                            plan: ScanPlan, batch_w: int, cap: int,
                            g_pad: int, width: int,
                            group_space: np.ndarray, local_ok: bool,
                            stack_key: Optional[tuple] = None,
                            put=None, key_salt: tuple = ()) -> tuple:
        """One round of host windows on the device, in two parts: the
        columns (ts, gid, val and n_valid, on the device and on the host)
        and the small arrays (remap, shift, lo on the device, lo on the
        host).  With a `stack_key` (the fused rounds) each part goes
        through the stack cache, and a miss stacks the columns from the
        windows' memoized device copies (_devcol_stack_ok) or from numpy;
        without one (the parts path, whose plans outgrow the cache's
        byte bound, so a byte LRU would evict each round before its
        reuse) the round is built uncached from numpy, one upload per
        array.  An explicit `put` (the meshes: shard_leading_axis,
        shard_time_axis) places the numpy stacks split over the mesh,
        its cache entries keyed apart by `key_salt`.  Windows past len(items) pad the round with no-op rows
        (ts 0, gid -1, value 0, n_valid 0), the same bytes on either
        route.  Returns (ts, gid, val, n_valid, n_valid_host, remap,
        shift, lo, lo_host); the host copies bound the round's rows and
        columns without a device read."""
        cached = stack_key is not None
        sharded = put is not None
        windows_now = tuple(it[1] for it in items)
        cols = small = None
        if cached:
            stack_key = stack_key + key_salt
            col_key = self._col_stack_key(windows_now, spec, plan, batch_w,
                                          cap) + key_salt
            cols = self._stack_cache_get(col_key, windows_now)
            small = self._stack_cache_get(stack_key, windows_now)
            if cols is not None and small is not None:
                return cols + small
        t0 = time.perf_counter_ns()
        built_bytes = 0
        if put is None:
            put = lambda a: encode.to_device(a, self.device)
        if cols is None:
            n_valid = np.zeros(batch_w, dtype=np.int32)
            for d, (_s, w, _prep) in enumerate(items):
                n_valid[d] = w.n_valid
            if cached and not sharded and self._devcol_stack_ok():
                cols = self._stack_device_cols(items, spec, plan, batch_w,
                                               cap)
            else:
                ts_m = np.zeros((batch_w, cap), dtype=np.int32)
                gid_m = np.full((batch_w, cap), -1, dtype=np.int32)
                val_m = np.zeros((batch_w, cap), dtype=np.float32)
                for d, (_s, w, (_values, gid, _sh)) in enumerate(items):
                    ts_m[d, :w.capacity] = w.columns[spec.ts_col]
                    gid_m[d, :w.capacity] = gid
                    val_m[d, :w.capacity] = w.columns[spec.value_col]
                cols = (put(ts_m), put(gid_m), put(val_m))
            built_bytes += sum(int(c.nbytes) for c in cols)
            cols = cols + (put(n_valid), n_valid)
            if cached:
                self._stack_cache_put(col_key, windows_now, cols)
        if small is None:
            remap = np.zeros((batch_w, g_pad), dtype=np.int32)
            shift = np.zeros(batch_w, dtype=np.int32)
            lo = np.zeros(batch_w, dtype=np.int32)
            for d, (_s, _w, (values, _gid, sh)) in enumerate(items):
                remap[d, :len(values)] = np.searchsorted(group_space, values)
                shift[d] = sh
                if local_ok:
                    lo[d] = max(0, sh // spec.bucket_ms)
            small = (put(remap), put(shift), put(lo), lo)
            built_bytes += sum(int(c.nbytes) for c in small[:3])
            if cached:
                self._stack_cache_put(stack_key, windows_now, small)
        _observe_stage("stack_build", t0)
        _STAGE_BYTES["stack_build"].inc(built_bytes)
        return cols + small

    def _stack_device_cols(self, items: list, spec: AggregateSpec,
                           plan: ScanPlan, batch_w: int, cap: int) -> tuple:
        """(ts, gid, val) stacks of a round from its windows' memoized
        device columns, padded on the device (ts/val 0, gid -1) to `cap`
        and with pad windows to `batch_w`."""
        import torch
        import torch.nn.functional as F

        rows: tuple = ([], [], [])
        for _s, w, (_values, gid, _sh) in items:
            pad = cap - w.capacity
            for out, col, fill in zip(
                    rows, self._window_device_cols(w, spec, plan, gid),
                    (0, -1, 0)):
                out.append(F.pad(col, (0, pad), value=fill) if pad else col)
        for out, dtype, fill in zip(rows, (torch.int32, torch.int32,
                                           torch.float32), (0, -1, 0)):
            out.extend([torch.full((cap,), fill, dtype=dtype,
                                   device=self.device)]
                       * (batch_w - len(items)))
        return tuple(torch.stack(out) for out in rows)


# ---------------------------------------------------------------------------
# fused device steps (counterparts of the JAX package's
# _fused_acc_init_jit, _fused_round_accumulate_jit, _fused_finalize_jit
# and _group_has_data_jit)
# ---------------------------------------------------------------------------


def fused_acc_init(*, num_groups: int, num_buckets: int, which: tuple,
                   device) -> dict:
    """Query-global accumulator grids with combine-identity inits:
    count/sum 0, min +F32_MAX, max -F32_MAX, last 0, last_ts INT32_MIN."""
    import torch

    shape = (num_groups, num_buckets)
    fields = bucket_agg.fields_for(which)
    acc = {"count": torch.zeros(shape, dtype=torch.float32, device=device)}
    if "sum" in fields:
        acc["sum"] = torch.zeros(shape, dtype=torch.float32, device=device)
    if "min" in fields:
        acc["min"] = torch.full(shape, _F32_MAX, dtype=torch.float32,
                                device=device)
    if "max" in fields:
        acc["max"] = torch.full(shape, -_F32_MAX, dtype=torch.float32,
                                device=device)
    if "last" in fields:
        acc["last"] = torch.zeros(shape, dtype=torch.float32, device=device)
        acc["last_ts"] = torch.full(shape, _ACC_TS_MIN, dtype=torch.int32,
                                    device=device)
    return acc


def fused_round_accumulate(acc: dict, ts, gid, vals, remap, shift, lo,
                           lo_host, total: int, bucket_ms: int, *,
                           num_groups: int, width: int, which: tuple,
                           n_valid=None, n_valid_host=None) -> dict:
    """One round of windows aggregated straight into the query-global
    accumulator, IN PLACE round over round (the JAX program donated its
    accumulator buffers for the same effect): one
    bucket_agg.bucket_round_accumulate call.  Window d covers global
    buckets [lo[d], lo[d] + width); columns past `total` are dropped,
    like the JAX scatter's mode="drop".  n_valid (device) and
    n_valid_host bound each window's rows; lo_host is lo on the host."""
    return bucket_agg.bucket_round_accumulate(
        acc, ts, gid, vals, remap, shift, lo, total, bucket_ms,
        num_groups=num_groups, width=width, which=which, n_valid=n_valid,
        lo_host=lo_host, n_valid_host=n_valid_host)


def fused_finalize(acc: dict, which: tuple) -> dict:
    """Finalize of the fused accumulator: min/max empty cells read
    +/-inf, a NaN cell its NaN's own bits (the kernel's NaN images
    decoded: bucket_agg.decode_min_images), avg/last NaN; last_ts stays
    int32 (range-relative)."""
    import torch

    count = acc["count"]
    empty = count == 0
    nan = torch.full_like(count, float("nan"))
    requested = set(which) | {"count"}
    out = {"count": count}
    if "sum" in acc and "sum" in requested:
        out["sum"] = acc["sum"]
    if "sum" in acc and "avg" in requested:
        out["avg"] = torch.where(empty, nan, mean(acc["sum"], count))
    if "min" in acc and "min" in requested:
        out["min"] = torch.where(empty, torch.full_like(count, float("inf")),
                                 bucket_agg.decode_min_images(acc["min"]))
    if "max" in acc and "max" in requested:
        out["max"] = torch.where(empty, torch.full_like(count, float("-inf")),
                                 bucket_agg.decode_max_images(acc["max"]))
    if "last" in acc and "last" in requested:
        out["last"] = torch.where(empty, nan, acc["last"])
        out["last_ts"] = acc["last_ts"]
    return out


def group_has_data(count):
    """Per-group any-data mask — G bools, the only bytes the empty-group
    check downloads."""
    return (count > 0).any(dim=1)


def _fused_finish(values: np.ndarray, grids: dict, spec: AggregateSpec):
    """The fused route's result on the event loop: empty groups dropped
    (a device-to-host read of the counts), last_ts made absolute; the
    second interval of the `fused_finish` stage."""
    t0 = time.perf_counter_ns()
    values, grids = _drop_empty_groups_dev(values, grids)
    out = values, _fused_last_ts_to_abs(grids, spec)
    _observe_stage("fused_finish", t0)
    return out


def _drop_empty_groups_dev(values: np.ndarray, grids: dict):
    """Drop groups with no row in any bucket (the aligned fast path can
    register groups whose rows all fall outside the range)."""
    if not len(values):
        return values, grids
    has = group_has_data(grids["count"]).cpu().numpy()
    if has.all():
        return values, grids
    idx = np.flatnonzero(has)
    import torch

    sel = torch.from_numpy(idx).to(grids["count"].device)
    return values[idx], {k: v.index_select(0, sel) for k, v in grids.items()}


def _fused_last_ts_to_abs(grids: dict, spec: AggregateSpec) -> dict:
    if "last_ts" in grids:
        # absolute float ms needs int64 range: host conversion
        count_h = grids["count"].cpu().numpy()
        lt = grids["last_ts"].cpu().numpy().astype(np.float64)
        grids["last_ts"] = np.where(count_h > 0, lt + spec.range_start,
                                    np.nan)
    return grids


def _cacheable_windows(windows: list) -> bool:
    """Only host-decoded window lists enter the scan cache: a DevicePart
    is an aggregate partial of one spec (serving it to a row scan or
    another aggregate would be wrong), and repeat aggregates are served
    by the PartsMemo already."""
    return all(isinstance(w, encode.DeviceBatch) for w in windows)


def _encoded_to_device_batch(es: sidecar.EncodedSegment
                             ) -> encode.DeviceBatch:
    """Pad sidecar columns to a capacity bucket — the only prep the
    already-device-layout data needs."""
    cap = encode.pad_capacity(es.n)
    columns = {}
    for name, arr in es.columns.items():
        columns[name] = encode.pad_to(arr, cap)
    return encode.DeviceBatch(columns=columns, encodings=es.encodings,
                              n_valid=es.n, capacity=cap)


def _decode_group_values(codes: np.ndarray, enc) -> np.ndarray:
    """Group codes -> host values (dictionary entries / epoch shift), in
    the same (sorted) order as the codes."""
    if enc.kind == "dict":
        return enc.dictionary[codes]
    if enc.kind == "offset":
        return codes.astype(np.int64) + enc.epoch
    return codes


# ---------------------------------------------------------------------------
# host merge
# ---------------------------------------------------------------------------


def _is_lex_sorted(keys: list[np.ndarray]) -> bool:
    """True iff rows are non-decreasing under lexicographic key order."""
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


def _plan_merge_perm(sort_cols: list[np.ndarray],
                     seq: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Host half of the k-way merge of pre-sorted SST runs: None when
    the rows are already sorted, else an int32 permutation.  The packed
    lexicographic key goes through numpy's stable (radix) argsort;
    ranges beyond int64 use np.lexsort.  `seq` is passed ONLY when rows
    are not already in ascending sequence order (stability keeps row
    order within equal keys, which last-wins dedup needs)."""
    keys = list(sort_cols) + ([] if seq is None else [seq])
    n = len(keys[0])
    if n <= 1:
        return None
    if _is_lex_sorted(keys):
        return None
    packed = None
    span_prod = 1
    for c in keys:  # most-significant first
        c64 = c.astype(np.int64, copy=False)
        lo = int(c64.min())
        span = int(c64.max()) - lo + 1
        if span_prod * span >= 2**63:
            packed = None
            break
        span_prod *= span
        part = c64 - lo
        packed = part if packed is None else packed * span + part
    if packed is not None:
        return np.argsort(packed, kind="stable").astype(np.int32)
    return np.lexsort(tuple(reversed(keys))).astype(np.int32)


def _window_merge_sel(sort_cols: list[np.ndarray], seq_h: np.ndarray,
                      seq_ordered: bool, sel: np.ndarray) -> np.ndarray:
    perm = _plan_merge_perm([c[sel] for c in sort_cols],
                            None if seq_ordered else seq_h[sel])
    return sel if perm is None else sel[perm]


def _batch_merge_perm(sort_cols: list[np.ndarray], seq_h: np.ndarray,
                      seq_ordered: bool, n: int) -> Optional[np.ndarray]:
    return _plan_merge_perm([c[:n] for c in sort_cols],
                            None if seq_ordered else seq_h[:n])


def _host_merge_window_descs(dev: encode.DeviceBatch, host_cols: dict,
                             sort_pk_names: list[str], seq_h: np.ndarray,
                             seq_ordered: bool, selections: list,
                             n: int) -> list:
    """Per window: plan the merge permutation, keep the last row of each
    PK run, and emit padded host column dicts.  Returns
    [(cols, n_valid, capacity, encodings)]."""
    descs = []
    sort_cols = [host_cols[nm] for nm in sort_pk_names]
    for sel in selections:
        if sel is not None and not len(sel):
            continue
        if sel is None:
            base = _batch_merge_perm(sort_cols, seq_h, seq_ordered, n)
        else:
            base = _window_merge_sel(sort_cols, seq_h, seq_ordered, sel)
        keys = (sort_cols if base is None
                else [c[base] for c in sort_cols])
        keep = _host_dedup_keep(keys)
        k = int(keep.sum())
        if k == 0:
            continue
        if base is None:
            if k == n and sel is None:
                # no duplicates, already padded
                descs.append(({kk: np.asarray(v) for kk, v
                               in dev.columns.items()},
                              n, dev.capacity, dev.encodings))
                continue
            idx = np.flatnonzero(keep)
        else:
            idx = base if k == len(base) else base[keep]
        cap = encode.pad_capacity(k)
        cols = {kk: np.pad(v[idx], (0, cap - k))
                for kk, v in host_cols.items()}
        descs.append((cols, k, cap, dev.encodings))
    return descs


def _host_dedup_keep(sort_cols: list[np.ndarray]) -> np.ndarray:
    """Keep-mask over PK-SORTED rows: the LAST row of each equal-PK run
    survives (the highest-sequence row arrives last)."""
    n = len(sort_cols[0])
    if n == 0:
        return np.zeros(0, dtype=bool)
    keep = np.empty(n, dtype=bool)
    keep[-1] = True
    diff = np.zeros(n - 1, dtype=bool)
    for c in sort_cols:
        diff |= c[:-1] != c[1:]
    keep[:-1] = diff
    return keep


def _plan_pk_windows(pk1_codes: np.ndarray, window: int) -> list[np.ndarray]:
    """Partition rows into PK-range windows of <= `window` rows; rows
    sharing a first-PK code always land in one window, and windows are
    code-ascending, so concatenated outputs stay globally PK-sorted."""
    _, inv, counts = np.unique(pk1_codes, return_inverse=True,
                               return_counts=True)
    order = np.argsort(inv, kind="stable")
    boundaries = np.cumsum(np.concatenate([[0], counts]))
    nkeys = len(counts)
    windows: list[np.ndarray] = []
    s = 0
    while s < nkeys:
        e = int(np.searchsorted(boundaries, boundaries[s] + window,
                                side="right")) - 1
        if e <= s:
            e = s + 1  # single code over budget: a window of its own
        windows.append(order[boundaries[s]:boundaries[e]])
        s = e
    return windows


def _eval_predicate_host(pred, batch: pa.RecordBatch) -> np.ndarray:
    """Host twin of ops.filter.eval_predicate over an Arrow batch of raw
    values."""
    F = filter_ops
    if isinstance(pred, F.And):
        out = np.ones(batch.num_rows, dtype=bool)
        for c in pred.children:
            out &= _eval_predicate_host(c, batch)
        return out
    if isinstance(pred, F.Or):
        out = np.zeros(batch.num_rows, dtype=bool)
        for c in pred.children:
            out |= _eval_predicate_host(c, batch)
        return out
    if isinstance(pred, F.Not):
        return ~_eval_predicate_host(pred.child, batch)
    col = batch.column(batch.schema.names.index(pred.column))
    return F.leaf_mask_host(pred, col.to_numpy(zero_copy_only=False))


def plan_columns(schema: StorageSchema,
                 projections: Optional[list[int]]) -> list[str]:
    """The column set a merge plan reads for a projection: shared by
    build_plan and the memtable overlay (wal/ingest.py), so hybrid and
    pure-SST scans cannot disagree on shape."""
    proj = schema.fill_required_projections(projections)
    if proj is None:
        columns = list(schema.arrow_schema.names)
    else:
        columns = [schema.arrow_schema.names[i] for i in proj]
    # __reserved__ is never read (all-null, unused); __seq__ must be
    # read for dedup even when it will be stripped from the output.
    columns = [c for c in columns if c != RESERVED_COLUMN_NAME]
    if SEQ_COLUMN_NAME not in columns:
        columns.append(SEQ_COLUMN_NAME)
    return columns


def merge_memtable_overlay(schema: StorageSchema,
                           sst_parts: list[pa.RecordBatch],
                           mem_batches: list[pa.RecordBatch],
                           predicate,
                           columns: list[str],
                           keep_builtin: bool) -> Optional[pa.RecordBatch]:
    """Host merge of ONE segment's already-merged SST rows with its
    memtable overlay: the hybrid scan's last stage (wal/ingest.py).

    Both sources carry per-row `__seq__` (sst_parts from a keep_builtin
    plan, mem_batches stamped with each entry's write seq), so
    Overwrite's last-value rule is one sort by (PK, __seq__) keeping the
    final row of every PK run.  The full predicate applies AFTER the
    dedup, as on the pure-SST path: filtering first would resurrect
    overwritten rows.  Seqs are preserved end to end, so a replayed
    memtable row and its flushed SST twin tie on (PK, seq) with equal
    values, and either winning is exactly-once."""
    import pyarrow.compute as pc

    from horaedb_tpu_torch.storage.operator import LastValueOperator

    target = pa.schema([schema.arrow_schema.field(
        schema.arrow_schema.names.index(c)) for c in columns])
    parts = []
    for b in list(sst_parts) + list(mem_batches):
        if b.num_rows == 0:
            continue
        b = b.select(columns)
        if not b.schema.equals(target):
            b = b.cast(target)
        parts.append(b)
    if not parts:
        return None
    table = pa.Table.from_batches(parts, schema=target)
    sort_keys = [(n, "ascending") for n in schema.primary_key_names]
    sort_keys.append((SEQ_COLUMN_NAME, "ascending"))
    table = table.take(pc.sort_indices(table, sort_keys=sort_keys))
    batch = table.combine_chunks().to_batches()[0]
    pk_indices = [columns.index(n) for n in schema.primary_key_names]
    batch = LastValueOperator().merge_sorted_batch(batch, pk_indices)
    if predicate is not None and batch.num_rows:
        mask = _eval_predicate_host(predicate, batch)
        batch = batch.take(np.flatnonzero(mask))
    if not keep_builtin:
        batch = batch.select([c for c in batch.schema.names
                              if not StorageSchema.is_builtin_name(c)])
    return batch


def describe_plan(plan: ScanPlan) -> str:
    """Indented plan text for golden tests (the analogue of the
    reference's DisplayableExecutionPlan assertion)."""
    lines = [f"MergeScan: mode={plan.mode.value}, "
             f"keep_builtin={plan.keep_builtin}"]
    for seg in plan.segments:
        kind = ("DeviceMergeDedup" if plan.mode is UpdateMode.OVERWRITE
                else "HostBytesMerge")
        lines.append(f"  Segment[start={seg.segment_start}]: {kind}")
        if plan.predicate is not None:
            lines.append(f"    Filter: {plan.predicate!r}")
        files = ", ".join(f"{f.id}.sst" for f in seg.ssts)
        pushed = ", pushdown=yes" if plan.pushdown is not None else ""
        lines.append(f"    ParquetScan: files=[{files}], "
                     f"columns={seg.columns}{pushed}")
    return "\n".join(lines)
