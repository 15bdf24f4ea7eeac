"""Engine configuration (ref: src/storage/src/config.rs).

Field names and defaults track the reference's TOML keys so configs are
interchangeable: scheduler (config.rs:24-50), parquet encodings (52-94),
per-column overrides (96-103), write props (105-133), manifest (135-155),
UpdateMode (166-172).  Unknown keys are rejected (serde deny_unknown_fields
equivalent) by `from_dict`.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import typing
from dataclasses import dataclass, field
from typing import Any, Optional

from horaedb_tpu_torch.common import Error, ReadableDuration, ReadableSize, ensure


class UpdateMode(enum.Enum):
    """Row-merge semantics for duplicate primary keys (ref: config.rs:166-172).

    OVERWRITE keeps the row with the highest sequence (LastValueOperator);
    APPEND concatenates binary value columns (BytesMergeOperator).
    """

    OVERWRITE = "Overwrite"
    APPEND = "Append"


class CompressionCodec(enum.Enum):
    UNCOMPRESSED = "uncompressed"
    SNAPPY = "snappy"
    ZSTD = "zstd"
    LZ4 = "lz4"
    GZIP = "gzip"


@dataclass
class SchedulerConfig:
    """Compaction scheduler knobs (ref: config.rs:24-50), read by
    storage/compaction.py."""

    schedule_interval: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(10))
    max_pending_compaction_tasks: int = 10
    # Executor memory gate (ref: executor.rs:93-114 uses 2 GiB default).
    memory_limit: ReadableSize = field(default_factory=lambda: ReadableSize.gb(2))
    # Picker thresholds (ref: picker.rs defaults).
    max_record_batch_size: int = 8192
    input_sst_max_num: int = 30
    input_sst_min_num: int = 5
    new_sst_max_size: ReadableSize = field(default_factory=lambda: ReadableSize.gb(1))
    ttl: Optional[ReadableDuration] = None


@dataclass
class ColumnOptions:
    """Per-column parquet writer overrides (ref: config.rs:96-103)."""

    enable_dict: Optional[bool] = None
    enable_bloom_filter: Optional[bool] = None
    encoding: Optional[str] = None
    compression: Optional[CompressionCodec] = None


@dataclass
class WriteConfig:
    """Parquet writer properties (ref: config.rs:105-133)."""

    max_row_group_size: int = 8192
    write_batch_size: int = 1024
    enable_sorting_columns: bool = True
    enable_dict: bool = False
    enable_bloom_filter: bool = False
    encoding: Optional[str] = None
    compression: CompressionCodec = CompressionCodec.SNAPPY
    column_options: dict[str, ColumnOptions] = field(default_factory=dict)
    # persist a device-layout sidecar ({id}.enc) next to each OVERWRITE
    # -mode SST so cold scans skip parquet decode + re-encode entirely
    # (no reference analogue; see storage/sidecar.py)
    enable_sidecar: bool = True
    # compaction outputs above this row count skip the sidecar.  NOTE:
    # unlike the parquet rewrite (streamed, ~MBs of RSS), the sidecar's
    # encoded columns accumulate in RAM until the rewrite finishes —
    # ~12 bytes/row, so the default caps that at ~768 MiB.  Lower it on
    # memory-constrained nodes; large compactions past the cap simply
    # fall back to parquet-only cold reads.
    sidecar_max_rows: int = 64 << 20


@dataclass
class ManifestConfig:
    """Manifest merge thresholds (ref: config.rs:135-155, manifest/mod.rs:48-50)."""

    channel_size: int = 3
    merge_interval: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(5))
    min_merge_threshold: int = 10
    hard_merge_threshold: int = 90
    soft_merge_threshold: int = 50
    # how long a writer may throttle waiting for the background fold to
    # drain below the soft threshold before proceeding toward the hard
    # limit (no reference analogue: its merger runs on its own threads)
    soft_merge_max_wait: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(2))


@dataclass
class RetryConfig:
    """Object-store retry middleware for the manifest plane
    (objstore/middleware.py).  This is the ONE engine-level retry
    layer: the data plane (SST puts/reads) stays single-shot so
    write-path failures surface to the caller's rollback discipline."""

    enabled: bool = True
    max_retries: int = 2
    base_backoff: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_millis(50))
    max_backoff: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(2))
    # total per-op wall clock including retries; None = unbounded
    op_deadline: Optional[ReadableDuration] = None
    # shared retry token bucket: capacity + refill rate (tokens/second)
    budget: int = 32
    budget_refill_per_s: float = 4.0


@dataclass
class ScrubConfig:
    """Orphan scrubber (storage/gc.py): reconciles data/ objects against
    the manifest and deletes unreferenced objects that stay orphaned for
    a full grace period.  The grace period must comfortably exceed the
    longest plausible gap between an SST put and its manifest add (a
    write or compaction in flight) — minutes, not seconds."""

    enabled: bool = True
    interval: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(600))
    grace_period: ReadableDuration = field(
        default_factory=lambda: ReadableDuration.from_secs(600))


@dataclass
class ScanCacheConfig:
    """Tier-2 scan cache ([scan.cache]; storage/encoded_cache.py):
    host-RAM per-SST encoded sidecar parts under the post-merge window
    cache.  A window-cache miss rebuilds from host memory, and a flush
    or compaction invalidates only the SSTs it removed."""

    # host-RAM byte budget for per-SST encoded parts (0 disables tier 2:
    # every window-cache miss reads the object store)
    tier2_max_bytes: int = 256 << 20
    # write-through admission: writes, WAL flushes and compactions
    # insert the columns they just encoded, so a query right after a
    # flush reads nothing from the store
    write_through: bool = True


@dataclass
class ScanPipelineConfig:
    """Cold-scan pipelining ([scan.pipeline]; storage/pipeline.py): a
    fetch stage keeps up to `depth` segments' store reads in flight
    (tier-2-resident parts skip the store), a decode stage merges one
    segment at a time on the worker pool, and the aggregate rounds
    consume finished windows in plan order.  `enabled = false` runs the
    sequential pump; results are bit-identical either way."""

    enabled: bool = True
    # segments in flight across the pipeline (fetch started -> consumed)
    depth: int = 32
    # host-RAM budget for in-flight state (fetched parts or tables plus
    # decoded, unconsumed windows); one oversized segment is always
    # admitted
    inflight_bytes: int = 256 << 20


@dataclass
class ScanCombineConfig:
    """Aggregate combine/finalize knobs of the parts path ([scan.combine];
    see storage/combine.py).  `mode = "sparse"` (default) folds partial
    grids straight into the final output buffers; `"dense"` is the
    accumulator fold kept as the bit-identity control."""

    mode: str = "sparse"
    # byte budget for the delta-summation memo: per-segment aggregate
    # partials keyed by the segment's exact SST set, served to
    # narrowed/refined ranges of the same query shape so only delta
    # segments recompute.  0 disables the memo.
    memo_max_bytes: int = 128 << 20


@dataclass
class ScanDecodeConfig:
    """Device-native decode ([scan.decode]; see ops/device_decode.py):
    an eligible aggregate scan uploads each segment's ENCODED sidecar
    columns raw, and the card runs leaf filter + merge + keep-last dedup
    + bucket_window_partials on them, so the host only moves the bytes.

    mode:
      "auto"   — engage on a CUDA reader for plans the fused aggregate
                 declines (the oversized cold shape); a CPU reader
                 keeps host decode.
      "device" — the dispatch wherever structurally eligible (it also
                 outranks the fused aggregate for such plans).
      "host"   — host decode and host merge everywhere: the bit-identity
                 control.
    HORAEDB_DEVICE_DECODE=1/0 forces device/host over the config.
    Ineligible plans and segments fall back per reason, counted in
    scan_decode_fallback_total:<reason>."""

    mode: str = "auto"
    # device-memory admission per segment: a segment whose padded upload
    # would exceed this decodes on the host instead (reason "budget")
    max_upload_bytes: int = 256 << 20


@dataclass
class ScanMeshConfig:
    """In-region 2-D device mesh for the aggregate scan ([scan.mesh]):
    plan segments shard along the `time` axis and group blocks along the
    `series` axis (parallel/mesh.py), over the local devices of the
    reader's device type.  Parsed and validated as the JAX package
    parses it, so the same TOML loads in both."""

    enabled: bool = False
    # axis sizes; 0 = auto.  `series` must be a power of two
    time: int = 0
    series: int = 0
    # per-device admission gate for one round's transient partial grid
    max_grid_bytes: int = 256 << 20


@dataclass
class ScanConfig:
    """Device scan execution knobs (no reference analogue)."""

    # max rows per merge window; segments larger than this are processed
    # as PK-range-partitioned windows
    max_window_rows: int = 1 << 20
    # post-merge window cache budget in rows (0 disables); keyed by
    # (segment, SST set, columns) so writes invalidate structurally.
    # The cache accounts BYTES; this row knob converts at
    # read._CACHE_BYTES_PER_ROW unless cache_max_bytes overrides it.
    cache_max_rows: int = 4 << 20
    # explicit budget in bytes for the scan cache (0 = derive from
    # cache_max_rows)
    cache_max_bytes: int = 0
    # slots of the 1-D segment mesh (parallel/mesh.py segment_mesh) the
    # aggregate rounds shard over (0 = single device)
    mesh_devices: int = 0
    # windows (across segments) batched into one aggregate round — the
    # window axis of one kernel launch (fused and parts paths)
    agg_batch_windows: int = 16
    # segments whose manifest row count exceeds this are read window by
    # window: PK value-range windows planned from sidecar block stats
    # (or a first parquet pass over one PK column), each window's rows
    # read alone, so host memory is bounded by the window budget.  0
    # disables streaming
    stream_read_min_rows: int = 8 << 20
    # byte twin of the row knob (manifest SST sizes): a segment under
    # the row threshold still streams when its stored bytes exceed this
    # and it spans more than one window; 0 disables the byte trigger
    stream_read_min_bytes: int = 512 << 20
    # read device-layout sidecars ({id}.enc) on bulk segment reads when
    # present (see storage/sidecar.py); disable to force parquet decode
    use_sidecar: bool = True
    # segment reads in flight ahead of the merge position on the
    # sequential pump (the pipeline's depth supersedes it when on)
    prefetch_segments: int = 4
    # width of the "sst" decode pool; 0 = threads.sst_thread_num
    decode_workers: int = 0
    cache: ScanCacheConfig = field(default_factory=ScanCacheConfig)
    combine: ScanCombineConfig = field(default_factory=ScanCombineConfig)
    pipeline: ScanPipelineConfig = field(
        default_factory=ScanPipelineConfig)
    decode: ScanDecodeConfig = field(default_factory=ScanDecodeConfig)
    # 2-D (time x series) mesh scan knobs ([scan.mesh]); mutually
    # exclusive with mesh_devices above
    mesh: ScanMeshConfig = field(default_factory=ScanMeshConfig)


@dataclass
class ThreadsConfig:
    """Worker-pool sizes (ref: the server's threads config feeding
    StorageRuntimes, src/server/src/main.rs:104-109)."""

    sst_thread_num: int = 4
    compact_thread_num: int = 2
    manifest_thread_num: int = 1


@dataclass
class StorageConfig:
    """Top-level engine config (ref: config.rs:157-164)."""

    write: WriteConfig = field(default_factory=WriteConfig)
    manifest: ManifestConfig = field(default_factory=ManifestConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    scan: ScanConfig = field(default_factory=ScanConfig)
    threads: ThreadsConfig = field(default_factory=ThreadsConfig)
    retry: RetryConfig = field(default_factory=RetryConfig)
    scrub: ScrubConfig = field(default_factory=ScrubConfig)
    update_mode: UpdateMode = UpdateMode.OVERWRITE


_DURATION_FIELDS = {"schedule_interval", "merge_interval", "ttl",
                    "soft_merge_max_wait", "base_backoff", "max_backoff",
                    "op_deadline", "interval", "grace_period"}
_SIZE_FIELDS = {"memory_limit", "new_sst_max_size"}
# Nested sections, keyed by field name.  This dict is THE mechanism for
# nested coercion: add new nested config dataclasses here.
_NESTED = {
    "write": WriteConfig,
    "manifest": ManifestConfig,
    "scheduler": SchedulerConfig,
    "scan": ScanConfig,
    "cache": ScanCacheConfig,
    "combine": ScanCombineConfig,
    "pipeline": ScanPipelineConfig,
    "decode": ScanDecodeConfig,
    "mesh": ScanMeshConfig,
    "threads": ThreadsConfig,
    "retry": RetryConfig,
    "scrub": ScrubConfig,
}


def _coerce(cls: type, f: dataclasses.Field, value: Any) -> Any:
    where = f"{cls.__name__}.{f.name}"
    if value is None:
        return None
    if f.name in _DURATION_FIELDS:
        if isinstance(value, ReadableDuration):
            return value
        ensure(isinstance(value, str), f'{where} expects a duration string like "10s"')
        return ReadableDuration.parse(value)
    if f.name in _SIZE_FIELDS:
        if isinstance(value, ReadableSize):
            return value
        ensure(isinstance(value, str), f'{where} expects a size string like "2GB"')
        return ReadableSize.parse(value)
    if f.name == "update_mode":
        if isinstance(value, UpdateMode):
            return value
        try:
            return UpdateMode(value)
        except ValueError as e:
            raise Error.context(
                f"{where}: expected one of {[m.value for m in UpdateMode]}", e)
    if f.name == "compression":
        if isinstance(value, CompressionCodec):
            return value
        try:
            return CompressionCodec(str(value).lower())
        except ValueError as e:
            raise Error.context(
                f"{where}: expected one of {[c.value for c in CompressionCodec]}", e)
    if f.name == "column_options":
        ensure(isinstance(value, dict), f"{where} expects a table of column options")
        return {k: from_dict(ColumnOptions, v) for k, v in value.items()}
    if f.name in _NESTED:
        ensure(isinstance(value, dict), f"{where} expects a config table")
        return from_dict(_NESTED[f.name], value)
    return _check_scalar(cls, f, value, where)


def _check_scalar(cls: type, f: dataclasses.Field, value: Any, where: str) -> Any:
    """Validate plain int/bool/str fields against their declared type so
    misconfigurations fail at load, not mid-flight (bool checked before int
    since bool subclasses int)."""
    hints = _type_hints(cls)
    declared = hints.get(f.name)
    if declared is None:
        return value
    origin = typing.get_origin(declared)
    if origin is typing.Union:  # Optional[T]
        args = [a for a in typing.get_args(declared) if a is not type(None)]
        if len(args) != 1:
            return value
        declared = args[0]
    if declared is bool:
        ensure(isinstance(value, bool), f"{where} expects a boolean")
    elif declared is int:
        ensure(isinstance(value, int) and not isinstance(value, bool),
               f"{where} expects an integer")
    elif declared is str:
        ensure(isinstance(value, str), f"{where} expects a string")
    return value


@functools.lru_cache(maxsize=None)
def _type_hints(cls: type) -> dict[str, Any]:
    return typing.get_type_hints(cls)


def from_dict(cls: type, data: dict[str, Any]) -> Any:
    """Build a config dataclass from a parsed TOML/JSON dict.

    Rejects unknown keys, mirroring serde's deny_unknown_fields
    (ref: config.rs:24-26 and every config struct), and validates value
    types at load time so misconfigurations fail here, not mid-flight.
    """
    ensure(isinstance(data, dict), f"{cls.__name__} config must be a table")
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(names)
    if unknown:
        raise Error(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {key: _coerce(cls, names[key], value) for key, value in data.items()}
    return cls(**kwargs)
