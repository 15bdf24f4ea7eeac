"""Metric data model (ref: src/metric_engine/src/types.rs:17-41, RFC:34, 99).

`Sample` is the write unit and the currency between pipeline managers.
Ids are SeaHash-derived, masked to 63 bits so they remain representable
in parquet int64 statistics and the device's i64-epoch encode path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from horaedb_tpu_torch.common.seahash import hash64

# keep ids in i64-positive range (device + parquet friendliness)
_ID_MASK = (1 << 63) - 1

MetricId = int
SeriesId = int


@dataclass(frozen=True)
class Label:
    name: str
    value: str


@dataclass
class Sample:
    """One point: name + labels + (timestamp ms, value).

    `name_id` / `series_id` start None and are filled by MetricManager /
    IndexManager as the sample flows down the pipeline
    (ref: types.rs:25-38)."""

    name: str
    labels: list[Label]
    timestamp: int
    value: float
    name_id: Optional[MetricId] = None
    series_id: Optional[SeriesId] = None
    field_name: str = "value"


def metric_id_of(name: str) -> MetricId:
    """metric id = hash(name) (RFC:34)."""
    return hash64(name.encode()) & _ID_MASK


def field_id_of(field_name: str) -> int:
    """FieldId is u32 in the RFC's metrics table; derive it from the field
    name so distinct fields of one series never collide on the data PK."""
    return hash64(field_name.encode()) & 0x7FFF_FFFF


def series_key_of(name: str, labels: list[Label]) -> bytes:
    """Canonical series key: sorted `k=v` pairs joined by commas
    (RFC: SeriesKey = sorted TagKVs; the example renders
    {code=200, job=proxy, url=/api/put})."""
    parts = sorted(f"{l.name}={l.value}" for l in labels)
    return (name + "{" + ",".join(parts) + "}").encode()


def tsid_of(name: str, labels: list[Label]) -> SeriesId:
    """TSID = hash(sorted labels) scoped by metric name (RFC:99)."""
    return hash64(series_key_of(name, labels)) & _ID_MASK


def tsids_of_keys(keys: list[bytes]):
    """TSIDs for many canonical series keys at once: one call of the
    host library's batch SeaHash for the whole batch (high-cardinality
    ingest hashes a key per unique series).  Returns a uint64 numpy
    array aligned with `keys`."""
    import numpy as np

    from horaedb_tpu_torch import native

    return native.seahash64_batch(keys) & np.uint64(_ID_MASK)
