"""Composable logical query plan over the merge-scan.

`QueryPlan` is the single internal currency every query shape routes
through: an entry point builds one, the storage facade executes it.
The port carries two shapes — row scan (+filter) and downsample
aggregate; the JAX package's top-k stage is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from horaedb_tpu_torch.storage.read import (
    AggregateSpec,
    ScanPlan,
    ScanRequest,
)


@dataclass
class QueryPlan:
    """scan -> filter (inside scan) -> aggregate?

    `scan` is the physical merge-scan plan captured at build time; it is
    the first attempt's plan in execute_plan (one manifest lookup per
    query)."""

    scan: ScanPlan
    request: ScanRequest
    aggregate: Optional[AggregateSpec] = None

