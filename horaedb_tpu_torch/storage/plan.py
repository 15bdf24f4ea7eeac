"""Composable logical query plan over the merge-scan.

`QueryPlan` is the single internal currency every query shape routes
through: an entry point builds one, the storage facade executes it, and
`describe()` renders the plan text the golden tests pin.  Three shapes:
row scan (+filter/project), downsample aggregate, and top-k over the
aggregate's groups.
"""

from __future__ import annotations

import textwrap
from dataclasses import dataclass
from typing import Optional

import numpy as np

from horaedb_tpu_torch.common.error import ensure
from horaedb_tpu_torch.storage.read import (
    AggregateSpec,
    ScanPlan,
    ScanRequest,
    describe_plan,
)


@dataclass(frozen=True)
class TopKSpec:
    """Rank groups by one aggregate grid and keep the best k.

    `by` names a grid in the aggregate output (it must be in the
    spec's `which`); a group's score is that grid's best cell across
    buckets with data (max for largest=True, min otherwise)."""

    k: int
    by: str = "max"
    largest: bool = True


@dataclass
class QueryPlan:
    """scan -> filter (inside scan) -> aggregate? -> top_k?

    `scan` is the physical merge-scan plan captured at build time; it is
    the first attempt's plan in execute_plan (one manifest lookup per
    query)."""

    scan: ScanPlan
    request: ScanRequest
    aggregate: Optional[AggregateSpec] = None
    top_k: Optional[TopKSpec] = None

    def describe(self) -> str:
        text = describe_plan(self.scan)
        if self.aggregate is not None:
            spec = self.aggregate
            text = (f"Aggregate: group={spec.group_col}, "
                    f"ts={spec.ts_col}, value={spec.value_col}, "
                    f"bucket={spec.bucket_ms}ms, "
                    f"buckets={spec.num_buckets}, "
                    f"which={tuple(spec.which)}\n"
                    + textwrap.indent(text, "  "))
        if self.top_k is not None:
            tk = self.top_k
            text = (f"TopK: k={tk.k}, by={tk.by}, largest={tk.largest}\n"
                    + textwrap.indent(text, "  "))
        return text


def _host(grid) -> np.ndarray:
    """A grid as a host array: the fused path's grids are tensors on the
    reader's device."""
    if hasattr(grid, "cpu"):
        return grid.cpu().numpy()
    return np.asarray(grid)


def apply_top_k(group_values: np.ndarray, grids: dict,
                tk: TopKSpec) -> tuple[np.ndarray, dict]:
    """Host top-k over finalized grids: the group axis is small by then
    (one row per series), so ranking is a numpy stable argsort.  Returns
    (values, grids) sliced to the k best groups, best first, as host
    arrays.  Only the ranking grid and `count` come down whole; a grid
    on the device is sliced there, so only the k winners' rows move."""
    ensure(tk.by in grids,
           f"top-k by {tk.by!r} needs that aggregate in the spec's "
           f"`which`; have {sorted(grids)}")
    if not len(group_values):
        return group_values, grids
    by = _host(grids[tk.by]).astype(np.float64)
    count = _host(grids["count"])
    if tk.largest:
        score = np.where(count > 0, by, -np.inf).max(axis=1)
        order = np.argsort(-score, kind="stable")
    else:
        score = np.where(count > 0, by, np.inf).min(axis=1)
        order = np.argsort(score, kind="stable")
    idx = order[:tk.k]
    out = {}
    for name, g in grids.items():
        if hasattr(g, "index_select"):  # a tensor: slice on its device
            import torch

            rows = torch.as_tensor(idx, dtype=torch.int64, device=g.device)
            out[name] = g.index_select(0, rows).cpu().numpy()
        else:
            out[name] = np.asarray(g)[idx]
    return np.asarray(group_values)[idx], out
