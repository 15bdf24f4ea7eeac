"""Whether what the timed path returned is correct: each kept result
against the plain reference, row by row and cell by cell.

Numbers compared, each against its limit in `perfbench/limits/<cell>.json`:

- `avg_gap`: the widest gap, over every kept query, field, series and
  bucket, between the engine's mean and the reference's, in the
  field's own units (TSBS's values lie in [0, 100]);
- `count_wrong`: cells whose count is not the reference's;
- `series_wrong`: result rows whose series is unknown, repeated, or
  carries other tags than the host the reference gives them, plus hosts
  missing from a result;
- `queries_checked`: the kept queries compared; fewer than the limit is
  a fault (a run that kept nothing proves nothing).
"""

from __future__ import annotations

import numpy as np

from perfbench import tsbs
from perfbench.reference import tsbs_downsample


def parse_series_key(key: bytes, metric: str) -> dict:
    """`cpu{k=v,...}` -> {k: v}; {} when the key is not of that form."""
    text = key.decode()
    head = metric + "{"
    if not text.startswith(head) or not text.endswith("}"):
        return {}
    body = text[len(head):-1]
    return dict(kv.split("=", 1) for kv in body.split(",")) if body else {}


def host_of_series(series_keys: dict, data: tsbs.TsbsData,
                   metric: str) -> dict:
    """tsid -> host index, for the keys whose every tag is that host's;
    other tsids map to -1."""
    out = {}
    for tsid, key in series_keys.items():
        tags = parse_series_key(key, metric)
        name = tags.get("hostname", "")
        h = -1
        if name.startswith("host_") and name[5:].isdigit():
            h = int(name[5:])
            if h >= data.cfg.num_hosts or tags != data.host_tags(h):
                h = -1
        out[int(tsid)] = h
    return out


def compare(kept: dict, starts: dict, series_keys: dict,
            data: tsbs.TsbsData, traffic: dict, metric: str) -> dict:
    """The compared numbers over every kept result.  `kept` is {query
    index: {field: host result}}, `starts` {query index: window start},
    `series_keys` {tsid: series key} as the engine resolved them."""
    cfg = data.cfg
    hosts_of = host_of_series(series_keys, data, metric)
    gap = 0.0
    count_wrong = 0
    series_wrong = 0
    for i, by_field in kept.items():
        for fname, res in by_field.items():
            ref_avg, ref_count = tsbs_downsample.downsample(
                data.values[data.fields.index(fname)], starts[i],
                traffic["window_ms"], traffic["bucket_ms"], cfg.start_ms,
                cfg.interval_ms)
            rows = np.array([hosts_of.get(int(t), -1)
                             for t in res["tsids"]], dtype=np.int64)
            avg = np.asarray(res["aggs"].get("avg"), dtype=np.float64)
            count = np.asarray(res["aggs"].get("count"))
            valid = rows >= 0
            uniq, seen = np.unique(rows[valid], return_counts=True)
            series_wrong += int((~valid).sum()) + int((seen - 1).sum())
            series_wrong += cfg.num_hosts - len(uniq)
            if avg.ndim != 2 or avg.shape != (len(rows), ref_avg.shape[1]) \
                    or count.shape != avg.shape:
                count_wrong += ref_count.size
                gap = float("inf")
                continue
            r = rows[valid]
            count_wrong += int((count[valid].astype(np.int64)
                                != ref_count[r]).sum())
            occupied = ref_count[r] > 0
            diff = np.abs(avg[valid][occupied] - ref_avg[r][occupied])
            if diff.size:
                # a NaN where the reference has a mean is the widest gap
                gap = max(gap, float(np.nan_to_num(diff, nan=np.inf).max()))
    return {"avg_gap": gap, "count_wrong": count_wrong,
            "series_wrong": series_wrong, "queries_checked": len(kept)}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}).  `queries_checked` must reach
    its limit; every other number must not pass its own."""
    checks = {}
    ok = True
    for name, value in numbers.items():
        limit = limits[name]
        passed = value >= limit if name == "queries_checked" \
            else value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
