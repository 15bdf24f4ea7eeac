"""Whether what the timed path returned is correct: each kept result
against the plain reference, row by row and cell by cell.  A mix's
result is compared in the aggregates it asks for (`aggs` of its traffic
file) and over the hosts its query named: every host, or the set drawn
for it (`host_draw`).

Numbers compared, each against its limit in `perfbench/limits/<cell>.json`:

- `avg_gap` (where `avg` is asked): the widest gap, over every kept
  query, field, series and bucket, between the engine's mean and the
  reference's, in the field's own units (TSBS's values lie in
  [0, 100]);
- `max_wrong`, `min_wrong` (where asked): cells whose value is not, bit
  for bit, the float32 rounding of the float64 reference's max (min).
  Rounding is monotone, so the float32 max of the samples is exactly
  that; an empty cell reads -inf (+inf);
- `count_wrong`: cells whose count is not the reference's;
- `series_wrong`: result rows whose series is unknown, repeated, of a
  host the query did not name, or carries other tags than the host the
  reference gives it, plus named hosts missing from a result;
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
            data: tsbs.TsbsData, traffic: dict, metric: str,
            hosts: dict = None) -> dict:
    """The compared numbers over every kept result.  `kept` is {query
    index: {field: host result}}, `starts` {query index: window start},
    `series_keys` {tsid: series key} as the engine resolved them,
    `hosts` {query index: the host indices it named}; a query missing
    from it, or all of them when it is None, named every host."""
    cfg = data.cfg
    hosts = hosts or {}
    hosts_of = host_of_series(series_keys, data, metric)
    exact = [a for a in ("max", "min") if a in traffic["aggs"]]
    asked = (["avg"] if "avg" in traffic["aggs"] else []) + exact
    gap = 0.0
    wrong = dict.fromkeys(exact, 0)
    count_wrong = 0
    series_wrong = 0
    for i, by_field in kept.items():
        named = hosts.get(i)
        named = np.arange(cfg.num_hosts) if named is None \
            else np.asarray(named, dtype=np.int64)
        # host index -> its row of the reference, -1 where not named
        ref_row = np.full(cfg.num_hosts, -1, dtype=np.int64)
        ref_row[named] = np.arange(len(named))
        for fname, res in by_field.items():
            ref = tsbs_downsample.downsample(
                data.values[data.fields.index(fname)], starts[i],
                traffic["window_ms"], traffic["bucket_ms"], cfg.start_ms,
                cfg.interval_ms, aggs=tuple(asked),
                hosts=None if len(named) == cfg.num_hosts else named)
            ref_count = ref["count"]
            rows = np.array([hosts_of.get(int(t), -1)
                             for t in res["tsids"]], dtype=np.int64)
            rows = np.where(rows >= 0, ref_row[np.maximum(rows, 0)], -1)
            got = {a: np.asarray(res["aggs"].get(a), dtype=np.float64)
                   for a in asked}
            count = np.asarray(res["aggs"].get("count"))
            valid = rows >= 0
            uniq, seen = np.unique(rows[valid], return_counts=True)
            series_wrong += int((~valid).sum()) + int((seen - 1).sum())
            series_wrong += len(named) - len(uniq)
            shape = (len(rows), ref_count.shape[1])
            if any(g.ndim != 2 or g.shape != shape for g in got.values()) \
                    or count.shape != shape:
                count_wrong += ref_count.size
                gap = float("inf") if "avg" in got else gap
                for a in exact:
                    wrong[a] += ref_count.size
                continue
            r = rows[valid]
            count_wrong += int((count[valid].astype(np.int64)
                                != ref_count[r]).sum())
            if "avg" in got:
                occupied = ref_count[r] > 0
                diff = np.abs(got["avg"][valid][occupied]
                              - ref["avg"][r][occupied])
                if diff.size:
                    # a NaN where the reference has a mean is the widest
                    # gap
                    gap = max(gap, float(np.nan_to_num(diff,
                                                       nan=np.inf).max()))
            for a in exact:
                want = ref[a][r].astype(np.float32).view(np.uint32)
                have = got[a][valid].astype(np.float32).view(np.uint32)
                wrong[a] += int((have != want).sum())
    numbers = {"avg_gap": gap} if "avg" in asked else {}
    numbers.update({f"{a}_wrong": wrong[a] for a in exact})
    numbers.update(count_wrong=count_wrong, series_wrong=series_wrong,
                   queries_checked=len(kept))
    return numbers


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
