"""The one general generator of the traffic mixes: it reads a traffic
file's parameters and drives the engine with them in a closed loop.

A traffic file (`perfbench/traffic/<name>.json`) states:

- `entry`: `query_downsample` (one field) or `query_downsample_multi`;
- `fields`: a list of field names, or `"all"` for the configuration's;
- `aggs`, `bucket_ms`, `window_ms`, `filters`: the query's shape;
- `start_resolution_ms`: window starts are drawn uniformly from the
  data span at this resolution (TSBS draws random starts the same way);
- `workers`: the closed loop's clients, each waiting for its reply;
- `host_draw` (optional, n): each query names n distinct hosts, drawn
  uniformly from the configuration's hosts with the query's own seeded
  stream, as TSBS draws them (`getRandomHosts`); the warm-up draws its
  sets from a stream of its own.  Without it a query reads every host.

The drawn set goes to the engine in one call, as one matcher on
`hostname` after the file's `filters` (TSBS issues one statement with
the hosts OR'd): `("hostname", "host_7")` for n = 1, the form the
engine takes today, and for n > 1 the tuple of the drawn names in the
order drawn, `("hostname", ("host_7", "host_912", ...))`, which matches
a series whose `hostname` is any of them.

Every seed gives the same work in another order: each query covers
`window_ms` of data at another start, and of as many hosts."""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from perfbench import tsbs


def query_fields(traffic: dict, config: dict) -> list:
    f = traffic["fields"]
    return list(config["fields"]) if f == "all" else list(f)


def window_starts(traffic: dict, config: dict, rng: np.random.Generator,
                  n: int) -> np.ndarray:
    """`n` window starts, uniform over the starts whose whole window
    lies inside the data span."""
    res = traffic["start_resolution_ms"]
    slots = (config["span_ms"] - traffic["window_ms"]) // res + 1
    return config["start_ms"] + rng.integers(0, slots, n) * res


def host_drawer(traffic: dict, config: dict, words: list):
    """`draw(i)`: the hosts query `i` names, `host_draw` distinct host
    indices in the order drawn from the stream seeded by `words + [i]`;
    None for a mix without `host_draw`."""
    n = traffic.get("host_draw")

    def draw(i: int):
        if n is None:
            return None
        rng = np.random.default_rng([*words, i])
        return rng.choice(config["scale"], n, replace=False)

    return draw


def host_matcher(hosts) -> tuple:
    """The one `hostname` matcher of a drawn set: a name for one host,
    else the tuple of the names."""
    names = tuple(tsbs.host_name(int(h)) for h in hosts)
    return ("hostname", names[0] if len(names) == 1 else names)


def host_result(out: dict) -> dict:
    """A result as the user reads it: host arrays, which waits for the
    device."""
    return {"tsids": np.asarray(out["tsids"], dtype=np.uint64),
            "num_buckets": out["num_buckets"],
            "aggs": {k: (v.cpu().numpy() if hasattr(v, "cpu")
                         else np.asarray(v))
                     for k, v in out["aggs"].items()}}


async def issue(engine, traffic: dict, fields: list, metric: str,
                start_ms: int, span=None, hosts=None) -> dict:
    """One query of the mix; returns {field: host result}.  `hosts`, the
    drawn host indices, adds their matcher; None reads every host.
    `span(name)`, when given, is a context manager wrapped around the
    engine call and around the download of its result."""
    import contextlib

    span = span or (lambda _name: contextlib.nullcontext())
    with span(traffic["entry"]):
        out = await _call(engine, traffic, fields, metric, start_ms, hosts)
    with span("to_host"):
        return {f: host_result(r) for f, r in out.items()}


async def _call(engine, traffic, fields, metric, start_ms, hosts) -> dict:
    from horaedb_tpu_torch.storage.types import TimeRange

    tr = TimeRange.new(int(start_ms), int(start_ms) + traffic["window_ms"])
    filters = [tuple(f) for f in traffic["filters"]]
    if hosts is not None:
        filters.append(host_matcher(hosts))
    aggs = tuple(traffic["aggs"])
    if traffic["entry"] == "query_downsample":
        (f,) = fields
        out = {f: await engine.query_downsample(
            metric, filters, tr, traffic["bucket_ms"], field=f, aggs=aggs)}
    elif traffic["entry"] == "query_downsample_multi":
        out = await engine.query_downsample_multi(
            metric, filters, tr, traffic["bucket_ms"], fields, aggs=aggs)
    else:
        raise ValueError(f"unknown entry {traffic['entry']!r}")
    return out


@dataclass
class Query:
    index: int
    start_ms: int
    issued: float
    # the drawn host indices; None for every host
    hosts: Optional[np.ndarray] = None
    done: float = 0.0
    error: str = ""


@dataclass
class LoopResult:
    queries: list
    window_start: float
    window_end: float
    # {query index: {field: host result}} for the seeded sample kept
    kept: dict = field(default_factory=dict)

    def completed_in_window(self) -> int:
        return sum(1 for q in self.queries
                   if not q.error and q.done <= self.window_end)

    def work_in_window(self) -> float:
        """Queries done inside the window, a query still in flight at
        the close counting by the share of its time that lay inside.
        The clients start together, so their queries tend to finish
        together; a whole-query count would jump by the clients' number
        with the phase of the close."""
        total = 0.0
        for q in self.queries:
            if q.error:
                continue
            inside = min(q.done, self.window_end) - q.issued
            total += max(0.0, inside) / max(q.done - q.issued, 1e-9)
        return total

    def latencies_ms(self) -> list:
        return [(q.done - q.issued) * 1e3 for q in self.queries
                if not q.error]


async def closed_loop(engine, traffic: dict, fields: list, metric: str,
                      starts: np.ndarray, seconds: float, keep: int,
                      keep_seed: int, span=None,
                      draw_hosts=lambda _i: None) -> LoopResult:
    """`traffic["workers"]` clients, each issuing its next query as soon
    as its last one returns, for `seconds`; query `i` starts at
    `starts[i]` and names the hosts `draw_hosts(i)`.  Queries issued
    before the close all run to their end.  A uniform sample of `keep` completed
    queries (reservoir sampling from `keep_seed`) keeps its results for
    the check.  `span(name)`, when given, is a context manager wrapped
    around each engine call and each download."""
    sampler = random.Random(keep_seed)
    queries: list = []
    kept: dict = {}
    seen = 0
    next_index = 0
    t_start = time.perf_counter()
    t_end = t_start + seconds

    async def client() -> None:
        nonlocal next_index, seen
        while time.perf_counter() < t_end:
            i = next_index
            next_index += 1
            if i >= len(starts):
                raise RuntimeError("the traffic ran out of window starts")
            hosts = draw_hosts(i)
            q = Query(i, int(starts[i]), time.perf_counter(), hosts)
            queries.append(q)
            try:
                res = await issue(engine, traffic, fields, metric,
                                  q.start_ms, span, hosts)
            except Exception as e:  # a failed query counts as failed
                q.done = time.perf_counter()
                q.error = f"{type(e).__name__}: {e}"
                continue
            q.done = time.perf_counter()
            seen += 1
            if len(kept) < keep:
                kept[i] = res
            else:
                j = sampler.randrange(seen)
                if j < keep:
                    del kept[sampler.choice(sorted(kept))]
                    kept[i] = res

    async with asyncio.TaskGroup() as tg:
        for _ in range(traffic["workers"]):
            tg.create_task(client())
    return LoopResult(queries, t_start, t_end, kept)
