"""Request-scoped tracing: trace IDs, tree-structured spans, a ring of
recent traces, and a slow-query log.

The reference uses field-style tracing events (tracing + EnvFilter,
SURVEY.md section 5) without spans; here spans are first-class and
request-scoped (docs/observability.md):

- every query/write through the HTTP server gets a `trace_id`
  (returned as the `X-Trace-Id` response header);
- `span(name, **fields)` records a real span (span_id/parent_id/
  status/fields) into the ambient trace when one is active — and keeps
  its original behavior (enter/exit logs + a latency histogram) either
  way, so background loops (compaction, manifest merge) stay observable
  without a trace;
- `record_interval(name, t0_ns, t1_ns)` records an interval measured
  elsewhere (a plan stage, a worker-pool hop, a garbage-collector
  pause) the same way, on the same clock;
- `trace_add(name, n)` attributes counted work (object-store GETs and
  bytes, cache tier hits, per-stage wall time) to the active trace;
- the trace context propagates across regions via the `X-Trace-Id`
  request header, and a downstream region exports its recorded spans
  back on the `X-Trace-Export` response header, so a scatter-gathered
  query yields ONE stitched distributed trace on the coordinator;
- completed traces land in a bounded ring (`GET /debug/traces`,
  `/debug/traces/{id}`), and traces over the slow threshold — or ones
  that died on their deadline — hit the slow-query log plus the
  `slow_queries_total` counter.

Context propagates through asyncio tasks natively and into the named
worker pools via `common.runtimes` (which copies the contextvars
context onto the pool thread), so stage attribution recorded inside
parquet decode / merge workers still lands on the right trace.

Every span carries `start_ns`/`end_ns` on `time.perf_counter_ns()`,
the clock a device trace is placed against, and the recording thread;
its `start_ms` is derived from the trace's anchor (its wall start and
its perf_counter_ns start), so one wall-clock read serves a trace.

Env: HORAEDB_TRACE=1 promotes span logs from DEBUG to INFO.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import gc
import json
import logging
import os
import random
import threading
import time
from collections import OrderedDict
from typing import Iterator, Optional

from horaedb_tpu_torch.utils.metrics import registry

logger = logging.getLogger("horaedb_tpu_torch.trace")
slow_logger = logging.getLogger("horaedb_tpu_torch.trace.slow")

TRACE_HEADER = "X-Trace-Id"
EXPORT_HEADER = "X-Trace-Export"

# aiohttp caps a header line at 8190 bytes; exports stay safely under
EXPORT_LIMIT = 7000

_SLOW_QUERIES = registry.counter(
    "slow_queries_total",
    "traced requests over the slow threshold (or deadline-exceeded)")
# ops get their OWN slow counter: an 11-minute compaction is slow, but
# it is not a slow QUERY — alerts on slow_queries_total must not fire
# during routine maintenance
_SLOW_OPS = registry.counter(
    "slow_ops_total",
    "background-op traces over their per-op slow threshold")
_TRACES_RECORDED = registry.counter(
    "traces_recorded_total", "traces completed into the trace ring")

_current_span: contextvars.ContextVar[str] = contextvars.ContextVar(
    "horaedb_span", default="")
_current_trace: contextvars.ContextVar[Optional["Trace"]] = \
    contextvars.ContextVar("horaedb_trace", default=None)
_current_span_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "horaedb_span_id", default="")

_LEVEL = logging.INFO if os.environ.get("HORAEDB_TRACE") == "1" else logging.DEBUG

# ids only need uniqueness, not secrecy; one process-wide PRNG seeded
# from urandom, guarded for thread use
_id_rng = random.Random(int.from_bytes(os.urandom(8), "big"))
_id_lock = threading.Lock()


def new_trace_id() -> str:
    with _id_lock:
        return f"{_id_rng.getrandbits(64):016x}"


def _new_span_id() -> str:
    with _id_lock:
        return f"{_id_rng.getrandbits(32):08x}"


def current_span() -> str:
    """Dotted path of the active span ("" outside any span)."""
    return _current_span.get()


def active_trace() -> Optional["Trace"]:
    """The ambient trace, or None outside a traced request."""
    return _current_trace.get()


def current_trace_id() -> str:
    trace = _current_trace.get()
    return trace.trace_id if trace is not None else ""


class Trace:
    """One request's (or background operation's) span buffer +
    counters.  Thread-safe: spans and counts arrive from the event loop
    AND worker-pool threads.  After `finish()` the trace is immutable —
    late adds (a straggler task outliving its request) are dropped, so
    work done after the query ended is attributed to nothing.

    `kind` separates the two trace populations: "query" (HTTP
    query/write requests) and "op" (background
    operations — compaction, flush, WAL commit rounds, rollup passes,
    scrub, health rounds; docs/observability.md, background plane).
    Op traces carry the op name in `op` and may override the recorder's
    slow threshold per-op via `slow_threshold_s`."""

    __slots__ = ("trace_id", "name", "kind", "op", "slow_threshold_s",
                 "root_fields", "root_span_id", "start_ms", "t0_ns",
                 "spans", "counters", "finished", "_lock")

    def __init__(self, trace_id: str, name: str, kind: str = "query",
                 op: str = "", slow_threshold_s: Optional[float] = None,
                 root_fields: Optional[dict] = None):
        self.trace_id = trace_id
        self.name = name
        self.kind = kind
        self.op = op
        self.slow_threshold_s = slow_threshold_s
        self.root_fields = dict(root_fields or {})
        self.root_span_id = _new_span_id()
        # the anchor: wall ms and perf_counter_ns read together, so a
        # span's start_ms follows from its start_ns
        self.start_ms = time.time() * 1e3
        self.t0_ns = time.perf_counter_ns()
        # span dicts; a local interval waits as a tuple (the arguments
        # of `interval`) until finish() writes it out, so recording one
        # costs the request little
        self.spans: list = []
        self.counters: dict[str, float] = {}
        self.finished = False
        self._lock = threading.Lock()

    def record_interval(self, span_id: Optional[str], parent_id: str,
                        name: str, t0_ns: int, t1_ns: int, status: str,
                        fields: dict, thread: int) -> None:
        """Record one local interval (span_id None: minted at finish)."""
        with self._lock:
            if not self.finished:
                self.spans.append((span_id, parent_id, name, t0_ns, t1_ns,
                                   status, fields, thread))

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            if not self.finished:
                self.counters[name] = self.counters.get(name, 0) + value

    # stitching bounds: a trace must stay ring-sized and exportable no
    # matter what its downstream peers send
    _IMPORT_MAX_SPANS = 512
    _IMPORT_MAX_COUNTERS = 256

    def import_remote(self, payload: dict, parent_id: str) -> None:
        """Stitch a downstream region's exported spans under
        `parent_id` (the RPC span that fetched them): remote roots —
        spans whose parent is not in the export — are reparented, and
        the remote's counters fold into ours.  Defensive by contract:
        entries that aren't span-shaped are skipped and both spans and
        counters are bounded — a peer on another version (or anything
        else answering that port) must never be able to blow up or
        bloat the coordinator's trace."""
        spans = payload.get("spans")
        if not isinstance(spans, list):
            spans = []
        spans = [s for s in spans if isinstance(s, dict)]
        ids = {s.get("span_id") for s in spans}
        with self._lock:
            if self.finished:
                return
            budget = self._IMPORT_MAX_SPANS - len(self.spans)
            for s in spans[:max(0, budget)]:
                if s.get("parent_id") not in ids:
                    s = dict(s, parent_id=parent_id)
                self.spans.append(s)
            counters = payload.get("counters")
            for k, v in (counters.items()
                         if isinstance(counters, dict) else ()):
                if not isinstance(v, (int, float)) \
                        or isinstance(v, bool):
                    continue
                if (k not in self.counters
                        and len(self.counters) >= self._IMPORT_MAX_COUNTERS):
                    continue
                self.counters[k] = self.counters.get(k, 0) + v

    def interval(self, span_id: Optional[str], parent_id: str, name: str,
                 t0_ns: int, t1_ns: int, status: str, fields: dict,
                 thread: Optional[int] = None) -> dict:
        """One span's record: the interval [t0_ns, t1_ns) of
        time.perf_counter_ns(), with start_ms placed from the anchor."""
        return {
            "span_id": span_id or _new_span_id(), "parent_id": parent_id,
            "name": name,
            "start_ms": round(self.start_ms + (t0_ns - self.t0_ns) / 1e6,
                              3),
            "duration_ms": round((t1_ns - t0_ns) / 1e6, 3),
            "status": status,
            "fields": {k: _field(v) for k, v in fields.items()},
            "start_ns": t0_ns, "end_ns": t1_ns,
            "thread": threading.get_ident() if thread is None else thread,
        }

    def finish(self, status: str = "ok") -> dict:
        # pauses that struck during the request land before it closes
        _file_gc_pauses()
        with self._lock:
            if self.finished:  # idempotent: first finish wins
                return self.to_dict_locked()
            root = self.interval(self.root_span_id, "", self.name,
                                 self.t0_ns, time.perf_counter_ns(), status,
                                 self.root_fields)
            self.spans = [self.interval(*s) if isinstance(s, tuple) else s
                          for s in self.spans]
            self.spans.append(root)
            self.finished = True
            return self.to_dict_locked()

    def to_dict_locked(self) -> dict:
        root = self.spans[-1] if self.finished else None
        return {
            "trace_id": self.trace_id,
            "root": self.name,
            "kind": self.kind,
            "op": self.op,
            "start_ms": round(self.start_ms, 3),
            "duration_ms": (root["duration_ms"] if root else None),
            "status": (root["status"] if root else "active"),
            "counters": dict(self.counters),
            "spans": list(self.spans),
        }


def span_tree(trace_dict: dict) -> dict:
    """Nest a completed trace's flat span list into the JSON tree the
    debug endpoint serves: each node carries its span plus `children`
    sorted by start time.  Orphans (a parent pruned by an export cap)
    attach to the root."""
    spans = sorted(trace_dict.get("spans", []),
                   key=lambda s: s.get("start_ms") or 0)
    nodes = {s["span_id"]: dict(s, children=[]) for s in spans}
    # the trace's own root is the parentless span named after the
    # trace; any other parentless span (stitching leftovers) attaches
    # under it like an orphan
    roots = [nodes[s["span_id"]] for s in spans if not s.get("parent_id")]
    root = next((n for n in roots
                 if n.get("name") == trace_dict.get("root")),
                roots[0] if roots else {"span_id": "", "name":
                                        trace_dict.get("root", ""),
                                        "children": []})
    for s in spans:
        node = nodes[s["span_id"]]
        if node is root:
            continue
        parent = nodes.get(s.get("parent_id") or "")
        (parent["children"] if parent is not None and parent is not node
         else root["children"]).append(node)
    out = {k: v for k, v in trace_dict.items() if k != "spans"}
    out["tree"] = root
    return out


def summarize(trace_dict: dict, top: int = 4) -> str:
    """Compact per-stage summary for the response header / slow log:
    total plus the longest direct children of the root, aggregated by
    span name."""
    spans = trace_dict.get("spans", [])
    roots = {s["span_id"] for s in spans if not s.get("parent_id")}
    by_name: dict[str, float] = {}
    for s in spans:
        if s.get("parent_id") in roots:
            by_name[s["name"]] = (by_name.get(s["name"], 0.0)
                                  + (s.get("duration_ms") or 0.0))
    parts = [f"total={trace_dict.get('duration_ms', 0):.1f}ms"]
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        parts.append(f"{name}={ms:.1f}ms")
    return ";".join(parts)


def export_payload(trace_dict: dict, limit: int = EXPORT_LIMIT) -> str:
    """Serialize a completed trace for the X-Trace-Export response
    header.  Header lines are size-capped, so over the limit the
    export degrades: span fields are dropped first, then the deepest
    spans (roots survive — the coordinator keeps the region's shape,
    losing only leaf detail), and an oversized counter bag is trimmed
    to its largest entries; `dropped_spans` / `dropped_counters`
    record the cuts.  Guaranteed to terminate and to return a blob
    within `limit` (the floor payload is constant-size)."""
    spans = trace_dict.get("spans", [])
    counters = trace_dict.get("counters", {})
    payload = {"spans": spans, "counters": counters}
    blob = json.dumps(payload, separators=(",", ":"))
    if len(blob) <= limit:
        return blob
    # counters first: a runaway bag (e.g. folded in from many
    # downstream hops) must not eat the whole span budget
    cblob = json.dumps(counters, separators=(",", ":"))
    if len(cblob) > limit // 2:
        kept: dict = {}
        size = 2
        for k, v in sorted(counters.items(),
                           key=lambda kv: -abs(kv[1])):
            entry = len(json.dumps({str(k): v},
                                   separators=(",", ":")))
            if size + entry > limit // 2:
                break
            kept[k] = v
            size += entry
        counters = dict(kept, dropped_counters=len(trace_dict.get(
            "counters", {})) - len(kept))
    slim = [dict(s, fields={}) for s in spans]
    by_id = {s["span_id"]: s for s in slim}

    def depth_of(s: dict) -> int:
        d, seen = 0, set()
        cur = s
        while cur.get("parent_id") in by_id and cur["span_id"] not in seen:
            seen.add(cur["span_id"])
            cur = by_id[cur["parent_id"]]
            d += 1
        return d

    depth = {s["span_id"]: depth_of(s) for s in slim}
    slim.sort(key=lambda s: depth[s["span_id"]])
    while slim:
        payload = {"spans": slim, "counters": counters,
                   "dropped_spans": len(spans) - len(slim)}
        blob = json.dumps(payload, separators=(",", ":"))
        if len(blob) <= limit:
            return blob
        # strictly-shrinking tail cut: empties on the last span rather
        # than spinning on an irreducible payload
        del slim[(len(slim) * 3) // 4:]
    return json.dumps({"spans": [], "counters": {},
                       "dropped_spans": len(spans)},
                      separators=(",", ":"))


def ingest_export(header_value: Optional[str]) -> None:
    """Fold a peer's X-Trace-Export header into the active trace,
    parented under the current span (the RPC span).  Malformed exports
    are dropped — stitching is best-effort observability, never a
    query failure."""
    if not header_value:
        return
    trace = _current_trace.get()
    if trace is None or trace.finished:
        return
    try:
        payload = json.loads(header_value)
        if isinstance(payload, dict):
            trace.import_remote(payload, _current_span_id.get())
    except Exception:  # noqa: BLE001 — observability must not fail RPCs
        logger.warning("dropping malformed trace export (%d bytes)",
                       len(header_value))


class TraceRecorder:
    """Process-wide trace sink: sampling decisions, the bounded ring of
    completed traces, and the slow-query log ([trace] config)."""

    def __init__(self) -> None:
        self.enabled = True
        self.ring_size = 256
        self.slow_threshold_s = 1.0
        self.sample_rate = 1.0
        # op traces get their OWN ring and knobs: a hot background op
        # (a WAL commit round per write group) must never evict query
        # traces, and background ops have very different "slow" scales
        self.op_ring_size = 256
        self.op_slow_threshold_s = 30.0
        self.op_sample_rate = 1.0
        self._ring: "OrderedDict[str, dict]" = OrderedDict()
        self._op_ring: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()
        self._rng = random.Random(0xACE)

    def configure(self, enabled: Optional[bool] = None,
                  ring_size: Optional[int] = None,
                  slow_threshold_s: Optional[float] = None,
                  sample_rate: Optional[float] = None,
                  op_ring_size: Optional[int] = None,
                  op_slow_threshold_s: Optional[float] = None,
                  op_sample_rate: Optional[float] = None) -> None:
        if enabled is not None:
            self.enabled = enabled
        if ring_size is not None:
            self.ring_size = max(1, ring_size)
        if slow_threshold_s is not None:
            self.slow_threshold_s = slow_threshold_s
        if sample_rate is not None:
            self.sample_rate = min(1.0, max(0.0, sample_rate))
        if op_ring_size is not None:
            self.op_ring_size = max(1, op_ring_size)
        if op_slow_threshold_s is not None:
            self.op_slow_threshold_s = op_slow_threshold_s
        if op_sample_rate is not None:
            self.op_sample_rate = min(1.0, max(0.0, op_sample_rate))

    def start(self, name: str, trace_id: Optional[str] = None,
              forced: bool = False, kind: str = "query", op: str = "",
              slow_threshold_s: Optional[float] = None,
              root_fields: Optional[dict] = None) -> Optional[Trace]:
        """A new active trace, or None when tracing is off / this
        request lost the sampling draw.  `forced` (an upstream
        coordinator already traced this request) bypasses sampling —
        a stitched trace must not lose limbs to a local coin flip.
        Op traces (kind="op") draw against `op_sample_rate`."""
        if not self.enabled:
            return None
        rate = self.op_sample_rate if kind == "op" else self.sample_rate
        if not forced and rate < 1.0:
            with self._lock:
                if self._rng.random() >= rate:
                    return None
        return Trace(trace_id or new_trace_id(), name, kind=kind, op=op,
                     slow_threshold_s=slow_threshold_s,
                     root_fields=root_fields)

    def finish(self, trace: Trace, status: str = "ok") -> dict:
        """Complete a trace into its ring; fires the slow log on
        threshold breach or a deadline-exceeded outcome.  Ops use
        their per-op threshold when one was set at start, else the
        recorder's op default."""
        d = trace.finish(status)
        if trace.slow_threshold_s is not None:
            thr = trace.slow_threshold_s
        elif trace.kind == "op":
            thr = self.op_slow_threshold_s
        else:
            thr = self.slow_threshold_s
        slow = (status == "timeout"
                or (d["duration_ms"] or 0) >= thr * 1e3)
        d["slow"] = slow
        ring, size = ((self._op_ring, self.op_ring_size)
                      if trace.kind == "op"
                      else (self._ring, self.ring_size))
        with self._lock:
            ring[trace.trace_id] = d
            ring.move_to_end(trace.trace_id)
            while len(ring) > size:
                ring.popitem(last=False)
        _TRACES_RECORDED.inc()
        if slow:
            (_SLOW_OPS if trace.kind == "op" else _SLOW_QUERIES).inc()
            what = (f"op {trace.op or d['root']}"
                    if trace.kind == "op" else "query")
            slow_logger.warning(
                "[trace] slow %s trace_id=%s root=%s status=%s %s "
                "counters=%s", what, trace.trace_id, d["root"], status,
                summarize(d), json.dumps(d["counters"], sort_keys=True))
        return d

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            d = self._ring.get(trace_id)
            return d if d is not None else self._op_ring.get(trace_id)

    def list(self, limit: int = 50, kind: str = "query",
             op: Optional[str] = None) -> list[dict]:
        """Newest-first summaries for GET /debug/traces.  `kind` picks
        the population: "query" (default), "op",
        or "all" (both rings merged by start time); `op` filters to
        one op name (implies kind="op")."""
        if op is not None:
            kind = "op"
        with self._lock:
            items = []
            if kind in ("all", "query"):
                items += list(self._ring.values())
            if kind in ("all", "op"):
                items += [d for d in self._op_ring.values()
                          if op is None or d.get("op") == op]
        items.sort(key=lambda d: d.get("start_ms") or 0)
        out = []
        for d in reversed(items[-max(0, limit):] if limit else items):
            out.append({"trace_id": d["trace_id"], "root": d["root"],
                        "kind": d.get("kind", "query"),
                        "op": d.get("op", ""),
                        "start_ms": d["start_ms"],
                        "duration_ms": d["duration_ms"],
                        "status": d["status"], "slow": d.get("slow"),
                        "spans": len(d["spans"])})
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._op_ring.clear()


recorder = TraceRecorder()


@contextlib.contextmanager
def trace_scope(trace: Optional[Trace]) -> Iterator[Optional[Trace]]:
    """Bind `trace` as the ambient trace (None = explicit no-trace
    scope).  Spans and trace_add() calls inside — including those in
    tasks and pool work spawned inside — attribute to it."""
    tok = _current_trace.set(trace)
    tok_span = _current_span_id.set(
        trace.root_span_id if trace is not None else "")
    try:
        yield trace
    finally:
        _current_trace.reset(tok)
        _current_span_id.reset(tok_span)


def trace_add(name: str, value: float = 1.0) -> None:
    """Attribute counted work to the active trace (no-op outside)."""
    trace = _current_trace.get()
    if trace is not None:
        trace.add(name, value)


# span_<name>_seconds, bound once per span name
_SPAN_HISTOGRAMS: dict = {}


def _span_histogram(name: str, buckets: Optional[tuple] = None):
    h = _SPAN_HISTOGRAMS.get(name)
    if h is None:
        kw = {} if buckets is None else {"buckets": buckets}
        h = registry.histogram(f"span_{name.replace('.', '_')}_seconds",
                               f"span {name} duration", **kw)
        _SPAN_HISTOGRAMS[name] = h
    return h


def _record(trace: Optional[Trace], histogram, name: str, t0_ns: int,
            t1_ns: int, status: str, fields: dict,
            span_id: Optional[str] = None, parent_id: str = "") -> None:
    """The one recording path of spans and intervals: the duration
    feeds `histogram` (None: none), and `trace`, if any, gets the
    interval under `parent_id` (default: the current span)."""
    if _gc_done:
        _file_gc_pauses()
    if histogram is not None:
        histogram.observe((t1_ns - t0_ns) / 1e9)
    if trace is not None and not trace.finished:
        parent_id = (parent_id or _current_span_id.get()
                     or trace.root_span_id)
        trace.record_interval(span_id, parent_id, name, t0_ns, t1_ns,
                              status, fields, threading.get_ident())


_SPAN_SERIES = object()


def record_interval(name: str, t0_ns: int, t1_ns: int,
                    histogram=_SPAN_SERIES, **fields) -> None:
    """Record an interval measured elsewhere — [t0_ns, t1_ns) of
    time.perf_counter_ns() — as a finished span: its seconds feed
    `histogram` (`span_<name>_seconds` unless a caller passes its own
    series, as a plan stage does, or None), and the ambient trace, when
    one is bound, records it under the current span."""
    if histogram is _SPAN_SERIES:
        histogram = _span_histogram(name)
    _record(_current_trace.get(), histogram, name, t0_ns, t1_ns, "ok",
            fields)


@contextlib.contextmanager
def span(name: str, buckets: Optional[tuple] = None, **fields) -> Iterator[None]:
    """Traced operation: logs enter/exit, observes a latency histogram
    (`buckets` overrides the default layout — pass
    metrics.WIDE_BUCKETS for long-running ops so compaction/flush
    don't flatten into +Inf), and records a tree span into the active
    trace when one is bound."""
    parent_path = _current_span.get()
    full = f"{parent_path}/{name}" if parent_path else name
    token = _current_span.set(full)
    trace = _current_trace.get()
    span_id = parent_id = ""
    tok_sid = None
    if trace is not None and not trace.finished:
        span_id = _new_span_id()
        parent_id = _current_span_id.get() or trace.root_span_id
        tok_sid = _current_span_id.set(span_id)
    histogram = _span_histogram(name, buckets)
    if logger.isEnabledFor(_LEVEL):
        logger.log(_LEVEL, "-> %s %s", full,
                   " ".join(f"{k}={v}" for k, v in fields.items()))
    ok = False
    t0 = time.perf_counter_ns()
    try:
        yield
        ok = True
    finally:
        t1 = time.perf_counter_ns()
        _current_span.reset(token)
        if tok_sid is not None:
            _current_span_id.reset(tok_sid)
        if logger.isEnabledFor(_LEVEL):
            if ok:
                logger.log(_LEVEL, "<- %s %.1fms", full, (t1 - t0) / 1e6)
            else:
                logger.log(_LEVEL, "<- %s FAILED after %.1fms", full,
                           (t1 - t0) / 1e6)
        # failures are observed too — failure-path tail latency matters
        _record(trace if span_id else None, histogram, name, t0, t1,
                "ok" if ok else "error", fields, span_id, parent_id)


# ---- garbage-collector pauses ----------------------------------------------
# A collection stops every thread of the process.  gc.callbacks run
# inside it, wherever it struck — possibly while that thread holds a
# trace's or a histogram's lock — so the callback only appends to a
# deque (atomic) and the next recorded interval files the pause
# (`_record`, `Trace.finish`).

_GC_PAUSE = _span_histogram("gc_pause")
_gc_start_ns = [0]
_gc_done: collections.deque = collections.deque()
_gc_users = 0
_gc_users_lock = threading.Lock()


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _gc_start_ns[0] = time.perf_counter_ns()
        return
    _gc_done.append((_gc_start_ns[0], time.perf_counter_ns(),
                     info["generation"], _current_trace.get(),
                     _current_span_id.get(), threading.get_ident()))


def _file_gc_pauses() -> None:
    while _gc_done:
        try:
            t0, t1, generation, trace, parent, thread = _gc_done.popleft()
        except IndexError:  # another thread filed the last one
            return
        _GC_PAUSE.observe((t1 - t0) / 1e9)
        if trace is not None and not trace.finished:
            trace.record_interval(None, parent or trace.root_span_id,
                                  "gc_pause", t0, t1, "ok",
                                  {"generation": generation}, thread)


def watch_gc_pauses() -> None:
    """Record every garbage collection of the process as a `gc_pause`
    interval (its generation as a field) until the matching
    unwatch_gc_pauses(); the callback is registered once however many
    engines are open."""
    global _gc_users
    with _gc_users_lock:
        _gc_users += 1
        if _gc_users == 1:
            gc.callbacks.append(_on_gc)


def unwatch_gc_pauses() -> None:
    """Release one watch_gc_pauses(); the last removes the callback."""
    global _gc_users
    with _gc_users_lock:
        if _gc_users == 0:
            return
        _gc_users -= 1
        if _gc_users == 0 and _on_gc in gc.callbacks:
            gc.callbacks.remove(_on_gc)
    _file_gc_pauses()


def _field(v):
    return v if isinstance(v, (str, int, float, bool, type(None))) else str(v)


@contextlib.contextmanager
def op_trace(op: str, slow_s: Optional[float] = None,
             **fields) -> Iterator[Optional[Trace]]:
    """Trace one background operation (compaction execute, memtable
    flush, WAL group-commit round, rollup roll pass, scrub pass,
    health-monitor round) as its own kind="op" trace tree in the
    recorder's op ring — with the same objstore/cache/rows/bytes
    attribution queries get, because every trace_add()/span() inside
    (including pool work, which inherits the contextvars) lands on the
    ambient trace this binds.

    If a trace is ALREADY ambient — a query-triggered flush inside the
    aggregate pushdown's pre-flush, a synchronous roll under a traced
    admin request — the operation records as a span of that trace
    instead of stealing the scope: the work is attributed to whoever
    caused it.

    `slow_s` overrides the recorder's op slow threshold for this op
    (a compaction's "slow" is minutes; a WAL fsync round's is
    seconds)."""
    if _current_trace.get() is not None:
        with span(op, **fields):
            yield None
        return
    trace = recorder.start(op, kind="op", op=op, slow_threshold_s=slow_s,
                           root_fields=fields)
    if trace is None:
        yield None
        return
    status = "ok"
    with trace_scope(trace):
        try:
            yield trace
        except BaseException:
            status = "error"
            raise
        finally:
            recorder.finish(trace, status=status)
