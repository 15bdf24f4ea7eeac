"""A traced run whose idle gaps are named by the program's own spans.

    python3 perfbench/spanclock.py --workload <name> --seed <n> \
        --seconds <s>

runs the cell as `perfbench/run.py ... --trace 1` does, and prints the
same result line, key for key.  Besides, each engine call of the
measured window binds one program trace (`horaedb_tpu_torch.utils.
tracing.Trace`, finished with `Trace.finish()`, so no ring or slow-log
line is written), and the window binds one of its own.  The program's spans carry their interval on
`time.perf_counter_ns()`, the host clock that the device trace's two
marker kernels place on the device's timeline (`perfbench/devtrace.py`),
so the run's `info` line on standard error gains:

- `idle_by_span`: the window's idle seconds (`window_s - busy_s`),
  split by the deepest program span open at each idle instant in each
  engine call then in flight (an instant shared by k calls gives each
  1/k; inside a call but no span of its own, the call's name).  An
  instant inside no engine call is labelled by what the window's own
  trace holds there — the harness's download of a result (`to_host`)
  or a `gc_pause` that struck outside a call — else `outside any
  engine call`.  The 10 largest labels, the rest as `other`, so the
  entries sum to the idle time;
- `idle_gaps_program`: the 10 longest gaps (those of
  `breakdown.idle_gaps`), each split the same way;
- `span_coverage`: over the window's engine calls, the median share of
  a call's wall that the union of its leaf spans (spans no other span
  names as its parent; `pool_queue` and `loop_resume` among them)
  covers."""

from __future__ import annotations

import contextlib
import heapq
import os
import statistics
import sys
import time
from collections import defaultdict
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the engine calls perfbench/loadgen.py drives (a traffic's `entry`)
ENGINE_CALLS = ("query_downsample", "query_downsample_multi")
OUTSIDE = "outside any engine call"
TOP = 10


@dataclass
class CallTrace:
    """One engine call's finished trace, kept as intervals."""

    name: str
    start_ns: int
    end_ns: int
    # (start_ns, end_ns, name, span_id, parent_id), the root left out
    spans: list


def call_trace(done: dict) -> CallTrace:
    root = done["spans"][-1]
    return CallTrace(
        root["name"], root["start_ns"], root["end_ns"],
        [(s["start_ns"], s["end_ns"], s["name"], s["span_id"],
          s["parent_id"]) for s in done["spans"][:-1] if "start_ns" in s])


def deepest_pieces(call: CallTrace) -> list:
    """The call's wall as pieces (start_ns, end_ns, label), each
    labelled by the shortest span open over it (the call's name where
    none is)."""
    spans = [(max(s, call.start_ns), min(e, call.end_ns), n)
             for s, e, n, _i, _p in call.spans]
    spans = sorted(sp for sp in spans if sp[1] > sp[0])
    bounds = sorted({call.start_ns, call.end_ns}
                    | {t for s, e, _n in spans for t in (s, e)})
    heap: list = []
    pieces: list = []
    j = 0
    for a, b in zip(bounds, bounds[1:]):
        while j < len(spans) and spans[j][0] <= a:
            s, e, n = spans[j]
            heapq.heappush(heap, (e - s, e, n))
            j += 1
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        label = heap[0][2] if heap else call.name
        if pieces and pieces[-1][2] == label and pieces[-1][1] == a:
            pieces[-1] = (pieces[-1][0], b, label)
        else:
            pieces.append((a, b, label))
    return pieces


def leaf_coverage(call: CallTrace) -> float:
    """The share of the call's wall covered by the union of its leaf
    spans."""
    wall = call.end_ns - call.start_ns
    if wall <= 0:
        return 0.0
    parents = {p for _s, _e, _n, _i, p in call.spans}
    leaves = sorted((max(s, call.start_ns), min(e, call.end_ns))
                    for s, e, _n, i, _p in call.spans if i not in parents)
    covered = 0
    cursor = call.start_ns
    for s, e in leaves:
        if e > cursor:
            covered += e - max(s, cursor)
            cursor = e
    return covered / wall


def idle_gaps(acts: list, host_marks: list) -> tuple:
    """(gaps, window_start): the idle gaps of the window between the two
    marker kernels, as `DeviceTrace.summarize` finds them, and the
    window's start, on the host's perf_counter_ns (placed through the
    first marker, as there)."""
    markers = [a for a in acts if "sleep" in a.name.lower()
               or "spin" in a.name.lower()]
    if len(markers) < 2:
        raise RuntimeError("the device trace holds no marker kernels")
    m0, m1 = markers[0], markers[-1]
    lo, hi = m0.end_ns, m1.start_ns
    offset = m0.start_ns - host_marks[0]
    gaps = []
    cursor = lo
    for a in acts:
        if a is m0 or a is m1 or a.end_ns <= lo or a.start_ns >= hi:
            continue
        s, e = max(a.start_ns, lo), min(a.end_ns, hi)
        if s > cursor:
            gaps.append((cursor - offset, s - offset))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor - offset, hi - offset))
    return gaps, lo - offset


# sweep events: (time, kind, index, label); at one instant every end
# (even kinds) goes before every start (odd kinds)
CALL_END, CALL_START, GAP_END, GAP_START, WINDOW_END, WINDOW_START = range(6)


def attribute(gaps: list, calls: list, window=None) -> list:
    """For each gap (start_ns, end_ns) on the host clock, its seconds
    split by label: {label: seconds}.  An instant shared by k calls in
    flight gives each call's deepest span 1/k of it; an instant with no
    call in flight takes the deepest span of `window` (a CallTrace of
    the window's own trace) there, else OUTSIDE."""
    events = []
    for c, call in enumerate(calls):
        for s, e, label in deepest_pieces(call):
            events.append((s, CALL_START, c, label))
            events.append((e, CALL_END, c, label))
    if window is not None:
        for s, e, label in deepest_pieces(window):
            if label != window.name:
                events.append((s, WINDOW_START, 0, label))
                events.append((e, WINDOW_END, 0, label))
    for g, (s, e) in enumerate(gaps):
        events.append((s, GAP_START, g, None))
        events.append((e, GAP_END, g, None))
    events.sort(key=lambda ev: (ev[0], ev[1] % 2))
    out = [defaultdict(float) for _ in gaps]
    active: dict = {}
    background = None
    gap = None
    last = None
    for t, kind, idx, label in events:
        if gap is not None and last is not None and t > last:
            d = (t - last) / 1e9
            if active:
                for lab in active.values():
                    out[gap][lab] += d / len(active)
            else:
                out[gap][background or OUTSIDE] += d
        last = t
        if kind == CALL_END:
            if active.get(idx) == label:
                del active[idx]
        elif kind == CALL_START:
            active[idx] = label
        elif kind == GAP_END:
            gap = None
        elif kind == GAP_START:
            gap = idx
        elif kind == WINDOW_END:
            background = None
        else:
            background = label
    return [dict(o) for o in out]


def summarize(gaps: list, calls: list, t_lo_ns: int, window=None) -> dict:
    """The three `info` keys from the window's gaps (host clock), its
    finished engine calls and its own trace; `t_lo_ns` is the window's
    start."""
    split = attribute(gaps, calls, window)
    total: dict = defaultdict(float)
    for g in split:
        for label, sec in g.items():
            total[label] += sec
    ranked = sorted(total.items(), key=lambda kv: -kv[1])
    by_span = [[label, sec] for label, sec in ranked[:TOP]]
    if len(ranked) > TOP:
        by_span.append(["other", sum(sec for _l, sec in ranked[TOP:])])
    longest = sorted(range(len(gaps)),
                     key=lambda i: gaps[i][0] - gaps[i][1])[:TOP]
    programmed = []
    for i in longest:
        parts = sorted(split[i].items(), key=lambda kv: -kv[1])
        label = ", ".join(f"{n} {sec:.3f}s" for n, sec in parts)
        programmed.append([f"{label} at {(gaps[i][0] - t_lo_ns) / 1e9:.3f}s",
                           (gaps[i][1] - gaps[i][0]) / 1e9])
    cover = [leaf_coverage(c) for c in calls]
    return {"idle_by_span": by_span, "idle_gaps_program": programmed,
            "span_coverage": statistics.median(cover) if cover else None}


def install(harness) -> dict:
    """Bind a program trace to each engine call of `harness`'s traced
    window, and one to the window itself (its client tasks inherit it,
    so a GC pause outside a call and the harness's other spans land
    there), and summarize the traces against the device trace; returns
    the dict the summary lands in (`run_cell` adds it to `info`)."""
    from horaedb_tpu_torch.utils import tracing

    found: dict = {}

    class ProgramSpans(harness.HostSpans):
        def __init__(self):
            super().__init__()
            self.calls: list = []

        @contextlib.contextmanager
        def span(self, name: str):
            with super().span(name):
                if name not in ENGINE_CALLS:
                    t0 = time.perf_counter_ns()
                    try:
                        yield
                    finally:
                        tracing.record_interval(
                            name, t0, time.perf_counter_ns(), None)
                    return
                trace = tracing.Trace(tracing.new_trace_id(), name)
                try:
                    with tracing.trace_scope(trace):
                        yield
                finally:
                    self.calls.append(call_trace(trace.finish()))

    class ProgramDeviceTrace(harness.DeviceTrace):
        # start() and stop() run in the harness's own task, around the
        # closed loop whose client tasks copy its context
        def start(self) -> None:
            self.window = tracing.Trace(tracing.new_trace_id(), "window")
            self.scope = tracing.trace_scope(self.window)
            self.scope.__enter__()
            super().start()

        def stop(self) -> None:
            super().stop()
            self.scope.__exit__(None, None, None)

        def summarize(self, spans, top: int = 10):
            out = super().summarize(spans, top)
            gaps, start = idle_gaps(self.activities(), self.host_marks)
            found.update(summarize(gaps, spans.calls, start,
                                   call_trace(self.window.finish())))
            return out

    run_cell = harness.run_cell

    def run_cell_with_spans(*args, **kwargs):
        run = run_cell(*args, **kwargs)
        run.info.update(found)
        return run

    harness.HostSpans = ProgramSpans
    harness.DeviceTrace = ProgramDeviceTrace
    harness.run_cell = run_cell_with_spans
    return found


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, ROOT)
    from perfbench import harness, run

    install(harness)
    return run.main(argv + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
