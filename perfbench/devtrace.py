"""The device trace of a traced run, from `torch.profiler` with CUDA
activity only, and the harness's own host spans.

The profiler records the device's kernels, copies and sets; the
harness records its spans (the engine call in flight, the download of
its result) with the host's clock.  Two marker kernels, launched on an
idle device at the window's start and end, place the host's clock on
the device's timeline, so an idle gap can be labelled by what the host
was doing then.  Nothing here imports the program."""

from __future__ import annotations

import contextlib
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field

MARKER_CYCLES = 1000


@dataclass
class Activity:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    # the summed durations of every kernel, copy and set in the window
    device_s: float
    device_ops: list
    idle_gaps: list
    activities: int
    # the host clock against the device clock at the window's two ends
    clock_drift_us: float


class HostSpans:
    """Spans of the harness on the host clock (perf_counter_ns)."""

    def __init__(self):
        self.spans: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns()))


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.host_marks: list = []

    def _marker(self) -> None:
        import torch

        torch.cuda.synchronize(self.device)
        self.host_marks.append(time.perf_counter_ns())
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._marker()

    def stop(self) -> None:
        self._marker()
        self.prof.__exit__(None, None, None)

    def activities(self) -> list:
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = int(e.start_ns())
            out.append(Activity(e.name(), start,
                                start + int(e.duration_ns())))
        out.sort(key=lambda a: a.start_ns)
        return out

    def summarize(self, spans: HostSpans, top: int = 10) -> TraceSummary:
        acts = self.activities()
        markers = [a for a in acts if "sleep" in a.name.lower()
                   or "spin" in a.name.lower()]
        if len(markers) < 2:
            raise RuntimeError("the device trace holds no marker kernels: "
                               f"{sorted({a.name for a in acts})[:20]}")
        m0, m1 = markers[0], markers[-1]
        lo, hi = m0.end_ns, m1.start_ns
        offset0 = m0.start_ns - self.host_marks[0]
        offset1 = m1.start_ns - self.host_marks[-1]
        inside = [a for a in acts if a is not m0 and a is not m1
                  and a.end_ns > lo and a.start_ns < hi]
        by_name: dict = defaultdict(int)
        device_ns = 0
        for a in inside:
            d = min(a.end_ns, hi) - max(a.start_ns, lo)
            by_name[a.name] += d
            device_ns += d
        # the union of device activity, and the gaps between its pieces
        busy_ns = 0
        gaps = []
        cursor = lo
        for a in inside:
            s, e = max(a.start_ns, lo), min(a.end_ns, hi)
            if s > cursor:
                gaps.append((cursor, s))
            if e > cursor:
                busy_ns += e - max(s, cursor)
                cursor = e
        if hi > cursor:
            gaps.append((cursor, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        labelled = []
        for g0, g1 in gaps[:top]:
            mid_host = (g0 + g1) // 2 - offset0
            names = Counter(n for n, s, e in spans.spans
                            if s <= mid_host < e)
            label = ", ".join(f"{n} x{c}" for n, c in sorted(names.items())) \
                or "no harness span"
            labelled.append([f"{label} at {(g0 - lo) / 1e9:.3f}s",
                             (g1 - g0) / 1e9])
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return TraceSummary(
            window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9,
            device_s=device_ns / 1e9,
            device_ops=[[n, ns / 1e9] for n, ns in ops],
            idle_gaps=labelled, activities=len(inside),
            clock_drift_us=(offset1 - offset0) / 1e3)
