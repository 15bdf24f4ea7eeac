"""Minimal observability: a process-wide registry of counters, gauges
and histograms, a `span` context manager that times a named block, and
`trace_add`, which bumps a named counter.

Enough for the ported call sites; the JAX package's full tracing,
memory-ledger and device-profiler planes are not ported yet."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class Counter:
    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """A value that moves both ways (buffered rows, backlog bytes)."""

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v


class Histogram:
    """Count and sum of observations (no buckets)."""

    def __init__(self, name: str, help_text: str = ""):
        self.name = name
        self.help = help_text
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += v


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help_text: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_text)
            return m

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get(Gauge, name, help_text)

    def histogram(self, name: str, help_text: str = "") -> Histogram:
        return self._get(Histogram, name, help_text)

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._metrics.items())
        return {name: (m.sum if isinstance(m, Histogram) else m.value)
                for name, m in items}


registry = MetricsRegistry()


@contextmanager
def span(name: str, **_attrs):
    """Time a named block into the `span_seconds:<name>` histogram."""
    hist = registry.histogram(f"span_seconds:{name}",
                              f"wall seconds spent in {name}")
    t0 = time.perf_counter()
    try:
        yield
    finally:
        hist.observe(time.perf_counter() - t0)


def trace_add(name: str, n: float = 1) -> None:
    """Add `n` to the counter `name` (the JAX package adds it to the
    current trace; the port has no tracing plane yet)."""
    registry.counter(name).inc(n)


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "span", "trace_add"]
