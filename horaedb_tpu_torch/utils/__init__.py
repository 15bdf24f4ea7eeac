"""Minimal observability: a process-wide registry of counters and
histograms, and a `span` context manager that times a named block.

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

    def histogram(self, name: str, help_text: str = "") -> Histogram:
        return self._get(Histogram, name, help_text)

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._metrics.items())
        return {name: (m.value if isinstance(m, Counter) else m.sum)
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


__all__ = ["Counter", "Histogram", "MetricsRegistry", "registry", "span"]
