"""Minimal counters/histograms registry with Prometheus-style labels.

The reference has logging only (SURVEY.md section 5: "Our build should
add a minimal counters/histograms registry from day one since the
north-star metric is a latency").  Exposed by the server at /metrics in
Prometheus text format.

Labels: every metric is a *family*; `family.labels(table="cpu")`
returns a child series keyed by the sorted label set, rendered as
`name{table="cpu"} value`.  The family object itself doubles as the
label-less series (back-compat: call sites that never use labels are
unchanged), but once a family has children the bare series is only
rendered if it was actually touched — a purely-labeled family must not
scrape a phantom `name 0` line.
"""

from __future__ import annotations

import bisect
import random
import threading
from typing import Optional

_DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# long-running operations (compaction rewrites, memtable flushes, cold
# object-store scans): the default buckets top out at 10 s, which
# flattens everything slower into +Inf — these extend to 10 minutes
WIDE_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                10.0, 30.0, 60.0, 120.0, 300.0, 600.0)


def _escape(value: object) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _label_str(labels: tuple) -> str:
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in labels) + "}"


class _Family:
    """Shared label plumbing: child creation + series naming.  A child
    is a full metric instance of the same class with `_labels` set; it
    renders series lines only (HELP/TYPE come from the family)."""

    __slots__ = ()

    def _init_family(self, labels: tuple) -> None:
        self._labels = labels
        self._children: Optional[dict] = None
        self._touched = False

    def _series(self, suffix: str = "") -> str:
        if self._labels:
            return f"{self.name}{suffix}" + _label_str(self._labels)
        return f"{self.name}{suffix}"

    def labels(self, **kv):
        """Child series for this label set (created on first use).
        Children are cached — `family.labels(table="x")` is cheap enough
        for per-call use, but hot paths should bind the child once."""
        if not kv:
            return self
        assert not self._labels, "labels() on a labeled child"
        key = tuple(sorted(kv.items()))
        with self._lock:
            if self._children is None:
                self._children = {}
            child = self._children.get(key)
            if child is None:
                child = self._new_child(key)
                self._children[key] = child
            return child

    def _snapshot_children(self) -> list:
        with self._lock:
            return [] if not self._children else list(
                self._children.values())

    def remove(self, **kv) -> bool:
        """Deregister one labeled child so it stops rendering — the
        reload discipline for label values that name config-scoped
        entities (a tenant removed from [tenants] must not serve
        phantom series on /metrics forever).  Returns whether a child
        was actually removed."""
        if not kv:
            return False
        key = tuple(sorted(kv.items()))
        with self._lock:
            if not self._children:
                return False
            return self._children.pop(key, None) is not None

    def _render_base(self) -> bool:
        """Whether the label-less series line should be emitted: always
        for a never-labeled metric (back-compat), only-if-touched once
        labeled children exist."""
        return self._children is None or self._touched

    def _header(self, kind: str) -> list:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} {kind}"]

    def samples(self) -> list:
        """Family-wide scalar samples as (series_name, labels_dict,
        value) tuples — the meta-ingest scrape surface
        (metric_engine/meta.py).  Mirrors render(): the bare series
        only when it would render, then every labeled child."""
        out = []
        if self._render_base():
            out.extend(self._sample_points())
        for child in self._snapshot_children():
            out.extend(child._sample_points())
        return out


class Counter(_Family):
    __slots__ = ("name", "help", "_value", "_lock", "_labels", "_children",
                 "_touched")

    def __init__(self, name: str, help_: str = "", labels: tuple = ()):
        self.name = name
        self.help = help_
        self._value = 0.0
        self._lock = threading.Lock()
        self._init_family(labels)

    def _new_child(self, key: tuple) -> "Counter":
        return Counter(self.name, self.help, labels=key)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount
            self._touched = True

    @property
    def value(self) -> float:
        return self._value

    @property
    def total(self) -> float:
        """Family-wide sum: the bare series plus every labeled child."""
        return self._value + sum(c._value
                                 for c in self._snapshot_children())

    def _series_lines(self) -> list:
        return [f"{self._series()} {self._value}"]

    def _sample_points(self) -> list:
        return [(self.name, dict(self._labels), self._value)]

    def render(self) -> str:
        out = self._header("counter")
        if self._render_base():
            out += self._series_lines()
        for child in self._snapshot_children():
            out += child._series_lines()
        return "\n".join(out) + "\n"


class Gauge(_Family):
    """A value that goes up and down (queue depth, active queries,
    breaker state).  Rendered with the Prometheus `gauge` type."""

    __slots__ = ("name", "help", "_value", "_lock", "_labels", "_children",
                 "_touched")

    def __init__(self, name: str, help_: str = "", labels: tuple = ()):
        self.name = name
        self.help = help_
        self._value = 0.0
        self._lock = threading.Lock()
        self._init_family(labels)

    def _new_child(self, key: tuple) -> "Gauge":
        return Gauge(self.name, self.help, labels=key)

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value
            self._touched = True

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount
            self._touched = True

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount
            self._touched = True

    @property
    def value(self) -> float:
        return self._value

    def _series_lines(self) -> list:
        return [f"{self._series()} {self._value}"]

    def _sample_points(self) -> list:
        return [(self.name, dict(self._labels), self._value)]

    def render(self) -> str:
        out = self._header("gauge")
        if self._render_base():
            out += self._series_lines()
        for child in self._snapshot_children():
            out += child._series_lines()
        return "\n".join(out) + "\n"


_RESERVOIR_SIZE = 4096


class Histogram(_Family):
    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_count",
                 "_lock", "_samples", "_rng", "_labels", "_children",
                 "_touched")

    def __init__(self, name: str, help_: str = "",
                 buckets: tuple = _DEFAULT_BUCKETS, labels: tuple = ()):
        self.name = name
        self.help = help_
        self.buckets = buckets
        self._counts = [0] * (len(buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        # true reservoir sample (Vitter's algorithm R): every observation
        # has equal probability of being in the quantile sample, so
        # quantiles track steady state, not start-up
        self._samples: list[float] = []
        self._rng = random.Random(0x5EA)
        self._init_family(labels)

    def _new_child(self, key: tuple) -> "Histogram":
        # children share the family's bucket layout so the le= grid is
        # consistent across every series of the family
        return Histogram(self.name, self.help, self.buckets, labels=key)

    def observe(self, value: float) -> None:
        with self._lock:
            idx = bisect.bisect_left(self.buckets, value)
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            self._touched = True
            if len(self._samples) < _RESERVOIR_SIZE:
                self._samples.append(value)
            else:
                j = self._rng.randrange(self._count)
                if j < _RESERVOIR_SIZE:
                    self._samples[j] = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> Optional[float]:
        with self._lock:
            if not self._samples:
                return None
            s = sorted(self._samples)
            return s[min(len(s) - 1, int(q * len(s)))]

    def _series_lines(self) -> list:
        out = []
        acc = 0
        base = (_label_str(self._labels)[1:-1] + ","
                if self._labels else "")
        for b, c in zip(self.buckets, self._counts):
            acc += c
            out.append(f'{self.name}_bucket{{{base}le="{b}"}} {acc}')
        out.append(f'{self.name}_bucket{{{base}le="+Inf"}} {self._count}')
        out.append(f"{self._series('_sum')} {self._sum}")
        out.append(f"{self._series('_count')} {self._count}")
        return out

    def _sample_points(self) -> list:
        # sum + count only: rates and means are derivable, and the
        # bucket grid would multiply the scraped-series cardinality
        labels = dict(self._labels)
        return [(f"{self.name}_sum", labels, self._sum),
                (f"{self.name}_count", dict(labels), self._count)]

    def render(self) -> str:
        out = self._header("histogram")
        if self._render_base():
            out += self._series_lines()
        for child in self._snapshot_children():
            out += child._series_lines()
        return "\n".join(out) + "\n"


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Counter(name, help_)
                self._metrics[name] = m
            assert isinstance(m, Counter)
            return m

    def gauge(self, name: str, help_: str = "") -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Gauge(name, help_)
                self._metrics[name] = m
            assert isinstance(m, Gauge)
            return m

    def histogram(self, name: str, help_: str = "",
                  buckets: tuple = _DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help_, buckets)
                self._metrics[name] = m
            assert isinstance(m, Histogram)
            return m

    def family(self, name: str):
        """The registered family for `name`, or None — the typed
        factories (counter/gauge/histogram) create; this only looks
        up (label-child removal at config reload must not mint a
        family of the wrong type as a side effect)."""
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        # snapshot the metric list under the registry lock, render
        # OUTSIDE it (each metric takes its own lock) — a scrape must
        # never serialize against metric registration — and sort by
        # name so scrapes are stable/diffable
        with self._lock:
            metrics = sorted(self._metrics.items())
        return "".join(m.render() for _name, m in metrics)

    def samples(self) -> list:
        """Every family's scalar samples as (series_name, labels_dict,
        value), sorted by family name — the meta-ingest scrape
        snapshot.  Same lock discipline as render(): snapshot the
        metric list under the registry lock, sample outside it."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out = []
        for _name, m in metrics:
            out.extend(m.samples())
        return out

    def snapshot(self) -> dict:
        """Every series' current value keyed by its rendered name
        (`name` or `name{k="v",...}`); a histogram's value is its sum.
        Callers diff two snapshots to read what a run added."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out = {}
        for _name, m in metrics:
            series = ([m] if m._render_base() else []) + \
                m._snapshot_children()
            for s in series:
                out[s._series()] = (s.sum if isinstance(s, Histogram)
                                    else s.value)
        return out


registry = MetricsRegistry()
