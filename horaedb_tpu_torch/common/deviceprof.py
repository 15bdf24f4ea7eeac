"""Device-plane profiler: kernel builds, launch seams, device time and
transfer accounting (PyTorch port).

Counterpart of horaedb_tpu/common/deviceprof.py.  The JAX package wraps
every `jax.jit` seam and keeps an XLA compile ledger; the port has no
tracing compiler, so its seams are the calls that put work on the card:

  what was built?  the nvcc build of a kernel library (ops/nvcc.py),
                   counted once per source hash with its wall seconds,
                   under device_compiles_total{fn="nvcc:<source>"}
  where did the wall go?  per-seam host dispatch seconds (the wrapper's
                   own wall) and DEVICE seconds from a pair of CUDA
                   events recorded around the call on the tensors'
                   stream.  The events are resolved only when they have
                   completed (Event.query), at the next download seam or
                   at snapshot time: the profiler adds no device sync
                   (only the syncs the path already makes resolve them)
  how many kernels?  per-seam launch counts, reported by each kernel's
                   wrapper where it launches (note_launch)
  what moved?      device_transfer_bytes_total{direction=h2d|d2h}
                   charged at the upload and download seams, with
                   per-trace twins

A query trace's stage counters are HOST walls that do not overlap, as
the JAX package's are, so their sum is the share of a stage's wall the
ledger explains: stage_device_dispatch_ms is charged by the outermost
seam of a thread only (a seam called inside another seam's body keeps
its own ledger row, but its wall is already inside the outer one's);
stage_device_exec_ms is the wall a path spends waiting on the device
at a sync it makes anyway (observe_wait; downloads inside that span
charge their bytes untimed); transfer seconds are the upload and
download walls.  The event pairs' device seconds, which overlap those
host walls, go to the seam's ledger row and to the trace's
device_exec_ms twin, not to a stage counter.

A seam keys each call by the shapes and dtypes of its tensors plus the
values of its declared static arguments (the grid geometry a kernel is
shaped by).  A burst of NEW distinct keys of one seam inside the sliding
window is a storm, flagged once per episode watchdog-style
(device_recompile_storms_total{fn=} and a slow-log line naming the
churning key dimension): the shape churn that would recompile an XLA
program is what makes capacity padding worth its bytes here too.

The profiler also keeps the mesh ROUND timeline: per-round slot fill,
padding-waste rows and per-shard row imbalance, served with the seam
table and the transfer totals on `GET /debug/device`.

Process-global, with the clear-on-close discipline: `profiler.clear()`
at engine close removes every labelled child and resets every record;
the seams stay registered (they wrap module-level functions).
"""

from __future__ import annotations

import functools
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from horaedb_tpu_torch.utils.metrics import registry
from horaedb_tpu_torch.utils.tracing import trace_add

logger = logging.getLogger(__name__)
# storms land next to slow queries and watchdog stalls: one stream an
# operator greps for "the system is not keeping up" events
slow_logger = logging.getLogger("horaedb_tpu_torch.trace.slow")

_COMPILES = registry.counter(
    "device_compiles_total",
    "nvcc builds of a kernel library, once per source hash "
    "(fn=\"nvcc:<source>\")")
_COMPILE_SECONDS = registry.counter(
    "device_compile_seconds_total",
    "cumulative nvcc wall seconds per kernel library")
_STORMS = registry.counter(
    "device_recompile_storms_total",
    "new-call-key storm episodes per seam (storm_threshold new distinct "
    "shape keys inside the [deviceprof] sliding window, flagged once per "
    "episode)")
_DISPATCHES = registry.counter(
    "device_dispatches_total", "calls per device seam")
_LAUNCHES = registry.counter(
    "device_launches_total",
    "CUDA kernel launches per seam, reported where the kernel launches")
_DISPATCH_SECONDS = registry.histogram(
    "device_dispatch_seconds",
    "host wall per seam call (argument checks, launch enqueue)")
_EXEC_SECONDS = registry.histogram(
    "device_exec_seconds",
    "device seconds per seam call from CUDA events")
_TRANSFER_BYTES = registry.counter(
    "device_transfer_bytes_total",
    "bytes moved across the host/device boundary at the upload and "
    "download seams, by direction (h2d|d2h)")
_TRANSFER_SECONDS = registry.counter(
    "device_transfer_seconds_total",
    "wall seconds spent in instrumented host/device transfers, by "
    "direction (h2d|d2h; async uploads charge the enqueue wall)")

# seam nesting depth per thread: only the outermost seam charges the
# trace's dispatch wall
_nesting = threading.local()

# CUDA event pairs waiting for their stream to pass them; beyond this
# many the oldest are dropped unresolved (counted in the snapshot)
_MAX_PENDING_EVENTS = 8192


def _leaf_key(label: str, x: Any, out: list) -> None:
    """Flatten one tensor-carrying argument into labelled key
    components: tensors and arrays contribute (label.shape, label.dtype,
    label.device); containers recurse with indexed labels; other leaves
    contribute nothing (only declared static arguments key by value)."""
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        out.append((f"{label}.shape", tuple(x.shape)))
        out.append((f"{label}.dtype", str(x.dtype)))
        dev = getattr(x, "device", None)
        if dev is not None:
            out.append((f"{label}.device", str(dev)))
    elif isinstance(x, (tuple, list)):
        for j, v in enumerate(x):
            _leaf_key(f"{label}[{j}]", v, out)
    elif isinstance(x, dict):
        for k in sorted(x):
            _leaf_key(f"{label}.{k}", x[k], out)


def _call_key(args: tuple, kwargs: dict, static: tuple) -> tuple:
    out: list = []
    for i, a in enumerate(args):
        _leaf_key(f"a{i}", a, out)
    for k in sorted(kwargs):
        if k in static:
            out.append((k, repr(kwargs[k])))
        else:
            _leaf_key(k, kwargs[k], out)
    return tuple(out)


def _cuda_device(x: Any, depth: int = 0):
    """The device of the first CUDA tensor in an argument tree (a mesh
    program's ShardedArray blocks included), or None."""
    dev = getattr(x, "device", None)
    if dev is not None and getattr(dev, "type", None) == "cuda":
        return dev
    if depth < 2:
        blocks = getattr(x, "blocks", None)
        if isinstance(blocks, list):
            x = blocks
        if isinstance(x, (tuple, list)):
            for v in x:
                d = _cuda_device(v, depth + 1)
                if d is not None:
                    return d
        elif isinstance(x, dict):
            for v in x.values():
                d = _cuda_device(v, depth + 1)
                if d is not None:
                    return d
    return None


class FnRecord:
    """One seam's (or one kernel library build's) ledger entry.  Scalar
    fields are written under the profiler lock; the record lives for the
    process (clear() resets its state, never its identity)."""

    __slots__ = ("name", "compiles", "compile_seconds", "last_compile_s",
                 "last_key", "dispatches", "dispatch_seconds", "launches",
                 "execs", "exec_seconds", "new_keys", "storms",
                 "storm_active", "_window", "_churn", "_prev_key", "_keys",
                 "_series")

    def __init__(self, name: str) -> None:
        self.name = name
        self._keys: set = set()
        self.reset()

    def reset(self) -> None:
        self.compiles = 0
        self.compile_seconds = 0.0
        self.last_compile_s = 0.0
        self.last_key: Optional[tuple] = None
        self.dispatches = 0
        self.dispatch_seconds = 0.0
        self.launches = 0
        self.execs = 0
        self.exec_seconds = 0.0
        self.new_keys = 0
        self.storms = 0
        self.storm_active = False
        self._window: deque = deque()
        self._churn: dict = {}
        self._prev_key: Optional[tuple] = None
        # the seam's labelled dispatch series, looked up once (clear()
        # removes them from their families, so they are dropped here)
        self._series = None
        # the distinct keys seen survive clear(): a key that was new
        # once is not new again after an engine close (the JAX
        # package's compile detection keeps jit's cache the same way)

    def snapshot(self) -> dict:
        return {
            "fn": self.name,
            "compiles": self.compiles,
            "compile_seconds": round(self.compile_seconds, 6),
            "last_compile_ms": round(self.last_compile_s * 1e3, 3),
            "last_key": (None if self.last_key is None
                         else {k: repr(v) for k, v in self.last_key}),
            "dispatches": self.dispatches,
            "dispatch_seconds": round(self.dispatch_seconds, 6),
            "launches": self.launches,
            "execs": self.execs,
            "exec_seconds": round(self.exec_seconds, 6),
            "exec_ms": round(self.exec_seconds * 1e3, 6),
            "distinct_keys": len(self._keys),
            "new_keys": self.new_keys,
            "storms": self.storms,
            "storm_active": self.storm_active,
        }


class Seam:
    """The callable `deviceprof.seam` returns: the wrapped function,
    with the ledger on top while the profiler is enabled and a plain
    pass-through while it is not."""

    def __init__(self, owner: "DeviceProfiler", fn: Callable, name: str,
                 static: tuple) -> None:
        self._fn = fn
        self._name = name
        self._static = static
        self._owner = owner
        self._rec = owner._record(name)
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        if not self._owner.enabled:
            return self._fn(*args, **kwargs)
        return self._owner._profiled_call(self._rec, self._fn,
                                          self._static, args, kwargs)

    def __repr__(self) -> str:
        return f"<deviceprof.seam {self._name}>"


class DeviceProfiler:
    """Process-global device-plane registry ([deviceprof] config)."""

    def __init__(self, clock=time.monotonic) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._recs: dict[str, FnRecord] = {}
        self.enabled = True
        # storm = storm_threshold new keys of ONE seam inside
        # storm_window_s (per-episode flag, watchdog-style)
        self.storm_window_s = 60.0
        self.storm_threshold = 5
        self.rounds_kept = 256
        self._rounds: deque = deque(maxlen=self.rounds_kept)
        self._pending: deque = deque()
        self._dropped_events = 0
        self.transfer = {"h2d": {"bytes": 0, "seconds": 0.0, "count": 0},
                         "d2h": {"bytes": 0, "seconds": 0.0, "count": 0}}

    def configure(self, enabled: Optional[bool] = None,
                  storm_window_s: Optional[float] = None,
                  storm_threshold: Optional[int] = None,
                  rounds_kept: Optional[int] = None) -> None:
        if enabled is not None:
            self.enabled = enabled
        if storm_window_s is not None:
            self.storm_window_s = max(0.1, storm_window_s)
        if storm_threshold is not None:
            self.storm_threshold = max(2, int(storm_threshold))
        if rounds_kept is not None and rounds_kept != self.rounds_kept:
            self.rounds_kept = max(1, int(rounds_kept))
            with self._lock:
                self._rounds = deque(self._rounds,
                                     maxlen=self.rounds_kept)

    # ---- the seam -----------------------------------------------------------

    def seam(self, fn: Optional[Callable] = None, *,
             name: Optional[str] = None, static: tuple = ()):
        """Wrap a device seam.  Both house forms work:

          @deviceprof.seam(name="...", static=("num_groups",))
          deviceprof.seam(fn, name="...")

        `static` names the keyword arguments whose VALUES enter the call
        key (the grid geometry); every other non-tensor argument is a
        runtime value and stays out of it."""
        if fn is None:
            return lambda f: self.seam(f, name=name, static=static)
        fn_name = name or getattr(fn, "__name__", None) or repr(fn)
        return Seam(self, fn, fn_name, tuple(static))

    def _record(self, name: str) -> FnRecord:
        with self._lock:
            rec = self._recs.get(name)
            if rec is None:
                rec = FnRecord(name)
                self._recs[name] = rec
            return rec

    def _profiled_call(self, rec: FnRecord, fn, static: tuple, args,
                       kwargs):
        key = _call_key(args, kwargs, static)
        dev = _cuda_device(args) or _cuda_device(kwargs)
        depth = getattr(_nesting, "depth", 0)
        start = stream = None
        if dev is not None:
            import torch

            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        t0 = time.perf_counter()
        _nesting.depth = depth + 1
        try:
            out = fn(*args, **kwargs)
        finally:
            _nesting.depth = depth
        wall = time.perf_counter() - t0
        end = None
        if start is not None:
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
        with self._lock:
            rec.dispatches += 1
            rec.dispatch_seconds += wall
            new = key not in rec._keys
            if new:
                rec._keys.add(key)
            if end is not None:
                self._pending.append((rec, start, end, not depth))
                while len(self._pending) > _MAX_PENDING_EVENTS:
                    self._pending.popleft()
                    self._dropped_events += 1
        series = rec._series
        if series is None:
            series = rec._series = (_DISPATCHES.labels(fn=rec.name),
                                    _DISPATCH_SECONDS.labels(fn=rec.name))
        series[0].inc()
        series[1].observe(wall)
        if not depth:
            trace_add("stage_device_dispatch_ms", wall * 1e3)
        if new:
            self._note_new_key(rec, key)
        return out

    def _note_new_key(self, rec: FnRecord, key: tuple) -> None:
        now = self._clock()
        storm_fired = False
        churn_dim = None
        with self._lock:
            rec.new_keys += 1
            # the churn ledger: which key dimension differed from the
            # PREVIOUS new key — a storm names the most frequent one
            if rec._prev_key is not None:
                prev, cur = dict(rec._prev_key), dict(key)
                for k in set(prev) | set(cur):
                    if prev.get(k) != cur.get(k):
                        rec._churn[k] = rec._churn.get(k, 0) + 1
            rec._prev_key = key
            rec.last_key = key
            w = rec._window
            w.append(now)
            while w and w[0] < now - self.storm_window_s:
                w.popleft()
            if len(w) >= self.storm_threshold:
                if not rec.storm_active:
                    rec.storm_active = True  # one episode, one flag
                    rec.storms += 1
                    storm_fired = True
                    churn_dim = (max(rec._churn, key=rec._churn.get)
                                 if rec._churn else "(no key dimension)")
            elif rec.storm_active:
                rec.storm_active = False  # episode over; next is new
        if storm_fired:
            _STORMS.labels(fn=rec.name).inc()
            slow_logger.warning(
                "[deviceprof] call-key storm: fn=%s %d new keys within "
                "%.0fs (threshold %d), churning key dimension: %s — "
                "capacity padding should keep shapes stable", rec.name,
                len(rec._window), self.storm_window_s,
                self.storm_threshold, churn_dim)

    def note_launch(self, fn: str, n: int = 1) -> None:
        """A kernel wrapper's report of `n` launches, made where it
        launches (beside its own LAUNCHES counter)."""
        if not self.enabled:
            return
        rec = self._record(fn)
        with self._lock:
            rec.launches += n
        _LAUNCHES.labels(fn=fn).inc(n)

    def note_build(self, source: str, seconds: float) -> None:
        """One nvcc build of a kernel library (ops/nvcc.py), counted
        once per source hash: the port's counterpart of a compile."""
        name = f"nvcc:{os.path.basename(source)}"
        rec = self._record(name)
        with self._lock:
            rec.compiles += 1
            rec.compile_seconds += seconds
            rec.last_compile_s = seconds
        _COMPILES.labels(fn=name).inc()
        _COMPILE_SECONDS.labels(fn=name).inc(seconds)
        trace_add("stage_device_compile_ms", seconds * 1e3)

    def resolve(self) -> int:
        """Charge every pending event pair whose end has completed,
        oldest first, stopping at the first one still in flight (a
        stream completes its events in order).  Event.query() never
        blocks, so this adds no device sync.  Returns the pairs still
        pending."""
        done = []
        with self._lock:
            while self._pending:
                rec, start, end, outer = self._pending[0]
                if not end.query():
                    break
                self._pending.popleft()
                done.append((rec, start, end, outer))
            left = len(self._pending)
        for rec, start, end, outer in done:
            seconds = start.elapsed_time(end) / 1e3
            with self._lock:
                rec.execs += 1
                rec.exec_seconds += seconds
            _EXEC_SECONDS.labels(fn=rec.name).observe(seconds)
            if outer:
                trace_add("device_exec_ms", seconds * 1e3)
        return left

    # ---- the exec + transfer seams ----------------------------------------

    def observe_wait(self, seconds: float) -> None:
        """Charge the wall a path spent waiting on the device, at a sync
        it makes anyway (a mesh round's tail downloads), to the trace's
        stage_device_exec_ms: the host wall the JAX package's
        observe_exec charges there.  The work's device seconds are the
        seam's event pair's."""
        if self.enabled:
            trace_add("stage_device_exec_ms", seconds * 1e3)

    def device_put(self, x, device):
        """A numpy array or host tensor onto `device`, with h2d
        accounting (bytes + enqueue wall).  A CPU reader's "device" is
        host memory: its copies are charged alike, so the accounting is
        the same on every device."""
        import numpy as np
        import torch

        t0 = time.perf_counter()
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        out = x.to(device)
        self.charge_transfer("h2d", int(x.nbytes),
                             seconds=time.perf_counter() - t0)
        return out

    def download(self, t, timed: bool = True):
        """THE device-to-host seam: a tensor to a host numpy array, its
        bytes charged d2h (a CPU tensor's too, as device_put does).  The
        copy syncs the stream, so the pending event pairs it passed
        resolve here.  `timed=False` charges the bytes alone, for a
        download inside a span that observe_wait charges whole."""
        import numpy as np

        if isinstance(t, np.ndarray):
            return t
        t0 = time.perf_counter()
        out = t.detach().cpu().numpy()
        self.charge_transfer(
            "d2h", int(out.nbytes),
            seconds=time.perf_counter() - t0 if timed else 0.0)
        return out

    def charge_transfer(self, direction: str, nbytes: int,
                        seconds: float = 0.0) -> None:
        """Account one host/device transfer.  `direction` is h2d|d2h;
        a d2h charge also resolves the event pairs the copy's sync
        passed."""
        if not self.enabled or nbytes <= 0:
            return
        with self._lock:
            t = self.transfer[direction]
            t["bytes"] += int(nbytes)
            t["seconds"] += seconds
            t["count"] += 1
        _TRANSFER_BYTES.labels(direction=direction).inc(int(nbytes))
        if seconds:
            _TRANSFER_SECONDS.labels(direction=direction).inc(seconds)
        trace_add(f"device_{direction}_bytes", float(nbytes))
        if direction == "d2h" and self._pending:
            self.resolve()

    # ---- the mesh round timeline ------------------------------------------

    def record_round(self, kind: str, *, slots: int, capacity: int,
                     rows_per_shard: Optional[list] = None,
                     padding_rows: int = 0, upload_bytes: int = 0,
                     stack_hit: bool = False,
                     seconds: float = 0.0) -> None:
        """One mesh round's batching quality: how full the time axis
        was (`slots`/`capacity`), how many capacity-padding rows rode
        along dead, and how unevenly real rows landed per shard (max /
        mean — 1.0 is perfect balance)."""
        if not self.enabled:
            return
        rec = {
            "kind": kind,
            "slots": int(slots),
            "capacity": int(capacity),
            "fill_ratio": (round(slots / capacity, 4)
                           if capacity else None),
            "padding_rows": int(padding_rows),
            "upload_bytes": int(upload_bytes),
            "stack_hit": bool(stack_hit),
            "seconds": round(seconds, 6),
            "at": round(self._clock(), 3),
        }
        if rows_per_shard:
            rows = [int(r) for r in rows_per_shard]
            mean = sum(rows) / len(rows)
            rec["shard_rows"] = rows
            rec["row_imbalance"] = (round(max(rows) / mean, 4)
                                    if mean > 0 else None)
        with self._lock:
            self._rounds.append(rec)

    def rounds(self) -> list:
        with self._lock:
            return list(self._rounds)

    # ---- the /debug/device + /stats surface -------------------------------

    def records(self) -> list[FnRecord]:
        with self._lock:
            return list(self._recs.values())

    def snapshot(self) -> dict:
        """Full device-plane state (GET /debug/device): the seam table
        (builds, calls, launches, dispatch and device seconds, keys,
        storm state), transfer totals, and the mesh round timeline
        (newest last).  Event pairs already completed are resolved
        first; none is waited for."""
        pending = self.resolve() if self._pending else 0
        with self._lock:
            rounds = list(self._rounds)
            transfer = {d: dict(t) for d, t in self.transfer.items()}
            dropped = self._dropped_events
        for t in transfer.values():
            t["seconds"] = round(t["seconds"], 6)
        fns = sorted((r.snapshot() for r in self.records()),
                     key=lambda d: d["fn"])
        return {
            "enabled": self.enabled,
            "storm": {"window_s": self.storm_window_s,
                      "threshold": self.storm_threshold},
            "fns": fns,
            "transfer": transfer,
            "rounds": rounds,
            "events": {"pending": pending, "dropped": dropped},
        }

    def summary(self) -> dict:
        """Compact rollup for /stats: totals plus any seam currently in
        a storm episode."""
        if self._pending:
            self.resolve()
        recs = self.records()
        with self._lock:
            transfer = {d: t["bytes"] for d, t in self.transfer.items()}
        return {
            "fns": len(recs),
            "compiles": sum(r.compiles for r in recs),
            "compile_seconds": round(
                sum(r.compile_seconds for r in recs), 3),
            "dispatches": sum(r.dispatches for r in recs),
            "launches": sum(r.launches for r in recs),
            "exec_seconds": round(sum(r.exec_seconds for r in recs), 6),
            "storms": sorted(r.name for r in recs if r.storm_active),
            "transfer_bytes": transfer,
        }

    def clear(self) -> None:
        """Clear-on-close: reset every record and remove every labelled
        child so the families render empty — a closed engine serves no
        phantom device series.  Seams stay registered."""
        for rec in self.records():
            for fam in (_COMPILES, _COMPILE_SECONDS, _STORMS, _DISPATCHES,
                        _LAUNCHES, _DISPATCH_SECONDS, _EXEC_SECONDS):
                fam.remove(fn=rec.name)
            with self._lock:
                rec.reset()
        with self._lock:
            self._rounds.clear()
            self._pending.clear()
            self._dropped_events = 0
            for t in self.transfer.values():
                t["bytes"], t["seconds"], t["count"] = 0, 0.0, 0
        for d in ("h2d", "d2h"):
            _TRANSFER_BYTES.remove(direction=d)
            _TRANSFER_SECONDS.remove(direction=d)


profiler = DeviceProfiler()

# module-level aliases: call sites read `deviceprof.seam(...)`,
# `deviceprof.download(...)`
seam = profiler.seam
observe_wait = profiler.observe_wait
device_put = profiler.device_put
download = profiler.download
charge_transfer = profiler.charge_transfer
record_round = profiler.record_round
note_launch = profiler.note_launch
note_build = profiler.note_build
