"""The PyTorch port's device profiler (horaedb_tpu_torch/common/
deviceprof.py) against tests/test_deviceprof.py's scenarios, on the
CPU: the seam ledger and its pass-through, new-call-key storms (the
port's counterpart of recompile storms), kernel-launch and nvcc-build
accounting, transfer accounting and the per-trace twins, the mesh round
timeline, clear-on-close, and the server's /debug/device, /stats and
[deviceprof] TOML.  The JAX package's lint tests are about jax.jit and
have no counterpart.

Where both packages take the same inputs (the round timeline, the storm
episodes, the TOML), the JAX package runs beside the port and the two
must agree.  On the CPU there are no CUDA events and so no device
seconds, and the cold-scan twin checks dispatch and transfer counters,
not stage_device_exec_ms."""

import asyncio
import contextlib
import logging
import os
import random

import numpy as np
import pyarrow as pa
import pytest
import torch

from horaedb_tpu.common.deviceprof import DeviceProfiler as RefProfiler
from horaedb_tpu_torch.common import ReadableDuration, deviceprof
from horaedb_tpu_torch.common import runtimes as runtimes_mod
from horaedb_tpu_torch.common.deviceprof import DeviceProfiler
from horaedb_tpu_torch.common.memledger import ledger as memledger
from horaedb_tpu_torch.metric_engine import MetricEngine
from horaedb_tpu_torch.objstore import MemoryObjectStore
from horaedb_tpu_torch.ops import bucket_agg, encode
from horaedb_tpu_torch.storage.config import (
    StorageConfig,
    ThreadsConfig,
    from_dict,
)
from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
from horaedb_tpu_torch.storage.storage import CloudObjectStorage, WriteRequest
from horaedb_tpu_torch.storage.types import TimeRange
from horaedb_tpu_torch.utils import tracing

T0 = 1_700_000_000_000
HOUR = 3_600_000
SEGMENT_MS = 3_600_000
SCHEMA = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                    ("v", pa.float64())])


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def own_trace_recorder(monkeypatch):
    """A fresh trace recorder per test: the process ring (and its
    sampling settings) stay as other test files left them."""
    monkeypatch.setattr(tracing, "recorder", tracing.TraceRecorder())


def _t(n, seed=0):
    return torch.arange(n, dtype=torch.float32) + seed


async def _open_device_storage(rt):
    cfg = from_dict(StorageConfig, {
        "scheduler": {"schedule_interval": "1h", "input_sst_min_num": 2},
        "scan": {"decode": {"mode": "device"}},
    })
    cfg.manifest.merge_interval = ReadableDuration.parse("1h")
    cfg.scrub.interval = ReadableDuration.parse("1h")
    return await CloudObjectStorage.open(
        "db", SEGMENT_MS, MemoryObjectStore(), SCHEMA, 2, cfg, runtimes=rt,
        device="cpu")


async def _write_segments(s, rng, segments=2, rows_per=200):
    for seg in range(segments):
        rows = [(f"k{rng.randint(0, 5)}",
                 seg * SEGMENT_MS + rng.randrange(0, SEGMENT_MS - 1000, 250),
                 float(rng.randint(0, 10**6))) for _ in range(rows_per)]
        k, t, v = zip(*rows)
        b = pa.record_batch(
            [pa.array(list(k)), pa.array(list(t), type=pa.int64()),
             pa.array(list(v), type=pa.float64())], schema=SCHEMA)
        await s.write(WriteRequest(b, TimeRange.new(min(t), max(t) + 1)))


def _clear_caches(s):
    s.reader.scan_cache.clear()
    s.reader.encoded_cache.clear()
    s.reader.parts_memo.clear()


def _agg_scan():
    spec = AggregateSpec(group_col="k", ts_col="ts", value_col="v",
                         range_start=0, bucket_ms=60_000, num_buckets=120,
                         which=("avg", "max"))
    return ScanRequest(range=TimeRange.new(0, 2 * SEGMENT_MS)), spec


@contextlib.contextmanager
def _parts_route():
    old = os.environ.get("HORAEDB_FUSED_AGG")
    os.environ["HORAEDB_FUSED_AGG"] = "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("HORAEDB_FUSED_AGG", None)
        else:
            os.environ["HORAEDB_FUSED_AGG"] = old


class TestSeamLedger:
    def test_calls_keys_and_static_values(self):
        prof = DeviceProfiler()
        f = prof.seam(lambda x, *, n: x[:n], name="unit_seam",
                      static=("n",))
        f(_t(8), n=3)
        f(_t(8, seed=1), n=3)  # same shapes and static value: no new key
        rec = prof._record("unit_seam")
        assert rec.dispatches == 2 and rec.new_keys == 1
        assert rec.dispatch_seconds > 0
        f(_t(16), n=3)  # new shape
        f(_t(16), n=5)  # new static value
        assert rec.new_keys == 3
        key = dict(rec.last_key)
        assert key["a0.shape"] == (16,) and key["n"] == "5"
        assert key["a0.dtype"] == "torch.float32"
        # runtime (non-static) scalars never enter the key
        g = prof.seam(lambda x, m: x * m, name="unit_runtime")
        g(_t(4), 2)
        g(_t(4), 3)
        assert prof._record("unit_runtime").new_keys == 1

    def test_nested_seam_charges_the_trace_once(self):
        """A seam called inside another seam's body keeps its own ledger
        row, but only the outermost seam charges the trace's dispatch
        wall (the inner walls are inside it), also after an outer seam
        raised."""
        prof = DeviceProfiler()
        inner = prof.seam(lambda x: x + 1, name="unit_inner")
        outer = prof.seam(lambda x: inner(inner(inner(x))),
                          name="unit_outer")

        def fail(x):
            inner(x)
            raise ValueError("boom")

        failing = prof.seam(fail, name="unit_failing")
        rin = prof._record("unit_inner")
        tracing.recorder.configure(enabled=True, sample_rate=1.0)
        trace = tracing.recorder.start("/query")
        with tracing.trace_scope(trace):
            outer(_t(8))
            with pytest.raises(ValueError):
                failing(_t(8))
            d0 = rin.dispatch_seconds
            inner(_t(8))
            top = rin.dispatch_seconds - d0
        tracing.recorder.finish(trace)
        assert rin.dispatches == 5
        # a seam that raised recorded no call; its inner one did
        assert prof._record("unit_failing").dispatches == 0
        outer_s = prof._record("unit_outer").dispatch_seconds
        assert trace.counters["stage_device_dispatch_ms"] == \
            pytest.approx((outer_s + top) * 1e3)

    def test_decorator_forms_register(self):
        prof = DeviceProfiler()

        @prof.seam
        def unit_bare(x):
            return x * 2

        @prof.seam(name="unit_named", static=("k",))
        def unit_static(x, k):
            return x[:k]

        unit_bare(_t(4))
        unit_static(_t(8), k=3)
        assert {"unit_bare", "unit_named"} <= {r.name for r in prof.records()}
        assert unit_bare.__name__ == "unit_bare"

    def test_disabled_profiler_is_passthrough(self):
        prof = DeviceProfiler()
        prof.configure(enabled=False)
        f = prof.seam(lambda x: x - 1, name="unit_disabled")
        out = f(_t(4))
        assert out.shape == (4,)
        rec = prof._record("unit_disabled")
        assert rec.dispatches == 0 and rec.new_keys == 0
        prof.note_launch("unit_disabled")
        prof.charge_transfer("h2d", 100)
        assert rec.launches == 0 and prof.transfer["h2d"]["bytes"] == 0

    def test_kernel_wrappers_are_seams(self):
        """The port's device entries are seams: the aggregate kernel's
        two entries and the k-way merge, each keyed by its grid
        geometry; on a CPU tensor the plain version runs and nothing
        counts as a launch."""
        from horaedb_tpu_torch.ops import merge

        for fn in (bucket_agg.bucket_window_partials,
                   bucket_agg.bucket_round_accumulate,
                   merge.kway_merge_perm):
            assert isinstance(fn, deviceprof.Seam), fn
        prof = deviceprof.profiler
        prof.clear()
        ts = torch.zeros((1, 128), dtype=torch.int32)
        gid = torch.zeros((1, 128), dtype=torch.int32)
        vals = torch.ones((1, 128), dtype=torch.float32)
        bucket_agg.bucket_window_partials(
            ts, gid, vals, None, None, None, 4, 1000, num_groups=8,
            width=4, which=("sum",), n_valid=100)
        rec = prof._record("bucket_window_partials")
        assert rec.dispatches == 1 and rec.launches == 0
        assert dict(rec.last_key)["num_groups"] == "8"
        assert "n_valid" not in dict(rec.last_key)
        prof.clear()

    def test_launch_and_build_accounting(self):
        prof = DeviceProfiler()
        prof.note_launch("unit_kernel")
        prof.note_launch("unit_kernel", 3)
        prof.note_build("/x/csrc/unit_kernel.cu", 2.5)
        snap = {f["fn"]: f for f in prof.snapshot()["fns"]}
        assert snap["unit_kernel"]["launches"] == 4
        assert snap["nvcc:unit_kernel.cu"]["compiles"] == 1
        assert snap["nvcc:unit_kernel.cu"]["compile_seconds"] == 2.5
        summ = prof.summary()
        assert summ["launches"] == 4 and summ["compiles"] == 1


class TestStorms:
    def _profs(self):
        t = [0.0]
        port = DeviceProfiler(clock=lambda: t[0])
        ref = RefProfiler(clock=lambda: t[0])
        for p in (port, ref):
            p.configure(storm_threshold=3, storm_window_s=60.0)
        return port, ref, t

    def test_storm_fires_once_per_episode(self, caplog):
        port, ref, t = self._profs()
        f = port.seam(lambda x: x * 2, name="unit_storm")
        rec = port._record("unit_storm")
        with caplog.at_level(logging.WARNING,
                             "horaedb_tpu_torch.trace.slow"):
            for n in range(3, 9):  # six shapes, six new keys, one window
                f(_t(n))
        assert rec.new_keys == 6
        assert rec.storms == 1 and rec.storm_active
        lines = [r.message for r in caplog.records
                 if "call-key storm" in r.message]
        assert len(lines) == 1
        assert "a0.shape" in lines[0] and "unit_storm" in lines[0]
        # the JAX package's ledger fires one episode for the same six
        # new shapes
        import jax.numpy as jnp

        g = ref.jit(lambda x: x * 2, name="unit_storm")
        for n in range(3, 9):
            g(jnp.zeros(n, jnp.float32))
        assert ref._record("unit_storm").storms == rec.storms

    def test_window_drain_starts_new_episode(self):
        port, _ref, t = self._profs()
        f = port.seam(lambda x: x * 3, name="unit_storm2")
        rec = port._record("unit_storm2")
        for n in range(3, 7):
            f(_t(n))
        assert rec.storms == 1
        t[0] = 1000.0  # the window drains; the episode is over
        for n in range(20, 24):
            f(_t(n))
        assert rec.storms == 2


class TestTransferAccounting:
    def test_device_put_and_download_charge(self):
        prof = deviceprof.profiler
        before = dict(prof.transfer["h2d"]), dict(prof.transfer["d2h"])
        t = deviceprof.device_put(np.zeros(1024, dtype=np.float32), "cpu")
        assert prof.transfer["h2d"]["bytes"] - before[0]["bytes"] == 4096
        out = deviceprof.download(t[:256])
        assert out.shape == (256,)
        assert prof.transfer["d2h"]["bytes"] - before[1]["bytes"] == 1024
        # a numpy array is already on the host: nothing moves
        deviceprof.download(out)
        assert prof.transfer["d2h"]["bytes"] - before[1]["bytes"] == 1024

    def test_to_device_charges_once(self):
        prof = deviceprof.profiler
        before = prof.transfer["h2d"]["bytes"]
        encode.to_device(np.zeros(100, dtype=np.int32), "cpu")
        assert prof.transfer["h2d"]["bytes"] - before == 400

    def test_charge_d2h_and_trace_twin(self):
        tracing.recorder.configure(enabled=True, sample_rate=1.0)
        trace = tracing.recorder.start("/query")
        with tracing.trace_scope(trace):
            deviceprof.charge_transfer("d2h", 2048)
        tracing.recorder.finish(trace)
        assert trace.counters.get("device_d2h_bytes") == 2048.0


class TestRoundTimeline:
    def test_record_round_quality_fields(self):
        port = DeviceProfiler(clock=lambda: 42.0)
        ref = RefProfiler(clock=lambda: 42.0)
        for p in (port, ref):
            p.record_round("mesh_run", slots=3, capacity=4,
                           rows_per_shard=[100, 50, 150],
                           padding_rows=212, upload_bytes=4096,
                           seconds=0.01)
        (r,) = port.snapshot()["rounds"]
        assert r == ref.snapshot()["rounds"][0]
        assert r["fill_ratio"] == 0.75 and r["row_imbalance"] == 1.5
        assert not r["stack_hit"]

    def test_rounds_ring_bounded(self):
        prof = DeviceProfiler()
        prof.configure(rounds_kept=4)
        for i in range(10):
            prof.record_round("mesh_run", slots=i, capacity=16)
        rounds = prof.snapshot()["rounds"]
        assert len(rounds) == 4 and rounds[-1]["slots"] == 9


class TestTraceTwins:
    def test_cold_scan_records_twins_memo_repeat_does_not(self):
        """A cold device-decode aggregate dispatches a kernel seam and
        moves bytes both ways, all on its trace; the identical repeat is
        memo-served and shows none."""
        async def go():
            rt = runtimes_mod.from_config(ThreadsConfig())
            s = await _open_device_storage(rt)
            try:
                await _write_segments(s, random.Random(7))
                _clear_caches(s)
                tracing.recorder.configure(enabled=True, sample_rate=1.0)

                async def traced_scan():
                    trace = tracing.recorder.start("/scan")
                    with tracing.trace_scope(trace):
                        await s.scan_aggregate(*_agg_scan())
                    tracing.recorder.finish(trace)
                    return {k: v for k, v in trace.counters.items()
                            if k in ("stage_device_dispatch_ms",
                                     "device_h2d_bytes",
                                     "device_d2h_bytes")}

                with _parts_route():
                    cold = await traced_scan()
                    assert "stage_device_dispatch_ms" in cold, cold
                    assert cold.get("device_h2d_bytes", 0) > 0, cold
                    assert cold.get("device_d2h_bytes", 0) > 0, cold
                    warm = await traced_scan()
                assert not warm, warm
            finally:
                await s.close()
                rt.close()

        run(go())


class TestClearOnClose:
    def test_clear_zeroes_families_and_state(self):
        prof = deviceprof.profiler
        f = prof.seam(lambda x: x + 7, name="unit_clear")
        f(_t(8))
        prof.note_launch("unit_clear")
        deviceprof.device_put(np.zeros(64, dtype=np.float32), "cpu")
        prof.record_round("mesh_run", slots=1, capacity=2)
        prof.clear()
        snap = prof.snapshot()
        for rec in snap["fns"]:
            assert rec["dispatches"] == 0 and rec["launches"] == 0, rec
        assert snap["rounds"] == []
        for d in ("h2d", "d2h"):
            assert snap["transfer"][d]["bytes"] == 0
        names = {r.name for r in prof.records()}
        for fam in (deviceprof._COMPILES, deviceprof._DISPATCHES,
                    deviceprof._LAUNCHES, deviceprof._STORMS):
            for _series, lbls, _val in fam.samples():
                assert lbls.get("fn") not in names, (lbls, names)
        assert deviceprof._TRANSFER_BYTES.samples() == []
        # a key seen before the clear is not new after it
        f(_t(8))
        rec = prof._record("unit_clear")
        assert rec.new_keys == 0 and rec.dispatches == 1
        prof.clear()

    def test_engine_close_clears_device_plane(self):
        async def go():
            rt = runtimes_mod.from_config(ThreadsConfig())
            s = await _open_device_storage(rt)
            try:
                await _write_segments(s, random.Random(11))
                _clear_caches(s)
                with _parts_route():
                    await s.scan_aggregate(*_agg_scan())
                assert any(r["dispatches"]
                           for r in deviceprof.profiler.snapshot()["fns"])
                assert deviceprof.profiler.transfer["h2d"]["bytes"] > 0
            finally:
                await s.close()
                rt.close()
            snap = deviceprof.profiler.snapshot()
            for rec in snap["fns"]:
                assert rec["dispatches"] == 0, rec
            assert snap["transfer"]["h2d"]["bytes"] == 0
            assert snap["transfer"]["d2h"]["bytes"] == 0
            assert memledger._device_high_water == {}

        run(go())


class TestServerSurface:
    def test_debug_device_and_stats_sections(self):
        from aiohttp.test_utils import TestClient, TestServer

        from horaedb_tpu_torch.server.config import ServerConfig
        from horaedb_tpu_torch.server.main import ServerState, build_app

        async def go():
            engine = await MetricEngine.open(
                "devsrv", MemoryObjectStore(), segment_ms=2 * HOUR,
                device="cpu")
            state = ServerState(engine, ServerConfig())
            client = TestClient(TestServer(build_app(state)))
            await client.start_server()
            try:
                r = await client.post("/write", json={"samples": [
                    {"name": "cpu", "labels": {"host": "h1"},
                     "timestamp": T0 + i * 1000, "value": float(i)}
                    for i in range(200)]})
                assert r.status == 200
                f = deviceprof.seam(lambda x: x * 2, name="unit_srv")
                f(_t(8))
                deviceprof.note_launch("unit_srv", 2)
                deviceprof.device_put(np.zeros(32, dtype=np.float32), "cpu")
                r = await client.post("/query", json={
                    "metric": "cpu", "filters": {}, "start": T0,
                    "end": T0 + HOUR, "bucket_ms": 60_000})
                assert r.status == 200
                r = await client.get("/debug/device")
                assert r.status == 200
                body = await r.json()
                assert body["enabled"] is True
                assert body["storm"]["threshold"] >= 2
                fns = {x["fn"]: x for x in body["fns"]}
                assert fns["unit_srv"]["dispatches"] == 1
                assert fns["unit_srv"]["launches"] == 2
                assert fns["unit_srv"]["last_key"], fns["unit_srv"]
                assert "exec_ms" in fns["unit_srv"]
                assert fns["bucket_round_accumulate"]["dispatches"] >= 1 \
                    or fns["bucket_window_partials"]["dispatches"] >= 1
                assert set(body["transfer"]) == {"h2d", "d2h"}
                assert {"rounds", "devices", "events"} <= set(body)
                r = await client.get("/stats")
                dp = (await r.json())["deviceprof"]
                assert dp["fns"] >= 1 and dp["launches"] >= 2
                assert "transfer_bytes" in dp
                r = await client.get("/metrics")
                text = await r.text()
                assert "device_dispatches_total" in text
                assert "device_launches_total" in text
            finally:
                await client.close()
                await engine.close()

        run(go())

    def test_deviceprof_config_toml_applied(self, tmp_path):
        """[deviceprof] loads as the JAX package loads it, and the
        server's start applies it to the process profiler."""
        from horaedb_tpu.server.config import load_config as ref_load
        from horaedb_tpu_torch.server import main as port_main
        from horaedb_tpu_torch.server.config import load_config

        p = tmp_path / "cfg.toml"
        p.write_text(
            "[deviceprof]\n"
            "enabled = false\n"
            'storm_window = "30s"\n'
            "storm_threshold = 4\n"
            "rounds = 64\n")
        cfg = load_config(str(p))
        ref = ref_load(str(p))
        for k in ("enabled", "storm_threshold", "rounds"):
            assert getattr(cfg.deviceprof, k) == getattr(ref.deviceprof, k)
        assert cfg.deviceprof.storm_window.seconds == 30.0
        bad = tmp_path / "bad.toml"
        bad.write_text("[deviceprof]\nstorm_threshold = 1\n")
        with pytest.raises(Exception, match="storm_threshold"):
            load_config(str(bad))

        prof = deviceprof.profiler
        saved = (prof.enabled, prof.storm_window_s, prof.storm_threshold,
                 prof.rounds_kept)

        async def go():
            engine = await MetricEngine.open(
                "devcfg", MemoryObjectStore(), segment_ms=2 * HOUR,
                device="cpu")
            state = port_main.ServerState(engine, cfg)
            try:
                port_main.build_app(state)
                return (prof.enabled, prof.storm_window_s,
                        prof.storm_threshold, prof.rounds_kept)
            finally:
                await engine.close()

        try:
            got = run(go())
        finally:
            prof.configure(enabled=saved[0], storm_window_s=saved[1],
                           storm_threshold=saved[2], rounds_kept=saved[3])
        assert got == (False, 30.0, 4, 64)
