"""The port's device decode (horaedb_tpu_torch/ops/device_decode.py and
its wiring in storage/read.py) against the JAX package's
(horaedb_tpu/ops/device_decode.py) on the same seeded inputs, all on the
CPU (the port's wrappers take their plain versions for CPU tensors; the
JAX package runs on its CPU backend, its Pallas kernel in interpret
mode):

- compile_leaves: the same program and constants, int32-edge
  tautologies and empty matches included;
- decode_rows_core on its three routes: keys_s, gid, val_s and n_rows
  equal;
- decode_aggregate against _decode_aggregate_jit (XLA, and once through
  pallas_window_partials): count/min/max/last/last_ts exact, sum within
  rtol 1e-5;
- the engine: port mode="device" against port mode="host" byte for
  byte, and against the JAX package's mode="device" (exact but sum/avg,
  rtol 1e-5) over seven aggregate sets and the Eq/In/range/absent
  predicates with cross-SST duplicates; fallback reasons and routing
  counters equal the reference's on the same writes; the decode mode's
  validation, env override and "auto" on a CPU reader; the sidecar's
  run bookkeeping."""

import asyncio
import random

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from horaedb_tpu.common import ReadableDuration as RefDuration
from horaedb_tpu.objstore import MemoryObjectStore as RefStore
from horaedb_tpu.ops import device_decode as ref_dd
from horaedb_tpu.ops import encode as ref_encode
from horaedb_tpu.ops import filter as RF
from horaedb_tpu.storage import sidecar as ref_sidecar
from horaedb_tpu.storage.config import StorageConfig as RefConfig
from horaedb_tpu.storage.config import from_dict as ref_from_dict
from horaedb_tpu.storage.read import AggregateSpec as RefSpec
from horaedb_tpu.storage.read import ScanRequest as RefRequest
from horaedb_tpu.storage.storage import CloudObjectStorage as RefStorage
from horaedb_tpu.storage.storage import WriteRequest as RefWrite
from horaedb_tpu.storage.types import TimeRange as RefRange
from horaedb_tpu_torch.common import ReadableDuration
from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.objstore import MemoryObjectStore
from horaedb_tpu_torch.ops import device_decode as dd
from horaedb_tpu_torch.ops import encode
from horaedb_tpu_torch.ops import filter as F
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.storage import sidecar
from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
from horaedb_tpu_torch.storage.read import AggregateSpec, ScanRequest
from horaedb_tpu_torch.storage.storage import CloudObjectStorage, WriteRequest
from horaedb_tpu_torch.storage.types import TimeRange

SEG = 3_600_000
SCHEMA = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                    ("v", pa.float64())])
WHICH_SETS = (("avg",), ("min", "max"), ("count",), ("sum", "avg"),
              ("last",), ("avg", "max", "last"), ALL_AGGS)
I32_LO, I32_HI = -(2**31), 2**31 - 1


# ---------------------------------------------------------------------------
# compile_leaves
# ---------------------------------------------------------------------------


def _encodings():
    """The same three columns encoded by both packages: a string dict, an
    epoch-offset timestamp and a raw int32 column."""
    cols = {"k": pa.array(["b", "d", "a", "d"]),
            "ts": pa.array([1_000, 5_000, 2_500, 9_000], type=pa.int64()),
            "n": pa.array([-7, 0, 3, 12], type=pa.int32())}
    port = {nm: encode.encode_column(c, nm)[1] for nm, c in cols.items()}
    ref = {nm: ref_encode.encode_column(c, nm)[1] for nm, c in cols.items()}
    return port, ref


LEAF_CASES = {
    "eq dict": [("Eq", "k", "b")],
    "eq absent": [("Eq", "k", "zz")],
    "in dict": [("In", "k", ["d", "a", "zz"])],
    "in absent": [("In", "k", ["x", "y"])],
    "dict thresholds": [("Lt", "k", "c"), ("Le", "k", "b"),
                        ("Gt", "k", "a"), ("Ge", "k", "b")],
    "offset thresholds": [("Lt", "ts", 4_000), ("Le", "ts", 5_000),
                          ("Gt", "ts", 1_000), ("Ge", "ts", 2_000)],
    "time range": [("TimeRangePred", "ts", 1_500, 8_000)],
    "numeric edges taut": [("Gt", "n", I32_LO - 5), ("Ge", "n", I32_LO - 1),
                           ("Lt", "n", I32_HI + 1), ("Le", "n", I32_HI + 9)],
    "numeric lt below range": [("Lt", "n", I32_LO - 1)],
    "numeric ge above range": [("Ge", "n", I32_HI + 1)],
    "numeric eq out of range": [("Eq", "n", 2**40)],
    "numeric range half taut": [("TimeRangePred", "n", I32_LO - 3, 4)],
    "numeric range both taut": [("TimeRangePred", "n", -(2**40), 2**40)],
    "numeric range empty": [("TimeRangePred", "n", 2**40, 2**41)],
    "numeric in range": [("Le", "n", 3), ("Gt", "n", -7)],
    "missing column": [("Eq", "nope", 1)],
}


def _leaf(mod, kind, col, *args):
    return getattr(mod, kind)(col, *args)


@pytest.mark.parametrize("name", list(LEAF_CASES))
def test_compile_leaves_matches_reference(name):
    port_enc, ref_enc = _encodings()
    spec = LEAF_CASES[name]

    def run(mod, comp, encs):
        try:
            prog, consts = comp([_leaf(mod, *s) for s in spec], encs)
            return prog, [c.tolist() for c in consts]
        except (ValueError, OverflowError) as e:
            return type(e).__name__
        except Exception as e:  # noqa: BLE001 — _EmptyMatch of each side
            return type(e).__name__

    want = run(RF, ref_dd.compile_leaves, ref_enc)
    got = run(F, dd.compile_leaves, port_enc)
    assert got == want
    for _prog, consts in ([got] if isinstance(got, tuple) else []):
        assert all(I32_LO <= c <= I32_HI for cs in consts for c in cs)


# ---------------------------------------------------------------------------
# decode_rows_core / decode_aggregate against the JAX functions
# ---------------------------------------------------------------------------

# columns of a synthetic segment: k (dict code), ts (offset), seq, v, n
KEY_SLOTS = (0, 1, 2)
CORE = dict(key_slots=KEY_SLOTS, num_pks=2, group_pos=0, val_slot=3)

LEAF_PROGS = {
    "none": ((), ()),
    "eq": (((0, dd._OP_EQ),), ([3],)),
    "lt le": (((1, dd._OP_LT), (1, dd._OP_LE)), ([90_000], [80_000])),
    "gt ge": (((1, dd._OP_GT), (0, dd._OP_GE)), ([4_000], [2])),
    "range": (((1, dd._OP_RANGE),), ([20_000, 70_000],)),
    "in": (((0, dd._OP_IN),), ([1, 4, 6],)),
    "leaf-only column": (((4, dd._OP_GE),), ([0],)),
}


def _segment(seed: int, runs: int, rows_per: int = 60, keys: int = 8):
    """`runs` SST runs, each sorted by (k, ts) with one seq per run (later
    runs newer), with duplicate (k, ts) across runs; padded to a
    capacity.  Returns (cols (5, cap) numpy, n, run_offsets, num_runs)."""
    rng = np.random.default_rng(seed)
    parts, lens = [], []
    for r in range(runs):
        m = int(rng.integers(rows_per // 2, rows_per))
        k = rng.integers(0, keys, m)
        ts = rng.integers(0, 25, m) * 4_000  # few ts: duplicates across runs
        order = np.lexsort((ts, k))
        k, ts = k[order], ts[order]
        # within one run the write path dedups (k, ts)
        keep = np.ones(m, bool)
        keep[1:] = (k[1:] != k[:-1]) | (ts[1:] != ts[:-1])
        k, ts = k[keep], ts[keep]
        m = len(k)
        v = rng.integers(-1000, 1000, m).astype(np.float32) / 8
        n_col = rng.integers(-3, 3, m)
        parts.append(np.stack([k, ts, np.full(m, r), v.view(np.int32),
                               n_col]).astype(np.int32))
        lens.append(m)
    n = sum(lens)
    cap = encode.pad_capacity(n)
    cols = np.zeros((5, cap), np.int32)
    cols[:, :n] = np.concatenate(parts, axis=1)
    num_runs = 1 << max(1, runs).bit_length()
    offs = np.full(num_runs + 1, cap, np.int32)
    offs[:runs + 1] = np.concatenate([[0], np.cumsum(lens)])
    offs[runs] = n
    return cols, n, offs, num_runs


def _port_cols(cols):
    out = [torch.from_numpy(c.copy()) for c in cols]
    out[3] = out[3].view(torch.float32)
    return tuple(out)


def _ref_cols(cols):
    out = [jnp.asarray(c) for c in cols]
    out[3] = jnp.asarray(cols[3].view(np.float32))
    return tuple(out)


@pytest.mark.parametrize("route", ["presorted", "kway", "sorted"])
@pytest.mark.parametrize("leaves", list(LEAF_PROGS))
def test_decode_rows_core_matches_reference(route, leaves):
    runs = 1 if route == "presorted" else 3
    cols, n, offs, num_runs = _segment(len(leaves) * 7 + len(route), runs)
    prog, consts = LEAF_PROGS[leaves]
    consts = [np.asarray(c, np.int32) for c in consts]
    if route != "kway":
        offs, num_runs = None, 0
    want = ref_dd.decode_rows_core(
        _ref_cols(cols), n, tuple(jnp.asarray(c) for c in consts),
        None if offs is None else jnp.asarray(offs), leaf_prog=prog,
        route=route, num_runs=num_runs, **CORE)
    got = dd.decode_rows_core(
        _port_cols(cols), n, tuple(torch.from_numpy(c) for c in consts),
        None if offs is None else torch.from_numpy(offs), leaf_prog=prog,
        route=route, num_runs=num_runs, **CORE)
    for w, g in zip(want[0], got[0]):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    assert got[1].numpy().tobytes() == np.asarray(want[1]).tobytes()
    assert got[2].numpy().tobytes() == np.asarray(want[2]).tobytes()
    assert int(got[3]) == int(want[3])
    if leaves == "none" and route != "presorted":
        assert int(got[3]) < n  # the duplicates across runs were dropped


def _compare_grids(got: dict, want: dict):
    want = {k: np.asarray(v) for k, v in want.items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k == "sum":
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)
        else:
            assert g.tobytes() == w.tobytes(), k


AGG = dict(shift=-12_000, lo=0, total=30, bucket_ms=4_000)


@pytest.mark.parametrize("route", ["presorted", "kway", "sorted"])
@pytest.mark.parametrize("which", [("avg",), ALL_AGGS],
                         ids=lambda w: "-".join(w))
def test_decode_aggregate_matches_reference(route, which):
    runs = 1 if route == "presorted" else 4
    cols, n, offs, num_runs = _segment(11 + len(route), runs)
    prog, consts = LEAF_PROGS["range"]
    consts = [np.asarray(c, np.int32) for c in consts]
    if route != "kway":
        offs, num_runs = None, 0
    kw = dict(key_slots=KEY_SLOTS, num_pks=2, group_pos=0, ts_pos=1,
              val_slot=3, leaf_prog=prog, g_pad=8, width=32,
              which=which, route=route, num_runs=num_runs)
    want, want_rows = ref_dd._decode_aggregate_jit(
        _ref_cols(cols), n, tuple(jnp.asarray(c) for c in consts),
        np.int32(AGG["shift"]), np.int32(AGG["lo"]), np.int32(AGG["total"]),
        np.int32(AGG["bucket_ms"]),
        jnp.int32(0) if offs is None else jnp.asarray(offs),
        use_pallas=False, **kw)
    got, got_rows = dd.decode_aggregate(
        _port_cols(cols), n, tuple(torch.from_numpy(c) for c in consts),
        AGG["shift"], AGG["lo"], AGG["total"], AGG["bucket_ms"],
        None if offs is None else torch.from_numpy(offs), **kw)
    _compare_grids(got, want)
    assert int(got_rows) == int(want_rows)


def test_decode_aggregate_matches_the_pallas_partials():
    """One case through pallas_window_partials (interpret mode on the
    CPU, as tests/test_pallas.py runs it)."""
    cols, n, offs, num_runs = _segment(23, 2)
    kw = dict(key_slots=KEY_SLOTS, num_pks=2, group_pos=0, ts_pos=1,
              val_slot=3, leaf_prog=(), g_pad=8, width=32,
              which=ALL_AGGS, route="kway", num_runs=num_runs)
    want, want_rows = ref_dd._decode_aggregate_jit(
        _ref_cols(cols), n, (), np.int32(AGG["shift"]), np.int32(3),
        np.int32(AGG["total"]), np.int32(AGG["bucket_ms"]),
        jnp.asarray(offs), use_pallas=True, **kw)
    got, got_rows = dd.decode_aggregate(
        _port_cols(cols), n, (), AGG["shift"], 3, AGG["total"],
        AGG["bucket_ms"], torch.from_numpy(offs), **kw)
    _compare_grids(got, want)
    assert int(got_rows) == int(want_rows)


# ---------------------------------------------------------------------------
# the engine: device against host, and against the JAX package
# ---------------------------------------------------------------------------


def _rows_batch(rows):
    k, t, v = zip(*rows)
    return pa.record_batch(
        [pa.array(list(k)), pa.array(list(t), type=pa.int64()),
         pa.array(list(v), type=pa.float64())], schema=SCHEMA)


async def _open_pair(**scan):
    sched = {"schedule_interval": "1h", "input_sst_min_num": 2}
    port_cfg = from_dict(StorageConfig, {"scheduler": sched, "scan": scan})
    port_cfg.manifest.merge_interval = ReadableDuration.parse("1h")
    port_cfg.scrub.interval = ReadableDuration.parse("1h")
    ref_cfg = ref_from_dict(RefConfig, {"scheduler": sched, "scan": scan})
    ref_cfg.manifest.merge_interval = RefDuration.parse("1h")
    ref_cfg.scrub.interval = RefDuration.parse("1h")
    port = await CloudObjectStorage.open("db", SEG, MemoryObjectStore(),
                                         SCHEMA, 2, port_cfg, device="cpu")
    ref = await RefStorage.open("db", SEG, RefStore(), SCHEMA, 2, ref_cfg)
    return port, ref


async def _write_both(port, ref, rows):
    lo, hi = min(r[1] for r in rows), max(r[1] for r in rows) + 1
    await port.write(WriteRequest(_rows_batch(rows), TimeRange.new(lo, hi)))
    await ref.write(RefWrite(_rows_batch(rows), RefRange.new(lo, hi)))


async def _write_segments(port, ref, rng, segments=2, rows_per=200, keys=6):
    for seg in range(segments):
        await _write_both(port, ref, [
            (f"k{rng.randint(0, keys - 1)}",
             seg * SEG + rng.randrange(0, SEG - 1000, 250),
             float(rng.randint(0, 10**6))) for _ in range(rows_per)])


def _clear(s):
    s.reader.scan_cache.clear()
    s.reader.parts_memo.clear()
    if hasattr(s.reader, "encoded_cache"):
        s.reader.encoded_cache.clear()


def _spec(mod, lo, hi, which, bucket_ms=60_000):
    return mod(group_col="k", ts_col="ts", value_col="v", range_start=lo,
               bucket_ms=bucket_ms,
               num_buckets=max(1, -(-(hi - lo) // bucket_ms)), which=which)


def _preds(mod):
    return {"none": None, "eq": mod.Eq("k", "k1"),
            "in": mod.In("k", ["k0", "k4"]),
            "range": mod.And((mod.Ge("ts", 1000), mod.Lt("ts", SEG))),
            "absent": mod.Eq("k", "nope")}


def _routing(mod):
    return (tuple(mod._SORT_SKIPPED[r].value
                  for r in ("compacted", "checked", "kway"))
            + (mod._SORT_RAN.value,))


def _decode_rows():
    return dd._STAGE_ROWS.value


@pytest.mark.parametrize("which", WHICH_SETS, ids=lambda w: "-".join(w))
def test_engine_device_matches_host_and_reference(monkeypatch, which):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")

    async def go():
        port, ref = await _open_pair(decode={"mode": "device"})
        try:
            rng = random.Random(1337)
            await _write_segments(port, ref, rng)
            # duplicate PKs across SSTs: the same keys written again
            await _write_both(port, ref, [("k0", 100, 7.0), ("k1", 350, 8.0)])
            await _write_both(port, ref, [("k0", 100, 9.0), ("k2", 600, 1.0)])
            r0 = _routing(dd)
            for name in _preds(F):
                lo, hi = 0, 2 * SEG
                req = ScanRequest(range=TimeRange.new(lo, hi),
                                  predicate=_preds(F)[name])
                spec = _spec(AggregateSpec, lo, hi, which)
                before = _decode_rows()
                _clear(port)
                port.config.scan.decode.mode = "device"
                dev = await port.scan_aggregate(req, spec)
                if name != "absent":
                    assert _decode_rows() > before, name
                _clear(port)
                port.config.scan.decode.mode = "host"
                after = _decode_rows()
                host = await port.scan_aggregate(req, spec)
                assert _decode_rows() == after  # the control stayed host
                assert np.array_equal(dev[0], host[0]), name
                assert sorted(dev[1]) == sorted(host[1]), name
                for k in dev[1]:
                    assert dev[1][k].tobytes() == host[1][k].tobytes(), \
                        f"{name}: {k}"
                _clear(ref)
                want = await ref.scan_aggregate(
                    RefRequest(range=RefRange.new(lo, hi),
                               predicate=_preds(RF)[name]),
                    _spec(RefSpec, lo, hi, which))
                assert np.array_equal(dev[0], want[0]), name
                assert sorted(dev[1]) == sorted(want[1]), name
                for k in want[1]:
                    w = np.asarray(want[1][k])
                    if k in ("sum", "avg"):
                        np.testing.assert_allclose(dev[1][k], w, rtol=1e-5,
                                                   err_msg=f"{name}: {k}")
                    else:
                        assert dev[1][k].tobytes() == w.tobytes(), \
                            f"{name}: {k}"
            # the cross-SST segment took the k-way merge on the card
            assert _routing(dd)[2] > r0[2]
            assert _routing(dd)[3] == r0[3]
        finally:
            await port.close()
            await ref.close()

    asyncio.run(go())


def test_fallback_reasons_and_routing_match_reference(monkeypatch):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")

    def counts():
        port = dd.fallback_counts()
        ref = {r: ref_dd._FALLBACK_CHILDREN[r].value for r in port}
        return port, ref, _routing(dd), _routing(ref_dd)

    def deltas(a, b):
        return ({r: b[0][r] - a[0][r] for r in a[0]},
                {r: b[1][r] - a[1][r] for r in a[1]},
                tuple(y - x for x, y in zip(a[2], b[2])),
                tuple(y - x for x, y in zip(a[3], b[3])))

    async def query_both(port, ref, pred=None):
        lo, hi = 0, SEG
        _clear(port)
        _clear(ref)
        await port.scan_aggregate(
            ScanRequest(range=TimeRange.new(lo, hi),
                        predicate=None if pred is None else pred(F)),
            _spec(AggregateSpec, lo, hi, ("avg",)))
        await ref.scan_aggregate(
            RefRequest(range=RefRange.new(lo, hi),
                       predicate=None if pred is None else pred(RF)),
            _spec(RefSpec, lo, hi, ("avg",)))

    async def go():
        seen = {}
        # one SST (compacted), then an interleaved second SST (kway), an
        # Or predicate and an oversized In (predicate), a tiny upload
        # budget (budget), and host mode (nothing counted)
        port, ref = await _open_pair(decode={"mode": "device"})
        try:
            rng = random.Random(7)
            await _write_segments(port, ref, rng, segments=1, rows_per=120)
            steps = [
                ("one sst", None, None),
                ("second sst", None, [("k0", 10, 1.0), ("k5", 20, 2.0)]),
                ("or", lambda m: m.Or((m.Eq("k", "k1"), m.Eq("k", "k2"))),
                 None),
                ("big in", lambda m: m.In("k", [f"x{i}" for i in range(200)]),
                 None),
            ]
            for name, pred, rows in steps:
                if rows:
                    await _write_both(port, ref, rows)
                c0 = counts()
                await query_both(port, ref, pred)
                seen[name] = deltas(c0, counts())
            for s in (port, ref):
                s.config.scan.decode.max_upload_bytes = 64
            c0 = counts()
            await query_both(port, ref)
            seen["budget"] = deltas(c0, counts())
            for s in (port, ref):
                s.config.scan.decode.max_upload_bytes = 256 << 20
                s.config.scan.decode.mode = "host"
            c0 = counts()
            await query_both(port, ref)
            seen["host"] = deltas(c0, counts())
        finally:
            await port.close()
            await ref.close()
        # sidecars off at the scan layer (no_sidecar), and missing
        # sidecar objects (parquet)
        for name, scan, sidecars in (("no sidecar", {"use_sidecar": False},
                                      True),
                                     ("parquet", {}, False)):
            port, ref = await _open_pair(decode={"mode": "device"}, **scan)
            try:
                for s in (port, ref):
                    s.config.write.enable_sidecar = sidecars
                await _write_segments(port, ref, random.Random(9),
                                      segments=1)
                c0 = counts()
                await query_both(port, ref)
                seen[name] = deltas(c0, counts())
            finally:
                await port.close()
                await ref.close()
        return seen

    seen = asyncio.run(go())
    for name, (port, ref, port_route, ref_route) in seen.items():
        assert port == ref, name
        assert port_route == ref_route, name
    assert seen["one sst"][2] == (1, 0, 0, 0)
    assert seen["second sst"][2] == (0, 0, 1, 0)
    assert seen["or"][0]["predicate"] == 1
    assert seen["big in"][0]["predicate"] == 1
    assert seen["budget"][0]["budget"] >= 1
    assert not any(seen["host"][0].values()) and not any(seen["host"][2])
    assert seen["no sidecar"][0]["no_sidecar"] == 1
    assert seen["parquet"][0]["parquet"] >= 1


# ---------------------------------------------------------------------------
# mode plumbing
# ---------------------------------------------------------------------------


async def _open_port(**scan):
    cfg = from_dict(StorageConfig, {"scheduler": {"schedule_interval": "1h"},
                                    "scan": scan})
    cfg.manifest.merge_interval = ReadableDuration.parse("1h")
    cfg.scrub.interval = ReadableDuration.parse("1h")
    return await CloudObjectStorage.open("db", SEG, MemoryObjectStore(),
                                         SCHEMA, 2, cfg, device="cpu")


def test_decode_config_toml():
    cfg = from_dict(StorageConfig, {
        "scan": {"decode": {"mode": "device", "max_upload_bytes": 1 << 20}}})
    assert cfg.scan.decode.mode == "device"
    assert cfg.scan.decode.max_upload_bytes == 1 << 20
    assert StorageConfig().scan.decode.mode == "auto"
    assert StorageConfig().scan.decode.max_upload_bytes == 256 << 20
    with pytest.raises(Error):
        from_dict(StorageConfig, {"scan": {"decode": {"mod": "x"}}})


def test_bad_decode_mode_rejected_at_open():
    async def go():
        with pytest.raises(Error, match="scan.decode"):
            await _open_port(decode={"mode": "gpu"})

    asyncio.run(go())


def test_env_force_overrides_config(monkeypatch):
    async def go():
        s = await _open_port(decode={"mode": "host"})
        try:
            monkeypatch.setenv("HORAEDB_DEVICE_DECODE", "1")
            assert s.reader._decode_mode() == "device"
            monkeypatch.setenv("HORAEDB_DEVICE_DECODE", "0")
            assert s.reader._decode_mode() == "host"
            monkeypatch.delenv("HORAEDB_DEVICE_DECODE")
            assert s.reader._decode_mode() == "host"
        finally:
            await s.close()

    asyncio.run(go())


def test_auto_on_a_cpu_reader_keeps_host_decode(monkeypatch):
    """"auto" engages only on a CUDA reader: on the CPU even a plan the
    fused gate declines takes host decode, and nothing is counted."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")

    async def go():
        s = await _open_port()
        try:
            await s.write(WriteRequest(_rows_batch(
                [("k0", 10, 1.0), ("k1", 20, 2.0)]), TimeRange.new(10, 21)))
            req = ScanRequest(range=TimeRange.new(0, SEG))
            plan = await s.build_scan_plan(req)
            assert s.config.scan.decode.mode == "auto"
            assert not s.reader.fused_aggregate_ok(plan)
            assert s.reader._device_decode_plan_ok(plan) is False
            before, falls = _decode_rows(), dd.fallback_counts()
            values, grids = await s.scan_aggregate(
                req, _spec(AggregateSpec, 0, SEG, ("avg",)))
            assert _decode_rows() == before
            assert dd.fallback_counts() == falls
            assert list(values) == ["k0", "k1"]
        finally:
            await s.close()

    asyncio.run(go())


def test_fused_gate_yields_to_forced_device_decode(monkeypatch):
    """HORAEDB_FUSED_AGG=1 keeps the fused path; without the force, mode
    "device" routes an eligible plan to the parts path, and "auto" on
    the CPU does not."""
    async def go():
        s = await _open_port(decode={"mode": "device"})
        try:
            await s.write(WriteRequest(_rows_batch(
                [("k0", 10, 1.0), ("k1", 20, 2.0)]), TimeRange.new(10, 21)))
            plan = await s.build_scan_plan(
                ScanRequest(range=TimeRange.new(0, SEG)))
            monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")
            assert s.reader.fused_aggregate_ok(plan) is True
            monkeypatch.delenv("HORAEDB_FUSED_AGG")
            assert s.reader.fused_aggregate_ok(plan) is False
            assert s.reader._device_decode_plan_ok(plan) is True
            s.config.scan.decode.mode = "auto"
            assert s.reader.fused_aggregate_ok(plan) is True
            s.config.scan.decode.mode = "host"
            assert s.reader._device_decode_plan_ok(plan) is False
        finally:
            await s.close()

    asyncio.run(go())


def test_device_parts_never_enter_the_scan_cache(monkeypatch):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")

    async def go():
        s = await _open_port(decode={"mode": "device"})
        try:
            await s.write(WriteRequest(_rows_batch(
                [("k0", 10, 1.0), ("k1", 20, 2.0)]), TimeRange.new(10, 21)))
            req = ScanRequest(range=TimeRange.new(0, SEG))
            spec = _spec(AggregateSpec, 0, SEG, ("avg",))
            before = _decode_rows()
            await s.scan_aggregate(req, spec)
            assert _decode_rows() == before + 2
            assert not list(s.reader.scan_cache.values())
            rows = [b async for b in s.scan(req)]  # the row scan: host
            assert sum(b.num_rows for b in rows) == 2
        finally:
            await s.close()

    asyncio.run(go())


# ---------------------------------------------------------------------------
# sidecar run bookkeeping
# ---------------------------------------------------------------------------


def _two_sidecars(mod, enc_mod):
    out = []
    for rows in ([("a", 1, 1.0), ("b", 2, 2.0), ("c", 3, 3.0)],
                 [("a", 4, 4.0), ("c", 5, 5.0)]):
        batch = _rows_batch(rows)
        cols = {nm: enc_mod.encode_column(c, nm) for nm, c in
                zip(batch.schema.names, batch.columns)}
        out.append((cols, batch.num_rows))
    return out


def test_assemble_and_deferred_leaves_keep_run_lengths():
    names = ["k", "ts", "v"]
    port_parts = _two_sidecars(sidecar, encode)
    ref_parts = _two_sidecars(ref_sidecar, ref_encode)
    got = sidecar.assemble_parts(port_parts, names, None)
    want = ref_sidecar.assemble_parts(ref_parts, names, None)
    assert (got.source_runs, got.run_lengths) == (2, (3, 2))
    assert (got.source_runs, got.run_lengths) == (want.source_runs,
                                                  want.run_lengths)
    got.pending_leaves = [F.In("k", ["a", "c"])]
    want.pending_leaves = [RF.In("k", ["a", "c"])]
    g, w = sidecar.apply_leaves_host(got), ref_sidecar.apply_leaves_host(want)
    assert (g.n, g.run_lengths, g.pending_leaves) == (4, (2, 2), None)
    assert (g.n, g.run_lengths) == (w.n, w.run_lengths)
    for nm in names:
        assert np.array_equal(g.columns[nm], w.columns[nm])
    # nothing pending: a no-op
    got.pending_leaves = []
    assert sidecar.apply_leaves_host(got) is got
    assert got.pending_leaves is None
    # the leaves applied at assemble count survivors per run too
    pruned = sidecar.assemble_parts(port_parts, names, [F.Eq("k", "a")])
    assert pruned.run_lengths == (1, 1) and pruned.n == 2
