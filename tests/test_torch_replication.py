"""The PyTorch port's replication plane (the WAL's hooks in
wal/log.py, cluster/replication.py and cluster/placement.py) against
the JAX package's, on the CPU.

One WAL written by each package gives equal `segments()`, `read_tail`
bytes, `high_watermark`, `flushed_seq`, `verify_frames` and
`mirror_watermarks`; `truncate` honours `retention`.  A mirror shipped
by the port's follower replays in the JAX package and one shipped by
the JAX package's follower replays in the port.  Lease records are
byte-equal.  Then, on the port with the JAX package's outcomes beside
it: ship-and-promote after an in-process kill -9 (`abort()` of every
WAL-fronted table) with no acked write lost and grids byte-equal to a
single-copy control; the StandbyMonitor's election under an injected
ms clock and jitter RNG; the PlacementController; the
RebalanceExecutor's gates; and HttpWalSource against the port's server.
Every clock is injected: no test waits on wall time."""

import asyncio
import dataclasses
import itertools
import json
import os
import random
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest
from aiohttp.test_utils import TestServer

import horaedb_tpu.cluster as ref_cl
import horaedb_tpu.cluster.placement as ref_placement
import horaedb_tpu.cluster.replication as ref_repl
import horaedb_tpu.server.config as ref_cfg
import horaedb_tpu.server.main as ref_main
import horaedb_tpu.wal.log as ref_log
from horaedb_tpu.common import ReadableDuration as RefDuration
from horaedb_tpu.metric_engine import Label as RefLabel
from horaedb_tpu.metric_engine import MetricEngine as RefEngine
from horaedb_tpu.metric_engine import Sample as RefSample
from horaedb_tpu.objstore import MemoryObjectStore as RefStore
from horaedb_tpu.storage import sst as ref_sst
from horaedb_tpu.storage.types import TimeRange as RefRange
from horaedb_tpu.wal import WalConfig as RefWalConfig
import horaedb_tpu_torch.cluster as port_cl
import horaedb_tpu_torch.cluster.placement as port_placement
import horaedb_tpu_torch.cluster.replication as port_repl
import horaedb_tpu_torch.server.config as port_cfg
import horaedb_tpu_torch.server.main as port_main
import horaedb_tpu_torch.wal.log as port_log
from horaedb_tpu_torch.common import ReadableDuration
from horaedb_tpu_torch.metric_engine import Label, MetricEngine, Sample
from horaedb_tpu_torch.objstore import MemoryObjectStore
from horaedb_tpu_torch.storage import sst as port_sst
from horaedb_tpu_torch.storage.types import TimeRange
from horaedb_tpu_torch.wal import WalConfig

T0 = 1_700_000_000_000
HOUR = 3_600_000

REF = SimpleNamespace(log=ref_log, repl=ref_repl, cl=ref_cl,
                      placement=ref_placement, WalConfig=RefWalConfig,
                      dur=RefDuration, tr=RefRange, engine=RefEngine,
                      store=RefStore, label=RefLabel, sample=RefSample,
                      main=ref_main, cfg=ref_cfg, sst=ref_sst, kw={})
PORT = SimpleNamespace(log=port_log, repl=port_repl, cl=port_cl,
                       placement=port_placement, WalConfig=WalConfig,
                       dur=ReadableDuration, tr=TimeRange,
                       engine=MetricEngine, store=MemoryObjectStore,
                       label=Label, sample=Sample, main=port_main,
                       cfg=port_cfg, sst=port_sst, kw={"device": "cpu"})

SCHEMA = pa.schema([("k", pa.string()), ("ts", pa.int64()),
                    ("v", pa.float64())])


@pytest.fixture(autouse=True)
def parts_route(monkeypatch):
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "0")
    monkeypatch.setenv("HORAEDB_HOST_AGG", "0")


@pytest.fixture
def same_seqs(monkeypatch):
    """Write seqs are SST ids, seeded from the wall clock: start both
    packages' counters at the same value for byte-equal logs."""
    def reset(start=1000):
        monkeypatch.setattr(ref_sst._SST_IDS, "_counter",
                            itertools.count(start))
        monkeypatch.setattr(port_sst._SST_IDS, "_counter",
                            itertools.count(start))
    reset()
    return reset


def run(coro):
    return asyncio.run(coro)


class Clock:
    """Injected ms clock."""

    def __init__(self, now=T0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, ms):
        self.now += ms


def wal_config(P, wal_dir, **kw):
    """Flush thresholds pinned high: the tests flush explicitly, so the
    WAL backlog (the shipped tail) is deterministic."""
    defaults = dict(enabled=True, dir=str(wal_dir), flush_rows=10**6,
                    flush_bytes=1 << 30,
                    flush_age=P.dur.parse("1h"),
                    flush_interval=P.dur.parse("1h"),
                    max_group_wait=P.dur.from_millis(0))
    defaults.update(kw)
    return P.WalConfig(**defaults)


def batch(rows):
    k, t, v = zip(*rows)
    return pa.record_batch(
        [pa.array(list(k)), pa.array(list(t), type=pa.int64()),
         pa.array(list(v), type=pa.float64())], schema=SCHEMA)


def samples(P, seed: int, n: int, hosts: int = 12, lo=T0):
    rng = np.random.default_rng(seed)
    return [P.sample("cpu", [P.label("host", f"h{int(h):02d}")],
                     int(lo + t), float(np.round(v * 100, 3)))
            for h, t, v in zip(rng.integers(0, hosts, n),
                               rng.integers(0, HOUR, n), rng.random(n))]


async def kill_engine(engine):
    """An in-process kill -9: abort every WAL-fronted table (no final
    flush: the acked tail stays only in the WAL) and drop the pools."""
    for t in engine.tables.values():
        abort = getattr(t, "abort", None)
        if abort is not None:
            await abort()
        else:
            await t.close()
    if getattr(engine, "_runtimes", None) is not None:
        engine._runtimes.close()


def rows_of(tbl):
    return sorted(zip(tbl.column("tsid").to_pylist(),
                      tbl.column("timestamp").to_pylist(),
                      tbl.column("value").to_pylist()))


def grid_bytes(out):
    return ([str(t) for t in out["tsids"]], out["num_buckets"],
            {k: np.asarray(v).tobytes() for k, v in
             sorted(out["aggs"].items())})


# ---- the WAL's hooks --------------------------------------------------------


async def _wal_session(P, d, segment_bytes):
    wal = P.log.Wal(str(d), wal_config(P, d, segment_bytes=segment_bytes))
    wal.replay()
    wal.start()
    out = [wal.high_watermark, wal.flushed_seq, wal.segments()]
    rng = np.random.default_rng(5)
    for seq in (3, 7, 9, 10, 12, 15):
        n = int(rng.integers(1, 5))
        rows = [(f"k{int(i)}", int(seq * 10 + j), float(v))
                for j, (i, v) in enumerate(zip(rng.integers(0, 9, n),
                                               rng.random(n)))]
        await wal.append(seq, P.tr.new(seq * 10, seq * 10 + n),
                         batch(rows))
    out.append((wal.high_watermark, wal.segments()))
    tails = []
    for seg in wal.segments():
        blob, sealed = await wal.read_tail(seg["id"], 0, 1 << 20)
        tails.append((blob, sealed, P.log.verify_frames(blob)))
        head = await wal.read_tail(seg["id"], 0, 10)
        tails.append(head)
        tails.append(await wal.read_tail(seg["id"], seg["size"], 64))
    tails.append(await wal.read_tail(999, 0, 64))
    out.append(tails)
    # out-of-order flushes: flushed_seq is the contiguous prefix
    for seqs in ([7, 10], [3], [9, 12], [15]):
        wal.mark_flushed(seqs)
        out.append(wal.flushed_seq)
    asked = []
    wal.retention = lambda sid, mx: asked.append((sid, mx)) or False
    out.append((await wal.truncate(), len(asked) > 0))
    wal.retention = None
    out.append(await wal.truncate())
    out.append(wal.segments())
    await wal.close()
    wal2 = P.log.Wal(str(d), wal_config(P, d))
    wal2.replay()
    out.append((wal2.high_watermark, wal2.segments()))
    await wal2.close()
    return out


@pytest.mark.parametrize("segment_bytes", [1, 300, 1 << 20])
def test_wal_hooks_equal_the_jax_package(tmp_path, segment_bytes):
    ref = run(_wal_session(REF, tmp_path / "ref", segment_bytes))
    got = run(_wal_session(PORT, tmp_path / "port", segment_bytes))
    assert got == ref
    assert got[3][0] == 15


def test_verify_frames_and_mirror_watermarks_equal(tmp_path):
    b = batch([("a", 1, 1.0), ("b", 2, 2.5)])
    rec = port_log.encode_record(4, TimeRange.new(1, 3), b)
    rec2 = port_log.encode_record(11, TimeRange.new(5, 9), b)
    assert rec == ref_log.encode_record(4, RefRange.new(1, 3), b)
    bad = bytearray(rec + rec2)
    bad[len(rec) + 12] ^= 0xFF
    blobs = [b"", rec, rec + rec2, rec + rec2[:7], bytes(bad),
             rec2 + rec, b"\x00" * 7, rec[:8] + b"\xff" * 30]
    for blob in blobs:
        assert port_log.verify_frames(blob) == ref_log.verify_frames(blob)
    # a WAL-layout directory, torn tails and stray files included
    root = tmp_path / "mirror"
    for log, files in {"data": {1: rec, 2: rec2 + rec[:5]},
                       "index": {7: rec}, "empty": {}}.items():
        (root / log).mkdir(parents=True)
        for sid, blob in files.items():
            (root / log / f"{sid:020d}.wal").write_bytes(blob)
    (root / "data" / "notes.txt").write_text("x")
    (root / "stray.wal").write_bytes(rec)
    assert port_log.mirror_watermarks(str(root)) == \
        ref_log.mirror_watermarks(str(root))
    assert port_log.mirror_watermarks(str(root))["data"] == 11
    assert port_log.mirror_watermarks(str(tmp_path / "none")) == {}


# ---- shipping across packages -----------------------------------------------


async def _ship(P, tmp_path, tag):
    """A WAL-fronted primary of package P with a flushed part and an
    acked tail, shipped by P's follower into a mirror."""
    store = P.store()
    primary = await P.engine.open(
        "repl/region_3", store, segment_ms=2 * HOUR,
        wal_config=wal_config(P, tmp_path / f"{tag}_wal"), **P.kw)
    hub = P.repl.ReplicationHub(primary)
    follower = P.repl.WalFollower(P.repl.LocalWalSource(hub, "f1"),
                                  str(tmp_path / f"{tag}_mirror"),
                                  region=3)
    try:
        await primary.write(samples(P, 1, 120))
        await primary.flush()
        await primary.write(samples(P, 2, 80, lo=T0 + HOUR))
        await follower.poll_once()
        assert follower.lag() == 0 and follower.healthy()
        status = hub.status()
        rows = rows_of(await primary.query("cpu", [],
                                           P.tr.new(T0, T0 + 2 * HOUR)))
        tail = rows_of(await primary.query("cpu", [], P.tr.new(
            T0 + HOUR, T0 + 2 * HOUR)))
        return (store, rows, tail, dict(follower.shipped_seqs),
                status["followers"]["f1"]["lag_seqs"], hub.snapshot())
    finally:
        hub.close()
        await follower.close()
        await kill_engine(primary)


async def _replay_mirror(P, mirror_dir):
    """Open a fresh engine of package P whose WAL is `mirror_dir`, over
    an empty store: it holds exactly the shipped tail."""
    eng = await P.engine.open(
        "other", P.store(), segment_ms=2 * HOUR,
        wal_config=wal_config(P, mirror_dir), **P.kw)
    try:
        return rows_of(await eng.query("cpu", [],
                                       P.tr.new(T0, T0 + 2 * HOUR)))
    finally:
        await eng.close()


@pytest.mark.parametrize("shipper,replayer", [(PORT, REF), (REF, PORT)],
                         ids=["port-ships-jax-replays",
                              "jax-ships-port-replays"])
def test_a_mirror_replays_in_the_other_package(tmp_path, same_seqs,
                                               shipper, replayer):
    async def go():
        shipped = await _ship(shipper, tmp_path, "s")
        replayed = await _replay_mirror(replayer,
                                        str(tmp_path / "s_mirror"))
        return shipped, replayed

    (store, rows, tail, shipped_seqs, lag, snap), replayed = run(go())
    assert lag == 0 and shipped_seqs
    # the mirror carries the unflushed tail, row for row
    assert replayed == tail and len(tail) > 0
    assert len(rows) > len(tail)


def test_shipping_listings_equal_the_jax_package(tmp_path, same_seqs):
    async def go():
        ref = await _ship(REF, tmp_path, "r")
        same_seqs()
        got = await _ship(PORT, tmp_path, "p")
        return ref, got

    ref, got = run(go())
    assert got[1:5] == ref[1:5]
    assert got[5] == ref[5]
    for log in ("data", "index"):
        for sid in os.listdir(tmp_path / "r_mirror" / log):
            assert (tmp_path / "p_mirror" / log / sid).read_bytes() == \
                (tmp_path / "r_mirror" / log / sid).read_bytes()


# ---- leases -----------------------------------------------------------------


async def _lease_session(P):
    clock = Clock()
    store = P.store()
    mgr = P.repl.LeaseManager(store, "root", clock=clock)
    out = []
    lease = await mgr.acquire(4, "node-a", ttl_ms=2000, url="http://a")
    lease.grant_ttl_ms(2000)
    out.append(await store.get("root/leases/region_4.json"))
    try:
        await mgr.acquire(4, "node-b", ttl_ms=2000)
    except P.repl.ReplicationError as e:
        out.append(str(e))
    clock.advance(1500)
    await lease.renew()
    out.append(await store.get("root/leases/region_4.json"))
    await lease.check()
    clock.advance(2500)
    for call in (lease.check, lease.check):
        try:
            await call()
        except P.repl.StaleEpochError as e:
            out.append(str(e))
    thief = await mgr.acquire(4, "node-b", ttl_ms=2000)
    out.append((thief.epoch, await store.get("root/leases/region_4.json")))
    await thief.release()
    out.append(await store.get("root/leases/region_4.json"))
    again = await mgr.acquire(4, "node-c", ttl_ms=1000)
    out.append(again.epoch)
    try:
        await lease.renew()
    except P.repl.StaleEpochError as e:
        out.append(str(e))
    rec = await mgr.read(4)
    out.append(rec.to_json())
    out.append(await mgr.read(99))
    return out


def test_lease_records_equal_the_jax_package():
    ref = run(_lease_session(REF))
    got = run(_lease_session(PORT))
    assert got == ref
    assert got[-4] == 3  # the epoch stays monotonic across a release


def test_lease_records_cross_packages():
    """A record written by one package reads in the other."""
    async def go():
        clock = Clock()
        store = MemoryObjectStore()
        pm = port_repl.LeaseManager(store, "x", clock=clock)
        lease = await pm.acquire(1, "p", ttl_ms=500, url="http://p")
        blob = await store.get("x/leases/region_1.json")
        back = ref_repl.LeaseRecord.from_json(blob)
        assert back.to_json() == lease.record.to_json()
        assert port_repl.LeaseRecord.from_json(back.to_json()) == \
            lease.record

    run(go())


# ---- ship, kill, promote ----------------------------------------------------


async def _promote_session(P, tmp_path, tag):
    clock = Clock()
    store = P.store()
    primary = await P.engine.open(
        "repl/region_7", store, segment_ms=2 * HOUR,
        wal_config=wal_config(P, tmp_path / f"{tag}_p"), **P.kw)
    control = await P.engine.open(
        "ctl/region_7", P.store(), segment_ms=2 * HOUR,
        wal_config=wal_config(P, tmp_path / f"{tag}_c"), **P.kw)
    promoted = None
    acked = []
    try:
        for k in range(3):
            batch_ = samples(P, 30 + k, 60, lo=T0 + k * 1000)
            await primary.write(batch_)
            await control.write(batch_)
            acked.extend(batch_)
            if k == 0:
                await primary.flush()   # these rows live in shared SSTs
                await control.flush()
        hub = P.repl.ReplicationHub(primary)
        follower = P.repl.WalFollower(P.repl.LocalWalSource(hub, "f1"),
                                      str(tmp_path / f"{tag}_m"),
                                      region=7)
        await follower.poll_once()
        lag = follower.lag()
        hub.close()
        await follower.close()
        await kill_engine(primary)
        primary = None
        mgr = P.repl.LeaseManager(store, "repl", clock=clock)
        promoted, lease = await P.repl.promote(
            "repl", store, 7, mgr, "node-b", str(tmp_path / f"{tag}_m"),
            wal_config(P, tmp_path / f"{tag}_p"), segment_ms=2 * HOUR,
            **P.kw)
        rng = P.tr.new(T0, T0 + 2 * HOUR)
        got = rows_of(await promoted.query("cpu", [], rng))
        want = rows_of(await control.query("cpu", [], rng))
        ctl = await control.query_downsample("cpu", [], rng, 60_000)
        pro = await promoted.query_downsample("cpu", [], rng, 60_000)
        # acked_write_loss: acked (series, ts) points the promoted node
        # does not serve
        served = {(t, ts) for t, ts, _v in got}
        wanted = {(t, ts) for t, ts, _v in want}
        loss = len(wanted - served)
        await promoted.flush()   # it owns the lease: it can commit
        return (lag, loss, got == want, grid_bytes(pro) == grid_bytes(ctl),
                lease.epoch, len(got))
    finally:
        if primary is not None:
            await primary.close()
        await control.close()
        if promoted is not None:
            P.repl.install_fence(promoted, None)
            await promoted.close()


def test_ship_kill_promote_loses_no_acked_write(tmp_path):
    ref = run(_promote_session(REF, tmp_path, "r"))
    got = run(_promote_session(PORT, tmp_path, "p"))
    assert got == ref
    assert got[:5] == (0, 0, True, True, 1) and got[5] > 0


def test_a_stale_primary_cannot_commit(tmp_path):
    """The fence: a primary whose lease was taken raises StaleEpochError
    at its flush and publishes no SST; its rows stay readable."""
    async def go():
        clock = Clock()
        store = MemoryObjectStore()
        eng = await MetricEngine.open(
            "f/region_0", store, segment_ms=2 * HOUR,
            wal_config=wal_config(PORT, tmp_path / "w"), device="cpu")
        try:
            mgr = port_repl.LeaseManager(store, "f", clock=clock)
            lease = await mgr.acquire(0, "a", ttl_ms=1000)
            port_repl.install_fence(eng, lease)
            await eng.write(samples(PORT, 9, 40))
            clock.advance(2000)
            await mgr.acquire(0, "b", ttl_ms=1000)
            before = len(await eng.tables["data"].manifest.all_ssts())
            with pytest.raises(port_repl.StaleEpochError):
                await eng.flush()
            assert len(await eng.tables["data"].manifest.all_ssts()) == \
                before
            tbl = await eng.query("cpu", [], TimeRange.new(T0, T0 + HOUR))
            assert tbl.num_rows > 0
        finally:
            port_repl.install_fence(eng, None)
            await eng.close()

    run(go())


def _all_logs(eng) -> dict:
    return {name: t.wal.high_watermark for name, t in eng.tables.items()
            if getattr(t, "wal", None) is not None}


def test_retention_waits_for_the_follower(tmp_path):
    async def go():
        clock = Clock()
        eng = await MetricEngine.open(
            "r", MemoryObjectStore(), segment_ms=2 * HOUR,
            wal_config=wal_config(PORT, tmp_path / "w", segment_bytes=1),
            device="cpu")
        hub = port_repl.ReplicationHub(eng, clock=clock)
        try:
            hub.register_follower("f")
            await eng.write(samples(PORT, 4, 30))
            wal = eng.tables["data"].wal
            await eng.flush()
            assert wal.segments(), "unacked segments stay"
            assert hub.status()["retention_held_by"] == ["f"]
            hub.ack("f", _all_logs(eng))
            await wal.truncate()
            assert all(s["max_seq"] == 0 or not s["sealed"]
                       for s in wal.segments())
            # a follower silent past follower_ttl stops pinning
            hub.register_follower("g")
            await eng.write(samples(PORT, 5, 10))
            await eng.flush()
            clock.advance(61_000)
            hub.ack("f", _all_logs(eng))
            await wal.truncate()
            st = hub.status()
            assert st["followers"]["g"]["stale"] is True
            assert st["retention_held_by"] == []
        finally:
            hub.close()
            await eng.close()

    run(go())


# ---- the standby's election -------------------------------------------------


async def _election_session(P, tmp_path, tag):
    """Two standbys of one region over a shared store, driven tick by
    tick under one injected clock and seeded jitter: the primary's lease
    expires, the fresher standby wins, the other defers and retargets;
    both engines are closed at the end."""
    clock = Clock()
    store = P.store()
    cfg = P.repl.FailoverConfig(
        enabled=True, grace=P.dur.from_millis(2000), jitter=0.5,
        fitness_wait=P.dur.from_millis(0),
        cooldown=P.dur.from_millis(3000))
    primary = await P.engine.open(
        "el/region_0", store, segment_ms=2 * HOUR,
        wal_config=wal_config(P, tmp_path / f"{tag}_p"), **P.kw)
    mgr = P.repl.LeaseManager(store, "el", clock=clock)
    lease = await mgr.acquire(0, "primary", ttl_ms=2000)
    lease.grant_ttl_ms(2000)
    P.repl.install_fence(primary, lease)
    hub = P.repl.ReplicationHub(primary, clock=clock)
    out = []
    monitors = []
    promoted = []
    try:
        await primary.write(samples(P, 40, 50))
        await primary.flush()
        await primary.write(samples(P, 41, 30, lo=T0 + HOUR))
        retargeted = []
        for name, polls in (("s1", 1), ("s2", 0)):
            f = P.repl.WalFollower(P.repl.LocalWalSource(hub, name),
                                   str(tmp_path / f"{tag}_{name}"),
                                   region=0)
            for _ in range(polls):
                await f.poll_once()

            async def on_promoted(engine, lease_, name=name):
                promoted.append((name, engine, lease_))

            async def retarget(rec, name=name):
                retargeted.append((name, rec.holder, rec.epoch))

            mon = P.repl.StandbyMonitor(
                f, P.repl.LeaseManager(store, "el", clock=clock), 0, name,
                cfg, wal_config(P, tmp_path / f"{tag}_p"),
                segment_ms=2 * HOUR, lease_ttl_ms=2000,
                on_promoted=on_promoted, retarget=retarget, clock=clock,
                rng=random.Random(7), **P.kw)
            monitors.append(mon)
        for m in monitors:
            await m._tick()
        out.append([m.election_state() for m in monitors])
        # the primary dies: no renewals, the lease expires
        hub.close()
        await kill_engine(primary)
        primary = None
        for step in range(12):
            clock.advance(500)
            for m in monitors:
                try:
                    await m._tick()
                except Exception as e:  # noqa: BLE001 — the dead hub
                    out.append((step, m.holder, type(e).__name__))
            out.append((step, [(m.role, m._grace_deadline_ms, m.attempts,
                                (m.last_outcome or {}).get("outcome"))
                               for m in monitors]))
        winner = promoted[0][1] if promoted else None
        if winner is not None:
            rng = P.tr.new(T0, T0 + 2 * HOUR)
            out.append(len(rows_of(await winner.query("cpu", [], rng))))
        out.append([(n, lz.epoch) for n, _e, lz in promoted])
        out.append(retargeted)
        out.append([m.election_state() for m in monitors])
        return out
    finally:
        for m in monitors:
            await m.close()
            await m.follower.close()
        if primary is not None:
            hub.close()
            await kill_engine(primary)
        for _n, eng, lz in promoted:
            P.repl.install_fence(eng, None)
            await eng.close()


def test_standby_election_under_an_injected_clock(tmp_path, same_seqs):
    ref = run(_election_session(REF, tmp_path, "r"))
    same_seqs()
    got = run(_election_session(PORT, tmp_path, "p"))
    assert got == ref
    assert got[-3] == [("s1", 2)], "the fresher mirror wins at epoch 2"
    assert got[-4] == 80, "no acked write lost"
    final = got[-1]
    assert final[0]["role"] == "primary"
    assert final[0]["last_outcome"]["outcome"] == "won"
    assert final[1]["role"] == "standby"
    # the other standby saw the winner's live lease and tails it now
    assert got[-2] == [("s1", "primary", 1), ("s2", "primary", 1),
                       ("s2", "s1", 2)]


def test_store_partition_never_arms(tmp_path):
    class BoomStore(MemoryObjectStore):
        async def get(self, path):
            raise ConnectionError("store partition")

    async def go():
        clock = Clock()
        mgr = port_repl.LeaseManager(BoomStore(), "part", clock=clock)
        follower = SimpleNamespace(shipped_seqs={}, _flushed={},
                                   mirror_dir=str(tmp_path / "m"),
                                   lag=lambda: 0)
        mon = port_repl.StandbyMonitor(
            follower, mgr, 0, "x", port_repl.FailoverConfig(enabled=True),
            wal_config(PORT, tmp_path / "w"), clock=clock,
            rng=random.Random(1), device="cpu")
        for _ in range(3):
            clock.advance(60_000)
            with pytest.raises(ConnectionError):
                await mon._tick()
        assert mon._grace_deadline_ms is None
        assert mon.attempts == 0 and mon.role == "standby"

    run(go())


# ---- placement and rebalance ------------------------------------------------


class _PlanCluster:
    """What the executor and the controller consume of a cluster."""

    def __init__(self, plan, stats=None):
        self.rebalance_survey = {"at_ms": T0, "plan": plan}
        self.splits = []
        self._stats = stats or {}

    async def split_region(self, rid, pivot, new_rid, ttl_ms):
        self.splits.append((rid, pivot, new_rid, ttl_ms))

    async def region_stats(self):
        return self._stats


async def _rebalance_session(P):
    clock = Clock()
    split = {"region": 0, "kind": "split", "pivot_key": 1 << 62,
             "new_region_id": 9, "reason": "hot shard"}
    move = {"region": 2, "kind": "move", "reason": "skew"}
    out = []
    c = _PlanCluster([split, move])
    for cfg in (P.repl.RebalanceConfig(),
                P.repl.RebalanceConfig(enabled=True),
                P.repl.RebalanceConfig(enabled=True, dry_run=False)):
        ex = P.repl.RebalanceExecutor(c, cfg, clock=clock)
        out.append(await ex.run_once())
        out.append(await ex.run_once())
        clock.advance(cfg.cooldown.seconds * 1000 + 1)
        out.append(await ex.run_once())
        out.append(ex.history)
    ex = P.repl.RebalanceExecutor(
        c, P.repl.RebalanceConfig(enabled=True, dry_run=False),
        clock=clock)
    ex._inflight = 1
    out.append(await ex.run_once())
    out.append(c.splits)
    # the controller closes the executor's seams
    ctl = P.placement.PlacementController(
        _PlanCluster([], stats={0: {"bytes": 5, "rules": 1},
                                2: {"bytes": 9, "rules": 2}}),
        P.repl.RebalanceConfig(max_replica_lag_seqs=2), clock=clock)
    lags = {0: 5, 2: 0}
    ctl.register_lag_probe(0, lambda: lags[0])
    ctl.register_lag_probe(2, lambda: lags[2])
    ex = P.repl.RebalanceExecutor(
        c, P.repl.RebalanceConfig(enabled=True, dry_run=False),
        clock=clock)
    ctl.attach(ex)
    adopted = []

    async def heavy(rid, entry):
        raise RuntimeError("full")

    async def light(rid, entry):
        adopted.append(rid)
        return True

    ctl.register_node("heavy", heavy, load=lambda: 1)
    ctl.register_node("light", light, load=lambda: 5)
    clock.advance(10**9)
    out.append(await ex.run_once())
    promotions = []

    async def promote_a():
        promotions.append("a")
        return "engine-a"

    async def promote_b():
        promotions.append("b")
        return "engine-b"

    ctl.register_standby(0, "b", lambda: 7, promote_b)
    ctl.register_standby(0, "a", lambda: 7, promote_a)
    ctl.register_standby(2, "z", lambda: 9, promote_b)
    out.append((ctl.choose_promotion(0), ctl.choose_promotion(2),
                ctl.choose_promotion(5)))
    out.append(await ctl.promote_region(0))
    out.append(await ctl.promote_region(5))
    ctl.cluster.rebalance_survey = None
    out.append(await ctl.refresh())
    out.append((ctl.history, adopted, promotions))
    return out


def test_rebalance_and_placement_equal_the_jax_package():
    ref = run(_rebalance_session(REF))
    got = run(_rebalance_session(PORT))
    assert got == ref
    outcomes = [r["outcome"] for r in got[3]]
    assert outcomes == ["disabled", "disabled", "disabled", "disabled",
                        "disabled", "disabled"]


def test_lease_owner_resolver_follows_the_record():
    async def go():
        clock = Clock()
        store = MemoryObjectStore()
        mgr = port_repl.LeaseManager(store, "root", clock=clock)
        made = []

        def factory(rec):
            made.append(rec.holder)
            return f"backend:{rec.holder}"

        res = port_placement.LeaseOwnerResolver(mgr, factory,
                                                cache_ttl_ms=1000,
                                                clock=clock)
        assert await res(1, None) is None          # no lease: partial
        await mgr.acquire(1, "a", ttl_ms=5000)
        assert await res(1, None) == "backend:a"
        assert await res(1, None) == "backend:a"   # cached
        assert made == ["a"]
        clock.advance(6000)
        await mgr.acquire(1, "b", ttl_ms=5000)
        hint = port_repl.StaleOwnerError("moved", region=1, owner="b")
        assert await res(1, hint) == "backend:b"   # contradicted: busted
        assert made == ["a", "b"]
        # the default factory follows the record's URL
        await mgr.acquire(2, "c", ttl_ms=5000, url="http://127.0.0.1:9")
        remote = await port_placement.LeaseOwnerResolver(
            mgr, clock=clock)(2, None)
        assert isinstance(remote, port_cl.RemoteRegion)
        await remote.close()

    run(go())


# ---- HTTP shipping against the port's server --------------------------------


def test_http_wal_source_against_the_ports_server(tmp_path):
    async def go():
        cfg = port_cfg.load_config(None)
        cfg.wal = wal_config(PORT, tmp_path / "wal")
        cfg.replication = dataclasses.replace(cfg.replication,
                                              enabled=True)
        eng = await MetricEngine.open(
            "h", MemoryObjectStore(), segment_ms=2 * HOUR,
            wal_config=cfg.wal, device="cpu")
        state = port_main.ServerState(eng, cfg)
        server = TestServer(port_main.build_app(state))
        await server.start_server()
        source = port_repl.HttpWalSource(str(server.make_url("/")),
                                         follower_id="f-http",
                                         timeout_s=10.0)
        follower = port_repl.WalFollower(source, str(tmp_path / "m"),
                                         region=0)
        try:
            await eng.write(samples(PORT, 50, 60))
            shipped = await follower.poll_once()
            assert shipped > 0 and follower.lag() == 0
            st = state.repl.status()
            assert st["followers"]["f-http"]["lag_seqs"] == 0
            for log in ("data", "series"):
                src = sorted(os.listdir(tmp_path / "wal" / log))
                assert sorted(os.listdir(tmp_path / "m" / log)) == src
                for name in src:
                    assert (tmp_path / "m" / log / name).read_bytes() == \
                        (tmp_path / "wal" / log / name).read_bytes()
            # the follower survives a restart: progress from the mirror
            await eng.write(samples(PORT, 51, 20))
            again = port_repl.WalFollower(
                port_repl.HttpWalSource(str(server.make_url("/")),
                                        follower_id="f-http"),
                str(tmp_path / "m"), region=0)
            await again.poll_once()
            assert again.lag() == 0
            assert again.shipped_seqs["data"] == \
                eng.tables["data"].wal.high_watermark
            await again.close()
            # a closed hub answers like a dead primary
            state.repl.close()
            state.repl = None
            with pytest.raises(port_repl.ReplicationError, match="501"):
                await source.snapshot()
        finally:
            await follower.close()
            await server.close()
            await eng.close()

    run(go())


def test_server_state_claims_and_fences_its_region(tmp_path):
    """[replication] region >= 0: start_replication claims the lease and
    fences every WAL table; losing the lease flips the data plane to
    409; /repl/status reports it."""
    async def go():
        cfg = port_cfg.load_config(None)
        cfg.wal = wal_config(PORT, tmp_path / "wal")
        cfg.replication = dataclasses.replace(
            cfg.replication, enabled=True, region=3, holder="node-a",
            lease_ttl=ReadableDuration.from_secs(10),
            renew_interval=ReadableDuration.from_secs(2))
        store = MemoryObjectStore()
        eng = await MetricEngine.open(
            "metrics", store, segment_ms=2 * HOUR, wal_config=cfg.wal,
            device="cpu")
        state = port_main.ServerState(eng, cfg)
        client = __import__("aiohttp.test_utils").test_utils.TestClient(
            TestServer(port_main.build_app(state)))
        await client.start_server()
        try:
            await state.start_replication(store)
            assert state.lease is not None and state.lease.epoch == 1
            assert all(t.fence is state.lease
                       for t in eng.tables.values()
                       if getattr(t, "wal", None) is not None)
            r = await client.get("/repl/status")
            body = await r.json()
            assert body["role"] == "primary"
            assert body["lease"] == {"region": 3, "epoch": 1,
                                     "lost": False}
            rec = json.loads(await store.get(
                "metrics/leases/region_3.json"))
            assert rec["holder"] == "node-a" and rec["url"].endswith(
                f":{cfg.port}")
            state.lease.on_lost(port_repl.StaleEpochError("stolen"))
            r = await client.post("/write", json={"samples": []})
            assert r.status == 409
        finally:
            await client.close()
            await state.stop_replication()
            await eng.close()

    run(go())


def test_a_standby_server_promotes_with_its_own_layout(tmp_path):
    """[failover] on a follower node: the StandbyMonitor that
    start_replication wires opens the promoted engine with the node's
    segment duration, storage config and device (the JAX package's
    falls back to the defaults: ROADMAP Queue C 11)."""
    async def go():
        cfg = port_cfg.load_config(None)
        cfg.metric_engine.segment_duration = ReadableDuration.parse("1h")
        cfg.replication = dataclasses.replace(
            cfg.replication, enabled=True, region=0,
            primary_url="http://127.0.0.1:9",
            mirror_dir=str(tmp_path / "m"),
            poll_interval=ReadableDuration.parse("1h"))
        cfg.failover = dataclasses.replace(
            cfg.failover, enabled=True,
            check_interval=ReadableDuration.parse("1h"))
        eng = await MetricEngine.open("metrics", MemoryObjectStore(),
                                      segment_ms=HOUR, device="cpu")
        state = port_main.ServerState(eng, cfg)
        try:
            await state.start_replication(MemoryObjectStore())
            mon = state.monitor
            assert mon is not None and state.lease is None
            assert mon.segment_ms == HOUR
            assert mon.engine_config is \
                cfg.metric_engine.time_merge_storage
            assert mon.device.type == "cpu"
            assert mon.election_state()["role"] == "standby"
        finally:
            await state.stop_replication()
            await eng.close()

    run(go())
