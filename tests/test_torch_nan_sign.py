"""NaN samples through every route of the port against the JAX package
(ROADMAP C 18): both packages' engines take the same seeded batches and
their grids are compared byte for byte in all six aggregates.

The rule the JAX package keeps on the CPU, and the port with it:
- min: a cell's positive NaN if it has one, else its negative NaN;
  max: its negative NaN if it has one, else its positive NaN; a NaN's
  payload rides along (a float64 payload that survives the cast to
  float32 is kept).  Two NaNs of one sign and different payloads in one
  cell are the one case the port does not follow: the reference keeps
  the first or the last in its visiting order, the port the larger
  payload (csrc/bucket_agg.cu, "NaN images"); no case here mixes them.
- sum and avg: a cell whose NaNs share their bits takes those bits.
  Within a window the reference keeps the window's last NaN row, and so
  does the port.  Where NaNs of different bits meet across windows or
  rounds of the fused route, the reference's choice follows the operand
  order its compiled scatter-add happens to take (the earlier window's
  NaN over two segments, the later one over two windows of a segment
  or two rounds); the port keeps the earlier NaN, as jnp's add does.
  There sum and avg are held to NaN, and every other case to the bytes.
  The parts route's numpy folds are the reference's own, run on the
  reference's partial bits, so they give its bits as they stand (for a
  1 x 1 grid, numpy's in-place mixed-dtype minimum and maximum make any
  NaN the positive one).
- count and last are selections and keep every bit.
- The cluster gather's merge (storage/combine.merge_downsample_results:
  np.fmin, np.fmax, nan_to_num) drops NaN samples in both packages; its
  grids are compared byte for byte all the same.

Placements: one window; two windows of one segment
(`max_window_rows` 2); two fused rounds (also `agg_batch_windows` 1);
two segments under a 1-day bucket; a flushed SST plus a memtable row
behind the WAL; two regions of a cluster gather.  Routes: fused, parts
with host decode, parts with device decode, the chunked layout,
rollup-served, a 4 x 2 `[scan.mesh]` on 8 cpu slots, a scan agent, and
`Cluster.query_downsample_gather`.

The JAX side runs with HORAEDB_HOST_AGG=0 (C 8).  Rollups run on the
parts route only: the reference's maintenance raises on the fused route
(C 7).  The chunked layout is compared against both of the reference's
downsample implementations: its default (XLA segment ops) in all six
aggregates, and its Pallas kernel (interpret mode), whose sum of a
cell's NaNs of both signs takes the NaN its XLA reduction tree visits
last in a tree order, not in row order: there the sum and avg are held
to NaN and the other four aggregates to the bytes."""

import asyncio

import numpy as np
import pyarrow as pa
import pytest

import horaedb_tpu.ops.downsample as ref_downsample
from horaedb_tpu.cluster import Cluster as RefCluster
from horaedb_tpu.cluster import routing_key as ref_routing_key
from horaedb_tpu.metric_engine import Label as RefLabel
from horaedb_tpu.metric_engine import MetricEngine as RefEngine
from horaedb_tpu.metric_engine import Sample as RefSample
from horaedb_tpu.objstore import MemoryObjectStore as RefStore
from horaedb_tpu.rollup import RollupConfig as RefRollupConfig
from horaedb_tpu.scanagent import AgentService as RefAgent
from horaedb_tpu.scanagent import AgentSpec as RefAgentSpec
from horaedb_tpu.scanagent import ScanAgentConfig as RefAgentConfig
from horaedb_tpu.storage.config import StorageConfig as RefConfig
from horaedb_tpu.storage.types import TimeRange as RefRange
from horaedb_tpu.wal import WalConfig as RefWalConfig
from horaedb_tpu_torch.cluster import Cluster as PortCluster
from horaedb_tpu_torch.cluster import routing_key as port_routing_key
from horaedb_tpu_torch.metric_engine import Label as PortLabel
from horaedb_tpu_torch.metric_engine import MetricEngine as PortEngine
from horaedb_tpu_torch.metric_engine import Sample as PortSample
from horaedb_tpu_torch.objstore import MemoryObjectStore as PortStore
from horaedb_tpu_torch.ops import bucket_agg
from horaedb_tpu_torch.parallel import mesh as mesh_mod
from horaedb_tpu_torch.rollup import RollupConfig as PortRollupConfig
from horaedb_tpu_torch.scanagent import AgentService as PortAgent
from horaedb_tpu_torch.scanagent import AgentSpec as PortAgentSpec
from horaedb_tpu_torch.scanagent import ScanAgentConfig as PortAgentConfig
from horaedb_tpu_torch.storage import read as port_read
from horaedb_tpu_torch.storage.config import StorageConfig as PortConfig
from horaedb_tpu_torch.storage.types import TimeRange as PortRange
from horaedb_tpu_torch.wal import WalConfig as PortWalConfig

T0 = 1_699_999_200_000  # a multiple of SEG
SEG = 2 * 3600_000
HOUR = 3600_000
DAY = 24 * HOUR
AGGS = ("count", "sum", "min", "max", "avg", "last")


def _f64(bits: int) -> float:
    return float(np.array([bits], np.uint64).view(np.float64)[0])


# the float64 samples as written: numpy's quiet NaN, its negative, and a
# payload of each sign that survives the cast to float32 (0x7fc00001,
# 0xffc00001)
NAN = {"+": _f64(0x7FF8000000000000), "-": _f64(0xFFF8000000000000),
       "+q": _f64(0x7FF8000020000000), "-q": _f64(0xFFF8000020000000)}
# a case is the NaNs of the cell under test, in row (time) order
SINGLE = [("+",), ("-",), ("+q",), ("-q",)]
PAIRS = [("+", "-"), ("-", "+"), ("-", "-"), ("+q", "-q")]


def _case_id(case) -> str:
    return "_".join({"+": "pos", "-": "neg", "+q": "posq",
                     "-q": "negq"}[c] for c in case)


class Pkg:
    def __init__(self, name, engine, store, config, rng, label, sample,
                 wal, rollup, agent, agent_spec, agent_cfg, cluster,
                 routing_key, kw):
        self.name, self.Engine, self.Store = name, engine, store
        self.Config, self.Range = config, rng
        self.Label, self.Sample = label, sample
        self.Wal, self.Rollup = wal, rollup
        self.Agent, self.AgentSpec, self.AgentConfig = (agent, agent_spec,
                                                        agent_cfg)
        self.Cluster, self.routing_key, self.kw = cluster, routing_key, kw


REF = Pkg("ref", RefEngine, RefStore, RefConfig, RefRange, RefLabel,
          RefSample, RefWalConfig, RefRollupConfig, RefAgent, RefAgentSpec,
          RefAgentConfig, RefCluster, ref_routing_key, {})
PORT = Pkg("port", PortEngine, PortStore, PortConfig, PortRange, PortLabel,
           PortSample, PortWalConfig, PortRollupConfig, PortAgent,
           PortAgentSpec, PortAgentConfig, PortCluster, port_routing_key,
           {"device": "cpu"})


@pytest.fixture(autouse=True)
def parts_env(monkeypatch):
    """The JAX package's partial grids from its device program (C 8)."""
    monkeypatch.setenv("HORAEDB_HOST_AGG", "0")
    with mesh_mod.local_devices_scope(["cpu"] * 8):
        yield


def run(coro):
    return asyncio.run(coro)


def _layout(placement: str, case: tuple) -> tuple:
    """(writes, bucket_ms, span): writes is a list of row lists, each
    row (ms after T0, value); the cell under test is series "a"'s first
    bucket.  A one-NaN case puts 4.0 where a second NaN would go.  The
    rollup route queries its 10 min tier instead of 1 h."""
    x1 = NAN[case[0]]
    x2 = NAN[case[1]] if len(case) > 1 else 4.0
    if placement == "segments":
        return ([[(0, 1.0), (1000, x1), (5000, 3.0), (SEG + 1000, x2),
                  (SEG + 4_200_000, 2.0)]], DAY, 2 * SEG)
    first = [(0, 1.0), (1000, x1)]
    second = [(2000, x2), (5000, 3.0), (4_200_000, 2.0)]
    if placement in ("wal", "regions"):
        return [first, second], HOUR, SEG
    return [first + second], HOUR, SEG


def _config(P, route: str, placement: str):
    cfg = P.Config()
    cfg.scheduler.schedule_interval = _hour(P)
    if route == "decode":
        cfg.scan.decode.mode = "device"
    if route == "mesh":
        cfg.scan.mesh.enabled = True
        cfg.scan.mesh.time, cfg.scan.mesh.series = 4, 2
    if placement in ("windows", "rounds"):
        cfg.scan.max_window_rows = 2
    if placement == "rounds":
        cfg.scan.agg_batch_windows = 1
    return cfg


def _hour(P):
    return type(P.Config().scheduler.schedule_interval).parse("1h")


def _grids(out) -> dict:
    return {k: np.asarray(v.cpu().numpy() if hasattr(v, "cpu") else v)
            for k, v in out["aggs"].items()}


def _batch(rows):
    return pa.record_batch({
        "host": pa.array(["a"] * len(rows)),
        "timestamp": pa.array([T0 + t for t, _ in rows]),
        "value": pa.array([v for _, v in rows])})


async def _engine_grids(P, route: str, placement: str, case: tuple,
                        tmp_path) -> dict:
    writes, bucket, span = _layout(placement, case)
    if route == "rollup":
        bucket = 600_000
    store = P.Store()
    kw = dict(P.kw)
    service = None
    if placement == "wal":
        kw["wal_config"] = P.Wal(enabled=True, dir=str(tmp_path / P.name),
                                 flush_rows=10**6)
    if route == "chunked":
        kw["chunked_data"] = True
    if route == "rollup":
        kw["rollup_config"] = P.Rollup(
            enabled=True, tiers=["1m", "10m"], specs=["cpu"],
            roll_interval=_hour(P))
    if route == "agent":
        service = (P.Agent(store, device="cpu") if P is PORT
                   else P.Agent(store))
        url = await service.start()
        kw["scanagent_config"] = P.AgentConfig(
            mode="on", agents=(P.AgentSpec("a0", url, (0,)),))
    e = await P.Engine.open("t", store, segment_ms=SEG,
                            config=_config(P, route, placement), **kw)
    try:
        for i, rows in enumerate(writes):
            if i and placement == "wal":
                await e.flush()
            await e.write_arrow("cpu", ["host"], _batch(rows))
        if route == "rollup":
            rolled = await e.rollups.roll_now()
            assert rolled["cpu:value"] >= 1, rolled
        spec = e.rollups.specs[("cpu", "value")] if route == "rollup" \
            else None
        out = await e.query_downsample(
            "cpu", [], P.Range.new(T0, T0 + span), bucket, aggs=AGGS)
        if spec is not None:
            assert spec.served_queries == 1, "not rollup-served"
        return _grids(out)
    finally:
        await e.close()
        if service is not None:
            await service.close()


async def _cluster_grids(P, placement: str, case: tuple) -> dict:
    """One region; the second write goes to the region a split makes, so
    the cell's two NaNs meet in the gather's merge ("regions"), or both
    in region 0 ("window")."""
    writes, bucket, span = _layout(placement, case)
    c = await P.Cluster.open("cl", P.Store(), num_regions=1,
                             segment_ms=SEG, **P.kw)
    labels = [P.Label("host", "a")]
    try:
        for i, rows in enumerate(writes):
            if i:
                await c.split_region(0, P.routing_key("cpu", labels), 1,
                                     30 * DAY)
            await c.write([P.Sample("cpu", labels, T0 + t, v)
                           for t, v in rows])
        if placement == "regions":
            assert sorted(c.regions) == [0, 1]
        out, meta = await c.query_downsample_gather(
            "cpu", [], P.Range.new(T0, T0 + span), bucket)
        assert not meta.partial
        return {k: np.asarray(v) for k, v in out["aggs"].items()}
    finally:
        await c.close()


def _both(monkeypatch, route: str, placement: str, case: tuple, tmp_path,
          fused: bool = False) -> tuple:
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1" if fused else "0")
    if route == "cluster":
        return (run(_cluster_grids(REF, placement, case)),
                run(_cluster_grids(PORT, placement, case)))
    return (run(_engine_grids(REF, route, placement, case, tmp_path)),
            run(_engine_grids(PORT, route, placement, case, tmp_path)))


def _bits(a) -> list:
    a = np.asarray(a)
    u = np.uint32 if a.dtype == np.float32 else np.uint64
    return [hex(int(x)) for x in a.reshape(-1)[:2].view(u)]


def _assert_bytes(ref: dict, got: dict, aggs=AGGS, ctx="", nan_cell=True):
    for k in AGGS:
        assert k in ref and k in got, (ctx, k, sorted(ref), sorted(got))
        r, g = ref[k], got[k]
        assert g.dtype == r.dtype and g.shape == r.shape, (ctx, k)
        if k in aggs:
            assert g.tobytes() == r.tobytes(), (ctx, k, _bits(r), _bits(g))
        else:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
    if nan_cell:  # the cell under test is NaN in min and max
        assert np.isnan(got["min"].reshape(-1)[0]), ctx
        assert np.isnan(got["max"].reshape(-1)[0]), ctx


def _mixed(case: tuple) -> bool:
    return len(set(case)) > 1


ENGINE_ROUTES = ["fused", "parts", "decode"]


@pytest.mark.parametrize("case", SINGLE + PAIRS, ids=_case_id)
@pytest.mark.parametrize("route", ENGINE_ROUTES)
def test_one_window(monkeypatch, tmp_path, route, case):
    ref, got = _both(monkeypatch, route, "window", case, tmp_path,
                     fused=route == "fused")
    _assert_bytes(ref, got, ctx=(route, case))


# rounds are the fused route's; the parts route's are its windows
BOUNDARIES = [(r, p) for r in ENGINE_ROUTES
              for p in ("windows", "rounds", "segments", "wal")
              if p != "rounds" or r == "fused"]


@pytest.mark.parametrize("case", [("-",)] + PAIRS, ids=_case_id)
@pytest.mark.parametrize("route,placement", BOUNDARIES)
def test_nans_meet_across_a_boundary(monkeypatch, tmp_path, route,
                                     placement, case):
    ref, got = _both(monkeypatch, route, placement, case, tmp_path,
                     fused=route == "fused")
    aggs = AGGS
    if route == "fused" and placement in ("windows", "rounds") \
            and _mixed(case):
        aggs = ("count", "min", "max", "last")
    _assert_bytes(ref, got, aggs=aggs, ctx=(route, placement, case))


@pytest.fixture(params=["xla", "pallas"])
def chunked_impl(request):
    """The JAX package's chunked aggregate through its default XLA
    segment ops or its Pallas kernel (interpret mode), restored."""
    prev = ref_downsample._impl
    ref_downsample.set_downsample_impl(request.param)
    yield request.param
    ref_downsample.set_downsample_impl(prev)


@pytest.mark.parametrize("placement", ["window", "segments"])
@pytest.mark.parametrize("case", SINGLE + PAIRS, ids=_case_id)
def test_chunked(monkeypatch, tmp_path, chunked_impl, placement, case):
    ref, got = _both(monkeypatch, "chunked", placement, case, tmp_path,
                     fused=True)
    aggs = AGGS if chunked_impl == "xla" or not _mixed(case) else \
        ("count", "min", "max", "last")
    _assert_bytes(ref, got, aggs=aggs, ctx=(chunked_impl, placement, case))


@pytest.mark.parametrize("placement", ["window", "windows"])
@pytest.mark.parametrize("case", SINGLE + PAIRS, ids=_case_id)
def test_rollup_served(monkeypatch, tmp_path, placement, case):
    """Rollup cells are 10 min buckets of one segment: NaNs meet in one
    cell within a window or across windows of the rolled segment."""
    ref, got = _both(monkeypatch, "rollup", placement, case, tmp_path)
    _assert_bytes(ref, got, ctx=(placement, case))


@pytest.mark.parametrize("placement", ["window", "segments"])
@pytest.mark.parametrize("case", [("-",)] + PAIRS, ids=_case_id)
def test_mesh(monkeypatch, tmp_path, placement, case):
    rounds0 = port_read._MESH_ROUNDS.value
    ref, got = _both(monkeypatch, "mesh", placement, case, tmp_path)
    assert port_read._MESH_ROUNDS.value > rounds0, "the mesh did not run"
    _assert_bytes(ref, got, ctx=(placement, case))


@pytest.mark.parametrize("placement", ["window", "segments"])
@pytest.mark.parametrize("case", [("-",)] + PAIRS, ids=_case_id)
def test_scan_agent(monkeypatch, tmp_path, placement, case):
    from horaedb_tpu_torch.scanagent import client as client_mod

    served = client_mod._REQUESTS.labels(agent="a0", outcome="ok")
    before = served.value
    ref, got = _both(monkeypatch, "agent", placement, case, tmp_path)
    assert served.value > before, "the agent served nothing"
    _assert_bytes(ref, got, ctx=(placement, case))


@pytest.mark.parametrize("placement", ["window", "regions"])
@pytest.mark.parametrize("case", [("-",)] + PAIRS, ids=_case_id)
def test_cluster_gather(monkeypatch, tmp_path, placement, case):
    ref, got = _both(monkeypatch, "cluster", placement, case, tmp_path)
    _assert_bytes(ref, got, ctx=(placement, case), nan_cell=False)


def test_boundary_placements_split_the_rows(monkeypatch, tmp_path):
    """The `windows` placement gives the fused route one round of three
    windows, `rounds` three rounds of one: the two NaNs really meet
    across a window and a round."""
    calls = []
    plain = bucket_agg.bucket_round_accumulate_plain

    def spy(acc, ts, *a, **kw):
        calls.append(int(ts.shape[0]) if kw.get("n_valid") is None
                     else int((kw["n_valid"] > 0).sum()))
        return plain(acc, ts, *a, **kw)

    monkeypatch.setattr(bucket_agg, "bucket_round_accumulate_plain", spy)
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1")
    for placement, want in (("windows", [3]), ("rounds", [1, 1, 1])):
        calls.clear()
        run(_engine_grids(PORT, "fused", placement, ("+", "-"), tmp_path))
        assert calls == want, (placement, calls)


# ---- the helpers against the kernel's rule, bit by bit -------------------

def _f32(bits: int) -> np.float32:
    return np.array([bits], np.uint32).view(np.float32)[0]


@pytest.mark.parametrize("a,b,lo,hi", [
    (0x7FC00000, 0xFFC00000, 0x7FC00000, 0xFFC00000),
    (0xFFC00000, 0x7FC00000, 0x7FC00000, 0xFFC00000),
    (0xFFC00000, 0x3F800000, 0xFFC00000, 0xFFC00000),
    (0x7FC00001, 0xFF800000, 0x7FC00001, 0x7FC00001),
    (0xFFC00001, 0x7F800000, 0xFFC00001, 0xFFC00001),
    (0xFFFFFFFF, 0x00000000, 0xFFFFFFFE, 0xFFFFFFFF),
    (0x7FFFFFFF, 0x00000000, 0x7FFFFFFF, 0x7FFFFFFE),
    (0x80000000, 0x00000000, 0x80000000, 0x00000000),
])
def test_nan_min_max_rule(a, b, lo, hi):
    """nan_min / nan_max of two float32 bit patterns: the NaN sign rule,
    payloads kept, the one all-ones payload per fold that decodes one
    below itself, and -0 below +0."""
    import torch

    ta = torch.from_numpy(np.array([_f32(a)]))
    tb = torch.from_numpy(np.array([_f32(b)]))
    for x, y in ((ta, tb), (tb, ta)):
        assert bucket_agg.nan_min(x, y).view(torch.int32).item() \
            & 0xFFFFFFFF == lo
        assert bucket_agg.nan_max(x, y).view(torch.int32).item() \
            & 0xFFFFFFFF == hi


def test_nan_add_matches_the_reference_add():
    """nan_add against jnp's add on the CPU: NaN operands of either sign
    in either order, opposite infinities, numbers."""
    import jax.numpy as jnp
    import torch

    vals = [0x7FC00000, 0xFFC00000, 0x7FC00001, 0x7F800000, 0xFF800000,
            0x3F800000, 0xC0000000]
    a = np.array([_f32(x) for x in vals for _ in vals], np.float32)
    b = np.array([_f32(y) for _ in vals for y in vals], np.float32)
    ref = np.asarray(jnp.asarray(a) + jnp.asarray(b))
    got = bucket_agg.nan_add(torch.from_numpy(a), torch.from_numpy(b))
    assert got.numpy().tobytes() == ref.tobytes()
