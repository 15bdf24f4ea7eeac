"""The aggregate kernel's wrappers (ops/bucket_agg.py) on the CPU: the
build command and its output path, the fields each aggregate set
needs, the columns a round touches, the round entry's argument checks
and dispatch (the plain version for CPU tensors only, never a fallback
for others), and the fused reader sending every round through that
entry with its windows' row counts.  The kernel itself runs only on
the card (chip_smoke.py holds it against these plain versions there)."""

import asyncio
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.metric_engine import MetricEngine
from horaedb_tpu_torch.objstore import MemoryObjectStore
from horaedb_tpu_torch.ops import bucket_agg
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.storage import read
from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
from horaedb_tpu_torch.storage.types import TimeRange

SEG = 2 * 3600 * 1000
T0 = (1_700_000_000_000 // SEG) * SEG


def test_build_targets_hopper_and_keys_the_library_by_source(monkeypatch,
                                                          tmp_path):
    cmd = bucket_agg.nvcc_command("out.so")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert cmd[-1] == bucket_agg.SOURCE
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(bucket_agg, "SOURCE", str(src))
    first = bucket_agg.library_path()
    assert first == bucket_agg.library_path()
    src.write_text("// two")
    assert bucket_agg.library_path() != first
    assert first.startswith(bucket_agg.BUILD_DIR)


@pytest.mark.parametrize("which,want", [
    (("avg",), ("count", "sum")),
    (("min",), ("count", "min")),
    (("last",), ("count", "last_ts", "last")),
    (ALL_AGGS, ("count", "sum", "min", "max", "last_ts", "last")),
], ids=lambda v: "-".join(v))
def test_fields_for_adds_dependencies_in_output_order(which, want):
    assert bucket_agg.fields_for(which) == want


@pytest.mark.parametrize("lo,nv,width,total,want", [
    # the union of the windows' [lo, lo + width)
    ([0, 120, 240], None, 128, 1000, (0, 368)),
    # cut at the total bucket count
    ([0, 120, 240], None, 128, 300, (0, 300)),
    # an empty window (a padding slot of the round) touches nothing
    ([0, 120, 240], [0, 5, 5], 128, 1000, (120, 368)),
    ([0, 120, 240], [5, 5, 0], 128, 1000, (0, 248)),
    # a round of empty windows touches no column
    ([3, 4], [0, 0], 8, 100, (0, 0)),
], ids=["union", "cut", "empty-first", "empty-last", "all-empty"])
def test_round_columns_cover_the_non_empty_windows(lo, nv, width, total,
                                                   want):
    nv = None if nv is None else np.asarray(nv, np.int32)
    assert bucket_agg._round_columns(np.asarray(lo, np.int32), nv, width,
                                     total) == want


def _round(W=2, cap=256, n_valid=(256, 200)):
    rng = np.random.default_rng(1)
    ts = torch.from_numpy(rng.integers(0, 4 * 100, (W, cap)).astype(np.int32))
    gid = torch.from_numpy(rng.integers(0, 2, (W, cap)).astype(np.int32))
    vals = torch.ones((W, cap), dtype=torch.float32)
    nv = np.asarray(n_valid, np.int32)
    return ts, gid, vals, nv


def test_round_entry_takes_plain_only_for_cpu_tensors(monkeypatch):
    """On the CPU the round entry runs the plain version (partial grids,
    then per-window slice updates) and counts no launch; a tensor on any
    other device raises and never reaches the plain version."""
    ts, gid, vals, nv = _round()
    acc = read.fused_acc_init(num_groups=2, num_buckets=4, which=("avg",),
                              device="cpu")
    before = dict(bucket_agg.LAUNCHES)
    read.fused_round_accumulate(
        acc, ts, gid, vals, None, None, None, np.zeros(2, np.int32), 4, 100,
        num_groups=2, width=4, which=("avg",), n_valid=torch.from_numpy(nv),
        n_valid_host=nv)
    assert dict(bucket_agg.LAUNCHES) == before
    # rows past each window's n_valid are dropped
    assert float(acc["count"].sum()) == float(nv.sum())
    assert float(acc["sum"].sum()) == float(nv.sum())

    def boom(*_a, **_k):
        raise AssertionError("the plain version served a non-CPU tensor")

    monkeypatch.setattr(bucket_agg, "bucket_round_accumulate_plain", boom)
    monkeypatch.setattr(bucket_agg, "fold_window_partials", boom)
    meta = [t.to("meta") for t in (ts, gid, vals)]
    acc_meta = {k: v.to("meta") for k, v in acc.items()}
    with pytest.raises(Error, match="cuda or cpu"):
        read.fused_round_accumulate(
            acc_meta, *meta, None, None, None, np.zeros(2, np.int32), 4, 100,
            num_groups=2, width=4, which=("avg",),
            n_valid=torch.from_numpy(nv).to("meta"), n_valid_host=nv)


def test_round_entry_refuses_host_row_counts_without_device_ones():
    """n_valid_host bounds the round's columns; without the n_valid it
    copies the kernel would read rows those columns leave out."""
    ts, gid, vals, nv = _round()
    acc = read.fused_acc_init(num_groups=2, num_buckets=4, which=("last",),
                              device="cpu")
    with pytest.raises(Error, match="n_valid_host needs the n_valid"):
        bucket_agg.bucket_round_accumulate(
            acc, ts, gid, vals, None, None, None, 4, 100, num_groups=2,
            width=4, which=("last",), lo_host=np.zeros(2, np.int32),
            n_valid_host=nv)


@pytest.mark.parametrize("which", [("avg",), ALL_AGGS],
                         ids=lambda w: "-".join(w))
def test_fused_reader_sends_each_round_through_the_round_entry(monkeypatch,
                                                               which):
    """One bucket_round_accumulate call per fused round, each with its
    windows' row counts as an int32 (W,) tensor beside the same counts
    on the host; the reader never computes partial grids itself (on the
    card, chip_smoke.py checks that the fused path launches no
    partial-grid kernel).  On the CPU the partial-grid entry dispatches
    to its plain twin, so both are patched: the twin may run only inside
    the round entry, whose plain version builds on it."""
    calls = []
    entry = bucket_agg.bucket_round_accumulate
    plain = bucket_agg.bucket_window_partials_plain
    inside = {"round": False}

    def spy(acc, ts, *args, **kw):
        calls.append((tuple(ts.shape), kw["n_valid"], kw["n_valid_host"]))
        inside["round"] = True
        try:
            return entry(acc, ts, *args, **kw)
        finally:
            inside["round"] = False

    def boom(*_a, **_k):
        raise AssertionError("the fused reader called the partial-grid entry")

    def plain_in_round_only(*a, **k):
        if not inside["round"]:
            raise AssertionError("the fused reader computed partial grids "
                                 "outside the round entry")
        return plain(*a, **k)

    monkeypatch.setattr(bucket_agg, "bucket_round_accumulate", spy)
    monkeypatch.setattr(bucket_agg, "bucket_window_partials", boom)
    monkeypatch.setattr(bucket_agg, "bucket_window_partials_plain",
                        plain_in_round_only)
    hosts, ticks, batch_w = 8, 3 * 720, 3
    cfg = from_dict(StorageConfig, {"scan": {
        "max_window_rows": 2000, "agg_batch_windows": batch_w}})
    ts = T0 + np.repeat(np.arange(ticks, dtype=np.int64) * 10_000, hosts)
    host = np.tile(np.arange(hosts, dtype=np.int32), ticks)
    names = pa.array([f"host_{i}" for i in range(hosts)])
    batch = pa.record_batch({
        "host": pa.DictionaryArray.from_arrays(pa.array(host), names),
        "timestamp": pa.array(ts),
        "value": pa.array(np.arange(len(ts), dtype=np.float64))})

    async def run():
        e = await MetricEngine.open("t", MemoryObjectStore(), segment_ms=SEG,
                                    config=cfg, device="cpu")
        try:
            await e.write_arrow("cpu", ["host"], batch)
            out = await e.query_downsample(
                "cpu", [], TimeRange.new(T0, T0 + ticks * 10_000), 60_000,
                aggs=which)
            windows = [w for ws in e.tables["data"].reader.scan_cache.values()
                       for w in ws]
            return out, windows
        finally:
            await e.close()

    out, windows = asyncio.run(run())
    assert len(windows) > batch_w  # several rounds
    assert len(calls) == math.ceil(len(windows) / batch_w)
    for shape, nv, nv_host in calls:
        assert nv.dtype == torch.int32 and tuple(nv.shape) == (shape[0],)
        np.testing.assert_array_equal(nv.numpy(), nv_host)
    got = sorted(int(n) for _s, nv, _h in calls for n in nv if n > 0)
    assert got == sorted(w.n_valid for w in windows)
    assert float(out["aggs"]["count"].sum()) == float(hosts * ticks)
