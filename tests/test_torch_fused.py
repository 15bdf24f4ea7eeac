"""The port's fused device steps (acc init -> rounds -> finalize,
storage/read.py) against the JAX package's _fused_acc_init_jit ->
_fused_round_accumulate_jit -> _fused_finalize_jit on the same seeded
round stacks: three rounds whose windows overlap in bucket range, with
`last` ties inside a round and across rounds (the later window wins).

Tolerances: count/min/max/last/last_ts exact, sum/avg within rtol 1e-5
(window partial sums fold into the accumulator in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horaedb_tpu.storage import read as ref_read
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.storage import read as port_read

BUCKET = 60_000


def _rounds(seed: int, n_rounds: int, W: int, cap: int, G: int, width: int,
            total: int):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(n_rounds):
        ts = rng.integers(-BUCKET, (width + 2) * BUCKET,
                          (W, cap)).astype(np.int32)
        gid = rng.integers(-1, 6, (W, cap)).astype(np.int32)
        vals = (rng.random((W, cap)) * 100 - 50).astype(np.float32)
        remap = np.stack([rng.permutation(G).astype(np.int32)
                          for _ in range(W)])
        shift = rng.integers(0, 3 * BUCKET, W).astype(np.int32)
        # overlapping bucket ranges: every window starts within a few
        # buckets of the others, and some reach past `total`
        lo = rng.integers(0, 6, W).astype(np.int32)
        if r == 0:
            lo[:] = 2  # same span for the whole round
        # a cell whose max ts is shared by every window of every round:
        # local group 0 -> union row 1, the last ms of global bucket 5,
        # on each window's last row (tie across windows and rounds)
        for d in range(W):
            remap[d, 0] = 1
            ts[d, cap - 1] = 6 * BUCKET - 1 - int(shift[d])
            gid[d, cap - 1] = 0
            vals[d, cap - 1] = 1000.0 * (r + 1) + d
        out.append((ts, gid, vals, remap, shift, lo))
    return out


@pytest.mark.parametrize("which", [ALL_AGGS, ("avg",), ("last", "max")],
                         ids=lambda w: "-".join(w))
def test_fused_rounds_match_reference(which):
    G, W, cap, width, total = 8, 4, 512, 16, 20
    which = tuple(sorted(set(which)))
    rounds = _rounds(7, 3, W, cap, G, width, total)

    acc_r = ref_read._fused_acc_init_jit(num_groups=G, num_buckets=total,
                                         which=which)
    for ts, gid, vals, remap, shift, lo in rounds:
        acc_r = ref_read._fused_round_accumulate_jit(
            acc_r, jnp.asarray(ts), jnp.asarray(gid), jnp.asarray(vals),
            jnp.asarray(remap), jnp.asarray(shift), jnp.asarray(lo),
            jnp.int32(total), jnp.int32(BUCKET), num_groups=G, width=width,
            which=which)
    ref = {k: np.asarray(v) for k, v in
           ref_read._fused_finalize_jit(acc_r, which).items()}

    t = torch.from_numpy
    acc = port_read.fused_acc_init(num_groups=G, num_buckets=total,
                                   which=which, device="cpu")
    for ts, gid, vals, remap, shift, lo in rounds:
        port_read.fused_round_accumulate(
            acc, t(ts), t(gid), t(vals), t(remap), t(shift), t(lo), lo,
            total, BUCKET, num_groups=G, width=width, which=which)
    got = {k: v.numpy() for k, v in
           port_read.fused_finalize(acc, which).items()}

    assert sorted(got) == sorted(ref)
    for k in ref:
        if k in ("sum", "avg"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if "last" in which:
        # the shared max-ts cell: the last window of the last round wins
        assert got["last"][1, 5] == 1000.0 * 3 + (W - 1)
    has_r = np.asarray(ref_read._group_has_data_jit(jnp.asarray(ref["count"])))
    has = port_read.group_has_data(torch.from_numpy(got["count"])).numpy()
    np.testing.assert_array_equal(has, has_r)


def _nan_inf_rounds(W: int, cap: int, G: int):
    """Two rounds with +NaN and -NaN in different cells, a cell holding
    only +inf and one holding only -inf (identity remap, no shift);
    window 1 (lo 2) and round 2 add finite values to the NaN cells.
    Rows past each window's n_valid carry gid -1."""
    rng = np.random.default_rng(5)
    nan_p = np.uint32(0x7FC00000).view(np.float32)
    nan_n = np.uint32(0xFFC00000).view(np.float32)
    # (round, window, group, global bucket, values)
    special = [(0, 0, 1, 2, [1.0, nan_p, 3.0, 2.0]),
               (0, 0, 2, 3, [5.0, nan_n, 4.0, 6.0]),
               (0, 0, 3, 4, [np.inf, np.inf]),
               (0, 0, 4, 5, [-np.inf]),
               (0, 1, 1, 2, [9.0]),
               (1, 0, 2, 3, [-7.0])]
    lo = np.array([0, 2], np.int32)
    out = []
    for r in range(2):
        # random rows in groups 5.. only: the special cells stay as set
        ts = rng.integers(0, 6 * BUCKET, (W, cap)).astype(np.int32)
        gid = rng.integers(5, G, (W, cap)).astype(np.int32)
        vals = (rng.random((W, cap)) * 100 - 50).astype(np.float32)
        n_valid = np.array([cap, cap - 37], np.int32)
        for rr, w, g, b, vs in special:
            if rr != r:
                continue
            for k, v in enumerate(vs):
                row = 11 + 29 * k + 3 * b
                ts[w, row] = b * BUCKET + k
                gid[w, row] = g
                vals[w, row] = v
        gid[np.arange(cap)[None, :] >= n_valid[:, None]] = -1
        out.append((ts, gid, vals, np.tile(np.arange(G, dtype=np.int32),
                                           (W, 1)),
                    np.zeros(W, np.int32), lo, n_valid))
    return out


@pytest.mark.parametrize("which", [ALL_AGGS, ("min", "max")],
                         ids=lambda w: "-".join(w))
def test_fused_nan_inf_rounds_match_reference(which):
    """NaN makes the accumulator's min and max NaN, whatever its sign and
    whatever finite values later windows and rounds fold in; a non-empty
    +inf-only cell reads min F32_MAX (the accumulator's identity wins the
    fold) and a -inf-only cell max -F32_MAX, in the reference and the
    port alike."""
    G, W, cap, width, total = 8, 2, 256, 8, 12
    which = tuple(sorted(set(which)))
    rounds = _nan_inf_rounds(W, cap, G)

    acc_r = ref_read._fused_acc_init_jit(num_groups=G, num_buckets=total,
                                         which=which)
    for ts, gid, vals, remap, shift, lo, _nv in rounds:
        acc_r = ref_read._fused_round_accumulate_jit(
            acc_r, jnp.asarray(ts), jnp.asarray(gid), jnp.asarray(vals),
            jnp.asarray(remap), jnp.asarray(shift), jnp.asarray(lo),
            jnp.int32(total), jnp.int32(BUCKET), num_groups=G, width=width,
            which=which)
    ref = {k: np.asarray(v) for k, v in
           ref_read._fused_finalize_jit(acc_r, which).items()}

    t = torch.from_numpy
    acc = port_read.fused_acc_init(num_groups=G, num_buckets=total,
                                   which=which, device="cpu")
    for ts, gid, vals, remap, shift, lo, nv in rounds:
        port_read.fused_round_accumulate(
            acc, t(ts), t(gid), t(vals), t(remap), t(shift), t(lo), lo,
            total, BUCKET, num_groups=G, width=width, which=which,
            n_valid=t(nv), n_valid_host=nv)
    got = {k: v.numpy() for k, v in
           port_read.fused_finalize(acc, which).items()}

    assert sorted(got) == sorted(ref)
    for k in ref:
        if k in ("sum", "avg"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    f32_max = np.finfo(np.float32).max
    for grids in (ref, got):
        for f in ("min", "max"):
            assert np.isnan(grids[f][1, 2]) and np.isnan(grids[f][2, 3]), f
        assert grids["count"][3, 4] == 2 and grids["min"][3, 4] == f32_max
        assert grids["count"][4, 5] == 1 and grids["max"][4, 5] == -f32_max


def test_fused_acc_init_identities_match_reference():
    which = tuple(sorted(ALL_AGGS))
    ref = ref_read._fused_acc_init_jit(num_groups=8, num_buckets=5,
                                       which=which)
    got = port_read.fused_acc_init(num_groups=8, num_buckets=5,
                                   which=which, device="cpu")
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        assert got[k].numpy().dtype == np.asarray(ref[k]).dtype


NAN_T0, NAN_SEG, NAN_HOUR = 1_699_999_200_000, 2 * 3600_000, 3600_000
# the float64 NaN samples as written: numpy's quiet NaN and its negative
POS_NAN = float("nan")
NEG_NAN = float(np.array([0xFFF8000000000000], np.uint64).view(np.float64)[0])


def _nan_grids(route: str, nan_value: float) -> tuple:
    """One series, values [1, NaN, 3, 2] at T0 + [0, 1 s, 2 s, 70 min],
    min and max at 1 h over one 2 h segment, through both packages'
    engines on `route`: "fused", "parts" (host decode) or "decode" (the
    parts route with [scan.decode] mode = "device").  Returns (port,
    reference) dicts of numpy grids."""
    import asyncio

    import pyarrow as pa

    from horaedb_tpu.metric_engine import MetricEngine as RefEngine
    from horaedb_tpu.objstore import MemoryObjectStore as RefStore
    from horaedb_tpu.storage.config import StorageConfig as RefConfig
    from horaedb_tpu.storage.types import TimeRange as RefRange
    from horaedb_tpu_torch.metric_engine import MetricEngine as PortEngine
    from horaedb_tpu_torch.objstore import MemoryObjectStore as PortStore
    from horaedb_tpu_torch.storage.config import StorageConfig as PortConfig
    from horaedb_tpu_torch.storage.types import TimeRange as PortRange

    batch = pa.record_batch({
        "host": pa.array(["a"] * 4),
        "timestamp": pa.array(NAN_T0 + np.array([0, 1000, 2000, 4_200_000])),
        "value": pa.array([1.0, nan_value, 3.0, 2.0])})

    async def run(engine_cls, store_cls, range_cls, config_cls, **kw):
        config = config_cls()
        if route == "decode":
            config.scan.decode.mode = "device"
        e = await engine_cls.open("t", store_cls(), segment_ms=NAN_SEG,
                                  config=config, **kw)
        try:
            await e.write_arrow("cpu", ["host"], batch)
            out = await e.query_downsample(
                "cpu", [], range_cls.new(NAN_T0, NAN_T0 + NAN_SEG),
                NAN_HOUR, aggs=("min", "max"))
        finally:
            await e.close()
        return {k: np.asarray(v.cpu().numpy() if hasattr(v, "cpu") else v)
                for k, v in out["aggs"].items()}

    ref = asyncio.run(run(RefEngine, RefStore, RefRange, RefConfig))
    got = asyncio.run(run(PortEngine, PortStore, PortRange, PortConfig,
                          device="cpu"))
    return got, ref


def _nan_bits(grid) -> int:
    return int(np.asarray(grid, np.float32)[:, :1].view(np.uint32)[0, 0])


@pytest.mark.parametrize("sample,bits", [(POS_NAN, 0x7FC00000),
                                         (NEG_NAN, 0xFFC00000)],
                         ids=["nan", "neg_nan"])
@pytest.mark.parametrize("route", ["fused", "parts", "decode"])
def test_nan_min_max_bits_match_reference(monkeypatch, route, sample, bits):
    """A NaN sample makes its cell's min and max NaN with the reference's
    bits, its own sign kept (the quiet NaN 0x7fc00000, or 0xffc00000 for
    a negative NaN sample), on the fused route and on the parts route
    with host and with device decode: the grids' bytes are compared, not
    their values (NaN equals NaN under assert_array_equal whatever its
    bits).  tests/test_torch_nan_sign.py holds the rule on every route
    and placement."""
    monkeypatch.setenv("HORAEDB_FUSED_AGG", "1" if route == "fused" else "0")
    monkeypatch.setenv("HORAEDB_HOST_AGG", "0")
    got, ref = _nan_grids(route, sample)
    for k in ("min", "max"):
        assert np.isnan(got[k][0, 0]), k
        assert got[k].dtype == ref[k].dtype, k
        assert got[k].tobytes() == ref[k].tobytes(), k
        assert _nan_bits(got[k]) == bits, k
