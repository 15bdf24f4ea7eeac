"""The port's time-bucket aggregate (ops/bucket_agg.py plain version and
ops/downsample.py) against the JAX package on the same numpy-seeded
inputs: the XLA path, the Pallas kernel in interpret mode, and the
Pallas window partials fed the fused-decode prologue.

Tolerances: count/min/max/last/last_ts exact (selections and integer
counts), sum/avg within rtol 1e-5 (f32 sums in another order)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horaedb_tpu.ops import downsample as ref_ds
from horaedb_tpu.ops.pallas_kernels import (
    pallas_time_bucket_aggregate,
    pallas_window_partials,
)
from horaedb_tpu_torch.ops import bucket_agg
from horaedb_tpu_torch.ops import downsample as port_ds

BUCKET = 60_000


def _assert_grids(got: dict, ref: dict, keys=None):
    keys = sorted(ref) if keys is None else keys
    assert sorted(got) == sorted(ref)
    for k in keys:
        g = np.asarray(got[k])
        r = np.asarray(ref[k])
        assert g.shape == r.shape, k
        if k in ("sum", "avg"):
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=k)
        else:
            # exact, NaN/inf identities included
            np.testing.assert_array_equal(g, r, err_msg=k)


def _case(name: str):
    """(ts, gid, vals, n_valid, G, B) for a named case."""
    cases = {
        # the cases of tests/test_pallas.py
        "p0": (0, 500, 7, 11), "p1": (1, 2000, 16, 32),
        "p2": (2, 100, 1, 1), "p3": (3, 1500, 3, 200),
    }
    if name in cases:
        seed, n, G, B = cases[name]
        rng = np.random.default_rng(seed)
        cap = port_ds_pad(n)
        ts = np.pad(rng.integers(0, B * BUCKET, n).astype(np.int32),
                    (0, cap - n))
        gid = np.pad(rng.integers(0, G, n).astype(np.int32), (0, cap - n))
        vals = np.pad((rng.random(n) * 100).astype(np.float32), (0, cap - n))
        return ts, gid, vals, n, G, B
    rng = np.random.default_rng(11)
    if name == "tie_across_blocks":
        # cap > 1024: every valid row shares (group, ts); the last valid
        # row sits in the second 1024-row block and must win
        cap, n = 2048, 1029
        return (np.zeros(cap, np.int32), np.zeros(cap, np.int32),
                np.arange(cap, dtype=np.float32), n, 1, 1)
    if name == "oversized_gid":
        cap, n, G, B = 256, 200, 4, 6
        gid = rng.integers(0, G, cap).astype(np.int32)
        gid[[0, 5, 9]] = [2**30, G, G + 3]
        ts = rng.integers(0, B * BUCKET, cap).astype(np.int32)
        return ts, gid, (rng.random(cap) * 5).astype(np.float32), n, G, B
    if name == "negative_ts":
        cap, n, G, B = 512, 400, 5, 8
        ts = rng.integers(-3 * BUCKET, B * BUCKET, cap).astype(np.int32)
        ts[:4] = [-1, -BUCKET, -BUCKET - 1, 0]
        gid = rng.integers(0, G, cap).astype(np.int32)
        return ts, gid, (rng.random(cap) * 5).astype(np.float32), n, G, B
    if name == "past_total":
        cap, n, G, B = 512, 512, 3, 4
        ts = rng.integers(0, 3 * B * BUCKET, cap).astype(np.int32)
        gid = rng.integers(0, G, cap).astype(np.int32)
        return ts, gid, (rng.random(cap) * 5).astype(np.float32), n, G, B
    if name == "nan_inf":
        # +NaN and -NaN in different cells among finite values, a cell
        # holding only +inf and one holding only -inf (Prometheus
        # staleness markers are NaN); random rows stay out of those cells
        cap, n, G, B = 512, 400, 5, 6
        ts = rng.integers(0, B * BUCKET, cap).astype(np.int32)
        gid = rng.integers(0, G, cap).astype(np.int32)
        vals = (rng.random(cap) * 5).astype(np.float32)
        hit = np.isin(gid * B + ts // BUCKET,
                      [g * B + b for g, b in NAN_INF_CELLS])
        ts[hit] = ts[hit] % BUCKET  # bucket 0 holds no special cell
        row = 3
        for (g, b), vs in NAN_INF_CELLS.items():
            for k, v in enumerate(vs):
                ts[row], gid[row], vals[row] = b * BUCKET + k, g, v
                row += 31
        return ts, gid, vals, n, G, B
    raise KeyError(name)


# (group, bucket) -> values of the nan_inf case
NAN_INF_CELLS = {
    (1, 2): [1.0, np.uint32(0x7FC00000).view(np.float32), 3.0, 2.0],
    (2, 3): [5.0, np.uint32(0xFFC00000).view(np.float32), 4.0, 6.0],
    (3, 4): [np.inf, np.inf],
    (4, 5): [-np.inf],
}


def port_ds_pad(n: int) -> int:
    from horaedb_tpu_torch.ops.encode import pad_capacity

    return pad_capacity(n)


CASES = ["p0", "p1", "p2", "p3", "tie_across_blocks", "oversized_gid",
         "negative_ts", "past_total", "nan_inf"]
WHICHES = [port_ds.ALL_AGGS, ("avg",), ("last", "min"), ("count", "max")]


@pytest.mark.parametrize("which", WHICHES, ids=lambda w: "-".join(w))
@pytest.mark.parametrize("case", CASES)
def test_time_bucket_aggregate_matches_xla_and_pallas(case, which):
    ts, gid, vals, n, G, B = _case(case)
    got = port_ds.partials_to_numpy(port_ds.time_bucket_aggregate(
        ts, gid, vals, n, BUCKET, G, B, which=which, device="cpu"))
    args = (jnp.asarray(ts), jnp.asarray(gid), jnp.asarray(vals), n, BUCKET)
    xla = ref_ds.time_bucket_aggregate(*args, num_groups=G, num_buckets=B,
                                       which=which)
    _assert_grids(got, {k: np.asarray(v) for k, v in xla.items()})
    pallas = {k: np.array(v) for k, v in pallas_time_bucket_aggregate(
        *args, num_groups=G, num_buckets=B, which=which,
        interpret=True).items()}
    if case == "nan_inf":
        # the Pallas kernel folds into +/-F32_MAX, not +/-inf, so its
        # +inf-only (-inf-only) cell reads min F32_MAX (max -F32_MAX)
        # where its own XLA path reads +inf (-inf); the port follows XLA
        f32_max = np.finfo(np.float32).max
        for f, cell, sign in (("min", (3, 4), 1), ("max", (4, 5), -1)):
            if f in pallas:
                assert pallas[f][cell] == sign * f32_max
                pallas[f][cell] = sign * np.inf
    _assert_grids(got, pallas)
    if case == "tie_across_blocks" and "last" in which:
        assert float(got["last"][0, 0]) == float(n - 1)
    if case == "oversized_gid":
        assert float(got["count"].sum()) == float(
            np.sum((gid[:n] >= 0) & (gid[:n] < G)))
    if case == "nan_inf":
        # a NaN makes its cell's min and max NaN, whatever its sign; a
        # non-empty +inf-only (-inf-only) cell reads min +inf (max -inf)
        for f in ("min", "max"):
            if f in got:
                assert np.isnan(got[f][1, 2]) and np.isnan(got[f][2, 3]), f
        if "min" in got:
            assert got["min"][3, 4] == np.inf and got["count"][3, 4] == 2
        if "max" in got:
            assert got["max"][4, 5] == -np.inf and got["count"][4, 5] == 1


def test_every_which_subset_matches_xla():
    """All 63 aggregate subsets: the reference side is the XLA partial
    over every aggregate, finalized per subset (the reference's own
    finalize emits exactly the requested grids plus count)."""
    ts, gid, vals, n, G, B = _case("p1")
    full = ref_ds.partial_aggregate(jnp.asarray(ts), jnp.asarray(gid),
                                    jnp.asarray(vals), n, BUCKET, G, B)
    for r in range(1, len(port_ds.ALL_AGGS) + 1):
        for which in itertools.combinations(port_ds.ALL_AGGS, r):
            got = port_ds.partials_to_numpy(port_ds.time_bucket_aggregate(
                ts, gid, vals, n, BUCKET, G, B, which=which, device="cpu"))
            ref = ref_ds.finalize_aggregate(full, which=which)
            _assert_grids(got, {k: np.asarray(v) for k, v in ref.items()})


def _windows(seed: int, W: int, cap: int, R: int, width: int, total: int):
    rng = np.random.default_rng(seed)
    ts = rng.integers(-2 * BUCKET, (width + 3) * BUCKET,
                      (W, cap)).astype(np.int32)
    gid = rng.integers(-1, R + 2, (W, cap)).astype(np.int32)
    vals = (rng.random((W, cap)) * 50).astype(np.float32)
    # a max-ts tie run across the 1024-row Pallas block boundary
    ts[:, 1020:1030] = 2 * BUCKET + 7
    gid[:, 1020:1030] = 1
    remap = np.stack([rng.permutation(R).astype(np.int32)
                      for _ in range(W)])
    shift = rng.integers(-BUCKET, BUCKET, W).astype(np.int32)
    lo = rng.integers(0, max(1, total - width), W).astype(np.int32)
    return ts, gid, vals, remap, shift, lo


@pytest.mark.parametrize("which", [port_ds.ALL_AGGS, ("avg",)],
                         ids=lambda w: "-".join(w))
def test_window_partials_match_window_local_partials(which):
    """Remapped windows: the plain version against the JAX package's
    window_local_partials, window by window."""
    W, cap, R, width, total = 3, 2048, 8, 16, 40
    ts, gid, vals, remap, shift, lo = _windows(3, W, cap, R, width, total)
    t = torch.from_numpy
    got = port_ds.partials_to_numpy(bucket_agg.bucket_window_partials(
        t(ts), t(gid), t(vals), t(remap), t(shift), t(lo), total, BUCKET,
        num_groups=R, width=width, which=which))
    for d in range(W):
        ref = ref_ds.window_local_partials(
            jnp.asarray(ts[d]), jnp.asarray(gid[d]), jnp.asarray(vals[d]),
            jnp.asarray(remap[d]), int(shift[d]), int(lo[d]), total, BUCKET,
            num_groups=R, num_buckets=width, which=which)
        _assert_grids({k: v[d] for k, v in got.items()},
                      {k: np.asarray(v) for k, v in ref.items()})
        one = port_ds.partials_to_numpy(port_ds.window_local_partials(
            t(ts[d]), t(gid[d]), t(vals[d]), t(remap[d]), int(shift[d]),
            int(lo[d]), total, BUCKET, num_groups=R, num_buckets=width,
            which=which))
        _assert_grids(one, {k: np.asarray(v) for k, v in ref.items()})


@pytest.mark.parametrize("which", [port_ds.ALL_AGGS, ("avg",)],
                         ids=lambda w: "-".join(w))
def test_window_partials_match_pallas_window_partials(which):
    """Identity-remapped windows (gids past the grid dropped, not
    clipped) against pallas_window_partials fed the prologue of
    ops/device_decode.py's fused dispatch."""
    W, cap, G, width, total = 2, 2048, 8, 16, 40
    ts, gid, vals, _remap, shift, lo = _windows(4, W, cap, G, width, total)
    gid[0, 3] = 2**30
    t = torch.from_numpy
    got = port_ds.partials_to_numpy(bucket_agg.bucket_window_partials(
        t(ts), t(gid), t(vals), None, t(shift), t(lo), total, BUCKET,
        num_groups=G, width=width, which=which))
    for d in range(W):
        shift32 = jnp.int32(int(shift[d]))
        lo32 = jnp.int32(int(lo[d]))
        b32 = jnp.int32(BUCKET)
        ts_s = jnp.asarray(ts[d])
        g = jnp.where((ts_s + shift32) // b32 < jnp.int32(total),
                      jnp.asarray(gid[d]), -1)
        ref = pallas_window_partials(ts_s + shift32 - lo32 * b32, g,
                                     jnp.asarray(vals[d]), cap, b32,
                                     num_groups=G, num_buckets=width,
                                     which=which, interpret=True)
        _assert_grids({k: v[d] for k, v in got.items()},
                      {k: np.asarray(v) for k, v in ref.items()})


def test_partials_numpy_round_trip():
    ts, gid, vals, n, G, B = _case("p0")
    ref = ref_ds.partial_aggregate(jnp.asarray(ts), jnp.asarray(gid),
                                   jnp.asarray(vals), n, BUCKET, G, B)
    grids = {k: np.asarray(v) for k, v in ref.items()}
    back = port_ds.partials_to_numpy(port_ds.partials_from_numpy(grids))
    _assert_grids(back, grids)
    got = port_ds.partial_aggregate(torch.from_numpy(ts),
                                    torch.from_numpy(gid),
                                    torch.from_numpy(vals), n, BUCKET, G, B)
    _assert_grids(port_ds.partials_to_numpy(got), grids)
