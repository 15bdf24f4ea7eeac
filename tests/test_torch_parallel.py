"""The PyTorch port's mesh programs (horaedb_tpu_torch/parallel/scan.py
and the device merge-dedup of ops/merge.py) against their
horaedb_tpu.parallel.scan twins, on the CPU.

The JAX package runs on its 8 virtual CPU devices, the port on a mesh of
8 `cpu` entries (one device named eight times: the slots are logical),
with the same seeded numpy inputs.  Contract: count, min, max, last and
last_ts byte-equal; sum and avg within rtol 1e-5 (each window's float32
sum may add in another order).  Also: the `last` tie across shards goes
to the higher rank, the segmented combine equals its own prefix fold
byte for byte, and on a mesh that repeats one device no program writes
a tensor another slot reads (the aliasing case: `t.to(same_device)` is
the same tensor, not a copy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horaedb_tpu.ops import merge as ref_merge
from horaedb_tpu.parallel import mesh as ref_mesh
from horaedb_tpu.parallel import scan as ref_scan
from horaedb_tpu_torch.common import Error
from horaedb_tpu_torch.ops import merge as port_merge
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.parallel import mesh as port_mesh
from horaedb_tpu_torch.parallel import scan as port_scan

NDEV = 8
CAP = 256
G, B = 5, 7
BUCKET = 60_000
CPU8 = ["cpu"] * NDEV
EXACT = ("count", "min", "max", "last", "last_ts")


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= NDEV
    return ref_mesh.segment_mesh(NDEV), port_mesh.segment_mesh(
        NDEV, devices=CPU8)


@pytest.fixture(scope="module")
def meshes2():
    return ref_mesh.scan_mesh(4, 2), port_mesh.scan_mesh(4, 2, devices=CPU8)


def _np(x):
    if isinstance(x, port_scan.ShardedArray):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _agree(ref: dict, port: dict, ctx=""):
    assert set(ref) == set(port), (ctx, set(ref), set(port))
    for k in ref:
        a, b = _np(ref[k]), _np(port[k])
        assert a.shape == b.shape, (ctx, k, a.shape, b.shape)
        if k in EXACT:
            assert a.tobytes() == b.astype(a.dtype).tobytes(), (ctx, k)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, err_msg=f"{ctx} {k}")


def make_shards(rng):
    ts = rng.integers(0, B * BUCKET, (NDEV, CAP)).astype(np.int32)
    gid = rng.integers(0, G, (NDEV, CAP)).astype(np.int32)
    vals = (rng.random((NDEV, CAP)) * 100).astype(np.float32)
    n_valid = rng.integers(1, CAP + 1, NDEV).astype(np.int32)
    return ts, gid, vals, n_valid


class TestShardedDownsample:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_the_jax_program(self, meshes, seed):
        ref_m, port_m = meshes
        ts, gid, vals, n_valid = make_shards(np.random.default_rng(seed))
        rf, rv, ri = ref_scan.sharded_downsample_query(
            ref_m, num_groups=G, num_buckets=B, k=3)(
            *(ref_scan.shard_leading_axis(ref_m, a)
              for a in (ts, gid, vals, n_valid)),
            jnp.asarray([BUCKET], dtype=jnp.int32))
        pf, pv, pi = port_scan.sharded_downsample_query(
            port_m, num_groups=G, num_buckets=B, k=3)(
            *(port_scan.shard_leading_axis(port_m, a)
              for a in (ts, gid, vals)), n_valid, BUCKET)
        _agree(rf, pf, f"seed {seed}")
        assert _np(ri).tolist() == _np(pi).tolist()
        np.testing.assert_allclose(_np(pv), _np(rv), rtol=1e-6)

    def test_last_cross_shard_and_tie(self, meshes):
        """`last` comes from the shard holding the latest timestamp; on
        a tie the higher rank wins — in both packages."""
        ref_m, port_m = meshes
        for tie in (False, True):
            ts = np.zeros((NDEV, CAP), dtype=np.int32)
            gid = np.zeros((NDEV, CAP), dtype=np.int32)
            vals = np.zeros((NDEV, CAP), dtype=np.float32)
            n_valid = np.ones(NDEV, dtype=np.int32)
            for d in range(NDEV):
                ts[d, 0] = 5000 if tie else d * 1000
                vals[d, 0] = float(d + 1) * 10
            rf, _, _ = ref_scan.sharded_downsample_query(
                ref_m, num_groups=1, num_buckets=1, k=1)(
                *(ref_scan.shard_leading_axis(ref_m, a)
                  for a in (ts, gid, vals, n_valid)),
                jnp.asarray([10**9], dtype=jnp.int32))
            pf, _, _ = port_scan.sharded_downsample_query(
                port_m, num_groups=1, num_buckets=1, k=1)(
                ts, gid, vals, n_valid, 10**9)
            assert float(_np(pf["last"])[0, 0]) == 80.0
            assert _np(pf["last"]).tobytes() == _np(rf["last"]).tobytes()
            assert float(_np(pf["count"])[0, 0]) == NDEV

    def test_oversubscribed_leading_axis_raises(self, meshes):
        _ref_m, port_m = meshes
        fn = port_scan.sharded_downsample_query(port_m, num_groups=2,
                                                num_buckets=2, k=1)
        big = np.zeros((NDEV * 2, CAP), dtype=np.int32)
        with pytest.raises(Error, match="leading axis"):
            fn(big, big, big.astype(np.float32),
               np.ones(NDEV * 2, dtype=np.int32), 1000)

    def test_mesh_too_few_devices_raises(self):
        with pytest.raises(Error, match="devices are available"):
            port_mesh.segment_mesh(1000, devices=CPU8)


class TestShardedRemapPartials:
    def test_window_local_grids_match_the_jax_program(self, meshes):
        ref_m, port_m = meshes
        rng = np.random.default_rng(2)
        W, total = 4, 20
        ts = rng.integers(0, W * BUCKET, (NDEV, CAP)).astype(np.int32)
        gid = rng.integers(-1, 3, (NDEV, CAP)).astype(np.int32)
        vals = (rng.random((NDEV, CAP)) * 10).astype(np.float32)
        lo = (np.arange(NDEV, dtype=np.int32) * 3) % (total + 2)
        shift = (lo * BUCKET).astype(np.int32)
        remap = np.pad(np.tile(np.asarray([2, 0, 1], dtype=np.int32),
                               (NDEV, 1)), ((0, 0), (0, 5)))
        for which in (ALL_AGGS, ("min", "max"), ("avg",)):
            ref = ref_scan.sharded_remap_partials(
                ref_m, num_groups=8, num_buckets=W, which=which)(
                *(ref_scan.shard_leading_axis(ref_m, a)
                  for a in (ts, gid, vals, remap, shift, lo)),
                jnp.int32(total), jnp.asarray([BUCKET], dtype=jnp.int32))
            port = port_scan.sharded_remap_partials(
                port_m, num_groups=8, num_buckets=W, which=which)(
                ts, gid, vals, remap, shift, lo, total, BUCKET)
            _agree(ref, port, str(which))
            assert _np(port["count"]).shape == (NDEV, 8, W)


def _merge_inputs(seed):
    rng = np.random.default_rng(seed)
    pk0 = rng.integers(0, 4, CAP).astype(np.int32)
    pk1 = rng.integers(0, 6, CAP).astype(np.int32)
    seq = rng.permutation(CAP).astype(np.int32)
    val = rng.random(CAP).astype(np.float32)
    n_valid = int(rng.integers(1, CAP + 1))
    return (pk0, pk1), seq, val, n_valid


class TestMergeDedup:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("seq_in_row_order", [False, True])
    def test_merge_dedup_last_matches(self, seed, seq_in_row_order):
        pks, seq, val, n = _merge_inputs(seed)
        if seq_in_row_order:
            seq = np.arange(CAP, dtype=np.int32)
        ref = ref_merge.merge_dedup_last(
            tuple(jnp.asarray(c) for c in pks), jnp.asarray(seq),
            (jnp.asarray(val),), n, seq_in_row_order=seq_in_row_order)
        port = port_merge.merge_dedup_last(
            tuple(torch.from_numpy(c) for c in pks), torch.from_numpy(seq),
            (torch.from_numpy(val),), n, seq_in_row_order=seq_in_row_order)
        r_pks, r_seq, r_vals, r_valid, r_runs = ref
        p_pks, p_seq, p_vals, p_valid, p_runs = port
        assert int(r_runs) == int(p_runs)
        # every output row, padding included, is the JAX program's
        for a, b in zip(r_pks + (r_seq,) + r_vals + (r_valid,),
                        p_pks + (p_seq,) + p_vals + (p_valid,)):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()

    @pytest.mark.parametrize("seed", [0, 3])
    @pytest.mark.parametrize("with_perm", [False, True])
    def test_dedup_sorted_last_and_run_starts(self, seed, with_perm):
        pks, seq, val, n = _merge_inputs(seed)
        order = np.lexsort((seq[:n], pks[1][:n], pks[0][:n]))
        perm = np.concatenate([order, np.arange(n, CAP)]).astype(np.int32)
        if not with_perm:
            pks = tuple(c[perm] for c in pks)
            seq, val = seq[perm], val[perm]
        ref = ref_merge.dedup_sorted_last(
            tuple(jnp.asarray(c) for c in pks), jnp.asarray(seq),
            (jnp.asarray(val),), n,
            perm=jnp.asarray(perm) if with_perm else None)
        port = port_merge.dedup_sorted_last(
            tuple(torch.from_numpy(c) for c in pks), torch.from_numpy(seq),
            (torch.from_numpy(val),), n,
            perm=torch.from_numpy(perm) if with_perm else None)
        assert int(ref[4]) == int(port[4])
        for a, b in zip(ref[0] + (ref[1],) + ref[2] + (ref[3],),
                        port[0] + (port[1],) + port[2] + (port[3],)):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()
        valid = np.arange(CAP) < n
        r_starts = ref_merge.sorted_run_starts(
            tuple(jnp.asarray(c) for c in pks), jnp.asarray(valid))
        p_starts = port_merge.sorted_run_starts(
            tuple(torch.from_numpy(c) for c in pks), torch.from_numpy(valid))
        assert np.asarray(r_starts).tolist() == p_starts.tolist()

    def test_sharded_merge_dedup_matches(self, meshes):
        ref_m, port_m = meshes
        rng = np.random.default_rng(7)
        pk = rng.integers(0, 16, (NDEV, CAP)).astype(np.int32)
        seq = np.stack([rng.permutation(CAP)
                        for _ in range(NDEV)]).astype(np.int32)
        val = rng.random((NDEV, CAP)).astype(np.float32)
        n_valid = rng.integers(1, CAP + 1, NDEV).astype(np.int32)
        ref = ref_scan.sharded_merge_dedup(ref_m, num_pks=1)(
            (ref_scan.shard_leading_axis(ref_m, pk),),
            ref_scan.shard_leading_axis(ref_m, seq),
            (ref_scan.shard_leading_axis(ref_m, val),),
            ref_scan.shard_leading_axis(ref_m, n_valid))
        port = port_scan.sharded_merge_dedup(port_m, num_pks=1)(
            (pk,), seq, (val,), n_valid)
        assert _np(ref[4]).tolist() == _np(port[4]).tolist()
        for a, b in ((ref[0][0], port[0][0]), (ref[1], port[1]),
                     (ref[2][0], port[2][0]), (ref[3], port[3])):
            assert _np(a).tobytes() == _np(b).tobytes()


def _run_inputs(seed, T=4, CAPW=64, GW=8, W=16):
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, W * 100, (T, CAPW)).astype(np.int32)
    gid = rng.integers(-1, GW, (T, CAPW)).astype(np.int32)
    # integer-valued f32: every sum is exact in either package
    vals = rng.integers(0, 1000, (T, CAPW)).astype(np.float32)
    remap = np.tile(np.arange(GW, dtype=np.int32), (T, 1))
    return ts, gid, vals, remap


class TestMeshRunPartials:
    @pytest.mark.parametrize("seed", [0, 1])
    @pytest.mark.parametrize("seg_ids", [[0, 0, 1, 2], [0, 0, 0, 0],
                                         [0, 1, 1, -4]])
    def test_matches_the_jax_program(self, meshes2, seed, seg_ids):
        ref_m, port_m = meshes2
        ts, gid, vals, remap = _run_inputs(seed)
        T = 4
        zeros = np.zeros(T, dtype=np.int32)
        sid = np.asarray(seg_ids, dtype=np.int32)
        ref = ref_scan.mesh_run_partials(ref_m, num_groups=8,
                                         num_buckets=16, which=ALL_AGGS)(
            *(ref_scan.shard_time_axis(ref_m, a)
              for a in (ts, gid, vals, remap, zeros, zeros, sid)),
            jnp.int32(16), jnp.asarray([100], dtype=jnp.int32))
        port = port_scan.mesh_run_partials(port_m, num_groups=8,
                                           num_buckets=16, which=ALL_AGGS)(
            ts, gid, vals, remap, zeros, zeros, sid, 16, 100)
        _agree(ref, port, f"seg_ids {seg_ids}")
        # integer-valued rows: the sums are byte-equal too
        assert _np(ref["sum"]).tobytes() == _np(port["sum"]).tobytes()

    def test_segmented_combine_byte_exact(self, meshes2):
        """Each slot's output equals its segment-run prefix combined with
        combine_partial_pair, byte for byte (the port's own check of the
        JAX package's test_segmented_combine_byte_exact)."""
        from horaedb_tpu_torch.ops import downsample

        _ref_m, port_m = meshes2
        ts, gid, vals, remap = _run_inputs(5)
        vals = (np.random.default_rng(5).random(vals.shape) * 50
                ).astype(np.float32)
        zeros = np.zeros(4, dtype=np.int32)
        out = port_scan.mesh_run_partials(port_m, num_groups=8,
                                          num_buckets=16, which=ALL_AGGS)(
            ts, gid, vals, remap, zeros, zeros,
            np.array([0, 0, 1, 2], dtype=np.int32), 16, 100)

        def one(t):
            return downsample.window_local_partials(
                torch.from_numpy(ts[t]), torch.from_numpy(gid[t]),
                torch.from_numpy(vals[t]), torch.from_numpy(remap[t]), 0, 0,
                16, 100, num_groups=8, num_buckets=16, which=ALL_AGGS)

        ps = [one(t) for t in range(4)]
        want = {0: ps[0], 1: downsample.combine_partial_pair(ps[1], ps[0]),
                2: ps[2], 3: ps[3]}
        for t, ref in want.items():
            for k in ref:
                assert out[k].row(t).tobytes() == ref[k].numpy().tobytes()

    def test_repeated_device_mesh_never_aliases(self, meshes2):
        """On a mesh that names one device eight times, slots share
        input tensors (one upload per device) and `.to()` hands a slot
        its neighbour's tensor itself, not a copy.  The programs must
        keep value semantics anyway: inputs unchanged, outputs of two
        series shards distinct storage, a score update writes its state
        only, and a second update from the same round gives the same
        state as one update applied to a fresh state twice."""
        _ref_m, port_m = meshes2
        ts, gid, vals, remap = _run_inputs(9)
        zeros = np.zeros(4, dtype=np.int32)
        sid = np.array([0, 0, 0, 1], dtype=np.int32)
        placed = [port_scan.shard_time_axis(port_m, a)
                  for a in (ts, gid, vals, remap, zeros, zeros, sid)]
        # the (t, 0) and (t, 1) slots share one uploaded block
        assert placed[0].blocks[0].data_ptr() == placed[0].blocks[1].data_ptr()
        snap = [p.numpy().copy() for p in placed]
        fn = port_scan.mesh_run_partials(port_m, num_groups=8,
                                         num_buckets=16, which=ALL_AGGS)
        out = fn(*placed, 16, 100)
        for p, s in zip(placed, snap):
            assert p.numpy().tobytes() == s.tobytes()
        ptrs = {b.data_ptr() for b in out["max"].blocks}
        assert len(ptrs) == port_m.size
        before = {k: v.numpy().copy() for k, v in out.items()}
        lo = np.zeros(4, dtype=np.int32)
        for by in ("max", "last"):
            st = port_scan.mesh_score_init(port_m, 8, 32, by)
            assert st[0]["by"].data_ptr() != st[1]["by"].data_ptr()
            port_scan.mesh_score_update(st, out[by], out["count"],
                                        out["last_ts"], lo, 100, by=by)
            port_scan.mesh_score_update(st, out[by], out["count"],
                                        out["last_ts"], lo, 100, by=by)
            once = port_scan.mesh_score_init(port_m, 8, 32, by)
            port_scan.mesh_score_update(once, out[by], out["count"],
                                        out["last_ts"], lo, 100, by=by)
            for a, b in zip(st, once):
                for k in a:
                    assert a[k].numpy().tobytes() == b[k].numpy().tobytes()
        add = port_scan.mesh_additive_init(port_m, 8, 32, "avg")
        port_scan.mesh_additive_update(add, out["count"], out["sum"],
                                       np.array([0, 0, 1, 1], bool), lo,
                                       by="avg")
        for k, v in out.items():
            assert v.numpy().tobytes() == before[k].tobytes(), k


class TestPlacement:
    def test_place_uploads_each_device_its_span(self):
        """Slots over two distinct device objects (`cpu` and `cpu:0`,
        the stand-ins for two cards): each device receives one upload of
        the rows its slots need, every slot's block is its own rows, and
        the mesh program's grids equal the one-device mesh's."""
        from horaedb_tpu_torch.common import deviceprof

        devs = ["cpu", "cpu", "cpu:0", "cpu:0", "cpu:0", "cpu:0", "cpu",
                "cpu"]
        m = port_mesh.scan_mesh(4, 2, devices=devs)
        arr = np.arange(4 * 3, dtype=np.int32).reshape(4, 3)
        before = deviceprof.profiler.transfer["h2d"]["bytes"]
        placed = port_scan.shard_time_axis(m, arr)
        # cpu holds time rows 0 and 3 (span 0..3), cpu:0 rows 1 and 2
        # (span 1..2): 4 + 2 rows of 12 bytes
        assert deviceprof.profiler.transfer["h2d"]["bytes"] - before == 72
        for slot in range(m.size):
            t, _s = m.coords(slot)
            assert placed.blocks[slot].numpy().tolist() == [arr[t].tolist()]
        ts, gid, vals, remap = _run_inputs(4)
        zeros = np.zeros(4, dtype=np.int32)
        sid = np.array([0, 0, 1, 1], dtype=np.int32)
        outs = [port_scan.mesh_run_partials(mm, num_groups=8,
                                            num_buckets=16, which=ALL_AGGS)(
            ts, gid, vals, remap, zeros, zeros, sid, 16, 100)
            for mm in (m, port_mesh.scan_mesh(4, 2, devices=CPU8))]
        for k in outs[0]:
            assert outs[0][k].numpy().tobytes() == outs[1][k].numpy().tobytes()


class TestScoreState:
    def _round(self, meshes2, seed):
        ref_m, port_m = meshes2
        ts, gid, vals, remap = _run_inputs(seed)
        shift = np.array([0, 0, 100 * 4, 100 * 8], dtype=np.int32)
        lo = shift // 100
        sid = np.array([0, 0, 1, 2], dtype=np.int32)
        ref = ref_scan.mesh_run_partials(ref_m, num_groups=8,
                                         num_buckets=16, which=ALL_AGGS)(
            *(ref_scan.shard_time_axis(ref_m, a)
              for a in (ts, gid, vals, remap, shift, lo, sid)),
            jnp.int32(24), jnp.asarray([100], dtype=jnp.int32))
        port = port_scan.mesh_run_partials(port_m, num_groups=8,
                                           num_buckets=16, which=ALL_AGGS)(
            ts, gid, vals, remap, shift, lo, sid, 24, 100)
        return ref, port, lo, np.array([False, True, True, True])

    @pytest.mark.parametrize("by", ["min", "max", "last"])
    @pytest.mark.parametrize("largest", [True, False])
    def test_selection_scores_match(self, meshes2, by, largest):
        ref_m, port_m = meshes2
        ref_st = ref_scan.mesh_score_init(8, 24 + 16, by)
        port_st = port_scan.mesh_score_init(port_m, 8, 24 + 16, by)
        for seed in (0, 1):  # two rounds fold into one state
            ref, port, lo, _tails = self._round(meshes2, seed)
            ref_st = ref_scan.mesh_score_update(
                ref_st, ref[by], ref["count"],
                ref["last_ts"] if by == "last" else None, jnp.asarray(lo),
                jnp.int32(100), by=by)
            port_st = port_scan.mesh_score_update(
                port_st, port[by], port["count"],
                port["last_ts"] if by == "last" else None, lo, 100, by=by)
        r_sc, r_has = ref_scan.mesh_score_finalize(ref_st, largest=largest,
                                                   num_buckets=24)
        p_sc, p_has = port_scan.mesh_score_finalize(port_st, largest=largest,
                                                    num_buckets=24)
        assert np.asarray(r_sc).tobytes() == p_sc.tobytes()
        assert np.asarray(r_has).tolist() == p_has.tolist()

    @pytest.mark.parametrize("by", ["count", "sum", "avg"])
    def test_additive_scores_match(self, meshes2, by):
        ref_m, port_m = meshes2
        ref_st = ref_scan.mesh_additive_init(8, 24 + 16, by)
        port_st = port_scan.mesh_additive_init(port_m, 8, 24 + 16, by)
        for seed in (0, 1):
            ref, port, lo, tails = self._round(meshes2, seed)
            ref_st = ref_scan.mesh_additive_update(
                ref_st, ref["count"], ref["sum"], jnp.asarray(tails),
                jnp.asarray(lo), by=by)
            port_st = port_scan.mesh_additive_update(
                port_st, port["count"], port["sum"], tails, lo, by=by)
        r = ref_scan.mesh_additive_finalize(ref_st, by=by, largest=True,
                                            num_buckets=24)
        p = port_scan.mesh_additive_finalize(port_st, by=by, largest=True,
                                             num_buckets=24)
        assert bool(r["lossy"]) == p["lossy"]
        for k in r:
            if k == "lossy":
                continue
            assert np.asarray(r[k]).tobytes() == np.asarray(p[k]).tobytes(), k

    def test_take_rows_matches(self, meshes2):
        ref, port, _lo, _tails = self._round(meshes2, 3)
        idx = np.array([1, 4, 6], dtype=np.int32)
        r = ref_scan.mesh_take_rows(ref, jnp.asarray(idx))
        p = port_scan.mesh_take_rows(port, idx)
        for k in r:
            assert np.asarray(r[k]).tobytes() == \
                p[k].numpy().astype(np.asarray(r[k]).dtype).tobytes(), k


class TestMeshDecodePartials:
    @pytest.mark.parametrize("route", ["sorted", "kway", "presorted"])
    def test_matches_the_jax_program(self, meshes2, route):
        """Encoded columns (pk, seq, ts, value) per slot through leaf
        filter, merge, dedup, aggregate and the segmented combine, in
        both packages: the same grids and survivor counts."""
        ref_m, port_m = meshes2
        T, cap, GW, W = 4, 128, 8, 16
        rng = np.random.default_rng(11)
        n = np.array([100, 128, 60, 90], dtype=np.int32)
        pk = np.zeros((T, cap), dtype=np.int32)
        seq = np.zeros((T, cap), dtype=np.int32)
        ts = np.zeros((T, cap), dtype=np.int32)
        val = np.zeros((T, cap), dtype=np.float32)
        num_runs = 4
        offs = np.full((T, num_runs + 1), cap, dtype=np.int32)
        offs[:, 0] = 0
        for t in range(T):
            k = int(n[t])
            rows = np.stack([rng.integers(0, GW, k),
                             rng.integers(0, 50, k),
                             rng.integers(0, W * 100, k)])
            if route == "presorted":
                rows = rows[:, np.lexsort((rows[1], rows[0]))]
            elif route == "kway":
                half = k // 2
                for a, b in ((0, half), (half, k)):
                    part = rows[:, a:b]
                    rows[:, a:b] = part[:, np.lexsort((part[1], part[0]))]
                offs[t, 1], offs[t, 2] = half, k
            pk[t, :k], seq[t, :k], ts[t, :k] = rows
            val[t, :k] = rng.integers(0, 1000, k).astype(np.float32)
        zeros = np.zeros(T, dtype=np.int32)
        sid = np.array([0, 1, 1, 2], dtype=np.int32)
        which = ("count", "min", "max", "last")
        kw = dict(num_groups=GW, num_buckets=W, which=which,
                  key_slots=(0, 1, 2), num_pks=1, group_pos=0, ts_pos=2,
                  val_slot=3, leaf_prog=((0, 4),), route=route,
                  num_runs=num_runs if route == "kway" else 0)
        # one leaf: pk >= 1 (op 4 = GE), constant per slot
        consts = np.ones((T, 1), dtype=np.int32)
        ref_out, ref_kept = ref_scan.mesh_decode_partials(ref_m, **kw)(
            tuple(ref_scan.shard_time_axis(ref_m, c)
                  for c in (pk, seq, ts, val)),
            ref_scan.shard_time_axis(ref_m, n),
            (ref_scan.shard_time_axis(ref_m, consts),),
            ref_scan.shard_time_axis(ref_m, offs),
            *(ref_scan.shard_time_axis(ref_m, a) for a in (zeros, zeros,
                                                          sid)),
            jnp.int32(W), jnp.asarray([100], dtype=jnp.int32))
        port_out, port_kept = port_scan.mesh_decode_partials(port_m, **kw)(
            (pk, seq, ts, val), n, (consts,), offs, zeros, zeros, sid, W,
            100)
        _agree(ref_out, port_out, route)
        assert _np(ref_kept).tolist() == _np(port_kept).tolist()
