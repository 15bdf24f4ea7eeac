"""The parts path's host combine (horaedb_tpu_torch/storage/combine.py)
against the JAX package's storage/combine.py on the same seeded parts:
the sparse fold, the dense fold and PartsMemo.probe give byte-equal
grids on both sides, sparse equals dense, and the memo serves exactly
the parts a recompute would give."""

import numpy as np
import pytest

from horaedb_tpu.storage import combine as ref_combine
from horaedb_tpu.storage.read import AggregateSpec as RefSpec
from horaedb_tpu_torch.common.error import Error
from horaedb_tpu_torch.ops.downsample import ALL_AGGS
from horaedb_tpu_torch.storage import combine as port_combine
from horaedb_tpu_torch.storage.config import StorageConfig, from_dict
from horaedb_tpu_torch.storage.read import AggregateSpec as PortSpec

I64_MIN = np.iinfo(np.int64).min
WHICH_SETS = (("avg",), ("min", "max"), ("count",), ("sum", "avg"),
              ("last",), ("avg", "max", "last"), ALL_AGGS)


def _rand_parts(rng: np.random.Generator, num_buckets: int,
                universe: np.ndarray, n_parts: int) -> list:
    """Random partial grids with the kernel's conventions: sorted unique
    group values, f32 cells with combine identities in empty cells,
    int64 last_ts with the I64_MIN sentinel."""
    parts = []
    for _ in range(n_parts):
        if rng.random() < 0.4:
            values = universe  # full-group part: the in-place paste
        else:
            k = int(rng.integers(1, len(universe) + 1))
            values = np.sort(rng.choice(universe, size=k, replace=False))
        lo = int(rng.integers(0, num_buckets))
        width = int(rng.integers(1, num_buckets - lo + 1))
        g = len(values)
        count = rng.integers(0, 3, (g, width)).astype(np.float32)
        has = count > 0
        vals = rng.normal(size=(g, width)).astype(np.float32)
        grids = {
            "count": count,
            "sum": np.where(has, vals * count, 0.0).astype(np.float32),
            "min": np.where(has, vals - 1.0, np.inf).astype(np.float32),
            "max": np.where(has, vals + 1.0, -np.inf).astype(np.float32),
            "last": np.where(has, vals, 0.0).astype(np.float32),
            "last_ts": np.where(
                has, rng.integers(0, 10**9, (g, width)), I64_MIN
            ).astype(np.int64),
        }
        parts.append((values.copy(), lo, grids))
    return parts


def _copy(parts: list) -> list:
    return [(v.copy(), lo, {k: a.copy() for k, a in g.items()})
            for v, lo, g in parts]


def _assert_bytes(a, b, ctx=""):
    va, ga = a
    vb, gb = b
    assert np.array_equal(va, vb), f"{ctx}: group values differ"
    assert sorted(ga) == sorted(gb), f"{ctx}: keys {sorted(ga)} != {sorted(gb)}"
    for k in ga:
        x, y = np.asarray(ga[k]), np.asarray(gb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (ctx, k)
        assert x.tobytes() == y.tobytes(), f"{ctx}: grid {k!r} differs"


def _case(seed: int):
    rng = np.random.default_rng(seed)
    num_buckets = int(rng.integers(1, 40))
    universe = np.sort(rng.choice(np.arange(1, 500, dtype=np.uint64),
                                  size=int(rng.integers(1, 12)),
                                  replace=False))
    return num_buckets, _rand_parts(rng, num_buckets, universe,
                                    int(rng.integers(0, 8)))


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("mode", port_combine.COMBINE_MODES)
def test_combine_matches_reference_bytes(seed, mode):
    num_buckets, parts = _case(seed)
    for which in WHICH_SETS:
        got = port_combine.combine_parts(_copy(parts), num_buckets,
                                         which=which, mode=mode)
        want = ref_combine.combine_parts(_copy(parts), num_buckets,
                                         which=which, mode=mode)
        _assert_bytes(got, want, f"seed {seed} {mode} {which}")


@pytest.mark.parametrize("seed", range(12))
def test_sparse_equals_dense_bytes(seed):
    num_buckets, parts = _case(1000 + seed)
    for which in WHICH_SETS:
        _assert_bytes(
            port_combine.combine_parts(_copy(parts), num_buckets,
                                       which=which, mode="sparse"),
            port_combine.combine_parts(_copy(parts), num_buckets,
                                       which=which, mode="dense"),
            f"seed {seed} {which}")


def test_requested_aggs_only_emitted():
    rng = np.random.default_rng(7)
    parts = _rand_parts(rng, 10, np.arange(1, 5, dtype=np.uint64), 3)
    for which, keys in ((("avg",), {"count", "avg"}),
                        (("min", "max"), {"count", "min", "max"}),
                        (("last",), {"count", "last", "last_ts"}),
                        (("count",), {"count"})):
        for mode in port_combine.COMBINE_MODES:
            _v, grids = port_combine.combine_parts(_copy(parts), 10,
                                                   which=which, mode=mode)
            assert set(grids) == keys, (which, mode)
    assert port_combine.emitted_aggs(ALL_AGGS) == \
        ref_combine.emitted_aggs(ALL_AGGS)
    for which in WHICH_SETS:
        assert port_combine.expand_which(which) == \
            ref_combine.expand_which(which)


def test_unknown_combine_mode_rejected():
    with pytest.raises(Error, match="scan.combine"):
        port_combine.combine_parts([], 4, mode="bogus")


def test_combine_config_roundtrip():
    cfg = from_dict(StorageConfig, {
        "scan": {"combine": {"mode": "dense", "memo_max_bytes": 1 << 20}},
        "scrub": {"grace_period": "30s", "interval": "1h"}})
    assert cfg.scan.combine.mode == "dense"
    assert cfg.scan.combine.memo_max_bytes == 1 << 20
    assert cfg.scrub.grace_period.seconds == 30.0
    assert StorageConfig().scan.combine.mode == "sparse"
    with pytest.raises(Error, match="unknown config keys"):
        from_dict(StorageConfig, {"scan": {"combine": {"bogus": 1}}})


SEG = 3_600_000


def _spec(cls, lo: int, hi: int, bucket_ms: int, which):
    return cls(group_col="k", ts_col="ts", value_col="v", range_start=lo,
               bucket_ms=bucket_ms,
               num_buckets=max(1, -(-(hi - lo) // bucket_ms)), which=which)


def _segment_parts(rng, spec, seg_start: int, universe) -> list:
    """Parts of one segment in the recording query's grid: each covers
    buckets of [seg_start, seg_start + SEG) clipped to the grid."""
    b0 = (seg_start - spec.range_start) // spec.bucket_ms
    b1 = (seg_start + SEG - 1 - spec.range_start) // spec.bucket_ms
    lo = max(0, b0)
    width = min(spec.num_buckets - 1, b1) - lo + 1
    out = []
    for p in _rand_parts(rng, width, universe, 2):
        v, plo, g = p
        out.append((v, lo + plo, g))
    return out


# (recording range, probing range): narrowed, shifted inside, widened
# past the recorded grid, and a different phase (a different key)
PROBES = [
    ((0, 4 * SEG), (SEG, 3 * SEG)),
    ((0, 4 * SEG), (SEG + 120_000, 3 * SEG - 60_000)),
    ((SEG, SEG + SEG // 2), (0, 4 * SEG)),
    ((0, 4 * SEG), (30_000, 2 * SEG + 30_000)),
]


@pytest.mark.parametrize("rec,probe", PROBES,
                         ids=["narrowed", "shifted", "widened", "phase"])
@pytest.mark.parametrize("which", [("avg",), ALL_AGGS],
                         ids=lambda w: "-".join(w))
def test_parts_memo_probe_matches_reference(rec, probe, which):
    """Both memos record the same segment parts and are probed with the
    same query: hit or miss alike, and the rebased parts byte-equal."""
    rng = np.random.default_rng(11)
    universe = np.arange(1, 7, dtype=np.uint64)
    bucket_ms = 60_000
    port_memo = port_combine.PartsMemo(1 << 20)
    ref_memo = ref_combine.PartsMemo(1 << 20)
    rec_port = _spec(PortSpec, *rec, bucket_ms, which)
    rec_ref = _spec(RefSpec, *rec, bucket_ms, which)
    stored = {}
    for seg in range(4):
        seg_start = seg * SEG
        if not (rec[0] < seg_start + SEG and seg_start < rec[1]):
            continue
        parts = _segment_parts(rng, rec_port, seg_start, universe)
        stored[seg_start] = parts
        key = (seg_start, frozenset([seg]), ("k", "ts", "v"))
        port_memo.store(key, rec_port, "", _copy(parts))
        ref_memo.store(key, rec_ref, "", _copy(parts))
    q_port = _spec(PortSpec, *probe, bucket_ms, which)
    q_ref = _spec(RefSpec, *probe, bucket_ms, which)
    hits = 0
    for seg_start in stored:
        key = (seg_start, frozenset([seg_start // SEG]), ("k", "ts", "v"))
        got = port_memo.probe(key, seg_start, SEG, q_port, "")
        want = ref_memo.probe(key, seg_start, SEG, q_ref, "")
        assert (got is None) == (want is None), seg_start
        if got is None:
            continue
        hits += 1
        assert len(got) == len(want)
        for (gv, glo, gg), (wv, wlo, wg) in zip(got, want):
            assert glo == wlo
            _assert_bytes((gv, gg), (wv, wg), f"segment {seg_start}")
    assert port_memo.stats()["hits"] == hits == ref_memo.stats()["hits"]
    assert port_memo.stats()["misses"] == ref_memo.stats()["misses"]


def test_parts_memo_store_copies_and_bounds_bytes():
    """Stored parts are copies (a later write into the original does not
    change what the memo serves); an entry over the budget is dropped,
    and a zero budget disables the memo."""
    rng = np.random.default_rng(3)
    spec = _spec(PortSpec, 0, 4 * SEG, 60_000, ("avg",))
    parts = _segment_parts(rng, spec, 0, np.arange(1, 5, dtype=np.uint64))
    memo = port_combine.PartsMemo(1 << 20)
    key = (0, frozenset([1]), ("k",))
    memo.store(key, spec, "", parts)
    want = [g["sum"].copy() for _v, _lo, g in parts]
    for _v, _lo, g in parts:
        g["sum"][...] = 123.0
    got = memo.probe(key, 0, SEG, spec, "")
    for w, (_v, _lo, g) in zip(want, got):
        assert g["sum"].tobytes() == w.tobytes()
    tiny = port_combine.PartsMemo(64)
    tiny.store(key, spec, "", parts)
    assert tiny.stats()["entries"] == 0
    off = port_combine.PartsMemo(0)
    assert not off.enabled
    off.store(key, spec, "", parts)
    assert off.probe(key, 0, SEG, spec, "") is None
    assert off.stats()["misses"] == 0
