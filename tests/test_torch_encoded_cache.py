"""The tier-2 encoded cache of the port (horaedb_tpu_torch/storage/
encoded_cache.py) against the JAX package's (horaedb_tpu/storage/
encoded_cache.py), on the same seeded call sequences.

- A seeded sequence of get/peek/put/admit/invalidate/clear and negative
  memo calls gives the same results, hits, misses, evictions, bytes and
  stats() on both caches, at several budgets (a tier of 0 B and
  write_through = false among them).  Parts mix owning arrays, views of
  one pinned blob (charged once at the blob's size) and string and int64
  dictionaries.
- The unit scenarios of tests/test_scan_cache.py (byte-LRU order and
  accounting, subset-get and widening, invalidation, the memos, a
  disabled tier) run on both packages and agree.

Every cache a test fills is cleared before the test ends: the bytes
gauges are process-global and move by deltas, and the JAX package's
tests/test_memledger.py asserts that its gauge reads 0 after a close in
the same worker process."""

import contextlib

import random
import types

import numpy as np
import pyarrow as pa
import pytest

import horaedb_tpu.ops.encode as ref_encode
import horaedb_tpu.storage.encoded_cache as ref_cache
import horaedb_tpu_torch.ops.encode as port_encode
import horaedb_tpu_torch.storage.encoded_cache as port_cache
from horaedb_tpu_torch.utils import registry

REF = types.SimpleNamespace(Cache=ref_cache.EncodedSegmentCache,
                            ColumnEncoding=ref_encode.ColumnEncoding,
                            part_nbytes=ref_cache._part_nbytes)
PORT = types.SimpleNamespace(Cache=port_cache.EncodedSegmentCache,
                             ColumnEncoding=port_encode.ColumnEncoding,
                             part_nbytes=port_cache._part_nbytes)
BOTH = {"ref": REF, "port": PORT}


@contextlib.contextmanager
def cache_of(P, *args, **kwargs):
    """A cache for one test, cleared at its end (the gauge discipline)."""
    cache = P.Cache(*args, **kwargs)
    try:
        yield cache
    finally:
        cache.clear()


def int_part(P, names_arrays):
    """{name: (arr, enc)} of owning int32 numeric columns."""
    return {nm: (np.asarray(a, dtype=np.int32),
                 P.ColumnEncoding("numeric", pa.int32()))
            for nm, a in names_arrays.items()}


def seeded_part(P, rng: np.random.Generator, n: int, names: list):
    """A part as the sidecar loader returns it: columns are views into
    one downloaded blob (plus an owning column now and then), with a
    string or int64 dictionary on some columns."""
    blob = rng.integers(0, 1 << 30, size=n * len(names) + 8,
                        dtype=np.int32).tobytes()
    out = {}
    for i, nm in enumerate(names):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            arr = np.asarray(rng.integers(0, 9, n), dtype=np.int32)
        else:
            arr = np.frombuffer(blob, dtype=np.int32, count=n,
                                offset=4 * n * i)
        if kind == 2:
            d = np.array([f"host_{j:03d}" for j in range(int(
                rng.integers(1, 40)))], dtype=object)
            enc = P.ColumnEncoding("dict", pa.string(), dictionary=d)
        elif kind == 3:
            d = np.frombuffer(blob, dtype=np.int64, count=4,
                              offset=4 * n * len(names))
            enc = P.ColumnEncoding("dict", pa.int64(), dictionary=d)
        else:
            enc = P.ColumnEncoding("numeric", pa.int32())
        out[nm] = (arr, enc)
    return out


def run_sequence(P, seed: int, max_bytes: int, write_through: bool):
    """One seeded call sequence; returns every call's observable result
    and the final stats()."""
    rng = np.random.default_rng(seed)
    pick = random.Random(seed)
    with cache_of(P, max_bytes, write_through=write_through) as cache:
        log = _sequence(P, cache, rng, pick)
        return log, cache.stats()


def _sequence(P, cache, rng, pick) -> list:
    names = ["a", "b", "c", "d"]
    log = []
    for _step in range(300):
        op = pick.choice(["put", "put", "admit", "get", "get", "get",
                          "peek", "invalidate", "missing", "assembly",
                          "clear"])
        sid = pick.randint(0, 11)
        want = set(pick.sample(names, pick.randint(1, 4)))
        if op == "put":
            n = pick.randint(1, 600)
            cols = seeded_part(P, rng, n, sorted(want))
            cache.put(sid, cols, n)
            log.append((op, sid, len(cache), cache.total_bytes))
        elif op == "admit":
            n = pick.randint(1, 600)
            cols = seeded_part(P, rng, n, sorted(want))
            log.append((op, sid, cache.admit(sid, cols, n),
                        cache.total_bytes))
        elif op == "get":
            got = cache.get(sid, want)
            log.append((op, sid, None if got is None
                        else (sorted(got[0]), got[1])))
        elif op == "peek":
            log.append((op, sid, cache.peek(sid, want)))
        elif op == "invalidate":
            ids = pick.sample(range(12), pick.randint(1, 4))
            log.append((op, cache.invalidate(ids), cache.total_bytes))
        elif op == "missing":
            cache.mark_missing(sid)
            log.append((op, sid, cache.is_missing(sid),
                        cache.is_missing((sid + 1) % 12)))
        elif op == "assembly":
            ids = frozenset(pick.sample(range(12), 2))
            cache.mark_assembly_failed(ids)
            log.append((op, cache.is_assembly_failed(ids),
                        cache.is_assembly_failed(frozenset({sid}))))
        else:
            if pick.random() < 0.3:
                cache.clear()
            log.append((op, len(cache), cache.total_bytes))
    return log


@pytest.mark.parametrize("max_bytes,write_through", [
    (1 << 20, True), (12_000, True), (3_000, True), (0, True),
    (1 << 20, False), (12_000, False)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_call_sequence_matches_reference(seed, max_bytes,
                                                write_through):
    ref_log, ref_stats = run_sequence(REF, seed, max_bytes, write_through)
    port_log, port_stats = run_sequence(PORT, seed, max_bytes,
                                        write_through)
    assert port_log == ref_log
    assert port_stats == ref_stats
    if max_bytes == 0:
        assert port_stats["entries"] == 0 and port_stats["bytes"] == 0


@pytest.mark.parametrize("seed", [3, 4])
def test_part_bytes_charge_the_pinned_blob(seed):
    """_part_nbytes: each pinned blob once at its full size, owning
    arrays at their own size, object dictionaries with their content."""
    for n in (1, 17, 500):
        ref = REF.part_nbytes(seeded_part(REF, np.random.default_rng(seed),
                                          n, ["a", "b", "c"]))
        port = PORT.part_nbytes(seeded_part(
            PORT, np.random.default_rng(seed), n, ["a", "b", "c"]))
        assert port == ref > 0
    blob = np.arange(100, dtype=np.int32).tobytes()
    for P in BOTH.values():
        enc = P.ColumnEncoding("numeric", pa.int32())
        two_views = {"a": (np.frombuffer(blob, np.int32, 10, 0), enc),
                     "b": (np.frombuffer(blob, np.int32, 10, 40), enc)}
        assert P.part_nbytes(two_views) == len(blob)


@pytest.mark.parametrize("P", list(BOTH.values()), ids=list(BOTH))
def test_byte_lru_eviction_order_and_accounting(P):
    one = int_part(P, {"a": np.zeros(100)})  # 400 bytes
    with cache_of(P, max_bytes=1000) as c:
        _lru_scenario(P, c, one)


def _lru_scenario(P, c, one):
    c.put(1, one, 100)
    c.put(2, one, 100)
    assert len(c) == 2 and c.total_bytes == 800
    c.get(1, {"a"})  # 1 becomes MRU; 2 is now LRU
    c.put(3, one, 100)  # 1200 > 1000: evicts 2
    assert c.get(2, {"a"}) is None
    assert c.get(1, {"a"}) is not None
    assert c.get(3, {"a"}) is not None
    assert c.total_bytes == 800 and c.evictions == 1
    # an entry larger than the whole budget is skipped, not thrashed
    c.put(4, int_part(P, {"a": np.zeros(1000)}), 1000)
    assert c.get(4, {"a"}) is None
    assert c.total_bytes == 800


@pytest.mark.parametrize("P", list(BOTH.values()), ids=list(BOTH))
def test_get_subset_semantics_and_widening(P):
    with cache_of(P, max_bytes=1 << 20) as c:
        _subset_scenario(P, c)


def _subset_scenario(P, c):
    c.put(7, int_part(P, {"a": np.arange(10), "b": np.arange(10)}), 10)
    got = c.get(7, {"a"})
    assert got is not None and set(got[0]) == {"a"} and got[1] == 10
    # a column the entry lacks => miss, not a partial hit
    assert c.get(7, {"a", "c"}) is None
    assert not c.peek(7, {"a", "c"}) and c.peek(7, {"b"})
    # inserting a part with the missing column WIDENS the entry
    c.put(7, int_part(P, {"c": np.arange(10)}), 10)
    got = c.get(7, {"a", "b", "c"})
    assert got is not None and set(got[0]) == {"a", "b", "c"}
    assert c.stats()["hits"] == 2 and c.stats()["misses"] == 1


@pytest.mark.parametrize("P", list(BOTH.values()), ids=list(BOTH))
def test_invalidate_memos_and_disabled(P):
    with cache_of(P, max_bytes=1 << 20) as c, \
            cache_of(P, max_bytes=0) as off, \
            cache_of(P, max_bytes=1 << 20, write_through=False) as ro:
        _invalidate_scenario(P, c, off, ro)


def _invalidate_scenario(P, c, off, ro):
    c.put(1, int_part(P, {"a": np.arange(4)}), 4)
    c.mark_missing(2)
    assert c.is_missing(2)
    assert c.invalidate([1, 2, 99]) == 1
    assert c.get(1, {"a"}) is None and not c.is_missing(2)
    # admission clears a stale negative entry for the same id
    c.mark_missing(3)
    assert c.admit(3, int_part(P, {"a": np.arange(4)}), 4)
    assert not c.is_missing(3)
    # a failed composition is memoized as a SET: its members stay valid
    c.mark_assembly_failed({5, 6})
    assert c.is_assembly_failed(frozenset({5, 6}))
    assert not c.is_assembly_failed({5}) and not c.is_missing(5)
    # clear() drops entries and composition memos, keeps missing memos
    c.mark_missing(8)
    c.clear()
    assert len(c) == 0 and c.total_bytes == 0
    assert not c.is_assembly_failed({5, 6}) and c.is_missing(8)
    # disabled tier: put/admit are no-ops, negative memo still works
    off.put(1, int_part(P, {"a": np.arange(4)}), 4)
    assert not off.admit(2, int_part(P, {"a": np.arange(4)}), 4)
    assert len(off) == 0 and off.get(1, {"a"}) is None
    off.mark_missing(9)
    assert off.is_missing(9)
    # write_through=False refuses admission but keeps the read path
    assert not ro.admit(1, int_part(P, {"a": np.arange(4)}), 4)
    ro.put(1, int_part(P, {"a": np.arange(4)}), 4)
    assert ro.get(1, {"a"}) is not None


def test_bytes_gauge_follows_every_instance():
    """The port's scan_cache_bytes{tier="tier2"} gauge moves by deltas,
    so it sums every live cache and reads its start value once they are
    cleared."""
    gauge = registry.gauge("scan_cache_bytes").labels(tier="tier2")
    start = gauge.value
    with cache_of(PORT, 1 << 20) as a, cache_of(PORT, 1 << 20) as b:
        a.put(1, int_part(PORT, {"a": np.arange(100)}), 100)
        b.admit(2, int_part(PORT, {"a": np.arange(50)}), 50)
        assert gauge.value - start == a.total_bytes + b.total_bytes == 600
        a.invalidate([1])
        b.clear()
        assert gauge.value == start


def test_filled_caches_leave_both_gauges_at_their_start():
    """A filled cache cleared at its end gives its bytes back to the
    process-global gauge, in both packages."""
    start = (ref_cache._BYTES.value, port_cache._BYTES.value)
    for P in BOTH.values():
        _log, stats = run_sequence(P, 5, 1 << 20, True)
        assert stats["bytes"] > 0
    assert (ref_cache._BYTES.value, port_cache._BYTES.value) == start
