"""The port's host library (horaedb_tpu_torch/native, built from
horaedb_tpu_torch/csrc/host_native.cpp) against the JAX package's
horaedb_tpu.native and against its own plain versions, on the same
seeded inputs: snapshot bytes and errors, run starts and last indices,
SeaHash single and batch, and the batch chunk decode of payloads made by
the JAX package's chunk encoder.  Also: the build lands in the port's
build directory and leaves native/ alone, a missing compiler raises
(no numpy result comes back), and a manifest written by either package
opens in the other.  The cases of tests/test_native.py are mirrored as
parametrised cases."""

import asyncio
import os
import struct

import numpy as np
import pyarrow as pa
import pytest

from horaedb_tpu import native as ref
from horaedb_tpu.common.error import Error as RefError
from horaedb_tpu.common.seahash import _hash64_py
from horaedb_tpu.metric_engine import chunks
from horaedb_tpu_torch import native as port
from horaedb_tpu_torch.common.error import Error

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def records(n, seed=0):
    rng = np.random.default_rng(seed)
    out = np.empty(n, dtype=port.RECORD_DTYPE)
    out["id"] = rng.integers(0, 2**63, n, dtype=np.uint64)
    out["start"] = rng.integers(-(2**40), 2**40, n)
    out["end"] = out["start"] + rng.integers(1, 10**6, n)
    out["size"] = rng.integers(0, 2**32, n, dtype=np.uint32)
    out["num_rows"] = rng.integers(0, 2**32, n, dtype=np.uint32)
    return out


def _listing(path):
    return sorted((name, os.stat(os.path.join(path, name)).st_size,
                   os.stat(os.path.join(path, name)).st_mtime_ns)
                  for name in os.listdir(path))


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The port's library built anew into an empty directory."""
    monkeypatch.setattr(port, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(port, "_lib", None)
    return tmp_path / "build"


def test_constants_match_the_reference():
    assert port.SNAPSHOT_MAGIC == ref.SNAPSHOT_MAGIC
    assert port.SNAPSHOT_VERSION == ref.SNAPSHOT_VERSION
    assert port.RECORD_DTYPE == ref.RECORD_DTYPE


def test_builds_into_the_port_build_dir_and_leaves_native_alone(
        fresh_build):
    assert ref.available()  # the reference's own build settles first
    native_dir = os.path.join(REPO, "native")
    before = _listing(native_dir)
    assert port.available() and port.is_loaded()
    assert os.path.dirname(port.library_path()) == str(fresh_build)
    assert os.path.exists(port.library_path())
    assert _listing(native_dir) == before
    assert port.SOURCE == os.path.join(REPO, "horaedb_tpu_torch", "csrc",
                                       "host_native.cpp")


def test_default_build_dir_is_the_ports():
    assert port.BUILD_DIR == os.path.join(REPO, "horaedb_tpu_torch", "build")


ENTRIES = {
    "snapshot_encode": lambda: port.snapshot_encode(records(3)),
    "snapshot_decode": lambda: port.snapshot_decode(
        ref.snapshot_encode(records(3))),
    "run_starts_i64": lambda: port.run_starts_i64(
        [np.arange(5, dtype=np.int64)]),
    "run_last_indices": lambda: port.run_last_indices(
        np.array([1, 0, 1], dtype=bool)),
    "seahash64": lambda: port.seahash64(b"key"),
    "seahash64_batch": lambda: port.seahash64_batch([b"a", b"b"]),
    "chunk_decode_batch": lambda: port.chunk_decode_batch(
        [chunks.encode_chunk(np.array([1000], dtype=np.int64),
                             np.array([1.0]))]),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_missing_compiler_raises(fresh_build, tmp_path, monkeypatch, entry):
    monkeypatch.setattr(port, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(Error, match="host library build failed"):
        ENTRIES[entry]()
    assert not port.is_loaded()


# ---- snapshot codec -------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 1000])
def test_snapshot_bytes_match_reference_and_plain(n):
    recs = records(n, seed=n)
    buf = port.snapshot_encode(recs)
    assert len(buf) == 14 + n * 32
    assert buf == ref.snapshot_encode(recs) == port.snapshot_encode_plain(
        recs)
    for back in (port.snapshot_decode(buf), port.snapshot_decode_plain(buf),
                 ref.snapshot_decode(buf)):
        assert back.dtype == port.RECORD_DTYPE
        assert back.tobytes() == recs.tobytes()


def test_snapshot_empty():
    empty = np.empty(0, dtype=port.RECORD_DTYPE)
    assert port.snapshot_encode(empty) == b"" == ref.snapshot_encode(empty)
    assert port.snapshot_encode_plain(empty) == b""
    assert len(port.snapshot_decode(b"")) == 0
    assert len(port.snapshot_decode_plain(b"")) == 0


def test_snapshot_wire_layout_golden():
    rec = np.zeros(1, dtype=port.RECORD_DTYPE)
    rec["id"] = 0x0102030405060708
    rec["start"] = -1
    rec["size"] = 0xAABBCCDD
    body = port.snapshot_encode(rec)[14:]
    assert body[:8] == bytes([8, 7, 6, 5, 4, 3, 2, 1])
    assert body[8:16] == b"\xff" * 8
    assert body[24:28] == bytes([0xDD, 0xCC, 0xBB, 0xAA])


def _header(magic=port.SNAPSHOT_MAGIC, version=port.SNAPSHOT_VERSION,
            length=0):
    return struct.pack("<IBBQ", magic, version, 0, length)


BAD_SNAPSHOTS = {
    "header only": _header(),
    "newer version": _header(version=2, length=32) + bytes(32),
    "bad magic": b"\x00" * 46,
    "truncated body": ref.snapshot_encode(records(2))[:-3],
    "length mismatch": _header(length=64) + bytes(32),
    "body not whole records": _header(length=33) + bytes(33),
    "truncated header": _header(length=32)[:9],
}


@pytest.mark.parametrize("case", sorted(BAD_SNAPSHOTS))
def test_snapshot_errors_match_reference(case):
    buf = BAD_SNAPSHOTS[case]
    with pytest.raises(RefError) as want:
        ref.snapshot_decode(buf)
    for decode in (port.snapshot_decode, port.snapshot_decode_plain):
        with pytest.raises(Error) as got:
            decode(buf)
        assert str(got.value) == str(want.value), (case, decode)


def test_snapshot_spec_classes_match_the_codec():
    from horaedb_tpu_torch.storage.manifest.encoding import (SnapshotHeader,
                                                             SnapshotRecord)
    from horaedb_tpu_torch.storage.types import TimeRange

    rec = SnapshotRecord(id=12345, time_range=TimeRange.new(-77, 999),
                         size=4096, num_rows=8192)
    arr = np.array([(12345, -77, 999, 4096, 8192)], dtype=port.RECORD_DTYPE)
    assert rec.to_bytes() == port.snapshot_encode(arr)[14:]
    arr = np.zeros(3, dtype=port.RECORD_DTYPE)
    assert SnapshotHeader(length=3 * 32).to_bytes() == \
        port.snapshot_encode(arr)[:14]


# ---- run detection --------------------------------------------------------


@pytest.mark.parametrize("ncols", [1, 2, 3])
@pytest.mark.parametrize("seed", range(3))
def test_run_starts_and_last_indices_match_reference(ncols, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5000))
    cols = [np.sort(rng.integers(-50, 50, n)).astype(np.int64)
            for _ in range(ncols)]
    cols[-1][: n // 3] = cols[-1][0]  # a long run
    got = port.run_starts_i64(cols)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, ref.run_starts_i64(cols))
    np.testing.assert_array_equal(got, port.run_starts_i64_plain(cols))
    last = port.run_last_indices(got)
    assert last.dtype == np.int64
    np.testing.assert_array_equal(last, ref.run_last_indices(got))
    np.testing.assert_array_equal(last, port.run_last_indices_plain(got))


@pytest.mark.parametrize("starts,want", [
    ([1, 0, 1, 1, 0, 0], [1, 2, 5]),
    ([1, 0, 0], [2]),
    ([1], [0]),
    ([], []),
])
def test_run_last_indices_cases(starts, want):
    starts = np.array(starts, dtype=bool)
    assert port.run_last_indices(starts).tolist() == want
    assert port.run_last_indices_plain(starts).tolist() == want
    assert ref.run_last_indices(starts).tolist() == want


def test_run_starts_empty():
    assert port.run_starts_i64([np.zeros(0, dtype=np.int64)]).tolist() == []
    assert port.run_starts_i64_plain([np.zeros(0, np.int64)]).tolist() == []


def test_last_value_operator_takes_the_library_route():
    from horaedb_tpu.storage.operator import LastValueOperator as RefOp
    from horaedb_tpu_torch.storage.operator import LastValueOperator

    rng = np.random.default_rng(4)
    n = 3000
    order = np.lexsort((rng.integers(0, 9, n), rng.integers(0, 40, n)))
    k1 = np.sort(rng.integers(0, 40, n))
    k2 = rng.integers(0, 9, n)[order]
    batch = pa.record_batch({
        "tsid": pa.array(k1, type=pa.int64()),
        "host": pa.array([f"h{v}" for v in k2]),
        "value": pa.array(rng.random(n))})
    for pks in ([0], [0, 1], [1]):
        got = LastValueOperator().merge_sorted_batch(batch, pks)
        assert got.equals(RefOp().merge_sorted_batch(batch, pks)), pks


# ---- SeaHash --------------------------------------------------------------


def _keys(seed=3):
    rng = np.random.default_rng(seed)
    keys = [bytes(rng.integers(0, 256, n).astype(np.uint8))
            for n in range(41)]
    keys += [b"", b"a", b"to be or not to be", b"x" * 31, b"y" * 32,
             b"z" * 33]
    keys += [bytes(rng.integers(0, 256, int(n)).astype(np.uint8))
             for n in rng.integers(0, 300, 64)]
    return keys


def test_seahash_single_matches_reference_and_spec():
    assert ref.available()
    for key in _keys():
        h = port.seahash64(key)
        assert h == ref.seahash64(key) == _hash64_py(key), key
        assert port.seahash64_plain(key) == h


@pytest.mark.parametrize("which", ["random", "series keys"])
def test_seahash_batch_matches_reference(which):
    keys = _keys() if which == "random" else [
        f"cpu{{host=h{i:03d},region=r{i % 5}}}".encode()
        for i in range(512)] + [b""]
    got = port.seahash64_batch(keys)
    assert got.dtype == np.uint64
    assert got.tobytes() == ref.seahash64_batch(keys).tobytes()
    assert got.tobytes() == port.seahash64_batch_plain(keys).tobytes()


def test_hash64_routes_the_library_once_loaded_and_tsids_match():
    from horaedb_tpu.metric_engine import types as ref_types
    from horaedb_tpu_torch.common.seahash import hash64, hash64_plain
    from horaedb_tpu_torch.metric_engine import types as port_types

    assert port.available() and port.is_loaded()
    labels = [port_types.Label("host", "a"), port_types.Label("dc", "b")]
    key = port_types.series_key_of("cpu", labels)
    assert hash64(key) == hash64_plain(key) == _hash64_py(key)
    keys = [port_types.series_key_of("cpu", [port_types.Label(
        "host", f"h{i}")]) for i in range(300)]
    got = port_types.tsids_of_keys(keys)
    assert got.tobytes() == ref_types.tsids_of_keys(keys).tobytes()
    assert int(got[0]) == port_types.tsid_of(
        "cpu", [port_types.Label("host", "h0")])
    ref_labels = [ref_types.Label("host", "a"), ref_types.Label("dc", "b")]
    assert port_types.tsid_of("cpu", labels) == ref_types.tsid_of(
        "cpu", ref_labels)


# ---- chunk payloads ---------------------------------------------------------


def _payloads(seed):
    rng = np.random.default_rng(seed)
    payloads = []
    for _ in range(30):
        parts = []
        for _c in range(rng.integers(1, 4)):
            n = int(rng.integers(1, 200))
            base = int(rng.integers(0, 2**40))
            kind = rng.integers(0, 4)
            if kind == 0:  # regular interval, integer gauge
                ts = base + np.arange(n, dtype=np.int64) * 10_000
                vals = rng.integers(0, 1000, n).astype(np.float64)
            elif kind == 1:  # jittery interval, float values (XOR)
                ts = base + np.cumsum(rng.integers(1, 5000, n))
                vals = rng.random(n) * 1e6
            elif kind == 2:  # 2-decimal gauge (scaled-int)
                ts = base + np.arange(n, dtype=np.int64) * 500
                vals = np.round(rng.random(n) * 100, 2)
            else:  # constant series + duplicate timestamps
                ts = base + rng.integers(0, max(1, n // 2), n) * 1000
                vals = np.full(n, 42.5)
            parts.append(chunks.encode_chunk(np.asarray(ts, dtype=np.int64),
                                             vals))
        payloads.append(b"".join(parts))
    return payloads


def _same_decode(a, b):
    assert a is not None and b is not None
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_decode_batch_matches_reference(seed):
    payloads = _payloads(seed)
    got = port.chunk_decode_batch(payloads)
    _same_decode(got, ref.chunk_decode_batch(payloads))
    _same_decode(got, port.chunk_decode_batch_plain(payloads))
    ts, vals, counts = got
    off = 0
    for i, p in enumerate(payloads):
        want_ts, want_vals = chunks.decode_chunks(p)
        k = int(counts[i])
        assert k == len(want_ts), f"payload {i}"
        assert ts[off:off + k].tobytes() == want_ts.tobytes()
        assert vals[off:off + k].tobytes() == want_vals.tobytes()
        off += k


def test_chunk_decode_batch_arrow_input_and_slices():
    payloads = _payloads(7)
    arr = pa.array(payloads, type=pa.binary())
    got_list = port.chunk_decode_batch(payloads)
    _same_decode(port.chunk_decode_batch(arr), got_list)
    _same_decode(port.chunk_decode_batch(arr), ref.chunk_decode_batch(arr))
    sl = arr.slice(3, 10)
    _same_decode(port.chunk_decode_batch(sl), ref.chunk_decode_batch(sl))
    _same_decode(port.chunk_decode_batch(sl),
                 port.chunk_decode_batch_plain(sl))
    off = int(got_list[2][:3].sum())
    k = int(got_list[2][3:13].sum())
    np.testing.assert_array_equal(port.chunk_decode_batch(sl)[0],
                                  got_list[0][off:off + k])


MALFORMED = {
    "bad magic": [b"\xff garbage"],
    "truncated header": "good[:5]",
    "short v2 header": ["good", b"\xc8" + b"\x00" * 5],
    "zero count": [b"\xc8" + bytes(28)],
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_chunk_decode_batch_malformed_returns_none(case):
    good = chunks.encode_chunk(np.array([1000], dtype=np.int64),
                               np.array([1.0]))
    payloads = MALFORMED[case]
    if payloads == "good[:5]":
        payloads = [good[:5]]
    payloads = [good if p == "good" else p for p in payloads]
    assert port.chunk_decode_batch([good]) is not None
    assert ref.chunk_decode_batch(payloads) is None
    assert port.chunk_decode_batch(payloads) is None
    assert port.chunk_decode_batch_plain(payloads) is None


def test_chunk_decode_batch_empty_inputs():
    ts, vals, counts = port.chunk_decode_batch([])
    assert len(ts) == len(vals) == len(counts) == 0
    got = port.chunk_decode_batch([b""])
    assert got is not None and got[2].tolist() == [0]
    assert port.chunk_decode_batch_plain([b""])[2].tolist() == [0]


# ---- a manifest written by one package opens in the other ------------------


async def _write_manifest(pkg: str, root: str, files: list) -> None:
    if pkg == "ref":
        from horaedb_tpu.objstore.local import LocalObjectStore
        from horaedb_tpu.storage.manifest import Manifest
        from horaedb_tpu.storage.sst import FileMeta
        from horaedb_tpu.storage.types import TimeRange
    else:
        from horaedb_tpu_torch.objstore.local import LocalObjectStore
        from horaedb_tpu_torch.storage.manifest import Manifest
        from horaedb_tpu_torch.storage.sst import FileMeta
        from horaedb_tpu_torch.storage.types import TimeRange
    m = await Manifest.open("db", LocalObjectStore(root))
    try:
        for fid, start, end, size, rows in files:
            await m.add_file(fid, FileMeta(max_sequence=fid, num_rows=rows,
                                           size=size, time_range=TimeRange.new(
                                               start, end)))
        await m.trigger_merge()
    finally:
        await m.close()


async def _read_manifest(pkg: str, root: str) -> list:
    if pkg == "ref":
        from horaedb_tpu.objstore.local import LocalObjectStore
        from horaedb_tpu.storage.manifest import Manifest
        from horaedb_tpu.storage.types import TimeRange
    else:
        from horaedb_tpu_torch.objstore.local import LocalObjectStore
        from horaedb_tpu_torch.storage.manifest import Manifest
        from horaedb_tpu_torch.storage.types import TimeRange
    m = await Manifest.open("db", LocalObjectStore(root))
    try:
        ssts = await m.find_ssts(TimeRange.new(-(2**62), 2**62))
    finally:
        await m.close()
    return sorted((f.id, int(f.meta.time_range.start),
                   int(f.meta.time_range.end), f.meta.size,
                   f.meta.num_rows) for f in ssts)


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_manifest_written_by_one_package_opens_in_the_other(tmp_path, writer,
                                                           reader):
    rng = np.random.default_rng(11)
    files = [(int(i + 1), int(s), int(s + d), int(sz), int(r))
             for i, (s, d, sz, r) in enumerate(zip(
                 rng.integers(0, 10**9, 40), rng.integers(1, 10**6, 40),
                 rng.integers(1, 2**31, 40), rng.integers(1, 2**31, 40)))]
    root = str(tmp_path / writer)
    asyncio.run(_write_manifest(writer, root, files))
    assert asyncio.run(_read_manifest(reader, root)) == sorted(files)
    # and the snapshot objects of the two packages are the same bytes
    other = str(tmp_path / reader)
    asyncio.run(_write_manifest(reader, other, files))

    def snapshot_bytes(path):
        for dirpath, _dirs, names in os.walk(path):
            for name in names:
                if "snapshot" in os.path.join(dirpath, name):
                    with open(os.path.join(dirpath, name), "rb") as f:
                        return f.read()
        raise AssertionError(f"no snapshot under {path}")

    assert snapshot_bytes(root) == snapshot_bytes(other)
