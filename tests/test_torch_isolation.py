"""The PyTorch port stands alone: importing it pulls in neither JAX nor
any module of the JAX package, no source file of it imports them, and
its engine refuses to fall back to the CPU when no card is present."""

import ast
import asyncio
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "horaedb_tpu_torch")


def _port_modules() -> list[str]:
    mods = []
    for root, _dirs, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, name), REPO)[:-3]
            mod = rel.replace(os.sep, ".")
            if mod.endswith(".__init__"):
                mod = mod[: -len(".__init__")]
            mods.append(mod)
    return sorted(mods)


def test_the_scan_covers_every_port_module():
    """The walk below finds every module of the port, the parts path's,
    compaction's, the scrubber's, the device decode's, the WAL's, the
    rollups', the chunked layout's, the planes' and the scan agents'
    included."""
    mods = _port_modules()
    for m in ("horaedb_tpu_torch.common.loops",
              "horaedb_tpu_torch.storage.combine",
              "horaedb_tpu_torch.storage.compaction",
              "horaedb_tpu_torch.storage.gc",
              "horaedb_tpu_torch.storage.read",
              "horaedb_tpu_torch.ops.bucket_agg",
              "horaedb_tpu_torch.ops.device_decode",
              "horaedb_tpu_torch.ops.merge",
              "horaedb_tpu_torch.ops.nvcc",
              "horaedb_tpu_torch.storage.operator",
              "horaedb_tpu_torch.wal.config",
              "horaedb_tpu_torch.wal.log",
              "horaedb_tpu_torch.wal.memtable",
              "horaedb_tpu_torch.wal.ingest",
              "horaedb_tpu_torch.native",
              "horaedb_tpu_torch.ops.topk",
              "horaedb_tpu_torch.storage.plan",
              "horaedb_tpu_torch.rollup",
              "horaedb_tpu_torch.rollup.config",
              "horaedb_tpu_torch.rollup.manager",
              "horaedb_tpu_torch.metric_engine.chunks",
              "horaedb_tpu_torch.metric_engine.functions",
              "horaedb_tpu_torch.utils.metrics",
              "horaedb_tpu_torch.utils.tracing",
              "horaedb_tpu_torch.common.deadline",
              "horaedb_tpu_torch.common.memledger",
              "horaedb_tpu_torch.common.tenant",
              "horaedb_tpu_torch.common.ipc",
              "horaedb_tpu_torch.objstore.middleware",
              "horaedb_tpu_torch.cluster",
              "horaedb_tpu_torch.cluster.breaker",
              "horaedb_tpu_torch.scanagent",
              "horaedb_tpu_torch.scanagent.config",
              "horaedb_tpu_torch.scanagent.wire",
              "horaedb_tpu_torch.scanagent.agent",
              "horaedb_tpu_torch.scanagent.client",
              "horaedb_tpu_torch.scanagent.__main__"):
        assert m in mods, m


def _port_sources() -> list[str]:
    """The port's C++ and CUDA sources."""
    return sorted(os.path.join(root, name)
                  for root, _dirs, files in os.walk(PKG) for name in files
                  if name.endswith((".cpp", ".cu", ".h", ".cuh")))


def test_native_sources_include_only_system_headers():
    """Every C++/CUDA source of the port, the host library's included,
    stands alone: it includes system headers only, nothing of the JAX
    package's native/ directory."""
    srcs = _port_sources()
    assert os.path.join(PKG, "csrc", "host_native.cpp") in srcs
    for path in srcs:
        with open(path, encoding="utf-8") as f:
            for n, line in enumerate(f, 1):
                if line.lstrip().startswith("#include"):
                    assert "<" in line and '"' not in line, f"{path}:{n}"


def test_port_never_opens_the_reference_host_library():
    """The port builds and loads its own library: no source names the
    JAX package's, and after every entry ran the process has mapped
    libhost_native and not libhoraedb_native."""
    for root, _dirs, files in os.walk(PKG):
        for name in files:
            if name.endswith((".py", ".cpp", ".cu")):
                with open(os.path.join(root, name), encoding="utf-8") as f:
                    assert "libhoraedb_native" not in f.read(), name
    code = (
        "import numpy as np\n"
        "from horaedb_tpu_torch import native\n"
        "recs = np.zeros(2, dtype=native.RECORD_DTYPE)\n"
        "native.snapshot_decode(native.snapshot_encode(recs))\n"
        "native.run_last_indices(native.run_starts_i64(\n"
        "    [np.arange(4, dtype=np.int64)]))\n"
        "native.seahash64(b'k'); native.seahash64_batch([b'a'])\n"
        "native.chunk_decode_batch([b''])\n"
        "maps = open('/proc/self/maps').read()\n"
        "print('PORT', 'libhost_native' in maps)\n"
        "print('REF', 'libhoraedb_native' in maps)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "PORT True" in out.stdout and "REF False" in out.stdout


def test_host_library_build_failure_raises_without_fallback(tmp_path,
                                                             monkeypatch):
    """A source that does not compile: every entry, and ingest's batch
    hash, raise with the compiler's output; none returns a numpy
    result."""
    import numpy as np

    from horaedb_tpu_torch import native
    from horaedb_tpu_torch.common.error import Error
    from horaedb_tpu_torch.metric_engine.types import tsids_of_keys

    bad = tmp_path / "host_native.cpp"
    bad.write_text('extern "C" int broken( { return 0; }\n')
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    for call in (lambda: tsids_of_keys([b"cpu{host=a}"]),
                 lambda: native.seahash64_batch([b"a"]),
                 lambda: native.run_starts_i64([np.arange(3)]),
                 lambda: native.snapshot_encode(
                     np.zeros(1, dtype=native.RECORD_DTYPE)),
                 native.available):
        with pytest.raises(Error, match="host library build failed") as err:
            call()
        assert "error" in str(err.value)
    assert not native.is_loaded()
    assert not os.listdir(tmp_path / "build")


def test_import_pulls_in_no_jax_and_no_reference_module():
    # a subprocess: this test process has JAX loaded by tests/conftest.py
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'horaedb_tpu'\n"
        "             or m.startswith('horaedb_tpu.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


def test_sources_import_neither_jax_nor_the_jax_package():
    offenders = []
    for root, _dirs, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                for n in names:
                    top = n.split(".")[0]
                    if top in ("jax", "jaxlib", "horaedb_tpu"):
                        offenders.append(f"{path}:{node.lineno}: {n}")
    assert not offenders, offenders


def test_engine_open_without_device_refuses_cpu_fallback(monkeypatch):
    import torch

    from horaedb_tpu_torch.common.error import Error
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import MemoryObjectStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Error, match="CUDA"):
        asyncio.run(MetricEngine.open("t", MemoryObjectStore()))


@pytest.mark.parametrize("layout", ["chunked", "rollup"])
def test_chunked_and_rollup_engines_refuse_cpu_fallback(monkeypatch, layout):
    """The chunked layout and the rollup tiers open on the card too: no
    card, no engine — nothing of either opens on the CPU unasked."""
    import torch

    from horaedb_tpu_torch.common.error import Error
    from horaedb_tpu_torch.metric_engine import MetricEngine
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.rollup import RollupConfig

    kw = ({"chunked_data": True} if layout == "chunked" else
          {"rollup_config": RollupConfig(enabled=True, specs=["cpu"])})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Error, match="CUDA"):
        asyncio.run(MetricEngine.open("t", MemoryObjectStore(), **kw))


def test_agent_service_refuses_cpu_fallback(monkeypatch):
    """A scan agent's reader opens on the card: no card, no agent,
    unless the caller asks for the CPU."""
    import torch

    from horaedb_tpu_torch.common.error import Error
    from horaedb_tpu_torch.objstore import MemoryObjectStore
    from horaedb_tpu_torch.scanagent import AgentService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Error, match="CUDA"):
        AgentService(MemoryObjectStore())
    service = AgentService(MemoryObjectStore(), device="cpu")
    assert service.device.type == "cpu"
    service.runtimes.close()


def test_scanagent_cli_refuses_to_start_without_a_card(tmp_path):
    """`python -m horaedb_tpu_torch.scanagent` defaults to --device
    cuda: on a machine without a card it exits with the error before
    it binds a port."""
    code = (
        "import sys, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from horaedb_tpu_torch.scanagent.__main__ import main\n"
        f"main(['--data-dir', {str(tmp_path)!r}, '--port', '0'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "needs a CUDA device" in out.stderr


def test_kernel_wrapper_takes_plain_only_for_cpu_tensors():
    """On the CPU the wrapper runs the plain version and counts no
    launch; a tensor on any other device is never served by it."""
    import torch

    from horaedb_tpu_torch.common.error import Error
    from horaedb_tpu_torch.ops import bucket_agg

    ts = torch.zeros((1, 128), dtype=torch.int32)
    gid = torch.zeros((1, 128), dtype=torch.int32)
    vals = torch.ones((1, 128), dtype=torch.float32)
    before = bucket_agg.LAUNCHES["bucket_window_partials"]
    out = bucket_agg.bucket_window_partials(
        ts, gid, vals, None, None, None, 4, 100, num_groups=2, width=4,
        which=("avg",))
    assert bucket_agg.LAUNCHES["bucket_window_partials"] == before
    assert float(out["count"].sum()) == 128.0
    meta = ts.to("meta")
    with pytest.raises(Error, match="cuda or cpu"):
        bucket_agg.bucket_window_partials(
            meta, gid.to("meta"), vals.to("meta"), None, None, None, 4, 100,
            num_groups=2, width=4, which=("avg",))
