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
