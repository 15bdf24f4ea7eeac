"""Build of the port's hand-written CUDA kernels: nvcc compiles one
source in csrc/ into a shared library with a plain C interface under
horaedb_tpu_torch/build/ at first use, keyed by the source's content
(an edited source rebuilds), and ctypes loads it.  Nothing here runs
at import: the CPU tests import every module of the port."""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
import time

from horaedb_tpu_torch.common.error import Error

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# the compiler's report (registers, spills) of each source built by
# this process
_BUILD_LOGS: dict = {}


def library_path(source: str) -> str:
    stem = os.path.splitext(os.path.basename(source))[0]
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def nvcc_command(source: str, out_path: str) -> list:
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = "nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", out_path, source]


def build(source: str) -> str:
    """Compile `source` unless its library exists; return the library
    path."""
    path = library_path(source)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(source, tmp), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise Error(f"nvcc failed for {source}:\n{proc.stderr}")
    os.replace(tmp, path)
    _BUILD_LOGS[source] = proc.stderr
    # the port's counterpart of a compile: once per source hash
    from horaedb_tpu_torch.common import deviceprof

    deviceprof.note_build(source, time.perf_counter() - t0)
    return path


def build_log(source: str) -> str:
    return _BUILD_LOGS.get(source, "")
