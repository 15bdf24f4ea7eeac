"""The PyTorch port's multi-process tier (horaedb_tpu_torch/parallel/
multihost.py): torch.distributed collectives across processes, gloo on
the CPU.  tests/torch_multihost_worker.py is the port's twin of
tests/multihost_worker.py: each worker joins the group with 4 local cpu
slots, contributes only ITS OWN windows to the global downsample, and
writes the replicated grids it observed.

Tier 1 runs the single-process worker (the worker script end to end:
the group, the global downsample program and the npz contract); the
two-process run, whose grids can only equal a numpy aggregate over ALL
windows if the combine crossed the process boundary, is marked slow as
the JAX package's is."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

NUM_GROUPS, NUM_BUCKETS, CAP, BUCKET_MS = 8, 4, 128, 60_000


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, nprocs: int) -> list[str]:
    coordinator = f"127.0.0.1:{_free_port()}"
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_multihost_worker.py")
    outs = [str(tmp_path / f"out{r}.npz") for r in range(nprocs)]
    procs = [subprocess.Popen(
        [sys.executable, worker, coordinator, str(nprocs), str(r), outs[r],
         "cpu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(nprocs)]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), \
        "worker failed:\n" + "\n---\n".join(logs)
    return outs


def _truth(n_global: int):
    rng = np.random.default_rng(99)
    ts = rng.integers(0, NUM_BUCKETS * BUCKET_MS,
                      (n_global, CAP)).astype(np.int32)
    gid = rng.integers(0, NUM_GROUPS, (n_global, CAP)).astype(np.int32)
    vals = (rng.random((n_global, CAP)) * 100).astype(np.float32)
    nv = CAP - 8
    t = np.concatenate([ts[i, :nv] for i in range(n_global)])
    g = np.concatenate([gid[i, :nv] for i in range(n_global)])
    v = np.concatenate([vals[i, :nv] for i in range(n_global)])
    cell = g.astype(np.int64) * NUM_BUCKETS + t // BUCKET_MS
    ncell = NUM_GROUPS * NUM_BUCKETS
    count = np.bincount(cell, minlength=ncell).reshape(NUM_GROUPS,
                                                       NUM_BUCKETS)
    total = np.bincount(cell, weights=v.astype(np.float64),
                        minlength=ncell).reshape(NUM_GROUPS, NUM_BUCKETS)
    mx = np.full((NUM_GROUPS, NUM_BUCKETS), -np.inf)
    mn = np.full((NUM_GROUPS, NUM_BUCKETS), np.inf)
    np.maximum.at(mx, (g, t // BUCKET_MS), v.astype(np.float64))
    np.minimum.at(mn, (g, t // BUCKET_MS), v.astype(np.float64))
    last = np.full((NUM_GROUPS, NUM_BUCKETS), np.nan)
    lts = np.full((NUM_GROUPS, NUM_BUCKETS), -1, dtype=np.int64)
    # later windows overwrite equal-ts earlier rows: ties go to the
    # higher rank
    for ti, gi, vi in zip(t, g, v):
        c = (gi, ti // BUCKET_MS)
        if ti >= lts[c]:
            lts[c], last[c] = ti, vi
    return count, total, mn, mx, last


def _check(a, n_global: int):
    count, total, mn, mx, last = _truth(n_global)
    occ = count > 0
    np.testing.assert_array_equal(a["count"], count)
    np.testing.assert_allclose(a["sum"], total, rtol=1e-5)
    np.testing.assert_array_equal(a["max"][occ], mx[occ].astype(np.float32))
    np.testing.assert_array_equal(a["min"][occ], mn[occ].astype(np.float32))
    np.testing.assert_array_equal(a["last"][occ],
                                  last[occ].astype(np.float32))
    scores = np.where(occ, a["max"], -np.inf).max(axis=1)
    np.testing.assert_array_equal(a["top_idx"],
                                  np.argsort(-scores, kind="stable")[:3])


def test_single_process_worker_fast(tmp_path):
    """One worker (4 windows): the worker script end to end over a gloo
    group of one."""
    (out,) = _run_workers(tmp_path, 1)
    _check(np.load(out), 4)


@pytest.mark.slow
def test_two_process_global_downsample(tmp_path):
    """Two processes x 4 slots: both observe the same replicated grids,
    equal to a numpy aggregate over all 8 windows."""
    outs = _run_workers(tmp_path, 2)
    a, b = np.load(outs[0]), np.load(outs[1])
    for key in a.files:
        assert a[key].tobytes() == b[key].tobytes(), key
    _check(a, 8)
