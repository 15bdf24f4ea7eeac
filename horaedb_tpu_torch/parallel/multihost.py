"""Multi-process mesh plumbing — the tier across processes (PyTorch port
of horaedb_tpu/parallel/multihost.py).

Inside one process the port runs every mesh slot from one controller
(parallel/scan.py).  Across processes it uses torch.distributed, where
the JAX package uses jax.distributed: each process contributes its own
segment windows, computes their partial grids on its local devices,
folds them in local rank order, and the cross-process combine runs as
collectives (all_reduce SUM for count and sum, MIN/MAX for min and max,
and the `last` winner by the latest timestamp, ties to the higher
global rank).  Every process receives the replicated result.  The
backend is gloo for CPU processes (the tests) and NCCL on cards.

The segment axis stays the one mesh axis: segments partition time, so
the cross-process combine is the same fold the single-process mesh
makes, over more slots.
"""

from __future__ import annotations

import numpy as np

from horaedb_tpu_torch.common.error import ensure


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_count: int | None = None,
               device: str = "cuda", timeout_s: float = 120.0) -> None:
    """Join (or form) a multi-process group: `coordinator_address` is
    host:port of rank 0's rendezvous (tcp).  `device` "cuda" uses NCCL
    and one card per process unless `local_device_count` slots are
    asked for; "cpu" uses gloo, with `local_device_count` CPU slots
    (the counterpart of the JAX package's virtual CPU devices).
    `timeout_s` bounds the rendezvous and every collective."""
    import datetime

    import torch
    import torch.distributed as dist

    from horaedb_tpu_torch.parallel import mesh as mesh_mod

    kind = torch.device(device).type
    if kind == "cuda":
        ensure(torch.cuda.is_available(),
               "no CUDA device for an NCCL group (pass device='cpu' for "
               "a gloo group)")
        n_cards = torch.cuda.device_count()
        card = torch.device("cuda", process_id % n_cards)
        torch.cuda.set_device(card)
        mesh_mod.set_local_devices([card] * (local_device_count or 1))
        backend = "nccl"
    else:
        mesh_mod.set_local_devices(["cpu"] * (local_device_count or 1))
        backend = "gloo"
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> tuple[int, int]:
    """(process_index, process_count) of the joined group."""
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


class GlobalMesh:
    """The 1-D segment mesh over every slot of every process: this
    process's `local` mesh plus its place in the group.  Global slot
    ranks run process by process, local slots in order."""

    def __init__(self, local, process_index: int, process_count: int):
        self.local = local
        self.process_index = process_index
        self.process_count = process_count

    @property
    def size(self) -> int:
        return self.local.size * self.process_count

    def global_rank(self, local_slot: int) -> int:
        return self.process_index * self.local.size + local_slot


def global_segment_mesh() -> GlobalMesh:
    """A 1-D mesh over EVERY slot of EVERY process, on the segment axis
    the single-process mesh uses."""
    from horaedb_tpu_torch.parallel.mesh import local_devices, segment_mesh

    idx, count = process_info()
    devs = local_devices(_group_device())
    ensure(len(devs) > 0, "no devices for the global mesh")
    return GlobalMesh(segment_mesh(devices=devs), idx, count)


def _group_device() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def host_local_rows_to_global(mesh: GlobalMesh, arr: np.ndarray):
    """This process's (n_local, ...) segment rows, placed over its local
    slots (every process must contribute the same n_local: pad with
    empty windows, whose n_valid 0 rows aggregate to nothing)."""
    from horaedb_tpu_torch.parallel.scan import shard_leading_axis

    arr = np.asarray(arr)
    ensure(arr.shape[0] == mesh.local.size,
           f"{arr.shape[0]} local rows for {mesh.local.size} local slots")
    return shard_leading_axis(mesh.local, arr)


def _all_reduce(t, op):
    import torch.distributed as dist

    dist.all_reduce(t, op=op)
    return t


def downsample_query_global(mesh: GlobalMesh, *, num_groups: int,
                            num_buckets: int, k: int):
    """The multi-slot downsample + top-k program over the GLOBAL mesh:
    per-slot partial grids (the hand kernel), the local fold in rank
    order, the cross-process all_reduce combine, and the finalize and
    top-k on the replicated result, which every process returns.

    fn(ts, gid, vals, n_valid, bucket_ms): ts/gid/vals this process's
    rows (host_local_rows_to_global or (n_local, capacity) arrays),
    n_valid its (n_local,) host rows, bucket_ms a scalar."""
    import torch
    import torch.distributed as dist

    from horaedb_tpu_torch.parallel import scan as pscan

    local = mesh.local
    R = dist.ReduceOp

    def fn(ts, gid, vals, n_valid, bucket_ms):
        ts, gid, vals = (pscan.shard_leading_axis(local, a)
                         for a in (ts, gid, vals))
        nv = pscan._host_rows(n_valid, local.size)
        bms = pscan._scalar(bucket_ms)
        ps = []
        for i, dev in enumerate(local.devices):
            with pscan.on_device(dev):
                ps.append(pscan._shard_partial(
                    ts.blocks[i], gid.blocks[i], vals.blocks[i], nv[i], bms,
                    num_groups=num_groups, num_buckets=num_buckets))
        ranks = [mesh.global_rank(i) for i in range(local.size)]
        p = pscan._combine_partials(ps, ranks=ranks)
        # the local fold's `last` carries its winning global rank so the
        # cross-process tie still goes to the higher rank
        dev = p["count"].device
        elig = [q["last_ts"].to(dev) == p["last_ts"] for q in ps]
        l_rank = pscan._reduce(
            [torch.where(e, torch.full_like(p["last_ts"], r),
                         torch.full_like(p["last_ts"], -1))
             for e, r in zip(elig, ranks)], torch.maximum)
        out = {"count": _all_reduce(p["count"].clone(), R.SUM),
               "sum": _all_reduce(p["sum"].clone(), R.SUM),
               "min": _all_reduce(p["min"].clone(), R.MIN),
               "max": _all_reduce(p["max"].clone(), R.MAX)}
        g_ts = _all_reduce(p["last_ts"].clone(), R.MAX)
        mine = p["last_ts"] == g_ts
        g_rank = _all_reduce(torch.where(mine, l_rank,
                                         torch.full_like(l_rank, -1)),
                             R.MAX)
        win = mine & (l_rank == g_rank)
        out["last"] = _all_reduce(
            torch.where(win, p["last"], torch.zeros_like(p["last"])), R.SUM)
        out["last_ts"] = g_ts
        return pscan._finalize_topk(out, k)

    return fn
