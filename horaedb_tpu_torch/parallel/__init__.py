"""Multi-device execution: the segment mesh, the 2-D (time, series) scan
mesh and their programs (PyTorch port of horaedb_tpu/parallel).

Time segments are independent by construction, so segments ARE the
shard axis: each slot merge-dedups and partially aggregates its own
windows, and only the small dense (group, bucket) grids cross slots.
One controller process runs every slot (parallel/scan.py); the
multi-process tier (parallel/multihost.py) alone uses
torch.distributed.
"""

# Lazy exports (PEP 562): importing this package imports no torch, so
# `from horaedb_tpu_torch.parallel import multihost` stays cheap
_EXPORTS = {
    "segment_mesh": "horaedb_tpu_torch.parallel.mesh",
    "scan_mesh": "horaedb_tpu_torch.parallel.mesh",
    "default_scan_shape": "horaedb_tpu_torch.parallel.mesh",
    "SEGMENT_AXIS": "horaedb_tpu_torch.parallel.mesh",
    "TIME_AXIS": "horaedb_tpu_torch.parallel.mesh",
    "SERIES_AXIS": "horaedb_tpu_torch.parallel.mesh",
    "sharded_downsample_query": "horaedb_tpu_torch.parallel.scan",
    "sharded_merge_dedup": "horaedb_tpu_torch.parallel.scan",
    "sharded_remap_partials": "horaedb_tpu_torch.parallel.scan",
    "mesh_run_partials": "horaedb_tpu_torch.parallel.scan",
    "multihost": "horaedb_tpu_torch.parallel.multihost",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(_EXPORTS[name])
    val = mod if name == "multihost" else getattr(mod, name)
    globals()[name] = val  # cache: next access skips __getattr__
    return val
