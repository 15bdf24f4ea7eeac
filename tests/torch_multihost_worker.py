"""Worker process for tests/test_torch_multihost.py: the PyTorch port's
twin of tests/multihost_worker.py.

Usage: python torch_multihost_worker.py <coordinator> <nprocs> <rank>
<outfile> [device]

Joins the process group (gloo on the CPU, NCCL with device cuda) with 4
local slots, contributes rank-dependent window data to the global
downsample query, and writes the replicated result grids it observed to
<outfile> (.npz).  Imports nothing of JAX.
"""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np


def main(coordinator: str, nprocs: int, rank: int, outfile: str,
         device: str = "cpu") -> None:
    # the package import first: it must not need the group to exist
    from horaedb_tpu_torch.parallel import multihost

    multihost.initialize(coordinator, nprocs, rank, local_device_count=4,
                         device=device)
    try:
        idx, count = multihost.process_info()
        assert (idx, count) == (rank, nprocs), (idx, count)
        mesh = multihost.global_segment_mesh()
        n_global = mesh.size
        assert n_global == 4 * nprocs, n_global

        # deterministic global dataset: every process can build all of
        # it, but each contributes only ITS OWN four windows
        NUM_GROUPS, NUM_BUCKETS, CAP, K = 8, 4, 128, 3
        bucket_ms = 60_000
        rng = np.random.default_rng(99)
        ts = rng.integers(0, NUM_BUCKETS * bucket_ms,
                          (n_global, CAP)).astype(np.int32)
        gid = rng.integers(0, NUM_GROUPS, (n_global, CAP)).astype(np.int32)
        vals = (rng.random((n_global, CAP)) * 100).astype(np.float32)
        n_valid = np.full(n_global, CAP - 8, dtype=np.int32)

        lo, hi = rank * 4, rank * 4 + 4
        fn = multihost.downsample_query_global(
            mesh, num_groups=NUM_GROUPS, num_buckets=NUM_BUCKETS, k=K)
        final, top_vals, top_idx = fn(
            multihost.host_local_rows_to_global(mesh, ts[lo:hi]),
            multihost.host_local_rows_to_global(mesh, gid[lo:hi]),
            multihost.host_local_rows_to_global(mesh, vals[lo:hi]),
            n_valid[lo:hi], bucket_ms)
        np.savez(outfile,
                 **{k: v.cpu().numpy() for k, v in final.items()},
                 top_vals=top_vals.cpu().numpy(),
                 top_idx=top_idx.cpu().numpy())
    finally:
        multihost.shutdown()
    print(f"rank {rank}: wrote {outfile}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         *(sys.argv[5:6]))
