"""`python -m horaedb_tpu_torch.bench [--device cuda|cpu]`: the bench.py
twin on the PyTorch port.  Prints ONE JSON line:

  {"metric": ..., "value": <p50>, "unit": ..., "vs_baseline": ...,
   ..., "backend": "cuda", "card": "<nvidia-smi name, power limit>",
   "fallback": false, "launches": {<kernel>: n}, "max_rss_mb": ...}

Env knobs (bench.py's, with its defaults): BENCH_ROWS (10_000_000),
BENCH_ITERS (20), BENCH_CONFIG (1 = the end-to-end engine headline,
0 = the device kernel microbench, 2-23 = horaedb_tpu_torch.bench.suite's
RUNNERS), BENCH_HOSTS (100) and BENCH_AGG_WINDOWS (config 1's windows
per aggregation round).  The on-disk configs (suite.ON_DISK) put their
stores and WALs under the system's temporary directory.  The bench runs
on the card; with no card it raises, and --device cpu runs it on the
CPU with `fallback: true`.
"""

from __future__ import annotations

import argparse
import json
import os
import resource


def main(argv=None) -> None:
    from horaedb_tpu_torch.bench.headline import (
        run_engine_headline,
        run_kernel_microbench,
    )
    from horaedb_tpu_torch.bench.suite import RUNNERS, provenance
    from horaedb_tpu_torch.common.error import Error
    from horaedb_tpu_torch.ops import bucket_agg, merge

    parser = argparse.ArgumentParser("python -m horaedb_tpu_torch.bench")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    rows = int(os.environ.get("BENCH_ROWS", 10_000_000))
    iters = int(os.environ.get("BENCH_ITERS", 20))
    raw = os.environ.get("BENCH_CONFIG", "1")
    try:
        config = int(raw)
    except ValueError:
        raise Error(f"BENCH_CONFIG must be 0-23, got {raw!r}") from None
    if config not in (0, 1) and config not in RUNNERS:
        raise Error(f"BENCH_CONFIG must be 0-23, got {config}")
    prov = provenance(args.device)  # raises before any work without a card
    if config == 1:
        result = run_engine_headline(rows, iters, device=args.device)
    elif config == 0:
        result = run_kernel_microbench(rows, iters, device=args.device)
    else:
        result = RUNNERS[config](rows, iters, device=args.device)
    # a config's own backend/fallback labels win (config 6 is pure host
    # work and must never read as a device number)
    for k, v in prov.items():
        result.setdefault(k, v)
    # the hand kernels' launches in this process (0 on the CPU, where
    # the wrappers take their plain versions)
    result["launches"] = {**bucket_agg.LAUNCHES, **merge.LAUNCHES}
    result["max_rss_mb"] = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
