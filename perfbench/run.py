"""Run one cell of the benchmark once, on the card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds `BENCHMARK.json` and the
program (`horaedb_tpu_torch`).  The last line of standard output is one
JSON object (`correct`, `attempted`, `failed`, `metrics`, `device`,
with `--trace 1` also `breakdown`, and last `checks`: each compared
number beside its limit); the same numbers are the last lines of
standard error.  Without a CUDA card, or with fewer cards than the cell
asks for, it prints no result and exits with 2; if JAX or the JAX
package was loaded into the process, with 3."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "horaedb_tpu"}


def loaded_forbidden() -> list:
    """Modules of JAX or the JAX package in this process, compared by
    their whole top-level name."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def finite(obj):
    """`obj` with every non-finite float written as a string, so the
    line stays JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    return obj


def card_line() -> str:
    """The card's name and power limit, from `nvidia-smi`."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    from perfbench import catalog

    bench = catalog.benchmark()
    cell = catalog.workload(bench, args.workload)

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(device)
    print(f"perfbench: {args.workload} seed {args.seed} on {card_line()}",
          file=sys.stderr, flush=True)

    from perfbench import harness

    run = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T_START, card)
    print(f"perfbench: memory_peak_bytes "
          f"{run.result['device']['memory_peak_bytes']} "
          f"info {json.dumps(run.info)}", file=sys.stderr)
    found = loaded_forbidden()
    if found:
        print(f"perfbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in run.result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check correct {run.result['correct']}", file=sys.stderr,
          flush=True)
    print(json.dumps(finite(run.result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
