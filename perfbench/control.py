"""The control of a cell's check: the plain reference put in the
engine's place and computed one precision below the configuration's
(every sample rounded to bfloat16, sums in float32), judged by the
cell's own comparison and limits.  It has to come out not correct.

    python3 perfbench/control.py --workload <name> --seed <n> [--seed <n> ...]
    python3 perfbench/control.py --config <name> --traffic <name> \
        --limits <file> --seed <n> [--seed <n> ...]

The second form runs a mix that no cell uses yet, on a configuration of
`BENCHMARK.json`, against the limits in `<file>` (the `limits` object
of a limits file).

For each seed it generates the cell's data, answers as many queries as
a run compares (`check_sample` of the traffic), at the windows and over
the host sets that the run's own seeded streams draw first, in the
aggregates the mix asks for, and prints one JSON line with the compared
numbers and the verdict.  It needs no card and runs no part of the
program."""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def series_key(data, h: int, metric: str) -> bytes:
    tags = data.host_tags(h)
    return (metric + "{" + ",".join(f"{k}={tags[k]}" for k in sorted(tags))
            + "}").encode()


def control_answers(data, traffic: dict, fields: list, starts: list,
                    hosts: list) -> dict:
    """{query index: {field: result}} in the engine's result shape, the
    series numbered by host; query `i` reads the hosts `hosts[i]`, or
    every host where that is None."""
    from perfbench.reference import tsbs_downsample

    out = {}
    every = np.arange(data.cfg.num_hosts)
    for i, lo in enumerate(starts):
        named = every if hosts[i] is None else hosts[i]
        out[i] = {}
        for f in fields:
            grids = tsbs_downsample.downsample(
                data.values[data.fields.index(f)], int(lo),
                traffic["window_ms"], traffic["bucket_ms"],
                data.cfg.start_ms, data.cfg.interval_ms,
                aggs=tuple(traffic["aggs"]), hosts=named,
                precision="bfloat16")
            out[i][f] = {"tsids": named.astype(np.uint64), "aggs": grids}
    return out


def run(bench: dict, name: str, seed: int) -> dict:
    """The control of cell `name` on `seed`."""
    from perfbench import catalog

    cell = catalog.workload(bench, name)
    out = run_mix(catalog.config(bench, cell["config"]),
                  catalog.traffic(cell["traffic"]), catalog.limits(name),
                  seed)
    return {"workload": name, **out}


def run_mix(config: dict, traffic: dict, limits: dict, seed: int) -> dict:
    """The control of a configuration and a mix on `seed`, judged by
    `limits`."""
    from perfbench import check, deploy, harness, loadgen, tsbs

    s = harness.seed_words(seed)
    data = tsbs.generate(deploy.tsbs_config(config, s))
    starts = loadgen.window_starts(traffic, config,
                                   np.random.default_rng([s, 1]),
                                   traffic["check_sample"])
    draw = loadgen.host_drawer(traffic, config, [s, 3])
    hosts = [draw(i) for i in range(len(starts))]
    fields = loadgen.query_fields(traffic, config)
    answers = control_answers(data, traffic, fields, list(starts), hosts)
    keys = {h: series_key(data, h, config["metric"])
            for h in range(data.cfg.num_hosts)}
    numbers = check.compare(answers, dict(enumerate(starts)), keys, data,
                            traffic, config["metric"],
                            dict(enumerate(hosts)))
    correct, checks = check.judge(numbers, limits)
    return {"seed": seed, "correct": correct, "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--config")
    p.add_argument("--traffic")
    p.add_argument("--limits")
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    if not args.workload and not (args.config and args.traffic
                                  and args.limits):
        p.error("give --workload, or --config, --traffic and --limits")
    sys.path.insert(0, ROOT)
    from perfbench import catalog

    bench = catalog.benchmark()
    for seed in args.seed:
        if args.workload:
            out = run(bench, args.workload, seed)
        else:
            out = {"config": args.config, "traffic": args.traffic,
                   **run_mix(catalog.config(bench, args.config),
                             catalog.traffic(args.traffic),
                             catalog.load_json(args.limits)["limits"],
                             seed)}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
