"""The control of a cell's check: the plain reference put in the
engine's place and computed one precision below the configuration's
(every sample rounded to bfloat16, sums in float32), judged by the
cell's own comparison and limits.  It has to come out not correct.

    python3 perfbench/control.py --workload <name> --seed <n> [--seed <n> ...]

For each seed it generates the cell's data, answers as many queries as
a run compares (`check_sample` of the traffic), at the windows the
run's own seeded stream draws first, and prints one JSON line with the
compared numbers and the verdict.  It needs no card and runs no part of
the program."""

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


def control_answers(data, traffic: dict, fields: list, starts: list) -> dict:
    """{query index: {field: result}} in the engine's result shape, the
    series numbered by host."""
    from perfbench.reference import tsbs_downsample

    out = {}
    hosts = np.arange(data.cfg.num_hosts, dtype=np.uint64)
    for i, lo in enumerate(starts):
        out[i] = {}
        for f in fields:
            avg, count = tsbs_downsample.downsample(
                data.values[data.fields.index(f)], int(lo),
                traffic["window_ms"], traffic["bucket_ms"],
                data.cfg.start_ms, data.cfg.interval_ms,
                precision="bfloat16")
            out[i][f] = {"tsids": hosts, "aggs": {"avg": avg,
                                                  "count": count}}
    return out


def run(bench: dict, name: str, seed: int) -> dict:
    from perfbench import catalog, check, deploy, harness, loadgen, tsbs

    cell = catalog.workload(bench, name)
    config = catalog.config(bench, cell["config"])
    traffic = catalog.traffic(cell["traffic"])
    s = harness.seed_words(seed)
    data = tsbs.generate(deploy.tsbs_config(config, s))
    starts = loadgen.window_starts(traffic, config,
                                   np.random.default_rng([s, 1]),
                                   traffic["check_sample"])
    fields = loadgen.query_fields(traffic, config)
    answers = control_answers(data, traffic, fields, list(starts))
    keys = {h: series_key(data, h, config["metric"])
            for h in range(data.cfg.num_hosts)}
    numbers = check.compare(answers, dict(enumerate(starts)), keys, data,
                            traffic, config["metric"])
    correct, checks = check.judge(numbers, catalog.limits(name))
    return {"workload": name, "seed": seed, "correct": correct,
            "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench import catalog

    bench = catalog.benchmark()
    for seed in args.seed:
        print(json.dumps(run(bench, args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
