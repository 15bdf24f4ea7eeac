"""TSBS `cpu-only` data, generated from a seed with numpy.

Started as a copy of the port's `horaedb_tpu_torch/bench/tsbs.py`
(`CPU_FIELDS`, `REGIONS`, `TsbsConfig`, `host_names`), extended to the
use case's whole tag set.  The benchmark keeps its own copy so that a
change to the program cannot change the data it is measured on.

Taken from TSBS (github.com/timescale/tsbs, `pkg/data/usecases/devops`):

- one measurement `cpu` with the 10 float fields of `CPU_FIELDS`;
- the 10 tags of a host, `TAG_KEYS`, and the value set of each:
  `hostname` is `host_<i>`; `region` one of 9 AWS regions, `datacenter`
  one of that region's zones; `rack` "0".."99"; `os`, `arch`, `team`,
  `service` "0".."19", `service_version` "0".."1" and
  `service_environment` from TSBS's choice lists;
- one point per host every 10 s, all hosts at every tick;
- each field a clamped random walk: a step drawn from N(0, 1), the
  value kept in [0, 100], the first value uniform in [0, 100).

Assumed (TSBS fixes no such thing, or fixes it through its own Go
random stream, which is not reproduced):

- every random draw comes from `numpy.random.default_rng(seed)` in the
  order of `generate`: the tags of all hosts, then the first values,
  then the steps tick by tick;
- a host's tags are drawn uniformly and independently from the value
  sets above (TSBS draws them uniformly too, from its own stream);
- values are float64 as TSBS writes them; the engine stores float64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CPU_FIELDS = [
    "usage_user", "usage_system", "usage_idle", "usage_nice", "usage_iowait",
    "usage_irq", "usage_softirq", "usage_steal", "usage_guest",
    "usage_guest_nice",
]

REGIONS = ["us-east-1", "us-west-1", "us-west-2", "eu-west-1", "eu-central-1",
           "ap-southeast-1", "ap-southeast-2", "ap-northeast-1",
           "sa-east-1"]

DATACENTERS = {
    "us-east-1": ["us-east-1a", "us-east-1b", "us-east-1c", "us-east-1e"],
    "us-west-1": ["us-west-1a", "us-west-1b"],
    "us-west-2": ["us-west-2a", "us-west-2b", "us-west-2c"],
    "eu-west-1": ["eu-west-1a", "eu-west-1b", "eu-west-1c"],
    "eu-central-1": ["eu-central-1a", "eu-central-1b"],
    "ap-southeast-1": ["ap-southeast-1a", "ap-southeast-1b"],
    "ap-southeast-2": ["ap-southeast-2a", "ap-southeast-2b"],
    "ap-northeast-1": ["ap-northeast-1a", "ap-northeast-1c"],
    "sa-east-1": ["sa-east-1a", "sa-east-1b", "sa-east-1c"],
}

# the value sets of the tags drawn independently of the others
CHOICES = {
    "rack": [str(i) for i in range(100)],
    "os": ["Ubuntu16.10", "Ubuntu16.04LTS", "Ubuntu15.10"],
    "arch": ["x64", "x86"],
    "team": ["SF", "NYC", "LON", "CHI"],
    "service": [str(i) for i in range(20)],
    "service_version": ["0", "1"],
    "service_environment": ["production", "staging", "test"],
}

TAG_KEYS = ["hostname", "region", "datacenter", "rack", "os", "arch",
            "team", "service", "service_version", "service_environment"]


@dataclass
class TsbsConfig:
    num_hosts: int = 100
    num_fields: int = 10
    interval_ms: int = 10_000
    start_ms: int = 1_700_000_000_000
    span_ms: int = 3_600_000
    seed: int = 42

    @property
    def num_ticks(self) -> int:
        return self.span_ms // self.interval_ms


def host_name(i: int) -> str:
    return f"host_{i}"


def host_names(n: int) -> list[str]:
    return [host_name(i) for i in range(n)]


@dataclass
class TsbsData:
    """The generated data set.  `values[f, h, t]` is field `f` of host
    `h` at `start_ms + t * interval_ms`; `tags[key]` holds each host's
    value of a tag as a code into `tag_values[key]`."""

    cfg: TsbsConfig
    fields: list
    tag_values: dict
    tags: dict
    values: np.ndarray

    def host_tags(self, h: int) -> dict:
        return {k: self.tag_values[k][int(self.tags[k][h])]
                for k in TAG_KEYS}


def generate(cfg: TsbsConfig) -> TsbsData:
    rng = np.random.default_rng(cfg.seed)
    n = cfg.num_hosts
    tag_values = {"hostname": host_names(n), "region": list(REGIONS)}
    tags = {"hostname": np.arange(n, dtype=np.int32),
            "region": rng.integers(0, len(REGIONS), n).astype(np.int32)}
    # a datacenter belongs to its host's region: the codes index the
    # flat list of every region's zones
    flat_dc = [dc for r in REGIONS for dc in DATACENTERS[r]]
    first_dc = np.cumsum([0] + [len(DATACENTERS[r]) for r in REGIONS])
    per_region = np.array([len(DATACENTERS[r]) for r in REGIONS])
    region = tags["region"]
    pick = (rng.random(n) * per_region[region]).astype(np.int32)
    tag_values["datacenter"] = flat_dc
    tags["datacenter"] = (first_dc[region] + pick).astype(np.int32)
    for key, choices in CHOICES.items():
        tag_values[key] = list(choices)
        tags[key] = rng.integers(0, len(choices), n).astype(np.int32)

    fields = CPU_FIELDS[:cfg.num_fields]
    # tick-major while walking (each tick one contiguous row), then laid
    # out field by host by tick
    walk = np.empty((cfg.num_ticks, len(fields), n), dtype=np.float64)
    walk[0] = rng.random((len(fields), n)) * 100.0
    for t in range(1, cfg.num_ticks):
        np.clip(walk[t - 1] + rng.standard_normal((len(fields), n)), 0.0,
                100.0, out=walk[t])
    values = np.ascontiguousarray(walk.transpose(1, 2, 0))
    return TsbsData(cfg, fields, tag_values, tags, values)
