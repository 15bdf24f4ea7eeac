"""The check has to fail: the control (the reference one precision
below the configuration's, in the engine's place), and a run whose
timed path is broken underneath the harness, once for each fault a
query cell can have."""

import numpy as np
import pytest
import torch

from perfbench import catalog, control
from perfbench.tests import support

CELLS = [w["name"] for w in catalog.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(monkeypatch, cell):
    support.small_config(monkeypatch)
    for seed in (11, 2**35 + 3, 977):
        out = control.run(catalog.benchmark(), cell, seed)
        assert not out["correct"]
        gap = out["checks"]["avg_gap"]
        assert gap["value"] > 3 * gap["limit"]


def altered(res):
    """One mean of the first row moved by 0.01."""
    avg = res["aggs"]["avg"]
    if isinstance(avg, torch.Tensor):
        avg = avg.clone()
    else:
        avg = np.array(avg, copy=True)
    avg[0, 0] += 0.01
    res["aggs"]["avg"] = avg
    return res


def half_rows(res):
    """Half of each cell's rows left out, the mean over the rest: the
    count halves."""
    res["aggs"]["count"] = res["aggs"]["count"] // 2
    return res


def relabelled(res):
    """Rows handed to the wrong series."""
    res["tsids"] = list(res["tsids"][1:]) + list(res["tsids"][:1])
    return res


class Stale:
    """Every answer after the first is the first query's own: state
    returned unchanged."""

    def __init__(self):
        self.first = {}

    def __call__(self, res, key):
        return self.first.setdefault(key, res)


FAULTS = ["altered", "half_rows", "relabelled", "stale"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    from horaedb_tpu_torch.metric_engine import MetricEngine

    stale = Stale()
    fix = {"altered": altered, "half_rows": half_rows,
           "relabelled": relabelled}.get(fault)

    def broken(res, key):
        return stale(res, key) if fault == "stale" else fix(res)

    one, multi = MetricEngine.query_downsample, \
        MetricEngine.query_downsample_multi

    async def query_downsample(self, *a, **kw):
        return broken(await one(self, *a, **kw), kw.get("field"))

    async def query_downsample_multi(self, *a, **kw):
        out = await multi(self, *a, **kw)
        return {f: broken(r, f) for f, r in out.items()}

    monkeypatch.setattr(MetricEngine, "query_downsample", query_downsample)
    monkeypatch.setattr(MetricEngine, "query_downsample_multi",
                        query_downsample_multi)
    run = support.run_small(monkeypatch, cell, seconds=8.0)
    assert not run.result["correct"], run.result["checks"]
