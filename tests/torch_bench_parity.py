"""Shared by the test_torch_bench_* files: one bench suite config run in
both packages on the CPU at 20,000 rows and 2 iters (the JAX package's
runner as its own tier-1 test runs it, the port's with device="cpu" on
eight `cpu` mesh slots, the counterpart of the JAX package's eight
virtual devices), then the same result keys and unit, the same
deterministic fields and a result line that is JSON."""

import json

import horaedb_tpu.bench.suite as ref_suite
import horaedb_tpu.storage.read as ref_read
import horaedb_tpu_torch.bench.suite as port_suite
import horaedb_tpu_torch.storage.read as port_read
from horaedb_tpu_torch.parallel import mesh

# keys the port's result adds to the reference's: config 16's note says
# that the port runs its host and xla_host legs on one route
PORT_ONLY = {16: {"note"}}


def _leg_counts(result: dict, legs) -> dict:
    """The request counts of each (tenant, path) or phase of the legs."""
    return {leg: ({k: v["n"] for k, v in result[leg].items()}
                  if "n" not in result[leg] else result[leg]["n"])
            for leg in legs}


def _bytes_of(result: dict, legs) -> dict:
    """The byte and GET counts of config 17's legs (not their times)."""
    return {leg: {k: v for k, v in result[leg].items() if k != "p50_ms"}
            for leg in legs}


def _fallbacks(read_mod) -> dict:
    """A package's process-wide mesh fallback counts by reason."""
    return {r: int(c.value)
            for r, c in read_mod._MESH_FALLBACK_CHILDREN.items() if c.value}


def _since(result: dict, before: dict) -> dict:
    """The result with its `mesh_fallbacks` (process-wide counts, as the
    reference reports them) cut to the fallbacks taken during the run:
    tests run before it in the same process count there too."""
    if "mesh_fallbacks" not in result:
        return result
    now = result["mesh_fallbacks"]
    return dict(result, mesh_fallbacks={
        r: n - before.get(r, 0) for r, n in now.items()
        if n - before.get(r, 0)})


def run_both(config: int, deterministic, nested=None) -> tuple:
    before = _fallbacks(ref_read)
    ref = _since(ref_suite.RUNNERS[config](rows=20_000, iters=2), before)
    detail: dict = {}
    before = _fallbacks(port_read)
    with mesh.local_devices_scope(["cpu"] * 8):
        got = port_suite.RUNNERS[config](rows=20_000, iters=2, device="cpu",
                                         detail=detail)
    got = _since(got, before)
    assert set(got) - set(ref) == PORT_ONLY.get(config, set())
    assert set(ref) <= set(got)
    assert got["unit"] == ref["unit"]
    for k in deterministic:
        assert got[k] == ref[k], (k, got[k], ref[k])
    if nested is not None:
        fn, legs = nested
        assert fn(got, legs) == fn(ref, legs)
    assert got["value"] > 0
    json.dumps(got)  # a result line
    # on the CPU no wrapper launches its kernel
    for k, v in detail.items():
        if k.endswith("launches"):
            assert not any(v.values()), (k, v)
    return got, ref, detail
