"""The port's bench suite configs 17-19, 22 and 23 beside the JAX
package's, on the CPU (tests/torch_bench_parity.py): the same result
keys and unit, the same deterministic fields (bytes, GETs, rounds,
egress cells).  The mesh configs run on eight `cpu` slots."""

import pytest

from torch_bench_parity import _bytes_of, run_both

DETERMINISTIC = {
    17: ("unit", "metric", "rows", "store_latency_ms", "reps_per_leg",
         "bit_identical", "bytes_reduction_x", "vs_baseline",
         "bar_bytes_reduction", "bar_bytes_reduction_met"),
    18: ("unit", "metric", "rows"),
    19: ("unit", "metric", "rows", "mesh_shape", "mesh_rounds",
         "mesh_parts", "windows_per_round", "topk_egress_cells",
         "topk_egress_bound", "topk_dense_grid_cells", "topk_served",
         "mesh_fallbacks", "bit_identical"),
    22: ("unit", "metric", "rows", "mesh_shape", "mesh_rounds",
         "meshdecode_rounds", "device_decoded_rows",
         "kway_merge_dispatches", "full_device_sorts",
         "additive_topk_cells_100", "additive_topk_cells_800",
         "additive_topk_bound", "additive_topk_dense_cells_800",
         "mesh_fallbacks", "bit_identical"),
    23: ("unit", "rows", "mesh_rounds_recorded"),
}
NESTED = {17: (_bytes_of, ("off", "agent", "agent_killed", "disk"))}


@pytest.mark.parametrize("config", sorted(DETERMINISTIC))
def test_runner_matches_the_jax_package(config):
    got, _ref, detail = run_both(config, DETERMINISTIC[config],
                                 NESTED.get(config))
    if config == 17:
        # the agent's spans are stitched under the routing span
        assert detail["trace"]["agent_roots_under_rpc"] == \
            detail["trace"]["rpc_spans"] > 0
        assert detail["off_parts"]["store_data_gets"] == \
            got["off"]["store_data_gets"]
    if config == 23:
        assert got["cold_attribution_ratio"] >= 0.8
