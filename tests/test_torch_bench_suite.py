"""The port's bench suite configs 11-14 and 16 beside the JAX package's,
on the CPU (tests/torch_bench_parity.py): the same result keys and
unit, the same deterministic fields.  The runners check themselves
in-bench (numpy, the route-aware byte and rtol checks, their bars)."""

import pytest

from torch_bench_parity import run_both

DETERMINISTIC = {
    11: ("unit", "metric", "rows", "store_latency_ms", "backfill_segments",
         "lag_seqs_after_roll", "coverage_after_roll",
         "data_gets_rollup_leg", "rollup_served_queries"),
    12: ("unit", "metric", "rows"),
    13: ("unit", "metric", "rows", "store_latency_ms", "data_gets_cached",
         "data_gets_tier2", "data_gets_true_cold",
         "data_gets_tier2_pipeline_off",
         "data_gets_true_cold_pipeline_off"),
    14: ("unit", "metric", "rows", "hosts", "num_buckets", "grid_cells",
         "bit_identical_full_span", "topk_materialized_cells",
         "topk_grid_cells", "topk_bound_ok", "refine_memo_hit_segments",
         "refine_probe_segments", "refine_memo_fraction",
         "bit_identical_refine"),
    16: ("unit", "metric", "rows", "store_latency_ms",
         "host_data_gets_true_cold", "xla_host_data_gets_true_cold",
         "device_data_gets_true_cold", "decode_fallbacks"),
}


@pytest.mark.parametrize("config", sorted(DETERMINISTIC))
def test_runner_matches_the_jax_package(config):
    got, _ref, detail = run_both(config, DETERMINISTIC[config])
    if config == 11:
        # the late write: one raw tail segment, then one re-roll
        assert detail["late_tail_segments"] == 1
        assert detail["late_write_rerolled"] == 1
        assert set(detail["raw_routes"]) == {"zoom", "overview"}
    if config == 16:
        # an explicit device decode outranks the fused gate
        assert detail["routes"]["device"] == "parts, device decode"
        assert detail["routes"]["host"] == detail["routes"]["xla_host"]
        assert "one route" in got["note"]
