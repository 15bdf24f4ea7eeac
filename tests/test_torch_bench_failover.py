"""The port's bench suite configs 20 and 21 (the failover drills)
beside the JAX package's, on the CPU: the same result keys and unit,
the same schedule (requests per phase) and no acked write lost in
either package.  Each drill's leg is 4 s."""

import pytest

from torch_bench_parity import _leg_counts, run_both

PHASES = ("query_pre_kill", "query_post_kill", "write_pre_kill",
          "write_post_kill")
DETERMINISTIC = {
    20: ("unit", "metric", "rows", "leg_seconds", "store_latency_ms",
         "lease_ttl_ms", "acked_write_loss", "bar_zero_loss",
         "slo_query_p99_ms", "slo_write_p99_ms"),
    21: ("unit", "metric", "rows", "leg_seconds", "store_latency_ms",
         "lease_ttl_ms", "grace_ms", "jitter", "acked_write_loss",
         "bar_zero_loss", "harness_promote_calls", "election_outcome",
         "failover_bound_ms", "slo_query_p99_ms", "slo_write_p99_ms"),
}


@pytest.mark.parametrize("config", sorted(DETERMINISTIC))
def test_runner_matches_the_jax_package(config):
    got, _ref, _detail = run_both(config, DETERMINISTIC[config],
                                  (_leg_counts, PHASES))
    assert got["acked_write_loss"] == 0 and got["acked_writes"] > 0
    if config == 21:
        assert got["bar_failover_bound"]
