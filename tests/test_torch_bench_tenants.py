"""The port's bench suite config 15 (tenant isolation under an
open-loop overload, over HTTP) beside the JAX package's, on the CPU:
the same result keys and unit, the same leg length and the same
arrivals per tenant and path in each leg (one seeded Poisson schedule).
Each leg is 4 s in each package."""

from torch_bench_parity import _leg_counts, run_both

DETERMINISTIC = ("unit", "metric", "rows", "leg_seconds",
                 "store_latency_ms", "slo_query_p99_ms", "slo_write_p99_ms")


def test_runner_matches_the_jax_package():
    got, _ref, _detail = run_both(
        15, DETERMINISTIC,
        (_leg_counts, ("baseline", "protected", "unprotected")))
    assert set(got["protected"]) == {"dash1_query", "dash2_query",
                                     "writer_write", "abuser_query",
                                     "abuser_write"}
