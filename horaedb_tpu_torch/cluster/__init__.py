"""Cluster plane.  Only the per-peer circuit breaker is here so far:
the scan agents' client breaks its circuits with it."""

from horaedb_tpu_torch.cluster.breaker import BreakerConfig, CircuitBreaker

__all__ = ["BreakerConfig", "CircuitBreaker"]
