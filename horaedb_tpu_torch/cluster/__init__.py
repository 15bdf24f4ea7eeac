"""Sharding / scale-out layer (ref: RFC 20240827:20-76, SURVEY.md P6).

A range-partitioned cluster: series route by hash(metric + sorted
tags) onto regions (router.py); a Region is the shard unit, served
in-process by a MetricEngine on the cluster's torch device or remotely
through another server's HTTP API (remote.py).  Partition split rules
carry per-rule TTLs, so writes route by the freshest rule while queries
fan out to every rule whose lifetime meets the query window
(cluster.py).  The replication plane ships WAL tails to followers and
fences ownership with lease epochs (replication.py); placement.py
decides where regions live and who serves them.
"""

from horaedb_tpu_torch.cluster.router import (
    MAX_TTL,
    PartitionRule,
    RoutingTable,
    routing_key,
)
from horaedb_tpu_torch.cluster.breaker import BreakerConfig, CircuitBreaker
from horaedb_tpu_torch.cluster.cluster import Cluster, GatherMeta
from horaedb_tpu_torch.cluster.remote import RemoteRegion
from horaedb_tpu_torch.cluster.replication import (
    FailoverConfig,
    HttpWalSource,
    Lease,
    LeaseManager,
    LocalWalSource,
    RebalanceConfig,
    RebalanceExecutor,
    ReplicationConfig,
    ReplicationError,
    ReplicationHub,
    StaleEpochError,
    StaleOwnerError,
    StandbyMonitor,
    WalFollower,
    install_fence,
    promote,
)
from horaedb_tpu_torch.cluster.placement import (
    LeaseOwnerResolver,
    PlacementController,
)

__all__ = ["BreakerConfig", "CircuitBreaker", "Cluster",
           "FailoverConfig", "GatherMeta", "HttpWalSource", "Lease",
           "LeaseManager", "LeaseOwnerResolver", "LocalWalSource",
           "MAX_TTL", "PartitionRule", "PlacementController",
           "RebalanceConfig", "RebalanceExecutor", "RemoteRegion",
           "ReplicationConfig", "ReplicationError", "ReplicationHub",
           "RoutingTable", "StaleEpochError", "StaleOwnerError",
           "StandbyMonitor", "WalFollower", "install_fence", "promote",
           "routing_key"]
