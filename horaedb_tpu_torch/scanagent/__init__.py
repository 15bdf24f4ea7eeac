"""Near-data scan agents (PAPERS.md "Near Data Processing in Taurus
Database"): push filter + partial-aggregate to the store shard.

  config.py  [scanagent] — the config-declared shard map + policy
  wire.py    plan request (JSON) / partial response (Arrow IPC)
  agent.py   AgentService — the store-colocated HTTP service
  client.py  ScanAgentClient + ScanRouter — coordinator-side routing
"""

from horaedb_tpu_torch.scanagent.config import (
    AgentSpec,
    ScanAgentConfig,
    scanagent_from_dict,
)
from horaedb_tpu_torch.scanagent.agent import AgentService
from horaedb_tpu_torch.scanagent.client import (
    AgentError,
    ScanAgentClient,
    ScanRouter,
)

__all__ = [
    "AgentSpec",
    "ScanAgentConfig",
    "scanagent_from_dict",
    "AgentService",
    "AgentError",
    "ScanAgentClient",
    "ScanRouter",
]
