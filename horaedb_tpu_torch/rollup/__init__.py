"""Continuous queries: standing downsample rollup tiers fed by the
ingest path (see rollup/manager.py for the architecture and the
correctness contract)."""

from horaedb_tpu_torch.rollup.config import RollupConfig, rollup_from_dict
from horaedb_tpu_torch.rollup.manager import (CELL_SCHEMA, ROLLUP_AGGS,
                                              RollupManager, RollupSpec)

__all__ = ["CELL_SCHEMA", "ROLLUP_AGGS", "RollupConfig", "RollupManager",
           "RollupSpec", "rollup_from_dict"]
