"""Prometheus-style metric layer over CloudObjectStorage instances
(ref: src/metric_engine + docs/rfcs/20240827-metric-engine.md)."""

from horaedb_tpu_torch.metric_engine.types import (Label, Sample, metric_id_of,
                                                   series_key_of, tsid_of)
from horaedb_tpu_torch.metric_engine.engine import MetricEngine

__all__ = ["Label", "MetricEngine", "Sample", "metric_id_of",
           "series_key_of", "tsid_of"]
